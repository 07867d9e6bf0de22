"""Batched per-group min-plus: the grouped route sweep's contraction.

Port note: the counterparts of
``openr_tpu/ops/pallas_grouped.py::batched_minplus`` and
``::batched_minplus_t``. Each wrapper launches its entry point of the
hand-written kernel in ``csrc/grouped_minplus.cu`` on CUDA tensors and
runs its own plain version on CPU tensors; there is no fallback from one
to the other. The Pallas versions' tile padding is gone: the kernel
takes any ``G, B, S, R``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from openr_tpu_torch.kernels import note_launch

INF = (1 << 30) - 1

# bound on the broadcast temporary of the plain versions (elements)
_PLAIN_CHUNK_ELEMS = 1 << 24

# The launches of csrc/grouped_minplus.cu. batched_minplus_t: a thread
# owns a (g, b) column and an R-tile of at most R_TILE_MAX accumulators; a
# block holds MAX_THREADS columns, or down to MIN_THREADS when the grid is
# thin. S is split (chunks of at least MIN_S_CHUNK) while the columns times
# R-tiles fall short of TARGET_THREADS (16 warps for each of an H100's 132
# SMs); then blocks shrink, and then R-tiles, until the grid holds
# MIN_BLOCKS (two a SM) or can shrink no further. batched_minplus where
# R <= R_TILE_MAX (its "rows" body): a thread owns a (g, b) row and all its
# R, MAX_THREADS rows a block, and S is split in the same way, in chunks
# that are whole int4 vectors (VEC), but only from SPLIT_MIN_S sources on;
# its blocks and R-tiles never shrink (a second launch for 12 sources, and
# smaller blocks or R-tiles, all measured slower on an H100 at both sweeps'
# segments). Where
# R > R_TILE_MAX (its "cols" body): a thread owns a (g, r) column and walks
# a run of up to RUN_B_MAX b rows, a block holds up to MAX_THREADS
# neighbouring r of one run; the runs shrink until the grid holds
# MIN_BLOCKS, then S is split as for rows.
R_TILE_MAX = 16
MAX_THREADS = 128
MIN_THREADS = 32
MIN_S_CHUNK = 4
TARGET_THREADS = 132 * 512
MIN_BLOCKS = 2 * 132
RUN_B_MAX = 8
SPLIT_MIN_S = 32
VEC = 4
GRID_YZ_MAX = 65535
GRID_X_MAX = 2**31 - 1
# every operand of the kernel holds fewer elements: 32-bit indices
MAX_ELEMS = 2**31 - 1


class MinplusTPlan(NamedTuple):
    """How one ``batched_minplus_t`` call launches: accumulators a thread
    (``r_tile``), columns a block (``threads``), the S range of a split
    (``s_chunk``) and the number of splits, the grid
    ``(G * b-blocks, R-tiles, splits)``, and the partial-min scratch's
    shape ``[splits, G, R, B]``, or ``()`` when S is not split (the
    kernel then writes the output)."""

    r_tile: int
    threads: int
    s_chunk: int
    splits: int
    grid: Tuple[int, int, int]
    scratch_shape: Tuple[int, ...]


class MinplusPlan(NamedTuple):
    """How one ``batched_minplus`` call launches: the ``body`` ("rows"
    or "cols"), accumulators a thread (``r_tile``: R rounded up to a power
    of two for rows, 1 for cols), threads a block (b rows for rows, r
    columns for cols), b rows a cols thread walks (``chunk``; 1 for rows),
    the S range of a split and the number of splits, the grid (rows:
    ``(G * b-blocks, 1, splits)``; cols: ``(G * r-blocks, b-runs,
    splits)``), and the scratch's shape
    ``[splits, G, B, R]``, or ``()`` when S is not split."""

    body: str
    r_tile: int
    threads: int
    chunk: int
    s_chunk: int
    splits: int
    grid: Tuple[int, int, int]
    scratch_shape: Tuple[int, ...]


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _split_s(work: int, s: int, least_s: int, align: int) -> Tuple[int, int]:
    """``(s_chunk, splits)``: S (at least ``least_s`` long) split while
    ``work`` threads fall short of TARGET_THREADS, in chunks of at least
    MIN_S_CHUNK that are multiples of ``align``; one chunk of all S
    otherwise."""
    if work >= TARGET_THREADS or s < max(least_s, 2 * MIN_S_CHUNK):
        return max(1, s), 1
    splits = min(-(-TARGET_THREADS // work), s // MIN_S_CHUNK, GRID_YZ_MAX)
    s_chunk = -(-(-(-s // splits)) // align) * align
    return s_chunk, -(-s // s_chunk)


def minplus_t_plan(g: int, b: int, s: int, r: int) -> MinplusTPlan:
    """The launch of ``[G, S, B] x [G, S, R] -> [G, R, B]`` (``g, b, r``
    >= 1, ``s`` >= 0) by the rule above the classes."""
    if g < 1 or b < 1 or r < 1 or s < 0:
        raise ValueError(f"batched_minplus_t plan: G={g}, B={b}, S={s}, R={r}")
    r_tile = min(R_TILE_MAX, _pow2_at_least(r))
    s_chunk, splits = _split_s(g * b * -(-r // r_tile), s, 0, 1)
    threads = MAX_THREADS

    def blocks() -> int:
        return g * -(-b // threads) * -(-r // r_tile) * splits

    while blocks() < MIN_BLOCKS and threads > MIN_THREADS:
        threads //= 2
    while blocks() < MIN_BLOCKS and r_tile > 1:
        r_tile //= 2
    grid = (g * -(-b // threads), -(-r // r_tile), splits)
    if grid[0] > GRID_X_MAX or grid[1] > GRID_YZ_MAX:
        raise ValueError(
            f"batched_minplus_t: G={g}, B={b}, R={r} exceed the grid {grid}"
        )
    return MinplusTPlan(r_tile, threads, s_chunk, splits, grid,
                        (splits, g, r, b) if splits > 1 else ())


def minplus_plan(g: int, b: int, s: int, r: int) -> MinplusPlan:
    """The launch of ``[G, B, S] x [G, S, R] -> [G, B, R]`` (``g, b, r``
    >= 1, ``s`` >= 0) by the rule above the classes."""
    if g < 1 or b < 1 or r < 1 or s < 0:
        raise ValueError(f"batched_minplus plan: G={g}, B={b}, S={s}, R={r}")
    if r <= R_TILE_MAX:
        r_tile = _pow2_at_least(r)
        s_chunk, splits = _split_s(g * b, s, SPLIT_MIN_S, VEC)
        grid = (g * -(-b // MAX_THREADS), 1, splits)
        body, threads, chunk = "rows", MAX_THREADS, 1
    else:
        r_tile, body = 1, "cols"
        threads = min(MAX_THREADS, -(-r // 32) * 32)
        r_blocks = -(-r // threads)
        chunk = RUN_B_MAX
        while chunk > 1 and g * r_blocks * -(-b // chunk) < MIN_BLOCKS:
            chunk //= 2
        while -(-b // chunk) > GRID_YZ_MAX and chunk < RUN_B_MAX:
            chunk *= 2
        s_chunk, splits = _split_s(g * r * -(-b // chunk), s, SPLIT_MIN_S, VEC)
        grid = (g * r_blocks, -(-b // chunk), splits)
    if grid[0] > GRID_X_MAX or grid[1] > GRID_YZ_MAX:
        raise ValueError(f"batched_minplus: G={g}, B={b}, R={r} exceed the grid {grid}")
    return MinplusPlan(body, r_tile, threads, chunk, s_chunk, splits, grid,
                       (splits, g, b, r) if splits > 1 else ())


def _check(name: str, gath, w, transposed: bool):
    if gath.dim() != 3 or w.dim() != 3:
        raise ValueError(
            f"{name}: shapes {tuple(gath.shape)} x {tuple(w.shape)}"
        )
    if transposed:
        g, s, b = gath.shape
    else:
        g, b, s = gath.shape
    if w.shape[:2] != (g, s):
        raise ValueError(
            f"{name}: shapes {tuple(gath.shape)} x {tuple(w.shape)}"
        )
    if gath.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"{name}: int32 operands, got {gath.dtype}, {w.dtype}")
    if gath.device != w.device:
        raise ValueError(f"{name}: operands on {gath.device} and {w.device}")
    return g, b, s, w.shape[2]


def _chunk(s: int, per_s: int) -> int:
    return max(1, min(s, _PLAIN_CHUNK_ELEMS // max(1, per_s)))


def batched_minplus_plain(gath: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, B, S] x [G, S, R] -> [G, B, R]``:
    ``min(INF, min_s gath[g, b, s] + w[g, s, r])`` in plain torch ops,
    walking S in chunks so the broadcast temporary stays bounded."""
    g, b, s, r = _check("batched_minplus", gath, w, False)
    out = torch.full((g, b, r), INF, dtype=torch.int32, device=gath.device)
    step = _chunk(s, g * b * r)
    for s0 in range(0, s, step):
        part = (
            gath[:, :, s0 : s0 + step, None] + w[:, None, s0 : s0 + step, :]
        ).amin(2)
        torch.minimum(out, part, out=out)
    return out


def batched_minplus_t_plain(gath_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, S, B] x [G, S, R] -> [G, R, B]``:
    ``min(INF, min_s gath_t[g, s, b] + w[g, s, r])`` in plain torch ops."""
    g, b, s, r = _check("batched_minplus_t", gath_t, w, True)
    out = torch.full((g, r, b), INF, dtype=torch.int32, device=gath_t.device)
    step = _chunk(s, g * b * r)
    for s0 in range(0, s, step):
        part = (
            gath_t[:, s0 : s0 + step, None, :] + w[:, s0 : s0 + step, :, None]
        ).amin(1)
        torch.minimum(out, part, out=out)
    return out


def _kernel_operands(name: str, gath, w) -> None:
    """Raise unless the kernel can take ``gath`` and ``w``."""
    if gath.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {gath.device}")
    if not (gath.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous operands")


def _run(name: str, entry: str, device, *args) -> None:
    from openr_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(rc, name)
    note_launch(name)


def _alloc(name: str, gath, w, out_shape, scratch_shape):
    """The output and the split scratch (None without a split); raises
    unless every operand fits the kernel's 32-bit indices."""
    most = max(gath.numel(), w.numel(), math.prod(out_shape),
               math.prod(scratch_shape))
    if most > MAX_ELEMS:
        raise ValueError(
            f"{name}: {most} elements in one operand exceed the kernel's "
            f"32-bit indices"
        )
    out = torch.empty(out_shape, dtype=torch.int32, device=gath.device)
    scratch = None
    if scratch_shape:
        scratch = torch.empty(scratch_shape, dtype=torch.int32, device=gath.device)
    return out, scratch


def batched_minplus(gath: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, B, S] x [G, S, R] -> [G, B, R]`` int32 over (min, +),
    saturating at INF. CUDA tensors go through the hand-written kernel
    (launched on the current stream, not synchronised, as ``minplus_plan``
    says; a split S takes a scratch ``[splits, G, B, R]`` allocated here);
    CPU tensors through ``batched_minplus_plain``. Any other device
    raises."""
    g, b, s, r = _check("batched_minplus", gath, w, False)
    if gath.device.type == "cpu":
        return batched_minplus_plain(gath, w)
    _kernel_operands("batched_minplus", gath, w)
    if not g * b * r:
        return torch.empty((g, b, r), dtype=torch.int32, device=gath.device)
    plan = minplus_plan(g, b, s, r)
    out, scratch = _alloc("batched_minplus", gath, w, (g, b, r), plan.scratch_shape)
    _run("batched_minplus", "openr_batched_minplus", gath.device,
         gath.data_ptr(), w.data_ptr(), out.data_ptr(),
         None if scratch is None else scratch.data_ptr(), g, b, s, r,
         int(plan.body == "cols"), plan.r_tile, plan.threads, plan.chunk,
         plan.s_chunk, plan.splits)
    return out


def batched_minplus_t(gath_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, S, B] x [G, S, R] -> [G, R, B]``: the same contraction with
    the batch last. CUDA tensors go through the hand-written kernel,
    launched as ``minplus_t_plan`` says (a split S takes a scratch
    ``[splits, G, R, B]`` allocated here); CPU tensors through
    ``batched_minplus_t_plain``. Any other device raises."""
    g, b, s, r = _check("batched_minplus_t", gath_t, w, True)
    if gath_t.device.type == "cpu":
        return batched_minplus_t_plain(gath_t, w)
    _kernel_operands("batched_minplus_t", gath_t, w)
    if not g * r * b:
        return torch.empty((g, r, b), dtype=torch.int32, device=gath_t.device)
    plan = minplus_t_plan(g, b, s, r)
    out, scratch = _alloc("batched_minplus_t", gath_t, w, (g, r, b), plan.scratch_shape)
    _run("batched_minplus_t", "openr_batched_minplus_t", gath_t.device,
         gath_t.data_ptr(), w.data_ptr(), out.data_ptr(),
         None if scratch is None else scratch.data_ptr(), g, b, s, r,
         plan.r_tile, plan.threads, plan.s_chunk, plan.splits)
    return out
