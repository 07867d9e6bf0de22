"""One band of the sliced-ELL relaxation: the sparse SPF relaxation step.

Port note: the counterpart of ``openr_tpu/ops/pallas_ell.py::ell_band_relax``
and ``::ell_band_relax_masked``, and of ``ell_band_relax`` batched over a
tenant axis by ``pallas_call``'s vmap rule (the reference's
``spf_sparse._uniform_relax`` under ``vmap``): ``ell_band_relax_worlds``,
one uniform band covering every row of each of B worlds, in one launch of
a kernel of its own that walks each row's live slots only (``live_slots``
counts them). ``ell_band_relax`` launches the hand-written kernel in
``csrc/ell_relax.cu``, ``ell_band_relax_masked`` (the KSP2 second-path
relax, with a per-batch-row edge mask) the one in
``csrc/ell_relax_masked.cu`` and ``ell_band_relax_worlds`` and
``live_slots`` those in ``csrc/ell_relax_worlds.cu`` on CUDA tensors; each
runs its ``*_plain`` version on CPU tensors. There is no fallback from one
to the other. The reversed-graph variant of the same Pallas module (the
route sweep's ``rev_band_relax``) is ``ops/rev_relax.py``.

The masked relax takes its edge mask bit-packed (``pack_edge_mask``):
int32 words ``[S, ceil(rows * k / 32)]`` per band, the bit of band row
``j``, slot ``slot`` of batch row ``s`` being bit ``(j * k + slot) & 31``
of word ``(j * k + slot) >> 5`` of row ``s``; where the JAX package's
``[S, rows, k]`` bool mask is True, the bit is set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from openr_tpu_torch.kernels import note_launch

INF = (1 << 30) - 1

# ell_band_relax's launch (csrc/ell_relax.cu): a narrow band (k < WIDE_K)
# gives each (s, j) row one thread, NARROW_ROWS rows a block; a wide one
# gives a row 32 to WIDE_THREADS threads of a WIDE_THREADS block, grown by
# doubling while the grid holds fewer than TARGET_WARPS warps (16 for each
# of an H100's 132 SMs) and each thread keeps at least MIN_SLOTS slots
NARROW_ROWS = 128
WIDE_K = 33
WIDE_THREADS = 256
MIN_ROW_THREADS = 32
MIN_SLOTS = 4
TARGET_WARPS = 132 * 16
GRID_Y_MAX = 65535


# ell_band_relax_masked's launch (csrc/ell_relax_masked.cu): a narrow band
# (k < WIDE_K) gives each band row one thread, MASKED_NARROW_ROWS rows a
# block, its k slots staged in registers (KMAX: k rounded up to 8, 16 or
# 32) and walked over a run of up to MASKED_NARROW_RUN batch rows, taken
# `group` at a time (MASKED_GROUP_SLOTS / KMAX, at most MASKED_GROUP_MAX);
# a wide one gives a row a thread a slot, 32 to WIDE_THREADS of a
# WIDE_THREADS block, over a run of up to MASKED_WIDE_RUN batch rows. Runs are the
# longest power of two that leaves MASKED_NARROW_MIN_BLOCKS (one for each
# of an H100's 132 SMs) or MASKED_WIDE_MIN_BLOCKS (two) blocks, or 1; runs
# beyond GRID_Y_MAX are walked by the blocks of grid.y in turn. (Chosen
# among runs of 1 to 32, groups of 1 to 8 and 32 to 256 threads a wide row
# by their device times on an H100 at the KSP2 chunks' in-bands.)
MASKED_NARROW_ROWS = 128
MASKED_NARROW_RUN = 16
MASKED_WIDE_RUN = 8
MASKED_GROUP_SLOTS = 64
MASKED_GROUP_MAX = 4
MASKED_NARROW_MIN_BLOCKS = 132
MASKED_WIDE_MIN_BLOCKS = 2 * 132


class EllPlan(NamedTuple):
    """How one band launches: ``wide`` body or not, threads a (s, j) row
    (``row_threads``, 1 for the narrow body), band rows a block and the
    grid ``(band-row tiles, batch rows)``."""

    wide: bool
    row_threads: int
    rows_per_block: int
    grid: Tuple[int, int]


def launch_plan(s: int, rows: int, k: int, variant: str = "plan") -> EllPlan:
    """The launch of one band of ``rows`` band rows with ``k`` slots over
    ``s`` batch rows (both >= 1, ``s`` within the grid's y limit) by the
    rule above the class. The autotuner's variants ``threadsX`` (family
    "ell_relax") give a wide band's row X threads instead; its other
    variants leave the plan as it is."""
    if s < 1 or rows < 1 or k < 0 or s > GRID_Y_MAX:
        raise ValueError(f"ell_band_relax plan: s={s}, rows={rows}, k={k}")
    if k < WIDE_K:
        return EllPlan(False, 1, NARROW_ROWS, (-(-rows // NARROW_ROWS), s))
    threads = MIN_ROW_THREADS
    while (threads < WIDE_THREADS
           and s * rows * threads // 32 < TARGET_WARPS
           and k >= MIN_SLOTS * 2 * threads):
        threads *= 2
    if variant.startswith("threads"):
        threads = int(variant[7:])
    per = WIDE_THREADS // threads
    return EllPlan(True, threads, per, (-(-rows // per), s))


# ell_band_relax_worlds' launch (csrc/ell_relax_worlds.cu): a block of
# WORLDS_THREADS threads relaxes a tile of up to WORLDS_TILE_MAX rows of one
# world for a run of up to WORLDS_RUN_MAX batch rows, the run's distance rows
# (its slab) and the world's overload bytes in shared memory, beside a list
# of the tile's wide rows (more than WORLDS_WIDE_LIVE live slots, a warp
# each). The run is the longest that fits WORLDS_SMEM_MAX bytes (without a
# slab where one row does not fit: gathers from device memory), evened out
# over the runs S takes; the rows are cut into tiles, a multiple of a warp,
# while the grid holds fewer blocks than an H100 has SMs (WORLDS_SMS): a
# tile reloads its run's slab. (Chosen among runs of 4 to 32 and tiles of
# 256 to 4096 rows by their device times on an H100 at the tenant plane's
# shapes: runs of 16 beat 32 by 5-15 % at S = 32 and 64.)
WORLDS_THREADS = 512
WORLDS_RUN_MAX = 16
WORLDS_WIDE_LIVE = 32
WORLDS_TILE_MAX = 4096
WORLDS_SMEM_MAX = 227 * 1024 - 1024
WORLDS_SMS = 132


class WorldsPlan(NamedTuple):
    """How ``ell_band_relax_worlds`` launches: the run's distance rows in
    shared memory or not (``slab``), batch rows a run, rows a tile, the
    block's dynamic shared memory and the grid ``(row tiles, runs,
    worlds)``."""

    slab: bool
    run: int
    tile_rows: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def worlds_smem(slab: bool, run: int, n: int, tile_rows: int) -> int:
    """A block's dynamic shared memory: the slab ``[run, n]`` int32 and the
    overload bytes ``[n]`` (with a slab), then the wide-row list."""
    return (_align16(4 * run * n) + _align16(n) if slab else 0) + 4 * tile_rows


def worlds_plan(b: int, s: int, n: int, k: int) -> WorldsPlan:
    """The launch of one relax step of ``b`` worlds of ``s`` batch rows
    over ``[n, k]`` blocks (``b``, ``s`` and ``n`` >= 1, ``b`` within the
    grid's z limit) by the rule above the class: a function of the
    shapes alone, so a captured graph replays the same launch. ``k`` does
    not change it: a row's work is its live slots."""
    if b < 1 or s < 1 or n < 1 or k < 0 or b > GRID_Y_MAX:
        raise ValueError(f"ell_band_relax_worlds plan: b={b}, s={s}, n={n}, k={k}")
    fit = (WORLDS_SMEM_MAX - _align16(n) - 4 * WORLDS_TILE_MAX - 16) // (4 * n)
    slab = fit >= 1
    run = min(s, WORLDS_RUN_MAX, fit) if slab else min(s, WORLDS_RUN_MAX)
    runs = -(-s // run)
    run = -(-s // runs)
    tiles = max(-(-n // WORLDS_TILE_MAX),
                min(round(WORLDS_SMS / (b * runs)), -(-n // WORLDS_THREADS)), 1)
    tile_rows = -(-(-(-n // tiles)) // 32) * 32
    return WorldsPlan(slab, run, tile_rows, worlds_smem(slab, run, n, tile_rows),
                      (-(-n // tile_rows), runs, b))


class MaskedPlan(NamedTuple):
    """How one band of ``ell_band_relax_masked`` launches: the ``body``
    ("narrow" or "wide"), slots a narrow thread stages (``kmax``; 0 for
    wide), batch rows a narrow thread takes at a time (``group``; 1 for
    wide), threads a band row (``row_threads``; 1 for narrow), band rows a
    block, batch rows a block walks (``chunk``), and the grid
    ``(band-row tiles, runs up to GRID_Y_MAX)``."""

    body: str
    kmax: int
    group: int
    row_threads: int
    rows_per_block: int
    chunk: int
    grid: Tuple[int, int]


def masked_plan(s: int, rows: int, k: int) -> MaskedPlan:
    """The launch of one band of ``rows`` band rows with ``k`` slots over
    ``s`` batch rows (both >= 1) by the rule above ``EllPlan``. The
    autotuner's "ell_relax" variants are measured on ``ell_band_relax``
    and ``rev_band_relax`` only, so this plan takes none of them."""
    if s < 1 or rows < 1 or k < 0:
        raise ValueError(f"ell_band_relax_masked plan: s={s}, rows={rows}, k={k}")
    if k < WIDE_K:
        body, kmax, threads, per = "narrow", 8, 1, MASKED_NARROW_ROWS
        while kmax < k:
            kmax *= 2
        group = min(MASKED_GROUP_MAX, MASKED_GROUP_SLOTS // kmax)
        chunk, least = MASKED_NARROW_RUN, MASKED_NARROW_MIN_BLOCKS
    else:
        body, kmax, group, threads = "wide", 0, 1, MIN_ROW_THREADS
        while threads < WIDE_THREADS and threads < k:
            threads *= 2
        per = WIDE_THREADS // threads
        chunk, least = MASKED_WIDE_RUN, MASKED_WIDE_MIN_BLOCKS
    tiles = -(-rows // per)
    while chunk > 1 and tiles * -(-s // chunk) < least:
        chunk //= 2
    return MaskedPlan(body, kmax, group, threads, per, chunk,
                      (tiles, min(-(-s // chunk), GRID_Y_MAX)))


def _variant(name: str) -> str:
    from openr_tpu_torch.ops.autotune import current_variant

    got = current_variant("ell_relax")
    if got == "plain":
        raise ValueError(f"{name}: no kernel plan 'plain' on the card")
    return got


def mask_words(rows: int, k: int) -> int:
    """int32 words a batch row of a band's packed edge mask takes."""
    return -(-rows * k // 32)


def pack_edge_mask(mask: torch.Tensor) -> torch.Tensor:
    """``[S, rows, k]`` bool -> the packed ``[S, mask_words(rows, k)]``
    int32 words the masked relax takes (the layout in the module
    docstring); plain torch ops, on the mask's device."""
    if mask.dim() != 3 or mask.dtype != torch.bool:
        raise ValueError(f"pack_edge_mask: [S, rows, k] bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    s, rows, k = mask.shape
    words = mask_words(rows, k)
    flat = torch.zeros((s, words * 32), dtype=torch.int64, device=mask.device)
    flat[:, : rows * k] = mask.reshape(s, rows * k)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    packed = (flat.view(s, words, 32) << shifts).sum(2)  # [0, 2^32)
    return torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)


def unpack_edge_mask(bits: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """The packed ``[S, mask_words(rows, k)]`` int32 words -> the
    ``[S, rows, k]`` bool mask (``pack_edge_mask``'s inverse)."""
    if bits.dim() != 2 or bits.shape[1] != mask_words(rows, k):
        raise ValueError(f"unpack_edge_mask: {tuple(bits.shape)} for "
                         f"{rows} rows of {k} slots")
    s, words = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    flat = ((bits.to(torch.int32)[:, :, None] >> shifts) & 1).reshape(s, words * 32)
    return flat[:, : rows * k].reshape(s, rows, k).bool()


def _check(d, src, w, overloaded, pos, out) -> int:
    if d.dim() != 2 or src.dim() != 2 or src.shape != w.shape:
        raise ValueError(
            f"ell_band_relax: shapes d {tuple(d.shape)}, src "
            f"{tuple(src.shape)}, w {tuple(w.shape)}"
        )
    rows = src.shape[0]
    if not 0 <= pos <= d.shape[1] - rows:
        raise ValueError(f"ell_band_relax: band [{pos}, {pos + rows}) "
                         f"outside {d.shape[1]} columns")
    for name, t in (("d", d), ("src", src), ("w", w)):
        if t.dtype != torch.int32:
            raise TypeError(f"ell_band_relax: {name} must be int32, got {t.dtype}")
    if overloaded.shape != (d.shape[1],):
        raise ValueError(
            f"ell_band_relax: overloaded {tuple(overloaded.shape)} for "
            f"{d.shape[1]} columns"
        )
    if overloaded.dtype not in (torch.bool, torch.uint8, torch.int32):
        raise TypeError(
            f"ell_band_relax: overloaded must be bool, uint8 or int32, "
            f"got {overloaded.dtype}"
        )
    devices = {d.device, src.device, w.device, overloaded.device}
    if out is not None:
        devices.add(out.device)
        if out.dtype != torch.int32 or out.shape != d.shape:
            raise ValueError(
                f"ell_band_relax: out {tuple(out.shape)} {out.dtype} for d "
                f"{tuple(d.shape)}"
            )
    if len(devices) != 1:
        raise ValueError(f"ell_band_relax: operands on {sorted(map(str, devices))}")
    return rows


def ell_band_relax_plain(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """``[S, rows]``: ``min(d[:, pos + j], min_slot min(d[:, src[j, slot]]
    + w_eff[j, slot], INF))`` with ``w_eff = INF`` where ``src`` is
    overloaded, in plain torch ops. ``src`` holds node ids < n_pad."""
    _check(d, src, w, overloaded, pos, None)
    rows = src.shape[0]
    idx = src.long()
    w_eff = w.masked_fill(overloaded[idx] != 0, INF)
    gathered = d[:, idx]  # [S, rows, k]
    relaxed = (gathered + w_eff[None]).clamp_max_(INF).amin(2)
    return torch.minimum(d[:, pos : pos + rows], relaxed)


def ell_band_relax(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
    out: torch.Tensor,
) -> torch.Tensor:
    """One band of the plain sliced-ELL relax over distance rows
    ``d [S, n_pad]`` and band slots ``src``/``w [rows, k]`` for the band
    starting at column ``pos``; ``overloaded [n_pad]`` is bool, uint8 or
    int32 0/1.

    Writes the band's ``[S, rows]`` block in place into
    ``out[:, pos:pos + rows]`` (``out`` is int32 and shaped like ``d``;
    its other columns are left as they are) and returns that view. Slot
    ids are not range-checked (that would cost a device sync): they must
    lie in ``[0, n_pad)``, as ``compile_ell`` makes them.

    CUDA tensors go through the hand-written kernel (launched on the
    current stream, not synchronised, as ``launch_plan`` says); CPU
    tensors through ``ell_band_relax_plain``. Any other device raises.
    The plan follows the autotuner's ``current_variant("ell_relax")``."""
    rows = _check(d, src, w, overloaded, pos, out)
    view = out[:, pos : pos + rows]
    if d.device.type == "cpu":
        view.copy_(ell_band_relax_plain(d, src, w, overloaded, pos))
        return view
    if d.device.type != "cuda":
        raise ValueError(f"ell_band_relax: no kernel for device {d.device}")
    from openr_tpu_torch.kernels import _build

    if overloaded.dtype == torch.bool:
        overloaded = overloaded.view(torch.uint8)
    for name, t in (
        ("d", d), ("src", src), ("w", w), ("overloaded", overloaded), ("out", out),
    ):
        if not t.is_contiguous():
            raise ValueError(f"ell_band_relax: {name} must be contiguous")
    s, n_pad = d.shape
    k = src.shape[1]
    if s == 0 or rows == 0:
        return view
    plan = launch_plan(s, rows, k, _variant("ell_band_relax"))
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.openr_ell_band_relax(
            d.data_ptr(), s, n_pad, src.data_ptr(), w.data_ptr(), rows, k,
            overloaded.data_ptr(), int(overloaded.dtype == torch.int32),
            pos, plan.row_threads, out.data_ptr(), stream,
        )
    _build.check(rc, "ell_band_relax")
    note_launch("ell_band_relax")
    return view


def _check_mask(d, src, mask) -> None:
    if mask.dtype != torch.int32:
        raise TypeError(
            f"ell_band_relax_masked: mask must be packed int32 words, got {mask.dtype}"
        )
    want = (d.shape[0], mask_words(*src.shape))
    if tuple(mask.shape) != want:
        raise ValueError(
            f"ell_band_relax_masked: mask {tuple(mask.shape)}, want {want}"
        )
    if mask.device != d.device:
        raise ValueError(
            f"ell_band_relax_masked: mask on {mask.device}, d on {d.device}"
        )


def ell_band_relax_masked_plain(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    mask: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """``[S, rows]``: ``ell_band_relax_plain`` with a per-batch-row edge
    mask: ``mask`` is the packed ``[S, mask_words(rows, k)]`` int32 words
    of an ``[S, rows, k]`` bool mask, True where the edge is excluded for
    that batch row (its weight becomes INF for that row only)."""
    _check(d, src, w, overloaded, pos, None)
    _check_mask(d, src, mask)
    rows, k = src.shape
    idx = src.long()
    w_eff = w.masked_fill(overloaded[idx] != 0, INF)
    w_rows = w_eff[None].masked_fill(unpack_edge_mask(mask, rows, k), INF)
    gathered = d[:, idx]  # [S, rows, k]
    relaxed = (gathered + w_rows).clamp_max_(INF).amin(2)
    return torch.minimum(d[:, pos : pos + rows], relaxed)


def ell_band_relax_masked(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    mask: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
    out: torch.Tensor,
) -> torch.Tensor:
    """One band of the per-batch-masked sliced-ELL relax (the KSP2
    second-path graphs): ``ell_band_relax`` plus ``mask``, the packed
    ``[S, mask_words(rows, k)]`` int32 words (``pack_edge_mask``),
    contiguous, whose bit is set where that edge is excluded for that
    batch row.

    Writes the band's ``[S, rows]`` block into ``out[:, pos:pos + rows]``
    and returns that view, as ``ell_band_relax`` does. CUDA tensors go
    through the hand-written kernel (current stream, not synchronised, as
    ``masked_plan`` says); CPU tensors through
    ``ell_band_relax_masked_plain``. Any other device raises."""
    rows = _check(d, src, w, overloaded, pos, out)
    _check_mask(d, src, mask)
    view = out[:, pos : pos + rows]
    if d.device.type == "cpu":
        view.copy_(ell_band_relax_masked_plain(d, src, w, mask, overloaded, pos))
        return view
    if d.device.type != "cuda":
        raise ValueError(f"ell_band_relax_masked: no kernel for device {d.device}")
    from openr_tpu_torch.kernels import _build

    if overloaded.dtype == torch.bool:
        overloaded = overloaded.view(torch.uint8)
    for name, t in (
        ("d", d), ("src", src), ("w", w), ("mask", mask),
        ("overloaded", overloaded), ("out", out),
    ):
        if not t.is_contiguous():
            raise ValueError(f"ell_band_relax_masked: {name} must be contiguous")
    s, n_pad = d.shape
    k = src.shape[1]
    if s == 0 or rows == 0:
        return view
    _variant("ell_band_relax_masked")  # refuses "plain" on the card
    plan = masked_plan(s, rows, k)
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.openr_ell_band_relax_masked(
            d.data_ptr(), s, n_pad, src.data_ptr(), w.data_ptr(),
            mask.data_ptr(), rows, k, overloaded.data_ptr(),
            int(overloaded.dtype == torch.int32), pos, plan.kmax, plan.group,
            plan.row_threads, plan.chunk, out.data_ptr(), stream,
        )
    _build.check(rc, "ell_band_relax_masked")
    note_launch("ell_band_relax_masked")
    return view


def _check_live(w, live) -> None:
    if live.dtype != torch.int32 or tuple(live.shape) != tuple(w.shape[:2]):
        raise ValueError(f"live slots: {tuple(live.shape)} {live.dtype}, want "
                         f"int32 {tuple(w.shape[:2])}")
    if live.device != w.device:
        raise ValueError(f"live slots on {live.device}, w on {w.device}")


def _check_worlds(d, src, w, overloaded, live) -> None:
    if d.dim() != 3 or src.dim() != 3 or src.shape != w.shape:
        raise ValueError(
            f"ell_band_relax_worlds: shapes d {tuple(d.shape)}, src "
            f"{tuple(src.shape)}, w {tuple(w.shape)}"
        )
    b, _s, n = d.shape
    if src.shape[:2] != (b, n) or overloaded.shape != (b, n):
        raise ValueError(
            f"ell_band_relax_worlds: d {tuple(d.shape)}, src {tuple(src.shape)}, "
            f"overloaded {tuple(overloaded.shape)}: want [B, n, k] and [B, n]"
        )
    for name, t in (("d", d), ("src", src), ("w", w)):
        if t.dtype != torch.int32:
            raise TypeError(f"ell_band_relax_worlds: {name} must be int32, got {t.dtype}")
    if overloaded.dtype not in (torch.bool, torch.uint8, torch.int32):
        raise TypeError(
            f"ell_band_relax_worlds: overloaded must be bool, uint8 or int32, "
            f"got {overloaded.dtype}"
        )
    devices = {d.device, src.device, w.device, overloaded.device}
    if len(devices) != 1:
        raise ValueError(f"ell_band_relax_worlds: operands on {sorted(map(str, devices))}")
    if live is not None:
        _check_live(w, live)


def live_slots_plain(w: torch.Tensor) -> torch.Tensor:
    """``[B, n]`` int32: for each row of ``w [B, n, k]``, one past its last
    slot with a weight below INF (0 for a row with none), in plain torch
    ops."""
    if w.dim() != 3 or w.dtype != torch.int32:
        raise ValueError(f"live slots: w {tuple(w.shape)} {w.dtype}, want int32 [B, n, k]")
    b, n, k = w.shape
    if k == 0:
        return torch.zeros((b, n), dtype=torch.int32, device=w.device)
    ones = torch.arange(1, k + 1, dtype=torch.int32, device=w.device)
    return torch.where(w < INF, ones, 0).amax(2).to(torch.int32)


def live_slots(w: torch.Tensor) -> torch.Tensor:
    """The live-slot counts of ``w [B, n, k]`` (``live_slots_plain``'s
    function): a slot at or past its row's count has weight INF, so a
    relax may stop there. CUDA tensors go through the hand-written kernel
    (``csrc/ell_relax_worlds.cu``'s ``ell_live_slot_counts``: a warp a
    row, no ``[B, n, k]`` temporary; current stream, not synchronised);
    CPU tensors through ``live_slots_plain``. Any other device raises."""
    if w.device.type == "cpu":
        return live_slots_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"live slots: no kernel for device {w.device}")
    if w.dim() != 3 or w.dtype != torch.int32 or not w.is_contiguous():
        raise ValueError(f"live slots: w {tuple(w.shape)} {w.dtype}, want "
                         "contiguous int32 [B, n, k]")
    from openr_tpu_torch.kernels import _build

    b, n, k = w.shape
    live = torch.empty((b, n), dtype=torch.int32, device=w.device)
    if b * n == 0:
        return live
    lib = _build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.openr_ell_live_slots(w.data_ptr(), b * n, k, live.data_ptr(), stream)
    _build.check(rc, "ell_live_slots")
    note_launch("ell_live_slots")
    return live


def ell_band_relax_worlds_plain(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    overloaded: torch.Tensor,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, S, n]``: for each world ``b``, ``min(d[b], min_slot
    min(d[b, :, src[b, j, slot]] + w_eff[b, j, slot], INF))`` with
    ``w_eff = INF`` where ``overloaded[b, src[b, j, slot]]``, and with
    ``live [B, n]`` given also at every slot at or past ``live[b, j]``: a
    batched gather in plain torch ops. ``src`` holds node ids < n."""
    _check_worlds(d, src, w, overloaded, live)
    b, s, n = d.shape
    k = src.shape[2]
    if k == 0:
        return d.clone()
    idx = src.long().reshape(b, n * k)
    ov = torch.gather(overloaded, 1, idx).reshape(b, n, k)
    w_eff = w.masked_fill(ov != 0, INF)
    if live is not None:
        slots = torch.arange(k, dtype=torch.int32, device=w.device)
        w_eff.masked_fill_(slots >= live[:, :, None], INF)
    gathered = torch.gather(d, 2, idx[:, None, :].expand(b, s, n * k))
    relaxed = (gathered.view(b, s, n, k) + w_eff[:, None]).clamp_max_(INF).amin(3)
    return torch.minimum(d, relaxed)


def ell_band_relax_worlds(
    d: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    overloaded: torch.Tensor,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One relax step of B worlds, each one uniform band covering all its
    rows (``pos = 0``): distance rows ``d [B, S, n]``, slots ``src``/``w
    [B, n, k]``, ``overloaded [B, n]`` bool, uint8 or int32 0/1, and the
    rows' live-slot counts ``live [B, n]`` int32 (``live_slots(w)``; run
    here when None). Returns a new ``[B, S, n]``. Slot ids are not
    range-checked: they must lie in ``[0, n)``, as
    ``spf_sparse.ell_pack_uniform`` makes them.

    CUDA tensors go through the hand-written kernel
    (``csrc/ell_relax_worlds.cu``'s ``openr_ell_band_relax_worlds``, one
    launch for every world, current stream, not synchronised, as
    ``worlds_plan`` says); CPU tensors through
    ``ell_band_relax_worlds_plain``. Any other device raises."""
    _check_worlds(d, src, w, overloaded, live)
    if d.device.type == "cpu":
        return ell_band_relax_worlds_plain(d, src, w, overloaded, live)
    if d.device.type != "cuda":
        raise ValueError(f"ell_band_relax_worlds: no kernel for device {d.device}")
    from openr_tpu_torch.kernels import _build

    for name, t in (("d", d), ("src", src), ("w", w), ("overloaded", overloaded),
                    ("live", live)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ell_band_relax_worlds: {name} must be contiguous")
    # the kernel takes the bits as bytes: int32 ones become bytes here, once
    if overloaded.dtype == torch.int32:
        overloaded = overloaded.ne(0)
    overloaded = overloaded.view(torch.uint8)
    b, s, n = d.shape
    k = src.shape[2]
    out = torch.empty_like(d)
    if b == 0 or s == 0 or n == 0:
        return out
    # the "ell_relax" autotune family is measured on the banded kernels
    # only, so its winner does not reach the world shapes unmeasured
    _variant("ell_band_relax_worlds")  # refuses "plain" on the card
    plan = worlds_plan(b, s, n, k)
    if live is None:
        live = live_slots(w)
    lib = _build.library()
    _build.allow_large_smem(d.device.index)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.openr_ell_band_relax_worlds(
            d.data_ptr(), b, s, n, src.data_ptr(), w.data_ptr(), k,
            overloaded.data_ptr(), live.data_ptr(), plan.run, plan.tile_rows,
            int(plan.slab), out.data_ptr(), stream,
        )
    _build.check(rc, "ell_band_relax_worlds")
    note_launch("ell_band_relax")
    return out
