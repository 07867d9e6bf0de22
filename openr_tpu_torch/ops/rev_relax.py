"""One band of the reversed-graph relaxation: the route sweep's relax step.

Port note: the counterpart of ``openr_tpu/ops/pallas_ell.py::rev_band_relax``.
``rev_band_relax`` launches the hand-written kernel in
``csrc/rev_relax.cu`` on CUDA tensors and runs ``rev_band_relax_plain``
on CPU tensors; there is no fallback from one to the other.

Rows of ``dr`` are destinations (``dr[b, s]`` is the distance s -> t_ids[b]);
band row j is node ``pos + j`` with its out-edges ``(v, w)``. Edge
``j -> v`` may extend a ``v ~> t`` path unless ``v`` is overloaded and
``v != t``: the transit mask depends on the row's destination, never on
the source.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from openr_tpu_torch.kernels import note_launch

INF = (1 << 30) - 1

# the kernel's block shapes (csrc/rev_relax.cu): a narrow block holds
# NARROW_ROWS band rows, one a thread with its slots staged; a wide one
# (k >= WIDE_K) WIDE_ROWS, one a warp
NARROW_ROWS = 128
WIDE_ROWS = 8
WIDE_K = 33
# longest run of destination rows a narrow block walks with its slots
# staged (runs of 64 measured slower on an H100 at the 10 000-node
# sweep's bands); the run shrinks until the grid holds MIN_BLOCKS (two
# blocks for each of an H100's 132 SMs)
MAX_CHUNK = 32
MIN_BLOCKS = 2 * 132
GRID_Y_MAX = 65535


class RevPlan(NamedTuple):
    """How one band launches: ``wide`` body or not, band rows a block,
    destination rows a block walks (``chunk``), and the grid
    ``(band-row tiles, destination runs)``."""

    wide: bool
    rows_per_block: int
    chunk: int
    grid: Tuple[int, int]


def launch_plan(b: int, rows: int, k: int, variant: str = "plan") -> RevPlan:
    """The launch of one band of ``rows`` band rows with ``k`` slots over
    ``b`` destination rows (both >= 1): the longest power-of-two run up to
    ``MAX_CHUNK`` (1 for a wide band, which stages nothing) that
    leaves at least ``MIN_BLOCKS`` blocks, or a run of 1; never so short
    that the runs overflow the grid's y limit. The autotuner's variants
    ``runX`` (family "ell_relax") set the run to X instead; its other
    variants leave the plan as it is."""
    if b < 1 or rows < 1 or k < 0:
        raise ValueError(f"rev_band_relax plan: b={b}, rows={rows}, k={k}")
    wide = k >= WIDE_K
    per = WIDE_ROWS if wide else NARROW_ROWS
    tiles = -(-rows // per)
    chunk = 1 if wide else MAX_CHUNK
    while chunk > 1 and tiles * -(-b // chunk) < MIN_BLOCKS:
        chunk //= 2
    if variant.startswith("run"):
        chunk = int(variant[3:])
    chunk = max(chunk, -(-b // GRID_Y_MAX))
    return RevPlan(wide, per, chunk, (tiles, -(-b // chunk)))


def _ell_variant() -> str:
    from openr_tpu_torch.ops.autotune import current_variant

    got = current_variant("ell_relax")
    if got == "plain":
        raise ValueError("rev_band_relax: no kernel plan 'plain' on the card")
    return got


def _check(dr, v, w, t_ids, overloaded, pos, out) -> int:
    if dr.dim() != 2 or v.dim() != 2 or v.shape != w.shape:
        raise ValueError(
            f"rev_band_relax: shapes dr {tuple(dr.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}"
        )
    rows = v.shape[0]
    if not 0 <= pos <= dr.shape[1] - rows:
        raise ValueError(f"rev_band_relax: band [{pos}, {pos + rows}) "
                         f"outside {dr.shape[1]} columns")
    if t_ids.shape != (dr.shape[0],):
        raise ValueError(
            f"rev_band_relax: t_ids {tuple(t_ids.shape)} for "
            f"{dr.shape[0]} rows"
        )
    for name, t in (("dr", dr), ("v", v), ("w", w), ("t_ids", t_ids)):
        if t.dtype != torch.int32:
            raise TypeError(f"rev_band_relax: {name} must be int32, got {t.dtype}")
    if overloaded.shape != (dr.shape[1],):
        raise ValueError(
            f"rev_band_relax: overloaded {tuple(overloaded.shape)} for "
            f"{dr.shape[1]} columns"
        )
    if overloaded.dtype not in (torch.bool, torch.uint8, torch.int32):
        raise TypeError(
            f"rev_band_relax: overloaded must be bool, uint8 or int32, "
            f"got {overloaded.dtype}"
        )
    devices = {dr.device, v.device, w.device, t_ids.device, overloaded.device}
    if out is not None:
        devices.add(out.device)
        if out.dtype != torch.int32 or out.shape != dr.shape:
            raise ValueError(
                f"rev_band_relax: out {tuple(out.shape)} {out.dtype} for dr "
                f"{tuple(dr.shape)}"
            )
    if len(devices) != 1:
        raise ValueError(f"rev_band_relax: operands on {sorted(map(str, devices))}")
    return rows


def rev_band_relax_plain(
    dr: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    t_ids: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """``[B, rows]``: ``min(dr[:, pos + j], min_slot min(dr[:, v[j, slot]]
    + w_eff, INF))`` with ``w_eff = INF`` where ``v`` is overloaded and
    not the row's destination, in plain torch ops."""
    _check(dr, v, w, t_ids, overloaded, pos, None)
    rows = v.shape[0]
    idx = v.long()
    blocked = (overloaded[idx] != 0)[None] & (v[None] != t_ids[:, None, None])
    w_eff = torch.where(blocked, INF, w[None])  # [B, rows, k]
    relaxed = (dr[:, idx] + w_eff).clamp_max_(INF).amin(2)
    return torch.minimum(dr[:, pos : pos + rows], relaxed)


def rev_band_relax(
    dr: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    t_ids: torch.Tensor,
    overloaded: torch.Tensor,
    pos: int,
    out: torch.Tensor,
) -> torch.Tensor:
    """One band of the reversed-graph relax over destination rows
    ``dr [B, n_pad]`` (row b is destination ``t_ids[b]``) and out-edge
    band slots ``v``/``w [rows, k]`` for the band starting at column
    ``pos``; ``overloaded [n_pad]`` is bool, uint8 or int32 0/1.

    Writes the band's ``[B, rows]`` block in place into
    ``out[:, pos:pos + rows]`` (``out`` is int32 and shaped like ``dr``;
    its other columns are left as they are) and returns that view. Slot
    ids are not range-checked (that would cost a device sync): they must
    lie in ``[0, n_pad)``, as ``compile_ell`` makes them.

    CUDA tensors go through the hand-written kernel (launched on the
    current stream, not synchronised, as ``launch_plan`` says); CPU
    tensors through ``rev_band_relax_plain``. Any other device raises.
    The plan follows the autotuner's ``current_variant("ell_relax")``."""
    rows = _check(dr, v, w, t_ids, overloaded, pos, out)
    view = out[:, pos : pos + rows]
    if dr.device.type == "cpu":
        view.copy_(rev_band_relax_plain(dr, v, w, t_ids, overloaded, pos))
        return view
    if dr.device.type != "cuda":
        raise ValueError(f"rev_band_relax: no kernel for device {dr.device}")
    from openr_tpu_torch.kernels import _build

    if overloaded.dtype == torch.bool:
        overloaded = overloaded.view(torch.uint8)
    for name, t in (
        ("dr", dr), ("v", v), ("w", w), ("t_ids", t_ids),
        ("overloaded", overloaded), ("out", out),
    ):
        if not t.is_contiguous():
            raise ValueError(f"rev_band_relax: {name} must be contiguous")
    b, n_pad = dr.shape
    k = v.shape[1]
    if b == 0 or rows == 0:
        return view
    plan = launch_plan(b, rows, k, _ell_variant())
    lib = _build.library()
    with torch.cuda.device(dr.device):
        stream = torch.cuda.current_stream(dr.device).cuda_stream
        rc = lib.openr_rev_band_relax(
            dr.data_ptr(), b, n_pad, v.data_ptr(), w.data_ptr(), rows, k,
            t_ids.data_ptr(), overloaded.data_ptr(),
            int(overloaded.dtype == torch.int32), pos, plan.chunk,
            out.data_ptr(), stream,
        )
    _build.check(rc, "rev_band_relax")
    note_launch("rev_band_relax")
    return view
