"""One band of the sliced-ELL relaxation: the sparse SPF relaxation step.

Port note: the counterpart of ``openr_tpu/ops/pallas_ell.py::ell_band_relax``
and ``::ell_band_relax_masked``. ``ell_band_relax`` launches the
hand-written kernel in ``csrc/ell_relax.cu`` and ``ell_band_relax_masked``
(the KSP2 second-path relax, with a per-batch-row edge mask) the one in
``csrc/ell_relax_masked.cu`` on CUDA tensors; each runs its ``*_plain``
version on CPU tensors. There is no fallback from one to the other. The
reversed-graph variant of the same Pallas module (the route sweep's
``rev_band_relax``) is ``ops/rev_relax.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from openr_tpu_torch.kernels import LAUNCHES

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


class EllPlan(NamedTuple):
    """How one band launches: ``wide`` body or not, threads a (s, j) row
    (``row_threads``, 1 for the narrow body), band rows a block, and the
    grid ``(band-row tiles, batch rows)``."""

    wide: bool
    row_threads: int
    rows_per_block: int
    grid: Tuple[int, int]


def launch_plan(s: int, rows: int, k: int) -> EllPlan:
    """The launch of one band of ``rows`` band rows with ``k`` slots over
    ``s`` batch rows (both >= 1, ``s`` within the grid's y limit) by the
    rule above the class."""
    if s < 1 or rows < 1 or k < 0 or s > GRID_Y_MAX:
        raise ValueError(f"ell_band_relax plan: s={s}, rows={rows}, k={k}")
    if k < WIDE_K:
        return EllPlan(False, 1, NARROW_ROWS, (-(-rows // NARROW_ROWS), s))
    threads = MIN_ROW_THREADS
    while (threads < WIDE_THREADS and s * rows * threads // 32 < TARGET_WARPS
           and k >= MIN_SLOTS * 2 * threads):
        threads *= 2
    per = WIDE_THREADS // threads
    return EllPlan(True, threads, per, (-(-rows // per), s))


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
    tensors through ``ell_band_relax_plain``. Any other device raises."""
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
    plan = launch_plan(s, rows, k)
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.openr_ell_band_relax(
            d.data_ptr(), s, n_pad, src.data_ptr(), w.data_ptr(), rows, k,
            overloaded.data_ptr(), int(overloaded.dtype == torch.int32),
            pos, plan.row_threads, out.data_ptr(), stream,
        )
    _build.check(rc, "ell_band_relax")
    LAUNCHES["ell_band_relax"] += 1
    return view


def _check_mask(d, src, mask) -> None:
    if mask.dtype != torch.bool:
        raise TypeError(f"ell_band_relax_masked: mask must be bool, got {mask.dtype}")
    want = (d.shape[0], *src.shape)
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
    mask: ``mask [S, rows, k]`` bool, True where the edge is excluded for
    that batch row (its weight becomes INF for that row only)."""
    _check(d, src, w, overloaded, pos, None)
    _check_mask(d, src, mask)
    rows = src.shape[0]
    idx = src.long()
    w_eff = w.masked_fill(overloaded[idx] != 0, INF)
    w_rows = w_eff[None].masked_fill(mask, INF)  # [S, rows, k]
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
    second-path graphs): ``ell_band_relax`` plus ``mask [S, rows, k]``
    bool, contiguous, True where that edge is excluded for that batch
    row. The kernel reads the mask as bytes.

    Writes the band's ``[S, rows]`` block into ``out[:, pos:pos + rows]``
    and returns that view, as ``ell_band_relax`` does. CUDA tensors go
    through the hand-written kernel (current stream, not synchronised);
    CPU tensors through ``ell_band_relax_masked_plain``. Any other device
    raises."""
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
    if s > 65535:
        raise ValueError(f"ell_band_relax_masked: {s} batch rows exceed the grid")
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.openr_ell_band_relax_masked(
            d.data_ptr(), s, n_pad, src.data_ptr(), w.data_ptr(),
            mask.data_ptr(), rows, k, overloaded.data_ptr(),
            int(overloaded.dtype == torch.int32), pos, out.data_ptr(), stream,
        )
    _build.check(rc, "ell_band_relax_masked")
    LAUNCHES["ell_band_relax_masked"] += 1
    return view
