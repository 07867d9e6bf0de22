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

import torch

from openr_tpu_torch.kernels import LAUNCHES

INF = (1 << 30) - 1

# bound on the broadcast temporary of the plain versions (elements)
_PLAIN_CHUNK_ELEMS = 1 << 24


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


def _launch(name: str, entry: str, gath, w, out_shape, dims) -> torch.Tensor:
    if gath.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {gath.device}")
    from openr_tpu_torch.kernels import _build

    if not (gath.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous operands")
    out = torch.empty(out_shape, dtype=torch.int32, device=gath.device)
    if out.numel() == 0:
        return out
    g, b, s, r = dims
    lib = _build.library()
    with torch.cuda.device(gath.device):
        stream = torch.cuda.current_stream(gath.device).cuda_stream
        rc = getattr(lib, entry)(
            gath.data_ptr(), w.data_ptr(), out.data_ptr(), g, b, s, r, stream
        )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def batched_minplus(gath: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, B, S] x [G, S, R] -> [G, B, R]`` int32 over (min, +),
    saturating at INF. CUDA tensors go through the hand-written kernel
    (launched on the current stream, not synchronised); CPU tensors
    through ``batched_minplus_plain``. Any other device raises."""
    g, b, s, r = _check("batched_minplus", gath, w, False)
    if gath.device.type == "cpu":
        return batched_minplus_plain(gath, w)
    return _launch(
        "batched_minplus", "openr_batched_minplus", gath, w, (g, b, r),
        (g, b, s, r),
    )


def batched_minplus_t(gath_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[G, S, B] x [G, S, R] -> [G, R, B]``: the same contraction with
    the batch last. CUDA tensors go through the hand-written kernel;
    CPU tensors through ``batched_minplus_t_plain``. Any other device
    raises."""
    g, b, s, r = _check("batched_minplus_t", gath_t, w, True)
    if gath_t.device.type == "cpu":
        return batched_minplus_t_plain(gath_t, w)
    return _launch(
        "batched_minplus_t", "openr_batched_minplus_t", gath_t, w, (g, r, b),
        (g, b, s, r),
    )
