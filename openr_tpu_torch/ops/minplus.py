"""Min-plus (tropical) product: the dense SPF relaxation step.

Port note: the counterpart of ``openr_tpu/ops/pallas_minplus.py::minplus``.
``minplus`` launches the hand-written kernel in ``csrc/minplus.cu`` on a
CUDA tensor and runs ``minplus_plain`` on a CPU tensor; there is no
fallback from one to the other. The Pallas version's tile-multiple
shape restriction is gone: the kernel masks ragged edges.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.kernels import LAUNCHES

INF = (1 << 30) - 1

# bound on the [S, k-chunk, N] broadcast temporary of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"minplus: int32 operands, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"minplus: operands on {a.device} and {b.device}")


def minplus_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[s, j] = min(INF, min_k a[s, k] + b[k, j])`` in plain torch ops.

    K is walked in chunks so the broadcast temporary stays under
    ``_PLAIN_CHUNK_ELEMS`` elements (4 GiB unchunked at S = 64, N = 4096).
    Operands are <= INF, so a + b <= 2^31 - 2 stays inside int32."""
    _check(a, b)
    s, k = a.shape
    n = b.shape[1]
    out = torch.full((s, n), INF, dtype=torch.int32, device=a.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, s * n))
    for k0 in range(0, k, step):
        part = (a[:, k0 : k0 + step, None] + b[None, k0 : k0 + step, :]).amin(1)
        torch.minimum(out, part, out=out)
    return out


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[S, K] x [K, N] -> [S, N]`` int32 over (min, +), saturating at INF.

    CUDA tensors go through the hand-written kernel (launched on the
    current stream, not synchronised); CPU tensors through
    ``minplus_plain``. Any other device raises."""
    _check(a, b)
    if a.device.type == "cpu":
        return minplus_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"minplus: no kernel for device {a.device}")
    from openr_tpu_torch.kernels import _build

    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus: the kernel takes contiguous operands")
    s, k = a.shape
    n = b.shape[1]
    out = torch.empty((s, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if (s + 7) // 8 > 65535:
        raise ValueError(f"minplus: {s} rows exceed the kernel's grid")
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.openr_minplus(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), s, k, n, stream
        )
    _build.check(rc, "minplus")
    LAUNCHES["minplus"] += 1
    return out
