"""Min-plus (tropical) product: the dense SPF relaxation step.

Port note: the counterpart of ``openr_tpu/ops/pallas_minplus.py::minplus``.
``minplus`` launches the hand-written kernel in ``csrc/minplus.cu`` on a
CUDA tensor, as ``minplus_plan`` says, and runs ``minplus_plain`` on a
CPU tensor; there is no fallback from one to the other. The Pallas
version's tile-multiple shape restriction is gone: the kernel masks
ragged edges.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from openr_tpu_torch.kernels import note_launch

INF = (1 << 30) - 1

# bound on the [S, k-chunk, N] broadcast temporary of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24

# The launch of csrc/minplus.cu. A thread owns an S_TILE x 4 output tile;
# a block is COL_TILE columns (8 groups of 4) x 4 K lanes a warp, with
# K_WARPS_MAX warps over K, fewer where K would give a lane under
# MIN_K_LANE of its k. Where the grid of (column tiles, S-tiles) holds
# fewer than MIN_BLOCKS blocks (four for each of an H100's 132 SMs), K is
# also split over grid.z, while each lane keeps at least MIN_K_LANE of its
# split's k; the splits' partial mins go to a scratch [splits, S, N] and a
# reduce kernel. S-tiles beyond GRID_YZ_MAX are walked by the blocks of
# grid.y in turn. (On an H100 at [S, 1024] x [1024, 1024], S-tiles of 16
# rows measured slower at every S from 16 to 1024, 8 warps over K no
# faster up to S = 32 and slower from 64 on, and fewer blocks slower.)
S_TILE = 8
COL_TILE = 32
K_LANES_A_WARP = 4
K_WARPS_MAX = 4
MIN_K_LANE = 4
MIN_BLOCKS = 4 * 132
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65535


class MinplusPlan(NamedTuple):
    """How one ``minplus`` call launches: warps of a block over K
    (``k_warps``; the block's K lanes are ``4 * k_warps``), the K range of
    a split (``k_chunk``) and the number of splits, the grid ``(column
    tiles, S-tiles up to GRID_YZ_MAX, splits)`` and the scratch's shape
    ``[splits, S, N]``, or ``()`` when K is not split."""

    k_warps: int
    k_chunk: int
    splits: int
    grid: Tuple[int, int, int]
    scratch_shape: Tuple[int, ...]


# the autotuner's variants of the plan (ops/autotune.py, family
# "minplus"): k_warps forced to 1, 2 or 4 with the plan's split rule, or
# the plan's warps with K never split
VARIANTS = ("plan", "warps1", "warps2", "warps4", "nosplit")


def minplus_plan(s: int, k: int, n: int, variant: str = "plan") -> MinplusPlan:
    """The launch of ``[S, K] x [K, N] -> [S, N]`` (``s, n`` >= 1, ``k``
    >= 0) by the rule above the class, or by one of its ``VARIANTS``."""
    if s < 1 or n < 1 or k < 0:
        raise ValueError(f"minplus plan: S={s}, K={k}, N={n}")
    if variant not in VARIANTS:
        raise ValueError(f"minplus plan: no variant {variant!r}")
    k_warps = 1
    while k_warps < K_WARPS_MAX and 2 * k_warps * K_LANES_A_WARP * MIN_K_LANE <= k:
        k_warps *= 2
    if variant.startswith("warps"):
        k_warps = int(variant[5:])
    lanes = K_LANES_A_WARP * k_warps
    col_tiles = -(-n // COL_TILE)
    if col_tiles > GRID_X_MAX:
        raise ValueError(f"minplus: N={n} exceeds the grid")
    s_tiles = min(-(-s // S_TILE), GRID_YZ_MAX)
    splits = 1
    if variant != "nosplit" and col_tiles * s_tiles < MIN_BLOCKS:
        splits = max(1, min(-(-MIN_BLOCKS // (col_tiles * s_tiles)),
                            k // (lanes * MIN_K_LANE), GRID_YZ_MAX))
    k_chunk = -(-k // splits)
    if k_chunk:
        splits = -(-k // k_chunk)
    return MinplusPlan(k_warps, k_chunk, splits, (col_tiles, s_tiles, splits),
                       (splits, s, n) if splits > 1 else ())


def _variant() -> str:
    from openr_tpu_torch.ops.autotune import current_variant

    got = current_variant("minplus")
    if got not in VARIANTS:
        raise ValueError(f"minplus: no kernel plan {got!r} on the card")
    return got


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
    current stream, not synchronised, as ``minplus_plan`` says under the
    autotuner's ``current_variant("minplus")``; a split K takes a scratch
    ``[splits, S, N]`` allocated here); CPU tensors through
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
    plan = minplus_plan(s, k, n, _variant())
    scratch = None
    if plan.scratch_shape:
        scratch = torch.empty(plan.scratch_shape, dtype=torch.int32, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.openr_minplus(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), s, k, n,
            plan.k_warps, plan.k_chunk, plan.splits, stream,
        )
    _build.check(rc, "minplus")
    note_launch("minplus")
    return out
