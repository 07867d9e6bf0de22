"""Batched dense shortest paths over the snapshot's [N, N] metric matrix.

Port note: mirrors ``openr_tpu/ops/spf.py``. Every relaxation goes
through ``ops.minplus.minplus``: the hand-written CUDA kernel on the
card, its plain torch version on the CPU. The JAX ``lax.while_loop``
becomes chunks of hops whose changed count stays on the card, read once a
chunk (``ops/relax_loop.py``). ``reconverge_step`` patches the resident
metric tensor IN PLACE. The implementation selector is the reference's
(``set_minplus_impl``, ``OPENR_MINPLUS``): "plan" (the kernel's heuristic
launch plan), one of the autotuner's "minplus" variants, or "auto", the
measured winner for the ``[S, N]`` shape (``ops/autotune.py``); its
"jnp" and "pallas" both mean "plan". Left out for a later slice:
``first_hop_matrix`` and ``spf_from_source_with_first_hops`` (the
all-pairs daemon view).

Shortest paths are computed algebraically: Bellman-Ford over min-plus
products for a batch of sources (``distances_from_sources``,
``spf_view_batch``) and min-plus squaring for all pairs
(``all_pairs_distances``). ECMP first hops: neighbour ``v`` of source
``s`` is a first hop toward ``j`` iff

    W[s,v] + D[v,j] == D[s,j]      (v not overloaded, transit case)
    W[s,v] == D[s,j] and v == j    (directly-connected case)

Transit exclusion masks *rows* of the one-hop matrix: an overloaded
node's outgoing edges never extend a path, while paths may still start
at or end on it. Distances saturate at INF = 2**30 - 1.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from openr_tpu_torch.ops import autotune, relax_loop
from openr_tpu_torch.ops.minplus import INF, VARIANTS, minplus
from openr_tpu_torch.ops.staging import UploadStager


def _impl_setting(name: str) -> str:
    impl = {"jnp": "plan", "pallas": "plan"}.get(name, name)
    if impl not in VARIANTS + ("auto",):
        raise ValueError(f"minplus impl {name!r}: one of {VARIANTS + ('auto',)}")
    return impl


_MINPLUS_IMPL = _impl_setting(os.environ.get("OPENR_MINPLUS", "plan"))


def set_minplus_impl(impl: str) -> None:
    global _MINPLUS_IMPL
    _MINPLUS_IMPL = _impl_setting(impl)


def get_minplus_impl() -> str:
    return _MINPLUS_IMPL


def _impl_for(shape, device) -> str:
    """The concrete plan variant for one dispatch: "auto" resolves to the
    measured winner for ``[rows, n]`` against ``[n, n]``."""
    if _MINPLUS_IMPL != "auto":
        return _MINPLUS_IMPL
    return autotune.resolve_minplus(tuple(shape), device)


def _mask_transit_rows(d: torch.Tensor, overloaded: torch.Tensor) -> torch.Tensor:
    """Replace rows of overloaded nodes with the min-plus identity row
    (0 on the diagonal, INF elsewhere): their paths never extend others.
    Returns a new tensor."""
    t = d.masked_fill(overloaded[:, None], INF)
    t.diagonal().masked_fill_(overloaded, 0)
    return t


def _relax_to_fixed_point(d: torch.Tensor, t: torch.Tensor, limit: int) -> torch.Tensor:
    """Iterate ``d <- min(d, d (x) t)`` until nothing shrinks or ``limit``
    steps ran; one host sync a chunk of steps."""
    with autotune.using("minplus", _impl_for(d.shape, d.device)):
        d, _ = relax_loop.fixed_point(lambda x: torch.minimum(x, minplus(x, t)), d, limit)
    return d


def all_pairs_distances(w: torch.Tensor, overloaded: torch.Tensor) -> torch.Tensor:
    """All-sources shortest path distances, [N, N] int32, by min-plus
    squaring. w: [N, N] one-hop metric matrix (INF = no edge), diagonal
    forced to 0. overloaded: [N] bool transit-exclusion mask."""
    n = w.shape[0]
    d = w.clone()
    d.diagonal().fill_(0)
    with autotune.using("minplus", _impl_for(w.shape, w.device)):
        d, _ = relax_loop.fixed_point(
            lambda x: torch.minimum(x, minplus(x, _mask_transit_rows(x, overloaded))), d, n
        )
    return d


def _initial_rows(w: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    d = w[srcs.long()]  # advanced indexing copies
    d[torch.arange(srcs.shape[0], device=w.device), srcs.long()] = 0
    return d


def distances_from_sources(
    w: torch.Tensor, overloaded: torch.Tensor, src_ids: torch.Tensor
) -> torch.Tensor:
    """Shortest-path distances from a batch of sources, [S, N] int32.

    Bellman-Ford over the transit-masked one-hop matrix. Initial rows are
    the sources' direct edges (so an overloaded source still originates).
    """
    t = _mask_transit_rows(w, overloaded)
    return _relax_to_fixed_point(_initial_rows(w, src_ids), t, w.shape[0])


def source_batch(snap, sid: int, device: torch.device,
                 stager=None) -> Tuple[List[int], torch.Tensor]:
    """The hot-path source batch for ``spf_view_batch``: the source
    followed by its sorted unique neighbour ids, padded by repeating the
    source up to a power-of-two bucket (>= 8, capped at the snapshot's
    padded dimension). Padding rows are inert: the source is never its
    own neighbour, so their first-hop rows are all False.

    Returns (real_srcs, padded ids as an int32 tensor on ``device``,
    uploaded through ``stager``, a new one when None); row i of the view
    corresponds to real_srcs[i] for i < len(real_srcs).
    """
    nbrs = sorted({dl.dst_id for dl in snap.links_from[sid]})
    srcs = [sid] + nbrs
    bucket = 8
    while bucket < len(srcs):
        bucket *= 2
    bucket = min(bucket, snap.n_pad)
    padded = np.asarray(srcs + [sid] * (bucket - len(srcs)), dtype=np.int32)
    (ids,) = (stager if stager is not None else UploadStager(device)).upload(
        [("view", padded)]
    )
    return srcs, ids


def _first_hops_from_rows(
    d: torch.Tensor,
    srcs: torch.Tensor,
    w_sv: torch.Tensor,
    overloaded: torch.Tensor,
) -> torch.Tensor:
    """ECMP first-hop bits [B, N] from the batch's distance rows: batch
    node v forwards toward j iff w(src, v) + d(v, j) == d(src, j) and v is
    not overloaded, or v == j and the direct edge is a shortest path.
    ``w_sv`` [B] is the direct metric source -> batch node (INF when not
    adjacent, and for the source itself). Every operand may carry a
    leading world axis (``d [W, B, N]``, ``srcs``/``w_sv [W, B]``,
    ``overloaded [W, N]``: the tenant plane's batched solve). Shared with
    ops.spf_sparse."""
    n = d.shape[-1]
    sl = srcs.long()
    d_src = d[..., :1, :]  # [..., 1, N]
    is_neighbor = w_sv < INF
    reachable = d_src < INF
    total = torch.clamp_max(w_sv[..., None] + d, INF)
    transit_ok = (
        is_neighbor[..., None]
        & ~torch.gather(overloaded, -1, sl)[..., None]
        & (total == d_src)
    )
    col_is_self = sl[..., None] == torch.arange(n, device=d.device)
    d_src_at = torch.gather(d_src[..., 0, :], -1, sl)
    direct_ok = col_is_self & (is_neighbor & (w_sv == d_src_at))[..., None]
    return (transit_ok | direct_ok) & reachable


def _spf_view_batch(
    metric: torch.Tensor,
    overloaded: torch.Tensor,
    srcs: torch.Tensor,
    use_link_metric: bool,
) -> torch.Tensor:
    n = metric.shape[0]
    w = metric if use_link_metric else torch.where(
        metric < INF, torch.ones_like(metric), torch.full_like(metric, INF)
    )
    t = _mask_transit_rows(w, overloaded)
    d = _relax_to_fixed_point(_initial_rows(w, srcs), t, n)
    # row 0 is the source itself (w[src, src] == INF => never a
    # neighbour => all False); padding rows repeating it behave the same
    w_sv = w[srcs[0].long(), srcs.long()]
    fh = _first_hops_from_rows(d, srcs, w_sv, overloaded)
    # one buffer: a single device->host copy returns both
    return torch.cat([d, fh.to(torch.int32)], dim=0)


def spf_view_batch(
    metric: torch.Tensor,
    overloaded: torch.Tensor,
    srcs: torch.Tensor,
    use_link_metric: bool = True,
):
    """Route-build view: distances + ECMP first hops for a batch of
    sources ``srcs = [src, neighbour_0, ...]`` (padded by repeating
    ``src``). Returns (d [B, N] int32, fh [B, N] bool) where fh[i, j] is
    True iff batch node i is a valid ECMP first hop from the source
    toward j."""
    packed = _spf_view_batch(metric, overloaded, srcs, use_link_metric)
    b = srcs.shape[0]
    return packed[:b], packed[b:].to(torch.bool)


def spf_view_batch_packed(
    metric: torch.Tensor,
    overloaded: torch.Tensor,
    srcs: torch.Tensor,
    use_link_metric: bool = True,
) -> torch.Tensor:
    """Single-buffer ``spf_view_batch``: [2B, N] int32, rows [0, B)
    distances, rows [B, 2B) first-hop 0/1."""
    return _spf_view_batch(metric, overloaded, srcs, use_link_metric)


def reconverge_step(
    metric: torch.Tensor,
    patch_ids: torch.Tensor,
    patch_vals: torch.Tensor,
    overloaded: torch.Tensor,
    srcs: torch.Tensor,
    use_link_metric: bool = True,
):
    """Churn step: scatter changed metric rows into the resident matrix
    IN PLACE (``index_copy_``; repeated ids must carry equal rows), then
    run the batched SPF view from it.

    Returns (``metric``, now patched, and packed [2B, N] int32)."""
    metric.index_copy_(0, patch_ids.long(), patch_vals)
    return metric, _spf_view_batch(metric, overloaded, srcs, use_link_metric)
