"""Host (NumPy) replica of the device route product — the FALLBACK rung
of the route-engine degradation ladder.

Port note: a copy of ``openr_tpu/ops/host_sweep.py``, over the port's own
``route_sweep`` and ``spf_sparse``; nothing left out. It runs on the host
only: the engine reaches it on the card only when its device rungs
failed by an injected fault or torn state.

When the device path is down (dispatch, readback, and cold rebuild all
failed), the supervisor still owes the caller a route product that is
bit-identical to what the device would have produced. This module
recomputes it entirely on the host over the SAME out-direction ELL
bands (``spf_sparse.compile_ell(direction="out")``), mirroring each
device kernel exactly:

- ``route_sweep._rev_relax`` / ``_rev_fixed_point``: the int32
  min-relaxation is overflow-free by construction (``INF + INF ==
  2**31 - 2`` fits int32), both sides clamp with ``minimum(.., INF)``
  per relax, both start from the same unit init, and both apply the
  same monotone Jacobi operator until no element changes — so the
  iterate sequences, not just the limits, are identical;
- ``_nh_counts`` / ``_sample_stats``: the same equality-test algebra
  and the same little-endian uint32 bit packing;
- the digest comes from ``route_sweep.host_digest`` (already the test
  oracle) over ``canonical_pos_weights``;
- the packed [n_pad, W] layout matches ``_route_block_body`` /
  ``route_engine._pack_product`` column for column, so
  ``route_sweep.assemble_result`` consumes it unchanged.

Padding columns beyond the last band are never relaxed on the device
(``_rev_relax`` passes them through) and never relaxed here, so they
hold their init values (INF, or 0 on the diagonal of a padding
destination row) on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from openr_tpu_torch.ops import route_sweep as rs
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf_sparse import EllGraph, compile_ell

__all__ = ["HostSweepShim", "host_packed_product", "host_route_product"]


def _block_fixed_point(
    graph: EllGraph, overloaded: np.ndarray, t_ids: np.ndarray
) -> np.ndarray:
    """DR rows [B, n_pad] for destination batch ``t_ids``: reversed
    Jacobi relaxation to the fixed point, element-identical to
    ``_rev_fixed_point`` (same operator, same init, same stop rule)."""
    n_pad = graph.n_pad
    b = len(t_ids)
    dr = np.full((b, n_pad), INF, dtype=np.int32)
    dr[np.arange(b), t_ids] = 0
    for _ in range(n_pad):
        nxt = dr.copy()
        pos = 0
        for band, v_b, w_b in zip(graph.bands, graph.src, graph.w):
            blocked = overloaded[v_b][None, :, :] & (
                v_b[None, :, :] != t_ids[:, None, None]
            )  # [B, rows, k]
            w_eff = np.where(blocked, INF, w_b[None, :, :])
            gathered = dr[:, v_b]  # [B, rows, k]
            relaxed = np.minimum(gathered + w_eff, INF).min(axis=2)
            nxt[:, pos : pos + band.rows] = np.minimum(
                dr[:, pos : pos + band.rows], relaxed.astype(np.int32)
            )
            pos += band.rows
        if np.array_equal(nxt, dr):
            break
        dr = nxt
    return dr


def _block_nh_counts(
    graph: EllGraph,
    overloaded: np.ndarray,
    dr: np.ndarray,
    t_ids: np.ndarray,
) -> np.ndarray:
    """Per-node ECMP slot counts [B, n_pad] (replica of _nh_counts;
    padding columns stay 0 as on device)."""
    out = np.zeros_like(dr)
    pos = 0
    for band, v_b, w_b in zip(graph.bands, graph.src, graph.w):
        blocked = overloaded[v_b][None, :, :] & (
            v_b[None, :, :] != t_ids[:, None, None]
        )
        total = np.minimum(
            dr[:, v_b] + np.where(blocked, INF, w_b[None, :, :]), INF
        )
        d_row = dr[:, pos : pos + band.rows]
        cond = (
            (total == d_row[:, :, None])
            & (d_row < INF)[:, :, None]
            & (w_b < INF)[None, :, :]
        )
        out[:, pos : pos + band.rows] = cond.sum(axis=2, dtype=np.int32)
        pos += band.rows
    return out


def _block_sample_stats(
    dr: np.ndarray,
    samp_ids: np.ndarray,
    samp_v: np.ndarray,
    samp_w: np.ndarray,
    overloaded: np.ndarray,
    t_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """([B, S] int32 metrics, [B, S, K/32] uint32 packed masks) —
    replica of _sample_stats including the bit-packing order."""
    blocked = overloaded[samp_v][None, :, :] & (
        samp_v[None, :, :] != t_ids[:, None, None]
    )  # [B, S, K]
    total = np.minimum(
        dr[:, samp_v] + np.where(blocked, INF, samp_w[None, :, :]), INF
    )
    d_s = dr[:, samp_ids]  # [B, S]
    cond = (
        (total == d_s[:, :, None])
        & (d_s < INF)[:, :, None]
        & (samp_w < INF)[None, :, :]
    )
    b, s, k = cond.shape
    bits = cond.reshape(b, s, k // 32, 32).astype(np.uint32)
    weights = np.left_shift(
        np.uint32(1), np.arange(32, dtype=np.uint32)
    )
    packed = np.sum(
        bits * weights[None, None, None, :], axis=3, dtype=np.uint32
    )
    return d_s, packed


def host_packed_product(
    graph: EllGraph,
    sample_ids: np.ndarray,
    samp_v: np.ndarray,
    samp_w: np.ndarray,
    block: int = 256,
) -> np.ndarray:
    """The full [n_pad, W] packed route product, column-compatible with
    ``_route_block_body`` (digest | nh_total | sample metrics | masks).
    Destination rows are processed in blocks to bound the [B, rows, k]
    gather temporaries."""
    n_pad = graph.n_pad
    overloaded = np.asarray(graph.overloaded, dtype=bool)
    pos_w = rs.canonical_pos_weights(graph)
    s = len(sample_ids)
    kw = samp_v.shape[1] // 32
    packed = np.zeros((n_pad, 2 + s + s * kw), dtype=np.int32)
    for start in range(0, n_pad, block):
        t_ids = np.arange(
            start, min(start + block, n_pad), dtype=np.int32
        )
        dr = _block_fixed_point(graph, overloaded, t_ids)
        nh = _block_nh_counts(graph, overloaded, dr, t_ids)
        d_s, masks = _block_sample_stats(
            dr, sample_ids, samp_v, samp_w, overloaded, t_ids
        )
        packed[t_ids, 0] = rs.host_digest(dr, nh, pos_w).view(np.int32)
        packed[t_ids, 1] = nh.sum(axis=1, dtype=np.int32)
        packed[t_ids, 2 : 2 + s] = d_s
        packed[t_ids, 2 + s :] = masks.view(np.int32).reshape(
            len(t_ids), -1
        )
    return packed


@dataclass
class HostSweepShim:
    """The slice of RouteSweeper that assemble_result reads — lets the
    host product flow through the one shared assembly site."""

    graph: EllGraph
    sample_names: Tuple[str, ...]
    sample_ids: np.ndarray
    samp_v: np.ndarray
    samp_w: np.ndarray


def host_route_product(
    ls, sample_names: Sequence[str], align: int = 128, block: int = 256
) -> Tuple[HostSweepShim, np.ndarray]:
    """Compile the out-ELL from a LinkState and compute the whole
    packed product on the host. ``assemble_result(shim, packed)``
    yields a RouteSweepResult bit-identical to a cold device sweep of
    the same LinkState at the same align."""
    graph = compile_ell(ls, align=align, direction="out")
    sample_ids = np.asarray(
        [graph.node_index[nm] for nm in sample_names], dtype=np.int32
    )
    samp_v, samp_w = rs._sample_bands(graph, sample_ids)
    packed = host_packed_product(
        graph, sample_ids, samp_v, samp_w, block=block
    )
    shim = HostSweepShim(
        graph=graph,
        sample_names=tuple(sample_names),
        sample_ids=sample_ids,
        samp_v=samp_v,
        samp_w=samp_w,
    )
    return shim, packed
