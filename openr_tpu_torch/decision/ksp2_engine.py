"""KSP2_ED_ECMP path tracing from masked distance rows.

Port note: the host half of ``openr_tpu/decision/ksp2_engine.py`` that the
per-build chunked KSP2 dispatch (``SpfSolver._prefetch_ksp2_area``) needs:
``trace_paths_from_row`` and ``make_cands_of``, copied. The incremental
``Ksp2Engine`` (paths persisted across churn, on the resident ELL state),
its native trace arrays and its mesh settings are left for a later slice;
this module keeps the reference's name so they land here.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

from openr_tpu_torch.graph.linkstate import Link, LinkState
from openr_tpu_torch.ops.minplus import INF


def trace_paths_from_row(
    src: str,
    dest: str,
    index: Dict[str, int],
    dlist,
    excluded: Set[Link],
    cands_of,
    transit_blocked: Set[str],
    preds_cache: Optional[Dict[str, list]] = None,
):
    """Enumerate link-disjoint shortest paths src -> dest from a distance
    row: the same paths, in the same order, as LinkState._trace_one_path
    over the same SPF (both walk predecessor links in canonical sorted
    order; reference: LinkState.cpp:399 traceOnePath).

    ``preds_cache``: predecessor lists depend only on (dlist, excluded,
    transit_blocked), not on the destination, so a caller tracing many
    destinations from one row under the same filters may share one
    dict."""
    inf = int(INF)
    did = index.get(dest)
    if did is None:
        return []
    # a plain list indexes and compares much faster than a numpy row in
    # the predecessor scans below; one bulk tolist() pays for itself
    if isinstance(dlist, np.ndarray):
        dlist = dlist.tolist()
    if dlist[did] >= inf:
        return []

    visited: Set[Link] = set()
    preds: Dict[str, list] = preds_cache if preds_cache is not None else {}

    # first-path traces run with both filter sets empty: skip the two
    # per-candidate membership tests there
    plain = not excluded and not transit_blocked

    def preds_of(v: str):
        got = preds.get(v)
        if got is None:
            dv = dlist[index[v]]
            if plain:
                got = preds[v] = [
                    (link, u)
                    for link, u, uid, w in cands_of(v)
                    if uid is not None and dlist[uid] + w == dv
                ]
            else:
                got = preds[v] = [
                    (link, u)
                    for link, u, uid, w in cands_of(v)
                    if uid is not None
                    and link not in excluded
                    and (u == src or u not in transit_blocked)
                    and dlist[uid] < inf
                    and dlist[uid] + w == dv
                ]
        return got

    def trace_one(v: str):
        if v == src:
            return []
        for link, u in preds_of(v):
            if link in visited:
                continue
            visited.add(link)
            sub = trace_one(u)
            if sub is not None:
                sub.append(link)
                return sub
        return None

    paths = []
    path = trace_one(dest)
    while path:
        paths.append(path)
        path = trace_one(dest)
    return paths


def make_cands_of(ls: LinkState, node_index: Dict[str, int]):
    """Per-build candidate list factory shared by the trace calls: up
    links of each node in canonical order with (origin, origin id,
    metric) pre-resolved."""
    in_cands: Dict[str, list] = {}

    def cands_of(v: str):
        got = in_cands.get(v)
        if got is None:
            got = in_cands[v] = [
                (
                    link,
                    link.other_node(v),
                    node_index.get(link.other_node(v)),
                    link.metric_from(link.other_node(v)),
                )
                for link in ls.ordered_links_from_node(v)
                if link.is_up()
            ]
        return got

    return cands_of
