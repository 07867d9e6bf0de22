"""LinkState -> dense snapshot compiler, with incremental row patching.

Port note: mirrors ``openr_tpu/graph/snapshot.py``. The host compile
(``compile_snapshot``) and patch plan (``patch_snapshot``,
``GraphSnapshot.patch_plan``) are copied. ``device_arrays(device)``
holds torch tensors on that device; a patched snapshot takes its parent's
resident metric tensor and patches the changed rows IN PLACE with
``index_copy_`` (the JAX version makes a new array), so the parent loses
its device copy. Left out: the jit patch-bucket padding
(``pad_patch_rows``) and the device hop matrix, which nothing on the
route-build path reads.

Each topology version of a ``LinkState`` compiles into:

- node-name interning: sorted names -> dense ids
- ``metric[N, N]`` int32 directed min-metric matrix (INF where no up link;
  min over parallel links per direction)
- ``overloaded[N]`` node transit-exclusion mask
- per-source-node directed-link metadata for next-hop materialization

N is padded to a multiple of 128.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.graph.linkstate import Link, LinkState
from openr_tpu_torch.ops.staging import UploadStager

# Distance/metric infinity sentinel: INF + INF == 2**31 - 2 still fits
# in int32, so relaxation adds never wrap.
INF = np.int32((1 << 30) - 1)

_PAD = 128


def _padded(n: int) -> int:
    return max(_PAD, ((n + _PAD - 1) // _PAD) * _PAD)


@dataclass
class DirectedLink:
    """Host-side metadata for one direction of one up link."""

    link: Link
    src: str
    dst: str
    src_id: int
    dst_id: int
    metric: int


@dataclass
class DeviceArrays:
    """Resident tensors of one snapshot: ``metric [n_pad, n_pad]`` int32
    and ``overloaded [n_pad]`` bool, on one device."""

    metric: torch.Tensor
    overloaded: torch.Tensor


@dataclass
class GraphSnapshot:
    area: str
    version: int
    node_names: List[str]  # index == dense node id
    node_index: Dict[str, int]
    n: int  # real node count
    n_pad: int  # padded node count (matrix dimension)
    metric: np.ndarray  # [n_pad, n_pad] int32, INF where no edge
    overloaded: np.ndarray  # [n_pad] bool
    # per node id: directed links leaving that node
    links_from: List[List[DirectedLink]]
    _dev: Optional[DeviceArrays] = None
    _parent: Optional["GraphSnapshot"] = None
    _changed_rows: Optional[np.ndarray] = None

    def id_of(self, node: str) -> Optional[int]:
        return self.node_index.get(node)

    def patch_plan(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(changed_row_ids, changed_row_values) when this snapshot is an
        unrealized patch of a parent whose device copy the caller owns;
        None for a full compile. Detaches the parent chain.

        Covers METRIC rows only: the caller refreshes its overloaded
        mask from ``self.overloaded`` on every step."""
        if self._parent is None or self._changed_rows is None:
            return None
        rows = self._changed_rows
        self._parent = None
        return rows, self.metric[rows, :]

    def device_arrays(self, device: torch.device,
                      stager: Optional[UploadStager] = None) -> DeviceArrays:
        """The snapshot's tensors on ``device``. A patched snapshot whose
        parent holds tensors there takes them over and scatters the
        changed rows in place (``index_copy_``): O(changed rows) upload
        instead of O(N^2). The parent's device copy is released. The
        uploads cross in one copy through ``stager`` (a new one when
        None)."""
        device = resolve_device(device)
        if self._dev is not None and self._dev.metric.device == device:
            return self._dev
        parent = self._parent
        rows = self._changed_rows
        patching = (
            parent is not None
            and parent._dev is not None
            and parent._dev.metric.device == device
            and rows is not None
        )
        items = [("overloaded", self.overloaded)]
        if not patching:
            items.append(("matrix", self.metric))
        elif len(rows):
            items += [("patch", rows), ("patch", self.metric[rows, :])]
        staged = (stager if stager is not None else UploadStager(device)).upload(items)
        overloaded = staged[0].ne(0)
        if patching:
            metric = parent._dev.metric
            parent._dev = None
            if len(rows):
                metric.index_copy_(0, staged[1].long(), staged[2])
        else:
            metric = staged[1]  # a staged copy never aliases the host matrix
        self._dev = DeviceArrays(metric, overloaded)
        # release the parent chain: resident arrays now belong to us
        self._parent = None
        return self._dev


def _build_node_row(
    ls: LinkState,
    name: str,
    index: Dict[str, int],
    metric: np.ndarray,
) -> List[DirectedLink]:
    """Fill row index[name] of the metric matrix and return the node's
    directed-link metadata."""
    i = index[name]
    metric[i, :] = INF
    out: List[DirectedLink] = []
    for link in ls.ordered_links_from_node(name):
        if not link.is_up():
            continue
        dst = link.other_node(name)
        j = index.get(dst)
        if j is None:
            continue
        m = min(int(link.metric_from(name)), int(INF) - 1)
        out.append(
            DirectedLink(
                link=link, src=name, dst=dst, src_id=i, dst_id=j, metric=m
            )
        )
        if m < metric[i, j]:
            metric[i, j] = m
    return out


def compile_snapshot(ls: LinkState) -> GraphSnapshot:
    """Full compile of the current LinkState topology."""
    names = sorted(ls.get_adjacency_databases().keys())
    index = {name: i for i, name in enumerate(names)}
    n = len(names)
    n_pad = _padded(n)

    metric = np.full((n_pad, n_pad), INF, dtype=np.int32)
    overloaded = np.zeros((n_pad,), dtype=bool)
    links_from: List[List[DirectedLink]] = [[] for _ in range(n)]

    for name in names:
        i = index[name]
        overloaded[i] = ls.is_node_overloaded(name)
        links_from[i] = _build_node_row(ls, name, index, metric)

    return GraphSnapshot(
        area=ls.area,
        version=ls.topology_version,
        node_names=names,
        node_index=index,
        n=n,
        n_pad=n_pad,
        metric=metric,
        overloaded=overloaded,
        links_from=links_from,
    )


def patch_snapshot(
    prev: GraphSnapshot, ls: LinkState, affected: List[str]
) -> GraphSnapshot:
    """Produce a new snapshot by re-deriving only the affected rows.
    Caller guarantees the node set is unchanged."""
    metric = prev.metric.copy()
    overloaded = prev.overloaded.copy()
    links_from = list(prev.links_from)
    rows = []
    for name in affected:
        i = prev.node_index.get(name)
        if i is None:
            continue
        rows.append(i)
        overloaded[i] = ls.is_node_overloaded(name)
        links_from[i] = _build_node_row(ls, name, prev.node_index, metric)
    return GraphSnapshot(
        area=ls.area,
        version=ls.topology_version,
        node_names=prev.node_names,
        node_index=prev.node_index,
        n=prev.n,
        n_pad=prev.n_pad,
        metric=metric,
        overloaded=overloaded,
        links_from=links_from,
        _parent=prev,
        _changed_rows=np.asarray(sorted(rows), dtype=np.int32),
    )


class SnapshotCache:
    """Versioned snapshot cache keyed by LinkState *identity* (weakly
    held); patches incrementally when the change journal covers the gap
    and the node set is unchanged. ``device`` (None = CUDA) is where the
    snapshots' tensors live; their uploads cross through one pinned
    buffer (``stager``)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.stager = UploadStager(self.device)
        self._cache: "weakref.WeakKeyDictionary[LinkState, GraphSnapshot]" = (
            weakref.WeakKeyDictionary()
        )

    def get(self, ls: LinkState) -> GraphSnapshot:
        snap = self._cache.get(ls)
        if snap is not None and snap.version == ls.topology_version:
            return snap
        snap = self._compile_or_patch(ls, snap)
        self._cache[ls] = snap
        return snap

    def _compile_or_patch(
        self, ls: LinkState, prev: Optional[GraphSnapshot]
    ) -> GraphSnapshot:
        if prev is not None:
            affected = ls.affected_since(prev.version)
            if (
                affected is not None
                and len(affected) <= max(8, prev.n // 4)
                and len(ls.get_adjacency_databases()) == prev.n
                and all(name in prev.node_index for name in affected)
            ):
                # same node set guaranteed: count matches and every
                # touched node is known
                return patch_snapshot(prev, ls, sorted(affected))
        return compile_snapshot(ls)

    def invalidate(self) -> None:
        self._cache.clear()
