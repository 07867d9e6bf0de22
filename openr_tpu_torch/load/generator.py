"""Seedable open-loop KvStore event generator.

Synthesizes a realistic publication stream against a synthetic topology
(``openr_tpu_torch.models.topologies``): metric churn on existing adjacencies,
link flaps (adjacency withdrawn then restored), and prefix updates
(loopback advertisements toggled). The mix is seedable and the whole
schedule is deterministic given (topology, seed, mix) — the property the
shed-by-coalescing oracle-parity check rests on: the *surviving* event
list replayed unshedded must land on the same LSDB.

Ninth fault seam: ``load.generator``. Arming it makes generated events
drop before mutating generator state (a lossy publisher), so chaos
storms can run *under* sustained load while the parity oracle still
holds — dropped events mutate nothing and are excluded from replay.

Port note: a copy of ``openr_tpu/load/generator.py``; nothing left out.
For one topology, seed and mix it draws the reference's event stream byte
for byte (keys, versions, payloads).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.faults.injector import (
    FaultInjected,
    fault_point,
    register_fault_site,
)
from openr_tpu_torch.models.topologies import Topology
from openr_tpu_torch.types import (
    TTL_INFINITY,
    Adjacency,
    AdjacencyDatabase,
    BinaryAddress,
    IpPrefix,
    PrefixDatabase,
    PrefixEntry,
    Value,
)
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils import wire

FAULT_LOAD_GENERATOR = register_fault_site("load.generator")

KIND_METRIC = "metric_churn"
KIND_FLAP = "link_flap"
KIND_PREFIX = "prefix_update"
KIND_DRAIN = "drain_flip"


@dataclass(frozen=True)
class EventMix:
    """Relative weights of the event kinds (normalized at use).

    ``drain_flip`` (overload toggle — the twin's drain-sequencing
    scenario) defaults to 0.0 so every pre-existing (topology, seed,
    mix) schedule stays byte-identical: the kind pick still consumes
    exactly one RNG draw and the cumulative thresholds are unchanged
    when the new weight is zero."""

    metric_churn: float = 0.70
    link_flap: float = 0.15
    prefix_update: float = 0.15
    drain_flip: float = 0.0

    def cumulative(self) -> Tuple[float, float, float]:
        total = (self.metric_churn + self.link_flap
                 + self.prefix_update + self.drain_flip)
        assert total > 0
        c1 = self.metric_churn / total
        c2 = c1 + self.link_flap / total
        return (c1, c2, c2 + self.prefix_update / total)


@dataclass
class LoadEvent:
    """One generated publication (or a fault-dropped slot)."""

    seq: int
    kind: str
    node: str
    key: str = ""
    payload: Optional[bytes] = None
    version: int = 0
    dropped: bool = False


def _extra_prefix(node_idx: int) -> IpPrefix:
    # distinct from topologies._loopback_prefix's fd00::/16 range
    val = (0xFD10 << 112) | node_idx
    return IpPrefix(BinaryAddress(addr=val.to_bytes(16, "big")), 128)


class LoadGenerator:
    """Deterministic event stream over a mutable copy of ``topo``.

    The generator owns per-key version counters (continuing from the
    version-1 bulk initial load it also emits) and the evolving
    adjacency/prefix databases; ``next_event`` mutates that state and
    returns the key + serialized payload to publish.
    """

    def __init__(
        self,
        topo: Topology,
        seed: int = 0,
        mix: Optional[EventMix] = None,
    ):
        self._rng = random.Random(seed)
        self._mix = mix or EventMix()
        self.adj_dbs = dict(topo.adj_dbs)
        self.prefix_dbs = dict(topo.prefix_dbs)
        self._node_idx = {n: i for i, n in enumerate(sorted(self.adj_dbs))}
        self.versions: Dict[str, int] = {}
        # link flaps: (node, withdrawn Adjacency) awaiting restore
        self._down: List[Tuple[str, Adjacency]] = []
        # nodes currently advertising the extra prefix
        self._extra: Dict[str, bool] = {}
        self._seq = 0
        self.dropped = 0

    # -- initial load -----------------------------------------------------

    def initial_key_vals(self) -> Dict[str, Value]:
        """Version-1 Values for the whole topology, for one bulk
        ``set_key_vals`` (one debounce window, one cold build)."""
        out: Dict[str, Value] = {}
        for name in sorted(self.adj_dbs):
            key = keyutil.adj_key(name)
            payload = wire.dumps(self.adj_dbs[name])
            self.versions[key] = 1
            out[key] = Value(
                version=1,
                originator_id=name,
                value=payload,
                ttl=TTL_INFINITY,
                hash=wire.generate_hash(1, name, payload),
            )
        for name in sorted(self.prefix_dbs):
            key = keyutil.prefix_db_key(name)
            payload = wire.dumps(self.prefix_dbs[name])
            self.versions[key] = 1
            out[key] = Value(
                version=1,
                originator_id=name,
                value=payload,
                ttl=TTL_INFINITY,
                hash=wire.generate_hash(1, name, payload),
            )
        return out

    # -- event stream -----------------------------------------------------

    def next_event(self) -> LoadEvent:
        seq = self._seq
        self._seq += 1
        c1, c2, c3 = self._mix.cumulative()
        r = self._rng.random()
        kind = (
            KIND_METRIC if r < c1
            else KIND_FLAP if r < c2
            else KIND_PREFIX if r < c3
            else KIND_DRAIN
        )
        # the seam fires BEFORE any state mutation: a dropped event is a
        # pure no-op for the oracle (lossy publisher, not torn state)
        try:
            fault_point(FAULT_LOAD_GENERATOR)
        except FaultInjected:
            self.dropped += 1
            return LoadEvent(seq=seq, kind=kind, node="", dropped=True)
        if kind == KIND_METRIC:
            return self._metric_churn(seq)
        if kind == KIND_FLAP:
            return self._link_flap(seq)
        if kind == KIND_DRAIN:
            return self._drain_flip(seq)
        return self._prefix_update(seq)

    def events(self, n: int) -> List[LoadEvent]:
        return [self.next_event() for _ in range(n)]

    # -- scripted seams (the twin's scenario runner) ----------------------

    def emit_adjacency(
        self,
        node: str,
        db: Optional[AdjacencyDatabase] = None,
        kind: str = "scripted",
    ) -> LoadEvent:
        """Scripted-event seam: replace ``node``'s adjacency database
        (when given) and emit the publication event. Consumes NO RNG
        draws, so scripted steps interleave with the seeded stream
        without perturbing its schedule."""
        if db is not None:
            self.adj_dbs[node] = db
        seq = self._seq
        self._seq += 1
        return self._emit_adj(seq, kind, node)

    def emit_prefix(
        self,
        node: str,
        db: Optional[PrefixDatabase] = None,
        kind: str = KIND_PREFIX,
    ) -> LoadEvent:
        """Scripted prefix-advertisement seam (same no-RNG contract as
        ``emit_adjacency``)."""
        if db is not None:
            self.prefix_dbs[node] = db
        seq = self._seq
        self._seq += 1
        key = keyutil.prefix_db_key(node)
        v = self.versions[key] = self.versions.get(key, 0) + 1
        return LoadEvent(
            seq=seq,
            kind=kind,
            node=node,
            key=key,
            payload=wire.dumps(self.prefix_dbs[node]),
            version=v,
        )

    # -- kinds ------------------------------------------------------------

    def _emit_adj(self, seq: int, kind: str, node: str) -> LoadEvent:
        key = keyutil.adj_key(node)
        v = self.versions[key] = self.versions.get(key, 0) + 1
        return LoadEvent(
            seq=seq,
            kind=kind,
            node=node,
            key=key,
            payload=wire.dumps(self.adj_dbs[node]),
            version=v,
        )

    def _metric_churn(self, seq: int) -> LoadEvent:
        nodes = sorted(n for n, db in self.adj_dbs.items() if db.adjacencies)
        node = nodes[int(self._rng.random() * len(nodes)) % len(nodes)]
        db = self.adj_dbs[node]
        adjs = list(db.adjacencies)
        i = int(self._rng.random() * len(adjs)) % len(adjs)
        adjs[i] = replace(adjs[i], metric=1 + (adjs[i].metric % 10))
        self.adj_dbs[node] = replace(db, adjacencies=tuple(adjs))
        return self._emit_adj(seq, KIND_METRIC, node)

    def _link_flap(self, seq: int) -> LoadEvent:
        restore = bool(self._down) and self._rng.random() < 0.5
        if restore:
            node, adj = self._down.pop(0)
            db = self.adj_dbs[node]
            self.adj_dbs[node] = replace(
                db, adjacencies=db.adjacencies + (adj,)
            )
            return self._emit_adj(seq, KIND_FLAP, node)
        # withdraw one adjacency from a node that keeps >= 2 (never
        # isolate a node: an unreachable originator changes best-route
        # semantics, which would make parity depend on timing)
        nodes = sorted(
            n for n, db in self.adj_dbs.items() if len(db.adjacencies) >= 2
        )
        if not nodes:
            return self._metric_churn(seq)
        node = nodes[int(self._rng.random() * len(nodes)) % len(nodes)]
        db = self.adj_dbs[node]
        adjs = list(db.adjacencies)
        i = int(self._rng.random() * len(adjs)) % len(adjs)
        adj = adjs.pop(i)
        self.adj_dbs[node] = replace(db, adjacencies=tuple(adjs))
        self._down.append((node, adj))
        return self._emit_adj(seq, KIND_FLAP, node)

    def _drain_flip(self, seq: int) -> LoadEvent:
        """Drain/undrain: toggle ``is_overloaded`` on one node's
        adjacency database. An undrain is preferred when any node is
        drained and the coin lands that way (mirror of the flap
        restore discipline), and a node is never drained if that would
        leave zero undrained nodes — an all-overloaded fabric has no
        transit path at all, which would make parity timing-dependent
        the same way an isolated originator would."""
        drained = sorted(
            n for n, db in self.adj_dbs.items() if db.is_overloaded
        )
        undrain = bool(drained) and self._rng.random() < 0.5
        if undrain:
            node = drained[
                int(self._rng.random() * len(drained)) % len(drained)
            ]
            self.adj_dbs[node] = replace(
                self.adj_dbs[node], is_overloaded=False
            )
            return self._emit_adj(seq, KIND_DRAIN, node)
        candidates = sorted(
            n for n, db in self.adj_dbs.items() if not db.is_overloaded
        )
        if len(candidates) <= 1:
            return self._metric_churn(seq)
        node = candidates[
            int(self._rng.random() * len(candidates)) % len(candidates)
        ]
        self.adj_dbs[node] = replace(
            self.adj_dbs[node], is_overloaded=True
        )
        return self._emit_adj(seq, KIND_DRAIN, node)

    def _prefix_update(self, seq: int) -> LoadEvent:
        nodes = sorted(self.prefix_dbs)
        node = nodes[int(self._rng.random() * len(nodes)) % len(nodes)]
        db = self.prefix_dbs[node]
        extra = _extra_prefix(self._node_idx[node])
        if self._extra.get(node):
            del self._extra[node]
            entries = tuple(
                e for e in db.prefix_entries if e.prefix != extra
            )
        else:
            self._extra[node] = True
            base = db.prefix_entries[0] if db.prefix_entries else None
            entry = (
                replace(base, prefix=extra)
                if base is not None
                else PrefixEntry(prefix=extra)
            )
            entries = db.prefix_entries + (entry,)
        self.prefix_dbs[node] = replace(db, prefix_entries=entries)
        key = keyutil.prefix_db_key(node)
        v = self.versions[key] = self.versions.get(key, 0) + 1
        return LoadEvent(
            seq=seq,
            kind=KIND_PREFIX,
            node=node,
            key=key,
            payload=wire.dumps(self.prefix_dbs[node]),
            version=v,
        )
