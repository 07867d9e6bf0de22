"""The port's copies of the telemetry, wire and dispatch-accounting
modules against ``openr_tpu``'s.

- Wire bytes round-trip both ways, for every type Decision reads from a
  publication (adjacency and prefix databases, with metric vectors, perf
  events, LAG members and every forwarding type and algorithm): what
  one package encodes the other decodes into its own types, and encodes
  back to the same bytes.
- ``event_window``: nesting joins the outer window; ``count_dispatch``,
  ``sync_flag`` and ``reap_read`` counted on CPU tensors, the relax loops'
  and readbacks' syncs counted, and a hand-kernel wrapper's launch
  counted in ``ops.host_dispatches`` beside its ``LAUNCHES`` count.
- The registry's ``counter_dict`` shim and histogram quantiles, held
  against the reference on the same inputs.
Exact equality throughout (bytes, counts, quantiles).
"""

from __future__ import annotations

import random
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu.telemetry.registry import Registry as JaxRegistry
from openr_tpu.types import PrefixDatabase as JaxPrefixDatabase
from openr_tpu.types import PrefixEntry as JaxPrefixEntry
from openr_tpu.types import PerfEvents as JaxPerfEvents
from openr_tpu.types.lsdb import CompareType as JaxCompareType
from openr_tpu.types.lsdb import MetricEntity as JaxMetricEntity
from openr_tpu.types.lsdb import MetricVector as JaxMetricVector
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.kernels import LAUNCHES, note_launch, reset_launches
from openr_tpu_torch.models import topologies
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import spf as spf_ops
from openr_tpu_torch.ops.staging import Readback
from openr_tpu_torch.telemetry import get_profiler, get_registry
from openr_tpu_torch.telemetry.registry import Registry
from openr_tpu_torch.types import AdjacencyDatabase, PrefixDatabase
from openr_tpu_torch.types import Publication, Value
from openr_tpu_torch.utils import wire


def _jax_dbs():
    """Adjacency and prefix databases of a fabric and a LAG graph, plus a
    prefix database with every optional field set."""
    out = []
    for topo in (
        jax_topologies.fat_tree_nodes(60, forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP,
                                      forwarding_type=JaxFwdType.SR_MPLS),
        jax_topologies.build_topology("lag", [("a", "b", 1), ("a", "b", 3), ("b", "c", 2)],
                                      v4_prefixes=True),
    ):
        out += [(db, AdjacencyDatabase) for db in topo.adj_dbs.values()]
        out += [(db, PrefixDatabase) for db in topo.prefix_dbs.values()]
    adj = next(iter(topo.adj_dbs.values()))
    perf = JaxPerfEvents()
    perf.add("a", "ADJ_DB_UPDATED")
    out.append((replace(adj, is_overloaded=True, perf_events=perf, node_label=70000),
                AdjacencyDatabase))
    pfx = next(iter(topo.prefix_dbs.values())).prefix_entries[0]
    mv = JaxMetricVector(version=1, metrics=(
        JaxMetricEntity(type=1, priority=10, op=JaxCompareType.WIN_IF_PRESENT,
                        is_best_path_tie_breaker=True, metric=(3, -4)),))
    entry = JaxPrefixEntry(
        prefix=pfx.prefix, forwarding_type=JaxFwdType.SR_MPLS,
        forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP, mv=mv, min_nexthop=2,
        prepend_label=65001, area_stack=("1", "2"), tags=frozenset({"x", "y"}))
    out.append((JaxPrefixDatabase(this_node_name="c", prefix_entries=(entry,), area="7",
                                  delete_prefix=False), PrefixDatabase))
    out.append((JaxPrefixDatabase(this_node_name="c", delete_prefix=True, area="7"),
                PrefixDatabase))
    return out


def test_wire_bytes_round_trip_both_ways():
    for jax_db, port_cls in _jax_dbs():
        raw = jax_wire.dumps(jax_db)
        db = wire.loads(raw, port_cls)
        assert type(db) is port_cls
        assert wire.dumps(db) == raw
        back = jax_wire.loads(wire.dumps(db), type(jax_db))
        assert back == jax_db


def test_port_encodes_its_own_objects_as_the_reference_does():
    topo = topologies.fat_tree_nodes(60)
    jax_topo = jax_topologies.fat_tree_nodes(60)
    for name in topo.adj_dbs:
        assert wire.dumps(topo.adj_dbs[name]) == jax_wire.dumps(jax_topo.adj_dbs[name])
        assert wire.dumps(topo.prefix_dbs[name]) == jax_wire.dumps(jax_topo.prefix_dbs[name])
    # the KvStore container types, and the hash over them
    v = Value(version=3, originator_id="a", value=b"xyz")
    from openr_tpu.types import Value as JaxValue

    assert wire.dumps(v) == jax_wire.dumps(JaxValue(version=3, originator_id="a", value=b"xyz"))
    assert wire.generate_hash(3, "a", b"xyz") == jax_wire.generate_hash(3, "a", b"xyz")
    pub = Publication(key_vals={"adj:a": v}, area="0")
    assert wire.loads(wire.dumps(pub), Publication) == pub


def test_wire_refuses_a_foreign_type_name():
    raw = jax_wire.dumps(jax_topologies.grid(2).adj_dbs["node-0"])
    with pytest.raises(TypeError, match="expected 'PrefixDatabase'"):
        wire.loads(raw, PrefixDatabase)


# -- dispatch accounting --------------------------------------------------------


def _counts(reg):
    return {k: reg.counter_get(k) for k in
            ("ops.host_dispatches", "ops.blocking_syncs")}


def _delta(now, then):
    return {k: now[k] - then[k] for k in now}


def test_event_window_nesting_joins_the_outer_window():
    reg = get_registry()
    c0 = _counts(reg)
    with da.event_window("outer") as w:
        da.count_dispatch()
        da.count_dispatch(2)
        with da.event_window("inner") as inner:
            assert inner is w
            assert da.sync_flag(torch.tensor(True))
            da.count_dispatch()
        assert da.current_window() is w
        np.testing.assert_array_equal(
            da.reap_read(torch.arange(4, dtype=torch.int32)), np.arange(4))
        np.testing.assert_array_equal(da.reap_read(torch.ones(2)), np.ones(2))
    assert da.current_window() is None
    assert (w.dispatches, w.blocking_syncs) == (4, 3)
    # submit, read, submit, read: a phase a run of one kind
    assert (w.submit_phases, w.read_phases, w.touches) == (2, 2, 4)
    assert _delta(_counts(reg), c0) == {
        "ops.host_dispatches": 4, "ops.blocking_syncs": 3}
    # counted globally outside any window too
    da.count_dispatch()
    assert _delta(_counts(reg), c0)["ops.host_dispatches"] == 5


def test_relax_loop_and_readback_count_their_syncs():
    """The dense relax loop syncs once a hop and its readback once, on CPU
    tensors too; the plain versions launch no kernel, so no dispatch."""
    reset_launches()
    topo = topologies.grid(3)
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.graph.snapshot import SnapshotCache

    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    cache = SnapshotCache("cpu")
    snap = cache.get(ls)
    dev = snap.device_arrays(cache.device, cache.stager)
    _, srcs = spf_ops.source_batch(snap, 0, cache.device, cache.stager)
    with da.event_window("view") as w:
        packed = spf_ops.spf_view_batch_packed(dev.metric, dev.overloaded, srcs)
        rows = Readback(packed).reap()
    assert rows.shape[0] == 2 * srcs.shape[0]
    # 3x3 grid: diameter 4, so a few hops, each one sync; plus the readback
    assert w.blocking_syncs >= 3 and w.dispatches == 0
    assert all(v == 0 for v in LAUNCHES.values())


def test_a_kernel_launch_counts_one_host_dispatch():
    reg = get_registry()
    before = reg.counter_get("ops.host_dispatches")
    with da.event_window("launch") as w:
        note_launch("minplus")
    assert LAUNCHES["minplus"] == 1 and w.dispatches == 1
    assert reg.counter_get("ops.host_dispatches") == before + 1
    reset_launches()


def test_profiler_annotates_and_times_cpu_dispatches():
    prof = get_profiler()
    with prof.annotate("decision.test"):
        x = torch.ones(3) + 1
    assert prof.start("decision.test", "cpu") is None
    assert prof.on_dispatch("decision.test", x, 2.5) == 2.5
    assert get_registry().histogram_if_exists("ops.host_ms.decision.test").count >= 1


# -- the registry ---------------------------------------------------------------


def test_counter_dict_shim_matches_reference():
    ours, theirs = Registry(), JaxRegistry()
    d_ours = ours.counter_dict(["x", "y"], prefix="decision.")
    d_theirs = theirs.counter_dict(["x", "y"], prefix="decision.")
    for d in (d_ours, d_theirs):
        d["x"] += 3
        d["z"] = 5  # a key first written late registers
        assert d["w"] == 0  # a key read before a write registers at 0
    assert dict(d_ours) == dict(d_theirs) == {"x": 3, "y": 0, "z": 5, "w": 0}
    assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    assert dict(d_ours) == {"x": 0, "y": 0, "z": 0, "w": 0}


def test_histogram_quantiles_match_reference():
    rng = random.Random(7)
    values = [rng.expovariate(0.1) for _ in range(3000)]
    ours, theirs = Registry(), JaxRegistry()
    for v in values:
        ours.observe("decision.rebuild_ms", v)
        theirs.observe("decision.rebuild_ms", v)
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.percentile("decision.rebuild_ms", q) == theirs.percentile("decision.rebuild_ms", q)
    assert ours.snapshot() == theirs.snapshot()
