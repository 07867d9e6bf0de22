"""The port's route plane under load against ``openr_tpu``'s: the load
generator, the sustained-load harness (KvStore -> Decision -> Fib) and
``chip_smoke.py``'s pipeline phases, rehearsed on the CPU.

Values cross between the packages as wire bytes, and the bar is
bit-identity. The generator must draw the reference's event stream byte
for byte (kinds, keys, versions, payloads) for the same topology, seed
and mix. The harness runs the port's pipeline on ``device="cpu"`` with
``solver_backend="device"`` (the kernels' plain versions); its live route
database must equal its own host oracle's replay and ``openr_tpu``'s host
Decision fed the same journal. Every wait is bounded, and every harness
is stopped before its test ends.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke
from openr_tpu.decision import decision as jax_decision
from openr_tpu.faults import FaultSchedule as JaxFaultSchedule
from openr_tpu.faults import get_injector as jax_injector
from openr_tpu.load import generator as jax_generator
from openr_tpu.load import harness as jax_harness
from openr_tpu.messaging.queue import ReplicateQueue as JaxQueue
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.types import Publication as JaxPublication
from openr_tpu.types import Value as JaxValue
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.decision import spf_solver
from openr_tpu_torch.faults import FaultSchedule, get_injector
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.load import AdmissionConfig, EventMix, LoadGenerator
from openr_tpu_torch.load import harness as port_harness
from openr_tpu_torch.models import topologies
from openr_tpu_torch.telemetry import reset_flight_recorder
from openr_tpu_torch.types import Value
from openr_tpu_torch.utils import wire

SEED = 20260805


@pytest.fixture(autouse=True)
def _fresh_singletons(tmp_path):
    get_injector().reset()
    jax_injector().reset()
    reset_flight_recorder(dump_dir=str(tmp_path / "port-flight"))
    yield
    get_injector().reset()
    jax_injector().reset()
    reset_flight_recorder()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


# -- the generator ---------------------------------------------------------------


def _stream(gen, n):
    return [(e.seq, e.kind, e.node, e.key, e.version, e.payload, e.dropped)
            for e in gen.events(n)]


MIXES = {
    "default": None,
    "with_drains": (0.55, 0.15, 0.15, 0.15),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, SEED])
def test_generator_matches_reference(seed, mix):
    """``fat_tree_nodes(64)``: the initial load and 500 events are the
    same bytes in both packages."""
    weights = MIXES[mix]
    port_topo, jax_topo = topologies.fat_tree_nodes(64), jax_topologies.fat_tree_nodes(64)
    assert wire.dumps(port_topo.adj_dbs) == jax_wire.dumps(jax_topo.adj_dbs)
    port = LoadGenerator(port_topo, seed=seed,
                         mix=EventMix(*weights) if weights else None)
    ref = jax_generator.LoadGenerator(jax_topo, seed=seed,
                                      mix=jax_generator.EventMix(*weights) if weights else None)
    assert wire.dumps(port.initial_key_vals()) == jax_wire.dumps(ref.initial_key_vals())
    got, want = _stream(port, 500), _stream(ref, 500)
    assert got == want
    kinds = {e[1] for e in got}
    assert {"metric_churn", "link_flap", "prefix_update"} <= kinds
    assert ("drain_flip" in kinds) == (weights is not None)
    # the generators' evolving databases end the same
    assert wire.dumps(port.adj_dbs) == jax_wire.dumps(ref.adj_dbs)
    assert wire.dumps(port.prefix_dbs) == jax_wire.dumps(ref.prefix_dbs)


def test_generator_fault_seam_matches_reference():
    """The ``load.generator`` seam armed ``fail_n(5)`` in both packages:
    the same five slots drop without touching the state, and the stream
    after them is the same bytes."""
    port = LoadGenerator(topologies.fat_tree_nodes(24), seed=SEED)
    ref = jax_generator.LoadGenerator(jax_topologies.fat_tree_nodes(24), seed=SEED)
    port.initial_key_vals()
    ref.initial_key_vals()
    get_injector().arm("load.generator", FaultSchedule.fail_n(5))
    jax_injector().arm("load.generator", JaxFaultSchedule.fail_n(5))
    got, want = _stream(port, 40), _stream(ref, 40)
    assert got == want
    assert [e[-1] for e in got[:6]] == [True] * 5 + [False]
    assert port.dropped == ref.dropped == 5
    assert port.versions == ref.versions


def test_percentiles_match_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100, 1001):
        samples = [float(x) for x in rng.exponential(20.0, n)]
        assert port_harness.percentiles(samples) == jax_harness.percentiles(samples)


# -- the harness -------------------------------------------------------------------


def _harness(nodes, **kwargs):
    return port_harness.SustainedLoadHarness(
        nodes=nodes, seed=SEED, solver_backend="device", debounce_max_s=0.05,
        admission=AdmissionConfig(shed_depth=4, cap_s=0.5), pipelined_emit=True,
        device="cpu", **kwargs)


def _reference_replay(h):
    """``openr_tpu``'s host Decision fed the port harness's journal as
    ``oracle_route_db`` feeds its own: the canonical RouteDatabase bytes."""

    def cross(value: Value) -> JaxValue:
        return jax_wire.loads(wire.dumps(value), JaxValue)

    kv_q = JaxQueue(name="oracle:kvstore")
    oracle = jax_decision.Decision(
        h.my_node, kvstore_updates_queue=kv_q,
        route_updates_queue=JaxQueue(name="oracle:routes"), solver_backend="host")
    try:
        oracle.process_publication(JaxPublication(
            key_vals={k: cross(v) for k, v in h._initial.items()}, area=h.area))
        for key, value in h._journal:
            oracle.process_publication(JaxPublication(key_vals={key: cross(value)}, area=h.area))
        oracle.pending.set_needs_full_rebuild()
        oracle.rebuild_routes("ORACLE")
        return jax_wire.dumps(oracle.route_db.to_route_db(h.my_node))
    finally:
        kv_q.close()


@pytest.mark.parametrize("nodes", [16, 64])
def test_harness_live_routes_match_reference_replay(nodes):
    """A short fixed-rate window through the port's pipeline on the CPU:
    it drains, every trace is well formed, e2e samples were taken, the
    live route database equals the harness's own oracle, and its bytes
    equal ``openr_tpu``'s host Decision replaying the same journal."""
    h = _harness(nodes)
    h.start(initial_timeout_s=120.0)
    try:
        report = h.run_fixed_rate(60, 1.0, p99_slo_ms=5000.0)
        assert report.published > 0 and report.published == len(h._journal)
        assert report.drained
        assert report.traces_malformed == 0
        assert report.e2e_samples > 0 and report.e2e_ms["p99"] is not None
        assert h.check_parity()
        live = h.live_route_db().to_route_db(h.my_node)
        assert len(live.unicast_routes) > 0
        assert wire.dumps(live) == _reference_replay(h)
    finally:
        h.stop()


def test_queue_reader_never_delivers_an_older_value_after_a_drain():
    """Decision's admission path drains its reader inside a callback. The
    event base's reader must not have taken a later message off the queue
    while that callback runs: it would then be delivered after the newer
    ones the drain applied, and Decision would keep a superseded LSDB
    value (a live route database unequal to the replay, seen once in a
    few dozen 15 s windows at 1008 nodes). Here the reader's thread is
    slowed after each take, as when it waits for the interpreter lock
    under load, and the first callback waits until the whole backlog is
    queued, then drains it."""
    import threading
    import time

    from openr_tpu_torch.load.admission import AdmissionControl
    from openr_tpu_torch.messaging.queue import ReplicateQueue
    from openr_tpu_torch.types import Publication
    from openr_tpu_torch.utils.eventbase import OpenrEventBase

    versions = 20
    q = ReplicateQueue(name="")
    reader = q.get_reader("decision:test")
    take = reader.get

    def slow_take(timeout=None):
        item = take(timeout=timeout)
        time.sleep(0.01)
        return item

    reader.get = slow_take
    admission = AdmissionControl(AdmissionConfig(shed_depth=1))
    evb = OpenrEventBase("reorder")
    applied = []
    backlog = threading.Event()

    def on_publication(pub):
        if not applied:
            assert backlog.wait(timeout=10.0)
            time.sleep(0.05)  # time for a reader that forwards ahead to take one
        for p in admission.admit(pub, reader).publications:
            applied.extend(v.version for v in p.key_vals.values())

    evb.add_queue_reader(reader, on_publication)
    evb.run_in_thread()
    try:
        for version in range(1, versions + 1):
            q.push(Publication(key_vals={"adj:node-1": Value(version=version)}, area="0"))
        backlog.set()
        deadline = time.monotonic() + 10.0
        while (not applied or applied[-1] != versions) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)  # anything delivered late would land here
    finally:
        evb.stop()
        q.close()
        evb.join()
    assert applied[-1] == versions
    assert applied == sorted(applied), applied


def test_oracle_replay_refuses_a_kernel_launch(monkeypatch):
    """``oracle_route_db`` raises if a launch count moved across the
    replay: the oracle must stay on the host."""
    h = _harness(16)
    h.start(initial_timeout_s=120.0)
    try:
        from openr_tpu_torch.decision.decision import Decision

        real = Decision.rebuild_routes

        def launching(self, event):
            LAUNCHES["minplus"] += 1
            return real(self, event)

        monkeypatch.setattr(Decision, "rebuild_routes", launching)
        try:
            with pytest.raises(AssertionError, match="launched a kernel"):
                h.oracle_route_db()
        finally:
            LAUNCHES["minplus"] = 0
    finally:
        h.stop()


def test_harness_raises_without_cuda(monkeypatch):
    """The harness follows the port's device rule: with no device given
    it runs on the card, and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_harness.SustainedLoadHarness(nodes=16)


# -- chip_smoke's pipeline phases, rehearsed ----------------------------------------


def test_chip_smoke_pipeline_phases_rehearsal(monkeypatch, capsys):
    """``chip_smoke.pipeline_phases`` on the CPU at 16 nodes (dense) and
    64 (sparse: the threshold lowered), with short windows and a one-probe
    search: both phases emit their line, every window drained with e2e
    samples and no malformed trace, the parities hold and the oracle
    launched nothing."""
    monkeypatch.setattr(spf_solver, "SPARSE_NODE_THRESHOLD", 32)
    search = {"p99_slo_ms": 5000.0, "lo": 10, "hi": 40, "duration_s": 0.3, "max_probes": 1}
    small, large = chip_smoke.pipeline_phases(
        torch.device("cpu"), 16, 64, (40,), (20, 30), 0.6, search, profiled_s=0.3)
    assert small == large == {k: 0 for k in LAUNCHES}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    by_phase = {line["phase"]: line for line in lines}
    assert set(by_phase) == {"pipeline-16", "pipeline-64"}
    dense, sparse = by_phase["pipeline-16"], by_phase["pipeline-64"]
    assert dense["kernel"] == "minplus" and sparse["kernel"] == "ell_band_relax"
    for line, rates in ((dense, [40]), (sparse, [20, 30])):
        assert [w["rate"] for w in line["windows"]] == rates
        for w in line["windows"]:
            assert w["drained"] and w["e2e_samples"] > 0 and w["traces_malformed"] == 0
            assert w["rebuilds"] > 0 and w["gc_ms"] >= 0
        assert line["parity_with_oracle_replay"] is True
        assert line["oracle_launches"] == {}
        assert line["initial"]["rebuilds"] >= 1
        assert line["profiled_window"] is None  # no profiler without the card
        assert line["counters"]["decision.fallbacks"] == 0
        assert line["counters"]["decision.spf_host_fallback"] == 0
        assert line["t_s"] > 0
    assert dense["parity_with_host_dijkstra"] is True
    assert sparse["parity_with_host_dijkstra"] is None and sparse["search"] is None
    # the sparse rebuilds patched the resident bands
    assert sparse["counters"]["decision.ell_patches"] > 0
    found = dense["search"]
    assert found["probes"] == len(found["ladder"]) == 2
    assert found["ladder"][0]["rate"] == 10
    assert found["max_sustainable_rate"] in (0, 10, 25)
