"""Sustained-load harness: drive the real pipeline at a target rate.

Assembles the actual KvStore → Decision → Fib module pipeline (same
wiring as the daemon: ReplicateQueues between per-module event bases),
pumps a seeded ``LoadGenerator`` stream at a target events/s, and
measures:

- p50/p95/p99 end-to-end convergence, sampled per retired trace through
  the tracer's finish-listener (the 256-deep export ring overflows in
  ~1 s at these rates);
- queue backpressure: reader depth high-watermark during the window,
  drain time after it, overflow/shed/coalesce counters;
- WARM/cold solve mix from the telemetry registry.

Two modes: ``run_fixed_rate`` (one sustained window + drain + verdict)
and ``find_max_sustainable_rate`` (binary search for the highest rate
whose p99 meets the SLO and whose backlog drains).

Oracle parity: every published event is journaled; ``check_parity``
replays the journal — unshedded, single-threaded — through a fresh
Decision and compares canonical RouteDatabases bit-for-bit, proving
shed-by-coalescing and pipelined emit never changed net effect.

Port note: a port of ``openr_tpu/load/harness.py``. The harness takes
``device=`` (None: the card; without CUDA it raises unless given
``device="cpu"``) and hands it to its pipeline Decision, whose device
backend runs the port's kernels on its event base. The oracle replays on
the caller's thread with the host backend on the CPU, and must launch no
kernel: ``oracle_route_db`` raises if a launch count moved across it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.device import DeviceLike
from openr_tpu_torch.load.admission import AdmissionConfig, AdmissionControl
from openr_tpu_torch.load.generator import EventMix, LoadGenerator
from openr_tpu_torch.models import topologies
from openr_tpu_torch.telemetry import get_registry, get_tracer
from openr_tpu_torch.types import DEFAULT_AREA, KeySetParams, Publication, Value
from openr_tpu_torch.utils import wire

# registry counters reported per window (as deltas across the window)
_WINDOW_COUNTERS = (
    "decision.admission.sheds",
    "decision.admission.shed_keys",
    "decision.admission.pubs_coalesced",
    "decision.admission.prewarm_skipped",
    "decision.coalesced_publications",
    "decision.debounce_widenings",
    "decision.debounce_narrowings",
    "decision.debounce_spans_reclaimed",
    "decision.ell_patches",
    "decision.ell_full_compiles",
    "decision.device_state_resets",
    "telemetry.traces_merged",
    "telemetry.traces_unclosed_spans",
    "telemetry.traces_bad_nesting",
    "faults.injected.load.generator",
)


def percentiles(samples: List[float]) -> Dict[str, Optional[float]]:
    """p50/p95/p99 with linear interpolation (same convention as the
    benchmark suite's _latency_percentiles)."""
    out: Dict[str, Optional[float]] = {"p50": None, "p95": None, "p99": None}
    if not samples:
        return out
    s = sorted(samples)

    def rank(q: float) -> float:
        if len(s) == 1:
            return s[0]
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    out["p50"] = round(rank(0.50), 3)
    out["p95"] = round(rank(0.95), 3)
    out["p99"] = round(rank(0.99), 3)
    return out


@dataclass
class RateReport:
    """One fixed-rate window's outcome."""

    rate: int
    duration_s: float
    offered: int = 0  # generator events drawn (incl. fault-dropped)
    published: int = 0
    gen_dropped: int = 0  # load.generator seam drops
    achieved_rate: float = 0.0
    e2e_ms: Dict[str, Optional[float]] = field(default_factory=dict)
    e2e_samples: int = 0
    traces_malformed: int = 0
    depth_hwm: int = 0
    drain_s: Optional[float] = None
    drained: bool = False
    counters: Dict[str, float] = field(default_factory=dict)
    sustainable: Optional[bool] = None

    def to_dict(self) -> dict:
        return {
            "rate": self.rate,
            "duration_s": self.duration_s,
            "offered": self.offered,
            "published": self.published,
            "gen_dropped": self.gen_dropped,
            "achieved_rate": round(self.achieved_rate, 1),
            "e2e_ms": self.e2e_ms,
            "e2e_samples": self.e2e_samples,
            "traces_malformed": self.traces_malformed,
            "depth_hwm": self.depth_hwm,
            "drain_s": (
                round(self.drain_s, 3) if self.drain_s is not None else None
            ),
            "drained": self.drained,
            "counters": self.counters,
            "sustainable": self.sustainable,
        }


class SustainedLoadHarness:
    """Owns the pipeline + generator + journal for one load run."""

    def __init__(
        self,
        nodes: int = 64,
        seed: int = 20260805,
        mix: Optional[EventMix] = None,
        solver_backend: str = "host",
        debounce_min_s: float = 0.010,
        debounce_max_s: float = 0.100,
        admission: Optional[AdmissionConfig] = None,
        pipelined_emit: bool = True,
        area: str = DEFAULT_AREA,
        device: DeviceLike = None,
    ):
        # real-module imports live here so importing openr_tpu_torch.load (as
        # decision does, for the admission half) never pulls in Decision
        from openr_tpu_torch.decision.decision import Decision
        from openr_tpu_torch.fib.fib import Fib
        from openr_tpu_torch.kvstore.wrapper import KvStoreWrapper
        from openr_tpu_torch.messaging.queue import ReplicateQueue
        from openr_tpu_torch.platform.fib_service import MockFibAgent

        self.area = area
        self.topo = topologies.fat_tree_nodes(nodes)
        self.generator = LoadGenerator(self.topo, seed=seed, mix=mix)
        self.my_node = next(
            k for k in sorted(self.topo.adj_dbs) if k.startswith("rsw")
        )
        self.store = KvStoreWrapper(f"load:{self.my_node}", areas=[area])
        self.route_q = ReplicateQueue(name="routeUpdates")
        self.decision = Decision(
            self.my_node,
            kvstore_updates_queue=self.store.store.updates_queue,
            route_updates_queue=self.route_q,
            debounce_min_s=debounce_min_s,
            debounce_max_s=debounce_max_s,
            solver_backend=solver_backend,
            admission=AdmissionControl(admission or AdmissionConfig()),
            pipelined_emit=pipelined_emit,
            device=device,
        )
        self.fib = Fib(
            self.my_node,
            MockFibAgent(),
            self.route_q,
            keepalive_interval_s=30.0,
            area=area,
        )
        self._solver_backend = solver_backend
        # parity journal: (key, Value) in publish order, plus the bulk
        # initial load — everything the oracle replays
        self._initial: Dict[str, Value] = {}
        self._journal: List[Tuple[str, Value]] = []
        self._started = False

    # -- lifecycle --------------------------------------------------------

    def start(self, initial_timeout_s: float = 600.0) -> None:
        self.store.start()
        self.decision.start()
        self.fib.start()
        self._initial = self.generator.initial_key_vals()
        self.store.store.set_key_vals(
            self.area, KeySetParams(key_vals=dict(self._initial))
        )
        assert self._wait_until(
            lambda: len(self.fib.get_route_db().unicast_routes) > 0,
            initial_timeout_s,
        ), "initial convergence timed out"
        self.drain()
        self._started = True

    def stop(self) -> None:
        self.fib.stop()
        self.decision.stop()
        self.store.stop()
        self._started = False

    def __enter__(self) -> "SustainedLoadHarness":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- load -------------------------------------------------------------

    def run_fixed_rate(
        self,
        rate: int,
        duration_s: float,
        drain_grace_s: float = 20.0,
        p99_slo_ms: Optional[float] = None,
    ) -> RateReport:
        """One open-loop window at ``rate`` events/s, then a bounded
        drain. The publisher never blocks on the pipeline (that's the
        point); backpressure shows up as reader depth, widened
        debounce, and shed counters instead."""
        assert self._started, "call start() first"
        report = RateReport(rate=rate, duration_s=duration_s)
        samples: List[float] = []
        malformed = [0]
        lock = threading.Lock()

        def on_finish(trace, ok: bool) -> None:
            with lock:
                if not (ok and trace.well_formed()):
                    malformed[0] += 1
                elif trace.e2e_ms is not None:
                    samples.append(trace.e2e_ms)

        tracer = get_tracer()
        reg = get_registry()
        c0 = {k: reg.counter_get(k) for k in _WINDOW_COUNTERS}
        tracer.add_finish_listener(on_finish)
        reader = self.decision._kv_reader
        interval = 1.0 / max(1, rate)
        t0 = time.monotonic()
        deadline = t0
        try:
            while True:
                now = time.monotonic()
                if now - t0 >= duration_s:
                    break
                ev = self.generator.next_event()
                report.offered += 1
                if ev.dropped:
                    report.gen_dropped += 1
                else:
                    self.store.set_key(
                        ev.key,
                        ev.payload,
                        version=ev.version,
                        area=self.area,
                        originator=ev.node,
                    )
                    self._journal.append(
                        (
                            ev.key,
                            Value(
                                version=ev.version,
                                originator_id=ev.node,
                                value=ev.payload,
                                ttl=self._initial[ev.key].ttl,
                                hash=wire.generate_hash(
                                    ev.version, ev.node, ev.payload
                                ),
                            ),
                        )
                    )
                    report.published += 1
                report.depth_hwm = max(report.depth_hwm, reader.size())
                deadline += interval
                sleep = deadline - time.monotonic()
                if sleep > 0:
                    time.sleep(sleep)
            elapsed = time.monotonic() - t0
            report.achieved_rate = (
                report.offered / elapsed if elapsed > 0 else 0.0
            )
            t_drain0 = time.monotonic()
            report.drained = self.drain(timeout_s=drain_grace_s)
            report.drain_s = time.monotonic() - t_drain0
        finally:
            tracer.remove_finish_listener(on_finish)
        with lock:
            report.e2e_ms = percentiles(samples)
            report.e2e_samples = len(samples)
            report.traces_malformed = malformed[0]
        report.counters = {
            k: reg.counter_get(k) - c0[k]
            for k in _WINDOW_COUNTERS
            if reg.counter_get(k) - c0[k]
        }
        if p99_slo_ms is not None:
            p99 = report.e2e_ms.get("p99")
            report.sustainable = bool(
                report.drained
                and report.e2e_samples > 0
                and p99 is not None
                and p99 <= p99_slo_ms
            )
        return report

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait for the pipeline to go quiescent: empty Decision reader,
        no pending debounce, emit stage flushed, Fib caught up."""
        reader = self.decision._kv_reader
        debounce = self.decision._rebuild_debounced
        ok = self._wait_until(
            lambda: reader.size() == 0 and not debounce.is_scheduled(),
            timeout_s,
        )
        # flush the pipelined emit stage and any queued evb callbacks
        self.decision.evb.call_and_wait(self.decision._drain_emit)
        # Fib: its reader must drain too (route programming is the last
        # trace stage)
        reg = get_registry()
        stable_since = time.monotonic()
        last = reg.counter_get("telemetry.traces_finished")
        deadline = time.monotonic() + max(2.0, timeout_s / 4)
        while time.monotonic() < deadline:
            time.sleep(0.05)
            cur = reg.counter_get("telemetry.traces_finished")
            if cur != last:
                last = cur
                stable_since = time.monotonic()
            elif time.monotonic() - stable_since > 0.4:
                break
        return ok

    @staticmethod
    def _wait_until(pred, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.005)
        return bool(pred())

    # -- oracle parity ----------------------------------------------------

    def oracle_route_db(self):
        """Replay the journal — full, unshedded, single-threaded — into
        a fresh Decision on the deterministic host backend and return
        its final DecisionRouteDb."""
        from openr_tpu_torch.decision.decision import Decision
        from openr_tpu_torch.kernels import LAUNCHES
        from openr_tpu_torch.messaging.queue import ReplicateQueue

        kv_q = ReplicateQueue(name="oracle:kvstore")
        oracle = Decision(
            self.my_node,
            kvstore_updates_queue=kv_q,
            route_updates_queue=ReplicateQueue(name="oracle:routes"),
            solver_backend="host",
            device="cpu",
        )
        launches = dict(LAUNCHES)
        try:
            oracle.process_publication(
                Publication(key_vals=dict(self._initial), area=self.area)
            )
            for key, value in self._journal:
                oracle.process_publication(
                    Publication(key_vals={key: value}, area=self.area)
                )
            oracle.pending.set_needs_full_rebuild()
            oracle.rebuild_routes("ORACLE")
            if dict(LAUNCHES) != launches or oracle.spf_solver.backend != "host":
                raise AssertionError(
                    "the oracle replay launched a kernel or left the host "
                    f"backend: {launches} -> {dict(LAUNCHES)}"
                )
            return oracle.route_db
        finally:
            kv_q.close()  # releases the oracle's reader forwarder thread

    def live_route_db(self):
        """The pipeline Decision's installed DecisionRouteDb (call after
        ``drain()``)."""
        self.decision.evb.call_and_wait(self.decision._drain_emit)
        return self.decision.route_db

    def check_parity(self) -> bool:
        """Shed-by-coalescing + pipelined emit vs the unshedded oracle:
        the canonical RouteDatabase must match bit for bit. The live
        solve may have run on a different backend than the host oracle —
        cross-backend parity is the parity suite's own guarantee."""
        live = wire.dumps(self.live_route_db().to_route_db(self.my_node))
        want = wire.dumps(self.oracle_route_db().to_route_db(self.my_node))
        return live == want

    # -- closed-loop controller ------------------------------------------

    def find_max_sustainable_rate(
        self,
        p99_slo_ms: float,
        lo: int = 25,
        hi: int = 800,
        duration_s: float = 2.0,
        max_probes: int = 6,
    ) -> dict:
        """Binary-search the highest events/s whose p99 meets the SLO
        and whose backlog drains. ``lo`` is assumed (and verified)
        sustainable; ``hi`` is the search ceiling."""
        ladder: List[RateReport] = []
        floor = self.run_fixed_rate(
            lo, duration_s, p99_slo_ms=p99_slo_ms
        )
        ladder.append(floor)
        best = lo if floor.sustainable else 0
        if floor.sustainable:
            probes = 0
            lo_r, hi_r = lo, hi
            while probes < max_probes and hi_r - lo_r > max(1, lo // 4):
                mid = (lo_r + hi_r) // 2
                rep = self.run_fixed_rate(
                    mid, duration_s, p99_slo_ms=p99_slo_ms
                )
                ladder.append(rep)
                probes += 1
                if rep.sustainable:
                    best = max(best, mid)
                    lo_r = mid
                else:
                    hi_r = mid
        return {
            "slo_p99_ms": p99_slo_ms,
            "max_sustainable_rate": best,
            "probes": len(ladder),
            "ladder": [r.to_dict() for r in ladder],
        }
