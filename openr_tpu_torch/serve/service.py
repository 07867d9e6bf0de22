"""SolverService: the device-owning solver process.

Ownership inversion over the rest of the tree: everywhere else the
Decision instance owns its engines and the device; here a standalone
serving process owns ONE private ``WorldManager`` (and through it the
device blocks) and many client daemons talk to it over the ctrl
transport. The scheduler is continuous batching as practiced by
inference servers, mapped onto the tenant plane:

- **Wave loop.** One background thread drains the pending-request
  table into bucket *waves*: each wave syncs + solves every admitted
  tenant in as few fused ``world_dispatch`` calls as the shape buckets
  allow (``WorldManager.solve_views``). Requests that arrive while a
  wave is in flight join the NEXT wave (``tenancy.wave_joins``) — the
  zero-retrace bucket-join contract makes that join free of compiles,
  which is what makes mid-flight joining worth doing at all.

- **SLO classes.** Every tenant carries a class (``premium`` /
  ``standard`` / ``bulk``, serve/slo.py). Wave admission orders
  pending requests by (class priority, arrival seq) and cuts at the
  wave budget: a premium request arriving late still rides the next
  wave ahead of earlier bulk arrivals (counted in
  ``tenancy.wave_preemptions``), and bulk requests absorb whatever
  budget the higher classes leave (they are never starved outright —
  the cut is a budget, not a filter, so leftover bulk rides the
  following wave).

- **Occupancy-sized dispatch.** After waves settle, buckets whose
  vacancy exceeds ~50% are compacted to the power-of-two width that
  fits their occupants (``WorldManager.compact_buckets``) so a
  half-empty fleet stops paying full-width solves.

- **Fault seams.** ``serve.client_disconnect`` fires at result
  delivery: a vanished client's tenants are parked WARM (slot freed,
  mirror + journal kept — the bucket is never poisoned and a
  reconnect rehydrates). ``serve.slow_client`` fires on the ctrl
  reply path (ctrl/solver.py), stalling only that client's connection
  thread, never the wave loop.

Telemetry: ``serve.requests`` / ``serve.waves`` / ``serve.errors`` /
``serve.disconnect_detaches`` counters, ``serve.latency_ms.<class>``
per-class histograms (p99 drives the SLO gate), plus the tenancy
counters the wave loop feeds (wave_joins / wave_preemptions /
wave_occupancy / bucket_compactions).

Port note: a copy of ``openr_tpu/serve/service.py``; the service takes
the ``device`` its private ``WorldManager`` holds its blocks on (None =
CUDA; raises without CUDA unless given ``device="cpu"``) and exposes it
as ``device``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set

from openr_tpu_torch.analysis.annotations import flight_callback
from openr_tpu_torch.device import DeviceLike
from openr_tpu_torch.faults import (
    FaultInjected,
    fault_point,
    register_fault_site,
)
from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
from openr_tpu_torch.serve.slo import SLO_TABLE, order_requests
from openr_tpu_torch.telemetry import (
    P99BreachTrigger,
    get_flight_recorder,
    get_profiler,
    get_registry as _get_registry,
    get_tracer,
    install_default_triggers,
)

FAULT_CLIENT_DISCONNECT = register_fault_site("serve.client_disconnect")
FAULT_SLOW_CLIENT = register_fault_site("serve.slow_client")


class SolveRequest:
    """One pending tenant solve: latest-wins per tenant (a newer
    request for the same tenant supersedes the queued one — the solve
    always runs against the tenant's CURRENT LinkState, so coalescing
    is free), delivered through an event the caller blocks on."""

    __slots__ = (
        "tenant_id", "ls", "root", "slo", "seq", "enqueued",
        "event", "view", "error", "superseded", "trace_ctx",
    )

    def __init__(self, tenant_id: str, ls, root: str, slo: str,
                 seq: int, trace_ctx: Optional[Dict] = None):
        self.tenant_id = tenant_id
        self.ls = ls
        self.root = root
        self.slo = slo
        self.seq = seq
        # client-stamped trace context off the wire ({"trace_id",
        # "span_id", ...}): adopted into the wave span + flight record
        # that serve this request, closing the cross-wire trace
        self.trace_ctx = trace_ctx
        self.enqueued = time.perf_counter()
        self.event = threading.Event()
        self.view = None
        self.error: Optional[BaseException] = None
        # waiters on requests this one coalesced over: they are served
        # with THIS request's result (the wave solves the tenant's
        # current world, which answers every superseded ask)
        self.superseded: List["SolveRequest"] = []

    def deliver(self, view=None,
                error: Optional[BaseException] = None) -> None:
        for r in [self] + self.superseded:
            r.view = view
            r.error = error
            r.event.set()

    def wait(self, timeout: float = 60.0):
        if not self.event.wait(timeout):
            raise TimeoutError(
                f"solve({self.tenant_id!r}) not served in {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.view


class SolverService:
    """The serving process's core (transport-free; ctrl/solver.py puts
    it behind the wire). Thread model: ctrl connection threads enqueue
    requests and block on their events; ONE wave thread owns every
    WorldManager mutation (the manager is not thread-safe), with
    ``_mgr_lock`` serializing the few out-of-wave touches (register /
    detach / ksp2 view)."""

    def __init__(
        self,
        manager: Optional[WorldManager] = None,
        wave_budget: Optional[int] = None,
        compaction_vacancy: float = 0.5,
        compact_every: int = 16,
        device: DeviceLike = None,
    ):
        # PRIVATE manager by default: the service owns the device; it
        # deliberately does not share get_world_manager()'s process
        # singleton with an in-process Decision
        self._mgr = manager if manager is not None else WorldManager(device=device)
        self.device = self._mgr.device
        self._wave_budget = (
            wave_budget
            if wave_budget is not None
            else 4 * self._mgr.slots_per_bucket
        )
        self._compaction_vacancy = compaction_vacancy
        # consecutive idle wait ticks (~50 ms each) with no pending
        # work before an occupancy-compaction pass may run
        self._compact_every = max(1, compact_every)
        self._placements_at_check = TENANCY_COUNTERS["placements"]
        self._cv = threading.Condition()
        self._pending: Dict[str, SolveRequest] = {}
        self._seq = 0
        self._stop = False
        self._wave_active = False
        self._waves = 0
        self._mgr_lock = threading.RLock()
        self._conn_tenants: Dict[int, Set[str]] = {}
        self._detached: Set[str] = set()
        # SLO classes mirrored under _cv so the request arrival path
        # never touches _mgr_lock — the wave loop holds that for the
        # whole solve, and an arrival blocking on it would serialize
        # behind the wave instead of joining the next one
        self._slo: Dict[str, str] = {}
        self._reg = _get_registry()
        # standing anomaly set + one p99-breach trigger per SLO class,
        # so every breach freezes the flight ring with the admission /
        # window records that explain it (idempotent across services
        # sharing the process recorder)
        fr = install_default_triggers()
        armed = set(fr.trigger_names())
        for cls in SLO_TABLE:
            name = f"p99_breach_{cls}"
            if name not in armed:
                fr.add_trigger(
                    P99BreachTrigger(name, f"serve.latency_ms.{cls}")
                )
        self._thread = threading.Thread(
            target=self._wave_loop, name="solver-wave-loop", daemon=True
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SolverService":
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
        # fail pending waiters rather than hanging their clients
        with self._cv:
            pending = list(self._pending.values())
            self._pending = {}
        for r in pending:
            r.deliver(error=RuntimeError("solver service stopped"))

    @property
    def manager(self) -> WorldManager:
        return self._mgr

    def waves(self) -> int:
        with self._cv:
            return self._waves

    # -- client surface ----------------------------------------------------

    def register(self, tenant_id: str, slo: str = "standard",
                 conn: Optional[int] = None) -> None:
        """Declare a tenant and its SLO class; ``conn`` ties it to a
        ctrl connection so a disconnect detaches it warm."""
        if slo not in SLO_TABLE:
            raise ValueError(f"unknown SLO class: {slo!r}")
        with self._mgr_lock:
            self._mgr.set_slo_class(tenant_id, slo)
        if conn is not None:
            with self._cv:
                self._conn_tenants.setdefault(conn, set()).add(
                    tenant_id
                )
        with self._cv:
            self._slo[tenant_id] = slo
            self._detached.discard(tenant_id)

    def request_solve(self, tenant_id: str, ls, root: str,
                      trace_ctx: Optional[Dict] = None) -> SolveRequest:
        """Enqueue (or supersede) the tenant's pending solve; returns
        the request whose ``wait()`` yields the view. Arrivals during
        an in-flight wave are the continuous-batching case — they ride
        the next wave, counted as wave joins."""
        with self._cv:
            slo = self._slo.get(tenant_id, "standard")
            self._seq += 1
            r = SolveRequest(
                tenant_id, ls, root,
                slo, self._seq,
                trace_ctx=trace_ctx,
            )
            old = self._pending.get(tenant_id)
            if old is not None:
                # latest-wins coalescing: the superseded waiters are
                # served with this wave's view of the same tenant
                r.superseded = old.superseded + [old]
                old.superseded = []
            if self._wave_active:
                TENANCY_COUNTERS["wave_joins"] += 1
                self._reg.counter_bump("serve.wave_joins")
            self._pending[tenant_id] = r
            self._reg.counter_bump("serve.requests")
            self._cv.notify()
        return r

    def solve(self, tenant_id: str, ls, root: str,
              timeout: float = 60.0,
              trace_ctx: Optional[Dict] = None):
        """Blocking convenience wrapper: enqueue + wait for the wave."""
        return self.request_solve(
            tenant_id, ls, root, trace_ctx=trace_ctx
        ).wait(timeout)

    def ksp2(self, tenant_id: str, dsts: Sequence[str]):
        """Second-path view for a solved tenant (the tenant plane's
        ``ksp2_view`` behind the service lock)."""
        with self._mgr_lock:
            return self._mgr.ksp2_view(tenant_id, dsts)

    def detach(self, tenant_id: str, warm: bool = True) -> None:
        """Release a tenant's device slot; ``warm`` keeps the host
        record for a cheap rehydration on return."""
        with self._cv:
            r = self._pending.pop(tenant_id, None)
        if r is not None:
            r.deliver(
                error=RuntimeError(f"tenant {tenant_id!r} detached")
            )
        with self._mgr_lock:
            if warm:
                self._mgr.park(tenant_id)
            else:
                self._mgr.drop(tenant_id)
        with self._cv:
            self._detached.add(tenant_id)

    # -- fleet plane: drain / export / import ------------------------------

    def quiesce(self, tenant_id: str, timeout_s: float = 30.0) -> None:
        """Migration drain barrier: block until the tenant has no
        pending request AND no wave is in flight. After this returns
        (and until the caller re-admits work for the tenant) its host
        record is stable — safe to export. New requests arriving after
        the barrier are the ctrl layer's problem: it freezes the
        tenant (retry-later replies) before draining."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while tenant_id in self._pending or self._wave_active:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"quiesce({tenant_id!r}) not drained in "
                        f"{timeout_s}s"
                    )
                self._cv.wait(0.02)

    def export_tenant(self, tenant_id: str) -> Dict[str, object]:
        """Serialize the tenant's host record for live migration
        (``WorldManager.export_tenant`` behind the service lock). The
        caller drains first (``quiesce``)."""
        with self._mgr_lock:
            return self._mgr.export_tenant(tenant_id)

    def import_tenant(self, ls, record: Dict[str, object]):
        """Rehydrate a migrated tenant's record against ``ls``
        (``WorldManager.import_tenant`` behind the service lock);
        returns the placed ``TenantWorld``. The first post-import
        solve is warm — zero compiles, zero cold solves — unless the
        record degraded to a counted cold admission."""
        with self._mgr_lock:
            t = self._mgr.import_tenant(ls, record)
        slo = record.get("slo")
        if isinstance(slo, str):
            with self._cv:
                self._slo[str(record["tenant_id"])] = slo
                self._detached.discard(str(record["tenant_id"]))
        return t

    def connection_closed(self, conn: int) -> None:
        """Ctrl-transport teardown hook: every tenant the connection
        registered is parked warm — the shared bucket keeps serving
        its other tenants and a reconnecting client rehydrates."""
        with self._cv:
            tenants = self._conn_tenants.pop(conn, set())
        for tid in tenants:
            self.detach(tid, warm=True)
            self._reg.counter_bump("serve.disconnect_detaches")

    # -- wave loop ---------------------------------------------------------

    def _admit_locked(self) -> List[SolveRequest]:
        """Cut the next wave from the pending table under ``_cv``:
        SLO-ordered, budget-capped. Leftovers stay pending and lead
        the next wave (their seq keeps their place in class order)."""
        by_tenant = dict(self._pending)
        preempt0 = TENANCY_COUNTERS["wave_preemptions"]
        ordered = order_requests(
            [(r.slo, r.seq) for r in by_tenant.values()]
        )
        seq_to_req = {r.seq: r for r in by_tenant.values()}
        admitted = [
            seq_to_req[seq]
            for _cls, seq in ordered[: self._wave_budget]
        ]
        for r in admitted:
            del self._pending[r.tenant_id]
        mix: Dict[str, int] = {}
        for r in admitted:
            mix[r.slo] = mix.get(r.slo, 0) + 1
        get_flight_recorder().note(
            "admission",
            admitted=len(admitted),
            deferred=len(by_tenant) - len(admitted),
            mix=mix,
            preemptions=TENANCY_COUNTERS["wave_preemptions"] - preempt0,
        )
        return admitted

    def _wave_loop(self) -> None:
        idle_ticks = 0
        while True:
            compact = False
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(0.05)
                    if not self._pending and not self._stop:
                        idle_ticks += 1
                        if idle_ticks >= self._compact_every:
                            idle_ticks = 0
                            compact = True
                            break
                if self._stop:
                    return
                if not compact:
                    idle_ticks = 0
                    batches = [self._admit_locked()]
                    if self._pending:
                        # back-pressure burst: more requests than one
                        # wave's budget. Cut the follow-on wave NOW and
                        # pipeline it behind this one — wave N+1's
                        # bucket dispatches submit before wave N's
                        # readbacks reap (solve_views_pipelined), so
                        # the burst drains at pipeline depth 2 instead
                        # of paying a full host turnaround per wave.
                        batches.append(self._admit_locked())
                    self._wave_active = True
            if compact:
                self._maybe_compact()
                continue
            try:
                self._run_waves(batches)
            finally:
                with self._cv:
                    self._wave_active = False

    def _maybe_compact(self) -> None:
        """Idle-time occupancy compaction. Runs ONLY when the service
        has had no pending work for a stretch AND no placement landed
        since the last check: a resize is a new dispatch width (a
        retrace), so compacting while requests flow — or mid
        admission-ramp, when occupancy lags the tenant count — would
        shrink a bucket that immediately regrows and break the
        zero-compile wave-join contract. Under load the loop never
        enters this branch; the vacancy threshold inside
        ``compact_buckets`` keeps a busy full fleet untouched even
        when it does."""
        placements = TENANCY_COUNTERS["placements"]
        if placements == self._placements_at_check:
            with self._mgr_lock:
                self._mgr.compact_buckets(self._compaction_vacancy)
        self._placements_at_check = placements

    def _run_wave(self, batch: List[SolveRequest]) -> None:
        self._run_waves([batch])

    def _run_waves(self, batches: List[List[SolveRequest]]) -> None:
        """Solve one or more admitted waves — two or more ride the
        tenant plane's pipelined front end, where wave N+1's dispatches
        are submitted before wave N's readbacks land — then deliver
        every request. Failures are relayed per request, never thrown
        at the wave loop.

        Cross-wire tracing: requests carrying a client-stamped trace
        context get their span ids adopted into this wave's service
        span and flight record, so a client-side p99 breach bundle and
        the service wave that served it share ids."""
        client_spans = [
            r.trace_ctx["span_id"]
            for b in batches
            for r in b
            if isinstance(r.trace_ctx, dict) and r.trace_ctx.get("span_id")
        ]
        views_list: Optional[List[List]] = None
        errors = None
        tracer = get_tracer()
        trace = tracer.start(origin="serve.wave")
        tracer.activate(trace)
        span = tracer.span_active("serve.wave_solve")
        try:
            with self._mgr_lock:
                if len(batches) == 1:
                    views_list = [
                        self._mgr.solve_views(
                            [(r.tenant_id, r.ls, r.root)
                             for r in batches[0]]
                        )
                    ]
                else:
                    views_list = self._mgr.solve_views_pipelined(
                        [
                            [(r.tenant_id, r.ls, r.root) for r in b]
                            for b in batches
                        ]
                    )
                    self._reg.counter_bump("serve.pipelined_waves")
        except Exception as exc:  # noqa: BLE001 - relayed per request
            errors = exc
            self._reg.counter_bump("serve.errors")
        finally:
            tracer.end_span_active(
                span,
                waves=len(batches),
                requests=sum(len(b) for b in batches),
                client_spans=client_spans[:64],
            )
            tracer.deactivate()
            tracer.finish(trace)
        get_flight_recorder().note(
            "wave",
            batches=len(batches),
            requests=sum(len(b) for b in batches),
            failed=errors is not None,
            client_spans=client_spans[:64],
        )
        now = time.perf_counter()
        with self._cv:
            self._waves += len(batches)
        for bi, batch in enumerate(batches):
            self._reg.counter_bump("serve.waves")
            views = views_list[bi] if views_list is not None else None
            for i, r in enumerate(batch):
                if errors is not None:
                    r.deliver(error=errors)
                    continue
                try:
                    # the disconnect seam sits AT delivery: the wave
                    # solved this tenant, but its client died before
                    # consuming — park it warm, never poison the bucket
                    fault_point(FAULT_CLIENT_DISCONNECT)
                except FaultInjected:
                    self.detach(r.tenant_id, warm=True)
                    self._reg.counter_bump("serve.disconnect_detaches")
                    r.deliver(error=ConnectionError(
                        f"client of {r.tenant_id!r} disconnected"
                    ))
                    continue
                self._reg.observe(
                    f"serve.latency_ms.{r.slo}",
                    (now - r.enqueued) * 1000.0,
                )
                r.deliver(view=views[i])
        self._check_slo_triggers()

    @flight_callback
    def _check_slo_triggers(self) -> None:
        """Post-delivery anomaly sweep on the wave loop: per-class p99
        breach + the standing trigger set. Runs after every wave, after
        results are delivered and outside any event window, so a
        trigger firing here dumps immediately instead of deferring."""
        get_flight_recorder().check_triggers()

    # -- introspection -----------------------------------------------------

    def class_p99(self, slo: str) -> float:
        return self._reg.percentile(f"serve.latency_ms.{slo}", 0.99)

    def stage_attribution(self) -> Dict[str, object]:
        """Every SLO-class p99 next to the measured per-stage device /
        host costs that produced it — the serve plane's answer to
        'which stage is eating my latency budget'."""
        prof = get_profiler()
        return {
            "class_p99_ms": {
                cls: round(self.class_p99(cls), 3) for cls in SLO_TABLE
            },
            "stages": prof.attribution(),
            "host_overhead_ratio": prof.host_overhead_ratio(),
        }

    def counters(self) -> Dict[str, float]:
        snap = self._reg.snapshot()
        return {
            k: v
            for k, v in snap.items()
            if k.startswith("serve.") or k.startswith("tenancy.")
        }
