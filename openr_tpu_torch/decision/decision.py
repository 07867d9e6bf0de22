"""Decision module: LSDB stream -> debounced route computation -> deltas.

Behavioral parity with the reference ``openr/decision/Decision.{h,cpp}``:

- subscribes to the KvStore publication queue; dispatches ``adj:`` /
  ``prefix:`` / ``fibtime:`` keys (processPublication, Decision.cpp:1722)
- maintains one LinkState per area plus the global PrefixState; per-prefix
  keys merge into a per-node synthetic PrefixDatabase
  (updateNodePrefixDatabase, Decision.cpp:1668)
- batches churn behind an AsyncDebounce (10..250 ms by default, matching
  common/Flags.cpp:87-96) and tracks whether the batch needs a *full*
  rebuild (any topology/node-label change, or local link-attribute
  change) or an *incremental* per-prefix pass
  (DecisionPendingUpdates, Decision.h:130; rebuildRoutes, Decision.cpp:1860)
- publishes DecisionRouteUpdate deltas on the route-updates queue with the
  batch's oldest perf-event chain attached
- cold-start hold gates the first route publication (Decision.cpp:1403)
- ordered-FIB hold decrement timer (Decision.cpp:1930 decrementOrderedFibHolds)

Port note: a port of ``openr_tpu/decision/decision.py``. ``Decision``
takes ``device=`` (None: the card; without CUDA it raises unless given
``device="cpu"``) and hands it to its ``SpfSolver``, whose device backend
runs the port's CUDA kernels. The event base binds that card as its
thread's current device when it starts; the solver, its pinned upload
buffer and its resident caches are used from the event base only, and the
pipelined emit worker (``pipelined_emit=True``) touches ``route_db`` and
the out-queue, never the card. The degradation ladder is the reference's:
warm solve, device-state reset and cold rebuild, then the ``native``
backend (the host C++ core) for a ``device`` solver. Unlike the
reference's, the ladder takes only an injected fault or torn resident
state (``ladder_recoverable``): any other failure of a rung, such as a
kernel's build or launch error, a CUDA error or a failed native build,
propagates out of ``rebuild_routes``, so the host never computes the
routes in place of a card that failed. Each
``decision.rebuild`` span carries the dispatch accounting's true counts
(``host_touches``, ``host_dispatches``, ``blocking_syncs``): the port's
eager relax loops read their convergence flag once a chunk of hops
(``ops/relax_loop.py``) and the KSP2 dispatches once a dispatch, so a
rebuild reports its true counts; the reference's two touches a window
hold for the route engine's warm events. Left out for a later slice: the crash-safe state plane
(the ``state_plane`` argument, the flight journal anchored on it,
``checkpoint_state`` and ``warm_boot``), the integrity plane (the
auditor's post-converge hook and the quarantine test beside the staleness
stamp: no port engine registers with an auditor yet). ``world_batch``
and ``view_cache_cap`` pass through to ``SpfSolver`` as in the
reference.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Set, Tuple

import torch

from openr_tpu_torch.analysis.annotations import (
    fault_boundary,
    solve_window,
    thread_confined,
)
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, DecisionRouteUpdate
from openr_tpu_torch.decision.spf_solver import SpfSolver, get_spf_counters
from openr_tpu_torch.device import DeviceLike
from openr_tpu_torch.faults.injector import FaultInjected
from openr_tpu_torch.faults.supervisor import DegradationSupervisor, HealthState
from openr_tpu_torch.graph.linkstate import LinkState, LinkStateChange
from openr_tpu_torch.load.admission import AdmissionControl
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops.spf_sparse import TornStateError
from openr_tpu_torch.telemetry import (
    get_registry,
    get_tracer,
    install_default_triggers,
)
from openr_tpu_torch.types import (
    AdjacencyDatabase,
    IpPrefix,
    PerfEvents,
    Publication,
    PrefixDatabase,
    PrefixEntry,
)
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import AsyncDebounce, OpenrEventBase


def ladder_recoverable(exc: BaseException) -> bool:
    """Whether a failed rung may hand its rebuild to the next one: an
    injected fault or torn resident state, which a reset and a cold
    rebuild repair. Everything else propagates."""
    return isinstance(exc, (FaultInjected, TornStateError))


class DecisionPendingUpdates:
    """reference: openr/decision/Decision.h:130."""

    def __init__(self, my_node_name: str):
        self._my_node_name = my_node_name
        self.count = 0
        self.perf_events: Optional[PerfEvents] = None
        self._needs_full_rebuild = False
        self.updated_prefixes: Set[IpPrefix] = set()
        # telemetry trace for the debounce window. The FIRST adopted
        # trace wins (publications arrive in order, so first == oldest
        # — the same convergence-from-earliest rule as perf_events);
        # later traces in the window are counted as merged and dropped.
        self.trace = None
        self._debounce_span = None

    def needs_full_rebuild(self) -> bool:
        return self._needs_full_rebuild

    def set_needs_full_rebuild(self) -> None:
        self._needs_full_rebuild = True

    def needs_route_update(self) -> bool:
        return self._needs_full_rebuild or bool(self.updated_prefixes)

    def apply_link_state_change(
        self,
        node_name: str,
        change: LinkStateChange,
        perf_events: Optional[PerfEvents] = None,
    ) -> None:
        self._needs_full_rebuild |= (
            change.topology_changed
            or change.node_label_changed
            # link attributes (nexthop addr / adj label) only matter for
            # our own links: they alter our programmed nexthops
            or (
                change.link_attributes_changed
                and node_name == self._my_node_name
            )
        )
        self._add_update(perf_events)

    def apply_prefix_state_change(
        self,
        changed: Set[IpPrefix],
        perf_events: Optional[PerfEvents] = None,
    ) -> None:
        self.updated_prefixes |= changed
        self._add_update(perf_events)

    def _add_update(self, perf_events: Optional[PerfEvents]) -> None:
        self.count += 1
        # keep the *oldest* event chain so convergence is measured from the
        # earliest update in the debounced batch
        if self.perf_events is None or (
            perf_events is not None
            and perf_events.events
            and self.perf_events.events
            and self.perf_events.events[0].unix_ts
            > perf_events.events[0].unix_ts
        ):
            self.perf_events = (
                PerfEvents(events=list(perf_events.events))
                if perf_events is not None
                else PerfEvents()
            )
            self.add_event("DECISION_RECEIVED")

    def add_event(self, descr: str) -> None:
        if self.perf_events is not None:
            self.perf_events.add(self._my_node_name, descr)

    def move_out_events(self) -> Optional[PerfEvents]:
        events = self.perf_events
        self.perf_events = None
        return events

    def adopt_trace(self, trace) -> None:
        if trace is None:
            return
        if self.trace is None:
            self.trace = trace
            self._debounce_span = trace.begin_span("decision.debounce")
        else:
            get_registry().counter_bump("telemetry.traces_merged")

    def move_out_trace(self):
        """End the debounce span and hand the trace to the rebuild."""
        trace, span = self.trace, self._debounce_span
        self.trace = None
        self._debounce_span = None
        if trace is not None and span is not None:
            trace.end_span(span, merged_updates=self.count)
            get_registry().observe(
                "decision.debounce_ms", span.dur_ms or 0.0
            )
        return trace

    def release_trace(self) -> None:
        """Reclaim an adopted trace that will never reach a rebuild
        (overload resets, teardown): the ``decision.debounce`` span MUST
        close on this path too, or sustained load leaks one open span
        per reset and the smoke gate's well-formedness check trips."""
        trace, span = self.trace, self._debounce_span
        self.trace = None
        self._debounce_span = None
        if trace is not None and span is not None:
            trace.end_span(span, aborted=True)
            get_registry().counter_bump("decision.debounce_spans_reclaimed")

    def reset(self) -> None:
        self.count = 0
        self.perf_events = None
        self._needs_full_rebuild = False
        self.updated_prefixes = set()
        self.release_trace()


# route_db is single-owner by mode, not by lock: eager mode mutates it
# on the event base; pipelined mode hands ownership to the emit worker,
# and every rebuild joins the worker (_drain_emit) before touching it.
@thread_confined("owner", "route_db")
class Decision:
    def __init__(
        self,
        my_node_name: str,
        kvstore_updates_queue: ReplicateQueue,
        route_updates_queue: ReplicateQueue,
        static_routes_queue: Optional[ReplicateQueue] = None,
        debounce_min_s: float = 0.010,
        debounce_max_s: float = 0.250,
        cold_start_s: float = 0.0,
        enable_v4: bool = False,
        compute_lfa_paths: bool = False,
        enable_ordered_fib: bool = False,
        bgp_dry_run: bool = False,
        enable_best_route_selection: bool = True,
        solver_backend: str = "device",
        enable_rib_policy: bool = True,
        admission: Optional[AdmissionControl] = None,
        pipelined_emit: bool = False,
        kvstore_reader_maxlen: Optional[int] = None,
        world_batch: Optional[bool] = None,
        view_cache_cap: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self._enable_rib_policy = enable_rib_policy
        self.my_node_name = my_node_name
        self.evb = OpenrEventBase(name=f"decision:{my_node_name}")
        self.route_updates_queue = route_updates_queue
        self.spf_solver = SpfSolver(
            my_node_name,
            enable_v4=enable_v4,
            compute_lfa_paths=compute_lfa_paths,
            enable_ordered_fib=enable_ordered_fib,
            bgp_dry_run=bgp_dry_run,
            enable_best_route_selection=enable_best_route_selection,
            backend=solver_backend,
            device=device,
            view_cache_cap=view_cache_cap,
            world_batch=world_batch,
        )
        # degradation ladder for the rebuild path: warm device solve →
        # device-state reset + cold rebuild → non-device backend. The
        # fallback backend is "native" when the configured backend is
        # the device (the port's native view raises when the core cannot
        # be built: no quiet step down to host); for an already-host
        # backend all rungs run the same solve, which is harmless.
        self._primary_backend = solver_backend
        self._fallback_backend = (
            "native" if solver_backend == "device" else solver_backend
        )
        self.supervisor = DegradationSupervisor("decision")
        # standing anomaly set (p99 breach vs rolling baseline,
        # compile-after-warmup, reshard delta): always-on from the
        # moment a pipeline exists, idempotent across instances
        install_default_triggers()
        # monotonic stamp of the last route db installed while the
        # ladder was fully warm — the staleness gauge ages from it while
        # degraded
        self._last_good_route_ts: Optional[float] = None
        # the stamp is written by whichever role emits (event base or
        # the emit worker) and read by the registry's gauge thread —
        # a dedicated lock keeps the pair race-free without dragging
        # the gauge into the emit path's wider critical sections
        self._emit_mu = threading.Lock()
        get_registry().gauge(
            "decision.route_staleness_ms", self._route_staleness_ms
        )
        self.area_link_states: Dict[str, LinkState] = {}
        self.prefix_state = PrefixState()
        self.route_db = DecisionRouteDb()
        self.pending = DecisionPendingUpdates(my_node_name)
        self.fib_times: Dict[str, float] = {}
        self.rib_policy = None  # set via set_rib_policy
        self._enable_ordered_fib = enable_ordered_fib
        # per-node view assembled from per-prefix keys
        # (reference: perPrefixPrefixEntries_ / fullDbPrefixEntries_)
        self._per_prefix_entries: Dict[
            Tuple[str, str], Dict[IpPrefix, PrefixEntry]
        ] = {}
        self._full_db_entries: Dict[
            Tuple[str, str], Dict[IpPrefix, PrefixEntry]
        ] = {}
        self.counters: Dict[str, int] = {
            "decision.adj_db_update": 0,
            "decision.prefix_db_update": 0,
            "decision.route_build_runs": 0,
            "decision.publications": 0,
        }

        self._rebuild_debounced = AsyncDebounce(
            self.evb, debounce_min_s, debounce_max_s, self._on_debounce_fire
        )
        # debounce-terminal speculation latch: at most ONE speculative
        # view solve per debounce window (armed when the window
        # saturates, reset when the rebuild fires)
        self._spec_fired_this_window = False
        # admission/backpressure path (service plane): the controller
        # adapts the debounce ceiling to the reader backlog, and the
        # consume path sheds-by-coalescing once the backlog is deep
        self._admission = admission
        if self._admission is not None:
            self._admission.bind_debounce(
                self._rebuild_debounced, debounce_max_s
            )
        # pipelined emit: the diff/apply/publish tail of a rebuild runs
        # on a single-worker FIFO executor so event N+1's solve can
        # dispatch while event N's routes are still being derived and
        # programmed (PendingDelta double-buffering, one layer up). The
        # worker is the sole owner of route_db once enabled.
        self._pipelined_emit = pipelined_emit
        self._emit_executor: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"decision-emit:{my_node_name}"
            )
            if pipelined_emit
            else None
        )
        self._emit_future: Optional[Future] = None
        self._cold_start_until = (
            time.monotonic() + cold_start_s if cold_start_s > 0 else 0.0
        )
        if cold_start_s > 0:
            self.evb.schedule_timeout(cold_start_s, self._on_cold_start_done)

        self._kv_reader = kvstore_updates_queue.get_reader(
            f"decision:{my_node_name}", maxlen=kvstore_reader_maxlen
        )
        self.evb.add_queue_reader(self._kv_reader, self._on_publication)
        if static_routes_queue is not None:
            self.evb.add_queue_reader(
                static_routes_queue.get_reader(f"decision:{my_node_name}"),
                self._on_static_routes,
            )
        self._ordered_fib_timer = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        # the first callback of the loop: the solver's card becomes the
        # event base thread's current device
        self.evb.run_in_event_base(self._bind_device)
        self.evb.run_in_thread()

    def _bind_device(self) -> None:
        if self.spf_solver.device.type == "cuda":
            torch.cuda.set_device(self.spf_solver.device)

    def stop(self) -> None:
        self.evb.stop()
        self.evb.join()
        if self._emit_executor is not None:
            if self._emit_future is not None:
                try:
                    self._emit_future.result(timeout=10.0)
                except Exception:  # noqa: BLE001 - drained best-effort
                    pass
                self._emit_future = None
            self._emit_executor.shutdown(wait=True)

    # -- queue handlers (run on the module thread) ------------------------

    def _on_publication(self, pub: Publication) -> None:
        if self._admission is not None:
            # admission path: observe backlog depth (adapting the
            # debounce ceiling) and, under a deep backlog, drain +
            # coalesce it into net-effect publications — superseded
            # per-key versions are shed, net state is untouched
            batch = self._admission.admit(pub, self._kv_reader)
            pubs, traces = batch.publications, batch.traces
            self.counters["decision.publications"] += batch.pubs_in
        else:
            pubs, traces = [pub], [pub.trace]
            self.counters["decision.publications"] += 1
        for p in pubs:
            self.process_publication(p)
        if self.pending.needs_route_update():
            # arrival order: the first (oldest) trace wins the window,
            # later ones are counted merged — same rule as perf_events
            for trace in traces:
                self.pending.adopt_trace(trace)
        else:
            for trace in traces:
                if trace is not None:
                    # publication with no route impact (e.g. fibtime
                    # keys): the trace dies here, visibly
                    get_registry().counter_bump(
                        "telemetry.traces_no_route_impact"
                    )
        if self.pending.needs_route_update():
            # overlap the device-side delta application with the
            # debounce window: the band scatter for this publication's
            # topology delta is enqueued asynchronously NOW, so by the
            # time the debounced rebuild dispatches its fused solve the
            # resident bands are already patched (and the previous
            # event's RouteDatabase delta emission ran concurrently
            # with the scatter instead of ahead of it)
            if self._admission is None or self._admission.allow_prewarm(
                self._kv_reader.size()
            ):
                self.spf_solver.prewarm(self.area_link_states)
            self._rebuild_debounced()
            # debounce-terminal speculation: once the window's backoff
            # saturates, further publications can only JOIN the window,
            # never extend it — the fire time is final, and under
            # latest-wins the current coalesced backlog is the most
            # likely rebuild composition. Stage its view solve now
            # (once per window) so the rebuild lands on a warm cache
            # hit; a later join supersedes the stage, counted
            # ops.spec_cancels, and the rebuild re-solves bit-identical.
            if (
                not self._spec_fired_this_window
                and self._rebuild_debounced.at_max_backoff()
            ):
                self._spec_fired_this_window = True
                self.spf_solver.speculate_views(
                    self.my_node_name, self.area_link_states
                )

    def _on_static_routes(self, delta) -> None:
        """Static MPLS routes pushed by the platform/plugin layer
        (reference: Decision static routes fiber)."""
        to_update = {
            r.top_label: list(r.next_hops)
            for r in getattr(delta, "mpls_routes_to_update", [])
        }
        to_delete = list(getattr(delta, "mpls_routes_to_delete", []))
        self.spf_solver.update_static_mpls_routes(to_update, to_delete)
        self.pending.set_needs_full_rebuild()
        self._rebuild_debounced()

    def process_publication(self, pub: Publication) -> None:
        """reference: Decision.cpp:1722 processPublication."""
        area = pub.area
        link_state = self.area_link_states.get(area)
        if link_state is None:
            link_state = self.area_link_states[area] = LinkState(area)

        for key, value in pub.key_vals.items():
            if value.value is None:
                continue  # ttl refresh only
            node_name = keyutil.get_node_name_from_key(key)
            try:
                if keyutil.is_adj_key(key):
                    adj_db = wire.loads(value.value, AdjacencyDatabase)
                    assert adj_db.this_node_name == node_name
                    if adj_db.area != area:
                        adj_db = AdjacencyDatabase(
                            this_node_name=adj_db.this_node_name,
                            is_overloaded=adj_db.is_overloaded,
                            adjacencies=adj_db.adjacencies,
                            node_label=adj_db.node_label,
                            area=area,
                            perf_events=adj_db.perf_events,
                        )
                    hold_up, hold_down = self._ordered_fib_holds(
                        link_state, node_name
                    )
                    self.counters["decision.adj_db_update"] += 1
                    self.pending.apply_link_state_change(
                        node_name,
                        link_state.update_adjacency_database(
                            adj_db, hold_up, hold_down
                        ),
                        adj_db.perf_events,
                    )
                    if (
                        self._enable_ordered_fib
                        and link_state.has_holds()
                        and self._ordered_fib_timer is None
                    ):
                        self._schedule_ordered_fib_tick()
                elif keyutil.is_prefix_key(key):
                    prefix_db = wire.loads(value.value, PrefixDatabase)
                    assert prefix_db.this_node_name == node_name
                    node_db = self._update_node_prefix_db(
                        key, prefix_db, area
                    )
                    if node_db is None:
                        continue
                    self.counters["decision.prefix_db_update"] += 1
                    self.pending.apply_prefix_state_change(
                        self.prefix_state.update_prefix_database(node_db),
                        prefix_db.perf_events,
                    )
                elif keyutil.is_fib_time_key(key):
                    try:
                        self.fib_times[node_name] = float(
                            value.value.decode()
                        )
                    except ValueError:
                        pass
            except Exception:  # noqa: BLE001 - bad LSDB values are skipped
                continue

        for key in pub.expired_keys:
            node_name = keyutil.get_node_name_from_key(key)
            if keyutil.is_adj_key(key):
                self.pending.apply_link_state_change(
                    node_name,
                    link_state.delete_adjacency_database(node_name),
                )
            elif keyutil.is_prefix_key(key):
                delete_db = PrefixDatabase(
                    this_node_name=node_name, delete_prefix=True, area=area
                )
                node_db = self._update_node_prefix_db(key, delete_db, area)
                if node_db is None:
                    continue
                self.pending.apply_prefix_state_change(
                    self.prefix_state.update_prefix_database(node_db)
                )

    def _update_node_prefix_db(
        self, key: str, prefix_db: PrefixDatabase, area: str
    ) -> Optional[PrefixDatabase]:
        """Merge a per-prefix or full-db advertisement into the node's
        synthetic PrefixDatabase (reference: Decision.cpp:1668
        updateNodePrefixDatabase)."""
        node = prefix_db.this_node_name
        slot = (node, area)
        parsed = keyutil.parse_per_prefix_key(key)
        if parsed is not None:
            _, _, prefix = parsed
            per = self._per_prefix_entries.setdefault(slot, {})
            if prefix_db.delete_prefix:
                per.pop(prefix, None)
            else:
                assert len(prefix_db.prefix_entries) == 1
                entry = prefix_db.prefix_entries[0]
                # ignore self-redistributed route reflection
                if (
                    node == self.my_node_name
                    and entry.area_stack
                    and entry.area_stack[-1] in self.area_link_states
                ):
                    return None
                per[prefix] = entry
        else:
            if prefix_db.delete_prefix:
                self._full_db_entries.pop(slot, None)
            else:
                self._full_db_entries[slot] = {
                    e.prefix: e for e in prefix_db.prefix_entries
                }

        per = self._per_prefix_entries.get(slot, {})
        full = self._full_db_entries.get(slot, {})
        entries = list(per.values()) + [
            e for p, e in full.items() if p not in per
        ]
        return PrefixDatabase(
            this_node_name=node,
            prefix_entries=tuple(entries),
            area=area,
            perf_events=prefix_db.perf_events,
        )

    # -- ordered fib holds ------------------------------------------------

    def _ordered_fib_holds(
        self, link_state: LinkState, node_name: str
    ) -> Tuple[int, int]:
        """Hold TTLs so farther routers program before nearer ones
        (RFC 6976 style; reference: Decision.cpp:1745-1752)."""
        if not self._enable_ordered_fib:
            return (0, 0)
        hops = link_state.get_hops_from_a_to_b(self.my_node_name, node_name)
        if hops is None:
            return (0, 0)
        hold_up = hops
        hold_down = max(0, link_state.get_max_hops_to_node(node_name) - hold_up)
        return (hold_up, hold_down)

    def _schedule_ordered_fib_tick(self) -> None:
        """Tick period = the slowest FIB in the network (reference:
        Decision.cpp:1943 getMaxFib, floor 1 ms)."""
        max_fib_s = max(self.fib_times.values(), default=1.0) / 1000.0
        self._ordered_fib_timer = self.evb.schedule_timeout(
            max(0.001, max_fib_s), self._decrement_ordered_fib_holds
        )

    def _decrement_ordered_fib_holds(self) -> None:
        """reference: Decision.cpp:1930 decrementOrderedFibHolds."""
        self._ordered_fib_timer = None
        still_has_holds = False
        topo_changed = False
        for link_state in self.area_link_states.values():
            change = link_state.decrement_holds()
            topo_changed |= change.topology_changed
            still_has_holds |= link_state.has_holds()
        if topo_changed:
            self.pending.set_needs_full_rebuild()
            self._rebuild_debounced()
        if still_has_holds:
            self._schedule_ordered_fib_tick()

    # -- rebuild ----------------------------------------------------------

    def _on_cold_start_done(self) -> None:
        self._cold_start_until = 0.0
        if self.pending.needs_route_update():
            self.rebuild_routes("COLD_START_UPDATE")

    def _on_debounce_fire(self) -> None:
        self._spec_fired_this_window = False
        self.rebuild_routes("DECISION_DEBOUNCE")

    def _route_staleness_ms(self) -> float:
        """How long the installed routes have been serving without a
        verified-good refresh: 0 while the ladder is warm (or before the
        first install), else the age of the last route db installed in
        that state. Self-heal zeroes it."""
        with self._emit_mu:
            ts = self._last_good_route_ts
        if ts is None or self.supervisor.state is HealthState.HEALTHY:
            return 0.0
        return (time.monotonic() - ts) * 1000.0

    @solve_window
    def rebuild_routes(self, event: str) -> None:
        """reference: Decision.cpp:1860 rebuildRoutes."""
        if self._cold_start_until and time.monotonic() < self._cold_start_until:
            return
        self.pending.add_event(event)
        self.counters["decision.route_build_runs"] += 1
        if self.pending.count > 1:
            # a debounce window folded several publications into THIS
            # one rebuild: downstream, the device churn path pays one
            # fused dispatch + one delta readback for the whole burst
            # (EllState merges the stacked patch journals; the route
            # engine takes the union affected set) — count the folds
            # so burst coalescing is observable next to
            # decision.route_build_runs
            get_registry().counter_bump(
                "decision.coalesced_publications",
                self.pending.count - 1,
            )

        # close the debounce span, open the rebuild span, and activate
        # the trace on this thread so deep call sites (the ELL
        # reconverge in ops.spf_sparse) can nest their own spans
        trace = self.pending.move_out_trace()
        tracer = get_tracer()
        rebuild_span = None
        full = self.pending.needs_full_rebuild()
        if trace is not None:
            rebuild_span = trace.begin_span(
                "decision.rebuild", full_rebuild=full
            )
            tracer.activate(trace)
        t_rebuild0 = time.perf_counter()

        # degradation ladder: warm solve with the configured backend →
        # reset all device-derived state and rebuild cold → flip to the
        # non-device backend. Every rung produces the same
        # DecisionRouteDb (the parity suite proves it per rung), so the
        # emitted delta is rung-independent. A LadderExhausted, or a
        # failure that ladder_recoverable rejects (a kernel's build or
        # launch error), propagates to the event loop after the finally
        # closes the trace span; pending is NOT reset on that path, so
        # the next publication retriggers the rebuild.
        payload = None
        win = None
        try:
            with da.event_window("decision.rebuild") as win:
                payload = self.supervisor.run(
                    (
                        ("warm", lambda: self._solve_update(
                            full, reset=False, backend=self._primary_backend)),
                        ("cold", lambda: self._solve_update(
                            True, reset=True, backend=self._primary_backend)),
                        ("host", lambda: self._solve_update(
                            True, reset=True, backend=self._fallback_backend)),
                    ),
                    recoverable=ladder_recoverable,
                )
        finally:
            get_registry().observe(
                "decision.rebuild_ms",
                (time.perf_counter() - t_rebuild0) * 1000.0,
            )
            if rebuild_span is not None and win is not None:
                # the rebuild's host touches, kernel launches and
                # blocking syncs, as the dispatch accounting counted them
                rebuild_span.attrs.update(
                    host_touches=win.touches,
                    host_dispatches=win.dispatches,
                    blocking_syncs=win.blocking_syncs,
                )
            if trace is not None:
                tracer.deactivate()
                if payload is None:
                    # ladder exhausted: no emit stage will run for this
                    # rebuild, so the span closes here
                    trace.end_span(
                        rebuild_span, routes_updated=-1, routes_deleted=-1
                    )

        self.pending.add_event("ROUTE_UPDATE")
        perf_events = self.pending.move_out_events()
        self.pending.reset()
        if self._emit_executor is not None:
            # double-buffered handoff: at most one emit in flight. The
            # wait lands AFTER this event's solve, so emit N overlapped
            # solve N+1; the single worker keeps route_db mutation and
            # queue pushes strictly FIFO.
            self._drain_emit()
            self._emit_future = self._emit_executor.submit(
                self._emit_update, payload, trace, rebuild_span, perf_events
            )
        else:
            self._emit_update(payload, trace, rebuild_span, perf_events)

    def _drain_emit(self) -> None:
        if self._emit_future is not None:
            try:
                self._emit_future.result()
            except Exception:  # noqa: BLE001 - counted, never kills evb
                get_registry().counter_bump("decision.emit_errors")
            self._emit_future = None

    def _emit_update(
        self, payload, trace, rebuild_span, perf_events
    ) -> None:
        """Emit stage of a rebuild: diff the solved db against the
        installed one, apply, and publish. In pipelined mode this runs
        on the single-worker emit executor (which then exclusively owns
        route_db); in eager mode it runs inline on the module thread."""
        kind, value = payload
        if kind == "db":
            # the diff runs HERE, not in the solve rung: route_db is
            # mutated by this stage, so reading it from the (possibly
            # concurrent) solve would race in pipelined mode
            update = self.route_db.calculate_update(value)
        else:
            update = value
        if trace is not None:
            trace.end_span(
                rebuild_span,
                routes_updated=len(update.unicast_routes_to_update),
                routes_deleted=len(update.unicast_routes_to_delete),
            )
        self.route_db.update(update)
        if self.supervisor.state is HealthState.HEALTHY:
            with self._emit_mu:
                self._last_good_route_ts = time.monotonic()
        update.perf_events = perf_events
        update.trace = trace
        self.route_updates_queue.push(update)

    @fault_boundary
    def _solve_update(
        self, full: bool, reset: bool, backend: str
    ) -> Tuple[str, object]:
        """One ladder rung: compute this rebuild's routes. ``reset``
        drops every device-derived cache first (so a torn dispatch
        can't leak into the result); a backend flip does the same
        implicitly. A reset or flip forces the full-rebuild branch even
        for a per-prefix batch — the full route db is a superset of the
        per-prefix entries and the emit stage's ``calculate_update``
        diffs against the installed db, so the emitted delta is
        identical.

        Returns an emit payload — ``("db", DecisionRouteDb)`` for a
        full build (the emit stage diffs it against the installed db)
        or ``("delta", DecisionRouteUpdate)`` for the per-prefix
        incremental pass — so the rung itself never touches route_db
        and can overlap the previous event's emit."""
        flipped = self.spf_solver.backend != backend
        if reset:
            self.spf_solver.reset_device_state()
        if flipped:
            self.spf_solver.set_backend(backend)
        update = DecisionRouteUpdate()
        if full or reset or flipped:
            new_db = (
                self.spf_solver.build_route_db(
                    self.my_node_name, self.area_link_states, self.prefix_state
                )
                or DecisionRouteDb()
            )
            if self.rib_policy is not None and self.rib_policy.is_active():
                self.rib_policy.apply_policy(new_db.unicast_routes)
            return ("db", new_db)
        else:
            for prefix in self.pending.updated_prefixes:
                entry = self.spf_solver.create_route_for_prefix(
                    self.my_node_name,
                    self.area_link_states,
                    self.prefix_state,
                    prefix,
                )
                if entry is not None:
                    update.unicast_routes_to_update[prefix] = entry
                else:
                    update.unicast_routes_to_delete.append(prefix)
            if self.rib_policy is not None and self.rib_policy.is_active():
                change = self.rib_policy.apply_policy(
                    update.unicast_routes_to_update
                )
                update.unicast_routes_to_delete.extend(change.deleted_routes)
        return ("delta", update)

    # -- public (thread-safe) APIs ---------------------------------------

    def get_decision_route_db(
        self, node: Optional[str] = None
    ) -> DecisionRouteDb:
        """Compute (any-source!) routes on demand — first-class API, same
        solver as the hot path (reference: Decision.cpp:1492)."""
        node = node or self.my_node_name

        def compute() -> DecisionRouteDb:
            return (
                self.spf_solver.build_route_db(
                    node, self.area_link_states, self.prefix_state
                )
                or DecisionRouteDb()
            )

        return self.evb.call_and_wait(compute)

    def get_adj_dbs(self) -> Dict[str, Dict[str, AdjacencyDatabase]]:
        return self.evb.call_and_wait(
            lambda: {
                area: dict(ls.get_adjacency_databases())
                for area, ls in self.area_link_states.items()
            }
        )

    def get_received_route_count(self) -> int:
        return self.evb.call_and_wait(
            lambda: len(self.prefix_state.prefixes())
        )

    def set_rib_policy(self, policy) -> None:
        """Install a TTL'd policy; a rebuild is scheduled at expiry so its
        effects revert (reference: Decision.cpp:1600 setRibPolicy +
        ribPolicyTimer_). Inline validation mirrors the reference's
        thrift::OpenrError cases: feature knob off (Decision.cpp:1593)
        and an empty policy (DecisionTest RibPolicyError)."""
        if not self._enable_rib_policy:
            raise RuntimeError("rib policy feature is disabled by config")
        if policy is not None and not policy.statements:
            raise ValueError("rib policy must carry >= 1 statement")

        def install() -> None:
            self.rib_policy = policy
            self.pending.set_needs_full_rebuild()
            self._rebuild_debounced()
            if policy is not None:
                self.evb.schedule_timeout(
                    policy.get_ttl_remaining_s() + 0.001,
                    self._on_rib_policy_expiry,
                )

        self.evb.call_and_wait(install)

    def _on_rib_policy_expiry(self) -> None:
        if self.rib_policy is not None and not self.rib_policy.is_active():
            self.pending.set_needs_full_rebuild()
            self._rebuild_debounced()

    def get_rib_policy(self):
        if not self._enable_rib_policy:
            raise RuntimeError("rib policy feature is disabled by config")
        return self.evb.call_and_wait(lambda: self.rib_policy)

    def get_counters(self) -> Dict[str, int]:
        return self.evb.call_and_wait(self._collect_counters)

    def _collect_counters(self) -> Dict[str, int]:
        """Event counters + global gauges (reference: Decision.cpp:1964
        updateGlobalCounters)."""
        out = dict(self.counters)
        num_adjacencies = 0
        num_partial = 0
        nodes = set()
        for ls in self.area_link_states.values():
            num_adjacencies += ls.num_links
            spf = ls.get_spf_result(self.my_node_name) if ls.has_node(
                self.my_node_name
            ) else {}
            for name, adj_db in ls.get_adjacency_databases().items():
                nodes.add(name)
                num_links = len(ls.links_from_node(name))
                # partial adjacency: declared but not bidirectional, only
                # counted for reachable, non-isolated nodes
                if name in spf and num_links != 0:
                    num_partial += max(
                        0, len(adj_db.adjacencies) - num_links
                    )
        conflicting = sum(
            1
            for entries in self.prefix_state.prefixes().values()
            if PrefixState.has_conflicting_forwarding_info(entries)
        )
        out["decision.num_conflicting_prefixes"] = conflicting
        out["decision.num_partial_adjacencies"] = num_partial
        out["decision.num_complete_adjacencies"] = num_adjacencies
        out["decision.num_nodes"] = max(len(nodes), 1)
        out["decision.num_prefixes"] = len(self.prefix_state.prefixes())
        out.update(get_spf_counters())
        return out
