"""Fib module: program computed routes into the platform agent.

Behavioral parity with the reference ``openr/fib/Fib.{h,cpp}``:

- consumes DecisionRouteUpdate deltas (processRouteUpdates, Fib.cpp:316)
- incremental add/delete programming with retry + exponential backoff on
  agent errors (updateRoutes, Fib.cpp:542); a failed program marks the
  state dirty and a later retry falls back to full ``syncFib``
  (syncRouteDb, Fib.cpp:674)
- keepalive polling of the agent's aliveSince: an agent restart triggers
  a full resync (Fib.cpp:86-103)
- publishes programmed deltas on the fib-updates queue and advertises the
  ``fibtime:<node>`` perf key into the KvStore for ordered-FIB
- dry-run mode: keep state, skip programming
- longest-prefix-match and route lookup APIs for the ctrl surface
  (Fib.cpp:164 longestPrefixMatch)

Port note: a copy of ``openr_tpu/fib/fib.py``; nothing left out, and one
fault fixed: the reference's ``start_graceful_restart`` keys a held MPLS
route by ``r.label``, which ``MplsRoute`` does not have (its field is
``top_label``), so a warm boot holding MPLS routes raises there. It reads
the port's ``DecisionRouteUpdate`` (``decision/rib.py``) and closes the
trace that the port's KvStore opens, with the same ``fib.program`` span.
It runs on its own event base and never touches a device.
"""

from __future__ import annotations

import ipaddress
import time
from typing import Dict, List, Optional

from openr_tpu_torch.monitor.monitor import push_log_sample
from openr_tpu_torch.decision.rib import DecisionRouteUpdate
from openr_tpu_torch.telemetry import get_registry, get_tracer
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.platform.fib_service import FibService
from openr_tpu_torch.types import (
    IpPrefix,
    MplsRoute,
    RouteDatabase,
    UnicastRoute,
)
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils.eventbase import ExponentialBackoff, OpenrEventBase

# client id Fib programs under (reference: thrift ClientID::OPENR = 786)
OPENR_CLIENT_ID = 786


class Fib:
    def __init__(
        self,
        my_node_name: str,
        agent: FibService,
        route_updates_queue: ReplicateQueue,
        fib_updates_queue: Optional[ReplicateQueue] = None,
        kvstore_client=None,
        area: str = "0",
        dry_run: bool = False,
        keepalive_interval_s: float = 1.0,
        retry_min_s: float = 0.05,
        retry_max_s: float = 2.0,
        log_sample_queue: Optional[ReplicateQueue] = None,
        graceful_restart_hold_s: float = 0.0,
    ):
        self.my_node_name = my_node_name
        self.agent = agent
        self.evb = OpenrEventBase(name=f"fib:{my_node_name}")
        self.fib_updates_queue = fib_updates_queue or ReplicateQueue(
            name=f"fibUpdates:{my_node_name}"
        )
        self._kvstore_client = kvstore_client
        self._area = area
        self._log_sample_queue = log_sample_queue
        self.dry_run = dry_run
        # desired state (what Decision wants programmed)
        self.unicast_routes: Dict[IpPrefix, UnicastRoute] = {}
        self.mpls_routes: Dict[int, MplsRoute] = {}
        self._synced_once = False
        self._dirty = False
        self._backoff = ExponentialBackoff(retry_min_s, retry_max_s)
        self._retry_timer = None
        self._agent_alive_since: Optional[int] = None
        # graceful restart: a warm-booted process serves the
        # journal-recovered RouteDatabase and HOLDS the previously
        # programmed routes (no deletes, no churn) until Decision
        # re-converges or the hold timer fires — either way ONE full
        # sync_fib reconciles the agent table; routes never flap.
        self.graceful_restart_hold_s = graceful_restart_hold_s
        self._gr_active = False
        self._gr_timer = None
        self.counters = {
            "fib.route_programming_failures": 0,
            "fib.sync_fib_calls": 0,
            "fib.routes_programmed": 0,
            "fib.routes_deleted": 0,
            "fib.agent_restarts": 0,
            "fib.unacked_reprogrammed": 0,
            "fib.graceful_restarts": 0,
            "fib.gr_reconciles": 0,
            "fib.gr_hold_expirations": 0,
        }
        # prefixes/labels a failed delta left in unknown agent state
        # (the program call may have partially landed before the
        # transport died). The recovery sync re-programs the FULL
        # desired state, so these are re-acknowledged in bulk; the
        # counter makes the re-program visible.
        self._unacked_prefixes: set = set()
        self._unacked_labels: set = set()
        # bounded perf-event history served via getPerfDb
        # (reference: Fib keeps a PerfDatabase, if/OpenrCtrl.thrift:312)
        from collections import deque

        self.perf_db = deque(maxlen=32)
        self.evb.add_queue_reader(
            route_updates_queue.get_reader(f"fib:{my_node_name}"),
            self._on_route_update,
        )
        self._keepalive = self.evb.schedule_periodic(
            keepalive_interval_s, self._check_agent, jitter_first=True
        )

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        # capture the agent's liveness baseline before any traffic so a
        # restart between start and the first keepalive is still detected
        try:
            self._agent_alive_since = self.agent.alive_since()
        except Exception:
            self._agent_alive_since = None
        self.evb.run_in_thread()
        if self._gr_active and self.graceful_restart_hold_s > 0:
            self._gr_timer = self.evb.schedule_timeout(
                self.graceful_restart_hold_s, self._on_gr_hold_expired
            )

    def stop(self) -> None:
        self._keepalive.cancel()
        if self._gr_timer is not None:
            self._gr_timer.cancel()
            self._gr_timer = None
        self.evb.stop()
        self.evb.join()

    # -- graceful restart -------------------------------------------------

    def start_graceful_restart(
        self, route_db: RouteDatabase, hold_s: Optional[float] = None
    ) -> None:
        """Seed the desired state from a recovered RouteDatabase and
        enter the graceful-restart hold: the previous life's routes are
        presumed still programmed in the agent, so nothing is deleted
        or re-programmed until Decision re-converges (first route
        update) or the hold timer expires — then a single ``sync_fib``
        reconciles the table. Call BEFORE ``start()``."""
        if hold_s is not None:
            self.graceful_restart_hold_s = hold_s
        for r in route_db.unicast_routes:
            self.unicast_routes[r.dest] = r
        for r in route_db.mpls_routes:
            self.mpls_routes[r.top_label] = r
        self._gr_active = True
        # the agent table already holds these routes from the previous
        # life — do NOT treat the boot as never-synced (that would
        # force an immediate full sync and defeat the hold)
        self._synced_once = True
        self._dirty = False
        self.counters["fib.graceful_restarts"] += 1
        get_registry().counter_bump("fib.graceful_restarts")

    def _cancel_graceful_restart(self) -> None:
        self._gr_active = False
        if self._gr_timer is not None:
            self._gr_timer.cancel()
            self._gr_timer = None

    def _end_graceful_restart(self) -> bool:
        """Reconcile: one full sync replaces the held table with the
        current desired state. Unchanged routes are re-asserted, never
        withdrawn — the no-flap contract."""
        self._cancel_graceful_restart()
        self.counters["fib.gr_reconciles"] += 1
        return self._sync_route_db()

    def _on_gr_hold_expired(self) -> None:
        self._gr_timer = None
        if not self._gr_active:
            return
        # Decision never re-converged within the hold: stop waiting and
        # reconcile with what the journal recovered
        self.counters["fib.gr_hold_expirations"] += 1
        if not self._end_graceful_restart():
            self._mark_dirty()

    # -- route updates ----------------------------------------------------

    def _on_route_update(self, update: DecisionRouteUpdate) -> None:
        """reference: Fib.cpp:316 processRouteUpdates."""
        t0 = time.perf_counter()
        trace = getattr(update, "trace", None)
        program_span = (
            trace.begin_span("fib.program") if trace is not None else None
        )
        if update.perf_events is not None:
            update.perf_events.add(self.my_node_name, "FIB_ROUTE_DB_RECVD")
            self.perf_db.append(update.perf_events)
        # apply to desired state
        for prefix in update.unicast_routes_to_delete:
            self.unicast_routes.pop(prefix, None)
        for prefix, entry in update.unicast_routes_to_update.items():
            self.unicast_routes[prefix] = entry.to_unicast_route()
        for label in update.mpls_routes_to_delete:
            self.mpls_routes.pop(label, None)
        for entry in update.mpls_routes_to_update:
            self.mpls_routes[entry.label] = entry.to_mpls_route()

        if self._gr_active:
            # first update after a warm boot: Decision re-converged, so
            # end the hold with the one reconciling sync (the delta is
            # subsumed by the full desired state)
            ok = self._end_graceful_restart()
        elif not self._synced_once or self._dirty:
            ok = self._sync_route_db()
        else:
            ok = self._program_delta(update)
        if not ok:
            self._mark_dirty()

        # publish what we programmed (even in dry run: observers track
        # intended state)
        self.fib_updates_queue.push(update)
        duration_ms = (time.perf_counter() - t0) * 1000.0
        get_registry().observe("fib.program_ms", duration_ms)
        if trace is not None:
            trace.end_span(program_span, ok=ok)
            # end of the line: publication -> debounce -> rebuild ->
            # program. finish() validates span closure/nesting and
            # feeds convergence.e2e_ms.
            get_tracer().finish(trace, ok=ok)
        if ok and update.perf_events is not None and update.perf_events.events:
            # reference: Fib.cpp:891 logPerfEvents -> ROUTE_CONVERGENCE;
            # duration = first perf event (the triggering update entering
            # the pipeline) to routes-programmed, NOT just Fib-local
            # time. Only logged when programming SUCCEEDED — a failed
            # attempt has not converged.
            events = update.perf_events.events
            push_log_sample(
                self._log_sample_queue,
                node_name=self.my_node_name,
                event="ROUTE_CONVERGENCE",
                perf_events=[
                    f"{e.node_name}.{e.event_descr}" for e in events
                ],
                duration_ms=max(
                    0, int(time.time() * 1000) - events[0].unix_ts
                ),
            )
        self._advertise_fib_time(duration_ms)

    def _program_delta(self, update: DecisionRouteUpdate) -> bool:
        if self.dry_run:
            return True
        try:
            to_delete = [
                p
                for p in update.unicast_routes_to_delete
                if not self._is_do_not_install(p)
            ]
            if to_delete:
                self.agent.delete_unicast_routes(OPENR_CLIENT_ID, to_delete)
                self.counters["fib.routes_deleted"] += len(to_delete)
            to_add = [
                e.to_unicast_route()
                for e in update.unicast_routes_to_update.values()
                if not e.do_not_install
            ]
            if to_add:
                self.agent.add_unicast_routes(OPENR_CLIENT_ID, to_add)
                self.counters["fib.routes_programmed"] += len(to_add)
            if update.mpls_routes_to_delete:
                self.agent.delete_mpls_routes(
                    OPENR_CLIENT_ID, list(update.mpls_routes_to_delete)
                )
            if update.mpls_routes_to_update:
                self.agent.add_mpls_routes(
                    OPENR_CLIENT_ID,
                    [e.to_mpls_route() for e in update.mpls_routes_to_update],
                )
            return True
        except Exception:
            self.counters["fib.route_programming_failures"] += 1
            # the delta's targets are now in unknown agent state until
            # the recovery sync re-programs the full desired state
            self._unacked_prefixes.update(update.unicast_routes_to_delete)
            self._unacked_prefixes.update(update.unicast_routes_to_update)
            self._unacked_labels.update(update.mpls_routes_to_delete)
            self._unacked_labels.update(
                e.label for e in update.mpls_routes_to_update
            )
            return False

    def _is_do_not_install(self, prefix: IpPrefix) -> bool:
        route = self.unicast_routes.get(prefix)
        return route is not None and route.do_not_install

    def _sync_route_db(self) -> bool:
        """Full-state sync with the agent (reference: Fib.cpp:674)."""
        if self.dry_run:
            self._synced_once = True
            self._dirty = False
            return True
        try:
            self.counters["fib.sync_fib_calls"] += 1
            self.agent.sync_fib(
                OPENR_CLIENT_ID,
                [
                    r
                    for r in self.unicast_routes.values()
                    if not r.do_not_install
                ],
            )
            self.agent.sync_mpls_fib(
                OPENR_CLIENT_ID, list(self.mpls_routes.values())
            )
            self._synced_once = True
            self._dirty = False
            self._backoff.report_success()
            unacked = len(self._unacked_prefixes) + len(self._unacked_labels)
            if unacked:
                # the full sync just re-asserted every desired route,
                # covering everything a failed delta left unknown
                self.counters["fib.unacked_reprogrammed"] += unacked
                self._unacked_prefixes.clear()
                self._unacked_labels.clear()
            return True
        except Exception:
            self.counters["fib.route_programming_failures"] += 1
            return False

    def _mark_dirty(self) -> None:
        self._dirty = True
        self._backoff.report_error()
        if self._retry_timer is None:
            self._retry_timer = self.evb.schedule_timeout(
                self._backoff.get_time_remaining_until_retry(), self._retry
            )

    def _retry(self) -> None:
        self._retry_timer = None
        if not self._dirty:
            return
        if not self._sync_route_db():
            self._mark_dirty()

    # -- agent keepalive --------------------------------------------------

    def _check_agent(self) -> None:
        """Detect agent restart via aliveSince; full resync when it moves
        (reference: Fib.cpp keepAliveCheck)."""
        try:
            alive = self.agent.alive_since()
        except Exception:
            return
        if self._agent_alive_since is None:
            self._agent_alive_since = alive
            return
        if alive != self._agent_alive_since:
            self._agent_alive_since = alive
            self.counters["fib.agent_restarts"] += 1
            # an agent restart voids graceful restart's premise (the
            # held routes are gone from its table) — reconcile now via
            # the restart resync instead of waiting out the hold
            self._cancel_graceful_restart()
            # the restarted agent lost its table: every desired route
            # is effectively unacknowledged until the sync lands
            self._unacked_prefixes.update(self.unicast_routes)
            self._unacked_labels.update(self.mpls_routes)
            if not self._sync_route_db():
                self._mark_dirty()

    # -- perf key ---------------------------------------------------------

    def _advertise_fib_time(self, ms: float) -> None:
        if self._kvstore_client is None:
            return
        try:
            self._kvstore_client.persist_key(
                self._area,
                keyutil.fib_time_key(self.my_node_name),
                str(int(ms) or 1).encode(),
            )
        except Exception:
            pass

    # -- public (thread-safe) APIs ---------------------------------------

    def get_route_db(self) -> RouteDatabase:
        def build() -> RouteDatabase:
            return RouteDatabase(
                this_node_name=self.my_node_name,
                unicast_routes=list(self.unicast_routes.values()),
                mpls_routes=list(self.mpls_routes.values()),
            ).canonicalize()

        return self.evb.call_and_wait(build)

    def get_unicast_routes(
        self, prefixes: Optional[List[IpPrefix]] = None
    ) -> List[UnicastRoute]:
        def collect():
            if not prefixes:
                return sorted(
                    self.unicast_routes.values(), key=lambda r: r.dest
                )
            return [
                self.unicast_routes[p]
                for p in prefixes
                if p in self.unicast_routes
            ]

        return self.evb.call_and_wait(collect)

    def longest_prefix_match(self, addr: str) -> Optional[UnicastRoute]:
        """reference: Fib.cpp:164 longestPrefixMatch."""
        ip = ipaddress.ip_address(addr)

        def find() -> Optional[UnicastRoute]:
            best = None
            best_len = -1
            for prefix, route in self.unicast_routes.items():
                try:
                    net = ipaddress.ip_network(
                        f"{prefix.prefix_address.to_str()}/{prefix.prefix_length}",
                        strict=False,
                    )
                except ValueError:
                    continue
                if ip.version == net.version and ip in net:
                    if prefix.prefix_length > best_len:
                        best_len = prefix.prefix_length
                        best = route
            return best

        return self.evb.call_and_wait(find)

    def get_counters(self) -> Dict[str, int]:
        return self.evb.call_and_wait(lambda: dict(self.counters))
