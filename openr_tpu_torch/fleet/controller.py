"""FleetController: placement, live migration, hot-standby failover.

One controller runs N *managed services*. Each ``ManagedService`` is a
primary ``SolverService`` behind its own ctrl port plus (by default) a
hot standby: a second service+handler pair fed the primary's adopted-
publication journal by a ``JournalStreamer`` over the ctrl wire — the
standby applies, solves, and holds route products, so it is HOT, not
a cold spare.

Three fleet transitions, all inside the existing degradation
machinery (never silent):

- **admit** — weighted-occupancy placement by SLO class
  (fleet/placement.py), counted ``fleet.placements``; the client asks
  the controller (``fleet_admit`` / ``fleet_lookup``) which endpoint
  owns its tenant.
- **migrate** — drain on A (freeze + quiesce), ship host snapshot +
  un-replayed journal tail over the ctrl wire, rehydrate warm on B,
  seal (redirect installed on A), counted ``fleet.migrations`` with a
  ``fleet.migration_ms`` histogram. A failed import aborts back to A
  (tenant parked warm, ``fleet.migration_aborts``) — bits never at
  risk, only the move.
- **promote** — on ``device.lost`` or primary death the standby takes
  over under graceful-restart semantics: ONE reconcile, zero route
  deletes. The walk is a two-rung ``DegradationSupervisor`` ladder:
  rung 0 flushes the journal suffix to the standby first (the
  never-promote-past-an-un-shipped-suffix rule, satisfied by making
  the suffix empty); the fallback rung promotes at the standby's
  applied seq and SURRENDERS the un-shipped suffix counted
  (``fleet.promotion_unshipped``) — the crash case, degraded loudly
  within the ladder, never silently. The ``fleet.promote`` fault seam
  sits at the head of rung 0 so the chaos leg can force the walk down
  the ladder.

Port note: a copy of ``openr_tpu/fleet/controller.py``; every service
of the fleet (primaries and standbys) holds its blocks on the
controller's ``device`` (None = CUDA; raises without CUDA unless given
``device="cpu"``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.analysis.annotations import runs_on
from openr_tpu_torch.ctrl.server import CtrlClient, CtrlServer
from openr_tpu_torch.device import DeviceLike
from openr_tpu_torch.ctrl.solver import SolverCtrlHandler
from openr_tpu_torch.faults import fault_point, register_fault_site
from openr_tpu_torch.faults.supervisor import DegradationSupervisor
from openr_tpu_torch.fleet.journal import FleetJournal, JournalStreamer
from openr_tpu_torch.fleet.placement import (
    FLEET_COUNTERS,
    PlacementPolicy,
    ServiceLoad,
    placement_table,
)
from openr_tpu_torch.serve.service import SolverService
from openr_tpu_torch.telemetry import (
    get_flight_recorder,
    get_registry as _get_registry,
)

FAULT_PROMOTE = register_fault_site("fleet.promote")


class ManagedService:
    """One fleet slot: primary service + ctrl server, hot standby +
    ctrl server, and the journal stream tying them together. ``port``
    always names the endpoint clients should dial — promotion swaps
    it to the standby's."""

    def __init__(self, name: str, host: str = "127.0.0.1",
                 with_standby: bool = True,
                 stream_interval_s: float = 0.02,
                 wave_budget: Optional[int] = None,
                 device: DeviceLike = None):
        self.name = name
        self.host = host
        self.journal = FleetJournal()
        self.service = SolverService(wave_budget=wave_budget, device=device)
        self.handler = SolverCtrlHandler(
            self.service, journal=self.journal, role="primary"
        )
        self.server = CtrlServer(self.handler, host=host, port=0)
        self.port = self.server.port
        self.standby_service: Optional[SolverService] = None
        self.standby_handler: Optional[SolverCtrlHandler] = None
        self.standby_server: Optional[CtrlServer] = None
        self.standby_port: Optional[int] = None
        self.streamer: Optional[JournalStreamer] = None
        self._stream_cli: Optional[CtrlClient] = None
        self.promoted = False
        if with_standby:
            self.standby_service = SolverService(
                wave_budget=wave_budget, device=device
            )
            self.standby_handler = SolverCtrlHandler(
                self.standby_service, journal=None, role="standby"
            )
            self.standby_server = CtrlServer(
                self.standby_handler, host=host, port=0
            )
            self.standby_port = self.standby_server.port
            self.streamer = JournalStreamer(
                self.journal, self._ship,
                interval_s=stream_interval_s,
                name=f"fleet-streamer-{name}",
            )

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "ManagedService":
        self.service.start()
        self.server.start()
        if self.standby_service is not None:
            self.standby_service.start()
            self.standby_server.start()
            self.streamer.start()
        return self

    def stop(self) -> None:
        if self.streamer is not None:
            self.streamer.stop()
        self._close_stream_cli()
        for server in (self.server, self.standby_server):
            if server is not None:
                try:
                    server.stop()
                except OSError:
                    pass
        for svc in (self.service, self.standby_service):
            if svc is not None:
                svc.stop()

    # -- journal stream (runs on the streamer thread only) -----------

    def _ship(self, frames: List[Dict]) -> int:
        if self.standby_port is None:
            raise ConnectionError("no standby to ship to")
        try:
            if self._stream_cli is None:
                self._stream_cli = CtrlClient(
                    self.host, self.standby_port
                )
            reply = self._stream_cli.call(
                "solver_replica_apply", records=frames
            )
            return int(reply["applied_seq"])
        except Exception:
            # drop the wire so the retry re-dials fresh
            self._close_stream_cli()
            raise

    def _close_stream_cli(self) -> None:
        if self._stream_cli is not None:
            try:
                self._stream_cli.close()
            except OSError:
                pass
            self._stream_cli = None

    # -- failure / takeover ------------------------------------------

    def alive(self) -> bool:
        """Is the PRIMARY answering its wire?"""
        try:
            cli = CtrlClient(self.host, self.port)
            try:
                cli.call("solver_ping")
            finally:
                cli.close()
            return True
        except (ConnectionError, OSError, RuntimeError):
            return False

    def kill_primary(self) -> None:
        """Abrupt primary death (tests/chaos): the wire drops with no
        handover — exactly what ``maybe_failover`` must detect."""
        try:
            self.server.stop()
        except OSError:
            pass
        self.service.stop()

    def adopt_standby(self) -> None:
        """Post-promotion bookkeeping: the standby IS the service now.
        The old primary (dead or being retired) is stopped; the
        advertised endpoint flips; the stream ends (the new primary
        runs without a standby until the operator re-seeds one)."""
        if self.standby_server is None:
            raise RuntimeError(f"{self.name}: no standby to adopt")
        if self.streamer is not None:
            self.streamer.stop()
            self.streamer = None
        self._close_stream_cli()
        try:
            self.server.stop()
        except OSError:
            pass
        self.service.stop()
        self.service = self.standby_service
        self.handler = self.standby_handler
        self.server = self.standby_server
        self.port = self.standby_port
        self.standby_service = None
        self.standby_handler = None
        self.standby_server = None
        self.standby_port = None
        self.promoted = True


class FleetController:
    """Owns the placement table and drives every fleet transition.
    Thread model: public methods run on whatever thread calls them
    (tests, tools, the controller's own ctrl handler threads) —
    ``_lock`` guards the placement maps; each wire conversation uses
    its own short-lived ``CtrlClient``."""

    def __init__(self, services: int = 2, with_standby: bool = True,
                 host: str = "127.0.0.1", capacity: int = 64,
                 wave_budget: Optional[int] = None,
                 stream_interval_s: float = 0.02,
                 device: DeviceLike = None):
        self._lock = threading.RLock()
        self._policy = PlacementPolicy()
        self._services: Dict[str, ManagedService] = {}
        self._loads: Dict[str, ServiceLoad] = {}
        for i in range(services):
            name = f"svc{i}"
            self._services[name] = ManagedService(
                name, host=host, with_standby=with_standby,
                stream_interval_s=stream_interval_s,
                wave_budget=wave_budget, device=device,
            )
            self._loads[name] = ServiceLoad(name, capacity=capacity)
        self._ctrl: Optional[CtrlServer] = None
        self._promote_sup = DegradationSupervisor(
            "fleet.promote_ladder",
            backoff_min_s=0.01, backoff_max_s=0.2,
        )
        self._reg = _get_registry()

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "FleetController":
        for ms in self._services.values():
            ms.start()
        return self

    def stop(self) -> None:
        if self._ctrl is not None:
            try:
                self._ctrl.stop()
            except OSError:
                pass
            self._ctrl = None
        for ms in self._services.values():
            ms.stop()

    def serve_ctrl(self, host: str = "127.0.0.1") -> int:
        """Put the controller itself on the ctrl wire (fleet_lookup /
        fleet_admit / fleet_services) — the endpoint redirect-chasing
        clients fall back to. Returns the bound port."""
        self._ctrl = CtrlServer(
            FleetCtrlHandler(self), host=host, port=0
        )
        self._ctrl.start()
        return self._ctrl.port

    # -- placement ---------------------------------------------------

    def services(self) -> Dict[str, ManagedService]:
        return dict(self._services)

    def placement(self) -> Dict[str, Dict]:
        with self._lock:
            table = placement_table(self._loads.values())
        for name, row in table.items():
            ms = self._services[name]
            row["endpoint"] = [ms.host, ms.port]
            row["standby"] = (
                [ms.host, ms.standby_port]
                if ms.standby_port is not None else None
            )
            row["promoted"] = ms.promoted
        return table

    def admit(self, tenant_id: str,
              slo: str = "standard") -> Tuple[str, int]:
        """Place the tenant; returns the endpoint it should register
        with. Placement is a table entry — the client still does its
        own ``solver_register`` against the endpoint."""
        with self._lock:
            row = self._policy.place(
                sorted(self._loads.values(), key=lambda s: s.name),
                tenant_id, slo,
            )
            ms = self._services[row.name]
            return (ms.host, ms.port)

    def owner_of(self, tenant_id: str) -> str:
        with self._lock:
            for name, row in self._loads.items():
                if tenant_id in row.tenants:
                    return name
        raise KeyError(f"tenant {tenant_id!r} not placed")

    def lookup(self, tenant_id: str) -> Dict[str, object]:
        """Current endpoint for a tenant — survives migrations AND
        promotions (the managed service's advertised port flips with
        the takeover)."""
        name = self.owner_of(tenant_id)
        ms = self._services[name]
        return {"service": name, "host": ms.host, "port": ms.port}

    # -- live migration ----------------------------------------------

    def migrate(self, tenant_id: str,
                dst: Optional[str] = None) -> Dict[str, object]:
        """Drain on A, ship, rehydrate warm on B, seal. Returns the
        import reply (``warm`` is the no-cold-solve witness)."""
        with self._lock:
            src_name = self.owner_of(tenant_id)
            slo = self._loads[src_name].tenants[tenant_id]
            if dst is None:
                dst = self._policy.choose(
                    sorted(self._loads.values(),
                           key=lambda s: s.name),
                    slo, exclude=[src_name],
                ).name
            if dst == src_name:
                raise ValueError(
                    f"migrate {tenant_id!r}: dst == src ({dst})"
                )
            src_ms = self._services[src_name]
            dst_ms = self._services[dst]
        t0 = time.perf_counter()
        src_cli = CtrlClient(src_ms.host, src_ms.port)
        try:
            bundle = src_cli.call(
                "solver_export", tenant_id=tenant_id
            )
            try:
                dst_cli = CtrlClient(dst_ms.host, dst_ms.port)
                try:
                    reply = dst_cli.call(
                        "solver_import", bundle=bundle
                    )
                finally:
                    dst_cli.close()
            except Exception:
                # import failed: thaw on A, tenant parked warm there
                src_cli.call(
                    "solver_abort_migration", tenant_id=tenant_id
                )
                FLEET_COUNTERS["migration_aborts"] += 1
                raise
            src_cli.call(
                "solver_seal_migration", tenant_id=tenant_id,
                host=dst_ms.host, port=dst_ms.port,
            )
        finally:
            src_cli.close()
        with self._lock:
            self._loads[src_name].evict(tenant_id)
            self._loads[dst].admit(tenant_id, slo)
        ms_elapsed = (time.perf_counter() - t0) * 1000.0
        FLEET_COUNTERS["migrations"] += 1
        self._reg.observe("fleet.migration_ms", ms_elapsed)
        get_flight_recorder().note(
            "fleet.migrate",
            tenant=tenant_id, src=src_name, dst=dst,
            warm=bool(reply.get("warm")),
            ms=round(ms_elapsed, 3),
        )
        return dict(reply, src=src_name, dst=dst)

    # -- failover ----------------------------------------------------

    def promote(self, name: str,
                reason: str = "operator") -> Dict[str, object]:
        """Standby takeover for one service, walked down the ladder
        (see module docstring). Raises ``LadderExhausted`` if even the
        at-applied-seq rung cannot complete."""
        ms = self._services[name]
        if ms.standby_port is None:
            raise RuntimeError(f"{name}: no standby to promote")

        def _promote_at(surrendered: int) -> Dict[str, object]:
            cli = CtrlClient(ms.host, ms.standby_port)
            try:
                summary = cli.call("solver_promote")
            finally:
                cli.close()
            deletes = int(summary.get("deletes", 0))
            FLEET_COUNTERS["promotions"] += 1
            FLEET_COUNTERS["promotion_deletes"] += deletes
            if surrendered:
                FLEET_COUNTERS["promotion_unshipped"] += surrendered
            ms.adopt_standby()
            get_flight_recorder().note(
                "fleet.promote",
                service=name, reason=reason, deletes=deletes,
                surrendered=surrendered,
                applied_seq=summary.get("applied_seq"),
            )
            return dict(
                summary, service=name, surrendered=surrendered
            )

        def rung_flush_and_promote() -> Dict[str, object]:
            # the chaos seam: an armed schedule fails this rung so
            # the walk degrades (counted by the supervisor) instead
            # of taking the clean path
            fault_point(FAULT_PROMOTE)
            if ms.streamer is None or not ms.streamer.flush(
                timeout_s=5.0
            ):
                raise RuntimeError(
                    f"{name}: journal suffix not shipped"
                )
            return _promote_at(surrendered=0)

        def rung_promote_at_applied_seq() -> Dict[str, object]:
            # crash rung: the primary (or its wire) is gone — promote
            # at the standby's applied seq, surrendering the
            # un-shipped suffix COUNTED, never silently
            unshipped = (
                len(ms.streamer.unshipped())
                if ms.streamer is not None else 0
            )
            return _promote_at(surrendered=unshipped)

        # both rungs promote the standby (neither computes on the host
        # in place of a card), so any failure of the first walks on, as
        # in the reference
        return self._promote_sup.run([
            ("flush_and_promote", rung_flush_and_promote),
            ("promote_at_applied_seq", rung_promote_at_applied_seq),
        ], recoverable=lambda _exc: True)

    def fail_over(self, name: str,
                  reason: str = "device.lost") -> Dict[str, object]:
        """Deliberate failover (injected ``device.lost``, operator
        drain): same ladder as ``promote`` — the flush rung still
        applies because the primary HOST may be healthy even when its
        device is lost."""
        return self.promote(name, reason=reason)

    def maybe_failover(self) -> List[str]:
        """Detection sweep: ping every primary; promote the dead ones.
        Returns the promoted service names."""
        promoted: List[str] = []
        for name, ms in list(self._services.items()):
            if ms.promoted or ms.standby_port is None:
                continue
            if ms.alive():
                continue
            FLEET_COUNTERS["failovers_detected"] += 1
            self.promote(name, reason="primary_death")
            promoted.append(name)
        return promoted

    # -- introspection -----------------------------------------------

    def counters(self) -> Dict[str, float]:
        snap = self._reg.snapshot()
        return {
            k: v for k, v in snap.items() if k.startswith("fleet.")
        }


@runs_on("ctrl")
class FleetCtrlHandler:
    """The controller's own wire surface: what a redirect-chasing
    client (serve/client.py) falls back to when its cached endpoint
    stops answering. Every served lookup is a redirect, counted."""

    def __init__(self, controller: FleetController):
        self._fc = controller

    def fleet_lookup(self, tenant_id: str) -> Dict[str, object]:
        endpoint = self._fc.lookup(tenant_id)
        FLEET_COUNTERS["client_redirects"] += 1
        return endpoint

    def fleet_admit(self, tenant_id: str,
                    slo: str = "standard") -> Dict[str, object]:
        host, port = self._fc.admit(tenant_id, slo)
        return {"host": host, "port": port}

    def fleet_services(self) -> Dict[str, Dict]:
        return self._fc.placement()

    def fleet_counters(self) -> Dict[str, float]:
        return self._fc.counters()
