"""SolverClient: the client daemon's side of solver-as-a-service.

Deliberately *thin, torch-free and jax-free*: a client process imports
only the stdlib, numpy, and the wire codec — no torch, no jax, no graph
compiler, no engines. That is the point of the ownership inversion: many cheap
client daemons (Decision instances, twins, what-if tools) feed worlds
to ONE device-owning service process and read views back.

Speaks the ctrl transport's JSON frames (the same
``{"method", "kwargs"}`` envelope ``CtrlServer`` dual-stacks), so a
solver client and a breeze CLI can share a port. Worlds travel as
base64 ``utils.wire`` AdjacencyDatabase blobs; views come back as
base64 int32 packed blocks decoded into ``SolverView``.

Fleet awareness: a service restart, a live migration, or a
standby promotion must never surface as a raw socket error or a
silent hang. The call path therefore:

- **reconnects with jittered backoff** (the stock
  ``utils.eventbase.ExponentialBackoff``) when a wire drops, then
  re-registers every tenant routed over it (the service parked them
  warm on disconnect — re-registration reattaches the connection
  binding and the next solve rehydrates warm);
- **follows ``moved_to`` redirects** from a migration seal — the
  per-tenant route table flips to the destination and the call
  retries there, counted in ``self.redirects`` (the server side
  counts ``fleet.client_redirects``);
- **honors retry-later** replies (a tenant frozen mid-drain) by
  sleeping the server's hint instead of failing;
- **falls back to the fleet controller** (``controller=(host,
  port)``) when the cached endpoint stops answering entirely — a
  ``fleet_lookup`` names the tenant's current owner, which also
  covers promotions (the endpoint flips to the adopted standby).

Port note: a copy of ``openr_tpu/serve/client.py``; it speaks the same
frames as the reference's, so either package's client reads either
package's service.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import socket
import struct
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from openr_tpu_torch.types.lsdb import AdjacencyDatabase, PrefixDatabase
from openr_tpu_torch.types.fib import RouteDatabase
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import ExponentialBackoff

# distinct trace ids across many clients in one process (the load
# generator spawns several per worker)
_CLIENT_SEQ = itertools.count(1)

Endpoint = Tuple[str, int]


def _send_frame(sock: socket.socket, obj) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[Dict]:
    header = b""
    while len(header) < 4:
        chunk = sock.recv(4 - len(header))
        if not chunk:
            return None
        header += chunk
    (length,) = struct.unpack(">I", header)
    payload = b""
    while len(payload) < length:
        chunk = sock.recv(length - len(payload))
        if not chunk:
            return None
        payload += chunk
    return json.loads(payload.decode("utf-8"))


class SolverView:
    """Decoded tenant view: ``packed`` is the [2b, n_pad] int32 block
    (rows [0, b) distances per source, rows [b, 2b) first hops — the
    ``ell_view_batch_packed`` layout), ``nodes`` maps column -> node
    name, and row 0 is the root's distance row."""

    def __init__(self, reply: Dict):
        self.root: str = reply["root"]
        self.srcs: List[int] = list(reply["srcs"])
        self.n_pad: int = int(reply["n_pad"])
        self.nodes: List[str] = list(reply["nodes"])
        shape = tuple(reply["shape"])
        self.packed = np.frombuffer(
            base64.b64decode(reply["packed_b64"]), dtype=np.int32
        ).reshape(shape)
        self.index: Dict[str, int] = {
            name: i for i, name in enumerate(self.nodes)
        }

    def distance(self, dst: str) -> int:
        return int(self.packed[0, self.index[dst]])

    def digest(self) -> int:
        """FNV-1a over the packed bytes — what the parity gates
        compare against a server/oracle digest."""
        h = 0x811C9DC5
        for b in self.packed.tobytes():
            h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
        return h


class FibView:
    """Decoded FIB-level tenant view: the tenant's full canonical
    ``RouteDatabase`` (unicast + MPLS route products, not just the
    SP distances) plus the server's digest of the same bytes."""

    def __init__(self, reply: Dict):
        self.root: str = reply["root"]
        self.digest: int = int(reply["digest"])
        self.blob: bytes = base64.b64decode(reply["route_db_b64"])
        self.route_db: RouteDatabase = wire.loads(
            self.blob, RouteDatabase
        )

    def unicast_count(self) -> int:
        return len(self.route_db.unicast_routes)

    def mpls_count(self) -> int:
        return len(self.route_db.mpls_routes)


class SolverClient:
    """One client daemon's wire to the solver fleet. Tenants are
    routed per-endpoint (``_route``); every tenant registered through
    an endpoint's connection is tied to it server-side (a disconnect
    parks them warm, re-registration reattaches).

    Cross-wire tracing: every request frame carries a top-level
    ``"trace"`` object (trace id stable per client, span id fresh per
    call) that the service adopts into its wave spans and flight
    records — a client-observed latency anomaly is chaseable to the
    exact service wave that served it. The client also keeps a rolling
    solve-latency window; a p99 breach against its own EWMA baseline
    (``breach_factor`` x, absolute ``breach_floor_ms``) fires a
    service-side ``dump_postmortem`` over the same wire, stamped with
    the breaching span id. Pass ``breach_factor=None`` to disarm."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2018,
                 timeout_s: float = 120.0,
                 breach_factor: Optional[float] = 4.0,
                 breach_min_samples: int = 64,
                 breach_floor_ms: float = 50.0,
                 controller: Optional[Endpoint] = None,
                 backoff_initial_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 max_attempts: int = 64):
        self._default_ep: Endpoint = (host, port)
        self._timeout_s = timeout_s
        self._conns: Dict[Endpoint, socket.socket] = {}
        self._route: Dict[str, Endpoint] = {}
        self._registered: Dict[str, Tuple[str, str]] = {}
        self._controller: Optional[Endpoint] = (
            (str(controller[0]), int(controller[1]))
            if controller is not None else None
        )
        # decorrelated jitter so a fleet of clients hammered off one
        # dead service does not re-dial in lockstep
        self._backoff = ExponentialBackoff(
            backoff_initial_s, backoff_max_s, jitter=True,
            seed=(os.getpid() << 8) ^ id(self) & 0xFF,
        )
        self._max_attempts = max(1, max_attempts)
        self.redirects = 0
        self.reconnects = 0
        # eager dial: constructing a client against a dead endpoint
        # still fails fast (the retry machinery guards LATER drops)
        self._sock_for(self._default_ep)
        self._trace_id = f"sc-{os.getpid():x}-{next(_CLIENT_SEQ):x}"
        self._span_seq = itertools.count(1)
        self.last_span_id: Optional[str] = None
        self.span_ids: deque = deque(maxlen=1024)
        self._breach_factor = breach_factor
        self._breach_min_samples = max(8, int(breach_min_samples))
        self._breach_floor_ms = breach_floor_ms
        self._lat_ring: deque = deque(maxlen=256)
        self._breach_baseline: Optional[float] = None
        self.breaches = 0

    @property
    def trace_id(self) -> str:
        return self._trace_id

    # back-compat shim: the pre-fleet client exposed its single socket
    @property
    def _sock(self) -> socket.socket:
        return self._sock_for(self._default_ep)

    def _next_trace(self, method: str) -> Dict:
        span_id = f"{self._trace_id}.{next(self._span_seq):x}"
        self.last_span_id = span_id
        self.span_ids.append(span_id)
        return {
            "trace_id": self._trace_id,
            "span_id": span_id,
            "origin": "solver_client",
            "method": method,
        }

    # -- wire plumbing -------------------------------------------------

    def _sock_for(self, ep: Endpoint) -> socket.socket:
        sock = self._conns.get(ep)
        if sock is None:
            sock = socket.create_connection(
                ep, timeout=self._timeout_s
            )
            self._conns[ep] = sock
        return sock

    def _drop_conn(self, ep: Endpoint) -> None:
        sock = self._conns.pop(ep, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _raw_call(self, ep: Endpoint, method: str, **kwargs) -> Dict:
        sock = self._sock_for(ep)
        _send_frame(sock, {
            "method": method,
            "kwargs": kwargs,
            "trace": self._next_trace(method),
        })
        reply = _recv_frame(sock)
        if reply is None:
            raise ConnectionError("solver service closed connection")
        return reply

    def _reregister(self, ep: Endpoint) -> None:
        """After a reconnect (or a redirect landing on a fresh wire):
        re-declare every tenant routed to ``ep`` so the service ties
        them to the NEW connection. Parked-warm records rehydrate on
        the next solve; failures here fall through to the main retry
        loop."""
        for tid, route_ep in list(self._route.items()):
            if route_ep != ep:
                continue
            reg = self._registered.get(tid)
            if reg is None:
                continue
            slo, area = reg
            try:
                self._raw_call(
                    ep, "solver_register",
                    tenant_id=tid, slo=slo, area=area,
                )
            except (ConnectionError, OSError):
                return  # wire still bad: the retry loop owns it

    def _relocate(self, tenant_id: Optional[str],
                  ep: Endpoint) -> Endpoint:
        """Endpoint lost and no redirect in hand: ask the fleet
        controller who owns the tenant now (covers migrations sealed
        while we were gone AND standby promotions, where the old
        primary simply vanishes)."""
        if tenant_id is None or self._controller is None:
            return ep
        try:
            reply = self._raw_call(
                self._controller, "fleet_lookup", tenant_id=tenant_id
            )
        except (ConnectionError, OSError):
            self._drop_conn(self._controller)
            return ep
        if not reply.get("ok"):
            return ep
        result = reply.get("result") or {}
        new_ep = (str(result["host"]), int(result["port"]))
        if new_ep != ep:
            self.redirects += 1
            self._route[tenant_id] = new_ep
            self._reregister(new_ep)
        return new_ep

    def _call(self, method: str, _tenant: Optional[str] = None,
              **kwargs):
        ep = (
            self._route.get(_tenant, self._default_ep)
            if _tenant is not None else self._default_ep
        )
        last_exc: Optional[BaseException] = None
        for _attempt in range(self._max_attempts):
            try:
                reply = self._raw_call(ep, method, **kwargs)
            except (ConnectionError, OSError) as exc:
                last_exc = exc
                self._drop_conn(ep)
                self.reconnects += 1
                self._backoff.report_error()
                delay = (
                    self._backoff.get_time_remaining_until_retry()
                )
                if delay > 0:
                    time.sleep(min(delay, 1.0))
                relocated = self._relocate(_tenant, ep)
                if relocated == ep:
                    # same endpoint: re-dial + re-register happens on
                    # the next _raw_call / after it succeeds
                    try:
                        self._sock_for(ep)
                        self._reregister(ep)
                    except (ConnectionError, OSError):
                        pass
                ep = relocated
                continue
            if reply.get("ok"):
                self._backoff.report_success()
                if _tenant is not None:
                    self._route[_tenant] = ep
                return reply.get("result")
            moved = reply.get("moved_to")
            if isinstance(moved, dict):
                # migration seal: chase the tenant to its new owner
                new_ep = (str(moved["host"]), int(moved["port"]))
                self.redirects += 1
                if _tenant is not None:
                    self._route[_tenant] = new_ep
                    self._reregister(new_ep)
                ep = new_ep
                continue
            if reply.get("retry"):
                # frozen mid-migration: honor the server's hint
                time.sleep(max(
                    0.001,
                    float(reply.get("retry_after_ms", 50.0)) / 1000.0,
                ))
                continue
            raise RuntimeError(reply.get("error", "unknown error"))
        if last_exc is not None:
            raise ConnectionError(
                f"{method}: retries exhausted ({last_exc})"
            ) from last_exc
        raise ConnectionError(f"{method}: retries exhausted")

    # -- client-observed p99 breach watch ------------------------------

    def _observe_solve_latency(self, ms: float) -> None:
        if self._breach_factor is None:
            return
        self._lat_ring.append(ms)
        if len(self._lat_ring) < self._breach_min_samples:
            return
        ordered = sorted(self._lat_ring)
        p99 = ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]
        if self._breach_baseline is None:
            self._breach_baseline = p99
            return
        baseline = self._breach_baseline
        threshold = max(self._breach_floor_ms,
                        self._breach_factor * baseline)
        self._breach_baseline = 0.9 * baseline + 0.1 * p99
        if p99 > threshold:
            # re-baseline: one sustained regression fires once, and the
            # service-side rate limiter bounds a fleet of clients
            self._breach_baseline = p99
            self.breaches += 1
            try:
                self.dump_postmortem(
                    trigger="client_p99_breach",
                    reason=(f"client-observed p99 {p99:.2f}ms > "
                            f"{self._breach_factor:g}x baseline "
                            f"{baseline:.2f}ms; trace {self.last_span_id}"),
                )
            except (RuntimeError, ConnectionError, OSError):
                pass  # a breach report must never break the solve path

    # -- surface -----------------------------------------------------------

    def hello(self) -> Dict:
        return self._call("solver_hello")

    def ping(self) -> Dict:
        return self._call("solver_ping")

    def register(self, tenant_id: str, slo: str = "standard",
                 area: str = "0") -> Dict:
        self._registered[tenant_id] = (slo, area)
        self._route.setdefault(tenant_id, self._default_ep)
        return self._call(
            "solver_register", _tenant=tenant_id,
            tenant_id=tenant_id, slo=slo, area=area,
        )

    def update_world(
        self,
        tenant_id: str,
        adj_dbs: Iterable[AdjacencyDatabase],
        root: Optional[str] = None,
        prefix_dbs: Optional[Iterable[PrefixDatabase]] = None,
    ) -> Dict:
        blobs = [
            base64.b64encode(wire.dumps(db)).decode()
            for db in adj_dbs
        ]
        prefix_blobs = [
            base64.b64encode(wire.dumps(db)).decode()
            for db in (prefix_dbs or [])
        ]
        return self._call(
            "solver_update", _tenant=tenant_id,
            tenant_id=tenant_id, adj_dbs=blobs, root=root,
            prefix_dbs=prefix_blobs or None,
        )

    def solve(self, tenant_id: str,
              timeout: float = 60.0) -> SolverView:
        t0 = time.perf_counter()
        view = SolverView(self._call(
            "solver_solve", _tenant=tenant_id,
            tenant_id=tenant_id, timeout=timeout,
        ))
        self._observe_solve_latency((time.perf_counter() - t0) * 1000.0)
        return view

    def fib(self, tenant_id: str, timeout: float = 60.0) -> FibView:
        """The tenant's full route product (``RouteDatabase``), not
        just the SP view — decoded torch-free off the wire."""
        return FibView(self._call(
            "solver_fib", _tenant=tenant_id,
            tenant_id=tenant_id, timeout=timeout,
        ))

    def ksp2(self, tenant_id: str, dsts: List[str]) -> Dict:
        return self._call(
            "solver_ksp2", _tenant=tenant_id,
            tenant_id=tenant_id, dsts=list(dsts),
        )

    def detach(self, tenant_id: str, warm: bool = True) -> Dict:
        return self._call(
            "solver_detach", _tenant=tenant_id,
            tenant_id=tenant_id, warm=warm,
        )

    def endpoint_of(self, tenant_id: str) -> Endpoint:
        """Where this client currently routes the tenant (tests +
        tooling introspection)."""
        return self._route.get(tenant_id, self._default_ep)

    def counters(self) -> Dict:
        return self._call("solver_counters")

    def dump_postmortem(self, trigger: str = "manual",
                        reason: str = "") -> Dict:
        """Ask the SERVICE to cut a post-mortem bundle (the breach
        watch calls this with the breaching trace stamped into the
        reason, so the bundle pairs with the client's observation)."""
        return self._call(
            "dump_postmortem", trigger=trigger, reason=reason
        )

    def close(self) -> None:
        for ep in list(self._conns):
            self._drop_conn(ep)
