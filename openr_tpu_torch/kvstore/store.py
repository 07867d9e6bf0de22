"""KvStore: the flooded, eventually-consistent link-state database.

Behavioral parity with the reference ``openr/kvstore/KvStore.{h,cpp}``:

- CRDT-style merge ordered by (version, originatorId, value bytes), with
  TTL-only updates on (version, originator) match and higher ttlVersion
  (reference: KvStore.cpp:263 mergeKeyValues, :426 compareValues)
- per-area stores (one ``KvStoreDb`` per area, reference: KvStore.h:202)
- flood-on-merge to all INITIALIZED peers except the sender; merge no-ops
  stop the flood (loop suppression; reference: KvStore.cpp:2861
  floodPublication, peer gating :2957)
- 3-way initial full sync: initiator sends its hash dump, responder
  returns better/missing values plus the key list the initiator should
  push back (reference: dumpDifference :1351, finalizeFullSync :2727),
  with the per-peer IDLE -> SYNCING -> INITIALIZED FSM and exponential
  backoff on failure (reference: KvStore.h:46-61)
- TTL countdown and local expiry flood (reference: cleanupTtlCountdownQueue
  :2611)

Transport is abstracted behind ``PeerTransport`` (the reference dual-stacks
fbzmq ROUTER and thrift; here: an in-process transport for tests/daemons in
one process and a TCP transport for real deployments). Peer I/O runs on an
executor so store event loops never block on each other.

Port note: a copy of ``openr_tpu/kvstore/store.py``. Its DUAL flood
optimisation imports the port's ``dual/dual.py``; the fault sites
``kvstore.full_sync`` and ``kvstore.flood`` register in the port's
``faults/injector.py``. ``merge_hook`` stays a plain callable: the
crash-safe state plane that sets it in the reference is not ported yet.
The cross-process transports (``transport.py``, ``thrift_peer.py``,
``dualstack.py``) are left out for a later slice: the port's stores peer
over ``InProcessTransport``. Nothing here touches a device.
"""

from __future__ import annotations

import heapq
import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from openr_tpu_torch.faults.injector import fault_point, register_fault_site
from openr_tpu_torch.monitor.monitor import push_log_sample
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.telemetry import get_registry, get_tracer
from openr_tpu_torch.types import (
    DEFAULT_AREA,
    TTL_INFINITY,
    KeyDumpParams,
    KeySetParams,
    KvStorePeerState,
    Publication,
    Value,
)
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import ExponentialBackoff, OpenrEventBase

# ttl decrement applied when re-flooding, so a key eventually dies even in
# a flood loop (reference: Constants.h kTtlDecrement)
TTL_DECREMENT_MS = 1

_LOG = logging.getLogger(__name__)

# injection seams for the store's two peer-I/O paths: the 3-way full
# sync request and the flood fan-out. Both fire on the executor thread
# inside the existing try blocks, so an injected fault takes the same
# backoff + re-sync recovery path as a real transport error.
FAULT_KV_FULL_SYNC = register_fault_site("kvstore.full_sync")
FAULT_KV_FLOOD = register_fault_site("kvstore.flood")


@dataclass
class KvStoreFilters:
    """Key prefix + originator filter (reference: KvStoreFilters in
    KvStore.h; OR semantics across the two dimensions)."""

    key_prefixes: List[str] = field(default_factory=list)
    originator_ids: Set[str] = field(default_factory=set)

    def key_match(self, key: str, value: Value) -> bool:
        if not self.key_prefixes and not self.originator_ids:
            return True
        if self.key_prefixes and any(key.startswith(p) for p in self.key_prefixes):
            return True
        if self.originator_ids and value.originator_id in self.originator_ids:
            return True
        return False


def compare_values(v1: Value, v2: Value) -> int:
    """1 if v1 better, -1 if v2 better, 0 equal, -2 unknown.
    reference: KvStore.cpp:426 compareValues."""
    if v1.version != v2.version:
        return 1 if v1.version > v2.version else -1
    if v1.originator_id != v2.originator_id:
        return 1 if v1.originator_id > v2.originator_id else -1
    if v1.hash is not None and v2.hash is not None and v1.hash == v2.hash:
        if v1.ttl_version != v2.ttl_version:
            return 1 if v1.ttl_version > v2.ttl_version else -1
        return 0
    if v1.value is not None and v2.value is not None:
        if v1.value == v2.value:
            if v1.ttl_version != v2.ttl_version:
                return 1 if v1.ttl_version > v2.ttl_version else -1
            return 0
        return 1 if v1.value > v2.value else -1
    return -2


def merge_key_values(
    store: Dict[str, Value],
    key_vals: Dict[str, Value],
    filters: Optional[KvStoreFilters] = None,
) -> Dict[str, Value]:
    """Merge key_vals into store; returns the accepted updates (what must
    be flooded onward). reference: KvStore.cpp:263 mergeKeyValues."""
    updates: Dict[str, Value] = {}
    for key, value in key_vals.items():
        if filters is not None and not filters.key_match(key, value):
            continue
        # TTL must be infinite or positive
        if value.ttl != TTL_INFINITY and value.ttl <= 0:
            continue
        existing = store.get(key)
        my_version = existing.version if existing is not None else 0
        if value.version < my_version:
            continue

        update_all = False
        update_ttl = False
        if value.value is not None:
            if value.version > my_version:
                update_all = True
            elif value.originator_id > existing.originator_id:
                update_all = True
            elif value.originator_id == existing.originator_id:
                if existing.value is None or value.value > existing.value:
                    update_all = True
                elif value.value == existing.value:
                    if value.ttl_version > existing.ttl_version:
                        update_ttl = True
        if (
            value.value is None
            and existing is not None
            and value.version == existing.version
            and value.originator_id == existing.originator_id
            and value.ttl_version > existing.ttl_version
        ):
            update_ttl = True

        if not update_all and not update_ttl:
            continue

        if update_all:
            new_value = Value(
                version=value.version,
                originator_id=value.originator_id,
                value=value.value,
                ttl=value.ttl,
                ttl_version=value.ttl_version,
                hash=value.hash
                if value.hash is not None
                else wire.generate_hash(
                    value.version, value.originator_id, value.value
                ),
            )
            store[key] = new_value
        else:  # ttl-only refresh
            existing.ttl = value.ttl
            existing.ttl_version = value.ttl_version
        updates[key] = value
    return updates


class PeerTransport:
    """RPC surface a store exposes to its peers (reference: the
    KvStoreService thrift interface / fbzmq ROUTER socket)."""

    # (host, port) the transport dials, when it dials anywhere — the
    # ctrl surface reports it as the thrift PeerSpec peerAddr/ctrlPort
    # (reference: openr/if/KvStore.thrift PeerSpec). In-process
    # transports have no endpoint.
    endpoint: Optional[Tuple[str, int]] = None

    def get_key_vals_filtered(
        self, area: str, params: KeyDumpParams
    ) -> Publication:
        raise NotImplementedError

    def set_key_vals(self, area: str, params: KeySetParams) -> None:
        raise NotImplementedError

    def send_dual_messages(self, area: str, sender_id: str, msgs) -> None:
        """Deliver DUAL messages for the flood-topology computation
        (reference: KvStoreService processKvStoreDualMessage)."""
        raise NotImplementedError

    def set_flood_topo_child(
        self, area: str, root_id: str, child_id: str, is_set: bool
    ) -> None:
        """Register/unregister the sender as an SPT child of this store
        for the given flood root (reference: KvStoreService
        updateFloodTopologyChild / FloodTopoSetParams)."""
        raise NotImplementedError


class InProcessTransport(PeerTransport):
    """Directly call into another KvStore in the same process (used by
    tests and single-process multi-node simulations; the analogue of the
    reference's KvStoreWrapper-linked stores)."""

    def __init__(self, target: "KvStore"):
        self._target = target

    def get_key_vals_filtered(
        self, area: str, params: KeyDumpParams
    ) -> Publication:
        return self._target.dump_with_filters(area, params)

    def set_key_vals(self, area: str, params: KeySetParams) -> None:
        self._target.set_key_vals(area, params, sender_id=params.originator_id)

    def send_dual_messages(self, area: str, sender_id: str, msgs) -> None:
        self._target.process_dual_messages(area, sender_id, msgs)

    def set_flood_topo_child(
        self, area: str, root_id: str, child_id: str, is_set: bool
    ) -> None:
        self._target.set_flood_topo_child(area, root_id, child_id, is_set)


@dataclass
class _Peer:
    name: str
    transport: PeerTransport
    state: KvStorePeerState = KvStorePeerState.IDLE
    backoff: ExponentialBackoff = field(
        default_factory=lambda: ExponentialBackoff(0.05, 5.0)
    )
    # floods that arrived while this peer was mid-full-sync; flushed when
    # it reaches INITIALIZED (otherwise an update racing the full sync
    # would be lost until the next anti-entropy pass)
    pending_flood: Dict[str, Value] = field(default_factory=dict)
    # monotonic stamp of the in-flight full sync (event-log duration)
    sync_started: Optional[float] = None


class KvStoreDb:
    """One area's store. All mutation happens on the owning KvStore's
    event base thread."""

    def __init__(
        self,
        area: str,
        node_id: str,
        evb: OpenrEventBase,
        updates_queue: ReplicateQueue,
        executor: ThreadPoolExecutor,
        filters: Optional[KvStoreFilters] = None,
        enable_flood_optimization: bool = False,
        is_flood_root: bool = False,
        flood_rate: Optional[Tuple[float, int]] = None,
        log_sample_queue: Optional[ReplicateQueue] = None,
        merge_hook=None,
    ):
        self.area = area
        self.node_id = node_id
        self._evb = evb
        self._updates_queue = updates_queue
        self._executor = executor
        self._filters = filters
        self._log_sample_queue = log_sample_queue
        # crash-safe state plane: called with (area, accepted updates)
        # after every merge, on this evb (StatePlane.on_kvstore_merge)
        self._merge_hook = merge_hook
        self.key_vals: Dict[str, Value] = {}
        self.peers: Dict[str, _Peer] = {}
        # flood rate limiting: token bucket + coalescing buffer
        # (reference: KvStore.cpp:1129 floodLimiter_ BasicTokenBucket +
        # bufferPublication/floodBufferedUpdates)
        self._flood_rate = flood_rate
        self._flood_tokens = float(flood_rate[1]) if flood_rate else 0.0
        self._flood_refill_t = time.monotonic()
        self._flood_buffer: Set[str] = set()
        self._flood_timer = None
        # DUAL-computed SPT flood topology (reference: KvStoreDb inherits
        # DualNode; flood-optimization flag KvStore.cpp:2940-2973). Off by
        # default, matching the reference.
        self.dual = None
        if enable_flood_optimization:
            from openr_tpu_torch.dual.dual import DualNode

            self.dual = DualNode(
                node_id,
                is_root=is_flood_root,
                nexthop_change_cb=self._on_dual_nexthop_change,
            )
        # (expiry_monotonic, key, version, originator, ttl_version)
        self._ttl_heap: List[Tuple[float, str, int, str, int]] = []
        self._ttl_timer = None
        self.counters: Dict[str, int] = {
            "kvstore.received_key_vals": 0,
            "kvstore.updated_key_vals": 0,
            "kvstore.expired_keys": 0,
            "kvstore.full_sync_count": 0,
            "kvstore.flood_count": 0,
            "kvstore.spt_floods": 0,
            "kvstore.rate_limit_suppress": 0,
            "kvstore.full_sync_failures": 0,
            "kvstore.flood_errors": 0,
            "kvstore.journal_errors": 0,
        }

    def _log_sample(self, **fields) -> None:
        """reference: KvStore.cpp:3104 logSyncEvent / :3118 logKvEvent."""
        push_log_sample(
            self._log_sample_queue,
            node_name=self.node_id,
            area=self.area,
            **fields,
        )

    # -- merge + flood ----------------------------------------------------

    def set_key_vals(
        self, params: KeySetParams, sender_id: Optional[str] = None
    ) -> None:
        self.counters["kvstore.received_key_vals"] += len(params.key_vals)
        updates = merge_key_values(self.key_vals, params.key_vals, self._filters)
        self.counters["kvstore.updated_key_vals"] += len(updates)
        if not updates:
            return
        self._track_ttls(updates)
        if self._merge_hook is not None:
            # write-ahead: the journal lands before the publication so a
            # crash mid-publish replays at least what Decision consumed
            try:
                self._merge_hook(self.area, updates)
            except Exception as exc:  # noqa: BLE001 - journal must not kill the merge path
                self.counters["kvstore.journal_errors"] += 1
                get_registry().counter_bump("state.journal_errors")
                _LOG.error(
                    "kvstore[%s] state-plane journal append failed: %s",
                    self.area, exc,
                )
        # telemetry: every accepted merge births one trace; Decision
        # adopts the oldest trace in a debounce window, Fib retires it
        trace = get_tracer().start(
            "kvstore.publish",
            node=self.node_id,
            area=self.area,
            keys=sorted(updates)[:8],
            n_keys=len(updates),
        )
        self._publish(
            Publication(
                key_vals=dict(updates), area=self.area, trace=trace
            )
        )
        self._flood(updates, exclude=sender_id)

    def _publish(self, pub: Publication) -> None:
        self._updates_queue.push(pub)

    # -- flood rate limiting ---------------------------------------------

    def _flood_consume(self) -> bool:
        """Take one token from the flood bucket (refilled at
        flood_msg_per_sec up to the burst size)."""
        rate, burst = self._flood_rate
        now = time.monotonic()
        self._flood_tokens = min(
            float(burst),
            self._flood_tokens + (now - self._flood_refill_t) * rate,
        )
        self._flood_refill_t = now
        if self._flood_tokens >= 1.0:
            self._flood_tokens -= 1.0
            return True
        return False

    def _schedule_buffered_flood(self) -> None:
        if self._flood_timer is not None:
            return
        # reference: Constants.h:189 kFloodPendingPublication = 100ms
        self._flood_timer = self._evb.schedule_timeout(
            0.1, self._flood_buffered
        )

    def _flood_buffered(self) -> None:
        """Re-flood the coalesced buffer with the CURRENT stored values
        (reference: floodBufferedUpdates — keys are merged, so a burst of
        N updates to one key floods once)."""
        self._flood_timer = None
        if not self._flood_buffer:
            return
        if not self._flood_consume():
            self._schedule_buffered_flood()
            return
        updates = {
            key: self.key_vals[key]
            for key in self._flood_buffer
            if key in self.key_vals
        }
        self._flood_buffer.clear()
        if updates:
            self._flood_now(updates, exclude=None)

    def _flood(self, updates: Dict[str, Value], exclude: Optional[str]) -> None:
        if self._flood_rate is not None:
            if not self._flood_consume():
                # suppressed: coalesce into the buffer, retry on a timer
                self.counters["kvstore.rate_limit_suppress"] += 1
                self._flood_buffer.update(updates)
                self._schedule_buffered_flood()
                return
            if self._flood_buffer:
                # token in hand and older keys pending: merge and flood
                # the whole buffer at once so ordering is preserved
                # (reference: floodPublication's buffer-merge path)
                self._flood_buffer.update(updates)
                updates = {
                    key: self.key_vals[key]
                    for key in self._flood_buffer
                    if key in self.key_vals
                }
                self._flood_buffer.clear()
                if self._flood_timer is not None:
                    self._flood_timer.cancel()
                    self._flood_timer = None
                exclude = None  # forwarded batch: no single sender
                if not updates:
                    return
        self._flood_now(updates, exclude)

    def _flood_now(
        self, updates: Dict[str, Value], exclude: Optional[str]
    ) -> None:
        """Flood accepted updates to every INITIALIZED peer except the one
        we learned them from. With flood optimization on and a converged
        SPT, only the SPT links (parent + children of the elected flood
        root) carry the flood (reference: KvStore.cpp:2957 floodPeers =
        getFloodPeers(rootId))."""
        flooded = self._decrement_ttls(updates)
        if not flooded:
            return
        spt_targets = None
        if self.dual is not None:
            root = self.dual.pick_flood_root()
            if root is not None:
                spt = self.dual.spt_peers(root)
                if spt:
                    spt_targets = spt
                    self.counters["kvstore.spt_floods"] += 1
        for peer in list(self.peers.values()):
            if peer.name == exclude:
                continue
            if peer.state == KvStorePeerState.SYNCING:
                # a syncing peer accumulates floods regardless of SPT:
                # its full sync raced this update and would miss it
                peer.pending_flood.update(flooded)
                continue
            if peer.state != KvStorePeerState.INITIALIZED:
                continue
            if spt_targets is not None and peer.name not in spt_targets:
                continue
            self.counters["kvstore.flood_count"] += 1
            params = KeySetParams(
                key_vals=dict(flooded),
                originator_id=self.node_id,
                solicit_response=False,
            )

            def flood_one(t=peer.transport, p=params) -> None:
                fault_point(FAULT_KV_FLOOD)
                t.set_key_vals(self.area, p)

            self._async_peer_call(peer, flood_one)

    def _decrement_ttls(self, updates: Dict[str, Value]) -> Dict[str, Value]:
        out: Dict[str, Value] = {}
        for key, value in updates.items():
            if value.ttl == TTL_INFINITY:
                out[key] = value
                continue
            remaining = value.ttl - TTL_DECREMENT_MS
            if remaining <= 0:
                continue
            out[key] = Value(
                version=value.version,
                originator_id=value.originator_id,
                value=value.value,
                ttl=remaining,
                ttl_version=value.ttl_version,
                hash=value.hash,
            )
        return out

    # -- TTL countdown ----------------------------------------------------

    def _track_ttls(self, updates: Dict[str, Value]) -> None:
        now = time.monotonic()
        for key, value in updates.items():
            stored = self.key_vals.get(key)
            if stored is None or stored.ttl == TTL_INFINITY:
                continue
            heapq.heappush(
                self._ttl_heap,
                (
                    now + stored.ttl / 1000.0,
                    key,
                    stored.version,
                    stored.originator_id,
                    stored.ttl_version,
                ),
            )
        self._schedule_ttl_cleanup()

    def _schedule_ttl_cleanup(self) -> None:
        if not self._ttl_heap:
            return
        if self._ttl_timer is not None:
            self._ttl_timer.cancel()
        delay = max(0.0, self._ttl_heap[0][0] - time.monotonic())
        self._ttl_timer = self._evb.schedule_timeout(delay, self._cleanup_ttls)

    def _cleanup_ttls(self) -> None:
        """Expire keys whose countdown entry still matches the stored value
        (reference: KvStore.cpp:2611 cleanupTtlCountdownQueue)."""
        self._ttl_timer = None
        now = time.monotonic()
        expired: List[str] = []
        while self._ttl_heap and self._ttl_heap[0][0] <= now:
            _, key, version, originator, ttl_version = heapq.heappop(
                self._ttl_heap
            )
            stored = self.key_vals.get(key)
            if (
                stored is not None
                and stored.version == version
                and stored.originator_id == originator
                and stored.ttl_version == ttl_version
                and stored.ttl != TTL_INFINITY
            ):
                del self.key_vals[key]
                expired.append(key)
        if expired:
            self.counters["kvstore.expired_keys"] += len(expired)
            for key in expired:
                self._log_sample(event="KEY_EXPIRE", key=key)
            self._publish(Publication(expired_keys=expired, area=self.area))
        self._schedule_ttl_cleanup()

    # -- dumps ------------------------------------------------------------

    def dump_with_filters(self, params: KeyDumpParams) -> Publication:
        """Full dump, or hash-differential dump when key_val_hashes given
        (the responder side of the 3-way sync)."""
        filters = KvStoreFilters(
            key_prefixes=[params.prefix] if params.prefix else [],
            originator_ids=set(params.originator_ids),
        )
        matching = {
            k: v for k, v in self.key_vals.items() if filters.key_match(k, v)
        }
        if params.keys:
            matching = {k: v for k, v in matching.items() if k in params.keys}
        if params.key_val_hashes is not None:
            return self._dump_difference(matching, params.key_val_hashes)
        return Publication(
            key_vals=self._update_publication_ttl(matching), area=self.area
        )

    def dump_hashes(self, prefix: str = "") -> Publication:
        """Hash-only dump (reference: KvStore.cpp:1327 dumpHashWithFilters)."""
        out: Dict[str, Value] = {}
        for key, v in self.key_vals.items():
            if prefix and not key.startswith(prefix):
                continue
            out[key] = Value(
                version=v.version,
                originator_id=v.originator_id,
                value=None,
                ttl=v.ttl,
                ttl_version=v.ttl_version,
                hash=v.hash,
            )
        return Publication(key_vals=out, area=self.area)

    def _dump_difference(
        self,
        my_key_vals: Dict[str, Value],
        req_key_vals: Dict[str, Value],
    ) -> Publication:
        """reference: KvStore.cpp:1351 dumpDifference — keyVals: keys where
        we are better/only; tobe_updated_keys: keys where requester is
        better/only (so the requester can push them back)."""
        key_vals: Dict[str, Value] = {}
        tobe_updated: List[str] = []
        for key in set(my_key_vals) | set(req_key_vals):
            mine = my_key_vals.get(key)
            req = req_key_vals.get(key)
            if mine is None:
                tobe_updated.append(key)
                continue
            if req is None:
                key_vals[key] = mine
                continue
            rc = compare_values(mine, req)
            if rc in (1, -2):
                key_vals[key] = mine
            if rc in (-1, -2):
                tobe_updated.append(key)
        return Publication(
            key_vals=self._update_publication_ttl(key_vals),
            tobe_updated_keys=sorted(tobe_updated),
            area=self.area,
        )

    def _update_publication_ttl(
        self, key_vals: Dict[str, Value]
    ) -> Dict[str, Value]:
        """Rewrite TTLs to remaining time; drop keys about to expire.
        reference: KvStore.cpp updatePublicationTtl."""
        now = time.monotonic()
        expiry: Dict[str, float] = {}
        for exp, key, version, orig, ttlv in self._ttl_heap:
            stored = self.key_vals.get(key)
            if (
                stored is not None
                and stored.version == version
                and stored.originator_id == orig
                and stored.ttl_version == ttlv
            ):
                expiry[key] = exp
        out: Dict[str, Value] = {}
        for key, v in key_vals.items():
            if v.ttl == TTL_INFINITY:
                out[key] = v
                continue
            exp = expiry.get(key)
            remaining = (
                v.ttl - TTL_DECREMENT_MS
                if exp is None
                else int((exp - now) * 1000) - TTL_DECREMENT_MS
            )
            if remaining <= 0:
                continue
            out[key] = Value(
                version=v.version,
                originator_id=v.originator_id,
                value=v.value,
                ttl=remaining,
                ttl_version=v.ttl_version,
                hash=v.hash,
            )
        return out

    # -- peers + full sync ------------------------------------------------

    def add_peer(self, name: str, transport: PeerTransport) -> None:
        peer = self.peers.get(name)
        if peer is None:
            self.peers[name] = _Peer(name=name, transport=transport)
        else:
            if (
                self.dual is not None
                and peer.state == KvStorePeerState.INITIALIZED
            ):
                # re-peering demotes to IDLE: balance the earlier peer_up
                self._send_dual(self.dual.peer_down(name))
            peer.transport = transport
            peer.state = KvStorePeerState.IDLE
        self._request_sync()

    def del_peer(self, name: str) -> None:
        peer = self.peers.pop(name, None)
        if (
            self.dual is not None
            and peer is not None
            and peer.state == KvStorePeerState.INITIALIZED
        ):
            self._send_dual(self.dual.peer_down(name))

    def peer_states(self) -> Dict[str, KvStorePeerState]:
        return {name: p.state for name, p in self.peers.items()}

    def peer_endpoints(self) -> Dict[str, Optional[Tuple[str, int]]]:
        return {
            name: p.transport.endpoint for name, p in self.peers.items()
        }

    def _request_sync(self) -> None:
        """Promote IDLE peers to SYNCING and kick the 3-way full sync
        (reference: KvStore.cpp:1400 requestThriftPeerSync)."""
        for peer in list(self.peers.values()):
            if peer.state != KvStorePeerState.IDLE:
                continue
            if not peer.backoff.can_try_now():
                self._evb.schedule_timeout(
                    peer.backoff.get_time_remaining_until_retry(),
                    self._request_sync,
                )
                continue
            peer.state = KvStorePeerState.SYNCING
            peer.sync_started = time.monotonic()
            self.counters["kvstore.full_sync_count"] += 1
            hashes = self.dump_hashes().key_vals
            params = KeyDumpParams(key_val_hashes=hashes)

            def do_sync(peer=peer, params=params) -> None:
                try:
                    fault_point(FAULT_KV_FULL_SYNC)
                    pub = peer.transport.get_key_vals_filtered(self.area, params)
                except Exception:
                    self._evb.run_in_event_base(
                        lambda: self._sync_failed(peer.name)
                    )
                    return
                self._evb.run_in_event_base(
                    lambda: self._sync_succeeded(peer.name, pub)
                )

            self._executor.submit(do_sync)

    def _sync_failed(self, peer_name: str) -> None:
        self.counters["kvstore.full_sync_failures"] += 1
        get_registry().counter_bump("kvstore.full_sync_failures")
        peer = self.peers.get(peer_name)
        if peer is None:
            return
        peer.state = KvStorePeerState.IDLE
        peer.backoff.report_error()
        self._evb.schedule_timeout(
            peer.backoff.get_time_remaining_until_retry(), self._request_sync
        )

    def _sync_succeeded(self, peer_name: str, pub: Publication) -> None:
        """reference: KvStore.cpp:1554 processThriftSuccess."""
        peer = self.peers.get(peer_name)
        if peer is None:
            return
        peer.state = KvStorePeerState.INITIALIZED
        peer.backoff.report_success()
        if peer.sync_started is not None:
            self._log_sample(
                event="KVSTORE_FULL_SYNC",
                neighbor=peer_name,
                duration_ms=int(
                    (time.monotonic() - peer.sync_started) * 1000
                ),
            )
            peer.sync_started = None
        if self.dual is not None:
            # (re-)announce the link to DUAL; a bounced peer is handled
            # as down-then-up inside Dual.peer_up
            self._send_dual(self.dual.peer_up(peer.name, cost=1))
        # merge what the peer had better; reflood to *other* peers
        self.set_key_vals(
            KeySetParams(key_vals=pub.key_vals, originator_id=peer_name),
            sender_id=peer_name,
        )
        # 3rd leg: push back the keys we are better at
        if pub.tobe_updated_keys:
            self._finalize_full_sync(peer, pub.tobe_updated_keys)
        # flush floods that raced the full sync
        if peer.pending_flood:
            pending, peer.pending_flood = peer.pending_flood, {}
            params = KeySetParams(
                key_vals=pending,
                originator_id=self.node_id,
                solicit_response=False,
            )
            self._async_peer_call(
                peer,
                lambda t=peer.transport: t.set_key_vals(self.area, params),
            )

    def _finalize_full_sync(self, peer: _Peer, keys: List[str]) -> None:
        """reference: KvStore.cpp:2727 finalizeFullSync."""
        updates = {
            key: self.key_vals[key] for key in keys if key in self.key_vals
        }
        updates = self._update_publication_ttl(updates)
        if not updates:
            return
        params = KeySetParams(
            key_vals=updates,
            originator_id=self.node_id,
            solicit_response=False,
        )
        self._async_peer_call(
            peer, lambda t=peer.transport: t.set_key_vals(self.area, params)
        )

    def _on_dual_nexthop_change(
        self, root_id: str, old_nh: Optional[str], new_nh: Optional[str]
    ) -> None:
        """Our SPT parent for root_id changed: tell the old parent to
        drop us as a child and the new one to adopt us (reference:
        KvStoreDb::processNexthopChange sending FLOOD_TOPO_SET)."""
        for nh, is_set in ((old_nh, False), (new_nh, True)):
            if nh is None or nh == self.node_id:
                continue
            peer = self.peers.get(nh)
            if peer is None:
                continue
            self._async_peer_call(
                peer,
                lambda t=peer.transport, flag=is_set: t.set_flood_topo_child(
                    self.area, root_id, self.node_id, flag
                ),
            )

    def set_flood_topo_child(
        self, root_id: str, child_id: str, is_set: bool,
        all_roots: bool = False,
    ) -> None:
        """A peer (un)registered as our SPT child (reference:
        KvStoreDb::processFloodTopoSet; ``all_roots`` applies the
        change to every root, FloodTopoSetParams.allRoots)."""
        if self.dual is None:
            return
        if all_roots:
            for rid in list(self.dual.duals):
                self.set_flood_topo_child(rid, child_id, is_set)
            return
        dual = self.dual.get_dual(root_id)
        if dual is None:
            return
        if is_set:
            dual.add_child(child_id)
        else:
            dual.remove_child(child_id)

    def process_dual_messages(self, sender: str, msgs) -> None:
        """Incoming DUAL messages from a peer (reference:
        processKvStoreDualMessage); replies/propagation go back out over
        the peer transports."""
        if self.dual is None:
            return
        for msg in msgs:
            self._send_dual(self.dual.process_message(sender, msg))

    def _send_dual(self, out_msgs) -> None:
        for nbr, mlist in out_msgs.items():
            peer = self.peers.get(nbr)
            if peer is None or not mlist:
                continue
            self._async_peer_call(
                peer,
                lambda t=peer.transport, m=list(mlist): t.send_dual_messages(
                    self.area, self.node_id, m
                ),
            )

    def _async_peer_call(self, peer: _Peer, call: Callable[[], None]) -> None:
        def run() -> None:
            try:
                call()
            except Exception:
                self._evb.run_in_event_base(lambda: self._peer_io_failed(peer.name))

        self._executor.submit(run)

    def _peer_io_failed(self, peer_name: str) -> None:
        self.counters["kvstore.flood_errors"] += 1
        get_registry().counter_bump("kvstore.flood_errors")
        peer = self.peers.get(peer_name)
        if peer is None:
            return
        if (
            self.dual is not None
            and peer.state == KvStorePeerState.INITIALIZED
        ):
            self._send_dual(self.dual.peer_down(peer_name))
        peer.state = KvStorePeerState.IDLE
        peer.backoff.report_error()
        self._evb.schedule_timeout(
            peer.backoff.get_time_remaining_until_retry(), self._request_sync
        )


class KvStore:
    """The KvStore module: one event base, one KvStoreDb per area.
    Public APIs are thread-safe (marshalled onto the module thread, the
    analogue of the reference's folly::SemiFuture APIs)."""

    def __init__(
        self,
        node_id: str,
        areas: Optional[List[str]] = None,
        updates_queue: Optional[ReplicateQueue] = None,
        filters: Optional[KvStoreFilters] = None,
        sync_interval_s: float = 60.0,
        enable_flood_optimization: bool = False,
        is_flood_root: bool = False,
        flood_rate: Optional[Tuple[float, int]] = None,
        log_sample_queue: Optional[ReplicateQueue] = None,
        state_plane=None,
    ):
        self.node_id = node_id
        self.evb = OpenrEventBase(name=f"kvstore:{node_id}")
        self.updates_queue = updates_queue or ReplicateQueue(
            name=f"kvstoreUpdates:{node_id}"
        )
        self._executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"kvstore-io:{node_id}"
        )
        self._dbs: Dict[str, KvStoreDb] = {}
        for area in areas or [DEFAULT_AREA]:
            self._dbs[area] = KvStoreDb(
                area,
                node_id,
                self.evb,
                self.updates_queue,
                self._executor,
                filters,
                enable_flood_optimization=enable_flood_optimization,
                is_flood_root=is_flood_root,
                flood_rate=flood_rate,
                log_sample_queue=log_sample_queue,
                merge_hook=(
                    state_plane.on_kvstore_merge
                    if state_plane is not None
                    else None
                ),
            )
        self._sync_interval = sync_interval_s
        self._sync_timer = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.evb.run_in_thread()
        self._sync_timer = self.evb.schedule_periodic(
            self._sync_interval, self._periodic_sync, jitter_first=True
        )

    def stop(self) -> None:
        if self._sync_timer is not None:
            self._sync_timer.cancel()
        self.evb.stop()
        self.evb.join()
        self._executor.shutdown(wait=False)

    def _periodic_sync(self) -> None:
        """Anti-entropy: retry IDLE peers (reference: KvStore.cpp:1942
        requestFullSyncFromPeers / periodic random resync)."""
        for db in self._dbs.values():
            db._request_sync()

    # -- area access ------------------------------------------------------

    def _db(self, area: str) -> KvStoreDb:
        if area not in self._dbs:
            raise KeyError(f"unknown area {area!r}")
        return self._dbs[area]

    def areas(self) -> List[str]:
        return sorted(self._dbs)

    # -- public API (thread-safe) -----------------------------------------

    def set_key_vals(
        self, area: str, params: KeySetParams, sender_id: Optional[str] = None
    ) -> None:
        self.evb.call_and_wait(
            lambda: self._db(area).set_key_vals(params, sender_id)
        )

    def get_key_vals(self, area: str, keys: List[str]) -> Dict[str, Value]:
        return self.evb.call_and_wait(
            lambda: {
                k: self._db(area).key_vals[k]
                for k in keys
                if k in self._db(area).key_vals
            }
        )

    def dump_with_filters(
        self, area: str, params: Optional[KeyDumpParams] = None
    ) -> Publication:
        params = params or KeyDumpParams()
        return self.evb.call_and_wait(
            lambda: self._db(area).dump_with_filters(params)
        )

    def dump_hashes(self, area: str, prefix: str = "") -> Publication:
        return self.evb.call_and_wait(lambda: self._db(area).dump_hashes(prefix))

    def add_peer(self, area: str, name: str, transport: PeerTransport) -> None:
        self.evb.call_and_wait(lambda: self._db(area).add_peer(name, transport))

    def del_peer(self, area: str, name: str) -> None:
        self.evb.call_and_wait(lambda: self._db(area).del_peer(name))

    def peer_states(self, area: str) -> Dict[str, KvStorePeerState]:
        return self.evb.call_and_wait(lambda: self._db(area).peer_states())

    def peer_endpoints(
        self, area: str
    ) -> Dict[str, Optional[Tuple[str, int]]]:
        return self.evb.call_and_wait(
            lambda: self._db(area).peer_endpoints()
        )

    def spt_infos(self, area: str) -> Dict:
        """Flood-topology snapshot for the ctrl getSpanningTreeInfos
        RPC (reference: KvStore.thrift SptInfos + KvStore.cpp
        processFloodTopoGet): per-root passive/cost/parent/children,
        the elected flood root, and the flooding peer set. Empty when
        flood optimization is off."""

        def snap() -> Dict:
            db = self._db(area)
            if db.dual is None:
                return {"infos": {}, "flood_root_id": None,
                        "flood_peers": set()}
            from openr_tpu_torch.dual.dual import DualState

            infos = {}
            for root, dual in db.dual.duals.items():
                infos[root] = {
                    "passive": dual.sm.state == DualState.PASSIVE,
                    "cost": int(dual.distance),
                    "parent": dual.nexthop,
                    "children": dual.children(),
                }
            root = db.dual.pick_flood_root()
            return {
                "infos": infos,
                "flood_root_id": root,
                "flood_peers": (
                    db.dual.spt_peers(root) if root is not None else set()
                ),
            }

        return self.evb.call_and_wait(snap)

    def process_dual_messages(self, area: str, sender: str, msgs) -> None:
        self.evb.call_and_wait(
            lambda: self._db(area).process_dual_messages(sender, msgs)
        )

    def set_flood_topo_child(
        self, area: str, root_id: str, child_id: str, is_set: bool,
        all_roots: bool = False,
    ) -> None:
        self.evb.call_and_wait(
            lambda: self._db(area).set_flood_topo_child(
                root_id, child_id, is_set, all_roots=all_roots
            )
        )

    def counters(self) -> Dict[str, int]:
        def collect():
            out: Dict[str, int] = {}
            for db in self._dbs.values():
                for k, v in db.counters.items():
                    out[k] = out.get(k, 0) + v
                out[f"kvstore.num_keys.{db.area}"] = len(db.key_vals)
            return out

        return self.evb.call_and_wait(collect)
