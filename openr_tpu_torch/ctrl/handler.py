"""OpenrCtrlHandler: the unified control/introspection API.

Behavioral parity with the reference ``openr/ctrl-server/OpenrCtrlHandler``
(the ~70-RPC ``OpenrCtrl`` thrift service, openr/if/OpenrCtrl.thrift:168):
per-module getters/setters routed to the modules' thread-safe APIs, plus
server-streaming subscriptions for KvStore publications and Fib deltas
(reference: OpenrCtrlHandler.h:226-247) and KvStore adjacency long-poll
(:250).

This object is transport-neutral: used directly in-process, and exposed
over TCP by the reference's ``ctrl/server.py`` (the thrift-server
analogue) for the ``breeze`` CLI.

Port note: a copy of ``openr_tpu/ctrl/handler.py``; nothing left out. The
port has no TCP ctrl server yet, so the handler is used in-process.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from openr_tpu_torch.analysis.annotations import runs_on
from openr_tpu_torch.messaging.queue import RQueue
from openr_tpu_torch.types import (
    TTL_INFINITY,
    IpPrefix,
    KeyDumpParams,
    KeySetParams,
    Value,
)
from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm, PrefixForwardingType
from openr_tpu_torch.types import PrefixEntry, PrefixType
from openr_tpu_torch.utils import keys as keyutil


class _FilteredPublicationReader:
    """Reader adapter dropping publications outside the subscription's
    area / key-prefix and trimming the surviving ones to matching keys
    (the reference KvStorePublisher's per-subscriber filter,
    openr/kvstore/KvStorePublisher.h)."""

    def __init__(self, reader, prefix: str, area: str):
        self._reader = reader
        self._prefix = prefix
        self._area = area

    def get(self, timeout: Optional[float] = None):
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            remaining = (
                None if deadline is None else deadline - _time.monotonic()
            )
            pub = self._reader.get(timeout=remaining)
            if pub.area != self._area:
                continue
            if not self._prefix:
                return pub
            key_vals = {
                k: v
                for k, v in pub.key_vals.items()
                if k.startswith(self._prefix)
            }
            expired = [
                k for k in pub.expired_keys if k.startswith(self._prefix)
            ]
            if not key_vals and not expired:
                continue
            return type(pub)(
                key_vals=key_vals,
                expired_keys=expired,
                area=pub.area,
            )

    def close(self) -> None:
        close = getattr(self._reader, "close", None)
        if close is not None:
            close()


@runs_on("ctrl")
class OpenrCtrlHandler:
    def __init__(
        self,
        node_name: str,
        kvstore=None,
        decision=None,
        fib=None,
        link_monitor=None,
        prefix_manager=None,
        spark=None,
        monitor=None,
        config=None,
    ):
        self.node_name = node_name
        self._kvstore = kvstore
        self._decision = decision
        self._fib = fib
        self._link_monitor = link_monitor
        self._prefix_manager = prefix_manager
        self._spark = spark
        self._monitor = monitor
        self._config = config
        self._config_store = None  # wired by the daemon when present
        self._start_time = int(time.time())

    # -- fb303-style base -------------------------------------------------

    def alive_since(self) -> int:
        return self._start_time

    def get_my_node_name(self) -> str:
        """reference: OpenrCtrl.thrift getMyNodeName."""
        return self.node_name

    def dryrun_config(self, config_json: str) -> Dict[str, Any]:
        """Validate a config document server-side (reference:
        OpenrCtrl.thrift dryrunConfig)."""
        import json as _json

        from openr_tpu_torch.config.config import ConfigError, OpenrConfig

        try:
            cfg = OpenrConfig.from_dict(_json.loads(config_json))
            return {"valid": True, "node_name": cfg.node_name}
        except (ConfigError, ValueError, KeyError, TypeError) as exc:
            return {"valid": False, "error": str(exc)}

    # -- config store (reference: getConfigKey / setConfigKey /
    # eraseConfigKey over PersistentStore) --------------------------------

    def get_config_key(self, key: str) -> Any:
        if self._config_store is None:
            return None
        return self._config_store.load(key)

    def set_config_key(self, key: str, value: Any) -> None:
        if self._config_store is None:
            raise RuntimeError("no persistent store configured")
        self._config_store.store(key, value)

    def erase_config_key(self, key: str) -> bool:
        if self._config_store is None:
            return False
        return self._config_store.erase(key)

    def get_counters(self) -> Dict[str, Any]:
        # start from the process-wide telemetry registry snapshot (the
        # store of record for SPF/ELL counters, latency histograms,
        # trace health, and jax compile metrics), then fold in the
        # module-local counter dicts — same order Monitor.get_counters
        # uses, so `breeze monitor counters` and this API agree
        from openr_tpu_torch.telemetry import get_registry

        out: Dict[str, Any] = dict(get_registry().snapshot())
        for module in (
            self._kvstore,
            self._decision,
            self._fib,
            self._link_monitor,
            self._spark,
            self._monitor,
        ):
            if module is None:
                continue
            getter = getattr(module, "get_counters", None) or getattr(
                module, "counters", None
            )
            try:
                counters = getter() if callable(getter) else getter
                if counters:
                    out.update(counters)
            except Exception:
                continue
        return out

    def get_running_config(self) -> Dict[str, Any]:
        if self._config is None:
            return {"node_name": self.node_name}
        return self._config.to_dict()

    # -- KvStore ----------------------------------------------------------

    def get_kvstore_key_vals(
        self, keys: List[str], area: str = "0"
    ) -> Dict[str, Value]:
        return self._kvstore.get_key_vals(area, keys)

    def set_kvstore_key_vals(
        self, key_vals: Dict[str, Value], area: str = "0"
    ) -> None:
        self._kvstore.set_key_vals(
            area,
            KeySetParams(key_vals=key_vals, originator_id=self.node_name),
        )

    def set_kvstore_key(
        self,
        key: str,
        value: str,
        version: int = 0,
        area: str = "0",
        ttl: Optional[int] = None,
    ) -> int:
        """Operator-facing single-key set (breeze kvstore set-key):
        version 0 auto-advances past the stored version. Returns the
        version written."""
        if version == 0:
            cur = self._kvstore.get_key_vals(area, [key]).get(key)
            version = (cur.version + 1) if cur is not None else 1
        self._kvstore.set_key_vals(
            area,
            KeySetParams(
                key_vals={
                    key: Value(
                        version=version,
                        originator_id=self.node_name,
                        value=value.encode("utf-8"),
                        ttl=TTL_INFINITY if ttl is None else ttl,
                    )
                },
                originator_id=self.node_name,
            ),
        )
        return version

    def erase_kvstore_key(self, key: str, area: str = "0") -> bool:
        """Expire a key network-wide by re-advertising it with a bumped
        ttl_version and a near-zero TTL (the reference's breeze kvstore
        erase-key mechanism — TTL countdown then removes it everywhere)."""
        cur = self._kvstore.get_key_vals(area, [key]).get(key)
        if cur is None:
            return False
        self._kvstore.set_key_vals(
            area,
            KeySetParams(
                key_vals={
                    key: Value(
                        version=cur.version,
                        originator_id=cur.originator_id,
                        value=cur.value,
                        ttl=100,  # ms: floods, then dies everywhere
                        ttl_version=cur.ttl_version + 1,
                    )
                },
                originator_id=self.node_name,
            ),
        )
        return True

    def get_kvstore_keys_filtered(
        self, prefix: str = "", area: str = "0"
    ) -> Dict[str, Value]:
        return self._kvstore.dump_with_filters(
            area, KeyDumpParams(prefix=prefix)
        ).key_vals

    def get_kvstore_hash_filtered(
        self, prefix: str = "", area: str = "0"
    ) -> Dict[str, Value]:
        return self._kvstore.dump_hashes(area, prefix).key_vals

    def get_kvstore_peers(self, area: str = "0") -> Dict[str, str]:
        return {
            name: state.name
            for name, state in self._kvstore.peer_states(area).items()
        }

    def get_kvstore_areas(self) -> List[str]:
        return self._kvstore.areas()

    def get_spanning_tree_infos(self, area: str = "0"):
        """reference: OpenrCtrl.thrift getSpanningTreeInfos — the
        flood-optimization SPT snapshot (per-root state + elected
        flood root + flooding peers); empty when DUAL is off."""
        return self._kvstore.spt_infos(area)

    def subscribe_kvstore_filtered(
        self, prefix: str = "", area: str = "0"
    ):
        """Server-streaming subscription (reference:
        OpenrCtrlHandler.h:226 subscribeAndGetKvStoreFiltered +
        KvStorePublisher's filtered fan-out). Returns a reader delivering
        only Publications touching the requested area/key-prefix;
        snapshot via get_kvstore_keys_filtered first."""
        reader = self._kvstore.updates_queue.get_reader(
            f"ctrl-sub:{self.node_name}"
        )
        if not prefix and area == "0" and self._kvstore.areas() == ["0"]:
            return reader
        return _FilteredPublicationReader(reader, prefix, area)

    def long_poll_kvstore_adj(
        self, area: str = "0", timeout_s: float = 10.0
    ) -> bool:
        """Block until any adj: key changes (reference:
        OpenrCtrlHandler.h:250 longPollKvStoreAdj). Returns True if a
        change was seen within the timeout."""
        reader = self._kvstore.updates_queue.get_reader("ctrl-longpoll")
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                pub = reader.get(timeout=remaining)
            except Exception:
                return False
            if pub.area != area:
                continue
            if any(keyutil.is_adj_key(k) for k in pub.key_vals) or any(
                keyutil.is_adj_key(k) for k in pub.expired_keys
            ):
                return True

    # -- Decision ---------------------------------------------------------

    def get_route_db_computed(self, node: Optional[str] = None):
        return self._decision.get_decision_route_db(node).to_route_db(
            node or self.node_name
        )

    def get_decision_adjacency_dbs(self):
        return self._decision.get_adj_dbs()

    def set_rib_policy(
        self, statements: List[Dict], ttl_secs: float = 300.0
    ) -> None:
        """reference: OpenrCtrl.thrift setRibPolicy."""
        from openr_tpu_torch.decision.rib_policy import (
            RibPolicy,
            RibPolicyStatement,
            RibRouteAction,
            RibRouteActionWeight,
        )

        parsed = [
            RibPolicyStatement(
                name=s.get("name", ""),
                prefixes=tuple(
                    IpPrefix.from_str(p) for p in s.get("prefixes", [])
                ),
                action=RibRouteAction(
                    set_weight=RibRouteActionWeight(
                        default_weight=s.get("default_weight", 0),
                        area_to_weight=s.get("area_to_weight", {}),
                        neighbor_to_weight=s.get("neighbor_to_weight", {}),
                    )
                ),
            )
            for s in statements
        ]
        self._decision.set_rib_policy(RibPolicy(parsed, ttl_secs=ttl_secs))

    def get_rib_policy(self):
        policy = self._decision.get_rib_policy()
        if policy is None:
            return None
        def action_dict(action):
            w = action.set_weight
            if w is None:
                return {}
            return {
                "set_weight": {
                    "default_weight": w.default_weight,
                    "area_to_weight": dict(w.area_to_weight),
                    "neighbor_to_weight": dict(w.neighbor_to_weight),
                }
            }

        return {
            "ttl_remaining_s": policy.get_ttl_remaining_s(),
            "statements": [
                {
                    "name": s.name,
                    "prefixes": [p.to_str() for p in s.prefixes],
                    "action": action_dict(s.action),
                }
                for s in policy.statements
            ],
        }

    def get_decision_prefix_dbs(self):
        return self._decision.evb.call_and_wait(
            lambda: dict(self._decision.prefix_state.prefixes())
        )

    # -- Fib --------------------------------------------------------------

    def get_route_db(self):
        return self._fib.get_route_db()

    def get_unicast_routes(self, prefixes: Optional[List[str]] = None):
        parsed = (
            [IpPrefix.from_str(p) for p in prefixes] if prefixes else None
        )
        return self._fib.get_unicast_routes(parsed)

    def longest_prefix_match(self, addr: str):
        return self._fib.longest_prefix_match(addr)

    def subscribe_fib(self) -> RQueue:
        """reference: OpenrCtrlHandler.h:240 subscribeAndGetFib."""
        return self._fib.fib_updates_queue.get_reader(
            f"ctrl-fib-sub:{self.node_name}"
        )

    def get_perf_db(self):
        """reference: if/OpenrCtrl.thrift:312 getPerfDb."""
        return self._fib.evb.call_and_wait(lambda: list(self._fib.perf_db))

    def get_traces(
        self, limit: int = 20, fmt: str = "dict"
    ) -> Any:
        """Completed publication->FIB telemetry traces from the
        process-wide ring (newest last). fmt: "dict" (list of trace
        dicts), "jsonl", or "chrome" (one traceEvents document)."""
        from openr_tpu_torch.telemetry import get_tracer

        tracer = get_tracer()
        if fmt == "chrome":
            return tracer.chrome_trace(limit)
        if fmt == "jsonl":
            return tracer.jsonl(limit)
        return [t.to_dict() for t in tracer.traces(limit)]

    def get_flight_record(self, limit: int = 0) -> Dict[str, Any]:
        """The flight recorder's recent-activity ring (newest last)
        plus the live device-time attribution — the first stop of the
        post-mortem triage recipe (docs/RUNBOOK.md)."""
        from openr_tpu_torch.telemetry import get_flight_recorder, get_profiler

        fr = get_flight_recorder()
        prof = get_profiler()
        return {
            "records": fr.records(limit),
            "triggers": fr.trigger_names(),
            "attribution": prof.attribution(),
            "host_overhead_ratio": prof.host_overhead_ratio(),
        }

    def dump_postmortem(self, trigger: str = "manual",
                        reason: str = "") -> Dict[str, Any]:
        """Force a post-mortem bundle to disk right now (counted
        ``flight.dumps.manual`` unless a trigger name is given)."""
        from openr_tpu_torch.telemetry import get_flight_recorder

        path = get_flight_recorder().dump_postmortem(
            trigger=trigger, reason=reason or "operator request"
        )
        return {"path": path}

    # -- LinkMonitor ------------------------------------------------------

    def get_interfaces(self):
        return self._link_monitor.get_interfaces()

    def get_link_monitor_adjacencies(self):
        return self._link_monitor.get_adjacencies()

    def set_node_overload(self, overloaded: bool) -> None:
        self._link_monitor.set_node_overload(overloaded)

    def set_link_overload(self, if_name: str, overloaded: bool) -> None:
        self._link_monitor.set_link_overload(if_name, overloaded)

    def set_link_metric(
        self, if_name: str, neighbor: str, metric: Optional[int]
    ) -> None:
        self._link_monitor.set_link_metric(if_name, neighbor, metric)

    # -- PrefixManager ----------------------------------------------------

    def set_interface_metric(self, if_name: str, metric: int) -> None:
        """reference: OpenrCtrl.thrift setInterfaceMetric."""
        self._link_monitor.set_interface_metric(if_name, metric)

    def unset_interface_metric(self, if_name: str) -> None:
        self._link_monitor.set_interface_metric(if_name, None)

    def get_prefixes(self):
        return self._prefix_manager.get_prefixes()

    def advertise_prefixes(
        self,
        prefixes: List[str],
        prefix_type: str = "BREEZE",
        forwarding_type: str = "IP",
        forwarding_algorithm: str = "SP_ECMP",
    ) -> None:
        entries = [
            PrefixEntry(
                prefix=IpPrefix.from_str(p),
                type=PrefixType[prefix_type],
                forwarding_type=PrefixForwardingType[forwarding_type],
                forwarding_algorithm=PrefixForwardingAlgorithm[
                    forwarding_algorithm
                ],
            )
            for p in prefixes
        ]
        self._prefix_manager.advertise_prefixes(entries)

    def withdraw_prefixes(self, prefixes: List[str]) -> None:
        self._prefix_manager.withdraw_prefixes(
            [IpPrefix.from_str(p) for p in prefixes]
        )

    def get_prefixes_by_type(self, prefix_type: str):
        """reference: OpenrCtrl.thrift getPrefixesByType."""
        want = PrefixType[prefix_type]
        return [
            e for e in self._prefix_manager.get_prefixes() if e.type == want
        ]

    def withdraw_prefixes_by_type(self, prefix_type: str) -> int:
        """reference: OpenrCtrl.thrift withdrawPrefixesByType."""
        victims = [e.prefix for e in self.get_prefixes_by_type(prefix_type)]
        if victims:
            self._prefix_manager.withdraw_prefixes(victims)
        return len(victims)

    def sync_prefixes_by_type(
        self,
        prefix_type: str,
        prefixes: List[str],
    ) -> None:
        """reference: OpenrCtrl.thrift syncPrefixesByType — the given set
        becomes the complete set for that type."""
        ptype = PrefixType[prefix_type]
        entries = [
            PrefixEntry(prefix=IpPrefix.from_str(p), type=ptype)
            for p in prefixes
        ]
        self._prefix_manager.sync_prefixes_by_type(ptype, entries)

    def get_advertised_routes(self, prefix: str = ""):
        """reference: OpenrCtrl.thrift getAdvertisedRoutes(Filtered)."""
        out = self._prefix_manager.get_prefixes()
        if prefix:
            want = IpPrefix.from_str(prefix)
            out = [e for e in out if e.prefix == want]
        return out

    def get_received_routes(self, prefix: str = ""):
        """reference: OpenrCtrl.thrift getReceivedRoutes(Filtered) — the
        per-prefix advertisements Decision has received, with their
        advertising (node, area)s."""
        dbs = self._decision.evb.call_and_wait(
            lambda: dict(self._decision.prefix_state.prefixes())
        )
        if prefix:
            want = IpPrefix.from_str(prefix)
            dbs = {p: entries for p, entries in dbs.items() if p == want}
        return dbs

    # -- Spark ------------------------------------------------------------

    def flood_restarting_msg(self) -> None:
        """reference: OpenrCtrl.thrift floodRestartingMsg — announce
        graceful restart on every interface without stopping."""
        self._spark.flood_restarting()

    def get_spark_neighbors(self):
        return {
            if_name: {n: state.name for n, state in neighbors.items()}
            for if_name, neighbors in self._spark.get_neighbors().items()
        }

    # -- Monitor ----------------------------------------------------------

    def get_event_logs(self, limit: int = 100):
        if self._monitor is None:
            return []
        return [s.to_json() for s in self._monitor.get_event_logs(limit)]
