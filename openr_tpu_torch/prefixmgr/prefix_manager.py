"""PrefixManager: owns the prefixes this node advertises into the LSDB.

Behavioral parity with the reference ``openr/prefix-manager/PrefixManager``:
- advertise/withdraw/sync per PrefixType (LOOPBACK, CONFIG, BGP, ...)
  (reference: PrefixManager.h:72 advertisePrefixes)
- serializes to per-prefix KvStore keys ``prefix:<node>:<area>:[<prefix>]``
  via the KvStore client (persist + TTL refresh)
- accepts requests through a queue (PrefixEvent) and via direct API
- cross-area re-distribution: subscribes to Decision's route updates and
  re-originates each best route into the areas it was *not* learned from,
  as a ``PrefixType.RIB`` entry with the source area appended to
  ``area_stack`` (loop prevention: never advertised into any area already
  on the stack). Reference: PrefixManager consuming
  decisionRouteUpdatesQueue + areaStack loop suppression
  (openr/prefix-manager/PrefixManager.cpp, SURVEY §2.1).

Port note: a copy of ``openr_tpu/prefixmgr/prefix_manager.py``; nothing
left out.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry, PrefixType
from openr_tpu_torch.types.lsdb import PrefixMetrics
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.constants import (
    DEFAULT_PATH_PREFERENCE,
    DEFAULT_SOURCE_PREFERENCE,
    KVSTORE_TOMBSTONE_TTL_MS,
)
from openr_tpu_torch.utils.eventbase import OpenrEventBase


class PrefixEventType(enum.IntEnum):
    ADD_PREFIXES = 1
    WITHDRAW_PREFIXES = 2
    SYNC_PREFIXES_BY_TYPE = 3
    WITHDRAW_PREFIXES_BY_TYPE = 4


@dataclass
class PrefixEvent:
    event_type: PrefixEventType
    type: Optional[PrefixType] = None
    prefixes: List[PrefixEntry] = field(default_factory=list)


class PrefixManager:
    def __init__(
        self,
        my_node_name: str,
        kvstore_client,
        prefix_updates_queue: Optional[ReplicateQueue] = None,
        decision_route_updates_queue: Optional[ReplicateQueue] = None,
        areas: Optional[List[str]] = None,
        per_prefix_keys: bool = True,
    ):
        self.my_node_name = my_node_name
        self.evb = OpenrEventBase(name=f"prefixmgr:{my_node_name}")
        self._client = kvstore_client
        self._areas = areas or ["0"]
        self._per_prefix_keys = per_prefix_keys
        # (type, prefix) -> entry
        self._prefixes: Dict[Tuple[PrefixType, IpPrefix], PrefixEntry] = {}
        # cross-area redistribution: prefix -> (entry, target areas)
        self._redistributed: Dict[
            IpPrefix, Tuple[PrefixEntry, Tuple[str, ...]]
        ] = {}
        self._advertised_keys: set = set()  # {(area, key)}
        if prefix_updates_queue is not None:
            self.evb.add_queue_reader(
                prefix_updates_queue.get_reader(f"pm:{my_node_name}"),
                self._on_event,
            )
        if decision_route_updates_queue is not None:
            self.evb.add_queue_reader(
                decision_route_updates_queue.get_reader(
                    f"pm-redist:{my_node_name}"
                ),
                self._on_route_update,
            )

    def start(self) -> None:
        self.evb.run_in_thread()

    def stop(self) -> None:
        self.evb.stop()
        self.evb.join()

    # -- queue interface --------------------------------------------------

    def _on_event(self, event: PrefixEvent) -> None:
        if event.event_type == PrefixEventType.ADD_PREFIXES:
            self._advertise(event.prefixes)
        elif event.event_type == PrefixEventType.WITHDRAW_PREFIXES:
            self._withdraw([e.prefix for e in event.prefixes])
        elif event.event_type == PrefixEventType.SYNC_PREFIXES_BY_TYPE:
            assert event.type is not None
            self._sync_by_type(event.type, event.prefixes)
        elif event.event_type == PrefixEventType.WITHDRAW_PREFIXES_BY_TYPE:
            assert event.type is not None
            self._withdraw(
                [
                    p
                    for (t, p) in list(self._prefixes)
                    if t == event.type
                ]
            )

    def _on_route_update(self, update) -> None:
        """Re-originate Decision's best routes into other areas
        (reference: PrefixManager's decisionRouteUpdatesQueue consumer)."""
        changed = False
        own_prefixes = {
            p for (t, p) in self._prefixes if t != PrefixType.RIB
        }
        for prefix, entry in getattr(
            update, "unicast_routes_to_update", {}
        ).items():
            best = entry.best_prefix_entry
            if best is None or prefix in own_prefixes:
                # a prefix we originate ourselves is never redistributed;
                # drop any redistribution recorded before it became ours
                changed |= self._redistributed.pop(prefix, None) is not None
                continue
            new_stack = tuple(best.area_stack)
            if entry.best_area and entry.best_area not in new_stack:
                new_stack = new_stack + (entry.best_area,)
            targets = tuple(a for a in self._areas if a not in new_stack)
            if not targets:
                changed |= self._redistributed.pop(prefix, None) is not None
                continue
            redist = PrefixEntry(
                prefix=prefix,
                type=PrefixType.RIB,
                forwarding_type=best.forwarding_type,
                forwarding_algorithm=best.forwarding_algorithm,
                min_nexthop=best.min_nexthop,
                # bump distance so the re-originated copy always loses
                # best-route selection to the original — without this,
                # two border routers' identical-metric copies can tie
                # with the source and oscillate advertise/withdraw
                metrics=replace(
                    best.metrics, distance=best.metrics.distance + 1
                ),
                tags=best.tags,
                area_stack=new_stack,
            )
            if self._redistributed.get(prefix) != (redist, targets):
                self._redistributed[prefix] = (redist, targets)
                changed = True
        for prefix in getattr(update, "unicast_routes_to_delete", []):
            changed |= self._redistributed.pop(prefix, None) is not None
        if changed:
            self._update_kvstore()

    # -- public API (thread-safe) -----------------------------------------

    def advertise_prefixes(self, entries: List[PrefixEntry]) -> None:
        self.evb.call_and_wait(lambda: self._advertise(entries))

    def withdraw_prefixes(self, prefixes: List[IpPrefix]) -> None:
        self.evb.call_and_wait(lambda: self._withdraw(prefixes))

    def sync_prefixes_by_type(
        self, prefix_type: PrefixType, entries: List[PrefixEntry]
    ) -> None:
        self.evb.call_and_wait(lambda: self._sync_by_type(prefix_type, entries))

    def get_prefixes(self) -> List[PrefixEntry]:
        return self.evb.call_and_wait(
            lambda: sorted(self._prefixes.values(), key=lambda e: e.prefix)
        )

    def get_redistributed(self) -> Dict[IpPrefix, Tuple[PrefixEntry, Tuple[str, ...]]]:
        """Cross-area re-originated routes (entry, target areas)."""
        return self.evb.call_and_wait(lambda: dict(self._redistributed))

    # -- internals --------------------------------------------------------

    def _record_own(self, entry: PrefixEntry) -> None:
        """Record one own advertisement (shared by advertise + sync)."""
        if entry.metrics == PrefixMetrics():
            # origination default (reference: buildOriginatedPrefixDb)
            entry = replace(
                entry,
                metrics=PrefixMetrics(
                    path_preference=DEFAULT_PATH_PREFERENCE,
                    source_preference=DEFAULT_SOURCE_PREFERENCE,
                ),
            )
        self._prefixes[(entry.type, entry.prefix)] = entry
        if entry.type != PrefixType.RIB:
            # an own advertisement supersedes any cross-area
            # redistribution of the same prefix
            self._redistributed.pop(entry.prefix, None)

    def _advertise(self, entries: List[PrefixEntry]) -> None:
        """reference: PrefixManager.cpp advertisePrefixesImpl."""
        for entry in entries:
            self._record_own(entry)
        self._update_kvstore()

    def _withdraw(self, prefixes: List[IpPrefix]) -> None:
        for key in [k for k in self._prefixes if k[1] in set(prefixes)]:
            del self._prefixes[key]
        self._update_kvstore()

    def _sync_by_type(
        self, prefix_type: PrefixType, entries: List[PrefixEntry]
    ) -> None:
        for key in [k for k in self._prefixes if k[0] == prefix_type]:
            del self._prefixes[key]
        for entry in entries:
            self._record_own(replace(entry, type=prefix_type))
        self._update_kvstore()

    def _best_own_entries(self) -> Dict[IpPrefix, PrefixEntry]:
        """One advertisement per prefix: the best-metrics entry among the
        types advertising it, deterministic tie-break by lowest type
        (reference: PrefixManager.cpp:346-348 syncKvStore picks
        selectBestPrefixMetrics across the per-type entries)."""
        best: Dict[IpPrefix, Tuple[tuple, PrefixEntry]] = {}
        for (ptype, prefix), entry in self._prefixes.items():
            rank = (entry.metrics.comparison_key(), -int(ptype))
            cur = best.get(prefix)
            if cur is None or rank > cur[0]:
                best[prefix] = (rank, entry)
        return {p: e for p, (_, e) in best.items()}

    def _update_kvstore(self) -> None:
        # (area, key) -> payload; keys repeat across areas in full-db mode
        wanted: Dict[Tuple[str, str], bytes] = {}
        own = self._best_own_entries()
        for area in self._areas:
            redist = {
                p: e
                for p, (e, targets) in self._redistributed.items()
                if area in targets and p not in own
            }
            if self._per_prefix_keys:
                for prefix, entry in {**own, **redist}.items():
                    key = keyutil.per_prefix_key(
                        self.my_node_name, area, prefix
                    )
                    db = PrefixDatabase(
                        this_node_name=self.my_node_name,
                        prefix_entries=(entry,),
                        area=area,
                    )
                    wanted[(area, key)] = wire.dumps(db)
            else:
                key = keyutil.prefix_db_key(self.my_node_name)
                db = PrefixDatabase(
                    this_node_name=self.my_node_name,
                    prefix_entries=tuple(
                        e
                        for _, e in sorted(
                            {**own, **redist}.items(),
                            key=lambda kv: kv[0],
                        )
                    ),
                    area=area,
                )
                wanted[(area, key)] = wire.dumps(db)

        # withdraw keys that are no longer advertised: flood the delete
        # marker so other Decisions drop the entries
        for area, key in list(self._advertised_keys):
            if (area, key) not in wanted:
                parsed = keyutil.parse_per_prefix_key(key)
                delete_db = PrefixDatabase(
                    this_node_name=self.my_node_name,
                    prefix_entries=(
                        (PrefixEntry(prefix=parsed[2]),) if parsed else ()
                    ),
                    delete_prefix=True,
                    area=area,
                )
                self._client.clear_key(
                    area,
                    key,
                    wire.dumps(delete_db),
                    ttl=KVSTORE_TOMBSTONE_TTL_MS,
                )
                self._advertised_keys.discard((area, key))

        for (area, key), payload in wanted.items():
            self._client.persist_key(area, key, payload)
            self._advertised_keys.add((area, key))
