"""Prefix advertisement state (the adjacency-RIB of flooded prefixes).

Port note: a copy of ``openr_tpu/decision/prefix_state.py`` without
the thread-confinement lint marker.

Behavioral parity with the reference ``openr/decision/PrefixState.{h,cpp}``:
``IpPrefix -> {(node, area) -> PrefixEntry}`` with a reverse index, and
changed-prefix sets returned from updates to drive incremental rebuilds.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry

NodeAndArea = Tuple[str, str]
PrefixEntries = Dict[NodeAndArea, PrefixEntry]


# externally serialized, never internally locked: every PrefixState is
# owned by one plane (Decision under evb; a ctrl handler's tenant
# views under SolverCtrlHandler._lock). The shared-state rule merges
# instances by class, so cross-role access to one instance is
# impossible by construction — hence "owner" confinement.
class PrefixState:
    def __init__(self) -> None:
        self._prefixes: Dict[IpPrefix, PrefixEntries] = {}
        # reverse index: (node, area) -> set of prefixes it advertises
        self._node_to_prefixes: Dict[NodeAndArea, Set[IpPrefix]] = {}
        # bumped whenever any entry actually changes; route caches key
        # their validity off this (solver per-prefix route reuse)
        self.version = 0

    def prefixes(self) -> Dict[IpPrefix, PrefixEntries]:
        return self._prefixes

    def entries_for(self, prefix: IpPrefix) -> PrefixEntries:
        return self._prefixes.get(prefix, {})

    def update_prefix_database(self, db: PrefixDatabase) -> Set[IpPrefix]:
        """Merge one node's prefix database (for one area); returns the set
        of prefixes whose entry set changed (for incremental rebuild).

        ``delete_prefix`` set means withdraw the listed prefixes.
        reference: openr/decision/PrefixState.cpp updatePrefixDatabase.
        """
        node_area: NodeAndArea = (db.this_node_name, db.area)
        changed: Set[IpPrefix] = set()

        if db.delete_prefix:
            for entry in db.prefix_entries:
                if self._remove_entry(node_area, entry.prefix):
                    changed.add(entry.prefix)
            if changed:
                self.version += 1
            return changed

        new_prefixes = {e.prefix: e for e in db.prefix_entries}
        old_prefixes = self._node_to_prefixes.get(node_area, set())

        # removed advertisements
        for prefix in old_prefixes - set(new_prefixes):
            if self._remove_entry(node_area, prefix):
                changed.add(prefix)

        # added / modified advertisements
        for prefix, entry in new_prefixes.items():
            entries = self._prefixes.setdefault(prefix, {})
            if entries.get(node_area) != entry:
                entries[node_area] = entry
                self._node_to_prefixes.setdefault(node_area, set()).add(prefix)
                changed.add(prefix)
        if changed:
            self.version += 1
        return changed

    def delete_prefix_database(self, node: str, area: str) -> Set[IpPrefix]:
        """Withdraw everything a node advertised into an area."""
        node_area = (node, area)
        changed: Set[IpPrefix] = set()
        for prefix in list(self._node_to_prefixes.get(node_area, ())):
            if self._remove_entry(node_area, prefix):
                changed.add(prefix)
        if changed:
            self.version += 1
        return changed

    def _remove_entry(self, node_area: NodeAndArea, prefix: IpPrefix) -> bool:
        entries = self._prefixes.get(prefix)
        if entries is None or node_area not in entries:
            return False
        del entries[node_area]
        if not entries:
            del self._prefixes[prefix]
        prefixes = self._node_to_prefixes.get(node_area)
        if prefixes is not None:
            prefixes.discard(prefix)
            if not prefixes:
                del self._node_to_prefixes[node_area]
        return True

    @staticmethod
    def has_conflicting_forwarding_info(entries: PrefixEntries) -> bool:
        """Advertisers of one prefix disagree on forwarding type or
        algorithm (reference: PrefixState::hasConflictingForwardingInfo)."""
        seen = None
        for entry in entries.values():
            key = (entry.forwarding_type, entry.forwarding_algorithm)
            if seen is None:
                seen = key
            elif key != seen:
                return True
        return False

    def get_node_host_loopbacks(self) -> Dict[NodeAndArea, Set[IpPrefix]]:
        return dict(self._node_to_prefixes)
