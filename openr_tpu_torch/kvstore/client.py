"""KvStoreClient: in-process client used by the other modules.

Behavioral parity with the reference ``openr/kvstore/KvStoreClientInternal``:
- ``persist_key``: own a key — advertise it, refresh its TTL, and win back
  ownership (higher version) if any other node overwrites it
- ``set_key`` / ``get_key`` / ``dump_all_with_prefix``
- per-key and filtered subscription callbacks fed from the store's
  publication queue, delivered on the caller's event base

Port note: a copy of ``openr_tpu/kvstore/client.py``; nothing left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from openr_tpu_torch.types import (
    TTL_INFINITY,
    KeyDumpParams,
    KeySetParams,
    Publication,
    Value,
)
from openr_tpu_torch.utils.eventbase import OpenrEventBase

KeyCallback = Callable[[str, Optional[Value]], None]


@dataclass
class _PersistedKey:
    area: str
    key: str
    value: bytes
    ttl: int


class KvStoreClient:
    def __init__(
        self,
        evb: OpenrEventBase,
        node_id: str,
        kvstore,
        ttl_refresh_interval_s: float = 0.5,
    ):
        self._evb = evb
        self._node_id = node_id
        self._kvstore = kvstore
        self._persisted: Dict[Tuple[str, str], _PersistedKey] = {}
        self._key_callbacks: Dict[Tuple[str, str], KeyCallback] = {}
        self._filter_callbacks: list = []
        reader = kvstore.updates_queue.get_reader(f"client:{node_id}")
        evb.add_queue_reader(reader, self._process_publication)
        self._refresh_timer = evb.schedule_periodic(
            ttl_refresh_interval_s, self._refresh_ttls, jitter_first=True
        )

    @property
    def evb(self) -> OpenrEventBase:
        """The event base publications are delivered on — consensus users
        (RangeAllocator) must run their FSM on this same thread."""
        return self._evb

    def stop(self) -> None:
        self._refresh_timer.cancel()

    # -- key ownership ----------------------------------------------------

    def persist_key(
        self, area: str, key: str, value: bytes, ttl: int = TTL_INFINITY
    ) -> None:
        """Advertise and keep ownership of key (reference:
        KvStoreClientInternal::persistKey)."""
        self._persisted[(area, key)] = _PersistedKey(area, key, value, ttl)
        existing = self.get_key(area, key)
        version = 1
        if existing is not None:
            if (
                existing.originator_id == self._node_id
                and existing.value == value
            ):
                return  # already ours with same value
            version = existing.version + 1
        self._advertise(area, key, value, version, ttl)

    def unset_key(self, area: str, key: str) -> None:
        """Stop owning the key; it will age out via TTL (there is no
        delete in the flooded store)."""
        self._persisted.pop((area, key), None)

    def clear_key(
        self, area: str, key: str, value: bytes, ttl: int = TTL_INFINITY
    ) -> None:
        """Stop owning the key and flood one final tombstone value
        (reference: KvStoreClientInternal::clearKey). Ownership must be
        dropped *before* the tombstone floods, or the ownership
        enforcement in _process_publication would see a foreign value on
        a persisted key and resurrect the old one."""
        self._persisted.pop((area, key), None)
        self.set_key(area, key, value, ttl=ttl)

    def set_key(
        self,
        area: str,
        key: str,
        value: bytes,
        version: Optional[int] = None,
        ttl: int = TTL_INFINITY,
    ) -> None:
        if version is None:
            existing = self.get_key(area, key)
            version = 1 if existing is None else existing.version + 1
        self._advertise(area, key, value, version, ttl)

    def _advertise(
        self, area: str, key: str, value: bytes, version: int, ttl: int
    ) -> None:
        self._kvstore.set_key_vals(
            area,
            KeySetParams(
                key_vals={
                    key: Value(
                        version=version,
                        originator_id=self._node_id,
                        value=value,
                        ttl=ttl,
                        ttl_version=0,
                    )
                },
                originator_id=self._node_id,
            ),
        )

    # -- reads ------------------------------------------------------------

    def get_key(self, area: str, key: str) -> Optional[Value]:
        return self._kvstore.get_key_vals(area, [key]).get(key)

    def dump_all_with_prefix(self, area: str, prefix: str = "") -> Dict[str, Value]:
        pub = self._kvstore.dump_with_filters(
            area, KeyDumpParams(prefix=prefix)
        )
        return pub.key_vals

    # -- subscriptions ----------------------------------------------------

    def subscribe_key(self, area: str, key: str, callback: KeyCallback) -> None:
        self._key_callbacks[(area, key)] = callback

    def unsubscribe_key(self, area: str, key: str) -> None:
        self._key_callbacks.pop((area, key), None)

    def unsubscribe_key_filter(self, callback) -> None:
        try:
            self._filter_callbacks.remove(callback)
        except ValueError:
            pass

    def subscribe_key_filter(
        self, callback: Callable[[str, str, Optional[Value]], None]
    ) -> None:
        """callback(area, key, value_or_None_for_expired)"""
        self._filter_callbacks.append(callback)

    # -- internals --------------------------------------------------------

    def _process_publication(self, pub: Publication) -> None:
        for key, value in pub.key_vals.items():
            cb = self._key_callbacks.get((pub.area, key))
            if cb is not None:
                cb(key, value)
            for fcb in self._filter_callbacks:
                fcb(pub.area, key, value)
            self._enforce_ownership(pub.area, key, value)
        for key in pub.expired_keys:
            cb = self._key_callbacks.get((pub.area, key))
            if cb is not None:
                cb(key, None)
            for fcb in self._filter_callbacks:
                fcb(pub.area, key, None)
            # re-advertise persisted keys that expired
            persisted = self._persisted.get((pub.area, key))
            if persisted is not None:
                self.persist_key(
                    pub.area, key, persisted.value, persisted.ttl
                )

    def _enforce_ownership(self, area: str, key: str, value: Value) -> None:
        """If someone overwrote a key we persist, advertise a higher
        version to win it back (reference: KvStoreClientInternal
        processPublication ownership enforcement)."""
        persisted = self._persisted.get((area, key))
        if persisted is None:
            return
        if value.value is None:
            return  # ttl-only refresh: carries no ownership information
        if (
            value.originator_id == self._node_id
            and value.value == persisted.value
        ):
            return
        self._advertise(
            area, key, persisted.value, value.version + 1, persisted.ttl
        )

    def refresh_ttl(self, area: str, key: str, ttl: int) -> bool:
        """One ttl-only refresh (same version, bumped ttlVersion, no
        value) for a key we originated. Returns False if the key is
        gone or no longer ours. Unlike persist_key this carries no
        ownership enforcement — consensus users (RangeAllocator) rely
        on the same-version merge ordering staying untouched."""
        current = self.get_key(area, key)
        if current is None or current.originator_id != self._node_id:
            return False
        self._kvstore.set_key_vals(
            area,
            KeySetParams(
                key_vals={
                    key: Value(
                        version=current.version,
                        originator_id=self._node_id,
                        value=None,  # ttl-only refresh
                        ttl=ttl,
                        ttl_version=current.ttl_version + 1,
                    )
                },
                originator_id=self._node_id,
            ),
        )
        return True

    def _refresh_ttls(self) -> None:
        """Bump ttlVersion on persisted finite-TTL keys so they never
        expire while owned."""
        for persisted in list(self._persisted.values()):
            if persisted.ttl == TTL_INFINITY:
                continue
            self.refresh_ttl(persisted.area, persisted.key, persisted.ttl)
