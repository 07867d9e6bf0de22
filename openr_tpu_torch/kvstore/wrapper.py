"""KvStoreWrapper: test fixture running a real KvStore.

Behavioral parity with the reference ``openr/kvstore/KvStoreWrapper.h``:
set/get keys, peer linking, and blocking publication receive — used to
build multi-store topologies (stars, rings, meshes) inside one process.

Port note: a copy of ``openr_tpu/kvstore/wrapper.py``; nothing left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from openr_tpu_torch.kvstore.store import InProcessTransport, KvStore
from openr_tpu_torch.messaging.queue import RQueue
from openr_tpu_torch.types import (
    DEFAULT_AREA,
    TTL_INFINITY,
    KeySetParams,
    Publication,
    Value,
)
from openr_tpu_torch.utils import wire


class KvStoreWrapper:
    def __init__(
        self,
        node_id: str,
        areas: Optional[List[str]] = None,
        enable_flood_optimization: bool = False,
        is_flood_root: bool = False,
    ):
        self.node_id = node_id
        self.store = KvStore(
            node_id=node_id,
            areas=areas,
            enable_flood_optimization=enable_flood_optimization,
            is_flood_root=is_flood_root,
        )
        self._reader: RQueue = self.store.updates_queue.get_reader(
            f"wrapper:{node_id}"
        )

    def start(self) -> None:
        self.store.start()

    def stop(self) -> None:
        self.store.stop()

    def set_key(
        self,
        key: str,
        value: bytes,
        version: int = 1,
        ttl: int = TTL_INFINITY,
        area: str = DEFAULT_AREA,
        originator: Optional[str] = None,
    ) -> None:
        originator = originator or self.node_id
        self.store.set_key_vals(
            area,
            KeySetParams(
                key_vals={
                    key: Value(
                        version=version,
                        originator_id=originator,
                        value=value,
                        ttl=ttl,
                        hash=wire.generate_hash(version, originator, value),
                    )
                },
                originator_id=originator,
            ),
        )

    def get_key(self, key: str, area: str = DEFAULT_AREA) -> Optional[Value]:
        return self.store.get_key_vals(area, [key]).get(key)

    def dump(self, area: str = DEFAULT_AREA) -> Dict[str, Value]:
        return self.store.dump_with_filters(area).key_vals

    def add_peer(self, other: "KvStoreWrapper", area: str = DEFAULT_AREA) -> None:
        self.store.add_peer(
            area, other.node_id, InProcessTransport(other.store)
        )

    def del_peer(self, other_name: str, area: str = DEFAULT_AREA) -> None:
        self.store.del_peer(area, other_name)

    def recv_publication(self, timeout: float = 5.0) -> Publication:
        return self._reader.get(timeout=timeout)

    def peer_states(self, area: str = DEFAULT_AREA):
        return self.store.peer_states(area)


def link_bidirectional(a: KvStoreWrapper, b: KvStoreWrapper, area=DEFAULT_AREA):
    a.add_peer(b, area)
    b.add_peer(a, area)
