"""PersistentStore: disk-backed store for state that must survive restart.

Behavioral parity with the reference ``openr/config-store/PersistentStore``
(PersistentStore.h:55): async batched writes with atomic on-disk commit
(tmp + rename + fsync), typed object load/store over the wire codec.
Used for drain/overload state, allocated prefixes and node labels
(reference: Main.cpp:479-480, PrefixAllocator).

Port note: a copy of ``openr_tpu/config_store/persistent_store.py``;
nothing left out.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, Optional

from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import AsyncThrottle, OpenrEventBase

log = logging.getLogger(__name__)


class PersistentStore:
    def __init__(self, path: str, save_throttle_s: float = 0.1):
        self._path = path
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}
        self.num_writes = 0
        self.num_saves = 0
        self._load_from_disk()
        self.evb = OpenrEventBase(name=f"config-store")
        self._save_throttled = AsyncThrottle(
            self.evb, save_throttle_s, self._save_to_disk
        )
        self.evb.run_in_thread()

    # -- lifecycle --------------------------------------------------------

    def stop(self) -> None:
        # flush pending writes synchronously before shutdown
        self.evb.call_and_wait(self._save_to_disk)
        self.evb.stop()
        self.evb.join()

    # -- public API -------------------------------------------------------

    def store(self, key: str, obj: Any) -> None:
        """Store any wire-encodable object (dataclass, dict, list, ...)."""
        payload = wire.dumps(obj)
        with self._lock:
            self._data[key] = payload
            self.num_writes += 1
        self._save_throttled()

    def load(self, key: str, cls: Any = None) -> Optional[Any]:
        with self._lock:
            payload = self._data.get(key)
        if payload is None:
            return None
        return wire.loads(payload, cls if cls is not None else Any)

    def erase(self, key: str) -> bool:
        with self._lock:
            existed = key in self._data
            self._data.pop(key, None)
        if existed:
            self._save_throttled()
        return existed

    def keys(self):
        with self._lock:
            return sorted(self._data)

    # -- disk I/O ---------------------------------------------------------

    def _load_from_disk(self) -> None:
        try:
            with open(self._path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self._data = {}
            return
        try:
            self._data = dict(wire.loads(raw, Dict[str, bytes]))
        except (ValueError, TypeError, IndexError, EOFError) as exc:
            # Corrupt/truncated store: start empty, but never silently.
            # The bad bytes are parked at the .tmp sibling for forensics
            # (the next atomic save overwrites .tmp last, so the evidence
            # survives until a healthy save lands).
            self._data = {}
            get_registry().counter_bump("config_store.load_errors")
            tmp = f"{self._path}.tmp"
            try:
                if not os.path.exists(tmp):
                    with open(tmp, "wb") as f:
                        f.write(raw)
            except OSError:
                pass
            log.error(
                "config-store %s unreadable (%d bytes): %s; starting "
                "empty, corrupt bytes kept at %s",
                self._path, len(raw), exc, tmp,
            )

    def _save_to_disk(self) -> None:
        with self._lock:
            raw = wire.dumps(dict(self._data))
            self.num_saves += 1
        tmp = f"{self._path}.tmp"
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
