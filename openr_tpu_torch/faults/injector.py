"""Deterministic, seedable fault injection at the pipeline's seams.

Port note: a copy of ``openr_tpu/faults/injector.py``; nothing left out.

Injection points are plain function calls (``fault_point("site.name")``)
placed at the real failure surfaces — device dispatch, delta
readback/consume, cold device rebuild, KvStore peer sync/flood, the Fib
thrift transport, netlink programming. A disarmed process pays one
attribute read per site crossing; nothing else.

Tests (and ``tools/chaos_report.py``) arm a site with a
``FaultSchedule``:

- ``FaultSchedule.fail_once()`` — raise on the next crossing only;
- ``FaultSchedule.fail_n(n)`` — raise on the next ``n`` crossings;
- ``FaultSchedule.fail_with_probability(p, seed)`` — raise on each
  crossing with probability ``p`` from a private ``random.Random(seed)``
  stream, so a chaos run replays bit-for-bit from its seed;
- ``FaultSchedule.delay(seconds, n)`` — sleep instead of raising (models
  a slow transport rather than a dead one).

Every fired fault bumps ``faults.injected.<site>`` (or
``faults.delayed.<site>``) in the process registry, which is how the
chaos soak proves its coverage floor. The injector is process-global:
``get_injector().reset()`` between tests.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional, Tuple

from openr_tpu_torch.telemetry import get_registry


class FaultInjected(Exception):
    """Raised by an armed injection site when its schedule fires."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault at {site}")
        self.site = site


class FaultSchedule:
    """Decides, per crossing of one armed site, whether to fire.

    Mutates its own counters under the injector lock; deterministic for
    a given (constructor args, crossing sequence).
    """

    __slots__ = ("mode", "remaining", "probability", "delay_s", "_rng",
                 "fires", "period", "_crossings")

    def __init__(
        self,
        mode: str,
        remaining: Optional[int] = None,
        probability: float = 0.0,
        delay_s: float = 0.0,
        seed: int = 0,
        period: int = 0,
    ) -> None:
        self.mode = mode
        self.remaining = remaining  # None = unlimited
        self.probability = probability
        self.delay_s = delay_s
        self._rng = random.Random(seed)
        self.fires = 0
        self.period = int(period)  # fire every k-th crossing (0 = off)
        self._crossings = 0

    # -- constructors ------------------------------------------------
    @classmethod
    def fail_once(cls) -> "FaultSchedule":
        return cls("fail", remaining=1)

    @classmethod
    def fail_n(cls, n: int) -> "FaultSchedule":
        return cls("fail", remaining=int(n))

    @classmethod
    def fail_with_probability(cls, p: float, seed: int) -> "FaultSchedule":
        return cls("fail", probability=float(p), seed=seed)

    @classmethod
    def fail_every(cls, k: int) -> "FaultSchedule":
        """Fire on every k-th crossing: deterministic periodic loss
        (the twin's lossy-flood scenarios want a fixed drop cadence
        that replays identically, which probability schedules only
        give per-seed)."""
        return cls("fail", period=int(k))

    @classmethod
    def delay(
        cls, seconds: float, n: Optional[int] = None
    ) -> "FaultSchedule":
        return cls("delay", remaining=n, delay_s=float(seconds))

    # -- evaluation --------------------------------------------------
    def should_fire(self) -> bool:
        if self.period:
            self._crossings += 1
            if self._crossings % self.period:
                return False
            self.fires += 1
            return True
        if self.remaining is not None:
            if self.remaining <= 0:
                return False
            self.remaining -= 1
            self.fires += 1
            return True
        if self._rng.random() < self.probability:
            self.fires += 1
            return True
        return False


class FaultInjector:
    """Process-global registry of named injection sites."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._registered: Dict[str, None] = {}
        self._armed: Dict[str, FaultSchedule] = {}
        # read lock-free on every site crossing; only flips under lock
        self.any_armed = False

    # -- site registry -----------------------------------------------
    def register(self, site: str) -> str:
        with self._lock:
            self._registered[site] = None
        return site

    def list_sites(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._registered)

    # -- arming ------------------------------------------------------
    def arm(self, site: str, schedule: FaultSchedule) -> None:
        with self._lock:
            self._registered[site] = None
            self._armed[site] = schedule
            self.any_armed = True

    def disarm(self, site: str) -> None:
        with self._lock:
            self._armed.pop(site, None)
            self.any_armed = bool(self._armed)

    def reset(self) -> None:
        """Disarm every site (registered names survive)."""
        with self._lock:
            self._armed.clear()
            self.any_armed = False

    # -- the crossing ------------------------------------------------
    def check(self, site: str) -> None:
        with self._lock:
            schedule = self._armed.get(site)
            fire = schedule is not None and schedule.should_fire()
            delay_s = schedule.delay_s if fire else 0.0
            mode = schedule.mode if fire else ""
        if not fire:
            return
        if mode == "delay":
            get_registry().counter_bump(f"faults.delayed.{site}")
            time.sleep(delay_s)
            return
        get_registry().counter_bump(f"faults.injected.{site}")
        raise FaultInjected(site)

    def consume(self, site: str) -> bool:
        """Non-raising crossing for seams that CORRUPT rather than
        fail (e.g. ``device.corrupt_resident``): the caller mutates its
        own state when this returns True. Fired crossings still bump
        ``faults.injected.<site>`` so chaos coverage floors see them;
        ``delay`` schedules make no sense here and are treated as
        fires."""
        with self._lock:
            schedule = self._armed.get(site)
            fire = schedule is not None and schedule.should_fire()
        if not fire:
            return False
        get_registry().counter_bump(f"faults.injected.{site}")
        return True


class DeviceLostError(RuntimeError):
    """An accelerator died under resident state.

    Raised by the ``device.lost`` seam (and recognized when the runtime
    raises its own device-loss flavored ``XlaRuntimeError``); the
    dispatch/consume fault boundaries poison the residents and the
    ladder's recover rung rebuilds them from the host mirrors.
    """

    def __init__(self, site: str = "device.lost") -> None:
        super().__init__(f"device lost at {site}")
        self.site = site


# Substrings the XLA runtime uses for a lost/failed device; matched
# case-insensitively against the exception text.
_DEVICE_LOSS_MARKERS = (
    "device lost",
    "device is lost",
    "device failure",
    "deadline exceeded waiting for device",
    "hbm is corrupted",
    "data loss:",
)


def is_device_loss(exc: BaseException) -> bool:
    """True when ``exc`` means the accelerator (not the program) died.

    Covers the typed ``DeviceLostError``, the ``device.lost`` injection
    seam, and real ``XlaRuntimeError`` texts carrying a device-loss
    marker.
    """
    if isinstance(exc, DeviceLostError):
        return True
    if isinstance(exc, FaultInjected) and exc.site == "device.lost":
        return True
    if type(exc).__name__ == "XlaRuntimeError":
        msg = str(exc).lower()
        return any(m in msg for m in _DEVICE_LOSS_MARKERS)
    return False


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


def register_fault_site(site: str) -> str:
    """Module-import-time site declaration (shows up in list_sites()
    even before anything arms it)."""
    return _INJECTOR.register(site)


def fault_point(site: str) -> None:
    """The per-crossing hook host code calls. Disarmed cost: one
    attribute read and a falsy branch."""
    if not _INJECTOR.any_armed:
        return
    _INJECTOR.check(site)


def consume_fault(site: str) -> bool:
    """Non-raising sibling of ``fault_point`` for corrupting seams.
    Same disarmed cost: one attribute read and a falsy branch."""
    if not _INJECTOR.any_armed:
        return False
    return _INJECTOR.consume(site)
