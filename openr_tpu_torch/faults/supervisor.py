"""Degradation supervisor: a bounded recovery ladder with a breaker.

Port note: a copy of ``openr_tpu/faults/supervisor.py``, with one
change: ``run(rungs, recoverable)`` hands a failed rung's walk to the next
rung only when ``recoverable(exc)`` says so, and re-raises any other
exception at once, leaving the health state, breaker and counters as they
were. Decision's predicate takes only injected faults and torn resident
state, so a kernel's build or launch failure propagates instead of being
answered by a deeper rung on the host.

One ``DegradationSupervisor`` guards one compute pipeline (the
route-sweep engine, the Decision SPF solve). Each call to ``run``
walks a caller-supplied ladder of rungs — e.g. warm ELL re-solve →
drain + cold device rebuild → host fallback — executing each rung AT
MOST ONCE, so a walk always terminates in ≤ len(rungs) attempts; there
is no retry loop to become unbounded. Every rung must produce the same
externally visible result (bit-identical route product), which the
parity suite proves per rung.

Health is a three-state machine exported as a registry gauge
(``<name>.health``: 0 HEALTHY / 1 DEGRADED / 2 FALLBACK) and stamped
into any active trace whenever a walk leaves the warm path:

- success on rung 0            → HEALTHY (a ``self_heals`` bump if we
  were degraded);
- success on a middle rung     → DEGRADED (the device path still works
  from cold, so the next walk probes warm again immediately);
- success on the last rung     → FALLBACK, and the circuit breaker
  (``utils/eventbase.ExponentialBackoff``) opens: until
  ``can_try_now()``, later walks start directly at the held fallback
  rung instead of hammering a dead device path. When the backoff
  elapses, one walk re-probes from rung 0 — success self-heals back to
  HEALTHY, failure re-opens the breaker with a longer delay.

If every rung fails the walk raises ``LadderExhausted`` carrying the
per-rung causes; the caller's event loop surfaces it like any other
module error (state stays FALLBACK, breaker open).
"""

from __future__ import annotations

import threading
import zlib
from enum import IntEnum
from typing import Any, Callable, List, Optional, Sequence, Tuple

from openr_tpu_torch.telemetry import get_flight_recorder, get_registry, get_tracer
from openr_tpu_torch.utils.eventbase import ExponentialBackoff

Rung = Tuple[str, Callable[[], Any]]


class HealthState(IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    FALLBACK = 2


class LadderExhausted(RuntimeError):
    """Every rung of a degradation ladder failed in one walk."""

    def __init__(
        self, name: str, failures: List[Tuple[str, BaseException]]
    ) -> None:
        detail = "; ".join(
            f"{rung}: {type(exc).__name__}: {exc}" for rung, exc in failures
        )
        super().__init__(f"{name}: all ladder rungs failed ({detail})")
        self.failures = failures


class DegradationSupervisor:
    """Walks a recovery ladder and owns the health state machine."""

    def __init__(
        self,
        name: str,
        backoff_min_s: float = 0.05,
        backoff_max_s: float = 2.0,
        backoff_jitter: bool = True,
        backoff_seed: Optional[int] = None,
    ) -> None:
        self.name = name
        self.state = HealthState.HEALTHY
        # decorrelated jitter ON by default: supervisors that all
        # degraded on one event must not re-probe in lockstep. The seed
        # defaults to a name hash so each supervisor gets a distinct
        # but replayable stream.
        seed = (
            backoff_seed if backoff_seed is not None
            else zlib.crc32(name.encode("utf-8"))
        )
        self.breaker = ExponentialBackoff(
            backoff_min_s, backoff_max_s,
            jitter=backoff_jitter, seed=seed,
        )
        self.walks = 0
        self._held_rung = 0
        self._lock = threading.RLock()
        get_registry().gauge(
            f"{name}.health", lambda: float(int(self.state))
        )

    # ------------------------------------------------------------------
    def run(
        self,
        rungs: Sequence[Rung],
        recoverable: Callable[[BaseException], bool],
    ) -> Any:
        """Walk the ladder once; first rung to succeed wins. An exception
        that ``recoverable`` rejects propagates at once."""
        reg = get_registry()
        with self._lock:
            self.walks += 1
            reg.counter_bump(f"{self.name}.ladder_walks")
            start = 0
            if self.state is not HealthState.HEALTHY:
                if self.breaker.can_try_now():
                    reg.counter_bump(f"{self.name}.probes")
                else:
                    # breaker open: go straight to the rung that last
                    # worked instead of hammering the failed path
                    start = min(self._held_rung, len(rungs) - 1)
            failures: List[Tuple[str, BaseException]] = []
            for i in range(start, len(rungs)):
                rung_name, fn = rungs[i]
                try:
                    result = fn()
                except Exception as exc:
                    if not recoverable(exc):
                        raise
                    failures.append((rung_name, exc))
                    reg.counter_bump(
                        f"{self.name}.rung_failures.{rung_name}"
                    )
                    continue
                self._note_success(i, len(rungs), rung_name, start)
                return result
            # nothing worked: stay broken, keep the breaker open so the
            # next walk still skips ahead, and surface the causes
            reg.counter_bump(f"{self.name}.ladder_exhausted")
            self.state = HealthState.FALLBACK
            self.breaker.report_error()
            self._held_rung = len(rungs) - 1
            get_flight_recorder().anomaly(
                "ladder_exhausted",
                reason=f"{self.name}: all {len(rungs)} rungs failed",
                ladder=self.name,
                rungs=[r for r, _ in failures],
            )
            raise LadderExhausted(self.name, failures)

    # ------------------------------------------------------------------
    def _note_success(
        self, index: int, total: int, rung_name: str, start: int
    ) -> None:
        reg = get_registry()
        prev = self.state
        if index == 0:
            new = HealthState.HEALTHY
            self.breaker.report_success()
            self._held_rung = 0
        elif index == total - 1:
            new = HealthState.FALLBACK
            self.breaker.report_error()
            self._held_rung = index
            reg.counter_bump(f"{self.name}.fallbacks")
        else:
            # the device path recovered from cold: close the breaker so
            # the very next walk re-probes the warm rung
            new = HealthState.DEGRADED
            self.breaker.report_success()
            self._held_rung = 0
            reg.counter_bump(f"{self.name}.degradations")
        if prev is not HealthState.HEALTHY and new is HealthState.HEALTHY:
            reg.counter_bump(f"{self.name}.self_heals")
        if new is not prev:
            reg.counter_bump(f"{self.name}.health_transitions")
        self.state = new
        if index > 0 or start > 0 or prev is not new:
            tracer = get_tracer()
            span = tracer.span_active(f"{self.name}.ladder")
            tracer.end_span_active(
                span,
                rung=rung_name,
                health=new.name,
                rungs_tried=index - start + 1,
            )
            get_flight_recorder().note(
                "ladder",
                name=self.name,
                rung=rung_name,
                health=new.name,
                rungs_tried=index - start + 1,
            )
