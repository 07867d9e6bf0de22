"""Per-module event loop: the daemon's async runtime substrate.

Port note: a copy of ``openr_tpu/utils/eventbase.py``; nothing left out,
and one fault fixed: a queue reader delivers one message at a time (see
``add_queue_reader``).

Behavioral parity with the reference ``openr/common/OpenrEventBase.h``
(folly EventBase wrapper): every protocol module owns exactly one
OpenrEventBase running on its own named thread; all module state is
touched only from that thread. Cross-module communication happens through
``openr_tpu_torch.messaging`` queues, whose readers are registered here (the
analogue of the reference's fiber tasks, OpenrEventBase.h:48
addFiberTask) and delivered as callbacks on the module thread.

Also hosts the coalescing/rate-limiting primitives the modules rely on:
- ``ExponentialBackoff``  (reference: common/ExponentialBackoff.h)
- ``AsyncThrottle``       (reference: common/AsyncThrottle.h)
- ``AsyncDebounce``       (reference: common/AsyncDebounce.h:27-62)
"""

from __future__ import annotations

import heapq
import itertools
import queue as _queue
import random
import threading
import time
from typing import Callable, List, Optional, Tuple

from openr_tpu_torch.analysis.annotations import thread_confined
from openr_tpu_torch.messaging.queue import QueueClosedError, RQueue

# upper bound on the event loop's idle wait so last_loop_ts stays fresh
# for the Watchdog even on a completely quiet event base; small enough
# that it stays well under any plausible watchdog threshold
_WATCHDOG_TICK_S = 0.1


class TimerHandle:
    __slots__ = ("deadline", "seq", "fn", "cancelled")

    def __init__(self, deadline: float, seq: int, fn: Callable[[], None]):
        self.deadline = deadline
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "TimerHandle") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class OpenrEventBase:
    """Single-threaded event loop with timers and queue-reader tasks."""

    def __init__(self, name: str = "evb"):
        self.name = name
        self._callbacks: "_queue.Queue[Callable[[], None]]" = _queue.Queue()
        self._timers: List[TimerHandle] = []
        self._timer_lock = threading.Lock()
        self._seq = itertools.count()
        self._running = threading.Event()
        self._stop_requested = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reader_threads: List[threading.Thread] = []
        # liveness for the watchdog (reference: Watchdog.h monitors evbs)
        self.last_loop_ts: float = time.monotonic()

    # -- lifecycle --------------------------------------------------------

    def run(self) -> None:
        """Run the loop on the calling thread until stop()."""
        self._running.set()
        try:
            while not self._stop_requested.is_set():
                self.last_loop_ts = time.monotonic()
                timeout = self._run_due_timers()
                # bound the idle wait: an evb with no timers and no
                # traffic (Monitor on a quiet network) would otherwise
                # block forever in get(), its last_loop_ts would go
                # stale, and the Watchdog would abort a HEALTHY daemon.
                # Idle-blocked is healthy; a hung callback still never
                # returns here and still trips the watchdog.
                if timeout is None or timeout > _WATCHDOG_TICK_S:
                    timeout = _WATCHDOG_TICK_S
                try:
                    cb = self._callbacks.get(timeout=timeout)
                except _queue.Empty:
                    continue
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    # a module callback must never kill the module loop
                    import logging

                    logging.getLogger(__name__).exception(
                        "%s: unhandled exception in event callback", self.name
                    )
        finally:
            self._running.clear()

    def run_in_thread(self) -> None:
        assert self._thread is None
        self._thread = threading.Thread(
            target=self.run, name=self.name, daemon=True
        )
        self._thread.start()
        self.wait_until_running()

    def wait_until_running(self, timeout: float = 5.0) -> None:
        if not self._running.wait(timeout=timeout):
            raise TimeoutError(f"{self.name}: loop did not start")

    def stop(self) -> None:
        self._stop_requested.set()
        # wake the loop
        self._callbacks.put(lambda: None)

    def join(self, timeout: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        for t in self._reader_threads:
            t.join(timeout=timeout)

    @property
    def is_running(self) -> bool:
        return self._running.is_set()

    def in_event_base_thread(self) -> bool:
        return threading.current_thread() is self._thread

    # -- scheduling -------------------------------------------------------

    def run_in_event_base(self, fn: Callable[[], None]) -> None:
        """Enqueue fn to run on the loop thread."""
        self._callbacks.put(fn)

    def run_immediately_or_in_event_base(self, fn: Callable[[], None]) -> None:
        if self.in_event_base_thread():
            fn()
        else:
            self.run_in_event_base(fn)

    def call_and_wait(self, fn: Callable[[], object], timeout: float = 10.0):
        """Run fn on the loop thread, block for its result (the analogue of
        the reference's folly::SemiFuture module read APIs)."""
        if self.in_event_base_thread():
            return fn()
        done = threading.Event()
        result: list = [None, None]

        def wrapper() -> None:
            try:
                result[0] = fn()
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                result[1] = e
            finally:
                done.set()

        self.run_in_event_base(wrapper)
        if not done.wait(timeout=timeout):
            raise TimeoutError(f"{self.name}: call_and_wait timed out")
        if result[1] is not None:
            raise result[1]
        return result[0]

    def schedule_timeout(
        self, delay_s: float, fn: Callable[[], None]
    ) -> TimerHandle:
        handle = TimerHandle(
            time.monotonic() + max(0.0, delay_s), next(self._seq), fn
        )
        with self._timer_lock:
            heapq.heappush(self._timers, handle)
        # wake the loop so it recomputes its sleep
        self._callbacks.put(lambda: None)
        return handle

    def schedule_periodic(
        self, interval_s: float, fn: Callable[[], None], jitter_first: bool = False
    ) -> "PeriodicHandle":
        return PeriodicHandle(self, interval_s, fn, jitter_first)

    def _run_due_timers(self) -> Optional[float]:
        """Fire expired timers; return seconds until the next one."""
        while True:
            with self._timer_lock:
                while self._timers and self._timers[0].cancelled:
                    heapq.heappop(self._timers)
                if not self._timers:
                    return None
                now = time.monotonic()
                if self._timers[0].deadline > now:
                    return self._timers[0].deadline - now
                handle = heapq.heappop(self._timers)
            if not handle.cancelled:
                try:
                    handle.fn()
                except Exception:  # noqa: BLE001
                    import logging

                    logging.getLogger(__name__).exception(
                        "%s: unhandled exception in timer", self.name
                    )

    # -- queue reader tasks (the "fibers") --------------------------------

    def add_queue_reader(
        self, rqueue: RQueue, callback: Callable[[object], None]
    ) -> None:
        """Deliver every message from rqueue as a callback on the loop
        thread (reference: fiber reading loops like Decision.cpp:1433),
        one at a time: the next message leaves rqueue only after the
        previous callback ran. A callback that drains rqueue itself
        (Decision's admission path) then never has an older message
        delivered after the newer ones it drained; the reference's reader
        forwards ahead, and under a backlog Decision applied a superseded
        LSDB value last."""

        def forward() -> None:
            while not self._stop_requested.is_set():
                try:
                    item = rqueue.get(timeout=0.2)
                except QueueClosedError:
                    return
                except Exception:
                    continue
                done = threading.Event()

                def deliver(item=item, done=done) -> None:
                    try:
                        callback(item)
                    finally:
                        done.set()

                self.run_in_event_base(deliver)
                while not done.wait(timeout=0.2):
                    if self._stop_requested.is_set():
                        return

        t = threading.Thread(
            target=forward, name=f"{self.name}::reader", daemon=True
        )
        t.start()
        self._reader_threads.append(t)


class PeriodicHandle:
    """Repeating timer bound to an event base."""

    def __init__(
        self,
        evb: OpenrEventBase,
        interval_s: float,
        fn: Callable[[], None],
        jitter_first: bool,
    ):
        self._evb = evb
        self._interval = interval_s
        self._fn = fn
        self._cancelled = False
        first = interval_s if jitter_first else 0.0
        self._handle = evb.schedule_timeout(first, self._tick)

    def _tick(self) -> None:
        if self._cancelled:
            return
        self._fn()
        if not self._cancelled:
            self._handle = self._evb.schedule_timeout(self._interval, self._tick)

    def cancel(self) -> None:
        self._cancelled = True
        self._handle.cancel()


# per-instance pacing state owned by whichever single loop created the
# backoff (an evb retry loop, the journal streamer thread, a client's
# reconnect path) — never shared across threads. The shared-state rule
# merges instances by class, so cross-role access to one instance is
# impossible by construction — hence "owner" confinement.
@thread_confined("owner", "_current", "_last_error_ts")
class ExponentialBackoff:
    """reference: common/ExponentialBackoff.h — per-key retry pacing.

    ``jitter=True`` opts into DECORRELATED jitter (the AWS
    exponential-backoff-and-jitter scheme): each error re-draws the
    delay uniformly from ``[initial, 3 * previous]`` (clamped to
    ``max``) from a private seeded stream, so N breakers that opened on
    the same event spread their re-probes instead of re-hammering the
    device in lockstep. Default OFF: the deterministic doubling path is
    byte-identical to the reference and some callers pin its exact
    sequence."""

    def __init__(self, initial_s: float, max_s: float,
                 jitter: bool = False, seed: Optional[int] = None):
        assert initial_s > 0 and max_s >= initial_s
        self._initial = initial_s
        self._max = max_s
        self._current = 0.0
        self._last_error_ts = 0.0
        self._jitter = bool(jitter)
        self._rng = random.Random(seed) if jitter else None

    def can_try_now(self) -> bool:
        return self.get_time_remaining_until_retry() <= 0

    def report_success(self) -> None:
        self._current = 0.0

    def report_error(self) -> None:
        self._last_error_ts = time.monotonic()
        if self._jitter:
            prev = self._current if self._current > 0.0 else self._initial
            self._current = min(
                self._max,
                self._rng.uniform(
                    self._initial, max(self._initial, prev * 3.0)
                ),
            )
        elif self._current == 0.0:
            self._current = self._initial
        else:
            self._current = min(self._current * 2, self._max)

    def at_max_backoff(self) -> bool:
        return self._current >= self._max

    @property
    def max_backoff(self) -> float:
        return self._max

    def set_max(self, max_s: float) -> None:
        """Retarget the ceiling (rate-adaptive debounce). Raising the max
        lets the next report_error extend further; lowering it clamps any
        in-flight backoff so the change takes effect immediately."""
        assert max_s >= self._initial
        self._max = max_s
        if self._current > max_s:
            self._current = max_s

    def get_current_backoff(self) -> float:
        return self._current

    def get_time_remaining_until_retry(self) -> float:
        if self._current == 0.0:
            return 0.0
        return max(0.0, self._last_error_ts + self._current - time.monotonic())


class AsyncThrottle:
    """Coalesce bursts: callback runs at most once per ``timeout_s``.
    reference: common/AsyncThrottle.h."""

    def __init__(
        self, evb: OpenrEventBase, timeout_s: float, callback: Callable[[], None]
    ):
        self._evb = evb
        self._timeout = timeout_s
        self._callback = callback
        self._handle: Optional[TimerHandle] = None

    def __call__(self) -> None:
        if self._handle is not None and not self._handle.cancelled:
            return
        if self._timeout <= 0:
            self._callback()
            return
        self._handle = self._evb.schedule_timeout(self._timeout, self._fire)

    def _fire(self) -> None:
        self._handle = None
        self._callback()

    def is_active(self) -> bool:
        return self._handle is not None and not self._handle.cancelled

    def cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None


class AsyncDebounce:
    """Debounce with exponential extension: every invocation while pending
    pushes the deadline out (doubling from min toward max); once the
    backoff is saturated further invocations no longer delay the fire.
    reference: common/AsyncDebounce.h:27-62."""

    def __init__(
        self,
        evb: OpenrEventBase,
        min_backoff_s: float,
        max_backoff_s: float,
        callback: Callable[[], None],
    ):
        self._evb = evb
        self._backoff = ExponentialBackoff(min_backoff_s, max_backoff_s)
        self._callback = callback
        self._handle: Optional[TimerHandle] = None

    def __call__(self) -> None:
        if not self._backoff.at_max_backoff():
            self._backoff.report_error()
            if self._handle is not None:
                self._handle.cancel()
            self._handle = self._evb.schedule_timeout(
                self._backoff.get_current_backoff(), self._fire
            )
        assert self._handle is not None and not self._handle.cancelled

    def _fire(self) -> None:
        self._handle = None
        self._backoff.report_success()
        self._callback()

    def is_scheduled(self) -> bool:
        return self._handle is not None and not self._handle.cancelled

    def at_max_backoff(self) -> bool:
        """True once the extension ceiling is saturated: further
        invocations no longer push the deadline out, so a pending fire
        time is FINAL. This is the debounce *terminal* — the window
        where speculating on the current coalesced backlog is sound
        under latest-wins (nothing can reopen the window, only join
        it)."""
        return self._backoff.at_max_backoff()

    @property
    def max_backoff_s(self) -> float:
        return self._backoff.max_backoff

    def set_max_backoff(self, max_s: float) -> None:
        """Adjust the extension ceiling in place (the admission path's
        rate-adaptive debounce). A pending fire keeps its deadline; only
        future extensions see the new ceiling — except that lowering the
        ceiling clamps the backoff immediately, so a saturated debounce
        under a narrowed ceiling fires sooner on the next invocation."""
        self._backoff.set_max(max_s)
