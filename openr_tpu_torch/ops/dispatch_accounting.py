"""Host-touch accounting for the port's route builds.

Port note: a port of the part of ``openr_tpu/ops/dispatch_accounting.py``
that the port's route-build path calls. Every host interaction with the
card on that path reports here:

- ``count_dispatch()`` — a hand-written kernel was launched (its wrapper
  calls it beside the kernel's ``LAUNCHES`` count): ``ops.host_dispatches``;
- ``sync_flag(flag)`` — ``bool()`` of a device scalar, the relax loops'
  per-hop convergence test: one ``ops.blocking_syncs``;
- ``reap_read(t)`` — a tensor read back to host memory as numpy by a
  blocking ``.cpu()``: one ``ops.blocking_syncs``;
- ``note_blocking_sync()`` — any other blocking device-to-host sync, such
  as the wait in ``ops.staging.Readback.reap``.

``event_window(tag)`` brackets one event (Decision's ``decision.rebuild``):
consecutive dispatches collapse into one submit phase and consecutive syncs
into one read phase, so ``touches = submit_phases + read_phases`` is the
number of times the host turned the card around. Per-window touches feed
the ``ops.host_touches`` histogram; the counters accumulate globally,
windowed or not. Re-entrant: an inner ``event_window`` joins the active
one. The reference holds each window to two touches (one submit run, one
read run); the port's relax loops sync once a hop, so its windows report
their true counts and nothing asserts the reference's (holding it needs the
whole window captured in a CUDA graph).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.telemetry.flight import get_flight_recorder

_TLS = threading.local()


class EventWindow:
    """Phase accounting for one event window."""

    __slots__ = (
        "tag", "dispatches", "blocking_syncs",
        "submit_phases", "read_phases", "_last", "t0",
    )

    def __init__(self, tag: str):
        self.tag = tag
        self.dispatches = 0
        self.blocking_syncs = 0
        self.submit_phases = 0
        self.read_phases = 0
        self._last: Optional[str] = None
        self.t0 = time.perf_counter()

    def _mark(self, phase: str) -> None:
        if self._last != phase:
            if phase == "submit":
                self.submit_phases += 1
            else:
                self.read_phases += 1
            self._last = phase

    @property
    def touches(self) -> int:
        return self.submit_phases + self.read_phases


def current_window() -> Optional[EventWindow]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def _retire(w: EventWindow) -> None:
    """Observe a popped window and hand it to the flight recorder. Runs
    OUTSIDE the window (stack already popped), so a deferred post-mortem
    dump is safe here."""
    reg = get_registry()
    reg.observe("ops.host_touches", float(w.touches))
    reg.observe(f"ops.host_touches.{w.tag}", float(w.touches))
    wall_ms = (time.perf_counter() - w.t0) * 1000.0
    get_flight_recorder().on_window(w.tag, wall_ms, w)


@contextmanager
def event_window(tag: str = "event") -> Iterator[EventWindow]:
    """Bracket one event. Joins an already-active window (same thread)
    instead of nesting, so the OUTERMOST caller owns the per-event touch
    observation."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    if stack:
        yield stack[-1]
        return
    w = EventWindow(tag)
    stack.append(w)
    try:
        yield w
    finally:
        stack.pop()
        _retire(w)


def count_dispatch(n: int = 1) -> None:
    """Record n kernel launches (one submit phase while consecutive)."""
    get_registry().counter_bump("ops.host_dispatches", n)
    w = current_window()
    if w is not None:
        w.dispatches += n
        w._mark("submit")


def note_blocking_sync() -> None:
    """Count one blocking device->host sync (one read phase while
    consecutive)."""
    get_registry().counter_bump("ops.blocking_syncs")
    w = current_window()
    if w is not None:
        w.blocking_syncs += 1
        w._mark("read")


def sync_flag(flag) -> bool:
    """``bool(flag)`` of a device scalar, counted as one blocking sync:
    the relax loops' per-hop convergence test."""
    note_blocking_sync()
    return bool(flag)


def reap_read(arr):
    """Materialize one readback on host as a numpy array by a blocking
    ``.cpu()``, counted as one blocking sync; a host array passes as it
    is."""
    note_blocking_sync()
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return arr
