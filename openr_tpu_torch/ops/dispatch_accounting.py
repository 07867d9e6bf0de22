"""Host-touch accounting for the port's route builds.

Port note: a port of the part of ``openr_tpu/ops/dispatch_accounting.py``
that the port's route-build path calls. Every host interaction with the
card on that path reports here:

- ``count_dispatch()`` — a hand-written kernel was launched (its wrapper
  calls it beside the kernel's ``LAUNCHES`` count): ``ops.host_dispatches``;
- ``sync_flag(flag)`` — ``bool()`` of a device scalar, the relax loops'
  per-hop convergence test: one ``ops.blocking_syncs``;
- ``kick_async(t)`` — stage a readback: a ``non_blocking`` copy into
  pinned host memory with a CUDA event at its end (``ops.staging.
  Readback``), returned as the handle to reap; not a host touch;
- ``reap_read(x, kicked=...)`` — materialize a readback as numpy. A
  handle from ``kick_async`` with ``kicked=True`` waits on its event and
  counts one ``ops.async_reaps``; anything else is a blocking sync (a
  tensor by ``.cpu()``, or a ``kick_async`` handle waited on at once,
  which reads through pinned memory): one ``ops.blocking_syncs``;
- ``note_blocking_sync()`` — any other blocking device-to-host sync, such
  as the wait in ``ops.staging.Readback.reap``.

``pipeline_drain(tag)`` brackets one pipelined burst of event windows
(the route engine's ``churn_burst``): every ``event_window`` inside it
joins it, and its retirement feeds ``ops.touches_per_drain`` and
``ops.windows_per_drain``. ``note_window``, ``note_pipelined_dispatch``
and ``note_overlapped_reap`` witness the burst's folded windows, its
submits while an earlier window's reap is in flight, and the reaps
drained inside a successor's window.

``event_window(tag)`` brackets one event (Decision's ``decision.rebuild``,
the route engine's ``churn``): consecutive dispatches collapse into one
submit phase and consecutive syncs into one read phase, so ``touches =
submit_phases + read_phases`` is the number of times the host turned the
card around. Per-window touches feed the ``ops.host_touches`` histogram;
the counters accumulate globally, windowed or not. Re-entrant: an inner
``event_window`` joins the active one. ``attribute_stage`` folds a
profiled dispatch's host and device ms into the active window, and a
retired window hands its wall clock and device ms to the profiler
(``Profiler.on_window``, the ``ops.host_overhead_ratio`` gauge).

The relax loops keep their convergence flag and hop count on the card
(``ops/relax_loop.py``): an eager loop reads them once a chunk of hops
(``sync_count``), and an engine body dispatched through the executable
cache (``ops/aot_cache.py``) carries them in the meta row it already reads
back, so a warm engine event holds the reference's two touches (one submit
run, one read run) and, deferred, no blocking sync.

``capturing()`` brackets a capture of the executable cache: inside it
``count_dispatch`` records into the capture's tally instead of the counters
(the cache adds the tally on every replay), and any host sync raises
``HostSyncInCapture``: a captured body never turns the card around.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.telemetry.flight import get_flight_recorder
from openr_tpu_torch.telemetry.profiler import get_profiler

_TLS = threading.local()


class EventWindow:
    """Phase accounting for one event window."""

    __slots__ = (
        "tag", "dispatches", "blocking_syncs", "async_reaps",
        "submit_phases", "read_phases", "_last", "t0", "device_ms", "stages",
        "windows", "drain",
    )

    def __init__(self, tag: str, drain: bool = False):
        self.tag = tag
        self.dispatches = 0
        self.blocking_syncs = 0
        self.async_reaps = 0
        self.submit_phases = 0
        self.read_phases = 0
        self._last: Optional[str] = None
        self.t0 = time.perf_counter()
        # device-time attribution (fed by attribute_stage): total device
        # ms inside this window and per-tag [calls, host ms, device ms]
        self.device_ms = 0.0
        self.stages: Dict[str, List[float]] = {}
        # logical event windows folded into this one (joins bump it);
        # a pipeline_drain bracket also feeds the per-drain histograms
        self.windows = 1
        self.drain = drain

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
    """Observe a popped window and hand it to the profiling plane. Runs
    OUTSIDE the window (stack already popped), so a deferred post-mortem
    dump is safe here."""
    reg = get_registry()
    reg.observe("ops.host_touches", float(w.touches))
    reg.observe(f"ops.host_touches.{w.tag}", float(w.touches))
    if w.drain:
        reg.counter_bump("ops.pipeline_drains")
        reg.observe("ops.touches_per_drain", float(w.touches))
        reg.observe("ops.windows_per_drain", float(w.windows))
    wall_ms = (time.perf_counter() - w.t0) * 1000.0
    get_flight_recorder().on_window(w.tag, wall_ms, w)
    get_profiler().on_window(w.tag, wall_ms, w.device_ms)


@contextmanager
def event_window(tag: str = "event") -> Iterator[EventWindow]:
    """Bracket one event. Joins an already-active window (same thread)
    instead of nesting, so the OUTERMOST caller owns the per-event touch
    observation."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    if stack:
        stack[-1].windows += 1
        yield stack[-1]
        return
    w = EventWindow(tag)
    stack.append(w)
    try:
        yield w
    finally:
        stack.pop()
        _retire(w)


@contextmanager
def pipeline_drain(tag: str = "drain") -> Iterator[EventWindow]:
    """Bracket one pipelined burst of event windows: a drain-flagged
    window that every ``event_window`` inside it joins. Joining an
    already-active window degrades to that window."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    if stack:
        yield stack[-1]
        return
    w = EventWindow(tag, drain=True)
    w.windows = 0  # only joined event windows count toward the burst
    stack.append(w)
    try:
        yield w
    finally:
        stack.pop()
        _retire(w)


def note_window(n: int = 1) -> None:
    """Count ``n`` logical event windows folded into the active window
    or drain without opening a join. No-op outside a window."""
    w = current_window()
    if w is not None:
        w.windows += n


def note_pipelined_dispatch(depth: int = 2) -> None:
    """Witness a dispatch submitted while an earlier window's reap was
    still in flight; ``depth`` windows are then in flight."""
    reg = get_registry()
    reg.counter_bump("ops.pipelined_dispatches")
    reg.observe("ops.pipeline_depth", float(depth))


def note_overlapped_reap() -> None:
    """Witness an earlier window's staged reap drained inside a
    successor window."""
    get_registry().counter_bump("ops.overlapped_reaps")


class HostSyncInCapture(RuntimeError):
    """A host sync was asked for inside a capture of the executable cache."""


class CaptureTally:
    """What one capture saw: dispatches and kernel launches by name."""

    __slots__ = ("dispatches", "launches")

    def __init__(self) -> None:
        self.dispatches = 0
        self.launches: Dict[str, int] = {}


def current_capture() -> Optional[CaptureTally]:
    return getattr(_TLS, "capture", None)


@contextmanager
def capturing() -> Iterator[CaptureTally]:
    """Bracket one capture on this thread; yields its tally."""
    prev = current_capture()
    tally = _TLS.capture = CaptureTally()
    try:
        yield tally
    finally:
        _TLS.capture = prev


def _refuse_in_capture(what: str) -> None:
    if current_capture() is not None:
        raise HostSyncInCapture(f"{what} inside a capture")


def attribute_stage(tag: str, host_ms: float, device_ms: float) -> None:
    """Fold one profiled dispatch into the active window's device-time
    attribution (no-op outside a window). Called by the executable cache
    for every timed call; leaves the touch accounting as it is."""
    w = current_window()
    if w is None:
        return
    w.device_ms += device_ms
    s = w.stages.get(tag)
    if s is None:
        w.stages[tag] = [1, host_ms, device_ms]
    else:
        s[0] += 1
        s[1] += host_ms
        s[2] += device_ms


def count_dispatch(n: int = 1) -> None:
    """Record n kernel launches (one submit phase while consecutive).
    Inside a capture they go to the capture's tally instead."""
    tally = current_capture()
    if tally is not None:
        tally.dispatches += n
        return
    get_registry().counter_bump("ops.host_dispatches", n)
    w = current_window()
    if w is not None:
        w.dispatches += n
        w._mark("submit")


def note_blocking_sync() -> None:
    """Count one blocking device->host sync (one read phase while
    consecutive)."""
    _refuse_in_capture("a blocking sync")
    get_registry().counter_bump("ops.blocking_syncs")
    w = current_window()
    if w is not None:
        w.blocking_syncs += 1
        w._mark("read")


def sync_flag(flag) -> bool:
    """``bool(flag)`` of a device scalar, counted as one blocking sync."""
    note_blocking_sync()
    return bool(flag)


def sync_count(count) -> int:
    """``int(count)`` of a device scalar, counted as one blocking sync: a
    relax loop's changed-hop count, read once a chunk of hops."""
    note_blocking_sync()
    return int(count)


def kick_async(arr):
    """Stage a device-to-host copy of tensor ``arr`` and return its
    handle (an ``ops.staging.Readback``: on the card a ``non_blocking``
    copy into pinned host memory and a CUDA event, never a pageable
    ``.cpu()``); reap it with ``reap_read(handle, kicked=True)``. Not a
    host touch. A host (numpy) array passes through as it is."""
    _refuse_in_capture("a readback")
    if not hasattr(arr, "detach"):
        return arr
    from openr_tpu_torch.ops.staging import Readback

    return Readback(arr)


def reap_read(arr, kicked: bool = False):
    """Materialize one readback on host as a numpy array. A
    ``kick_async`` handle with ``kicked=True`` waits for its staged copy
    to land: one ``ops.async_reaps``. Anything else is a blocking sync
    (a tensor by a blocking ``.cpu()``): one ``ops.blocking_syncs``. A
    host array passes as it is."""
    from openr_tpu_torch.ops.staging import Readback

    _refuse_in_capture("a readback")
    w = current_window()
    if kicked and isinstance(arr, Readback):
        get_registry().counter_bump("ops.async_reaps")
        if w is not None:
            w.async_reaps += 1
            w._mark("read")
        return arr.wait()
    note_blocking_sync()
    if isinstance(arr, Readback):
        return arr.wait()
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return arr
