"""Structured end-to-end traces over the PerfEvents chain.

Port note: a copy of ``openr_tpu/telemetry/trace.py``; nothing left out.

A ``Trace`` is born when KvStore accepts a key-set that produces a
publication, rides the in-process ``Publication`` /
``DecisionRouteUpdate`` objects through Decision's debounce and solve,
and is ``finish()``-ed by Fib after route programming. Each stage
contributes a timed ``Span``; spans may nest (the ELL warm/cold solve
span sits inside Decision's rebuild span).

Design points:

- Only *completed* traces enter the tracer's bounded ring. An
  in-flight trace lives solely on the carrying queue object, so a
  publication that Decision drops (no route impact) costs nothing and
  cannot leak.
- Deep call sites (``ops.spf_sparse``) must not know about queue
  plumbing: the tracer keeps a per-thread *active trace* stack
  (``activate()``), and ``span_active()`` attaches to whatever trace
  the enclosing module activated — a no-op when none is.
- ``finish()`` validates that every span is closed and properly
  nested; violations bump ``telemetry.traces_unclosed_spans`` /
  ``telemetry.traces_bad_nesting`` instead of raising, and the trace
  is kept (marked) so the smoke gate can fail loudly.
- Export: Chrome-trace JSON (``chrome://tracing`` / Perfetto, ``ph:X``
  complete events, µs) or JSONL (one trace per line).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from openr_tpu_torch.analysis.annotations import thread_confined
from openr_tpu_torch.telemetry.registry import get_registry

_trace_ids = itertools.count(1)


class Span:
    """One timed stage of a trace. ``dur_ms`` is perf_counter-based;
    ``ts_ms`` anchors the span on the wall clock for export."""

    __slots__ = ("name", "ts_ms", "dur_ms", "attrs", "_t0", "depth")

    def __init__(self, name: str, depth: int = 0) -> None:
        self.name = name
        self.ts_ms = time.time() * 1000.0
        self._t0 = time.perf_counter()
        self.dur_ms: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        self.depth = depth

    @property
    def closed(self) -> bool:
        return self.dur_ms is not None

    def end(self, **attrs: Any) -> "Span":
        if self.dur_ms is None:
            self.dur_ms = (time.perf_counter() - self._t0) * 1000.0
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "ts_ms": round(self.ts_ms, 3),
            "dur_ms": round(self.dur_ms, 4) if self.closed else None,
            "depth": self.depth,
            "attrs": self.attrs,
        }


@thread_confined("owner", "spans", "_stack", "complete")
class Trace:
    """An ordered list of spans sharing one trace id. Not thread-safe
    by itself — a trace is owned by exactly one module thread at a
    time (it travels through the queues with the payload); the
    ``"owner"`` confinement above states exactly that hand-off
    discipline for the shared-state rule."""

    __slots__ = ("trace_id", "origin", "ts_ms", "spans", "_stack", "complete")

    def __init__(self, origin: str = "kvstore.publish") -> None:
        self.trace_id = next(_trace_ids)
        self.origin = origin
        self.ts_ms = time.time() * 1000.0
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self.complete = False

    def begin_span(self, name: str, **attrs: Any) -> Span:
        span = Span(name, depth=len(self._stack))
        span.attrs.update(attrs)
        self.spans.append(span)
        self._stack.append(span)
        return span

    def end_span(self, span: Span, **attrs: Any) -> Span:
        span.end(**attrs)
        # pop through the stack to this span; anything above it left
        # open is a nesting bug the finish() validator will count
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        return span

    def instant(self, name: str, **attrs: Any) -> Span:
        """A zero-duration marker (e.g. the publication itself)."""
        span = Span(name, depth=len(self._stack))
        span.attrs.update(attrs)
        span.dur_ms = 0.0
        self.spans.append(span)
        return span

    @property
    def e2e_ms(self) -> Optional[float]:
        if not self.spans:
            return None
        ends = [s.ts_ms + s.dur_ms for s in self.spans if s.closed]
        if not ends:
            return None
        return max(ends) - self.ts_ms

    def well_formed(self) -> bool:
        """Every span closed and the open/close order properly nested
        (a child span never outlives its parent's duration window)."""
        if any(not s.closed for s in self.spans):
            return False
        if self._stack:
            return False
        for i, s in enumerate(self.spans):
            for t in self.spans[i + 1 :]:
                if t.depth > s.depth and t.ts_ms < s.ts_ms + s.dur_ms:
                    # t starts inside s: it must also end inside s
                    # (tolerance for clock granularity)
                    if t.ts_ms + t.dur_ms > s.ts_ms + s.dur_ms + 0.5:
                        return False
        return True

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "origin": self.origin,
            "ts_ms": round(self.ts_ms, 3),
            "e2e_ms": round(self.e2e_ms, 4) if self.e2e_ms is not None else None,
            "complete": self.complete,
            "spans": [s.to_dict() for s in self.spans],
        }


class Tracer:
    """Process-wide sink for completed traces + per-thread active-trace
    stack for deep call sites.

    The ring depth defaults from ``OPENR_TRACE_RING`` (256): at 200+
    events/s the default overflows in ~1 s, which is why every retired
    trace's overflow is counted (``telemetry.trace_ring_overflows``)
    and a compact summary also lands in the flight recorder's much
    cheaper ring."""

    def __init__(self, ring: Optional[int] = None) -> None:
        if ring is None:
            ring = int(os.environ.get("OPENR_TRACE_RING", "256"))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, ring))
        self._tls = threading.local()
        # finish listeners: the sustained-load harness samples e2e per
        # retired trace through these instead of polling the ring (the
        # 256-deep ring overflows in ~1s at 200+ events/s)
        self._finish_listeners: List[Any] = []

    # -- lifecycle --------------------------------------------------
    def start(self, origin: str = "kvstore.publish", **attrs: Any) -> Trace:
        t = Trace(origin)
        t.instant(origin, **attrs)
        get_registry().counter_bump("telemetry.traces_started")
        return t

    def finish(self, trace: Optional[Trace], ok: bool = True) -> None:
        """Validate and retire a trace into the export ring."""
        if trace is None:
            return
        reg = get_registry()
        unclosed = sum(1 for s in trace.spans if not s.closed)
        if unclosed:
            reg.counter_bump("telemetry.traces_unclosed_spans", unclosed)
        elif not trace.well_formed():
            reg.counter_bump("telemetry.traces_bad_nesting")
        trace.complete = ok and unclosed == 0
        reg.counter_bump("telemetry.traces_finished")
        e2e = trace.e2e_ms
        if trace.complete and e2e is not None:
            reg.observe("convergence.e2e_ms", e2e)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                reg.counter_bump("telemetry.trace_ring_overflows")
            self._ring.append(trace)
            listeners = list(self._finish_listeners)
        # compact summary into the flight recorder's deeper ring — the
        # evidence that survives this ring's ~1 s overflow horizon.
        # Lazy import: flight imports this module for chrome export.
        from openr_tpu_torch.telemetry.flight import get_flight_recorder

        fr = get_flight_recorder()
        if fr.enabled:
            fr.note(
                "trace",
                origin=trace.origin,
                trace_id=trace.trace_id,
                e2e_ms=round(e2e, 4) if e2e is not None else None,
                complete=trace.complete,
                spans=[s.name for s in trace.spans],
            )
        for fn in listeners:
            try:
                fn(trace, ok)
            except Exception:  # noqa: BLE001 - observers never poison Fib
                reg.counter_bump("telemetry.finish_listener_errors")

    def add_finish_listener(self, fn) -> None:
        """Register ``fn(trace, ok)`` called after every finish(). Runs
        on the finishing thread (Fib's event base) — keep it cheap."""
        with self._lock:
            self._finish_listeners.append(fn)

    def remove_finish_listener(self, fn) -> None:
        with self._lock:
            if fn in self._finish_listeners:
                self._finish_listeners.remove(fn)

    # -- thread-local activation ------------------------------------
    def activate(self, trace: Optional[Trace]) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(trace)

    def deactivate(self) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack.pop()

    def active(self) -> Optional[Trace]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def span_active(self, name: str, **attrs: Any) -> Optional[Span]:
        """Open a span on the current thread's active trace (None if no
        trace is active — callers must pass the result back through
        ``end_span_active``, which tolerates None)."""
        t = self.active()
        return t.begin_span(name, **attrs) if t is not None else None

    def end_span_active(self, span: Optional[Span], **attrs: Any) -> None:
        t = self.active()
        if t is not None and span is not None:
            t.end_span(span, **attrs)

    # -- export -----------------------------------------------------
    def traces(self, limit: int = 0) -> List[Trace]:
        with self._lock:
            out = list(self._ring)
        return out[-limit:] if limit else out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def jsonl(self, limit: int = 0) -> str:
        return "\n".join(
            json.dumps(t.to_dict()) for t in self.traces(limit)
        )

    def chrome_trace(self, limit: int = 0) -> Dict[str, Any]:
        """Chrome-trace / Perfetto ``traceEvents`` document. One "pid"
        per trace so concurrent churn events render as parallel rows;
        span depth maps to "tid" to keep nesting visible."""
        events: List[Dict[str, Any]] = []
        for t in self.traces(limit):
            for s in t.spans:
                events.append(
                    {
                        "name": s.name,
                        "cat": t.origin,
                        "ph": "X",
                        "pid": t.trace_id,
                        "tid": s.depth,
                        "ts": s.ts_ms * 1000.0,
                        "dur": (s.dur_ms or 0.0) * 1000.0,
                        "args": dict(s.attrs),
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER
