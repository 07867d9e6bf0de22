"""Always-on device-time attribution with bounded overhead.

Port note: a port of ``openr_tpu/telemetry/profiler.py``. Where the
reference names a dispatch with ``jax.profiler.TraceAnnotation`` and
samples its device time with ``jax.block_until_ready``, the port's
``annotate(tag)`` opens ``torch.profiler.record_function(tag)`` and, on
the card, an NVTX range; and a sampled call's device time is the
elapsed time between two CUDA events on the current stream: ``start()``
records the first before the dispatch, ``on_dispatch`` the second after
it, and waits for it. Without a start event (a CPU tensor, or an
unsampled call) the host time stands in, as in the reference.

- every timed dispatch is wall-timed on the host (``ops.host_ms.<tag>``),
  and every ``sample_every``-th call per tag also waits for the card so
  its device time lands in ``ops.device_ms.<tag>``;
- call sites label dispatches (``labels(bucket=..., slo=...)``) so the
  sampled device time also lands per label
  (``ops.device_ms.by_<key>.<value>``);
- ``dispatch_accounting.event_window`` reports every window's wall clock
  and its attributed device time (``on_window``), so
  ``ops.host_overhead_ratio`` is a live gauge of window wall over
  attributed device time (``host_overhead_ratio``).

Disabled (``OPENR_PROFILE=0``) the plane costs one attribute read per
dispatch and nothing else.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from openr_tpu_torch.telemetry.registry import get_registry

_EWMA = 0.2  # weight of the newest device-time sample per tag


def _sanitize(value: Any) -> str:
    """fb303-safe label value: lowercase alnum + underscore."""
    s = str(value).lower()
    return "".join(c if c.isalnum() else "_" for c in s).strip("_") or "x"


class _TagState:
    __slots__ = ("calls", "device_ewma_ms")

    def __init__(self) -> None:
        self.calls = 0
        self.device_ewma_ms: Optional[float] = None


class Profiler:
    """Process-wide device-time attributor. All methods thread-safe."""

    def __init__(
        self,
        sample_every: Optional[int] = None,
        enabled: Optional[bool] = None,
    ) -> None:
        if sample_every is None:
            sample_every = int(os.environ.get("OPENR_PROFILE_SAMPLE", "8"))
        if enabled is None:
            enabled = os.environ.get("OPENR_PROFILE", "1") != "0"
        self.sample_every = max(1, sample_every)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._tags: Dict[str, _TagState] = {}
        self._tls = threading.local()
        self._warm = False
        self._annotation_cls: Any = None
        # recent (window_wall_ms, window_device_ms) pairs: the ratio
        # gauge reads these, bounded so it tracks current behaviour
        self._windows: deque = deque(maxlen=256)
        get_registry().gauge(
            "ops.host_overhead_ratio", self.host_overhead_ratio
        )

    # -- warmup marker ----------------------------------------------
    def mark_warm(self) -> None:
        """Callers declare warmup done; compiles after this point are
        anomalies (see flight.CompileAfterWarmupTrigger)."""
        self._warm = True

    @property
    def warm(self) -> bool:
        return self._warm

    # -- labels ------------------------------------------------------
    @contextmanager
    def labels(self, **kv: Any) -> Iterator[None]:
        """Attach label dimensions (bucket=..., slo=...) to every
        sampled dispatch inside the block. Thread-local; nests by
        overlay."""
        if not self.enabled:
            yield
            return
        prev = getattr(self._tls, "labels", None)
        merged = dict(prev or ())
        merged.update({k: _sanitize(v) for k, v in kv.items()})
        self._tls.labels = merged
        try:
            yield
        finally:
            self._tls.labels = prev

    def _active_labels(self) -> Optional[Dict[str, str]]:
        return getattr(self._tls, "labels", None)

    # -- profiler annotations ---------------------------------------
    @contextmanager
    def annotate(self, tag: str) -> Iterator[None]:
        """Name the enclosed dispatches ``tag`` on the profiler's
        timeline (``torch.profiler.record_function``) and, on the card,
        in an NVTX range; free when no profiler session is collecting."""
        if not self.enabled:
            yield
            return
        import torch

        nvtx = torch.cuda.is_available()
        with torch.profiler.record_function(tag):
            if nvtx:
                torch.cuda.nvtx.range_push(tag)
            try:
                yield
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()

    def start(self, tag: str, device: Any = None) -> Any:
        """A CUDA event recorded on ``device``'s current stream when the
        next call of ``tag`` will be sampled and ``device`` is a card,
        else None. Pass it to ``on_dispatch``."""
        if not self.enabled or device is None:
            return None
        import torch

        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        with self._lock:
            st = self._tags.get(tag)
            calls = st.calls if st is not None else 0
        if self.sample_every != 1 and (calls + 1) % self.sample_every != 1:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    # -- per-dispatch attribution -----------------------------------
    def on_dispatch(
        self, tag: str, out: Any, host_ms: float, start: Any = None
    ) -> float:
        """Record one dispatch's host wall time; on sampled calls also
        wait for the card and record measured device time (the CUDA
        events from ``start`` to now, else the host time plus the wait).
        Returns the best device-time estimate for this call (measured,
        else the tag's EWMA, else the host time). ``out`` is unused: the
        events time the stream, not one tensor."""
        del out
        if not self.enabled:
            return host_ms
        reg = get_registry()
        reg.observe(f"ops.host_ms.{tag}", host_ms)
        with self._lock:
            st = self._tags.get(tag)
            if st is None:
                st = self._tags[tag] = _TagState()
            st.calls += 1
            sampled = (st.calls % self.sample_every) == 1 or \
                self.sample_every == 1
            ewma = st.device_ewma_ms
        if not sampled:
            return ewma if ewma is not None else host_ms
        if start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            device_ms = float(start.elapsed_time(end))
        else:
            device_ms = host_ms
        reg.counter_bump("ops.profile_samples")
        reg.observe(f"ops.device_ms.{tag}", device_ms)
        labels = self._active_labels()
        if labels:
            for key, val in labels.items():
                reg.observe(f"ops.device_ms.by_{key}.{val}", device_ms)
        with self._lock:
            st = self._tags[tag]
            if st.device_ewma_ms is None:
                st.device_ewma_ms = device_ms
            else:
                st.device_ewma_ms = (
                    (1.0 - _EWMA) * st.device_ewma_ms + _EWMA * device_ms
                )
        return device_ms

    # -- per-window attribution -------------------------------------
    def on_window(self, tag: str, wall_ms: float, device_ms: float) -> None:
        """One event window retired: its host wall clock and the device
        time attributed inside it (``dispatch_accounting.attribute_stage``).
        Feeds the live ``ops.host_overhead_ratio`` gauge."""
        if not self.enabled or device_ms <= 0.0:
            return
        with self._lock:
            self._windows.append((wall_ms, device_ms))

    def host_overhead_ratio(self) -> float:
        """Window wall time over attributed device time across the
        recent windows; 0.0 before any window carried device time."""
        with self._lock:
            pairs = list(self._windows)
        wall = sum(p[0] for p in pairs)
        dev = sum(p[1] for p in pairs)
        return round(wall / dev, 4) if dev > 0.0 else 0.0

    # -- export ------------------------------------------------------
    def attribution(self) -> Dict[str, Dict[str, float]]:
        """Per-tag measured stage costs: ``{tag: {device_ms_p50,
        device_ms_p99, host_ms_p50, host_ms_p99, calls,
        device_samples}}`` read straight from the registry histograms
        (label histograms ``by_*`` excluded)."""
        hists = get_registry().histograms()
        out: Dict[str, Dict[str, float]] = {}
        for name, h in hists.items():
            for prefix, dev in (("ops.device_ms.", True),
                                ("ops.host_ms.", False)):
                if not name.startswith(prefix):
                    continue
                tag = name[len(prefix):]
                if tag.startswith("by_"):
                    continue
                row = out.setdefault(tag, {})
                kind = "device_ms" if dev else "host_ms"
                row[f"{kind}_p50"] = round(h.percentile(0.50), 4)
                row[f"{kind}_p99"] = round(h.percentile(0.99), 4)
                if dev:
                    row["device_samples"] = float(h.count)
                else:
                    row["calls"] = float(h.count)
        return out


_PROFILER: Optional[Profiler] = None
_PROFILER_LOCK = threading.Lock()


def get_profiler() -> Profiler:
    global _PROFILER
    if _PROFILER is None:
        with _PROFILER_LOCK:
            if _PROFILER is None:
                _PROFILER = Profiler()
    return _PROFILER


def reset_profiler(**kwargs: Any) -> Profiler:
    """Tests / smoke gates: replace the singleton (re-reads env unless
    overridden by kwargs)."""
    global _PROFILER
    with _PROFILER_LOCK:
        _PROFILER = Profiler(**kwargs)
    return _PROFILER
