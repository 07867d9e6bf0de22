"""Process-wide observability spine: counters, gauges, latency
histograms, and end-to-end trace spans.

Three pieces, one export surface:

- ``registry.py``: a thread-safe fb303-style metric registry. Modules
  register dotted-name counters/gauges/histograms; ``snapshot()``
  flattens everything (histograms expand to ``.p50/.p95/.p99/.max/
  .avg/.count``) into the dict served by ``OpenrCtrl.get_counters``
  and ``breeze monitor counters``.
- ``trace.py``: structured spans over the PerfEvents chain. A trace is
  born at KvStore publication, rides the Publication/RouteUpdate
  objects through Decision and Fib, and lands in a bounded ring
  exportable as Chrome-trace JSON or JSONL.
- ``profiler.py``: always-on device-time attribution — measured
  ``ops.device_ms.<tag>`` / ``ops.host_ms.<tag>`` per dispatch tag.
- ``flight.py``: the flight recorder — a lock-cheap activity ring that
  survives trace-ring overflow, with anomaly triggers that freeze it
  and dump post-mortem bundles.

Port note: a copy of ``openr_tpu/telemetry/__init__.py`` without
``jax_hooks.py`` (the port compiles no jit programs); ``profiler.py`` is a
port.
"""

from openr_tpu_torch.telemetry.registry import (  # noqa: F401
    CounterDict,
    Histogram,
    Registry,
    get_registry,
)
from openr_tpu_torch.telemetry.trace import (  # noqa: F401
    Span,
    Trace,
    Tracer,
    get_tracer,
)
from openr_tpu_torch.telemetry.profiler import (  # noqa: F401
    Profiler,
    get_profiler,
    reset_profiler,
)
from openr_tpu_torch.telemetry.flight import (  # noqa: F401
    BUNDLE_SCHEMA,
    CompileAfterWarmupTrigger,
    CounterDeltaTrigger,
    FlightRecorder,
    P99BreachTrigger,
    fnv1a,
    get_flight_recorder,
    install_default_triggers,
    load_bundle,
    reset_flight_recorder,
)

__all__ = [
    "BUNDLE_SCHEMA",
    "CompileAfterWarmupTrigger",
    "CounterDeltaTrigger",
    "CounterDict",
    "FlightRecorder",
    "Histogram",
    "P99BreachTrigger",
    "Profiler",
    "Registry",
    "Span",
    "Trace",
    "Tracer",
    "fnv1a",
    "get_flight_recorder",
    "get_profiler",
    "get_registry",
    "get_tracer",
    "install_default_triggers",
    "load_bundle",
    "reset_flight_recorder",
    "reset_profiler",
]
