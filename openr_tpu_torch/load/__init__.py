"""Service plane: sustained-load generation + admission/backpressure.

Two halves (see docs/ARCHITECTURE.md "Service plane"):

- ``admission`` — daemon-side backpressure: the rate-adaptive debounce
  controller and shed-by-coalescing publication admission Decision wires
  into its consume path.
- ``generator`` / ``harness`` — the load half: a seedable open-loop
  KvStore event generator and the closed-loop harness that drives the
  real KvStore→Decision→Fib pipeline at a target events/s, measures
  p50/p95/p99 e2e from the trace spine, and binary-searches the max
  sustainable rate against a p99 SLO.

``harness`` is imported lazily (``openr_tpu_torch.load.harness``) because it
depends on the Decision/Fib modules; importing this package from inside
``decision`` must stay cycle-free.

``multi_client`` (the multi-process client fleet of the solver service)
is imported as a submodule: its client path is torch-free, its oracles
import torch lazily.

Port note: mirrors ``openr_tpu/load/__init__.py``.
"""

from openr_tpu_torch.load.admission import (
    AdmissionConfig,
    AdmissionControl,
    CoalescedBatch,
    DebounceController,
    coalesce_publications,
)
from openr_tpu_torch.load.generator import (
    FAULT_LOAD_GENERATOR,
    EventMix,
    LoadEvent,
    LoadGenerator,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionControl",
    "CoalescedBatch",
    "DebounceController",
    "coalesce_publications",
    "FAULT_LOAD_GENERATOR",
    "EventMix",
    "LoadEvent",
    "LoadGenerator",
]
