"""SLO classes for the solver service's continuous-batching scheduler.

Three classes, inference-server style: ``premium`` rides the front of
every wave (its pending requests preempt lower classes when a wave's
admission budget fills), ``standard`` is the default, and ``bulk``
absorbs whatever slots the higher classes leave vacant. All three
share the 100 ms p99 latency objective for the CPU smoke gate —
the classes differ in *ordering under contention*, not in the target,
so the acceptance check is premium p99 <= standard p99 under a
mixed-class storm rather than absolute numbers per class.

Port note: a copy of ``openr_tpu/serve/slo.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from openr_tpu_torch.ops.world_batch import SLO_CLASSES, TENANCY_COUNTERS


@dataclass(frozen=True)
class SloClass:
    """One admission class: lower ``priority`` is admitted earlier;
    ``target_p99_ms`` is the per-class latency objective the breach
    triage recipe (RUNBOOK) and the serve smoke gate read."""

    name: str
    priority: int
    target_p99_ms: float


SLO_TABLE: Dict[str, SloClass] = {
    "premium": SloClass("premium", 0, 100.0),
    "standard": SloClass("standard", 1, 100.0),
    "bulk": SloClass("bulk", 2, 100.0),
}

assert tuple(SLO_TABLE) == SLO_CLASSES


def slo_of(name: str) -> SloClass:
    """Class record for ``name``; unknown names are an error (the
    tenant plane enforces the same closed set in ``set_slo_class``)."""
    return SLO_TABLE[name]


def order_requests(
    requests: Sequence[Tuple[str, int]],
) -> List[Tuple[str, int]]:
    """Wave admission order for ``[(slo_name, seq), ...]`` pending
    requests: (class priority, arrival seq). A higher-class request
    placed ahead of an EARLIER-arrived lower-class one is a
    preemption — counted in ``tenancy.wave_preemptions`` so queue
    jumps are never silent."""
    ordered = sorted(
        requests, key=lambda r: (SLO_TABLE[r[0]].priority, r[1])
    )
    preemptions = 0
    for pos, (name, seq) in enumerate(ordered):
        pri = SLO_TABLE[name].priority
        for later in ordered[pos + 1 :]:
            if SLO_TABLE[later[0]].priority > pri and later[1] < seq:
                preemptions += 1
    if preemptions:
        TENANCY_COUNTERS["wave_preemptions"] += preemptions
    return ordered
