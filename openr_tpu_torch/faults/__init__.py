"""Fault-injection harness and graceful-degradation supervisor.

Port note: a copy of ``openr_tpu/faults/__init__.py``; nothing left out.

``injector`` provides named, seedable injection points at the
pipeline's real seams; ``supervisor`` owns the HEALTHY → DEGRADED →
FALLBACK ladder walked by the route engine and Decision when those
seams fail for real.
"""

from openr_tpu_torch.faults.injector import (
    DeviceLostError,
    FaultInjected,
    FaultInjector,
    FaultSchedule,
    consume_fault,
    fault_point,
    get_injector,
    is_device_loss,
    register_fault_site,
)
from openr_tpu_torch.faults.supervisor import (
    DegradationSupervisor,
    HealthState,
    LadderExhausted,
)

__all__ = [
    "DegradationSupervisor",
    "DeviceLostError",
    "FaultInjected",
    "FaultInjector",
    "FaultSchedule",
    "HealthState",
    "consume_fault",
    "LadderExhausted",
    "fault_point",
    "get_injector",
    "is_device_loss",
    "register_fault_site",
]
