"""Fleet plane: placement, live tenant migration, hot-standby
failover.

- ``placement`` — weighted-occupancy SLO-class placement (torch-free)
  and the ``FLEET_COUNTERS`` table.
- ``journal`` — the adopted-publication ``FleetJournal`` + the
  ``JournalStreamer`` that feeds each service's hot standby
  (``fleet.journal_stream`` fault seam, ``fleet.replica_lag`` gauge).
- ``controller`` — ``ManagedService`` (primary + standby + stream)
  and ``FleetController`` (admit / migrate / promote / fail_over),
  with the ``fleet.promote`` seam on the takeover ladder.

Port note: a copy of ``openr_tpu/fleet/__init__.py``.
"""

from openr_tpu_torch.fleet.journal import (
    FAULT_JOURNAL_STREAM,
    FleetJournal,
    FleetRecord,
    JournalStreamer,
)
from openr_tpu_torch.fleet.placement import (
    FLEET_COUNTERS,
    FleetAdmissionError,
    PlacementPolicy,
    ServiceLoad,
    SLO_WEIGHT,
    placement_table,
)

# The controller pulls in the whole serve/ctrl stack, and ctrl/solver
# itself imports fleet.journal — eager re-export here would close an
# import cycle. PEP 562 lazy attribute access breaks it: the
# controller module only loads when someone asks for it.
_CONTROLLER_EXPORTS = (
    "FAULT_PROMOTE",
    "FleetController",
    "FleetCtrlHandler",
    "ManagedService",
)


def __getattr__(name):
    if name in _CONTROLLER_EXPORTS:
        from openr_tpu_torch.fleet import controller

        return getattr(controller, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = [
    "FAULT_JOURNAL_STREAM",
    "FAULT_PROMOTE",
    "FLEET_COUNTERS",
    "FleetAdmissionError",
    "FleetController",
    "FleetCtrlHandler",
    "FleetJournal",
    "FleetRecord",
    "JournalStreamer",
    "ManagedService",
    "PlacementPolicy",
    "SLO_WEIGHT",
    "ServiceLoad",
    "placement_table",
]
