"""Adopted-publication journal stream: the hot-standby's feed.

DeltaPath's framing (PAPERS.md) made the adopted-publication journal
the system of record; the fleet plane leans on that. Every mutation a
primary service adopts for a tenant — register, world update, detach —
is appended here as a ``FleetRecord``; a ``JournalStreamer`` thread
ships the un-shipped suffix to the service's standby over the ctrl
wire and tracks how far the standby has APPLIED (`fleet.replica_lag`,
bounded by the stream cadence).

The hazard rule this module exists to make enforceable: **never
promote a standby past an un-shipped journal suffix.** The suffix is
computed by the same ``state.plane.journal_suffix`` fold recovery
uses; a planned promotion flushes it to empty first, and a crash
promotion (primary unreachable, nothing left to flush) surrenders it
*counted* (``fleet.promotion_unshipped``), never silently.

The ``fleet.journal_stream`` fault seam sits on the ship path: an
armed schedule makes a ship attempt fail exactly like a wire fault —
the suffix stays queued, the lag gauge grows, the error is counted,
and the streamer retries under its jittered backoff. Nothing is
dropped and nothing is silent, which is what the chaos fleet leg
verifies.

Port note: a copy of ``openr_tpu/fleet/journal.py``. It keeps its own
copy of ``journal_suffix`` (the reference's ``state/plane.py``) until the
state plane is ported.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from openr_tpu_torch.analysis.annotations import guarded_by, runs_on
from openr_tpu_torch.faults import (
    FaultInjected,
    fault_point,
    register_fault_site,
)
from openr_tpu_torch.fleet.placement import FLEET_COUNTERS
from openr_tpu_torch.telemetry import get_registry as _get_registry
from openr_tpu_torch.utils.eventbase import ExponentialBackoff


def journal_suffix(records, applied_seq: int) -> list:
    """The un-applied tail of an ordered journal: every record whose
    ``seq`` is strictly past ``applied_seq``. The reference shares this
    one definition with its state plane's recovery; the fleet plane's
    replica stream reads it as the never-promote-past-an-un-shipped-
    suffix hazard rule: "this list must be empty, or its loss consciously
    counted, before a standby may take over"."""
    return [
        rec for rec in records
        if rec is not None and rec.seq > applied_seq
    ]

FAULT_JOURNAL_STREAM = register_fault_site("fleet.journal_stream")


class FleetRecord:
    """One adopted tenant mutation, in ship order. ``payload`` is
    jsonable (world blobs ride as b64 strings, same as the client
    wire) so a record crosses the ctrl transport unmodified."""

    __slots__ = ("seq", "kind", "tenant_id", "payload")

    KINDS = ("register", "update", "detach")

    def __init__(self, seq: int, kind: str, tenant_id: str,
                 payload: Dict[str, object]):
        if kind not in self.KINDS:
            raise ValueError(f"unknown journal record kind: {kind!r}")
        self.seq = seq
        self.kind = kind
        self.tenant_id = tenant_id
        self.payload = payload

    def to_wire(self) -> Dict[str, object]:
        return {
            "seq": self.seq,
            "kind": self.kind,
            "tenant_id": self.tenant_id,
            "payload": self.payload,
        }

    @staticmethod
    def from_wire(frame: Dict[str, object]) -> "FleetRecord":
        return FleetRecord(
            int(frame["seq"]), str(frame["kind"]),
            str(frame["tenant_id"]), dict(frame["payload"]),
        )


@guarded_by("FleetJournal._lock", "_records", "_next_seq")
class FleetJournal:
    """Append-only, totally ordered, bounded. The bound is a safety
    valve against a standby that is down for good — when the tail
    outgrows ``cap`` the oldest records are truncated (counted
    ``fleet.journal_truncations``) and a standby behind the truncation
    horizon must resync via a full snapshot, exactly like a KvStore
    peer behind the checkpoint."""

    def __init__(self, cap: int = 8192):
        self._lock = threading.Lock()
        self._records: List[FleetRecord] = []
        self._next_seq = 1
        self._cap = max(16, cap)
        self._reg = _get_registry()

    def append(self, kind: str, tenant_id: str,
               payload: Dict[str, object]) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._records.append(
                FleetRecord(seq, kind, tenant_id, payload)
            )
            if len(self._records) > self._cap:
                drop = len(self._records) - self._cap
                del self._records[:drop]
                self._reg.counter_bump(
                    "fleet.journal_truncations", drop
                )
        FLEET_COUNTERS["journal_records"] += 1
        return seq

    def suffix(self, applied_seq: int) -> List[FleetRecord]:
        """The un-applied tail past ``applied_seq`` — the recovery
        fold's suffix rule applied to the replica stream."""
        with self._lock:
            return journal_suffix(self._records, applied_seq)

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1

    @property
    def horizon_seq(self) -> int:
        """Oldest retained seq (a standby applied below this must
        snapshot-resync)."""
        with self._lock:
            return self._records[0].seq if self._records else self._next_seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


@runs_on("fleet-streamer")
class JournalStreamer:
    """Ships a primary's journal suffix to its standby.

    ``ship`` is injected by the controller: it takes a list of wire
    records and returns the standby's new APPLIED seq (the standby
    applies in order and answers with how far it got — idempotent on
    replayed prefixes, so a retry after a half-failed ship is safe).
    One thread per (primary, standby) pair; wire faults and the
    ``fleet.journal_stream`` seam both land on the same counted-and-
    retried path."""

    def __init__(
        self,
        journal: FleetJournal,
        ship: Callable[[List[Dict]], int],
        interval_s: float = 0.02,
        backoff_min_s: float = 0.02,
        backoff_max_s: float = 0.5,
        name: str = "fleet-streamer",
    ):
        self._journal = journal
        self._ship = ship
        self._interval_s = interval_s
        self._backoff = ExponentialBackoff(
            backoff_min_s, backoff_max_s, jitter=True, seed=0xF1EE7
        )
        self._wake = threading.Event()
        self._stop = False
        self._shipped_seq = 0
        self._lag_name = f"fleet.replica_lag.{name}"
        self._reg = _get_registry()
        # the literal thread name doubles as the thread's role label for
        # the shared-state rule — it must match this class's @runs_on
        # role so the stream loop and the control methods (stop/flush,
        # also pinned to that role) are one role, not two
        self._thread = threading.Thread(
            target=self._run, name="fleet-streamer", daemon=True
        )

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "JournalStreamer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    # -- introspection ----------------------------------------------

    @property
    def shipped_seq(self) -> int:
        return self._shipped_seq

    def lag(self) -> int:
        """Journal records the standby has not applied yet — the
        replica-lag gauge's value, bounded by the stream cadence when
        the wire is healthy."""
        return max(0, self._journal.last_seq - self._shipped_seq)

    def unshipped(self) -> List[FleetRecord]:
        """The hazard suffix: records a promotion-at-applied-seq would
        surrender. Empty is the planned-promotion precondition."""
        return self._journal.suffix(self._shipped_seq)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the suffix is empty (True) or the deadline
        passes (False). The planned-promotion barrier."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        self._wake.set()
        while self.lag() > 0:
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.005)
        return True

    # -- stream loop -------------------------------------------------

    def _run(self) -> None:
        while not self._stop:
            suffix = self._journal.suffix(self._shipped_seq)
            if not suffix:
                self._publish_lag()
                self._wake.wait(self._interval_s)
                self._wake.clear()
                continue
            if not self._backoff.can_try_now():
                self._wake.wait(
                    max(
                        0.001,
                        self._backoff
                        .get_time_remaining_until_retry(),
                    )
                )
                self._wake.clear()
                continue
            try:
                # the chaos seam: an armed schedule fails this ship
                # attempt exactly like a dropped wire — counted,
                # retried under backoff, suffix intact
                fault_point(FAULT_JOURNAL_STREAM)
                applied = int(
                    self._ship([r.to_wire() for r in suffix])
                )
            except (FaultInjected, ConnectionError, OSError,
                    RuntimeError):
                FLEET_COUNTERS["journal_stream_errors"] += 1
                self._backoff.report_error()
                self._publish_lag()
                continue
            self._backoff.report_success()
            self._shipped_seq = max(self._shipped_seq, applied)
            self._publish_lag()

    def _publish_lag(self) -> None:
        lag = self.lag()
        # per-pair gauge plus the fleet-wide one the runbook watches
        # (last writer wins; each streamer publishes every loop tick,
        # so a stuck pair's lag is never masked for long)
        self._reg.counter_set(self._lag_name, lag)
        self._reg.counter_set("fleet.replica_lag", lag)
