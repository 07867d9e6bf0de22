"""Flight recorder: a lock-cheap ring of recent system activity that
survives trace-ring overflow, plus anomaly triggers that freeze it and
dump a post-mortem bundle to disk.

Port note: a copy of ``openr_tpu/telemetry/flight.py``; its default dump
directory is under the temporary directory (``tempfile.gettempdir()``).

Why a second ring: the span tracer keeps ~256 *full* traces — at 200+
events/s that is ~1 s of history, gone before anyone asks "what
happened right before the p99 breach / the quarantine / the compile
storm". A flight record is a flat dict (one event window's touch
counts, one ladder rung, one audit verdict, one wave admission), so a
2048-deep ring holds tens of seconds of causally-ordered activity for
the cost of a lock + deque append per record.

Record kinds (see docs/ARCHITECTURE.md "Flight recorder"):

- ``window``   — one retired event window: tag, wall_ms, touches,
  dispatches, blocking_syncs (from ``ops/dispatch_accounting.py``);
- ``trace``    — compact summary of every retired trace (origin,
  e2e_ms, span names) noted by ``Tracer.finish`` — survives the trace
  ring's own overflow;
- ``engine``   — route-engine decision points (cold build, full
  refresh, frontier resolve/fallback);
- ``ladder``   — degradation-ladder walks that left the warm rung;
- ``audit``    — integrity audit verdicts;
- ``admission``— wave-scheduler admission: admitted count, class mix,
  preemption delta;
- ``anomaly``  — a trigger firing.

Besides the activity ring there is a second, independent bounded ring:
the **event journal** (``journal_note`` / ``journal_mark``). Where an
activity record is a human-facing breadcrumb, a journal record is a
*replayable* fact: one adopted post-CRDT publication (area, key,
serialized value, version, trace id) or one dispatch-wave boundary
mark. The journal self-compacts: a pub record evicted from the ring
folds into a rolling per-(area, key) base LSDB, so ``base + ring
slice`` is always the complete adopted history — every post-mortem
bundle embeds both plus an anchor (checkpoint seq + FNV-1a graph
digest) and is therefore self-contained and deterministically
replayable by ``twin/replay.py``. The journal does NOT drop while the
activity ring is frozen: dropping a pub would break the
base-plus-slice completeness of every later bundle.

Triggers: each ``check()`` is a couple of registry reads per retired
event window (and per serve wave). On fire the ring FREEZES (new notes
are dropped and counted, so the pre-anomaly evidence survives), a
bundle is written (``flight.dumps.<trigger>``), and the ring thaws.

THE HAZARD (lint-enforced via ``@flight_callback``): a dump is file
I/O plus a full counter snapshot — it must NEVER run inside a solve
window. ``_fire`` defers the dump while ``dispatch_accounting`` has an
active window and flushes it at the next window retirement, which
runs strictly after the window pops.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from openr_tpu_torch.telemetry.registry import get_registry

_DEF_RING = 2048
_DEF_JOURNAL = 4096
_DEF_MAX_DUMP_BYTES = 8 << 20
_DEF_DIR = os.path.join(tempfile.gettempdir(), "openr_tpu_torch_flight")

BUNDLE_SCHEMA = 2


def fnv1a(data: bytes, h: int = 0x811C9DC5) -> int:
    """FNV-1a over ``data`` (same digest family as ``SolverView.digest``
    and the multi-client wire parity check)."""
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def _lsdb_digest(lsdb: Dict[str, Dict[str, Dict[str, Any]]]) -> int:
    """FNV-1a over a serialized base LSDB in sorted (area, key) order —
    the bundle's graph anchor digest. ``twin/replay.py`` recomputes it
    to detect a corrupt or hand-edited bundle."""
    h = 0x811C9DC5
    for area in sorted(lsdb):
        kv = lsdb[area]
        for key in sorted(kv):
            rec = kv[key]
            blob = "|".join((area, key, str(rec.get("version", 0)),
                             rec.get("value_b64") or "", ";"))
            h = fnv1a(blob.encode(), h)
    return h


def load_bundle(path: str) -> Dict[str, Any]:
    """Load a post-mortem bundle written by ``dump_postmortem`` —
    transparently handles the gzip form (``.json.gz``)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


class Trigger:
    """One anomaly detector. ``check(reg)`` returns a human-readable
    reason string to fire, or None. Checks run per retired event window
    — keep them to a few registry reads."""

    name = "trigger"

    def check(self, reg) -> Optional[str]:  # pragma: no cover - interface
        raise NotImplementedError


class CounterDeltaTrigger(Trigger):
    """Fires when a counter moves by >= min_delta since the last check.
    The baseline updates on every check, so one burst fires once."""

    def __init__(self, name: str, counter: str, min_delta: int = 1) -> None:
        self.name = name
        self.counter = counter
        self.min_delta = min_delta
        self._last: Optional[float] = None

    def check(self, reg) -> Optional[str]:
        cur = float(reg.counter_get(self.counter))
        last, self._last = self._last, cur
        if last is None:
            return None
        delta = cur - last
        if delta >= self.min_delta:
            return f"{self.counter} +{delta:g} (was {last:g})"
        return None


class P99BreachTrigger(Trigger):
    """Fires when a latency histogram's p99 breaches ``factor`` x its
    own rolling EWMA baseline (and an absolute floor, so microsecond
    noise on a quiet histogram can't trip it). Re-baselines on fire so
    a sustained regression fires once, not every window."""

    def __init__(self, name: str, hist: str, factor: float = 3.0,
                 min_samples: int = 32, floor_ms: float = 5.0,
                 alpha: float = 0.1) -> None:
        self.name = name
        self.hist = hist
        self.factor = factor
        self.min_samples = min_samples
        self.floor_ms = floor_ms
        self.alpha = alpha
        self._baseline: Optional[float] = None
        self._last_count = -1

    def check(self, reg) -> Optional[str]:
        h = reg.histogram_if_exists(self.hist)
        if h is None:
            return None
        count = h.count
        if count < self.min_samples or count == self._last_count:
            return None
        self._last_count = count
        p99 = h.percentile(0.99)
        if self._baseline is None:
            self._baseline = p99
            return None
        threshold = max(self.floor_ms, self.factor * self._baseline)
        baseline = self._baseline
        self._baseline = (1.0 - self.alpha) * self._baseline + \
            self.alpha * p99
        if p99 > threshold:
            self._baseline = p99  # re-baseline: fire once per regression
            return (f"{self.hist} p99 {p99:.2f}ms > {self.factor:g}x "
                    f"baseline {baseline:.2f}ms")
        return None


class CompileAfterWarmupTrigger(Trigger):
    """Any jit or AOT compile after the profiler's warmup marker is a
    retrace — the exact regression the zero-retrace contract forbids."""

    name = "compile_after_warmup"

    def __init__(self) -> None:
        self._last: Optional[float] = None

    def check(self, reg) -> Optional[str]:
        cur = float(reg.counter_get("ops.aot_compiles")) + \
            float(reg.counter_get("jax.compile_count"))
        from openr_tpu_torch.telemetry.profiler import get_profiler

        if not get_profiler().warm:
            self._last = cur
            return None
        last, self._last = self._last, cur
        if last is not None and cur > last:
            return f"compile after warmup (+{cur - last:g} compiles)"
        return None


class FlightRecorder:
    """Process-wide activity ring + trigger host + post-mortem dumper."""

    def __init__(
        self,
        ring: Optional[int] = None,
        enabled: Optional[bool] = None,
        dump_dir: Optional[str] = None,
        min_dump_interval_s: float = 2.0,
        max_dumps: int = 16,
        journal: Optional[int] = None,
        max_dump_bytes: Optional[int] = None,
        gzip_dumps: Optional[bool] = None,
    ) -> None:
        if ring is None:
            ring = int(os.environ.get("OPENR_FLIGHT_RING", str(_DEF_RING)))
        if enabled is None:
            enabled = os.environ.get("OPENR_FLIGHT", "1") != "0"
        if dump_dir is None:
            dump_dir = os.environ.get("OPENR_FLIGHT_DIR", _DEF_DIR)
        if journal is None:
            journal = int(os.environ.get(
                "OPENR_FLIGHT_JOURNAL", str(_DEF_JOURNAL)))
        if max_dump_bytes is None:
            max_dump_bytes = int(os.environ.get(
                "OPENR_FLIGHT_MAX_DUMP_BYTES", str(_DEF_MAX_DUMP_BYTES)))
        if gzip_dumps is None:
            gzip_dumps = os.environ.get("OPENR_FLIGHT_GZIP", "0") == "1"
        self.enabled = bool(enabled)
        self.dump_dir = dump_dir
        self.min_dump_interval_s = min_dump_interval_s
        self.max_dumps = max_dumps
        self.max_dump_bytes = max(4096, int(max_dump_bytes))
        self.gzip_dumps = bool(gzip_dumps)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, ring))
        self._frozen = False
        self._seq = 0
        self._dumps = 0
        self._last_dump_t = 0.0
        self._triggers: List[Trigger] = []
        self._pending: Optional[tuple] = None
        # -- event journal: pub/mark ring + rolling base LSDB ---------
        self._journal: deque = deque(maxlen=max(64, journal))
        self._journal_seq = 0
        self._journal_base: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._journal_base_seq = 0
        self._anchor_provider: Optional[Callable[[], Dict[str, Any]]] = None
        self._counter_baseline: Dict[str, float] = {}
        budget = os.environ.get("OPENR_TOUCH_BUDGET", "")
        self._touch_budget: Optional[int] = int(budget) if budget else None

    # -- recording ---------------------------------------------------
    def note(self, kind: str, /, **data: Any) -> None:
        """Append one activity record. Lock + deque append; drops (and
        counts) while frozen so pre-anomaly evidence survives.
        ``kind`` is positional-only: a data key named ``kind`` rides in
        the record instead of colliding (the record's own kind wins)."""
        if not self.enabled:
            return
        rec = dict(data)
        rec["ts"] = round(time.time(), 4)
        rec["kind"] = kind
        with self._lock:
            if self._frozen:
                dropped = True
            else:
                dropped = False
                if len(self._ring) == self._ring.maxlen:
                    get_registry().counter_bump("flight.ring_overflows")
                self._ring.append(rec)
        if dropped:
            get_registry().counter_bump("flight.dropped_while_frozen")

    def records(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        return out[-limit:] if limit else out

    def freeze(self) -> None:
        with self._lock:
            self._frozen = True

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen = False

    # -- event journal -----------------------------------------------
    def journal_anchor(self, area: str,
                       key_vals: Dict[str, Dict[str, Any]]) -> None:
        """Seed (or extend) the rolling base LSDB wholesale — used by a
        source whose starting state never flowed through ``journal_note``
        (e.g. a twin built directly from a topology). ``key_vals`` maps
        key -> {value_b64, version, originator}."""
        if not self.enabled:
            return
        with self._lock:
            base = self._journal_base.setdefault(area, {})
            for key, rec in key_vals.items():
                base[key] = dict(rec)

    def journal_note(self, area: str, key: str, *, value_b64: str,
                     version: int, originator: str = "",
                     trace_id: Optional[int] = None) -> None:
        """Record one adopted post-CRDT publication. Keeps appending
        while the activity ring is frozen: the journal is bounded and
        self-compacting, and a dropped pub would break the
        base-plus-slice completeness of every later bundle."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {
            "area": area,
            "key": key,
            "value_b64": value_b64,
            "version": int(version),
            "originator": originator,
        }
        if trace_id is not None:
            rec["trace_id"] = trace_id
        with self._lock:
            self._journal_seq += 1
            rec["seq"] = self._journal_seq
            self._journal_append_locked(rec)

    def journal_mark(self, kind: str, /, **data: Any) -> None:
        """Record one dispatch-wave / debounce-window boundary (kind
        ``wave``) or an analyzer verdict (kind ``analysis``). Marks
        delimit the replay windows: the replayer applies the pubs since
        the previous mark, then converges exactly the mark's vantages."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"mark": kind}
        rec.update(data)
        with self._lock:
            self._journal_seq += 1
            rec["seq"] = self._journal_seq
            self._journal_append_locked(rec)

    def _journal_append_locked(self, rec: Dict[str, Any]) -> None:
        ring = self._journal
        if len(ring) == ring.maxlen:
            evicted = ring[0]
            if "mark" not in evicted:
                self._journal_base.setdefault(evicted["area"], {})[
                    evicted["key"]] = {
                    "value_b64": evicted["value_b64"],
                    "version": evicted["version"],
                    "originator": evicted.get("originator", ""),
                }
            self._journal_base_seq = evicted["seq"]
            get_registry().counter_bump("flight.journal_evictions")
        ring.append(rec)

    def journal_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._journal]

    def journal_len(self) -> int:
        with self._lock:
            return len(self._journal)

    def journal_base(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        with self._lock:
            return {a: {k: dict(v) for k, v in kv.items()}
                    for a, kv in self._journal_base.items()}

    def set_anchor_provider(
            self, fn: Optional[Callable[[], Dict[str, Any]]]) -> None:
        """Install a callable returning extra anchor fields for the next
        bundle (the state plane installs one that reports its checkpoint
        seq). Errors are swallowed and counted — same contract as the
        dump itself."""
        self._anchor_provider = fn

    def _anchor_digest_locked(self) -> int:
        return _lsdb_digest(self._journal_base)

    def journal_anchor_digest(self) -> int:
        """FNV-1a digest over the rolling base LSDB (sorted area/key
        order) — the bundle's graph anchor, recomputed by the replayer
        to detect a corrupt or mis-paired bundle."""
        with self._lock:
            return self._anchor_digest_locked()

    # -- budgets -----------------------------------------------------
    def set_touch_budget(self, budget: Optional[int]) -> None:
        """Arm (or disarm with None) the per-window host-touch budget.
        Disarmed by default: cold builds legitimately exceed the warm
        two-touch contract."""
        self._touch_budget = budget

    # -- triggers ----------------------------------------------------
    def add_trigger(self, trigger: Trigger) -> None:
        with self._lock:
            self._triggers.append(trigger)

    def trigger_names(self) -> List[str]:
        with self._lock:
            return [t.name for t in self._triggers]

    def check_triggers(self) -> None:
        """Run every registered trigger. Called per retired event
        window and per serve wave — a few registry reads per trigger."""
        if not self.enabled:
            return
        reg = get_registry()
        with self._lock:
            triggers = list(self._triggers)
        for t in triggers:
            try:
                reason = t.check(reg)
            except Exception:  # noqa: BLE001 - a bad trigger never
                reg.counter_bump("flight.trigger_errors")  # poisons solve
                continue
            if reason:
                self._fire(t.name, reason)

    def anomaly(self, name: str, /, reason: str = "", **data: Any) -> None:
        """Direct anomaly entry point for call sites that already know
        (quarantine conviction, ladder exhaustion) — no polling
        trigger needed."""
        if not self.enabled:
            return
        self.note("anomaly", trigger=name, reason=reason, **data)
        self._fire(name, reason)

    def _fire(self, name: str, reason: str) -> None:
        reg = get_registry()
        reg.counter_bump(f"flight.triggers.{name}")
        now = time.monotonic()
        with self._lock:
            if self._dumps >= self.max_dumps or \
                    (now - self._last_dump_t) < self.min_dump_interval_s:
                reg.counter_bump("flight.dumps_suppressed")
                return
            self._last_dump_t = now
            self._frozen = True
        # NEVER dump inside a solve window: the bundle write is file
        # I/O + a full snapshot. Defer; the next window retirement
        # (which runs after the window pops) flushes it.
        from openr_tpu_torch.ops import dispatch_accounting as da

        if da.current_window() is not None:
            with self._lock:
                self._pending = (name, reason)
            return
        self.dump_postmortem(trigger=name, reason=reason)

    def _flush_pending(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            self.dump_postmortem(trigger=pending[0], reason=pending[1])

    # -- window hook -------------------------------------------------
    def on_window(self, tag: str, wall_ms: float, window: Any) -> None:
        """One committed event window retired (called by
        ``dispatch_accounting.event_window`` AFTER the window pops, so
        everything here — including a deferred dump — runs outside the
        solve window)."""
        if not self.enabled:
            return
        self.note(
            "window",
            tag=tag,
            wall_ms=round(wall_ms, 4),
            touches=window.touches,
            dispatches=window.dispatches,
            blocking_syncs=window.blocking_syncs,
        )
        budget = self._touch_budget
        if budget is not None and window.touches > budget:
            self.anomaly(
                "touch_budget",
                reason=f"{tag}: {window.touches} touches > budget {budget}",
                tag=tag,
                touches=window.touches,
                budget=budget,
            )
        self._flush_pending()
        self.check_triggers()

    # -- post-mortem bundles -----------------------------------------
    def _encode_bundle(self, bundle: Dict[str, Any]) -> bytes:
        """Serialize compactly; if over the size ceiling, shed the bulk
        in evidence order — activity records first, then the oldest
        journal pubs (folded into the bundle's own anchor LSDB so the
        bundle stays replayable, just from a later anchor)."""
        payload = json.dumps(bundle, separators=(",", ":")).encode()
        truncated = False
        while len(payload) > self.max_dump_bytes:
            recs = bundle["records"]
            jrn = bundle["journal"]
            if recs:
                del recs[:max(1, len(recs) // 2)]
            elif len(jrn["records"]) > 1:
                drop = jrn["records"][:max(1, len(jrn["records"]) // 2)]
                del jrn["records"][:len(drop)]
                lsdb = jrn["anchor"]["lsdb"]
                for rec in drop:
                    if "mark" in rec:
                        continue
                    lsdb.setdefault(rec["area"], {})[rec["key"]] = {
                        "value_b64": rec["value_b64"],
                        "version": rec["version"],
                        "originator": rec.get("originator", ""),
                    }
                    jrn["base_seq"] = rec["seq"]
                # the anchor moved: its digest no longer matches the
                # recorded one, so recompute over the folded LSDB
                jrn["anchor"]["graph_digest"] = _lsdb_digest(lsdb)
            else:
                break
            truncated = True
            bundle["truncated"] = True
            payload = json.dumps(bundle, separators=(",", ":")).encode()
        if truncated:
            get_registry().counter_bump("flight.dump_truncations")
        return payload

    def dump_postmortem(self, trigger: str = "manual",
                        reason: str = "") -> Optional[str]:
        """Write the bundle (JSON or gzip + sibling Chrome trace), thaw
        the ring, return the bundle path (None when disabled or the
        write fails — a dump failure never propagates into the
        pipeline). The bundle embeds the journal slice plus the LSDB
        anchor, so it is self-contained for ``twin/replay.py``."""
        if not self.enabled:
            return None
        reg = get_registry()
        from openr_tpu_torch.telemetry.profiler import get_profiler
        from openr_tpu_torch.telemetry.trace import get_tracer

        prof = get_profiler()
        with self._lock:
            self._seq += 1
            seq = self._seq
            records = list(self._ring)
            journal_records = [dict(r) for r in self._journal]
            journal_base = {a: {k: dict(v) for k, v in kv.items()}
                            for a, kv in self._journal_base.items()}
            base_seq = self._journal_base_seq
            graph_digest = self._anchor_digest_locked()
        anchor: Dict[str, Any] = {
            "checkpoint_seq": base_seq,
            "graph_digest": graph_digest,
            "lsdb": journal_base,
        }
        provider = self._anchor_provider
        if provider is not None:
            try:
                anchor.update(provider() or {})
            except Exception:  # noqa: BLE001 - anchor extras are
                reg.counter_bump("flight.anchor_errors")  # best-effort
        counters = reg.snapshot()
        # the baseline dict is swapped wholesale under _lock on reset;
        # grab the reference under the same lock so a dump racing a
        # reset reads one coherent snapshot, never a torn swap
        with self._lock:
            baseline = self._counter_baseline
        delta = {k: round(v - baseline.get(k, 0.0), 6)
                 for k, v in counters.items()
                 if v != baseline.get(k, 0.0)}
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "trigger": trigger,
            "reason": reason,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "seq": seq,
            "records": records,
            "counters": counters,
            "counters_delta": delta,
            "journal": {
                "base_seq": base_seq,
                "records": journal_records,
                "anchor": anchor,
            },
            "attribution": prof.attribution(),
            "host_overhead_ratio": prof.host_overhead_ratio(),
        }
        stamp = int(bundle["ts"] * 1000.0)
        base = f"postmortem-{trigger}-{stamp}-{os.getpid()}-{seq}"
        path = os.path.join(self.dump_dir,
                            base + (".json.gz" if self.gzip_dumps
                                    else ".json"))
        try:
            payload = self._encode_bundle(bundle)
            os.makedirs(self.dump_dir, exist_ok=True)
            if self.gzip_dumps:
                with gzip.open(path, "wb") as f:
                    f.write(payload)
            else:
                with open(path, "wb") as f:
                    f.write(payload)
            reg.observe("ops.flight.dump_bytes",
                        float(os.path.getsize(path)))
            with open(os.path.join(self.dump_dir,
                                   base + "-trace.json"), "w") as f:
                json.dump(get_tracer().chrome_trace(), f,
                          separators=(",", ":"))
        except (OSError, TypeError, ValueError):
            reg.counter_bump("flight.dump_errors")
            path = None
        with self._lock:
            if path is not None:
                self._dumps += 1
                self._counter_baseline = dict(counters)
            self._frozen = False
        if path is not None:
            reg.counter_bump(f"flight.dumps.{trigger}")
        return path


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()
_DEFAULTS_INSTALLED = False


def get_flight_recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def reset_flight_recorder(**kwargs: Any) -> FlightRecorder:
    """Tests / smoke gates: replace the singleton (re-reads env unless
    overridden by kwargs). Default triggers must be re-installed."""
    global _RECORDER, _DEFAULTS_INSTALLED
    with _RECORDER_LOCK:
        _RECORDER = FlightRecorder(**kwargs)
        _DEFAULTS_INSTALLED = False
    return _RECORDER


def install_default_triggers() -> FlightRecorder:
    """Idempotent: arm the standing anomaly set — convergence p99
    breach, compile-after-warmup, reshard delta. Touch budget stays
    disarmed until a caller sets it; quarantine and ladder exhaustion
    fire directly from their call sites via ``anomaly()``."""
    global _DEFAULTS_INSTALLED
    fr = get_flight_recorder()
    with _RECORDER_LOCK:
        if _DEFAULTS_INSTALLED:
            return fr
        _DEFAULTS_INSTALLED = True
    fr.add_trigger(P99BreachTrigger("p99_breach", "convergence.e2e_ms"))
    fr.add_trigger(CompileAfterWarmupTrigger())
    fr.add_trigger(CounterDeltaTrigger("reshard", "ops.reshard_events"))
    # a handful of speculation cancels per window is the normal
    # latest-wins tax; a burst of them means every speculative
    # dispatch is being thrown away (composition churning faster than
    # the debounce terminal) — capture the window for the runbook's
    # speculation-miss-storm recipe
    fr.add_trigger(CounterDeltaTrigger(
        "spec_cancel_storm", "ops.spec_cancels", min_delta=8,
    ))
    return fr
