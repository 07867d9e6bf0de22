"""Admission control / backpressure for the Decision consume path.

Port note: a copy of ``openr_tpu/load/admission.py``; nothing left out.

Two cooperating mechanisms keep the daemon healthy when the KvStore
publication stream outruns the solve rate:

- ``DebounceController`` — a small hysteresis FSM that widens Decision's
  debounce ceiling (so bursts fold into fewer fused dispatches) while the
  reader backlog is deep, and narrows it back once the backlog drains.

- ``coalesce_backlog`` — shed-by-coalescing: drain the reader's backlog
  and squash it into one net-effect publication per area, dropping
  superseded per-key versions. This is *never* a semantic change: every
  KvStore key's value fully replaces the per-(node, key) state inside
  Decision (adjacency DBs, per-prefix entries, fibtime), so replaying
  only the last value per key yields the same LinkState/PrefixState —
  and therefore a bit-identical RouteDatabase — as the full replay.
  ``tests/test_sustained_load.py`` enforces this oracle parity.

Neither mechanism ever drops net effect; both only reduce *work*.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.types import Publication


@dataclass
class AdmissionConfig:
    """Knobs for Decision's admission path. Defaults are conservative:
    shedding only engages with a real backlog (depth ≥ shed_depth), so a
    lightly-loaded daemon behaves exactly as before."""

    # backlog depth at which the consume path drains + coalesces
    shed_depth: int = 8
    # DebounceController band: widen at ≥ high, narrow at ≤ low
    widen_depth: int = 8
    narrow_depth: int = 2
    # debounce ceiling range: base is the configured debounce_max;
    # the controller may widen up to cap_s under sustained backlog
    cap_s: float = 2.0
    # skip the (overlap-only) solver prewarm when the backlog is deeper
    # than this: under pressure the fused rebuild will re-patch anyway,
    # and per-publication prewarm dispatch becomes pure overhead
    prewarm_depth_limit: int = 4


class DebounceController:
    """Rate-adaptive debounce ceiling: ``observe(depth)`` once per
    delivered publication.

    FSM over the current ceiling ``cur``:

        depth >= widen_depth  and cur < cap   -> WIDEN  (cur = min(2*cur, cap))
        depth <= narrow_depth and cur > base  -> NARROW (cur = max(cur/2, base))
        otherwise                             -> STEADY (hysteresis band)

    The ceiling is pushed into the AsyncDebounce via ``set_max_backoff``;
    counters ``decision.debounce_widenings`` / ``_narrowings`` and the
    ``decision.debounce_max_ms`` gauge make the FSM observable.

    The widen/narrow band also SELF-ADJUSTS from the admission
    counters it used to be hand-picked against: every ``tune_period``
    observations the controller samples ``{prefix}.admission.sheds``
    and ``{prefix}.admission.pubs_coalesced`` — sheds while inside the
    band mean widening engaged too late (``widen_depth`` steps down
    toward the backlog the shed path actually saw), a fully quiet
    period relaxes it back up toward the configured value. Adjustments
    are one step per period with the band floor pinned at
    ``narrow_depth + 1`` (the FSM's hysteresis invariant), counted in
    ``{prefix}.debounce_band_adjustments``. ``self_tune=False``
    restores the fixed hand-picked band.
    """

    WIDEN = "widen"
    NARROW = "narrow"
    STEADY = "steady"

    def __init__(
        self,
        base_max_s: float,
        cap_s: float,
        widen_depth: int = 8,
        narrow_depth: int = 2,
        debounce=None,
        metric_prefix: str = "decision",
        self_tune: bool = True,
        tune_period: int = 64,
    ):
        assert cap_s >= base_max_s > 0
        assert widen_depth > narrow_depth >= 0
        self._base = base_max_s
        self._cap = cap_s
        self._widen_depth = widen_depth
        self._widen_depth_base = widen_depth
        self._narrow_depth = narrow_depth
        self._debounce = debounce
        self._prefix = metric_prefix
        self._self_tune = self_tune
        self._tune_period = max(1, tune_period)
        self._observations = 0
        # (sheds, pubs_coalesced) at the last retune; None until the
        # first period completes so a fresh controller never adjusts
        # off counter history it did not witness
        self._tune_sample = None
        self.current_max_s = base_max_s
        get_registry().gauge(
            f"{metric_prefix}.debounce_max_ms",
            lambda: self.current_max_s * 1000.0,
        )

    @property
    def widen_depth(self) -> int:
        return self._widen_depth

    def _retune(self) -> None:
        reg = get_registry()
        sample = (
            reg.counter_get(f"{self._prefix}.admission.sheds"),
            reg.counter_get(f"{self._prefix}.admission.pubs_coalesced"),
        )
        prev, self._tune_sample = self._tune_sample, sample
        if prev is None:
            return
        sheds = sample[0] - prev[0]
        coalesced = sample[1] - prev[1]
        floor = self._narrow_depth + 1
        if sheds > 0 and self._widen_depth > floor:
            # backlogs reached the shed path while the ceiling was
            # still narrow: engage widening earlier
            self._widen_depth -= 1
        elif (
            sheds == 0
            and coalesced == 0
            and self._widen_depth < self._widen_depth_base
        ):
            # a full period with no pressure at all: relax back toward
            # the configured band
            self._widen_depth += 1
        else:
            return
        get_registry().counter_bump(
            f"{self._prefix}.debounce_band_adjustments"
        )

    def observe(self, depth: int) -> str:
        """Feed one backlog-depth sample; returns the action taken."""
        if self._self_tune:
            self._observations += 1
            if self._observations % self._tune_period == 0:
                self._retune()
        if depth >= self._widen_depth and self.current_max_s < self._cap:
            self.current_max_s = min(self.current_max_s * 2.0, self._cap)
            self._apply()
            get_registry().counter_bump(f"{self._prefix}.debounce_widenings")
            return self.WIDEN
        if depth <= self._narrow_depth and self.current_max_s > self._base:
            self.current_max_s = max(self.current_max_s / 2.0, self._base)
            self._apply()
            get_registry().counter_bump(f"{self._prefix}.debounce_narrowings")
            return self.NARROW
        return self.STEADY

    def _apply(self) -> None:
        if self._debounce is not None:
            self._debounce.set_max_backoff(self.current_max_s)


@dataclass
class CoalescedBatch:
    """Result of shed-by-coalescing one consume round."""

    # net-effect publications, one per area, in first-seen area order
    publications: List[Publication] = field(default_factory=list)
    # every drained publication's trace, arrival-ordered (first = oldest)
    traces: List[object] = field(default_factory=list)
    pubs_in: int = 0
    keys_in: int = 0
    keys_out: int = 0

    @property
    def keys_shed(self) -> int:
        return self.keys_in - self.keys_out


def coalesce_publications(pubs: List[Publication]) -> CoalescedBatch:
    """Squash an arrival-ordered publication backlog into one net-effect
    publication per area.

    Per area, replayed in order: a later value for a key supersedes the
    earlier one (KvStore floods only merge-accepted — strictly better —
    values, so last-wins matches ``compare_values`` order); an expiry
    cancels a pending value and vice versa. The output preserves exactly
    the final per-key state the full replay would have left behind.
    """
    batch = CoalescedBatch(pubs_in=len(pubs))
    merged: Dict[str, Dict[str, object]] = {}  # area -> key -> Value
    expired: Dict[str, Dict[str, None]] = {}  # area -> ordered key set
    area_order: List[str] = []
    for pub in pubs:
        if pub.area not in merged:
            merged[pub.area] = {}
            expired[pub.area] = {}
            area_order.append(pub.area)
        kv = merged[pub.area]
        exp = expired[pub.area]
        batch.keys_in += len(pub.key_vals) + len(pub.expired_keys)
        for key, value in pub.key_vals.items():
            kv[key] = value
            exp.pop(key, None)
        for key in pub.expired_keys:
            exp[key] = None
            kv.pop(key, None)
        if pub.trace is not None:
            batch.traces.append(pub.trace)
    for area in area_order:
        batch.keys_out += len(merged[area]) + len(expired[area])
        batch.publications.append(
            Publication(
                key_vals=merged[area],
                expired_keys=list(expired[area]),
                area=area,
            )
        )
    return batch


class AdmissionControl:
    """Decision-side admission path: owns the debounce FSM and the
    shed-by-coalescing drain. One instance per Decision module."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        metric_prefix: str = "decision",
    ):
        self.config = config or AdmissionConfig()
        self._prefix = metric_prefix
        self.controller: Optional[DebounceController] = None

    def bind_debounce(self, debounce, base_max_s: float) -> None:
        """Wire the controller to the module's AsyncDebounce (called by
        Decision once the debounce exists)."""
        self.controller = DebounceController(
            base_max_s=base_max_s,
            cap_s=max(self.config.cap_s, base_max_s),
            widen_depth=self.config.widen_depth,
            narrow_depth=self.config.narrow_depth,
            debounce=debounce,
            metric_prefix=self._prefix,
        )

    def admit(self, first_pub: Publication, reader) -> CoalescedBatch:
        """One consume round: observe backlog depth, adapt the debounce
        ceiling, and — only when the backlog is at/over ``shed_depth`` —
        drain and coalesce it behind ``first_pub``."""
        depth = reader.size()
        if self.controller is not None:
            self.controller.observe(depth)
        if depth < self.config.shed_depth:
            batch = CoalescedBatch(
                publications=[first_pub], pubs_in=1
            )
            if first_pub.trace is not None:
                batch.traces.append(first_pub.trace)
            nkeys = len(first_pub.key_vals) + len(first_pub.expired_keys)
            batch.keys_in = batch.keys_out = nkeys
            return batch
        pubs = [first_pub]
        while True:
            try:
                nxt = reader.try_get()
            except Exception:  # QueueClosedError: treat as drained
                break
            if nxt is None:
                break
            pubs.append(nxt)
        batch = coalesce_publications(pubs)
        reg = get_registry()
        reg.counter_bump(f"{self._prefix}.admission.sheds")
        if batch.keys_shed:
            reg.counter_bump(
                f"{self._prefix}.admission.shed_keys", batch.keys_shed
            )
        if batch.pubs_in > len(batch.publications):
            reg.counter_bump(
                f"{self._prefix}.admission.pubs_coalesced",
                batch.pubs_in - len(batch.publications),
            )
        return batch

    def allow_prewarm(self, depth: int) -> bool:
        """Prewarm is an overlap-only optimization (never correctness);
        under a deep backlog the per-publication dispatch is pure
        overhead, so rate-gate it."""
        if depth <= self.config.prewarm_depth_limit:
            return True
        get_registry().counter_bump(
            f"{self._prefix}.admission.prewarm_skipped"
        )
        return False
