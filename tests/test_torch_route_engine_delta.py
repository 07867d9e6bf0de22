"""The port's delta-compacted, double-buffered churn readback against the
JAX package's, in the shape of ``tests/test_route_engine_delta.py``.

After any event class (bucketed incremental, full-width refresh, cold
rebuild) the port's delta-applied host result equals the reference
engine's and a from-scratch cold build of the same engine class, field
by field; ``defer_consume`` leaves the host result stale behind a
``PendingDelta`` until the next event or a flush consumes it; a coalesced
window folds to one incremental event; the readback is one meta row plus
the changed rows, and the changed rows are a subset of the affected ones.
Both engines on the CPU (``device="cpu"`` for the port).
"""

from __future__ import annotations

import numpy as np
import pytest

from openr_tpu.models import topologies as jax_topologies
from openr_tpu_torch.ops import route_engine as port_engine
from openr_tpu_torch.ops import route_sweep as port_sweep
from tests.test_torch_route_engine import KINDS, Pair, _set_buckets


def small_fat_tree(pods=3, rsw=4):
    return jax_topologies.fat_tree(pods=pods, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=rsw)


def cold_twin(pair):
    """A from-scratch port engine of the same class on the same network."""
    cls = type(pair.port.engine)
    return cls(pair.twin.ls, pair.samples, device="cpu")


def assert_bit_identical(pair):
    twin = cold_twin(pair)
    a, b = pair.port.engine.result, twin.result
    assert pair.port.engine.graph.node_names == twin.graph.node_names
    for f in ("digests", "nh_totals", "sample_metrics", "sample_masks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def digests(engine):
    return port_sweep.digests_by_name(engine.result)


def first(pair, prefix, i=0):
    return [n for n in pair.plain() if n.startswith(prefix)][i]


@pytest.mark.parametrize("kind", KINDS)
class TestDeltaApplyParity:
    def test_incremental_delta_apply(self, kind):
        p = Pair(small_fat_tree(), kind)
        rsw = first(p, "rsw")
        for metric in (7, 3, 11):
            moved, _ = p.churn(f"metric {metric}", p.metric(rsw, 0, metric))
            assert moved
            # the moved names are the device diff: every row it touched
            assert p.port.engine.last_delta_rows == len(moved)
        assert p.port.engine.incremental_events == 3
        assert p.port.engine.full_refreshes == 0
        assert_bit_identical(p)

    def test_full_width_refresh_delta_apply(self, kind, monkeypatch):
        p = Pair(small_fat_tree(), kind)
        _set_buckets(monkeypatch, (8,))
        p.both(lambda e: setattr(e, "_k_hint", 8))
        # the full-width rung: a zero budget makes every frontier fall back
        p.both(lambda e: setattr(e, "frontier_threshold", 0.0))
        ssw = first(p, "ssw")
        moved, _ = p.churn("full width", p.metric(ssw, 0, 9))
        assert moved is not None and len(moved) > 8
        assert p.port.engine.full_refreshes == 1 and p.port.engine.cold_builds == 1
        assert p.port.engine.last_delta_rows == len(moved)
        assert_bit_identical(p)

    def test_cold_rebuild_after_deltas(self, kind):
        p = Pair(small_fat_tree(), kind)
        rsw = first(p, "rsw")
        p.churn("deferred", p.metric(rsw, 0, 7), defer_consume=True)
        handle = p.port.engine._pending
        assert isinstance(handle, port_engine.PendingDelta)
        p.step("cold rebuild", lambda side, aps: side.engine._build(side.ls))
        assert handle.consumed, "a cold rebuild drains the delta"
        assert p.port.engine.cold_builds == 2
        assert_bit_identical(p)


class TestDoubleBuffer:
    def test_defer_returns_pending_and_result_lags(self):
        p = Pair(small_fat_tree(), "ell")
        eng = p.port.engine
        before = dict(digests(eng))
        p.churn("deferred", p.metric(first(p, "rsw"), 0, 7), defer_consume=True)
        pending = eng._pending
        assert isinstance(pending, port_engine.PendingDelta) and not pending.consumed
        # device state committed, the HOST result deliberately stale
        assert eng.version == p.twin.ls.topology_version
        assert digests(eng) == before
        names = pending.wait()
        assert pending.consumed and names
        assert names == p.jax.engine.flush().names
        p.same_product("after wait")
        assert_bit_identical(p)
        assert pending.wait() == names  # idempotent

    def test_next_event_consumes_prior_delta_in_overlap(self):
        p = Pair(small_fat_tree(), "ell")
        eng = p.port.engine
        rsws = [n for n in p.plain() if n.startswith("rsw")]
        p.churn("event 1", p.metric(rsws[0], 0, 7), defer_consume=True)
        p1 = eng._pending
        p.churn("event 2", p.metric(rsws[1], 0, 9), defer_consume=True)
        p2 = eng._pending
        # event 2's dispatch window consumed event 1's delta
        assert p1.consumed and p1.names and not p2.consumed
        p.step("flush", lambda side, aps: side.engine.flush().names)
        assert p2.consumed and eng._pending is None
        assert eng.flush() is None
        assert_bit_identical(p)

    def test_pipelined_sequence_matches_eager(self):
        eager = Pair(small_fat_tree(pods=2), "ell")
        piped = Pair(small_fat_tree(pods=2), "ell")
        rsw = first(eager, "rsw")
        eager_names, handles = [], []
        for metric in (5, 9, 2, 12):
            eager_names.append(eager.churn(f"eager {metric}", eager.metric(rsw, 0, metric))[1])
            piped.churn(f"piped {metric}", piped.metric(rsw, 0, metric), defer_consume=True)
            handles.append(piped.port.engine._pending)
        piped.step("flush", lambda side, aps: _names(side.engine.flush()))
        assert [h.names for h in handles] == eager_names
        assert digests(piped.port.engine) == digests(eager.port.engine)


def _names(pending):
    return None if pending is None else pending.names


class TestCoalescing:
    def test_window_folds_to_one_dispatch(self):
        seq = Pair(small_fat_tree(), "ell")
        fused = Pair(small_fat_tree(), "ell")
        rsws = [n for n in seq.plain() if n.startswith("rsw")][:4]
        events = []
        for i, rsw in enumerate(rsws):
            seq.churn(f"sequential {i}", seq.metric(rsw, 0, 3 + i))
            ev = fused.metric(rsw, 0, 3 + i)
            events.append(ev)
            for side in (fused.jax, fused.port):
                side.apply(ev)
        moved, _ = fused.step("coalesced", lambda side, aps: side.engine.churn_coalesced(
            side.ls, [set(ev.affected) for ev in events]))
        assert moved is not None
        assert seq.port.engine.incremental_events == 4
        assert fused.port.engine.incremental_events == 1
        assert fused.port.engine.coalesced_events == 1
        assert digests(fused.port.engine) == digests(seq.port.engine)
        assert_bit_identical(fused)

    def test_self_cancelling_window_is_noop(self):
        p = Pair(small_fat_tree(pods=2), "ell")
        rsw = first(p, "rsw")
        old = p.db(rsw).adjacencies[0].metric
        e1 = p.metric(rsw, 0, old + 5)
        for side in (p.jax, p.port):
            side.apply(e1)
        e2 = p.metric(rsw, 0, old)
        got, _ = p.step("cancelling window", lambda side, aps: side.engine.churn_coalesced(
            side.ls, [set(e1.affected), aps[0]()]), e2)
        assert got == []
        assert p.port.engine.incremental_events == 0
        assert p.port.engine.coalesced_events == 1

    def test_single_set_window_not_counted(self):
        p = Pair(small_fat_tree(pods=2), "ell")
        got, _ = p.step("one set", lambda side, aps: side.engine.churn_coalesced(
            side.ls, [aps[0]()]), p.metric(first(p, "rsw"), 0, 7))
        assert got is not None
        assert p.port.engine.coalesced_events == 0
        assert p.port.engine.incremental_events == 1


@pytest.mark.parametrize("kind", KINDS)
class TestReadbackAccounting:
    def test_bytes_scale_with_delta_rows_not_width(self, kind):
        """bytes == one meta row a segment + changed rows x row width,
        below the whole packed product."""
        p = Pair(small_fat_tree(pods=4, rsw=6), kind)
        eng = p.port.engine
        full_bytes = eng._packed_dev.shape[0] * eng._packed_dev.shape[1] * 4
        p.churn("deferred", p.metric(first(p, "rsw"), 0, 7), defer_consume=True)
        pending = eng._pending
        row_bytes = pending.segs[0].shape[1] * 4
        p.step("flush", lambda side, aps: _names(side.engine.flush()))
        assert pending.delta_rows == sum(pending.ch_counts)
        assert pending.readback_bytes == (len(pending.segs) + pending.delta_rows) * row_bytes
        assert eng.last_readback_bytes == pending.readback_bytes
        assert eng.last_delta_rows == pending.delta_rows
        assert pending.delta_rows <= eng.graph.n
        assert pending.readback_bytes < full_bytes

    def test_changed_subset_of_affected(self, kind):
        p = Pair(small_fat_tree(), kind)
        p.churn("deferred", p.metric(first(p, "fsw"), 0, 9), defer_consume=True)
        pending = p.port.engine._pending
        for cnt, ch in zip(pending.counts, pending.ch_counts):
            assert 0 <= ch <= cnt
        names, _ = p.step("wait", lambda side, aps: side.engine._pending.wait())
        assert names
        assert_bit_identical(p)
