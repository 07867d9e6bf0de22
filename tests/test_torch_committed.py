"""Committed dispatch in the port: the executable cache
(``ops/aot_cache.py``), the relax loops with their convergence flag on the
card (``ops/relax_loop.py``, ``route_sweep.expand_cone``), the route
engines through the cache (the port's versions of
``tests/test_committed_dispatch.py``, on both engine kinds, each test with
a fresh cache), the window's device-time attribution and the flight
record's ``host_overhead_ratio``, held against ``openr_tpu`` on the CPU.
"""

from __future__ import annotations

import io
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import route_sweep as jax_sweep
from openr_tpu.telemetry.profiler import Profiler as JaxProfiler
from openr_tpu_torch import carry
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.kernels import LAUNCHES, note_launch
from openr_tpu_torch.ops import aot_cache, relax_loop, route_engine, route_sweep
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import spf_grouped, spf_sparse
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.telemetry import profiler as port_profiler

CPU = torch.device("cpu")
KINDS = ("ell", "grouped")


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts from an empty executable cache (the registry's
    counters are read as deltas)."""
    aot_cache.get_aot_cache().clear()
    yield
    aot_cache.get_aot_cache().clear()


def counter(name):
    return get_registry().counter_get(name)


# -- the executable cache ----------------------------------------------------


def _body(a, b, *, k):
    return a + b * k, (a.sum(),)


def test_keys_compiles_and_hits():
    cache = aot_cache.get_aot_cache()
    x = torch.arange(6, dtype=torch.int32)
    y = torch.ones(6, dtype=torch.int32)
    c0, h0 = counter("ops.aot_compiles"), counter("ops.aot_hits")
    out, (total,) = aot_cache.aot_call("t", _body, (x, y), dict(k=2))
    assert torch.equal(out, x + 2) and int(total) == 15
    aot_cache.aot_call("t", _body, (x + 1, y), dict(k=2))  # same shapes: a hit
    aot_cache.aot_call("t", _body, (x, y), dict(k=3))  # another static
    aot_cache.aot_call("t", _body, (x[:4], y[:4]), dict(k=2))  # another shape
    aot_cache.aot_call("u", _body, (x, y), dict(k=2))  # another tag
    aot_cache.aot_call("t", _body, (x, y.long()), dict(k=2))  # another dtype
    assert counter("ops.aot_compiles") - c0 == 5
    assert counter("ops.aot_hits") - h0 == 1
    st = cache.stats()
    assert st["entries"] == 5 and st["fallbacks"] == counter("ops.aot_fallbacks")
    assert st["input_bytes"] > 0 and st["pool_bytes"] == 0  # no graph pool on the CPU
    sig = aot_cache.signature((x, (y, None), 3))
    assert sig == aot_cache.signature((x + 5, (y, None), 3))
    assert sig != aot_cache.signature((x, (y, None), 4))
    cache.clear()
    assert cache.stats()["entries"] == 0


def test_each_call_counts_a_dispatch_and_the_profiler_attributes_it():
    x = torch.arange(4)
    d0 = counter("ops.host_dispatches")
    with da.event_window("probe") as w:
        aot_cache.aot_call("t", _body, (x, x), dict(k=1))
        aot_cache.aot_call("t", _body, (x, x), dict(k=1))
    assert counter("ops.host_dispatches") - d0 == 2
    assert w.dispatches == 2 and w.touches == 1 and w.blocking_syncs == 0
    if port_profiler.get_profiler().enabled:
        assert w.stages["t"][0] == 2 and w.device_ms > 0.0


def test_a_retained_result_survives_another_call_of_the_key():
    x = torch.arange(6, dtype=torch.int32)
    first, (s1,) = aot_cache.aot_call("alias", _body, (x, x), dict(k=1))
    kept = first.clone()
    second, (s2,) = aot_cache.aot_call("alias", _body, (x * 7, x), dict(k=1))
    assert torch.equal(first, kept) and int(s1) == 15
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(second, x * 8) and int(s2) == 105
    # the caller's inputs are never the key's buffers, nor written
    assert torch.equal(x, torch.arange(6, dtype=torch.int32))


def test_keys_share_their_output_buffers():
    """A key pins no output of its own: keys whose outputs have one
    signature write one shared buffer, and results handed out are
    copies of it."""
    cache = aot_cache.get_aot_cache()
    x = torch.arange(6, dtype=torch.int32)
    outs = [aot_cache.aot_call("share", _body, (x, x), dict(k=k))[0] for k in (1, 2, 3)]
    st = cache.stats()
    assert st["entries"] == 3
    # one [6] int32 result and one int64 sum, shared by the three keys
    assert st["output_bytes"] == 6 * 4 + 8
    assert [o.tolist() for o in outs] == [(x * (1 + k)).tolist() for k in (1, 2, 3)]
    assert st["copies"]["share"] == {"replays": 3, "in_bytes": 2 * 6 * 4,
                                     "out_bytes": 6 * 4 + 8}


def test_the_cache_evicts_the_least_recently_used_keys():
    cache = aot_cache.AotDispatchCache(max_entries=2)
    x = torch.arange(4, dtype=torch.int32)
    e0, c0 = counter("ops.aot_evictions"), counter("ops.aot_compiles")
    cache.call("lru", _body, (x, x), dict(k=1))
    cache.call("lru", _body, (x, x), dict(k=2))
    cache.call("lru", _body, (x, x), dict(k=1))  # a hit: k=2 is now the oldest
    out, _ = cache.call("lru", _body, (x, x), dict(k=3))
    assert torch.equal(out, x * 4)
    assert cache.stats()["entries"] == 2 and counter("ops.aot_evictions") - e0 == 1
    h0 = counter("ops.aot_hits")
    cache.call("lru", _body, (x, x), dict(k=1))  # kept
    assert counter("ops.aot_hits") - h0 == 1
    out, _ = cache.call("lru", _body, (x, x), dict(k=2))  # evicted: captured again
    assert torch.equal(out, x * 3)
    assert counter("ops.aot_compiles") - c0 == 4


def test_the_byte_bound_drops_a_superseded_shape():
    """Past ``max_bytes`` the oldest keys go, and with them the buffers of
    a shape no remaining key reads."""
    big = torch.arange(1000, dtype=torch.int32)
    small = torch.arange(10, dtype=torch.int32)
    cache = aot_cache.AotDispatchCache(max_bytes=3 * 1000 * 4 + 64)
    cache.call("b", _body, (big, big), dict(k=1))
    st = cache.stats()
    assert st["input_bytes"] == 2 * 4000 and st["output_bytes"] == 4000 + 8
    e0 = counter("ops.aot_evictions")
    out, _ = cache.call("b", _body, (small, small), dict(k=1))
    assert torch.equal(out, small * 2)
    st = cache.stats()
    assert counter("ops.aot_evictions") - e0 == 1 and st["entries"] == 1
    assert st["input_bytes"] == 2 * 40 and st["output_bytes"] == 40 + 8
    # a bound below one key's own buffers still keeps the newest key
    tiny = aot_cache.AotDispatchCache(max_bytes=1)
    for k in (1, 2):
        assert torch.equal(tiny.call("b", _body, (big, big), dict(k=k))[0], big * (1 + k))
    assert tiny.stats()["entries"] == 1


def _syncing(a):
    return a * 2 if da.sync_flag(a.any()) else a


def test_a_body_that_syncs_is_poisoned_and_runs_eagerly():
    x = torch.arange(3)
    c0, f0 = counter("ops.aot_compiles"), counter("ops.aot_fallbacks")
    for _ in range(3):
        assert torch.equal(aot_cache.aot_call("sync", _syncing, (x,), {}), x * 2)
    assert counter("ops.aot_compiles") == c0
    assert counter("ops.aot_fallbacks") - f0 == 3
    assert aot_cache.get_aot_cache().warm("sync", _syncing, (x,), {}) is False
    with da.capturing():
        with pytest.raises(da.HostSyncInCapture):
            da.sync_flag(x.any())
        with pytest.raises(da.HostSyncInCapture):
            da.reap_read(x)
        with pytest.raises(da.HostSyncInCapture):
            da.kick_async(x)


def test_warm_captures_without_a_call():
    x = torch.arange(5)
    cache = aot_cache.get_aot_cache()
    c0, h0 = counter("ops.aot_compiles"), counter("ops.aot_hits")
    assert cache.warm("w", _body, (x, x), dict(k=4)) is True
    assert cache.warm("w", _body, (x, x), dict(k=4)) is True
    assert counter("ops.aot_compiles") - c0 == 1
    aot_cache.aot_call("w", _body, (x, x), dict(k=4))
    assert counter("ops.aot_hits") - h0 == 1
    # unhashable statics cannot key: the call runs eagerly, counted as a
    # fallback (as the reference counts it), and nothing is captured
    f0 = counter("ops.aot_fallbacks")
    out = aot_cache.aot_call("w", lambda a, *, k: a + len(k), (x,), dict(k=[1, 2]))
    assert torch.equal(out, x + 2)
    assert cache.warm("w", lambda a, *, k: a, (x,), dict(k=[1])) is False
    assert counter("ops.aot_fallbacks") == f0 + 1
    assert cache.stats()["entries"] == 1


def _launching(a):
    note_launch("rev_band_relax")
    note_launch("rev_band_relax")
    return a + 1


def test_replays_count_the_launches_the_capture_saw():
    x = torch.arange(3)
    saved = dict(LAUNCHES)
    l0, d0 = LAUNCHES["rev_band_relax"], counter("ops.host_dispatches")
    try:
        for _ in range(3):
            aot_cache.aot_call("launching", _launching, (x,), {})
        assert LAUNCHES["rev_band_relax"] - l0 == 6
        assert counter("ops.host_dispatches") - d0 == 3 * (1 + 2)
    finally:
        # the counts are process-wide: other tests read them as CPU zeros
        LAUNCHES.update(saved)


def test_direct_calls_touch_no_cache_counter():
    x = torch.arange(3)
    before = {k: counter(k) for k in ("ops.aot_compiles", "ops.aot_hits", "ops.aot_fallbacks")}
    with aot_cache.direct():
        out, _ = aot_cache.aot_call("d", _body, (x, x), dict(k=1))
    assert torch.equal(out, 2 * x)
    assert before == {k: counter(k) for k in before}
    assert aot_cache.get_aot_cache().stats()["entries"] == 0


def test_cache_dir_follows_openr_cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENR_CACHE_DIR", raising=False)
    assert aot_cache.cache_dir() is None
    monkeypatch.setenv("OPENR_CACHE_DIR", str(tmp_path / "c"))
    assert aot_cache.cache_dir() == str(tmp_path / "c") and (tmp_path / "c").is_dir()


# -- the relax loops ----------------------------------------------------------


def _step(w):
    return lambda d: torch.minimum(d, (d[:, :, None] + w[None]).amin(1))


def _per_hop(step, d, limit):
    """The reference's ``while_loop``, a sync a hop: the hop count."""
    hops = 0
    while hops < limit:
        nxt = step(d)
        hops += 1
        changed = bool((nxt < d).any())
        d = nxt
        if not changed:
            break
    return d, hops


@pytest.mark.parametrize("n,chunk", [(12, 1), (12, 3), (12, 8), (30, 8), (5, 8), (30, 64)])
def test_chunked_fixed_point_matches_the_per_hop_loop(n, chunk):
    rng = np.random.default_rng(n + chunk)
    w = np.full((n, n), INF, dtype=np.int32)
    for i in range(n - 1):  # a path graph: n - 1 hops to converge
        w[i, i + 1] = w[i + 1, i] = int(rng.integers(1, 9))
    w = torch.from_numpy(w)
    d0 = torch.full((3, n), INF, dtype=torch.int32)
    d0[torch.arange(3), torch.tensor([0, n // 2, n - 1])] = 0
    want, want_hops = _per_hop(_step(w), d0, n)
    s0 = counter("ops.blocking_syncs")
    got, hops = relax_loop.fixed_point(_step(w), d0, n, chunk=chunk)
    assert torch.equal(got, want) and hops == want_hops
    assert counter("ops.blocking_syncs") - s0 == min((hops - 1) // chunk + 1,
                                                   -(-n // chunk))
    for budget in (1, 2, hops - 1, hops, n, n + 3):
        if budget < 1:
            continue
        d, changed = relax_loop.run_hops(_step(w), d0, budget)
        h, ok = relax_loop.hop_status(changed, budget, n)
        assert bool(ok) == (budget >= hops or budget >= n)
        if bool(ok):
            assert torch.equal(d, want) and int(h) == want_hops
    assert relax_loop.next_budget(8, 12) == 12 and relax_loop.next_budget(2, 12) == 4
    # a run as long as the previous one converges inside one chunk
    s0 = counter("ops.blocking_syncs")
    again, again_hops = relax_loop.fixed_point(_step(w), d0, n,
                                               chunk=relax_loop.chunk_for(hops))
    assert torch.equal(again, want) and again_hops == hops
    assert counter("ops.blocking_syncs") - s0 == (1 if hops >= 2 else -(-n // 8))
    assert relax_loop.chunk_for(0) == relax_loop.chunk_for(1) == relax_loop.HOP_CHUNK


@pytest.mark.parametrize("kind", KINDS)
def test_budgeted_reverse_fixed_point_matches_the_reference(kind):
    """Route-sweep rows through the chunked loop and through budgets
    equal the reference's ``while_loop`` rows, and the hop count is its
    iteration count (the per-hop loop's)."""
    import jax.numpy as jnp

    topo = jax_topologies.ring(16)
    ls = _port_ls(topo)
    t_ids = torch.arange(0, 16, 3, dtype=torch.int32)
    if kind == "ell":
        graph = route_sweep.compile_out_ell(ls)
        sw = route_sweep.RouteSweeper(graph, graph.node_names[:1], device=CPU)
        args = (graph.bands, sw.v_t, sw.w_t, sw.overloaded, t_ids, graph.n_pad)
        got, hops = route_sweep._rev_fixed_point(*args)
        jax_ls = _jax_ls(topo)
        jg = jax_sweep.compile_out_ell(jax_ls)
        jsw = jax_sweep.RouteSweeper(jg, jg.node_names[:1])
        want = np.asarray(jax_sweep._rev_fixed_point(
            jg.bands, jsw.v_t, jsw.w_t, jsw.overloaded, jnp.asarray(t_ids.numpy()), jg.n_pad))
        np.testing.assert_array_equal(got.numpy(), want)
        step = lambda d: route_sweep._rev_relax(d, graph.bands, sw.v_t, sw.w_t,  # noqa: E731
                                                sw.overloaded, t_ids)
        n = graph.n_pad
        budgeted = lambda b: route_sweep._rev_fixed_point(*args, budget=b)  # noqa: E731
    else:
        graph = spf_grouped.compile_out_grouped(ls)
        sw = spf_grouped.GroupedRouteSweeper(graph, graph.node_names[:1], device=CPU)
        got, hops = spf_grouped._grouped_fixed_point(
            sw.meta, sw.v_t, sw.w_t, sw.overloaded, t_ids, graph.n_pad, reverse=True,
            impl="batched_minplus")
        n = graph.n_pad
        step = lambda d: spf_grouped._grouped_relax(  # noqa: E731
            d, sw.meta, sw.v_t, sw.w_t, sw.overloaded, t_ids, "batched_minplus")
        budgeted = lambda b: spf_grouped._grouped_fixed_point(  # noqa: E731
            sw.meta, sw.v_t, sw.w_t, sw.overloaded, t_ids, n, reverse=True,
            impl="batched_minplus", budget=b)
    d0 = torch.full((len(t_ids), n), INF, dtype=torch.int32)
    d0[torch.arange(len(t_ids)), t_ids.long()] = 0
    want, want_hops = _per_hop(step, d0, n)
    assert torch.equal(got, want) and hops == want_hops > 2
    for budget in (2, hops, 40):
        d, (h, ok) = budgeted(budget)
        assert bool(ok) == (budget >= hops)
        if bool(ok):
            assert torch.equal(d, want) and int(h) == hops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("budget", [1, 2, 16])
def test_budgeted_cone_matches_the_reference_cut_at_its_budget(kind, budget):
    """A cone expansion with a jump budget equals the reference's with
    ``max_jumps`` at that budget (cone, rows, cells, jumps, converged), and
    says ``more`` exactly when the reference's loop would have gone on."""
    import jax.numpy as jnp

    from openr_tpu.ops import spf_grouped as jax_grouped

    from test_torch_route_engine import _cone_inputs  # noqa: PLC0415

    p, dr, e = _cone_inputs(0, kind)
    sel = dr[np.arange(0, dr.shape[0], 2)]
    je, pe = p.jax.engine, p.port.engine
    jargs = [jnp.asarray(e[:, c]) for c in range(4)]
    pargs = [torch.from_numpy(np.ascontiguousarray(e[:, c])) for c in range(4)]
    max_jumps = route_engine._FRONTIER_MAX_JUMPS

    def ref(jumps):
        if kind == "ell":
            return jax_sweep._cone_expand(jnp.asarray(sel), je.graph.bands, je.sweeper.v_t,
                                          je.sweeper.w_t, *jargs, jumps)
        return jax_grouped._grouped_cone_expand(jnp.asarray(sel), je.sweeper.meta,
                                                je.sweeper.v_t, je.sweeper.w_t, *jargs, jumps)

    if kind == "ell":
        got = route_sweep._cone_expand(torch.from_numpy(sel), pe.graph.bands, pe.sweeper.v_t,
                                       pe.sweeper.w_t, *pargs, max_jumps, jump_budget=budget)
    else:
        got = spf_grouped._grouped_cone_expand(
            torch.from_numpy(sel), pe.sweeper.meta, pe.sweeper.v_t, pe.sweeper.w_t, *pargs,
            max_jumps, jump_budget=budget)
    cut = min(budget, max_jumps)
    cone_j, rows_j, cells_j, jumps_j, ok_j = (np.asarray(x) for x in ref(cut))
    cone_p, rows_p, cells_p, jumps_p, ok_p, more_p = got
    np.testing.assert_array_equal(cone_j, cone_p.numpy())
    assert (int(rows_j), float(cells_j), int(jumps_j)) == (
        int(rows_p), float(cells_p), int(jumps_p))
    full_jumps = int(np.asarray(ref(max_jumps)[3]))
    assert bool(more_p) == (full_jumps > cut)
    if not bool(more_p):
        assert bool(ok_j) == bool(ok_p)


# -- the route engines through the cache (test_committed_dispatch.py) ---------


def _port_ls(topo):
    ls = LinkState(area=topo.area)
    for name, db in sorted(topo.adj_dbs.items()):
        (pdb,), _ = carry.lsdb_from_plain([carry.to_plain(db)], [])
        ls.update_adjacency_database(pdb)
    return ls


def _jax_ls(topo):
    from openr_tpu.graph.linkstate import LinkState as JaxLinkState

    ls = JaxLinkState(area=topo.area)
    for name, db in sorted(topo.adj_dbs.items()):
        ls.update_adjacency_database(db)
    return ls


def make_topo():
    return jax_topologies.fat_tree(pods=3, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=4)


def mutate_metric(ls, node, i, metric):
    db = ls.get_adjacency_databases()[node]
    adjs = list(db.adjacencies)
    adjs[i] = replace(adjs[i], metric=metric)
    ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))
    return {node, adjs[i].other_node_name}


def make_engine(kind, ls):
    names = sorted(ls.get_adjacency_databases().keys())
    cls = route_engine.RouteSweepEngine if kind == "ell" else \
        route_engine.GroupedRouteSweepEngine
    return cls(ls, [names[0]], device="cpu")


def first(engine, prefix):
    return next(n for n in engine.graph.node_names if n.startswith(prefix))


@pytest.mark.parametrize("kind", KINDS)
def test_warm_window_compiles_nothing(kind):
    """After a first pass, a second identical pass of events is served
    from the cache: no capture, every body a hit, no fallback. The cache
    starts empty here, so the test does not depend on the order of the
    tests before it."""
    # every count is a delta over this test: the registry is process-wide
    f0 = counter("ops.aot_fallbacks")
    ls = _port_ls(make_topo())
    engine = make_engine(kind, ls)
    rsw = first(engine, "rsw")
    seq = (7, 3, 11, 5)
    for metric in seq:
        engine.churn(ls, mutate_metric(ls, rsw, 0, metric))
    compiles0, hits0 = counter("ops.aot_compiles"), counter("ops.aot_hits")
    for metric in seq:
        assert engine.churn(ls, mutate_metric(ls, rsw, 0, metric)) is not None
    assert counter("ops.aot_compiles") == compiles0
    assert counter("ops.aot_hits") >= hits0 + len(seq)
    assert counter("ops.aot_fallbacks") == f0


@pytest.mark.parametrize("kind", KINDS)
def test_compile_count_ceiling_across_window(kind):
    ls = _port_ls(make_topo())
    c0 = counter("ops.aot_compiles")
    engine = make_engine(kind, ls)
    rsw = first(engine, "rsw")
    for metric in (7, 3, 11, 5, 9):
        engine.churn(ls, mutate_metric(ls, rsw, 0, metric))
    delta = counter("ops.aot_compiles") - c0
    assert 1 <= delta <= 6, f"{delta} captures for a cold build and 5 events"


@pytest.mark.parametrize("kind", KINDS)
def test_warm_event_two_touches_zero_blocking(kind):
    ls = _port_ls(make_topo())
    engine = make_engine(kind, ls)
    rsw = first(engine, "rsw")
    engine.churn(ls, mutate_metric(ls, rsw, 0, 7))  # warm-up
    for metric in (3, 11, 5):
        with da.event_window("test") as win:
            engine.churn(ls, mutate_metric(ls, rsw, 0, metric), defer_consume=True)
        assert win.touches <= 2, f"a warm event took {win.touches} touches"
        assert win.blocking_syncs == 0
        assert win.dispatches >= 1
    engine.flush()


@pytest.mark.parametrize("kind", KINDS)
def test_no_event_class_exceeds_two_blocking_syncs(kind, monkeypatch):
    monkeypatch.setattr(route_engine, "_ROW_BUCKETS", (8,))
    ls = _port_ls(make_topo())
    engine = make_engine(kind, ls)
    engine._k_hint = 8
    rsw, ssw = first(engine, "rsw"), first(engine, "ssw")
    paths = []
    for node, i, metric in ((rsw, 0, 7), (ssw, 0, 9), (rsw, 0, 3)):
        s0 = counter("ops.blocking_syncs")
        engine.churn(ls, mutate_metric(ls, node, i, metric))
        paths.append(engine.last_path)
        took = counter("ops.blocking_syncs") - s0
        assert took <= 2, f"an event on {node} took {took} blocking syncs"
    assert set(paths) & {"frontier", "full_width"}


@pytest.mark.parametrize("kind", KINDS)
def test_histogram_observed_per_window(kind):
    ls = _port_ls(make_topo())
    engine = make_engine(kind, ls)
    rsw = first(engine, "rsw")
    h = get_registry().histogram("ops.host_touches.churn")
    c0 = h.count
    engine.churn(ls, mutate_metric(ls, rsw, 0, 7))
    engine.churn(ls, mutate_metric(ls, rsw, 0, 3))
    assert h.count == c0 + 2


def test_counters_in_spf_snapshot():
    from openr_tpu_torch.decision.spf_solver import get_spf_counters

    out = get_spf_counters()
    for key in ("ops.host_dispatches", "ops.blocking_syncs", "ops.async_reaps",
                "ops.aot_compiles", "ops.aot_hits", "ops.aot_fallbacks"):
        assert key in out


@pytest.mark.parametrize("kind", KINDS)
def test_cached_and_direct_engines_are_bit_equal(kind):
    """The same events through an engine whose bodies replay from the
    cache and one whose bodies are called directly: equal rows after every
    event, equal hop logs, and the bodies that ran out of budget were
    re-dispatched, never committed."""
    ls = _port_ls(make_topo())
    cached = make_engine(kind, ls)
    with aot_cache.direct():
        direct = make_engine(kind, ls)
    rsw, ssw = first(cached, "rsw"), first(cached, "ssw")
    for node, metric in ((rsw, 7), (ssw, 9), (rsw, 3), (ssw, 2)):
        aff = mutate_metric(ls, node, 0, metric)
        got = cached.churn(ls, aff)
        with aot_cache.direct():
            want = direct.churn(ls, aff)
        assert got == want
        assert route_sweep.digests_by_name(cached.result) == \
            route_sweep.digests_by_name(direct.result)
        np.testing.assert_array_equal(cached._packed_host, direct._packed_host)
    assert cached.hops_log == direct.hops_log


@pytest.mark.parametrize("kind", KINDS)
def test_a_budget_that_runs_out_is_redispatched(kind, monkeypatch):
    """Hop and jump budgets of 1: every body runs out and is re-dispatched
    with a larger budget until it converges; the results equal an engine
    with the default budgets, and the engine keeps the larger budgets."""
    monkeypatch.setattr(relax_loop, "HOP_CHUNK", 1)
    monkeypatch.setattr(route_engine, "_JUMP_BUDGET", 1)
    ls = _port_ls(make_topo())
    r0 = counter("route_engine.budget_retries")
    small = make_engine(kind, ls)
    monkeypatch.undo()
    ref = make_engine(kind, ls)
    rsw = first(small, "rsw")
    for metric in (7, 3):
        aff = mutate_metric(ls, rsw, 0, metric)
        assert small.churn(ls, aff) == ref.churn(ls, aff)
        np.testing.assert_array_equal(small._packed_host, ref._packed_host)
    assert counter("route_engine.budget_retries") > r0
    assert all(h > 1 for h, _j in small._budgets.values())
    assert small.hops_log == ref.hops_log


def test_ksp2_dispatches_ride_the_cache():
    """The KSP2 dispatches go through ``ell_dispatch``: captured once a key,
    their status read once (not a sync a hop), equal to the bodies called
    directly and to the reference's masked solve."""
    import jax.numpy as jnp

    from openr_tpu.ops import spf_sparse as jax_sparse

    topo = jax_topologies.random_mesh(24, degree=3, seed=7, max_metric=9)
    ls = _port_ls(topo)
    graph = spf_sparse.compile_ell(ls)
    state = spf_sparse.EllState(graph, device=CPU)
    src = graph.node_index[sorted(graph.node_index)[0]]
    links = sorted(ls.links_from_node(graph.node_names[src]), key=repr)[:2]
    masks, ok = spf_sparse.build_edge_masks(graph, [[], links[:1], links])
    c0, s0 = counter("ops.aot_compiles"), counter("ops.blocking_syncs")
    got = spf_sparse.ell_masked_distances_resident(state, src, masks).reap()
    again = spf_sparse.ell_masked_distances_resident(state, src, masks).reap()
    assert counter("ops.aot_compiles") - c0 == 1
    # one status read and one readback a call
    assert counter("ops.blocking_syncs") - s0 == 4
    host = spf_sparse.ell_masked_distances(graph, src, masks, device=CPU)
    with aot_cache.direct():
        direct = spf_sparse.ell_masked_distances(graph, src, masks, device=CPU)
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, direct)
    jls = _jax_ls(topo)
    jg = jax_sparse.compile_ell(jls)
    jmasks, _ = jax_sparse.build_edge_masks(jg, [[], links[:1], links])
    want = jax_sparse.ell_masked_distances(jg, src, jmasks)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert jnp is not None


# -- the window's device-time attribution and the flight record --------------


def test_the_window_attribution_feeds_the_host_overhead_ratio():
    prof = port_profiler.reset_profiler(enabled=True)
    ref = JaxProfiler(enabled=True)
    try:
        windows = [("churn", 12.5, 2.5), ("churn", 30.0, 10.0), ("sweep", 4.0, 0.0)]
        for tag, wall, dev in windows:
            prof.on_window(tag, wall, dev)
            ref.on_window(tag, wall, dev)
        assert prof.host_overhead_ratio() == ref.host_overhead_ratio() == 3.4
        assert get_registry().snapshot()["ops.host_overhead_ratio"] == 3.4
        with da.event_window("attributed") as w:
            da.attribute_stage("body", 1.5, 0.5)
            da.attribute_stage("body", 1.0, 0.25)
            da.attribute_stage("other", 0.1, 0.05)
        assert w.stages == {"body": [2, 2.5, 0.75], "other": [1, 0.1, 0.05]}
        assert w.device_ms == pytest.approx(0.8)
        assert prof.host_overhead_ratio() != 3.4  # the window joined the ratio
        da.attribute_stage("outside", 1.0, 1.0)  # no window: nothing to fold
    finally:
        port_profiler.reset_profiler()


def test_flight_record_and_post_mortem_carry_the_ratio(tmp_path):
    """``get_flight_record`` (breeze monitor flight's call) answers with
    the ratio the reference's Profiler gives for the same windows; the
    post-mortem bundle carries it too."""
    from openr_tpu_torch.cli.breeze import Breeze, _InProcessClient
    from openr_tpu_torch.ctrl.handler import OpenrCtrlHandler
    from openr_tpu_torch.telemetry import get_flight_recorder

    prof = port_profiler.reset_profiler(enabled=True)
    ref = JaxProfiler(enabled=True)
    try:
        for wall, dev in ((9.0, 3.0), (5.0, 1.0)):
            prof.on_window("churn", wall, dev)
            ref.on_window("churn", wall, dev)
        rec = OpenrCtrlHandler.get_flight_record(None, 5)
        assert rec["host_overhead_ratio"] == ref.host_overhead_ratio() == 3.5
        assert set(rec) >= {"records", "triggers", "attribution"}
        out = io.StringIO()
        Breeze(_InProcessClient(OpenrCtrlHandler.__new__(OpenrCtrlHandler)),
               out=out).monitor_flight(limit=5)
        assert "host_overhead_ratio=3.5 " in out.getvalue()
        fr = get_flight_recorder()
        old_dir, fr.dump_dir = fr.dump_dir, str(tmp_path)
        try:
            path = fr.dump_postmortem("manual", "test")
        finally:
            fr.dump_dir = old_dir
        assert path is not None
        import gzip

        raw = gzip.open(path).read() if path.endswith(".gz") else open(path, "rb").read()
        bundle = json.loads(raw)
        assert bundle["host_overhead_ratio"] == 3.5
    finally:
        port_profiler.reset_profiler()
