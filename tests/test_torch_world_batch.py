"""The port's tenant plane (``openr_tpu_torch.ops.world_batch``) against the
JAX package's, on the CPU.

In the shape of ``tests/test_world_batch.py``: the same worlds (made with
the JAX package's topology generators and handed to the port through
``openr_tpu_torch.carry``) churn in lockstep under both packages.

- ``ell_band_relax_worlds_plain`` equals a loop of single-world
  ``ell_band_relax_plain`` calls and the reference's ``_uniform_relax``
  under ``jax.vmap``, over ragged random worlds with INF and overloaded
  nodes; ``ell_pack_uniform``/``ell_uniform_rows`` equal the reference's.
- ``world_view_solve`` and the fused ``world_dispatch`` equal the
  reference's, array for array, including the compacted delta rows, the
  ``cap`` overflow and the dropped out-of-bounds patch rows.
- ``WorldManager.solve_views`` equals the reference's ``WorldManager``
  round by round on ``tools/tenancy_smoke.py``'s eight mixed tenants under
  metric, structural and overload churn: views and ``tenancy.*`` counter
  deltas equal (but the gauges: ``active`` and ``resident`` are the last
  manager's, ``wave_occupancy`` in the reference follows the iteration
  order of a set of buckets; each manager's own are checked instead).
- Batch composition, bucket joins (no new ``ops.aot_compiles`` key),
  eviction and warm rehydration, ``solve_views_pipelined``, ``ksp2_view``,
  the export record in both directions, the multi-area Decision build
  with ``world_batch`` on and off, and the view-cache LRU.

Everything is int32: equality is exact.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import route_engine as jax_engine
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.ops import world_batch as jax_wb
from openr_tpu.types import IpPrefix as JaxIpPrefix
from openr_tpu.types import PrefixDatabase as JaxPrefixDatabase
from openr_tpu.types import PrefixEntry as JaxPrefixEntry
from openr_tpu_torch import carry
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.ops import ell_relax
from openr_tpu_torch.ops import route_engine as port_engine
from openr_tpu_torch.ops import spf_sparse as port_sparse
from openr_tpu_torch.ops import world_batch as port_wb
from openr_tpu_torch.telemetry import get_registry

CPU = torch.device("cpu")
INF = (1 << 30) - 1
# gauges, not counters: "active" and "resident" are set by whichever
# manager of the process updated last, and "wave_occupancy" in the
# reference by the iteration order of a set of buckets; each manager's
# own gauges are checked against it instead
GAUGES = ("active", "resident", "wave_occupancy")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the tenant worlds here are small, and a loaded
    test run's threads would fight more of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches():
    yield
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


# -- worlds in lockstep ---------------------------------------------------------


class Pair:
    """One world under both packages: the reference's LinkState and the
    port's, fed the same databases."""

    def __init__(self, topo):
        self.jax = JaxLinkState(area=topo.area)
        self.port = LinkState(area=topo.area)
        for name in sorted(topo.adj_dbs):
            self.set_db(topo.adj_dbs[name])
        self.root = sorted(topo.adj_dbs)[0]

    def set_db(self, jax_db) -> None:
        self.jax.update_adjacency_database(jax_db)
        (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
        self.port.update_adjacency_database(db)

    def db(self, node):
        return self.jax.get_adjacency_databases()[node]

    def nodes(self):
        return sorted(self.jax.get_adjacency_databases())

    def set_metric(self, node, i, metric) -> None:
        adjs = list(self.db(node).adjacencies)
        adjs[i] = replace(adjs[i], metric=metric)
        self.set_db(replace(self.db(node), adjacencies=tuple(adjs)))

    def drop_adj(self, node, i):
        adjs = list(self.db(node).adjacencies)
        dropped = adjs.pop(i)
        self.set_db(replace(self.db(node), adjacencies=tuple(adjs)))
        return dropped

    def restore_adj(self, node, adj) -> None:
        db = self.db(node)
        self.set_db(replace(db, adjacencies=tuple(list(db.adjacencies) + [adj])))

    def set_overload(self, node, flag) -> None:
        self.set_db(replace(self.db(node), is_overloaded=flag))


def _mixed(extra_seed=0):
    """``tools/tenancy_smoke.py``'s eight mixed-size worlds (two shape
    buckets)."""
    t = jax_topologies
    return [
        Pair(topo) for topo in (
            t.grid(3), t.grid(4), t.grid(5),
            t.random_mesh(20, 3, seed=7 + extra_seed),
            t.random_mesh(30, 4, seed=11 + extra_seed),
            t.random_mesh(48, 4, seed=13 + extra_seed),
            t.random_mesh(64, 3, seed=17 + extra_seed),
            t.random_mesh(150, 3, seed=19 + extra_seed),
        )
    ]


def _items(pairs, side, prefix="t"):
    return [(f"{prefix}{i}", getattr(p, side), p.root) for i, p in enumerate(pairs)]


def _port_oracle(ls, root):
    graph = port_sparse.compile_ell(ls)
    srcs = port_sparse.ell_source_batch(graph, ls, root)
    return srcs, port_sparse.ell_view_batch_packed(graph, srcs, CPU).numpy()


class Managers:
    """A reference and a port ``WorldManager`` of the same settings."""

    def __init__(self, **kw):
        self.jax = jax_wb.WorldManager(**kw)
        self.port = port_wb.WorldManager(device=CPU, **kw)

    def solve(self, pairs, tag, prefix="t", oracle=True):
        """One ``solve_views`` of each; views equal each other and the
        port's sequential oracle, counter deltas equal. Returns the
        port's views and counter deltas."""
        j0, p0 = dict(jax_wb.TENANCY_COUNTERS), dict(port_wb.TENANCY_COUNTERS)
        want = self.jax.solve_views(_items(pairs, "jax", prefix))
        got = self.port.solve_views(_items(pairs, "port", prefix))
        for i, ((_, ws, wp), (_, gs, gp)) in enumerate(zip(want, got)):
            assert gs == ws, (tag, i)
            np.testing.assert_array_equal(gp, np.asarray(wp), err_msg=f"{tag}:{i}")
            if oracle:
                srcs, ref = _port_oracle(pairs[i].port, pairs[i].root)
                assert srcs == gs
                np.testing.assert_array_equal(gp, ref, err_msg=f"{tag}:{i} oracle")
        jd = {k: jax_wb.TENANCY_COUNTERS[k] - j0[k] for k in j0 if k not in GAUGES}
        pd = {k: port_wb.TENANCY_COUNTERS[k] - p0[k] for k in p0 if k not in GAUGES}
        assert pd == jd, tag
        assert port_wb.TENANCY_COUNTERS["active"] == len(self.port._tenants)
        assert port_wb.TENANCY_COUNTERS["resident"] == self.port.resident_count()
        assert self.port.resident_count() == self.jax.resident_count()
        return got, pd


# -- the kernel's plain version and the uniform blocks --------------------------


def _ragged_worlds(seed, b=4, s=8, n=96, k=12):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 500, (b, s, n)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = INF
    src = rng.integers(0, n, (b, n, k)).astype(np.int32)
    w = rng.integers(1, 60, (b, n, k)).astype(np.int32)
    for x in range(b):
        # ragged worlds: each a different count of live rows and slots;
        # the rest self-loop INF padding, as ell_pack_uniform makes it
        rows, slots = int(rng.integers(n // 3, n + 1)), int(rng.integers(1, k + 1))
        src[x, rows:] = np.arange(rows, n)[:, None]
        w[x, rows:] = INF
        w[x, :, slots:] = INF
    w[rng.random(w.shape) < 0.1] = INF
    ov = rng.random((b, n)) < 0.15
    return d, src, w, ov


@pytest.mark.parametrize("seed", range(6))
def test_worlds_plain_equals_single_world_loop_and_the_reference_vmap(seed):
    d, src, w, ov = _ragged_worlds(seed)
    got = ell_relax.ell_band_relax_worlds(*(torch.from_numpy(a) for a in (d, src, w, ov)))
    for x in range(d.shape[0]):
        one = ell_relax.ell_band_relax_plain(
            torch.from_numpy(d[x]), torch.from_numpy(src[x]), torch.from_numpy(w[x]),
            torch.from_numpy(ov[x]), 0,
        )
        assert torch.equal(got[x], one)
    want = jax.vmap(lambda *a: jax_sparse._uniform_relax(*a, impl="jnp"))(
        jnp.asarray(d), jnp.asarray(src), jnp.asarray(w), jnp.asarray(ov)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_worlds_plan_counts_every_world():
    # every world is a slice of the grid's third axis, and the row tiles
    # shrink in number only while the worlds together fill the card
    one = ell_relax.worlds_plan(1, 8, 1024, 64)
    many = ell_relax.worlds_plan(64, 8, 1024, 64)
    assert many.grid[2] == 64 and one.grid[2] == 1
    assert many.grid[0] <= one.grid[0]
    assert many.grid[:2] == (-(-1024 // many.tile_rows), -(-8 // many.run))
    with pytest.raises(ValueError):
        ell_relax.worlds_plan(0, 8, 1024, 64)


def _live_loop(w):
    b, n, k = w.shape
    out = np.zeros((b, n), dtype=np.int32)
    for x in range(b):
        for j in range(n):
            for slot in range(k):
                if w[x, j, slot] < INF:
                    out[x, j] = slot + 1
    return out


def _holed_worlds(seed, b=3, s=5, n=40, k=9):
    """Ragged worlds with INF holes inside the rows' live prefixes, rows
    whose last slot is live, all-padding rows and a patched row."""
    d, src, w, ov = _ragged_worlds(seed, b, s, n, k)
    rng = np.random.default_rng(seed + 100)
    w[rng.random(w.shape) < 0.25] = INF  # holes anywhere in a row
    w[0, 1, -1] = 7  # the last slot live
    w[0, 1, 0] = INF
    w[1, :3] = INF  # all-padding rows
    w[2, 4] = rng.integers(1, 60, k)  # a patched row, every slot live
    return d, src, w, ov


@pytest.mark.parametrize("seed", range(4))
def test_live_slots_plain_equals_a_numpy_loop(seed):
    _, _, w, _ = _holed_worlds(seed)
    got = ell_relax.live_slots(torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _live_loop(w))
    assert int(got[1, 0]) == 0 and int(got[0, 1]) == w.shape[2]
    empty = ell_relax.live_slots_plain(torch.zeros((2, 3, 0), dtype=torch.int32))
    assert empty.shape == (2, 3) and not empty.any()


@pytest.mark.parametrize("seed", range(4))
def test_worlds_plain_with_live_equals_without_and_the_reference(seed):
    d, src, w, ov = _holed_worlds(seed, k=12 + 5 * seed)
    ts = [torch.from_numpy(a) for a in (d, src, w, ov)]
    live = ell_relax.live_slots(ts[2])
    got = ell_relax.ell_band_relax_worlds(*ts, live)
    assert torch.equal(got, ell_relax.ell_band_relax_worlds_plain(*ts))
    want = jax.vmap(lambda *a: jax_sparse._uniform_relax(*a, impl="jnp"))(
        *(jnp.asarray(a) for a in (d, src, w, ov)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_worlds_plain_stops_at_the_live_count_given():
    # slots at and past the given count are left out, so a count one
    # short drops the row's last live edge
    d, src, w, ov = _holed_worlds(9)
    ts = [torch.from_numpy(a) for a in (d, src, w, ov)]
    short = (ell_relax.live_slots(ts[2]) - 1).clamp_min(0)
    cut = w.copy()
    cut[np.arange(w.shape[2])[None, None, :] >= short.numpy()[:, :, None]] = INF
    want = ell_relax.ell_band_relax_worlds_plain(ts[0], ts[1], torch.from_numpy(cut), ts[3])
    assert torch.equal(ell_relax.ell_band_relax_worlds_plain(*ts, short), want)
    with pytest.raises(ValueError):
        ell_relax.ell_band_relax_worlds_plain(*ts, short.long())
    with pytest.raises(ValueError):
        ell_relax.ell_band_relax_worlds(*ts, short[:, :-1])


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), b=st.integers(1, 4), s=st.integers(1, 13),
       n=st.integers(1, 40), k=st.integers(0, 20), hole=st.floats(0.0, 1.0))
def test_worlds_plain_with_live_on_random_ragged_blocks(seed, b, s, n, k, hole):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 500, (b, s, n)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = INF
    src = rng.integers(0, n, (b, n, k)).astype(np.int32)
    w = rng.integers(1, 60, (b, n, k)).astype(np.int32)
    w[rng.random(w.shape) < hole] = INF
    ov = rng.random((b, n)) < 0.2
    ts = [torch.from_numpy(a) for a in (d, src, w, ov)]
    live = ell_relax.live_slots(ts[2])
    np.testing.assert_array_equal(live.numpy(), _live_loop(w))
    got = ell_relax.ell_band_relax_worlds(*ts, live)
    assert torch.equal(got, ell_relax.ell_band_relax_worlds_plain(*ts))
    if k:
        want = jax.vmap(lambda *a: jax_sparse._uniform_relax(*a, impl="jnp"))(
            *(jnp.asarray(a) for a in (d, src, w, ov)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_worlds_wrapper_checks_shapes():
    d, src, w, ov = (torch.from_numpy(a) for a in _ragged_worlds(0))
    with pytest.raises(ValueError):
        ell_relax.ell_band_relax_worlds(d, src[:, :-1], w[:, :-1], ov)
    with pytest.raises(TypeError):
        ell_relax.ell_band_relax_worlds(d.long(), src, w, ov)


def _bucket_graphs(pairs):
    graphs = [(jax_sparse.compile_ell(p.jax), port_sparse.compile_ell(p.port)) for p in pairs]
    n = port_wb._pow2_at_least(max(g.n_pad for _, g in graphs), 128)
    k = port_wb._pow2_at_least(max(max(b.k for b in g.bands) for _, g in graphs), 16)
    return graphs, n, k


def test_uniform_pack_and_rows_equal_the_reference():
    pairs = _mixed()
    graphs, n, k = _bucket_graphs(pairs)
    for jg, pg in graphs:
        for a, b in zip(jax_sparse.ell_pack_uniform(jg, n, k), port_sparse.ell_pack_uniform(pg, n, k)):
            np.testing.assert_array_equal(a, b)
        ids = np.arange(0, sum(bd.rows for bd in pg.bands), 3, dtype=np.int32)
        for a, b in zip(jax_sparse.ell_uniform_rows(jg, ids, k), port_sparse.ell_uniform_rows(pg, ids, k)):
            np.testing.assert_array_equal(a, b)


def _dispatch_inputs(pairs, seed, cold):
    """One bucket's dispatch operands for both packages: packed blocks of
    real graphs, patch rows (real ids, the out-of-bounds padding id ``n``
    and idle tenants), increase deltas (the cold sentinel, real edges,
    INF padding) and a previous solve's rows."""
    rng = np.random.default_rng(seed)
    graphs, n, k = _bucket_graphs(pairs)
    b = len(pairs)
    packs = [port_sparse.ell_pack_uniform(pg, n, k) for _, pg in graphs]
    src = np.stack([p[0] for p in packs])
    w = np.stack([p[1] for p in packs])
    ov = np.stack([p[2] for p in packs])
    s = 16
    srcs = np.zeros((b, s), dtype=np.int32)
    for x, (p, (_, pg)) in enumerate(zip(pairs, graphs)):
        row = port_sparse.ell_source_batch(pg, p.port, p.root)[:s]
        srcs[x] = row + [row[0]] * (s - len(row))
    slots = 8
    p_rows = np.full((b, slots), n, dtype=np.int32)
    p_src = np.zeros((b, slots, k), dtype=np.int32)
    p_w = np.zeros((b, slots, k), dtype=np.int32)
    for x in range(0, b, 2):  # odd tenants idle
        ids = np.sort(rng.choice(len(pairs[x].nodes()), size=3, replace=False)).astype(np.int32)
        p_rows[x, :3] = ids
        p_src[x, :3] = src[x, ids]
        p_w[x, :3] = np.where(w[x, ids] < INF, w[x, ids] + 5, INF)
    e = 64
    inc_t = np.zeros((b, e), dtype=np.int32)
    inc_h = np.zeros((b, e), dtype=np.int32)
    inc_w = np.full((b, e), INF, dtype=np.int32)
    if not cold:
        for x in range(1, b):
            live = np.argwhere(w[x] < INF)[:4]
            for y, (h, sl) in enumerate(live):
                inc_t[x, y], inc_h[x, y], inc_w[x, y] = src[x, h, sl], h, w[x, h, sl]
    inc_w[0, 0] = 0  # tenant 0: the _FORCE_RESET_EDGE sentinel
    d_prev = np.full((b, s, n), INF, dtype=np.int32)
    packed_prev = np.zeros((b, 2 * s, n), dtype=np.int32)
    return [src, w, ov, srcs, p_rows, p_src, p_w, inc_t, inc_h, inc_w, d_prev], packed_prev


def _jax_args(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("seed", range(3))
def test_world_view_solve_equals_the_reference(seed):
    pairs = _mixed(extra_seed=seed)[:5]
    args, _ = _dispatch_inputs(pairs, seed, cold=True)
    first = jax_sparse.world_view_solve(*_jax_args(args))
    got = port_sparse.world_view_solve(*(torch.from_numpy(a) for a in args))
    for a, b in zip(first, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the package's entry: world_dispatch's first four outputs
    fused = port_engine.world_dispatch(*(torch.from_numpy(a) for a in args),
                                       torch.zeros_like(got[0]), 64)
    for a, b in zip(first, fused[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # warm: the previous rows seed the next solve under increases
    args, _ = _dispatch_inputs(pairs, seed, cold=False)
    args[-1] = np.asarray(first[1])
    want = jax_sparse.world_view_solve(*_jax_args(args))
    got = port_sparse.world_view_solve(*(torch.from_numpy(a) for a in args))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", range(2))
def test_world_view_solve_counts_live_slots_after_the_patch(seed):
    """A patch that gives a row a live slot past its old count (and one
    that empties a row) is relaxed over: the counts are taken after the
    scatter, and the solve equals the reference's."""
    pairs = _mixed(extra_seed=seed)[:4]
    args, _ = _dispatch_inputs(pairs, seed, cold=True)
    src, w, p_rows, p_src, p_w = args[0], args[1], args[4], args[5], args[6]
    k = w.shape[2]
    for x in range(0, len(pairs), 2):
        short = [j for j in p_rows[x] if j < w.shape[1] and (w[x, j] == INF).any()]
        if not short:
            continue
        i = list(p_rows[x]).index(short[0])
        p_src[x, i, -1] = src[x, p_rows[x, i], 0]
        p_w[x, i, -1] = 3  # live at the block's last slot
        p_w[x, i + 1, :] = INF  # the next patched row loses every slot
    assert (p_w[:, :, -1] == 3).any()
    want = jax_sparse.world_view_solve(*_jax_args(args))
    got = port_sparse.world_view_solve(*(torch.from_numpy(a) for a in args))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(ell_relax.live_slots(got[3]).max()) == k


@pytest.mark.parametrize("cap", [4, 64, 1024])
def test_world_dispatch_and_compaction_equal_the_reference(cap):
    pairs = _mixed()[:6]
    args, packed_prev = _dispatch_inputs(pairs, cap, cold=True)
    first = jax_engine.world_dispatch(*_jax_args(args), jnp.asarray(packed_prev), cap=cap)
    args, _ = _dispatch_inputs(pairs, cap + 1, cold=False)
    args[-1] = np.asarray(first[1])
    prev = np.asarray(first[0])
    want = jax_engine.world_dispatch(*_jax_args(args), jnp.asarray(prev), cap=cap)
    got = port_engine.world_dispatch(*(torch.from_numpy(a) for a in args),
                                     torch.from_numpy(prev), cap)
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cnt = int(want[4])
    assert int(got[4]) == cnt and cnt > 0
    assert got[5].shape == tuple(want[5].shape)
    # the compacted rows; the overflow slot at ``cap`` is unspecified
    # in the reference (the port leaves it zero)
    rows = min(cnt, cap)
    np.testing.assert_array_equal(got[5][:rows].numpy(), np.asarray(want[5])[:rows])
    # a hop budget gives the same outputs and a converged status
    budgeted = port_engine.world_dispatch(*(torch.from_numpy(a) for a in args),
                                          torch.from_numpy(prev), cap, budget=64)
    for a, b in zip(got, budgeted[:6]):
        assert torch.equal(a, b)
    assert int(budgeted[6][1]) == 1


def test_compact_rows_with_ids_equals_the_reference():
    rng = np.random.default_rng(5)
    new = rng.integers(0, 9, (3, 6, 10)).astype(np.int32)
    prev = new.copy()
    prev[rng.random(prev.shape) < 0.05] += 1
    for cap in (2, 5, 18):
        cnt, out = jax_engine.compact_rows_with_ids(jnp.asarray(new), jnp.asarray(prev), cap=cap)
        pc, po = port_engine.compact_rows_with_ids(torch.from_numpy(new), torch.from_numpy(prev), cap)
        assert int(pc) == int(cnt)
        rows = min(int(cnt), cap)
        np.testing.assert_array_equal(po[:rows].numpy(), np.asarray(out)[:rows])


# -- the manager ------------------------------------------------------------------


def test_solve_views_rounds_equal_the_reference_under_churn():
    pairs = _mixed()
    mgrs = Managers(slots_per_bucket=8, max_resident=64)
    _, d = mgrs.solve(pairs, "cold")
    assert d["cold_solves"] == 8 and d["admissions"] == 8
    for p in pairs[::2]:
        p.set_metric(p.root, 0, 55)
    _, d = mgrs.solve(pairs, "metric")
    assert d["warm_solves"] >= 4
    nodes = pairs[3].nodes()
    dropped = pairs[3].drop_adj(nodes[1], 0)
    mgrs.solve(pairs, "link-down")
    pairs[3].restore_adj(nodes[1], dropped)
    mgrs.solve(pairs, "link-up")
    pairs[4].set_overload(pairs[4].nodes()[2], True)
    mgrs.solve(pairs, "overload-on")
    pairs[4].set_overload(pairs[4].nodes()[2], False)
    mgrs.solve(pairs, "overload-off")
    _, d = mgrs.solve(pairs, "idle")
    assert d["dispatches"] == 0


def test_overrides_and_shared_graph_vantages_equal_the_reference():
    """Vantage tenants over ONE LinkState share its compiled graph
    (``tenancy.graph_shares``); a vantage-local override solves cold."""
    pair = Pair(jax_topologies.random_mesh(40, 3, seed=23))
    roots = pair.nodes()[:6]
    mgrs = Managers(slots_per_bucket=8)

    def solve(tag, override=None):
        j0, p0 = dict(jax_wb.TENANCY_COUNTERS), dict(port_wb.TENANCY_COUNTERS)
        items = [(f"v{i}", r) for i, r in enumerate(roots)]
        want = mgrs.jax.solve_views(
            [(t, pair.jax, r, override if i == 1 else None) for i, (t, r) in enumerate(items)])
        got = mgrs.port.solve_views(
            [(t, pair.port, r, override if i == 1 else None) for i, (t, r) in enumerate(items)])
        for (_, ws, wp), (_, gs, gp) in zip(want, got):
            assert gs == ws
            np.testing.assert_array_equal(gp, np.asarray(wp), err_msg=tag)
        jd = {k: jax_wb.TENANCY_COUNTERS[k] - j0[k] for k in j0 if k not in GAUGES}
        pd = {k: port_wb.TENANCY_COUNTERS[k] - p0[k] for k in p0 if k not in GAUGES}
        assert pd == jd, tag
        return pd

    d = solve("cold")
    assert d["graph_shares"] >= len(roots) - 1
    pair.set_metric(pair.nodes()[5], 0, 17)
    solve("churn")
    d = solve("override", {pair.nodes()[3]: True})
    assert d["override_solves"] == 1
    solve("restored")


def test_batch_composition_independence():
    pairs = _mixed(extra_seed=300)
    solo = port_wb.WorldManager(slots_per_bucket=8, device=CPU)
    batched = port_wb.WorldManager(slots_per_bucket=8, device=CPU)
    solo_views = solo.solve_views(_items(pairs[:1], "port"))
    batched_views = batched.solve_views(_items(pairs, "port"))
    np.testing.assert_array_equal(solo_views[0][2], batched_views[0][2])


def test_bucket_join_adds_no_executable_key():
    """Joining tenants of warm shapes and churning them runs the same
    ``world_dispatch`` keys: the CPU cache keeps the card's key table,
    so ``ops.aot_compiles`` stays flat, as the reference's compile count
    does."""
    reg = get_registry()
    fallbacks0 = reg.counter_get("ops.aot_fallbacks")
    pairs = _mixed(extra_seed=400)
    mgr = port_wb.WorldManager(slots_per_bucket=8, device=CPU)
    mgr.solve_views(_items(pairs, "port"))
    pairs[1].set_metric(pairs[1].root, 0, 77)
    mgr.solve_views(_items(pairs, "port"))
    compiles0 = reg.counter_get("ops.aot_compiles")
    buckets0 = port_wb.TENANCY_COUNTERS["bucket_compiles"]
    joins = _mixed(extra_seed=400)
    for p in joins:
        p.set_metric(p.root, 0, 33)
    mgr.solve_views(_items(joins, "port", prefix="j"))
    pairs[1].set_metric(pairs[1].root, 0, 88)
    mgr.solve_views(_items(pairs, "port"))
    assert reg.counter_get("ops.aot_compiles") == compiles0
    assert port_wb.TENANCY_COUNTERS["bucket_compiles"] == buckets0
    assert reg.counter_get("ops.aot_fallbacks") == fallbacks0


def test_evict_rehydrate_warm_equals_the_reference():
    t = jax_topologies
    pairs = [Pair(t.grid(3)), Pair(t.grid(4)), Pair(t.random_mesh(20, 3, seed=7))]
    mgrs = Managers(slots_per_bucket=2)
    _, d = mgrs.solve(pairs, "wave")
    assert d["evictions"] > 0 and mgrs.port.resident_count() == 2
    evicted = [i for i in range(3) if mgrs.port._tenants[f"t{i}"].slot is None
               and mgrs.port._tenants[f"t{i}"].solved]
    assert evicted
    p = pairs[evicted[0]]
    p.set_metric(p.root, 0, 123)
    _, d = mgrs.solve(pairs, "rehydrate")
    assert d["rehydrations"] >= 1 and d["warm_solves"] >= 1 and d["cold_solves"] == 0


def test_solve_views_pipelined_equals_the_reference():
    pairs = _mixed(extra_seed=600)
    mgrs = Managers(slots_per_bucket=8)
    batches = [pairs[:3], pairs[3:6], pairs[6:]]
    for rnd in range(2):
        if rnd:
            for p in pairs[::3]:
                p.set_metric(p.root, 0, 40 + rnd)
        want = mgrs.jax.solve_views_pipelined([_items(b, "jax", f"b{i}_") for i, b in enumerate(batches)])
        got = mgrs.port.solve_views_pipelined([_items(b, "port", f"b{i}_") for i, b in enumerate(batches)])
        for wb, gb, b in zip(want, got, batches):
            for (_, ws, wp), (_, gs, gp), p in zip(wb, gb, b):
                assert gs == ws
                np.testing.assert_array_equal(gp, np.asarray(wp))
                np.testing.assert_array_equal(gp, _port_oracle(p.port, p.root)[1])


def test_a_spent_hop_budget_re_dispatches_at_the_reap(monkeypatch):
    """A launch whose hop budget runs out is solved again at the reap
    with a larger one; the views are the sequential oracle's."""
    monkeypatch.setitem(port_sparse._HOP_BUDGET, "world_dispatch", 1)
    pairs = _mixed(extra_seed=700)
    mgr = port_wb.WorldManager(slots_per_bucket=8, device=CPU)
    views = mgr.solve_views(_items(pairs, "port"))
    assert port_sparse._HOP_BUDGET["world_dispatch"] > 1
    for p, (_, srcs, packed) in zip(pairs, views):
        want_srcs, want = _port_oracle(p.port, p.root)
        assert srcs == want_srcs
        np.testing.assert_array_equal(packed, want)


@pytest.mark.parametrize("topo", ["grid4", "mesh24"])
def test_ksp2_view_equals_the_reference(topo):
    t = jax_topologies
    pair = Pair(t.grid(4) if topo == "grid4" else t.random_mesh(24, 3, seed=11))
    mgrs = Managers(slots_per_bucket=4)
    mgrs.solve([pair], "solve")
    dsts = [n for n in pair.nodes() if n != pair.root]
    want = mgrs.jax.ksp2_view("t0", dsts)
    got = mgrs.port.ksp2_view("t0", dsts)
    assert carry.paths_to_keys(got) == carry.paths_to_keys(want)
    for dst in dsts[:6]:
        host = pair.port.get_kth_paths(pair.root, dst, 1) + pair.port.get_kth_paths(pair.root, dst, 2)
        assert got[dst] == host


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_export_record_imports_into_the_other_package(direction):
    """The export record is the reference's, field for field: a tenant
    exported by either package imports WARM into the other and its next
    solve after churn equals the exporter's."""
    pair = Pair(jax_topologies.random_mesh(30, 4, seed=5))
    mgrs = Managers(slots_per_bucket=4)
    mgrs.solve([pair], "solve")
    pair.set_metric(pair.root, 0, 9)
    mgrs.solve([pair], "churn")
    src_mgr, dst_cls = ((mgrs.port, jax_wb) if direction == "port_to_jax" else (mgrs.jax, port_wb))
    rec = src_mgr.export_tenant("t0")
    other = mgrs.jax if src_mgr is mgrs.port else mgrs.port
    assert set(rec) == set(other.export_tenant("t0"))
    if dst_cls is jax_wb:
        dst, ls = jax_wb.WorldManager(slots_per_bucket=4), pair.jax
    else:
        dst, ls = port_wb.WorldManager(slots_per_bucket=4, device=CPU), pair.port
    colds = dst_cls.TENANCY_COUNTERS["tenant_import_colds"]
    t = dst.import_tenant(ls, rec)
    assert t.solved and dst_cls.TENANCY_COUNTERS["tenant_import_colds"] == colds
    pair.set_metric(pair.nodes()[3], 0, 21)
    cold0 = dst_cls.TENANCY_COUNTERS["cold_solves"]
    (_, srcs, packed), = dst.solve_views([("t0", ls, pair.root)])
    assert dst_cls.TENANCY_COUNTERS["cold_solves"] == cold0
    ref_srcs, ref = _port_oracle(pair.port, pair.root)
    assert list(srcs) == ref_srcs
    np.testing.assert_array_equal(np.asarray(packed), ref)


def test_park_drop_slo_and_compaction_equal_the_reference():
    pairs = [Pair(jax_topologies.grid(3)) for _ in range(6)]
    mgrs = Managers(slots_per_bucket=8)
    mgrs.solve(pairs, "first")
    for m in (mgrs.jax, mgrs.port):
        m.set_slo_class("t0", "premium")
        with pytest.raises(ValueError):
            m.set_slo_class("t1", "gold")
        for i in range(2, 6):
            m.park(f"t{i}")
    assert mgrs.port.slo_class("t0") == mgrs.jax.slo_class("t0") == "premium"
    assert mgrs.port.compact_buckets(0.5) == mgrs.jax.compact_buckets(0.5) == 1
    assert [b.slots for b in mgrs.port._buckets.values()] == [b.slots for b in mgrs.jax._buckets.values()]
    for p in pairs:
        p.set_metric(p.root, 0, 6)
    mgrs.solve(pairs, "regrow")
    for m in (mgrs.jax, mgrs.port):
        m.drop("t5")
    assert mgrs.port.resident_count() == mgrs.jax.resident_count()


def test_world_manager_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_wb.WorldManager()
    assert port_wb.WorldManager(device="cpu").device == CPU


# -- Decision ---------------------------------------------------------------------


class _Areas:
    """``TestDecisionWiring``'s three areas, prefixes and the build with
    one metric change, under both packages."""

    def __init__(self):
        t = jax_topologies
        self.pairs = {f"area{i}": Pair(topo) for i, topo in
                      enumerate([t.grid(3), t.grid(4), t.random_mesh(20, 3, seed=7)])}
        self.jax_ps, self.ps = JaxPrefixState(), PrefixState()
        for a, p in self.pairs.items():
            for node in p.nodes()[:4]:
                db = JaxPrefixDatabase(
                    this_node_name=node,
                    prefix_entries=(JaxPrefixEntry(
                        prefix=JaxIpPrefix.from_str(f"fd00:{a[-1]}:{node.split('-')[-1]}::/64")),),
                    area=a,
                )
                self.jax_ps.update_prefix_database(db)
                _, (pdb,) = carry.lsdb_from_plain([], [carry.to_plain(db)])
                self.ps.update_prefix_database(pdb)

    def areas(self, side):
        return {a: getattr(p, side) for a, p in self.pairs.items()}


def _builds(world_batch, deltas):
    port_solver.reset_device_caches()
    jax_solver.reset_device_caches()
    w = _Areas()
    port = port_solver.SpfSolver("node-0", device=CPU, world_batch=world_batch)
    ref = jax_solver.SpfSolver("node-0", world_batch=world_batch)
    out = []
    for step in range(2):
        if step:
            w.pairs["area1"].set_metric("node-1", 0, 44)
        keys = ("decision.world_preloads", "decision.world_preload_failures")
        p0 = [port_solver.SPF_COUNTERS[k] for k in keys]
        j0 = [jax_solver.SPF_COUNTERS[k] for k in keys]
        got = port.build_route_db("node-0", w.areas("port"), w.ps)
        want = ref.build_route_db("node-0", w.areas("jax"), w.jax_ps)
        pd = [port_solver.SPF_COUNTERS[k] - v for k, v in zip(keys, p0)]
        assert pd == [jax_solver.SPF_COUNTERS[k] - v for k, v in zip(keys, j0)], step
        deltas.append(pd)
        got_p = carry.route_db_to_plain(got.to_route_db("node-0"))
        assert got_p == carry.route_db_to_plain(want.to_route_db("node-0")), step
        out.append(got_p)
    return out


def test_multi_area_world_batch_build_equals_the_reference():
    """Builds with the world batch on and off equal each other and the
    reference's; the preload counters move as the reference's do (the
    first build batches three areas, the second only the changed one,
    which is no batch) and no preload fails."""
    try:
        off, on = [], []
        seq = _builds(False, off)
        world = _builds(True, on)
        assert off == [[0, 0], [0, 0]]
        assert on == [[1, 0], [0, 0]]
        assert seq == world
    finally:
        port_solver.reset_device_caches()
        jax_solver.reset_device_caches()


def test_reset_device_caches_resets_the_world_managers():
    mgr = port_wb.get_world_manager(CPU)
    pair = Pair(jax_topologies.grid(3))
    mgr.solve_views([("r", pair.port, pair.root)])
    assert mgr.resident_count() == 1
    port_solver.reset_device_caches()
    assert port_wb.get_world_manager(CPU) is not mgr
    assert port_wb.get_world_manager(CPU).resident_count() == 0
    port_wb.reset_world_manager()


def test_view_cache_lru_and_its_eviction_counter(monkeypatch):
    pairs = [Pair(jax_topologies.grid(3)) for _ in range(3)]
    solver = port_solver.SpfSolver("node-0", device=CPU, view_cache_cap=2)
    ref = jax_solver.SpfSolver("node-0", view_cache_cap=2)
    assert solver.view_cache_cap == 2
    e0 = port_solver.SPF_COUNTERS["route_engine.view_evictions"]
    j0 = jax_solver.SPF_COUNTERS["route_engine.view_evictions"]
    for i, p in enumerate(pairs + pairs[:1]):
        solver._view(f"a{i}", p.port, "node-0")
        ref._view(f"a{i}", p.jax, "node-0")
    assert len(solver._views) == len(ref._views) == 2
    assert (port_solver.SPF_COUNTERS["route_engine.view_evictions"] - e0
            == jax_solver.SPF_COUNTERS["route_engine.view_evictions"] - j0 == 2)
    monkeypatch.setattr(port_solver, "VIEW_CACHE_CAP_DEFAULT", 7)
    assert port_solver.SpfSolver("n", device=CPU).view_cache_cap == 7
    assert port_solver.SpfSolver("n", device=CPU, view_cache_cap=3).view_cache_cap == 3
