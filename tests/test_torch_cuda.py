"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA card and nvcc; skips without a card. It imports nothing
of JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The tolerance is exact equality (int32, saturating at INF = 2^30 - 1).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from openr_tpu_torch.kernels import LAUNCHES, reset_launches
from openr_tpu_torch.ops import ell_relax, grouped_minplus, minplus, rev_relax

INF = (1 << 30) - 1


def _mat(rng, shape, inf_frac):
    a = rng.integers(0, 1000, shape).astype(np.int32)
    a[rng.random(shape) < inf_frac] = INF
    return torch.from_numpy(a)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launches()
    yield torch.device("cuda")
    reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,k,n",
    [
        # the dense route build's batches at 1008 nodes (S = 8 splits K 16
        # ways over grid.z, 64 takes eight S-tiles and 3 splits)
        (8, 1024, 1024), (16, 1024, 1024), (32, 1024, 1024), (64, 1024, 1024),
        # ragged: N % 4 != 0 (scalar b loads), S off the S-tile, K off the
        # lanes and the unroll, K = 0 (all INF), single elements
        (5, 77, 300), (33, 129, 65), (1, 1, 1), (8, 1000, 1001), (17, 3, 6),
        (3, 0, 10),
        # a thin grid with a long K: many splits of several slices each
        (1, 50_000, 7), (20, 4000, 40),
        # all pairs at 1024 nodes; S-tiles past one grid.y sweep
        (1024, 1024, 1024), (1_100_000, 2, 3),
    ],
)
def test_minplus_kernel_matches_plain(card, s, k, n):
    rng = np.random.default_rng(s + k + n)
    a = _mat(rng, (s, k), 0.3).to(card)
    b = _mat(rng, (k, n), 0.3).to(card)
    got = minplus.minplus(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["minplus"] == 1
    assert torch.equal(got, minplus.minplus_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,n,splits", [(8, 1024, 1024, True), (1, 50_000, 7, True),
                                          (64, 1024, 1000, True), (1024, 1024, 1024, False)])
def test_minplus_kernel_split_k(card, s, k, n, splits):
    """The K split over grid.z (partial mins in a scratch, then the
    reduce kernel) and the unsplit grid, each against the plain version;
    the plan splits K exactly when the test says. A b off a 16-byte
    boundary takes the scalar loads."""
    plan = minplus.minplus_plan(s, k, n)
    assert (plan.splits > 1) == splits
    rng = np.random.default_rng(s * k + n)
    a = _mat(rng, (s, k), 0.3).to(card)
    flat = _mat(rng, (k * n + 1,), 0.3).to(card)
    for b in (flat[:-1].view(k, n), flat[1:].view(k, n)):
        reset_launches()
        got = minplus.minplus(a, b)
        torch.cuda.synchronize()
        assert LAUNCHES["minplus"] == 1
        assert torch.equal(got, minplus.minplus_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n_pad,rows,k,pos",
    [(8, 10112, 7488, 8, 0), (8, 10112, 16, 1024, 9984), (3, 300, 50, 9, 17), (13, 256, 200, 24, 56)],
)
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_ell_band_relax_kernel_matches_plain(card, s, n_pad, rows, k, pos, mask_dtype):
    rng = np.random.default_rng(s + n_pad + rows + k)
    d = _mat(rng, (s, n_pad), 0.2).to(card)
    src = torch.from_numpy(rng.integers(0, n_pad, (rows, k)).astype(np.int32)).to(card)
    w = _mat(rng, (rows, k), 0.2).to(card)
    ov = torch.from_numpy(rng.random(n_pad) < 0.1).to(card).to(mask_dtype)
    want = ell_relax.ell_band_relax_plain(d, src, w, ov, pos)
    out = torch.full_like(d, -1)
    view = ell_relax.ell_band_relax(d, src, w, ov, pos, out=out)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == 1
    assert torch.equal(view, want)
    assert torch.equal(out[:, pos : pos + rows], want)
    assert (out[:, :pos] == -1).all() and (out[:, pos + rows :] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 255, 256, 257, 1024, 1500])
@pytest.mark.parametrize("s", [1, 8, 13, 300])
@pytest.mark.parametrize("rows", [1, 16, 17])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_ell_band_relax_wide_kernel_matches_plain(card, k, s, rows, mask_dtype):
    """Wide bands (k >= 33): a row's slots split over 32 to 256 threads,
    as the launch plan says, joined by warp and block min-reductions; k
    off the thread count and the unroll, rows off a block's row count."""
    plan = ell_relax.launch_plan(s, rows, k)
    assert plan.wide
    n_pad = rows + k + 37
    pos = n_pad - rows - 5
    rng = np.random.default_rng(k * 1000 + s * 10 + rows)
    d = _mat(rng, (s, n_pad), 0.2).to(card)
    src_np = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
    ov_np = rng.random(n_pad) < 0.1
    src_np[:, -1] = rng.choice(np.flatnonzero(ov_np), size=rows)  # overloaded origins
    src = torch.from_numpy(src_np).to(card)
    w = _mat(rng, (rows, k), 0.2).to(card)
    ov = torch.from_numpy(ov_np).to(card).to(mask_dtype)
    want = ell_relax.ell_band_relax_plain(d, src, w, ov, pos)
    out = torch.full_like(d, -1)
    view = ell_relax.ell_band_relax(d, src, w, ov, pos, out=out)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == 1
    assert torch.equal(view, want)
    assert (out[:, :pos] == -1).all() and (out[:, pos + rows :] == -1).all()


def _holed_worlds(rng, worlds, s, n, k, hole=0.2):
    """Ragged world blocks: each world's rows past a random count and its
    slots past a random width are self-loop INF padding (as
    ell_pack_uniform makes them), INF holes inside the rows' live
    prefixes, rows whose last slot is live, and all-padding rows."""
    d = _mat(rng, (worlds, s, n), 0.3)
    src = rng.integers(0, n, (worlds, n, k)).astype(np.int32)
    w = rng.integers(0, 1000, (worlds, n, k)).astype(np.int32)
    for x in range(worlds):
        rows, slots = int(rng.integers(1, n + 1)), int(rng.integers(1, k + 1))
        src[x, rows:] = np.arange(rows, n)[:, None]
        w[x, rows:] = INF
        w[x, :, slots:] = INF
    w[rng.random(w.shape) < hole] = INF
    w[:, : n // 4, -1] = 5  # the last slot live
    w[:, n // 2 : n // 2 + 3] = INF  # all-padding rows
    return d, torch.from_numpy(src), torch.from_numpy(w)


@pytest.mark.cuda
@pytest.mark.parametrize("worlds,s,n,k", [(1, 1, 40, 3), (3, 8, 300, 9), (7, 13, 257, 33),
                                          (64, 64, 1024, 64), (64, 8, 1024, 64),
                                          (64, 32, 1024, 64), (4, 8, 16384, 1024),
                                          (4, 8, 2048, 1024), (2, 5, 129, 1500),
                                          (5, 2, 129, 200), (4, 8, 1000, 1024),
                                          (2, 3, 70_000, 8)])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_ell_band_relax_worlds_kernel_matches_plain(card, worlds, s, n, k, mask_dtype):
    """The world axis (the tenant plane's uniform blocks): one launch for
    every world, each with its own slots and overload bits, over each
    row's live slots only; equal to the batched gather with and without
    the counts, and to a loop of single-world plain calls. The counts are
    the live pass's, given and computed by the wrapper. At n = 70 000 a
    distance row does not fit in shared memory: the gathers read device
    memory (the plan's ``slab`` False)."""
    assert ell_relax.worlds_plan(worlds, s, n, k).slab == (n < 50_000)
    rng = np.random.default_rng(worlds * 100 + s * 10 + k)
    d, src, w = (t.to(card) for t in _holed_worlds(rng, worlds, s, n, k))
    ov = torch.from_numpy(rng.random((worlds, n)) < 0.1).to(card).to(mask_dtype)
    want = ell_relax.ell_band_relax_worlds_plain(d, src, w, ov)
    live = ell_relax.live_slots(w)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_live_slots"] == 1 and LAUNCHES["ell_band_relax"] == 0
    assert torch.equal(live, ell_relax.live_slots_plain(w))
    assert torch.equal(ell_relax.ell_band_relax_worlds_plain(d, src, w, ov, live), want)
    got = ell_relax.ell_band_relax_worlds(d, src, w, ov, live)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == 1 and LAUNCHES["ell_live_slots"] == 1
    assert torch.equal(got, want)
    computed = ell_relax.ell_band_relax_worlds(d, src, w, ov)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == 2 and LAUNCHES["ell_live_slots"] == 2
    assert torch.equal(computed, want)
    for x in range(worlds):
        one = ell_relax.ell_band_relax_plain(d[x], src[x], w[x], ov[x], 0)
        assert torch.equal(got[x], one)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 33, 64, 1024, 1500])
def test_live_slots_kernel_matches_plain(card, k):
    """The live pass, 16-byte loads (k % 4 == 0) and scalar ones, on rows
    with INF holes, a live last slot and no live slot; a w off a 16-byte
    boundary takes the scalar loads."""
    rng = np.random.default_rng(k)
    flat = _mat(rng, (3 * 37 * k + 1,), 0.5).to(card)
    flat[: 37 * k + 1] = INF  # world 0 has no live slot in either view
    for w in (flat[:-1].view(3, 37, k), flat[1:].view(3, 37, k)):
        reset_launches()
        got = ell_relax.live_slots(w)
        torch.cuda.synchronize()
        assert LAUNCHES["ell_live_slots"] == 1
        assert torch.equal(got, ell_relax.live_slots_plain(w))
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_tenant_view_solve_replayed_as_a_graph_equals_eager(card, mask_dtype):
    """A whole ``_tenant_view_solve`` body (patch scatter, live pass, the
    relax's hop budget, first hops) captured into a CUDA graph and
    replayed on new inputs equals the body run eagerly on them."""
    from openr_tpu_torch.ops import spf_sparse

    b, s, n, k, p, e = 3, 8, 256, 16, 4, 8

    def inputs(seed):
        g = np.random.default_rng(seed)
        _, src, w = _holed_worlds(g, b, s, n, k, hole=0.1)
        ov = torch.from_numpy(g.random((b, n)) < 0.05).to(mask_dtype)
        srcs = torch.from_numpy(g.integers(0, n, (b, s)).astype(np.int32))
        p_rows = torch.full((b, p), n, dtype=torch.int32)
        p_rows[:, :2] = torch.from_numpy(g.integers(0, n, (b, 2)).astype(np.int32))
        p_src = torch.from_numpy(g.integers(0, n, (b, p, k)).astype(np.int32))
        p_w = torch.from_numpy(g.integers(1, 60, (b, p, k)).astype(np.int32))
        p_w[:, 0, k // 2 :] = INF
        inc_t = torch.zeros((b, e), dtype=torch.int32)
        inc_h = torch.zeros((b, e), dtype=torch.int32)
        inc_w = torch.full((b, e), INF, dtype=torch.int32)
        inc_w[:, 0] = 0  # the cold sentinel: every row reset
        d_prev = torch.full((b, s, n), INF, dtype=torch.int32)
        return [t.to(card) for t in (src, w, ov, srcs, p_rows, p_src, p_w,
                                     inc_t, inc_h, inc_w, d_prev)]

    budget = 32
    static = inputs(1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spf_sparse._tenant_view_solve(*static, budget=budget)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = spf_sparse._tenant_view_solve(*static, budget=budget)
    for seed in (2, 3):
        fresh = inputs(seed)
        for dst, src_t in zip(static, fresh):
            dst.copy_(src_t)
        reset_launches()
        graph.replay()
        torch.cuda.synchronize()
        assert LAUNCHES["ell_band_relax"] == 0  # a replay launches nothing new
        want = spf_sparse._tenant_view_solve(*fresh, budget=budget)
        torch.cuda.synchronize()
        assert LAUNCHES["ell_live_slots"] == 1 and LAUNCHES["ell_band_relax"] == budget + 1
        assert int(want[-1][1]) == 1  # converged within the budget
        for got, exp in zip(outs, want):
            assert torch.equal(got, exp)


# run lengths: the plan's own, and (through its least blocks) the
# shortest and the longest it allows, which take each wide RUN template
RUNS = {"plan": None, "shortest": 1 << 40, "longest": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n_pad,rows,k,pos",
    [
        # the 10 000-node KSP2 chunk (256 destinations) over the in-bands
        (256, 10112, 7488, 8, 0), (256, 10112, 2496, 16, 7488),
        (256, 10112, 16, 1024, 9984),
        # the 1008-node chunk (1024 destinations)
        (1024, 1024, 744, 8, 0), (1024, 1024, 248, 16, 744), (1024, 1024, 16, 64, 992),
        # ragged: S off the runs, rows below a block, k off a word (9, 24),
        # k past the narrow body (33) and past a row's staged piece (3000)
        (37, 300, 50, 9, 17), (3, 256, 5, 8, 100), (129, 700, 33, 64, 600),
        (13, 256, 200, 24, 56), (2, 1100, 3, 1024, 1000), (5, 500, 7, 33, 400),
        (9, 3100, 3, 3000, 3000), (70, 200, 40, 1, 100),
    ],
)
@pytest.mark.parametrize("runs", sorted(RUNS))
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_ell_band_relax_masked_kernel_matches_plain(card, monkeypatch, s, n_pad, rows, k,
                                                    pos, runs, mask_dtype):
    if RUNS[runs] is not None:
        for least in ("MASKED_NARROW_MIN_BLOCKS", "MASKED_WIDE_MIN_BLOCKS"):
            monkeypatch.setattr(ell_relax, least, RUNS[runs])
    plan = ell_relax.masked_plan(s, rows, k)
    assert plan.body == ("wide" if k >= 33 else "narrow")
    rng = np.random.default_rng(s + n_pad + rows + k)
    d = _mat(rng, (s, n_pad), 0.2).to(card)
    src_np = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
    ov_np = rng.random(n_pad) < 0.1
    src_np[:, 0] = rng.choice(np.flatnonzero(ov_np), size=rows)  # overloaded origins
    src = torch.from_numpy(src_np).to(card)
    w = _mat(rng, (rows, k), 0.2).to(card)
    mask_np = rng.random((s, rows, k)) < 0.05
    mask_np[::7] = True  # batch rows that lose every edge
    mask = ell_relax.pack_edge_mask(torch.from_numpy(mask_np)).to(card)
    ov = torch.from_numpy(ov_np).to(card).to(mask_dtype)
    want = ell_relax.ell_band_relax_masked_plain(d, src, w, mask, ov, pos)
    out = torch.full_like(d, -1)
    view = ell_relax.ell_band_relax_masked(d, src, w, mask, ov, pos, out=out)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax_masked"] == 1
    assert torch.equal(view, want)
    assert torch.equal(out[:, pos : pos + rows], want)
    assert (out[:, :pos] == -1).all() and (out[:, pos + rows :] == -1).all()
    # a mask that starts one word past a 16-byte boundary
    flat = torch.zeros(mask.numel() + 1, dtype=torch.int32, device=card)
    odd = flat[1:].view(mask.shape)
    odd.copy_(mask)
    assert odd.data_ptr() % 16 != 0
    out.fill_(-1)
    ell_relax.ell_band_relax_masked(d, src, w, odd, ov, pos, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out[:, pos : pos + rows], want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n_pad,rows,k,pos",
    [
        # the 10 000-node spine band widened once and twice (1024 -> 2048,
        # 4096 slots) at the view's batch and the KSP2 chunk; an 8-slot
        # rack band widened to 16
        (8, 10112, 16, 2048, 9984), (256, 10112, 16, 4096, 9984),
        (8, 10112, 7488, 16, 0), (256, 10112, 7488, 16, 0),
    ],
)
def test_ell_relax_kernels_at_a_widened_k(card, s, n_pad, rows, k, pos):
    """ell_patch(widen=True) doubles a band's k in place; both relax
    kernels take the new shape, as their launch plans say."""
    rng = np.random.default_rng(s + k)
    d = _mat(rng, (s, n_pad), 0.2).to(card)
    src_np = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
    src_np[:, k // 2 :] = (pos + np.arange(rows))[:, None]  # self-loop padding
    w_np = _mat(rng, (rows, k), 0.2).numpy()
    w_np[:, k // 2 :] = INF
    src, w = torch.from_numpy(src_np).to(card), torch.from_numpy(w_np).to(card)
    ov = torch.from_numpy(rng.random(n_pad) < 0.1).to(card)
    out = torch.full_like(d, -1)
    ell_relax.ell_band_relax(d, src, w, ov, pos, out=out)
    mask = ell_relax.pack_edge_mask(torch.from_numpy(rng.random((s, rows, k)) < 0.05)).to(card)
    out_m = torch.full_like(d, -1)
    ell_relax.ell_band_relax_masked(d, src, w, mask, ov, pos, out=out_m)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == 1 and LAUNCHES["ell_band_relax_masked"] == 1
    assert torch.equal(out[:, pos : pos + rows], ell_relax.ell_band_relax_plain(d, src, w, ov, pos))
    assert torch.equal(out_m[:, pos : pos + rows],
                       ell_relax.ell_band_relax_masked_plain(d, src, w, mask, ov, pos))


@pytest.mark.cuda
def test_dense_snapshot_patches_its_resident_matrix_on_the_card(card):
    """A topology version patched on the host scatters its changed rows
    into the previous version's metric tensor on the card (one staged
    copy of the rows), not a new upload of the whole matrix."""
    from dataclasses import replace

    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.graph.snapshot import SnapshotCache
    from openr_tpu_torch.models import topologies

    topo = topologies.grid(6)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    cache = SnapshotCache()
    first = cache.get(ls).device_arrays(cache.device, cache.stager)
    db = ls.get_adjacency_databases()["node-7"]
    ls.update_adjacency_database(replace(db, adjacencies=(
        replace(db.adjacencies[0], metric=9),) + db.adjacencies[1:]))
    snap = cache.get(ls)
    second = snap.device_arrays(cache.device, cache.stager)
    assert second.metric.data_ptr() == first.metric.data_ptr()
    assert torch.equal(second.metric.cpu(), torch.from_numpy(snap.metric))
    assert cache.stager.bytes["matrix"] == snap.metric.nbytes
    assert 0 < cache.stager.bytes["patch"] < snap.metric.nbytes


@pytest.mark.cuda
def test_reconverge_warm_matches_cold_on_the_card(card):
    """EllState.reconverge on the card through churn (metric up and
    down, link down and up, drain and undrain, two stacked patches): every
    warm view equals a cold solve over the same bands on the card and the
    same warm solve on the CPU, and the warm solves went through the
    ell_band_relax kernel."""
    from dataclasses import replace

    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import spf_sparse

    topo = topologies.fat_tree(4, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=6)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    root = "rsw-0-0"
    graph = spf_sparse.compile_ell(ls)
    states = {dev: spf_sparse.EllState(graph, dev) for dev in (card, torch.device("cpu"))}
    version = ls.topology_version

    def edit(node, **changes):
        db = ls.get_adjacency_databases()[node]
        ls.update_adjacency_database(replace(db, **changes))

    def metric(node, m):
        adjs = list(ls.get_adjacency_databases()[node].adjacencies)
        adjs[0] = replace(adjs[0], metric=m)
        edit(node, adjacencies=tuple(adjs))

    def solve(apply_only=False):
        nonlocal version
        affected = sorted(ls.affected_since(version))
        version = ls.topology_version
        views = {}
        for dev, state in states.items():
            patched = spf_sparse.ell_patch(state.graph, ls, affected, widen=True)
            if apply_only:
                state.apply_patch(patched)
                continue
            srcs = spf_sparse.ell_source_batch(patched, ls, root)
            views[dev] = state.reconverge(patched, srcs)
        if apply_only:
            return
        warm = views[card]
        cold = spf_sparse.ell_view_batch_packed(states[card].graph, srcs, card)
        torch.cuda.synchronize()
        assert torch.equal(warm, cold)
        assert torch.equal(warm.cpu(), views[torch.device("cpu")])

    solve()
    fsw = "fsw-1-0"
    dropped = ls.get_adjacency_databases()["fsw-2-1"]
    reset_launches()
    for step in (lambda: metric(fsw, 9), lambda: metric(fsw, 1),
                 lambda: edit("fsw-2-1", adjacencies=dropped.adjacencies[1:]),
                 lambda: ls.update_adjacency_database(dropped),
                 lambda: edit("ssw-0-0", is_overloaded=True),
                 lambda: edit("ssw-0-0", is_overloaded=False)):
        step()
        solve()
        assert states[card].last_warm
    metric(fsw, 4)
    solve(apply_only=True)
    metric(fsw, 20)
    solve()
    assert states[card].last_warm
    assert LAUNCHES["ell_band_relax"] > 0


@pytest.mark.cuda
def test_ell_band_relax_masked_rejects_what_the_kernel_does_not_take(card):
    d = torch.zeros((2, 16), dtype=torch.int32, device=card)
    src = torch.zeros((4, 16), dtype=torch.int32, device=card)
    w = torch.zeros((4, 16), dtype=torch.int32, device=card)
    bool_mask = torch.zeros((2, 4, 16), dtype=torch.bool, device=card)
    mask = ell_relax.pack_edge_mask(bool_mask)  # [2, 2] words
    ov = torch.zeros(16, dtype=torch.bool, device=card)
    out = torch.empty_like(d)
    for bad in (bool_mask, mask.to(torch.uint8), mask.to(torch.int64)):
        with pytest.raises(TypeError, match="packed int32"):
            ell_relax.ell_band_relax_masked(d, src, w, bad, ov, 0, out)
    strided = torch.zeros((2, 2), dtype=torch.int32, device=card).t()
    assert strided.shape == mask.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ell_relax.ell_band_relax_masked(d, src, w, strided, ov, 0, out)
    with pytest.raises(ValueError, match="mask"):
        ell_relax.ell_band_relax_masked(d, src, w, mask.cpu(), ov, 0, out)
    assert LAUNCHES["ell_band_relax_masked"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n_pad,rows,k,pos",
    [
        # the 10 000-node sweep's out-bands at a 1024-destination block
        (1024, 10112, 7488, 8, 0), (1024, 10112, 2496, 16, 7488),
        (1024, 10112, 16, 1024, 9984),
        # ragged: narrow and wide (warp per row, k >= 33) bodies
        (3, 300, 50, 9, 17), (13, 256, 200, 24, 56), (5, 700, 33, 64, 600),
        (2, 130, 3, 200, 127),
        # the 1008-node sweep's out-bands at a 256-destination block
        (256, 1024, 744, 8, 0), (256, 1024, 248, 16, 744), (256, 1024, 16, 64, 992),
        # B off the destination run (1000 = 31 runs of 32 + 8; 300 = 37
        # runs of 8 + 4), B = 1, rows below a tile with k = 1, 17 slots
        # (staged as 32), 40 slots (the wide body from 33)
        (1000, 10112, 7488, 8, 0), (1, 300, 50, 9, 17), (37, 256, 5, 1, 100),
        (300, 2000, 1300, 17, 700), (300, 2000, 1300, 40, 700),
    ],
)
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_rev_band_relax_kernel_matches_plain(card, b, n_pad, rows, k, pos, mask_dtype):
    rng = np.random.default_rng(b + n_pad + rows + k)
    d = _mat(rng, (b, n_pad), 0.2).to(card)
    v_np = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
    ov_np = rng.random(n_pad) < 0.1
    t_np = rng.integers(0, n_pad, b).astype(np.int32)
    # destinations that are overloaded nodes and band neighbours
    t_np[::3] = rng.choice(np.flatnonzero(ov_np), size=t_np[::3].shape)
    t_np[1::3] = v_np.reshape(-1)[rng.integers(0, v_np.size, t_np[1::3].shape)]
    v = torch.from_numpy(v_np).to(card)
    w = _mat(rng, (rows, k), 0.2).to(card)
    t_ids = torch.from_numpy(t_np).to(card)
    ov = torch.from_numpy(ov_np).to(card).to(mask_dtype)
    want = rev_relax.rev_band_relax_plain(d, v, w, t_ids, ov, pos)
    out = torch.full_like(d, -1)
    view = rev_relax.rev_band_relax(d, v, w, t_ids, ov, pos, out=out)
    torch.cuda.synchronize()
    assert LAUNCHES["rev_band_relax"] == 1
    assert torch.equal(view, want)
    assert torch.equal(out[:, pos : pos + rows], want)
    assert (out[:, :pos] == -1).all() and (out[:, pos + rows :] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,rows,k", [(1000, 300, 8), (300, 1300, 17), (5, 33, 1), (64, 40, 100)])
def test_rev_band_relax_kernel_staged_overloaded_destinations(card, b, rows, k):
    """Destinations that are overloaded nodes the band's slots stage: the
    v == t exception lets their edges through, per destination row of a
    block's run."""
    n_pad = 2 * rows + 64
    pos = n_pad - rows
    rng = np.random.default_rng(b + rows + k)
    v_np = rng.integers(0, pos, (rows, k)).astype(np.int32)
    ov_np = np.zeros(n_pad, dtype=bool)
    ov_np[v_np[::2].reshape(-1)] = True  # every slot of every other row
    t_np = rng.choice(np.unique(v_np[::2]), size=b).astype(np.int32)
    t_np[::5] = rng.integers(0, n_pad, t_np[::5].shape)  # and some others
    # as in a sweep: dr[b, t] = 0; the band's own columns start at INF
    d_np = _mat(rng, (b, n_pad), 0.2).numpy()
    d_np[np.arange(b), t_np] = 0
    d_np[:, pos:] = INF
    d = torch.from_numpy(d_np).to(card)
    v = torch.from_numpy(v_np).to(card)
    w = _mat(rng, (rows, k), 0.0).to(card)
    t_ids = torch.from_numpy(t_np).to(card)
    ov = torch.from_numpy(ov_np).to(card)
    want = rev_relax.rev_band_relax_plain(d, v, w, t_ids, ov, pos)
    out = torch.full_like(d, -1)
    got = rev_relax.rev_band_relax(d, v, w, t_ids, ov, pos, out=out)
    torch.cuda.synchronize()
    assert LAUNCHES["rev_band_relax"] == 1
    assert torch.equal(got, want)
    assert (out[:, :pos] == -1).all()
    # without the exception the rows whose slots are all overloaded stay
    # INF: the exception made a difference
    blocked = rev_relax.rev_band_relax_plain(
        d, v, w, torch.full_like(t_ids, -1), ov, pos
    )
    assert not torch.equal(blocked, want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,b,s,r",
    [
        # the 10 000-node grouped sweep's segments at B = 1024
        (624, 1024, 4, 12), (624, 1024, 12, 4), (4, 1024, 4, 624), (4, 1024, 624, 4),
        # ragged, and S past the Pallas s-block cap of 512
        (3, 5, 7, 9), (1, 1, 1, 1), (7, 19, 3, 1), (2, 8, 600, 3), (3, 9, 1030, 5),
        # the 1008-node grouped sweep's segments at B = 256
        (62, 256, 4, 12), (62, 256, 12, 4), (4, 256, 4, 62), (4, 256, 62, 4),
        # S split with R past one R-tile and B off 32; no split with R past
        # one R-tile and B off 32
        (3, 33, 1030, 20), (4, 100, 700, 40), (2, 1000, 3, 100), (5, 70, 64, 17),
    ],
)
@pytest.mark.parametrize("transposed", [False, True], ids=["bgs", "sgb"])
def test_batched_minplus_kernel_matches_plain(card, g, b, s, r, transposed):
    rng = np.random.default_rng(g + b + s + r)
    w = _mat(rng, (g, s, r), 0.3).to(card)
    if transposed:
        gath = _mat(rng, (g, s, b), 0.3).to(card)
        got = grouped_minplus.batched_minplus_t(gath, w)
        want = grouped_minplus.batched_minplus_t_plain(gath, w)
        name = "batched_minplus_t"
    else:
        gath = _mat(rng, (g, b, s), 0.3).to(card)
        got = grouped_minplus.batched_minplus(gath, w)
        want = grouped_minplus.batched_minplus_plain(gath, w)
        name = "batched_minplus"
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1
    assert torch.equal(got, want)


# G = 1..4 in turn, B, S and R on and off the vector width, the R-tile
# and the cols body's threads; both bodies with and without a split S
BATCHED_RAGGED = [
    (1 + i % 4, b, s, r)
    for i, (r, b, s) in enumerate(
        (r, b, s) for r in (1, 5, 16, 17, 624, 700) for b in (1, 33, 1100)
        for s in (3, 8, 624, 2000)
    )
]


@pytest.mark.cuda
@pytest.mark.parametrize("g,b,s,r", BATCHED_RAGGED)
def test_batched_minplus_kernel_ragged(card, g, b, s, r):
    plan = grouped_minplus.minplus_plan(g, b, s, r)
    assert plan.body == ("rows" if r <= 16 else "cols")
    rng = np.random.default_rng(g + b * 7 + s * 11 + r * 13)
    gath = _mat(rng, (g, b, s), 0.3).to(card)
    w = _mat(rng, (g, s, r), 0.3).to(card)
    got = grouped_minplus.batched_minplus(gath, w)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_minplus"] == 1
    assert torch.equal(got, grouped_minplus.batched_minplus_plain(gath, w))


@pytest.mark.cuda
def test_batched_minplus_kernel_unaligned_operands(card):
    """Operands off a 16-byte boundary take the scalar loads and stores."""
    rng = np.random.default_rng(5)
    g, b, s, r = 3, 70, 8, 12
    flat = _mat(rng, (g * b * s + 1,), 0.3).to(card)
    gath = flat[1:].view(g, b, s)
    assert gath.data_ptr() % 16 != 0
    w = _mat(rng, (g, s, r), 0.3).to(card)
    got = grouped_minplus.batched_minplus(gath, w)
    torch.cuda.synchronize()
    assert torch.equal(got, grouped_minplus.batched_minplus_plain(gath, w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,b,s,r,splits,r_tiles",
    [(4, 1024, 624, 4, True, False), (3, 33, 1030, 20, True, True),
     (4, 1024, 4, 624, False, True), (2, 1000, 3, 100, False, True)],
)
def test_batched_minplus_t_kernel_split_and_r_tiles(card, g, b, s, r, splits, r_tiles):
    """The S-split branch (partials in a scratch, then the reduce kernel)
    and the R-tiled grid, each against the plain version; the plan the
    wrapper takes splits S, and tiles R, exactly when the test says."""
    plan = grouped_minplus.minplus_t_plan(g, b, s, r)
    assert (plan.splits > 1) == splits
    assert (plan.grid[1] > 1) == r_tiles
    rng = np.random.default_rng(g * b + s * r)
    gath = _mat(rng, (g, s, b), 0.3).to(card)
    w = _mat(rng, (g, s, r), 0.3).to(card)
    got = grouped_minplus.batched_minplus_t(gath, w)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_minplus_t"] == 1
    assert torch.equal(got, grouped_minplus.batched_minplus_t_plain(gath, w))


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", [1000, 10000])
def test_ell_band_relax_at_all_sources_matches_plain(card, nodes):
    """One relax step of the KSP2 engine's all-sources solve, S = n_pad
    rows (1024 and 10112), over a fabric's in-bands: the kernel against
    the plain version on slices of 1024 rows (the plain gather holds
    [S, rows, k] at once), and the fixed point on the card against the
    one on the CPU."""
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import spf_sparse

    topo = topologies.fat_tree_nodes(nodes)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    graph = spf_sparse.compile_ell(ls)
    s = graph.n_pad
    rng = np.random.default_rng(nodes)
    src = tuple(torch.from_numpy(x).to(card) for x in graph.src)
    w = tuple(torch.from_numpy(x).to(card) for x in graph.w)
    ov = torch.from_numpy(rng.random(s) < 0.05).to(card)
    d = _mat(rng, (s, s), 0.5).to(card)
    got = spf_sparse._ell_relax(d, graph.bands, src, w, ov)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_band_relax"] == len(graph.bands)
    for rows in (slice(0, 1024), slice(s - 1024, s)):
        pos = 0
        for band, s_b, w_b in zip(graph.bands, src, w):
            want = ell_relax.ell_band_relax_plain(d[rows], s_b, w_b, ov, pos)
            assert torch.equal(got[rows, pos : pos + band.rows], want)
            pos += band.rows
    if nodes == 1000:
        ids = np.arange(s)
        on_card = spf_sparse.ell_distances_from_sources(graph, ids, device=card)
        on_cpu = spf_sparse.ell_distances_from_sources(graph, ids, device="cpu")
        assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", ["1", "0"])
def test_ksp2_engine_on_the_card_matches_the_cpu(card, monkeypatch, fast):
    """The KSP2 engine's route databases and counters through churn, on
    the card and on the CPU, each solver on its own databases; after
    every event the engine's resident all-sources matrix on the card
    equals the CPU's and a cold solve on the card."""
    from dataclasses import replace

    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import spf_sparse
    from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm, PrefixForwardingType

    monkeypatch.setenv("OPENR_KSP2_FAST", fast)
    monkeypatch.setattr(spf_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    topo = topologies.fat_tree_nodes(
        120, forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
        forwarding_type=PrefixForwardingType.SR_MPLS)

    def world():
        ls = LinkState(area=topo.area)
        for name in sorted(topo.adj_dbs):
            ls.update_adjacency_database(topo.adj_dbs[name])
        ps = PrefixState()
        for name in sorted(topo.prefix_dbs):
            ps.update_prefix_database(topo.prefix_dbs[name])
        return {topo.area: ls}, ps

    root = "rsw-0-0"
    runs = {dev: (spf_solver.SpfSolver(root, backend="device", device=dev), world())
            for dev in (card, torch.device("cpu"))}
    names = sorted(topo.adj_dbs)
    fsw = next(n for n in names if n.startswith("fsw"))
    far = [n for n in names if n.startswith("rsw")][-1]

    def event(change):
        for _, (areas, _) in runs.values():
            (ls,) = areas.values()
            db = ls.get_adjacency_databases()[change[0]]
            ls.update_adjacency_database(change[1](db))

    def metric(node, m):
        return node, lambda db: replace(db, adjacencies=(
            replace(db.adjacencies[0], metric=m),) + db.adjacencies[1:])

    def build():
        out = {}
        for dev, (solver, (areas, ps)) in runs.items():
            before = dict(spf_solver.SPF_COUNTERS)
            got = solver.build_route_db(root, areas, ps)
            counts = {k: spf_solver.SPF_COUNTERS[k] - before[k]
                      for k in before if "ksp2" in k}
            (ls,) = areas.values()
            out[dev] = (carry.route_db_to_plain(got.to_route_db(root)), counts,
                        solver._ksp2_engines[ls])
        (db_card, c_card, e_card), (db_cpu, c_cpu, e_cpu) = out[card], out[torch.device("cpu")]
        assert db_card == db_cpu and c_card == c_cpu
        assert torch.equal(e_card.d_prev_dev.cpu(), e_cpu.d_prev_dev)
        state = e_card.state
        cold = spf_sparse.ell_distances_from_sources(
            state.graph, np.arange(state.graph.n_pad), state=state)
        assert torch.equal(e_card.d_prev_dev, cold)
        assert (e_card.masks_t is not None) == (fast == "1")
        return c_card

    build()
    reset_launches()
    syncs = 0
    for change in (metric(fsw, 3), metric(far, 4), metric(far, 5),
                   (fsw, lambda db: replace(db, is_overloaded=True)),
                   (fsw, lambda db: replace(db, is_overloaded=False)), metric(far, 6)):
        event(change)
        syncs += build()["decision.ksp2_incremental_syncs"]
    assert syncs > 0
    assert LAUNCHES["ell_band_relax"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,sparse", [(120, False), (120, True)], ids=["dense", "sparse"])
def test_decision_on_the_card_matches_the_cpu(card, monkeypatch, nodes, sparse):
    """The port's Decision module on the card and on the CPU, fed the same
    publications through a churn sequence (bench and remote events, a
    burst that saturates the debounce, a drain): the emitted updates,
    installed route databases and decision.* counter deltas are equal, and
    the card's rebuilds launched their kernels."""
    import dataclasses
    from dataclasses import replace

    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.messaging.queue import ReplicateQueue
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.telemetry import get_registry
    from openr_tpu_torch.types import Publication, Value
    from openr_tpu_torch.utils import keys, wire

    if sparse:
        monkeypatch.setattr(spf_solver, "SPARSE_NODE_THRESHOLD", 8)
    topo = topologies.fat_tree_nodes(nodes)
    root = "rsw-0-0"
    mods = {dev: Decision(root, ReplicateQueue(), ReplicateQueue(), device=dev)
            for dev in (card, torch.device("cpu"))}
    readers = {dev: d.route_updates_queue.get_reader("t") for dev, d in mods.items()}
    versions = {}

    def publish(dbs):
        kv = {}
        for db in dbs:
            key = (keys.adj_key if hasattr(db, "adjacencies") else keys.prefix_db_key)(
                db.this_node_name)
            versions[key] = versions.get(key, 0) + 1
            kv[key] = Value(versions[key], db.this_node_name, wire.dumps(db))
        for d in mods.values():
            d._on_publication(Publication(key_vals=kv, area=topo.area))

    def form(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return tuple((f.name, form(getattr(x, f.name))) for f in dataclasses.fields(x)
                         if f.name not in ("perf_events", "trace"))
        if isinstance(x, (set, frozenset)):
            return tuple(sorted(map(form, x), key=repr))
        if isinstance(x, dict):
            return tuple(sorted(((form(k), form(v)) for k, v in x.items()), key=repr))
        if isinstance(x, (list, tuple)):
            return tuple(map(form, x))
        return x

    def step():
        got = {}
        for dev, d in mods.items():
            c0 = dict(get_registry()._counters)
            if d._rebuild_debounced.is_scheduled():
                d._rebuild_debounced._handle.cancel()
                d._rebuild_debounced._fire()
            ups = []
            while (u := readers[dev].try_get()) is not None:
                ups.append(form(u))
            c1 = dict(get_registry()._counters)
            deltas = {k: v - c0.get(k, 0) for k, v in c1.items()
                      if k.startswith("decision.") and v != c0.get(k, 0)
                      and not k.startswith("decision.rung")}
            got[dev] = (ups, form(d.route_db.unicast_routes), form(d.route_db.mpls_routes),
                        deltas)
        assert got[card] == got[torch.device("cpu")]

    publish(list(topo.adj_dbs.values()) + list(topo.prefix_dbs.values()))
    step()
    reset_launches()
    adj = dict(topo.adj_dbs)
    far = sorted(n for n in adj if n.startswith("rsw"))[-1]
    fsws = sorted(n for n in adj if n.startswith("fsw"))
    for node, metric in (("fsw-0-0", 3), (far, 4), ("fsw-0-0", 5)):
        adj[node] = replace(adj[node], adjacencies=(
            replace(adj[node].adjacencies[0], metric=metric),) + adj[node].adjacencies[1:])
        publish([adj[node]])
        step()
    for i in range(8):  # one saturated window: prewarm and speculation
        node = fsws[i % len(fsws)]
        adj[node] = replace(adj[node], adjacencies=(
            replace(adj[node].adjacencies[0], metric=2 + i),) + adj[node].adjacencies[1:])
        publish([adj[node]])
    step()
    adj[fsws[3]] = replace(adj[fsws[3]], is_overloaded=True)
    publish([adj[fsws[3]]])
    step()
    kernel = "ell_band_relax" if sparse else "minplus"
    assert LAUNCHES[kernel] > 0
