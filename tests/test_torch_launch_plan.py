"""The launch plans of the port's redesigned CUDA kernels.

``ell_relax.launch_plan`` (``csrc/ell_relax.cu``), ``ell_relax.masked_plan``
(``csrc/ell_relax_masked.cu``), ``ell_relax.worlds_plan``
(``csrc/ell_relax_worlds.cu``, the tenant plane's world relax), ``rev_relax.launch_plan``
(``csrc/rev_relax.cu``), ``minplus.minplus_plan`` (``csrc/minplus.cu``),
``grouped_minplus.minplus_plan`` and ``grouped_minplus.minplus_t_plan``
(``csrc/grouped_minplus.cu``, ``batched_minplus`` and
``batched_minplus_t``) are pure functions of the shapes, so their grids
are checked here on the CPU, for a sweep of shapes that includes the main
path's own (the dense route build's min-plus product at the 1008-node
fabric; the sparse route build's in-bands at the 10 000-node fabric; the
KSP2 masked solve's in-bands and destination chunk at both fabrics; both
route sweeps: the 1008-node fabric at a 256-destination block, the
10 000-node one at 1024): each output element is covered by exactly one
(block, thread) and each reduction term by exactly one split, the grid
stays within CUDA's limits, the scratch matches the splits, and the main
path's shapes fill the card. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest

from openr_tpu_torch.decision.spf_solver import _ksp2_chunk
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.graph.snapshot import SnapshotCache
from openr_tpu_torch.models import topologies
from openr_tpu_torch.ops import ell_relax as er
from openr_tpu_torch.ops import grouped_minplus as gm
from openr_tpu_torch.ops import minplus as mp
from openr_tpu_torch.ops import rev_relax as rr
from openr_tpu_torch.ops import route_sweep, spf, spf_grouped, spf_sparse

GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65535
SMS = 132

# (B, rows, k) of each out-band of the two route sweeps
SWEEP_REV = {
    1000: [(256, 744, 8), (256, 248, 16), (256, 16, 64)],
    10000: [(1024, 7488, 8), (1024, 2496, 16), (1024, 16, 1024)],
}
# (G, B, S, R) of each grouped segment of the two route sweeps
SWEEP_GROUPED = {
    1000: [(62, 256, 4, 12), (62, 256, 12, 4), (4, 256, 4, 62), (4, 256, 62, 4)],
    10000: [(624, 1024, 4, 12), (624, 1024, 12, 4), (4, 1024, 4, 624),
            (4, 1024, 624, 4)],
}
SWEEP_BLOCK = {1000: 256, 10000: 1024}
# (S, rows, k) of each in-band of the 10 000-node sparse route build's view
# solve (the root's batch of itself and its 4 fabric switches, padded)
SPARSE_ELL = [(8, 7488, 8), (8, 2496, 16), (8, 16, 1024)]

# (S, K, N) of the 1008-node dense route build's min-plus product (the
# root's batch of itself and its 4 fabric switches, padded; the metric
# matrix padded to 1024), and the larger batches of high-degree roots
DENSE_MINPLUS = [(8, 1024, 1024), (16, 1024, 1024), (32, 1024, 1024),
                 (64, 1024, 1024)]
# (S, rows, k) of each in-band of the KSP2 masked solve: the 1008-node
# fabric's destination chunk of 1024, the 10 000-node one's of 256
KSP2_MASKED = {
    1000: [(1024, 744, 8), (1024, 248, 16), (1024, 16, 64)],
    10000: [(256, 7488, 8), (256, 2496, 16), (256, 16, 1024)],
}

MINPLUS_SHAPES = sorted(
    set(DENSE_MINPLUS)
    | {(s, k, n) for s in (1, 5, 8, 15, 16, 33, 64, 1024) for k in (0, 1, 77, 129, 1024, 5000)
       for n in (1, 3, 65, 300, 1024)}
    | {(2_000_000, 4, 5), (1, 1 << 20, 1), (3, 100_000, 70)}
)
MASKED_SHAPES = sorted(
    {shape for shapes in KSP2_MASKED.values() for shape in shapes}
    | {(s, rows, k) for s in (1, 2, 37, 129, 1024) for rows in (1, 3, 16, 17, 129, 744)
       for k in (0, 1, 8, 9, 16, 24, 32, 33, 64, 255, 256, 1024, 1500)}
    | {(100_000, 3, 8), (600_000, 17, 40), (2, 100_000, 2048)}
)

ELL_SHAPES = sorted(
    set(SPARSE_ELL)
    | {(s, rows, k) for s in (1, 8, 13, 300) for rows in (1, 16, 17, 129)
       for k in (0, 8, 32, 33, 64, 255, 256, 257, 1024, 1500)}
    | {(65535, 3, 40), (2, 100_000, 2048)}
)

REV_SHAPES = sorted(
    {shape for shapes in SWEEP_REV.values() for shape in shapes}
    | {(b, rows, k) for b in (1, 33, 255, 1001) for rows in (1, 129, 744)
       for k in (0, 1, 17, 64, 200)}
    | {(70000, 3, 8), (70000, 9, 64), (65535, 1, 1)}
)
GROUPED_SHAPES = sorted(
    {shape for shapes in SWEEP_GROUPED.values() for shape in shapes}
    | {(g, b, s, r) for g in (1, 7) for b in (1, 33, 1000) for s in (0, 7, 8, 1030)
       for r in (1, 17, 100)}
    | {(3, 9, 1030, 5), (50, 300, 13, 6), (1, 1, 1, 1_000_000)}
    | {(g, b, s, r) for g in (1, 4) for b in (1, 33, 1100) for s in (3, 8, 624, 2000)
       for r in (5, 16, 17, 624, 700)}
    | {(1, 500_000, 4, 40), (2, 1, 20, 33)}
)


def _cover(n: int, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """How often each index of ``range(n)`` lies in one of the ranges
    ``[starts[i], ends[i])``, clipped to ``n``."""
    hits = np.zeros(n + 1, dtype=np.int64)
    np.add.at(hits, np.minimum(starts, n), 1)
    np.add.at(hits, np.minimum(ends, n), -1)
    return np.cumsum(hits)[:n]


@pytest.mark.parametrize("s,rows,k", ELL_SHAPES)
def test_ell_plan_covers_each_output_once_within_the_grid(s, rows, k):
    plan = er.launch_plan(s, rows, k)
    assert plan.wide == (k >= er.WIDE_K)
    tiles, batch = plan.grid
    assert 1 <= tiles <= GRID_X_MAX and batch == s <= GRID_YZ_MAX
    # blockIdx.x * rows_per_block + (thread >> log2 row_threads) -> band
    # row j, blockIdx.y -> batch row s: each (s, j) row once, no empty block
    row0 = np.arange(tiles) * plan.rows_per_block
    assert (_cover(rows, row0, row0 + plan.rows_per_block) == 1).all()
    assert (tiles - 1) * plan.rows_per_block < rows
    if not plan.wide:
        assert (plan.row_threads, plan.rows_per_block) == (1, er.NARROW_ROWS)
        return
    # a row's threads are whole warps of one block; lane l takes slots
    # l, l + row_threads, ...: every slot once
    assert plan.row_threads in (32, 64, 128, 256)
    assert plan.row_threads * plan.rows_per_block == er.WIDE_THREADS
    lanes = np.arange(plan.row_threads)
    slots = np.concatenate([np.arange(l, k, plan.row_threads) for l in lanes])
    assert np.array_equal(np.sort(slots), np.arange(k))
    # the threads grew only while the grid lacked warps and each thread
    # kept MIN_SLOTS slots, and stopped for one of those reasons
    half = plan.row_threads // 2
    if plan.row_threads > er.MIN_ROW_THREADS:
        assert s * rows * half // 32 < er.TARGET_WARPS and k >= er.MIN_SLOTS * plan.row_threads
    assert (plan.row_threads == er.WIDE_THREADS
            or s * rows * plan.row_threads // 32 >= er.TARGET_WARPS
            or k < er.MIN_SLOTS * 2 * plan.row_threads)


def test_ell_plan_fills_the_card_at_the_sparse_bands():
    for s, rows, k in SPARSE_ELL:
        plan = er.launch_plan(s, rows, k)
        warps = math.prod(plan.grid) * (er.WIDE_THREADS if plan.wide else er.NARROW_ROWS) // 32
        assert warps >= 4 * SMS, (s, rows, k, plan)
    # the spine band: a block of 256 threads a row, 4 slots a thread, where
    # a thread a row gave the band 128 threads in all
    spine = er.launch_plan(8, 16, 1024)
    assert spine.wide and spine.row_threads == 256 and spine.grid == (16, 8)
    assert not er.launch_plan(8, 2496, 16).wide


# (B, S, n, k) of the world relax: the tenant plane's two shapes (64
# vantage worlds of the 1008-node fabric at its three source buckets; 4
# areas of the 10 000-node one), S of 1 to 13 off any run, n off a tile or
# a warp, k not a power of two, and an n whose slab row does not fit
WORLDS_SHAPES = sorted(
    {(64, s, 1024, 64) for s in (8, 32, 64)}
    | {(4, 8, 16384, 1024)}
    | {(b, s, n, k) for b in (1, 4, 64) for s in range(1, 14)
       for n, k in ((1024, 64), (16384, 1024), (257, 1500))}
    | {(1, 1, 1, 0), (3, 300, 70_000, 8), (2, 40, 32_768, 16), (65535, 2, 33, 3)}
)


@pytest.mark.parametrize("b,s,n,k", WORLDS_SHAPES)
def test_worlds_plan_covers_each_output_once_within_the_limits(b, s, n, k):
    plan = er.worlds_plan(b, s, n, k)
    tiles, runs, worlds = plan.grid
    assert worlds == b <= GRID_YZ_MAX and 1 <= runs <= GRID_YZ_MAX
    assert 1 <= tiles <= GRID_X_MAX
    # a run takes at most S batch rows, at most WORLDS_RUN_MAX (the
    # kernel's largest register run, 16), and the runs cover S once, none
    # empty
    assert 1 <= plan.run <= min(s, er.WORLDS_RUN_MAX) and er.WORLDS_RUN_MAX == 16
    run0 = np.arange(runs) * plan.run
    assert (_cover(s, run0, run0 + plan.run) == 1).all() and run0[-1] < s
    # tiles of whole warps, at most WORLDS_TILE_MAX rows: each row once
    assert plan.tile_rows % 32 == 0 and plan.tile_rows <= er.WORLDS_TILE_MAX
    row0 = np.arange(tiles) * plan.tile_rows
    assert (_cover(n, row0, row0 + plan.tile_rows) == 1).all() and row0[-1] < n
    # the block's shared memory: the slab of the run's rows and the
    # overload bytes where a slab row fits, always the wide-row list; within
    # what a block may ask for (227 KB less the static part)
    assert plan.smem_bytes == er.worlds_smem(plan.slab, plan.run, n, plan.tile_rows)
    assert plan.smem_bytes <= er.WORLDS_SMEM_MAX < 227 * 1024
    assert plan.smem_bytes >= 4 * plan.tile_rows + (4 * plan.run * n + n if plan.slab else 0)
    assert plan.slab == (4 * n + n + 4 * er.WORLDS_TILE_MAX + 16 <= er.WORLDS_SMEM_MAX)


def test_worlds_plan_at_the_tenant_shapes():
    """The spine bucket at 1008 nodes: four runs of 16 rows of 4 KB (64 KB
    of slab), 64 x 4 blocks of all 1024 rows; the fabric bucket two runs,
    the rack bucket one run and two tiles; the 10 000-node areas: runs of
    3 rows of 64 KB, the rows cut into tiles until the grid is a wave."""
    spine = er.worlds_plan(64, 64, 1024, 64)
    assert spine.slab and spine.run == 16 and spine.grid == (1, 4, 64)
    assert 64 * 1024 < spine.smem_bytes < 2 * 64 * 1024
    assert er.worlds_plan(64, 32, 1024, 64).grid == (1, 2, 64)
    rack = er.worlds_plan(64, 8, 1024, 64)
    assert rack.run == 8 and rack.grid == (2, 1, 64)
    areas = er.worlds_plan(4, 8, 16384, 1024)
    assert areas.slab and areas.run == 3 and areas.grid[1:] == (3, 4)
    assert SMS * 0.9 <= math.prod(areas.grid) <= SMS * 1.1
    assert 3 * 64 * 1024 < areas.smem_bytes <= er.WORLDS_SMEM_MAX
    # the plan reads shapes only: k does not move it
    assert er.worlds_plan(4, 8, 16384, 16) == areas


@pytest.mark.parametrize("args", [(0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, -1),
                                  (65536, 1, 1, 1)])
def test_worlds_plan_rejects_empty_launches(args):
    with pytest.raises(ValueError):
        er.worlds_plan(*args)


def _strided_cover(items: int, tile: int, tiles_in_grid: int) -> np.ndarray:
    """How often each of ``items`` is covered when block ``y`` of a grid
    of ``tiles_in_grid`` takes tiles ``y, y + tiles_in_grid, ...`` of
    ``tile`` items each (the kernels' stride over grid.y)."""
    tiles = -(-items // tile)
    assert 1 <= tiles_in_grid <= min(tiles, GRID_YZ_MAX)
    starts = np.concatenate([np.arange(y, tiles, tiles_in_grid) for y in range(tiles_in_grid)])
    return _cover(items, starts * tile, starts * tile + tile)


@pytest.mark.parametrize("s,k,n", MINPLUS_SHAPES)
def test_dense_minplus_plan_covers_each_output_once_within_the_grid(s, k, n):
    plan = mp.minplus_plan(s, k, n)
    assert plan.k_warps in (1, 2, 4)
    gx, gy, gz = plan.grid
    assert 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX
    assert gz == plan.splits
    # blockIdx.x -> COL_TILE columns, a thread 4 of them: every column once
    c0 = np.arange(gx) * mp.COL_TILE
    assert (_cover(n, c0, c0 + mp.COL_TILE) == 1).all() and c0[-1] < n
    thread_cols = np.arange(0, mp.COL_TILE, 4)
    assert np.array_equal(np.sort(np.concatenate([thread_cols + c for c in range(4)])),
                          np.arange(mp.COL_TILE))
    # blockIdx.y walks S-tiles of S_TILE rows with a stride of gridDim.y:
    # every row once
    assert (_strided_cover(s, mp.S_TILE, gy) == 1).all()
    # blockIdx.z -> K range; lane kl of the block's 4 * k_warps takes k =
    # kl, kl + lanes, ...: every k once, no empty split
    lanes = mp.K_LANES_A_WARP * plan.k_warps
    k0 = np.arange(gz) * plan.k_chunk
    assert (_cover(k, k0, k0 + plan.k_chunk) == 1).all()
    assert plan.splits == 1 or (plan.splits - 1) * plan.k_chunk < k
    ks = np.concatenate([np.arange(kl, plan.k_chunk, lanes) for kl in range(lanes)])
    assert np.array_equal(np.sort(ks), np.arange(plan.k_chunk))
    # warps over K only while each lane keeps MIN_K_LANE of its k
    assert plan.k_warps == 1 or k >= lanes * mp.MIN_K_LANE
    assert plan.k_warps == mp.K_WARPS_MAX or k < 2 * lanes * mp.MIN_K_LANE
    if plan.splits > 1:
        # a split only where the grid is thin, each lane keeping its k
        assert gx * gy < mp.MIN_BLOCKS
        assert plan.k_chunk >= lanes * mp.MIN_K_LANE
        assert plan.scratch_shape == (plan.splits, s, n)
    else:
        assert plan.scratch_shape == () and plan.k_chunk >= k


def test_dense_minplus_plan_fills_the_card():
    """At the dense route build's products the grid holds at least two
    blocks a SM: [8, 1024] x [1024, 1024] splits K 16 ways into 512 blocks
    of 4 warps (the first port's kernel launched 32 blocks)."""
    for shape in DENSE_MINPLUS:
        plan = mp.minplus_plan(*shape)
        assert math.prod(plan.grid) >= 2 * SMS, (shape, plan)
    plan = mp.minplus_plan(8, 1024, 1024)
    assert plan.k_warps == 4 and plan.splits == 16 and plan.grid == (32, 1, 16)
    # S = 64: eight S-tiles on grid.y, K split 3 ways
    assert mp.minplus_plan(64, 1024, 1024).grid == (32, 8, 3)
    # all pairs at 1024 nodes: a full grid, no split
    assert mp.minplus_plan(1024, 1024, 1024).splits == 1


def test_dense_minplus_shape_is_the_route_builds_own():
    """DENSE_MINPLUS[0] is what the 1008-node route build's view gives
    ``minplus``: the root's source batch against the metric matrix."""
    ls = _link_state(1000)
    snap = SnapshotCache("cpu").get(ls)
    _, srcs = spf.source_batch(snap, snap.id_of("rsw-0-0"), "cpu")
    assert (len(srcs), snap.n_pad, snap.n_pad) == DENSE_MINPLUS[0]


@pytest.mark.parametrize("s,rows,k", MASKED_SHAPES)
def test_masked_plan_covers_each_output_once_within_the_grid(s, rows, k):
    plan = er.masked_plan(s, rows, k)
    assert plan.body == ("wide" if k >= er.WIDE_K else "narrow")
    tiles, gy = plan.grid
    assert 1 <= tiles <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX
    # blockIdx.x * rows_per_block + (thread >> log2 row_threads) -> band
    # row j: each once, no empty block
    row0 = np.arange(tiles) * plan.rows_per_block
    assert (_cover(rows, row0, row0 + plan.rows_per_block) == 1).all()
    assert (tiles - 1) * plan.rows_per_block < rows
    # blockIdx.y walks runs of `chunk` batch rows with a stride of
    # gridDim.y: every batch row once
    assert (_strided_cover(s, plan.chunk, gy) == 1).all()
    wide = plan.body == "wide"
    run_max = er.MASKED_WIDE_RUN if wide else er.MASKED_NARROW_RUN
    least = er.MASKED_WIDE_MIN_BLOCKS if wide else er.MASKED_NARROW_MIN_BLOCKS
    assert plan.chunk in (1, 2, 4, 8, 16) and plan.chunk <= run_max
    # the longest run that leaves the least blocks, or 1
    blocks = tiles * -(-s // plan.chunk)
    assert plan.chunk == 1 or blocks >= least
    assert plan.chunk == run_max or tiles * -(-s // (2 * plan.chunk)) < least
    if not wide:
        # a thread a band row, its slots staged in the fewest registers,
        # batch rows taken 4 at a time (2 with 32 slots staged)
        assert (plan.row_threads, plan.rows_per_block) == (1, er.MASKED_NARROW_ROWS)
        assert plan.kmax in (8, 16, 32) and k <= plan.kmax
        assert plan.kmax == 8 or k > plan.kmax // 2
        assert (plan.kmax, plan.group) in ((8, 4), (16, 4), (32, 2))
        return
    # a row's threads are whole warps of one block, a thread a slot up to
    # a whole block; lane l takes slots l, l + row_threads, ...: every
    # slot once
    assert plan.kmax == 0 and plan.group == 1 and plan.row_threads in (32, 64, 128, 256)
    assert plan.row_threads * plan.rows_per_block == er.WIDE_THREADS
    assert plan.row_threads == max(er.MIN_ROW_THREADS,
                                   min(er.WIDE_THREADS, 1 << (k - 1).bit_length()))
    slots = np.concatenate([np.arange(l, k, plan.row_threads) for l in range(plan.row_threads)])
    assert np.array_equal(np.sort(slots), np.arange(k))


@pytest.mark.parametrize("nodes", sorted(KSP2_MASKED))
def test_masked_plan_fills_the_card_at_the_ksp2_bands(nodes):
    """At the KSP2 chunks' in-bands every band's grid holds a block a SM
    (two for a wide band's 8-warp blocks), and each block reuses a band
    row's slots over a run of batch rows (the first port's kernel read
    them again for every batch row)."""
    for shape in KSP2_MASKED[nodes]:
        plan = er.masked_plan(*shape)
        least = er.MASKED_WIDE_MIN_BLOCKS if plan.body == "wide" else er.MASKED_NARROW_MIN_BLOCKS
        assert math.prod(plan.grid) >= least >= SMS, (shape, plan)
        assert plan.chunk > 1, (shape, plan)
    # the spine bands: 64 threads a row (a slot each) at 1008 nodes, a
    # whole block a row (4 slots each) at 10 000
    assert er.masked_plan(1024, 16, 64)[:4] == ("wide", 0, 1, 64)
    assert er.masked_plan(256, 16, 1024)[:4] == ("wide", 0, 1, 256)
    assert er.masked_plan(256, 7488, 8).chunk == er.MASKED_NARROW_RUN


@pytest.mark.parametrize("nodes", sorted(KSP2_MASKED))
def test_ksp2_bands_are_the_masked_solves_own(nodes):
    """KSP2_MASKED is what the KSP2 masked solve gives
    ``ell_band_relax_masked``: the in-bands and a destination chunk of
    ``_ksp2_chunk`` batch rows."""
    graph = spf_sparse.compile_ell(_link_state(nodes))
    s = _ksp2_chunk(graph)
    assert [(s, bd.rows, bd.k) for bd in graph.bands] == KSP2_MASKED[nodes]


@pytest.mark.parametrize("b,rows,k", REV_SHAPES)
def test_rev_plan_covers_each_output_once_within_the_grid(b, rows, k):
    plan = rr.launch_plan(b, rows, k)
    assert plan.wide == (k >= rr.WIDE_K)
    assert plan.rows_per_block == (rr.WIDE_ROWS if plan.wide else rr.NARROW_ROWS)
    assert plan.chunk >= 1 and (plan.wide or plan.chunk <= rr.MAX_CHUNK or b > rr.GRID_Y_MAX)
    tiles, runs = plan.grid
    assert 1 <= tiles <= GRID_X_MAX and 1 <= runs <= GRID_YZ_MAX
    # blockIdx.x * rows_per_block + thread -> band row j; blockIdx.y *
    # chunk + step -> destination row b: each exactly once, no empty block
    row0 = np.arange(tiles) * plan.rows_per_block
    rows_cover = _cover(rows, row0, row0 + plan.rows_per_block)
    b0 = np.arange(runs) * plan.chunk
    b_cover = _cover(b, b0, b0 + plan.chunk)
    assert (rows_cover == 1).all() and (b_cover == 1).all()
    assert (tiles - 1) * plan.rows_per_block < rows and (runs - 1) * plan.chunk < b


@pytest.mark.parametrize("nodes", sorted(SWEEP_REV))
def test_rev_plan_fills_the_card_at_the_sweeps_shapes(nodes):
    for b, rows, k in SWEEP_REV[nodes]:
        plan = rr.launch_plan(b, rows, k)
        assert math.prod(plan.grid) >= 2 * SMS, (b, rows, k, plan)
    # the narrow bands reuse each staged slot tile across a run of
    # destinations wherever the grid allows it
    assert rr.launch_plan(1024, 7488, 8).chunk == rr.MAX_CHUNK
    assert rr.launch_plan(1024, 2496, 16).chunk == rr.MAX_CHUNK
    assert rr.launch_plan(256, 744, 8).chunk > 1


@pytest.mark.parametrize("g,b,s,r", GROUPED_SHAPES)
def test_minplus_t_plan_covers_each_output_once_within_the_grid(g, b, s, r):
    plan = gm.minplus_t_plan(g, b, s, r)
    assert plan.r_tile in (1, 2, 4, 8, 16)
    assert plan.threads in (32, 64, 128)
    gx, gy, gz = plan.grid
    assert 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX
    assert gz == plan.splits
    b_blocks = -(-b // plan.threads)
    assert gx == g * b_blocks
    # blockIdx.x -> g = x / b_blocks and the b-block x % b_blocks, thread
    # -> b, live below B: every (g, b) column once
    blk = np.arange(gx)
    g_of, b0 = blk // b_blocks, (blk % b_blocks) * plan.threads
    start = g_of * b + b0
    assert (_cover(g * b, start, g_of * b + np.minimum(b0 + plan.threads, b)) == 1).all()
    assert (b_blocks - 1) * plan.threads < b
    # blockIdx.y -> R-tile: every r once
    r0 = np.arange(gy) * plan.r_tile
    assert (_cover(r, r0, r0 + plan.r_tile) == 1).all()
    assert (gy - 1) * plan.r_tile < r
    # blockIdx.z -> S chunk: every s once, no empty split
    s0 = np.arange(gz) * plan.s_chunk
    assert (_cover(s, s0, s0 + plan.s_chunk) == 1).all()
    assert plan.splits == 1 or (plan.splits - 1) * plan.s_chunk < s
    if plan.splits > 1:
        assert plan.s_chunk >= gm.MIN_S_CHUNK
        assert plan.scratch_shape == (plan.splits, g, r, b)
    else:
        assert plan.scratch_shape == ()
        assert plan.s_chunk >= s


@pytest.mark.parametrize("g,b,s,r", GROUPED_SHAPES)
def test_minplus_plan_covers_each_output_once_within_the_grid(g, b, s, r):
    plan = gm.minplus_plan(g, b, s, r)
    assert plan.body == ("rows" if r <= gm.R_TILE_MAX else "cols")
    assert plan.threads in (32, 64, 128)
    gx, gy, gz = plan.grid
    assert 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX
    assert gz == plan.splits
    if plan.body == "rows":
        # a block of MAX_THREADS rows, each with all its R: never shrunk
        assert plan.r_tile == min(gm.R_TILE_MAX, 1 << (r - 1).bit_length()) >= r
        assert plan.threads == gm.MAX_THREADS and plan.chunk == 1
        # blockIdx.x -> (g, b-block), thread -> b, blockIdx.y -> R-tile
        b_blocks = -(-b // plan.threads)
        assert gx == g * b_blocks and (b_blocks - 1) * plan.threads < b
        blk = np.arange(gx)
        g_of, b0 = blk // b_blocks, (blk % b_blocks) * plan.threads
        start = g_of * b + b0
        assert (_cover(g * b, start, g_of * b + np.minimum(b0 + plan.threads, b)) == 1).all()
        r0 = np.arange(gy) * plan.r_tile
        assert (_cover(r, r0, r0 + plan.r_tile) == 1).all()
        assert (gy - 1) * plan.r_tile < r
    else:
        assert plan.r_tile == 1 and 1 <= plan.chunk <= gm.RUN_B_MAX
        # blockIdx.x -> (g, r-block), thread -> r, blockIdx.y -> b-run
        r_blocks = -(-r // plan.threads)
        assert gx == g * r_blocks and (r_blocks - 1) * plan.threads < r
        blk = np.arange(gx)
        g_of, r0 = blk // r_blocks, (blk % r_blocks) * plan.threads
        start = g_of * r + r0
        assert (_cover(g * r, start, g_of * r + np.minimum(r0 + plan.threads, r)) == 1).all()
        b0 = np.arange(gy) * plan.chunk
        assert (_cover(b, b0, b0 + plan.chunk) == 1).all()
        assert (gy - 1) * plan.chunk < b
    # blockIdx.z -> S chunk: every s once, no empty split; only S of
    # SPLIT_MIN_S or more splits, in whole int4 vectors of MIN_S_CHUNK or
    # more
    s0 = np.arange(gz) * plan.s_chunk
    assert (_cover(s, s0, s0 + plan.s_chunk) == 1).all()
    if plan.splits > 1:
        assert (plan.splits - 1) * plan.s_chunk < s and s >= gm.SPLIT_MIN_S
        assert plan.s_chunk >= gm.MIN_S_CHUNK and plan.s_chunk % gm.VEC == 0
        assert plan.scratch_shape == (plan.splits, g, b, r)
    else:
        assert plan.scratch_shape == ()
        assert plan.s_chunk >= s


def test_minplus_plan_fills_the_card_at_the_sweeps_shapes():
    # the 10 000-node sweep's segments (device-bound) give the card at
    # least two blocks a SM
    for shape in SWEEP_GROUPED[10000]:
        plan = gm.minplus_plan(*shape)
        assert math.prod(plan.grid) >= 2 * SMS, (shape, plan)
    # R <= 16 keeps a whole row's R in one thread; the thin segment splits
    # S; R > 16 puts neighbouring r on neighbouring lanes, runs of 8 rows
    assert gm.minplus_plan(624, 1024, 4, 12)[:3] == ("rows", 16, 128)
    assert gm.minplus_plan(624, 1024, 12, 4).grid[1:] == (1, 1)
    assert gm.minplus_plan(4, 1024, 624, 4).splits == 16
    assert gm.minplus_plan(4, 1024, 4, 624)[:4] == ("cols", 1, 128, 8)
    # the 1008-node sweep's (launch-bound) segments: only the one with 62
    # sources splits, and a run shrinks to give the cols body two blocks a SM
    assert [gm.minplus_plan(*x).splits > 1 for x in SWEEP_GROUPED[1000]] == [
        False, False, False, True]
    assert math.prod(gm.minplus_plan(4, 256, 4, 62).grid) >= 2 * SMS


def test_minplus_plan_takes_every_body_with_and_without_a_split():
    seen = {(p.body, p.splits > 1) for p in map(lambda x: gm.minplus_plan(*x), GROUPED_SHAPES)}
    assert seen == {("rows", False), ("rows", True), ("cols", False), ("cols", True)}


@pytest.mark.parametrize("nodes", sorted(SWEEP_GROUPED))
def test_minplus_t_plan_fills_the_card_at_the_sweeps_shapes(nodes):
    for shape in SWEEP_GROUPED[nodes]:
        plan = gm.minplus_t_plan(*shape)
        assert math.prod(plan.grid) >= 2 * SMS, (shape, plan)
    # the thin 10 000-node segment splits S; its wide ones keep each gath
    # column in one thread (a single R-tile)
    assert gm.minplus_t_plan(4, 1024, 624, 4).splits > 1
    assert gm.minplus_t_plan(624, 1024, 4, 12).grid[1:] == (1, 1)
    assert gm.minplus_t_plan(624, 1024, 12, 4).grid[1:] == (1, 1)


@functools.lru_cache(maxsize=None)
def _link_state(nodes: int) -> LinkState:
    topo = topologies.fat_tree_nodes(nodes)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    return ls


@pytest.fixture(scope="module", params=sorted(SWEEP_BLOCK))
def sweep_graphs(request):
    nodes = request.param
    ls = _link_state(nodes)
    return nodes, route_sweep.compile_out_ell(ls), spf_grouped.compile_out_grouped(ls)


def test_sweep_shapes_are_the_sweeps_own(sweep_graphs):
    """The shapes above are those the route sweeps give the kernels."""
    nodes, ell, grouped = sweep_graphs
    block = SWEEP_BLOCK[nodes]
    assert [(block, bd.rows, bd.k) for bd in ell.bands] == SWEEP_REV[nodes]
    assert [
        (seg.w.shape[0], block, seg.w.shape[1], seg.w.shape[2])
        for band in grouped.bands for seg in band.segments
    ] == SWEEP_GROUPED[nodes]


@pytest.mark.parametrize(
    "fn,args",
    [(rr.launch_plan, (0, 5, 8)), (rr.launch_plan, (3, 0, 8)),
     (gm.minplus_t_plan, (0, 1, 1, 1)), (gm.minplus_t_plan, (1, 0, 1, 1)),
     (gm.minplus_t_plan, (1, 1, -1, 1)), (gm.minplus_t_plan, (1, 1, 1, 0)),
     (er.launch_plan, (0, 5, 40)), (er.launch_plan, (3, 0, 40)),
     (er.launch_plan, (3, 5, -1)), (er.launch_plan, (65536, 5, 8)),
     (gm.minplus_plan, (0, 1, 1, 1)), (gm.minplus_plan, (1, 0, 1, 1)),
     (gm.minplus_plan, (1, 1, -1, 1)), (gm.minplus_plan, (1, 1, 1, 0)),
     (gm.minplus_plan, (0, 1, 1, 40)), (gm.minplus_plan, (1, 0, 1, 40)),
     (gm.minplus_plan, (1, 1, -1, 40)), (gm.minplus_plan, (1, 600_000, 4, 40)),
     (mp.minplus_plan, (0, 4, 4)), (mp.minplus_plan, (4, -1, 4)),
     (mp.minplus_plan, (4, 4, 0)), (er.masked_plan, (0, 5, 8)),
     (er.masked_plan, (3, 0, 8)), (er.masked_plan, (3, 5, -1))],
)
def test_plans_reject_empty_launches(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_sparse_bands_are_the_route_builds_own():
    """SPARSE_ELL is what the 10 000-node route build's view solve gives
    ``ell_band_relax``: its in-bands and its batch of source rows."""
    ls = _link_state(10000)
    graph = spf_sparse.compile_ell(ls)
    s = len(spf_sparse.ell_source_batch(graph, ls, "rsw-0-0"))
    assert [(s, bd.rows, bd.k) for bd in graph.bands] == SPARSE_ELL


# (S, rows, k) of bands that ell_patch(widen=True) can make from the main
# path's: each k doubled once or twice (an 8-slot rack band to 16 or 32,
# the 10 000-node fabric's 16 x 1024 spine band to 2048 or 4096, the
# 1008-node one's 16 x 64 to 128), at the sparse view's batch of 8 and the
# KSP2 chunks of 256 and 1024
WIDENED = sorted(
    {(s, rows, k) for s in (8, 256, 1024) for rows, ks in (
        (7488, (16, 32)), (2496, (32, 64)), (744, (16, 32)), (248, (32, 64)),
        (16, (128, 256, 2048, 4096)))
     for k in ks}
)


@pytest.mark.parametrize("s,rows,k", WIDENED)
def test_plans_take_every_widened_band(s, rows, k):
    test_ell_plan_covers_each_output_once_within_the_grid(s, rows, k)
    test_masked_plan_covers_each_output_once_within_the_grid(s, rows, k)


def test_widened_bands_of_ell_patch_take_the_plans():
    """A node whose in-degree outgrows its slot class widens its band in
    place (k doubles, node ids stay); the plans take the new shape."""
    from dataclasses import replace

    ls = LinkState(area="0")
    topo = topologies.grid(4)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    graph = spf_sparse.compile_ell(ls)
    version = ls.topology_version
    target = "node-5"
    base = topo.adj_dbs[target].adjacencies[0]
    peers = ["node-0", "node-3", "node-10", "node-12", "node-14", "node-15"]
    for peer in peers:
        db = ls.get_adjacency_databases()[peer]
        ls.update_adjacency_database(replace(db, adjacencies=db.adjacencies + (replace(
            db.adjacencies[0], other_node_name=target, if_name=f"if_{peer}_{target}",
            other_if_name=f"if_{target}_{peer}"),)))
    db = ls.get_adjacency_databases()[target]
    ls.update_adjacency_database(replace(db, adjacencies=db.adjacencies + tuple(
        replace(base, other_node_name=p, if_name=f"if_{target}_{p}",
                other_if_name=f"if_{p}_{target}") for p in peers)))
    patched = spf_sparse.ell_patch(graph, ls, sorted(ls.affected_since(version)), widen=True)
    assert patched.widened and patched.node_names is graph.node_names
    for bi in patched.widened:
        old, new = graph.bands[bi], patched.bands[bi]
        assert (new.start, new.rows) == (old.start, old.rows) and new.k == 2 * old.k
    for band in patched.bands:
        for s in (8, 256):
            test_ell_plan_covers_each_output_once_within_the_grid(s, band.rows, band.k)
            test_masked_plan_covers_each_output_once_within_the_grid(s, band.rows, band.k)
