"""The port's kernel modules against the JAX package's kernels.

``minplus_plain``, ``ell_band_relax_plain``,
``ell_band_relax_masked_plain``, ``rev_band_relax_plain``,
``batched_minplus_plain`` and ``batched_minplus_t_plain`` are the versions
the port runs on CPU tensors, and what the CUDA kernels are held against
on the card. Here they are held against the JAX package's Pallas kernels (in
interpret mode on the CPU) and its jnp formulations, on the same int32
inputs made with numpy from a seed. The tolerance is exact equality:
everything is int32 with saturation at INF = 2^30 - 1. The on-card leg,
kernel against plain version, is ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import pallas_grouped as jax_pallas_grouped
from openr_tpu.ops import route_sweep as jax_sweep
from openr_tpu.ops import spf as jax_spf
from openr_tpu.ops import spf_grouped as jax_grouped
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.ops.pallas_ell import ell_band_relax as jax_ell_band_relax
from openr_tpu.ops.pallas_ell import ell_band_relax_masked as jax_ell_band_relax_masked
from openr_tpu.ops.pallas_ell import rev_band_relax as jax_rev_band_relax
from openr_tpu.ops.pallas_minplus import minplus as jax_pallas_minplus
from openr_tpu_torch.kernels import LAUNCHES, reset_launches
from openr_tpu_torch.ops import ell_relax, grouped_minplus, rev_relax
from openr_tpu_torch.ops import minplus as port_minplus
from openr_tpu_torch.ops import route_sweep as port_sweep
from openr_tpu_torch.ops import spf_grouped as port_grouped
from openr_tpu_torch.ops import spf_sparse as port_sparse

INF = (1 << 30) - 1


def _mat(rng, shape, inf_frac, hi=1000):
    a = rng.integers(0, hi, shape).astype(np.int32)
    a[rng.random(shape) < inf_frac] = INF
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors run the plain versions: no kernel launch is counted."""
    reset_launches()
    yield
    assert set(LAUNCHES) == {
        "minplus", "ell_band_relax", "ell_band_relax_masked", "ell_live_slots",
        "rev_band_relax", "batched_minplus", "batched_minplus_t",
    }
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize(
    "s,k,n,inf_frac",
    [(8, 128, 128, 0.3), (16, 256, 128, 0.9), (8, 128, 256, 1.0), (24, 128, 128, 0.0)],
)
def test_minplus_plain_matches_pallas_interpret(s, k, n, inf_frac):
    rng = np.random.default_rng(s * 1000 + k + n)
    a = _mat(rng, (s, k), inf_frac)
    b = _mat(rng, (k, n), inf_frac)
    want = np.asarray(
        jax_pallas_minplus(jnp.asarray(a), jnp.asarray(b), interpret=True)
    )
    got = port_minplus.minplus(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "s,k,n", [(1, 1, 1), (5, 77, 300), (33, 129, 65), (8, 1000, 3)]
)
def test_minplus_plain_matches_jnp_on_ragged_shapes(s, k, n):
    rng = np.random.default_rng(s + 7 * k + 13 * n)
    a = _mat(rng, (s, k), 0.4)
    b = _mat(rng, (k, n), 0.4)
    want = np.asarray(jax_spf._minplus(jnp.asarray(a), jnp.asarray(b), "jnp"))
    np.testing.assert_array_equal(port_minplus.minplus_plain(_t(a), _t(b)).numpy(), want)


def test_minplus_plain_chunks_k_exactly(monkeypatch):
    # force a K chunk of a few columns: the chunked min equals one pass
    rng = np.random.default_rng(3)
    a = _mat(rng, (6, 50), 0.5)
    b = _mat(rng, (50, 40), 0.5)
    whole = port_minplus.minplus_plain(_t(a), _t(b))
    monkeypatch.setattr(port_minplus, "_PLAIN_CHUNK_ELEMS", 6 * 40 * 3)
    chunked = port_minplus.minplus_plain(_t(a), _t(b))
    assert torch.equal(whole, chunked)
    want = np.asarray(jax_spf._minplus(jnp.asarray(a), jnp.asarray(b), "jnp"))
    np.testing.assert_array_equal(chunked.numpy(), want)


def test_minplus_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_minplus.minplus(a, torch.zeros((6, 3), dtype=torch.int32))
    with pytest.raises(TypeError):
        port_minplus.minplus(a, torch.zeros((5, 3), dtype=torch.int64))
    # no kernel and no plain fallback on a device that is neither
    with pytest.raises(ValueError, match="no kernel"):
        port_minplus.minplus(a.to("meta"), torch.zeros((5, 3), dtype=torch.int32, device="meta"))


def _band(rng, s, n_pad, rows, k, pos, inf_frac, ov_frac):
    d = _mat(rng, (s, n_pad), inf_frac)
    src = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
    w = _mat(rng, (rows, k), inf_frac)
    ov = rng.random(n_pad) < ov_frac
    return d, src, w, ov


BAND_CASES = [
    # s, n_pad, rows, k, pos, inf_frac, overloaded fraction
    (8, 256, 128, 8, 0, 0.2, 0.1),
    (3, 256, 40, 16, 100, 0.5, 0.3),
    (8, 384, 16, 64, 300, 0.9, 0.0),
    (1, 128, 7, 8, 121, 0.0, 0.5),
    (13, 256, 200, 24, 56, 0.3, 1.0),
]


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_ell_band_relax_plain_matches_pallas_interpret(case):
    s, n_pad, rows, k, pos, inf_frac, ov_frac = case
    rng = np.random.default_rng(sum(case[:5]))
    d, src, w, ov = _band(rng, s, n_pad, rows, k, pos, inf_frac, ov_frac)
    want = np.asarray(
        jax_ell_band_relax(
            jnp.asarray(d), jnp.asarray(src), jnp.asarray(w),
            jnp.asarray(ov), pos, interpret=True,
        )
    )
    for mask in (_t(ov), _t(ov).to(torch.uint8), _t(ov).to(torch.int32)):
        out = torch.empty((s, n_pad), dtype=torch.int32)
        got = ell_relax.ell_band_relax(_t(d), _t(src), _t(w), mask, pos, out)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(out[:, pos : pos + rows].numpy(), want)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("s", [1, 8, 11])
def test_full_relax_matches_jax_band_bodies(impl, s):
    # three bands of different widths and a padding tail: the port's
    # in-place band writes + copied tail equal the JAX concatenation
    rng = np.random.default_rng(100 + s)
    bands = (
        jax_sparse.EllBand(0, 90, 8),
        jax_sparse.EllBand(90, 30, 16),
        jax_sparse.EllBand(120, 3, 64),
    )
    n_pad = 128
    d = _mat(rng, (s, n_pad), 0.3)
    srcs = [rng.integers(0, n_pad, (b.rows, b.k)).astype(np.int32) for b in bands]
    ws = [_mat(rng, (b.rows, b.k), 0.3) for b in bands]
    ov = rng.random(n_pad) < 0.2
    want = np.asarray(
        jax_sparse._ell_relax(
            jnp.asarray(d), bands, tuple(map(jnp.asarray, srcs)),
            tuple(map(jnp.asarray, ws)), jnp.asarray(ov), impl=impl,
        )
    )
    port_bands = tuple(port_sparse.EllBand(b.start, b.rows, b.k) for b in bands)
    got = port_sparse._ell_relax(
        _t(d), port_bands, tuple(map(_t, srcs)), tuple(map(_t, ws)), _t(ov)
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_band_relax_writes_into_out_slice():
    rng = np.random.default_rng(5)
    d, src, w, ov = _band(rng, 4, 128, 20, 8, 30, 0.3, 0.2)
    out = torch.full((4, 128), -7, dtype=torch.int32)
    view = ell_relax.ell_band_relax(_t(d), _t(src), _t(w), _t(ov), 30, out=out)
    want = ell_relax.ell_band_relax_plain(_t(d), _t(src), _t(w), _t(ov), 30)
    assert torch.equal(view, want)
    assert torch.equal(out[:, 30:50], want)
    assert (out[:, :30] == -7).all() and (out[:, 50:] == -7).all()


def test_ell_band_relax_rejects_what_the_kernel_does_not_take():
    d = torch.zeros((2, 16), dtype=torch.int32)
    src = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((4, 8), dtype=torch.int32)
    ov = torch.zeros(16, dtype=torch.bool)
    out = torch.empty_like(d)
    with pytest.raises(ValueError):  # band past the last column
        ell_relax.ell_band_relax(d, src, w, ov, 13, out)
    with pytest.raises(TypeError):
        ell_relax.ell_band_relax(d, src, w, ov.to(torch.float32), 0, out)
    with pytest.raises(TypeError):
        ell_relax.ell_band_relax(d.to(torch.int64), src, w, ov, 0, out)
    with pytest.raises(ValueError):
        ell_relax.ell_band_relax(d, src, w[:, :4], ov, 0, out)
    with pytest.raises(ValueError):  # out not shaped like d
        ell_relax.ell_band_relax(d, src, w, ov, 0, out[:, :8])
    with pytest.raises(ValueError):  # out not int32
        ell_relax.ell_band_relax(d, src, w, ov, 0, out.to(torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        ell_relax.ell_band_relax(
            d.to("meta"), src.to("meta"), w.to("meta"), ov.to("meta"), 0,
            out.to("meta"),
        )


# -- ell_band_relax_masked: the KSP2 second-path band relax --------------------


MASKED_CASES = [
    # s, n_pad, rows, k, pos, inf_frac, overloaded fraction, mask
    (3, 256, 40, 8, 100, 0.2, 0.2, "random"),
    (13, 256, 130, 16, 126, 0.4, 0.1, "random"),
    (1, 128, 7, 64, 121, 0.0, 0.5, "random"),
    (9, 384, 16, 64, 300, 0.3, 0.0, "all_true"),
    (10, 256, 200, 8, 56, 0.3, 0.3, "all_false"),
    (8, 128, 128, 16, 0, 0.9, 1.0, "rows_true"),
]


def _mask(rng, kind, shape):
    if kind == "all_true":
        return np.ones(shape, dtype=bool)
    if kind == "all_false":
        return np.zeros(shape, dtype=bool)
    mask = rng.random(shape) < 0.1
    if kind == "rows_true":
        mask[::3] = True  # some batch rows lose every edge
    return mask


@pytest.mark.parametrize("case", MASKED_CASES, ids=lambda c: "x".join(map(str, c[:5])) + c[7])
def test_ell_band_relax_masked_plain_matches_pallas_interpret(case):
    s, n_pad, rows, k, pos, inf_frac, ov_frac, kind = case
    rng = np.random.default_rng(sum(case[:5]))
    d, src, w, ov = _band(rng, s, n_pad, rows, k, pos, inf_frac, ov_frac)
    # overloaded origins: some slots gather from overloaded nodes
    if ov.any():
        src[:, 0] = rng.choice(np.flatnonzero(ov), size=rows)
    mask = _mask(rng, kind, (s, rows, k))
    want = np.asarray(
        jax_ell_band_relax_masked(
            jnp.asarray(d), jnp.asarray(src), jnp.asarray(w), jnp.asarray(mask),
            jnp.asarray(ov), pos, interpret=True,
        )
    )
    # the port takes the same bool mask bit-packed
    bits = ell_relax.pack_edge_mask(_t(mask))
    for ovm in (_t(ov), _t(ov).to(torch.uint8), _t(ov).to(torch.int32)):
        out = torch.empty((s, n_pad), dtype=torch.int32)
        got = ell_relax.ell_band_relax_masked(_t(d), _t(src), _t(w), bits, ovm, pos, out)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(out[:, pos : pos + rows].numpy(), want)
    if kind == "all_false":
        np.testing.assert_array_equal(
            want, ell_relax.ell_band_relax_plain(_t(d), _t(src), _t(w), _t(ov), pos).numpy()
        )
    if kind == "all_true":
        np.testing.assert_array_equal(want, d[:, pos : pos + rows])


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("s", [1, 8, 11])
def test_full_masked_relax_matches_jax(impl, s):
    # three bands and a padding tail, each band with its own [S, rows, k]
    # mask: the port's in-place band writes equal the JAX concatenation
    rng = np.random.default_rng(200 + s)
    bands = (
        jax_sparse.EllBand(0, 90, 8),
        jax_sparse.EllBand(90, 30, 16),
        jax_sparse.EllBand(120, 3, 64),
    )
    n_pad = 128
    d = _mat(rng, (s, n_pad), 0.3)
    srcs = [rng.integers(0, n_pad, (b.rows, b.k)).astype(np.int32) for b in bands]
    ws = [_mat(rng, (b.rows, b.k), 0.3) for b in bands]
    masks = [rng.random((s, b.rows, b.k)) < 0.2 for b in bands]
    ov = rng.random(n_pad) < 0.2
    want = np.asarray(
        jax_sparse._ell_relax_masked(
            jnp.asarray(d), bands, tuple(map(jnp.asarray, srcs)),
            tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, masks)),
            jnp.asarray(ov), impl=impl,
        )
    )
    port_bands = tuple(port_sparse.EllBand(b.start, b.rows, b.k) for b in bands)
    got = port_sparse._ell_relax_masked(
        _t(d), port_bands, tuple(map(_t, srcs)), tuple(map(_t, ws)),
        tuple(ell_relax.pack_edge_mask(_t(m)) for m in masks), _t(ov),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_band_relax_masked_writes_into_out_slice():
    rng = np.random.default_rng(6)
    d, src, w, ov = _band(rng, 4, 128, 20, 8, 30, 0.3, 0.2)
    mask = ell_relax.pack_edge_mask(_t(rng.random((4, 20, 8)) < 0.3))
    out = torch.full((4, 128), -7, dtype=torch.int32)
    view = ell_relax.ell_band_relax_masked(_t(d), _t(src), _t(w), mask, _t(ov), 30, out=out)
    want = ell_relax.ell_band_relax_masked_plain(_t(d), _t(src), _t(w), mask, _t(ov), 30)
    assert torch.equal(view, want)
    assert torch.equal(out[:, 30:50], want)
    assert (out[:, :30] == -7).all() and (out[:, 50:] == -7).all()


def test_ell_band_relax_masked_rejects_what_the_kernel_does_not_take():
    d = torch.zeros((2, 16), dtype=torch.int32)
    src = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((4, 8), dtype=torch.int32)
    bool_mask = torch.zeros((2, 4, 8), dtype=torch.bool)
    mask = ell_relax.pack_edge_mask(bool_mask)  # [2, 1] int32 words
    ov = torch.zeros(16, dtype=torch.bool)
    out = torch.empty_like(d)
    # the kernel reads packed int32 words: the bool mask, or its words in
    # another type, is refused
    for bad in (bool_mask, mask.to(torch.uint8), mask.to(torch.int64)):
        with pytest.raises(TypeError, match="packed int32"):
            ell_relax.ell_band_relax_masked(d, src, w, bad, ov, 0, out)
    with pytest.raises(ValueError, match="mask"):  # one batch row short
        ell_relax.ell_band_relax_masked(d, src, w, mask[:1], ov, 0, out)
    with pytest.raises(ValueError, match="mask"):  # words do not match the band
        ell_relax.ell_band_relax_masked(d, src, w, torch.zeros((2, 2), dtype=torch.int32), ov, 0, out)
    with pytest.raises(ValueError):  # band past the last column
        ell_relax.ell_band_relax_masked(d, src, w, mask, ov, 13, out)
    with pytest.raises(TypeError):
        ell_relax.ell_band_relax_masked(d.to(torch.int64), src, w, mask, ov, 0, out)
    with pytest.raises(ValueError):  # out not shaped like d
        ell_relax.ell_band_relax_masked(d, src, w, mask, ov, 0, out[:, :8])
    with pytest.raises(ValueError, match="no kernel"):
        ell_relax.ell_band_relax_masked(
            d.to("meta"), src.to("meta"), w.to("meta"), mask.to("meta"),
            ov.to("meta"), 0, out.to("meta"),
        )


@pytest.mark.parametrize(
    "s,rows,k",
    [(3, 40, 8), (2, 7, 9), (5, 3, 24), (1, 13, 33), (2, 3, 1024), (4, 1, 1),
     (3, 5, 5), (2, 16, 64), (1, 1, 31), (3, 0, 8)],
)
def test_pack_edge_mask_round_trip(s, rows, k):
    """pack_edge_mask then unpack_edge_mask gives the bool mask back, with
    rows * k on and off a multiple of 32 (the last word partly used): the
    bit of (j, slot) of row x is bit (j * k + slot) & 31 of word
    (j * k + slot) >> 5, and no other bit is set."""
    rng = np.random.default_rng(s * 100 + rows * 10 + k)
    mask = rng.random((s, rows, k)) < 0.4
    mask[0] = True
    bits = ell_relax.pack_edge_mask(_t(mask))
    assert bits.dtype == torch.int32 and bits.shape == (s, -(-rows * k // 32))
    assert bits.shape[1] == ell_relax.mask_words(rows, k)
    np.testing.assert_array_equal(ell_relax.unpack_edge_mask(bits, rows, k).numpy(), mask)
    words = bits.numpy().view(np.uint32)
    flat = mask.reshape(s, rows * k)
    want = np.zeros_like(words)
    for x, i in zip(*np.nonzero(flat)):
        want[x, i >> 5] |= np.uint32(1 << (i & 31))
    np.testing.assert_array_equal(words, want)


def test_pack_edge_mask_rejects_what_is_not_a_bool_mask():
    with pytest.raises(ValueError):
        ell_relax.pack_edge_mask(torch.zeros((2, 3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ell_relax.pack_edge_mask(torch.zeros((2, 12), dtype=torch.bool))
    with pytest.raises(ValueError):  # words for another band
        ell_relax.unpack_edge_mask(torch.zeros((2, 3), dtype=torch.int32), 4, 8)


# -- rev_band_relax: the route sweep's reversed-graph band relax ---------------


def _rev_band(rng, b, n_pad, rows, k, pos, inf_frac, ov_frac):
    """A band with destination ids that hit overloaded nodes and the
    band's own neighbour ids, so both arms of the transit test occur."""
    dr, v, w, ov = _band(rng, b, n_pad, rows, k, pos, inf_frac, ov_frac)
    t_ids = rng.integers(0, n_pad, b).astype(np.int32)
    hot = np.flatnonzero(ov)
    if hot.size:
        t_ids[::3] = rng.choice(hot, size=t_ids[::3].shape)
    t_ids[1::3] = v.reshape(-1)[rng.integers(0, v.size, t_ids[1::3].shape)]
    return dr, v, w, t_ids, ov


REV_CASES = [
    # b, n_pad, rows, k, pos, inf_frac, overloaded fraction; the first
    # three are the 10 000-node sweep's out-bands (7488x8, 2496x16,
    # 16x1024 at n_pad 10112) scaled down
    (16, 256, 150, 8, 0, 0.3, 0.1),
    (16, 256, 50, 16, 150, 0.3, 0.2),
    (16, 256, 4, 128, 200, 0.3, 0.3),
    (3, 256, 40, 16, 100, 0.5, 0.3),
    (1, 128, 7, 8, 121, 0.0, 0.5),
    (13, 256, 200, 24, 56, 0.9, 1.0),
    (9, 384, 33, 64, 351, 0.2, 0.0),
]


@pytest.mark.parametrize("case", REV_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_rev_band_relax_plain_matches_pallas_interpret(case):
    b, n_pad, rows, k, pos, inf_frac, ov_frac = case
    rng = np.random.default_rng(sum(case[:5]) + 17)
    dr, v, w, t_ids, ov = _rev_band(rng, b, n_pad, rows, k, pos, inf_frac, ov_frac)
    want = np.asarray(
        jax_rev_band_relax(
            jnp.asarray(dr), jnp.asarray(v), jnp.asarray(w), jnp.asarray(t_ids),
            jnp.asarray(ov), pos, interpret=True,
        )
    )
    for mask in (_t(ov), _t(ov).to(torch.uint8), _t(ov).to(torch.int32)):
        out = torch.full((b, n_pad), -5, dtype=torch.int32)
        got = rev_relax.rev_band_relax(
            _t(dr), _t(v), _t(w), _t(t_ids), mask, pos, out
        )
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(out[:, pos : pos + rows].numpy(), want)
        assert (out[:, :pos] == -5).all() and (out[:, pos + rows :] == -5).all()


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("b", [1, 8, 11])
def test_full_rev_relax_matches_jax(impl, b):
    # three out-bands of different widths and a padding tail: the port's
    # in-place band writes + copied tail equal the JAX concatenation
    rng = np.random.default_rng(200 + b)
    bands = (
        jax_sparse.EllBand(0, 90, 8),
        jax_sparse.EllBand(90, 30, 16),
        jax_sparse.EllBand(120, 3, 64),
    )
    n_pad = 128
    dr = _mat(rng, (b, n_pad), 0.3)
    vs = [rng.integers(0, n_pad, (bd.rows, bd.k)).astype(np.int32) for bd in bands]
    ws = [_mat(rng, (bd.rows, bd.k), 0.3) for bd in bands]
    ov = rng.random(n_pad) < 0.2
    t_ids = rng.integers(0, 123, b).astype(np.int32)
    t_ids[::2] = np.flatnonzero(ov)[: len(t_ids[::2])]
    want = np.asarray(
        jax_sweep._rev_relax(
            jnp.asarray(dr), bands, tuple(map(jnp.asarray, vs)),
            tuple(map(jnp.asarray, ws)), jnp.asarray(ov), jnp.asarray(t_ids),
            impl=impl,
        )
    )
    port_bands = tuple(port_sparse.EllBand(bd.start, bd.rows, bd.k) for bd in bands)
    got = port_sweep._rev_relax(
        _t(dr), port_bands, tuple(map(_t, vs)), tuple(map(_t, ws)), _t(ov), _t(t_ids)
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_rev_band_relax_rejects_what_the_kernel_does_not_take():
    d = torch.zeros((2, 16), dtype=torch.int32)
    v = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((4, 8), dtype=torch.int32)
    t = torch.zeros(2, dtype=torch.int32)
    ov = torch.zeros(16, dtype=torch.bool)
    out = torch.empty_like(d)
    with pytest.raises(ValueError):  # band past the last column
        rev_relax.rev_band_relax(d, v, w, t, ov, 13, out)
    with pytest.raises(ValueError):  # one destination id per row
        rev_relax.rev_band_relax(d, v, w, t[:1], ov, 0, out)
    with pytest.raises(TypeError):
        rev_relax.rev_band_relax(d, v, w, t.to(torch.int64), ov, 0, out)
    with pytest.raises(TypeError):
        rev_relax.rev_band_relax(d, v, w, t, ov.to(torch.float32), 0, out)
    with pytest.raises(ValueError):
        rev_relax.rev_band_relax(d, v, w[:, :4], t, ov, 0, out)
    with pytest.raises(ValueError):  # out not shaped like dr
        rev_relax.rev_band_relax(d, v, w, t, ov, 0, out[:, :8])
    with pytest.raises(ValueError, match="no kernel"):
        rev_relax.rev_band_relax(
            d.to("meta"), v.to("meta"), w.to("meta"), t.to("meta"),
            ov.to("meta"), 0, out.to("meta"),
        )


# -- batched_minplus(_t): the grouped backend's contraction --------------------

GROUPED_CASES = [
    # g, b, s, r, inf_frac; the first four are the 10 000-node grouped
    # sweep's segments (624x4x12, 624x12x4, 4x4x624, 4x624x4 at B=1024)
    # scaled down, then ragged shapes, then S past the Pallas s-block cap
    # of 512 (its revisit grid)
    (24, 32, 4, 12, 0.2),
    (24, 32, 12, 4, 0.2),
    (4, 32, 4, 24, 0.5),
    (4, 32, 62, 4, 0.3),
    (3, 5, 7, 9, 0.4),
    (1, 1, 1, 1, 0.0),
    (7, 19, 3, 1, 1.0),
    (2, 8, 600, 3, 0.3),
    (3, 9, 1030, 5, 0.9),
]


def _grouped(rng, g, b, s, r, inf_frac):
    gath = _mat(rng, (g, b, s), inf_frac, hi=1 << 29)
    w = _mat(rng, (g, s, r), inf_frac)
    return gath, w


@pytest.mark.parametrize("case", GROUPED_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_batched_minplus_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(sum(case[:4]) + 3)
    gath, w = _grouped(rng, *case)
    want = np.asarray(
        jax_pallas_grouped.batched_minplus(jnp.asarray(gath), jnp.asarray(w), interpret=True)
    )
    got = grouped_minplus.batched_minplus(_t(gath), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", GROUPED_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_batched_minplus_t_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(sum(case[:4]) + 4)
    gath, w = _grouped(rng, *case)
    gath_t = np.ascontiguousarray(gath.transpose(0, 2, 1))  # [G, S, B]
    want = np.asarray(
        jax_pallas_grouped.batched_minplus_t(
            jnp.asarray(gath_t), jnp.asarray(w), interpret=True
        )
    )
    got = grouped_minplus.batched_minplus_t(_t(gath_t), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["batched_minplus_plain", "batched_minplus_t_plain"])
def test_batched_minplus_plain_chunks_s_exactly(monkeypatch, fn):
    rng = np.random.default_rng(9)
    gath, w = _grouped(rng, 3, 6, 50, 5, 0.5)
    if fn == "batched_minplus_t_plain":
        gath = np.ascontiguousarray(gath.transpose(0, 2, 1))
    plain = getattr(grouped_minplus, fn)
    whole = plain(_t(gath), _t(w))
    monkeypatch.setattr(grouped_minplus, "_PLAIN_CHUNK_ELEMS", 3 * 6 * 5 * 4)
    assert torch.equal(plain(_t(gath), _t(w)), whole)


@pytest.mark.parametrize("impl", port_grouped.IMPLS)
def test_contract_layouts_match_jax(impl):
    # [B, G, S] in, [B, G, R] out, through each kernel's layout
    rng = np.random.default_rng(12)
    gath = _mat(rng, (10, 6, 5), 0.3, hi=1 << 20)
    w = _mat(rng, (6, 5, 7), 0.3)
    want = np.asarray(jax_grouped._contract(jnp.asarray(gath), jnp.asarray(w), "jnp"))
    got = port_grouped._contract(_t(gath), _t(w), impl)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_minplus_rejects_what_the_kernel_does_not_take():
    gath = torch.zeros((2, 3, 4), dtype=torch.int32)
    w = torch.zeros((2, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        grouped_minplus.batched_minplus(gath, w[:, :3])
    with pytest.raises(ValueError):  # the _t layout wants [G, S, B]
        grouped_minplus.batched_minplus_t(gath, w)
    with pytest.raises(TypeError):
        grouped_minplus.batched_minplus(gath.to(torch.int64), w)
    with pytest.raises(ValueError, match="no kernel"):
        grouped_minplus.batched_minplus(gath.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        grouped_minplus.batched_minplus_t(
            gath.transpose(1, 2).contiguous().to("meta"), w.to("meta")
        )
