"""The port's kernel modules against the JAX package's kernels.

``minplus_plain`` and ``ell_band_relax_plain`` are the versions the port
runs on CPU tensors, and what the CUDA kernels are held against on the
card. Here they are held against the JAX package's Pallas kernels (in
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

from openr_tpu.ops import spf as jax_spf
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.ops.pallas_ell import ell_band_relax as jax_ell_band_relax
from openr_tpu.ops.pallas_minplus import minplus as jax_pallas_minplus
from openr_tpu_torch.kernels import LAUNCHES, reset_launches
from openr_tpu_torch.ops import ell_relax, minplus as port_minplus
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
    assert LAUNCHES == {"minplus": 0, "ell_band_relax": 0}


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
