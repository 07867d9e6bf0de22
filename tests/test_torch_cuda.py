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
from openr_tpu_torch.ops import ell_relax, minplus

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
@pytest.mark.parametrize("s,k,n", [(8, 1024, 1024), (5, 77, 300), (33, 129, 65), (1, 1, 1)])
def test_minplus_kernel_matches_plain(card, s, k, n):
    rng = np.random.default_rng(s + k + n)
    a = _mat(rng, (s, k), 0.3).to(card)
    b = _mat(rng, (k, n), 0.3).to(card)
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
