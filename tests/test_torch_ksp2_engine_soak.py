"""The reference's two KSP2 engine soak regressions, on the port's engine.

``tools/soak_ksp2.py``'s mixed churn (metric wiggles, overload flips, link
pulls and restores, node-label changes) at seed 9013 on the 112-node
fabric (stale resident masks: the reference once traced a bogus masked
row, total 6 where the truth was 8) and at seed 40018 on the 5 x 5 grid
(slot-map drift: a dropped link re-packed a node's slots under the
resident masks), 60 events each, through the JAX engine, the JAX host
backend and the port's engine. Both faults live in the fast path's
resident masks, so both run with ``OPENR_KSP2_FAST=1`` in both packages,
as the reference's soak does; the slow path meets the same churn classes
in ``tests/test_torch_ksp2_engine.py``. After every event the port equals
both and counts what the JAX engine counts (``Trio.step`` there). Exact:
no tolerance applies.
"""

from __future__ import annotations

import pytest

from tests.test_torch_ksp2_engine import (  # noqa: F401 (an autouse fixture)
    SOAKS,
    Trio,
    _device_ksp2_everywhere,
    _drive,
)
from openr_tpu_torch.decision import spf_solver as port_solver


@pytest.mark.parametrize("seed", sorted(SOAKS))
def test_soak_regression_parity(seed, monkeypatch):
    monkeypatch.setenv("OPENR_KSP2_FAST", "1")
    topos, extra, root, events = SOAKS[seed]()
    trio = Trio(topos, extra, root)
    syncs = port_solver.SPF_COUNTERS["decision.ksp2_incremental_syncs"]
    _drive(trio, events(trio))
    assert trio.steps == 61
    assert port_solver.SPF_COUNTERS["decision.ksp2_incremental_syncs"] > syncs
    for engine in trio.port_solver._ksp2_engines.values():
        assert engine.masks_t is not None
