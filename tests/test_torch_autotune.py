"""The port's autotuner (``ops/autotune.py``) over the hand kernels'
launch plans: the port's versions of ``tests/test_pallas_ell.py``'s
autotune tests (a forced tuner, family-keyed persistence, invalid and
out-of-family entries dropped, ``"auto"`` never in a cache key), plus the
port's own rules: no torch-op candidate for a card, and the reference's
``autotune.json`` never read or written. On the CPU."""

from __future__ import annotations

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu_torch import carry
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.ops import aot_cache, autotune, ell_relax, grouped_minplus, minplus
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import rev_relax, route_engine, route_sweep, spf, spf_grouped
from openr_tpu_torch.ops import spf_sparse
from openr_tpu_torch.telemetry import get_registry

CUDA = torch.device("cuda")


class ForcedTuner(autotune.Autotuner):
    """Always picks ``winner`` where it is a candidate, measuring nothing."""

    def __init__(self, winner):
        super().__init__(persist=False)
        self.winner = winner
        self.asked = []

    def pick(self, family, shape_key, candidates, device):
        self.asked.append((family, shape_key))
        return self.winner if self.winner in candidates else next(iter(candidates))


@pytest.fixture(autouse=True)
def restore_selectors():
    tuner = autotune.get_autotuner()
    impls = (spf.get_minplus_impl(), spf_sparse.get_ell_relax_impl(),
             spf_grouped._GROUPED_IMPL)
    aot_cache.get_aot_cache().clear()
    yield
    autotune.set_autotuner(tuner)
    spf.set_minplus_impl(impls[0])
    spf_sparse.set_ell_relax_impl(impls[1])
    spf_grouped.set_grouped_impl(impls[2])
    aot_cache.get_aot_cache().clear()


def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OPENR_CACHE_DIR", str(tmp_path))
    return os.path.join(str(tmp_path), "autotune_torch.json")


def test_round_trip_same_winner_without_remeasure(tmp_path, monkeypatch):
    path = _cache(tmp_path, monkeypatch)
    calls = []

    def measure(thunk, device):
        calls.append(1)
        thunk()
        return float(len(calls))  # the first candidate measured wins

    t1 = autotune.Autotuner(measure=measure)
    w1 = t1.pick("ell_relax", "256x4", {"run4": lambda: None, "plan": lambda: None}, "cpu")
    assert w1 == "run4" and len(calls) == 2
    assert t1.timings()["cpu:ell_relax:256x4"] == {"run4": 1.0, "plan": 2.0}
    data = json.load(open(path))
    assert data["version"] == autotune._SCHEMA_VERSION
    entry = data["winners"]["cpu:ell_relax:256x4"]
    assert entry["winner"] == "run4" and entry["family"] == "ell_relax"
    # a fresh process adopts the persisted winner and never measures
    t2 = autotune.Autotuner(measure=measure)
    calls.clear()
    assert t2.pick("ell_relax", "256x4", {"run4": lambda: None, "plan": lambda: None},
                   "cpu") == "run4"
    assert calls == []


def test_invalid_and_out_of_family_entries_are_dropped(tmp_path, monkeypatch):
    path = _cache(tmp_path, monkeypatch)
    card = "NVIDIA H100 80GB HBM3"
    persisted = {"version": 1, "winners": {
        "cpu:minplus:8x256": {"winner": "warps2"},
        # out of family: a grouped kernel never arms the ELL dispatch
        "cpu:ell_relax:256x4": {"winner": "batched_minplus_t"},
        "cpu:nonsense": {"winner": "plan"},  # malformed key
        "cpu:unknown_family:1x1": {"winner": "plan"},
        # a family field that disagrees with the key
        "cpu:grouped_minplus:1x2x3x4": {"winner": "batched_minplus", "family": "minplus"},
        # the plain version is never a card's winner
        f"{card}:minplus:8x1024": {"winner": "plain"},
        f"{card}:minplus:64x1024": {"winner": "nosplit"},
    }}
    with open(path, "w") as f:
        json.dump(persisted, f)
    t = autotune.Autotuner(measure=lambda th, dev: 1.0)
    t._load()
    assert t.winners() == {"cpu:minplus:8x256": "warps2",
                           f"{card}:minplus:64x1024": "nosplit"}
    assert t.pick("minplus", "8x256", {"plan": lambda: None, "warps2": lambda: None},
                  "cpu") == "warps2"
    # the dropped ell_relax entry is measured again
    assert t.pick("ell_relax", "256x4", {"plan": lambda: None, "run1": lambda: None},
                  "cpu") in ("plan", "run1")
    data = json.load(open(path))
    keys = set(data["winners"])
    assert "cpu:minplus:8x256" in keys and "cpu:nonsense" not in keys
    assert "cpu:unknown_family:1x1" not in keys and f"{card}:minplus:8x1024" not in keys
    for key, entry in data["winners"].items():
        assert entry["winner"] in autotune._FAMILY_CANDIDATES[entry["family"]], key


def test_record_rejects_out_of_family_winner():
    t = autotune.Autotuner(persist=False)
    with pytest.raises(ValueError):
        t.record("ell_relax", "256x4", "batched_minplus_t", "cpu")
    with pytest.raises(ValueError):
        t.record("not_a_family", "256x4", "plan", "cpu")
    with pytest.raises(ValueError):
        t.record("minplus", "8x1024", "plain", CUDA)


def test_resolve_ell_relax_adopts_recorded_winner():
    t = autotune.Autotuner(persist=False)
    autotune.set_autotuner(t)
    t.record("ell_relax", "256x3", "run16", "cpu")
    assert autotune.resolve_ell_relax((256, 3), "cpu") == "run16"


def test_no_torch_op_candidate_for_a_card():
    t = autotune.Autotuner(persist=False, measure=lambda th, dev: 1.0)
    for family in autotune._FAMILY_CANDIDATES:
        cands = autotune._candidates(family, CUDA)
        assert "plain" not in cands and cands
        assert "plain" in autotune._candidates(family, "cpu")
    with pytest.raises(ValueError, match="no candidate on a card"):
        t.pick("minplus", "8x1024", {"plan": lambda: None, "plain": lambda: None}, CUDA)
    with pytest.raises(ValueError, match="not a minplus candidate"):
        t.pick("minplus", "8x1024", {"jnp": lambda: None}, "cpu")
    # the kernel wrappers refuse the plain version as a card's plan
    for family in ("minplus", "ell_relax"):
        with autotune.using(family, "plain"):
            assert autotune.current_variant(family) == "plain"
    with autotune.using("ell_relax", "plain"):
        with pytest.raises(ValueError, match="plain"):
            rev_relax._ell_variant()
    with pytest.raises(ValueError):
        with autotune.using("ell_relax", "pallas"):
            pass


def test_never_measured_inside_a_capture():
    t = autotune.Autotuner(persist=False, measure=lambda th, dev: 1.0)
    with da.capturing():
        with pytest.raises(RuntimeError, match="inside a capture"):
            t.pick("minplus", "8x8", {"plan": lambda: None}, "cpu")


def test_the_reference_file_is_never_read_or_written(tmp_path, monkeypatch):
    _cache(tmp_path, monkeypatch)
    ref = tmp_path / "autotune.json"
    ref_bytes = json.dumps({"version": 2, "winners": {
        "cpu:ell_relax:256x4": {"winner": "pallas", "family": "ell_relax"},
        "cpu:minplus:8x8": {"winner": "plan", "family": "minplus"}}}).encode()
    ref.write_bytes(ref_bytes)
    mtime = os.stat(ref).st_mtime_ns
    t = autotune.Autotuner(measure=lambda th, dev: 1.0)
    # nothing adopted from the reference's file: measured
    calls = []
    t._measure = lambda th, dev: calls.append(1) or 1.0
    assert t.pick("minplus", "8x8", {"warps1": lambda: None, "plan": lambda: None},
                  "cpu") == "warps1"
    assert calls == [1, 1]
    assert ref.read_bytes() == ref_bytes and os.stat(ref).st_mtime_ns == mtime
    assert sorted(os.listdir(tmp_path)) == ["autotune.json", "autotune_torch.json"]


@pytest.mark.parametrize("impl", ["plain", "plan", "warps1", "warps4", "nosplit"])
def test_resolve_minplus_measures_every_candidate_on_the_cpu(impl):
    seen = {}

    def measure(thunk, device):
        thunk()
        seen[len(seen)] = 1
        return 0.0 if len(seen) == 1 + list(
            autotune._candidates("minplus", "cpu")).index(impl) else 1.0

    autotune.set_autotuner(autotune.Autotuner(measure=measure, persist=False))
    assert autotune.resolve_minplus((8, 64), "cpu") == impl
    assert len(seen) == len(autotune._candidates("minplus", "cpu"))


def test_plan_variants_are_launchable_plans():
    base = minplus.minplus_plan(8, 1024, 1024)
    assert minplus.minplus_plan(8, 1024, 1024, "plan") == base
    for w in (1, 2, 4):
        p = minplus.minplus_plan(8, 1024, 1024, f"warps{w}")
        assert p.k_warps == w and p.k_chunk * p.splits >= 1024
    nosplit = minplus.minplus_plan(8, 1024, 1024, "nosplit")
    assert nosplit.splits == 1 and nosplit.scratch_shape == () and base.splits > 1
    with pytest.raises(ValueError):
        minplus.minplus_plan(8, 1024, 1024, "pallas")
    assert rev_relax.launch_plan(1024, 7488, 8, "run4").chunk == 4
    assert rev_relax.launch_plan(1024, 7488, 8, "threads256") == \
        rev_relax.launch_plan(1024, 7488, 8)
    assert rev_relax.launch_plan(10112, 16, 1024, "run1").chunk == 1
    wide = ell_relax.launch_plan(8, 16, 1024, "threads32")
    assert wide.wide and wide.row_threads == 32 and wide.rows_per_block == 8
    assert ell_relax.launch_plan(8, 7488, 8, "threads256") == ell_relax.launch_plan(8, 7488, 8)
    # the masked relax is measured under no variant: it keeps its plan
    # whatever the family's winner
    with autotune.using("ell_relax", "run1"):
        assert ell_relax._variant("ell_band_relax_masked") == "run1"
    with pytest.raises(TypeError):
        ell_relax.masked_plan(1024, 744, 8, "run1")


def test_reference_impl_names_map_to_the_hand_kernels():
    spf.set_minplus_impl("pallas")
    assert spf.get_minplus_impl() == "plan"
    spf.set_minplus_impl("jnp")
    assert spf.get_minplus_impl() == "plan"
    spf_sparse.set_ell_relax_impl("pallas")
    assert spf_sparse.get_ell_relax_impl() == "plan"
    spf_grouped.set_grouped_impl("pallas_t")
    assert spf_grouped.get_grouped_impl("cpu") == "batched_minplus_t"
    for setter in (spf.set_minplus_impl, spf_sparse.set_ell_relax_impl,
                   spf_grouped.set_grouped_impl):
        with pytest.raises(ValueError):
            setter("xla")


def test_grouped_auto_resolves_to_a_kernel():
    autotune.set_autotuner(ForcedTuner("batched_minplus_t"))
    spf_grouped.set_grouped_impl("auto")
    assert spf_grouped.get_grouped_impl("cpu") == "batched_minplus_t"
    ls = _port_ls(jax_topologies.fat_tree(pods=2, ssw_per_plane=1, fsw_per_pod=2,
                                          rsw_per_pod=2))
    names = sorted(ls.get_adjacency_databases())
    eng = route_engine.GroupedRouteSweepEngine(ls, names[:1], impl=None, device="cpu")
    assert eng.impl == "batched_minplus_t"
    assert grouped_minplus.batched_minplus_t is not None


def _port_ls(topo):
    ls = LinkState(area=topo.area)
    for name, db in sorted(topo.adj_dbs.items()):
        (pdb,), _ = carry.lsdb_from_plain([carry.to_plain(db)], [])
        ls.update_adjacency_database(pdb)
    return ls


def _mutate(ls, node, metric):
    db = ls.get_adjacency_databases()[node]
    adjs = list(db.adjacencies)
    adjs[0] = replace(adjs[0], metric=metric)
    ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))
    return {node, adjs[0].other_node_name}


def _warm_engine_auto(winner):
    autotune.set_autotuner(ForcedTuner(winner))
    spf_sparse.set_ell_relax_impl("auto")
    ls = _port_ls(jax_topologies.fat_tree(pods=3, ssw_per_plane=2, fsw_per_pod=2,
                                          rsw_per_pod=4))
    names = sorted(ls.get_adjacency_databases())
    eng = route_engine.RouteSweepEngine(ls, [names[0]], device="cpu")
    rsw = next(n for n in eng.graph.node_names if n.startswith("rsw"))
    assert eng.churn(ls, _mutate(ls, rsw, 3)) is not None
    return eng, ls, rsw


def test_auto_is_resolved_before_the_key_and_never_in_it():
    eng, ls, rsw = _warm_engine_auto("run4")
    keys = list(aot_cache.get_aot_cache()._exes)
    tags = {k[0] for k in keys}
    assert tags and all("auto" not in repr(k) for k in keys)
    assert {t for t in tags if t.startswith("ell_")} <= {
        f"{t}@run4" for t in ("ell_full_resident", "ell_churn_step",
                              "ell_frontier_probe", "ell_frontier_step",
                              "ell_overflow_chain")}
    assert "ell_churn_step@run4" in tags
    # "plan" dispatches keep the bare tag: flipping the impl re-keys
    spf_sparse.set_ell_relax_impl("plan")
    eng.churn(ls, _mutate(ls, rsw, 9))
    assert "ell_churn_step" in {k[0] for k in aot_cache.get_aot_cache()._exes}


def test_zero_recapture_across_churn_under_auto():
    eng, ls, rsw = _warm_engine_auto("run16")
    reg = get_registry()
    for metric in (5, 9, 2, 12):
        eng.churn(ls, _mutate(ls, rsw, metric))
    c0 = reg.counter_get("ops.aot_compiles")
    for metric in (5, 9, 2, 12):
        eng.churn(ls, _mutate(ls, rsw, metric))
    assert reg.counter_get("ops.aot_compiles") == c0


def test_warm_churn_two_touch_contract_holds_armed():
    eng, ls, rsw = _warm_engine_auto("run1")
    with da.event_window("test_armed") as w:
        assert eng.churn(ls, _mutate(ls, rsw, 8)) is not None
    assert w.touches <= 2 and w.blocking_syncs == 0


def test_pipelined_burst_digest_parity_armed():
    """A burst of three events under "auto" (a forced variant) leaves the
    digests of an engine under "plan" fed the same events."""
    topo = jax_topologies.fat_tree(pods=3, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=4)
    ls_a, ls_b = _port_ls(topo), _port_ls(topo)
    names = sorted(ls_a.get_adjacency_databases())
    eng_a = route_engine.RouteSweepEngine(ls_a, [names[0]], device="cpu")
    autotune.set_autotuner(ForcedTuner("run4"))
    spf_sparse.set_ell_relax_impl("auto")
    eng_b = route_engine.RouteSweepEngine(ls_b, [names[0]], device="cpu")
    nodes = [n for n in eng_a.graph.node_names if n.startswith("rsw")][:3]
    for i, node in enumerate(nodes):
        _mutate(ls_a, node, 5 + i)
    spf_sparse.set_ell_relax_impl("plan")
    eng_a.churn(ls_a, set(nodes) | {ls_a.get_adjacency_databases()[n].adjacencies[0]
                                    .other_node_name for n in nodes})
    spf_sparse.set_ell_relax_impl("auto")
    eng_b.churn_burst(ls_b, [lambda n=n, i=i: _mutate(ls_b, n, 5 + i)
                             for i, n in enumerate(nodes)])
    assert route_sweep.digests_by_name(eng_a.result) == \
        route_sweep.digests_by_name(eng_b.result)


def test_dense_auto_resolves_per_shape():
    tuner = ForcedTuner("warps2")
    autotune.set_autotuner(tuner)
    spf.set_minplus_impl("auto")
    w = torch.tensor([[0, 3, minplus.INF], [3, 0, 1], [minplus.INF, 1, 0]],
                     dtype=torch.int32)
    ov = torch.zeros(3, dtype=torch.bool)
    d = spf.distances_from_sources(w, ov, torch.tensor([0, 2], dtype=torch.int32))
    np.testing.assert_array_equal(d.numpy(), [[0, 3, 4], [4, 1, 0]])
    assert tuner.asked[0] == ("minplus", "2x3")
