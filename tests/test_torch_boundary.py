"""The port's boundary: it imports nothing of JAX or of ``openr_tpu``,
and it runs on the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from openr_tpu_torch import carry
from openr_tpu_torch.decision.spf_solver import SpfSolver, _EllResidentCache
from openr_tpu_torch.device import resolve_device
from openr_tpu_torch.graph.snapshot import SnapshotCache
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf_sparse import EllState, ell_masked_distances

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "openr_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import openr_tpu_torch
    names = [openr_tpu_torch.__name__]
    for info in pkgutil.walk_packages(
        openr_tpu_torch.__path__, openr_tpu_torch.__name__ + "."
    ):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = sorted(
        m for m in sys.modules if m.split(".")[0] in BLOCKED
    )
    assert not loaded, loaded
    print(" ".join(names))
    """
)


def test_port_and_chip_smoke_import_without_jax_or_openr_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # every module of the port was imported (the package has > 20),
    # the KSP2 ones among them
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) > 20
    assert {"openr_tpu_torch.decision.ksp2_engine", "openr_tpu_torch.ops.ell_relax",
            "openr_tpu_torch.ops.route_engine", "openr_tpu_torch.ops.host_sweep"} <= set(names)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpfSolver("x")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SnapshotCache()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        carry.snapshot_from_numpy(
            ["a"], [[0] * 128] * 128, [False] * 128
        )
    graph = carry.ell_from_numpy(
        ["a"], [(0, 1, 8)], [np.zeros((1, 8), np.int32)],
        [np.full((1, 8), INF, np.int32)], np.zeros(128, bool),
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ell_masked_distances(graph, 0, [np.zeros((1, 1), np.int32)])
    # the resident bands and the cache that holds them
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EllState(graph)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _EllResidentCache()


def test_entry_points_take_the_cpu_when_asked(no_cuda):
    assert SpfSolver("x", device="cpu").device == torch.device("cpu")
    graph = carry.ell_from_numpy(
        ["a"], [(0, 1, 8)], [np.zeros((1, 8), np.int32)],
        [np.full((1, 8), INF, np.int32)], np.zeros(128, bool),
    )
    # the band's packed edge mask: 1 row of 8 slots is one int32 word a
    # batch row
    rows = ell_masked_distances(graph, 0, [np.zeros((2, 1), np.int32)], device="cpu")
    assert rows.shape == (2, 128) and (rows[:, 0] == 0).all()
    assert SnapshotCache("cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    state = EllState(graph, "cpu")
    assert state.src[0].device == torch.device("cpu")
    assert _EllResidentCache("cpu").stager.device == torch.device("cpu")


def test_the_card_is_named_with_its_index(monkeypatch):
    # a tensor on the card reports "cuda:N", and torch.device("cuda") !=
    # torch.device("cuda:0"): an unindexed device made every resident
    # tensor look foreign, so the dense snapshot re-uploaded its whole
    # metric matrix on every topology version instead of patching rows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda:0")
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


def test_decision_modules_import_without_jax_or_openr_tpu():
    """The Decision slice's modules, each imported alone with JAX and
    ``openr_tpu`` refused (the walk above imports them all together)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in (
        "openr_tpu_torch.decision.decision",
        "openr_tpu_torch.graph.native_spf",
        "openr_tpu_torch.ops.dispatch_accounting",
        "openr_tpu_torch.telemetry.profiler",
        "openr_tpu_torch.faults.supervisor",
        "openr_tpu_torch.load.admission",
        "openr_tpu_torch.utils.wire",
    ):
        code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
            f"import importlib; importlib.import_module({name!r})\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (name, proc.stderr)


def test_native_core_builds_from_the_port_source_into_build():
    from openr_tpu_torch.graph import native_spf

    assert native_spf.SRC == Path(REPO) / "openr_tpu_torch" / "csrc" / "spfcore.cpp"
    assert native_spf.BUILD_DIR == Path(REPO) / "build" / "openr_tpu_torch"
    path = native_spf.build()
    assert path == native_spf.BUILD_DIR / "libspfcore.so" and path.exists()
    stamp = native_spf.BUILD_DIR / "libspfcore.so.sha256"
    assert stamp.read_text().strip() == native_spf._digest()
    # the reference's native/ directory is never read or built by the port
    assert "native" not in native_spf.SRC.relative_to(REPO).parts[:1]
    assert native_spf.library().spf_all_pairs is not None


def test_decision_raises_without_cuda(no_cuda):
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.messaging.queue import ReplicateQueue

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decision("a", ReplicateQueue(), ReplicateQueue())
    assert Decision("a", ReplicateQueue(), ReplicateQueue(), device="cpu").spf_solver.device == \
        torch.device("cpu")


def test_route_plane_modules_import_without_jax_or_openr_tpu():
    """The route plane's modules (KvStore, DUAL, the FIB service, Fib,
    the load generator and harness), each imported alone with JAX and
    ``openr_tpu`` refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in (
        "openr_tpu_torch.monitor.monitor",
        "openr_tpu_torch.dual.dual",
        "openr_tpu_torch.kvstore.store",
        "openr_tpu_torch.kvstore.client",
        "openr_tpu_torch.kvstore.wrapper",
        "openr_tpu_torch.platform.fib_service",
        "openr_tpu_torch.fib.fib",
        "openr_tpu_torch.load.generator",
        "openr_tpu_torch.load.harness",
    ):
        code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
            f"import importlib; importlib.import_module({name!r})\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (name, proc.stderr)


DAEMON_MODULES = (
    "openr_tpu_torch.types.spark",
    "openr_tpu_torch.utils.stepdetector",
    "openr_tpu_torch.utils.thrift_compact",
    "openr_tpu_torch.spark.thrift_wire",
    "openr_tpu_torch.spark.io_provider",
    "openr_tpu_torch.spark.spark",
    "openr_tpu_torch.config_store.persistent_store",
    "openr_tpu_torch.allocators.range_allocator",
    "openr_tpu_torch.platform.netlink",
    "openr_tpu_torch.linkmonitor.link_monitor",
    "openr_tpu_torch.prefixmgr.prefix_manager",
    "openr_tpu_torch.allocators.prefix_allocator",
    "openr_tpu_torch.plugin",
    "openr_tpu_torch.config.bgp_config",
    "openr_tpu_torch.config.config",
    "openr_tpu_torch.ctrl.handler",
    "openr_tpu_torch.daemon",
)


@pytest.mark.parametrize("name", DAEMON_MODULES)
def test_daemon_modules_import_without_jax_or_openr_tpu(name):
    """The daemon slice's modules (Spark and its wire, LinkMonitor, the
    allocators, PrefixManager, config, the plugin hook, the ctrl handler,
    ``OpenrNode``), each imported alone with JAX and ``openr_tpu``
    refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
        f"import importlib; importlib.import_module({name!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (name, proc.stderr)


def test_daemon_raises_without_cuda_before_starting_a_thread(no_cuda):
    import threading

    from openr_tpu_torch.daemon import OpenrNode
    from openr_tpu_torch.spark.io_provider import MockIoProvider

    io = MockIoProvider()
    try:
        before = threading.active_count()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OpenrNode("a", io)
        assert threading.active_count() == before
        node = OpenrNode("a", io, device="cpu")
        assert node.device == torch.device("cpu")
        assert node.decision.spf_solver.device == torch.device("cpu")
        node.start()
        node.stop()  # ends every module's threads, the queue readers' too
    finally:
        io.stop()


PROCESS_MODULES = (
    "openr_tpu_torch.utils.jsonable",
    "openr_tpu_torch.utils.rpc",
    "openr_tpu_torch.utils.theader",
    "openr_tpu_torch.utils.thrift_binary",
    "openr_tpu_torch.utils.thrift_rpc",
    "openr_tpu_torch.kvstore.transport",
    "openr_tpu_torch.kvstore.thrift_peer",
    "openr_tpu_torch.kvstore.dualstack",
    "openr_tpu_torch.ctrl.thrift_ctrl",
    "openr_tpu_torch.ctrl.server",
    "openr_tpu_torch.cli.printing",
    "openr_tpu_torch.cli.breeze",
    "openr_tpu_torch.platform.netlink_fib_handler",
    "openr_tpu_torch.platform.thrift_fib",
    "openr_tpu_torch.platform.netlink_linux",
    "openr_tpu_torch.platform.agent",
    "openr_tpu_torch.monitor.watchdog",
    "openr_tpu_torch.config.gflags",
    "openr_tpu_torch.main",
)


@pytest.mark.parametrize("name", PROCESS_MODULES)
def test_process_modules_import_without_jax_or_openr_tpu(name):
    """The process slice's modules (the RPC codecs and THeader, the
    KvStore peer wires, the ctrl server and its thrift service, breeze,
    the FIB agent and rtnetlink socket, the watchdog, the gflags dialect,
    ``main``), each imported alone with JAX and ``openr_tpu`` refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
        f"import importlib; importlib.import_module({name!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (name, proc.stderr)


def test_a_named_card_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(torch.device("cuda", 0))


def test_the_daemon_process_runs_without_jax_or_openr_tpu(tmp_path):
    """``python -m openr_tpu_torch.main --device cpu`` boots and stops
    with JAX and ``openr_tpu`` refused at import."""
    code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + textwrap.dedent(
        """
        import runpy, signal, threading, time

        def stop_when_started():
            # main installs its handler once the node is up
            while signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
                time.sleep(0.05)
            signal.pthread_kill(threading.main_thread().ident, signal.SIGTERM)

        threading.Thread(target=stop_when_started, daemon=True).start()
        sys.argv = ["openr_tpu_torch.main", "--device", "cpu", "--config", sys.argv[1]]
        try:
            runpy.run_module("openr_tpu_torch.main", run_name="__main__")
        except SystemExit as exc:
            assert exc.code == 0, exc.code
        assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]
        print("stopped")
        """)
    cfg = tmp_path / "node.json"
    cfg.write_text('{"node_name": "guard", "openr_ctrl_port": 0, "kvstore": {"peer_port": 0}, '
                   f'"persistent_store_path": "{tmp_path / "store.bin"}"}}')
    proc = subprocess.run([sys.executable, "-c", code, str(cfg)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("stopped")


def test_committed_dispatch_modules_import_without_jax_or_openr_tpu():
    """The committed dispatch's modules (the executable cache, the
    autotuner, the relax loops), each imported alone with JAX and
    ``openr_tpu`` refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in (
        "openr_tpu_torch.ops.aot_cache",
        "openr_tpu_torch.ops.autotune",
        "openr_tpu_torch.ops.relax_loop",
    ):
        code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
            f"import importlib; importlib.import_module({name!r})\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (name, proc.stderr)


TENANT_MODULES = (
    "openr_tpu_torch.ops.world_batch",
    "openr_tpu_torch.serve",
    "openr_tpu_torch.serve.slo",
    "openr_tpu_torch.serve.service",
    "openr_tpu_torch.serve.client",
    "openr_tpu_torch.fleet",
    "openr_tpu_torch.fleet.placement",
    "openr_tpu_torch.fleet.journal",
    "openr_tpu_torch.fleet.controller",
    "openr_tpu_torch.ctrl.solver",
    "openr_tpu_torch.load.multi_client",
)


@pytest.mark.parametrize("name", TENANT_MODULES)
def test_tenant_plane_modules_import_without_jax_or_openr_tpu(name):
    """The tenant plane's and the solver service's modules, each imported
    alone with JAX and ``openr_tpu`` refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0] + (
        f"import importlib; importlib.import_module({name!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (name, proc.stderr)


@pytest.mark.parametrize("name", ["openr_tpu_torch.serve.client",
                                  "openr_tpu_torch.load.multi_client",
                                  "openr_tpu_torch.fleet.placement"])
def test_the_client_path_imports_without_torch(name):
    """A solver client process imports neither torch nor JAX: the client,
    and the client path of ``load.multi_client`` (a tenant's world and
    churn schedule built, the child entry reached) with ``torch`` refused
    as well."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _BLOCKED_IMPORT.split("import openr_tpu_torch\n")[0].replace(
        'BLOCKED = ("jax", "jaxlib", "openr_tpu")',
        'BLOCKED = ("jax", "jaxlib", "openr_tpu", "torch")',
    ) + (
        f"import importlib; importlib.import_module({name!r})\n"
        "from openr_tpu_torch.load.multi_client import TenantSpec, apply_mutation, run_client\n"
        "spec = TenantSpec('t', 'fabric', 60, seed=3)\n"
        "dbs = spec.build_dbs(); apply_mutation(dbs, spec, 1)\n"
        "assert spec.build_prefix_dbs()\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (name, proc.stderr)


def test_tenant_plane_entry_points_raise_without_cuda(no_cuda):
    from openr_tpu_torch.fleet import FleetController
    from openr_tpu_torch.ops.world_batch import WorldManager, get_world_manager
    from openr_tpu_torch.serve.service import SolverService

    for make in (WorldManager, SolverService, get_world_manager,
                 lambda: FleetController(services=1, with_standby=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert WorldManager(device="cpu").device == torch.device("cpu")
    assert SolverService(device="cpu").device == torch.device("cpu")
    fc = FleetController(services=1, with_standby=True, device="cpu")
    for ms in fc.services().values():
        assert ms.service.device == ms.standby_service.device == torch.device("cpu")


def test_chip_smoke_tenant_phases_rehearsed_on_the_cpu(capsys, monkeypatch):
    """``chip_smoke.py``'s tenant-plane phases at a small size on the CPU:
    ``tenancy-1008`` (vantages of three tiers, area tenants joining, churn
    and overrides, eviction, KSP2, the multi-area Decision build),
    ``tenancy-10k``, ``serve-1008`` (spawned torch-free clients; a small
    run's waves may end before the next request, so joins are not
    required) and ``fleet-1008`` (a migration and a promotion). One torch
    thread here and in the spawned oracle (one process): the small
    tensors gain nothing from more, and a loaded test run's threads
    would fight them."""
    import json

    import chip_smoke

    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    oracle_async = chip_smoke._oracle_digests_async
    monkeypatch.setattr(chip_smoke, "_oracle_digests_async",
                        lambda specs, rounds: oracle_async(specs, rounds, workers=1))
    try:
        _rehearse_tenant_phases(chip_smoke, cpu)
    finally:
        torch.set_num_threads(threads)
    lines = {}
    for x in capsys.readouterr().out.splitlines():
        if x.startswith("{"):
            rec = json.loads(x)
            lines[rec.get("phase")] = rec
    t = lines["tenancy-rehearsal"]
    assert t["views_match_oracle"] and t["bucket_count"] == 2
    assert t["batched_over_sequential_steady"] is not None
    assert all("gc_ms" in r for r in t["round_lines"])
    assert t["eviction"]["tenancy"]["rehydrations"] > 0
    assert t["decision"]["world_preloads"] == 2 and t["decision"]["world_preload_failures"] == 0
    assert lines["tenancy-10k-rehearsal"]["aot_compiles_after_first_round"] == 0
    assert lines["serve-rehearsal"]["digests_match_oracle"]
    assert lines["serve-rehearsal"]["fib_match_oracle"]
    f = lines["fleet-rehearsal"]
    assert f["migration"]["warm"] and f["promotion"]["deletes"] == 0


def _rehearse_tenant_phases(chip_smoke, cpu) -> None:
    chip_smoke.tenancy_phase(cpu, nodes=120, vantages={"rsw": 4, "fsw": 2, "ssw": 2}, areas=2,
                             rounds=5, slots=8, resident=16, evict=(2, 2, 4, 3), ksp2_dsts=8,
                             decision_areas=2, profile=False, phase="tenancy-rehearsal")
    chip_smoke.tenancy_10k_phase(cpu, nodes=300, areas=2, rounds=2, phase="tenancy-10k-rehearsal")
    chip_smoke.serve_phase(cpu, nodes=60, clients=2, tenants=2, rounds=2, slots=8,
                           fib_tenants=1, require_joins=False, phase="serve-rehearsal")
    chip_smoke.fleet_phase(cpu, nodes=60, tenants=3, rounds=5, migrate_at=1, promote_at=3,
                           phase="fleet-rehearsal")


def test_chip_smoke_worlds_kernel_row_rehearsed_on_the_cpu():
    """``chip_smoke.worlds_kernel_row`` (the world relax and its live pass
    in the ``kernels`` phase) on a small fabric on the CPU: its checks
    run through the plain versions, the plan and the bounds are reported,
    and the bound over the walked slots lies under the padded one."""
    import chip_smoke

    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import spf_sparse

    ls, _ = chip_smoke._fabric_ls(topologies, LinkState, 120)
    graph = spf_sparse.compile_ell(ls)
    seen = []

    def compare(name, got, want, what):
        seen.append(name)
        assert got.shape == want.shape and torch.equal(got, want), (name, what)

    row = chip_smoke.worlds_kernel_row(torch, torch.device("cpu"), graph, 3, 5,
                                       np.random.default_rng(1), compare)
    assert seen == ["ell_live_slots", "ell_band_relax", "ell_band_relax"]
    assert row["shape"]["B"] == 3 and row["plan"]["grid"][2] == 3
    assert 0 < row["slots_walked_per_world"] <= row["live_slots_per_world"]
    assert row["bound_ms"] < row["padded_bound_ms"] and row["bound_by"] == "bytes"
    assert "ms" not in row  # no device time without the card
