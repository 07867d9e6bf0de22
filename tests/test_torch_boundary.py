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
    assert {"openr_tpu_torch.decision.ksp2_engine", "openr_tpu_torch.ops.ell_relax"} <= set(names)


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
