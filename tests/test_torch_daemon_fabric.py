"""``chip_smoke.py``'s ``daemon-fabric`` phase rehearsed on the CPU, in
both packages.

``chip_smoke.daemon_fabric_phase`` drives whole daemons wired as a fat
tree through bring-up, the flood of a generated LSDB, generated events
and a cut link, and holds every daemon's Fib to its host oracle after
each step. Here it runs small (6 daemons, a 48-node LSDB, 4 events,
Spark's fast intervals with a 2 s hold) over the port's daemons on
``device="cpu"`` and over ``openr_tpu``'s daemons: after every step each
daemon's route database must be the same in both packages. The phase's own gates must bite: an
oracle that disagrees with the Fib fails it.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from openr_tpu.daemon import OpenrNode as JaxNode
from openr_tpu.decision.rib import DecisionRouteDb as JaxDecisionRouteDb
from openr_tpu.decision.spf_solver import SpfSolver as JaxSpfSolver
from openr_tpu.load.generator import LoadGenerator as JaxLoadGenerator
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.spark.io_provider import MockIoProvider as JaxIo
from openr_tpu import types as jax_types
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch import carry

FABRIC = {"pods": 1, "ssw_per_plane": 1, "fsw_per_pod": 2, "rsw_per_pod": 2}
LSDB_NODES = 48
EVENTS = 4
# Spark's own (fast) intervals, a short hold: the cut is seen in 2 s
SPARK = {"hold_time_s": 2.0}
CUT = ("rsw-0-1", "fsw-0-1")
STEP_S = 60.0


def reference_modules():
    """``chip_smoke.port_modules``'s pieces, from ``openr_tpu``."""
    T = jax_types
    return SimpleNamespace(
        OpenrNode=JaxNode, MockIoProvider=JaxIo, topologies=jax_topologies,
        LoadGenerator=JaxLoadGenerator, TTL_INFINITY=T.TTL_INFINITY,
        AdjacencyDatabase=T.AdjacencyDatabase, IpPrefix=T.IpPrefix, KeySetParams=T.KeySetParams,
        PrefixDatabase=T.PrefixDatabase, Value=T.Value, wire=jax_wire,
        DecisionRouteDb=JaxDecisionRouteDb, route_db_to_plain=carry.route_db_to_plain,
        oracle=lambda name: JaxSpfSolver(name, backend="host"), node_kwargs={})


def _phase(m):
    return chip_smoke.daemon_fabric_phase(m, FABRIC, LSDB_NODES, EVENTS, SPARK, CUT,
                                          step_s=STEP_S)


def test_the_card_phase_takes_the_deployed_spark_settings():
    spark = chip_smoke.deployed_spark_config()
    assert spark == {"hello_interval_s": 20.0, "fast_hello_interval_s": 0.5,
                     "handshake_interval_s": 0.5, "heartbeat_interval_s": 2.0,
                     "hold_time_s": 10.0, "graceful_restart_time_s": 30.0}


def test_fabric_rehearsal_matches_the_reference_at_every_step(capsys):
    port_line, port_fibs, launches = _phase(chip_smoke.port_modules(torch.device("cpu")))
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["phase"] == "daemon-fabric"
    _, ref_fibs, _ = _phase(reference_modules())
    steps = ["bring-up", "flood"] + [f"event {i}" for i in range(EVENTS)] + ["the cut"]
    assert list(port_fibs) == steps
    for step in steps:
        assert port_fibs[step] == ref_fibs[step], step
    # 6 daemons, 5 loopback routes each; the generated block is apart
    assert port_line["daemons"] == 6 and port_line["lsdb_nodes"] == LSDB_NODES + 6
    assert all(len(db[1]) == 5 for db in port_fibs["flood"].values())
    assert port_line["reroute"]["affected"] > 0
    assert port_line["neighbors_lost"] == 2
    assert not any(port_line["fallbacks"].values())
    # plain versions on CPU tensors launch nothing
    assert not any(launches.values())


def test_fabric_fails_when_a_fib_differs_from_its_oracle():
    m = chip_smoke.port_modules(torch.device("cpu"))
    real = m.oracle

    class DropsARoute:
        def __init__(self, name):
            self.solver = real(name)

        def build_route_db(self, *args):
            db = self.solver.build_route_db(*args)
            db.unicast_routes.pop(next(iter(db.unicast_routes)))
            return db

    m.oracle = DropsARoute
    with pytest.raises(AssertionError, match="differs from the host oracle"):
        chip_smoke.daemon_fabric_phase(m, FABRIC, LSDB_NODES, EVENTS, SPARK, CUT, step_s=3.0)
