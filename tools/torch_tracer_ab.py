#!/usr/bin/env python3
"""The PyTorch port's KSP2 engine under its two tracers, in turns, on one card.

    python3 tools/torch_tracer_ab.py          # from the root of a checkout

The engine's paths come from the native batch tracer (``csrc/spfcore.cpp``
``ksp2_trace_batch``, the default) or from the Python tracer
(``ksp2_engine.trace_paths_from_row``, its plain version). This script runs
the same KSP2 route builds under each, in the order native, python,
python, native, each run on a fresh solver and fresh copies of the
databases: the ``ksp2-1008`` and ``ksp2-10k`` networks of ``chip_smoke.py``
(every prefix KSP2 on the 1008-node fabric; 256 sampled ones on the
10 000-node fabric), an initial build, bench events that bump
``fsw-0-0``'s first adjacency metric and remote events that bump the last
pod's first rack switch. Both libraries (the CUDA kernels and the native
core) are built before the first run. Every run's route databases must
equal the first run's, event by event. Each build prints its host ms,
its affected destinations, the engine's trace parts (``trace_arrays_ms``,
``first_paths_ms``, ``second_paths_ms``, ``retrace_ms``) and the ms the
host spent in Python's garbage collector (``gc_ms``) as one JSON line;
the last lines are the card's ``nvidia-smi`` name and power limit, then a
summary with the median of each part over the runs of each tracer.
Without CUDA it exits nonzero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ORDER = ("native", "python", "python", "native")
NETWORKS = (("ksp2-1008", chip_smoke.DENSE_NODES, None, 3),
            ("ksp2-10k", chip_smoke.SPARSE_NODES, chip_smoke.KSP2_SAMPLED_DSTS, 2))
REMOTE_EVENTS = 2
PARTS = ("trace_arrays_ms", "first_paths_ms", "second_paths_ms", "retrace_ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tracer_ab.py: CUDA is not available", file=sys.stderr)
        return 2
    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import ksp2_engine
    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.graph import native_spf
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import _build
    from openr_tpu_torch.models import topologies

    dev = torch.device("cuda")
    _build.library()
    native_spf.library()
    gc_clock = chip_smoke.GcClock()
    spf_solver.KSP2_DEVICE_MIN_DSTS = 1
    summary = {}
    for label, nodes, sampled, events in NETWORKS:
        reference = None
        for run, tracer in enumerate(ORDER):
            ksp2_engine.TRACER = tracer
            ls, ps = chip_smoke.load_ksp2_network(topologies, LinkState, PrefixState,
                                                  nodes, sampled)
            remote = chip_smoke.remote_rsw(ls)
            solver = spf_solver.SpfSolver("rsw-0-0", backend="device", device=dev)
            steps = (["initial"] + [("fsw-0-0", 2 + i) for i in range(events)]
                     + [(remote, 3 + i) for i in range(REMOTE_EVENTS)])
            dbs = []
            for step in steps:
                if step != "initial":
                    chip_smoke.bump_metric(ls, *step)
                gc0 = gc_clock.read()[0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = solver.build_route_db("rsw-0-0", {ls.area: ls}, ps)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                gc_ms = gc_clock.read()[0] - gc0
                (engine,) = solver._ksp2_engines.values()
                if engine.tracer != tracer:
                    raise AssertionError(f"{label}: the engine traced with {engine.tracer}")
                stats = solver.ksp2_stats
                rec = {"network": label, "run": run, "tracer": tracer,
                       "event": step if step == "initial" else f"{step[0]}={step[1]}",
                       "ms": ms, "cold": bool(stats.get("cold")),
                       "affected": stats.get("affected"), "gc_ms": gc_ms,
                       **{k: stats.get(k, 0.0) for k in PARTS}}
                print(json.dumps(rec), flush=True)
                summary.setdefault((label, tracer, rec["event"]), []).append(rec)
                dbs.append(carry.route_db_to_plain(got.to_route_db("rsw-0-0")))
            if reference is None:
                reference = dbs
            elif dbs != reference:
                raise AssertionError(f"{label}: the {tracer} run's route databases differ")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {}
    for (label, tracer, event), recs in summary.items():
        out.setdefault(label, {}).setdefault(event, {})[tracer] = {
            k: statistics.median(r[k] for r in recs) for k in ("ms", "gc_ms") + PARTS}
    print(json.dumps({"tracer_ab": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
