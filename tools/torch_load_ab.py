#!/usr/bin/env python3
"""The route plane under sustained load in both packages, in turns, on the CPU.

    python3 tools/torch_load_ab.py              # from the root of a checkout
    python3 tools/torch_load_ab.py --turns 6    # 24 runs, about 15 min

Runs ``openr_tpu``'s ``SustainedLoadHarness`` (the reference) and the
PyTorch port's (``openr_tpu_torch``, ``device="cpu"``) at the same
settings: ``chip_smoke.py``'s ``pipeline-1008`` configuration (the
1008-node fabric, seed 20260805, debounce cap 0.05 s, admission with shed
depth 4 and cap 0.5 s, pipelined emit, 5 s windows at 120, 240 and 360
events/s) with the host solver backend in both, as ``tools/load_report.py``
runs the reference, so that the solver is the same Dijkstra and what
differs is each package's KvStore, Decision, Fib and harness. The runs go
in turns of reference, port, port, reference (``--turns`` of them), each
in a process of its own (a fresh heap), one after the other. A run
reports its initial convergence, then for each fixed-rate window the achieved rate, e2e
p50/p95/p99, the reader's high-water mark, the drain, the garbage
collector's ms and full collections, Decision's rebuilds and the median
and p99 of each part of the sampled traces (``chip_smoke.SPAN_PARTS``:
merge to debounce, debounce, rebuild span, to Fib, Fib), and whether its
live route database equals its oracle's replay. Each run prints one JSON
line; the last line is a summary of each part by package and rate (the
median over that package's runs) with each package's count of runs whose
parity check failed. Exits nonzero if a run failed, a window did not
drain or a parity check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ORDER = ("reference", "port", "port", "reference")


def rank(samples, q):
    """The nearest-rank ``q`` quantile of ``samples`` (None when empty)."""
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def run_one(package: str) -> dict:
    """One harness run of ``package`` in this process."""
    if package == "reference":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from openr_tpu.load import AdmissionConfig
        from openr_tpu.load.harness import SustainedLoadHarness
        from openr_tpu.telemetry import get_tracer

        extra = {}
    else:
        from openr_tpu_torch.load import AdmissionConfig
        from openr_tpu_torch.load.harness import SustainedLoadHarness
        from openr_tpu_torch.telemetry import get_tracer

        extra = {"device": "cpu"}
    gc_clock = chip_smoke.GcClock()
    tracer = get_tracer()
    t0 = time.perf_counter()
    h = SustainedLoadHarness(
        nodes=chip_smoke.DENSE_NODES, seed=chip_smoke.PIPELINE_SEED, solver_backend="host",
        debounce_max_s=chip_smoke.PIPELINE_DEBOUNCE_MAX_S,
        admission=AdmissionConfig(**chip_smoke.PIPELINE_ADMISSION),
        pipelined_emit=True, **extra)
    windows = []
    try:
        h.start(initial_timeout_s=chip_smoke.PIPELINE_START_S)
        start_s = time.perf_counter() - t0
        for rate in chip_smoke.PIPELINE_DENSE_RATES:
            parts, on_finish = chip_smoke.trace_parts()
            g0 = gc_clock.read()
            r0 = h.decision.counters["decision.route_build_runs"]
            tracer.add_finish_listener(on_finish)
            try:
                rep = h.run_fixed_rate(rate, chip_smoke.PIPELINE_WINDOW_S)
            finally:
                tracer.remove_finish_listener(on_finish)
            g1 = gc_clock.read()
            windows.append({
                "rate": rate, "achieved_rate": rep.achieved_rate, "e2e_ms": rep.e2e_ms,
                "e2e_samples": rep.e2e_samples, "traces_malformed": rep.traces_malformed,
                "depth_hwm": rep.depth_hwm, "drain_s": rep.drain_s, "drained": rep.drained,
                "gc_ms": g1[0] - g0[0], "gc_full_collections": g1[1] - g0[1],
                "rebuilds": h.decision.counters["decision.route_build_runs"] - r0,
                "median_parts_ms": {k: statistics.median(v) if v else None
                                    for k, v in parts.items()},
                "p99_parts_ms": {k: rank(v, 0.99) for k, v in parts.items()},
            })
        if not h.drain(timeout_s=chip_smoke.PIPELINE_DRAIN_S):
            raise AssertionError(f"{package}: the pipeline did not drain before the parity")
        parity = h.check_parity()
    finally:
        h.stop()
    return {"package": package, "nodes": len(h.topo.adj_dbs), "root": h.my_node,
            "solver_backend": "host", "initial_s": start_s,
            "windows": windows, "parity_with_oracle_replay": parity,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=1,
                    help="turns of reference, port, port, reference")
    ap.add_argument("--one", choices=sorted(set(ORDER)), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0

    runs, failed = [], []
    for package in ORDER * args.turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", package],
            capture_output=True, text=True, cwd=ROOT)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            failed.append({"package": package, "rc": proc.returncode,
                           "stderr": proc.stderr[-2000:]})
            continue
        run = json.loads(lines[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
        if not run["parity_with_oracle_replay"]:
            failed.append({"package": package, "parity_with_oracle_replay": False})
        for w in run["windows"]:
            if not w["drained"] or w["traces_malformed"] or not w["e2e_samples"]:
                failed.append({"package": package, "window": w["rate"]})

    def median_of(values):
        values = [v for v in values if v is not None]
        return statistics.median(values) if values else None

    summary = {}
    for package in dict.fromkeys(ORDER):
        mine = [r for r in runs if r["package"] == package]
        by_rate = {}
        for i, rate in enumerate(chip_smoke.PIPELINE_DENSE_RATES):
            ws = [r["windows"][i] for r in mine]
            by_rate[str(rate)] = {
                "achieved_rate": median_of([w["achieved_rate"] for w in ws]),
                "e2e_p50_ms": median_of([w["e2e_ms"]["p50"] for w in ws]),
                "e2e_p99_ms": median_of([w["e2e_ms"]["p99"] for w in ws]),
                "depth_hwm": median_of([w["depth_hwm"] for w in ws]),
                "rebuilds": median_of([w["rebuilds"] for w in ws]),
                "gc_ms": median_of([w["gc_ms"] for w in ws]),
                **{f"{k}_median_ms": median_of([w["median_parts_ms"][k] for w in ws])
                   for k in chip_smoke.SPAN_PARTS},
                **{f"{k}_p99_ms": median_of([w["p99_parts_ms"][k] for w in ws])
                   for k in chip_smoke.SPAN_PARTS},
            }
        summary[package] = {"runs": len(mine),
                            "parity_failures": sum(not r["parity_with_oracle_replay"]
                                                   for r in mine),
                            "initial_s": median_of([r["initial_s"] for r in mine]),
                            "by_rate": by_rate}
    print(json.dumps({"summary": summary, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
