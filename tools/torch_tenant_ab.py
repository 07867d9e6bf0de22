#!/usr/bin/env python3
"""The tenant plane's host-timed figures of two checkouts, in turns, on the card.

    python3 tools/torch_tenant_ab.py --other DIR            # from a checkout
    python3 tools/torch_tenant_ab.py --other DIR --turns 2 --out build/tenant_ab

``DIR`` is a second checkout (for example a parent commit unpacked with
``git archive``). Each run is a process of its own (a fresh heap and a
fresh kernel build in its checkout's ``build/``) that runs that
checkout's ``chip_smoke.py`` phases ``tenancy-1008`` and ``fleet-1008`` on
the card, in turns of other, this, this, other (``--turns`` of them).
These phases time single calls on the host's clock: the KSP2 view of 64
destinations, Decision's 4-area builds with and without the world batch,
and the fleet's live migration, so one run alone cannot tell a cost of
the code from the host's spread. A run prints one JSON line with those
figures, the warm rounds' ms and the profiled wave's busy and idle share;
the last line gives each figure's runs by checkout. ``--out`` keeps each
run's whole output. Exits nonzero if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("other", "this", "this", "other")


def run_child(tree: Path) -> int:
    """Both phases of ``tree``'s ``chip_smoke.py`` in this process."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    import chip_smoke
    from openr_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("torch_tenant_ab.py: CUDA is not available", file=sys.stderr)
        return 2
    _build.library()
    dev = torch.device("cuda")
    chip_smoke.tenancy_phase(dev)
    chip_smoke.fleet_phase(dev)
    return 0


def figures(lines) -> dict:
    """The figures of one run's phase lines."""
    out = {}
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("phase") == "tenancy-1008":
            out["ksp2_view_ms"] = rec["ksp2"]["ms"]
            out["decision_builds"] = rec["decision"]["builds"]
            out["round_ms"] = [r["ms"] for r in rec["round_lines"]]
            wave = rec.get("profiled_wave") or {}
            out["wave_busy_ms"] = wave.get("device_busy_ms")
            out["wave_idle_share"] = wave.get("device_idle_share")
            out["tenancy_s"] = rec.get("seconds")
        elif rec.get("phase") == "fleet-1008":
            out["migration_ms"] = rec["migration"]["ms"]
            out["fleet_s"] = rec.get("seconds")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="the checkout to compare with")
    ap.add_argument("--turns", type=int, default=1, help="turns of other, this, this, other")
    ap.add_argument("--out", type=Path, help="a directory for each run's whole output")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return run_child(args.child.resolve())
    if args.other is None:
        ap.error("--other is required")
    trees = {"this": ROOT, "other": args.other.resolve()}
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
    runs, failed = [], 0
    for turn in range(args.turns):
        for i, label in enumerate(ORDER):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", str(trees[label])],
                capture_output=True, text=True)
            if args.out:
                stem = args.out / f"turn{turn}_{i}_{label}"
                stem.with_suffix(".log").write_text(proc.stdout)
                stem.with_suffix(".err").write_text(proc.stderr)
            row = {"turn": turn, "tree": label, "rc": proc.returncode,
                   "s": time.monotonic() - t0, **figures(proc.stdout.splitlines())}
            failed += proc.returncode != 0
            runs.append(row)
            print(json.dumps(row), flush=True)
    keys = ("ksp2_view_ms", "migration_ms", "wave_busy_ms", "wave_idle_share")
    summary = {label: {k: [r.get(k) for r in runs if r["tree"] == label] for k in keys}
               for label in trees}
    for label in trees:
        builds = [r.get("decision_builds") or [] for r in runs if r["tree"] == label]
        summary[label]["decision_after_churn_ms"] = [
            [(b["world_batch_ms"], b["sequential_ms"]) for b in bs[1:]] for bs in builds]
    print(json.dumps({"summary": summary, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
