#!/usr/bin/env python3
"""Count the kernel records ``torch.profiler`` keeps of a session, on the card.

    python3 tools/torch_profiler_records.py [--sessions N]   # from a checkout

Each session launches ``minplus`` (the port's hand kernel, at the dense
route build's ``[8, 1024] x [1024, 1024]``) 30 times under the
profiler's CUDA activity and counts the records of its kernels, as
``chip_smoke.py``'s ``device_ms`` does. Sessions take turns: a plain
one, one that runs a spin kernel (``torch.cuda._sleep``) and synchronises
before the launches, one that does so in a warm-up step of a profiler
schedule, whose records are thrown away, and one that also idles 50 ms
inside the window before and after the launches (as ``chip_smoke.py``'s
``profiled`` does). One JSON line reports, per kind, each session's
record count against the records the launches made, and its launch skew
(``chip_smoke.launch_skew_us``: below 0 the card's records run behind the
host's clock, which bounds the session's window); a session short of
records is one that ``chip_smoke.py`` profiles again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=10, help="sessions of each kind")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_records.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from openr_tpu_torch.kernels import _build
    from openr_tpu_torch.ops.minplus import minplus, minplus_plan

    _build.library()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 1000, (8, 1024)).astype(np.int32)).cuda()
    b = torch.from_numpy(rng.integers(0, 1000, (1024, 1024)).astype(np.int32)).cuda()
    calls = 30
    want = calls * (1 + (minplus_plan(8, 1024, 1024).splits > 1))
    minplus(a, b)
    counts = {"plain": [], "spin first": [], "warm-up step": [], "window margin": []}
    skews = {kind: [] for kind in counts}
    for _ in range(args.sessions):
        for kind in counts:
            torch.cuda.synchronize()
            steps = {"schedule": schedule(wait=0, warmup=1, active=1)} \
                if kind in ("warm-up step", "window margin") else {}
            margin = 0.05 if kind == "window margin" else 0.0
            with profile(activities=[ProfilerActivity.CUDA], **steps) as prof:
                if kind != "plain":
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                if steps:
                    prof.step()
                time.sleep(margin)
                for _ in range(calls):
                    minplus(a, b)
                torch.cuda.synchronize()
                time.sleep(margin)
            counts[kind].append(chip_smoke.kernel_records(prof.key_averages(),
                                                          chip_smoke.KERNEL_KEYS["minplus"]))
            skews[kind].append(chip_smoke.launch_skew_us(prof))
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps({"records": counts, "launch_skew_us": skews, "want": want, "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
