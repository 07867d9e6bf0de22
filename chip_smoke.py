#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's route build, route sweep, Decision module, route plane and daemon fabric on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each (``"phase": ...``):

0. ``env``: torch, CUDA and nvcc versions and the card. The card's
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line
   is also printed on a line of its own.
1. ``build``: the CUDA kernels built from ``openr_tpu_torch/csrc`` by
   ``nvcc``, then the native SPF core (``csrc/spfcore.cpp``, host C++) by
   ``g++`` into ``build/openr_tpu_torch/libspfcore.so``, with the
   compiler's version line.
2. ``setup``: the two networks (a 1008-node and a 10 000-node 3-tier
   fat-tree) loaded into link-state and prefix databases.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   exactly (int32), at the shapes of the main path and at random ragged
   shapes with INF and overloaded nodes sprinkled in. ``kernel_ms`` and
   ``plain_ms`` are device time per call from the profiler's CUDA
   activity. A session missed device activity, and is profiled again
   (six times, then the script fails), when it records none, when it
   holds fewer kernel records than its calls launched, or when a relax
   step's reading is below 0.9 of the sum of its bands or segments, each
   profiled alone. ``call_ms`` is
   CUDA-event time per call, host launch path included. The bands and
   segments of ``ell_band_relax`` and the route sweep kernels name the
   launch plan they took.
4. ``dense``: ``SpfSolver(backend="device").build_route_db`` from
   ``rsw-0-0`` on the 1008-node fabric (dense regime), then churn events
   that bump one adjacency metric of ``fsw-0-0`` (``bench.py``'s event, a
   neighbour of the root), then 3 remote events that bump the first
   adjacency of the last pod's first rack switch; after every build the
   route database must equal the host Dijkstra solver's. ``view_ms`` is
   the part spent in the build's one SPF view (graph compile or patch,
   device solve, readback), ``assembly_ms`` the rest; each build reports
   the prefixes and node-label routes it re-derived and its
   ``decision.sp_route_reuses`` (together they must cover every prefix);
   ``remote_event_ms`` and ``remote_routes_rebuilt`` are the remote
   events'. One more profiled build gives the card's
   busy time, idle share, heaviest device ops, host-to-device copy time
   by kind (``h2d_copy_ms``) and each launched kernel's
   device time (``kernel_device_ms``, with its ``kernel_records`` beside
   the build's launches); a session that holds less device time of a
   kernel the build launched than its launches times its least time a
   launch at the main path's shapes missed device activity and is
   profiled again on a fresh churn event (six times, then the script
   fails). Launch counts and
   the solver's host-SPF fallback count are zeroed before the phase and
   read after it; the fallback count must stay at 0. The LFA build must
   re-derive every route.
5. ``sparse``: the same on the 10 000-node fabric (sliced-ELL regime,
   resident bands). Each build also reports its deltas of
   ``decision.ell_full_compiles``, ``ell_patches``, ``ell_warm_solves``
   and ``ell_cold_solves``, the host-to-device bytes the solver staged
   (``h2d_bytes``, by kind) and its warm solve's hops; every build after
   the first must take the patch path (no full compile) and a warm
   solve, and every view must equal a cold ``ell_view_batch_packed``
   over the same bands on the card (launches of that check not counted).
6. ``sweep-1008``: the all-sources route sweep of the 1008-node fabric
   (block 256), on three backends: the out-edge ELL sweep
   (``rev_band_relax``) and the grouped sweep under each contraction
   kernel (``batched_minplus``, ``batched_minplus_t``), with one sample
   node per tier (``rsw``, ``fsw``, ``ssw``). Every destination's digest
   and next-hop total must equal the host Dijkstra's (``host_digest``
   over ``run_spf`` from every source), the backends must agree by node
   name, and each sample's route table must equal ``run_spf``'s.
   ``sweep_ms`` is the host clock around the whole sweep (it ends in a
   readback); one more block is profiled for the card's busy time, idle
   share and the backend kernel's own device time (a session that
   recorded none of that kernel is profiled again); ``block_hops`` are
   the relax hops of each block. The
   launch counts are zeroed before the phase; each backend must launch
   its kernel, and the grouped sweeps no ELL kernel.
7. ``sweep-10k``: the same on the 10 000-node fabric (block 1024); the
   oracle there is the backends' agreement by name and each sample's
   route table against ``run_spf``. It also prints the grouped graph's
   ``structure_report``.
8. ``ksp2-1008``: KSP2_ED_ECMP route builds from ``rsw-0-0`` on the
   1008-node fabric with every prefix KSP2 over SR-MPLS (1007
   destinations), through the incremental KSP2 engine
   (``decision/ksp2_engine.py``, with its fast path: every
   destination's edge mask resident and re-solved in each event's fused
   dispatch): an initial build, churn events that bump ``fsw-0-0``'s
   first adjacency metric, then 3 remote events that bump the last pod's
   first rack switch. Every route database must equal the host Dijkstra
   solver's, which runs on its own copy of the link-state and prefix
   databases (the kth-path cache lives on the ``LinkState``: a shared
   one would hand it the device's second paths), and after each event
   the engine's resident all-sources matrix must equal a cold
   ``ell_distances_from_sources`` on the card. Each build reports cold
   build or incremental sync, the affected destinations, the KSP2
   route reuses and counter deltas, the all-sources hops, fast path on
   or off, the speculative rows changed, the engine's host-clock parts
   (``SpfSolver.ksp2_stats``), the ms the host spent in Python's
   garbage collector (``gc_ms``) and the rest (``assembly_ms``). One
   more bench and one more remote build are profiled, as in ``dense``.
   The KSP2 device batches must be > 0, its host fallbacks and the
   views' host-SPF fallbacks 0, a remote event must sync incrementally
   and reuse KSP2 routes, and ``ell_band_relax`` and
   ``ell_band_relax_masked`` must launch.
9. ``ksp2-10k``: the same on the 10 000-node fabric with 256 evenly
   sampled KSP2 prefixes (the stride of ``benchmarks/bench_scale.py``'s
   ``ksp2_churn_bench``), the rest SP_ECMP: the engine without its fast
   path (255 resident masks would pass the mask budget), the
   all-sources relax at S = 10112.
10. ``ksp2-1008-chunked``: the per-build chunked masked dispatch, the
   path above the engine's node bound, with the engine turned off
   (``ENGINE_MAX_NODES = 0``), for 2 events on a fresh copy of the
   1008-node KSP2 network (one masked chunk of 1024). Each build is split
   into the view, the hop gate's unit-metric SPF, the KSP2 graph sync,
   the host first-path traces, the mask build, the masked solve (upload,
   device relax hops, readback; ``hops`` from its launch count), the
   second-path traces and route assembly (the rest), with the bytes of
   bit-packed edge masks the build uploaded (``mask_bytes``) beside the
   bytes the same masks took as bool cells. The masked solves run over
   the solver's resident bands: a churn build uploads no band
   (``band_bytes_per_build``; patch rows and masks only).

11. ``decision-1008``: the port's ``Decision`` module on the card
   (``decision/decision.py``), wired to two ``ReplicateQueue``s (in:
   KvStore publications, out: route updates) and running on its own event
   base thread, at the module's default debounce (0.010 s, 0.250 s),
   backend ``device``, root ``rsw-0-0``, on the 1008-node fabric. Every
   adjacency and prefix database goes in as one publication (keys from
   ``utils/keys.py``, values from ``utils/wire.py``), then 10 bench events
   re-publish ``fsw-0-0``'s adjacency database with its first metric at
   ``2 + step % 5`` and 3 remote events ``rsw-61-0``'s. Each event reports
   ``pub_to_update_ms`` (host clock from the push to the route update off
   the out-queue, the debounce included) and its parts: ``publication_ms``
   (the push to the debounce window's start; of it ``process_ms`` and
   ``prewarm_ms``, timed around the module's calls), ``debounce_ms``,
   ``rebuild_ms`` (the ``decision.rebuild_ms`` sample: the solve),
   ``emit_ms`` (the route diff and push) and ``gc_ms``; the rebuild
   span's ``host_touches``, ``host_dispatches`` and
   ``blocking_syncs`` (dispatch accounting), its SP route reuses and its
   routes updated and deleted. After each the installed route database
   must equal the host Dijkstra solver's on its own copy of the
   databases, the ladder must stay on its warm rung (no
   ``decision.fallbacks``, ``degradations`` or ``ladder_exhausted``) and
   ``minplus`` must have launched.
12. ``decision-10k``: the same on the 10 000-node fabric, 3 bench and 3
   remote events (``rsw-623-0``); also every rebuild after the first
   patches the resident bands (no ``decision.ell_full_compiles``), the
   publications prewarm them (``decision.ell_prewarms`` > 0), and
   ``ell_band_relax`` launches; ``ops.spec_*`` are reported as read.
13. ``decision-ladder``: a fresh 1008-node module; the fault seam
   ``decision.spf_solve`` armed ``fail_once`` (the rebuild lands on the
   ``cold`` rung), then ``fail_n(2)`` (the ``native`` rung: the host C++
   core), then disarmed (once the breaker allows a probe, the module heals
   back onto the card). Every route database equals the oracle's, and the
   ladder counters read one fallback, one degradation, one self-heal, two
   warm and one cold rung failures.
14. ``pipeline-1008``: the route plane under sustained load, as
   ``tools/load_report.py``'s full mode drives the reference: the port's
   ``load/harness.py::SustainedLoadHarness`` wires KvStore
   (``kvstore/store.py``) -> Decision (backend ``device``, on the card)
   -> Fib (``fib/fib.py``) over ``MockFibAgent``, each on its own event
   base, with seed 20260805, debounce cap 0.05 s, admission (shed depth
   4, cap 0.5 s) and pipelined emit, root ``rsw-0-0`` of the 1008-node
   fabric; the seeded generator's default mix (metric churn 0.70, link
   flap 0.15, prefix update 0.15). It reports the initial convergence,
   then a 5 s window at each of 120, 240 and 360 events/s: each window's
   ``RateReport.to_dict()`` (offered, published, achieved rate, e2e
   p50/p95/p99 from the KvStore merge to the programmed FIB and its
   sample count, malformed traces, the reader's high-water mark, drain
   seconds, shed and coalesce counters) with the garbage collector's ms
   (``gc_ms``), the kernel launches by name and Decision's rebuilds; one
   more 2 s window at 120 events/s under the profiler (the card's busy
   ms, its idle share over the session and, at least, over the
   publishing span alone, beside the drain ms; a session with fewer
   records of the kernel than the window launched is run again); then ``find_max_sustainable_rate`` against
   a 100 ms p99 (``BM_DecisionFabric``'s goal; from 25 to 800 events/s,
   2 s probes) with its ladder. A fixed-rate window that did not drain
   or took no e2e sample fails the phase; so does any window with a
   malformed trace, without a ``minplus`` launch, or in which
   ``decision.fallbacks`` or ``decision.spf_host_fallback`` moved. At
   the end the live route database must equal the harness's unshedded
   host replay of the journal (``check_parity``; the replay must launch
   no kernel) and the host Dijkstra solver's over the generator's final
   databases.
15. ``pipeline-10k``: the same on the 10 000-node fabric (sparse regime,
   resident bands; ``ell_band_relax`` must launch in every window) at 10
   and 40 events/s, with no rate search and no Dijkstra check beyond the
   replay.

16. ``daemon-fabric``: whole daemons (``daemon.py::OpenrNode``: Spark,
   LinkMonitor, KvStore, PrefixManager, Decision on the card, Fib) wired
   as ``FABRIC``'s fat tree (8 spines, 2 pods of 4 fabric and 4 rack
   switches: 24 daemons named ``d-<switch>``) over one ``MockIoProvider``,
   Spark set from the configuration's defaults as the process entry point
   sets it (a keepalive every 2 s, a 10 s hold), each advertising
   ``fd01:<i>::1/128``. Bring-up (``bringup_s``: from ``start()`` until
   every daemon's Fib routes every other loopback); the flood
   (``flood_s``: the generator's LSDB of the 1008-node fabric, seed
   20260805, set at ``d-rsw-0-0``'s KvStore, until every Decision holds
   all 1032 nodes and their prefixes and has rebuilt; the generated block
   is a component of its own, so its prefixes get no routes); 20
   generator events one at a time (``event_ms`` each, until every
   Decision holds it and is idle); the cut (``reroute_ms``: the link
   ``rsw-1-0``–``fsw-1-0`` partitioned both ways, until both ends lost
   the neighbour, every Decision dropped the link and every Fib equals
   its oracle, the oracles' own build left out). After each step
   every daemon's Fib must equal the host oracle (``SpfSolver`` on the
   host backend over that daemon's own link-state and prefix state, run
   on its Decision's thread; it must launch no kernel); no neighbour may
   be lost but the cut's two; no ``decision.fallbacks`` or
   ``spf_host_fallback``; ``minplus`` must launch. It reports launches by
   kernel and by step, threads, ``gc_ms``, the solvers' pinned bytes and
   ``torch.cuda.max_memory_allocated``.

Phases 14 and 15 run in a process of their own (``pipeline_process``,
started with ``spawn`` and joined): it holds only the route plane, as a
daemon's does. The earlier phases keep six copies of the two networks
alive, and a full garbage collection's pause grows with the heap. Phase
16 runs last, in another (``daemon_fabric_process``).

Every phase line carries ``t_s``, the seconds since the script started.
Each profiler session idles a margin inside its window before and after
what it measures, doubled after a short session (``profiled``); a
``profiler`` line of the main process, and one of the pipeline's, counts
the sessions, the short ones, the margin and the launch skew.

The ``kernels`` phase holds ``ell_band_relax`` also at the KSP2 engine's
all-sources shapes, S = n_pad rows (1024 and 10112), against its plain
version on slices of 1024 rows. That of the route sweep's kernels (``rev_band_relax``,
``batched_minplus``, ``batched_minplus_t``) runs at both sweeps' shapes:
one relax step of a 1024-destination block of the 10 000-node sweep and
of a 256-destination block of the 1008-node one; that of
``ell_band_relax_masked`` at both KSP2 cells' chunks (S = 1024 over the
1008-node in-bands, S = 256 over the 10 000-node ones), with bit-packed
masks, beside two bounds: the packed mask's and a byte mask's; that of
``minplus`` at the dense route build's ``[8, 1024] x [1024, 1024]`` and
at ``[64, 1024] x [1024, 1024]`` (a high-degree root's batch), each with
its launch plan.

Then one ``{"kernels": [...]}`` line (time, bound, plain time and main-path
launches of every kernel) and, last, ``{"ok": true, "device": {...}}``.
Any mismatch or error raises: the exit code is then nonzero and the last
line is not printed. Without CUDA, or outside a checkout, the script
exits nonzero before doing anything. The sizes are fixed: the 1008-node
fabric of the repo's ``bench.py`` (10 churn events and 3 remote ones;
with KSP2 5 and 3, and 2 with the chunked dispatch; through Decision 10
and 3) and a 10 000-node one (3 events and 3 remote ones; with KSP2 2 and
3; through Decision 3 and 3; under load, the windows above; 24 daemons,
20 events); only the seed of the random kernel inputs can be set.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores, the closest listed rate for the
# int32 add/min work of these kernels (tensor cores have no min-plus mode)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# the main path's networks: fat_tree_nodes(1000) is bench.py's 1008-node
# 3-tier fabric (dense regime), fat_tree_nodes(10000) the 10 000-node one
# (sliced-ELL regime); churn events per network; timed calls per kernel
DENSE_NODES = 1000
SPARSE_NODES = 10000
DENSE_EVENTS = 10
SPARSE_EVENTS = 3
# remote events after the churn events of each route-build phase: a bump of
# the first adjacency of the last pod's first rack switch, far from the root
REMOTE_EVENTS = 3
# the resident bands' counters the sparse phase reports per build
ELL_KEYS = ("ell_full_compiles", "ell_patches", "ell_warm_solves", "ell_cold_solves")
REPS = 30
# route sweep: destinations per block on each network (the reference
# scale bench's 1008-node and 10 000-node settings)
DENSE_SWEEP_BLOCK = 256
SPARSE_SWEEP_BLOCK = 1024
# KSP2 cells: churn events on the 1008-node fabric (every prefix KSP2) and
# on the 10 000-node one, where KSP2_SAMPLED_DSTS evenly sampled prefixes
# are KSP2 (the realistic per-prefix opt-in at that scale)
KSP2_DENSE_EVENTS = 5
KSP2_SPARSE_EVENTS = 2
KSP2_SAMPLED_DSTS = 256
# the chunked KSP2 dispatch (engine off) stays driven on the 1008-node
# fabric for this many churn events
KSP2_CHUNKED_EVENTS = 2
# rows of the all-sources relax held against the plain version at once
ALL_SOURCES_SLICE = 1024
# the Decision module's phases: bench events (a re-published fsw-0-0
# adjacency database) on the 1008-node and the 10 000-node fabric, each
# followed by REMOTE_EVENTS remote ones; the module's default debounce
DECISION_DENSE_EVENTS = 10
DECISION_SPARSE_EVENTS = 3
DECISION_DEBOUNCE_S = (0.010, 0.250)
# the longest a route update may take to come off the out-queue
DECISION_WAIT_S = 600.0
# the route plane under sustained load (tools/load_report.py's full mode):
# the harness's seed, debounce cap and admission, fixed-rate windows
# (events/s) of PIPELINE_WINDOW_S on the 1008-node and the 10 000-node
# fabric, one profiled window, and on the 1008-node fabric the search for
# the highest rate whose e2e p99 meets the reference fabric goal
# (BM_DecisionFabric, 100 ms)
PIPELINE_SEED = 20260805
PIPELINE_DEBOUNCE_MAX_S = 0.05
PIPELINE_ADMISSION = {"shed_depth": 4, "cap_s": 0.5}
PIPELINE_DENSE_RATES = (120, 240, 360)
PIPELINE_SPARSE_RATES = (10, 40)
PIPELINE_WINDOW_S = 5.0
PIPELINE_PROFILED_S = 2.0
PIPELINE_SEARCH = {"p99_slo_ms": 100.0, "lo": 25, "hi": 800, "duration_s": 2.0}
# the parts of a sampled trace, in order: the KvStore merge to the debounce
# window's start (queue hand-off and Decision's processing), the debounce,
# the rebuild span (solve and emit), the rebuild's end to Fib's start, and
# Fib's programming
SPAN_PARTS = ("to_debounce", "debounce", "rebuild", "to_fib", "fib_program")
# the longest the initial convergence and the drain before the parity
# may take
PIPELINE_START_S = 600.0
PIPELINE_DRAIN_S = 120.0
# the daemon fabric (daemon-fabric): one OpenrNode a switch of FABRIC's fat
# tree (8 spines, 2 pods of 4 fabric and 4 rack switches: 24 daemons), named
# FABRIC_PREFIX and the switch's name, over one MockIoProvider, Spark set as
# the process entry point sets it from the configuration's defaults
# (deployed_spark_config: a 10 s hold); the generator's LSDB of
# fat_tree_nodes(FABRIC_LSDB_NODES) flooded in at FABRIC_INJECT,
# FABRIC_EVENTS of its events, then the link FABRIC_CUT partitioned both
# ways; the longest a step may take
FABRIC = {"pods": 2, "ssw_per_plane": 2, "fsw_per_pod": 4, "rsw_per_pod": 4}
FABRIC_PREFIX = "d-"
FABRIC_INJECT = "d-rsw-0-0"
FABRIC_LSDB_NODES = 1000
FABRIC_EVENTS = 20
FABRIC_CUT = ("rsw-1-0", "fsw-1-0")
FABRIC_STEP_S = 120.0
# the chunked KSP2 prefetch's host-clock parts (SpfSolver.ksp2_stats)
KSP2_PARTS = ("hop_gate_ms", "graph_ms", "first_paths_ms", "masks_ms", "solve_ms",
              "second_paths_ms")
# the KSP2 counters each engine build reports the deltas of
KSP2_COUNTERS = ("decision.ksp2_cold_builds", "decision.ksp2_incremental_syncs",
                 "decision.ksp2_warm_dispatches", "decision.ksp2_affected_dsts",
                 "decision.ksp2_route_reuses", "decision.ksp2_device_batches",
                 "decision.ksp2_host_fallbacks")


_START = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.monotonic() - _START)
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, after warm-up. For a
    kernel shorter than its host-side launch path this is the launch path:
    the card waits between the two events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The profiler keeps a device record only when its times fall inside the
# session's window, which it takes on the host's clock; where the card's
# records run behind that clock (``launch_skew_us`` below 0) a session
# loses the kernels launched early in it, or every kernel of a short one.
# So a session idles ``margin_s`` inside its window before ``fn`` and after
# it; a short session doubles the margin, up to PROFILE_MARGIN_MAX_S, for
# itself and every later session of the process. ``PROFILER`` also counts
# the sessions, the short ones, and each session's launch skew (µs).
PROFILE_MARGIN_MAX_S = 1.6
PROFILER = {"margin_s": 0.05, "sessions": 0, "short": 0, "skew_us": []}


def launch_skew_us(prof):
    """The least time (µs) from a kernel's launch, the host's runtime
    record, to its start on the card, CUPTI's record, over the finished
    session ``prof``; None where it holds no launched kernel. A few µs
    where the two clocks agree; below 0 the card's records run behind."""
    try:
        events = prof.profiler.kineto_results.events()
        launched = {e.correlation_id(): e.start_ns() for e in events
                    if "LaunchKernel" in e.name() and "CUDA" not in str(e.device_type())}
        gaps = [e.start_ns() - launched[e.correlation_id()] for e in events
                if "CUDA" in str(e.device_type()) and e.correlation_id() in launched]
    except (AttributeError, RuntimeError):
        return None
    return min(gaps) / 1e3 if gaps else None


def profiler_summary() -> dict:
    """The ``profiler`` phase line's fields: this process's sessions,
    the short ones, the margin it ended with, and the launch skew's
    least, median and greatest reading."""
    skews = [x for x in PROFILER["skew_us"] if x is not None]
    return {"sessions": PROFILER["sessions"], "short_sessions": PROFILER["short"],
            "margin_s": PROFILER["margin_s"],
            "launch_skew_us": [min(skews), statistics.median(skews), max(skews)]
            if skews else None}


def profiled(torch, fn, short, attempts: int = 6, prepare=None):
    """Run ``fn`` under the profiler's CUDA activity (CUPTI), in the step
    after a warm-up step the profiler throws away and between two idle
    margins inside the window (``PROFILER``), and return
    ``(key_averages, fn's result, host ms)``. ``short(stats, result)``
    names what the session's device activity lacks (``{}`` when it is
    whole, see ``lacking``); a session that lacks some missed device
    activity: it is reported on stderr with its launch skew and, after a
    pause, run again with the margin doubled, up to ``attempts`` times;
    then this raises. Short sessions come in runs
    (``tools/torch_profiler_records.py`` counts them: on an H100 about one
    in 25 sessions kept a part of its records, and whole-script runs saw
    three and six short sessions in a row). ``prepare(attempt)``, when
    given, runs before each session, outside it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    gaps = {}
    for attempt in range(attempts):
        if prepare is not None:
            prepare(attempt)
        margin = PROFILER["margin_s"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            # a warm-up step switches CUPTI on and is thrown away: kernels
            # launched early in a session went unrecorded (all six of a
            # ksp2-10k build's, in three whole runs)
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
            time.sleep(margin)
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(margin)
        stats = prof.key_averages()
        gaps = short(stats, result)
        skew = launch_skew_us(prof)
        PROFILER["sessions"] += 1
        PROFILER["skew_us"].append(skew)
        if not gaps:
            return stats, result, wall_ms
        PROFILER["short"] += 1
        PROFILER["margin_s"] = min(2 * margin, PROFILE_MARGIN_MAX_S)
        print(json.dumps({"profiler_session_missed_device_time": gaps,
                          "attempt": attempt + 1, "margin_s": margin,
                          "launch_skew_us": skew,
                          "keys": [evt.key[:80] for evt in stats][:8]}),
              file=sys.stderr, flush=True)
        time.sleep(1.0)
    raise RuntimeError(
        f"the profiler missed device time in {attempts} sessions: {gaps}"
    )


def _keys(name):
    return (name,) if isinstance(name, str) else tuple(name)


def _step_mark(evt) -> bool:
    """The profiler schedule's step annotation (``ProfilerStep#n``): not
    device activity of its own."""
    return evt.key.startswith("ProfilerStep")


def device_us(stats, name) -> float:
    """Device microseconds in ``stats`` of the kernels whose name holds
    ``name``, or any of the strings of a tuple ``name`` (all device
    activity when ``name`` is ``"a call"``)."""
    return sum(
        getattr(evt, "self_device_time_total", 0) or 0
        for evt in stats
        if (name == "a call" and not _step_mark(evt))
        or any(key in evt.key for key in _keys(name))
    )


def top_device_ms(stats, n: int = 6):
    """The ``n`` heaviest device ops in ``stats``: ``[key, ms, count]``."""
    top = sorted((e for e in stats if not _step_mark(e)),
                 key=lambda e: getattr(e, "self_device_time_total", 0) or 0,
                 reverse=True)[:n]
    return [[evt.key[:60], (getattr(evt, "self_device_time_total", 0) or 0) / 1e3,
             evt.count] for evt in top]


def copy_ms(stats, way: str = "HtoD") -> dict:
    """Device ms of the host-to-device copies in ``stats`` (``way``
    "DtoH": device-to-host), by the profiler's copy kind (pageable or
    pinned host memory), with their counts: ``{kind: [ms, count]}``."""
    out = {}
    for evt in stats:
        if f"Memcpy {way}" in evt.key:
            kind = "pinned" if "Pinned" in evt.key else "pageable"
            ms, n = out.get(kind, [0.0, 0])
            out[kind] = [ms + (getattr(evt, "self_device_time_total", 0) or 0) / 1e3,
                         n + evt.count]
    return out


def count_calls(obj, name: str) -> list:
    """Wrap ``obj.name`` so that each call adds one to the returned
    one-element list."""
    calls = [0]
    real = getattr(obj, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(obj, name, counted)
    return calls


class GcClock:
    """Host ms spent in Python's cyclic garbage collector, and its full
    (generation 2) collections, counted through ``gc.callbacks`` from
    construction on; a build reads the delta around it."""

    def __init__(self):
        self.ms = 0.0
        self.full = 0
        self._t0 = None
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2
            self._t0 = None

    def read(self):
        return self.ms, self.full


def kernel_records(stats, name) -> int:
    """How many kernel executions of ``name`` (as in ``device_us``) the
    profiler recorded in ``stats``."""
    return sum(evt.count for evt in stats if any(key in evt.key for key in _keys(name)))


def lacking(stats, name, floor_us: float = 0.0, records: int = 0) -> dict:
    """``{}`` when ``stats`` hold device time of ``name``, at least
    ``floor_us`` of it, and at least ``records`` kernel executions of it;
    else what fell short. A session that lost kernel records, or recorded
    none of a kernel it ran, missed device activity."""
    got = device_us(stats, name)
    n = kernel_records(stats, name) if records else 0
    if got and got >= floor_us and n >= records:
        return {}
    return {str(name): {"device_us": got, "floor_us": floor_us,
                        "records": n, "want_records": records}}


# the parts of each kernel's names that the profiler's keys hold (a split
# batched_minplus launch ends in the reduce kernel it shares with _t; no
# session launches both)
KERNEL_KEYS = {
    "minplus": ("minplus_tile", "minplus_split_reduce"),
    "ell_band_relax": ("ell_band_relax_",),
    "ell_band_relax_masked": ("masked_relax_",),
    "rev_band_relax": ("rev_band_relax_",),
    "batched_minplus": ("batched_minplus_rows", "batched_minplus_cols",
                        "batched_minplus_t_reduce"),
    "batched_minplus_t": ("batched_minplus_t_",),
}

# a step's profiled device time below this share of the sum of its parts
# (bands or segments, each profiled alone in the same run) means the
# session missed device activity
PARTS_SHARE = 0.9


def device_ms(torch, fn, calls: int, name=None, parts_ms: float = 0.0,
              records: int = 0) -> float:
    """Device time per call of ``fn`` from the profiler's CUDA activity
    (CUPTI): the kernels whose name contains ``name``, or all device
    activity (kernels, copies, fills) when ``name`` is None. ``records``
    is the number of kernel executions of ``name`` a call launches and
    ``parts_ms`` the sum of the per-call times of ``fn``'s parts: a
    session with fewer records than ``calls`` x ``records``, or below
    ``PARTS_SHARE`` of the parts, is profiled again. Raises when no
    session recorded device time (or all of it)."""
    what = name or "a call"
    fn()

    def run():
        for _ in range(calls):
            fn()

    floor_us = PARTS_SHARE * parts_ms * 1e3 * calls
    stats, _, _ = profiled(
        torch, run, lambda st, _: lacking(st, what, floor_us, records * calls))
    return device_us(stats, what) / 1e3 / calls


def bound_ms(nbytes: int, nops: int):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def band_least_ms(batch: int, rows: int, k: int) -> float:
    """The least time one band of a relax step can take on the card from
    device memory: its own ``[batch, rows]`` columns read and written
    once, its slots (id and weight) read once."""
    return bound_ms(8 * batch * rows + 8 * rows * k, 0)[0]


def build_lacking(stats, launched, least_launch_ms) -> dict:
    """What a profiled route build's session lacks (``lacking``) of the
    kernels the build launched, ``launched[name]`` times each: every one
    must show device time of at least its launches x its least time a
    launch. Its kernel records are not held to its launches: a build's
    session lost one of 21 records in three sessions running on an H100,
    where 30-call kernel sessions never did; the phase line shows both."""
    gaps = {}
    for name, n in launched.items():
        gaps.update(lacking(stats, KERNEL_KEYS[name], n * least_launch_ms[name] * 1e3))
    return gaps


def churn_build(torch, solver, areas, ps, root, LAUNCHES):
    """A function for ``profiled`` that builds the route database and
    returns it, the kernels the build launched and how often, and the
    build's host ms. Each session needs a fresh churn event before it
    (``profiled``'s ``prepare``): a view already solved is cached."""

    def build():
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = solver.build_route_db(root, areas, ps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return got, {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] > before[k]}, ms

    return build


def load_network(topologies, LinkState, PrefixState, nodes: int):
    return load_topology(topologies.fat_tree_nodes(nodes), LinkState, PrefixState)


def load_ksp2_network(topologies, LinkState, PrefixState, nodes: int, ksp2_dsts=None):
    """The fabric with SR-MPLS prefixes: every one KSP2_ED_ECMP
    (``ksp2_dsts`` None), or ``ksp2_dsts`` evenly sampled ones KSP2 and
    the rest SP_ECMP, sampled as ``benchmarks/bench_scale.py``'s
    ``ksp2_churn_bench`` samples them."""
    from dataclasses import replace

    from openr_tpu_torch.types.lsdb import (
        PrefixForwardingAlgorithm,
        PrefixForwardingType,
    )

    ksp2 = PrefixForwardingAlgorithm.KSP2_ED_ECMP
    topo = topologies.fat_tree_nodes(
        nodes,
        forwarding_algorithm=ksp2 if ksp2_dsts is None else PrefixForwardingAlgorithm.SP_ECMP,
        forwarding_type=PrefixForwardingType.SR_MPLS,
    )
    if ksp2_dsts is not None:
        names = sorted(topo.prefix_dbs)
        stride = max(1, len(names) // ksp2_dsts)
        for name in names[::stride][:ksp2_dsts]:
            pdb = topo.prefix_dbs[name]
            topo.prefix_dbs[name] = replace(pdb, prefix_entries=tuple(
                replace(e, forwarding_algorithm=ksp2) for e in pdb.prefix_entries
            ))
    return load_topology(topo, LinkState, PrefixState)


def load_topology(topo, LinkState, PrefixState):
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    ps = PrefixState()
    for name in sorted(topo.prefix_dbs):
        ps.update_prefix_database(topo.prefix_dbs[name])
    return ls, ps


def bump_metric(ls, node: str, metric: int) -> None:
    """The churn event of the repo's bench: one adjacency metric of
    ``node`` changes (an incremental LSDB update)."""
    from dataclasses import replace

    db = ls.get_adjacency_databases()[node]
    adjs = list(db.adjacencies)
    adjs[0] = replace(adjs[0], metric=metric)
    ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))


def remote_rsw(ls) -> str:
    """The remote events' node: the last pod's first rack switch, far
    from the root."""
    return "rsw-%d-0" % max(
        int(name.split("-")[1]) for name in ls.get_adjacency_databases()
        if name.startswith("rsw-")
    )


def decision_phases(dev, root, dense_nodes, sparse_nodes, dense_events, sparse_events,
                    gc_clock=None):
    """The Decision module's phases (``decision-1008``, ``decision-10k``,
    ``decision-ladder``) on ``dev``, each emitting its JSON line; returns
    each phase's kernel launches. The sizes are arguments so a rehearsal
    can run them small on the CPU; ``main`` passes the full ones."""
    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.faults import FaultSchedule, HealthState, get_injector
    from openr_tpu_torch.graph import native_spf
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.messaging.queue import ReplicateQueue
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.telemetry import get_registry, get_tracer
    from openr_tpu_torch.types import Publication, Value
    from openr_tpu_torch.utils import keys as keyutil
    from openr_tpu_torch.utils import wire

    gc_clock = gc_clock or GcClock()
    dense_label = "1008" if dense_nodes == DENSE_NODES else str(dense_nodes)
    sparse_label = "10k" if sparse_nodes == SPARSE_NODES else str(sparse_nodes)
    reg = get_registry()
    tracer = get_tracer()

    def counter_deltas(c0, names):
        return {k: reg.counter_get(k) - c0.get(k, 0) for k in names}

    def last_sample(name):
        hist = reg.histogram_if_exists(name)
        return hist._ring[(hist._next - 1) % len(hist._ring)]

    class DecisionRun:
        """A port Decision on the card, wired to two ReplicateQueues (in:
        KvStore publications, out: route updates) and started on its
        event base thread, and the host Dijkstra oracle on its own copy of
        the databases. ``publish`` pushes adjacency and prefix databases
        as one publication (keys from ``utils.keys``, values from
        ``utils.wire``, a new version each) with a trace; ``wait`` reads
        the route update it caused off the out-queue."""

        def __init__(self, phase, nodes):
            self.phase = phase
            self.topo = topologies.fat_tree_nodes(nodes)
            self.host_ls, self.host_ps = load_topology(self.topo, LinkState, PrefixState)
            self.host = SpfSolver(root, backend="host", device=dev)
            self.kv_q = ReplicateQueue(name="kvStoreUpdates")
            self.route_q = ReplicateQueue(name="routeUpdates")
            self.reader = self.route_q.get_reader("chip_smoke")
            self.decision = Decision(
                root, self.kv_q, self.route_q, debounce_min_s=DECISION_DEBOUNCE_S[0],
                debounce_max_s=DECISION_DEBOUNCE_S[1], solver_backend="device", device=dev)
            self.adj = dict(self.topo.adj_dbs)
            self.versions = {}
            # host ms of the publication's processing and prewarm, timed
            # around the module's own calls on its event base
            self.host_ms = {"process_ms": 0.0, "prewarm_ms": 0.0}
            self._time(self.decision, "process_publication", "process_ms")
            self._time(self.decision.spf_solver, "prewarm", "prewarm_ms")
            self.decision.start()

        def _time(self, obj, name, part):
            real = getattr(obj, name)

            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    self.host_ms[part] += (time.perf_counter() - t0) * 1e3

            setattr(obj, name, timed)

        def publish(self, dbs):
            kv = {}
            for db in dbs:
                key = (keyutil.adj_key if hasattr(db, "adjacencies")
                       else keyutil.prefix_db_key)(db.this_node_name)
                self.versions[key] = self.versions.get(key, 0) + 1
                kv[key] = Value(version=self.versions[key], originator_id=db.this_node_name,
                                value=wire.dumps(db))
            pub = Publication(key_vals=kv, area=self.topo.area)
            pub.trace = tracer.start("kvstore.publish", node=root)
            t0 = time.perf_counter()
            self.kv_q.push(pub)
            return t0

        def wait(self, t0):
            """The route update, the host ms since ``t0``, and the
            event's parts: the rebuild span's dispatch accounting, the
            ms from the push to the debounce window's start (queue,
            decode, LinkState update, prewarm), the debounce window, the
            rebuild's solve (``decision.rebuild_ms``) and the rest of its
            span (the route diff and the push), and the garbage
            collector's ms meanwhile."""
            gc0 = gc_clock.read()
            host0 = dict(self.host_ms)
            update = self.reader.get(timeout=DECISION_WAIT_S)
            ms = (time.perf_counter() - t0) * 1e3
            gc1 = gc_clock.read()
            trace = update.trace
            spans = {sp.name: sp for sp in trace.spans} if trace else {}
            rebuild, debounce = spans.get("decision.rebuild"), spans.get("decision.debounce")
            if rebuild is None or debounce is None:
                raise AssertionError(f"{self.phase}: a route update without its spans")
            tracer.finish(trace, ok=True)
            solve_ms = last_sample("decision.rebuild_ms")
            parts = {
                "publication_ms": debounce.ts_ms - trace.ts_ms,
                **{k: v - host0[k] for k, v in self.host_ms.items()},
                "debounce_ms": debounce.dur_ms,
                "rebuild_ms": solve_ms,
                "emit_ms": rebuild.dur_ms - solve_ms,
                "gc_ms": gc1[0] - gc0[0], "gc_full_collections": gc1[1] - gc0[1],
            }
            return update, ms, dict(rebuild.attrs, **parts)

        def bump(self, node, metric):
            from dataclasses import replace

            db = self.adj[node]
            self.adj[node] = replace(db, adjacencies=(
                replace(db.adjacencies[0], metric=metric),) + db.adjacencies[1:])
            bump_metric(self.host_ls, node, metric)
            return self.adj[node]

        def check(self, step):
            d = self.decision
            got = d.evb.call_and_wait(
                lambda: carry.route_db_to_plain(d.route_db.to_route_db(root)),
                timeout=DECISION_WAIT_S)
            want = self.host.build_route_db(root, {self.host_ls.area: self.host_ls}, self.host_ps)
            if got != carry.route_db_to_plain(want.to_route_db(root)):
                raise AssertionError(f"{self.phase}: the installed route database differs "
                                     f"from the host oracle after event {step}")
            if d.supervisor.state is not HealthState.HEALTHY:
                raise AssertionError(f"{self.phase}: the ladder left the warm rung "
                                     f"({d.supervisor.state.name}) at event {step}")

        def stop(self):
            self.decision.stop()

    LADDER_COUNTERS = ("decision.fallbacks", "decision.ladder_exhausted",
                       "decision.degradations", "decision.self_heals",
                       "decision.rung_failures.warm", "decision.rung_failures.cold")
    SPEC_COUNTERS = ("ops.spec_dispatches", "ops.spec_hits", "ops.spec_cancels",
                     "ops.spec_skips")

    def decision_drive(phase, nodes, events):
        """The Decision module on the card: the initial convergence, then
        ``events`` bench events (``fsw-0-0``'s adjacency database
        re-published with its first metric at 2 + step % 5) and
        REMOTE_EVENTS remote ones (the last pod's first rack switch). Each
        reports the host clock from the push to the route update
        (debounce included), the module's ``decision.rebuild_ms`` sample,
        the rebuild span's dispatch accounting, the SP route reuses and
        the routes updated and deleted; after each the installed route
        database must equal the host oracle's, the ladder must stay on
        its warm rung and no fallback may be counted. The launch counts
        are zeroed just before and read just after."""
        run = DecisionRun(phase, nodes)
        remote = remote_rsw(run.host_ls)
        reset_launches()
        c0 = dict(reg._counters)
        records = []
        try:
            def one(step, dbs):
                s0 = dict(reg._counters)
                t0 = run.publish(dbs)
                update, ms, attrs = run.wait(t0)
                rec = {
                    "event": step, "pub_to_update_ms": ms,
                    **{k: attrs[k] for k in ("publication_ms", "process_ms", "prewarm_ms",
                                             "debounce_ms", "rebuild_ms", "emit_ms", "gc_ms",
                                             "gc_full_collections")},
                    "host_touches": attrs.get("host_touches"),
                    "host_dispatches": attrs.get("host_dispatches"),
                    "blocking_syncs": attrs.get("blocking_syncs"),
                    "sp_route_reuses": reg.counter_get("decision.sp_route_reuses")
                    - s0.get("decision.sp_route_reuses", 0),
                    "routes_updated": len(update.unicast_routes_to_update),
                    "routes_deleted": len(update.unicast_routes_to_delete),
                    "ell": {k: reg.counter_get(f"decision.{k}") - s0.get(f"decision.{k}", 0)
                            for k in ELL_KEYS + ("ell_prewarms",)},
                }
                run.check(step)
                bad = {k: v for k, v in counter_deltas(c0, LADDER_COUNTERS).items() if v}
                if bad:
                    raise AssertionError(f"{phase}: the ladder moved at event {step}: {bad}")
                return rec

            initial = one("initial", list(run.topo.adj_dbs.values())
                          + list(run.topo.prefix_dbs.values()))
            for step in range(events):
                records.append(one(step, [run.bump("fsw-0-0", 2 + step % 5)]))
            remotes = [one(f"remote {i}", [run.bump(remote, 3 + i)])
                       for i in range(REMOTE_EVENTS)]
        finally:
            run.stop()
        launches = dict(LAUNCHES)
        counters = counter_deltas(c0, LADDER_COUNTERS + SPEC_COUNTERS + (
            "decision.ell_full_compiles", "decision.ell_prewarms", "decision.ell_patches",
            "decision.sp_route_reuses",
            "decision.spf_host_fallback", "ops.host_dispatches", "ops.blocking_syncs"))
        if counters["decision.spf_host_fallback"]:
            raise AssertionError(f"{phase}: {counters['decision.spf_host_fallback']} SPF "
                                 "queries went to a host Dijkstra")
        events_only = records + remotes
        if nodes > spf_solver.SPARSE_NODE_THRESHOLD:
            full = [r["event"] for r in events_only if r["ell"]["ell_full_compiles"]]
            if full:
                raise AssertionError(f"{phase}: rebuilds {full} compiled the bands in full")
            if counters["decision.ell_prewarms"] == 0:
                raise AssertionError(f"{phase}: no publication prewarmed the resident bands")
            kernel = "ell_band_relax"
        else:
            kernel = "minplus"
        if dev.type == "cuda" and launches[kernel] == 0:
            raise AssertionError(f"{phase}: the module's rebuilds launched no {kernel}")
        emit({
            "phase": phase, "nodes": len(run.topo.adj_dbs), "root": root,
            "debounce_s": DECISION_DEBOUNCE_S, "events": events, "remote_node": remote,
            "parity_with_host_oracle": True, "health": "HEALTHY",
            "pub_to_update_includes_debounce": True,
            "initial": initial,
            "median_pub_to_update_ms": statistics.median(r["pub_to_update_ms"] for r in records),
            "median_rebuild_ms": statistics.median(r["rebuild_ms"] for r in records),
            "event_builds": records, "remote_builds": remotes,
            "counters": counters, "launches": launches,
        })
        return launches

    def decision_ladder(phase):
        """The degradation ladder on a fresh 1008-node module: the fault
        seam ``decision.spf_solve`` armed ``fail_once`` (the rebuild lands
        on the cold rung), then ``fail_n(2)`` (the native rung: the host
        C++ core), then disarmed (once the breaker lets a probe through,
        the module heals back onto the card). Each route database must
        equal the oracle's, and the ladder counters read what the
        reference's TestDecisionLadder reads."""
        run = DecisionRun(phase, dense_nodes)
        reset_launches()
        rungs = []
        try:
            t0 = run.publish(list(run.topo.adj_dbs.values()) + list(run.topo.prefix_dbs.values()))
            run.wait(t0)
            run.check("initial")
            c0 = dict(reg._counters)
            for step, (schedule, want) in enumerate((
                    (FaultSchedule.fail_once(), ("DEGRADED", "device")),
                    (FaultSchedule.fail_n(2), ("FALLBACK", "native")),
                    (None, ("HEALTHY", "device")))):
                if schedule is None:
                    get_injector().reset()
                    time.sleep(run.decision.supervisor.breaker.get_time_remaining_until_retry()
                               + 0.05)
                else:
                    get_injector().arm("decision.spf_solve", schedule)
                t0 = run.publish([run.bump("fsw-0-0", 7 + 2 * step)])
                update, ms, attrs = run.wait(t0)
                d = run.decision
                state = (d.supervisor.state.name, d.spf_solver.backend)
                got = d.evb.call_and_wait(
                    lambda: carry.route_db_to_plain(d.route_db.to_route_db(root)),
                    timeout=DECISION_WAIT_S)
                want_db = run.host.build_route_db(
                    root, {run.host_ls.area: run.host_ls}, run.host_ps)
                if got != carry.route_db_to_plain(want_db.to_route_db(root)):
                    raise AssertionError(f"{phase}: the {state} route database differs from "
                                         "the host oracle")
                if state != want:
                    raise AssertionError(f"{phase}: step {step} landed on {state}, not {want}")
                rungs.append({"step": step, "health": state[0], "backend": state[1],
                              "pub_to_update_ms": ms,
                              **{k: attrs[k] for k in ("rebuild_ms", "emit_ms", "gc_ms",
                                                       "gc_full_collections")},
                              "host_dispatches": attrs.get("host_dispatches"),
                              "blocking_syncs": attrs.get("blocking_syncs"),
                              "routes_updated": len(update.unicast_routes_to_update)})
        finally:
            get_injector().reset()
            run.stop()
        counters = counter_deltas(c0, LADDER_COUNTERS)
        want = {"decision.fallbacks": 1, "decision.ladder_exhausted": 0,
                "decision.degradations": 1, "decision.self_heals": 1,
                "decision.rung_failures.warm": 2, "decision.rung_failures.cold": 1}
        if counters != want:
            raise AssertionError(f"{phase}: ladder counters {counters}, want {want}")
        emit({"phase": phase, "nodes": len(run.topo.adj_dbs), "root": root,
              "rungs": rungs, "counters": counters, "parity_with_host_oracle": True,
              "native_library": native_spf.LIB_NAME, "launches": dict(LAUNCHES)})
        return dict(LAUNCHES)

    small = decision_drive(f"decision-{dense_label}", dense_nodes, dense_events)
    large = decision_drive(f"decision-{sparse_label}", sparse_nodes, sparse_events)
    faults = decision_ladder("decision-ladder")
    return small, large, faults



def trace_parts():
    """``(parts, on_finish)``: a tracer finish listener that appends each
    well-formed sampled trace's parts (``SPAN_PARTS``, ms) to the lists of
    ``parts``. It reads only span names and times, so it serves the
    reference package's tracer as well as the port's."""
    parts = {k: [] for k in SPAN_PARTS}

    def on_finish(trace, ok):
        spans = {sp.name: sp for sp in trace.spans}
        debounce, rebuild = spans.get("decision.debounce"), spans.get("decision.rebuild")
        program = spans.get("fib.program")
        if not ok or trace.e2e_ms is None or None in (debounce, rebuild, program):
            return
        for name, ms in zip(SPAN_PARTS, (
                debounce.ts_ms - trace.ts_ms, debounce.dur_ms, rebuild.dur_ms,
                program.ts_ms - rebuild.ts_ms - rebuild.dur_ms, program.dur_ms)):
            parts[name].append(ms)

    return parts, on_finish


def pipeline_phases(dev, dense_nodes, sparse_nodes, dense_rates, sparse_rates, window_s,
                    search, profiled_s=PIPELINE_PROFILED_S):
    """The route plane under sustained load (``pipeline-1008``,
    ``pipeline-10k``) on ``dev``, each emitting its JSON line; returns
    each phase's kernel launches. ``search`` holds the keyword arguments
    of ``find_max_sustainable_rate`` for the dense fabric (None: no
    search). The sizes, rates and durations are arguments so a rehearsal
    can run them small on the CPU; ``main`` passes the full ones."""

    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.load import AdmissionConfig
    from openr_tpu_torch.load.harness import SustainedLoadHarness
    from openr_tpu_torch.telemetry import get_registry, get_tracer

    gc_clock = GcClock()
    reg = get_registry()
    tracer = get_tracer()
    dense_label = "1008" if dense_nodes == DENSE_NODES else str(dense_nodes)
    sparse_label = "10k" if sparse_nodes == SPARSE_NODES else str(sparse_nodes)
    fallbacks = ("decision.fallbacks", "decision.spf_host_fallback",
                 "decision.degradations", "decision.ladder_exhausted")

    def window(h, phase, kernel, run, rate, duration_s, p99_slo_ms=None, fixed=True):
        """One window through ``run`` (the harness's ``run_fixed_rate``):
        its ``RateReport``, and its record with the garbage collector's
        ms, the kernel launches by name and Decision's rebuilds beside
        the report, and the median of each part of the sampled traces
        (``SPAN_PARTS``). A fixed-rate window fails the phase if it did not
        drain or took no e2e sample; any window does if a trace was
        malformed, ``kernel`` never launched on the card, or a fallback
        counter moved."""
        l0, g0 = dict(LAUNCHES), gc_clock.read()
        r0 = h.decision.counters["decision.route_build_runs"]
        f0 = {k: reg.counter_get(k) for k in fallbacks}
        parts, on_finish = trace_parts()
        tracer.add_finish_listener(on_finish)
        try:
            rep = run(rate, duration_s, p99_slo_ms=p99_slo_ms)
        finally:
            tracer.remove_finish_listener(on_finish)
        g1 = gc_clock.read()
        rec = dict(rep.to_dict(), gc_ms=g1[0] - g0[0], gc_full_collections=g1[1] - g0[1],
                   launches={k: LAUNCHES[k] - l0[k] for k in LAUNCHES if LAUNCHES[k] > l0[k]},
                   rebuilds=h.decision.counters["decision.route_build_runs"] - r0,
                   median_parts_ms={k: statistics.median(v) if v else None
                                    for k, v in parts.items()})
        faults = []
        if fixed and not rep.drained:
            faults.append(f"did not drain in {rep.drain_s} s")
        if fixed and not rep.e2e_samples:
            faults.append("took no e2e sample")
        if rep.traces_malformed:
            faults.append(f"{rep.traces_malformed} malformed traces")
        if dev.type == "cuda" and not rec["launches"].get(kernel):
            faults.append(f"launched no {kernel}")
        moved = {k: reg.counter_get(k) - f0[k] for k in fallbacks if reg.counter_get(k) != f0[k]}
        if moved:
            faults.append(f"fallback counters moved: {moved}")
        if faults:
            raise AssertionError(f"{phase}: the {rate} events/s window " + "; ".join(faults))
        return rep, rec

    def pipeline_drive(phase, nodes, rates, search):
        """The harness on ``dev`` (``tools/load_report.py``'s full-mode
        configuration): the initial convergence, a window at each of
        ``rates`` for ``window_s``, one profiled window at ``rates[0]``
        for ``profiled_s`` (device busy ms and idle share), the rate
        search when ``search`` is given, then the parity: the live route
        database against the host oracle's replay of the journal (which
        must launch nothing) and, in the dense regime, against the host
        Dijkstra solver on the generator's final databases. The launch
        counts are zeroed just before and read just after."""
        import torch

        kernel = "ell_band_relax" if nodes > spf_solver.SPARSE_NODE_THRESHOLD else "minplus"
        reset_launches()
        c0 = dict(reg._counters)
        g0 = gc_clock.read()
        t0 = time.perf_counter()
        h = SustainedLoadHarness(
            nodes=nodes, seed=PIPELINE_SEED, solver_backend="device",
            debounce_max_s=PIPELINE_DEBOUNCE_MAX_S, admission=AdmissionConfig(**PIPELINE_ADMISSION),
            pipelined_emit=True, device=dev)
        try:
            h.start(initial_timeout_s=PIPELINE_START_S)
            g1 = gc_clock.read()
            initial = {"seconds": time.perf_counter() - t0, "gc_ms": g1[0] - g0[0],
                       "gc_full_collections": g1[1] - g0[1], "launches": dict(LAUNCHES),
                       "rebuilds": h.decision.counters["decision.route_build_runs"]}
            windows = [window(h, phase, kernel, h.run_fixed_rate, rate, window_s)[1]
                       for rate in rates]
            profile = None
            if dev.type == "cuda":
                # each launch of ``kernel`` runs its first key's kernel once
                # (a split minplus adds a reduce): a session with fewer of
                # those records than the window's launches missed some
                launch_key = KERNEL_KEYS[kernel][0]

                def short(stats, result):
                    return lacking(stats, launch_key,
                                   records=result[1]["launches"].get(kernel, 0))

                stats, (rep, rec), wall_ms = profiled(
                    torch, lambda: window(h, phase, kernel, h.run_fixed_rate, rates[0],
                                          profiled_s), short)
                busy_ms = device_us(stats, "a call") / 1e3
                # the publishing span (offered events over the achieved rate)
                # and the drain after it; all the session's device time
                # counted against the publishing span alone gives the least
                # idle share the card can have had while work was offered
                publish_ms = rep.offered / rep.achieved_rate * 1e3
                profile = {"window": rec, "wall_ms": wall_ms, "publish_ms": publish_ms,
                           "drain_ms": rep.drain_s * 1e3, "device_busy_ms": busy_ms,
                           "device_idle_share": 1 - busy_ms / wall_ms,
                           "device_idle_share_publishing_least": 1 - busy_ms / publish_ms,
                           "kernel_records": kernel_records(stats, launch_key),
                           "kernel_device_ms": device_us(stats, KERNEL_KEYS[kernel]) / 1e3,
                           "top_device_ms": top_device_ms(stats)}
            found = None
            if search is not None:
                probes = []

                def probe(rate, duration_s, p99_slo_ms=None):
                    rep, rec = window(h, phase, kernel, real, rate, duration_s, p99_slo_ms,
                                      fixed=False)
                    probes.append(rec)
                    return rep

                real = h.run_fixed_rate
                h.run_fixed_rate = probe
                try:
                    found = h.find_max_sustainable_rate(**search)
                finally:
                    del h.run_fixed_rate
                found["ladder"] = probes
            if not h.drain(timeout_s=PIPELINE_DRAIN_S):
                raise AssertionError(f"{phase}: the pipeline did not drain before the parity")
            l0 = dict(LAUNCHES)
            parity = h.check_parity()
            oracle_launches = {k: LAUNCHES[k] - l0[k] for k in LAUNCHES if LAUNCHES[k] != l0[k]}
            if not parity:
                raise AssertionError(f"{phase}: the live route database differs from the "
                                     "oracle's replay of the journal")
            if oracle_launches:
                raise AssertionError(f"{phase}: the oracle's replay launched {oracle_launches}")
            dijkstra = None
            if kernel == "minplus":
                gen = h.generator
                ls, ps = load_topology(SimpleNamespace(
                    area=h.area, adj_dbs=gen.adj_dbs, prefix_dbs=gen.prefix_dbs),
                    LinkState, PrefixState)
                root = h.my_node
                want = SpfSolver(root, backend="host", device=dev).build_route_db(
                    root, {h.area: ls}, ps)
                got = h.live_route_db().to_route_db(root)
                dijkstra = carry.route_db_to_plain(got) == carry.route_db_to_plain(
                    want.to_route_db(root))
                if not dijkstra:
                    raise AssertionError(f"{phase}: the live route database differs from "
                                         "the host Dijkstra solver's")
        finally:
            h.stop()
        launches = dict(LAUNCHES)
        counters = {k: reg.counter_get(k) - c0.get(k, 0) for k in fallbacks + (
            "decision.ell_full_compiles", "decision.ell_patches", "decision.ell_prewarms",
            "decision.sp_route_reuses", "decision.admission.sheds",
            "decision.coalesced_publications", "telemetry.traces_finished")}
        emit({
            "phase": phase, "nodes": len(h.topo.adj_dbs), "root": h.my_node,
            "seed": PIPELINE_SEED, "debounce_max_s": PIPELINE_DEBOUNCE_MAX_S,
            "admission": PIPELINE_ADMISSION, "pipelined_emit": True, "window_s": window_s,
            "kernel": kernel, "initial": initial, "windows": windows,
            "profiled_window": profile, "search": found,
            "parity_with_oracle_replay": parity, "oracle_launches": oracle_launches,
            "parity_with_host_dijkstra": dijkstra, "journal": len(h._journal),
            "counters": counters, "launches": launches,
            "seconds": time.perf_counter() - t0,
        })
        return launches

    small = pipeline_drive(f"pipeline-{dense_label}", dense_nodes, dense_rates, search)
    large = pipeline_drive(f"pipeline-{sparse_label}", sparse_nodes, sparse_rates, None)
    return small, large


def pipeline_process(start: float):
    """``pipeline_phases`` at full size on the card, in a process that
    holds only the route plane (as a daemon's does): the other phases
    keep six copies of the two networks alive, a full garbage
    collection's pause grows with the heap, and their profiler sessions
    stay apart from this one. ``start`` is the script's ``_START``, so
    ``t_s`` counts from the script's start here too."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    import torch

    from openr_tpu_torch.kernels import _build

    _build.library()
    phases = pipeline_phases(torch.device("cuda"), DENSE_NODES, SPARSE_NODES,
                             PIPELINE_DENSE_RATES, PIPELINE_SPARSE_RATES, PIPELINE_WINDOW_S,
                             PIPELINE_SEARCH)
    emit({"phase": "profiler", "process": "pipeline", **profiler_summary()})
    return phases


class DaemonFabric:
    """Whole daemons (``OpenrNode``: Spark, LinkMonitor, KvStore,
    PrefixManager, Decision, Fib, Monitor) wired as a fat tree over one
    ``MockIoProvider``, one daemon a switch, named ``FABRIC_PREFIX`` and
    the switch's name, each advertising the loopback ``fd01:<i>::1/128``.
    ``m`` names the package's pieces (``port_modules``), so a test can
    drive the reference's daemons through the same steps. Every wait is
    bounded; ``stop`` stops every daemon that started and the provider."""

    def __init__(self, m, fabric, spark, node_kwargs, step_s=FABRIC_STEP_S):
        self.m = m
        # the longest a read may wait for a module's thread: while 24
        # Decisions decode a flooded LSDB under one interpreter lock, one
        # callback can hold its thread for tens of seconds
        self.step_s = step_s
        topo = m.topologies.fat_tree(**fabric)
        self.switches = sorted(topo.adj_dbs)
        self.names = [FABRIC_PREFIX + s for s in self.switches]
        self.links = sorted({tuple(sorted((a, adj.other_node_name)))
                             for a, db in topo.adj_dbs.items() for adj in db.adjacencies})
        self.io = m.MockIoProvider()
        registry = {}
        self.nodes = {
            name: m.OpenrNode(name, self.io, node_registry=registry, v6_addr=f"fe80::{i + 1}",
                              spark_config=spark, **node_kwargs)
            for i, name in enumerate(self.names)
        }
        self.loopbacks = {name: m.IpPrefix.from_str(f"fd01:{i}::1/128")
                          for i, name in enumerate(self.names)}
        self._started = []

    @staticmethod
    def iface(a: str, b: str) -> str:
        return f"if_{a}_{b}"

    def start(self) -> None:
        for node in self.nodes.values():
            node.start()
            self._started.append(node)
        for a, b in self.links:
            self.io.connect_pair(self.iface(a, b), self.iface(b, a), 1)
            self.nodes[FABRIC_PREFIX + a].add_interface(self.iface(a, b))
            self.nodes[FABRIC_PREFIX + b].add_interface(self.iface(b, a))
        for name, node in self.nodes.items():
            node.advertise_loopback(self.loopbacks[name].to_str())

    def stop(self) -> None:
        for node in reversed(self._started):
            node.stop()
        self._started = []
        self.io.stop()

    def cut(self, a: str, b: str) -> None:
        """Drop every packet both ways over the link between switches
        ``a`` and ``b``."""
        self.io.partition(self.iface(a, b))
        self.io.partition(self.iface(b, a))

    # -- reads, each on the module's own thread --------------------------------

    def on_decision(self, name, fn):
        dec = self.nodes[name].decision
        return dec.evb.call_and_wait(lambda: fn(dec), timeout=self.step_s)

    def has_loopbacks(self, name) -> bool:
        have = {r.dest for r in self.nodes[name].get_fib_routes().unicast_routes}
        return all(p in have for n, p in self.loopbacks.items() if n != name)

    def oracle(self, name):
        """The host oracle's route database over the daemon's own
        link-state and prefix state (launch-free), as a plain tuple."""
        def build(dec):
            db = self.m.oracle(name).build_route_db(name, dec.area_link_states, dec.prefix_state)
            return self.m.route_db_to_plain(
                (db if db is not None else self.m.DecisionRouteDb()).to_route_db(name))
        return self.on_decision(name, build)

    def foreign_routes(self) -> int:
        """Fib routes, over all daemons, to anything but a daemon's
        loopback."""
        own = set(self.loopbacks.values())
        return sum(r.dest not in own for node in self.nodes.values()
                   for r in node.get_fib_routes().unicast_routes)

    def fib(self, name):
        return self.m.route_db_to_plain(self.nodes[name].get_fib_routes())

    def neighbors_lost(self) -> int:
        return sum(n.spark.counters["spark.neighbor_down"] for n in self.nodes.values())

    # -- waits -----------------------------------------------------------------

    def wait(self, names, pred, timeout_s):
        """Poll ``pred(name)`` for each of ``names`` until all hold; the
        names that never did by ``timeout_s``."""
        pending = list(names)
        deadline = time.monotonic() + timeout_s
        while pending:
            pending = [n for n in pending if not pred(n)]
            if not pending or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        return pending

    def wait_decisions(self, pred, timeout_s):
        """Until every daemon's Decision holds ``pred`` (on its own
        thread) with nothing left to do: its reader empty, no debounce
        armed, no route update pending."""
        def settled(name):
            return self.on_decision(name, lambda d: bool(pred(d)) and d._kv_reader.size() == 0
                                    and not d._rebuild_debounced.is_scheduled()
                                    and not d.pending.needs_route_update())
        return self.wait(self.names, settled, timeout_s)

    def check_oracle(self, step, timeout_s):
        """Every daemon's Fib equals its host oracle (waited for: Fib
        follows Decision); returns the oracle databases and the ms spent
        building them."""
        t0 = time.perf_counter()
        want = {n: self.oracle(n) for n in self.names}
        build_ms = (time.perf_counter() - t0) * 1e3
        late = self.wait(self.names, lambda n: self.fib(n) == want[n], timeout_s)
        if late:
            raise AssertionError(f"daemon-fabric: after {step} the Fib of {late} differs "
                                 "from the host oracle")
        return want, build_ms


def deployed_spark_config() -> dict:
    """Spark's settings as the daemon's process entry point derives them
    from the configuration's defaults (``config.SparkConfig``, the
    reference Open/R's: fast-init hellos and handshakes every 0.5 s,
    hellos every 20 s, a keepalive every 2 s, a 10 s hold, 30 s graceful
    restart). ``Spark``'s own defaults are a test's: 25 packets a second
    an interface, which one simulated LAN cannot carry for 96 interfaces
    (its delivery fell seconds behind with the fabric idle)."""
    from openr_tpu_torch.config.config import SparkConfig

    c = SparkConfig()
    return {"hello_interval_s": c.hello_time_s,
            "fast_hello_interval_s": c.fastinit_hello_time_ms / 1000,
            "handshake_interval_s": c.handshake_time_ms / 1000,
            "heartbeat_interval_s": c.keepalive_time_s, "hold_time_s": c.hold_time_s,
            "graceful_restart_time_s": c.graceful_restart_time_s}


def port_modules(dev):
    """The port's pieces a ``DaemonFabric`` drives, Decision on ``dev``."""
    from openr_tpu_torch import carry
    from openr_tpu_torch.daemon import OpenrNode
    from openr_tpu_torch.decision.rib import DecisionRouteDb
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.load.generator import LoadGenerator
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.spark.io_provider import MockIoProvider
    from openr_tpu_torch.types import (TTL_INFINITY, AdjacencyDatabase, IpPrefix, KeySetParams,
                                       PrefixDatabase, Value)
    from openr_tpu_torch.utils import wire

    return SimpleNamespace(
        OpenrNode=OpenrNode, MockIoProvider=MockIoProvider, topologies=topologies,
        LoadGenerator=LoadGenerator, TTL_INFINITY=TTL_INFINITY, AdjacencyDatabase=AdjacencyDatabase,
        IpPrefix=IpPrefix, KeySetParams=KeySetParams, PrefixDatabase=PrefixDatabase, Value=Value,
        wire=wire, DecisionRouteDb=DecisionRouteDb, route_db_to_plain=carry.route_db_to_plain,
        oracle=lambda name: SpfSolver(name, backend="host", device="cpu"),
        node_kwargs={"device": dev})


def daemon_fabric_phase(m, fabric, lsdb_nodes, events, spark, cut, step_s=FABRIC_STEP_S):
    """``daemon-fabric``: a ``DaemonFabric`` over ``m`` brought up, then
    flooded with the generator's LSDB of ``fat_tree_nodes(lsdb_nodes)``
    (seed ``PIPELINE_SEED``) set at ``FABRIC_INJECT``'s KvStore, then
    ``events`` of its events one at a time, then the link ``cut`` (two
    switch names) partitioned both ways. After each step every daemon's
    Fib must equal its host oracle, and no neighbour may be lost but by
    the cut. Emits the phase line and returns it with the daemons'
    route databases after each step (``fibs``) and the kernel launches."""
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.telemetry import get_registry

    import torch

    dev = m.node_kwargs.get("device")
    on_card = dev is not None and torch.device(dev).type == "cuda"
    reg = get_registry()
    fallbacks = ("decision.fallbacks", "decision.spf_host_fallback",
                 "decision.degradations", "decision.ladder_exhausted")
    gc_clock = GcClock()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    f0 = {k: reg.counter_get(k) for k in fallbacks}
    t_phase = time.perf_counter()
    fabric_ = DaemonFabric(m, fabric, spark, m.node_kwargs, step_s)
    hold_s = spark["hold_time_s"]
    names = fabric_.names
    inject = fabric_.nodes[FABRIC_INJECT].kvstore
    phase = "daemon-fabric"
    fibs = {}

    def launched_since(before):
        return {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] > before[k]}

    def oracle_step(step):
        """The Fib check after ``step``: the ms building the oracles."""
        l0 = dict(LAUNCHES)
        fibs[step], build_ms = fabric_.check_oracle(step, step_s)
        moved = {k: LAUNCHES[k] - l0[k] for k in LAUNCHES if LAUNCHES[k] != l0[k]}
        if moved:
            raise AssertionError(f"{phase}: the host oracle of {step} launched {moved}")
        return build_ms

    def progress(step, **fields):
        print(json.dumps({"daemon_fabric_step": step, "t_s": time.perf_counter() - t_phase,
                          **fields}), file=sys.stderr, flush=True)

    def lost(step, want):
        if fabric_.neighbors_lost() != want:
            raise AssertionError(f"{phase}: {fabric_.neighbors_lost()} neighbours lost after "
                                 f"{step}, {want} expected")

    try:
        # 1. bring-up: every Fib holds every other daemon's loopback
        l0, g0 = dict(LAUNCHES), gc_clock.read()
        t0 = time.perf_counter()
        fabric_.start()
        late = fabric_.wait(names, fabric_.has_loopbacks, step_s)
        if late:
            raise AssertionError(f"{phase}: bring-up: {late} lack loopback routes")
        bringup_s = time.perf_counter() - t0
        bringup = {"seconds": bringup_s, "oracle_ms": oracle_step("bring-up"),
                   "routes": len(fibs["bring-up"][names[0]][1]), "launches": launched_since(l0),
                   "gc_ms": gc_clock.read()[0] - g0[0], "threads": threading.active_count()}
        lost("bring-up", 0)
        progress("bring-up", seconds=bringup_s)

        # 2. the flood: the generator's LSDB set at one daemon's KvStore
        topo = m.topologies.fat_tree_nodes(lsdb_nodes)
        gen = m.LoadGenerator(topo, seed=PIPELINE_SEED)
        kvs = gen.initial_key_vals()
        n_nodes = len(topo.adj_dbs) + len(names)
        n_prefixes = len({e.prefix for db in topo.prefix_dbs.values()
                          for e in db.prefix_entries}) + len(names)
        runs0 = {n: fabric_.on_decision(n, lambda d: d.counters["decision.route_build_runs"])
                 for n in names}
        l0, g0 = dict(LAUNCHES), gc_clock.read()
        t0 = time.perf_counter()
        inject.set_key_vals("0", m.KeySetParams(key_vals=kvs))
        late = fabric_.wait_decisions(
            lambda d: len(d.area_link_states["0"].get_adjacency_databases()) == n_nodes
            and len(d.prefix_state.prefixes()) == n_prefixes
            and d.counters["decision.route_build_runs"] > runs0[d.my_node_name], step_s)
        if late:
            raise AssertionError(f"{phase}: flood: {late} did not take the LSDB in")
        flood_s = time.perf_counter() - t0
        flood = {"seconds": flood_s, "keys": len(kvs), "nodes": n_nodes,
                 "prefixes": n_prefixes, "oracle_ms": oracle_step("flood"),
                 "routes": len(fibs["flood"][names[0]][1]),
                 "launches": launched_since(l0),
                 "gc_ms": gc_clock.read()[0] - g0[0]}
        lost("flood", 0)
        # the generated block is a component apart: its prefixes get no route
        foreign = fabric_.foreign_routes()
        if foreign:
            raise AssertionError(f"{phase}: {foreign} Fib routes lead into the generated block")
        progress("flood", seconds=flood_s)

        # 3. events, one at a time, each until every Decision holds it
        def holds(ev):
            if ev.key.startswith("adj:"):
                want = m.wire.loads(ev.payload, m.AdjacencyDatabase)
                return lambda d: d.area_link_states["0"].get_adjacency_databases().get(
                    ev.node) == want
            want = {e.prefix for e in m.wire.loads(ev.payload, m.PrefixDatabase).prefix_entries}
            return lambda d: {p for p, entries in d.prefix_state.prefixes().items()
                              if (ev.node, "0") in entries} == want

        event_rows = []
        for step in range(events):
            ev = gen.next_event()
            value = m.Value(version=ev.version, originator_id=ev.node, value=ev.payload,
                            ttl=m.TTL_INFINITY,
                            hash=m.wire.generate_hash(ev.version, ev.node, ev.payload))
            l0, g0 = dict(LAUNCHES), gc_clock.read()
            t0 = time.perf_counter()
            inject.set_key_vals("0", m.KeySetParams(key_vals={ev.key: value}))
            late = fabric_.wait_decisions(holds(ev), step_s)
            if late:
                raise AssertionError(f"{phase}: event {step} ({ev.kind} {ev.key}) never "
                                     f"reached the Decision of {late}")
            event_ms = (time.perf_counter() - t0) * 1e3
            event_rows.append({
                "kind": ev.kind, "key": ev.key, "event_ms": event_ms,
                "oracle_ms": oracle_step(f"event {step}"),
                "launches": launched_since(l0),
                "gc_ms": gc_clock.read()[0] - g0[0]})
            lost(f"event {step}", 0)
            progress(f"event {step}", ms=event_ms)

        # 4. the cut: one rack uplink partitioned both ways
        a, b = (FABRIC_PREFIX + s for s in cut)

        def link_gone(d):
            dbs = d.area_link_states["0"].get_adjacency_databases()
            return not any(adj.other_node_name == y for x, y in ((a, b), (b, a))
                           for adj in dbs[x].adjacencies)

        before = fibs[f"event {events - 1}" if events else "flood"]
        l0, g0 = dict(LAUNCHES), gc_clock.read()
        t0 = time.perf_counter()
        fabric_.cut(*cut)
        late = fabric_.wait([a, b], lambda n: fabric_.nodes[n].spark.counters[
            "spark.neighbor_down"] > 0, hold_s + step_s)
        if late:
            raise AssertionError(f"{phase}: the cut: {late} never lost the neighbour")
        detect_ms = (time.perf_counter() - t0) * 1e3
        late = fabric_.wait_decisions(link_gone, step_s)
        if late:
            raise AssertionError(f"{phase}: the cut never reached the Decision of {late}")
        # until every Fib equals its oracle, the oracles' own build left out
        oracle_ms = oracle_step("the cut")
        reroute_ms = (time.perf_counter() - t0) * 1e3 - oracle_ms
        affected = sorted(n for n in names if fibs["the cut"][n] != before[n])
        reroute = {"cut": [a, b], "detect_ms": detect_ms, "reroute_ms": reroute_ms,
                   "oracle_ms": oracle_ms, "affected": len(affected),
                   "launches": launched_since(l0),
                   "gc_ms": gc_clock.read()[0] - g0[0]}
        lost("the cut", 2)
        if not affected:
            raise AssertionError(f"{phase}: the cut changed no daemon's routes")

        moved = {k: reg.counter_get(k) - f0[k] for k in fallbacks if reg.counter_get(k) != f0[k]}
        if moved:
            raise AssertionError(f"{phase}: fallback counters moved: {moved}")
        launches = dict(LAUNCHES)
        if on_card and not launches["minplus"]:
            raise AssertionError(f"{phase}: the daemons' Decisions launched no minplus")
        # each Decision's solver stages its uploads through one pinned buffer
        pinned = sum(
            n.decision.spf_solver._snapshots.stager._buf.numel() * 4
            for n in fabric_.nodes.values()
            if n.decision.spf_solver._snapshots.stager._buf is not None) if on_card else None
        threads = threading.active_count()
        neighbors_lost = fabric_.neighbors_lost()
    finally:
        fabric_.stop()
    times = [r["event_ms"] for r in event_rows]
    line = {
        "phase": phase, "daemons": len(names), "links": len(fabric_.links),
        "fabric": fabric, "spark": spark, "lsdb_nodes": n_nodes,
        "seed": PIPELINE_SEED, "inject": FABRIC_INJECT,
        "bringup_s": bringup_s, "bringup": bringup, "flood_s": flood_s, "flood": flood,
        "event_ms": {"p50": statistics.median(times) if times else None,
                     "max": max(times) if times else None},
        "events": event_rows, "reroute_ms": reroute_ms, "reroute": reroute,
        "parity_with_host_oracle": True, "neighbors_lost": neighbors_lost,
        "generated_prefixes_routed": foreign, "launches": launches, "threads": threads,
        "gc_ms": gc_clock.read()[0], "gc_full_collections": gc_clock.read()[1],
        "pinned_bytes": pinned,
        "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
        "fallbacks": {k: reg.counter_get(k) - f0[k] for k in fallbacks},
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "seconds": time.perf_counter() - t_phase,
    }
    gc.callbacks.remove(gc_clock._note)
    emit(line)
    return line, fibs, launches


def daemon_fabric_process(start: float):
    """``daemon_fabric_phase`` at full size with Decision on the card, in
    a process of its own (the 24 daemons' threads and heaps stay apart
    from the other phases'); ``start`` is the script's ``_START``.
    Returns the phase's kernel launches."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    import torch

    from openr_tpu_torch.kernels import _build

    _build.library()
    print(nvidia_smi_line(), flush=True)
    _, _, launches = daemon_fabric_phase(port_modules(torch.device("cuda")), FABRIC,
                                         FABRIC_LSDB_NODES, FABRIC_EVENTS, deployed_spark_config(),
                                         FABRIC_CUT)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random kernel inputs")
    args = ap.parse_args(argv)

    if not (ROOT / "openr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    # the profiler keeps CUPTI set up between sessions (this process's and,
    # through the environment, its spawned phases'): by default each session
    # tears CUPTI down and the next sets it up again, and sessions came back
    # short of kernel records, some three and six times in a row
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import ksp2_engine
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import (
        SPARSE_NODE_THRESHOLD,
        SPF_COUNTERS,
        SpfSolver,
        _ksp2_chunk,
        get_spf_counters,
    )
    from openr_tpu_torch.graph import native_spf
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.graph.snapshot import SnapshotCache
    from openr_tpu_torch.kernels import LAUNCHES, _build, reset_launches
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import spf as spf_ops
    from openr_tpu_torch.ops import route_sweep, spf_grouped, spf_sparse
    from openr_tpu_torch.ops.ell_relax import (
        ell_band_relax,
        ell_band_relax_masked,
        ell_band_relax_masked_plain,
        ell_band_relax_plain,
        mask_words,
        masked_plan,
        pack_edge_mask,
    )
    from openr_tpu_torch.ops.ell_relax import launch_plan as ell_launch_plan
    from openr_tpu_torch.ops.grouped_minplus import (
        batched_minplus,
        batched_minplus_plain,
        batched_minplus_t,
        batched_minplus_t_plain,
        minplus_plan,
        minplus_t_plan,
    )
    from openr_tpu_torch.ops.minplus import INF, minplus, minplus_plain
    from openr_tpu_torch.ops.minplus import minplus_plan as dense_plan
    from openr_tpu_torch.ops.rev_relax import launch_plan as rev_launch_plan
    from openr_tpu_torch.ops.rev_relax import rev_band_relax, rev_band_relax_plain
    from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm

    KSP2_ED_ECMP = PrefixForwardingAlgorithm.KSP2_ED_ECMP

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    gc_clock = GcClock()

    # -- 0. environment ----------------------------------------------------
    smi = nvidia_smi_line()
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc_version, "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
    })
    print(smi, flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.monotonic()
    _build.build(force=True)
    ptxas = [
        line.strip() for line in str(_build.BUILD_INFO["log"]).splitlines()
        if "registers" in line or "Compiling entry" in line
    ]
    _build.library()
    nvcc_s = time.monotonic() - t0
    native_spf.build(force=True)
    native_build = dict(native_spf.BUILD_INFO)
    native_spf.library()
    emit({"phase": "build", "seconds": time.monotonic() - t0, "nvcc_seconds": nvcc_s,
          "sources": [p.name for p in _build.sources()], "ptxas": ptxas,
          "native": {"source": str(native_spf.SRC.relative_to(ROOT)),
                     "library": str((native_spf.BUILD_DIR / native_spf.LIB_NAME).relative_to(ROOT)),
                     "seconds": native_build["seconds"], "compiled": native_build["compiled"],
                     "compiler": native_spf.compiler_version()}})

    # -- 2. networks -----------------------------------------------------------
    t0 = time.monotonic()
    dense_ls, dense_ps = load_network(topologies, LinkState, PrefixState, DENSE_NODES)
    sparse_ls, sparse_ps = load_network(topologies, LinkState, PrefixState, SPARSE_NODES)
    # the KSP2 cells, each twice: the device solver's copy and the host
    # oracle's own
    ksp2_dense = [load_ksp2_network(topologies, LinkState, PrefixState, DENSE_NODES)
                  for _ in range(2)]
    ksp2_sparse = [load_ksp2_network(topologies, LinkState, PrefixState, SPARSE_NODES,
                                     KSP2_SAMPLED_DSTS) for _ in range(2)]
    ksp2_dense_chunked = [load_ksp2_network(topologies, LinkState, PrefixState, DENSE_NODES)
                          for _ in range(2)]
    n_dense = len(dense_ls.get_adjacency_databases())
    n_sparse = len(sparse_ls.get_adjacency_databases())
    if not n_dense <= SPARSE_NODE_THRESHOLD < n_sparse:
        raise RuntimeError(f"{n_dense}/{n_sparse} nodes do not straddle the "
                           f"{SPARSE_NODE_THRESHOLD}-node regime split")
    emit({"phase": "setup", "seconds": time.monotonic() - t0,
          "dense_nodes": n_dense, "sparse_nodes": n_sparse})
    root = "rsw-0-0"

    # -- 3. kernels against their plain versions -------------------------------
    max_err = {name: 0 for name in LAUNCHES}

    def compare(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{name} differs from its plain version at {what}")

    def rand_int(shape, inf_frac):
        a = rng.integers(0, 1000, shape).astype(np.int32)
        a[rng.random(shape) < inf_frac] = INF
        return torch.from_numpy(a).to(dev)

    # minplus at the dense main path's inputs: the root's batch rows and
    # the transit-masked metric matrix of the 1008-node fabric
    snaps = SnapshotCache(dev)
    snap = snaps.get(dense_ls)
    arrays = snap.device_arrays(dev)
    _, srcs = spf_ops.source_batch(snap, snap.id_of(root), dev)
    t_mat = spf_ops._mask_transit_rows(arrays.metric, arrays.overloaded)
    d_rows = spf_ops._initial_rows(arrays.metric, srcs)
    compare("minplus", minplus(d_rows, t_mat), minplus_plain(d_rows, t_mat),
            f"main path {tuple(d_rows.shape)}x{tuple(t_mat.shape)}")
    # ragged: S on and off the 8-row S-tile, N % 4 != 0 (scalar b loads),
    # K = 0, a thin grid with a long K (many K splits), S-tiles past one
    # grid.y sweep
    shapes = [(8, 1024, 1024), (5, 77, 300), (33, 129, 65), (1, 1, 1), (64, 1024, 1024),
              (16, 1024, 1024), (32, 1024, 1024), (8, 1000, 1001), (3, 0, 10),
              (1, 50_000, 7), (20, 4000, 40), (1024, 1024, 1024), (1_100_000, 2, 3)]
    for s, k, n in shapes:
        a, b = rand_int((s, k), 0.3), rand_int((k, n), 0.3)
        compare("minplus", minplus(a, b), minplus_plain(a, b), (s, k, n))

    def plan_fields(plan):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in plan._asdict().items()}

    def minplus_row(a):
        """Device ms, plain ms, bound and plan of ``minplus(a, t_mat)``: a
        split K adds the reduce kernel's record to each call."""
        s, k, n = a.shape[0], t_mat.shape[0], t_mat.shape[1]
        plan = dense_plan(s, k, n)
        bound, by = bound_ms(4 * (s * k + k * n + s * n), 2 * s * k * n)
        return {
            "shape": [[s, k], [k, n]], "plan": plan_fields(plan),
            "kernel_ms": device_ms(torch, lambda: minplus(a, t_mat), REPS,
                                   KERNEL_KEYS["minplus"],
                                   records=1 + (plan.splits > 1)),
            "plain_ms": device_ms(torch, lambda: minplus_plain(a, t_mat), REPS),
            "bound_ms": bound, "bound_by": by,
            "call_ms": time_ms(torch, lambda: minplus(a, t_mat), REPS),
            "plain_call_ms": time_ms(torch, lambda: minplus_plain(a, t_mat), REPS),
        }

    s_, k_, n_ = d_rows.shape[0], t_mat.shape[0], t_mat.shape[1]
    mp_row = minplus_row(d_rows)
    # a high-degree root's batch: 64 distance rows, random, over the same
    # metric matrix
    rows64 = rand_int((64, k_), 0.3)
    compare("minplus", minplus(rows64, t_mat), minplus_plain(rows64, t_mat),
            f"(64, {k_}) x {tuple(t_mat.shape)}")
    mp_row64 = minplus_row(rows64)
    mp_ms, mp_plain = mp_row["kernel_ms"], mp_row["plain_ms"]
    mp_call, mp_plain_call = mp_row["call_ms"], mp_row["plain_call_ms"]
    mp_bound, mp_by = mp_row["bound_ms"], mp_row["bound_by"]
    # the least time one launch of each route-build kernel can take at the
    # main path's shapes (its bytes over the card's memory rate): a
    # profiled build below launches x this missed device activity
    least_launch_ms = {"minplus": bound_ms(4 * (s_ * k_ + k_ * n_ + s_ * n_), 0)[0]}
    emit({"phase": "kernels", "kernel": "minplus", "match": True,
          "checked_shapes": [list(x) for x in shapes], **mp_row,
          "at_s64": mp_row64})

    # ell_band_relax at the sparse main path's bands: the 10 000-node
    # fabric's sliced-ELL graph, relaxing the root batch's first rows
    graph = spf_sparse.compile_ell(sparse_ls)
    ell_srcs = spf_sparse.ell_source_batch(graph, sparse_ls, root)
    src_t = tuple(torch.from_numpy(s).to(dev) for s in graph.src)
    w_t = tuple(torch.from_numpy(w).to(dev) for w in graph.w)
    ov = torch.from_numpy(graph.overloaded).to(dev)
    b = len(ell_srcs)
    unit = torch.full((b, graph.n_pad), INF, dtype=torch.int32, device=dev)
    unit[torch.arange(b, device=dev), torch.tensor(ell_srcs, device=dev).long()] = 0
    d_ell = spf_sparse._ell_relax(unit, graph.bands, src_t, w_t, torch.zeros_like(ov))
    band_rows = []
    pos = 0
    band_out = torch.empty_like(d_ell)
    for band, s_b, w_b in zip(graph.bands, src_t, w_t):
        compare("ell_band_relax", ell_band_relax(d_ell, s_b, w_b, ov, pos, band_out),
                ell_band_relax_plain(d_ell, s_b, w_b, ov, pos),
                f"band {band}")
        plan = ell_launch_plan(b, band.rows, band.k)
        band_rows.append({
            "rows": band.rows, "k": band.k,
            "plan": {"body": "wide" if plan.wide else "narrow",
                     "row_threads": plan.row_threads, "grid": list(plan.grid)},
            "kernel_ms": device_ms(
                torch, lambda: ell_band_relax(d_ell, s_b, w_b, ov, pos, band_out),
                REPS, KERNEL_KEYS["ell_band_relax"], records=1),
            "plain_ms": device_ms(
                torch, lambda: ell_band_relax_plain(d_ell, s_b, w_b, ov, pos),
                REPS),
            "call_ms": time_ms(
                torch, lambda: ell_band_relax(d_ell, s_b, w_b, ov, pos, band_out),
                REPS),
        })
        pos += band.rows
    # ragged: narrow bands, and wide ones (k from 33) with S of 1 to 300,
    # rows of one, a block's 16 and one past, k off the row's threads and
    # the unroll
    ell_ragged = [(3, 300, 50, 9), (8, 1000, 997, 8), (17, 256, 5, 200)] + [
        (s, rows + k + 37, rows, k) for k in (33, 64, 255, 256, 257, 1024, 1500)
        for s in (1, 8, 13, 300) for rows in (1, 16, 17)
    ]
    for s, n_pad, rows, k in ell_ragged:
        dd, ww = rand_int((s, n_pad), 0.3), rand_int((rows, k), 0.3)
        sb = torch.from_numpy(rng.integers(0, n_pad, (rows, k)).astype(np.int32)).to(dev)
        ovr = torch.from_numpy(rng.random(n_pad) < 0.2).to(dev)
        p = n_pad - rows
        for mask in (ovr, ovr.to(torch.int32)):
            out = torch.full_like(dd, -1)
            compare("ell_band_relax", ell_band_relax(dd, sb, ww, mask, p, out),
                    ell_band_relax_plain(dd, sb, ww, mask, p), (s, n_pad, rows, k))
            compare("ell_band_relax", out[:, :p], torch.full_like(dd[:, :p], -1),
                    f"columns outside the band at {(s, n_pad, rows, k)}")

    def relax_plain():
        out = torch.empty_like(d_ell)
        at = 0
        for band, s_b, w_b in zip(graph.bands, src_t, w_t):
            out[:, at : at + band.rows] = ell_band_relax_plain(d_ell, s_b, w_b, ov, at)
            at += band.rows
        return out

    def relax_kernel():
        out = torch.empty_like(d_ell)
        at = 0
        for band, s_b, w_b in zip(graph.bands, src_t, w_t):
            ell_band_relax(d_ell, s_b, w_b, ov, at, out=out)
            at += band.rows
        return out

    compare("ell_band_relax", relax_kernel()[:, : graph.n], relax_plain()[:, : graph.n],
            "one relax step over all bands")
    least_launch_ms["ell_band_relax"] = min(
        band_least_ms(b, bd.rows, bd.k) for bd in graph.bands)
    slots = sum(band.rows * band.k for band in graph.bands)
    ell_call = time_ms(torch, relax_kernel, REPS)
    ell_plain_call = time_ms(torch, relax_plain, REPS)
    ell_ms = device_ms(torch, relax_kernel, REPS, KERNEL_KEYS["ell_band_relax"],
                       parts_ms=sum(row["kernel_ms"] for row in band_rows),
                       records=len(graph.bands))
    ell_plain = device_ms(torch, relax_plain, REPS)
    # each input read once: distance rows, band slots (src + w), the
    # overload mask; each output written once: the band columns. One add
    # and one min per gathered slot and batch row.
    ell_bound, ell_by = bound_ms(
        4 * b * graph.n_pad + 8 * slots + graph.n_pad + 4 * b * graph.n,
        2 * b * slots,
    )
    emit({"phase": "kernels", "kernel": "ell_band_relax",
          "shape": {"S": b, "n_pad": graph.n_pad,
                    "bands": [[bd.rows, bd.k] for bd in graph.bands]},
          "match": True, "bands": band_rows,
          "checked_shapes": [list(x) for x in ell_ragged],
          "kernel_ms": ell_ms, "plain_ms": ell_plain, "bound_ms": ell_bound,
          "call_ms": ell_call, "plain_call_ms": ell_plain_call})

    # ell_band_relax at the KSP2 engine's all-sources shapes: S = n_pad
    # rows (every node a source) over the 1008-node fabric's in-bands and
    # over the 10 000-node one's, two relax hops from the unit rows. The
    # plain version's gather holds [S, rows, k] at once, so it is held
    # against the kernel on slices of ALL_SOURCES_SLICE rows (the first
    # and the last)
    all_sources_kernel = {}
    for label, g in (("1008", spf_sparse.compile_ell(ksp2_dense[0][0])), ("10k", graph)):
        s = g.n_pad
        g_src = tuple(torch.from_numpy(x).to(dev) for x in g.src)
        g_w = tuple(torch.from_numpy(x).to(dev) for x in g.w)
        g_ov = torch.from_numpy(rng.random(g.n_pad) < 0.05).to(dev)
        ids = torch.arange(s, device=dev)
        d_all = torch.full((s, g.n_pad), INF, dtype=torch.int32, device=dev)
        d_all[ids, ids] = 0
        for _ in range(2):
            d_all = spf_sparse._ell_relax(d_all, g.bands, g_src, g_w, torch.zeros_like(g_ov))
        out_all = torch.empty_like(d_all)
        slices = (slice(0, ALL_SOURCES_SLICE), slice(s - ALL_SOURCES_SLICE, s))

        def all_step(rows=slice(None)):
            dd = d_all[rows]
            out = out_all[: dd.shape[0]]
            at = 0
            for band, s_b, w_b in zip(g.bands, g_src, g_w):
                ell_band_relax(dd, s_b, w_b, g_ov, at, out=out)
                at += band.rows
            out[:, at:] = dd[:, at:]
            return out

        def all_step_plain(rows):
            dd = d_all[rows]
            out = torch.empty_like(dd)
            at = 0
            for band, s_b, w_b in zip(g.bands, g_src, g_w):
                out[:, at : at + band.rows] = ell_band_relax_plain(dd, s_b, w_b, g_ov, at)
                at += band.rows
            out[:, at:] = dd[:, at:]
            return out

        full = all_step().clone()
        for rows in slices:
            compare("ell_band_relax", full[rows], all_step_plain(rows),
                    f"all sources, {label}, rows {rows.start}:{rows.stop}")
        del full
        a_slots = sum(bd.rows * bd.k for bd in g.bands)
        a_bound, a_by = bound_ms(4 * s * g.n_pad + 8 * a_slots + g.n_pad + 4 * s * g.n,
                                 2 * s * a_slots)
        all_sources_kernel[label] = {
            "shape": {"S": s, "n_pad": g.n_pad, "bands": [[bd.rows, bd.k] for bd in g.bands]},
            "plans": [plan_fields(ell_launch_plan(s, bd.rows, bd.k)) for bd in g.bands],
            "kernel_ms": device_ms(torch, all_step, REPS, KERNEL_KEYS["ell_band_relax"],
                                   records=len(g.bands)),
            "call_ms": time_ms(torch, all_step, REPS),
            "slice_rows": ALL_SOURCES_SLICE,
            "kernel_slice_ms": device_ms(torch, lambda: all_step(slices[0]), REPS,
                                         KERNEL_KEYS["ell_band_relax"], records=len(g.bands)),
            "plain_slice_ms": device_ms(torch, lambda: all_step_plain(slices[0]), REPS),
            "bound_ms": a_bound, "bound_by": a_by,
        }
        emit({"phase": "kernels", "kernel": "ell_band_relax", "cell": f"ksp2-{label}",
              "at": "all sources", "match": True, **all_sources_kernel[label]})
        del d_all, out_all
    torch.cuda.empty_cache()

    # ell_band_relax_masked at the KSP2 cells' chunks: the in-bands of the
    # 1008-node fabric with S = 1024 destination rows and of the 10 000-node
    # one with S = 256 (_ksp2_chunk), distance rows two relax hops from the
    # root's unit rows, a random mask of about 5 % set bits (every 7th row
    # all set: that destination loses every edge) and a random overload mask
    masked_kernel = {}
    for label, ls in (("1008", ksp2_dense[0][0]), ("10k", sparse_ls)):
        g = spf_sparse.compile_ell(ls)
        s = _ksp2_chunk(g)
        g_src = tuple(torch.from_numpy(x).to(dev) for x in g.src)
        g_w = tuple(torch.from_numpy(x).to(dev) for x in g.w)
        no_ov = torch.zeros(g.n_pad, dtype=torch.bool, device=dev)
        dm = torch.full((s, g.n_pad), INF, dtype=torch.int32, device=dev)
        dm[:, g.node_index[root]] = 0
        for _ in range(2):
            dm = spf_sparse._ell_relax(dm, g.bands, g_src, g_w, no_ov)
        g_masks = []
        for band in g.bands:
            m = rng.random((s, band.rows, band.k)) < 0.05
            m[::7] = True
            # packed on the card: no large host temporaries
            g_masks.append(pack_edge_mask(torch.from_numpy(m).to(dev)))
        g_ov = torch.from_numpy(rng.random(g.n_pad) < 0.05).to(dev)
        m_rows = []
        pos = 0
        band_out = torch.empty_like(dm)
        for band, s_b, w_b, m_b in zip(g.bands, g_src, g_w, g_masks):
            want = ell_band_relax_masked_plain(dm, s_b, w_b, m_b, g_ov, pos)
            for ovm in (g_ov, g_ov.to(torch.int32)):
                compare("ell_band_relax_masked",
                        ell_band_relax_masked(dm, s_b, w_b, m_b, ovm, pos, band_out),
                        want, f"{label} band {band}")
            m_rows.append({
                "rows": band.rows, "k": band.k,
                "plan": plan_fields(masked_plan(s, band.rows, band.k)),
                "kernel_ms": device_ms(
                    torch, lambda: ell_band_relax_masked(dm, s_b, w_b, m_b, g_ov, pos,
                                                         band_out),
                    REPS, KERNEL_KEYS["ell_band_relax_masked"], records=1),
                "plain_ms": device_ms(
                    torch, lambda: ell_band_relax_masked_plain(dm, s_b, w_b, m_b, g_ov, pos),
                    REPS),
            })
            pos += band.rows

        def masked_step_kernel():
            return spf_sparse._ell_relax_masked(dm, g.bands, g_src, g_w, g_masks, g_ov)

        def masked_step_plain():
            out = torch.empty_like(dm)
            at = 0
            for band, s_b, w_b, m_b in zip(g.bands, g_src, g_w, g_masks):
                out[:, at : at + band.rows] = ell_band_relax_masked_plain(
                    dm, s_b, w_b, m_b, g_ov, at)
                at += band.rows
            out[:, at:] = dm[:, at:]
            return out

        compare("ell_band_relax_masked", masked_step_kernel(), masked_step_plain(),
                f"{label}: one masked relax step over all bands")
        least_launch_ms["ell_band_relax_masked"] = min(
            [band_least_ms(s, bd.rows, bd.k) for bd in g.bands]
            + [least_launch_ms.get("ell_band_relax_masked", float("inf"))])
        m_slots = sum(band.rows * band.k for band in g.bands)
        m_words = sum(mask_words(band.rows, band.k) for band in g.bands)
        # each input read once: the distance rows, the band slots (src + w),
        # the packed mask (a bit a slot and row, in int32 words), the
        # overload mask; each output written once: the band columns. One
        # add and one min a slot and row. The byte-mask bound counts a byte
        # a slot and row instead (the mask an earlier kernel read as bytes).
        rest = 4 * s * g.n_pad + 8 * m_slots + g.n_pad + 4 * s * g.n
        m_bound, m_by = bound_ms(rest + 4 * s * m_words, 2 * s * m_slots)
        m_bound_bytes, _ = bound_ms(rest + s * m_slots, 2 * s * m_slots)
        masked_kernel[label] = {
            "shape": {"S": s, "n_pad": g.n_pad, "bands": [[bd.rows, bd.k] for bd in g.bands]},
            "kernel_ms": device_ms(torch, masked_step_kernel, REPS,
                                   KERNEL_KEYS["ell_band_relax_masked"],
                                   parts_ms=sum(row["kernel_ms"] for row in m_rows),
                                   records=len(g.bands)),
            "plain_ms": device_ms(torch, masked_step_plain, REPS),
            "call_ms": time_ms(torch, masked_step_kernel, REPS),
            "plain_call_ms": time_ms(torch, masked_step_plain, REPS),
            "bound_ms": m_bound, "bound_by": m_by, "bound_bytemask_ms": m_bound_bytes,
            "bands": m_rows,
        }
    # ragged: S off 8, 32 and 128, rows below a block, k of 8, 9 and 24
    # (bits straddling words), 33, 64, 1024 and 3000 (two staged pieces a
    # row), all-set and all-clear masks, a mask off a 16-byte boundary
    masked_ragged = [(37, 300, 50, 8), (3, 256, 5, 9), (129, 700, 33, 64),
                     (13, 256, 200, 24), (2, 1100, 3, 1024), (1, 130, 2, 1024),
                     (5, 500, 7, 33), (9, 3100, 3, 3000)]
    for s, n_pad, rows, k in masked_ragged:
        dd, ww = rand_int((s, n_pad), 0.3), rand_int((rows, k), 0.3)
        sb = torch.from_numpy(rng.integers(0, n_pad, (rows, k)).astype(np.int32)).to(dev)
        ovr = torch.from_numpy(rng.random(n_pad) < 0.2).to(dev)
        p = n_pad - rows
        words = mask_words(rows, k)
        flat = torch.zeros(s * words + 1, dtype=torch.int32, device=dev)
        odd = flat[1:].view(s, words)
        odd.copy_(pack_edge_mask(torch.from_numpy(rng.random((s, rows, k)) < 0.05).to(dev)))
        for mask in (pack_edge_mask(torch.from_numpy(rng.random((s, rows, k)) < 0.05).to(dev)),
                     pack_edge_mask(torch.ones((s, rows, k), dtype=torch.bool, device=dev)),
                     pack_edge_mask(torch.zeros((s, rows, k), dtype=torch.bool, device=dev)),
                     odd):
            out = torch.full_like(dd, -1)
            compare("ell_band_relax_masked",
                    ell_band_relax_masked(dd, sb, ww, mask, ovr, p, out),
                    ell_band_relax_masked_plain(dd, sb, ww, mask, ovr, p), (s, n_pad, rows, k))
            compare("ell_band_relax_masked", out[:, :p], torch.full_like(dd[:, :p], -1),
                    f"columns outside the band at {(s, n_pad, rows, k)}")
    for label, row in masked_kernel.items():
        emit({"phase": "kernels", "kernel": "ell_band_relax_masked", "cell": f"ksp2-{label}",
              "match": True, "checked_shapes": [list(x) for x in masked_ragged], **row})

    # rev_band_relax at each route sweep's out-bands and block (the
    # 10 000-node fabric with 1024 destinations, the 1008-node one with
    # 256): the block of the first destinations, two relax hops from the
    # unit init (finite and INF distances mixed); then the same bands with
    # a random overload mask whose nodes some destinations hit
    sweep_cells = (("10k", sparse_ls, SPARSE_SWEEP_BLOCK),
                   ("1008", dense_ls, DENSE_SWEEP_BLOCK))
    rev_kernel = {}
    for label, ls, rb in sweep_cells:
        out_graph = route_sweep.compile_out_ell(ls)
        rv_t = tuple(torch.from_numpy(v).to(dev) for v in out_graph.src)
        rw_t = tuple(torch.from_numpy(w).to(dev) for w in out_graph.w)
        r_ov = torch.from_numpy(out_graph.overloaded).to(dev)
        t_blk = torch.arange(rb, dtype=torch.int32, device=dev)
        dr = torch.full((rb, out_graph.n_pad), INF, dtype=torch.int32, device=dev)
        dr[torch.arange(rb, device=dev), t_blk.long()] = 0
        for _ in range(2):
            dr = route_sweep._rev_relax(dr, out_graph.bands, rv_t, rw_t, r_ov, t_blk)
        ov_np = rng.random(out_graph.n_pad) < 0.05
        t_np = np.arange(rb, dtype=np.int32)
        t_np[::4] = rng.choice(np.flatnonzero(ov_np), size=t_np[::4].shape)
        masks = [(r_ov, t_blk),
                 (torch.from_numpy(ov_np).to(dev), torch.from_numpy(t_np).to(dev))]
        rev_rows = []
        pos = 0
        band_out = torch.empty_like(dr)
        for band, v_b, w_b in zip(out_graph.bands, rv_t, rw_t):
            for ovm, tt in masks:
                compare("rev_band_relax",
                        rev_band_relax(dr, v_b, w_b, tt, ovm, pos, band_out),
                        rev_band_relax_plain(dr, v_b, w_b, tt, ovm, pos),
                        f"sweep-{label} out-band {band}")
            plan = rev_launch_plan(rb, band.rows, band.k)
            rev_rows.append({
                "rows": band.rows, "k": band.k,
                "plan": {"body": "wide" if plan.wide else "narrow",
                         "chunk": plan.chunk, "grid": list(plan.grid)},
                "kernel_ms": device_ms(
                    torch, lambda: rev_band_relax(dr, v_b, w_b, t_blk, r_ov, pos, band_out),
                    REPS, KERNEL_KEYS["rev_band_relax"], records=1),
                "plain_ms": device_ms(
                    torch, lambda: rev_band_relax_plain(dr, v_b, w_b, t_blk, r_ov, pos),
                    REPS),
            })
            pos += band.rows

        def rev_step_plain():
            out = torch.empty_like(dr)
            at = 0
            for band, v_b, w_b in zip(out_graph.bands, rv_t, rw_t):
                out[:, at : at + band.rows] = rev_band_relax_plain(dr, v_b, w_b, t_blk, r_ov, at)
                at += band.rows
            out[:, at:] = dr[:, at:]
            return out

        def rev_step_kernel():
            return route_sweep._rev_relax(dr, out_graph.bands, rv_t, rw_t, r_ov, t_blk)

        compare("rev_band_relax", rev_step_kernel(), rev_step_plain(),
                f"sweep-{label}: one reversed relax step over all out-bands")
        rslots = sum(band.rows * band.k for band in out_graph.bands)
        # each input read once: the destination rows, the band slots (v + w),
        # the overload mask, the destination ids; each output written once:
        # the band columns. One add and one min per gathered slot and row.
        rev_bound, rev_by = bound_ms(
            4 * rb * out_graph.n_pad + 8 * rslots + out_graph.n_pad + 4 * rb
            + 4 * rb * out_graph.n,
            2 * rb * rslots,
        )
        rev_kernel[label] = {
            "shape": {"B": rb, "n_pad": out_graph.n_pad,
                      "bands": [[bd.rows, bd.k] for bd in out_graph.bands]},
            "bands": rev_rows,
            "kernel_ms": device_ms(torch, rev_step_kernel, REPS, KERNEL_KEYS["rev_band_relax"],
                                   parts_ms=sum(row["kernel_ms"] for row in rev_rows),
                                   records=len(out_graph.bands)),
            "plain_ms": device_ms(torch, rev_step_plain, REPS),
            "call_ms": time_ms(torch, rev_step_kernel, REPS),
            "plain_call_ms": time_ms(torch, rev_step_plain, REPS),
            "bound_ms": rev_bound, "bound_by": rev_by,
        }
    # ragged: B = 1, B off the destination run, rows below a block, k of 1
    # and slots staged as 8, 16 and 32, wide bands from 33 slots; half the
    # destinations overloaded nodes, half overloaded nodes that the band's
    # slots stage (the v == t exception)
    rev_ragged = [(3, 300, 50, 9), (37, 1000, 997, 8), (17, 256, 5, 200),
                  (5, 700, 33, 64), (1, 300, 50, 9), (1001, 1200, 300, 8),
                  (37, 256, 5, 1), (300, 2000, 1300, 17), (300, 2000, 1300, 40)]
    for b_, n_pad, rows, k in rev_ragged:
        dd, ww = rand_int((b_, n_pad), 0.3), rand_int((rows, k), 0.3)
        vb_np = rng.integers(0, n_pad, (rows, k)).astype(np.int32)
        vb = torch.from_numpy(vb_np).to(dev)
        ovn = rng.random(n_pad) < 0.2
        tn = rng.integers(0, n_pad, b_).astype(np.int32)
        tn[::2] = rng.choice(np.flatnonzero(ovn), size=tn[::2].shape)
        staged = np.unique(vb_np[ovn[vb_np]])
        if staged.size:
            tn[1::2] = rng.choice(staged, size=tn[1::2].shape)
        tt = torch.from_numpy(tn).to(dev)
        ovr = torch.from_numpy(ovn).to(dev)
        p = n_pad - rows
        for mask in (ovr, ovr.to(torch.int32)):
            out = torch.full_like(dd, -1)
            compare("rev_band_relax", rev_band_relax(dd, vb, ww, tt, mask, p, out),
                    rev_band_relax_plain(dd, vb, ww, tt, mask, p), (b_, n_pad, rows, k))
            compare("rev_band_relax", out[:, :p], torch.full_like(dd[:, :p], -1),
                    f"columns outside the band at {(b_, n_pad, rows, k)}")
    for label, row in rev_kernel.items():
        emit({"phase": "kernels", "kernel": "rev_band_relax", "cell": f"sweep-{label}",
              "match": True, "checked_shapes": [list(x) for x in rev_ragged], **row})

    # batched_minplus(_t) at each grouped sweep's segments and block: the
    # masked source tables of the block's destinations, two grouped relax
    # hops from the unit init, in each kernel's layout
    grouped_ops = {
        "batched_minplus": (batched_minplus, batched_minplus_plain, 0,
                            KERNEL_KEYS["batched_minplus"]),
        "batched_minplus_t": (batched_minplus_t, batched_minplus_t_plain, 1,
                              KERNEL_KEYS["batched_minplus_t"]),
    }
    grouped_kernel = {name: {} for name in grouped_ops}
    for label, ls, rb in sweep_cells:
        grp_graph = spf_grouped.compile_out_grouped(ls)
        g_meta = spf_grouped.band_meta(grp_graph)
        g_src, g_w = spf_grouped.device_tensors(grp_graph, dev)
        g_ov = torch.from_numpy(grp_graph.overloaded).to(dev)
        t_blk = torch.arange(rb, dtype=torch.int32, device=dev)
        dg = torch.full((rb, grp_graph.n_pad), INF, dtype=torch.int32, device=dev)
        dg[torch.arange(rb, device=dev), t_blk.long()] = 0
        for _ in range(2):
            dg = spf_grouped._grouped_relax(
                dg, g_meta, g_src, g_w, g_ov, t_blk, spf_grouped.IMPLS[0]
            )
        segs = []
        for src, w in zip(g_src, g_w):
            idx = src.long()
            blocked = g_ov[idx][None] & (src[None] != t_blk[:, None, None])
            gath = dg[:, idx].masked_fill(blocked, INF)  # [B, G, S]
            segs.append((gath.permute(1, 0, 2).contiguous(),
                         gath.permute(1, 2, 0).contiguous(), w))
        grouped_shapes = [[int(w.shape[0]), rb, int(w.shape[1]), int(w.shape[2])]
                          for _, _, w in segs]
        g_bytes = sum(4 * (g_ * b_ * s_g + g_ * s_g * r_ + g_ * b_ * r_)
                      for g_, b_, s_g, r_ in grouped_shapes)
        g_ops = sum(2 * g_ * b_ * s_g * r_ for g_, b_, s_g, r_ in grouped_shapes)
        grp_bound, grp_by = bound_ms(g_bytes, g_ops)
        for name, (kern, plain, layout, key) in grouped_ops.items():
            seg_rows = []
            for seg, shape in zip(segs, grouped_shapes):
                compare(name, kern(seg[layout], seg[2]), plain(seg[layout], seg[2]),
                        f"sweep-{label} segment {shape}")
                row = {"shape": shape}
                plan = (minplus_t_plan if layout else minplus_plan)(*shape)
                row["plan"] = {k: list(v) if k == "grid" else v
                               for k, v in plan._asdict().items() if k != "scratch_shape"}
                # a split S adds the reduce kernel's record
                row["records"] = 1 + (plan.splits > 1)
                row["kernel_ms"] = device_ms(
                    torch, lambda seg=seg: kern(seg[layout], seg[2]), REPS, key,
                    records=row["records"])
                seg_rows.append(row)

            def step_kernel(kern=kern, layout=layout):
                return [kern(seg[layout], seg[2]) for seg in segs]

            def step_plain(plain=plain, layout=layout):
                return [plain(seg[layout], seg[2]) for seg in segs]

            grouped_kernel[name][label] = {
                "shape": {"segments_GBSR": grouped_shapes},
                "segments": seg_rows,
                "kernel_ms": device_ms(torch, step_kernel, REPS, key,
                                       parts_ms=sum(row["kernel_ms"] for row in seg_rows),
                                       records=sum(row["records"] for row in seg_rows)),
                "plain_ms": device_ms(torch, step_plain, REPS),
                "call_ms": time_ms(torch, step_kernel, REPS),
                "plain_call_ms": time_ms(torch, step_plain, REPS),
                "bound_ms": grp_bound, "bound_by": grp_by,
            }
    # ragged: S past the Pallas s-block cap of 512, S split on and off, R
    # past one R-tile, B off 32, single elements
    grouped_ragged = [(3, 5, 7, 9), (7, 19, 3, 1), (2, 8, 600, 3), (3, 9, 1030, 5),
                      (50, 300, 13, 6), (3, 33, 1030, 20), (4, 100, 700, 40),
                      (1, 1, 1, 1), (5, 70, 64, 17), (2, 1000, 3, 100)]
    # and for batched_minplus: G of 1 to 4, S up to 2000, R from 1 to 700
    # and B from 1 to 1100, which take both bodies with and without a split
    # S; an operand off a 16-byte boundary (scalar loads)
    grouped_ragged_rows = grouped_ragged + [
        (1 + i % 4, b_, (3, 8, 624, 2000)[i % 4], r_)
        for i, (r_, b_) in enumerate(
            (r_, b_) for r_ in (1, 5, 16, 17, 624, 700) for b_ in (1, 33, 1100))
    ]
    for name, (kern, plain, layout, _) in grouped_ops.items():
        checked = grouped_ragged_rows if name == "batched_minplus" else grouped_ragged
        for g_, b_, s_g, r_ in checked:
            gath = rand_int((g_, s_g, b_) if layout else (g_, b_, s_g), 0.3)
            w = rand_int((g_, s_g, r_), 0.3)
            compare(name, kern(gath, w), plain(gath, w), (g_, b_, s_g, r_))
        for label, row in grouped_kernel[name].items():
            emit({"phase": "kernels", "kernel": name, "cell": f"sweep-{label}",
                  "match": True, "checked_shapes": [list(x) for x in checked],
                  **row})
    odd = rand_int((3 * 70 * 8 + 1,), 0.3)[1:].view(3, 70, 8)
    w = rand_int((3, 8, 12), 0.3)
    compare("batched_minplus", batched_minplus(odd, w), batched_minplus_plain(odd, w),
            "gath off a 16-byte boundary")

    # -- 4./5. the main path: route builds through the kernels ---------------
    def drive(phase, ls, ps, events, nodes):
        """Initial build + ``events`` churn builds from ``root`` (bench.py's
        event, a bump of ``fsw-0-0``, a neighbour of the root), then
        REMOTE_EVENTS remote events (a bump of the first adjacency of the
        last pod's first rack switch), then one more churn build under the
        profiler for the card's busy share; then one build with LFA on,
        whose loop-free alternates read the neighbours' distance rows of
        the device view and which must re-derive every route. Each route
        database is held against the host Dijkstra solver's. Each build
        reports the prefixes and node-label routes it re-derived, its
        ``decision.sp_route_reuses`` and its assembly ms (the build minus
        its view); in the sliced-ELL regime also its resident-band counter
        deltas and host-to-device bytes, every churn build must take the
        patch path and a warm solve, and each warm view must equal a cold
        ``ell_view_batch_packed`` over the same bands on the card (its
        launches are not counted). The launch counts and the device views'
        host-SPF fallbacks are zeroed just before and read just after; the
        host solver launches nothing, and the device solver must take no
        SPF to the host."""
        device_solver = SpfSolver(root, backend="device", device=dev)
        host_solver = SpfSolver(root, backend="host", device=dev)
        areas = {ls.area: ls}
        resident = nodes > SPARSE_NODE_THRESHOLD
        n_prefixes = len(ps.prefixes())
        rederived = count_calls(device_solver, "create_route_for_prefix")
        relabeled = count_calls(device_solver, "_derive_label_entry")
        stager = device_solver._resident.stager
        remote = remote_rsw(ls)

        def check(got, step, host=host_solver):
            want = host.build_route_db(root, areas, ps)
            if carry.route_db_to_plain(got.to_route_db(root)) != carry.route_db_to_plain(
                want.to_route_db(root)
            ):
                raise AssertionError(
                    f"{phase}: route database differs from the host oracle "
                    f"after event {step}"
                )
            if len(got.unicast_routes) != nodes - 1 or len(got.mpls_routes) < nodes:
                raise AssertionError(
                    f"{phase}: {len(got.unicast_routes)} unicast and "
                    f"{len(got.mpls_routes)} MPLS routes for {nodes} nodes"
                )

        def warm_equals_cold(step):
            view = device_solver._view(ls.area, ls, root)
            state = device_solver._resident._cache[ls][1]
            saved = dict(LAUNCHES)
            cold = spf_sparse.ell_view_batch_packed(
                state.graph, view._batch_srcs, dev).cpu().numpy()
            LAUNCHES.update(saved)
            warm = np.concatenate([view._d, view._fh_batch.astype(np.int32)])
            if not np.array_equal(warm, cold):
                raise AssertionError(f"{phase}: the warm view of event {step} differs "
                                     "from a cold solve on the card")

        def one_build(step, event):
            if event is not None:
                event()
            before = dict(LAUNCHES)
            c0, b0 = get_spf_counters(), dict(stager.bytes)
            r0, l0 = rederived[0], relabeled[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the build's one SPF view (graph compile/patch, device solve,
            # readback), solved first so its share of the build shows;
            # build_route_db then finds it in the solver's view cache
            device_solver._view(ls.area, ls, root)
            t1 = time.perf_counter()
            got = device_solver.build_route_db(root, areas, ps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            c1 = get_spf_counters()
            rec = {
                "ms": (t2 - t0) * 1e3, "view_ms": (t1 - t0) * 1e3,
                "assembly_ms": (t2 - t1) * 1e3,
                "prefixes_rederived": rederived[0] - r0,
                "label_routes_rederived": relabeled[0] - l0,
                "sp_route_reuses": c1["decision.sp_route_reuses"]
                - c0["decision.sp_route_reuses"],
                "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] > before[k]},
            }
            if rec["prefixes_rederived"] + rec["sp_route_reuses"] != n_prefixes:
                raise AssertionError(f"{phase}: {rec} does not cover {n_prefixes} prefixes")
            if resident:
                rec["ell"] = {k: c1[f"decision.{k}"] - c0[f"decision.{k}"] for k in ELL_KEYS}
                rec["h2d_bytes"] = {k: v - b0.get(k, 0) for k, v in stager.bytes.items()
                                    if v > b0.get(k, 0)}
                state = device_solver._resident._cache[ls][1]
                rec["reconverge_ms"] = state.reconverge_ms
                rec["hops"] = state.last_hops
                if step != 0 and (rec["ell"]["ell_full_compiles"] or not rec["ell"]["ell_patches"]
                                  or not rec["ell"]["ell_warm_solves"]):
                    raise AssertionError(f"{phase}: event {step} left the patch path or "
                                         f"solved cold: {rec['ell']}")
                warm_equals_cold(step)
            check(got, step)
            return rec

        reset_launches()
        SPF_COUNTERS["decision.spf_host_fallback"] = 0
        builds = [
            one_build(step, None if step == 0 else (
                lambda step=step: bump_metric(ls, "fsw-0-0", 2 + (step - 1) % 5)))
            for step in range(events + 1)
        ]
        remotes = [
            one_build(f"remote {i}", lambda i=i: bump_metric(ls, remote, 3 + i))
            for i in range(REMOTE_EVENTS)
        ]
        stats, (got, launched, wall_ms), _ = profiled(
            torch, churn_build(torch, device_solver, areas, ps, root, LAUNCHES),
            lambda st, res: build_lacking(st, res[1], least_launch_ms),
            prepare=lambda attempt: bump_metric(ls, "fsw-0-0", 9 + attempt))
        check(got, events + 1)
        lfa_solver = SpfSolver(root, backend="device", device=dev, compute_lfa_paths=True)
        lfa_rederived = count_calls(lfa_solver, "create_route_for_prefix")
        r0 = SPF_COUNTERS["decision.sp_route_reuses"]
        t0 = time.perf_counter()
        lfa_got = lfa_solver.build_route_db(root, areas, ps)
        lfa_ms = (time.perf_counter() - t0) * 1e3
        check(lfa_got, "LFA build", SpfSolver(
            root, backend="host", device=dev, compute_lfa_paths=True
        ))
        if SPF_COUNTERS["decision.sp_route_reuses"] != r0 or lfa_rederived[0] != n_prefixes:
            raise AssertionError(f"{phase}: the LFA build reused routes")
        fallbacks = SPF_COUNTERS["decision.spf_host_fallback"]
        if fallbacks:
            raise AssertionError(
                f"{phase}: {fallbacks} SPF queries of the device views went "
                "to the host Dijkstra"
            )
        busy_ms = device_us(stats, "a call") / 1e3
        launches = dict(LAUNCHES)
        events_only = builds[1:]
        emit({
            "phase": phase, "nodes": nodes, "root": root, "events": events,
            "parity_with_host_oracle": True, "prefixes": n_prefixes,
            "first_build_ms": builds[0]["ms"], "event_ms": [b["ms"] for b in events_only],
            "median_event_ms": statistics.median(b["ms"] for b in events_only),
            "first_view_ms": builds[0]["view_ms"],
            "event_view_ms": [b["view_ms"] for b in events_only],
            "median_event_view_ms": statistics.median(b["view_ms"] for b in events_only),
            "median_event_assembly_ms": statistics.median(
                b["assembly_ms"] for b in events_only),
            "remote_node": remote,
            "remote_event_ms": [b["ms"] for b in remotes],
            "remote_view_ms": [b["view_ms"] for b in remotes],
            "remote_assembly_ms": [b["assembly_ms"] for b in remotes],
            "remote_routes_rebuilt": [
                {"prefixes": b["prefixes_rederived"], "labels": b["label_routes_rederived"]}
                for b in remotes
            ],
            "first_build": builds[0], "event_builds": events_only, "remote_builds": remotes,
            "profiled_build_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_device_ms": {k: device_us(stats, KERNEL_KEYS[k]) / 1e3
                                 for k in launched},
            "profiled_launches": launched,
            "kernel_records": {k: kernel_records(stats, KERNEL_KEYS[k]) for k in launched},
            "h2d_copy_ms": copy_ms(stats),
            "top_device_ms": top_device_ms(stats),
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "launches": launches,
            "launches_per_build": [b["launches"] for b in builds + remotes],
            "lfa_build_ms": lfa_ms, "spf_host_fallbacks": fallbacks,
            "unicast_routes": len(got.unicast_routes),
            "mpls_routes": len(got.mpls_routes),
        })
        return launches

    dense = drive("dense", dense_ls, dense_ps, DENSE_EVENTS, n_dense)
    if dense["minplus"] == 0:
        raise AssertionError("dense route builds launched no minplus kernel")
    sparse = drive("sparse", sparse_ls, sparse_ps, SPARSE_EVENTS, n_sparse)
    if sparse["ell_band_relax"] == 0:
        raise AssertionError("sparse route builds launched no ell_band_relax kernel")

    # -- 6./7. the main path: all-sources route sweeps through the kernels --
    def oracle_digests(ls, graph):
        """Name -> (digest, next-hop total) of every destination from the
        host Dijkstra run from every source (``host_digest``)."""
        n, n_pad = graph.n, graph.n_pad
        d_rows = np.full((n, n_pad), INF, dtype=np.int64)
        nh_counts = np.zeros((n, n_pad), dtype=np.int64)
        for s_id, s_name in enumerate(graph.node_names):
            for t_name, res in ls.run_spf(s_name).items():
                t_id = graph.node_index[t_name]
                d_rows[t_id, s_id] = res.metric
                if s_id != t_id:
                    nh_counts[t_id, s_id] = len(res.next_hops)
        digests = route_sweep.host_digest(
            d_rows, nh_counts, pos_w=route_sweep.canonical_pos_weights(graph)
        )
        totals = nh_counts.sum(1)
        return {nm: (int(digests[i]), int(totals[i]))
                for i, nm in enumerate(graph.node_names)}

    def sweep_phase(phase, ls, block, full_oracle):
        """The all-sources route sweep on the ELL backend and on the
        grouped backend under each contraction kernel; held against the
        host Dijkstra and against each other by node name."""
        t0 = time.perf_counter()
        ell_graph = route_sweep.compile_out_ell(ls)
        ell_compile_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        grp_graph = spf_grouped.compile_out_grouped(ls)
        grp_compile_ms = (time.perf_counter() - t0) * 1e3
        samples = [
            next(nm for nm in ell_graph.node_names if nm.startswith(tier))
            for tier in ("rsw", "fsw", "ssw")
        ]
        backends = [("ell", lambda: route_sweep.RouteSweeper(
            ell_graph, samples, device=dev))]
        for impl in spf_grouped.IMPLS:
            backends.append((f"grouped/{impl}", lambda impl=impl: (
                spf_grouped.GroupedRouteSweeper(
                    grp_graph, samples, impl=impl, device=dev))))
        t0 = time.perf_counter()
        oracle = oracle_digests(ls, ell_graph) if full_oracle else None
        oracle_ms = (time.perf_counter() - t0) * 1e3
        want_routes = {}
        for nm in samples:
            want_routes[nm] = {
                dst: (res.metric, set(res.next_hops))
                for dst, res in ls.run_spf(nm).items() if dst != nm
            }
        reset_launches()
        phase_launches = dict(LAUNCHES)
        report = {}
        by_name = {}
        for label, make in backends:
            sweeper = make()
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = sweeper.sweep(block=block)
            torch.cuda.synchronize()
            sweep_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            for k in LAUNCHES:
                phase_launches[k] += launches[k]
            kernel = "rev_band_relax" if label == "ell" else label.split("/")[1]
            if launches[kernel] == 0:
                raise AssertionError(f"{phase}: the {label} sweep launched no {kernel}")
            stray = {k: v for k, v in launches.items() if k != kernel and v}
            if stray:
                raise AssertionError(f"{phase}: the {label} sweep launched {stray}")
            names = result.graph.node_names
            digests = route_sweep.digests_by_name(result)
            totals = {nm: int(result.nh_totals[result.graph.node_index[nm]])
                      for nm in names}
            by_name[label] = digests
            if oracle is not None:
                bad = [nm for nm in names
                       if (int(digests[nm]), totals[nm]) != oracle[nm]]
                if bad:
                    raise AssertionError(
                        f"{phase}: {label} digests differ from the host Dijkstra "
                        f"at {len(bad)} destinations, first {bad[:3]}"
                    )
            for nm in samples:
                if result.routes_from(nm) != want_routes[nm]:
                    raise AssertionError(
                        f"{phase}: {label} route table of {nm} differs from run_spf"
                    )
            # one more block under the profiler: the card's busy share; a
            # session that recorded none of the backend's own kernel missed
            # device activity and is run again
            ids = torch.arange(block, dtype=torch.int32, device=dev) % ell_graph.n_pad
            sweeper.solve_block(ids).cpu()
            stats, _, block_wall = profiled(
                torch, lambda: sweeper.solve_block(ids).cpu(),
                lambda st, _: lacking(st, KERNEL_KEYS[kernel]))
            busy = device_us(stats, "a call") / 1e3
            block_kernel_ms = device_us(stats, KERNEL_KEYS[kernel]) / 1e3
            report[label] = {
                "sweep_ms": sweep_ms, "blocks": len(result.digests) // block
                + (len(result.digests) % block > 0),
                "block_hops": sweeper.block_hops[: -(-ell_graph.n_pad // block)],
                "launches": launches,
                "profiled_block_ms": block_wall, "block_device_busy_ms": busy,
                "block_kernel_ms": block_kernel_ms,
                "block_device_idle_share": 1 - busy / block_wall,
                "block_top_device_ms": top_device_ms(stats),
            }
        ref = by_name["ell"]
        for label, digests in by_name.items():
            if digests != ref:
                raise AssertionError(f"{phase}: {label} digests differ from the ELL sweep's by name")
        emit({
            "phase": phase, "nodes": ell_graph.n, "n_pad": ell_graph.n_pad,
            "block": block, "samples": samples,
            "parity_with_host_oracle": "every destination digest" if full_oracle
            else "sample route tables",
            "backends_agree_by_name": True, "oracle_ms": oracle_ms,
            "ell_compile_ms": ell_compile_ms, "grouped_compile_ms": grp_compile_ms,
            "ell_bands": [[bd.rows, bd.k] for bd in ell_graph.bands],
            "structure_report": spf_grouped.structure_report(grp_graph),
            "backends": report, "launches": phase_launches,
        })
        return phase_launches

    sweep_small = sweep_phase("sweep-1008", dense_ls, DENSE_SWEEP_BLOCK, True)
    sweep_large = sweep_phase("sweep-10k", sparse_ls, SPARSE_SWEEP_BLOCK, False)

    # -- 8./9. the main path: KSP2 route builds through the engine --------
    def ksp2_engine_drive(phase, worlds, events):
        """The KSP2 engine (the default up to ksp2_engine.ENGINE_MAX_NODES
        nodes) on a KSP2 network from ``root``: an initial build,
        ``events`` bench events (a bump of ``fsw-0-0``), REMOTE_EVENTS
        remote ones (a bump of the last pod's first rack switch), each
        held against the host Dijkstra solver on its own copy of the
        databases, and after each the engine's resident all-sources
        matrix held against a cold ``ell_distances_from_sources`` on the
        card (its launches are taken back out of the counts). Then one
        more bench and one more remote build under the profiler. Each
        build reports cold build or incremental sync, the affected
        destinations, the KSP2 route reuses, the all-sources hops and
        ``ell_band_relax`` launches, the fast path on or off and the
        speculative rows changed, the engine's host-clock parts, the
        kernel launches and the host's garbage-collector ms. The launch counts and the solver counters are zeroed just before
        and read just after."""
        (ls, ps), (host_ls, host_ps) = worlds
        nodes = len(ls.get_adjacency_databases())
        areas, host_areas = {ls.area: ls}, {host_ls.area: host_ls}
        device_solver = SpfSolver(root, backend="device", device=dev)
        host_solver = SpfSolver(root, backend="host", device=dev)
        stager = device_solver._resident.stager
        remote = remote_rsw(ls)
        want_dsts = len({
            node for prefix in ps.prefixes()
            for (node, _), entry in ps.entries_for(prefix).items()
            if node != root and entry.forwarding_algorithm == KSP2_ED_ECMP
        })

        def check(got, step):
            want = host_solver.build_route_db(root, host_areas, host_ps)
            if carry.route_db_to_plain(got.to_route_db(root)) != carry.route_db_to_plain(
                want.to_route_db(root)
            ):
                raise AssertionError(
                    f"{phase}: route database differs from the host oracle "
                    f"after event {step}"
                )
            if len(got.unicast_routes) != nodes - 1 or len(got.mpls_routes) < nodes:
                raise AssertionError(
                    f"{phase}: {len(got.unicast_routes)} unicast and "
                    f"{len(got.mpls_routes)} MPLS routes for {nodes} nodes"
                )
            engine = device_solver._ksp2_engines[ls]
            state = device_solver._resident._cache[ls][1]
            saved = dict(LAUNCHES)
            cold = spf_sparse.ell_distances_from_sources(
                state.graph, torch.arange(state.graph.n_pad, device=dev), state=state)
            LAUNCHES.update(saved)
            same = torch.equal(engine.d_prev_dev, cold)
            del cold
            if not same:
                raise AssertionError(f"{phase}: the engine's resident all-sources matrix "
                                     f"after event {step} differs from a cold solve")

        def bump(node, metric):
            def event():
                for l in (ls, host_ls):
                    bump_metric(l, node, metric)
            return event

        def one_build(step, event):
            if event is not None:
                event()
            before = dict(LAUNCHES)
            c0, b0 = get_spf_counters(), dict(stager.bytes)
            gc0 = gc_clock.read()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = device_solver.build_route_db(root, areas, ps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            gc1 = gc_clock.read()
            c1 = get_spf_counters()
            stats = dict(device_solver.ksp2_stats)
            if stats.get("dsts") != want_dsts:
                raise AssertionError(f"{phase}: the engine tracked {stats.get('dsts')} "
                                     f"of {want_dsts} KSP2 destinations")
            engine = device_solver._ksp2_engines[ls]
            launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] > before[k]}
            parts = {k: v for k, v in stats.items() if k.endswith("_ms")}
            if engine.tracer != "native":
                raise AssertionError(f"{phase}: the engine traced with {engine.tracer!r}")
            rec = {
                "event": step, "ms": ms, "cold": bool(stats["cold"]),
                "tracer": engine.tracer,
                "fast_path": engine.masks_t is not None,
                "affected": stats.get("affected"),
                "rows_changed": stats.get("rows_changed"),
                "all_sources_hops": engine.last_hops,
                "counters": {k[len("decision."):]: c1[k] - c0[k] for k in KSP2_COUNTERS},
                "parts_ms": parts,
                "assembly_ms": ms - sum(parts.values()),
                "gc_ms": gc1[0] - gc0[0], "gc_full_collections": gc1[1] - gc0[1],
                "masked_batches": stats.get("chunks", 0),
                "h2d_bytes": {k: v - b0.get(k, 0) for k, v in stager.bytes.items()
                              if v > b0.get(k, 0)},
                "launches": launches,
            }
            check(got, step)
            return rec

        reset_launches()
        for name in SPF_COUNTERS:
            SPF_COUNTERS[name] = 0
        builds = [one_build(step, None if step == 0 else bump("fsw-0-0", 2 + (step - 1) % 5))
                  for step in range(events + 1)]
        remotes = [one_build(f"remote {i}", bump(remote, 3 + i)) for i in range(REMOTE_EVENTS)]
        profiles = {}
        for label, node, metric in (("bench", "fsw-0-0", 9), ("remote", remote, 20)):
            stats, (got, launched, wall_ms), _ = profiled(
                torch, churn_build(torch, device_solver, areas, ps, root, LAUNCHES),
                lambda st, res: build_lacking(st, res[1], least_launch_ms),
                prepare=lambda attempt, node=node, metric=metric: bump(node, metric + attempt)())
            check(got, f"profiled {label}")
            busy_ms = device_us(stats, "a call") / 1e3
            profiles[label] = {
                "build_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
                "cold": bool(device_solver.ksp2_stats["cold"]),
                "kernel_device_ms": {k: device_us(stats, KERNEL_KEYS[k]) / 1e3
                                     for k in launched},
                "profiled_launches": launched,
                "kernel_records": {k: kernel_records(stats, KERNEL_KEYS[k]) for k in launched},
                "h2d_copy_ms": copy_ms(stats), "d2h_copy_ms": copy_ms(stats, "DtoH"),
                "top_device_ms": top_device_ms(stats),
            }
        counters = dict(SPF_COUNTERS)
        if counters["decision.ksp2_device_batches"] == 0:
            raise AssertionError(f"{phase}: no KSP2 device batch")
        if counters["decision.ksp2_host_fallbacks"] or counters["decision.spf_host_fallback"]:
            raise AssertionError(f"{phase}: host fallbacks {counters}")
        if not any(b["counters"]["ksp2_incremental_syncs"] and b["counters"]["ksp2_route_reuses"]
                   for b in remotes):
            raise AssertionError(f"{phase}: no remote event synced incrementally and "
                                 f"reused KSP2 routes: {[b['counters'] for b in remotes]}")
        launches = dict(LAUNCHES)
        for kernel in ("ell_band_relax", "ell_band_relax_masked"):
            if launches[kernel] == 0:
                raise AssertionError(f"{phase}: KSP2 builds launched no {kernel}")
        events_only = builds[1:]
        emit({
            "phase": phase, "mode": "engine", "tracer": ksp2_engine.TRACER,
            "nodes": nodes, "root": root,
            "events": events, "ksp2_dsts": want_dsts, "parity_with_host_oracle": True,
            "resident_matches_cold_solve": True,
            "first_build": builds[0],
            "median_event_ms": statistics.median(b["ms"] for b in events_only),
            "event_ms": [b["ms"] for b in events_only],
            "remote_node": remote, "remote_event_ms": [b["ms"] for b in remotes],
            "event_builds": events_only, "remote_builds": remotes,
            "profiled": profiles,
            "counters": counters, "launches": launches,
            "unicast_routes": len(got.unicast_routes),
            "mpls_routes": len(got.mpls_routes),
        })
        return launches

    def ksp2_chunked_drive(phase, worlds, events):
        """The per-build chunked masked dispatch (the engine turned off):
        an initial build + ``events`` churn builds of a KSP2 network from
        ``root``, each held against the host Dijkstra solver on its own
        copy of the databases, then one more churn build under the
        profiler. The masked solves run over the solver's resident bands:
        a churn build must upload no band, and its staged mask bytes must
        be the masks'. The launch counts and the solver counters are
        zeroed just before and read just after."""
        (ls, ps), (host_ls, host_ps) = worlds
        nodes = len(ls.get_adjacency_databases())
        areas, host_areas = {ls.area: ls}, {host_ls.area: host_ls}
        device_solver = SpfSolver(root, backend="device", device=dev)
        host_solver = SpfSolver(root, backend="host", device=dev)
        stager = device_solver._resident.stager
        ksp2_graph = spf_sparse.compile_ell(ls)
        n_bands = len(ksp2_graph.bands)
        # a chunk's masks: packed words, and the bytes of bool cells
        chunk_words = _ksp2_chunk(ksp2_graph) * sum(
            mask_words(bd.rows, bd.k) for bd in ksp2_graph.bands)
        chunk_cells = _ksp2_chunk(ksp2_graph) * sum(
            bd.rows * bd.k for bd in ksp2_graph.bands)
        want_dsts = len({
            node for prefix in ps.prefixes()
            for (node, _), entry in ps.entries_for(prefix).items()
            if node != root and entry.forwarding_algorithm == KSP2_ED_ECMP
        })

        def check(got, step):
            want = host_solver.build_route_db(root, host_areas, host_ps)
            if carry.route_db_to_plain(got.to_route_db(root)) != carry.route_db_to_plain(
                want.to_route_db(root)
            ):
                raise AssertionError(
                    f"{phase}: route database differs from the host oracle "
                    f"after event {step}"
                )
            if len(got.unicast_routes) != nodes - 1 or len(got.mpls_routes) < nodes:
                raise AssertionError(
                    f"{phase}: {len(got.unicast_routes)} unicast and "
                    f"{len(got.mpls_routes)} MPLS routes for {nodes} nodes"
                )

        reset_launches()
        for name in SPF_COUNTERS:
            SPF_COUNTERS[name] = 0
        builds = []
        for step in range(events + 1):
            if step:
                for l in (ls, host_ls):
                    bump_metric(l, "fsw-0-0", 2 + (step - 1) % 5)
            before = dict(LAUNCHES)
            b0 = dict(stager.bytes)
            gc0 = gc_clock.read()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device_solver._view(ls.area, ls, root)
            t1 = time.perf_counter()
            got = device_solver.build_route_db(root, areas, ps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            gc1 = gc_clock.read()
            h2d = {k: v - b0.get(k, 0) for k, v in stager.bytes.items() if v > b0.get(k, 0)}
            stats = device_solver.ksp2_stats
            if stats.get("dsts") != want_dsts:
                raise AssertionError(f"{phase}: the device solved {stats.get('dsts')} "
                                     f"of {want_dsts} KSP2 destinations")
            launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            build = {"ms": (t2 - t0) * 1e3, "view_ms": (t1 - t0) * 1e3,
                     **{k: stats[k] for k in KSP2_PARTS}}
            build["assembly_ms"] = build["ms"] - build["view_ms"] - sum(
                stats[k] for k in KSP2_PARTS)
            build["gc_ms"] = gc1[0] - gc0[0]
            build["gc_full_collections"] = gc1[1] - gc0[1]
            build["hops"] = launches["ell_band_relax_masked"] / (n_bands * stats["chunks"]) - 1
            build["chunks"] = stats["chunks"]
            build["mask_bytes"] = stats["mask_bytes"]
            build["bool_mask_bytes"] = stats["chunks"] * chunk_cells
            if build["mask_bytes"] != 4 * stats["chunks"] * chunk_words:
                raise AssertionError(f"{phase}: {build['mask_bytes']} mask bytes uploaded "
                                     f"for {stats['chunks']} chunks")
            # the resident bands: uploaded whole by the first build only;
            # a metric churn build uploads patch rows and masks
            build["h2d_bytes"] = h2d
            build["band_bytes"] = h2d.get("bands", 0)
            if step and build["band_bytes"]:
                raise AssertionError(f"{phase}: event {step} uploaded "
                                     f"{build['band_bytes']} band bytes")
            if h2d.get("masks", 0) != build["mask_bytes"]:
                raise AssertionError(f"{phase}: {h2d} staged for {build['mask_bytes']} "
                                     "mask bytes")
            build["launches"] = {k: v for k, v in launches.items() if v}
            builds.append(build)
            check(got, step)

        def bump(attempt):
            for l in (ls, host_ls):
                bump_metric(l, "fsw-0-0", 9 + attempt)

        stats, (got, launched, wall_ms), _ = profiled(
            torch, churn_build(torch, device_solver, areas, ps, root, LAUNCHES),
            lambda st, res: build_lacking(st, res[1], least_launch_ms), prepare=bump)
        check(got, events + 1)
        counters = dict(SPF_COUNTERS)
        if counters["decision.ksp2_device_batches"] == 0:
            raise AssertionError(f"{phase}: no KSP2 device batch")
        if counters["decision.ksp2_host_fallbacks"] or counters["decision.spf_host_fallback"]:
            raise AssertionError(f"{phase}: host fallbacks {counters}")
        launches = dict(LAUNCHES)
        if launches["ell_band_relax_masked"] == 0:
            raise AssertionError(f"{phase}: KSP2 builds launched no ell_band_relax_masked")
        busy_ms = device_us(stats, "a call") / 1e3
        events_only = builds[1:]
        emit({
            "phase": phase, "nodes": nodes, "root": root, "events": events,
            "ksp2_dsts": want_dsts, "parity_with_host_oracle": True,
            "first_build": builds[0],
            "median_event_ms": statistics.median(b["ms"] for b in events_only),
            "median_event_split_ms": {
                k: statistics.median(b[k] for b in events_only)
                for k in ("view_ms", *KSP2_PARTS, "assembly_ms")
            },
            "event_builds": events_only,
            "mask_bytes_per_build": builds[-1]["mask_bytes"],
            "band_bytes_per_build": [b["band_bytes"] for b in builds],
            "h2d_copy_ms": copy_ms(stats),
            "bool_mask_bytes_per_build": builds[-1]["bool_mask_bytes"],
            "profiled_build_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_device_ms": {k: device_us(stats, KERNEL_KEYS[k]) / 1e3
                                 for k in launched},
            "profiled_launches": launched,
            "kernel_records": {k: kernel_records(stats, KERNEL_KEYS[k]) for k in launched},
            "top_device_ms": top_device_ms(stats),
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "counters": counters, "launches": launches,
            "unicast_routes": len(got.unicast_routes),
            "mpls_routes": len(got.mpls_routes),
        })
        return launches

    ksp2_small = ksp2_engine_drive("ksp2-1008", ksp2_dense, KSP2_DENSE_EVENTS)
    ksp2_large = ksp2_engine_drive("ksp2-10k", ksp2_sparse, KSP2_SPARSE_EVENTS)
    engine_max = ksp2_engine.ENGINE_MAX_NODES
    ksp2_engine.ENGINE_MAX_NODES = 0
    try:
        ksp2_chunked = ksp2_chunked_drive("ksp2-1008-chunked", ksp2_dense_chunked,
                                          KSP2_CHUNKED_EVENTS)
    finally:
        ksp2_engine.ENGINE_MAX_NODES = engine_max

    # -- 11-13. the Decision module -----------------------------------------------
    decision_small, decision_large, decision_faults = decision_phases(
        dev, root, DENSE_NODES, SPARSE_NODES, DECISION_DENSE_EVENTS, DECISION_SPARSE_EVENTS,
        gc_clock)

    # -- 14-15. the route plane under sustained load, in a process of its own
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pipeline_small, pipeline_large = pool.apply(pipeline_process, (_START,))

    # -- 16. a fabric of whole daemons, in a process of its own
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        fabric = pool.apply(daemon_fabric_process, (_START,))

    main_launches = {
        k: dense[k] + sparse[k] + sweep_small[k] + sweep_large[k] + ksp2_small[k]
        + ksp2_large[k] + ksp2_chunked[k] + decision_small[k] + decision_large[k]
        + decision_faults[k] + pipeline_small[k] + pipeline_large[k] + fabric[k]
        for k in LAUNCHES
    }

    def sweep_row(cells):
        """A route sweep kernel's closing-line fields: its times at the
        10 000-node sweep's shapes, with each band's or segment's launch
        plan and time, and the same at the 1008-node sweep's block."""
        row = cells["10k"]
        parts = {k: row[k] for k in ("bands", "segments") if k in row}
        return {
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "call_ms": row["call_ms"],
            "plain_call_ms": row["plain_call_ms"], "shape": row["shape"], **parts,
            "at_1008": {k: v for k, v in cells["1008"].items() if k != "bound_by"},
        }

    emit({"phase": "profiler", **profiler_summary()})
    csrc = "openr_tpu_torch/csrc"
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "minplus", "route": "cuda", "source": f"{csrc}/minplus.cu",
         "replaces": "openr_tpu/ops/pallas_minplus.py:69",
         "launches": main_launches["minplus"],
         "max_abs_err": max_err["minplus"],
         "ms": mp_ms, "plain_ms": mp_plain,
         "bound_ms": mp_bound, "bound_by": mp_by, "library_ms": None,
         "call_ms": mp_call, "plain_call_ms": mp_plain_call,
         "shape": [[s_, k_], [k_, n_]], "plan": mp_row["plan"], "match": True,
         "at_s64": {k: mp_row64[k] for k in (
             "shape", "plan", "kernel_ms", "plain_ms", "bound_ms", "call_ms")}},
        {"name": "ell_band_relax", "route": "cuda", "source": f"{csrc}/ell_relax.cu",
         "replaces": "openr_tpu/ops/pallas_ell.py:196",
         "launches": main_launches["ell_band_relax"],
         "max_abs_err": max_err["ell_band_relax"],
         "ms": ell_ms, "plain_ms": ell_plain,
         "bound_ms": ell_bound, "bound_by": ell_by, "library_ms": None,
         "call_ms": ell_call, "plain_call_ms": ell_plain_call,
         "shape": {"S": b, "n_pad": graph.n_pad,
                   "bands": [[bd.rows, bd.k] for bd in graph.bands]},
         "match": True,
         "all_sources": all_sources_kernel},
        {"name": "ell_band_relax_masked", "route": "cuda",
         "source": f"{csrc}/ell_relax_masked.cu",
         "replaces": "openr_tpu/ops/pallas_ell.py:219",
         "launches": main_launches["ell_band_relax_masked"],
         "max_abs_err": max_err["ell_band_relax_masked"],
         "ms": masked_kernel["1008"]["kernel_ms"],
         "plain_ms": masked_kernel["1008"]["plain_ms"],
         "bound_ms": masked_kernel["1008"]["bound_ms"],
         "bound_by": masked_kernel["1008"]["bound_by"], "library_ms": None,
         "bound_bytemask_ms": masked_kernel["1008"]["bound_bytemask_ms"],
         "call_ms": masked_kernel["1008"]["call_ms"],
         "plain_call_ms": masked_kernel["1008"]["plain_call_ms"],
         "shape": masked_kernel["1008"]["shape"], "bands": masked_kernel["1008"]["bands"],
         "match": True,
         "at_10k": {k: masked_kernel["10k"][k] for k in (
             "shape", "bands", "kernel_ms", "plain_ms", "bound_ms", "bound_bytemask_ms",
             "call_ms", "plain_call_ms")}},
        {"name": "rev_band_relax", "route": "cuda", "source": f"{csrc}/rev_relax.cu",
         "replaces": "openr_tpu/ops/pallas_ell.py:248",
         "launches": main_launches["rev_band_relax"],
         "max_abs_err": max_err["rev_band_relax"],
         **sweep_row(rev_kernel), "match": True},
    ] + [
        {"name": name, "route": "cuda", "source": f"{csrc}/grouped_minplus.cu",
         "replaces": replaces,
         "launches": main_launches[name], "max_abs_err": max_err[name],
         **sweep_row(grouped_kernel[name]), "match": True}
        for name, replaces in (
            ("batched_minplus", "openr_tpu/ops/pallas_grouped.py:247"),
            ("batched_minplus_t", "openr_tpu/ops/pallas_grouped.py:203"),
        )
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
