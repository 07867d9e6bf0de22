#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's route build, route sweep, route engine, Decision module, route plane, daemon fabric, daemon process, tenant plane and solver service on one NVIDIA card.

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
   resident bands), with one remote event. Each build also reports its deltas of
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
7a. ``engine-1008``: the network-wide route engine
   (``ops/route_engine.py``) on a fresh link state of the 1008-node fabric,
   shared by three engines: the ELL ``RouteSweepEngine`` and the
   ``GroupedRouteSweepEngine`` under each contraction kernel (samples
   ``rsw-0-0``, ``fsw-0-0``, ``ssw-0-0``). The events, each to every engine
   in turn: three bumps of ``fsw-0-0``'s first metric (``2 + step % 5``), a
   remote bump (``rsw-61-0``), a drain and an undrain of ``fsw-1-0``, the
   link ``rsw-1-0``--``fsw-1-0`` pulled both ways and restored, a window of
   three metric events (``churn_window``), three events with
   ``defer_consume`` and a ``flush()``, a ``churn_burst`` of three, a
   speculation that hits and one that another event cancels. After each,
   a cold ``RouteSweeper.sweep`` on the card over a fresh
   ``compile_out_ell`` of the same link state must equal every engine by
   node name (digests, next-hop totals, sample metrics and next hops),
   each sample's ``routes_from`` must equal ``run_spf``'s, the engines must
   agree, and each engine's moved names must be the destinations whose
   row changed since the previous oracle. Each event reports, per engine,
   the path it took (bucket k, frontier, full width, cold), the affected
   and changed rows, the readback bytes, its host ms (ending in the
   consume), its relax hops, its ``ops.host_dispatches``/
   ``blocking_syncs``/``async_reaps``, the frontier's rows, cells and
   jumps, and ``gc_ms``; one more event per engine is profiled (busy,
   idle share, heaviest ops, the relax kernel's device time and records).
   Then the ladder: ``route_engine.dispatch`` armed once (the cold rung),
   ``dispatch`` and ``cold_build`` (the host rung, equal to the oracle),
   then unarmed events probe back through the cold rung to the warm one;
   ``route_engine.host_fallbacks`` may rise only in the armed step. Each
   engine must launch its relax kernel and no other.
7b. ``engine-10k``: the same on the 10 000-node fabric (remote
   ``rsw-623-0``), without the ladder.
7c. ``sweep-100k``, in a spawned process: the ELL sweep of
   ``fat_tree_nodes(100000)`` (n_pad 100096, block 1024, 98 blocks) through
   ``RouteSweeper``, its three sample route tables against ``run_spf`` and
   64 seeded destinations' digests and next-hop totals against the numpy
   replica (``ops/host_sweep.py``), those host oracles computed in
   spawned workers while the card works; ``rev_band_relax`` at its
   out-bands (7488 rows of k 8 become 74 988, and a band of k 8192)
   against the plain version, timed. The engine does not run there: its
   resident DR would be 40 GB.
8. ``ksp2-1008``: KSP2_ED_ECMP route builds from ``rsw-0-0`` on the
   1008-node fabric with every prefix KSP2 over SR-MPLS (1007
   destinations), through the incremental KSP2 engine
   (``decision/ksp2_engine.py``, with its fast path: every
   destination's edge mask resident and re-solved in each event's fused
   dispatch): an initial build, churn events that bump ``fsw-0-0``'s
   first adjacency metric, then 3 remote events (1 at 10 000 nodes) that
   bump the last pod's first rack switch. Every route database must equal
   the host Dijkstra solver's, which runs on its own copy of the
   link-state and prefix databases (the kth-path cache lives on the ``LinkState``: a shared
   one would hand it the device's second paths) in spawned processes
   (``HostRouteOracle``: each build's oracle replays the events so far and
   runs beside the others and the card; the answers are compared at the
   phase's end, so the card never waits on the host's 40 s builds at
   10 000 nodes), and after each event
   the engine's resident all-sources matrix must equal a cold
   ``ell_distances_from_sources`` on the card. Each build reports cold
   build or incremental sync, the affected destinations, the KSP2
   route reuses and counter deltas, the all-sources hops, fast path on
   or off, the speculative rows changed, the engine's host-clock parts
   (``SpfSolver.ksp2_stats``), the ms the host spent in Python's
   garbage collector (``gc_ms``) and the rest (``assembly_ms``). One
   more bench and one more remote build are profiled, as in ``dense``
   (at 10 000 nodes the bench build alone).
   The KSP2 device batches must be > 0, its host fallbacks and the
   views' host-SPF fallbacks 0, a remote event must sync incrementally
   and reuse KSP2 routes, and ``ell_band_relax`` and
   ``ell_band_relax_masked`` must launch.
9. ``ksp2-10k``: the same on the 10 000-node fabric, one remote event,
   with 256 evenly sampled KSP2 prefixes (the stride of ``benchmarks/bench_scale.py``'s
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
12. ``decision-10k``: the same on the 10 000-node fabric, 1 bench event
   (3 until the tenant plane's phases joined the script) and 1 remote one
   (``rsw-623-0``); also every rebuild after the first
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
   is a component of its own, so its prefixes get no routes); 10
   generator events one at a time (20 until the daemon process joined
   the script, which then ran past 1000 s) (``event_ms`` each, until every
   Decision holds it and is idle); the cut (``reroute_ms``: the link
   ``rsw-1-0``–``fsw-1-0`` partitioned both ways, until both ends lost
   the neighbour, every Decision dropped the link and every Fib equals
   its oracle, the oracles' own build left out). After each step
   every daemon's Fib must equal the host oracle (``SpfSolver`` on the
   host backend over that daemon's own link-state and prefix state, run
   on its Decision's thread; it must launch no kernel); no neighbour may
   be lost but the cut's two; no ``decision.fallbacks`` or
   ``spf_host_fallback``; ``minplus`` must launch. The 24 daemons share
   one interpreter's collector, so the phase freezes the heap and defers
   full collections to its end (``defer_full_collections``: full
   collections over all 24 daemons' heaps took 13-14 s of a 20 s flood,
   and a run on the card lost every neighbour in the flood). It reports launches by
   kernel and by step, threads, ``gc_ms`` and the longest collection, the
   LAN's delivery lag by step (``LanProbe``: how late a probe packet rode
   the delivery thread Spark's keepalives ride), the process's peak
   resident set, the solvers' pinned bytes and
   ``torch.cuda.max_memory_allocated``.

17. ``daemon-process``: the daemon as users run it, a process of its own
   (``python -m openr_tpu_torch.main --config <file>``, Decision on the
   card, node ``proc-0`` outside the LSDB, the watchdog on with the
   configuration's ``watchdog.max_memory_mb`` set to ``DAEMON_MAX_MEMORY_MB``),
   driven over its wires from another process, one leg a fabric: the
   1008-node one (roots ``rsw-0-0``, ``fsw-0-0``, ``ssw-0-0``,
   ``rsw-61-0``, ``rsw-0-0`` again; 10 events) and the 10 000-node one
   (roots ``rsw-0-0``, ``rsw-623-0``; 3 events). ``boot_s``: from the
   process's start until ``getMyNodeName`` answers on the OpenrCtrl thrift
   wire; ``flood_s``: the generator's LSDB (seed 20260805) sent over the
   KvStore thrift peer wire (``ThriftPeerTransport.set_key_vals``, 256
   keys a call) until ``getDecisionAdjacencyDbs`` holds every node;
   ``answer_ms``: ``getRouteDbComputed`` for each root, each answer equal
   to the host oracle (``SpfSolver(backend="host", device="cpu")`` over
   this process's own link-state and prefix databases, built from the
   same values; it must launch no kernel); ``event_ms``: each generator
   event sent on the same wire until the daemon's Decision took it in and
   the answer for ``rsw-0-0`` equals the oracle's after it (10 s at most;
   this process's own conversion of each answer, to compare it, left out).
   Then ``python -m openr_tpu_torch.cli.breeze --port <ctrl> decision
   routes --node rsw-0-0`` must exit 0 and list every destination of the
   thrift answer. The daemon's ``ops.host_dispatches`` (read with
   ``getCounters``) must rise over the answers and events, its
   ``decision.fallbacks`` stay 0, ``nvidia-smi --query-compute-apps`` must
   list one process more while it runs (that machine's PID namespace
   shows every pid as 1); its peak resident set is its own
   ``process.rss_peak_bytes`` counter. After
   ``SIGTERM`` it must exit 0 within 30 s.

18. ``tenancy-1008``: the tenant plane (``ops/world_batch.py``):
   ``WorldManager(slots_per_bucket=64, max_resident=128)`` on the card
   serving 64 vantage tenants over one 1008-node LinkState (40 rack, 16
   fabric, 8 spine switches: the three source-batch buckets S = 8, 32 and
   64 fill and the graph is shared, ``tenancy.graph_shares``) and 8 area
   tenants on LinkStates of their own rooted at ``rsw-0-0``, which join the
   warm buckets after the first round. 10 rounds, one ``solve_views``
   each: a metric bump, an adjacency down and back up, an ``fsw``
   overload flip in turn, on the shared LinkState and one area, and a
   vantage override toggled every round. Every view must equal
   ``ell_view_batch_packed`` of the tenant's graph and sources on the
   card (the reference's sequential oracle; its launches not counted),
   four tenants of round 1 the host Dijkstra; ``ops.aot_compiles`` must
   not move after the first round, ``ops.aot_fallbacks`` never. Then
   ``WorldManager(8, 8)`` overcommitted with 16 tenants for 3 rounds must
   evict and rehydrate warm (no cold solve after the first round); one
   tenant's ``ksp2_view`` for 64 destinations must equal the host's
   ``get_kth_paths(…, 1) + (…, 2)``, with ``tenancy.ksp2_host_fallbacks``
   flat; ``SpfSolver(world_batch=True)`` over 4
   areas (copies of the fabric, root ``rsw-0-0``) must build the route
   databases of ``world_batch=False`` before and after one churn event
   (in every area), with ``decision.world_preloads`` rising and
   ``decision.world_preload_failures`` at 0. It reports each round's ms
   and garbage-collector ms, the batched against the sequential ms a
   tenant (the reference's ``bench_scale.multi_tenant_bench`` ratio,
   gated there at 0.5; over the rounds after the first, and over those
   after the areas' join), the
   ``tenancy.*`` deltas, the delta rows and bytes read back, the Decision
   builds' ms and garbage-collector ms, and one profiled wave (busy ms,
   idle share, heaviest ops) with one more wave's host clock split at its
   bucket launches and reaps.
19. ``tenancy-10k``: 4 area tenants of the 10 000-node fabric in one
   bucket (``[4, 16384, 1024]``, 512 MiB of slots), 3 churn rounds, every
   view against ``ell_view_batch_packed``; peak memory and each round's
   ms.
20. ``serve-1008``, in a spawned process that owns the card for the
   service: ``SolverService`` (a 32-slot manager) behind
   ``CtrlServer(SolverCtrlHandler)``; three torch-free client processes
   (``load.multi_client.spawn_clients``) hold 8 tenants each of the
   1008-node fabric in the three SLO classes for 5 churn rounds. Every
   digest a client reads must equal ``oracle_digests`` (the port's plain
   versions in two spawned processes, beside the service), ``solver_fib``
   for two more
   tenants ``oracle_fib_digests``; ``tenancy.wave_joins`` must rise and no
   key be captured after the first wave. It reports each class's p99 and
   p50 as the clients saw them (the wire included), the waves and the
   preemptions.
21. ``fleet-1008``, in the same process: ``FleetController(services=2,
   with_standby=True)`` over 8 tenants of the 1008-node fabric for 6
   rounds; one tenant migrates live before round 2 (warm, the client
   answering the redirect), and the primary owning another is killed
   before round 4 and its standby promoted mid-storm (zero route
   deletes); every digest against ``oracle_digests``. It reports the
   migration ms and the replica lag.

Phase 7c runs in a process of its own (``sweep_100k_process``), so the
100 000-node link state leaves with it. Phases 14 and 15 run in another
(``pipeline_process``,
started with ``spawn`` and joined): it holds only the route plane, as a
daemon's does. The earlier phases keep six copies of the two networks
alive, and a full garbage collection's pause grows with the heap. Phase
16 runs in another (``daemon_fabric_process``), phase 17's driving
side in a third (``daemon_process_process``), and phases 20 and 21 in a
fourth (``serve_fleet_process``).

A ``committed`` line follows each phase whose path dispatches through the
executable cache or runs the budgeted relax loops (``dense``, ``sparse``,
the sweeps, the engines, the KSP2 phases, ``daemon-fabric``): the cache's
captures, hits, fallbacks (any fails the phase) and evictions over the
phase, blocking syncs per event, its keys and the bytes of its shared
input and output buffers and graph pool, the card's peak memory over the
phase, and by tag the bytes a replay copies in and out, costed at the
card's measured copy rate. The cache is never cleared between phases:
its least-recently-used bound holds it. An engine phase's line also
carries its warm deferred events, cached and with the bodies called
directly: touches, blocking syncs, ms, bit-equality, and the card's
allocated bytes after each. ``autotune`` lines follow ``kernels``: each
family and shape on the path, each candidate plan's CUDA-event ms, and
the winner (applied only under ``"auto"``).

Every phase line carries ``t_s``, the seconds since the script started.
Each profiler session idles a margin inside its window before and after
what it measures, doubled after a short session (``profiled``); a
``profiler`` line of the main process, and one of the pipeline's, counts
the sessions, the short ones, the margin and the launch skew.

The ``kernels`` phase holds ``ell_band_relax`` also at the KSP2 engine's
all-sources shapes, S = n_pad rows (1024 and 10112), against its plain
version on slices of 1024 rows, and over a tenant axis
(``ell_band_relax_worlds``, ``csrc/ell_relax_worlds.cu``, with its
live-slot counts given and computed, and the live pass ``live_slots``
against its plain version) at the tenant plane's two shapes, ``[64, 64,
1024] x [64, 1024, 64]`` and ``[4, 8, 16384] x [4, 16384, 1024]``, and at
ragged random worlds, with and without INF holes inside the rows' live
prefixes. That of the route sweep's kernels (``rev_band_relax``,
``batched_minplus``, ``batched_minplus_t``) runs at both sweeps' shapes:
one relax step of a 1024-destination block of the 10 000-node sweep and
of a 256-destination block of the 1008-node one; that of
``rev_band_relax`` and ``batched_minplus(_t)`` also run at the route
engine's shapes over the 10 000-node graphs: churn buckets of 32 and 1024
rows with scattered, repeated destinations, and the full width (10112);
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
with KSP2 3 and 3, and 2 with the chunked dispatch; through Decision 10
and 3; the route engine's script) and a 10 000-node one (3 events and 1
remote one; with KSP2 1 and 1; through Decision 1 and 1; the route
engine's script; under load, the windows above; 24 daemons, 10 events; a
daemon process, 10 and 3 events; 72 tenants for 10 rounds, 4 for 3; a
solver service of 24 tenants for 5 rounds, a fleet of 8 for 6), and the
100 000-node sweep; only the seed of the random kernel inputs can be set.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import resource
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
# the first adjacency of the last pod's first rack switch, far from the root.
# The 10 000-node route builds (sparse, ksp2-10k) take one: each build there
# pays its host oracle (the KSP2 one 30-40 s at 10 000 nodes), and the
# script has to make room for the route engine's phases inside its time
# limit
REMOTE_EVENTS = 3
SPARSE_REMOTE_EVENTS = 1
KSP2_SPARSE_REMOTE_EVENTS = 1
# the resident bands' counters the sparse phase reports per build
ELL_KEYS = ("ell_full_compiles", "ell_patches", "ell_warm_solves", "ell_cold_solves")
REPS = 30
# route sweep: destinations per block on each network (the reference
# scale bench's 1008-node and 10 000-node settings)
DENSE_SWEEP_BLOCK = 256
SPARSE_SWEEP_BLOCK = 1024
# the route sweep at the north star's size (sweep-100k, a spawned process):
# fat_tree_nodes(SWEEP_100K_NODES), SWEEP_100K_BLOCK destinations a block,
# SWEEP_100K_CHECKED seeded destinations held against the numpy replica
SWEEP_100K_NODES = 100000
SWEEP_100K_BLOCK = 1024
SWEEP_100K_CHECKED = 64
SWEEP_100K_SEED = 20260805
# calls a profiler session times at 100 000 nodes: sessions of 30 calls of
# a 0.4 ms band kept 20 records five times running on an H100
SWEEP_100K_REPS = 10
# processes that run the phase's host oracles (a run_spf each, the replica)
# beside the card's work: 47 and 17 s of host time at 100 000 nodes
SWEEP_100K_WORKERS = 4
# the route engine's phases (engine-1008, engine-10k): the samples of its
# three engines, the link pulled both ways, the burst's three nodes (their
# affected sets apart), and the registry counters each event reports
ENGINE_SAMPLES = ("rsw-0-0", "fsw-0-0", "ssw-0-0")
ENGINE_LINK = ("rsw-1-0", "fsw-1-0")
ENGINE_BURST = ("rsw-2-0", "rsw-3-0", "rsw-4-0")
ENGINE_COUNTERS = ("ops.host_dispatches", "ops.blocking_syncs", "ops.async_reaps",
                   "ops.burst_cancels", "ops.spec_dispatches", "ops.spec_hits",
                   "ops.spec_cancels", "ops.spec_skips", "ops.frontier_fallbacks",
                   "route_engine.incremental_events", "route_engine.full_refreshes",
                   "route_engine.frontier_resolves", "route_engine.cold_builds",
                   "route_engine.host_fallbacks", "route_engine.coalesced_events",
                   "route_engine.structural_events")
# KSP2 cells: churn events on the 1008-node fabric (every prefix KSP2) and
# on the 10 000-node one, where KSP2_SAMPLED_DSTS evenly sampled prefixes
# are KSP2 (the realistic per-prefix opt-in at that scale)
KSP2_DENSE_EVENTS = 3
KSP2_SPARSE_EVENTS = 1
KSP2_SAMPLED_DSTS = 256
# the host oracle of the KSP2 engine cells: its worker processes, and the
# longest wait for the route database of one build
HOST_ORACLE_WORKERS = 4
HOST_ORACLE_WAIT_S = 900.0
# the chunked KSP2 dispatch (engine off) stays driven on the 1008-node
# fabric for this many churn events
KSP2_CHUNKED_EVENTS = 2
# rows of the all-sources relax held against the plain version at once
ALL_SOURCES_SLICE = 1024
# the Decision module's phases: bench events (a re-published fsw-0-0
# adjacency database) on the 1008-node and the 10 000-node fabric, each
# followed by REMOTE_EVENTS remote ones; the module's default debounce
DECISION_DENSE_EVENTS = 10
DECISION_SPARSE_EVENTS = 1
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
FABRIC_EVENTS = 10
FABRIC_CUT = ("rsw-1-0", "fsw-1-0")
FABRIC_STEP_S = 120.0
# the daemon as a process (daemon-process): python -m openr_tpu_torch.main
# named DAEMON_NODE, outside the LSDB (its own routes are empty); a leg a
# fabric of fat_tree_nodes(nodes), its roots asked in turn and its events
# sent one at a time; the LSDB goes over the KvStore thrift peer wire
# DAEMON_BATCH keys a call; after an event the answer for DAEMON_EVENT_ROOT
# must equal the oracle within DAEMON_EVENT_S; the watchdog's memory limit
# in the daemon's configuration (MB): the daemon's resident set on the card
# peaked at 5661130752 bytes (10 000 nodes; 5497507840 at 1008), torch and
# the CUDA libraries most of it, past the configuration's default 800
DAEMON_NODE = "proc-0"
DAEMON_LEGS = (
    {"nodes": 1000, "roots": ("rsw-0-0", "fsw-0-0", "ssw-0-0", "rsw-61-0", "rsw-0-0"),
     "events": 10},
    {"nodes": 10000, "roots": ("rsw-0-0", "rsw-623-0"), "events": 3},
)
DAEMON_BATCH = 256
DAEMON_EVENT_ROOT = "rsw-0-0"
DAEMON_EVENT_S = 10.0
DAEMON_BOOT_S = 180.0
DAEMON_FLOOD_S = 300.0
DAEMON_STOP_S = 30.0
DAEMON_MAX_MEMORY_MB = 8192
DAEMON_FALLBACKS = ("decision.fallbacks", "decision.spf_host_fallback", "decision.degradations",
                    "decision.ladder_exhausted")
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
        self.longest_ms = 0.0
        self._t0 = None
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self.ms += ms
            self.longest_ms = max(self.longest_ms, ms)
            self.full += info["generation"] == 2
            self._t0 = None

    def read(self):
        return self.ms, self.full


def defer_full_collections():
    """Freeze the heap as it stands (``gc.freeze``) and stop automatic
    full collections, the young generations collected as before; returns
    the call that restores the thresholds and unfreezes. For a phase
    that hosts many daemons in one interpreter: a full collection there
    walks every daemon's heap while every daemon stands still (13-14 s
    of a 20 s flood at 24 daemons), which a daemon in a process of its
    own never sees."""
    threshold = gc.get_threshold()
    gc.freeze()
    gc.set_threshold(threshold[0], threshold[1], 1 << 30)

    def restore():
        gc.set_threshold(*threshold)
        gc.unfreeze()

    return restore


class LanProbe:
    """The delivery lag of a ``MockIoProvider`` as a packet sees it: a
    pair of probe interfaces joined to each other, one sending its send
    time every ``interval_s`` from a thread of its own, the other noting
    how late each packet arrived past the link's 1 ms. Spark's keepalives
    ride the same delivery thread, so a lag near the hold time loses
    neighbours. ``take`` returns the largest lag since the last take,
    ``all_max`` the largest yet."""

    def __init__(self, io, interval_s: float = 0.25):
        self.io = io
        self.interval_s = interval_s
        self.lags = []
        self.all_max = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        io.connect_pair("probe_a", "probe_b", 1)
        io.attach("probe_b", self._receive)
        self._thread = threading.Thread(target=self._run, name="lan-probe", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.io.send("probe_a", repr(time.monotonic()).encode())

    def _receive(self, if_name, payload):
        lag_ms = (time.monotonic() - float(payload.decode())) * 1e3 - 1.0
        with self._lock:
            self.lags.append(lag_ms)
            self.all_max = lag_ms if self.all_max is None else max(self.all_max, lag_ms)

    def take(self):
        with self._lock:
            lags, self.lags = self.lags, []
        return max(lags) if lags else None

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


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
    "ell_live_slots": ("ell_live_slot_counts",),
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


# a HostRouteOracle worker's network, kept between its tasks: (nodes,
# ksp2_dsts, root) -> (link state, prefix state, host solver, events applied)
_ORACLE_STATE = {}


def _host_oracle_task(nodes, ksp2_dsts, root, events):
    """One ``HostRouteOracle`` answer, in a worker process: the host
    Dijkstra solver's plain route database of the KSP2 network after
    ``events`` (``(node, metric)`` bumps in order). The worker keeps its
    network between tasks and applies only the events past those it
    applied (the checks come in order), or builds it anew."""
    sys.path.insert(0, str(ROOT))
    from openr_tpu_torch import carry
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies

    key = (nodes, ksp2_dsts, root)
    state = _ORACLE_STATE.get(key)
    if state is None or state[3] > len(events):
        ls, ps = load_ksp2_network(topologies, LinkState, PrefixState, nodes, ksp2_dsts)
        state = (ls, ps, SpfSolver(root, backend="host", device="cpu"), 0)
    ls, ps, solver, applied = state
    for node, metric in events[applied:]:
        bump_metric(ls, node, metric)
    _ORACLE_STATE[key] = (ls, ps, solver, len(events))
    db = solver.build_route_db(root, {ls.area: ls}, ps)
    return carry.route_db_to_plain(db.to_route_db(root))


class HostRouteOracle:
    """The host Dijkstra solver's route databases of a KSP2 network, in
    ``HOST_ORACLE_WORKERS`` spawned processes, each with its own copy of
    the databases: the caller logs each event as it applies it to its own
    (``bump``) and hands over each build's route database (``check``),
    which submits the oracle's build after the events so far; the answers
    are compared in ``finish``. The card never waits on the host (at
    10 000 nodes about 40 s a build), and the builds run side by side."""

    def __init__(self, nodes, ksp2_dsts, root):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.args = (nodes, ksp2_dsts, root)
        self.pool = ProcessPoolExecutor(
            HOST_ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.events = []
        self.pending = []
        self.checked = 0

    def bump(self, node, metric) -> None:
        self.events.append((node, metric))

    def check(self, step, got_plain) -> None:
        future = self.pool.submit(_host_oracle_task, *self.args, list(self.events))
        self.pending.append((step, got_plain, future))

    def finish(self, phase) -> None:
        """Wait for every answer; raise on the first route database that
        differs from the oracle's. Stops the workers either way."""
        try:
            for step, got, future in self.pending:
                if got != future.result(timeout=HOST_ORACLE_WAIT_S):
                    raise AssertionError(f"{phase}: route database differs from the host "
                                         f"oracle after event {step}")
                self.checked += 1
        finally:
            self.pool.shutdown(cancel_futures=True)


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


def daemon_fabric_phase(m, fabric, lsdb_nodes, events, spark, cut, step_s=FABRIC_STEP_S,
                        defer_gc=True):
    """``daemon-fabric``: a ``DaemonFabric`` over ``m`` brought up, then
    flooded with the generator's LSDB of ``fat_tree_nodes(lsdb_nodes)``
    (seed ``PIPELINE_SEED``) set at ``FABRIC_INJECT``'s KvStore, then
    ``events`` of its events one at a time, then the link ``cut`` (two
    switch names) partitioned both ways. After each step every daemon's
    Fib must equal its host oracle, and no neighbour may be lost but by
    the cut. ``defer_gc`` (the default) defers full collections to the
    phase's end (``defer_full_collections``). Emits the phase line and
    returns it with the daemons' route databases after each step
    (``fibs``) and the kernel launches."""
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
    # 24 daemons share this interpreter's collector: no full collection
    # until the phase ends (``defer_full_collections``)
    restore_gc = defer_full_collections() if defer_gc else (lambda: None)
    probe = LanProbe(fabric_.io)
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
                                 f"{step}, {want} expected (LAN lag up to {probe.all_max} ms, "
                                 f"longest collection {gc_clock.longest_ms} ms)")

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
                   "gc_ms": gc_clock.read()[0] - g0[0], "lan_lag_ms": probe.take(),
                   "threads": threading.active_count()}
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
        progress("flood", seconds=flood_s)
        flood = {"seconds": flood_s, "keys": len(kvs), "nodes": n_nodes,
                 "prefixes": n_prefixes, "oracle_ms": oracle_step("flood"),
                 "routes": len(fibs["flood"][names[0]][1]),
                 "launches": launched_since(l0),
                 "gc_ms": gc_clock.read()[0] - g0[0], "lan_lag_ms": probe.take()}
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
                "gc_ms": gc_clock.read()[0] - g0[0], "lan_lag_ms": probe.take()})
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
                   "gc_ms": gc_clock.read()[0] - g0[0], "lan_lag_ms": probe.take()}
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
        probe.stop()
        fabric_.stop()
        restore_gc()
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
        "gc_deferred": defer_gc, "gc_longest_ms": gc_clock.longest_ms,
        "lan_lag_max_ms": probe.all_max,
        "rss_peak_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "pinned_bytes": pinned,
        "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
        "fallbacks": {k: reg.counter_get(k) - f0[k] for k in fallbacks},
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "seconds": time.perf_counter() - t_phase,
    }
    gc.callbacks.remove(gc_clock._note)
    emit(line)
    return line, fibs, launches


def daemon_fabric_process(start: float, defer_gc: bool = True):
    """``daemon_fabric_phase`` at full size with Decision on the card, in
    a process of its own (the 24 daemons' threads and heaps stay apart
    from the other phases'); ``start`` is the script's ``_START``,
    ``defer_gc`` the phase's. Returns the phase's kernel launches."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    import torch

    from openr_tpu_torch.kernels import _build

    _build.library()
    print(nvidia_smi_line(), flush=True)
    aot0 = aot_snapshot()
    _, _, launches = daemon_fabric_phase(port_modules(torch.device("cuda")), FABRIC,
                                         FABRIC_LSDB_NODES, FABRIC_EVENTS, deployed_spark_config(),
                                         FABRIC_CUT, defer_gc=defer_gc)
    committed_line("daemon-fabric", aot0, events=FABRIC_EVENTS)
    return launches


def free_port() -> int:
    """A TCP port no one listens on now: bound on port 0, then closed."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class DaemonProcess:
    """``python -m <module> --config <file>`` (the port's daemon unless a
    test names another) started from the checkout's root, its output going
    to a file (a pipe no one reads would block it), its configuration and
    persistent store in a directory of its own. ``device`` None runs
    Decision on the card (no ``--device``)."""

    def __init__(self, node, workdir, device=None, module="openr_tpu_torch.main", env=None):
        self.node = node
        self.workdir = Path(workdir)
        self.device = device
        self.module = module
        self.env = env
        self.log_path = self.workdir / "daemon.log"
        self.proc = None
        self._log = None

    def start(self) -> float:
        """Start the daemon on fresh ports (once more when a port was taken
        in between) and wait until it answers ``getMyNodeName`` on the
        OpenrCtrl thrift wire; the seconds from the start until then."""
        for attempt in range(2):
            self.ctrl_port, self.peer_port = free_port(), free_port()
            config = {
                "node_name": self.node, "openr_ctrl_port": self.ctrl_port,
                "kvstore": {"peer_port": self.peer_port},
                "enable_watchdog": True,
                "watchdog": {"interval_s": 5.0, "max_memory_mb": DAEMON_MAX_MEMORY_MB},
                "persistent_store_path": str(self.workdir / f"store-{attempt}.bin"),
            }
            cfg = self.workdir / "openr.json"
            cfg.write_text(json.dumps(config))
            argv = [sys.executable, "-m", self.module, "--config", str(cfg)]
            if self.device is not None:
                argv += ["--device", str(self.device)]
            self._log = open(self.log_path, "ab")
            t0 = time.perf_counter()
            self.proc = subprocess.Popen(argv, cwd=ROOT, stdout=self._log,
                                         stderr=subprocess.STDOUT, env=self.env)
            if self._wait_name(DAEMON_BOOT_S):
                return time.perf_counter() - t0
            if attempt == 0 and "Address already in use" in self.log_tail():
                self.kill()
                continue
            raise AssertionError(f"daemon-process: the daemon did not answer getMyNodeName "
                                 f"(exit {self.proc.poll()}):\n{self.log_tail()}")
        raise AssertionError("unreachable")

    def _wait_name(self, timeout_s) -> bool:
        from openr_tpu_torch.ctrl.thrift_ctrl import ThriftCtrlClient

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and self.proc.poll() is None:
            try:
                client = ThriftCtrlClient("127.0.0.1", self.ctrl_port, timeout_s=10.0)
            except OSError:
                time.sleep(0.05)
                continue
            try:
                return client.call("getMyNodeName") == self.node
            except OSError:
                time.sleep(0.05)
            finally:
                client.close()
        return False

    def log_tail(self, n: int = 40) -> str:
        try:
            return "\n".join(self.log_path.read_text(errors="replace").splitlines()[-n:])
        except OSError:
            return ""

    def stop(self, timeout_s=DAEMON_STOP_S):
        """SIGTERM, then wait up to ``timeout_s``: the exit code and seconds."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        return rc, time.perf_counter() - t0

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        if self._log is not None:
            self._log.close()
            self._log = None


def compute_apps():
    """The card's ``nvidia-smi --query-compute-apps=pid,used_memory``
    rows. On the machine with the card the pid column is its PID
    namespace's (every row reads 1), not the daemon's pid: a process that
    holds the card shows as one row more while it runs."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in proc.stdout.splitlines() if line.strip()]


def route_db_canonical(wire_db):
    """A route database's thrift struct, as ``route_db_to_wire`` gives it
    and the wire decodes it, with each route's next hops in one order (a
    route keeps them in a set, whose order is the process's own); two
    equal route databases give equal structs."""
    for route in wire_db.get("unicastRoutes", []) + wire_db.get("mplsRoutes", []):
        route["nextHops"].sort(key=repr)
    return wire_db


def daemon_process_phase(nodes, roots, events, device=None):
    """``daemon-process``, one leg: a daemon process (``DaemonProcess``)
    booted, flooded with the generator's LSDB of ``fat_tree_nodes(nodes)``
    over the KvStore thrift peer wire, asked ``getRouteDbComputed`` for
    each of ``roots`` over the OpenrCtrl thrift wire, sent ``events`` of
    the generator's events, asked once through breeze, and stopped with
    ``SIGTERM``. Every answer must equal the host oracle's over this
    process's own databases. ``device`` None is the card; the CPU
    rehearsal passes ``"cpu"``. Emits the leg's line and returns it."""
    import shutil
    import socket
    import tempfile

    from openr_tpu_torch.ctrl.thrift_ctrl import ThriftCtrlClient
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.decision.rib import DecisionRouteDb
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.kernels import LAUNCHES
    from openr_tpu_torch.kvstore.thrift_peer import ThriftPeerTransport
    from openr_tpu_torch.load.generator import LoadGenerator
    from openr_tpu_torch.messaging.queue import ReplicateQueue
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.types import TTL_INFINITY, KeySetParams, Publication, Value
    from openr_tpu_torch.utils import thrift_compact as tc
    from openr_tpu_torch.utils import wire

    phase = "daemon-process"
    on_card = device is None
    t_phase = time.perf_counter()
    topo = topologies.fat_tree_nodes(nodes)
    gen = LoadGenerator(topo, seed=PIPELINE_SEED)
    kvs = gen.initial_key_vals()
    n_nodes = len(topo.adj_dbs)
    n_prefix_dbs = len(topo.prefix_dbs)
    # the oracle's databases: this process's own Decision on the host,
    # fed the same values by process_publication, never started
    kv_q = ReplicateQueue(name="oracle:kvstore")
    oracle_dec = Decision(DAEMON_NODE, kvstore_updates_queue=kv_q,
                          route_updates_queue=ReplicateQueue(name="oracle:routes"),
                          solver_backend="host", device="cpu")
    workdir = tempfile.mkdtemp(prefix="openr-daemon-")
    daemon = DaemonProcess(DAEMON_NODE, workdir, device)
    ctrl = peer = None

    def oracle(root):
        l0 = dict(LAUNCHES)
        db = SpfSolver(root, backend="host", device="cpu").build_route_db(
            root, oracle_dec.area_link_states, oracle_dec.prefix_state) or DecisionRouteDb()
        if dict(LAUNCHES) != l0:
            raise AssertionError(f"{phase}: the host oracle launched a kernel")
        return route_db_canonical(tc.route_db_to_wire(db.to_route_db(root)))

    def answer(root):
        """The daemon's answer for ``root`` (``route_db_canonical``), the
        ms until it was received and decoded, and when it was received
        (``perf_counter``)."""
        t0 = time.perf_counter()
        wire_db = ctrl.call("getRouteDbComputed", nodeName=root)
        received = time.perf_counter()
        return route_db_canonical(wire_db), (received - t0) * 1e3, received

    def counters():
        return ctrl.call("getCounters")

    def took_in(c):
        return c.get("decision.adj_db_update", 0) + c.get("decision.prefix_db_update", 0)

    def fail(msg):
        raise AssertionError(f"{phase} ({nodes} nodes): {msg}\n--- daemon log ---\n"
                             f"{daemon.log_tail()}")

    def progress(step, **fields):
        print(json.dumps({"daemon_process_step": step, "nodes": nodes,
                          "t_s": time.perf_counter() - t_phase, **fields}),
              file=sys.stderr, flush=True)

    try:
        # 1. boot: from Popen until the ctrl wire answers getMyNodeName
        apps_before = compute_apps() if on_card else None
        boot_s = daemon.start()
        ctrl = ThriftCtrlClient("127.0.0.1", daemon.ctrl_port, timeout_s=120.0)
        peer = ThriftPeerTransport("127.0.0.1", daemon.peer_port, timeout_s=120.0)
        progress("boot", seconds=boot_s)

        # 2. the flood, as a peer floods it, until Decision holds every node
        items = list(kvs.items())
        oracle_dec.process_publication(Publication(key_vals=dict(kvs), area="0"))
        # this process's heap (the oracle's databases) out of the collector's
        # reach until the leg ends: a full collection over it took seconds
        # an answer at 10 000 nodes, in this process's decode and compare
        gc.freeze()
        t0 = time.perf_counter()
        for i in range(0, len(items), DAEMON_BATCH):
            peer.set_key_vals("0", KeySetParams(key_vals=dict(items[i:i + DAEMON_BATCH])))
        sent_s = time.perf_counter() - t0
        deadline = time.monotonic() + DAEMON_FLOOD_S
        while True:
            c = counters()
            if (c.get("decision.adj_db_update", 0) >= n_nodes
                    and c.get("decision.prefix_db_update", 0) >= n_prefix_dbs
                    and len(ctrl.call("getDecisionAdjacencyDbs")) == n_nodes):
                break
            if time.monotonic() > deadline or daemon.proc.poll() is not None:
                fail(f"the flood never reached Decision ({took_in(c)} of {len(kvs)} keys)")
            time.sleep(0.05)
        flood_s = time.perf_counter() - t0
        progress("flood", seconds=flood_s)

        # 3. answers for each root, each equal to the oracle's
        c_before = counters()
        seen, answers = set(), []
        for root in roots:
            got, ms, _ = answer(root)
            if got != oracle(root):
                fail(f"getRouteDbComputed({root}) differs from the host oracle")
            answers.append({"root": root, "ms": ms, "cold": root not in seen,
                            "routes": len(got["unicastRoutes"])})
            seen.add(root)
            progress("answer", root=root, ms=ms)

        # 4. events, each until Decision took it in and the answer holds it
        event_rows = []
        for step in range(events):
            ev = gen.next_event()
            value = Value(version=ev.version, originator_id=ev.node, value=ev.payload,
                          ttl=TTL_INFINITY,
                          hash=wire.generate_hash(ev.version, ev.node, ev.payload))
            oracle_dec.process_publication(Publication(key_vals={ev.key: value}, area="0"))
            want = oracle(DAEMON_EVENT_ROOT)
            before = took_in(counters())
            t0 = time.perf_counter()
            peer.set_key_vals("0", KeySetParams(key_vals={ev.key: value}))
            # the clock runs until the answer that holds the event is
            # received, less this process's own handling of the answers
            # before it, which is not the daemon's
            excluded, polls = 0.0, 0
            while True:
                if took_in(counters()) > before:
                    got, _, received = answer(DAEMON_EVENT_ROOT)
                    polls += 1
                    if got == want:
                        event_ms = (received - t0 - excluded) * 1e3
                        break
                    excluded += time.perf_counter() - received
                if time.perf_counter() - t0 - excluded > DAEMON_EVENT_S:
                    fail(f"event {step} ({ev.kind} {ev.key}): the answer for "
                         f"{DAEMON_EVENT_ROOT} never equalled the oracle's")
                time.sleep(0.005)
            event_rows.append({"kind": ev.kind, "key": ev.key, "event_ms": event_ms,
                               "polls": polls})
            progress("event", **event_rows[-1])
        c_after = counters()

        # 5. breeze, as an operator asks for the same routes
        dests = [tc._ip_prefix_from_wire(r["dest"]).to_str()
                 for r in answer(DAEMON_EVENT_ROOT)[0]["unicastRoutes"]]
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "openr_tpu_torch.cli.breeze", "--port", str(daemon.ctrl_port),
             "decision", "routes", "--node", DAEMON_EVENT_ROOT],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        breeze_ms = (time.perf_counter() - t0) * 1e3
        if cli.returncode != 0:
            fail(f"breeze exited {cli.returncode}: {cli.stderr[-2000:]}")
        listed = set(cli.stdout.split())
        missing = [d for d in dests if d not in listed]
        if missing or not dests:
            fail(f"breeze did not list {len(missing)} of {len(dests)} destinations, "
                 f"{missing[:3]}")

        # 6. counters, the card, the resident set
        dispatches = c_after.get("ops.host_dispatches", 0) - c_before.get("ops.host_dispatches", 0)
        # a counter is made at its first bump: absent is 0
        fallbacks = {k: c_after.get(k, 0) for k in DAEMON_FALLBACKS}
        if any(fallbacks.values()):
            fail(f"fallback counters moved: {fallbacks}")
        if on_card and dispatches <= 0:
            fail(f"ops.host_dispatches rose by {dispatches} over the answers and events")
        apps = compute_apps() if on_card else None
        if on_card and len(apps) != len(apps_before) + 1:
            fail(f"the card's compute apps did not gain the daemon: {apps_before} -> {apps}")
        # the daemon's own resident set: its peak (ru_maxrss) and now (the
        # figure its watchdog holds against watchdog.max_memory_mb)
        c_end = counters()
        rss_peak, rss_now = c_end["process.rss_peak_bytes"], c_end["process.rss_bytes"]

        # 7. stop: SIGTERM, exit 0 within DAEMON_STOP_S
        ctrl.close()
        peer.close()
        ctrl = peer = None
        rc, stop_s = daemon.stop()
        if rc != 0:
            fail(f"after SIGTERM the daemon exited {rc} ({stop_s:.1f} s)")
    finally:
        for client in (ctrl, peer):
            if client is not None:
                client.close()
        daemon.kill()
        kv_q.close()
        gc.unfreeze()
    shutil.rmtree(workdir, ignore_errors=True)
    cold = [a["ms"] for a in answers if a["cold"]]
    warm = [a["ms"] for a in answers if not a["cold"]]
    times = [r["event_ms"] for r in event_rows]
    line = {
        "phase": phase, "nodes": n_nodes, "keys": len(kvs), "seed": PIPELINE_SEED,
        "device": "card" if on_card else str(device), "node": DAEMON_NODE,
        "has_ipv6": socket.has_ipv6, "boot_s": boot_s, "flood_s": flood_s,
        "flood_send_s": sent_s, "batch": DAEMON_BATCH, "answers": answers,
        "answer_ms": {"cold": cold, "repeated": warm},
        "event_ms": {"p50": statistics.median(times) if times else None,
                     "max": max(times) if times else None},
        "events": event_rows, "parity_with_host_oracle": True,
        "breeze": {"ms": breeze_ms, "routes": len(dests)},
        "host_dispatches": dispatches,
        "blocking_syncs": (c_after.get("ops.blocking_syncs", 0)
                           - c_before.get("ops.blocking_syncs", 0)),
        "fallbacks": fallbacks,
        "pid": daemon.proc.pid, "compute_apps": {"before": apps_before, "running": apps},
        "rss_peak_bytes": rss_peak, "rss_bytes": rss_now,
        "watchdog_max_memory_mb": DAEMON_MAX_MEMORY_MB, "stop_s": stop_s, "exit_code": rc,
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(line)
    return line


def daemon_process_process(start: float):
    """Both legs of ``daemon-process`` on the card, driven from a process
    of its own (its heap and garbage collections apart from the other
    phases'); ``start`` is the script's ``_START``."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    return [daemon_process_phase(**leg) for leg in DAEMON_LEGS]


def sweep_100k_process(start: float):
    """``sweep-100k`` at full size on the card, in a process of its own so
    the 100 000-node LinkState leaves with it; ``start`` is the script's
    ``_START``. Returns ``sweep_huge_phase``'s ``(launches, kernel row)``."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    import torch

    aot0 = aot_snapshot()
    out = sweep_huge_phase(torch.device("cuda"), SWEEP_100K_NODES, SWEEP_100K_BLOCK,
                           SWEEP_100K_CHECKED, SWEEP_100K_WORKERS)
    committed_line("sweep-100k", aot0)
    emit({"phase": "profiler", "process": "sweep-100k", **profiler_summary()})
    return out


def _huge_link_state(nodes):
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies

    topo = topologies.fat_tree_nodes(nodes)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    return ls


def _huge_tables_worker(nodes, names):
    """A worker of ``sweep_huge_phase``: its own link state, then
    ``run_spf`` from each of ``names`` as plain data: destination ->
    (metric, next-hop names)."""
    ls = _huge_link_state(nodes)
    return {nm: {dst: (r.metric, set(r.next_hops)) for dst, r in ls.run_spf(nm).items()
                 if dst != nm} for nm in names}


def _huge_replica_worker(nodes, checked, seed):
    """A worker of ``sweep_huge_phase``: its own link state and out-ELL
    graph (the same compile as the phase's), then ``checked`` seeded
    destinations and the numpy replica's digests and next-hop totals of
    those rows."""
    import numpy as np

    from openr_tpu_torch.ops import host_sweep, route_sweep

    graph = route_sweep.compile_out_ell(_huge_link_state(nodes))
    rng = np.random.default_rng(seed)
    t_ids = np.sort(rng.choice(graph.n, size=checked, replace=False)).astype(np.int32)
    ovh = np.asarray(graph.overloaded, dtype=bool)
    d_rows = host_sweep._block_fixed_point(graph, ovh, t_ids)
    nh = host_sweep._block_nh_counts(graph, ovh, d_rows, t_ids)
    digests = route_sweep.host_digest(d_rows, nh, route_sweep.canonical_pos_weights(graph))
    return t_ids, digests, nh.sum(axis=1, dtype=np.int32)


def _huge_card_work(dev, graph, samples, block, rng, clock, phase):
    """The card's part of ``sweep_huge_phase``: ``rev_band_relax`` at the
    graph's out-bands for the first block against its plain version
    (``rev_relax_row``, timed on the card), then the sweep. Returns
    ``(launches, kernel row, result, sweep fields)``."""
    import numpy as np
    import torch

    from openr_tpu_torch.kernels import LAUNCHES, _build, reset_launches
    from openr_tpu_torch.ops import route_sweep
    from openr_tpu_torch.telemetry import get_registry

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    max_err = [0]

    def compare(name, got, want, what):
        sync()
        err = int((got.long() - want.long()).abs().max().item())
        max_err[0] = max(max_err[0], err)
        if err:
            raise AssertionError(f"{phase}: {name} differs from its plain version at {what}")

    if on_card:
        _build.library()
    kernel_row = rev_relax_row(dev, graph, np.arange(block, dtype=np.int32), rng, compare,
                               phase, SWEEP_100K_REPS, band_reps=SWEEP_100K_REPS)
    kernel_row["max_abs_err"] = max_err[0]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the sweep through the entry point a user calls
    sweeper = route_sweep.RouteSweeper(graph, samples, device=dev)
    reset_launches()
    gc0 = clock.read()[0]
    syncs0 = get_registry().counter_get("ops.blocking_syncs")
    sync()
    t0 = time.perf_counter()
    result = sweeper.sweep(block=block)
    sync()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    sweep_syncs = get_registry().counter_get("ops.blocking_syncs") - syncs0
    launches = dict(LAUNCHES)
    sweep_gc_ms = clock.read()[0] - gc0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card and launches["rev_band_relax"] == 0:
        raise AssertionError(f"{phase}: the sweep launched no rev_band_relax")
    stray = {k: v for k, v in launches.items() if k != "rev_band_relax" and v}
    if stray:
        raise AssertionError(f"{phase}: the sweep launched {stray}")
    return launches, kernel_row, result, {
        "sweep_ms": sweep_ms, "sweep_gc_ms": sweep_gc_ms, "max_memory_allocated": peak,
        "block_hops": sweeper.block_hops[: -(-graph.n_pad // block)], "sweeper": sweeper,
        "blocking_syncs": sweep_syncs,
        "blocking_syncs_per_block": sweep_syncs / -(-graph.n_pad // block),
    }


def sweep_huge_phase(dev, nodes, block, checked, workers, phase="sweep-100k"):
    """``sweep-100k``: the ELL all-sources route sweep of the north star's
    size (``fat_tree_nodes(100000)``, ``BASELINE.json`` configs[4]) on
    ``dev``, ``block`` destinations a block. The route engine does not run
    here: its resident DR would be 100096^2 int32, 40 GB
    (``ENGINE_MAX_NODES``). First ``rev_band_relax`` at this graph's
    out-bands and block against its plain version (each band with two
    overload masks, and one step; the wide band's k of 8192 among them),
    timed on the card; then the sweep through ``RouteSweeper``, one sample
    route table per tier against ``run_spf``, and ``checked`` seeded
    destinations' digests and next-hop totals against the port's numpy
    replica (``ops/host_sweep.py``) of those rows; one more block
    profiled. Returns ``(launches, kernel row)``. The sizes are arguments
    so a rehearsal runs it small on the CPU. The host oracles
    (``run_spf``, the replica) run in ``workers`` spawned processes
    started first, each building its own link state, while this process
    builds its own and the card works."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from openr_tpu_torch.ops import route_sweep

    samples = list(ENGINE_SAMPLES)
    t_oracle = time.perf_counter()
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    table_futures = [pool.submit(_huge_tables_worker, nodes, [nm]) for nm in samples]
    replica_future = pool.submit(_huge_replica_worker, nodes, checked, SWEEP_100K_SEED)
    try:
        rng = np.random.default_rng(SWEEP_100K_SEED)
        clock = GcClock()
        t0 = time.monotonic()
        ls = _huge_link_state(nodes)
        setup_s = time.monotonic() - t0
        t0 = time.perf_counter()
        graph = route_sweep.compile_out_ell(ls)
        compile_ms = (time.perf_counter() - t0) * 1e3
        launches, kernel_row, result, sweep = _huge_card_work(
            dev, graph, samples, block, rng, clock, phase)
        # one sample route table per tier against the host Dijkstra, and
        # the seeded destinations against the numpy replica of those rows
        t0 = time.perf_counter()
        tables = {}
        for future in table_futures:
            tables.update(future.result())
        t_ids, digests, totals = replica_future.result()
        oracle_wait_ms = (time.perf_counter() - t0) * 1e3
        oracle_ms = (time.perf_counter() - t_oracle) * 1e3
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for nm in samples:
        if result.routes_from(nm) != tables[nm]:
            raise AssertionError(f"{phase}: route table of {nm} differs from run_spf")
    if not (np.array_equal(digests, result.digests[t_ids])
            and np.array_equal(totals, result.nh_totals[t_ids])):
        raise AssertionError(f"{phase}: digests or next-hop totals differ from host_sweep")
    n_blocks = -(-graph.n_pad // block)
    sweeper = sweep.pop("sweeper")
    profiled_block = {}
    if dev.type == "cuda":
        # one more block under the profiler: busy time, idle share, kernel
        ids = torch.arange(block, dtype=torch.int32, device=dev)
        sweeper.solve_block(ids).cpu()
        stats, _, wall = profiled(torch, lambda: sweeper.solve_block(ids).cpu(),
                                  lambda st, _: lacking(st, KERNEL_KEYS["rev_band_relax"]))
        busy = device_us(stats, "a call") / 1e3
        profiled_block = {
            "profiled_block_ms": wall, "block_device_busy_ms": busy,
            "block_device_idle_share": 1 - busy / wall,
            "block_kernel_ms": device_us(stats, KERNEL_KEYS["rev_band_relax"]) / 1e3,
            "block_top_device_ms": top_device_ms(stats),
        }
    emit({
        "phase": phase, "nodes": graph.n, "n_pad": graph.n_pad, "block": block,
        "blocks": n_blocks, "samples": samples,
        "parity_with_host_oracle": "sample route tables (run_spf) and "
        f"{checked} destinations' digests and next-hop totals (host_sweep)",
        "setup_s": setup_s, "compile_ms": compile_ms,
        "ell_bands": [[bd.rows, bd.k] for bd in graph.bands],
        **sweep, "oracle_workers": workers, "oracle_ms": oracle_ms,
        "oracle_wait_ms": oracle_wait_ms, "launches": launches, **profiled_block,
    })
    return launches, kernel_row


def rev_relax_row(dev, graph, t_ids, rng, compare, what, reps, band_reps=0):
    """``rev_band_relax`` at ``graph``'s out-bands for the destination
    rows ``t_ids`` (int32 numpy [B]) against its plain version exactly,
    ``compare(name, got, want, what)`` raising on a difference: the rows
    two relax hops from the unit init (finite and INF distances mixed),
    each band under the graph's overload mask and under a random one
    onto whose nodes every fourth destination is moved (the v == t
    exception), then one whole relax step. On the card the step is timed
    over ``reps`` calls (profiler device ms of the kernel and of the
    plain version, CUDA-event ms of both), and with ``band_reps`` each
    band too. Returns the row: shape, each band's launch plan (and
    times), the step's times and its bound."""
    import numpy as np
    import torch

    from openr_tpu_torch.ops import route_sweep
    from openr_tpu_torch.ops.minplus import INF
    from openr_tpu_torch.ops.rev_relax import launch_plan, rev_band_relax, rev_band_relax_plain

    on_card = dev.type == "cuda"
    key = KERNEL_KEYS["rev_band_relax"]
    rb = len(t_ids)
    v_t = tuple(torch.from_numpy(v).to(dev) for v in graph.src)
    w_t = tuple(torch.from_numpy(w).to(dev) for w in graph.w)
    ov = torch.from_numpy(graph.overloaded).to(dev)
    tt = torch.from_numpy(t_ids).to(dev)
    dr = torch.full((rb, graph.n_pad), INF, dtype=torch.int32, device=dev)
    dr[torch.arange(rb, device=dev), tt.long()] = 0
    for _ in range(2):
        dr = route_sweep._rev_relax(dr, graph.bands, v_t, w_t, ov, tt)
    ov_np = rng.random(graph.n_pad) < 0.05
    t_moved = t_ids.copy()
    t_moved[::4] = rng.choice(np.flatnonzero(ov_np), size=t_moved[::4].shape)
    masks = ((ov, tt), (torch.from_numpy(ov_np).to(dev), torch.from_numpy(t_moved).to(dev)))
    out = torch.empty_like(dr)
    bands, pos = [], 0
    for band, v_b, w_b in zip(graph.bands, v_t, w_t):
        for ovm, t_m in masks:
            compare("rev_band_relax", rev_band_relax(dr, v_b, w_b, t_m, ovm, pos, out),
                    rev_band_relax_plain(dr, v_b, w_b, t_m, ovm, pos), f"{what} out-band {band}")
        plan = launch_plan(rb, band.rows, band.k)
        row = {"rows": band.rows, "k": band.k,
               "plan": {"body": "wide" if plan.wide else "narrow", "chunk": plan.chunk,
                        "grid": list(plan.grid)},
               "least_ms": band_least_ms(rb, band.rows, band.k)}
        if on_card and band_reps:
            row["kernel_ms"] = device_ms(
                torch, lambda: rev_band_relax(dr, v_b, w_b, tt, ov, pos, out), band_reps, key,
                records=1)
            row["plain_ms"] = device_ms(
                torch, lambda: rev_band_relax_plain(dr, v_b, w_b, tt, ov, pos), band_reps)
        bands.append(row)
        pos += band.rows
    del out, masks

    def step_kernel():
        return route_sweep._rev_relax(dr, graph.bands, v_t, w_t, ov, tt)

    def step_plain():
        res = torch.empty_like(dr)
        at = 0
        for band, v_b, w_b in zip(graph.bands, v_t, w_t):
            res[:, at : at + band.rows] = rev_band_relax_plain(dr, v_b, w_b, tt, ov, at)
            at += band.rows
        res[:, at:] = dr[:, at:]
        return res

    compare("rev_band_relax", step_kernel(), step_plain(), f"{what}: one reversed relax step")
    slots = sum(band.rows * band.k for band in graph.bands)
    # each input read once: the destination rows, the band slots (v + w),
    # the overload mask, the destination ids; each output written once:
    # the band columns. One add and one min per gathered slot and row.
    bound, by = bound_ms(4 * rb * graph.n_pad + 8 * slots + graph.n_pad + 4 * rb
                         + 4 * rb * graph.n, 2 * rb * slots)
    row = {"shape": {"B": rb, "n_pad": graph.n_pad, "distinct_t": int(len(np.unique(t_ids))),
                     "bands": [[bd.rows, bd.k] for bd in graph.bands]},
           "bands": bands, "bound_ms": bound, "bound_by": by}
    if on_card:
        row.update({
            "kernel_ms": device_ms(torch, step_kernel, reps, key,
                                   parts_ms=sum(b.get("kernel_ms", 0.0) for b in bands),
                                   records=len(graph.bands)),
            "plain_ms": device_ms(torch, step_plain, reps),
            "call_ms": time_ms(torch, step_kernel, reps),
            "plain_call_ms": time_ms(torch, step_plain, reps, warmup=1),
        })
    return row


def grouped_rows(dev, graph, t_ids, compare, what, reps, seg_reps=0):
    """``batched_minplus`` and ``batched_minplus_t`` at ``graph``'s
    segments for the destination rows ``t_ids`` (int32 numpy [B]): the
    segments' masked source tables of those rows, two grouped relax hops
    from the unit init, in each kernel's layout, each segment against the
    plain version exactly (``compare`` as for ``rev_relax_row``). On the
    card one step (every segment) is timed over ``reps`` calls (profiler
    device ms of the kernel and of the plain version, CUDA-event ms of
    both), and with ``seg_reps`` each segment too. Returns ``{kernel:
    row}``: shape, each segment's launch plan (and time), the step's times
    and its bound."""
    import torch

    from openr_tpu_torch.ops import spf_grouped
    from openr_tpu_torch.ops.grouped_minplus import (
        batched_minplus,
        batched_minplus_plain,
        batched_minplus_t,
        batched_minplus_t_plain,
        minplus_plan,
        minplus_t_plan,
    )
    from openr_tpu_torch.ops.minplus import INF

    on_card = dev.type == "cuda"
    rb = len(t_ids)
    g_meta = spf_grouped.band_meta(graph)
    g_src, g_w = spf_grouped.device_tensors(graph, dev)
    g_ov = torch.from_numpy(graph.overloaded).to(dev)
    tt = torch.from_numpy(t_ids).to(dev)
    dg = torch.full((rb, graph.n_pad), INF, dtype=torch.int32, device=dev)
    dg[torch.arange(rb, device=dev), tt.long()] = 0
    for _ in range(2):
        dg = spf_grouped._grouped_relax(dg, g_meta, g_src, g_w, g_ov, tt, spf_grouped.IMPLS[0])
    segs = []
    for src, w in zip(g_src, g_w):
        idx = src.long()
        blocked = g_ov[idx][None] & (src[None] != tt[:, None, None])
        gath = dg[:, idx].masked_fill(blocked, INF)  # [B, G, S]
        segs.append((gath.permute(1, 0, 2).contiguous(),
                     gath.permute(1, 2, 0).contiguous(), w))
    del dg
    shapes = [[int(w.shape[0]), rb, int(w.shape[1]), int(w.shape[2])] for _, _, w in segs]
    # each input read once (the gathered table, the weights), each output
    # written once; one add and one min per (g, b, s, r)
    bound, by = bound_ms(sum(4 * (g_ * b_ * s_g + g_ * s_g * r_ + g_ * b_ * r_)
                             for g_, b_, s_g, r_ in shapes),
                         sum(2 * g_ * b_ * s_g * r_ for g_, b_, s_g, r_ in shapes))
    rows = {}
    for name, kern, plain, layout in (
            ("batched_minplus", batched_minplus, batched_minplus_plain, 0),
            ("batched_minplus_t", batched_minplus_t, batched_minplus_t_plain, 1)):
        key = KERNEL_KEYS[name]
        seg_rows = []
        for seg, shape in zip(segs, shapes):
            compare(name, kern(seg[layout], seg[2]), plain(seg[layout], seg[2]),
                    f"{what} segment {shape}")
            plan = (minplus_t_plan if layout else minplus_plan)(*shape)
            # a split S adds the reduce kernel's record
            row = {"shape": shape,
                   "plan": {k: list(v) if k == "grid" else v
                            for k, v in plan._asdict().items() if k != "scratch_shape"},
                   "records": 1 + (plan.splits > 1)}
            if on_card and seg_reps:
                row["kernel_ms"] = device_ms(
                    torch, lambda seg=seg: kern(seg[layout], seg[2]), seg_reps, key,
                    records=row["records"])
            seg_rows.append(row)

        def step_kernel(kern=kern, layout=layout):
            return [kern(seg[layout], seg[2]) for seg in segs]

        def step_plain(plain=plain, layout=layout):
            return [plain(seg[layout], seg[2]) for seg in segs]

        row = {"shape": {"segments_GBSR": shapes}, "segments": seg_rows,
               "bound_ms": bound, "bound_by": by}
        if on_card:
            row.update({
                "kernel_ms": device_ms(torch, step_kernel, reps, key,
                                       parts_ms=sum(r.get("kernel_ms", 0.0) for r in seg_rows),
                                       records=sum(r["records"] for r in seg_rows)),
                "plain_ms": device_ms(torch, step_plain, reps),
                "call_ms": time_ms(torch, step_kernel, reps),
                "plain_call_ms": time_ms(torch, step_plain, reps, warmup=1),
            })
        rows[name] = row
    return rows


def engine_kernel_shapes(dev, ls, rng, compare):
    """``rev_band_relax`` and ``batched_minplus(_t)`` at the route engine's
    shapes over ``ls``'s graphs (``rev_relax_row``, ``grouped_rows``):
    churn buckets of 32 and 1024 destination rows with scattered, repeated
    ids (the detection pads a bucket with its first affected id), and the
    full width, B = n_pad (cold build, frontier re-solve, overflow chain).
    ``compare(name, got, want, what)`` raises on a difference. Returns
    ``{kernel: {cell: row}}``."""
    import numpy as np

    from openr_tpu_torch.ops import route_sweep, spf_grouped

    eng_out = route_sweep.compile_out_ell(ls)
    eng_grp = spf_grouped.compile_out_grouped(ls)
    engine_kernel = {"rev_band_relax": {}, "batched_minplus": {}, "batched_minplus_t": {}}
    for label, rb in (("b32", 32), ("b1024", min(1024, eng_out.n_pad)), ("full", eng_out.n_pad)):
        if rb == eng_out.n_pad:
            t_np = np.arange(rb, dtype=np.int32)
        else:
            t_np = rng.choice(eng_out.n, size=rb // 2, replace=False).astype(np.int32)
            t_np = np.concatenate([t_np, np.repeat(t_np[:1], rb - len(t_np))])
        reps = max(3, REPS // (1 + rb // 2048))
        what = f"engine {label}"
        engine_kernel["rev_band_relax"][label] = rev_relax_row(
            dev, eng_out, t_np, rng, compare, what, reps)
        for name, row in grouped_rows(dev, eng_grp, t_np, compare, what, reps).items():
            engine_kernel[name][label] = row
    return engine_kernel


def engine_rows(result):
    """A route product's rows in node-name order, independent of its
    layout's node and slot numbering: ``(names, digests, next-hop totals,
    sample metrics [n, S], next hops)``, the next hops as one dict a
    sample, neighbour name -> bool column [n] (a column without a set
    bit left out)."""
    import numpy as np

    graph = result.graph
    names = np.asarray(graph.node_names[: graph.n])
    order = np.argsort(names)
    k = result.samp_v.shape[1]
    slots = np.arange(k)
    hops = []
    for s in range(result.sample_masks.shape[1]):
        words = result.sample_masks[order, s, :]
        bits = ((words[:, slots // 32] >> (slots % 32).astype(np.uint32)) & 1).astype(bool)
        cols = {}
        for slot in np.flatnonzero(bits.any(axis=0)):
            nbr = graph.node_names[int(result.samp_v[s, slot])]
            cols[nbr] = cols[nbr] | bits[:, slot] if nbr in cols else bits[:, slot]
        hops.append(cols)
    return (names[order], result.digests[order], result.nh_totals[order],
            result.sample_metrics[order], hops)


def engine_rows_differ(a, b):
    """Bool [n] in name order: the destinations whose rows differ between
    two ``engine_rows`` of the same node set."""
    import numpy as np

    if not np.array_equal(a[0], b[0]):
        raise AssertionError("the route products hold different node sets")
    diff = (a[1] != b[1]) | (a[2] != b[2]) | (a[3] != b[3]).any(axis=1)
    for ha, hb in zip(a[4], b[4]):
        for nbr in set(ha) | set(hb):
            none = np.zeros(len(a[0]), dtype=bool)
            diff |= ha.get(nbr, none) != hb.get(nbr, none)
    return diff


def autotune_lines(dev, rng, compare, minplus_shapes, ell_geometries):
    """One ``autotune`` line a family and shape on the main path: every
    candidate launch plan of the kernels (``ops/autotune.py``) checked
    against the plain version on random operands of that shape (through
    ``compare``), then measured by a fresh tuner (CUDA events, the best of
    three after a warm-up): each candidate's ms and the winner. Nothing is
    persisted; the main path runs the plans it runs without "auto"."""
    import numpy as np
    import torch

    from openr_tpu_torch.ops import autotune, spf_grouped
    from openr_tpu_torch.ops.ell_relax import ell_band_relax, ell_band_relax_plain
    from openr_tpu_torch.ops.minplus import INF, minplus, minplus_plain
    from openr_tpu_torch.ops.rev_relax import rev_band_relax, rev_band_relax_plain

    def rand(shape, hi, p_inf=0.3):
        x = torch.from_numpy(rng.integers(0, hi, size=shape, dtype=np.int32)).to(dev)
        return torch.where(torch.from_numpy(rng.random(shape) < p_inf).to(dev), INF, x)

    tuner = autotune.Autotuner(persist=False)
    saved = autotune.get_autotuner()
    autotune.set_autotuner(tuner)
    lines = []
    try:
        for s_, n_ in minplus_shapes:
            a, b = rand((s_, n_), 50), rand((n_, n_), 50)
            want = minplus_plain(a, b)
            for name in autotune._candidates("minplus", dev):
                with autotune.using("minplus", name):
                    compare("minplus", minplus(a, b), want, f"autotune {name} {s_}x{n_}")
            winner = autotune.resolve_minplus((s_, n_), dev)
            lines.append(("minplus", f"{s_}x{n_}", winner))
        for n_, k_ in ell_geometries:
            # the check's band: the plain versions gather [64, rows, k]
            rows = min(n_, 256)
            d = rand((64, n_), 1000)
            src = torch.from_numpy(rng.integers(0, n_, size=(rows, k_), dtype=np.int32)).to(dev)
            w = rand((rows, k_), 20)
            ov = torch.from_numpy(rng.random(n_) < 0.05).to(dev)
            t_ids = torch.from_numpy(rng.integers(0, n_, size=64, dtype=np.int32)).to(dev)
            want_f = ell_band_relax_plain(d, src, w, ov, 0)
            want_r = rev_band_relax_plain(d, src, w, t_ids, ov, 0)
            for name in autotune._candidates("ell_relax", dev):
                out = torch.empty_like(d)
                with autotune.using("ell_relax", name):
                    compare("ell_band_relax", ell_band_relax(d, src, w, ov, 0, out=out),
                            want_f, f"autotune {name} {n_}x{k_}")
                    compare("rev_band_relax", rev_band_relax(d, src, w, t_ids, ov, 0, out=out),
                            want_r, f"autotune {name} {n_}x{k_}")
            winner = autotune.resolve_ell_relax((n_, k_), dev)
            lines.append(("ell_relax", f"{n_}x{k_}", winner))
        winner = autotune.resolve_grouped(spf_grouped._AUTO_PROBE_SHAPE, dev)
        lines.append(("grouped_minplus", "x".join(map(str, spf_grouped._AUTO_PROBE_SHAPE)),
                      winner))
    finally:
        autotune.set_autotuner(saved)
    timings = tuner.timings()
    platform = autotune.platform_name(dev)
    for family, shape, winner in lines:
        emit({"autotune": family, "shape": shape, "winner": winner,
              "default": autotune._DEFAULT[family],
              "ms": timings.get(f"{platform}:{family}:{shape}", {})})
    return lines


def ksp2_committed(ls, engine, state):
    """One fused dispatch of a KSP2 engine's (``ell_all_view_rows``, or
    ``_masked`` on the fast path) on its resident state, warm (no increase
    edge), through the executable cache twice and with its body called
    directly once: the ms of each and whether all three are bit-equal
    (raises if not). Its launches are taken back out of the counts."""
    import numpy as np
    import torch

    from openr_tpu_torch.decision.ksp2_engine import ENGINE_ROW_BUDGET
    from openr_tpu_torch.kernels import LAUNCHES
    from openr_tpu_torch.ops import aot_cache, spf_sparse

    graph = state.graph
    view = spf_sparse.ell_source_batch(graph, ls, engine.src_name)
    srcs, w_sv = spf_sparse._batch_host_args(graph, view)
    ep = np.asarray([engine.sid], np.int32)
    saved = dict(LAUNCHES)
    runs = []
    for how in ("cached", "cached", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with aot_cache.direct() if how == "direct" else contextlib.nullcontext():
            if engine.masks_t is not None:
                d_all, dm, back, hops = spf_sparse.ell_all_view_rows_masked(
                    state, srcs, w_sv, ep, engine.d_prev_dev, engine.masks_t, engine.dm_dev,
                    engine.sid, ENGINE_ROW_BUDGET, inc=[])
            else:
                d_all, back, hops = spf_sparse.ell_all_view_rows(
                    state, srcs, w_sv, ep, engine.d_prev_dev, inc=[])
            packed = back.reap()
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, d_all, packed, hops))
    LAUNCHES.update(saved)
    equal = all(torch.equal(r[1], runs[0][1]) and np.array_equal(r[2], runs[0][2])
                and r[3] == runs[0][3] for r in runs)
    if not equal:
        raise AssertionError("the cached and direct KSP2 dispatches differ")
    return {"dispatch": "ell_all_view_rows_masked" if engine.masks_t is not None
            else "ell_all_view_rows", "first_cached_ms": runs[0][0],
            "cached_ms": runs[1][0], "direct_ms": runs[2][0], "hops": runs[0][3],
            "bit_equal": equal}


# warm events of a phase's committed check: metric bumps of the remote
# rack switch's first uplink (off every shortest path after the first, so
# bucketed), each deferred in an event window, then flushed
COMMITTED_EVENTS = 5
COMMITTED_WARMUP = 2
# drained and undrained after them (the overflow path at 10 000 nodes)
COMMITTED_WIDE_NODE = "fsw-2-0"


def aot_snapshot():
    """The executable cache's counters and the dispatch accounting's, for
    a ``committed`` line's deltas; the card's peak memory starts over, so
    the line's ``max_memory_allocated`` is its phase's."""
    import torch

    from openr_tpu_torch.telemetry import get_registry

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    reg = get_registry()
    return {k: reg.counter_get(k) for k in (
        "ops.aot_compiles", "ops.aot_hits", "ops.aot_fallbacks", "ops.aot_evictions",
        "ops.blocking_syncs",
        "ops.async_reaps", "ops.host_dispatches", "route_engine.budget_retries")}


_COPY_RATE = []


def copy_rate():
    """Bytes a millisecond one device-to-device copy moves on the card
    (read and write counted), the best of 5 copies of 256 MiB timed with
    CUDA events: the rate a replay's copies of its inputs and outputs are
    costed at. Measured once a process."""
    import torch

    if not _COPY_RATE:
        src = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        dst = torch.empty_like(src)
        best = None
        for _ in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            best = ms if best is None else min(best, ms)
        _COPY_RATE.append(2 * src.numel() * src.element_size() / best)
        del src, dst
    return _COPY_RATE[0]


def committed_line(phase, before, events=None, **extra):
    """Emit the ``committed`` line of ``phase``: the executable cache's
    counter deltas since ``before`` (``aot_snapshot``; the cache is not
    cleared between phases, so its keys and buffers carry over, bounded
    by its LRU), the blocking syncs per event when ``events`` is known,
    the graph pool's and the shared input and output buffers' bytes, the
    card's peak memory over the phase, and by tag the bytes a replay
    copies in and out with their cost at the card's measured copy rate
    (``copy_rate``); raises when a capture fell back
    (``ops.aot_fallbacks`` rose)."""
    import torch

    from openr_tpu_torch.ops.aot_cache import get_aot_cache

    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None
    after = aot_snapshot()
    delta = {k: after[k] - before[k] for k in after}
    stats = get_aot_cache().stats()
    rate = copy_rate() if torch.cuda.is_available() and stats["copies"] else None
    copies = {
        tag: dict(c, copy_ms_from_rate=(2 * (c["in_bytes"] + c["out_bytes"]) / rate
                                        if rate else None))
        for tag, c in sorted(stats["copies"].items())
    }
    line = {
        "committed": phase, "aot_compiles": delta["ops.aot_compiles"],
        "aot_hits": delta["ops.aot_hits"], "aot_fallbacks": delta["ops.aot_fallbacks"],
        "aot_evictions": delta["ops.aot_evictions"],
        "blocking_syncs": delta["ops.blocking_syncs"], "async_reaps": delta["ops.async_reaps"],
        "host_dispatches": delta["ops.host_dispatches"],
        "budget_retries": delta["route_engine.budget_retries"],
        "cache_entries": stats["entries"], "pool_bytes": stats["pool_bytes"],
        "input_bytes": stats["input_bytes"], "output_bytes": stats["output_bytes"],
        "poisoned": stats["poisoned"], "max_memory_allocated": peak,
        "copy_bytes_per_ms": rate, "copies": copies,
    }
    if events:
        line["events"] = events
        line["blocking_syncs_per_event"] = delta["ops.blocking_syncs"] / events
    line.update(extra)
    emit(line)
    if delta["ops.aot_fallbacks"]:
        raise AssertionError(f"{phase}: {delta['ops.aot_fallbacks']} dispatches fell back "
                             "from the executable cache")
    return line


def engine_committed(dev, phase, ls, samples, engines, bump, node, drain,
                     events=COMMITTED_EVENTS, warmup=COMMITTED_WARMUP):
    """The committed-dispatch check of an engine phase: beside each cached
    engine of ``engines`` a twin built with its bodies called directly
    (``aot_cache.direct``) on the same LinkState; ``warmup`` then
    ``events`` bumps of ``node`` (``bump(node, metric)`` -> affected),
    each through both engines deferred (``defer_consume=True``) and then
    flushed; then a drain and an undrain of ``COMMITTED_WIDE_NODE``
    (``drain(node, on)`` -> affected), which take the overflow path at
    10 000 nodes, so its full-width bodies run replayed and called
    directly. Per measured event and engine: the path, the deferred call's
    touches and blocking syncs in its event window, the ms of call and
    flush (the card synchronised) cached and direct, whether the two
    engines' rows are bit-equal, and after the cached call the card's
    allocated bytes and the cache's keys (memory held across events).
    Raises when the rows differ, or when a warm bucketed event took more
    than two touches or any blocking sync."""
    import torch

    from openr_tpu_torch.ops import aot_cache, route_engine
    from openr_tpu_torch.ops import dispatch_accounting as da

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    twins = {}
    with aot_cache.direct():
        for label, eng in engines.items():
            if isinstance(eng, route_engine.GroupedRouteSweepEngine):
                twins[label] = route_engine.GroupedRouteSweepEngine(ls, samples, impl=eng.impl,
                                                                    device=dev)
            else:
                twins[label] = route_engine.RouteSweepEngine(ls, samples, device=dev)
    for label, eng in engines.items():
        eng.flush()
    recs = []
    script = [(f"{node} metric {30 + i}", lambda i=i: bump(node, 30 + i))
              for i in range(warmup + events)]
    script += [(f"{COMMITTED_WIDE_NODE} {tag}", lambda on=on: drain(COMMITTED_WIDE_NODE, on))
               for tag, on in (("drain", True), ("undrain", False))]
    for i, (event, make) in enumerate(script):
        aff = make()
        rec = {"event": event, "engines": {}}
        for label, eng in engines.items():
            got = {}
            for how, e in (("cached", eng), ("direct", twins[label])):
                sync()
                t0 = time.perf_counter()
                if how == "direct":
                    with aot_cache.direct(), da.event_window("committed") as win:
                        e.churn(ls, aff, defer_consume=True)
                    with aot_cache.direct():
                        e.flush()
                else:
                    with da.event_window("committed") as win:
                        e.churn(ls, aff, defer_consume=True)
                    e.flush()
                sync()
                got[how] = {"ms": (time.perf_counter() - t0) * 1e3,
                            "touches": win.touches, "blocking_syncs": win.blocking_syncs,
                            "path": e.last_path,
                            "k": e.last_k if e.last_path == "bucket" else None,
                            "memory_allocated": (torch.cuda.memory_allocated()
                                                 if on_card else None),
                            "cache_entries": aot_cache.get_aot_cache().stats()["entries"]}
            equal = not engine_rows_differ(engine_rows(eng.result),
                                           engine_rows(twins[label].result)).any()
            if not equal:
                raise AssertionError(f"{phase} committed: the cached and direct {label} "
                                     f"engines differ after {rec['event']}")
            c = got["cached"]
            if warmup <= i < warmup + events and c["path"] == "bucket" and (
                    c["touches"] > 2 or c["blocking_syncs"]):
                raise AssertionError(f"{phase} committed: a warm bucketed {label} event "
                                     f"took {c['touches']} touches, {c['blocking_syncs']} "
                                     "blocking syncs")
            rec["engines"][label] = {"path": c["path"], "k": c["k"],
                                     "touches": c["touches"],
                                     "blocking_syncs": c["blocking_syncs"],
                                     "cached_ms": c["ms"], "direct_ms": got["direct"]["ms"],
                                     "direct_touches": got["direct"]["touches"],
                                     "bit_equal": equal,
                                     "memory_allocated": c["memory_allocated"],
                                     "cache_entries": c["cache_entries"]}
        if i >= warmup:
            recs.append(rec)
    del twins
    return recs


def engine_phase(dev, phase, nodes, ladder, block, profile, gc_clock=None):
    """``engine-<size>``: the network-wide route engine on ``dev``. One
    fresh LinkState of ``fat_tree_nodes(nodes)`` is shared by three
    engines: the ELL ``RouteSweepEngine`` and the
    ``GroupedRouteSweepEngine`` under each contraction kernel, samples
    ``ENGINE_SAMPLES``. The script's events go to every engine in turn,
    and after each the oracle (a cold ``RouteSweeper.sweep`` on ``dev``
    over a fresh ``compile_out_ell`` of the same LinkState, whose sample
    route tables must equal ``run_spf``'s) must equal every engine row for
    row by node name: digests, next-hop totals, sample metrics and next
    hops (so each sample's ``routes_from`` is the oracle's); each engine's
    moved names must be the destinations whose row changed since the
    previous oracle. With ``ladder`` the
    supervisor's rungs are walked under armed faults (cold, host, then
    healed); ``route_engine.host_fallbacks`` may rise only there. With
    ``profile`` one more event per engine runs under the profiler.
    Returns the engines' kernel launches (the oracle's are not counted).
    The sizes are arguments so a rehearsal runs it small on the CPU."""
    from dataclasses import replace

    import torch

    from openr_tpu_torch.faults.injector import FaultSchedule, get_injector
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import LAUNCHES
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import route_engine, route_sweep, spf_grouped
    from openr_tpu_torch.telemetry import get_registry

    reg = get_registry()
    on_card = dev.type == "cuda"
    clock = gc_clock or GcClock()
    t_phase = time.monotonic()
    aot0 = aot_snapshot()
    topo = topologies.fat_tree_nodes(nodes)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    del topo
    remote = remote_rsw(ls)
    samples = list(ENGINE_SAMPLES)
    setup_s = time.monotonic() - t_phase

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def oracle(routes=True):
        """The cold sweep's rows; with ``routes`` its sample route tables
        are held against ``run_spf``."""
        t0 = time.perf_counter()
        graph = route_sweep.compile_out_ell(ls)
        sweeper = route_sweep.RouteSweeper(graph, samples, device=dev)
        before = dict(LAUNCHES)
        result = sweeper.sweep(block=block)
        for k in LAUNCHES:
            oracle_launches[k] += LAUNCHES[k] - before[k]
        if routes:
            for s in samples:
                want = {dst: (r.metric, set(r.next_hops)) for dst, r in ls.run_spf(s).items()
                        if dst != s}
                if result.routes_from(s) != want:
                    raise AssertionError(f"{phase}: the cold sweep's route table of {s} "
                                         "differs from run_spf")
        oracle_ms.append((time.perf_counter() - t0) * 1e3)
        return engine_rows(result)

    oracle_launches = {k: 0 for k in LAUNCHES}
    oracle_ms = []
    kinds = [("ell", "rev_band_relax")] + [(f"grouped/{impl}", impl)
                                           for impl in spf_grouped.IMPLS]
    engines = {}
    launches = {k: 0 for k in LAUNCHES}
    per_engine = {label: {"launches": {k: 0 for k in LAUNCHES}} for label, _ in kinds}
    for label, kernel in kinds:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = dict(LAUNCHES)
        sync()
        t0 = time.perf_counter()
        if label == "ell":
            eng = route_engine.RouteSweepEngine(ls, samples, device=dev)
        else:
            eng = route_engine.GroupedRouteSweepEngine(ls, samples, impl=kernel, device=dev)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k in LAUNCHES:
            per_engine[label]["launches"][k] += got[k]
            launches[k] += got[k]
        engines[label] = eng
        per_engine[label].update({
            "cold_build_ms": ms, "cold_build_hops": eng.hops_log[-1],
            "n_pad": eng.graph.n_pad,
            "resident_bytes": sum(t.numel() * t.element_size()
                                  for t in (eng._dr, eng._digests_dev, eng._packed_dev)),
            "cold_build_max_memory_allocated":
                torch.cuda.max_memory_allocated() if on_card else None,
        })
    prev = None

    def changed(a, b):
        return sorted(a[0][engine_rows_differ(a, b)])

    def hold(tag, names_by_engine=None, expected=None):
        """Every engine against the oracle of the current LinkState, row
        for row by node name (so each sample's ``routes_from``, which
        reads only those rows, equals the oracle's, which equals
        ``run_spf``'s)."""
        nonlocal prev
        keys = oracle()
        for label, eng in engines.items():
            bad = engine_rows_differ(engine_rows(eng.result), keys)
            if bad.any():
                raise AssertionError(f"{phase} {tag}: the {label} engine differs from the "
                                     f"cold sweep at {int(bad.sum())} destinations, first "
                                     f"{list(keys[0][bad][:3])}")
            if names_by_engine is not None:
                want = expected if expected is not None else changed(keys, prev)
                moved = names_by_engine[label]
                if moved is not None and sorted(moved) != sorted(want):
                    raise AssertionError(
                        f"{phase} {tag}: {label} moved {len(moved)} destinations, the "
                        f"oracle's rows changed at {len(want)}")
        digests = {label: route_sweep.digests_by_name(eng.result)
                   for label, eng in engines.items()}
        if any(d != digests["ell"] for d in digests.values()):
            raise AssertionError(f"{phase} {tag}: the engines disagree by name")
        prev = keys
        return keys

    def counters():
        return {k: reg.counter_get(k) for k in ENGINE_COUNTERS}

    def drive(tag, label, fn):
        """One engine's call: its record (path, rows, readback, ms, hops,
        accounting, frontier, gc) and its result."""
        eng = engines[label]
        before = dict(LAUNCHES)
        c0 = counters()
        gc0 = clock.read()[0]
        hops0 = len(eng.hops_log)
        fr0 = (eng.frontier_resolves, eng.frontier_fallbacks)
        sync()
        t0 = time.perf_counter()
        result = fn(eng)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k in LAUNCHES:
            per_engine[label]["launches"][k] += got[k]
            launches[k] += got[k]
        c1 = counters()
        rec = {
            "path": eng.last_path, "k": eng.last_k if eng.last_path == "bucket" else None,
            "affected": eng.last_affected, "changed": eng.last_delta_rows,
            "readback_bytes": eng.last_readback_bytes, "ms": ms,
            "hops": eng.hops_log[hops0:],
            "counters": {k: c1[k] - c0[k] for k in ENGINE_COUNTERS if c1[k] != c0[k]},
            "launches": {k: v for k, v in got.items() if v},
            "gc_ms": clock.read()[0] - gc0,
        }
        if (eng.frontier_resolves, eng.frontier_fallbacks) != fr0:
            rec["frontier"] = {"rows": eng.last_frontier_rows,
                               "cells": eng.last_frontier_cells,
                               "jumps": eng.last_frontier_jumps}
        return rec, result

    def names_of(result):
        if result is None or isinstance(result, list):
            return result
        return result.names

    def each(tag, fn, expected=None, check=True):
        recs, moved = {}, {}
        for label in engines:
            rec, result = drive(tag, label, fn)
            recs[label] = rec
            moved[label] = names_of(result)
        if check:
            hold(tag, moved, expected)
        events.append({"event": tag, "engines": recs})
        return moved

    def db_of(node):
        return ls.get_adjacency_databases()[node]

    def bumped(node, metric, i=0):
        db = db_of(node)
        adjs = list(db.adjacencies)
        adjs[i] = replace(adjs[i], metric=metric)
        return replace(db, adjacencies=tuple(adjs)), {node, adjs[i].other_node_name}

    def bump(node, metric):
        db, aff = bumped(node, metric)
        ls.update_adjacency_database(db)
        return aff

    events = []
    hold("cold builds")
    fallbacks0 = reg.counter_get("route_engine.host_fallbacks")
    # 1. three bumps of fsw-0-0's first metric (bench.py's event)
    for step in range(3):
        aff = bump("fsw-0-0", 2 + step % 5)
        each(f"fsw-0-0 metric {2 + step % 5}", lambda e: e.churn(ls, aff))
    # 2. a remote bump
    aff = bump(remote, 3)
    each(f"{remote} metric 3", lambda e: e.churn(ls, aff))
    # 3. a drain, then an undrain, of fsw-1-0
    for on in (True, False):
        ls.update_adjacency_database(replace(db_of("fsw-1-0"), is_overloaded=on))
        each(f"fsw-1-0 {'drain' if on else 'undrain'}",
             lambda e: e.churn(ls, {"fsw-1-0"}))
    # 4. the link rsw-1-0 -- fsw-1-0 pulled both ways, then restored
    a, b = ENGINE_LINK
    saved = {a: db_of(a), b: db_of(b)}
    for x, y in ((a, b), (b, a)):
        db = db_of(x)
        ls.update_adjacency_database(replace(db, adjacencies=tuple(
            adj for adj in db.adjacencies if adj.other_node_name != y)))
    each(f"link {a}-{b} down", lambda e: e.churn(ls, {a, b}))
    for x in (a, b):
        ls.update_adjacency_database(saved[x])
    each(f"link {a}-{b} up", lambda e: e.churn(ls, {a, b}))
    # 5. a window of three metric events through churn_window
    window = [bump("fsw-0-0", 7), bump(remote, 5), bump("fsw-2-0", 4)]
    each("window of 3", lambda e: e.churn_window(ls, window))
    # 6. three events with defer_consume, then flush(): each event's
    # moved names (known once consumed) against its own oracle
    deferred, handles = [], {label: [] for label in engines}
    for i, (node, metric) in enumerate((("fsw-0-0", 3), (remote, 6), ("fsw-2-0", 5))):
        aff = bump(node, metric)
        recs = {}
        for label in engines:
            rec, pending = drive(f"deferred {i}", label,
                                 lambda e: e.churn(ls, aff, defer_consume=True))
            handles[label].append(pending)
            recs[label] = rec
        keys_i = oracle(routes=False)
        deferred.append(changed(keys_i, prev))
        prev = keys_i
        events.append({"event": f"deferred {i} ({node} metric {metric})", "engines": recs})
    recs = {}
    for label in engines:
        rec, _ = drive("flush", label, lambda e: e.flush())
        recs[label] = rec
        for i, p in enumerate(handles[label]):
            if p is None or sorted(p.names) != deferred[i]:
                raise AssertionError(f"{phase} deferred {i}: the {label} engine's moved "
                                     "names differ from the oracle's changed rows")
    hold("flush")
    events.append({"event": "flush", "engines": recs})
    # 7. a churn_burst of three events on three nodes apart; each
    # window's changed rows from an oracle of the state it leaves
    burst_nodes = ENGINE_BURST
    pre = {node: db_of(node) for node in burst_nodes}
    burst = [bumped(node, 8 + i) for i, node in enumerate(burst_nodes)]
    union = set()
    for db, _aff in burst:
        ls.update_adjacency_database(db)
        keys_i = oracle(routes=False)
        union |= set(changed(keys_i, prev))
        prev = keys_i
    for node in burst_nodes:
        ls.update_adjacency_database(pre[node])
    keys_0 = oracle(routes=False)
    prev = keys_0
    net = set(changed(keys_i, keys_0))

    def apply_burst(db, aff):
        def apply():
            ls.update_adjacency_database(db)
            return aff
        return apply

    c0 = reg.counter_get("ops.burst_cancels")
    recs, moved = {}, {}
    for label in engines:
        rec, result = drive("burst", label,
                            lambda e: e.churn_burst(ls, [apply_burst(*x) for x in burst]))
        recs[label] = rec
        moved[label] = names_of(result)
    cancels = reg.counter_get("ops.burst_cancels") - c0
    events.append({"event": "burst of 3", "engines": recs, "burst_cancels": cancels})
    for label, got in moved.items():
        want = net if recs[label]["counters"].get("ops.burst_cancels") else union
        if sorted(got) != sorted(want):
            raise AssertionError(f"{phase} burst: the {label} engine moved {len(got)} "
                                 f"destinations, the oracle's windows changed {len(want)}")
    hold("burst")
    # 8. a speculation that hits (a bump of an edge no shortest path
    # takes any more: few rows), and one that another event cancels
    aff = bump(remote, 9)
    spec = {}

    def speculate_then_window(e):
        spec[e] = e.speculate_churn(ls, [aff])
        return e.churn_window(ls, [aff])

    s0 = {k: reg.counter_get(k) for k in ("ops.spec_hits", "ops.spec_cancels")}
    each("speculation hit", speculate_then_window)
    hits = reg.counter_get("ops.spec_hits") - s0["ops.spec_hits"]
    aff1 = bump("fsw-2-0", 6)
    staged = {label: eng.speculate_churn(ls, [aff1]) for label, eng in engines.items()}
    aff2 = bump(remote, 10)
    each("speculation cancelled", lambda e: e.churn_window(ls, [aff1, aff2]))
    cancelled = reg.counter_get("ops.spec_cancels") - s0["ops.spec_cancels"]
    if hits != len(engines) or cancelled != sum(staged.values()):
        raise AssertionError(f"{phase}: speculation hits {hits}, cancels {cancelled} "
                             f"(staged {staged})")
    if reg.counter_get("route_engine.host_fallbacks") != fallbacks0:
        raise AssertionError(f"{phase}: route_engine.host_fallbacks rose outside the "
                             "armed ladder step")
    # one more event per engine under the profiler: the card's busy time,
    # its idle share, the heaviest ops and the relax kernel's own time
    profiled_events = {}
    if profile and on_card:
        for label, kernel in kinds:
            eng = engines[label]
            bumps = []

            def prepare(attempt, bumps=bumps):
                bumps.append(bump("fsw-0-0", 20 + len(bumps)))

            def run(eng=eng, bumps=bumps):
                before = dict(LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.churn(ls, bumps[-1])
                torch.cuda.synchronize()
                return ({k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                        (time.perf_counter() - t0) * 1e3)

            stats, (got, ms), wall = profiled(
                torch, run, lambda st, res, kernel=kernel: lacking(
                    st, KERNEL_KEYS[kernel], records=res[0][kernel]),
                prepare=prepare)
            for k in LAUNCHES:
                per_engine[label]["launches"][k] += got[k]
                launches[k] += got[k]
            busy = device_us(stats, "a call") / 1e3
            profiled_events[label] = {
                "event_ms": ms, "path": eng.last_path, "launches": {k: v for k, v in got.items() if v},
                "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
                "kernel_device_ms": device_us(stats, KERNEL_KEYS[kernel]) / 1e3,
                "kernel_records": kernel_records(stats, KERNEL_KEYS[kernel]),
                "top_device_ms": top_device_ms(stats),
            }
        hold("profiled events")
    # the ladder (its own step): a dispatch fault lands on the cold
    # rung; dispatch and cold-build faults on the host rung (the host
    # numpy product, equal to the oracle); then unarmed events probe back
    # through the cold rung to the warm one
    ladder_steps = []
    if ladder:
        inj = get_injector()
        arms = (("cold rung", ("route_engine.dispatch",)),
                ("host rung", ("route_engine.dispatch", "route_engine.cold_build")))
        for i, (tag, sites) in enumerate(arms):
            aff = bump(remote, 11 + i)
            recs = {}
            f0 = reg.counter_get("route_engine.host_fallbacks")
            for label in engines:
                for site in sites:
                    inj.arm(site, FaultSchedule.fail_once())
                try:
                    rec, result = drive(tag, label, lambda e: e.churn(ls, aff))
                finally:
                    inj.reset()
                if result is not None:
                    raise AssertionError(f"{phase} {tag}: the {label} engine stayed warm")
                recs[label] = rec
            rose = reg.counter_get("route_engine.host_fallbacks") - f0
            if rose != (len(engines) if tag == "host rung" else 0):
                raise AssertionError(f"{phase} {tag}: route_engine.host_fallbacks rose {rose}")
            hold(tag)
            ladder_steps.append({"step": tag, "engines": recs, "host_fallbacks": rose})
        # the breaker reopens on the wall clock: wait for its probe
        deadline = time.monotonic() + 10
        while not all(e.supervisor.breaker.can_try_now() for e in engines.values()):
            if time.monotonic() > deadline:
                raise AssertionError(f"{phase}: the ladder's breaker did not reopen")
            time.sleep(0.05)
        f0 = reg.counter_get("route_engine.host_fallbacks")
        for i, tag in enumerate(("healed: probe", "healed: warm")):
            aff = bump(remote, 13 + i)
            moved = each(tag, lambda e: e.churn(ls, aff), check=i == 1)
            if i == 0:
                hold(tag)
            paths = {label: rec["path"] for label, rec in events[-1]["engines"].items()}
            ladder_steps.append({"step": tag, "paths": paths,
                                 "warm": all(m is not None for m in moved.values())})
        if reg.counter_get("route_engine.host_fallbacks") != f0:
            raise AssertionError(f"{phase}: route_engine.host_fallbacks rose after the ladder")
        if not ladder_steps[-1]["warm"]:
            raise AssertionError(f"{phase}: the engines did not heal to the warm rung")
    for label, kernel in kinds:
        got = per_engine[label]["launches"]
        if on_card and got[kernel] == 0:
            raise AssertionError(f"{phase}: the {label} engine launched no {kernel}")
        stray = {k: v for k, v in got.items() if k != kernel and v}
        if stray:
            raise AssertionError(f"{phase}: the {label} engine launched {stray}")
    by_path = {}
    for ev in events:
        if ev["event"] == "flush":
            continue
        for label, rec in ev["engines"].items():
            key = f"{label} {rec['path']}" + (f" k={rec['k']}" if rec.get("k") else "")
            by_path.setdefault(key, []).append(rec["ms"])
    for label, eng in engines.items():
        per_engine[label].update({
            "cold_builds": eng.cold_builds, "incremental_events": eng.incremental_events,
            "full_refreshes": eng.full_refreshes, "frontier_resolves": eng.frontier_resolves,
            "frontier_fallbacks": eng.frontier_fallbacks,
            "structural_events": eng.structural_events,
            "coalesced_events": eng.coalesced_events, "host_fallbacks": eng.host_fallbacks,
            "budgets": {tag: list(b) for tag, b in sorted(eng._budgets.items())},
            "profiled_event": profiled_events.get(label),
        })
    def drain(node, on):
        ls.update_adjacency_database(replace(db_of(node), is_overloaded=on))
        return {node}

    committed = engine_committed(dev, phase, ls, samples, engines, bump, remote, drain)
    committed_line(phase, aot0, events=len(events) + len(committed),
                   warm_events=committed)
    emit({
        "phase": phase, "nodes": nodes, "samples": samples, "remote_node": remote,
        "setup_s": setup_s, "parity": "every event == cold sweep and run_spf; engines agree",
        "engines": per_engine, "events": events, "ladder": ladder_steps,
        "ms_by_path": by_path, "oracle_ms": oracle_ms,
        "oracle_launches": {k: v for k, v in oracle_launches.items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
        "launches": launches, "seconds": time.monotonic() - t_phase,
    })
    del engines
    if on_card:
        torch.cuda.empty_cache()
    return launches


# -- the tenant plane and the solver service (tenancy-1008, tenancy-10k,
# serve-1008, fleet-1008) ------------------------------------------------------

# tenancy-1008: vantage tenants over ONE 1008-node LinkState, by tier (the
# rack, fabric and spine switches' source batches are 8, 32 and 64 rows:
# one shape bucket each), and area tenants on LinkStates of their own
TENANCY_VANTAGES = {"rsw": 40, "fsw": 16, "ssw": 8}
TENANCY_AREAS = 8
TENANCY_ROUNDS = 10
TENANCY_SLOTS = 64
TENANCY_RESIDENT = 128
# the overcommitted manager: slots, resident cap, tenants, rounds
TENANCY_EVICT = (8, 8, 16, 3)
TENANCY_KSP2_DSTS = 64
TENANCY_DECISION_AREAS = 4
TENANCY_HOST_SAMPLES = 4
TENANCY_10K_AREAS = 4
TENANCY_10K_ROUNDS = 3
SERVE_CLIENTS = 3
SERVE_TENANTS = 8
SERVE_ROUNDS = 5
SERVE_SLOTS = 32
SERVE_FIB_TENANTS = 2
FLEET_TENANTS = 8
FLEET_ROUNDS = 6
FLEET_MIGRATE_AT = 2
FLEET_PROMOTE_AT = 4
SLO_ROTATION = ("premium", "standard", "bulk")
# processes of the serve and fleet phases' CPU oracle, run beside them
SERVE_ORACLE_WORKERS = 2


def _sync_card(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worlds_bound_ms(worlds: int, s: int, n: int, live: int, ov_bytes: int = 1):
    """The least time of one world relax step over ``worlds`` blocks of
    ``n`` rows holding ``live`` live slots each: the distance rows read
    and written once, the live slots (id and weight), the rows' live
    counts and the overload bits read once; one add and one min a live
    slot and batch row. Returns ``(ms, "bytes" or "operations")``."""
    return bound_ms(8 * worlds * s * n + 8 * worlds * live + (4 + ov_bytes) * worlds * n,
                    2 * worlds * s * live)


def worlds_kernel_row(torch, dev, graph, worlds, s, rng, compare, reps=REPS):
    """``ell_band_relax`` over a tenant axis at one tenant shape: ``graph``
    packed into its uniform block (``ell_pack_uniform``) ``worlds`` times,
    each world with its own overload bits and random distance rows,
    against ``ell_band_relax_worlds_plain``, with the live-slot counts
    given (``live_slots``, once a dispatch on the main path) and computed
    by the wrapper; the live pass against ``live_slots_plain``. Device ms
    of the kernel with the counts given (``ms``, a hop's cost on the main
    path), of the plain version and of the live pass (``live_pass_ms``),
    call ms, the launch plan (``worlds_plan``), and the bound over what
    the kernel reads (``worlds_bound_ms``: the live slots), beside
    ``padded_bound_ms``, the same over the whole padded block, and the
    live pass's own bound (the block's weights read once, the counts
    written)."""
    import numpy as np

    from openr_tpu_torch.ops import spf_sparse
    from openr_tpu_torch.ops.ell_relax import (
        WORLDS_WIDE_LIVE,
        ell_band_relax_worlds,
        ell_band_relax_worlds_plain,
        live_slots,
        live_slots_plain,
        worlds_plan,
    )
    from openr_tpu_torch.ops.minplus import INF
    from openr_tpu_torch.ops.world_batch import _pow2_at_least

    n = _pow2_at_least(graph.n_pad, 128)
    k = _pow2_at_least(max(bd.k for bd in graph.bands), 16)
    src, w, ov = spf_sparse.ell_pack_uniform(graph, n, k)
    src_t = torch.from_numpy(src).to(dev)[None].expand(worlds, n, k).contiguous()
    w_t = torch.from_numpy(w).to(dev)[None].expand(worlds, n, k).contiguous()
    ov_np = np.tile(ov, (worlds, 1)) | (rng.random((worlds, n)) < 0.05)
    ov_t = torch.from_numpy(ov_np).to(dev)
    d_np = rng.integers(0, 1000, (worlds, s, n)).astype(np.int32)
    d_np[rng.random(d_np.shape) < 0.5] = INF
    d_t = torch.from_numpy(d_np).to(dev)
    what = f"worlds [{worlds}, {s}, {n}] x [{worlds}, {n}, {k}]"
    live_t = live_slots(w_t)
    compare("ell_live_slots", live_t, live_slots_plain(w_t), what)
    want = ell_band_relax_worlds_plain(d_t, src_t, w_t, ov_t)
    compare("ell_band_relax", ell_band_relax_worlds(d_t, src_t, w_t, ov_t, live_t), want, what)
    compare("ell_band_relax", ell_band_relax_worlds(d_t, src_t, w_t, ov_t), want,
            f"{what}, the counts computed by the wrapper")
    del want
    plan = worlds_plan(worlds, s, n, k)
    live = int(sum(bd.rows * bd.k for bd in graph.bands))
    live_counted = int(live_t[0].sum().item())
    row = {
        "shape": {"B": worlds, "S": s, "n": n, "k": k},
        "plan": {"slab": plan.slab, "run": plan.run, "tile_rows": plan.tile_rows,
                 "smem_bytes": plan.smem_bytes, "grid": list(plan.grid)},
        "live_slots_per_world": live,
        "slots_walked_per_world": live_counted,
        "wide_rows_per_world": int((live_t[0] > WORLDS_WIDE_LIVE).sum().item()),
        "padding_share": 1.0 - live / (n * k),
        "match": True,
    }
    if dev.type == "cuda":
        row["ms"] = device_ms(
            torch, lambda: ell_band_relax_worlds(d_t, src_t, w_t, ov_t, live_t), reps,
            KERNEL_KEYS["ell_band_relax"], records=1)
        row["plain_ms"] = device_ms(
            torch, lambda: ell_band_relax_worlds_plain(d_t, src_t, w_t, ov_t, live_t),
            max(3, reps // 10))
        row["call_ms"] = time_ms(
            torch, lambda: ell_band_relax_worlds(d_t, src_t, w_t, ov_t, live_t), reps)
        row["live_pass_ms"] = device_ms(torch, lambda: live_slots(w_t), reps,
                                        KERNEL_KEYS["ell_live_slots"], records=1)
        row["live_pass_plain_ms"] = device_ms(torch, lambda: live_slots_plain(w_t),
                                              max(3, reps // 10))
        row["live_pass_call_ms"] = time_ms(torch, lambda: live_slots(w_t), reps)
    # the kernel walks the counted slots (the graph's live slots, less the
    # trailing INF ones of a row)
    row["bound_ms"], row["bound_by"] = worlds_bound_ms(worlds, s, n, live_counted)
    row["padded_bound_ms"], _ = bound_ms(
        8 * worlds * s * n + 8 * worlds * n * k + worlds * n, 2 * worlds * s * n * k)
    row["live_pass_bound_ms"], _ = bound_ms(4 * worlds * n * k + 4 * worlds * n, 0)
    return row


# the parts of a tenant wave's device time by kernel name: the world relax,
# the live pass, the readback of the compacted rows, the copies on the card
# (``_scatter_rows_drop``'s extension and compaction of each block, inputs
# and outputs copied through a replay's buffers, uploads), the patch
# scatters, the reductions (``_uniform_direct``'s [B, n, k] min among
# them); the rest of the elementwise ops under "other"
WAVE_PARTS = (("relax", KERNEL_KEYS["ell_band_relax"]),
              ("live_pass", KERNEL_KEYS["ell_live_slots"]),
              ("readback", ("Memcpy DtoH",)),
              ("copies", ("copy", "Memcpy", "Memset")),
              ("scatter", ("scatter",)),
              ("reductions", ("reduce_kernel",)))


def wave_lacking(stats, _result) -> dict:
    """What a profiled tenant wave's session lacks: records of the world
    relax and of the live pass (each dispatch launches both)."""
    return {**lacking(stats, KERNEL_KEYS["ell_band_relax"]),
            **lacking(stats, KERNEL_KEYS["ell_live_slots"])}


def wave_profile(stats, wall_ms) -> dict:
    """A profiled tenant wave's line: its host ms, device busy ms and idle
    share, device ms by ``WAVE_PARTS`` (each kernel counted under its
    first matching part) and the heaviest ops."""
    busy = device_us(stats, "a call") / 1e3
    parts = {name: 0.0 for name, _ in WAVE_PARTS}
    parts["other"] = 0.0
    for evt in stats:
        if _step_mark(evt):
            continue
        us = getattr(evt, "self_device_time_total", 0) or 0
        part = next((name for name, keys in WAVE_PARTS if any(k in evt.key for k in keys)),
                    "other")
        parts[part] += us / 1e3
    return {"wave_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "relax_device_ms": parts["relax"], "live_pass_ms": parts["live_pass"],
            "copies_ms": parts["copies"], "readback_ms": parts["readback"],
            "device_ms_by_part": parts,
            "top_device_ms": top_device_ms(stats, 8)}


def _wave_host_split(torch, dev, mgr, items, prepare, phase):
    """One more wave of ``mgr`` after ``prepare()``, its host clock split
    at the bucket dispatches: ms before the first launch (the tenants'
    sync and placement), in the launches (operand prep and enqueue), from
    the last launch to the first reap's start, in the reaps (the wait for
    the card and the delta fan-out), and after the last reap. Views held
    against the sequential oracle."""
    stamps = []

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                stamps.append((name, t0, time.perf_counter()))
        return call

    prepare()
    mgr._dispatch_launch = timed("launch", mgr._dispatch_launch)
    mgr._dispatch_finish = timed("finish", mgr._dispatch_finish)
    try:
        _sync_card(torch, dev)
        t0 = time.perf_counter()
        views = mgr.solve_views(items())
        _sync_card(torch, dev)
        t1 = time.perf_counter()
    finally:
        del mgr._dispatch_launch, mgr._dispatch_finish
    _oracle_views(torch, dev, views, phase, "the split wave")
    launches = [st for st in stamps if st[0] == "launch"]
    finishes = [st for st in stamps if st[0] == "finish"]
    if not launches or not finishes:
        return {"wave_ms": (t1 - t0) * 1e3, "buckets": 0}
    return {"wave_ms": (t1 - t0) * 1e3, "buckets": len(launches),
            "before_launch_ms": (launches[0][1] - t0) * 1e3,
            "launches_ms": sum(b - a for _, a, b in launches) * 1e3,
            "launch_to_reap_ms": (finishes[0][1] - launches[-1][2]) * 1e3,
            "reaps_ms": sum(b - a for _, a, b in finishes) * 1e3,
            "after_reap_ms": (t1 - finishes[-1][2]) * 1e3}


def _fabric_ls(topologies, LinkState, nodes, area="0"):
    """A fresh LinkState of ``fat_tree_nodes(nodes)`` in ``area``, and the
    topology."""
    from dataclasses import replace

    topo = topologies.fat_tree_nodes(nodes)
    ls = LinkState(area=area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(replace(topo.adj_dbs[name], area=area))
    return ls, topo


def _drop_first_adj(ls, node):
    from dataclasses import replace

    db = ls.get_adjacency_databases()[node]
    dropped = db.adjacencies[0]
    ls.update_adjacency_database(replace(db, adjacencies=db.adjacencies[1:]))
    return dropped


def _restore_adj(ls, node, adj):
    from dataclasses import replace

    db = ls.get_adjacency_databases()[node]
    ls.update_adjacency_database(replace(db, adjacencies=(adj,) + tuple(db.adjacencies)))


def _set_overload(ls, node, flag):
    from dataclasses import replace

    db = ls.get_adjacency_databases()[node]
    ls.update_adjacency_database(replace(db, is_overloaded=flag))


def _oracle_views(torch, dev, views, phase, what):
    """Every tenant view ``(graph, srcs, packed)`` against the reference's
    sequential oracle on ``dev``: ``ell_view_batch_packed`` of the view's
    own graph and sources, solved alone (its launches are not counted).
    Returns the oracle's ms per tenant."""
    import numpy as np

    from openr_tpu_torch.kernels import LAUNCHES
    from openr_tpu_torch.ops import spf_sparse

    saved = dict(LAUNCHES)
    _sync_card(torch, dev)
    t0 = time.perf_counter()
    for i, (graph, srcs, packed) in enumerate(views):
        want = spf_sparse.ell_view_batch_packed(graph, srcs, dev).cpu().numpy()
        if packed.shape != want.shape or not np.array_equal(packed, want):
            raise AssertionError(f"{phase}: tenant {i}'s view differs from the "
                                 f"sequential oracle after {what}")
    ms = (time.perf_counter() - t0) * 1e3
    LAUNCHES.update(saved)
    return ms / max(1, len(views))


def _host_check(ls, root, view, phase):
    """One view's distance row against the host Dijkstra."""
    from openr_tpu_torch.ops.minplus import INF

    graph, _srcs, packed = view
    res = ls.get_spf_result(root)
    for name, idx in graph.node_index.items():
        want = res[name].metric if name in res else INF
        if int(packed[0][idx]) != int(want):
            raise AssertionError(f"{phase}: {root}'s distance to {name} is "
                                 f"{int(packed[0][idx])}, the host Dijkstra's {want}")


def _tenancy_delta(before):
    from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS

    return {k: TENANCY_COUNTERS[k] - before[k] for k in before
            if TENANCY_COUNTERS[k] != before[k]}


def _need_launches(dev, launches, kernels, phase, what="") -> None:
    """On the card each of ``kernels`` must have been launched (a CPU
    rehearsal runs the plain versions, which count none)."""
    for kernel in kernels:
        if dev.type == "cuda" and launches[kernel] == 0:
            raise AssertionError(f"{phase}: {what or 'the phase'} launched no {kernel}")


def _fail_on_moves(phase, reg, aot0):
    if reg.counter_get("ops.aot_fallbacks") != aot0["ops.aot_fallbacks"]:
        raise AssertionError(f"{phase}: ops.aot_fallbacks moved")


def tenancy_phase(dev, nodes=DENSE_NODES, vantages=None, areas=TENANCY_AREAS,
                  rounds=TENANCY_ROUNDS, slots=TENANCY_SLOTS, resident=TENANCY_RESIDENT,
                  evict=TENANCY_EVICT, ksp2_dsts=TENANCY_KSP2_DSTS,
                  decision_areas=TENANCY_DECISION_AREAS, profile=True, gc_clock=None,
                  phase="tenancy-1008"):
    """``tenancy-1008``: ``WorldManager(slots, resident)`` on ``dev``
    serving vantage tenants over one ``fat_tree_nodes(nodes)`` LinkState
    (``vantages``: tenants per tier, rack, fabric and spine switches, so
    the three source-batch buckets fill and the graph is shared) and
    ``areas`` area tenants on LinkStates of their own rooted at
    ``rsw-0-0``, which join after the first round. ``rounds`` rounds of
    churn, each one ``solve_views``: a metric bump, an adjacency down and
    back up, an ``fsw`` overload flip, in turn, on the shared LinkState
    and one area; and every round a vantage override toggled. Every view
    against ``ell_view_batch_packed`` of the tenant's graph and sources
    (the sequential oracle), four tenants of round 1 against the host
    Dijkstra; ``ops.aot_compiles`` flat after the first round and no
    fallback. Then an overcommitted manager (``evict``: slots, resident
    cap, tenants, rounds) must evict and rehydrate warm; a tenant's
    ``ksp2_view`` for ``ksp2_dsts`` destinations against the host's
    ``get_kth_paths``, none of them answered by the host; and ``SpfSolver(world_batch=True)`` over
    ``decision_areas`` copies of the fabric against ``world_batch=False``,
    before and after one churn event. Each round reports the host's
    garbage-collector ms and full collections (``gc_clock``, a
    ``GcClock``; one of its own when None); the batched-over-sequential
    ratio is given over the rounds after the first and over those after
    the areas' join (``steady``). Returns the launch counts. The sizes
    are arguments so a rehearsal runs it small on the CPU."""
    from dataclasses import replace

    import numpy as np
    import torch

    from openr_tpu_torch import carry
    from openr_tpu_torch.decision import spf_solver
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import world_batch
    from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
    from openr_tpu_torch.telemetry import get_registry

    vantages = dict(TENANCY_VANTAGES if vantages is None else vantages)
    reg = get_registry()
    gc_clock = gc_clock or GcClock()
    t_phase = time.monotonic()
    ls, topo = _fabric_ls(topologies, LinkState, nodes)
    names = sorted(topo.adj_dbs)
    vantage_roots = []
    for tier, count in vantages.items():
        tier_names = [nm for nm in names if nm.startswith(tier + "-")]
        if len(tier_names) < count:
            raise AssertionError(f"{phase}: {len(tier_names)} {tier} switches for {count}")
        stride = len(tier_names) // count
        vantage_roots += tier_names[::stride][:count]
    area_ls = [_fabric_ls(topologies, LinkState, nodes, area=f"area{i}")[0] for i in range(areas)]
    fsw = [nm for nm in names if nm.startswith("fsw-")]
    rsw = [nm for nm in names if nm.startswith("rsw-")]
    overridden = vantage_roots[0]
    override_node = fsw[-1]

    def items(rnd):
        out = [(f"v{i}", ls, root, ({override_node: True} if (i == 0 and rnd % 2) else None))
               for i, root in enumerate(vantage_roots)]
        if rnd >= 1:  # the area tenants join the warm buckets
            out += [(f"a{i}", a, "rsw-0-0", None) for i, a in enumerate(area_ls)]
        return out

    dropped = {}

    def churn(rnd):
        kind = ("metric", "down", "up", "overload")[(rnd - 1) % 4]
        a = area_ls[rnd % areas]
        for target in (ls, a):
            if kind == "metric":
                bump_metric(target, rsw[rnd % len(rsw)], 2 + rnd % 7)
            elif kind == "down":
                dropped[id(target)] = _drop_first_adj(target, fsw[1])
            elif kind == "up" and id(target) in dropped:
                _restore_adj(target, fsw[1], dropped.pop(id(target)))
            elif kind == "overload":
                flag = not target.get_adjacency_databases()[fsw[2]].is_overloaded
                _set_overload(target, fsw[2], flag)
        return kind

    mgr = WorldManager(slots_per_bucket=slots, max_resident=resident, device=dev)
    reset_launches()
    aot0 = aot_snapshot()
    before = dict(TENANCY_COUNTERS)
    round_lines = []
    compiles_after_first = None
    batched_ms = sequential_ms = 0.0
    solved = 0
    steady = [0.0, 0.0]  # batched ms, sequential ms, rounds after the join
    for rnd in range(rounds):
        kind = churn(rnd) if rnd else "cold"
        r0 = dict(TENANCY_COUNTERS)
        its = items(rnd)
        gc0 = gc_clock.read()
        _sync_card(torch, dev)
        t0 = time.perf_counter()
        views = mgr.solve_views(its)
        _sync_card(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        gc1 = gc_clock.read()
        per_tenant_seq = _oracle_views(torch, dev, views, phase, f"round {rnd} ({kind})")
        if rnd == 1:
            for (tid, l, root, ov), view in list(zip(its, views))[1:1 + TENANCY_HOST_SAMPLES]:
                _host_check(l, root, view, phase)
        if rnd == 0:
            compiles_after_first = reg.counter_get("ops.aot_compiles")
        elif reg.counter_get("ops.aot_compiles") != compiles_after_first:
            raise AssertionError(f"{phase}: round {rnd} ({kind}) captured a new key")
        delta = _tenancy_delta(r0)
        if rnd:
            batched_ms += ms
            sequential_ms += per_tenant_seq * len(its)
            solved += len(its)
        if rnd >= 2:
            steady[0] += ms
            steady[1] += per_tenant_seq * len(its)
        round_lines.append({"round": rnd, "event": kind, "tenants": len(its), "ms": ms,
                            "gc_ms": gc1[0] - gc0[0], "gc_full_collections": gc1[1] - gc0[1],
                            "sequential_ms_per_tenant": per_tenant_seq,
                            "tenancy": delta})
    _fail_on_moves(phase, reg, aot0)
    main_delta = _tenancy_delta(before)
    if main_delta.get("graph_shares", 0) < len(vantage_roots) - 1:
        raise AssertionError(f"{phase}: vantages shared no graph: {main_delta}")
    n_buckets = mgr.bucket_count()
    buckets = sorted(mgr._buckets)
    profile_line = None
    if profile and dev.type == "cuda":
        def prepare(attempt):
            bump_metric(ls, rsw[-1], 5 + attempt)

        stats, views, wall_ms = profiled(
            torch, lambda: mgr.solve_views(items(rounds)), wave_lacking, prepare=prepare)
        _oracle_views(torch, dev, views, phase, "the profiled wave")
        profile_line = {**wave_profile(stats, wall_ms),
                        "host_split": _wave_host_split(torch, dev, mgr, lambda: items(rounds),
                                                       lambda: bump_metric(ls, rsw[-1], 13),
                                                       phase)}
    launches_main = dict(LAUNCHES)

    # -- eviction and warm rehydration ---------------------------------------
    e_slots, e_resident, e_tenants, e_rounds = evict
    ev = WorldManager(slots_per_bucket=e_slots, max_resident=e_resident, device=dev)
    e_items = [(f"e{i}", ls, root) for i, root in enumerate(rsw[::max(1, len(rsw) // e_tenants)][:e_tenants])]
    e_before = dict(TENANCY_COUNTERS)
    e_lines = []
    for rnd in range(e_rounds):
        if rnd:
            bump_metric(ls, rsw[rnd], 3 + rnd)
        r0 = dict(TENANCY_COUNTERS)
        _sync_card(torch, dev)
        t0 = time.perf_counter()
        views = ev.solve_views(e_items)
        _sync_card(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        _oracle_views(torch, dev, views, phase, f"eviction round {rnd}")
        delta = _tenancy_delta(r0)
        if rnd and delta.get("cold_solves", 0):
            raise AssertionError(f"{phase}: eviction round {rnd} solved cold: {delta}")
        e_lines.append({"round": rnd, "ms": ms, "tenancy": delta})
    e_delta = _tenancy_delta(e_before)
    if not e_delta.get("rehydrations") or not e_delta.get("evictions"):
        raise AssertionError(f"{phase}: the overcommitted manager did not evict and "
                             f"rehydrate: {e_delta}")

    # -- KSP2 second paths of one tenant ---------------------------------------
    k_root, k_ls = "rsw-0-0", area_ls[0]
    k_names = [nm for nm in sorted(k_ls.get_adjacency_databases()) if nm != k_root]
    dsts = k_names[:: max(1, len(k_names) // ksp2_dsts)][:ksp2_dsts]
    mgr.solve_views([("a0", k_ls, k_root)])
    registry = get_registry()
    fb0 = registry.counter_get("tenancy.ksp2_host_fallbacks")
    t0 = time.perf_counter()
    paths = mgr.ksp2_view("a0", dsts)
    ksp2_ms = (time.perf_counter() - t0) * 1e3
    ksp2_fallbacks = registry.counter_get("tenancy.ksp2_host_fallbacks") - fb0
    if ksp2_fallbacks:
        raise AssertionError(f"{phase}: ksp2_view answered {ksp2_fallbacks} "
                             "destinations from the host")
    for dst in dsts:
        want = k_ls.get_kth_paths(k_root, dst, 1) + k_ls.get_kth_paths(k_root, dst, 2)
        if paths[dst] != want:
            raise AssertionError(f"{phase}: ksp2_view's paths to {dst} differ from the host's")

    # -- the multi-area Decision build ------------------------------------------
    d_areas, ps = {}, PrefixState()
    for i in range(decision_areas):
        name = f"d{i}"
        d_ls, d_topo = _fabric_ls(topologies, LinkState, nodes, area=name)
        d_areas[name] = d_ls
        for pname in sorted(d_topo.prefix_dbs):
            ps.update_prefix_database(replace(d_topo.prefix_dbs[pname], area=name))
    keys = ("decision.world_preloads", "decision.world_preload_failures")
    c0 = [spf_solver.SPF_COUNTERS[k] for k in keys]
    on = spf_solver.SpfSolver("rsw-0-0", device=dev, world_batch=True)
    off = spf_solver.SpfSolver("rsw-0-0", device=dev, world_batch=False)
    decision_ms = []
    for step in range(2):
        if step:
            for d_ls in d_areas.values():
                bump_metric(d_ls, "fsw-0-0", 7)
        _sync_card(torch, dev)
        gc0 = gc_clock.read()
        t0 = time.perf_counter()
        got = on.build_route_db("rsw-0-0", d_areas, ps)
        _sync_card(torch, dev)
        t1 = time.perf_counter()
        gc1 = gc_clock.read()
        want = off.build_route_db("rsw-0-0", d_areas, ps)
        _sync_card(torch, dev)
        gc2 = gc_clock.read()
        decision_ms.append({"world_batch_ms": (t1 - t0) * 1e3,
                            "sequential_ms": (time.perf_counter() - t1) * 1e3,
                            "world_batch_gc_ms": gc1[0] - gc0[0],
                            "sequential_gc_ms": gc2[0] - gc1[0]})
        if carry.route_db_to_plain(got.to_route_db("rsw-0-0")) != carry.route_db_to_plain(
                want.to_route_db("rsw-0-0")):
            raise AssertionError(f"{phase}: the world-batch build {step} differs from "
                                 "the per-area build")
    preloads = spf_solver.SPF_COUNTERS[keys[0]] - c0[0]
    failures = spf_solver.SPF_COUNTERS[keys[1]] - c0[1]
    if preloads < 2 or failures:
        raise AssertionError(f"{phase}: {preloads} world preloads, {failures} failures")
    _fail_on_moves(phase, reg, aot0)
    launches = dict(LAUNCHES)
    _need_launches(dev, launches, ("ell_band_relax", "ell_band_relax_masked"), phase)
    _need_launches(dev, launches_main, ("ell_band_relax", "ell_live_slots"), phase,
                   "the tenant waves")
    world_batch.reset_world_manager()
    ratio = (batched_ms / solved) / (sequential_ms / solved) if solved and sequential_ms else None
    emit({
        "phase": phase, "nodes": nodes, "tenants": len(items(1)),
        "vantages": vantages, "areas": areas, "rounds": rounds,
        "slots": slots, "buckets": [list(b) for b in buckets], "bucket_count": n_buckets,
        "views_match_oracle": True, "host_samples": TENANCY_HOST_SAMPLES,
        "round_lines": round_lines,
        "batched_ms_per_tenant": batched_ms / solved if solved else None,
        "sequential_ms_per_tenant": sequential_ms / solved if solved else None,
        "batched_over_sequential": ratio,
        "meets_reference_gate_0_5": (ratio is not None and ratio <= 0.5),
        "batched_over_sequential_steady": steady[0] / steady[1] if steady[1] else None,
        "tenancy": main_delta,
        "delta_rows": main_delta.get("delta_rows", 0),
        "delta_bytes": 4 * main_delta.get("delta_rows", 0) * (2 + buckets[0][1]),
        "aot_compiles_after_first_round": 0,
        "profiled_wave": profile_line,
        "eviction": {"slots": e_slots, "resident": e_resident, "tenants": len(e_items),
                     "rounds": e_lines, "tenancy": e_delta},
        "ksp2": {"dsts": len(dsts), "ms": ksp2_ms, "match_host": True,
                 "host_fallbacks": ksp2_fallbacks},
        "decision": {"areas": decision_areas, "builds": decision_ms,
                     "world_preloads": preloads, "world_preload_failures": failures,
                     "match": True},
        "launches_waves": launches_main, "launches": launches,
        "seconds": time.monotonic() - t_phase,
    })
    return launches


def tenancy_10k_phase(dev, nodes=SPARSE_NODES, areas=TENANCY_10K_AREAS,
                      rounds=TENANCY_10K_ROUNDS, phase="tenancy-10k"):
    """``tenancy-10k``: ``areas`` area tenants of ``fat_tree_nodes(nodes)``
    rooted at ``rsw-0-0`` in one bucket (at 10 000 nodes ``[4, 16384,
    1024]``, 512 MiB of slots), ``rounds`` churn rounds (a metric bump of
    one area each), every view against ``ell_view_batch_packed``; the
    peak memory and each round's ms; on the card one more round under the
    profiler (``wave_profile``: busy, idle share, the relax's, the live
    pass's and the copies' device ms), its views checked too. Returns the
    launch counts."""
    import torch

    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
    from openr_tpu_torch.telemetry import get_registry

    reg = get_registry()
    t_phase = time.monotonic()
    lss = [_fabric_ls(topologies, LinkState, nodes, area=f"area{i}")[0] for i in range(areas)]
    rsw = [nm for nm in sorted(lss[0].get_adjacency_databases()) if nm.startswith("rsw-")]
    mgr = WorldManager(slots_per_bucket=areas, max_resident=areas, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    aot0 = aot_snapshot()
    before = dict(TENANCY_COUNTERS)
    its = [(f"a{i}", l, "rsw-0-0") for i, l in enumerate(lss)]
    lines = []
    compiles_after_first = None
    for rnd in range(rounds + 1):
        if rnd:
            bump_metric(lss[rnd % areas], rsw[(7 * rnd) % len(rsw)], 2 + rnd)
        r0 = dict(TENANCY_COUNTERS)
        _sync_card(torch, dev)
        t0 = time.perf_counter()
        views = mgr.solve_views(its)
        _sync_card(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        seq = _oracle_views(torch, dev, views, phase, f"round {rnd}")
        if rnd == 0:
            compiles_after_first = reg.counter_get("ops.aot_compiles")
        lines.append({"round": rnd, "ms": ms, "sequential_ms_per_tenant": seq,
                      "tenancy": _tenancy_delta(r0)})
    profile_line = None
    if dev.type == "cuda":
        def prepare(attempt):
            bump_metric(lss[attempt % areas], rsw[(5 * attempt + 3) % len(rsw)], 11 + attempt)

        stats, views, wall_ms = profiled(
            torch, lambda: mgr.solve_views(its), wave_lacking, prepare=prepare)
        _oracle_views(torch, dev, views, phase, "the profiled round")
        profile_line = wave_profile(stats, wall_ms)
    _fail_on_moves(phase, reg, aot0)
    launches = dict(LAUNCHES)
    _need_launches(dev, launches, ("ell_band_relax", "ell_live_slots"), phase)
    emit({
        "phase": phase, "nodes": nodes, "tenants": areas, "rounds": rounds,
        "buckets": [list(b) for b in sorted(mgr._buckets)],
        "slot_bytes": sum(4 * b.src_dev.numel() + 4 * b.w_dev.numel()
                          for b in mgr._buckets.values()),
        "views_match_oracle": True, "round_lines": lines,
        "aot_compiles_after_first_round": reg.counter_get("ops.aot_compiles") - compiles_after_first,
        "tenancy": _tenancy_delta(before),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "profiled_round": profile_line,
        "launches": launches, "seconds": time.monotonic() - t_phase,
    })
    return launches


def _oracle_digests_task(specs, rounds):
    """``load.multi_client.oracle_digests`` on the CPU, in a worker
    process (the port's plain versions: bit-identical to the card's)."""
    sys.path.insert(0, str(ROOT))
    from openr_tpu_torch.load import multi_client

    return multi_client.oracle_digests(specs, rounds, "cpu")


def _oracle_digests_async(specs, rounds, workers=SERVE_ORACLE_WORKERS):
    """Start the sequential oracle of ``specs`` in ``workers`` spawned
    processes, so it runs while the service works; returns a function
    that waits and gives the merged ``{tenant: digests}``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(_oracle_digests_task, specs[i::workers], rounds)
               for i in range(workers)]

    def result():
        out = {}
        try:
            for f in futures:
                out.update(f.result(timeout=HOST_ORACLE_WAIT_S))
        finally:
            pool.shutdown(cancel_futures=True)
        return out

    return result


def _p99(values):
    if not values:
        return None
    s = sorted(values)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def serve_phase(dev, nodes=DENSE_NODES, clients=SERVE_CLIENTS, tenants=SERVE_TENANTS,
                rounds=SERVE_ROUNDS, slots=SERVE_SLOTS, fib_tenants=SERVE_FIB_TENANTS,
                require_joins=True, phase="serve-1008"):
    """``serve-1008``: ``SolverService`` + ``CtrlServer(SolverCtrlHandler)``
    owning ``dev`` in this process; ``clients`` spawned torch-free client
    processes (``load.multi_client.spawn_clients``) hold ``tenants``
    tenants each of ``fat_tree_nodes(nodes)`` in mixed SLO classes for
    ``rounds`` churn rounds; every digest a client reads against
    ``oracle_digests`` (computed on the CPU in spawned processes while the
    service works), and
    ``solver_fib`` for ``fib_tenants`` more tenants against
    ``oracle_fib_digests``. ``tenancy.wave_joins`` must rise (unless
    ``require_joins`` is False: a small rehearsal's waves may end before
    the next request arrives) and no key may be captured after the first
    wave. Returns the launch counts."""
    import tempfile

    import torch

    from openr_tpu_torch.ctrl.server import CtrlServer
    from openr_tpu_torch.ctrl.solver import SolverCtrlHandler
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.load import multi_client
    from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
    from openr_tpu_torch.serve.client import SolverClient
    from openr_tpu_torch.serve.service import SolverService
    from openr_tpu_torch.telemetry import get_registry

    reg = get_registry()
    t_phase = time.monotonic()
    specs = {
        f"c{c}": [multi_client.TenantSpec(f"c{c}_t{t}", "fabric", nodes, seed=c * tenants + t + 1,
                                          slo=SLO_ROTATION[(c * tenants + t) % 3])
                  for t in range(tenants)]
        for c in range(clients)
    }
    all_specs = [s for ss in specs.values() for s in ss]
    oracle_of = _oracle_digests_async(all_specs, rounds)
    svc = SolverService(manager=WorldManager(slots_per_bucket=slots, max_resident=4 * slots,
                                             device=dev)).start()
    srv = CtrlServer(SolverCtrlHandler(svc), host="127.0.0.1", port=0)
    srv.start()
    reset_launches()
    aot0 = aot_snapshot()
    before = dict(TENANCY_COUNTERS)
    s0 = {k: reg.counter_get(k) for k in ("serve.waves", "serve.requests", "serve.errors")}
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as td:
            t0 = time.perf_counter()
            procs = multi_client.spawn_clients("127.0.0.1", srv.port, specs, rounds, td)
            first_wave_compiles = None
            while any(p.is_alive() for p, _ in procs):
                if first_wave_compiles is None and svc._waves >= 1:
                    first_wave_compiles = reg.counter_get("ops.aot_compiles")
                time.sleep(0.005)
            results = multi_client.harvest(procs)
            drive_s = time.perf_counter() - t0
        if first_wave_compiles is None:
            first_wave_compiles = reg.counter_get("ops.aot_compiles")
        t0 = time.perf_counter()
        oracle = oracle_of()
        oracle_wait_ms = (time.perf_counter() - t0) * 1e3
        errors = [e for r in results for e in r.get("errors", [])]
        if errors:
            raise AssertionError(f"{phase}: client errors {errors[:3]}")
        for res in results:
            for tid, digs in res["digests"].items():
                if digs != oracle[tid]:
                    raise AssertionError(f"{phase}: {tid}'s digests differ from the oracle")
        captures_after_first = reg.counter_get("ops.aot_compiles") - first_wave_compiles
        if captures_after_first:
            raise AssertionError(f"{phase}: {captures_after_first} captures after the first wave")
        delta = _tenancy_delta(before)
        if require_joins and not delta.get("wave_joins"):
            raise AssertionError(f"{phase}: no request joined a wave in flight: {delta}")
        latencies = {}
        for res in results:
            for cls, vals in res["latencies_ms"].items():
                latencies.setdefault(cls, []).extend(vals)
        # FIB-level views of two more tenants, against the oracle replay
        fib_specs = [multi_client.TenantSpec(f"fib{i}", "fabric", nodes, seed=40 + i)
                     for i in range(fib_tenants)]
        saved = dict(LAUNCHES)
        fib_oracle = multi_client.oracle_fib_digests(fib_specs, 2, 1, dev)
        LAUNCHES.update(saved)
        client = SolverClient("127.0.0.1", srv.port)
        fib_got = {}
        for spec in fib_specs:
            dbs = spec.build_dbs()
            client.register(spec.tenant_id, slo=spec.slo)
            client.update_world(spec.tenant_id, [dbs[k] for k in sorted(dbs)],
                                root=spec.root_of(dbs),
                                prefix_dbs=[db for _k, db in sorted(spec.build_prefix_dbs().items())])
            for i in range(2):
                if i:
                    node = multi_client.apply_mutation(dbs, spec, i)
                    client.update_world(spec.tenant_id, [dbs[node]])
                client.solve(spec.tenant_id)
                fib_got.setdefault(spec.tenant_id, []).append(client.fib(spec.tenant_id).digest)
        client.close()
        if fib_got != fib_oracle:
            raise AssertionError(f"{phase}: FIB digests differ from the oracle")
        _fail_on_moves(phase, reg, aot0)
        launches = dict(LAUNCHES)
        _need_launches(dev, launches, ("ell_band_relax", "ell_live_slots"), phase)
        emit({
            "phase": phase, "nodes": nodes, "clients": clients, "tenants": len(all_specs),
            "rounds": rounds, "slots": slots, "digests_match_oracle": True,
            "fib_match_oracle": True, "fib_tenants": fib_tenants,
            "drive_s": drive_s, "oracle_wait_ms": oracle_wait_ms,
            "p99_ms_by_class": {cls: _p99(v) for cls, v in sorted(latencies.items())},
            "p50_ms_by_class": {cls: sorted(v)[len(v) // 2] for cls, v in sorted(latencies.items())},
            "requests_by_class": {cls: len(v) for cls, v in sorted(latencies.items())},
            "waves": reg.counter_get("serve.waves") - s0["serve.waves"],
            "requests": reg.counter_get("serve.requests") - s0["serve.requests"],
            "serve_errors": reg.counter_get("serve.errors") - s0["serve.errors"],
            "preemptions": delta.get("wave_preemptions", 0),
            "wave_joins": delta.get("wave_joins", 0),
            "captures_after_first_wave": captures_after_first,
            "tenancy": delta, "launches": launches,
            "seconds": time.monotonic() - t_phase,
        })
        return launches
    finally:
        srv.stop()
        svc.stop()


def fleet_phase(dev, nodes=DENSE_NODES, tenants=FLEET_TENANTS, rounds=FLEET_ROUNDS,
                migrate_at=FLEET_MIGRATE_AT, promote_at=FLEET_PROMOTE_AT, phase="fleet-1008"):
    """``fleet-1008``: ``FleetController(services=2, with_standby=True)`` on
    ``dev`` over ``tenants`` tenants of ``fat_tree_nodes(nodes)``, driven by
    a fleet-aware ``SolverClient`` for ``rounds`` churn rounds; before
    round ``migrate_at`` one tenant migrates live (it must rehydrate warm,
    and the client answer the redirect), before round ``promote_at`` the
    primary owning another is killed and its standby promoted mid-storm
    (zero route deletes). Every digest against ``oracle_digests`` (on the
    CPU in spawned processes while the fleet works). Reports
    the replica lag and the migration ms. Returns the launch counts."""
    import torch

    from openr_tpu_torch.fleet import FleetController
    from openr_tpu_torch.kernels import LAUNCHES, reset_launches
    from openr_tpu_torch.load import multi_client
    from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS
    from openr_tpu_torch.serve.client import SolverClient
    from openr_tpu_torch.telemetry import get_registry

    reg = get_registry()
    t_phase = time.monotonic()
    specs = [multi_client.TenantSpec(f"f{i}", "fabric", nodes, seed=60 + i,
                                     slo=SLO_ROTATION[i % 3]) for i in range(tenants)]
    oracle_of = _oracle_digests_async(specs, rounds)
    fc = FleetController(services=2, with_standby=True, device=dev)
    fc.start()
    reset_launches()
    aot0 = aot_snapshot()
    before = dict(TENANCY_COUNTERS)
    try:
        ctrl_port = fc.serve_ctrl("127.0.0.1")
        f0 = fc.counters()
        clients, worlds, got = {}, {}, {}
        for spec in specs:
            host, port = fc.admit(spec.tenant_id, spec.slo)
            c = clients.get((host, port))
            if c is None:
                c = clients[(host, port)] = SolverClient(host, port,
                                                          controller=("127.0.0.1", ctrl_port))
            dbs = spec.build_dbs()
            worlds[spec.tenant_id] = (spec, dbs, c)
            c.register(spec.tenant_id, slo=spec.slo)
            c.update_world(spec.tenant_id, [dbs[k] for k in sorted(dbs)], root=spec.root_of(dbs))
        migrated, promoted = specs[0].tenant_id, specs[1].tenant_id
        migration = promotion = None
        lags = []
        for i in range(rounds):
            if i == migrate_at:
                src = fc.owner_of(migrated)
                colds = TENANCY_COUNTERS["tenant_import_colds"]
                t0 = time.perf_counter()
                reply = fc.migrate(migrated)
                migration = {"ms": (time.perf_counter() - t0) * 1e3, "from": src,
                             "to": fc.owner_of(migrated), "warm": bool(reply.get("warm")),
                             "import_colds": TENANCY_COUNTERS["tenant_import_colds"] - colds}
                if migration["to"] == src or migration["import_colds"] or not migration["warm"]:
                    raise AssertionError(f"{phase}: the migration was not warm: {migration}")
            if i == promote_at:
                owner = fc.owner_of(promoted)
                ms = fc.services()[owner]
                lags.append({"before_flush": ms.streamer.lag()})
                if not ms.streamer.flush(10.0):
                    raise AssertionError(f"{phase}: {owner}'s journal did not drain")
                lags[-1]["after_flush"] = ms.streamer.lag()
                p0 = fc.counters()
                ms.kill_primary()
                done = fc.maybe_failover()
                p1 = fc.counters()
                promotion = {
                    "service": owner, "promoted": done,
                    "promotions": p1.get("fleet.promotions", 0) - p0.get("fleet.promotions", 0),
                    "deletes": (p1.get("fleet.promotion_deletes", 0)
                                - p0.get("fleet.promotion_deletes", 0)),
                }
                if done != [owner] or promotion["promotions"] != 1 or promotion["deletes"]:
                    raise AssertionError(f"{phase}: the promotion flapped: {promotion}")
            for tid, (spec, dbs, c) in worlds.items():
                if i > 0:
                    node = multi_client.apply_mutation(dbs, spec, i)
                    c.update_world(tid, [dbs[node]])
                got.setdefault(tid, []).append(c.solve(tid).digest())
        oracle = oracle_of()
        if got != oracle:
            bad = sorted(t for t in got if got[t] != oracle[t])
            raise AssertionError(f"{phase}: digests differ from the oracle for {bad}")
        redirects = sum(c.redirects for c in clients.values())
        reconnects = sum(c.reconnects for c in clients.values())
        if not redirects:
            raise AssertionError(f"{phase}: no redirect was answered")
        for ms in fc.services().values():
            if ms.streamer is not None and not ms.promoted:
                ms.streamer.flush(10.0)
                lags.append({"service": ms.name, "after_flush": ms.streamer.lag()})
        for c in clients.values():
            c.close()
        _fail_on_moves(phase, reg, aot0)
        launches = dict(LAUNCHES)
        _need_launches(dev, launches, ("ell_band_relax", "ell_live_slots"), phase)
        f1 = fc.counters()
        emit({
            "phase": phase, "nodes": nodes, "tenants": tenants, "rounds": rounds,
            "digests_match_oracle": True, "migration": migration, "promotion": promotion,
            "redirects": redirects, "reconnects": reconnects, "replica_lag": lags,
            "fleet": {k: f1[k] - f0.get(k, 0) for k in f1
                      if isinstance(f1[k], (int, float)) and f1[k] != f0.get(k, 0)},
            "tenancy": _tenancy_delta(before), "launches": launches,
            "seconds": time.monotonic() - t_phase,
        })
        return launches
    finally:
        fc.stop()


def serve_fleet_process(start: float):
    """``serve-1008`` and ``fleet-1008`` on the card, in a process of its
    own that owns the card for the service (the client processes it
    spawns are torch-free); ``start`` is the script's ``_START``. Returns
    the launch counts of both."""
    global _START
    _START = start
    sys.path.insert(0, str(ROOT))
    import torch

    dev = torch.device("cuda")
    serve = serve_phase(dev)
    fleet = fleet_phase(dev)
    emit({"phase": "profiler", "process": "serve-fleet", **profiler_summary()})
    return {k: serve[k] + fleet[k] for k in serve}


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
    )
    from openr_tpu_torch.ops.minplus import INF, minplus, minplus_plain
    from openr_tpu_torch.ops.minplus import minplus_plan as dense_plan
    from openr_tpu_torch.ops.rev_relax import rev_band_relax, rev_band_relax_plain
    from openr_tpu_torch.telemetry import get_registry
    from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm

    KSP2_ED_ECMP = PrefixForwardingAlgorithm.KSP2_ED_ECMP
    reg = get_registry()

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
    # the KSP2 engine cells: the device solver's copy (the host oracle
    # builds its own in a process of its own, HostRouteOracle); the chunked
    # cell twice: the device solver's copy and the host oracle's own
    ksp2_dense = load_ksp2_network(topologies, LinkState, PrefixState, DENSE_NODES)
    ksp2_sparse = load_ksp2_network(topologies, LinkState, PrefixState, SPARSE_NODES,
                                    KSP2_SAMPLED_DSTS)
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

    # ell_band_relax over a tenant axis (ell_band_relax_worlds): the tenant
    # plane's uniform blocks at its two shapes (64 vantage worlds of the
    # 1008-node fabric at the spine bucket's S = 64; 4 area worlds of the
    # 10 000-node one at S = 8), then ragged random worlds: narrow and wide
    # slot widths, S of 1 to 13, 1 to 7 worlds
    worlds_rows = {
        "1008": worlds_kernel_row(torch, dev, spf_sparse.compile_ell(dense_ls),
                                  TENANCY_SLOTS, 64, rng, compare),
        "10k": worlds_kernel_row(torch, dev, graph, TENANCY_10K_AREAS, 8, rng, compare),
    }
    from openr_tpu_torch.ops.ell_relax import (
        ell_band_relax_worlds,
        ell_band_relax_worlds_plain,
        live_slots_plain,
    )
    from openr_tpu_torch.ops.ell_relax import live_slots as ell_live_slots

    # the least time of a world relax launch at the tenant plane's shapes,
    # over what it reads, and of a live pass
    least_launch_ms["ell_band_relax"] = min(
        [least_launch_ms["ell_band_relax"]]
        + [worlds_bound_ms(r["shape"]["B"], 8, r["shape"]["n"], r["slots_walked_per_world"])[0]
           for r in worlds_rows.values()])
    least_launch_ms["ell_live_slots"] = min(r["live_pass_bound_ms"] for r in worlds_rows.values())

    # (64, 8, 1024, 64) and (64, 32, 1024, 64): the 1008-node tenant
    # plane's other S buckets, each with its own launch plan
    worlds_ragged = [(1, 1, 40, 3), (3, 8, 300, 9), (7, 13, 257, 33), (2, 5, 100, 64),
                     (5, 2, 129, 200), (4, 8, 1000, 1024), (2, 5, 129, 1500),
                     (64, 8, 1024, 64), (64, 32, 1024, 64)]
    for bw, s_, n_, k_ in worlds_ragged:
        dd = rand_int((bw, s_, n_), 0.3)
        sb = torch.from_numpy(rng.integers(0, n_, (bw, n_, k_)).astype(np.int32)).to(dev)
        ovr = torch.from_numpy(rng.random((bw, n_)) < 0.2).to(dev)
        # random weights, a third INF; then INF holes inside ragged live
        # prefixes (each row's live slots end at a random width), rows
        # whose last slot is live and all-padding rows
        ww = rand_int((bw, n_, k_), 0.3)
        holed = ww.clone()
        widths = torch.from_numpy(rng.integers(0, k_ + 1, (bw, n_, 1))).to(dev)
        holed.masked_fill_(torch.arange(k_, device=dev) >= widths, INF)
        holed[:, : n_ // 4, -1] = 5
        holed[:, n_ // 2 : n_ // 2 + 3] = INF
        for wts in (ww, holed):
            lv = ell_live_slots(wts)
            compare("ell_live_slots", lv, live_slots_plain(wts), (bw, n_, k_))
            for mask in (ovr, ovr.to(torch.int32)):
                want = ell_band_relax_worlds_plain(dd, sb, wts, mask)
                compare("ell_band_relax", ell_band_relax_worlds(dd, sb, wts, mask, lv),
                        want, (bw, s_, n_, k_))
                compare("ell_band_relax", ell_band_relax_worlds(dd, sb, wts, mask),
                        want, f"{(bw, s_, n_, k_)}, the counts computed by the wrapper")
    emit({"phase": "kernels", "kernel": "ell_band_relax", "cell": "worlds",
          "rows": worlds_rows, "checked_shapes": [list(x) for x in worlds_ragged],
          "match": True})

    # ell_band_relax at the KSP2 engine's all-sources shapes: S = n_pad
    # rows (every node a source) over the 1008-node fabric's in-bands and
    # over the 10 000-node one's, two relax hops from the unit rows. The
    # plain version's gather holds [S, rows, k] at once, so it is held
    # against the kernel on slices of ALL_SOURCES_SLICE rows (the first
    # and the last)
    all_sources_kernel = {}
    for label, g in (("1008", spf_sparse.compile_ell(ksp2_dense[0])), ("10k", graph)):
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
    for label, ls in (("1008", ksp2_dense[0]), ("10k", sparse_ls)):
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

    # rev_band_relax and batched_minplus(_t) at each route sweep's graphs
    # and block (the 10 000-node fabric with 1024 destinations, the
    # 1008-node one with 256): the block of the first destinations, each
    # band and segment timed too
    rev_kernel = {}
    grouped_kernel = {"batched_minplus": {}, "batched_minplus_t": {}}
    for label, ls, rb in (("10k", sparse_ls, SPARSE_SWEEP_BLOCK),
                          ("1008", dense_ls, DENSE_SWEEP_BLOCK)):
        t_blk = np.arange(rb, dtype=np.int32)
        rev_kernel[label] = rev_relax_row(dev, route_sweep.compile_out_ell(ls), t_blk, rng,
                                          compare, f"sweep-{label}", REPS, band_reps=REPS)
        for name, row in grouped_rows(dev, spf_grouped.compile_out_grouped(ls), t_blk,
                                      compare, f"sweep-{label}", REPS, seg_reps=REPS).items():
            grouped_kernel[name][label] = row
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

    grouped_ops = {
        "batched_minplus": (batched_minplus, batched_minplus_plain, 0),
        "batched_minplus_t": (batched_minplus_t, batched_minplus_t_plain, 1),
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
    for name, (kern, plain, layout) in grouped_ops.items():
        checked = grouped_ragged_rows if name == "batched_minplus" else grouped_ragged
        for g_, b_, s_g, r_ in checked:
            gath = rand_int((g_, s_g, b_) if layout else (g_, b_, s_g), 0.3)
            w = rand_int((g_, s_g, r_), 0.3)
            compare(name, kern(gath, w), plain(gath, w), (g_, b_, s_g, r_))
        for label, row in grouped_kernel[name].items():
            emit({"phase": "kernels", "kernel": name, "cell": f"sweep-{label}",
                  "match": True, "checked_shapes": [list(x) for x in checked],
                  **row})
    # the route engine's shapes over the 10 000-node graphs
    engine_kernel = engine_kernel_shapes(dev, sparse_ls, rng, compare)
    for name, cells in engine_kernel.items():
        emit({"phase": "kernels", "kernel": name, "cell": "engine-10k", "match": True,
              "shapes": cells})
    torch.cuda.empty_cache()
    odd = rand_int((3 * 70 * 8 + 1,), 0.3)[1:].view(3, 70, 8)
    w = rand_int((3, 8, 12), 0.3)
    compare("batched_minplus", batched_minplus(odd, w), batched_minplus_plain(odd, w),
            "gath off a 16-byte boundary")
    # the autotuner's candidates at the main path's shapes: each plan
    # variant held against the plain version, its CUDA-event ms and the
    # winner (the counts are zeroed before every phase below)
    autotune_lines(dev, rng, compare, [(s_, n_), (64, n_)], [
        (g.n_pad, max(bd.k for bd in g.bands))
        for g in (spf_sparse.compile_ell(dense_ls), graph,
                  route_sweep.compile_out_ell(sparse_ls))])

    # -- 4./5. the main path: route builds through the kernels ---------------
    def drive(phase, ls, ps, events, nodes, remote_events):
        """Initial build + ``events`` churn builds from ``root`` (bench.py's
        event, a bump of ``fsw-0-0``, a neighbour of the root), then
        ``remote_events`` remote events (a bump of the first adjacency of the
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
                "blocking_syncs": c1["ops.blocking_syncs"] - c0["ops.blocking_syncs"],
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
            for i in range(remote_events)
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

    aot0 = aot_snapshot()
    dense = drive("dense", dense_ls, dense_ps, DENSE_EVENTS, n_dense, REMOTE_EVENTS)
    committed_line("dense", aot0)
    if dense["minplus"] == 0:
        raise AssertionError("dense route builds launched no minplus kernel")
    aot0 = aot_snapshot()
    sparse = drive("sparse", sparse_ls, sparse_ps, SPARSE_EVENTS, n_sparse,
                   SPARSE_REMOTE_EVENTS)
    committed_line("sparse", aot0)
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
        aot0 = aot_snapshot()
        sweep_committed = {}
        for label, make in backends:
            sweeper = make()
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            syncs0 = reg.counter_get("ops.blocking_syncs")
            result = sweeper.sweep(block=block)
            torch.cuda.synchronize()
            sweep_ms = (time.perf_counter() - t0) * 1e3
            sweep_syncs = reg.counter_get("ops.blocking_syncs") - syncs0
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
            n_blocks = len(result.digests) // block + (len(result.digests) % block > 0)
            sweep_committed[label] = {
                "sweep_ms": sweep_ms, "blocks": n_blocks, "blocking_syncs": sweep_syncs,
                "blocking_syncs_per_block": sweep_syncs / n_blocks,
                "hops_per_block": sum(sweeper.block_hops[:n_blocks]) / n_blocks,
            }
            report[label] = {
                "sweep_ms": sweep_ms, "blocks": n_blocks,
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
        committed_line(phase, aot0, sweeps=sweep_committed)
        return phase_launches

    sweep_small = sweep_phase("sweep-1008", dense_ls, DENSE_SWEEP_BLOCK, True)
    sweep_large = sweep_phase("sweep-10k", sparse_ls, SPARSE_SWEEP_BLOCK, False)

    # -- the route engine, then the route sweep at 100 000 nodes ------------
    engine_small = engine_phase(dev, "engine-1008", DENSE_NODES, True, DENSE_SWEEP_BLOCK,
                                True, gc_clock)
    engine_large = engine_phase(dev, "engine-10k", SPARSE_NODES, False, SPARSE_SWEEP_BLOCK,
                                True, gc_clock)
    gc.collect()
    torch.cuda.empty_cache()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # not a multiprocessing.Pool: its workers are daemonic and may not start
    # the phase's host-oracle workers
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        sweep_huge, rev_100k = pool.submit(sweep_100k_process, _START).result()

    # -- 8./9. the main path: KSP2 route builds through the engine --------
    def ksp2_engine_drive(phase, world, fabric_nodes, ksp2_dsts, events, remote_events):
        """The KSP2 engine (the default up to ksp2_engine.ENGINE_MAX_NODES
        nodes) on a KSP2 network from ``root``: an initial build,
        ``events`` bench events (a bump of ``fsw-0-0``), ``remote_events``
        remote ones (a bump of the last pod's first rack switch), each
        held against the host Dijkstra solver on its own copy of the
        databases, and after each the engine's resident all-sources
        matrix held against a cold ``ell_distances_from_sources`` on the
        card (its launches are taken back out of the counts). Then one
        more bench and one more remote build under the profiler. The host
        oracle (``HostRouteOracle``: spawned processes with their own copy
        of the databases of ``fabric_nodes`` and ``ksp2_dsts`` as
        ``load_ksp2_network`` takes them) replays the events and answers
        each build's route database while the card works; the answers are
        compared at the phase's end. Each
        build reports cold build or incremental sync, the affected
        destinations, the KSP2 route reuses, the all-sources hops and
        ``ell_band_relax`` launches, the fast path on or off and the
        speculative rows changed, the engine's host-clock parts, the
        kernel launches and the host's garbage-collector ms. The launch counts and the solver counters are zeroed just before
        and read just after."""
        ls, ps = world
        nodes = len(ls.get_adjacency_databases())
        areas = {ls.area: ls}
        oracle = HostRouteOracle(fabric_nodes, ksp2_dsts, root)
        device_solver = SpfSolver(root, backend="device", device=dev)
        stager = device_solver._resident.stager
        remote = remote_rsw(ls)
        want_dsts = len({
            node for prefix in ps.prefixes()
            for (node, _), entry in ps.entries_for(prefix).items()
            if node != root and entry.forwarding_algorithm == KSP2_ED_ECMP
        })

        def check(got, step):
            oracle.check(step, carry.route_db_to_plain(got.to_route_db(root)))
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
                bump_metric(ls, node, metric)
                oracle.bump(node, metric)
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
        aot0 = aot_snapshot()
        builds = [one_build(step, None if step == 0 else bump("fsw-0-0", 2 + (step - 1) % 5))
                  for step in range(events + 1)]
        remotes = [one_build(f"remote {i}", bump(remote, 3 + i)) for i in range(remote_events)]
        profiles = {}
        # at 10 000 nodes the bench build alone: a profiled build there is
        # one more host oracle of the sampled KSP2 prefixes (about 40 s)
        for label, node, metric in (("bench", "fsw-0-0", 9), ("remote", remote, 20))[
                : 2 if nodes <= SPARSE_NODE_THRESHOLD else 1]:
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
        launches = dict(LAUNCHES)
        t_wait = time.perf_counter()
        oracle.finish(phase)
        oracle_wait_ms = (time.perf_counter() - t_wait) * 1e3
        if counters["decision.ksp2_device_batches"] == 0:
            raise AssertionError(f"{phase}: no KSP2 device batch")
        if counters["decision.ksp2_host_fallbacks"] or counters["decision.spf_host_fallback"]:
            raise AssertionError(f"{phase}: host fallbacks {counters}")
        if not any(b["counters"]["ksp2_incremental_syncs"] and b["counters"]["ksp2_route_reuses"]
                   for b in remotes):
            raise AssertionError(f"{phase}: no remote event synced incrementally and "
                                 f"reused KSP2 routes: {[b['counters'] for b in remotes]}")
        for kernel in ("ell_band_relax", "ell_band_relax_masked"):
            if launches[kernel] == 0:
                raise AssertionError(f"{phase}: KSP2 builds launched no {kernel}")
        events_only = builds[1:]
        emit({
            "phase": phase, "mode": "engine", "tracer": ksp2_engine.TRACER,
            "nodes": nodes, "root": root,
            "events": events, "ksp2_dsts": want_dsts, "parity_with_host_oracle": True,
            "host_oracle": {"builds": oracle.checked, "wait_ms": oracle_wait_ms,
                            "workers": HOST_ORACLE_WORKERS},
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
        committed_line(phase, aot0, events=len(builds) + len(remotes) + len(profiles),
                       dispatch=ksp2_committed(ls, device_solver._ksp2_engines[ls],
                                               device_solver._resident._cache[ls][1]))
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
            # relax steps a chunk's masked solve launched: its hop budget
            # (ops/relax_loop.py), one more on a dispatch that captured
            build["relax_steps"] = (
                launches["ell_band_relax_masked"] / (n_bands * stats["chunks"]) - 1)
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

    ksp2_small = ksp2_engine_drive("ksp2-1008", ksp2_dense, DENSE_NODES, None,
                                   KSP2_DENSE_EVENTS, REMOTE_EVENTS)
    ksp2_large = ksp2_engine_drive("ksp2-10k", ksp2_sparse, SPARSE_NODES, KSP2_SAMPLED_DSTS,
                                   KSP2_SPARSE_EVENTS, KSP2_SPARSE_REMOTE_EVENTS)
    engine_max = ksp2_engine.ENGINE_MAX_NODES
    ksp2_engine.ENGINE_MAX_NODES = 0
    try:
        aot0 = aot_snapshot()
        ksp2_chunked = ksp2_chunked_drive("ksp2-1008-chunked", ksp2_dense_chunked,
                                          KSP2_CHUNKED_EVENTS)
        committed_line("ksp2-1008-chunked", aot0, events=KSP2_CHUNKED_EVENTS + 2)
    finally:
        ksp2_engine.ENGINE_MAX_NODES = engine_max

    # -- 11-13. the Decision module -----------------------------------------------
    decision_small, decision_large, decision_faults = decision_phases(
        dev, root, DENSE_NODES, SPARSE_NODES, DECISION_DENSE_EVENTS, DECISION_SPARSE_EVENTS,
        gc_clock)

    # -- 14-15. the route plane under sustained load, in a process of its own
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pipeline_small, pipeline_large = pool.apply(pipeline_process, (_START,))

    # -- 16. a fabric of whole daemons, in a process of its own
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        fabric = pool.apply(daemon_fabric_process, (_START,))

    # -- 17. the daemon as a process, driven over its wires from another
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pool.apply(daemon_process_process, (_START,))

    # -- 18-19. the tenant plane: WorldManager at 1008 and 10 000 nodes
    gc.collect()
    torch.cuda.empty_cache()
    tenancy_small = tenancy_phase(dev, gc_clock=gc_clock)
    tenancy_large = tenancy_10k_phase(dev)

    # -- 20-21. the solver service and the fleet, in a process that owns
    # the card for the service, its clients in torch-free processes (not a
    # multiprocessing.Pool: its workers are daemonic and may not start them)
    gc.collect()
    torch.cuda.empty_cache()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        serve_fleet = pool.submit(serve_fleet_process, _START).result()

    main_launches = {
        k: dense[k] + sparse[k] + sweep_small[k] + sweep_large[k] + engine_small[k]
        + engine_large[k] + sweep_huge[k] + ksp2_small[k]
        + ksp2_large[k] + ksp2_chunked[k] + decision_small[k] + decision_large[k]
        + decision_faults[k] + pipeline_small[k] + pipeline_large[k] + fabric[k]
        + tenancy_small[k] + tenancy_large[k] + serve_fleet[k]
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
         "all_sources": all_sources_kernel,
         "worlds": {
             label: {**row, "route": "cuda", "source": f"{csrc}/ell_relax_worlds.cu",
                     "replaces": "openr_tpu/ops/pallas_ell.py:196 (under vmap: "
                                 "openr_tpu/ops/spf_sparse.py:2241)",
                     "launches": {"tenancy-1008": tenancy_small["ell_band_relax"],
                                  "tenancy-10k": tenancy_large["ell_band_relax"],
                                  "serve-fleet-1008": serve_fleet["ell_band_relax"]},
                     "max_abs_err": max_err["ell_band_relax"], "library_ms": None}
             for label, row in worlds_rows.items()}},
        {"name": "ell_live_slots", "route": "cuda", "source": f"{csrc}/ell_relax_worlds.cu",
         "replaces": "openr_tpu/ops/pallas_ell.py:196 (none of its own: the live-slot "
                     "counts the world relax stops at)",
         "launches": main_launches["ell_live_slots"],
         "max_abs_err": max_err["ell_live_slots"],
         "ms": worlds_rows["10k"]["live_pass_ms"],
         "plain_ms": worlds_rows["10k"]["live_pass_plain_ms"],
         "bound_ms": worlds_rows["10k"]["live_pass_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "call_ms": worlds_rows["10k"]["live_pass_call_ms"],
         "shape": worlds_rows["10k"]["shape"], "match": True,
         "at_1008": {"shape": worlds_rows["1008"]["shape"],
                     "ms": worlds_rows["1008"]["live_pass_ms"],
                     "plain_ms": worlds_rows["1008"]["live_pass_plain_ms"],
                     "bound_ms": worlds_rows["1008"]["live_pass_bound_ms"],
                     "call_ms": worlds_rows["1008"]["live_pass_call_ms"]}},
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
         "max_abs_err": max(max_err["rev_band_relax"], rev_100k["max_abs_err"]),
         **sweep_row(rev_kernel), "match": True,
         "engine_10k": engine_kernel["rev_band_relax"], "at_100k": rev_100k},
    ] + [
        {"name": name, "route": "cuda", "source": f"{csrc}/grouped_minplus.cu",
         "replaces": replaces,
         "launches": main_launches[name], "max_abs_err": max_err[name],
         **sweep_row(grouped_kernel[name]), "match": True,
         "engine_10k": engine_kernel[name]}
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
