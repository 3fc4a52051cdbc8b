#!/usr/bin/env python3
"""Smoke run of kueue_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version, and drives the port's main path
at full size both ways: ``Driver(device="cuda").schedule_once`` per cycle
and ``Driver.schedule_burst``, K cycles per launch; then fair-sharing
admission, ``Driver(device="cuda", fair_sharing=True).schedule_once``;
then topology-aware scheduling, ``Driver(device="cuda")`` with the TAS
gates on; then the one-call cycle solver behind the north-star probe
(``python -m kueue_tpu_torch.probe``) and ``scenarios.entry()``, and
``Driver(solver_backend="native")``; then the forest-sharded burst and,
under ``KUEUE_TPU_SHARDS``, the per-cycle mesh; then the front door:
the reference perf harness (``python -m kueue_tpu_torch.perf.harness``)
and the job layer (Configuration, manifests, ``JobManager``); then the
open-loop traffic runner (``kueue_tpu_torch.traffic``) and two-phase
admission with the provisioning check
(``kueue_tpu_torch.admissionchecks``); then the serving front
(``kueue_tpu_torch.serving``), the MultiKueue federation
(``kueue_tpu_torch.federation``, ``remote``) and supervised child
processes (``kueue_tpu_torch.dist``); then the kueuectl CLI and its
admission daemon over a manifest store (``python -m
kueue_tpu_torch.cli``); then the north-star entry point's twin (``python
-m kueue_tpu_torch.northstar``) on the mixed fleet and through the
fill-then-trickle; then the twins of the chaos, OBS and scale soaks
(``python -m kueue_tpu_torch.chaos_soak`` / ``obs_soak`` /
``scale_soak``), of the traffic, serving and federation soaks
(``traffic_soak`` / ``serve_soak`` / ``federation_soak``) and of the
distributed soak and the roofline (``dist_soak`` / ``accel_roofline``),
each ending in the per-cycle admit kernels or the fused burst; then the
solver's router (``CycleSolver(backend="auto")``: its warm-up,
``kq_add_one``'s round trip and the persisted table).  On a card
"auto" launches the card's kernels at every dispatch, so every phase
runs the default backend; the run's sidecars go to a fresh temporary
``KUEUE_TPU_COMPILE_CACHE``, removed at the end:

1. device: name, count and ``nvidia-smi`` name/power limit;
2. build: nvcc of every kernel source (in parallel) into one library;
   then the CPU arms start, each a child process on one torch thread
   beside the card's phases (``CPU_ARMS``): phase 10's, 12's, 18's,
   20's and 22's parity runs, 25's, 26's, 27's, 28's, 29's, 30-32's and
   33's runs on "cpu" and
   phase 24's apply (on the card) and CPU side, each read where its
   phase checks it (33's from phase 16 on); and phases 27-29's and
   30-32's card children (``CARD_ARMS["27-29"]``, ``CARD_ARMS["30-32"]``;
   ``CARD_ARMS["33"]`` from phase 16 on);
3. kernels: each CUDA kernel against its plain version on the CPU over a
   seeded sweep (kueue_tpu_torch.testing.kernel_cases, burst_cases,
   fs_cases and avail_cases: kq_cq_avail's staged route at depth 1, 2,
   3 and 17 and at N = 12,288, its global route at N = 13,000, both
   counted per call; admit_scan_preempt with the forest tables joined where a
   target lies in another forest, testing.preempt_tables) and over the
   inputs captured from the first calls of phases
   4, 5, 7, 8, 9 and 9b (for the burst also up to two windows with a
   preempting head) and of the warm-ups before 4 and 5 (kept apart:
   the kernels line times the phases' own calls) —
   exact equality (tolerance 0: every output is bool or int32, the
   burst's carry included);
4. the reference perf scenario: 5 cohorts x 6 CQs, 15,000 workloads in
   staggered waves, drained per cycle; all drained, preemptions > 0, no
   host-fallback cycle, and admit_scan, admit_scan_preempt and
   minimal_preemptions_batch launched;
5. the north-star shape: 1,000 CQs in cohorts of 5, 100,000 workloads,
   30 per-cycle cycles with a preemptor wave; admit_scan_forests launched;
6. card against CPU: the perf scenario at 3,000 workloads on "cuda" and
   on "cpu" must give the same decision digest;
7. the perf scenario drained through the fused burst: all 15,000
   drained with burst_cycles launched and cycles decided in bursts
   (dirty cycles by reason and per-cycle fallbacks printed); then at
   3,000 workloads on "cuda" and "cpu", equal decision digests;
8. the north-star shape through the fused burst at full width: 30
   cycles, the preemptor wave, burst_cycles launched, preemptions > 0;
9. fair sharing at the north-star size (scripts/northstar_e2e.py
   ``--fair-sharing``): 1,000 weighted CQs in cohorts of 5, 100,000
   workloads, 30 per-cycle cycles on the card; fs_admit_scan launched and
   cycles decided by it; then ``compute_all_drs`` on the final snapshot
   (drs_components launched) must equal the host DRS of every node,
   and again (9b) on two small clusters that borrow;
10. the same fair-sharing run on "cpu", at full size (its CPU arm): its
   decision digest must equal the card's, and it launches no kernel;
11. tas-4k (kueue_tpu_torch.scenarios.build_tas): 8 blocks x 16
   subblocks x 32 hosts of 8 GPUs, 32 CQs in 4 cohorts, 6,400 gang
   workloads, 60 per-cycle cycles on the card; fill_counts,
   best_fit_descend and split_across_roots launched (once per call),
   every branch of TASFlavorSnapshot._find_device taken, the host tree
   walk never;
12. the same 60 cycles on "cpu" with the plain TAS programs, and with
   the host tree walk (TASDeviceKernel off), in its CPU arm: both
   digests, which cover
   every admission's topology domains and counts, equal the card's;
3e. the TAS kernels against their plain versions over a seeded sweep
   (kueue_tpu_torch.testing.tas_cases: every profile and Mixed's
   unconstrained variant, every request shape, 1-3 levels, a flat
   4,096-root level, levels shuffled out of id order and runs of 33-128
   children (both on the sort route), the working set and the sort in
   global memory) and the calls captured in phase 11 — exact in values
   and dtypes, with the route each walked level took counted;
13. the north-star probe at full size on the card
   (``kueue_tpu_torch.probe.run``): ``solve_cycle`` with
   ``run_scan=False`` over 100,000 heads x 1,000 CQs (S = 4, R = 3, 64
   cohorts), then ``solve_cycle`` over 1,000 heads and
   ``solve_cycle_forests`` over 64 forests, 20 timed calls each after a
   warm-up; p50 and worst, the kernels' per-call device ms, and the
   launches of kq_cq_avail, kq_classify_heads, kq_cycle_order, admit_scan
   and admit_scan_forests (one each per call that runs them: the sort
   only where the JAX program sorts, with the scan); every output equal
   to the plain versions on the card's host CPU;
3f. the three phase-1 kernels against their plain versions over a seeded
   sweep (kueue_tpu_torch.testing.solve_cycle_cases: N on both sides of
   64, padding, uncovered and invalid slots, int32 wraps, ties and
   INT_MIN, groups of 1 / 4 / 8 lanes a head (a lane a slot) and 40
   slots on the loop route, the order's registers route at 1 to 16,384
   heads and its global route past them), the classify forced onto its
   loop route (``kernels.CLASSIFY_LANES = 0``) and the sort into global
   scratch (``kernels.SORT_SMEM = 0``), and the calls captured in phase
   13 — exact; both routes of both kernels taken and counted per call
   (``kernels.PHASE1_ROUTES``; checked with the others' in 3h);
14. ``entry(device="cuda")``'s step equal to ``entry(device="cpu")``'s;
   then ``Driver(device="cuda", solver_backend="native")`` on the perf
   scenario at 3,000 workloads: its decision digest equal to phase 6's
   card digest, with cycles decided by the C++ admit loop;
3h. the shapes past the launchers' old limits
   (kueue_tpu_torch.testing.shape_cases): admit_scan,
   admit_scan_preempt, admit_scan_forests, minimal_preemptions_batch,
   burst_cycles, kq_cq_avail and drs_components on a cohort chain 17
   levels deep, drs_components over testing.drs_design_cases (depth 1
   to 17, F = 1 to 65, R = 1 to 5, a resource with no column, the int32
   range, its staged route and its walk, both counted per call),
   fs_admit_scan at F = 65 and 72, kq_cq_avail on its
   global route (N = 13,000), admit_scan at F = 1,025,
   admit_scan_forests over one forest of 40,000 heads (its head list in
   global scratch) — each equal to its plain version; admit_scan over
   the flat scan's forest layouts (testing.flat_scan_cases: interleaved
   forests, padding, reserve heads, one forest, depth 17, F = 65, one
   forest past a block's shared memory, F = 1,025, F = 7,257 whose
   warps' column rows only global memory holds) with and without the
   forest tables, admit_scan_preempt over its forest layouts
   (testing.preempt_route_cases: cohorts of five, nested forests, depth
   17, F = 12, one forest, the cross-forest case under joined tables),
   admit_scan_forests over testing.FOREST_SHAPES (a forest with heads
   past max_forest_wl among them) and burst_cycles on a window, on the
   mixed fleet's window (4 slots x 3 resources, F = 12, resumes and both
   fungibility policies) and on one forest of every CQ, each with shared
   memory and with none allowed
   — both routes of the four kernels taken and counted per call; and
   minimal_preemptions_batch over testing.search_route_cases (S = 13 with
   padding searches between real ones, K = 1,024, F = 40, a tree past
   shared memory, candidates past it, both), each on the route its
   shapes give (``kernels.SEARCH_ROUTES``); then admit_scan over 1,000 heads
   timed on a cohort chain 17 levels deep beside the same heads on a
   chain of 2;
15. the north-star shape through the forest-sharded burst at full width
   (``KUEUE_TPU_SHARDS=4`` on a virtual mesh of four shards on this
   card, one stream each): the same 30 cycles as phase 8, whose decision
   digest it must equal; sharded dispatches > 0 and one
   kq_reduce_dflags launch for each (phases 8 and 15 start from a
   collected heap and print the full garbage collections that ran
   inside them);
15b. the sustained drain with a high-priority arrival at cycle 36 on 8
   virtual shards with ``KUEUE_TPU_RESIDENT_VERIFY=1``: records equal to
   the serial drain, resident hits > 0, rows scattered by
   kq_scatter_rows, fewer boundary bytes than a full upload; then the
   drain split in two with ``lose_devices(4)`` between the halves:
   8 → 4 shards and records equal to the serial split drain;
15c. the same drain at north-star width (scenarios.sustained_drain with
   n_cqs=1,000: 1,000 CQs in cohorts of 5, 100 workloads queued in every
   fifth, 40 reclaiming arrivals at cycle 36, runtime 30) on 4 virtual
   shards with ``KUEUE_TPU_RESIDENT_VERIFY=1``: records equal to the
   serial drain on the card, resident hits > 0 that scatter the busy
   CQs' rows with kq_scatter_rows, one packed host-to-device copy and
   one launch per shard with rows (``burst_resident_scatter_s`` and
   the copies per hit printed), fewer boundary bytes than a full
   upload;
3g. kq_scatter_rows and kq_reduce_dflags against their plain versions
   over seeded cases (kueue_tpu_torch.testing.scatter_case packed by
   ops.packing.pack_scatter_rows: padded duplicate rows, rows past the
   planes and below -C, a row in [-C, 0) written at C + r, 5-byte bool
   rows, 16-byte rows, every row of a 250-row shard; dflags_blocks) and the calls captured in phases 15, 15b and
   15c — exact;
16. the perf scenario through the per-cycle mesh (``KUEUE_TPU_SHARDS=4``
   on a virtual 2 x 2 mesh of this card: 5 forests on 2 cq shards, one
   stream per cell): all 15,000 drained, phase 4's decision digest,
   sharded and sharded preempt dispatches > 0, one kq_gather_heads
   launch per sharded dispatch, the per-shard launches of each kernel;
16b. the 30 north-star cycles through the mesh (``KUEUE_TPU_SHARDS=8``:
   4 x 2, 200 forests on 2 cq shards): phase 5's digest, the forest scan
   and the 1,000-gang preemption cycle sharded;
16c. the 30 fair-sharing north-star cycles through the mesh
   (``KUEUE_TPU_SHARDS=4``): phase 9's digest, sharded fs dispatches > 0,
   fs_admit_scan per shard, kq_fs_merge_order launched once per sharded
   fs dispatch;
16d. ``scenarios.dryrun_multichip(8)`` on a virtual 8-cell mesh of the
   card: every check of the JAX package's ``__graft_entry__
   .dryrun_multichip`` and its counts, with ``sharded_cycle_fn`` against
   the unsharded ``solve_cycle`` timed on the card;
17. the reference perf harness at full size: ``python -m
   kueue_tpu_torch.perf.harness perf/default_generator_config.yaml
   perf/default_rangespec.yaml`` as a child process (its maxrss and mCPU
   its own): 15,000 workloads finished, every class's average time to
   admission with large < medium < small, no rangespec failure on usage
   or time to admission (virtual time); wall, mCPU and maxrss printed
   beside their limits; then ``run_scenario`` on the config cut to 1
   cohort x 6 CQs (a fifth of each workload set) on "cuda" and "cpu":
   every virtual-time field of ``PerfStats`` equal, and admit_scan,
   admit_scan_preempt and minimal_preemptions_batch launched;
18. the job front door at tas-4k's size (``scenarios.build_jobs`` /
   ``run_jobs``): the Configuration from YAML (``config.load`` +
   ``validate``: the TAS gate on, waitForPodsReady, fair sharing off),
   ``Driver.from_config``, the cluster from one manifest
   (``api.manifests``: priority classes, the Topology, a GPU flavor on it
   and a CPU flavor, 4 cohorts, 32 ClusterQueues, LocalQueues) and
   4,096 GPU nodes, then 6,400 jobs of nine kinds (BatchJob, JobSet,
   PyTorchJob, MPIJob, RayJob, AppWrapper, PodGroup, StatefulSet,
   LeaderWorkerSet) in waves over 64 steps of ``JobManager`` syncs and
   ``schedule_once``, a high-priority wave at half time; every kind
   started, preempted jobs stopped with their templates restored, the
   webhook's refusals, fill_counts, best_fit_descend,
   split_across_roots, admit_scan and admit_scan_preempt launched, no
   full collection, and the same run on "cpu" (its CPU arm) with an
   equal digest (the feature gates restored after each);
19. the open loop at scripts/traffic_soak.py's width
   (``scenarios.build_traffic`` / ``traffic_stream`` / ``open_loop``):
   1,000 CQs in cohorts of 4, 4,000m cpu each, BEST_EFFORT_FIFO, Poisson
   arrivals of 1,500m at half the capacity estimate (333.3/s), runtimes
   2 or 4 s, priorities 0 / 10 / 20, 2% cancels and 2% churn, 30
   virtual s at dt = 1 s, p99 SLO 8 s, on the card: the SLO met, the
   queue depth bounded, admit kernels launched, no host-fallback cycle;
   the same stream on "cpu" with equal decisions and latencies; the
   consumed events replayed on the card with bit-identical decisions;
   then ``traffic.find_sustainable_rate`` on the card (2 probes between
   the half rate and 1.5 x the estimate), the rate printed with the
   cycle walls and the nvidia-smi line;
20. two-phase admission with a provisioning check at the perf
   scenario's size (``scenarios.build_provisioning`` /
   ``run_provisioning``): 5 cohorts x 6 CQs each carrying the check,
   ``ProvisioningController`` over a seeded capacity backend, 6,000
   workloads on the card (``PROV_SCALE``, cut from 15,000): Provisioned,
   Failed then retried with backoff, BookingExpired before admission,
   CapacityRevoked after it and a check rejected at its retry limit all
   reached, admit kernels
   launched, every workload finished or rejected; then at 3,000
   workloads on "cuda" and "cpu" equal digests over every cycle's
   reservations and check writes;
21. the admission service at traffic-1k's width
   (``scenarios.serve_loop`` / ``serve_open_loop`` / ``serve_killable``,
   scripts/serve_soak.py's arms): phase 19's stream's 9,488 submissions
   (its cancels and reprioritisations left out: the service takes
   submissions only) through ``AdmissionService.submit`` / ``step`` on
   ``Driver(device="cuda")`` with K pinned to 1, and through
   ``run_open_loop`` on a fresh card Driver: decisions and
   ``remote.state_digest`` identical; (b) the same with ``k_max`` 8 fed
   by 4 submitter threads: no accepted submission lost, none admitted
   twice, K adapted; (c) a ``svc.cycle`` crash at the middle step,
   ``recover_service`` from the store, the WAL and the ingest journal:
   (a)'s decisions and digest; every launch from the one thread that
   steps the service; (d) (a)'s service arm over the first 10 virtual s
   on "cuda" and "cpu": equal digests; (e) serve_soak.py's wall arm (16
   CQs, 4 submitter threads, diurnal 8-96/s, p99 SLO 2 s) cut from 24 s
   to 8 s of wall clock: the SLO held in every window, a clean drain,
   every launch from the service thread;
22. the federation at scripts/federation_soak.py's size
   (``scenarios.fed_arm``): a manager of 1,000 CQs (250 remote) and 4
   workers, each ``Driver(device="cuda")``, 2,500 events (cut from
   5,000), seed 1513: the
   fault-free control and ``worker_crash_mid_sync`` with equal global
   digests, no violation, no double admission, the WAL tail replayed;
   then the control with the events cut to 1,000 on "cuda" and "cpu":
   equal global digests;
23. supervised processes on the card at scripts/dist_soak.py's
   configuration (``scenarios.dist_kill_front_end_shard`` /
   ``dist_kill_federation_worker``): 2 shard, 2 submitter and 2 worker
   children, each ``python -m kueue_tpu_torch.dist.child --device
   cuda`` (no argv names a module of the JAX package), against
   in-process controls on the card: shard0 SIGKILLed and rebuilt from
   its journals, w0 SIGKILLed behind fault-injecting proxies and rebuilt
   from its journals: decisions and digests equal to the controls, none
   lost, none duplicated; while the children run, nvidia-smi's compute
   apps grow by one per shard and worker child; each child's
   ``--stats-file`` shows a CUDA context, the library loaded (not
   built) and, for the shards, admit kernels launched; each child's
   start printed;
24. the kueuectl file store at the perf scenario's cluster (cli-3k):
   ``scenarios.cli_bench_docs`` writes 5 cohorts x 6 CQs and 3,000
   workloads as manifests (``api.manifests``) after the build, loaded
   by a ``python -m kueue_tpu_torch.cli apply -f`` child on the card
   that phase 24's CPU arm starts; (a) ``cli.main([...,
   "--device", "cuda", "schedule", "--cycles", "1000"])`` in this
   process: admit_scan launched (admit_scan_preempt and
   minimal_preemptions_batch printed), no host-fallback cycle, the
   admitted list and ``scenarios.store_digest`` of the written store
   (its workload manifests without ``lastTransitionTime``) printed;
   (b) the same command on a copy of the applied store with ``--device
   cpu`` (the CPU arm): the same output and digest; (c) ``cli state``
   on the card lists every CQ with its usage; (d0) ``cli serve`` in
   this process while another thread applies 100 more workloads (a
   cohort of two CQs of their own): the store watcher restores them,
   the daemon admits them, and every ``solver.dispatch`` and every
   launch comes from the daemon's thread (the watcher's never); (d)
   ``scenarios.cli_serve_sequence`` on a copy of (a)'s store on the card
   (beside (c) and (d0)) and on a copy of (b)'s on the CPU (the CPU
   arm): a ``serve`` leader child, a ``serve
   --exit-when-drained`` child waiting for the lease, ``cli apply`` of
   the 100 while the leader serves, SIGUSR2 until the leader's dump
   lists them admitted, SIGTERM (write-back, lease released), the
   waiter takes over, drains and exits 0; each child's seconds to
   ready printed; the final store holds every admission and its digest
   is the CPU's;
25. (its card arms, 26's and 3l run in one child process on the card,
   started before phase 16 and read here: ``CARD_ARMS``) the north-star
   twin's mixed fleet at full width (northstar-hetero-1k:
   ``python -m kueue_tpu_torch.northstar``'s ``NS_HETERO`` arms,
   ``--ab-hetero``): 1,000 CQs in cohorts of 5, each over 4 flavors x 3
   resources with the whenCanBorrow x whenCanPreempt matrix cycled,
   100,000 workloads, 30 cycles with the 1,000-gang wave at cycle 10 —
   the per-cycle device solver on the card, the fused burst on the card,
   the burst on a virtual mesh of 4 shards of the card, and the host-walk
   oracle on "cpu" (its CPU arm): one digest over the four arms' per-cycle
   decisions (``scenarios.cycle_record``), the twin's ``hetero`` block
   with its decision identity and zero host fallbacks, every fallback and
   ``burst_dirty_*`` counter 0 (the sharded arm's too), resume and
   walk-stop heads > 0, preemptions and skips in every arm, and
   admit_scan_forests (or admit_scan), admit_scan_preempt,
   minimal_preemptions_batch, burst_cycles and kq_reduce_dflags launched;
   p50 / p99 per arm printed;
26. the twin's fill-then-trickle at full width (northstar-trickle-1k:
   ``NS_PACK``, ``--ab-pack`` with its 6 trickle rounds): the delta-pack
   serial, full-pack serial and pipelined arms on the card
   (``--device``: no host arm) with one digest and ``pack_compare``'s
   decision identity, no delta pack in the full-pack arm;
   the trickle's ``delta_pack_s`` / ``burst_pack_s`` printed (with 100
   workloads a CQ the backlog stays, every CQ is journal-dirty at every
   trickle boundary and all 6 repack in full, as in the JAX script);
   then the delta-pack serial arm at 1,000 CQs and 10,000 workloads (the
   backlog drained before the fill) on the card and on "cpu" (its CPU
   arm): delta packs and reused rows, equal digests and pack counters;
3l. the kernels on the calls captured in phases 25 and 26 (F = 12 and
   the mixed fleet's burst windows among them) against their plain
   versions, in the same child — exact, counted in the kernels line;
27. (27-29 run in one child process on the card started after the
   build, beside phases 3-26, and are read here: ``CARD_ARMS``) the
   chaos twin at its script's defaults (chaos-1k: ``python -m
   kueue_tpu_torch.chaos_soak``'s ``run``: 1,000 CQs in cohorts of 4,
   seed 1009, ``--devices 8`` on a virtual mesh of the card): 7 of 7
   scenarios run and bit-identical to their fault-free controls (a kill
   and ``Driver.recover_from`` at a cycle boundary and mid-admit, a crash
   inside a fused burst window, a forced speculation divergence, the
   8 → 4 → 1 shard-loss cascade with 2 degradations, 1 serial fallback
   and 1 shard at the end, pack-journal corruption, a partitioned
   MultiKueue transport), the tail clean under the port's copy of the
   CHAOS checks (``perf.validate``), and burst_cycles, an admit kernel
   and kq_reduce_dflags launched; then the seven scenarios at 100 CQs on
   the card and on "cpu" (its CPU arm): 7 of 7 each and equal control
   and faulted state digests;
28. the OBS twin at its defaults (obs-16: ``obs_soak``'s ``run``: 4
   cohorts x 4 CQs, 24 workloads a LocalQueue, 16 cycles, 12 reps, the
   device solver on the card, without the profiler): decisions identical
   between the traced and untraced Drivers and across reps, the traced
   p50 within 1.05 x the untraced, the six host phases in the span
   roster, the flight-recorder, SIGUSR2 and Chrome-trace dumps, the OBS
   checks, and an admit kernel launched; then one lockstep pair on the
   card and on "cpu" (its CPU arm): equal per-cycle decision digests;
29. the scale twin's ``--quick`` (scale-quick: sizes 1,000 / 4,000, 4
   pack boundaries, 4 end-to-end arms a size, an 8,000-CQ ceiling with 8
   preempting cohorts, the host-pool A/B at 4,000 CQs, a 100,000-workload
   soak at 4,000 CQs, a 2,000-op pool curve): byte-identical planes and
   one decision digest over the four arms at every size, the pool arms'
   decisions identical, the soak completed, burst_cycles launched, and
   the SCALE_r19 checks, all but the pooled host plane's >= 2x gate,
   whose verdict is printed with the core count; then the stream arm at
   1,000 CQs on "cpu" (its CPU arm): the card's decision digest;
30. the traffic twin's ``--quick`` (traffic-quick: ``python -m
   kueue_tpu_torch.traffic_soak``'s ``run``, 16 CQs, the 3-rung ladder
   and 2 search steps for the serial arm and the sharded arm on 8
   virtual shards of the card, the replay, the snapshot, storm and
   remote probes): the replay bit-identical, serial and sharded
   decisions equal, the TRAFFIC checks (``perf.validate``, the r16+ obs
   block included), an admit kernel and kq_gather_heads launched; what
   it decided (every curve point but its walls, the counters, each
   probe's decision digest) equal to the same run on "cpu" (the CPU arm
   of 30-32);
31. the serving twin's ``--quick`` (serve-quick: 8 CQs; the parity, kill
   / restart, SIGTERM drain and 6 s wall arms): every arm ok (the wall
   arm's p99 within its SLO and K adapted), the SERVE checks, an admit
   kernel launched; the parity, kill and drain arms equal to "cpu"'s;
32. the federation twin's ``--quick`` (fed-quick: 16 CQs, 4 workers, 80
   events): 4 of 4 scenarios converged, no double admission, the FED
   checks, an admit kernel launched; every scenario's verdict, counters
   and control / faulted digests equal to "cpu"'s;
33. the dist twin's ``--quick`` (dist-quick: ``python -m
   kueue_tpu_torch.dist_soak``'s ``run`` in its own card child started
   before phase 16, beside 16-32 (not from the build: its processes'
   load skewed phase 28's overhead A/B and its 1.05 gate): 2 shard, 2
   submitter and 2 worker processes, 4 kill steps of 3 a submitter,
   blasts of 16 and 32 a submitter; six arms, 20 child processes):
   ``all_ok``, the DIST checks (``perf.validate``),
   every child's argv ``-m kueue_tpu_torch.dist.child`` (none naming a
   JAX module), shards and workers on ``--device cuda:0`` and
   submitters on none, every shard's ``--stats-file`` showing a CUDA
   context and admit kernels launched, every worker that launched one a
   context (a worker opens it at its first launch: the socket arm's
   never steps, a restarted one may have nothing left to admit; each
   child's context and launches printed); the saturation rounds (wall-clock) and each child's start
   printed, not compared; what it decided (``dist_soak.decided``: each
   kill arm's admissions, dedupe, crash and its exit code, verdicts,
   the socket arm's proxy and client counts, the kill log; the
   federation arm's counts hang on a 2 s client timeout and are only
   printed) equal to the same run on "cpu" (its CPU arm);
34. the roofline twin's ``--quick`` (roofline-quick: ``python -m
   kueue_tpu_torch.accel_roofline``'s ``run`` in this process after
   every arm has ended, so no arm competes for the host; not profiled:
   the profiler's host cost would enter the walls): the round trip of
   ``x + 1`` and of a 4 MB ``sum``, ``admit_scan`` /
   ``admit_scan_forests`` at W = 1,024 / 8,192 on the card, on the plain
   versions and the native loop, ``burst_cycles`` at 1,000 x 128, K = 16
   / 64: every card output's digest equal to the plain version's on
   the host (tolerance 0), the native loop's too; the tunnel block, each
   row and the crossover printed;
35. the router ((a)-(c) in a card child started before phase 16,
   beside 16-33: walls not clean; read before 34): (a) the north-star
   cluster (1,000 CQs in cohorts of 5, 100,000 workloads) on a card
   Driver under "auto" in that fresh process, then ``warmup(..., 1000)``
   on a cache directory of its own: the warm-up's seconds apart from
   the library's load (and phase 2's build), the round trip, the table
   (ms by route, the measured fastest and the route taken per kind, W
   and forest bucket: the card in every bucket), no native failure, one
   sidecar written, ``kq_add_one`` launched; (b) a second cold process
   on that directory: the table loaded, its keys the same; (c) the
   sidecar's schema made stale: rejected and measured again; the CPU
   arm drains perf-15k on "cpu" under the calibrated "auto" (the plain
   versions against the native loop), phase 4's digest; (d) after 34,
   in this process with no arm running and no profiler: perf-15k and
   phase 5's north-star shape under "auto", "accel" and "native", each
   warmed up: the routes (cuda, cpu, native, no_fit, singleton; cpu 0
   everywhere, native only under "native", "auto"'s equal to
   "accel"'s), cycle p50 / p99, and one decision digest a shape with
   phase 4's (and the CPU arm's) or phase 5's;
3i. kq_gather_heads and kq_fs_merge_order against their plain versions
   on the calls captured in 16-16d and on one synthetic call each at
   north-star width (1,000 heads over 8 shards), and the per-shard admit
   scans and fs_admit_scan captured in 16-16c against theirs — exact;
3j. kq_reduce_dflags (the call captured in phase 15, and S = 8) and
   kq_gather_heads (the widest call captured in 16b, and 1,000 heads
   over 8 shards) taken apart: µs per call back to back of (a) the
   wrapper, (b) the bare C launch, (c) the library call, beside a
   one-element ``zero_()``, and the same calls under the profiler (each
   kernel's own duration and the start-to-start period).

Launch counts are zeroed just before phases 4, 5, 7, 8, 9, 9b, 11, 13,
14, 15, 15b, 15c, 16, 16b, 16c, 16d, 17, 18, 19 (its run and its
search), 20, 21 (its arms on the card, and its wall arm), 22, 23, 24
(its in-process schedule, and its in-process serve), 25 (its three card
arms, each also counted alone), 26, 27, 28, 29, 30, 31, 32, 33, 34 and
35 (its cold warm-up, and each drain of (d))
and read just after each (23 and 33: the process's and, from their
``--stats-file``, the children's; 24: this process's, the children have
no stats file).  The
scenarios collect as the reference scripts do (builds frozen, drains
with collection off): the measured north-star phases 5, 8, 9, 15, 15c,
16b and 16c, tas-4k's phase 11, the job front door's phase 18 and
phases 19 and 20 must see no full collection
(``GCWatch``), and
``scenarios.release()`` frees each phase's driver graph before the next
phase builds.  A
launch records no CUDA event: the device time of phases 4, 5, 7, 8, 9,
11, 13, 15, 15c, 16, 16b, 16c, 16d, 17, 18, 19, 20, 21, 22, 23, 24's
schedule, 25's card arms, 26, 27, 29, 30, 31, 32 and 33 (this process
and the card children: the CPU arms and phases 23's and 33's children
are not profiled) (per kernel, the rest, the
busy union and its share of the wall) comes from torch.profiler's CUDA activity
over the phase (``kueue_tpu_torch.profiling.DeviceClock``); a phase in
which it sees nothing fails.  Prints a ``kernels`` JSON line (per
kernel: its launches on its main path and in each phase, ms through
the wrapper, ``bare_ms`` of the C launch alone, ``kernel_ms`` by the
profiler, which must have recorded the timed launches (a kernel with
no profiler duration fails the run; 3k prints the host-to-device
offset of the profiler's clocks after the build and before the line);
the route of the timed call of each kernel with two; the TAS routes of the timed call, which must be the warp
route for best_fit_descend at tas-4k; the routes admit_scan and
burst_cycles took per call; a dependent-step count for the TAS
kernels, fs_admit_scan, admit_scan and burst_cycles; admit_scan also
on the probe's flat 1,000 heads, fs_admit_scan, admit_scan and
burst_cycles also on one forest of every CQ, their worst case;
drs_components also on a cohort chain 17 levels deep, ``deep_17``), the
seconds by phase (``[walls]``, the wall up to each printed line summed
by the phase tag at its head) and the total, the
nvidia-smi line, and as its last line ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result line, when there is
no CUDA device or no kueue_tpu_torch beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
# outside the tensor cores, used as the (generous) int32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
TPU_KERNEL = {   # the jitted JAX program each kernel replaces
    "admit_scan": "kueue_tpu/ops/cycle.py:251",
    "admit_scan_preempt": "kueue_tpu/ops/cycle.py:380",
    "admit_scan_forests": "kueue_tpu/ops/cycle.py:597",
    "minimal_preemptions_batch": "kueue_tpu/ops/preemption_kernel.py:135",
    "burst_cycles": "kueue_tpu/ops/burst.py:110",
    "fs_admit_scan": "kueue_tpu/ops/fs_scan.py:163",
    "drs_components": "kueue_tpu/ops/fairsharing_kernel.py:33",
    "fill_counts": "kueue_tpu/ops/tas_kernel.py:78",
    "best_fit_descend": "kueue_tpu/ops/tas_kernel.py:196",
    "split_across_roots": "kueue_tpu/ops/tas_kernel.py:219",
    "kq_cq_avail": "kueue_tpu/ops/cycle.py:458",
    "kq_classify_heads": "kueue_tpu/ops/cycle.py:463",
    "kq_cycle_order": "kueue_tpu/ops/cycle.py:521",
    "kq_scatter_rows": "kueue_tpu/ops/burst.py:2309",
    "kq_reduce_dflags": "kueue_tpu/ops/burst.py:789",
    "kq_gather_heads": "kueue_tpu/parallel/sharded.py:90",
    "kq_fs_merge_order": "kueue_tpu/parallel/sharded.py:137",
    "kq_add_one": "kueue_tpu/ops/solver.py:367",
}
SOURCE = {
    "admit_scan": "kueue_tpu_torch/kernels/admit_scan.cu",
    "admit_scan_preempt": "kueue_tpu_torch/kernels/admit_scan_preempt.cu",
    "admit_scan_forests": "kueue_tpu_torch/kernels/admit_scan_forests.cu",
    "minimal_preemptions_batch":
        "kueue_tpu_torch/kernels/minimal_preemptions.cu",
    "burst_cycles": "kueue_tpu_torch/kernels/burst_cycles.cu",
    "fs_admit_scan": "kueue_tpu_torch/kernels/fs_admit_scan.cu",
    "drs_components": "kueue_tpu_torch/kernels/drs_components.cu",
    "fill_counts": "kueue_tpu_torch/kernels/tas_fill_counts.cu",
    "best_fit_descend": "kueue_tpu_torch/kernels/tas_descend.cu",
    "split_across_roots": "kueue_tpu_torch/kernels/tas_descend.cu",
    "kq_cq_avail": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_classify_heads": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_cycle_order": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_scatter_rows": "kueue_tpu_torch/kernels/scatter_rows.cu",
    "kq_reduce_dflags": "kueue_tpu_torch/kernels/scatter_rows.cu",
    "kq_gather_heads": "kueue_tpu_torch/kernels/mesh_gather.cu",
    "kq_fs_merge_order": "kueue_tpu_torch/kernels/mesh_gather.cu",
    "kq_add_one": "kueue_tpu_torch/kernels/probe.cu",
}
TAS_KERNELS = ("fill_counts", "best_fit_descend", "split_across_roots")
BENCH_WORKLOADS = 15_000
NORTHSTAR = dict(n_cqs=1000, n_wl=100_000, cycles=30)
KIND_PREEMPT = 4            # ops/burst.py decision code
PARITY_SCALE = 0.2          # 3,000 workloads
TAS_CYCLES = 60             # tas-4k, on the card, on the CPU and walked
PHASE1 = ("kq_cq_avail", "kq_classify_heads", "kq_cycle_order")
PROBE = dict(W=100_000, C=1_000, reps=20)   # scripts/northstar_probe.py
SHARD_KERNELS = ("kq_scatter_rows", "kq_reduce_dflags")
INPLACE = ("kq_scatter_rows",)   # writes its first argument's planes
NORTHSTAR_SHARDS = 4
RESIDENT_SHARDS = 8
MESH_KERNELS = ("kq_gather_heads", "kq_fs_merge_order")
MESH_SCANS = ("admit_scan", "admit_scan_forests", "admit_scan_preempt",
              "fs_admit_scan")
MESH_SHARDS = {"bench": 4, "northstar": 8, "fs": 4, "dryrun": 8}
ROUTED = ("admit_scan", "burst_cycles",   # kernels with two routes
          "admit_scan_preempt", "admit_scan_forests",
          "minimal_preemptions_batch", "kq_cq_avail", "kq_classify_heads",
          "kq_cycle_order", "drs_components")
# the routes each must take in 3f / 3h (minimal_preemptions_batch: its
# tree and its candidates each staged or global)
ROUTES_TAKEN = {"minimal_preemptions_batch": {
    "shared", "tree global", "candidates global", "global"},
    "kq_cq_avail": {"staged", "global"},
    "drs_components": {"staged", "walk"},
    "kq_classify_heads": {"group", "loop"},
    "kq_cycle_order": {"registers", "global"}}
HARNESS_TIMEOUT_S = 600    # phase 17's child process
# phase 19: scripts/traffic_soak.py's cluster, marks, horizon and SLO and
# its default seed (KUEUE_TPU_TRAFFIC_SEED); the search runs its --quick
# iterations, 2 (not 4): the whole run passed 900 s with 4
TRAFFIC = dict(n_cqs=1000, duration_s=30.0, slo_p99_s=8.0, seed=1109,
               iters=2, wall_budget_s=60.0)
# phase 20: 6,000 workloads, cut from 15,000 when phases 21-23 came
# (their ~110-140 s took the run past 1,150 s on a slow host)
PROV_SCALE = 0.4
# the outcomes of phase 20's check writes that must all show
PROV_REACHED = ("Ready: Provisioned", "Retry: Retrying after Failed",
                "Retry: Retrying after booking expired",
                "Rejected: CapacityRevoked", "Rejected: Failed")
ADMIT_KERNELS = ("admit_scan", "admit_scan_forests", "admit_scan_preempt")
# phase 21 (e): scripts/serve_soak.py's wall arm at its own configuration
# and seed (KUEUE_TPU_SVC_SEED 1709 + 3), its 24 s of wall clock cut to
# 8 s (and so its diurnal period and its 8 windows with it)
SERVE_WALL = dict(cqs=16, wall_dt_s=0.25, wall_duration_s=8.0,
                  wall_trough_rate=8.0, wall_peak_rate=96.0,
                  wall_runtime_s=0.3, wall_submitters=4, wall_windows=8,
                  slo_p99_s=2.0, high_water=4096, k_max=8, seed=1712)
SERVE_CPU_S = 10            # phase 21 (d): virtual s on "cpu" and the card
# phase 22: scripts/federation_soak.py at its defaults but its events,
# cut from 5,000 to 2,500 to fit the phase's time, and its
# worker_crash_mid_sync seed (KUEUE_TPU_FED_SEED 1511 + 2); the card
# against the CPU with the events cut to 1,000
FED = dict(cqs=1000, remote_cqs=250, workers=4, events=2500, rate=500.0,
           steps=12, drain_max=400, seed=1513)
FED_PARITY_EVENTS = 1000
# phase 23: scripts/dist_soak.py at its defaults (seed KUEUE_TPU_DIST_SEED
# 2003; the shard arm + 1, the federation-worker arm + 4)
DIST = dict(cqs=8, shards=2, submitters=2, workers=2, per_step=4,
            kill_steps=8, fed_cqs=6, fed_remote_cqs=4, fed_traffic_steps=5,
            fed_pre_kill_steps=3, fed_post_kill_steps=7, proxy_reset=0.03,
            proxy_latency=0.05, ready_timeout_s=120.0, seed=2003)
# phase 24: the file store at phase 6's size (PARITY_SCALE: 3,000
# workloads); the daemon picks up this many more while it serves
CLI_SERVE = 100
# phases 25 and 26: the north-star twin (python -m kueue_tpu_torch.northstar)
# at full width; the mixed fleet's host-walk oracle and the trickle's card
# against CPU check (100 CQs) run in CPU_ARMS
NS_HETERO = ["--burst", "--ab-hetero", "--flavors", "4", "--resources", "3",
             "--ab-shards", "4", "--burst-backend", "accel", "--trials", "1"]
# (--device: the card arms only); the delta packs at 1,000 CQs with the
# backlog drained (10 workloads a CQ), card against CPU: with 100 a CQ
# every CQ's inadmissible backlog dirties its journal each cycle and every
# trickle boundary repacks in full, in the JAX script too
NS_PACK = ["--burst", "--ab-pack", "--trials", "1", "--burst-backend",
           "accel", "--device"]
NS_PACK_PARITY = ["--cqs", "1000", "--wl", "10000", "--trickle", "6",
                  "--no-pipeline", "--trials", "1"]
# phases 27-29: the soak twins at their scripts' defaults (chaos_soak:
# 1,000 CQs in cohorts of 4, --devices 8, seed 1009; obs_soak: 4 x 4 CQs,
# 24 a LocalQueue, 16 cycles, 12 reps; scale_soak --quick: sizes 1,000 /
# 4,000, an 8,000-CQ ceiling, a 100,000-workload soak); card against CPU:
# the seven chaos scenarios at 100 CQs, obs's lockstep pair, and scale's
# stream arm at 1,000 CQs (the script's --rounds 3 and seed 1307)
CHAOS_ARGS: list = []
CHAOS_PARITY = ["--cqs", "100"]
CHAOS_SCENARIOS = 7
OBS_ARGS: list = []
OBS_PAIR = dict(cycles=16, runtime=2, shape=(4, 4, 24))
SCALE_ARGS = ["--quick"]
SCALE_PARITY = dict(n=1000, rounds=3, seed=1307)
# phases 30-32: the traffic, serve and federation twins at their scripts'
# --quick sizes (traffic_soak: 16 CQs, the 3-rung ladder and 2 search
# steps an arm, the sharded arm on 8 virtual shards; serve_soak: 8 CQs, a
# 6 s wall arm; federation_soak: 16 CQs, 4 workers, 80 events), each on
# the card and on "cpu" (their CPU arm), whose decisions must agree
TRAFFIC_ARGS = ["--quick"]
SERVE_ARGS = ["--quick"]
FED_ARGS = ["--quick"]
# phases 33-34: the dist and roofline twins at their scripts' --quick
# (dist_soak: 2 shards, 2 submitters, 2 workers, 4 kill steps of 3 a
# submitter, blasts of 16 / 32; accel_roofline: W = 1,024 / 8,192, the
# north-star burst at K = 16 / 64, 3 reps); the dist twin on the card and
# on "cpu" (its CPU arm), whose decisions must agree
DIST_ARGS = ["--quick"]
ROOF_ARGS = ["--quick"]
# the SCALE_r19 check that holds the pooled host plane to >= 2x when the
# host has the cores, a timing gate both packages miss on 8 cores
POOL_GATE = "'host_pool.apply_pack_speedup'="
# phase 35: the router, its warm-up and its sidecar (a card child from
# phase 16 on, its CPU side in CPU_ARMS): the north-star cluster cold, a
# second cold process, a stale sidecar; then, with no arm running,
# perf-15k and the north-star shape under each backend ("auto" stays on
# the card; "native" the C++ loop the table measured)
CALIB_BACKENDS = ("auto", "accel", "native")
README_REPLAY = ("76.8 virtual s; large/medium/small 0 / 33.2 / 54.1 s; "
                 "min CQ usage 98.7%")


PHASE_WALLS: dict[str, float] = {}   # wall s by phase, summed by ``log``
_LAST_LOG = [time.perf_counter()]


def log(msg: str) -> None:
    """Print one line.  The wall since the previous line counts to the
    phase named at the head of this one (``[11 tas-4k] ...`` → "11",
    ``[3h ...]`` → "3h"; a line without a tag → "-")."""
    now = time.perf_counter()
    tag = msg[1:].split("]")[0].split(" ")[0] if msg.startswith("[") else "-"
    PHASE_WALLS[tag] = PHASE_WALLS.get(tag, 0.0) + now - _LAST_LOG[0]
    _LAST_LOG[0] = now
    print(msg, flush=True)


def check(ok, what) -> None:
    """A phase's requirement; failing it fails the run."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Capture:
    """Wraps the solver's kernel entry points to keep the inputs of the
    first ``keep`` calls of each kernel in each phase (references, or
    copies for a kernel that writes its inputs: ``INPLACE``).  The
    wrapped function itself is called unchanged."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.phase = ""
        self.calls: dict[tuple[str, str], list] = {}
        self._undo = []

    def install(self, module, attr: str, name: str) -> None:
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            calls = self.calls.setdefault((self.phase, name), [])
            args = tuple(tuple(a) if isinstance(a, list) else a
                         for a in args)
            kept = (clone_args(args) if name in INPLACE
                    and len(calls) < self.keep else args)
            out = fn(*args, **kw)
            if len(calls) < self.keep:
                calls.append((kept, kw))
            elif (name in PHASE1 and len(calls) < 2 * self.keep
                  and all(signature(a, k) != signature(args, kw)
                          for a, k in calls)):
                calls.append((args, kw))    # a call of another shape
            elif (name == "burst_cycles" and len(calls) < self.keep + 2
                  and bool((out[1] == KIND_PREEMPT).any())):
                calls.append((args, kw))    # a window with preemption
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def uninstall(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


class GCWatch:
    """Full (generation-2) garbage collections of the host's Python
    while a phase runs: how many, their seconds, the longest — a pause
    lands inside whichever cycle triggered it.  Entered inside the
    phase's ``DeviceClock``, so the profiler's own reading is not
    counted."""

    def __enter__(self):
        self.n, self.seconds, self.longest, self._t0 = 0, 0.0, 0.0, 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self._t0
        self.n += 1
        self.seconds += dt
        self.longest = max(self.longest, dt)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def line(self) -> str:
        return (f"gen-2 GC {self.n} collections, {self.seconds:.3f}s, "
                f"longest {self.longest:.3f}s")


class LaunchThreads:
    """The threads that launched kernels while the block ran, with their
    launches: wraps ``kernels._launch``, which every launcher calls where
    it counts a launch."""

    def __enter__(self):
        import threading
        from kueue_tpu_torch import kernels
        self.idents: Counter = Counter()
        self._orig = orig = kernels._launch

        def launch(name, fn, *args):
            self.idents[threading.get_ident()] += 1
            return orig(name, fn, *args)

        kernels._launch = launch
        return self

    def __exit__(self, *exc):
        from kueue_tpu_torch import kernels
        kernels._launch = self._orig


def compute_apps() -> list:
    """The pids of the processes that hold a context on the card, as
    ``nvidia-smi --query-compute-apps=pid`` lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def summed(counts) -> dict:
    """Launch counts summed over several processes' ``LAUNCHES``."""
    from kueue_tpu_torch import kernels
    out = Counter(dict.fromkeys(kernels.KERNELS, 0))
    for c in counts:
        out.update(c or {})
    return dict(out)


def clone_args(args):
    """Copies of a call's tensors (tuples of them included)."""
    return tuple(clone_args(a) if isinstance(a, tuple)
                 else a.clone() if hasattr(a, "clone") else a for a in args)


def install_shard_capture(cap: Capture) -> None:
    # the sharded burst looks these up in parallel.sharded at each call
    from kueue_tpu_torch.parallel import sharded
    cap.install(sharded, "scatter_rows", "kq_scatter_rows")
    cap.install(sharded, "reduce_dflags", "kq_reduce_dflags")


def install_mesh_capture(cap: Capture) -> None:
    # the mesh route looks its gather and merge up in parallel.sharded,
    # its per-shard scans in ops.cycle and ops.fs_scan, at each call
    from kueue_tpu_torch.ops import cycle, fs_scan
    from kueue_tpu_torch.parallel import sharded
    for name in MESH_KERNELS:
        cap.install(sharded, name[3:], name)
    for name in MESH_SCANS[:3]:
        cap.install(cycle, name, name)
    cap.install(fs_scan, "fs_admit_scan", "fs_admit_scan")


def signature(args, kw) -> tuple:
    """A call's shapes and keyword arguments."""
    return (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                  for a in args), tuple(sorted(kw.items())))


def install_phase1_capture(cap: Capture) -> None:
    # solve_cycle looks its phase-1 functions up in ops.cycle at each call
    from kueue_tpu_torch.ops import cycle
    for name, attr in zip(PHASE1, ("cq_avail", "classify_heads",
                                   "cycle_order")):
        cap.install(cycle, attr, name)


def install_capture(cap: Capture) -> None:
    from kueue_tpu_torch.ops import preemption_solver, solver
    for name in ("admit_scan", "admit_scan_forests", "admit_scan_preempt"):
        cap.install(solver, name, name)
    cap.install(preemption_solver, "minimal_preemptions_batch",
                "minimal_preemptions_batch")
    from kueue_tpu_torch.ops import burst
    cap.install(burst, "burst_cycles", "burst_cycles")


def install_fs_capture(cap: Capture) -> None:
    # dispatch_fs imports fs_admit_scan from its module at each call and
    # compute_all_drs calls its module's drs_components
    from kueue_tpu_torch.ops import fairsharing_kernel, fs_scan
    cap.install(fs_scan, "fs_admit_scan", "fs_admit_scan")
    cap.install(fairsharing_kernel, "drs_components", "drs_components")


def install_tas_capture(cap: Capture) -> None:
    # TASFlavorSnapshot._find_device imports ops.tas_kernel at each query
    from kueue_tpu_torch.ops import tas_kernel
    for name in TAS_KERNELS:
        cap.install(tas_kernel, name, name)


def plain_fns():
    from kueue_tpu_torch.ops import (burst, cycle, fairsharing_kernel,
                                     fs_scan, preemption_kernel, rtt,
                                     tas_kernel)
    from kueue_tpu_torch.parallel import sharded
    return {
        "kq_add_one": rtt.add_one_plain,
        "kq_scatter_rows": sharded.scatter_rows_plain,
        "kq_reduce_dflags": sharded.reduce_dflags_plain,
        "kq_gather_heads": sharded.gather_src_plain,
        "kq_fs_merge_order": sharded.fs_merge_order_plain,
        "fill_counts": tas_kernel.fill_counts_plain,
        "best_fit_descend": tas_kernel.best_fit_descend_plain,
        "split_across_roots": tas_kernel.split_across_roots_plain,
        "fs_admit_scan": fs_scan.fs_admit_scan_plain,
        "drs_components": fairsharing_kernel.drs_components_plain,
        "burst_cycles": burst.burst_cycles_plain,
        "admit_scan": cycle.admit_scan_plain,
        "admit_scan_forests": cycle.admit_scan_forests_plain,
        "admit_scan_preempt": cycle.admit_scan_preempt_plain,
        "minimal_preemptions_batch":
            preemption_kernel.minimal_preemptions_batch_plain,
        "kq_cq_avail": cycle.cq_avail_plain,
        "kq_classify_heads": cycle.classify_heads_plain,
        "kq_cycle_order": cycle.cycle_order_plain,
    }


def cuda_fns():
    from kueue_tpu_torch import kernels
    return {k: getattr(kernels, k) for k in kernels.KERNELS}


def as_tuple(x):
    """Outputs as a flat tuple of tensors (the burst's carry flattened)."""
    if not isinstance(x, tuple):
        return (x,)
    return tuple(t for y in x for t in as_tuple(y))


def on_cpu(args):
    return [tuple(on_cpu(a)) if isinstance(a, tuple)
            else a.cpu() if hasattr(a, "cpu") else a for a in args]


def on_card(args):
    """Seeded numpy inputs (tuples of arrays included) as CUDA tensors."""
    import numpy as np
    import torch
    return [tuple(on_card(a)) if isinstance(a, tuple)
            else torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
            else a for a in args]


def plain_kw(kw):
    """The keyword arguments of the plain version: no CUDA-only table, and
    tensors on the CPU (the sharded burst's dflags row among them)."""
    return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in kw.items()
            if k not in ("node_table", "device")}


def cuda_kw(kw):
    # without the caller's error word admit_scan_preempt reads its own
    return {k: v for k, v in kw.items() if k not in ("device", "error")}


def compare(name, args, kw, stats) -> None:
    """One CUDA launch against the plain version on CPU copies."""
    import torch
    if name in INPLACE:
        args = clone_args(args)
        plain = as_tuple(plain_fns()[name](*on_cpu(args), **plain_kw(kw)))
        cuda = as_tuple(cuda_fns()[name](*args, **cuda_kw(kw)))
    else:
        cuda = as_tuple(cuda_fns()[name](*args, **cuda_kw(kw)))
        plain = as_tuple(plain_fns()[name](*on_cpu(args), **plain_kw(kw)))
    torch.cuda.synchronize()
    if name in ROUTED:
        tally_route(name, stats)
    err = 0
    for c, p in zip(cuda, plain):
        check(c.dtype == p.dtype and c.shape == p.shape,
              f"{name}: {c.dtype}{tuple(c.shape)} vs "
              f"{p.dtype}{tuple(p.shape)}")
        d = (c.cpu().to(torch.int32) - p.to(torch.int32)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    s = stats[name]
    s["cases"] += 1
    s["mismatches"] += int(err != 0)
    s["max_abs_err"] = max(s["max_abs_err"], err)


def route_of(name) -> str:
    """The route the last launch of ``name`` took: kq_cq_avail's staged
    or global route, drs_components' staged route or walk, kq_classify_heads' lane groups or loop,
    kq_cycle_order's registers or global route; burst_cycles' forest
    state in shared memory or global rows; minimal_preemptions_batch's
    trees and candidates staged ("shared"), read from the inputs
    ("global"), or one of the two global; the blocks with heads of
    admit_scan, admit_scan_forests and admit_scan_preempt all on the
    shared-memory route, all on the global route, or both."""
    from kueue_tpu_torch import kernels
    if name in PHASE1:
        route = kernels.PHASE1_ROUTES[name]
    elif name == "drs_components":
        route = kernels.DRS_ROUTES[name]
    elif name == "burst_cycles":
        route = kernels.BURST_ROUTES[name]
    elif name == "minimal_preemptions_batch":
        r = kernels.SEARCH_ROUTES
        route = (r["tree"] if r["tree"] == r["candidates"]
                 else "tree global" if r["tree"] == "global"
                 else "candidates global")
    else:
        taken = {kernels.FLAT_ROUTE_NAMES[r]
                 for r in kernels.FLAT_ROUTES[name].cpu().tolist() if r}
        route = taken.pop() if len(taken) == 1 else (
            "both" if taken else "no heads")
    return route


def tally_route(name, stats) -> None:
    """The route of the last launch of ``name`` (``route_of``), counted
    per call in ``stats[name]["routes"]``."""
    route = route_of(name)
    routes = stats[name].setdefault("routes", {})
    routes[route] = routes.get(route, 0) + 1


def flat_dependent_steps(args, kw) -> int:
    """admit_scan's chain of dependent steps (kernels/admit_scan.cu):
    the prologue's passes over the nodes and heads (one load round per
    chunk of FLAT_THREADS x 4 items, a root walk of depth more without
    the forest tables), the staging's 3 barriers and the head
    compaction's 2 per chunk; then the largest forest's entries, each
    2 x depth + 3 (the pair loads, the walk, the vote, the column sums,
    the charge walk)."""
    import numpy as np
    from kueue_tpu_torch import kernels
    N = int(args[0].shape[0])
    W = int(args[8].shape[0])
    depth = kw["depth"]
    chunk = kernels.FLAT_THREADS * 4
    parent = args[5].cpu().numpy()
    root = np.arange(N)
    for _ in range(depth):
        root = np.where(parent[root] >= 0, parent[root], root)
    wl_cq = args[8].cpu().numpy()
    heads = np.bincount(root[wl_cq[wl_cq >= 0]], minlength=1)
    per_chunk = 1 + (0 if kw.get("forest_of_node") is not None else depth)
    n_chunks = -(-N // chunk) + -(-W // chunk)
    return (n_chunks * per_chunk + 3 + 2 * -(-W // chunk)
            + int(heads.max()) * (2 * depth + 3))


def burst_dependent_steps(kw) -> int:
    """burst_cycles' chain of dependent steps (kernels/burst_cycles.cu)
    per launch, the searches' candidate walks left out (they depend on
    the data): per cycle the rebuild's n_levels barriers and 12 more
    between the phases, then at most L scan entries on warp 0 of
    n_levels + 6 steps each (the overlap vote, the row refresh, the
    target removal, the marked rebuild's levels, the fit vote, the
    charge)."""
    n_levels = kw["n_levels"]
    return kw["K"] * (n_levels + 12 + kw["L"] * (n_levels + 6))


def io_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size()
               for t in as_tuple(tuple(args)) + as_tuple(tuple(outs))
               if hasattr(t, "numel"))


def tas_levels(name, kw) -> list:
    """The levels a TAS call sorts and walks (best_fit_descend: below
    the chosen level; split_across_roots: all, the roots as one
    segment)."""
    sizes = kw["level_sizes"]
    if name == "fill_counts":
        return []
    if name == "best_fit_descend":
        return list(range(kw["level"] + 1, len(sizes)))
    return list(range(len(sizes)))


def tas_op_count(name, args, kw) -> int:
    """int32 operations of a TAS call on its data: the fill (~4 per leaf
    and resource, ~2 per domain), then per level walked a comparison
    sort (~4 n log2 n) and a walk (~16 per child)."""
    import math
    sizes = kw["level_sizes"]
    ops = args[0].numel() * 4 + sum(sizes) * 2
    for d in tas_levels(name, kw):
        n = sizes[d]
        ops += int(4 * n * max(1.0, math.log2(n))) + 16 * n
    return ops


def tas_dependent_steps(name, args, kw, routes) -> int:
    """The launch's chain of dependent steps (kernels/tas.cuh): the route
    check's barrier and the fill's L - 1, two for the pick (the argmin,
    or the root total and the root split), then per level walked after
    it one on the warp route (``routes[d]`` 1), or on the sort route the
    bitonic sort's log2(P) (log2(P) + 1) / 2 barriers, three more and
    the level's longest child walk (three passes under BestFit)."""
    import numpy as np
    sizes = kw["level_sizes"]
    steps = len(sizes) + 2
    for d in tas_levels(name, kw):
        if routes[d] == 1:
            steps += 1 if d > 0 else 0     # the root split is the pick's
            continue
        lg = max(0, (sizes[d] - 1).bit_length())
        if d == 0:
            seg = sizes[0]
        else:
            par = args[2][d - 1].cpu().numpy()
            seg = int(np.bincount(par[(par >= 0) & (par < sizes[d - 1])],
                                  minlength=sizes[d - 1]).max())
        steps += lg * (lg + 1) // 2 + 3 + 3 * seg
    return steps


def fs_dependent_steps(args, kw) -> int:
    """The launch's chain of dependent steps (kernels/fs_admit_scan.cu):
    the membership sums (2 barriers), the two ordered compactions (2 per
    chunk of FS_STRIP x threads indices of N and of W) and the local
    maps (1); the largest forest's rounds, 5 + 7 (n_levels - 1) each;
    the finished-block count (2) and the last block's scan of W (2 per
    chunk)."""
    import numpy as np
    from kueue_tpu_torch import kernels
    N, F = args[0].shape
    W = int(args[12].shape[0])
    chunk = kernels.FS_STRIP * kernels.fs_threads(F, kw["max_forest"])
    wl_cq = args[12].cpu().numpy()
    valid = args[17].cpu().numpy()
    fon = args[18].cpu().numpy()
    k = np.bincount(fon[np.maximum(wl_cq, 0)][valid], minlength=1)
    rounds = int(k.max()) * (5 + 7 * (kw["n_levels"] - 1))
    return (2 + 2 * -(-N // chunk) + 2 * -(-W // chunk) + 1 + rounds + 2
            + 2 * -(-W // chunk))


def op_count(name, args, kw) -> int:
    """int32 operations the call's data needs: ~12 per column per chain
    step of each entry that runs (admit scans: valid heads' fit and
    charge walks; preempt: plus each preempting head's fit after removal
    and one removal walk per target it names; search: valid searches x
    real candidates x the forward and reverse steps)."""
    if name in TAS_KERNELS:
        return tas_op_count(name, args, kw)
    if name in ("kq_scatter_rows", "kq_gather_heads"):
        return 0                      # a copy: no arithmetic
    if name == "kq_fs_merge_order":
        # per head ~8 for its mark, suffix minimum and key, per emission
        # a binary search in each other shard's keys (~4 a step)
        n = [int(h.shape[0]) for h in args[1]]
        steps = max(n, default=0).bit_length()
        return sum(n) * (8 + 4 * (len(n) - 1) * steps)
    if name in ("kq_reduce_dflags", "kq_add_one"):
        return args[0].numel()                     # one add per input
    if name in PHASE1:
        return phase1_op_count(name, args, kw)
    depth = kw["depth"]
    if name == "fs_admit_scan":
        return fs_op_count(args, kw)
    if name == "drs_components":
        N, F = args[0].shape
        return int(N * F * (4 + depth * 12))
    if name == "burst_cycles":
        # per cycle: the heads' argmin and the end-of-cycle transitions
        # over every row, the classify over [C, S, R], and the forest
        # scan's chain walks (~12 ops per column per chain step)
        C, M, R = args[0].shape
        F = args[17].shape[1]
        return int(kw["K"] * (C * M * 8 + C * kw["S"] * R * depth * 12
                              + C * F * 2 * depth * 12 * 2))
    if name == "minimal_preemptions_batch":
        S, NL, F = args[0].shape
        valid = int((args[6] >= 0).sum())
        cands = int((args[9] >= 0).sum())
        per_search = cands / max(1, S)
        return int(valid * per_search * 2 * (2 * depth * F * 12))
    N, F = args[0].shape
    heads = int((args[8] >= 0).sum())
    ops = heads * 2 * depth * F * 12
    if name == "admit_scan_preempt":
        valid = args[8] >= 0
        pre = args[16] & valid
        targets = int(((args[19] >= 0) & pre[:, None]).sum())
        ops += (int(pre.sum()) + targets) * depth * F * 12
    return int(ops)


def phase1_op_count(name, args, kw) -> int:
    """int32 operations of a phase-1 call: ~10 per chain step of each
    (CQ, column) for both availabilities; ~16 per (head, slot, resource)
    and ~12 per (head, slot) of the classify, ~4 per pair written; the
    bitonic sort's log2(P) (log2(P) + 1) / 2 stages of P / 2
    compare-exchanges of ~8 operations, padded to P = 2^k >= W."""
    if name == "kq_cq_avail":
        F = args[0].shape[1]
        return int(kw["n_cqs"] * F * kw["depth"] * 2 * 10)
    if name == "kq_classify_heads":
        W = args[0].shape[0]
        _, S, R = args[3].shape
        return int(W * S * (R * 16 + 12) + (W * R * 4 if kw["pairs"] else 0))
    W = args[0].shape[0]
    lg = max(0, (W - 1).bit_length())
    return int(lg * (lg + 1) // 2 * (1 << lg) // 2 * 8 + W * 12)


def fs_forest_work(args):
    """(live rounds, entry-rounds, node-rounds) of an fs_admit_scan call
    on its data: every round removes one entry of its first remaining
    entry's forest, so a forest with k heads runs k rounds over k, k-1,
    ..., 1 remaining entries and its n nodes k times."""
    import numpy as np
    wl_cq = args[12].cpu().numpy()
    valid = args[17].cpu().numpy()
    fon = args[18].cpu().numpy()
    k = np.bincount(fon[np.maximum(wl_cq, 0)][valid],
                    minlength=int(fon.max()) + 1).astype(np.int64)
    n = np.bincount(fon, minlength=len(k)).astype(np.int64)
    return int(k.sum()), int((k * (k + 1) // 2).sum()), int((k * n).sum())


def fs_op_count(args, kw) -> int:
    """int32 operations of an fs_admit_scan call on its data: per
    entry-round the DRS walk (~8 per column and resource, ~16 per
    column and level), per node-round the five key passes of each
    tournament level (~8 each), per round the fit and charge walks."""
    N, F = args[0].shape
    R = args[9].shape[1]
    L, n_levels = kw["depth"], kw["n_levels"]
    rounds, entry_rounds, node_rounds = fs_forest_work(args)
    return int(entry_rounds * L * (8 * F * R + 16 * F)
               + node_rounds * (n_levels - 1) * 5 * 8
               + rounds * 2 * L * F * 12)


def bound_bytes(name, args, outs) -> int:
    """The bytes a call must move: each input read once, each output
    written once — for the in-place row scatter only the distinct rows
    it writes (2 x the distinct rows x the summed row bytes of its
    planes: one value read and one row written each; a padded duplicate
    row writes what its first copy wrote)."""
    import torch
    if name == "kq_scatter_rows":
        from kueue_tpu_torch.ops.packing import scatter_layout
        from kueue_tpu_torch.parallel import sharded
        planes, buf, count = args
        n = planes[0].shape[0]
        rows = sharded.unpack_scatter_rows(planes, buf, count)[0]
        rows = rows[(rows >= -n) & (rows < n)]
        rows = torch.where(rows < 0, rows + n, rows)
        return 2 * int(torch.unique(rows).numel()) * sum(
            scatter_layout(planes, count)[1])
    return io_bytes(args, outs)


def library_call(name, args):
    """The one PyTorch call that computes what the kernel computes on the
    same inputs (timed beside it, never used by the port), or None:
    ``index_put_`` per plane for the row scatter (one call per plane:
    PyTorch has no call that writes 13 tensors), ``torch.sum(dim=0)``
    over the flag window for the reduction, per plane ``index_copy_`` of
    the concatenated blocks into a filled row for the head gather (the
    maps read back from the source map and concatenated once, outside
    the timing), for the cycle order a stable ``torch.argsort`` of
    the composed key (built once, outside the timing, as the gather's
    maps), and ``torch.add(x, 1)`` for the round-trip probe."""
    import torch
    if name == "kq_scatter_rows":
        # the rows and values as views of the packed buffer
        from kueue_tpu_torch.parallel import sharded
        planes, buf, count = args
        rows, vals = sharded.unpack_scatter_rows(planes, buf, count)
        planes = clone_args(planes)
        idx = (rows.long(),)
        return lambda: [p.index_put_(idx, v) for p, v in zip(planes, vals)]
    if name == "kq_reduce_dflags":
        window = args[0]
        return lambda: torch.sum(window, dim=0, dtype=torch.int32)
    if name == "kq_gather_heads":
        from kueue_tpu_torch.parallel import sharded
        planes, src, fills = args
        idx = torch.cat(sharded.maps_of_source(
            src, [b.shape[0] for b in planes[0]])).long()
        outs = [torch.full((src.shape[0],), f, dtype=p[0].dtype,
                           device=src.device)
                for p, f in zip(planes, fills)]
        return lambda: [o.index_copy_(0, idx, torch.cat(p))
                        for o, p in zip(outs, planes)]
    if name == "kq_cycle_order":
        key = cycle_order_key(*args)
        return lambda: torch.argsort(key, stable=True)
    if name == "kq_add_one":
        x = args[0]
        return lambda: torch.add(x, 1)
    return None


def cycle_order_key(borrows0, priority, timestamp):
    """One int64 key whose stable ascending sort is the cycle order of
    ``ops.cycle.cycle_order_plain``: not borrowing first (the sign bit),
    then -priority (wrapping at INT_MIN, 32 bits), then the timestamp's
    dense rank in XLA's float order (31 bits)."""
    import torch
    from kueue_tpu_torch.ops.cycle import float32_sort_key
    neg = -priority.to(torch.int64)
    neg = torch.where(neg == 2**31, -2**31, neg)
    rank = torch.unique(float32_sort_key(timestamp), return_inverse=True)[1]
    base = torch.where(borrows0, 0, -2**63).to(torch.int64)
    return base + ((neg + 2**31) << 31) + rank.to(torch.int64)


def event_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after three warm-up
    calls (CUDA events around the run)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream busy while the host enqueues every call, so the
    # events bracket the kernels back to back and not the host's
    # launch overhead between them
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(name, args, kw, reps: int = 50) -> dict:
    """Mean device ms per launch through the wrapper (CUDA events around
    ``reps`` launches queued behind a busy stream), the same for the bare
    C launch (``bare_launch``; None for burst_cycles, whose C launch
    advances its own carry), the kernel's own duration under the
    profiler (``profiled_period``), the plain version's ms on the same
    card-resident inputs (host clock, synchronized), the bound of the
    call (the larger of its bytes over HBM bandwidth and its int32
    operations over the peak rate) and the library call's ms."""
    import torch
    fn = cuda_fns()[name]
    kw_c = cuda_kw(kw)
    if name == "admit_scan_preempt":
        # an error word of the timing's own: no read-back per launch
        kw_c["error"] = torch.zeros(1, dtype=torch.int32,
                                    device=args[0].device)
    outs = as_tuple(fn(*args, **kw_c))

    def wrapper():
        return fn(*args, **kw_c)
    ms = event_ms(wrapper, reps)
    if name == "admit_scan_preempt":
        check(int(kw_c["error"].item()) == 0, f"{name}: error word set")
    bare_ms = (None if name == "burst_cycles"
               else event_ms(bare_launch(name, args, kw), reps))
    prof = profiled_period(wrapper, reps, name)
    require_kernel_time(name, prof, f"the kernels line's {name}")
    plain = plain_fns()[name]
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bytes_ms = bound_bytes(name, args, outs) / PEAK_BYTES_PER_S * 1e3
    ops_ms = op_count(name, args, kw) / PEAK_OPS_PER_S * 1e3
    lib = library_call(name, args)
    if name == "kq_cycle_order":
        check(torch.equal(lib().to(torch.int32), outs[0]),
              "the composed-key argsort differs from kq_cycle_order")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=event_ms(lib, reps) if lib is not None else None,
                bare_ms=bare_ms,
                kernel_ms=prof["kernel_us"] / 1e3,
                kernel_records=prof["kernel_records"])


def bare_launch(name, args, kw):
    """The kernel's C function as one wrapper call issues it, with the
    wrapper's checks, allocations and argument packing done once: a
    callable that re-issues only the C call on the current stream (and
    counts nowhere)."""
    import ctypes
    import torch
    from kueue_tpu_torch import kernels
    seen = []
    real = kernels._launch
    kernels._launch = lambda _name, fn, *a: seen.append((fn, a))
    try:
        outs = cuda_fns()[name](*args, **cuda_kw(kw))
    finally:
        kernels._launch = real
    check(len(seen) == 1, f"{name}: {len(seen)} launches in one call")
    fn, a = seen[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*a, stream) != 0:
            raise RuntimeError(f"{name}: bare launch failed")
        return outs
    return call


def profiled_period(fn, reps: int, name: str | None = None) -> dict:
    """``reps`` calls of ``fn`` queued behind a busy stream under the
    profiler's CUDA activity, in microseconds: per call the summed
    duration of the activities it issued and the start-to-start period
    of its first activity (``DeviceClock`` leaves the spins out), the
    mean duration of kernel ``name``'s own launches (``kernel_us``, None
    when the profiler recorded none of them), how many it recorded
    (``kernel_records``) and whether it recorded the 100 M-cycle spin
    (``spin_seen``: a spin longer than a millisecond).  A profiler that
    raises fails the run."""
    import torch
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.profiling import DeviceClock
    fn()
    torch.cuda.synchronize()
    with DeviceClock() as clk:
        torch.cuda._sleep(100_000_000)
        for _ in range(reps):
            fn()
    spans = sorted(s for v in clk.spans_us.values() for s in v)
    own = [t1 - t0 for n, v in clk.spans_us.items()
           if name is not None and kernels.launcher_of(n) == name
           for t0, t1 in v]
    out = dict(activities_per_call=len(spans) / reps,
               spin_seen=any(t1 - t0 > 1e3 for t0, t1 in clk.spin_us),
               kernel_records=len(own),
               kernel_us=sum(own) / len(own) if own else None)
    if not spans:
        return out
    per = max(1, round(len(spans) / reps))     # activities per call
    firsts = [spans[i][0] for i in range(0, len(spans), per)]
    return dict(
        out, device_us_per_call=sum(t1 - t0 for t0, t1 in spans) / reps,
        period_us=((firsts[-1] - firsts[0]) / (len(firsts) - 1)
                   if len(firsts) > 1 else None),
        names=sorted(clk.spans_us))


def require_kernel_time(name, prof, what: str) -> None:
    """A profiled run of ``name``'s kernel must give its own duration: a
    kernel that launched without one fails the run."""
    check(prof.get("kernel_us") is not None,
          f"{what}: the profiler recorded no launch of {name} "
          f"({json.dumps({k: prof.get(k) for k in ('kernel_records', 'activities_per_call', 'spin_seen', 'names')})})")


def profiler_clock_offset(reps: int = 20, margin_s: float = 1.0) -> dict:
    """Microseconds from the start of a host op (``aten::zero_``, the
    host's clock) to the start of its kernel (the device's timestamp as
    the profiler converts it), one-element zeroings on an idle card
    inside a window held open ``margin_s`` at each end: a few
    microseconds when the two clocks agree; its change over a run is the
    drift of the conversion (``DeviceClock.MARGIN_S`` must exceed it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(reps):
            x.zero_()
            torch.cuda.synchronize()
        time.sleep(margin_s)
    ev = prof.events()
    ops = sorted(e.time_range.start for e in ev if e.name == "aten::zero_"
                 and e.device_type == DeviceType.CPU)
    ks = sorted(e.time_range.start for e in ev
                if e.device_type == DeviceType.CUDA)
    off = sorted(k - o for o, k in zip(ops, ks))
    return dict(ops=len(ops), kernels=len(ks),
                median_us=off[len(off) // 2] if off else None,
                min_us=off[0] if off else None)


def launch_breakdown(cases, reps: int = 200) -> list:
    """Phase 3j: for each (label, kernel, args, kw), ms per call back to
    back behind a busy stream (``event_ms``) of (a) the wrapper, (b) the
    bare C launch and (c) the library call, beside a one-element
    ``zero_()`` (the floor of any launch); then the same launches under
    the profiler (``profiled_period``)."""
    import torch
    rows = []
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    for label, name, args, kw in cases:
        def wrapper():
            return cuda_fns()[name](*args, **cuda_kw(kw))
        calls = dict(wrapper=wrapper, bare=bare_launch(name, args, kw),
                     library=library_call(name, args), zero=tiny.zero_)
        row = dict(case=label, kernel=name)
        for mode, fn in calls.items():
            row[f"{mode}_ms"] = event_ms(fn, reps)
        for mode, fn in calls.items():
            row[f"{mode}_profiled"] = profiled_period(fn, reps, name)
            if mode in ("wrapper", "bare"):
                require_kernel_time(name, row[f"{mode}_profiled"],
                                    f"3j {label} ({mode})")
        rows.append(row)
    return rows


def host_drs(snapshot) -> dict:
    """cache.state.dominant_resource_share of every CQ and cohort."""
    from kueue_tpu_torch.cache.state import dominant_resource_share
    from kueue_tpu_torch.ops.packing import _iter_nodes
    cq_names, cohorts = _iter_nodes(snapshot)
    nodes = [snapshot.cluster_queues[n] for n in cq_names] + cohorts
    return {n.name: dominant_resource_share(n)[0] for n in nodes}


def most_heads(calls):
    """The captured fs_admit_scan call with the most valid heads."""
    return max(calls, key=lambda call: int(call[0][17].sum()))


def mesh_shape(name, args) -> dict:
    """W, shards and heads of a captured gather (planes, src, fills) or
    merge (winners, head_of, W) call."""
    if name == "kq_gather_heads":
        return dict(W=int(args[1].shape[0]), S=len(args[0][0]),
                    heads=int((args[1] >= 0).sum()))
    return dict(W=int(args[2]), S=len(args[1]),
                heads=int(sum(h.numel() for h in args[1])))


def widest_mesh(name, calls):
    """The captured gather or merge call over the most heads (its W),
    then the most shards."""
    return max(calls, key=lambda call: (mesh_shape(name, call[0])["W"],
                                        mesh_shape(name, call[0])["S"]))


def per_launch(dc, name) -> float:
    """A kernel's mean device ms over the launches the profiler recorded
    in a phase."""
    return dc.kernel_ms[name] / max(1, dc.kernel_count[name])


def device_line(tag, dc, wall_s: float, launches: dict) -> str:
    """A phase's device time from the profiler's CUDA activity
    (``profiling.DeviceClock``): each kernel's ms, every other
    activity's ms (the three largest by name), the busy union and its
    share of the phase's wall, and the launches the profiler did not
    record; the phase fails when the profiler saw nothing on the
    card."""
    from kueue_tpu_torch import kernels
    check(dc.activities > 0, f"phase {tag}: no device activity profiled")
    other = sorted(((sum(t1 - t0 for t0, t1 in v) / 1e3, n[:60])
                    for n, v in dc.spans_us.items()
                    if kernels.launcher_of(n) is None), reverse=True)[:3]
    missed = {k: launches[k] - dc.kernel_count[k] for k in launches
              if launches[k] != dc.kernel_count[k]}
    return (f"device (profiler) kernels_ms "
            f"{json.dumps({k: v for k, v in dc.kernel_ms.items() if v})}, "
            f"other {dc.other_ms:.3f}ms (largest "
            f"{json.dumps([[n, round(ms, 3)] for ms, n in other])}), busy "
            f"{dc.busy_ms:.3f}ms (busy share "
            f"{dc.busy_ms / 1e3 / wall_s:.6f}), {dc.activities} activities, "
            f"launches not recorded {json.dumps(missed)}")


def mesh_line(tag, d, r, launches, dc, digest, ref, wall_ref, gcw):
    from kueue_tpu_torch import scenarios
    ss = d.scheduler.solver.stats
    pct = scenarios.percentile
    keys = ("sharded_dispatches", "sharded_preempt_dispatches",
            "sharded_fs_dispatches", "sharded_empty_shards",
            "sharded_shard_launches", "full_cycles", "fs_full_cycles",
            "classify_cycles", "host_cycles", "skipped_dispatches",
            "singleton_dispatches")
    log(f"[{tag}] mesh {d.scheduler.solver.mesh.shape} (virtual, cuda:0), "
        f"{r['cycles']} cycles in {r['wall']:.2f}s (serial {wall_ref:.2f}s),"
        f" cycle p50 {pct(r['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r['cycle_times'], 0.99) * 1e3:.3f}ms, mean "
        f"{r['wall'] / r['cycles'] * 1e3:.3f}ms, {gcw.line()}; digest "
        f"{digest} (serial {ref}); stats "
        f"{json.dumps({k: ss.get(k) for k in keys})}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; "
        f"{device_line(tag, dc, r['wall'], launches)}")


def most_rows(calls):
    """The captured row scatter that writes the most rows."""
    return max(calls, key=lambda call: int(call[0][2]))


def largest(calls):
    """The captured call with the most heads (admit scans, [N, F] usage)
    or searches (the batched search, [S, NL, F] usage)."""
    def size(call):
        args = call[0]
        return args[0].shape[0] if args[0].dim() == 3 else args[8].shape[0]
    return max(calls, key=size)


def widest(calls):
    """The captured phase-1 call over the most heads (rows of its first
    argument)."""
    return max(calls, key=lambda call: call[0][0].shape[0])


def deepest(calls):
    """The captured best_fit_descend call that walks the most levels."""
    return min(calls, key=lambda call: call[1]["level"])


def burst_window(calls):
    """The captured burst window to time: the last one kept, which is a
    window with preemption whenever the phase had one."""
    return calls[-1]


def boundary_report(bstats: dict) -> str:
    """The harness's ``burst_boundary_report`` of ``BurstSolver.stats``,
    then the forest-sharded burst's two counters, under their stats
    names, where the run has them."""
    from kueue_tpu_torch.perf.harness import burst_boundary_report
    shard = {k: bstats[k] for k in ("burst_sharded_dispatches",
                                    "burst_shard_degradations")
             if k in bstats}
    return (json.dumps(burst_boundary_report(bstats))
            + (f" {json.dumps(shard)}" if shard else ""))


def burst_line(tag, d, r, launches) -> None:
    bs = d._burst_solver.stats
    ss = d.scheduler.solver.stats
    log(f"[{tag}] burst_cycles launches {launches['burst_cycles']}, "
        f"cycles decided {bs['burst_cycles_decided']}, dispatches "
        f"{bs['burst_dispatches']} (spec {bs['burst_spec_dispatches']}, "
        f"overlapped {bs['burst_overlapped_packs']}, cancelled "
        f"{bs['burst_spec_cancelled']}), preempt cycles in bursts "
        f"{bs['burst_preempt_cycles']}, dirty cycles "
        f"{bs['burst_dirty_cycles']} (preempt {bs['burst_dirty_preempt']}, "
        f"scalar {bs['burst_dirty_scalar']}), suppressed "
        f"{bs['burst_suppressed_cycles']}, target divergences "
        f"{bs['burst_target_divergences']}; per-cycle fallbacks: full "
        f"{ss['full_cycles']} classify {ss['classify_cycles']} host "
        f"{ss['host_cycles']}; boundary "
        f"{boundary_report(bs)}; launches "
        f"{json.dumps(launches)}")


def calibrated_warmup(n_cqs: int, n_wl: int):
    """Phase 35 (a) and (b): the north-star cluster on a card Driver
    under the calibrated "auto", then its warm-up, timed apart from the
    kernel library's load (``scenarios.warmup_record``), with the
    launches it made and the sidecars in the cache directory →
    (record, driver)."""
    from kueue_tpu_torch import compilecache, kernels, scenarios
    d, _, _, _ = scenarios.build_northstar(n_cqs, n_wl, device="cuda")
    kernels.reset_counts()
    rec = scenarios.warmup_record(d, n_cqs)
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["sidecars"] = sorted(f for f in os.listdir(compilecache.enable())
                             if f.startswith("calibration-"))
    return rec, d


def phase35_card(n_cqs: int, n_wl: int) -> dict:
    """Phase 35's card side, in a card child: (a) the cold warm-up in
    this fresh process, on a cache directory of its own; (b) a second
    cold process on that directory; (c) the sidecar's schema made stale,
    then a new solver's warm-up on (a)'s snapshot."""
    import tempfile
    from kueue_tpu_torch import compilecache, scenarios
    from kueue_tpu_torch.ops.solver import CALIB_SCHEMA, CycleSolver
    from kueue_tpu_torch.features import env_value
    os.environ["KUEUE_TPU_COMPILE_CACHE"] = tempfile.mkdtemp(
        prefix="phase35_", dir=env_value("KUEUE_TPU_COMPILE_CACHE"))
    out = {}
    a, d = calibrated_warmup(n_cqs, n_wl)
    out["a"] = a
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, chip_smoke as cs\n"
            f"print(json.dumps(cs.calibrated_warmup({n_cqs}, {n_wl})[0]))\n")
    # one torch thread, as the arm that starts it
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=here, env=env,
                       capture_output=True, text=True, timeout=900)
    check(r.returncode == 0,
          f"phase 35 (b) exited {r.returncode}: {r.stderr[-3000:]}")
    out["b"] = dict(json.loads(r.stdout.strip().splitlines()[-1]),
                    process_s=time.perf_counter() - t0)
    check(len(a["sidecars"]) == 1, a["sidecars"])
    path = os.path.join(compilecache.enable(), a["sidecars"][0])
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    data["schema"] = CALIB_SCHEMA - 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh)
    s = CycleSolver(device="cuda")
    t0 = time.perf_counter()
    s.warmup(d.cache.snapshot(), n_cqs)
    with open(path, encoding="utf-8") as fh:
        rewritten = json.load(fh)["schema"]
    out["c"] = dict(warmup_s=time.perf_counter() - t0,
                    rewritten_schema=rewritten,
                    **{k: s.stats[k] for k in scenarios.CALIBRATION_STATS})
    return out


def phase35_drains(bench_workloads: int, n_cqs: int, n_wl: int,
                   cycles: int) -> dict:
    """Phase 35 (d), in this process with no arm running and no profiler
    (clean walls): perf-15k drained and the north-star shape run per
    cycle (phase 5's) under each of ``CALIB_BACKENDS``, each warmed up
    first → {shape: {backend: record}}."""
    from kueue_tpu_torch import kernels, scenarios
    out = {}
    for shape in ("perf-15k", "northstar"):
        out[shape] = {}
        for backend in CALIB_BACKENDS:
            if shape == "perf-15k":
                d, clock, total, waves = scenarios.build_bench(
                    bench_workloads / 15_000, device="cuda",
                    solver_backend=backend)
                heads = len(d.cache.cluster_queue_names())
            else:
                d, clock, total, waves = scenarios.build_northstar(
                    n_cqs, n_wl, device="cuda", solver_backend=backend)
                heads = n_cqs
            w = scenarios.warmup_record(d, heads)
            kernels.reset_counts()
            r = (scenarios.run_bench(d, clock, total, waves)
                 if shape == "perf-15k" else
                 scenarios.run_northstar(d, clock, waves, cycles=cycles))
            out[shape][backend] = dict(
                warmup=w, routes=scenarios.route_counts(d.scheduler.solver),
                finished=r.get("finished"), admitted=r.get("admitted"),
                preempted=r.get("preempted"), total=total, cycles=r["cycles"],
                wall=r["wall"],
                p50_ms=scenarios.percentile(r["cycle_times"], 0.5) * 1e3,
                p99_ms=scenarios.percentile(r["cycle_times"], 0.99) * 1e3,
                digest=scenarios.decision_digest(d, r["decisions"]),
                launches=dict(kernels.LAUNCHES))
            del d, waves
            scenarios.release()
    return out


class Launcher:
    """A small process, started before this one imports torch, that runs
    one command for it.  A child's ``ru_maxrss`` starts from the resident
    high-water mark of the process it was forked from (Linux carries it
    across exec), so a command started from here would report this run's
    gigabytes; started from the launcher it reports its own."""

    CODE = ("import json, subprocess, sys\n"
            "req = json.loads(sys.stdin.readline() or 'null')\n"
            "if req:\n"
            "    r = subprocess.run(req['cmd'], cwd=req['cwd'], "
            "env=req['env'], capture_output=True, text=True, "
            "timeout=req['timeout'])\n"
            "    sys.stdout.write(json.dumps([r.returncode, r.stdout, "
            "r.stderr]))\n")

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, "-c", self.CODE],
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def run(self, cmd: list, cwd: str, env: dict, timeout: float):
        """``subprocess.run(cmd, ...)`` in the launcher (killed after
        ``timeout`` seconds); the launcher exits afterwards."""
        out, _ = self.proc.communicate(json.dumps(dict(
            cmd=cmd, cwd=cwd, env=env, timeout=timeout)) + "\n",
            timeout=timeout + 60)
        rc, stdout, stderr = json.loads(out or "[null, \"\", \"\"]")
        return subprocess.CompletedProcess(cmd, rc, stdout, stderr)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


# the CPU-only parity arms of phases 10, 12, 18, 20, 22, 25 and 26: the
# same scenario on "cpu" as the phase holds against the card, run in a child
# process on one torch thread from the build on, beside the card's
# phases, and read where the phase checks it (format: NORTHSTAR,
# TAS_CYCLES)
CPU_ARM_CODE = {
    "10": """
d, clock, total = scenarios.build_northstar_fs({n_cqs}, {n_wl}, device="cpu")
r = scenarios.run_northstar_fs(d, clock, cycles={cycles})
out = dict(total=total, cycles=r["cycles"], wall=r["wall"],
           admitted=r["admitted"], skipped=r["skipped"],
           fs_full_cycles=d.scheduler.solver.stats["fs_full_cycles"],
           digest=scenarios.decision_digest(d, r["decisions"]))
""",
    "12": """
out = {{}}
for label, device_kernel in (("plain", True), ("host walk", False)):
    with scenarios.tas_gates(device_kernel=device_kernel):
        d, clock, runtimes = scenarios.build_tas(device="cpu")
        with scenarios.TASBranches() as br:
            r = scenarios.run_tas(d, clock, runtimes, cycles={tas_cycles})
    out[label] = dict(cycles=r["cycles"], wall=r["wall"],
                      admitted=r["admitted"], counts=dict(br.counts),
                      digest=scenarios.tas_digest(d, r))
    del d
    scenarios.release()
""",
    "18": """
with scenarios.restore_gates():
    d, clock, mgr, plan = scenarios.build_jobs(device="cpu")
    r = scenarios.run_jobs(d, clock, mgr, plan)
out = dict(steps=r["steps"], wall=r["wall"], admitted=r["admitted"],
           digest=scenarios.jobs_digest(d, r))
""",
    # phase 24's CPU side: the apply on the card (a CLI child, into a/),
    # a copy of its store for (b) and applied.json for phase 24; (b) the
    # schedule on "cpu"; then (d)'s sequence on "cpu" on a copy of (b)'s
    # store (format: CLI_DIR, CLI_SERVE)
    "24": """
import contextlib, io, shutil, subprocess
from kueue_tpu_torch import cli
td = {td!r}
cwd, env = scenarios.cli_env()
t1 = time.perf_counter()
r = subprocess.run(scenarios.cli_argv(td + "/a", "cuda", "apply", "-f",
                                      td + "/bench.yaml"),
                   cwd=cwd, env=env, capture_output=True, text=True)
applied = dict(rc=r.returncode, apply_s=time.perf_counter() - t1,
               err=r.stderr[-3000:], workloads=sum(
                   doc["kind"] == "Workload"
                   for doc in cli.Store(td + "/a").docs))
shutil.copytree(td + "/a", td + "/b")
with open(td + "/applied.tmp", "w") as fh:
    json.dump(applied, fh)
shutil.move(td + "/applied.tmp", td + "/applied.json")
buf = io.StringIO()
t1 = time.perf_counter()
with contextlib.redirect_stdout(buf):
    rc = cli.main(["--state-dir", td + "/b", "--device", "cpu", "schedule",
                   "--cycles", "1000"])
out = dict(schedule_rc=rc, schedule_s=time.perf_counter() - t1,
           schedule_out=buf.getvalue(),
           digest_b=scenarios.store_digest(td + "/b"))
shutil.copytree(td + "/b", td + "/d_cpu")
seq = scenarios.cli_serve_sequence(
    td + "/d_cpu", td + "/serve.yaml", "cpu",
    ["default/serve-" + str(i) for i in range({cli_serve})])
out["seq"] = {{k: seq[k] for k in ("ready_s", "rc", "admitted_in_dump",
                                   "digest", "ok")}}
""",
    # phase 25's host-walk oracle (the twin's run_path with the host
    # solver) and phase 26's delta-pack serial arm at 1,000 CQs, on "cpu"
    # (format: NS_HETERO, NS_PACK_PARITY)
    "25": """
from kueue_tpu_torch import northstar
args = northstar.parse_args({ns_hetero!r} + ["--torch-device", "cpu"])
rec = []
t1 = time.perf_counter()
o = northstar.run_path(args, False, rec)
out = dict(out=o, digest=rec[0]["digest"], arm_s=time.perf_counter() - t1)
""",
    "26": """
from kueue_tpu_torch import northstar
args = northstar.parse_args({ns_parity!r} + ["--torch-device", "cpu"])
rec = []
o = northstar.run_burst_path(args, "cpu", rec)
out = dict(digest=rec[0]["digest"], admitted=o["admitted"],
           trickle=o["trickle"])
""",
    # phases 27-29's CPU sides: the chaos scenarios at 100 CQs, obs's
    # lockstep pair and scale's stream arm at 1,000 CQs, on "cpu" (format:
    # CHAOS_PARITY, OBS_PAIR, SCALE_PARITY)
    "27": """
from kueue_tpu_torch import chaos_soak
import contextlib, io
with contextlib.redirect_stderr(io.StringIO()):
    tail = chaos_soak.run(chaos_soak.parser().parse_args(
        {chaos_parity!r} + ["--torch-device", "cpu"]))
out = dict(stable=tail["scenarios_stable"], total=tail["scenarios_total"],
           digests=dict((n, s_.get("state_digest"))
                        for n, s_ in tail["scenarios"].items()))
""",
    "28": """
from kueue_tpu_torch import obs_soak
p = obs_soak.run_pair({obs_cycles}, {obs_runtime}, {obs_shape!r}, "cpu")
out = dict(digests=p["digests"], admitted=p["admitted"])
""",
    "29": """
from kueue_tpu_torch import scale_soak
import contextlib, io
with contextlib.redirect_stderr(io.StringIO()):
    e = scale_soak.e2e_arm("stream", {scale_n}, {scale_rounds}, {scale_n},
                           {scale_seed}, per_cq=4, device="cpu")
out = dict(digest=scenarios.records_digest(e["decisions"]),
           n_cycles=e["n_cycles"])
""",
    # phases 30-32's CPU sides: the three twins at --quick on "cpu", what
    # each decided (format: TRAFFIC_ARGS, SERVE_ARGS, FED_ARGS)
    "30-32": """
from kueue_tpu_torch import federation_soak, serve_soak, traffic_soak
import contextlib, io
out = dict()
for tag, mod, argv in (("30", traffic_soak, {traffic_args!r}),
                       ("31", serve_soak, {serve_args!r}),
                       ("32", federation_soak, {fed_args!r})):
    args = mod.parser().parse_args(argv + ["--torch-device", "cpu"])
    record = dict()
    with contextlib.redirect_stderr(io.StringIO()):
        tail = (mod.run(args, record) if mod is traffic_soak
                else mod.run(args))
    scenarios.release()
    out[tag] = dict(decided=mod.decided(tail),
                    record=dict((str(k), v) for k, v in record.items()))
""",
    # phases 20's and 22's CPU sides: the provisioning drain at 3,000
    # workloads and the federation control at 1,000 events on "cpu", each
    # with its digest (format: PARITY_SCALE, FED, FED_PARITY_EVENTS)
    "20-22": """
import tempfile
out = dict()
d, clock, ctrl, total, waves, revoke = scenarios.build_provisioning(
    {parity_scale}, device="cpu")
r = scenarios.run_provisioning(d, clock, ctrl, total, waves, revoke)
out["20"] = dict(total=total, cycles=r["cycles"], wall=r["wall"],
                 admitted=r["admitted"], finished=r["finished"],
                 rejected=r["rejected"], digest=scenarios.decision_digest(
                     d, [r["decisions"], r["requests"], r["reached"]]))
del d, ctrl, waves, revoke, r
scenarios.release()
m = scenarios.serving_modules("cpu")
t1 = time.perf_counter()
sim, ok = scenarios.fed_arm(dict({fed!r}, events={fed_parity_events}),
                            {fed_seed}, tempfile.mkdtemp(), m=m)
out["22"] = dict(steps=sim.step_no, settled=ok, s=time.perf_counter() - t1,
                 digest=m.fed.global_digest(sim))
""",
    # phase 35's CPU side: the perf scenario on "cpu" under the
    # calibrated "auto" (the plain versions against the native loop),
    # warmed up first (format: BENCH_WORKLOADS)
    "35": """
d, clock, total, waves = scenarios.build_bench({bench_workloads} / 15_000,
                                               device="cpu")
w = scenarios.warmup_record(d, len(d.cache.cluster_queue_names()))
r = scenarios.run_bench(d, clock, total, waves)
out = dict(digest=scenarios.decision_digest(d, r["decisions"]),
           finished=r["finished"], wall=r["wall"], warmup=w,
           routes=scenarios.route_counts(d.scheduler.solver))
""",
    # phase 33's CPU side: the dist twin at --quick with every child on
    # "cpu", what it decided (format: DIST_ARGS)
    "33": """
from kueue_tpu_torch import dist_soak
import contextlib, io
rec = dict()
with contextlib.redirect_stderr(io.StringIO()):
    tail = dist_soak.run(dist_soak.parser().parse_args(
        {dist_args!r} + ["--torch-device", "cpu"]), rec)
out = dict(decided=dist_soak.decided(tail), all_ok=tail["all_ok"],
           problems=dist_soak.check(rec))
""",
}
# phases 25 and 26 on the card in a child process started before phase 16,
# beside phases 16-24: the twin's three --ab-hetero card arms, its
# --ab-pack arms and the card side of 26's card-against-CPU check, each
# with its launches and its profiler reading, then the calls captured in
# them against the plain versions (3l) (format: NS_HETERO, NS_PACK,
# NS_PACK_PARITY)
CARD_ARM_CODE = {
    "25-26": """
import contextlib, io
import chip_smoke as cs
from kueue_tpu_torch import northstar
from kueue_tpu_torch.parallel import sharded
from kueue_tpu_torch.profiling import DeviceClock
kernels.load()
stats = dict((k, dict(cases=0, mismatches=0, max_abs_err=0))
             for k in kernels.KERNELS)
cap = cs.Capture()
quiet = io.StringIO()
out = dict()
args = northstar.parse_args({ns_hetero!r} + ["--torch-device", "cuda:0"])
rec = []
runs, walls, arm_launches = dict(), dict(), dict()
cs.install_capture(cap)
cs.install_shard_capture(cap)
cap.phase = "northstar_hetero"
kernels.reset_counts()
t1 = time.perf_counter()
with DeviceClock() as dc, contextlib.redirect_stderr(quiet):
    with sharded.virtual_mesh("cuda:0", args.ab_shards):
        for arm in ("in_kernel", "burst", "sharded"):
            before = dict(kernels.LAUNCHES)
            args.shards = args.ab_shards if arm == "sharded" else 0
            t2 = time.perf_counter()
            runs[arm] = [northstar.run_path(args, True, rec)
                         if arm == "in_kernel" else
                         northstar.run_burst_path(args, "accel", rec)]
            walls[arm] = time.perf_counter() - t2
            arm_launches[arm] = dict(
                (k, kernels.LAUNCHES[k] - before[k]) for k in kernels.KERNELS
                if kernels.LAUNCHES[k] != before[k])
            scenarios.release()
        args.shards = 0
        mesh = northstar.mesh_info(args.ab_shards, "cuda:0", True)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
cap.uninstall()
out["25"] = dict(runs=runs, walls=walls, arm_launches=arm_launches,
                 launches=launches, mesh=mesh, wall=wall,
                 digests=dict((e["path"], e["digest"]) for e in rec),
                 device=cs.device_line("25", dc, wall, launches))
args = northstar.parse_args({ns_pack!r} + ["--torch-device", "cuda:0"])
rec = []
cs.install_capture(cap)
cap.phase = "northstar_trickle"
kernels.reset_counts()
t1 = time.perf_counter()
with DeviceClock() as dc, contextlib.redirect_stderr(quiet):
    tail = northstar.run(args, rec)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
cap.uninstall()
scenarios.release()
out["26"] = dict(tail=tail, launches=launches, wall=wall,
                 digests=dict((e["path"], e["digest"]) for e in rec),
                 device=cs.device_line("26", dc, wall, launches))
args = northstar.parse_args({ns_parity!r} + ["--torch-device", "cuda:0"])
rec = []
kernels.reset_counts()
t1 = time.perf_counter()
with contextlib.redirect_stderr(quiet):
    r = northstar.run_burst_path(args, "accel", rec)
scenarios.release()
out["26p"] = dict(admitted=r["admitted"], trickle=r["trickle"],
                  digest=rec[0]["digest"], wall=time.perf_counter() - t1,
                  launches=dict(kernels.LAUNCHES))
n = dict()
for phase in ("northstar_hetero", "northstar_trickle"):
    for name in kernels.KERNELS:
        for a, kw in cap.calls.get((phase, name), []):
            cs.compare(name, a, kw, stats)
            n[name] = n.get(name, 0) + 1
out["3l"] = dict(captured=n, stats=dict((k, stats[k]) for k in n))
""",
}
# phases 27-29 on the card in a child process started after the build,
# beside phases 3-26: the three soak twins through their entry points'
# ``run``, each with its launches (27 and 29 also with the profiler's
# reading; 28's overhead A/B runs without it), and the card sides of their
# card-against-CPU checks (format: CHAOS_ARGS, CHAOS_PARITY, OBS_ARGS,
# OBS_PAIR, SCALE_ARGS)
CARD_ARM_CODE["27-29"] = """
import contextlib, io
import chip_smoke as cs
from kueue_tpu_torch import chaos_soak, obs_soak, scale_soak
from kueue_tpu_torch.perf.validate import validate_tail
from kueue_tpu_torch.profiling import DeviceClock
kernels.load()
quiet = io.StringIO()
out = dict()
args = chaos_soak.parser().parse_args({chaos_args!r} + ["--torch-device",
                                                       "cuda:0"])
kernels.reset_counts()
t1 = time.perf_counter()
with DeviceClock() as dc, contextlib.redirect_stderr(quiet):
    tail = chaos_soak.run(args)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
scenarios.release()
out["27"] = dict(tail=tail, launches=launches, wall=wall,
                 problems=validate_tail(tail, "CHAOS_r09.json"),
                 device=cs.device_line("27", dc, wall, launches))
t1 = time.perf_counter()
with contextlib.redirect_stderr(quiet):
    tail = chaos_soak.run(chaos_soak.parser().parse_args(
        {chaos_parity!r} + ["--torch-device", "cuda:0"]))
scenarios.release()
out["27p"] = dict(stable=tail["scenarios_stable"],
                  total=tail["scenarios_total"],
                  digests=dict((n, s_.get("state_digest"))
                               for n, s_ in tail["scenarios"].items()),
                  wall=time.perf_counter() - t1)
args = obs_soak.parser().parse_args({obs_args!r} + ["--torch-device",
                                                   "cuda:0"])
kernels.reset_counts()
t1 = time.perf_counter()
with contextlib.redirect_stderr(quiet):
    tail, ok = obs_soak.run(args)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
p = obs_soak.run_pair({obs_cycles}, {obs_runtime}, {obs_shape!r}, "cuda:0")
scenarios.release()
out["28"] = dict(tail=tail, ok=ok, launches=launches, wall=wall,
                 problems=validate_tail(tail, "OBS_r16.json"),
                 pair=dict(digests=p["digests"], admitted=p["admitted"]))
args = scale_soak.parser().parse_args({scale_args!r} + ["--torch-device",
                                                       "cuda:0"])
record = dict()
kernels.reset_counts()
t1 = time.perf_counter()
with DeviceClock() as dc, contextlib.redirect_stderr(quiet):
    tail, ok = scale_soak.run(args, record)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
scenarios.release()
out["29"] = dict(tail=tail, ok=ok, launches=launches, wall=wall,
                 record=dict((str(k), v) for k, v in record.items()),
                 problems=validate_tail(tail, "SCALE_r19.json"),
                 device=cs.device_line("29", dc, wall, launches))
"""
# phases 30-32 on the card in a child process started after the build,
# beside phases 3-29: the traffic, serve and federation twins through
# their entry points' ``run`` at --quick, each with its launches, the
# profiler's reading, what it decided and the port's copy of its kind's
# checks (format: TRAFFIC_ARGS, SERVE_ARGS, FED_ARGS)
CARD_ARM_CODE["30-32"] = """
import contextlib, io
import chip_smoke as cs
from kueue_tpu_torch import federation_soak, serve_soak, traffic_soak
from kueue_tpu_torch.perf.validate import validate_tail
from kueue_tpu_torch.profiling import DeviceClock
kernels.load()
quiet = io.StringIO()
out = dict()
for tag, mod, argv, name in (
        ("30", traffic_soak, {traffic_args!r}, "TRAFFIC_r21.json"),
        ("31", serve_soak, {serve_args!r}, "SERVE_r21.json"),
        ("32", federation_soak, {fed_args!r}, "FED_r21.json")):
    args = mod.parser().parse_args(argv + ["--torch-device", "cuda:0"])
    record = dict()
    kernels.reset_counts()
    t1 = time.perf_counter()
    with DeviceClock() as dc, contextlib.redirect_stderr(quiet):
        tail = (mod.run(args, record) if mod is traffic_soak
                else mod.run(args))
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    scenarios.release()
    out[tag] = dict(tail=tail, decided=mod.decided(tail),
                    record=dict((str(k), v) for k, v in record.items()),
                    launches=launches, wall=wall,
                    problems=validate_tail(tail, name),
                    device=cs.device_line(tag, dc, wall, launches))
"""
# phase 33 on the card in a child process started before phase 16, beside
# phases 16-32: the dist twin through its entry point's ``run`` at --quick,
# its children started from this child, with its launches and the
# profiler's reading (this child's: the controls and the federation
# manager), every child's argv and ``--stats-file`` report, what it
# decided and the port's copy of the DIST checks (format: DIST_ARGS)
CARD_ARM_CODE["33"] = """
import contextlib, io
import chip_smoke as cs
from kueue_tpu_torch import dist_soak
from kueue_tpu_torch.perf.validate import validate_tail
from kueue_tpu_torch.profiling import DeviceClock
kernels.load()
rec = dict()
args = dist_soak.parser().parse_args({dist_args!r} + ["--torch-device",
                                                     "cuda:0"])
kernels.reset_counts()
t1 = time.perf_counter()
with DeviceClock() as dc, contextlib.redirect_stderr(io.StringIO()):
    tail = dist_soak.run(args, rec)
wall = time.perf_counter() - t1
launches = dict(kernels.LAUNCHES)
out = dict()
out["33"] = dict(
    tail=tail, decided=dist_soak.decided(tail),
    children=dist_soak.children(tail, rec),
    argvs=[a for r in rec.values() for a in r["argvs"]],
    kids=dict((arm + "/" + n, st) for arm, r in rec.items()
              for n, st in r["child_stats"].items()),
    problems=validate_tail(tail, "DIST_r22.json") + dist_soak.check(rec),
    launches=launches, wall=wall,
    device=cs.device_line("33", dc, wall, launches))
"""
# phase 35 (a)-(c) on the card in a child process started before phase
# 16, beside phases 16-33 (walls not clean): phase35_card (format:
# NORTHSTAR)
CARD_ARM_CODE["35"] = """
import chip_smoke as cs
out = dict()
out["35"] = cs.phase35_card({n_cqs}, {n_wl})
"""
CPU_ARMS: dict = {}
CARD_ARMS: dict = {}
CACHE_DIR: list = []        # the run's KUEUE_TPU_COMPILE_CACHE
CLI_DIR: list = []          # phase 24's manifests and stores


def wait_for_json(path: str, timeout: float) -> dict:
    """The JSON object a child writes to ``path`` (by rename, whole)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"no {path} in {timeout}s")
        time.sleep(0.1)
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


class ChildArm:
    """A phase's arm in a child process: ``code[tag]`` (a CPU arm's
    ``CPU_ARM_CODE``, or the card arms' ``CARD_ARM_CODE``) on one torch
    thread, its ``out`` printed as the last line with the child's launch
    count (0 for a CPU arm: nothing runs on the card) and seconds."""

    def __init__(self, tag: str, code: dict):
        here = os.path.dirname(os.path.abspath(__file__))
        code = ("import json, time\nt0 = time.perf_counter()\n"
                "import torch\ntorch.set_num_threads(1)\n"
                "from kueue_tpu_torch import kernels, scenarios\n"
                + code[tag].format(
                    tas_cycles=TAS_CYCLES, td=CLI_DIR[0] if CLI_DIR else "",
                    cli_serve=CLI_SERVE, ns_hetero=NS_HETERO,
                    ns_pack=NS_PACK, ns_parity=NS_PACK_PARITY,
                    chaos_args=CHAOS_ARGS, chaos_parity=CHAOS_PARITY,
                    obs_args=OBS_ARGS, obs_cycles=OBS_PAIR["cycles"],
                    obs_runtime=OBS_PAIR["runtime"],
                    obs_shape=OBS_PAIR["shape"], scale_args=SCALE_ARGS,
                    scale_n=SCALE_PARITY["n"],
                    scale_rounds=SCALE_PARITY["rounds"],
                    scale_seed=SCALE_PARITY["seed"],
                    traffic_args=TRAFFIC_ARGS, serve_args=SERVE_ARGS,
                    fed_args=FED_ARGS, dist_args=DIST_ARGS,
                    parity_scale=PARITY_SCALE, fed=FED,
                    fed_parity_events=FED_PARITY_EVENTS,
                    fed_seed=FED["seed"], bench_workloads=BENCH_WORKLOADS,
                    **NORTHSTAR)
                + "out['launches'] = sum(kernels.LAUNCHES.values())\n"
                  "out['child_s'] = time.perf_counter() - t0\n"
                  "print(json.dumps(out))\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        self.tag = tag
        # a session of its own: stop() ends the arm and every child of it
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)

    def result(self, timeout: float = 1200) -> dict:
        out, err = self.proc.communicate(timeout=timeout)
        check(self.proc.returncode == 0,
              f"phase {self.tag}'s arm exited {self.proc.returncode}: "
              f"{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])

    def stop(self) -> None:
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()


def main() -> int:
    launcher = Launcher()   # while this process is still small
    try:
        return smoke(launcher)
    finally:
        launcher.close()
        for arm in list(CPU_ARMS.values()) + list(CARD_ARMS.values()):
            arm.stop()
        import shutil
        for d in CACHE_DIR:
            shutil.rmtree(d, ignore_errors=True)


def smoke(launcher: Launcher) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the router's sidecars of this run only, in every process it starts:
    # one left by an earlier run would make a cold warm-up load
    import tempfile
    CACHE_DIR.append(tempfile.mkdtemp(prefix="chip_smoke_calibration_"))
    os.environ["KUEUE_TPU_COMPILE_CACHE"] = CACHE_DIR[0]
    try:
        import numpy as np
        from kueue_tpu_torch import kernels, scenarios, testing
        from kueue_tpu_torch.profiling import DeviceClock
    except ImportError as e:
        print(f"chip_smoke: kueue_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 3
    t_start = time.perf_counter()

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.load()
    log(f"[2 build] {kernels.BUILD['library']} in "
        f"{time.perf_counter() - t0:.2f}s")
    clock_offset0 = profiler_clock_offset()
    CLI_DIR.append(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    docs24 = scenarios.cli_bench_docs(PARITY_SCALE)
    scenarios.write_manifests(f"{CLI_DIR[0]}/bench.yaml", docs24)
    scenarios.write_manifests(f"{CLI_DIR[0]}/cluster.yaml", [
        doc for doc in docs24 if doc["kind"] != "Workload"])
    scenarios.write_manifests(f"{CLI_DIR[0]}/serve.yaml",
                              scenarios.cli_serve_docs(CLI_SERVE))
    del docs24
    for tag in CPU_ARM_CODE:
        if tag not in ("33", "35"):
            CPU_ARMS[tag] = ChildArm(tag, CPU_ARM_CODE)
    # phases 27-29 and 30-32 on the card, beside phases 3-26
    # (CARD_ARM_CODE)
    CARD_ARMS["27-29"] = ChildArm("27-29", CARD_ARM_CODE)
    CARD_ARMS["30-32"] = ChildArm("30-32", CARD_ARM_CODE)

    # -- 3a. kernels against their plain versions: seeded sweep ------------
    stats = {k: dict(cases=0, mismatches=0, max_abs_err=0)
             for k in kernels.KERNELS}
    for seed in (0, 1):
        for name, arrays, kw in testing.kernel_cases(seed):
            args = [torch.from_numpy(a).cuda() for a in arrays]
            if name == "admit_scan_preempt":
                # the sweep's targets may lie in other forests
                fon, nf = testing.preempt_tables(arrays)
                kw = dict(kw, forest_of_node=torch.from_numpy(fon).cuda(),
                          n_forests=nf)
            compare(name, args, kw, stats)
        for _, arrays, kw in testing.burst_cases(seed):
            args = [torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                    else int(a) for a in arrays]
            compare("burst_cycles", args, kw, stats)
        for name, arrays, kw in testing.fs_cases(seed):
            compare(name, [torch.from_numpy(a).cuda() for a in arrays], kw,
                    stats)
        # kq_cq_avail's staged route at depth 1, 2, 3 and 17 (N = 12,288,
        # the widest it stages, with seed 0) and its global route
        for name, arrays, kw in testing.avail_cases(seed, card=seed == 0):
            compare(name, on_card(arrays), kw, stats)
    log(f"[3 kernels, sweep] {json.dumps(stats)}")

    cap = Capture()
    install_capture(cap)

    # -- 4. the reference perf scenario, full size ---------------------------
    d, clock, total, waves = scenarios.build_bench(
        BENCH_WORKLOADS / 15_000, device="cuda")
    # warm-up's launches are kept apart from the path's (3b holds them)
    cap.phase = "warmup"
    d.scheduler.solver.warmup(d.cache.snapshot(),
                              len(d.cache.cluster_queue_names()))
    cap.phase = "bench"
    kernels.reset_counts()
    with DeviceClock() as dc4:
        r = scenarios.run_bench(d, clock, total, waves)
    launches4 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    aps = r["finished"] / r["wall"]
    log(f"[4 bench] drained {r['finished']}/{r['total']} in "
        f"{r['cycles']} cycles, {r['wall']:.2f}s wall, {aps:.1f} "
        f"admissions/s, cycle p50 "
        f"{scenarios.percentile(r['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"preempted {r['preempted']}, full_cycles {ss['full_cycles']}, "
        f"host_cycles {ss['host_cycles']}, classify_cycles "
        f"{ss['classify_cycles']}; launches {json.dumps(launches4)}; "
        f"{device_line('4', dc4, r['wall'], launches4)}")
    digest4 = scenarios.decision_digest(d, r["decisions"])
    wall4 = r["wall"]
    log(f"[4 bench] digest {digest4}")
    check(r["finished"] == r["total"] == BENCH_WORKLOADS, r["finished"])
    check(r["preempted"] > 0, "no preemption in the perf scenario")
    check(ss["host_cycles"] == 0, ss)
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches4[k] > 0, (k, launches4))
    del d, waves
    scenarios.release()

    # -- 5. the north-star shape, per cycle ---------------------------------
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    cap.phase = "warmup"
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    cap.phase = "northstar"
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc5, GCWatch() as gc5:
        r5 = scenarios.run_northstar(d, clock, wave,
                                     cycles=NORTHSTAR["cycles"])
    launches5 = dict(kernels.LAUNCHES)
    log(f"[5 northstar] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r5['cycles']} cycles in "
        f"{r5['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r5['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r5['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r5['admitted']}, preempted {r5['preempted']}; "
        f"{gc5.line()}; launches {json.dumps(launches5)}; "
        f"{device_line('5', dc5, r5['wall'], launches5)}")
    digest5 = scenarios.decision_digest(d, r5["decisions"])
    log(f"[5 northstar] digest {digest5}")
    check(launches5["admit_scan_forests"] > 0, launches5)
    check(gc5.n == 0, f"phase 5: {gc5.line()}")
    del d
    scenarios.release()
    cap.uninstall()

    # -- 3b. kernels against their plain versions: captured planes ----------
    for (_, name), calls in cap.calls.items():
        for args, kw in calls:
            compare(name, args, kw, stats)
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, captured] {json.dumps(stats)}")

    # -- 6. card against CPU -----------------------------------------------
    digests = {}
    for dev in ("cuda", "cpu"):
        d, clock, total, waves = scenarios.build_bench(PARITY_SCALE,
                                                       device=dev)
        r6 = scenarios.run_bench(d, clock, total, waves)
        digests[dev] = scenarios.decision_digest(d, r6["decisions"])
        log(f"[6 parity] {dev}: {r6['finished']}/{total} drained, "
            f"{r6['preempted']} preempted, digest {digests[dev]}")
        check(r6["finished"] == total, f"{dev}: not drained")
        del d
        scenarios.release()
    check(digests["cuda"] == digests["cpu"], digests)
    digest6 = digests["cuda"]

    # -- 7. the perf scenario through the fused burst -------------------------
    install_capture(cap)
    d, clock, total, waves = scenarios.build_bench(
        BENCH_WORKLOADS / 15_000, device="cuda")
    cap.phase = "warmup"
    d.scheduler.solver.warmup(d.cache.snapshot(),
                              len(d.cache.cluster_queue_names()))
    cap.phase = "bench_burst"
    kernels.reset_counts()
    with DeviceClock() as dc7:
        r7 = scenarios.drain_bench_burst(d, clock, total, waves)
    launches7 = dict(kernels.LAUNCHES)
    log(f"[7 bench burst] drained {r7['finished']}/{r7['total']} in "
        f"{r7['cycles']} cycles, {r7['wall']:.2f}s wall, "
        f"{r7['finished'] / r7['wall']:.1f} admissions/s, cycle p50 "
        f"{scenarios.percentile(r7['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r7['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"preempted {r7['preempted']}, digest "
        f"{scenarios.decision_digest(d, r7['decisions'])}; "
        f"{device_line('7', dc7, r7['wall'], launches7)}")
    burst_line("7 bench burst", d, r7, launches7)
    check(r7["finished"] == r7["total"] == BENCH_WORKLOADS, r7["finished"])
    check(launches7["burst_cycles"] > 0, launches7)
    check(d._burst_solver.stats["burst_cycles_decided"] > 0, "no burst")
    del d, waves
    scenarios.release()
    cap.uninstall()

    # -- 7b. the burst on the card against the CPU --------------------------
    digests = {}
    for dev in ("cuda", "cpu"):
        d, clock, total, waves = scenarios.build_bench(PARITY_SCALE,
                                                       device=dev)
        r = scenarios.drain_bench_burst(d, clock, total, waves)
        digests[dev] = scenarios.decision_digest(d, r["decisions"])
        log(f"[7 burst parity] {dev}: {r['finished']}/{total} drained, "
            f"{r['preempted']} preempted, "
            f"{d._burst_solver.stats['burst_cycles_decided']} cycles "
            f"decided in bursts, digest {digests[dev]}")
        check(r["finished"] == total, f"{dev}: not drained")
        del d
        scenarios.release()
    check(digests["cuda"] == digests["cpu"], digests)

    # -- 8. the north-star shape through the fused burst ---------------------
    install_capture(cap)
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    cap.phase = "warmup"
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    cap.phase = "northstar_burst"
    build_s = time.perf_counter() - t0
    gc.collect()      # phases 8 and 15 start from a collected heap
    kernels.reset_counts()
    with DeviceClock() as dc8, GCWatch() as gc8:
        r8 = scenarios.northstar_burst(d, clock, wave,
                                       cycles=NORTHSTAR["cycles"])
    launches8 = dict(kernels.LAUNCHES)
    digest8 = scenarios.decision_digest(d, r8["decisions"])
    log(f"[8 northstar burst] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r8['cycles']} cycles in "
        f"{r8['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r8['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r8['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r8['admitted']}, preempted {r8['preempted']}, digest "
        f"{digest8}; {gc8.line()}; "
        f"{device_line('8', dc8, r8['wall'], launches8)}")
    burst_line("8 northstar burst", d, r8, launches8)
    check(r8["cycles"] == NORTHSTAR["cycles"], r8["cycles"])
    check(launches8["burst_cycles"] > 0, launches8)
    check(r8["preempted"] > 0, "no preemption in the north-star wave")
    check(gc8.n == 0, f"phase 8: {gc8.line()}")
    del d
    scenarios.release()
    cap.uninstall()

    # -- 3c. the burst kernel on the windows captured in phases 7 and 8 ------
    n_pre = 0
    for phase in ("bench_burst", "northstar_burst"):
        for name in kernels.KERNELS:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                if name == "burst_cycles":
                    out = plain_fns()[name](*on_cpu(args), **plain_kw(kw))
                    n_pre += int(bool((out[1] == KIND_PREEMPT).any()))
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    check(n_pre > 0, "no captured burst window with a preempting head")
    log(f"[3 kernels, captured bursts] {n_pre} windows with preemption; "
        f"{json.dumps(stats)}")

    # -- 9. fair sharing at the north-star size, on the card ------------------
    from kueue_tpu_torch.ops.fairsharing_kernel import compute_all_drs
    install_fs_capture(cap)
    cap.phase = "northstar_fs"
    t0 = time.perf_counter()
    d, clock, total = scenarios.build_northstar_fs(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc9:
        with GCWatch() as gc9:
            r9 = scenarios.run_northstar_fs(d, clock,
                                            cycles=NORTHSTAR["cycles"])
        snapshot = d.cache.snapshot()
        t_drs = time.perf_counter()
        drs = compute_all_drs(snapshot, device="cuda")
        drs_s = time.perf_counter() - t_drs
    launches9 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    digest9 = scenarios.decision_digest(d, r9["decisions"])
    log(f"[9 northstar fs] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r9['cycles']} cycles in "
        f"{r9['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r9['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r9['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r9['admitted']}, skipped {r9['skipped']}, "
        f"fs_full_cycles {ss['fs_full_cycles']}, fs_noop_skips "
        f"{ss['fs_noop_skips']}, fs_noop_reuses {ss['fs_noop_reuses']}, "
        f"classify_cycles {ss['classify_cycles']}, host_cycles "
        f"{ss['host_cycles']}; digest {digest9}; {gc9.line()}; launches "
        f"{json.dumps(launches9)}; "
        f"{device_line('9', dc9, r9['wall'], launches9)}")
    check(launches9["fs_admit_scan"] > 0, launches9)
    check(gc9.n == 0, f"phase 9: {gc9.line()}")
    check(ss["fs_full_cycles"] > 0, ss)
    check(r9["admitted"] > 0, "nothing admitted")
    host = host_drs(snapshot)
    log(f"[9 compute_all_drs] {len(drs)} nodes in {drs_s * 1e3:.3f}ms, "
        f"{sum(v > 0 for v in host.values())} borrowing, equal to the "
        f"host: {drs == host}")
    check(drs == host, "compute_all_drs differs from the host DRS")
    check(launches9["drs_components"] > 0, launches9)
    del d, snapshot
    scenarios.release()

    # -- 9b. compute_all_drs on a cluster that borrows ----------------------
    # (the north-star CQs fill their cohort's quota and never borrow)
    from kueue_tpu_torch.api import types as api_types
    from kueue_tpu_torch.controller.driver import Driver
    cap.phase = "fs_borrowing"
    kernels.reset_counts()
    for nested in (False, True):
        clock = scenarios.VirtualClock()
        d = Driver(clock=clock, fair_sharing=True, device="cuda")
        testing.fs_borrowing_cluster(api_types, d, clock, nested)
        snapshot = d.cache.snapshot()
        drs = compute_all_drs(snapshot, device="cuda")
        host = host_drs(snapshot)
        n_borrow = sum(v > 0 for v in host.values())
        log(f"[9b compute_all_drs] nested={nested}: {len(drs)} nodes, "
            f"{n_borrow} borrowing, DRS {sorted(host.values())}, equal to "
            f"the host: {drs == host}")
        check(drs == host, "compute_all_drs differs from the host DRS")
        check(n_borrow > 0, "no borrowing node")
    torch.cuda.synchronize()
    launches9b = dict(kernels.LAUNCHES)
    check(launches9b["drs_components"] == 2, launches9b)
    cap.uninstall()

    # -- 10. the same fair-sharing run on the CPU (its child, since 2) -------
    r10 = CPU_ARMS["10"].result()
    log(f"[10 fs parity] cpu (a child on one thread beside phases 3-9, "
        f"{r10['child_s']:.2f}s): {r10['total']} workloads, {r10['cycles']} "
        f"cycles in {r10['wall']:.2f}s, admitted {r10['admitted']}, skipped "
        f"{r10['skipped']}, fs_full_cycles {r10['fs_full_cycles']}, digest "
        f"{r10['digest']}")
    check(r10["digest"] == digest9, {"cuda": digest9, "cpu": r10["digest"]})
    check(r10["launches"] == 0, "the CPU run launched a kernel")

    # -- 3d. the fair-sharing kernels on the calls captured in 9 and 9b ------
    for name in ("fs_admit_scan", "drs_components"):
        for phase in ("northstar_fs", "fs_borrowing"):
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, captured fair sharing] {json.dumps(stats)}")

    # -- 11. topology-aware scheduling at tas-4k, on the card -----------------
    install_tas_capture(cap)
    cap.phase = "tas"
    with scenarios.tas_gates():
        t0 = time.perf_counter()
        d, clock, runtimes = scenarios.build_tas(device="cuda")
        build_s = time.perf_counter() - t0
        kernels.reset_counts()
        with (scenarios.TASBranches() as br11, DeviceClock() as dc11,
              GCWatch() as gc11):
            r11 = scenarios.run_tas(d, clock, runtimes, cycles=TAS_CYCLES)
        launches11 = dict(kernels.LAUNCHES)
    cap.uninstall()
    digest11 = scenarios.tas_digest(d, r11)
    ss = d.scheduler.solver.stats
    wall11 = sum(r11["cycle_times"])
    dev11 = dc11.busy_ms / 1e3
    log(f"[11 tas-4k] {len(d.cache.tas.nodes)} nodes, {len(runtimes)} "
        f"workloads (built in {build_s:.1f}s), {r11['cycles']} cycles in "
        f"{r11['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r11['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r11['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r11['admitted']}; branches {json.dumps(br11.counts)}; "
        f"full_cycles {ss['full_cycles']}, scalar_heads "
        f"{ss['scalar_heads']}, host_cycles {ss['host_cycles']}; device "
        f"busy {dev11 * 1e3:.3f}ms of {wall11 * 1e3:.3f}ms cycle wall (host "
        f"share {1 - dev11 / wall11:.4f}); digest {digest11}; "
        f"{gc11.line()}; launches "
        f"{json.dumps(launches11)}; "
        f"{device_line('11', dc11, r11['wall'], launches11)}")
    check(r11["admitted"] > 0, "tas-4k admitted nothing")
    for name in TAS_KERNELS:
        check(launches11[name] > 0, (name, launches11))
        check(launches11[name] == br11.counts[name],
              (name, "launches differ from calls", launches11, br11.counts))
    for branch in scenarios.TASBranches.BRANCHES:
        check(br11.counts[branch] > 0, (branch, br11.counts))
    check(br11.counts["scalar_walk"] == 0, "the host walk ran on the card")
    check(launches11["admit_scan"] > 0, launches11)
    check(gc11.n == 0, f"phase 11: {gc11.line()}")
    del d
    scenarios.release()

    # -- 12. the same cycles on the CPU: plain programs, then the host walk --
    # (its child, since 2)
    r12 = CPU_ARMS["12"].result()
    for label, device_kernel in (("plain", True), ("host walk", False)):
        r, counts = r12[label], r12[label]["counts"]
        log(f"[12 tas parity] cpu, {label} (a child on one thread beside "
            f"phases 3-11, {r12['child_s']:.2f}s for both): {r['cycles']} "
            f"cycles in {r['wall']:.2f}s, admitted {r['admitted']}, calls "
            f"{json.dumps({k: counts[k] for k in scenarios.TASBranches.CALLS})}"
            f", digest {r['digest']}")
        check(r["digest"] == digest11, {"cuda": digest11, label: r["digest"]})
        if device_kernel:
            check(counts["scalar_walk"] == 0, counts)
        else:
            check(counts["scalar_walk"] > 0, counts)
            check(all(counts[k] == 0 for k in TAS_KERNELS), counts)
    check(r12["launches"] == 0, "a CPU run launched a kernel")

    # -- 3e. the TAS kernels: seeded sweep, global-memory sort, captured -----
    # the walked levels of the descent launches by the route they took
    routes3e = {"warp": 0, "sort": 0}

    def tally(name, kw):
        if name == "fill_counts":
            return
        taken = kernels.TAS_ROUTES[name].cpu().tolist()
        for d in tas_levels(name, kw):
            routes3e[kernels.TAS_ROUTE_NAMES[taken[d]]] += 1

    for seed in (0, 1):
        for name, arrays, kw in testing.tas_cases(
                seed, testing.TAS_ALL, flat=4096):
            compare(name, on_card(arrays), kw, stats)
            tally(name, kw)
    smem_sort = kernels.TAS_SMEM_SORT
    kernels.TAS_SMEM_SORT = 0
    try:
        for name, arrays, kw in testing.tas_cases(
                0, ("three_levels", "flat", "shuffled", "wide_runs")):
            if name != "fill_counts":
                compare(name, on_card(arrays), kw, stats)
                tally(name, kw)
    finally:
        kernels.TAS_SMEM_SORT = smem_sort
    check(routes3e["warp"] > 0 and routes3e["sort"] > 0, routes3e)
    log(f"[3e TAS routes of the sweep's walked levels] "
        f"{json.dumps(routes3e)}")
    n_captured = 0
    for name in TAS_KERNELS:
        for args, kw in cap.calls.get(("tas", name), []):
            compare(name, args, kw, stats)
            n_captured += 1
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, TAS sweep + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in TAS_KERNELS})}")

    # -- 13. the north-star probe at full size, on the card ------------------
    from kueue_tpu_torch import probe
    from kueue_tpu_torch.ops import cycle
    install_phase1_capture(cap)
    cap.install(cycle, "admit_scan", "admit_scan")   # the flat 1,000 heads
    cap.phase = "probe"
    kernels.reset_counts()
    t13 = time.perf_counter()
    with DeviceClock() as dc13:
        r13 = probe.run(PROBE["W"], PROBE["C"], device="cuda",
                        reps=PROBE["reps"])
    t13 = time.perf_counter() - t13
    launches13 = dict(kernels.LAUNCHES)
    cap.uninstall()
    calls13 = PROBE["reps"] + 1
    path13 = PHASE1 + ("admit_scan", "admit_scan_forests")
    log(f"[13 probe] {PROBE['W']} heads x {PROBE['C']} CQs: "
        + "; ".join(f"{label} p50 {x['p50_ms']:.6f}ms worst "
                    f"{x['worst_ms']:.6f}ms" for label, x in r13.items())
        + f"; launches {json.dumps({k: launches13[k] for k in path13})}"
        f"; device ms per launch "
        f"{json.dumps({k: per_launch(dc13, k) for k in path13})}"
        f"; {device_line('13', dc13, t13, launches13)}")
    check(launches13["kq_cq_avail"] == 3 * calls13, launches13)
    check(launches13["kq_classify_heads"] == 3 * calls13, launches13)
    check(launches13["kq_cycle_order"] == 2 * calls13, launches13)
    check(launches13["admit_scan"] == calls13, launches13)
    check(launches13["admit_scan_forests"] == calls13, launches13)
    t0 = time.perf_counter()
    for label, name, args, kw in probe.probe_calls(PROBE["W"], PROBE["C"]):
        want = getattr(cycle, name + "_plain")(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
            **kw)
        got = r13[label]["outputs"]
        for w_, g in zip(want, got):
            check(g.dtype == w_.dtype and torch.equal(g.cpu(), w_),
                  f"probe {label}: the card differs from the plain version")
        if label == "classify":
            fits13 = int((want[4] >= 0).sum())
        if label == "flat":
            admitted13 = int(want[0].sum())
    log(f"[13 probe] outputs equal to the plain versions on the host CPU "
        f"({time.perf_counter() - t0:.1f}s): {fits13} fits of "
        f"{PROBE['W']}, {admitted13} of {PROBE['C']} heads admitted")

    # -- 3f. the phase-1 kernels: seeded sweep, both routes, captured -------
    for seed in (0, 1):
        for name, arrays, kw in testing.solve_cycle_cases(seed):
            compare(name, on_card(arrays), kw, stats)
    # the other route of each: the classify's loop on every shape, the
    # sort in global scratch
    saved = (kernels.CLASSIFY_LANES, kernels.SORT_SMEM)
    kernels.CLASSIFY_LANES, kernels.SORT_SMEM = 0, 0
    try:
        for name, arrays, kw in testing.solve_cycle_cases(2):
            if name == "kq_classify_heads":
                compare(name, on_card(arrays), kw, stats)
        for W in (5, 1000):
            compare("kq_cycle_order", on_card(testing.order_case(
                np.random.default_rng(W), W)), {}, stats)
    finally:
        kernels.CLASSIFY_LANES, kernels.SORT_SMEM = saved
    n_captured = 0
    for name in PHASE1:
        for args, kw in cap.calls.get(("probe", name), []):
            compare(name, args, kw, stats)
            n_captured += 1
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, phase-1 sweep + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in PHASE1})}")

    # -- 14. entry() on the card and the CPU; the native route ----------------
    kernels.reset_counts()
    step, args = scenarios.entry(device="cuda")
    got = step(*args)
    torch.cuda.synchronize()
    step_cpu, args_cpu = scenarios.entry(device="cpu")
    want = step_cpu(*args_cpu)
    for w_, g in zip(want, got):
        check(g.dtype == w_.dtype and torch.equal(g.cpu(), w_),
              "entry(): the card differs from the CPU")
    d, clock, total, waves = scenarios.build_bench(
        PARITY_SCALE, device="cuda", solver_backend="native")
    r14 = scenarios.run_bench(d, clock, total, waves)
    torch.cuda.synchronize()
    launches14 = dict(kernels.LAUNCHES)
    digest14 = scenarios.decision_digest(d, r14["decisions"])
    ss = d.scheduler.solver.stats
    log(f"[14 entry] {len(got[0])} heads, {int(got[0].sum())} admitted, "
        f"equal on the card and the CPU; [14 native] {r14['finished']}/"
        f"{total} drained, {r14['preempted']} preempted, native_dispatches "
        f"{ss['native_dispatches']}, cuda_dispatches "
        f"{ss['cuda_dispatches']}, native_ff_fallbacks "
        f"{ss['native_ff_fallbacks']}, digest {digest14} (phase 6: "
        f"{digest6}); launches {json.dumps(launches14)}")
    check(r14["finished"] == total, "native: not drained")
    check(digest14 == digest6, {"native": digest14, "phase 6": digest6})
    check(ss["native_dispatches"] > 0, ss)
    del d, waves
    scenarios.release()

    # -- 3h. the shapes past the launchers' old limits ------------------------
    t0 = time.perf_counter()
    n3h = {}
    for name, arrays, kw in testing.shape_cases(0, card=True):
        compare(name, on_card(arrays), kw, stats)
        shape = dict(depth=kw.get("depth"),
                     F=int(arrays[0].shape[-1]) if name != "burst_cycles"
                     else int(arrays[17].shape[1]))
        n3h.setdefault(name, []).append(shape)
    # drs_components' (node, column) design: depth 1 to 17, F = 1 to 65,
    # R = 1 to 5, a resource with no column, the int32 range, both routes
    for arrays, kw in testing.drs_design_cases(0):
        compare("drs_components", on_card(arrays), kw, stats)
        n3h.setdefault("drs_components", []).append(dict(
            N=int(arrays[0].shape[0]), depth=kw["depth"],
            F=int(arrays[0].shape[1]), R=kw["n_resources"]))
    # the forest-parallel flat scan and the burst on both routes: the
    # flat scan's layouts (testing.flat_scan_cases: one forest past a
    # block's shared memory among them) with and without the forest
    # tables, a burst window, the mixed fleet's window (4 slots x 3
    # resources, resumes, both fungibility policies) and one forest of
    # every CQ, with shared memory and with none allowed (every block on
    # its global route)
    saved = (kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM)
    try:
        for smem in (saved, (0, 0)):
            kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM = smem
            for _, arrays, kw, (fon, nf) in testing.flat_scan_cases(
                    0, card=True):
                a = on_card(arrays)
                compare("admit_scan", a, kw, stats)
                compare("admit_scan", a, dict(
                    kw, forest_of_node=torch.from_numpy(fon).cuda(),
                    n_forests=nf), stats)
            for name, arrays, kw in testing.kernel_cases(0):
                if name == "admit_scan_forests":
                    compare(name, on_card(arrays), kw, stats)
            for _, arrays, depth, (fon, nf) in testing.preempt_route_cases():
                compare("admit_scan_preempt", on_card(arrays), dict(
                    depth=depth, forest_of_node=torch.from_numpy(fon).cuda(),
                    n_forests=nf), stats)
            burst3h = [c for c in testing.burst_cases(0)
                       if c[0] in ("base", "mixed-fleet")]
            for _, arrays, kw in burst3h + [("one_forest",
                                             *testing.burst_one_forest(0))]:
                compare("burst_cycles", [
                    torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                    else int(a) for a in arrays], kw, stats)
    finally:
        kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM = saved
    # the batched search's layouts: an S past a multiple of its searches
    # per block, K = 1,024, F = 40, a tree and candidates past shared
    # memory (testing.search_route_cases), each on the route its shapes
    # give
    for label, arrays, kw, route in testing.search_route_cases(0):
        compare("minimal_preemptions_batch", on_card(arrays), kw, stats)
        r = kernels.SEARCH_ROUTES
        check((r["tree"], r["candidates"]) == {
            "shared": ("shared", "shared"), "global": ("global", "global"),
            "tree global": ("global", "shared"),
            "candidates global": ("shared", "global")}[route],
              (label, route, r))
        n3h.setdefault("minimal_preemptions_batch", []).append(label)
    for name in ROUTED:
        check(ROUTES_TAKEN.get(name, {"shared", "global"})
              <= set(stats[name]["routes"]), (name, stats[name]["routes"]))
    for name, s_ in stats.items():
        check(s_["mismatches"] == 0, (name, s_))
    log(f"[3h kernels past the old limits, both routes] {json.dumps(n3h)} "
        f"in {time.perf_counter() - t0:.1f}s; "
        f"{json.dumps({k: stats[k] for k in set(n3h) | set(ROUTED)})}")
    # the cost of a deep chain: the same 1,000 heads over 6 CQs under a
    # cohort chain of 16 levels (depth 17) and of 1 level (depth 2)
    t3h = {}
    for n_cohorts in (16, 1):
        c = testing.admit_cycle(np.random.default_rng(1), n_cqs=6,
                                n_cohorts=n_cohorts, depth=2, F=3,
                                W=1000, R=2, chain=True)
        args3h = on_card(testing.admit_args(c))
        compare("admit_scan", args3h, dict(depth=c["depth"]), stats)
        t3h[f"depth_{c['depth']}"] = {
            k: v for k, v in time_kernel(
                "admit_scan", args3h, dict(depth=c["depth"])).items()
            if k in ("ms", "plain_ms")}
    check(stats["admit_scan"]["mismatches"] == 0, stats["admit_scan"])
    log(f"[3h admit_scan, 1,000 heads, by chain depth] {json.dumps(t3h)}")

    # -- 15. the north-star shape through the forest-sharded burst ---------
    from kueue_tpu_torch.ops.packing import pack_scatter_rows, scatter_layout
    from kueue_tpu_torch.parallel import sharded
    install_shard_capture(cap)
    cap.phase = "northstar_sharded"
    os.environ["KUEUE_TPU_SHARDS"] = str(NORTHSTAR_SHARDS)
    try:
        with sharded.virtual_mesh("cuda:0", NORTHSTAR_SHARDS):
            t0 = time.perf_counter()
            d, clock, total, wave = scenarios.build_northstar(
                NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
            d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
            build_s = time.perf_counter() - t0
            gc.collect()
            kernels.reset_counts()
            with DeviceClock() as dc15, GCWatch() as gc15:
                r15 = scenarios.northstar_burst(d, clock, wave,
                                                cycles=NORTHSTAR["cycles"])
            launches15 = dict(kernels.LAUNCHES)
    finally:
        del os.environ["KUEUE_TPU_SHARDS"]
    cap.uninstall()
    bs = d._burst_solver
    digest15 = scenarios.decision_digest(d, r15["decisions"])
    pct = scenarios.percentile
    log(f"[15 northstar sharded burst] {bs.n_shards} virtual shards on "
        f"cuda:0, {total} workloads (built in {build_s:.1f}s), "
        f"{r15['cycles']} cycles in {r15['wall']:.2f}s, cycle p50 "
        f"{pct(r15['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r15['cycle_times'], 0.99) * 1e3:.3f}ms (phase 8 serial: "
        f"{r8['wall']:.2f}s, p50 {pct(r8['cycle_times'], 0.5) * 1e3:.3f}ms "
        f"p99 {pct(r8['cycle_times'], 0.99) * 1e3:.3f}ms, {gc8.line()}), "
        f"{gc15.line()}, admitted "
        f"{r15['admitted']}, preempted {r15['preempted']}, digest "
        f"{digest15} (phase 8: {digest8}); burst_shard_pack_s "
        f"{json.dumps(bs.stats['burst_shard_pack_s'])}, "
        f"burst_shard_fetch_s {json.dumps(bs.stats['burst_shard_fetch_s'])}"
        f"; {device_line('15', dc15, r15['wall'], launches15)}")
    burst_line("15 northstar sharded burst", d, r15, launches15)
    check(bs.n_shards == NORTHSTAR_SHARDS, bs.n_shards)
    check(digest15 == digest8, {"sharded": digest15, "phase 8": digest8})
    n_sharded = bs.stats["burst_sharded_dispatches"]
    check(n_sharded >= 1, bs.stats)
    check(launches15["kq_reduce_dflags"] == n_sharded,
          (launches15, n_sharded))
    check(launches15["burst_cycles"] == NORTHSTAR_SHARDS * n_sharded
          + bs.stats["burst_dispatches"] - n_sharded, launches15)
    check(gc15.n == 0, f"phase 15: {gc15.line()}")
    del d, bs
    scenarios.release()

    # -- 15b. resident reuse on 8 virtual shards, then 8 → 4 ---------------
    install_shard_capture(cap)
    cap.phase = "resident"
    os.environ["KUEUE_TPU_RESIDENT_VERIFY"] = "1"
    try:
        serial = scenarios.sustained_drain(device="cuda")
        serial_split = scenarios.sustained_drain(device="cuda", lose=4)
        with sharded.virtual_mesh("cuda:0", RESIDENT_SHARDS):
            kernels.reset_counts()
            r15b = scenarios.sustained_drain(device="cuda",
                                             shards=RESIDENT_SHARDS)
            torch.cuda.synchronize()
            launches15b = dict(kernels.LAUNCHES)
            r15c = scenarios.sustained_drain(
                device="cuda", shards=RESIDENT_SHARDS, lose=4)
    finally:
        del os.environ["KUEUE_TPU_RESIDENT_VERIFY"]
    cap.uninstall()
    st = r15b["stats"]
    log(f"[15b resident] {RESIDENT_SHARDS} virtual shards: "
        f"{len(r15b['records'])} cycles, records equal to the serial "
        f"drain: {r15b['records'] == serial['records']}; boundary "
        f"{boundary_report(st)}; launches "
        f"{json.dumps({k: launches15b[k] for k in ('burst_cycles',) + SHARD_KERNELS})}"
        f"; after lose_devices(4): shards {r15c['shards']}, records equal "
        f"to the serial split drain: "
        f"{r15c['records'] == serial_split['records']}, resident misses "
        f"{r15c['stats']['burst_resident_misses']}")
    check(r15b["records"] == serial["records"], "15b: records differ")
    check(st["burst_resident_hits"] >= 1, st)
    check(st["burst_resident_scatter_rows"] >= 1, st)
    check(launches15b["kq_scatter_rows"] >= 1, launches15b)
    check(launches15b["kq_reduce_dflags"] == st["burst_sharded_dispatches"],
          launches15b)
    check(st["burst_boundary_bytes_h2d"] < st["burst_boundary_bytes_equiv"],
          st)
    check(r15c["shards"] == [RESIDENT_SHARDS, 4], r15c["shards"])
    check(r15c["records"] == serial_split["records"],
          "15b: records differ after lose_devices(4)")
    check(r15c["stats"]["burst_shard_degradations"] == 1, r15c["stats"])
    del serial, serial_split, r15b, r15c
    scenarios.release()

    # -- 15c. resident reuse at north-star width on 4 virtual shards -------
    install_shard_capture(cap)
    cap.phase = "northstar_resident"
    wide = dict(device="cuda", n_cqs=NORTHSTAR["n_cqs"], runtime=30)
    os.environ["KUEUE_TPU_RESIDENT_VERIFY"] = "1"
    try:
        t0 = time.perf_counter()
        serial_w = scenarios.sustained_drain(**wide)
        serial_w_s = time.perf_counter() - t0
        with sharded.virtual_mesh("cuda:0", NORTHSTAR_SHARDS):
            kernels.reset_counts()
            t0 = time.perf_counter()
            with DeviceClock() as dc15w, GCWatch() as gc15w:
                r15w = scenarios.sustained_drain(shards=NORTHSTAR_SHARDS,
                                                 **wide)
            r15w_s = time.perf_counter() - t0
            launches15w = dict(kernels.LAUNCHES)
    finally:
        del os.environ["KUEUE_TPU_RESIDENT_VERIFY"]
    cap.uninstall()
    st = r15w["stats"]
    log(f"[15c resident at north-star width] {NORTHSTAR['n_cqs']} CQs, "
        f"{NORTHSTAR_SHARDS} virtual shards: {len(r15w['records'])} "
        f"cycles in {r15w_s:.2f}s (serial on the card {serial_w_s:.2f}s; "
        f"both with the VERIFY gathers), admitted "
        f"{sum(len(r[0]) for r in r15w['records'])}, preempted "
        f"{sum(len(r[3]) for r in r15w['records'])}, records equal to the "
        f"serial drain: {r15w['records'] == serial_w['records']}; boundary "
        f"{boundary_report(st)}; launches "
        f"{json.dumps({k: launches15w[k] for k in ('burst_cycles',) + SHARD_KERNELS})}"
        f"; {gc15w.line()}; {device_line('15c', dc15w, r15w_s, launches15w)}")
    hits15w = max(1, st["burst_resident_hits"])
    log(f"[15c resident scatter] per resident hit: "
        f"burst_resident_scatter_s {st['burst_resident_scatter_s'] / hits15w:.6f}"
        f", host-to-device copies {st['burst_resident_scatter_copies'] / hits15w:.3f}"
        f" ({st['burst_resident_scatter_copies']} copies, "
        f"{launches15w['kq_scatter_rows']} kq_scatter_rows launches, "
        f"{st['burst_resident_hits']} hits, {NORTHSTAR_SHARDS} shards)")
    check(r15w["records"] == serial_w["records"], "15c: records differ")
    check(gc15w.n == 0, f"phase 15c: {gc15w.line()}")
    check(st["burst_resident_scatter_copies"]
          == launches15w["kq_scatter_rows"], (st, launches15w))
    check(st["burst_resident_hits"] >= 1, st)
    check(st["burst_resident_scatter_rows"] >= 1, st)
    check(launches15w["kq_scatter_rows"] >= 1, launches15w)
    check(launches15w["kq_reduce_dflags"] == st["burst_sharded_dispatches"],
          launches15w)
    check(st["burst_boundary_bytes_h2d"] < st["burst_boundary_bytes_equiv"],
          st)
    check(any(r[3] for r in r15w["records"]), "15c: no preemption")

    # -- 3g. the two sharded-burst kernels: seeded and captured -------------
    # packed buffers: padded duplicate rows, rows past the planes and
    # below -C, a row in [-C, 0) (written at C + r), 5-byte bool rows,
    # 16-byte rows; all 250 rows of a shard dirty
    for seed, C, D in ((0, 12, 1), (1, 12, 3), (2, 12, 9), (3, 12, 12),
                       (4, 250, 250)):
        planes, rows, vals = testing.scatter_case(seed, C=C, D=D)
        compare("kq_scatter_rows", [
            tuple(on_card(planes)),
            torch.from_numpy(pack_scatter_rows(rows, vals)).cuda(),
            len(rows)], {}, stats)
    for S, K in ((2, 32), (4, 32), (8, 32), (32, 32), (4, 7)):
        compare("kq_reduce_dflags",
                on_card([testing.dflags_blocks(S, K)]), {}, stats)
    n_captured = 0
    for phase in ("northstar_sharded", "resident", "northstar_resident"):
        for name in SHARD_KERNELS:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                n_captured += 1
    for name in SHARD_KERNELS:
        check(stats[name]["mismatches"] == 0, (name, stats[name]))
    log(f"[3g sharded-burst kernels, seeded + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in SHARD_KERNELS})}")

    # phases 25 and 26 on the card, beside phases 16-24 (CARD_ARM_CODE)
    CARD_ARMS["25-26"] = ChildArm("25-26", CARD_ARM_CODE)
    # phase 33's card and CPU children from here on: their forty-odd
    # processes started with the build loaded the host under phase 28's
    # traced / untraced A/B in CARD_ARMS["27-29"], whose p50 ratio has a
    # 1.05 gate
    CARD_ARMS["33"] = ChildArm("33", CARD_ARM_CODE)
    CPU_ARMS["33"] = ChildArm("33", CPU_ARM_CODE)
    # phase 35's from here on too, for the same reason
    CARD_ARMS["35"] = ChildArm("35", CARD_ARM_CODE)
    CPU_ARMS["35"] = ChildArm("35", CPU_ARM_CODE)

    # -- 16. the perf scenario through the per-cycle mesh ------------------
    install_mesh_capture(cap)
    cap.phase = "bench_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["bench"]):
        d, clock, total, waves = scenarios.build_bench(
            BENCH_WORKLOADS / 15_000, device="cuda",
            shards=MESH_SHARDS["bench"])
        d.scheduler.solver.warmup(d.cache.snapshot(),
                                  len(d.cache.cluster_queue_names()))
        gc.collect()      # phases 16-16c start from a collected heap
        kernels.reset_counts()
        with DeviceClock() as dc16, GCWatch() as gc16:
            r16 = scenarios.run_bench(d, clock, total, waves)
        launches16 = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16 = scenarios.decision_digest(d, r16["decisions"])
    log(f"[16 bench mesh] drained {r16['finished']}/{r16['total']}, "
        f"{r16['finished'] / r16['wall']:.1f} admissions/s (phase 4: "
        f"{BENCH_WORKLOADS / wall4:.1f}), preempted {r16['preempted']}")
    mesh_line("16 bench mesh", d, r16, launches16, dc16, digest16,
              digest4, wall4, gc16)
    check(d.scheduler.solver.mesh.shape == {"wl": 2, "cq": 2},
          d.scheduler.solver.mesh.shape)
    check(digest16 == digest4, {"mesh": digest16, "phase 4": digest4})
    check(ss["sharded_dispatches"] > 0 and ss["sharded_preempt_dispatches"]
          > 0, ss)
    check(launches16["kq_gather_heads"] == ss["sharded_dispatches"],
          (launches16, ss["sharded_dispatches"]))
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches16[k] > 0, (k, launches16))
    check(sum(sum(v) for v in ss["sharded_shard_launches"].values())
          == launches16["admit_scan"] + launches16["admit_scan_preempt"]
          + launches16["admit_scan_forests"], ss["sharded_shard_launches"])
    del d, waves
    scenarios.release()

    # -- 16b. the north-star shape through the per-cycle mesh ---------------
    install_mesh_capture(cap)
    cap.phase = "northstar_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["northstar"]):
        t0 = time.perf_counter()
        d, clock, total, wave = scenarios.build_northstar(
            NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda",
            shards=MESH_SHARDS["northstar"])
        d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
        build_s = time.perf_counter() - t0
        gc.collect()
        kernels.reset_counts()
        with DeviceClock() as dc16b, GCWatch() as gc16b:
            r16b = scenarios.run_northstar(d, clock, wave,
                                           cycles=NORTHSTAR["cycles"])
        launches16b = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16b = scenarios.decision_digest(d, r16b["decisions"])
    log(f"[16b northstar mesh] built in {build_s:.1f}s, admitted "
        f"{r16b['admitted']}, preempted {r16b['preempted']}")
    mesh_line("16b northstar mesh", d, r16b, launches16b, dc16b,
              digest16b, digest5, r5["wall"], gc16b)
    check(d.scheduler.solver.mesh.shape == {"wl": 4, "cq": 2},
          d.scheduler.solver.mesh.shape)
    check(digest16b == digest5, {"mesh": digest16b, "phase 5": digest5})
    check(ss["sharded_preempt_dispatches"] > 0, ss)
    check(launches16b["admit_scan_forests"] > 0, launches16b)
    check(launches16b["kq_gather_heads"] == ss["sharded_dispatches"],
          (launches16b, ss["sharded_dispatches"]))
    check(gc16b.n == 0, f"phase 16b: {gc16b.line()}")
    del d
    scenarios.release()

    # -- 16c. fair sharing at the north-star size through the mesh ----------
    install_mesh_capture(cap)
    cap.phase = "northstar_fs_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["fs"]):
        t0 = time.perf_counter()
        d, clock, total = scenarios.build_northstar_fs(
            NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda",
            shards=MESH_SHARDS["fs"])
        d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
        build_s = time.perf_counter() - t0
        gc.collect()
        kernels.reset_counts()
        with DeviceClock() as dc16c, GCWatch() as gc16c:
            r16c = scenarios.run_northstar_fs(d, clock,
                                              cycles=NORTHSTAR["cycles"])
        launches16c = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16c = scenarios.decision_digest(d, r16c["decisions"])
    log(f"[16c northstar fs mesh] built in {build_s:.1f}s, admitted "
        f"{r16c['admitted']}, skipped {r16c['skipped']}")
    mesh_line("16c northstar fs mesh", d, r16c, launches16c, dc16c,
              digest16c, digest9, r9["wall"], gc16c)
    check(digest16c == digest9, {"mesh": digest16c, "phase 9": digest9})
    check(ss["sharded_fs_dispatches"] > 0, ss)
    check(launches16c["fs_admit_scan"] > 0, launches16c)
    check(launches16c["kq_fs_merge_order"] == ss["sharded_fs_dispatches"],
          (launches16c, ss["sharded_fs_dispatches"]))
    check(launches16c["kq_gather_heads"] >= ss["sharded_fs_dispatches"],
          launches16c)
    check(gc16c.n == 0, f"phase 16c: {gc16c.line()}")
    del d
    scenarios.release()

    # -- 16d. the multi-chip dry run on a virtual mesh of the card ----------
    install_mesh_capture(cap)
    install_phase1_capture(cap)
    cap.phase = "dryrun"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["dryrun"]):
        kernels.reset_counts()
        t16d = time.perf_counter()
        with DeviceClock() as dc16d:
            r16d = scenarios.dryrun_multichip(MESH_SHARDS["dryrun"],
                                              device="cuda")
        t16d = time.perf_counter() - t16d
        launches16d = dict(kernels.LAUNCHES)
    cap.uninstall()
    log(f"[16d dryrun_multichip] {json.dumps(r16d)}; launches "
        f"{json.dumps({k: v for k, v in launches16d.items() if v})}; "
        f"device ms per launch "
        f"{json.dumps({k: per_launch(dc16d, k) for k in PHASE1})}; "
        f"{device_line('16d', dc16d, t16d, launches16d)}")
    for k in PHASE1 + ("admit_scan", "admit_scan_preempt",
                       "kq_gather_heads"):
        check(launches16d[k] > 0, (k, launches16d))

    # -- 17. the reference perf harness at full size ------------------------
    import yaml
    from kueue_tpu_torch.perf import harness
    here = os.path.dirname(os.path.abspath(__file__))
    gen = os.path.join(here, "perf", "default_generator_config.yaml")
    spec_path = os.path.join(here, "perf", "default_rangespec.yaml")
    with open(spec_path) as f:
        spec = yaml.safe_load(f)
    t0 = time.perf_counter()
    # a process of its own, started by the launcher, so that maxrss and
    # mCPU are the harness's
    proc = launcher.run(
        [sys.executable, "-m", "kueue_tpu_torch.perf.harness", gen,
         spec_path], cwd=here, env=dict(os.environ, PYTHONPATH=here),
        timeout=HARNESS_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    try:
        h17 = json.loads(proc.stdout)
    except json.JSONDecodeError:
        raise RuntimeError(f"phase 17: no JSON from the harness (exit "
                           f"{proc.returncode}): {proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}") from None
    tta = h17["avg_time_to_admission_ms"]
    fails17 = [ln[len("RANGESPEC FAIL: "):]
               for ln in proc.stderr.splitlines()
               if ln.startswith("RANGESPEC FAIL: ")]
    cmd = spec["cmd"]
    log(f"[17 perf harness] python -m kueue_tpu_torch.perf.harness "
        f"(exit {proc.returncode}, {child_s:.1f}s): {json.dumps(h17)}; "
        f"rangespec failures {json.dumps(fails17)}; host figures against "
        f"their limits: wall {h17['wall_ms']}ms (maxWallMs "
        f"{cmd['maxWallMs']}), cpu {h17['cpu_mcpu']}mCPU (mCPU "
        f"{cmd['mCPU']}), maxrss {h17['maxrss_kb']}KB (maxrss "
        f"{cmd['maxrss']}KB, set for a JAX process); on the card "
        f"{h17['virtual_ms'] / 1e3} virtual s, avg time to admission (s) "
        f"{json.dumps({k: v / 1e3 for k, v in tta.items()})}, min CQ usage "
        f"{h17['min_avg_usage_pct'].get('cq')}%, beside the JAX replay's "
        f"record (README): {README_REPLAY}")
    check(proc.returncode in (0, 1), ("phase 17 exit", proc.returncode,
                                      proc.stderr[-4000:]))
    check(proc.returncode == 0 or fails17, proc.stderr[-4000:])
    check(h17["finished"] == h17["workloads"] == BENCH_WORKLOADS, h17)
    check(set(tta) == {"small", "medium", "large"}
          and tta["large"] < tta["medium"] < tta["small"], tta)
    check(not [f for f in fails17
               if f.startswith(("usage[", "timeToAdmission["))], fails17)

    # the cut config in this process, on the card and on the CPU
    with open(gen) as f:
        cut = yaml.safe_load(f)
    cut[0]["count"] = 1
    for ws in cut[0]["queuesSets"][0]["workloadsSets"]:
        ws["count"] //= 5
    kernels.reset_counts()
    with DeviceClock() as dc17:
        s17 = harness.run_scenario(cut, device="cuda")
    launches17 = dict(kernels.LAUNCHES)
    s17c = harness.run_scenario(cut, device="cpu")
    virtual = ("admitted", "finished", "virtual_ms",
               "avg_time_to_admission_ms", "min_avg_usage_pct")
    v17 = {k: getattr(s17, k) for k in virtual}
    log(f"[17 perf harness, 1 cohort x 6 CQs, "
        f"{s17.total_workloads} workloads] cuda {json.dumps(v17)} in "
        f"{s17.wall_ms / 1e3:.2f}s; cpu equal: "
        f"{v17 == {k: getattr(s17c, k) for k in virtual}} "
        f"({s17c.wall_ms / 1e3:.2f}s); launches "
        f"{json.dumps({k: v for k, v in launches17.items() if v})}; "
        f"{device_line('17', dc17, s17.wall_ms / 1e3, launches17)}")
    check(v17 == {k: getattr(s17c, k) for k in virtual},
          ("phase 17: card and CPU differ", v17, s17c))
    check(s17.finished == s17.total_workloads, s17)
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches17[k] > 0, (k, launches17))
    del s17, s17c
    scenarios.release()

    # -- 18. the job front door at tas-4k's size ----------------------------
    with scenarios.restore_gates():
        t0 = time.perf_counter()
        d, clock, mgr, plan = scenarios.build_jobs(device="cuda")
        build_s = time.perf_counter() - t0
        kernels.reset_counts()
        with (scenarios.TASBranches() as br18, DeviceClock() as dc18,
              GCWatch() as gc18):
            r18 = scenarios.run_jobs(d, clock, mgr, plan)
        launches18 = dict(kernels.LAUNCHES)
    digest18 = scenarios.jobs_digest(d, r18)
    pct = scenarios.percentile
    log(f"[18 jobs-tas-4k] {len(d.cache.tas.nodes)} nodes, "
        f"{len(list(d.queues.cluster_queue_names()))} CQs, "
        f"{r18['jobs']} jobs (built in {build_s:.1f}s), {r18['steps']} "
        f"steps in {r18['wall']:.2f}s (schedule_once "
        f"{sum(r18['cycle_times']):.2f}s, the job layer the rest), cycle p50 "
        f"{pct(r18['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r18['cycle_times'], 0.99) * 1e3:.3f}ms; admitted "
        f"{r18['admitted']}, completed {r18['completed']}, preempted "
        f"{r18['preempted']}, PodsReady timeouts {r18['timed_out']} "
        f"(deactivated {r18['deactivated']}), stopped "
        f"{len(r18['stopped'])} "
        f"({json.dumps(Counter(s[1] for s in r18['stopped']))}), refused "
        f"{len(r18['refused'])}; started by kind "
        f"{json.dumps(r18['started_kinds'])}; branches "
        f"{json.dumps(br18.counts)}; digest {digest18}; {gc18.line()}; "
        f"launches {json.dumps({k: v for k, v in launches18.items() if v})}"
        f"; {device_line('18', dc18, r18['wall'], launches18)}")
    check(set(r18["started_kinds"]) == set(scenarios.JOB_KINDS),
          r18["started_kinds"])
    check(r18["preempted"] > 0 and r18["stopped"], "phase 18: no preemption")
    check(r18["preempted_unstopped"] == [], r18["preempted_unstopped"][:5])
    check(all(restored for _, _, restored in r18["stopped"]),
          [s for s in r18["stopped"] if not s[2]][:5])
    check(r18["refused"], "phase 18: the webhook refused nothing")
    for k in TAS_KERNELS + ("admit_scan", "admit_scan_preempt"):
        check(launches18[k] > 0, (k, launches18))
    check(br18.counts["scalar_walk"] == 0, br18.counts)
    check(gc18.n == 0, f"phase 18: {gc18.line()}")
    del d, mgr, plan, r18
    scenarios.release()

    r = CPU_ARMS["18"].result()     # its child, since 2
    log(f"[18 jobs parity] cpu (a child on one thread beside phases 3-18, "
        f"{r['child_s']:.2f}s): {r['steps']} steps in {r['wall']:.2f}s, "
        f"admitted {r['admitted']}, digest {r['digest']}")
    check(r["digest"] == digest18, {"cuda": digest18, "cpu": r["digest"]})
    check(r["launches"] == 0, "the CPU run launched a kernel")

    # -- 19. the open loop at traffic_soak.py's width ------------------------
    from kueue_tpu_torch.traffic import find_sustainable_rate
    n19 = TRAFFIC["n_cqs"]
    loop_cfg = {k: TRAFFIC[k] for k in ("duration_s", "slo_p99_s")}
    cap19 = scenarios.traffic_capacity(n19)
    rate19 = round(cap19 * 0.5, 1)
    seed19 = scenarios.rate_seed(TRAFFIC["seed"], rate19)
    t0 = time.perf_counter()
    d, clock = scenarios.build_traffic(n19, device="cuda")
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc19, GCWatch() as gc19:
        r19 = scenarios.open_loop(
            d, clock, scenarios.traffic_stream(n19, rate19, seed19),
            **loop_cfg)
    launches19 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    log(f"[19 traffic-1k] {n19} CQs (built in {build_s:.1f}s), Poisson "
        f"{rate19}/s (half of the capacity estimate {cap19:.1f}/s, seed "
        f"{seed19}), {r19.cycles} cycles in {r19.wall_s:.2f}s: submitted "
        f"{r19.submitted}, admitted {r19.admitted}, cancelled "
        f"{r19.cancelled}, churned {r19.churned}; latency p50 / p99 "
        f"{r19.p50_latency_s} / {r19.p99_latency_s} virtual s (SLO "
        f"{TRAFFIC['slo_p99_s']}), depth max / end {r19.max_depth} / "
        f"{r19.end_depth}, meets_slo {r19.meets_slo}; cycle wall p50 / p99 "
        f"{r19.cycle_wall_p50_ms:.3f} / {r19.cycle_wall_p99_ms:.3f}ms; "
        f"host_cycles {ss['host_cycles']}; {gc19.line()}; launches "
        f"{json.dumps({k: v for k, v in launches19.items() if v})}; "
        f"{device_line('19', dc19, r19.wall_s, launches19)}; {smi_line}")
    check(r19.meets_slo and not r19.truncated, "phase 19: over the SLO")
    check(r19.max_depth < rate19 * TRAFFIC["slo_p99_s"],
          f"phase 19: queue depth {r19.max_depth} not bounded")
    check(sum(launches19[k] for k in ADMIT_KERNELS) > 0, launches19)
    check(ss["host_cycles"] == 0, ss)
    check(gc19.n == 0, f"phase 19: {gc19.line()}")
    # the phase's drivers stay frozen until its end: one release, the
    # one full collection that scans the whole heap
    del d
    before = dict(kernels.LAUNCHES)
    r19c, d = scenarios.traffic_probe(n19, rate19, seed=seed19,
                                      device="cpu", **loop_cfg)
    decided = ("decisions", "submitted", "admitted", "cancelled", "churned",
               "p50_latency_s", "p99_latency_s", "mean_latency_s",
               "latency_hist", "max_depth", "end_depth", "meets_slo")
    diff19 = [k for k in decided if getattr(r19c, k) != getattr(r19, k)]
    check(kernels.LAUNCHES == before, "the CPU run launched a kernel")
    del d
    r19r, d = scenarios.traffic_probe(n19, rate19, seed=seed19,
                                      device="cuda", events=r19.events,
                                      **loop_cfg)
    log(f"[19 traffic parity] cpu: {r19c.cycles} cycles in "
        f"{r19c.wall_s:.2f}s, fields differing from the card's "
        f"{diff19}; card replay of {len(r19.events)} events: decisions "
        f"bit-identical {r19r.decisions == r19.decisions}")
    check(not diff19, diff19)
    check(r19r.decisions == r19.decisions, "phase 19: the replay diverged")
    del d

    def probe19(rate):
        return scenarios.traffic_probe(
            n19, rate, seed=scenarios.rate_seed(TRAFFIC["seed"], rate),
            device="cuda", wall_budget_s=TRAFFIC["wall_budget_s"],
            **loop_cfg)[0]

    t0 = time.perf_counter()
    kernels.reset_counts()
    best19, probes19 = find_sustainable_rate(
        probe19, rate19, cap19 * 1.5, iters=TRAFFIC["iters"])
    launches19s = dict(kernels.LAUNCHES)
    at_best = next((r for r in probes19 if r.rate_per_s == best19), r19)
    log(f"[19 sustainable rate] {best19:.1f}/s at p99 <= "
        f"{TRAFFIC['slo_p99_s']} virtual s over [{rate19}, "
        f"{cap19 * 1.5:.1f}] in {TRAFFIC['iters']} probes "
        f"({time.perf_counter() - t0:.1f}s): "
        f"{json.dumps([[round(r.rate_per_s, 1), r.meets_slo, r.p99_latency_s, r.end_depth, round(r.cycle_wall_p50_ms, 3), round(r.cycle_wall_p99_ms, 3)] for r in probes19])} "
        f"(rate, meets, p99 s, end depth, cycle wall p50 / p99 ms); at "
        f"the rate cycle wall p50 / p99 {at_best.cycle_wall_p50_ms:.3f} / "
        f"{at_best.cycle_wall_p99_ms:.3f}ms, admissions per wall s "
        f"{at_best.admissions_per_wall_s:.1f}; launches "
        f"{json.dumps({k: v for k, v in launches19s.items() if v})}; "
        f"{smi_line}")
    check(sum(launches19s[k] for k in ADMIT_KERNELS) > 0, launches19s)
    del probes19, at_best
    scenarios.release()

    # -- 20. two-phase admission with a provisioning check ------------------
    t0 = time.perf_counter()
    d, clock, ctrl, total, waves, revoke = scenarios.build_provisioning(
        PROV_SCALE, device="cuda")
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc20, GCWatch() as gc20:
        r20 = scenarios.run_provisioning(d, clock, ctrl, total, waves,
                                         revoke)
    launches20 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    log(f"[20 provisioning-{total // 1000}k] {total} workloads in 30 CQs "
        f"with the check (built in {build_s:.1f}s), {r20['cycles']} cycles in "
        f"{r20['wall']:.2f}s (schedule_once "
        f"{sum(r20['cycle_times']):.2f}s, the controller and the drain "
        f"the rest), cycle p50 "
        f"{scenarios.percentile(r20['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r20['cycle_times'], 0.99) * 1e3:.3f}ms; "
        f"admitted {r20['admitted']}, finished {r20['finished']}, rejected "
        f"{r20['rejected']}; check writes {json.dumps(r20['reached'])}; "
        f"host_cycles {ss['host_cycles']}; {gc20.line()}; launches "
        f"{json.dumps({k: v for k, v in launches20.items() if v})}; "
        f"{device_line('20', dc20, r20['wall'], launches20)}")
    check(r20["finished"] + r20["rejected"] == total, r20["cycles"])
    check(set(PROV_REACHED) <= set(r20["reached"]), r20["reached"])
    check(sum(launches20[k] for k in ADMIT_KERNELS) > 0, launches20)
    check(ss["host_cycles"] == 0, ss)
    check(gc20.n == 0, f"phase 20: {gc20.line()}")
    del d, ctrl, waves, revoke, r20
    # the CPU side ran in CPU_ARMS["20-22"] since phase 2
    cpu2022 = CPU_ARMS["20-22"].result()
    d, clock, ctrl, total, waves, revoke = scenarios.build_provisioning(
        PARITY_SCALE, device="cuda")
    r = scenarios.run_provisioning(d, clock, ctrl, total, waves, revoke)
    r20p = dict(total=total, digest=scenarios.decision_digest(
        d, [r["decisions"], r["requests"], r["reached"]]), **{
            k: r[k] for k in ("cycles", "wall", "admitted", "finished",
                              "rejected")})
    del d, ctrl, waves, revoke, r
    scenarios.release()
    for device, rp in (("cuda", r20p), ("cpu (CPU_ARMS[20-22])",
                                        cpu2022["20"])):
        log(f"[20 provisioning parity] {device}: {rp['total']} workloads, "
            f"{rp['cycles']} cycles in {rp['wall']:.2f}s, admitted "
            f"{rp['admitted']}, finished {rp['finished']}, rejected "
            f"{rp['rejected']}, digest {rp['digest']}")
    check(r20p["digest"] == cpu2022["20"]["digest"],
          (r20p["digest"], cpu2022["20"]["digest"]))

    # -- 21. the admission service at traffic-1k's width --------------------
    import threading
    from kueue_tpu_torch.remote import state_digest
    m21 = scenarios.serving_modules("cuda")
    cyc21 = int(TRAFFIC["duration_s"])
    ev21 = scenarios.serve_events(
        scenarios.traffic_stream(n19, rate19, seed19), TRAFFIC["duration_s"])
    td21 = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    main_thread = threading.get_ident()
    t0 = time.perf_counter()
    kernels.reset_counts()
    gc.disable()    # the arms run with collection off, and so what
    try:            # they leave between them
        with DeviceClock() as dc21, GCWatch() as gc21, \
                LaunchThreads() as lt21:
            t1 = time.perf_counter()
            a21 = scenarios.serve_loop(m21, n19, ev21, cyc21)
            serve_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            o21 = scenarios.serve_open_loop(m21, n19, ev21, cyc21)
            open_s = time.perf_counter() - t1
            parity21 = (a21["decisions"] == o21["decisions"],
                        state_digest(a21["driver"]),
                        state_digest(o21["driver"]))
            del o21
            t1 = time.perf_counter()
            b21 = scenarios.serve_loop(m21, n19, ev21, cyc21, k_max=8,
                                       threads=4)
            adaptive_s = time.perf_counter() - t1
            lost21, dup21 = scenarios.lost_and_duplicated(
                b21["accepted"], b21["driver"], b21["decisions"])
            ks21 = b21["ks"]
            adaptive_digest = state_digest(b21["driver"])
            del b21
            # the unkilled control of (c) is (a)'s run: the same service
            # steps, without the journals on disk, which decide nothing
            t1 = time.perf_counter()
            k21 = scenarios.serve_killable(m21, n19, ev21, cyc21, td21, "kill",
                                           kill_site="svc.cycle",
                                           kill_at=cyc21 // 2 + 1)
            kill_s = time.perf_counter() - t1
            kill21 = (k21["crashed"], k21["decisions"] == a21["decisions"],
                      state_digest(k21["driver"]), parity21[1],
                      k21["service"].duplicate_total)
            del a21, k21
    finally:
        gc.enable()
    wall21 = time.perf_counter() - t0
    launches21 = dict(kernels.LAUNCHES)
    log(f"[21 serve-1k] {n19} CQs, phase 19's stream: {len(ev21)} "
        f"submissions (its cancels and reprioritisations left out) over "
        f"{cyc21} virtual s; (a) AdmissionService K = 1 {serve_s:.2f}s, "
        f"run_open_loop {open_s:.2f}s: decisions identical {parity21[0]}, "
        f"digests {parity21[1]} / {parity21[2]}; (b) k_max 8, 4 submitter "
        f"threads, {adaptive_s:.2f}s: K chosen {ks21}, lost {lost21}, "
        f"duplicated {dup21}, digest {adaptive_digest}; (c) svc.cycle "
        f"crash at step {cyc21 // 2 + 1}, recover_service, {kill_s:.2f}s: "
        f"crashed {kill21[0] is not None}, decisions identical "
        f"{kill21[1]}, digest {kill21[2]} ((a)'s {kill21[3]}), "
        f"resubmissions deduped {kill21[4]}; wall {wall21:.2f}s; "
        f"launching threads {len(lt21.idents)} (the service thread only "
        f"{set(lt21.idents) == {main_thread}}); {gc21.line()}; launches "
        f"{json.dumps({k: v for k, v in launches21.items() if v})}; "
        f"{device_line('21', dc21, wall21, launches21)}")
    check(parity21[0] and parity21[1] == parity21[2], parity21)
    check(lost21 == 0 and dup21 == 0, (lost21, dup21))
    check(max(ks21) > 1, f"phase 21: K never adapted {ks21}")
    check(kill21[0] is not None and kill21[1] and kill21[2] == kill21[3],
          kill21)
    check(set(lt21.idents) == {main_thread}, dict(lt21.idents))
    check(sum(launches21[k] for k in ADMIT_KERNELS) > 0, launches21)
    head21 = [e for e in ev21 if e.t <= SERVE_CPU_S]
    digests21 = {}
    for device in ("cuda", "cpu"):
        t1 = time.perf_counter()
        r = scenarios.serve_loop(scenarios.serving_modules(device), n19,
                                 head21, SERVE_CPU_S)
        digests21[device] = (state_digest(r["driver"]),
                             scenarios.decision_digest(r["driver"],
                                                       r["decisions"]))
        log(f"[21 serve parity] {device}: {len(head21)} submissions over "
            f"{SERVE_CPU_S} virtual s in {time.perf_counter() - t1:.2f}s, "
            f"admitted {sum(map(len, r['decisions']))}, digests "
            f"{digests21[device]}")
        del r
    check(digests21["cuda"] == digests21["cpu"], digests21)
    kernels.reset_counts()
    t0 = time.perf_counter()
    with DeviceClock() as dc21w, GCWatch() as gc21w, \
            LaunchThreads() as lt21w:
        w21 = scenarios.serve_wall(SERVE_WALL, SERVE_WALL["seed"], td21,
                                   device="cuda")
    wall21w = time.perf_counter() - t0
    launches21w = dict(kernels.LAUNCHES)
    p99_21 = [[w["samples"], round(w["p99_s"], 4)] for w in w21["windows"]]
    log(f"[21 serve wall] serve_soak.py's wall arm, {SERVE_WALL['cqs']} "
        f"CQs, {w21['events']} diurnal arrivals "
        f"{SERVE_WALL['wall_trough_rate']}-{SERVE_WALL['wall_peak_rate']}/s "
        f"over {w21['duration_s']}s of wall clock (cut from 24 s), 4 "
        f"submitter threads, dt {SERVE_WALL['wall_dt_s']}s: submitted "
        f"{w21['submitted']}, admitted {w21['admitted']} "
        f"({w21['admissions_per_s']:.1f}/s), rejected {w21['rejected']}, "
        f"shed {w21['shed']}, drained clean {w21['drained_clean']}; p99 by "
        f"window {json.dumps(p99_21)} "
        f"(samples, s) against the SLO {SERVE_WALL['slo_p99_s']}s: held "
        f"{w21['held']}; K chosen {w21['k_values']}; launching threads "
        f"{len(lt21w.idents)} (the service thread only "
        f"{set(lt21w.idents) == {w21['service_thread']}}); wall "
        f"{wall21w:.2f}s; {gc21w.line()}; launches "
        f"{json.dumps({k: v for k, v in launches21w.items() if v})}; "
        f"{device_line('21', dc21w, wall21w, launches21w)}; {smi_line}")
    check(w21["held"] and w21["drained_clean"] and w21["stopped"], w21)
    check(w21["admitted"] == w21["submitted"] - w21["shed"], w21)
    check(set(lt21w.idents) == {w21["service_thread"]}, dict(lt21w.idents))
    check(sum(launches21w[k] for k in ADMIT_KERNELS) > 0, launches21w)
    launches21 = summed([launches21, launches21w])
    del w21
    scenarios.release()

    # -- 22. the federation at federation_soak.py's size --------------------
    td22 = tempfile.mkdtemp(prefix="chip_smoke_fed_")
    at22 = max(2, FED["steps"] // 3)
    kernels.reset_counts()
    t0 = time.perf_counter()
    with DeviceClock() as dc22, GCWatch() as gc22:
        ctl22, ok_c = scenarios.fed_arm(FED, FED["seed"], f"{td22}/c",
                                        m=m21)
        ctl_s = time.perf_counter() - t0
        crash22, ok_f = scenarios.fed_arm(
            FED, FED["seed"], f"{td22}/f", m=m21,
            arm=lambda i: i.arm("fed.worker_crash", at=at22,
                                payload=ctl22.worker_names[0]))
    wall22 = time.perf_counter() - t0
    launches22 = dict(kernels.LAUNCHES)
    dg22 = (m21.fed.global_digest(ctl22), m21.fed.global_digest(crash22))
    dbl22 = scenarios.fed_double_admissions(crash22)
    log(f"[22 fed-1k] manager {FED['cqs']} CQs ({FED['remote_cqs']} "
        f"remote) + {FED['workers']} workers, each Driver(device=\"cuda\"),"
        f" {FED['events']} events, seed {FED['seed']}: control "
        f"{ctl22.step_no} steps in {ctl_s:.2f}s, worker_crash_mid_sync "
        f"(w0 at step {at22}) {crash22.step_no} steps in "
        f"{wall22 - ctl_s:.2f}s; settled {ok_c} / {ok_f}; global digests "
        f"{dg22[0]} / {dg22[1]}; violations {len(ctl22.violations)} / "
        f"{len(crash22.violations)}, double admissions {dbl22}; counters "
        f"{json.dumps(crash22.counters)}; spread "
        f"{json.dumps(crash22.assignment_spread())}; {gc22.line()}; "
        f"launches {json.dumps({k: v for k, v in launches22.items() if v})}"
        f"; {device_line('22', dc22, wall22, launches22)}")
    check(ok_c and ok_f, (ok_c, ok_f))
    check(ctl22.violations == [] and crash22.violations == [],
          crash22.violations[:2])
    check(dg22[0] == dg22[1] and dbl22 == 0, (dg22, dbl22))
    check(crash22.counters["worker_crashes"] == 1
          and crash22.counters["mid_admit_crashes"] >= 1
          and crash22.counters["wal_tail_replayed"] >= 1, crash22.counters)
    check(sum(launches22[k] for k in ADMIT_KERNELS) > 0, launches22)
    del ctl22, crash22
    cut22 = dict(FED, events=FED_PARITY_EVENTS)
    t1 = time.perf_counter()
    sim, ok = scenarios.fed_arm(cut22, FED["seed"], f"{td22}/cuda",
                                m=scenarios.serving_modules("cuda"))
    digests22 = {"cuda": m21.fed.global_digest(sim),
                 "cpu": cpu2022["22"]["digest"]}
    log(f"[22 fed parity] cuda: {FED_PARITY_EVENTS} events, "
        f"{sim.step_no} steps in {time.perf_counter() - t1:.2f}s, "
        f"settled {ok}, global digest {digests22['cuda']}")
    log(f"[22 fed parity] cpu (CPU_ARMS[20-22]): {FED_PARITY_EVENTS} "
        f"events, {cpu2022['22']['steps']} steps in "
        f"{cpu2022['22']['s']:.2f}s, settled {cpu2022['22']['settled']}, "
        f"global digest {digests22['cpu']}")
    check(ok and cpu2022["22"]["settled"], (ok, cpu2022["22"]))
    del sim
    check(digests22["cuda"] == digests22["cpu"], digests22)
    scenarios.release()

    # -- 23. supervised processes on the card ---------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    td23 = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    seen23 = {}

    # nvidia-smi in a container that sees another pid namespace lists
    # every compute app as pid 1: what shows the shards on the card is
    # that the apps grow by one for each shard child once it has stepped
    # (the workers, ready by then, open their context at their first
    # cycle, later in their arm)
    apps_before = compute_apps()
    kernels.reset_counts()
    t0 = time.perf_counter()
    # the federation arm's workers start while the shard arm runs
    fed23 = scenarios.start_fed_workers(DIST, DIST["seed"] + 4, td23,
                                        device="cuda")

    def apps_while_running(sup):
        scenarios.wait_fed_workers(fed23, DIST["ready_timeout_s"])
        seen23.update(apps=compute_apps(), children={
            n: mp.proc.pid for n, mp in [*sup.procs.items(),
                                         *fed23["workers"].items()]})
        return seen23

    try:
        with DeviceClock() as dc23, GCWatch() as gc23:
            s23 = scenarios.dist_kill_front_end_shard(
                DIST, DIST["seed"] + 1, td23, device="cuda",
                while_running=apps_while_running)
            shard_s = time.perf_counter() - t0
            f23 = scenarios.dist_kill_federation_worker(
                DIST, DIST["seed"] + 4, td23, device="cuda", started=fed23)
    finally:
        fed23["sup"].terminate_all()
    wall23 = time.perf_counter() - t0
    launches23p = dict(kernels.LAUNCHES)
    starts23 = {k: round(v, 3) for k, v in {**s23["starts_s"],
                                            **f23["starts_s"]}.items()}
    kids23 = {**s23["child_stats"], **f23["child_stats"]}
    launches23c = summed([st and st["launches"] for st in kids23.values()])
    argvs23 = s23["argvs"] + f23["argvs"]
    jax_argv = [a for a in argvs23 if any(
        x == "kueue_tpu" or x.startswith("kueue_tpu.") for x in a)]
    card_kids = [n for n in seen23["children"] if not n.startswith("sub")]
    shards_on_card = {n: seen23["children"][n] in seen23["apps"]
                      for n in card_kids}
    apps_added = len(seen23["apps"]) - len(apps_before)
    log(f"[23 dist-procs] dist_soak.py's config ({DIST['cqs']} CQs, "
        f"{DIST['shards']} shards, {DIST['submitters']} submitters, "
        f"{DIST['workers']} workers, seed {DIST['seed']}), every child "
        f"`python -m kueue_tpu_torch.dist.child --device cuda`: "
        f"front_end_shard (the workers starting beside it) "
        f"{shard_s:.2f}s: killed {s23['killed']}, same "
        f"port {s23['same_port']}, {s23['admissions']} admissions over "
        f"{s23['steps']} steps, decisions identical "
        f"{s23['decisions_identical']}, lost {s23['lost']}, duplicated "
        f"{s23['duplicated']}, dedupe {json.dumps(s23['dedupe'])}; "
        f"federation_worker {wall23 - shard_s:.2f}s: killed "
        f"{f23['killed']}, manager / worker parity {f23['manager_parity']}"
        f" / {f23['worker_parity']}, settled {f23['settled']}, duplicated "
        f"{f23['duplicated']}, epoch resyncs {f23['epoch_resyncs']}, proxy "
        f"{json.dumps(f23['proxy'])}; child start (spawn to ready, s; the "
        f"workers' to the first look, after the shard arm's first step) "
        f"{json.dumps(starts23)}"
        f"; children's build s "
        f"{json.dumps({n: st and st['build_s'] for n, st in kids23.items()})}"
        f" (null: the library was loaded, not built); compute apps before "
        f"{apps_before}, while the children ran {seen23.get('apps')} "
        f"(+{apps_added}), children {json.dumps(seen23.get('children'))}, "
        f"shard / worker pids listed {json.dumps(shards_on_card)}; argvs "
        f"naming the JAX package {len(jax_argv)}; wall {wall23:.2f}s; "
        f"{gc23.line()}; launches in the children "
        f"{json.dumps({k: v for k, v in launches23c.items() if v})}, in "
        f"this process (the controls and the manager) "
        f"{json.dumps({k: v for k, v in launches23p.items() if v})}; this "
        f"process's {device_line('23', dc23, wall23, launches23p)}")
    check(s23["ok"] and f23["ok"], (s23["ok"], f23["ok"]))
    check(not jax_argv, jax_argv)
    check(all(shards_on_card.values()) or apps_added == DIST["shards"],
          (apps_before, seen23))
    check(all(st and st["cuda_initialized"] for st in kids23.values()),
          kids23)
    check(all(sum(st["launches"][k] for k in ADMIT_KERNELS) > 0
              for n, st in kids23.items() if n.startswith("shard")), kids23)
    check(sum(launches23c[k] for k in ADMIT_KERNELS) > 0, launches23c)
    launches23 = summed([launches23p, launches23c])
    del s23, f23
    scenarios.release()

    # -- 24. the kueuectl file store on the card ------------------------------
    # the apply and every CPU step ran in CPU_ARMS["24"] since phase 2
    import contextlib
    import io
    import shutil
    import threading
    from kueue_tpu_torch import cli
    td24 = CLI_DIR[0]
    new24 = [f"default/serve-{i}" for i in range(CLI_SERVE)]
    t24 = time.perf_counter()
    applied24 = wait_for_json(f"{td24}/applied.json", 900)
    check(applied24["rc"] == 0, applied24)
    drivers24 = []
    build24 = cli.build_driver

    def keep_driver(store, device="cuda"):
        drivers24.append(build24(store, device=device))
        return drivers24[-1]

    cli.build_driver = keep_driver
    out24 = io.StringIO()
    kernels.reset_counts()
    try:
        with DeviceClock() as dc24, LaunchThreads() as lt24, \
                contextlib.redirect_stdout(out24):
            t1 = time.perf_counter()
            rc24 = cli.main(["--state-dir", f"{td24}/a", "--device", "cuda",
                             "schedule", "--cycles", "1000"])
            sched24_s = time.perf_counter() - t1
    finally:
        cli.build_driver = build24
    launches24a = dict(kernels.LAUNCHES)
    ss24 = drivers24[0].scheduler.solver.stats
    text24 = out24.getvalue()
    admitted24 = [ln.strip() for ln in text24.splitlines()[1:]]
    digest24a = scenarios.store_digest(f"{td24}/a")
    # (d) on the card: the daemon as children, on a copy of (a)'s store,
    # while (c) and (d0) run here
    seq24: dict = {}

    def card_sequence():
        try:
            seq24["cuda"] = scenarios.cli_serve_sequence(
                f"{td24}/d_cuda", f"{td24}/serve.yaml", "cuda", new24)
        except BaseException as e:   # raised below, on this thread
            seq24["cuda"] = e

    t2 = time.perf_counter()
    shutil.copytree(f"{td24}/a", f"{td24}/d_cuda")
    kid24 = threading.Thread(target=card_sequence)
    kid24.start()
    log(f"[24 cli-3k] `python -m kueue_tpu_torch.cli apply -f` of the perf "
        f"scenario's 5 cohorts x 6 CQs and {applied24['workloads']} "
        f"workloads as manifests on the card {applied24['apply_s']:.2f}s "
        f"(in CPU_ARMS['24'] since phase 2); (a) `cli --device cuda schedule "
        f"--cycles 1000` in this process {sched24_s:.2f}s: rc {rc24}, "
        f"{text24.splitlines()[0] if text24 else 'no output'} "
        f"{json.dumps(admitted24)}, full_cycles {ss24['full_cycles']}, "
        f"host_cycles {ss24['host_cycles']}, state.json digest {digest24a}; "
        f"launching threads {len(lt24.idents)}; launches "
        f"{json.dumps({k: v for k, v in launches24a.items() if v})} "
        f"(admit_scan_preempt {launches24a['admit_scan_preempt']}, "
        f"minimal_preemptions_batch "
        f"{launches24a['minimal_preemptions_batch']}); "
        f"{device_line('24', dc24, sched24_s, launches24a)}")
    check(rc24 == 0, text24[-3000:])
    check(launches24a["admit_scan"] > 0, launches24a)
    check(ss24["host_cycles"] == 0, ss24)
    check(len(admitted24) > 0, text24)
    # (c) `cli state` on the card: every CQ with its usage
    out24 = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out24):
        rc = cli.main(["--state-dir", f"{td24}/a", "--device", "cuda",
                       "state"])
    dump24 = out24.getvalue().splitlines()
    usage24 = dump24[dump24.index("-- cache usage --") + 1:
                     dump24.index("-- admitted workloads --")]
    cqs24 = [f"cq-{c}-{q}" for c in range(scenarios.N_COHORTS)
             for q in range(scenarios.CQS_PER_COHORT)]
    listed24 = {ln.split(":")[0].strip() for ln in usage24}
    used24 = {ln.split(":")[0].strip() for ln in usage24
              if not ln.endswith("{}")}
    log(f"[24 cli state] rc {rc} in {time.perf_counter() - t0:.2f}s: "
        f"{len(listed24)} of {len(cqs24)} CQs listed with their usage, "
        f"{len(used24)} using quota; {usage24[0].strip()} ...")
    check(rc == 0 and listed24 == set(cqs24), usage24)
    # (d0) `cli serve` in this process: the store watcher's thread never
    # decides a cycle or launches; the daemon's thread does both
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--state-dir", f"{td24}/s", "--device", "cuda",
                       "apply", "-f", f"{td24}/cluster.yaml"])
    check(rc == 0, "apply of the cluster")
    kernels.reset_counts()
    t0 = time.perf_counter()
    with LaunchThreads() as lt24s, contextlib.redirect_stdout(io.StringIO()):
        s24 = scenarios.cli_serve_in_process(f"{td24}/s",
                                             f"{td24}/serve.yaml", "cuda",
                                             new24)
    serve24_s = time.perf_counter() - t0
    launches24s = dict(kernels.LAUNCHES)
    log(f"[24 cli serve in-process] the watcher applied {CLI_SERVE} "
        f"workloads and the daemon admitted them in {serve24_s:.2f}s: rc "
        f"{s24['rc']}, error {s24['error']!r}, dispatching threads "
        f"{len(s24['dispatches'])} (the daemon's only "
        f"{set(s24['dispatches']) == {s24['serve_thread']}}), launching "
        f"threads {len(lt24s.idents)} (the daemon's only "
        f"{set(lt24s.idents) == {s24['serve_thread']}}); launches "
        f"{json.dumps({k: v for k, v in launches24s.items() if v})}")
    check(s24["rc"] == 0 and s24["error"] is None, s24["error"])
    check(set(s24["dispatches"]) == {s24["serve_thread"]}, s24["dispatches"])
    check(set(lt24s.idents) == {s24["serve_thread"]}, dict(lt24s.idents))
    check(launches24s["admit_scan"] > 0, launches24s)
    del s24, drivers24
    kid24.join()
    seq24_s = time.perf_counter() - t2
    if isinstance(seq24["cuda"], BaseException):
        raise seq24["cuda"]
    c24 = seq24["cuda"]
    cpu24 = CPU_ARMS["24"].result()
    with open(f"{td24}/d_cuda/{cli.STATE_FILE}", encoding="utf-8") as fh:
        held24 = {f"{doc['metadata'].get('namespace', 'default')}/"
                  f"{doc['metadata']['name']}" for doc in json.load(fh)
                  if doc["kind"] == "Workload"
                  and (doc.get("status") or {}).get("admission")}
    log(f"[24 cli serve] `cli serve` leader and `serve --exit-when-drained` "
        f"waiter as children on a copy of (a)'s store, {seq24_s:.2f}s with "
        f"(c) and (d0) beside: card seconds {json.dumps(c24['ready_s'])} "
        f"(leader and waiter: spawn to ready; apply: the child's run; "
        f"admitted_in_dump: after it; the rest from the SIGTERM), exit "
        f"codes {c24['rc']}, the leader's SIGUSR2 dump listed "
        f"{c24['admitted_in_dump']}/{CLI_SERVE} applied workloads admitted, "
        f"last lines {json.dumps(c24['leader_out'][-1:])} / "
        f"{json.dumps(c24['waiter_out'][-1:])}; final store: {len(held24)} "
        f"holding quota, digest {c24['digest']}")
    log(f"[24 cli dump] {json.dumps(c24['dump'].splitlines()[:8])}")
    log(f"[24 cli cpu] CPU_ARMS['24'] ({cpu24['child_s']:.2f}s beside "
        f"phases 3-24): (b) the same schedule with --device cpu on a copy "
        f"of the applied store {cpu24['schedule_s']:.2f}s: rc "
        f"{cpu24['schedule_rc']}, output equal {cpu24['schedule_out'] == text24}"
        f", digest {cpu24['digest_b']} (card {digest24a}); (d) the same "
        f"sequence on --device cpu on a copy of (b)'s store: seconds "
        f"{json.dumps(cpu24['seq']['ready_s'])}, exit codes "
        f"{cpu24['seq']['rc']}, dump listed "
        f"{cpu24['seq']['admitted_in_dump']}/{CLI_SERVE}, digest "
        f"{cpu24['seq']['digest']} (card {c24['digest']}); phase 24 "
        f"{time.perf_counter() - t24:.2f}s")
    check(cpu24["schedule_rc"] == 0 and cpu24["schedule_out"] == text24,
          (text24[-2000:], cpu24["schedule_out"][-2000:]))
    check(cpu24["digest_b"] == digest24a, (digest24a, cpu24["digest_b"]))
    check(c24["ok"] and cpu24["seq"]["ok"], (c24["rc"], cpu24["seq"]["rc"]))
    check(held24 == set(admitted24) | set(new24), sorted(held24)[:5])
    check(c24["digest"] == cpu24["seq"]["digest"],
          (c24["digest"], cpu24["seq"]["digest"]))
    launches24 = summed([launches24a, launches24s])
    shutil.rmtree(td24, ignore_errors=True)
    scenarios.release()

    # -- 25. the north-star twin: the mixed fleet, four arms ---------------
    # the card arms ran in CARD_ARMS["25-26"] since phase 16, the host-walk
    # oracle in CPU_ARMS["25"] since phase 2
    from kueue_tpu_torch import northstar
    t25 = time.perf_counter()
    card = CARD_ARMS["25-26"].result()
    c25 = card["25"]
    host25 = CPU_ARMS["25"].result()
    args25 = northstar.parse_args(NS_HETERO + ["--torch-device", "cuda:0"])
    runs25 = dict(c25["runs"], host=[host25["out"]])
    part25, hetero25 = northstar.hetero_block(args25, runs25)
    tail25 = northstar.tail_of(args25, part25, c25["mesh"], hetero=hetero25)
    launches25 = c25["launches"]
    digests25 = dict(c25["digests"], **{"host (cpu)": host25["digest"]})
    for arm, r in runs25.items():
        where = (f"CPU_ARMS[25], {host25['child_s']:.2f}s beside phases 3-25"
                 if arm == "host" else "CARD_ARMS[25-26], beside phases 16-24")
        log(f"[25 northstar-hetero-1k] {arm} arm ({r[0]['path']}, {where}): "
            f"{c25['walls'].get(arm, host25['arm_s']):.2f}s with its build, "
            f"{r[0]['cycles_run']} cycles, p50 {r[0]['p50_ms']}ms p99 "
            f"{r[0]['p99_ms']}ms, admitted {r[0]['admitted']}, preempted "
            f"{r[0]['preempted']}, skipped {r[0]['skipped']}, workloads "
            f"{r[0]['workloads']}; launches "
            f"{json.dumps(c25['arm_launches'].get(arm, {}))}")
    fb25 = hetero25["fallbacks"]
    dirty25 = {k: v for k, v in runs25["sharded"][0]["burst_stats"].items()
               if k.startswith("burst_dirty")}
    log(f"[25 northstar-hetero-1k] {NS_HETERO}: {args25.cqs} CQs x "
        f"{args25.flavors} flavors x {args25.resources} resources, "
        f"{args25.wl} workloads, {args25.cycles} cycles; digests "
        f"{json.dumps(digests25)}; hetero: identical "
        f"{hetero25['decisions_identical_across_arms']}, zero host "
        f"fallbacks {hetero25['zero_host_fallbacks']}, fallbacks "
        f"{json.dumps(fb25)}, resume_heads {hetero25['resume_heads']}, "
        f"walk_stop_heads {hetero25['walk_stop_heads']}, sharded dirty "
        f"{json.dumps(dirty25)}; tail value {tail25['value']} "
        f"({tail25['best_solver_path']}), hard paths "
        f"{tail25['hard_paths_exercised']}, mesh {json.dumps(c25['mesh'])}; "
        f"card arms {c25['wall']:.2f}s; {c25['device']}; waited "
        f"{time.perf_counter() - t25:.2f}s here")
    check(len(set(digests25.values())) == 1, digests25)
    check(hetero25["decisions_identical_across_arms"], hetero25)
    check(hetero25["zero_host_fallbacks"], fb25)
    check(all(fb25[k] == 0 for k in fb25 if k != "scalar_reasons"), fb25)
    check(all(v == 0 for v in dirty25.values()), dirty25)
    check(hetero25["resume_heads"] > 0 and hetero25["walk_stop_heads"] > 0,
          hetero25)
    check(tail25["hard_paths_exercised"], "phase 25: no preemption or skip")
    check(all(r[0]["cycles_run"] == args25.cycles for r in runs25.values()),
          {k: r[0]["cycles_run"] for k, r in runs25.items()})
    check(launches25["admit_scan_forests"] + launches25["admit_scan"] > 0,
          launches25)
    for k in ("admit_scan_preempt", "minimal_preemptions_batch",
              "burst_cycles", "kq_reduce_dflags"):
        check(launches25[k] > 0, (k, launches25))

    # -- 26. the north-star twin: fill, then the trickle's delta packs -----
    c26 = card["26"]
    tail26 = c26["tail"]
    args26 = northstar.parse_args(NS_PACK)
    launches26 = c26["launches"]
    arms26 = {r: tail26[r] for r in ("burst-accel", "burst-accel-serial",
                                     "burst-accel-serial-fullpack")}
    for path, r in arms26.items():
        tr = r["trickle"]
        log(f"[26 northstar-trickle-1k] {path}: p50 {r['p50_ms']}ms p99 "
            f"{r['p99_ms']}ms, admitted {r['admitted']}, preempted "
            f"{r['preempted']}, skipped {r['skipped']}, {r['cycles_run']} "
            f"cycles (main {args26.cycles}, the fill, {tr['rounds']} "
            f"trickle rounds); trickle delta_pack_s "
            f"{tr['delta_pack_s']} burst_pack_s {tr['burst_pack_s']}, packs "
            f"{tr['burst_packs']} (delta {tr['burst_delta_packs']}, full "
            f"{tr['burst_full_packs']}), rows reused {tr['rows_reused']} "
            f"repacked {tr['rows_repacked']}; boundary "
            f"{boundary_report(r['burst_stats'])}")
    log(f"[26 northstar-trickle-1k] {NS_PACK} (CARD_ARMS[25-26]): "
        f"{c26['wall']:.2f}s; digests {json.dumps(c26['digests'])}; "
        f"pack_compare {json.dumps(tail26['pack_compare'])}; launches "
        f"{json.dumps({k: v for k, v in launches26.items() if v})}; "
        f"{c26['device']}")
    check(tail26["pack_compare"]["decisions_identical"],
          tail26["pack_compare"])
    check(len(c26["digests"]) == 3 and len(set(c26["digests"].values())) == 1,
          c26["digests"])
    full26 = arms26["burst-accel-serial-fullpack"]
    check(full26["burst_stats"]["burst_delta_packs"] == 0
          and full26["trickle"]["burst_delta_packs"] == 0, full26["trickle"])
    check(all(r["trickle"]["rounds"] == 6 for r in arms26.values()), arms26)
    check(launches26["burst_cycles"] > 0, launches26)
    # the delta packs at north-star width, card against CPU: the delta-pack
    # serial arm at 1,000 CQs, the backlog drained before the trickle
    p26 = card["26p"]
    cpu26 = CPU_ARMS["26"].result()
    log(f"[26 trickle parity] {NS_PACK_PARITY}: card (CARD_ARMS[25-26], "
        f"{p26['wall']:.2f}s) {p26['admitted']} admitted, trickle "
        f"{json.dumps(p26['trickle'])}, launches "
        f"{json.dumps({k: v for k, v in p26['launches'].items() if v})}, "
        f"digest {p26['digest']}; CPU_ARMS[26] ({cpu26['child_s']:.2f}s): "
        f"{cpu26['admitted']} admitted, digest {cpu26['digest']}; card "
        f"arms' child {card['child_s']:.2f}s")
    counts26 = ("burst_packs", "burst_full_packs", "burst_delta_packs",
                "rows_reused", "rows_repacked", "admitted", "rounds")
    check(p26["digest"] == cpu26["digest"], (p26["digest"], cpu26["digest"]))
    check(all(cpu26["trickle"][k] == p26["trickle"][k] for k in counts26),
          (cpu26["trickle"], p26["trickle"]))
    check(p26["trickle"]["burst_delta_packs"] > 0
          and p26["trickle"]["rows_reused"] > 0, p26["trickle"])
    check(p26["launches"]["burst_cycles"] > 0, p26["launches"])

    # -- 3l. the kernels on the calls captured in phases 25 and 26 ---------
    # compared in the card arms' child; counted here with the others
    c3l = card["3l"]
    for name, s_ in c3l["stats"].items():
        m = stats[name]
        m["cases"] += s_["cases"]
        m["mismatches"] += s_["mismatches"]
        m["max_abs_err"] = max(m["max_abs_err"], s_["max_abs_err"])
        for route, n in s_.get("routes", {}).items():
            m.setdefault("routes", {})[route] = (
                m.get("routes", {}).get(route, 0) + n)
        check(s_["mismatches"] == 0, (name, s_))
    check(c3l["captured"].get("burst_cycles")
          and c3l["captured"].get("admit_scan_preempt"), c3l["captured"])
    log(f"[3l kernels, captured 25-26 {json.dumps(c3l['captured'])}] "
        f"{json.dumps(c3l['stats'])}")

    # -- 27. the chaos twin at 1,000 CQs: crash, recover, degrade ----------
    # the card arms ran in CARD_ARMS["27-29"] since phase 2
    t27 = time.perf_counter()
    soak = CARD_ARMS["27-29"].result()
    c27 = soak["27"]
    tail27 = c27["tail"]
    launches27 = c27["launches"]
    for name, r in tail27["scenarios"].items():
        log(f"[27 chaos-1k] {name}: stable {r.get('decisions_stable')}, "
            f"{r.get('wall_s')}s, "
            + json.dumps({k: v for k, v in r.items()
                          if k not in ("chaos", "decisions_stable",
                                       "wall_s")}))
    cascade = tail27["scenarios"].get("shard_cascade_8_4_1", {})
    log(f"[27 chaos-1k] {CHAOS_ARGS} (CARD_ARMS[27-29], {c27['wall']:.2f}s): "
        f"{tail27['cqs']} CQs, seed {tail27['seed']}, "
        f"{tail27['scenarios_stable']}/{tail27['scenarios_total']} stable, "
        f"mesh {json.dumps(tail27['mesh'])}; validator "
        f"{json.dumps(c27['problems'])}; launches "
        f"{json.dumps({k: v for k, v in launches27.items() if v})}; "
        f"{c27['device']}; waited {time.perf_counter() - t27:.2f}s here")
    check(tail27["scenarios_total"] == CHAOS_SCENARIOS
          and tail27["scenarios_stable"] == CHAOS_SCENARIOS
          and tail27["all_stable"],
          {n: r.get("failures") or r.get("reason")
           for n, r in tail27["scenarios"].items()})
    check(not any(r.get("skipped") for r in tail27["scenarios"].values()),
          "phase 27: a scenario was skipped")
    check((cascade.get("degradations"), cascade.get("serial_fallbacks"),
           cascade.get("final_shards")) == (2, 1, 1), cascade)
    check(c27["problems"] == [], c27["problems"])
    check(launches27["burst_cycles"] > 0
          and launches27["kq_reduce_dflags"] > 0
          and any(launches27[k] for k in ADMIT_KERNELS), launches27)
    p27 = soak["27p"]
    cpu27 = CPU_ARMS["27"].result()
    log(f"[27 chaos parity] {CHAOS_PARITY}: card (CARD_ARMS[27-29], "
        f"{p27['wall']:.2f}s) {p27['stable']}/{p27['total']} stable, digests "
        f"{json.dumps(p27['digests'])}; CPU_ARMS[27] "
        f"({cpu27['child_s']:.2f}s) {cpu27['stable']}/{cpu27['total']}")
    check(p27["stable"] == p27["total"] == CHAOS_SCENARIOS
          and cpu27["stable"] == cpu27["total"] == CHAOS_SCENARIOS,
          (p27["stable"], cpu27["stable"]))
    check(p27["digests"] == cpu27["digests"],
          (p27["digests"], cpu27["digests"]))

    # -- 28. the OBS twin: traced and untraced Drivers in lockstep ----------
    c28 = soak["28"]
    tail28 = c28["tail"]
    launches28 = c28["launches"]
    ov28 = tail28["overhead"]
    log(f"[28 obs-16] {OBS_ARGS} (CARD_ARMS[27-29], {c28['wall']:.2f}s): "
        f"{tail28['cqs']} CQs, {tail28['cycles']} cycles x {tail28['reps']} "
        f"reps; decisions identical {tail28['decisions_identical']}; "
        f"traced p50 {ov28['traced_p50_ms']:.4f}ms untraced p50 "
        f"{ov28['untraced_p50_ms']:.4f}ms ratio {ov28['ratio']:.4f}; spans "
        f"{json.dumps({k: v['count'] for k, v in tail28['spans'].items()})}"
        f", missing {tail28['spans_missing_host_phases']}; dumps "
        f"{json.dumps(tail28['dumps'])}; validator "
        f"{json.dumps(c28['problems'])}; launches "
        f"{json.dumps({k: v for k, v in launches28.items() if v})}")
    check(tail28["decisions_identical"], "phase 28: decisions diverged")
    check(ov28["ratio"] <= 1.05, ov28)
    check(not tail28["spans_missing_host_phases"]
          and {"cycle", "cycle.snapshot", "cycle.nominate", "cycle.admit",
               "wal.append", "wal.commit"} <= set(tail28["spans"]),
          tail28["spans"].keys())
    check(tail28["dumps"]["flightrecorder_ok"]
          and tail28["dumps"]["sigusr2_ok"]
          and tail28["dumps"]["chrome_trace_events"] > 0, tail28["dumps"])
    check(c28["ok"] and c28["problems"] == [], c28["problems"])
    check(any(launches28[k] for k in ADMIT_KERNELS), launches28)
    cpu28 = CPU_ARMS["28"].result()
    log(f"[28 obs parity] {OBS_PAIR}: card and CPU_ARMS[28] "
        f"({cpu28['child_s']:.2f}s) per-cycle digests equal "
        f"{c28['pair']['digests'] == cpu28['digests']}, admitted "
        f"{len(cpu28['admitted']['traced'])}")
    check(c28["pair"]["digests"] == cpu28["digests"]
          and c28["pair"]["admitted"] == cpu28["admitted"],
          (c28["pair"]["digests"], cpu28["digests"]))

    # -- 29. the scale twin --quick: curve, arms, ceiling, pool, soak -------
    c29 = soak["29"]
    tail29 = c29["tail"]
    launches29 = c29["launches"]
    rec29 = c29["record"]
    for pt in tail29["curve"]:
        log(f"[29 scale-quick] {pt['cqs']} CQs: rows {pt['rows']} live "
            f"{pt['live_rows']} row-backed {pt['rows_row_backed']}, pack "
            f"stream {pt['pack_ms_stream']}ms rebuild "
            f"{pt['pack_ms_rebuild']}ms, planes identical "
            f"{pt['planes_identical']}, cycle wall {pt['cycle_wall_ms']}ms "
            f"(rebuild {pt['cycle_wall_ms_rebuild']}ms, classic "
            f"{pt['cycle_wall_ms_classic']}ms), host apply "
            f"{pt['host_apply_ms']}ms, bytes_h2d_e2e {pt['bytes_h2d_e2e']}; "
            f"arm digests " + json.dumps(
                {a: rec29[str((pt["cqs"], a))] for a in (
                    "stream", "rebuild", "nobulk", "classic")}))
    ce29, hp29, sk29 = tail29["ceiling"], tail29["host_pool"], tail29["soak"]
    gate29 = [e for e in c29["problems"] if POOL_GATE in e]
    log(f"[29 scale-quick] {SCALE_ARGS} (CARD_ARMS[27-29], "
        f"{c29['wall']:.2f}s): ceiling {json.dumps(ce29)}; host pool "
        f"serial {hp29['apply_pack_ms_serial']}ms pooled "
        f"{hp29['apply_pack_ms_pooled']}ms ({hp29['apply_pack_speedup']}x, "
        f"{hp29['workers']} workers, {hp29['cores_available']} cores): "
        f"pool gate {'missed: ' + gate29[0] if gate29 else 'held'}; soak "
        f"{sk29['created']} created {sk29['admitted']} admitted in "
        f"{sk29['wall_s']}s ({sk29['workloads_per_s']}/s, peak rss "
        f"{sk29['peak_rss_mb']}MB); parity {json.dumps(tail29['parity'])}; "
        f"launches {json.dumps({k: v for k, v in launches29.items() if v})}; "
        f"{c29['device']}")
    check(c29["ok"], tail29["parity"])
    check(all(tail29["parity"].values()), tail29["parity"])
    for pt in tail29["curve"]:
        check(pt["planes_identical"] and len({rec29[str((pt["cqs"], a))]
              for a in ("stream", "rebuild", "nobulk", "classic")}) == 1,
              (pt["cqs"], rec29))
    check(rec29[str(("pool", 0))] == rec29[str(("pool", hp29["workers"]))],
          rec29)
    check(sk29["completed"], sk29)
    check([e for e in c29["problems"] if POOL_GATE not in e] == [],
          c29["problems"])
    check(launches29["burst_cycles"] > 0, launches29)
    cpu29 = CPU_ARMS["29"].result()
    card29 = rec29[str((SCALE_PARITY["n"], "stream"))]
    log(f"[29 scale parity] the stream arm at {SCALE_PARITY}: card {card29}, "
        f"CPU_ARMS[29] ({cpu29['child_s']:.2f}s) {cpu29['digest']}; card "
        f"arms' child {soak['child_s']:.2f}s")
    check(card29 == cpu29["digest"], (card29, cpu29["digest"]))

    # -- 30-32. the traffic, serve and federation twins at --quick ---------
    # the card arms ran in CARD_ARMS["30-32"] since phase 2, their CPU
    # sides in CPU_ARMS["30-32"]
    t30 = time.perf_counter()
    twins = CARD_ARMS["30-32"].result()
    cpu30 = CPU_ARMS["30-32"].result()
    c30 = twins["30"]
    tail30 = c30["tail"]
    launches30 = c30["launches"]
    for arm, a in tail30["arms"].items():
        log(f"[30 traffic-quick] {arm}: sustainable "
            f"{a['sustainable_rate_per_s']}/s, curve (rate, submitted, "
            f"admitted, end depth, virtual p99 s, cycle wall p50 ms) "
            + json.dumps([[e["rate_per_s"], e["submitted"], e["admitted"],
                           e["end_depth"], e["p99_latency_s"],
                           e["cycle_wall_p50_ms"]] for e in a["curve"]]))
    log(f"[30 traffic-quick] {TRAFFIC_ARGS} (CARD_ARMS[30-32], "
        f"{c30['wall']:.2f}s): {tail30['cqs']} CQs, replay identical "
        f"{tail30['replay_identical']}, serial = shards "
        f"{tail30['serial_shard_decisions_match']}, mesh "
        f"{json.dumps(tail30['mesh'])}; storm "
        f"{json.dumps(tail30['storm_probe'])}; remote "
        f"{json.dumps(tail30['remote_probe'])}; validator "
        f"{json.dumps(c30['problems'])}; launches "
        f"{json.dumps({k: v for k, v in launches30.items() if v})}; "
        f"{c30['device']}; card = CPU_ARMS[30-32] "
        f"{c30['decided'] == cpu30['30']['decided']} (decided), "
        f"{c30['record'] == cpu30['30']['record']} ({len(c30['record'])} "
        f"probe digests); waited {time.perf_counter() - t30:.2f}s here")
    check(tail30["replay_identical"]
          and tail30["serial_shard_decisions_match"],
          "phase 30: the replay or the sharded arm diverged")
    check(tail30["mesh"].get("virtual") and tail30["mesh"]["shards"] == 8,
          tail30["mesh"])
    check(c30["problems"] == [], c30["problems"])
    check(any(launches30[k] for k in ADMIT_KERNELS)
          and launches30["kq_gather_heads"] > 0, launches30)
    check(c30["decided"] == cpu30["30"]["decided"],
          "phase 30: card and CPU decided differently")
    check(c30["record"] == cpu30["30"]["record"], (
        c30["record"], cpu30["30"]["record"]))
    c31 = twins["31"]
    tail31 = c31["tail"]
    launches31 = c31["launches"]
    w31 = tail31["wall"]
    kill31 = {k: v for k, v in tail31["kill_restart"].items()
              if k != "scenarios"}
    log(f"[31 serve-quick] {SERVE_ARGS} (CARD_ARMS[30-32], "
        f"{c31['wall']:.2f}s): {tail31['cqs']} CQs; parity "
        f"{json.dumps(tail31['parity'])}; kill {json.dumps(kill31)}; "
        f"drain {json.dumps(tail31['drain'])}; wall "
        f"{w31['admissions_per_s']:.2f} admissions/s ({w31['admitted']} of "
        f"{w31['submitted']}), held {w31['slo']['held']}, K "
        f"{w31['slo']['k_values']}, window p99 s "
        f"{[round(w['p99_s'], 4) for w in w31['slo']['windows']]}; "
        f"validator {json.dumps(c31['problems'])}; launches "
        f"{json.dumps({k: v for k, v in launches31.items() if v})}; "
        f"{c31['device']}; card = CPU_ARMS[30-32] "
        f"{c31['decided'] == cpu30['31']['decided']}")
    check(tail31["all_ok"], {k: tail31.get(k) for k in (
        "parity", "kill_restart", "drain")})
    check(c31["problems"] == [], c31["problems"])
    check(any(launches31[k] for k in ADMIT_KERNELS), launches31)
    check(c31["decided"] == cpu30["31"]["decided"],
          (c31["decided"], cpu30["31"]["decided"]))
    c32 = twins["32"]
    tail32 = c32["tail"]
    launches32 = c32["launches"]
    for name, r in tail32["scenarios"].items():
        log(f"[32 fed-quick] {name}: stable {r['decisions_stable']}, "
            f"{r['wall_s']}s, parity {r.get('parity')}, double "
            f"{r.get('double_admissions')}, digests "
            f"{json.dumps(r.get('state_digest'))}, counters "
            f"{json.dumps(r.get('counters'))}")
    log(f"[32 fed-quick] {FED_ARGS} (CARD_ARMS[30-32], {c32['wall']:.2f}s): "
        f"{tail32['cqs']} CQs, {tail32['workers']} workers, "
        f"{tail32['events']} events, {tail32['scenarios_stable']}/"
        f"{tail32['scenarios_total']} converged; validator "
        f"{json.dumps(c32['problems'])}; launches "
        f"{json.dumps({k: v for k, v in launches32.items() if v})}; "
        f"{c32['device']}; card = CPU_ARMS[30-32] "
        f"{c32['decided'] == cpu30['32']['decided']}; twins' card child "
        f"{twins['child_s']:.2f}s, CPU child {cpu30['child_s']:.2f}s")
    check(tail32["all_stable"] and tail32["scenarios_total"] == 4,
          {n: r.get("failures") for n, r in tail32["scenarios"].items()})
    check(tail32["double_admissions_total"] == 0, tail32)
    check(c32["problems"] == [], c32["problems"])
    check(any(launches32[k] for k in ADMIT_KERNELS), launches32)
    check(c32["decided"] == cpu30["32"]["decided"],
          (c32["decided"], cpu30["32"]["decided"]))

    # -- 33. the dist twin --quick: processes, kills, wire faults ----------
    # the card side ran in CARD_ARMS["33"] since phase 2 (its children
    # started from that child), the CPU side in CPU_ARMS["33"]
    t33 = time.perf_counter()
    card33 = CARD_ARMS["33"].result()
    c33 = card33["33"]
    cpu33 = CPU_ARMS["33"].result()
    tail33 = c33["tail"]
    sat33 = tail33["saturation"]
    launches33p = c33["launches"]
    kids33 = c33["kids"]
    launches33c = summed([st and st["launches"] for st in kids33.values()])
    argvs33 = c33["argvs"]
    jax_argv33 = [a for a in argvs33 if any(
        x == "kueue_tpu" or x.startswith("kueue_tpu.") for x in a)]
    not_port33 = [a for a in argvs33
                  if a[1:3] != ["-m", "kueue_tpu_torch.dist.child"]]
    # a child opens its context at its first launch: every shard launches,
    # a worker may not (the socket arm's never steps; a restarted one with
    # nothing left to admit never launches)
    launched33 = {n: st for n, st in kids33.items()
                  if st and sum(st["launches"].values())}
    for arm, b in tail33["kills"].items():
        log(f"[33 dist-quick] {arm}: " + json.dumps(b))
    log(f"[33 dist-quick] {DIST_ARGS} (CARD_ARMS[33], {c33['wall']:.2f}s, "
        f"the tail's own {tail33['elapsed_s']:.2f}s): saturation "
        f"(wall-clock, not compared) ceiling "
        f"{sat33['ceiling_admissions_per_s']:.2f} admissions/s, rounds "
        f"(n, accepted, drain steps, s, admissions/s) "
        + json.dumps([[r["n_per_submitter"], r["accepted"],
                       r["drain_steps"], round(r["elapsed_s"], 4),
                       round(r["admissions_per_s"], 2)]
                      for r in sat33["rounds"]])
        + f"; socket faults {json.dumps(tail33['socket_faults'])}; by "
        f"role {json.dumps(tail33['dist']['by_role'])}; kill log "
        f"{tail33['dist']['kill_log']}; child start (spawn to ready, s), "
        f"CUDA context, launches, build s by arm "
        f"{json.dumps(c33['children'])}; argvs {len(argvs33)}, naming the "
        f"JAX package {len(jax_argv33)}, not the port's child "
        f"{len(not_port33)}; validator and children "
        f"{json.dumps(c33['problems'])}; launches in the children "
        f"{json.dumps({k: v for k, v in launches33c.items() if v})}, in "
        f"the card child (the controls and the manager) "
        f"{json.dumps({k: v for k, v in launches33p.items() if v})}; "
        f"{c33['device']}; card = CPU_ARMS[33] "
        f"{c33['decided'] == cpu33['decided']} (CPU all_ok "
        f"{cpu33['all_ok']}); card child {card33['child_s']:.2f}s, CPU "
        f"child {cpu33['child_s']:.2f}s; waited "
        f"{time.perf_counter() - t33:.2f}s here")
    check(tail33["all_ok"], {k: tail33[k] for k in ("kills",
                                                     "socket_faults")})
    check(c33["problems"] == [], c33["problems"])
    check(not jax_argv33 and not not_port33, (jax_argv33, not_port33))
    check(all(st["cuda_initialized"] for st in launched33.values())
          and all(n in launched33 for n in kids33 if "/shard" in n), kids33)
    check(all(sum(st["launches"][k] for k in ADMIT_KERNELS) > 0
              for n, st in kids33.items() if "/shard" in n), kids33)
    check(cpu33["all_ok"] and cpu33["problems"] == [], cpu33)
    check(c33["decided"] == cpu33["decided"],
          (c33["decided"], cpu33["decided"]))
    launches33 = summed([launches33p, launches33c])

    # -- 35. the router: cold, second cold, stale --------------------------
    # the card side ran in CARD_ARMS["35"] from phase 16 on, beside phases
    # 16-33 (walls not clean), the CPU side in CPU_ARMS["35"]; (d) runs
    # after 34, with no arm left
    t35 = time.perf_counter()
    card35 = CARD_ARMS["35"].result()
    c35 = card35["35"]
    cpu35 = CPU_ARMS["35"].result()
    a35, b35, stale35 = c35["a"], c35["b"], c35["c"]

    def table_keys(rec):
        return [(r["kind"], r["W"], r["key_len"], sorted(r["ms"]))
                for r in rec["table"]]

    def winners(rec):
        return dict(Counter(f"{r['kind']}:{r['fastest']}"
                            for r in rec["table"]))
    log(f"[35 router] (a) cold, north-star {NORTHSTAR['n_cqs']} CQs x "
        f"{NORTHSTAR['n_wl']} workloads, \"auto\": warm-up "
        f"{a35['warmup_s']:.3f}s, the library's load {a35['load_s']:.3f}s "
        f"apart (built in phase 2 in {kernels.BUILD['seconds']:.2f}s), "
        f"rtt {a35['rtt_ms']:.4f}ms, native_calibration_failures "
        f"{a35['native_calibration_failures']}, calibration_loaded "
        f"{a35['calibration_loaded']}, sidecars {a35['sidecars']}, "
        f"measured fastest {json.dumps(winners(a35))}, routed "
        f"{json.dumps(dict(Counter(r['route'] for r in a35['table'])))}, "
        f"launches "
        f"{json.dumps({k: v for k, v in a35['launches'].items() if v})}")
    log("[35 router] (a) table (ms by route, fastest, routed) "
        + json.dumps([[r["kind"], r["W"], r["key_len"],
                       {k: round(v, 4) for k, v in r["ms"].items()},
                       r["fastest"], r["route"]] for r in a35["table"]]))
    log(f"[35 router] (b) second cold process: warm-up "
        f"{b35['warmup_s']:.3f}s (load {b35['load_s']:.3f}s apart; the "
        f"process {b35['process_s']:.2f}s with its build of the cluster), "
        f"calibration_loaded {b35['calibration_loaded']}, the same keys "
        f"{table_keys(b35) == table_keys(a35)}, rtt {b35['rtt_ms']:.4f}ms")
    log(f"[35 router] (c) stale schema: calibration_rejected "
        f"{stale35['calibration_rejected']}, loaded "
        f"{stale35['calibration_loaded']}, re-measured in "
        f"{stale35['warmup_s']:.3f}s and written with schema "
        f"{stale35['rewritten_schema']}; the CPU arm's perf-15k under "
        f"\"auto\": routes {json.dumps(cpu35['routes'])} "
        f"({cpu35['wall']:.2f}s), digest {cpu35['digest']}; card child "
        f"{card35['child_s']:.2f}s, CPU child {cpu35['child_s']:.2f}s; "
        f"waited {time.perf_counter() - t35:.2f}s here")
    check(a35["native_calibration_failures"] == 0, a35)
    check(a35["calibration_loaded"] == 0 and len(a35["sidecars"]) == 1, a35)
    check(a35["rtt_ms"] is not None and a35["launches"]["kq_add_one"] > 0,
          a35["launches"])
    # "auto" on a card routes every bucket to the card, whatever it measured
    check({r["route"] for r in a35["table"]} == {"cuda"}, a35["table"])
    check(b35["calibration_loaded"] == 1 and b35["calibration_rejected"] == 0,
          b35)
    check(table_keys(b35) == table_keys(a35), (table_keys(b35),
                                               table_keys(a35)))
    check(stale35["calibration_rejected"] == 1
          and stale35["calibration_loaded"] == 0, stale35)
    check(cpu35["finished"] == BENCH_WORKLOADS
          and cpu35["warmup"]["native_calibration_failures"] == 0, cpu35)
    check(cpu35["digest"] == digest4, (cpu35["digest"], digest4))

    # -- 34. the roofline twin --quick: dispatch, readback, scan, burst -----
    # in this process once every arm has ended: no arm competes for the
    # host, and no profiler runs (its host cost would enter the walls)
    from kueue_tpu_torch import accel_roofline
    from kueue_tpu_torch.perf.validate import validate_tail
    busy34 = [tag for tag, arm in {**CPU_ARMS, **CARD_ARMS}.items()
              if arm.proc.poll() is None]
    args34 = accel_roofline.parser().parse_args(ROOF_ARGS + [
        "--torch-device", "cuda"])
    rec34 = {}
    kernels.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        tail34 = accel_roofline.run(args34, rec34)
    wall34 = time.perf_counter() - t0
    launches34 = dict(kernels.LAUNCHES)
    problems34 = (accel_roofline.check(rec34)
                  + validate_tail(tail34, "ROOFLINE_r22.json"))
    on_card34 = sorted(k for k in rec34 if k.startswith("accel:"))
    for r in tail34["per_dispatch_admit_scan"] + tail34["fused_burst"]:
        log(f"[34 roofline-quick] {json.dumps(r)}")
    log(f"[34 roofline-quick] {ROOF_ARGS} ({wall34:.2f}s; arms still "
        f"running {busy34}): tunnel {json.dumps(tail34['tunnel'])}; "
        f"crossover {json.dumps(tail34['crossover'])}; {len(on_card34)} "
        f"card outputs, each equal to the plain version's on the host: "
        f"{not problems34} {json.dumps(problems34)}; launches "
        f"{json.dumps({k: v for k, v in launches34.items() if v})}")
    check(not problems34, problems34)
    check(len(on_card34) == 6, on_card34)   # 2 W x 2 scans, 2 K
    check(all(launches34[k] > 0 for k in ("admit_scan", "admit_scan_forests",
                                           "burst_cycles")), launches34)

    # -- 35 (d). perf-15k and the north-star shape under each backend ------
    # in this process after 34, no arm running and no profiler: clean walls
    busy35 = [tag for tag, arm in {**CPU_ARMS, **CARD_ARMS}.items()
              if arm.proc.poll() is None]
    t0 = time.perf_counter()
    d35 = phase35_drains(BENCH_WORKLOADS, NORTHSTAR["n_cqs"],
                         NORTHSTAR["n_wl"], NORTHSTAR["cycles"])
    launches35 = summed([a35["launches"]] + [
        r["launches"] for by in d35.values() for r in by.values()])
    for shape, by in d35.items():
        for backend, r in by.items():
            log(f"[35 router] (d) {shape} \"{backend}\": "
                f"{r['finished'] if shape == 'perf-15k' else r['admitted']}"
                f"{' finished' if shape == 'perf-15k' else ' admitted'} of "
                f"{r['total']} in {r['cycles']} cycles, {r['wall']:.2f}s, "
                f"cycle p50 {r['p50_ms']:.3f}ms p99 {r['p99_ms']:.3f}ms, "
                f"routes {json.dumps(r['routes'])}, warm-up "
                f"{r['warmup']['warmup_s']:.3f}s, measured fastest "
                f"{json.dumps(winners(r['warmup']))}, digest {r['digest']}; "
                f"launches "
                f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
    digests35 = {
        "perf-15k": {**{b: r["digest"] for b, r in d35["perf-15k"].items()},
                     "phase 4": digest4, "CPU_ARMS[35]": cpu35["digest"]},
        "northstar": {**{b: r["digest"]
                         for b, r in d35["northstar"].items()},
                      "phase 5": digest5}}
    log(f"[35 router] (d) ({time.perf_counter() - t0:.2f}s; arms still "
        f"running {busy35}; unprofiled) digests {json.dumps(digests35)}")
    for shape, by in d35.items():
        check(len(set(digests35[shape].values())) == 1, digests35[shape])
        for backend, r in by.items():
            # the plain versions never serve a dispatch with a card, and
            # "auto" keeps every scan on it
            check(r["routes"]["cpu"] == 0, (shape, backend, r["routes"]))
            check((r["routes"]["native"] > 0) == (backend == "native"),
                  (shape, backend, r["routes"]))
            check(r["warmup"]["native_calibration_failures"] == 0,
                  r["warmup"])
        check(by["auto"]["routes"] == by["accel"]["routes"],
              (by["auto"]["routes"], by["accel"]["routes"]))
    check(all(r["finished"] == r["total"] == BENCH_WORKLOADS
              for r in d35["perf-15k"].values()), d35["perf-15k"])
    check(d35["perf-15k"]["auto"]["launches"]["admit_scan"] > 0
          and d35["northstar"]["auto"]["launches"]["admit_scan_forests"] > 0,
          (d35["perf-15k"]["auto"]["launches"],
           d35["northstar"]["auto"]["launches"]))

    # -- 3i. the mesh kernels and the per-shard scans against plain ---------
    mesh_phases = ("bench_mesh", "northstar_mesh", "northstar_fs_mesh",
                   "dryrun")
    t0 = time.perf_counter()
    n_captured = {}
    for phase in mesh_phases:
        for name in MESH_KERNELS + MESH_SCANS + PHASE1:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                n_captured[name] = n_captured.get(name, 0) + 1
    rng = np.random.default_rng(1000)
    planes, head_of, fills = testing.gather_case(
        rng, W=1000, S=8, dtypes=("bool", "bool", "bool"))
    synth_gather = [tuple(tuple(on_card(list(p))) for p in planes),
                    torch.from_numpy(sharded.source_map(head_of,
                                                        1000)).cuda(),
                    fills]
    compare("kq_gather_heads", synth_gather, {}, stats)
    winners, head_of = testing.merge_case(rng, W=1000, S=8)
    synth_merge = [tuple(on_card(list(winners))),
                   tuple(on_card(list(head_of))), 1000]
    compare("kq_fs_merge_order", synth_merge, {}, stats)
    for name in MESH_KERNELS + MESH_SCANS + PHASE1:
        check(stats[name]["mismatches"] == 0, (name, stats[name]))
    for name in MESH_KERNELS:
        check(n_captured.get(name), f"{name}: nothing captured in 16-16d")
    log(f"[3i mesh kernels, synthetic + captured {json.dumps(n_captured)}] "
        f"in {time.perf_counter() - t0:.1f}s; "
        f"{json.dumps({k: stats[k] for k in MESH_KERNELS + MESH_SCANS})}")

    # -- 3j. two launches taken apart: wrapper, bare C launch, library -----
    t0 = time.perf_counter()
    cases3j = [
        ("phase 15, S = 4", "kq_reduce_dflags",
         *cap.calls[("northstar_sharded", "kq_reduce_dflags")][0]),
        ("S = 8, K = 32", "kq_reduce_dflags",
         on_card([testing.dflags_blocks(8, 32)]), {}),
        ("phase 16b, widest", "kq_gather_heads",
         *widest_mesh("kq_gather_heads",
                      cap.calls[("northstar_mesh", "kq_gather_heads")])),
        ("1,000 heads x 8 shards", "kq_gather_heads", synth_gather, {}),
    ]
    j3 = launch_breakdown(cases3j)
    log(f"[3j launch breakdown] ({time.perf_counter() - t0:.1f}s) "
        f"{json.dumps(j3)}")

    # -- 3k. the profiler's clocks: the host op to its kernel, then and now -
    clock_offset1 = profiler_clock_offset()
    log(f"[3k profiler clock] host op to its kernel's start, µs: after the "
        f"build {json.dumps(clock_offset0)}; "
        f"{time.perf_counter() - t_start:.1f}s into the run "
        f"{json.dumps(clock_offset1)}; DeviceClock's margin "
        f"{DeviceClock.MARGIN_S * 1e6:.0f}µs")

    # -- the kernels line ----------------------------------------------------
    by_phase = {"4": launches4, "5": launches5, "7": launches7,
                "8": launches8, "9": launches9, "9b": launches9b,
                "11": launches11, "13": launches13, "14": launches14,
                "15": launches15, "15b": launches15b, "15c": launches15w,
                "16": launches16, "16b": launches16b, "16c": launches16c,
                "16d": launches16d, "17": launches17, "18": launches18,
                "19": launches19, "20": launches20, "21": launches21,
                "22": launches22, "23": launches23, "24": launches24,
                "25": launches25, "26": launches26, "27": launches27,
                "28": launches28, "29": launches29, "30": launches30,
                "31": launches31, "32": launches32, "33": launches33,
                "34": launches34, "35": launches35}
    # the round-trip probe at the shape warm-up gives it, eight int32:
    # the probe's values, then seeded ones with both int32 limits (the
    # add wraps, as the plain version's)
    from kueue_tpu_torch.ops import rtt
    probe_args = [torch.from_numpy(rtt.PROBE).cuda()]
    compare("kq_add_one", probe_args, {}, stats)
    seeded = np.random.default_rng(23).integers(
        -2**31, 2**31, 8, dtype=np.int64).astype(np.int32)
    seeded[:2] = (2**31 - 1, -2**31)
    compare("kq_add_one", [torch.from_numpy(seeded).cuda()], {}, stats)
    check(stats["kq_add_one"]["cases"] == 2, stats["kq_add_one"])
    check(stats["kq_add_one"]["mismatches"] == 0, stats["kq_add_one"])
    cap.calls[("rtt", "kq_add_one")] = [(probe_args, {})]
    rows = []
    for name in kernels.KERNELS:
        phase = {"admit_scan_forests": "northstar",
                 "kq_add_one": "rtt",
                 "burst_cycles": "northstar_burst",
                 "fs_admit_scan": "northstar_fs",
                 "drs_components": "northstar_fs",
                 **dict.fromkeys(TAS_KERNELS, "tas"),
                 **dict.fromkeys(PHASE1, "probe"),
                 "kq_scatter_rows": "northstar_resident",
                 "kq_reduce_dflags": "northstar_sharded",
                 "kq_gather_heads": "northstar_mesh",
                 "kq_fs_merge_order": "northstar_fs_mesh"}.get(name,
                                                               "bench")
        calls = cap.calls.get((phase, name))
        check(calls, f"{name}: no captured {phase} call")
        args, kw = (burst_window(calls) if name == "burst_cycles"
                    else most_heads(calls) if name == "fs_admit_scan"
                    else deepest(calls) if name == "best_fit_descend"
                    else most_rows(calls) if name == "kq_scatter_rows"
                    else widest_mesh(name, calls) if name in MESH_KERNELS
                    else widest(calls) if name in PHASE1
                    else calls[0] if name in ("drs_components",
                                              "fill_counts",
                                              "split_across_roots",
                                              "kq_reduce_dflags",
                                              "kq_add_one")
                    else largest(calls))
        t = time_kernel(name, args, kw)
        launches = {"northstar": launches5, "bench": launches4,
                    "northstar_burst": launches8,
                    "northstar_fs": launches9, "tas": launches11,
                    "probe": launches13, "northstar_sharded": launches15,
                    "northstar_resident": launches15w,
                    "northstar_mesh": launches16b,
                    "northstar_fs_mesh": launches16c,
                    "rtt": a35["launches"]}[phase][name]
        extra = {}
        if name in ROUTED:
            extra["timed_route"] = route_of(name)
        if name == "kq_add_one":
            extra["timed_shape"] = dict(n=int(args[0].shape[0]))
            extra["round_trip_ms"] = a35["rtt_ms"]
        if name == "kq_scatter_rows":
            rows_t = sharded.unpack_scatter_rows(*args)[0]
            extra["timed_shape"] = dict(
                planes=len(args[0]), rows=int(args[0][0].shape[0]),
                Dp=int(args[2]), distinct=int(torch.unique(rows_t).numel()),
                buffer_bytes=int(args[1].numel()),
                row_bytes=scatter_layout(args[0], args[2])[1])
            extra["device_ms_per_launch_on_path"] = per_launch(dc15w, name)
        if name == "kq_reduce_dflags":
            extra["timed_shape"] = dict(S=int(args[0].shape[0]),
                                        K=int(args[0].shape[1]))
        if name in MESH_KERNELS:
            path_dc = {"kq_gather_heads": dc16b,
                       "kq_fs_merge_order": dc16c}[name]
            extra["timed_shape"] = mesh_shape(name, args)
            extra["device_ms_per_launch_on_path"] = per_launch(path_dc, name)
            ts = time_kernel(name, synth_gather if name == "kq_gather_heads"
                             else synth_merge, {})
            extra["synthetic_1000x8"] = {k: ts[k] for k in (
                "ms", "bare_ms", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        if name in TAS_KERNELS:
            # the route each level of the timed call took, as the kernel
            # wrote it (fill_counts walks none)
            routes = (kernels.TAS_ROUTES[name].cpu().tolist()
                      if name in kernels.TAS_ROUTES else [])
            extra["dependent_steps"] = tas_dependent_steps(name, args, kw,
                                                           routes)
            extra["timed_shape"] = dict(
                level_sizes=list(kw["level_sizes"]),
                R=int(args[0].shape[1]),
                **{k: kw[k] for k in ("level", "profile", "descend_profile")
                   if k in kw},
                routes={d: kernels.TAS_ROUTE_NAMES[routes[d]]
                        for d in tas_levels(name, kw)})
            if name == "best_fit_descend":
                check(all(routes[d] == 1 for d in tas_levels(name, kw)),
                      f"best_fit_descend: not the warp route on every "
                      f"walked level of the timed tas-4k call: {routes}")
            extra["device_ms_per_launch_on_path"] = per_launch(dc11, name)
        if name == "fs_admit_scan":
            # the dependent chain: the largest forest's rounds beside the
            # others, and the membership and merge passes
            rounds, entry_rounds, node_rounds = fs_forest_work(args)
            extra["dependent_steps"] = fs_dependent_steps(args, kw)
            extra["timed_shape"] = dict(
                N=int(args[0].shape[0]), F=int(args[0].shape[1]),
                W=int(args[12].shape[0]), heads=rounds,
                depth=kw["depth"], n_levels=kw["n_levels"],
                n_forests=kw["n_forests"], max_forest=kw["max_forest"],
                threads=kernels.fs_threads(int(args[0].shape[1]),
                                           kw["max_forest"]))
            # the worst case: one forest holding the 1,000 CQs and 200
            # cohorts (nested under one root), its rounds all in one block
            c1 = testing.fs_cycle(np.random.default_rng(9), n_cqs=1000,
                                  n_cohorts=200, depth=3, F=1, R=1, W=1024,
                                  n_valid=1000, roots=1)
            a1, k1 = on_card(list(testing.fs_args(c1))), testing.fs_kw(c1)
            compare(name, a1, k1, stats)
            check(stats[name]["mismatches"] == 0, stats[name])
            t1 = time_kernel(name, a1, k1)
            extra["one_forest"] = dict(
                **{k: t1[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=fs_dependent_steps(a1, k1),
                shape=dict(N=int(a1[0].shape[0]), W=1024, heads=1000,
                           n_forests=k1["n_forests"],
                           max_forest=k1["max_forest"],
                           n_levels=k1["n_levels"],
                           threads=kernels.fs_threads(1, k1["max_forest"])))
        if name in PHASE1:
            extra["timed_shape"] = {
                "kq_cq_avail": lambda: dict(N=int(args[0].shape[0]),
                                            F=int(args[0].shape[1]),
                                            C=kw["n_cqs"]),
                "kq_classify_heads": lambda: dict(
                    W=int(args[0].shape[0]),
                    C_S_R=list(args[3].shape), pairs=kw["pairs"]),
                "kq_cycle_order": lambda: dict(W=int(args[0].shape[0])),
            }[name]()
            extra["device_ms_per_launch_on_path"] = per_launch(dc13, name)
            if name == "kq_classify_heads":
                # the 1,000-head call of the scans, with the pairs
                h_args, h_kw = min(cap.calls[("probe", name)],
                                   key=lambda c: c[0][0].shape[0])
                th = time_kernel(name, h_args, h_kw)
                extra["heads_1000_with_pairs"] = dict(
                    ms=th["ms"], plain_ms=th["plain_ms"],
                    bound_ms=th["bound_ms"], bound_by=th["bound_by"],
                    W=int(h_args[0].shape[0]))
        if name in ROUTED:
            extra["routes"] = stats[name].get("routes")
        if name == "admit_scan":
            # the perf-15k call timed above, the probe's flat 1,000 heads
            # (64 forests) and the worst case, one forest of 1,000 CQs
            # under 64 cohorts with 1,000 heads
            extra["dependent_steps"] = flat_dependent_steps(args, kw)
            extra["timed_shape"] = dict(
                N=int(args[0].shape[0]), F=int(args[0].shape[1]),
                W=int(args[8].shape[0]), depth=kw["depth"],
                tables=kw.get("forest_of_node") is not None)
            extra["device_ms_per_launch_on_path"] = per_launch(dc4, name)
            extra["device_ms_per_launch_mesh"] = per_launch(dc16, name)
            p_args, p_kw = cap.calls[("probe", name)][0]
            tp = time_kernel(name, p_args, p_kw)
            extra["probe_1000_heads"] = dict(
                **{k: tp[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                device_ms_per_launch_on_path=per_launch(dc13, name),
                dependent_steps=flat_dependent_steps(p_args, p_kw))
            c1 = testing.admit_cycle(np.random.default_rng(7), n_cqs=1000,
                                     n_cohorts=64, depth=3, F=12, W=1000,
                                     R=3, roots=1)
            a1 = on_card(testing.admit_args(c1))
            k1 = dict(depth=c1["depth"])
            compare(name, a1, k1, stats)
            check(stats[name]["mismatches"] == 0, stats[name])
            t1 = time_kernel(name, a1, k1)
            extra["one_forest"] = dict(
                **{k: t1[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=flat_dependent_steps(a1, k1),
                shape=dict(N=int(a1[0].shape[0]), F=12, W=1000, heads=1000,
                           depth=k1["depth"]))
        if name == "admit_scan_preempt":
            # the perf-15k call timed above, and northstar-1k's
            # 1,000-gang cycle (the captured call with the most
            # preempting heads)
            def preempt_shape(a, k):
                pre = a[16] & (a[8] >= 0)
                return dict(N=int(a[0].shape[0]), F=int(a[0].shape[1]),
                            W=int(a[8].shape[0]), depth=k["depth"],
                            preempting=int(pre.sum()),
                            targets=int(((a[19] >= 0)
                                         & pre[:, None]).sum()),
                            tables=k.get("forest_of_node") is not None)
            extra["timed_shape"] = preempt_shape(args, kw)
            extra["device_ms_per_launch_on_path"] = per_launch(dc4, name)
            n_args, n_kw = max(cap.calls[("northstar", name)],
                               key=lambda c: int(c[0][16].sum()))
            tn = time_kernel(name, n_args, n_kw)
            extra["northstar_1000_gangs"] = dict(
                **{k: tn[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                launches=launches5[name],
                device_ms_per_launch_on_path=per_launch(dc5, name),
                shape=preempt_shape(n_args, n_kw))
        if name == "drs_components":
            extra["timed_shape"] = dict(N=int(args[0].shape[0]),
                                        F=int(args[0].shape[1]),
                                        R=kw["n_resources"],
                                        depth=kw["depth"])
            extra["device_ms_per_launch_on_path"] = per_launch(dc9, name)
            # the chain's cost: 1,000 CQs under a cohort chain 17 deep
            d_args, d_kw = testing.drs_case(
                np.random.default_rng(17), n_cqs=1000, n_cohorts=16,
                depth=2, F=12, R=3, wl_req=False, chain=True)
            d_args = on_card(d_args)
            compare(name, d_args, d_kw, stats)
            check(stats[name]["mismatches"] == 0, stats[name])
            td = time_kernel(name, d_args, d_kw)
            extra["deep_17"] = dict(
                **{k: td[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                route=route_of(name), shape=dict(N=1016, F=12, R=3,
                                                 depth=d_kw["depth"]))
        if name == "burst_cycles":
            # the same timing on a perf-scenario window (5 forests)
            b_args, b_kw = burst_window(cap.calls[("bench_burst", name)])
            tb = time_kernel(name, b_args, b_kw)
            extra["bench_burst"] = dict(
                ms=tb["ms"], kernel_ms=tb["kernel_ms"],
                plain_ms=tb["plain_ms"],
                bound_ms=tb["bound_ms"], bound_by=tb["bound_by"],
                dependent_steps=burst_dependent_steps(b_kw),
                device_ms_per_launch_on_path=per_launch(dc7, name),
                shape=dict(C=int(b_args[0].shape[0]),
                           M=int(b_args[0].shape[1]), KC=b_kw["KC"],
                           K=b_kw["K"], L=b_kw["L"]))
            extra["dependent_steps"] = burst_dependent_steps(kw)
            extra["device_ms_per_launch_on_path"] = per_launch(dc8, name)
            # the worst case: one forest of every CQ (40 CQs, one block)
            o_args, o_kw = testing.burst_one_forest(0)
            o_args = [torch.from_numpy(a).cuda()
                      if isinstance(a, np.ndarray) else int(a)
                      for a in o_args]
            to = time_kernel(name, o_args, o_kw)
            extra["one_forest"] = dict(
                **{k: to[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=burst_dependent_steps(o_kw),
                shape=dict(C=40, L=o_kw["L"], KC=o_kw["KC"], K=o_kw["K"]))
            extra["sharded_northstar"] = dict(
                shards=NORTHSTAR_SHARDS,
                launches=launches15["burst_cycles"],
                device_ms_per_launch=per_launch(dc15, "burst_cycles"))
            extra["timed_shape"] = dict(C=int(args[0].shape[0]),
                                        M=int(args[0].shape[1]),
                                        KC=kw["KC"], K=kw["K"], L=kw["L"])
        rows.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=TPU_KERNEL[name], launches=launches,
            max_abs_err=stats[name]["max_abs_err"], **t,
            cases=stats[name]["cases"],
            mismatches=stats[name]["mismatches"], path=phase,
            launches_by_phase={k: v[name] for k, v in by_phase.items()},
            **extra))
    print(json.dumps({"kernels": rows}), flush=True)
    log("[walls] s by phase, to each line from the one before: "
        + json.dumps({k: round(v, 3) for k, v in PHASE_WALLS.items()}))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
