#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel from ``dinunet_implementations_tpu_torch/csrc``;
3. kernel ``lstm_fwd`` (K1: the projection, then the recurrence over a
   thread-block cluster) against ``lstm_recurrence_plain`` on the card,
   all eight outputs, f32 and bf16, at T=98, D=256, H=174 and rows 1, 16,
   512, on the route the launcher picks and on the streaming route, and
   the projection's xp against ``lstm_proj_plain``; the geometry picked
   (cluster size, rows a cluster, clusters, shared memory, threads) with
   cudaOccupancyMaxActiveClusters; times of K1 on both routes, the
   projection alone, the plain version and a cuDNN ``torch.nn.LSTM``;
   then, untimed, every geometry the launcher can pick (clusters of 2, 4
   and 8, ragged slices and rows, the streaming route's rows-per-block
   templates at H=400), and the model-layout ``lstm_forward_fused``
   against ``lstm_forward_plain``;
4. kernel ``lstm_bwd`` (K2) against ``lstm_bwd_plain``, all six outputs,
   f32 and bf16, at rows 16 and 512, on the cluster route the launcher
   picks (a cluster BPTT that holds W_hhᵀ in shared memory and
   reduce-scatters dh through distributed shared memory) and on the stream
   route (the first design), with the geometry, cudaOccupancyMaxActiveClusters
   and the phase clock; times of both routes, the plain version and the
   backward of a cuDNN ``torch.nn.LSTM`` (which also computes dx and dW);
   then, untimed, every geometry the cluster route can take (clusters of 2,
   4, 8, each rows a thread or m-tiles, ragged slices and a ragged last
   cluster) and the stream route's rows-a-block templates at H=400;
5. the serving slice at full ICA-LSTM width: ``InferenceEngine`` answers
   requests of 1-16 rows from two threads; every answer is checked against
   ``eval_forward`` with the plain LSTM, and the launch counter must show
   two K1 calls (one per direction) for every dispatch, all on the
   cluster route;
6. the training slice at full width: two federated dSGD epochs of 32
   sites, batch 16, Adam 1e-3, through ``make_train_epoch_fn`` with the
   kernels; each kernel must launch exactly twice (one per direction) per
   micro-batch, K1 and K2 on the cluster route; the first round's aggregate
   gradient, and the params,
   optimizer state, running statistics and losses after the epochs, are
   held against the same epochs through the kernels' plain versions on
   the card; epoch ms, samples/s and ms per round are printed;
7. kernel ``poweriter`` (K7) against ``poweriter_plain`` at one rankDAD
   round of the flagship: the r=10 class (7 leaves × 32 sites, seven
   buckets, nn.Linear weights read through transposed views) and the r=2
   class, with a dead site (G = 0) and a site of rank 2; f32 and bf16,
   cold and warm Ω, tol 1e-3 and 0, on the staged route the launcher picks
   (two blocks an SM, one wave) and on the direct route; P, Q, PQᵀ and
   the trip counts compared; times of both routes and the plain version,
   the bound, the streamed floor and the staged route's phase clock; then,
   untimed, ranks 1 and 16, row-major and transposed buckets, A's rows and
   columns off every tile multiple, a class past half an SM and an
   unaligned member (both direct by the geometry's rule) and the r=2 class
   forced onto the direct route; the wrapper's refusals (a class over the
   shared-memory limit, a G with no contiguous matrix axis); an r=17 class
   through the engine's ``subspace_iteration_grouped``, which goes to the
   plain version by shape (``POWERITER_PLAIN_CLASSES``) while an r=2
   class launches K7;
8. the rankDAD training slice: phase 6's two epochs with the rankDAD
   engine (rank 10, 5 refinements, tol 1e-3, warm starts) through K1, K2
   and K7, held against the all-plain path on the card the same way and
   on Ω; K7 must launch once per rank class per round, all on the staged
   route, no class may go to the plain version, and K1 and K2 take the
   cluster route;
9. kernels ``bilstm_fwd`` (K3), ``bilstm_pool_fwd`` (K5), ``bilstm_bwd``
   (K4) and ``bilstm_pool_bwd`` (K6) against their plain versions, every
   output and K5's pool, f32 and bf16, K3/K5 at rows 1, 16 and 512 and
   K4/K6 at rows 16 and 512; K3/K5 on the cluster route the launcher picks
   (the projection of both directions, then the recurrence over
   thread-block clusters) and on the stream route (the first design), with
   the geometry and cudaOccupancyMaxActiveClusters, the projection's xp2
   against ``bilstm_proj_plain`` (f32: bit-identical to K1's projection
   kernel on the same 8 gates) and the phase clock; K4 (full cotangent
   streams at the stream dtype) and K6 likewise on K2's cluster BPTT (half
   of the clusters a direction; bf16 also held to ``BWD_BF16_SHARE``) and
   on their stream route; times of each kernel (K3-K6 on both routes, the
   projection alone), its plain version and a cuDNN
   ``torch.nn.LSTM(bidirectional=True)`` forward or backward; then,
   untimed, every geometry K3/K5's launcher can pick (clusters of 2, 4, 8,
   each rows a thread, ragged slices and rows, K3 without residuals, the
   stream route at H=400), every geometry of K4's and K6's cluster route
   and their stream route's templates, and K4's per-row constant
   cotangent at the stream dtype on both routes, f32 and bf16;
10. the fused bidirectional arm, ``ICALstm(fused_bidir=True)``: phase 6's
   two dSGD epochs through K5 and K6 (one call each per micro-batch, both on
   the cluster route, no K1 or K2), held against the same epochs through
   the plain versions; one bf16 epoch; the one-model eval forward (rows 1
   and 16, one K3 call a call, on the cluster route) against the
   per-direction kernel path and the plain path; one one-model gradient
   (one K3 and one K4 call, both on the cluster route) against the plain
   path;
11. the fit slice at full width: a 32-site ICA demo tree (40 subjects a
   site, 100 components, 980 timepoints, windows of 10; its inputspec set
   to the default ``ICAArgs`` widths), and ``FedRunner(...,
   pipeline="host", epochs=3, agg_engine="dSGD").run()`` for fold 0, f32:
   K1 must launch twice per training micro-batch and per eval step, K2
   twice per micro-batch, all on the cluster route; the losses and test
   metrics must be finite, and every site's and the remote's
   ``logs.json``, ``test_metrics.csv`` and ``checkpoint_best.msgpack``
   must exist with JAX's keys; ``load_checkpoint`` of the best checkpoint
   must equal the fit's best state bit for bit; one epoch through the host
   pipeline must equal one through the device pipeline from the same state
   and plan, held to the spread of two device epochs;
   ``InferenceEngine(cfg, checkpoint=...)`` must answer the fold's test
   rows within 1e-4 of the trainer's eval probabilities, two K1 launches a
   dispatch. It prints the fit's seconds, the warm epoch ms and
   host-to-device bytes of each pipeline, and the ms of a validation pass
   and of saving and loading checkpoints, with the card's name and power
   limit;
12. the powerSGD training slice: phase 6's two epochs with the powerSGD
   engine (rank 10, error feedback) through K1 and K2, held against the
   all-plain path the same way, and the first round's q and e per leaf;
   2 K1 and 2 K2 a micro-batch on the cluster route and no K7 launch; after
   the epochs e is finite and differs between sites, and every site holds
   the same q; epoch ms, samples/s, ms a round and peak memory are printed;
13. the command line: ``runner.cli.main`` on phase 11's tree (reused, not
   written again), a federated powerSGD fit of fold 0 for 3 epochs after
   one epoch of largest-site pretraining, then ``--site 0`` for one epoch:
   K1 and K2 launch as counted for the pretraining, the training, the eval
   and the test, all on the cluster route; the printed JSON lines parse
   and hold finite metrics; the outputs exist with JAX's keys; the best
   checkpoint's q and e load back bit for bit. It prints the fit's and the
   pretraining's seconds and the checkpoint's bytes and save ms;
14. the FS task (the JAX package's default) at MSANNet's full width (66 ->
   256, 128, 64, 32 -> 2): a 5-site FreeSurfer demo tree of the reference
   fixture's shape (sites of uneven size, 66 features); every site read
   through the native batch reader (``native/fastio.cpp``, built with
   g++) and the Python reader, bit for bit, timed, with no fallback; K7
   at one FS rankDAD round's rank classes (r = 10: ``linear_0`` ..
   ``linear_3`` through transposed views, on the route ``k7_geometry``
   names, the direct route for rows of 66 values; r = 2: ``fc_out``)
   against the plain version, timed with its bound; ``FedRunner`` fits of
   fold 0 under dSGD, rankDAD (rank 10, warm starts) and powerSGD (rank
   10), 3 epochs each on the device pipeline: no kernel launches but K7,
   once a rank class and round on its route, outputs and the best
   checkpoint checked, the warm epoch ms, fit seconds and peak memory (in
   all, and over what was allocated before the fit) printed; one FS
   rankDAD epoch through K7 against the plain power iteration
   (first-round aggregate within ``AGG_TOL``, Ω within
   ``OMEGA_FIRST_TOL``); ``InferenceEngine`` from the rankDAD fit's best
   checkpoint, one request a dispatch, each answer within 1e-5 of the
   same forward on the CPU; the command line with no ``--task``: rankDAD
   after one epoch of largest-site pretraining, then ``--site 0``, K7
   counted for each part;
15. the serving plane: the unidirectional ICA-LSTM at full width (one
   direction of H=348), random weights from seed 0 written with the port's
   checkpoint writer and served from that file (``InferenceEngine(cfg,
   checkpoint=...)``, stream buckets 1 and 4, chunks of 8, 32 slots). K1 at
   H=348, rows 1, 4 and 16: the route and geometry the launcher picks (the
   streaming route: W_hh fits no cluster of 8), every output against the
   plain version, times of K1, the plain version and cuDNN's
   unidirectional ``torch.nn.LSTM`` beside the bound; one K1 launch a
   batched dispatch. Streaming: 8 sessions of 98 windows from two threads
   in ragged chunks of 1-13 windows, each final answer within
   ``SERVE_TOL`` of the batched lane on the card and of the CPU forward
   (also of the same session replayed alone, at another bucket); one
   session chunk by chunk (each awaited) and as one submission, bit for
   bit; the carry table's tensors, shapes and bytes unchanged after 6 × 98
   more windows; streaming-step ms p50/p99 per bucket, sessions occupied
   and evictions. Publish (``PublishController`` on a ``MetricsBus``): the
   live digest again is ``rejected-stale``, a candidate with a NaN leaf
   ``rejected-shadow`` with the live answers unchanged bit for bit, a
   perturbed candidate (seed 1) ``swapped`` with its pause and the shadow
   lane's K1 launches (2 a mirrored batch) and its answers bit for bit a
   fresh engine's, and ``check_rollback`` at a p99 target no request
   meets rolls back to the original answers bit for bit; no kernel library
   built or loaded after warmup. Fleet: ``ReplicaSet(replicas=2)`` on the
   card, bit for bit the single engine at every row bucket, each session on
   its ``home_slot``; after a swap, ``kill_replica(0)``: the supervisor
   restarts it at generation 2 on the current weights, a re-homed session
   replays bit for bit, and the restart seconds are printed;
16. the remaining workloads at the JAX package's bench_matrix.py widths:
   SMRI3DNet (8 sites of batch 4, 64³ volumes folded by the pipeline to
   32³ x 8, channels 16-128) and MultimodalNet (64 sites of batch 8, 66 FS
   values and 98 windows of 100 x 10, embed 256, 8 heads, 4 blocks). For
   each: the route of each K7 launch of each rankDAD rank class
   (``k7_launches``, ``k7_geometry``; the multimodal r = 10 class of 19
   buckets is two launches) and K7 against its plain version at each
   launch, timed with its bound; a cold and a warm epoch of 2 rounds under
   dSGD, rankDAD and powerSGD, f32 and bf16, through ``build_training``
   and ``make_train_epoch_fn``, the warm ms and the peak memory over the
   baseline, K7 counted once a launch and round on its route, no class in
   the plain version; the rankDAD epoch against the same epoch with
   ``use_kernel=False`` at phase 8's tolerances (K7 must launch); a
   rankDAD ``FedRunner`` fit of 3 epochs on a tree the phase writes (8
   sites: sMRI volumes of 64³ in the JAX tests' layout; the port's
   ``make_multimodal_demo_tree`` at full width), its outputs and best
   checkpoint checked, then ``InferenceEngine`` serves the checkpoint,
   each eval step of a site one dispatch, within ``SERVE_TOL`` of the
   trainer's eval; the command line on the multimodal tree under rankDAD;
   the local attention beside ``F.scaled_dot_product_attention``;
17. hostile and faulty sites at the flagship (phase 6's 32 sites of batch
   16, default ``ICAArgs``, per-direction arm, f32, Adam 1e-3, rank 10),
   under a ``FaultPlan`` (a scheduled drop of site 5 for rounds 1-3, a
   ``delay_at`` straggler, flaky sites at 5 %, site 9's inputs NaN for 3
   rounds: quarantined) and an ``AttackPlan`` (sign-flip on 3 sites, scale
   x10 on 1, noise on 1, a free-rider and a colluding pair, each over its
   own window), windowed on the global round counter: for dSGD, rankDAD and
   powerSGD under each of ``norm_clip``, ``trimmed_mean`` and
   ``coordinate_median``, a cold and a warm epoch through the kernels and
   through the plain versions, held at phase 8's tolerances (the first
   round's aggregate, rankDAD's Ω, powerSGD's q and e; the first loss; the
   health counters equal after the first round, the anomaly score within
   ``HOSTILE_FIRST_ANOMALY_TOL``; the later losses and the health after the
   epochs against the plain path and its run on inputs nudged by one ulp,
   within ``HOSTILE_SPREAD_FACTOR`` times that run's spread or a floor),
   the nearest anomaly z to the threshold
   printed; K1 and K2 twice a micro-batch on the cluster
   route, K7 once a rank class and round staged, no plain class; the warm
   epoch's ms and peak memory beside the same epoch with
   ``robust_agg="none"`` and no attack (the cost of the defence); the
   cosine of an attacked round's aggregate with the same mode's without
   the attack and with the clean weighted mean (information only); a
   rankDAD ``trimmed_mean`` ``FedRunner`` fit of 3 epochs on phase 11's
   tree with both plans
   (launches, ``logs.json``'s anomaly keys, the best checkpoint back bit for
   bit with its reputation fields); ``runner.cli.main`` with ``--faults
   @file --attacks '<json>' --robust-agg coordinate_median``;
18. elastic and durable rounds at the flagship (phase 6's 32 sites of batch
   16, per-direction arm, f32): buffered-async epochs (``staleness_bound``
   2, decay 0.5) under dSGD, rankDAD and powerSGD with a ``FaultPlan`` of
   two ``delay_at`` stragglers of 2 rounds and a drop, and overlapped
   epochs under dSGD and rankDAD, each through the kernels against the
   plain versions at phase 8's tolerances (the first aggregate within
   ``AGG_TOL``, rankDAD's first Ω by its Gram, the losses, the buffers'
   ages and weights equal; overlap: the first round's NaN, the stash
   carried across the epoch boundary), K1 and K2 twice a round on the
   cluster route and K7 once a rank class and round staged; an
   all-arrivals async epoch equal to the bulk-sync epoch bit for bit, and
   each mode's warm epoch against bulk-sync; a ``kill_at_round`` fit on
   phase 11's tree (``Preempted``, exit code 75, after the checkpoint;
   ``resume=True`` bit-equal to the uninterrupted fit; the command line
   exits 75, then 0 with ``--resume``); ``FedDaemon`` over an ICA tree of
   6 sites at full width, capacity 8, buffered-async, a leave after epoch 1
   and the rejoin after epoch 2, 4 epochs: the same K1/K2 launches every
   epoch, no kernel library built or loaded after the first, a daemon
   resumed after epoch 2 bit-equal to the uninterrupted one, every
   ``publish.json`` seen by the ``CheckpointWatcher`` with the checkpoint's
   ``params_digest``;
19. the privacy plane at the flagship (phase 6's 32 sites of batch 16,
   f32, 4 + 4 rounds a pair): dSGD, rankDAD and powerSGD under DP-SGD
   (clip 1.0, σ 0.5), dSGD under DP with ``secure_agg="mask"``, and dSGD
   with a personalized ``cls_fc3``, each through the kernels against the
   plain versions at phase 8's tolerances (the first round's aggregate and
   heads' step, rankDAD's first Ω by its Gram, powerSGD's first q and e,
   the losses), K1 and K2 twice a round on the cluster route, K7 once a
   rank class and round staged, and K7's trips under DP beside DP off;
   "mask" equal to "mask-nopads" and a clip-only run (clip 1e6, σ 0) equal
   to DP off, bit for bit on the card, and int32 addition wrapping; the
   DP transform's and the pads' device ms and launches a round; the
   BASELINE multimodal 64-site DP-SGD configuration at phase 16's widths
   under dSGD and rankDAD beside DP off (K7 on its routes, no plain
   class); on phase 11's tree a DP fit (ε against the accountant), one
   stopped by its ε budget after epoch 1 and resumed to the uninterrupted
   ε exactly, a personalized fit whose checkpoint holds the heads in JAX's
   layout and comes back bit for bit, the command line with every privacy
   flag; ``FedDaemon`` under DP with a personalized head, a leave and a
   rejoin (the head row reset, ε never reset); the JAX package's golden
   privacy-stack fit (hard-SNR, 6 sites, 60 epochs, DP 1.0 / 0.05, masked
   wires, ``cls_fc3``), its AUC recorded beside the JAX floor;
20. the fit's telemetry plane at phase 6's flagship (32 sites, batch 16,
   f32): dSGD and rankDAD, 2 epochs of 4 rounds with the round metrics
   through the kernels (K1 and K2 twice a round on the cluster route, K7
   once a rank class and round staged, no plain class), equal bit for bit
   in state, losses and launches to the same epochs without them; the
   accumulators equal bit for bit to their recompute on the card from the
   rounds' captured gradients, aggregates and updates, and each round's
   within TEL_ROUND_RTOL of the plain path's from the same state (the
   round and site where the gradient norm parts most are recorded, beside
   how far a one-ulp move of the weights moves the plain path's own norm
   there); the warm epoch with and without the metrics, and the kernels
   and host ms they add a round; a telemetry-on rankDAD fit of phase 11's tree with an xprof window on
   epoch 2, its artifacts through the report's ``--validate``, the window's
   device kernels (K1's projection and recurrence, K2, K7) counted equal to
   the launch counters over epoch 2; a command-line fit in a process of its
   own with ``--compile-cache`` at a copy of phase 2's libraries (builds
   nothing, loads every library from the copy) and ``--sanitize
   compile,nans``;
21. the live plane and the serving CLI at full width, on a tree of phase
   18's shape (6 sites of 40 subjects): (a) a flagship ICA checkpoint
   (2 x 174, random weights from seed 0) through ``python -m
   dinunet_implementations_tpu_torch.serving``'s ``main`` in this process
   with ``--smoke 60 --statusz-port 0 --linger-s 2 --sanitize compile``:
   a thread scrapes ``/metrics`` (the Prometheus text must parse),
   ``/healthz`` (200), ``/statusz`` (the SLO's samples equal to the
   requests served) and ``/tracez`` (``serve-infer`` spans) during the
   linger and times a flight dump; K1 twice a batched dispatch on the
   cluster route, no kernel library built or loaded after warmup, the
   report's ``--validate`` at rc 0; the host ms of a one-row request with
   the tracer and sink on against off, in turns; (b) phase 15's
   unidirectional checkpoint (H = 348) through the same CLI with
   ``--replicas 2`` and a script of infer, stream, swap, rollback_check
   and kill_replica: K1 on its stream route only, once a batched dispatch
   and twice a shadow-scored batch, the rows labelled by replica, no
   library loaded by the swap or the restart; (c) the command line's
   daemon (rankDAD, ``--serve --serve-epochs 3 --statusz-port 0
   --slo-p99-ms 500``) with telemetry on and off: state and losses equal
   bit for bit, the same launches an epoch (K1 and K2 on the cluster
   route, K7 staged, no plain class), the endpoints after epoch 2; a
   telemetry-on daemon in a process of its own sent SIGTERM after epoch 1
   leaves ``flight_<pid>.json`` with the final spans and the bus. One
   ``live plane:`` JSON line of the part's numbers;
22. analysis and the fleet scheduler at full width, on phase 21's tree (6
   sites of 40 subjects) and phase 14's: (a) ``analysis.engine_comparison``
   for dSGD, rankDAD and powerSGD, 2 epochs each (cut from the default
   101; 6 sites, not phase 11's 32, whose powerSGD fit would write ~18 GB of
   per-site result zips): each fit's K1 and K2
   launches counted on the cluster route (K7 staged for rankDAD, no plain
   class), each row equal to its fit's ``logs.json``,
   ``engine_comparison.md`` written; (b) ``analysis.pretrain_study`` on
   phase 14's tree under rankDAD, folds 0 and 1, 2 pretraining epochs, 3
   epochs: K7 r=10 direct and r=2 staged as phase 14 counts them, the CSV's
   header and 2 arms x 2 folds, ``write_study_figures`` returning ``[]``
   (no matplotlib on the card's machine); (c) ``FleetScheduler(pod_slices=1)``:
   tenant "ica" (the same ICA tree, rankDAD, batch 16, 2 rounds an epoch, 4
   epochs) preempted after 2 by tenant "fs" (phase 14's tree, rankDAD, 2
   epochs, higher priority) through checkpoint-then-yield, then resumed:
   its final ``params_digest`` equal to a solo daemon's, its epochs'
   launches equal to the solo daemon's (K1/K2 cluster, K7 staged, no plain
   class), no kernel library after either tenant's first epoch, the yield
   and the resume in ``grants.jsonl``; the pauses, ``goodput()`` and the
   idle fraction; (d) the runner CLI's ``--schedule`` over a spool of a
   register and a shutdown (rc 0, a strict-JSON summary) and a
   ``BackfillLane`` serving the flagship checkpoint beside a tenant held
   below its quorum: K1 twice a dispatch on the cluster route, no library
   after warmup. One ``scheduler:`` JSON line of the phase's numbers;
23. the supervisor and the pod plane at full width, on phase 21's tree (6
   sites of 40 subjects): (a) a ``SliceSupervisor`` over one worker
   process, ``scripts/torch_pod_worker.py``, a rankDAD ``FedRunner`` fit of
   the flagship ICA-LSTM (3 epochs) that advertises its ``StatusExporter``
   in its heartbeat, writes its spans to ``pod_trace/`` and rotates a slice
   checkpoint (meta ``round``, ``params_sha256``) each epoch; generation 1
   SIGKILLs itself at the aggregation of epoch 2's first round. The
   supervisor notes and dumps to a ``FlightRecorder``, its ``on_consensus``
   reads what ``consensus_round`` picks, holds the fold's resume point at
   its epoch and writes ``consensus/decision_gen1.json``, and it relaunches
   the worker with ``--resume``. Held: the supervisor's rc 0; the final
   ``params_digest`` and losses equal, bit for bit, to an uninterrupted run
   of the same worker alone after the drill; the resume's reload timed;
   during generation 2 a ``PodCollector`` over
   the supervisor's bus reads one target, no scrape error, with the
   worker's epoch and round; ``postmortem --validate`` rc 0, its incident
   slice 0, ``signal 9``, the consensus round and generation 2;
   ``assemble`` puts the supervisor's and both workers' spans on one
   timeline under one trace id; K1, K2 and K7 launched in each generation
   on the cluster (K1, K2) and staged (K7) routes, no plain class, and the
   two generations' launches equal to the uninterrupted run's plus the
   killed epoch's. (b) The runner CLI's ``--schedule --statusz-port`` over
   registers of phase 22's FS tenants ("fs1", one dSGD epoch, and "held",
   below its quorum): one ``/statusz`` during the run, after "fs1"'s epoch,
   says ``"mode": "pod"`` with the tenant table and the series stamped
   ``process="scheduler"``, ``/metrics`` carries ``pod_scrape_targets``; a
   shutdown event ends it, rc 0. One ``pod plane:`` JSON line of the phase's numbers;
24. the site axis over processes at full width (phase 6's 32 sites, batch 16):
   (a) dSGD, rankDAD and powerSGD epochs under the int8, int8 stochastic,
   fp8 and bf16 wire codecs against the same epochs on the f32 wire (the
   first round's aggregate within JAX's codec envelope, relative; K1 and K2
   on the cluster route, rankDAD's K7 staged, no plain class), and each
   codec's output on the card equal bit for bit to its CPU output on a fixed
   payload; (b) the dSGD and rankDAD epochs on an NCCL group of one (K = 32
   on ``multihost_site_mesh``) against phase 6's one-device epochs at the CPU
   tests' tolerances, whether bit-equal, the epoch ms and the collectives' ms
   a round; (c) two ``runner/dcn_worker.py`` processes under gloo with no
   ``--device`` (each takes the card, cuda:0; K = 3 a rank) fit phase 21's tree with rankDAD for 2 epochs: equal params
   checksums, losses within 1e-4 of the same worker alone, only rank 0
   writes, K1, K2 and K7 launched on each rank; first
   ``scripts/torch_gloo_cuda_probe.py``, two ranks, holds gloo's
   all_reduce, all_gather and broadcast on CUDA tensors. One line a
   sub-phase and one
   ``mesh:`` line;
25. the slice tier over processes at full width, on phase 21's tree (6
   sites; the card machine's disk cap keeps the tree at 6): (a) two
   ``runner/dcn_worker.py`` processes with ``--slices 2`` (two slices of
   one rank, gloo on cuda:0, no ``--device``, K = 3 a rank) fit it with
   rankDAD for 2 epochs, three times: the FUSED form, whose params
   checksum must equal phase 24 (c)'s unsliced world of 2 bit for bit; the
   SPLIT form under ``--dcn-wire-quant int8``, finite losses within
   ``SLICE_INT8_SHARE`` of the fused losses and the inter-slice elements a
   round, at a byte a value, equal to the fit's ``dcn_bytes_of``; and a
   ``slice_drop_at`` plan over all of epoch 2 with ``min_slices=2``, every
   round of epoch 2 held and the params after it those after epoch 1
   (the fused run's). Each rank launches K1 and K2 on the cluster route and
   K7 staged, no plain class; the collectives a round of each form are
   printed. (b) ``dcn_worker --supervise --num-processes 2 --slices 2``
   over the same fit with slice 1's ``kill_slice_at`` in epoch 2: the
   death in the liveness spool, JAX's decision file at epoch 1's round,
   and the resumed fleet's params checksum equal to the fused run's, bit
   for bit; the SIGKILL-to-first-pulse and reload times. One line a
   sub-phase and one ``slices:`` line;
26. one JSON line of per-kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

T, D, H = 98, 256, 174  # the ICA-LSTM's windows, encoder width, per-direction hidden
KERNEL_ROWS = (1, 16, 512)  # one request, the largest serving bucket, the training fold
SERVE_ROWS = 16  # the kernel row of the JSON line: the largest bucket the serving path runs
N_REQUESTS = 72
# f32: the kernel and cuBLAS sum the 430-term products in different orders;
# the difference (~1e-6 a step) compounds over 98 recurrent steps
F32_TOL = 1e-4
# bf16: products are exact in f32 in both, but a different summation order
# can flip the last bit of a bf16 stream value (2**-8 relative), and the
# bf16 h fed back carries that flip into later steps
BF16_TOL = 3e-2
# The bf16 cluster BPTT (K2, K4, K6) is also held to a share of each output's
# largest |value|, since BF16_TOL exceeds a typical dp (~1e-2) or dh carry
# (~2e-2) at the smoke's cotangents: a fault in the tensor-core product (a
# dropped k-tile, a missed n-tile, a rank left out of the reduce-scatter)
# would pass it. The kernel multiplies the same bf16 operands as the plain
# version and sums in f32, in another order: its dp differ by last-bit
# flips (a bf16 ulp is 2**-8 to 2**-7 of the value), its f32 dh0 and dc0 by
# less. 2 % is two ulps at the largest value. scripts/torch_bwd_mutants.py
# plants such faults in a copy of the kernel and shows that each fails it.
BWD_BF16_SHARE = 2e-2
SERVE_TOL = 1e-4
# a width whose W_hh slice fits no cluster of 8 in f32: K1's streaming route
STREAM_H = 400
BWD_ROWS = (16, 512)  # a serving-sized fold and the training fold (32 sites x 16)
TRAIN_SITES, TRAIN_BATCH, TRAIN_LR, TRAIN_EPOCHS = 32, 16, 1e-3, 2
# The training comparison (kernels vs their plain versions, f32, same
# inputs): the first round's aggregate gradient tightly, since the two
# differ only in summation order over 98 steps; the params after the
# epochs on the scale of lr, since an entry whose gradient is zero up to
# rounding (cls_fc1.bias: the BatchNorm after it removes any constant)
# takes Adam steps of about lr of either sign, up to 2·lr a round apart.
# The losses: the first round's is computed before any update and is
# compared tightly; later ones follow params that may part by lr-scale
# steps, which moved them by up to ~1e-4 on this card. Adam's moments after
# the epochs average gradients taken at those parted params, so they are
# compared at a share of the largest moment of the tree (a leaf whose
# gradient is rounding noise, as cls_fc1.bias, has no scale of its own).
AGG_TOL = dict(atol=1e-5, rtol=1e-3)
FIRST_LOSS_TOL, LOSS_TOL = 1e-5, 1e-3
MOMENT_SHARE = 5e-2
# rankDAD's Ω after the first round (each site's Q of its first gradient,
# from the same start on both paths), per leaf over the leaf's max |Ω|: the
# round's cold start makes five unconverged refinements, whose columns
# within near-equal singular values carry the kernel's f32 summation-order
# differences (K7's own phase: Q within 2.8e-5 of max|G|). After the epochs
# Ω follows params that part on the lr scale, and Q's columns within
# near-equal singular values then rotate freely (the encoder's Ω differed
# by 0.46 at a scale of 0.43 after 8 rounds on the card): checked there for
# shape and finiteness only. The first card run measured 2.6e-5.
OMEGA_FIRST_TOL = 2e-4
# powerSGD's q and each site's e after the first round, per leaf over the
# leaf's max |value|: the same sketch M q of the same start on both paths,
# whose M differ by the LSTM kernels' f32 summation order; set before the
# first card run at rankDAD's OMEGA_FIRST_TOL. After the epochs q and e
# follow params that part on the lr scale: checked for shape, finiteness,
# one q across the sites (every site live) and a residual of each site's own.
PSGD_FIRST_TOL = 2e-4
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores, bf16 tensor-core FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def ptxas_lines(log: str) -> list[str]:
    """``kernel: registers; spills`` for each kernel of an ``nvcc
    -Xptxas=-v`` log, the names demangled by ``c++filt`` where it exists."""
    entries, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            entries.append((name, line.split("Used", 1)[-1].split(",")[0].strip(), spill))
            name = None
    names = [e[0] for e in entries]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    return [f"{n}: {regs}; {sp}" for n, (_, regs, sp) in zip(names, entries)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after two warm runs."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(rows: int, bf16: bool, h: int = H) -> tuple[float, str]:
    """Least time for one serving-configuration call of width ``h`` (hs, hT,
    cT out): the larger of its bytes over HBM bandwidth and its product FLOP
    over the peak for the operand type."""
    es = 2 if bf16 else 4
    nbytes = (T * rows * D * es + 4 * D * h * es + 4 * h * 4 + 4 * h * h * es
              + 2 * rows * h * 4 + T * rows * h * es + 2 * rows * h * 4)
    flop = 2 * T * rows * (D + h) * 4 * h
    tb, to = nbytes / HBM_BPS, flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def scratch_ms(torch, rows: int, gates: int) -> float:
    """The cluster route's own cost beyond the function's bytes, measured:
    one read and one write of the f32 projection scratch [T, rows, gates·H]
    (4 gates for K1, 8 for K3/K5), timed as one device copy of it."""
    src = torch.zeros((T, rows, gates * H), device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), 30)


def check_proj_tiles(torch, what: str, proj, args, xp) -> None:
    """The f32 projection's two tilings (the C entry takes the 128x128 tiles
    once their grid fills the card, the 64x64 ones below: at the flagship
    the training fold and a serving bucket) sum in one order: the
    projection of the first 16 rows of ``x`` equals those rows of the
    whole, bit for bit."""
    part = proj(args[0][:, :16], *args[1:3])
    if not torch.equal(part, xp[:, :16]):
        fail(f"{what}: the projection of 16 rows differs from those rows of the whole by "
             f"{(part - xp[:, :16]).abs().max().item()}")


OUTPUTS = ("hs", "cs", "i", "f", "o", "g", "hT", "cT")


def compare(what: str, got, want, names, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; fails past ``tol`` (abs +
    rel), on a shape or dtype mismatch, or on a non-finite value."""
    err = 0.0
    for name, a, b in zip(names, got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what} {name}: {a.shape}/{a.dtype} vs plain {b.shape}/{b.dtype}")
        d = (a.float() - b.float()).abs()
        if not bool(a.float().isfinite().all()) or bool((d > tol + tol * b.float().abs()).any()):
            fail(f"{what} output {name}: max abs err {d.max().item()}")
        err = max(err, d.max().item())
    return err


def share_check(what: str, got, want, names, share: float) -> float:
    """The largest over the outputs of max |got - want| over max |want|;
    fails where one is more than ``share`` (after :func:`compare`, which
    checks shapes and finiteness)."""
    worst = 0.0
    for name, a, b in zip(names, got, want, strict=True):
        scale = b.float().abs().max().item()
        d = (a.float() - b.float()).abs().max().item()
        if d > share * scale:
            fail(f"{what} output {name}: max abs err {d} is more than {share} of its largest "
                 f"|value| {scale}")
        worst = max(worst, d / scale if scale else 0.0)
    return worst


def recurrence_args(torch, rows: int, g, h: int = H):
    """Inputs of one direction at rows ``rows`` (width ``h``), as the JAX
    kernel takes them."""
    dev = torch.device("cuda")

    def u(*shape, scale):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)

    x = torch.randn((T, rows, D), generator=g).relu().to(dev)  # encoder output is ReLU'd
    wih4 = u(4, D, h, scale=D ** -0.5)
    b4 = u(4, h, scale=2 * D ** -0.5)
    whh4 = u(4, h, h, scale=h ** -0.5)
    h0, c0 = u(rows, h, scale=0.5).contiguous(), u(rows, h, scale=0.5).contiguous()
    return x, wih4, b4, whh4, h0, c0


def geometry_line(torch, lc, rows: int, h: int, cdt, geometry=None) -> dict:
    """The launcher's geometry for ``rows`` rows of width ``h`` on this card,
    with cudaOccupancyMaxActiveClusters of its configuration."""
    g = dict(geometry or lc.device_geometry("cuda", rows, h, cdt))
    g["max_active_clusters"] = lc.k1_max_active_clusters("cuda", rows, h, cdt, g)
    return g


def kernel_phase(torch, lc) -> list[dict]:
    """K1 at the main path's shapes: every output against the plain version
    on both routes (the cluster route the launcher picks, and the streaming
    route, stage 1's recurrence), and the projection's xp against its plain
    version; times of K1 on each route, of the projection alone, of the
    plain version and of cuDNN, beside the bound."""
    g = torch.Generator().manual_seed(0)
    sms, optin = lc.device_limits("cuda")
    out = []
    for rows in KERNEL_ROWS:
        args = recurrence_args(torch, rows, g)
        stream = lc.k1_stream_geometry(rows, H, sms, optin)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            geo = geometry_line(torch, lc, rows, H, cdt)
            xp = lc.lstm_proj_fused(*args[:3], cdt)
            torch.cuda.synchronize()
            xp_err = compare(f"lstm_proj rows={rows} {cdt}", (xp,),
                             (lc.lstm_proj_plain(*args[:3], cdt),), ("xp",), F32_TOL)
            if cdt is None and rows > 16:
                check_proj_tiles(torch, f"lstm_proj rows={rows}", lc.lstm_proj_fused, args, xp)
            del xp
            want = lc.lstm_recurrence_plain(*args, cdt, residuals=True)
            got = lc.lstm_recurrence_fused(*args, cdt, residuals=True)
            torch.cuda.synchronize()
            err = compare(f"lstm_fwd rows={rows} {cdt} {geo['route']}", got, want, OUTPUTS, tol)
            got = lc.lstm_recurrence_fused(*args, cdt, residuals=True, geometry=stream)
            torch.cuda.synchronize()
            stream_err = compare(f"lstm_fwd rows={rows} {cdt} stream", got, want, OUTPUTS, tol)
            ms = time_ms(lambda: lc.lstm_recurrence_fused(*args, cdt), 30)
            stream_ms = time_ms(lambda: lc.lstm_recurrence_fused(*args, cdt, geometry=stream), 30)
            proj_ms = time_ms(lambda: lc.lstm_proj_fused(*args[:3], cdt), 30)
            plain_ms = time_ms(lambda: lc.lstm_recurrence_plain(*args, cdt), 20)
            library = library_lstm_ms(torch, args, want[0], cdt)
            b_ms, b_by = bound(rows, cdt is not None)
            phases = lc.k1_phase_profile(*args, cdt) if geo["route"] == "cluster" else None
            rec = {"rows": rows, "dtype": "bf16" if cdt else "f32", "max_abs_err": err,
                   "ms": ms, "route": geo["route"], "proj_ms": proj_ms, "proj_max_abs_err": xp_err,
                   "step_phases": phases,
                   "stream_ms": stream_ms, "stream_max_abs_err": stream_err,
                   "plain_ms": plain_ms, **library, "bound_ms": b_ms, "bound_by": b_by,
                   "scratch_ms": scratch_ms(torch, rows, 4), "geometry": geo,
                   "stream_geometry": stream}
            print(json.dumps(rec))
            out.append(rec)
    return out


def coverage_phase(torch, lc) -> None:
    """Untimed checks of what the timed shapes leave out: every geometry the
    launcher can pick (clusters of 2, 4 and 8, each row count a thread may
    carry, ragged slices and a ragged last cluster; the streaming route's
    1, 2, 4 and 8 rows a block, at an H whose W_hh fits no cluster), every
    output against the plain version; and the model-layout wrapper, whose
    strided views of x [B, T, D] and w [D, 4H] are what the serving path
    passes."""
    g = torch.Generator().manual_seed(3)
    sms, optin = lc.device_limits("cuda")
    bf = torch.bfloat16
    # (H, dtype, the cluster size the launcher should take, rows a cluster,
    # rows short of filling the last cluster of a full wave); None: the
    # streaming route, whose wave is one block an SM
    cases = [(H, None, 4, 1, 0), (H, None, 4, 2, 1), (H, None, 4, 3, 2), (H, None, 4, 4, 1),
             (H, None, 4, 12, 5), (H, None, 4, 17, 3), (H, bf, 2, 2, 1), (H, bf, 2, 8, 1),
             (128, None, 2, 1, 0), (256, None, 8, 7, 3), (256, None, 8, 32, 1)]
    cases += [(STREAM_H, None, None, R, 1) for R in (1, 2, 4, 8)]
    seen = set()
    for h, cdt, C, R, short in cases:
        wave = sms if C is None else lc.k1_max_active_clusters(
            "cuda", 1, h, cdt, lc.k1_cluster_geometry(1, h, C, R, cdt, optin))
        rows = max(1, R * wave - short)
        geo = geometry_line(torch, lc, rows, h, cdt)
        if geo["route"] != ("stream" if C is None else "cluster") or geo.get("C", C) != C \
                or geo["R"] != R:
            fail(f"K1 geometry for rows={rows} H={h} {cdt}: {geo}, expected C={C} R={R}")
        seen.add((geo["route"], geo.get("C"), geo.get("rpt", geo["R"])))
        x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g, h)
        args = (x, wih4, b4, whh4, h0, c0)
        tol = F32_TOL if cdt is None else BF16_TOL
        err = compare(f"lstm_fwd rows={rows} H={h} {cdt}", lc.lstm_recurrence_fused(
            *args, cdt, residuals=True), lc.lstm_recurrence_plain(*args, cdt, residuals=True),
            OUTPUTS, tol)
        print(json.dumps({"check": "K1 geometry", "rows": rows, "H": h,
                          "dtype": "bf16" if cdt else "f32", "max_abs_err": err, "geometry": geo}))
    need = {("cluster", C, None) for C in (2, 4, 8)} | {("cluster", None, r) for r in (1, 2, 4, 8)} \
        | {("stream", None, r) for r in (1, 2, 4, 8)}
    covered = {(a, C, None) for a, C, _ in seen} | {(a, None, r) for a, _, r in seen}
    if not need <= covered:
        fail(f"K1 coverage misses {sorted(map(str, need - covered))}")
    for rows in (1, 16):
        x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g)
        model = (x.transpose(0, 1).contiguous(), wih4.permute(1, 0, 2).reshape(D, 4 * H),
                 b4.reshape(4 * H), whh4.permute(1, 0, 2).reshape(H, 4 * H), h0, c0)
        for cdt in (None, torch.bfloat16):
            hs, (hT, cT) = lc.lstm_forward_fused(*model, cdt)
            ws, (wT, wc) = lc.lstm_forward_plain(*model, cdt)
            err = compare(f"lstm_forward_fused rows={rows} {cdt}", (hs, hT, cT), (ws, wT, wc),
                          ("hs", "hT", "cT"), F32_TOL if cdt is None else BF16_TOL)
            print(json.dumps({"check": "model layout", "rows": rows,
                              "dtype": "bf16" if cdt else "f32", "max_abs_err": err}))


BWD_OUTPUTS = ("dp_i", "dp_f", "dp_o", "dp_g", "dh0", "dc0")
BWD_DESIGN = ("a cluster BPTT (csrc/lstm_bwd_cluster.cuh): each block of a thread-block cluster "
              "holds the rows of W_hh^T of its own hidden units in shared memory for the whole "
              "sequence, computes their dp, and multiplies them by its slice into a partial "
              "dh of all H columns; after one cluster barrier a step, each block adds its own "
              "units' slice of every rank's partials through distributed shared memory "
              "(a reduce-scatter). f32 on a SIMT register tile, bf16 on mma.sync; the first "
              "design's stream route for a W_hh^T that fits no cluster of 8")


def bwd_bound(rows: int, bf16: bool) -> tuple[float, str]:
    """Least time for one backward call: bytes of the streams read (i, f, o,
    g, c, dhs) and written (the four dp) at the stream dtype, W_hhᵀ, and the
    f32 c0, dhT, dcT, dh0, dc0; product FLOP ``2·T·rows·4H·H`` over the peak
    for the operand type."""
    es = 2 if bf16 else 4
    nbytes = (6 + 4) * T * rows * H * es + 4 * H * H * es + 5 * rows * H * 4
    flop = 2 * T * rows * 4 * H * H
    tb, to = nbytes / HBM_BPS, flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def bwd_args(torch, lc, rows: int, cdt, g, h: int = H):
    """Inputs of one direction's backward at rows ``rows`` (width ``h``):
    the residual streams of the plain forward, random cotangents."""
    x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g, h)
    _, cs, i, f, o, gg, _, _ = lc.lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, cdt,
                                                       residuals=True)
    sdt = torch.bfloat16 if cdt is not None else torch.float32

    def cot(*shape):
        return (0.05 * torch.randn(shape, generator=g)).cuda()

    return i, f, o, gg, cs, whh4, c0, cot(T, rows, h).to(sdt), cot(rows, h), cot(rows, h)


def bwd_share(what: str, route: str, cdt, got, want, names) -> float | None:
    """:func:`share_check` at :data:`BWD_BF16_SHARE` of a bf16 call on the
    cluster route; None for any other."""
    if cdt is None or route != "cluster":
        return None
    return share_check(f"{what} cluster", got, want, names, BWD_BF16_SHARE)


def split_bwd(out):
    dp, dh0, dc0 = out
    h = dh0.shape[-1]
    return [dp[..., k * h:(k + 1) * h] for k in range(4)] + [dh0, dc0]


def bwd_geometry_line(kernel: str, rows: int, h: int, cdt, geometry=None) -> dict:
    """The launcher geometry of K2 (``kernel`` "lstm_bwd"), K4
    ("bilstm_bwd") or K6 ("bilstm_pool_bwd") for ``rows`` rows of width
    ``h`` on this card, with cudaOccupancyMaxActiveClusters of that
    kernel's configuration."""
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    pick, occupancy = {
        "lstm_bwd": (lc.device_bwd_geometry, lc.bwd_max_active_clusters),
        "bilstm_bwd": (bc.device_k4_geometry, bc.k4_max_active_clusters),
        "bilstm_pool_bwd": (bc.device_bidir_bwd_geometry, bc.bidir_bwd_max_active_clusters),
    }[kernel]
    g = dict(geometry or pick("cuda", rows, h, cdt))
    g["max_active_clusters"] = occupancy("cuda", rows, h, cdt, g)
    return g


def bwd_phase(torch, lc) -> list[dict]:
    """K2 at the main path's shapes: every output against the plain version
    on the cluster route the launcher picks and on the stream route (the
    first design); times of both, of the plain version and of cuDNN's
    backward beside the bound, the geometry and the phase clock. Then,
    untimed, every geometry the cluster route can take and the stream
    route's rows-a-block templates (:func:`bwd_coverage_phase`)."""
    g = torch.Generator().manual_seed(5)
    sms = lc.device_limits("cuda")[0]
    out = []
    for rows in BWD_ROWS:
        stream = lc.bwd_stream_geometry(rows, H, sms)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            args = bwd_args(torch, lc, rows, cdt, g)
            geo = bwd_geometry_line("lstm_bwd", rows, H, cdt)
            want = split_bwd(lc.lstm_bwd_plain(*args, cdt))
            got = lc.lstm_bwd_fused(*args, cdt)
            torch.cuda.synchronize()
            err = compare(f"lstm_bwd rows={rows} {cdt} {geo['route']}", split_bwd(got), want,
                          BWD_OUTPUTS, tol)
            share = bwd_share(f"lstm_bwd rows={rows} {cdt}", geo["route"], cdt, split_bwd(got),
                              want, BWD_OUTPUTS)
            got = lc.lstm_bwd_fused(*args, cdt, geometry=stream)
            torch.cuda.synchronize()
            stream_err = compare(f"lstm_bwd rows={rows} {cdt} stream", split_bwd(got), want,
                                 BWD_OUTPUTS, tol)
            del got
            ms = time_ms(lambda: lc.lstm_bwd_fused(*args, cdt), 30)
            plain_ms = time_ms(lambda: lc.lstm_bwd_plain(*args, cdt), 10)
            library = library_lstm_bwd_ms(torch, rows, g, cdt)
            b_ms, b_by = bwd_bound(rows, cdt is not None)
            rec = {"kernel": "lstm_bwd", "rows": rows, "dtype": "bf16" if cdt else "f32",
                   "max_abs_err": err, "bf16_max_share": share, "ms": ms, "route": geo["route"],
                   "stream_ms": time_ms(lambda: lc.lstm_bwd_fused(*args, cdt, geometry=stream), 30),
                   "stream_max_abs_err": stream_err,
                   "step_phases": lc.bwd_phase_profile(*args, cdt)
                   if geo["route"] == "cluster" else None,
                   "plain_ms": plain_ms, **library,
                   "library": "cuDNN LSTM backward, also dx and dW", "bound_ms": b_ms,
                   "bound_by": b_by, "geometry": geo, "stream_geometry": stream}
            print(json.dumps(rec))
            out.append(rec)
    bwd_coverage_phase(torch, "lstm_bwd", g)
    return out


# The cluster BPTT's geometries checked untimed, K2, K4 and K6 alike: (H, dtype,
# cluster size, rows a cluster). f32 (the SIMT kernel): 1, 2, 4 and 8 rows a
# thread (R 1, 2, 18, 8), several row groups (3, 13, 18, 35), clusters of 2, 4, 8,
# ragged slices (174 = 44 + 44 + 43 + 43) and an odd H (the padded column);
# bf16 (the tensor cores): 1, 2, 3 m-tiles, clusters of 2, 4, 8, an odd H.
BWD_COVERAGE = [(H, None, 4, 1), (H, None, 4, 2), (H, None, 4, 3), (H, None, 4, 8),
                (H, None, 4, 13), (H, None, 4, 18), (H, None, 4, 35), (128, None, 2, 5),
                (256, None, 8, 7), (175, None, 4, 6), (H, "bf16", 2, 1), (H, "bf16", 2, 20),
                (H, "bf16", 4, 40), (256, "bf16", 8, 10), (175, "bf16", 2, 17)]


def bwd_coverage_phase(torch, kernel: str, g) -> None:
    """Untimed: K2 (``kernel`` "lstm_bwd"), K4 ("bilstm_bwd", full
    cotangent streams) or K6 ("bilstm_pool_bwd") on every geometry of
    :data:`BWD_COVERAGE`, three clusters a direction with a ragged last one,
    every output against the plain version; then the stream route at H =
    400, whose W_hhᵀ slice fits no cluster of 8 in f32, at each of its rows
    a block (1, 2, 4, 8) as the launcher picks it, and in bf16 by request
    (bf16's slice fits a cluster of 8)."""
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    dirs = 1 if kernel == "lstm_bwd" else 2
    sms, optin = lc.device_limits("cuda")
    bf = torch.bfloat16

    def check(rows, h, cdt, geometry, what):
        if kernel == "lstm_bwd":
            args = bwd_args(torch, lc, rows, cdt, g, h)
            want = split_bwd(lc.lstm_bwd_plain(*args, cdt))
            got = split_bwd(lc.lstm_bwd_fused(*args, cdt, geometry=geometry))
        elif kernel == "bilstm_bwd":
            args = bidir_bwd_args(torch, bc, bidir_args(torch, rows, g, h), cdt, g, const=False)
            want = bc.bilstm_bwd_plain(*args, cdt)
            got = bc.bilstm_bwd_fused(*args, cdt, geometry=geometry)
        else:
            args = pool_bwd_args(torch, bc, rows, cdt, g, h)
            want = bc.bilstm_bwd_plain(*pool_plain_args(args), cdt)
            got = bc.bilstm_pool_bwd_fused(*args, cdt, geometry=geometry)
        names = BWD_OUTPUTS if kernel == "lstm_bwd" else BIDIR_BWD_OUTPUTS
        err = compare(f"{kernel} {what} rows={rows} H={h} {cdt}", got, want, names,
                      F32_TOL if cdt is None else BF16_TOL)
        share = bwd_share(f"{kernel} {what} rows={rows} H={h} {cdt}", (geometry or {}).get("route"),
                          cdt, got, want, names)
        print(json.dumps({"check": f"{kernel} {what}", "rows": rows, "H": h,
                          "dtype": "bf16" if cdt else "f32", "max_abs_err": err,
                          "bf16_max_share": share, "geometry": geometry}))

    seen = set()
    for h, dt, C, R in BWD_COVERAGE:
        cdt = bf if dt else None
        rows = 3 * R - (1 if R > 1 else 0)
        geo = lc.bwd_cluster_geometry(rows, h, C, R, cdt, optin, dirs=dirs)
        if geo is None:
            fail(f"{kernel} coverage: no cluster geometry for H={h} {dt} C={C} R={R}")
        seen |= {(dt, "C", C), (dt, "rows a thread", geo["rpt"]), (dt, "tiles", geo["row_groups"])}
        check(rows, h, cdt, geo, "cluster geometry")
    for R in (1, 2, 4, 8):
        rows = R * (sms // dirs) - 1
        geo = bwd_geometry_line(kernel, rows, STREAM_H, None)
        if geo["route"] != "stream" or geo["R"] != R:
            fail(f"{kernel} geometry for rows={rows} H={STREAM_H}: {geo}, expected the stream "
                 f"route at R={R}")
        seen.add(("stream", R))
        check(rows, STREAM_H, None, None, "stream route")
    check(2 * (sms // dirs) - 1, STREAM_H, bf, lc.bwd_stream_geometry(
        2 * (sms // dirs) - 1, STREAM_H, sms, dirs), "stream route by request")
    need = ({(None, "C", C) for C in (2, 4, 8)} | {(None, "rows a thread", r) for r in (1, 2, 4, 8)}
            | {("bf16", "C", C) for C in (2, 4, 8)} | {("bf16", "tiles", n) for n in (1, 2, 3)}
            | {("stream", r) for r in (1, 2, 4, 8)} | {(None, "tiles", 5)})
    if not need <= seen:
        fail(f"{kernel} coverage misses {sorted(map(str, need - seen))}")


def cudnn_lstm(torch, wih, b, whh, cdt=None):
    """A cuDNN ``torch.nn.LSTM`` holding the port's weights, its gate blocks
    reordered from the port's i, f, o, g to torch's i, f, g, o, at the
    compute dtype. ``wih [4, D, H]`` for one direction, ``[2, 4, D, H]``
    (forward, reverse) for a bidirectional LSTM."""
    order = (0, 1, 3, 2)
    bidir = wih.dim() == 4
    lstm = torch.nn.LSTM(D, wih.shape[-1], bidirectional=bidir).to(wih.device)
    with torch.no_grad():
        for d, suffix in ((0, ""), (1, "_reverse"))[:2 if bidir else 1]:
            wi, bi, wh = (w[d] if bidir else w for w in (wih, b, whh))
            getattr(lstm, "weight_ih_l0" + suffix).copy_(torch.cat([wi[k].T for k in order]))
            getattr(lstm, "weight_hh_l0" + suffix).copy_(torch.cat([wh[k].T for k in order]))
            getattr(lstm, "bias_ih_l0" + suffix).copy_(torch.cat([bi[k] for k in order]))
            getattr(lstm, "bias_hh_l0" + suffix).zero_()
    lstm = lstm.to(cdt or torch.float32)
    lstm.flatten_parameters()  # one weight buffer, as cuDNN wants it
    return lstm


def library_call(torch, what: str, cdt, build, check_tol: float):
    """``{"library_ms": ..., "library_max_abs_err": ...}`` of a cuDNN
    yardstick: ``build()`` returns ``(fn, got, want)``, the call to time and
    its output beside the plain version's (``want`` None: nothing to hold
    it against, as for a backward that computes more than the kernel). In
    f32 the yardstick must agree with the plain version within
    ``check_tol`` (so it computes the same function); in bf16 cuDNN rounds
    at its own points, so its error is reported, and if cuDNN refuses bf16
    its error message stands in for the time."""
    try:
        fn, got, want = build()
        err = None if want is None else (got.float() - want.float()).abs().max().item()
    except RuntimeError as e:
        if cdt is None:
            raise
        return {"library_ms": None, "library_error": f"{what}: {e}".splitlines()[0][:300]}
    if cdt is None and err is not None and err > check_tol:
        fail(f"{what} yardstick disagrees with the plain version: {err}")
    return {"library_ms": time_ms(fn, 30), "library_max_abs_err": err}


def no_grad_call(torch, fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def library_lstm_bwd_ms(torch, rows: int, g, cdt=None) -> dict:
    """The backward of one cuDNN LSTM call at the same shape: it computes
    the recurrence's cotangents and also dx and dW, so it does more than
    the kernel alone."""
    x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g)
    dt = cdt or torch.float32

    def build():
        lstm = cudnn_lstm(torch, wih4, b4, whh4, cdt)
        xx = x.to(dt).requires_grad_()
        hs, _ = lstm(xx, (h0[None].to(dt), c0[None].to(dt)))
        dhs = (0.05 * torch.randn(hs.shape, generator=g)).to(hs)
        inputs = [xx] + list(lstm.parameters())
        return (lambda: torch.autograd.grad(hs, inputs, dhs, retain_graph=True)), hs, None
    return library_call(torch, "cuDNN LSTM backward", cdt, build, 0.0)


def library_lstm_ms(torch, args, hs_plain, cdt=None) -> dict:
    """cuDNN ``torch.nn.LSTM`` on the same data, its gate blocks reordered
    from the port's i, f, o, g to torch's i, f, g, o. Checked against the
    plain version first, so the yardstick computes the same function."""
    x, wih4, b4, whh4, h0, c0 = args
    dt = cdt or torch.float32

    def build():
        lstm = cudnn_lstm(torch, wih4, b4, whh4, cdt)
        xx, hc = x.to(dt), (h0[None].to(dt), c0[None].to(dt))
        fn = no_grad_call(torch, lambda: lstm(xx, hc))
        return fn, fn()[0], hs_plain
    return library_call(torch, "cuDNN LSTM", cdt, build, F32_TOL)


def serving_phase(torch, np, lc):
    from dinunet_implementations_tpu_torch import ICALstm, InferenceEngine
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_model
    from dinunet_implementations_tpu_torch.trainer.steps import FederatedTask, eval_forward

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)  # default ICAArgs: full width
    a = cfg.ica_args
    model = build_model(cfg)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial head BatchNorm state
        bn = model.cls_bn
        bn.running_mean.copy_(0.2 * torch.randn(256, generator=g))
        bn.running_var.copy_(0.5 + 1.5 * torch.rand(256, generator=g))
        bn.weight.copy_(1 + 0.2 * torch.randn(256, generator=g))
        bn.bias.copy_(0.1 * torch.randn(256, generator=g))
    sd = model.state_dict()
    ref = ICALstm(input_size=a.input_size, hidden_size=a.hidden_size, bidirectional=a.bidirectional,
                  num_cls=a.num_class, num_comps=a.num_components, window_size=a.window_size,
                  use_kernel=False)
    ref.load_state_dict(sd)
    ref_task = FederatedTask(ref.to("cuda").eval())

    rng = np.random.default_rng(2)
    sizes = rng.integers(1, 17, N_REQUESTS)
    windows = a.temporal_size // a.window_size
    reqs = [rng.standard_normal((int(n), windows, a.num_components, a.window_size)).astype(np.float32)
            for n in sizes]
    answers = [None] * N_REQUESTS
    with InferenceEngine(cfg, state_dict=sd) as eng:
        warm = eng.warmup()
        print("warmup seconds by bucket:", json.dumps(warm))

        def client(ix):
            futs = [(i, eng.submit(reqs[i])) for i in ix]
            for i, f in futs:
                answers[i] = f.result(timeout=120)

        lc.LAUNCHES = lc.PROJ_LAUNCHES = lc.K1_CLUSTER_CALLS = lc.K1_STREAM_CALLS = 0
        # the main path's run starts here
        threads = [threading.Thread(target=client, args=(range(k, N_REQUESTS, 2),))
                   for k in (0, 1)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
    launches = lc.LAUNCHES  # read just after the run, before any reference work
    routes = {"lstm_proj": lc.PROJ_LAUNCHES, "k1_cluster_route": lc.K1_CLUSTER_CALLS,
              "k1_stream_route": lc.K1_STREAM_CALLS}
    if any(t.is_alive() for t in threads) or any(x is None for x in answers):
        fail("not every request was answered")
    summary = eng.summary()
    if summary["requests"] != N_REQUESTS or launches != 2 * summary["dispatches"] or launches == 0:
        fail(f"launches {launches} vs dispatches {summary['dispatches']}: {summary}")
    if routes != {"lstm_proj": launches, "k1_cluster_route": launches, "k1_stream_route": 0}:
        fail(f"serving K1 routes {routes} for {launches} K1 calls")
    err = 0.0
    for x, got in zip(reqs, answers):
        want = eval_forward(ref_task, torch.from_numpy(x).cuda()).cpu().numpy()
        if got.shape != (len(x), a.num_class) or not np.isfinite(got).all():
            fail(f"answer shaped {got.shape} or not finite")
        err = max(err, float(np.abs(got - want).max()))
    if err > SERVE_TOL:
        fail(f"served probabilities differ from the plain path by {err}")
    summary.update(wall_s=wall, lstm_launches=launches, k1_routes=routes, max_abs_err_vs_plain=err)
    print("serving:", json.dumps(summary))
    return launches


def fused_twin(model, cfg, use_kernel: bool):
    """``ICALstm(fused_bidir=True)`` of ``cfg``'s widths holding ``model``'s
    weights, on its device: the fused bidirectional arm, built as a caller
    builds it (the registry builds the per-direction default)."""
    from dinunet_implementations_tpu_torch.models.icalstm import ICALstm

    a = cfg.ica_args
    twin = ICALstm(input_size=a.input_size, hidden_size=a.hidden_size,
                   bidirectional=a.bidirectional, num_cls=a.num_class, num_comps=a.num_components,
                   window_size=a.window_size, compute_dtype=a.compute_dtype or None,
                   use_kernel=use_kernel, fused_bidir=True)
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device)


def training_setup(torch, use_kernel: bool, seed: int = 0, engine: str = "dSGD",
                   fused_bidir: bool = False, bf16: bool = False):
    """The full-width ICA-LSTM training configuration (default ``ICAArgs``,
    f32 or with ``bf16`` the bf16 compute dtype, the ``engine``
    aggregation: dSGD; rankDAD with its default knobs, rank 10, 5
    refinements, tol 1e-3, warm starts; or powerSGD at rank 10; with
    ``fused_bidir`` the fused bidirectional arm), its epoch function and
    first state, dropout 0 so that the kernel and plain paths compute the
    same function."""
    import dataclasses

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        FederatedTask,
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=seed, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine)
    if bf16:
        cfg = dataclasses.replace(
            cfg, ica_args=dataclasses.replace(cfg.ica_args, compute_dtype="bfloat16"))
    task, engine, opt = build_training(cfg, use_kernel=use_kernel)
    if fused_bidir:
        task = FederatedTask(fused_twin(task.model, cfg, use_kernel))
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, engine, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds)
    return cfg, epoch, init_train_state(task, engine, opt, rng=seed, num_sites=cfg.num_sites)


def training_data(np, cfg, seed: int = 4):
    """Sites of unequal size (2 to 4 batches each) with random timecourses
    and labels, stacked into the resident inventory, and one index plan
    per epoch."""
    from dinunet_implementations_tpu_torch.data import (
        SiteArrays,
        plan_epoch_positions,
        stack_site_inventory,
    )

    a = cfg.ica_args
    shape = (a.temporal_size // a.window_size, a.num_components, a.window_size)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2 * cfg.batch_size, 4 * cfg.batch_size + 1, cfg.num_sites)
    sites = [SiteArrays(rng.standard_normal((n,) + shape, dtype=np.float32),
                        rng.integers(0, a.num_class, n).astype(np.int32),
                        np.arange(n, dtype=np.int32)) for n in sizes]
    plans = [plan_epoch_positions(sites, cfg.batch_size, seed=e).positions
             for e in range(TRAIN_EPOCHS)]
    return stack_site_inventory(sites), plans


def tree_err(got: dict, want: dict, atol: float = 0.0, rtol: float = 0.0,
             share: float = 0.0) -> tuple[float, bool]:
    """Max abs error over a dict of tensors, and whether every entry is
    finite and within ``atol + rtol·|want| + share·max|want|`` (the last
    over the whole dict)."""
    top = max(w.float().abs().max().item() for w in want.values())
    err, ok = 0.0, True
    for k, w in want.items():
        a, b = got[k].float(), w.float()
        d = (a - b).abs()
        ok &= bool(a.isfinite().all()) and not bool((d > atol + rtol * b.abs() + share * top).any())
        err = max(err, d.max().item())
    return err, ok


def leaf_errs(got: dict, want: dict) -> dict:
    """Per leaf: [max abs error, max abs value]."""
    return {k: [(got[k] - w).abs().max().item(), w.abs().max().item()] for k, w in want.items()}


def zero_counters(lc, pc, bc) -> None:
    from dinunet_implementations_tpu_torch.engines import lowrank

    lc.LAUNCHES = lc.BWD_LAUNCHES = pc.POWERITER_LAUNCHES = 0
    pc.POWERITER_STAGED_CALLS = pc.POWERITER_DIRECT_CALLS = 0
    lc.PROJ_LAUNCHES = lc.K1_CLUSTER_CALLS = lc.K1_STREAM_CALLS = 0
    lc.BWD_CLUSTER_CALLS = lc.BWD_STREAM_CALLS = 0
    lowrank.POWERITER_PLAIN_CLASSES = 0
    bc.BIDIR_FWD_LAUNCHES = bc.BIDIR_BWD_LAUNCHES = 0
    bc.POOL_FWD_LAUNCHES = bc.POOL_BWD_LAUNCHES = 0
    bc.BIDIR_PROJ_LAUNCHES = bc.BIDIR_CLUSTER_CALLS = bc.BIDIR_STREAM_CALLS = 0
    bc.BIDIR_BWD_CLUSTER_CALLS = bc.BIDIR_BWD_STREAM_CALLS = 0
    bc.K4_CLUSTER_CALLS = bc.K4_STREAM_CALLS = 0


def read_counters(lc, pc, bc) -> dict:
    """Kernel launches, and the static routes: K1's and K3/K5's recurrences
    and K2's, K4's and K6's BPTT over a cluster or streamed, K7 staged or direct,
    rank classes sent to the plain power iteration."""
    from dinunet_implementations_tpu_torch.engines import lowrank

    return {"lstm_fwd": lc.LAUNCHES, "lstm_proj": lc.PROJ_LAUNCHES,
            "k1_cluster_route": lc.K1_CLUSTER_CALLS, "k1_stream_route": lc.K1_STREAM_CALLS,
            "lstm_bwd": lc.BWD_LAUNCHES, "k2_cluster_route": lc.BWD_CLUSTER_CALLS,
            "k2_stream_route": lc.BWD_STREAM_CALLS, "poweriter": pc.POWERITER_LAUNCHES,
            "k7_staged_route": pc.POWERITER_STAGED_CALLS,
            "k7_direct_route": pc.POWERITER_DIRECT_CALLS,
            "poweriter_plain_classes": lowrank.POWERITER_PLAIN_CLASSES,
            "bilstm_fwd": bc.BIDIR_FWD_LAUNCHES, "bilstm_bwd": bc.BIDIR_BWD_LAUNCHES,
            "bilstm_pool_fwd": bc.POOL_FWD_LAUNCHES, "bilstm_pool_bwd": bc.POOL_BWD_LAUNCHES,
            "bilstm_proj": bc.BIDIR_PROJ_LAUNCHES, "bidir_cluster_route": bc.BIDIR_CLUSTER_CALLS,
            "bidir_stream_route": bc.BIDIR_STREAM_CALLS,
            "k4_cluster_route": bc.K4_CLUSTER_CALLS, "k4_stream_route": bc.K4_STREAM_CALLS,
            "k6_cluster_route": bc.BIDIR_BWD_CLUSTER_CALLS,
            "k6_stream_route": bc.BIDIR_BWD_STREAM_CALLS}


def training_phase(torch, np, lc, pc, bc, engine: str = "dSGD", fused_bidir: bool = False) -> dict:
    cfg, epoch_k, state_k = training_setup(torch, use_kernel=True, engine=engine,
                                           fused_bidir=fused_bidir)
    _, epoch_p, state_p = training_setup(torch, use_kernel=False, engine=engine,
                                         fused_bidir=fused_bidir)
    rankdad, psgd = engine == "rankDAD", engine == "powerSGD"
    classes = len(k7_leaves(torch)) if rankdad else 0
    if any(not torch.equal(v, state_p.params[k]) for k, v in state_k.params.items()):
        fail("the kernel and plain training paths start from different weights")
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q).cuda() for q in plans]
    L = cfg.local_iterations
    rounds = [q.shape[1] // L for q in plans]
    samples = [cfg.num_sites * q.shape[1] * cfg.batch_size for q in plans]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counters(lc, pc, bc)  # the main path's run starts here
    st, ms, losses_k = state_k, [], []
    for e in range(TRAIN_EPOCHS):
        t0 = time.perf_counter()
        st, lo = epoch_k(st, inv_x, inv_y, idx[e])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses_k.append(lo)
    launches = read_counters(lc, pc, bc)  # read before any check
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the first round's aggregate gradient: mu / (1 - b1) after one Adam step
    one_k, _ = epoch_k(state_k, inv_x, inv_y, idx[0][:, :L])
    one_p, _ = epoch_p(state_p, inv_x, inv_y, idx[0][:, :L])
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    sp, losses_p = state_p, []
    for e in range(TRAIN_EPOCHS):
        sp, lo = epoch_p(sp, inv_x, inv_y, idx[e])
        losses_p.append(lo)
    lk, lp = torch.cat(losses_k), torch.cat(losses_p)
    dl = (lk - lp).abs()
    param_atol = 2 * TRAIN_LR * sum(rounds)
    checks = {
        "first_round_aggregate": tree_err(agg(one_k), agg(one_p), **AGG_TOL),
        "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
        "loss": (dl.max().item(), bool(lk.isfinite().all()) and dl.max().item() <= LOSS_TOL),
        "params": tree_err(st.params, sp.params, param_atol, 0.0),
        "batch_stats": tree_err(st.batch_stats, sp.batch_stats, param_atol, 0.0),
        "adam_mu": tree_err(st.opt_state["mu"], sp.opt_state["mu"], share=MOMENT_SHARE),
        "adam_nu": tree_err(st.opt_state["nu"], sp.opt_state["nu"], share=MOMENT_SHARE),
    }
    omega = lambda s: {k: v for k, v in s.engine_state.get("omega", {}).items()  # noqa: E731
                       if v is not None}
    if rankdad:
        first = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                 for g, w in zip(omega(one_k).values(), omega(one_p).values(), strict=True)]
        checks["first_round_omega"] = (max(first), max(first) <= OMEGA_FIRST_TOL)
        end_ok = all(bool(v.isfinite().all()) and v.shape == w.shape
                     for v, w in zip(omega(st).values(), omega(sp).values(), strict=True))
        checks["omega_end_finite"] = (0.0, end_ok and len(omega(st)) == len(omega(sp)) > 0)
    qe = lambda s, key: {k: v for k, v in s.engine_state.get(key, {}).items()  # noqa: E731
                         if v is not None}
    if psgd:
        for key in ("q", "e"):
            first = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                     for g, w in zip(qe(one_k, key).values(), qe(one_p, key).values(),
                                     strict=True)]
            checks[f"first_round_{key}"] = (max(first), max(first) <= PSGD_FIRST_TOL)
        q_end, e_end = qe(st, "q"), qe(st, "e")
        end_ok = len(q_end) == len(qe(sp, "q")) == len(e_end) > 0 and all(
            bool(v.isfinite().all()) and v.shape == w.shape
            for key in ("q", "e") for v, w in zip(qe(st, key).values(), qe(sp, key).values(),
                                                  strict=True))
        checks["q_e_end_finite"] = (0.0, end_ok)
        # every site live: one q across the sites; each site's residual its own
        checks["q_rows_equal"] = (0.0, all(bool((v == v[:1]).all()) for v in q_end.values()))
        checks["e_per_site"] = (0.0, all(bool((v[0] != v[1]).any()) for v in e_end.values()))
    rec = {
        "sites": cfg.num_sites, "batch": cfg.batch_size, "local_iterations": L,
        "rounds_per_epoch": rounds, "samples_per_epoch": samples, "epoch_ms": ms,
        "samples_per_s": samples[-1] / (ms[-1] / 1e3), "ms_per_round": ms[-1] / rounds[-1],
        "launches": launches, "peak_memory_gb": peak_gb, "losses": lk.tolist(),
        "plain_losses": lp.tolist(), "param_atol": param_atol,
        "max_abs_err_vs_plain": {k: e for k, (e, _) in checks.items()},
        "leaf_err_and_scale": {m: leaf_errs(st.opt_state[m], sp.opt_state[m]) for m in ("mu", "nu")}
        | {"params": leaf_errs(st.params, sp.params),
           "first_round_omega": leaf_errs(omega(one_k), omega(one_p)),
           "omega": leaf_errs(omega(st), omega(sp)),
           "first_round_q": leaf_errs(qe(one_k, "q"), qe(one_p, "q")),
           "first_round_e": leaf_errs(qe(one_k, "e"), qe(one_p, "e"))},
        "engine": engine, "rank_classes": classes, "fused_bidir": fused_bidir,
    }
    print(f"training {engine}{' fused_bidir' if fused_bidir else ''}:", json.dumps(rec))
    want = dict.fromkeys(launches, 0)
    if fused_bidir:  # one K5 and one K6 per micro-batch, both on the cluster route
        n = sum(rounds) * L
        want.update(bilstm_pool_fwd=n, bilstm_proj=n, bidir_cluster_route=n, bilstm_pool_bwd=n,
                    k6_cluster_route=n)
    else:  # one K1 and one K2 per direction and micro-batch, both on the cluster route
        n = 2 * sum(rounds) * L
        want.update(lstm_fwd=n, lstm_proj=n, k1_cluster_route=n, lstm_bwd=n, k2_cluster_route=n)
    # one K7 a rank class and round, all on the staged route
    want["poweriter"] = want["k7_staged_route"] = classes * sum(rounds)
    if launches != want:
        fail(f"training {engine} launches {launches}, want {want}")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"training {engine} differs from the plain path in {bad}")
    if lk.shape != (sum(rounds),):
        fail(f"training losses shaped {tuple(lk.shape)}")
    if int(st.opt_state["count"]) != sum(rounds) or st.round != sum(rounds):
        fail(f"training count {int(st.opt_state['count'])}, round {st.round}")
    return rec


# K7: one round of rankDAD's power iteration at the flagship shapes. The
# per-site gradients are made of 16 decaying directions plus a floor of
# noise (a per-site batch of 16 bounds the rank of most leaves); site 0 is
# a dead site (G = 0) and site 1 has rank 2, below r = 10.
K7_RANK, K7_ITERS = 10, 5
K7_SIGNAL, K7_DECAY, K7_NOISE = 16, 0.7, 1e-3
# Kernel against plain (P absolute; Q and PQᵀ over the member's max|G|),
# set from the first card run (f32: P 2.6e-5, Q 2.8e-5, PQᵀ 4.3e-6; bf16:
# 3.1e-4, 2.1e-3, 3.7e-4). f32: the two sum 256-1000-term products in other
# orders, and five unconverged refinements from a cold Ω carry the
# difference into the subspace. bf16: an f32 value one ulp apart can round
# to the neighbouring bf16 operand (2**-9 relative). A site of rank 2 < r:
# its other columns are rounding noise, so only PQᵀ is compared, at the
# noise's scale (JAX's own two paths differ by 2.3e-4 there on the CPU).
K7_TOL = {"f32": {"P": 1e-4, "Q": 1e-4, "PQ": 2e-5, "PQ_rank_below_r": 1e-3},
          "bf16": {"P": 1e-3, "Q": 5e-3, "PQ": 1e-3, "PQ_rank_below_r": 5e-3}}
# Trip counts are compared at tol 1e-3: a member whose σ change lands within
# rounding of the threshold can stop one refinement apart (2 of 224 in the
# first run), which moves its factors by far less than the tolerances above.
# At tol 0 a member stops only when its σ change is exactly 0, which
# depends on the last bit of a sum, so trips are not compared there.
K7_TRIPS_DIFFER_SHARE = 0.02


def k7_leaves(torch, cfg=None):
    """``(name, m, n, transposed)`` of every compressible leaf of the
    full-width model of ``cfg`` (default: the ICA-LSTM), in the JAX matrix
    orientation, and their rank classes ``{r: [leaf, ...]}``."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.engines.lowrank import _matrix_shape, is_compressible
    from dinunet_implementations_tpu_torch.runner.registry import get_task
    from dinunet_implementations_tpu_torch.weights import leaf_table

    cfg = cfg or TrainConfig(task_id=NNComputation.TASK_ICA)
    model = get_task(cfg.task_id).build_model(cfg, torch.Generator().manual_seed(0))
    tr = leaf_table(cfg).transposed
    classes: dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)[::-1] if name in tr else tuple(p.shape)
        if is_compressible(shape):
            m, n = _matrix_shape(shape)
            classes.setdefault(min(K7_RANK, m, n), []).append((name, m, n, name in tr))
    return dict(sorted(classes.items()))


def k7_gradients(torch, leaves, gen, sites: int = TRAIN_SITES, pad: int = 0):
    """Per leaf, the ``[S, m, n]`` matrix view the engine hands the kernel:
    a transposed view of ``[S, n, m]`` storage for an ``nn.Linear`` weight.
    ``pad`` extra values a storage row leave G's contiguous axis a view of a
    wider row (a row pitch that is not G's width)."""
    S, dev = sites, torch.device("cuda")
    out = []
    for _, m, n, tr in leaves:
        k = min(K7_SIGNAL, m, n)
        d = K7_DECAY ** torch.arange(k, device=dev, dtype=torch.float32)
        A = torch.randn((S, m, k), generator=gen, device=dev)
        B = torch.randn((S, k, n), generator=gen, device=dev)
        G = (A * d) @ B / k ** 0.5 + K7_NOISE * torch.randn((S, m, n), generator=gen, device=dev)
        G[0] = 0.0
        G[1] = (A[1, :, :2] @ B[1, :2]) / k ** 0.5
        if tr:
            store = torch.zeros((S, n, m + pad), device=dev)
            store[..., :m] = G.transpose(1, 2)
            out.append(store[..., :m].transpose(1, 2))
        else:
            store = torch.zeros((S, m, n + pad), device=dev)
            store[..., :n] = G
            out.append(store[..., :n])
    return out


def k7_starts(torch, pc, leaves, Gs, r: int, gen):
    """Cold Ω (the per-shape default draw, one for every site) and warm Ω
    (the Q of a factorization of the last round's, perturbed, G)."""
    from dinunet_implementations_tpu_torch.engines.lowrank import default_omega

    cold = [default_omega((m, n), r, "cuda").expand(G.shape[0], n, r)
            for (_, m, n, _), G in zip(leaves, Gs)]
    prev = [G + 0.05 * G.abs().amax((1, 2), keepdim=True)
            * torch.randn(G.shape, generator=gen, device="cuda") for G in Gs]
    return cold, pc.poweriter_plain(prev, cold, K7_ITERS, 1e-3)[1]


def k7_bound(Gs, r: int, trips, bf16: bool) -> tuple[float, str]:
    """Least time for one K7 call: bytes of G read once, Ω read, P and Q
    written (f32) over HBM bandwidth; product FLOP over the peak for the
    operand type, ``2·m·n·r`` for each of ``G Ω``, the first ``GᵀP`` and
    two products a refinement, with each member's trips in this call (the
    final ``Q = GᵀP`` is the last refinement's ``GᵀP``)."""
    t = trips.tolist()
    nbytes, flop, k = 0, 0, 0
    for G in Gs:
        L, m, n = G.shape
        nbytes += 4 * L * (m * n + n * r + (m + n) * r)
        flop += sum(2 * m * n * r * (2 + 2 * t[k + i]) for i in range(L))
        k += L
    tb = nbytes / HBM_BPS
    to = flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def k7_streamed_floor(Gs, trips) -> float:
    """ms to read every member's G once a pass, ``2 + 2·trips`` passes, at
    the HBM rate: the floor of a design that streams G (none keeps a
    class's 122.9 MB on chip), beside the bound, which counts G once."""
    t = trips.tolist()
    nbytes, k = 0, 0
    for G in Gs:
        L, m, n = G.shape
        nbytes += sum(4 * m * n * (2 + 2 * t[k + i]) for i in range(L))
        k += L
    return nbytes / HBM_BPS * 1e3


def k7_errors(torch, Gs, r, got, want) -> dict:
    """Kernel against plain per member category: P, and Q and PQᵀ over the
    member's max|G|, for the members of rank ≥ r; PQᵀ alone for site 1
    when its rank (2) is below r (its other columns are rounding noise);
    the dead site's factors exactly; the trip counts."""
    Pg, Qg, tg = got
    Pw, Qw, tw = want
    e = {"P": 0.0, "Q": 0.0, "PQ": 0.0, "PQ_rank_below_r": 0.0, "dead_site": 0.0}
    for G, pg, qg, pw, qw in zip(Gs, Pg, Qg, Pw, Qw):
        scale = G.abs().amax((1, 2)).clamp(min=1e-30)
        dP = (pg - pw).abs().amax((1, 2))
        dQ = (qg - qw).abs().amax((1, 2)) / scale
        dPQ = ((pg @ qg.mT) - (pw @ qw.mT)).abs().amax((1, 2)) / scale
        regular = slice(2, None) if r > 2 else slice(1, None)
        e["P"] = max(e["P"], dP[regular].max().item())
        e["Q"] = max(e["Q"], dQ[regular].max().item())
        e["PQ"] = max(e["PQ"], dPQ[regular].max().item())
        if r > 2:
            e["PQ_rank_below_r"] = max(e["PQ_rank_below_r"], dPQ[1].item())
        e["dead_site"] = max(e["dead_site"], (pg[0] - pw[0]).abs().max().item(),
                             (qg[0] - qw[0]).abs().max().item())
        if not all(bool(a.isfinite().all()) for a in (pg, qg)):
            fail(f"K7 rank {r}: non-finite factors")
    e["trips_differ"] = int((tg != tw).sum().item())
    e["trips"] = {int(v): int(c) for v, c in zip(*torch.unique(tg, return_counts=True))}
    return e


def k7_check(torch, what: str, Gs, r, got, want, dtype: str, trips: bool) -> dict:
    """``k7_errors`` of a kernel call against the plain version, held to
    ``K7_TOL``, the dead site exactly, and (``trips``) the trip counts to
    ``K7_TRIPS_DIFFER_SHARE`` of the members."""
    e = k7_errors(torch, Gs, r, got, want)
    bad = [k for k, v in K7_TOL[dtype].items() if not e[k] <= v]
    if e["dead_site"] != 0.0:
        bad.append("dead_site")
    if trips and e["trips_differ"] > K7_TRIPS_DIFFER_SHARE * sum(G.shape[0] for G in Gs):
        bad.append("trips")
    if bad:
        fail(f"K7 {what} differs from the plain version in {bad}: {json.dumps(e)}")
    return e


K7_DESIGN = ("the staged route (poweriter_staged_kernel): one block a member, numbered largest "
             "member first, two blocks an SM; G's row-major side A streams through a ring of "
             "16 KB shared-memory stages, an mbarrier a stage, refilled by the last warp done "
             "with a tile: column bands of A for A x, 64 x 64, copied as two 64 x 32 boxes of "
             "a per-bucket tensor map (128-byte swizzle, zero past A's edges; eight lanes a "
             "row), and row bands for A^T y, one bulk copy a row (a thread 4 columns); sums "
             "in registers with float4 reads of the iterate, bf16 rounding once a pass; the "
             "r x r chain in one warp (the direct route, the first design, for a class the "
             "staged route does not take)")


def k7_geometry_line(pc, Gs, r: int, mm) -> dict:
    """The geometry the launcher picks for this class, by its own rule."""
    return pc.device_k7_geometry("cuda", [tuple(G.shape) for G in Gs], r,
                                 all(pc._aligned(G) for G in Gs),
                                 [pc._row_major(G) for G in Gs], mm)


def poweriter_phase(torch, pc) -> list[dict]:
    """K7 against its plain version at one round of the flagship's rank
    classes (32 sites), f32 and bf16, cold and warm Ω, tol 1e-3 and 0, on
    the staged route the launcher picks and on the direct route; times
    (both routes), bounds, the streamed floor and the phase clock; the
    coverage classes; the wrapper's refusals."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for r, leaves in k7_leaves(torch).items():
        Gs = k7_gradients(torch, leaves, gen)
        cold, warm = k7_starts(torch, pc, leaves, Gs, r, gen)
        direct = pc.k7_direct_geometry([tuple(G.shape) for G in Gs], r)
        for bf16 in (False, True):
            mm = torch.bfloat16 if bf16 else None
            geo = k7_geometry_line(pc, Gs, r, mm)
            if geo["route"] != "staged" or geo["blocks_per_sm"] != 2 or geo["waves"] != 1:
                fail(f"K7 rank {r}: the flagship class is not staged at two blocks an SM in one "
                     f"wave: {geo}")
            for start, oms in (("cold", cold), ("warm", warm)):
                for tol in (1e-3, 0.0):
                    n0 = pc.POWERITER_STAGED_CALLS
                    got = pc.poweriter_fused(Gs, oms, K7_ITERS, tol, mm)
                    got_direct = pc.poweriter_fused(Gs, oms, K7_ITERS, tol, mm, geometry=direct)
                    torch.cuda.synchronize()
                    if pc.POWERITER_STAGED_CALLS != n0 + 1:
                        fail(f"K7 rank {r} did not take the staged route")
                    want = pc.poweriter_plain(Gs, oms, K7_ITERS, tol, mm)
                    dtype = "bf16" if bf16 else "f32"
                    rec = {"kernel": "poweriter", "rank": r,
                           "members": sum(G.shape[0] for G in Gs),
                           "shapes": [list(G.shape) for G in Gs], "dtype": dtype, "start": start,
                           "tol": tol, "route": "staged"}
                    rec.update(k7_check(torch, f"rank {r} {dtype} {start} tol {tol}", Gs, r,
                                        got, want, dtype, tol > 0))
                    rec["direct_route"] = k7_check(torch, f"direct route rank {r} {dtype} {start} "
                                                   f"tol {tol}", Gs, r, got_direct, want, dtype,
                                                   tol > 0)
                    if tol == 1e-3:
                        rec["geometry"] = {k: v for k, v in geo.items() if k != "why"}
                        rec["ms"] = time_ms(lambda: pc.poweriter_fused(Gs, oms, K7_ITERS, tol, mm), 20)
                        rec["direct_ms"] = time_ms(lambda: pc.poweriter_fused(
                            Gs, oms, K7_ITERS, tol, mm, geometry=direct), 20)
                        rec["plain_ms"] = time_ms(
                            lambda: pc.poweriter_plain(Gs, oms, K7_ITERS, tol, mm), 5)
                        rec["bound_ms"], rec["bound_by"] = k7_bound(Gs, r, got[2], bf16)
                        rec["streamed_floor_ms"] = k7_streamed_floor(Gs, got[2])
                        rec["library_ms"] = None
                        rec["phases"] = pc.k7_phase_profile(Gs, oms, K7_ITERS, tol, mm)
                    print(json.dumps(rec))
                    out.append(rec)
    k7_coverage_phase(torch, pc, gen)
    # the wrapper refuses what the kernel does not take, before any launch
    n0 = pc.POWERITER_LAUNCHES
    for what, G, om in (
            ("over the shared-memory limit", torch.zeros((1, 4000, 3000), device="cuda"),
             torch.zeros((1, 3000, 16), device="cuda")),
            ("no contiguous matrix axis", torch.zeros((2, 64, 64, 2), device="cuda")[..., 0],
             torch.zeros((2, 64, 4), device="cuda"))):
        try:
            pc.poweriter_fused(G, om, K7_ITERS, 1e-3)
        except ValueError as e:
            print(f"K7 refuses a class {what}: {e}")
        else:
            fail(f"poweriter_fused took a class {what}")
    if pc.POWERITER_LAUNCHES != n0:
        fail("a refused class was launched")
    plain_route_check(torch, pc, gen)
    return out


# Untimed K7 classes beyond the flagship's, each held to K7_TOL against the
# plain version in f32 and bf16 from a cold Ω (trips are not compared at 8
# members, where one member a refinement apart is 1/8 of them): ranks 1 and
# 16; row-major and transposed buckets in one class; A's rows and columns
# off every tile multiple (64-row chunks and 64-column bands, row bands,
# rows past one 1024-column chunk) in a row pitch wider than A; widths off
# 4 values, a class past half an SM's shared memory and a class with an
# unaligned member, all on the direct route by the geometry's rule; and
# the flagship's r = 2 class forced onto the direct route.
K7_COVERAGE = [
    # (what, rank, [(m, n, transposed, pad)], sites, expected route); the
    # pads keep each row pitch a multiple of 4 values
    ("rank 16, row-major and transposed, ragged bands", 16,
     [(300, 201, True, 4), (150, 92, False, 4)], 8, "staged"),
    ("rank 1", 1, [(37, 132, False, 0), (44, 23, True, 0)], 8, "staged"),
    ("rank 4, 1100 rows and 1100 columns of A", 4,
     [(1100, 300, False, 0), (64, 1100, False, 0), (300, 1032, True, 0)], 4, "staged"),
    ("rank 1, widths off 4 values", 1, [(37, 129, False, 3), (45, 23, True, 3)], 8, "direct"),
    ("rank 16, iterates past half an SM", 16, [(2000, 1000, False, 0)], 3, "direct"),
]


def k7_coverage_phase(torch, pc, gen) -> None:
    cases = [(what, r, [(f"c{i}", m, n, tr) for i, (m, n, tr, _) in enumerate(spec)],
              [pad for *_, pad in spec], sites, route) for what, r, spec, sites, route in K7_COVERAGE]
    for what, r, leaves, pads, sites, route in cases:
        Gs = [k7_gradients(torch, [leaf], gen, sites, pad)[0] for leaf, pad in zip(leaves, pads)]
        k7_coverage_case(torch, pc, what, r, leaves, Gs, route, gen)
    # an unaligned member: G one value past a 16-byte boundary
    leaves = [("c0", 96, 64, False)]
    G = k7_gradients(torch, leaves, gen, 8)[0]
    store = torch.zeros(G.numel() + 1, device="cuda")
    store[1:] = G.reshape(-1)
    k7_coverage_case(torch, pc, "an unaligned member", 4, leaves,
                     [store[1:].view(G.shape)], "direct", gen)
    # the flagship's r = 2 class forced onto the direct route
    r, leaves = next((r, lv) for r, lv in k7_leaves(torch).items() if r == 2)
    Gs = k7_gradients(torch, leaves, gen)
    k7_coverage_case(torch, pc, "the r = 2 class forced onto the direct route", r, leaves, Gs,
                     "direct", gen, pc.k7_direct_geometry([tuple(G.shape) for G in Gs], r))


def k7_coverage_case(torch, pc, what, r, leaves, Gs, route, gen, geometry=None) -> None:
    cold, _ = k7_starts(torch, pc, leaves, Gs, r, gen)
    for bf16 in (False, True):
        mm = torch.bfloat16 if bf16 else None
        geo = geometry or k7_geometry_line(pc, Gs, r, mm)
        if geo["route"] != route:
            fail(f"K7 coverage {what}: route {geo['route']}, want {route} ({geo.get('why')})")
        n0 = (pc.POWERITER_STAGED_CALLS, pc.POWERITER_DIRECT_CALLS)
        got = pc.poweriter_fused(Gs, cold, K7_ITERS, 1e-3, mm, geometry=geometry)
        torch.cuda.synchronize()
        counted = (pc.POWERITER_STAGED_CALLS - n0[0], pc.POWERITER_DIRECT_CALLS - n0[1])
        if counted != ((1, 0) if route == "staged" else (0, 1)):
            fail(f"K7 coverage {what}: counted {counted} on the {route} route")
        want = pc.poweriter_plain(Gs, cold, K7_ITERS, 1e-3, mm)
        dtype = "bf16" if bf16 else "f32"
        e = k7_check(torch, f"coverage {what} {dtype}", Gs, r, got, want, dtype, False)
        print(json.dumps({"k7_coverage": what, "rank": r, "dtype": dtype, "route": route,
                          "shapes": [list(G.shape) for G in Gs],
                          "tiles": geo.get("tiles"), "stages": geo.get("stages"), **e}))


def plain_route_check(torch, pc, gen) -> dict:
    """A rank class K7 does not take (r = 17 > 16, a valid
    ``dad_reduction_rank`` in JAX) through the engine's
    ``subspace_iteration_grouped`` beside one it takes (r = 2): the first
    goes to the plain version by shape, before any launch, and is counted;
    the second launches K7 once. Each member is of rank 17 exactly, so the
    factors must rebuild it."""
    from dinunet_implementations_tpu_torch.engines import lowrank

    S, m, n, k = TRAIN_SITES, 256, 64, 17
    G17 = (torch.randn((S, m, k), generator=gen, device="cuda")
           @ torch.randn((S, k, n), generator=gen, device="cuda")) / k ** 0.5
    G2 = torch.randn((S, 64, 2), generator=gen, device="cuda")
    n0, p0 = pc.POWERITER_LAUNCHES, lowrank.POWERITER_PLAIN_CLASSES
    (P, Q), = lowrank.subspace_iteration_grouped([([G17], 17, None)], K7_ITERS, 1e-3)[0]
    (P2, Q2), = lowrank.subspace_iteration_grouped([([G2], 2, None)], K7_ITERS, 1e-3)[0]
    torch.cuda.synchronize()
    rec = {"check": "rank class past K7", "rank": 17, "members": S, "shape": [m, n],
           "poweriter_plain_classes": lowrank.POWERITER_PLAIN_CLASSES - p0,
           "poweriter_launches": pc.POWERITER_LAUNCHES - n0,
           "rebuild_err_share": ((P @ Q.mT - G17).abs().amax() / G17.abs().amax()).item(),
           "rank2_rebuild_err_share": ((P2 @ Q2.mT - G2).abs().amax() / G2.abs().amax()).item()}
    print(json.dumps(rec))
    if rec["poweriter_plain_classes"] != 1 or rec["poweriter_launches"] != 1:
        fail(f"the r = 17 class was not routed to the plain version by shape: {rec}")
    if P.shape != (S, m, 17) or Q.shape != (S, n, 17) or not rec["rebuild_err_share"] <= 1e-3 \
            or not rec["rank2_rebuild_err_share"] <= 1e-3:
        fail(f"the r = 17 class's factors: {tuple(P.shape)}, {tuple(Q.shape)}, {rec}")
    return rec


# ---------------------------------------------------------------------------
# K3-K6: the fused bidirectional kernels

BIDIR_ROWS = (16, 512)  # K4/K6: the one-model gradient, the training fold
BIDIR_FWD_ROWS = (1, 16, 512)  # K3/K5: one request, the one-model forward, the training fold
BIDIR_FWD_OUTPUTS = ("hs2", "cs2", "i2", "f2", "o2", "g2", "hT2", "cT2")
BIDIR_BWD_OUTPUTS = ("dp", "dh02", "dc02")


def bidir_bound(kernel: str, rows: int, bf16: bool) -> tuple[float, str]:
    """Least time for one call of K3-K6: K1's and K2's counts for both
    directions. K3: x read once (both directions consume it), the two
    directions' W_ih, W_hh and f32 biases, the f32 carries in and out, the
    12 streams written; FLOP ``2·2·T·rows·(D+H)·4H``. K5: K3's and the f32
    pool ``[rows, 2H]``. K4: twice K2's (per direction six streams read,
    i, f, o, g, c, dhs, and four dp written, W_hhᵀ, five f32 carries);
    FLOP ``2·2·T·rows·4H·H``. K6: K4's without the dhs streams, with the
    f32 ``dpool`` per direction."""
    es = 2 if bf16 else 4
    if kernel in ("bilstm_fwd", "bilstm_pool_fwd"):
        nbytes = (T * rows * D * es + 2 * (4 * D * H + 4 * H * H) * es + 2 * 4 * H * 4
                  + 2 * 4 * rows * H * 4 + 12 * T * rows * H * es)
        if kernel == "bilstm_pool_fwd":
            nbytes += 2 * rows * H * 4
        flop = 2 * 2 * T * rows * (D + H) * 4 * H
    else:
        streams = 10 if kernel == "bilstm_bwd" else 9
        nbytes = 2 * (streams * T * rows * H * es + 4 * H * H * es + 5 * rows * H * 4)
        if kernel == "bilstm_pool_bwd":
            nbytes += 2 * rows * H * 4
        flop = 2 * 2 * T * rows * 4 * H * H
    tb, to = nbytes / HBM_BPS, flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def bidir_args(torch, rows: int, g, h: int = H, d: int = D):
    """Inputs of both directions at rows ``rows`` (width ``h``, inputs
    ``d``), as the JAX kernels take them: x ``[T, rows, d]``, wih2 ``[2, 4,
    d, h]``, b2, whh2, h02, c02."""
    dev = torch.device("cuda")

    def u(*shape, scale):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)

    x = torch.randn((T, rows, d), generator=g).relu().to(dev)
    return (x, u(2, 4, d, h, scale=d ** -0.5), u(2, 4, h, scale=2 * d ** -0.5),
            u(2, 4, h, h, scale=h ** -0.5), u(2, rows, h, scale=0.5).contiguous(),
            u(2, rows, h, scale=0.5).contiguous())


def bidir_bwd_args(torch, bc, args, cdt, g, const: bool):
    """K4's inputs from the plain forward's residuals: random cotangents,
    full ``[T, rows, H]`` streams or (``const``) ``[1, rows, H]`` per-row
    constants at the stream dtype."""
    hs2, cs2, i2, f2, o2, g2, _, _ = bc.bilstm_fwd_plain(*args, cdt)
    sdt = hs2.dtype
    rows, h = hs2.shape[2:]

    def cot(*shape):
        return (0.05 * torch.randn(shape, generator=g)).cuda()

    n = 1 if const else T
    return (i2, f2, o2, g2, cs2, args[3], args[5], cot(n, rows, h).to(sdt), cot(n, rows, h).to(sdt),
            cot(2, rows, h), cot(2, rows, h))


def pool_bwd_args(torch, bc, rows: int, cdt, g, h: int = H):
    """K6's inputs at rows ``rows`` (width ``h``): K4's with per-row
    constant cotangents, those as the f32 ``[rows, h]`` ``dpool / T``."""
    pb = list(bidir_bwd_args(torch, bc, bidir_args(torch, rows, g, h), cdt, g, const=True))
    pb[7], pb[8] = pb[7][0].float().contiguous(), pb[8][0].float().contiguous()
    return tuple(pb)


def pool_plain_args(pb):
    """K6's inputs as ``bilstm_bwd_plain`` takes them: the constants ``[1,
    rows, h]``."""
    return (*pb[:7], pb[7][None], pb[8][None], *pb[9:])


def library_bilstm(torch, args, cdt, plain_hs2, backward: bool, g) -> dict:
    """A cuDNN ``torch.nn.LSTM(bidirectional=True)`` on the same data: its
    reverse half is in x-time as the kernels' streams are, so the forward
    is held against the plain ``hs2``; the backward also computes dx and
    dW, so it does more than K4 or K6."""
    x, wih2, b2, whh2, h02, c02 = args
    dt = cdt or torch.float32

    def build():
        lstm = cudnn_lstm(torch, wih2, b2, whh2, cdt)
        hc = (h02.to(dt), c02.to(dt))
        if not backward:
            fn = no_grad_call(torch, lambda: lstm(x.to(dt), hc))
            return fn, fn()[0], torch.cat([plain_hs2[0], plain_hs2[1]], -1)
        xx = x.to(dt).requires_grad_()
        out, _ = lstm(xx, hc)
        dout = (0.05 * torch.randn(out.shape, generator=g)).to(out)
        inputs = [xx] + list(lstm.parameters())
        return (lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)), out, None
    what = f"cuDNN bidirectional LSTM {'backward' if backward else 'forward'}"
    return library_call(torch, what, cdt, build, F32_TOL)


def bidir_geometry_line(bc, rows: int, h: int, cdt, pool: bool, geometry=None) -> dict:
    """The launcher's K3 (``pool`` False) or K5 geometry for ``rows`` rows of
    width ``h`` on this card, with cudaOccupancyMaxActiveClusters of its
    configuration (both directions' clusters together)."""
    g = dict(geometry or bc.device_bidir_geometry("cuda", rows, h, cdt, pool))
    g["max_active_clusters"] = bc.bidir_max_active_clusters("cuda", rows, h, cdt, g)
    return g


def bidir_kernel_phase(torch, bc) -> list[dict]:
    """K3 and K5 at rows 1, 16 and 512, K4 (full cotangent streams) and K6
    at rows 16 and 512, f32 and bf16, against their plain versions, timed
    beside the plain version, the bound and cuDNN; each on the route the
    launcher picks and on the stream route (the first design), with the
    geometry and the phase clock (K3/K5 also the projection alone; K4 and
    K6 in bf16 also held to ``BWD_BF16_SHARE``). Then, untimed, every
    geometry K3/K5's launcher can pick (:func:`bidir_coverage_phase`),
    every geometry of K4's and K6's cluster route and their stream route's
    templates (:func:`bwd_coverage_phase`), all four kernels at the rows of
    2 and 4 rows a block on their launcher's route, and K4's per-row
    constant at the stream dtype on both routes."""
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    g = torch.Generator().manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []

    def record(kernel, rows, cdt, err, fn, plain, plain_runs, library, **extra):
        b_ms, b_by = bidir_bound(kernel, rows, cdt is not None)
        rec = {"kernel": kernel, "rows": rows, "dtype": "bf16" if cdt else "f32",
               "max_abs_err": err, "ms": time_ms(fn, 30), **extra,
               "plain_ms": time_ms(plain, plain_runs), **library, "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps(rec))
        out.append(rec)

    for rows in BIDIR_FWD_ROWS:
        stream = bc.bidir_stream_geometry(rows, H, sms)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            args = bidir_args(torch, rows, g)
            xp2 = bc.bilstm_proj_fused(*args[:3], cdt)
            torch.cuda.synchronize()
            proj_err = compare(f"bilstm_proj rows={rows} {cdt}", (xp2,),
                               (bc.bilstm_proj_plain(*args[:3], cdt),), ("xp2",), F32_TOL)
            if cdt is None and rows > 16:
                check_proj_tiles(torch, f"bilstm_proj rows={rows}", bc.bilstm_proj_fused, args, xp2)
            del xp2
            want = bc.bilstm_fwd_plain(*args, cdt)
            fwd_lib = library_bilstm(torch, args, cdt, want[0], False, g)
            for kernel, pool in (("bilstm_fwd", False), ("bilstm_pool_fwd", True)):
                fused = bc.bilstm_pool_fwd_fused if pool else bc.bilstm_fwd_fused
                names = BIDIR_FWD_OUTPUTS + (("pool",) if pool else ())
                w = bc.bilstm_fwd_plain(*args, cdt, pool=True) if pool else want
                geo = bidir_geometry_line(bc, rows, H, cdt, pool)
                got = fused(*args, cdt)
                torch.cuda.synchronize()
                err = compare(f"{kernel} rows={rows} {cdt} {geo['route']}", got, w, names, tol)
                got = fused(*args, cdt, geometry=stream)
                torch.cuda.synchronize()
                stream_err = compare(f"{kernel} rows={rows} {cdt} stream", got, w, names, tol)
                del got
                phases = (bc.bidir_phase_profile(*args, cdt, pool=pool)
                          if geo["route"] == "cluster" else None)
                record(kernel, rows, cdt, err, lambda: fused(*args, cdt),
                       lambda: bc.bilstm_fwd_plain(*args, cdt, pool=pool), 10, fwd_lib,
                       route=geo["route"],
                       stream_ms=time_ms(lambda: fused(*args, cdt, geometry=stream), 30),
                       stream_max_abs_err=stream_err,
                       proj_ms=time_ms(lambda: bc.bilstm_proj_fused(*args[:3], cdt), 30),
                       proj_max_abs_err=proj_err, scratch_ms=scratch_ms(torch, rows, 8),
                       step_phases=phases, geometry=geo, stream_geometry=stream)

    for rows in BIDIR_ROWS:
        stream = lc.bwd_stream_geometry(rows, H, sms, dirs=2)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            args = bidir_args(torch, rows, g)
            bwd_lib = library_bilstm(torch, args, cdt, None, True, g)
            bargs = bidir_bwd_args(torch, bc, args, cdt, g, const=False)
            geo = bwd_geometry_line("bilstm_bwd", rows, H, cdt)
            want = bc.bilstm_bwd_plain(*bargs, cdt)
            got = bc.bilstm_bwd_fused(*bargs, cdt)
            torch.cuda.synchronize()
            err = compare(f"bilstm_bwd rows={rows} {cdt} {geo['route']}", got, want,
                          BIDIR_BWD_OUTPUTS, tol)
            share = bwd_share(f"bilstm_bwd rows={rows} {cdt}", geo["route"], cdt, got, want,
                              BIDIR_BWD_OUTPUTS)
            got = bc.bilstm_bwd_fused(*bargs, cdt, geometry=stream)
            torch.cuda.synchronize()
            stream_err = compare(f"bilstm_bwd rows={rows} {cdt} stream", got, want,
                                 BIDIR_BWD_OUTPUTS, tol)
            del got, want
            record("bilstm_bwd", rows, cdt, err, lambda: bc.bilstm_bwd_fused(*bargs, cdt),
                   lambda: bc.bilstm_bwd_plain(*bargs, cdt), 5, bwd_lib,
                   route=geo["route"], bf16_max_share=share,
                   stream_ms=time_ms(lambda: bc.bilstm_bwd_fused(*bargs, cdt, geometry=stream),
                                     30),
                   stream_max_abs_err=stream_err,
                   step_phases=bc.k4_phase_profile(*bargs, cdt)
                   if geo["route"] == "cluster" else None,
                   geometry=geo, stream_geometry=stream)

            pb = list(bidir_bwd_args(torch, bc, args, cdt, g, const=True))
            pb[7], pb[8] = pb[7][0].float().contiguous(), pb[8][0].float().contiguous()
            geo = bwd_geometry_line("bilstm_pool_bwd", rows, H, cdt)
            want = bc.bilstm_bwd_plain(*pool_plain_args(pb), cdt)
            got = bc.bilstm_pool_bwd_fused(*pb, cdt)
            torch.cuda.synchronize()
            err = compare(f"bilstm_pool_bwd rows={rows} {cdt} {geo['route']}", got, want,
                          BIDIR_BWD_OUTPUTS, tol)
            share = bwd_share(f"bilstm_pool_bwd rows={rows} {cdt}", geo["route"], cdt, got, want,
                              BIDIR_BWD_OUTPUTS)
            got = bc.bilstm_pool_bwd_fused(*pb, cdt, geometry=stream)
            torch.cuda.synchronize()
            stream_err = compare(f"bilstm_pool_bwd rows={rows} {cdt} stream", got, want,
                                 BIDIR_BWD_OUTPUTS, tol)
            del got, want
            record("bilstm_pool_bwd", rows, cdt, err, lambda: bc.bilstm_pool_bwd_fused(*pb, cdt),
                   lambda: bc.bilstm_bwd_plain(*pool_plain_args(pb), cdt), 5, bwd_lib,
                   route=geo["route"], bf16_max_share=share,
                   stream_ms=time_ms(lambda: bc.bilstm_pool_bwd_fused(*pb, cdt, geometry=stream),
                                     30),
                   stream_max_abs_err=stream_err,
                   step_phases=bc.bidir_bwd_phase_profile(*pb, cdt)
                   if geo["route"] == "cluster" else None,
                   geometry=geo, stream_geometry=stream)

    bidir_coverage_phase(torch, bc, g)
    bwd_coverage_phase(torch, "bilstm_bwd", g)
    bwd_coverage_phase(torch, "bilstm_pool_bwd", g)
    # untimed: the rows at which the stream route's rule (the fewest rows a
    # block that keep both directions' blocks within the SMs, rows / R <=
    # SMs / 2) takes 2 and 4 rows a block; every kernel runs here on its
    # launcher's route (at H = 174, the cluster route)
    half = sms // 2
    for rows in (2 * half - 1, 4 * half - 1):
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            args = bidir_args(torch, rows, g)
            errs = {"bilstm_fwd": compare(f"bilstm_fwd rows={rows} {cdt}",
                                          bc.bilstm_fwd_fused(*args, cdt),
                                          bc.bilstm_fwd_plain(*args, cdt), BIDIR_FWD_OUTPUTS, tol),
                    "bilstm_pool_fwd": compare(f"bilstm_pool_fwd rows={rows} {cdt}",
                                               bc.bilstm_pool_fwd_fused(*args, cdt),
                                               bc.bilstm_fwd_plain(*args, cdt, pool=True),
                                               BIDIR_FWD_OUTPUTS + ("pool",), tol)}
            for const in (False, True):
                bargs = bidir_bwd_args(torch, bc, args, cdt, g, const)
                errs[f"bilstm_bwd{' const' if const else ''}"] = compare(
                    f"bilstm_bwd rows={rows} {cdt} const={const}", bc.bilstm_bwd_fused(*bargs, cdt),
                    bc.bilstm_bwd_plain(*bargs, cdt), BIDIR_BWD_OUTPUTS, tol)
            pb = list(bargs)
            pb[7], pb[8] = pb[7][0].float().contiguous(), pb[8][0].float().contiguous()
            errs["bilstm_pool_bwd"] = compare(
                f"bilstm_pool_bwd rows={rows} {cdt}", bc.bilstm_pool_bwd_fused(*pb, cdt),
                bc.bilstm_bwd_plain(*pool_plain_args(pb), cdt), BIDIR_BWD_OUTPUTS, tol)
            print(json.dumps({"check": "bidir rows per block", "rows": rows, "sms": 2 * half,
                              "dtype": "bf16" if cdt else "f32", "max_abs_err": errs}))
    # K4's per-row constant at the stream dtype (the one-model gradient's
    # form, f32 and in the bf16 arm) at the timed shapes, on both routes
    for rows in BIDIR_ROWS:
        stream = lc.bwd_stream_geometry(rows, H, sms, dirs=2)
        args = bidir_args(torch, rows, g)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            bargs = bidir_bwd_args(torch, bc, args, cdt, g, const=True)
            route = bc.device_k4_geometry("cuda", rows, H, cdt)["route"]
            want = bc.bilstm_bwd_plain(*bargs, cdt)
            got = bc.bilstm_bwd_fused(*bargs, cdt)
            what = f"bilstm_bwd const rows={rows} {cdt}"
            err = compare(f"{what} {route}", got, want, BIDIR_BWD_OUTPUTS, tol)
            share = bwd_share(what, route, cdt, got, want, BIDIR_BWD_OUTPUTS)
            stream_err = compare(f"{what} stream", bc.bilstm_bwd_fused(*bargs, cdt, geometry=stream),
                                 want, BIDIR_BWD_OUTPUTS, tol)
            print(json.dumps({"check": "bilstm_bwd per-row constant", "rows": rows,
                              "dtype": "bf16" if cdt else "f32", "route": route,
                              "max_abs_err": err, "bf16_max_share": share,
                              "stream_max_abs_err": stream_err}))
    return out


def bidir_coverage_phase(torch, bc, g) -> None:
    """Untimed: every geometry K3/K5's launcher can pick, each held against
    the plain version on every output and the pool, K3 with and without
    residuals. f32 cluster route: clusters of 2, 4 and 8, each rows a
    thread (1, 2, 4, 8, and 8 over several row groups), ragged slices (174 =
    44 + 44 + 43 + 43) and a ragged last cluster; bf16 cluster route (the
    tensor cores): clusters of 2, 4 and 8, one and several 16-row tiles;
    stream route: H = 400, whose W_hh fits no cluster of 8 in f32, at each
    rows a block (1, 2, 4, 8), in f32 as the launcher picks it and in bf16
    as measurements may ask; bf16 at D = 100, whose projection takes K1's
    SIMT kernel."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    optin = bc.device_limits("cuda")[1]
    bf = torch.bfloat16
    # (H, dtype, the cluster size the launcher should take, rows a cluster,
    # rows short of filling the last cluster of a full wave); None: the
    # stream route, whose rows a block the kernel picks
    cases = [(H, None, 4, 1, 0), (H, None, 4, 2, 1), (H, None, 4, 3, 2), (H, None, 4, 5, 3),
             (H, None, 4, 17, 4), (128, None, 2, 1, 0), (256, None, 8, 7, 3),
             (256, None, 8, 32, 1), (H, bf, 2, 1, 0), (H, bf, 2, 16, 3), (H, bf, 4, 40, 3),
             (128, bf, 2, 20, 3), (STREAM_H, bf, 8, 2, 1)]
    cases += [(STREAM_H, None, None, R, 1) for R in (1, 2, 4, 8)]
    seen = set()
    for h, cdt, C, R, short in cases:
        if C is None:
            rows = max(1, R * (sms // 2) - short)
        else:
            probe = bc.bidir_cluster_geometry(1, h, C, R, cdt, optin)
            rows = max(1, R * (bc.bidir_max_active_clusters("cuda", 1, h, cdt, probe) // 2) - short)
        args = bidir_args(torch, rows, g, h)
        tol = F32_TOL if cdt is None else BF16_TOL
        geo = bidir_geometry_line(bc, rows, h, cdt, True)
        if geo["route"] != ("stream" if C is None else "cluster") or geo.get("C", C) != C \
                or geo["R"] != R:
            fail(f"K5 geometry for rows={rows} H={h} {cdt}: {geo}, expected C={C} R={R}")
        dt = "bf16" if cdt else "f32"
        if C is None:
            seen.add(("stream", R))
        else:
            seen |= {(dt, "C", C), (dt, "rows a thread", geo["rpt"]),
                     (dt, "row groups > 1", geo["row_groups"] > 1)}
        errs = {"bilstm_pool_fwd": compare(
            f"bilstm_pool_fwd rows={rows} H={h} {cdt}", bc.bilstm_pool_fwd_fused(*args, cdt),
            bc.bilstm_fwd_plain(*args, cdt, pool=True), BIDIR_FWD_OUTPUTS + ("pool",), tol)}
        want = bc.bilstm_fwd_plain(*args, cdt)
        errs["bilstm_fwd"] = compare(f"bilstm_fwd rows={rows} H={h} {cdt}",
                                     bc.bilstm_fwd_fused(*args, cdt), want, BIDIR_FWD_OUTPUTS, tol)
        hs2, (hT2, cT2) = bc.bilstm_fwd_fused(*args, cdt, residuals=False)
        errs["bilstm_fwd no residuals"] = compare(
            f"bilstm_fwd residuals=False rows={rows} H={h} {cdt}", (hs2, hT2, cT2),
            (want[0], want[6], want[7]), ("hs2", "hT2", "cT2"), tol)
        if C is None:  # bf16's slice of H = 400 fits a cluster: the stream route by request
            stream = bc.bidir_stream_geometry(rows, h, sms)
            errs["bilstm_pool_fwd bf16 stream"] = compare(
                f"bilstm_pool_fwd stream rows={rows} H={h} bf16",
                bc.bilstm_pool_fwd_fused(*args, bf, geometry=stream),
                bc.bilstm_fwd_plain(*args, bf, pool=True), BIDIR_FWD_OUTPUTS + ("pool",), BF16_TOL)
        print(json.dumps({"check": "K3/K5 geometry", "rows": rows, "H": h, "dtype": dt,
                          "max_abs_err": errs, "geometry": geo}))
    # bf16 at a D of no whole 16-byte chunks: the projection takes K1's SIMT
    # kernel by shape, the recurrence the tensor cores
    args = bidir_args(torch, 16, g, H, 100)
    err = compare("bilstm_pool_fwd D=100 bf16", bc.bilstm_pool_fwd_fused(*args, bf),
                  bc.bilstm_fwd_plain(*args, bf, pool=True), BIDIR_FWD_OUTPUTS + ("pool",), BF16_TOL)
    print(json.dumps({"check": "K3/K5 bf16 projection at D=100", "max_abs_err": err}))
    need = ({("f32", "C", C) for C in (2, 4, 8)} | {("f32", "rows a thread", r) for r in (1, 2, 4, 8)}
            | {("f32", "row groups > 1", True), ("bf16", "row groups > 1", True)}
            | {("bf16", "C", C) for C in (2, 4, 8)} | {("stream", r) for r in (1, 2, 4, 8)})
    if not need <= seen:
        fail(f"K3/K5 coverage misses {sorted(map(str, need - seen))}")


def fused_bf16_epoch(torch, np, lc, pc, bc) -> dict:
    """The bf16 fused arm (the compute dtype of the JAX bench's arm): one
    dSGD epoch timed cold (the first bf16 epoch of the run), then the next
    one timed warm; finite losses and params, one K5 and one K6 per
    micro-batch, both on the cluster route."""
    cfg, epoch, st = training_setup(torch, use_kernel=True, fused_bidir=True, bf16=True)
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    rounds = [q.shape[1] // cfg.local_iterations for q in plans]
    idx = [torch.from_numpy(q).cuda() for q in plans]
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)
    ms, out = [], []
    for e in range(TRAIN_EPOCHS):
        t0 = time.perf_counter()
        st, lo = epoch(st, inv_x, inv_y, idx[e])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(lo)
    launches = read_counters(lc, pc, bc)
    losses = torch.cat(out)
    samples = cfg.num_sites * plans[-1].shape[1] * cfg.batch_size
    rec = {"epoch_ms": ms, "rounds_per_epoch": rounds, "samples_per_s": samples / (ms[-1] / 1e3),
           "ms_per_round": ms[-1] / rounds[-1], "losses": losses.tolist(), "launches": launches}
    print("training dSGD fused_bidir bf16:", json.dumps(rec))
    want = dict.fromkeys(launches, 0)
    n = sum(rounds) * cfg.local_iterations
    want.update(bilstm_pool_fwd=n, bilstm_proj=n, bidir_cluster_route=n, bilstm_pool_bwd=n,
                k6_cluster_route=n)
    if launches != want:
        fail(f"bf16 fused epoch launches {launches}, want {want}")
    if losses.shape != (sum(rounds),) or not bool(losses.isfinite().all()):
        fail(f"bf16 fused epoch losses {losses.tolist()}")
    if not all(bool(v.isfinite().all()) for v in st.params.values()):
        fail("bf16 fused epoch: non-finite params")
    return rec


def fused_model_phase(torch, np, lc, pc, bc) -> dict:
    """The one-model paths of the fused arm at full width: the eval forward
    (``eval_forward``, rows 1 and 16; one K3 launch a call) against the
    per-direction kernel path and the plain path, and one gradient of
    ``ICALstm.forward(train=True)`` on 16 rows (one K3 and one K4 launch,
    both on the cluster route) against the plain path."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_model
    from dinunet_implementations_tpu_torch.trainer.steps import (
        FederatedTask,
        cross_entropy,
        eval_forward,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    a = cfg.ica_args
    per_dir = build_model(cfg)  # the per-direction arm, K1
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial head BatchNorm state
        bn = per_dir.cls_bn
        bn.running_mean.copy_(0.2 * torch.randn(256, generator=g))
        bn.running_var.copy_(0.5 + 1.5 * torch.rand(256, generator=g))
    fused = fused_twin(per_dir, cfg, use_kernel=True)
    plain = fused_twin(per_dir, cfg, use_kernel=False)
    tasks = {k: FederatedTask(m.eval()) for k, m in
             (("fused", fused), ("per_direction", per_dir), ("plain", plain))}
    rng = np.random.default_rng(6)
    windows = a.temporal_size // a.window_size
    rec = {"eval": {}, "launches": {}}
    for rows in (1, 16):
        x = torch.from_numpy(rng.standard_normal((rows, windows, a.num_components, a.window_size))
                             .astype(np.float32)).cuda()
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)
        got = eval_forward(tasks["fused"], x)
        torch.cuda.synchronize()
        launches = read_counters(lc, pc, bc)
        rec["launches"][f"eval_rows_{rows}"] = launches
        want = dict.fromkeys(launches, 0) | {"bilstm_fwd": 1, "bilstm_proj": 1,
                                             "bidir_cluster_route": 1}
        if launches != want:
            fail(f"fused eval rows={rows} launches {launches}, want {want}")
        errs = {k: (got - eval_forward(tasks[k], x)).abs().max().item()
                for k in ("per_direction", "plain")}
        rec["eval"][f"rows_{rows}"] = errs
        if got.shape != (rows, a.num_class) or not bool(got.isfinite().all()) or \
                max(errs.values()) > SERVE_TOL:
            fail(f"fused eval rows={rows}: {got.shape}, errors {errs}")

    x = torch.from_numpy(rng.standard_normal((16, windows, a.num_components, a.window_size))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, a.num_class, 16)).cuda()
    w = torch.ones(16).cuda()
    grads = {}
    for k, m in (("fused", fused), ("plain", plain)):
        m.train().dropout_rate = 0.0
        named = dict(m.named_parameters())
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)
        loss = cross_entropy(m(x, train=True, mask=w), y, w)
        gk = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        if k == "fused":
            launches = read_counters(lc, pc, bc)
        grads[k] = dict(zip(named, gk))
    rec["launches"]["one_model_gradient"] = launches
    want = dict.fromkeys(launches, 0) | {"bilstm_fwd": 1, "bilstm_proj": 1,
                                         "bidir_cluster_route": 1, "bilstm_bwd": 1,
                                         "k4_cluster_route": 1}
    if launches != want:
        fail(f"fused one-model gradient launches {launches}, want {want}")
    err, ok = tree_err(grads["fused"], grads["plain"], **AGG_TOL)
    rec["gradient_max_abs_err_vs_plain"] = err
    rec["gradient_leaf_err_and_scale"] = leaf_errs(grads["fused"], grads["plain"])
    print("fused one-model paths:", json.dumps(rec))
    if not ok:
        fail(f"fused one-model gradient differs from the plain path by {err}")
    return rec


# The fit slice (phase 11): a demo ICA tree of 32 sites at the flagship
# width, 40 subjects a site (32 / 4 / 4 by the default split ratio: two
# rounds an epoch at batch 16), three epochs of dSGD through the host
# pipeline, f32.
FIT_SITES, FIT_SUBJECTS, FIT_EPOCHS = 32, 40, 3
# the logs.json keys and the test_metrics.csv header of JAX's FedRunner
# (tests/test_torch_port_fit.py holds the port's against JAX's on the CPU)
FIT_LOCAL_KEYS = {"agg_engine", "test_metrics", "best_val_epoch", "cumulative_total_duration",
                  "time_spent_on_computation", "local_iter_duration", "site_index",
                  "pooled_test_metrics", "durations_shared_across_sites", "skipped_rounds",
                  "quarantined"}
FIT_REMOTE_KEYS = {"agg_engine", "test_metrics", "best_val_epoch", "cumulative_total_duration",
                   "time_spent_on_computation", "remote_iter_duration", "site_skipped_rounds",
                   "site_quarantined"}
FIT_CSV_HEADER = "fold,accuracy,f1,precision,recall,auc"


def fit_tree(root: str, sites: int = FIT_SITES) -> str:
    """The demo tree of the fit phase, its inputspec widened to the
    default ``ICAArgs`` model (encoder 1000 -> 256, BiLSTM 2 x 174)."""
    from dinunet_implementations_tpu_torch.data import make_ica_demo_tree

    make_ica_demo_tree(root, n_sites=sites, subjects=FIT_SUBJECTS, comps=100, temporal=980,
                       window=10)
    spec_path = os.path.join(root, "inputspec.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    for site in spec:
        site["input_size"] = {"value": 256}
        site["hidden_size"] = {"value": 348}
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    return root


def same_tree(got: dict, want: dict) -> bool:
    """Two dicts of tensors (nested, None leaves) equal bit for bit."""
    if got.keys() != want.keys():
        return False
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            if not isinstance(g, dict) or not same_tree(g, w):
                return False
        elif (g is None) != (w is None) or (w is not None and not (
                g.dtype == w.dtype and g.shape == w.shape and bool((g == w).all()))):
            return False
    return True


def state_err(a, b) -> float:
    """Max abs difference over params, running statistics and Adam moments."""
    err = 0.0
    for ga, gb in ((a.params, b.params), (a.batch_stats, b.batch_stats),
                   (a.opt_state["mu"], b.opt_state["mu"]), (a.opt_state["nu"], b.opt_state["nu"])):
        for k in gb:
            err = max(err, (ga[k].float() - gb[k].float()).abs().max().item())
    return err


def check_fit_outputs(out: str, task_id: str, sites: int = FIT_SITES) -> dict:
    """Every site's and the remote's ``logs.json``, ``test_metrics.csv`` and
    the best checkpoint with its sidecar, in JAX's layout and keys."""
    def fold(site):
        return os.path.join(out, site, "simulatorRun", task_id, "fold_0")

    for i in range(sites):
        with open(os.path.join(fold(f"local{i}"), "logs.json")) as fh:
            keys = set(json.load(fh))
        if keys != FIT_LOCAL_KEYS:
            fail(f"local{i} logs.json keys {sorted(keys ^ FIT_LOCAL_KEYS)} differ from JAX's")
    with open(os.path.join(fold("remote"), "logs.json")) as fh:
        remote = json.load(fh)
    if set(remote) != FIT_REMOTE_KEYS:
        fail(f"remote logs.json keys {sorted(set(remote) ^ FIT_REMOTE_KEYS)} differ from JAX's")
    with open(os.path.join(fold("remote"), "test_metrics.csv")) as fh:
        lines = fh.read().splitlines()
    if len(lines) != 2 or lines[0] != FIT_CSV_HEADER or not lines[1].startswith("fold_0,"):
        fail(f"test_metrics.csv reads {lines}")
    best = os.path.join(fold("remote"), "checkpoint_best.msgpack")
    for f in (best, best + ".meta.json",
              os.path.join(out, "remote", "simulatorRun", "global_results.zip")):
        if not os.path.isfile(f):
            fail(f"the fit wrote no {f}")
    return {"best_checkpoint": best, "best_checkpoint_bytes": os.path.getsize(best)}


def fit_phase(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """The fit slice at full width (phase 11 of the module docstring): a
    ``FedRunner`` fit from a site tree written under ``root`` (its path is
    the record's ``tree``, for phase 13), then the host pipeline against the
    device pipeline, the checkpoint round trip and the served fit."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_epoch, plan_eval
    from dinunet_implementations_tpu_torch.runner import FedRunner, build_model, load_site_splits
    from dinunet_implementations_tpu_torch.trainer import (
        FederatedTrainer,
        load_checkpoint,
        load_inference_state,
        save_checkpoint,
    )

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tree = fit_tree(os.path.join(root, "tree"))
    tree_s = time.perf_counter() - t0
    out = os.path.join(root, "out")
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    runner = FedRunner(cfg, tree, out, pipeline="host", epochs=FIT_EPOCHS, agg_engine="dSGD")
    fcfg = runner.cfg
    a = fcfg.ica_args
    if (a.input_size, a.hidden_size, a.num_components, fcfg.num_sites) != (256, 348, 100,
                                                                           FIT_SITES):
        fail(f"the fit's config is not the flagship's width: {a}, {fcfg.num_sites} sites")
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // fcfg.local_iterations
    eval_steps = {k: plan_eval(fold[k], fcfg.batch_size).steps for k in ("validation", "test")}
    torch.cuda.synchronize()

    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    res = runner.run(folds=[0], verbose=False)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # read before any check

    epochs = len(res["epoch_losses"])
    micro = epochs * rounds * fcfg.local_iterations
    evals = epochs * eval_steps["validation"] + eval_steps["test"]
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": 2 * (micro + evals), "lstm_proj": 2 * (micro + evals),
        "k1_cluster_route": 2 * (micro + evals), "lstm_bwd": 2 * micro,
        "k2_cluster_route": 2 * micro}
    # every LSTM call of the fit launched its kernel: a call that went
    # to a plain version would leave these counts short
    if launches != want:
        fail(f"fit launches {launches}, want {want}")
    finite = [np.isfinite(res[k]).all() for k in ("epoch_losses", "test_metrics")]
    if not all(finite) or not np.isfinite(list(res["test_scores"].values())).all():
        fail(f"the fit's losses or test metrics are not finite: {res['epoch_losses']}, "
             f"{res['test_metrics']}, {res['test_scores']}")
    outputs = check_fit_outputs(out, fcfg.task_id)

    # the checkpoint round trip: the best checkpoint is the fit's best
    # state, bit for bit
    best = outputs["best_checkpoint"]
    t0 = time.perf_counter()
    restored = load_checkpoint(best, res["state"])
    torch.cuda.synchronize()
    load_best_ms = (time.perf_counter() - t0) * 1e3
    for part in ("params", "batch_stats", "opt_state", "engine_state", "health"):
        if not same_tree(getattr(restored, part), getattr(res["state"], part)):
            fail(f"checkpoint_best.msgpack {part} differ from the fit's best state")
    if (restored.rng, restored.round) != (res["state"].rng, res["state"].round):
        fail("checkpoint_best.msgpack rng or round differ from the fit's best state")

    # host pipeline against device pipeline: one epoch from one state
    # and one plan through each, then each once more (timed warm)
    trainers = {p: FederatedTrainer(fcfg.replace(pipeline=p), build_model(fcfg))
                for p in ("device", "host")}
    start = trainers["device"].init_state(num_sites=FIT_SITES)
    runs, epoch_ms, xfer = {}, {}, {}
    for p in ("device", "host", "device", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, lo = trainers[p].run_epoch(start, fold["train"], 1)
        torch.cuda.synchronize()
        epoch_ms[p] = (time.perf_counter() - t0) * 1e3  # the second, warm, run stays
        xfer[p] = trainers[p]._last_transfer_bytes
        runs.setdefault(p, []).append((st, lo))
    inv_bytes = sum(t.numel() * t.element_size() for t in trainers["device"]._inventory)
    # the host pipeline's own share: materializing the dense epoch
    t0 = time.perf_counter()
    plan_epoch(fold["train"], fcfg.batch_size, seed=fcfg.seed * 100003 + 1, pad_mode="wrap")
    materialize_ms = (time.perf_counter() - t0) * 1e3
    (d1, dl1), (d2, dl2) = runs["device"]
    (h1, hl1), _ = runs["host"]
    device_spread = max(state_err(d1, d2), float(np.abs(dl1 - dl2).max()))
    host_vs_device = max(state_err(h1, d1), float(np.abs(hl1 - dl1).max()))
    # host against device is held to the spread of two device epochs:
    # 0 when the device pipeline repeats itself bit for bit
    if not np.isfinite(dl1).all() or host_vs_device > device_spread:
        fail(f"host epoch differs from the device epoch by {host_vs_device} "
             f"(two device epochs by {device_spread})")

    # a validation pass, warm
    dev = trainers["device"]
    dev.evaluate(d1, fold["validation"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.evaluate(d1, fold["validation"])
    eval_ms = (time.perf_counter() - t0) * 1e3

    # saving and loading a full training state
    latest = os.path.join(root, "latest.msgpack")
    t0 = time.perf_counter()
    save_checkpoint(latest, d1, meta={"epoch": 1}, rotate=True)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = load_checkpoint(latest, start)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    if not same_tree(back.params, d1.params) or not same_tree(back.opt_state, d1.opt_state):
        fail("a saved training state does not load back bit for bit")
    t0 = time.perf_counter()
    load_inference_state(best)
    load_inference_ms = (time.perf_counter() - t0) * 1e3

    # serving the fit: the fold's test rows through the engine against
    # the trainer's eval probabilities for those rows
    fb = plan_eval(fold["test"], fcfg.batch_size)
    probs = dev.eval_fn(res["state"], fb.inputs, fb.labels, fb.weights)[0].cpu().numpy()
    keep = fb.weights > 0
    rows, want_p = fb.inputs[keep], probs[keep]
    with InferenceEngine(fcfg, checkpoint=best) as eng:
        eng.warmup()
        lc.LAUNCHES = lc.PROJ_LAUNCHES = lc.K1_CLUSTER_CALLS = lc.K1_STREAM_CALLS = 0
        futs = [eng.submit(rows[i:i + 16]) for i in range(0, len(rows), 16)]
        got_p = np.concatenate([f.result(timeout=120) for f in futs])
        serve = eng.summary()
    serve_launches = {"lstm_fwd": lc.LAUNCHES, "lstm_proj": lc.PROJ_LAUNCHES,
                      "k1_cluster_route": lc.K1_CLUSTER_CALLS,
                      "k1_stream_route": lc.K1_STREAM_CALLS}
    n = serve_launches["lstm_fwd"]
    if n == 0 or n != 2 * serve["dispatches"] or serve_launches != {
            "lstm_fwd": n, "lstm_proj": n, "k1_cluster_route": n, "k1_stream_route": 0}:
        fail(f"served fit launches {serve_launches} for {serve['dispatches']} dispatches")
    serve_err = float(np.abs(got_p - want_p).max())
    if got_p.shape != want_p.shape or serve_err > SERVE_TOL:
        fail(f"the served fit differs from the trainer's eval by {serve_err}")

    rec = {
        "card": smi, "sites": FIT_SITES, "subjects": FIT_SUBJECTS,
        "split": {k: len(fold[k][0]) for k in ("train", "validation", "test")},
        "epochs": epochs, "rounds_per_epoch": rounds, "eval_steps": eval_steps,
        "tree": tree, "tree_seconds": tree_s, "fit_seconds": fit_s, "launches": launches,
        "epoch_losses": res["epoch_losses"], "best_val_epoch": res["best_val_epoch"],
        "best_val_metric": res["best_val_metric"], "test_metrics": res["test_metrics"],
        "test_scores": res["test_scores"], "warm_epoch_ms": epoch_ms,
        "host_materialize_ms": materialize_ms,
        "epoch_transfer_bytes": xfer, "device_inventory_bytes": inv_bytes,
        "device_epoch_spread": device_spread, "host_vs_device_max_abs_err": host_vs_device,
        "validation_pass_ms": eval_ms, "checkpoint_save_ms": save_ms,
        "checkpoint_load_ms": load_ms, "best_checkpoint_load_ms": load_best_ms,
        "inference_state_load_ms": load_inference_ms,
        "best_checkpoint_bytes": outputs["best_checkpoint_bytes"],
        "serving": {"rows": len(rows), "dispatches": serve["dispatches"],
                    "launches": serve_launches, "max_abs_err_vs_trainer_eval": serve_err},
        "phase_seconds": time.perf_counter() - t_phase,
    }
    print(f"fit seconds {fit_s:.3f} ({epochs} epochs, {FIT_SITES} sites, host pipeline) on "
          f"{smi}")
    print(f"warm epoch ms: device {epoch_ms['device']:.3f}, host {epoch_ms['host']:.3f} "
          f"(of which materializing the dense epoch {materialize_ms:.3f}) on {smi}")
    print(f"host-to-device bytes an epoch: device {xfer['device']} (the plan; the inventory, "
          f"{inv_bytes}, once a fit), host {xfer['host']}")
    print(f"validation pass ms {eval_ms:.3f}; checkpoint save ms {save_ms:.3f}, load ms "
          f"{load_ms:.3f}, best load ms {load_best_ms:.3f}, inference-state load ms "
          f"{load_inference_ms:.3f} on {smi}")
    print("fit:", json.dumps(rec))
    return rec


# The CLI (phase 13): phase 11's tree, a powerSGD fit of fold 0 with one
# epoch of largest-site pretraining, then one site alone for one epoch.
CLI_EPOCHS = 3


def cli_phase(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """The command line at full width (phase 13 of the module docstring):
    ``runner.cli.main`` on phase 11's tree, a federated powerSGD fit with
    pretraining, then ``--site 0``; launches counted for each part, the
    printed JSON lines, the outputs, and the best checkpoint's q and e."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import PretrainArgs, TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_eval
    from dinunet_implementations_tpu_torch.runner import (
        FedRunner,
        build_model,
        cli,
        discover_site_dirs,
        load_site_splits,
    )
    from dinunet_implementations_tpu_torch.trainer import (
        FederatedTrainer,
        load_checkpoint,
        save_checkpoint,
    )
    from dinunet_implementations_tpu_torch.trainer.checkpoint import _read_raw
    from dinunet_implementations_tpu_torch.weights import leaf_table

    t_phase = time.perf_counter()
    task = "ICA-Classification"
    out = os.path.join(root, "cli")
    args = ["--data-path", tree, "--task", task, "--engine", "powerSGD", "--quiet"]
    fed_args = args + ["--folds", "0", "--epochs", str(CLI_EPOCHS), "--out-dir", out,
                       "--set", "pretrain=true", "--set", 'pretrain_args={"epochs": 1}']
    # the counts the fit must launch: the fold's rounds, the pretraining's
    # (the largest site's rounds; every other site runs with zero rows) and
    # the eval steps
    runner = FedRunner(TrainConfig(task_id=task, agg_engine="powerSGD"), tree)
    fcfg, pa = runner.cfg, PretrainArgs(epochs=1)
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    L = fcfg.local_iterations
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // L
    largest = max(len(s) for s in fold["train"])
    pre_rounds = (largest // pa.batch_size) // pa.local_iterations
    eval_steps = {k: plan_eval(fold[k], fcfg.batch_size).steps for k in ("validation", "test")}

    # the pretraining's own time and launches, read around its call
    pre = {}
    pretrain = FederatedTrainer._pretrain

    def timed_pretrain(self, *a, **k):
        torch.cuda.synchronize()
        before, t0 = read_counters(lc, pc, bc), time.perf_counter()
        state = pretrain(self, *a, **k)
        torch.cuda.synchronize()
        pre["seconds"] = time.perf_counter() - t0
        pre["launches"] = {n: v - before[n] for n, v in read_counters(lc, pc, bc).items()}
        return state

    FederatedTrainer._pretrain = timed_pretrain
    try:
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)  # the main path's run starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as fed_out:
            rc = cli.main(fed_args)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counters(lc, pc, bc)  # read before any check
    finally:
        FederatedTrainer._pretrain = pretrain
    micro = CLI_EPOCHS * rounds * L + pre_rounds * pa.local_iterations
    evals = CLI_EPOCHS * eval_steps["validation"] + eval_steps["test"]
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": 2 * (micro + evals), "lstm_proj": 2 * (micro + evals),
        "k1_cluster_route": 2 * (micro + evals), "lstm_bwd": 2 * micro,
        "k2_cluster_route": 2 * micro}
    if rc != 0 or launches != want:
        fail(f"cli fit exit code {rc}, launches {launches}, want {want}")
    want_pre = dict.fromkeys(launches, 0) | {
        k: 2 * pre_rounds * pa.local_iterations for k in ("lstm_fwd", "lstm_proj", "k1_cluster_route", "lstm_bwd",
                                         "k2_cluster_route")}
    if pre.get("launches") != want_pre:
        fail(f"cli pretraining launches {pre.get('launches')}, want {want_pre}")
    lines = [json.loads(x) for x in fed_out.getvalue().splitlines()]
    keys = ["fold", "test_loss", f"test_{fcfg.monitor_metric}", "best_val_epoch"]
    if (len(lines) != 1 or list(lines[0]) != keys or lines[0]["fold"] != 0
            or not np.isfinite([lines[0][k] for k in keys[1:3]]).all()):
        fail(f"cli fit printed {fed_out.getvalue()!r}")
    outputs = check_fit_outputs(out, task)

    # the best checkpoint gives back the q and e it holds, bit for bit
    best = outputs["best_checkpoint"]
    like = FederatedTrainer(fcfg, build_model(fcfg)).init_state(num_sites=FIT_SITES)
    restored = load_checkpoint(best, like)
    raw = _read_raw(best)["engine_state"]
    for key in ("q", "e"):
        for name, j, _ in leaf_table(fcfg).params:
            node = raw[key]
            for part in j.split("/"):
                node = node[part]
            got = restored.engine_state[key][name]
            if (got is None) != (node is None) or (got is not None and (
                    got.shape[0] != FIT_SITES
                    or got.cpu().numpy().tobytes() != np.asarray(node).tobytes())):
                fail(f"checkpoint_best.msgpack {key} {j} does not load back bit for bit")
    again = os.path.join(root, "cli_again.msgpack")
    t0 = time.perf_counter()
    save_checkpoint(again, restored)
    save_ms = (time.perf_counter() - t0) * 1e3
    back = load_checkpoint(again, like)
    if not same_tree(back.engine_state, restored.engine_state):
        fail("a powerSGD state does not save and load back bit for bit")

    # one site alone
    zero_counters(lc, pc, bc)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as site_out:
        rc = cli.main(args + ["--site", "0", "--epochs", "1", "--out-dir",
                              os.path.join(root, "cli_site")])
    torch.cuda.synchronize()
    site_s = time.perf_counter() - t0
    site_launches = read_counters(lc, pc, bc)
    site0 = fold["train"][0]
    site_micro = (len(site0) // fcfg.batch_size) // L * L
    site_evals = sum(-(-len(fold[k][0]) // fcfg.batch_size) for k in ("validation", "test"))
    want_site = dict.fromkeys(launches, 0) | {
        "lstm_fwd": 2 * (site_micro + site_evals), "lstm_proj": 2 * (site_micro + site_evals),
        "k1_cluster_route": 2 * (site_micro + site_evals), "lstm_bwd": 2 * site_micro,
        "k2_cluster_route": 2 * site_micro}
    site_lines = [json.loads(x) for x in site_out.getvalue().splitlines()]
    if rc != 0 or site_launches != want_site or len(site_lines) != 1 or not np.isfinite(
            [site_lines[0][k] for k in keys[1:3]]).all():
        fail(f"cli --site 0: exit code {rc}, launches {site_launches}, want {want_site}, "
             f"printed {site_out.getvalue()!r}")
    if len(discover_site_dirs(tree)) != FIT_SITES:
        fail("phase 13 did not reuse phase 11's tree")

    rec = {
        "card": smi, "sites": FIT_SITES, "epochs": CLI_EPOCHS, "rounds_per_epoch": rounds,
        "pretrain_rounds": pre_rounds, "eval_steps": eval_steps, "fit_seconds": fit_s,
        "pretrain_seconds": pre["seconds"], "launches": launches,
        "pretrain_launches": pre["launches"], "json_lines": lines,
        "best_checkpoint_bytes": outputs["best_checkpoint_bytes"],
        "checkpoint_save_ms": save_ms, "site_seconds": site_s, "site_launches": site_launches,
        "site_json_lines": site_lines, "phase_seconds": time.perf_counter() - t_phase,
    }
    for line in lines + site_lines:
        print(json.dumps(line))
    print(f"cli fit seconds {fit_s:.3f} ({CLI_EPOCHS} epochs, powerSGD, {FIT_SITES} sites), of "
          f"which pretraining {pre['seconds']:.3f}; --site 0 seconds {site_s:.3f} on {smi}")
    print(f"powerSGD checkpoint bytes {outputs['best_checkpoint_bytes']}, save ms {save_ms:.3f} "
          f"on {smi}")
    print("cli:", json.dumps(rec))
    return rec


# The FS task (phase 14): the JAX package's default task at MSANNet's full
# width (66 -> 256, 128, 64, 32 -> 2) on a tree of the reference fixture's
# shape: 5 sites of uneven size, 66 aseg features.
FS_TASK = "FS-Classification"
FS_SITES, FS_SUBJECTS, FS_EPOCHS, FS_CLI_EPOCHS = 5, 85, 3, 2
FS_ENGINES = ("dSGD", "rankDAD", "powerSGD")
# a served answer against the same forward on the CPU (f32 both, TF32 off),
# each request in a dispatch of its own
FS_SERVE_TOL = 1e-5
FS_REQUEST_ROWS = (4, 7, 12, 16)


def fs_reader_phase(np, tree: str, smi: str) -> dict:
    """The native batch reader against the Python reader on every site of
    the tree: bit for bit, timed; no batch may fall back."""
    import glob

    from dinunet_implementations_tpu_torch.data import freesurfer, native_io

    t0 = time.perf_counter()
    built = native_io._load() is not None
    build_s = time.perf_counter() - t0
    if not built:
        fail("the native aseg reader did not build (g++)")
    native_io.reset_counts()
    files = [sorted(glob.glob(os.path.join(tree, "input", f"local{i}", "simulatorRun",
                                           "*_aseg_stats.txt"))) for i in range(FS_SITES)]
    t0 = time.perf_counter()
    python = [np.stack([freesurfer.read_aseg_stats(f) for f in fs]) for fs in files]
    python_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native = [native_io.read_aseg_batch(fs, 66) for fs in files]
    native_ms = (time.perf_counter() - t0) * 1e3
    for i, (a, b) in enumerate(zip(native, python)):
        if a is None or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            fail(f"site {i}: the native reader's batch differs from the Python reader's")
    if native_io.READS != {"native": FS_SITES, "python": 0}:
        fail(f"aseg batch reads {native_io.READS}: a batch fell back to the Python reader")
    rec = {"subjects": [len(fs) for fs in files], "native_ms": native_ms,
           "python_ms": python_ms, "native_build_s": build_s}
    print(f"aseg readers, {sum(rec['subjects'])} files of 5 sites: native {native_ms:.3f} ms, "
          f"Python {python_ms:.3f} ms (g++ build {build_s:.2f} s), bit for bit on {smi}")
    return rec


def k7_routes(torch, pc, cfg, sites: int) -> dict:
    """``{r: [route, ...]}``: the route ``k7_geometry`` names for each K7
    launch of each rank class of the model of ``cfg`` at ``sites`` sites
    (``k7_launches``: one launch, or one for each 16 buckets), on gradients
    laid out as the engine hands them to K7 (``nn.Linear`` weights as
    transposed views); ``"plain"`` for a class K7 does not take (a rank
    above 16, iterates past the shared-memory limit)."""
    routes = {}
    for r, leaves in k7_leaves(torch, cfg).items():
        Gs = [torch.zeros((sites, n, m), device="cuda").transpose(1, 2) if tr
              else torch.zeros((sites, m, n), device="cuda") for _, m, n, tr in leaves]
        launches = pc.k7_launches(Gs, r)
        routes[r] = "plain" if launches is None else [
            k7_geometry_line(pc, [Gs[k] for k in ks], r, None)["route"] for ks in launches]
    return routes


def k7_want(launches: dict, routes: dict, rounds: int) -> dict:
    """The counts a path of ``rounds`` rankDAD rounds must show: each K7
    launch of each rank class once a round, on its route, and a class K7
    does not take counted once a round as sent to the plain version;
    nothing else."""
    want = dict.fromkeys(launches, 0)
    for route in routes.values():
        if route == "plain":
            want["poweriter_plain_classes"] += rounds
            continue
        for one in route:
            want["poweriter"] += rounds
            want[f"k7_{one}_route"] += rounds
    return want


def k7_phase(torch, pc, cfg, smi: str, sites: int, task: str) -> list[dict]:
    """K7 against its plain version at one rankDAD round's rank classes of
    the model of ``cfg`` at ``sites`` sites (f32, cold Ω, tol 1e-3), one
    record a launch of ``k7_launches`` (a class of more than 16 buckets is
    several), on the route the launcher picks; times, bound, route and
    counters. Trips are not compared (at 20 members one member a
    refinement apart is 5 % of them). A class K7 does not take is skipped:
    the engine sends it to the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = []
    for r, leaves in k7_leaves(torch, cfg).items():
        Gs_all = k7_gradients(torch, leaves, gen, sites=sites)
        launches = pc.k7_launches(Gs_all, r)
        if launches is None:
            continue
        cold_all, _ = k7_starts(torch, pc, leaves, Gs_all, r, gen)
        for i, ks in enumerate(launches):
            Gs, cold = [Gs_all[k] for k in ks], [cold_all[k] for k in ks]
            geo = k7_geometry_line(pc, Gs, r, None)
            before = (pc.POWERITER_STAGED_CALLS, pc.POWERITER_DIRECT_CALLS)
            got = pc.poweriter_fused(Gs, cold, K7_ITERS, 1e-3)
            torch.cuda.synchronize()
            took = {"staged": pc.POWERITER_STAGED_CALLS - before[0],
                    "direct": pc.POWERITER_DIRECT_CALLS - before[1]}
            if took != {"staged": int(geo["route"] == "staged"),
                        "direct": int(geo["route"] == "direct")}:
                fail(f"K7 {task} rank {r} launch {i}: took {took}, the geometry names "
                     f"{geo['route']}")
            want = pc.poweriter_plain(Gs, cold, K7_ITERS, 1e-3)
            rec = {"kernel": "poweriter", "task": task, "rank": r, "launch": i,
                   "launches": len(launches), "leaves": [leaves[k][0] for k in ks],
                   "members": sum(G.shape[0] for G in Gs), "shapes": [list(G.shape) for G in Gs],
                   "dtype": "f32", "start": "cold", "tol": 1e-3, "route": geo["route"],
                   "why": geo.get("why"), "route_counters": took,
                   "geometry": {k: v for k, v in geo.items() if k != "why"}}
            rec.update(k7_check(torch, f"{task} rank {r} launch {i}", Gs, r, got, want, "f32",
                                False))
            rec["ms"] = time_ms(lambda: pc.poweriter_fused(Gs, cold, K7_ITERS, 1e-3), 30)
            rec["plain_ms"] = time_ms(lambda: pc.poweriter_plain(Gs, cold, K7_ITERS, 1e-3), 5)
            rec["bound_ms"], rec["bound_by"] = k7_bound(Gs, r, got[2], False)
            rec["library_ms"] = None
            print(f"K7 {task} rank {r} launch {i + 1} of {len(launches)}: route {geo['route']} "
                  f"({geo.get('why', 'staged')}), {len(Gs)} buckets of {sites} sites, "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.6f} ms, P err {rec['P']:.3g} on {smi}")
            print(json.dumps(rec))
            out.append(rec)
    return out


def fs_fit(torch, np, lc, pc, bc, smi: str, engine: str, tree: str, out: str,
           routes: dict) -> dict:
    """One ``FedRunner`` fit of fold 0 on the FS tree (the default task),
    its epochs timed; launches counted, outputs and the best checkpoint
    checked."""
    from dinunet_implementations_tpu_torch.core.config import TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, native_io
    from dinunet_implementations_tpu_torch.runner import FedRunner, load_site_splits
    from dinunet_implementations_tpu_torch.trainer import FederatedTrainer, load_checkpoint

    runner = FedRunner(TrainConfig(agg_engine=engine, epochs=FS_EPOCHS, seed=0), tree, out)
    fcfg = runner.cfg
    a = fcfg.fs_args
    if (fcfg.task_id, a.input_size, tuple(a.hidden_sizes), a.num_class, fcfg.num_sites) != (
            FS_TASK, 66, (256, 128, 64, 32), 2, FS_SITES):
        fail(f"the FS fit's config is not MSANNet's full width: {fcfg.task_id}, {a}")
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // fcfg.local_iterations
    epoch_ms: list = []
    run_epoch = FederatedTrainer.run_epoch

    def timed_epoch(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_epoch(self, *args, **kw)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    FederatedTrainer.run_epoch = timed_epoch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases hold
        native_io.reset_counts()
        zero_counters(lc, pc, bc)  # the main path's run starts here
        t0 = time.perf_counter()
        res = runner.run(folds=[0], verbose=False)[0]
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counters(lc, pc, bc)  # read before any check
    finally:
        FederatedTrainer.run_epoch = run_epoch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_gb = peak_gb - base_gb
    epochs = len(res["epoch_losses"])
    want = (k7_want(launches, routes, epochs * rounds) if engine == "rankDAD"
            else dict.fromkeys(launches, 0))
    if launches != want:
        fail(f"FS {engine} fit launches {launches}, want {want}")
    if native_io.READS != {"native": FS_SITES, "python": 0}:
        fail(f"FS {engine} fit read its sites {native_io.READS}: a fallback to Python")
    finite = [np.isfinite(res[k]).all() for k in ("epoch_losses", "test_metrics")]
    if not all(finite) or not np.isfinite(list(res["test_scores"].values())).all():
        fail(f"the FS {engine} fit's losses or test metrics are not finite: {res}")
    outputs = check_fit_outputs(out, FS_TASK, FS_SITES)
    restored = load_checkpoint(outputs["best_checkpoint"], res["state"])
    for part in ("params", "batch_stats", "opt_state", "engine_state", "health"):
        if not same_tree(getattr(restored, part), getattr(res["state"], part)):
            fail(f"FS {engine}: checkpoint_best.msgpack {part} differ from the fit's best state")
    rec = {"card": smi, "engine": engine, "sites": FS_SITES,
           "split": {k: [len(s) for s in fold[k]] for k in ("train", "validation", "test")},
           "epochs": epochs, "rounds_per_epoch": rounds, "launches": launches,
           "fit_seconds": fit_s, "epoch_ms": epoch_ms, "warm_epoch_ms": epoch_ms[-1],
           "peak_memory_gb": peak_gb, "fit_memory_gb": fit_gb,
           "epoch_losses": res["epoch_losses"],
           "test_metrics": res["test_metrics"], "test_scores": res["test_scores"],
           "best_val_epoch": res["best_val_epoch"],
           "best_checkpoint_bytes": outputs["best_checkpoint_bytes"],
           "best_checkpoint": outputs["best_checkpoint"]}
    print(f"FS {engine} fit: {fit_s:.3f} s ({epochs} epochs of {rounds} rounds), warm epoch "
          f"{epoch_ms[-1]:.3f} ms, peak memory {peak_gb:.4f} GB ({fit_gb:.4f} GB over what "
          f"was allocated before the fit) on {smi}")
    return rec


def fs_kernel_vs_plain(torch, np, lc, pc, bc, cfg, fold: dict, routes: dict) -> dict:
    """One FS rankDAD epoch through K7 against the same epoch through the
    plain power iteration, from one state and one plan: the first round's
    aggregate within ``AGG_TOL``, its Ω within ``OMEGA_FIRST_TOL`` of each
    leaf's scale, the losses within phase 8's tolerances."""
    from dinunet_implementations_tpu_torch.data import plan_epoch_positions, stack_site_inventory
    from dinunet_implementations_tpu_torch.runner import build_training
    from dinunet_implementations_tpu_torch.trainer import init_train_state, make_train_epoch_fn

    inv = stack_site_inventory(fold["train"])
    plan = plan_epoch_positions(fold["train"], cfg.batch_size, seed=1, pad_mode="wrap")
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = torch.from_numpy(plan.positions).cuda()
    L = cfg.local_iterations
    runs = {}
    for use_kernel in (True, False):
        task, engine, opt = build_training(cfg, device="cuda", use_kernel=use_kernel)
        epoch = make_train_epoch_fn(task, engine, opt, L, cfg.quarantine_rounds, "cuda")
        start = init_train_state(task, engine, opt, rng=cfg.seed, num_sites=FS_SITES)
        zero_counters(lc, pc, bc)
        one, _ = epoch(start, inv_x, inv_y, idx[:, :L])
        end, losses = epoch(start, inv_x, inv_y, idx)
        torch.cuda.synchronize()
        runs[use_kernel] = (start, one, end, losses, read_counters(lc, pc, bc))
    (sk, one_k, _, lk, ck), (sp, one_p, _, lp, cp) = runs[True], runs[False]
    if not same_tree(sk.params, sp.params):
        fail("the FS kernel and plain epochs start from different weights")
    rounds = idx.shape[1] // L
    if ck != k7_want(ck, routes, 1 + rounds) or cp["poweriter"] != 0:
        fail(f"FS rankDAD epochs launched {ck} (kernel) and {cp} (plain)")
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    omega = lambda s: {k: v for k, v in s.engine_state["omega"].items()  # noqa: E731
                       if v is not None}
    first = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
             for g, w in zip(omega(one_k).values(), omega(one_p).values(), strict=True)]
    dl = (lk - lp).abs()
    checks = {"first_round_aggregate": tree_err(agg(one_k), agg(one_p), **AGG_TOL),
              "first_round_omega": (max(first), max(first) <= OMEGA_FIRST_TOL),
              "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
              "loss": (dl.max().item(), bool(lk.isfinite().all()) and dl.max().item() <= LOSS_TOL)}
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"the FS rankDAD epoch through K7 differs from the plain path in {bad}: {checks}")
    rec = {"rounds": rounds, "launches": ck,
           "max_abs_err_vs_plain": {k: e for k, (e, _) in checks.items()},
           "first_round_omega": leaf_errs(omega(one_k), omega(one_p))}
    print("FS rankDAD epoch, K7 against plain:", json.dumps(rec))
    return rec


def fs_serving(torch, np, smi: str, cfg, best: str, rows) -> dict:
    """``InferenceEngine(cfg, checkpoint=best)`` on the card answers one
    request a dispatch; each answer against the same forward through the
    port on the CPU."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.runner import build_model
    from dinunet_implementations_tpu_torch.trainer import FederatedTask, eval_forward
    from dinunet_implementations_tpu_torch.trainer.checkpoint import load_inference_state
    from dinunet_implementations_tpu_torch.weights import params_from_jax

    params, stats, _ = load_inference_state(best)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(params_from_jax(cfg, params, stats))
    task = FederatedTask(cpu.eval())
    reqs, at = [], 0
    for n in FS_REQUEST_ROWS:
        reqs.append(np.ascontiguousarray(rows[at:at + n]))
        at += n
    with InferenceEngine(cfg, checkpoint=best) as eng:
        eng.warmup()
        got = [eng.submit(r).result(timeout=120) for r in reqs]  # one request a dispatch
        summary = eng.summary()
    err = 0.0
    for r, g in zip(reqs, got):
        want = eval_forward(task, torch.from_numpy(r), None, torch.ones(len(r))).numpy()
        if g.shape != want.shape:
            fail(f"FS served answer shaped {g.shape}, want {want.shape}")
        err = max(err, float(np.abs(g - want).max()))
    if summary["dispatches"] != len(reqs) or err > FS_SERVE_TOL:
        fail(f"FS serving: {summary['dispatches']} dispatches for {len(reqs)} requests, "
             f"max abs err {err} against the CPU forward")
    rec = {"requests": [len(r) for r in reqs], "dispatches": summary["dispatches"],
           "max_abs_err_vs_cpu": err, "latency_ms_p50": summary["latency_ms_p50"]}
    print(f"FS serving: {len(reqs)} requests, one a dispatch, within {err:.3g} of the CPU "
          f"forward on {smi}")
    return rec


def fs_cli(torch, np, lc, pc, bc, smi: str, tree: str, root: str, routes: dict) -> dict:
    """The command line with no ``--task`` on the FS tree: a rankDAD fit of
    fold 0 after one epoch of largest-site pretraining, then ``--site 0``;
    launches counted for each part."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import TrainConfig
    from dinunet_implementations_tpu_torch.data import build_site_dataset, epoch_steps
    from dinunet_implementations_tpu_torch.data.splits import resolve_splits
    from dinunet_implementations_tpu_torch.runner import FedRunner, cli, load_site_splits
    from dinunet_implementations_tpu_torch.runner.registry import get_task, task_cache
    from dinunet_implementations_tpu_torch.trainer import FederatedTrainer

    out = os.path.join(root, "fs_cli")
    args = ["--data-path", tree, "--engine", "rankDAD", "--quiet"]
    fed_args = args + ["--folds", "0", "--epochs", str(FS_CLI_EPOCHS), "--out-dir", out,
                       "--set", "pretrain=true", "--set", 'pretrain_args={"epochs": 1}']
    runner = FedRunner(TrainConfig(agg_engine="rankDAD"), tree)
    fcfg = runner.cfg
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // fcfg.local_iterations
    pre: dict = {}
    pretrain = FederatedTrainer._pretrain

    def timed_pretrain(self, *a, **k):
        torch.cuda.synchronize()
        before, t0 = read_counters(lc, pc, bc), time.perf_counter()
        state = pretrain(self, *a, **k)
        torch.cuda.synchronize()
        pre["seconds"] = time.perf_counter() - t0
        pre["launches"] = {n: v - before[n] for n, v in read_counters(lc, pc, bc).items()}
        pre["site"] = int(np.argmax([len(s) for s in a[1]]))
        return state

    FederatedTrainer._pretrain = timed_pretrain
    try:
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)  # the main path's run starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as fed_out:
            rc = cli.main(fed_args)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counters(lc, pc, bc)  # read before any check
    finally:
        FederatedTrainer._pretrain = pretrain
    want = k7_want(launches, routes, FS_CLI_EPOCHS * rounds)
    if rc != 0 or launches != want or pre.get("launches") != dict.fromkeys(launches, 0):
        fail(f"FS cli fit exit code {rc}, launches {launches} (pretraining "
             f"{pre.get('launches')}), want {want} (pretraining none)")
    lines = [json.loads(x) for x in fed_out.getvalue().splitlines()]
    keys = ["fold", "test_loss", "test_auc", "best_val_epoch"]
    if (len(lines) != 1 or list(lines[0]) != keys or lines[0]["fold"] != 0
            or not np.isfinite([lines[0][k] for k in keys[1:3]]).all()):
        fail(f"FS cli fit printed {fed_out.getvalue()!r}")
    check_fit_outputs(out, FS_TASK, FS_SITES)

    # one site alone: SiteRunner's own split of site 0, one rankDAD fit of
    # one site (every class's members are one)
    scfg = runner.site_cfgs[0]
    ds = build_site_dataset(get_task(FS_TASK).dataset_cls, get_task(FS_TASK).handle_cls,
                            task_cache(scfg), {"baseDirectory": runner.site_dirs[0]})
    splits = resolve_splits(len(ds), split_ratio=scfg.split_ratio, num_folds=scfg.num_folds,
                            seed=scfg.seed)
    site_rounds = sum(len(sp["train"]) // scfg.batch_size // scfg.local_iterations
                      for sp in splits)
    site_routes = k7_routes(torch, pc, scfg, 1)
    zero_counters(lc, pc, bc)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as site_out:
        rc = cli.main(args + ["--site", "0", "--epochs", "1", "--out-dir",
                              os.path.join(root, "fs_cli_site")])
    torch.cuda.synchronize()
    site_s = time.perf_counter() - t0
    site_launches = read_counters(lc, pc, bc)
    want_site = k7_want(site_launches, site_routes, site_rounds)
    site_lines = [json.loads(x) for x in site_out.getvalue().splitlines()]
    if rc != 0 or site_launches != want_site or len(site_lines) != len(splits) or not np.isfinite(
            [site_lines[0][k] for k in keys[1:3]]).all():
        fail(f"FS cli --site 0: exit code {rc}, launches {site_launches}, want {want_site}, "
             f"printed {site_out.getvalue()!r}")
    rec = {"card": smi, "epochs": FS_CLI_EPOCHS, "rounds_per_epoch": rounds,
           "fit_seconds": fit_s, "pretrain_seconds": pre["seconds"],
           "pretrain_site": pre["site"], "launches": launches,
           "pretrain_launches": pre["launches"], "json_lines": lines, "site_seconds": site_s,
           "site_rounds": site_rounds, "site_routes": site_routes,
           "site_launches": site_launches, "site_json_lines": site_lines}
    print(f"FS cli (no --task): fit {fit_s:.3f} s, pretraining on site {pre['site']} "
          f"{pre['seconds']:.3f} s; --site 0 {site_s:.3f} s on {smi}")
    print("FS cli:", json.dumps(rec))
    return rec


def fs_phase(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """Phase 14 of the module docstring: the FS tree, the readers, the K7
    classes, the three fits, K7 against plain on an FS epoch, the served
    fit and the command line."""
    from dinunet_implementations_tpu_torch.core.config import TrainConfig
    from dinunet_implementations_tpu_torch.data import make_fs_demo_tree, plan_eval
    from dinunet_implementations_tpu_torch.runner import FedRunner, load_site_splits

    t_phase = time.perf_counter()
    tree = make_fs_demo_tree(os.path.join(root, "fs_tree"), n_sites=FS_SITES,
                             subjects=FS_SUBJECTS, seed=0)
    readers = fs_reader_phase(np, tree, smi)
    runner = FedRunner(TrainConfig(agg_engine="rankDAD"), tree)
    fcfg = runner.cfg
    routes = k7_routes(torch, pc, fcfg, FS_SITES)
    print(f"K7 routes at the FS classes, {FS_SITES} sites (k7_geometry): "
          + ", ".join(f"r={r} {v}" for r, v in routes.items()))
    k7 = k7_phase(torch, pc, fcfg, smi, FS_SITES, FS_TASK)
    fits = {e: fs_fit(torch, np, lc, pc, bc, smi, e, tree, os.path.join(root, f"fs_{e}"), routes)
            for e in FS_ENGINES}
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    vs_plain = fs_kernel_vs_plain(torch, np, lc, pc, bc, fcfg, fold, routes)
    fb = plan_eval(fold["test"], fcfg.batch_size)
    rows = fb.inputs[fb.weights > 0]
    serving = fs_serving(torch, np, smi, fcfg, fits["rankDAD"]["best_checkpoint"], rows)
    cli_rec = fs_cli(torch, np, lc, pc, bc, smi, tree, root, routes)
    rec = {"card": smi, "readers": readers, "k7_routes": routes, "k7": k7,
           "fits": fits, "rankdad_vs_plain": vs_plain, "serving": serving, "cli": cli_rec,
           "phase_seconds": time.perf_counter() - t_phase}
    for e in FS_ENGINES:
        f = fits[e]
        print(f"FS {e}: warm epoch {f['warm_epoch_ms']:.3f} ms, fit {f['fit_seconds']:.3f} s, "
              f"peak memory {f['peak_memory_gb']:.4f} GB ({f['fit_memory_gb']:.4f} GB over the "
              f"allocation before the fit), test {f['test_metrics']} on {smi}")
    print("fs:", json.dumps(rec))
    return rec


# The serving plane (phase 15): the unidirectional ICA-LSTM at full width
# (the default ICAArgs with bidirectional=False: one direction of 348),
# random weights from seed 0, written with the port's checkpoint writer and
# served from that file at the engine's default stream buckets (1, 4),
# chunk 8 and 32 slots.
PLANE_H = 348
PLANE_ROWS = (1, 4, 16)  # K1 on this path: one request, four rows, the largest row bucket
PLANE_SESSIONS, PLANE_WINDOWS = 8, 98
PLANE_CHUNKS = (1, 13)  # a client's ragged chunk sizes, inclusive
PLANE_STEP_RUNS = 50  # timed streaming steps a bucket
PLANE_LONG_RUNS = 6  # more whole sessions through one session id: the table stays put
PLANE_REQUESTS = 12  # batched requests mirrored before the first publish


def plane_cfg():
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig

    return TrainConfig(task_id=NNComputation.TASK_ICA, seed=0).with_overrides(
        {"ica_args": {"bidirectional": False}})


def plane_checkpoint(torch, cfg, path: str) -> dict:
    """The model of ``cfg`` with random weights from its seed and a head
    BatchNorm with non-trivial statistics, written with the port's
    checkpoint writer; returns its ``state_dict`` (CPU)."""
    from dinunet_implementations_tpu_torch.runner.registry import build_model
    from dinunet_implementations_tpu_torch.trainer.checkpoint import save_checkpoint
    from dinunet_implementations_tpu_torch.trainer.steps import TrainState
    from dinunet_implementations_tpu_torch.weights import leaf_table

    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        bn = model.cls_bn
        bn.running_mean.copy_(0.2 * torch.randn(256, generator=g))
        bn.running_var.copy_(0.5 + 1.5 * torch.rand(256, generator=g))
        bn.weight.copy_(1 + 0.2 * torch.randn(256, generator=g))
        bn.bias.copy_(0.1 * torch.randn(256, generator=g))
    sd = model.state_dict()
    table = leaf_table(cfg)
    save_checkpoint(path, TrainState(
        params={n: sd[n] for n, _, _ in table.params},
        batch_stats={n: sd[n] for n, _ in table.stats},
        opt_state={}, engine_state={}, rng=0, round=0, health={}), meta={"epoch": 0})
    return sd


def k1_plane_phase(torch, lc) -> list[dict]:
    """K1 at the width the unidirectional model runs (H = 348) and the rows
    of this path: the route and geometry the launcher picks, every output
    against the plain version, and the times of K1, the plain version and
    cuDNN's unidirectional ``torch.nn.LSTM`` beside the bound."""
    g = torch.Generator().manual_seed(0)
    out = []
    for rows in PLANE_ROWS:
        args = recurrence_args(torch, rows, g, h=PLANE_H)
        geo = geometry_line(torch, lc, rows, PLANE_H, None)
        want = lc.lstm_recurrence_plain(*args, None, residuals=True)
        got = lc.lstm_recurrence_fused(*args, None, residuals=True)
        torch.cuda.synchronize()
        err = compare(f"lstm_fwd H={PLANE_H} rows={rows} {geo['route']}", got, want, OUTPUTS,
                      F32_TOL)
        ms = time_ms(lambda: lc.lstm_recurrence_fused(*args, None), 30)
        plain_ms = time_ms(lambda: lc.lstm_recurrence_plain(*args, None), 20)
        library = library_lstm_ms(torch, args, want[0])
        b_ms, b_by = bound(rows, False, PLANE_H)
        rec = {"rows": rows, "H": PLANE_H, "dtype": "f32", "route": geo["route"], "geometry": geo,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **library, "bound_ms": b_ms,
               "bound_by": b_by}
        print(json.dumps(rec))
        out.append(rec)
    return out


def plane_counts(lc) -> dict:
    return {"lstm_fwd": lc.LAUNCHES, "k1_cluster_route": lc.K1_CLUSTER_CALLS,
            "k1_stream_route": lc.K1_STREAM_CALLS}


def plane_zero(lc) -> None:
    lc.LAUNCHES = lc.PROJ_LAUNCHES = lc.K1_CLUSTER_CALLS = lc.K1_STREAM_CALLS = 0


def plane_want(route: str, launches: int) -> dict:
    """The counts of ``launches`` K1 calls at H = 348, all on ``route``."""
    return {"lstm_fwd": launches, "k1_cluster_route": launches * (route == "cluster"),
            "k1_stream_route": launches * (route == "stream")}


def plane_sessions(np, rng, window_shape):
    """``PLANE_SESSIONS`` sessions of ``PLANE_WINDOWS`` windows, each cut
    into ragged chunks."""
    sessions = {}
    for i in range(PLANE_SESSIONS):
        seq = rng.standard_normal((PLANE_WINDOWS, *window_shape)).astype(np.float32)
        cuts, at = [], 0
        while at < PLANE_WINDOWS:
            n = int(rng.integers(PLANE_CHUNKS[0], PLANE_CHUNKS[1] + 1))
            cuts.append((at, min(at + n, PLANE_WINDOWS)))
            at += n
        sessions[f"plane-{i}"] = (seq, cuts)
    return sessions


def stream_phase(torch, np, eng, cpu_task) -> dict:
    """Phase 15's streaming part on a warm engine (module docstring)."""
    from dinunet_implementations_tpu_torch.trainer.steps import eval_forward

    rng = np.random.default_rng(15)
    sessions = plane_sessions(np, rng, eng.sample_shape[1:])
    finals = {}

    def client(names):
        # every session of this client advances one chunk a round, none awaited
        futs = {}
        for k in range(max(len(sessions[n][1]) for n in names)):
            for n in names:
                seq, cuts = sessions[n]
                if k < len(cuts):
                    futs[n] = eng.stream(n, seq[cuts[k][0]:cuts[k][1]])
        for n, f in futs.items():
            finals[n] = f.result(timeout=120)["probs"]

    names = sorted(sessions)
    threads = [threading.Thread(target=client, args=(names[k::2],)) for k in (0, 1)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in threads) or sorted(finals) != names:
        fail("not every streaming session was answered")
    seqs = np.stack([sessions[n][0] for n in names])
    batched = np.stack([eng.submit(s[None]).result(timeout=120)[0] for s in seqs])
    cpu = eval_forward(cpu_task, torch.from_numpy(seqs)).numpy()
    got = np.stack([finals[n] for n in names])
    if not np.isfinite(got).all() or got.shape != (PLANE_SESSIONS, 2):
        fail(f"streamed answers shaped {got.shape} or not finite")
    err_batched = float(np.abs(got - batched).max())
    err_cpu = float(np.abs(got - cpu).max())
    if max(err_batched, err_cpu) > SERVE_TOL:
        fail(f"streamed answers differ from the batched lane by {err_batched} and from the "
             f"CPU forward by {err_cpu}")
    # one session alone (bucket 1): chunk by chunk, each awaited, then the
    # whole run as one submission; and each concurrent session replayed
    # alone, which crosses buckets
    seq, cuts = sessions[names[0]]
    for lo, hi in cuts:
        for a in range(lo, hi, eng.stream_chunk):
            piece = seq[a:min(a + eng.stream_chunk, hi)]
            last = eng.stream("plane-chunked", piece).result(timeout=120)
    whole = eng.stream("plane-whole", seq).result(timeout=120)
    if not np.array_equal(last["probs"], whole["probs"]):
        fail(f"chunked {last['probs']} and one-submission {whole['probs']} answers differ")
    solo = np.stack([eng.stream("solo-" + n, sessions[n][0]).result(timeout=120)["probs"]
                     for n in names])
    cross_bucket = float(np.abs(got - solo).max())
    if cross_bucket > SERVE_TOL:
        fail(f"concurrent sessions differ from their solo replays by {cross_bucket}")
    # the O(1) table: the same tensors, shapes and bytes after more windows
    before = {k: (tuple(v.shape), v.numel() * v.element_size(), v.data_ptr())
              for k, v in eng._table.items()}
    for _ in range(PLANE_LONG_RUNS):
        eng.stream("plane-long", seq).result(timeout=120)
    after = {k: (tuple(v.shape), v.numel() * v.element_size(), v.data_ptr())
             for k, v in eng._table.items()}
    if after != before:
        fail(f"the carry table changed: {before} -> {after}")
    # one streaming step a bucket, timed on the host clock (it ends with the
    # answer on the host): pad slots only, an identity on the trash row
    a, t = eng.cfg.ica_args, eng.stream_chunk
    step_ms = {}
    for b in eng.stream_buckets:
        args = (np.full((b,), eng.sessions.trash_slot, np.int64), np.zeros((b,), np.float32),
                rng.standard_normal((b, t, a.num_components, a.window_size)).astype(np.float32),
                np.ones((b, t), np.float32), np.zeros((b,), np.float32))
        times = []
        for _ in range(PLANE_STEP_RUNS + 2):
            t0 = time.perf_counter()
            eng._stream_step(eng.weights(), *args)
            times.append((time.perf_counter() - t0) * 1e3)
        times = sorted(times[2:])
        step_ms[b] = {"p50": times[len(times) // 2],
                      "p99": times[min(int(0.99 * len(times)), len(times) - 1)]}
    summary = eng.summary()
    rec = {"sessions": PLANE_SESSIONS, "windows": PLANE_WINDOWS, "wall_s": wall,
           "chunks": sum(len(c) for _, c in sessions.values()),
           "max_abs_err_vs_batched": err_batched, "max_abs_err_vs_cpu": err_cpu,
           "cross_bucket_max_abs_diff": cross_bucket, "chunked_equals_whole": True,
           "carry_table": {k: v[:2] for k, v in after.items()},
           "step_ms": step_ms, "stream_latency_ms": {
               k: summary[k] for k in ("latency_ms_p50", "latency_ms_p99")},
           "sessions_occupied": summary["stream_sessions"],
           "evictions": summary["stream_evictions"], "stream_chunks": summary["stream_chunks"]}
    print(f"streaming: {PLANE_SESSIONS} sessions x {PLANE_WINDOWS} windows from two threads in "
          f"{wall:.3f} s; vs batched {err_batched:.3g}, vs CPU {err_cpu:.3g}, across buckets "
          f"{cross_bucket:.3g}; step ms " + ", ".join(
              f"bucket {b}: p50 {v['p50']:.3f} p99 {v['p99']:.3f}" for b, v in step_ms.items())
          + f"; {rec['sessions_occupied']} sessions occupied, {rec['evictions']} evictions")
    return rec


def publish_phase(torch, np, lc, eng, bus, cfg, device, route: str):
    """Phase 15's publish part on the streaming engine (module docstring):
    returns the record and the probe answers of the original and the
    candidate weights."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.serving import PublishController
    from dinunet_implementations_tpu_torch.trainer.checkpoint import params_digest
    from dinunet_implementations_tpu_torch.weights import _nest, _params_to_jax

    rng = np.random.default_rng(16)
    probes = {b: rng.standard_normal((b, *eng.sample_shape)).astype(np.float32)
              for b in eng.row_buckets}

    def answers(e):
        return {b: e.submit(x).result(timeout=120) for b, x in probes.items()}

    for _ in range(PLANE_REQUESTS):
        eng.submit(rng.standard_normal((int(rng.integers(1, 17)), *eng.sample_shape))
                   .astype(np.float32)).result(timeout=120)
    original = answers(eng)
    params, stats = eng.weights()
    jparams = _params_to_jax(params, eng.table)
    jstats = _nest({j: stats[n].cpu().numpy() for n, j in eng.table.stats})
    pc = PublishController(eng, bus=bus, p99_target_ms=1e-3, min_window_samples=20)
    pc.live_digest = params_digest(params, stats)
    rows = [pc.publish(jparams, jstats, digest=pc.live_digest)]
    nan = {k: dict(v) for k, v in jparams.items()}
    nan["cls_fc3"]["bias"] = np.full_like(nan["cls_fc3"]["bias"], np.nan)
    rows.append(pc.publish(nan, jstats, digest="nan-candidate"))
    after_reject = answers(eng)
    if not all(np.array_equal(after_reject[b], original[b]) for b in probes):
        fail("a rejected candidate moved the live answers")
    cand = _perturbed(np, jparams, np.random.default_rng(1))
    plane_zero(lc)
    rows.append(pc.publish(cand, jstats, digest=params_digest(cand, jstats)))
    shadow_launches = plane_counts(lc)
    outcomes = [r["outcome"] for r in rows]
    if outcomes != ["rejected-stale", "rejected-shadow", "swapped"]:
        fail(f"publish outcomes {outcomes}: {rows}")
    batches = rows[2]["shadow"]["batches"]
    if shadow_launches != plane_want(route, 2 * batches):
        fail(f"shadow scoring of {batches} mirrored batches launched {shadow_launches}")
    swapped = answers(eng)
    with InferenceEngine(cfg, params=cand, batch_stats=jstats, streaming=False,
                         device=device) as fresh:
        fresh.warmup()
        fresh_answers = answers(fresh)
    for b in probes:
        if not np.array_equal(swapped[b], fresh_answers[b]):
            fail(f"after the swap, rows {b} differ from a fresh engine's on the candidate")
    for _ in range(pc.min_window_samples):
        eng.submit(probes[1]).result(timeout=120)
    verdict = pc.check_rollback()
    if verdict is None or not verdict["rolled_back"]:
        fail(f"no rollback at a p99 target of {pc.p99_target_ms} ms: {verdict}")
    rolled = answers(eng)
    for b in probes:
        if not np.array_equal(rolled[b], original[b]):
            fail(f"after the rollback, rows {b} differ from the original weights' answers")
    built = eng.compiles_after_warmup()
    if any(built.values()):
        fail(f"kernel libraries built or loaded after warmup: {built}")
    rec = {"outcomes": outcomes + ["rolled-back"], "pause_ms": rows[2]["pause_ms"],
           "shadow": rows[2]["shadow"], "shadow_launches": shadow_launches,
           "rollback": verdict, "swaps": eng.stats["swaps"], "compiles_after_warmup": built,
           "swap_pause_hist": bus.snapshot()["histograms"].get("serving_swap_pause_ms")}
    print(f"publish: stale, shadow-rejected, swapped (pause {rec['pause_ms']} ms, "
          f"{shadow_launches['lstm_fwd']} K1 launches for {batches} mirrored batches), rolled "
          f"back at burn {verdict['burn']}; nothing built after warmup")
    return rec, cand, jstats, fresh_answers, probes


def _perturbed(np, tree, noise):
    """``tree`` with every leaf moved by 0.01 of a standard normal draw."""
    if isinstance(tree, dict):
        return {k: _perturbed(np, tree[k], noise) for k in sorted(tree)}
    return (tree + 0.01 * noise.standard_normal(tree.shape)).astype(np.float32)


def fleet_phase(torch, np, lc, cfg, ckpt, eng, cand, cand_stats, cand_answers, probes,
                device, route: str) -> dict:
    """Phase 15's fleet part (module docstring): two replicas on the one
    card against the single engine ``eng`` (on the original weights again)."""
    from dinunet_implementations_tpu_torch.serving import ReplicaSet, home_slot
    from dinunet_implementations_tpu_torch.telemetry import MetricsBus

    rng = np.random.default_rng(17)
    fleet = ReplicaSet(cfg, replicas=2, checkpoint=ckpt, bus=MetricsBus(), devices=[device],
                       supervise_interval_s=0.05)
    try:
        fleet.warmup()
        plane_zero(lc)
        for b, x in probes.items():
            if not np.array_equal(fleet.submit(x).result(timeout=120),
                                  eng.submit(x).result(timeout=120)):
                fail(f"the fleet's answer at rows {b} differs from the single engine's")
        fleet_launches = plane_counts(lc)
        if fleet_launches != plane_want(route, 2 * len(probes)):
            fail(f"fleet and engine launched {fleet_launches} for {2 * len(probes)} dispatches")
        sids = [f"fleet-{i}" for i in range(6)]
        for sid in sids:
            fleet.stream(sid, rng.standard_normal((12, *eng.sample_shape[1:])).astype(
                np.float32)).result(timeout=120)
        for sid in sids:
            where = [i for i, e in enumerate(fleet._engines) if e.sessions.slot_of(sid) is not None]
            if where != [home_slot(sid, 2)] or fleet.replica_of(sid) != home_slot(sid, 2):
                fail(f"session {sid} lives on {where}, home {home_slot(sid, 2)}")
        fleet.swap_params(cand, cand_stats)
        victim = next(f"victim-{i}" for i in range(100) if home_slot(f"victim-{i}", 2) == 0)
        seq = rng.standard_normal(eng.sample_shape).astype(np.float32)
        step = eng.stream_chunk  # one chunk a submission: each answer is its chunk's
        ref = [fleet.stream(victim, seq[lo:lo + step]).result(timeout=120)["probs"]
               for lo in range(0, PLANE_WINDOWS, step)]
        gen = fleet.table.generation_of("replica-0")
        t0 = time.monotonic()
        fleet.kill_replica(0)
        while not (fleet.restarts >= 1 and fleet._replica_alive(0)):
            if time.monotonic() - t0 > 120:
                fail("replica 0 was not restarted within 120 s")
            time.sleep(0.005)
        restart_s = time.monotonic() - t0
        if fleet.table.generation_of("replica-0") != gen + 1:
            fail(f"replica 0 came back at generation {fleet.table.generation_of('replica-0')}")
        if fleet.replica_of(victim) is not None:
            fail("the restart kept the route of a session homed on replica 0")
        got = [fleet.stream(victim, seq[lo:lo + step]).result(timeout=120)
               for lo in range(0, PLANE_WINDOWS, step)]
        if not got[0]["restarted"] or not all(np.array_equal(a["probs"], b)
                                              for a, b in zip(got, ref)):
            fail("the re-homed session's replay differs from its first run")
        for b, x in probes.items():
            if not np.array_equal(fleet._engines[0].submit(x).result(timeout=120),
                                  cand_answers[b]):
                fail(f"the restarted replica does not serve the current weights (rows {b})")
        status = fleet.status()
    finally:
        summary = fleet.close()
    rec = {"replicas": 2, "restart_s": restart_s, "generation": gen + 1,
           "launches": fleet_launches, "membership": status["membership"],
           "requests": summary["requests"], "swaps": summary["swaps"],
           "compiles_after_warmup": summary["compiles_after_warmup"]}
    if summary["compiles_after_warmup"]:
        fail(f"the fleet built or loaded kernels after warmup: {summary}")
    print(f"fleet: 2 replicas on one card, bit for bit the single engine at rows "
          f"{sorted(probes)}; replica 0 restarted in {restart_s:.3f} s at generation {gen + 1}, "
          f"serving the current weights")
    return rec


def serving_plane_phase(torch, np, lc, smi: str, root: str) -> dict:
    """Phase 15 of the module docstring."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.runner.registry import build_model
    from dinunet_implementations_tpu_torch.serving.engine import DEFAULT_ROW_BUCKETS
    from dinunet_implementations_tpu_torch.telemetry import MetricsBus
    from dinunet_implementations_tpu_torch.trainer.steps import FederatedTask

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    k1 = k1_plane_phase(torch, lc)
    cfg = plane_cfg()
    routes = {b: lc.device_geometry(device, b, PLANE_H, None)["route"]
              for b in sorted(set(PLANE_ROWS) | set(DEFAULT_ROW_BUCKETS))}
    if len(set(routes.values())) != 1:
        fail(f"K1 takes several routes on this path: {routes}")
    ckpt = os.path.join(root, "plane", "checkpoint_best.msgpack")
    sd = plane_checkpoint(torch, cfg, ckpt)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(sd)
    cpu_task = FederatedTask(cpu.eval())
    bus = MetricsBus()
    with InferenceEngine(cfg, checkpoint=ckpt, bus=bus) as eng:
        warm = eng.warmup()
        plane_zero(lc)
        x = np.random.default_rng(5).standard_normal((1, *eng.sample_shape)).astype(np.float32)
        eng.submit(x).result(timeout=120)
        one = plane_counts(lc)
        if one != plane_want(routes[1], 1):
            fail(f"one batched dispatch launched {one}")
        stream = stream_phase(torch, np, eng, cpu_task)
        publish, cand, cand_stats, cand_answers, probes = publish_phase(
            torch, np, lc, eng, bus, cfg, device, routes[1])
        fleet = fleet_phase(torch, np, lc, cfg, ckpt, eng, cand, cand_stats, cand_answers,
                            probes, device, routes[1])
    rec = {"card": smi, "k1": k1, "k1_routes": routes, "warmup_s": warm,
           "batched_dispatch_launches": one,
           "stream": stream, "publish": publish, "fleet": fleet,
           "phase_seconds": time.perf_counter() - t_phase}
    print(f"serving plane: K1 at H={PLANE_H} on the {routes[1]} route, "
          + ", ".join(f"rows {r['rows']} {r['ms']:.3f} ms (bound {r['bound_ms']:.4f}, plain "
                      f"{r['plain_ms']:.3f}, cuDNN {r['library_ms']:.3f})" for r in k1)
          + f"; swap pause {publish['pause_ms']} ms; replica restart {fleet['restart_s']:.3f} s; "
          f"phase {rec['phase_seconds']:.1f} s on {smi}")
    print("serving plane:", json.dumps(rec, default=float))
    return rec


# The remaining workloads (phase 16): the 3D-CNN of sMRI volumes and the
# multimodal FS+ICA transformer at the JAX package's bench_matrix.py
# widths. sMRI: 8 sites of per-site batch 4, 64³ volumes folded by the
# pipeline to 32³ x 8, channels (16, 32, 64, 128). Multimodal: 64 sites of
# per-site batch 8, 66 FS values and 98 windows of 100 x 10 a sample, embed
# 256, 8 heads, 4 blocks. Each epoch has A9_ROUNDS rounds (every site holds
# A9_ROUNDS batches); the fits' trees hold fewer sites than the epochs.
A9_SMRI, A9_MM = "sMRI-3D-Classification", "Multimodal-Classification"
A9_SHAPES = {A9_SMRI: {"sites": 8, "batch": 4}, A9_MM: {"sites": 64, "batch": 8}}
A9_ROUNDS = 2
A9_ENGINES = ("dSGD", "rankDAD", "powerSGD")
A9_FIT = {A9_SMRI: {"sites": 8, "subjects": 20}, A9_MM: {"sites": 8, "subjects": 20}}
A9_FIT_EPOCHS, A9_CLI_EPOCHS = 3, 2
A9_SMRI_VOLUME = (64, 64, 64)


def a9_cfg(task: str, engine: str, bf16: bool):
    """The full-width configuration of ``task`` at its bench shape; the
    sMRI volumes folded by the pipeline (``space_to_depth``)."""
    from dinunet_implementations_tpu_torch.core.config import TrainConfig

    shape = A9_SHAPES[task]
    over = {"compute_dtype": "bfloat16" if bf16 else ""}
    if task == A9_SMRI:
        over["space_to_depth"] = True
    return TrainConfig(task_id=task, agg_engine=engine, num_sites=shape["sites"],
                       batch_size=shape["batch"], learning_rate=TRAIN_LR).with_overrides(over)


def a9_data(torch, cfg, seed: int = 16):
    """A resident inventory of ``A9_ROUNDS`` batches a site, made on the
    card (random samples of the task's shape, random labels), and one
    epoch's index plan ``[S, A9_ROUNDS, B]``."""
    from dinunet_implementations_tpu_torch.runner.registry import get_task

    g = torch.Generator(device="cuda").manual_seed(seed)
    S, B = cfg.num_sites, cfg.batch_size
    n = A9_ROUNDS * B
    shape = tuple(get_task(cfg.task_id).serving.sample_shape(cfg))
    inv_x = torch.randn((S, n) + shape, generator=g, device="cuda")
    inv_y = torch.randint(0, 2, (S, n), generator=g, device="cuda")
    idx = torch.stack([torch.randperm(n, generator=g, device="cuda") for _ in range(S)])
    return inv_x, inv_y, idx.reshape(S, A9_ROUNDS, B)


def a9_training(torch, cfg, use_kernel: bool = True):
    from dinunet_implementations_tpu_torch.runner import build_training
    from dinunet_implementations_tpu_torch.trainer import init_train_state, make_train_epoch_fn

    task, engine, opt = build_training(cfg, device="cuda", use_kernel=use_kernel)
    epoch = make_train_epoch_fn(task, engine, opt, cfg.local_iterations, cfg.quarantine_rounds,
                                "cuda")
    return epoch, init_train_state(task, engine, opt, rng=cfg.seed, num_sites=cfg.num_sites)


def a9_epochs(torch, lc, pc, bc, smi: str, task: str, engine: str, bf16: bool,
              routes: dict) -> dict:
    """A cold and a warm epoch of ``task`` under ``engine`` through the
    entry points (``build_training``, ``make_train_epoch_fn``): the warm
    epoch's ms and the peak memory over what was allocated before;
    launches counted (K7 once a launch of ``k7_launches`` and round on
    its route, a class K7 does not take sent to the plain version; nothing
    else)."""
    cfg = a9_cfg(task, engine, bf16)
    inv_x, inv_y, idx = a9_data(torch, cfg)
    epoch, state = a9_training(torch, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    ms, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, lo = epoch(state, inv_x, inv_y, idx)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lo)
    launches = read_counters(lc, pc, bc)  # read before any check
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    want = (k7_want(launches, routes, 2 * A9_ROUNDS) if engine == "rankDAD"
            else dict.fromkeys(launches, 0))
    loss = torch.cat(losses)
    if launches != want or not bool(loss.isfinite().all()):
        fail(f"{task} {engine} {'bf16' if bf16 else 'f32'} epochs launched {launches}, want "
             f"{want}; losses {loss.tolist()}")
    shape = A9_SHAPES[task]
    rec = {"task": task, "engine": engine, "dtype": "bf16" if bf16 else "f32",
           "sites": shape["sites"], "batch": shape["batch"], "rounds": A9_ROUNDS,
           "cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1],
           "samples_per_s": shape["sites"] * shape["batch"] * A9_ROUNDS / (ms[1] / 1e3),
           "peak_memory_over_baseline_gb": peak_gb, "launches": launches,
           "losses": loss.tolist()}
    print(f"{task} {engine} {rec['dtype']}: warm epoch {ms[1]:.3f} ms ({A9_ROUNDS} rounds, cold "
          f"{ms[0]:.3f}), {rec['samples_per_s']:.1f} samples/s, peak {peak_gb:.4f} GB over the "
          f"baseline, K7 {launches['poweriter']} launches, {launches['poweriter_plain_classes']} "
          f"plain classes on {smi}")
    return rec


def a9_kernel_vs_plain(torch, lc, pc, bc, task: str, bf16: bool, routes: dict) -> dict:
    """One rankDAD epoch of ``task`` through K7 against the same epoch with
    ``use_kernel=False`` (the all-plain path), from one state and one plan,
    at phase 8's tolerances: the first round's aggregate within
    ``AGG_TOL``, its Ω within ``OMEGA_FIRST_TOL`` of each leaf's scale
    (``a9_omega_errs``: every member's ΩΩᵀ, and Ω itself but for at most
    ``K7_TRIPS_DIFFER_SHARE`` of the members), the first loss within
    ``FIRST_LOSS_TOL`` and every loss within ``LOSS_TOL``. The dropout masks are the same draws on both paths, and
    both run cuDNN's deterministic algorithms, so that the two paths
    factor the same gradients: with its default algorithms the same bf16
    round run twice gives gradients apart by bf16 roundings (the
    ``repeat_spread`` this prints, the first round's aggregate of two such
    runs)."""
    cfg = a9_cfg(task, "rankDAD", bf16)
    inv_x, inv_y, idx = a9_data(torch, cfg, seed=17)
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for use_kernel in (True, False):
            epoch, start = a9_training(torch, cfg, use_kernel)
            zero_counters(lc, pc, bc)
            one, _ = epoch(start, inv_x, inv_y, idx[:, :1])
            _, losses = epoch(start, inv_x, inv_y, idx)
            torch.cuda.synchronize()
            runs[use_kernel] = (start, one, losses, read_counters(lc, pc, bc))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    epoch, start = a9_training(torch, cfg)
    twice = [agg(epoch(start, inv_x, inv_y, idx[:, :1])[0]) for _ in range(2)]
    repeat_spread = tree_err(*twice)[0]
    (sk, one_k, lk, ck), (sp, one_p, lp, cp) = runs[True], runs[False]
    if not same_tree(sk.params, sp.params):
        fail(f"the {task} kernel and plain epochs start from different weights")
    classes = len(routes)
    if (ck != k7_want(ck, routes, 1 + A9_ROUNDS) or cp["poweriter"] != 0
            or cp["poweriter_plain_classes"] != 0 or ck["poweriter"] == 0):
        fail(f"{task} rankDAD epochs launched {ck} (kernel) and {cp} (plain), {classes} classes")
    omega = lambda s: {k: v for k, v in s.engine_state["omega"].items()  # noqa: E731
                       if v is not None}
    om = a9_omega_errs(omega(one_k), omega(one_p))
    dl = (lk - lp).abs()
    checks = {"first_round_aggregate": tree_err(agg(one_k), agg(one_p), **AGG_TOL),
              "first_round_omega_gram": (om["gram"], om["gram"] <= OMEGA_FIRST_TOL),
              "first_round_omega_members_over": (om["over"], om["over"] <= K7_TRIPS_DIFFER_SHARE
                                                 * om["members"]),
              "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
              "loss": (dl.max().item(), bool(lk.isfinite().all()) and dl.max().item() <= LOSS_TOL)}
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"the {task} rankDAD epoch through K7 differs from the plain path in {bad}: "
             f"{checks}, Ω {om}")
    rec = {"task": task, "dtype": "bf16" if bf16 else "f32", "rounds": A9_ROUNDS,
           "launches": ck, "max_abs_err_vs_plain": {k: e for k, (e, _) in checks.items()},
           "first_round_omega": om, "repeat_spread": repeat_spread}
    print(f"{task} rankDAD epoch {rec['dtype']}, K7 against plain:", json.dumps(rec))
    return rec


def a9_omega_errs(got: dict, want: dict) -> dict:
    """rankDAD's first-round Ω through K7 (``got``) against the plain path
    (``want``), ``{leaf: [S, n, r]}``, per member over its leaf's max: ``Ω``
    itself (its largest error ``omega``, and ``over``, the members over
    ``OMEGA_FIRST_TOL`` of ``members``) and ``ΩΩᵀ``, which is ``QQᵀ =
    (PQᵀ)ᵀ(PQᵀ)``, the same for any basis of the member's subspace
    (``gram``, the largest). A member whose gradient has rank below r
    (``σ_r`` at rounding, as some multimodal leaves at 8 samples a site)
    decides its early exit on that noise column's σ: the two paths can
    stop it a refinement apart (as ``K7_TRIPS_DIFFER_SHARE`` allows in
    phase 7), and that refinement rotates its columns within the same
    subspace (measured 7.4e-4 of Ω, 5.1e-5 of PQᵀ, trips 4 against 5)."""
    e_om, e_gram, over, members = 0.0, 0.0, 0, 0
    for g, w in zip(got.values(), want.values(), strict=True):
        e = (g - w).abs().amax((1, 2)) / max(w.abs().max().item(), 1e-30)
        gg, ww = g @ g.mT, w @ w.mT
        eg = (gg - ww).abs().amax((1, 2)) / max(ww.abs().max().item(), 1e-30)
        # a NaN counts as over every limit (Python's max would drop it)
        e, eg = e.nan_to_num(nan=float("inf")), eg.nan_to_num(nan=float("inf"))
        e_om, e_gram = max(e_om, e.max().item()), max(e_gram, eg.max().item())
        over += int((e > OMEGA_FIRST_TOL).sum())
        members += e.numel()
    return {"omega": e_om, "gram": e_gram, "over": over, "members": members}


def a9_attention(torch, smi: str) -> list[dict]:
    """The multimodal model's local attention (two products and an f32
    softmax, ``models/transformer.py:dot_product_attention``) at its
    training shape, 512 rows of 100 tokens, 8 heads of 32, beside
    ``F.scaled_dot_product_attention`` on the same q, k, v: a yardstick,
    used nowhere in the port."""
    from dinunet_implementations_tpu_torch.models.transformer import dot_product_attention

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(18)
    rows = A9_SHAPES[A9_MM]["sites"] * A9_SHAPES[A9_MM]["batch"]
    out = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((rows, 100, 8, 32), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        local = dot_product_attention(q, k, v)
        sdpa = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
        err = (local.float() - sdpa.transpose(1, 2).float()).abs().max().item()
        rec = {"rows": rows, "tokens": 100, "heads": 8, "head_dim": 32,
               "dtype": "f32" if dt == torch.float32 else "bf16",
               "local_ms": time_ms(lambda: dot_product_attention(q, k, v), 30),
               "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   *(t.transpose(1, 2) for t in (q, k, v))), 30),
               "max_abs_diff": err}
        print(f"attention {rec['dtype']}: local {rec['local_ms']:.4f} ms, SDPA "
              f"{rec['sdpa_ms']:.4f} ms, {err:.3g} apart on {smi}")
        out.append(rec)
    return out


def a9_smri_tree(np, root: str) -> str:
    """An sMRI tree of the JAX tests' layout (tests/test_extensions.py
    ``_make_smri_tree``: ``volumes.npz`` and ``labels.csv`` a site, label-1
    volumes shifted by 1.5) at 64³, its inputspec the full-width model with
    the pipeline fold."""
    fit = A9_FIT[A9_SMRI]
    rng = np.random.default_rng(11)
    spec = []
    for i in range(fit["sites"]):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        os.makedirs(d)
        y = rng.integers(0, 2, fit["subjects"])
        X = rng.standard_normal((fit["subjects"],) + A9_SMRI_VOLUME, dtype=np.float32)
        X += (y[:, None, None, None] * 1.5).astype(np.float32)
        np.savez(os.path.join(d, "volumes.npz"), X)
        with open(os.path.join(d, "labels.csv"), "w") as fh:
            fh.write("index,label\n" + "".join(f"{j},{int(y[j])}\n" for j in range(len(y))))
        spec.append({"task_id": {"value": A9_SMRI}, "data_file": {"value": "volumes.npz"},
                     "labels_file": {"value": "labels.csv"},
                     "volume_shape": {"value": list(A9_SMRI_VOLUME)},
                     "space_to_depth": {"value": True}})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh)
    return root


def a9_mm_tree(root: str) -> str:
    """The port's ``make_multimodal_demo_tree`` at full width (66 FS
    values, 100 components of 980 timepoints, windows of 10), its
    inputspec's narrow transformer dropped for the default one."""
    from dinunet_implementations_tpu_torch.data import make_multimodal_demo_tree

    fit = A9_FIT[A9_MM]
    make_multimodal_demo_tree(root, n_sites=fit["sites"], subjects=fit["subjects"],
                              n_features=66, comps=100, temporal=980, window=10, stride=10)
    path = os.path.join(root, "inputspec.json")
    with open(path) as fh:
        spec = json.load(fh)
    for site in spec:
        for k in ("embed_dim", "num_heads", "num_layers"):
            site.pop(k)
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return root


def a9_fit(torch, np, lc, pc, bc, smi: str, task: str, tree: str, out: str) -> dict:
    """A rankDAD ``FedRunner`` fit of fold 0 for ``A9_FIT_EPOCHS`` epochs on
    the tree, K7 counted; outputs and the best checkpoint checked; then
    ``InferenceEngine`` serves the best checkpoint, each of the trainer's
    eval steps of a site (its real rows) one request and one dispatch,
    within ``SERVE_TOL`` of the trainer's eval probabilities."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.core.config import TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_eval
    from dinunet_implementations_tpu_torch.runner import FedRunner, build_model, load_site_splits
    from dinunet_implementations_tpu_torch.trainer import (
        FederatedTask,
        load_checkpoint,
        make_eval_fn,
    )

    runner = FedRunner(TrainConfig(agg_engine="rankDAD", epochs=A9_FIT_EPOCHS,
                                   batch_size=A9_SHAPES[task]["batch"]), tree, out)
    fcfg = runner.cfg
    sites = A9_FIT[task]["sites"]
    if fcfg.task_id != task or fcfg.num_sites != sites:
        fail(f"the {task} tree's config names {fcfg.task_id}, {fcfg.num_sites} sites")
    routes = k7_routes(torch, pc, fcfg, sites)
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // fcfg.local_iterations
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    res = runner.run(folds=[0], verbose=False)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # read before any check
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    epochs = len(res["epoch_losses"])
    want = k7_want(launches, routes, epochs * rounds)
    if launches != want or launches["poweriter"] == 0:
        fail(f"{task} fit launches {launches}, want {want}")
    if not np.isfinite(res["epoch_losses"]).all() or not np.isfinite(res["test_metrics"]).all():
        fail(f"the {task} fit's losses or test metrics are not finite: {res['epoch_losses']}")
    outputs = check_fit_outputs(out, task, sites)
    restored = load_checkpoint(outputs["best_checkpoint"], res["state"])
    for part in ("params", "opt_state", "engine_state"):
        if not same_tree(getattr(restored, part), getattr(res["state"], part)):
            fail(f"{task}: checkpoint_best.msgpack {part} differ from the fit's best state")

    fb = plan_eval(fold["test"], fcfg.batch_size)
    eval_fn = make_eval_fn(FederatedTask(build_model(fcfg)), "cuda")
    probs = eval_fn(res["state"], fb.inputs, fb.labels, fb.weights)[0].cpu().numpy()
    reqs = [(s, k) for s in range(fb.inputs.shape[0]) for k in range(fb.inputs.shape[1])
            if fb.weights[s, k].sum() > 0]
    err = 0.0
    with InferenceEngine(fcfg, checkpoint=outputs["best_checkpoint"]) as eng:
        eng.warmup()
        for s, k in reqs:  # one request a dispatch: the site's rows of one eval step
            keep = fb.weights[s, k] > 0
            got = eng.submit(np.ascontiguousarray(fb.inputs[s, k][keep])).result(timeout=120)
            err = max(err, float(np.abs(got - probs[s, k][keep]).max()))
        summary = eng.summary()
    if summary["dispatches"] != len(reqs) or err > SERVE_TOL:
        fail(f"{task} serving: {summary['dispatches']} dispatches for {len(reqs)} requests, "
             f"{err} from the trainer's eval")
    rec = {"task": task, "card": smi, "sites": sites, "subjects": A9_FIT[task]["subjects"],
           "split": {k: [len(s) for s in fold[k]] for k in ("train", "validation", "test")},
           "epochs": epochs, "rounds_per_epoch": rounds, "routes": routes,
           "launches": launches, "fit_seconds": fit_s, "peak_memory_over_baseline_gb": peak_gb,
           "epoch_losses": res["epoch_losses"], "test_metrics": res["test_metrics"],
           "best_checkpoint_bytes": outputs["best_checkpoint_bytes"],
           "serving": {"requests": len(reqs), "dispatches": summary["dispatches"],
                       "max_abs_err_vs_trainer_eval": err,
                       "latency_ms_p50": summary["latency_ms_p50"]}}
    print(f"{task} rankDAD fit: {fit_s:.3f} s ({epochs} epochs of {rounds} rounds, {sites} "
          f"sites), K7 {launches['poweriter']}, plain classes "
          f"{launches['poweriter_plain_classes']}, peak {peak_gb:.4f} GB; served "
          f"{len(reqs)} requests within {err:.3g} of the trainer's eval on {smi}")
    return rec


def a9_cli(torch, np, lc, pc, bc, smi: str, task: str, tree: str, out: str) -> dict:
    """The command line on the tree (its inputspec names the task) under
    rankDAD, fold 0, K7 counted; the JSON line parsed."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps
    from dinunet_implementations_tpu_torch.runner import FedRunner, cli, load_site_splits

    batch = A9_SHAPES[task]["batch"]
    runner = FedRunner(TrainConfig(agg_engine="rankDAD", batch_size=batch), tree)
    fold = load_site_splits(runner.cfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], batch)
    routes = k7_routes(torch, pc, runner.cfg, runner.cfg.num_sites)
    args = ["--data-path", tree, "--engine", "rankDAD", "--folds", "0", "--epochs",
            str(A9_CLI_EPOCHS), "--batch-size", str(batch), "--quiet", "--out-dir", out]
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = cli.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)
    want = k7_want(launches, routes, A9_CLI_EPOCHS * rounds)
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    keys = ["fold", "test_loss", "test_auc", "best_val_epoch"]
    if (rc != 0 or launches != want or len(lines) != 1 or list(lines[0]) != keys
            or not np.isfinite([lines[0][k] for k in keys[1:3]]).all()):
        fail(f"{task} cli: exit code {rc}, launches {launches}, want {want}, printed "
             f"{printed.getvalue()!r}")
    check_fit_outputs(out, task, runner.cfg.num_sites)
    rec = {"task": task, "seconds": cli_s, "epochs": A9_CLI_EPOCHS, "rounds_per_epoch": rounds,
           "routes": routes, "launches": launches, "json_lines": lines}
    print(f"{task} cli (rankDAD): {cli_s:.3f} s, K7 {launches['poweriter']}, plain classes "
          f"{launches['poweriter_plain_classes']} on {smi}")
    return rec


def a9_phase(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """Phase 16 of the module docstring: for each model, the K7 routes of
    its rank classes, K7 against plain at them, warm dSGD, rankDAD and
    powerSGD epochs in f32 and bf16, the rankDAD epoch against the
    all-plain path, a rankDAD fit served from its best checkpoint; the
    command line on the multimodal tree; the attention yardstick."""
    t_phase = time.perf_counter()
    rec: dict = {"card": smi, "models": {}}
    for task in (A9_SMRI, A9_MM):
        cfg = a9_cfg(task, "rankDAD", False)
        sites = A9_SHAPES[task]["sites"]
        routes = k7_routes(torch, pc, cfg, sites)
        print(f"K7 routes at the {task} classes, {sites} sites (k7_launches, k7_geometry): "
              + ", ".join(f"r={r} {v}" for r, v in routes.items()))
        k7 = k7_phase(torch, pc, cfg, smi, sites, task)
        epochs = [a9_epochs(torch, lc, pc, bc, smi, task, e, bf16, routes)
                  for bf16 in (False, True) for e in A9_ENGINES]
        vs_plain = [a9_kernel_vs_plain(torch, lc, pc, bc, task, bf16, routes)
                    for bf16 in (False, True)]
        tree = os.path.join(root, f"a9_tree_{len(rec['models'])}")
        t0 = time.perf_counter()
        if task == A9_SMRI:
            a9_smri_tree(np, tree)
        else:
            a9_mm_tree(tree)
        tree_s = time.perf_counter() - t0
        fit = a9_fit(torch, np, lc, pc, bc, smi, task, tree, os.path.join(tree, "out"))
        fit["tree_seconds"] = tree_s
        rec["models"][task] = {"k7_routes": routes, "k7": k7, "epochs": epochs,
                               "rankdad_vs_plain": vs_plain, "fit": fit, "tree": tree}
    rec["cli"] = a9_cli(torch, np, lc, pc, bc, smi, A9_MM, rec["models"][A9_MM]["tree"],
                        os.path.join(root, "a9_cli"))
    rec["attention"] = a9_attention(torch, smi)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    for task, m in rec["models"].items():
        for e in m["epochs"]:
            print(f"{task} {e['engine']} {e['dtype']}: warm epoch {e['warm_epoch_ms']:.3f} ms, "
                  f"peak {e['peak_memory_over_baseline_gb']:.4f} GB over the baseline on {smi}")
    print(f"phase 16 in {rec['phase_seconds']:.1f} s on {smi}")
    print("a9:", json.dumps(rec, default=float))
    return rec


# -- phase 17: hostile and faulty sites ------------------------------------------

HOSTILE_MODES = ("norm_clip", "trimmed_mean", "coordinate_median")
HOSTILE_ENGINES = ("dSGD", "rankDAD", "powerSGD")
HOSTILE_FIT_EPOCHS, HOSTILE_CLI_EPOCHS = 3, 2
# The kernel and plain paths under the plans, held at phase 8's tolerances:
# the first round's aggregate within AGG_TOL, powerSGD's q and e within
# PSGD_FIRST_TOL of their largest value, the first loss within
# FIRST_LOSS_TOL, the health counters equal after the first round and the
# anomaly score within HOSTILE_FIRST_ANOMALY_TOL. From the second round on
# the params part on the lr scale (phase 8), so the later losses and the
# health after the epochs are held against the plain path run again on
# inputs nudged by a relative 1e-7: each loss within LOSS_TOL or
# HOSTILE_SPREAD_FACTOR times that run's spread (powerSGD's median measured
# 1.14e-3 > LOSS_TOL, the nudged run 1.02e-3 apart); each int health field
# equal to the plain run's or to the nudged run's (a suspect decision
# within the reference's own spread of the threshold); the anomaly score
# within HOSTILE_SPREAD_FACTOR times the nudged run's spread or
# HOSTILE_ANOMALY_TOL, whichever is larger. The floor is set from the 9
# pairs' readings (PERF.md, PR 17): the spread bound held 8 of them; dSGD
# norm_clip's nudged run parted by only 6.2e-5 while the kernel path parted
# by 1.74e-3 (z 0.016 apart). 3e-3 is above that with room for the
# rounding a change of the reduction order brings, and below the
# honest sites' scores (0.01-0.05) that a wrong kernel would move whole.
HOSTILE_SPREAD_FACTOR = 4.0
HOSTILE_FIRST_ANOMALY_TOL, HOSTILE_ANOMALY_TOL = 1e-4, 3e-3


def hostile_plans():
    """The phase's ``FaultPlan`` and ``AttackPlan`` over the 32 training
    sites, in global rounds: site 5 dropped for rounds 1-3, site 7 a
    straggler for rounds 2-3, flaky sites at 5 %, site 9's inputs NaN for
    rounds 0-2 (quarantined at the default 3 rounds); sign-flip on sites
    10-12, scale x10 on 13, noise on 14, free-rider on 15 and a colluding
    pair 16 and 17, each over its own window."""
    from dinunet_implementations_tpu_torch.robustness import AttackPlan, FaultPlan

    faults = FaultPlan(drop=((5, 1, 3),), delay_at=((7, 2, 2),), flaky_prob=0.05,
                       flaky_seed=17, nan_at=((0, 9), (1, 9), (2, 9)))
    attacks = AttackPlan(sign_flip=((10, 0, -1), (11, 1, -1), (12, 0, 4)),
                         scale=((13, 1, 5),), scale_factor=10.0, noise=((14, 0, 3),),
                         noise_std=1e-3, noise_seed=5, free_rider=((15, 2, -1),),
                         collude=((16, 1, -1), (17, 1, -1)), collude_seed=9, collude_scale=5.0)
    return faults, attacks


def hostile_setup(torch, use_kernel: bool, engine: str, mode: str, attacks):
    """Phase 6's configuration (32 sites of batch 16, default ``ICAArgs``,
    dropout 0) under ``engine`` and ``robust_agg=mode``, through
    ``build_training`` and ``make_train_epoch_fn`` with the attack plan
    and the config's reputation knobs; its first state."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine,
                      robust_agg=mode)
    task, eng, opt = build_training(cfg, use_kernel=use_kernel)
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, eng, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds, attack_plan=attacks,
                                robust_agg=mode, reputation_z=cfg.reputation_z,
                                reputation_rounds=cfg.reputation_rounds)
    return cfg, epoch, init_train_state(task, eng, opt, rng=0, num_sites=cfg.num_sites,
                                        reputation=mode != "none")


def hostile_masks(np, faults, attacks, round0: int, rounds: int):
    """``(live, poison, attack)`` of the round window, as the trainer feeds
    them (``attack`` None without an attack plan)."""
    from dinunet_implementations_tpu_torch.robustness import attack_window, fault_window

    live, nan = fault_window(faults, TRAIN_SITES, round0, rounds)
    return (live, None if nan is None else nan.astype(np.float32),
            attack_window(attacks, TRAIN_SITES, round0, rounds))


def hostile_run(torch, np, epoch, state, inv_x, inv_y, idx, faults, attacks):
    """The phase's two epochs (cold, then warm) from ``state``, each on its
    window of the global round counter: their states, losses, ms and the
    reputation layer's z-scores."""
    out, ms, losses, zs, round0 = state, [], [], [], 0
    for e in range(TRAIN_EPOCHS):
        rounds = idx[e].shape[1]
        masks = hostile_masks(np, faults, attacks, round0, rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lo = epoch(out, inv_x, inv_y, idx[e], *masks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lo)
        zs.extend(epoch.reputation_z_trace)
        round0 += rounds
    return out, torch.cat(losses), ms, (torch.cat(zs) if zs else None)


def leaf_check(got: dict, want: dict, tol) -> tuple[float, bool]:
    """Per leaf, ``got`` against ``want`` within ``tol(w)`` elementwise: the
    largest error and whether every leaf is finite and within."""
    err, ok = 0.0, True
    for k, w in want.items():
        if w is None:
            continue
        g, w = got[k].float(), w.float()
        d = (g - w).abs()
        ok &= bool(g.isfinite().all()) and bool((d <= tol(w)).all())
        err = max(err, d.max().item())
    return err, ok


def hostile_pair(torch, np, lc, pc, bc, smi: str, engine: str, mode: str, inv_x, inv_y, idx,
                 faults, attacks) -> dict:
    """One engine under one mode: the two epochs through the kernels (timed,
    launches counted, peak memory over the baseline) and through the plain
    versions, the first round of each and the plain path's nudged first
    round, held to each other (module docstring, phase 17)."""
    cfg, epoch_k, start_k = hostile_setup(torch, True, engine, mode, attacks)
    _, epoch_p, start_p = hostile_setup(torch, False, engine, mode, attacks)
    if not same_tree(start_k.params, start_p.params):
        fail(f"hostile {engine} {mode}: the kernel and plain paths start from different weights")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    st_k, lk, ms, zk = hostile_run(torch, np, epoch_k, start_k, inv_x, inv_y, idx, faults,
                                   attacks)
    launches = read_counters(lc, pc, bc)  # read before any check
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    st_p, lp, _, zp = hostile_run(torch, np, epoch_p, start_p, inv_x, inv_y, idx, faults,
                                  attacks)
    # the plain path again on inputs nudged by a relative 1e-7: its own spread
    g = torch.Generator(device=inv_x.device).manual_seed(23)
    nudged_x = inv_x * (1 + 1e-7 * torch.randn(inv_x.shape, generator=g, device=inv_x.device))
    st_n, ln, _, zn = hostile_run(torch, np, epoch_p, start_p, nudged_x, inv_y, idx, faults,
                                  attacks)

    # the first round: kernel and plain
    first = hostile_masks(np, faults, attacks, 0, 1)
    one_k, _ = epoch_k(start_k, inv_x, inv_y, idx[0][:, :1], *first)
    one_p, _ = epoch_p(start_p, inv_x, inv_y, idx[0][:, :1], *first)
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    rounds = sum(q.shape[1] for q in idx)
    dl, loss_spread = (lk - lp).abs(), (ln - lp).abs().max().item()
    agg_tol = lambda w: AGG_TOL["atol"] + AGG_TOL["rtol"] * w.abs()  # noqa: E731
    checks = {"first_round_aggregate": leaf_check(agg(one_k), agg(one_p), agg_tol),
              "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
              "loss": (dl.max().item(), bool(lk.isfinite().all()) and dl.max().item()
                       <= max(LOSS_TOL, HOSTILE_SPREAD_FACTOR * loss_spread)),
              "loss_spread": (loss_spread, True)}
    if engine == "rankDAD":
        omega = lambda st: {k: v for k, v in st.engine_state["omega"].items()  # noqa: E731
                            if v is not None}
        om = a9_omega_errs(omega(one_k), omega(one_p))
        checks["first_round_omega_gram"] = (om["gram"], om["gram"] <= OMEGA_FIRST_TOL)
        checks["first_round_omega_members_over"] = (
            om["over"], om["over"] <= K7_TRIPS_DIFFER_SHARE * om["members"])
    if engine == "powerSGD":
        for key in ("q", "e"):
            share = lambda w: PSGD_FIRST_TOL * w.abs().max()  # noqa: E731
            checks[f"first_round_{key}"] = leaf_check(one_k.engine_state[key],
                                                      one_p.engine_state[key], share)
    # the health counters: after the first round equal to the plain path's;
    # after the epochs equal to the plain path's or to its nudged run's (a
    # suspect decision within the reference's own spread of the threshold)
    for when, hk, hps in (("first_round_", one_k.health, [one_p.health]),
                          ("", st_k.health, [st_p.health, st_n.health])):
        for k in ("streak", "skips", "quarantined", "suspect_streak"):
            same = any(torch.equal(hk[k], h[k]) for h in hps)
            checks[f"{when}health_{k}"] = (0.0 if same else 1.0, same)
    anomaly_gap = lambda a, b: (a["anomaly"] - b["anomaly"]).abs().max().item()  # noqa: E731
    da = anomaly_gap(one_k.health, one_p.health)
    checks["first_round_health_anomaly"] = (da, da <= HOSTILE_FIRST_ANOMALY_TOL)
    da, spread = anomaly_gap(st_k.health, st_p.health), anomaly_gap(st_n.health, st_p.health)
    checks["health_anomaly"] = (da, da <= max(HOSTILE_ANOMALY_TOL,
                                              HOSTILE_SPREAD_FACTOR * spread))
    checks["health_anomaly_spread"] = (spread, True)
    live = zk.isfinite()
    margin = (zk[live] - cfg.reputation_z).abs().min().item() if bool(live.any()) else None
    z_apart = (zk - zp).nan_to_num(0.0).abs().max().item()
    z_spread = (zn - zp).nan_to_num(0.0).abs().max().item()
    if not torch.equal(live, zp.isfinite()):
        checks["z_sites_alike"] = (1.0, False)
    L = cfg.local_iterations
    n = 2 * rounds * L  # one K1 and one K2 a direction and micro-batch
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": n, "lstm_proj": n, "k1_cluster_route": n, "lstm_bwd": n,
        "k2_cluster_route": n}
    if engine == "rankDAD":  # one K7 a rank class and round, staged
        want["poweriter"] = want["k7_staged_route"] = len(k7_leaves(torch)) * rounds
    rec = {"engine": engine, "robust_agg": mode, "sites": TRAIN_SITES, "batch": TRAIN_BATCH,
           "rounds": rounds, "cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1],
           "warm_ms_per_round": ms[1] / idx[1].shape[1],
           "peak_memory_over_baseline_gb": peak_gb, "launches": launches,
           "max_abs_err_vs_plain": {k: v for k, (v, _) in checks.items()},
           "z_margin_to_threshold": margin, "z_kernel_vs_plain": z_apart,
           "z_plain_spread": z_spread,
           "health": {k: v.tolist() for k, v in st_k.health.items()},
           "losses": lk.tolist()}
    print(f"hostile {engine} {mode}: warm epoch {ms[1]:.3f} ms ({idx[1].shape[1]} rounds, cold "
          f"{ms[0]:.3f}), peak {peak_gb:.4f} GB over the baseline, nearest z to the threshold "
          f"{margin}, z kernel vs plain {z_apart:.3g} (plain's spread {z_spread:.3g}), on "
          f"{smi}:", json.dumps(rec))
    if launches != want:
        fail(f"hostile {engine} {mode} launches {launches}, want {want}")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"hostile {engine} {mode} differs from the plain path in {bad}: {checks}")
    if int(st_k.health["quarantined"][9]) != 1:
        fail(f"hostile {engine} {mode}: site 9's three NaN rounds did not quarantine it: "
             f"{rec['health']}")
    return rec


def hostile_baseline(torch, np, engine: str, inv_x, inv_y, idx, faults, mode: str = "none",
                     attacks=None) -> dict:
    """The same two epochs through the kernels under ``engine`` and
    ``mode``, with ``attacks`` or none: against ``robust_agg="none"`` with
    no attack, the cost of the defence."""
    _, epoch, start = hostile_setup(torch, True, engine, mode, attacks)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, lo, ms, _ = hostile_run(torch, np, epoch, start, inv_x, inv_y, idx, faults, attacks)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not bool(lo[1:].isfinite().all()):
        fail(f"hostile baseline {engine}: losses {lo.tolist()}")
    return {"cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1],
            "warm_ms_per_round": ms[1] / idx[1].shape[1], "peak_memory_over_baseline_gb": peak_gb}


def hostile_effect(torch, np, engine: str, inv_x, inv_y, idx, faults, attacks) -> dict:
    """Information only: under each mode, the cosine of round 0's aggregate
    (an attacked round: two sign-flips and a noise site) with the same
    round's aggregate under that mode without the attack
    (``vs_no_attack``), and with the clean weighted mean (``robust_agg=
    "none"``, no attack: ``vs_clean_mean``)."""
    def flat_agg(mode, plan):
        _, epoch, start = hostile_setup(torch, True, engine, mode, plan)
        one, _ = epoch(start, inv_x, inv_y, idx[0][:, :1], *hostile_masks(np, faults, plan, 0, 1))
        return torch.cat([m.flatten() / 0.1 for m in one.opt_state["mu"].values()])

    def cos(a, b):
        return (a @ b / (a.norm() * b.norm()).clamp(min=1e-30)).item()

    clean_mean = flat_agg("none", None)
    out = {}
    for mode in ("none",) + HOSTILE_MODES:
        attacked = flat_agg(mode, attacks)
        out[mode] = {"vs_no_attack": cos(attacked, flat_agg(mode, None) if mode != "none"
                                         else clean_mean),
                     "vs_clean_mean": cos(attacked, clean_mean)}
    return out


def hostile_fit(torch, np, lc, pc, bc, smi: str, tree: str, out: str, faults, attacks) -> dict:
    """A rankDAD ``trimmed_mean`` ``FedRunner`` fit on phase 11's tree with
    both plans: launches, ``logs.json``'s anomaly keys, and the best
    checkpoint back bit for bit, the reputation fields included."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_eval
    from dinunet_implementations_tpu_torch.runner import FedRunner, load_site_splits
    from dinunet_implementations_tpu_torch.trainer import load_checkpoint

    runner = FedRunner(TrainConfig(task_id=NNComputation.TASK_ICA, seed=0), tree, out,
                       fault_plan=faults, attack_plan=attacks, epochs=HOSTILE_FIT_EPOCHS,
                       agg_engine="rankDAD", robust_agg="trimmed_mean")
    fcfg = runner.cfg
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    L = fcfg.local_iterations
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // L
    eval_steps = {k: plan_eval(fold[k], fcfg.batch_size).steps for k in ("validation", "test")}
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    res = runner.run(folds=[0], verbose=False)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # read before any check
    epochs = len(res["epoch_losses"])
    micro = epochs * rounds * L
    evals = epochs * eval_steps["validation"] + eval_steps["test"]
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": 2 * (micro + evals), "lstm_proj": 2 * (micro + evals),
        "k1_cluster_route": 2 * (micro + evals), "lstm_bwd": 2 * micro,
        "k2_cluster_route": 2 * micro}
    want["poweriter"] = want["k7_staged_route"] = len(k7_leaves(torch)) * epochs * rounds
    if launches != want:
        fail(f"hostile fit launches {launches}, want {want}")
    d = os.path.join(out, "remote", "simulatorRun", fcfg.task_id, "fold_0")
    with open(os.path.join(d, "logs.json")) as fh:
        remote = json.load(fh)
    with open(os.path.join(out, "local3", "simulatorRun", fcfg.task_id, "fold_0",
                           "logs.json")) as fh:
        local = json.load(fh)
    if (len(remote.get("site_anomaly_score", [])) != FIT_SITES
            or "site_suspect_streak" not in remote or "anomaly_score" not in local):
        fail(f"the hostile fit's logs.json lacks the anomaly keys: {sorted(remote)}, "
             f"{sorted(local)}")
    best = os.path.join(d, "checkpoint_best.msgpack")
    back = load_checkpoint(best, res["state"])
    for part in ("params", "batch_stats", "opt_state", "engine_state", "health"):
        if not same_tree(getattr(back, part), getattr(res["state"], part)):
            fail(f"the hostile fit's checkpoint_best.msgpack {part} differ from its best state")
    if back.health["anomaly"].dtype != torch.float32 or set(back.health) != {
            "streak", "skips", "quarantined", "suspect_streak", "anomaly"}:
        fail(f"the hostile fit's checkpoint health reads back as {back.health}")
    if not np.isfinite(res["test_metrics"]).all():
        fail(f"the hostile fit's test metrics are not finite: {res['test_metrics']}")
    rec = {"seconds": fit_s, "epochs": epochs, "rounds_per_epoch": rounds, "launches": launches,
           "epoch_losses": res["epoch_losses"], "test_metrics": res["test_metrics"],
           "site_anomaly_score": remote["site_anomaly_score"],
           "site_quarantined": remote["site_quarantined"],
           "site_skipped_rounds": remote["site_skipped_rounds"]}
    print(f"hostile fit rankDAD trimmed_mean: {fit_s:.1f} s on {smi}:", json.dumps(rec))
    return rec


def hostile_cli(torch, np, lc, pc, bc, smi: str, tree: str, out: str, faults, attacks) -> dict:
    """``runner.cli.main`` on phase 11's tree with ``--faults @file
    --attacks '<json>' --robust-agg coordinate_median``: launches, the
    printed line, the anomaly keys."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_eval
    from dinunet_implementations_tpu_torch.runner import FedRunner, cli, load_site_splits

    os.makedirs(out, exist_ok=True)
    fpath = os.path.join(out, "faults.json")
    with open(fpath, "w") as fh:
        json.dump(faults.to_json(), fh)
    args = ["--data-path", tree, "--task", NNComputation.TASK_ICA, "--folds", "0", "--epochs",
            str(HOSTILE_CLI_EPOCHS), "--out-dir", out, "--quiet", "--faults", f"@{fpath}",
            "--attacks", json.dumps(attacks.to_json()), "--robust-agg", "coordinate_median"]
    runner = FedRunner(TrainConfig(task_id=NNComputation.TASK_ICA), tree)
    fcfg = runner.cfg
    fold = load_site_splits(fcfg, runner.site_dirs, runner.site_cfgs)[0]
    L = fcfg.local_iterations
    rounds = epoch_steps(fold["train"], fcfg.batch_size) // L
    eval_steps = {k: plan_eval(fold[k], fcfg.batch_size).steps for k in ("validation", "test")}
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = cli.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # read before any check
    micro = HOSTILE_CLI_EPOCHS * rounds * L
    evals = HOSTILE_CLI_EPOCHS * eval_steps["validation"] + eval_steps["test"]
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": 2 * (micro + evals), "lstm_proj": 2 * (micro + evals),
        "k1_cluster_route": 2 * (micro + evals), "lstm_bwd": 2 * micro,
        "k2_cluster_route": 2 * micro}
    lines = printed.getvalue().splitlines()
    if rc != 0 or launches != want or len(lines) != 1:
        fail(f"hostile cli exit code {rc}, launches {launches}, want {want}, printed {lines}")
    line = json.loads(lines[0])
    with open(os.path.join(out, "remote", "simulatorRun", fcfg.task_id, "fold_0",
                           "logs.json")) as fh:
        remote = json.load(fh)
    if "site_anomaly_score" not in remote or not np.isfinite(line["test_loss"]):
        fail(f"hostile cli printed {line}, logs.json keys {sorted(remote)}")
    rec = {"seconds": cli_s, "launches": launches, "line": line,
           "site_quarantined": remote["site_quarantined"]}
    print(f"hostile cli coordinate_median: {cli_s:.1f} s on {smi}:", json.dumps(rec))
    return rec


def hostile_phase(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """Phase 17 of the module docstring: every engine under every robust
    mode with both plans, through the kernels against the plain versions;
    the cost and the effect of the defence; a fit and the command line."""
    t_phase = time.perf_counter()
    faults, attacks = hostile_plans()
    cfg = hostile_setup(torch, True, "dSGD", "none", None)[0]
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q).cuda() for q in plans]
    pairs = [hostile_pair(torch, np, lc, pc, bc, smi, engine, mode, inv_x, inv_y, idx, faults,
                          attacks)
             for engine in HOSTILE_ENGINES for mode in HOSTILE_MODES]
    # the cost of the defence, warm ms a round over robust_agg="none" with
    # no attack: each mode with the attack (the pairs' own epochs), each
    # mode without it (the defence alone) and "none" with it (the attack
    # alone)
    cost = {}
    for engine in HOSTILE_ENGINES:
        base = hostile_baseline(torch, np, engine, inv_x, inv_y, idx, faults)
        cost[engine] = {"none_no_attack": base,
                        "none_attacked": hostile_baseline(torch, np, engine, inv_x, inv_y, idx,
                                                          faults, "none", attacks)}
        for p in pairs:
            if p["engine"] != engine:
                continue
            alone = hostile_baseline(torch, np, engine, inv_x, inv_y, idx, faults,
                                     p["robust_agg"])
            cost[engine][p["robust_agg"]] = {
                "warm_ms_per_round": p["warm_ms_per_round"],
                "no_attack_warm_ms_per_round": alone["warm_ms_per_round"],
                "peak_memory_over_baseline_gb": p["peak_memory_over_baseline_gb"]}
        for v in cost[engine].values():
            for key in ("warm_ms_per_round", "no_attack_warm_ms_per_round"):
                if key in v:
                    v["extra_" + key] = v[key] - base["warm_ms_per_round"]
    print(f"hostile cost of the defence on {smi}:", json.dumps(cost))
    effect = {engine: hostile_effect(torch, np, engine, inv_x, inv_y, idx, faults, attacks)
              for engine in HOSTILE_ENGINES}
    print("hostile effect (information only; cosine of round 0's aggregate under attack with "
          "the same mode's without it, and with the clean weighted mean):", json.dumps(effect))
    fit = hostile_fit(torch, np, lc, pc, bc, smi, tree, os.path.join(root, "hostile_fit"),
                      faults, attacks)
    cli_rec = hostile_cli(torch, np, lc, pc, bc, smi, tree, os.path.join(root, "hostile_cli"),
                          faults, attacks)
    seconds = time.perf_counter() - t_phase
    print(f"hostile phase {seconds:.1f} s on {smi}")
    return {"pairs": pairs, "cost": cost, "effect": effect, "fit": fit, "cli": cli_rec,
            "seconds": seconds}


# -- phase 18: elastic and durable rounds ---------------------------------------

ELASTIC_BOUND, ELASTIC_DECAY = 2, 0.5
ELASTIC_ENGINES = ("dSGD", "rankDAD", "powerSGD")
ELASTIC_OVERLAP_ENGINES = ("dSGD", "rankDAD")
# the kill fit: phase 11's tree (2 rounds an epoch), 3 epochs of dSGD, the
# kill crossed in epoch 2; the command line's: 2 epochs, crossed in epoch 1
ELASTIC_KILL_ROUND, ELASTIC_CLI_KILL_ROUND = 3, 1
# the daemon: an ICA tree of 6 sites at the flagship width over 8 slots,
# buffered-async, a leave after epoch 1 and the rejoin after epoch 2
DAEMON_SITES, DAEMON_CAPACITY, DAEMON_EPOCHS = 6, 8, 4


def elastic_plan():
    """The phase's ``FaultPlan`` over the 32 training sites: two stragglers
    of 2 rounds (site 3 from round 0, site 8 from round 3, across the epoch
    boundary) and a drop of site 20 in round 5."""
    from dinunet_implementations_tpu_torch.robustness import FaultPlan

    return FaultPlan(delay_at=((3, 0, 2), (8, 3, 2)), drop=((20, 5, 5),))


def elastic_setup(torch, use_kernel: bool, engine: str, **modes):
    """Phase 6's configuration (32 sites of batch 16, default ``ICAArgs``,
    dropout 0) under ``engine``, its epoch with ``modes``
    (``staleness_bound``/``staleness_decay`` or ``overlap_rounds``) and its
    first state with the buffers or the stash."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine)
    task, eng, opt = build_training(cfg, use_kernel=use_kernel)
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, eng, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds, **modes)
    return cfg, epoch, init_train_state(
        task, eng, opt, rng=0, num_sites=cfg.num_sites,
        staleness_bound=modes.get("staleness_bound", 0),
        overlap_rounds=modes.get("overlap_rounds", False))


def elastic_run(torch, np, epoch, state, inv_x, inv_y, idx, plan, chunks=None):
    """The epochs of ``idx`` from ``state``, each on its window of the global
    round counter under ``plan`` (every site live when None), in calls of
    ``chunks`` rounds (a whole epoch a call when None): the state, the
    losses and each call's ms."""
    from dinunet_implementations_tpu_torch.robustness import fault_window

    out, ms, losses, round0 = state, [], [], 0
    for q in idx:
        step = chunks or q.shape[1]
        for c in range(0, q.shape[1], step):
            part = q[:, c:c + step]
            live = (None if plan is None
                    else fault_window(plan, TRAIN_SITES, round0, part.shape[1])[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lo = epoch(out, inv_x, inv_y, part, live)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lo)
            round0 += part.shape[1]
    return out, torch.cat(losses), ms


def elastic_want(torch, launches: dict, engine: str, rounds: int) -> dict:
    """One K1 and one K2 a direction and round on the cluster route; one K7
    a rank class and round on the staged route under rankDAD."""
    n = 2 * rounds
    want = dict.fromkeys(launches, 0) | {
        "lstm_fwd": n, "lstm_proj": n, "k1_cluster_route": n, "lstm_bwd": n,
        "k2_cluster_route": n}
    if engine == "rankDAD":
        want["poweriter"] = want["k7_staged_route"] = len(k7_leaves(torch)) * rounds
    return want


def elastic_pair(torch, np, lc, pc, bc, smi: str, engine: str, mode: str, inv_x, inv_y, idx,
                 plan) -> dict:
    """One engine under one mode (``"async"``: ``staleness_bound`` 2 and
    decay 0.5 under ``plan``; ``"overlap"``: ``overlap_rounds``) through the
    kernels (timed, launches counted) and through the plain versions, held
    to each other at phase 8's tolerances (module docstring, phase 18)."""
    modes = (dict(staleness_bound=ELASTIC_BOUND, staleness_decay=ELASTIC_DECAY)
             if mode == "async" else dict(overlap_rounds=True))
    cfg, epoch_k, start_k = elastic_setup(torch, True, engine, **modes)
    _, epoch_p, start_p = elastic_setup(torch, False, engine, **modes)
    if not same_tree(start_k.params, start_p.params):
        fail(f"elastic {engine} {mode}: the kernel and plain paths start from different weights")
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    st_k, lk, ms = elastic_run(torch, np, epoch_k, start_k, inv_x, inv_y, idx, plan)
    launches = read_counters(lc, pc, bc)  # read before any check
    st_p, lp, _ = elastic_run(torch, np, epoch_p, start_p, inv_x, inv_y, idx, plan)
    rounds = sum(q.shape[1] for q in idx)
    # the first aggregate: after the first round (async: its buffers), or
    # after the second (overlap: round 0's stash applies at round 1)
    first = 1 if mode == "async" else 2
    one = [elastic_run(torch, np, ep, s0, inv_x, inv_y, [idx[0][:, :first]], plan)[0]
           for ep, s0 in ((epoch_k, start_k), (epoch_p, start_p))]
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    dl = (lk - lp).abs()
    agg_tol = lambda w: AGG_TOL["atol"] + AGG_TOL["rtol"] * w.abs()  # noqa: E731
    checks = {"first_aggregate": leaf_check(agg(one[0]), agg(one[1]), agg_tol)}
    if mode == "async":
        checks["first_loss"] = (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL)
        checks["loss"] = (dl.max().item(), bool(lk.isfinite().all())
                          and dl.max().item() <= LOSS_TOL)
        for key in ("age", "weight"):
            same = torch.equal(st_k.buffers[key], st_p.buffers[key])
            checks[f"buffers_{key}"] = (0.0 if same else 1.0, same)
        stale = int((st_k.buffers["age"] > ELASTIC_BOUND).sum())
    else:
        # the first round applies nothing (NaN on both); the stash carries
        # across the epoch boundary (the second epoch's first loss is finite)
        nan0 = bool(lk[0].isnan()) and bool(lp[0].isnan())
        checks["first_round_nan"] = (0.0 if nan0 else 1.0, nan0)
        e2 = idx[0].shape[1]
        carried = bool(lk[e2].isfinite()) and float(st_k.overlap["valid"].min()) == 1.0
        checks["stash_carried"] = (0.0 if carried else 1.0, carried)
        checks["first_loss"] = (dl[1].item(), dl[1].item() <= FIRST_LOSS_TOL)
        checks["loss"] = (dl[1:].max().item(), bool(lk[1:].isfinite().all())
                          and dl[1:].max().item() <= LOSS_TOL)
        stale = None
    if engine == "rankDAD":
        omega = lambda st: {k: v for k, v in st.engine_state["omega"].items()  # noqa: E731
                            if v is not None}
        om = a9_omega_errs(omega(one[0]), omega(one[1]))
        checks["first_omega_gram"] = (om["gram"], om["gram"] <= OMEGA_FIRST_TOL)
    want = elastic_want(torch, launches, engine, rounds)
    rec = {"engine": engine, "mode": mode, "sites": TRAIN_SITES, "batch": TRAIN_BATCH,
           "rounds": rounds, "cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1],
           "warm_ms_per_round": ms[1] / idx[1].shape[1], "launches": launches,
           "max_abs_err_vs_plain": {k: v for k, (v, _) in checks.items()},
           "slots_past_the_bound": stale, "losses": lk.tolist(), "plain_losses": lp.tolist()}
    print(f"elastic {engine} {mode}: warm epoch {ms[1]:.3f} ms ({idx[1].shape[1]} rounds, cold "
          f"{ms[0]:.3f}) on {smi}:", json.dumps(rec))
    if launches != want:
        fail(f"elastic {engine} {mode} launches {launches}, want {want}")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"elastic {engine} {mode} differs from the plain path in {bad}: {checks}")
    return rec


def elastic_all_arrivals(torch, np, engine: str, inv_x, inv_y, idx) -> dict:
    """Every site arriving every round: the async epoch through the kernels
    equals the bulk-sync epoch through the kernels, bit for bit; the two
    warm epochs' ms (the bulk-sync one is phase 6's round)."""
    runs = []
    for modes in ({}, dict(staleness_bound=ELASTIC_BOUND, staleness_decay=ELASTIC_DECAY)):
        _, epoch, start = elastic_setup(torch, True, engine, **modes)
        runs.append(elastic_run(torch, np, epoch, start, inv_x, inv_y, idx, None))
    (sync, ls, ms_s), (asy, la, ms_a) = runs
    same = torch.equal(ls, la) and all(
        same_tree(getattr(sync, part), getattr(asy, part))
        for part in ("params", "batch_stats", "opt_state", "engine_state", "health"))
    if not same:
        fail(f"elastic {engine}: an all-arrivals async run differs from the bulk-sync run")
    return {"engine": engine, "bit_equal": same, "sync_warm_epoch_ms": ms_s[1],
            "async_warm_epoch_ms": ms_a[1]}


def elastic_kill(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """A ``kill_at_round`` fit on phase 11's tree: ``Preempted`` with exit
    code 75 after epoch 2's checkpoint; ``resume=True`` ends bit-equal to
    the uninterrupted fit; the command line exits 75, then 0 with
    ``--resume``. Launches: the killed and the resumed runs together make
    the uninterrupted run's."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.robustness import FaultPlan, Preempted
    from dinunet_implementations_tpu_torch.runner import FedRunner, cli
    from dinunet_implementations_tpu_torch.trainer import load_meta

    def runner(out, plan):
        return FedRunner(TrainConfig(task_id=NNComputation.TASK_ICA, seed=0), tree, out,
                         fault_plan=plan, epochs=FIT_EPOCHS, agg_engine="dSGD")

    plan = FaultPlan(kill_at_round=ELASTIC_KILL_ROUND)
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    whole = runner(os.path.join(root, "whole"), None).run(folds=[0], verbose=False)[0]
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    whole_launches = read_counters(lc, pc, bc)
    out = os.path.join(root, "killed")
    zero_counters(lc, pc, bc)
    try:
        runner(out, plan).run(folds=[0], verbose=False)
        fail("the kill_at_round fit did not raise Preempted")
    except Preempted as p:
        killed = {"exit_code": p.exit_code, "epoch": p.epoch, "reason": p.reason}
    meta = load_meta(os.path.join(out, "remote", "simulatorRun", NNComputation.TASK_ICA,
                                  "fold_0", "checkpoint_latest.msgpack"))
    t0 = time.perf_counter()
    res = runner(out, plan).run(folds=[0], verbose=False, resume=True)[0]
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # the killed and the resumed runs
    if killed["exit_code"] != 75 or killed["epoch"] != 2 or meta.get("epoch") != 2:
        fail(f"the kill fit: {killed}, checkpointed epoch {meta.get('epoch')}")
    if launches != whole_launches or launches["lstm_fwd"] == 0:
        fail(f"the kill fit's launches {launches}, the uninterrupted fit's {whole_launches}")
    if not (all(same_tree(getattr(res["state"], p), getattr(whole["state"], p))
                for p in ("params", "batch_stats", "opt_state", "engine_state", "health"))
            and res["epoch_losses"] == whole["epoch_losses"]
            and res["test_metrics"] == whole["test_metrics"]):
        fail("the resumed kill fit differs from the uninterrupted fit")
    args = ["--data-path", tree, "--task", NNComputation.TASK_ICA, "--folds", "0", "--epochs",
            "2", "--out-dir", os.path.join(root, "kill_cli"), "--quiet", "--faults",
            json.dumps({"kill_at_round": ELASTIC_CLI_KILL_ROUND})]
    with contextlib.redirect_stdout(io.StringIO()) as printed, \
            contextlib.redirect_stderr(io.StringIO()) as errors:
        rc_kill = cli.main(args)
        rc_resume = cli.main(args + ["--resume"])
    line = json.loads(errors.getvalue().strip().splitlines()[-1])
    lines = printed.getvalue().splitlines()
    if rc_kill != 75 or rc_resume != 0 or not line.get("preempted") or len(lines) != 1:
        fail(f"the kill CLI exited {rc_kill} then {rc_resume}, printed {lines}, {line}")
    rec = {"killed": killed, "whole_seconds": whole_s, "resume_seconds": resume_s,
           "launches": launches, "cli": {"exit_codes": [rc_kill, rc_resume],
                                         "preempted_line": line,
                                         "fold_line": json.loads(lines[0])}}
    print(f"elastic kill_at_round on {smi}:", json.dumps(rec))
    return rec


def daemon_tree(root: str) -> str:
    """An ICA tree of ``DAEMON_SITES`` sites at the flagship width (phase
    11's, fewer sites)."""
    return fit_tree(root, DAEMON_SITES)


def elastic_daemon(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """``FedDaemon`` at full model width (module docstring, phase 18): the
    launches of each epoch, no kernel library built or loaded after the
    first, a daemon resumed after epoch 2 bit-equal to the uninterrupted
    one, and every ``publish.json`` seen by the port's
    ``CheckpointWatcher`` with the digest of the checkpoint loaded back."""
    from dinunet_implementations_tpu_torch.core.config import (
        NNComputation,
        TrainConfig,
        load_inputspec,
    )
    from dinunet_implementations_tpu_torch.runner import FedDaemon
    from dinunet_implementations_tpu_torch.serving import CheckpointWatcher
    from dinunet_implementations_tpu_torch.trainer import load_checkpoint, params_digest

    tree = daemon_tree(os.path.join(root, "daemon_tree"))
    spec = load_inputspec(os.path.join(tree, "inputspec.json"))
    rejoin = {"event": "join", "site": "local1",
              "data_dir": os.path.join(tree, "input", "local1", "simulatorRun"),
              "config": spec[1 % len(spec)], "after_epoch": 2}
    churn = [{"event": "leave", "site": "local1", "after_epoch": 1}, rejoin]

    def daemon(out, resume=False):
        return FedDaemon(TrainConfig(task_id=NNComputation.TASK_ICA, seed=0,
                                     batch_size=TRAIN_BATCH, staleness_bound=ELASTIC_BOUND),
                         capacity=DAEMON_CAPACITY, data_path=tree, out_dir=out,
                         spool_dir=os.path.join(out, "spool"), poll_s=0.01, resume=resume,
                         verbose=False)

    def spool(d, events):
        for i, ev in enumerate(events):
            with open(os.path.join(d.spool_dir, f"ev{i:03d}.json"), "w") as fh:
                json.dump(ev, fh)

    a = daemon(os.path.join(root, "daemon_a"))
    watcher = CheckpointWatcher(os.path.join(os.path.dirname(a.ckpt_path), "publish.json"))
    seen, per_epoch, epoch_ms = [], [], []
    watcher.poll()
    train, checkpoint = a.train_epoch, a.checkpoint

    def counted():
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)  # each epoch of the main path starts here
        t0 = time.perf_counter()
        loss = train()
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        per_epoch.append(read_counters(lc, pc, bc))
        return loss

    def published():
        checkpoint()
        ann = watcher.poll()
        if ann is not None:
            back = load_checkpoint(ann["path"], a.state)
            seen.append({"epoch": ann["epoch"], "digest_ok": ann["digest"] == params_digest(
                back.params, back.batch_stats)})

    a.train_epoch, a.checkpoint = counted, published
    spool(a, churn)
    summary = a.serve(max_epochs=DAEMON_EPOCHS)
    b1 = daemon(os.path.join(root, "daemon_b"))
    spool(b1, churn)
    b1.serve(max_epochs=2)
    b2 = daemon(os.path.join(root, "daemon_b"), resume=True)
    b2.serve(max_epochs=DAEMON_EPOCHS - 2)
    resumed_equal = (same_tree(a.state.params, b2.state.params)
                     and same_tree(a.state.buffers, b2.state.buffers))
    rounds = a._steps // a.cfg.local_iterations
    want = elastic_want(torch, per_epoch[0], "dSGD", rounds)
    rec = {"epochs": a.epochs_run, "rounds_per_epoch": rounds, "epoch_ms": epoch_ms,
           "held_rounds": a.held_rounds, "launches_per_epoch": per_epoch,
           "compiles_after_first_epoch": a.compiles_after_first_epoch(),
           "publishes_seen": seen, "resumed_bit_equal": resumed_equal,
           "summary": {k: summary[k] for k in ("epochs_run", "held_rounds", "membership")},
           "generation_local1": a.table.generation_of("local1")}
    print(f"elastic daemon: {DAEMON_SITES} sites over {DAEMON_CAPACITY} slots, epoch ms "
          f"{[round(m, 3) for m in epoch_ms]}, held rounds {a.held_rounds}, on {smi}:",
          json.dumps(rec))
    if a.epochs_run != DAEMON_EPOCHS or any(p != want for p in per_epoch):
        fail(f"the daemon's epochs {a.epochs_run}, launches {per_epoch}, want {want} each")
    if rec["compiles_after_first_epoch"] != {"kernel_builds": 0, "kernel_loads": 0}:
        fail(f"the daemon built or loaded kernels after its first epoch: {rec}")
    if not resumed_equal or rec["generation_local1"] != 2:
        fail("the resumed daemon differs from the uninterrupted one")
    if len(seen) < DAEMON_EPOCHS or not all(s["digest_ok"] for s in seen):
        fail(f"the daemon's publishes: {seen}")
    return rec


def elastic_phase(torch, np, lc, pc, bc, smi: str, tree: str, root: str,
                  bulk_sync_round_ms: float | None = None) -> dict:
    """Phase 18 of the module docstring: buffered-async and overlapped
    epochs through the kernels against the plain versions, the
    all-arrivals async epoch against bulk-sync, a ``kill_at_round`` fit and
    the command line on ``tree`` (phase 11's), and the daemon."""
    t_phase = time.perf_counter()
    plan = elastic_plan()
    cfg = elastic_setup(torch, True, "dSGD")[0]
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q).cuda() for q in plans]
    pairs = [elastic_pair(torch, np, lc, pc, bc, smi, e, "async", inv_x, inv_y, idx, plan)
             for e in ELASTIC_ENGINES]
    pairs += [elastic_pair(torch, np, lc, pc, bc, smi, e, "overlap", inv_x, inv_y, idx, plan)
              for e in ELASTIC_OVERLAP_ENGINES]
    arrivals = [elastic_all_arrivals(torch, np, e, inv_x, inv_y, idx) for e in ELASTIC_ENGINES]
    sync = {a["engine"]: a["sync_warm_epoch_ms"] for a in arrivals}
    vs = {f"{p['engine']}_{p['mode']}": {"warm_epoch_ms": p["warm_epoch_ms"],
                                         "bulk_sync_warm_epoch_ms": sync[p["engine"]]}
          for p in pairs}
    print(f"elastic warm epochs against bulk-sync (phase 6's round: {bulk_sync_round_ms} ms) on "
          f"{smi}:", json.dumps({"pairs": vs, "all_arrivals": arrivals}))
    kill = elastic_kill(torch, np, lc, pc, bc, smi, tree, root)
    daemon = elastic_daemon(torch, np, lc, pc, bc, smi, root)
    seconds = time.perf_counter() - t_phase
    print(f"elastic phase {seconds:.1f} s on {smi}")
    return {"pairs": pairs, "all_arrivals": arrivals, "kill": kill, "daemon": daemon,
            "seconds": seconds}


# -- phase 19: the privacy plane -------------------------------------------------

# The privacy A/B defaults of the JAX package's bench (clip 1.0, σ 0.5) at
# phase 6's flagship; PRIVACY_ROUNDS rounds an epoch, two epochs a pair.
PRIVACY_DP = dict(dp_clip=1.0, dp_noise_multiplier=0.5, dp_seed=0)
PRIVACY_PAIRS = (("dSGD", "dp"), ("dSGD", "dp_mask"), ("rankDAD", "dp"), ("powerSGD", "dp"),
                 ("dSGD", "personalize"))
PRIVACY_ROUNDS = 4
PRIVACY_HEAD = ("cls_fc3",)
PRIVACY_FIT_EPOCHS = 2
# the golden privacy stack (the JAX package's hard-SNR recipe): 6 sites,
# 60 epochs, patience 20, batch 8, DP 1.0 / 0.05, masked wires, cls_fc3
PRIVACY_STACK = dict(epochs=60, patience=20, batch_size=8, split_ratio=(0.7, 0.15, 0.15), seed=0,
                     dp_clip=1.0, dp_noise_multiplier=0.05, secure_agg="mask",
                     personalize=PRIVACY_HEAD)
PRIVACY_STACK_FLOOR = 0.62  # JAX's floor for the same recipe, recorded, not gated


def privacy_setup(torch, use_kernel: bool, engine: str, arm: str, **extra):
    """Phase 6's configuration (32 sites of batch 16, default ``ICAArgs``,
    dropout 0) under ``engine`` and the privacy ``arm`` ("dp": DP-SGD at
    ``PRIVACY_DP``; "dp_mask" and "dp_nopads": DP with secure aggregation
    "mask" / "mask-nopads"; "personalize": ``cls_fc3`` per site; "off":
    none), its epoch and first state; ``extra`` overrides the DP knobs."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    secure = {"dp_mask": "mask", "dp_nopads": "mask-nopads"}.get(arm, "off")
    head = PRIVACY_HEAD if arm == "personalize" else ()
    dp = ({**PRIVACY_DP, **extra} if arm in ("dp", "dp_mask", "dp_nopads") else {})
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine,
                      secure_agg=secure, personalize=head)
    task, eng, opt = build_training(cfg, use_kernel=use_kernel)
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, eng, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds, personalize=head, **dp)
    return cfg, epoch, init_train_state(task, eng, opt, rng=0, num_sites=cfg.num_sites,
                                        personalize=head)


def privacy_run(torch, epoch, state, inv_x, inv_y, idx):
    """The epochs of ``idx`` from ``state``: the state, the losses, each
    epoch's ms."""
    out, ms, losses = state, [], []
    for q in idx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lo = epoch(out, inv_x, inv_y, q)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lo)
    return out, torch.cat(losses), ms


def privacy_trips(torch, pc, epoch, state, inv_x, inv_y, q) -> list:
    """Each K7 launch's refinements in one round of ``epoch`` from
    ``state`` (``[min, mean, max]`` over its members): the wrapper is
    wrapped for this run only, outside any counted or timed run."""
    seen, real = [], pc.poweriter_fused

    def spy(*args, **kw):
        P, Q, trips = real(*args, **kw)
        t = trips.float()
        seen.append([t.min().item(), t.mean().item(), t.max().item()])
        return P, Q, trips

    pc.poweriter_fused = spy
    try:
        epoch(state, inv_x, inv_y, q[:, :1])
    finally:
        pc.poweriter_fused = real
    return seen


def privacy_pair(torch, np, lc, pc, bc, smi: str, engine: str, arm: str, inv_x, inv_y,
                 idx) -> dict:
    """One engine under one privacy arm through the kernels (timed,
    launches counted) and through the plain versions, held to each other
    at phase 8's tolerances: the first round's aggregate (and, personalized,
    each site's head step) within ``AGG_TOL``, rankDAD's first Ω by its
    Gram, powerSGD's first q and e, the first loss within
    ``FIRST_LOSS_TOL`` and every loss within ``LOSS_TOL``; K1 and K2 twice
    a round on the cluster route, K7 once a rank class and round staged."""
    _, epoch_k, start_k = privacy_setup(torch, True, engine, arm)
    _, epoch_p, start_p = privacy_setup(torch, False, engine, arm)
    if not same_tree(start_k.params, start_p.params):
        fail(f"privacy {engine} {arm}: the kernel and plain paths start from different weights")
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    st_k, lk, ms = privacy_run(torch, epoch_k, start_k, inv_x, inv_y, idx)
    launches = read_counters(lc, pc, bc)  # read before any check
    st_p, lp, _ = privacy_run(torch, epoch_p, start_p, inv_x, inv_y, idx)
    one_k, _ = epoch_k(start_k, inv_x, inv_y, idx[0][:, :1])
    one_p, _ = epoch_p(start_p, inv_x, inv_y, idx[0][:, :1])
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    agg_tol = lambda w: AGG_TOL["atol"] + AGG_TOL["rtol"] * w.abs()  # noqa: E731
    dl = (lk - lp).abs()
    checks = {"first_round_aggregate": leaf_check(agg(one_k), agg(one_p), agg_tol),
              "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
              "loss": (dl.max().item(), bool(lk.isfinite().all())
                       and dl.max().item() <= LOSS_TOL)}
    if arm == "personalize":
        heads = lambda s: {k: m / 0.1 for k, m in s.personal["opt"]["mu"].items()}  # noqa
        checks["first_round_heads"] = leaf_check(heads(one_k), heads(one_p), agg_tol)
        frozen = all(torch.equal(st_k.params[k], start_k.params[k])
                     for k in st_k.personal["params"])
        checks["global_head_frozen"] = (0.0 if frozen else 1.0, frozen)
    if engine == "rankDAD":
        omega = lambda st: {k: v for k, v in st.engine_state["omega"].items()  # noqa: E731
                            if v is not None}
        om = a9_omega_errs(omega(one_k), omega(one_p))
        checks["first_round_omega_gram"] = (om["gram"], om["gram"] <= OMEGA_FIRST_TOL)
    if engine == "powerSGD":
        for key in ("q", "e"):
            share = lambda w: PSGD_FIRST_TOL * w.abs().max()  # noqa: E731
            checks[f"first_round_{key}"] = leaf_check(one_k.engine_state[key],
                                                      one_p.engine_state[key], share)
    rounds = sum(q.shape[1] for q in idx)
    want = elastic_want(torch, launches, engine, rounds)
    rec = {"engine": engine, "arm": arm, "sites": TRAIN_SITES, "batch": TRAIN_BATCH,
           "rounds": rounds, "cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1],
           "warm_ms_per_round": ms[1] / idx[1].shape[1], "launches": launches,
           "max_abs_err_vs_plain": {k: v for k, (v, _) in checks.items()},
           "losses": lk.tolist()}
    if engine == "rankDAD":
        _, epoch_off, start_off = privacy_setup(torch, True, engine, "off")
        rec["k7_trips_dp"] = privacy_trips(torch, pc, epoch_k, start_k, inv_x, inv_y, idx[0])
        rec["k7_trips_off"] = privacy_trips(torch, pc, epoch_off, start_off, inv_x, inv_y, idx[0])
    print(f"privacy {engine} {arm}: warm epoch {ms[1]:.3f} ms ({idx[1].shape[1]} rounds, cold "
          f"{ms[0]:.3f}) on {smi}:", json.dumps(rec))
    if launches != want:
        fail(f"privacy {engine} {arm} launches {launches}, want {want}")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"privacy {engine} {arm} differs from the plain path in {bad}: {checks}")
    return rec


def privacy_identities(torch, np, inv_x, inv_y, idx) -> dict:
    """On the card: dSGD + DP with "mask" equal to "mask-nopads" bit for
    bit; a clip far above every norm with σ = 0 equal to the DP-off epochs
    bit for bit; int32 addition wrapping mod 2**32 as on the CPU."""
    def end(arm, **extra):
        _, epoch, start = privacy_setup(torch, True, "dSGD", arm, **extra)
        return privacy_run(torch, epoch, start, inv_x, inv_y, idx)[0]

    mask, nopads = end("dp_mask"), end("dp_nopads")
    clip_only = end("dp", dp_clip=1e6, dp_noise_multiplier=0.0)
    off = end("off")
    top = torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=torch.int32, device="cuda")
    wrapped = (top + torch.tensor([1, -1], dtype=torch.int32, device="cuda")).tolist()
    rec = {"mask_equals_nopads": same_tree(mask.params, nopads.params),
           "clip_only_equals_off": same_tree(clip_only.params, off.params)
           and same_tree(clip_only.opt_state["mu"], off.opt_state["mu"]),
           "int32_wraps": wrapped == [-2 ** 31, 2 ** 31 - 1]}
    print("privacy identities on the card:", json.dumps(rec))
    if not all(rec.values()):
        fail(f"privacy identities: {rec}")
    return rec


def privacy_costs(torch, np, smi: str, inv_x, inv_y, idx) -> dict:
    """The DP transform and the pads alone, on one round's gradients at
    the flagship (32 sites): device ms and kernel launches a round from
    ``torch.profiler`` (None when it shows no device time), and the host
    ms of the call."""
    from dinunet_implementations_tpu_torch.privacy.dpsgd import make_dp_fn
    from dinunet_implementations_tpu_torch.privacy.secure_agg import masked_weighted_mean
    from dinunet_implementations_tpu_torch.weights import table_of

    _, _, start = privacy_setup(torch, True, "dSGD", "off")
    table = table_of(start.params)
    g = torch.Generator(device="cuda").manual_seed(19)
    grads = {k: 1e-3 * torch.randn((TRAIN_SITES,) + tuple(v.shape), generator=g, device="cuda")
             for k, v in start.params.items()}
    weight = torch.full((TRAIN_SITES,), float(TRAIN_BATCH), device="cuda")
    live = torch.ones(TRAIN_SITES, device="cuda")
    dp = make_dp_fn(**PRIVACY_DP, table=table)
    calls = {"dp_transform": lambda: dp(grads, 3),
             "masked_mean": lambda: masked_weighted_mean(grads, weight, 0, 3, live=live,
                                                         leaf_index=table.leaf_index,
                                                         transposed=table.transposed),
             "masked_mean_nopads": lambda: masked_weighted_mean(grads, weight, 0, 3, live=live,
                                                                pads=False),
             "plain_mean": lambda: {k: (v * (weight / weight.sum()).reshape(
                 (-1,) + (1,) * (v.dim() - 1))).sum(0) for k, v in grads.items()}}
    out = {"sites": TRAIN_SITES, "shared_values": sum(v[0].numel() for v in grads.values()),
           "pairs": TRAIN_SITES * (TRAIN_SITES - 1) // 2}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        out[name] = {"host_ms": host_ms, **device_profile(torch, fn)}
    print(f"privacy costs a round at {TRAIN_SITES} sites on {smi}:", json.dumps(out))
    return out


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device ms summed over
    its kernels and the kernel count; None for both when the profiler shows
    no device time."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        us = sum(e.device_time if hasattr(e, "device_time") else e.cuda_time for e in evs)
        if not evs or us <= 0:
            return {"device_ms": None, "kernels": None}
        return {"device_ms": us / 1e3, "kernels": len(evs)}
    except Exception as e:  # the profiler is untried on this machine: report, do not fail
        return {"device_ms": None, "kernels": None, "profiler_error": repr(e)[:200]}


def privacy_mm(torch, lc, pc, bc, smi: str) -> dict:
    """The BASELINE multimodal 64-site DP-SGD configuration at phase 16's
    widths: a cold and a warm epoch under dSGD and rankDAD with DP
    (``PRIVACY_DP``) beside the same epochs without, launches counted on
    the DP runs (rankDAD: each K7 launch of each rank class once a round on
    its route, no plain class), K7's trips of one round with and without
    DP."""
    from dinunet_implementations_tpu_torch.runner import build_training
    from dinunet_implementations_tpu_torch.trainer import init_train_state, make_train_epoch_fn

    routes = k7_routes(torch, pc, a9_cfg(A9_MM, "rankDAD", False), A9_SHAPES[A9_MM]["sites"])
    out = {"routes": routes}
    for engine in ("dSGD", "rankDAD"):
        cfg = a9_cfg(A9_MM, engine, False)
        inv_x, inv_y, idx = a9_data(torch, cfg)
        rec = {}
        for arm in ("off", "dp"):
            task, eng, opt = build_training(cfg, device="cuda")
            epoch = make_train_epoch_fn(task, eng, opt, cfg.local_iterations,
                                        cfg.quarantine_rounds, "cuda",
                                        **(PRIVACY_DP if arm == "dp" else {}))
            state = init_train_state(task, eng, opt, rng=cfg.seed, num_sites=cfg.num_sites)
            start = state
            torch.cuda.synchronize()
            zero_counters(lc, pc, bc)  # the main path's run starts here
            ms, losses = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                state, lo = epoch(state, inv_x, inv_y, idx)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(lo)
            launches = read_counters(lc, pc, bc)  # read before any check
            loss = torch.cat(losses)
            want = (k7_want(launches, routes, 2 * A9_ROUNDS) if engine == "rankDAD"
                    else dict.fromkeys(launches, 0))
            if launches != want or not bool(loss.isfinite().all()):
                fail(f"multimodal {engine} {arm} epochs launched {launches}, want {want}; "
                     f"losses {loss.tolist()}")
            rec[arm] = {"cold_epoch_ms": ms[0], "warm_epoch_ms": ms[1], "launches": launches,
                        "losses": loss.tolist()}
            if engine == "rankDAD":
                rec[arm]["k7_trips"] = privacy_trips(torch, pc, epoch, start, inv_x, inv_y, idx)
        out[engine] = rec
        print(f"multimodal {engine} at {A9_SHAPES[A9_MM]['sites']} sites: warm epoch "
              f"{rec['dp']['warm_epoch_ms']:.3f} ms with DP, {rec['off']['warm_epoch_ms']:.3f} ms "
              f"without, on {smi}:", json.dumps(rec))
    return out


def privacy_fits(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """The fit surfaces on phase 11's tree (module docstring, phase 19)."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.data import epoch_steps
    from dinunet_implementations_tpu_torch.privacy import (
        RdpAccountant,
        effective_noise_multiplier,
        sampling_fraction,
    )
    from dinunet_implementations_tpu_torch.runner import FedRunner, load_site_splits
    from dinunet_implementations_tpu_torch.trainer import load_checkpoint, load_meta
    from dinunet_implementations_tpu_torch.trainer.checkpoint import _load_raw
    from dinunet_implementations_tpu_torch.weights import train_state_from_tree, train_state_to_jax

    base = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    dp = dict(dp_clip=1.0, dp_noise_multiplier=0.5, patience=99, epochs=PRIVACY_FIT_EPOCHS)

    def fit(out, resume=False, **kw):
        runner = FedRunner(base, tree, os.path.join(root, out), **{**dp, **kw})
        return runner, runner.run(folds=[0], verbose=False, resume=resume)[0]

    def ckpt(out, name="checkpoint_latest.msgpack"):
        return os.path.join(root, out, "remote", "simulatorRun", NNComputation.TASK_ICA,
                            "fold_0", name)

    runner = FedRunner(base, tree, os.path.join(root, "p_probe"))
    fold = load_site_splits(runner.cfg, runner.site_dirs, runner.site_cfgs)[0]
    rounds = epoch_steps(fold["train"], runner.cfg.batch_size) // runner.cfg.local_iterations
    q = sampling_fraction(runner.cfg.batch_size, runner.cfg.local_iterations,
                          [len(s) for s in fold["train"]])
    eps1 = RdpAccountant().step(effective_noise_multiplier(0.5), q, rounds).epsilon(1e-5)[0]
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    _, full = fit("p_full")
    fit_s = time.perf_counter() - t0
    launches = read_counters(lc, pc, bc)  # read before any check
    _, stopped = fit("p_resume", dp_epsilon_budget=eps1)
    _, resumed = fit("p_resume", resume=True)
    meta_a, meta_b = load_meta(ckpt("p_full")), load_meta(ckpt("p_resume"))
    rec = {"rounds_per_epoch": rounds, "fit_seconds": fit_s, "launches": launches,
           "epsilon": full["dp_epsilon"], "epsilon_one_epoch": eps1,
           "budget_stopped_epoch": stopped["stopped_epoch"],
           "budget_epsilon": stopped["dp_epsilon"], "resumed_epsilon": resumed["dp_epsilon"],
           "ledger_equal": meta_a["dp_accountant"] == meta_b["dp_accountant"]}
    n = 2 * rounds * PRIVACY_FIT_EPOCHS
    if (launches["lstm_bwd"] != n or launches["k2_stream_route"] or launches["k1_stream_route"]
            or launches["poweriter"]):
        fail(f"the DP fit launched {launches}, want {n} K2 launches on the cluster route")
    if (stopped["stopped_epoch"] != 1 or resumed["dp_epsilon"] != full["dp_epsilon"]
            or not rec["ledger_equal"] or not full["dp_epsilon"] > eps1 > 0):
        fail(f"the DP fit's budget stop or resume: {rec}")
    # a personalized fit: its best checkpoint in JAX's layout and back
    _, pers = fit("p_pers", personalize=PRIVACY_HEAD, dp_clip=0.0, dp_noise_multiplier=0.0)
    raw = _load_raw(ckpt("p_pers", "checkpoint_best.msgpack"))
    kernel = raw["personal"]["params"]["cls_fc3"]["kernel"]
    _, _, like = privacy_setup(torch, True, "dSGD", "personalize")
    back = load_checkpoint(ckpt("p_pers", "checkpoint_best.msgpack"), like)
    again = train_state_from_tree(train_state_to_jax(back), device="cuda")
    layout_ok = (tuple(raw["personal"]) == ("opt", "params")
                 and tuple(np.shape(kernel)) == (FIT_SITES, 64, 2)
                 and tuple(raw["personal"]["opt"]["0"]) == ("count", "mu", "nu")
                 and np.shape(raw["personal"]["opt"]["0"]["count"]) == (FIT_SITES,))
    round_trip = (same_tree(again.personal["params"], back.personal["params"])
                  and same_tree(again.personal["opt"]["mu"], back.personal["opt"]["mu"])
                  and torch.equal(again.personal["opt"]["count"], back.personal["opt"]["count"])
                  and np.array_equal(np.asarray(kernel), back.personal["params"][
                      "cls_fc3.weight"].mT.cpu().numpy()))
    site_scores = [json.load(open(os.path.join(
        root, "p_pers", f"local{i}", "simulatorRun", NNComputation.TASK_ICA, "fold_0",
        "logs.json")))["test_metrics"] for i in (0, 1)]
    rec.update(personal_layout_ok=layout_ok, personal_round_trip=round_trip,
               personal_test_metrics=pers["test_metrics"], personal_site_scores=site_scores)
    print(f"privacy fits on phase 11's tree, {FIT_SITES} sites, on {smi}:", json.dumps(rec))
    if not (layout_ok and round_trip):
        fail(f"the personalized checkpoint: {rec}")
    return rec


def privacy_cli(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """The command line with every privacy flag on phase 11's tree: one
    fold's JSON line, ε in each ``logs.json``, K1 and K2 counted."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.runner import cli

    out = os.path.join(root, "p_cli")
    argv = ["--data-path", tree, "--task", NNComputation.TASK_ICA, "--epochs", "1",
            "--folds", "0", "--out-dir", out, "--quiet", "--dp-clip", "1", "--dp-noise", "0.5",
            "--secure-agg", "mask", "--personalize", "cls_fc3"]
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = read_counters(lc, pc, bc)  # read before any check
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    logs = json.load(open(os.path.join(out, "local0", "simulatorRun", NNComputation.TASK_ICA,
                                       "fold_0", "logs.json")))
    rec = {"rc": rc, "line": line, "dp_epsilon": logs.get("dp_epsilon"), "launches": launches}
    print("privacy command line:", json.dumps(rec))
    if rc != 0 or not (logs.get("dp_epsilon") or 0) > 0 or not launches["lstm_fwd"] \
            or launches["k1_stream_route"] or launches["k2_stream_route"]:
        fail(f"the privacy command line: {rec}")
    return rec


def privacy_daemon(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """``FedDaemon`` under DP with a personalized head over phase 18's
    daemon tree: a leave after epoch 1 and the rejoin after epoch 2; the
    rejoined slot's head reset to the global head at the rejoin, ε growing
    across the rejoin (never reset), K1 and K2 the same every epoch."""
    from dinunet_implementations_tpu_torch.core.config import (
        NNComputation,
        TrainConfig,
        load_inputspec,
    )
    from dinunet_implementations_tpu_torch.runner import FedDaemon

    tree = daemon_tree(os.path.join(root, "p_daemon_tree"))
    spec = load_inputspec(os.path.join(tree, "inputspec.json"))
    d = FedDaemon(TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, batch_size=TRAIN_BATCH,
                              personalize=PRIVACY_HEAD, **PRIVACY_DP),
                  capacity=DAEMON_CAPACITY, data_path=tree, out_dir=os.path.join(root, "p_d"),
                  poll_s=0.01, verbose=False)
    events = [{"event": "leave", "site": "local1", "after_epoch": 1},
              {"event": "join", "site": "local1", "after_epoch": 2, "config": spec[1],
               "data_dir": os.path.join(tree, "input", "local1", "simulatorRun")}]
    for i, ev in enumerate(events):
        with open(os.path.join(d.spool_dir, f"ev{i:03d}.json"), "w") as fh:
            json.dump(ev, fh)
    eps, heads_reset, per_epoch = [], [], []
    train, reset = d.train_epoch, d._reset_slot

    def counted():
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)  # each epoch of the main path starts here
        loss = train()
        torch.cuda.synchronize()
        per_epoch.append(read_counters(lc, pc, bc))
        eps.append(d.trainer._dp_epsilon)
        return loss

    def reset_and_check(slot, site="", generation=0):
        reset(slot, site, generation)
        if d.state is not None and d.state.personal is not None:
            heads_reset.append(all(torch.equal(d.state.personal["params"][k][slot],
                                               d.state.params[k])
                                   for k in d.state.personal["params"]))

    d.train_epoch, d._reset_slot = counted, reset_and_check
    d.serve(max_epochs=4)
    rec = {"epochs": d.epochs_run, "epsilon_per_epoch": eps, "heads_reset": heads_reset,
           "generation_local1": d.table.generation_of("local1"), "launches_per_epoch": per_epoch}
    print("privacy daemon:", json.dumps(rec))
    rounds = d._steps // d.cfg.local_iterations
    want = elastic_want(torch, per_epoch[0], "dSGD", rounds)
    if (d.epochs_run != 4 or rec["generation_local1"] != 2 or not heads_reset
            or not all(heads_reset) or any(b <= a for a, b in zip(eps, eps[1:]))
            or any(p != want for p in per_epoch)):
        fail(f"the privacy daemon: {rec}, want {want} launches an epoch")
    return rec


def privacy_stack(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """The JAX package's golden privacy-stack fit (its hard-SNR recipe:
    ``PRIVACY_STACK``) on the port: a finite test loss and ε > 0 held; the
    AUC recorded beside ``PRIVACY_STACK_FLOOR`` (the noise draws are the
    port's own, so it is not gated)."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.data import make_hard_ica_tree
    from dinunet_implementations_tpu_torch.runner import FedRunner

    tree = make_hard_ica_tree(os.path.join(root, "p_hard"), n_sites=6)
    t0 = time.perf_counter()
    res = FedRunner(TrainConfig(task_id=NNComputation.TASK_ICA, agg_engine="dSGD",
                                **PRIVACY_STACK), tree, os.path.join(root, "p_hard_out")
                    ).run(verbose=False)[0]
    loss, auc = res["test_metrics"][0]
    rec = {"test_loss": loss, "test_auc": auc, "floor_jax": PRIVACY_STACK_FLOOR,
           "epsilon": res.get("dp_epsilon"), "best_val_epoch": res["best_val_epoch"],
           "stopped_epoch": res["stopped_epoch"], "seconds": time.perf_counter() - t0}
    print(f"privacy stack (golden recipe) on {smi}:", json.dumps(rec))
    if not (np.isfinite(loss) and (res.get("dp_epsilon") or 0) > 0):
        fail(f"the privacy-stack fit: {rec}")
    return rec


def privacy_phase(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """Phase 19 of the module docstring: the privacy plane."""
    t_phase = time.perf_counter()
    cfg = privacy_setup(torch, True, "dSGD", "off")[0]
    inv, plans = training_data(np, cfg)
    if any(q.shape[1] < PRIVACY_ROUNDS for q in plans):
        fail(f"phase 19 wants {PRIVACY_ROUNDS} rounds an epoch: {[q.shape for q in plans]}")
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q[:, :PRIVACY_ROUNDS]).cuda() for q in plans]
    pairs = [privacy_pair(torch, np, lc, pc, bc, smi, e, a, inv_x, inv_y, idx)
             for e, a in PRIVACY_PAIRS]
    identities = privacy_identities(torch, np, inv_x, inv_y, idx)
    costs = privacy_costs(torch, np, smi, inv_x, inv_y, idx)
    mm = privacy_mm(torch, lc, pc, bc, smi)
    fits = privacy_fits(torch, np, lc, pc, bc, smi, tree, root)
    cli = privacy_cli(torch, np, lc, pc, bc, smi, tree, root)
    daemon = privacy_daemon(torch, np, lc, pc, bc, smi, root)
    stack = privacy_stack(torch, np, lc, pc, bc, smi, root)
    seconds = time.perf_counter() - t_phase
    print(f"privacy phase {seconds:.1f} s on {smi}")
    return {"pairs": pairs, "identities": identities, "costs": costs, "mm": mm, "fits": fits,
            "cli": cli, "daemon": daemon, "stack": stack, "seconds": seconds}


# -- phase 20: the fit's telemetry plane --------------------------------------------

# phase 6's flagship, TELEMETRY_ROUNDS rounds an epoch, two epochs a run
TELEMETRY_ROUNDS = 4
TELEMETRY_ENGINES = ("dSGD", "rankDAD")
# The round metrics through the kernels against the same rounds through
# the plain versions, each round from the same state (the kernel path's
# after the rounds before it), set from phase 8's AGG_TOL: a squared norm
# doubles the relative error of its vector, so the gradient and update
# norms at 2 x AGG_TOL's rtol; the residual carries rankDAD's
# reconstruction of near-equal singular pairs (Ω's OMEGA_FIRST_TOL), so
# 1e-2 there. (Set before the first card run; that run measured 2e-7 to
# 9e-7 on the first round. Its two-epoch sums, each path on its own
# trajectory, parted by up to 6.5e-2 on grad_sq_max: params part on the lr
# scale, as phase 8's reasoning says, so those are not compared. rankDAD's
# gradient norm parts by 5.9e-4 at one round and site of epoch 2, where a
# move of every weight by one rounding moves the plain path's own norm by
# the same amount: a kink that any rounding flips, recorded with the run.)
TEL_ROUND_RTOL = {"grad_sq_last": 2e-3, "update_sq_last": 2e-3,
                  "residual_sq_sum": {"dSGD": 2e-3, "rankDAD": 1e-2}}
TEL_FIT_EPOCHS, TEL_XPROF_WINDOW = 2, (2, 2)
# the kernel names in the profiler's device events, by counter
TEL_KERNEL_NAMES = {"lstm_proj": ("lstm_proj_kernel", "lstm_proj_wide_kernel"),
                    "k1_cluster_route": ("lstm_rec_cluster_kernel",),
                    "k2_cluster_route": ("bwd_cluster_kernel", "bwd_cluster_mma_kernel"),
                    "k7_staged_route": ("poweriter_staged_kernel",)}


def telemetry_setup(torch, use_kernel: bool, engine: str, telemetry: bool, capture=None):
    """Phase 6's configuration (32 sites of batch 16, default ``ICAArgs``,
    dropout 0) under ``engine``, its epoch with or without the round
    metrics, and its first state. ``capture`` (a list) receives each
    round's engine input, aggregate and optimizer update, read without a
    launch."""
    import dataclasses

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine)
    task, eng, opt = build_training(cfg, use_kernel=use_kernel)
    task.model.dropout_rate = 0.0
    if capture is not None:
        inner, upd = eng.aggregate, opt.update

        def aggregate(grads, state, weight, live=None, rnd=None):
            agg, es = inner(grads, state, weight, live=live, rnd=rnd)
            capture.append({"grads": grads, "agg": agg})
            return agg, es

        def update(grads, state):
            u, st = upd(grads, state)
            capture[-1]["updates"] = u
            return u, st

        eng = dataclasses.replace(eng, aggregate=aggregate)
        opt = dataclasses.replace(opt, update=update)
    epoch = make_train_epoch_fn(task, eng, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds, telemetry=telemetry)
    return epoch, init_train_state(task, eng, opt, rng=0, num_sites=cfg.num_sites,
                                   telemetry=telemetry)


def telemetry_recompute(torch, capture: list, params: dict) -> dict:
    """The accumulators from the captured rounds, by the same
    ``tree_sq_sum`` in the epoch's order, on the card."""
    from dinunet_implementations_tpu_torch.telemetry.metrics import jax_leaf_order, tree_sq_sum

    order = jax_leaf_order(list(params))
    zero = torch.zeros(TRAIN_SITES, device="cuda")
    acc = {"grad_sq_sum": zero, "grad_sq_max": zero, "residual_sq_sum": zero,
           "update_sq_sum": zero}
    for c in capture:
        g = tree_sq_sum(c["grads"], order, site_axis=True)
        r = tree_sq_sum({k: c["grads"][k] - c["agg"][k] for k in order}, order, site_axis=True)
        u = tree_sq_sum(c["updates"], order)
        acc = {"grad_sq_sum": acc["grad_sq_sum"] + g,
               "grad_sq_max": torch.maximum(acc["grad_sq_max"], g),
               "residual_sq_sum": acc["residual_sq_sum"] + r,
               "update_sq_sum": acc["update_sq_sum"] + u}
        acc["grad_sq_last"], acc["update_sq_last"] = g, zero + u
    return acc


def telemetry_rel(got: dict, want: dict, keys) -> dict:
    """Per accumulator: the largest relative difference over the sites."""
    return {k: ((got[k] - want[k]).abs() / want[k].abs().clamp_min(1e-30)).max().item()
            for k in keys}


def telemetry_rounds_vs_plain(torch, engine: str, epoch_k, epoch_p, cap_k: list, cap_p: list,
                              start, inv_x, inv_y, idx) -> tuple:
    """Each round of ``idx`` once through the kernels and once through the
    plain versions from the same state (the kernel path's after the rounds
    before it, its accumulators dropped so that each run holds that round's
    values alone): the largest relative difference of each round metric
    over the rounds and sites, where the gradient norm parts most (round,
    site, both paths' norms, the sites' median norm, the round's loss, the
    leaves whose gradients part most), and the kernel path's end state.
    ``epoch_k`` and ``epoch_p`` capture each round's gradients into
    ``cap_k`` and ``cap_p``."""
    import dataclasses

    keys = tuple(TEL_ROUND_RTOL)
    worst = dict.fromkeys(keys, 0.0)
    at: dict = {"rel": -1.0}
    st, n = start, 0
    for q in idx:
        for r in range(q.shape[1]):
            fresh = dataclasses.replace(st, telemetry=None)
            k_out, k_loss = epoch_k(fresh, inv_x, inv_y, q[:, r:r + 1])
            p_out, p_loss = epoch_p(fresh, inv_x, inv_y, q[:, r:r + 1])
            tk, tp = k_out.telemetry, p_out.telemetry
            rel = {k: (tk[k] - tp[k]).abs() / tp[k].abs().clamp_min(1e-30) for k in keys}
            worst = {k: max(worst[k], rel[k].max().item()) for k in keys}
            site = int(rel["grad_sq_last"].argmax())
            if rel["grad_sq_last"][site].item() > at["rel"]:
                gk, gp = cap_k[-1]["grads"], cap_p[-1]["grads"]
                leaf_rel = {k: ((gk[k][site] - gp[k][site]).norm()
                                / gp[k][site].norm().clamp_min(1e-30)).item() for k in gp}
                at = {"rel": rel["grad_sq_last"][site].item(), "round": n, "site": site,
                      "grad_sq_kernel": tk["grad_sq_last"][site].item(),
                      "grad_sq_plain": tp["grad_sq_last"][site].item(),
                      "grad_sq_plain_median": tp["grad_sq_last"].median().item(),
                      "round_loss_kernel": k_loss[0].item(),
                      "round_loss_plain": p_loss[0].item(),
                      "leaves_most_apart": sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:4],
                      "state": fresh, "q": q[:, r:r + 1]}
            cap_k.clear()
            cap_p.clear()
            st, n = k_out, n + 1
    # the plain round at that state with every weight moved by about one
    # f32 rounding (relative 2^-23, a random sign each): how far rounding
    # alone moves the plain path's own gradient norm there
    g = torch.Generator(device=inv_x.device).manual_seed(0)
    moved = {k: v * (1.0 + 2.0 ** -23 * (torch.randint(0, 2, v.shape, generator=g,
                                                        device=v.device) * 2 - 1))
             for k, v in at["state"].params.items()}
    base, _ = epoch_p(at["state"], inv_x, inv_y, at["q"])
    pert, _ = epoch_p(dataclasses.replace(at["state"], params=moved), inv_x, inv_y, at["q"])
    cap_p.clear()
    a, b = pert.telemetry["grad_sq_last"], base.telemetry["grad_sq_last"]
    moved_rel = (a - b).abs() / b.abs().clamp_min(1e-30)
    at["plain_moved_by_rounding_rel"] = moved_rel[at["site"]].item()
    at["plain_moved_by_rounding_rel_max"] = moved_rel.max().item()
    del at["state"], at["q"]
    ok = all(worst[k] <= (TEL_ROUND_RTOL[k][engine] if isinstance(TEL_ROUND_RTOL[k], dict)
                          else TEL_ROUND_RTOL[k]) for k in keys)
    return worst, at, ok, st


def telemetry_pair(torch, np, lc, pc, bc, smi: str, engine: str, inv_x, inv_y, idx) -> dict:
    """One engine's telemetry-on epochs through the kernels (launches
    counted, timed) against the telemetry-off epochs through the kernels
    (state and losses bit for bit, launches equal); a captured rerun whose
    accumulators equal their on-card recompute and the counted run's, bit
    for bit; each round against the plain versions from the same state
    (TEL_ROUND_RTOL)."""
    cap: list = []
    epoch_on, start_on = telemetry_setup(torch, True, engine, True)
    epoch_off, start_off = telemetry_setup(torch, True, engine, False)
    epoch_cap, start_cap = telemetry_setup(torch, True, engine, True, capture=cap)
    cap_p: list = []
    epoch_p, start_p = telemetry_setup(torch, False, engine, True, capture=cap_p)
    if not all(same_tree(start_on.params, s.params) for s in (start_off, start_cap, start_p)):
        fail(f"telemetry {engine}: the runs start from different weights")
    torch.cuda.synchronize()
    zero_counters(lc, pc, bc)  # the main path's run starts here
    st_on, l_on, ms_on = privacy_run(torch, epoch_on, start_on, inv_x, inv_y, idx)
    launches = read_counters(lc, pc, bc)  # read before any check
    zero_counters(lc, pc, bc)
    st_off, l_off, ms_off = privacy_run(torch, epoch_off, start_off, inv_x, inv_y, idx)
    launches_off = read_counters(lc, pc, bc)
    st_cap, _, _ = privacy_run(torch, epoch_cap, start_cap, inv_x, inv_y, idx)
    rounds = sum(q.shape[1] for q in idx)
    keys = ("grad_sq_last", "grad_sq_sum", "grad_sq_max", "residual_sq_sum", "update_sq_last",
            "update_sq_sum")
    t_on = st_on.telemetry
    rec_host = telemetry_recompute(torch, cap, st_on.params)
    cap.clear()
    per_round, worst_grad, per_round_ok, st_seq = telemetry_rounds_vs_plain(
        torch, engine, epoch_cap, epoch_p, cap, cap_p, start_on, inv_x, inv_y, idx)
    checks = {
        "state_on_equals_off": all(same_tree(getattr(st_on, part), getattr(st_off, part))
                                   for part in ("params", "batch_stats", "opt_state",
                                                "engine_state", "health"))
        and torch.equal(l_on, l_off),
        "launches_on_equal_off": launches == launches_off,
        "recompute_bit_for_bit": all(torch.equal(st_cap.telemetry[k], rec_host[k])
                                     for k in keys),
        "captured_run_equals_counted": same_tree(st_cap.telemetry, t_on),
        "rounds": bool((t_on["rounds"] == rounds).all()),
        "off_has_none": st_off.telemetry is None,
        "rounds_vs_plain": per_round_ok,
    }
    want = elastic_want(torch, launches, engine, rounds)
    rec = {"engine": engine, "sites": TRAIN_SITES, "batch": TRAIN_BATCH, "rounds": rounds,
           "warm_epoch_ms_on": ms_on[1], "warm_epoch_ms_off": ms_off[1],
           "cold_epoch_ms_on": ms_on[0], "cold_epoch_ms_off": ms_off[0],
           "launches": launches, "round_rel_vs_plain": per_round,
           "grad_most_apart_from_plain": worst_grad,
           "one_round_runs_end_at_the_counted_state": same_tree(st_seq.params, st_on.params),
           "payload_bytes_per_round": t_on["payload_bytes"][0].item() / rounds,
           "checks": checks}
    print(f"telemetry {engine}: warm epoch {ms_on[1]:.3f} ms on, {ms_off[1]:.3f} ms off "
          f"({idx[1].shape[1]} rounds) on {smi}:", json.dumps(rec))
    if launches != want:
        fail(f"telemetry {engine} launches {launches}, want {want}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"telemetry {engine} fails {bad}: {rec}")
    return rec


def telemetry_cost(torch, smi: str, inv_x, inv_y, idx) -> dict:
    """What the accumulators add to one dSGD round at the flagship: the
    kernels a round (``torch.profiler``'s device events of one round with
    the metrics on, less those with them off) and the host ms (the least of
    five one-round epochs each way)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for on in (False, True):
        epoch, start = telemetry_setup(torch, True, "dSGD", on)
        q = idx[0][:, :1]
        epoch(start, inv_x, inv_y, q)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(start, inv_x, inv_y, q)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            epoch(start, inv_x, inv_y, q)
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        out["on" if on else "off"] = {"round_ms": min(ms), "kernels": len(evs)}
    out["added_kernels_a_round"] = out["on"]["kernels"] - out["off"]["kernels"]
    out["added_host_ms_a_round"] = out["on"]["round_ms"] - out["off"]["round_ms"]
    print(f"telemetry cost a dSGD round at {TRAIN_SITES} sites on {smi}:", json.dumps(out))
    return out


def telemetry_fit(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """A telemetry-on rankDAD fit of phase 11's tree (``FedRunner``, device
    pipeline) with an xprof window on epoch 2: the artifacts pass the
    report's ``--validate`` (rc 0) and the rows the JAX-shaped row schema;
    the window's trace lists K1's projection and recurrence, K2 and K7 by
    name, each as many times as its counter over epoch 2."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner import FedRunner
    from dinunet_implementations_tpu_torch.telemetry import report, sink, xprof
    from dinunet_implementations_tpu_torch.trainer.loop import FederatedTrainer

    out, xdir = os.path.join(root, "t_fit"), os.path.join(root, "t_xprof")
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, agg_engine="rankDAD", telemetry="on",
                      xprof_dir=xdir, xprof_window=TEL_XPROF_WINDOW, epochs=TEL_FIT_EPOCHS)
    per_epoch, real = {}, FederatedTrainer.run_epoch

    def counted(self, state, train_sites, epoch, **kw):
        torch.cuda.synchronize()
        before = read_counters(lc, pc, bc)
        res = real(self, state, train_sites, epoch, **kw)
        torch.cuda.synchronize()
        after = read_counters(lc, pc, bc)
        per_epoch[epoch] = {k: after[k] - before[k] for k in after}
        return res

    FederatedTrainer.run_epoch = counted
    try:
        torch.cuda.synchronize()
        zero_counters(lc, pc, bc)  # the main path's run starts here
        t0 = time.perf_counter()
        res = FedRunner(cfg, tree, out).run(folds=[0], verbose=False)[0]
        seconds = time.perf_counter() - t0
        launches = read_counters(lc, pc, bc)  # read before any check
    finally:
        FederatedTrainer.run_epoch = real
    tel = os.path.join(out, "telemetry")
    rc = report.main(["--validate", tel])
    rows = sink.load_metrics(os.path.join(tel, "fold_0", sink.METRICS_FILE))
    ops = xprof.summarize_device_ops(os.path.join(xdir, "fold_0"), top=200)
    seen = {counter: sum(o["count"] for o in ops if any(n in o["name"] for n in names))
            for counter, names in TEL_KERNEL_NAMES.items()}
    e2 = per_epoch.get(TEL_XPROF_WINDOW[0], {})
    rec = {"seconds": seconds, "report_rc": rc, "rows": len(rows),
           "row_problems": sink.validate_metrics_rows(rows), "launches": launches,
           "epoch2_launches": e2, "profiled_kernels": seen,
           "top_device_ops": ops[:8], "site_telemetry_rounds": res["site_telemetry"]["rounds"],
           "payload_bytes_per_round": res["site_telemetry"]["payload_bytes_per_round"]}
    print(f"telemetry fit in {seconds:.1f} s on {smi}:", json.dumps(rec))
    if rc != 0 or rec["row_problems"] or not e2:
        fail(f"the telemetry fit's artifacts: {rec}")
    if any(seen[k] != e2.get(k) or not seen[k] for k in TEL_KERNEL_NAMES):
        fail(f"the profiler's device kernels over epoch 2 {seen} differ from the counters "
             f"{e2}: {ops[:12]}")
    return rec


def telemetry_cli(torch, smi: str, tree: str, root: str) -> dict:
    """The compile cache and the sanitizer in one process of their own: the
    libraries phase 2 built, copied into a fresh directory, and a command
    line fit with ``--compile-cache`` at the copy, ``--sanitize
    compile,nans`` and ``--telemetry on``, 2 epochs: exit 0, no library
    built, every library loaded from the copy."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.ops import _build

    src = _build.build_dir()
    cache = os.path.join(root, "t_kcache")
    shutil.copytree(src, os.path.join(cache, src.name))
    out = os.path.join(root, "t_cli")
    argv = ["--data-path", tree, "--task", NNComputation.TASK_ICA, "--engine", "rankDAD",
            "--epochs", "2", "--folds", "0", "--out-dir", out, "--quiet", "--telemetry", "on",
            "--compile-cache", cache, "--sanitize", "compile,nans"]
    code = ("import json, sys\n"
            "from dinunet_implementations_tpu_torch.runner import cli\n"
            "from dinunet_implementations_tpu_torch.ops import _build\n"
            f"rc = cli.main({argv!r})\n"
            "print(json.dumps({'rc': rc, 'builds': _build.BUILDS, 'loads': _build.LOADS, "
            "'root': str(_build.BUILD_ROOT), 'libs': sorted(l._name for l in "
            "_build._libs.values())}))\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        got = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"the compile-cache command line printed no result (rc {proc.returncode}): "
             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    rec = {"seconds": seconds, "returncode": proc.returncode, **got,
           "fold_line": json.loads(lines[-2]) if len(lines) > 1 else None,
           "cache": cache, "copied_from": str(src)}
    print(f"telemetry compile cache and sanitizer in {seconds:.1f} s on {smi}:", json.dumps(rec))
    copy = os.path.join(os.path.realpath(cache), src.name) + os.sep
    in_copy = all(os.path.realpath(p).startswith(copy) for p in got["libs"])
    if proc.returncode != 0 or got["rc"] != 0 or got["builds"] != 0 or got["loads"] < 3 \
            or not in_copy:
        fail(f"the compile cache or the sanitizer: {rec} {proc.stderr[-4000:]}")
    return rec


def telemetry_phase(torch, np, lc, pc, bc, smi: str, tree: str, root: str) -> dict:
    """Phase 20 of the module docstring: the fit's telemetry plane."""
    t_phase = time.perf_counter()
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH)
    inv, plans = training_data(np, cfg)
    if any(q.shape[1] < TELEMETRY_ROUNDS for q in plans):
        fail(f"phase 20 wants {TELEMETRY_ROUNDS} rounds an epoch: {[q.shape for q in plans]}")
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q[:, :TELEMETRY_ROUNDS]).cuda() for q in plans]
    pairs = [telemetry_pair(torch, np, lc, pc, bc, smi, e, inv_x, inv_y, idx)
             for e in TELEMETRY_ENGINES]
    cost = telemetry_cost(torch, smi, inv_x, inv_y, idx)
    fit = telemetry_fit(torch, np, lc, pc, bc, smi, tree, root)
    cli = telemetry_cli(torch, smi, tree, root)
    seconds = time.perf_counter() - t_phase
    print(f"telemetry phase {seconds:.1f} s on {smi}")
    return {"pairs": pairs, "cost": cost, "fit": fit, "cli": cli, "seconds": seconds}


# -- phase 21: the live plane and the serving CLI -------------------------------------

# (a): the flagship's serving CLI run; (b): the unidirectional fleet's
# script; (c): the daemon's epochs, telemetry on and off; the SIGTERM run
# stops after its first epoch
LIVE_SMOKE, LIVE_LINGER_S, LIVE_SLO_MS = 60, 2.0, 500.0
LIVE_DAEMON_EPOCHS = 3
LIVE_ENDPOINTS = ("/metrics", "/healthz", "/statusz", "/tracez")
# requests a sequential run of the dispatch-cost arms (one row each)
LIVE_COST_REQUESTS = 40
# (b)'s script: batched and streaming requests (sessions s0 and s4 are at
# home on replicas 0 and 1, by crc32), a swap to a second checkpoint, a
# rollback verdict over the requests after it, a replica killed and
# restarted, more requests
LIVE_SCRIPT = (
    [{"op": "infer", "n": 4, "rows": 1}, {"op": "infer", "n": 2, "rows": 4},
     {"op": "infer", "n": 1, "rows": 16}, {"op": "drain"},
     {"op": "stream", "session": "s0", "windows": 8},
     {"op": "stream", "session": "s4", "windows": 5},
     {"op": "stream", "session": "s0", "windows": 3}, {"op": "drain"},
     {"op": "swap", "checkpoint": "CANDIDATE"},
     {"op": "infer", "n": 6, "rows": 2}, {"op": "stream", "session": "s4", "windows": 4},
     {"op": "drain"}, {"op": "rollback_check"}, {"op": "kill_replica", "slot": 0},
     {"op": "infer", "n": 3, "rows": 1}, {"op": "stream", "session": "s0", "windows": 2},
     {"op": "drain"}])
_PROM_LINE = None


def prometheus_problems(text: str) -> list:
    """Lines of a Prometheus text exposition (0.0.4) that do not parse: each
    line a ``# TYPE`` line or ``name{labels} value``."""
    import re

    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = (re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$"),
                      re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
                                 r'(\\.|[^"\\])*",?)*\})? (-?[0-9.e+-]+|NaN|[+-]Inf)$'))
    typ, sample = _PROM_LINE
    if not text.endswith("\n"):
        return ["no final newline"]
    return [ln for ln in text.splitlines() if ln and not (typ.match(ln) or sample.match(ln))]


def live_get(url: str) -> tuple:
    """One GET: (status, body, ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            code, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    return code, body, (time.perf_counter() - t0) * 1e3


def live_scrape(exporter) -> dict:
    """Each endpoint of a running exporter once: the payloads and the ms."""
    out = {}
    for path in LIVE_ENDPOINTS:
        code, body, ms = live_get(exporter.url(path))
        out[path] = {"code": code, "ms": ms,
                     "body": body if path == "/metrics" else json.loads(body)}
    return out


class LiveHooks:
    """The serving and daemon entry points watched from outside, for one
    run: the exporter the CLI starts, the kernel counters zeroed after each
    engine's warmup (the launches of a restarted replica's warmup are kept
    apart), the builds and loads since the first warmup, the end of the
    request script, and each daemon epoch's launches, loss and ms."""

    def __init__(self, torch, lc, pc, bc):
        from dinunet_implementations_tpu_torch.ops import _build
        from dinunet_implementations_tpu_torch.runner.fed_runner import FedDaemon
        from dinunet_implementations_tpu_torch.serving import InferenceEngine
        from dinunet_implementations_tpu_torch.serving import __main__ as serving_cli
        from dinunet_implementations_tpu_torch.telemetry.exporter import StatusExporter

        self.torch, self.lc, self.pc, self.bc, self._build = torch, lc, pc, bc, _build
        self.exporters, self.daemons, self.epochs = [], [], []
        self.warm_launches = {}
        self.builds_at_warmup = None
        self.script_done = threading.Event()
        self.on_script_done = None
        self.after_epoch = None
        self._patched = [(StatusExporter, "start"), (InferenceEngine, "warmup"),
                         (serving_cli, "run_script"), (FedDaemon, "train_epoch"),
                         (FedDaemon, "serve")]
        self._saved = [getattr(o, n) for o, n in self._patched]
        hooks = self
        start, warmup, run_script, train_epoch, serve = self._saved

        def start_(exporter):
            port = start(exporter)
            hooks.exporters.append(exporter)
            return port

        def warmup_(engine):
            torch.cuda.synchronize()
            before = read_counters(lc, pc, bc)
            times = warmup(engine)
            torch.cuda.synchronize()
            after = read_counters(lc, pc, bc)
            for k in after:
                hooks.warm_launches[k] = hooks.warm_launches.get(k, 0) + after[k] - before[k]
            if hooks.builds_at_warmup is None:
                hooks.builds_at_warmup = (_build.BUILDS, _build.LOADS)
            return times

        def run_script_(*args, **kw):
            fired = run_script(*args, **kw)
            hooks.script_done.set()
            if hooks.on_script_done is not None:
                hooks.on_script_done()
            return fired

        def train_epoch_(daemon):
            torch.cuda.synchronize()
            zero_counters(lc, pc, bc)
            t0 = time.perf_counter()
            loss = train_epoch(daemon)
            torch.cuda.synchronize()
            hooks.epochs.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                                 "launches": read_counters(lc, pc, bc)})
            if hooks.after_epoch is not None:
                hooks.after_epoch(daemon)
            return loss

        def serve_(daemon, *args, **kw):
            hooks.daemons.append(daemon)
            return serve(daemon, *args, **kw)

        for (owner, name), fn in zip(self._patched, (start_, warmup_, run_script_,
                                                     train_epoch_, serve_)):
            setattr(owner, name, fn)

    def launches(self) -> dict:
        """The counters since they were zeroed, less every warmup's."""
        got = read_counters(self.lc, self.pc, self.bc)
        return {k: v - self.warm_launches.get(k, 0) for k, v in got.items()}

    def builds_after_warmup(self) -> dict:
        b0, l0 = self.builds_at_warmup
        return {"kernel_builds": self._build.BUILDS - b0, "kernel_loads": self._build.LOADS - l0}

    def close(self) -> None:
        for (owner, name), fn in zip(self._patched, self._saved):
            setattr(owner, name, fn)


def live_serving_cli(torch, hooks, argv: list) -> dict:
    """One in-process run of the serving CLI from a zeroed set of counters
    and a fresh process bus; its exit code and its metrics rows."""
    from dinunet_implementations_tpu_torch.serving import __main__ as serving_cli
    from dinunet_implementations_tpu_torch.telemetry import global_bus
    from dinunet_implementations_tpu_torch.telemetry.sink import METRICS_FILE, load_metrics

    global_bus().reset()
    torch.cuda.synchronize()
    zero_counters(hooks.lc, hooks.pc, hooks.bc)
    t0 = time.perf_counter()
    rc = serving_cli.main(argv)
    torch.cuda.synchronize()
    out = argv[argv.index("--out-dir") + 1]
    rows = load_metrics(os.path.join(out, "telemetry", "serving", METRICS_FILE))
    return {"rc": rc, "seconds": time.perf_counter() - t0, "rows": rows,
            "launches": hooks.launches()}


def live_dispatch_cost(torch, np, cfg, ckpt: str, root: str) -> dict:
    """The host ms of a one-row request (one dispatch) with the tracer and
    the sink on against the engine without them, in turns (off, on, on,
    off), and the host µs of one span and one dispatch row alone."""
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.telemetry import SpanTracer
    from dinunet_implementations_tpu_torch.telemetry.sink import FitTelemetry

    tracer = SpanTracer()
    sink = FitTelemetry.open(os.path.join(root, "live_cost"), cfg, tracer=tracer,
                             device=torch.device("cuda"))
    engines = {"off": InferenceEngine(cfg, checkpoint=ckpt, row_buckets=(1,)),
               "on": InferenceEngine(cfg, checkpoint=ckpt, row_buckets=(1,), tracer=tracer,
                                     sink=sink)}
    x = np.random.default_rng(21).standard_normal((1, *engines["on"].sample_shape)).astype(
        np.float32)
    ms = {"off": [], "on": []}
    try:
        for eng in engines.values():
            eng.warmup()
            eng.submit(x).result(timeout=120)
        for arm in ("off", "on", "on", "off"):
            for _ in range(LIVE_COST_REQUESTS // 2):
                t0 = time.perf_counter()
                engines[arm].submit(x).result(timeout=120)
                ms[arm].append((time.perf_counter() - t0) * 1e3)
        # a span and a dispatch row alone, into the open sink (the "on"
        # engine's close closes it)
        row = {"kind": "dispatch", "lane": "infer", "bucket": 1, "rows": 1, "pad_rows": 0,
               "queue_depth": 0, "trace_ids": ["0123456789abcdef"]}
        t0 = time.perf_counter()
        for _ in range(200):
            with tracer.span("serve-infer", bucket=1, rows=1, trace_ids=row["trace_ids"]):
                pass
            sink.append(row)
        alone_us = (time.perf_counter() - t0) / 200 * 1e6
    finally:
        for eng in engines.values():
            eng.close()
    return {"request_ms_off_p50": statistics.median(ms["off"]),
            "request_ms_on_p50": statistics.median(ms["on"]),
            "request_ms_off_mean": statistics.fmean(ms["off"]),
            "request_ms_on_mean": statistics.fmean(ms["on"]),
            "span_and_row_host_us": alone_us, "requests_an_arm": len(ms["on"])}


def live_flagship(torch, np, hooks, smi: str, tree: str, root: str) -> dict:
    """(a): the flagship ICA checkpoint (2 x 174) through the serving CLI
    with --smoke, --statusz-port 0, --linger-s and --sanitize compile; the
    endpoints scraped during the linger; the report's --validate."""
    from dinunet_implementations_tpu_torch.checks.sanitize import ENV_VAR
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.telemetry import report

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    ckpt = os.path.join(root, "live_flagship", "checkpoint.msgpack")
    plane_checkpoint(torch, cfg, ckpt)
    out = os.path.join(root, "live_a")
    scraped = {}

    def scrape():
        # the linger: wait until the last dispatch has recorded its
        # requests, then each endpoint once and a flight dump
        ex = hooks.exporters[-1]
        deadline = time.monotonic() + LIVE_LINGER_S / 2
        while time.monotonic() < deadline:
            st = json.loads(live_get(ex.url("/statusz"))[1])
            if st["status"]["requests"] == LIVE_SMOKE and st["slo"]["samples"] == LIVE_SMOKE:
                break
            time.sleep(0.01)
        scraped.update(live_scrape(ex))
        t0 = time.perf_counter()
        scraped["flight_dump"] = {"path": ex.flight.dump("probe"),
                                  "ms": (time.perf_counter() - t0) * 1e3}

    scraper = threading.Thread(target=scrape, name="live-scraper", daemon=True)
    hooks.on_script_done = scraper.start
    env = os.environ.get(ENV_VAR)
    try:
        run = live_serving_cli(torch, hooks, [
            "--data-path", tree, "--task", NNComputation.TASK_ICA, "--checkpoint", ckpt,
            "--out-dir", out, "--smoke", str(LIVE_SMOKE), "--statusz-port", "0",
            "--linger-s", str(LIVE_LINGER_S), "--sanitize", "compile", "--quiet"])
        scraper.join(timeout=30)
    finally:
        hooks.on_script_done = None
        if env is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = env
    summary = run["rows"][-1]
    dispatches = [r for r in run["rows"] if r["kind"] == "dispatch"]
    launches = run["launches"]
    statusz = scraped.get("/statusz", {}).get("body", {})
    tracez = scraped.get("/tracez", {}).get("body", {})
    rec = {"rc": run["rc"], "seconds": run["seconds"], "requests": summary.get("requests"),
           "dispatches": summary.get("dispatches"), "dispatch_rows": len(dispatches),
           "latency_ms_p50": summary.get("latency_ms_p50"),
           "latency_ms_p99": summary.get("latency_ms_p99"),
           "requests_per_s": summary.get("requests_per_s"),
           "compiles_after_warmup": summary.get("compiles_after_warmup"),
           "builds_after_warmup": hooks.builds_after_warmup(),
           "launches": launches,
           "scrape_ms": {p: scraped[p]["ms"] for p in LIVE_ENDPOINTS if p in scraped},
           "scrape_codes": {p: scraped[p]["code"] for p in LIVE_ENDPOINTS if p in scraped},
           "prometheus_problems": prometheus_problems(scraped["/metrics"]["body"])
           if "/metrics" in scraped else ["not scraped"],
           "slo": statusz.get("slo"),
           "statusz_requests": statusz.get("status", {}).get("requests"),
           "tracez_serve_infer": sum(e.get("name") == "serve-infer"
                                     for e in tracez.get("recent", [])),
           "flight_dump_ms": scraped.get("flight_dump", {}).get("ms"),
           "validate_rc": report.main(["--validate",
                                       os.path.join(out, "telemetry", "serving")])}
    rec["dispatch_cost"] = live_dispatch_cost(torch, np, cfg, ckpt, root)
    print(f"live plane (a): the flagship through the serving CLI on {smi}:", json.dumps(rec))
    want_k1 = 2 * rec["dispatches"] if rec["dispatches"] else -1
    if rec["rc"] != 0 or rec["requests"] != LIVE_SMOKE or rec["dispatch_rows"] != rec["dispatches"]:
        fail(f"the serving CLI's flagship run: {rec}")
    if launches["lstm_fwd"] != want_k1 or launches["k1_cluster_route"] != want_k1 \
            or launches["k1_stream_route"] != 0 or launches["lstm_proj"] != want_k1:
        fail(f"K1 wants 2 launches a batched dispatch on the cluster route: {launches}")
    if rec["compiles_after_warmup"] != 0 or any(rec["builds_after_warmup"].values()):
        fail(f"the serving CLI built or loaded a kernel library after warmup: {rec}")
    if rec["scrape_codes"] != {p: 200 for p in LIVE_ENDPOINTS} or rec["prometheus_problems"]:
        fail(f"the endpoints during the linger: {rec}")
    if not rec["slo"] or rec["slo"]["samples"] != rec["requests"] \
            or rec["statusz_requests"] != rec["requests"]:
        fail(f"the /statusz SLO's samples against the requests served: {rec}")
    if rec["tracez_serve_infer"] < 1 or rec["flight_dump_ms"] is None \
            or rec["validate_rc"] != 0:
        fail(f"/tracez, the flight dump or the report's --validate: {rec}")
    return rec


def live_fleet(torch, np, hooks, smi: str, tree: str, root: str) -> dict:
    """(b): phase 15's unidirectional checkpoint (H = 348) through the same
    CLI with --replicas 2 and LIVE_SCRIPT: K1 on its stream route only, one
    launch a batched dispatch and two a shadow-scored batch; the rows
    labelled by replica; no library loaded by the swap or the restart."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.telemetry import report

    cfg = plane_cfg()
    ckpt = os.path.join(root, "live_uni", "checkpoint.msgpack")
    cand = os.path.join(root, "live_uni", "candidate.msgpack")
    plane_checkpoint(torch, cfg, ckpt)
    plane_checkpoint(torch, cfg.replace(seed=1), cand)
    script = os.path.join(root, "live_uni", "script.jsonl")
    with open(script, "w") as fh:
        for op in LIVE_SCRIPT:
            fh.write(json.dumps({**op, "checkpoint": cand} if op["op"] == "swap" else op) + "\n")
    out = os.path.join(root, "live_b")
    run = live_serving_cli(torch, hooks, [
        "--data-path", tree, "--task", NNComputation.TASK_ICA, "--checkpoint", ckpt,
        "--set", 'ica_args={"bidirectional": false}', "--out-dir", out, "--replicas", "2",
        "--script", script, "--rollback-window", "4", "--quiet"])
    rows = run["rows"]
    dispatches = [r for r in rows if r["kind"] == "dispatch"]
    infer = [r for r in dispatches if r["lane"] == "infer"]
    publish = [r for r in rows if r["kind"] == "publish"]
    shadow = sum((r.get("shadow") or {}).get("batches", 0) for r in publish)
    launches = run["launches"]
    want = len(infer) + 2 * shadow
    fleet = rows[-1]
    rec = {"rc": run["rc"], "seconds": run["seconds"], "dispatches": len(dispatches),
           "infer_dispatches": len(infer), "shadow_batches": shadow,
           "stream_dispatches": len(dispatches) - len(infer), "launches": launches,
           "kinds": sorted({r["kind"] for r in rows}),
           "replica_labels": sorted({str(r.get("replica")) for r in dispatches}),
           "publish": [{k: r.get(k) for k in ("outcome", "pause_ms")} for r in publish],
           "rollback": [{k: r.get(k) for k in ("burn", "rolled_back", "window_samples")}
                        for r in rows if r["kind"] == "rollback"],
           "restarts": fleet.get("restarts"), "requests": fleet.get("requests"),
           "compiles_after_warmup": fleet.get("compiles_after_warmup"),
           "builds_after_warmup": hooks.builds_after_warmup(),
           "latency_ms_p50": fleet.get("latency_ms_p50"),
           "latency_ms_p99": fleet.get("latency_ms_p99"),
           "validate_rc": report.main(["--validate",
                                       os.path.join(out, "telemetry", "serving")])}
    print(f"live plane (b): the unidirectional fleet through the serving CLI on {smi}:",
          json.dumps(rec))
    if rec["rc"] != 0 or rec["validate_rc"] != 0 or rec["restarts"] != 1 \
            or [p["outcome"] for p in rec["publish"]] != ["swapped"] or not rec["rollback"]:
        fail(f"the serving CLI's fleet run: {rec}")
    if launches["lstm_fwd"] != want or launches["k1_stream_route"] != want \
            or launches["k1_cluster_route"] != 0 or not rec["stream_dispatches"]:
        fail(f"K1 wants its stream route only, one launch a batched dispatch and two a "
             f"shadow batch ({want}): {rec}")
    if rec["replica_labels"] != ["0", "1"]:
        fail(f"the dispatch rows are not labelled by replica: {rec}")
    if rec["compiles_after_warmup"] != 0 or any(rec["builds_after_warmup"].values()):
        fail(f"the swap or the restart built or loaded a kernel library: {rec}")
    return rec


def live_same(a, b) -> bool:
    """Two state trees (dicts, tensors, numbers, None) equal bit for bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(live_same(a[k], b[k]) for k in a))
    if hasattr(a, "dtype") and hasattr(b, "dtype"):
        return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
    return a == b


def live_daemon_run(torch, hooks, tree: str, out: str, telemetry: bool) -> dict:
    """The runner CLI's daemon, rankDAD, LIVE_DAEMON_EPOCHS epochs, with the
    exporter on; the endpoints scraped after epoch 2."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.runner import cli
    from dinunet_implementations_tpu_torch.telemetry import global_bus

    scraped = {}

    def after(daemon):
        if daemon.epochs_run == 2:
            scraped.update(live_scrape(hooks.exporters[-1]))

    global_bus().reset()
    hooks.epochs.clear()
    hooks.after_epoch = after
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--data-path", tree, "--task", NNComputation.TASK_ICA, "--engine",
                       "rankDAD", "--serve", "--serve-epochs", str(LIVE_DAEMON_EPOCHS),
                       "--serve-poll", "0.01", "--out-dir", out, "--statusz-port", "0",
                       "--slo-p99-ms", str(LIVE_SLO_MS), "--telemetry",
                       "on" if telemetry else "off", "--quiet"])
        seconds = time.perf_counter() - t0
    finally:
        hooks.after_epoch = None
    return {"rc": rc, "seconds": seconds, "daemon": hooks.daemons[-1],
            "epochs": [dict(e) for e in hooks.epochs], "scraped": scraped}


def live_sigterm(smi: str, tree: str, out: str) -> dict:
    """A telemetry-on daemon in a process of its own, sent SIGTERM once its
    first epoch is checkpointed: it stops after the epoch in flight and
    leaves ``flight_<pid>.json`` with the final spans and the bus."""
    import signal

    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.telemetry import flight_files

    argv = ["--data-path", tree, "--task", NNComputation.TASK_ICA, "--engine", "rankDAD",
            "--serve", "--serve-epochs", "50", "--serve-poll", "0.01", "--out-dir", out,
            "--statusz-port", "0", "--slo-p99-ms", str(LIVE_SLO_MS), "--telemetry", "on",
            "--quiet"]
    code = ("import sys\nfrom dinunet_implementations_tpu_torch.runner import cli\n"
            f"sys.exit(cli.main({argv!r}))\n")
    ann = os.path.join(out, "serve", "publish.json")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    epoch, sent = 0, None
    try:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with open(ann) as fh:
                    epoch = json.load(fh)["epoch"]
            except (OSError, ValueError, KeyError):
                pass
            if epoch >= 1:
                sent = time.perf_counter() - t0
                proc.send_signal(signal.SIGTERM)
                break
            time.sleep(0.05)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    dumps = flight_files(out)
    payload = {}
    if dumps:
        with open(dumps[0]) as fh:
            payload = json.load(fh)
    names = [e.get("name") for e in payload.get("events", [])]
    try:
        summary = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        summary = {}
    rec = {"returncode": proc.returncode, "signal_sent_s": sent,
           "seconds": time.perf_counter() - t0, "dumps": [os.path.basename(p) for p in dumps],
           "pid": proc.pid, "reason": payload.get("reason"),
           "events": len(names), "epoch_spans": names.count("epoch"),
           "last_event": names[-1] if names else None,
           "bus_epochs": (payload.get("bus") or {}).get("counters", {}).get(
               "serve_epochs_total"),
           "epochs_run": summary.get("epochs_run"), "preempted": summary.get("preempted")}
    print(f"live plane (c): SIGTERM after epoch 1 on {smi}:", json.dumps(rec))
    if proc.returncode != 0 or sent is None or rec["dumps"] != [f"flight_{proc.pid}.json"] \
            or rec["reason"] != f"signal:{int(signal.SIGTERM)}" or rec["epoch_spans"] < 1 \
            or rec["last_event"] != "signal" or not rec["bus_epochs"] or not rec["preempted"]:
        fail(f"the daemon's flight dump on SIGTERM: {rec} {stderr[-4000:]}")
    return rec


def live_daemon(torch, hooks, smi: str, tree: str, root: str) -> dict:
    """(c): the runner CLI's daemon over phase 18's tree, telemetry on and
    off: the same state and losses bit for bit, the same launches an epoch
    (K1 and K2 on the cluster route, K7 staged, no plain class), /healthz
    200 and the SLO's samples an epoch; then the SIGTERM run."""
    runs = {arm: live_daemon_run(torch, hooks, tree, os.path.join(root, f"live_c_{arm}"),
                                 arm == "on") for arm in ("on", "off")}
    on, off = runs["on"], runs["off"]
    s_on, s_off = on["daemon"].state, off["daemon"].state
    equal = {part: live_same(getattr(s_on, part), getattr(s_off, part))
             for part in ("params", "batch_stats", "opt_state", "engine_state", "health")}
    losses_equal = [e["loss"] for e in on["epochs"]] == [e["loss"] for e in off["epochs"]]
    per_epoch = [e["launches"] for e in on["epochs"]]
    statusz = on["scraped"].get("/statusz", {}).get("body", {})
    rec = {"rc": [on["rc"], off["rc"]], "seconds": [on["seconds"], off["seconds"]],
           "epoch_ms_on": [e["ms"] for e in on["epochs"]],
           "epoch_ms_off": [e["ms"] for e in off["epochs"]],
           "losses": [e["loss"] for e in on["epochs"]], "state_equal": equal,
           "losses_equal": losses_equal, "launches_per_epoch": per_epoch,
           "launches_equal": per_epoch == [e["launches"] for e in off["epochs"]],
           "scrape_ms": {p: v["ms"] for p, v in on["scraped"].items()},
           "scrape_codes": {p: v["code"] for p, v in on["scraped"].items()},
           "slo": statusz.get("slo"),
           "prometheus_problems": prometheus_problems(on["scraped"]["/metrics"]["body"])
           if "/metrics" in on["scraped"] else ["not scraped"]}
    print(f"live plane (c): the daemon through the command line, telemetry on and off, on "
          f"{smi}:", json.dumps(rec, default=float))
    if rec["rc"] != [0, 0] or len(per_epoch) != LIVE_DAEMON_EPOCHS:
        fail(f"the command line's daemon: {rec}")
    if not all(equal.values()) or not losses_equal or not rec["launches_equal"]:
        fail(f"the daemon with telemetry on differs from off: {rec}")
    for e in per_epoch:
        if not (e["lstm_fwd"] > 0 and e["k1_cluster_route"] == e["lstm_fwd"]
                and e["k1_stream_route"] == 0 and e["lstm_bwd"] > 0
                and e["k2_cluster_route"] == e["lstm_bwd"] and e["poweriter"] > 0
                and e["k7_staged_route"] == e["poweriter"]
                and e["poweriter_plain_classes"] == 0):
            fail(f"an epoch of the daemon off its routes: {e}")
    if rec["scrape_codes"] != {p: 200 for p in LIVE_ENDPOINTS} or rec["prometheus_problems"] \
            or not rec["slo"] or rec["slo"]["samples"] != 2:
        fail(f"the daemon's endpoints after epoch 2: {rec}")
    rec["sigterm"] = live_sigterm(smi, tree, os.path.join(root, "live_c_sigterm"))
    return rec


def live_phase(torch, np, lc, pc, bc, smi: str, root: str) -> dict:
    """Phase 21 of the module docstring: the live plane and the serving CLI."""
    t_phase = time.perf_counter()
    tree = daemon_tree(os.path.join(root, "live_tree"))
    hooks = LiveHooks(torch, lc, pc, bc)
    try:
        flagship = live_flagship(torch, np, hooks, smi, tree, root)
        hooks.warm_launches, hooks.builds_at_warmup = {}, None
        fleet = live_fleet(torch, np, hooks, smi, tree, root)
        daemon = live_daemon(torch, hooks, smi, tree, root)
    finally:
        hooks.close()
    rec = {"flagship": flagship, "fleet": fleet, "daemon": daemon,
           "seconds": time.perf_counter() - t_phase}
    cost = flagship["dispatch_cost"]
    line = {
        "card": smi,
        "cli_latency_ms_p50": flagship["latency_ms_p50"],
        "cli_latency_ms_p99": flagship["latency_ms_p99"],
        "cli_requests_per_s": flagship["requests_per_s"],
        "fleet_latency_ms_p50": fleet["latency_ms_p50"],
        "fleet_latency_ms_p99": fleet["latency_ms_p99"],
        "serving_scrape_ms": flagship["scrape_ms"], "daemon_scrape_ms": daemon["scrape_ms"],
        "flight_dump_ms": flagship["flight_dump_ms"],
        "request_ms_p50_tracer_sink_on": cost["request_ms_on_p50"],
        "request_ms_p50_tracer_sink_off": cost["request_ms_off_p50"],
        "span_and_row_host_us": cost["span_and_row_host_us"],
        "daemon_epoch_ms_on": daemon["epoch_ms_on"], "daemon_epoch_ms_off": daemon["epoch_ms_off"],
        "sigterm_s": daemon["sigterm"]["seconds"], "phase_seconds": rec["seconds"]}
    print("live plane:", json.dumps(line, default=float))
    return rec


# The fleet scheduler and the notebooks' tables (phase 22): analysis's
# engine comparison on phase 11's tree (each engine's epochs cut from the
# default 101), its pretrain study on phase 14's tree, the scheduler's
# checkpoint-then-yield in process at one slice, its command line and the
# backfill lane.
SCHED_ENGINES = ("dSGD", "rankDAD", "powerSGD")
SCHED_FIT_EPOCHS = 2  # each engine of the comparison, cut from the default 101
SCHED_STUDY = dict(folds=[0, 1], pretrain_epochs=2, epochs=3)
SCHED_ICA_EPOCHS, SCHED_ICA_STEPS, SCHED_FS_EPOCHS = 4, 2, 2
SCHED_BACKFILL_ROWS, SCHED_BACKFILL_REQUESTS = 4, 4


class CountedRuns:
    """``analysis.FedRunner`` replaced, for one ``with``, by a runner whose
    every ``run`` is a main-path run: the kernel counters zeroed just
    before it and read just after, with its results, runner and seconds."""

    def __init__(self, torch, lc, pc, bc):
        self.torch, self.lc, self.pc, self.bc = torch, lc, pc, bc
        self.runs = []

    def __enter__(self):
        from dinunet_implementations_tpu_torch import analysis
        from dinunet_implementations_tpu_torch.runner import FedRunner

        hooks = self

        class Counted(FedRunner):
            def run(self, folds=None, verbose=True, resume=False):
                hooks.torch.cuda.synchronize()
                zero_counters(hooks.lc, hooks.pc, hooks.bc)  # the main path's run starts here
                t0 = time.perf_counter()
                res = super().run(folds=folds, verbose=verbose, resume=resume)
                hooks.torch.cuda.synchronize()
                hooks.runs.append({"runner": self, "results": res, "folds": folds,
                                   "seconds": time.perf_counter() - t0,
                                   "launches": read_counters(hooks.lc, hooks.pc, hooks.bc)})
                return res

        self._saved = analysis.FedRunner
        analysis.FedRunner = Counted
        return self.runs

    def __exit__(self, *exc):
        from dinunet_implementations_tpu_torch import analysis

        analysis.FedRunner = self._saved
        return False


def sched_fold_rounds(runner, fold_ids) -> dict:
    """Each fold's rounds an epoch and eval steps, from the runner's own
    splits."""
    from dinunet_implementations_tpu_torch.data import epoch_steps, plan_eval
    from dinunet_implementations_tpu_torch.runner import load_site_splits

    cfg = runner.cfg
    folds = load_site_splits(cfg, runner.site_dirs, runner.site_cfgs)
    return {k: {"rounds": epoch_steps(folds[k]["train"], cfg.batch_size) // cfg.local_iterations,
                "val_steps": plan_eval(folds[k]["validation"], cfg.batch_size).steps,
                "test_steps": plan_eval(folds[k]["test"], cfg.batch_size).steps}
            for k in fold_ids}


def sched_analysis(torch, np, lc, pc, bc, smi: str, ica_tree: str, fs_tree: str,
                   root: str) -> dict:
    """(a) ``analysis.engine_comparison`` on a tree of phase 18's shape
    (``ica_tree``) and (b) ``analysis.pretrain_study`` on phase 14's, on
    the card. Not phase 11's 32 sites: each fit zips its checkpoints into a
    copy a site (FedRunner's remote transfer), and powerSGD's error state
    makes that ~18 GB a fit there, past what the card's machine lets a
    run write."""
    from dinunet_implementations_tpu_torch import analysis
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig

    out_a = os.path.join(root, "sched_a")
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, epochs=SCHED_FIT_EPOCHS, patience=35,
                      seed=0)
    with CountedRuns(torch, lc, pc, bc) as runs:
        report = analysis.engine_comparison(ica_tree, out_a, engines=SCHED_ENGINES, base_cfg=cfg)
    fits = {}
    for run in runs:
        runner, res = run["runner"], run["results"][0]
        engine, fcfg = runner.cfg.agg_engine, runner.cfg
        a = fcfg.ica_args
        if (a.input_size, a.hidden_size, a.num_components, fcfg.num_sites) != (256, 348, 100,
                                                                               DAEMON_SITES):
            fail(f"engine comparison {engine}: not the flagship's width: {a}, {fcfg.num_sites}")
        shape = sched_fold_rounds(runner, [0])[0]
        epochs = len(res["epoch_losses"])
        micro = epochs * shape["rounds"] * fcfg.local_iterations
        evals = epochs * shape["val_steps"] + shape["test_steps"]
        launches = run["launches"]
        routes = k7_routes(torch, pc, fcfg, DAEMON_SITES) if engine == "rankDAD" else {}
        want = (k7_want(launches, routes, epochs * shape["rounds"]) if engine == "rankDAD"
                else dict.fromkeys(launches, 0)) | {
            "lstm_fwd": 2 * (micro + evals), "lstm_proj": 2 * (micro + evals),
            "k1_cluster_route": 2 * (micro + evals), "lstm_bwd": 2 * micro,
            "k2_cluster_route": 2 * micro}
        if launches != want or any(r != ["staged"] for r in routes.values()):
            fail(f"engine comparison {engine}: launches {launches}, want {want} (K7 routes "
                 f"{routes}, all staged)")
        with open(os.path.join(out_a, engine, "remote", "simulatorRun", fcfg.task_id, "fold_0",
                               "logs.json")) as fh:
            lg = json.load(fh)
        row = report["engines"][engine]
        if row != {"test_metrics": lg["test_metrics"][0],
                   "total_duration": lg["cumulative_total_duration"][-1],
                   "computation_time": sum(lg["time_spent_on_computation"]),
                   "best_val_epoch": lg["best_val_epoch"]} \
                or row["best_val_epoch"] != res["best_val_epoch"] \
                or not np.isfinite(row["test_metrics"]).all():
            fail(f"engine comparison {engine}: the row {row} is not its fit's logs.json")
        fits[engine] = {"seconds": run["seconds"], "epochs": epochs,
                        "rounds_per_epoch": shape["rounds"], "launches": launches,
                        "k7_routes": routes, "row": row}
    md = os.path.join(out_a, "engine_comparison.md")
    if list(fits) != list(SCHED_ENGINES) or not os.path.isfile(md):
        fail(f"engine comparison: fits {list(fits)}, {md} written: {os.path.isfile(md)}")
    print(f"analysis (a): engine_comparison on a tree of phase 18's shape ({DAEMON_SITES} sites, "
          f"{SCHED_FIT_EPOCHS} epochs an engine) on {smi}:", json.dumps(fits, default=float))
    print(report["summary_markdown"])

    out_b = os.path.join(root, "sched_b")
    base = TrainConfig(agg_engine="rankDAD", epochs=SCHED_STUDY["epochs"], patience=35, seed=0)
    with CountedRuns(torch, lc, pc, bc) as runs:
        study = analysis.pretrain_study(fs_tree, out_b, folds=SCHED_STUDY["folds"],
                                        pretrain_epochs=SCHED_STUDY["pretrain_epochs"],
                                        base_cfg=base)
    arms = {}
    for run in runs:
        runner, fcfg = run["runner"], run["runner"].cfg
        arm = "pretrained" if fcfg.pretrain else "scratch"
        shapes = sched_fold_rounds(runner, SCHED_STUDY["folds"])
        rounds = sum(len(r["epoch_losses"]) * shapes[k]["rounds"]
                     for k, r in zip(SCHED_STUDY["folds"], run["results"]))
        routes = k7_routes(torch, pc, fcfg, FS_SITES)
        want = k7_want(run["launches"], routes, rounds)
        if run["launches"] != want or routes != {10: ["direct"], 2: ["staged"]}:
            fail(f"pretrain study {arm}: launches {run['launches']}, want {want} (K7 routes "
                 f"{routes}: r=10 direct, r=2 staged as phase 14)")
        arms[arm] = {"seconds": run["seconds"], "rounds": rounds, "launches": run["launches"],
                     "k7_routes": {str(r): v for r, v in routes.items()},
                     "best_val_epochs": study["arms"][arm]["best_val_epochs"],
                     "test_aucs": study["arms"][arm]["test_aucs"]}
    with open(os.path.join(out_b, "pretrain_study.csv")) as fh:
        rows = [ln.rstrip("\n").split(",") for ln in fh]
    if rows[0] != ["arm", "fold", "best_val_epoch", "test_auc", "test_loss"] \
            or len(rows) != 1 + 2 * len(SCHED_STUDY["folds"]) or set(arms) != {"scratch",
                                                                             "pretrained"}:
        fail(f"pretrain study: the CSV {rows}, arms {list(arms)}")
    import importlib.util

    plots = importlib.util.find_spec("matplotlib") is not None
    if len(study["figures"]) != (2 if plots else 0):
        fail(f"write_study_figures wrote {study['figures']} with matplotlib "
             f"{'present' if plots else 'absent'}")
    print(f"analysis (b): pretrain_study on phase 14's tree ({FS_SITES} sites, rankDAD, folds "
          f"{SCHED_STUDY['folds']}) on {smi}: write_study_figures returned {study['figures']} "
          f"(matplotlib {'present' if plots else 'absent'});", json.dumps(arms, default=float))
    return {"engine_comparison": fits, "pretrain_study": arms,
            "epoch_speedup": study["epoch_speedup"]}


def sched_epoch_ok(e: dict) -> bool:
    """K1 and K2 on the cluster route, K7 staged, no plain class."""
    return (e["lstm_fwd"] > 0 and e["k1_cluster_route"] == e["lstm_fwd"]
            and e["k1_stream_route"] == 0 and e["lstm_bwd"] > 0
            and e["k2_cluster_route"] == e["lstm_bwd"] and e["k2_stream_route"] == 0
            and e["poweriter"] > 0 and e["k7_staged_route"] == e["poweriter"]
            and e["poweriter_plain_classes"] == 0)


def sched_preemption(torch, np, lc, pc, bc, smi: str, ica_tree: str, fs_tree: str,
                     root: str) -> dict:
    """(c) ``FleetScheduler(pod_slices=1)``: "ica" (phase 18's tree,
    rankDAD, 2 rounds an epoch) trains 2 epochs, "fs" arrives at a higher
    priority and takes the slice (checkpoint, then the yield), trains and
    finishes, "ica" resumes through the checkpoint reload and finishes its
    4; against a solo daemon of the same 4 epochs."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner import FedDaemon
    from dinunet_implementations_tpu_torch.runner.scheduler import (
        GRANTS_FILE,
        FleetScheduler,
        Tenant,
        TenantSpec,
    )
    from dinunet_implementations_tpu_torch.telemetry import MetricsBus
    from dinunet_implementations_tpu_torch.trainer import params_digest

    ica_cfg = TrainConfig(task_id=NNComputation.TASK_ICA, agg_engine="rankDAD",
                          batch_size=TRAIN_BATCH, seed=0)
    fs_cfg = TrainConfig(agg_engine="rankDAD", seed=0)
    epochs = []

    def counted(train):
        def run(*args):
            torch.cuda.synchronize()
            zero_counters(lc, pc, bc)  # each epoch of the main path starts here
            t0 = time.perf_counter()
            loss = train(*args)
            torch.cuda.synchronize()
            epochs.append({"tenant": args[0].spec.tenant if args else "solo", "loss": loss,
                           "ms": (time.perf_counter() - t0) * 1e3,
                           "launches": read_counters(lc, pc, bc)})
            return loss
        return run

    sched_root = os.path.join(root, "sched_c")
    saved = Tenant.train_epoch
    Tenant.train_epoch = counted(saved)
    try:
        sched = FleetScheduler(sched_root, pod_slices=1, bus=MetricsBus(), poll_s=0.0,
                               verbose=False)
        ica = sched.register(TenantSpec("ica", data_path=ica_tree, config=ica_cfg,
                                        capacity=DAEMON_CAPACITY, steps=SCHED_ICA_STEPS,
                                        max_epochs=SCHED_ICA_EPOCHS))
        ticks = [sched.tick(sleep_when_idle=False) for _ in range(2)]
        fs = sched.register(TenantSpec("fs", data_path=fs_tree, config=fs_cfg, capacity=FS_SITES,
                                       priority=2.0, max_epochs=SCHED_FS_EPOCHS))
        while not sched.done() and len(ticks) < 20:
            ticks.append(sched.tick(sleep_when_idle=False))
        digest = ica.params_digest()
        goodput, idle = sched.goodput(), sched.idle_fraction()
        pauses = {t.spec.tenant: t.pauses_ms for t in (ica, fs)}
        out = sched.close()  # each tenant's compile guard: raises on a late library
    finally:
        Tenant.train_epoch = saved
    sched_epochs, epochs[:] = list(epochs), []
    solo = FedDaemon(ica_cfg, capacity=DAEMON_CAPACITY, data_path=ica_tree,
                     out_dir=os.path.join(root, "sched_solo"),
                     spool_dir=os.path.join(root, "sched_solo", "spool"), poll_s=0.0,
                     steps=SCHED_ICA_STEPS, verbose=False)
    solo.train_epoch = counted(solo.train_epoch)
    solo.serve(max_epochs=SCHED_ICA_EPOCHS)
    solo_digest = params_digest(solo.state.params, solo.state.batch_stats)
    with open(os.path.join(sched_root, GRANTS_FILE)) as fh:
        grants = [json.loads(ln)["grants"] for ln in fh]
    ica_epochs = [e["launches"] for e in sched_epochs if e["tenant"] == "ica"]
    solo_epochs = [e["launches"] for e in epochs]
    order = [e["tenant"] for e in sched_epochs]
    rec = {"card": smi, "ticks": len(ticks), "order": order,
           "grants": grants, "pauses_ms": pauses, "goodput": goodput, "idle_fraction": idle,
           "ica_epoch_ms": [e["ms"] for e in sched_epochs if e["tenant"] == "ica"],
           "fs_epoch_ms": [e["ms"] for e in sched_epochs if e["tenant"] == "fs"],
           "solo_epoch_ms": [e["ms"] for e in epochs],
           "ica_launches_per_epoch": ica_epochs,
           "fs_launches_per_epoch": [e["launches"] for e in sched_epochs if e["tenant"] == "fs"],
           "digest_equal": digest == solo_digest,
           "compiles_after_first_epoch": {n: s["compiles_after_first_epoch"]
                                          for n, s in out["tenants"].items()}}
    print(f"scheduler (c): preemption at one slice on {smi}: pauses ms {pauses}, goodput "
          f"{json.dumps(goodput)}, idle_fraction {idle}:", json.dumps(rec, default=float))
    ica_grants = [g.get("ica") for g in grants]
    if order != ["ica"] * 2 + ["fs"] * SCHED_FS_EPOCHS + ["ica"] * (SCHED_ICA_EPOCHS - 2):
        fail(f"the scheduler's epochs ran in the order {order}")
    if not rec["digest_equal"]:
        fail("the preempted and resumed tenant differs from the solo daemon")
    if ica_epochs != solo_epochs or not all(sched_epoch_ok(e) for e in ica_epochs):
        fail(f"the tenant's epochs launched {ica_epochs}, the solo daemon's {solo_epochs}")
    if not all(e["poweriter"] > 0 and e["poweriter_plain_classes"] == 0 and e["lstm_fwd"] == 0
               for e in rec["fs_launches_per_epoch"]):
        fail(f"the FS tenant's epochs launched {rec['fs_launches_per_epoch']}")
    if ica_grants[:3] != [1, 0, 1] or grants[1] != {"fs": 1, "ica": 0}:
        fail(f"the grant log does not show the yield and the resume: {grants}")
    if any(any(c.values()) for c in rec["compiles_after_first_epoch"].values()):
        fail(f"a tenant built or loaded a kernel library after its first epoch: {rec}")
    if goodput["preempt_count"] != 1 or not goodput["preempt_pause_ms_p99"] > 0:
        fail(f"the scheduler's goodput: {goodput}")
    return rec


def sched_cli_and_backfill(torch, np, lc, pc, bc, smi: str, fs_tree: str, root: str) -> dict:
    """(d) the runner CLI's ``--schedule`` over a spool of a register and a
    shutdown; a ``BackfillLane`` serving the flagship checkpoint beside a
    tenant held below its quorum."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.ops import _build
    from dinunet_implementations_tpu_torch.runner import cli
    from dinunet_implementations_tpu_torch.runner.registry import get_task
    from dinunet_implementations_tpu_torch.runner.scheduler import (
        BackfillLane,
        FleetScheduler,
        TenantSpec,
    )
    from dinunet_implementations_tpu_torch.telemetry import MetricsBus

    cli_root = os.path.join(root, "sched_d")
    os.makedirs(os.path.join(cli_root, "spool"))
    for name, ev in (("ev000.json", {"event": "register", "tenant": "fs1", "data_path": fs_tree,
                                     "capacity": FS_SITES, "max_epochs": 1,
                                     "config": {"agg_engine": "dSGD"}}),
                     ("ev001.json", {"event": "shutdown"})):
        with open(os.path.join(cli_root, "spool", name), "w") as fh:
            json.dump(ev, fh)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--data-path", cli_root, "--schedule", "--pod-slices", "1",
                       "--sched-ticks", "3", "--quiet"])
    cli_s = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]

    def strict(c):
        fail(f"the --schedule summary is not strict JSON: {c}")

    summary = json.loads(line, parse_constant=strict)
    if rc != 0 or list(summary["tenants"]) != ["fs1"] \
            or summary["tenants"]["fs1"]["epochs_run"] != 1:
        fail(f"the command line's --schedule: rc {rc}, {line}")

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    ckpt = os.path.join(root, "sched_backfill", "checkpoint.msgpack")
    plane_checkpoint(torch, cfg, ckpt)
    shape = get_task(cfg.task_id).serving.sample_shape(cfg)
    rng = np.random.default_rng(22)
    lane = BackfillLane(cfg, lambda: rng.standard_normal((SCHED_BACKFILL_ROWS,) + tuple(shape))
                        .astype(np.float32), checkpoint=ckpt, replicas=1,
                        requests_per_quantum=SCHED_BACKFILL_REQUESTS)
    sched = FleetScheduler(os.path.join(root, "sched_bf"), pod_slices=1, bus=MetricsBus(),
                           poll_s=0.0, verbose=False, backfill=lane)
    sched.register(TenantSpec("held", data_path=fs_tree, config=TrainConfig(seed=0),
                              capacity=8, quorum=8, max_epochs=1))
    first = sched.tick(sleep_when_idle=False)  # the lane's warmup and first quantum
    torch.cuda.synchronize()
    builds0 = (_build.BUILDS, _build.LOADS)
    d0 = lane._set.summary()["dispatches"]
    zero_counters(lc, pc, bc)  # the main path's run starts here
    t0 = time.perf_counter()
    second = sched.tick(sleep_when_idle=False)
    torch.cuda.synchronize()
    quantum_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters(lc, pc, bc)
    dispatches = lane._set.summary()["dispatches"] - d0
    builds = (_build.BUILDS - builds0[0], _build.LOADS - builds0[1])
    out = sched.close()  # the lane's fleet checks no library after its warmup
    rec = {"card": smi, "cli_rc": rc, "cli_seconds": cli_s, "cli_goodput": summary["goodput"],
           "served": [first["served"], second["served"]], "grants": second["grants"],
           "dispatches": dispatches, "launches": launches, "quantum_ms": quantum_ms,
           "builds_after_warmup": builds, "backfill": out["backfill"]["requests_served"]}
    print(f"scheduler (d): the CLI's --schedule and the backfill lane on {smi}:",
          json.dumps(rec, default=float))
    want = 2 * dispatches
    if second["served"]["requests"] != SCHED_BACKFILL_REQUESTS or second["grants"] != {"held": 0} \
            or dispatches < 1 or launches["lstm_fwd"] != want \
            or launches["k1_cluster_route"] != want or launches["lstm_proj"] != want \
            or launches["k1_stream_route"] != 0 or builds != (0, 0):
        fail(f"the backfill lane: {rec}; K1 wants 2 launches a dispatch on the cluster route")
    return rec


def sched_phase(torch, np, lc, pc, bc, smi: str, root: str, ica_tree: str | None = None,
                fs_tree: str | None = None) -> dict:
    """Phase 22 of the module docstring: analysis and the fleet scheduler;
    makes an ICA tree of phase 18's shape and phase 14's FS tree under
    ``root`` when not given."""
    from dinunet_implementations_tpu_torch.data import make_fs_demo_tree

    t_phase = time.perf_counter()
    ica_tree = ica_tree or daemon_tree(os.path.join(root, "sched_ica_tree"))
    fs_tree = fs_tree or make_fs_demo_tree(os.path.join(root, "sched_fs_tree"),
                                           n_sites=FS_SITES, subjects=FS_SUBJECTS, seed=0)
    rec = {"analysis": sched_analysis(torch, np, lc, pc, bc, smi, ica_tree, fs_tree, root)}
    rec["preemption"] = sched_preemption(torch, np, lc, pc, bc, smi, ica_tree, fs_tree, root)
    rec["cli_backfill"] = sched_cli_and_backfill(torch, np, lc, pc, bc, smi, fs_tree, root)
    rec["seconds"] = time.perf_counter() - t_phase
    pre = rec["preemption"]
    line = {"card": smi, "fit_seconds": {e: f["seconds"] for e, f in
                                         rec["analysis"]["engine_comparison"].items()},
            "study_seconds": {a: v["seconds"] for a, v in
                              rec["analysis"]["pretrain_study"].items()},
            "preempt_pauses_ms": pre["pauses_ms"], "goodput": pre["goodput"],
            "idle_fraction": pre["idle_fraction"], "ica_epoch_ms": pre["ica_epoch_ms"],
            "solo_epoch_ms": pre["solo_epoch_ms"],
            "backfill_quantum_ms": rec["cli_backfill"]["quantum_ms"],
            "phase_seconds": rec["seconds"]}
    print("scheduler:", json.dumps(line, default=float))
    return rec


# The supervisor and the pod plane (phase 23): a supervised SIGKILL drill
# of a real port fit (scripts/torch_pod_worker.py) on phase 21's tree, and
# the runner CLI's --schedule --statusz-port.
POD_EPOCHS, POD_KILL_EPOCH = 3, 2
POD_RUN_KEYS = ("lstm_fwd", "lstm_bwd", "poweriter")


def pod_worker_cmd(tree: str, out: str, generation: int, result: str) -> list:
    """The worker script's command line."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [sys.executable, os.path.join(here, "scripts", "torch_pod_worker.py"),
            "--data-path", tree, "--out-dir", out, "--generation", str(generation),
            "--epochs", str(POD_EPOCHS), "--result", result]


def pod_worker_spawn(tree: str, out: str, trace: str, results: dict):
    """``spawn(process_id, generation)`` for the supervisor: the worker
    script on ``tree`` into ``out``, ``--resume`` after the first
    generation, its result file in ``results[generation]``."""
    here = os.path.dirname(os.path.abspath(__file__))

    def spawn(process_id, generation):
        results[generation] = os.path.join(out, f"worker_gen{generation}.json")
        cmd = pod_worker_cmd(tree, out, generation, results[generation]) + [
            "--kill-epoch", str(POD_KILL_EPOCH), "--pod-trace", trace]
        if generation > 1:
            cmd.append("--resume")
        log = open(os.path.join(out, f"worker_gen{generation}.log"), "w")
        try:
            return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=here)
        finally:
            log.close()

    return spawn


def pod_consensus(pod: str, flight, installs: list):
    """The supervisor's ``on_consensus``: ``dcn_worker --supervise``'s own
    install (``runner/dcn_worker.py install_consensus``) over the one
    slice, which writes the decision where the post-mortem reads it, in
    the format of the JAX package's worker. The kill lands after both of
    epoch 1's checkpoints, so the two agree (the drill holds it) and
    nothing is copied (``replaced`` false: the fold's checkpoint sits at
    the agreed epoch, its ``fold_epoch`` here)."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation
    from dinunet_implementations_tpu_torch.runner.dcn_worker import install_consensus

    def install(generation: int, dead_slice: int) -> None:
        t0 = time.perf_counter()
        decision = install_consensus(pod, NNComputation.TASK_ICA, 1, generation, dead_slice,
                                     flight)
        fold_epoch = (decision["epoch"] if decision["round"] is not None
                      and not decision["replaced"] else None)
        installs.append({**decision, "fold_epoch": fold_epoch,
                         "ms": (time.perf_counter() - t0) * 1e3})

    return install


def pod_read(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def pod_routes_ok(launches: dict) -> bool:
    """K1, K2 and K7 launched, K1 and K2 on the cluster route, K7 staged,
    no rank class sent to the plain power iteration."""
    return (launches["lstm_fwd"] > 0 and launches["k1_cluster_route"] == launches["lstm_fwd"]
            and launches["lstm_bwd"] > 0
            and launches["k2_cluster_route"] == launches["lstm_bwd"]
            and launches["poweriter"] > 0
            and launches["k7_staged_route"] == launches["poweriter"]
            and launches["poweriter_plain_classes"] == 0)


def pod_drill(torch, smi: str, tree: str, root: str) -> dict:
    """(a): the supervised SIGKILL drill (the module docstring), then the
    same worker run alone and uninterrupted, for the digest and launches it
    is held to."""
    import contextlib
    import io

    from dinunet_implementations_tpu_torch.runner.supervisor import SliceSupervisor
    from dinunet_implementations_tpu_torch.telemetry import (
        FlightRecorder,
        MetricsBus,
        SpanTracer,
        new_trace_id,
    )
    from dinunet_implementations_tpu_torch.telemetry import assemble, postmortem
    from dinunet_implementations_tpu_torch.telemetry.collector import PodCollector

    pod, solo_dir = os.path.join(root, "pod_a"), os.path.join(root, "pod_a_solo")
    os.makedirs(pod)
    os.makedirs(solo_dir)
    trace, results, installs = new_trace_id(), {}, []
    bus, tracer = MetricsBus(), SpanTracer()
    flight = FlightRecorder(pod, bus=bus, tracer=tracer)
    sup = SliceSupervisor(pod_worker_spawn(tree, pod, trace, results), num_processes=1,
                          out_dir=pod, heartbeat_timeout_s=120.0, max_restarts=1, poll_s=0.05,
                          grace_s=20.0, flight=flight, bus=bus,
                          on_consensus=pod_consensus(pod, flight, installs))
    collector = PodCollector(pod, local_bus=bus, local_labels={"process": "supervisor"},
                             cache_s=0.0)
    t0 = time.perf_counter()
    box = {}

    def supervise():
        try:
            with tracer.span("supervise", trace=trace, processes=1):
                box["rc"] = sup.run()
        except BaseException as e:  # the main thread reports it
            box["error"] = repr(e)

    thread = threading.Thread(target=supervise, name="pod-supervisor")
    thread.start()
    scraped, scrapes = None, 0
    while thread.is_alive():
        if sup.generation >= 2 and scraped is None:
            got = collector.collect()
            scrapes += 1
            tgt = got["targets"][0] if got["targets"] else {}
            if got["targets"] and tgt.get("epoch") is not None:
                scraped = {"pod_scrape_targets": got["snapshot"]["gauges"][
                    "pod_scrape_targets"],
                    "pod_scrape_errors": got["snapshot"]["gauges"]["pod_scrape_errors"],
                    "errors": got["errors"], "target_pid": tgt.get("pid"),
                    "epoch": tgt.get("epoch"), "round": tgt.get("round"),
                    "status": tgt.get("status"),
                    "worker_series": sorted(k for k in got["snapshot"]["gauges"]
                                            if 'process="0"' in k)}
        time.sleep(0.02)
    thread.join()
    drill_s = time.perf_counter() - t0
    with tracer.span("supervisor-exit", trace=trace):
        flight.note("supervisor-exit", rc=box.get("rc"), restarts=sup.restarts)
    flight.dump(f"supervisor-exit:rc={box.get('rc')}")
    tracer.write_jsonl(os.path.join(pod, assemble.POD_TRACE_DIR, "supervisor.jsonl"))
    if box.get("rc") != 0 or set(results) != {1, 2}:
        logs = {g: open(os.path.join(pod, f"worker_gen{g}.log")).read()[-3000:] for g in results}
        fail(f"the supervised drill: {box}, restarts {sup.restarts}, "
             f"generations {sorted(results)}; logs {logs}")
    # the uninterrupted run of the same worker, after the drill, so that the
    # drill's relaunch and reload have the host and the card to themselves
    t_solo = time.perf_counter()
    solo_result = os.path.join(solo_dir, "worker_solo.json")
    with open(os.path.join(solo_dir, "worker_solo.log"), "w") as log:
        try:
            solo_rc = subprocess.run(pod_worker_cmd(tree, solo_dir, 0, solo_result), stdout=log,
                                     stderr=subprocess.STDOUT, timeout=600,
                                     cwd=os.path.dirname(os.path.abspath(__file__))).returncode
        except subprocess.TimeoutExpired:
            solo_rc = "timeout"
    solo_s = time.perf_counter() - t_solo
    if solo_rc != 0:
        fail(f"the uninterrupted worker: rc {solo_rc}; log "
             f"{open(os.path.join(solo_dir, 'worker_solo.log')).read()[-3000:]}")
    gen = {g: pod_read(results[g]) for g in (1, 2)}
    solo_out = pod_read(solo_result)
    killed = gen[1]["killed"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pm_rc = postmortem.main([pod, "--validate", "--json", os.path.join(pod, "pm.json")])
        asm_rc = assemble.main([pod, "--require-cross-process"])
    incident = postmortem.incident_summary(postmortem.build_timeline(pod))
    payload = assemble.assemble(pod)
    pids = {s["pid"]: s["events"] for s in payload["metadata"]["sources"]}
    shared = assemble.processes_by_trace(payload).get(trace, set())
    epoch1_round = gen[1]["epochs"][0]["round"]
    sums = {k: gen[1]["launches"][k] + gen[2]["launches"][k] for k in POD_RUN_KEYS}
    want = {k: solo_out["launches"][k] + (killed or {}).get("in_epoch", {}).get(k, 0)
            for k in POD_RUN_KEYS}
    rec = {"card": smi, "rc": box.get("rc"), "restarts": sup.restarts,
           "drill_seconds": drill_s, "solo_seconds": solo_s,
           "digest": gen[2]["digest"], "solo_digest": solo_out["digest"],
           "losses_equal": gen[2].get("epoch_losses") == solo_out.get("epoch_losses"),
           "killed": killed, "installs": installs, "scraped": scraped, "scrapes": scrapes,
           "launches": {"gen1": gen[1]["launches"], "gen2": gen[2]["launches"],
                        "solo": solo_out["launches"]},
           "launches_two_generations": sums, "launches_solo_plus_killed": want,
           "kill_to_first_heartbeat_s": (gen[2]["first_pulse_unix"] - killed["kill_unix"]
                                         if killed else None),
           "reload_ms": gen[2]["reload_ms"], "postmortem_rc": pm_rc, "assemble_rc": asm_rc,
           "incident": incident, "trace_pids": sorted(shared),
           "sources": {str(k): v for k, v in pids.items()},
           "worker_pids": [gen[1]["pid"], gen[2]["pid"]],
           "epoch1_round": epoch1_round}
    print(f"pod plane (a): the supervised SIGKILL drill on {smi}:",
          json.dumps(rec, default=float))
    if not killed or killed["epoch"] != POD_KILL_EPOCH or gen[1]["digest"] is not None:
        fail(f"generation 1 did not die in epoch {POD_KILL_EPOCH}: {killed}")
    if rec["digest"] is None or rec["digest"] != rec["solo_digest"] or not rec["losses_equal"]:
        fail(f"the resumed run's final digest {rec['digest']} (losses equal: "
             f"{rec['losses_equal']}) is not the uninterrupted run's {rec['solo_digest']}")
    if not (installs and installs[0]["round"] == epoch1_round and installs[0]["epoch"] == 1
            and installs[0]["fold_epoch"] == 1):
        fail(f"the consensus install: {installs}, want epoch 1's round {epoch1_round}, with the "
             f"fold's checkpoint at epoch 1")
    if rec["reload_ms"] is None:
        fail("generation 2 did not time its resume's reload (no load_checkpoint call seen)")
    if not scraped or scraped["pod_scrape_targets"] != 1 or scraped["pod_scrape_errors"] != 0 \
            or scraped["target_pid"] != gen[2]["pid"] or scraped["round"] is None:
        fail(f"the pod collector during generation 2: {scraped} ({scrapes} scrapes)")
    if pm_rc != 0 or incident["killed_slice"] != 0 \
            or "signal 9" not in (incident["death_reason"] or "") \
            or incident["consensus_round"] != epoch1_round \
            or incident["restart_generation"] != 2:
        fail(f"postmortem --validate rc {pm_rc}, incident {incident}: {buf.getvalue()[-2000:]}")
    if asm_rc != 0 or not {os.getpid(), gen[1]["pid"], gen[2]["pid"]} <= shared \
            or any(pids.get(p, 0) == 0 for p in (os.getpid(), gen[1]["pid"], gen[2]["pid"])):
        fail(f"assemble: rc {asm_rc}, trace {trace} over {sorted(shared)}, sources {pids}")
    for name, launches in rec["launches"].items():
        if not pod_routes_ok(launches):
            fail(f"the {name} worker off its routes: {launches}")
    if sums != want:
        fail(f"the two generations' launches {sums} are not the uninterrupted run's plus the "
             f"killed epoch's {want}")
    return rec


def pod_cli(torch, smi: str, fs_tree: str, root: str) -> dict:
    """(b): ``--schedule --statusz-port`` over registers of phase 22's FS
    tenants; one ``/statusz`` (once "fs1" has trained its epoch) and one
    ``/metrics`` during the run, then a shutdown event."""
    import contextlib
    import io
    import socket

    from dinunet_implementations_tpu_torch.runner import cli

    cli_root = os.path.join(root, "pod_b")
    spool = os.path.join(cli_root, "spool")
    os.makedirs(spool)
    # phase 22's tenants: "fs1" trains an epoch; "held", below its quorum,
    # keeps the scheduler up until the shutdown event
    for name, ev in (("ev000.json", {"tenant": "fs1", "capacity": FS_SITES}),
                     ("ev001.json", {"tenant": "held", "capacity": 8, "quorum": 8})):
        with open(os.path.join(spool, name), "w") as fh:
            json.dump({"event": "register", "data_path": fs_tree, "max_epochs": 1,
                       "config": {"agg_engine": "dSGD"}, **ev}, fh)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    buf, box = io.StringIO(), {}

    def run():
        try:
            box["rc"] = cli.main(["--data-path", cli_root, "--schedule", "--pod-slices", "1",
                                  "--statusz-port", str(port), "--serve-poll", "0.05",
                                  "--sched-wall-s", "300", "--quiet"])
        except BaseException as e:  # the main thread reports it
            box["error"] = repr(e)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        thread = threading.Thread(target=run, name="pod-cli")
        thread.start()
        payload, get_ms, metrics = None, None, ""
        key = 'sched_granted_slices{process="scheduler",tenant="fs1"}'
        deadline = time.monotonic() + 300
        while thread.is_alive() and time.monotonic() < deadline:
            try:
                code, text, ms = live_get(f"http://127.0.0.1:{port}/statusz")
                body = json.loads(text)
            except (OSError, ValueError):
                time.sleep(0.02)
                continue
            tenants = (body.get("status") or {}).get("tenants", {})
            if code == 200 and set(tenants) == {"fs1", "held"} \
                    and tenants["fs1"]["epochs_run"] == 1 and key in body["metrics"]["gauges"]:
                payload, get_ms = body, ms
                metrics = live_get(f"http://127.0.0.1:{port}/metrics")[1]
                break
            time.sleep(0.02)
        with open(os.path.join(spool, "ev999.json"), "w") as fh:
            json.dump({"event": "shutdown"}, fh)
        thread.join(600)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    status = (payload or {}).get("status") or {}
    rec = {"card": smi, "rc": box.get("rc"), "error": box.get("error"), "seconds": seconds,
           "statusz_ms": get_ms, "mode": status.get("mode"),
           "tenants": sorted(status.get("tenants") or {}),
           "status_keys": sorted(status), "targets": status.get("targets"),
           "scheduler_series": len([k for k in ((payload or {}).get("metrics") or {})
                                    .get("gauges", {}) if 'process="scheduler"' in k]),
           "granted_series": key in ((payload or {}).get("metrics") or {}).get("gauges", {}),
           "metrics_has_pod_scrape_targets": "pod_scrape_targets" in metrics,
           "summary_tenants": sorted(summary.get("tenants") or {})}
    print(f"pod plane (b): the CLI's --schedule --statusz-port on {smi}:", json.dumps(rec))
    if rec["rc"] != 0 or payload is None or rec["mode"] != "pod" \
            or rec["tenants"] != ["fs1", "held"] or not rec["granted_series"] \
            or rec["targets"] != [] or not rec["metrics_has_pod_scrape_targets"] \
            or rec["summary_tenants"] != ["fs1", "held"]:
        fail(f"the CLI's pod /statusz: {rec}")
    return rec


def pod_phase(torch, np, lc, pc, bc, smi: str, root: str, tree: str | None = None,
              fs_tree: str | None = None) -> dict:
    """Phase 23 of the module docstring: the supervisor and the pod plane;
    makes a tree of phase 21's shape and phase 14's FS tree under ``root``
    when not given."""
    from dinunet_implementations_tpu_torch.data import make_fs_demo_tree

    t_phase = time.perf_counter()
    tree = tree or daemon_tree(os.path.join(root, "pod_ica_tree"))
    fs_tree = fs_tree or make_fs_demo_tree(os.path.join(root, "pod_fs_tree"), n_sites=FS_SITES,
                                           subjects=FS_SUBJECTS, seed=0)
    rec = {"drill": pod_drill(torch, smi, tree, root), "cli": pod_cli(torch, smi, fs_tree, root)}
    rec["seconds"] = time.perf_counter() - t_phase
    d = rec["drill"]
    line = {"card": smi, "supervisor_rc": d["rc"], "digest_equal": d["digest"] == d["solo_digest"],
            "kill_to_first_heartbeat_s": d["kill_to_first_heartbeat_s"],
            "reload_ms": d["reload_ms"], "consensus_install_ms": d["installs"][0]["ms"],
            "drill_seconds": d["drill_seconds"], "solo_seconds": d["solo_seconds"], "statusz_ms": rec["cli"]["statusz_ms"],
            "launches": {g: {k: d["launches"][g][k] for k in POD_RUN_KEYS}
                         for g in ("gen1", "gen2", "solo")},
            "phase_seconds": rec["seconds"]}
    print("pod plane:", json.dumps(line, default=float))
    return rec


# -- phase 24: the site axis over processes ------------------------------------------

MESH_ENGINES = ("dSGD", "rankDAD", "powerSGD")
MESH_CODECS = (("int8", False), ("int8", True), ("fp8", False), ("bf16", False))
# The first round's aggregate under a codec against the f32 wire's, each leaf
# over its max |aggregate| (a leaf of rounding noise, cls_fc1.bias, over 1e-3
# of the tree's largest): JAX's envelope (tests/test_collectives.py: int8
# 0.02, fp8 0.1 of unit-scale gradients), taken relative here since the
# flagship's gradients are far from unit scale; bf16's grid is finer than
# int8's.
CODEC_SHARE = {"int8": 0.02, "fp8": 0.1, "bf16": 0.02}
# The NCCL group of one against the one-device epoch: the CPU tests' W = 2
# against W = 1 (tests/test_torch_port_mesh.py), absolute
MESH_ATOL = {"dSGD": 1e-6, "rankDAD": 1e-5}
# The two gloo ranks' fit against the same worker alone: the worker's CPU
# test's tolerance against JAX (tests/test_torch_port_dcn_worker.py
# FIT_ATOL). K = 3 members against 6 run K7 and the LSTM in other batch
# shapes; rankDAD's factors of rank-deficient per-site gradients (batch 8
# against r = 10) carry their last bits into the next round's Ω: on the
# CPU a 6-site ICA demo tree's second-epoch loss parted by 2.3e-5.
MESH_FIT_ATOL, MESH_FIT_EPOCHS, MESH_WORKER_TIMEOUT_S = 1e-4, 2, 600


def mesh_setup(torch, engine: str, quant: str = "none", stochastic: bool = False, mesh=None):
    """Phase 6's configuration (32 sites, batch 16, the default ICAArgs,
    dropout 0) with the wire codec ``quant`` and, with ``mesh``, over the
    process group: its epoch function and first state (the mesh's block of
    the per-site leaves)."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine,
                      wire_quant=quant, wire_stochastic=stochastic)
    task, eng, opt = build_training(cfg, use_kernel=True)
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, eng, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds, mesh=mesh)
    k = TRAIN_SITES if mesh is None else mesh.pack
    return cfg, eng, epoch, init_train_state(task, eng, opt, rng=0, num_sites=k)


def mesh_epochs(torch, epoch, state, inv_x, inv_y, idx) -> tuple:
    """``TRAIN_EPOCHS`` epochs: the end state, the losses and each epoch's
    ms (synchronized)."""
    losses, ms = [], []
    for q in idx:
        t0 = time.perf_counter()
        state, lo = epoch(state, inv_x, inv_y, q)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lo)
    return state, torch.cat(losses), ms


def leaf_share(got: dict, want: dict) -> float:
    """The largest per-leaf error over the leaf's max |value| (floored at
    1e-3 of the tree's largest)."""
    top = max(w.abs().max().item() for w in want.values())
    return max((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-3 * top)
               for k, w in want.items())


def mesh_want(torch, launches: dict, engine: str, rounds: int) -> dict:
    """Phase 6's routes: one K1 and one K2 a direction and round on the
    cluster route, one staged K7 a rank class and round under rankDAD."""
    want = dict.fromkeys(launches, 0)
    n = 2 * rounds
    want.update(lstm_fwd=n, lstm_proj=n, k1_cluster_route=n, lstm_bwd=n, k2_cluster_route=n)
    if engine == "rankDAD":
        want["poweriter"] = want["k7_staged_route"] = len(k7_leaves(torch)) * rounds
    return want


def mesh_codecs(torch, np, lc, pc, bc, smi: str, inv_x, inv_y, idx) -> dict:
    """(a): every engine's epochs under each codec against the f32 wire;
    the codec's card output against its CPU output on a fixed payload."""
    from dinunet_implementations_tpu_torch.parallel import collectives as col

    rounds = sum(q.shape[1] for q in idx)
    out = {"pairs": [], "codec_bits": {}}
    for engine in MESH_ENGINES:
        _, _, epoch_f, state_f = mesh_setup(torch, engine)
        one_f, _ = epoch_f(state_f, inv_x, inv_y, idx[0][:, :1])
        agg_f = {k: m / 0.1 for k, m in one_f.opt_state["mu"].items()}
        _, losses_f, ms_f = mesh_epochs(torch, epoch_f, state_f, inv_x, inv_y, idx)
        for quant, stochastic in MESH_CODECS:
            name = quant + ("-stochastic" if stochastic else "")
            _, eng, epoch, state = mesh_setup(torch, engine, quant, stochastic)
            zero_counters(lc, pc, bc)  # the main path's run starts here
            st, losses, ms = mesh_epochs(torch, epoch, state, inv_x, inv_y, idx)
            launches = read_counters(lc, pc, bc)
            one, _ = epoch(state, inv_x, inv_y, idx[0][:, :1])
            share = leaf_share({k: m / 0.1 for k, m in one.opt_state["mu"].items()}, agg_f)
            rec = {"engine": engine, "codec": name, "wire_dtype": str(eng.wire_dtype),
                   "first_round_aggregate_share": share, "envelope": CODEC_SHARE[quant],
                   "losses": losses.tolist(), "f32_wire_losses": losses_f.tolist(),
                   "epoch_ms": ms, "f32_wire_epoch_ms": ms_f, "launches": launches,
                   "card": smi}
            print("mesh codec:", json.dumps(rec))
            if launches != mesh_want(torch, launches, engine, rounds):
                fail(f"phase 24 (a) {engine} {name} launches {launches}")
            if not bool(losses.isfinite().all()) or share > CODEC_SHARE[quant]:
                fail(f"phase 24 (a) {engine} {name}: first-round share {share}")
            out["pairs"].append(rec)
    # the codec on the card against the CPU on fixed payloads of
    # gradient-sized values: finite, and with a dead row and non-finite rows
    gen = np.random.default_rng(24)
    finite = (gen.standard_normal((TRAIN_SITES, 64, 33)) * 1e-3).astype(np.float32)
    faulty = finite.copy()
    faulty[1], faulty[2, 0, 0], faulty[3, 5, 5] = 0.0, np.inf, np.nan
    for (quant, stochastic), (kind, x) in ((c, p) for c in MESH_CODECS
                                           for p in (("finite", finite), ("faulty", faulty))):
        codec = col.resolve_wire_codec("32", quant, stochastic)
        for batched in (False, True):
            cpu = codec.compress(torch.from_numpy(x), batched=batched).numpy()
            card = codec.compress(torch.from_numpy(x).cuda(), batched=batched).cpu().numpy()
            same = np.array_equal(np.where(np.isnan(cpu), 0, cpu).view(np.uint32),
                                  np.where(np.isnan(card), 0, card).view(np.uint32)) and \
                np.array_equal(np.isnan(cpu), np.isnan(card))
            key = (f"{quant}{'-stochastic' if stochastic else ''}"
                   f"{'-batched' if batched else ''}-{kind}")
            out["codec_bits"][key] = bool(same)
            if not same:
                fail(f"phase 24 (a) codec {key}: the card's output differs from the CPU's")
    return out


def timed_collectives(torch, col, run):
    """``run()`` with the port's two collectives wrapped: the device
    synchronized before and after each, their wall seconds summed.
    Returns ``(seconds, run())``; the wrappers go when it returns."""
    spent = [0.0]
    orig = {"_all_reduce": col._all_reduce, "_all_gather": col._all_gather}

    def timed(fn):
        def call(x, axes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, axes)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return call

    for name, fn in orig.items():
        setattr(col, name, timed(fn))
    try:
        out = run()
    finally:
        for name, fn in orig.items():
            setattr(col, name, fn)
    return spent[0], out


def mesh_nccl_one(torch, np, lc, pc, bc, smi: str, inv_x, inv_y, idx) -> dict:
    """(b): the dSGD and rankDAD epochs on an NCCL group of one (K = 32 on
    multihost_site_mesh) against phase 6's one-device epochs."""
    import socket

    from dinunet_implementations_tpu_torch.parallel import collectives as col
    from dinunet_implementations_tpu_torch.parallel.distributed import (
        distributed_init,
        distributed_shutdown,
        multihost_site_mesh,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rounds = sum(q.shape[1] for q in idx)
    out = {}
    distributed_init(f"127.0.0.1:{port}", 1, 0, backend="nccl", device="cuda:0")
    try:
        mesh = multihost_site_mesh(TRAIN_SITES, device="cuda:0")
        for engine in ("dSGD", "rankDAD"):
            _, _, epoch_p, state_p = mesh_setup(torch, engine)
            sp, losses_p, ms_p = mesh_epochs(torch, epoch_p, state_p, inv_x, inv_y, idx)
            _, _, epoch, state = mesh_setup(torch, engine, mesh=mesh)
            zero_counters(lc, pc, bc)  # the main path's run starts here
            col.reset_collective_counts()
            st, losses, ms = mesh_epochs(torch, epoch, state, inv_x, inv_y, idx)
            launches = read_counters(lc, pc, bc)
            collectives = dict(col.COLLECTIVES)
            # one more epoch with the device synchronized around each
            # collective: their ms a round
            coll_s, ms_timed = timed_collectives(torch, col, lambda: mesh_epochs(
                torch, epoch, st, inv_x, inv_y, idx[:1])[2])
            coll_ms = coll_s * 1e3 / idx[0].shape[1]
            trees = {"params": (st.params, sp.params)}
            if engine == "rankDAD":
                trees["omega"] = ({k: v for k, v in st.engine_state["omega"].items()
                                   if v is not None},
                                  {k: v for k, v in sp.engine_state["omega"].items()
                                   if v is not None})
            errs = {k: tree_err(g, w, MESH_ATOL[engine])[0] for k, (g, w) in trees.items()}
            errs["loss"] = (losses - losses_p).abs().max().item()
            bit_equal = all(same_tree(g, w) for g, w in trees.values()) and \
                bool(torch.equal(losses, losses_p))
            rec = {"engine": engine, "backend": mesh.backend, "world": mesh.world,
                   "pack": mesh.pack, "bit_equal": bit_equal, "max_abs_err": errs,
                   "epoch_ms": ms, "one_device_epoch_ms": ms_p, "timed_epoch_ms": ms_timed,
                   "collective_ms_per_round": coll_ms,
                   "collectives_per_round": {k: collectives[k] / rounds
                                             for k in ("all_reduce", "all_gather", "bytes")},
                   "launches": launches, "card": smi}
            print("mesh nccl group of one:", json.dumps(rec))
            if launches != mesh_want(torch, launches, engine, rounds):
                fail(f"phase 24 (b) {engine} launches {launches}")
            if any(e > MESH_ATOL[engine] for e in errs.values()):
                fail(f"phase 24 (b) {engine} differs from the one-device epoch: {errs}")
            out[engine] = rec
    finally:
        distributed_shutdown()
    return out


def mesh_worker_cmd(tree: str, out: str, report: str, rank=None, port=None) -> list:
    """The port's multi-process worker on ``tree``: a rankDAD fit of
    ``MESH_FIT_EPOCHS`` epochs; with ``rank`` one of two gloo ranks. No
    ``--device``: each rank takes its card (rank modulo the one card:
    ``cuda:0``) under gloo as under nccl."""
    cmd = [sys.executable, "-m", "dinunet_implementations_tpu_torch.runner.dcn_worker",
           "--data-path", tree, "--out-dir", out, "--report", report, "--task",
           "ICA-Classification", "--epochs", str(MESH_FIT_EPOCHS),
           "--set", 'agg_engine="rankDAD"']
    if rank is not None:
        cmd += ["--backend", "gloo", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "2", "--process-id", str(rank)]
    return cmd


def mesh_gloo_two(torch, smi: str, tree: str, root: str) -> dict:
    """(c): two worker processes on cuda:0 under gloo (K = 3 a rank) and
    the same worker alone."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "mesh_gloo")
    os.makedirs(work, exist_ok=True)

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # the gloo collectives the route runs, on CUDA tensors: each must run
    # and give the expected result
    port, probe_out = free_port(), os.path.join(work, "gloo_cuda_probe.json")
    probe = [subprocess.Popen([sys.executable, os.path.join(here, "scripts",
                                                            "torch_gloo_cuda_probe.py"),
                               str(r), str(port), probe_out], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in probe]
    except subprocess.TimeoutExpired:
        for p in probe:
            p.kill()
            p.wait()
        fail("phase 24 (c): the gloo CUDA probe outran 120 s")
    if any(p.returncode != 0 for p in probe):
        fail(f"phase 24 (c): the gloo CUDA probe exited {[p.returncode for p in probe]}: {outs}")
    gloo_cuda = pod_read(probe_out)
    if not all(gloo_cuda[c]["ran"] and gloo_cuda[c]["equal"]
               for c in ("all_reduce", "all_gather", "broadcast")):
        fail(f"phase 24 (c): gloo on CUDA tensors: {gloo_cuda}")
    port = free_port()
    t0 = time.monotonic()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(mesh_worker_cmd(tree, os.path.join(work, "out2"),
                                              os.path.join(work, f"rank{r}.json"), r, port),
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=here)
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=MESH_WORKER_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"phase 24 (c): the two ranks outran {MESH_WORKER_TIMEOUT_S} s")
    finally:
        for f in logs:
            f.close()
    pair_s = time.monotonic() - t0
    if rcs != [0, 0]:
        tails = [open(os.path.join(work, f"rank{r}.log")).read()[-3000:] for r in range(2)]
        fail(f"phase 24 (c): the ranks exited {rcs}: {tails}")
    t0 = time.monotonic()
    solo = subprocess.run(mesh_worker_cmd(tree, os.path.join(work, "out1"),
                                          os.path.join(work, "solo.json")),
                          capture_output=True, text=True, cwd=here,
                          timeout=MESH_WORKER_TIMEOUT_S)
    solo_s = time.monotonic() - t0
    if solo.returncode != 0:
        fail(f"phase 24 (c): the worker alone exited {solo.returncode}: {solo.stdout[-3000:]}")
    reps = [pod_read(os.path.join(work, f"rank{r}.json")) for r in range(2)]
    alone = pod_read(os.path.join(work, "solo.json"))
    loss_err = max(abs(a - b) for a, b in zip(reps[0]["epoch_losses"], alone["epoch_losses"]))
    fold = os.path.join(work, "out2", "remote", "simulatorRun", "ICA-Classification", "fold_0")
    files = sorted(os.listdir(fold)) if os.path.isdir(fold) else []
    rec = {"ranks": [{k: r[k] for k in ("process_index", "backend", "device", "pack",
                                        "params_sha256", "n_log_writes", "n_ckpt_writes",
                                        "launches", "collectives", "fit_seconds",
                                        "epoch_losses")} for r in reps],
           "alone": {k: alone[k] for k in ("device", "launches", "fit_seconds",
                                           "epoch_losses", "params_sha256")},
           "loss_err_vs_alone": loss_err, "pair_wall_s": pair_s, "alone_wall_s": solo_s,
           "remote_files": files, "gloo_cuda_tensors": gloo_cuda, "card": smi}
    print("mesh gloo two ranks:", json.dumps(rec))
    problems = []
    if reps[0]["params_sha256"] != reps[1]["params_sha256"]:
        problems.append("the ranks' params checksums differ")
    if loss_err > MESH_FIT_ATOL:
        problems.append(f"losses {loss_err} from the worker alone")
    if (reps[1]["n_log_writes"], reps[1]["n_ckpt_writes"]) != (0, 0) or \
            reps[0]["n_ckpt_writes"] == 0 or "checkpoint_best.msgpack" not in files:
        problems.append("a rank other than 0 wrote, or rank 0 did not")
    if any(r["pack"] != 3 or r["backend"] != "gloo" for r in reps):
        problems.append("not two gloo ranks of 3 sites")
    if any(r["device"] != "cuda:0" for r in reps) or not alone["device"].startswith("cuda"):
        problems.append("a worker with no --device did not take the card")
    for r in reps:
        if min(r["launches"].values()) == 0:
            problems.append(f"rank {r['process_index']} launched {r['launches']}")
    if problems:
        fail(f"phase 24 (c): {problems}")
    return rec


def mesh_phase(torch, np, lc, pc, bc, smi: str, root: str, tree: str) -> dict:
    cfg, _, _, _ = mesh_setup(torch, "dSGD")
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q).cuda() for q in plans]
    t0 = time.monotonic()
    codecs = mesh_codecs(torch, np, lc, pc, bc, smi, inv_x, inv_y, idx)
    t_a = time.monotonic() - t0
    nccl = mesh_nccl_one(torch, np, lc, pc, bc, smi, inv_x, inv_y, idx)
    t_b = time.monotonic() - t0 - t_a
    gloo = mesh_gloo_two(torch, smi, tree, root)
    rec = {"a_s": t_a, "b_s": t_b, "c_s": time.monotonic() - t0 - t_a - t_b,
           "codec_bits": codecs["codec_bits"], "card": smi}
    print("mesh:", json.dumps(rec))
    return {"codecs": codecs, "nccl": nccl, "gloo": gloo}


# -- phase 25: the slice tier over processes ---------------------------------------------

# The int8 split form's losses against the fused form's, each epoch's
# |difference| over the fused loss. The envelope first predicted, 0.05 (a
# narrow ICA-LSTM on the CPU parted by 1.6e-2 over the same 2 epochs), fell
# at 0.0523 on the card (epoch 2; epoch 1 0.0109): the inter-slice codec
# scales each site row of a rank class's whole factor block by one amax,
# a coarser grid than the one-device codec's (a scale a factor). Now PR
# 24's codec share for runs a grid step can part (tests/test_torch_port_
# mesh.py CODEC_FLIP_SHARE)
SLICE_INT8_SHARE = 0.1
SLICE_WORKER_TIMEOUT_S = 600
SLICE_DRILL_TIMEOUT_S = 900


def slice_routes_ok(rep: dict) -> bool:
    """A rank's K1, K2 and K7 launched, K1 and K2 on the cluster route, K7
    staged, no rank class sent to the plain power iteration."""
    n, r = rep["launches"], rep["routes"]
    return (n["lstm_fwd"] > 0 and r["k1_cluster"] == n["lstm_fwd"] and n["lstm_bwd"] > 0
            and r["k2_cluster"] == n["lstm_bwd"] and n["poweriter"] > 0
            and r["k7_staged"] == n["poweriter"] and r["poweriter_plain_classes"] == 0)


def slice_pair(work: str, name: str, tree: str, extra: list) -> tuple:
    """Two ``--slices 2`` worker ranks under gloo on the card (no
    ``--device``), their reports and the pair's wall seconds."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, name)
    logs = [open(os.path.join(work, f"{name}_rank{r}.log"), "w") for r in range(2)]
    t0 = time.monotonic()
    procs = [subprocess.Popen(mesh_worker_cmd(tree, out, os.path.join(work, f"{name}{r}.json"),
                                              r, port) + ["--slices", "2", *extra],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=here)
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=SLICE_WORKER_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"phase 25 (a) {name}: the two ranks outran {SLICE_WORKER_TIMEOUT_S} s")
    finally:
        for f in logs:
            f.close()
    wall = time.monotonic() - t0
    if rcs != [0, 0]:
        tails = [open(os.path.join(work, f"{name}_rank{r}.log")).read()[-3000:]
                 for r in range(2)]
        fail(f"phase 25 (a) {name}: the ranks exited {rcs}: {tails}")
    return [pod_read(os.path.join(work, f"{name}{r}.json")) for r in range(2)], wall


def slice_record(reps: list, wall: float) -> dict:
    a = reps[0]
    rounds = a["epoch_rounds"][-1]  # a fit from round 0
    return {"wall_s": wall, "params_sha256": [r["params_sha256"] for r in reps],
            "epoch_losses": a["epoch_losses"], "epoch_rounds": a["epoch_rounds"],
            "held_rounds": a["held_rounds"], "mesh_shape": a["mesh_shape"], "pack": a["pack"],
            "fit_seconds": [r["fit_seconds"] for r in reps],
            "launches": [r["launches"] for r in reps], "routes": [r["routes"] for r in reps],
            "collectives_a_round": {k: v / rounds for k, v in a["epoch_collectives"].items()},
            "dcn_bytes_round": a["dcn_bytes_round"], "device": [r["device"] for r in reps]}


def slices_two_by_one(torch, smi: str, tree: str, root: str, unsliced_sha: str) -> dict:
    """(a): the fused, the int8 split and the quorum runs (module
    docstring)."""
    work = os.path.join(root, "slices_a")
    os.makedirs(work, exist_ok=True)
    fused_reps, t_fused = slice_pair(work, "fused", tree, [])
    fused = slice_record(fused_reps, t_fused)
    split_reps, t_split = slice_pair(work, "split_int8", tree, ["--dcn-wire-quant", "int8"])
    split = slice_record(split_reps, t_split)
    r1 = fused["epoch_rounds"][0]
    drop_reps, t_drop = slice_pair(work, "quorum", tree, [
        "--faults", json.dumps({"slice_drop_at": [[1, r1, -1]]}), "--set", "min_slices=2"])
    drop = slice_record(drop_reps, t_drop)
    share = max(abs(a - b) / abs(b) for a, b in zip(split["epoch_losses"],
                                                     fused["epoch_losses"]))
    rounds = fused["epoch_rounds"][-1]
    split_elems = split["collectives_a_round"]["dcn_elements"]
    rec = {"card": smi, "fused": fused, "split_int8": split, "quorum": drop,
           "unsliced_sha": unsliced_sha, "int8_loss_share": share,
           "split_dcn_bytes_a_round": split_elems * 1, "rounds": rounds}
    print("slices (a) two slices of one rank:", json.dumps(rec))
    problems = []
    for name, run, reps in (("fused", fused, fused_reps), ("split", split, split_reps),
                            ("quorum", drop, drop_reps)):
        if len(set(run["params_sha256"])) != 1:
            problems.append(f"{name}: the ranks' params checksums differ")
        if run["mesh_shape"] != {"slice": 2, "site": 1, "model": 1} or run["pack"] != 3:
            problems.append(f"{name}: not two slices of one rank of 3 sites")
        if run["device"] != ["cuda:0", "cuda:0"]:
            problems.append(f"{name}: a rank with no --device did not take the card")
        for r in reps:
            if not slice_routes_ok(r):
                problems.append(f"{name} rank {r['process_index']}: off its routes "
                                f"{r['launches']} {r['routes']}")
    if fused["params_sha256"][0] != unsliced_sha:
        problems.append("the fused form's params are not the unsliced world's of phase 24 (c)")
    if not all(x == x and abs(x) < float("inf") for x in split["epoch_losses"]):
        problems.append(f"split losses {split['epoch_losses']}")
    if share > SLICE_INT8_SHARE:
        problems.append(f"the int8 split form's losses {share} of the fused form's")
    if split_elems != split["dcn_bytes_round"]:
        problems.append(f"the split form's inter-slice elements a round {split_elems} are not "
                        f"the fit's dcn_bytes_of {split['dcn_bytes_round']} at a byte a value")
    if drop["held_rounds"] != rounds - r1 or not all(
            x != x for x in drop["epoch_losses"][1:]):
        problems.append(f"quorum: {drop['held_rounds']} rounds held, want {rounds - r1}")
    shas = drop_reps[0]["epoch_params_sha256"]
    if shas[1] != shas[0] or shas[0] != fused_reps[0]["epoch_params_sha256"][0]:
        problems.append("quorum: the params moved across held rounds, or epoch 1 is not the "
                        "fused run's")
    if problems:
        fail(f"phase 25 (a): {problems}")
    return rec


def slices_drill(torch, smi: str, tree: str, root: str, fused: dict) -> dict:
    """(b): the supervised drill on the card (module docstring)."""
    from dinunet_implementations_tpu_torch.runner.supervisor import (
        LIVENESS_DIR,
        read_slice_liveness,
    )
    from dinunet_implementations_tpu_torch.telemetry.postmortem import CONSENSUS_DIR

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "slices_b")
    os.makedirs(out, exist_ok=True)
    r1 = fused["epoch_rounds"][0]
    cmd = [sys.executable, "-m", "dinunet_implementations_tpu_torch.runner.dcn_worker",
           "--supervise", "--num-processes", "2", "--slices", "2", "--backend", "gloo",
           "--data-path", tree, "--out-dir", out, "--report", os.path.join(out, "rep.json"),
           "--task", "ICA-Classification", "--epochs", str(MESH_FIT_EPOCHS),
           "--set", 'agg_engine="rankDAD"', "--heartbeat-s", "0.5",
           "--heartbeat-timeout-s", "120",
           "--faults", json.dumps({"kill_slice_at": [[1, r1 + 1]]})]
    t0 = time.monotonic()
    with open(os.path.join(out, "supervisor.log"), "w") as log:
        try:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=here,
                                timeout=SLICE_DRILL_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    drill_s = time.monotonic() - t0
    if rc != 0:
        tails = {n: open(os.path.join(out, n)).read()[-2000:] for n in sorted(os.listdir(out))
                 if n.endswith(".log")}
        fail(f"phase 25 (b): the supervisor exited {rc}: {tails}")
    reps = [pod_read(os.path.join(out, f"rep_p{r}.json")) for r in range(2)]
    deaths = [e for e in read_slice_liveness(os.path.join(out, LIVENESS_DIR))
              if e["event"] == "dead"]
    decision = pod_read(os.path.join(out, CONSENSUS_DIR, "decision_gen1.json"))
    kills = []
    for name in os.listdir(out):
        if name.startswith("flight_") and name.endswith(".json"):
            d = pod_read(os.path.join(out, name))
            if str(d.get("reason", "")).startswith("kill-slice"):
                kills.append(d["time_unix"])
    first_pulse = min(r["first_pulse_unix"] for r in reps if r["first_pulse_unix"])
    rec = {"card": smi, "drill_s": drill_s, "deaths": deaths, "decision": decision,
           "digests": [r["params_sha256"] for r in reps],
           "fused_digest": fused["params_sha256"][0],
           "generations": [r["restart_generation"] for r in reps],
           "kill_to_first_pulse_s": (first_pulse - kills[0]) if kills else None,
           "reload_ms": [r["reload_ms"] for r in reps],
           "launches": [r["launches"] for r in reps], "routes": [r["routes"] for r in reps]}
    print("slices (b) the supervised drill:", json.dumps(rec))
    problems = []
    if [(e["slice"], e["generation"]) for e in deaths] != [(1, 1)] or \
            "signal 9" not in deaths[0]["reason"]:
        problems.append(f"the liveness spool's deaths {deaths}")
    want = {"time_unix", "generation", "dead_slice", "round", "epoch", "sha", "replaced"}
    if set(decision) != want or (decision["dead_slice"], decision["round"],
                                 decision["epoch"]) != (1, r1, 1):
        problems.append(f"the decision {decision}, want slice 1 at round {r1}, epoch 1")
    if rec["generations"] != [2, 2] or set(rec["digests"]) != {rec["fused_digest"]}:
        problems.append("the resumed fleet's params are not the uninterrupted fused run's")
    if not kills or any(ms is None for ms in rec["reload_ms"]):
        problems.append("the kill or the resume's reload was not timed")
    for r in reps:
        if not slice_routes_ok(r):
            problems.append(f"rank {r['process_index']} off its routes")
    if problems:
        fail(f"phase 25 (b): {problems}")
    return rec


def slices_phase(torch, smi: str, root: str, tree: str, unsliced_sha: str) -> dict:
    t0 = time.monotonic()
    two = slices_two_by_one(torch, smi, tree, root, unsliced_sha)
    t_a = time.monotonic() - t0
    drill = slices_drill(torch, smi, tree, root, two["fused"])
    rec = {"a_s": t_a, "b_s": time.monotonic() - t0 - t_a, "card": smi}
    print("slices:", json.dumps(rec))
    return {"two": two, "drill": drill}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from dinunet_implementations_tpu_torch.core.device import resolve_device
    from dinunet_implementations_tpu_torch.ops import _build
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc
    from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc

    resolve_device(None)  # sets the f32 precision flags the port runs under
    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    print("== 1. device:", kind, "| python", sys.version.split()[0], "| torch", torch.__version__,
          "| CUDA", torch.version.cuda)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)

    print("== 2. build")
    _build.build_all()
    print(f"built in {_build.last_build['seconds']:.1f} s into {_build.last_build['dir']}")
    for name, log in _build.last_build["logs"].items():
        for line in ptxas_lines(log):
            print(f"  {name}: {line}")

    print(f"== 3. kernel lstm_fwd vs plain, T={T} D={D} H={H}")
    shapes = kernel_phase(torch, lc)
    coverage_phase(torch, lc)

    print(f"== 4. kernel lstm_bwd vs plain, T={T} H={H}")
    bwd_shapes = bwd_phase(torch, lc)

    print("== 5. serving slice at full ICA-LSTM width")
    serve_launches = serving_phase(torch, np, lc)

    print(f"== 6. training slice at full ICA-LSTM width: {TRAIN_SITES} sites, batch {TRAIN_BATCH}")
    train = training_phase(torch, np, lc, pc, bc)

    print(f"== 7. kernel poweriter vs plain: one rankDAD round's rank classes, {TRAIN_SITES} sites")
    k7 = poweriter_phase(torch, pc)

    print(f"== 8. rankDAD training at full ICA-LSTM width: {TRAIN_SITES} sites, batch {TRAIN_BATCH}")
    train_dad = training_phase(torch, np, lc, pc, bc, engine="rankDAD")

    print(f"== 9. kernels bilstm_fwd, bilstm_pool_fwd, bilstm_bwd, bilstm_pool_bwd vs plain, "
          f"T={T} D={D} H={H}")
    bidir = bidir_kernel_phase(torch, bc)

    print(f"== 10. the fused bidirectional arm at full width: {TRAIN_SITES} sites, "
          f"batch {TRAIN_BATCH}")
    train_fused = training_phase(torch, np, lc, pc, bc, fused_bidir=True)
    train_fused_bf16 = fused_bf16_epoch(torch, np, lc, pc, bc)
    one_model = fused_model_phase(torch, np, lc, pc, bc)

    root = tempfile.mkdtemp(prefix="dinunet_fit_")  # phase 11's tree, reused by phase 13
    try:
        print(f"== 11. the fit slice at full width: FedRunner on a {FIT_SITES}-site ICA tree, "
              f"{FIT_EPOCHS} epochs")
        fit = fit_phase(torch, np, lc, pc, bc, smi, root)

        print(f"== 12. powerSGD training at full ICA-LSTM width: {TRAIN_SITES} sites, "
              f"batch {TRAIN_BATCH}")
        train_psgd = training_phase(torch, np, lc, pc, bc, engine="powerSGD")

        print("== 13. the command line on phase 11's tree: a powerSGD fit with pretraining, "
              "then --site 0")
        cli = cli_phase(torch, np, lc, pc, bc, smi, fit["tree"], root)

        print(f"== 14. the FS task at full width: a {FS_SITES}-site FreeSurfer tree, the "
              "native reader, dSGD / rankDAD / powerSGD fits, K7 at the FS classes, serving "
              "and the command line with no --task")
        fs = fs_phase(torch, np, lc, pc, bc, smi, root)

        print(f"== 15. the serving plane at full width: the unidirectional ICA-LSTM "
              f"(H={PLANE_H}) from a checkpoint: streaming, publish and rollback, two replicas")
        plane = serving_plane_phase(torch, np, lc, smi, root)

        print("== 16. the remaining workloads at full width: the sMRI 3D-CNN (8 sites, 64^3 "
              "folded to 32^3 x 8) and the multimodal transformer (64 sites, 98 windows): "
              "epochs under dSGD / rankDAD / powerSGD, rankDAD against plain, fits, serving, "
              "the command line")
        a9 = a9_phase(torch, np, lc, pc, bc, smi, root)

        print("== 17. hostile and faulty sites at full width: dSGD / rankDAD / powerSGD under "
              "norm_clip, trimmed_mean and coordinate_median with a fault and an attack plan, "
              "against plain; the cost of the defence; a fit and the command line")
        hostile = hostile_phase(torch, np, lc, pc, bc, smi, fit["tree"], root)

        print("== 18. elastic and durable rounds at full width: buffered-async epochs under "
              "dSGD / rankDAD / powerSGD and overlapped epochs under dSGD / rankDAD against "
              "plain; a kill_at_round fit and its resume; the daemon")
        elastic = elastic_phase(torch, np, lc, pc, bc, smi, fit["tree"], root,
                                train["ms_per_round"])

        print("== 19. the privacy plane at full width: DP-SGD under dSGD / rankDAD / powerSGD, "
              "secure aggregation and a personalized head against plain; the multimodal "
              "64-site DP-SGD epochs; DP and personalized fits, the command line, the daemon; "
              "the golden privacy-stack fit")
        privacy = privacy_phase(torch, np, lc, pc, bc, smi, fit["tree"], root)

        print("== 20. the fit's telemetry plane at full width: telemetry-on dSGD and rankDAD "
              "epochs against off, the on-card recompute and plain; a telemetry-on fit with "
              "an xprof window; the compile cache and the sanitizer on the command line")
        telemetry = telemetry_phase(torch, np, lc, pc, bc, smi, fit["tree"], root)

        print("== 21. the live plane and the serving CLI at full width: the flagship "
              "checkpoint through the serving CLI with the endpoints scraped; the "
              "unidirectional checkpoint through a two-replica fleet script; the command "
              "line's daemon with /statusz, telemetry on against off, and a SIGTERM")
        live = live_phase(torch, np, lc, pc, bc, smi, root)

        print(f"== 22. analysis and the fleet scheduler at full width: engine_comparison on "
              f"phase 21's tree ({SCHED_FIT_EPOCHS} epochs an engine), pretrain_study on phase "
              "14's, checkpoint-then-yield at one slice, --schedule and the backfill lane")
        sched = sched_phase(torch, np, lc, pc, bc, smi, root, os.path.join(root, "live_tree"),
                            os.path.join(root, "fs_tree"))

        print(f"== 23. the supervisor and the pod plane at full width: a SliceSupervisor over a "
              f"rankDAD fit on phase 21's tree ({POD_EPOCHS} epochs) SIGKILLed in epoch "
              f"{POD_KILL_EPOCH}, consensus, resume, the pod collector, postmortem and "
              "assemble; --schedule --statusz-port")
        pod = pod_phase(torch, np, lc, pc, bc, smi, root, os.path.join(root, "live_tree"),
                        os.path.join(root, "fs_tree"))

        print(f"== 24. the site axis over processes at full width: {TRAIN_SITES}-site epochs "
              "under the int8, int8 stochastic, fp8 and bf16 wires against f32; an NCCL group "
              f"of one against the one-device epochs; two gloo ranks of dcn_worker on cuda:0 "
              f"over phase 21's tree against the worker alone")
        mesh = mesh_phase(torch, np, lc, pc, bc, smi, root, os.path.join(root, "live_tree"))

        print("== 25. the slice tier over processes at full width: dcn_worker --slices 2 as "
              "two gloo ranks on cuda:0 over phase 21's tree, the fused form against phase 24 "
              "(c)'s unsliced world, the int8 split form, a slice drop under the quorum; the "
              "supervised SIGKILL drill of slice 1")
        slices = slices_phase(torch, smi, root, os.path.join(root, "live_tree"),
                              mesh["gloo"]["ranks"][0]["params_sha256"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    fwd = next(s for s in shapes if s["rows"] == SERVE_ROWS and s["dtype"] == "f32")
    bwd = next(s for s in bwd_shapes if s["rows"] == TRAIN_SITES * TRAIN_BATCH and s["dtype"] == "f32")
    by_path = {"serving": serve_launches, "training": train["launches"]["lstm_fwd"],
               "training_rankDAD": train_dad["launches"]["lstm_fwd"],
               "fit": fit["launches"]["lstm_fwd"],
               "fit_serving": fit["serving"]["launches"]["lstm_fwd"],
               "training_powerSGD": train_psgd["launches"]["lstm_fwd"],
               "cli": cli["launches"]["lstm_fwd"], "cli_site": cli["site_launches"]["lstm_fwd"],
               "plane_batched": plane["batched_dispatch_launches"]["lstm_fwd"],
               "plane_shadow": plane["publish"]["shadow_launches"]["lstm_fwd"],
               "plane_fleet": plane["fleet"]["launches"]["lstm_fwd"]}
    bwd_by_path = {"training": train["launches"]["lstm_bwd"],
                   "training_rankDAD": train_dad["launches"]["lstm_bwd"],
                   "fit": fit["launches"]["lstm_bwd"],
                   "training_powerSGD": train_psgd["launches"]["lstm_bwd"],
                   "cli": cli["launches"]["lstm_bwd"],
                   "cli_site": cli["site_launches"]["lstm_bwd"]}
    for p in hostile["pairs"]:
        by_path[f"hostile_{p['engine']}_{p['robust_agg']}"] = p["launches"]["lstm_fwd"]
        bwd_by_path[f"hostile_{p['engine']}_{p['robust_agg']}"] = p["launches"]["lstm_bwd"]
    for part in ("fit", "cli"):
        by_path[f"hostile_{part}"] = hostile[part]["launches"]["lstm_fwd"]
        bwd_by_path[f"hostile_{part}"] = hostile[part]["launches"]["lstm_bwd"]
    k7_by_path = {"training_rankDAD": train_dad["launches"]["poweriter"],
                  "fs_fit_rankDAD": fs["fits"]["rankDAD"]["launches"]["poweriter"],
                  "fs_cli": fs["cli"]["launches"]["poweriter"],
                  "fs_cli_site": fs["cli"]["site_launches"]["poweriter"],
                  "mm_cli": a9["cli"]["launches"]["poweriter"]}
    for task, short in ((A9_SMRI, "smri"), (A9_MM, "mm")):
        m = a9["models"][task]
        for e in m["epochs"]:
            if e["engine"] == "rankDAD":
                k7_by_path[f"{short}_training_rankDAD_{e['dtype']}"] = e["launches"]["poweriter"]
        k7_by_path[f"{short}_fit_rankDAD"] = m["fit"]["launches"]["poweriter"]
    for p in hostile["pairs"]:
        if p["engine"] == "rankDAD":
            k7_by_path[f"hostile_rankDAD_{p['robust_agg']}"] = p["launches"]["poweriter"]
    k7_by_path["hostile_fit_rankDAD"] = hostile["fit"]["launches"]["poweriter"]
    for p in elastic["pairs"]:
        name = f"elastic_{p['engine']}_{p['mode']}"
        by_path[name] = p["launches"]["lstm_fwd"]
        bwd_by_path[name] = p["launches"]["lstm_bwd"]
        if p["engine"] == "rankDAD":
            k7_by_path[name] = p["launches"]["poweriter"]
    by_path["elastic_kill_fit"] = elastic["kill"]["launches"]["lstm_fwd"]
    bwd_by_path["elastic_kill_fit"] = elastic["kill"]["launches"]["lstm_bwd"]
    by_path["elastic_daemon"] = sum(e["lstm_fwd"] for e in elastic["daemon"]["launches_per_epoch"])
    bwd_by_path["elastic_daemon"] = sum(e["lstm_bwd"]
                                        for e in elastic["daemon"]["launches_per_epoch"])
    for p in privacy["pairs"]:
        name = f"privacy_{p['engine']}_{p['arm']}"
        by_path[name] = p["launches"]["lstm_fwd"]
        bwd_by_path[name] = p["launches"]["lstm_bwd"]
        if p["engine"] == "rankDAD":
            k7_by_path[name] = p["launches"]["poweriter"]
    for part in ("fits", "cli"):
        by_path[f"privacy_{part}"] = privacy[part]["launches"]["lstm_fwd"]
        bwd_by_path[f"privacy_{part}"] = privacy[part]["launches"]["lstm_bwd"]
    by_path["privacy_daemon"] = sum(e["lstm_fwd"] for e in privacy["daemon"]["launches_per_epoch"])
    bwd_by_path["privacy_daemon"] = sum(e["lstm_bwd"]
                                        for e in privacy["daemon"]["launches_per_epoch"])
    k7_by_path["privacy_mm_rankDAD_dp"] = privacy["mm"]["rankDAD"]["dp"]["launches"]["poweriter"]
    for p in telemetry["pairs"]:
        name = f"telemetry_{p['engine']}"
        by_path[name] = p["launches"]["lstm_fwd"]
        bwd_by_path[name] = p["launches"]["lstm_bwd"]
        if p["engine"] == "rankDAD":
            k7_by_path[name] = p["launches"]["poweriter"]
    by_path["telemetry_fit"] = telemetry["fit"]["launches"]["lstm_fwd"]
    bwd_by_path["telemetry_fit"] = telemetry["fit"]["launches"]["lstm_bwd"]
    k7_by_path["telemetry_fit"] = telemetry["fit"]["launches"]["poweriter"]
    by_path["live_cli_flagship"] = live["flagship"]["launches"]["lstm_fwd"]
    by_path["live_cli_fleet"] = live["fleet"]["launches"]["lstm_fwd"]
    for name, bucket in (("lstm_fwd", by_path), ("lstm_bwd", bwd_by_path),
                         ("poweriter", k7_by_path)):
        bucket["live_daemon"] = sum(e[name] for e in live["daemon"]["launches_per_epoch"])
    for engine, f in sched["analysis"]["engine_comparison"].items():
        by_path[f"sched_analysis_{engine}"] = f["launches"]["lstm_fwd"]
        bwd_by_path[f"sched_analysis_{engine}"] = f["launches"]["lstm_bwd"]
        if engine == "rankDAD":
            k7_by_path["sched_analysis_rankDAD"] = f["launches"]["poweriter"]
    for arm, a in sched["analysis"]["pretrain_study"].items():
        k7_by_path[f"sched_pretrain_study_{arm}"] = a["launches"]["poweriter"]
    pre = sched["preemption"]
    by_path["sched_tenant_ica"] = sum(e["lstm_fwd"] for e in pre["ica_launches_per_epoch"])
    bwd_by_path["sched_tenant_ica"] = sum(e["lstm_bwd"] for e in pre["ica_launches_per_epoch"])
    k7_by_path["sched_tenant_ica"] = sum(e["poweriter"] for e in pre["ica_launches_per_epoch"])
    k7_by_path["sched_tenant_fs"] = sum(e["poweriter"] for e in pre["fs_launches_per_epoch"])
    by_path["sched_backfill"] = sched["cli_backfill"]["launches"]["lstm_fwd"]
    for g in ("gen1", "gen2"):  # the supervised worker's two generations
        got = pod["drill"]["launches"][g]
        by_path[f"pod_drill_{g}"] = got["lstm_fwd"]
        bwd_by_path[f"pod_drill_{g}"] = got["lstm_bwd"]
        k7_by_path[f"pod_drill_{g}"] = got["poweriter"]
    for p in mesh["codecs"]["pairs"]:  # phase 24
        name = f"mesh_wire_{p['engine']}_{p['codec']}"
        by_path[name] = p["launches"]["lstm_fwd"]
        bwd_by_path[name] = p["launches"]["lstm_bwd"]
        if p["engine"] == "rankDAD":
            k7_by_path[name] = p["launches"]["poweriter"]
    for engine, p in mesh["nccl"].items():
        by_path[f"mesh_nccl1_{engine}"] = p["launches"]["lstm_fwd"]
        bwd_by_path[f"mesh_nccl1_{engine}"] = p["launches"]["lstm_bwd"]
        if engine == "rankDAD":
            k7_by_path[f"mesh_nccl1_{engine}"] = p["launches"]["poweriter"]
    for r in mesh["gloo"]["ranks"]:
        name = f"mesh_gloo2_rank{r['process_index']}"
        by_path[name] = r["launches"]["lstm_fwd"]
        bwd_by_path[name] = r["launches"]["lstm_bwd"]
        k7_by_path[name] = r["launches"]["poweriter"]
    for run in ("fused", "split_int8", "quorum"):  # phase 25
        for rank, n in enumerate(slices["two"][run]["launches"]):
            name = f"slices_{run}_rank{rank}"
            by_path[name], bwd_by_path[name] = n["lstm_fwd"], n["lstm_bwd"]
            k7_by_path[name] = n["poweriter"]
    for rank, n in enumerate(slices["drill"]["launches"]):
        name = f"slices_drill_gen2_rank{rank}"
        by_path[name], bwd_by_path[name] = n["lstm_fwd"], n["lstm_bwd"]
        k7_by_path[name] = n["poweriter"]
    k7_main = next(s for s in k7 if s["rank"] == K7_RANK and s["dtype"] == "f32"
                   and s["start"] == "cold" and s["tol"] > 0)
    kernels = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "dinunet_implementations_tpu/ops/lstm_pallas.py:91 (_fwd_fused_kernel)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": fwd["max_abs_err"],
        "ms": fwd["ms"], "kernel_ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "shape": {"T": T, "rows": SERVE_ROWS, "D": D, "H": H},
        "design": "two launches: a tiled SIMT GEMM projects x W_ih + b into an f32 scratch "
                  "(lstm_proj_wide_kernel's 128x128 tiles once their grid fills the card, "
                  "lstm_proj_kernel's 64x64 below and in bf16); "
                  "the recurrence runs over a thread-block cluster whose blocks hold their "
                  "W_hh columns in shared memory and exchange h through distributed shared "
                  "memory, one cluster barrier a step (the streaming recurrence for a W_hh "
                  "that fits no cluster of 8)",
        "geometry": fwd["geometry"], "proj_ms": fwd["proj_ms"], "stream_ms": fwd["stream_ms"],
        "shapes": shapes,
        # the unidirectional model's width on the serving plane (phase 15)
        "h348_shapes": plane["k1"],
    }, {
        "name": "lstm_bwd", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "dinunet_implementations_tpu/ops/lstm_pallas.py:174 (_bwd_kernel)",
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path,
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"], "kernel_ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "library": bwd["library"],
        "shape": {"T": T, "rows": TRAIN_SITES * TRAIN_BATCH, "H": H},
        "design": BWD_DESIGN + " (one direction)", "geometry": bwd["geometry"],
        "stream_ms": bwd["stream_ms"], "shapes": bwd_shapes,
    }, {
        "name": "poweriter", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/poweriter.cu",
        "replaces": "dinunet_implementations_tpu/ops/poweriter_pallas.py:164 (_poweriter_kernel)",
        "launches": sum(k7_by_path.values()), "launches_by_path": k7_by_path,
        "max_abs_err": max(s["P"] for s in k7 if s["dtype"] == "f32"),
        "ms": k7_main["ms"], "kernel_ms": k7_main["ms"], "plain_ms": k7_main["plain_ms"],
        "bound_ms": k7_main["bound_ms"], "bound_by": k7_main["bound_by"], "library_ms": None,
        "library": "none: no one PyTorch call computes a shifted-CholeskyQR2 subspace iteration "
                   "with a per-member early exit (torch.svd_lowrank and torch.linalg.svd are "
                   "other algorithms)",
        "shape": {"rank": K7_RANK, "members": k7_main["members"], "buckets": k7_main["shapes"],
                  "dtype": "f32", "start": "cold", "tol": k7_main["tol"]},
        "design": K7_DESIGN, "geometry": k7_main["geometry"], "direct_ms": k7_main["direct_ms"],
        "phases": k7_main["phases"],
        # the streamed floor is computed, not measured: phase 7's lines carry it
        "shapes": [{k: v for k, v in s.items() if k != "streamed_floor_ms"}
                   for s in k7 if "ms" in s],
        # the FS classes (phase 14): r = 10 on the route k7_geometry names
        # for rows of 66 values, r = 2 staged
        "fs_shapes": fs["k7"],
        # the sMRI and multimodal classes (phase 16), one record a K7
        # launch, and the routes of each class's launches
        "a9_shapes": [s for m in a9["models"].values() for s in m["k7"]],
        "a9_routes": {task: m["k7_routes"] for task, m in a9["models"].items()},
    }]
    one = one_model["launches"]
    fused_by_path = {
        "bilstm_fwd": {"eval_rows_1": one["eval_rows_1"]["bilstm_fwd"],
                       "eval_rows_16": one["eval_rows_16"]["bilstm_fwd"],
                       "one_model_gradient": one["one_model_gradient"]["bilstm_fwd"]},
        "bilstm_bwd": {"one_model_gradient": one["one_model_gradient"]["bilstm_bwd"]},
        "bilstm_pool_fwd": {"training_fused_bidir": train_fused["launches"]["bilstm_pool_fwd"],
                            "training_fused_bidir_bf16":
                                train_fused_bf16["launches"]["bilstm_pool_fwd"]},
        "bilstm_pool_bwd": {"training_fused_bidir": train_fused["launches"]["bilstm_pool_bwd"],
                            "training_fused_bidir_bf16":
                                train_fused_bf16["launches"]["bilstm_pool_bwd"]},
    }
    for name, source, line, fn, rows in (
            ("bilstm_fwd", "bilstm_fwd.cu", 470, "_fwd_bidir_kernel", 16),
            ("bilstm_bwd", "bilstm_bwd.cu", 575, "_bwd_bidir_kernel", 16),
            ("bilstm_pool_fwd", "bilstm_fwd.cu", 927, "_fwd_pool_kernel4", 512),
            ("bilstm_pool_bwd", "bilstm_bwd.cu", 1033, "_bwd_pool_kernel4", 512)):
        main_shape = next(r for r in bidir if r["kernel"] == name and r["rows"] == rows
                          and r["dtype"] == "f32")
        by_path = fused_by_path[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"dinunet_implementations_tpu_torch/csrc/{source}",
            "replaces": f"dinunet_implementations_tpu/ops/lstm_pallas.py:{line} ({fn})",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in bidir
                               if r["kernel"] == name and r["dtype"] == "f32"),
            "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
            "library": "cuDNN torch.nn.LSTM(bidirectional=True) "
                       + ("forward" if "fwd" in name else "backward, also dx and dW"),
            "shape": {"T": T, "rows": rows, "D": D, "H": H, "dtype": "f32"},
            "shapes": [r for r in bidir if r["kernel"] == name],
        })
        if "fwd" in name:
            kernels[-1].update({
                "design": "two launches: a GEMM writes x W_ih + b of both directions' 8 gates "
                          "into an f32 scratch (f32: K1's SIMT GEMM, lstm_proj_wide_kernel's "
                          "128x128 tiles once their grid fills the card, lstm_proj_kernel's "
                          "64x64 below; bf16: lstm_proj_mma_kernel on the tensor cores, "
                          "lstm_proj_kernel when D is not a multiple of 8); the recurrence runs over "
                          "thread-block clusters, half of them a direction, whose blocks hold "
                          "their W_hh columns in shared memory and exchange h through distributed "
                          "shared memory, one cluster barrier a step (the first design's one "
                          "launch for a W_hh that fits no cluster of 8)",
                "geometry": main_shape["geometry"], "proj_ms": main_shape["proj_ms"],
                "stream_ms": main_shape["stream_ms"], "scratch_ms": main_shape["scratch_ms"]})
        else:
            cot = ("dhs a full stream or a per-row constant at the stream dtype"
                   if name == "bilstm_bwd" else "dpool / T an f32 per-row constant")
            kernels[-1].update({
                "design": BWD_DESIGN + f" (half of the clusters a direction, each on its own time "
                          f"map; {cot})",
                "geometry": main_shape["geometry"], "stream_ms": main_shape["stream_ms"]})
    print(f"== 26. kernels; total {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
