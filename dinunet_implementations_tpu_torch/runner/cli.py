"""The command line: the port's counterpart of the JAX package's
``runner/cli.py``.

    # a federated fit over a simulator tree, on the card: the FS task unless
    # --task (or the tree's inputspec) names another
    python -m dinunet_implementations_tpu_torch.runner.cli \\
        --data-path datasets/demo --engine rankDAD --epochs 3
    python -m dinunet_implementations_tpu_torch.runner.cli \\
        --data-path ica_tree --task ICA-Classification --engine powerSGD --epochs 3

    # one site alone (SiteRunner), resume, test only, on the CPU
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... --site 0
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... --resume
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... --mode test --device cpu

    # hostile and faulty sites: a fault plan from a file, an attack plan
    # inline, and a robust aggregation (with the reputation layer)
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --faults @faults.json --attacks '{"sign_flip": [[2, 0, -1]]}' \
        --robust-agg trimmed_mean

    # a simulated preemption: exits 75 after the checkpoint of the epoch
    # that crosses round 6; --resume continues bit for bit
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --faults '{"kill_at_round": 6}'

    # the elastic daemon over the tree's sites and a spool of join/leave
    # events, buffered-async; or overlapped rounds in a batch fit
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --serve --serve-capacity 8 --serve-epochs 4 --set staleness_bound=2
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... --overlap-rounds

    # the daemon's live endpoints on 127.0.0.1 (port 0 picks a free one,
    # printed at start): /metrics, /healthz, /statusz with the SLO burn of
    # the epoch time against a p99 target, /tracez
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --serve --statusz-port 0 --slo-p99-ms 500 --telemetry on

    # telemetry: spans, per-site round metrics and the artifacts under
    # <out-dir>/telemetry/fold_<k>, a profiler capture of epochs 2..3, the
    # kernel libraries kept in a cache directory, and the sanitizer
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --telemetry on --xprof-dir prof --set xprof_window=[2,3] \
        --compile-cache kcache --sanitize compile,nans
    python -m dinunet_implementations_tpu_torch.telemetry.report <out-dir>/telemetry

    # the fleet scheduler: --data-path is the scheduler's root; tenants
    # register through <root>/spool/*.json and live under <root>/tenants/<id>/
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path pod \
        --schedule --pod-slices 1 --sched-ticks 40 --statusz-port 0

    # the privacy plane: DP-SGD with an ε budget, masked wires, and a
    # personalized classifier head per site
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path ... \
        --dp-clip 1 --dp-noise 0.5 --dp-epsilon-budget 8 --secure-agg mask \
        --personalize cls_fc3

Any ``TrainConfig`` field (or task-args field) can be set with ``--set
key=value`` (repeatable; the value is parsed as JSON when it parses, e.g.
``--set pretrain=true --set 'pretrain_args={"epochs": 1}'``). Each fold
prints one JSON line, as JAX's CLI does; ``--serve`` prints the daemon's
summary, and a preempted fit prints JAX's ``{"preempted": true, ...}``
line on stderr and exits with its code; a sanitizer violation prints JAX's
``{"sanitizer_violation": ...}`` line on stderr and exits 70 (the daemon
dumps its flight recorder first). ``--schedule`` runs the fleet scheduler
(runner/scheduler.py) over ``--data-path`` as its root and prints its
summary, exit 70 when a tenant built a kernel library after its first
epoch; with ``--statusz-port`` it serves the pod's endpoints, a
``PodCollector`` over the scheduler's bus and the workers that advertise
themselves in heartbeats under the root (``/statusz`` says ``"mode":
"pod"`` and carries the tenant table). ``--serve`` installs the flight
recorder's exception hook (the daemon's preemption guard owns the signals
and dumps on them); ``--statusz-port`` starts the exporter over the
daemon's bus, tracer, flight recorder, probes and status, as JAX's CLI
does. ``--device`` is the port's own:
the card unless ``--device cpu`` is given (the counterpart of JAX's
``JAX_PLATFORMS=cpu``).

Every other flag of the JAX CLI is parsed, and refused with a
``SystemExit`` that names the ROADMAP item that ports it, when it asks for
anything but what the port runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.config import AggEngine, NNComputation, TrainConfig

# the JAX CLI's flags that the port refuses: argparse dest -> (the value
# that asks for nothing the port lacks, or None when any value is refused;
# the ROADMAP item that ports it)
_REFUSED = {
    "model_axis_size": (None, "A11 (c)"),
}


def _parse_set(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v  # bare string
    return out


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (those the port refuses without their help
    text: ``_REFUSED`` names the item of each) and ``--device``."""
    p = argparse.ArgumentParser(
        prog="dinunet-tpu-torch",
        description="Federated training of the dinunet workloads on one CUDA card.")
    p.add_argument("--data-path", required=True,
                   help="dataset tree (the reference's simulator layout: "
                        "input/local*/simulatorRun + inputspec.json)")
    p.add_argument("--task", default=None, choices=list(NNComputation.ALL),
                   help="task id (default: TrainConfig/inputspec default)")
    p.add_argument("--engine", default=None, choices=list(AggEngine.ALL),
                   help="aggregation engine")
    p.add_argument("--mode", default=None, choices=["train", "test"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-folds", type=int, default=None)
    p.add_argument("--out-dir", default=None,
                   help="output root (default <data-path>/output)")
    p.add_argument("--site", type=int, default=None,
                   help="one site alone: fit only this site index (SiteRunner)")
    p.add_argument("--folds", type=int, nargs="*", default=None,
                   help="run only these fold indices")
    p.add_argument("--resume", action="store_true",
                   help="resume each fold from its latest checkpoint")
    p.add_argument("--pipeline", default=None, choices=["device", "host"],
                   help="input pipeline: 'device' (default) keeps the site inventory "
                        "resident on the card and ships an index plan an epoch; 'host' "
                        "copies the dense batches a round at a time")
    p.add_argument("--fused-poweriter", default=None, choices=["auto", "on", "off"],
                   help="rankDAD's power iteration: 'auto' and 'on' run the CUDA kernel on "
                        "the card (what the port always does); 'off' is refused")
    p.add_argument("--faults", default=None, metavar="JSON|@FILE",
                   help="deterministic fault injection (robustness.FaultPlan): inline JSON or "
                        "@path, e.g. '{\"drop\": [[3, 10, -1]], \"nan_at\": [[5, 1]]}'; "
                        "kill_at_round exits 75 after its epoch's checkpoint")
    p.add_argument("--attacks", default=None, metavar="JSON|@FILE",
                   help="byzantine-site attack injection (robustness.AttackPlan): inline JSON "
                        "or @path, e.g. '{\"sign_flip\": [[2, 0, -1]], \"scale\": [[5, 10, "
                        "20]]}'; pair with --robust-agg for the defense")
    p.add_argument("--robust-agg", default=None,
                   choices=["none", "norm_clip", "trimmed_mean", "coordinate_median"],
                   help="byzantine-robust aggregation: norm_clip bounds each site's gradient "
                        "norm at the live-weighted median; trimmed_mean / coordinate_median "
                        "reduce each coordinate over the sites. Any but none also runs the "
                        "reputation quarantine")
    p.add_argument("--serve", action="store_true",
                   help="daemon mode (elastic rounds): a persistent service over a fixed slot "
                        "axis; sites join, leave and rejoin through JSON events in the spool "
                        "(FedDaemon). The tree's local* sites pre-join; with --set "
                        "staleness_bound=N the rounds are buffered-async")
    p.add_argument("--serve-spool", default=None, metavar="DIR",
                   help="the spool directory (default <data-path>/spool): join/leave/shutdown "
                        "events as *.json files, taken in sorted order")
    p.add_argument("--serve-capacity", type=int, default=None,
                   help="slots, fixed for the life of the service (default: the tree's sites)")
    p.add_argument("--serve-quorum", type=int, default=1,
                   help="the fewest occupied slots; below it rounds hold (default 1)")
    p.add_argument("--serve-epochs", type=int, default=None,
                   help="stop after this many trained epochs (default: until a shutdown "
                        "event or SIGTERM)")
    p.add_argument("--serve-poll", type=float, default=0.5,
                   help="the idle spool poll interval in seconds (default 0.5)")
    p.add_argument("--serve-rows", type=int, default=None,
                   help="inventory rows a slot, pinned (default: the first admitted site's)")
    p.add_argument("--schedule", action="store_true",
                   help="fleet-scheduler mode: pack concurrent studies (tenants) onto the "
                        "shared slice pool with weighted fair share, checkpoint-then-yield "
                        "preemption and serving backfill. --data-path is the scheduler ROOT: "
                        "tenants register through <root>/spool/*.json events and live under "
                        "<root>/tenants/<id>/ (runner/scheduler.py FleetScheduler)")
    p.add_argument("--pod-slices", type=int, default=1, metavar="N",
                   help="scheduler mode: the width of the shared slice pool the fair share "
                        "allocates, every slice the one card (default 1)")
    p.add_argument("--sched-wall-s", type=float, default=None, metavar="S",
                   help="scheduler mode: stop after S wall-clock seconds (default: until every "
                        "tenant is done or a shutdown event or signal arrives)")
    p.add_argument("--sched-ticks", type=int, default=None, metavar="N",
                   help="scheduler mode: stop after N scheduling ticks")
    p.add_argument("--statusz-port", type=int, default=None, metavar="PORT",
                   help="with --serve or --schedule (the pod's, merged by the PodCollector): "
                        "the live endpoints on 127.0.0.1:PORT: /metrics "
                        "(Prometheus), /healthz, /statusz (with the SLO burn), /tracez; "
                        "0 picks a free port, printed at start")
    p.add_argument("--slo-p99-ms", type=float, default=None, metavar="MS",
                   help="the p99 target of the /statusz SLO burn over the daemon's epoch "
                        "time (serve_epoch_ms)")
    p.add_argument("--overlap-rounds", action="store_true", default=None,
                   help="apply each round's update one round late, JAX's overlapped rounds "
                        "(on one card there is no collective to hide)")
    p.add_argument("--dp-clip", type=float, default=None, metavar="C",
                   help="DP-SGD: clip each site's round-gradient L2 norm to C before the "
                        "engine; 0 = off")
    p.add_argument("--dp-noise", type=float, default=None, metavar="SIGMA",
                   help="DP-SGD noise multiplier σ: adds σ·C Gaussian noise per site per "
                        "round, drawn per (dp_seed, site, round, leaf). Needs --dp-clip > 0; "
                        "the RDP accountant reports (ε, δ) in the results and logs.json")
    p.add_argument("--dp-epsilon-budget", type=float, default=None, metavar="EPS",
                   help="stop the fit cleanly (checkpointed; the best state is still tested) "
                        "once the accountant's ε reaches this budget; 0 = unbounded")
    p.add_argument("--secure-agg", default=None, choices=["off", "mask", "mask-nopads"],
                   help="secure-aggregation masked wires (dSGD only): 'mask' one-time-pads "
                        "each site's fixed-point delta with pairwise int32 masks that cancel "
                        "exactly in the site sum; 'mask-nopads' is the pads-zeroed "
                        "verification arm (bit-identical results)")
    p.add_argument("--personalize", default=None, metavar="PATTERNS",
                   help="personalized per-site heads: comma-separated parameter-path "
                        "substrings (e.g. 'cls_fc3' for the ICA-LSTM classifier) kept out of "
                        "the aggregation; each site trains and evaluates its own head")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of each fold's whole fit here")
    p.add_argument("--telemetry", default=None, choices=["on", "off"],
                   help="telemetry: span tracer, per-site round metrics and "
                        "manifest.json/metrics.jsonl/Perfetto traces under "
                        "<out-dir>/telemetry/fold_<k>; 'off' (default) runs without them")
    p.add_argument("--xprof-dir", default=None, metavar="DIR",
                   help="torch.profiler capture of an epoch window only (TrainConfig."
                        "xprof_window, default epoch 1; --set xprof_window=[3,5]); the "
                        "windowed alternative to --profile-dir")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build the kernel libraries into and load them from DIR "
                        "(TrainConfig.compile_cache_dir): a later run loads what an earlier "
                        "one built there")
    p.add_argument("--sanitize", nargs="?", const="1", default=None, metavar="FLAGS",
                   help="runtime sanitizer (checks/sanitize.py) around every fit: no kernel "
                        "library built after the first epoch (compile), autograd anomaly "
                        "mode (nans), leaks accepted and unchecked; a comma subset of "
                        "compile,leaks,nans (default: all). Sets DINUNET_SANITIZE")
    p.add_argument("--device", default=None,
                   help="where to run: the CUDA card by default, 'cpu' to run on the CPU")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override any TrainConfig / task-args field (repeatable; value "
                        "parsed as JSON when possible)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process runs: the process group's coordinator (rank 0 hosts "
                        "it); every process passes the same address. The backend follows "
                        "--device: nccl on the card, gloo on the CPU")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process runs: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process runs: this process's rank")
    p.add_argument("--sites-per-device", type=int, default=None,
                   help="virtual sites a rank holds (TrainConfig.sites_per_device); a rank "
                        "has one device, so over W processes it must be sites / W")
    p.add_argument("--wire-quant", default=None, choices=["none", "bf16", "int8", "fp8"],
                   help="the engines' wire codec (TrainConfig.wire_quant): bf16, or a "
                        "one-byte int8 / fp8 grid with a scale a payload")
    p.add_argument("--slices", type=int, default=None,
                   help="lay the site axis over this many slices of the process group's ranks "
                        "(TrainConfig.num_slices; needs --coordinator, --num-processes and "
                        "--process-id, a multiple of the slices)")
    p.add_argument("--dcn-wire-quant", default=None, choices=["none", "bf16", "int8", "fp8"],
                   help="the inter-slice wire codec (TrainConfig.dcn_wire_quant; default: "
                        "follow --wire-quant, 'none' the fused exact form)")
    p.add_argument("--min-slices", type=int, default=None,
                   help="the slice quorum (TrainConfig.min_slices): a round with fewer live "
                        "slices holds; needs --slices > 1 and a --faults plan with slice "
                        "windows")
    p.add_argument("--model-axis-size", type=int, default=None, help=argparse.SUPPRESS)
    return p


def _refuse(args) -> None:
    """``SystemExit`` naming the ROADMAP item of the first flag given that
    asks for what the port does not run."""
    for dest, (off, item) in _REFUSED.items():
        value = getattr(args, dest)
        if value is not None and value is not False and value != off:
            flag = "--" + dest.replace("_", "-")
            shown = flag if value is True else f"{flag} {value!r}"
            raise SystemExit(f"{shown} is not ported: ROADMAP {item}")
    if args.fused_poweriter == "off":
        raise SystemExit(
            "--fused-poweriter off asks for the JAX package's XLA power-iteration loop, which "
            "has no counterpart on the card: the port runs rankDAD's power iteration as its "
            "CUDA kernel on the card (its plain version on the CPU)")


def _plans(args):
    """The ``--faults`` and ``--attacks`` plans, each None when not given;
    a plan that does not parse exits naming the flag."""
    from ..robustness.attacks import parse_attack_plan
    from ..robustness.faults import parse_fault_plan

    plans = []
    for flag, arg, parse in (("--faults", args.faults, parse_fault_plan),
                             ("--attacks", args.attacks, parse_attack_plan)):
        try:
            plans.append(parse(arg))
        except (ValueError, OSError, TypeError) as e:
            raise SystemExit(f"{flag}: {e}")
    return plans


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse(args)
    overrides = _parse_set(args.overrides)
    for key, val in (("task_id", args.task), ("agg_engine", args.engine), ("mode", args.mode),
                     ("epochs", args.epochs), ("batch_size", args.batch_size),
                     ("num_folds", args.num_folds), ("pipeline", args.pipeline),
                     ("robust_agg", args.robust_agg), ("overlap_rounds", args.overlap_rounds),
                     ("dp_clip", args.dp_clip), ("dp_noise_multiplier", args.dp_noise),
                     ("dp_epsilon_budget", args.dp_epsilon_budget),
                     ("secure_agg", args.secure_agg), ("telemetry", args.telemetry),
                     ("profile_dir", args.profile_dir), ("xprof_dir", args.xprof_dir),
                     ("compile_cache_dir", args.compile_cache),
                     ("wire_quant", args.wire_quant),
                     ("sites_per_device", args.sites_per_device),
                     ("num_slices", args.slices), ("dcn_wire_quant", args.dcn_wire_quant),
                     ("min_slices", args.min_slices),
                     ("personalize", None if args.personalize is None
                      else tuple(p for p in args.personalize.split(",") if p))):
        if val is not None:
            overrides[key] = val
    cfg = TrainConfig().with_overrides(overrides)
    verbose = not args.quiet
    fault_plan, attack_plan = _plans(args)
    if args.sanitize is not None:
        # the runners read the variable; check the flags here for an early,
        # readable error
        from ..checks.sanitize import ENV_VAR, sanitize_flags

        try:
            sanitize_flags(args.sanitize)
        except ValueError as e:
            raise SystemExit(f"--sanitize: {e}")
        os.environ[ENV_VAR] = args.sanitize
    from ..checks.sanitize import SanitizerViolation
    from ..telemetry.sink import _finite  # strict JSON, as JAX's CLI prints it

    mh_flags = (args.coordinator, args.num_processes, args.process_id)
    multi = False
    if any(f is not None for f in mh_flags):
        complete = all(f is not None for f in mh_flags)
        solo = args.num_processes == 1 and args.coordinator is None and args.process_id is None
        if not complete and not solo:
            # a worker with a partial spec must not run alone on the whole
            # tree as if it were the federation
            raise SystemExit("multi-process runs need all of --coordinator, --num-processes "
                             "and --process-id together (--num-processes 1 alone runs "
                             "single-process)")
        multi = not solo
    if multi:
        # refused before anything joins: only the federated fit runs over a
        # process group
        if args.schedule or args.serve:
            mode = "--schedule" if args.schedule else "--serve"
            raise SystemExit(f"{mode} over a process group (--coordinator, --num-processes, "
                             "--process-id) is not ported: ROADMAP A11 (b)")
        if args.site is not None:
            raise SystemExit("--site is one site's local fit in one process; --coordinator, "
                             "--num-processes and --process-id are federated-mode options")

    if args.schedule:
        if args.serve or args.site is not None or args.folds is not None:
            raise SystemExit("--schedule is the fleet-scheduler mode; --serve/--site/--folds "
                             "are single-fit options")
        from .scheduler import FleetScheduler

        sched = FleetScheduler(args.data_path, pod_slices=args.pod_slices, poll_s=args.serve_poll,
                               verbose=verbose, device=args.device)
        exporter = None
        if args.statusz_port is not None:
            from ..telemetry.collector import PodCollector
            from ..telemetry.exporter import ENDPOINTS, StatusExporter

            # the pod's scope: the scheduler's bus and any worker that
            # advertises its exporter in a heartbeat under the root, merged
            # behind one /statusz
            collector = PodCollector(args.data_path, local_bus=sched.bus,
                                     local_labels={"process": "scheduler"},
                                     status_extra=sched.status)
            exporter = StatusExporter(
                collector, port=args.statusz_port, health=sched.health_probes(),
                statusz=collector.status,
                slo=({"histogram": "serve_epoch_ms", "p99_target_ms": args.slo_p99_ms}
                     if args.slo_p99_ms is not None else None))
            port = exporter.start()
            if verbose:
                print(json.dumps({"statusz": f"http://127.0.0.1:{port}",
                                  "endpoints": ENDPOINTS}), flush=True)
        try:
            summary = sched.run(max_wall_s=args.sched_wall_s, max_ticks=args.sched_ticks)
        except SanitizerViolation as v:
            print(json.dumps({"sanitizer_violation": str(v)}), file=sys.stderr)
            return 70
        finally:
            if exporter is not None:
                exporter.stop()
        print(json.dumps(_finite(summary), default=str))
        return 0

    if args.serve:
        if args.site is not None or args.folds is not None:
            raise SystemExit("--serve is the daemon mode; --site/--folds are batch-mode options")
        from .fed_runner import FedDaemon, discover_site_dirs

        daemon = FedDaemon(
            cfg, capacity=args.serve_capacity or len(discover_site_dirs(args.data_path)),
            spool_dir=args.serve_spool, out_dir=args.out_dir, data_path=args.data_path,
            quorum=args.serve_quorum, poll_s=args.serve_poll, fault_plan=fault_plan,
            attack_plan=attack_plan, inventory_rows=args.serve_rows, resume=args.resume,
            verbose=verbose, device=args.device)
        # the preemption guard owns SIGTERM and SIGINT while the daemon
        # serves, and dumps the flight recorder on them: the hook here is
        # the exception's only
        daemon.flight.install(signals=())
        exporter = None
        if args.statusz_port is not None:
            from ..telemetry.exporter import ENDPOINTS, StatusExporter

            exporter = StatusExporter(
                daemon.bus, port=args.statusz_port, tracer=daemon.trainer.tracer,
                flight=daemon.flight, health=daemon.health_probes(), statusz=daemon.status,
                slo=({"histogram": "serve_epoch_ms", "p99_target_ms": args.slo_p99_ms}
                     if args.slo_p99_ms is not None else None))
            port = exporter.start()
            if verbose:
                print(json.dumps({"statusz": f"http://127.0.0.1:{port}",
                                  "endpoints": ENDPOINTS}), flush=True)
        from ..checks.sanitize import sanitized_fit

        try:
            # the compile guard over the whole service: churn builds nothing
            with sanitized_fit(daemon, label="serve"):
                summary = daemon.serve(max_epochs=args.serve_epochs)
        except SanitizerViolation as v:
            daemon.flight.dump("sanitizer-violation")
            print(json.dumps({"sanitizer_violation": str(v)}), file=sys.stderr)
            return 70
        finally:
            # on a failure the exception hook stays: an exception that
            # unwinds past here still dumps the ring
            if exporter is not None:
                exporter.stop()
        daemon.flight.uninstall()
        print(json.dumps(_finite(summary), default=str))
        return 0

    if args.site is not None:
        if args.folds is not None or args.resume:
            raise SystemExit("--folds/--resume are federated-mode options; not supported "
                             "together with --site")
        for flag, plan in (("--faults", fault_plan), ("--attacks", attack_plan)):
            if plan is not None:
                raise SystemExit(f"{flag} targets federated rounds; not supported with --site")
        from .fed_runner import SiteRunner

        runner = SiteRunner(
            task_id=cfg.task_id, data_path=args.data_path, mode=cfg.mode,
            site_index=args.site, out_dir=args.out_dir, device=args.device,
            # the keys passed explicitly above already carry any override
            **{k: v for k, v in overrides.items()
               if k not in ("task_id", "mode", "site_index", "out_dir", "device")})
        try:
            results = runner.run(verbose=verbose)
        except SanitizerViolation as v:
            print(json.dumps({"sanitizer_violation": str(v)}), file=sys.stderr)
            return 70  # EX_SOFTWARE: an internal invariant broke
    else:
        from .fed_runner import FedRunner

        from ..robustness.preemption import Preempted

        from ..parallel.distributed import distributed_init, distributed_shutdown

        try:
            if multi:
                distributed_init(coordinator_address=args.coordinator,
                                 num_processes=args.num_processes, process_id=args.process_id,
                                 device=args.device)
            runner = FedRunner(cfg, data_path=args.data_path, out_dir=args.out_dir,
                               fault_plan=fault_plan, attack_plan=attack_plan, device=args.device)
            results = runner.run(folds=args.folds, verbose=verbose, resume=args.resume)
        except SanitizerViolation as v:
            print(json.dumps({"sanitizer_violation": str(v)}), file=sys.stderr)
            return 70  # EX_SOFTWARE: an internal invariant broke
        except Preempted as p:
            # a cooperative stop (a signal, or the FaultPlan kill) after the
            # checkpoint: --resume continues bit for bit from that epoch
            print(json.dumps({"preempted": True, "reason": p.reason, "epoch": p.epoch,
                              "resume_with": "--resume"}), file=sys.stderr)
            return p.exit_code
        finally:
            # a process group ends with the fit, whatever the fit's end
            distributed_shutdown()

    for k, res in enumerate(results):
        loss, metric = res["test_metrics"][0]
        print(json.dumps({
            "fold": (args.folds or list(range(len(results))))[k],
            "test_loss": loss,
            f"test_{cfg.monitor_metric}": metric,
            "best_val_epoch": res["best_val_epoch"],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
