"""The multi-process worker: the port of the JAX package's
``runner/dcn_worker.py``.

Each invocation joins a process group as ONE rank of ``--num-processes``
(parallel/distributed.py ``distributed_init``) and trains the shared
federated fit (``FedRunner`` with ``mesh="auto"``: the site mesh over the
group, ``K = S / W`` sites a rank). With ``--slices N`` the mesh is the
three-tier ``(slice, site, model)`` topology (parallel/mesh.py
``sliced_site_mesh`` through ``TrainConfig.num_slices``): the ranks lie
slice-major, ``W / N`` a slice, and the only traffic across slices is the
inter-slice hop of each round's reductions, through ``--dcn-wire-quant``
when it sets a codec. Every rank computes the same replicated update; only
rank 0 writes logs and checkpoints. A launch, one process a rank::

    python -m dinunet_implementations_tpu_torch.runner.dcn_worker \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id $RANK \\
        --slices 2 --data-path /data/tree --out-dir /shared/out --report rep.json

The backend follows ``--device`` (nccl on the card, gloo on the CPU)
unless ``--backend`` names one; several ranks on one card run gloo. A rank
with no ``--device`` runs on its card under either backend, and on the
CPU only when ``--device cpu`` says so. A rank holds one device, so
``--devices-per-process`` (JAX's virtual devices a process) takes 1 only.

Each slice's first rank is its lead: with ``--out-dir`` it pulses
``<out>/heartbeats/slice_<i>.json`` (runner/supervisor.py ``Heartbeat``)
and serves its own ``/statusz`` on a port it picks and advertises there;
with ``--slice-ckpt`` it rotates the slice's checkpoint sidecar
(``<out>/slices/slice_<i>/``, the whole state every epoch with a
``params_sha256`` meta, the consensus input). ``--pod-trace ID`` stamps
every epoch span with the pod's trace id and writes the rank's spans to
``<out>/pod_trace/``. A ``--faults`` plan's ``kill_slice_at`` makes the
named slice's ranks SIGKILL themselves once their round counter crosses
it (first generation only).

``--supervise`` makes the invocation the fleet's SUPERVISOR instead
(JAX's ``_supervise``): it launches one worker a rank, watches their exits
and heartbeats (runner/supervisor.py ``SliceSupervisor``), records each
slice death in the liveness spool, drains the survivors, installs the
checkpoint consensus (:func:`install_consensus`: the newest round the
surviving slices' sidecars agree on by digest becomes the fleet's resume
point, the decision under ``<out>/consensus/decision_gen<g>.json``) and
relaunches everything with ``--resume``. ``--statusz-port`` serves the
pod's merged ``/metrics`` and ``/statusz`` (telemetry/collector.py
``PodCollector``). Under gloo a peer's death fails a rank's next
collective at once; a supervised worker then waits to be drained, so that
the death the supervisor records is the peer's.

``--report PATH`` writes one JSON record of this rank (each rank passes
its own path; a supervisor gives each worker ``<path>_p<rank>``): the
mesh, the per-epoch losses, the test metrics, the params checksum (equal
on every rank of a correct run), the kernel libraries built or loaded,
the fit's seconds, the rank's K1, K2 and K7 launches, its collectives and
its write counts.

Exit codes (every failure path calls ``distributed_shutdown()`` first, so
a dead peer becomes a nonzero exit, not a hang):

- ``0``: the run completed;
- ``2``: an argument is refused: a ``--faults`` plan that does not parse,
  ``--slices`` that does not divide ``--num-processes``, or
  ``--devices-per-process`` other than 1;
- ``66`` (:data:`UNSUPPORTED_RC`): the backend cannot run here (gloo or
  nccl missing from this torch build, nccl with no card); a supervisor
  passes it on as it is;
- ``128 + signum`` / ``75``: cooperative preemption after the rotating
  checkpoint (robustness/preemption.py ``Preempted.exit_code``);
- ``-9`` / ``137``: the ``kill_slice_at`` self-SIGKILL;
- ``69`` (runner/supervisor.py ``SUPERVISOR_GAVE_UP_RC``): supervisor
  only, a slice kept dying past ``--max-restarts``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

#: exit code for "this backend cannot run collectives here"
UNSUPPORTED_RC = 66


def _parse(argv):
    p = argparse.ArgumentParser(prog="dcn_worker",
                                description="multi-process federated training worker")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="the process group's coordinator (rank 0 hosts it); omit with "
                        "--num-processes 1 for the single-process reference run")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--data-path", required=True,
                   help="dataset tree (the reference's simulator layout); every process loads "
                        "the same tree and trains its own block of the sites")
    p.add_argument("--out-dir", default=None,
                   help="shared output dir (rank 0 writes; heartbeats, the liveness spool and "
                        "the slices' checkpoint sidecars live here too)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the run-report JSON here (supervised: one _p<rank> report a "
                        "worker)")
    p.add_argument("--slices", type=int, default=1,
                   help="slices of the (slice, site, model) mesh; must divide --num-processes "
                        "(1: the (site, model) mesh)")
    p.add_argument("--dcn-wire-quant", default="", choices=["", "none", "bf16", "int8", "fp8"],
                   help="the inter-slice wire codec (TrainConfig.dcn_wire_quant; '' follows "
                        "--set wire_quant)")
    p.add_argument("--devices-per-process", type=int, default=None,
                   help="devices a process (JAX's virtual CPU devices): a rank holds one "
                        "device, so only 1 is taken")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--task", default="FS-Classification")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--faults", default=None, metavar="JSON|@FILE",
                   help="deterministic FaultPlan (robustness/faults.py) of site and slice "
                        "windows; kill_slice_at is a real self-SIGKILL of the named slice's "
                        "ranks (first generation only)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the last rotating checkpoint (the supervisor passes it "
                        "on every relaunch)")
    p.add_argument("--supervise", action="store_true",
                   help="run as the fleet supervisor: launch one worker a rank, watch "
                        "heartbeats and exits, restart after a slice death through the "
                        "checkpoint consensus (module docstring)")
    p.add_argument("--heartbeat-s", type=float, default=2.0,
                   help="the slice leads' heartbeat interval (seconds)")
    p.add_argument("--heartbeat-timeout-s", type=float, default=30.0,
                   help="supervisor: a heartbeat older than this is a wedged worker; a "
                        "supervised worker whose group lost a peer waits this long to be "
                        "drained")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="supervisor: give up (rc 69) after this many fleet restarts")
    p.add_argument("--slice-ckpt", action="store_true",
                   help="rotate this slice's checkpoint sidecar every epoch (the consensus "
                        "input; the supervisor passes it to its workers)")
    p.add_argument("--restart-generation", type=int, default=1,
                   help=argparse.SUPPRESS)  # the supervisor's
    p.add_argument("--statusz-port", type=int, default=None, metavar="PORT",
                   help="supervisor: serve the pod's merged /metrics and /statusz here "
                        "(workers pick their own port and advertise it in the heartbeat)")
    p.add_argument("--slo-p99-ms", type=float, default=2000.0, metavar="MS",
                   help="supervisor: the p99 target of the pod /statusz SLO burn over the "
                        "fleet's merged epoch_ms")
    p.add_argument("--pod-trace", default=None, metavar="ID",
                   help="the pod's trace id on every epoch span (the supervisor mints one "
                        "and passes it to every worker)")
    p.add_argument("--device", default=None,
                   help="this rank's device: the card by default (cuda:<rank> modulo the "
                        "cards, under either backend), 'cpu', or e.g. 'cuda:0' for several "
                        "ranks on one card")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the collectives' backend (default: nccl on the card, gloo on the CPU)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="raw TrainConfig overrides (JSON-parsed values)")
    return p.parse_args(argv)


def _config_overrides(pairs):
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _slice_of(process_id: int, num_processes: int, slices: int) -> int:
    """The slice of a rank: ranks are slice-major, contiguous (JAX's
    processes as slice granules)."""
    if slices <= 1:
        return 0
    return process_id // max(num_processes // slices, 1)


def _params_checksum(state) -> str:
    """A digest of the replicated params, leaf by leaf in name order (a
    state restored from a checkpoint holds its leaves in another order
    than a fresh one): every rank of a correct run reports the same hex,
    and the checkpoint consensus keys on it."""
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(state.params):
        h.update(np.ascontiguousarray(state.params[k].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _unsupported(backend: str, device) -> str | None:
    """Why ``backend`` cannot run on ``device`` here, or None."""
    import torch
    import torch.distributed as dist

    if not dist.is_available():
        return "this torch build has no torch.distributed"
    if backend == "gloo" and not dist.is_gloo_available():
        return "this torch build has no gloo backend"
    if backend == "nccl":
        if not dist.is_nccl_available():
            return "this torch build has no nccl backend"
        if not torch.cuda.is_available():
            return "the nccl backend needs a CUDA card"
    return None


def _refusal(args) -> str | None:
    """Why the arguments are refused (exit 2), or None."""
    if args.devices_per_process is not None and args.devices_per_process != 1:
        return (f"--devices-per-process {args.devices_per_process}: a rank holds one device "
                "(its card, or the CPU); JAX's virtual CPU devices have no counterpart here")
    if args.slices < 1 or args.num_processes % args.slices:
        return (f"--slices {args.slices} must divide --num-processes {args.num_processes}: "
                "slices are rank granules")
    return None


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _report_path(base: str | None, rank: int) -> str | None:
    if not base:
        return None
    root, ext = os.path.splitext(base)
    return f"{root}_p{rank}{ext or '.json'}"


def install_consensus(out_dir: str, task: str, num_slices: int, generation: int,
                      dead_slice: int, flight=None, fold: int = 0) -> dict:
    """JAX's consensus install: the newest round on which the surviving
    slices' sidecars agree by digest (every slice's when none survives)
    becomes the fleet's resume point, copied over the fold's rotating
    checkpoint unless that already sits at the agreed epoch (it keeps its
    richer fit meta then). The decision is written to
    ``<out>/consensus/decision_gen<generation>.json`` in JAX's format and
    returned."""
    import shutil

    from ..telemetry.postmortem import CONSENSUS_DIR
    from ..trainer.checkpoint import CorruptCheckpointError, load_meta
    from ..trainer.logs import fold_dir
    from .supervisor import _atomic_json, consensus_round, slice_ckpt_dir

    decision_path = os.path.join(out_dir, CONSENSUS_DIR, f"decision_gen{generation}.json")
    os.makedirs(os.path.dirname(decision_path), exist_ok=True)
    slices = range(max(num_slices, 1))
    dirs = {sl: slice_ckpt_dir(out_dir, sl) for sl in slices if sl != dead_slice}
    agreed = consensus_round(dirs or {sl: slice_ckpt_dir(out_dir, sl) for sl in slices})
    if agreed is None:
        if flight is not None:
            flight.note("consensus-none", generation=generation)
        decision = {"time_unix": time.time(), "generation": generation,
                    "dead_slice": dead_slice, "round": None}
        _atomic_json(decision_path, decision)
        return decision  # the fleet resumes from the fold's checkpoint as it is
    rnd, sha, path = agreed
    epoch = load_meta(path).get("epoch")
    resume = os.path.join(fold_dir(out_dir, "remote", task, fold), "checkpoint_latest.msgpack")
    try:
        fold_epoch = load_meta(resume).get("epoch")
    except (OSError, CorruptCheckpointError):
        fold_epoch = None
    if fold_epoch != epoch:
        # torn, missing, or past the agreement (rank 0 sealed an epoch a
        # dead slice never did): roll the fleet back to the agreed one
        os.makedirs(os.path.dirname(resume), exist_ok=True)
        shutil.copyfile(path, resume)
    if flight is not None:
        flight.note("consensus-install", round=rnd, epoch=epoch, sha=sha[:12],
                    replaced=fold_epoch != epoch)
    decision = {"time_unix": time.time(), "generation": generation, "dead_slice": dead_slice,
                "round": rnd, "epoch": epoch, "sha": sha, "replaced": fold_epoch != epoch}
    _atomic_json(decision_path, decision)
    return decision


def _supervise(args) -> int:
    """The ``--supervise`` entry: a ``SliceSupervisor`` over one worker
    process a rank (module docstring). It joins no process group itself."""
    import subprocess

    from ..telemetry.bus import global_bus
    from ..telemetry.flight import FlightRecorder
    from ..telemetry.tracer import new_trace_id
    from .supervisor import SliceSupervisor

    out_dir = args.out_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    flight = FlightRecorder(out_dir, bus=global_bus())
    flight.install()  # crash dumps; SIGTERM chained (no guard owns it here)
    # one pod-wide trace id for the whole run, every generation
    pod_trace = args.pod_trace or new_trace_id()
    launch = {"generation": 0, "port": None}

    def spawn(rank: int, generation: int):
        if generation != launch["generation"]:
            launch["generation"] = generation
            launch["port"] = _free_port()
        argv = [sys.executable, "-m", "dinunet_implementations_tpu_torch.runner.dcn_worker",
                "--coordinator", f"127.0.0.1:{launch['port']}",
                "--num-processes", str(args.num_processes), "--process-id", str(rank),
                "--data-path", args.data_path, "--slices", str(args.slices),
                "--epochs", str(args.epochs), "--task", args.task,
                "--batch-size", str(args.batch_size), "--heartbeat-s", str(args.heartbeat_s),
                "--heartbeat-timeout-s", str(args.heartbeat_timeout_s),
                "--restart-generation", str(generation), "--pod-trace", pod_trace,
                "--slice-ckpt", "--out-dir", out_dir]
        for flag, value in (("--dcn-wire-quant", args.dcn_wire_quant), ("--faults", args.faults),
                            ("--device", args.device), ("--backend", args.backend),
                            ("--report", _report_path(args.report, rank))):
            if value:
                argv += [flag, value]
        if args.resume or generation > 1:
            argv.append("--resume")
        for kv in args.overrides:
            argv += ["--set", kv]
        with open(os.path.join(out_dir, f"worker_p{rank}_gen{generation}.log"), "w") as log:
            # the child holds its own copy of the descriptor
            return subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT)

    def on_consensus(generation: int, dead_slice: int) -> None:
        install_consensus(out_dir, args.task, args.slices, generation, dead_slice, flight)

    sup = SliceSupervisor(spawn, num_processes=args.num_processes, out_dir=out_dir,
                          slice_of_process=lambda r: _slice_of(r, args.num_processes,
                                                               args.slices),
                          heartbeat_timeout_s=args.heartbeat_timeout_s,
                          max_restarts=args.max_restarts, flight=flight, bus=global_bus(),
                          on_consensus=on_consensus, passthrough_rcs=(UNSUPPORTED_RC,))
    exporter = None
    if args.statusz_port is not None:
        # the pod plane: one /statusz and /metrics for the fleet, every
        # worker found through its heartbeat and its bus merged
        from ..telemetry.collector import PodCollector
        from ..telemetry.exporter import StatusExporter

        collector = PodCollector(out_dir, local_bus=global_bus(),
                                 local_labels={"process": "supervisor"},
                                 status_extra=lambda: {"mode": "supervisor",
                                                       "generation": sup.generation,
                                                       "restarts": sup.restarts,
                                                       "pod_trace": pod_trace})
        exporter = StatusExporter(collector, port=args.statusz_port, flight=flight,
                                  statusz=collector.status,
                                  slo={"histogram": "epoch_ms",
                                       "p99_target_ms": args.slo_p99_ms})
        port = exporter.start()
        print(f"[supervise] pod statusz http://127.0.0.1:{port}/statusz (federated /metrics, "
              "SLO over merged epoch_ms)", flush=True)
    rc = sup.run()
    flight.note("supervisor-exit", rc=rc, restarts=sup.restarts)
    if exporter is not None:
        exporter.stop()
    # the supervisor's ring reaches disk on a clean exit too: it is the
    # post-mortem's evidence
    flight.dump(f"supervisor-exit:rc={rc}")
    try:
        from ..telemetry.assemble import POD_TRACE_DIR, POD_TRACE_FILE, assemble

        if os.path.isdir(os.path.join(out_dir, POD_TRACE_DIR)):
            assemble(out_dir, os.path.join(out_dir, POD_TRACE_DIR, POD_TRACE_FILE))
    except (OSError, ValueError, TypeError, KeyError) as e:
        # the assembled trace is a convenience: it never masks the run's rc
        flight.note("pod-trace-assembly-failed", error=repr(e))
    return rc


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def _await_drain(timeout_s: float) -> None:
    """Wait up to ``timeout_s`` for the supervisor's SIGTERM (whose default
    disposition, chained by the flight recorder, ends the process)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        time.sleep(0.2)


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    why = _refusal(args)
    if why is not None:
        print(why, file=sys.stderr)
        return 2
    if args.supervise:
        return _supervise(args)

    from ..parallel.distributed import default_backend, distributed_init, distributed_shutdown
    from ..robustness.faults import parse_fault_plan
    from ..robustness.preemption import Preempted
    from .supervisor import Heartbeat, heartbeat_path, slice_ckpt_dir

    try:
        fault_plan = parse_fault_plan(args.faults)
    except (ValueError, OSError) as e:
        print(f"--faults: {e}", file=sys.stderr)
        return 2
    backend = args.backend or default_backend(args.device)
    multi_run = args.num_processes > 1
    if multi_run:
        why = _unsupported(backend, args.device)
        if why is not None:
            print(f"UNSUPPORTED: {why}", flush=True)
            return UNSUPPORTED_RC

    slice_id = _slice_of(args.process_id, args.num_processes, args.slices)
    # one sidecar and heartbeat writer a slice: the params are replicated,
    # so the slice's first rank writing loses nothing
    procs_per_slice = max(args.num_processes // max(args.slices, 1), 1)
    slice_lead = args.process_id % procs_per_slice == 0
    heartbeat = flight = None
    if args.out_dir:
        from ..telemetry.flight import FlightRecorder

        flight = FlightRecorder(args.out_dir)
        # crash and SIGTERM-outside-the-fit dumps; during the fit the
        # PreemptionGuard owns SIGTERM and the Preempted arm below dumps
        flight.install()
        if slice_lead:
            heartbeat = Heartbeat(heartbeat_path(args.out_dir, slice_id), slice_id,
                                  interval_s=args.heartbeat_s).start()
    multi = distributed_init(coordinator_address=args.coordinator,
                             num_processes=args.num_processes, process_id=args.process_id,
                             backend=backend, device=args.device)

    from .. import TrainConfig
    from ..ops import _build
    from ..trainer import loop as loop_mod
    from ..trainer.steps import gather_site_state
    from .fed_runner import FedRunner

    writes = {"logs": 0, "ckpt": 0}
    orig_logs, orig_ckpt = loop_mod.write_logs_json, loop_mod.save_checkpoint
    orig_load = loop_mod.load_checkpoint

    def count_logs(*a, **k):
        writes["logs"] += 1
        return orig_logs(*a, **k)

    def count_ckpt(*a, **k):
        writes["ckpt"] += 1
        return orig_ckpt(*a, **k)

    def timed_load(*a, **k):
        # the resume's reload: the first checkpoint the fit reads back
        t = time.perf_counter()
        out = orig_load(*a, **k)
        if final["reload_ms"] is None:
            final["reload_ms"] = (time.perf_counter() - t) * 1e3
        return out

    loop_mod.write_logs_json, loop_mod.save_checkpoint = count_logs, count_ckpt
    loop_mod.load_checkpoint = timed_load
    # the last epoch's state (the checksum) and trainer; the global epoch
    # and round, which the heartbeat and the statusz carry; each epoch's
    # round counter, params digest and quorum holds, and the collectives
    # the epochs ran (the evaluations' gathers left out)
    final = {"state": None, "trainer": None, "epoch": 0, "round": 0, "reload_ms": None,
             "epoch_rounds": [], "epoch_params_sha256": [], "held_rounds": 0,
             "epoch_collectives": {}}

    exporter = None
    if heartbeat is not None:
        # the pod plane: each slice lead serves its own /statusz on a port it
        # picks and advertises in its heartbeat (started_unix lets the
        # collector reject a recycled pid)
        from ..telemetry.bus import global_bus
        from ..telemetry.exporter import StatusExporter

        exporter = StatusExporter(global_bus(), flight=flight, statusz=lambda: {
            "mode": "dcn_worker", "process_id": args.process_id, "slice": slice_id,
            "generation": args.restart_generation, "started_unix": heartbeat.started_unix,
            "epoch": final["epoch"], "round": final["round"]})
        heartbeat.beat(statusz_port=exporter.start(), process=args.process_id)

    def write_pod_trace() -> None:
        """This rank's spans to ``<out>/pod_trace/`` for the cross-process
        assembler (the fit's own sink is rank 0's only)."""
        tr = final["trainer"]
        if args.out_dir and args.pod_trace and tr is not None and tr.tracer.enabled:
            from ..telemetry.assemble import POD_TRACE_DIR

            tr.tracer.write_jsonl(os.path.join(
                args.out_dir, POD_TRACE_DIR,
                f"trace_p{args.process_id}_gen{args.restart_generation}.jsonl"))

    def stop_plane() -> None:
        if heartbeat is not None:
            heartbeat.stop()
        if exporter is not None:
            exporter.stop()

    from ..engines import lowrank
    from ..ops import lstm_cuda, poweriter_cuda
    from ..parallel import collectives

    orig_run_epoch = loop_mod.FederatedTrainer.run_epoch
    kill_round = (fault_plan.kill_round_for_slice(slice_id)
                  if fault_plan is not None and args.restart_generation <= 1 else None)
    my_ckpt_dir = (slice_ckpt_dir(args.out_dir, slice_id)
                   if args.out_dir and args.slice_ckpt and slice_lead else None)

    def record_run_epoch(self, state, *a, **k):
        # the first call reads the input state's round: a resumed fit
        # starts past 0, and the kill keys on rounds this run crosses
        round_before = final["round"] if final["epoch"] else int(state.round)
        counts0 = dict(collectives.COLLECTIVES)
        if args.pod_trace:
            with self.tracer.span("dcn-epoch", trace=args.pod_trace, slice=slice_id,
                                  process=args.process_id, generation=args.restart_generation):
                out = orig_run_epoch(self, state, *a, **k)
        else:
            out = orig_run_epoch(self, state, *a, **k)
        final["state"], final["trainer"] = out[0], self
        for key, n in collectives.COLLECTIVES.items():
            final["epoch_collectives"][key] = (final["epoch_collectives"].get(key, 0)
                                               + n - counts0[key])
        # the fit's global epoch (run_epoch's third argument): a restarted
        # generation resumes past its first
        final["epoch"] = int(a[1] if len(a) > 1 else k.get("epoch", 0))
        final["round"] = int(out[0].round)
        final["epoch_rounds"].append(final["round"])
        final["epoch_params_sha256"].append(_params_checksum(out[0]))
        final["held_rounds"] += sum(int(t.sum()) for t in self.epoch_fn.held_rounds)
        if heartbeat is not None:
            heartbeat.beat(epoch=final["epoch"], round=final["round"])
        if kill_round is not None and round_before <= kill_round < final["round"]:
            # die as a preempted slice dies: at once, before this epoch's
            # sidecar seals, so the fleet recovers from the other slices'
            if flight is not None:
                flight.note("kill-slice", slice=slice_id, round=final["round"])
                flight.dump(f"kill-slice:{slice_id}@round{kill_round}")
            os.kill(os.getpid(), signal.SIGKILL)
        if args.out_dir and args.slice_ckpt:
            # every site's state (a collective: every rank takes part), one
            # writer a slice
            full = gather_site_state(out[0], self.mesh)
            if my_ckpt_dir is not None:
                orig_ckpt(os.path.join(my_ckpt_dir, "checkpoint_latest.msgpack"), full,
                          meta={"round": final["round"], "epoch": final["epoch"],
                                "slice": slice_id, "params_sha256": _params_checksum(out[0])},
                          rotate=True)
        return out

    loop_mod.FederatedTrainer.run_epoch = record_run_epoch

    builds0 = _build.BUILDS + _build.LOADS
    lstm_cuda.LAUNCHES = lstm_cuda.BWD_LAUNCHES = poweriter_cuda.POWERITER_LAUNCHES = 0
    lstm_cuda.K1_CLUSTER_CALLS = lstm_cuda.K1_STREAM_CALLS = 0
    lstm_cuda.BWD_CLUSTER_CALLS = lstm_cuda.BWD_STREAM_CALLS = 0
    poweriter_cuda.POWERITER_STAGED_CALLS = poweriter_cuda.POWERITER_DIRECT_CALLS = 0
    lowrank.POWERITER_PLAIN_CLASSES = 0
    collectives.reset_collective_counts()
    t0 = time.perf_counter()
    res = None
    try:
        cfg = TrainConfig(task_id=args.task, epochs=args.epochs, validation_epochs=2,
                          patience=10, batch_size=args.batch_size,
                          split_ratio=(0.7, 0.15, 0.15), seed=0, num_slices=args.slices,
                          dcn_wire_quant=args.dcn_wire_quant).with_overrides(
            _config_overrides(args.overrides))
        runner = FedRunner(cfg, data_path=args.data_path, out_dir=args.out_dir,
                           fault_plan=fault_plan, device=args.device)
        res = runner.run(folds=[0], verbose=False, resume=args.resume)[0]
    except Preempted as p:
        if flight is not None:
            flight.note("preempted", signum=p.signum, epoch=p.epoch, slice=slice_id)
            flight.dump(f"signal:{p.signum}" if p.signum else "kill_at_round")
        write_pod_trace()  # a drained survivor's spans are the pod's evidence
        stop_plane()
        distributed_shutdown()
        return p.exit_code
    except Exception:
        # the group ends before the error propagates, so the peers' next
        # collective fails instead of waiting
        distributed_shutdown()
        if multi_run and args.slice_ckpt:
            # supervised: a peer's death fails this rank's collective at
            # once under gloo; wait for the drain, so that the supervisor
            # records the peer's death and not this collateral one
            _await_drain(args.heartbeat_timeout_s)
        stop_plane()
        raise
    finally:
        loop_mod.write_logs_json, loop_mod.save_checkpoint = orig_logs, orig_ckpt
        loop_mod.load_checkpoint = orig_load
        loop_mod.FederatedTrainer.run_epoch = orig_run_epoch
    fit_seconds = time.perf_counter() - t0
    mesh = runner.mesh
    world = 1 if mesh is None else mesh.world
    rank = 0 if mesh is None else mesh.rank
    if args.report:
        report = {
            "process_index": rank, "process_count": world, "multi": bool(multi),
            "backend": None if mesh is None else mesh.backend,
            "device": str(runner.device),
            "mesh_spans_processes": world > 1,
            "mesh_shape": None if mesh is None else mesh.shape,
            "mesh_axes": None if mesh is None else list(mesh.axis_names),
            "pack": None if mesh is None else mesh.pack,
            "num_slices": runner.num_slices, "slice_id": slice_id,
            "restart_generation": args.restart_generation,
            "epoch_losses": [float(x) for x in res["epoch_losses"]],
            "test_metrics": res["test_metrics"],
            "n_log_writes": writes["logs"], "n_ckpt_writes": writes["ckpt"],
            "params_sha256": (_params_checksum(final["state"])
                              if final["state"] is not None else None),
            "epoch_rounds": final["epoch_rounds"],
            "epoch_params_sha256": final["epoch_params_sha256"],
            "held_rounds": final["held_rounds"],
            # the fit's modeled inter-slice bytes a round (0.0 at one slice)
            "dcn_bytes_round": (final["trainer"]._dcn_bytes_round
                                if final["trainer"] is not None else 0.0),
            "epoch_collectives": final["epoch_collectives"],
            # the resume's checkpoint read, and this generation's first
            # heartbeat pulse (a slice lead's)
            "reload_ms": final["reload_ms"] if args.resume else None,
            "first_pulse_unix": None if heartbeat is None else heartbeat.started_unix,
            # kernel libraries built or loaded during the fit: the port's
            # counterpart of JAX's epoch compile count
            "epoch_compiles": _build.BUILDS + _build.LOADS - builds0,
            "fit_seconds": fit_seconds,
            # this rank's kernel launches (K1, K2, K7), their routes, and its
            # collectives (the inter-slice hops apart)
            "launches": {"lstm_fwd": lstm_cuda.LAUNCHES, "lstm_bwd": lstm_cuda.BWD_LAUNCHES,
                         "poweriter": poweriter_cuda.POWERITER_LAUNCHES},
            "routes": {"k1_cluster": lstm_cuda.K1_CLUSTER_CALLS,
                       "k1_stream": lstm_cuda.K1_STREAM_CALLS,
                       "k2_cluster": lstm_cuda.BWD_CLUSTER_CALLS,
                       "k2_stream": lstm_cuda.BWD_STREAM_CALLS,
                       "k7_staged": poweriter_cuda.POWERITER_STAGED_CALLS,
                       "k7_direct": poweriter_cuda.POWERITER_DIRECT_CALLS,
                       "poweriter_plain_classes": lowrank.POWERITER_PLAIN_CLASSES},
            "collectives": dict(collectives.COLLECTIVES),
        }
        with open(args.report, "w") as fh:
            json.dump(report, fh)
    write_pod_trace()
    stop_plane()
    distributed_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
