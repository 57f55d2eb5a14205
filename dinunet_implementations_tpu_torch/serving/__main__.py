"""The serving CLI: an :class:`~.engine.InferenceEngine` (or a
:class:`~.fleet.ReplicaSet`) over a trained checkpoint, driven by a
scripted or synthetic mix of batched and streaming requests. The port's
counterpart of the JAX package's ``serving/__main__.py``, on the card
unless ``--device cpu`` is given.

    # train something first, then serve its best checkpoint with 100 mixed
    # requests
    python -m dinunet_implementations_tpu_torch.runner.cli --data-path tree \\
        --epochs 3 --out-dir out
    python -m dinunet_implementations_tpu_torch.serving --data-path tree \\
        --out-dir out --smoke 100 --sanitize compile

The checkpoint is in the JAX package's file format, so one that either
package wrote serves here. Request payloads come from the tree's fold-0
test split (the rows the trainer evaluated), so the served numbers are
comparable with the trainer's eval. ``--script FILE`` replays a JSONL
request script instead of the synthetic mix; each line is one op:

    {"op": "infer", "n": 3, "rows": 2}     # 3 requests of 2 samples each
    {"op": "stream", "session": "s0", "windows": 4}
    {"op": "drain"}                        # wait for every future so far
    {"op": "close_session", "session": "s0"}
    {"op": "swap", "checkpoint": "PATH"}   # publish a candidate
    {"op": "rollback_check"}               # one SLO-burn probation verdict
    {"op": "kill_replica", "slot": 0}      # a fleet fault drill (--replicas > 1)

``--replicas N`` (N > 1) serves through a ``ReplicaSet``: the same ops,
sessions routed by id, the series and rows labelled by ``replica``, and the
fleet's rollup. ``swap`` and ``rollback_check`` drive a
:class:`~.publish.PublishController` against whichever target is live.

Telemetry is always on here (a serving run with no latency record is no
evidence): ``manifest.json``, ``metrics.jsonl`` (a row a dispatch, the
publish and rollback rows, the ``serve_summary`` row with p50/p95/p99
latency, pad waste and bucket hit rate) and the trace files under
``<out-dir>/telemetry/serving``, checked by ``telemetry.report
--validate``; a flight recorder over the process's bus dumps
``flight_<pid>.json`` into ``<out-dir>`` on SIGTERM or an unhandled
exception; ``--statusz-port`` serves ``/metrics``, ``/healthz``,
``/statusz`` (with the SLO burn of the request latency against
``--slo-p99-ms``) and ``/tracez``. ``--compile-cache DIR`` is the kernel
libraries' root (``ops/_build.enable_compile_cache``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    """JAX's flags and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m dinunet_implementations_tpu_torch.serving",
        description="Continuously batched inference over a trained checkpoint on one CUDA "
                    "card.")
    p.add_argument("--data-path", required=True,
                   help="dataset tree (simulator layout): the request payloads come from its "
                        "test split")
    p.add_argument("--task", default=None,
                   help="task id (default: TrainConfig/inputspec default)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to serve (default: the fold-0 best checkpoint under "
                        "--out-dir)")
    p.add_argument("--out-dir", default=None,
                   help="output root (default <data-path>/output); the serving telemetry "
                        "lands under <out-dir>/telemetry/serving")
    p.add_argument("--script", default=None, metavar="FILE",
                   help="JSONL request script (see the module docstring)")
    p.add_argument("--smoke", type=int, default=None, metavar="N",
                   help="synthetic mixed workload: N requests across the batched and (where "
                        "the checkpoint streams) the streaming lane")
    p.add_argument("--row-buckets", default="1,2,4,8,16",
                   help="the batched lane's row capacities")
    p.add_argument("--stream-buckets", default="1,4",
                   help="the streaming lane's session counts")
    p.add_argument("--stream-chunk", type=int, default=8,
                   help="windows a streaming chunk")
    p.add_argument("--stream-slots", type=int, default=32,
                   help="the session table's capacity (LRU-evicted)")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="admission: the longest wait before a partial bucket dispatches")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="serve through a ReplicaSet of N engines (sessions routed by id, "
                        "supervised restarts); 1 = one engine (default)")
    p.add_argument("--max-queue", type=int, default=None, metavar="N",
                   help="admission: shed new requests once a lane's queue holds N (default "
                        "unbounded)")
    p.add_argument("--rollback-burn", type=float, default=1.0, metavar="BURN",
                   help="the SLO error-budget burn above which a rollback_check swaps back "
                        "(1.0 = the whole budget)")
    p.add_argument("--rollback-window", type=int, default=20, metavar="N",
                   help="the fewest latency samples after a swap before a rollback_check "
                        "gives a verdict")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build the kernel libraries into and load them from DIR: a later run "
                        "loads what an earlier one built there")
    p.add_argument("--statusz-port", type=int, default=None, metavar="PORT",
                   help="the live endpoints on 127.0.0.1:PORT: /metrics (Prometheus), "
                        "/healthz, /statusz (with the SLO burn over the request latency), "
                        "/tracez; 0 picks a free port, printed at start")
    p.add_argument("--slo-p99-ms", type=float, default=50.0, metavar="MS",
                   help="the p99 latency target of the SLO burn (default 50 ms)")
    p.add_argument("--linger-s", type=float, default=0.0, metavar="S",
                   help="keep the process (and the --statusz-port endpoints) up this many "
                        "seconds after the script: a window to scrape in")
    p.add_argument("--sanitize", nargs="?", const="1", default=None, metavar="FLAGS",
                   help="runtime sanitizer flags (checks/sanitize.py); the engine's check "
                        "that nothing builds or loads after warmup runs regardless")
    p.add_argument("--device", default=None,
                   help="where to serve: the CUDA card by default, 'cpu' to serve on the CPU")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override any TrainConfig / task-args field (as the training run did, "
                        "so the model rebuilds the same)")
    p.add_argument("--quiet", action="store_true")
    return p


def default_checkpoint(out_dir: str, task_id: str) -> str:
    """The fold-0 best checkpoint the trainer writes, without making any
    directory."""
    return os.path.join(out_dir, "remote", "simulatorRun", task_id, "fold_0",
                        "checkpoint_best.msgpack")


def smoke_script(n: int, streaming: bool) -> list[dict]:
    """A deterministic mix: about 2/3 batched requests over a cycle of row
    counts (every bucket gets traffic), 1/3 streaming chunks over a few
    long-lived sessions, drained at the end."""
    ops = []
    rows_cycle = (1, 2, 3, 4, 8)
    for i in range(n):
        if streaming and i % 3 == 2:
            ops.append({"op": "stream", "session": f"smoke-{(i // 3) % 4}",
                        "windows": 2 + (i % 3)})
        else:
            ops.append({"op": "infer", "n": 1, "rows": rows_cycle[i % len(rows_cycle)]})
    ops.append({"op": "drain"})
    return ops


class _Pool:
    """A cycling pool of request payloads over the tree's test split."""

    def __init__(self, sites):
        self.inputs = np.concatenate([s.inputs for s in sites if len(s)])
        self._at = 0

    def take(self, n: int) -> np.ndarray:
        ix = [(self._at + i) % len(self.inputs) for i in range(n)]
        self._at = (self._at + n) % len(self.inputs)
        return self.inputs[ix]


def run_script(engine, ops: list[dict], pool: _Pool, verbose: bool, publisher=None) -> int:
    """Run a request script; returns the number of requests fired. The
    futures are resolved at each drain and at the end, so a dispatch error
    fails the CLI instead of losing a request. ``publisher`` (a
    :class:`~.publish.PublishController`) runs the ``swap`` and
    ``rollback_check`` ops."""
    futures = []
    stream_pos: dict[str, int] = {}
    fired = 0

    def drain():
        engine.drain()
        while futures:
            futures.pop().result()

    for op in ops:
        kind = op.get("op")
        if kind == "infer":
            for _ in range(int(op.get("n", 1))):
                futures.append(engine.submit(pool.take(int(op.get("rows", 1))),
                                             trace_id=op.get("trace_id")))
                fired += 1
        elif kind == "stream":
            sid = str(op.get("session", "s0"))
            t = int(op.get("windows", 1))
            seq = pool.take(1)[0]  # [S, C, W]: one subject's run of windows
            pos = stream_pos.get(sid, 0)
            chunk = np.take(seq, [(pos + j) % seq.shape[0] for j in range(t)], axis=0)
            stream_pos[sid] = pos + t
            futures.append(engine.stream(sid, chunk, trace_id=op.get("trace_id")))
            fired += 1
        elif kind == "drain":
            drain()
        elif kind == "close_session":
            engine.close_session(str(op["session"]))
        elif kind == "swap":
            if publisher is None:
                raise SystemExit("the swap op needs the publish controller (main wires it)")
            from ..trainer.checkpoint import load_inference_state, params_digest

            drain()  # the requests in flight finish on the weights they saw
            params, stats, _ = load_inference_state(str(op["checkpoint"]))
            row = publisher.publish(params, stats,
                                    digest=op.get("digest") or params_digest(params, stats))
            if verbose:
                print(json.dumps(row, default=str))
        elif kind == "rollback_check":
            if publisher is None:
                raise SystemExit("the rollback_check op needs the publish controller (main "
                                 "wires it)")
            drain()
            row = publisher.check_rollback()
            if verbose:
                print(json.dumps(row, default=str))
        elif kind == "kill_replica":
            if not hasattr(engine, "kill_replica"):
                raise SystemExit("the kill_replica op needs --replicas > 1")
            drain()
            slot = int(op.get("slot", 0))
            want = engine.restarts + 1
            engine.kill_replica(slot)
            if op.get("wait_restart", True):
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    if engine.restarts >= want and engine._replica_alive(slot):
                        break
                    time.sleep(0.02)
                else:
                    raise SystemExit(f"replica {slot} did not restart within 60 s")
        else:
            raise SystemExit(f"unknown script op {op!r}")
    drain()
    if verbose:
        print(json.dumps({"requests_fired": fired}))
    return fired


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if (args.script is None) == (args.smoke is None):
        raise SystemExit("exactly one of --script or --smoke is required")
    if args.sanitize is not None:
        from ..checks.sanitize import ENV_VAR, sanitize_flags

        try:
            sanitize_flags(args.sanitize)
        except ValueError as e:
            raise SystemExit(f"--sanitize: {e}")
        os.environ[ENV_VAR] = args.sanitize

    from ..checks.sanitize import SanitizerViolation
    from ..core.config import TrainConfig, resolve_site_configs
    from ..core.device import resolve_device
    from ..runner.cli import _parse_set
    from ..runner.fed_runner import discover_site_dirs, load_site_splits
    from ..telemetry.bus import global_bus
    from ..telemetry.flight import FlightRecorder
    from ..telemetry.sink import FitTelemetry, _finite
    from ..telemetry.tracer import SpanTracer
    from .engine import InferenceEngine
    from .fleet import ReplicaSet
    from .publish import PublishController

    device = resolve_device(args.device)  # the card unless --device cpu; raises without one
    overrides = _parse_set(args.overrides)
    if args.task is not None:
        overrides["task_id"] = args.task
    if args.compile_cache is not None:
        overrides["compile_cache_dir"] = args.compile_cache
    site_dirs = discover_site_dirs(args.data_path)
    site_cfgs = resolve_site_configs(TrainConfig().with_overrides(overrides), args.data_path,
                                     num_sites=len(site_dirs))
    cfg = site_cfgs[0]
    out_dir = args.out_dir or os.path.join(args.data_path, "output")
    ckpt = args.checkpoint or default_checkpoint(out_dir, cfg.task_id)
    if not (os.path.exists(ckpt) or os.path.exists(ckpt + ".prev")):
        raise SystemExit(f"no checkpoint at {ckpt}: train first (python -m "
                         f"dinunet_implementations_tpu_torch.runner.cli --data-path "
                         f"{args.data_path} --out-dir {out_dir}) or pass --checkpoint")

    # the request payloads: the tree's fold-0 test split
    pool = _Pool(load_site_splits(cfg, site_dirs, site_cfgs)[0]["test"])

    tracer = SpanTracer()
    sink = FitTelemetry.open(os.path.join(out_dir, "telemetry", "serving"), cfg, fold=0,
                             tracer=tracer, device=device)
    # the process's bus and a flight recorder over it, which dumps the final
    # spans and a bus snapshot on SIGTERM or an unhandled exception (no
    # preemption guard owns the signal here)
    bus = global_bus()
    flight = FlightRecorder(out_dir, bus=bus, tracer=tracer)
    flight.install()
    lane_kwargs = dict(row_buckets=[int(b) for b in args.row_buckets.split(",")],
                       stream_buckets=[int(b) for b in args.stream_buckets.split(",")],
                       stream_chunk=args.stream_chunk, stream_slots=args.stream_slots,
                       max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
                       tracer=tracer, sink=sink, bus=bus)
    if args.replicas > 1:
        engine = ReplicaSet(cfg, replicas=args.replicas, checkpoint=ckpt,
                            devices=[device] if args.device is not None else None,
                            **lane_kwargs)
    else:
        engine = InferenceEngine(cfg, checkpoint=ckpt, device=device, **lane_kwargs)
    publisher = PublishController(engine, bus=bus, sink=sink, p99_target_ms=args.slo_p99_ms,
                                  rollback_burn=args.rollback_burn,
                                  min_window_samples=args.rollback_window)
    exporter = None
    if args.statusz_port is not None:
        from ..telemetry.exporter import ENDPOINTS, StatusExporter

        exporter = StatusExporter(
            bus, port=args.statusz_port, tracer=tracer, flight=flight,
            health=engine.health_probes(), statusz=engine.status,
            slo={"histogram": "serving_request_latency_ms", "p99_target_ms": args.slo_p99_ms})
        port = exporter.start()
        if not args.quiet:
            print(json.dumps({"statusz": f"http://127.0.0.1:{port}", "endpoints": ENDPOINTS}),
                  flush=True)
    try:
        warm = engine.warmup()
        if not args.quiet:
            print(json.dumps({"warmup_seconds": engine.warmup_seconds, "executables": warm,
                              "streaming": engine.streaming, "checkpoint": ckpt,
                              "replicas": args.replicas, "device": str(device)}))
        if args.script is not None:
            with open(args.script) as fh:
                ops = [json.loads(ln) for ln in fh if ln.strip()]
        else:
            ops = smoke_script(args.smoke, engine.streaming)
        run_script(engine, ops, pool, verbose=not args.quiet, publisher=publisher)
        if args.linger_s:
            time.sleep(args.linger_s)
        summary = engine.close()
    except SanitizerViolation as v:
        flight.dump("sanitizer-violation")
        print(json.dumps({"sanitizer_violation": str(v)}), file=sys.stderr)
        return 70
    finally:
        # on a failure the hooks stay: an exception that unwinds past here
        # still dumps the ring
        if exporter is not None:
            exporter.stop()
    flight.uninstall()
    print(json.dumps(_finite(summary), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
