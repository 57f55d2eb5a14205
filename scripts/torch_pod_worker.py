"""One supervised slice worker: a rankDAD port fit of the ICA task on the card,
with the files a ``SliceSupervisor`` and the pod plane read. ``chip_smoke.py``
phase 23 runs it under a supervisor (and once alone, uninterrupted, for the
digest it is held to).

    python3 scripts/torch_pod_worker.py --data-path TREE --out-dir POD \\
        --generation G [--resume] [--kill-epoch E] [--epochs N] [--pod-trace ID] \\
        [--result PATH]

The worker

- starts a ``Heartbeat`` (``<pod>/heartbeats/slice_0.json``) that
  advertises its ``StatusExporter`` port (``beat(statusz_port=...)``) and,
  after each epoch, the epoch and round;
- runs ``FedRunner`` (``--resume`` continues from the fold's checkpoint)
  with every epoch in a ``worker-epoch`` span carrying ``--pod-trace``,
  written after each epoch to ``<pod>/pod_trace/worker_gen<G>.jsonl``
  (with the tracer's ``clock_sync`` row);
- after each epoch rotates a slice checkpoint,
  ``<pod>/slices/slice_0/checkpoint_latest.msgpack``, whose meta carries
  ``round``, ``epoch``, ``slice`` and ``params_sha256`` (the state's
  ``params_digest``);
- with ``--kill-epoch E`` (generation 1 only) SIGKILLs itself in the middle
  of epoch E: in the aggregation of its round R // 2 (the first when R < 4)
  of R, once the kernel counts are written down;
- writes ``--result`` (JSON) as it goes: its kernel launches by route (K1,
  K2, K7, the plain classes) in total and by epoch, the first pulse's wall
  time, the resume's reload ms, and at the end the final params digest. A
  killed generation's file holds what it wrote before the kill.

Runs on the card, with the kernels built under the checkout
(``ops/_build.build_all``).
"""

import argparse
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launches(lc, pc, lowrank) -> dict:
    """K1, K2 and K7 launches and their routes, and the rank classes sent
    to the plain power iteration."""
    return {"lstm_fwd": lc.LAUNCHES, "k1_cluster_route": lc.K1_CLUSTER_CALLS,
            "k1_stream_route": lc.K1_STREAM_CALLS, "lstm_bwd": lc.BWD_LAUNCHES,
            "k2_cluster_route": lc.BWD_CLUSTER_CALLS, "k2_stream_route": lc.BWD_STREAM_CALLS,
            "poweriter": pc.POWERITER_LAUNCHES, "k7_staged_route": pc.POWERITER_STAGED_CALLS,
            "k7_direct_route": pc.POWERITER_DIRECT_CALLS,
            "poweriter_plain_classes": lowrank.POWERITER_PLAIN_CLASSES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-path", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--generation", type=int, required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--kill-epoch", type=int, default=None)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--pod-trace", default=None)
    p.add_argument("--result", default=None)
    args = p.parse_args(argv)

    from dinunet_implementations_tpu_torch.runner.supervisor import (
        Heartbeat,
        heartbeat_path,
        slice_ckpt_dir,
    )

    hb = Heartbeat(heartbeat_path(args.out_dir, 0), 0, interval_s=0.5).start()
    first_pulse_unix = time.time()

    import torch

    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.engines import lowrank
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc
    from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc
    from dinunet_implementations_tpu_torch.runner import FedRunner
    from dinunet_implementations_tpu_torch.telemetry import MetricsBus, SpanTracer, StatusExporter
    from dinunet_implementations_tpu_torch.trainer import checkpoint as ckpt
    from dinunet_implementations_tpu_torch.trainer import loop

    out = {"generation": args.generation, "pid": os.getpid(),
           "first_pulse_unix": first_pulse_unix, "epochs": [], "reload_ms": None,
           "killed": None, "digest": None}
    progress = {"epoch": None, "round": None}

    def record():
        if args.result:
            out["launches"] = launches(lc, pc, lowrank)
            tmp = args.result + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(out, fh)
            os.replace(tmp, args.result)

    bus, tracer = MetricsBus(), SpanTracer()
    exporter = StatusExporter(bus, tracer=tracer, statusz=lambda: {
        "mode": "worker", "slice": 0, "generation": args.generation,
        "started_unix": hb.started_unix, **progress})
    hb.beat(statusz_port=exporter.start(), process=0)
    trace_path = os.path.join(args.out_dir, "pod_trace", f"worker_gen{args.generation}.jsonl")
    sidecar = os.path.join(slice_ckpt_dir(args.out_dir, 0), "checkpoint_latest.msgpack")

    load = loop.load_checkpoint

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        got = load(*a, **k)
        if out["reload_ms"] is None:  # the resume point, before the best state
            out["reload_ms"] = (time.perf_counter() - t0) * 1e3
        return got

    loop.load_checkpoint = timed_load
    run_epoch = loop.FederatedTrainer.run_epoch

    def supervised_epoch(self, state, train_sites, epoch, *a, **k):
        before = launches(lc, pc, lowrank)
        if args.kill_epoch == epoch and args.generation == 1 and out["epochs"]:
            rounds = out["epochs"][-1]["rounds"]
            at = max(rounds // 2, 1)
            aggregate, calls = self.engine.aggregate, [0]

            def killing_aggregate(*aa, **kk):
                calls[0] += 1
                if calls[0] == at:
                    torch.cuda.synchronize()
                    now = launches(lc, pc, lowrank)
                    out["killed"] = {"epoch": epoch, "round_in_epoch": at, "rounds": rounds,
                                     "kill_unix": time.time(),
                                     "in_epoch": {n: now[n] - before[n] for n in now}}
                    record()
                    os.kill(os.getpid(), signal.SIGKILL)
                return aggregate(*aa, **kk)

            # the engine is a frozen dataclass; the epoch looks its
            # aggregate up on it every round
            object.__setattr__(self.engine, "aggregate", killing_aggregate)
        with tracer.span("worker-epoch", epoch=epoch, generation=args.generation,
                         trace=args.pod_trace):
            state, losses = run_epoch(self, state, train_sites, epoch, *a, **k)
        torch.cuda.synchronize()
        now = launches(lc, pc, lowrank)
        rnd = int(state.round)
        progress.update(epoch=epoch, round=rnd)
        with tracer.span("slice-checkpoint", epoch=epoch, trace=args.pod_trace):
            ckpt.save_checkpoint(sidecar, state, rotate=True, meta={
                "round": rnd, "epoch": epoch, "slice": 0,
                "params_sha256": ckpt.params_digest(state.params, state.batch_stats)})
        hb.beat(epoch=epoch, round=rnd)
        bus.gauge("worker_epoch", epoch)
        bus.gauge("worker_round", rnd)
        out["epochs"].append({"epoch": epoch, "round": rnd, "rounds": len(losses),
                              "launches": {n: now[n] - before[n] for n in now}})
        tracer.write_jsonl(trace_path)
        record()
        return state, losses

    loop.FederatedTrainer.run_epoch = supervised_epoch
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)
    runner = FedRunner(cfg, args.data_path, args.out_dir, bus=bus, epochs=args.epochs,
                       agg_engine="rankDAD")
    try:
        res = runner.run(folds=[0], verbose=False, resume=args.resume)[0]
        torch.cuda.synchronize()
        out["digest"] = ckpt.params_digest(res["state"].params, res["state"].batch_stats)
        out["epoch_losses"] = res["epoch_losses"]
        record()
    finally:
        tracer.write_jsonl(trace_path)
        exporter.stop()
        hb.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
