"""The multi-process worker: the port of the JAX package's
``runner/dcn_worker.py`` at one slice.

Each invocation joins a process group as ONE rank of ``--num-processes``
(parallel/distributed.py ``distributed_init``) and trains the shared
federated fit (``FedRunner`` with ``mesh="auto"``: the site mesh over the
group, ``K = S / W`` sites a rank). Every rank computes the same
replicated update; only rank 0 writes logs and checkpoints. A launch, one
process a rank::

    python -m dinunet_implementations_tpu_torch.runner.dcn_worker \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id $RANK \\
        --data-path /data/tree --out-dir /shared/out --report rep.json

The backend follows ``--device`` (nccl on the card, gloo on the CPU)
unless ``--backend`` names one; several ranks on one card run gloo. A rank
with no ``--device`` runs on its card under either backend, and on the
CPU only when ``--device cpu`` says so. ``--report PATH`` writes one
JSON record of this rank (each rank passes its own path): the mesh, the
per-epoch losses, the test metrics, the params checksum (equal on every
rank of a correct run), the kernel libraries built or loaded, the fit's
seconds, the rank's K1, K2 and K7 launches, its collectives and its write
counts.

Exit codes (every failure path calls ``distributed_shutdown()`` first, so
a dead peer becomes a nonzero exit, not a hang):

- ``0``: the run completed;
- ``2``: an argument is refused: a ``--faults`` plan that does not parse,
  or ``--slices`` above 1 and ``--supervise`` (ROADMAP A11 (b));
- ``66`` (:data:`UNSUPPORTED_RC`): the backend cannot run here (gloo or
  nccl missing from this torch build, nccl with no card);
- ``128 + signum`` / ``75``: cooperative preemption after the rotating
  checkpoint (robustness/preemption.py ``Preempted.exit_code``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
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
    p.add_argument("--out-dir", default=None, help="shared output dir (rank 0 writes)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the run-report JSON here")
    p.add_argument("--slices", type=int, default=1,
                   help="slices of the site mesh: 1 (more are ROADMAP A11 (b))")
    p.add_argument("--supervise", action="store_true",
                   help="run as the fleet supervisor (ROADMAP A11 (b))")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--task", default="FS-Classification")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--faults", default=None, metavar="JSON|@FILE",
                   help="deterministic FaultPlan (robustness/faults.py) of site windows")
    p.add_argument("--resume", action="store_true",
                   help="continue from the last rotating checkpoint")
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


def _params_checksum(state) -> str:
    """A digest of the replicated params in ``state_dict`` order: every rank
    of a correct run reports the same hex."""
    import numpy as np

    h = hashlib.sha256()
    for v in state.params.values():
        h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes())
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


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.supervise:
        print("--supervise (the fleet supervisor over slices) is not ported: ROADMAP A11 (b)",
              file=sys.stderr)
        return 2
    if args.slices != 1:
        print(f"--slices {args.slices} is not ported: ROADMAP A11 (b)", file=sys.stderr)
        return 2

    from ..parallel.distributed import default_backend, distributed_init, distributed_shutdown
    from ..robustness.faults import parse_fault_plan
    from ..robustness.preemption import Preempted

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
    multi = distributed_init(coordinator_address=args.coordinator,
                             num_processes=args.num_processes, process_id=args.process_id,
                             backend=backend, device=args.device)

    from .. import TrainConfig
    from ..ops import _build
    from ..trainer import loop as loop_mod
    from .fed_runner import FedRunner

    writes = {"logs": 0, "ckpt": 0}
    orig_logs, orig_ckpt = loop_mod.write_logs_json, loop_mod.save_checkpoint

    def count_logs(*a, **k):
        writes["logs"] += 1
        return orig_logs(*a, **k)

    def count_ckpt(*a, **k):
        writes["ckpt"] += 1
        return orig_ckpt(*a, **k)

    loop_mod.write_logs_json, loop_mod.save_checkpoint = count_logs, count_ckpt
    final = {"state": None}
    orig_run_epoch = loop_mod.FederatedTrainer.run_epoch

    def record_run_epoch(self, state, *a, **k):
        out = orig_run_epoch(self, state, *a, **k)
        final["state"] = out[0]
        return out

    loop_mod.FederatedTrainer.run_epoch = record_run_epoch
    from ..ops import lstm_cuda, poweriter_cuda
    from ..parallel import collectives

    builds0 = _build.BUILDS + _build.LOADS
    lstm_cuda.LAUNCHES = lstm_cuda.BWD_LAUNCHES = poweriter_cuda.POWERITER_LAUNCHES = 0
    collectives.reset_collective_counts()
    t0 = time.perf_counter()
    res = None
    try:
        cfg = TrainConfig(task_id=args.task, epochs=args.epochs, validation_epochs=2,
                          patience=10, batch_size=args.batch_size,
                          split_ratio=(0.7, 0.15, 0.15), seed=0).with_overrides(
            _config_overrides(args.overrides))
        runner = FedRunner(cfg, data_path=args.data_path, out_dir=args.out_dir,
                           fault_plan=fault_plan, device=args.device)
        res = runner.run(folds=[0], verbose=False, resume=args.resume)[0]
    except Preempted as p:
        distributed_shutdown()
        return p.exit_code
    finally:
        loop_mod.write_logs_json, loop_mod.save_checkpoint = orig_logs, orig_ckpt
        loop_mod.FederatedTrainer.run_epoch = orig_run_epoch
        if res is None:
            # any other failure: the group ends before the error propagates,
            # so the peers' next collective fails instead of waiting
            distributed_shutdown()
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
            "pack": None if mesh is None else mesh.pack,
            "num_slices": args.slices,
            "epoch_losses": [float(x) for x in res["epoch_losses"]],
            "test_metrics": res["test_metrics"],
            "n_log_writes": writes["logs"], "n_ckpt_writes": writes["ckpt"],
            "params_sha256": (_params_checksum(final["state"])
                              if final["state"] is not None else None),
            # kernel libraries built or loaded during the fit: the port's
            # counterpart of JAX's epoch compile count
            "epoch_compiles": _build.BUILDS + _build.LOADS - builds0,
            "fit_seconds": fit_seconds,
            # this rank's kernel launches (K1, K2, K7) and collectives
            "launches": {"lstm_fwd": lstm_cuda.LAUNCHES, "lstm_bwd": lstm_cuda.BWD_LAUNCHES,
                         "poweriter": poweriter_cuda.POWERITER_LAUNCHES},
            "collectives": dict(collectives.COLLECTIVES),
        }
        with open(args.report, "w") as fh:
            json.dump(report, fh)
    distributed_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
