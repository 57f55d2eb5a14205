#!/usr/bin/env python3
"""Where a federated training round's time goes on the card, for the
PyTorch/CUDA port at full ICA-LSTM width.

    python3 scripts/torch_train_profile.py [--epochs 2] [--engine dSGD|rankDAD|powerSGD]
                                           [--fused-bidir] [--robust-agg MODE]
                                           [--faults] [--attacks]

It builds the configuration of chip_smoke.py's training phases (default
``ICAArgs``, f32, 32 sites of 2-4 batches of 16, Adam 1e-3, the dSGD, the
rankDAD or the powerSGD engine with its default knobs; with
``--fused-bidir`` the model is ``ICALstm(fused_bidir=True)``, whose BiLSTM
runs K5 and K6; with ``--robust-agg`` the engine's robust mode and the
reputation layer, with ``--faults`` / ``--attacks`` chip_smoke.py phase
17's ``FaultPlan`` / ``AttackPlan`` on the epoch's first window), runs one
epoch to warm up, times ``--epochs`` epochs on the host clock, then runs one
epoch under ``torch.profiler`` and prints device time per round by kernel
name, the device's busy and idle share of that window, the host's time in
the CUDA runtime's calls by name (launches, allocations, synchronizations)
and the caching allocator's device allocations, frees and retries over the
timed epochs, and the host's operators by their own time. Every line is
one JSON object; it needs one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--engine", choices=("dSGD", "rankDAD", "powerSGD"), default="dSGD")
    ap.add_argument("--fused-bidir", action="store_true")
    ap.add_argument("--robust-agg", default="none",
                    choices=("none", "norm_clip", "trimmed_mean", "coordinate_median"))
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--attacks", action="store_true")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    hostile = args.robust_agg != "none" or args.faults or args.attacks
    if hostile:
        faults, attacks = chip_smoke.hostile_plans()
        faults, attacks = (faults if args.faults else None), (attacks if args.attacks else None)
        cfg, epoch, state = chip_smoke.hostile_setup(torch, True, args.engine, args.robust_agg,
                                                     attacks)
    else:
        cfg, epoch, state = chip_smoke.training_setup(torch, use_kernel=True, engine=args.engine,
                                                      fused_bidir=args.fused_bidir)
    arm = {"engine": args.engine, "fused_bidir": args.fused_bidir,
           "robust_agg": args.robust_agg, "faults": args.faults, "attacks": args.attacks}
    inv, plans = chip_smoke.training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = torch.from_numpy(plans[0]).cuda()
    rounds = plans[0].shape[1] // cfg.local_iterations
    samples = cfg.num_sites * plans[0].shape[1] * cfg.batch_size
    masks = chip_smoke.hostile_masks(np, faults, attacks, 0, rounds) if hostile else ()

    state, _ = epoch(state, inv_x, inv_y, idx, *masks)  # warm-up
    torch.cuda.synchronize()
    alloc_keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    before = torch.cuda.memory_stats()
    ms = []
    for _ in range(args.epochs):
        t0 = time.perf_counter()
        state, _ = epoch(state, inv_x, inv_y, idx, *masks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    after = torch.cuda.memory_stats()
    print(json.dumps({**arm, "epoch_ms": ms, "rounds": rounds, "samples_per_epoch": samples,
                      "samples_per_s": [samples / (m / 1e3) for m in ms],
                      "allocator": {k: after.get(k, 0) - before.get(k, 0) for k in alloc_keys},
                      "card": smi}))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = epoch(state, inv_x, inv_y, idx, *masks)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6

    by_name, runtime, runtime_n = defaultdict(float), defaultdict(float), defaultdict(int)
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):  # the runtime's calls, on the host
            runtime[e.name] += e.time_range.elapsed_us()
            runtime_n[e.name] += 1
    busy, end = 0.0, None
    for s, t in sorted(spans):  # union of device intervals
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    print(json.dumps({
        **arm, "rounds": rounds, "window_ms": window_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": (1 - busy / window_us) if spans else None,
        "device_ms_per_round_by_kernel": {n: us / 1e3 / rounds for n, us in top},
        "device_ms_per_round_all_kernels": sum(by_name.values()) / 1e3 / rounds,
        "host_runtime_ms_per_round": {n: [runtime_n[n] / rounds, us / 1e3 / rounds] for n, us in
                                      sorted(runtime.items(), key=lambda kv: -kv[1])[:8]},
        # [calls, own host ms] a round of the operators with the most own time
        "host_ops_per_round": {a.key: [a.count / rounds, a.self_cpu_time_total / 1e3 / rounds]
                               for a in sorted(prof.key_averages(),
                                               key=lambda a: -a.self_cpu_time_total)[:12]},
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
