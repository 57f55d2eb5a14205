#!/usr/bin/env python3
"""Where a serving dispatch's time goes on the card, for the PyTorch/CUDA
port at full ICA-LSTM width.

    python3 scripts/torch_serving_profile.py [--dispatches 20]

For each row bucket it sends requests one at a time (one request a
dispatch, no queueing) and prints the host-clock latency. Then it runs
``--dispatches`` dispatches of the largest bucket under ``torch.profiler``
and prints device time by kernel name and the device's busy and idle
share of that window. Every line is one JSON object; it needs one CUDA
card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
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
    ap.add_argument("--dispatches", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from dinunet_implementations_tpu_torch import InferenceEngine
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    with InferenceEngine(cfg, state_dict=build_model(cfg).state_dict()) as eng:
        eng.warmup()
        for b in eng.row_buckets:
            x = rng.standard_normal((b,) + eng.sample_shape).astype(np.float32)
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                eng.submit(x).result(timeout=60)
                lat.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"bucket": b, "unloaded_latency_ms_p50": statistics.median(lat),
                              "min_ms": min(lat), "card": smi}))

        b = eng.row_buckets[-1]
        x = rng.standard_normal((b,) + eng.sample_shape).astype(np.float32)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.dispatches):
                eng.submit(x).result(timeout=60)
            window_us = (time.perf_counter() - t0) * 1e6

    by_name = defaultdict(float)
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, t in sorted(spans):  # union of device intervals
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "bucket": b, "dispatches": args.dispatches, "window_ms": window_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1 - busy / window_us) if spans else None,
        "device_ms_per_dispatch_by_kernel": {
            n: us / 1e3 / args.dispatches for n, us in top},
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
