#!/usr/bin/env python3
"""Where one aggregation round's time goes on the card, engine by engine,
for the PyTorch/CUDA port at full ICA-LSTM width.

    python3 scripts/torch_engine_profile.py [--engines dSGD rankDAD powerSGD] [--calls 20]

For each engine it builds chip_smoke.py's training configuration (default
``ICAArgs``, f32, 32 sites), makes one round's per-site gradients ``[32,
...]`` from a seed, and calls ``engine.aggregate`` on them:

- ``host_ms``: the host's time a call, ``--calls`` calls back to back with
  no synchronize between them (what the round loop pays on the host);
- ``device_ms``: CUDA events around the same calls, over the count;
- ``syncs``: the calls that synchronized the host with the card in one
  call under ``torch.cuda.set_sync_debug_mode("warn")``, by message;
- ``ops``: the CPU-side operators of one call under ``torch.profiler``,
  their count and host µs by name (the top 12), and the kernel launches.

Every line is one JSON object with the card's name and power limit; it
needs one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter, defaultdict


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--engines", nargs="+", default=["dSGD", "rankDAD", "powerSGD"])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for name in args.engines:
        cfg, _, state = chip_smoke.training_setup(torch, use_kernel=True, engine=name)
        from dinunet_implementations_tpu_torch.runner.registry import build_engine

        engine = build_engine(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        S = cfg.num_sites
        grads = {k: 1e-2 * torch.randn((S,) + tuple(v.shape), generator=gen, device="cuda")
                 for k, v in state.params.items()}
        weight = torch.full((S,), float(cfg.batch_size), device="cuda")
        es = state.engine_state
        for _ in range(3):  # warm-up: workspaces, handles, the kernels' first launch
            engine.aggregate(grads, es, weight)
        torch.cuda.synchronize()

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.calls):
            engine.aggregate(grads, es, weight)
        host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / args.calls

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                engine.aggregate(grads, es, weight)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = Counter(str(w.message).splitlines()[0] for w in caught
                        if "is a prototype feature" not in str(w.message))

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            engine.aggregate(grads, es, weight)
            torch.cuda.synchronize()
        count, cpu_us, launches = Counter(), defaultdict(float), 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                launches += 1
            elif e.name.startswith("aten::") and e.cpu_parent is None:
                count[e.name] += 1
                cpu_us[e.name] += e.cpu_time_total
        top = sorted(cpu_us.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "engine": name, "sites": S, "calls": args.calls, "host_ms": host_ms,
            "device_ms": device_ms, "syncs": dict(syncs), "sync_count": sum(syncs.values()),
            "top_level_ops": sum(count.values()), "kernel_launches": launches,
            "ops_host_us": {k: [count[k], v] for k, v in top}, "card": smi,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
