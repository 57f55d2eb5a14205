#!/usr/bin/env python3
"""K7's staged route on the flagship's r = 10 class and on its largest
bucket alone, for A/Bs between two trees in one call.

    python3 scripts/torch_k7_ab.py TAG [--stages 3,2,4]

It makes ``chip_smoke.py`` phase 7's gradients (32 sites, cold Ω, tol
1e-3, 5 refinements) and runs K7 on the whole class and on its largest
bucket alone (the 32 encoder members, one block an SM: what one block does
without a neighbour), f32 and bf16, on the geometry the launcher picks;
with ``--stages`` on rings of those stage counts instead (the launcher's
16 KB stages; a ring over half an SM runs one block an SM). Each point is
held against ``poweriter_plain`` (``k7_errors``), timed as device ms (20
calls back to back, median of 5, as ``torch_k1_sweep.py``) and read by the
phase clock (``k7_phase_profile``). One JSON line per point, tagged
``TAG``, then the card's name and power limit. Run it from the root of
each tree: ``cd parent && python3 scripts/torch_k7_ab.py parent``. It needs
one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("tag")
    ap.add_argument("--stages", default="", help="comma-separated ring sizes, e.g. 3,2,4")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    import chip_smoke as cs
    from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc
    from torch_k1_sweep import device_ms

    gen = torch.Generator(device="cuda").manual_seed(11)
    leaves = cs.k7_leaves(torch)[cs.K7_RANK]
    Gs = cs.k7_gradients(torch, leaves, gen)
    cold, _ = cs.k7_starts(torch, pc, leaves, Gs, cs.K7_RANK, gen)
    largest = max(range(len(Gs)), key=lambda k: Gs[k].shape[1] * Gs[k].shape[2])
    stages = [int(v) for v in args.stages.split(",") if v]
    for name, sub, oms in (("class", Gs, cold), ("largest", Gs[largest:largest + 1],
                                                 cold[largest:largest + 1])):
        for mm in (None, torch.bfloat16):
            base = cs.k7_geometry_line(pc, sub, cs.K7_RANK, mm)
            geos = [base] + [dict(base, stages=s, smem=pc.staged_smem_bytes(
                [tuple(G.shape[1:]) for G in sub], cs.K7_RANK, s)) for s in stages]
            for geo in geos[1:] if stages else geos:
                want = pc.poweriter_plain(sub, oms, cs.K7_ITERS, 1e-3, mm)
                got = pc.poweriter_fused(sub, oms, cs.K7_ITERS, 1e-3, mm, geometry=geo)
                err = cs.k7_errors(torch, sub, cs.K7_RANK, got, want)
                ms = device_ms(torch, lambda: pc.poweriter_fused(sub, oms, cs.K7_ITERS, 1e-3, mm,
                                                                 geometry=geo))
                phases = pc.k7_phase_profile(sub, oms, cs.K7_ITERS, 1e-3, mm, geometry=geo)
                print(json.dumps({
                    "tree": args.tag, "set": name, "dtype": "bf16" if mm else "f32",
                    "stages": geo["stages"], "smem": geo["smem"],
                    "blocks_per_sm": pc.k7_max_active_blocks("cuda", cs.K7_RANK, geo["smem"], mm),
                    "device_ms": ms, "P": err["P"], "Q": err["Q"], "PQ": err["PQ"],
                    "trips_differ": err["trips_differ"], "phases": phases}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
