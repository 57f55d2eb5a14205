"""The rankDAD power iteration at the multimodal model's full width on the
card (64 sites of batch 8, 19 leaves in the rank-10 class), as
``chip_smoke.py`` phase 16 drives it:

1. breakdowns: rankDAD epochs on the plain path (``use_kernel=False``),
   seeds 16 and 17, f32 and bf16, 3 epochs of 2 rounds, with the port's
   CholeskyQR (``engines/lowrank.py:_cholqr_once``: a member whose f32
   Cholesky breaks down takes its Gram again, accumulated in float64)
   and without that guard (the f32 cuBLAS Gram alone); the members whose
   f32 Cholesky broke down, those whose float64 Gram's did too, and the
   losses. For the first breakdowns: the shifted f32 Gram's smallest
   eigenvalue (float64), its Cholesky batched, member by member and by
   LAPACK on the CPU, the unrolled Cholesky–Banachiewicz (the form of
   K7's r x r chain), K7 and the port's plain loop on the stack from the
   same start; the iterates of the broken members are written to
   ``OUT/cholqr_breakdowns.npz``;
2. cost: one CholeskyQR round at ``[64, m, 10]`` with and without the
   guard (host ms, and device ms of 20 calls queued behind a sleep), and
   warm plain-path epochs with and without it;
3. K7 against plain, the first round from one start: per rank-10 stack,
   the largest error of Q (rankDAD's next Ω) over the leaf's max, its
   member's trips on each path, singular values and PQᵀ error.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_rankdad_probe.py [--out chiprun_out/rankdad_probe]

Prints the card's ``nvidia-smi`` name and power limit, one JSON line an
item, and writes ``OUT/probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dinunet_implementations_tpu_torch.core.device import resolve_device  # noqa: E402
from dinunet_implementations_tpu_torch.engines import lowrank  # noqa: E402
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc  # noqa: E402

MM = cs.A9_MM
SAVE_EVENTS = 12


def cholqr_once(guard: bool, events: list | None = None):
    """``lowrank._cholqr_once`` with (``guard``: the port's) or without the
    float64 Gram for a member whose f32 Cholesky breaks down; appends the
    round to ``events`` when a member's f32 Cholesky breaks down, with
    ``info64`` nonzero where the float64 Gram's broke down too."""
    def once(Y, shift):
        Yn, nc = lowrank._normalize_cols(Y)
        r = Yn.shape[-1]
        eye = torch.eye(r, dtype=Yn.dtype, device=Yn.device)

        def shifted(gram):
            tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
            return gram + (shift * tr + 1e-30)[..., None, None] * eye

        gram = shifted(Yn.mT @ Yn)
        chol, info = torch.linalg.cholesky_ex(gram)
        info64 = torch.zeros_like(info)
        if guard:
            Yd = Yn.double()
            chol64, info64 = torch.linalg.cholesky_ex(shifted((Yd.mT @ Yd).to(Yn.dtype)))
            chol = torch.where((info > 0)[..., None, None], chol64, chol)
            info64 = torch.where(info > 0, info64, torch.zeros_like(info64))
        if events is not None and bool((info > 0).any()):
            events.append({"shift": shift, "Y": Y, "gram": gram, "info": info, "info64": info64,
                           "stack": STACK[-1] if STACK else None})
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        return Yn @ linv.mT, nc
    return once


STACK: list = []
_plain_stack = pc._plain_stack


def tracked_plain_stack(G, om, *args):
    STACK.append((G, om))
    try:
        return _plain_stack(G, om, *args)
    finally:
        STACK.pop()


def epochs(seed: int, bf16: bool, use_kernel: bool, n: int) -> dict:
    cfg = cs.a9_cfg(MM, "rankDAD", bf16)
    inv_x, inv_y, idx = cs.a9_data(torch, cfg, seed=seed)
    epoch, state = cs.a9_training(torch, cfg, use_kernel)
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, lo = epoch(state, inv_x, inv_y, idx)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lo)
    return {"seed": seed, "dtype": "bf16" if bf16 else "f32", "use_kernel": use_kernel,
            "losses": torch.cat(losses).tolist(), "epoch_ms": ms,
            "params_finite": all(bool(v.isfinite().all()) for v in state.params.values())}


def unrolled_cholesky(g):
    r = g.shape[-1]
    L = torch.zeros_like(g)
    for j in range(r):
        s = g[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(-1)
        ljj = torch.sqrt(s)
        if j + 1 < r:
            L[..., j + 1:, j] = (g[..., j + 1:, j] - torch.einsum(
                "...ik,...k->...i", L[..., j + 1:, :j], L[..., j, :j])) / ljj[..., None]
        L[..., j, j] = ljj
    return L


def breakdown_record(e: dict) -> dict:
    gram, bad = e["gram"], (e["info"] > 0).nonzero().flatten().tolist()
    ev = torch.linalg.eigvalsh(gram.double().cpu())
    rec = {"shift": e["shift"], "m": e["Y"].shape[1], "members": e["Y"].shape[0], "broken": bad,
           "min_eig_broken": [ev[k, 0].item() for k in bad],
           "min_eig_median": ev[:, 0].median().item(),
           "broken_again_batched": (torch.linalg.cholesky_ex(gram)[1] > 0).nonzero()
           .flatten().tolist(),
           "info_member_by_member": [int(torch.linalg.cholesky_ex(gram[k])[1]) for k in bad],
           "broken_lapack_cpu": (torch.linalg.cholesky_ex(gram.cpu())[1] > 0).nonzero()
           .flatten().tolist(),
           "unrolled_nan": (~unrolled_cholesky(gram).isfinite().all(-1).all(-1)).nonzero()
           .flatten().tolist()}
    if e["stack"] is not None and e["stack"][0].shape[0] == e["Y"].shape[0]:
        G, om = e["stack"]
        P, Q, _ = pc.poweriter_fused(G, om.contiguous(), 5, 1e-3)
        rec["k7_stack_finite"] = bool(P.isfinite().all() and Q.isfinite().all())
        was, lowrank._cholqr_once = lowrank._cholqr_once, cholqr_once(True)
        try:
            Pg, _, _ = _plain_stack(G, om, 5, 1e-3, None)
        finally:
            lowrank._cholqr_once = was
        rec["guarded_plain_stack_finite"] = bool(Pg.isfinite().all())
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/rankdad_probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rankdad_probe: needs a CUDA card", file=sys.stderr)
        return 1
    resolve_device(None)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res: dict = {"card": smi}
    committed = lowrank._cholqr_once
    pc._plain_stack = tracked_plain_stack

    # 1. breakdowns on the plain path, with and without the guard
    runs, saved = [], []
    for guard in (True, False):
        for seed in (16, 17):
            for bf16 in (False, True):
                events: list = []
                lowrank._cholqr_once = cholqr_once(guard, events)
                r = epochs(seed, bf16, False, 3)
                r.update(guard=guard, f32_breakdowns=sum(int((e["info"] > 0).sum()) for e in events),
                         float64_breakdowns=sum(int((e["info64"] > 0).sum()) for e in events))
                if events and len(saved) < SAVE_EVENTS:
                    r["first"] = []
                    for e in events[:SAVE_EVENTS - len(saved)]:
                        r["first"].append(breakdown_record(e))
                        bad = (e["info"] > 0).nonzero().flatten()
                        saved.append((e["Y"][bad].cpu(), e["gram"][bad].cpu(), e["shift"]))
                print(json.dumps(r), flush=True)
                runs.append(r)
    res["plain_runs"] = runs
    if saved:
        np.savez_compressed(os.path.join(args.out, "cholqr_breakdowns.npz"),
                            Y=torch.cat([s[0] for s in saved]).numpy(),
                            gram=torch.cat([s[1] for s in saved]).numpy(),
                            shift=np.array([s[2] for s in saved for _ in range(len(s[0]))]))
    pc._plain_stack = _plain_stack
    lowrank._cholqr_once = committed

    # 2. the guard's cost
    g = torch.Generator(device="cuda").manual_seed(3)
    cost = {}
    grams = {"guarded": committed, "f32": cholqr_once(False)}
    for m in (66, 256, 1024):
        Y = torch.randn((64, m, 10), generator=g, device="cuda")
        c = {f"{k}_ms": cs.time_ms(lambda fn=fn: fn(Y, 1e-6), 50) for k, fn in grams.items()}
        for k, fn in grams.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            ev[0].record()
            for _ in range(20):
                fn(Y, 1e-6)
            ev[1].record()
            torch.cuda.synchronize()
            c[f"{k}_device_ms"] = ev[0].elapsed_time(ev[1]) / 20
        cost[f"[64, {m}, 10]"] = c
    res["cholqr_round_cost"] = cost
    print("cholqr round cost", json.dumps(cost), flush=True)
    ep = {}
    for k in ("guarded", "f32", "guarded_again", "f32_again"):
        lowrank._cholqr_once = grams[k.split("_")[0]]
        ep[k] = epochs(17, False, False, 3)["epoch_ms"]
    lowrank._cholqr_once = committed
    res["plain_epoch_ms"] = ep
    print("plain epoch ms", json.dumps(ep), flush=True)

    # 3. K7 against plain at the first round
    calls: list = []
    fused, plain = pc.poweriter_fused, pc.poweriter_plain

    def recorded(fn):
        def call(G, om, *a, **k):
            out = fn(G, om, *a, **k)
            calls.append((G, out))
            return out
        return call

    cfg = cs.a9_cfg(MM, "rankDAD", False)
    inv_x, inv_y, idx = cs.a9_data(torch, cfg, seed=17)
    torch.backends.cudnn.deterministic = True
    stacks = {}
    pc.poweriter_fused, pc.poweriter_plain = recorded(fused), recorded(plain)
    try:
        for use_kernel in (True, False):
            calls.clear()
            epoch, start = cs.a9_training(torch, cfg, use_kernel)
            epoch(start, inv_x, inv_y, idx[:, :1])
            torch.cuda.synchronize()
            out = []
            for G, (P, Q, trips) in calls:
                t0 = 0
                for g_, p_, q_ in zip(G, P, Q):
                    if p_.shape[-1] == 10:
                        out.append((g_, p_, q_, trips[t0:t0 + g_.shape[0]]))
                    t0 += g_.shape[0]
            stacks[use_kernel] = out
    finally:
        pc.poweriter_fused, pc.poweriter_plain = fused, plain
        torch.backends.cudnn.deterministic = False
    rows, used = [], set()
    for G, P, Q, t in stacks[False]:
        j = min((j for j, s in enumerate(stacks[True]) if j not in used and s[0].shape == G.shape),
                key=lambda j: (stacks[True][j][0] - G).abs().max().item())
        used.add(j)
        Gk, Pk, Qk, tk = stacks[True][j]
        dq = (Qk - Q).abs().amax((1, 2)) / max(Q.abs().max().item(), 1e-30)
        k = int(dq.argmax())
        row = {"shape": list(G.shape), "q_err": dq.max().item(), "member": k,
               "members_over_2e-4": int((dq > 2e-4).sum()), "trips_k7": int(tk[k]),
               "trips_plain": int(t[k]), "trips_differ": int((tk != t).sum()),
               "singular_values_8_to_12": torch.linalg.svdvals(G[k].double())[7:12].tolist(),
               "pq_err": ((Pk[k] @ Qk[k].mT) - (P[k] @ Q[k].mT)).abs().max().item()
               / max(G[k].abs().max().item(), 1e-30)}
        print("stack", json.dumps(row), flush=True)
        rows.append(row)
    res["first_round_q"] = rows
    with open(os.path.join(args.out, "probe.json"), "w") as f:
        json.dump(res, f)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
