#!/usr/bin/env python3
"""K1, K3 and K5, K2 and K6, or K7, across launch geometries on the card,
at full ICA-LSTM width.

    python3 scripts/torch_k1_sweep.py [--dtype f32|bf16|both] [--bidir] [--bwd] [--k7]

At T=98, D=256, H=174 it runs K1 (``lstm_recurrence_fused``) on the
geometry the launcher picks, on cluster geometries it could pick instead
(clusters of C blocks carrying R rows each, in one wave of the card, so
that the time against R gives the cost of a step), and on the streaming
route; each point is first held against the plain version (every output,
the tolerances of ``chip_smoke.py``), then timed as device time per call:
CUDA events around 20 back-to-back calls, so that a call's host work hides
behind the previous call's device time, the median of 5 such runs. The
projection alone is timed the same way; a cluster point also gives the
mean µs of each phase of a step (``k1_phase_profile``). With ``--bidir``
the same for K3 (``bilstm_fwd_fused``) and K5 (``bilstm_pool_fwd_fused``):
cluster geometries of both directions in one wave, the launcher's at rows
1, 16 and 512, and the stream route (the first design), with the
projection of both directions alone and ``bidir_phase_profile``. With
``--bwd`` the backward: K2 (``lstm_bwd_fused``; with ``--bidir`` K6,
``bilstm_pool_bwd_fused``) on cluster geometries of one wave (the time
against R gives the cost of a step; not with ``--main``), on the
launcher's at rows 16 and 512 and on the stream route (the first design),
each point held against the plain version, timed as above, with the µs a
step and the phase clock (``bwd_phase_profile`` /
``bidir_bwd_phase_profile``); with ``--bidir`` then K4
(``bilstm_bwd_fused``, full cotangent streams) on its launcher's geometry
and the stream route at rows 16 and 512, with ``k4_phase_profile``. With
``--k7`` the power iteration K7 (``poweriter_fused``) at one rankDAD round
of the flagship's two rank classes (``chip_smoke.py`` phase 7's gradients,
tol 1e-3), cold and warm Ω: the staged route the launcher picks and the
direct route, each held against ``poweriter_plain`` (``K7_TOL``) and timed
as above, with the bound, the streamed floor (G read once a pass) and the
staged route's phase clock (``k7_phase_profile``). Each K7 point also gives its device ms
with the host ahead of the card (``queued_device_ms``: the calls queued
behind a sleep kernel, so no call waits for the host) and the host µs of a
call (``host_us``); and the r=10 class's gradients run at ranks 12 and 16
too (r=16 without the encoder bucket, whose iterates and ring at that rank
exceed half an SM), cold Ω, both routes, their errors recorded. One JSON
line per point, then the card's name and power limit; it needs one CUDA
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

#: cycles of the sleep kernel the queued timings start behind (about 50 ms
#: at the H100's 1.98 GHz, far longer than the host takes to queue 20 calls)
SLEEP_CYCLES = 100_000_000


def device_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def queued_ms(torch, fn, calls: int = 20, reps: int = 5) -> dict:
    """One call's device ms with the host ahead of the card, and its host
    µs: each run queues a sleep kernel, then ``calls`` calls between two
    CUDA events, so the events time the card's work alone while the host
    clock times the host's; the medians of ``reps`` runs. ``host_ahead``:
    every run finished queueing before its sleep could have ended."""
    fn()
    torch.cuda.synchronize()
    dev, host, ahead = [], [], True
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ts = time.perf_counter()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        ahead = ahead and t1 - ts < 0.025
        dev.append(a.elapsed_time(b) / calls)
        host.append((t1 - t0) / calls * 1e6)
    return {"queued_device_ms": statistics.median(dev), "host_us": statistics.median(host),
            "host_ahead": ahead}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("f32", "bf16", "both"), default="both")
    ap.add_argument("--bidir", action="store_true", help="K3 and K5 (with --bwd: K6) instead of K1")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward: K2, or K6 and K4 with --bidir")
    ap.add_argument("--k7", action="store_true", help="the power iteration K7, both routes")
    ap.add_argument("--main", action="store_true",
                    help="with --bwd: only the launcher's geometry and the stream route at rows "
                         "16 and 512 (for A/Bs between two trees in one call)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from dinunet_implementations_tpu_torch.core.device import resolve_device
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if args.k7:
        k7_sweep(torch, cs, args.dtype)
        print(smi)
        return 0
    if args.bwd:
        bwd_sweep(torch, cs, args.dtype, args.bidir, args.main)
        print(smi)
        return 0
    if args.bidir:
        bidir_sweep(torch, cs, args.dtype)
        print(smi)
        return 0
    sms, optin = lc.device_limits("cuda")
    H = cs.H
    g = torch.Generator().manual_seed(0)
    dtypes = {"f32": None, "bf16": torch.bfloat16}
    for name, cdt in dtypes.items():
        if args.dtype not in (name, "both"):
            continue
        points = []
        for C in (2, 4, 8):
            probe = lc.k1_cluster_geometry(1, H, C, 1, cdt, optin)
            if probe is None:
                continue
            slots = lc.k1_max_active_clusters("cuda", 1, H, cdt, probe)
            for R in (1, 2, 4, 8, 16, 18, 32):
                geo = lc.k1_cluster_geometry(slots * R, H, C, R, cdt, optin, slots)
                if geo is not None:
                    points.append((slots * R, geo))
        for rows in (1, 16, 512):
            points.append((rows, lc.device_geometry("cuda", rows, H, cdt)))
            points.append((rows, lc.k1_stream_geometry(rows, H, sms, optin)))
        for rows, geo in points:
            a = cs.recurrence_args(torch, rows, g)
            tol = cs.F32_TOL if cdt is None else cs.BF16_TOL
            err = cs.compare(f"K1 rows={rows} {name} {geo}",
                             lc.lstm_recurrence_fused(*a, cdt, residuals=True, geometry=geo),
                             lc.lstm_recurrence_plain(*a, cdt, residuals=True), cs.OUTPUTS, tol)
            ms = device_ms(torch, lambda: lc.lstm_recurrence_fused(*a, cdt, geometry=geo))
            proj = device_ms(torch, lambda: lc.lstm_proj_fused(*a[:3], cdt))
            rec = {"rows": rows, "dtype": name, "route": geo["route"], "C": geo.get("C"),
                   "R": geo["R"], "rpt": geo.get("rpt"), "threads": geo["threads"],
                   "blocks": geo["blocks"], "smem": geo["smem"],
                   "max_active_clusters": lc.k1_max_active_clusters("cuda", rows, H, cdt, geo),
                   "k1_device_ms": ms, "proj_device_ms": proj,
                   "recurrence_us_per_step": (ms - proj) * 1e3 / cs.T, "max_abs_err": err,
                   "step_phases": lc.k1_phase_profile(*a, cdt, geometry=geo)
                   if geo["route"] == "cluster" else None}
            print(json.dumps(rec), flush=True)
            del a
    print(smi)
    return 0


def bidir_sweep(torch, cs, which: str) -> None:
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc

    sms, optin = bc.device_limits("cuda")
    H = cs.H
    g = torch.Generator().manual_seed(0)
    for name, cdt in {"f32": None, "bf16": torch.bfloat16}.items():
        if which not in (name, "both"):
            continue
        tol = cs.F32_TOL if cdt is None else cs.BF16_TOL
        for pool in (True, False):
            kernel = "bilstm_pool_fwd" if pool else "bilstm_fwd"
            fused = bc.bilstm_pool_fwd_fused if pool else bc.bilstm_fwd_fused
            names = cs.BIDIR_FWD_OUTPUTS + (("pool",) if pool else ())
            points = []
            if pool:  # the step cost against R: K5 alone
                for C in (2, 4, 8):
                    probe = bc.bidir_cluster_geometry(1, H, C, 1, cdt, optin, pool=pool)
                    if probe is None:
                        continue
                    half = bc.bidir_max_active_clusters("cuda", 1, H, cdt, probe) // 2
                    for R in (1, 2, 4, 8, 16, 24, 35):
                        geo = bc.bidir_cluster_geometry(half * R, H, C, R, cdt, optin, 2 * half,
                                                        pool)
                        if geo is not None:
                            points.append((half * R, geo))
            for rows in (1, 16, 512):
                points.append((rows, bc.device_bidir_geometry("cuda", rows, H, cdt, pool)))
                points.append((rows, bc.bidir_stream_geometry(rows, H, sms)))
            for rows, geo in points:
                a = cs.bidir_args(torch, rows, g)
                err = cs.compare(f"{kernel} rows={rows} {name} {geo}", fused(*a, cdt, geometry=geo),
                                 bc.bilstm_fwd_plain(*a, cdt, pool=pool), names, tol)
                ms = device_ms(torch, lambda: fused(*a, cdt, geometry=geo))
                proj = device_ms(torch, lambda: bc.bilstm_proj_fused(*a[:3], cdt))
                cluster = geo["route"] == "cluster"
                rec = {"kernel": kernel, "rows": rows, "dtype": name, "route": geo["route"],
                       "C": geo.get("C"), "R": geo["R"], "rpt": geo.get("rpt"),
                       "threads": geo["threads"], "blocks": geo["blocks"], "smem": geo.get("smem"),
                       "max_active_clusters": bc.bidir_max_active_clusters(
                           "cuda", rows, H, cdt, geo), "device_ms": ms,
                       "proj_device_ms": proj if cluster else None,
                       "recurrence_us_per_step": (ms - proj) * 1e3 / cs.T if cluster else None,
                       "max_abs_err": err,
                       "step_phases": bc.bidir_phase_profile(*a, cdt, geometry=geo, pool=pool)
                       if cluster else None}
                print(json.dumps(rec), flush=True)
                del a


def bwd_sweep(torch, cs, which: str, bidir: bool, main_only: bool = False) -> None:
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    sms, optin = lc.device_limits("cuda")
    H, dirs = cs.H, 2 if bidir else 1
    g = torch.Generator().manual_seed(0)
    for name, cdt in {"f32": None, "bf16": torch.bfloat16}.items():
        if which not in (name, "both"):
            continue
        tol = cs.F32_TOL if cdt is None else cs.BF16_TOL
        # K6 (or K2) over geometries, then K4 at the launcher's point and on
        # the stream route
        for kernel in ("bilstm_pool_bwd", "bilstm_bwd") if bidir else ("lstm_bwd",):
            points = []
            occupancy = bc.bidir_bwd_max_active_clusters if bidir else lc.bwd_max_active_clusters
            sweep = () if main_only or kernel == "bilstm_bwd" else (2, 4, 8)
            for C in sweep:  # the step cost against R, one wave each
                for R in (1, 2, 4, 8, 16, 18, 24, 35):
                    probe = lc.bwd_cluster_geometry(R, H, C, R, cdt, optin, dirs=dirs)
                    if probe is None:
                        continue
                    per = occupancy("cuda", R, H, cdt, probe) // dirs
                    points.append((per * R, lc.bwd_cluster_geometry(per * R, H, C, R, cdt, optin,
                                                                    dirs * per, dirs)))
            for rows in (16, 512):
                points.append((rows, cs.bwd_geometry_line(kernel, rows, H, cdt)))
                points.append((rows, lc.bwd_stream_geometry(rows, H, sms, dirs)))
            for rows, geo in points:
                bwd_point(torch, cs, bc, lc, kernel, name, cdt, tol, rows, geo, g)


def bwd_point(torch, cs, bc, lc, kernel, name, cdt, tol, rows, geo, g) -> None:
    """One BPTT point: held against the plain version, timed, one JSON line."""
    if kernel == "bilstm_pool_bwd":
        a = cs.pool_bwd_args(torch, bc, rows, cdt, g)
        fused, want, split = bc.bilstm_pool_bwd_fused, bc.bilstm_bwd_plain(
            *cs.pool_plain_args(a), cdt), (lambda o: o)
        names, profile = cs.BIDIR_BWD_OUTPUTS, bc.bidir_bwd_phase_profile
    elif kernel == "bilstm_bwd":  # full cotangent streams at the stream dtype
        a = cs.bidir_bwd_args(torch, bc, cs.bidir_args(torch, rows, g), cdt, g, const=False)
        fused, want, split = bc.bilstm_bwd_fused, bc.bilstm_bwd_plain(*a, cdt), (lambda o: o)
        names, profile = cs.BIDIR_BWD_OUTPUTS, bc.k4_phase_profile
    else:
        a = cs.bwd_args(torch, lc, rows, cdt, g)
        fused, want, split = lc.lstm_bwd_fused, lc.lstm_bwd_plain(*a, cdt), cs.split_bwd
        names, profile = cs.BWD_OUTPUTS, lc.bwd_phase_profile
    err = cs.compare(f"{kernel} rows={rows} {name} {geo}",
                     split(fused(*a, cdt, geometry=geo)), split(want), names, tol)
    ms = device_ms(torch, lambda: fused(*a, cdt, geometry=geo))
    cluster = geo["route"] == "cluster"
    rec = {"kernel": kernel, "rows": rows, "dtype": name, "route": geo["route"],
           "C": geo.get("C"), "R": geo["R"], "rpt": geo.get("rpt"),
           "threads": geo["threads"], "blocks": geo["blocks"], "smem": geo.get("smem"),
           "max_active_clusters": geo.get("max_active_clusters"), "device_ms": ms,
           "us_per_step": ms * 1e3 / cs.T, "max_abs_err": err,
           "step_phases": profile(*a, cdt, geometry=geo) if cluster else None}
    print(json.dumps(rec), flush=True)


def k7_sweep(torch, cs, which: str) -> None:
    from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc

    gen = torch.Generator(device="cuda").manual_seed(11)
    for r, leaves in cs.k7_leaves(torch).items():
        Gs = cs.k7_gradients(torch, leaves, gen)
        cold, warm = cs.k7_starts(torch, pc, leaves, Gs, r, gen)
        direct = pc.k7_direct_geometry([tuple(G.shape) for G in Gs], r)
        for name, mm in {"f32": None, "bf16": torch.bfloat16}.items():
            if which not in (name, "both"):
                continue
            staged = cs.k7_geometry_line(pc, Gs, r, mm)
            for start, oms in (("cold", cold), ("warm", warm)):
                want = pc.poweriter_plain(Gs, oms, cs.K7_ITERS, 1e-3, mm)
                for geo in (staged, direct):
                    got = pc.poweriter_fused(Gs, oms, cs.K7_ITERS, 1e-3, mm, geometry=geo)
                    err = cs.k7_check(torch, f"rank {r} {name} {start} {geo['route']}", Gs, r,
                                      got, want, name, True)
                    call = (lambda: pc.poweriter_fused(Gs, oms, cs.K7_ITERS, 1e-3, mm,
                                                       geometry=geo))
                    rec = {"kernel": "poweriter", "rank": r, "dtype": name, "start": start,
                           "route": geo["route"], "members": geo["blocks"],
                           "geometry": {k: v for k, v in geo.items() if k != "why"},
                           "device_ms": device_ms(torch, call), **queued_ms(torch, call),
                           "bound_ms": cs.k7_bound(Gs, r, got[2], mm is not None),
                           "streamed_floor_ms": cs.k7_streamed_floor(Gs, got[2]),
                           "errors": err,
                           "phases": pc.k7_phase_profile(Gs, oms, cs.K7_ITERS, 1e-3, mm,
                                                         geometry=geo)
                           if geo["route"] == "staged" else None}
                    print(json.dumps(rec), flush=True)
        if r == cs.K7_RANK:
            k7_rank_sweep(torch, cs, pc, which, leaves, Gs, gen)


def k7_rank_sweep(torch, cs, pc, which: str, leaves, Gs, gen) -> None:
    """The r=10 class's gradients at ranks 12 and 16 (16: without the
    encoder bucket, which alone puts that rank's iterates and ring past half
    an SM), cold Ω, tol 1e-3, on the staged route and the direct route: the
    ranks at which ptxas reports the staged kernel spilling."""
    enc = max(range(len(Gs)), key=lambda k: Gs[k].shape[1] * Gs[k].shape[2])
    for r, drop in ((12, False), (16, True)):
        keep = [k for k in range(len(Gs)) if not (drop and k == enc)]
        lv, gs = [leaves[k] for k in keep], [Gs[k] for k in keep]
        cold, _ = cs.k7_starts(torch, pc, lv, gs, r, gen)
        direct = pc.k7_direct_geometry([tuple(G.shape) for G in gs], r)
        for name, mm in {"f32": None, "bf16": torch.bfloat16}.items():
            if which not in (name, "both"):
                continue
            want = pc.poweriter_plain(gs, cold, cs.K7_ITERS, 1e-3, mm)
            for geo in (cs.k7_geometry_line(pc, gs, r, mm), direct):
                got = pc.poweriter_fused(gs, cold, cs.K7_ITERS, 1e-3, mm, geometry=geo)
                call = (lambda: pc.poweriter_fused(gs, cold, cs.K7_ITERS, 1e-3, mm,
                                                   geometry=geo))
                rec = {"kernel": "poweriter", "rank": r, "dtype": name, "start": "cold",
                       "set": "r=10 class without the encoder bucket" if drop else "r=10 class",
                       "route": geo["route"], "members": geo["blocks"],
                       "geometry": {k: v for k, v in geo.items() if k != "why"},
                       "device_ms": device_ms(torch, call), **queued_ms(torch, call),
                       "bound_ms": cs.k7_bound(gs, r, got[2], mm is not None),
                       "streamed_floor_ms": cs.k7_streamed_floor(gs, got[2]),
                       "errors": cs.k7_errors(torch, gs, r, got, want),
                       "phases": pc.k7_phase_profile(gs, cold, cs.K7_ITERS, 1e-3, mm,
                                                     geometry=geo)
                       if geo["route"] == "staged" else None}
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
