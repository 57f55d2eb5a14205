#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel from ``dinunet_implementations_tpu_torch/csrc``;
3. kernel ``lstm_fwd`` against ``lstm_recurrence_plain`` on the card, all
   eight outputs, f32 and bf16, at T=98, D=256, H=174 and rows 1, 16, 512;
   times of the kernel, the plain version and a cuDNN ``torch.nn.LSTM``;
   then, untimed, every rows-per-block template of the launcher, and the
   model-layout ``lstm_forward_fused`` against ``lstm_forward_plain``;
4. the serving slice at full ICA-LSTM width: ``InferenceEngine`` answers
   requests of 1-16 rows from two threads; every answer is checked against
   ``eval_forward`` with the plain LSTM, and the launch counter must show
   two kernel launches (one per direction) for every dispatch;
5. one JSON line of per-kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

T, D, H = 98, 256, 174  # the ICA-LSTM's windows, encoder width, per-direction hidden
KERNEL_ROWS = (1, 16, 512)  # one request, the largest serving bucket, the training fold
SERVE_ROWS = 16  # the kernel row of the JSON line: the largest bucket the serving path runs
N_REQUESTS = 72
# f32: the kernel and cuBLAS sum the 430-term products in different orders;
# the difference (~1e-6 a step) compounds over 98 recurrent steps
F32_TOL = 1e-4
# bf16: products are exact in f32 in both, but a different summation order
# can flip the last bit of a bf16 stream value (2**-8 relative), and the
# bf16 h fed back carries that flip into later steps
BF16_TOL = 3e-2
SERVE_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores, bf16 tensor-core FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after two warm runs."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(rows: int, bf16: bool) -> tuple[float, str]:
    """Least time for one serving-configuration call (hs, hT, cT out): the
    larger of its bytes over HBM bandwidth and its product FLOP over the
    peak for the operand type."""
    es = 2 if bf16 else 4
    nbytes = (T * rows * D * es + 4 * D * H * es + 4 * H * 4 + 4 * H * H * es
              + 2 * rows * H * 4 + T * rows * H * es + 2 * rows * H * 4)
    flop = 2 * T * rows * (D + H) * 4 * H
    tb, to = nbytes / HBM_BPS, flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


OUTPUTS = ("hs", "cs", "i", "f", "o", "g", "hT", "cT")


def compare(what: str, got, want, names, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; fails past ``tol`` (abs +
    rel), on a shape or dtype mismatch, or on a non-finite value."""
    err = 0.0
    for name, a, b in zip(names, got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what} {name}: {a.shape}/{a.dtype} vs plain {b.shape}/{b.dtype}")
        d = (a.float() - b.float()).abs()
        if not bool(a.float().isfinite().all()) or bool((d > tol + tol * b.float().abs()).any()):
            fail(f"{what} output {name}: max abs err {d.max().item()}")
        err = max(err, d.max().item())
    return err


def recurrence_args(torch, rows: int, g):
    """Inputs of one direction at rows ``rows``, as the JAX kernel takes them."""
    dev = torch.device("cuda")

    def u(*shape, scale):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)

    x = torch.randn((T, rows, D), generator=g).relu().to(dev)  # encoder output is ReLU'd
    wih4 = u(4, D, H, scale=D ** -0.5)
    b4 = u(4, H, scale=2 * D ** -0.5)
    whh4 = u(4, H, H, scale=H ** -0.5)
    h0, c0 = u(rows, H, scale=0.5).contiguous(), u(rows, H, scale=0.5).contiguous()
    return x, wih4, b4, whh4, h0, c0


def kernel_phase(torch, lc) -> list[dict]:
    g = torch.Generator().manual_seed(0)
    out = []
    for rows in KERNEL_ROWS:
        args = recurrence_args(torch, rows, g)
        for cdt in (None, torch.bfloat16):
            tol = F32_TOL if cdt is None else BF16_TOL
            got = lc.lstm_recurrence_fused(*args, cdt, residuals=True)
            torch.cuda.synchronize()
            want = lc.lstm_recurrence_plain(*args, cdt, residuals=True)
            err = compare(f"lstm_fwd rows={rows} {cdt}", got, want, OUTPUTS, tol)
            ms = time_ms(lambda: lc.lstm_recurrence_fused(*args, cdt), 30)
            plain_ms = time_ms(lambda: lc.lstm_recurrence_plain(*args, cdt), 20)
            library_ms = library_lstm_ms(torch, args, want[0]) if cdt is None else None
            b_ms, b_by = bound(rows, cdt is not None)
            rec = {"rows": rows, "dtype": "bf16" if cdt else "f32", "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            print(json.dumps(rec))
            out.append(rec)
    return out


def coverage_phase(torch, lc) -> None:
    """Untimed checks of what the timed shapes leave out: every rows-per-block
    template the launcher can pick (1, 2, 4, 8 rows a block, each with a
    ragged last block), and the model-layout wrapper, whose strided views
    of x [B, T, D] and w [D, 4H] are what the serving path passes."""
    g = torch.Generator().manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the launcher takes the fewest rows a block that keep blocks <= SMs
    for rows in (2 * sms - 1, 4 * sms - 1, 4 * sms + 7):
        args = recurrence_args(torch, rows, g)
        for cdt in (None, torch.bfloat16):
            got = lc.lstm_recurrence_fused(*args, cdt, residuals=True)
            want = lc.lstm_recurrence_plain(*args, cdt, residuals=True)
            err = compare(f"lstm_fwd rows={rows} {cdt}", got, want, OUTPUTS,
                          F32_TOL if cdt is None else BF16_TOL)
            print(json.dumps({"check": "rows per block", "rows": rows, "sms": sms,
                              "dtype": "bf16" if cdt else "f32", "max_abs_err": err}))
    for rows in (1, 16):
        x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g)
        model = (x.transpose(0, 1).contiguous(), wih4.permute(1, 0, 2).reshape(D, 4 * H),
                 b4.reshape(4 * H), whh4.permute(1, 0, 2).reshape(H, 4 * H), h0, c0)
        for cdt in (None, torch.bfloat16):
            hs, (hT, cT) = lc.lstm_forward_fused(*model, cdt)
            ws, (wT, wc) = lc.lstm_forward_plain(*model, cdt)
            err = compare(f"lstm_forward_fused rows={rows} {cdt}", (hs, hT, cT), (ws, wT, wc),
                          ("hs", "hT", "cT"), F32_TOL if cdt is None else BF16_TOL)
            print(json.dumps({"check": "model layout", "rows": rows,
                              "dtype": "bf16" if cdt else "f32", "max_abs_err": err}))


def library_lstm_ms(torch, args, hs_plain) -> float:
    """cuDNN ``torch.nn.LSTM`` on the same data, its gate blocks reordered
    from the port's i, f, o, g to torch's i, f, g, o. Checked against the
    plain version first, so the yardstick computes the same function."""
    x, wih4, b4, whh4, h0, c0 = args
    order = (0, 1, 3, 2)
    lstm = torch.nn.LSTM(D, H).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([wih4[k].T for k in order]))
        lstm.weight_hh_l0.copy_(torch.cat([whh4[k].T for k in order]))
        lstm.bias_ih_l0.copy_(torch.cat([b4[k] for k in order]))
        lstm.bias_hh_l0.zero_()
        hc = (h0[None], c0[None])
        hs = lstm(x, hc)[0]
        err = (hs - hs_plain).abs().max().item()
        if err > F32_TOL:
            fail(f"cuDNN LSTM yardstick disagrees with the plain version: {err}")
        return time_ms(lambda: lstm(x, hc), 30)


def serving_phase(torch, np, lc):
    from dinunet_implementations_tpu_torch import ICALstm, InferenceEngine
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_model
    from dinunet_implementations_tpu_torch.trainer.steps import FederatedTask, eval_forward

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=0)  # default ICAArgs: full width
    a = cfg.ica_args
    model = build_model(cfg)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial head BatchNorm state
        bn = model.cls_bn
        bn.running_mean.copy_(0.2 * torch.randn(256, generator=g))
        bn.running_var.copy_(0.5 + 1.5 * torch.rand(256, generator=g))
        bn.weight.copy_(1 + 0.2 * torch.randn(256, generator=g))
        bn.bias.copy_(0.1 * torch.randn(256, generator=g))
    sd = model.state_dict()
    ref = ICALstm(input_size=a.input_size, hidden_size=a.hidden_size, bidirectional=a.bidirectional,
                  num_cls=a.num_class, num_comps=a.num_components, window_size=a.window_size,
                  use_kernel=False)
    ref.load_state_dict(sd)
    ref_task = FederatedTask(ref.to("cuda").eval())

    rng = np.random.default_rng(2)
    sizes = rng.integers(1, 17, N_REQUESTS)
    windows = a.temporal_size // a.window_size
    reqs = [rng.standard_normal((int(n), windows, a.num_components, a.window_size)).astype(np.float32)
            for n in sizes]
    answers = [None] * N_REQUESTS
    with InferenceEngine(cfg, state_dict=sd) as eng:
        warm = eng.warmup()
        print("warmup seconds by bucket:", json.dumps(warm))

        def client(ix):
            futs = [(i, eng.submit(reqs[i])) for i in ix]
            for i, f in futs:
                answers[i] = f.result(timeout=120)

        lc.LAUNCHES = 0  # the main path's run starts here
        threads = [threading.Thread(target=client, args=(range(k, N_REQUESTS, 2),))
                   for k in (0, 1)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
    launches = lc.LAUNCHES  # read just after the run, before any reference work
    if any(t.is_alive() for t in threads) or any(x is None for x in answers):
        fail("not every request was answered")
    summary = eng.summary()
    if summary["requests"] != N_REQUESTS or launches != 2 * summary["dispatches"] or launches == 0:
        fail(f"launches {launches} vs dispatches {summary['dispatches']}: {summary}")
    err = 0.0
    for x, got in zip(reqs, answers):
        want = eval_forward(ref_task, torch.from_numpy(x).cuda()).cpu().numpy()
        if got.shape != (len(x), a.num_class) or not np.isfinite(got).all():
            fail(f"answer shaped {got.shape} or not finite")
        err = max(err, float(np.abs(got - want).max()))
    if err > SERVE_TOL:
        fail(f"served probabilities differ from the plain path by {err}")
    summary.update(wall_s=wall, lstm_launches=launches, max_abs_err_vs_plain=err)
    print("serving:", json.dumps(summary))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from dinunet_implementations_tpu_torch.core.device import resolve_device
    from dinunet_implementations_tpu_torch.ops import _build
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    resolve_device(None)  # sets the f32 precision flags the port runs under
    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    print("== 1. device:", kind, "| python", sys.version.split()[0], "| torch", torch.__version__,
          "| CUDA", torch.version.cuda)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)

    print("== 2. build")
    _build.build_all()
    print(f"built in {_build.last_build['seconds']:.1f} s into {_build.last_build['dir']}")
    for name, log in _build.last_build["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print(f"== 3. kernel lstm_fwd vs plain, T={T} D={D} H={H}")
    shapes = kernel_phase(torch, lc)
    coverage_phase(torch, lc)

    print("== 4. serving slice at full ICA-LSTM width")
    launches = serving_phase(torch, np, lc)

    head = next(s for s in shapes if s["rows"] == SERVE_ROWS and s["dtype"] == "f32")
    kernels = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "dinunet_implementations_tpu/ops/lstm_pallas.py:91 (_fwd_fused_kernel)",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": {"T": T, "rows": SERVE_ROWS, "D": D, "H": H},
        "shapes": shapes,
    }]
    print(f"total {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
