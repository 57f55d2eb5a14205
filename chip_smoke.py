#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every kernel from ``dinunet_implementations_tpu_torch/csrc``;
3. kernel ``lstm_fwd`` (K1) against ``lstm_recurrence_plain`` on the card,
   all eight outputs, f32 and bf16, at T=98, D=256, H=174 and rows 1, 16,
   512; times of the kernel, the plain version and a cuDNN
   ``torch.nn.LSTM``; then, untimed, every rows-per-block template of the
   launcher, and the model-layout ``lstm_forward_fused`` against
   ``lstm_forward_plain``;
4. kernel ``lstm_bwd`` (K2) against ``lstm_bwd_plain``, all six outputs,
   f32 and bf16, at rows 16 and 512; times of the kernel, the plain
   version and the backward of a cuDNN ``torch.nn.LSTM`` (which also
   computes dx and dW); then, untimed, every rows-per-block template;
5. the serving slice at full ICA-LSTM width: ``InferenceEngine`` answers
   requests of 1-16 rows from two threads; every answer is checked against
   ``eval_forward`` with the plain LSTM, and the launch counter must show
   two kernel launches (one per direction) for every dispatch;
6. the training slice at full width: two federated dSGD epochs of 32
   sites, batch 16, Adam 1e-3, through ``make_train_epoch_fn`` with the
   kernels; each kernel must launch exactly twice (one per direction) per
   micro-batch; the first round's aggregate gradient, and the params,
   optimizer state, running statistics and losses after the epochs, are
   held against the same epochs through the kernels' plain versions on
   the card; epoch ms, samples/s and ms per round are printed;
7. one JSON line of per-kernel numbers, then the result line.

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
BWD_ROWS = (16, 512)  # a serving-sized fold and the training fold (32 sites x 16)
TRAIN_SITES, TRAIN_BATCH, TRAIN_LR, TRAIN_EPOCHS = 32, 16, 1e-3, 2
# The training comparison (kernels vs their plain versions, f32, same
# inputs): the first round's aggregate gradient tightly, since the two
# differ only in summation order over 98 steps; the params after the
# epochs on the scale of lr, since an entry whose gradient is zero up to
# rounding (cls_fc1.bias: the BatchNorm after it removes any constant)
# takes Adam steps of about lr of either sign, up to 2·lr a round apart.
# The losses: the first round's is computed before any update and is
# compared tightly; later ones follow params that may part by lr-scale
# steps, which moved them by up to ~1e-4 on this card. Adam's moments after
# the epochs average gradients taken at those parted params, so they are
# compared at a share of the largest moment of the tree (a leaf whose
# gradient is rounding noise, as cls_fc1.bias, has no scale of its own).
AGG_TOL = dict(atol=1e-5, rtol=1e-3)
FIRST_LOSS_TOL, LOSS_TOL = 1e-5, 1e-3
MOMENT_SHARE = 5e-2
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


BWD_OUTPUTS = ("dp_i", "dp_f", "dp_o", "dp_g", "dh0", "dc0")


def bwd_bound(rows: int, bf16: bool) -> tuple[float, str]:
    """Least time for one backward call: bytes of the streams read (i, f, o,
    g, c, dhs) and written (the four dp) at the stream dtype, W_hhᵀ, and the
    f32 c0, dhT, dcT, dh0, dc0; product FLOP ``2·T·rows·4H·H`` over the peak
    for the operand type."""
    es = 2 if bf16 else 4
    nbytes = (6 + 4) * T * rows * H * es + 4 * H * H * es + 5 * rows * H * 4
    flop = 2 * T * rows * 4 * H * H
    tb, to = nbytes / HBM_BPS, flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def bwd_args(torch, lc, rows: int, cdt, g):
    """Inputs of one direction's backward at rows ``rows``: the residual
    streams of the plain forward, random cotangents."""
    x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g)
    _, cs, i, f, o, gg, _, _ = lc.lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, cdt,
                                                       residuals=True)
    sdt = torch.bfloat16 if cdt is not None else torch.float32

    def cot(*shape):
        return (0.05 * torch.randn(shape, generator=g)).cuda()

    return i, f, o, gg, cs, whh4, c0, cot(T, rows, H).to(sdt), cot(rows, H), cot(rows, H)


def split_bwd(out):
    dp, dh0, dc0 = out
    return [dp[..., k * H:(k + 1) * H] for k in range(4)] + [dh0, dc0]


def bwd_phase(torch, lc) -> list[dict]:
    g = torch.Generator().manual_seed(5)
    out = []
    for rows in BWD_ROWS:
        for cdt in (None, torch.bfloat16):
            args = bwd_args(torch, lc, rows, cdt, g)
            got = lc.lstm_bwd_fused(*args, cdt)
            torch.cuda.synchronize()
            want = lc.lstm_bwd_plain(*args, cdt)
            err = compare(f"lstm_bwd rows={rows} {cdt}", split_bwd(got), split_bwd(want),
                          BWD_OUTPUTS, F32_TOL if cdt is None else BF16_TOL)
            ms = time_ms(lambda: lc.lstm_bwd_fused(*args, cdt), 30)
            plain_ms = time_ms(lambda: lc.lstm_bwd_plain(*args, cdt), 10)
            library_ms = library_lstm_bwd_ms(torch, rows, g) if cdt is None else None
            b_ms, b_by = bwd_bound(rows, cdt is not None)
            rec = {"kernel": "lstm_bwd", "rows": rows, "dtype": "bf16" if cdt else "f32",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library": "cuDNN LSTM backward, also dx and dW",
                   "bound_ms": b_ms, "bound_by": b_by}
            print(json.dumps(rec))
            out.append(rec)
    # untimed: every rows-per-block template the launcher can pick (the same
    # choice as the forward's), each with a ragged last block
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (2 * sms - 1, 4 * sms - 1, 4 * sms + 7):
        for cdt in (None, torch.bfloat16):
            args = bwd_args(torch, lc, rows, cdt, g)
            err = compare(f"lstm_bwd rows={rows} {cdt}", split_bwd(lc.lstm_bwd_fused(*args, cdt)),
                          split_bwd(lc.lstm_bwd_plain(*args, cdt)), BWD_OUTPUTS,
                          F32_TOL if cdt is None else BF16_TOL)
            print(json.dumps({"check": "lstm_bwd rows per block", "rows": rows, "sms": sms,
                              "dtype": "bf16" if cdt else "f32", "max_abs_err": err}))
    return out


def cudnn_lstm(torch, wih4, b4, whh4):
    """A cuDNN ``torch.nn.LSTM`` holding the port's weights, its gate blocks
    reordered from the port's i, f, o, g to torch's i, f, g, o."""
    order = (0, 1, 3, 2)
    lstm = torch.nn.LSTM(D, H).to(wih4.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([wih4[k].T for k in order]))
        lstm.weight_hh_l0.copy_(torch.cat([whh4[k].T for k in order]))
        lstm.bias_ih_l0.copy_(torch.cat([b4[k] for k in order]))
        lstm.bias_hh_l0.zero_()
    return lstm


def library_lstm_bwd_ms(torch, rows: int, g) -> float:
    """The backward of one cuDNN LSTM call at the same shape: it computes
    the recurrence's cotangents and also dx and dW, so it does more than
    the kernel alone."""
    x, wih4, b4, whh4, h0, c0 = recurrence_args(torch, rows, g)
    lstm = cudnn_lstm(torch, wih4, b4, whh4)
    x = x.clone().requires_grad_()
    hs, _ = lstm(x, (h0[None], c0[None]))
    dhs = 0.05 * torch.randn(hs.shape, generator=g).cuda()
    inputs = [x] + list(lstm.parameters())
    return time_ms(lambda: torch.autograd.grad(hs, inputs, dhs, retain_graph=True), 30)


def library_lstm_ms(torch, args, hs_plain) -> float:
    """cuDNN ``torch.nn.LSTM`` on the same data, its gate blocks reordered
    from the port's i, f, o, g to torch's i, f, g, o. Checked against the
    plain version first, so the yardstick computes the same function."""
    x, wih4, b4, whh4, h0, c0 = args
    lstm = cudnn_lstm(torch, wih4, b4, whh4)
    with torch.no_grad():
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


def training_setup(torch, use_kernel: bool, seed: int = 0):
    """The full-width ICA-LSTM training configuration (default ``ICAArgs``,
    f32), its epoch function and first state, dropout 0 so that the kernel
    and plain paths compute the same function."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=seed, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR)
    task, engine, opt = build_training(cfg, use_kernel=use_kernel)
    task.model.dropout_rate = 0.0
    epoch = make_train_epoch_fn(task, engine, opt, local_iterations=cfg.local_iterations,
                                quarantine_rounds=cfg.quarantine_rounds)
    return cfg, epoch, init_train_state(task, engine, opt, rng=seed, num_sites=cfg.num_sites)


def training_data(np, cfg, seed: int = 4):
    """Sites of unequal size (2 to 4 batches each) with random timecourses
    and labels, stacked into the resident inventory, and one index plan
    per epoch."""
    from dinunet_implementations_tpu_torch.data import (
        SiteArrays,
        plan_epoch_positions,
        stack_site_inventory,
    )

    a = cfg.ica_args
    shape = (a.temporal_size // a.window_size, a.num_components, a.window_size)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2 * cfg.batch_size, 4 * cfg.batch_size + 1, cfg.num_sites)
    sites = [SiteArrays(rng.standard_normal((n,) + shape, dtype=np.float32),
                        rng.integers(0, a.num_class, n).astype(np.int32),
                        np.arange(n, dtype=np.int32)) for n in sizes]
    plans = [plan_epoch_positions(sites, cfg.batch_size, seed=e).positions
             for e in range(TRAIN_EPOCHS)]
    return stack_site_inventory(sites), plans


def tree_err(got: dict, want: dict, atol: float = 0.0, rtol: float = 0.0,
             share: float = 0.0) -> tuple[float, bool]:
    """Max abs error over a dict of tensors, and whether every entry is
    finite and within ``atol + rtol·|want| + share·max|want|`` (the last
    over the whole dict)."""
    top = max(w.float().abs().max().item() for w in want.values())
    err, ok = 0.0, True
    for k, w in want.items():
        a, b = got[k].float(), w.float()
        d = (a - b).abs()
        ok &= bool(a.isfinite().all()) and not bool((d > atol + rtol * b.abs() + share * top).any())
        err = max(err, d.max().item())
    return err, ok


def leaf_errs(got: dict, want: dict) -> dict:
    """Per leaf: [max abs error, max abs value]."""
    return {k: [(got[k] - w).abs().max().item(), w.abs().max().item()] for k, w in want.items()}


def training_phase(torch, np, lc) -> dict:
    cfg, epoch_k, state_k = training_setup(torch, use_kernel=True)
    _, epoch_p, state_p = training_setup(torch, use_kernel=False)
    if any(not torch.equal(v, state_p.params[k]) for k, v in state_k.params.items()):
        fail("the kernel and plain training paths start from different weights")
    inv, plans = training_data(np, cfg)
    inv_x, inv_y = torch.from_numpy(inv.inputs).cuda(), torch.from_numpy(inv.labels).cuda()
    idx = [torch.from_numpy(q).cuda() for q in plans]
    L = cfg.local_iterations
    rounds = [q.shape[1] // L for q in plans]
    samples = [cfg.num_sites * q.shape[1] * cfg.batch_size for q in plans]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lc.LAUNCHES = lc.BWD_LAUNCHES = 0  # the main path's run starts here
    st, ms, losses_k = state_k, [], []
    for e in range(TRAIN_EPOCHS):
        t0 = time.perf_counter()
        st, lo = epoch_k(st, inv_x, inv_y, idx[e])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses_k.append(lo)
    launches = {"lstm_fwd": lc.LAUNCHES, "lstm_bwd": lc.BWD_LAUNCHES}  # read before any check
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the first round's aggregate gradient: mu / (1 - b1) after one Adam step
    one_k, _ = epoch_k(state_k, inv_x, inv_y, idx[0][:, :L])
    one_p, _ = epoch_p(state_p, inv_x, inv_y, idx[0][:, :L])
    agg = lambda s: {k: m / 0.1 for k, m in s.opt_state["mu"].items()}  # noqa: E731
    sp, losses_p = state_p, []
    for e in range(TRAIN_EPOCHS):
        sp, lo = epoch_p(sp, inv_x, inv_y, idx[e])
        losses_p.append(lo)
    lk, lp = torch.cat(losses_k), torch.cat(losses_p)
    dl = (lk - lp).abs()
    param_atol = 2 * TRAIN_LR * sum(rounds)
    checks = {
        "first_round_aggregate": tree_err(agg(one_k), agg(one_p), **AGG_TOL),
        "first_loss": (dl[0].item(), dl[0].item() <= FIRST_LOSS_TOL),
        "loss": (dl.max().item(), bool(lk.isfinite().all()) and dl.max().item() <= LOSS_TOL),
        "params": tree_err(st.params, sp.params, param_atol, 0.0),
        "batch_stats": tree_err(st.batch_stats, sp.batch_stats, param_atol, 0.0),
        "adam_mu": tree_err(st.opt_state["mu"], sp.opt_state["mu"], share=MOMENT_SHARE),
        "adam_nu": tree_err(st.opt_state["nu"], sp.opt_state["nu"], share=MOMENT_SHARE),
    }
    rec = {
        "sites": cfg.num_sites, "batch": cfg.batch_size, "local_iterations": L,
        "rounds_per_epoch": rounds, "samples_per_epoch": samples, "epoch_ms": ms,
        "samples_per_s": samples[-1] / (ms[-1] / 1e3), "ms_per_round": ms[-1] / rounds[-1],
        "launches": launches, "peak_memory_gb": peak_gb, "losses": lk.tolist(),
        "plain_losses": lp.tolist(), "param_atol": param_atol,
        "max_abs_err_vs_plain": {k: e for k, (e, _) in checks.items()},
        "leaf_err_and_scale": {m: leaf_errs(st.opt_state[m], sp.opt_state[m]) for m in ("mu", "nu")}
        | {"params": leaf_errs(st.params, sp.params)},
    }
    print("training:", json.dumps(rec))
    want_launches = 2 * sum(rounds) * L
    if launches != {"lstm_fwd": want_launches, "lstm_bwd": want_launches}:
        fail(f"training launches {launches}, want {want_launches} of each kernel")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"training differs from the plain path in {bad}")
    if lk.shape != (sum(rounds),):
        fail(f"training losses shaped {tuple(lk.shape)}")
    if int(st.opt_state["count"]) != sum(rounds) or st.round != sum(rounds):
        fail(f"training count {int(st.opt_state['count'])}, round {st.round}")
    return rec


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

    print(f"== 4. kernel lstm_bwd vs plain, T={T} H={H}")
    bwd_shapes = bwd_phase(torch, lc)

    print("== 5. serving slice at full ICA-LSTM width")
    serve_launches = serving_phase(torch, np, lc)

    print(f"== 6. training slice at full ICA-LSTM width: {TRAIN_SITES} sites, batch {TRAIN_BATCH}")
    train = training_phase(torch, np, lc)

    fwd = next(s for s in shapes if s["rows"] == SERVE_ROWS and s["dtype"] == "f32")
    bwd = next(s for s in bwd_shapes if s["rows"] == TRAIN_SITES * TRAIN_BATCH and s["dtype"] == "f32")
    by_path = {"serving": serve_launches, "training": train["launches"]["lstm_fwd"]}
    kernels = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "dinunet_implementations_tpu/ops/lstm_pallas.py:91 (_fwd_fused_kernel)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": fwd["max_abs_err"],
        "ms": fwd["ms"], "kernel_ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "shape": {"T": T, "rows": SERVE_ROWS, "D": D, "H": H},
        "shapes": shapes,
    }, {
        "name": "lstm_bwd", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "dinunet_implementations_tpu/ops/lstm_pallas.py:174 (_bwd_kernel)",
        "launches": train["launches"]["lstm_bwd"],
        "launches_by_path": {"training": train["launches"]["lstm_bwd"]},
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"], "kernel_ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "library": bwd["library"],
        "shape": {"T": T, "rows": TRAIN_SITES * TRAIN_BATCH, "H": H}, "shapes": bwd_shapes,
    }]
    print(f"total {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
