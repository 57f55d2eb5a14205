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
7. kernel ``poweriter`` (K7) against ``poweriter_plain`` at one rankDAD
   round of the flagship: the r=10 class (7 leaves × 32 sites, six shape
   buckets, nn.Linear weights read through transposed views) and the r=2
   class, with a dead site (G = 0) and a site of rank 2; f32 and bf16,
   cold and warm Ω, tol 1e-3 and 0; P, Q, PQᵀ and the trip counts
   compared; times of the kernel and the plain version and the bound; the
   wrapper's refusals (a class over the shared-memory limit, a G with no
   contiguous matrix axis);
8. the rankDAD training slice: phase 6's two epochs with the rankDAD
   engine (rank 10, 5 refinements, tol 1e-3, warm starts) through K1, K2
   and K7, held against the all-plain path on the card the same way and
   on Ω; K7 must launch once per rank class per round;
9. one JSON line of per-kernel numbers, then the result line.

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
# rankDAD's Ω after the first round (each site's Q of its first gradient,
# from the same start on both paths), per leaf over the leaf's max |Ω|: the
# round's cold start makes five unconverged refinements, whose columns
# within near-equal singular values carry the kernel's f32 summation-order
# differences (K7's own phase: Q within 2.8e-5 of max|G|). After the epochs
# Ω follows params that part on the lr scale, and Q's columns within
# near-equal singular values then rotate freely (the encoder's Ω differed
# by 0.46 at a scale of 0.43 after 8 rounds on the card): checked there for
# shape and finiteness only. The first card run measured 2.6e-5.
OMEGA_FIRST_TOL = 2e-4
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


def training_setup(torch, use_kernel: bool, seed: int = 0, engine: str = "dSGD"):
    """The full-width ICA-LSTM training configuration (default ``ICAArgs``,
    f32, the ``engine`` aggregation: rankDAD with its default knobs, rank
    10, 5 refinements, tol 1e-3, warm starts), its epoch function and first
    state, dropout 0 so that the kernel and plain paths compute the same
    function."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.runner.registry import build_training
    from dinunet_implementations_tpu_torch.trainer.steps import (
        init_train_state,
        make_train_epoch_fn,
    )

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, seed=seed, num_sites=TRAIN_SITES,
                      batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, agg_engine=engine)
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


def training_phase(torch, np, lc, pc, engine: str = "dSGD") -> dict:
    cfg, epoch_k, state_k = training_setup(torch, use_kernel=True, engine=engine)
    _, epoch_p, state_p = training_setup(torch, use_kernel=False, engine=engine)
    rankdad = engine == "rankDAD"
    classes = len(k7_leaves(torch)) if rankdad else 0
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

    lc.LAUNCHES = lc.BWD_LAUNCHES = pc.POWERITER_LAUNCHES = 0  # the main path's run starts here
    st, ms, losses_k = state_k, [], []
    for e in range(TRAIN_EPOCHS):
        t0 = time.perf_counter()
        st, lo = epoch_k(st, inv_x, inv_y, idx[e])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses_k.append(lo)
    # read before any check
    launches = {"lstm_fwd": lc.LAUNCHES, "lstm_bwd": lc.BWD_LAUNCHES,
                "poweriter": pc.POWERITER_LAUNCHES}
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
    omega = lambda s: {k: v for k, v in s.engine_state.get("omega", {}).items()  # noqa: E731
                       if v is not None}
    if rankdad:
        first = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                 for g, w in zip(omega(one_k).values(), omega(one_p).values(), strict=True)]
        checks["first_round_omega"] = (max(first), max(first) <= OMEGA_FIRST_TOL)
        end_ok = all(bool(v.isfinite().all()) and v.shape == w.shape
                     for v, w in zip(omega(st).values(), omega(sp).values(), strict=True))
        checks["omega_end_finite"] = (0.0, end_ok and len(omega(st)) == len(omega(sp)) > 0)
    rec = {
        "sites": cfg.num_sites, "batch": cfg.batch_size, "local_iterations": L,
        "rounds_per_epoch": rounds, "samples_per_epoch": samples, "epoch_ms": ms,
        "samples_per_s": samples[-1] / (ms[-1] / 1e3), "ms_per_round": ms[-1] / rounds[-1],
        "launches": launches, "peak_memory_gb": peak_gb, "losses": lk.tolist(),
        "plain_losses": lp.tolist(), "param_atol": param_atol,
        "max_abs_err_vs_plain": {k: e for k, (e, _) in checks.items()},
        "leaf_err_and_scale": {m: leaf_errs(st.opt_state[m], sp.opt_state[m]) for m in ("mu", "nu")}
        | {"params": leaf_errs(st.params, sp.params),
           "first_round_omega": leaf_errs(omega(one_k), omega(one_p)),
           "omega": leaf_errs(omega(st), omega(sp))},
        "engine": engine, "rank_classes": classes,
    }
    print(f"training {engine}:", json.dumps(rec))
    want_launches = 2 * sum(rounds) * L
    want = {"lstm_fwd": want_launches, "lstm_bwd": want_launches,
            "poweriter": classes * sum(rounds)}
    if launches != want:
        fail(f"training {engine} launches {launches}, want {want}")
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        fail(f"training {engine} differs from the plain path in {bad}")
    if lk.shape != (sum(rounds),):
        fail(f"training losses shaped {tuple(lk.shape)}")
    if int(st.opt_state["count"]) != sum(rounds) or st.round != sum(rounds):
        fail(f"training count {int(st.opt_state['count'])}, round {st.round}")
    return rec


# K7: one round of rankDAD's power iteration at the flagship shapes. The
# per-site gradients are made of 16 decaying directions plus a floor of
# noise (a per-site batch of 16 bounds the rank of most leaves); site 0 is
# a dead site (G = 0) and site 1 has rank 2, below r = 10.
K7_RANK, K7_ITERS = 10, 5
K7_SIGNAL, K7_DECAY, K7_NOISE = 16, 0.7, 1e-3
# Kernel against plain (P absolute; Q and PQᵀ over the member's max|G|),
# set from the first card run (f32: P 2.6e-5, Q 2.8e-5, PQᵀ 4.3e-6; bf16:
# 3.1e-4, 2.1e-3, 3.7e-4). f32: the two sum 256-1000-term products in other
# orders, and five unconverged refinements from a cold Ω carry the
# difference into the subspace. bf16: an f32 value one ulp apart can round
# to the neighbouring bf16 operand (2**-9 relative). A site of rank 2 < r:
# its other columns are rounding noise, so only PQᵀ is compared, at the
# noise's scale (JAX's own two paths differ by 2.3e-4 there on the CPU).
K7_TOL = {"f32": {"P": 1e-4, "Q": 1e-4, "PQ": 2e-5, "PQ_rank_below_r": 1e-3},
          "bf16": {"P": 1e-3, "Q": 5e-3, "PQ": 1e-3, "PQ_rank_below_r": 5e-3}}
# Trip counts are compared at tol 1e-3: a member whose σ change lands within
# rounding of the threshold can stop one refinement apart (2 of 224 in the
# first run), which moves its factors by far less than the tolerances above.
# At tol 0 a member stops only when its σ change is exactly 0, which
# depends on the last bit of a sum, so trips are not compared there.
K7_TRIPS_DIFFER_SHARE = 0.02


def k7_leaves(torch):
    """``(name, m, n, transposed)`` of every compressible leaf of the
    full-width ICA-LSTM, in the JAX matrix orientation, and their rank
    classes ``{r: [leaf, ...]}``."""
    from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
    from dinunet_implementations_tpu_torch.engines.lowrank import _matrix_shape, is_compressible
    from dinunet_implementations_tpu_torch.runner.registry import get_task
    from dinunet_implementations_tpu_torch.weights import jax_transposed_leaves

    cfg = TrainConfig(task_id=NNComputation.TASK_ICA)
    model = get_task(cfg.task_id).build_model(cfg, torch.Generator().manual_seed(0))
    tr = jax_transposed_leaves(cfg.ica_args.bidirectional)
    classes: dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)[::-1] if name in tr else tuple(p.shape)
        if is_compressible(shape):
            m, n = _matrix_shape(shape)
            classes.setdefault(min(K7_RANK, m, n), []).append((name, m, n, name in tr))
    return dict(sorted(classes.items()))


def k7_gradients(torch, leaves, gen):
    """Per leaf, the ``[S, m, n]`` matrix view the engine hands the kernel:
    a transposed view of ``[S, n, m]`` storage for an ``nn.Linear`` weight."""
    S, dev = TRAIN_SITES, torch.device("cuda")
    out = []
    for _, m, n, tr in leaves:
        k = min(K7_SIGNAL, m, n)
        d = K7_DECAY ** torch.arange(k, device=dev, dtype=torch.float32)
        A = torch.randn((S, m, k), generator=gen, device=dev)
        B = torch.randn((S, k, n), generator=gen, device=dev)
        G = (A * d) @ B / k ** 0.5 + K7_NOISE * torch.randn((S, m, n), generator=gen, device=dev)
        G[0] = 0.0
        G[1] = (A[1, :, :2] @ B[1, :2]) / k ** 0.5
        out.append(G.transpose(1, 2).contiguous().transpose(1, 2) if tr else G.contiguous())
    return out


def k7_bound(Gs, r: int, trips, bf16: bool) -> tuple[float, str]:
    """Least time for one K7 call: bytes of G read once, Ω read, P and Q
    written (f32) over HBM bandwidth; product FLOP over the peak for the
    operand type, ``2·m·n·r`` for each of ``G Ω``, the first ``GᵀP`` and
    two products a refinement, with each member's trips in this call (the
    final ``Q = GᵀP`` is the last refinement's ``GᵀP``)."""
    t = trips.tolist()
    nbytes, flop, k = 0, 0, 0
    for G in Gs:
        L, m, n = G.shape
        nbytes += 4 * L * (m * n + n * r + (m + n) * r)
        flop += sum(2 * m * n * r * (2 + 2 * t[k + i]) for i in range(L))
        k += L
    tb = nbytes / HBM_BPS
    to = flop / (BF16_FLOPS if bf16 else F32_FLOPS)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def k7_errors(torch, Gs, r, got, want) -> dict:
    """Kernel against plain per member category: P, and Q and PQᵀ over the
    member's max|G|, for the members of rank ≥ r; PQᵀ alone for site 1
    when its rank (2) is below r (its other columns are rounding noise);
    the dead site's factors exactly; the trip counts."""
    Pg, Qg, tg = got
    Pw, Qw, tw = want
    e = {"P": 0.0, "Q": 0.0, "PQ": 0.0, "PQ_rank_below_r": 0.0, "dead_site": 0.0}
    for G, pg, qg, pw, qw in zip(Gs, Pg, Qg, Pw, Qw):
        scale = G.abs().amax((1, 2)).clamp(min=1e-30)
        dP = (pg - pw).abs().amax((1, 2))
        dQ = (qg - qw).abs().amax((1, 2)) / scale
        dPQ = ((pg @ qg.mT) - (pw @ qw.mT)).abs().amax((1, 2)) / scale
        regular = slice(2, None) if r > 2 else slice(1, None)
        e["P"] = max(e["P"], dP[regular].max().item())
        e["Q"] = max(e["Q"], dQ[regular].max().item())
        e["PQ"] = max(e["PQ"], dPQ[regular].max().item())
        if r > 2:
            e["PQ_rank_below_r"] = max(e["PQ_rank_below_r"], dPQ[1].item())
        e["dead_site"] = max(e["dead_site"], (pg[0] - pw[0]).abs().max().item(),
                             (qg[0] - qw[0]).abs().max().item())
        if not all(bool(a.isfinite().all()) for a in (pg, qg)):
            fail(f"K7 rank {r}: non-finite factors")
    e["trips_differ"] = int((tg != tw).sum().item())
    e["trips"] = {int(v): int(c) for v, c in zip(*torch.unique(tg, return_counts=True))}
    return e


def poweriter_phase(torch, pc) -> list[dict]:
    """K7 against its plain version at one round of the flagship's rank
    classes (32 sites), f32 and bf16, cold and warm Ω, tol 1e-3 and 0;
    times and bounds of the kernel and the plain version; and the
    wrapper's refusals."""
    from dinunet_implementations_tpu_torch.engines.lowrank import default_omega

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for r, leaves in k7_leaves(torch).items():
        Gs = k7_gradients(torch, leaves, gen)
        cold = [default_omega((m, n), r, "cuda").expand(TRAIN_SITES, n, r)
                for _, m, n, _ in leaves]
        # warm Ω: the Q of a factorization of the last round's (perturbed) G
        prev = [G + 0.05 * G.abs().amax((1, 2), keepdim=True)
                * torch.randn(G.shape, generator=gen, device="cuda") for G in Gs]
        warm = pc.poweriter_plain(prev, cold, K7_ITERS, 1e-3)[1]
        for bf16 in (False, True):
            mm = torch.bfloat16 if bf16 else None
            for start, oms in (("cold", cold), ("warm", warm)):
                for tol in (1e-3, 0.0):
                    got = pc.poweriter_fused(Gs, oms, K7_ITERS, tol, mm)
                    torch.cuda.synchronize()
                    want = pc.poweriter_plain(Gs, oms, K7_ITERS, tol, mm)
                    rec = {"kernel": "poweriter", "rank": r, "members": sum(G.shape[0] for G in Gs),
                           "shapes": [list(G.shape) for G in Gs],
                           "dtype": "bf16" if bf16 else "f32", "start": start, "tol": tol}
                    rec.update(k7_errors(torch, Gs, r, got, want))
                    bad = [k for k, v in K7_TOL[rec["dtype"]].items() if not rec[k] <= v]
                    if rec["dead_site"] != 0.0:
                        bad.append("dead_site")
                    if tol > 0 and rec["trips_differ"] > K7_TRIPS_DIFFER_SHARE * rec["members"]:
                        bad.append("trips")
                    if bad:
                        fail(f"K7 differs from the plain version in {bad}: {json.dumps(rec)}")
                    if tol == 1e-3:
                        rec["ms"] = time_ms(lambda: pc.poweriter_fused(Gs, oms, K7_ITERS, tol, mm), 20)
                        rec["plain_ms"] = time_ms(
                            lambda: pc.poweriter_plain(Gs, oms, K7_ITERS, tol, mm), 5)
                        rec["bound_ms"], rec["bound_by"] = k7_bound(Gs, r, got[2], bf16)
                        rec["library_ms"] = None
                    print(json.dumps(rec))
                    out.append(rec)
    # the wrapper refuses what the kernel does not take, before any launch
    n0 = pc.POWERITER_LAUNCHES
    for what, G, om in (
            ("over the shared-memory limit", torch.zeros((1, 4000, 3000), device="cuda"),
             torch.zeros((1, 3000, 16), device="cuda")),
            ("no contiguous matrix axis", torch.zeros((2, 64, 64, 2), device="cuda")[..., 0],
             torch.zeros((2, 64, 4), device="cuda"))):
        try:
            pc.poweriter_fused(G, om, K7_ITERS, 1e-3)
        except ValueError as e:
            print(f"K7 refuses a class {what}: {e}")
        else:
            fail(f"poweriter_fused took a class {what}")
    if pc.POWERITER_LAUNCHES != n0:
        fail("a refused class was launched")
    return out


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
    from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc

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
    train = training_phase(torch, np, lc, pc)

    print(f"== 7. kernel poweriter vs plain: one rankDAD round's rank classes, {TRAIN_SITES} sites")
    k7 = poweriter_phase(torch, pc)

    print(f"== 8. rankDAD training at full ICA-LSTM width: {TRAIN_SITES} sites, batch {TRAIN_BATCH}")
    train_dad = training_phase(torch, np, lc, pc, engine="rankDAD")

    fwd = next(s for s in shapes if s["rows"] == SERVE_ROWS and s["dtype"] == "f32")
    bwd = next(s for s in bwd_shapes if s["rows"] == TRAIN_SITES * TRAIN_BATCH and s["dtype"] == "f32")
    by_path = {"serving": serve_launches, "training": train["launches"]["lstm_fwd"],
               "training_rankDAD": train_dad["launches"]["lstm_fwd"]}
    bwd_by_path = {"training": train["launches"]["lstm_bwd"],
                   "training_rankDAD": train_dad["launches"]["lstm_bwd"]}
    k7_main = next(s for s in k7 if s["rank"] == K7_RANK and s["dtype"] == "f32"
                   and s["start"] == "cold" and s["tol"] > 0)
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
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path,
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"], "kernel_ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "library": bwd["library"],
        "shape": {"T": T, "rows": TRAIN_SITES * TRAIN_BATCH, "H": H}, "shapes": bwd_shapes,
    }, {
        "name": "poweriter", "route": "cuda",
        "source": "dinunet_implementations_tpu_torch/csrc/poweriter.cu",
        "replaces": "dinunet_implementations_tpu/ops/poweriter_pallas.py:164 (_poweriter_kernel)",
        "launches": train_dad["launches"]["poweriter"],
        "launches_by_path": {"training_rankDAD": train_dad["launches"]["poweriter"]},
        "max_abs_err": max(s["P"] for s in k7 if s["dtype"] == "f32"),
        "ms": k7_main["ms"], "kernel_ms": k7_main["ms"], "plain_ms": k7_main["plain_ms"],
        "bound_ms": k7_main["bound_ms"], "bound_by": k7_main["bound_by"], "library_ms": None,
        "library": "none: no one PyTorch call computes this power iteration "
                   "(torch.svd_lowrank and torch.linalg.svd are other algorithms)",
        "shape": {"rank": K7_RANK, "members": k7_main["members"], "buckets": k7_main["shapes"],
                  "dtype": "f32", "start": "cold", "tol": k7_main["tol"]},
        "shapes": [s for s in k7 if "ms" in s],
    }]
    print(f"total {time.monotonic() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
