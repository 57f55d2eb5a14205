"""The fused LSTM recurrence, forward and backward: CUDA kernels for the
card, their plain PyTorch versions beside them.

Counterpart of the JAX package's ``ops/lstm_pallas.py`` single-direction
path (``_fwd_fused_kernel`` and ``_bwd_kernel`` behind
``lstm_recurrence_fused`` and ``lstm_forward_fused``), with the same
signatures and layouts:

- ``x [T, B, D]`` raw per-step inputs: the i2h projection runs inside the
  forward kernel, as on the TPU;
- ``wih4 [4, D, H]``, ``b4 [4, H]``, ``whh4 [4, H, H]``, gates in the order
  i, f, o, g (not ``torch.nn.LSTM``'s i, f, g, o);
- ``h0, c0 [B, H]`` f32.

Kernel sources: ``csrc/lstm_fwd.cu`` (K1) and ``csrc/lstm_bwd.cu`` (K2).
:func:`lstm_recurrence_fused` and :func:`lstm_bwd_fused` launch them for
CUDA tensors and raise on anything they do not take; for CPU tensors, and
only for them, they run :func:`lstm_recurrence_plain` and
:func:`lstm_bwd_plain`. ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel
launches, so a run can show that it went through the kernels.

:class:`LSTMRecurrence` is the differentiable recurrence: K1 with its
residual streams forward, K2 and the weight-gradient products backward, as
the JAX ``custom_vjp``. Its weights may carry a leading site axis
``[S, ...]`` of stride 0 (every site holds the same values): the rows of
``x`` are then ``S`` blocks of ``B / S`` rows, one block per site, the
kernels run once over all rows, and the weight gradients come back per
site, as the JAX ``custom_vmap`` fold computes them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: K1 launches since the counter was last set to 0
LAUNCHES = 0
#: K2 launches since the counter was last set to 0
BWD_LAUNCHES = 0

_entries: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "lstm_fwd": [_I, _P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _L, _P, _P,
                 _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lstm_bwd": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _L, _L,
                 _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _kernel(name: str):
    """``(entry, error_string)`` of ``csrc/<name>.cu``, built on first use."""
    if name not in _entries:
        lib = _build.load(name)
        fn = getattr(lib, "dn_" + name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        lib.dn_error_string.argtypes = [_I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entries[name] = (fn, lib.dn_error_string)
    return _entries[name]


def _stream_dtype(compute_dtype) -> torch.dtype:
    if compute_dtype is None:
        return torch.float32
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype!r}")


def lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, compute_dtype=None,
                          residuals=False):
    """Plain PyTorch version of the kernel: a loop over T with the same gate
    order and casts. Under ``compute_dtype=torch.bfloat16`` the operands of
    both products are rounded to bf16 and the products accumulate in f32;
    the streams are bf16 and the carries f32.

    Returns ``(hs, (hT, cT))``, or with ``residuals=True`` the kernel's
    eight outputs ``(hs, cs, i, f, o, g, hT, cT)``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, D = x.shape
    H = wih4.shape[-1]
    wih = wih4.to(sdt).float().permute(1, 0, 2).reshape(D, 4 * H)
    whh = whh4.to(sdt).float().permute(1, 0, 2).reshape(H, 4 * H)
    xp = torch.matmul(x.to(sdt).float(), wih)  # [T, B, 4H]
    b = b4.float().reshape(4 * H)
    h, c = h0.float(), c0.float()
    streams = [[] for _ in range(6)]
    for t in range(T):
        pre = xp[t] + torch.matmul(h.to(sdt).float(), whh) + b
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        o = torch.sigmoid(pre[:, 2 * H:3 * H])
        g = torch.tanh(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        for s, v in zip(streams, (h, c, i, f, o, g)):
            s.append(v)
    hs, cs, ai, af, ao, ag = (torch.stack(s).to(sdt) for s in streams)
    if residuals:
        return hs, cs, ai, af, ao, ag, h, c
    return hs, (h, c)


def _check(cond: bool, what: str, fn: str = "lstm_recurrence_fused") -> None:
    if not cond:
        raise ValueError(f"{fn}: {what}")


def lstm_recurrence_fused(x, wih4, b4, whh4, h0, c0, compute_dtype=None,
                          residuals=False):
    """Fused LSTM forward: i2h projection and recurrence in one kernel.

    Same arguments and returns as :func:`lstm_recurrence_plain`. The terminal
    carry ``(hT, cT)`` is always f32, written from the kernel's f32 carry and
    never from the stream dtype. The residual streams ``cs, i, f, o, g`` are
    written only when ``residuals=True``. ``x`` may be a strided view (any
    strides over T and B, contiguous over D); the weights need only their
    last axis contiguous, so model-layout views pass without a copy."""
    if x.device.type == "cpu":
        return lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, compute_dtype, residuals)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    sdt = _stream_dtype(compute_dtype)
    if compute_dtype is None:
        _check(all(a.dtype == torch.float32 for a in (x, wih4, whh4)),
               "x, wih4 and whh4 must be float32 when compute_dtype is None")
    else:
        x, wih4, whh4 = x.to(sdt), wih4.to(sdt), whh4.to(sdt)
    _check(all(a.dtype == torch.float32 for a in (b4, h0, c0)), "b4, h0 and c0 must be float32")
    _check(x.dim() == 3, f"x must be [T, B, D], got {tuple(x.shape)}")
    T, B, D = x.shape
    H = wih4.shape[-1]
    _check(T >= 1 and B >= 1, "x needs at least one step and one row")
    _check(tuple(wih4.shape) == (4, D, H), f"wih4 must be [4, {D}, {H}], got {tuple(wih4.shape)}")
    _check(tuple(b4.shape) == (4, H), f"b4 must be [4, {H}], got {tuple(b4.shape)}")
    _check(tuple(whh4.shape) == (4, H, H), f"whh4 must be [4, {H}, {H}], got {tuple(whh4.shape)}")
    _check(tuple(h0.shape) == (B, H) and tuple(c0.shape) == (B, H), f"h0 and c0 must be [{B}, {H}]")
    args = (x, wih4, b4, whh4, h0, c0)
    _check(all(a.device == x.device for a in args), "all inputs must be on one device")
    _check(all(a.stride(-1) == 1 for a in (x, wih4, b4, whh4)),
           "x, wih4, b4 and whh4 must be contiguous in their last axis")
    _check(h0.is_contiguous() and c0.is_contiguous(), "h0 and c0 must be contiguous")

    def stream():
        return torch.empty((T, B, H), dtype=sdt, device=x.device)

    hs = stream()
    res = [stream() for _ in range(5)] if residuals else [None] * 5
    hT = torch.empty((B, H), dtype=torch.float32, device=x.device)
    cT = torch.empty_like(hT)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn, err_str = _kernel("lstm_fwd")
    with torch.cuda.device(x.device):
        err = fn(
            0 if sdt == torch.float32 else 1,
            x.data_ptr(), x.stride(0), x.stride(1),
            wih4.data_ptr(), wih4.stride(0), wih4.stride(1),
            b4.data_ptr(), b4.stride(0),
            whh4.data_ptr(), whh4.stride(0), whh4.stride(1),
            h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), *(ptr(r) for r in res), hT.data_ptr(), cT.data_ptr(),
            T, B, D, H, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel failed: {err_str(err).decode()} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    if residuals:
        return (hs, *res, hT, cT)
    return hs, (hT, cT)




def lstm_bwd_plain(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype=None):
    """Plain PyTorch version of the backward kernel: the loop over T,
    backwards, of the JAX ``_bwd_kernel``. ``ai, af, ao, ag, cs`` are the
    forward's residual streams ``[T, B, H]``, ``dhs`` the cotangent of
    ``hs``, ``dhT, dcT [B, H]`` those of the terminal carry. Under
    ``compute_dtype=torch.bfloat16`` each dp is rounded to bf16 before the
    product with ``W_hhᵀ`` (also bf16) and the product accumulates in f32.

    Returns ``(dp [T, B, 4H] at the stream dtype, gates i, f, o, g side by
    side; dh0, dc0 [B, H] f32)``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, H = cs.shape
    wT = whh4.to(sdt).float().transpose(1, 2)  # W_hh[k]ᵀ, as _bwd_call:243
    i, f, o, g, c = (a.float() for a in (ai, af, ao, ag, cs))
    dh_c, dc_c = dhT.float(), dcT.float()
    dp = torch.empty((T, B, 4 * H), dtype=sdt, device=cs.device)
    for t in range(T - 1, -1, -1):
        c_prev = c[t - 1] if t > 0 else c0.float()
        dh = dhs[t].float() + dh_c
        tc = torch.tanh(c[t])
        dc = dh * o[t] * (1 - tc * tc) + dc_c
        dps = (dc * g[t] * i[t] * (1 - i[t]), dc * c_prev * f[t] * (1 - f[t]),
               dh * tc * o[t] * (1 - o[t]), dc * i[t] * (1 - g[t] * g[t]))
        dp[t] = torch.cat(dps, -1).to(sdt)
        ops = [d.to(sdt).float() for d in dps]
        dh_c = (((ops[0] @ wT[0]) + ops[1] @ wT[1]) + ops[2] @ wT[2]) + ops[3] @ wT[3]
        dc_c = dc * f[t]
    return dp, dh_c, dc_c


def lstm_bwd_fused(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype=None):
    """LSTM backward through time in one kernel launch.

    Same arguments and returns as :func:`lstm_bwd_plain`. The streams must
    be contiguous at the stream dtype; ``dhs`` may be any view that is
    contiguous over H (the model layout hands over a transposed one).
    ``whh4`` is transposed once per call, outside the kernel."""
    if cs.device.type == "cpu":
        return lstm_bwd_plain(ai, af, ao, ag, cs, whh4, c0, dhs, dhT, dcT, compute_dtype)

    def check(cond, what):
        _check(cond, what, "lstm_bwd_fused")

    check(cs.device.type == "cuda", f"unsupported device {cs.device}")
    sdt = _stream_dtype(compute_dtype)
    check(cs.dim() == 3, f"cs must be [T, B, H], got {tuple(cs.shape)}")
    T, B, H = cs.shape
    streams = (ai, af, ao, ag, cs, dhs)
    check(all(tuple(a.shape) == (T, B, H) and a.dtype == sdt for a in streams),
          f"ai, af, ao, ag, cs and dhs must be [{T}, {B}, {H}] {sdt}")
    check(all(a.is_contiguous() for a in streams[:5]), "ai, af, ao, ag and cs must be contiguous")
    check(dhs.stride(-1) == 1, "dhs must be contiguous in its last axis")
    check(tuple(whh4.shape) == (4, H, H), f"whh4 must be [4, {H}, {H}], got {tuple(whh4.shape)}")
    carries = (c0, dhT, dcT)
    check(all(tuple(a.shape) == (B, H) and a.dtype == torch.float32 and a.is_contiguous()
              for a in carries), f"c0, dhT and dcT must be contiguous [{B}, {H}] float32")
    check(all(a.device == cs.device for a in streams + carries + (whh4,)),
          "all inputs must be on one device")
    wT = whh4.to(sdt).transpose(1, 2).contiguous()
    dp = torch.empty((T, B, 4 * H), dtype=sdt, device=cs.device)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=cs.device)
    dc0 = torch.empty_like(dh0)
    fn, err_str = _kernel("lstm_bwd")
    with torch.cuda.device(cs.device):
        err = fn(
            0 if sdt == torch.float32 else 1,
            *(a.data_ptr() for a in streams[:5]), wT.data_ptr(), wT.stride(0), wT.stride(1),
            c0.data_ptr(), dhs.data_ptr(), dhs.stride(0), dhs.stride(1),
            dhT.data_ptr(), dcT.data_ptr(), dp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            T, B, H, torch.cuda.current_stream(cs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_bwd kernel failed: {err_str(err).decode()} ({err})")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dp, dh0, dc0


def _site_weight(w, sites: int):
    """The one weight block behind a site-batched ``[S, ...]`` view; every
    site must hold the same values, which a stride-0 site axis proves."""
    if not sites:
        return w
    _check(w.shape[0] == sites and w.stride(0) == 0,
           f"site-batched weights must be [{sites}, ...] views of stride 0, got shape "
           f"{tuple(w.shape)} strides {w.stride()}", "LSTMRecurrence")
    return w[0]


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable fused recurrence: ``apply(x, wih4, b4, whh4, h0,
    c0, compute_dtype, use_kernel) -> (hs, hT, cT)``.

    Forward: K1 with ``residuals=True`` (or its plain version when
    ``use_kernel`` is False). Backward: K2 (or its plain version), then
    the products that JAX's ``_vjp_fused_bwd`` computes outside its kernel
    (``dx = dp·W_ihᵀ``, ``dW_ih = xᵀ·dp``, ``db = Σ dp``, ``dW_hh =
    h_prevᵀ·dp`` with ``h_prev = [h0; hs[:-1]]``), each accumulated in f32
    from operands rounded to the compute dtype.

    Site-batched weights ``[S, 4, D, H]``, ``[S, 4, H]``, ``[S, 4, H, H]``
    of stride 0 over S: ``x [T, S·B, D]`` holds site s in rows ``s·B ..
    (s+1)·B``, each kernel launches once over all rows with the one
    weight block, and the weight gradients are split by rows per site."""

    @staticmethod
    def forward(ctx, x, wih4, b4, whh4, h0, c0, compute_dtype=None, use_kernel=True):
        sites = wih4.shape[0] if wih4.dim() == 4 else 0
        wih, b, whh = (_site_weight(w, sites) for w in (wih4, b4, whh4))
        fwd = lstm_recurrence_fused if use_kernel else lstm_recurrence_plain
        hs, cs, i, f, o, g, hT, cT = fwd(x, wih, b, whh, h0, c0, compute_dtype, residuals=True)
        ctx.save_for_backward(x, wih, whh, h0, c0, hs, cs, i, f, o, g)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        x, wih, whh, h0, c0, hs, cs, i, f, o, g = ctx.saved_tensors
        cdt_ = ctx.compute_dtype
        sdt = _stream_dtype(cdt_)
        T, R, D = x.shape
        H = cs.shape[-1]
        # hs feeds the loss; hT and cT do not in the mean-pooled model
        dhs = torch.zeros_like(hs) if dhs is None else dhs.to(sdt)
        zero = torch.zeros((R, H), dtype=torch.float32, device=x.device)
        dhT = zero if dhT is None else dhT.float().contiguous()
        dcT = zero if dcT is None else dcT.float().contiguous()
        bwd = lstm_bwd_fused if ctx.use_kernel else lstm_bwd_plain
        dp, dh0, dc0 = bwd(i, f, o, g, cs, whh, c0, dhs, dhT, dcT, cdt_)

        # operands rounded to the compute dtype, products accumulated in f32
        # (the JAX einsums' preferred_element_type=f32)
        cdt = cdt_ if cdt_ is not None else x.dtype
        dpf = dp.to(cdt).float()
        dx = None
        if ctx.needs_input_grad[0]:
            wih_cat = wih.permute(1, 0, 2).reshape(D, 4 * H).to(cdt).float()
            dx = torch.matmul(dpf, wih_cat.T).to(x.dtype)
        xf = x.to(cdt).float()
        h_prev = torch.cat([h0[None].to(hs.dtype), hs[:-1]], 0).to(cdt).float()
        if ctx.sites:
            S = ctx.sites
            dpv, xv, hv = (a.reshape(T, S, R // S, -1) for a in (dpf, xf, h_prev))
            dwih = torch.einsum("tsbd,tsbg->sdg", xv, dpv).reshape(S, D, 4, H).transpose(1, 2)
            db = dpv.sum((0, 2)).reshape(S, 4, H)
            dwhh = torch.einsum("tsbh,tsbg->shg", hv, dpv).reshape(S, H, 4, H).transpose(1, 2)
        else:
            dwih = torch.einsum("tbd,tbg->dg", xf, dpf).reshape(D, 4, H).transpose(0, 1)
            db = dpf.sum((0, 1)).reshape(4, H)
            dwhh = torch.einsum("tbh,tbg->hg", h_prev, dpf).reshape(H, 4, H).transpose(0, 1)
        return dx, dwih, db, dwhh, dh0, dc0, None, None


class _SiteSum(torch.autograd.Function):
    """``a + b`` of two stride-0 site-batched views, as a stride-0 view:
    each site's sum is the same, so it is computed once; the backward hands
    every site its own cotangent, to both operands."""

    @staticmethod
    def forward(ctx, a, b):
        for w in (a, b):
            _site_weight(w, a.shape[0])
        return (a[0] + b[0]).expand_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, g


def site_sum(a, b):
    """The combined bias ``b_ih + b_hh`` of stride-0 site-batched views,
    kept of stride 0 so that :class:`LSTMRecurrence` takes it."""
    return _SiteSum.apply(a, b)


def _model_layout(use_kernel, x, w_ih, b, w_hh, h0, c0, compute_dtype):
    B, T, D = x.shape
    H = w_hh.shape[-2]
    lead = tuple(w_ih.shape[:-2])  # () or (S,) for site-batched weights
    in_dtype = x.dtype
    x = x.to(compute_dtype if compute_dtype is not None else torch.float32)
    wih4 = w_ih.float().reshape(*lead, D, 4, H).transpose(-3, -2)
    b4 = b.float().reshape(*lead, 4, H)
    whh4 = w_hh.float().reshape(*lead, H, 4, H).transpose(-3, -2)
    args = (x.transpose(0, 1), wih4, b4, whh4, h0.float().contiguous(), c0.float().contiguous())
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        hs, hT, cT = LSTMRecurrence.apply(*args, compute_dtype, use_kernel)
    else:
        sites = lead[0] if lead else 0
        fwd = lstm_recurrence_fused if use_kernel else lstm_recurrence_plain
        hs, (hT, cT) = fwd(args[0], *(_site_weight(w, sites) for w in args[1:4]), *args[4:],
                           compute_dtype)
    return hs.transpose(0, 1).to(in_dtype), (hT, cT)


def lstm_forward_fused(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """Model-layout wrapper over the fused recurrence.

    ``x [B, T, D]``, ``w_ih [D, 4H]``, ``b [4H]`` (``b_ih + b_hh``),
    ``w_hh [H, 4H]``, ``h0, c0 [B, H]``; the weights may carry a leading
    stride-0 site axis (:class:`LSTMRecurrence`). Returns ``(hs [B, T, H]
    at x's dtype, (hT, cT) f32)``. With gradients enabled it runs
    :class:`LSTMRecurrence` (K1 with residuals, K2 backward); without, K1
    alone. The gate blocks and the time-major input are passed as strided
    views: nothing is copied to change layout, and rows need no padding."""
    return _model_layout(True, x, w_ih, b, w_hh, h0, c0, compute_dtype)


def lstm_forward_plain(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """:func:`lstm_forward_fused` through the plain versions on any device:
    the reference that the card's kernel path is held against."""
    return _model_layout(False, x, w_ih, b, w_hh, h0, c0, compute_dtype)
