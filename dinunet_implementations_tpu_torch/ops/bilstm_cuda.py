"""The fused BIDIRECTIONAL LSTM recurrence, forward and backward, both
directions in one kernel launch: CUDA kernels for the card, their plain
PyTorch versions beside them.

Counterpart of the JAX package's ``ops/lstm_pallas.py`` bidirectional path
(``_fwd_bidir_kernel``, ``_bwd_bidir_kernel``, ``_fwd_pool_kernel4``,
``_bwd_pool_kernel4`` behind ``bilstm_recurrence_fused`` and
``bilstm_pool_fused_op``), with JAX's layouts:

- ``x [T, B, D]`` raw per-step inputs, shared by both directions: the
  reverse direction reads ``x[T-1-s]`` at its step ``s``; nothing is
  flipped;
- ``wih2 [2, 4, D, H]``, ``b2 [2, 4, H]`` (``b_ih + b_hh``), ``whh2 [2, 4,
  H, H]``, direction 0 forward and 1 reverse, gates i, f, o, g;
- ``h02, c02 [2, B, H]`` f32.

Every stream of both directions is stored in X-TIME: ``hs2[1, t]`` is the
reverse state after consuming ``x[T-1..t]``. The streams are ``[2, T, B,
H]``; the backward's gate cotangents are one ``[T, B, 8H]`` array (forward
gates, then reverse gates), the concat that ``dx`` and ``dW_ih`` take.

Kernels (``csrc/bilstm_fwd.cu``, ``csrc/bilstm_bwd.cu``) and launch counters:

- K3 :func:`bilstm_fwd_fused` (``BIDIR_FWD_LAUNCHES``): the forward;
- K5 :func:`bilstm_pool_fwd_fused` (``POOL_FWD_LAUNCHES``): the forward and
  the time-mean pool, summed in f32 from the f32 h inside the kernel;
- K4 :func:`bilstm_bwd_fused` (``BIDIR_BWD_LAUNCHES``): the backward, with
  a full cotangent stream or a per-row constant at the stream dtype;
- K6 :func:`bilstm_pool_bwd_fused` (``POOL_BWD_LAUNCHES``): the backward of
  the pool, its cotangent ``dpool / T`` a per-row f32 constant.

Each launches for CUDA tensors and raises on anything it does not take;
for CPU tensors, and only for them, it runs :func:`bilstm_fwd_plain` or
:func:`bilstm_bwd_plain`.

:class:`BiLSTMRecurrence` (the sequence-returning op) and
:class:`BiLSTMPool` (the pooled op) are the differentiable ops. They
dispatch as JAX's ``custom_vmap`` rules do: unbatched weights go to K3/K4;
weights with a leading site axis ``[S, ...]`` of stride 0 go to K5/K6 in
the pooled op (K3/K4 in the sequence op), the rows of ``x`` being ``S``
site-major blocks, and the weight gradients come back per site. Under
``compute_dtype=torch.bfloat16`` the two dispatches of the pooled op differ
by design, as in JAX: the unbatched pool is the f32 mean of the bf16 ``hs``
and its cotangent is cast to bf16; K5's pool is the f32 sum of the f32 h
and K6's cotangent stays f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lstm_cuda import _check, _site_weight, _stream_dtype

#: K3 launches since the counter was last set to 0
BIDIR_FWD_LAUNCHES = 0
#: K4 launches since the counter was last set to 0
BIDIR_BWD_LAUNCHES = 0
#: K5 launches since the counter was last set to 0
POOL_FWD_LAUNCHES = 0
#: K6 launches since the counter was last set to 0
POOL_BWD_LAUNCHES = 0

_entries: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FWD = [_I, _P, _L, _L, _P, _P, _P, _P, _P] + [_P] * 8
# (library, C entry) -> argument types
_ARGTYPES = {
    ("bilstm_fwd", "dn_bilstm_fwd"): _FWD + [_I, _I, _I, _I, _P],
    ("bilstm_fwd", "dn_bilstm_pool_fwd"): _FWD + [_P, _I, _I, _I, _I, _P],
    ("bilstm_bwd", "dn_bilstm_bwd"): [_I] + [_P] * 7 + [_P, _L, _L, _P, _L, _L]
    + [_P] * 5 + [_I, _I, _I, _P],
    ("bilstm_bwd", "dn_bilstm_pool_bwd"): [_I] + [_P] * 14 + [_I, _I, _I, _P],
}


def _kernel(lib_name: str, entry: str):
    """``(entry, error_string)`` of ``csrc/<lib_name>.cu``, built on first use."""
    key = (lib_name, entry)
    if key not in _entries:
        lib = _build.load(lib_name)
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[key]
        fn.restype = _I
        lib.dn_error_string.argtypes = [_I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entries[key] = (fn, lib.dn_error_string)
    return _entries[key]


def _launch(lib_name: str, entry: str, *args) -> None:
    fn, err_str = _kernel(lib_name, entry)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry} kernel failed: {err_str(err).decode()} ({err})")


# ---------------------------------------------------------------------------
# plain versions


def _direction_plain(x, wih4, b4, whh4, h0, c0, sdt, reverse: bool):
    """One direction's loop, the kernel's time map and casts: step ``s``
    consumes ``x[t]`` with ``t = T-1-s`` for the reverse direction and
    stores at ``t``. Returns the six f32 streams, the f32 carries and the
    f32 sum of h over the direction's own time."""
    T, B, D = x.shape
    H = wih4.shape[-1]
    wih = wih4.to(sdt).float().permute(1, 0, 2).reshape(D, 4 * H)
    whh = whh4.to(sdt).float().permute(1, 0, 2).reshape(H, 4 * H)
    xp = torch.matmul(x.to(sdt).float(), wih)  # [T, B, 4H]
    b = b4.float().reshape(4 * H)
    h, c = h0.float(), c0.float()
    total = torch.zeros_like(h)
    streams = [[None] * T for _ in range(6)]
    for s in range(T):
        t = T - 1 - s if reverse else s
        pre = xp[t] + torch.matmul(h.to(sdt).float(), whh) + b
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        o = torch.sigmoid(pre[:, 2 * H:3 * H])
        g = torch.tanh(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        total = total + h
        for st, v in zip(streams, (h, c, i, f, o, g)):
            st[t] = v
    return [torch.stack(st) for st in streams], h, c, total


def bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype=None, residuals=True,
                     pool=False):
    """Plain PyTorch version of K3 (and, with ``pool=True``, K5): both
    directions' loops over T with the kernels' time maps and casts. Under
    ``compute_dtype=torch.bfloat16`` the operands of both products are
    rounded to bf16 and the products accumulate in f32; the streams are
    bf16 and the carries f32.

    Returns ``(hs2, cs2, i2, f2, o2, g2, hT2, cT2)``: streams ``[2, T, B,
    H]`` at the stream dtype in x-time, carries ``[2, B, H]`` f32; with
    ``residuals=False`` only ``(hs2, (hT2, cT2))``. ``pool=True`` appends
    K5's ``pool [B, 2H]`` f32: each direction's f32 h summed over its own
    time, times ``1/T``."""
    sdt = _stream_dtype(compute_dtype)
    T, B, _ = x.shape
    dirs = [_direction_plain(x, wih2[d], b2[d], whh2[d], h02[d], c02[d], sdt, d == 1)
            for d in (0, 1)]
    streams = [torch.stack([dirs[0][0][k], dirs[1][0][k]]).to(sdt) for k in range(6)]
    hT2 = torch.stack([dirs[0][1], dirs[1][1]])
    cT2 = torch.stack([dirs[0][2], dirs[1][2]])
    if pool:
        sums = torch.cat([dirs[0][3], dirs[1][3]], -1)
        return (*streams, hT2, cT2, sums * (1.0 / T))
    if not residuals:
        return streams[0], (hT2, cT2)
    return (*streams, hT2, cT2)


def bilstm_bwd_plain(ai2, af2, ao2, ag2, cs2, whh2, c02, dhsf, dhsr, dhT2, dcT2,
                     compute_dtype=None):
    """Plain PyTorch version of K4 (and K6): each direction's loop over its
    own time, backwards, of the JAX ``_bwd_bidir_kernel``. ``ai2 .. cs2``
    are the forward's residual streams ``[2, T, B, H]`` in x-time;
    ``dhsf, dhsr`` the cotangents of ``hs2[0], hs2[1]``, each a ``[T, B,
    H]`` stream or a ``[1, B, H]`` per-row constant (K6: ``dpool / T`` in
    f32); ``dhT2, dcT2 [2, B, H]`` those of the terminal carries. Under
    ``compute_dtype=torch.bfloat16`` each dp is rounded to bf16 before the
    product with ``W_hhᵀ`` (also bf16) and the product accumulates in f32.

    Returns ``(dp [T, B, 8H] at the stream dtype: the forward direction's
    gates i, f, o, g, then the reverse direction's; dh02, dc02 [2, B, H]
    f32)``."""
    sdt = _stream_dtype(compute_dtype)
    _, T, B, H = cs2.shape
    dp = torch.empty((T, B, 8 * H), dtype=sdt, device=cs2.device)
    dh0, dc0 = [], []
    for d, dhs in enumerate((dhsf, dhsr)):
        wT = whh2[d].to(sdt).float().transpose(1, 2)  # W_hh[d, k]ᵀ
        i, f, o, g, c = (a[d].float() for a in (ai2, af2, ao2, ag2, cs2))
        dh_c, dc_c = dhT2[d].float(), dcT2[d].float()
        for s in range(T):
            t = s if d == 1 else T - 1 - s
            tp = t + 1 if d == 1 else t - 1  # one step earlier in the direction's own time
            c_prev = c[tp] if 0 <= tp < T else c02[d].float()
            dh = dhs[t if dhs.shape[0] == T else 0].float() + dh_c
            tc = torch.tanh(c[t])
            dc = dh * o[t] * (1 - tc * tc) + dc_c
            dps = (dc * g[t] * i[t] * (1 - i[t]), dc * c_prev * f[t] * (1 - f[t]),
                   dh * tc * o[t] * (1 - o[t]), dc * i[t] * (1 - g[t] * g[t]))
            dp[t, :, 4 * H * d:4 * H * (d + 1)] = torch.cat(dps, -1).to(sdt)
            ops = [v.to(sdt).float() for v in dps]
            dh_c = (((ops[0] @ wT[0]) + ops[1] @ wT[1]) + ops[2] @ wT[2]) + ops[3] @ wT[3]
            dc_c = dc * f[t]
        dh0.append(dh_c)
        dc0.append(dc_c)
    return dp, torch.stack(dh0), torch.stack(dc0)


# ---------------------------------------------------------------------------
# kernel wrappers


def _fwd_checks(fn, x, wih2, b2, whh2, h02, c02, compute_dtype):
    """Validates a forward call; returns ``(sdt, x, wih2, b2, whh2, T, B, D,
    H)`` with the weights at the stream dtype and contiguous."""

    def check(cond, what):
        _check(cond, what, fn)

    check(x.device.type == "cuda", f"unsupported device {x.device}")
    sdt = _stream_dtype(compute_dtype)
    if compute_dtype is None:
        check(all(a.dtype == torch.float32 for a in (x, wih2, whh2)),
              "x, wih2 and whh2 must be float32 when compute_dtype is None")
    check(all(a.dtype == torch.float32 for a in (b2, h02, c02)), "b2, h02 and c02 must be float32")
    check(x.dim() == 3, f"x must be [T, B, D], got {tuple(x.shape)}")
    T, B, D = x.shape
    H = wih2.shape[-1]
    check(T >= 1 and B >= 1, "x needs at least one step and one row")
    check(tuple(wih2.shape) == (2, 4, D, H), f"wih2 must be [2, 4, {D}, {H}], got {tuple(wih2.shape)}")
    check(tuple(b2.shape) == (2, 4, H), f"b2 must be [2, 4, {H}], got {tuple(b2.shape)}")
    check(tuple(whh2.shape) == (2, 4, H, H), f"whh2 must be [2, 4, {H}, {H}], got {tuple(whh2.shape)}")
    check(tuple(h02.shape) == (2, B, H) and tuple(c02.shape) == (2, B, H),
          f"h02 and c02 must be [2, {B}, {H}]")
    check(all(a.device == x.device for a in (wih2, b2, whh2, h02, c02)),
          "all inputs must be on one device")
    check(x.stride(-1) == 1, "x must be contiguous in its last axis")
    check(h02.is_contiguous() and c02.is_contiguous(), "h02 and c02 must be contiguous")
    # the weights are small (2.4 MB at the flagship): one contiguous copy at
    # the stream dtype per call
    return (sdt, x.to(sdt), wih2.to(sdt).contiguous(), b2.contiguous(),
            whh2.to(sdt).contiguous(), T, B, D, H)


def _fwd_outputs(sdt, T, B, H, device, residuals):
    def stream():
        return torch.empty((2, T, B, H), dtype=sdt, device=device)

    hs2 = stream()
    res = [stream() for _ in range(5)] if residuals else [None] * 5
    hT2 = torch.empty((2, B, H), dtype=torch.float32, device=device)
    return hs2, res, hT2, torch.empty_like(hT2)


def _ptr(a):
    return None if a is None else a.data_ptr()


def bilstm_fwd_fused(x, wih2, b2, whh2, h02, c02, compute_dtype=None, residuals=True):
    """K3: both directions' forward in one launch. Same arguments and
    returns as :func:`bilstm_fwd_plain` (without ``pool``). ``x`` may be a
    strided view (any strides over T and B, contiguous over D); the
    residual streams are written only when ``residuals=True``; ``hT2, cT2``
    come from the kernel's f32 carries, never from the stream dtype."""
    if x.device.type == "cpu":
        return bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype, residuals)
    sdt, x, wih2, b2, whh2, T, B, D, H = _fwd_checks(
        "bilstm_fwd_fused", x, wih2, b2, whh2, h02, c02, compute_dtype)
    hs2, res, hT2, cT2 = _fwd_outputs(sdt, T, B, H, x.device, residuals)
    with torch.cuda.device(x.device):
        _launch("bilstm_fwd", "dn_bilstm_fwd", 0 if sdt == torch.float32 else 1,
                x.data_ptr(), x.stride(0), x.stride(1), wih2.data_ptr(), b2.data_ptr(),
                whh2.data_ptr(), h02.data_ptr(), c02.data_ptr(), hs2.data_ptr(),
                *(_ptr(r) for r in res), hT2.data_ptr(), cT2.data_ptr(), T, B, D, H,
                torch.cuda.current_stream(x.device).cuda_stream)
    global BIDIR_FWD_LAUNCHES
    BIDIR_FWD_LAUNCHES += 1
    if residuals:
        return (hs2, *res, hT2, cT2)
    return hs2, (hT2, cT2)


def bilstm_pool_fwd_fused(x, wih2, b2, whh2, h02, c02, compute_dtype=None):
    """K5: K3 with every residual stream, plus the time-mean pool summed in
    f32 inside the kernel. Same arguments and returns as
    :func:`bilstm_fwd_plain` with ``pool=True``: ``(hs2, cs2, i2, f2, o2,
    g2, hT2, cT2, pool [B, 2H] f32)``."""
    if x.device.type == "cpu":
        return bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, compute_dtype, pool=True)
    sdt, x, wih2, b2, whh2, T, B, D, H = _fwd_checks(
        "bilstm_pool_fwd_fused", x, wih2, b2, whh2, h02, c02, compute_dtype)
    hs2, res, hT2, cT2 = _fwd_outputs(sdt, T, B, H, x.device, True)
    pool = torch.empty((B, 2 * H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("bilstm_fwd", "dn_bilstm_pool_fwd", 0 if sdt == torch.float32 else 1,
                x.data_ptr(), x.stride(0), x.stride(1), wih2.data_ptr(), b2.data_ptr(),
                whh2.data_ptr(), h02.data_ptr(), c02.data_ptr(), hs2.data_ptr(),
                *(r.data_ptr() for r in res), hT2.data_ptr(), cT2.data_ptr(), pool.data_ptr(),
                T, B, D, H, torch.cuda.current_stream(x.device).cuda_stream)
    global POOL_FWD_LAUNCHES
    POOL_FWD_LAUNCHES += 1
    return (hs2, *res, hT2, cT2, pool)


def _bwd_checks(fn, streams, whh2, c02, dhT2, dcT2, compute_dtype):
    """Validates a backward call; returns ``(sdt, T, B, H, W_hhᵀ [2, 4, H,
    H] contiguous at the stream dtype)``."""

    def check(cond, what):
        _check(cond, what, fn)

    cs2 = streams[4]
    check(cs2.device.type == "cuda", f"unsupported device {cs2.device}")
    sdt = _stream_dtype(compute_dtype)
    check(cs2.dim() == 4 and cs2.shape[0] == 2, f"cs2 must be [2, T, B, H], got {tuple(cs2.shape)}")
    _, T, B, H = cs2.shape
    check(all(tuple(a.shape) == (2, T, B, H) and a.dtype == sdt and a.is_contiguous()
              for a in streams), f"ai2, af2, ao2, ag2 and cs2 must be contiguous [2, {T}, {B}, {H}] {sdt}")
    check(tuple(whh2.shape) == (2, 4, H, H), f"whh2 must be [2, 4, {H}, {H}], got {tuple(whh2.shape)}")
    carries = (c02, dhT2, dcT2)
    check(all(tuple(a.shape) == (2, B, H) and a.dtype == torch.float32 and a.is_contiguous()
              for a in carries), f"c02, dhT2 and dcT2 must be contiguous [2, {B}, {H}] float32")
    check(all(a.device == cs2.device for a in streams + carries + (whh2,)),
          "all inputs must be on one device")
    return sdt, T, B, H, whh2.to(sdt).transpose(2, 3).contiguous()


def _bwd_outputs(sdt, T, B, H, device):
    dp = torch.empty((T, B, 8 * H), dtype=sdt, device=device)
    dh02 = torch.empty((2, B, H), dtype=torch.float32, device=device)
    return dp, dh02, torch.empty_like(dh02)


def bilstm_bwd_fused(ai2, af2, ao2, ag2, cs2, whh2, c02, dhsf, dhsr, dhT2, dcT2,
                     compute_dtype=None):
    """K4: both directions' backward in one launch. Same arguments and
    returns as :func:`bilstm_bwd_plain`. ``dhsf, dhsr`` are at the stream
    dtype, each a ``[T, B, H]`` view contiguous over H or a ``[1, B, H]``
    per-row constant (read at every step, never broadcast in memory)."""
    streams = (ai2, af2, ao2, ag2, cs2)
    if cs2.device.type == "cpu":
        return bilstm_bwd_plain(*streams, whh2, c02, dhsf, dhsr, dhT2, dcT2, compute_dtype)
    sdt, T, B, H, wT = _bwd_checks("bilstm_bwd_fused", streams, whh2, c02, dhT2, dcT2,
                                   compute_dtype)
    for name, d in (("dhsf", dhsf), ("dhsr", dhsr)):
        _check(d.dim() == 3 and d.shape[0] in (1, T) and tuple(d.shape[1:]) == (B, H)
               and d.dtype == sdt and d.stride(-1) == 1 and d.device == cs2.device,
               f"{name} must be [{T} or 1, {B}, {H}] {sdt}, contiguous in its last axis",
               "bilstm_bwd_fused")

    def time_stride(d):
        return d.stride(0) if d.shape[0] == T and T > 1 else 0

    dp, dh02, dc02 = _bwd_outputs(sdt, T, B, H, cs2.device)
    with torch.cuda.device(cs2.device):
        _launch("bilstm_bwd", "dn_bilstm_bwd", 0 if sdt == torch.float32 else 1,
                *(a.data_ptr() for a in streams), wT.data_ptr(), c02.data_ptr(),
                dhsf.data_ptr(), time_stride(dhsf), dhsf.stride(1),
                dhsr.data_ptr(), time_stride(dhsr), dhsr.stride(1),
                dhT2.data_ptr(), dcT2.data_ptr(), dp.data_ptr(), dh02.data_ptr(),
                dc02.data_ptr(), T, B, H, torch.cuda.current_stream(cs2.device).cuda_stream)
    global BIDIR_BWD_LAUNCHES
    BIDIR_BWD_LAUNCHES += 1
    return dp, dh02, dc02


def bilstm_pool_bwd_fused(ai2, af2, ao2, ag2, cs2, whh2, c02, dpoolf, dpoolr, dhT2, dcT2,
                          compute_dtype=None):
    """K6: the backward of the time-mean pool, both directions in one
    launch. ``dpoolf, dpoolr [B, H]`` f32 are the pool's cotangent already
    divided by T, a per-row constant at every step (kept in f32 at any
    stream dtype). Returns as :func:`bilstm_bwd_plain`."""
    streams = (ai2, af2, ao2, ag2, cs2)
    if cs2.device.type == "cpu":
        return bilstm_bwd_plain(*streams, whh2, c02, dpoolf[None], dpoolr[None], dhT2, dcT2,
                                compute_dtype)
    sdt, T, B, H, wT = _bwd_checks("bilstm_pool_bwd_fused", streams, whh2, c02, dhT2, dcT2,
                                   compute_dtype)
    _check(all(tuple(d.shape) == (B, H) and d.dtype == torch.float32 and d.is_contiguous()
               and d.device == cs2.device for d in (dpoolf, dpoolr)),
           f"dpoolf and dpoolr must be contiguous [{B}, {H}] float32", "bilstm_pool_bwd_fused")
    dp, dh02, dc02 = _bwd_outputs(sdt, T, B, H, cs2.device)
    with torch.cuda.device(cs2.device):
        _launch("bilstm_bwd", "dn_bilstm_pool_bwd", 0 if sdt == torch.float32 else 1,
                *(a.data_ptr() for a in streams), wT.data_ptr(), c02.data_ptr(),
                dpoolf.data_ptr(), dpoolr.data_ptr(), dhT2.data_ptr(), dcT2.data_ptr(),
                dp.data_ptr(), dh02.data_ptr(), dc02.data_ptr(), T, B, H,
                torch.cuda.current_stream(cs2.device).cuda_stream)
    global POOL_BWD_LAUNCHES
    POOL_BWD_LAUNCHES += 1
    return dp, dh02, dc02


# ---------------------------------------------------------------------------
# the differentiable ops


def _weight_grads(needs_dx, x, wih2, hs2, h02, dp, compute_dtype, sites):
    """The products that JAX's ``_bidir_weight_grads`` computes outside its
    kernels, from the backward's ``dp [T, R, 8H]`` (both directions in
    x-time): ``dx`` and ``dW_ih`` as single products against the 8H concat,
    ``db`` its sum, ``dW_hh`` per direction against ``h_prev`` in x-time
    (forward ``[h0; hs[:-1]]``, reverse ``[hs[1:]; h0]``), each accumulated
    in f32 from operands rounded to the compute dtype. With ``sites`` the
    rows are ``S`` site-major blocks and the weight gradients come back per
    site ``[S, ...]``."""
    T, R, D = x.shape
    H = hs2.shape[-1]
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    dpf = dp.to(cdt).float()
    dx = None
    if needs_dx:
        w_cat8 = torch.cat([wih2[d].permute(1, 0, 2).reshape(D, 4 * H) for d in (0, 1)], -1)
        dx = torch.matmul(dpf, w_cat8.to(cdt).float().T).to(x.dtype)
    xf = x.to(cdt).float()
    h_prev = torch.stack([
        torch.cat([h02[0][None].to(hs2.dtype), hs2[0, :-1]], 0),
        torch.cat([hs2[1, 1:], h02[1][None].to(hs2.dtype)], 0),
    ]).to(cdt).float()  # [2, T, R, H]
    if sites:
        S = sites
        xv, dpv = xf.reshape(T, S, R // S, D), dpf.reshape(T, S, R // S, 8 * H)
        dwih = torch.einsum("tsbd,tsbg->sdg", xv, dpv).reshape(S, D, 2, 4, H).permute(0, 2, 3, 1, 4)
        db = dpv.sum((0, 2)).reshape(S, 2, 4, H)
        dwhh = torch.einsum("dtsbh,tsbdg->sdhg", h_prev.reshape(2, T, S, R // S, H),
                            dpv.reshape(T, S, R // S, 2, 4 * H))
        dwhh = dwhh.reshape(S, 2, H, 4, H).permute(0, 1, 3, 2, 4)
    else:
        dwih = torch.einsum("tbd,tbg->dg", xf, dpf).reshape(D, 2, 4, H).permute(1, 2, 0, 3)
        db = dpf.sum((0, 1)).reshape(2, 4, H)
        dwhh = torch.einsum("dtbh,tbdg->dhg", h_prev, dpf.reshape(T, R, 2, 4 * H))
        dwhh = dwhh.reshape(2, H, 4, H).permute(0, 2, 1, 3)
    return dx, dwih, db, dwhh


def _sites_of(wih2) -> int:
    return wih2.shape[0] if wih2.dim() == 5 else 0


def _blocks(sites, wih2, b2, whh2):
    return tuple(_site_weight(w, sites) for w in (wih2, b2, whh2))


class BiLSTMRecurrence(torch.autograd.Function):
    """The sequence-returning op, JAX's ``bilstm_recurrence_fused``:
    ``apply(x [T, R, D], wih2, b2, whh2, h02, c02, compute_dtype,
    use_kernel) -> (hs_f, hs_r [T, R, H] in x-time, hT2, cT2)``.

    Forward: K3 with its residual streams (its plain version when
    ``use_kernel`` is False); backward: K4 with both cotangent streams, then
    the weight-gradient products (``_vjp_bidir_bwd``). Site-batched weights
    ``[S, 2, ...]`` of stride 0 fold the sites into the kernels' rows (the
    JAX ``custom_vmap`` fold) and get per-site gradients."""

    @staticmethod
    def forward(ctx, x, wih2, b2, whh2, h02, c02, compute_dtype=None, use_kernel=True):
        sites = _sites_of(wih2)
        wih, b, whh = _blocks(sites, wih2, b2, whh2)
        fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
        hs2, cs2, i2, f2, o2, g2, hT2, cT2 = fwd(x, wih, b, whh, h02, c02, compute_dtype)
        ctx.save_for_backward(x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return hs2[0], hs2[1], hT2, cT2

    @staticmethod
    def backward(ctx, dhsf, dhsr, dhT2, dcT2):
        x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2 = ctx.saved_tensors
        sdt = _stream_dtype(ctx.compute_dtype)
        zero = torch.zeros_like(h02)

        def stream_cot(d):
            if d is None:
                return torch.zeros_like(hs2[0])
            d = d.to(sdt)
            return d if d.stride(-1) == 1 else d.contiguous()

        bwd = bilstm_bwd_fused if ctx.use_kernel else bilstm_bwd_plain
        dp, dh02, dc02 = bwd(i2, f2, o2, g2, cs2, whh, c02, stream_cot(dhsf), stream_cot(dhsr),
                             zero if dhT2 is None else dhT2.float().contiguous(),
                             zero if dcT2 is None else dcT2.float().contiguous(),
                             ctx.compute_dtype)
        dx, dwih, db, dwhh = _weight_grads(ctx.needs_input_grad[0], x, wih, hs2, h02, dp,
                                           ctx.compute_dtype, ctx.sites)
        return dx, dwih, db, dwhh, dh02, dc02, None, None


def _pool_forward(x, wih, b, whh, h02, c02, compute_dtype, use_kernel, sites, residuals):
    """The pooled op's forward, dispatched as JAX's ``_pool_fwd_kcall``:
    K5 for site-batched weights (the pool from the kernel's f32 sums), K3
    otherwise (the pool the f32 mean of the stream-dtype ``hs``). Returns
    ``(pooled [R, 2H] f32, hT2, cT2, streams or None)``."""
    if sites:
        args = (x, wih, b, whh, h02, c02, compute_dtype)
        *streams, hT2, cT2, pooled = (bilstm_pool_fwd_fused(*args) if use_kernel
                                      else bilstm_fwd_plain(*args, pool=True))
        return pooled, hT2, cT2, streams
    fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
    out = fwd(x, wih, b, whh, h02, c02, compute_dtype, residuals)
    if residuals:
        *streams, hT2, cT2 = out
        hs2 = streams[0]
    else:
        (hs2, (hT2, cT2)), streams = out, None
    pooled = hs2.mean(1, dtype=torch.float32)  # [2, R, H]
    return torch.cat([pooled[0], pooled[1]], -1), hT2, cT2, streams


class BiLSTMPool(torch.autograd.Function):
    """The pooled op, JAX's ``bilstm_pool_fused_op``: ``apply(x [T, R, D],
    wih2, b2, whh2, h02, c02, compute_dtype, use_kernel) -> (pooled [R, 2H]
    f32, hT2, cT2)``, ``pooled`` the concat of each direction's time mean.

    Unbatched weights: K3 forward and K4 backward with the cotangent
    ``dpool / T`` cast to the stream dtype as a per-row constant.
    Site-batched weights ``[S, 2, ...]`` of stride 0: K5 forward and K6
    backward with ``dpool / T`` in f32, per-site weight gradients. The
    plain versions replace the kernels when ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, wih2, b2, whh2, h02, c02, compute_dtype=None, use_kernel=True):
        sites = _sites_of(wih2)
        wih, b, whh = _blocks(sites, wih2, b2, whh2)
        pooled, hT2, cT2, streams = _pool_forward(x, wih, b, whh, h02, c02, compute_dtype,
                                                  use_kernel, sites, True)
        ctx.save_for_backward(x, wih, whh, h02, c02, *streams)
        ctx.compute_dtype, ctx.use_kernel, ctx.sites = compute_dtype, use_kernel, sites
        return pooled, hT2, cT2

    @staticmethod
    def backward(ctx, dpooled, dhT2, dcT2):
        x, wih, whh, h02, c02, hs2, cs2, i2, f2, o2, g2 = ctx.saved_tensors
        T, H = x.shape[0], hs2.shape[-1]
        zero = torch.zeros_like(h02)
        if dpooled is None:
            dpooled = torch.zeros((x.shape[1], 2 * H), dtype=torch.float32, device=x.device)
        dpoolf = (dpooled[:, :H].float() / T).contiguous()
        dpoolr = (dpooled[:, H:].float() / T).contiguous()
        carries = (zero if dhT2 is None else dhT2.float().contiguous(),
                   zero if dcT2 is None else dcT2.float().contiguous())
        streams = (i2, f2, o2, g2, cs2)
        cdt = ctx.compute_dtype
        if ctx.sites and ctx.use_kernel:  # K6: the constant stays f32
            dp, dh02, dc02 = bilstm_pool_bwd_fused(*streams, whh, c02, dpoolf, dpoolr, *carries,
                                                   cdt)
        else:  # K4, or a plain version: the constant [1, R, H]
            if not ctx.sites:  # K4's constant is at the stream dtype
                sdt = _stream_dtype(cdt)
                dpoolf, dpoolr = dpoolf.to(sdt), dpoolr.to(sdt)
            bwd = bilstm_bwd_fused if ctx.use_kernel else bilstm_bwd_plain
            dp, dh02, dc02 = bwd(*streams, whh, c02, dpoolf[None], dpoolr[None], *carries, cdt)
        dx, dwih, db, dwhh = _weight_grads(ctx.needs_input_grad[0], x, wih, hs2, h02, dp, cdt,
                                           ctx.sites)
        return dx, dwih, db, dwhh, dh02, dc02, None, None


class _StackDirections(torch.autograd.Function):
    """One weight of both directions in model layout (``[..., 4H]``, the
    gate blocks side by side, optionally a stride-0 site axis ``[S, ...]``)
    → JAX's stacked layout ``[(S,) 2, 4, ..., H]``. Only the one block of
    each direction is stacked; the site axis stays stride 0. The backward
    hands each direction its (per-site) gradient in model layout."""

    @staticmethod
    def forward(ctx, w_f, w_r, sites):
        blocks = [_site_weight(w, sites) for w in (w_f, w_r)]
        lead, H = tuple(blocks[0].shape[:-1]), blocks[0].shape[-1] // 4
        st = torch.stack([b.float().reshape(*lead, 4, H).movedim(-2, 0) for b in blocks])
        ctx.sites = sites
        return st.expand(sites, *st.shape) if sites else st

    @staticmethod
    def backward(ctx, g):
        off = 1 if ctx.sites else 0
        out = []
        for d in (0, 1):
            gd = g.select(off, d).movedim(off, -2)  # [(S,) ..., 4, H]
            out.append(gd.reshape(*gd.shape[:-2], -1))
        return out[0], out[1], None


def _model_layout(op, use_kernel, x, params_fwd, params_rev, h02, c02, compute_dtype):
    """``x [B, T, D]``; ``params_*``: ``(w_ih [D, 4H], b [4H], w_hh [H,
    4H])``, each optionally site-batched ``[S, ...]`` of stride 0."""
    B, T, D = x.shape
    H = params_fwd[2].shape[-2]
    sites = params_fwd[0].shape[0] if params_fwd[0].dim() == 3 else 0
    wih2, b2, whh2 = (_StackDirections.apply(f, r, sites) for f, r in zip(params_fwd, params_rev))
    zeros = torch.zeros((2, B, H), dtype=torch.float32, device=x.device)
    h02 = zeros if h02 is None else h02.float().contiguous()
    c02 = zeros if c02 is None else c02.float().contiguous()
    xk = x.to(compute_dtype if compute_dtype is not None else torch.float32).transpose(0, 1)
    args = (xk, wih2, b2, whh2, h02, c02)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if op == "pool":
        if grad:
            pooled, hT2, cT2 = BiLSTMPool.apply(*args, compute_dtype, use_kernel)
        else:  # inference: no residual streams
            blocks = _blocks(sites, wih2, b2, whh2)
            pooled, hT2, cT2, _ = _pool_forward(xk, *blocks, h02, c02, compute_dtype, use_kernel,
                                                sites, False)
        return pooled, (hT2, cT2)
    if grad:
        hsf, hsr, hT2, cT2 = BiLSTMRecurrence.apply(*args, compute_dtype, use_kernel)
    else:
        fwd = bilstm_fwd_fused if use_kernel else bilstm_fwd_plain
        hs2, (hT2, cT2) = fwd(xk, *_blocks(sites, wih2, b2, whh2), h02, c02, compute_dtype,
                              residuals=False)
        hsf, hsr = hs2[0], hs2[1]
    return hsf.transpose(0, 1).to(x.dtype), hsr.transpose(0, 1).to(x.dtype), (hT2, cT2)


def bilstm_forward_fused(x, params_fwd, params_rev, h02=None, c02=None, compute_dtype=None):
    """Model-layout wrapper over :class:`BiLSTMRecurrence` (JAX's
    ``bilstm_forward_fused``): ``x [B, T, D]``, ``params_fwd / params_rev =
    (w_ih [D, 4H], b [4H] = b_ih + b_hh, w_hh [H, 4H])``, optionally
    site-batched ``[S, ...]`` of stride 0; ``h02, c02 [2, B, H]`` (zeros by
    default). Returns ``(hs_f [B, T, H], hs_r [B, T, H] in x-time, (hT2,
    cT2) [2, B, H] f32)`` at x's dtype. Without gradients, K3 alone."""
    return _model_layout("seq", True, x, params_fwd, params_rev, h02, c02, compute_dtype)


def bilstm_pool_forward_fused(x, params_fwd, params_rev, h02=None, c02=None,
                              compute_dtype=None):
    """Model-layout wrapper over :class:`BiLSTMPool` (JAX's
    ``bilstm_pool_forward_fused``), arguments as
    :func:`bilstm_forward_fused`. Returns ``(pooled [B, 2H] f32, (hT2, cT2)
    [2, B, H] f32)``. Unbatched weights run K3 (and K4 backward),
    site-batched ones K5 and K6; without gradients the unbatched forward
    writes no residual streams."""
    return _model_layout("pool", True, x, params_fwd, params_rev, h02, c02, compute_dtype)


def bilstm_pool_forward_plain(x, params_fwd, params_rev, h02=None, c02=None,
                              compute_dtype=None):
    """:func:`bilstm_pool_forward_fused` through the plain versions on any
    device: the reference that the card's kernel path is held against."""
    return _model_layout("pool", False, x, params_fwd, params_rev, h02, c02, compute_dtype)
