"""The fused LSTM recurrence: a CUDA kernel for the card, its plain PyTorch
version beside it.

Counterpart of the JAX package's ``ops/lstm_pallas.py`` forward path
(``_fwd_fused_kernel`` behind ``lstm_recurrence_fused`` and
``lstm_forward_fused``), with the same signatures and layouts:

- ``x [T, B, D]`` raw per-step inputs: the i2h projection runs inside the
  kernel, as on the TPU;
- ``wih4 [4, D, H]``, ``b4 [4, H]``, ``whh4 [4, H, H]``, gates in the order
  i, f, o, g (not ``torch.nn.LSTM``'s i, f, g, o);
- ``h0, c0 [B, H]`` f32.

The kernel source is ``csrc/lstm_fwd.cu``. :func:`lstm_recurrence_fused`
launches it for CUDA tensors and raises on anything it does not take; for
CPU tensors, and only for them, it runs :func:`lstm_recurrence_plain`.
``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the counter was last set to 0
LAUNCHES = 0

_entry = None


def _kernel():
    global _entry
    if _entry is None:
        lib = _build.load("lstm_fwd")
        fn = lib.dn_lstm_fwd
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, P, L, L, P, L, P, L, L, P, P,
                       P, P, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
        lib.dn_error_string.argtypes = [I]
        lib.dn_error_string.restype = ctypes.c_char_p
        _entry = (fn, lib.dn_error_string)
    return _entry


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


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"lstm_recurrence_fused: {what}")


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
    fn, err_str = _kernel()
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


def _model_layout(recurrence, x, w_ih, b, w_hh, h0, c0, compute_dtype):
    B, T, D = x.shape
    H = w_hh.shape[0]
    in_dtype = x.dtype
    x = x.to(compute_dtype if compute_dtype is not None else torch.float32)
    wih4 = w_ih.float().reshape(D, 4, H).permute(1, 0, 2)
    b4 = b.float().reshape(4, H)
    whh4 = w_hh.float().reshape(H, 4, H).permute(1, 0, 2)
    hs, (hT, cT) = recurrence(
        x.transpose(0, 1), wih4, b4, whh4,
        h0.float().contiguous(), c0.float().contiguous(), compute_dtype,
    )
    return hs.transpose(0, 1).to(in_dtype), (hT, cT)


def lstm_forward_fused(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """Model-layout wrapper over :func:`lstm_recurrence_fused`.

    ``x [B, T, D]``, ``w_ih [D, 4H]``, ``b [4H]`` (``b_ih + b_hh``),
    ``w_hh [H, 4H]``, ``h0, c0 [B, H]``. Returns ``(hs [B, T, H] at x's
    dtype, (hT, cT) f32)``. The gate blocks and the time-major input are
    passed as strided views: nothing is copied to change layout, and rows
    need no padding."""
    return _model_layout(lstm_recurrence_fused, x, w_ih, b, w_hh, h0, c0, compute_dtype)


def lstm_forward_plain(x, w_ih, b, w_hh, h0, c0, compute_dtype=None):
    """:func:`lstm_forward_fused` through the plain version on any device:
    the reference that the card's kernel path is held against."""
    return _model_layout(lstm_recurrence_plain, x, w_ih, b, w_hh, h0, c0, compute_dtype)
