"""The port's LSTM backward (ops/lstm_cuda.py: lstm_bwd_plain and the
LSTMRecurrence autograd Function) against the JAX package's backward
kernel, which runs in Pallas interpret mode on the CPU, and against the
JAX custom_vjp and its custom_vmap fold over sites.

On the CPU the port's wrappers run their plain versions; the CUDA kernel
is held against the plain version on the card by chip_smoke.py. Inputs are
made with numpy from a seed and fed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.ops import lstm_pallas as jl
from dinunet_implementations_tpu_torch.ops import lstm_cuda as tl

# f32: the two frameworks sum the H-term products in different orders, and
# the difference compounds over the reversed recurrence
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: dp is rounded to bf16 before the recurrent product, so a last-bit
# difference (2**-8 relative) in one dp moves the carries of earlier steps
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
# weight gradients sum T·B products of values of order 1; the f32 sums are
# taken in different orders
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)

SHAPES = [(5, 3, 8, 6), (7, 16, 16, 12), (4, 1, 5, 7)]  # T, B, D, H


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))  # a writable copy


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(_f32(a)).to(dtype)


def _bwd_inputs(T, B, D, H, cdt, seed):
    """Residual streams from the JAX forward kernel at ``cdt``, and random
    cotangents; ``dhs`` is at the stream dtype as the forward's ``hs``."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x, wih4, b4, whh4 = f(T, B, D), f(4, D, H, scale=0.4), f(4, H, scale=0.2), f(4, H, H, scale=0.4)
    h0, c0 = f(B, H, scale=0.5), f(B, H, scale=0.5)
    outs = jl._fwd_fused_callable(cdt)(*map(jnp.asarray, (x, wih4, b4, whh4, h0, c0)))
    sdt = jnp.bfloat16 if cdt else jnp.float32
    acts_cs = [outs[k] for k in (2, 3, 4, 5, 1)]  # i, f, o, g, cs
    dhs = jnp.asarray(f(T, B, H), sdt)
    return acts_cs, jnp.asarray(whh4), jnp.asarray(c0), dhs, jnp.asarray(f(B, H)), jnp.asarray(f(B, H))


@pytest.mark.parametrize("cdt,tol", [(None, F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("T,B,D,H", SHAPES)
def test_bwd_plain_matches_pallas_all_six_outputs(T, B, D, H, cdt, tol):
    acts_cs, whh4, c0, dhs, dhT, dcT = _bwd_inputs(T, B, D, H, cdt, seed=T + B)
    want = jl._bwd_callable(cdt)(*acts_cs, whh4, c0, dhs, dhT, dcT)
    tdt = torch.bfloat16 if cdt else torch.float32
    dp, dh0, dc0 = tl.lstm_bwd_plain(
        *(_to_torch(a, tdt) for a in acts_cs), _to_torch(whh4), _to_torch(c0),
        _to_torch(dhs, tdt), _to_torch(dhT), _to_torch(dcT),
        compute_dtype=torch.bfloat16 if cdt else None)
    assert dp.shape == (T, B, 4 * H) and dp.dtype == tdt
    assert dh0.dtype == dc0.dtype == torch.float32
    got = [dp[..., k * H:(k + 1) * H] for k in range(4)] + [dh0, dc0]
    for name, g, w in zip(("dp_i", "dp_f", "dp_o", "dp_g", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.float().numpy(), _f32(w), err_msg=name, **tol)


def test_bwd_plain_is_the_gradient_of_the_plain_forward():
    """An oracle independent of JAX: autograd through the plain forward loop."""
    T, B, D, H = 6, 4, 5, 7
    rng = np.random.default_rng(3)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))  # noqa: E731
    x, wih4, b4, whh4 = f(T, B, D), f(4, D, H, scale=0.4), f(4, H, scale=0.2), f(4, H, H, scale=0.4)
    h0, c0 = f(B, H, scale=0.5), f(B, H, scale=0.5).requires_grad_()
    h0.requires_grad_()
    dhs, dhT, dcT = f(T, B, H), f(B, H), f(B, H)
    hs, cs, i, fg, o, g, hT, cT = tl.lstm_recurrence_plain(x, wih4, b4, whh4, h0, c0, residuals=True)
    want = torch.autograd.grad((hs, hT, cT), (h0, c0), (dhs, dhT, dcT))
    with torch.no_grad():
        _, dh0, dc0 = tl.lstm_bwd_plain(i, fg, o, g, cs, whh4, c0, dhs, dhT, dcT)
    torch.testing.assert_close(dh0, want[0], **F32_TOL)
    torch.testing.assert_close(dc0, want[1], **F32_TOL)


@pytest.mark.parametrize("cdt,tol", [(None, GRAD_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("T,B,D,H", SHAPES[:2])
def test_recurrence_gradients_match_jax_vjp(T, B, D, H, cdt, tol):
    rng = np.random.default_rng(T * B)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    args = (f(T, B, D), f(4, D, H, scale=0.4), f(4, H, scale=0.2), f(4, H, H, scale=0.4),
            f(B, H, scale=0.5), f(B, H, scale=0.5))
    sdt = jnp.bfloat16 if cdt else jnp.float32
    jcdt = jnp.bfloat16 if cdt else None
    xj = jnp.asarray(args[0], sdt)
    primal, vjp = jax.vjp(lambda *a: jl.lstm_recurrence_fused(*a, jcdt), xj,
                          *map(jnp.asarray, args[1:]))
    dhs = f(T, B, H).astype(np.float32)
    dhs_j = jnp.asarray(dhs, sdt)
    dhT, dcT = f(B, H), f(B, H)
    want = vjp((dhs_j, (jnp.asarray(dhT), jnp.asarray(dcT))))

    tdt = torch.bfloat16 if cdt else torch.float32
    ins = [_to_torch(xj, tdt)] + [torch.from_numpy(a) for a in args[1:]]
    for a in ins:
        a.requires_grad_()
    hs, hT, cT = tl.LSTMRecurrence.apply(*ins, torch.bfloat16 if cdt else None, True)
    np.testing.assert_allclose(hs.detach().float().numpy(), _f32(primal[0]), **tol)
    got = torch.autograd.grad((hs, hT, cT), ins,
                              (_to_torch(dhs_j, tdt), torch.from_numpy(dhT), torch.from_numpy(dcT)))
    for name, g, w in zip(("dx", "dW_ih", "db", "dW_hh", "dh0", "dc0"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), _f32(w), err_msg=name, **tol)


def test_unused_terminal_carry_gets_zero_cotangents():
    args = [torch.from_numpy(a) for a in (
        np.random.default_rng(5).standard_normal(s).astype(np.float32) * 0.3
        for s in [(4, 2, 3), (4, 3, 5), (4, 5), (4, 5, 5), (2, 5), (2, 5)])]
    w = args[1].requires_grad_()
    hs, hT, cT = tl.LSTMRecurrence.apply(*args, None, True)
    (g_only_hs,) = torch.autograd.grad(hs.sum(), w)
    hs, hT, cT = tl.LSTMRecurrence.apply(*args, None, True)
    (g_with_zeros,) = torch.autograd.grad((hs, hT, cT), w,
                                          (torch.ones_like(hs), torch.zeros_like(hT),
                                           torch.zeros_like(cT)))
    assert torch.equal(g_only_hs, g_with_zeros)


def test_per_site_gradients_through_stride0_weights_match_jax_vmap_grad():
    """Three sites, one shared weight set: the port folds the sites into the
    kernel rows and splits the weight gradients by rows; JAX takes
    ``vmap(grad)`` of the cell with the Pallas kernels, whose custom_vmap
    rule folds sites into rows the same way."""
    S, B, T, D, H = 3, 2, 5, 6, 4
    rng = np.random.default_rng(7)
    f = lambda *s, scale=0.4: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    p = {"w_ih": f(D, 4 * H), "b_ih": f(4 * H), "w_hh": f(H, 4 * H), "b_hh": f(4 * H)}
    xs, proj = f(S, B, T, D, scale=1.0), f(S, B, T, H, scale=1.0)

    cell = jm.LSTMCell(H, use_pallas=True)

    def loss(params, x, w):
        hs, (hT, cT) = cell.apply({"params": params}, x)
        return jnp.sum(hs * w) + jnp.sum(hT * cT)

    want = jax.vmap(jax.grad(loss), in_axes=(None, 0, 0))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs), jnp.asarray(proj))

    leaves = {k: torch.from_numpy(v).unsqueeze(0).expand(S, *v.shape).requires_grad_()
              for k, v in p.items()}
    x = torch.from_numpy(xs).reshape(S * B, T, D)
    z = torch.zeros(S * B, H)
    hs, (hT, cT) = tl.lstm_forward_fused(
        x, leaves["w_ih"], tl.site_sum(leaves["b_ih"], leaves["b_hh"]), leaves["w_hh"], z, z)
    per_site = ((hs.reshape(S, B, T, H) * torch.from_numpy(proj)).sum((1, 2, 3))
                + (hT * cT).reshape(S, B, H).sum((1, 2)))
    grads = torch.autograd.grad(per_site.sum(), list(leaves.values()))
    for (name, _), g in zip(leaves.items(), grads):
        assert g.shape == (S,) + p[name].shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), err_msg=name, **GRAD_TOL)


def test_site_weights_must_be_stride0_views():
    S, D, H = 2, 3, 4
    x = torch.zeros(S * 2, 5, D)
    w_ih = torch.zeros(S, D, 4 * H, requires_grad=True)  # a materialized site axis
    b = torch.zeros(4 * H).expand(S, 4 * H)
    w_hh = torch.zeros(H, 4 * H).expand(S, H, 4 * H)
    z = torch.zeros(S * 2, H)
    with pytest.raises(ValueError, match="stride 0"):
        tl.lstm_forward_fused(x, w_ih, b, w_hh, z, z)


def test_cpu_tensors_take_the_plain_backward_without_launching():
    acts_cs, whh4, c0, dhs, dhT, dcT = _bwd_inputs(4, 3, 5, 6, None, seed=0)
    args = [_to_torch(a) for a in (*acts_cs, whh4, c0, dhs, dhT, dcT)]
    before = tl.BWD_LAUNCHES
    got = tl.lstm_bwd_fused(*args)
    want = tl.lstm_bwd_plain(*args)
    assert tl.BWD_LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_non_cpu_tensors_never_fall_back_to_the_plain_backward():
    T, B, H = 4, 3, 5
    args = [torch.empty(s, device="meta") for s in
            [(T, B, H)] * 5 + [(4, H, H), (B, H), (T, B, H), (B, H), (B, H)]]
    with pytest.raises(ValueError, match="unsupported device"):
        tl.lstm_bwd_fused(*args)
