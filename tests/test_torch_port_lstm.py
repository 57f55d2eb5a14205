"""The port's LSTM recurrence (ops/lstm_cuda.py) against the JAX package's
Pallas kernel, which runs in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
Inputs are made with numpy from a seed and fed to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.ops import lstm_pallas as jl
from dinunet_implementations_tpu_torch.ops import lstm_cuda as tl

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: the two frameworks round bf16 products, the stream casts and the h
# fed back into the recurrence at different points, so a last-bit flip of a
# bf16 value (2**-8 relative) can carry into later steps
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

SHAPES = [(5, 3, 8, 6), (7, 16, 16, 12), (4, 1, 5, 7)]


def _inputs(T, B, D, H, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(T, B, D), f(4, D, H, scale=0.3), f(4, H, scale=0.1),
            f(4, H, H, scale=0.3), f(B, H, scale=0.5), f(B, H, scale=0.5))


def _jax(args, cdt):
    outs = jl._fwd_fused_callable(cdt)(*(jnp.asarray(a) for a in args))
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in outs]


def _torch(fn, args, cdt, **kw):
    return fn(*(torch.from_numpy(a) for a in args), compute_dtype=cdt, **kw)


@pytest.mark.parametrize("T,B,D,H", SHAPES)
def test_plain_matches_pallas_all_outputs_f32(T, B, D, H):
    args = _inputs(T, B, D, H)
    want = _jax(args, None)
    got = _torch(tl.lstm_recurrence_plain, args, None, residuals=True)
    names = ("hs", "cs", "i", "f", "o", "g", "hT", "cT")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("T,B,D,H", SHAPES[:2])
def test_plain_matches_pallas_all_outputs_bf16(T, B, D, H):
    args = _inputs(T, B, D, H, seed=1)
    want = _jax(args, "bfloat16")
    got = _torch(tl.lstm_recurrence_plain, args, torch.bfloat16, residuals=True)
    names = ("hs", "cs", "i", "f", "o", "g", "hT", "cT")
    for k, (name, g, w) in enumerate(zip(names, got, want)):
        # streams at the stream dtype, the terminal carry always f32
        assert g.dtype == (torch.bfloat16 if k < 6 else torch.float32), name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("cdt,tol", [(None, F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("B,T,D,H", [(3, 6, 8, 5), (9, 4, 7, 10)])
def test_forward_fused_model_layout_matches_jax(B, T, D, H, cdt, tol):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w_ih = (rng.standard_normal((D, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    args = (x, w_ih, b, w_hh, h0, c0)
    jcdt = jnp.bfloat16 if cdt else None
    hs_j, (hT_j, cT_j) = jl.lstm_forward_fused(*(jnp.asarray(a) for a in args), compute_dtype=jcdt)
    tcdt = torch.bfloat16 if cdt else None
    hs_t, (hT_t, cT_t) = _torch(tl.lstm_forward_fused, args, tcdt)
    assert hs_t.shape == (B, T, H) and hs_t.dtype == torch.float32
    assert hT_t.dtype == cT_t.dtype == torch.float32
    for g, w in ((hs_t, hs_j), (hT_t, hT_j), (cT_t, cT_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **tol)


def test_cpu_tensors_take_the_plain_version_without_launching():
    args = [torch.from_numpy(a) for a in _inputs(5, 3, 8, 6)]
    before = tl.LAUNCHES
    got = tl.lstm_recurrence_fused(*args, residuals=True)
    want = tl.lstm_recurrence_plain(*args, residuals=True)
    assert tl.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hs, (hT, cT) = tl.lstm_recurrence_fused(*args)
    assert torch.equal(hs, want[0]) and torch.equal(hT, want[6]) and torch.equal(cT, want[7])


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    # a device that is neither the CPU nor CUDA is refused, not computed
    args = [torch.empty(s, device="meta") for s in
            [(5, 3, 8), (4, 8, 6), (4, 6), (4, 6, 6), (3, 6), (3, 6)]]
    with pytest.raises(ValueError, match="unsupported device"):
        tl.lstm_recurrence_fused(*args)


@pytest.mark.parametrize("bad", [torch.float16, torch.float64])
def test_unsupported_compute_dtype_raises(bad):
    args = [torch.from_numpy(a) for a in _inputs(2, 1, 3, 2)]
    with pytest.raises(ValueError, match="compute_dtype"):
        tl.lstm_recurrence_plain(*args, compute_dtype=bad)
