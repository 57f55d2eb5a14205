"""The port's fused bidirectional LSTM (ops/bilstm_cuda.py: the plain
versions of K3-K6, the ops ``BiLSTMRecurrence`` and ``BiLSTMPool`` and their
model-layout wrappers) and the ``ICALstm(fused_bidir=True)`` arm against the
JAX package, whose Pallas kernels run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against the plain versions on the card by chip_smoke.py. Inputs
are made with numpy from a seed and fed to both frameworks.

Tolerances, as the JAX package's own tests of these kernels
(tests/test_lstm_pallas.py): f32 values 1e-5 and gradients 1e-4 (the two
frameworks sum the products in other orders, compounded over the
recurrence); bf16 3e-2, as the port's single-direction tests (a last-bit
bf16 flip, 2**-8 relative, of a stream or an operand moves later values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.ops import lstm_pallas as jl
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.ops import bilstm_cuda as tb
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import params_from_jax

ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
F32 = dict(atol=1e-5, rtol=1e-5)
F32_GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
T, D, H, B, S = 6, 5, 8, 4, 3
DTYPES = [(None, F32), ("bfloat16", BF16)]


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))  # a writable copy


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_f32(a)).to(dtype)


def _tdt(cdt):
    return torch.bfloat16 if cdt else None


def _sdt(cdt):
    return torch.bfloat16 if cdt else torch.float32


def _weights(rng):
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(2, 4, D, H, scale=0.4), f(2, 4, H, scale=0.2), f(2, 4, H, H, scale=0.4),
            f(2, B, H, scale=0.5), f(2, B, H, scale=0.5))


def _fwd_inputs(seed, rows=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, rows, D)).astype(np.float32)
    wih2, b2, whh2, _, _ = _weights(rng)
    h02 = (rng.standard_normal((2, rows, H)) * 0.5).astype(np.float32)
    c02 = (rng.standard_normal((2, rows, H)) * 0.5).astype(np.float32)
    return x, wih2, b2, whh2, h02, c02


def _check(got, want, names, tol):
    for name, g, w in zip(names, got, want, strict=True):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        np.testing.assert_allclose(g.float().numpy(), _f32(w), err_msg=name, **tol)


FWD_NAMES = ("hs", "cs", "i", "f", "o", "g")


def _split_fwd(out):
    """The port's [2, T, B, H] streams as JAX's 12 outputs, then hT2, cT2."""
    streams = [s[d] for d in (0, 1) for s in out[:6]]
    return streams + list(out[6:8])


@pytest.mark.parametrize("cdt,tol", DTYPES)
def test_k3_plain_matches_pallas_all_fourteen_outputs(cdt, tol):
    args = _fwd_inputs(0)
    want = jl._fwd_bidir_call(*map(jnp.asarray, args),
                              compute_dtype=jnp.bfloat16 if cdt else None)
    got = tb.bilstm_fwd_plain(*(torch.from_numpy(a) for a in args), _tdt(cdt))
    assert all(g.dtype == _sdt(cdt) for g in got[:6])
    assert got[6].dtype == got[7].dtype == torch.float32
    names = [f"{n}_{d}" for d in ("f", "r") for n in FWD_NAMES] + ["hT2", "cT2"]
    _check(_split_fwd(got), want, names, tol)


def _bwd_inputs(cdt, seed, const):
    """Residual streams from the JAX forward kernel at ``cdt`` and random
    cotangents; ``dhs`` at the stream dtype, full or a per-row constant."""
    x, wih2, b2, whh2, h02, c02 = _fwd_inputs(seed)
    jcdt = jnp.bfloat16 if cdt else None
    outs = jl._fwd_bidir_call(*map(jnp.asarray, (x, wih2, b2, whh2, h02, c02)), compute_dtype=jcdt)
    rng = np.random.default_rng(seed + 100)
    sdt = jnp.bfloat16 if cdt else jnp.float32
    n = 1 if const else T
    dhsf, dhsr = (jnp.asarray(rng.standard_normal((n, B, H)).astype(np.float32), sdt) for _ in "fr")
    dhT2, dcT2 = (rng.standard_normal((2, B, H)).astype(np.float32) for _ in "hc")
    return outs, whh2, c02, dhsf, dhsr, dhT2, dcT2


def _port_streams(outs, cdt):
    """JAX's 12 forward outputs as the port's [2, T, B, H] residuals
    (i, f, o, g, cs)."""
    sdt = _sdt(cdt)
    return [torch.stack([_t(outs[k], sdt), _t(outs[6 + k], sdt)]) for k in (2, 3, 4, 5, 1)]


BWD_NAMES = [f"dp{g}_{d}" for d in ("f", "r") for g in "ifog"] + ["dh02", "dc02"]


def _split_bwd(dp, dh02, dc02):
    return [dp[..., k * H:(k + 1) * H] for k in range(8)] + [dh02, dc02]


@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("cdt,tol", DTYPES)
def test_k4_plain_matches_pallas_with_a_stream_and_a_constant_cotangent(cdt, tol, const):
    outs, whh2, c02, dhsf, dhsr, dhT2, dcT2 = _bwd_inputs(cdt, 1, const)
    jcdt = jnp.bfloat16 if cdt else None
    want = jl._bwd_bidir_call(tuple(outs[2:6]), tuple(outs[8:12]), outs[1], outs[7],
                              jnp.asarray(whh2), jnp.asarray(c02), dhsf, dhsr,
                              jnp.asarray(dhT2), jnp.asarray(dcT2), jcdt)
    sdt = _sdt(cdt)
    dp, dh02, dc02 = tb.bilstm_bwd_plain(*_port_streams(outs, cdt), torch.from_numpy(whh2),
                                         torch.from_numpy(c02), _t(dhsf, sdt), _t(dhsr, sdt),
                                         torch.from_numpy(dhT2), torch.from_numpy(dcT2), _tdt(cdt))
    assert dp.shape == (T, B, 8 * H) and dp.dtype == sdt
    _check(_split_bwd(dp, dh02, dc02), want, BWD_NAMES, tol)


def _site_rows(a):
    """[S, T, B, ·] site-native → the port's [T, S·B, ·] site-major rows."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return np.array(a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1, a.shape[-1]))


def _carry_rows(a):
    """[2, S, B, H] → [2, S·B, H]."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return np.array(a.reshape(2, -1, a.shape[-1]))


@pytest.mark.parametrize("cdt,tol", DTYPES)
def test_k5_plain_matches_pallas_with_the_f32_pool(cdt, tol):
    rng = np.random.default_rng(2)
    x4 = rng.standard_normal((S, T, B, D)).astype(np.float32)
    wih2, b2, whh2, _, _ = _weights(rng)
    h4, c4 = ((rng.standard_normal((2, S, B, H)) * 0.5).astype(np.float32) for _ in "hc")
    want = jl._fwd_pool_call4(*map(jnp.asarray, (x4, wih2, b2, whh2, h4, c4)),
                              compute_dtype=jnp.bfloat16 if cdt else None)
    got = tb.bilstm_fwd_plain(torch.from_numpy(_site_rows(x4)), *map(torch.from_numpy, (
        wih2, b2, whh2, _carry_rows(h4), _carry_rows(c4))), _tdt(cdt), pool=True)
    assert got[8].shape == (S * B, 2 * H) and got[8].dtype == torch.float32
    names = [f"{n}_{d}" for d in ("f", "r") for n in FWD_NAMES]
    for name, g, w in zip(names, _split_fwd(got)[:12], want[:12], strict=True):
        np.testing.assert_allclose(g.float().numpy(), _site_rows(w), err_msg=name, **tol)
    for k, name in ((12, "hT2"), (13, "cT2")):
        np.testing.assert_allclose(got[k - 6].numpy(), _carry_rows(want[k]), err_msg=name, **tol)
    pool = np.concatenate([np.asarray(want[14]), np.asarray(want[15])], -1).reshape(S * B, 2 * H)
    np.testing.assert_allclose(got[8].numpy(), pool, err_msg="pool", **tol)


@pytest.mark.parametrize("cdt,tol", DTYPES)
def test_k6_plain_matches_pallas_with_an_f32_constant(cdt, tol):
    rng = np.random.default_rng(3)
    x4 = rng.standard_normal((S, T, B, D)).astype(np.float32)
    wih2, b2, whh2, _, _ = _weights(rng)
    h4, c4 = ((rng.standard_normal((2, S, B, H)) * 0.5).astype(np.float32) for _ in "hc")
    jcdt = jnp.bfloat16 if cdt else None
    outs = jl._fwd_pool_call4(*map(jnp.asarray, (x4, wih2, b2, whh2, h4, c4)), compute_dtype=jcdt)
    dpf, dpr = ((rng.standard_normal((S, B, H)) / T).astype(np.float32) for _ in "fr")
    dhT4, dcT4 = (rng.standard_normal((2, S, B, H)).astype(np.float32) for _ in "hc")
    want = jl._bwd_pool_call4(tuple(outs[2:6]), tuple(outs[8:12]), outs[1], outs[7],
                              jnp.asarray(whh2), jnp.asarray(c4), jnp.asarray(dpf),
                              jnp.asarray(dpr), jnp.asarray(dhT4), jnp.asarray(dcT4), jcdt)
    sdt = _sdt(cdt)
    streams = [torch.stack([torch.from_numpy(_site_rows(outs[k])),
                            torch.from_numpy(_site_rows(outs[6 + k]))]).to(sdt)
               for k in (2, 3, 4, 5, 1)]
    const = [torch.from_numpy(np.ascontiguousarray(d.reshape(1, S * B, H))) for d in (dpf, dpr)]
    dp, dh02, dc02 = tb.bilstm_bwd_plain(*streams, torch.from_numpy(whh2),
                                         torch.from_numpy(_carry_rows(c4)), *const,
                                         torch.from_numpy(_carry_rows(dhT4)),
                                         torch.from_numpy(_carry_rows(dcT4)), _tdt(cdt))
    for k, name in enumerate(BWD_NAMES[:8]):
        np.testing.assert_allclose(dp[..., k * H:(k + 1) * H].float().numpy(),
                                   _site_rows(want[k]), err_msg=name, **tol)
    np.testing.assert_allclose(dh02.numpy(), _carry_rows(want[8]), err_msg="dh02", **tol)
    np.testing.assert_allclose(dc02.numpy(), _carry_rows(want[9]), err_msg="dc02", **tol)


# ---------------------------------------------------------------------------
# the ops through their model-layout wrappers, values and gradients


def _model_inputs(seed, lead=()):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=0.4: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    params = [(f(D, 4 * H), f(4 * H, scale=0.2), f(H, 4 * H)) for _ in "fr"]
    x = f(*lead, B, T, D, scale=1.0)
    h02, c02 = f(*lead, 2, B, H, scale=0.5), f(*lead, 2, B, H, scale=0.5)
    proj = [f(*lead, B, T, H, scale=1.0) for _ in "fr"] + [f(*lead, B, 2 * H, scale=1.0)]
    return params, x, h02, c02, proj


def _jax_loss(op, proj):
    def loss(params, x, h02, c02):
        pf, pr = params
        if op == "seq":
            hsf, hsr, (hT2, cT2) = jl.bilstm_forward_fused(x, pf, pr, h02, c02)
            out = jnp.sum(hsf.astype(jnp.float32) * proj[0]) + jnp.sum(
                hsr.astype(jnp.float32) * proj[1])
        else:
            pooled, (hT2, cT2) = jl.bilstm_pool_forward_fused(x, pf, pr, h02, c02)
            out = jnp.sum(pooled * proj[2])
        return out + jnp.sum(jnp.sin(hT2)) + jnp.sum(cT2 * cT2)
    return loss


def _port_loss(op, outs, proj):
    p = [torch.from_numpy(a) for a in proj]
    if op == "seq":
        hsf, hsr, (hT2, cT2) = outs
        out = (hsf.float() * p[0]).sum() + (hsr.float() * p[1]).sum()
    else:
        pooled, (hT2, cT2) = outs
        out = (pooled * p[2]).sum()
    return out + torch.sin(hT2).sum() + (cT2 * cT2).sum()


WRAPPERS = {"seq": tb.bilstm_forward_fused, "pool": tb.bilstm_pool_forward_fused}
GRAD_NAMES = ("dx", "dw_ih_f", "db_f", "dw_hh_f", "dw_ih_r", "db_r", "dw_hh_r", "dh02", "dc02")


@pytest.mark.parametrize("op", ["seq", "pool"])
def test_model_layout_op_values_and_all_gradients_match_jax(op):
    params, x, h02, c02, proj = _model_inputs(4)
    jp = [tuple(map(jnp.asarray, p)) for p in params]
    loss = _jax_loss(op, [jnp.asarray(a) for a in proj])
    want_loss, want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(x), jnp.asarray(h02), jnp.asarray(c02))
    tp = [[torch.from_numpy(a).requires_grad_() for a in p] for p in params]
    tx, th, tc = (torch.from_numpy(a).requires_grad_() for a in (x, h02, c02))
    got_loss = _port_loss(op, WRAPPERS[op](tx, tp[0], tp[1], th, tc), proj)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    got = torch.autograd.grad(got_loss, [tx, *tp[0], *tp[1], th, tc])
    wanted = [want[1], *want[0][0], *want[0][1], want[2], want[3]]
    for name, g, w in zip(GRAD_NAMES, got, wanted, strict=True):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **F32_GRAD)


@pytest.mark.parametrize("op", ["seq", "pool"])
def test_site_batched_op_gives_per_site_gradients_as_jax_vmap(op):
    """Three sites, one shared weight set: JAX takes ``vmap(grad)`` of the
    wrapper (the pooled op dispatches to K5/K6 there, the sequence op folds
    sites into K3/K4 rows); the port passes stride-0 site weights, folds
    the sites into rows and gets each site's weight gradient back."""
    params, x, h02, c02, proj = _model_inputs(5, lead=(S,))
    jp = [tuple(map(jnp.asarray, p)) for p in params]

    def site_loss(jparams, xs, hs, cs, *pj):
        return _jax_loss(op, pj)(jparams, xs, None, None)

    want = jax.vmap(jax.grad(site_loss, argnums=(0, 1)), in_axes=(None, 0, 0, 0, 0, 0, 0))(
        jp, jnp.asarray(x), jnp.asarray(h02), jnp.asarray(c02), *map(jnp.asarray, proj))
    leaves = [[torch.from_numpy(a).unsqueeze(0).expand(S, *a.shape).requires_grad_() for a in p]
              for p in params]
    tx = torch.from_numpy(x).reshape(S * B, T, D).requires_grad_()
    outs = WRAPPERS[op](tx, leaves[0], leaves[1])
    loss = _port_loss(op, outs, [a.reshape(S * B, *a.shape[2:]) for a in proj])
    got = torch.autograd.grad(loss, [tx, *leaves[0], *leaves[1]])
    wanted = [want[1], *want[0][0], *want[0][1]]
    for name, g, w in zip(GRAD_NAMES, got, wanted):
        g = g.reshape(S, B, T, D) if name == "dx" else g
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **F32_GRAD)


def test_pooled_op_dispatches_in_bf16_as_jax_does():
    """bf16: the unbatched pool is the f32 mean of the bf16 streams (K3),
    the site-batched one the f32 sum of the f32 h (K5), so the two differ
    by design; each matches its JAX dispatch."""
    params, x, _, _, _ = _model_inputs(6, lead=(S,))
    jp = [tuple(map(jnp.asarray, p)) for p in params]
    fn = lambda xs: jl.bilstm_pool_forward_fused(xs, *jp, compute_dtype=jnp.bfloat16)[0]  # noqa: E731
    want_sites = jax.vmap(fn)(jnp.asarray(x))
    want_one = fn(jnp.asarray(x[0]))
    tp = [[torch.from_numpy(a) for a in p] for p in params]
    sites = [[a.unsqueeze(0).expand(S, *a.shape) for a in p] for p in tp]
    got_sites = tb.bilstm_pool_forward_fused(torch.from_numpy(x).reshape(S * B, T, D), *sites,
                                             compute_dtype=torch.bfloat16)[0]
    got_one = tb.bilstm_pool_forward_fused(torch.from_numpy(x[0]), *tp,
                                           compute_dtype=torch.bfloat16)[0]
    assert got_one.dtype == got_sites.dtype == torch.float32
    np.testing.assert_allclose(got_sites.numpy(), np.asarray(want_sites).reshape(S * B, -1), **BF16)
    np.testing.assert_allclose(got_one.numpy(), np.asarray(want_one), **BF16)


# ---------------------------------------------------------------------------
# the model arm

C, W, WIN, IN, HID = 4, 5, 6, 16, 12


def _jax_model(cdt):
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_cls=2, num_comps=C, window_size=W,
                       use_pallas=True, compute_dtype=cdt, fused_bidir=True, dropout_rate=0.0)
    task = jsteps.FederatedTask(model)
    params, stats = task.init_variables(jax.random.PRNGKey(3), jnp.zeros((2, WIN, C, W)))
    return task, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _port_model(params, stats, cdt, fused=True, use_kernel=True):
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_cls=2, num_comps=C, window_size=W,
                       compute_dtype=cdt, dropout_rate=0.0, fused_bidir=fused,
                       use_kernel=use_kernel)
    model.load_state_dict(params_from_jax(ICA, params, stats))
    return model


@pytest.mark.parametrize("cdt,tol", DTYPES)
def test_fused_icalstm_eval_and_train_gradient_match_jax(cdt, tol):
    task, params, stats = _jax_model(cdt)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, WIN, C, W)).astype(np.float32)
    y = rng.integers(0, 2, 5).astype(np.int32)
    w = np.ones(5, np.float32)
    pj = jsteps.eval_forward(task, params, stats, jnp.asarray(x))
    model = _port_model(params, stats, cdt)
    pt = tsteps.eval_forward(tsteps.FederatedTask(model.eval()), torch.from_numpy(x))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **(F32 if cdt is None else BF16))

    def jloss(p):
        logits, _ = task.apply(p, stats, jnp.asarray(x), train=True, mask=jnp.asarray(w),
                               mutable=True)
        return jsteps.cross_entropy(logits, jnp.asarray(y), jnp.asarray(w))

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    want_sd = params_from_jax(ICA, jax.tree.map(np.asarray, want), stats)
    model.train()
    named = dict(model.named_parameters())
    loss = tsteps.cross_entropy(model(torch.from_numpy(x), train=True, mask=torch.from_numpy(w)),
                                torch.from_numpy(y), torch.from_numpy(w))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert grads.keys() == {k for k in want_sd if k in named}
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_sd[k].numpy(), err_msg=k,
                                   **(F32_GRAD if cdt is None else tol))


def test_fused_arm_matches_the_per_direction_arm_on_one_state_dict():
    """One state_dict drives both arms: the names are the same, the eval
    outputs, the one-model gradient and the per-site gradients of a
    federated round agree."""
    _, params, stats = _jax_model(None)
    fused, per_dir = _port_model(params, stats, None), _port_model(params, stats, None, fused=False)
    assert list(fused.state_dict()) == list(per_dir.state_dict())
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, WIN, C, W)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused.eval()(x, train=False), per_dir.eval()(x, train=False),
                                   **F32)
    grads = []
    for m in (fused.train(), per_dir.train()):
        named = dict(m.named_parameters())
        grads.append(torch.autograd.grad(m(x).square().sum(), list(named.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **F32_GRAD)
    xs = torch.from_numpy(rng.standard_normal((S, B, WIN, C, W)).astype(np.float32))
    site = []
    for m in (fused, per_dir):
        leaves = {k: v.detach().unsqueeze(0).expand(S, *v.shape).requires_grad_()
                  for k, v in m.named_parameters()}
        st = {k: v.unsqueeze(0).expand(S, *v.shape) for k, v in m.named_buffers()}
        logits, _ = m.site_forward(leaves, xs, torch.ones(S, B), st)
        site.append((logits, torch.autograd.grad(logits.square().sum(), list(leaves.values()))))
    torch.testing.assert_close(site[0][0], site[1][0], **F32)
    for a, b in zip(site[0][1], site[1][1]):
        assert a.shape[0] == S
        torch.testing.assert_close(a, b, **F32_GRAD)


def test_fused_arm_never_flips_a_time_axis(monkeypatch):
    """The reverse direction reads x through the kernels' time map; the
    per-direction arm flips x, the fused arm must not."""
    _, params, stats = _jax_model(None)
    fused = _port_model(params, stats, None)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((3, WIN, C, W)).astype(np.float32))

    def refuse(*a, **k):
        raise AssertionError("torch.flip on the fused path")

    monkeypatch.setattr(torch, "flip", refuse)
    fused(x).sum().backward()
    with pytest.raises(AssertionError, match="torch.flip"):
        _port_model(params, stats, None, fused=False)(x)


def test_fused_branch_needs_bidirectional_mean_pool_and_the_flag(monkeypatch):
    import dinunet_implementations_tpu_torch.models.icalstm as icalstm_mod

    calls = []
    real = tb.bilstm_pool_forward_fused
    monkeypatch.setattr(icalstm_mod, "bilstm_pool_forward_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(B, T, D)
    tm.BiLSTM(D, 2 * H, time_pool="mean", fused_bidir=True)(x)
    tm.BiLSTM(D, 2 * H, time_pool=None, fused_bidir=True)(x)
    tm.BiLSTM(D, 2 * H, time_pool="mean", fused_bidir=None)(x)
    tm.BiLSTM(D, H, bidirectional=False, time_pool="mean", fused_bidir=True)(x)
    assert len(calls) == 1
    assert tm.ICALstm(num_comps=C, window_size=W).lstm.fused_bidir is None


# ---------------------------------------------------------------------------
# the wrappers' dispatch


def test_cpu_tensors_take_the_plain_versions_without_launching():
    x, wih2, b2, whh2, h02, c02 = (torch.from_numpy(a) for a in _fwd_inputs(10))
    counters = ("BIDIR_FWD_LAUNCHES", "BIDIR_BWD_LAUNCHES", "POOL_FWD_LAUNCHES",
                "POOL_BWD_LAUNCHES")
    before = [getattr(tb, c) for c in counters]
    fwd = tb.bilstm_fwd_fused(x, wih2, b2, whh2, h02, c02)
    for g, w in zip(fwd, tb.bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02)):
        assert torch.equal(g, w)
    pool = tb.bilstm_pool_fwd_fused(x, wih2, b2, whh2, h02, c02)
    assert torch.equal(pool[8], tb.bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, pool=True)[8])
    streams = [fwd[k] for k in (2, 3, 4, 5, 1)]
    dhs, carry = torch.ones(T, B, H), torch.zeros(2, B, H)
    bwd = tb.bilstm_bwd_fused(*streams, whh2, c02, dhs, dhs, carry, carry)
    for g, w in zip(bwd, tb.bilstm_bwd_plain(*streams, whh2, c02, dhs, dhs, carry, carry)):
        assert torch.equal(g, w)
    dpool = torch.ones(B, H)
    pbwd = tb.bilstm_pool_bwd_fused(*streams, whh2, c02, dpool, dpool, carry, carry)
    want = tb.bilstm_bwd_plain(*streams, whh2, c02, dpool[None], dpool[None], carry, carry)
    for g, w in zip(pbwd, want):
        assert torch.equal(g, w)
    assert [getattr(tb, c) for c in counters] == before


def test_non_cpu_tensors_never_fall_back_to_the_plain_versions():
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    fwd_args = (m(T, B, D), m(2, 4, D, H), m(2, 4, H), m(2, 4, H, H), m(2, B, H), m(2, B, H))
    for fn in (tb.bilstm_fwd_fused, tb.bilstm_pool_fwd_fused):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*fwd_args)
    streams = [m(2, T, B, H) for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        tb.bilstm_bwd_fused(*streams, m(2, 4, H, H), m(2, B, H), m(T, B, H), m(T, B, H),
                            m(2, B, H), m(2, B, H))
    with pytest.raises(ValueError, match="unsupported device"):
        tb.bilstm_pool_bwd_fused(*streams, m(2, 4, H, H), m(2, B, H), m(B, H), m(B, H),
                                 m(2, B, H), m(2, B, H))


def test_site_weights_must_be_stride0_views():
    params, x, _, _, _ = _model_inputs(11, lead=(S,))
    leaves = [[torch.from_numpy(a).unsqueeze(0).expand(S, *a.shape) for a in p] for p in params]
    leaves[1][0] = leaves[1][0].clone()  # a materialized site axis
    with pytest.raises(ValueError, match="stride 0"):
        tb.bilstm_pool_forward_fused(torch.from_numpy(x).reshape(S * B, T, D), *leaves)
