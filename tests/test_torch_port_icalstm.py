"""The port's model modules against the JAX package's flax modules, with
the Pallas LSTM kernel in interpret mode on the JAX side and the weights
carried across as numpy arrays (through the bridge for the whole model)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.models import layers as jlayers
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import ICAArgs, NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models import layers as tlayers
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import params_from_jax

ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: the frameworks round the encoder's bf16 output, the products and
# the streams at different points; a last-bit bf16 flip (2**-8 relative)
# then moves later values
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

# small ICA-LSTM: 6 windows of 4 components x 5 timepoints
C, W, S, IN, HID = 4, 5, 6, 16, 12


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cell_params(rng, D, H):
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return {"w_ih": f(D, 4 * H), "b_ih": f(4 * H), "w_hh": f(H, 4 * H), "b_hh": f(4 * H)}


def _load_cell(cell, p):
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return cell


@pytest.mark.parametrize("with_carry", [False, True])
def test_lstm_cell_matches_flax(with_carry):
    rng = np.random.default_rng(0)
    B, T, D, H = 3, 7, 9, 6
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    p = _cell_params(rng, D, H)
    h0 = None
    if with_carry:
        h0 = tuple((rng.standard_normal((B, H)) * 0.5).astype(np.float32) for _ in range(2))
    hs_j, (h_j, c_j) = jm.LSTMCell(H, use_pallas=True).apply(
        {"params": p}, jnp.asarray(x), None if h0 is None else tuple(map(jnp.asarray, h0)))
    cell = _load_cell(tm.LSTMCell(D, H), p)
    hs_t, (h_t, c_t) = cell(torch.from_numpy(x),
                            None if h0 is None else tuple(map(torch.from_numpy, h0)))
    for g, w in ((hs_t, hs_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("cdt,tol", [(None, F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_bilstm_mean_pool_matches_flax(bidirectional, cdt, tol):
    rng = np.random.default_rng(1)
    B, T, D, Htot = 4, 6, 8, 10
    per_dir = Htot // (2 if bidirectional else 1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dirs = ("fwd", "rev") if bidirectional else ("fwd",)
    params = {d: _cell_params(rng, D, per_dir) for d in dirs}
    jmod = jm.BiLSTM(Htot, bidirectional, use_pallas=True, compute_dtype=cdt, time_pool="mean")
    o_j, (h_j, c_j) = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tm.BiLSTM(D, Htot, bidirectional, compute_dtype=cdt, time_pool="mean")
    for d in dirs:
        _load_cell(getattr(tmod, d), params[d])
    with torch.no_grad():
        o_t, (h_t, c_t) = tmod(torch.from_numpy(x))
    assert o_t.shape == (B, Htot)
    for g, w in ((o_t, o_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


def _bn_state(rng, F):
    return (
        (1 + 0.3 * rng.standard_normal(F)).astype(np.float32),
        (0.2 * rng.standard_normal(F)).astype(np.float32),
        (0.5 * rng.standard_normal(F)).astype(np.float32),
        rng.uniform(0.5, 2.0, F).astype(np.float32),
    )


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_flax(train):
    rng = np.random.default_rng(2)
    F = 7
    x = rng.standard_normal((5, F)).astype(np.float32) * 2 + 1
    mask = np.array([1, 1, 0, 1, 1], np.float32)  # row 2 is padding
    scale, bias, mean, var = _bn_state(rng, F)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    jbn = jlayers.BatchNorm(F, track_running_stats=True)
    y_j, upd = jbn.apply(variables, jnp.asarray(x), train=train, mask=jnp.asarray(mask),
                         mutable=["batch_stats"])
    tbn = tlayers.BatchNorm(F, track_running_stats=True)
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         (("weight", scale), ("bias", bias), ("running_mean", mean),
                          ("running_var", var))})
    y_t = tbn(torch.from_numpy(x), train=train, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **F32_TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               **F32_TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               **F32_TOL)
    if train:
        # the weight-0 row leaves the batch statistics (and every real row)
        # exactly as the sub-batch without it
        keep = mask > 0
        sub = tlayers.BatchNorm(F)
        sub.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
        y_sub = sub(torch.from_numpy(x[keep]), train=True)
        np.testing.assert_allclose(y_t[torch.from_numpy(keep)].detach().numpy(),
                                   y_sub.detach().numpy(), **F32_TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_moments_match_jax(with_mask):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    m = np.array([1, 0, 1, 1, 0, 1], np.float32)[:, None] if with_mask else None
    mj, vj, nj = jlayers.masked_moments(jnp.asarray(x), None if m is None else jnp.asarray(m))
    mt, vt, nt = tlayers.masked_moments(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **F32_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **F32_TOL)
    np.testing.assert_allclose(np.asarray(nt), np.asarray(nj))


@pytest.mark.parametrize("value,want", [("", None), (None, None),
                                        ("bfloat16", torch.bfloat16),
                                        (torch.bfloat16, torch.bfloat16)])
def test_compute_dtype_of(value, want):
    assert tlayers.compute_dtype_of(value) == want


def test_dense_init_is_torch_linear_uniform_from_generator():
    a = tlayers.dense(40, 30, torch.Generator().manual_seed(5))
    b = tlayers.dense(40, 30, torch.Generator().manual_seed(5))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / np.sqrt(40)
    assert a.weight.shape == (30, 40)
    w, bias = a.weight.detach().abs(), a.bias.detach().abs()
    assert float(w.max()) <= bound and float(bias.max()) <= bound
    assert float(w.max()) > 0.8 * bound


def _jax_icalstm(cdt, bidirectional=True, seed=0):
    model = jm.ICALstm(input_size=IN, hidden_size=HID, bidirectional=bidirectional,
                       num_cls=2, num_comps=C, window_size=W, use_pallas=True,
                       compute_dtype=cdt)
    task = jsteps.FederatedTask(model)
    params, stats = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, S, C, W)))
    rng = np.random.default_rng(seed + 10)
    # non-trivial running stats and BN affine: mean 0 / var 1 / scale 1
    # would hide a bridge that dropped or swapped them
    params = _np_tree(params)
    _, _, mean, var = _bn_state(rng, 256)
    params["cls_bn"] = {"scale": (1 + 0.3 * rng.standard_normal(256)).astype(np.float32),
                        "bias": (0.2 * rng.standard_normal(256)).astype(np.float32)}
    stats = {"cls_bn": {"mean": mean, "var": var}}
    return task, params, stats


def _torch_icalstm(params, stats, cdt, bidirectional=True):
    model = tm.ICALstm(input_size=IN, hidden_size=HID, bidirectional=bidirectional,
                       num_cls=2, num_comps=C, window_size=W, compute_dtype=cdt)
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA, ica_args=ICAArgs(bidirectional=bidirectional))
    model.load_state_dict(params_from_jax(cfg, params, stats))
    return tsteps.FederatedTask(model.eval())


@pytest.mark.parametrize("cdt,tol", [(None, dict(atol=1e-5, rtol=1e-5)),
                                     ("bfloat16", dict(atol=3e-2, rtol=0))])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_icalstm_eval_forward_matches_jax(bidirectional, cdt, tol):
    task_j, params, stats = _jax_icalstm(cdt, bidirectional)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, S, C, W)).astype(np.float32)
    w = np.array([1, 1, 1, 0, 1], np.float32)
    y = np.array([0, 1, 1, 0, 1], np.int32)
    pj, cej = jsteps.eval_forward(task_j, params, stats, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(w))
    task_t = _torch_icalstm(params, stats, cdt, bidirectional)
    pt, cet = tsteps.eval_forward(task_t, torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(w))
    assert pt.shape == (5, 2) and pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **tol)
    np.testing.assert_allclose(cet.numpy(), np.asarray(cej), atol=10 * tol["atol"])
    only = tsteps.eval_forward(task_t, torch.from_numpy(x), None, torch.from_numpy(w))
    assert torch.equal(only, pt)


def test_icalstm_train_mode_head_matches_jax():
    """Train mode without dropout noise: batch statistics from the masked
    rows, as in training."""
    task_j, params, stats = _jax_icalstm(None)
    task_j.model = task_j.model.clone(dropout_rate=0.0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, S, C, W)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    lj, _ = task_j.apply(params, stats, jnp.asarray(x), train=True, mask=jnp.asarray(mask),
                         mutable=True)
    task_t = _torch_icalstm(params, stats, None)
    task_t.model.dropout_rate = 0.0
    with torch.no_grad():
        lt = task_t.apply(torch.from_numpy(x), train=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)


def test_bridge_rejects_missing_and_extra_leaves():
    _, params, stats = _jax_icalstm(None)
    params_from_jax(ICA, params, stats)  # the full tree passes
    missing = {**params, "lstm": {"fwd": params["lstm"]["fwd"]}}
    with pytest.raises(ValueError, match="missing leaves.*lstm/rev/b_hh"):
        params_from_jax(ICA, missing, stats)
    extra = {**params, "cls_fc4": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="extra leaves.*cls_fc4/kernel"):
        params_from_jax(ICA, extra, stats)
    with pytest.raises(ValueError, match="batch_stats is missing"):
        params_from_jax(ICA, params, {})


def test_bridge_layouts():
    _, params, stats = _jax_icalstm(None)
    sd = params_from_jax(ICA, params, stats)
    np.testing.assert_array_equal(sd["encoder.weight"].numpy(), params["encoder"]["kernel"].T)
    np.testing.assert_array_equal(sd["lstm.rev.w_hh"].numpy(), params["lstm"]["rev"]["w_hh"])
    # the two LSTM biases stay two leaves: an optimizer steps each of them
    for leaf in ("b_ih", "b_hh"):
        np.testing.assert_array_equal(sd[f"lstm.fwd.{leaf}"].numpy(), params["lstm"]["fwd"][leaf])
    assert "lstm.fwd.b" not in sd
    np.testing.assert_array_equal(sd["cls_bn.running_var"].numpy(), stats["cls_bn"]["var"])


@pytest.mark.parametrize("kw", [{"double_sigmoid_gates": True}, {"sequence_axis": "model"}])
def test_unported_model_paths_raise(kw):
    with pytest.raises(NotImplementedError):
        tm.ICALstm(num_comps=C, window_size=W, **kw)
