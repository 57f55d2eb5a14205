"""The port's powerSGD engine (``engines/powersgd.py``) against the JAX
package's, round by round: JAX runs its engine under ``jax.vmap(...,
axis_name=SITE_AXIS)``, the fold that ``make_train_epoch_fn`` uses with
``mesh=None``; the port runs its ``[S, ...]`` engine on the CPU. The
gradient tree holds an ``nn.Linear``-style leaf (stored transposed in the
port), an LSTM-style leaf (same layout in both), a 1-D leaf and a leaf of
rank class 2. Inputs are made with numpy from a seed; the engine state
(``q`` and ``e``) crosses as numpy. Also: the first Q's key (the JAX leaf
index), the engine's refusals, and powerSGD checkpoints in both
directions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.engines import build_engine, make_powersgd
from dinunet_implementations_tpu_torch.engines import lowrank as tlowrank
from dinunet_implementations_tpu_torch.engines import powersgd as tpowersgd
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    train_state_from_jax,
    train_state_to_jax,
)

S, R, ROUNDS = 4, 3, 3
ICA = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA)
# (port name, JAX path, JAX shape of one site's leaf, stored transposed in the port)
LEAVES = (("enc.weight", ("enc", "kernel"), (8, 8), True),
          ("lstm.w_ih", ("lstm", "w_ih"), (8, 12), False),
          ("bias", ("bias",), (8,), False),
          ("head.weight", ("head", "kernel"), (6, 2), True))
TRANSPOSED = frozenset(n for n, _, _, tr in LEAVES if tr)
WEIGHT = np.array([16.0, 9.0, 12.0, 5.0], np.float32)
# f32: the two frameworks sum the products and the sites in other orders,
# and each round's q and e carry the difference into the next (measured
# over three rounds: 1.7e-6 at values up to 5.8, the aggregate, q and e).
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 operands and payload: both sides round the same f32 values (measured
# 9.5e-7), but an f32 value one ulp apart can round to the neighbouring
# bf16 value (2**-9 relative) in an operand or the shipped payload.
BF16_TOL = dict(atol=1e-3, rtol=1e-3)


def _grads(seed):
    """Per-site gradients ``[S, ...]`` in the JAX layout, as numpy."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((S,) + shape).astype(np.float32) for n, _, shape, _ in LEAVES}


def _jax_tree(flat):
    tree: dict = {}
    for n, path, _, _ in LEAVES:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = None if flat[n] is None else jnp.asarray(flat[n])
    return tree


def _from_jax_tree(tree):
    out = {}
    for n, path, _, _ in LEAVES:
        node = tree
        for k in path:
            node = node[k]
        out[n] = None if node is None else np.asarray(node)
    return out


def _jax_engine(pb):
    return make_engine("powerSGD", dad_reduction_rank=R, precision_bits=pb, seed=0)


def _jax_init():
    """JAX's per-site state, stacked for S sites, as flat numpy dicts."""
    st = _jax_engine("32").init(_jax_tree({n: np.zeros(s, np.float32) for n, _, s, _ in LEAVES}))
    return tuple({n: None if v is None else np.stack([v] * S)
                  for n, v in _from_jax_tree(st[k]).items()} for k in ("q", "e"))


def _jax_round(grads, q, e, live, pb):
    eng = _jax_engine(pb)
    agg, new = jax.vmap(lambda g, st, w, lv: eng.aggregate(g, st, w, SITE_AXIS, live=lv),
                        axis_name=SITE_AXIS)(
        _jax_tree(grads), {"q": _jax_tree(q), "e": _jax_tree(e)}, jnp.asarray(WEIGHT),
        jnp.asarray(live))
    return ({n: a[0] for n, a in _from_jax_tree(agg).items()}, _from_jax_tree(new["q"]),
            _from_jax_tree(new["e"]))


def _port_round(engine, grads, q, e, live):
    g = {n: torch.from_numpy(np.ascontiguousarray(grads[n].swapaxes(-1, -2) if tr else grads[n]))
         for n, _, _, tr in LEAVES}
    state = {"q": {n: None if v is None else torch.from_numpy(v) for n, v in q.items()},
             "e": {n: None if v is None else torch.from_numpy(v) for n, v in e.items()}}
    agg, new = engine.aggregate(g, state, torch.from_numpy(WEIGHT), live=torch.from_numpy(live))
    agg = {n: (agg[n].T if tr else agg[n]).numpy() for n, _, _, tr in LEAVES}
    return agg, *({n: None if v is None else v.numpy() for n, v in new[k].items()}
                  for k in ("q", "e"))


def _freeze_dead(live, new, old):
    """The trainer's hold of a dead site's q and e for the round."""
    alive = (live > 0)[:, None, None]
    return {n: None if v is None else np.where(alive, v, old[n]) for n, v in new.items()}


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("precision_bits", ["32", "16"])
def test_rounds_match_jax_with_q_and_e_carried(precision_bits, dead):
    """Three rounds from JAX's first state, each side carrying its own q
    and e; with ``dead``, site 2 is dead in round 1 (its gradient and
    weight are zeroed, its q and e held as the trainer holds them). The
    aggregate, q and e match JAX's every round; e stays distinct per site,
    and q is one matrix across the live sites."""
    q_j, e_j = _jax_init()
    q_t, e_t = q_j, e_j
    engine = make_powersgd(R, precision_bits, transposed=TRANSPOSED)
    tol = F32_TOL if precision_bits == "32" else BF16_TOL
    for rnd in range(ROUNDS):
        live = np.ones(S, np.float32)
        if dead and rnd == 1:
            live[2] = 0.0
        g = _grads(rnd)
        want, nq_j, ne_j = _jax_round(g, q_j, e_j, live, precision_bits)
        got, nq_t, ne_t = _port_round(engine, g, q_t, e_t, live)
        for n, _, _, _ in LEAVES:
            assert got[n].shape == want[n].shape, n
            np.testing.assert_allclose(got[n], want[n], err_msg=f"round {rnd} aggregate {n}",
                                       **tol)
            for what, a, b in (("q", nq_t, nq_j), ("e", ne_t, ne_j)):
                if b[n] is None:
                    assert a[n] is None, (what, n)
                else:
                    np.testing.assert_allclose(a[n], b[n], err_msg=f"round {rnd} {what} {n}",
                                               **tol)
        q_j, e_j = _freeze_dead(live, nq_j, q_j), _freeze_dead(live, ne_j, e_j)
        held = q_t
        q_t, e_t = _freeze_dead(live, nq_t, q_t), _freeze_dead(live, ne_t, e_t)
        for n in ("enc.weight", "lstm.w_ih"):
            # each site's residual is its own; q is the one psum'd factor
            assert np.abs(e_t[n][0] - e_t[n][1]).max() > 1e-3, n
            if dead and rnd == 1:
                assert np.array_equal(q_t[n][2], held[n][2])  # held, not the new q
                assert np.abs(q_t[n][2] - q_t[n][0]).max() > 1e-3, n
            else:
                assert all(np.array_equal(q_t[n][0], q_t[n][s]) for s in range(S)), n


def test_a_leaf_taken_the_wrong_way_round_differs_from_jax():
    """The port's ``enc.weight`` is the transpose of the JAX kernel. Told
    so, the engine factorizes the transposed view and matches JAX; not told
    (the leaf is square, so the shapes still fit), its rank-3 sketch of the
    other matrix does not."""
    q, e = _jax_init()
    live = np.ones(S, np.float32)
    want, _, _ = _jax_round(_grads(0), q, e, live, "32")
    got, _, _ = _port_round(make_powersgd(R, transposed=TRANSPOSED), _grads(0), q, e, live)
    np.testing.assert_allclose(got["enc.weight"], want["enc.weight"], **F32_TOL)
    wrong, _, _ = _port_round(make_powersgd(R, transposed=TRANSPOSED - {"enc.weight"}),
                              _grads(0), q, e, live)
    assert np.abs(wrong["enc.weight"] - want["enc.weight"]).max() > 1e-2


def test_orthonormalize_matches_jax():
    from dinunet_implementations_tpu.engines import lowrank as jlowrank

    rng = np.random.default_rng(3)
    for shape in ((40, 5), (7, 3)):
        P = rng.standard_normal(shape).astype(np.float32)
        got = tlowrank.orthonormalize(torch.from_numpy(P)).numpy()
        want = np.asarray(jlowrank.orthonormalize(jnp.asarray(P)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # rank-deficient: the shift keeps it finite; its last column is
        # rounding noise in both, so only the span is compared (the shift
        # regularizes the Gram matrix: measured 1.9e-4 at values up to 2.6)
        P[:, -1] = P[:, 0] * 0.5
        got = tlowrank.orthonormalize(torch.from_numpy(P)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got @ (got.T @ P), P, atol=1e-3, rtol=0)


def test_first_q_is_keyed_by_the_jax_leaf_index():
    """The first Q is drawn per leaf from ``(seed, index)``, ``index`` the
    leaf's place in ``jax.tree.flatten`` of the JAX params; the same on
    every site, with e zero, q ``[S, n, r]`` and e ``[S, m, n]`` in JAX's
    orientation."""
    model = jm.ICALstm(input_size=16, hidden_size=12, num_comps=4, window_size=5, num_cls=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 6, 4, 5)))["params"]
    paths = ["/".join(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    want = {p: i for i, p in enumerate(paths)}
    cfg = tconfig.TrainConfig(task_id="ICA-Classification", agg_engine="powerSGD", seed=5)
    table = leaf_table(cfg)
    index = table.leaf_index
    assert {j: index[n] for n, j, _ in table.params} == want
    cfg = cfg.with_overrides({"input_size": 16, "hidden_size": 12, "num_components": 4,
                              "window_size": 5, "temporal_size": 30})
    engine = build_engine(cfg)
    task = tsteps.FederatedTask(tm.ICALstm(input_size=16, hidden_size=12, num_comps=4,
                                           window_size=5))
    state = tsteps.init_train_state(task, engine, tsteps.make_optimizer("adam", 1e-3),
                                    num_sites=3)
    q, e = state.engine_state["q"], state.engine_state["e"]
    assert tuple(q["encoder.weight"].shape) == (3, 16, 10)  # JAX kernel [20, 16]: n = 16
    assert tuple(e["encoder.weight"].shape) == (3, 20, 16)
    assert tuple(q["cls_fc3.weight"].shape) == (3, 2, 2)  # rank class min(10, 64, 2)
    assert q["encoder.bias"] is None and e["encoder.bias"] is None
    for n, v in q.items():
        if v is not None:
            assert torch.equal(v[0], tpowersgd.default_q(5, index[n], *v.shape[1:]))
            assert all(torch.equal(v[0], v[s]) for s in range(3)) and not e[n].any()
    assert not torch.equal(tpowersgd.default_q(5, 0, 6, 2), tpowersgd.default_q(5, 1, 6, 2))
    assert not torch.equal(tpowersgd.default_q(5, 0, 6, 2), tpowersgd.default_q(6, 0, 6, 2))


@pytest.mark.parametrize("kw,error,match", [
    ({"wire_quant": "int4"}, ValueError, "wire_quant must be one of"),
    ({"robust_agg": "krum"}, ValueError, "robust_agg must be one of"),
    ({"secure_agg": "mask"}, ValueError, "only supported by the dSGD engine"),
    ({"secure_agg": "pads"}, ValueError, "secure_agg must be one of"),
])
def test_unported_options_raise(kw, error, match):
    with pytest.raises(error, match=match):
        make_powersgd(**kw)
    if error is ValueError:  # JAX's own error for the same option
        with pytest.raises(ValueError, match=match):
            make_engine("powerSGD", **kw)


# the small ICA-LSTM of tests/test_torch_port_train.py
C, W, T, IN, HID = 4, 5, 6, 16, 12


def _jax_powersgd_state(tmp_path):
    """A JAX powerSGD training state after one round of 3 sites (so q is
    past its draw and e is nonzero), saved by JAX."""
    task = jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))
    engine = make_engine("powerSGD", seed=0)
    opt = jsteps.make_optimizer("adam", 1e-3)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                    jnp.zeros((2, T, C, W)), num_sites=3)
    epoch = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="host")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 4, T, C, W)).astype(np.float32)
    y = rng.integers(0, 2, (3, 1, 4)).astype(np.int32)
    state, _ = epoch(state, jnp.asarray(x), jnp.asarray(y), jnp.ones((3, 1, 4), jnp.float32))
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(path, state)
    return state, path


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_powersgd_checkpoints_cross_both_ways(tmp_path):
    """A JAX-written powerSGD checkpoint restores in the port with q and e
    bit for bit, and the port's restores in JAX the same way."""
    state_j, path = _jax_powersgd_state(tmp_path)
    want = _flat(jax.tree.map(np.asarray, state_j.engine_state))
    assert any(k.startswith("e/") and np.abs(v).max() > 0 for k, v in want.items()
               if v is not None)
    engine = make_powersgd(transposed=leaf_table(ICA).transposed)
    task = tsteps.FederatedTask(tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2))
    like = tsteps.init_train_state(task, engine, tsteps.make_optimizer("adam", 1e-3), num_sites=3)
    got = tckpt.load_checkpoint(path, like)
    flat = _flat(train_state_to_jax(got)["engine_state"])
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert (flat[k] is None) == (v is None), k
        if v is not None:
            assert flat[k].dtype == v.dtype and flat[k].tobytes() == v.tobytes(), k
    assert got.round == int(state_j.round) == 1
    # the port's file restores in JAX
    port = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    port = dataclasses.replace(port, round=7)
    out = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(out, port)
    back = jckpt.load_checkpoint(out, state_j)
    assert int(back.round) == 7
    for k, v in _flat(jax.tree.map(np.asarray, back.engine_state)).items():
        assert (v is None) == (want[k] is None), k
        if v is not None:
            assert v.tobytes() == want[k].tobytes(), k
