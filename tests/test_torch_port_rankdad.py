"""The port's rankDAD engine (``engines/rankdad.py``) against the JAX
package's, one aggregation round at a time: JAX runs its engine under
``jax.vmap(..., axis_name=SITE_AXIS)``, the fold that ``make_train_epoch_fn``
uses with ``mesh=None``; the port runs the power iteration's plain version
on the CPU. The gradient tree holds an ``nn.Linear``-style leaf (stored
transposed in the port), an LSTM-style leaf (same layout in both), a 1-D
leaf and a leaf of rank class 2. Inputs are made with numpy from a seed;
the engine state (Ω) crosses as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.engines import make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    train_state_from_jax,
    train_state_to_jax,
)

S = 4
ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
KW = dict(dad_reduction_rank=3, dad_num_pow_iters=2, dad_tol=1e-3)
# (port name, JAX path, JAX shape of one site's leaf, stored transposed in the port)
LEAVES = (("enc.weight", ("enc", "kernel"), (8, 8), True),
          ("lstm.w_ih", ("lstm", "w_ih"), (8, 12), False),
          ("bias", ("bias",), (8,), False),
          ("head.weight", ("head", "kernel"), (6, 2), True))
TRANSPOSED = frozenset(n for n, _, _, tr in LEAVES if tr)
# f32: the two frameworks sum the products in other orders, carried through
# two unconverged refinements (measured: 7.2e-7 at values of ~1)
F32_TOL = dict(atol=5e-6, rtol=1e-5)
# bf16 payload and products: both sides round the same f32 values (measured:
# 6e-8), but an f32 value one ulp apart can round to the neighbouring bf16
# value (2**-9 relative) in a factor, an operand or the shipped payload
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


def _port_grads(flat):
    """The JAX-layout numpy gradients as the port's tensors (transposed
    leaves stored ``[S, out, in]``)."""
    return {n: torch.from_numpy(np.ascontiguousarray(flat[n].swapaxes(-1, -2) if tr else flat[n]))
            for n, _, _, tr in LEAVES}


def _to_jax_layout(agg):
    return {n: (agg[n].T if tr else agg[n]).numpy() for n, _, _, tr in LEAVES}


def _jax_round(grads, omega, weight, live, precision_bits="32", warm=True):
    eng = make_engine("rankDAD", precision_bits=precision_bits, dad_warm_start=warm,
                      fused_poweriter=False, **KW)
    state = {"omega": _jax_tree(omega)} if warm else {}

    def one(g, st, w, lv):
        return eng.aggregate(g, st, w, SITE_AXIS, live=lv)

    agg, new = jax.vmap(one, axis_name=SITE_AXIS)(
        _jax_tree(grads), state, jnp.asarray(weight), jnp.asarray(live))
    agg = _from_jax_tree(agg)
    return {n: a[0] for n, a in agg.items()}, (_from_jax_tree(new["omega"]) if warm else None)


def _jax_init_omega():
    eng = make_engine("rankDAD", fused_poweriter=False, **KW)
    one = _jax_tree({n: np.zeros(shape, np.float32) for n, _, shape, _ in LEAVES})
    om = _from_jax_tree(eng.init(one)["omega"])
    return {n: None if v is None else np.stack([v] * S) for n, v in om.items()}


def _port_round(grads, omega, weight, live, precision_bits="32", transposed=TRANSPOSED,
                warm=True):
    eng = make_rankdad(precision_bits=precision_bits, dad_warm_start=warm, transposed=transposed,
                       **KW)
    state = ({"omega": {n: None if v is None else torch.from_numpy(v) for n, v in omega.items()}}
             if warm else {})
    agg, new = eng.aggregate(_port_grads(grads), state, torch.from_numpy(weight),
                             live=torch.from_numpy(live))
    om = {n: None if v is None else v.numpy() for n, v in new["omega"].items()} if warm else None
    return _to_jax_layout(agg), om


WEIGHT = np.array([16.0, 9.0, 12.0, 5.0], np.float32)


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("precision_bits", ["32", "16"])
def test_aggregate_and_new_omega_match_jax(precision_bits, dead):
    """A warm round: the state is JAX's Ω after a first round, then both
    engines aggregate the next round's gradients; optionally site 2 is
    dead (its payload and weight are zeroed before the factorization)."""
    omega0 = _jax_init_omega()
    live1 = np.ones(S, np.float32)
    _, omega1 = _jax_round(_grads(0), omega0, WEIGHT, live1, precision_bits)
    live = live1.copy()
    if dead:
        live[2] = 0.0
    want, want_om = _jax_round(_grads(1), omega1, WEIGHT, live, precision_bits)
    got, got_om = _port_round(_grads(1), omega1, WEIGHT, live, precision_bits)
    tol = F32_TOL if precision_bits == "32" else BF16_TOL
    for n in want:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)
        if want_om[n] is None:
            assert got_om[n] is None, n
        else:
            np.testing.assert_allclose(got_om[n], want_om[n], err_msg=f"omega {n}", **tol)
    if dead:  # the dead site's new Ω is the Q of a zero gradient
        assert all(np.abs(got_om[n][2]).max() == 0 for n in got_om if got_om[n] is not None)


def test_a_leaf_taken_the_wrong_way_round_differs_from_jax():
    """The port's ``enc.weight`` is the transpose of the JAX kernel. Told
    so, the engine factorizes the transposed view and matches JAX; not told
    (the leaf is square, so the shapes still fit), it factorizes the other
    matrix, which an unconverged power iteration from the same Ω does not
    turn into the same factors."""
    omega0 = _jax_init_omega()
    live = np.ones(S, np.float32)
    want, want_om = _jax_round(_grads(3), omega0, WEIGHT, live)
    right, right_om = _port_round(_grads(3), omega0, WEIGHT, live)
    wrong, wrong_om = _port_round(_grads(3), omega0, WEIGHT, live,
                                  transposed=TRANSPOSED - {"enc.weight"})
    np.testing.assert_allclose(right["enc.weight"], want["enc.weight"], **F32_TOL)
    np.testing.assert_allclose(right_om["enc.weight"], want_om["enc.weight"], **F32_TOL)
    assert np.abs(wrong["enc.weight"] - want["enc.weight"]).max() > 1e-2
    assert np.abs(wrong_om["enc.weight"] - want_om["enc.weight"]).max() > 1e-1
    np.testing.assert_allclose(wrong["lstm.w_ih"], want["lstm.w_ih"], **F32_TOL)


def test_round_one_warm_equals_cold():
    """At init the engine state holds the cold-start draw, so the first
    round is the same with warm starts on or off."""
    grads = _port_grads(_grads(4))
    w = torch.from_numpy(WEIGHT)
    warm = make_rankdad(transposed=TRANSPOSED, **KW)
    params = {n: g[0] for n, g in grads.items()}
    state = {"omega": {n: None if v is None else v.unsqueeze(0).repeat(S, 1, 1)
                       for n, v in warm.init(params)["omega"].items()}}
    a, _ = warm.aggregate(grads, state, w)
    b, st = make_rankdad(dad_warm_start=False, transposed=TRANSPOSED, **KW).aggregate(grads, {}, w)
    assert st == {}
    for n in a:
        torch.testing.assert_close(a[n], b[n], atol=1e-6, rtol=0)


def test_init_keeps_omega_in_jax_orientation():
    eng = make_rankdad(transposed=TRANSPOSED, **KW)
    params = {n: p[0] for n, p in _port_grads(_grads(5)).items()}
    om = eng.init(params)["omega"]
    want = _jax_init_omega()
    for n, v in om.items():
        if want[n] is None:
            assert v is None, n
        else:
            assert tuple(v.shape) == want[n].shape[1:], n
    assert make_rankdad(dad_warm_start=False).init(params) == {}


def test_secure_aggregation_and_a_mesh_axis_are_refused():
    with pytest.raises(ValueError, match="only supported by the dSGD engine"):
        make_rankdad(secure_agg="mask")
    with pytest.raises(ValueError, match="secure_agg must be one of"):
        make_rankdad(secure_agg="nope")
    # the robust modes run with every site on one device only: over a
    # process group's axis they are refused
    from dinunet_implementations_tpu_torch.parallel.collectives import PackedAxis

    eng = make_rankdad(dad_warm_start=False, robust_agg="trimmed_mean")
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        eng.aggregate(_port_grads(_grads(6)), {}, torch.from_numpy(WEIGHT),
                      axis=PackedAxis(None, len(WEIGHT)))


def test_bridge_carries_omega_both_ways_and_init_stacks_it_per_site():
    C, W, T, IN, HID = 4, 5, 6, 16, 12
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       use_pallas=True, dropout_rate=0.0)
    engine = make_engine("rankDAD", fused_poweriter=False)
    state = jsteps.init_train_state(jsteps.FederatedTask(model), engine,
                                    jsteps.make_optimizer("adam", 1e-3), jax.random.PRNGKey(0),
                                    jnp.zeros((2, T, C, W)), num_sites=3)
    jstate = jax.tree.map(np.asarray, state)
    port = train_state_from_jax(jstate, device="cpu")
    om = port.engine_state["omega"]
    assert om["encoder.bias"] is None and om["cls_bn.weight"] is None
    np.testing.assert_array_equal(om["encoder.weight"].numpy(),
                                  jstate.engine_state["omega"]["encoder"]["kernel"])
    assert tuple(om["encoder.weight"].shape) == (3, 16, 10)  # [S, n=out, r] of the [20, 16] kernel
    back = train_state_to_jax(port)["engine_state"]["omega"]
    flat_j = jax.tree_util.tree_flatten_with_path(jstate.engine_state["omega"])[0]
    assert len(flat_j) == sum(v is not None for v in om.values())
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    assert back["encoder"]["bias"] is None
    # the port's own first state stacks its engine's per-site Ω the same way
    tmodel = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2)
    teng = make_rankdad(transposed=leaf_table(ICA).transposed)
    tstate = tsteps.init_train_state(tsteps.FederatedTask(tmodel), teng,
                                     tsteps.make_optimizer("adam", 1e-3), num_sites=3)
    for n, v in tstate.engine_state["omega"].items():
        assert (v is None) == (om[n] is None), n
        if v is not None:
            assert v.shape == om[n].shape, n
            assert torch.equal(v[0], v[2])  # every site starts from the same draw


def test_a_dead_sites_engine_state_is_frozen_leaf_by_leaf():
    """The epoch holds a dead site's rows of the nested engine state for the
    round (JAX's ``_freeze_dead``); dense leaves stay None and dSGD's empty
    state stays empty."""
    old = {"omega": {"w": torch.zeros(3, 4, 2), "b": None}}
    new = {"omega": {"w": torch.ones(3, 4, 2), "b": None}}
    out = tsteps._freeze_dead(torch.tensor([True, False, True]), new, old)
    assert out["omega"]["b"] is None
    assert torch.equal(out["omega"]["w"][:, 0, 0], torch.tensor([1.0, 0.0, 1.0]))
    assert tsteps._freeze_dead(torch.tensor([True]), {}, {}) == {}
