"""The port's training slice against the JAX package: whole federated dSGD
epochs of a small ICA-LSTM (trainer/steps.py make_train_epoch_fn, device
pipeline, sites folded onto one device), also with the fused bidirectional
arm (``ICALstm(fused_bidir=True)``), the epoch plan, dropout, the
optimizer, and the LSTM cell's two biases. The rankDAD and powerSGD epochs,
which hold the engines, are in ``test_torch_port_train_rankdad.py`` and
``test_torch_port_train_powersgd.py`` (this file's helpers), so that
``pytest --dist loadfile`` can run them on other workers.

The JAX epochs here run the Pallas LSTM kernels in interpret mode (the
low-rank files' run JAX's plain LSTM reference); the port runs the kernels'
plain versions on the CPU. Both start from one initial state, carried
across by ``weights.train_state_from_jax``; inputs are made with numpy from
a seed. ``_jax_setup`` builds each JAX model, state and epoch once a
process: the cases that share them skip XLA's compile of
``init_train_state`` and of the epoch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import api as tdata
from dinunet_implementations_tpu_torch.data import batching as tbatching
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models import layers as tlayers
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    params_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

# small ICA-LSTM: 6 windows of 4 components x 5 timepoints; 3 sites of
# unequal size, batch 4 (2, 4 and 3 batches: the small sites wrap)
C, W, T, IN, HID, B = 4, 5, 6, 16, 12, 4
ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
SIZES = (9, 17, 13)
S = len(SIZES)
LR = 1e-3
EPOCHS = 2

# The first round's aggregate gradient (mu / (1 - b1) after one Adam step)
# is compared tightly: f32 sums in another order. A bf16 payload rounds
# each site's f32 gradient, so a near-tie can round one bf16 ulp (2**-8
# relative) apart; the sites' values reach ~1.5e-2 and can cancel in the
# mean, so that ulp (~6e-5) bounds the absolute error.
AGG_TOL = {"32": dict(atol=1e-6, rtol=1e-4), "16": dict(atol=6e-5, rtol=1e-2)}
# Parameters after the epochs, on the scale of lr: an entry whose gradient
# is zero up to rounding (cls_fc1.bias, which the BatchNorm after it makes
# constant-invariant) gets Adam steps of about lr of either sign, so two
# correct trajectories can part by up to 2·lr a round.
PARAM_ATOL = 2 * LR * 8
# Adam moments: f32 sums in another order; bf16 payloads a few ulps apart.
MOMENT_TOL = {"32": (dict(atol=1e-6, rtol=1e-4), dict(atol=1e-9, rtol=1e-4)),
              "16": (dict(atol=5e-4, rtol=1e-2), dict(atol=2e-6, rtol=1e-2))}
LOSS_TOL = {"32": dict(atol=1e-6, rtol=1e-5), "16": dict(atol=2e-4, rtol=1e-3)}
# rankDAD: the small model's cls_fc1 and cls_fc2 gradients have rank <= 4
# per site (batch 4) against r = 10, so their factors' columns past that
# rank are orthonormalized rounding noise, and the reconstruction P·Qᵀ of
# those leaves moves with the last bits of the gradient. The first round's
# aggregate is held per leaf at a share of the leaf's max |aggregate|, set
# from JAX's own spread: the first round's per-site gradients (vmap(grad)
# of this test's small model and round) through JAX's two power-iteration
# paths, the Pallas interpret path and the legacy loop, disagree by up to
# 2.9e-4 of the leaf's max in f32 (cls_fc1/kernel; cls_fc2/kernel 1.5e-4;
# the other leaves <= 2.5e-7) and 7.3e-4 with the bf16 payload
# (cls_fc2/kernel; cls_fc1/kernel 5.6e-4); a one-ulp perturbation of the
# gradients moves the legacy path's aggregate by 2.7e-4 to 3.5e-4 in f32.
# (Inside the jitted epoch the two JAX paths agree bit for bit in f32 and
# by 7.1e-4 in bf16.) The shares are under 4x those spreads. Measured for
# the port: its engine fed JAX's gradients lands 2.3e-4 (f32) and 8.6e-4
# (bf16) from the legacy path, inside the spread
# (test_rankdad_engine_on_jax_gradients_is_inside_jax_spread); its whole
# epoch, whose gradients differ from JAX's in their last bits, 4.1e-4
# (f32) and 2.1e-3 (bf16), both on cls_fc1/kernel. cls_fc1/bias is zero in
# exact arithmetic (the BatchNorm after it removes any constant): its
# aggregate is rounding noise (~5e-8) with no scale of its own, so it is
# held at the share of the tree's largest aggregate. Ω after the first
# round is held at a share of each leaf's max |Ω| (measured 3.5e-4 in f32,
# 3.1e-3 in bf16). From there Adam's sign-like first steps part the
# trajectories as for dSGD's cls_fc1.bias, but on every leaf: params stay
# on the lr scale, later losses part by up to 1.1e-3 and the moments by up
# to 5.5 % of the tree's largest moment (measured over the three cases),
# and Ω, each site's Q of its last gradient at the parted params, is
# checked for shape and finiteness.
DAD_AGG_SHARE = {"32": 1e-3, "16": 2.9e-3}
NOISE_LEAVES = ("cls_fc1/bias",)
# The fused arm's first-round aggregate with the bf16 payload: where the two
# frameworks' f32 site gradients straddle a bf16 rounding boundary, that
# site's payload differs by one bf16 ulp (2**-7 of the value's binade), and
# a coordinate where two of the three sites flip moves the mean by up to
# one ulp of the largest site value (measured: 8.4e-5 on cls_fc2/kernel,
# whose aggregate reaches 3.7e-2). Each leaf is held within one ulp of its
# largest aggregate value.
FUSED_BF16_AGG_SHARE = 2.0 ** -7
DAD_OMEGA_SHARE = {"32": 1e-3, "16": 1e-2}
DAD_LOSS_ATOL = 3e-3
DAD_MOMENT_SHARE = 0.1
# powerSGD: the first round's aggregate, q and e per leaf at a share of the
# leaf's max |value| (q and e: each site's). In f32 the port lands 2.3e-5
# of cls_fc1/kernel's max from JAX (its engine fed JAX's gradients: 3.0e-5)
# and JAX's own aggregate moves by 1.9e-5 to 3.2e-5 when its gradients take
# relative noise of 1e-7 to 1e-6; q and e 4.5e-5 (q of cls_fc1/kernel,
# whose factor columns past the leaf's rank are rounding noise). With the
# bf16 wire, a payload value that straddles a bf16 rounding boundary moves
# the subspace P: JAX's own aggregate moves by 8.3e-3 to 1.2e-2 of a
# leaf's max under that gradient noise, and the port's epoch lands 1.05e-2
# from JAX (cls_fc2/kernel; e 7.4e-3). Later: as for rankDAD, params on the
# lr scale, moments at DAD_MOMENT_SHARE (measured 2.2 % in bf16, 3.6 % with
# a dead site), losses at LOSS_TOL without a dead site (measured 1.8e-6
# f32, 2.0e-4 bf16) and at DAD_LOSS_ATOL with one (4.1e-4): a site frozen
# through a dead round keeps its own q, whose noise columns then differ
# between the two runs.
PSGD_AGG_SHARE = {"32": 1e-4, "16": 2.5e-2}
PSGD_STATE_SHARE = {"32": 5e-4, "16": 5e-2}


def _sites(seed=0, cls=jdata.SiteArrays):
    rng = np.random.default_rng(seed)
    return [cls(rng.standard_normal((n, T, C, W)).astype(np.float32),
                rng.integers(0, 2, n).astype(np.int32), np.arange(n, dtype=np.int32))
            for n in SIZES]


# rankDAD's knobs: the JAX defaults (ICAArgs); the small model's leaves fall
# into rank classes 2, 6 and 10
DAD = dict(dad_reduction_rank=10, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)


@functools.lru_cache(maxsize=None)
def _jax_setup(pb, L, qr, engine_name="dSGD", fused=False, use_pallas=True):
    """The JAX side of a case: its initial state and its jitted epoch, built
    once a process for each key (the state's arrays are immutable and the
    epoch donates nothing, so the cases can share them)."""
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       use_pallas=use_pallas, dropout_rate=0.0, fused_bidir=fused or None)
    task = jsteps.FederatedTask(model)
    engine = make_engine(engine_name, precision_bits=pb, **(DAD if engine_name == "rankDAD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                    jnp.zeros((2, T, C, W)), num_sites=S)
    epoch = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, local_iterations=L,
                                       quarantine_rounds=qr, pipeline="device")
    return state, epoch


def _port_setup(state_j, pb, L, qr, engine_name="dSGD", fused=False):
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       dropout_rate=0.0, fused_bidir=fused or None)
    if engine_name == "rankDAD":
        engine = make_rankdad(precision_bits=pb, transposed=leaf_table(ICA).transposed, **DAD)
    elif engine_name == "powerSGD":
        engine = make_powersgd(precision_bits=pb, transposed=leaf_table(ICA).transposed)
    else:
        engine = make_dsgd(pb)
    epoch = tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), engine,
                                       tsteps.make_optimizer("adam", LR), local_iterations=L,
                                       quarantine_rounds=qr, device="cpu")
    return train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu"), epoch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _omega(tree):
    """The low-rank engines' state leaves (rankDAD's Ω, powerSGD's q and e)
    of an engine-state tree, flat; dense leaves hold None."""
    return {k: v for k, v in _flat(tree).items() if v.dtype != object}


def _compare(what, got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {k}", **tol)


def _compare_at_share(got, want, share):
    """The first-round aggregate, each leaf within ``share`` of its max
    |aggregate|; a leaf of rounding noise (``NOISE_LEAVES``, checked to be
    noise) within the share of the tree's largest aggregate."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    top = max(np.abs(v).max() for v in w.values())
    for k, v in w.items():
        scale = np.abs(v).max()
        if k in NOISE_LEAVES:
            assert scale <= 1e-5 * top, k
            scale = top
        np.testing.assert_allclose(g[k], v, rtol=0, atol=share * scale,
                                   err_msg=f"first-round aggregate {k}")


def _run(epoch, state, inv, plans, masks, to_dev):
    losses = []
    for idx, (live, poison) in zip(plans, masks):
        state, lo = epoch(state, to_dev(inv.inputs), to_dev(inv.labels), to_dev(idx),
                          None if live is None else to_dev(live),
                          None if poison is None else to_dev(poison))
        losses.append(np.asarray(lo))
    return state, np.concatenate(losses)


# (local_iterations, precision_bits, quarantine_rounds, fault, engine, fused
# bidirectional arm) per case: the dSGD and fused cases here, with JAX's
# Pallas kernels; the low-rank engines' in test_torch_port_train_rankdad.py
# and test_torch_port_train_powersgd.py, with JAX's plain LSTM
CASES = {
    "L1-f32": (1, "32", 3, None, "dSGD", False),
    "L2-f32": (2, "32", 3, None, "dSGD", False),
    "L1-bf16": (1, "16", 3, None, "dSGD", False),
    "live-drop": (1, "32", 3, "live", "dSGD", False),
    "nan-quarantine": (1, "32", 3, "poison", "dSGD", False),
    "unguarded": (1, "32", -1, None, "dSGD", False),
    "fused-f32": (1, "32", 3, None, "dSGD", True),
    "fused-bf16": (1, "16", 3, None, "dSGD", True),
}
RANKDAD_CASES = {
    "rankDAD-f32": (1, "32", 3, None, "rankDAD", False),
    "rankDAD-bf16": (1, "16", 3, None, "rankDAD", False),
    "rankDAD-live-drop": (1, "32", 3, "live", "rankDAD", False),
}
POWERSGD_CASES = {
    "powerSGD-f32": (1, "32", 3, None, "powerSGD", False),
    "powerSGD-bf16": (1, "16", 3, None, "powerSGD", False),
    "powerSGD-live-drop": (1, "32", 3, "live", "powerSGD", False),
}


def _masks(fault, rounds):
    """Per-epoch (live, poison) masks [S, rounds]: ``live`` drops site 0 in
    round 1 of the first epoch; ``poison`` turns site 1's batches to NaN in
    every round of the first epoch (3 rounds in a row: quarantine)."""
    out = []
    for e in range(EPOCHS):
        live = poison = None
        if fault == "live":
            live = np.ones((S, rounds), np.float32)
            if e == 0:
                live[0, 1] = 0.0
        if fault == "poison":
            poison = np.zeros((S, rounds), np.float32)
            if e == 0:
                poison[1] = 1.0
        out.append((live, poison))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_epochs_match_jax(case):
    _check_epochs(CASES[case], use_pallas=True)


def _check_epochs(case: tuple, use_pallas: bool) -> None:
    """One case of ``CASES``, ``RANKDAD_CASES`` or ``POWERSGD_CASES``: its first round's
    aggregate (and rankDAD's Ω, powerSGD's q and e), then its epochs' losses
    and end state, held against JAX's."""
    L, pb, qr, fault, engine_name, fused = case
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plans = [jbatching.plan_epoch_positions(sites, B, seed=e).positions for e in range(EPOCHS)]
    rounds = plans[0].shape[1] // L
    masks = _masks(fault, rounds)
    state_j, epoch_j = _jax_setup(pb, L, qr, engine_name, fused, use_pallas)
    state_t, epoch_t = _port_setup(state_j, pb, L, qr, engine_name, fused)

    dad, psgd = engine_name == "rankDAD", engine_name == "powerSGD"
    if fault is None or dad or psgd:
        # one round: its aggregate gradient is mu / (1 - b1) after one Adam step
        one_j, _ = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                           jnp.asarray(plans[0][:, :L]))
        one_t, _ = epoch_t(state_t, inv.inputs, inv.labels, plans[0][:, :L])
        agg = lambda mu: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)  # noqa: E731
        got_agg = agg(train_state_to_jax(one_t)["opt_state"]["mu"])
        if dad:
            _compare_at_share(got_agg, agg(one_j.opt_state[0].mu), DAD_AGG_SHARE[pb])
        elif psgd:
            _compare_at_share(got_agg, agg(one_j.opt_state[0].mu), PSGD_AGG_SHARE[pb])
        elif fused and pb == "16":
            _compare_at_share(got_agg, agg(one_j.opt_state[0].mu), FUSED_BF16_AGG_SHARE)
        else:
            _compare("first-round aggregate", got_agg, agg(one_j.opt_state[0].mu), **AGG_TOL[pb])
        if dad:
            got_om = _omega(train_state_to_jax(one_t)["engine_state"]["omega"])
            want_om = _omega(jax.tree.map(np.asarray, one_j.engine_state["omega"]))
            assert got_om.keys() == want_om.keys()
            for k, w in want_om.items():
                np.testing.assert_allclose(got_om[k], w, rtol=0,
                                           atol=DAD_OMEGA_SHARE[pb] * np.abs(w).max(),
                                           err_msg=f"first-round omega {k}")
        if psgd:
            got_qe = _omega(train_state_to_jax(one_t)["engine_state"])
            want_qe = _omega(jax.tree.map(np.asarray, one_j.engine_state))
            assert got_qe.keys() == want_qe.keys() and any(k.startswith("e/") for k in got_qe)
            for k, w in want_qe.items():
                np.testing.assert_allclose(got_qe[k], w, rtol=0,
                                           atol=PSGD_STATE_SHARE[pb] * np.abs(w).max(),
                                           err_msg=f"first-round {k}")

    end_j, loss_j = _run(epoch_j, state_j, inv, plans, masks, jnp.asarray)
    end_t, loss_t = _run(epoch_t, state_t, inv, plans, masks, lambda a: a)
    got = train_state_to_jax(end_t)
    want = jax.tree.map(np.asarray, end_j)

    assert loss_t.shape == loss_j.shape == (EPOCHS * rounds,)
    if dad or (psgd and fault):
        np.testing.assert_allclose(loss_t[0], loss_j[0], **LOSS_TOL[pb])
        np.testing.assert_allclose(loss_t, loss_j, atol=DAD_LOSS_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(loss_t, loss_j, **LOSS_TOL[pb])
    _compare("params", got["params"], want.params, atol=PARAM_ATOL, rtol=0)
    _compare("batch_stats", got["batch_stats"], want.batch_stats, atol=PARAM_ATOL, rtol=0)
    if dad or psgd:
        for m in ("mu", "nu"):
            w_m = getattr(want.opt_state[0], m)
            top = max(np.abs(v).max() for v in _flat(w_m).values())
            _compare(f"adam {m}", got["opt_state"][m], w_m, atol=DAD_MOMENT_SHARE * top, rtol=0)
        got_om = _omega(got["engine_state"])
        want_om = _omega(want.engine_state)
        assert got_om.keys() == want_om.keys()
        for k, w in want_om.items():
            assert got_om[k].shape == w.shape and np.isfinite(got_om[k]).all(), k
            if psgd and k.startswith("q/"):  # every site live in the last round
                assert all(np.array_equal(got_om[k][0], v) for v in got_om[k]), k
            if psgd and k.startswith("e/"):  # each site's residual is its own
                assert np.abs(got_om[k][0] - got_om[k][1]).max() > 0, k
    else:
        mu_tol, nu_tol = MOMENT_TOL[pb]
        _compare("adam mu", got["opt_state"]["mu"], want.opt_state[0].mu, **mu_tol)
        _compare("adam nu", got["opt_state"]["nu"], want.opt_state[0].nu, **nu_tol)
    assert got["opt_state"]["count"] == int(want.opt_state[0].count)
    assert got["round"] == int(want.round) == EPOCHS * rounds
    _compare("health", got["health"], want.health, atol=0, rtol=0)
    if fault == "poison":
        np.testing.assert_array_equal(got["health"]["quarantined"], [0, 1, 0])
        assert got["health"]["skips"][1] == EPOCHS * rounds
    if fault == "live":
        np.testing.assert_array_equal(got["health"]["skips"], [1, 0, 0])
    assert (got["engine_state"] == {}) == (not dad and not psgd)


def test_bias_leaves_take_one_adam_step_each_as_in_jax():
    """The JAX cell has two bias leaves, ``b_ih`` and ``b_hh``, that get the
    same cotangent; Adam steps each of them, so the effective bias moves by
    two steps. The port's cell keeps both leaves and must do the same."""
    sites = _sites(seed=3)
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       use_pallas=True, dropout_rate=0.0)
    task = jsteps.FederatedTask(model)
    x = jnp.asarray(sites[1].inputs[:B])
    y = jnp.asarray(sites[1].labels[:B])
    w = jnp.ones((B,), jnp.float32)
    params, stats = task.init_variables(jax.random.PRNGKey(1), x)

    def loss_fn(p):
        logits, _ = task.apply(p, stats, x, train=True, mask=w, mutable=True)
        return jsteps.cross_entropy(logits, y, w)

    opt = optax.adam(LR)
    updates, _ = opt.update(jax.grad(loss_fn)(params), opt.init(params), params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))

    port = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                      dropout_rate=0.0)
    port.load_state_dict(params_from_jax(ICA, jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, stats)))
    named = dict(port.named_parameters())
    logits = port(torch.from_numpy(np.array(x)), train=True, mask=torch.from_numpy(np.array(w)))
    loss = tsteps.cross_entropy(logits, torch.from_numpy(np.array(y)),
                                torch.from_numpy(np.array(w)))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    optimizer = tsteps.make_optimizer("adam", LR)
    upd, _ = optimizer.update(grads, optimizer.init(named))
    for d in ("fwd", "rev"):
        got = {leaf: (named[f"lstm.{d}.{leaf}"] + upd[f"lstm.{d}.{leaf}"]).detach().numpy()
               for leaf in ("b_ih", "b_hh")}
        ref = want["lstm"][d]
        for leaf in ("b_ih", "b_hh"):
            np.testing.assert_allclose(got[leaf], ref[leaf], atol=1e-6, rtol=0, err_msg=leaf)
        np.testing.assert_allclose(got["b_ih"] + got["b_hh"], ref["b_ih"] + ref["b_hh"],
                                   atol=2e-6, rtol=0)
        # the effective bias moved by two steps of about lr each
        moved = np.abs((got["b_ih"] + got["b_hh"])
                       - np.asarray(params["lstm"][d]["b_ih"] + params["lstm"][d]["b_hh"]))
        assert moved.max() > 1.5 * LR


def test_epoch_plan_is_byte_identical_to_jax():
    jsites, tsites = _sites(cls=jdata.SiteArrays), _sites(cls=tdata.SiteArrays)
    for kw in ({}, {"seed": 7}, {"shuffle": False}, {"steps": 9}, {"steps": 2},
               {"drop_last": False, "pad_mode": "mask"}, {"drop_last": False}):
        want = jbatching.plan_epoch_positions(jsites, B, **kw).positions
        got = tbatching.plan_epoch_positions(tsites, B, **kw).positions
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), kw
    assert tbatching.epoch_steps(tsites, B) == jbatching.epoch_steps(jsites, B)
    ti, ji = tdata.stack_site_inventory(tsites), jdata.stack_site_inventory(jsites)
    for name in ("inputs", "labels", "counts"):
        assert getattr(ti, name).tobytes() == getattr(ji, name).tobytes(), name


def test_gather_batch_matches_jax_with_padding_and_poison():
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    idx = jbatching.plan_epoch_positions(sites, B, drop_last=False, pad_mode="mask").positions
    poison = np.array([0, 1, 0], np.float32)
    for pz in (None, poison):
        want = jax.vmap(jsteps._gather_batch, in_axes=(0, 0, 0, None if pz is None else 0))(
            jnp.asarray(inv.inputs), jnp.asarray(inv.labels), jnp.asarray(idx),
            None if pz is None else jnp.asarray(pz))
        got = tsteps._gather_batch(torch.from_numpy(inv.inputs), torch.from_numpy(inv.labels),
                                   torch.from_numpy(idx), None if pz is None else torch.from_numpy(pz))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dropout_masks_per_site_and_micro_batch():
    rate = 0.25
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4, 64, 256)
    a = tlayers.site_dropout(x, rate, gen)
    b = tlayers.site_dropout(x, rate, gen)  # the next micro-batch
    for y in (a, b):
        kept = y != 0
        assert torch.all(y[kept] == 1 / (1 - rate))  # survivors scaled by 1/(1-p)
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.01  # 65,536 draws
    assert not torch.equal(a != 0, b != 0)  # each micro-batch draws anew
    assert not torch.equal(a[0] != 0, a[1] != 0)  # and each site its own
    # the same seed gives the same masks; rate 0 is the identity
    again = tlayers.site_dropout(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(again, a)
    assert tlayers.site_dropout(x, 0.0, gen) is x


def test_site_batchnorm_matches_the_module_per_site():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    mask = torch.tensor([[1, 1, 0, 1, 1], [1, 1, 1, 1, 1], [0, 1, 1, 0, 1]], dtype=torch.float32)
    weight, bias = 1 + 0.3 * torch.randn(3, 7), 0.2 * torch.randn(3, 7)
    rm, rv = 0.1 * torch.randn(3, 7), 1 + torch.rand(3, 7)
    y, (m, v) = tlayers.site_batchnorm_train(x, mask, weight, bias, rm, rv)
    for s in range(3):
        bn = tlayers.BatchNorm(7, track_running_stats=True)
        bn.load_state_dict({"weight": weight[s], "bias": bias[s], "running_mean": rm[s],
                            "running_var": rv[s]})
        torch.testing.assert_close(y[s], bn(x[s], train=True, mask=mask[s]), atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(m[s], bn.running_mean, atol=1e-7, rtol=1e-6)
        torch.testing.assert_close(v[s], bn.running_var, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax_over_steps(name):
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    jopt, topt = jsteps.make_optimizer(name, 0.01), tsteps.make_optimizer(name, 0.01)
    pj, sj = {k: jnp.asarray(v) for k, v in params.items()}, None
    sj = jopt.init(pj)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    st = topt.init(pt)
    for g in grads:
        u, sj = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, u)
        ut, st = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, st)
        pt = {k: v + ut[k] for k, v in pt.items()}
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6, rtol=1e-6)
    if name == "adam":
        assert int(st["count"]) == int(sj[0].count) == 4


@pytest.mark.parametrize("option,value", [
    ("sequence_microbatches", 2),
])
def test_unported_epoch_options_raise(option, value):
    task = tsteps.FederatedTask(tm.ICALstm(num_comps=C, window_size=W))
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        tsteps.make_train_epoch_fn(task, make_dsgd(), tsteps.make_optimizer("adam", LR),
                                   device="cpu", **{option: value})


# JAX make_train_epoch_fn options the port takes at JAX's default: the two
# execution details at any value, the two that act through another option
# at any value while that option is off, and the reputation layer's two
# knobs (any value; they act once robust_agg is on)
JAX_OPTION_DEFAULTS = {"rounds_scan_xs": True, "donate_state": False, "staleness_decay": 0.5,
                       "reputation_z": 2.0, "reputation_rounds": 8, "dp_seed": 0}


@pytest.mark.parametrize("option", sorted(JAX_OPTION_DEFAULTS))
def test_jax_epoch_options_at_their_defaults_build_an_epoch(option):
    import inspect

    assert inspect.signature(jsteps.make_train_epoch_fn).parameters[option].default == \
        JAX_OPTION_DEFAULTS[option]
    task = tsteps.FederatedTask(tm.ICALstm(num_comps=C, window_size=W))
    opt = tsteps.make_optimizer("adam", LR)
    assert callable(tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu",
                                               **{option: JAX_OPTION_DEFAULTS[option]}))
    # execution details take any value; the others any value while the
    # option they act through is off
    other = {"rounds_scan_xs": False, "donate_state": True, "staleness_decay": 0.25,
             "reputation_z": 3.0, "reputation_rounds": 2, "dp_seed": 7}[option]
    assert callable(tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu",
                                               **{option: other}))


def test_epoch_range_checks_hold():
    task = tsteps.FederatedTask(tm.ICALstm(num_comps=C, window_size=W))
    opt = tsteps.make_optimizer("adam", LR)
    # JAX's range checks hold whatever else is set
    bad = {"staleness_decay": 1.5, "reputation_rounds": -1}
    for k, v in bad.items():
        with pytest.raises(ValueError, match=k):
            tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", **{k: v})


def test_training_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from dinunet_implementations_tpu_torch.runner.registry import build_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA)
    task = tsteps.FederatedTask(tm.ICALstm(num_comps=C, window_size=W))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_train_epoch_fn(task, make_dsgd(), tsteps.make_optimizer("adam", LR))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_training(cfg)
    task, engine, opt = build_training(cfg, device="cpu")
    assert engine.name == "dSGD" and opt.name == "adam"
    assert all(p.device.type == "cpu" for p in task.model.parameters())
    cfg = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA, agg_engine="rankDAD")
    task, engine, _ = build_training(cfg, device="cpu")
    state = tsteps.init_train_state(task, engine, tsteps.make_optimizer("adam", LR), num_sites=2)
    assert engine.name == "rankDAD"
    # the nn.Linear weights' Ω follows the JAX kernel [in, out]: [S, out, r]
    assert tuple(state.engine_state["omega"]["encoder.weight"].shape) == (2, 256, 10)
    assert tuple(state.engine_state["omega"]["lstm.fwd.w_hh"].shape) == (2, 696, 10)
    assert state.engine_state["omega"]["encoder.bias"] is None
    task, engine, _ = build_training(dataclasses.replace(cfg, agg_engine="powerSGD"), device="cpu")
    state = tsteps.init_train_state(task, engine, tsteps.make_optimizer("adam", LR), num_sites=2)
    assert engine.name == "powerSGD"
    # q [S, n, r] and e [S, m, n] in the JAX orientation: the encoder's
    # kernel is [1000, 256]
    q, e = state.engine_state["q"], state.engine_state["e"]
    assert tuple(q["encoder.weight"].shape) == (2, 256, 10)
    assert tuple(e["encoder.weight"].shape) == (2, 1000, 256)
    assert tuple(q["lstm.fwd.w_hh"].shape) == (2, 696, 10)
    assert tuple(e["lstm.fwd.w_hh"].shape) == (2, 174, 696)
    assert q["encoder.bias"] is None and e["encoder.bias"] is None


# the TrainConfig fields that the federated trainer and the runner read, and
# the options they refuse at any value but "off"
TRAINER_FIELDS = ("mode", "epochs", "validation_epochs", "patience", "split_ratio", "num_folds",
                 "num_class", "monitor_metric", "metric_direction", "log_header",
                 "pretrained_path", "pretrain", "telemetry", "dp_clip", "dp_noise_multiplier",
                 "dp_seed", "dp_delta", "dp_epsilon_budget", "profile_dir", "xprof_dir",
                 "compile_cache_dir", "donate_epoch_state")
ICA_TRAINER_FIELDS = ("data_file", "labels_file", "window_stride", "split_files",
                     "monitor_metric", "metric_direction", "log_header")


def test_training_config_copy_keeps_the_jax_defaults():
    jcfg, tcfg = jconfig.TrainConfig(), tconfig.TrainConfig()
    names = {f.name for f in dataclasses.fields(tconfig.TrainConfig)}
    assert set(TRAINER_FIELDS) <= names, set(TRAINER_FIELDS) - names
    ica_names = {f.name for f in dataclasses.fields(tconfig.ICAArgs)}
    assert set(ICA_TRAINER_FIELDS) <= ica_names, set(ICA_TRAINER_FIELDS) - ica_names
    for f in dataclasses.fields(tconfig.TrainConfig):
        if f.name not in ("fs_args", "ica_args", "smri3d_args", "multimodal_args"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for block in ("smri3d_args", "multimodal_args"):
        assert dataclasses.asdict(getattr(tcfg, block)) == dataclasses.asdict(
            getattr(jcfg, block)), block
    assert tconfig.AggEngine.ALL == jconfig.AggEngine.ALL
    for f in dataclasses.fields(tconfig.ICAArgs):
        assert getattr(tcfg.ica_args, f.name) == getattr(jcfg.ica_args, f.name), f.name
    for f in dataclasses.fields(tconfig.FSArgs):
        assert getattr(tcfg.fs_args, f.name) == getattr(jcfg.fs_args, f.name), f.name


COMPAT_FIELDS = dict(num_reducers=3, pin_memory=True, num_workers=2,
                     dataloader_args={"train": {"drop_last": False}}, fused_poweriter=True)


@pytest.mark.parametrize("through_json", [False, True])
def test_compatibility_fields_round_trip_as_jax(through_json):
    """The reference's compatibility fields: a JAX config that sets them
    goes through both packages' ``with_overrides`` and ``to_dict`` with the
    same values (JAX's defaults when unset); they are read by nothing."""
    import json

    jcfg = jconfig.TrainConfig(**COMPAT_FIELDS)
    d = jcfg.to_dict()
    if through_json:
        d = json.loads(json.dumps(d))
    back_t = tconfig.TrainConfig().with_overrides(d)
    back_j = jconfig.TrainConfig().with_overrides(d)
    for name in COMPAT_FIELDS:
        assert getattr(back_t, name) == getattr(back_j, name) == COMPAT_FIELDS[name], name
        assert back_t.to_dict()[name] == back_j.to_dict()[name], name
        assert getattr(tconfig.TrainConfig(), name) == getattr(jconfig.TrainConfig(), name)
    assert tconfig.TrainConfig(num_reducers=2, pin_memory=True).num_reducers == 2


def test_fused_poweriter_false_is_refused_and_compspec_matches_jax():
    """``fused_poweriter=False`` (JAX's XLA loop) raises, by construction
    and through ``with_overrides``; None and True load. The compspec's GUI
    entries are JAX's (the ICA block's defaults on the port's fields)."""
    with pytest.raises(ValueError, match="CUDA kernel"):
        tconfig.TrainConfig(fused_poweriter=False)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tconfig.TrainConfig().with_overrides({"fused_poweriter": False})
    assert tconfig.TrainConfig(fused_poweriter=None).fused_poweriter is None
    got = tconfig.export_compspec()["computation"]["input"]
    want = jconfig.export_compspec()["computation"]["input"]
    assert set(got) == set(want)
    for key in ("num_reducers", "pin_memory", "num_workers"):
        assert got[key] == want[key], key
    for key, entry in got.items():
        ica = key == "ICA-Classification_args"
        assert {k: v for k, v in entry.items() if k != "default" or not ica} == {
            k: v for k, v in want[key].items() if k != "default" or not ica}, key
        if ica:
            assert entry["default"] == {k: want[key]["default"][k] for k in entry["default"]}
