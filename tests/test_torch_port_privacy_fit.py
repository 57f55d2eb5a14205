"""The port's privacy plane through its epochs, fits and surfaces, against
the JAX package's: DP-SGD, secure-aggregation and personalized epochs of
JAX's corner (tests/test_privacy.py ``_corner``: MSANNet 6→8→2, 4 sites,
2 steps of batch 4) under every engine, a personalized epoch of a small
ICA-LSTM (its classifier ``cls_fc3``), each site's personalized eval,
checkpoints with head rows both ways, the ε budget's clean stop, an exact
ε on resume, the rejoin reset, powerSGD's first Q under personalization,
the trainer's checks, ``FedDaemon``'s budget stop and the command line's
privacy flags.

The JAX epochs run the host pipeline with ``mesh=None`` (the ICA-LSTM on
its LSTM's plain reference), and the DP noise of both sides is JAX's,
handed across by monkeypatching ``privacy.dpsgd.default_draw``. The
tolerances are the FS epoch tests' (tests/test_torch_port_fs_fit.py
``LOSS_TOL`` and ``PARAM_ATOL``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fs_fit import LOSS_TOL, PARAM_ATOL
from test_torch_port_privacy import _jax_dp_draw

from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.privacy import accounting as jacct
from dinunet_implementations_tpu.privacy import personalize as jpers
from dinunet_implementations_tpu.robustness import membership as jmem
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import FSArgs, TrainConfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import build_engine, make_dsgd, make_powersgd
from dinunet_implementations_tpu_torch.engines import make_rankdad
from dinunet_implementations_tpu_torch.engines import powersgd as tpsgd
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.privacy import dpsgd as tdpsgd
from dinunet_implementations_tpu_torch.robustness import membership as tmem
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax

S, STEPS, B, D, LR = 4, 2, 4, 6, 1e-2
PAT = ("fc_out",)
TABLE = MSANNet.leaf_table(1)
DAD = dict(dad_reduction_rank=2, dad_num_pow_iters=2)
DP = dict(dp_clip=1.0, dp_noise_multiplier=0.5, dp_seed=3)


def _data(seed=0, sites=S):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(sites, STEPS, B, D)).astype(np.float32)
    y = (rng.random((sites, STEPS, B)) > 0.5).astype(np.int32)
    return x, y, np.ones((sites, STEPS, B), np.float32)


def _engines(name, **kw):
    if name == "rankDAD":
        return (make_engine("rankDAD", fused_poweriter=False, **DAD, **kw),
                make_rankdad(transposed=TABLE.transposed, **DAD, **kw))
    if name == "powerSGD":
        return (make_engine("powerSGD", dad_reduction_rank=2, **kw),
                make_powersgd(2, transposed=TABLE.transposed, leaf_index=TABLE.leaf_index, **kw))
    return make_engine("dSGD", **kw), make_dsgd(**kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _corner_epochs(name, epochs=2, personalize=(), engine_kw=None, jax_side=True, **kw):
    """``epochs`` host epochs of the corner on both sides from JAX's first
    state; returns the losses and both end states as JAX-layout trees (the
    port's alone when not ``jax_side``)."""
    jeng, teng = _engines(name, **(engine_kw or {}))
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    jopt = jsteps.make_optimizer("adam", LR)
    state_j = jsteps.init_train_state(task, jeng, jopt, jax.random.PRNGKey(0),
                                      jnp.ones((B, D), jnp.float32), num_sites=S,
                                      personalize=personalize)
    epoch_j = jsteps.make_train_epoch_fn(task, jeng, jopt, mesh=None, personalize=personalize,
                                         **kw)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    epoch_t = tsteps.make_train_epoch_fn(
        tsteps.FederatedTask(MSANNet(in_size=D, hidden_sizes=(8,), out_size=2)), teng,
        tsteps.make_optimizer("adam", LR), device="cpu", pipeline="host",
        personalize=personalize, **kw)
    lj, lt = [], []
    for e in range(epochs):
        x, y, w = _data(e)
        if jax_side:
            state_j, a = epoch_j(state_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
            lj.append(np.asarray(a))
        state_t, b = epoch_t(state_t, x, y, w)
        lt.append(b.numpy())
    return (np.concatenate(lt), np.concatenate(lj) if lj else None, train_state_to_jax(state_t),
            jax.tree.map(np.asarray, state_j))


def _check_params(got, want, what="params", atol=PARAM_ATOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


def _check_params_past_noise(got, want, g1, noise_atol):
    """The params at PARAM_ATOL, coordinate by coordinate, but where the
    first round's aggregate ``g1`` is rounding noise: at most 1e-5 of the
    round's largest, the rule of tests/test_torch_port_train.py's
    ``NOISE_LEAVES`` for a single coordinate. Adam's first step there is
    ``lr·g/(|g| + eps)``, a full step of either sign (the ICA-LSTM's
    ``cls_fc1/bias`` before the BatchNorm; a row of ``cls_fc2/kernel``
    whose unit sits at the ReLU's edge), so those coordinates are held at
    ``noise_atol``, the lr scale of the rounds run. ``cls_fc1/bias`` is
    checked to be noise throughout."""
    g, w = _flat(got), _flat(want)
    top = max(np.abs(v).max() for v in g1.values())
    assert np.abs(g1["cls_fc1/bias"]).max() <= 1e-5 * top
    for k, v in w.items():
        noise = np.abs(g1[k]) <= 1e-5 * top
        np.testing.assert_allclose(g[k][~noise], v[~noise], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"params {k}")
        np.testing.assert_allclose(g[k][noise], v[noise], rtol=0, atol=noise_atol,
                                   err_msg=f"params {k} (noise coordinates)")


@pytest.mark.parametrize("name", ["dSGD", "rankDAD", "powerSGD"])
def test_dp_epochs_match_jax_with_jax_s_noise(monkeypatch, name):
    """Two DP epochs (clip 1.0, σ 0.5) of every engine against JAX's, the
    noise JAX's on both sides: the losses at the engine's LOSS_TOL, the
    params at PARAM_ATOL."""
    monkeypatch.setattr(tdpsgd, "default_draw", _jax_dp_draw)
    lt, lj, st, sj = _corner_epochs(name, **DP)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL[name])
    _check_params(st["params"], sj.params)


@pytest.mark.parametrize("mode", ["mask", "mask-nopads"])
def test_secure_agg_epochs_match_jax(mode):
    """Two dSGD epochs on the masked wire (with DP clipping, as the golden
    privacy stack runs it) against JAX's: the losses at dSGD's LOSS_TOL,
    the params at PARAM_ATOL; "mask" and "mask-nopads" end bit for bit
    equal on the port."""
    kw = dict(engine_kw=dict(secure_agg=mode, secure_agg_seed=1), dp_clip=1.0)
    lt, lj, st, sj = _corner_epochs("dSGD", **kw)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL["dSGD"])
    _check_params(st["params"], sj.params)
    other = "mask-nopads" if mode == "mask" else "mask"
    _, _, st2, _ = _corner_epochs("dSGD", jax_side=False,
                                  **{**kw, "engine_kw": dict(secure_agg=other)})
    for k, v in _flat(st["params"]).items():
        assert v.tobytes() == _flat(st2["params"])[k].tobytes(), k


@pytest.mark.parametrize("name", ["dSGD", "rankDAD", "powerSGD"])
def test_personalized_epochs_match_jax(name):
    """Two personalized epochs (``fc_out``) of every engine against JAX's:
    the losses, the params (the global head frozen bit for bit at its first
    value), each site's head rows and their Adam rows (counts equal)."""
    lt, lj, st, sj = _corner_epochs(name, personalize=PAT)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL[name])
    _check_params(st["params"], sj.params)
    first, _ = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2)) \
        .init_variables(jax.random.PRNGKey(0), jnp.ones((B, D), jnp.float32))
    for leaf in ("kernel", "bias"):
        assert st["params"]["fc_out"][leaf].tobytes() == np.asarray(
            first["fc_out"][leaf]).tobytes()
    _check_params(st["personal"]["params"], sj.personal["params"], "heads")
    adam = sj.personal["opt"][0]
    np.testing.assert_array_equal(st["personal"]["opt"]["count"], np.asarray(adam.count))
    _check_params(st["personal"]["opt"]["mu"], adam.mu, "head mu")
    rows = st["personal"]["params"]["fc_out"]["kernel"]
    assert rows.shape[0] == S and not np.allclose(rows[0], rows[1])
    # the engine state covers the shared leaves only
    if st["engine_state"]:
        assert "fc_out" not in next(iter(st["engine_state"].values()))


def test_personalized_icalstm_epoch_and_eval_match_jax():
    """A personalized (``cls_fc3``) dSGD epoch of a small ICA-LSTM against
    JAX's (its LSTM's plain reference), then each site's eval on its own
    head: the losses at dSGD's LOSS_TOL; the head rows at PARAM_ATOL; the
    params at PARAM_ATOL, but for the coordinates whose first-round
    gradient is rounding noise (:func:`_check_params_past_noise`); the
    eval of JAX's end state on both sides, probabilities and loss sums
    within 1e-5 (the port's eval keeps the LSTM's site fold and runs the
    head per site)."""
    kw = dict(input_size=8, hidden_size=6, num_comps=3, window_size=4, num_cls=2,
              dropout_rate=0.0)
    jtask = jsteps.FederatedTask(jm.ICALstm(use_pallas=False, **kw))
    lr = 1e-3
    jeng, jopt = make_engine("dSGD"), jsteps.make_optimizer("adam", lr)
    pat = ("cls_fc3",)
    state_j = jsteps.init_train_state(jtask, jeng, jopt, jax.random.PRNGKey(1),
                                      jnp.zeros((B, 5, 3, 4)), num_sites=3, personalize=pat)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, B, 5, 3, 4)).astype(np.float32)
    y = rng.integers(0, 2, (3, 2, B)).astype(np.int32)
    w = np.ones((3, 2, B), np.float32)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    ttask = tsteps.FederatedTask(tm.ICALstm(**kw))
    epoch_j = jsteps.make_train_epoch_fn(jtask, jeng, jopt, mesh=None, personalize=pat)
    first, _ = epoch_j(state_j, jnp.asarray(x[:, :1]), jnp.asarray(y[:, :1]),
                       jnp.asarray(w[:, :1]))
    state_j, lj = epoch_j(state_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    state_t, lt = tsteps.make_train_epoch_fn(ttask, make_dsgd(), tsteps.make_optimizer(
        "adam", lr), device="cpu", pipeline="host", personalize=pat)(state_t, x, y, w)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOSS_TOL["dSGD"])
    got, want = train_state_to_jax(state_t), jax.tree.map(np.asarray, state_j)
    g1 = {k: v / 0.1 for k, v in _flat(first.opt_state[0].mu).items()}  # mu = (1 - b1)·g
    assert _flat(want.params).keys() == g1.keys()
    _check_params_past_noise(got["params"], want.params, g1, 2 * lr * 2)
    _check_params(got["personal"]["params"], want.personal["params"], "heads")
    state_t = train_state_from_jax(want, device="cpu")
    pj, lsj, _ = jsteps.make_eval_fn(jtask, mesh=None, personalize=pat)(
        state_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    pt, lst, _ = tsteps.make_eval_fn(ttask, "cpu", personalize=pat)(state_t, x, y, w)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lst.numpy(), np.asarray(lsj), atol=1e-5, rtol=1e-5)
    # the global heads for a state without rows, as JAX's
    plain = tsteps.make_eval_fn(ttask, "cpu")(state_t, x, y, w)[0]
    bare = tsteps.make_eval_fn(ttask, "cpu", personalize=pat)(
        tsteps.TrainState(**{**state_t.__dict__, "personal": None}), x, y, w)[0]
    assert torch.equal(plain, bare) and not torch.allclose(plain, pt)


def test_personalized_msannet_eval_matches_jax():
    """Each site of the corner on its own head (site 0's scaled by 3) in
    JAX's personalized eval and the port's (one forward a site): within
    1e-6."""
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    st = jsteps.init_train_state(task, make_engine("dSGD"), jsteps.make_optimizer("adam", LR),
                                 jax.random.PRNGKey(0), jnp.ones((B, D)), num_sites=S,
                                 personalize=PAT)
    bumped = jax.tree.map(lambda a: a.at[0].set(a[0] * 3.0), st.personal["params"])
    st = st.replace(personal={**st.personal, "params": bumped})
    x, y, w = _data(4)
    pj, lj, _ = jsteps.make_eval_fn(task, mesh=None, personalize=PAT)(st, x, y, w)
    tst = train_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    ttask = tsteps.FederatedTask(MSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    pt, lt, _ = tsteps.make_eval_fn(ttask, "cpu", personalize=PAT)(tst, x, y, w)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-6)


def test_personalized_checkpoints_cross_both_ways(tmp_path):
    """A personalized rankDAD state after an epoch: the port's file loads
    in JAX (its ``load_checkpoint(like=...)``) and JAX's in the port, heads,
    their Adam rows and the shared-leaf engine state bit for bit; a plain
    checkpoint restores into a personalized run with its fresh rows."""
    _, _, st, sj = _corner_epochs("rankDAD", epochs=1, personalize=PAT)
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    jeng, _ = _engines("rankDAD")
    like_j = jsteps.init_train_state(task, jeng, jsteps.make_optimizer("adam", LR),
                                     jax.random.PRNGKey(0), jnp.ones((B, D)), num_sites=S,
                                     personalize=PAT)
    state_t = train_state_from_jax(sj, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "port.msgpack"), state_t)
    back_j = jckpt.load_checkpoint(str(tmp_path / "port.msgpack"), like_j)
    jckpt.save_checkpoint(str(tmp_path / "jax.msgpack"), back_j)
    like_t = train_state_from_jax(jax.tree.map(np.asarray, like_j), device="cpu")
    back_t = train_state_to_jax(tckpt.load_checkpoint(str(tmp_path / "jax.msgpack"), like_t))
    want = train_state_to_jax(state_t)
    for key in ("params", "personal", "engine_state"):
        g, w = _flat(back_t[key]), _flat(want[key])
        assert g.keys() == w.keys(), key
        for k in w:
            if w[k].dtype != object:
                assert g[k].tobytes() == w[k].tobytes(), (key, k)
    np.testing.assert_array_equal(np.asarray(back_j.personal["opt"][0].count),
                                  want["personal"]["opt"]["count"])
    plain = tsteps.init_train_state(tsteps.FederatedTask(MSANNet(in_size=D, hidden_sizes=(8,),
                                                                 out_size=2)),
                                    make_rankdad(transposed=TABLE.transposed, **DAD),
                                    tsteps.make_optimizer("adam", LR), num_sites=S)
    tckpt.save_checkpoint(str(tmp_path / "plain.msgpack"), plain)
    with pytest.warns(UserWarning, match="engine state"):
        fresh = tckpt.load_checkpoint(str(tmp_path / "plain.msgpack"), like_t)
    assert torch.equal(fresh.personal["params"]["fc_out.weight"],
                       like_t.personal["params"]["fc_out.weight"])


def test_rejoin_resets_the_head_row_and_moves_it_with_its_site():
    """After a personalized powerSGD epoch: ``reset_slot_state`` puts the
    slot's head back to the current global head with a zeroed Adam row and
    a fresh shared-leaf engine row, as JAX's does (bit for bit); the other
    rows survive; ``move_slot_state`` carries the head row; a trainer's ε
    is untouched by either."""
    _, _, _, sj = _corner_epochs("powerSGD", epochs=1, personalize=PAT)
    jeng, teng = _engines("powerSGD")
    st = train_state_from_jax(sj, device="cpu")
    for slot in (1, 3):
        got = train_state_to_jax(tmem.reset_slot_state(st, slot, engine=teng))
        heads = got["personal"]["params"]["fc_out"]
        for leaf in ("kernel", "bias"):
            assert heads[leaf][slot].tobytes() == sj.params["fc_out"][leaf].tobytes()
            keep = [i for i in range(S) if i != slot]
            assert heads[leaf][keep].tobytes() == sj.personal["params"]["fc_out"][leaf][
                keep].tobytes()
        assert got["personal"]["opt"]["count"][slot] == 0
        assert not _flat(got["personal"]["opt"]["mu"])["fc_out/kernel"][slot].any()
        assert "fc_out" not in got["engine_state"]["q"]
    moved = train_state_to_jax(tmem.move_slot_state(st, 0, 2, engine=teng))
    assert moved["personal"]["params"]["fc_out"]["kernel"][2].tobytes() == \
        sj.personal["params"]["fc_out"]["kernel"][0].tobytes()
    # JAX's own reset on its state agrees on the head rows
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    like = jsteps.init_train_state(task, jeng, jsteps.make_optimizer("adam", LR),
                                   jax.random.PRNGKey(0), jnp.ones((B, D)), num_sites=S,
                                   personalize=PAT)
    sj_full = like.replace(params=jax.tree.map(jnp.asarray, sj.params),
                           personal=jax.tree.map(jnp.asarray, like.personal))
    want = jax.tree.map(np.asarray, jmem.reset_slot_state(sj_full, 1, engine=jeng))
    got = train_state_to_jax(tmem.reset_slot_state(train_state_from_jax(
        jax.tree.map(np.asarray, sj_full), device="cpu"), 1, engine=teng))
    for k, v in _flat(want.personal["params"]).items():
        assert _flat(got["personal"]["params"])[k].tobytes() == v.tobytes(), k


def test_powersgd_first_q_is_keyed_by_the_shared_leaf_index(monkeypatch):
    """Under personalization JAX's powerSGD sees the shared subtree and keys
    each first Q by the leaf's place in it: ``build_engine`` hands the
    port's ``default_q`` the same index for every leaf."""
    seen = []
    real = tpsgd.default_q

    def spy(seed, index, n, r, device=None):
        seen.append(index)
        return real(seed, index, n, r, device)

    monkeypatch.setattr(tpsgd, "default_q", spy)
    cfg = TrainConfig(agg_engine="powerSGD", personalize=("linear_0",),
                      fs_args=FSArgs(input_size=D, hidden_sizes=(8, 8)))
    model = MSANNet(in_size=D, hidden_sizes=(8, 8), out_size=2)
    tsteps.init_train_state(tsteps.FederatedTask(model), build_engine(cfg),
                            tsteps.make_optimizer("adam", LR), personalize=cfg.personalize)
    jparams, _ = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8, 8), out_size=2)) \
        .init_variables(jax.random.PRNGKey(0), jnp.ones((B, D)))
    shared = jpers.strip_tree(jparams, jpers.head_leaf_paths(jparams, ("linear_0",)),
                              keep_head=False)
    qs = jax.tree.leaves(make_engine("powerSGD").init(shared)["q"],
                         is_leaf=lambda v: v is None)
    want = [i for i, q in enumerate(qs) if q is not None]
    assert sorted(seen) == want and len(want) >= 2


# -- fits, the budget, resume, the daemon, the command line -----------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("privacy_tree"))
    tdemo.make_fs_demo_tree(root, n_sites=3, subjects=24, n_features=8, seed=2)
    return root


def _cfg(**kw):
    return TrainConfig(**{"batch_size": 4, "epochs": 3,
                          "fs_args": FSArgs(input_size=8, hidden_sizes=(8,)), **kw})


def _host_epsilon(runner, rounds):
    """JAX's accountant over the fit's rounds at the conservative corner."""
    fold = trunner.load_site_splits(runner.cfg, runner.site_dirs, runner.site_cfgs)[0]
    q = jacct.sampling_fraction(4, 1, [len(s) for s in fold["train"]])
    return jacct.RdpAccountant().step(jacct.effective_noise_multiplier(0.5), q,
                                      steps=rounds).epsilon(1e-5)[0]


def test_dp_fit_reports_epsilon_and_resumes_it_exactly(tree, tmp_path):
    """A 2-epoch DP fit reports JAX's host recompute of ε (same formula, to
    1e-12 relative) in its results and every ``logs.json``; a fit stopped
    after one epoch and resumed to two continues the ledger exactly (equal
    ε and ledger)."""
    kw = dict(dp_clip=1.0, dp_noise_multiplier=0.5, patience=99, epochs=2)
    a = trunner.FedRunner(_cfg(**kw), tree, str(tmp_path / "a"), device="cpu")
    ra = a.run(folds=[0], verbose=False)[0]
    meta = tckpt.load_meta(os.path.join(str(tmp_path / "a"), "remote", "simulatorRun",
                                        "FS-Classification", "fold_0",
                                        "checkpoint_latest.msgpack"))
    steps = meta["dp_accountant"]["steps"]
    assert ra["dp_epsilon"] == pytest.approx(_host_epsilon(a, steps), rel=1e-12)
    assert ra["dp_delta"] == 1e-5
    logs = json.load(open(os.path.join(str(tmp_path / "a"), "local1", "simulatorRun",
                                       "FS-Classification", "fold_0", "logs.json")))
    assert logs["dp_epsilon"] == ra["dp_epsilon"]
    out = str(tmp_path / "b")
    trunner.FedRunner(_cfg(**{**kw, "epochs": 1}), tree, out, device="cpu").run(
        folds=[0], verbose=False)
    rb = trunner.FedRunner(_cfg(**kw), tree, out, device="cpu").run(
        folds=[0], verbose=False, resume=True)[0]
    assert rb["dp_epsilon"] == ra["dp_epsilon"]
    meta_b = tckpt.load_meta(os.path.join(out, "remote", "simulatorRun", "FS-Classification",
                                          "fold_0", "checkpoint_latest.msgpack"))
    assert meta_b["dp_accountant"] == meta["dp_accountant"]


def test_the_epsilon_budget_stops_a_fit_cleanly(tree, tmp_path):
    """A budget below one epoch's ε stops after that epoch's checkpoint,
    tests the best state and reports ε ≥ budget; the checks on the DP knobs
    are JAX's ValueErrors."""
    res = trunner.FedRunner(_cfg(dp_clip=1.0, dp_noise_multiplier=0.5, dp_epsilon_budget=1.0,
                                 epochs=5, patience=99), tree, str(tmp_path), device="cpu"
                            ).run(folds=[0], verbose=False)[0]
    assert res["stopped_epoch"] == 1 and res["dp_epsilon"] >= 1.0
    assert np.isfinite(res["test_metrics"][0][0])
    model = MSANNet(in_size=8, hidden_sizes=(8,), out_size=2)
    for kw, match in (({"dp_delta": 1.0}, "dp_delta"), ({"dp_epsilon_budget": -1.0}, ">= 0"),
                      ({"dp_epsilon_budget": 2.0, "dp_clip": 1.0}, "needs dp_noise"),
                      ({"dp_noise_multiplier": 1.0}, "needs dp_clip")):
        with pytest.raises(ValueError, match=match):
            tloop.FederatedTrainer(_cfg(**kw), model, device="cpu")
    with pytest.raises(ValueError, match="needs dp_clip"):
        tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), make_dsgd(),
                                   tsteps.make_optimizer("adam", LR), device="cpu",
                                   dp_noise_multiplier=0.5)


def test_the_daemon_stops_on_its_budget_and_a_rejoin_keeps_epsilon(tree, tmp_path):
    """``FedDaemon`` under DP with a personalized head: a budget crossed in
    the second epoch checkpoints, latches the stop and counts
    ``serve_dp_budget_stops_total``; resetting a slot (a rejoin) leaves
    the trainer's ε as it was."""
    d = trunner.FedDaemon(_cfg(dp_clip=1.0, dp_noise_multiplier=0.5, dp_epsilon_budget=3.0,
                               personalize=("fc_out",)), capacity=4, data_path=tree,
                          out_dir=str(tmp_path), poll_s=0.01, inventory_rows=32,
                          verbose=False, device="cpu")
    summary = d.serve(max_epochs=10)
    eps = d.trainer._dp_epsilon
    assert 1 <= d.epochs_run < 10 and eps >= 3.0
    assert "serve_dp_budget_stops_total" in json.dumps(d.bus.snapshot(), default=str)
    assert summary is not None
    state = tmem.reset_slot_state(d.state, 0, engine=d.trainer.engine)
    assert torch.equal(state.personal["params"]["fc_out.weight"][0],
                       d.state.params["fc_out.weight"])
    assert d.trainer._dp_epsilon == eps
    assert os.path.exists(d.ckpt_path)


def test_a_resumed_daemon_continues_epsilon_and_keeps_its_budget_stop(tree, tmp_path):
    """``FedDaemon`` writes its privacy ledger into the checkpoint meta: a
    daemon resumed after its budget stop restores ε exactly and trains no
    epoch past the budget; resumed under a larger budget, its ledger goes
    on from the checkpointed one (one more epoch's rounds, larger ε)."""
    kw = dict(capacity=4, out_dir=str(tmp_path), poll_s=0.01, inventory_rows=32,
              verbose=False, device="cpu")
    dp = dict(dp_clip=1.0, dp_noise_multiplier=0.5)
    d = trunner.FedDaemon(_cfg(**dp, dp_epsilon_budget=3.0), data_path=tree, **kw)
    d.serve(max_epochs=10)
    eps, ledger, epochs = d.trainer._dp_epsilon, d.trainer.dp_accountant.to_json(), d.epochs_run
    assert eps >= 3.0 and tckpt.load_meta(d.ckpt_path)["dp_accountant"] == ledger
    r = trunner.FedDaemon(_cfg(**dp, dp_epsilon_budget=3.0), resume=True, **kw)
    assert r.trainer._dp_epsilon == eps and r.trainer.dp_accountant.to_json() == ledger
    r.serve(max_epochs=10)
    assert r.epochs_run == epochs and r.trainer.dp_accountant.to_json() == ledger
    m = trunner.FedDaemon(_cfg(**dp, dp_epsilon_budget=1e9), resume=True, **kw)
    m.serve(max_epochs=1)
    assert m.epochs_run == epochs + 1 and m.trainer._dp_epsilon > eps
    assert m.trainer.dp_accountant.to_json()["steps"] == ledger["steps"] * (epochs + 1) // epochs


def test_the_cli_takes_the_privacy_flags(tree, tmp_path, capsys):
    """``--dp-clip 1 --dp-noise 0.5 --secure-agg mask --personalize fc_out``
    runs a fold and prints JAX's JSON line; each site's ``logs.json``
    carries the fit's ε."""
    out = str(tmp_path / "out")
    assert tcli.main(["--data-path", tree, "--epochs", "2", "--folds", "0", "--batch-size", "4",
                      "--dp-clip", "1", "--dp-noise", "0.5", "--secure-agg", "mask",
                      "--personalize", "fc_out", "--out-dir", out, "--device", "cpu", "--quiet",
                      "--set", 'fs_args={"input_size": 8, "hidden_sizes": [8]}']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["fold"] == 0 and np.isfinite(line["test_loss"])
    logs = json.load(open(os.path.join(out, "local0", "simulatorRun", "FS-Classification",
                                       "fold_0", "logs.json")))
    assert logs["dp_epsilon"] > 0


def test_the_hard_snr_tree_is_the_golden_recipe_s(tmp_path):
    """``data.make_hard_ica_tree`` writes the JAX tests' hard-SNR tree (the
    golden privacy-stack recipe's) byte for byte: the timecourses, the
    labels and the inputspec."""
    from test_golden import _make_hard_ica_tree

    want, got = tmp_path / "jax", str(tmp_path / "port")
    want.mkdir()
    _make_hard_ica_tree(want, n_sites=6)
    tdemo.make_hard_ica_tree(got, n_sites=6)
    for i in range(6):
        for name in ("timecourses.npz", "labels.csv"):
            a = want / "input" / f"local{i}" / "simulatorRun" / name
            b = os.path.join(got, "input", f"local{i}", "simulatorRun", name)
            if name.endswith(".npz"):
                assert np.array_equal(np.load(a)["arr_0"], np.load(b)["arr_0"])
            else:
                assert a.read_text() == open(b).read()
    assert json.loads((want / "inputspec.json").read_text()) == json.load(
        open(os.path.join(got, "inputspec.json")))
