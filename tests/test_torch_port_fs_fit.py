"""The FS task's training, eval, fits, checkpoints, serving and command
line, the port against the JAX package.

Epochs and eval use a narrow MSANNet over three sites of uneven size; the
fits, checkpoints, serving and the CLI run on an FS demo tree at MSANNet's
full width (66 -> 256, 128, 64, 32 -> 2), two sites of uneven size. Both
fits start from one JAX-written checkpoint (``pretrained_path``). The JAX
side runs on the CPU as its own tests do; the port on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import lowrank as jlowrank
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import msannet as jmsan
from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.serving import engine as jserving
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.engines import powersgd as tpowersgd
from dinunet_implementations_tpu_torch.engines import rankdad as trankdad
from dinunet_implementations_tpu_torch.models import msannet as tmsan
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.serving import engine as tserving
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    params_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

TASK = "FS-Classification"
# the narrow model of the epoch tests: 12 features, three hidden layers;
# three sites of unequal size, batch 4 (the small sites wrap)
IN, HIDDEN, B = 12, (16, 8, 6), 4
SIZES = (9, 17, 13)
S = len(SIZES)
LR = 1e-3
EPOCHS = 2
DAD = dict(dad_reduction_rank=10, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)
TABLE = tmsan.MSANNet.leaf_table(len(HIDDEN))

# Tolerances of the epochs, set from the measured differences (f32):
# - the first round's aggregate gradient (mu / (1 - b1) after one Adam
#   step): dSGD f32 sums in another order (measured 3.6e-7 absolute, 1.4e-6
#   of a leaf's max); rankDAD and powerSGD at a share of each leaf's max
#   |aggregate|, as tests/test_torch_port_train.py holds them (its
#   DAD_AGG_SHARE and PSGD_AGG_SHARE): per-site gradients of rank <= 4
#   (batch 4) factored at r up to 10 carry noise columns (measured 5.8e-4
#   rankDAD, 9.9e-6 powerSGD);
# - the losses (measured 1.2e-7 dSGD and powerSGD, 1.0e-6 rankDAD);
# - params after two epochs (measured 6.0e-8 dSGD, 5.1e-6 rankDAD, 3.3e-7
#   powerSGD).
AGG_TOL = dict(atol=1e-6, rtol=1e-4)
AGG_SHARE = {"rankDAD": 1e-3, "powerSGD": 1e-4}
LOSS_TOL = {"dSGD": dict(atol=1e-6, rtol=1e-5), "rankDAD": dict(atol=1e-5, rtol=0),
            "powerSGD": dict(atol=1e-6, rtol=1e-5)}
PARAM_ATOL = 1e-4


def _sites(seed=0):
    rng = np.random.default_rng(seed)
    return [jdata.SiteArrays(rng.standard_normal((n, IN)).astype(np.float32),
                             rng.integers(0, 2, n).astype(np.int32),
                             np.arange(n, dtype=np.int32)) for n in SIZES]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_setup(engine_name):
    task = jsteps.FederatedTask(jmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN, out_size=2))
    engine = make_engine(engine_name, precision_bits="32",
                         **(DAD if engine_name == "rankDAD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                    jnp.zeros((2, IN)), num_sites=S)
    epoch = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="device")
    return task, state, epoch


def _port_setup(state_j, engine_name):
    model = tmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN, out_size=2)
    if engine_name == "rankDAD":
        engine = make_rankdad(precision_bits="32", transposed=TABLE.transposed, **DAD)
    elif engine_name == "powerSGD":
        engine = make_powersgd(precision_bits="32", transposed=TABLE.transposed,
                               leaf_index=TABLE.leaf_index)
    else:
        engine = make_dsgd("32")
    task = tsteps.FederatedTask(model)
    epoch = tsteps.make_train_epoch_fn(task, engine, tsteps.make_optimizer("adam", LR),
                                       device="cpu")
    return task, train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu"), epoch


@pytest.mark.parametrize("engine_name", ["dSGD", "rankDAD", "powerSGD"])
def test_fs_epochs_match_jax(engine_name):
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plans = [jbatching.plan_epoch_positions(sites, B, seed=e, pad_mode="wrap").positions
             for e in range(EPOCHS)]
    _, state_j, epoch_j = _jax_setup(engine_name)
    _, state_t, epoch_t = _port_setup(state_j, engine_name)
    assert state_t.batch_stats == {} and train_state_to_jax(state_t)["batch_stats"] == {}

    one_j, _ = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                       jnp.asarray(plans[0][:, :1]))
    one_t, _ = epoch_t(state_t, inv.inputs, inv.labels, plans[0][:, :1])
    got = _flat(train_state_to_jax(one_t)["opt_state"]["mu"])
    want = _flat(jax.tree.map(np.asarray, one_j.opt_state[0].mu))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if engine_name == "dSGD":
            np.testing.assert_allclose(got[k] / 0.1, w / 0.1, err_msg=k, **AGG_TOL)
        else:
            np.testing.assert_allclose(got[k] / 0.1, w / 0.1, rtol=0, err_msg=k,
                                       atol=AGG_SHARE[engine_name] * np.abs(w / 0.1).max())

    end_j, end_t, loss_j, loss_t = state_j, state_t, [], []
    for idx in plans:
        end_j, lj = epoch_j(end_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                            jnp.asarray(idx))
        end_t, lt = epoch_t(end_t, inv.inputs, inv.labels, idx)
        loss_j.append(np.asarray(lj))
        loss_t.append(lt.numpy())
    np.testing.assert_allclose(np.concatenate(loss_t), np.concatenate(loss_j),
                               **LOSS_TOL[engine_name])
    got, want = _flat(train_state_to_jax(end_t)["params"]), _flat(jax.tree.map(np.asarray,
                                                                                end_j.params))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=PARAM_ATOL, rtol=0, err_msg=k)
    if engine_name != "dSGD":
        es = _flat(train_state_to_jax(end_t)["engine_state"])
        jes = _flat(jax.tree.map(np.asarray, end_j.engine_state))
        assert {k for k, v in es.items() if v.dtype != object} == {
            k for k, v in jes.items() if v.dtype != object}


def test_fs_eval_takes_each_site_on_its_own_rows_as_jax():
    """``make_eval_fn`` of MSANNet: each site's BatchNorms take that site's
    masked batch moments (JAX's per-site vmap); a folded eval would not
    (measured 1.2e-7 on the probabilities, 0 on the loss sums)."""
    sites = _sites(seed=5)
    fb = jbatching.plan_eval(sites, B)
    task_j, state_j, _ = _jax_setup("dSGD")
    task_t, state_t, _ = _port_setup(state_j, "dSGD")
    pj, lj, wj = (np.asarray(a) for a in jsteps.make_eval_fn(task_j)(
        state_j, jnp.asarray(fb.inputs), jnp.asarray(fb.labels), jnp.asarray(fb.weights)))
    pt, lt, wt = (a.numpy() for a in tsteps.make_eval_fn(task_t, device="cpu")(
        state_t, fb.inputs, fb.labels, fb.weights))
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(wt, wj)
    # one forward over every site's rows of a step is not what JAX computes
    # for this model
    assert not tsteps.eval_folds_sites(task_t.model)
    st = tsteps._StateTask(task_t.model, {**state_t.params, **state_t.batch_stats})
    pf = np.stack([tsteps.eval_forward(
        st, torch.from_numpy(np.ascontiguousarray(fb.inputs[:, k])).reshape(S * B, -1),
        None, torch.from_numpy(np.ascontiguousarray(fb.weights[:, k])).reshape(-1)).numpy()
        for k in range(fb.inputs.shape[1])], 1)
    assert np.abs(pf.reshape(pj.shape) - pj).max() > 1e-3


def test_eval_folds_sites_only_where_every_batchnorm_keeps_running_statistics():
    """``make_eval_fn`` shares one forward among the sites exactly when
    each BatchNorm of the model normalizes by running statistics in eval:
    ICALstm's head BatchNorm does, MSANNet's take the batch moments."""
    from dinunet_implementations_tpu_torch.models import icalstm as tica

    assert tsteps.eval_folds_sites(tica.ICALstm(input_size=8, hidden_size=6, num_comps=3,
                                                window_size=2))
    assert not tsteps.eval_folds_sites(tmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN))


# -- fits over an FS demo tree at full width ------------------------------------

TREE = dict(n_sites=2, subjects=40, seed=3)
FIT_BATCH = 8
# Fit tolerances (epoch losses, validation loss, pooled test metrics, each
# site's test metrics; the metrics are rounded to 5 decimals), from the
# measured differences at full width: dSGD 1.8e-7 / 6.0e-8 / 0 / 0;
# powerSGD (JAX's first Q) 3.6e-7 / 1.7e-6 / 0 / 0; rankDAD (JAX's
# cold-start Ω), whose per-site gradients of rank <= 8 are factored at r =
# 10 with noise columns, 9.5e-7 / 2.9e-6 / 1e-5 / 1e-5, and with two
# epochs of pretraining first 3.3e-7 / 1.5e-6 / 0 / 1e-5. The test scores
# (accuracy, F1, AUC, ...) agree exactly in all of them.
FIT_TOL = {"dSGD": (dict(atol=1e-6, rtol=1e-5), 1e-5, 1e-4, 1e-4),
           "powerSGD": (dict(atol=1e-6, rtol=1e-5), 1e-5, 1e-4, 1e-4),
           "rankDAD": (dict(atol=1e-5, rtol=0), 1e-4, 1e-4, 1e-4)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fs_tree"))
    return tdemo.make_fs_demo_tree(root, **TREE)


@pytest.fixture(scope="module")
def start(tree, tmp_path_factory):
    """A JAX checkpoint of the tree's model: every fit here starts from its
    params."""
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    model = jregistry.get_task(TASK).build_model(cfg)
    state = jloop.FederatedTrainer(cfg, model, None).init_state(jnp.ones((2, 66)),
                                                                num_sites=TREE["n_sites"])
    path = str(tmp_path_factory.mktemp("start") / "start.msgpack")
    jckpt.save_checkpoint(path, state)
    return path


def _jax_omega(G, r, device=None):
    """JAX's cold-start Ω for a leaf of this shape, handed across."""
    m, n = (int(d) for d in tuple(getattr(G, "shape", G))[-2:])
    om = torch.from_numpy(np.array(jlowrank.default_omega(np.zeros((m, n)), r)))
    return om if device is None else om.to(device)


def _jax_q(seed, index, n, r, device=None):
    """JAX's first powerSGD Q of the leaf at ``index``, handed across."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    q = torch.from_numpy(np.array(jax.random.normal(key, (n, r), jnp.float32)))
    return q if device is None else q.to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(trankdad, "default_omega", _jax_omega)
    monkeypatch.setattr(tpowersgd, "default_q", _jax_q)


def _fit_kw(start, engine, **kw):
    return dict(dict(agg_engine=engine, epochs=3, batch_size=FIT_BATCH, seed=2,
                     monitor_metric="loss", pretrained_path=start), **kw)


def _compare_fits(got, want, engine):
    loss_tol, val_atol, metric_atol, site_atol = FIT_TOL[engine]
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], **loss_tol)
    assert got["best_val_epoch"] == want["best_val_epoch"]
    np.testing.assert_allclose(got["best_val_metric"], want["best_val_metric"], atol=val_atol,
                               rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=metric_atol,
                               rtol=0)
    np.testing.assert_allclose(got["site_test_metrics"], want["site_test_metrics"],
                               atol=site_atol, rtol=0)
    for k, v in want["test_scores"].items():
        np.testing.assert_allclose(got["test_scores"][k], v, atol=metric_atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_fs_fedrunner_fit_matches_jax(tree, start, tmp_path, jax_draws, engine):
    """``FedRunner(TrainConfig())`` over the FS tree (the default task), the
    port on the CPU against JAX's with ``mesh=None``; the sites differ in
    size (47 and 38 subjects)."""
    kw = _fit_kw(start, engine)
    want = jrunner.FedRunner(jconfig.TrainConfig(), data_path=tree, out_dir=str(tmp_path / "j"),
                             mesh=None, **kw).run(folds=[0], verbose=False)
    got = trunner.FedRunner(tconfig.TrainConfig(), data_path=tree, out_dir=str(tmp_path / "t"),
                            device="cpu", **kw).run(folds=[0], verbose=False)
    _compare_fits(got[0], want[0], engine)
    fold = tmp_path / "t" / "remote" / "simulatorRun" / TASK / "fold_0"
    for name in ("logs.json", "test_metrics.csv", "checkpoint_best.msgpack"):
        assert (fold / name).is_file(), name


def test_fs_pretraining_picks_jax_site_and_matches_jax(tree, start, tmp_path, jax_draws):
    """Largest-site pretraining on sites of uneven size: the site JAX
    picks (the larger), then a rankDAD fit."""
    kw = _fit_kw(start, "rankDAD", epochs=2, pretrain=True)
    block = {"pretrain_args": {"epochs": 2, "batch_size": FIT_BATCH, "learning_rate": 1e-2}}
    jc = jconfig.TrainConfig(**kw).with_overrides(block)
    tc = tconfig.TrainConfig(**kw).with_overrides(block)
    want = jrunner.FedRunner(jc, data_path=tree, out_dir=str(tmp_path / "j"),
                             mesh=None).run(folds=[0], verbose=False)
    got = trunner.FedRunner(tc, data_path=tree, out_dir=str(tmp_path / "t"),
                            device="cpu").run(folds=[0], verbose=False)
    _compare_fits(got[0], want[0], "rankDAD")
    plain = trunner.FedRunner(tconfig.TrainConfig(**_fit_kw(start, "rankDAD", epochs=2)),
                              data_path=tree, device="cpu", out_dir=str(tmp_path / "p")).run(
        folds=[0], verbose=False)
    assert got[0]["epoch_losses"] != plain[0]["epoch_losses"]


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_fs_checkpoints_cross_both_ways(tree, tmp_path, engine):
    """A JAX-written FS checkpoint (empty batch_stats, the engine's state)
    restores in the port leaf for leaf, and the port's restores in JAX."""
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(agg_engine=engine), tree)[0]
    tr = jloop.FederatedTrainer(cfg, jregistry.get_task(TASK).build_model(cfg), None)
    state_j = tr.init_state(jnp.ones((2, 66)), num_sites=2)
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(path, state_j, meta={"fold": 0})
    like = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    got = tckpt.load_checkpoint(path, like)
    a, b = _flat(train_state_to_jax(got)), _flat(train_state_to_jax(like))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    out = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(out, got, meta={"fold": 0})
    back, meta = jckpt.load_checkpoint(out, state_j, with_meta=True)
    assert meta == {"fold": 0} and back.batch_stats == {}
    want = jax.tree.map(np.asarray, state_j)
    for part in ("params", "engine_state"):
        fw, fb = _flat(getattr(want, part)), _flat(jax.tree.map(np.asarray, getattr(back, part)))
        assert fw.keys() == fb.keys(), part
        for k in fw:
            if fw[k].dtype != object:
                np.testing.assert_array_equal(fb[k], fw[k], err_msg=f"{part} {k}")
    params, stats, _ = tckpt.load_inference_state(out)
    assert stats == {}
    tcfg = tconfig.resolve_site_configs(tconfig.TrainConfig(), tree)[0]
    assert set(params_from_jax(tcfg, params, stats)) == set(got.params)


def test_fs_serving_dispatch_matches_jax(tree, start):
    """One dispatch of three requests padded to a bucket of 8, the port's
    engine from a JAX checkpoint against JAX's engine: the mask keeps the
    pad rows out of the BatchNorm moments (measured 1.2e-7)."""
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    tcfg = tconfig.resolve_site_configs(tconfig.TrainConfig(), tree)[0]
    rng = np.random.default_rng(6)
    reqs = [rng.random((n, 66)).astype(np.float32) for n in (2, 1, 3)]
    jeng = jserving.InferenceEngine(jcfg, checkpoint=start, row_buckets=(8,))
    teng = tserving.InferenceEngine(tcfg, checkpoint=start, row_buckets=(8,), device="cpu")
    try:
        jeng.warmup()
        teng.warmup()
        jr = [jserving._Req(r) for r in reqs]
        tr = [tserving._Req(r) for r in reqs]
        jeng._dispatch_infer(jr, 8)
        teng._dispatch_infer(tr, 8)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.future.result(timeout=30), b.future.result(timeout=30),
                                       atol=1e-6, rtol=1e-6)
        # a request's answer depends on the rows it shares a dispatch with
        alone = tserving._Req(reqs[0])
        teng._dispatch_infer([alone], 8)
        assert np.abs(alone.future.result(timeout=30) - tr[0].future.result()).max() > 1e-4
    finally:
        jeng.close()
        teng.close()


def test_cli_without_task_trains_fs(tree, start, tmp_path, capsys, jax_draws):
    """The port's CLI with no ``--task`` on an FS tree trains FS, as JAX's
    does: rankDAD with one pretraining epoch, fold 0, then ``--site 0``."""
    args = ["--data-path", tree, "--engine", "rankDAD", "--epochs", "2", "--folds", "0",
            "--batch-size", str(FIT_BATCH), "--quiet", "--set", "seed=2",
            "--set", f"pretrained_path={start}", "--set", "pretrain=true",
            "--set", 'pretrain_args={"epochs": 1, "batch_size": 8}']
    assert jcli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(got) == len(want) == 1 and list(got[0]) == list(want[0])
    for k in ("test_loss", "test_auc"):
        np.testing.assert_allclose(got[0][k], want[0][k], atol=FIT_TOL["rankDAD"][2], rtol=0)
    assert os.path.isfile(tmp_path / "port" / "remote" / "simulatorRun" / TASK / "fold_0" /
                          "checkpoint_best.msgpack")
    site = ["--data-path", tree, "--site", "0", "--epochs", "1", "--quiet", "--device", "cpu",
            "--out-dir", str(tmp_path / "site")]
    assert tcli.main(site) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["test_loss"])


def test_pretraining_picks_the_site_jax_picks_ties_included(monkeypatch):
    """``_pretrain`` warms up on the largest training site; of two equally
    large ones, the first, as JAX's ``np.argmax`` picks. Both planners see
    the same masked sites (only that site keeps rows)."""
    sizes = (20, 24, 24, 9)
    rng = np.random.default_rng(8)
    sites = [jdata.SiteArrays(rng.standard_normal((n, IN)).astype(np.float32),
                              rng.integers(0, 2, n).astype(np.int32),
                              np.arange(n, dtype=np.int32)) for n in sizes]
    kw = dict(fs_args=dict(input_size=IN, hidden_sizes=list(HIDDEN)), pretrain=True,
              pretrain_args={"epochs": 1, "batch_size": 8})
    seen = {}
    for name, mod in (("jax", jloop), ("port", tloop)):
        real = mod.plan_epoch

        def capture(planned, *a, _name=name, _real=real, **k):
            seen[_name] = [len(s) for s in planned]
            return _real(planned, *a, **k)

        monkeypatch.setattr(mod, "plan_epoch", capture)
    jcfg = jconfig.TrainConfig().with_overrides(kw)
    jtr = jloop.FederatedTrainer(jcfg, jregistry.get_task(TASK).build_model(jcfg), None)
    jtr._num_sites = len(sizes)
    jtr._pretrain(jtr.init_state(jnp.ones((2, IN)), num_sites=len(sizes)), sites, [], False)
    tcfg = tconfig.TrainConfig().with_overrides(kw)
    ttr = tloop.FederatedTrainer(tcfg, tmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN),
                                 device="cpu")
    ttr._num_sites = len(sizes)
    ttr._pretrain(ttr.init_state(), sites, False)
    assert seen["port"] == seen["jax"] == [0, 24, 0, 0]
