"""The port's fit slice against the JAX package: ``FederatedTrainer`` and
``FedRunner`` on an ICA demo tree. The host pipeline of
``make_train_epoch_fn`` (against the port's device pipeline and JAX's host
epoch), ``make_eval_fn`` and the metrics are in
``test_torch_port_fit_epochs.py`` (this file's helpers), so that ``pytest
--dist loadfile`` can run them on another worker.

The JAX side runs on the CPU as its own tests do (``mesh=None``, the scan
LSTM); the port runs the kernels' plain versions on the CPU. Both start
from one state, carried across as numpy (``weights.train_state_from_jax``)
or through a checkpoint that JAX wrote. Models are built with dropout 0
where a fit is compared: the two draw their dropout masks from different
generators (ROADMAP queue C).
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
from dinunet_implementations_tpu.engines import lowrank as jlowrank
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_rankdad
from dinunet_implementations_tpu_torch.engines import powersgd as tpowersgd
from dinunet_implementations_tpu_torch.engines import rankdad as trankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    train_state_from_jax,
    train_state_to_jax,
)

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

# the small ICA-LSTM of tests/test_torch_port_train.py: 6 windows of 4
# components x 5 timepoints, 3 sites of unequal size, batch 4
C, W, T, IN, HID, B = 4, 5, 6, 16, 12, 4
ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
SIZES = (9, 17, 13)
S = len(SIZES)
LR = 1e-3
DAD = dict(dad_reduction_rank=10, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)
# The host epoch against JAX's host epoch: the tolerances of
# test_torch_port_train.py::test_epochs_match_jax (f32). Losses: f32 sums
# in another order. Params on the scale of lr: an entry whose gradient is
# rounding noise (cls_fc1.bias) takes Adam steps of about lr of either sign
# in each run. rankDAD's later losses part by up to 1.1e-3 there (its
# factors of rank-deficient leaves are orthonormalized rounding noise).
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
DAD_LOSS_ATOL = 3e-3
PARAM_ATOL = 2 * LR * 8
MU_TOL, NU_TOL = dict(atol=1e-6, rtol=1e-4), dict(atol=1e-9, rtol=1e-4)


def _sites(seed=0, cls=jdata.SiteArrays, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [cls(rng.standard_normal((n, T, C, W)).astype(np.float32),
                rng.integers(0, 2, n).astype(np.int32), np.arange(n, dtype=np.int32))
            for n in sizes]


def _jax_task():
    return jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))


def _jax_state(engine_name="dSGD", seed=0):
    task = _jax_task()
    engine = make_engine(engine_name, precision_bits="32",
                         **(DAD if engine_name == "rankDAD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(seed),
                                    jnp.zeros((2, T, C, W)), num_sites=S)
    return task, engine, opt, state


def _port_task():
    return tsteps.FederatedTask(tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))


def _port_engine(engine_name):
    if engine_name == "rankDAD":
        return make_rankdad(precision_bits="32", transposed=leaf_table(ICA).transposed, **DAD)
    return make_dsgd("32")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _compare(what, got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        if w[k].dtype == object:
            assert g[k].dtype == object, f"{what} {k}"
            continue
        np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {k}", **tol)


def _same_state(a, b):
    """Two port states equal bit for bit, leaf by leaf."""
    ja, jb = train_state_to_jax(a), train_state_to_jax(b)
    fa, fb = _flat(ja), _flat(jb)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k].dtype == object:
            assert fb[k].dtype == object, k
        else:
            assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes(), k


# -- the trainer and the runner on an ICA demo tree ---------------------------

# the demo tree's narrow model: 8 windows of 16 components x 10 timepoints,
# encoder 32, BiLSTM 24; 3 sites of 40 subjects: 32 / 4 / 4 a site
TREE = dict(n_sites=3, subjects=40, comps=16, temporal=80, window=10)
FIT_BATCH = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ica_tree")
    return tdemo.make_ica_demo_tree(str(root), **TREE)


def _cfgs(tree_root, **kw):
    """The JAX and port configs of one fit over ``tree_root``."""
    base = dict(dict(task_id="ICA-Classification", batch_size=FIT_BATCH, seed=2), **kw)
    jc = jconfig.resolve_site_configs(jconfig.TrainConfig(**base), tree_root)[0]
    tc = tconfig.resolve_site_configs(tconfig.TrainConfig(**base), tree_root)[0]
    return jc.replace(num_sites=TREE["n_sites"]), tc.replace(num_sites=TREE["n_sites"])


def _models(cfg_j, cfg_t):
    a = cfg_j.ica_args
    jmodel = jm.ICALstm(input_size=a.input_size, hidden_size=a.hidden_size, num_cls=2,
                        num_comps=a.num_components, window_size=a.window_size, dropout_rate=0.0)
    b = cfg_t.ica_args
    tmodel = tm.ICALstm(input_size=b.input_size, hidden_size=b.hidden_size, num_cls=2,
                        num_comps=b.num_components, window_size=b.window_size, dropout_rate=0.0,
                        generator=torch.Generator().manual_seed(cfg_t.seed))
    return jmodel, tmodel


def _pretrained(tmp_path, cfg_j, jmodel):
    """A checkpoint of JAX's first state of this fit: both fits start from
    its params."""
    tr = jloop.FederatedTrainer(cfg_j, jmodel, None)
    state = tr.init_state(jnp.ones((2, 8, cfg_j.ica_args.num_components,
                                    cfg_j.ica_args.window_size)), num_sites=TREE["n_sites"])
    path = str(tmp_path / "pretrained.msgpack")
    jckpt.save_checkpoint(path, state)
    return path


def _jax_omega(G, r, device=None):
    """JAX's cold-start Ω for a leaf of this shape, handed across as numpy
    (the port draws its own: ROADMAP queue C)."""
    m, n = (int(d) for d in tuple(getattr(G, "shape", G))[-2:])
    om = torch.from_numpy(np.array(jlowrank.default_omega(np.zeros((m, n)), r)))
    return om if device is None else om.to(device)


def _jax_q(seed, index, n, r, device=None):
    """JAX's first powerSGD Q for the leaf at ``index``, handed across as
    numpy (the port draws its own: ROADMAP queue C)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    q = torch.from_numpy(np.array(jax.random.normal(key, (n, r), jnp.float32)))
    return q if device is None else q.to(device)


def _fit_pair(tree_root, tmp_path, monkeypatch=None, **kw):
    cfg_j, cfg_t = _cfgs(tree_root, **kw)
    jmodel, tmodel = _models(cfg_j, cfg_t)
    path = _pretrained(tmp_path, cfg_j, jmodel)
    cfg_j, cfg_t = cfg_j.replace(pretrained_path=path), cfg_t.replace(pretrained_path=path)
    if monkeypatch is not None:
        monkeypatch.setattr(trankdad, "default_omega", _jax_omega)
        monkeypatch.setattr(tpowersgd, "default_q", _jax_q)
    jf = jrunner.load_site_splits(cfg_j, jrunner.discover_site_dirs(tree_root))[0]
    tf = trunner.load_site_splits(cfg_t, trunner.discover_site_dirs(tree_root))[0]
    want = jloop.FederatedTrainer(cfg_j, jmodel, None).fit(
        jf["train"], jf["validation"], jf["test"], verbose=False)
    got = tloop.FederatedTrainer(cfg_t, tmodel, device="cpu").fit(
        tf["train"], tf["validation"], tf["test"], verbose=False)
    return got, want


# (engine, options): dSGD selecting on AUC over 4 epochs; dSGD selecting on
# the validation loss and stopping on patience; rankDAD and powerSGD on the
# loss
FIT_CASES = {
    "dSGD-auc": ("dSGD", dict(epochs=4, monitor_metric="auc", patience=35)),
    "dSGD-loss-patience": ("dSGD", dict(epochs=10, monitor_metric="loss", patience=2,
                                        learning_rate=1e-2)),
    "rankDAD-loss": ("rankDAD", dict(epochs=3, monitor_metric="loss")),
    "powerSGD-loss": ("powerSGD", dict(epochs=3, monitor_metric="loss")),
}
# Tolerances (epoch losses, validation score, pooled test metrics, each
# site's test metrics), set from the measured differences:
# - dSGD: epoch losses are f32 sums in another order (measured 2.7e-7).
#   The scores are on the tree's 12 validation / test rows; at lr 1e-2 the
#   validation loss parts by 7.7e-5 and the pooled test loss by 3e-5
#   (both 0 or 1e-5 at lr 1e-3). A site's own test loss, over 4 rows,
#   parts by more (measured 1.2e-4): cls_fc1.bias, whose gradient is
#   rounding noise, takes Adam steps of about lr of either sign in each
#   run, and the eval BatchNorm removes it only up to its running mean's
#   lag.
# - rankDAD: the factors of rank-deficient leaves are orthonormalized
#   rounding noise, so the trajectories part from the first rounds
#   (test_torch_port_train.py's DAD_LOSS_ATOL; measured 1.0e-3 on the
#   epoch losses, 5.0e-4 on the validation loss, 6.3e-4 on the test loss,
#   7.8e-4 on a site's).
# - powerSGD, with JAX's first Q: its reconstruction of a rank-deficient
#   leaf is the aggregate's projection on its own span, so the epoch losses
#   stay on dSGD's scale (measured 6.0e-8); the scores part as dSGD's at lr
#   1e-2, by the cls_fc1.bias noise of Adam and the factors' rounding
#   (measured 1.6e-4 on the validation loss, 2.2e-4 on the test loss, 4.1e-4
#   on a site's).
FIT_TOL = {"dSGD": (dict(atol=1e-5, rtol=1e-5), 2e-4, 1e-4, 5e-4),
           "powerSGD": (dict(atol=1e-5, rtol=1e-5), 5e-4, 5e-4, 1e-3),
           "rankDAD": (dict(atol=DAD_LOSS_ATOL, rtol=0), DAD_LOSS_ATOL, DAD_LOSS_ATOL,
                       DAD_LOSS_ATOL)}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_matches_jax_from_one_jax_checkpoint(tree, tmp_path, monkeypatch, case):
    engine_name, kw = FIT_CASES[case]
    got, want = _fit_pair(tree, tmp_path, monkeypatch if engine_name != "dSGD" else None,
                          agg_engine=engine_name, **kw)
    loss_tol, val_atol, metric_atol, site_atol = FIT_TOL[engine_name]
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], **loss_tol)
    assert got["best_val_epoch"] == want["best_val_epoch"]
    assert got["stopped_epoch"] == want["stopped_epoch"]
    np.testing.assert_allclose(got["best_val_metric"], want["best_val_metric"],
                               atol=val_atol, rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=metric_atol,
                               rtol=0)
    np.testing.assert_allclose(got["site_test_metrics"], want["site_test_metrics"],
                               atol=site_atol, rtol=0)
    for k, v in want["test_scores"].items():
        np.testing.assert_allclose(got["test_scores"][k], v, atol=metric_atol, rtol=0,
                                   err_msg=k)
    assert got["site_health"] == {k: v for k, v in want["site_health"].items()}
    if case == "dSGD-loss-patience":
        assert got["stopped_epoch"] < kw["epochs"]  # the patience stop happened


def _port_trainer(cfg_t, out_dir=None):
    _, tmodel = _models(cfg_t, cfg_t)
    return tloop.FederatedTrainer(cfg_t, tmodel, out_dir=out_dir, device="cpu")


def _port_fold(cfg_t, tree_root, k=0):
    return trunner.load_site_splits(cfg_t, trunner.discover_site_dirs(tree_root))[k]


def test_final_validation_below_the_cadence_matches_jax(tree, tmp_path):
    """``epochs`` below ``validation_epochs``: no epoch validates, so the
    trained state is validated once and selected, as in JAX."""
    got, want = _fit_pair(tree, tmp_path, epochs=2, validation_epochs=5, monitor_metric="loss")
    assert got["best_val_epoch"] == want["best_val_epoch"] == 2
    assert got["stopped_epoch"] == want["stopped_epoch"] == 2
    np.testing.assert_allclose(got["best_val_metric"], want["best_val_metric"], atol=1e-4)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=1e-4)


def test_mode_test_reproduces_the_stored_metrics(tree, tmp_path):
    _, cfg = _cfgs(tree, epochs=2)
    fold = _port_fold(cfg, tree)
    res = _port_trainer(cfg, str(tmp_path)).fit(fold["train"], fold["validation"], fold["test"],
                                                verbose=False)
    again = _port_trainer(cfg.replace(mode="test"), str(tmp_path)).fit(
        fold["train"], fold["validation"], fold["test"], verbose=False)
    assert again["test_metrics"] == res["test_metrics"]
    assert again["test_scores"] == res["test_scores"]
    assert again["best_val_epoch"] == res["best_val_epoch"]
    assert again["best_val_metric"] == res["best_val_metric"]
    with pytest.raises(FileNotFoundError, match="no trained checkpoint"):
        _port_trainer(cfg.replace(mode="test"), str(tmp_path / "none")).fit(
            fold["train"], fold["validation"], fold["test"], verbose=False)
    with pytest.raises(ValueError, match="needs out_dir"):
        _port_trainer(cfg.replace(mode="test")).fit(fold["train"], fold["validation"],
                                                    fold["test"], verbose=False)


def test_host_and_device_pipelines_fit_alike(tree, tmp_path):
    out = {}
    for pipeline in ("device", "host"):
        _, cfg = _cfgs(tree, epochs=2, pipeline=pipeline)
        fold = _port_fold(cfg, tree)
        tr = _port_trainer(cfg)
        out[pipeline] = (tr.fit(fold["train"], fold["validation"], fold["test"], verbose=False),
                         tr._last_transfer_bytes)
    (dev, dev_bytes), (host, host_bytes) = out["device"], out["host"]
    assert dev["epoch_losses"] == host["epoch_losses"]
    assert dev["test_metrics"] == host["test_metrics"]
    _same_state(dev["state"], host["state"])
    # the device pipeline ships the index plan an epoch, the host pipeline
    # the dense batches
    rows = TREE["n_sites"] * 4 * FIT_BATCH  # 32 train subjects a site: 4 steps of 8
    assert dev_bytes == rows * 4
    assert host_bytes == rows * (8 * 16 * 10 * 4 + 4 + 4)


def test_batch_size_clamp_stays_local_to_the_fold(tree):
    _, cfg = _cfgs(tree, epochs=1, batch_size=64)
    fold = _port_fold(cfg, tree)
    tr = _port_trainer(cfg)
    res = tr.fit(fold["train"], fold["validation"], fold["test"], verbose=False)
    assert np.isfinite(res["epoch_losses"]).all()
    assert tr.cfg.batch_size == cfg.batch_size == 64


def test_split_errors_and_an_empty_validation_split(tree, tmp_path):
    _, cfg = _cfgs(tree, epochs=2)
    fold = _port_fold(cfg, tree)
    empty = [s.take(np.arange(0)) for s in fold["test"]]
    for name, args in (("train", (empty, fold["validation"], fold["test"])),
                       ("test", (fold["train"], fold["validation"], empty))):
        with pytest.raises(ValueError, match=f"the {name} split is empty at every site"):
            _port_trainer(cfg).fit(*args, verbose=False)
    # no validation anywhere (k-fold with k == 2): the last state is kept
    res = _port_trainer(cfg).fit(fold["train"], [s.take(np.arange(0)) for s in fold["test"]],
                                 fold["test"], verbose=False)
    assert res["best_val_epoch"] == 2 and res["best_val_metric"] is None


def _json_keys(path):
    with open(path) as fh:
        return sorted(json.load(fh))


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_fed_runner_writes_jax_outputs_for_every_fold(tree, tmp_path):
    """Both runners on one tree with 3 folds: the same files, the same
    logs.json keys, the same test_metrics.csv header and the same
    checkpoint payload keys; the port through both pipelines."""
    kw = dict(epochs=2, batch_size=FIT_BATCH, num_folds=3)
    jres = jrunner.FedRunner(jconfig.TrainConfig(task_id="ICA-Classification"), tree,
                             str(tmp_path / "jax"), mesh=None, **kw).run(verbose=False)
    for pipeline in ("device", "host"):
        out = tmp_path / pipeline
        runner = trunner.FedRunner(tconfig.TrainConfig(task_id="ICA-Classification"), tree,
                                   str(out), device="cpu", pipeline=pipeline, **kw)
        assert runner.cfg.num_sites == TREE["n_sites"] and runner.cfg.ica_args.hidden_size == 24
        res = runner.run(verbose=False)
        assert len(res) == len(jres) == 3
        assert _outputs(out) == _outputs(tmp_path / "jax")
        for rel in _outputs(out):
            got, want = out / rel, tmp_path / "jax" / rel
            if rel.endswith("logs.json"):
                assert _json_keys(got) == _json_keys(want), rel
                g, w = json.loads(got.read_text()), json.loads(want.read_text())
                for k in ("local_iter_duration", "remote_iter_duration",
                          "cumulative_total_duration", "time_spent_on_computation"):
                    assert len(g.get(k, ())) == len(w.get(k, ())), (rel, k)
                assert (g["best_val_epoch"], g["agg_engine"]) == (w["best_val_epoch"],
                                                                 w["agg_engine"])
            elif rel.endswith(".csv"):
                assert got.read_text().splitlines()[0] == want.read_text().splitlines()[0]
            elif rel.endswith(".msgpack"):
                assert list(tckpt._read_raw(str(got))) == list(jckpt._read_raw(str(want))), rel
            elif rel.endswith(".meta.json"):
                assert _json_keys(got) == _json_keys(want), rel
        for r in res:
            assert np.isfinite(r["epoch_losses"]).all() and len(r["epoch_losses"]) == 2
        with open(out / "local1/simulatorRun/ICA-Classification/fold_2/logs.json") as fh:
            assert json.load(fh)["site_index"] == 1


def test_fed_runner_resolves_auto_mesh_and_refuses_others(tree):
    r = trunner.FedRunner(tconfig.TrainConfig(task_id="ICA-Classification"), tree, device="cpu")
    assert r.mesh is None and r.out_dir == os.path.join(tree, "output")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        trunner.FedRunner(tconfig.TrainConfig(task_id="ICA-Classification"), tree,
                          mesh=object(), device="cpu")


@pytest.mark.parametrize("option,item", [
    ({"mesh": object()}, "A11"), ({"min_slices": 2}, "A11"), ({"wire_quant": "int8"}, "A11"),
])
def test_refused_trainer_options_name_their_item(tree, option, item):
    ctor = {k: v for k, v in option.items() if k in ("mesh", "fault_plan", "attack_plan", "bus")}
    _, cfg = _cfgs(tree, **{k: v for k, v in option.items() if k not in ctor})
    _, model = _models(cfg, cfg)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tloop.FederatedTrainer(cfg, model, device="cpu", **ctor)


def test_trainer_checks_its_config_values(tree):
    for kw, match in (({"telemetry": "maybe"}, "telemetry"), ({"dp_delta": 0.0}, "dp_delta"),
                      ({"pipeline": "scan"}, "pipeline")):
        _, cfg = _cfgs(tree, **kw)
        _, model = _models(cfg, cfg)
        with pytest.raises(ValueError, match=match):
            tloop.FederatedTrainer(cfg, model, device="cpu")


def test_fit_entry_points_need_a_card_or_an_explicit_cpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(tree, epochs=1)
    _, model = _models(cfg, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.FedRunner(tconfig.TrainConfig(task_id="ICA-Classification"), tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.FederatedTrainer(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_eval_fn(tsteps.FederatedTask(model))
    tr = tloop.FederatedTrainer(cfg, model, device="cpu")
    assert tr.device.type == "cpu" and all(p.device.type == "cpu" for p in model.parameters())


def test_epoch_payload_is_jax_plan(tree):
    """The device pipeline's epoch input is JAX's index plan for the same
    epoch, byte for byte, and a prebuilt plan gives the same epoch."""
    cfg_j, cfg_t = _cfgs(tree, epochs=1)
    jmodel, tmodel = _models(cfg_j, cfg_t)
    jf = jrunner.load_site_splits(cfg_j, jrunner.discover_site_dirs(tree))[0]
    tf = _port_fold(cfg_t, tree)
    jtr = jloop.FederatedTrainer(cfg_j, jmodel, None)
    ttr = tloop.FederatedTrainer(cfg_t, tmodel, device="cpu")
    for epoch in (1, 7):
        want = np.asarray(jtr._build_epoch_payload(jf["train"], epoch, FIT_BATCH, 0)[0])
        got = ttr._build_epoch_payload(tf["train"], epoch, FIT_BATCH).positions
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), epoch
    start = ttr.init_state(num_sites=TREE["n_sites"])
    plan = ttr._build_epoch_payload(tf["train"], 3, FIT_BATCH)
    a, la = ttr.run_epoch(start, tf["train"], 3)
    b, lb = ttr.run_epoch(start, tf["train"], 3, plan=plan)
    _same_state(a, b)
    assert la.tobytes() == lb.tobytes()
