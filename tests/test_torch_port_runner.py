"""The port's runner surfaces against the JAX package: largest-site
pretraining (``FederatedTrainer._pretrain``), ``pretrain_args`` from an
inputspec, ``SiteRunner`` and the command line (``runner/cli.py``), on an
ICA demo tree whose sites differ in size, so that the largest is not site 0.

Both sides run on the CPU (JAX with its own runners' meshes, the port with
its kernels' plain versions). Fits start from one JAX-written checkpoint
(``pretrained_path``), powerSGD from JAX's first Q, and the models run with
dropout 0: the two draw dropout masks and first factors from different
generators (ROADMAP queue C).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import powersgd as tpowersgd
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.runner import registry as tregistry
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.weights import train_state_to_jax

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

TASK = "ICA-Classification"
# 3 sites of 24, 40 and 32 subjects (train splits of 19, 32 and 25 rows):
# the largest training site is site 1
SUBJECTS = (24, 40, 32)
TREE = dict(n_sites=3, subjects=40, comps=16, temporal=80, window=10)
BATCH = 8
PRETRAIN = {"epochs": 2, "batch_size": BATCH, "learning_rate": 1e-2}
# A powerSGD fit with pretraining against JAX's: epoch losses, the
# validation loss, the pooled test loss, a site's test loss. Measured
# 1.3e-5, 1.7e-5, 1.5e-4, 2.5e-4: the scores as test_torch_port_fit.py's
# powerSGD FIT_TOL; the losses part more than that file's 6e-8, since the
# pretraining's lr of 1e-2 takes Adam steps of 1e-2 of either sign on the
# coordinates whose gradient is rounding noise (cls_fc1.bias).
FIT_TOL = (dict(atol=5e-5, rtol=0), 5e-4, 5e-4, 1e-3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ica_tree"))
    tdemo.make_ica_demo_tree(root, **TREE)
    for i, n in enumerate(SUBJECTS):
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        x = np.load(os.path.join(d, "timecourses.npz"))["arr_0"][:n]
        np.savez(os.path.join(d, "timecourses.npz"), x)
        with open(os.path.join(d, "labels.csv")) as fh:
            lines = fh.read().splitlines()[:n + 1]
        with open(os.path.join(d, "labels.csv"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return root


@pytest.fixture
def no_dropout(monkeypatch):
    """Both registries build their ICA-LSTM with dropout 0."""
    jspec = jregistry.TASKS[TASK]
    monkeypatch.setitem(jregistry.TASKS, TASK, dataclasses.replace(
        jspec, build_model=lambda cfg: jspec.build_model(cfg).clone(dropout_rate=0.0)))
    tspec = tregistry.TASKS[TASK]

    def build(cfg, generator=None, use_kernel=True):
        model = tspec.build_model(cfg, generator, use_kernel=use_kernel)
        model.dropout_rate = 0.0
        return model

    monkeypatch.setitem(tregistry.TASKS, TASK, dataclasses.replace(tspec, build_model=build))


def _jax_q(seed, index, n, r, device=None):
    """JAX's first powerSGD Q of the leaf at ``index``, as a tensor."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    q = torch.from_numpy(np.array(jax.random.normal(key, (n, r), jnp.float32)))
    return q if device is None else q.to(device)


def _cfgs(tree_root, **kw):
    """The JAX and port configs of one fit; a ``pretrain_args`` dict merges
    into the block as an override does."""
    block = {"pretrain_args": kw.pop("pretrain_args")} if "pretrain_args" in kw else {}
    base = dict(dict(task_id=TASK, batch_size=BATCH, seed=2), **kw)
    jc = jconfig.resolve_site_configs(jconfig.TrainConfig(**base).with_overrides(block),
                                      tree_root)[0]
    tc = tconfig.resolve_site_configs(tconfig.TrainConfig(**base).with_overrides(block),
                                      tree_root)[0]
    return jc.replace(num_sites=3), tc.replace(num_sites=3)


def _pretrained(path, cfg_j):
    """A JAX checkpoint of the tree's model at seed 0: every fit here
    starts from its params."""
    model = jregistry.get_task(TASK).build_model(cfg_j)
    state = jloop.FederatedTrainer(cfg_j, model, None).init_state(
        jnp.ones((2, 8, cfg_j.ica_args.num_components, cfg_j.ica_args.window_size)),
        num_sites=3)
    jckpt.save_checkpoint(path, state)
    return path


@pytest.fixture(scope="module")
def start(tree, tmp_path_factory):
    cfg_j, _ = _cfgs(tree)
    return _pretrained(str(tmp_path_factory.mktemp("start") / "start.msgpack"), cfg_j)


def _compare_fits(got, want):
    loss_tol, val_atol, metric_atol, site_atol = FIT_TOL
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], **loss_tol)
    assert got["best_val_epoch"] == want["best_val_epoch"]
    assert got["stopped_epoch"] == want["stopped_epoch"]
    np.testing.assert_allclose(got["best_val_metric"], want["best_val_metric"], atol=val_atol,
                               rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=metric_atol,
                               rtol=0)
    np.testing.assert_allclose(got["site_test_metrics"], want["site_test_metrics"],
                               atol=site_atol, rtol=0)


def test_pretrained_powersgd_fit_matches_jax(tree, start, monkeypatch, no_dropout):
    """A powerSGD fit with largest-site pretraining, port against JAX, from
    one JAX checkpoint and JAX's first Q. Pretraining runs dSGD on site 1,
    the largest, with the others cut to zero rows, and hands the fit its
    warm params with the fit's own optimizer and engine state."""
    monkeypatch.setattr(tpowersgd, "default_q", _jax_q)
    kw = dict(agg_engine="powerSGD", epochs=3, monitor_metric="loss", pretrain=True,
              pretrain_args=PRETRAIN, pretrained_path=start)
    cfg_j, cfg_t = _cfgs(tree, **kw)
    assert cfg_t.pretrain_args == tconfig.PretrainArgs(**PRETRAIN)
    jf = jrunner.load_site_splits(cfg_j, jrunner.discover_site_dirs(tree))[0]
    tf = trunner.load_site_splits(cfg_t, trunner.discover_site_dirs(tree))[0]
    assert [len(s) for s in tf["train"]] == [19, 32, 25]
    want = jloop.FederatedTrainer(cfg_j, jregistry.get_task(TASK).build_model(cfg_j), None).fit(
        jf["train"], jf["validation"], jf["test"], verbose=False)

    seen = []
    plan_epoch, make_dsgd = tloop.plan_epoch, tloop.make_dsgd
    monkeypatch.setattr(tloop, "plan_epoch", lambda sites, *a, **k: (
        seen.append(("plan", [len(s) for s in sites], k.get("pad_mode"))),
        plan_epoch(sites, *a, **k))[1])
    monkeypatch.setattr(tloop, "make_dsgd", lambda *a, **k: (
        seen.append(("dSGD",)), make_dsgd(*a, **k))[1])
    trainer = tloop.FederatedTrainer(cfg_t, tregistry.build_model(cfg_t, device="cpu"),
                                     device="cpu")
    got = trainer.fit(tf["train"], tf["validation"], tf["test"], verbose=False)
    assert trainer.engine.name == "powerSGD"
    assert seen == [("dSGD",)] + [("plan", [0, 32, 0], "mask")] * PRETRAIN["epochs"]
    _compare_fits(got, want)
    # the pretraining's rounds (4 a epoch on the 32-row site) count on
    state = got["state"]
    assert state.round == int(want["state"].round) == 2 * 4 + 3 * 4
    assert got["site_health"] == want["site_health"]
    assert all(np.isfinite(v).all() for v in train_state_to_jax(state)["batch_stats"]["cls_bn"]
               .values())


def test_pretraining_changes_the_fit_and_is_skipped_on_resume(tree, start, tmp_path, no_dropout,
                                                             monkeypatch):
    """Pretraining warms the params; a resumed fit starts from its
    checkpoint and does not pretrain again, and ends bit for bit where the
    uninterrupted fit ends (powerSGD's q and e ride the checkpoints)."""
    _, cfg = _cfgs(tree, agg_engine="powerSGD", epochs=3, monitor_metric="loss", pretrain=True,
                   pretrain_args=PRETRAIN, pretrained_path=start)
    fold = trunner.load_site_splits(cfg, trunner.discover_site_dirs(tree))[0]
    args = (fold["train"], fold["validation"], fold["test"])

    def fit(c, out=None, resume=False):
        tr = tloop.FederatedTrainer(c, tregistry.build_model(c, device="cpu"), out_dir=out,
                                    device="cpu")
        return tr.fit(*args, verbose=False, resume=resume)

    plain = fit(cfg.replace(pretrain=False))
    whole = fit(cfg, str(tmp_path / "whole"))
    assert whole["epoch_losses"][0] != plain["epoch_losses"][0]
    assert whole["state"].round == plain["state"].round + 2 * 4
    fit(cfg.replace(epochs=2), str(tmp_path / "cut"))
    monkeypatch.setattr(tloop.FederatedTrainer, "_pretrain",
                        lambda *a: pytest.fail("a resumed fit pretrained"))
    resumed = fit(cfg, str(tmp_path / "cut"), resume=True)
    assert resumed["epoch_losses"] == whole["epoch_losses"]
    for k in ("best_val_epoch", "best_val_metric", "test_metrics", "site_test_metrics"):
        assert resumed[k] == whole[k], k
    a, b = train_state_to_jax(resumed["state"]), train_state_to_jax(whole["state"])
    for key in ("q", "e"):
        for n, v in jax.tree_util.tree_leaves_with_path(b["engine_state"][key]):
            w = a["engine_state"][key]
            for k in n:
                w = w[k.key]
            assert v.tobytes() == w.tobytes(), (key, n)


def test_pretrain_args_resolve_from_an_inputspec(tmp_path):
    spec = [{"pretrain": {"value": True}, "pretrain_args": {"value": {"epochs": 3,
                                                                      "learning_rate": 0.01}},
             "epochs": {"value": 7}, "batch_size": {"value": 4}},
            {"pretrain": {"value": True}, "epochs": {"value": 5}}]
    with open(tmp_path / "inputspec.json", "w") as fh:
        json.dump(spec, fh)
    base = dict(task_id=TASK)
    want = jconfig.resolve_site_configs(jconfig.TrainConfig(**base), str(tmp_path))
    got = tconfig.resolve_site_configs(tconfig.TrainConfig(**base), str(tmp_path))
    assert [dataclasses.asdict(c.pretrain_args) if c.pretrain_args else None for c in got] == \
        [dataclasses.asdict(c.pretrain_args) if c.pretrain_args else None for c in want]
    assert got[0].pretrain_args == tconfig.PretrainArgs(epochs=3, learning_rate=0.01)
    # flat keys never reach the block: epochs 7 and batch_size 4 are the fit's
    assert (got[0].epochs, got[0].batch_size, got[0].pretrain_args.batch_size) == (7, 4, 16)
    assert got[1].pretrain and got[1].pretrain_args is None
    merged = tconfig.TrainConfig(pretrain_args=tconfig.PretrainArgs(epochs=1)).with_overrides(
        {"pretrain_args": {"batch_size": 8}})
    assert merged.pretrain_args == tconfig.PretrainArgs(epochs=1, batch_size=8)


def test_site_runner_matches_jax(tree, start, tmp_path, no_dropout):
    """``SiteRunner`` of site 1 (the reference's ``taks_id="ICA"``) against
    JAX's, every fold of the site's own split."""
    kw = dict(data_path=tree, site_index=1, batch_size=BATCH, seed=2, epochs=2,
              monitor_metric="loss", pretrained_path=start)
    want = jrunner.SiteRunner(taks_id="ICA", out_dir=str(tmp_path / "jax"), **kw).run(
        verbose=False)
    runner = trunner.SiteRunner(taks_id="ICA", out_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert runner.cfg.task_id == TASK
    got = runner.run(verbose=False)
    assert len(got) == len(want) == 1
    # one site's dSGD fit: the epoch losses as test_torch_port_fit.py's,
    # the site's 4 test rows as a site's test loss there (measured 1.3e-4)
    np.testing.assert_allclose(got[0]["epoch_losses"], want[0]["epoch_losses"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0]["test_metrics"], want[0]["test_metrics"], atol=5e-4, rtol=0)
    assert got[0]["best_val_epoch"] == want[0]["best_val_epoch"]
    assert os.path.isfile(tmp_path / "port" / "remote" / "simulatorRun" / TASK / "fold_0" /
                          "checkpoint_best.msgpack")
    # site_index is clamped to the sites present
    one = dict(kw, epochs=1)
    last = [trunner.SiteRunner(task_id=TASK, device="cpu", **dict(one, site_index=i)).run(
        verbose=False)[0] for i in (2, 9)]
    assert last[0]["epoch_losses"] == last[1]["epoch_losses"]
    assert last[0]["test_metrics"] == last[1]["test_metrics"]


def _cli_lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("mode", ["federated", "site"])
def test_cli_json_lines_match_jax(tree, start, tmp_path, capsys, monkeypatch, no_dropout, mode):
    """The port's CLI (``--device cpu``) against JAX's on one tree and one
    start: a powerSGD fit with pretraining for fold 0, or one site alone.
    The JSON lines carry the same keys and agree within the fit's
    tolerances; the exit code is JAX's."""
    monkeypatch.setattr(tpowersgd, "default_q", _jax_q)
    args = ["--data-path", tree, "--task", TASK, "--batch-size", str(BATCH), "--quiet",
            "--set", "seed=2", "--set", f"pretrained_path={start}"]
    if mode == "federated":
        args += ["--engine", "powerSGD", "--epochs", "3", "--folds", "0", "--set",
                 "pretrain=true", "--set", json.dumps(PRETRAIN).join(["pretrain_args=", ""])]
    else:
        args += ["--site", "2", "--epochs", "2"]
    assert jcli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    want = _cli_lines(capsys)
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = _cli_lines(capsys)
    assert len(got) == len(want) == 1
    assert list(got[0]) == list(want[0]) == ["fold", "test_loss", "test_auc", "best_val_epoch"]
    assert got[0]["fold"] == want[0]["fold"] == 0
    assert got[0]["best_val_epoch"] == want[0]["best_val_epoch"]
    for k in ("test_loss", "test_auc"):
        np.testing.assert_allclose(got[0][k], want[0][k], atol=FIT_TOL[2], rtol=0, err_msg=k)
    assert os.path.isfile(tmp_path / "port" / "remote" / "simulatorRun" / TASK / "fold_0" /
                          "checkpoint_best.msgpack")


def test_the_port_parses_every_jax_flag():
    """The port's parser takes every option of JAX's, and adds only
    ``--device``; every option is either run or refused naming its item."""
    def options(parser):
        return {o: a.dest for a in parser._actions for o in a.option_strings}

    want, got = options(jcli.build_parser()), options(tcli.build_parser())
    assert set(got) - set(want) == {"--device"}
    assert set(want) <= set(got)
    run = {"help", "data_path", "task", "engine", "mode", "epochs", "batch_size", "num_folds",
           "out_dir", "site", "folds", "resume", "pipeline", "fused_poweriter", "quiet",
           "overrides", "faults", "attacks", "robust_agg", "serve", "serve_spool",
           "serve_capacity", "serve_quorum", "serve_epochs", "serve_poll", "serve_rows",
           "overlap_rounds", "dp_clip", "dp_noise", "dp_epsilon_budget", "secure_agg",
           "personalize", "telemetry", "profile_dir", "xprof_dir", "compile_cache", "sanitize",
           "statusz_port", "slo_p99_ms", "schedule", "pod_slices", "sched_wall_s", "sched_ticks"}
    assert {d for d in want.values()} - run == set(tcli._REFUSED)


SET_PAIRS = ["epochs=3", "split_ratio=[0.7,0.15,0.15]", "task_id=ICA-Classification",
             "pretrain=true", 'pretrain_args={"epochs": 1}', "expr=a=b", "empty=", "x=null"]


def test_parse_set_matches_jax():
    assert tcli._parse_set(SET_PAIRS) == jcli._parse_set(SET_PAIRS)
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit, match="--set expects key=value"):
            mod._parse_set(["epochs"])


@pytest.mark.parametrize("flag", sorted(tcli._REFUSED))
def test_each_refused_flag_names_its_item(tree, flag):
    """Every flag of the JAX CLI that asks for what the port does not run
    exits naming its ROADMAP item, before anything is built; the JAX
    parser takes the same flag."""
    off, item = tcli._REFUSED[flag]
    opt = "--" + flag.replace("_", "-")
    action = next(a for a in tcli.build_parser()._actions if a.dest == flag)
    if action.nargs == 0:
        extra = [opt]
    elif action.choices:
        extra = [opt, next(c for c in action.choices if c != off)]
    elif action.type in (int, float):
        extra = [opt, "2"]
    else:
        extra = [opt, "x"]
    base = ["--data-path", tree, "--device", "cpu"]
    jcli.build_parser().parse_args(base[:2] + extra)
    with pytest.raises(SystemExit, match=rf"{opt}.*ROADMAP {item.split()[0]}"):
        tcli.main(base + extra)
    if off is not None and off is not False:
        assert tcli.build_parser().parse_args(base + [opt, str(off)]) is not None
        tcli._refuse(tcli.build_parser().parse_args(base + [opt, str(off)]))


def test_fused_poweriter_off_is_refused_with_its_reason(tree):
    base = ["--data-path", tree, "--device", "cpu"]
    with pytest.raises(SystemExit, match="XLA power-iteration loop, which has no counterpart"):
        tcli.main(base + ["--fused-poweriter", "off"])
    for value in ("auto", "on"):
        tcli._refuse(tcli.build_parser().parse_args(base + ["--fused-poweriter", value]))


def test_cli_and_site_runner_need_a_card_or_an_explicit_cpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data-path", tree, "--task", TASK, "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data-path", tree, "--task", TASK, "--epochs", "1", "--site", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.SiteRunner(task_id=TASK, data_path=tree)
    with pytest.raises(SystemExit, match="--folds/--resume"):
        tcli.main(["--data-path", tree, "--site", "0", "--resume", "--device", "cpu"])
