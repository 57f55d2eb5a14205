"""The port's faulty-site slice against the JAX package: ``FaultPlan`` (JSON
both ways, validation, the liveness, NaN and slice masks bit for bit across
window chunkings), ``poison_inputs``, the trainer's windowing on the global
round counter for both pipelines under a fault plan and an attack plan, a robust fit's outputs (``logs.json``'s anomaly keys) and its
checkpoint both ways with JAX's ``load_checkpoint``, the health restore key
by key, and the command line's ``--faults`` / ``--attacks`` /
``--robust-agg``. ``kill_at_round`` is tests/test_torch_port_preemption.py's.

The JAX side runs its Pallas LSTM kernels in interpret mode. Inputs are made
with numpy from a seed. Each tolerance is stated beside its test.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.robustness import attacks as jattacks
from dinunet_implementations_tpu.robustness import faults as jfaults
from dinunet_implementations_tpu.robustness import health as jhealth
from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import logs as jlogs
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import make_dsgd
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.robustness import attacks as tattacks
from dinunet_implementations_tpu_torch.robustness import faults as tfaults
from dinunet_implementations_tpu_torch.robustness import health as thealth
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.runner import build_model
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import logs as tlogs
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_to_jax

# the small ICA-LSTM of tests/test_torch_port_train.py
C, W, IN, HID = 4, 5, 16, 12
LR = 1e-3
# scheduled drops, a straggler, flaky sites and NaN rounds
PLANS = [
    jfaults.FaultPlan(drop=((0, 1, 1), (2, 3, -1)), nan_at=((0, 2), (5, 4))),
    jfaults.FaultPlan(delay_at=((1, 2, 3), (3, 0, 1)), flaky_prob=0.3, flaky_seed=11),
    jfaults.FaultPlan(drop=((4, 0, 2),), flaky_prob=0.05, flaky_seed=3, nan_at=((1, 1),),
                      delay_at=((0, 5, 2),), slice_drop_at=((1, 2, 4),),
                      slice_delay_at=((0, 1, 2),), kill_slice_at=((2, 6),)),
]
DET_PLAN = jattacks.AttackPlan(sign_flip=((1, 0, -1),), scale=((2, 1, 2),), scale_factor=10.0,
                               free_rider=((4, 0, 1),))


def _tplan(plan, cls):
    return cls.from_json(plan.to_json())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# -- FaultPlan -----------------------------------------------------------------


def test_fault_plan_json_both_ways_and_validation(tmp_path):
    for plan in PLANS + [jfaults.FaultPlan(kill_at_round=4)]:
        port = _tplan(plan, tfaults.FaultPlan)
        assert port.to_json() == plan.to_json()
        assert jfaults.FaultPlan.from_json(port.to_json()) == plan
        assert port.injects_faults() == plan.injects_faults()
        for inc in (True, False):
            assert port.injects_slice_faults(inc) == plan.injects_slice_faults(inc)
    port = _tplan(PLANS[2], tfaults.FaultPlan)
    assert port.kill_round_for_slice(2) == 6 and port.kill_round_for_slice(0) is None
    p = tmp_path / "faults.json"
    p.write_text(json.dumps(PLANS[0].to_json()))
    for arg in (f"@{p}", str(p), json.dumps(PLANS[0].to_json())):
        assert tfaults.parse_fault_plan(arg) == _tplan(PLANS[0], tfaults.FaultPlan)
    assert tfaults.parse_fault_plan(None) is None
    for bad, match in (({"drop": ((1, 2),)}, "need 3 integers"),
                       ({"drop": ((0, 5, 2),)}, "bad FaultPlan.drop"),
                       ({"nan_at": ((-1, 0),)}, "bad FaultPlan.nan_at"),
                       ({"delay_at": ((0, 1, 0),)}, "bad FaultPlan.delay_at"),
                       ({"flaky_prob": 1.5}, "flaky_prob"),
                       ({"slice_drop_at": ((0, 3, 1),)}, "slice_drop_at"),
                       ({"slice_delay_at": ((0, 1, 0),)}, "slice_delay_at"),
                       ({"kill_slice_at": ((-1, 0),)}, "kill_slice_at")):
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError, match=match):
                mod.FaultPlan(**bad)
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError, match="unknown FaultPlan keys"):
            mod.FaultPlan.from_json({"drops": []})


@pytest.mark.parametrize("plan", range(len(PLANS)))
@pytest.mark.parametrize("chunk", [1, 3, 10])
def test_fault_masks_equal_jax_across_window_chunkings(plan, chunk):
    """The liveness (drops, stragglers, the splitmix64 flaky draw), NaN and
    slice masks of 10 rounds, bit for bit JAX's, for any window split."""
    want_plan = PLANS[plan]
    port = _tplan(want_plan, tfaults.FaultPlan)
    rounds, sites = 10, 6
    windows = [(r0, min(chunk, rounds - r0)) for r0 in range(0, rounds, chunk)]
    for name, args in (("liveness", (sites,)), ("nan_mask", (sites,)),
                       ("slice_liveness", (3,))):
        want = getattr(want_plan, name)(*args, 0, rounds)
        got = np.concatenate([getattr(port, name)(*args, r0, n) for r0, n in windows], axis=1)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    np.testing.assert_array_equal(port.slice_liveness(3, 2, 5, include_kills=False),
                                  want_plan.slice_liveness(3, 2, 5, include_kills=False))
    got, want = tfaults.fault_window(port, sites, 4, 5), jfaults.fault_window(want_plan, sites, 4, 5)
    for g, w in zip(got, want):
        assert (g is None) == (w is None) and (g is None or g.tobytes() == w.tobytes())
    for n_sl in (1, 3):
        g = tfaults.slice_fault_window(port, n_sl, 0, 4)
        w = jfaults.slice_fault_window(want_plan, n_sl, 0, 4)
        assert (g is None) == (w is None) and (g is None or g.tobytes() == w.tobytes())
    assert tfaults.fault_window(None, sites, 0, 4) == (None, None)


def test_poison_inputs_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    nan = jfaults.FaultPlan(nan_at=((1, 0), (3, 2), (0, 1))).nan_mask(3, 0, 4)
    for L in (1, 2):
        got, want = tfaults.poison_inputs(x, nan, L), jfaults.poison_inputs(x, nan, L)
        assert got.tobytes() == want.tobytes() and np.isnan(got).any()
    assert tfaults.poison_inputs(x, np.zeros((3, 4), bool), 2) is x


# -- the trainer, the fit, checkpoints -----------------------------------------

# the demo tree of tests/test_torch_port_fit.py: 3 sites of 40 subjects
TREE = dict(n_sites=3, subjects=40, comps=16, temporal=80, window=10)
FIT_BATCH = 8
FIT_FAULTS = tfaults.FaultPlan(drop=((2, 1, 2),), nan_at=((0, 0),), flaky_prob=0.1, flaky_seed=5)
FIT_ATTACKS = tattacks.AttackPlan(sign_flip=((1, 0, 3),), noise=((0, 2, 4),), noise_std=0.01)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdemo.make_ica_demo_tree(str(tmp_path_factory.mktemp("ica_tree")), **TREE)


def _fit_cfg(tree_root, **kw):
    base = dict(dict(task_id="ICA-Classification", batch_size=FIT_BATCH, seed=2), **kw)
    cfg = tconfig.resolve_site_configs(tconfig.TrainConfig(**base), tree_root)[0]
    return cfg.replace(num_sites=TREE["n_sites"])


def _same(got, want, path=""):
    """Two trees of tensors (or numpy arrays) equal bit for bit, dtypes
    included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), path


def test_trainer_windows_plans_on_the_round_counter_for_both_pipelines(tree):
    """Two epochs of a ``trimmed_mean`` trainer with both plans: the host
    pipeline (NaN-poisoned inputs) equals the device pipeline (the NaN
    gate) bit for bit, and the second epoch takes the window after the
    first (a skip counted by the round-1 drop of site 2)."""
    cfg = _fit_cfg(tree, robust_agg="trimmed_mean")
    fold = trunner.load_site_splits(cfg, trunner.discover_site_dirs(tree))[0]
    runs = {}
    for pipeline in ("device", "host"):
        tr = tloop.FederatedTrainer(cfg.replace(pipeline=pipeline), build_model(cfg, device="cpu"),
                                    device="cpu", fault_plan=FIT_FAULTS, attack_plan=FIT_ATTACKS)
        st = tr.init_state(num_sites=TREE["n_sites"])
        assert set(st.health) == {"streak", "skips", "quarantined", "suspect_streak", "anomaly"}
        losses = []
        for epoch in (1, 2):
            st, lo = tr.run_epoch(st, fold["train"], epoch)
            losses.append(lo)
        runs[pipeline] = (st, np.concatenate(losses))
    (d, dl), (h, hl) = runs["device"], runs["host"]
    assert dl.tobytes() == hl.tobytes()
    _same(train_state_to_jax(h), train_state_to_jax(d))
    rounds = len(dl)
    live = FIT_FAULTS.liveness(3, 0, rounds)
    assert d.round == rounds and int(d.health["skips"][2]) >= int((live[2] == 0).sum())
    assert int(d.health["skips"][0]) >= 1  # the NaN round


def test_a_robust_fit_writes_anomaly_scores_and_its_checkpoint_loads_both_ways(tree, tmp_path):
    """A ``FedRunner`` dSGD ``trimmed_mean`` fit with both plans: ``logs.json`` carries JAX's anomaly keys (the remote's lists,
    each site's scalars), the best checkpoint loads back bit for bit in the
    port (the reputation fields in their dtypes) and in JAX's
    ``load_checkpoint`` against a JAX template with the reputation layer,
    and a checkpoint JAX writes of that state loads back in the port."""
    out = tmp_path / "out"
    runner = trunner.FedRunner(tconfig.TrainConfig(task_id="ICA-Classification",
                                                   robust_agg="trimmed_mean"), tree, str(out),
                               device="cpu", fault_plan=FIT_FAULTS, attack_plan=FIT_ATTACKS,
                               epochs=2, batch_size=FIT_BATCH)
    res = runner.run(folds=[0], verbose=False)[0]
    fold = out / "remote" / "simulatorRun" / "ICA-Classification" / "fold_0"
    remote = json.loads((fold / "logs.json").read_text())
    summary = thealth.health_summary(res["state"].health)
    assert remote["site_anomaly_score"] == [round(v, 6) for v in summary["site_anomaly_score"]]
    assert remote["site_suspect_streak"] == summary["site_suspect_streak"]
    local = json.loads((out / "local1" / "simulatorRun" / "ICA-Classification" / "fold_0" /
                        "logs.json").read_text())
    assert {"anomaly_score", "suspect_streak", "skipped_rounds", "quarantined"} <= set(local)
    best = str(fold / "checkpoint_best.msgpack")
    trainer = tloop.FederatedTrainer(runner.cfg, build_model(runner.cfg, device="cpu"), device="cpu")
    back = tckpt.load_checkpoint(best, trainer.init_state(num_sites=TREE["n_sites"]))
    assert back.health["anomaly"].dtype == torch.float32 and back.health["anomaly"].any()
    _same(train_state_to_jax(back), train_state_to_jax(res["state"]))
    # JAX's load_checkpoint of the port's file, against a template of the
    # same model with the reputation layer
    jcfg = runner.cfg
    a = jcfg.ica_args
    jtask = jsteps.FederatedTask(jm.ICALstm(input_size=a.input_size, hidden_size=a.hidden_size,
                                            num_cls=2, num_comps=a.num_components,
                                            window_size=a.window_size, dropout_rate=0.0))
    jeng = make_engine("dSGD", precision_bits="32", robust_agg="trimmed_mean")
    like = jsteps.init_train_state(jtask, jeng, jsteps.make_optimizer("adam", jcfg.learning_rate),
                                   jax.random.PRNGKey(0),
                                   jnp.zeros((2, a.temporal_size // a.window_size,
                                              a.num_components, a.window_size)),
                                   num_sites=TREE["n_sites"], reputation=True)
    got = jax.tree.map(np.asarray, jckpt.load_checkpoint(best, like))
    want = train_state_to_jax(res["state"])
    _same(got.health, want["health"])
    _same(got.params, want["params"])
    # and back: JAX writes the state it restored, the port reads it
    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(jpath, jckpt.load_checkpoint(best, like))
    again = tckpt.load_checkpoint(jpath, trainer.init_state(num_sites=TREE["n_sites"]))
    _same(train_state_to_jax(again)["health"], want["health"])
    _same(train_state_to_jax(again)["params"], want["params"])


def test_health_restores_key_by_key(tmp_path):
    """A robust resume from a plain checkpoint keeps the three counters and
    starts the reputation fields fresh; a plain resume from a robust one
    drops them; a site-count change gives fresh counters with a warning.
    Each field comes back in its own dtype."""
    task = tsteps.FederatedTask(tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))
    opt = tsteps.make_optimizer("adam", LR)
    plain = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=3)
    plain.health = {k: torch.tensor([1, 2, 3], dtype=torch.int32) for k in plain.health}
    robust = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=3, reputation=True)
    robust.health = dict(robust.health, anomaly=torch.tensor([0.25, 1.5, 0.0]),
                         suspect_streak=torch.tensor([0, 4, 1], dtype=torch.int32))
    p_path, r_path = str(tmp_path / "plain.msgpack"), str(tmp_path / "robust.msgpack")
    tckpt.save_checkpoint(p_path, plain)
    tckpt.save_checkpoint(r_path, robust)
    fresh_robust = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=3, reputation=True)
    got = tckpt.load_checkpoint(p_path, fresh_robust).health
    assert [got[k].tolist() for k in ("streak", "skips", "quarantined")] == [[1, 2, 3]] * 3
    assert not got["anomaly"].any() and got["anomaly"].dtype == torch.float32
    got = tckpt.load_checkpoint(r_path, fresh_robust).health
    assert got["anomaly"].tolist() == [0.25, 1.5, 0.0] and got["suspect_streak"].tolist() == [0, 4, 1]
    got = tckpt.load_checkpoint(r_path, tsteps.init_train_state(task, make_dsgd(), opt,
                                                                num_sites=3)).health
    assert set(got) == {"streak", "skips", "quarantined"}
    four = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=4, reputation=True)
    with pytest.warns(UserWarning, match="site-health"):
        got = tckpt.load_checkpoint(r_path, four).health
    assert not any(v.any() for v in got.values())
    # the epoch's own normalization, in both directions
    h = tsteps._ensure_health(plain.health, 3, True, "cpu")
    assert set(h) == set(thealth.HEALTH_DTYPES) and h["skips"].tolist() == [1, 2, 3]
    assert set(tsteps._ensure_health(robust.health, 3, False, "cpu")) == {
        "streak", "skips", "quarantined"}


def test_health_log_fields_match_jax():
    h = {"streak": np.array([0, 3], np.int32), "skips": np.array([1, 4], np.int32),
         "quarantined": np.array([0, 1], np.int32),
         "suspect_streak": np.array([0, 2], np.int32),
         "anomaly": np.array([0.1234567891, 2.5], np.float32)}
    for keys in (list(h), ["streak", "skips", "quarantined"]):
        sub = {k: h[k] for k in keys}
        got = thealth.health_summary({k: torch.from_numpy(v) for k, v in sub.items()})
        want = jhealth.health_summary(sub)
        assert got == want
        for i in (None, 0, 1):
            assert tlogs.health_log_fields(got, i) == jlogs.health_log_fields(want, i)


# -- refusals and the command line ---------------------------------------------


def test_cli_takes_faults_attacks_and_robust_agg(tree, tmp_path, monkeypatch):
    """``--faults @file --attacks JSON --robust-agg``: the plans reach
    ``FedRunner`` equal to JAX's parse of the same flags, the mode its
    config; a plan that does not parse and a plan with ``--site`` exit
    naming the flag, as JAX's CLI does."""
    seen = {}

    class Runner:
        def __init__(self, cfg, data_path, out_dir=None, fault_plan=None, attack_plan=None,
                     device=None):
            seen.update(cfg=cfg, fault_plan=fault_plan, attack_plan=attack_plan, device=device)

        def run(self, folds=None, verbose=True, resume=False):
            return [{"test_metrics": [[0.5, 0.5]], "best_val_epoch": 1}]

    monkeypatch.setattr(trunner, "FedRunner", Runner)
    f = tmp_path / "faults.json"
    f.write_text(json.dumps(PLANS[1].to_json()))
    attacks = json.dumps(DET_PLAN.to_json())
    argv = ["--data-path", tree, "--device", "cpu", "--faults", f"@{f}", "--attacks", attacks,
            "--robust-agg", "coordinate_median"]
    assert tcli.main(argv) == 0
    jargs = jcli.build_parser().parse_args(argv[:2] + argv[4:])
    assert seen["fault_plan"].to_json() == jfaults.parse_fault_plan(jargs.faults).to_json()
    assert seen["attack_plan"].to_json() == jattacks.parse_attack_plan(jargs.attacks).to_json()
    assert seen["cfg"].robust_agg == jargs.robust_agg == "coordinate_median"
    assert seen["device"] == "cpu"
    for argv, match in ((["--faults", "{nope"], "--faults: "),
                        (["--attacks", '{"sign_flip": [[0, 3, 1]]}'], "--attacks: bad"),
                        (["--faults", f"@{tmp_path / 'missing.json'}"], "--faults: "),
                        (["--site", "0", "--attacks", attacks], "--attacks targets federated"),
                        (["--site", "0", "--faults", f"@{f}"], "--faults targets federated")):
        with pytest.raises(SystemExit, match=match):
            tcli.main(["--data-path", tree, "--device", "cpu"] + argv)
    assert os.path.isfile(f)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tcli._plans(tcli.build_parser().parse_args(["--data-path", tree])) == [None, None]
