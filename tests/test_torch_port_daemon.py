"""The port's elastic daemon against the JAX package's: ``FedDaemon`` on the
FS demo tree and config of tests/test_membership.py (FS, MSANNet 8→8,
capacity 4, ``inventory_rows=32``, buffered-async with bound 2) over the
same spool of leaves and a rejoin, from one initial state; a churned
service resumed from its checkpoint bit for bit; the quorum hold; a
rejected admission; ``publish.json`` read by the serving plane's
``CheckpointWatcher``; the slot-state helpers (``reset_slot_state``,
``move_slot_state``, ``membership_rollup``) against JAX's; and the command
line's ``--serve`` and ``--overlap-rounds``.

The JAX daemon runs with ``mesh=None`` (every slot folded onto one device,
as the port's). Tolerances: the FS epoch tests' (tests/
test_torch_port_fs_fit.py ``LOSS_TOL["dSGD"]`` and ``PARAM_ATOL``); the
membership table, the buffers' ages and weights and the hold counts are
held equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_port_fs_fit import LOSS_TOL as FS_LOSS_TOL
from test_torch_port_fs_fit import PARAM_ATOL as FS_PARAM_ATOL

from dinunet_implementations_tpu import TrainConfig as JTrainConfig
from dinunet_implementations_tpu.core.config import FSArgs as JFSArgs
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.robustness import membership as jmem
from dinunet_implementations_tpu.runner.fed_runner import FedDaemon as JFedDaemon
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import FSArgs, TrainConfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.engines import make_rankdad
from dinunet_implementations_tpu_torch.engines.base import ASYNC_NEVER_AGE
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.robustness import membership as tmem
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.serving.publish import CheckpointWatcher
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax

TASK = "FS-Classification"


@pytest.fixture(scope="module")
def demo_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_tree"))
    tdemo.make_fs_demo_tree(root, n_sites=3, subjects=20, n_features=8, seed=4)
    return root


def _cfg(mod_cfg, mod_fs, **kw):
    return mod_cfg(task_id=TASK, batch_size=4, staleness_bound=2,
                   fs_args=mod_fs(input_size=8, hidden_sizes=(8,)), **kw)


def _daemon(demo_tree, out, resume=False, capacity=4, **kw):
    return trunner.FedDaemon(_cfg(TrainConfig, FSArgs), capacity=capacity,
                             spool_dir=os.path.join(out, "spool"), out_dir=out,
                             data_path=demo_tree, quorum=1, poll_s=0.01, inventory_rows=32,
                             resume=resume, verbose=False, device="cpu", **kw)


def _spool(daemon, *events):
    for i, ev in enumerate(events):
        path = os.path.join(daemon.spool_dir, f"ev{i:03d}.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(ev, fh)
        os.replace(path + ".tmp", path)


def _site2_join(demo_tree, **extra):
    return {"event": "join", "site": "local1",
            "data_dir": os.path.join(demo_tree, "input", "local1", "simulatorRun"),
            "config": {"labels_file": "site2_Covariate.csv"}, **extra}


def _churn(demo_tree):
    return [{"event": "leave", "site": "local1", "after_epoch": 1},
            {"event": "leave", "site": "local2", "after_epoch": 2},
            _site2_join(demo_tree, after_epoch=3)]


def _recording(daemon):
    """Record each trained epoch's loss (None for a hold)."""
    losses, train = [], daemon.train_epoch

    def recorded():
        loss = train()
        losses.append(loss)
        return loss

    daemon.train_epoch = recorded
    return losses


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def both(demo_tree, tmp_path_factory):
    """JAX's daemon and the port's over the same churn, 4 served epochs,
    the port's started from JAX's initial state."""
    jout = str(tmp_path_factory.mktemp("jax_daemon"))
    jd = JFedDaemon(_cfg(JTrainConfig, JFSArgs), capacity=4,
                    spool_dir=os.path.join(jout, "spool"), out_dir=jout, data_path=demo_tree,
                    quorum=1, poll_s=0.01, inventory_rows=32, verbose=False, mesh=None)
    td = _daemon(demo_tree, str(tmp_path_factory.mktemp("port_daemon")))
    td.state = train_state_from_jax(jax.tree.map(np.asarray, jd.state), rng=td.cfg.seed,
                                    device="cpu")
    runs = []
    for d in (jd, td):
        _spool(d, *_churn(demo_tree))
        losses = _recording(d)
        runs.append((d, losses, d.serve(max_epochs=4)))
    return runs


def test_the_daemon_matches_jax_over_the_same_spool(both):
    """Epochs, holds, the membership table (slots, generations, epoch),
    the rollup (mean staleness), the buffers' ages and weights equal;
    each epoch's loss at the FS epoch tests' dSGD tolerance and the params
    at their ``PARAM_ATOL``; the summary has JAX's keys."""
    (jd, jl, js), (td, tl, ts) = both
    assert td.epochs_run == jd.epochs_run == 4 and td.held_rounds == jd.held_rounds
    assert ts["table"] == js["table"] and ts["membership"] == js["membership"]
    assert set(js) <= set(ts) and ts["compiles_after_first_epoch"] == {
        "kernel_builds": 0, "kernel_loads": 0}
    assert td.table.generation_of("local1") == jd.table.generation_of("local1") == 2
    np.testing.assert_allclose(tl, jl, **FS_LOSS_TOL["dSGD"])
    got, want = train_state_to_jax(td.state), jax.tree.map(np.asarray, jd.state)
    assert got["buffers"]["age"].tolist() == want.buffers["age"].tolist()
    assert got["buffers"]["weight"].tobytes() == want.buffers["weight"].tobytes()
    gp, wp = _flat(got["params"]), _flat(want.params)
    assert gp.keys() == wp.keys()
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=FS_PARAM_ATOL, rtol=0, err_msg=k)
    assert set(jd.status()) <= set(td.status())


def test_a_churned_daemon_resumes_bit_exact(demo_tree, tmp_path):
    """A service stopped after epoch 2's churn and resumed on its out_dir,
    the rest of the churn replayed from the spool, ends with the params and
    buffers of the uninterrupted service, bit for bit."""
    churn = _churn(demo_tree)
    a = _daemon(demo_tree, str(tmp_path / "a"))
    _spool(a, *churn)
    a.serve(max_epochs=4)
    b1 = _daemon(demo_tree, str(tmp_path / "b"))
    _spool(b1, *churn[:2])
    b1.serve(max_epochs=2)
    assert b1.table.slot_of("local1") is None
    b2 = _daemon(demo_tree, str(tmp_path / "b"), resume=True)
    # local2's leave (after epoch 2) is still queued in the spool
    assert b2.epochs_run == 2 and b2.table.occupied == 2
    _spool(b2, churn[2])
    b2.serve(max_epochs=2)
    assert a.epochs_run == b2.epochs_run == 4
    assert a.table.generation_of("local1") == b2.table.generation_of("local1") == 2
    ga, gb = train_state_to_jax(a.state), train_state_to_jax(b2.state)
    for key in ("params", "buffers", "opt_state"):
        fa, fb = _flat(ga[key]), _flat(gb[key])
        assert fa.keys() == fb.keys() and all(fa[k].tobytes() == fb[k].tobytes() for k in fa), key


def test_the_quorum_holds_rounds_and_holds_count_episodes(demo_tree, tmp_path):
    """Below the quorum an epoch holds and counts one epoch's rounds (the
    unpinned plan: 1); at the quorum it trains and the count stays; an
    idle service polling fast counts one hold, as JAX's tests hold it."""
    d = _daemon(demo_tree, str(tmp_path / "q"))
    d.quorum = 4
    assert d.train_epoch() is None and d.held_rounds == 1
    d.quorum = 2
    assert d.train_epoch() is not None and d.held_rounds == 1
    assert tmem.membership_rollup(d.table, d.state, held_rounds=d.held_rounds)[
        "held_rounds"] == 1
    idle = _daemon(demo_tree, str(tmp_path / "idle"))
    idle.quorum = 4
    idle.serve(max_wall_s=0.3)
    assert idle.held_rounds == 1 and idle.epochs_run == 0


def test_a_bad_admission_is_rejected_and_bad_spool_files_set_aside(demo_tree, tmp_path):
    d = _daemon(demo_tree, str(tmp_path / "adm"))
    d.admission_deadline_s = 0.3
    before = d.table.occupied
    assert d.apply_event({"event": "join", "site": "ghost", "data_dir": "/nonexistent/xyz"}) \
        is False
    assert d.table.occupied == before and d.table.slot_of("ghost") is None
    for name, body in (("bad.json", "{not json"),
                       ("late.json", json.dumps({"event": "leave", "site": "local0",
                                                 "after_epoch": "soon"}))):
        with open(os.path.join(d.spool_dir, name), "w") as fh:
            fh.write(body)
    assert d.ingest() is False
    for name in ("bad.json", "late.json"):
        assert os.path.exists(os.path.join(d.spool_dir, name + ".rejected"))
    assert d.table.slot_of("local0") is not None


def test_every_publish_is_seen_with_the_checkpoints_digest(demo_tree, tmp_path):
    """Each rotation's ``publish.json`` is a new announcement to the port's
    ``CheckpointWatcher``, its digest the ``params_digest`` of the
    checkpoint loaded back, in the port and in JAX."""
    from dinunet_implementations_tpu.trainer.checkpoint import params_digest as jdigest

    d = _daemon(demo_tree, str(tmp_path / "pub"))
    watcher = CheckpointWatcher(os.path.join(os.path.dirname(d.ckpt_path), "publish.json"))
    first = watcher.poll()
    assert first is not None and first["epoch"] == 0
    for epoch in (1, 2):
        assert d.train_epoch() is not None
        d.checkpoint()
        ann = watcher.poll()
        assert ann is not None and ann["epoch"] == epoch and ann["path"] == d.ckpt_path
        back = tckpt.load_checkpoint(ann["path"], d.state)
        assert ann["digest"] == tckpt.params_digest(back.params, back.batch_stats)
        raw = jckpt._read_raw(ann["path"])
        assert ann["digest"] == jdigest(raw["params"], raw["batch_stats"])
    d.checkpoint()  # the same weights again: no new candidate
    assert watcher.poll() is None


def test_slot_state_helpers_match_jax():
    """After a warm async rankDAD epoch of JAX's corner (MSANNet 6→8→2, 4
    sites): ``reset_slot_state`` clears the slot's health and buffer rows
    as JAX's does (bit for bit) and sets its engine rows to the engine's
    fresh ``init``; ``move_slot_state`` carries a slot's rows and resets
    the source; ``membership_rollup`` is JAX's."""
    model = JMSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    task = jsteps.FederatedTask(model)
    kw = dict(dad_num_pow_iters=2, dad_reduction_rank=2)
    eng = make_engine("rankDAD", **kw)
    opt = jsteps.make_optimizer("adam", 1e-2)
    state = jsteps.init_train_state(task, eng, opt, jax.random.PRNGKey(0),
                                    np.ones((4, 6), np.float32), num_sites=4,
                                    staleness_bound=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 4, 6)).astype(np.float32)
    y = (rng.random((4, 3, 4)) > 0.5).astype(np.int32)
    w = np.ones((4, 3, 4), np.float32)
    s1, _ = jsteps.make_train_epoch_fn(task, eng, opt, staleness_bound=3)(state, x, y, w)
    ts1 = train_state_from_jax(jax.tree.map(np.asarray, s1), device="cpu")
    teng = make_rankdad(transposed=MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
                        .leaf_table(1).transposed, **kw)
    fresh = train_state_to_jax(ts1)  # for the port engine's fresh rows
    tinit = teng.init(ts1.params)
    for slot in (1, 3):
        want = jax.tree.map(np.asarray, jmem.reset_slot_state(s1, slot, engine=eng))
        got = train_state_to_jax(tmem.reset_slot_state(ts1, slot, engine=teng))
        for key in ("health", "buffers"):
            g, w_ = _flat(got[key]), _flat(getattr(want, key))
            assert g.keys() == w_.keys() and all(g[k].tobytes() == w_[k].tobytes() for k in g)
        g_om = {k: v for k, v in _flat(got["engine_state"]).items() if v.dtype != object}
        w_om = {k: v for k, v in _flat(want.engine_state).items() if v.dtype != object}
        f_om = {k: v for k, v in _flat(fresh["engine_state"]).items() if v.dtype != object}
        assert g_om.keys() == w_om.keys()
        for k in g_om:
            keep = [i for i in range(4) if i != slot]
            assert g_om[k][keep].tobytes() == f_om[k][keep].tobytes(), k
        for name, om in tinit["omega"].items():
            if om is not None:
                assert torch.equal(tmem.reset_slot_state(ts1, slot, engine=teng)
                                   .engine_state["omega"][name][slot], om)
    moved_j = jax.tree.map(np.asarray, jmem.move_slot_state(s1, 0, 3, engine=eng))
    moved_t = train_state_to_jax(tmem.move_slot_state(ts1, 0, 3, engine=teng))
    for key in ("health", "buffers"):
        g, w_ = _flat(moved_t[key]), _flat(getattr(moved_j, key))
        assert all(g[k].tobytes() == w_[k].tobytes() for k in g), key
    assert moved_t["buffers"]["age"][0] == ASYNC_NEVER_AGE
    table = tmem.MembershipTable(4)
    jtable = jmem.MembershipTable(4)
    for site in ("a", "b", "c"):
        table, _, _ = table.join(site)
        jtable, _, _ = jtable.join(site)
    table, _ = table.leave("b")
    jtable, _ = jtable.leave("b")
    assert tmem.membership_rollup(table, ts1, held_rounds=5) == jmem.membership_rollup(
        jtable, s1, held_rounds=5)
    assert tmem.membership_rollup(table, None)["mean_staleness"] is None


def test_the_cli_serves_and_takes_overlap_rounds(demo_tree, tmp_path, capsys, monkeypatch):
    """``--serve`` runs the daemon on the tree and prints its summary (JAX's
    keys, strict JSON); ``--overlap-rounds`` reaches the fit's config."""
    out = str(tmp_path / "cli")
    argv = ["--data-path", demo_tree, "--device", "cpu", "--quiet", "--serve",
            "--serve-epochs", "2", "--serve-spool", os.path.join(out, "spool"),
            "--out-dir", out, "--serve-rows", "32", "--batch-size", "4",
            "--set", "staleness_bound=2", "--set",
            'FS-Classification_args={"input_size": 8, "hidden_sizes": [8]}']
    assert tcli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"epochs_run", "held_rounds", "membership", "table", "preempted"} <= set(summary)
    assert summary["epochs_run"] == 2 and summary["membership"]["slots_occupied"] == 3
    assert os.path.exists(os.path.join(out, "serve", "publish.json"))
    seen = {}

    class Runner:
        def __init__(self, cfg, data_path, out_dir=None, fault_plan=None, attack_plan=None,
                     device=None):
            seen["cfg"] = cfg

        def run(self, folds=None, verbose=True, resume=False):
            return [{"test_metrics": [[0.5, 0.5]], "best_val_epoch": 1}]

    monkeypatch.setattr(trunner, "FedRunner", Runner)
    assert tcli.main(["--data-path", demo_tree, "--device", "cpu", "--overlap-rounds"]) == 0
    assert seen["cfg"].overlap_rounds is True
