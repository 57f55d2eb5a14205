"""Durable rounds in the port: ``Preempted`` and ``PreemptionGuard``
against the JAX package's (exit codes, the latch, a second SIGINT,
nesting, a thread off the main one), the guard latching a real SIGTERM sent
to this process, a ``FaultPlan`` ``kill_at_round`` fit that saves and then
raises and resumes bit for bit, a SIGTERM during a fit, and the command
line's exit codes and JSON line (JAX's keys).

The fits run the ICA demo tree of tests/test_torch_port_faults.py on the
CPU; resumed and uninterrupted fits are held equal bit for bit.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest

from dinunet_implementations_tpu.robustness import preemption as jpre
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.robustness import preemption as tpre
from dinunet_implementations_tpu_torch.robustness.faults import FaultPlan
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import loop as tloop
from dinunet_implementations_tpu_torch.weights import train_state_to_jax

# 3 sites of 24 subjects, batch 8: 2 rounds an epoch
TREE = dict(n_sites=3, subjects=24, comps=16, temporal=80, window=10)
BATCH, EPOCHS = 8, 3
TASK = "ICA-Classification"
KILL = 3  # crossed in epoch 2 (rounds 2 and 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdemo.make_ica_demo_tree(str(tmp_path_factory.mktemp("ica_tree")), **TREE)


def _runner(tree, out, fault_plan=None):
    return trunner.FedRunner(tconfig.TrainConfig(task_id=TASK), tree, str(out), device="cpu",
                             fault_plan=fault_plan, epochs=EPOCHS, batch_size=BATCH)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: None if tree is None else np.asarray(tree)}


def _bit_equal(a, b):
    fa, fb = _flat(train_state_to_jax(a)), _flat(train_state_to_jax(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert (fa[k] is None) == (fb[k] is None), k
        assert fa[k] is None or fa[k].tobytes() == fb[k].tobytes(), k


@pytest.fixture(scope="module")
def uninterrupted(tree, tmp_path_factory):
    return _runner(tree, tmp_path_factory.mktemp("whole")).run(folds=[0], verbose=False)[0]


def _latest(out):
    return os.path.join(out, "remote", "simulatorRun", TASK, "fold_0",
                        "checkpoint_latest.msgpack")


def test_preempted_and_the_guard_match_jax():
    """Exit codes (75 for the plan's kill, ``128 + signum`` for a signal),
    a ``BaseException``, the latch of the first signal, a second SIGINT
    raising ``KeyboardInterrupt``, nested guards restoring their
    handlers, and an inert guard off the main thread: as JAX's."""
    for mod in (tpre, jpre):
        p = mod.Preempted("kill", epoch=2)
        assert p.exit_code == 75 and p.epoch == 2 and not isinstance(p, Exception)
        assert mod.Preempted("sig", signum=signal.SIGTERM).exit_code == 128 + signal.SIGTERM
        before = signal.getsignal(signal.SIGINT)
        with mod.PreemptionGuard() as outer:
            with mod.PreemptionGuard() as inner:
                inner._handler(signal.SIGINT, None)
                assert inner.requested == signal.SIGINT and outer.requested is None
                with pytest.raises(KeyboardInterrupt):
                    inner._handler(signal.SIGINT, None)
            assert signal.getsignal(signal.SIGINT) == outer._handler
        assert signal.getsignal(signal.SIGINT) == before
        seen = {}

        def off_main():
            with mod.PreemptionGuard() as g:
                seen["old"] = dict(g._old)

        t = threading.Thread(target=off_main)
        t.start()
        t.join()
        assert seen["old"] == {}


def test_the_guard_latches_a_real_sigterm_in_process():
    """``os.kill(os.getpid(), SIGTERM)`` inside the guard sets the latch
    instead of ending the process, and the handler is restored after."""
    before = signal.getsignal(signal.SIGTERM)
    with tpre.PreemptionGuard() as g:
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == before


def test_kill_at_round_saves_then_raises_and_resumes_bit_exact(tree, tmp_path, uninterrupted):
    """The kill crossed in epoch 2 raises ``Preempted`` (exit 75) after
    epoch 2's rotating checkpoint; ``resume=True`` starts past the round
    and ends with the uninterrupted fit's best state, losses and test
    metrics, bit for bit."""
    out = tmp_path / "killed"
    plan = FaultPlan(kill_at_round=KILL)
    with pytest.raises(tpre.Preempted) as info:
        _runner(tree, out, plan).run(folds=[0], verbose=False)
    assert info.value.exit_code == 75 and info.value.epoch == 2
    assert f"kill_at_round={KILL}" in info.value.reason
    meta = tckpt.load_meta(_latest(str(out)))
    assert meta["epoch"] == 2 and len(meta["epoch_losses"]) == 2
    res = _runner(tree, out, plan).run(folds=[0], verbose=False, resume=True)[0]
    assert res["epoch_losses"] == uninterrupted["epoch_losses"]
    assert res["test_metrics"] == uninterrupted["test_metrics"]
    _bit_equal(res["state"], uninterrupted["state"])


def test_a_sigterm_during_a_fit_checkpoints_then_raises(tree, tmp_path, uninterrupted,
                                                        monkeypatch):
    """A SIGTERM that lands during epoch 1 lets the epoch finish, the
    checkpoint land, then raises ``Preempted`` with ``128 + SIGTERM``; the
    resumed fit equals the uninterrupted one bit for bit."""
    out = tmp_path / "signalled"
    run_epoch = tloop.FederatedTrainer.run_epoch

    def signalled(self, state, sites, epoch, **kw):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return run_epoch(self, state, sites, epoch, **kw)

    monkeypatch.setattr(tloop.FederatedTrainer, "run_epoch", signalled)
    with pytest.raises(tpre.Preempted) as info:
        _runner(tree, out).run(folds=[0], verbose=False)
    assert info.value.exit_code == 128 + signal.SIGTERM and info.value.epoch == 1
    assert tckpt.load_meta(_latest(str(out)))["epoch"] == 1
    monkeypatch.setattr(tloop.FederatedTrainer, "run_epoch", run_epoch)
    res = _runner(tree, out).run(folds=[0], verbose=False, resume=True)[0]
    _bit_equal(res["state"], uninterrupted["state"])


def test_the_cli_exits_75_then_resumes(tree, tmp_path, capsys, uninterrupted):
    """``--faults kill_at_round`` exits 75 with JAX's JSON line on stderr;
    ``--resume`` exits 0 with the fold's line, the uninterrupted fit's test
    loss."""
    argv = ["--data-path", tree, "--device", "cpu", "--task", TASK, "--epochs", str(EPOCHS),
            "--batch-size", str(BATCH), "--folds", "0", "--out-dir", str(tmp_path / "cli"),
            "--quiet", "--faults", json.dumps({"kill_at_round": KILL})]
    assert tcli.main(argv) == 75
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(line) == {"preempted", "reason", "epoch", "resume_with"}
    assert line["preempted"] is True and line["epoch"] == 2 and line["resume_with"] == "--resume"
    assert tcli.main(argv + ["--resume"]) == 0
    fold = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fold["fold"] == 0 and fold["test_loss"] == uninterrupted["test_metrics"][0][0]
