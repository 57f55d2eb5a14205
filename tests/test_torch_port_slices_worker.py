"""The multi-process worker over slices (runner/dcn_worker.py ``--slices``
and ``--supervise``): two port workers, a gloo world of two slices on the
CPU, fit a 4-site FS demo tree from one JAX-written checkpoint, against
JAX's ``FedRunner(num_slices=2)`` on its sliced host mesh (conftest's
virtual CPU devices); then a supervised drill of the same fit whose slice
1 SIGKILLs itself (a ``kill_slice_at`` plan): the death in the liveness
spool, the consensus decision in JAX's format, and the resumed fleet's
params digest equal to the uninterrupted sliced run's.
"""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dcn_worker import FIT_ATOL, SANITIZE_VAR, _clean_environ, _free_port

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.runner import supervisor as tsup
from dinunet_implementations_tpu_torch.telemetry import postmortem as tpost

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "FS-Classification"
SITES, SUBJECTS, EPOCHS, SLICES = 4, 24, 2, 2
WORKER_TIMEOUT_S = 150
# the drill's kill: round 3 falls in epoch 2 (2 rounds an epoch on this tree),
# so slice 1 dies after epoch 2's rounds, before its epoch-2 sidecar
KILL_ROUND = 3
# JAX's decision file (runner/dcn_worker.py _supervise's install_consensus)
DECISION_KEYS = {"time_unix", "generation", "dead_slice", "round", "epoch", "sha", "replaced"}


def _worker(*argv) -> list:
    return [sys.executable, "-m", "dinunet_implementations_tpu_torch.runner.dcn_worker",
            *argv]


def _env() -> dict:
    return {**_clean_environ(), "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}


def _wait(procs, what: str) -> list:
    deadline, outs = time.monotonic() + WORKER_TIMEOUT_S, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what} outran {WORKER_TIMEOUT_S} s")
    return outs


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """The tree, JAX's start checkpoint, and two sliced workers' run."""
    root = tmp_path_factory.mktemp("slices_worker")
    tree = tdemo.make_fs_demo_tree(str(root / "tree"), n_sites=SITES, subjects=SUBJECTS)
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    state = jloop.FederatedTrainer(cfg, jregistry.get_task(TASK).build_model(cfg), None) \
        .init_state(jnp.ones((2, 66)), num_sites=SITES)
    start = str(root / "start.msgpack")
    jckpt.save_checkpoint(start, state)
    port = str(_free_port())
    common = ["--data-path", tree, "--epochs", str(EPOCHS), "--device", "cpu", "--slices",
              str(SLICES), "--set", f"pretrained_path={start}"]
    procs = [subprocess.Popen(
        _worker("--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
                str(r), "--out-dir", str(root / "out"), "--report", str(root / f"report{r}.json"),
                *common),
        env=_env(), cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = _wait(procs, "the two sliced workers")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    reports = [json.load(open(root / f"report{r}.json")) for r in range(2)]
    return {"root": root, "tree": tree, "start": start, "reports": reports, "common": common}


def test_sliced_workers_report_the_mesh_and_the_same_params(fit):
    a, b = fit["reports"]
    assert a["params_sha256"] == b["params_sha256"] and a["params_sha256"]
    for r, rep in enumerate(fit["reports"]):
        assert rep["mesh_shape"] == {"slice": 2, "site": 1, "model": 1} and rep["pack"] == 2
        assert rep["mesh_axes"] == ["slice", "site", "model"]
        assert (rep["num_slices"], rep["slice_id"], rep["process_index"]) == (2, r, r)
    assert a["epoch_losses"] == b["epoch_losses"] and a["test_metrics"] == b["test_metrics"]
    assert (b["n_log_writes"], b["n_ckpt_writes"]) == (0, 0) and a["n_ckpt_writes"] > 0


def test_sliced_workers_match_jax_fedrunner_with_two_slices(fit, tmp_path, monkeypatch):
    """JAX's ``FedRunner(num_slices=2)`` lays the slices over 4 virtual
    devices (K = 1); the port over 2 ranks (K = 2): the FS fit tolerance
    of tests/test_torch_port_dcn_worker.py."""
    monkeypatch.delenv(SANITIZE_VAR, raising=False)
    cfg = jconfig.TrainConfig(task_id=TASK, epochs=EPOCHS, validation_epochs=2, patience=10,
                              batch_size=8, split_ratio=(0.7, 0.15, 0.15), seed=0,
                              pretrained_path=fit["start"], num_slices=SLICES)
    runner = jrunner.FedRunner(cfg, data_path=fit["tree"], out_dir=str(tmp_path / "jax"))
    assert dict(runner.mesh.shape)["slice"] == SLICES
    want = runner.run(folds=[0], verbose=False)[0]
    got = fit["reports"][0]
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], atol=FIT_ATOL, rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=FIT_ATOL, rtol=0)


def test_supervised_drill_resumes_to_the_uninterrupted_digest(fit):
    """``--supervise --slices 2`` with ``kill_slice_at`` of slice 1: the
    supervisor records slice 1's death, installs the consensus and
    relaunches; the resumed fleet ends on the uninterrupted run's params."""
    out = fit["root"] / "drill"
    faults = json.dumps({"kill_slice_at": [[1, KILL_ROUND]]})
    proc = subprocess.Popen(
        _worker("--supervise", "--num-processes", "2", "--out-dir", str(out), "--report",
                str(out / "rep.json"), "--faults", faults, "--heartbeat-s", "0.5",
                "--heartbeat-timeout-s", "30", *fit["common"]),
        env=_env(), cwd=str(fit["root"]), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    outs = _wait([proc], "the supervised drill")
    assert proc.returncode == 0, outs[0]
    deaths = [e for e in tsup.read_slice_liveness(os.path.join(out, tsup.LIVENESS_DIR))
              if e["event"] == "dead"]
    assert [(e["slice"], e["generation"]) for e in deaths] == [(1, 1)]
    assert "signal 9" in deaths[0]["reason"]
    decision = json.load(open(out / tpost.CONSENSUS_DIR / "decision_gen1.json"))
    assert set(decision) == DECISION_KEYS
    assert (decision["dead_slice"], decision["round"], decision["epoch"]) == (1, 2, 1)
    reps = [json.load(open(out / f"rep_p{r}.json")) for r in range(2)]
    assert all(r["restart_generation"] == 2 for r in reps)
    assert reps[0]["params_sha256"] == reps[1]["params_sha256"] == \
        fit["reports"][0]["params_sha256"]
