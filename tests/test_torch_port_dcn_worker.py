"""The multi-process worker (runner/dcn_worker.py): two port worker
processes, a gloo world on the CPU, fit a 4-site FS demo tree end to end
from one JAX-written checkpoint, against JAX's ``FedRunner`` on its host
mesh (conftest's virtual CPU devices); the worker's refusals, exit codes
and the CLI's multi-process flags.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import dcn_worker

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "FS-Classification"
SITES, SUBJECTS, EPOCHS = 4, 24, 2
WORKER_TIMEOUT_S = 120
# the FS fit tests' tolerance (tests/test_torch_port_fs_fit.py FIT_TOL's
# metrics): the two-level sums run in another order than JAX's psum over
# its 4-device mesh
FIT_ATOL = 1e-4
# the runtime sanitizer's switch (checks/sanitize.py ENV_VAR in both packages)
SANITIZE_VAR = "DINUNET_SANITIZE"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cfg_kw(start):
    """The worker's config (its defaults and the ``--set`` below)."""
    return dict(task_id=TASK, epochs=EPOCHS, validation_epochs=2, patience=10, batch_size=8,
                split_ratio=(0.7, 0.15, 0.15), seed=0, pretrained_path=start)


def _clean_environ() -> dict:
    """This process's environment without the sanitizer's variable: a
    test earlier in the same process may leave it set (each package's CLI
    writes it), and under ``compile`` JAX's reference fit of this tree
    fails its own one-compile guard (its epoch program compiles twice)."""
    return {k: v for k, v in os.environ.items() if k != SANITIZE_VAR}


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """The tree, JAX's start checkpoint, and the two workers' run."""
    root = tmp_path_factory.mktemp("dcn")
    tree = tdemo.make_fs_demo_tree(str(root / "tree"), n_sites=SITES, subjects=SUBJECTS)
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    state = jloop.FederatedTrainer(cfg, jregistry.get_task(TASK).build_model(cfg), None) \
        .init_state(jnp.ones((2, 66)), num_sites=SITES)
    start = str(root / "start.msgpack")
    jckpt.save_checkpoint(start, state)
    port = str(_free_port())
    env = {**_clean_environ(), "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dinunet_implementations_tpu_torch.runner.dcn_worker",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
         "--data-path", tree, "--out-dir", str(root / "out"), "--report",
         str(root / f"report{r}.json"), "--epochs", str(EPOCHS), "--device", "cpu",
         "--set", f"pretrained_path={start}"],
        env=env, cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline, outs = time.monotonic() + WORKER_TIMEOUT_S, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the two workers outran {WORKER_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    reports = [json.load(open(root / f"report{r}.json")) for r in range(2)]
    return {"root": root, "tree": tree, "start": start, "reports": reports}


def test_both_ranks_report_the_same_params_and_the_mesh(fit):
    a, b = fit["reports"]
    assert a["params_sha256"] == b["params_sha256"] and a["params_sha256"]
    for r, rep in enumerate(fit["reports"]):
        assert (rep["process_index"], rep["process_count"], rep["multi"]) == (r, 2, True)
        assert rep["mesh_shape"] == {"site": 2, "model": 1} and rep["pack"] == 2
        assert rep["backend"] == "gloo" and rep["mesh_spans_processes"]
    assert a["epoch_losses"] == b["epoch_losses"] and a["test_metrics"] == b["test_metrics"]


def test_only_rank_zero_writes(fit):
    a, b = fit["reports"]
    assert a["n_log_writes"] == SITES + 1 and a["n_ckpt_writes"] > 0
    assert b["n_log_writes"] == 0 and b["n_ckpt_writes"] == 0
    fold = os.path.join(fit["root"], "out", "remote", "simulatorRun", TASK, "fold_0")
    for name in ("logs.json", "test_metrics.csv", "checkpoint_best.msgpack",
                 "checkpoint_latest.msgpack"):
        assert os.path.isfile(os.path.join(fold, name)), name
    assert not any("_p1" in f for f in os.listdir(fit["root"]))


def test_losses_match_jax_fedrunner_on_its_host_mesh(fit, tmp_path, monkeypatch):
    monkeypatch.delenv(SANITIZE_VAR, raising=False)
    cfg = jconfig.TrainConfig(**_cfg_kw(fit["start"]))
    runner = jrunner.FedRunner(cfg, data_path=fit["tree"], out_dir=str(tmp_path / "jax"))
    assert runner.mesh is not None and dict(runner.mesh.shape)["site"] == SITES
    want = runner.run(folds=[0], verbose=False)[0]
    got = fit["reports"][0]
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], atol=FIT_ATOL, rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=FIT_ATOL, rtol=0)


def test_a_backend_that_cannot_run_here_exits_unsupported(tmp_path, capsys):
    """nccl (the default on the card) with no card: exit 66 before any join."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nccl can run")
    rc = dcn_worker.main(["--data-path", str(tmp_path), "--num-processes", "2",
                          "--coordinator", f"127.0.0.1:{_free_port()}", "--process-id", "1"])
    assert rc == dcn_worker.UNSUPPORTED_RC == 66
    assert "UNSUPPORTED" in capsys.readouterr().out


def test_cli_refuses_a_partial_multi_process_spec_as_jax(tmp_path):
    for argv in (["--coordinator", "127.0.0.1:1"], ["--num-processes", "2"],
                 ["--process-id", "0", "--num-processes", "2"]):
        with pytest.raises(SystemExit, match="all of --coordinator, --num-processes"):
            tcli.main(["--data-path", str(tmp_path), "--device", "cpu", *argv])


@pytest.mark.parametrize("mode", [["--schedule"], ["--serve"], ["--site", "0"]])
def test_cli_refuses_a_process_group_outside_the_federated_fit(mode, tmp_path):
    """A whole multi-process spec with the scheduler, the daemon or one
    site's fit exits before anything joins (the coordinator's port has no
    listener: a join would wait for it)."""
    import torch.distributed as dist

    argv = ["--data-path", str(tmp_path), "--device", "cpu", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2", "--process-id", "1", *mode]
    match = "one site's local fit" if mode[0] == "--site" else r"ROADMAP A11 \(b\)"
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)
    assert not dist.is_initialized()
