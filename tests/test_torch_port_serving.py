"""The port's serving slice on the CPU: the inference engine against the JAX
package's ``eval_forward``, the registry and config copies, and the
package's independence from JAX."""

import dataclasses
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.models.icalstm import ICALstm as JaxICALstm
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.runner import registry as treg
from dinunet_implementations_tpu_torch.serving import (
    InferenceEngine,
    Microbatcher,
    RequestError,
    RequestFuture,
    ServingClosed,
    ServingError,
)
from dinunet_implementations_tpu_torch.trainer import steps as tsteps

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dinunet_implementations_tpu_torch"

# small ICA-LSTM: 30 timepoints in windows of 5 -> 6 windows of 4 components
ICA = dict(num_components=4, temporal_size=30, window_size=5, input_size=16, hidden_size=12)


def _cfg(**kw):
    return tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA,
                               ica_args=tconfig.ICAArgs(**{**ICA, **kw}))


def _jax_task_and_weights(seed=0):
    model = JaxICALstm(input_size=16, hidden_size=12, num_cls=2, num_comps=4,
                       window_size=5, use_pallas=True)
    task = jsteps.FederatedTask(model)
    params, stats = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, 6, 4, 5)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    stats = {"cls_bn": {"mean": (0.5 * rng.standard_normal(256)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 256).astype(np.float32)}}
    return task, params, stats


def test_engine_serves_requests_from_two_threads_like_jax_eval_forward():
    task, params, stats = _jax_task_and_weights()
    rng = np.random.default_rng(1)
    reqs = [rng.standard_normal((n, 6, 4, 5)).astype(np.float32) for n in (1, 3, 2, 4, 1, 2)]
    futures = [None] * len(reqs)
    with InferenceEngine(_cfg(), params=params, batch_stats=stats, row_buckets=(1, 2, 4),
                         device="cpu") as eng:
        eng.warmup()

        def client(ix):
            for i in ix:
                futures[i] = eng.submit(reqs[i])

        threads = [threading.Thread(target=client, args=(range(k, len(reqs), 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        got = [f.result(timeout=30) for f in futures]
    s = eng.summary()
    assert s["requests"] == 6 and s["samples"] == 13
    assert s["dispatches"] >= 4  # 13 rows never fit fewer 4-row buckets
    assert s["latency_ms_p50"] is not None and s["latency_ms_p99"] >= s["latency_ms_p50"]
    # eval rows are independent (the head normalises by running stats), so
    # one JAX call over all requests' rows is each request's reference
    allx = np.concatenate(reqs)
    want = np.asarray(jsteps.eval_forward(task, params, stats, jnp.asarray(allx), None,
                                          jnp.ones(len(allx))))
    at = 0
    for rows, probs in zip(reqs, got):
        assert probs.shape == (len(rows), 2)
        np.testing.assert_allclose(probs, want[at:at + len(rows)], atol=1e-5, rtol=1e-5)
        at += len(rows)


def test_pad_rows_do_not_change_real_rows():
    _, params, stats = _jax_task_and_weights(seed=2)
    eng = InferenceEngine(_cfg(), params=params, batch_stats=stats, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 6, 4, 5)).astype(np.float32))
    alone = tsteps.eval_forward(eng.task, x, None, torch.ones(3))
    padded = torch.cat([x, torch.zeros(5, 6, 4, 5)])
    w = torch.tensor([1.0] * 3 + [0.0] * 5)
    together = tsteps.eval_forward(eng.task, padded, None, w)
    np.testing.assert_allclose(together[:3].numpy(), alone.numpy(), atol=1e-6, rtol=1e-6)


def test_engine_refuses_without_cuda_unless_cpu_is_explicit(monkeypatch):
    _, params, stats = _jax_task_and_weights()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(_cfg(), params=params, batch_stats=stats)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.build_model(_cfg())
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        treg.build_model(_cfg(), device="cuda")
    InferenceEngine(_cfg(), params=params, batch_stats=stats, device="cpu").close()


def test_engine_rejects_bad_weights_and_requests():
    _, params, stats = _jax_task_and_weights()
    broken = {**params, "cls_fc3": {"kernel": params["cls_fc3"]["kernel"]}}
    with pytest.raises(ValueError, match="missing leaves.*cls_fc3/bias"):
        InferenceEngine(_cfg(), params=broken, batch_stats=stats, device="cpu")
    with pytest.raises(ServingError, match="either params"):
        InferenceEngine(_cfg(), device="cpu")
    # the default task (FS) takes MSANNet's tree, not this ICA-LSTM's, and
    # the sMRI task SMRI3DNet's
    with pytest.raises(ValueError, match="not an MSANNet variable tree"):
        InferenceEngine(tconfig.TrainConfig(), params=params, batch_stats=stats, device="cpu")
    with pytest.raises(ValueError, match="not an SMRI3DNet variable tree"):
        InferenceEngine(tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_SMRI_3D),
                        params=params, batch_stats=stats, device="cpu")
    with InferenceEngine(_cfg(), params=params, batch_stats=stats, row_buckets=(1, 2),
                         device="cpu") as eng:
        with pytest.raises(ServingError, match="warmup"):
            eng.submit(np.zeros((1, 6, 4, 5)))
        eng.warmup()
        with pytest.raises(ServingError, match="serves"):
            eng.submit(np.zeros((1, 6, 4, 4)))
        with pytest.raises(RequestError, match="exceeds the largest bucket"):
            eng.submit(np.zeros((3, 6, 4, 5)))


def test_microbatcher_batches_in_arrival_order_and_drains_on_close():
    class Req:
        def __init__(self, n):
            self.rows = np.zeros((n, 1))
            self.future = RequestFuture()

    seen = []

    def dispatch(reqs, bucket):
        seen.append(([len(r.rows) for r in reqs], bucket))
        for r in reqs:
            r.future.set_result(len(r.rows))

    # a long max-delay: only a full bucket, a request that does not fit, or
    # close() ends a batch
    mb = Microbatcher(dispatch, (4, 1, 2), max_delay_ms=10_000.0, name="t")
    reqs = [Req(n) for n in (1, 2, 3, 1, 2)]
    for r in reqs:
        mb.submit(r)
    with pytest.raises(RequestError, match="exceeds the largest bucket"):
        mb.submit(Req(5))
    assert [r.future.result(timeout=10) for r in reqs[:4]] == [1, 2, 3, 1]
    mb.close()
    assert reqs[4].future.result(timeout=10) == 2
    # 3 rows do not fit after 1 + 2, so they open the next dispatch
    assert seen == [([1, 2], 4), ([3, 1], 4), ([2], 2)]
    # the lane's other counters (peak depth, deferrals) depend on when the
    # dispatch thread wakes
    assert {k: mb.stats[k] for k in ("requests", "dispatches", "rows", "pad_rows", "rejected",
                                     "bucket_hits", "shed")} == {
        "requests": 5, "dispatches": 3, "rows": 9, "pad_rows": 1, "rejected": 1,
        "bucket_hits": 2, "shed": 0}
    with pytest.raises(ServingClosed):
        mb.submit(Req(1))


def test_engine_takes_the_port_models_own_state_dict():
    cfg = _cfg(bidirectional=False)
    model = treg.build_model(cfg, device="cpu")
    with InferenceEngine(cfg, state_dict=model.state_dict(), row_buckets=(2,),
                         device="cpu") as eng:
        eng.warmup()
        x = np.random.default_rng(4).standard_normal((2, 6, 4, 5)).astype(np.float32)
        got = eng.submit(x).result(timeout=30)
    want = tsteps.eval_forward(tsteps.FederatedTask(model.eval()), torch.from_numpy(x))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


def test_ica_sample_shape_and_windows_at_the_defaults():
    cfg = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA)
    spec = treg.get_task(cfg.task_id)
    assert spec.serving.sample_shape(cfg) == (98, 100, 10)
    assert treg._ica_windows(cfg.ica_args) == 98
    assert spec.serving.sample_shape(_cfg()) == (6, 4, 5)


def test_config_copy_keeps_the_jax_defaults():
    jica = jconfig.ICAArgs()
    for f in dataclasses.fields(tconfig.ICAArgs):
        assert getattr(tconfig.ICAArgs(), f.name) == getattr(jica, f.name), f.name
    jcfg, tcfg = jconfig.TrainConfig(), tconfig.TrainConfig()
    assert (tcfg.task_id, tcfg.seed) == (jcfg.task_id, jcfg.seed)
    for name in ("TASK_FREE_SURFER", "TASK_ICA", "TASK_SMRI_3D", "TASK_MULTIMODAL"):
        assert getattr(tconfig.NNComputation, name) == getattr(jconfig.NNComputation, name)


def test_importing_the_port_pulls_in_no_jax():
    mods = sorted(
        "dinunet_implementations_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    for mod in ("models.cnn3d", "models.transformer", "data.smri", "data.multimodal",
                "robustness.faults", "robustness.attacks", "privacy.accounting",
                "privacy.dpsgd", "privacy.personalize", "privacy.secure_agg",
                "telemetry.flight", "telemetry.exporter", "serving.__main__", "analysis",
                "checks.core", "checks.rules", "checks.__main__", "runner.scheduler",
                "runner.supervisor", "telemetry.collector", "telemetry.assemble",
                "telemetry.postmortem", "parallel.mesh", "parallel.distributed",
                "runner.dcn_worker", "parallel.collectives", "engines.base", "engines.dsgd",
                "engines.rankdad", "engines.powersgd", "telemetry.metrics", "trainer.steps",
                "trainer.loop", "runner.fed_runner", "runner.cli"):
        assert "dinunet_implementations_tpu_torch." + mod in mods, mod
    code = (
        "import sys, importlib\n"
        f"for m in {['dinunet_implementations_tpu_torch'] + mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'flax'"
        " or m == 'dinunet_implementations_tpu' or m.startswith('dinunet_implementations_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted(
        (REPO / "scripts").glob("torch_*.py"))
    # the native reader's loader and bridge are scanned too, and the loader
    # compiles the port's own copy of fastio.cpp
    for part in ("native/__init__.py", "data/native_io.py", "robustness/retry.py",
                 "models/cnn3d.py", "models/transformer.py", "data/smri.py",
                 "data/multimodal.py", "robustness/faults.py", "robustness/attacks.py",
                 "robustness/health.py", "parallel/collectives.py", "privacy/__init__.py",
                 "privacy/accounting.py", "privacy/dpsgd.py", "privacy/personalize.py",
                 "privacy/secure_agg.py", "telemetry/flight.py", "telemetry/exporter.py",
                 "serving/__main__.py", "analysis.py", "checks/core.py", "checks/rules.py",
                 "checks/__main__.py", "runner/scheduler.py", "runner/supervisor.py",
                 "telemetry/collector.py", "telemetry/assemble.py", "telemetry/postmortem.py",
                 "parallel/mesh.py", "parallel/distributed.py", "runner/dcn_worker.py",
                 "engines/base.py", "engines/dsgd.py", "engines/rankdad.py",
                 "engines/powersgd.py", "telemetry/metrics.py", "trainer/steps.py",
                 "trainer/loop.py", "runner/fed_runner.py", "runner/cli.py"):
        assert PORT / part in files, part
    loader = (PORT / "native" / "__init__.py").read_text()
    assert "Path(__file__).resolve().parent" in loader and (PORT / "native" / "fastio.cpp").is_file()
    assert "dinunet_implementations_tpu/" not in loader
    seen = set()
    for p in files:
        for mod in _IMPORT.findall(p.read_text()):
            seen.add(mod)
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (p, mod)
            # the port's own name starts with the JAX package's: match whole names
            assert top != "dinunet_implementations_tpu", (p, mod)
    assert "torch" in seen
