"""The port's telemetry plane through its fits, runners and command line,
against the JAX package's contracts: the artifacts of a telemetry-on fit
(``manifest.json``, ``metrics.jsonl``, ``trace.jsonl``,
``trace.chrome.json``) against JAX's validators (the manifest differs from
JAX's by exactly its two version keys), the privacy block against JAX's
``privacy_manifest``, a telemetry-off fit, a preempted fit, the report CLI,
the profiler options, the compile cache, the sanitizer around the runners
and the command line, and the live options that ROADMAP A12 (b) refused
before it was ported.

The fits are JAX's telemetry corner (tests/test_telemetry.py ``_fit``:
MSANNet 6→8→2 over toy sites) and a small FS tree through the runners and
the CLI, all on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.telemetry import metrics as jmetrics
from dinunet_implementations_tpu.telemetry import report as jreport
from dinunet_implementations_tpu.telemetry import sink as jsink
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.checks import sanitize as tsan
from dinunet_implementations_tpu_torch.core.config import FSArgs, TrainConfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.data.api import SiteArrays
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.ops import _build
from dinunet_implementations_tpu_torch.robustness.faults import FaultPlan
from dinunet_implementations_tpu_torch.robustness.preemption import Preempted
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.serving import InferenceEngine
from dinunet_implementations_tpu_torch.telemetry import (
    FlightRecorder,
    MetricsBus,
    report,
    sink,
    xprof,
)
from dinunet_implementations_tpu_torch.trainer import loop as tloop

D = 6
FS_TREE = dict(n_sites=2, subjects=24, seed=5)


def _toy_sites(ns, n=24, d=D, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ns):
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = (x.sum(-1) > 0).astype(np.int32)
        out.append(SiteArrays(x, y, np.arange(n, dtype=np.int32)))
    return out


def _cfg(**kw):
    base = dict(epochs=3, batch_size=8, patience=50, telemetry="on",
                fs_args=FSArgs(input_size=D, hidden_sizes=(8,)))
    return TrainConfig(**{**base, **kw})


def _fit(cfg, out_dir, fault_plan=None, bus=None, resume=False):
    tr = tloop.FederatedTrainer(cfg, MSANNet(in_size=D, hidden_sizes=(8,), out_size=2),
                                out_dir=out_dir, fault_plan=fault_plan, bus=bus, device="cpu")
    res = tr.fit(_toy_sites(2), _toy_sites(2, n=16, seed=9), _toy_sites(2, n=16, seed=5),
                 verbose=False, resume=resume)
    return tr, res


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """One telemetry-on fit of the corner (3 epochs) with its own bus."""
    out = str(tmp_path_factory.mktemp("fit"))
    bus = MetricsBus()
    tr, res = _fit(_cfg(), out, bus=bus)
    return out, tr, res, bus


def test_fit_writes_artifacts_that_pass_jax_s_validators(fitted):
    """manifest.json, metrics.jsonl (3 epoch rows, a summary row) and both
    traces under fold_0; the rows pass JAX's ``validate_metrics_rows`` and
    the port's; JAX's ``validate_manifest`` reports exactly the two renamed
    version keys, the port's nothing; the spans of the fit are in the
    trace."""
    out, tr, res, _ = fitted
    d = os.path.join(out, "telemetry", "fold_0")
    assert sorted(os.listdir(d)) == sorted([sink.MANIFEST_FILE, sink.METRICS_FILE,
                                            sink.TRACE_JSONL_FILE, sink.TRACE_CHROME_FILE])
    manifest = json.load(open(os.path.join(d, sink.MANIFEST_FILE)))
    assert sink.validate_manifest(manifest) == []
    assert jsink.validate_manifest(manifest) == [
        "manifest missing keys: ['jax_version', 'jaxlib_version']"]
    assert sink.MANIFEST_REQUIRED ^ jsink.MANIFEST_REQUIRED == {
        "jax_version", "jaxlib_version", "torch_version", "cuda_version"}
    assert manifest["torch_version"] == torch.__version__
    assert (manifest["backend"], manifest["device_name"], manifest["mesh"]) == ("cpu", "cpu", None)
    assert (manifest["agg_engine"], manifest["num_sites"], manifest["fold"]) == ("dSGD", 2, 0)
    assert manifest["config"]["telemetry"] == "on" and manifest["privacy"] is None
    rows = sink.load_metrics(os.path.join(d, sink.METRICS_FILE))
    assert jsink.validate_metrics_rows(rows) == [] == sink.validate_metrics_rows(rows)
    assert {k: frozenset(v) for k, v in sink.ROW_REQUIRED.items()} == jsink.ROW_REQUIRED
    epochs = [r for r in rows if r["kind"] == "epoch"]
    (summary,) = [r for r in rows if r["kind"] == "summary"]
    assert [r["epoch"] for r in epochs] == [1, 2, 3]
    assert [r["rounds"] for r in epochs] == [3, 6, 9]
    assert summary["epochs_run"] == 3 and summary["membership"] is None
    assert summary["epoch_compiles"] == 0  # no kernel library on the CPU
    assert len(epochs[-1]["site_grad_sq_last"]) == 2 and epochs[-1]["dp_epsilon"] is None
    names = {e["name"] for e in json.load(open(os.path.join(d, sink.TRACE_CHROME_FILE)))[
        "traceEvents"]}
    assert {"fit", "epoch", "eval", "test", "checkpoint", "write-outputs",
            "inventory-upload", "plan-build"} <= names
    trace = [json.loads(line) for line in open(os.path.join(d, sink.TRACE_JSONL_FILE))]
    assert trace[0]["name"] == "clock_sync"
    assert tr.tracer.count("epoch") == 3


def test_fit_results_logs_and_bus_carry_the_round_metrics(fitted):
    """``results["site_telemetry"]`` is the final state's rollup; the
    remote and each site's ``logs.json`` carry JAX's telemetry fields; the
    bus holds the epoch gauges and counters; the payload a round is the
    JAX engine's figure for the same model."""
    out, tr, res, bus = fitted
    st = res["site_telemetry"]
    assert st["rounds"] == 9 and st["held_rounds"] == 0 and len(st["site_grad_norm_last"]) == 2
    params, _ = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2)) \
        .init_variables(jax.random.PRNGKey(0), jnp.ones((2, D)))
    assert st["payload_bytes_per_round"] == jmetrics.payload_bytes_of(make_engine("dSGD"),
                                                                       params)
    task = "FS-Classification"
    remote = json.load(open(os.path.join(out, "remote", "simulatorRun", task, "fold_0",
                                         "logs.json")))
    assert remote["site_grad_norm_last"] == st["site_grad_norm_last"]
    assert remote["payload_bytes_per_round"] == st["payload_bytes_per_round"]
    local = json.load(open(os.path.join(out, "local1", "simulatorRun", task, "fold_0",
                                        "logs.json")))
    assert local["grad_norm_mean"] == st["site_grad_norm_mean"][1]
    snap = bus.snapshot()
    assert snap["counters"]["train_epochs_total"] == 3
    assert snap["counters"]["train_rounds_total"] == 9
    assert snap["gauges"]["train_epoch"] == 3 and "epoch_ms" in snap["histograms"]


def test_privacy_block_equals_jax_privacy_manifest(tmp_path):
    """The manifest's privacy block of a DP + masked-wire + personalized
    fit is JAX's ``privacy_manifest`` of the same knobs; None when the
    plane is off; the epoch rows carry ε."""
    kw = dict(dp_clip=1.0, dp_noise_multiplier=0.5, dp_seed=3, dp_epsilon_budget=1000.0,
              secure_agg="mask", secure_agg_seed=2, personalize=("fc_out",))
    jcfg = jconfig.TrainConfig(**kw)
    assert sink.privacy_manifest(TrainConfig(**kw)) == jsink.privacy_manifest(jcfg)
    assert sink.privacy_manifest(TrainConfig()) is None is jsink.privacy_manifest(
        jconfig.TrainConfig())
    for one in ({"dp_clip": 1.0}, {"secure_agg": "mask"}, {"personalize": ("x",)}):
        assert sink.privacy_manifest(TrainConfig(**one)) == jsink.privacy_manifest(
            jconfig.TrainConfig(**one))
    _, res = _fit(_cfg(epochs=2, **kw), str(tmp_path))
    d = tmp_path / "telemetry" / "fold_0"
    assert json.load(open(d / sink.MANIFEST_FILE))["privacy"] == jsink.privacy_manifest(jcfg)
    eps = [r["dp_epsilon"] for r in sink.load_metrics(str(d / sink.METRICS_FILE))
           if r["kind"] == "epoch"]
    assert len(eps) == 2 and 0 < eps[0] < eps[1] == res["dp_epsilon"]


def test_telemetry_off_fit_writes_nothing(tmp_path):
    tr, res = _fit(_cfg(telemetry="off", epochs=1), str(tmp_path))
    assert not (tmp_path / "telemetry").exists() and "site_telemetry" not in res
    assert tr.tracer.events() == [] and res["state"].telemetry is None


def test_telemetry_dir_and_no_out_dir(tmp_path):
    """``telemetry_dir`` roots the sinks elsewhere; without it and without
    an out_dir the fit collects but writes nothing."""
    _fit(_cfg(epochs=1, telemetry_dir=str(tmp_path / "tel")), None)
    assert (tmp_path / "tel" / "fold_0" / sink.MANIFEST_FILE).exists()
    tr, res = _fit(_cfg(epochs=1), None)
    assert res["site_telemetry"]["rounds"] == 3 and tr.tracer.count("epoch") == 1


def test_preempted_fit_still_finalizes_its_artifacts(tmp_path):
    """A kill at round 4 (epoch 2) raises ``Preempted`` after the epoch's
    checkpoint; the fold's artifacts are complete: a ``preempted`` event,
    the summary row, both traces, the fit span closed not-ok. The resumed
    fit starts its rows afresh and runs the remaining epoch."""
    with pytest.raises(Preempted):
        _fit(_cfg(), str(tmp_path), fault_plan=FaultPlan(kill_at_round=4))
    d = tmp_path / "telemetry" / "fold_0"
    rows = sink.load_metrics(str(d / sink.METRICS_FILE))
    assert [r["name"] for r in rows if r["kind"] == "event"][-1] == "preempted"
    assert rows[-1]["kind"] == "summary" and rows[-1]["epochs_run"] == 2
    assert report.validate_fit(str(d)) == []
    fit_span = next(e for e in map(json.loads, open(d / sink.TRACE_JSONL_FILE))
                    if e.get("name") == "fit")
    assert fit_span["ok"] is False
    _, res = _fit(_cfg(), str(tmp_path), fault_plan=FaultPlan(kill_at_round=4), resume=True)
    rows = sink.load_metrics(str(d / sink.METRICS_FILE))
    assert [r["epoch"] for r in rows if r["kind"] == "epoch"] == [3]
    assert res["site_telemetry"]["rounds"] == 9


def test_report_cli_renders_and_validates(fitted, tmp_path, capsys):
    """The report renders the run header, phase table, per-site rollup and
    counters; ``--validate`` exits 0 on the fit and 1 on a broken copy; two
    paths close with the per-tenant rollup. JAX's own ``validate_fit`` on
    the port's artifacts reports only the renamed manifest keys."""
    out = fitted[0]
    root = os.path.join(out, "telemetry")
    assert report.fit_dirs(root) == [os.path.join(root, "fold_0")]
    assert report.main([root]) == 0
    text = capsys.readouterr().out
    for part in ("run: FS-Classification · dSGD · 2 sites", "-- phase time", "per-site rollup",
                 "epoch_compiles=0", "env: torch"):
        assert part in text, part
    assert report.main(["--validate", root]) == 0
    assert "validated 1 fit(s), 0 problem(s)" in capsys.readouterr().out
    assert [p.split(": ", 1)[1] for p in jreport.validate_fit(os.path.join(root, "fold_0"))] == [
        "manifest missing keys: ['jax_version', 'jaxlib_version']"]
    broken = tmp_path / "fold_0"
    broken.mkdir()
    (broken / sink.MANIFEST_FILE).write_text(json.dumps({"schema_version": 1}))
    (broken / sink.METRICS_FILE).write_text('{"kind": "epoch"}\n{"kind": "nope"}\n')
    assert report.main(["--validate", str(broken)]) == 1
    err = capsys.readouterr().err
    assert "manifest missing keys" in err and "unknown kind 'nope'" in err
    assert "no traceEvents" in err or "trace.chrome.json: unreadable" in err
    assert report.main([root, root]) == 0
    assert "per-tenant rollup" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        report.fit_dirs(str(tmp_path / "empty"))
    assert report.phase_table([{"ph": "X", "name": "a", "dur": 2e6},
                               {"ph": "X", "name": "a", "dur": 1e6}]) == \
        jreport.phase_table([{"ph": "X", "name": "a", "dur": 2e6},
                             {"ph": "X", "name": "a", "dur": 1e6}])


def test_profile_dir_traces_the_whole_fit_and_excludes_xprof(tmp_path):
    """``profile_dir`` writes one trace a fold; with ``xprof_dir`` too the
    trainer refuses (JAX's ValueError); an ``xprof_window`` fit traces its
    window, also when a resume starts inside it."""
    _fit(_cfg(epochs=1, telemetry="off", profile_dir=str(tmp_path / "prof")), None)
    assert len(xprof.trace_files(str(tmp_path / "prof" / "fold_0"))) == 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        _fit(_cfg(profile_dir="p", xprof_dir="x"), None)
    out = str(tmp_path / "out")
    with pytest.raises(Preempted):
        _fit(_cfg(xprof_dir=str(tmp_path / "xp"), xprof_window=(2, 3)), out,
             fault_plan=FaultPlan(kill_at_round=1))
    assert xprof.trace_files(str(tmp_path / "xp")) == []
    _fit(_cfg(xprof_dir=str(tmp_path / "xp"), xprof_window=(2, 3)), out,
         fault_plan=FaultPlan(kill_at_round=1), resume=True)
    assert len(xprof.trace_files(str(tmp_path / "xp" / "fold_0"))) == 1


def test_compile_cache_dir_moves_the_library_root(monkeypatch, tmp_path):
    """The trainer's and the serving engine's ``compile_cache_dir`` point
    the kernel libraries' root at the directory."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    _fit(_cfg(epochs=1, telemetry="off", compile_cache_dir=str(tmp_path / "kc")), None)
    assert _build.BUILD_ROOT == (tmp_path / "kc").resolve()
    m = MSANNet(in_size=D, hidden_sizes=(8,), out_size=2)
    params = {k: v.detach() for k, v in m.named_parameters()}
    with InferenceEngine(_cfg(compile_cache_dir=str(tmp_path / "kc2")), params=params,
                         batch_stats={}, device="cpu"):
        assert _build.BUILD_ROOT == (tmp_path / "kc2").resolve()


def test_serving_and_daemon_refusals_name_a12_b(tmp_path, capsys):
    """What ROADMAP A12 (b) refused now runs: a daemon with its own flight
    recorder, sink tags and telemetry on, and the CLI's ``--statusz-port``
    and ``--slo-p99-ms`` with ``--serve``. ``--schedule`` runs the fleet
    scheduler; with ``--statusz-port`` it serves the pod's endpoints (the
    pod collector over the scheduler's bus)."""
    tree = tdemo.make_fs_demo_tree(str(tmp_path / "tree"), **FS_TREE)
    bus = MetricsBus()
    flight = FlightRecorder(str(tmp_path / "flight"), bus=bus)
    d = trunner.FedDaemon(TrainConfig(telemetry="on"), capacity=2, data_path=tree,
                          out_dir=str(tmp_path / "d"), device="cpu", bus=bus, flight=flight,
                          sink_tags={"tenant": "a"}, verbose=False)
    assert d.flight is flight and d.serve(max_epochs=1)["epochs_run"] == 1
    assert "serve-epoch" in {e["name"] for e in flight.recent()}
    serve_dir = str(tmp_path / "d" / "telemetry" / "serve")
    assert report.validate_fit(serve_dir) == []
    with open(os.path.join(serve_dir, sink.MANIFEST_FILE)) as fh:
        assert json.load(fh)["tags"] == {"tenant": "a"}
    assert "epoch" in {e.get("name") for e in report._load_trace(serve_dir)}
    capsys.readouterr()
    assert tcli.main(["--data-path", tree, "--device", "cpu", "--serve", "--serve-epochs", "1",
                      "--out-dir", str(tmp_path / "c"), "--statusz-port", "0",
                      "--slo-p99-ms", "5"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[0]["statusz"].startswith("http://127.0.0.1:")
    assert lines[0]["endpoints"] == ["/metrics", "/healthz", "/statusz", "/tracez"]
    assert lines[-1]["epochs_run"] == 1
    assert tcli.main(["--data-path", str(tmp_path / "pod0"), "--device", "cpu", "--schedule",
                      "--statusz-port", "0", "--sched-ticks", "1", "--serve-poll", "0"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[0]["statusz"].startswith("http://127.0.0.1:")
    assert lines[-1]["tenants"] == {}
    assert tcli.main(["--data-path", str(tmp_path / "pod"), "--device", "cpu", "--schedule",
                      "--sched-ticks", "1", "--serve-poll", "0", "--quiet"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["tenants"] == {}


@pytest.fixture(scope="module")
def fs_tree(tmp_path_factory):
    return tdemo.make_fs_demo_tree(str(tmp_path_factory.mktemp("fs_tree")), **FS_TREE)


def test_runners_take_the_telemetry_options_and_the_sanitizer(fs_tree, tmp_path, monkeypatch):
    """``FedRunner`` and ``SiteRunner`` with telemetry on, a telemetry
    directory, an xprof window and a bus, under ``DINUNET_SANITIZE=1``:
    artifacts a fold, the bus fed, the fits clean under the guard."""
    monkeypatch.setenv(tsan.ENV_VAR, "1")
    bus = MetricsBus()
    res = trunner.FedRunner(TrainConfig(), fs_tree, str(tmp_path / "out"), device="cpu",
                            bus=bus, epochs=2, telemetry="on",
                            telemetry_dir=str(tmp_path / "tel"),
                            xprof_dir=str(tmp_path / "xp"), xprof_window=(2, 2)).run(
        folds=[0], verbose=False)
    assert res[0]["site_telemetry"]["rounds"] > 0
    assert report.validate_fit(str(tmp_path / "tel" / "fold_0")) == []
    assert len(xprof.trace_files(str(tmp_path / "xp"))) == 1
    assert bus.snapshot()["counters"]["train_epochs_total"] == 2
    sres = trunner.SiteRunner(task_id="FS-Classification", data_path=fs_tree,
                              out_dir=str(tmp_path / "site"), device="cpu", bus=bus, epochs=1,
                              telemetry="on", num_folds=None).run(verbose=False)
    assert sres[0]["site_telemetry"]["rounds"] > 0
    assert os.path.exists(tmp_path / "site" / "telemetry" / "fold_0" / sink.MANIFEST_FILE)


def test_runner_fold_fails_the_compile_guard_when_a_library_loads_late(fs_tree, tmp_path,
                                                                         monkeypatch):
    """A library loaded during the second epoch (a counter bumped there)
    fails the fold under ``--sanitize compile``: the CLI prints JAX's
    ``{"sanitizer_violation": ...}`` line and exits 70; an unknown flag
    exits naming ``--sanitize``."""
    run_epoch = tloop.FederatedTrainer.run_epoch

    def late_load(self, state, train_sites, epoch, **kw):
        if epoch == 2:
            monkeypatch.setattr(_build, "LOADS", _build.LOADS + 1)
        return run_epoch(self, state, train_sites, epoch, **kw)

    monkeypatch.setattr(tloop.FederatedTrainer, "run_epoch", late_load)
    monkeypatch.delenv(tsan.ENV_VAR, raising=False)
    base = ["--data-path", fs_tree, "--device", "cpu", "--epochs", "2", "--folds", "0",
            "--out-dir", str(tmp_path / "o"), "--quiet"]
    assert tcli.main(base + ["--sanitize", "compile"]) == 70
    with pytest.raises(SystemExit, match="--sanitize"):
        tcli.main(base + ["--sanitize", "bogus"])
    monkeypatch.setenv(tsan.ENV_VAR, "0")
    assert tcli.main(base + ["--sanitize", "leaks"]) == 0


def test_cli_runs_a_telemetry_fit_with_every_flag(fs_tree, tmp_path, monkeypatch, capsys):
    """``--telemetry on --xprof-dir --compile-cache --sanitize compile,nans``
    exits 0 with its JSON line, the artifacts and the window's trace; then
    ``--profile-dir`` traces the fit; the report validates the run."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv(tsan.ENV_VAR, raising=False)
    out = str(tmp_path / "o")
    rc = tcli.main(["--data-path", fs_tree, "--device", "cpu", "--epochs", "2", "--folds", "0",
                    "--out-dir", out, "--quiet", "--telemetry", "on",
                    "--xprof-dir", str(tmp_path / "xp"), "--set", "xprof_window=[1,2]",
                    "--compile-cache", str(tmp_path / "kc"), "--sanitize", "compile,nans"])
    assert rc == 0 and os.environ[tsan.ENV_VAR] == "compile,nans"
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["fold"] == 0 and "test_auc" in line
    assert _build.BUILD_ROOT == (tmp_path / "kc").resolve()
    assert len(xprof.trace_files(str(tmp_path / "xp"))) == 1
    assert report.main(["--validate", os.path.join(out, "telemetry")]) == 0
    monkeypatch.delenv(tsan.ENV_VAR, raising=False)
    assert tcli.main(["--data-path", fs_tree, "--device", "cpu", "--epochs", "1", "--folds",
                      "0", "--out-dir", out, "--quiet", "--profile-dir",
                      str(tmp_path / "prof")]) == 0
    assert len(xprof.trace_files(str(tmp_path / "prof"))) == 1
