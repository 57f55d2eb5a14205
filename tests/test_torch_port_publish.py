"""The port's publish plane on the CPU: the latency histogram, the SLO burn,
the delay autotuner, the checkpoint watcher and the params digest against
the JAX package's on the same inputs; the publish gauntlet against JAX's on
the FS task; hot-swaps (the shape refusal, two swaps bit for bit against a
fresh engine, nothing built after warmup)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.runner.registry import get_task as jget_task
from dinunet_implementations_tpu.serving import AutotunerDaemon as JaxAutotunerDaemon
from dinunet_implementations_tpu.serving import CheckpointWatcher as JaxWatcher
from dinunet_implementations_tpu.serving import DelayAutotuner as JaxAutotuner
from dinunet_implementations_tpu.serving import InferenceEngine as JaxEngine
from dinunet_implementations_tpu.serving import PublishController as JaxController
from dinunet_implementations_tpu.telemetry.bus import LabeledBusView as JaxLabeledBusView
from dinunet_implementations_tpu.telemetry.bus import MetricsBus as JaxBus
from dinunet_implementations_tpu.telemetry.exporter import slo_burn as jax_slo_burn
from dinunet_implementations_tpu.telemetry.hist import LogHistogram as JaxHist
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.ops import _build
from dinunet_implementations_tpu_torch.serving import (
    AutotunerDaemon,
    CheckpointWatcher,
    DelayAutotuner,
    InferenceEngine,
    PublishController,
    PublishDaemon,
    ServingError,
)
from dinunet_implementations_tpu_torch.telemetry import (
    NULL_BUS,
    HistogramShapeError,
    LabeledBusView,
    LogHistogram,
    MetricsBus,
    series_key,
    slo_burn,
)
from dinunet_implementations_tpu_torch.trainer import params_digest

FS = {"input_size": 6, "hidden_sizes": [8]}
ICA = dict(num_components=3, window_size=4, temporal_size=32, window_stride=4, input_size=8,
           hidden_size=6, bidirectional=False)
SHADOW_TOL = 1e-5


def _cfgs(task_id, args_key, args):
    j = jconfig.TrainConfig(task_id=task_id).with_overrides({args_key: args})
    t = tconfig.TrainConfig(task_id=task_id).with_overrides({args_key: args})
    return j, t


def _jax_init(jcfg, sample):
    task = jsteps.FederatedTask(jget_task(jcfg.task_id).build_model(jcfg))
    params, stats = task.init_variables(jax.random.PRNGKey(0), sample)
    return task, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


@pytest.fixture(scope="module")
def fs_env():
    jcfg, tcfg = _cfgs(jconfig.NNComputation.TASK_FREE_SURFER, "fs_args", FS)
    task, params, stats = _jax_init(jcfg, jnp.ones((4, 6)))
    return jcfg, tcfg, task, params, stats


@pytest.fixture(scope="module")
def ica_env():
    jcfg, tcfg = _cfgs(jconfig.NNComputation.TASK_ICA, "ica_args", ICA)
    _, params, stats = _jax_init(jcfg, jnp.ones((2, 8, 3, 4)))
    return tcfg, params, stats


def _shift(tree, by):
    return jax.tree.map(lambda a: (np.asarray(a) + by).astype(np.asarray(a).dtype), tree)


# -- histograms and the SLO burn ----------------------------------------------


SAMPLES = np.random.default_rng(0).lognormal(1.0, 1.5, 400).tolist() + [0.0, 1e-4, 2e6, 50.0]


def _pair(values):
    ours, theirs = LogHistogram(), JaxHist()
    for v in values:
        ours.record(v)
        theirs.record(v)
    return ours, theirs


def test_histogram_estimates_equal_jaxs():
    ours, theirs = _pair(SAMPLES)
    assert ours.counts == theirs.counts and ours.bounds == theirs.bounds
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == theirs.quantile(q), q
    assert ours.percentiles() == theirs.percentiles()
    for t in (0.5, 2.7, 10.0, 50.0, 1e3, 1e6):
        assert ours.over(t) == theirs.over(t), t
    assert ours.to_dict() == theirs.to_dict()
    assert LogHistogram.from_dict(ours.to_dict()).counts == ours.counts


def test_histogram_delta_and_merge_equal_jaxs():
    ours, theirs = _pair(SAMPLES[:200])
    snaps = ours.copy(), theirs.copy()
    for v in SAMPLES[200:]:
        ours.record(v)
        theirs.record(v)
    d_ours, d_theirs = ours.delta(snaps[0]), theirs.delta(snaps[1])
    assert d_ours.to_dict() == d_theirs.to_dict()
    merged = snaps[0].copy().merge(d_ours)
    assert merged.counts == ours.counts and merged.count == ours.count
    assert snaps[0].copy().merge(d_ours).to_dict() == snaps[1].copy().merge(d_theirs).to_dict()
    with pytest.raises(HistogramShapeError, match="backwards"):
        snaps[0].delta(ours)
    with pytest.raises(HistogramShapeError):
        ours.merge(LogHistogram(per_decade=5))


@pytest.mark.parametrize("target,budget", [(10.0, 0.01), (3.0, 0.05), (1e4, 0.01)])
def test_slo_burn_equals_jaxs(target, budget):
    ours, theirs = _pair(SAMPLES)
    assert slo_burn(ours, target, budget) == jax_slo_burn(theirs, target, budget)
    assert slo_burn(None, target) == jax_slo_burn(None, target)


def test_bus_series_and_labeled_views_equal_jaxs():
    snaps = []
    for bus_cls, view_cls in ((MetricsBus, LabeledBusView), (JaxBus, JaxLabeledBusView)):
        bus = bus_cls()
        view = view_cls(bus, tenant="a", replica="1")
        for v in SAMPLES[:50]:
            view.observe("serving_request_latency_ms", v, lane="infer")
        bus.observe("serving_request_latency_ms", 3.0, lane='stream"\\n')
        view.counter("serving_requests_total", 2, lane="infer", tenant="spoofed")
        view.gauge("serving_queue_depth", 5, lane="infer")
        bus.gauge("serving_replicas_live", 2)
        view.clear_gauge("serving_queue_depth", lane="infer")
        snaps.append((bus.snapshot(), view.histogram("serving_request_latency_ms",
                                                     lane="infer").to_dict(),
                      bus.merged_histogram("serving_request_latency_ms").to_dict()))
    assert snaps[0] == snaps[1]
    assert 'tenant="a"' in next(iter(snaps[0][0]["counters"]))  # the view's label wins
    assert series_key("x", {"b": 1, "a": 'q"'}) == 'x{a="q\\"",b="1"}'
    assert NULL_BUS.histogram("anything") is None
    NULL_BUS.observe("anything", 1.0)
    assert NULL_BUS.snapshot()["histograms"] == {}


# -- the autotuner -------------------------------------------------------------


class _Lane:
    def __init__(self, delay_ms=2.0):
        self.max_delay_s = delay_ms / 1e3
        self.name = "infer"
        self.labels = {}


WINDOWS = [[1.0] * 90 + [100.0] * 10, [10.0] * 100, [1.0] * 100, [80.0] * 100, None,
           [100.0] * 5, [0.5] * 50, [0.5] * 50, [200.0] * 60, [200.0] * 60, [200.0] * 60]


@pytest.mark.parametrize("kw", [dict(p99_target_ms=10.0), dict(p99_target_ms=100.0, headroom=0.5),
                                dict(p99_target_ms=10.0, min_samples=50, min_delay_ms=0.5,
                                     max_delay_ms=3.0)])
def test_autotuner_makes_jaxs_decisions(kw):
    runs = []
    for tuner_cls, hist_cls in ((DelayAutotuner, LogHistogram), (JaxAutotuner, JaxHist)):
        lane = _Lane()
        tuner = tuner_cls(lane, **{"min_samples": 10, **kw})
        seq = []
        for values in WINDOWS:
            h = None
            if values is not None:
                h = hist_cls()
                for v in values:
                    h.record(v)
            seq.append((tuner.step(h), lane.max_delay_s))
        runs.append((seq, tuner.decisions))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        DelayAutotuner(_Lane(), p99_target_ms=1.0, headroom=1.5)


def test_autotuner_daemon_steps_on_window_deltas_like_jax():
    runs = []
    for bus_cls, tuner_cls, daemon_cls in ((MetricsBus, DelayAutotuner, AutotunerDaemon),
                                           (JaxBus, JaxAutotuner, JaxAutotunerDaemon)):
        bus, lane = bus_cls(), _Lane()
        tuner = tuner_cls(lane, p99_target_ms=10.0, min_samples=10, bus=bus)
        daemon = daemon_cls(bus, [tuner], interval_s=60.0)
        seq = []
        for value in (1.0, 100.0, 100.0, 1.0, 1.0):
            for _ in range(20):
                bus.observe("serving_request_latency_ms", value, lane="infer")
            daemon.tick()
            seq.append((dict(tuner.decisions), lane.max_delay_s))
        daemon.stop()
        runs.append(seq)
    assert runs[0] == runs[1]


# -- the watcher and the digest ---------------------------------------------------


def test_checkpoint_watcher_sees_jaxs_file_sequence(tmp_path):
    path = str(tmp_path / "publish.json")
    ours, theirs = CheckpointWatcher(path), JaxWatcher(path)
    seen = []

    def write(text):
        with open(path + ".tmp", "w") as f:
            f.write(text)
        os.replace(path + ".tmp", path)

    steps = [None, json.dumps({"path": "a", "digest": "aaa", "epoch": 1}), "same",
             json.dumps({"path": "a", "digest": "aaa", "epoch": 2}),
             json.dumps({"path": "b", "digest": "bbb", "epoch": 3}), "{not json",
             json.dumps({"path": "c", "epoch": 4}),
             json.dumps({"path": "b", "digest": "ccc", "epoch": 5})]
    for step in steps:
        if step not in (None, "same"):
            write(step)
        got, want = ours.poll(), theirs.poll()
        assert got == want, step
        seen.append(got and got["digest"])
    assert seen == [None, "aaa", None, None, "bbb", None, None, "ccc"]


def test_params_digest_equals_jaxs_and_follows_values_and_shapes(fs_env, ica_env):
    _, tcfg, _, params, stats = fs_env
    for p, s in ((params, stats), ica_env[1:]):
        assert params_digest(p, s) == jckpt.params_digest(p, s)
    d = params_digest(params, stats)
    assert params_digest(_shift(params, 1e-6), stats) != d
    reshaped = jax.tree.map(lambda a: np.asarray(a).reshape(-1), params)
    assert params_digest(reshaped, stats) != d
    # an engine's live tensors hash to the same string as the JAX trees
    with InferenceEngine(tcfg, params=params, batch_stats=stats, device="cpu",
                         row_buckets=(2,)) as eng:
        assert params_digest(*eng.weights()) == d


# -- the gauntlet against JAX's -------------------------------------------------------


def _gauntlet(engine_cls, controller_cls, bus_cls, cfg, params, stats):
    """JAX's publish gauntlet (stale digest, non-finite shadow, a healthy
    probation, an induced SLO burn that rolls back) on one engine class.
    Returns the rows with their times left out, and the engine's answers on
    one probe before any publish, after the first swap and after the
    rollback."""
    bus = bus_cls()
    rng = np.random.default_rng(0)
    probe = rng.normal(size=(2, 6)).astype(np.float32)
    kw = {"device": "cpu"} if engine_cls is InferenceEngine else {}
    rows, answers = [], []
    with engine_cls(cfg, params=params, batch_stats=stats, row_buckets=(2, 4), streaming=False,
                    max_delay_ms=1.0, bus=bus, **kw) as eng:
        eng.warmup()
        for _ in range(8):
            eng.submit(rng.normal(size=(2, 6)).astype(np.float32)).result()
        answers.append(np.asarray(eng.submit(probe).result()))
        pc = controller_cls(eng, bus=bus, p99_target_ms=50.0, rollback_burn=1.0,
                            min_window_samples=5)
        cand = _shift(params, 0.01)
        rows.append(pc.publish(cand, stats, digest="d1"))
        answers.append(np.asarray(eng.submit(probe).result()))
        rows.append(pc.publish(cand, stats, digest="d1"))
        rows.append(pc.publish(jax.tree.map(lambda a: np.full_like(a, np.nan), params), stats,
                               digest="d2"))
        rows.append(pc.check_rollback())
        for _ in range(6):
            eng.submit(rng.normal(size=(2, 6)).astype(np.float32)).result()
        rows.append(pc.check_rollback())
        rows.append(pc.check_rollback())
        rows.append(pc.publish(_shift(params, 0.02), stats, digest="d3"))
        for _ in range(30):
            bus.observe("serving_request_latency_ms", 500.0, lane="infer")
        rows.append(pc.check_rollback())
        answers.append(np.asarray(eng.submit(probe).result()))
        rows.append({"live_digest": pc.live_digest, "history": len(pc.history)})
    clean = []
    for row in rows:
        if row is not None:
            row = {k: v for k, v in row.items() if k not in ("pause_ms", "window_samples")}
            if row.get("shadow"):
                row["shadow"] = dict(row["shadow"])
        clean.append(row)
    return clean, answers


def test_publish_gauntlet_matches_jax_on_fs(fs_env):
    jcfg, tcfg, _, params, stats = fs_env
    got, got_answers = _gauntlet(InferenceEngine, PublishController, MetricsBus, tcfg, params,
                                 stats)
    want, _ = _gauntlet(JaxEngine, JaxController, JaxBus, jcfg, params, stats)
    for g, w in zip(got, want):
        if g and g.get("shadow") and w.get("shadow"):
            assert abs(g["shadow"].pop("max_abs_delta") - w["shadow"].pop("max_abs_delta")) \
                <= SHADOW_TOL
    assert got == want
    outcomes = [r and (r.get("outcome") or r.get("rolled_back")) for r in got[:-1]]
    assert outcomes == ["swapped", "rejected-stale", "rejected-shadow", None, False, None,
                        "swapped", True]
    assert got[-1] == {"live_digest": "d1", "history": 6}
    # the rollback put back the weights the first swap installed, bit for bit
    np.testing.assert_array_equal(got_answers[2], got_answers[1])
    assert not np.array_equal(got_answers[1], got_answers[0])


def test_publish_daemon_swaps_a_checkpoint_announced_with_jaxs_digest(fs_env, tmp_path):
    jcfg, tcfg, task, params, stats = fs_env
    state = jsteps.init_train_state(task, make_engine("dSGD"), jsteps.make_optimizer("adam", 1e-3),
                                    jax.random.PRNGKey(5), jnp.ones((4, 6)), num_sites=3)
    ckpt = str(tmp_path / "serve.msgpack")
    jckpt.save_checkpoint(ckpt, state)
    digest = jckpt.params_digest(state.params, state.batch_stats)
    ann = str(tmp_path / "publish.json")
    with open(ann, "w") as f:
        json.dump({"path": ckpt, "digest": digest, "epoch": 1}, f)
    bus = MetricsBus()
    with InferenceEngine(tcfg, params=params, batch_stats=stats, device="cpu",
                         row_buckets=(2,), bus=bus) as eng:
        eng.warmup()
        pc = PublishController(eng, bus=bus)
        daemon = PublishDaemon(CheckpointWatcher(ann), pc, interval_s=60.0)
        row = daemon.tick()
        assert row["outcome"] == "swapped" and pc.live_digest == digest
        assert params_digest(*eng.weights()) == digest
        assert daemon.tick() is None
        # the same weights announced again: stale by the port's own digest
        assert pc.publish(*eng.weights(), digest=params_digest(*eng.weights()))["outcome"] \
            == "rejected-stale"
    with pytest.raises(NotImplementedError, match="A12"):
        PublishController(eng, bus=bus, sink=[])
    with pytest.raises(ServingError):
        PublishController(eng, bus=bus, rollback_burn=0.0)


# -- hot-swaps --------------------------------------------------------------------------


def test_swap_refuses_shape_and_dtype_drift(ica_env):
    tcfg, params, stats = ica_env
    x = np.random.default_rng(1).normal(size=(1, 8, 3, 4)).astype(np.float32)
    with InferenceEngine(tcfg, params=params, batch_stats=stats, device="cpu",
                         row_buckets=(1,), streaming=False) as eng:
        eng.warmup()
        before = eng.submit(x).result()
        bad = jax.tree.map(lambda a: np.zeros(np.asarray(a).shape + (1,), np.float32), params)
        with pytest.raises(ServingError, match="hot-swap refused.*leaf"):
            eng.swap_params(bad, stats)
        wide = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        with pytest.raises(ServingError, match="float64"):
            eng.swap_params(wide, stats)
        short = {k: v for k, v in params.items() if k != "cls_fc3"}
        with pytest.raises(ServingError, match="tree structure"):
            eng.swap_params(short, stats)
        with pytest.raises(ServingError, match="shadow-score refused"):
            eng.shadow_score(bad, stats)
        np.testing.assert_array_equal(eng.submit(x).result(), before)  # never moved
        assert eng.stats["swaps"] == 0


def test_two_hot_swaps_are_bitwise_a_fresh_engine_and_build_nothing(ica_env, monkeypatch):
    tcfg, params, stats = ica_env
    rng = np.random.default_rng(4)
    probes = {rows: rng.normal(size=(rows, 8, 3, 4)).astype(np.float32) for rows in (1, 2, 4)}
    seq = rng.normal(size=(6, 3, 4)).astype(np.float32)
    kw = dict(device="cpu", row_buckets=(1, 2, 4), stream_buckets=(1,), stream_chunk=4,
              stream_slots=2, max_delay_ms=1.0)

    def answers(eng, tag):
        return ({rows: eng.submit(x).result() for rows, x in probes.items()},
                eng.stream(tag, seq).result()["probs"])

    bus = MetricsBus()
    with InferenceEngine(tcfg, params=params, batch_stats=stats, bus=bus, **kw) as eng:
        eng.warmup()
        for i, cand in enumerate((_shift(params, 0.01), _shift(params, -0.02))):
            got_pause = eng.swap_params(cand, stats)
            assert got_pause["pause_ms"] >= 0
            got = answers(eng, f"after-{i}")
            with InferenceEngine(tcfg, params=cand, batch_stats=stats, **kw) as fresh:
                fresh.warmup()
                want = answers(fresh, "fresh")
            for rows in probes:
                np.testing.assert_array_equal(got[0][rows], want[0][rows])
            np.testing.assert_array_equal(got[1], want[1])
        assert eng.compiles_after_warmup() == {"kernel_builds": 0, "kernel_loads": 0}
        assert eng.status()["swaps"] == 2
        snap = bus.snapshot()
        assert snap["counters"]["serving_swaps_total"] == 2
        assert snap["histograms"]["serving_swap_pause_ms"]["count"] == 2
        # a kernel library loaded after warmup is what the check exists for
        monkeypatch.setattr(_build, "LOADS", _build.LOADS + 1)
        with pytest.raises(ServingError, match="after warmup"):
            eng.assert_no_compiles()
        monkeypatch.setattr(_build, "LOADS", _build.LOADS - 1)


def test_shadow_score_replays_the_mirror_ring(ica_env):
    tcfg, params, stats = ica_env
    rng = np.random.default_rng(6)
    with InferenceEngine(tcfg, params=params, batch_stats=stats, device="cpu",
                         row_buckets=(2, 4), streaming=False) as eng:
        eng.warmup()
        assert eng.shadow_score(params, stats) == {"batches": 1, "rows": 2, "finite": True,
                                                   "max_abs_delta": 0.0}
        for n in (1, 2, 3, 4, 2, 1):
            eng.submit(rng.normal(size=(n, 8, 3, 4)).astype(np.float32)).result()
        got = eng.shadow_score(_shift(params, 0.05), stats)
        assert got["batches"] == 4 and got["rows"] == 3 + 4 + 2 + 1 and got["finite"]
        assert got["max_abs_delta"] > 0
        # the candidate never became live
        assert eng.shadow_score(*eng.weights())["max_abs_delta"] == 0.0
