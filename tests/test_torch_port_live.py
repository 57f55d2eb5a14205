"""The port's live plane on the CPU, against the JAX package's: the
Prometheus text of one bus snapshot byte for byte, the four endpoints of
``StatusExporter`` over real HTTP on 127.0.0.1 (the payloads equal to
JAX's from the same bus, tracer and probes but for the time fields), the
flight recorder (tests/test_observability.py's ring, dump, exception-hook
and never-raise checks, and a chained signal), the serving objects' tracer
spans and sink rows (the same kinds, keys and counts as JAX's engine, fleet
and publish controller over the same requests and weights), the daemon's
bus (a DP daemon's trainer gauges reach it, as JAX's), and the daemon's
live surface: tests/test_observability.py's journey of a join's trace id
through ``status()``, the bus, the checkpoint meta, a serving engine and
its dispatch row, held against the JAX daemon on the same tree.

The models are the FS MSANNet at input 8 and hidden (8,) (the daemon tests'
tree) and its JAX twin.
"""

import json
import os
import re
import signal
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dinunet_implementations_tpu import TrainConfig as JTrainConfig
from dinunet_implementations_tpu.core.config import FSArgs as JFSArgs
from dinunet_implementations_tpu.runner.fed_runner import FedDaemon as JFedDaemon
from dinunet_implementations_tpu.runner.registry import get_task as jget_task
from dinunet_implementations_tpu.serving import InferenceEngine as JEngine
from dinunet_implementations_tpu.serving import PublishController as JPublish
from dinunet_implementations_tpu.serving import ReplicaSet as JReplicaSet
from dinunet_implementations_tpu.telemetry import bus as jbus
from dinunet_implementations_tpu.telemetry import exporter as jexporter
from dinunet_implementations_tpu.telemetry import flight as jflight
from dinunet_implementations_tpu.telemetry import tracer as jtracer
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import FSArgs, TrainConfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.serving import InferenceEngine, PublishController, ReplicaSet
from dinunet_implementations_tpu_torch.telemetry import (
    FlightRecorder,
    MetricsBus,
    SpanTracer,
    StatusExporter,
    exporter,
    flight_files,
    global_bus,
    new_trace_id,
    render_prometheus,
    series_key,
)
from dinunet_implementations_tpu_torch.telemetry import sink as tsink
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt

TASK = "FS-Classification"
ENDPOINT_PATHS = ["/metrics", "/healthz", "/statusz", "/tracez", "/nope", "/"]
# the payload fields that read a clock: equal only up to when each was taken
TIME_FIELDS = {"uptime_s"}


def _bus_ops(bus):
    """The same counters, gauges and histograms on a bus of either package:
    labels that need escaping, non-finite gauges, an overflow sample."""
    bus.counter("serving_requests_total", 5, lane="infer")
    bus.counter("serving_requests_total", 2, lane="stream", replica="1")
    bus.gauge("serve_epoch", 12)
    bus.gauge("weird name-with.chars", 1.5)
    bus.gauge("train_loss", float("nan"))
    bus.gauge("train_epsilon", float("inf"))
    bus.gauge("serve_member_generation", 3, site='we"ird\\site')
    for v in (0.5, 3.0, 3.0, 2e6, 9000.0):
        bus.observe("serve_epoch_ms", v)
        bus.observe("serving_request_latency_ms", v / 10, lane="infer", replica="0")
    return bus


def test_prometheus_text_of_one_snapshot_is_jax_s_byte_for_byte():
    """One snapshot through both renderers, and each package's bus fed the
    same series: one text, byte for byte, whose histogram series are
    cumulative and end at ``_count``."""
    snap = _bus_ops(jbus.MetricsBus()).snapshot()
    text = render_prometheus(snap)
    assert text == jexporter.render_prometheus(snap)
    assert render_prometheus(_bus_ops(MetricsBus()).snapshot()) == text
    assert 'dinunet_serving_requests_total{lane="infer"} 5' in text
    assert "dinunet_weird_name_with_chars 1.5" in text and "dinunet_train_loss NaN" in text
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
              if ln.startswith("dinunet_serve_epoch_ms_bucket")]
    assert counts == sorted(counts) and counts[-1] == 5
    assert "dinunet_serve_epoch_ms_count 5" in text
    assert render_prometheus({}) == jexporter.render_prometheus({}) == "\n"


def test_slo_burn_is_jax_s():
    h = _bus_ops(MetricsBus()).merged_histogram("serve_epoch_ms")
    jh = _bus_ops(jbus.MetricsBus()).merged_histogram("serve_epoch_ms")
    for target in (1.0, 100.0, 5000.0):
        assert exporter.slo_burn(h, target) == jexporter.slo_burn(jh, target)
    assert exporter.slo_burn(None, 5.0) == jexporter.slo_burn(None, 5.0)


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _payload(ctype: str, body: str):
    if not ctype.startswith("application/json"):
        return body
    return {k: v for k, v in json.loads(body).items() if k not in TIME_FIELDS}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's exporter and JAX's over one bus, tracer, flight ring and
    set of probes (one of them broken), both on 127.0.0.1:0."""
    bus = _bus_ops(MetricsBus())
    tracer = SpanTracer()
    flight = FlightRecorder(str(tmp_path_factory.mktemp("flight")), bus=bus, tracer=tracer)
    with tracer.span("epoch", epoch=3):
        tracer.event("checkpoint-publish", epoch=3)
    flight.note("round-hold", occupied=0)
    kw = dict(port=0, tracer=tracer, flight=flight,
              health={"state": lambda: True, "broken": lambda: 1 / 0},
              statusz=lambda: {"round": 3, "members": {"a": {"slot": 0}}},
              slo={"histogram": "serve_epoch_ms", "p99_target_ms": 100.0})
    ours, theirs = StatusExporter(bus, **kw), jexporter.StatusExporter(bus, **kw)
    with ours, theirs:
        yield ours, theirs


@pytest.mark.parametrize("path", ENDPOINT_PATHS)
def test_endpoints_over_http_match_jax(served, path):
    """Each endpoint (and an unknown path, and the bare root) over HTTP:
    JAX's status code, content type and payload but for the time fields."""
    ours, theirs = served
    assert ours.port > 0 and ours.url("/x") == f"http://127.0.0.1:{ours.port}/x"
    code, ctype, body = _get(ours.url(path))
    jcode, jctype, jbody = _get(theirs.url(path))
    assert (code, ctype) == (jcode, jctype)
    assert _payload(ctype, body) == _payload(jctype, jbody)
    want = {"/healthz": 503, "/nope": 404}.get(path, 200)
    assert code == want
    if path == "/healthz":
        sub = json.loads(body)["subsystems"]
        assert sub["state"] == {"ready": True} and "division" in sub["broken"]["error"]
    if path == "/statusz":
        p = json.loads(body)
        assert p["slo"]["samples"] == 5 and p["slo"]["violations"] == 2
        assert p["status"]["round"] == 3 and p["metrics"]["gauges"]["serve_epoch"] == 12
        # strict JSON: the non-finite gauges are null
        assert p["metrics"]["gauges"]["train_loss"] is None
    if path == "/tracez":
        names = [e["name"] for e in json.loads(body)["recent"]]
        assert names == ["checkpoint-publish", "epoch", "round-hold"]


def test_healthz_all_ready_and_a_stopped_exporter(served):
    bus = MetricsBus()
    for cls in (StatusExporter, jexporter.StatusExporter):
        ex = cls(bus, health={"a": lambda: True})
        assert ex.healthz() == (200, {"status": "ok", "subsystems": {"a": {"ready": True}}})
        assert ex.slo_status() is None
        assert ex.tracez_payload() == {"recent": [], "count": 0}
        port = ex.start()
        assert ex.start() == port and _get(ex.url("/healthz"))[0] == 200
        ex.stop()
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(ex.url(), timeout=1)
    # /tracez falls back to the tracer's tail without a flight recorder
    tracer = SpanTracer()
    with tracer.span("serve-infer"):
        pass
    got = StatusExporter(bus, tracer=tracer, tracez_limit=1).tracez_payload()
    assert got == jexporter.StatusExporter(bus, tracer=tracer, tracez_limit=1).tracez_payload()
    assert [e["name"] for e in got["recent"]] == ["serve-infer"]


# -- the flight recorder -------------------------------------------------------


def test_flight_ring_bounded_and_dump_keys_are_jax_s(tmp_path):
    bus = MetricsBus()
    bus.gauge("serve_epoch", 9)
    bus.gauge("train_loss", float("nan"))
    tracer = SpanTracer()
    flight = FlightRecorder(str(tmp_path / "ours"), capacity=8, bus=bus, tracer=tracer)
    jfl = jflight.FlightRecorder(str(tmp_path / "theirs"), capacity=8, bus=bus, tracer=tracer)
    for i in range(50):
        with tracer.span("epoch", epoch=i):
            pass
    assert len(flight.recent(100)) == 8 and flight.recent(100)[-1]["epoch"] == 49
    assert flight.recent(100) == jfl.recent(100) and len(flight.recent(3)) == 3
    for f in (flight, jfl):
        f.note("round-hold", occupied=0)
    paths = [flight.dump("signal:15"), jfl.dump("signal:15")]
    payloads = []
    for path in paths:
        with open(path) as fh:
            payloads.append(json.load(fh))
    ours, theirs = payloads
    assert os.path.basename(paths[0]) == os.path.basename(paths[1]) == f"flight_{os.getpid()}.json"
    assert set(ours) == set(theirs) and ours["reason"] == "signal:15"
    assert ours["pid"] == os.getpid() and ours["bus"] == theirs["bus"]
    assert ours["bus"]["gauges"]["serve_epoch"] == 9 and ours["bus"]["gauges"]["train_loss"] is None
    assert [e["name"] for e in ours["events"]] == [e["name"] for e in theirs["events"]]
    assert ours["events"][-1]["name"] == "round-hold" and ours["events"][-1]["src"] == "flight"
    # a second dump keeps the first (a crash during shutdown)
    path2 = flight.dump("crash:RuntimeError")
    assert path2.endswith(f"flight_{os.getpid()}_2.json") and os.path.exists(paths[0])
    assert flight_files(str(tmp_path / "ours")) == sorted([paths[0], path2]) == flight.dumps
    assert flight_files(str(tmp_path / "missing")) == []


def test_flight_excepthook_chains_and_dumps(tmp_path):
    flight = FlightRecorder(str(tmp_path))
    prev_hook = sys.excepthook
    seen = []
    sys.excepthook = lambda *a: seen.append(a)
    try:
        flight.install(signals=())
        assert sys.excepthook is not prev_hook
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        dumps = flight_files(str(tmp_path))
        assert len(dumps) == 1
        with open(dumps[0]) as fh:
            payload = json.load(fh)
        assert payload["reason"] == "crash:RuntimeError" and payload["bus"] is None
        assert any(e["name"] == "unhandled-exception" for e in payload["events"])
        assert seen  # the previous hook still ran
        flight.uninstall()
        assert len(seen) == 1 and sys.excepthook is not prev_hook  # put back: the recorder
    finally:
        sys.excepthook = prev_hook


def test_flight_signal_handler_chains_to_the_previous_one(tmp_path):
    """``install(signals=(SIGUSR1,))``: the signal dumps, then the handler
    installed before runs; ``uninstall`` puts that handler back."""
    got = []
    prev = signal.signal(signal.SIGUSR1, lambda signum, frame: got.append(signum))
    try:
        flight = FlightRecorder(str(tmp_path))
        flight.install(signals=(signal.SIGUSR1,))
        flight.install(signals=(signal.SIGUSR1,))  # once only
        os.kill(os.getpid(), signal.SIGUSR1)
        assert got == [signal.SIGUSR1]
        with open(flight_files(str(tmp_path))[0]) as fh:
            payload = json.load(fh)
        assert payload["reason"] == f"signal:{int(signal.SIGUSR1)}"
        assert payload["events"][-1]["name"] == "signal"
        flight.uninstall()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert got == [signal.SIGUSR1] * 2 and len(flight_files(str(tmp_path))) == 1
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_flight_dump_never_raises(tmp_path):
    flight = FlightRecorder(os.path.join(str(tmp_path), "f"))
    flight.record({"name": "x", "bad": object()})  # not JSON: written by str
    assert flight.dump("crash") is not None
    broken = FlightRecorder("/proc/definitely-unwritable/x")
    assert broken.dump("crash") is None
    # a disabled tracer is not listened to (it never records anyway)
    from dinunet_implementations_tpu_torch.telemetry import NULL_TRACER

    FlightRecorder(str(tmp_path), tracer=NULL_TRACER)
    assert not NULL_TRACER._listeners


# -- the serving objects' spans and rows ---------------------------------------------


class _Rows(list):
    """A sink that keeps its rows and counts its closes."""

    closes = 0

    def close(self):
        self.closes += 1


def _fs_cfgs():
    return (JTrainConfig(task_id=TASK, fs_args=JFSArgs(input_size=8, hidden_sizes=(8,))),
            TrainConfig(task_id=TASK, fs_args=FSArgs(input_size=8, hidden_sizes=(8,))))


@pytest.fixture(scope="module")
def fs_weights():
    jcfg, _ = _fs_cfgs()
    task = jsteps.FederatedTask(jget_task(TASK).build_model(jcfg))
    params, stats = task.init_variables(jax.random.PRNGKey(3), jnp.ones((2, 8)))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


REQUESTS = [(1, "t-a"), (3, "t-b"), (2, None), (4, "t-d")]


def _drive(target, rows_of, trace_ids: list):
    """The REQUESTS one at a time (one dispatch each); the answers."""
    out = []
    for i, (n, tid) in enumerate(REQUESTS):
        fut = target.submit(rows_of(i, n), trace_id=tid)
        trace_ids.append(fut.trace_id)
        out.append(np.asarray(fut.result(timeout=60)))
    return out


def _rows_in(rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    return lambda i, n: rng.standard_normal((n, 8)).astype(np.float32)


# the keys the port's serving summaries add to JAX's (the device, and the
# pad rows beside their share)
PORT_ONLY = {"device", "pad_rows"}


def _shape(rows):
    """Kind and keys of each row, with its counts."""
    return [(r["kind"], tuple(sorted(set(r) - PORT_ONLY))) for r in rows]


@pytest.mark.parametrize("fleet", [False, True], ids=["engine", "fleet"])
def test_serving_spans_and_rows_match_jax(fs_weights, fleet):
    """The same requests through the port's engine (or a fleet of 2) and
    JAX's, each with a tracer and a sink: the answers, the rows' kinds,
    keys and counts, each dispatch row's trace ids, and a ``serve-infer``
    span a dispatch carrying them; the sink closed once."""
    params, stats = fs_weights
    jcfg, tcfg = _fs_cfgs()
    kw = dict(params=params, batch_stats=stats, row_buckets=(1, 4), max_delay_ms=1.0)
    results = []
    for ours in (True, False):
        tracer = SpanTracer() if ours else jtracer.SpanTracer()
        rows, ids = _Rows(), []
        if fleet:
            cls = ReplicaSet if ours else JReplicaSet
            extra = {"devices": ["cpu"]} if ours else {}
            target = cls(tcfg if ours else jcfg, replicas=2, tracer=tracer, sink=rows,
                         **kw, **extra)
        else:
            cls = InferenceEngine if ours else JEngine
            extra = {"device": "cpu"} if ours else {}
            target = cls(tcfg if ours else jcfg, tracer=tracer, sink=rows, **kw, **extra)
        target.warmup()
        answers = _drive(target, _rows_in(7), ids)
        target.close()
        results.append((answers, rows, ids, tracer.events()))
    (ours, rows, ids, events), (theirs, jrows, jids, jevents) = results
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert _shape(rows) == _shape(jrows)
    assert rows.closes == jrows.closes == 1
    assert ids[:2] == jids[:2] == ["t-a", "t-b"]
    assert all(re.fullmatch(r"[0-9a-f]{16}", t) for t in (ids[2], jids[2]))
    dispatch = [r for r in rows if r["kind"] == "dispatch"]
    assert [r["trace_ids"] for r in dispatch] == [[t] for t in ids]
    assert [r["rows"] for r in dispatch] == [n for n, _ in REQUESTS]
    assert [r["pad_rows"] for r in dispatch] == [r["pad_rows"] for r in jrows
                                                 if r["kind"] == "dispatch"]
    for evs in (events, jevents):
        infer = [e for e in evs if e["name"] == "serve-infer"]
        assert [e["trace_ids"] for e in infer] == [[t] for t in (ids if evs is events else jids)]
        assert {e["name"] for e in evs} >= {"serve-warmup", "serve-infer"}
    if fleet:
        starts = [r for r in rows if r["kind"] == "event"]
        assert [r["name"] for r in starts] == ["replica-start"] * 2
        assert {r.get("replica") for r in dispatch} <= {"0", "1"}


def test_publish_rows_match_jax(fs_weights, tmp_path):
    """A candidate published and its probation judged through the port's
    controller and JAX's, each with a sink: the same publish and rollback
    rows (kinds, keys, outcomes), as in their histories."""
    params, stats = fs_weights
    jcfg, tcfg = _fs_cfgs()
    cand = jax.tree.map(lambda a: a * 1.5, params)
    digest = jckpt.params_digest(cand, stats)
    assert tckpt.params_digest(cand, stats) == digest
    shapes = []
    for ours in (True, False):
        bus = MetricsBus() if ours else jbus.MetricsBus()
        rows = []
        cls = InferenceEngine if ours else JEngine
        extra = {"device": "cpu"} if ours else {}
        with cls(tcfg if ours else jcfg, params=params, batch_stats=stats, row_buckets=(2,),
                 bus=bus, **extra) as eng:
            eng.warmup()
            pc = (PublishController if ours else JPublish)(
                eng, bus=bus, sink=rows, p99_target_ms=60_000.0, min_window_samples=2)
            assert pc.publish(cand, stats, digest=digest)["outcome"] == "swapped"
            assert pc.publish(cand, stats, digest=digest)["outcome"] == "rejected-stale"
            for i in range(3):
                eng.submit(np.full((2, 8), i, np.float32)).result(timeout=60)
            assert pc.check_rollback()["rolled_back"] is False
            assert rows == pc.history
        shapes.append([(r["kind"], r.get("outcome"), tuple(sorted(r))) for r in rows])
    assert shapes[0] == shapes[1]
    assert [k for k, _, _ in shapes[0]] == ["publish", "publish", "rollback"]


def test_a_request_s_latency_is_on_the_bus_when_its_answer_is(fs_weights):
    """A caller that waits for its answer finds the request's latency on the
    bus already, so a rollback check right after a drain counts every
    request of its window: the engine records the latency before it
    resolves the future. A bus whose ``observe`` is slow shows the order
    (resolved first, the count would lag by one)."""
    params, stats = fs_weights
    _, tcfg = _fs_cfgs()

    class SlowBus(MetricsBus):
        def observe(self, name, value, **kw):
            time.sleep(0.2)
            super().observe(name, value, **kw)

    bus = SlowBus()
    with InferenceEngine(tcfg, params=params, batch_stats=stats, row_buckets=(2,), bus=bus,
                         device="cpu") as eng:
        eng.warmup()
        for i in range(3):
            eng.submit(np.full((2, 8), i, np.float32)).result(timeout=60)
            assert bus.merged_histogram("serving_request_latency_ms").count == i + 1


def test_drain_returns_once_every_dispatch_is_accounted(fs_weights):
    """``drain`` waits for every submitted request's dispatch row and
    stats, not only for the queue to empty (a request leaves the queue
    before its answer, and its answer comes before its row), so a script's
    rows after a drain follow its dispatch rows. A sink whose ``append``
    is slow shows the order."""
    params, stats = fs_weights
    _, tcfg = _fs_cfgs()

    class SlowSink(list):
        def append(self, row):
            time.sleep(0.2)
            super().append(row)

    sink = SlowSink()
    with InferenceEngine(tcfg, params=params, batch_stats=stats, row_buckets=(2,),
                         bus=MetricsBus(), sink=sink, close_sink=False, device="cpu") as eng:
        eng.warmup()
        for i in range(2):
            eng.submit(np.full((2, 8), i, np.float32))
            eng.drain()
            assert [r["kind"] for r in sink].count("dispatch") == i + 1
            assert eng.summary()["dispatches"] == i + 1


# -- the daemon ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fs_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("live_tree"))
    tdemo.make_fs_demo_tree(root, n_sites=2, subjects=20, n_features=8, seed=6)
    return root


def _daemon_cfg(mod_cfg, mod_fs, **kw):
    return mod_cfg(task_id=TASK, batch_size=4, fs_args=mod_fs(input_size=8, hidden_sizes=(8,)),
                   **kw)


def _port_daemon(tree, out, **kw):
    return trunner.FedDaemon(_daemon_cfg(TrainConfig, FSArgs, **kw.pop("cfg", {})), capacity=4,
                             spool_dir=os.path.join(out, "spool"), out_dir=out, data_path=tree,
                             quorum=1, poll_s=0.01, inventory_rows=32, verbose=False,
                             device="cpu", **kw)


def _jax_daemon(tree, out, **kw):
    return JFedDaemon(_daemon_cfg(JTrainConfig, JFSArgs, **kw.pop("cfg", {})), capacity=4,
                      spool_dir=os.path.join(out, "spool"), out_dir=out, data_path=tree,
                      quorum=1, poll_s=0.01, inventory_rows=32, verbose=False, mesh=None, **kw)


def _series(bus) -> dict:
    snap = bus.snapshot()
    return {part: sorted(snap[part]) for part in ("counters", "gauges", "histograms")}


def test_daemon_bus_is_the_process_s_and_carries_the_trainer_s_gauges(fs_tree, tmp_path):
    """A DP daemon in both packages, each on a fresh bus: the same series
    names, ``train_epsilon`` among them (the trainer publishes into the
    daemon's bus); without ``bus=`` the daemon and its trainer publish into
    the process's bus, as JAX's do."""
    dp = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}
    buses = []
    for make, mod in ((_port_daemon, MetricsBus), (_jax_daemon, jbus.MetricsBus)):
        bus = mod()
        make(fs_tree, str(tmp_path / make.__name__), cfg=dp, bus=bus).serve(max_epochs=2)
        buses.append(bus)
    ours, theirs = (_series(b) for b in buses)
    assert ours == theirs
    assert "train_epsilon" in ours["gauges"]
    assert buses[0].snapshot()["gauges"]["train_epsilon"] == pytest.approx(
        buses[1].snapshot()["gauges"]["train_epsilon"], rel=1e-6)
    d = _port_daemon(fs_tree, str(tmp_path / "default"))
    assert d.bus is global_bus() and d.trainer.bus is d.bus


@pytest.fixture(scope="module")
def journeys(fs_tree, tmp_path_factory):
    """tests/test_observability.py's daemon journey in both packages: a
    telemetry-on daemon with a spool join that carries a trace id, 2 served
    epochs, each on its own bus."""
    tid = new_trace_id()
    ev = {"event": "join", "site": "late-site", "trace_id": tid,
          "data_dir": os.path.join(fs_tree, "input", "local1", "simulatorRun"),
          "config": {"labels_file": "site2_Covariate.csv"}}
    out = {}
    for name, make, mod in (("ours", _port_daemon, MetricsBus),
                            ("theirs", _jax_daemon, jbus.MetricsBus)):
        root = str(tmp_path_factory.mktemp(name))
        bus = mod()
        d = make(fs_tree, root, cfg={"telemetry": "on"}, bus=bus,
                 sink_tags={"tenant": "study-a"})
        with open(os.path.join(d.spool_dir, "ev000.json"), "w") as fh:
            json.dump(ev, fh)
        summary = d.serve(max_epochs=2)
        out[name] = (d, bus, summary, root)
    return tid, out


def _exporter_of(d, bus, mod=exporter):
    return mod.StatusExporter(bus, health=d.health_probes(), statusz=d.status,
                              slo={"histogram": "serve_epoch_ms", "p99_target_ms": 60_000.0},
                              tracer=d.trainer.tracer, flight=d.flight)


def test_daemon_journey_status_bus_and_tracez_match_jax(journeys):
    tid, out = journeys
    d, bus, _, _ = out["ours"]
    jd, jbus_, _, _ = out["theirs"]
    ex, jex = _exporter_of(d, bus), _exporter_of(jd, jbus_, jexporter)
    assert ex.healthz() == jex.healthz() and ex.healthz()[0] == 200
    assert set(d.health_probes()) == set(jd.health_probes())
    st, jst = ex.statusz_payload(), jex.statusz_payload()
    assert st["status"]["epoch"] == 2 and st["status"]["occupied"] == 3
    assert st["status"]["members"]["late-site"]["trace_id"] == tid
    assert st["status"]["members"] == jst["status"]["members"]
    assert set(jst["status"]) <= set(st["status"])
    assert st["slo"]["samples"] == jst["slo"]["samples"] == 2
    gauges, counters = st["metrics"]["gauges"], st["metrics"]["counters"]
    assert gauges["serve_epoch"] == 2 and gauges["serve_members"] == 3
    assert gauges[series_key("serve_member_generation", {"site": "late-site"})] == 1
    assert counters[series_key("serve_spool_events_total", {"result": "applied"})] == 3
    assert counters["serve_epochs_total"] == 2 and counters["serve_checkpoints_total"] >= 2
    assert _series(bus) == _series(jbus_)
    text = ex.metrics_text()
    assert "dinunet_serve_epoch 2" in text and "dinunet_train_epoch 2" not in text
    assert [ln.split(" ")[0].split("{")[0] for ln in text.splitlines()] == [
        ln.split(" ")[0].split("{")[0] for ln in jex.metrics_text().splitlines()]
    names = [e.get("name") for e in ex.tracez_payload()["recent"]]
    jnames = [e.get("name") for e in jex.tracez_payload()["recent"]]
    assert "epoch" in names and "serve-epoch" in names
    assert sorted(set(names)) == sorted(set(jnames))


def test_daemon_journey_meta_flight_and_sink_match_jax(journeys, tmp_path):
    """The trace id in the checkpoint meta; a flight dump with the final
    spans and bus snapshot; the sink's rows under ``telemetry/serve`` (the
    same kinds and event names as JAX's, the manifest tagged); the summary."""
    tid, out = journeys
    d, _, summary, root = out["ours"]
    jd, _, jsummary, jroot = out["theirs"]
    assert tckpt.load_meta(d.ckpt_path)["traces"] == {"late-site": tid}
    assert jckpt.load_meta(jd.ckpt_path)["traces"] == {"late-site": tid}
    events = []
    for fl, at in ((d.flight, root), (jd.flight, jroot)):
        path = fl.dump("signal:15")
        assert os.path.dirname(path) == at
        with open(path) as fh:
            payload = json.load(fh)
        assert payload["bus"]["gauges"]["serve_epoch"] == 2
        events.append({e["name"] for e in payload["events"]})
    assert events[0] == events[1]
    assert {"serve-epoch", "checkpoint-publish", "membership-join", "epoch"} <= events[0]
    rows = [tsink.load_metrics(os.path.join(r, "telemetry", "serve", tsink.METRICS_FILE))
            for r in (root, jroot)]
    assert [(r["kind"], r.get("name")) for r in rows[0]] == [
        (r["kind"], r.get("name")) for r in rows[1]]
    assert tsink.validate_metrics_rows(rows[0]) == []
    joins = [r for r in rows[0] if r.get("name") == "membership-join"]
    assert joins[-1]["trace"] == tid and joins[-1]["site"] == "late-site"
    epochs = [r for r in rows[0] if r["kind"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [1, 2] and epochs[0]["rounds"] > 0
    assert rows[0][-1]["kind"] == "summary" and rows[0][-1]["epochs_run"] == 2
    with open(os.path.join(root, "telemetry", "serve", tsink.MANIFEST_FILE)) as fh:
        assert json.load(fh)["tags"] == {"tenant": "study-a"}
    assert os.path.exists(os.path.join(root, "telemetry", "serve", tsink.TRACE_JSONL_FILE))
    assert set(jsummary) <= set(summary)
    assert summary["membership"] == jsummary["membership"]


def test_daemon_checkpoint_serves_its_trace_into_a_dispatch_row(journeys, tmp_path):
    """The serving end of the journey: an engine on the daemon's checkpoint
    names the join's trace id, and a request's own trace id lands in its
    dispatch row, as JAX's engine does on JAX's checkpoint."""
    tid, out = journeys
    d, _, _, _ = out["ours"]
    jd, _, _, _ = out["theirs"]
    rows_in = d._data["late-site"].inputs[:2]
    for eng_cls, daemon, extra in ((InferenceEngine, d, {"device": "cpu"}),
                                   (JEngine, jd, {})):
        sink, bus = _Rows(), MetricsBus()
        eng = eng_cls(daemon.cfg, checkpoint=daemon.ckpt_path, row_buckets=(4,), sink=sink,
                      bus=bus, **extra)
        eng.warmup()
        assert eng.status()["checkpoint_traces"] == {"late-site": tid}
        req = new_trace_id()
        fut = eng.submit(rows_in, trace_id=req)
        assert fut.trace_id == req and np.asarray(fut.result(timeout=60)).shape == (2, 2)
        eng.close()
        assert any(req in r.get("trace_ids", []) for r in sink if r["kind"] == "dispatch")
        assert sink[-1]["checkpoint_traces"] == {"late-site": tid} and sink.closes == 1
        assert exporter.slo_burn(bus.merged_histogram("serving_request_latency_ms"),
                                 60_000.0)["samples"] == 1


def test_daemon_dumps_its_flight_recorder_on_a_signal(fs_tree, tmp_path):
    """SIGTERM while the daemon serves: the preemption guard latches it,
    the daemon checkpoints, notes the signal and dumps ``flight_<pid>.json``
    with the final spans and the bus, then stops."""
    d = _port_daemon(fs_tree, str(tmp_path / "o"), cfg={"telemetry": "on"}, bus=MetricsBus())
    train = d.train_epoch

    def train_then_signal():
        loss = train()
        if d.epochs_run == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss

    d.train_epoch = train_then_signal
    summary = d.serve(max_epochs=5)
    assert summary["preempted"] and summary["epochs_run"] == 1
    (path,) = flight_files(str(tmp_path / "o"))
    with open(path) as fh:
        payload = json.load(fh)
    assert payload["reason"] == f"signal:{int(signal.SIGTERM)}"
    names = [e["name"] for e in payload["events"]]
    assert names[-1] == "signal" and "epoch" in names and "checkpoint" in names
    assert payload["bus"]["counters"]["serve_epochs_total"] == 1
