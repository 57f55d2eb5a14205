"""The port's pod plane against the JAX package's, on the same inputs:
``telemetry/collector.py`` (series parsing, label stamping, the exact
merge, discovery, and ``PodCollector`` scraping the other package's
``StatusExporter``), ``telemetry/assemble.py`` and
``telemetry/postmortem.py`` over one directory (flight dumps, heartbeats,
the liveness spool, consensus decisions and a ``grants.jsonl`` written by
both packages' schedulers), JAX's supervised SIGKILL drill through the
port's supervisor and post-mortem, and the CLI's ``--schedule
--statusz-port``.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.runner import scheduler as jsched
from dinunet_implementations_tpu.runner import supervisor as jsup
from dinunet_implementations_tpu.telemetry import assemble as jasm
from dinunet_implementations_tpu.telemetry import bus as jbus
from dinunet_implementations_tpu.telemetry import collector as jcol
from dinunet_implementations_tpu.telemetry import postmortem as jpm
from dinunet_implementations_tpu.telemetry.bus import MetricsBus as JMetricsBus
from dinunet_implementations_tpu.telemetry.bus import series_key as jseries_key
from dinunet_implementations_tpu.telemetry.exporter import StatusExporter as JStatusExporter
from dinunet_implementations_tpu.telemetry.flight import FlightRecorder as JFlightRecorder
from dinunet_implementations_tpu.telemetry.hist import HistogramShapeError as JHistogramShapeError
from dinunet_implementations_tpu.telemetry.tracer import SpanTracer as JSpanTracer
from dinunet_implementations_tpu_torch import telemetry as ttel
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import scheduler as tsched
from dinunet_implementations_tpu_torch.runner import supervisor as tsup
from dinunet_implementations_tpu_torch.telemetry import assemble as tasm
from dinunet_implementations_tpu_torch.telemetry import bus as tbus
from dinunet_implementations_tpu_torch.telemetry import collector as tcol
from dinunet_implementations_tpu_torch.telemetry import postmortem as tpm
from dinunet_implementations_tpu_torch.telemetry.bus import MetricsBus, series_key
from dinunet_implementations_tpu_torch.telemetry.exporter import StatusExporter
from dinunet_implementations_tpu_torch.telemetry.flight import FlightRecorder
from dinunet_implementations_tpu_torch.telemetry.hist import HistogramShapeError
from dinunet_implementations_tpu_torch.telemetry.tracer import SpanTracer
from test_torch_port_supervisor import _STUB, stub_spawn

COLS = {"jax": jcol, "port": tcol}


def _get(port: int, path: str = "/statusz"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        body = resp.read().decode()
    return json.loads(body) if path == "/statusz" else body


# -- series keys, stamping and the merge ----------------------------------------

SERIES = {
    "plain": ("plain", {}),
    "labels": ("epoch_ms", {"tenant": "studyA", "slice": "0"}),
    "escapes": ("weird", {"q": 'va"lue', "b": "back\\slash", "n": "new\nline"}),
    "commas": ("commas", {"a": "x,y", "z": 'trail,"'}),
}


@pytest.mark.parametrize("case", sorted(SERIES))
def test_parse_series_matches_jax(case):
    name, labels = SERIES[case]
    key = series_key(name, labels)
    assert key == jseries_key(name, labels)
    assert tcol.parse_series(key) == jcol.parse_series(key) == (name, labels)


def _bus(cls, seed: int):
    bus = cls()
    bus.counter("epochs_total", 2 + seed)
    bus.gauge("round", 10 * seed)
    bus.gauge("epoch", 7, tenant="a")
    for i in range(4 + seed):
        bus.observe("epoch_ms", 5.0 * (i + 1) * (seed + 1))
    return bus


def test_stamp_merge_and_their_errors_match_jax():
    snaps = [_bus(MetricsBus, s).snapshot() for s in range(3)]
    assert snaps == [_bus(JMetricsBus, s).snapshot() for s in range(3)]
    stamped = []
    for i, snap in enumerate(snaps):
        got = tcol.stamp_snapshot(snap, process=str(i), slice=str(i))
        assert got == jcol.stamp_snapshot(snap, process=str(i), slice=str(i))
        stamped.append(got)
    assert set(stamped[1]["gauges"]) == {'epoch{process="1",slice="1",tenant="a"}',
                                         'round{process="1",slice="1"}'}
    assert stamped[1]["counters"] == {"epochs_total": 3}
    a, b, c = stamped
    left = tcol.merge_snapshots(tcol.merge_snapshots(a, b), c)
    assert left == tcol.merge_snapshots(a, tcol.merge_snapshots(b, c))
    assert left == jcol.merge_snapshots(jcol.merge_snapshots(a, b), c)
    assert tcol.merge_snapshots(a, b) == tcol.merge_snapshots(b, a)
    for name in ("epoch_ms", "round", "missing"):
        t, j = tcol.merged_histogram_of(left, name), jcol.merged_histogram_of(left, name)
        assert (t is None and j is None) or t.to_dict() == j.to_dict()
    assert tcol.merged_histogram_of(left, "epoch_ms").count == 4 + 5 + 6
    spoof = {"counters": {}, "histograms": {}, "gauges": {'g{process="w0"}': 1.0}}
    clash = ({"counters": {}, "histograms": {}, "gauges": {"round": 4}},
             {"counters": {}, "histograms": {}, "gauges": {"round": 9}})
    for mod in COLS.values():
        with pytest.raises(mod.LabelCollisionError):
            mod.stamp_snapshot(spoof, process="w1")
        assert mod.stamp_snapshot(spoof, process="w0")["gauges"] == spoof["gauges"]
        with pytest.raises(mod.LabelCollisionError):
            mod.merge_snapshots(*clash)
        assert mod.merge_snapshots(clash[0], dict(clash[0]))["gauges"] == {"round": 4}
    assert issubclass(tcol.LabelCollisionError, ValueError)
    assert ttel.PodCollector is tcol.PodCollector and ttel.stamp_snapshot is tcol.stamp_snapshot
    good = {"histograms": {"h": snaps[0]["histograms"]["epoch_ms"]}}
    bad = {"histograms": {"h": {**snaps[0]["histograms"]["epoch_ms"], "per_decade": 7,
                                "counts": [0] * 3}}}
    with pytest.raises(HistogramShapeError):
        tcol.merge_snapshots(good, bad)
    with pytest.raises(JHistogramShapeError):
        jcol.merge_snapshots(good, bad)


# -- discovery and the collector across packages --------------------------------


def test_discovery_matches_jax_and_skips_dead_and_portless(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    hb_dir = tmp_path / "heartbeats"
    hb_dir.mkdir()
    (hb_dir / "slice_0.json").write_text(json.dumps(
        {"pid": dead.pid, "slice": 0, "statusz_port": 1, "time_unix": time.time()}))
    (hb_dir / "slice_1.json").write_text(json.dumps(
        {"pid": os.getpid(), "slice": 1, "time_unix": time.time()}))
    assert tcol.discover_targets(str(tmp_path)) == jcol.discover_targets(str(tmp_path)) == []
    hb = tsup.Heartbeat(tsup.heartbeat_path(str(tmp_path), 2), 2)
    hb.beat(statusz_port=12345, process=2)
    got = tcol.discover_targets(str(tmp_path))
    assert got == jcol.discover_targets(str(tmp_path))
    assert [t["pid"] for t in got] == [os.getpid()]
    assert tcol.read_heartbeats(str(tmp_path)) == jcol.read_heartbeats(str(tmp_path))


def test_pod_collector_scrapes_the_other_package_and_both_agree(tmp_path):
    """Slice 0 is a JAX ``StatusExporter`` and slice 1 the port's; the
    port's collector and JAX's over the one directory give the same merged
    snapshot and targets, and the port's exporter serves the pod."""
    t0 = time.time()
    workers = [JStatusExporter(_bus(JMetricsBus, 0), statusz=lambda: {"started_unix": t0}),
               StatusExporter(_bus(MetricsBus, 1), statusz=lambda: {"started_unix": t0})]
    pod_exporter = None
    try:
        for i, e in enumerate(workers):
            (jsup if i == 0 else tsup).Heartbeat(tsup.heartbeat_path(str(tmp_path), i), i).beat(
                statusz_port=e.start(), process=i, epoch=3, round=6)
        locals_ = {name: cls() for name, cls in (("jax", JMetricsBus), ("port", MetricsBus))}
        for bus in locals_.values():
            bus.counter("supervisor_polls_total", 5)
        got = {name: COLS[name].PodCollector(str(tmp_path), local_bus=locals_[name],
                                             local_labels={"process": "supervisor"},
                                             cache_s=0.0).collect()
               for name in COLS}
        assert got["port"] == got["jax"]
        snap = got["port"]["snapshot"]
        for i in range(2):
            assert series_key("epoch_ms", {"process": str(i), "slice": str(i)}) \
                in snap["histograms"]
        assert snap["counters"]["epochs_total"] == 2 + 3
        assert snap["counters"]["supervisor_polls_total"] == 5
        assert snap["gauges"]["pod_scrape_targets"] == 2
        assert snap["gauges"]["pod_scrape_errors"] == 0
        assert [(t["slice"], t["epoch"], t["round"]) for t in got["port"]["targets"]] == [
            (0, 3, 6), (1, 3, 6)]
        collector = tcol.PodCollector(str(tmp_path), local_bus=locals_["port"],
                                      local_labels={"process": "supervisor"}, cache_s=0.0,
                                      status_extra=lambda: {"generation": 2, "mode": "x"})
        pod_exporter = StatusExporter(collector, statusz=collector.status,
                                      slo={"histogram": "epoch_ms", "p99_target_ms": 1e6})
        payload = _get(pod_exporter.start())
        assert payload["slo"]["samples"] == 4 + 5
        assert payload["status"]["mode"] == "pod" and payload["status"]["generation"] == 2
        assert len(payload["status"]["targets"]) == 2
        assert "dinunet_pod_scrape_targets 2" in _get(pod_exporter.port, "/metrics")
    finally:
        for e in workers:
            e.stop()
        if pod_exporter is not None:
            pod_exporter.stop()
    # the workers gone: both views fall back to the reachable subset
    gone = {name: COLS[name].PodCollector(str(tmp_path), cache_s=0.0).collect()
            for name in COLS}
    assert gone["port"]["targets"] == gone["jax"]["targets"] == []
    assert len(gone["port"]["errors"]) == len(gone["jax"]["errors"]) == 2


# -- assembly -------------------------------------------------------------------


def _fake_trace(path, pid, t0_unix, trace_id):
    rows = [{"ph": "M", "name": "clock_sync", "pid": pid, "t0_perf": 50.0 + pid,
             "t0_unix": t0_unix},
            {"ph": "X", "name": "dcn-epoch", "ts": 1000.0, "dur": 500.0, "trace": trace_id,
             "tid": 0},
            {"ph": "i", "name": "pulse", "ts": 2000.0, "trace": trace_id}]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in rows)


def test_assemble_matches_jax_on_both_packages_traces(tmp_path):
    pod = str(tmp_path)
    _fake_trace(os.path.join(pod, "pod_trace", "trace_p0.jsonl"), 111, 1000.0, "abc")
    _fake_trace(os.path.join(pod, "pod_trace", "trace_p1.jsonl"), 222, 2000.0, "abc")
    os.makedirs(os.path.join(pod, "heartbeats"))
    with open(os.path.join(pod, "heartbeats", "slice_0.json"), "w") as fh:
        json.dump({"pid": 111, "slice": 0, "perf": 50.0, "time_unix": 1500.0}, fh)
    for name, cls in (("jax", JSpanTracer), ("port", SpanTracer)):
        tr = cls()
        with tr.span("fit-epoch", trace="t1"):
            tr.event("tick", trace="t1")
        tr.write_jsonl(os.path.join(pod, "telemetry", name, "trace.jsonl"))
    clock, events = tasm.load_trace(os.path.join(pod, "telemetry", "port", "trace.jsonl"))
    assert (clock, events) != (None, [])
    assert set(clock) == set(jasm.load_trace(
        os.path.join(pod, "telemetry", "jax", "trace.jsonl"))[0])
    assert tasm.align_unix_us(2e6, {"t0_perf": 100.0, "t0_unix": 5000.0}, offset=900.0) == \
        jasm.align_unix_us(2e6, {"t0_perf": 100.0, "t0_unix": 5000.0}, offset=900.0)
    assert tasm.find_trace_files(pod) == jasm.find_trace_files(pod)
    got = tasm.assemble(pod, os.path.join(pod, "out", "port.json"))
    assert got == jasm.assemble(pod, os.path.join(pod, "out", "jax.json"))
    srcs = {s["pid"]: s["aligned_by"] for s in got["metadata"]["sources"]}
    assert srcs[111] == "heartbeat" and srcs[222] == "clock_sync"
    assert tasm.processes_by_trace(got)["abc"] == {111, 222}
    ts = [e["ts"] for e in got["traceEvents"] if "ts" in e]
    assert min(ts) == 0.0
    assert tasm.main([pod, "--require-cross-process"]) == 0
    lone = str(tmp_path / "lone")
    _fake_trace(os.path.join(lone, "pod_trace", "trace_p0.jsonl"), 111, 1000.0, "only")
    for mod in (tasm, jasm):
        assert mod.main([lone, "--require-cross-process"]) == 1 and mod.main([lone]) == 0


# -- the post-mortem -----------------------------------------------------------


def _grant_logger(mod, root, ticks):
    sched = object.__new__(mod.FleetScheduler)
    sched.root, sched.ticks = root, ticks
    return sched


def _incident(pod: str) -> None:
    liveness = os.path.join(pod, tsup.LIVENESS_DIR)
    tsup.mark_slice_dead(liveness, 1, "exit rc=-9 (signal 9)", heartbeat_age=0.4,
                         generation=1)
    jsup.mark_slice_alive(liveness, 1, 2)
    os.makedirs(os.path.join(pod, "consensus"))
    with open(os.path.join(pod, "consensus", "decision_gen1.json"), "w") as fh:
        json.dump({"time_unix": time.time(), "generation": 1, "dead_slice": 1, "round": 14,
                   "epoch": 7, "sha": "abc123", "replaced": True}, fh)
    _grant_logger(jsched, pod, 3)._log_grants({"a": 2}, 0.0)
    _grant_logger(tsched, pod, 4)._log_grants({"a": 1, "b": 1}, 12.5)
    for cls in (JFlightRecorder, FlightRecorder):
        flight = cls(pod)
        flight.note("slice-death", slice=1, generation=1)
        flight.dump("slice-death:slice=1")
    tsup.Heartbeat(tsup.heartbeat_path(pod, 0), 0).beat(epoch=7, round=14)


def test_postmortem_matches_jax_over_one_directory(tmp_path):
    pod = str(tmp_path / "pod")
    _incident(pod)
    rows = tpm.build_timeline(pod)
    assert rows == jpm.build_timeline(pod)
    assert [r["t_unix"] for r in rows] == sorted(r["t_unix"] for r in rows)
    assert {"liveness", "consensus", "scheduler", "heartbeat",
            f"flight:{os.getpid()}"} <= {r["source"] for r in rows}
    assert [r["tick"] for r in rows if r["source"] == "scheduler"] == [3, 4]
    assert tpm._grant_rows(pod) == jpm._grant_rows(pod)
    inc = tpm.incident_summary(rows)
    assert inc == jpm.incident_summary(rows)
    assert (inc["killed_slice"], inc["consensus_round"], inc["restart_generation"]) == (1, 14, 2)
    assert tpm.validate_timeline(rows) == jpm.validate_timeline(rows) == []
    outs = {}
    for name, mod in (("jax", jpm), ("port", tpm)):
        path = str(tmp_path / f"{name}.json")
        assert mod.main([pod, "--validate", "--json", path]) == 0
        with open(path) as fh:
            outs[name] = json.load(fh)
    assert outs["port"] == outs["jax"]
    unfinished = str(tmp_path / "unfinished")
    tsup.mark_slice_dead(os.path.join(unfinished, tsup.LIVENESS_DIR), 1, "exit rc=-9", generation=1)
    for mod in (tpm, jpm):
        assert mod.main([unfinished, "--validate"]) == 1 and mod.main([unfinished]) == 0
    assert tpm.validate_timeline(tpm.build_timeline(unfinished)) == \
        jpm.validate_timeline(jpm.build_timeline(unfinished))


def _drill(mod, flight_cls, out_dir):
    """JAX's supervised SIGKILL drill: two stub workers, slice 1 kills
    itself in generation 1, a real flight recorder, and the consensus
    decision written as the worker's consensus install writes it."""
    os.makedirs(out_dir)
    flight = flight_cls(out_dir)

    def on_consensus(generation, dead_slice):
        os.makedirs(os.path.join(out_dir, "consensus"), exist_ok=True)
        with open(os.path.join(out_dir, "consensus", f"decision_gen{generation}.json"),
                  "w") as fh:
            json.dump({"time_unix": time.time(), "generation": generation,
                       "dead_slice": dead_slice, "round": 6, "epoch": 3, "sha": "drill",
                       "replaced": True}, fh)

    sup = mod.SliceSupervisor(stub_spawn(out_dir, _STUB, (1,)), num_processes=2,
                              out_dir=out_dir, heartbeat_timeout_s=10.0, max_restarts=2,
                              poll_s=0.1, grace_s=5.0, flight=flight, on_consensus=on_consensus)
    assert sup.run() == 0
    flight.dump("supervisor-exit:rc=0")


def test_sigkill_drill_through_the_port_gives_jax_s_incident(tmp_path):
    runs = {"jax": (jsup, JFlightRecorder, jpm), "port": (tsup, FlightRecorder, tpm)}
    threads = [threading.Thread(target=_drill, args=(mod, fl, str(tmp_path / name)))
               for name, (mod, fl, _pm) in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    incidents = {}
    for name, (_mod, _fl, pm) in runs.items():
        d = str(tmp_path / name)
        assert pm.main([d, "--validate"]) == 0
        incidents[name] = pm.incident_summary(pm.build_timeline(d))
        assert jpm.incident_summary(jpm.build_timeline(d)) == incidents[name]
        rows = [r for r in pm.build_timeline(d) if r["source"].startswith("flight")]
        # two dumps, the death's and the exit's, each with its ring
        assert [r["reason"] for r in rows if r["event"] == "flight-dump"][-1] == \
            "supervisor-exit:rc=0"
        assert {"fleet-launch", "slice-death", "fleet-restart", "fleet-complete"} <= {
            r["event"] for r in rows}
    assert incidents["port"] == incidents["jax"]
    assert incidents["port"]["killed_slice"] == 1
    assert "signal 9" in incidents["port"]["death_reason"]
    assert incidents["port"]["consensus_round"] == 6
    assert incidents["port"]["restart_generation"] == 2


# -- the CLI's pod branch ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _served_statusz(cli, root: str, extra=()):
    """``cli.main`` with ``--schedule --statusz-port`` in a thread: one
    ``/statusz`` and one ``/metrics`` while it runs, once the served
    snapshot holds a whole first tick (its ``sched_ticks_total`` counter at
    2: a tick sets its last gauges after counting itself, and the
    collector's snapshot may be older than the status beside it), then a
    shutdown event ends it. ``(rc, statusz, metrics)``."""
    port = _free_port()
    os.makedirs(os.path.join(root, "spool"), exist_ok=True)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("rc", cli.main(
        ["--data-path", root, "--schedule", "--statusz-port", str(port), "--serve-poll", "0.05",
         "--sched-wall-s", "30", "--quiet", *extra])))
    t.start()
    deadline = time.time() + 20
    while True:
        try:
            payload = _get(port)
            if payload["metrics"]["counters"].get("sched_ticks_total", 0) >= 2:
                break
        except OSError:
            pass
        assert time.time() < deadline and t.is_alive(), "never served a whole tick"
        time.sleep(0.05)
    metrics = _get(port, "/metrics")
    with open(os.path.join(root, "spool", "zz_shutdown.json"), "w") as fh:
        json.dump({"event": "shutdown"}, fh)
    t.join(30)
    return out.get("rc"), payload, metrics


def test_cli_schedule_statusz_port_serves_jax_s_pod_statusz(tmp_path, monkeypatch):
    # each scheduler on a bus of its own, not the process's (other tests'
    # series live there)
    monkeypatch.setattr(tbus, "global_bus", MetricsBus)
    monkeypatch.setattr(jbus, "global_bus", JMetricsBus)
    rc, payload, metrics = _served_statusz(tcli, str(tmp_path / "port"), ("--device", "cpu"))
    jrc, jpayload, jmetrics = _served_statusz(jcli, str(tmp_path / "jax"))
    assert rc == jrc == 0
    assert set(payload) == set(jpayload)
    assert set(payload["status"]) == set(jpayload["status"])
    # the port's pod /statusz says it is one; JAX's lets the scheduler's
    # "mode" overwrite the collector's
    assert payload["status"]["mode"] == "pod" and jpayload["status"]["mode"] == "scheduler"
    assert payload["status"]["tenants"] == jpayload["status"]["tenants"] == {}
    assert payload["status"]["targets"] == [] and payload["status"]["scrape_errors"] == []
    assert set(payload["metrics"]["gauges"]) == set(jpayload["metrics"]["gauges"])
    assert 'sched_pod_slices{process="scheduler"}' in payload["metrics"]["gauges"]
    assert "dinunet_pod_scrape_targets 0" in metrics and "dinunet_pod_scrape_targets 0" in jmetrics
