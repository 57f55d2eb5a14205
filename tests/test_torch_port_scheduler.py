"""The port's fleet scheduler (``runner/scheduler.py``) against the JAX
package's.

- ``fair_share`` and ``TenantSpec.from_event`` against JAX's, over the
  cases of JAX's ``tests/test_scheduler.py``;
- the scheduler spool (register, shutdown, the ``.rejected`` quarantine)
  with the same outcome in both;
- one two-tenant preempt-and-resume run at ``pod_slices=1`` in both
  packages, on tiny FS trees (MSANNet 8 -> 8 -> 2, as JAX's test), each
  port tenant started from JAX's initial state: the port's scheduled
  tenant ends bit for bit where the port's solo run of it ends, its grant
  log is JAX's line for line, each tenant's first epoch's loss agrees with
  JAX's at the FS epoch tests' dSGD tolerance
  (``tests/test_torch_port_fs_fit.py`` ``LOSS_TOL``) and every epoch's at
  ``LOSS_ATOL`` (below). JAX's daemons run with ``mesh=None``, every slot on one
  device, as the port's (on JAX's default mesh the sums run in another
  order, and the losses part by up to 8e-6). JAX's scheduler is not closed
  there: with ``mesh=None`` its reload places the state so that its epoch
  traces a second time, which its per-tenant guard counts (JAX's own tests
  run the scheduler on its default mesh, where it compiles once);
- the port alone: tenant-scoped sinks, bus labels, ``/statusz`` and the
  report's tenant rollup; an ε-budget stop isolated to one tenant; the
  backfill lane (no kernel library loaded after its warmup) and its
  missing-feed error; the CLI's ``--schedule``, and ``--schedule
  --statusz-port``, which serves the pod's endpoints.
"""

import dataclasses
import functools
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
from test_torch_port_fs_fit import LOSS_TOL as FS_LOSS_TOL

from dinunet_implementations_tpu.core.config import FSArgs as JFSArgs
from dinunet_implementations_tpu.core.config import TrainConfig as JTrainConfig
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import scheduler as jsched
from dinunet_implementations_tpu.telemetry.bus import MetricsBus as JMetricsBus
from dinunet_implementations_tpu_torch.core.config import FSArgs, TrainConfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.robustness.faults import FaultPlan
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import scheduler as tsched
from dinunet_implementations_tpu_torch.telemetry import report
from dinunet_implementations_tpu_torch.telemetry.bus import MetricsBus
from dinunet_implementations_tpu_torch.telemetry.exporter import StatusExporter
from dinunet_implementations_tpu_torch.weights import train_state_from_jax

# ---------------------------------------------------------------------------
# fair share and the spec, against JAX's
# ---------------------------------------------------------------------------


def _req(tenant, priority, weight, demand):
    return {"tenant": tenant, "priority": priority, "weight": weight, "demand": demand}


_THREE = [_req(t, 1.0, 1.0, 4) for t in ("c", "a", "b")]
FAIR_CASES = {
    "bands_drain_first_4": (4, [_req("lo", 1.0, 1.0, 4), _req("hi", 2.0, 1.0, 3)]),
    "bands_drain_first_2": (2, [_req("lo", 1.0, 1.0, 4), _req("hi", 2.0, 1.0, 3)]),
    "weighted_max_min": (6, [_req("a", 1.0, 2.0, 8), _req("b", 1.0, 1.0, 8)]),
    "demand_caps_and_residue": (4, [_req("a", 1.0, 1.0, 1), _req("hold", 1.0, 1.0, 0)]),
    "tiebreak_by_id": (1, _THREE),
    "tiebreak_reversed": (1, list(reversed(_THREE))),
    "one_slice_preempts": (1, [_req("ica", 1.0, 1.0, 1), _req("fs", 2.0, 1.0, 1)]),
}
FAIR_WANT = {"bands_drain_first_4": {"hi": 3, "lo": 1}, "bands_drain_first_2": {"hi": 2, "lo": 0},
             "weighted_max_min": {"a": 4, "b": 2}, "demand_caps_and_residue": {"a": 1, "hold": 0},
             "tiebreak_by_id": {"a": 1, "b": 0, "c": 0},
             "tiebreak_reversed": {"a": 1, "b": 0, "c": 0},
             "one_slice_preempts": {"fs": 1, "ica": 0}}


@pytest.mark.parametrize("case", sorted(FAIR_CASES))
def test_fair_share_matches_jax(case):
    pool, req = FAIR_CASES[case]
    got = tsched.fair_share(pool, req)
    assert got == jsched.fair_share(pool, req) == FAIR_WANT[case]
    assert list(got) == list(jsched.fair_share(pool, req))


SPEC_EVENTS = {
    "flat_config": {"event": "register", "tenant": "study0", "data_path": "/t", "capacity": 4,
                    "inventory_rows": 48, "max_epochs": 1, "priority": "2", "weight": 3,
                    "config": {"task_id": "FS-Classification", "batch_size": 4}},
    "defaults": {"event": "register", "tenant": "s"},
    "quota_steps_resume": {"event": "register", "tenant": "q", "slice_quota": "1",
                           "steps": 5, "resume": 1, "quorum": 2},
    "fault_plan": {"event": "register", "tenant": "f", "faults": {"nan_at": [[1, 0]]}},
    "bad_parent": {"event": "register", "tenant": "../evil"},
    "bad_hidden": {"event": "register", "tenant": ".hidden"},
    "bad_empty": {"event": "register"},
}


@pytest.mark.parametrize("case", sorted(SPEC_EVENTS))
def test_tenant_spec_from_event_matches_jax(case):
    ev = SPEC_EVENTS[case]
    if case.startswith("bad"):
        for mod in (tsched, jsched):
            with pytest.raises(mod.SchedulerError, match="bad tenant id"):
                mod.TenantSpec.from_event(ev)
        return
    got, want = tsched.TenantSpec.from_event(ev), jsched.TenantSpec.from_event(ev)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "fault_plan" and w is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        else:
            assert g == w, f.name


# ---------------------------------------------------------------------------
# tiny FS trees and tenants
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("sched_trees")
    return [tdemo.make_fs_demo_tree(str(root / f"tree{i}"), n_sites=4, subjects=32, n_features=8,
                                    seed=i) for i in range(2)]


CFG = dict(task_id="FS-Classification", batch_size=4, staleness_bound=2)
# the losses of the preemption drill past each tenant's first epoch: JAX's
# own move by up to 5.4e-6 when its start weights are perturbed by 1e-7
# (relative), Adam carrying rounding along; the port's part from JAX's by
# up to 8.1e-6 (measured, "a"'s fourth epoch)
LOSS_ATOL = 2e-5


def _cfg(mod="t", **kw):
    cfg_cls, fs_cls = (TrainConfig, FSArgs) if mod == "t" else (JTrainConfig, JFSArgs)
    return cfg_cls(fs_args=fs_cls(input_size=8, hidden_sizes=(8,)), **dict(CFG, **kw))


def _spec(mod, tenant, tree, **kw):
    base = dict(tenant=tenant, data_path=tree, config=_cfg("t" if mod is tsched else "j"),
                capacity=4, inventory_rows=48, quorum=1)
    base.update(kw)
    return mod.TenantSpec(**base)


@pytest.fixture
def jax_one_device(monkeypatch):
    """JAX's tenants with ``mesh=None``: every slot on one device."""
    monkeypatch.setattr(jsched, "FedDaemon", functools.partial(jrunner.FedDaemon, mesh=None))


def _sched(mod, root, **kw):
    bus = (MetricsBus if mod is tsched else JMetricsBus)()
    extra = {"device": "cpu"} if mod is tsched else {}
    return mod.FleetScheduler(str(root), pod_slices=kw.pop("pod_slices", 1), bus=bus,
                              poll_s=0.0, verbose=False, **extra, **kw)


def _run_to_done(sched, max_ticks=60):
    for _ in range(max_ticks):
        sched.tick(sleep_when_idle=False)
        if sched.done():
            return
    raise AssertionError("scheduler did not converge")


def _recording(monkeypatch, mod):
    """Every trained epoch's (tenant, loss), in the order the ticks ran."""
    log, train = [], mod.Tenant.train_epoch

    def recorded(self):
        loss = train(self)
        if loss is not None:
            log.append((self.spec.tenant, loss))
        return loss

    monkeypatch.setattr(mod.Tenant, "train_epoch", recorded)
    return log


def _start_state(tenant, init: dict):
    """JAX's tenant: note its initial state in ``init``; the port's: start
    its daemon from the noted state of the JAX tenant of its name."""
    name = tenant.spec.tenant
    if name not in init:
        init[name] = jax.tree.map(np.asarray, tenant.daemon.state)
    else:
        tenant.daemon.state = train_state_from_jax(init[name], rng=tenant.daemon.cfg.seed,
                                                   device="cpu")


# ---------------------------------------------------------------------------
# the spool
# ---------------------------------------------------------------------------


def _register_event(tree):
    return {"event": "register", "tenant": "study0", "data_path": tree, "capacity": 4,
            "inventory_rows": 48, "max_epochs": 1,
            "config": dict(CFG, fs_args={"input_size": 8, "hidden_sizes": [8]})}


def _write_spool(spool, tree):
    with open(os.path.join(spool, "ev000.json"), "w") as fh:
        json.dump(_register_event(tree), fh)
    with open(os.path.join(spool, "ev001.json"), "w") as fh:
        fh.write("{not json")
    with open(os.path.join(spool, "ev002.json"), "w") as fh:
        json.dump({"event": "register", "tenant": "../evil"}, fh)


def test_spool_register_shutdown_and_quarantine_match_jax(tmp_path, trees, jax_one_device):
    """The same spool through both: the good register applied, the
    malformed file quarantined, the bad id rejected and counted; a
    duplicate register refused; the study runs its one epoch; a shutdown
    event latches the stop."""
    outcomes = []
    for mod in (jsched, tsched):
        sched = _sched(mod, tmp_path / mod.__name__.split(".")[0])
        _write_spool(sched.spool_dir, trees[0])
        sched.tick(sleep_when_idle=False)
        snap = sched.bus.snapshot()["counters"]
        with pytest.raises(mod.SchedulerError, match="already registered"):
            sched.register(_spec(mod, "study0", trees[0]))
        _run_to_done(sched)
        with open(os.path.join(sched.spool_dir, "zz_down.json"), "w") as fh:
            json.dump({"event": "shutdown"}, fh)
        sched.ingest()
        out = sched.close()
        outcomes.append({
            "tenants": sorted(sched.tenants), "spool": sorted(os.listdir(sched.spool_dir)),
            "register": snap['sched_events_total{kind="register"}'],
            "rejected": snap['sched_events_total{kind="rejected"}'],
            "status": sched.tenants["study0"].status,
            "epochs": sched.tenants["study0"].daemon.epochs_run, "stop": sched._stop,
            "summary_keys": set(out), "epochs_run": out["tenants"]["study0"]["epochs_run"]})
    assert outcomes[0] == outcomes[1]
    assert outcomes[1]["spool"] == ["ev001.json.rejected"] and outcomes[1]["epochs"] == 1
    assert out["tenants"]["study0"]["compiles_after_first_epoch"] == {
        "kernel_builds": 0, "kernel_loads": 0}


# ---------------------------------------------------------------------------
# checkpoint, yield, resume
# ---------------------------------------------------------------------------


def _grant_log(root) -> list:
    with open(os.path.join(root, tsched.GRANTS_FILE)) as fh:
        return [(r["tick"], list(r["grants"].items())) for r in map(json.loads, fh)]


def test_preempt_and_resume_match_jax_and_the_solo_run(tmp_path, trees, jax_one_device,
                                                        monkeypatch):
    """At one slice: "a" trains 2 epochs, "b" arrives at a higher priority
    and takes the slice (a's checkpoint, then the yield), trains 2 epochs
    and finishes; "a" resumes through the checkpoint reload and finishes
    its 4. In both packages the same grants tick by tick, the same losses
    at tolerance; the port's "a" ends bit for bit on its solo run's
    params digest, with no library built after its first epoch."""
    runs, init = {}, {}
    for mod in (jsched, tsched):
        log = _recording(monkeypatch, mod)
        sched = _sched(mod, tmp_path / mod.__name__.split(".")[0])
        a = sched.register(_spec(mod, "a", trees[0], max_epochs=4, priority=1.0))
        _start_state(a, init)
        sched.tick(sleep_when_idle=False)
        sched.tick(sleep_when_idle=False)
        assert a.daemon.epochs_run == 2 and a.granted == 1
        b = sched.register(_spec(mod, "b", trees[1], max_epochs=2, priority=2.0))
        _start_state(b, init)
        r = sched.tick(sleep_when_idle=False)
        assert r["grants"] == {"b": 1, "a": 0} and r["preempt_pause_ms"] > 0
        assert a.preempted and a.preempt_count == 1 and a.daemon.epochs_run == 2
        assert a.daemon.status()["slice_grant"] == [0.0]
        _run_to_done(sched)
        assert not a.preempted and a.daemon.epochs_run == 4 and b.daemon.epochs_run == 2
        runs["jax" if mod is jsched else "port"] = {
            "a": a, "b": b, "digest": a.params_digest(), "log": list(log),
            "grants": _grant_log(sched.root), "goodput": sched.goodput(),
            "out": sched.close() if mod is tsched else None}
    j, t = runs["jax"], runs["port"]
    assert t["grants"] == j["grants"]
    assert [n for n, _ in t["log"]] == [n for n, _ in j["log"]] == ["a", "a", "b", "b", "a", "a"]
    tl, jl = [v for _, v in t["log"]], [v for _, v in j["log"]]
    first = [0, 2]  # "a"'s and "b"'s first epochs
    np.testing.assert_allclose([tl[i] for i in first], [jl[i] for i in first],
                               **FS_LOSS_TOL["dSGD"])
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    for name in ("a", "b"):
        assert t["out"]["tenants"][name]["compiles_after_first_epoch"] == {
            "kernel_builds": 0, "kernel_loads": 0}
    assert t["goodput"]["preempt_count"] == j["goodput"]["preempt_count"] == 1
    assert t["goodput"]["epochs"] == j["goodput"]["epochs"] == {"a": 4, "b": 2}
    assert t["goodput"]["preempt_pause_ms_p99"] > 0

    solo = _sched(tsched, tmp_path / "solo")
    sa = solo.register(_spec(tsched, "a", trees[0], max_epochs=4))
    _start_state(sa, init)
    _run_to_done(solo)
    assert sa.params_digest() == t["digest"]
    solo.close()


# ---------------------------------------------------------------------------
# the port alone: isolation, observability, backfill, the CLI
# ---------------------------------------------------------------------------


def test_sinks_bus_labels_statusz_and_the_report_rollup_are_tenant_scoped(tmp_path, trees):
    root = str(tmp_path / "pod")
    sched = _sched(tsched, root, pod_slices=2)
    for i, name in enumerate(("alpha", "beta")):
        sched.register(_spec(tsched, name, trees[i], max_epochs=2, slice_quota=1,
                             config=_cfg(telemetry="on")))
    _run_to_done(sched)
    with StatusExporter(sched.bus, port=0, health=sched.health_probes(),
                        statusz=sched.status) as ex:
        url = f"http://127.0.0.1:{ex.port}"
        with urllib.request.urlopen(f"{url}/statusz", timeout=5) as r:
            payload = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=5) as r:
            text = r.read().decode()
        with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
            health = json.loads(r.read())
    status = payload["status"]
    assert status["mode"] == "scheduler" and set(status["tenants"]) == {"alpha", "beta"}
    assert status["tenants"]["alpha"]["epochs_run"] == 2
    assert status["tenants"]["alpha"]["daemon"]["slice_grant"] == [0.0]
    assert 'tenant="alpha"' in text and 'tenant="beta"' in text
    assert health["status"] == "ok" and health["subsystems"]["tenant_alpha"]["ready"]
    sched.close()
    dirs = [os.path.join(root, "tenants", n, "output", "telemetry", "serve")
            for n in ("alpha", "beta")]
    for name, d in zip(("alpha", "beta"), dirs):
        with open(os.path.join(d, "manifest.json")) as fh:
            assert json.load(fh)["tags"] == {"tenant": name}
        assert report.main([d, "--validate"]) == 0
    rollup = report.tenant_rollup(dirs)
    assert [(r["tenant"], r["fits"], r["epochs"]) for r in rollup] == [
        ("alpha", 1, 2), ("beta", 1, 2)]


def test_epsilon_budget_stop_and_quarantine_are_isolated(tmp_path, trees):
    """Tenant "a" trains under DP with a tiny ε budget and a NaN site: a
    clean stop and a quarantine, in its own state only; "b" ends bit for
    bit on its solo run, with no DP of its own."""
    solo = _sched(tsched, tmp_path / "solo", pod_slices=2)
    sb = solo.register(_spec(tsched, "b", trees[1], max_epochs=3, slice_quota=1))
    _run_to_done(solo)
    solo_digest = sb.params_digest()
    solo.close()
    sched = _sched(tsched, tmp_path / "pod", pod_slices=2)
    a = sched.register(_spec(tsched, "a", trees[0], max_epochs=6, slice_quota=1,
                             config=_cfg(dp_clip=1.0, dp_noise_multiplier=0.8,
                                         dp_epsilon_budget=1e-3, quarantine_rounds=1),
                             fault_plan=FaultPlan(nan_at=((1, 0),))))
    b = sched.register(_spec(tsched, "b", trees[1], max_epochs=3, slice_quota=1))
    _run_to_done(sched)
    assert a.status == "stopped" and a.daemon.epochs_run < 6
    assert a.daemon.trainer._dp_epsilon >= 1e-3
    assert int(a.daemon.state.health["quarantined"].max()) > 0
    assert int(b.daemon.state.health["quarantined"].max()) == 0
    assert b.daemon.trainer._dp_epsilon is None
    assert b.status == "done" and b.daemon.epochs_run == 3
    assert b.params_digest() == solo_digest
    assert sched.bus.snapshot()["counters"]['serve_dp_budget_stops_total{tenant="a"}'] == 1
    sched.close()


def test_backfill_lane_serves_the_residue_with_no_load_after_warmup(tmp_path):
    from dinunet_implementations_tpu_torch.models import MSANNet
    from dinunet_implementations_tpu_torch.ops import _build

    cfg = TrainConfig(task_id="FS-Classification", batch_size=4, seed=3).with_overrides(
        {"fs_args": {"input_size": 6, "hidden_sizes": [8]}})
    model = MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    params = {k: v.detach() for k, v in model.named_parameters()}
    stats = {k: v.detach() for k, v in model.named_buffers() if "num_batches" not in k}
    rng = np.random.default_rng(0)
    lane = tsched.BackfillLane(
        cfg, lambda: rng.normal(size=(2, 6)).astype(np.float32), params=params,
        batch_stats=stats, replicas=1, requests_per_quantum=3,
        engine_kwargs=dict(row_buckets=(1, 2, 4), max_delay_ms=1.0, supervise_interval_s=0.05))
    sched = _sched(tsched, tmp_path / "pod", pod_slices=2, backfill=lane)
    r = sched.tick(sleep_when_idle=False)  # an empty pool: the lane rents all of it
    assert r["leftover"] == 2 and r["served"]["requests"] == 3
    loads = (_build.BUILDS, _build.LOADS)
    r = sched.tick(sleep_when_idle=False)
    assert r["served"]["samples"] == 6 and (_build.BUILDS, _build.LOADS) == loads
    snap = sched.bus.snapshot()
    assert snap["gauges"]["sched_backfill_requests"] == 6.0
    assert any('lane="backfill"' in k for k in snap["gauges"])
    out = sched.close()  # the fleet checks no library after its warmup
    assert out["backfill"]["requests_served"] == 6 and out["backfill"]["samples_served"] == 12
    assert lane.status()["started"] is False
    for mod in (tsched, jsched):
        with pytest.raises(mod.SchedulerError, match="needs a feed"):
            mod.BackfillLane(cfg, None)


def test_a_tenant_of_more_than_one_slice_is_refused_naming_a11(tmp_path, trees):
    sched = _sched(tsched, tmp_path / "pod")
    with pytest.raises(tsched.SchedulerError, match="ROADMAP A11"):
        sched.register(_spec(tsched, "wide", trees[0], config={"num_slices": 2}))


def test_cli_schedule_runs_the_spool_and_refuses_the_pod_plane(tmp_path, trees, capsys):
    """``--schedule`` over a root whose spool holds a register and a
    shutdown: rc 0 and one strict-JSON summary line; ``--schedule
    --statusz-port 0`` over the finished root is served (rc 0, the
    endpoints' line before the summary), no longer refused."""
    root = str(tmp_path / "pod")
    os.makedirs(os.path.join(root, "spool"))
    with open(os.path.join(root, "spool", "ev000.json"), "w") as fh:
        json.dump(_register_event(trees[0]), fh)
    with open(os.path.join(root, "spool", "ev001.json"), "w") as fh:
        json.dump({"event": "shutdown"}, fh)
    capsys.readouterr()
    assert tcli.main(["--data-path", root, "--schedule", "--pod-slices", "1", "--sched-ticks",
                      "5", "--device", "cpu", "--quiet"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(line, parse_constant=lambda c: pytest.fail(f"not strict JSON: {c}"))
    assert list(summary["tenants"]) == ["study0"] and summary["goodput"]["ticks"] == 1
    assert summary["tenants"]["study0"]["epochs_run"] == 1
    assert tcli.main(["--data-path", root, "--schedule", "--statusz-port", "0", "--sched-ticks",
                      "1", "--serve-poll", "0", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines[0]["statusz"].startswith("http://127.0.0.1:")
    assert lines[0]["endpoints"] == ["/metrics", "/healthz", "/statusz", "/tracez"]
    assert lines[-1]["tenants"] == {}
