"""The port's slice supervisor (``runner/supervisor.py``) against the JAX
package's, on the same inputs:

- the constants, the heartbeat's fields and the liveness spool's file names
  and event order;
- checkpoint consensus over the cases of JAX's ``tests/test_supervisor.py``
  (the newest agreed round, a lagging slice, a digest disagreement, a torn
  latest with its ``.prev``), with the slices' checkpoints written by JAX,
  by the port, and half by each: both packages read both packages' files
  and pick the same round;
- ``SliceSupervisor`` over stub workers (restart and complete, give up, a
  passthrough rc, a worker wedged and found by its heartbeat): the same rc,
  restarts, liveness events, flight notes and dumps, and bus counters.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from dinunet_implementations_tpu.runner import supervisor as jsup
from dinunet_implementations_tpu.telemetry.bus import MetricsBus as JMetricsBus
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer.steps import TrainState as JTrainState
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.runner import supervisor as tsup
from dinunet_implementations_tpu_torch.telemetry.bus import MetricsBus
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer.steps import TrainState

SUPS = {"jax": jsup, "port": tsup}
BUSES = {"jax": JMetricsBus, "port": MetricsBus}


def _no_time(events):
    return [{k: v for k, v in e.items() if k != "time_unix"} for e in events]


def test_constants_and_paths_match_jax(tmp_path):
    for name in ("SUPERVISOR_GAVE_UP_RC", "HEARTBEAT_DIR", "LIVENESS_DIR", "SLICE_CKPT_DIR"):
        assert getattr(tsup, name) == getattr(jsup, name), name
    out = str(tmp_path)
    assert tsup.heartbeat_path(out, 3) == jsup.heartbeat_path(out, 3)
    assert tsup.slice_ckpt_dir(out, 2) == jsup.slice_ckpt_dir(out, 2)


def test_heartbeat_fields_match_jax_and_each_reads_the_other(tmp_path):
    pulses = {}
    for name, mod in SUPS.items():
        path = mod.heartbeat_path(str(tmp_path / name), 3)
        assert mod.read_heartbeat(path) is None and mod.heartbeat_age_s(path) is None
        hb = mod.Heartbeat(path, 3, interval_s=0.05)
        hb.beat(epoch=7, round=14, statusz_port=1234, process=0)
        pulses[name] = (hb, path)
    jp, tp = (jsup.read_heartbeat(pulses[n][1]) for n in ("jax", "port"))
    assert set(tp) == set(jp)
    for k in ("pid", "slice", "epoch", "round", "statusz_port", "process"):
        assert tp[k] == jp[k], k
    assert tp["started_unix"] == pulses["port"][0].started_unix
    assert abs((tp["time_unix"] - tp["perf"]) - (time.time() - time.perf_counter())) < 1.0
    for mod in SUPS.values():  # each package reads the other's pulse
        for name in SUPS:
            assert mod.heartbeat_age_s(pulses[name][1]) < 5.0
    # the port's background thread pulses and keeps the extras
    hb, path = pulses["port"]
    hb.start()
    deadline = time.time() + 5.0
    while time.time() < deadline and tsup.read_heartbeat(path)["time_unix"] <= tp["time_unix"]:
        time.sleep(0.02)
    again = tsup.read_heartbeat(path)
    hb.stop()
    assert again["time_unix"] > tp["time_unix"] and again["epoch"] == 7


def test_liveness_spool_names_and_order_match_jax(tmp_path):
    events = {}
    for name, mod in SUPS.items():
        d = str(tmp_path / name)
        assert mod.read_slice_liveness(d) == []
        paths = [mod.mark_slice_dead(d, 1, "exit rc=-9 (signal 9)", heartbeat_age=3.2,
                                     generation=1),
                 mod.mark_slice_alive(d, 1, 2),
                 mod.mark_slice_dead(d, 0, "heartbeat stale", heartbeat_age=31.0,
                                     generation=2)]
        assert sorted(os.listdir(d)) == [os.path.basename(p) for p in paths]
        events[name] = (sorted(os.listdir(d)), d)
    assert events["port"][0] == events["jax"][0]
    # each package reads the other's spool, in the same order
    for reader in SUPS.values():
        got = [_no_time(reader.read_slice_liveness(events[n][1])) for n in SUPS]
        assert got[0] == got[1]
    assert [(e["event"], e["slice"]) for e in tsup.read_slice_liveness(events["port"][1])] == [
        ("dead", 1), ("alive", 1), ("dead", 0)]


# -- consensus ----------------------------------------------------------------

_PORT_MODEL = MSANNet(in_size=4, hidden_sizes=(3,), out_size=2)


def _seal_jax(ckpt_dir, rnd, sha):
    state = JTrainState(params={"w": jnp.full((3,), float(rnd))}, batch_stats={}, opt_state={},
                        engine_state={}, rng=jax.random.PRNGKey(0),
                        round=jnp.asarray(rnd, jnp.int32))
    jckpt.save_checkpoint(os.path.join(ckpt_dir, "checkpoint_latest.msgpack"), state,
                          meta={"round": rnd, "epoch": rnd // 2, "params_sha256": sha},
                          rotate=True)


def _seal_port(ckpt_dir, rnd, sha):
    params = {k: torch.full_like(v.detach(), float(rnd))
              for k, v in _PORT_MODEL.named_parameters()}
    state = TrainState(params=params, batch_stats=dict(_PORT_MODEL.named_buffers()),
                       opt_state={}, engine_state={}, rng=0, round=rnd, health={})
    tckpt.save_checkpoint(os.path.join(ckpt_dir, "checkpoint_latest.msgpack"), state,
                          meta={"round": rnd, "epoch": rnd // 2, "params_sha256": sha},
                          rotate=True)


def _tear(ckpt_dir):
    with open(os.path.join(ckpt_dir, "checkpoint_latest.msgpack"), "r+b") as fh:
        fh.seek(24)
        fh.write(b"XXXX")  # corrupt the payload past the CRC


# case -> (seals per slice, a slice whose latest is torn, the answer)
CONSENSUS = {
    "newest_agreed": ({0: [(4, "sha4"), (8, "sha8")], 1: [(4, "sha4"), (8, "sha8")]}, None,
                      (8, "sha8")),
    "lagging_slice": ({0: [(4, "sha4"), (8, "sha8")], 1: [(4, "sha4")]}, None, (4, "sha4")),
    "digest_disagrees": ({0: [(4, "sha4")], 1: [(4, "DIVERGED")]}, None, None),
    "torn_latest_prev": ({0: [(4, "sha4"), (8, "sha8")], 1: [(4, "sha4"), (8, "sha8")]}, 0,
                         (4, "sha4")),
}
WRITERS = {"jax": (_seal_jax, _seal_jax), "port": (_seal_port, _seal_port),
           "mixed": (_seal_jax, _seal_port)}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("case", sorted(CONSENSUS))
def test_consensus_matches_jax_on_both_packages_checkpoints(tmp_path, case, writer):
    seals, torn, want = CONSENSUS[case]
    dirs = {sl: tsup.slice_ckpt_dir(str(tmp_path), sl) for sl in seals}
    for sl, rounds in seals.items():
        for rnd, sha in rounds:
            WRITERS[writer][sl](dirs[sl], rnd, sha)
    if torn is not None:
        _tear(dirs[torn])
    for sl, d in dirs.items():
        cands = tsup.slice_ckpt_candidates(d)
        assert cands == jsup.slice_ckpt_candidates(d)
        assert set(cands) == ({r for r, _ in seals[sl]} - ({8} if sl == torn else set()))
    got = {name: mod.consensus_round(dirs) for name, mod in SUPS.items()}
    assert got["port"] == got["jax"]
    if want is None:
        assert got["port"] is None
    else:
        assert got["port"][:2] == want and os.path.exists(got["port"][2])
    if case == "digest_disagrees":  # a slice with no checkpoint: no consensus either
        dirs[2] = tsup.slice_ckpt_dir(str(tmp_path), 2)
        assert tsup.consensus_round(dirs) is None and jsup.consensus_round(dirs) is None


# -- the supervisor over stub workers ------------------------------------------

_STUB = textwrap.dedent("""
    import json, os, signal, sys, time
    out, rank, gen, die_rank = sys.argv[1], int(sys.argv[2]), \\
        int(sys.argv[3]), int(sys.argv[4])
    hb = os.path.join(out, "heartbeats", f"slice_{rank}.json")
    os.makedirs(os.path.dirname(hb), exist_ok=True)
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))
    for i in range(100):
        tmp = hb + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"pid": os.getpid(), "slice": rank, "time_unix": time.time()}, fh)
        os.replace(tmp, hb)
        if gen == 1 and rank == die_rank and i == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        if i >= 6:
            sys.exit(0)
        time.sleep(0.05)
""")

_ALWAYS_DIE = "import os, signal, time\ntime.sleep(0.1)\nos.kill(os.getpid(), signal.SIGKILL)\n"

_WEDGE = textwrap.dedent("""
    import json, os, sys, time
    out, rank, gen = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    hb = os.path.join(out, "heartbeats", f"slice_{rank}.json")
    os.makedirs(os.path.dirname(hb), exist_ok=True)
    with open(hb + ".tmp", "w") as fh:
        json.dump({"pid": os.getpid(), "slice": rank, "time_unix": time.time()}, fh)
    os.replace(hb + ".tmp", hb)
    if gen == 1 and rank == 0:
        time.sleep(600)  # wedged: alive, never beats again
    sys.exit(0)
""")


class RingFlight:
    """A flight recorder's ``note`` and ``dump``, kept in lists."""

    def __init__(self):
        self.notes = []
        self.dumps = []

    def note(self, name, **attrs):
        self.notes.append({"name": name, **attrs})

    def dump(self, reason):
        self.dumps.append(reason)
        return reason


def stub_spawn(out_dir, script: str, args=()):
    """``spawn(rank, generation)`` running ``script`` with the out dir, the
    rank, the generation and ``args``."""
    stub = os.path.join(out_dir, "stub.py")
    with open(stub, "w") as fh:
        fh.write(script)

    def spawn(rank, generation):
        return subprocess.Popen([sys.executable, stub, out_dir, str(rank), str(generation),
                                 *map(str, args)])

    return spawn


# case -> (stub script, its extra args, SliceSupervisor kwargs)
SUPERVISED = {
    "restart_and_complete": (_STUB, (1,), dict(num_processes=2, heartbeat_timeout_s=10.0,
                                               max_restarts=2, grace_s=5.0)),
    "give_up": (_ALWAYS_DIE, (), dict(num_processes=1, heartbeat_timeout_s=10.0,
                                      max_restarts=1, grace_s=2.0)),
    "passthrough_rc": ("import sys; sys.exit(66)", (), dict(num_processes=2, grace_s=2.0,
                                                           passthrough_rcs=(66,))),
    "wedged_heartbeat": (_WEDGE, (), dict(num_processes=1, heartbeat_timeout_s=1.0,
                                          max_restarts=2, poll_s=0.2, grace_s=2.0)),
}
WANT_RC = {"restart_and_complete": 0, "give_up": 128 + signal.SIGKILL, "passthrough_rc": 66,
           "wedged_heartbeat": 0}


def _supervise(mod, bus_cls, out_dir, case):
    script, args, kw = SUPERVISED[case]
    os.makedirs(out_dir)
    flight, bus, calls = RingFlight(), bus_cls(), []
    sup = mod.SliceSupervisor(stub_spawn(out_dir, script, args), out_dir=out_dir,
                              flight=flight, bus=bus, poll_s=kw.pop("poll_s", 0.1),
                              on_consensus=lambda g, dead: calls.append((g, dead)), **kw)
    rc = sup.run()
    events = mod.read_slice_liveness(os.path.join(out_dir, mod.LIVENESS_DIR))
    return {"rc": rc, "restarts": sup.restarts, "generation": sup.generation,
            "consensus": calls,
            "events": [(e["event"], e["slice"], e.get("reason"), e["generation"],
                        e.get("heartbeat_age_s") is not None) for e in events],
            "notes": [n["name"] for n in flight.notes],
            "dumps": [d.split(":hb_age=")[0] for d in flight.dumps],
            "dump_ages": all(":hb_age=" in d for d in flight.dumps),
            "counters": bus.snapshot()["counters"]}


@pytest.mark.parametrize("case", sorted(SUPERVISED))
def test_supervisor_matches_jax_on_stub_workers(tmp_path, case):
    got = {name: _supervise(mod, BUSES[name], str(tmp_path / name), case)
           for name, mod in SUPS.items()}
    assert got["port"] == got["jax"]
    out = got["port"]
    assert out["rc"] == WANT_RC[case]
    if case == "passthrough_rc":
        assert out["restarts"] == 0 and out["events"] == [] and out["dumps"] == []
        return
    deaths = [e for e in out["events"] if e[0] == "dead"]
    assert out["dump_ages"] and len(out["dumps"]) == len(deaths)
    if case == "restart_and_complete":
        assert out["restarts"] == 1 and out["consensus"] == [(1, 1)]
        assert [e[:2] for e in out["events"]] == [("dead", 1), ("alive", 1)]
        assert "signal 9" in out["events"][0][2]
        assert out["notes"].count("fleet-launch") == 2 and out["notes"][-1] == "fleet-complete"
        assert out["counters"] == {'supervisor_slice_deaths_total{slice="1"}': 1,
                                   "supervisor_restarts_total": 1}
    elif case == "give_up":
        assert out["restarts"] == 2 and len(deaths) == 2
        assert out["notes"][-1] == "supervisor-give-up"
    else:
        assert out["restarts"] == 1 and len(deaths) == 1 and "heartbeat" in deaths[0][2]
        assert deaths[0][4]  # the last heartbeat age is recorded
        assert out["counters"]['dcn_heartbeat_timeouts_total{slice="0"}'] == 1
