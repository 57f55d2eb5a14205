"""The port's replica fleet on the CPU: the shard function and the membership
table against the JAX package's, session affinity, eviction and generations
per shard, supervised restarts (a re-homed session replays bit for bit, a
restarted replica serves the current weights), the fleet bit for bit
against a single engine, and the status and summary keys against JAX's."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.robustness.membership import MembershipTable as JaxTable
from dinunet_implementations_tpu.runner.registry import get_task as jget_task
from dinunet_implementations_tpu.serving import ReplicaSet as JaxReplicaSet
from dinunet_implementations_tpu.serving import home_slot as jax_home_slot
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.robustness import MembershipError, MembershipTable
from dinunet_implementations_tpu_torch.serving import (
    InferenceEngine,
    ReplicaSet,
    ServingError,
    home_slot,
)
from dinunet_implementations_tpu_torch.telemetry import MetricsBus

ICA = dict(num_components=3, window_size=4, temporal_size=32, window_stride=4, input_size=8,
           hidden_size=6, bidirectional=False)
FLEET = dict(row_buckets=(1, 2, 4), stream_buckets=(1, 2), stream_chunk=4, stream_slots=4,
             max_delay_ms=1.0, supervise_interval_s=0.05)
# the keys the port's status and summary add to JAX's
PORT_ONLY = {"device", "pad_rows"}


@pytest.fixture(scope="module")
def env():
    jcfg = jconfig.TrainConfig(task_id=jconfig.NNComputation.TASK_ICA).with_overrides(
        {"ica_args": ICA})
    tcfg = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA).with_overrides(
        {"ica_args": ICA})
    task = jsteps.FederatedTask(jget_task(jcfg.task_id).build_model(jcfg))
    params, stats = task.init_variables(jax.random.PRNGKey(0), jnp.ones((2, 8, 3, 4)))
    return jcfg, tcfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _fleet(env, replicas=2, **kw):
    _, tcfg, params, stats = env
    fleet = ReplicaSet(tcfg, replicas=replicas, params=params, batch_stats=stats,
                       devices=["cpu"], bus=MetricsBus(), **{**FLEET, **kw})
    fleet.warmup()
    return fleet


def _seq(seed=1, windows=12):
    return np.random.default_rng(seed).normal(size=(windows, 3, 4)).astype(np.float32)


def _sid_on(slot, prefix, capacity=2):
    return next(f"{prefix}-{i}" for i in range(1000)
                if home_slot(f"{prefix}-{i}", capacity) == slot)


def _wait_restart(fleet, slot, want, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fleet.restarts >= want and fleet._replica_alive(slot):
            return
        time.sleep(0.02)
    raise AssertionError(f"replica {slot} did not restart in {timeout} s")


# -- host-side pieces against JAX's ---------------------------------------------------


@pytest.mark.parametrize("capacity", [1, 2, 3, 4, 7])
def test_home_slot_equals_jaxs(capacity):
    ids = [f"session-{i}" for i in range(1000)] + ["", "ünïcode", "a" * 300]
    assert [home_slot(s, capacity) for s in ids] == [jax_home_slot(s, capacity) for s in ids]
    assert set(home_slot(s, capacity) for s in ids) == set(range(capacity))


def test_membership_table_transitions_equal_jaxs():
    script = [("join", "a"), ("join", "b"), ("join", "c"), ("leave", "b"), ("join", "d"),
              ("leave", "a"), ("join", "b"), ("join", "e"), ("leave", "c"), ("leave", "e"),
              ("rebalance", 2), ("join", "a"), ("leave", "d"), ("rebalance", 4)]
    ours, theirs = MembershipTable(capacity=4), JaxTable(capacity=4)
    for op, arg in script:
        (ours, *got), (theirs, *want) = getattr(ours, op)(arg), getattr(theirs, op)(arg)
        assert got == want and ours.to_json() == theirs.to_json(), (op, arg)
        np.testing.assert_array_equal(ours.occupancy(), theirs.occupancy())
        assert ours.placements(2) == theirs.placements(2)
    assert MembershipTable.from_json(ours.to_json()) == ours
    with pytest.raises(MembershipError, match="already a member"):
        ours.join(ours.slots[next(i for i, s in enumerate(ours.slots) if s)])
    with pytest.raises(MembershipError, match="not a member"):
        ours.leave("nobody")


# -- affinity and shards --------------------------------------------------------------


def test_sessions_never_split_across_replicas(env):
    fleet = _fleet(env, stream_slots=8)
    try:
        sids = [f"aff-{i}" for i in range(6)]
        for k, sid in enumerate(sids):
            seq = _seq(seed=k)
            for lo in range(0, 12, 4):
                fleet.stream(sid, seq[lo:lo + 4]).result()
            assert fleet.replica_of(sid) == home_slot(sid, 2)
        for sid in sids:
            residents = [i for i, eng in enumerate(fleet._engines)
                         if eng.sessions.slot_of(sid) is not None]
            assert residents == [home_slot(sid, 2)], sid
    finally:
        fleet.close()


def test_eviction_and_generation_discipline_per_shard(env):
    fleet = _fleet(env, stream_slots=2)
    try:
        keeper = _sid_on(1, "keep")
        crowd = [f"evict-{i}" for i in range(40) if home_slot(f"evict-{i}", 2) == 0][:4]
        fleet.stream(keeper, _seq()[:4]).result()
        for sid in crowd:  # 4 sessions through 2 slots
            fleet.stream(sid, _seq()[:4]).result()
        e0, e1 = fleet._engines
        assert e0.sessions.evictions >= 2 and e1.sessions.evictions == 0
        assert e1.sessions.slot_of(keeper) is not None
        victim = crowd[0]
        assert e0.sessions.slot_of(victim) is None
        got = fleet.stream(victim, _seq()[:4]).result()
        assert got["restarted"] and got["generation"] == 2
    finally:
        fleet.close()


# -- supervision --------------------------------------------------------------------


def test_rehomed_session_replays_bit_exact_from_the_fresh_gate(env):
    fleet = _fleet(env)
    try:
        sid = _sid_on(0, "victim")
        seq = _seq(seed=9)
        ref = [fleet.stream(sid, seq[lo:lo + 4]).result()["probs"] for lo in range(0, 12, 4)]
        gen_before = fleet.table.generation_of("replica-0")
        fleet.kill_replica(0)
        _wait_restart(fleet, 0, want=1)
        assert fleet.table.generation_of("replica-0") == gen_before + 1 == 2
        assert fleet.replica_of(sid) is None  # the route went with the slot
        got = [fleet.stream(sid, seq[lo:lo + 4]).result() for lo in range(0, 12, 4)]
        assert got[0]["restarted"] and got[0]["generation"] == 1  # a new table
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a["probs"], b)
        assert fleet.restarts == 1
        fleet.assert_no_compiles()
    finally:
        fleet.close()


def test_a_session_that_moves_is_closed_where_it_was(env):
    """While its home is down a session runs on the next replica; when the
    home is back, the router closes it there, so a later move back cannot
    resume a stale carry."""
    fleet = _fleet(env)
    try:
        sid = _sid_on(0, "mover")
        with fleet._lock:  # hold the supervisor off while slot 0 is down
            fleet.kill_replica(0)
            assert fleet._route_session(sid) == 1
            fleet._engines[1].stream(sid, _seq()[:4]).result()
            assert fleet._engines[1].sessions.slot_of(sid) is not None
            fleet.restart_replica(0)
        assert fleet.stream(sid, _seq()[:4]).result()["restarted"]
        assert fleet.replica_of(sid) == 0
        assert fleet._engines[1].sessions.slot_of(sid) is None
    finally:
        fleet.close()


def test_restarted_replica_serves_the_current_weights(env):
    _, tcfg, params, stats = env
    fleet = _fleet(env)
    try:
        new = jax.tree.map(lambda a: a + np.float32(0.01), params)
        fleet.swap_params(new, stats)
        fleet.kill_replica(0)
        _wait_restart(fleet, 0, want=1)
        sid = _sid_on(0, "w")
        seq = _seq(seed=11)
        got = fleet.stream(sid, seq[:4]).result()["probs"]
        with InferenceEngine(tcfg, params=new, batch_stats=stats, device="cpu", row_buckets=(1,),
                             stream_buckets=(1,), stream_chunk=4, stream_slots=2,
                             max_delay_ms=1.0) as ref_eng:
            ref_eng.warmup()
            want = ref_eng.stream("r", seq[:4]).result()["probs"]
        np.testing.assert_array_equal(got, want)
    finally:
        fleet.close()


# -- the fleet against one engine -------------------------------------------------------


def test_fleet_is_bitwise_a_single_engine_at_every_bucket(env):
    _, tcfg, params, stats = env
    rng = np.random.default_rng(3)
    fleet = _fleet(env)
    try:
        with InferenceEngine(tcfg, params=params, batch_stats=stats, device="cpu",
                             row_buckets=(1, 2, 4), streaming=False, max_delay_ms=1.0) as ref:
            ref.warmup()
            for rows in (1, 2, 3, 4):
                x = rng.normal(size=(rows, 8, 3, 4)).astype(np.float32)
                np.testing.assert_array_equal(fleet.submit(x).result(), ref.submit(x).result())
        swapped = fleet.swap_params(jax.tree.map(lambda a: a - np.float32(0.02), params), stats)
        assert set(swapped["per_replica"]) == {"replica-0", "replica-1"}
        summary = fleet.close()
        assert summary["swaps"] == 2 and summary["compiles_after_warmup"] == 0
        assert summary["requests"] == 4
    except BaseException:
        fleet.close()
        raise


def test_status_and_summary_carry_jaxs_keys(env):
    jcfg, tcfg, params, stats = env
    kw = dict(replicas=2, params=params, batch_stats=stats, row_buckets=(1,),
              stream_buckets=(1,), stream_chunk=4, stream_slots=2, max_delay_ms=1.0)
    x = np.zeros((1, 8, 3, 4), np.float32)
    keys = []
    for cls, extra in ((ReplicaSet, {"devices": ["cpu"]}), (JaxReplicaSet, {})):
        fleet = cls(jcfg if cls is JaxReplicaSet else tcfg, **kw, **extra)
        fleet.warmup()
        fleet.submit(x).result()
        fleet.stream("s", x[0, :4]).result()
        st = fleet.status()
        probes = fleet.health_probes()
        assert all(p() for p in probes.values())
        summary = fleet.close()
        keys.append({"status": set(st), "replica_status": set(st["per_replica"]["replica-0"]),
                     "summary": set(summary), "replica_summary": set(summary["per_replica"][0]),
                     "membership": st["membership"], "probes": set(probes)})
    ours, theirs = keys
    for part in ("status", "summary"):
        assert ours[part] == theirs[part], part
    for part in ("replica_status", "replica_summary"):
        assert theirs[part] <= ours[part], part
        assert ours[part] - theirs[part] <= PORT_ONLY, part
    assert ours["membership"] == theirs["membership"]
    assert ours["probes"] == theirs["probes"]


def test_fleet_refusals(env):
    _, tcfg, params, stats = env
    with pytest.raises(ServingError, match=">= 1 replica"):
        ReplicaSet(tcfg, replicas=0, params={}, devices=["cpu"])
    with pytest.raises(ServingError, match="checkpoint path or explicit"):
        ReplicaSet(tcfg, replicas=1, devices=["cpu"])
    # the shared sink runs (refused before the live plane was ported): a
    # replica-start row, then the replica's and the fleet's summaries
    rows = _Rows()
    with ReplicaSet(tcfg, replicas=1, params=params, batch_stats=stats, devices=["cpu"],
                    sink=rows, row_buckets=(1,)) as traced:
        traced.warmup()
    assert [r["kind"] for r in rows] == ["event", "serve_summary", "serve_summary"]
    assert rows[0]["name"] == "replica-start" and rows.closed == 1
    fleet = ReplicaSet(tcfg, replicas=1, params=params, batch_stats=stats, devices=["cpu"])
    with pytest.raises(ServingError, match="warmup"):
        fleet.submit(np.zeros((1, 8, 3, 4), np.float32))


class _Rows(list):
    """A sink that keeps its rows and counts its closes."""

    closed = 0

    def close(self):
        self.closed += 1
