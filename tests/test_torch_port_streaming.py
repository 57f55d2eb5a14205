"""The port's streaming lane on the CPU: ``ICALstmStream`` and the session
table against the JAX package's, the streaming engine against JAX's on one
session script, the lane's own guarantees (chunked == replay bit for bit,
stream == batched forward, isolation, restart, the O(1) table, the
refusals), and the microbatcher's admission options against JAX's
``Microbatcher`` on the same requests."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.models.icalstm import ICALstm as JaxICALstm
from dinunet_implementations_tpu.models.icalstm import ICALstmStream as JaxStream
from dinunet_implementations_tpu.serving import InferenceEngine as JaxEngine
from dinunet_implementations_tpu.serving import Microbatcher as JaxMicrobatcher
from dinunet_implementations_tpu.serving import SessionTable as JaxSessionTable
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.models import ICALstm, ICALstmStream
from dinunet_implementations_tpu_torch.runner import registry as treg
from dinunet_implementations_tpu_torch.serving import (
    ChainedFuture,
    InferenceEngine,
    Microbatcher,
    RequestFuture,
    ServingError,
    SessionError,
    SessionTable,
    init_carry_table,
)
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import params_from_jax

# small unidirectional ICA-LSTM: 32 timepoints in windows of 4 -> 8 windows
# of 3 components
ICA = dict(num_components=3, window_size=4, temporal_size=32, window_stride=4, input_size=8,
           hidden_size=6, bidirectional=False)
C, W = 3, 4
ENGINE = dict(row_buckets=(1, 2, 4), stream_buckets=(1, 2), stream_chunk=4, stream_slots=4,
              max_delay_ms=1.0)
STREAM_TOL = 1e-5  # the port against JAX: f32, another summation order
BATCHED_TOL = 1e-6  # stream against the batched forward within one package


def _tcfg(**kw):
    return tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA,
                               ica_args=tconfig.ICAArgs(**{**ICA, **kw}))


def _jcfg(**kw):
    return jconfig.TrainConfig(task_id=jconfig.NNComputation.TASK_ICA).with_overrides(
        {"ica_args": {**ICA, **kw}})


def _jax_weights(seed=0, bidirectional=False):
    model = JaxICALstm(input_size=8, hidden_size=6, num_cls=2, num_comps=C, window_size=W,
                       bidirectional=bidirectional, use_pallas=False)
    params, _ = jsteps.FederatedTask(model).init_variables(jax.random.PRNGKey(seed),
                                                           jnp.zeros((2, 8, C, W)))
    rng = np.random.default_rng(seed)
    stats = {"cls_bn": {"mean": (0.5 * rng.standard_normal(256)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 256).astype(np.float32)}}
    return jax.tree.map(np.asarray, params), stats


def _seq(seed=1, windows=12):
    return np.random.default_rng(seed).normal(size=(windows, C, W)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


@pytest.fixture(scope="module")
def engine(weights):
    params, stats = weights
    eng = InferenceEngine(_tcfg(), params=params, batch_stats=stats, device="cpu", **ENGINE)
    eng.warmup()
    yield eng
    eng.close()


# -- the model --------------------------------------------------------------


def test_stream_model_takes_the_unidirectional_models_parameters(weights):
    params, stats = weights
    sd = params_from_jax(_tcfg(), params, stats)
    stream = ICALstmStream(input_size=8, hidden_size=6, num_comps=C, window_size=W)
    stream.load_state_dict(sd)  # strict: the same names, no more, no fewer
    dense = ICALstm(input_size=8, hidden_size=6, bidirectional=False, num_comps=C, window_size=W)
    assert set(dense.state_dict()) == set(stream.state_dict())
    names = {n for n, _, _ in ICALstm.leaf_table(bidirectional=False).params}
    assert names <= set(stream.state_dict())


def test_stream_model_chunk_by_chunk_matches_jax_with_ragged_padding(weights):
    """Three chunks of 4 steps, each session's tail padded by step_valid = 0
    at its own place: the carry and the probabilities against JAX's
    ``ICALstmStream`` fed the same carry, chunk after chunk."""
    params, stats = weights
    stream = ICALstmStream(input_size=8, hidden_size=6, num_comps=C, window_size=W)
    stream.load_state_dict(params_from_jax(_tcfg(), params, stats))
    jstream = JaxStream(input_size=8, hidden_size=6, num_cls=2, num_comps=C, window_size=W)
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.default_rng(3)
    B, t = 3, 4
    valid = [np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32),
             np.array([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], np.float32),
             np.array([[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32)]
    z = np.zeros((B, 6), np.float32)
    jc = tc = (z, z, z, np.zeros((B,), np.float32))
    for sv in valid:
        x = rng.standard_normal((B, t, C, W)).astype(np.float32)
        jl, jc = jstream.apply(variables, jnp.asarray(x), *map(jnp.asarray, jc), jnp.asarray(sv))
        with torch.no_grad():
            tl, tcar = stream(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a)) for a in tc),
                              torch.from_numpy(sv))
        tc = tuple(a.numpy() for a in tcar)
        jc = tuple(np.asarray(a) for a in jc)
        for got, want in zip(tc[:3], jc[:3]):
            np.testing.assert_allclose(got, want, atol=STREAM_TOL)
        np.testing.assert_array_equal(tc[3], jc[3])
        np.testing.assert_allclose(torch.softmax(tl, -1).numpy(),
                                   np.asarray(jax.nn.softmax(jl, -1)), atol=STREAM_TOL)


def test_invalid_steps_leave_the_carry_bitwise_unchanged(weights):
    params, stats = weights
    stream = ICALstmStream(input_size=8, hidden_size=6, num_comps=C, window_size=W)
    stream.load_state_dict(params_from_jax(_tcfg(), params, stats))
    g = torch.Generator().manual_seed(0)
    carry = tuple(torch.randn((2, 6), generator=g) for _ in range(3)) + (torch.tensor([3.0, 5.0]),)
    with torch.no_grad():
        _, got = stream(torch.randn((2, 4, C, W), generator=g), *carry, torch.zeros((2, 4)))
    for a, b in zip(got, carry):
        assert torch.equal(a, b)


# -- the session table --------------------------------------------------------


def test_session_table_makes_jaxs_decisions_over_a_script():
    script = [("r", "a"), ("r", "b"), ("r", "a"), ("r", "c"), ("r", "d"), ("c", "a"),
              ("r", "e"), ("r", "a"), ("r", "b"), ("r", "f"), ("c", "e"), ("r", "e"),
              ("r", "c"), ("r", "a"), ("c", "c"), ("r", "g"), ("r", "b")]
    ours, theirs = SessionTable(3), JaxSessionTable(3)

    def outcome(table, op, sid):
        try:
            return table.resolve(sid) if op == "r" else table.close(sid)
        except ValueError as e:  # SessionError, in both packages
            return type(e).__name__

    for op, sid in script:
        assert outcome(ours, op, sid) == outcome(theirs, op, sid), (op, sid)
        assert ours.slots == theirs.slots and ours.generations == theirs.generations
        assert (ours.evictions, ours.occupied) == (theirs.evictions, theirs.occupied)
    assert ours.trash_slot == theirs.trash_slot == 3
    for bad in (lambda t: t.resolve(""), lambda t: t.close("nobody")):
        with pytest.raises(SessionError):
            bad(ours)
    with pytest.raises(SessionError):
        SessionTable(0)


def test_carry_table_has_a_trash_row():
    tbl = init_carry_table(4, 6, "cpu")
    assert {k: tuple(v.shape) for k, v in tbl.items()} == {
        "h": (5, 6), "c": (5, 6), "pooled": (5, 6), "count": (5,)}
    assert all(v.dtype == torch.float32 and not v.any() for v in tbl.values())


# -- the engine against JAX's -----------------------------------------------------


def test_engine_streams_a_session_script_like_jax(weights, engine):
    """Three sessions, interleaved, chunked raggedly, one closed and
    restarted: the port's answers against JAX's engine on the same script."""
    params, stats = weights
    script = [("s1", 0, 3), ("s2", 0, 5), ("s1", 3, 9), ("s3", 0, 2), ("s2", 5, 12),
              ("s1", 9, 12), ("close", "s2"), ("s2", 0, 4), ("s3", 2, 11)]
    seqs = {s: _seq(seed=10 + i) for i, s in enumerate(("s1", "s2", "s3"))}
    jeng = JaxEngine(_jcfg(), params=params, batch_stats=stats, **ENGINE)
    jeng.warmup()
    try:
        for step in script:
            if step[0] == "close":
                engine.close_session("port-" + step[1])
                jeng.close_session(step[1])
                continue
            sid, lo, hi = step
            got = engine.stream("port-" + sid, seqs[sid][lo:hi]).result(timeout=30)
            want = jeng.stream(sid, seqs[sid][lo:hi]).result(timeout=30)
            np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), atol=STREAM_TOL)
            assert (got["generation"], got["restarted"]) == (want["generation"], want["restarted"])
    finally:
        jeng.close()


# -- the lane's own guarantees ----------------------------------------------------


def test_streaming_chunked_equals_full_replay(engine):
    seq = _seq()
    replay = engine.stream("replay-full", seq).result()
    for lo in range(0, len(seq), 4):
        last = engine.stream("replay-chunked", seq[lo:lo + 4]).result()
    np.testing.assert_array_equal(last["probs"], replay["probs"])
    for lo, hi in ((0, 2), (2, 5), (5, 12)):  # ragged: 2 + 3 + 7
        last = engine.stream("replay-ragged", seq[lo:hi]).result()
    np.testing.assert_array_equal(last["probs"], replay["probs"])


def test_streaming_matches_the_batched_forward(engine):
    seq = _seq(seed=7, windows=8)
    got = engine.stream("vs-batched", seq).result()["probs"]
    want = engine.submit(seq[None]).result()[0]
    np.testing.assert_allclose(got, want, atol=BATCHED_TOL)
    ref = tsteps.eval_forward(engine.task, torch.from_numpy(seq[None])).numpy()[0]
    np.testing.assert_allclose(got, ref, atol=BATCHED_TOL)


def test_streaming_session_isolation_and_restart(engine):
    a, b = _seq(seed=2), _seq(seed=3)
    solo = engine.stream("iso-solo", a[:4]).result()["probs"]
    r1 = engine.stream("iso-a", a[:4]).result()
    engine.stream("iso-b", b[:4]).result()
    np.testing.assert_array_equal(r1["probs"], solo)
    engine.close_session("iso-a")
    r2 = engine.stream("iso-a", a[:4]).result()
    assert r2["restarted"] and r2["generation"] == 2
    np.testing.assert_array_equal(r2["probs"], solo)


def test_streaming_state_is_o1(engine):
    before = {k: (tuple(v.shape), v.data_ptr()) for k, v in engine._table.items()}
    for _ in range(6):
        engine.stream("long-session", _seq(seed=9)).result()
    assert {k: (tuple(v.shape), v.data_ptr()) for k, v in engine._table.items()} == before
    assert engine._table["count"][engine.sessions.trash_slot] == 0  # the trash row stays clean


def test_concurrent_sessions_from_two_threads_match_sequential_answers(engine):
    seqs = {f"conc-{i}": _seq(seed=20 + i, windows=9) for i in range(4)}
    got = {}

    def client(names):
        for name in names:
            for lo, hi in ((0, 3), (3, 9)):
                got[name] = engine.stream(name, seqs[name][lo:hi]).result(timeout=30)["probs"]

    threads = [threading.Thread(target=client, args=(list(seqs)[k::2],)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for name, seq in seqs.items():
        want = engine.stream("seq-" + name, seq).result(timeout=30)["probs"]
        np.testing.assert_allclose(got[name], want, atol=BATCHED_TOL)


def test_lanes_under_many_threads_and_short_switches_count_every_request(weights):
    """More client threads than cores, a switch interval of a microsecond:
    every request answered, and no count of the engine or its lanes loses
    an update."""
    params, stats = weights
    threads_n, per_thread = 12, 6
    rng = np.random.default_rng(8)
    rows = [rng.standard_normal((1 + i % 4, 8, C, W)).astype(np.float32)
            for i in range(threads_n * per_thread)]
    answers, errors = {}, []
    prev = sys.getswitchinterval()
    with InferenceEngine(_tcfg(), params=params, batch_stats=stats, device="cpu",
                         **{**ENGINE, "stream_slots": 16}) as eng:
        eng.warmup()

        def client(k):
            try:
                for j in range(per_thread):
                    i = k * per_thread + j
                    answers[i] = (eng.submit(rows[i]).result(timeout=60),
                                  eng.stream(f"stress-{k}", rows[i][0, :3]).result(timeout=60))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=client, args=(k,)) for k in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(prev)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        summary = eng.summary()
        lanes = eng._infer_lane.stats, eng._stream_lane.stats
    n = threads_n * per_thread
    assert len(answers) == n
    assert summary["requests"] == 2 * n and summary["stream_chunks"] == n
    assert summary["samples"] == sum(len(r) for r in rows) + n
    assert lanes[0]["requests"] == lanes[1]["requests"] == n
    assert lanes[0]["rows"] == sum(len(r) for r in rows)
    assert summary["stream_sessions"] == threads_n
    for i, (probs, streamed) in answers.items():
        assert probs.shape == (len(rows[i]), 2) and np.isfinite(probs).all()
        assert streamed["generation"] == 1


def test_stream_refusals(weights, engine):
    params, stats = weights
    with pytest.raises(ServingError, match="at least one window"):
        engine.stream("empty", np.zeros((0, C, W), np.float32))
    with pytest.raises(ServingError, match="stream windows must be"):
        engine.stream("shape", np.zeros((4, W, C), np.float32))
    with pytest.raises(ServingError, match="below the largest"):
        InferenceEngine(_tcfg(), params=params, batch_stats=stats, device="cpu",
                        stream_buckets=(1, 4), stream_slots=2)
    bparams, bstats = _jax_weights(bidirectional=True)
    with pytest.raises(ServingError, match="cannot stream"):
        InferenceEngine(_tcfg(bidirectional=True), params=bparams, batch_stats=bstats,
                        device="cpu", streaming=True)
    with InferenceEngine(_tcfg(bidirectional=True), params=bparams, batch_stats=bstats,
                         device="cpu", row_buckets=(2,)) as eng:
        eng.warmup()
        assert not eng.streaming
        with pytest.raises(ServingError, match="bidirectional"):
            eng.stream("s", _seq()[:4])
    for kw in ({"tracer": object()}, {"sink": object()}):
        with pytest.raises(NotImplementedError, match=r"A12 \(b\)"):
            InferenceEngine(_tcfg(), params=params, batch_stats=stats, device="cpu", **kw)


def test_registry_streams_only_the_unidirectional_ica_model():
    ica = treg.get_task(tconfig.NNComputation.TASK_ICA).serving
    assert ica.supports_streaming(_tcfg()) and not ica.supports_streaming(_tcfg(bidirectional=True))
    assert ica.stream_shape(_tcfg()) == (C, W)
    fs = treg.get_task(tconfig.NNComputation.TASK_FREE_SURFER).serving
    assert not fs.supports_streaming(tconfig.TrainConfig())


def test_chained_future_surfaces_the_first_chunks_error():
    first, last = RequestFuture(), RequestFuture()
    first.set_exception(ValueError("chunk 1 died"))
    last.set_result({"probs": np.zeros(2)})
    chained = ChainedFuture([first, last])
    assert chained.done()
    with pytest.raises(ValueError, match="chunk 1 died"):
        chained.result()


# -- the microbatcher's admission against JAX's --------------------------------------


class _Req:
    def __init__(self, tag, n=2, priority=0, deadline_ms=None, session=None):
        self.tag, self.rows = tag, np.zeros((n, 2), np.float32)
        self.priority, self.deadline_ms, self.session = priority, deadline_ms, session
        self.future = RequestFuture()


def _run_scenario(cls, scenario):
    """One admission scenario on a microbatcher class: a blocker holds the
    lane's first dispatch, the scenario's requests pile up, then the lane is
    released. Returns the dispatch order, the sheds and the lane's counts."""
    order, gate, first = [], threading.Event(), threading.Event()

    def dispatch(batch, bucket):
        if not first.is_set():
            first.set()
            gate.wait(10)
        order.append([r.tag for r in batch])
        for r in batch:
            r.future.set_result(None)

    kw = scenario.get("lane", {})
    seen = []  # what on_dispatch hears of each dispatch (not the depth: timing)
    mb = cls(dispatch, buckets=scenario.get("buckets", (2,)), max_delay_ms=kw.pop("delay", 5.0),
             on_dispatch=lambda lane, batch, bucket, rows, depth: seen.append(
                 (lane, [r.tag for r in batch], bucket, rows)), **kw)
    blocker = _Req("blocker", **scenario.get("blocker", {}))
    mb.submit(blocker)
    assert first.wait(10)
    admitted, refused = [blocker], []
    for spec in scenario["reqs"]:
        r = _Req(**spec)
        try:
            mb.submit(r)
            admitted.append(r)
        except RuntimeError as e:  # each package's own RequestError
            refused.append((r.tag, type(e).__name__, "queue full" in str(e)))
    time.sleep(scenario.get("sleep", 0.0))
    gate.set()
    shed = []
    for r in admitted:
        try:
            r.future.result(timeout=10)
        except RuntimeError as e:
            shed.append((r.tag, type(e).__name__, "deadline" in str(e)))
    mb.close()
    return order, refused, shed, seen, {k: mb.stats[k] for k in ("dispatches", "shed", "rejected")}


SCENARIOS = {
    "priority": {"reqs": [dict(tag="lo"), dict(tag="mid", priority=1),
                          dict(tag="hi", priority=5)]},
    "fifo": {"reqs": [dict(tag=i) for i in range(4)]},
    "deadline": {"lane": {"delay": 1.0}, "sleep": 0.05,
                 "reqs": [dict(tag="doomed", deadline_ms=5.0),
                          dict(tag="survivor", deadline_ms=60_000.0)]},
    "max_queue": {"lane": {"delay": 1.0, "max_queue": 1},
                  "reqs": [dict(tag="queued"), dict(tag="refused")]},
    # two chunks of one session never share a dispatch; the other session
    # fills the slot beside the first
    "conflict": {"buckets": (1, 2), "blocker": {"n": 1},
                 "lane": {"rows_of": lambda r: 1, "conflict_key": lambda r: r.session},
                 "reqs": [dict(tag="a1", n=1, session="a"), dict(tag="a2", n=1, session="a"),
                          dict(tag="b1", n=1, session="b"), dict(tag="a3", n=1, session="a")]},
    "oversize": {"reqs": [dict(tag="big", n=3), dict(tag="ok")]},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_microbatcher_admission_matches_jax(name):
    scenario = SCENARIOS[name]
    got, want = (_run_scenario(cls, {**scenario, "lane": dict(scenario.get("lane", {}))})
                 for cls in (Microbatcher, JaxMicrobatcher))
    assert got == want
    if name in ("deadline", "max_queue", "oversize"):
        assert got[1] or got[2]  # something was refused or shed
