"""The port's telemetry modules against the JAX package's, module by module:
the span tracer, the engines' wire models (``payload_bytes_of``, exact),
``telemetry_summary`` and ``telemetry_log_fields``, the epoch's per-site
round metrics (against JAX's host recompute of the same round, against the
port's own recompute bit for bit, telemetry on against off bit for bit, a
non-finite round), the accumulators in checkpoints both ways, the
sanitizer, the compile cache, the profiler windows and the config's dict
round trip.

The epochs are JAX's telemetry corner (tests/test_telemetry.py
``_epoch_setup``: MSANNet 6→8→2, batch 8) at 3 sites, on the host
pipeline, from JAX's first state (rankDAD's Ω handed across in it). JAX's
own on-device accumulators are not the oracle (ROADMAP C): the oracle is
JAX's host recompute of one round, from JAX's ``tree_sq_sum``, JAX's
per-site gradients and JAX's ``engine.aggregate``. Each tolerance is
stated beside its test.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_privacy import _jax_dp_draw

from dinunet_implementations_tpu.checks import sanitize as jsan
from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.privacy import dpsgd as jdpsgd
from dinunet_implementations_tpu.privacy import personalize as jpers
from dinunet_implementations_tpu.telemetry import metrics as jmetrics
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import logs as jlogs
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.checks import sanitize as tsan
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.ops import _build
from dinunet_implementations_tpu_torch.privacy import dpsgd as tdpsgd
from dinunet_implementations_tpu_torch.privacy.personalize import head_leaf_paths
from dinunet_implementations_tpu_torch.robustness.preemption import Preempted
from dinunet_implementations_tpu_torch.runner.registry import _ica_windows
from dinunet_implementations_tpu_torch.telemetry import NULL_TRACER, SpanTracer, duration
from dinunet_implementations_tpu_torch.telemetry import metrics as tmetrics
from dinunet_implementations_tpu_torch.telemetry import xprof as txprof
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import logs as tlogs
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax

S, B, D, LR = 3, 8, 6, 1e-2
TABLE = MSANNet.leaf_table(1)
DAD = dict(dad_reduction_rank=4, dad_num_pow_iters=3, dad_tol=0.0)
DP = dict(dp_clip=1.0, dp_noise_multiplier=0.5, dp_seed=3)
# the port's round metrics against JAX's host recompute of the same round:
# the gradients of the two packages agree to ~1e-6 relative, and the sums
# of squares reduce in each library's own order. rankDAD's residual holds
# the reconstruction of rank-deficient leaves (MSANNet's per-site gradients
# at batch 8 have rank <= 8 > r = 4, but the r-th singular pairs are close),
# which moves with the last bits of the gradient (ROADMAP C, rankDAD
# aggregate tolerance): 1e-3 relative there
RTOL_GRAD = 1e-5
RTOL_RESIDUAL = {"dSGD": 1e-5, "rankDAD": 1e-3, "trimmed_mean": 1e-5, "dp": 1e-5}
RTOL_UPDATE = 1e-4


# -- the span tracer ------------------------------------------------------------


def test_spans_nest_and_close_across_threads():
    """One tracer serves the loop and another thread: spans nest per
    thread, depths and threads are recorded, inner spans close first."""
    tracer = SpanTracer()

    def worker():
        for _ in range(2):
            with tracer.span("plan-build"):
                pass

    with tracer.span("fit"):
        t = threading.Thread(target=worker, name="worker")
        with tracer.span("epoch"):
            t.start()
            t.join()
    evs = tracer.events()
    by_name = {e["name"]: e for e in evs}
    assert by_name["fit"]["depth"] == 0 and by_name["epoch"]["depth"] == 1
    builds = [e for e in evs if e["name"] == "plan-build"]
    assert len(builds) == 2 and all(e["depth"] == 0 for e in builds)
    assert builds[0]["tid"] != by_name["fit"]["tid"] and builds[0]["thread"] == "worker"
    assert all(e["ok"] for e in evs)
    order = [e["name"] for e in evs]
    assert order.index("epoch") < order.index("fit")
    assert tracer.count("plan-build") == 2 and tracer.total_seconds("fit") >= 0


def test_span_closes_on_preempted():
    tracer = SpanTracer()
    with pytest.raises(Preempted):
        with tracer.span("fit"):
            raise Preempted("signal 15 during epoch 2", signum=15, epoch=2)
    (ev,) = tracer.events()
    assert ev["name"] == "fit" and ev["ph"] == "X" and not ev["ok"]


def test_tracer_outputs_have_jax_s_shape(tmp_path):
    """The Chrome trace and the JSONL of the port's tracer and JAX's, fed
    the same spans, events and counters: the same event phases, names,
    argument keys and row keys (timestamps aside)."""
    from dinunet_implementations_tpu.telemetry.tracer import SpanTracer as JTracer

    def shape(tr, d):
        with tr.span("fit", fold=0):
            tr.event("checkpoint", epoch=1)
            tr.counter("queue-depth", 1)
        chrome = json.load(open(tr.write_chrome_trace(str(d / "trace.chrome.json"))))
        rows = [json.loads(line) for line in open(tr.write_jsonl(str(d / "trace.jsonl")))]
        return ([(e["ph"], e["name"], sorted(e), sorted(e.get("args", {})))
                 for e in chrome["traceEvents"]], chrome["displayTimeUnit"],
                [(r["ph"], r["name"], sorted(r)) for r in rows])

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert shape(SpanTracer(), tmp_path / "t") == shape(JTracer(), tmp_path / "j")
    x = next(e for e in json.load(open(tmp_path / "t" / "trace.chrome.json"))["traceEvents"]
             if e["ph"] == "X")
    assert {"name", "ts", "dur", "pid", "tid"} <= set(x) and x["args"]["fold"] == 0


def test_disabled_tracer_is_a_noop_and_duration_survives_a_stepped_clock(monkeypatch):
    tracer = SpanTracer(enabled=False)
    with tracer.span("fit"):
        tracer.event("x")
        tracer.counter("c", 1)
    assert tracer.events() == [] and NULL_TRACER.events() == []
    cache: dict = {}
    t0 = time.perf_counter()
    monkeypatch.setattr(time, "time", lambda: 1e9)  # the wall clock steps back
    d1 = duration(cache, t0, "time_spent_on_computation")
    monkeypatch.setattr(time, "time", lambda: 4e9)  # and jumps forward
    d2 = duration(cache, t0, "time_spent_on_computation")
    assert 0 <= d1 <= d2 < 60 and cache["time_spent_on_computation"] == [d1, d2]


# -- the wire models --------------------------------------------------------------

MODES = [
    ("dSGD", {}), ("dSGD", {"precision_bits": "16"}), ("dSGD", {"precision_bits": "16-ieee"}),
    ("dSGD", {"robust_agg": "norm_clip"}), ("dSGD", {"robust_agg": "trimmed_mean"}),
    ("dSGD", {"robust_agg": "coordinate_median"}), ("dSGD", {"secure_agg": "mask"}),
    ("dSGD", {"secure_agg": "mask", "robust_agg": "norm_clip"}),
    ("rankDAD", {}), ("rankDAD", {"precision_bits": "16"}),
    ("rankDAD", {"robust_agg": "norm_clip"}), ("rankDAD", {"robust_agg": "coordinate_median"}),
    ("powerSGD", {}), ("powerSGD", {"precision_bits": "16"}),
    ("powerSGD", {"robust_agg": "norm_clip"}), ("powerSGD", {"robust_agg": "trimmed_mean"}),
]


def _port_engine(name, table, **kw):
    if name == "rankDAD":
        return make_rankdad(transposed=table.transposed, **kw)
    if name == "powerSGD":
        return make_powersgd(transposed=table.transposed, leaf_index=table.leaf_index, **kw)
    return make_dsgd(transposed=table.transposed, leaf_index=table.leaf_index, **kw)


@pytest.fixture(scope="module")
def flagship_trees():
    """The flagship ICA-LSTM's (ICAArgs defaults) and a MSANNet's params:
    JAX's as shapes only (``jax.eval_shape``), the port's on the CPU."""
    a = tconfig.ICAArgs()
    jtask = jsteps.FederatedTask(jm.ICALstm(
        input_size=a.input_size, hidden_size=a.hidden_size, num_cls=2,
        num_comps=a.num_components, window_size=a.window_size))
    jica = jax.eval_shape(lambda k: jtask.init_variables(
        k, jnp.zeros((2, _ica_windows(a), a.num_components, a.window_size)))[0],
        jax.random.PRNGKey(0))
    tica = tm.ICALstm(input_size=a.input_size, hidden_size=a.hidden_size, num_cls=2,
                      num_comps=a.num_components, window_size=a.window_size)
    fs = tconfig.FSArgs()
    jfs = jax.eval_shape(lambda k: jsteps.FederatedTask(JMSANNet(
        in_size=fs.input_size, hidden_sizes=fs.hidden_sizes, out_size=2)).init_variables(
        k, jnp.zeros((2, fs.input_size)))[0], jax.random.PRNGKey(0))
    tfs = MSANNet(in_size=fs.input_size, hidden_sizes=fs.hidden_sizes, out_size=2)
    return {"ica": (jica, dict(tica.named_parameters()), tica.leaf_table()),
            "fs": (jfs, dict(tfs.named_parameters()), MSANNet.leaf_table(len(fs.hidden_sizes)))}


@pytest.mark.parametrize("model", ["ica", "fs"])
@pytest.mark.parametrize("name,kw", MODES)
def test_payload_bytes_equal_jax_exactly(flagship_trees, model, name, kw):
    """``payload_bytes_of`` of every engine and mode, at pack 1 and 4, on
    the flagship ICA tree and on MSANNet: JAX's figure as an integer; the
    structured model lists JAX's operands (shapes and item sizes)."""
    jtree, ttree, table = flagship_trees[model]
    jeng, teng = make_engine(name, **kw), _port_engine(name, table, **kw)
    for pack in (1, 4):
        want = jmetrics.payload_bytes_of(jeng, jtree, pack=pack)
        got = tmetrics.payload_bytes_of(teng, ttree, pack=pack)
        assert got == want and teng.wire_bytes(ttree, pack=pack) == int(want)
        shapes = sorted((tuple(s), d.itemsize)
                        for s, d in tmetrics.modeled_wire_shapes(teng, ttree, pack=pack))
        assert shapes == sorted((tuple(s), d.itemsize)
                                for s, d in jmetrics.modeled_wire_shapes(jeng, jtree, pack=pack))
    assert tmetrics.dcn_bytes_of(teng, ttree) == jmetrics.dcn_bytes_of(jeng, jtree) == 0.0


@pytest.mark.parametrize("name", ["dSGD", "rankDAD", "powerSGD"])
def test_payload_bytes_of_the_shared_subtree_equal_jax(flagship_trees, name):
    """Under personalization the wire carries the shared leaves only: the
    port's figure over them is JAX's over its stripped tree."""
    jtree, ttree, table = flagship_trees["ica"]
    jhead = jpers.head_leaf_paths(jtree, ("cls_fc3",))
    jshared = jpers.strip_tree(jtree, jhead, keep_head=False)
    head = head_leaf_paths(ttree, ("cls_fc3",), table)
    tshared = {k: v for k, v in ttree.items() if k not in head}
    assert len(tshared) == len(ttree) - 2
    jeng, teng = make_engine(name), _port_engine(name, table)
    assert tmetrics.payload_bytes_of(teng, tshared) == jmetrics.payload_bytes_of(jeng, jshared)


def test_engine_without_a_wire_model_falls_back_to_dense_leaves():
    e = dataclasses.replace(make_dsgd(), wire_shapes=None, dcn_wire_shapes=None)
    tree = {"a": torch.zeros(3, 4), "b": torch.zeros(5)}
    assert tmetrics.payload_bytes_of(e, tree) == 68.0
    assert tmetrics.modeled_wire_shapes(e, tree) == [((3, 4), torch.float32),
                                                     ((5,), torch.float32)]
    # the inter-slice fallback, JAX's: every leaf's slice partial whole at
    # the inter-slice dtype, else the wire's (0.0 at one slice)
    assert tmetrics.dcn_bytes_of(e, tree, slices=2) == 68.0
    assert tmetrics.dcn_bytes_of(e, tree, slices=1) == 0.0
    e8 = dataclasses.replace(make_dsgd(dcn_wire_quant="int8"), dcn_wire_shapes=None)
    assert tmetrics.dcn_bytes_of(e8, tree, slices=2) == 17.0


# -- the rollups ------------------------------------------------------------------


def _accumulators(seed=0, sites=S, nan_last=True):
    rng = np.random.default_rng(seed)
    t = {k: rng.random(sites).astype(np.float32) * 5 for k in tmetrics.TELEMETRY_KEYS}
    t["rounds"] = np.full(sites, 7, np.int32)
    t["held_rounds"] = np.zeros(sites, np.int32)
    if nan_last:
        t["grad_sq_last"][1] = np.nan
    return t


def test_summary_and_log_fields_equal_jax():
    """The rollup of the same accumulators (a NaN last round at one site),
    and the logs.json fields from it (remote and each site): JAX's, key for
    key and value for value."""
    assert tmetrics.TELEMETRY_KEYS == jmetrics.TELEMETRY_KEYS
    assert tmetrics._INT_KEYS == jmetrics._INT_KEYS
    t = _accumulators()
    got = tmetrics.telemetry_summary({k: torch.from_numpy(v) for k, v in t.items()})
    want = jmetrics.telemetry_summary({k: jnp.asarray(v) for k, v in t.items()})
    np.testing.assert_equal(got, want)
    for i in (None, 0, 1, 2):
        np.testing.assert_equal(tlogs.telemetry_log_fields(got, i),
                                jlogs.telemetry_log_fields(want, i))
    assert tmetrics.telemetry_summary(None) is None and tlogs.telemetry_log_fields(None) == {}
    fresh = tmetrics.default_round_telemetry(S)
    want0 = jmetrics.default_round_telemetry(S)
    for k in tmetrics.TELEMETRY_KEYS:
        assert fresh[k].numpy().dtype == np.asarray(want0[k]).dtype and not fresh[k].any()


def test_tree_sq_sum_adds_in_jax_leaf_order():
    """The port's leaves come in the JAX leaf order (MSANNet's puts
    ``bn_*`` before ``fc_out`` before ``linear_*``); the per-site form
    reduces each ``[S, ...]`` leaf whole. Against JAX's ``tree_sq_sum``
    over the same leaves at 1e-6 relative."""
    rng = np.random.default_rng(4)
    m = MSANNet(in_size=D, hidden_sizes=(8,), out_size=2)
    tree = {k: torch.from_numpy(rng.standard_normal((S,) + tuple(v.shape)).astype(np.float32))
            for k, v in m.named_parameters()}
    order = tmetrics.jax_leaf_order(list(tree))
    assert order == sorted(tree, key=TABLE.leaf_index.__getitem__) and order[0].startswith("bn")
    got = tmetrics.tree_sq_sum(tree, site_axis=True)
    assert got.shape == (S,)
    for s in range(S):
        want = jmetrics.tree_sq_sum({k: jnp.asarray(v[s].numpy()) for k, v in tree.items()})
        np.testing.assert_allclose(got[s].item(), float(want), rtol=1e-6)
        one = tmetrics.tree_sq_sum({k: v[s] for k, v in tree.items()})
        np.testing.assert_allclose(one.item(), got[s].item(), rtol=1e-6)
    with pytest.raises(ValueError, match="empty"):
        tmetrics.tree_sq_sum({}, order=[])


# -- the epoch's round metrics ------------------------------------------------------


def _data(seed=0, steps=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, steps, B, D)).astype(np.float32)
    y = (rng.random((S, steps, B)) > 0.5).astype(np.int32)
    return x, y, np.ones((S, steps, B), np.float32)


def _engines(arm):
    if arm == "rankDAD":
        return (make_engine("rankDAD", fused_poweriter=False, **DAD),
                make_rankdad(transposed=TABLE.transposed, **DAD))
    if arm == "trimmed_mean":
        return (make_engine("dSGD", robust_agg="trimmed_mean"),
                make_dsgd(robust_agg="trimmed_mean"))
    return make_engine("dSGD"), make_dsgd()


def _jax_first_state(jeng):
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, jeng, opt, jax.random.PRNGKey(0),
                                    jnp.ones((B, D), jnp.float32), num_sites=S)
    return task, opt, state


def _port_epoch(teng, epoch_kw=None, telemetry=True, capture=None):
    """The port's epoch of the corner; ``capture`` (a list) receives each
    round's engine input, aggregate and optimizer update."""
    opt = tsteps.make_optimizer("adam", LR)
    if capture is not None:
        inner, upd = teng.aggregate, opt.update

        def aggregate(grads, state, weight, live=None, rnd=None):
            agg, es = inner(grads, state, weight, live=live, rnd=rnd)
            capture.append({"grads": grads, "agg": agg})
            return agg, es

        def update(grads, state):
            u, st = upd(grads, state)
            capture[-1]["updates"] = u
            return u, st

        teng = dataclasses.replace(teng, aggregate=aggregate)
        opt = dataclasses.replace(opt, update=update)
    task = tsteps.FederatedTask(MSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    return tsteps.make_train_epoch_fn(task, teng, opt, device="cpu", pipeline="host",
                                      telemetry=telemetry, **(epoch_kw or {}))


def _jax_host_recompute(task, jeng, opt, state, x, y, w, dp=None):
    """JAX's host recompute of ONE round (local_iterations 1, every site
    live): each site's gradient by JAX's model and ``cross_entropy``, JAX's
    DP transform when given, JAX's ``engine.aggregate`` over the site axis,
    then JAX's ``tree_sq_sum`` of each site's gradient, of its distance to
    the aggregate and of the optimizer's update. Returns numpy ``(gsq [S],
    rsq [S], usq)``."""
    def loss_fn(params, stats, xb, yb, wb):
        logits, new_stats = task.apply(params, stats, xb, train=True,
                                       rng=jax.random.PRNGKey(0), mask=wb, mutable=True)
        return jsteps.cross_entropy(logits, yb, wb), new_stats

    grad_fn = jax.grad(loss_fn, has_aux=True)

    def site(es, xb, yb, wb):
        ix = jax.lax.axis_index(SITE_AXIS)
        g, _ = grad_fn(state.params, state.batch_stats, xb, yb, wb)
        n = wb.sum()
        g = jax.tree.map(lambda a: a * n / jnp.maximum(n, 1.0), g)
        if dp is not None:
            g = dp(g, state.round, ix)
        agg, _ = jeng.aggregate(g, es, n, SITE_AXIS, live=jnp.asarray(1.0), rnd=state.round)
        return (jmetrics.tree_sq_sum(g),
                jmetrics.tree_sq_sum(jax.tree.map(lambda a, b: a - b, g, agg)), agg)

    gsq, rsq, agg = jax.vmap(site, axis_name=SITE_AXIS)(
        state.engine_state, jnp.asarray(x[:, 0]), jnp.asarray(y[:, 0]), jnp.asarray(w[:, 0]))
    updates, _ = opt.update(jax.tree.map(lambda a: a[0], agg), state.opt_state, state.params)
    return np.asarray(gsq), np.asarray(rsq), float(jmetrics.tree_sq_sum(updates))


@pytest.mark.parametrize("arm", ["dSGD", "rankDAD", "trimmed_mean", "dp"])
def test_round_metrics_match_jax_host_recompute(monkeypatch, arm):
    """One round of the port's telemetry epoch from JAX's first state
    (rankDAD's Ω in it): each site's squared gradient norm at RTOL_GRAD,
    the residual at RTOL_RESIDUAL[arm], the update's squared norm at
    RTOL_UPDATE (Adam's first step divides by √ν), against JAX's host
    recompute; payload_bytes JAX's exactly; rounds 1. The DP arm draws
    JAX's noise on both sides."""
    epoch_kw, dp = {}, None
    if arm == "dp":
        monkeypatch.setattr(tdpsgd, "default_draw", _jax_dp_draw)
        epoch_kw, dp = DP, jdpsgd.make_dp_fn(**DP)
    jeng, teng = _engines(arm)
    task, opt, state_j = _jax_first_state(jeng)
    x, y, w = _data()
    gsq, rsq, usq = _jax_host_recompute(task, jeng, opt, state_j, x, y, w, dp)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    out, _ = _port_epoch(teng, epoch_kw)(state_t, x, y, w)
    t = {k: v.numpy() for k, v in out.telemetry.items()}
    np.testing.assert_allclose(t["grad_sq_last"], gsq, rtol=RTOL_GRAD)
    np.testing.assert_array_equal(t["grad_sq_sum"], t["grad_sq_last"])
    np.testing.assert_array_equal(t["grad_sq_max"], t["grad_sq_last"])
    np.testing.assert_allclose(t["residual_sq_sum"], rsq, rtol=RTOL_RESIDUAL[arm])
    np.testing.assert_allclose(t["update_sq_last"], np.full(S, usq, np.float32),
                               rtol=RTOL_UPDATE)
    assert (t["payload_bytes"] == jmetrics.payload_bytes_of(jeng, state_j.params)).all()
    assert (t["rounds"] == 1).all() and not t["held_rounds"].any() and not t["dcn_bytes"].any()


@pytest.mark.parametrize("arm", ["dSGD", "rankDAD", "trimmed_mean", "dp"])
def test_round_metrics_equal_the_port_s_recompute_bit_for_bit(arm):
    """Three rounds: the accumulators equal ``tree_sq_sum`` of the same
    rounds' engine inputs, aggregates and updates (captured as the epoch
    ran), added in the epoch's order, bit for bit."""
    jeng, teng = _engines(arm)
    _, _, state_j = _jax_first_state(jeng)
    cap: list = []
    x, y, w = _data(1, steps=3)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    out, _ = _port_epoch(teng, DP if arm == "dp" else None, capture=cap)(state_t, x, y, w)
    assert len(cap) == 3
    order = tmetrics.jax_leaf_order(list(state_t.params))
    zero = torch.zeros(S)
    gsum, gmax, rsum, usum = zero, zero, zero, torch.zeros(())
    for c in cap:
        g = tmetrics.tree_sq_sum(c["grads"], order, site_axis=True)
        r = tmetrics.tree_sq_sum({k: c["grads"][k] - c["agg"][k] for k in order}, order,
                                 site_axis=True)
        u = tmetrics.tree_sq_sum(c["updates"], order)
        gsum, gmax, rsum, usum = gsum + g, torch.maximum(gmax, g), rsum + r, usum + u
    t = out.telemetry
    for k, want in (("grad_sq_last", g), ("grad_sq_sum", gsum), ("grad_sq_max", gmax),
                    ("residual_sq_sum", rsum), ("update_sq_last", zero + u),
                    ("update_sq_sum", zero + usum)):
        assert t[k].numpy().tobytes() == want.numpy().tobytes(), k
    assert (t["rounds"] == 3).all()


def _flat(tree, prefix=""):
    """Every tensor of a state's trees by path (None leaves left out)."""
    if isinstance(tree, tsteps.TrainState):
        tree = {f: getattr(tree, f) for f in ("params", "batch_stats", "opt_state",
                                              "engine_state", "health", "buffers", "overlap",
                                              "personal")}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.mark.parametrize("arm,epoch_kw", [
    ("dSGD", {}), ("rankDAD", {}), ("trimmed_mean", {}), ("dSGD", DP),
    ("dSGD", {"overlap_rounds": True}), ("dSGD", {"staleness_bound": 2}),
    ("dSGD", {"quarantine_rounds": -1}), ("dSGD", {"personalize": ("fc_out",)}),
])
def test_telemetry_on_state_equals_off_bit_for_bit(arm, epoch_kw):
    """Two epochs with the round metrics and two without, from one state:
    losses, params, optimizer, engine state, health, buffers and stash
    equal bit for bit (the metrics only read); the off epoch carries no
    accumulators, and an off epoch fed an on state drops them. In the
    overlapped mode the empty stash's first round counts nothing."""
    jeng, teng = _engines(arm)
    _, _, state_j = _jax_first_state(jeng)
    runs = {}
    for on in (False, True):
        st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
        fn = _port_epoch(teng, epoch_kw, telemetry=on)
        losses = []
        for e in range(2):
            st, lo = fn(st, *_data(e, steps=2))
            losses.append(lo.numpy())
        runs[on] = (st, np.concatenate(losses))
    (off, loff), (on, lon) = runs[False], runs[True]
    assert loff.tobytes() == lon.tobytes()
    a, b = _flat(off), _flat(on)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
    assert off.telemetry is None
    rounds = 3 if epoch_kw.get("overlap_rounds") else 4
    assert (on.telemetry["rounds"] == rounds).all()
    assert _port_epoch(teng, epoch_kw, telemetry=False)(on, *_data(3))[0].telemetry is None


def test_nonfinite_round_poisons_last_not_sums():
    """Site 1's second round is NaN: its last value is NaN, the sums and
    the max stay finite (the first round's), the other sites are finite."""
    x, y, w = _data(2, steps=2)
    x[1, 1] = np.nan
    _, _, state_j = _jax_first_state(make_engine("dSGD"))
    st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    out, _ = _port_epoch(make_dsgd())(st, x, y, w)
    t = {k: v.numpy() for k, v in out.telemetry.items()}
    assert np.isnan(t["grad_sq_last"][1]) and np.isfinite(t["grad_sq_last"][[0, 2]]).all()
    for k in ("grad_sq_sum", "grad_sq_max", "residual_sq_sum", "update_sq_sum"):
        assert np.isfinite(t[k]).all(), k
    assert t["grad_sq_sum"][1] == t["grad_sq_max"][1] > 0
    assert (t["rounds"] == 2).all()


def test_epoch_refills_accumulators_of_other_keys_or_sites():
    """A state whose accumulators lack a key (an older schema) or have
    another site count starts them fresh; matching ones carry on."""
    _, _, state_j = _jax_first_state(make_engine("dSGD"))
    fn = _port_epoch(make_dsgd())
    st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    one, _ = fn(st, *_data())
    two, _ = fn(one, *_data(1))
    assert (two.telemetry["rounds"] == 2).all()
    for bad in ({k: v for k, v in one.telemetry.items() if k != "dcn_bytes"},
                tmetrics.default_round_telemetry(S + 1)):
        again, _ = fn(dataclasses.replace(one, telemetry=bad), *_data(1))
        assert set(again.telemetry) == set(tmetrics.TELEMETRY_KEYS)
        assert (again.telemetry["rounds"] == 1).all()


# -- checkpoints -------------------------------------------------------------------


def test_accumulators_cross_checkpoints_both_ways(tmp_path):
    """JAX's epoch state with its accumulators, written by JAX, restores
    into the port's telemetry-on state with every accumulator equal; the
    port's, written by the port, restores in JAX; an older file gives the
    fresh ones; a telemetry-off resume drops them; another site count warns
    and starts fresh."""
    jeng = make_engine("dSGD")
    task, opt, _ = _jax_first_state(jeng)
    state_j = jsteps.init_train_state(task, jeng, opt, jax.random.PRNGKey(0),
                                      jnp.ones((B, D), jnp.float32), num_sites=S, telemetry=True)
    fn = jsteps.make_train_epoch_fn(task, jeng, opt, mesh=None, telemetry=True)
    state_j, _ = fn(state_j, *(jnp.asarray(a) for a in _data(0, steps=2)))
    pj = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(pj, state_j)
    like = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    assert like.telemetry is not None
    fresh = dataclasses.replace(like, telemetry=tmetrics.default_round_telemetry(S))
    got = tckpt.load_checkpoint(pj, fresh)
    for k in tmetrics.TELEMETRY_KEYS:
        want = np.asarray(state_j.telemetry[k])
        assert got.telemetry[k].numpy().tobytes() == want.tobytes(), k
        assert got.telemetry[k].numpy().dtype == want.dtype
    pt = str(tmp_path / "port.msgpack")
    st, _ = _port_epoch(make_dsgd())(got, *_data(1))
    tckpt.save_checkpoint(pt, st)
    back = jckpt.load_checkpoint(pt, state_j)
    for k in tmetrics.TELEMETRY_KEYS:
        assert np.asarray(back.telemetry[k]).tobytes() == st.telemetry[k].numpy().tobytes(), k
    assert tckpt.load_checkpoint(pt, dataclasses.replace(like, telemetry=None)).telemetry is None
    older = str(tmp_path / "older.msgpack")
    tckpt.save_checkpoint(older, dataclasses.replace(st, telemetry=None))
    assert tckpt.load_checkpoint(older, fresh).telemetry is fresh.telemetry
    other = dataclasses.replace(like, telemetry=tmetrics.default_round_telemetry(S + 1))
    with pytest.warns(UserWarning, match="telemetry accumulators"):
        assert tckpt.load_checkpoint(pt, other).telemetry is other.telemetry


# -- the sanitizer --------------------------------------------------------------------

SANITIZE_VALUES = ["", "0", "false", "off", "no", "1", "true", "on", "yes", "all", " ALL ",
                   "compile", "nans", "leaks", "compile,nans", " compile , leaks ,", "nans,nans",
                   None]


@pytest.mark.parametrize("value", SANITIZE_VALUES)
def test_sanitize_flags_equal_jax(monkeypatch, value):
    monkeypatch.setenv(tsan.ENV_VAR, "compile,leaks")
    assert tsan.ENV_VAR == jsan.ENV_VAR and tsan.ALL_FLAGS == jsan.ALL_FLAGS
    assert tsan.sanitize_flags(value) == jsan.sanitize_flags(value)


def test_sanitize_flags_refuse_unknown_flags_as_jax_does():
    for mod in (tsan, jsan):
        with pytest.raises(ValueError, match="unknown sanitizer flag"):
            mod.sanitize_flags("compile,bogus")


class _Watched:
    def __init__(self, n):
        self.n = n

    def compiles_after_first_epoch(self):
        return {"kernel_builds": self.n, "kernel_loads": 0}


def test_sanitized_fit_guards_builds_after_the_first_epoch():
    """Off: yields None. ``compile``: passes a fit that built nothing after
    its first epoch and raises, with the result's context, for one that
    did. ``leaks`` alone checks nothing. ``nans`` runs the body under
    autograd's anomaly mode."""
    with tsan.sanitized_fit(_Watched(1), flags=()) as rep:
        assert rep is None
    with tsan.sanitized_fit(_Watched(0), flags={"compile"}) as rep:
        rep.note_result({"best_val_epoch": 2, "site_health": {"site_skipped_rounds": [0]}})
    with pytest.raises(tsan.SanitizerViolation, match="after its first epoch") as e:
        with tsan.sanitized_fit(_Watched(1), label="dSGD/fold0", flags={"compile"}) as rep:
            rep.note_result({"best_val_epoch": 2, "state": tsteps.TrainState(
                {}, {}, {}, {}, 0, 7, {})})
    assert "round=7" in str(e.value) and "[dSGD/fold0]" in str(e.value)
    with tsan.sanitized_fit(_Watched(5), flags={"leaks"}) as rep:
        assert rep is not None
    with tsan.sanitized_fit(_Watched(0), flags={"nans"}):
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


# -- the compile cache ----------------------------------------------------------------


def test_compile_cache_moves_the_library_root(monkeypatch, tmp_path):
    """``enable_compile_cache`` points the library root at the directory
    (made if missing; idempotent), and the source hash keys it: a library
    file put there by another process is found without a build."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    old = _build.build_dir()
    root = _build.enable_compile_cache(tmp_path / "kcache")
    assert root == (tmp_path / "kcache").resolve() and root.is_dir()
    assert _build.enable_compile_cache(str(tmp_path / "kcache")) == root
    assert _build.build_dir() == root / old.name
    d = _build.build_dir()
    d.mkdir(parents=True)
    for src in _build._sources():
        (d / f"lib{src.stem}.so").write_bytes(b"")
    builds = _build.BUILDS
    assert set(_build.build_all()) == {s.stem for s in _build._sources()}
    assert _build.BUILDS == builds


# -- the profiler windows -----------------------------------------------------------------


def test_xprof_window_captures_its_epoch_range(tmp_path):
    """A (2, 3) window over epochs 1..4 runs the CPU profiler for epochs 2
    and 3 only and writes one trace under <dir>/<label>; a resume whose
    first epoch is 3 still captures (a range test)."""
    w = txprof.XprofWindow(str(tmp_path / "xp"), (2, 3), "fold_0")
    active = []
    for e in range(1, 5):
        w.epoch_begin(e)
        active.append(w.active)
        torch.randn(8, 8).sum()
        w.epoch_end(e)
    assert active == [False, True, True, False]
    files = txprof.trace_files(str(tmp_path / "xp"))
    assert files == [w.path] and "/fold_0/" in w.path
    assert isinstance(json.load(open(w.path))["traceEvents"], list)
    resumed = txprof.XprofWindow(str(tmp_path / "xr"), (2, 3), "fold_0")
    resumed.epoch_begin(3)
    assert resumed.active
    resumed.epoch_end(3)
    assert not resumed.active and len(txprof.trace_files(str(tmp_path / "xr"))) == 1
    idle = txprof.XprofWindow("", (1, 1))
    idle.epoch_begin(1)
    assert not idle.active


def test_summarize_device_ops_reads_kernel_events(tmp_path):
    """Kernel events (category ``kernel``) by total time, longest first;
    host operators and runtime calls are not counted; a capture without
    CUDA activity (the CPU) lists none; no trace raises."""
    d = tmp_path / "cap"
    d.mkdir()
    evs = [{"ph": "X", "cat": "kernel", "name": "dn_k1", "dur": 5.0},
           {"ph": "X", "cat": "kernel", "name": "dn_k2", "dur": 9.0},
           {"ph": "X", "cat": "kernel", "name": "dn_k1", "dur": 6.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelEx", "dur": 50.0}]
    (d / f"h_1.2{txprof.TRACE_SUFFIX}").write_text(json.dumps({"traceEvents": evs}))
    assert txprof.summarize_device_ops(str(d)) == [
        {"name": "dn_k1", "total_us": 11.0, "count": 2},
        {"name": "dn_k2", "total_us": 9.0, "count": 1}]
    assert txprof.summarize_device_ops(str(d), top=1)[0]["name"] == "dn_k1"
    with txprof.capture(str(tmp_path / "cpu")):
        torch.randn(8, 8).sum()
    assert txprof.summarize_device_ops(str(tmp_path / "cpu")) == []
    with pytest.raises(FileNotFoundError):
        txprof.summarize_device_ops(str(tmp_path / "none"))


# -- the config -------------------------------------------------------------------------


def _shared_fields(a: dict, b: dict) -> tuple:
    """The fields both dicts have, nested one level (the args blocks)."""
    def cut(d, other):
        return {k: (cut(v, other[k]) if isinstance(v, dict) and isinstance(other.get(k), dict)
                    else v) for k, v in d.items() if k in other}
    return cut(a, b), cut(b, a)


def test_config_telemetry_fields_and_dict_round_trip_equal_jax():
    """``telemetry_dir`` and ``xprof_window`` with JAX's defaults;
    ``to_dict`` is ``dataclasses.asdict``; ``with_overrides`` of the dict
    (through JSON) gives what JAX's gives: every top-level field back, and
    the flat fields that a task-args block shares (``log_header``) set in
    the block as well, as JAX's round trip does."""
    t, j = tconfig.TrainConfig(), jconfig.TrainConfig()
    assert (t.telemetry_dir, t.xprof_window) == (j.telemetry_dir, j.xprof_window) == ("", (1, 1))
    kw = dict(telemetry="on", telemetry_dir="tel", xprof_window=(2, 5), epochs=4,
              personalize=("fc_out",), log_header="loss|auc|f1")
    cfg, jcfg = t.replace(**kw), j.replace(**kw)
    d = cfg.to_dict()
    assert d == dataclasses.asdict(cfg) and d["xprof_window"] == (2, 5)
    back = tconfig.TrainConfig().with_overrides(json.loads(json.dumps(d)))
    jback = jconfig.TrainConfig().with_overrides(json.loads(json.dumps(jcfg.to_dict())))
    for f in dataclasses.fields(tconfig.TrainConfig):
        if f.name not in ("fs_args", "ica_args", "smri3d_args", "multimodal_args"):
            assert getattr(back, f.name) == getattr(cfg, f.name), f.name
    assert back.ica_args.log_header == jback.ica_args.log_header == "loss|auc|f1"
    got, want = _shared_fields(dataclasses.asdict(back), dataclasses.asdict(jback))
    assert got == want
