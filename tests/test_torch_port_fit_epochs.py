"""The port's host pipeline, eval and metrics against the JAX package: the
host pipeline of ``make_train_epoch_fn`` against the port's device pipeline
(bit for bit) and JAX's host epoch, ``make_eval_fn`` and the metrics, on
the small ICA-LSTM of ``test_torch_port_fit.py`` (its helpers and
tolerances), in a file of its own so that ``pytest --dist loadfile`` can
run it on another worker than the fits.

The JAX side runs on the CPU as its own tests do (``mesh=None``, the scan
LSTM); the port runs the kernels' plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fit import (
    B,
    DAD_LOSS_ATOL,
    LOSS_TOL,
    LR,
    MU_TOL,
    NU_TOL,
    PARAM_ATOL,
    S,
    _compare,
    _jax_state,
    _port_engine,
    _port_task,
    _same_state,
    _sites,
)

from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.trainer import metrics as jmetrics
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.data import api as tdata
from dinunet_implementations_tpu_torch.data import batching as tbatching
from dinunet_implementations_tpu_torch.engines import make_dsgd
from dinunet_implementations_tpu_torch.trainer import metrics as tmetrics
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)


def _live(rounds, epochs):
    """Site 0 drops in round 1 of the first epoch, site 2 in the last round
    of the second."""
    out = []
    for e in range(epochs):
        live = np.ones((S, rounds), np.float32)
        live[0 if e == 0 else 2, 1 if e == 0 else rounds - 1] = 0.0
        out.append(live)
    return out


# (local_iterations, engine, liveness mask)
HOST_CASES = {"L1-dSGD": (1, "dSGD", False), "L2-dSGD-live": (2, "dSGD", True),
              "L1-rankDAD-live": (1, "rankDAD", True)}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_epoch_equals_the_device_epoch_bit_for_bit(case):
    """One plan two ways: the device pipeline gathers each round's batch
    from the resident inventory; the host pipeline takes the plan's dense
    batches and copies each round's block. Same rounds, same bits."""
    L, engine_name, masked = HOST_CASES[case]
    sites = _sites(cls=jdata.SiteArrays)
    _, _, _, state_j = _jax_state(engine_name)
    task = _port_task()
    opt = tsteps.make_optimizer("adam", LR)
    dev_fn = tsteps.make_train_epoch_fn(task, _port_engine(engine_name), opt, L, device="cpu")
    host_fn = tsteps.make_train_epoch_fn(task, _port_engine(engine_name), opt, L, device="cpu",
                                         pipeline="host")
    inv = tdata.stack_site_inventory(sites)
    s_dev = s_host = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    plans = [tbatching.plan_epoch_positions(sites, B, seed=e) for e in range(2)]
    lives = _live(plans[0].steps // L, 2) if masked else [None, None]
    for plan, live in zip(plans, lives):
        s_dev, lo_dev = dev_fn(s_dev, inv.inputs, inv.labels, plan.positions, live)
        fb = tbatching.materialize_plan(sites, plan)
        s_host, lo_host = host_fn(s_host, fb.inputs, fb.labels, fb.weights, live)
        assert lo_host.numpy().tobytes() == lo_dev.numpy().tobytes()
    _same_state(s_host, s_dev)
    if masked:
        assert int(s_host.health["skips"].sum()) == 2


def test_host_epoch_takes_torch_blocks_and_no_poison():
    sites = _sites(cls=jdata.SiteArrays)
    _, _, _, state_j = _jax_state()
    host_fn = tsteps.make_train_epoch_fn(_port_task(), make_dsgd(), tsteps.make_optimizer(
        "adam", LR), device="cpu", pipeline="host")
    st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    fb = tbatching.plan_epoch(sites, B, seed=3)
    a, la = host_fn(st, fb.inputs, fb.labels, fb.weights)
    b, lb = host_fn(st, torch.from_numpy(fb.inputs), torch.from_numpy(fb.labels),
                    torch.from_numpy(fb.weights))
    _same_state(a, b)
    assert la.numpy().tobytes() == lb.numpy().tobytes()
    # the host path takes no NaN gate (its sixth argument is the attack mask,
    # as JAX's host epoch's is)
    with pytest.raises(TypeError):
        host_fn(st, fb.inputs, fb.labels, fb.weights, None, poison=np.zeros((S, 4), np.float32))
    with pytest.raises(ValueError, match="pipeline"):
        tsteps.make_train_epoch_fn(_port_task(), make_dsgd(), tsteps.make_optimizer("adam", LR),
                                   device="cpu", pipeline="scan")


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_epoch_matches_jax_host_epoch(case):
    L, engine_name, masked = HOST_CASES[case]
    sites = _sites()
    task_j, engine_j, opt_j, state_j = _jax_state(engine_name)
    epoch_j = jsteps.make_train_epoch_fn(task_j, engine_j, opt_j, mesh=None,
                                         local_iterations=L, pipeline="host")
    host_fn = tsteps.make_train_epoch_fn(_port_task(), _port_engine(engine_name),
                                         tsteps.make_optimizer("adam", LR), L, device="cpu",
                                         pipeline="host")
    st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    rounds = jbatching.epoch_steps(sites, B) // L
    lives = _live(rounds, 2) if masked else [None, None]
    losses_j, losses_t = [], []
    for e, live in enumerate(lives):
        fb = jbatching.plan_epoch(sites, B, seed=e)
        state_j, lj = epoch_j(state_j, jnp.asarray(fb.inputs), jnp.asarray(fb.labels),
                              jnp.asarray(fb.weights), None if live is None else jnp.asarray(live))
        st, lt = host_fn(st, fb.inputs, fb.labels, fb.weights, live)
        losses_j.append(np.asarray(lj))
        losses_t.append(lt.numpy())
    lj, lt = np.concatenate(losses_j), np.concatenate(losses_t)
    got, want = train_state_to_jax(st), jax.tree.map(np.asarray, state_j)
    if engine_name == "rankDAD":
        np.testing.assert_allclose(lt[0], lj[0], **LOSS_TOL)
        np.testing.assert_allclose(lt, lj, atol=DAD_LOSS_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(lt, lj, **LOSS_TOL)
        _compare("adam mu", got["opt_state"]["mu"], want.opt_state[0].mu, **MU_TOL)
        _compare("adam nu", got["opt_state"]["nu"], want.opt_state[0].nu, **NU_TOL)
    _compare("params", got["params"], want.params, atol=PARAM_ATOL, rtol=0)
    _compare("batch_stats", got["batch_stats"], want.batch_stats, atol=PARAM_ATOL, rtol=0)
    _compare("health", got["health"], want.health, atol=0, rtol=0)
    assert got["round"] == int(want.round) == 2 * rounds


# eval: the same forward in both, f32 sums in another order
PROB_ATOL, SUM_ATOL = 1e-6, 1e-5


@pytest.mark.parametrize("batch", [4, 16])
def test_eval_fn_matches_jax(batch):
    sites = _sites(seed=2, sizes=(9, 17, 0, 5)[:3])
    task_j, _, _, state_j = _jax_state()
    rng = np.random.default_rng(7)
    stats = {"cls_bn": {"mean": rng.standard_normal(256).astype(np.float32) * 0.3,
                        "var": (0.5 + rng.random(256)).astype(np.float32)}}
    state_j = state_j.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    fb = jbatching.plan_eval(sites, batch)
    pj, lj, wj = jsteps.make_eval_fn(task_j)(state_j, jnp.asarray(fb.inputs),
                                             jnp.asarray(fb.labels), jnp.asarray(fb.weights))
    st = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    pt, lt, wt = tsteps.make_eval_fn(_port_task(), device="cpu")(st, fb.inputs, fb.labels,
                                                                  fb.weights)
    assert tuple(pt.shape) == np.asarray(pj).shape == (S, fb.steps, batch, 2)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SUM_ATOL, rtol=0)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    # a padding row's content does not reach the loss: change it, same sums
    pad = fb.weights == 0
    x2 = fb.inputs.copy()
    x2[pad] = 1e3
    _, lt2, _ = tsteps.make_eval_fn(_port_task(), device="cpu")(st, x2, fb.labels, fb.weights)
    np.testing.assert_array_equal(lt2.numpy(), lt.numpy())


def _scores(rng, n, ties=True):
    s = rng.random(n)
    if ties:
        s = np.round(s * 8) / 8  # many ties, some exactly 0.5
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    want, got = jmetrics.ClassificationMetrics(), tmetrics.ClassificationMetrics()
    for _ in range(3):
        n = int(rng.integers(5, 40))
        s, y = _scores(rng, n, ties=seed != 2), rng.integers(0, 2, n)
        w = (rng.random(n) > 0.2).astype(np.float32)
        want.add(s, y, w)
        got.add(s, y, w)
    for name in ("accuracy", "f1", "precision", "recall", "auc", "AUC"):
        np.testing.assert_allclose(got.value(name), want.value(name), atol=1e-12, rtol=0)
    assert got.get() == want.get()
    other_j, other_t = jmetrics.ClassificationMetrics(), tmetrics.ClassificationMetrics()
    other_j.add([0.9, 0.1], [1, 0])
    other_t.add([0.9, 0.1], [1, 0])
    assert got.merge(other_t).auc() == want.merge(other_j).auc()
    assert tmetrics.ClassificationMetrics().auc() == 0.0
    with pytest.raises(ValueError, match="unknown metric"):
        got.value("mcc")


def test_multiclass_metrics_and_averages_match_jax():
    rng = np.random.default_rng(3)
    p = rng.random((60, 4))
    p[:10] = np.round(p[:10] * 4) / 4
    p = p / p.sum(1, keepdims=True)
    y = rng.integers(0, 3, 60)  # class 3 absent: left out of the macro average
    w = (rng.random(60) > 0.1).astype(np.float32)
    want, got = jmetrics.MulticlassMetrics().add(p, y, w), tmetrics.MulticlassMetrics().add(p, y, w)
    for name in ("accuracy", "f1", "precision", "recall", "auc"):
        np.testing.assert_allclose(got.value(name), want.value(name), atol=1e-12, rtol=0)
    a_j, a_t = jmetrics.Averages(), tmetrics.Averages()
    for v, n in ((0.3, 4), (0.7, 0), (1.25, 9)):
        a_j.add(v, n)
        a_t.add(v, n)
    assert a_t.avg == a_j.avg and a_t.get() == a_j.get()
    for new, best, d in ((0.5, None, "maximize"), (0.5, 0.6, "maximize"), (0.5, 0.6, "minimize"),
                         (0.6, 0.6, "maximize")):
        assert tmetrics.is_improvement(new, best, d) == jmetrics.is_improvement(new, best, d)
