"""The port's buffered-async rounds against the JAX package: the helpers
(``staleness_weights``, ``default_async_buffers``), whole async epochs of
the small ICA-LSTM of tests/test_torch_port_train.py under dSGD, rankDAD
and powerSGD with ``delay_at`` stragglers and drops, an async epoch where
every site arrives equal to the bulk-sync epoch bit for bit, the buffers
through checkpoints both ways, and the option checks.

The JAX epochs run the Pallas LSTM kernels in interpret mode; the port runs
the kernels' plain versions on the CPU. Both start from one JAX state,
carried across by ``weights.train_state_from_jax``. The tolerances are
those of tests/test_torch_port_train.py, named there; the buffers' ages and
weights are held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    AGG_TOL,
    B,
    C,
    DAD,
    DAD_AGG_SHARE,
    DAD_LOSS_ATOL,
    DAD_MOMENT_SHARE,
    HID,
    ICA,
    IN,
    LOSS_TOL,
    LR,
    MOMENT_TOL,
    PARAM_ATOL,
    PSGD_AGG_SHARE,
    S,
    T,
    W,
    _compare,
    _compare_at_share,
    _flat,
    _sites,
)

from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import base as jbase
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.engines import base as tbase
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.robustness.faults import FaultPlan
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    train_state_from_jax,
    train_state_to_jax,
)

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

BOUND, DECAY = 2, 0.5
EPOCHS = 2
# 4 rounds an epoch: two stragglers of 2 rounds (site 1 from the fit's
# first round, site 0 in rounds 2-3), a drop of site 2 for one round, and
# site 0 gone again for the last 3 rounds (past the bound: its slot ages out)
FAULTS = FaultPlan(delay_at=((1, 0, 2), (0, 2, 2)), drop=((2, 2, 2), (0, 5, 7)))


def _jax_setup(engine_name, pb="32", bound=BOUND, qr=3):
    # the JAX LSTM's plain reference path (the Pallas kernels' own tests
    # hold it against them), which compiles in a fraction of interpret mode
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       use_pallas=False, dropout_rate=0.0)
    task = jsteps.FederatedTask(model)
    engine = make_engine(engine_name, precision_bits=pb,
                         **(DAD if engine_name == "rankDAD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                    jnp.zeros((2, T, C, W)), num_sites=S, staleness_bound=bound)
    epoch = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, quarantine_rounds=qr,
                                       pipeline="device", staleness_bound=bound,
                                       staleness_decay=DECAY)
    return state, epoch


def _port_engine(engine_name, pb="32"):
    if engine_name == "rankDAD":
        return make_rankdad(precision_bits=pb, transposed=leaf_table(ICA).transposed, **DAD)
    if engine_name == "powerSGD":
        return make_powersgd(precision_bits=pb, transposed=leaf_table(ICA).transposed)
    return make_dsgd(pb)


def _port_epoch(engine_name, bound=BOUND, qr=3, **kw):
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       dropout_rate=0.0)
    return tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), _port_engine(engine_name),
                                      tsteps.make_optimizer("adam", LR), quarantine_rounds=qr,
                                      device="cpu", staleness_bound=bound, staleness_decay=DECAY,
                                      **kw)


def _data():
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plans = [jbatching.plan_epoch_positions(sites, B, seed=e).positions for e in range(EPOCHS)]
    return inv, plans


def _run(epoch, state, inv, plans, to_dev, live=True, chunk=None):
    """The epochs of ``plans`` under ``FAULTS`` (every site live with
    ``live=False``), each called in epoch-function calls of ``chunk``
    rounds (the whole epoch when None). Returns the end state, the losses
    and the state after the first call."""
    losses, r0, first = [], 0, None
    for idx in plans:
        step = chunk or idx.shape[1]
        for c in range(0, idx.shape[1], step):
            part = idx[:, c:c + step]
            rounds = part.shape[1]
            mask = (FAULTS.liveness(S, r0, rounds) if live
                    else np.ones((S, rounds), np.float32))
            state, lo = epoch(state, to_dev(inv.inputs), to_dev(inv.labels), to_dev(part),
                              to_dev(mask))
            first = state if first is None else first
            losses.append(np.asarray(lo))
            r0 += rounds
    return state, np.concatenate(losses), first


def test_staleness_weights_and_default_async_buffers_match_jax():
    """``decay ** age`` inside the bound, 0 past it; ``decay ** 0`` is
    exactly 1. Decay 0.5 is exact in both; other decays within one f32 ulp
    (two pow implementations). The fresh buffers' keys, shapes, dtypes and
    values are JAX's."""
    age = np.array([0, 1, 2, 3, 7, jbase.ASYNC_NEVER_AGE, jbase.ASYNC_NEVER_AGE + 1], np.int32)
    assert tbase.ASYNC_NEVER_AGE == jbase.ASYNC_NEVER_AGE
    for bound in (0, 1, 2, 3):
        for decay in (0.5, 0.7, 1.0):
            got = tbase.staleness_weights(torch.from_numpy(age), bound, decay).numpy()
            want = np.asarray(jbase.staleness_weights(jnp.asarray(age), bound, decay))
            assert got.dtype == want.dtype == np.float32 and got[0] == 1.0
            if decay == 0.5:
                assert got.tobytes() == want.tobytes()
            np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
            assert (got[age > bound] == 0).all()
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2)
    task, opt = tsteps.FederatedTask(model), tsteps.make_optimizer("adam", LR)
    assert tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S).buffers is None
    st = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S, staleness_bound=1)
    assert st.overlap is None
    got = train_state_to_jax(st)
    want = jax.tree.map(np.asarray, jbase.default_async_buffers(S, got["params"]))
    gf, wf = _flat(got["buffers"]), _flat(want)
    assert gf.keys() == wf.keys()
    for k in wf:
        assert gf[k].dtype == wf[k].dtype and gf[k].tobytes() == wf[k].tobytes(), k


@pytest.fixture(scope="module", params=["dSGD", "rankDAD", "powerSGD"])
def async_runs(request):
    """One engine's async epochs under ``FAULTS``, JAX's and the port's from
    one initial state, a round a call, and each side's state after the
    first round."""
    name = request.param
    inv, plans = _data()
    state_j, epoch_j = _jax_setup(name)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    # one-round calls: one JAX compile, and the first call is the first round
    end_j, loss_j, one_j = _run(epoch_j, state_j, inv, plans, jnp.asarray, chunk=1)
    end_t, loss_t, one_t = _run(_port_epoch(name), state_t, inv, plans, lambda a: a, chunk=1)
    return name, (one_j, one_t), (jax.tree.map(np.asarray, end_j), loss_j), (end_t, loss_t)


def test_async_first_round_aggregate_matches_jax(async_runs):
    """The first round (site 1 straggling: its never-deposited slot weighs
    nothing): its aggregate, ``mu / (1 - b1)`` after one Adam step, at the
    engine's first-round tolerance of the epoch tests."""
    name, (one_j, one_t), _, _ = async_runs
    agg = lambda mu: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)  # noqa: E731
    got, want = agg(train_state_to_jax(one_t)["opt_state"]["mu"]), agg(one_j.opt_state[0].mu)
    if name == "rankDAD":
        _compare_at_share(got, want, DAD_AGG_SHARE["32"])
    elif name == "powerSGD":
        _compare_at_share(got, want, PSGD_AGG_SHARE["32"])
    else:
        _compare("first-round aggregate", got, want, **AGG_TOL["32"])
    bj = jax.tree.map(np.asarray, one_j.buffers)
    bt = train_state_to_jax(one_t)["buffers"]
    assert bt["age"].tolist() == bj["age"].tolist() == [0, jbase.ASYNC_NEVER_AGE + 1, 0]
    assert bt["weight"].tobytes() == bj["weight"].tobytes()


def test_async_epochs_match_jax(async_runs):
    """Two epochs with stragglers and drops: the losses at the epoch tests'
    tolerance for the engine (``LOSS_TOL``; the low-rank engines
    ``DAD_LOSS_ATOL``), params on the lr scale, the buffers' ages and
    weights equal, their gradients as the Adam moments are held (dSGD
    ``MOMENT_TOL``, the low-rank engines ``DAD_MOMENT_SHARE`` of the
    largest), and every carried leaf finite."""
    name, _, (want, loss_j), (end_t, loss_t) = async_runs
    got = train_state_to_jax(end_t)
    assert loss_t.shape == loss_j.shape and np.isfinite(loss_t).all()
    if name == "dSGD":
        np.testing.assert_allclose(loss_t, loss_j, **LOSS_TOL["32"])
    else:
        np.testing.assert_allclose(loss_t, loss_j, atol=DAD_LOSS_ATOL, rtol=0)
    _compare("params", got["params"], want.params, atol=PARAM_ATOL, rtol=0)
    assert got["buffers"]["age"].tolist() == want.buffers["age"].tolist()
    assert got["buffers"]["weight"].tobytes() == want.buffers["weight"].tobytes()
    # site 0 was away 3 rounds at the end of the second epoch: past the bound
    assert got["buffers"]["age"][0] > BOUND
    if name == "dSGD":
        _compare("buffer grads", got["buffers"]["grads"], want.buffers["grads"],
                 **MOMENT_TOL["32"][0])
    else:
        top = max(np.abs(v).max() for v in _flat(want.buffers["grads"]).values())
        _compare("buffer grads", got["buffers"]["grads"], want.buffers["grads"],
                 atol=DAD_MOMENT_SHARE * top, rtol=0)
    assert end_t.health["skips"].tolist() == want.health["skips"].tolist()


@pytest.mark.parametrize("engine_name", ["dSGD", "rankDAD", "powerSGD"])
def test_all_arrivals_async_equals_bulk_sync_bit_for_bit(engine_name):
    """Every site arriving every round: ``decay ** 0 == 1`` makes each async
    round the bulk-sync round, so params, optimizer and engine state,
    health and losses are equal bit for bit."""
    inv, plans = _data()
    plans = plans[:1]
    torch.manual_seed(0)
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       dropout_rate=0.0)
    state0 = tsteps.init_train_state(tsteps.FederatedTask(model), _port_engine(engine_name),
                                     tsteps.make_optimizer("adam", LR), num_sites=S)
    runs = []
    for bound in (0, BOUND):
        end, losses, _ = _run(_port_epoch(engine_name, bound=bound), state0, inv, plans,
                              lambda a: a, live=False)
        runs.append((train_state_to_jax(end), losses))
    (sync, ls), (asy, la) = runs
    assert ls.tobytes() == la.tobytes()
    assert sync["buffers"] is None and asy["buffers"]["age"].tolist() == [0] * S
    for key in ("params", "batch_stats", "opt_state", "engine_state", "health"):
        gs, ga = _flat(sync[key]), _flat(asy[key])
        assert gs.keys() == ga.keys(), key
        for k in gs:
            assert gs[k].tobytes() == ga[k].tobytes(), f"{key} {k}"


def test_async_buffers_checkpoint_both_ways(async_runs, tmp_path):
    """The port's async state written and read back bit for bit; JAX's
    ``load_checkpoint`` restores the port's buffers, and the port restores
    the buffers JAX writes. A bulk-sync template drops stored buffers, an
    async template restores a bulk-sync file with fresh buffers."""
    name, _, _, (end_t, _) = async_runs
    path = str(tmp_path / "async.msgpack")
    tckpt.save_checkpoint(path, end_t)
    back = tckpt.load_checkpoint(path, end_t)
    bt, gt = _flat(train_state_to_jax(back)["buffers"]), _flat(train_state_to_jax(end_t)["buffers"])
    assert bt.keys() == gt.keys() and all(bt[k].tobytes() == gt[k].tobytes() for k in gt)
    state_j, _ = _jax_setup(name)
    got_j = jax.tree.map(np.asarray, jckpt.load_checkpoint(path, state_j))
    gj = _flat(got_j.buffers)
    assert gj.keys() == gt.keys()
    for k in gt:
        assert gj[k].dtype == gt[k].dtype and gj[k].tobytes() == gt[k].tobytes(), k
    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(jpath, jckpt.load_checkpoint(path, state_j))
    again = _flat(train_state_to_jax(tckpt.load_checkpoint(jpath, end_t))["buffers"])
    assert all(again[k].tobytes() == gt[k].tobytes() for k in gt)
    # tolerant both ways, as JAX's restore
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2)
    task, opt = tsteps.FederatedTask(model), tsteps.make_optimizer("adam", LR)
    plain = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S)
    assert tckpt.load_checkpoint(path, plain).buffers is None
    ppath = str(tmp_path / "plain.msgpack")
    tckpt.save_checkpoint(ppath, plain)
    fresh = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S, staleness_bound=BOUND)
    assert tckpt.load_checkpoint(ppath, fresh).buffers["age"].tolist() == [
        tbase.ASYNC_NEVER_AGE] * S
    four = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=4, staleness_bound=BOUND)
    with pytest.warns(UserWarning, match="staleness buffers"):
        assert tckpt.load_checkpoint(path, four, fallback=False).buffers["weight"].shape == (4,)


def test_async_option_checks_match_jax():
    """The range checks and the exclusion of overlap, with JAX's errors."""
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2)
    task, opt = tsteps.FederatedTask(model), tsteps.make_optimizer("adam", LR)
    jtask = jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                            window_size=W, num_cls=2))
    jopt = jsteps.make_optimizer("adam", LR)
    for kw, match in (({"staleness_bound": -1}, "staleness_bound must be >= 0"),
                      ({"staleness_bound": 1, "staleness_decay": 0.0}, "staleness_decay"),
                      ({"staleness_decay": 1.5}, "staleness_decay"),
                      ({"staleness_bound": 1, "overlap_rounds": True}, "mutually exclusive")):
        with pytest.raises(ValueError, match=match):
            tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jsteps.make_train_epoch_fn(jtask, make_engine("dSGD"), jopt, **kw)
    # the decay is taken at any value while the bound is 0
    tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", staleness_decay=0.9)
