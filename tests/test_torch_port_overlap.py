"""The port's overlapped rounds against the JAX package: the cases of
tests/test_overlap.py on JAX's own corner (MSANNet 6→8→2, 2 sites, 2
rounds, the host pipeline) run through the port and held against JAX's
epochs, the stash through checkpoints both ways, the corner's overlapped
rounds under rankDAD, and the ICA-LSTM's empty stash.

Tolerances: the corner's dSGD losses and params at ``LOSS_TOL`` /
``AGG_TOL``'s f32 entries of tests/test_torch_port_train.py (f32 sums in
another order); its rankDAD epochs at that file's rankDAD tolerances
(``DAD_LOSS_ATOL``, params on the lr scale). Everything within the port that the JAX file holds bit for bit is
held bit for bit here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_port_train import (
    AGG_TOL,
    C,
    DAD_LOSS_ATOL,
    HID,
    IN,
    LOSS_TOL,
    LR,
    W,
    _compare,
    _flat,
)

from dinunet_implementations_tpu.checks.semantic import TraceCell, build_cell_inputs
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax


@pytest.fixture(scope="module")
def corner():
    """JAX's corner and the port's counterpart: ``(jax epoch fns, port
    epoch fns, JAX state, port state, (x, y, w))``; each side has its
    legacy and its overlapped epoch."""
    task, engine, opt, state, args, _ = build_cell_inputs(TraceCell("dSGD", "vmap", "host"))
    jfns = {ov: jsteps.make_train_epoch_fn(task, engine, opt, overlap_rounds=ov)
            for ov in (False, True)}
    model = MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    tfns = {ov: tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), make_dsgd(),
                                           tsteps.make_optimizer("adam", 1e-2), device="cpu",
                                           pipeline="host", overlap_rounds=ov)
            for ov in (False, True)}
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state), device="cpu")
    xyw = tuple(np.asarray(a) for a in args[1:])
    return jfns, tfns, state, state_t, xyw


def _bits(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(fa[k].tobytes() == fb[k].tobytes() for k in fa)


def _state(st):
    return {k: v for k, v in train_state_to_jax(st).items() if k != "rng"}


def test_first_round_applies_nothing_and_first_apply_is_legacy_bit_exact(corner):
    """Round 0 applies nothing (NaN loss); after 2 rounds the params and the
    optimizer equal the legacy epoch's after round 0, bit for bit in the
    port; the overlapped run is JAX's within f32 tolerance; the stash
    holds round 1, valid everywhere."""
    jfns, tfns, state_j, state_t, (x, y, w) = corner
    s_ov, losses = tfns[True](state_t, x, y, w)
    losses = losses.numpy()
    assert np.isnan(losses[0])
    s_legacy1, l_legacy = tfns[False](state_t, x[:, :1], y[:, :1], w[:, :1])
    got, one = train_state_to_jax(s_ov), train_state_to_jax(s_legacy1)
    assert _bits(got["params"], one["params"]) and _bits(got["opt_state"], one["opt_state"])
    assert losses[1] == l_legacy.numpy()[0]
    assert s_ov.overlap["valid"].tolist() == [1.0] * x.shape[0]
    j_ov, j_losses = jfns[True](state_j, *(jnp.asarray(a) for a in (x, y, w)))
    j_losses = np.asarray(j_losses)
    assert np.isnan(j_losses[0])
    np.testing.assert_allclose(losses[1:], j_losses[1:], **LOSS_TOL["32"])
    want = jax.tree.map(np.asarray, j_ov)
    _compare("params", got["params"], want.params, **AGG_TOL["32"])
    _compare("stash", got["overlap"], want.overlap, **AGG_TOL["32"])


def test_stash_survives_epoch_boundary(corner):
    """Epoch 2's first round applies epoch 1's last stash: a finite loss,
    JAX's within f32 tolerance."""
    jfns, tfns, state_j, state_t, (x, y, w) = corner
    s1, l1 = tfns[True](state_t, x, y, w)
    _, l2 = tfns[True](s1, x, y, w)
    assert np.isnan(l1.numpy()[0]) and np.isfinite(l2.numpy()).all()
    jx = tuple(jnp.asarray(a) for a in (x, y, w))
    j1, _ = jfns[True](state_j, *jx)
    _, jl2 = jfns[True](j1, *jx)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **LOSS_TOL["32"])


def test_overlap_checkpoint_roundtrip_bit_exact(corner, tmp_path):
    """The stash written and read back bit for bit, and the resumed epoch
    equal to the uninterrupted one bit for bit; JAX's ``load_checkpoint``
    restores the port's stash bit for bit, and the port restores the one
    JAX writes."""
    jfns, tfns, state_j, state_t, (x, y, w) = corner
    s1, _ = tfns[True](state_t, x, y, w)
    path = str(tmp_path / "ov.msgpack")
    tckpt.save_checkpoint(path, s1)
    model = MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    like = tsteps.init_train_state(tsteps.FederatedTask(model), make_dsgd(),
                                   tsteps.make_optimizer("adam", 1e-2), num_sites=x.shape[0],
                                   overlap_rounds=True)
    restored = tckpt.load_checkpoint(path, like)
    assert _bits(train_state_to_jax(restored)["overlap"], train_state_to_jax(s1)["overlap"])
    sa, la = tfns[True](s1, x, y, w)
    sb, lb = tfns[True](restored, x, y, w)
    assert _bits(_state(sa), _state(sb)) and la.numpy().tobytes() == lb.numpy().tobytes()
    jlike = jsteps.init_train_state(*_jax_corner_parts(), overlap_rounds=True)
    got_j = jckpt.load_checkpoint(path, jlike)
    assert _bits(jax.tree.map(np.asarray, got_j.overlap), train_state_to_jax(s1)["overlap"])
    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(jpath, got_j)
    again = tckpt.load_checkpoint(jpath, like)
    assert _bits(train_state_to_jax(again)["overlap"], train_state_to_jax(s1)["overlap"])


def _jax_corner_parts():
    task, engine, opt, state, args, _ = build_cell_inputs(TraceCell("dSGD", "vmap", "host"))
    x = args[1]
    return task, engine, opt, jax.random.PRNGKey(0), x[0, 0], x.shape[0]


def test_overlap_resumed_without_flag_drops_stash(corner, tmp_path):
    """An overlapped state run by the plain epoch: the stash is dropped once
    and the plain program runs; a plain template drops a stored stash, an
    overlapped one restores a plain file with an empty stash."""
    _, tfns, _, state_t, (x, y, w) = corner
    s1, _ = tfns[True](state_t, x, y, w)
    s2, l2 = tfns[False](s1, x, y, w)
    assert s2.overlap is None and np.isfinite(l2.numpy()).all()
    path = str(tmp_path / "ov.msgpack")
    tckpt.save_checkpoint(path, s1)
    assert tckpt.load_checkpoint(path, state_t).overlap is None
    ppath = str(tmp_path / "plain.msgpack")
    tckpt.save_checkpoint(ppath, s2)
    like = tsteps.TrainState(**{**vars(state_t), "overlap": tsteps.default_overlap_stash(
        x.shape[0], state_t.params, state_t.batch_stats)})
    assert tckpt.load_checkpoint(ppath, like).overlap["valid"].tolist() == [0.0] * x.shape[0]


def test_overlap_liveness_applies_to_the_data_round(corner):
    """Every site dead in round 0: round 0's stash applies at round 1 and
    holds the params (NaN loss), as JAX's does; with every site live the
    params move."""
    jfns, tfns, state_j, state_t, (x, y, w) = corner
    S_, rounds = x.shape[0], x.shape[1]
    all_live = np.ones((S_, rounds), np.float32)
    dead0 = all_live.copy()
    dead0[:, 0] = 0.0
    s_live, l_live = tfns[True](state_t, x, y, w, all_live)
    s_dead, l_dead = tfns[True](state_t, x, y, w, dead0)
    assert np.isnan(l_dead.numpy()[1]) and np.isfinite(l_live.numpy()[1])
    assert _bits(train_state_to_jax(s_dead)["params"], train_state_to_jax(state_t)["params"])
    assert not _bits(train_state_to_jax(s_live)["params"], train_state_to_jax(state_t)["params"])
    _, jl = jfns[True](state_j, *(jnp.asarray(a) for a in (x, y, w)), jnp.asarray(dead0))
    assert np.isnan(np.asarray(jl)[1])


def test_overlap_health_not_counted_on_empty_stash(corner):
    """The empty stash of the first round counts no skip against any site."""
    _, tfns, _, state_t, (x, y, w) = corner
    s1, _ = tfns[True](state_t, x, y, w)
    assert s1.health["skips"].tolist() == [0] * x.shape[0]
    assert s1.health["quarantined"].tolist() == [0] * x.shape[0]


def test_overlap_rejects_buffered_async(corner):
    model = MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), make_dsgd(),
                                   tsteps.make_optimizer("adam", 1e-2), device="cpu",
                                   overlap_rounds=True, staleness_bound=2)


def test_default_overlap_stash_matches_jax():
    """The empty stash of the ICA-LSTM (running statistics too): keys,
    shapes, dtypes and values of JAX's."""
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2)
    st = tsteps.init_train_state(tsteps.FederatedTask(model), make_dsgd(),
                                 tsteps.make_optimizer("adam", LR), num_sites=4,
                                 overlap_rounds=True)
    assert st.buffers is None
    got = train_state_to_jax(st)
    want = jax.tree.map(np.asarray, jsteps.default_overlap_stash(4, got["params"],
                                                                 got["batch_stats"]))
    gf, wf = _flat(got["overlap"]), _flat(want)
    assert gf.keys() == wf.keys() and any(k.startswith("stats/") for k in gf)
    for k in wf:
        assert gf[k].dtype == wf[k].dtype and gf[k].tobytes() == wf[k].tobytes(), k


def test_overlapped_rankdad_epochs_match_jax():
    """rankDAD's overlapped rounds on JAX's corner, two epochs, site 1 dead
    in the first epoch's second round: the first round's NaN, the later
    losses at ``DAD_LOSS_ATOL``, the params on the lr scale of the corner
    (``PARAM_ATOL``'s 2·lr a round, at the corner's lr), the warm-start Ω
    finite with the stash's weights, liveness and validity equal to
    JAX's."""
    task, engine, opt, state, args, _ = build_cell_inputs(TraceCell("rankDAD", "vmap", "host"))
    jfn = jsteps.make_train_epoch_fn(task, engine, opt, overlap_rounds=True)
    model = MSANNet(in_size=6, hidden_sizes=(8,), out_size=2)
    tfn = tsteps.make_train_epoch_fn(
        tsteps.FederatedTask(model), make_rankdad(transposed=model.leaf_table(1).transposed),
        tsteps.make_optimizer("adam", 1e-2), device="cpu", pipeline="host", overlap_rounds=True)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state), device="cpu")
    x, y, w = (np.asarray(a) for a in args[1:])
    S_, rounds = x.shape[:2]
    lj, lt = [], []
    for e in range(2):
        live = np.ones((S_, rounds), np.float32)
        if e == 0:
            live[1, 1] = 0.0
        state, j = jfn(state, *(jnp.asarray(a) for a in (x, y, w, live)))
        state_t, t = tfn(state_t, x, y, w, live)
        lj.append(np.asarray(j))
        lt.append(t.numpy())
    lj, lt = np.concatenate(lj), np.concatenate(lt)
    assert np.isnan(lj[0]) and np.isnan(lt[0]) and np.isfinite(lt[1:]).all()
    np.testing.assert_allclose(lt[1:], lj[1:], atol=DAD_LOSS_ATOL, rtol=0)
    got, want = train_state_to_jax(state_t), jax.tree.map(np.asarray, state)
    _compare("params", got["params"], want.params, atol=2 * 1e-2 * len(lt), rtol=0)
    for k in ("weight", "live", "valid"):
        assert got["overlap"][k].tobytes() == want.overlap[k].tobytes(), k
    assert got["health"]["skips"].tolist() == want.health["skips"].tolist()
    om = {k: v for k, v in _flat(got["engine_state"]).items() if v.dtype != object}
    assert om and all(np.isfinite(v).all() for v in om.values())
