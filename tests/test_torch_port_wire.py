"""The wire codecs (``TrainConfig.wire_quant``, ``wire_stochastic``) of the
port against the JAX package's ``parallel/collectives.py``: each codec bit
for bit (none, bf16, int8, int8 stochastic, fp8; zero, non-finite and
per-row scales; the dither hash over random bit patterns), each engine's
aggregate under a codec on the same gradients, two-round epochs of each
engine with every site on one device (JAX's ``mesh=None``, its plain LSTM),
and the modeled wire bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    DAD,
    DAD_LOSS_ATOL,
    DAD_MOMENT_SHARE,
    HID,
    IN,
    LR,
    PARAM_ATOL,
    B,
    C,
    S,
    T,
    W,
    _compare,
    _flat,
    _sites,
)

from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel import collectives as jcol
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.parallel import collectives as tcol
from dinunet_implementations_tpu_torch.telemetry import metrics as tmetrics
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import leaf_table, train_state_from_jax

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

# (precision_bits, wire_quant, wire_stochastic) of each codec case
CODECS = {"none-32": ("32", "none", False), "none-16": ("16", "none", False),
          "none-16-ieee": ("16-ieee", "none", False), "bf16": ("32", "bf16", False),
          "int8": ("32", "int8", False), "int8-stochastic": ("32", "int8", True),
          "fp8": ("32", "fp8", False)}


def _payload(kind: str) -> np.ndarray:
    """A ``[4, 7, 5]`` payload: gradient-sized values; with a dead (zero)
    row; or with non-finite entries in rows whose other values overflow
    the fp8 grid at scale 1 (JAX: NaN; torch's own cast: 448)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 7, 5)) * 1e-3).astype(np.float32)
    if kind == "zero-row":
        x[1] = 0.0
    elif kind == "non-finite":
        x[2, 0, 0], x[2, 1, 1] = np.inf, 900.0
        x[3, 1, 1], x[3, 2, 2] = np.nan, -1000.0
        x[0, 0, 0] = -np.inf
    return x


def _bits(a: np.ndarray) -> np.ndarray:
    """The f32 bits, with every NaN the same (NaN payloads carry no bits)."""
    a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "zero-row", "non-finite"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_matches_jax_bit_for_bit(codec, batched, kind):
    pb, quant, stochastic = CODECS[codec]
    x = _payload(kind)
    want = np.asarray(jcol.resolve_wire_codec(pb, quant, stochastic).compress(
        jnp.asarray(x), batched=batched))
    got = tcol.resolve_wire_codec(pb, quant, stochastic).compress(
        torch.from_numpy(x), batched=batched).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("codec", ["int8", "int8-stochastic", "fp8", "bf16"])
def test_batched_codec_scales_each_site_as_jax_vmap(codec):
    """``batched=True`` (one scale a site row) is JAX's per-member codec
    under ``vmap``, the form its ``mesh=None`` epoch runs."""
    pb, quant, stochastic = CODECS[codec]
    x = _payload("zero-row")
    c = jcol.resolve_wire_codec(pb, quant, stochastic)
    want = np.asarray(jax.vmap(c.compress)(jnp.asarray(x)))
    got = tcol.resolve_wire_codec(pb, quant, stochastic).compress(torch.from_numpy(x),
                                                                 batched=True).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dither_hash_matches_jax_over_random_bit_patterns(seed):
    """The stochastic rounding's hash over every kind of f32 bit pattern
    (NaNs, infinities, denormals, both signs)."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, size=20000,
                                                dtype=np.uint64).astype(np.uint32)
    v = bits.view(np.float32)
    want = np.asarray(jcol._dither_uniform(jnp.asarray(v)))
    got = tcol._dither_uniform(torch.from_numpy(v.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_fp8_overflow_is_jax_nan_not_torch_saturation():
    v = np.array([447.0, 448.0, 463.9, 464.0, 464.01, 500.0, -465.0, np.inf, -np.inf, np.nan],
                 np.float32)
    codec_j = jcol.resolve_wire_codec("32", "fp8")
    codec_t = tcol.resolve_wire_codec("32", "fp8")
    # scale 1: a non-finite amax keeps the payload's own magnitudes
    want = np.asarray(codec_j.compress(jnp.asarray(v)))
    got = codec_t.compress(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(got[4:]).all() and (got[:4] == 448.0).all()


@pytest.mark.parametrize("codec", list(CODECS))
def test_resolved_codec_matches_jax(codec):
    pb, quant, stochastic = CODECS[codec]
    cj = jcol.resolve_wire_codec(pb, quant, stochastic)
    ct = tcol.resolve_wire_codec(pb, quant, stochastic)
    assert (ct.quant, ct.stochastic) == (cj.quant, cj.stochastic)
    assert ct.dtype.itemsize == np.dtype(cj.dtype).itemsize
    assert str(ct.dtype).split(".")[-1] == np.dtype(cj.dtype).name
    for mod in (jcol, tcol):
        with pytest.raises(ValueError, match="wire_quant must be one of"):
            mod.resolve_wire_codec("32", "int4")
    assert tcol.WIRE_QUANTS == jcol.WIRE_QUANTS and tcol.FP8_E4M3_MAX == jcol.FP8_E4M3_MAX


def test_dcn_codec_is_none_at_one_slice_and_refuses_more():
    """The inter-slice codec, JAX's: ``"none"`` (or ``""`` over a "none"
    wire) is the fused form, ``""`` follows ``wire_quant``; a value of no
    codec is refused as JAX refuses it. An axis of one slice never
    consults it (tests/test_torch_port_slices.py)."""
    for mod in (jcol, tcol):
        assert mod.resolve_dcn_codec("32", "int8", "none") is None
        assert mod.resolve_dcn_codec("32", "none") is None
        assert mod.resolve_dcn_codec("32", "int8").quant == "int8"
        assert mod.resolve_dcn_codec("32", "none", "fp8").quant == "fp8"
        with pytest.raises(ValueError, match="wire_quant must be one of"):
            mod.resolve_dcn_codec("32", "none", "int4")


# -- each engine's aggregate under a codec ----------------------------------------

NS = 4
SHAPES = {"w1": (12, 8), "w2": (8, 6), "b1": (8,), "head": (6, 2)}
WEIGHTS = np.array([16.0, 9.0, 12.0, 5.0], np.float32)
KW_LOWRANK = dict(dad_reduction_rank=3)
KW_DAD = dict(dad_num_pow_iters=2, dad_tol=1e-3)
# the aggregate against JAX's on the same gradients, each leaf at a share of
# its max |aggregate|. dSGD: the codec's payloads are JAX's bit for bit and
# so is the aggregate (measured 0). The low-rank engines: the factors come
# out of the two frameworks' power iterations a few ulps apart; through a
# deterministic grid they stay that close unless a value straddles a
# rounding boundary (measured <= 4.3e-7 of a leaf's max for int8, fp8 and
# bf16), while the stochastic grid hashes each value's own bits, so a
# last-bit difference redraws the dither and about half the values land
# one grid step (1/127 of the factor's amax) apart (measured 1.7e-2
# rankDAD, 2.4e-2 powerSGD)
ENGINE_SHARE = {"dSGD": 0.0, "deterministic": 2e-6, "stochastic": 5e-2}


def _engine_grads(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((NS,) + s).astype(np.float32) for k, s in SHAPES.items()}


def _jax_engine(name, quant, stochastic):
    kw = dict(wire_quant=quant, wire_stochastic=stochastic)
    if name != "dSGD":
        kw.update(KW_LOWRANK)
    if name == "rankDAD":
        kw.update(KW_DAD, fused_poweriter=False)
    return make_engine(name, **kw)


def _port_engine(name, quant, stochastic):
    kw = dict(wire_quant=quant, wire_stochastic=stochastic)
    if name == "dSGD":
        return make_dsgd(**kw)
    if name == "rankDAD":
        return make_rankdad(**KW_LOWRANK, **KW_DAD, **kw)
    return make_powersgd(**KW_LOWRANK, **kw)


@pytest.mark.parametrize("codec", ["int8", "int8-stochastic", "fp8", "bf16"])
@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_engine_aggregate_under_codec_matches_jax(engine, codec):
    _, quant, stochastic = CODECS[codec]
    grads = _engine_grads()
    ej = _jax_engine(engine, quant, stochastic)
    one = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    st1 = ej.init(one)
    st_j = jax.tree.map(lambda a: jnp.stack([a] * NS), st1)
    agg_j, _ = jax.vmap(lambda g, st, w: ej.aggregate(g, st, w, SITE_AXIS),
                        axis_name=SITE_AXIS)({k: jnp.asarray(v) for k, v in grads.items()},
                                             st_j, jnp.asarray(WEIGHTS))
    agg_j = {k: np.asarray(v[0]) for k, v in agg_j.items()}
    st_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), st_j)
    et = _port_engine(engine, quant, stochastic)
    agg_t, _ = et.aggregate({k: torch.from_numpy(v) for k, v in grads.items()}, st_t,
                            torch.from_numpy(WEIGHTS))
    share = ENGINE_SHARE["dSGD" if engine == "dSGD" else
                         "stochastic" if stochastic else "deterministic"]
    for k, want in agg_j.items():
        np.testing.assert_allclose(agg_t[k].numpy(), want, rtol=0,
                                   atol=share * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("codec", ["none-32", "none-16", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_wire_bytes_and_dtype_match_jax(engine, codec):
    pb, quant, stochastic = CODECS[codec]
    kw = dict(precision_bits=pb, wire_quant=quant)
    if engine != "dSGD":
        kw.update(KW_LOWRANK)
    ej = make_engine(engine, **kw)
    et = {"dSGD": make_dsgd, "rankDAD": make_rankdad, "powerSGD": make_powersgd}[engine](**kw)
    one_j = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    one_t = {k: torch.zeros(s) for k, s in SHAPES.items()}
    for pack in (1, 4):
        assert et.wire_bytes(one_t, pack=pack) == ej.wire_bytes(one_j, pack=pack), pack
        assert tmetrics.payload_bytes_of(et, one_t, pack) == float(ej.wire_bytes(one_j, pack))
    assert et.wire_dtype.itemsize == np.dtype(ej.wire_dtype).itemsize
    assert tmetrics.dcn_bytes_of(et, one_t) == 0.0


def test_secure_aggregation_refuses_the_float_grid_codecs_as_jax():
    for quant in ("int8", "fp8"):
        with pytest.raises(ValueError, match="cannot compose with wire_quant"):
            make_dsgd(secure_agg="mask", wire_quant=quant)
        with pytest.raises(ValueError, match="cannot compose with wire_quant"):
            make_engine("dSGD", secure_agg="mask", wire_quant=quant)
    assert make_dsgd(secure_agg="mask", wire_quant="bf16").wire_dtype == torch.int32


# -- two-round epochs under a codec, one device -------------------------------------

ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
ROUNDS = 2
# the first round's aggregate (mu / (1 - b1) after one Adam step) per leaf
# at a share of its max. The two frameworks' gradients part in their last
# bits. Through fp8 (round to nearest) a value moves one grid step (2⁻³ of
# its binade) only where it straddles a rounding boundary. The stochastic
# int8 grid hashes each value's own bits, so a last-bit difference redraws
# its dither and about half the values land one step (1/127 of the site's
# amax) apart: the two runs are two draws of the same unbiased codec
# (measured: 5.6e-2 of cls_fc2/kernel's max for powerSGD). Then, as the
# low-rank cases of test_torch_port_train.py: params on the lr scale, the
# losses at DAD_LOSS_ATOL, the moments at DAD_MOMENT_SHARE of the tree's
# largest, or under the stochastic grid at STOCHASTIC_MOMENT_SHARE (measured
# 12.5 % on rankDAD's cls_fc2/kernel).
EPOCH_SHARE = {"int8-stochastic": 0.1, "fp8": 0.1}
STOCHASTIC_MOMENT_SHARE = 0.25


def _jax_epoch(engine_name, quant, stochastic):
    model = jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       use_pallas=False, dropout_rate=0.0)
    task = jsteps.FederatedTask(model)
    kw = dict(wire_quant=quant, wire_stochastic=stochastic)
    if engine_name == "rankDAD":
        kw.update(DAD, fused_poweriter=False)
    engine = make_engine(engine_name, **kw)
    opt = jsteps.make_optimizer("adam", LR)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                    jnp.zeros((2, T, C, W)), num_sites=S)
    return state, jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="device")


def _port_epoch(state_j, engine_name, quant, stochastic):
    model = tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C, window_size=W, num_cls=2,
                       dropout_rate=0.0)
    kw = dict(wire_quant=quant, wire_stochastic=stochastic)
    tr = leaf_table(ICA).transposed
    engine = {"dSGD": lambda: make_dsgd(**kw),
              "rankDAD": lambda: make_rankdad(transposed=tr, **DAD, **kw),
              "powerSGD": lambda: make_powersgd(transposed=tr, **kw)}[engine_name]()
    epoch = tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), engine,
                                       tsteps.make_optimizer("adam", LR), device="cpu")
    return train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu"), epoch


@pytest.mark.parametrize("codec", ["int8-stochastic", "fp8"])
@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_two_round_epochs_under_codec_match_jax(engine, codec):
    from dinunet_implementations_tpu_torch.weights import train_state_to_jax

    _, quant, stochastic = CODECS[codec]
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    # one epoch of ROUNDS rounds
    plans = [jbatching.plan_epoch_positions(sites, B, seed=0).positions[:, :ROUNDS]]
    state_j, epoch_j = _jax_epoch(engine, quant, stochastic)
    state_t, epoch_t = _port_epoch(state_j, engine, quant, stochastic)
    # the first round's aggregate gradient: mu / (1 - b1) after one Adam step
    one_j, _ = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                       jnp.asarray(plans[0][:, :1]))
    one_t, _ = epoch_t(state_t, inv.inputs, inv.labels, plans[0][:, :1])
    want = _flat(jax.tree.map(lambda m: np.asarray(m) / 0.1, one_j.opt_state[0].mu))
    got = _flat(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                             train_state_to_jax(one_t)["opt_state"]["mu"]))
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=EPOCH_SHARE[codec] * max(np.abs(v).max(), 1e-3 * top),
                                   err_msg=f"first-round aggregate {k}")
    losses_j, losses_t = [], []
    for idx in plans:
        state_j, lj = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                              jnp.asarray(idx))
        state_t, lt = epoch_t(state_t, inv.inputs, inv.labels, idx)
        losses_j.append(np.asarray(lj))
        losses_t.append(lt.numpy())
    np.testing.assert_allclose(np.concatenate(losses_t), np.concatenate(losses_j),
                               atol=DAD_LOSS_ATOL, rtol=0)
    got = train_state_to_jax(state_t)
    want = jax.tree.map(np.asarray, state_j)
    _compare("params", got["params"], want.params, atol=PARAM_ATOL, rtol=0)
    for m in ("mu", "nu"):
        w_m = getattr(want.opt_state[0], m)
        top = max(np.abs(v).max() for v in _flat(w_m).values())
        share = STOCHASTIC_MOMENT_SHARE if stochastic else DAD_MOMENT_SHARE
        _compare(f"adam {m}", got["opt_state"][m], w_m, atol=share * top, rtol=0)
    _compare("health", got["health"], want.health, atol=0, rtol=0)
