"""The slice tier over processes (parallel/mesh.py ``sliced_site_mesh``,
parallel/collectives.py's three-level reductions, the engines'
``dcn_wire_quant``, the slice-liveness mask and the quorum in the epoch)
against the JAX package's ``sliced_site_mesh(2, S // 2, K)`` on the
conftest's virtual CPU devices.

Two spawned gloo worlds lay two slices over their ranks, K = 2 sites a
rank: 2 slices x 1 rank (S = 4) and 2 slices x 2 ranks (S = 8, the one
world with an intra-slice tier). In each, every engine's epochs run the
FUSED form (bit for bit the unsliced world of the same size, and JAX's
sliced epoch at the f32 wire's tolerances) and the SPLIT form under the
inter-slice codecs (JAX's sliced split epoch at the codec shares of
tests/test_torch_port_wire.py and tests/test_torch_port_mesh.py); each
engine's split aggregate of one set of gradients is held against JAX's
on its sliced axis, dSGD's bit for bit against JAX's wire run op by op;
a dropped slice equals the same sites dropped through the site mask, and
the flat mesh's site exclusion, bit for bit; the quorum holds a round
with nothing moving, JAX's held count. In one process: the mesh helpers'
and the epoch's checks with JAX's errors, the inter-slice wire models
against JAX's integers, and the worker's flags.

The ranks are Python processes that import torch and the port only; they
join at a free localhost port and fail their test when they outrun
WORLD_TIMEOUT_S.
"""

import inspect
import json
import os
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mesh import ATOL, CODEC_FLIP_LOSS_ATOL, CODEC_FLIP_SHARE, AGG_SHARE, _flat
from test_torch_port_slices_rank import (
    BATCH,
    DCN_CODECS,
    ENGINES,
    EPOCHS,
    SLICE_DROP,
    SLICES,
    STEPS,
    F,
    K,
    engine_kw,
    site_drop,
    sites,
    world_runs,
)
from test_torch_port_wire import KW_LOWRANK, NS, WEIGHTS, _engine_grads

from dinunet_implementations_tpu.core.jaxcompat import shard_map
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.parallel import collectives as jcol
from dinunet_implementations_tpu.parallel import mesh as jmesh
from dinunet_implementations_tpu.runner import dcn_worker as jworker
from dinunet_implementations_tpu.telemetry import metrics as jmetrics
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import TrainConfig as TCfg
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models.msannet import MSANNet as TMSANNet
from dinunet_implementations_tpu_torch.parallel import collectives as tcol
from dinunet_implementations_tpu_torch.parallel import distributed as tdist
from dinunet_implementations_tpu_torch.parallel import mesh as tmesh
from dinunet_implementations_tpu_torch.runner import dcn_worker as tworker
from dinunet_implementations_tpu_torch.runner.fed_runner import auto_site_mesh
from dinunet_implementations_tpu_torch.telemetry import metrics as tmetrics
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
WORLD_TIMEOUT_S = 150


def _data(world: int, seed=3):
    rng = np.random.default_rng(seed)
    S = sites(world)
    x = rng.normal(size=(S, STEPS, BATCH, F)).astype(np.float32)
    y = (rng.random((S, STEPS, BATCH)) > 0.5).astype(np.int32)
    w = np.ones((S, STEPS, BATCH), np.float32)
    return x, y, w


def _jax_engine(engine: str, dcn=None, **extra):
    return make_engine(engine, **engine_kw(engine, dcn), **extra)


def _jax_mesh(world: int, topology: str):
    S = sites(world)
    if topology == "flat":
        return jmesh.packed_site_mesh(S, K)
    return jmesh.sliced_site_mesh(SLICES, S // SLICES, K)


def _jax_epoch(world: int, run: dict, telemetry: bool = False):
    """JAX's state and epoch of a run, on its mesh (or ``mesh=None``)."""
    task = jsteps.FederatedTask(JMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
    eng = _jax_engine(run["engine"], run["dcn"])
    opt = jsteps.make_optimizer("sgd", 1e-2)
    state = jsteps.init_train_state(task, eng, opt, jax.random.PRNGKey(0),
                                    jnp.ones((4, F), jnp.float32), num_sites=sites(world),
                                    telemetry=telemetry)
    mesh = None if run["topology"] is None else _jax_mesh(world, run["topology"])
    return state, jsteps.make_train_epoch_fn(task, eng, opt, mesh, local_iterations=1,
                                              pipeline="host", telemetry=telemetry,
                                              min_slices=run["min_slices"])


def _jax_run(world: int, run: dict, telemetry: bool = False):
    """JAX's epochs of a run: ``(state, losses)``."""
    state, epoch = _jax_epoch(world, run, telemetry)
    x, y, w = (jnp.asarray(a) for a in _data(world))
    live = jnp.asarray(site_drop(world)) if run["live"] else None
    slice_live = jnp.asarray(SLICE_DROP, jnp.float32) if run["slice_live"] else None
    losses = []
    for _ in range(EPOCHS):
        state, lo = epoch(state, x, y, w, live, None, slice_live)
        losses.extend(np.asarray(lo).tolist())
    return jax.tree.map(np.asarray, state), np.array(losses)


CHILD = r'''
import sys, torch
sys.path.insert(0, sys.argv[5])
torch.set_num_threads(1)
import test_torch_port_slices_rank as r
r.main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(tmp, world: int) -> None:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(rank), str(world), port,
                               str(tmp), os.path.join(REPO, "tests")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    deadline, outs = time.monotonic() + WORLD_TIMEOUT_S, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the gloo world of {world} outran {WORLD_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out


def _agg_cases(world: int) -> dict:
    if world == 2:
        return {f"{e}-{c}": (e, c) for e in ENGINES for c in DCN_CODECS}
    return {"dSGD-int8": ("dSGD", "int8")}


def _jax_agg_engine(engine: str, dcn: str):
    extra = dict(KW_LOWRANK) if engine != "dSGD" else {}
    if engine == "rankDAD":
        extra.update(fused_poweriter=False)
    kw = {**engine_kw(engine, dcn), **extra}
    return make_engine(engine, **kw)


def _agg_state(engine, world: int):
    one = {k: jnp.zeros(v.shape[1:], jnp.float32) for k, v in _agg_grads(world).items()}
    return jax.tree.map(lambda a: jnp.stack([a] * sites(world)), engine.init(one))


def _agg_grads(world: int) -> dict:
    """test_torch_port_wire.py's gradients for ``sites(world)`` sites (its
    NS = 4 sites, repeated with a scale for more)."""
    g = _engine_grads()
    reps = sites(world) // NS
    return {k: np.concatenate([v * (1.0 + 0.5 * i) for i in range(reps)]).astype(np.float32)
            for k, v in g.items()}


def _agg_weights(world: int) -> np.ndarray:
    return np.tile(WEIGHTS, sites(world) // NS)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run once: each engine's JAX initial state (as the
    port's), the data and the aggregate inputs, then the ranks."""
    tmp = tmp_path_factory.mktemp("slices")
    for world in WORLDS:
        x, y, w = _data(world)
        np.savez(tmp / f"data{world}.npz", x=x, y=y, w=w)
        for engine in ENGINES:
            state, _ = _jax_epoch(world, {"engine": engine, "dcn": None, "topology": None,
                                          "min_slices": 1})
            torch.save(train_state_from_jax(jax.tree.map(np.asarray, state), device="cpu"),
                       tmp / f"init{world}_{engine}.pt")
        cases = _agg_cases(world)
        torch.save({"grads": {k: torch.from_numpy(v) for k, v in _agg_grads(world).items()},
                    "weight": torch.from_numpy(_agg_weights(world)), "cases": cases,
                    "states": {name: jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                                  _agg_state(_jax_agg_engine(*case), world))
                               for name, case in cases.items()}}, tmp / f"agg_in{world}.pt")
        _spawn(tmp, world)
    return tmp


def _result(worlds, world: int, name: str) -> dict:
    return torch.load(worlds / f"w{world}_result_{name}.pt", weights_only=False)


def _facts(worlds, world: int) -> list:
    return [json.load(open(worlds / f"w{world}_facts{r}.json")) for r in range(world)]


def _assert_close_to_jax(got: dict, want_state, want_losses, engine: str, flips: bool):
    """A world's result against JAX's run at the f32 wire's ``ATOL``
    (tests/test_torch_port_mesh.py), or, where a codec's grid can part the
    two runs, at its ``CODEC_FLIP_SHARE`` of each leaf's max."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0,
                               atol=CODEC_FLIP_LOSS_ATOL if flips else ATOL[engine])
    for part in ("params", "engine_state", "health"):
        g, t = _flat(got["state"][part]), _flat(getattr(want_state, part))
        assert g.keys() == t.keys(), part
        top = max((np.abs(v).max() for v in t.values()), default=0.0)
        for k in t:
            atol = (CODEC_FLIP_SHARE * max(np.abs(t[k]).max(), 1e-3 * top) if flips
                    else ATOL[engine])
            if part == "engine_state" and engine == "rankDAD" and "fc_out" in k:
                # the 2-class head's per-site gradient has rank 1: the second
                # column of each site's Q is rounding noise (test_torch_port_
                # mesh.py's note); the first is the factor
                np.testing.assert_allclose(g[k][..., 0], t[k][..., 0], atol=atol, rtol=0,
                                           err_msg=k)
                assert np.isfinite(g[k]).all() and np.abs(g[k][..., 1]).max() < 1e-3, k
                continue
            np.testing.assert_allclose(g[k], t[k], atol=atol, rtol=0, err_msg=k)


def _assert_equal_states(a: dict, b: dict, parts=("params", "engine_state", "health")):
    for part in parts:
        fa, fb = _flat(a[part]), _flat(b[part])
        assert fa.keys() == fb.keys(), part
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{part}/{k}")


# -- the fused form -----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_fused_form_is_the_unsliced_world_bit_for_bit(worlds, world, engine):
    """One all-reduce over every rank is the unsliced world's collective,
    and the hierarchical gather reassembles the same site order."""
    fused, flat = (_result(worlds, world, f"{engine}-{t}") for t in ("fused", "flat"))
    np.testing.assert_array_equal(fused["losses"], flat["losses"])
    _assert_equal_states(fused["state"], flat["state"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_fused_form_matches_jax_sliced_epoch(worlds, world, engine):
    run = world_runs(world)[f"{engine}-fused"]
    state, losses = _jax_run(world, run)
    _assert_close_to_jax(_result(worlds, world, f"{engine}-fused"), state, losses, engine,
                         flips=False)


def test_every_rank_holds_the_same_params_and_its_slice(worlds):
    for world in WORLDS:
        for name in world_runs(world):
            ranks = [torch.load(worlds / f"w{world}_rank{r}_{name}.pt", weights_only=False)
                     for r in range(world)]
            for k in ranks[0]:
                for other in ranks[1:]:
                    np.testing.assert_array_equal(ranks[0][k], other[k], err_msg=(name, k))
        facts = _facts(worlds, world)
        per = world // SLICES
        for r, f in enumerate(facts):
            m = f["mesh"]
            assert m["shape"] == {"slice": SLICES, "site": per, "model": 1}
            assert m["axis_names"] == ["slice", "site", "model"]
            assert m["slice_id"] == r // per and m["block"] == [r * K, (r + 1) * K]
            assert m["slice_count"] == SLICES
            want = jmesh.site_axis_of(_jax_mesh(world, "sliced"))
            assert m["site_axis"] == (list(want) if isinstance(want, tuple) else want)


# -- the split form ------------------------------------------------------------------


def _split_cases():
    return ([(2, e, c) for e in ENGINES for c in DCN_CODECS]
            + [(4, e, "int8") for e in ENGINES])


@pytest.mark.parametrize("world,engine,codec", _split_cases())
def test_split_form_matches_jax_sliced_split_epoch(worlds, world, engine, codec):
    """Each slice's partial through the inter-slice codec, as JAX's split
    form: held at the codec's shares where a grid step can part the runs
    (rankDAD's factors part by ulps upstream of the grid; the stochastic
    grid keys its dither on each value's bits), else at the f32 wire's."""
    run = world_runs(world)[f"{engine}-{codec}"]
    state, losses = _jax_run(world, run)
    got = _result(worlds, world, f"{engine}-{codec}")
    assert np.isfinite(got["losses"]).all()
    _assert_close_to_jax(got, state, losses, engine,
                         flips=DCN_CODECS[codec][1] or engine == "rankDAD")


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in _agg_cases(w)])
def test_split_aggregate_matches_jax_on_its_sliced_axis(worlds, world, name):
    """One set of gradients through each engine's split form over the
    group against JAX's engine on its sliced packed axis (shard_map under
    jit): equal on every rank, within test_torch_port_mesh.py's
    AGG_SHARE of each leaf's max."""
    engine, dcn = _agg_cases(world)[name]
    ej = _jax_agg_engine(engine, dcn)
    mesh = _jax_mesh(world, "sliced")
    axis = jcol.PackedAxis(jmesh.SITE_AXIS, K, slice_name=jmesh.SLICE_AXIS)
    spec = jax.sharding.PartitionSpec(jmesh.site_axis_of(mesh))
    fn = jax.jit(shard_map(lambda g, st, w: ej.aggregate(g, st, w, axis), mesh=mesh,
                           in_specs=(spec, spec, spec),
                           out_specs=(jax.sharding.PartitionSpec(), spec), check_vma=False))
    want, _ = fn({k: jnp.asarray(v) for k, v in _agg_grads(world).items()},
                 _agg_state(ej, world), jnp.asarray(_agg_weights(world)))
    got = [torch.load(worlds / f"w{world}_agg{r}_{name}.pt", weights_only=False)
           for r in range(world)]
    share = AGG_SHARE["stochastic" if DCN_CODECS[dcn][1] else "deterministic"]
    assert got[0].keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        for other in got[1:]:
            np.testing.assert_array_equal(got[0][k], other[k], err_msg=k)
        np.testing.assert_allclose(got[0][k], v, rtol=0, atol=share * np.abs(v).max(),
                                   err_msg=k)


@pytest.mark.parametrize("world,codec", [(2, c) for c in DCN_CODECS] + [(4, "int8")])
def test_dsgd_split_wire_is_jax_split_wire_bit_for_bit(worlds, world, codec):
    """dSGD's split aggregate against JAX's split wire run op by op with
    JAX's own functions: each rank's weighted partial (``_pack_partial``
    at the f32 wire), the slice's partials summed (the intra-slice psum),
    each slice's through the codec (``WireCodec.compress``), the slices
    summed (the inter-slice psum), then the payload's and the gradient's
    dtype."""
    quant, stochastic = DCN_CODECS[codec]
    dcn = jcol.resolve_dcn_codec("32", "none", quant, stochastic)
    grads = {k: jnp.asarray(v) for k, v in _agg_grads(world).items()}
    scale = jcol.site_weight_scale(jnp.asarray(_agg_weights(world)),
                                   jcol.PackedAxis(None, sites(world)))
    per = world // SLICES
    got = torch.load(worlds / f"w{world}_agg0_dSGD-{codec}.pt", weights_only=False)
    for k, g in grads.items():
        parts = [jcol._pack_partial(g[r * K:(r + 1) * K] * jcol._bcast(scale[r * K:(r + 1) * K],
                                                                        g), jnp.float32)
                 for r in range(world)]
        slices = []
        for sl in range(SLICES):
            p = parts[sl * per]
            for q in parts[sl * per + 1:(sl + 1) * per]:
                p = p + q
            slices.append(dcn.compress(p))
        want = np.asarray((slices[0] + slices[1]).astype(g.dtype))
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_collectives_of_the_two_forms(worlds):
    """A round of the fused form: the unsliced world's collectives (the
    one-rank-a-slice gather is the inter-slice hop itself); of the split
    form: the bookkeeping all-reduce over every rank, the payload's
    intra-slice all-reduce (none for one rank a slice) and its inter-slice
    hop (rankDAD: its dense leaves' and its rank class's gather; powerSGD:
    P's and q''s)."""
    rounds = EPOCHS * STEPS
    for world in WORLDS:
        intra = 1 if world // SLICES > 1 else 0
        for engine in ENGINES:
            flat = _result(worlds, world, f"{engine}-flat")["collectives"]
            fused = _result(worlds, world, f"{engine}-fused")["collectives"]
            split = _result(worlds, world, f"{engine}-int8")["collectives"]
            assert flat["all_reduce"] == fused["all_reduce"], (world, engine)
            assert fused["dcn_all_reduce"] == flat["dcn_all_reduce"] == 0
            gathers = rounds if engine == "rankDAD" else 0
            assert flat["all_gather"] == gathers
            assert fused["dcn_all_gather"] == gathers and \
                fused["all_gather"] == gathers * intra, (world, engine, fused)
            hops = {"dSGD": 1, "rankDAD": 1, "powerSGD": 2}[engine]
            assert split["dcn_all_reduce"] == hops * rounds, (world, engine, split)
            assert split["all_reduce"] == (1 + hops * intra) * rounds, (world, engine, split)


def test_split_elements_a_round_are_jax_dcn_model(worlds):
    """The elements a rank sends across the inter-slice hop a round, at
    the codec's byte a value, are JAX's ``dcn_bytes_of`` for one slice."""
    rounds = EPOCHS * STEPS
    for world in WORLDS:
        per = world // SLICES
        for engine in ENGINES:
            split = _result(worlds, world, f"{engine}-int8")["collectives"]
            want = jmetrics.dcn_bytes_of(_jax_engine(engine, "int8"), _jax_params(engine),
                                         pack=K, sites_per_slice=K * per, slices=SLICES)
            assert split["dcn_elements"] == want * rounds, (world, engine, split, want)


def _jax_params(engine: str) -> dict:
    task = jsteps.FederatedTask(JMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
    eng = _jax_engine(engine)
    state = jsteps.init_train_state(task, eng, jsteps.make_optimizer("sgd", 1e-2),
                                    jax.random.PRNGKey(0), jnp.ones((4, F), jnp.float32),
                                    num_sites=2)
    return state.params


def test_primitives_over_the_slices(worlds):
    """three_level_psum's fused form is the flat collective bit for bit;
    the slice gate leaves exactly the live slice's sum; the split form is
    each slice's partial through the codec, summed; the hierarchical
    gather keeps the slice-major site order; the tree's split form is the
    leaf-by-leaf one."""
    for world in WORLDS:
        for r, f in enumerate(_facts(worlds, world)):
            p = f["primitives"]
            assert p["fused_is_flat"] and p["gate_keeps_slice_0"], (world, r)
            assert p["split_by_hand"] and p["tree_split_is_leafwise"], (world, r)
            assert p["gather_order"] == [float(q) for q in range(world) for _ in range(K)]


# -- slice faults and the quorum -------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_slice_drop_matches_site_exclusion_bit_exact(worlds, engine):
    """JAX's equivalence gate: slice 1 masked through ``slice_live`` is
    slice 1's sites masked through ``live``, bit for bit (params, losses,
    per-site engine state, health); and within the f32 wire's tolerance of
    JAX's slice drop."""
    drop, excl = (_result(worlds, 2, f"{engine}-{t}") for t in ("slice-drop", "site-drop"))
    np.testing.assert_array_equal(drop["losses"], excl["losses"])
    _assert_equal_states(drop["state"], excl["state"])
    state, losses = _jax_run(2, world_runs(2)[f"{engine}-slice-drop"])
    _assert_close_to_jax(drop, state, losses, engine, flips=False)
    # site 2 and 3 (slice 1) sat out round 0 of each epoch
    np.testing.assert_array_equal(drop["state"]["health"]["skips"], [0, 0, EPOCHS, EPOCHS])


@pytest.mark.parametrize("world", WORLDS)
def test_slice_drop_matches_flat_mesh_site_exclusion(worlds, world):
    """The same dead slice across topologies: the sliced run with slice 1
    masked is the flat mesh's run with slice 1's sites masked."""
    drop, flat = (_result(worlds, world, n) for n in ("dSGD-slice-drop", "dSGD-flat-site-drop"))
    np.testing.assert_array_equal(drop["losses"], flat["losses"])
    _assert_equal_states(drop["state"], flat["state"], parts=("params",))


@pytest.mark.parametrize("world", WORLDS)
def test_slice_quorum_holds_round(worlds, world):
    """``min_slices=2`` with slice 1 dead in round 0: the round holds (NaN
    loss, nothing the state carries moves, bit for bit; no site is charged
    a skip) and round 1 trains; the held count is JAX's telemetry's."""
    got = _result(worlds, world, "dSGD-quorum")
    one = got["one_held_round"]
    assert np.isnan(one["loss"][0])
    for part in ("params", "engine_state", "health", "opt_state", "batch_stats"):
        for k, v in _flat(one["before"][part]).items():
            np.testing.assert_array_equal(_flat(one["after"][part])[k], v, err_msg=k)
    assert one["after"]["round"] == one["before"]["round"] + 1
    losses = got["losses"].reshape(EPOCHS, STEPS)
    assert np.isnan(losses[:, 0]).all() and np.isfinite(losses[:, 1]).all()
    assert got["held"] == [True, False] * EPOCHS
    assert int(np.asarray(got["state"]["health"]["skips"]).sum()) == 0
    run = world_runs(world)["dSGD-quorum"]
    state, losses_j = _jax_run(world, run, telemetry=True)
    assert int(state.telemetry["held_rounds"][0]) == sum(got["held"])
    np.testing.assert_array_equal(np.isnan(got["losses"]), np.isnan(losses_j))
    _assert_close_to_jax({**got, "losses": np.nan_to_num(got["losses"])}, state,
                         np.nan_to_num(losses_j), "dSGD", flips=False)


def test_slice_mask_rejected_on_unsliced_topologies():
    """JAX's errors, in type and message: the mask on a topology with no
    slice tier, a quorum floor without one (or above its slices), and a
    mask of another row count than the mesh's slices."""
    S = 4
    x, y, w = _data(2)
    task = tsteps.FederatedTask(TMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
    opt = tsteps.make_optimizer("sgd", 1e-2)
    state = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S)
    mask = np.ones((2, STEPS), np.float32)
    for mesh in (None, tmesh.packed_site_mesh(S, S, device="cpu")):
        ep = tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", pipeline="host",
                                        mesh=mesh)
        with pytest.raises(ValueError, match="unsliced topology"):
            ep(state, x, y, w, None, None, mask)
    for mod, mesh in ((tsteps, tmesh.packed_site_mesh(S, S, device="cpu")),
                      (jsteps, jmesh.packed_site_mesh(S, 1))):
        jtask = jsteps.FederatedTask(JMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
        args = ((task, make_dsgd(), opt) if mod is tsteps
                else (jtask, make_engine("dSGD"), jsteps.make_optimizer("sgd", 1e-2)))
        kw = {"device": "cpu", "mesh": mesh} if mod is tsteps else {"mesh": mesh}
        with pytest.raises(ValueError, match="needs a sliced mesh"):
            mod.make_train_epoch_fn(*args, min_slices=2, **kw)
        with pytest.raises(ValueError, match="min_slices must be >= 1"):
            mod.make_train_epoch_fn(*args, min_slices=0, **kw)
    # a sliced mesh's checks come before any collective: a mesh of two
    # slices with no group behind it is enough to reach them
    sliced = tmesh.SiteMesh(None, 2, 0, torch.device("cpu"), None, K, slices=2)
    with pytest.raises(ValueError, match="exceeds the mesh's 2 slices"):
        tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", mesh=sliced,
                                   min_slices=3)
    ep = tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu", pipeline="host",
                                    mesh=sliced)
    with pytest.raises(ValueError, match="slice_live has 3 slice rows but the mesh has 2"):
        ep(tsteps.site_state_block(state, sliced), x, y, w, None, None,
           np.ones((3, STEPS), np.float32))


# -- the mesh helpers, one process ---------------------------------------------------------


def test_sliced_mesh_validation_matches_jax():
    for mod in (jmesh, tmesh):
        kw = {} if mod is jmesh else {"device": "cpu"}
        with pytest.raises(ValueError, match="num_slices must be >= 1"):
            mod.sliced_site_mesh(0, 4, **kw)
        with pytest.raises(ValueError, match="sites_per_device must be >= 1"):
            mod.sliced_site_mesh(2, 4, 0, **kw)
        with pytest.raises(ValueError, match="must divide the per-slice site count"):
            mod.sliced_site_mesh(2, 5, 2, **kw)
        assert mod.slice_count(mod.sliced_site_mesh(1, 4, 4, **kw)) == 1
    # one slice is the packed mesh, as in JAX
    one = tmesh.sliced_site_mesh(1, 4, 4, device="cpu")
    assert (one.pack, one.slices, one.shape) == (4, 1, {"site": 1, "model": 1})
    # one process has no devices to lay slices on: it names the group it needs
    with pytest.raises(ValueError, match="needs a process group of 4 ranks"):
        tmesh.sliced_site_mesh(2, 4, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A11 \(c\)"):
        tmesh.sliced_site_mesh(2, 4, 2, model_axis_size=2, device="cpu")
    # the multi-process form collapses to it in one process, as JAX's
    assert tdist.multihost_sliced_site_mesh(device="cpu").slices == 1
    with pytest.raises(ValueError, match="needs a process group"):
        tdist.multihost_sliced_site_mesh(num_slices=2, device="cpu")


def test_multihost_sliced_mesh_validation_over_a_group(worlds):
    """Over the worlds' groups: too few ranks for the slices asked (JAX's
    message), slices that do not divide the processes and members that do
    not divide over a slice's ranks (JAX's messages)."""
    for world in WORLDS:
        errs = _facts(worlds, world)[0]["mesh"]["errors"]
        assert errs["too_few_ranks"][0] == "ValueError"
        assert f"need {2 * sites(world)} devices for 2 slices" in errs["too_few_ranks"][1]
        assert errs["slices_not_dividing"] == [
            "ValueError", f"num_slices=3 must divide the process count ({world}) — slices "
                          "are process granules over DCN"]
        assert errs["members_not_dividing"] == [
            "ValueError", f"{world + 1} site-axis members per slice must divide over {world} "
                          "processes per slice"]


def test_auto_site_mesh_resolves_slices(worlds):
    """``num_slices=2`` over a group: the sliced mesh, K = S / W a rank;
    the multi-process form's default, one slice a rank. One process
    refuses it, naming the group it needs; the site-count checks are
    JAX's."""
    for world in WORLDS:
        m = _facts(worlds, world)[0]["mesh"]
        assert m["auto"] == {"shape": {"slice": 2, "site": world // 2, "model": 1}, "pack": K,
                             "slices": 2}
        assert m["default"] == {"shape": {"slice": world, "site": 1, "model": 1}, "pack": 1}
    with pytest.raises(ValueError, match="needs a process group of a multiple of 2 ranks"):
        auto_site_mesh(TCfg(num_slices=2), 4, device="cpu")
    with pytest.raises(ValueError, match=r"num_slices=2 × sites_per_device=1 must divide"):
        auto_site_mesh(TCfg(num_slices=2), 5, device="cpu")
    assert auto_site_mesh(TCfg(), 4, device="cpu") is None


# -- the wire models, one process -----------------------------------------------------------

SHAPES = {"w1": (12, 8), "w2": (8, 6), "b1": (8,), "head": (6, 2)}
ROBUST = ("none", "norm_clip", "trimmed_mean", "coordinate_median")
DCN_QUANTS = ("", "none", "bf16", "int8", "fp8")


@pytest.mark.parametrize("robust", ROBUST)
@pytest.mark.parametrize("dcn", DCN_QUANTS)
@pytest.mark.parametrize("engine", ENGINES)
def test_dcn_wire_model_matches_jax(engine, dcn, robust):
    """``dcn_wire_shapes``, ``dcn_bytes`` and ``dcn_bytes_of`` equal JAX's
    integers for every engine, robust mode and inter-slice codec, at a few
    pack factors and slice widths; the inter-slice dtype is JAX's."""
    kw = dict(wire_quant="int8" if dcn == "" else "none", dcn_wire_quant=dcn,
              robust_agg=robust)
    if engine != "dSGD":
        kw.update(KW_LOWRANK)
    ej = make_engine(engine, **kw)
    et = {"dSGD": make_dsgd, "rankDAD": make_rankdad, "powerSGD": make_powersgd}[engine](**kw)
    one_j = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    one_t = {k: torch.zeros(s) for k, s in SHAPES.items()}
    for pack, sps in ((1, 1), (2, 4), (4, 8)):
        # the operands as a multiset (JAX lists dict leaves in key order)
        want = sorted((tuple(s), np.dtype(d).itemsize)
                      for s, d in ej.dcn_wire_shapes(one_j, pack=pack, sites_per_slice=sps))
        got = sorted((tuple(s), d.itemsize)
                     for s, d in et.dcn_wire_shapes(one_t, pack=pack, sites_per_slice=sps))
        assert got == want
        assert et.dcn_bytes(one_t, pack, sps) == ej.dcn_bytes(one_j, pack, sps)
        for slices in (1, 2):
            assert tmetrics.dcn_bytes_of(et, one_t, pack, sps, slices) == \
                jmetrics.dcn_bytes_of(ej, one_j, pack, sps, slices)
    dj = None if ej.dcn_dtype is None else np.dtype(ej.dcn_dtype).itemsize
    assert (None if et.dcn_dtype is None else et.dcn_dtype.itemsize) == dj


@pytest.mark.parametrize("combo", [("32", "none", "", False), ("32", "int8", "", True),
                                   ("32", "int8", "none", False), ("16", "none", "fp8", False),
                                   ("32", "bf16", "int8", True), ("16-ieee", "none", "bf16",
                                                                  False)])
def test_resolve_dcn_codec_matches_jax(combo):
    """``""`` follows ``wire_quant``, ``"none"`` is the fused form."""
    want = jcol.resolve_dcn_codec(*combo)
    got = tcol.resolve_dcn_codec(*combo)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.quant, got.stochastic) == (want.quant, want.stochastic)
        assert got.dtype.itemsize == np.dtype(want.dtype).itemsize


def test_dsgd_secure_aggregation_keeps_the_fused_form():
    """JAX's guard: the masked wire refuses an inter-slice codec of its own
    and takes the fused form where ``""`` would follow a bf16 wire."""
    for mod in (make_dsgd, lambda **k: make_engine("dSGD", **k)):
        with pytest.raises(ValueError, match="cannot compose with a DCN wire codec"):
            mod(secure_agg="mask", dcn_wire_quant="int8")
    et = make_dsgd(secure_agg="mask", wire_quant="bf16")
    ej = make_engine("dSGD", secure_agg="mask", wire_quant="bf16")
    assert et.dcn_dtype is None and ej.dcn_dtype is None


# -- the worker's flags ------------------------------------------------------------------


def test_every_jax_worker_flag_parses():
    """Each flag of JAX's ``dcn_worker`` parser is the port's, with JAX's
    default where it is the same option; the port adds ``--device`` and
    ``--backend``. ``--devices-per-process`` other than 1 and ``--slices``
    that do not divide the processes exit 2."""
    flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', inspect.getsource(jworker)))
    port = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', inspect.getsource(tworker)))
    assert flags <= port and port - flags == {"--device", "--backend"}
    argv = ["--data-path", "/x", "--slices", "2", "--num-processes", "4", "--process-id", "3",
            "--coordinator", "h:1", "--dcn-wire-quant", "int8", "--epochs", "3", "--task",
            "ICA-Classification", "--batch-size", "4", "--faults", '{"kill_slice_at":[[1,2]]}',
            "--resume", "--supervise", "--heartbeat-s", "0.5", "--heartbeat-timeout-s", "15",
            "--max-restarts", "3", "--slice-ckpt", "--restart-generation", "2",
            "--statusz-port", "0", "--slo-p99-ms", "500", "--pod-trace", "abc",
            "--out-dir", "/o", "--report", "/r.json", "--set", "wire_quant=int8"]
    a, b = jworker._parse(argv + ["--devices-per-process", "1"]), tworker._parse(
        argv + ["--devices-per-process", "1"])
    for dest in vars(a):
        assert getattr(b, dest) == getattr(a, dest), dest
    assert tworker._config_overrides(b.overrides) == jworker._config_overrides(a.overrides)
    assert [tworker._slice_of(r, 4, 2) for r in range(4)] == \
        [jworker._slice_of(r, 4, 2) for r in range(4)] == [0, 0, 1, 1]
    assert tworker.main(["--data-path", "/x", "--devices-per-process", "4"]) == 2
    assert tworker.main(["--data-path", "/x", "--num-processes", "3", "--slices", "2"]) == 2
    assert tworker._report_path("/r.json", 1) == jworker._report_path("/r.json", 1)
