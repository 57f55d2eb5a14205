"""The site axis over processes (parallel/mesh.py, parallel/distributed.py,
the engines' two-level reductions and the epoch over a group) against
the JAX package: the mesh helpers and their refusals, the join's
contract, and a spawned gloo world of 2 ranks running S = 4 sites (K = 2
a rank) through dSGD, rankDAD and powerSGD epochs, held against JAX's
packed epoch on ``host_mesh(2)`` (conftest's virtual CPU devices) and
against the port's own one-device epoch; the same engines under the int8,
stochastic int8 and fp8 wire codecs against JAX's packed epoch under the
codec (and under bf16 and the 16-bit payloads), and each engine's
aggregate of one set of gradients on each wire against JAX's packed
aggregate; a case with dropout against the port at W = 1; and checkpoints
that cross between W = 2, W = 1 and JAX.

The ranks are two Python processes that import torch and the port only;
they join at a free localhost port and fail their test when they outrun
WORLD_TIMEOUT_S.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mesh_rank import (
    BATCH,
    CASES,
    CODEC_CASES,
    CODECS,
    F32,
    ENGINE_KW,
    EPOCHS,
    STEPS,
    F,
    S,
    _live,
    _port_engine,
    _port_epoch,
    _wire_kw,
    all_runs,
)

from test_torch_port_wire import ENGINE_SHARE, KW_DAD, KW_LOWRANK, NS, WEIGHTS, _engine_grads

from dinunet_implementations_tpu.core.jaxcompat import shard_map
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.parallel import collectives as jcol
from dinunet_implementations_tpu.parallel import distributed as jdist
from dinunet_implementations_tpu.parallel import mesh as jmesh
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.parallel import collectives as tcol
from dinunet_implementations_tpu_torch.parallel import distributed as tdist
from dinunet_implementations_tpu_torch.parallel import mesh as tmesh
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's own packed == unpacked gate (tests/test_packing.py): dSGD 1e-6, the
# low-rank engines 1e-5
ATOL = {"dSGD": 1e-6, "rankDAD": 1e-5, "powerSGD": 1e-5}
WORLD_TIMEOUT_S = 120
# The epochs on the other wires. dSGD and powerSGD on every deterministic
# wire (int8, fp8, bf16, the 16-bit payloads) meet the f32 wire's ATOL
# (measured <= 1.2e-6). Where a value's
# last bits differ between the two frameworks upstream of the wire
# (rankDAD's power iteration leaves its factors a few ulps apart; under the
# stochastic grid any value's own bits key its dither), the codec rounds it
# one grid step apart and the later rounds carry the step: the two runs are
# two draws of the same codec. Those cases hold each leaf of the params and
# the engine state at test_torch_port_wire.py's EPOCH_SHARE of the leaf's
# max (measured <= 3.3e-2, powerSGD's q under stochastic int8; rankDAD's
# deterministic wires <= 9.2e-5) and the losses at the FS fit tests' 1e-4
# (measured <= 4.3e-5). The aggregate test
# below holds the wire itself on equal inputs.
CODEC_FLIP_SHARE, CODEC_FLIP_LOSS_ATOL = 0.1, 1e-4
# The aggregate of one set of gradients over the group against JAX's engine
# on its packed axis, compiled (shard_map under jit): XLA compiles the
# codec's division its own way, an ulp from JAX's op-by-op result in 75 of
# a 2 x 12 x 8 fp8 payload's 192 values (measured), and the stochastic
# grid's dither, keyed by each value's bits, redraws where they part. So
# every engine is held at test_torch_port_wire.py's shares for engines
# whose inputs part by ulps; dSGD's wire is also held bit for bit against
# JAX's packed wire run op by op.
AGG_SHARE = {"deterministic": ENGINE_SHARE["deterministic"],
             "stochastic": ENGINE_SHARE["stochastic"]}


def _data(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, STEPS, BATCH, F)).astype(np.float32)
    y = (rng.random((S, STEPS, BATCH)) > 0.5).astype(np.int32)
    w = np.ones((S, STEPS, BATCH), np.float32)
    return x, y, w


def _jax_epoch(engine, mesh, wire=F32):
    task = jsteps.FederatedTask(JMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
    eng = make_engine(engine, **_wire_kw(wire), **ENGINE_KW[engine])
    opt = jsteps.make_optimizer("sgd", 1e-2)
    state = jsteps.init_train_state(task, eng, opt, jax.random.PRNGKey(0),
                                    jnp.ones((4, F), jnp.float32), num_sites=S)
    return state, jsteps.make_train_epoch_fn(task, eng, opt, mesh, local_iterations=1,
                                              pipeline="host")


def _run_port(epoch, state, data, live):
    losses = []
    for _ in range(EPOCHS):
        state, lo = epoch(state, *data, None if live is None else live)
        losses.extend(lo.tolist())
    return state, np.array(losses)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree)}


# the rank's program: torch and the port only
CHILD = r'''
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
import test_torch_port_mesh_rank as r
r.main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_world(tmp, world=2):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(rank), port, str(tmp),
                               os.path.join(REPO, "tests")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    deadline, outs = time.monotonic() + WORLD_TIMEOUT_S, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the gloo world outran {WORLD_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the world once for every case: writes each case's JAX initial
    state (as the port's) and data, and a JAX checkpoint for the W = 1 -> 2
    case, then the two ranks; returns the directory of their results."""
    tmp = tmp_path_factory.mktemp("world")
    x, y, w = _data()
    np.savez(tmp / "data.npz", x=x, y=y, w=w)
    for name, (engine, _, _, wire) in all_runs().items():
        state, _ = _jax_epoch(engine, None, wire)
        torch.save(train_state_from_jax(jax.tree.map(np.asarray, state), device="cpu"),
                   tmp / f"init_{name}.pt")
    # a JAX powerSGD state after one epoch, each site's q and e its own
    state, epoch = _jax_epoch("powerSGD", None)
    live = np.ones((S, STEPS), np.float32)
    live[2, 1] = 0.0
    state, _ = epoch(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(live))
    jckpt.save_checkpoint(str(tmp / "jax_psgd.msgpack"), state)
    # one set of gradients, weights and each codec case's JAX engine state
    # for the aggregate over the group
    torch.save({"grads": {k: torch.from_numpy(v) for k, v in _engine_grads().items()},
                "weight": torch.from_numpy(WEIGHTS),
                "states": {name: jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                              _agg_state(_jax_agg_engine(*case)))
                           for name, case in CODEC_CASES.items()}}, tmp / "agg_in.pt")
    _spawn_world(tmp)
    return tmp


def _jax_agg_engine(engine, wire):
    """test_torch_port_wire.py's JAX engines on a wire."""
    kw = _wire_kw(wire)
    if engine != "dSGD":
        kw.update(KW_LOWRANK)
    if engine == "rankDAD":
        kw.update(KW_DAD, fused_poweriter=False)
    return make_engine(engine, **kw)


def _agg_state(engine):
    """A JAX engine's initial state for every one of the NS sites."""
    one = {k: jnp.zeros(v.shape[1:], jnp.float32) for k, v in _engine_grads().items()}
    return jax.tree.map(lambda a: jnp.stack([a] * NS), engine.init(one))


def _result(world, name):
    return torch.load(world / f"result_{name}.pt", weights_only=False)


def _assert_matches_jax_packed(got, engine, wire=F32, flips=False):
    """A world's result against JAX's packed epoch on ``host_mesh(2)`` (K =
    2 a device) with the same wire, at JAX's own packed == unpacked
    tolerances; ``flips``: where the codec's grid can part the two runs, at
    :data:`CODEC_FLIP_SHARE` of each leaf's max."""
    state, epoch = _jax_epoch(engine, jmesh.host_mesh(2), wire)
    x, y, w = _data()
    losses = []
    for _ in range(EPOCHS):
        state, lo = epoch(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        losses.extend(np.asarray(lo).tolist())
    want = jax.tree.map(np.asarray, state)
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=CODEC_FLIP_LOSS_ATOL if flips else ATOL[engine])
    for part in ("params", "engine_state"):
        g, t = _flat(got["state"][part]), _flat(getattr(want, part))
        assert g.keys() == t.keys(), part
        top = max((np.abs(v).max() for v in t.values()), default=0.0)
        for k in t:
            atol = (CODEC_FLIP_SHARE * max(np.abs(t[k]).max(), 1e-3 * top) if flips
                    else ATOL[engine])
            if part == "engine_state" and engine == "rankDAD" and "fc_out" in k:
                # the 2-class head's per-site gradient has rank 1 (its two
                # columns are negatives of each other), so the second column
                # of each site's Q is orthonormalized rounding noise (~1e-6)
                # and differs between any two correct runs; the first is the
                # factor
                np.testing.assert_allclose(g[k][..., 0], t[k][..., 0], atol=atol, rtol=0,
                                           err_msg=k)
                assert np.isfinite(g[k]).all() and np.abs(g[k][..., 1]).max() < 1e-3, k
                continue
            np.testing.assert_allclose(g[k], t[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_gloo_world_of_two_matches_jax_packed_epoch(world, engine):
    """W = 2 ranks of K = 2 sites against JAX's packed epoch."""
    _assert_matches_jax_packed(_result(world, engine), engine)


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_gloo_world_of_two_matches_jax_packed_epoch_under_codec(world, name):
    """Each other wire over the group, as JAX's packed axis runs it: dSGD
    and rankDAD round each site's payload through the codec (one scale a
    site row) or the 16-bit payload dtype, and dSGD the rank's weighted
    partial again; powerSGD rounds the rank's partials of P and q'. Held
    against JAX's packed epoch on the same wire (:data:`CODEC_FLIP_SHARE`
    where a grid step can part them: rankDAD, and the stochastic grid)."""
    engine, wire = CODEC_CASES[name]
    _assert_matches_jax_packed(_result(world, name), engine, wire,
                               flips=wire[2] or engine == "rankDAD")


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_gloo_world_of_two_aggregates_as_jax_packed_under_codec(world, name):
    """Each engine's aggregate of one set of gradients (test_torch_port_wire
    .py's) over the group of 2 (K = 2 a rank) against JAX's engine on
    ``host_mesh(2)`` over its packed axis (K = 2 a device), the same inputs
    on both sides: equal on both ranks, and at :data:`AGG_SHARE` of each
    leaf's max against JAX."""
    engine, wire = CODEC_CASES[name]
    ej = _jax_agg_engine(engine, wire)
    axis = jcol.PackedAxis(jmesh.SITE_AXIS, NS // 2)
    spec = jax.sharding.PartitionSpec(jmesh.SITE_AXIS)
    fn = jax.jit(shard_map(lambda g, st, w: ej.aggregate(g, st, w, axis),
                           mesh=jmesh.host_mesh(2), in_specs=(spec, spec, spec),
                           out_specs=(jax.sharding.PartitionSpec(), spec), check_vma=False))
    want, _ = fn({k: jnp.asarray(v) for k, v in _engine_grads().items()}, _agg_state(ej),
                 jnp.asarray(WEIGHTS))
    got = [torch.load(world / f"agg{r}_{name}.pt", weights_only=False) for r in (0, 1)]
    share = AGG_SHARE["stochastic" if wire[2] else "deterministic"]
    assert got[0].keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_allclose(got[0][k], v, rtol=0, atol=share * np.abs(v).max(),
                                   err_msg=k)


@pytest.mark.parametrize("codec", list(CODECS))
def test_gloo_world_of_two_dsgd_wire_is_jax_packed_wire_bit_for_bit(world, codec):
    """dSGD's aggregate over the group against JAX's packed wire run op by
    op with JAX's own functions (dsgd.py's quantized arm on a
    ``PackedAxis``): each site's payload through the codec with one scale a
    row of the rank's block, the rank's weighted partial through the codec
    again (``weighted_site_sum``, whose cross-device psum is the identity
    for an axis without a mesh name), and the two ranks' partials summed,
    as the psum of two values does."""
    pb, quant, stochastic = CODECS[codec]
    cj = jcol.resolve_wire_codec(pb, quant, stochastic)
    if quant == "none":
        # the precision_bits wire: each payload cast, the partial cast again
        on_wire, wire_dtype = (lambda g: g.astype(jcol.payload_dtype(pb))), cj.dtype
    else:
        on_wire, wire_dtype = (lambda g: cj.compress(g, batched=True)), cj
    grads = {k: jnp.asarray(v) for k, v in _engine_grads().items()}
    scale = jcol.site_weight_scale(jnp.asarray(WEIGHTS), jcol.PackedAxis(None, NS))
    K = NS // 2
    parts = [jax.tree.map(lambda g: jcol.weighted_site_sum(
        on_wire(g[r * K:(r + 1) * K]), scale[r * K:(r + 1) * K], jcol.PackedAxis(None, K),
        wire_dtype=wire_dtype), grads) for r in (0, 1)]
    got = torch.load(world / f"agg0_dSGD-{codec}.pt", weights_only=False)
    for k, g in grads.items():
        # the mean in the payload's dtype, then the gradient's
        payload = on_wire(g[:K])
        want = np.asarray((parts[0][k] + parts[1][k]).astype(payload.dtype).astype(g.dtype))
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_gloo_world_of_two_matches_the_one_device_epoch(world, name):
    """The same epochs with every site on one device (``mesh=None``): the
    two-level reduction changes the order of f32 sums, nothing else; with
    dropout the masks are the one-device draw's (SiteBlockDraw)."""
    engine, dropout, dead = CASES[name]
    got = _result(world, name)
    state = torch.load(world / f"init_{name}.pt", weights_only=False)
    state, losses = _run_port(_port_epoch(engine, dropout), state, _data(), _live(dead))
    want = train_state_to_jax(state)
    np.testing.assert_allclose(got["losses"], losses, atol=ATOL[engine], rtol=0)
    for part in ("params", "engine_state", "health"):
        g, t = _flat(got["state"][part]), _flat(want[part])
        assert g.keys() == t.keys(), part
        for k in t:
            np.testing.assert_allclose(g[k], t[k], atol=ATOL[engine], rtol=0, err_msg=k)
    if dead:
        # site 1 sits out round 0 of each epoch
        np.testing.assert_array_equal(got["state"]["health"]["skips"], [0, EPOCHS, 0, 0])


def test_every_rank_holds_the_same_params_and_its_own_sites(world):
    for name in all_runs():
        a, b = (torch.load(world / f"rank{r}_{name}.pt", weights_only=False) for r in (0, 1))
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
        assert a["block"] == [0, 2] and b["block"] == [2, 4]


def test_collectives_a_round(world):
    """dSGD: two all-reduces a round, the round's bookkeeping (the live
    total and the loss in one buffer; the engine takes the total from
    there, and MSANNet has no sync-BN statistics to sum) and the engine's
    whole payload in one flat buffer; rankDAD the same, its dense leaves in
    the one flat buffer, and one gather for its one rank class (r = 2);
    powerSGD one more all-reduce (its two sums, P and q', each one buffer
    for every leaf). A codec changes no count."""
    for name, (engine, *_) in all_runs().items():
        c = _result(world, name)["collectives"]
        rounds = EPOCHS * STEPS
        assert c["all_reduce"] == (3 if engine == "powerSGD" else 2) * rounds, (name, c)
        assert c["all_gather"] == (rounds if engine == "rankDAD" else 0), (name, c)


def test_checkpoint_from_two_ranks_loads_at_one_and_in_jax(world):
    """The powerSGD world's rank 0 wrote the gathered state: the port at
    W = 1 and JAX restore every site's q and e from it."""
    path = str(world / "w2_psgd.msgpack")
    got = _result(world, "powerSGD")["state"]
    like = torch.load(world / "init_powerSGD.pt", weights_only=False)
    back = train_state_to_jax(tckpt.load_checkpoint(path, like))
    for part in ("params", "engine_state", "health"):
        g, t = _flat(back[part]), _flat(got[part])
        assert g.keys() == t.keys()
        for k in t:
            np.testing.assert_array_equal(g[k], t[k], err_msg=k)
    state_j, _ = _jax_epoch("powerSGD", None)
    back_j = jax.tree.map(np.asarray, jckpt.load_checkpoint(path, state_j))
    g, t = _flat(back_j.engine_state), _flat(got["engine_state"])
    for k in t:
        np.testing.assert_array_equal(g[k], t[k], err_msg=k)


def test_jax_checkpoint_loads_into_each_ranks_block(world):
    """A JAX checkpoint (every site's q and e, written with W = 1) restored
    at W = 2: each rank keeps its block of the sites."""
    state_j, _ = _jax_epoch("powerSGD", None)
    want = _flat(jax.tree.map(np.asarray, jckpt.load_checkpoint(
        str(world / "jax_psgd.msgpack"), state_j)).engine_state)
    for r in (0, 1):
        got = _flat(torch.load(world / f"block{r}.pt", weights_only=False))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k][2 * r:2 * r + 2], err_msg=k)


# -- the helpers and refusals, a world of one --------------------------------------


def test_mesh_helpers_validate_as_jax():
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError, match="divide"):
            mod.packed_site_mesh(6, 4)
        with pytest.raises(ValueError, match=">= 1"):
            mod.packed_site_mesh(8, 0)
        assert mod.pack_factor(None, 8) == 8
        assert mod.slice_count(None) == 1
    # a world of one: one rank packs every site; more ranks than the group
    # has is oversubscription
    mesh = tmesh.packed_site_mesh(8, 8, device="cpu")
    assert (mesh.world, mesh.rank, mesh.pack, mesh.shape) == (1, 0, 8, {"site": 1, "model": 1})
    assert tmesh.pack_factor(mesh, 8) == 8 and mesh.coordinator
    assert tmesh.site_axis_of(mesh) == jmesh.site_axis_of(jmesh.host_mesh(2)) == "site"
    with pytest.raises(ValueError, match="need 2 devices"):
        tmesh.packed_site_mesh(8, 4, device="cpu")
    with pytest.raises(ValueError, match="built for 8 sites"):
        tmesh.pack_factor(mesh, 4)
    assert tmesh.host_mesh(1).device == torch.device("cpu")
    with pytest.raises(ValueError, match="process group of 2"):
        tmesh.host_mesh(2)
    assert tmesh.make_site_mesh(device="cpu").pack == 1


def test_a_rank_takes_its_card_whatever_the_backend(monkeypatch):
    """No device: the rank's card (its rank modulo the cards) under gloo as
    under nccl; the CPU only when the caller names it; with no card and no
    device the mesh raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for backend in ("gloo", "nccl", None):
        assert tmesh._mesh_device(None, backend, 3) == torch.device("cuda", 1), backend
    assert tmesh._mesh_device("cpu", "gloo", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh._mesh_device(None, "gloo", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.multihost_site_mesh(2)


def test_slices_and_the_model_axis_are_refused_naming_their_items():
    """The model axis is refused naming A11 (c); slices need a process
    group (tests/test_torch_port_slices.py runs them over one), and one
    process refuses them naming the group it needs; the slice-liveness
    mask rides whole to the rank's device."""
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        tmesh.sliced_site_mesh(2, 4, 4, device="cpu")
    assert tmesh.sliced_site_mesh(1, 4, 4, device="cpu").pack == 4
    with pytest.raises(NotImplementedError, match=r"ROADMAP A11 \(c\)"):
        tmesh.packed_site_mesh(4, 4, model_axis_size=2, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        tdist.multihost_sliced_site_mesh(num_slices=2, device="cpu")
    mesh = tmesh.packed_site_mesh(4, 4, device="cpu")
    plan = tdist.put_epoch_plan(mesh, np.zeros((4, 1, 1)), slice_live=np.ones((2, 1)))
    assert plan[4].shape == (2, 1) and plan[4].device == torch.device("cpu")


def test_one_process_placement_keeps_every_site():
    mesh = tdist.multihost_site_mesh(4, device="cpu")
    assert (mesh.world, mesh.pack) == (1, 4) and not tdist.spans_processes(mesh)
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(tdist.put_site_batch(mesh, a).numpy(), a)
    np.testing.assert_array_equal(tdist.fetch_site_outputs(torch.from_numpy(a), mesh), a)
    plan = tdist.put_epoch_plan(mesh, np.zeros((4, 2, 3), np.int32), live=np.ones((4, 1)))
    assert plan[0].shape == (4, 2, 3) and plan[2] is None and plan[4] is None


def test_distributed_init_is_a_no_op_for_one_process():
    for mod in (jdist, tdist):
        assert mod.distributed_init() is False
        assert mod.distributed_init(num_processes=1) is False
    with pytest.raises(ValueError, match="together"):
        tdist.distributed_init(num_processes=2)
    with pytest.raises(ValueError, match="backend"):
        tdist.distributed_init("127.0.0.1:1", 2, 0, backend="mpi")
    assert tdist.default_backend("cpu") == "gloo" and tdist.default_backend("cuda:0") == "nccl"


def test_join_fails_within_its_deadline_against_an_unreachable_coordinator():
    """Rank 1 of 2 at a localhost port where nothing listens: each attempt
    gives up at ``join_timeout_s``, the join at ``join_deadline_s``, and
    nothing stays initialized."""
    import torch.distributed as dist

    t0 = time.monotonic()
    with pytest.raises((RuntimeError, OSError, TimeoutError)):
        tdist.distributed_init(f"127.0.0.1:{_free_port()}", 2, 1, device="cpu",
                               join_timeout_s=1.0, join_deadline_s=2.0)
    assert time.monotonic() - t0 < 15
    assert not dist.is_initialized() and not tdist._initialized
    tdist.distributed_shutdown()  # a no-op with nothing up


def test_flat_psum_and_gathers_without_a_group_are_the_identity():
    axis = tcol.PackedAxis(None, 3)
    a, b = torch.arange(6.0).reshape(3, 2), torch.ones(4)
    out = tcol.flat_psum([a, b], axis)
    assert torch.equal(out[0], a) and torch.equal(out[1], b)
    assert torch.equal(tcol.site_all_gather(a, axis), a)
    parts = tcol.site_all_gather_packed([a[:, None], a[:, None] * 2], axis)
    assert torch.equal(parts[1][:, 0], a * 2)
    assert tcol.site_index(axis) == 0 and tcol.site_count(axis) == 3
    assert tcol.site_count(None, 5) == 5


def test_parallel_exports_the_ported_jax_names():
    import dinunet_implementations_tpu.parallel as jpar
    import dinunet_implementations_tpu_torch.parallel as tpar

    # JAX's sharding objects (replicated, site_sharding) have no
    # counterpart: the ranks hold their blocks; nothing of the port calls
    # JAX's unweighted site_sum / site_mean
    not_ported = {"replicated", "site_sharding", "site_mean", "site_sum"}
    jnames = {n for n in dir(jpar) if not n.startswith("_") and n not in ("collectives",
                                                                        "distributed", "mesh",
                                                                        "sequence")}
    assert jnames - not_ported <= set(tpar.__all__), jnames - not_ported - set(tpar.__all__)
    a = torch.arange(12.0).reshape(4, 3)
    axis = tpar.PackedAxis(None, 4)
    assert torch.equal(tpar.two_level_psum(a, axis), a.sum(0))
    codec = tpar.resolve_wire_codec("32", "bf16")
    assert torch.equal(tpar.two_level_psum(a / 7, axis, codec), codec.compress((a / 7).sum(0)))


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_a_mesh_of_one_rank_is_the_one_device_epoch_bit_for_bit(world, engine):
    """A world of one (no group: every collective the identity) runs the
    two-level path with K = S: the same ops as ``mesh=None``."""
    mesh = tmesh.packed_site_mesh(S, S, device="cpu")
    states = [torch.load(world / f"init_{engine}.pt", weights_only=False) for _ in range(2)]
    got, lg = _run_port(_port_epoch(engine, 0.0, mesh), states[0], _data(), None)
    want, lw = _run_port(_port_epoch(engine, 0.0), states[1], _data(), None)
    np.testing.assert_array_equal(lg, lw)
    g, t = train_state_to_jax(got), train_state_to_jax(want)
    for part in ("params", "engine_state", "health"):
        for k, v in _flat(t[part]).items():
            np.testing.assert_array_equal(_flat(g[part])[k], v, err_msg=k)


MESH_REFUSED = {"robust_agg": {"robust_agg": "trimmed_mean"}, "staleness": {"staleness_bound": 2},
                "overlap": {"overlap_rounds": True}, "dp": {"dp_clip": 1.0},
                "personalize": {"personalize": ("fc_out",)}, "telemetry": {"telemetry": True}}


@pytest.mark.parametrize("plane", sorted(MESH_REFUSED))
def test_epoch_planes_over_a_group_are_refused_naming_a20(plane):
    from dinunet_implementations_tpu_torch.models.msannet import MSANNet as TMSANNet

    mesh = tmesh.packed_site_mesh(S, S, device="cpu")
    task = tsteps.FederatedTask(TMSANNet(in_size=F, hidden_sizes=(8,), out_size=2))
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        tsteps.make_train_epoch_fn(task, _port_engine("dSGD"),
                                   tsteps.make_optimizer("sgd", 0.1), device="cpu", mesh=mesh,
                                   **MESH_REFUSED[plane])
    # the same option with every site on one device builds
    assert callable(tsteps.make_train_epoch_fn(task, _port_engine("dSGD"),
                                               tsteps.make_optimizer("sgd", 0.1), device="cpu",
                                               **MESH_REFUSED[plane]))


@pytest.mark.parametrize("option", [{"secure_agg": "mask"},
                                    {"pretrain": True, "pretrain_args": {"epochs": 1}}])
def test_trainer_planes_over_a_group_are_refused_naming_a20(option):
    from dinunet_implementations_tpu_torch.core.config import TrainConfig as TCfg
    from dinunet_implementations_tpu_torch.models.msannet import MSANNet as TMSANNet
    from dinunet_implementations_tpu_torch.trainer.loop import FederatedTrainer

    mesh = tmesh.packed_site_mesh(S, S, device="cpu")
    cfg = TCfg().with_overrides(option)
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        FederatedTrainer(cfg, TMSANNet(in_size=F, hidden_sizes=(8,), out_size=2), mesh=mesh)
    with pytest.raises(TypeError, match="SiteMesh"):
        FederatedTrainer(TCfg(), TMSANNet(in_size=F, hidden_sizes=(8,), out_size=2),
                         mesh=object(), device="cpu")


def test_the_daemon_over_a_group_is_refused_naming_a11b(tmp_path):
    from dinunet_implementations_tpu_torch.runner.fed_runner import FedDaemon

    mesh = tmesh.packed_site_mesh(S, S, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A11 \(b\)"):
        FedDaemon(capacity=S, spool_dir=str(tmp_path / "spool"), out_dir=str(tmp_path),
                  mesh=mesh, device="cpu")
