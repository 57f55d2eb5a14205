"""One rank of test_torch_port_slices.py's gloo worlds, and the cases that
file shares with it (torch and the port only; it holds no test).
``main(rank, world, port, dir)`` joins a world of ``world`` ranks laid as
two slices, runs every case of :func:`world_runs` on its block of the
``S = 2·world`` sites (K = 2 a rank) and, on rank 0, writes each case's
losses, held rounds, collective counts and gathered state to ``dir``;
each rank writes its params, its mesh facts, the slice tier's primitives
and each aggregate case's result over the group of one set of gradients.
"""

import json

import numpy as np
import torch

from dinunet_implementations_tpu_torch.core.config import TrainConfig
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.parallel import collectives as tcol
from dinunet_implementations_tpu_torch.parallel import distributed as tdist
from dinunet_implementations_tpu_torch.parallel import mesh as tmesh
from dinunet_implementations_tpu_torch.runner.fed_runner import auto_site_mesh
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_to_jax

K, SLICES, STEPS, BATCH, F, EPOCHS = 2, 2, 2, 4, 6, 2
ENGINES = ("dSGD", "rankDAD", "powerSGD")
ENGINE_KW = {"dSGD": {}, "rankDAD": dict(dad_reduction_rank=2, dad_num_pow_iters=2,
                                         dad_tol=1e-3),
             "powerSGD": dict(dad_reduction_rank=2)}
TABLE = MSANNet.leaf_table(1)
# the split form's inter-slice codecs: (dcn_wire_quant, wire_stochastic);
# the intra-slice wire stays f32 (wire_quant "none")
DCN_CODECS = {"int8": ("int8", False), "int8-stochastic": ("int8", True),
              "fp8": ("fp8", False), "bf16": ("bf16", False)}
# slice 1 dead in round 0 of each epoch, back in round 1
SLICE_DROP = [[1.0, 1.0], [0.0, 1.0]]


def sites(world: int) -> int:
    return K * world


def site_drop(world: int) -> np.ndarray:
    """The same death as :data:`SLICE_DROP` through the site mask: slice
    1's band of sites (slice-major) out of round 0."""
    live = np.ones((sites(world), STEPS), np.float32)
    live[sites(world) // 2:, 0] = 0.0
    return live


def world_runs(world: int) -> dict:
    """Every epoch run of a world: ``name -> dict(engine, topology
    ("flat": the unsliced mesh, "sliced"), dcn codec name or None, live
    ("site-drop" or None), slice_live (bool), min_slices)``."""
    runs = {}
    for engine in ENGINES:
        runs[f"{engine}-flat"] = dict(engine=engine, topology="flat")
        runs[f"{engine}-fused"] = dict(engine=engine, topology="sliced")
        codecs = DCN_CODECS if world == 2 else {"int8": DCN_CODECS["int8"]}
        for codec in codecs:
            runs[f"{engine}-{codec}"] = dict(engine=engine, topology="sliced", dcn=codec)
        if world == 2:
            runs[f"{engine}-slice-drop"] = dict(engine=engine, topology="sliced",
                                                slice_live=True)
            runs[f"{engine}-site-drop"] = dict(engine=engine, topology="sliced",
                                               live="site-drop")
    runs["dSGD-flat-site-drop"] = dict(engine="dSGD", topology="flat", live="site-drop")
    if world == 4:
        runs["dSGD-slice-drop"] = dict(engine="dSGD", topology="sliced", slice_live=True)
    runs["dSGD-quorum"] = dict(engine="dSGD", topology="sliced", slice_live=True, min_slices=2)
    return {k: {"dcn": None, "live": None, "slice_live": False, "min_slices": 1, **v}
            for k, v in runs.items()}


def engine_kw(engine: str, dcn=None) -> dict:
    """The engine's keywords: the f32 wire, and the split form's codec."""
    kw = dict(ENGINE_KW[engine])
    if dcn is not None:
        quant, stochastic = DCN_CODECS[dcn]
        kw.update(dcn_wire_quant=quant, wire_stochastic=stochastic)
    else:
        kw.update(dcn_wire_quant="none")
    return kw


def port_engine(engine: str, dcn=None):
    kw = engine_kw(engine, dcn)
    if engine == "dSGD":
        return make_dsgd(**kw)
    if engine == "rankDAD":
        return make_rankdad(transposed=TABLE.transposed, **kw)
    return make_powersgd(transposed=TABLE.transposed, leaf_index=TABLE.leaf_index, **kw)


def agg_engine(engine: str, dcn: str):
    """test_torch_port_wire.py's engines (plain leaves, rank 3) with the
    split form's codec."""
    kw = engine_kw(engine, dcn)
    if engine == "dSGD":
        return make_dsgd(**kw)
    if engine == "rankDAD":
        kw.update(dad_reduction_rank=3)
        return make_rankdad(**kw)
    return make_powersgd(**{**kw, "dad_reduction_rank": 3})


def port_epoch(run: dict, mesh):
    model = MSANNet(in_size=F, hidden_sizes=(8,), out_size=2)
    return tsteps.make_train_epoch_fn(tsteps.FederatedTask(model),
                                      port_engine(run["engine"], run["dcn"]),
                                      tsteps.make_optimizer("sgd", 1e-2), device="cpu",
                                      pipeline="host", mesh=mesh,
                                      min_slices=run["min_slices"])


def _rows(tree, block: slice):
    if isinstance(tree, dict):
        return {k: _rows(v, block) for k, v in tree.items()}
    return None if tree is None else tree[block].contiguous()


def _error(fn) -> list:
    """``[type name, message]`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares type and text
        return [type(e).__name__, str(e)]
    return None


def primitives(mesh, rank: int) -> dict:
    """The slice tier's primitives on this rank: the fused form against the
    flat collective, the slice gate, the split form by hand and the
    hierarchical gather's order."""
    axes = mesh.axis(sites(mesh.world))
    flat = tcol.PackedAxis(mesh.group, K, mesh.world, rank)
    x = torch.arange(K * 6, dtype=torch.float32).reshape(K, 6) / 7 + rank
    fused = tcol.three_level_psum(x, axes)
    want = tcol.two_level_psum(x, flat)
    gated = tcol.three_level_psum(x, axes, slice_live=1.0 if mesh.slice_id == 0 else 0.0)
    slice0 = tcol.psum(x.sum(0) * (1.0 if mesh.slice_id == 0 else 0.0), flat)
    codec = tcol.resolve_wire_codec("32", "int8")
    split = tcol.three_level_psum(x, axes, dcn_wire=codec)
    # the split form by hand: each slice's partial through the codec, summed
    parts = tcol.site_all_gather(x.sum(0, keepdim=True), flat)  # [W, 6]
    per = mesh.per_slice
    by_hand = sum(codec.compress(parts[sl * per:(sl + 1) * per].sum(0))
                  for sl in range(SLICES))
    block = torch.full((K, 3), float(rank))
    gathered = tcol.site_all_gather(block, axes)
    tree = {"a": x, "b": x[:, :2] * 3}
    tsum = tcol.weighted_tree_sum(tree, torch.ones(K), axes, dcn_wire=codec)
    tsum_flat = {k: tcol.three_level_psum(v, axes, dcn_wire=codec) for k, v in tree.items()}
    return {"fused_is_flat": bool(torch.equal(fused, want)),
            "gate_keeps_slice_0": bool(torch.equal(gated, slice0)),
            "split_by_hand": bool(torch.equal(split, by_hand)),
            "gather_order": gathered[:, 0].tolist(),
            "tree_split_is_leafwise": all(bool(torch.equal(tsum[k], tsum_flat[k])) for k in tree)}


def mesh_facts(mesh, world: int) -> dict:
    """The mesh's shape, this rank's slice, block and groups, the resolvers
    and the multi-process validation."""
    S = sites(world)
    auto = auto_site_mesh(TrainConfig(num_slices=SLICES), S, device="cpu")
    default = tdist.multihost_sliced_site_mesh(device="cpu")
    return {"shape": mesh.shape, "axis_names": list(mesh.axis_names),
            "slice_id": mesh.slice_id, "block": [mesh.block(S).start, mesh.block(S).stop],
            "slice_count": tmesh.slice_count(mesh), "site_axis": tmesh.site_axis_of(mesh),
            "auto": {"shape": auto.shape, "pack": auto.pack, "slices": auto.slices},
            "default": {"shape": default.shape, "pack": default.pack},
            "errors": {
                "too_few_ranks": _error(lambda: tmesh.sliced_site_mesh(SLICES, S, 1,
                                                                       device="cpu")),
                "slices_not_dividing": _error(lambda: tdist.multihost_sliced_site_mesh(
                    num_slices=3, device="cpu")),
                "members_not_dividing": _error(lambda: tdist.multihost_sliced_site_mesh(
                    num_slices=1, sites_per_slice=world + 1, device="cpu")),
            }}


def main(rank: int, world: int, port: str, out: str) -> None:
    tdist.distributed_init(f"127.0.0.1:{port}", world, rank, device="cpu", join_timeout_s=30,
                           join_deadline_s=60)
    try:
        S = sites(world)
        meshes = {"flat": tmesh.packed_site_mesh(S, K, device="cpu"),
                  "sliced": tmesh.sliced_site_mesh(SLICES, S // SLICES, K, device="cpu")}
        data = np.load(f"{out}/data{world}.npz")
        x, y, w = data["x"], data["y"], data["w"]
        for name, run in world_runs(world).items():
            mesh = meshes[run["topology"]]
            init = torch.load(f"{out}/init{world}_{run['engine']}.pt", weights_only=False)
            state = tsteps.site_state_block(init, mesh)
            epoch = port_epoch(run, mesh)
            live = site_drop(world) if run["live"] else None
            slice_live = np.asarray(SLICE_DROP, np.float32) if run["slice_live"] else None
            tcol.reset_collective_counts()
            losses, held = [], []
            for _ in range(EPOCHS):
                state, lo = epoch(state, x, y, w, live, None, slice_live)
                losses.extend(lo.tolist())
                held.extend(bool(h) for t in epoch.held_rounds for h in t.tolist())
            counts = dict(tcol.COLLECTIVES)
            one = None
            if run["min_slices"] > 1:
                # one held round alone: nothing the state carries may move
                first = tsteps.site_state_block(init, mesh)
                after, lo1 = epoch(first, x[:, :1], y[:, :1], w[:, :1], None, None,
                                   slice_live[:, :1])
                g0 = train_state_to_jax(tsteps.gather_site_state(first, mesh))
                g1 = train_state_to_jax(tsteps.gather_site_state(after, mesh))
                one = {"loss": lo1.tolist(), "before": g0, "after": g1}
            gathered = tsteps.gather_site_state(state, mesh)
            torch.save({k: v.numpy() for k, v in state.params.items()},
                       f"{out}/w{world}_rank{rank}_{name}.pt")
            if rank == 0:
                torch.save({"losses": np.array(losses), "held": held, "collectives": counts,
                            "state": train_state_to_jax(gathered), "one_held_round": one},
                           f"{out}/w{world}_result_{name}.pt")
        sliced = meshes["sliced"]
        facts = {"mesh": mesh_facts(sliced, world), "primitives": primitives(sliced, rank)}
        with open(f"{out}/w{world}_facts{rank}.json", "w") as fh:
            json.dump(facts, fh)
        # each split codec's aggregate of one set of gradients over the group
        agg_in = torch.load(f"{out}/agg_in{world}.pt", weights_only=False)
        block = sliced.block(S)
        for name, (engine, dcn) in agg_in["cases"].items():
            agg, _ = agg_engine(engine, dcn).aggregate(
                _rows(agg_in["grads"], block), _rows(agg_in["states"][name], block),
                agg_in["weight"][block], axis=sliced.axis(S))
            torch.save({k: v.numpy() for k, v in agg.items()},
                       f"{out}/w{world}_agg{rank}_{name}.pt")
    finally:
        tdist.distributed_shutdown()
