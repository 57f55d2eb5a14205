"""One rank of test_torch_port_mesh.py's gloo world, and the cases and
port epochs that file shares with it (torch and the port only; it holds no
test). ``main(rank, port, dir)`` joins the world of 2, runs every case and
every codec case on its block of the sites and, on rank 0, writes each
case's gathered state, losses and collective counts to ``dir``; each rank
writes its own params, its block of a JAX checkpoint and, for each codec
case, the engine's aggregate over the group of one set of gradients."""

import numpy as np
import torch

from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.parallel import collectives as tcol
from dinunet_implementations_tpu_torch.parallel.distributed import (
    distributed_init,
    distributed_shutdown,
)
from dinunet_implementations_tpu_torch.parallel.mesh import packed_site_mesh
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import train_state_to_jax

WORLD = 2
S, STEPS, BATCH, F, EPOCHS = 4, 2, 4, 6, 2
ENGINE_KW = {"dSGD": {}, "rankDAD": dict(dad_reduction_rank=2, dad_num_pow_iters=2,
                                         dad_tol=1e-3),
             "powerSGD": dict(dad_reduction_rank=2)}
TABLE = MSANNet.leaf_table(1)
# the world's cases: (engine, dropout rate, site 1 dead in round 0)
CASES = {"dSGD": ("dSGD", 0.0, False), "rankDAD": ("rankDAD", 0.0, False),
         "powerSGD": ("powerSGD", 0.0, False), "dSGD-dead-site": ("dSGD", 0.0, True),
         "dSGD-dropout": ("dSGD", 0.3, False)}
# a wire: (precision_bits, wire_quant, wire_stochastic); the cases above run
# the f32 wire, the codec cases each other wire over the group
F32 = ("32", "none", False)
CODECS = {"int8": ("32", "int8", False), "int8-stochastic": ("32", "int8", True),
          "fp8": ("32", "fp8", False), "bf16": ("32", "bf16", False),
          "16": ("16", "none", False), "16-ieee": ("16-ieee", "none", False)}
CODEC_CASES = {f"{engine}-{codec}": (engine, CODECS[codec])
               for engine in ("dSGD", "rankDAD", "powerSGD") for codec in CODECS}


def all_runs() -> dict:
    """Every run of the world: ``name -> (engine, dropout, dead, wire)``."""
    runs = {name: case + (F32,) for name, case in CASES.items()}
    runs.update((name, (engine, 0.0, False, wire))
                for name, (engine, wire) in CODEC_CASES.items())
    return runs


def _wire_kw(wire) -> dict:
    pb, quant, stochastic = wire
    return dict(precision_bits=pb, wire_quant=quant, wire_stochastic=stochastic)


def _live(dead: bool):
    if not dead:
        return None
    live = np.ones((S, STEPS), np.float32)
    live[1, 0] = 0.0  # virtual site 1: the second row of rank 0's block
    return live


def _port_engine(engine, wire=F32):
    kw = dict(ENGINE_KW[engine], **_wire_kw(wire))
    if engine == "dSGD":
        return make_dsgd(**kw)
    if engine == "rankDAD":
        return make_rankdad(transposed=TABLE.transposed, **kw)
    return make_powersgd(transposed=TABLE.transposed, leaf_index=TABLE.leaf_index, **kw)


def agg_engine(engine, wire):
    """The engines of the one-set-of-gradients aggregate, as
    test_torch_port_wire.py builds them (plain leaves, rank 3)."""
    kw = _wire_kw(wire)
    if engine == "dSGD":
        return make_dsgd(**kw)
    if engine == "rankDAD":
        return make_rankdad(dad_reduction_rank=3, dad_num_pow_iters=2, dad_tol=1e-3, **kw)
    return make_powersgd(dad_reduction_rank=3, **kw)


def _rows(tree, block: slice):
    """A block of the leading site axis of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: _rows(v, block) for k, v in tree.items()}
    return None if tree is None else tree[block].contiguous()


def _port_epoch(engine, dropout, mesh=None, wire=F32):
    model = MSANNet(in_size=F, hidden_sizes=(8,), out_size=2, dropout_rate=dropout,
                    dropout_in=(0,) if dropout else ())
    return tsteps.make_train_epoch_fn(tsteps.FederatedTask(model),
                                      _port_engine(engine, wire),
                                      tsteps.make_optimizer("sgd", 1e-2), device="cpu",
                                      pipeline="host", mesh=mesh)


def main(rank: int, port: str, out: str) -> None:
    distributed_init(f"127.0.0.1:{port}", WORLD, rank, device="cpu", join_timeout_s=30,
                     join_deadline_s=60)
    try:
        mesh = packed_site_mesh(S, S // WORLD, device="cpu")
        data = np.load(f"{out}/data.npz")
        x, y, w = data["x"], data["y"], data["w"]
        for name, (engine, dropout, dead, wire) in all_runs().items():
            full = torch.load(f"{out}/init_{name}.pt", weights_only=False)
            state = tsteps.site_state_block(full, mesh)
            epoch = _port_epoch(engine, dropout, mesh, wire)
            tcol.reset_collective_counts()
            losses = []
            for _ in range(EPOCHS):
                state, lo = epoch(state, x, y, w, _live(dead))
                losses.extend(lo.tolist())
            counts = dict(tcol.COLLECTIVES)
            gathered = tsteps.gather_site_state(state, mesh)
            block = mesh.block(S)
            torch.save({"params": {k: v.numpy() for k, v in state.params.items()},
                        "block": [block.start, block.stop]}, f"{out}/rank{rank}_{name}.pt")
            if rank == 0:
                torch.save({"losses": np.array(losses), "collectives": counts,
                            "state": train_state_to_jax(gathered)}, f"{out}/result_{name}.pt")
                if name == "powerSGD":
                    tckpt.save_checkpoint(f"{out}/w2_psgd.msgpack", gathered)
        # each codec case's aggregate of one set of gradients over the group
        agg_in = torch.load(f"{out}/agg_in.pt", weights_only=False)
        block = mesh.block(S)
        for name, (engine, wire) in CODEC_CASES.items():
            agg, _ = agg_engine(engine, wire).aggregate(
                _rows(agg_in["grads"], block), _rows(agg_in["states"][name], block),
                agg_in["weight"][block], axis=mesh.axis(S))
            torch.save({k: v.numpy() for k, v in agg.items()}, f"{out}/agg{rank}_{name}.pt")
        # a JAX checkpoint of every site, restored into this rank's block
        like = tsteps.gather_site_state(
            tsteps.site_state_block(torch.load(f"{out}/init_powerSGD.pt", weights_only=False),
                                    mesh), mesh)
        back = tsteps.site_state_block(tckpt.load_checkpoint(f"{out}/jax_psgd.msgpack", like),
                                       mesh)
        torch.save(train_state_to_jax(back)["engine_state"], f"{out}/block{rank}.pt")
    finally:
        distributed_shutdown()
