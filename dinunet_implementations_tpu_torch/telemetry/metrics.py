"""On-device round metrics: the port of the JAX package's
``telemetry/metrics.py``.

A telemetry-on epoch (``trainer.make_train_epoch_fn(telemetry=True)``)
keeps, per site, a few scalars a round that the operator otherwise cannot
see:

- ``grad_sq_last``: this round's squared gradient norm ``Σ g²`` over the
  site's round gradient (what it ships, after DP and an attack). A
  non-finite value stays here as it is: "site 3's gradients blew up" is the
  signal;
- ``grad_sq_sum`` / ``grad_sq_max``: finite rounds only, across rounds;
- ``residual_sq_sum``: ``Σ ‖g_site − ĝ‖²`` over the shared (shipped)
  leaves, how far the engine's aggregate moved this site's gradient (the
  compression error for rankDAD and powerSGD);
- ``update_sq_last`` / ``update_sq_sum``: the squared norm of the applied
  optimizer update, the same in every site's row (the update is global);
- ``payload_bytes``: the engine's modeled wire bytes a round
  (:func:`payload_bytes_of`: under a ``wire_quant`` codec at the codec's
  dtype, as JAX's), ``dcn_bytes`` the inter-slice hop's (0.0 at one
  slice), ``rounds`` the rounds counted and ``held_rounds`` the rounds a
  slice quorum held (0: round telemetry over a process group, where slices
  run, is ROADMAP A20).

Every leaf is a ``[num_sites]`` tensor on the epoch's device, carried in
``TrainState.telemetry`` and checkpointed in JAX's layout. The values stay
on the device through the epoch: reading them is the caller's choice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: metric keys of ``TrainState.telemetry`` (sorted, JAX's)
TELEMETRY_KEYS = (
    "dcn_bytes",
    "grad_sq_last",
    "grad_sq_max",
    "grad_sq_sum",
    "held_rounds",
    "payload_bytes",
    "residual_sq_sum",
    "rounds",
    "update_sq_last",
    "update_sq_sum",
)

#: integer accumulators (the rest are f32)
_INT_KEYS = ("rounds", "held_rounds")


def default_round_telemetry(num_sites: int, device=None) -> dict:
    """Fresh all-zero accumulators with the per-site leading axis."""
    return {k: torch.zeros(num_sites, dtype=torch.int32 if k in _INT_KEYS else torch.float32,
                           device=device)
            for k in TELEMETRY_KEYS}


def jax_leaf_order(names, table=None) -> list:
    """``names`` (``state_dict`` names of one model's parameters, or a
    subset) in JAX's leaf order, the order ``jax.tree.leaves`` gives the
    params tree (``weights.LeafTable.leaf_index``); ``table`` defaults to
    the table of ``names`` themselves."""
    from ..weights import table_of

    index = (table or table_of({n: None for n in names})).leaf_index
    return sorted(names, key=index.__getitem__)


def tree_sq_sum(tree: dict, order=None, site_axis: bool = False):
    """``Σ x²`` over every leaf, accumulated in f32 a leaf at a time in
    ``order`` (default: JAX's leaf order, :func:`jax_leaf_order`). With
    ``site_axis`` every leaf carries a leading ``[S]`` site axis and the
    result is ``[S]``: one reduction of the whole leaf, never a loop over
    sites. The epoch and a host recompute call the same function, so their
    sums are equal bit for bit on the same device."""
    order = list(order) if order is not None else jax_leaf_order(list(tree))
    s = None
    for k in order:
        x = tree[k].float()
        part = (x * x).reshape(x.shape[0], -1).sum(1) if site_axis else (x * x).sum()
        s = part if s is None else s + part
    if s is None:
        raise ValueError("tree_sq_sum of an empty tree")
    return s


def payload_bytes_of(engine, grads_template: dict, pack: int = 1) -> float:
    """The modeled collective payload a round for one device: the engine's
    own wire model (``Engine.wire_shapes``, JAX's ``wire_bytes``) over the
    JAX leaf shapes of ``grads_template`` (one site's leaves by
    ``state_dict`` name), else every leaf shipped whole in f32. A Python
    float."""
    if getattr(engine, "wire_shapes", None) is not None:
        return float(engine.wire_bytes(grads_template, pack=pack))
    return float(sum(math.prod(g.shape) * 4 for g in grads_template.values()))


def dcn_bytes_of(engine, grads_template: dict, pack: int = 1, sites_per_slice: int = 1,
                 slices: int = 1) -> float:
    """The modeled inter-slice (DCN) payload a round for one slice, JAX's:
    0.0 at one slice (there is no inter-slice hop); else the engine's own
    model (``Engine.dcn_bytes``), or every leaf's slice partial whole at
    the engine's inter-slice dtype, else its wire dtype, else f32. A
    Python float."""
    if slices <= 1:
        return 0.0
    if getattr(engine, "dcn_wire_shapes", None) is not None:
        return float(engine.dcn_bytes(grads_template, pack=pack,
                                      sites_per_slice=sites_per_slice))
    d = (getattr(engine, "dcn_dtype", None) or getattr(engine, "wire_dtype", None)
         or torch.float32)
    return float(sum(math.prod(g.shape) * d.itemsize for g in grads_template.values()))


def modeled_wire_shapes(engine, grads_template: dict, pack: int = 1) -> list:
    """The structured model behind :func:`payload_bytes_of`: ``[(shape,
    torch dtype), ...]``, one entry per collective operand a round, JAX
    leaf shapes; one dense f32 operand a leaf without an engine model."""
    ws = getattr(engine, "wire_shapes", None)
    if ws is not None:
        return [(tuple(s), d) for s, d in ws(grads_template, pack=pack)]
    from ..engines.base import jax_shapes

    return [(s, torch.float32) for s in jax_shapes(grads_template).values()]


def telemetry_summary(telemetry) -> dict | None:
    """Host-side rollup of a fit's final ``TrainState.telemetry`` for the
    results, ``logs.json`` and ``metrics.jsonl``: plain floats, norms
    un-squared, JAX's keys. ``None`` in, ``None`` out (telemetry off)."""
    if telemetry is None:
        return None
    t = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
         for k, v in telemetry.items()}
    rounds = np.maximum(t["rounds"].astype(np.float64), 1.0)

    def norms(a):
        return [float(v) for v in np.sqrt(np.maximum(a.astype(np.float64), 0.0))]

    return {
        "site_grad_norm_last": [float(v) for v in np.sqrt(t["grad_sq_last"])],
        "site_grad_norm_max": norms(t["grad_sq_max"]),
        "site_grad_norm_mean": norms(t["grad_sq_sum"] / rounds),
        "site_residual_norm_mean": norms(t["residual_sq_sum"] / rounds),
        "update_norm_last": float(np.sqrt(max(float(t["update_sq_last"][0]), 0.0))),
        "payload_bytes_per_round": float(t["payload_bytes"][0] / rounds[0]),
        "dcn_bytes_per_round": (
            float(t["dcn_bytes"][0] / rounds[0]) if "dcn_bytes" in t else 0.0),
        "rounds": int(t["rounds"][0]),
        "held_rounds": int(t["held_rounds"][0]) if "held_rounds" in t else 0,
    }
