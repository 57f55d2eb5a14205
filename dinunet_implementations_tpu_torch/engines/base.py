"""Aggregation-engine interface: the subset of the JAX package's
``engines/base.py`` that dSGD, rankDAD and powerSGD need.

An engine is a pair of functions the epoch runs every round:

- ``init(params) -> state``: the engine's state for ONE site, a dict:
  ``{}`` for dSGD, ``{"omega": {name: Ω [n, r] or None}}`` for rankDAD
  (a warm-start subspace per compressible leaf, None for a dense one),
  ``{"q": {name: [n, r] or None}, "e": {name: [m, n] or None}}`` for
  powerSGD (the right factor and the error-feedback residual).
  ``trainer.init_train_state`` stacks it per site (``[S, n, r]``), as the
  JAX trainer does, and the epoch freezes a dead site's rows for the round;
- ``aggregate(grads, state, weight, live=None, rnd=None, axis=None,
  total=None) -> (agg, state)``: per-site gradients (a dict of ``[S, ...]`` leaves), the
  per-site state and example weights ``[S]`` to the aggregated gradient (a
  dict of unbatched leaves) and the new per-site state. ``live [S]`` is the
  round's 0/1 contribute mask: a dead site's payload and weight are zeroed
  before the reduction, and the weighted mean renormalizes over live weight
  only. ``rnd`` is the global round, which keys dSGD's secure-aggregation
  pads (the other engines take and ignore it). ``axis`` (a
  ``parallel.collectives.PackedAxis``) runs the round over a process group:
  the leaves, the state and the weights are then this rank's ``[K]`` block
  of the ``S`` sites and every reduction is two-level; the aggregate is the
  same on every rank. ``total``, when the caller has it, is the live
  weight's sum over every site (``Σ weight·live``): the engine then takes
  no collective of its own for it.

Every engine takes ``wire_quant`` (``parallel.collectives.WIRE_QUANTS``)
and ``wire_stochastic``: its payloads go through the wire codec, as JAX's,
and ``Engine.wire_dtype`` is what one element costs on the wire.

Slices: every engine takes ``dcn_wire_quant`` (``""`` follows
``wire_quant``, ``"none"`` is the fused form; parallel/collectives.py
``resolve_dcn_codec``). Over a sliced axis the codec rounds each slice's
partial (or each site row of a slice's gathered block) before the
inter-slice hop. ``dcn_wire_shapes(grads, pack=1, sites_per_slice=1)``
and ``dcn_bytes`` model what ONE slice ships across that hop a round,
JAX's integers; ``dcn_dtype`` is the inter-slice codec's dtype (None for
the fused form).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..parallel.collectives import per_site


def mask_dead_site(grads: dict, weight, live):
    """Zero a dead site's contribution before any reduction.

    ``torch.where``, not ``g * live``: a quarantined site's gradient is
    typically non-finite and ``NaN * 0`` is NaN. Returns ``(grads,
    weight)`` unchanged when ``live is None``."""
    if live is None:
        return grads, weight
    alive = live.float() > 0
    grads = {k: torch.where(per_site(alive, g), g, torch.zeros((), dtype=g.dtype, device=g.device))
             for k, g in grads.items()}
    return grads, weight * alive.float()


#: ``age`` of a slot whose buffer was never deposited into (a fresh join, a
#: fresh state): stale past any bound, and its deposited weight is 0 too.
#: Far below int32 overflow after one increment a round for any fit.
ASYNC_NEVER_AGE = 1 << 20


def default_async_buffers(num_sites: int, params: dict) -> dict:
    """Fresh per-slot staleness buffers of the buffered-async rounds, with
    the leading site axis: ``grads`` (the slot's last deposited gradient by
    ``state_dict`` name, zeros until one arrives), ``weight`` (its example
    weight at deposit, 0 = never) and ``age`` (rounds since the deposit,
    :data:`ASYNC_NEVER_AGE` = never), as JAX's ``default_async_buffers``."""
    dev = next(iter(params.values())).device
    return {
        "grads": {k: torch.zeros((num_sites,) + tuple(p.shape), dtype=p.dtype, device=dev)
                  for k, p in params.items()},
        "weight": torch.zeros(num_sites, dtype=torch.float32, device=dev),
        "age": torch.full((num_sites,), ASYNC_NEVER_AGE, dtype=torch.int32, device=dev),
    }


def staleness_weights(age, staleness_bound: int, staleness_decay: float):
    """Each slot's weight factor: ``decay ** age`` while ``age <=
    staleness_bound``, 0 past it (an update older than the bound counts as
    a dead site's). ``age == 0`` gives exactly 1.0, which makes an async
    round where every site arrives the bulk-sync round bit for bit."""
    fresh = (age <= staleness_bound).float()
    # a Python base: a tensor made from it would be copied to the card from
    # pageable memory every round, which waits for the device
    return fresh * torch.pow(staleness_decay, age.float())


def refuse_secure_agg(secure_agg) -> None:
    """The low-rank engines' check of ``secure_agg``: JAX's ``ValueError``
    for an unknown mode and for any mode but "off"."""
    from ..privacy.secure_agg import secure_agg_enabled

    if secure_agg_enabled(secure_agg):
        raise ValueError(
            f"secure_agg={secure_agg!r} is only supported by the dSGD engine: the low-rank "
            "engines gather per-site factors, which a masked psum wire cannot carry")


def robust_gather_wire(pack: int, robust_agg: str) -> list:
    """The robust modes' bookkeeping gathers that every engine's wire model
    adds, as JAX's: ``norm_clip`` gathers the per-site norm and weight
    vectors, the gather-based reducers the weight vector only."""
    f32 = torch.float32
    if robust_agg == "norm_clip":
        return [((pack,), f32), ((pack,), f32)]
    if robust_agg in ("trimmed_mean", "coordinate_median"):
        return [((pack,), f32)]
    return []


def robust_gather_dcn_wire(sites_per_slice: int, robust_agg: str) -> list:
    """The robust bookkeeping gathers' inter-slice operands, JAX's: the
    slice's assembled ``[sites_per_slice]`` vectors at f32, never through
    the inter-slice codec."""
    f32 = torch.float32
    if robust_agg == "norm_clip":
        return [((sites_per_slice,), f32), ((sites_per_slice,), f32)]
    if robust_agg in ("trimmed_mean", "coordinate_median"):
        return [((sites_per_slice,), f32)]
    return []


def wire_shapes_bytes(shapes) -> int:
    """The byte total of a wire model ``[(shape, dtype), ...]``."""
    return sum(math.prod(s) * d.itemsize for s, d in shapes)


def jax_shapes(grads: dict, transposed=frozenset()) -> dict:
    """One site's leaf shapes in the JAX layout, by name: reversed for a
    leaf named in ``transposed``."""
    return {k: tuple(g.shape)[::-1] if k in transposed else tuple(g.shape)
            for k, g in grads.items()}


@dataclass(frozen=True)
class Engine:
    name: str
    init: Callable  # params -> state
    aggregate: Callable  # (grads, state, weight, live=None, rnd=None, axis=None, total=None)
    # (grads, pack=1) -> [(shape, dtype), ...] (module docstring); None:
    # the telemetry's dense f32 fallback
    wire_shapes: Callable | None = None
    # what one payload element costs on the wire (the codec's dtype)
    wire_dtype: torch.dtype | None = None
    # (grads, pack=1, sites_per_slice=1) -> [(shape, dtype), ...]: what one
    # slice ships across the inter-slice hop a round (module docstring)
    dcn_wire_shapes: Callable | None = None
    # the inter-slice codec's dtype; None: the fused form
    dcn_dtype: torch.dtype | None = None

    def wire_bytes(self, grads: dict, pack: int = 1) -> int:
        """The modeled payload one device ships a round (module
        docstring): JAX's ``wire_bytes``, an exact integer."""
        if self.wire_shapes is None:
            raise NotImplementedError(f"engine {self.name!r} has no wire model")
        return wire_shapes_bytes(self.wire_shapes(grads, pack=pack))

    def dcn_bytes(self, grads: dict, pack: int = 1, sites_per_slice: int = 1) -> int:
        """The modeled payload one slice ships across the inter-slice hop
        a round: JAX's ``dcn_bytes``, an exact integer."""
        if self.dcn_wire_shapes is None:
            raise NotImplementedError(f"engine {self.name!r} has no inter-slice wire model")
        return wire_shapes_bytes(self.dcn_wire_shapes(grads, pack=pack,
                                                      sites_per_slice=sites_per_slice))


#: the ROADMAP item of the epoch's planes that the port does not yet run
#: over a process group
MESH_PLANES_ITEM = "A20 (the epoch's planes over a process group)"


def refuse_on_mesh(axis, **modes) -> None:
    """``NotImplementedError`` naming :data:`MESH_PLANES_ITEM` for the
    first of ``modes`` (name → whether it is on) that is on while ``axis``
    is a process group's: those modes are held against JAX with every site
    on one device only."""
    if axis is None:
        return
    for name, on in modes.items():
        if on:
            raise NotImplementedError(f"{name} over a process group (mesh) is not ported: "
                                      f"ROADMAP {MESH_PLANES_ITEM}")
