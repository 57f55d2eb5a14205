"""dSGD, decentralized SGD: the example-weighted mean of the sites' full
gradients, with the ``precision_bits`` payload cast or the wire codec
(``wire_quant``: each site's payload rounded through the codec's grid,
one scale a site). The port of the JAX package's ``engines/dsgd.py``,
with its byzantine-robust modes (``robust_agg``) and its
secure-aggregation masked wire (``secure_agg``):

- ``"norm_clip"`` clips each site's gradient to ``robust_clip_mult``
  times the live-weighted median site norm before the same weighted mean;
- ``"trimmed_mean"`` and ``"coordinate_median"`` reduce each coordinate
  of the sites' payloads (each cast to the payload dtype, as each site's
  wire would carry it) by the live-weighted trimmed mean or median; the
  reduction runs in f32 and is cast to the gradient's dtype;
- ``secure_agg="mask"`` (or the pads-zeroed ``"mask-nopads"``) replaces
  the weighted mean with privacy/secure_agg.py's fixed-point, pad-masked
  sum of each site's payload (rounded through the payload dtype first);
  ``norm_clip`` composes (it clips before the masking), the gather-based
  reducers and the quantized or inter-slice wire codecs do not, as in
  JAX. Its pads are keyed by the global round, ``aggregate(..., rnd=)``.

Over a process group (``aggregate(..., axis=)``) the weighted mean is
two-level, as JAX's packed axis: each rank's weighted partial over its
``[K]`` sites goes through the wire (the payload dtype, or the codec
again) and the whole tree is summed over the group in one collective.
Over slices with an inter-slice codec (``dcn_wire_quant``) the tree's
slice partials cross the inter-slice hop as ONE vector, each leaf's
partial through the codec on its own scale. The robust modes and the
masked wire run with every site on one device only.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import (
    check_robust_agg,
    clip_site_gradients,
    codec_payload,
    payload_uncast,
    resolve_dcn_codec,
    resolve_wire_codec,
    robust_reduce_tree,
    site_weighted_mean,
)
from ..privacy.secure_agg import masked_weighted_mean, secure_agg_enabled
from .base import (
    Engine,
    jax_shapes,
    mask_dead_site,
    refuse_on_mesh,
    robust_gather_dcn_wire,
    robust_gather_wire,
)


def make_dsgd(precision_bits="32", wire_quant="none", robust_agg="none",
              secure_agg="off", robust_trim_frac: float = 0.2,
              robust_clip_mult: float = 2.5, secure_agg_seed: int = 0,
              dcn_wire_quant: str = "", leaf_index=None, transposed=frozenset(),
              wire_stochastic: bool = False) -> Engine:
    """``leaf_index`` and ``transposed`` lay out the secure-aggregation pads
    (each leaf's place among the aggregated leaves in JAX's order, and the
    leaves stored as the transpose of their JAX matrix); the result does
    not depend on them."""
    secure = secure_agg_enabled(secure_agg)
    if secure and wire_quant in ("int8", "fp8"):
        raise ValueError(
            f"secure_agg={secure_agg!r} cannot compose with wire_quant={wire_quant!r}: a float "
            "codec grid on the wire destroys the integer pad cancellation (bf16 and the plain "
            "precision_bits wires compose — the payload pre-rounds, the wire stays int32)")
    if secure and robust_agg in ("trimmed_mean", "coordinate_median"):
        raise ValueError(
            f"secure_agg={secure_agg!r} cannot compose with robust_agg={robust_agg!r}: the "
            "gather-based reducers need every site's payload in the clear (norm_clip composes "
            "— it runs before masking on the unchanged psum wire)")
    if secure and dcn_wire_quant not in ("", "none"):
        raise ValueError(
            f"secure_agg={secure_agg!r} cannot compose with a DCN wire codec (dcn_wire_quant="
            f"{dcn_wire_quant!r}): re-quantizing the per-slice int32 partial through a float "
            "grid destroys pad cancellation — set dcn_wire_quant='none' (the fused exact "
            "(slice, site) reduce)")
    codec = resolve_wire_codec(precision_bits, wire_quant, wire_stochastic)
    # the inter-slice codec: None is the fused form; the masked wire always
    # takes it ("" following a bf16 wire_quant would not)
    dcn = (None if secure else
           resolve_dcn_codec(precision_bits, wire_quant, dcn_wire_quant, wire_stochastic))
    ddtype = None if dcn is None else dcn.dtype
    check_robust_agg(robust_agg, robust_trim_frac)
    gather_mode = robust_agg in ("trimmed_mean", "coordinate_median")

    def init(params):
        return {}

    def aggregate(grads, state, weight, live=None, rnd=None, axis=None, total=None):
        refuse_on_mesh(axis, robust_agg=robust_agg != "none", secure_agg=secure)
        grads, weight = mask_dead_site(grads, weight, live)
        if robust_agg == "norm_clip":
            grads = clip_site_gradients(grads, weight, robust_clip_mult)
        # each site's payload as its wire carries it: the precision_bits
        # cast, or the codec's grid (f32)
        payload = codec_payload(grads, codec, precision_bits)
        if gather_mode:
            agg = robust_reduce_tree(payload, weight, robust_agg, robust_trim_frac)
            return payload_uncast(agg, grads), state
        if secure:
            agg = masked_weighted_mean(
                {k: g.float() for k, g in payload.items()}, weight, secure_agg_seed, rnd,
                live=live, pads=secure_agg != "mask-nopads", leaf_index=leaf_index,
                transposed=transposed)
            return payload_uncast(agg, grads), state
        # over a group each rank's partial crosses the wire again, as
        # JAX's packed axis: at the payload dtype, or through the codec
        wire = pdtype if codec.quant == "none" else codec
        return payload_uncast(site_weighted_mean(payload, weight, axis, wire, total, dcn),
                              grads), state

    pdtype = codec.dtype
    transposed = frozenset(transposed)

    def wire_shapes(grads, pack: int = 1) -> list:
        """JAX's model: one psum a leaf at the payload dtype; the gather
        modes one ``[pack, ...]`` block a leaf; the masked wire the same
        leaves at int32 and the ``[pack]`` liveness gather."""
        shapes = list(jax_shapes(grads, transposed).values())
        extras = robust_gather_wire(pack, robust_agg)
        if gather_mode:
            return [((pack,) + s, pdtype) for s in shapes] + extras
        if secure:
            return ([(s, torch.int32) for s in shapes] + [((pack,), torch.float32)]
                    + extras)
        return [(s, pdtype) for s in shapes] + extras

    def dcn_wire_shapes(grads, pack: int = 1, sites_per_slice: int = 1) -> list:
        """JAX's inter-slice model: the gather modes ship the slice's
        ``[sites_per_slice, ...]`` block a leaf, the masked wire its int32
        partials and the slice's liveness vector; under an inter-slice codec
        the whole tree as ONE vector at its dtype, else each leaf's partial
        at the payload dtype (the fused collective's operand)."""
        shapes = list(jax_shapes(grads, transposed).values())
        extras = robust_gather_dcn_wire(sites_per_slice, robust_agg)
        if gather_mode:
            return [((sites_per_slice,) + s, ddtype or pdtype) for s in shapes] + extras
        if secure:
            return ([(s, torch.int32) for s in shapes]
                    + [((sites_per_slice,), torch.float32)] + extras)
        if ddtype is not None:
            return [((sum(math.prod(s) for s in shapes),), ddtype)] + extras
        return [(s, pdtype) for s in shapes] + extras

    return Engine("dSGD", init, aggregate, wire_shapes=wire_shapes,
                  wire_dtype=torch.int32 if secure else pdtype,
                  dcn_wire_shapes=dcn_wire_shapes, dcn_dtype=ddtype)
