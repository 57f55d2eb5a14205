"""dSGD, decentralized SGD: the example-weighted mean of the sites' full
gradients, with the ``precision_bits`` payload cast. The subset of the JAX
package's ``engines/dsgd.py`` for ``wire_quant="none"`` and
``secure_agg="off"``, with its byzantine-robust modes (``robust_agg``):

- ``"norm_clip"`` clips each site's gradient to ``robust_clip_mult``
  times the live-weighted median site norm before the same weighted mean;
- ``"trimmed_mean"`` and ``"coordinate_median"`` reduce each coordinate
  of the sites' payloads (each cast to the payload dtype, as each site's
  wire would carry it) by the live-weighted trimmed mean or median; the
  reduction runs in f32 and is cast to the gradient's dtype.
"""

from __future__ import annotations

from ..parallel.collectives import (
    check_robust_agg,
    clip_site_gradients,
    payload_cast,
    payload_dtype,
    payload_uncast,
    robust_reduce_tree,
    site_weighted_mean,
)
from .base import Engine, mask_dead_site


def make_dsgd(precision_bits="32", wire_quant="none", robust_agg="none",
              secure_agg="off", robust_trim_frac: float = 0.2,
              robust_clip_mult: float = 2.5) -> Engine:
    for name, value, ported, item in (("wire_quant", wire_quant, "none", "A11 (WireCodec)"),
                                      ("secure_agg", secure_agg, "off", "A10 (c) (secure_agg)")):
        if value != ported:
            raise NotImplementedError(f"dSGD {name}={value!r} is not ported: ROADMAP {item}")
    check_robust_agg(robust_agg, robust_trim_frac)
    payload_dtype(precision_bits)  # rejects an unknown flag here, not in the first round
    gather_mode = robust_agg in ("trimmed_mean", "coordinate_median")

    def init(params):
        return {}

    def aggregate(grads, state, weight, live=None):
        grads, weight = mask_dead_site(grads, weight, live)
        if robust_agg == "norm_clip":
            grads = clip_site_gradients(grads, weight, robust_clip_mult)
        payload = payload_cast(grads, precision_bits)
        if gather_mode:
            agg = robust_reduce_tree(payload, weight, robust_agg, robust_trim_frac)
            return payload_uncast(agg, grads), state
        return payload_uncast(site_weighted_mean(payload, weight), grads), state

    return Engine("dSGD", init, aggregate)
