"""dSGD, decentralized SGD: the example-weighted mean of the sites' full
gradients, with the ``precision_bits`` payload cast. The subset of the JAX
package's ``engines/dsgd.py`` for ``wire_quant="none"``,
``robust_agg="none"`` and ``secure_agg="off"``."""

from __future__ import annotations

from ..parallel.collectives import payload_cast, payload_dtype, payload_uncast, site_weighted_mean
from .base import Engine, mask_dead_site


def make_dsgd(precision_bits="32", wire_quant="none", robust_agg="none",
              secure_agg="off") -> Engine:
    for name, value, ported, item in (("wire_quant", wire_quant, "none", "A11 (WireCodec)"),
                                      ("robust_agg", robust_agg, "none", "A10 (robust_agg)"),
                                      ("secure_agg", secure_agg, "off", "A10 (secure_agg)")):
        if value != ported:
            raise NotImplementedError(f"dSGD {name}={value!r} is not ported: ROADMAP {item}")
    payload_dtype(precision_bits)  # rejects an unknown flag here, not in the first round

    def init(params):
        return {}

    def aggregate(grads, state, weight, live=None):
        grads, weight = mask_dead_site(grads, weight, live)
        payload = payload_cast(grads, precision_bits)
        return payload_uncast(site_weighted_mean(payload, weight), grads), state

    return Engine("dSGD", init, aggregate)
