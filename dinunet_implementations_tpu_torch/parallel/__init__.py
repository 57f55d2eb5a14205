from .collectives import (
    payload_cast,
    payload_dtype,
    payload_uncast,
    per_site,
    site_weight_scale,
    site_weighted_mean,
)

__all__ = ["payload_cast", "payload_dtype", "payload_uncast", "per_site", "site_weight_scale",
           "site_weighted_mean"]
