from .collectives import (
    ROBUST_AGGS,
    clip_site_gradients,
    payload_cast,
    payload_dtype,
    payload_uncast,
    per_site,
    robust_site_reduce,
    site_weight_scale,
    site_weighted_mean,
    weighted_coordinate_median,
    weighted_trimmed_mean,
)

__all__ = ["ROBUST_AGGS", "clip_site_gradients", "payload_cast", "payload_dtype",
           "payload_uncast", "per_site", "robust_site_reduce", "site_weight_scale",
           "site_weighted_mean", "weighted_coordinate_median", "weighted_trimmed_mean"]
