"""Cross-site reductions: the subset of the JAX package's
``parallel/collectives.py`` that the engines on one card use: the
weighted mean and the byzantine-robust reducers.

In JAX these are ``psum``s over a site mesh or ``vmap`` axis. Here every
site of the round lives on one card, so a site-batched value carries an
explicit leading ``[S]`` axis and the reduction is a sum over it.

``precision_bits`` payload casts: ``"16"`` is bfloat16, ``"16-ieee"`` the
reference's IEEE fp16, ``"32"`` f32. The weighted mean accumulates in f32
and is cast back to the payload dtype before :func:`payload_uncast`, as
the JAX ``site_weighted_mean`` does, so a 16-bit wire rounds both each
site's payload and the mean.
"""

from __future__ import annotations

import numpy as np
import torch

_PAYLOAD_DTYPES = {
    "32": torch.float32, 32: torch.float32,
    "16": torch.bfloat16, 16: torch.bfloat16,
    "16-ieee": torch.float16,
}


def payload_dtype(precision_bits="32") -> torch.dtype:
    """Resolve the ``precision_bits`` flag to the payload dtype."""
    return _PAYLOAD_DTYPES[precision_bits]


def per_site(v, like):
    """A per-site ``[S]`` vector (or any ``[S, ...]`` prefix) shaped to
    broadcast against an ``[S, ...]`` leaf."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def site_weight_scale(weight):
    """Per-site normalized weight ``w_s / Σ w`` over ``weight [S]``; an
    all-zero round gives scale 0, which keeps updates finite."""
    w = weight.float()
    total = w.sum()
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12), torch.zeros_like(w))


def payload_cast(tree: dict, precision_bits="32") -> dict:
    """Cast a gradient dict to the payload dtype before the reduction."""
    dtype = payload_dtype(precision_bits)
    return {k: g.to(dtype) for k, g in tree.items()}


def payload_uncast(tree: dict, like: dict) -> dict:
    """Restore each leaf's original dtype after the reduction."""
    return {k: g.to(like[k].dtype) for k, g in tree.items()}


def site_weighted_mean(tree: dict, weight) -> dict:
    """Example-count-weighted mean across sites: each site's ``[S, ...]``
    leaf contributes in proportion to ``weight [S]``, so the aggregate is
    the pooled-data gradient. Accumulates in f32 and casts back to each
    leaf's dtype."""
    scale = site_weight_scale(weight)
    return {k: (g.float() * per_site(scale, g)).sum(0).to(g.dtype) for k, g in tree.items()}


# ---------------------------------------------------------------------------
# byzantine-robust reducers over the site axis
# ---------------------------------------------------------------------------

#: the accepted ``robust_agg`` values. "none" is the weighted mean;
#: "norm_clip" clips each site's gradient norm to ``robust_clip_mult`` times
#: the live-weighted median site norm before the same weighted mean;
#: "trimmed_mean" and "coordinate_median" reduce each coordinate over the
#: sites' payloads. On one card every site's payload is already at hand
#: (the leading ``[S]`` axis), so there is no gather.
ROBUST_AGGS = ("none", "norm_clip", "trimmed_mean", "coordinate_median")


def check_robust_agg(robust_agg: str, trim_frac: float = 0.2) -> None:
    """JAX's ``ValueError`` for an unknown mode, and for a trimmed mean
    whose ``trim_frac`` is outside [0, 0.5)."""
    if robust_agg not in ROBUST_AGGS:
        raise ValueError(f"robust_agg must be one of {ROBUST_AGGS}, got {robust_agg!r}")
    if robust_agg == "trimmed_mean" and not 0.0 <= float(trim_frac) < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")


def _sorted_site_axis(vals, weight):
    """Sort ``vals [S, ...]`` along the site axis per coordinate (stably,
    as ``jnp.argsort``) and carry each site's weight with the permutation.
    Returns ``(v_sorted, w_sorted, cum, total)``: ``cum`` the inclusive
    cumulative weight in sorted order, ``total`` its last row."""
    v_sorted, order = torch.sort(vals, dim=0, stable=True)
    w = per_site(weight.float(), vals).expand_as(vals)
    w_sorted = torch.gather(w, 0, order)
    cum = torch.cumsum(w_sorted, dim=0)
    return v_sorted, w_sorted, cum, cum[-1:]


def weighted_trimmed_mean(vals, weight, trim_frac: float):
    """Per-coordinate weighted trimmed mean over the leading site axis:
    ``trim_frac`` of the total live weight dropped from each tail, each
    sorted entry contributing the overlap of its weight interval with the
    kept band (exact for fractional trims; a dead site, weight 0, never
    shifts the band). A coordinate with no live weight reduces to 0."""
    if not 0.0 <= float(trim_frac) < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
    v_sorted, w_sorted, cum, total = _sorted_site_axis(vals, weight)
    t = np.float32(trim_frac)  # the f32 products of JAX's band
    lo, hi = total * float(t), total * float(np.float32(1.0) - t)
    keep = torch.clamp(torch.minimum(cum, hi) - torch.maximum(cum - w_sorted, lo), min=0.0)
    out = (keep * v_sorted).sum(0) / torch.clamp(keep.sum(0), min=1e-12)
    return torch.where(total[0] > 0, out, torch.zeros_like(out))


def weighted_coordinate_median(vals, weight):
    """Per-coordinate weighted (lower) median over the leading site axis:
    the sorted value whose cumulative weight interval holds half the total
    live weight. A dead site is never picked; a coordinate with no live
    weight reduces to 0."""
    v_sorted, w_sorted, cum, total = _sorted_site_axis(vals, weight)
    mid = 0.5 * total
    keep = ((cum - w_sorted < mid) & (cum >= mid) & (w_sorted > 0)).float()
    out = (keep * v_sorted).sum(0) / torch.clamp(keep.sum(0), min=1.0)
    return torch.where(total[0] > 0, out, torch.zeros_like(out))


def robust_site_reduce(vals, weight, mode: str, trim_frac: float = 0.2):
    """One ``[S, ...]`` payload through the robust reducer ``mode``."""
    if mode == "trimmed_mean":
        return weighted_trimmed_mean(vals, weight, trim_frac)
    if mode == "coordinate_median":
        return weighted_coordinate_median(vals, weight)
    raise ValueError(f"unknown robust site reducer {mode!r}")


def site_flat(tree: dict):
    """A site-batched dict ``{name: [S, ...]}`` as one f32 ``[S, N]``
    buffer, its leaves side by side in the dict's order: the per-site
    norms, the clip and the robust reducers then take a few launches for
    the whole tree instead of a few a leaf."""
    S = next(iter(tree.values())).shape[0]
    return torch.cat([g.reshape(S, -1).float() for g in tree.values()], 1)


def site_unflat(flat, like: dict) -> dict:
    """:func:`site_flat` undone: ``flat [S, N]`` (or ``[N]``, a reduced
    buffer) back into ``like``'s leaves, each in its shape (without the
    site axis for ``[N]``) and dtype."""
    lead = flat.shape[:-1]
    parts = flat.split([g[0].numel() for g in like.values()], dim=-1)
    return {k: v.reshape(lead + g.shape[1:]).to(g.dtype)
            for (k, g), v in zip(like.items(), parts)}


def site_sq_norms(tree: dict):
    """Each site's ``Σ x²`` over a site-batched dict, in f32: ``[S]``."""
    flat = site_flat(tree)
    return (flat * flat).sum(1)


def robust_reduce_tree(tree: dict, weight, mode: str, trim_frac: float = 0.2) -> dict:
    """Every ``[S, ...]`` leaf of ``tree`` through the robust reducer
    ``mode`` in one sort of the site axis (:func:`site_flat`): each leaf's
    f32 reduction, in its shape without the site axis."""
    if not tree:
        return {}
    flat = robust_site_reduce(site_flat(tree), weight, mode, trim_frac)
    return site_unflat(flat, {k: g.float() for k, g in tree.items()})


def robust_clip_scales(nsq, weight, clip_mult: float):
    """The norm-clip defense's per-site scales: each site's squared
    gradient norm ``nsq [S]`` against ``clip_mult`` times the
    live-weighted median site norm (a hostile site cannot move a median it
    does not own). 1 for a site under the threshold."""
    med = weighted_coordinate_median(torch.sqrt(nsq.float()), weight)
    tau = med * float(np.float32(clip_mult))
    norm = torch.sqrt(nsq.float())
    return torch.where(norm > tau, tau / torch.clamp(norm, min=1e-30), torch.ones_like(norm))


def clip_site_gradients(grads: dict, weight, clip_mult: float) -> dict:
    """The norm-clip defense on site-batched gradients ``{name: [S,
    ...]}``: each site's whole tree scaled by :func:`robust_clip_scales`
    (f32, cast back). The weights are left alone: the weighted mean
    renormalizes as usual."""
    flat = site_flat(grads)
    scale = robust_clip_scales((flat * flat).sum(1), weight, clip_mult)
    return site_unflat(flat * scale[:, None], grads)
