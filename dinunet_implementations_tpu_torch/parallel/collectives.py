"""Cross-site reductions: the subset of the JAX package's
``parallel/collectives.py`` that dSGD on one card uses.

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
