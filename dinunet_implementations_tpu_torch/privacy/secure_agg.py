"""Secure-aggregation masked wires: pairwise antisymmetric one-time pads
over the site axis that cancel exactly in the weighted site sum, the port
of the JAX package's ``privacy/secure_agg.py``.

Floating-point addition is not associative, so float pads could never
cancel bit for bit through a reduction. As real secure aggregation
(Bonawitz et al.) works in ``ℤ_R``, each site's weighted delta ``y_s =
scale_s·g_s`` is encoded onto a shared power-of-two fixed-point grid (per
leaf, per round), masked by int32 pads that are antisymmetric per
unordered pair (``pad(i, j) = −pad(j, i)``) and summed in int32, which
wraps mod 2³², where the pads cancel exactly in any order. Decoding the
sum is a cast and a power-of-two product. So:

- ``secure_agg="mask"`` and the pads-zeroed verification arm
  (``"mask-nopads"``) give bit-identical results at any liveness;
- dead sites renormalize: a pair is gated on both members' liveness, so
  cancellation is exact over the surviving cohort and the weighted mean
  renormalizes over live weight;
- the grid quantizes the aggregate to ``~2^-fb`` of each leaf's cross-site
  amax (``fb = 30 − ⌈log2 S⌉`` fractional bits, so the int32 sum of S grid
  values cannot overflow): the mode is not value-identical to the plain
  float mean.

On one card the sites' rows are all at hand: the site sum is a sum over
the leading ``[S]`` axis. Each pair's pad is drawn once, from a
``torch.Generator`` seeded by (seed, lo, hi, global round, leaf index)
(``robustness.attacks.draw_seed`` of kind "pad"), full-range int32 in the
leaf's JAX shape, added to ``lo``'s row and subtracted from ``hi``'s, and
zeroed when either member is dead this round. The
leaf index is the leaf's place among the leaves the engine aggregates in
JAX's ``jax.tree.flatten`` order. JAX draws its pads from threefry keys,
so the pads differ; the result does not, since the pads cancel.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import per_site, site_weight_scale

#: the accepted ``TrainConfig.secure_agg`` values. "off" is the plain mean;
#: "mask" the real mode; "mask-nopads" the verification arm, the same
#: fixed-point program with the pads zeroed (never deploy it)
SECURE_AGGS = ("off", "mask", "mask-nopads")


def secure_agg_enabled(secure_agg: str) -> bool:
    if secure_agg not in SECURE_AGGS:
        raise ValueError(f"secure_agg must be one of {SECURE_AGGS}, got {secure_agg!r}")
    return secure_agg != "off"


def fraction_bits(total_sites: int) -> int:
    """Fixed-point fractional bits for an S-site cohort: the sum of S grid
    values bounded by ±2^fb stays inside int32, so ``fb = 30 − ⌈log2 S⌉``
    (floored at 8)."""
    s = max(int(total_sites), 1)
    return max(30 - math.ceil(math.log2(max(s, 2))), 8)


def default_pad(key: tuple, shape, device) -> torch.Tensor:
    """A full-range uniform int32 ``shape`` draw from a ``torch.Generator``
    on ``device`` seeded with ``draw_seed("pad", key)``, ``key = (seed, lo,
    hi, rnd, leaf index)``. ``torch.randint`` over ``[-2³¹, 2³¹)``:
    ``Tensor.random_()`` on int32 draws only non-negative values."""
    from ..robustness.attacks import draw_seed, seeded_generator

    gen = seeded_generator(draw_seed("pad", key), device)
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), generator=gen, dtype=torch.int32,
                         device=device)


def masked_weighted_mean(tree: dict, weight, seed: int, rnd, live=None, pads: bool = True,
                         leaf_index=None, transposed=frozenset(), draw=default_pad) -> dict:
    """The secure-aggregation weighted mean of a site-batched payload dict
    ``{name: [S, ...]}`` (f32) at the example weights ``weight [S]``: each
    site's weighted delta on a shared per-leaf grid, pad-masked, summed in
    int32, decoded. Dead sites arrive zero-weighted (``mask_dead_site``
    upstream) and are left out of the pads by ``live [S]`` (None: all
    live); the scale renormalizes over live weight as the plain mean does.
    ``rnd`` is the global round; ``pads=False`` is the "mask-nopads" arm.
    ``leaf_index`` maps each name to the leaf's place among the aggregated
    leaves in JAX's order (default: the dict's order); ``transposed`` names
    the leaves stored as the transpose of their JAX matrix. Returns f32
    leaves without the site axis.

    Each leaf's grid is ``Δ = exp2(ceil(log2 amax)) · 2^-fb`` over the
    cross-site amax of the weighted deltas (1.0 in place of the power of
    two when amax is zero or not finite), ``q = round(y / Δ)`` (half to
    even) in int32."""
    if rnd is None:
        raise ValueError("secure aggregation needs the global round counter (rnd=): masks are "
                         "keyed per (pair, round)")
    if not tree:
        return {}
    S = next(iter(tree.values())).shape[0]
    fb = fraction_bits(S)
    scale = site_weight_scale(weight)
    pairs = [(lo, hi) for lo in range(S) for hi in range(lo + 1, S)]
    if pads and pairs:
        dev = next(iter(tree.values())).device
        lo_ix = torch.tensor([p[0] for p in pairs], device=dev)
        hi_ix = torch.tensor([p[1] for p in pairs], device=dev)
        # a pair with a dead member pads nothing: gated on the device, as
        # JAX gates each partner of its loop on the traced liveness
        gate = (None if live is None
                else ((live[lo_ix] > 0) & (live[hi_ix] > 0)).to(torch.int32))
    out = {}
    for i, (name, g) in enumerate(tree.items()):
        y = g.float() * per_site(scale, g)
        amax = y.abs().amax()
        ok = torch.isfinite(amax) & (amax > 0)
        ex = torch.where(ok, torch.exp2(torch.ceil(torch.log2(torch.where(ok, amax, 1.0)))),
                         1.0)
        delta = ex * (2.0 ** -fb)
        q = torch.round(y / delta).to(torch.int32)
        if pads and pairs:
            ix = i if leaf_index is None else leaf_index[name]
            tr = name in transposed
            shape = tuple(g.shape[1:])
            jshape = shape[:-2] + shape[-2:][::-1] if tr else shape
            drawn = [draw((int(seed), lo, hi, int(rnd), ix), jshape, g.device)
                     for lo, hi in pairs]
            P = torch.stack([d.mT if tr else d for d in drawn])  # [pairs, ...] int32
            if gate is not None:
                P = P * per_site(gate, P)
            # each pair's pad once into lo's row and once out of hi's, in
            # wrapping int32 arithmetic: what each site ships is q + pad
            # mod 2**32
            q = q + torch.zeros_like(q).index_add_(0, lo_ix, P).index_add_(0, hi_ix, P,
                                                                        alpha=-1)
        # the site sum mod 2**32: torch.sum widens int32 to int64, and the
        # cast back keeps the residue
        tot = q.sum(0, dtype=torch.int64).to(torch.int32)
        out[name] = tot.float() * delta
    return out
