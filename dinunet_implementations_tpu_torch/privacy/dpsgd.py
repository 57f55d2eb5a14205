"""DP-SGD: per-site clipping and calibrated Gaussian noise, the port of
the JAX package's ``privacy/dpsgd.py``.

The transform runs on every site's finished round gradient, before the
engine (and before rankDAD's or powerSGD's compression) and before an
``AttackPlan``'s transform of a hostile site: clip the site's gradient to
the L2 norm ``dp_clip`` (C), then add ``dp_noise_multiplier·C`` (σ·C) of
Gaussian noise to each leaf. What leaves the site is then a noised
quantity of bounded sensitivity; the accountant (privacy/accounting.py)
turns the (σ, q, rounds) trajectory into (ε, δ), composing at σ/2 because
this mechanism clips the round-mean gradient
(``accounting.MEAN_CLIP_SENSITIVITY_FACTOR``).

The transform works on the port's site-batched round gradient ``{name:
[S, ...]}``: one f32 ``[S, N]`` view of the shared leaves gives every
site's norm at once (``parallel.collectives.site_flat``). Each noise draw
comes from a ``torch.Generator`` seeded by (dp_seed, site row, global
round, JAX leaf index) (``robustness.attacks.draw_seed`` of kind "dp"), the
leaf index being the leaf's place in JAX's ``jax.tree.flatten`` order of
the full params tree (``weights.LeafTable.leaf_index``), drawn in the JAX
leaf shape and transposed for the ``nn.Linear`` weights: the noise replays
the same whatever the epoch chunking or the resume point. JAX draws from
its threefry counter keys, so the numbers differ; ``draw=`` takes any other
source, which is how the tests hand JAX's draws across.

Off: ``dp_clip == 0 and dp_noise_multiplier == 0`` builds no transform.
Noise without a clip has no finite sensitivity, hence no guarantee:
``dp_noise_multiplier > 0`` needs ``dp_clip > 0``. Clipping alone is a
robustness transform with ε = ∞.

Personalized heads (privacy/personalize.py) never leave their site, so
the clip norm and the noise cover the shared leaves only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import site_flat, site_unflat
from ..robustness.attacks import default_draw


def dp_enabled(dp_clip: float, dp_noise_multiplier: float) -> bool:
    """Whether the DP transform exists; JAX's ``ValueError``s for a
    negative knob and for noise without a clip."""
    if float(dp_noise_multiplier) < 0.0:
        raise ValueError(f"dp_noise_multiplier must be >= 0, got {dp_noise_multiplier}")
    if float(dp_clip) < 0.0:
        raise ValueError(f"dp_clip must be >= 0, got {dp_clip}")
    if float(dp_noise_multiplier) > 0.0 and float(dp_clip) <= 0.0:
        raise ValueError(
            "dp_noise_multiplier > 0 needs dp_clip > 0: noise without a clipped sensitivity "
            "carries no DP guarantee (set dp_clip)")
    return float(dp_clip) > 0.0


def make_dp_fn(dp_clip: float, dp_noise_multiplier: float, dp_seed: int = 0,
               skip_paths: frozenset = frozenset(), table=None, draw=None):
    """The DP transform, or None when it is off.

    Returns ``dp(grads, rnd) -> grads`` over a site-batched gradient dict
    ``{name: [S, ...]}`` (row ``s`` is site ``s``), ``rnd`` the global
    round. ``skip_paths`` names the personalized-head leaves (their
    ``state_dict`` names, ``personalize.head_leaf_paths``), left out of the
    norm and the noise. ``table`` is the model's ``weights.LeafTable``
    (each draw's leaf index and the leaves stored transposed); without one
    the leaves are indexed in the dict's order and none is transposed.
    ``draw(kind, key, shape, device)`` gives each draw, ``kind`` "dp" and
    ``key = (dp_seed, site, rnd, leaf index)`` (default: this module's
    ``default_draw``, ``robustness.attacks.default_draw``, looked up when
    the transform is built).

    As in JAX: each site's scale ``min(1, C / max(‖g‖, 1e-30))`` in f32,
    the f32 leaf times the scale, plus ``σ·C·ε``, cast back to the leaf's
    dtype."""
    if not dp_enabled(dp_clip, dp_noise_multiplier):
        return None
    clip, sigma, seed = float(dp_clip), float(dp_noise_multiplier), int(dp_seed)
    draw = draw or default_draw
    noise_mult = float(np.float32(sigma * clip))  # JAX's weak-typed f32 product

    def layout(grads):
        """The shared leaves in the dict's order: (name, JAX leaf index,
        stored transposed)."""
        if table is None:
            return [(k, i, False) for i, k in enumerate(grads) if k not in skip_paths]
        index, transposed = table.leaf_index, table.transposed
        return [(k, index[k], k in transposed) for k in grads if k not in skip_paths]

    def dp(grads: dict, rnd: int) -> dict:
        leaves = layout(grads)
        shared = {k: grads[k] for k, _, _ in leaves}
        flat = site_flat(shared)  # [S, N] f32
        S, dev = flat.shape[0], flat.device
        norm = (flat * flat).sum(1).sqrt()
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-30), max=1.0)
        out = flat * scale[:, None]
        if sigma > 0.0:
            noise = []
            for s in range(S):
                for k, i, tr in leaves:
                    shape = grads[k].shape[1:]
                    eps = draw("dp", (seed, s, int(rnd), i), shape[::-1] if tr else shape, dev)
                    noise.append((eps.mT if tr else eps).reshape(-1))
            out = out + noise_mult * torch.cat(noise).reshape(S, -1)
        return {**grads, **site_unflat(out, shared)}

    return dp
