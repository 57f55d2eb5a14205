"""RDP accounting for the port's DP-SGD mechanism: the port's own copy of
the JAX package's ``privacy/accounting.py`` (stdlib and numpy only).

The epoch (trainer/steps.py, privacy/dpsgd.py) adds, per site per round,
Gaussian noise ``σ·C·ε`` to the clipped (``‖g‖ ≤ C``) round gradient. This
module answers "what (ε, δ) has that spent so far": Rényi differential
privacy of the subsampled Gaussian mechanism (Mironov 2017;
Mironov/Talwar/Zhang 2019, the TF-Privacy moments accountant), composed
additively over rounds and converted to (ε, δ) by the standard RDP→DP
bound.

- ε is per site, record-level: each site runs the same mechanism on its
  own data, so one trajectory at the cohort's largest per-round sampling
  fraction ``q = B·local_iterations / n_site_min`` bounds every site's
  loss.
- The trainer draws epoch batches by shuffled partition, not Poisson
  sampling; the subsampled-Gaussian amplification is the standard
  approximation for that regime.
- RDP is computed at integer orders α ∈ {2..64} by the exact
  binomial-expansion bound (log-sum-exp stable), with the q == 1 closed
  form ``α/(2σ²)``.
- The ledger is a plain (orders, rdp, steps) triple that serializes into
  the checkpoint meta (trainer/loop.py), so a resumed fit continues ε
  exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

#: default Rényi orders: the integer range the TF-Privacy accountant sweeps;
#: small orders bound the high-noise regime, large orders the low-noise one
DEFAULT_ORDERS = tuple(range(2, 65))

#: The mechanism clips the site's round-MEAN gradient and noises it once
#: (privacy/dpsgd.py), not the per-example-clipped SUM the textbook DP-SGD
#: analysis assumes: under record-level adjacency the sensitivity of
#: clip(mean) is bounded by 2C (both neighbours' outputs merely lie in the
#: C-ball), not C. The ledger therefore composes at the conservative
#: effective multiplier σ/2: the reported ε is an upper bound on the spend.
#: trainer/loop.py divides by this factor.
MEAN_CLIP_SENSITIVITY_FACTOR = 2.0


def effective_noise_multiplier(noise_multiplier: float) -> float:
    """The σ the RDP ledger composes at for the clip-of-mean mechanism
    (see :data:`MEAN_CLIP_SENSITIVITY_FACTOR`)."""
    return float(noise_multiplier) / MEAN_CLIP_SENSITIVITY_FACTOR


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(vals) -> float:
    m = max(vals)
    if not math.isfinite(m):
        return m
    return m + math.log(sum(math.exp(v - m) for v in vals))


def rdp_sampled_gaussian(q: float, noise_multiplier: float, order: int) -> float:
    """One step's RDP at integer ``order`` for the sampled Gaussian mechanism
    with sampling fraction ``q`` and noise multiplier ``σ`` (noise std is
    ``σ·C`` against an L2 sensitivity of ``C``).

    ``q == 1``: the plain Gaussian mechanism, ``α/(2σ²)``. ``0 < q < 1``:
    Mironov et al. 2019's integer-order bound
    ``(1/(α−1))·log Σ_{k=0..α} C(α,k)(1−q)^{α−k} q^k exp(k(k−1)/(2σ²))``.
    ``σ == 0`` is infinite (no noise, no guarantee); ``q == 0`` is 0 (the
    mechanism never touches the data)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling fraction must be in [0, 1], got {q}")
    if order < 2 or int(order) != order:
        raise ValueError(f"integer order >= 2 required, got {order}")
    if noise_multiplier <= 0.0:
        return math.inf
    if q == 0.0:
        return 0.0
    s2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return order / (2.0 * s2)
    a = int(order)
    terms = [
        _log_binom(a, k)
        + (a - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + (k * (k - 1)) / (2.0 * s2)
        for k in range(a + 1)
    ]
    return _logsumexp(terms) / (a - 1)


def rdp_to_epsilon(orders, rdp, delta: float):
    """(ε, best order) from accumulated RDP via the standard conversion
    ``ε = min_α rdp_α + log(1/δ)/(α−1)``."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    best_eps, best_order = math.inf, None
    for a, r in zip(orders, rdp):
        if not math.isfinite(r):
            continue
        eps = r + math.log(1.0 / delta) / (a - 1)
        if eps < best_eps:
            best_eps, best_order = eps, a
    return best_eps, best_order


def sampling_fraction(batch_size: int, local_iterations: int,
                      site_sizes) -> float:
    """The conservative per-round sampling fraction the accountant composes
    at: each round every site steps ``batch_size·local_iterations`` of its
    own examples, so the smallest non-empty site samples the largest
    fraction — that corner bounds every site's privacy loss. Empty sites
    sample nothing and are ignored; an empty cohort is q = 0."""
    sizes = [int(n) for n in site_sizes if int(n) > 0]
    if not sizes:
        return 0.0
    per_round = max(int(batch_size), 1) * max(int(local_iterations), 1)
    return min(1.0, per_round / min(sizes))


@dataclasses.dataclass
class RdpAccountant:
    """Additive-composition RDP ledger for one fit.

    ``step(noise_multiplier, q, steps)`` composes ``steps`` rounds of the
    sampled Gaussian mechanism; ``epsilon(delta)`` converts to (ε, δ).
    JSON-round-trips through the checkpoint meta so a resumed fit continues
    the exact ledger."""

    orders: tuple = DEFAULT_ORDERS
    rdp: np.ndarray = None
    steps: int = 0

    def __post_init__(self):
        if self.rdp is None:
            self.rdp = np.zeros(len(self.orders), np.float64)
        else:
            self.rdp = np.asarray(self.rdp, np.float64)
        if self.rdp.shape != (len(self.orders),):
            raise ValueError(
                f"rdp ledger has {self.rdp.shape} entries for "
                f"{len(self.orders)} orders"
            )

    def step(self, noise_multiplier: float, q: float, steps: int = 1
             ) -> "RdpAccountant":
        """Compose ``steps`` rounds at (σ, q) into the ledger (in place)."""
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if steps:
            per = np.array([
                rdp_sampled_gaussian(q, noise_multiplier, a)
                for a in self.orders
            ])
            self.rdp = self.rdp + per * steps
            self.steps += int(steps)
        return self

    def epsilon(self, delta: float):
        """(ε, δ)-DP spent so far: ``(epsilon, best_order)``; ``(inf, None)``
        when no finite order bounds the mechanism (σ = 0) — and ``(0, None)``
        before any step."""
        if self.steps == 0:
            return 0.0, None
        return rdp_to_epsilon(self.orders, self.rdp, delta)

    # -- checkpoint-meta round trip --------------------------------------

    def to_json(self) -> dict:
        return {
            "orders": list(self.orders),
            # inf survives the strict-JSON metrics contract by riding the
            # checkpoint META (json.dumps default allows it) — but keep the
            # ledger finite-or-null anyway so the meta stays jq-friendly
            "rdp": [r if math.isfinite(r) else None for r in self.rdp],
            "steps": int(self.steps),
        }

    @classmethod
    def from_json(cls, blob) -> "RdpAccountant":
        if not isinstance(blob, dict):
            raise ValueError(f"accountant state must be an object, got {blob!r}")
        rdp = np.array([
            math.inf if r is None else float(r) for r in blob["rdp"]
        ])
        return cls(
            orders=tuple(int(a) for a in blob["orders"]),
            rdp=rdp, steps=int(blob.get("steps", 0)),
        )
