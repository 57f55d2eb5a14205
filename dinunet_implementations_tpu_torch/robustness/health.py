"""Per-site health state, carried through the epoch's rounds: the subset
of the JAX package's ``robustness/health.py`` without the reputation
fields.

Three int32 counters per site, each a ``[num_sites]`` tensor in
``TrainState.health``:

- ``streak``: consecutive rounds with a non-finite site gradient; back to
  0 the round the gradient is finite again;
- ``skips``: rounds this site contributed nothing (scheduled drop,
  non-finite gradient, or quarantine);
- ``quarantined``: sticky 0/1 flag, set once ``streak`` reaches
  ``quarantine_rounds``. A quarantined site has weight 0 for the rest of
  the fit.
"""

from __future__ import annotations

import numpy as np
import torch


def default_health(num_sites: int, device=None) -> dict:
    """Fresh all-healthy counters, one distinct tensor each."""
    return {k: torch.zeros((num_sites,), dtype=torch.int32, device=device)
            for k in ("streak", "skips", "quarantined")}


def health_summary(health) -> dict | None:
    """Host-side summary for results and ``logs.json``: plain int lists
    under the log-facing names."""
    if health is None:
        return None
    h = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in health.items()}
    return {"site_skipped_rounds": [int(v) for v in h["skips"]],
            "site_quarantined": [int(v) for v in h["quarantined"]],
            "site_nonfinite_streak": [int(v) for v in h["streak"]]}
