"""Per-site health state, carried through the epoch's rounds: the port of
the JAX package's ``robustness/health.py``.

Three int32 counters per site, each a ``[num_sites]`` tensor in
``TrainState.health``:

- ``streak``: consecutive rounds with a non-finite site gradient; back to
  0 the round the gradient is finite again;
- ``skips``: rounds this site contributed nothing (scheduled drop,
  non-finite gradient, or quarantine);
- ``quarantined``: sticky 0/1 flag, set once ``streak`` reaches
  ``quarantine_rounds``. A quarantined site has weight 0 for the rest of
  the fit.

The reputation layer (:data:`REPUTATION_KEYS`), present only when a
robust aggregation mode is on (``robust_agg != "none"``):

- ``suspect_streak`` (int32): consecutive rounds this site's anomaly
  z-score (the larger of its distance-to-aggregate z and its gradient-norm
  z across the live sites, trainer/steps.py) exceeded ``reputation_z``;
  back to 0 the round it falls under. ``reputation_rounds`` such rounds
  latch ``quarantined``, as a NaN streak does;
- ``anomaly`` (float32): an exponential moving average of the positive
  part of that z-score (decay 0.9 a live round, held while the site sits
  out), the per-site score of ``logs.json``.
"""

from __future__ import annotations

import numpy as np
import torch

#: health keys added by the reputation layer (robust_agg != "none")
REPUTATION_KEYS = ("suspect_streak", "anomaly")
#: every health field's dtype
HEALTH_DTYPES = {"streak": torch.int32, "skips": torch.int32, "quarantined": torch.int32,
                 "suspect_streak": torch.int32, "anomaly": torch.float32}


def reputation_fields(num_sites: int, device=None) -> dict:
    """Fresh zero reputation fields (:data:`REPUTATION_KEYS`)."""
    return {k: torch.zeros((num_sites,), dtype=HEALTH_DTYPES[k], device=device)
            for k in REPUTATION_KEYS}


def default_health(num_sites: int, reputation: bool = False, device=None) -> dict:
    """Fresh all-healthy counters, one distinct tensor each;
    ``reputation=True`` adds the reputation fields."""
    out = {k: torch.zeros((num_sites,), dtype=torch.int32, device=device)
           for k in ("streak", "skips", "quarantined")}
    if reputation:
        out.update(reputation_fields(num_sites, device))
    return out


def health_from_numpy(tree: dict, device=None) -> dict:
    """A health tree of numpy arrays (JAX's, or a checkpoint's) as tensors
    on ``device``, each field in its own dtype."""
    return {k: torch.from_numpy(np.array(v)).to(device=device,
                                                 dtype=HEALTH_DTYPES.get(k, torch.int32))
            for k, v in tree.items()}


def health_summary(health) -> dict | None:
    """Host-side summary for results and ``logs.json``: plain lists under
    the log-facing names, the reputation fields' where they are kept."""
    if health is None:
        return None
    h = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in health.items()}
    out = {"site_skipped_rounds": [int(v) for v in h["skips"]],
           "site_quarantined": [int(v) for v in h["quarantined"]],
           "site_nonfinite_streak": [int(v) for v in h["streak"]]}
    if all(k in h for k in REPUTATION_KEYS):
        out["site_anomaly_score"] = [float(v) for v in h["anomaly"]]
        out["site_suspect_streak"] = [int(v) for v in h["suspect_streak"]]
    return out
