"""The privacy plane, the port of the JAX package's ``privacy/``:

- :mod:`.dpsgd`: per-site DP-SGD on the round gradient, clipping and
  calibrated Gaussian noise drawn per (seed, site, round, leaf);
- :mod:`.accounting`: the host-side RDP accountant, (ε, δ) per epoch and a
  clean checkpointed stop at ``dp_epsilon_budget``;
- :mod:`.secure_agg`: secure-aggregation masked wires for dSGD, pairwise
  antisymmetric int32 pads on a shared fixed-point grid that cancel
  exactly in the site sum;
- :mod:`.personalize`: personalized per-site heads, a partition of the
  parameters kept out of the aggregation, each site's head row in
  ``TrainState.personal``.
"""

from .accounting import RdpAccountant, effective_noise_multiplier, sampling_fraction
from .dpsgd import dp_enabled, make_dp_fn
from .personalize import head_leaf_paths, merge_head, personal_row_template, strip_tree
from .secure_agg import SECURE_AGGS, secure_agg_enabled

__all__ = ["RdpAccountant", "SECURE_AGGS", "dp_enabled", "effective_noise_multiplier",
           "head_leaf_paths", "make_dp_fn", "merge_head", "personal_row_template",
           "sampling_fraction", "secure_agg_enabled", "strip_tree"]
