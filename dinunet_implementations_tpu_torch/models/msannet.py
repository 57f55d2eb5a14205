"""MSANNet, the FreeSurfer-volume MLP classifier: the counterpart of the JAX
package's ``models/msannet.py``.

Each hidden layer is ``Linear(bias=False) -> BatchNorm(no running
statistics) -> ReLU [-> Dropout if the layer's index is in dropout_in]``,
then a biased ``Linear`` head; the defaults are 66 -> (256, 128, 64, 32) ->
2 (the reference's ``compspec.json:227-235``). The BatchNorms normalise by
the mask-weighted batch moments in train and eval alike, so an eval of
several sites must take each site's rows on their own
(``trainer/steps.py:make_eval_fn``).

The products stay ``torch`` matrix products at f32 (TF32 off): the JAX
model runs them outside any Pallas kernel.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ..weights import LeafTable
from .layers import BatchNorm, dense, site_batchnorm, site_dropout, site_linear


class MSANNet(nn.Module):
    """``forward(x [B, in_size], train, mask, generator)`` returns logits
    ``[B, out_size]``; ``mask [B]`` weights rows in every BatchNorm's
    statistics (weight-0 rows are padding); ``generator`` draws the dropout
    masks of a training forward. Parameters: ``linear_i.weight`` (``[h,
    fan_in]``, the transpose of the JAX kernel), ``bn_i.weight`` /
    ``bn_i.bias`` (JAX's ``scale`` / ``bias``) and ``fc_out.weight`` /
    ``fc_out.bias``; no buffers. The constructor draws the weights from
    ``generator``."""

    @staticmethod
    def leaf_table(n_hidden: int = 4) -> LeafTable:
        """The leaves: ``n_hidden`` bias-free linears and their BatchNorms
        (no running statistics), and the biased head."""
        names = []
        for i in range(n_hidden):
            names += [(f"linear_{i}.weight", f"linear_{i}/kernel", True),
                      (f"bn_{i}.weight", f"bn_{i}/scale", False),
                      (f"bn_{i}.bias", f"bn_{i}/bias", False)]
        names += [("fc_out.weight", "fc_out/kernel", True), ("fc_out.bias", "fc_out/bias", False)]
        return LeafTable("MSANNet", tuple(names))

    @staticmethod
    def leaf_table_of(paths) -> LeafTable | None:
        """The table of a tree whose leaf paths (tuples of keys, JAX's or
        the port's) are MSANNet's, else None."""
        tops = {p[0] for p in paths}
        if "fc_out" not in tops:
            return None
        return MSANNet.leaf_table(sum(re.fullmatch(r"linear_\d+", t) is not None for t in tops))

    def __init__(self, in_size: int = 66, hidden_sizes: tuple = (256, 128, 64, 32),
                 out_size: int = 2, dropout_in: tuple = (), dropout_rate: float = 0.5,
                 generator=None):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.dropout_in = tuple(dropout_in)
        self.dropout_rate = dropout_rate
        fan_in = in_size
        for i, h in enumerate(self.hidden_sizes):
            setattr(self, f"linear_{i}", dense(fan_in, h, generator, bias=False))
            setattr(self, f"bn_{i}", BatchNorm(h, track_running_stats=False))
            fan_in = h
        self.fc_out = dense(fan_in, out_size, generator)

    def forward(self, x, train: bool = True, mask=None, generator=None):
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"linear_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, train=train, mask=mask))
            if train and i in self.dropout_in:
                x = site_dropout(x, self.dropout_rate, generator)
        return self.fc_out(x)

    def site_forward(self, params, x, mask, stats, generator=None):
        """The training forward of every site at once.

        ``params``: every parameter by its ``state_dict`` name, as a
        site-batched view ``[S, ...]``; ``x [S, B, in_size]``, ``mask [S,
        B]`` (weight-0 rows are padding); ``stats`` is empty (no running
        statistics); ``generator`` draws the dropout masks.

        Returns ``(logits [S, B, out_size], {})``. Each site's BatchNorms
        take that site's masked batch moments, as JAX's per-site ``vmap``
        does."""
        for i in range(len(self.hidden_sizes)):
            x = site_linear(params[f"linear_{i}.weight"], None, x)
            x = torch.relu(site_batchnorm(x, mask, params[f"bn_{i}.weight"],
                                          params[f"bn_{i}.bias"], getattr(self, f"bn_{i}").eps))
            if i in self.dropout_in:
                x = site_dropout(x, self.dropout_rate, generator)
        return site_linear(params["fc_out.weight"], params["fc_out.bias"], x), {}
