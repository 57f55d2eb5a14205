"""ICALstm, the ICA-timecourse bidirectional LSTM classifier: the
counterpart of the JAX package's ``models/icalstm.py`` (batched lane).

- a per-window encoder ``Linear(num_comps*window -> input_size) + ReLU``;
- a BiLSTM whose ``hidden_size`` is split across the two directions; the
  reverse direction is the cell over the time-flipped input; each direction
  is mean-pooled over time and the two are concatenated;
- the head ``Dropout -> Linear(H->256) -> BatchNorm(256) -> ReLU ->
  Linear(256->64) -> ReLU -> Linear(64->num_cls)``.

Gates are standard (single sigmoid) in the order i, f, o, g. The
recurrence runs the CUDA kernels on the card (ops/lstm_cuda.py: K1
forward, K2 backward, one launch per direction) and their plain versions on
the CPU. ``fused_bidir=True`` opts in to the fused bidirectional pooled op
instead (ops/bilstm_cuda.py: both directions and the time-mean pool in one
launch, K3/K4 for one model, K5/K6 over sites), as the JAX model's A/B arm;
the parameters and their names are the same on both paths.

:meth:`ICALstm.site_forward` is the training forward of a federated round:
every site at once over an explicit leading site axis, with per-site
parameters, per-site head BatchNorm statistics and dropout drawn from a
``torch.Generator``. The encoder and both LSTM directions fold the sites
into rows, so each kernel launches once per direction for all sites.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bilstm_cuda import bilstm_pool_forward_fused, bilstm_pool_forward_plain
from ..ops.lstm_cuda import lstm_forward_fused, lstm_forward_plain, site_sum
from ..weights import LeafTable
from .layers import (
    BatchNorm,
    TorchLinearInit,
    compute_dtype_of,
    dense,
    linear,
    site_batchnorm_train,
    site_dropout,
    site_linear,
)


def _scope(params, prefix: str) -> dict:
    """The entries of a flat ``name -> tensor`` dict under ``prefix.``,
    with the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class LSTMCell(nn.Module):
    """One direction over a full sequence: ``x [B, T, D]`` → ``(hs [B, T,
    H], (hT, cT))``.

    Parameters keep the JAX layout and leaves the kernels read: ``w_ih [D,
    4H]``, ``b_ih [4H]``, ``w_hh [H, 4H]``, ``b_hh [4H]``. The two biases
    are summed only at the call, so an optimizer steps each of them, as
    it steps the JAX cell's two leaves. ``use_kernel=False`` runs the plain
    recurrence on every device; it exists so a check on the card has a
    reference to hold the kernels against."""

    def __init__(self, in_dim: int, hidden_size: int, compute_dtype=None,
                 use_kernel: bool = True, generator=None):
        super().__init__()
        D, H = in_dim, hidden_size
        self.hidden_size = H
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.w_ih = nn.Parameter(TorchLinearInit.uniform_(torch.empty(D, 4 * H), D, generator))
        self.b_ih = nn.Parameter(TorchLinearInit.uniform_(torch.empty(4 * H), D, generator))
        self.w_hh = nn.Parameter(TorchLinearInit.uniform_(torch.empty(H, 4 * H), H, generator))
        self.b_hh = nn.Parameter(TorchLinearInit.uniform_(torch.empty(4 * H), H, generator))

    def leaves(self, params=None):
        """``(w_ih, b_ih + b_hh, w_hh)`` as the kernels take them: the
        module's own, or from ``params``, the cell's four leaves as
        site-batched stride-0 views ``[S, ...]`` (the bias sum stays of
        stride 0)."""
        if params is None:
            return self.w_ih, self.b_ih + self.b_hh, self.w_hh
        return params["w_ih"], site_sum(params["b_ih"], params["b_hh"]), params["w_hh"]

    def forward(self, x, h0=None, params=None):
        """``params``: the cell's four leaves as site-batched stride-0 views
        ``[S, ...]`` (rows of ``x`` site-major); None = the module's own."""
        B, H = x.shape[0], self.hidden_size
        if h0 is None:
            z = torch.zeros((B, H), dtype=torch.float32, device=x.device)
            h0 = (z, z)
        w_ih, b, w_hh = self.leaves(params)
        fn = lstm_forward_fused if self.use_kernel else lstm_forward_plain
        return fn(x, w_ih, b, w_hh, h0[0], h0[1],
                  compute_dtype=compute_dtype_of(self.compute_dtype))


class BiLSTM(nn.Module):
    """Bidirectional wrapper; ``hidden_size`` is the total width, split
    across directions. ``time_pool="mean"`` returns each direction's time
    mean, concatenated, instead of the hidden sequence.

    ``fused_bidir=True`` (bidirectional, ``time_pool="mean"``) runs the
    fused pooled op of both directions (JAX's ``bilstm_pool_forward_fused``
    arm) over the same two cells' parameters, both biases of each summed
    per call; ``use_kernel=False`` runs that op's plain versions. The
    reverse direction reads x through the kernels' time map: x is not
    flipped."""

    def __init__(self, in_dim: int, hidden_size: int, bidirectional: bool = True,
                 compute_dtype=None, use_kernel: bool = True,
                 time_pool: str | None = None, generator=None,
                 fused_bidir: bool | None = None):
        super().__init__()
        if time_pool not in (None, "mean"):
            raise ValueError(f"unknown time_pool {time_pool!r}")
        self.bidirectional = bidirectional
        self.time_pool = time_pool
        self.fused_bidir = fused_bidir
        per_dir = hidden_size // (2 if bidirectional else 1)
        self.fwd = LSTMCell(in_dim, per_dir, compute_dtype, use_kernel, generator)
        self.rev = (LSTMCell(in_dim, per_dir, compute_dtype, use_kernel, generator)
                    if bidirectional else None)

    def _pool(self, s):
        return s.mean(dim=1) if self.time_pool == "mean" else s

    def forward(self, x, h0=None, params=None):
        """``params``: site-batched leaves by name (``fwd.w_ih``, …), as
        :meth:`LSTMCell.forward` takes them; None = the module's own."""
        if self.bidirectional and self.time_pool == "mean" and self.fused_bidir is True:
            return self._fused(x, h0, params)
        fwd, (h, c) = self.fwd(x, h0, None if params is None else _scope(params, "fwd"))
        if not self.bidirectional:
            return self._pool(fwd), (h, c)
        rev, (hr, cr) = self.rev(torch.flip(x, dims=(1,)), h0,
                                 None if params is None else _scope(params, "rev"))
        return (
            torch.cat([self._pool(fwd), self._pool(rev)], dim=-1),
            (torch.cat([h, hr], 1), torch.cat([c, cr], 1)),
        )

    def _fused(self, x, h0, params):
        pf, pr = (cell.leaves(None if params is None else _scope(params, name))
                  for name, cell in (("fwd", self.fwd), ("rev", self.rev)))
        h02 = None if h0 is None else torch.stack([h0[0], h0[0]])
        c02 = None if h0 is None else torch.stack([h0[1], h0[1]])
        fn = bilstm_pool_forward_fused if self.fwd.use_kernel else bilstm_pool_forward_plain
        pooled, (hT2, cT2) = fn(x, pf, pr, h02, c02,
                                compute_dtype=compute_dtype_of(self.fwd.compute_dtype))
        return pooled, (torch.cat([hT2[0], hT2[1]], 1), torch.cat([cT2[0], cT2[1]], 1))


class ICALstm(nn.Module):
    """See the module docstring. ``forward(x [B, S, C, W], train, mask)``
    returns logits ``[B, num_cls]``; ``mask [B]`` weights rows in the
    head's batch statistics (train only: eval uses the running stats).
    ``fused_bidir=True`` selects the fused bidirectional op (see
    :class:`BiLSTM`); default off, as in JAX."""

    @staticmethod
    def leaf_table(bidirectional: bool = True) -> LeafTable:
        """The leaves: the dense layers, one LSTM cell a direction and the
        head BatchNorm with its running statistics."""
        names = []
        for n in ("encoder", "cls_fc1", "cls_fc2", "cls_fc3"):
            names += [(f"{n}.weight", f"{n}/kernel", True), (f"{n}.bias", f"{n}/bias", False)]
        for d in ("fwd", "rev") if bidirectional else ("fwd",):
            names += [(f"lstm.{d}.{leaf}", f"lstm/{d}/{leaf}", False)
                      for leaf in ("w_ih", "b_ih", "w_hh", "b_hh")]
        names += [("cls_bn.weight", "cls_bn/scale", False), ("cls_bn.bias", "cls_bn/bias", False)]
        return LeafTable("ICALstm", tuple(names), (("cls_bn.running_mean", "cls_bn/mean"),
                                                   ("cls_bn.running_var", "cls_bn/var")))

    @staticmethod
    def leaf_table_of(paths) -> LeafTable | None:
        """The table of a tree whose leaf paths (tuples of keys, JAX's or
        the port's) are ICALstm's, else None."""
        if not any(p[0] == "lstm" for p in paths):
            return None
        return ICALstm.leaf_table(any(p[:2] == ("lstm", "rev") for p in paths))

    def __init__(self, input_size: int = 256, hidden_size: int = 256,
                 bidirectional: bool = True, num_cls: int = 2, num_comps: int = 53,
                 window_size: int = 20, dropout_rate: float = 0.25,
                 compute_dtype=None, use_kernel: bool = True,
                 double_sigmoid_gates: bool = False, sequence_axis=None,
                 generator=None, fused_bidir: bool | None = None):
        super().__init__()
        if double_sigmoid_gates:
            raise NotImplementedError("double_sigmoid_gates is not ported")
        if sequence_axis is not None:
            raise NotImplementedError("the sequence-parallel (ring) path is not ported")
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        g = generator
        self.encoder = dense(num_comps * window_size, input_size, g)
        self.lstm = BiLSTM(input_size, hidden_size, bidirectional, compute_dtype,
                           use_kernel, time_pool="mean", generator=g, fused_bidir=fused_bidir)
        per_dir = hidden_size // (2 if bidirectional else 1)
        width = per_dir * (2 if bidirectional else 1)
        self.cls_fc1 = dense(width, 256, g)
        self.cls_bn = BatchNorm(256, track_running_stats=True)
        self.cls_fc2 = dense(256, 64, g)
        self.cls_fc3 = dense(64, num_cls, g)

    def forward(self, x, train: bool = True, mask=None):
        B, S = x.shape[0], x.shape[1]
        flat = x.reshape(B, S, -1)
        # under compute_dtype the encoder output stays bf16: the LSTM's i2h
        # products consume it directly
        enc = torch.relu(linear(self.encoder, flat, compute_dtype_of(self.compute_dtype)))
        o, _ = self.lstm(enc)
        o = o.float()  # the head and its BatchNorm stay f32
        o = nn.functional.dropout(o, self.dropout_rate, training=train)
        o = self.cls_bn(self.cls_fc1(o), train=train, mask=mask)
        o = torch.relu(self.cls_fc2(torch.relu(o)))
        return self.cls_fc3(o)

    def site_forward(self, params, x, mask, stats, generator=None):
        """The training forward of every site at once.

        ``params``: every parameter by its ``state_dict`` name, as a
        site-batched view ``[S, ...]`` of stride 0; ``x [S, B, windows,
        comps, wlen]``, ``mask [S, B]`` (weight-0 rows are padding);
        ``stats``: the head BatchNorm's running statistics by buffer name,
        per site ``[S, 256]``; ``generator`` draws the dropout masks.

        Returns ``(logits [S, B, num_cls], new stats)``, the new running
        statistics per site by buffer name. Nothing of the module is
        written."""
        S, B, W = x.shape[:3]
        cdt = compute_dtype_of(self.compute_dtype)

        def dense_(name, v, dtype=None):
            return site_linear(params[name + ".weight"], params[name + ".bias"], v, dtype)

        enc = torch.relu(dense_("encoder", x.reshape(S, B * W, -1), cdt))
        o, _ = self.lstm(enc.reshape(S * B, W, -1), params=_scope(params, "lstm"))
        o = site_dropout(o.float().reshape(S, B, -1), self.dropout_rate, generator)
        bn = self.cls_bn
        o, (mean, var) = site_batchnorm_train(
            dense_("cls_fc1", o), mask, params["cls_bn.weight"], params["cls_bn.bias"],
            stats["cls_bn.running_mean"], stats["cls_bn.running_var"], bn.momentum, bn.eps)
        o = torch.relu(dense_("cls_fc2", torch.relu(o)))
        return dense_("cls_fc3", o), {"cls_bn.running_mean": mean, "cls_bn.running_var": var}
