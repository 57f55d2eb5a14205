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

:class:`ICALstmStream` is the streaming twin of the unidirectional model,
the serving path's O(1) step over a chunk of new windows (JAX's
``ICALstmStream`` and ``_StreamLSTM``); it takes the same parameters.
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


class _StreamLSTM(nn.Module):
    """Streaming (single-direction) LSTM step over a CHUNK of new windows,
    with the mean-pool accumulator folded into the recurrence carry: the
    O(1) state of the serving path (serving/session.py).

    Holds the ``fwd`` cell of the dense path (:class:`LSTMCell`), so a
    trained unidirectional :class:`ICALstm` state drives it unchanged. The
    carry is ``(h, c, pooled, count)``: hidden and cell state plus the
    running hidden-state SUM and valid-step count, whatever the number of
    windows the session has consumed.

    The step is plain PyTorch, as JAX's is a ``lax.scan`` outside any
    Pallas kernel: the i2h product is one ``torch.matmul`` over the chunk
    (JAX's ``xi = enc @ w_ih + b``), then a loop over the chunk's steps.
    The pooled sum accumulates INSIDE the loop, a strict left fold in time
    order, so windows ``[0..t1)`` then ``[t1..T)`` perform the same
    additions as ``[0..T)`` in one chunk: streaming in chunks is bitwise
    the one-shot replay. ``step_valid`` gates padded chunk slots: an invalid
    step leaves all four parts of the carry bitwise unchanged."""

    def __init__(self, in_dim: int, hidden_size: int, compute_dtype=None, generator=None):
        super().__init__()
        self.fwd = LSTMCell(in_dim, hidden_size, compute_dtype, use_kernel=False,
                            generator=generator)

    def forward(self, enc, h, c, pooled, count, step_valid):
        w_ih, b, w_hh = self.fwd.leaves()
        H = self.fwd.hidden_size
        cdt = compute_dtype_of(self.fwd.compute_dtype)
        if cdt is not None:
            # JAX's mixed-precision step: bf16 operands, f32 accumulation,
            # a bf16 xi stream
            xi = (torch.matmul(enc.to(cdt).float(), w_ih.to(cdt).float()) + b).to(cdt)
            w_hh = w_hh.to(cdt).float()
        else:
            xi = torch.matmul(enc, w_ih) + b  # [B, t, 4H]: one hoisted product
        for t in range(xi.shape[1]):
            hh = h if cdt is None else h.to(cdt).float()
            preact = xi[:, t] + torch.matmul(hh, w_hh)
            i = torch.sigmoid(preact[:, :H])
            f = torch.sigmoid(preact[:, H:2 * H])
            o = torch.sigmoid(preact[:, 2 * H:3 * H])
            g = torch.tanh(preact[:, 3 * H:])
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            sv = step_valid[:, t]
            live = (sv > 0)[:, None]
            # an invalid step is an exact identity: h, c and pooled hold and
            # count adds sv == 0
            h, c, pooled = (torch.where(live, h_new, h), torch.where(live, c_new, c),
                            torch.where(live, pooled + h_new, pooled))
            count = count + sv
        return h, c, pooled, count


class ICALstmStream(nn.Module):
    """Streaming twin of the unidirectional :class:`ICALstm`: the serving
    path's O(1) step over a chunk (serving/engine.py).

    Its ``state_dict`` names are ``ICALstm.leaf_table(bidirectional=False)``'s
    (``encoder``, ``lstm.fwd``, ``cls_fc1``, ``cls_bn``, ``cls_fc2``,
    ``cls_fc3``), so one checkpoint, or one ``params_from_jax``, serves
    both the batched full-sequence path and this one. ``forward(x [B, t,
    C, W], h, c, pooled [B, H], count [B], step_valid [B, t])`` encodes only
    the chunk's new windows, advances the carry, and runs the head on the
    running mean; returns ``(logits, (h, c, pooled, count))``. Eval
    semantics only: no dropout, the head BatchNorm on its running
    statistics, so co-batched sessions never perturb each other.
    Unidirectional only: the reverse direction of a biLSTM reads the
    future, so no O(1) carry can reproduce it."""

    def __init__(self, input_size: int = 256, hidden_size: int = 256, num_cls: int = 2,
                 num_comps: int = 53, window_size: int = 20, compute_dtype=None,
                 generator=None):
        super().__init__()
        g = generator
        self.compute_dtype = compute_dtype
        self.encoder = dense(num_comps * window_size, input_size, g)
        self.lstm = _StreamLSTM(input_size, hidden_size, compute_dtype, g)
        self.cls_fc1 = dense(hidden_size, 256, g)
        self.cls_bn = BatchNorm(256, track_running_stats=True)
        self.cls_fc2 = dense(256, 64, g)
        self.cls_fc3 = dense(64, num_cls, g)

    def forward(self, x, h, c, pooled, count, step_valid):
        B, t = x.shape[0], x.shape[1]
        enc = torch.relu(linear(self.encoder, x.reshape(B, t, -1),
                                compute_dtype_of(self.compute_dtype)))
        h, c, pooled, count = self.lstm(enc, h, c, pooled, count, step_valid)
        o = (pooled / torch.clamp(count, min=1.0)[:, None]).float()
        o = self.cls_bn(self.cls_fc1(o), train=False)
        o = torch.relu(self.cls_fc2(torch.relu(o)))
        return self.cls_fc3(o), (h, c, pooled, count)


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

    def site_forward(self, params, x, mask, stats, generator=None, train: bool = True):
        """The forward of every site at once.

        ``params``: every parameter by its ``state_dict`` name, as a
        site-batched view ``[S, ...]`` (stride 0, or a row a site for a
        personalized head's leaves); ``x [S, B, windows, comps, wlen]``,
        ``mask [S, B]`` (weight-0 rows are padding); ``stats``: the head
        BatchNorm's running statistics by buffer name, per site ``[S, 256]``
        or shared ``[256]``; ``generator`` draws the dropout masks.

        ``train`` (a federated round's step): dropout on, the BatchNorm
        normalizes by each site's masked batch moments and updates the
        running statistics. ``train=False`` (the eval of personalized
        heads): no dropout, the BatchNorm normalizes by ``stats``, and the
        LSTM still runs every site's rows in one call, as the folded eval
        does.

        Returns ``(logits [S, B, num_cls], stats)``: the new running
        statistics per site by buffer name in train, ``stats`` unchanged in
        eval. Nothing of the module is written."""
        S, B, W = x.shape[:3]
        cdt = compute_dtype_of(self.compute_dtype)

        def dense_(name, v, dtype=None):
            return site_linear(params[name + ".weight"], params[name + ".bias"], v, dtype)

        enc = torch.relu(dense_("encoder", x.reshape(S, B * W, -1), cdt))
        o, _ = self.lstm(enc.reshape(S * B, W, -1), params=_scope(params, "lstm"))
        o = o.float().reshape(S, B, -1)
        bn = self.cls_bn
        if train:
            o, (mean, var) = site_batchnorm_train(
                dense_("cls_fc1", site_dropout(o, self.dropout_rate, generator)), mask,
                params["cls_bn.weight"], params["cls_bn.bias"],
                stats["cls_bn.running_mean"], stats["cls_bn.running_var"], bn.momentum, bn.eps)
            stats = {"cls_bn.running_mean": mean, "cls_bn.running_var": var}
        else:
            o = ((dense_("cls_fc1", o) - stats["cls_bn.running_mean"])
                 * torch.rsqrt(stats["cls_bn.running_var"] + bn.eps))
            o = o * params["cls_bn.weight"][:, None] + params["cls_bn.bias"][:, None]
        o = torch.relu(dense_("cls_fc2", torch.relu(o)))
        return dense_("cls_fc3", o), stats
