"""SMRI3DNet, the 3D-CNN classifier of structural MRI (T1w) volumes: the
counterpart of the JAX package's ``models/cnn3d.py``.

Each stage is a bias-free 3x3x3 convolution of stride 2 with flax's SAME
padding, a BatchNorm without running statistics over the batch and every
voxel (BatchNorm3d; padding rows of weight 0 are left out of its moments),
and a ReLU; then a global average pool, dropout and a biased ``Linear``
head. The default channels are (16, 32, 64, 128) over 64³ volumes.

Layouts: a sample is ``[D, H, W]`` or ``[D, H, W, C]`` (channels last, as
the data pipeline and JAX give it); each convolution's kernel is kept in
JAX's ``[3, 3, 3, C_in, C_out]`` layout as the port's parameter (the
low-rank engines factorize it as its ``[27·C_in, C_out]`` matrix, JAX's)
and permuted at the call. The convolutions are cuDNN's (``F.conv3d``): JAX
runs them outside any Pallas kernel.

SAME padding at kernel 3 and stride 2 is not ``padding=1``: XLA pads each
axis so that ``ceil(n / 2)`` outputs come out, the odd pixel after (0
before and 1 after on an even side, 1 and 1 on an odd one);
:func:`same_pads` derives it.

Every site of a federated round runs in one grouped convolution a stage
(:func:`site_conv3d`): the sites' channels side by side, ``groups`` the
site count, so each site's kernel gradient comes back on its own.
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn
from torch.nn import functional as F

from ..weights import LeafTable
from .layers import (
    BatchNorm,
    compute_dtype_of,
    dense,
    param_at,
    site_batchnorm,
    site_dropout,
    site_linear,
)

#: the convolutions' kernel size and stride
KERNEL, STRIDE = 3, 2


def space_to_depth_222(x):
    """Fold each 2x2x2 spatial block of ``[B, D, H, W, 1]`` into 8 channels:
    voxel ``(2i+di, 2j+dj, 2k+dk)`` lands in channel ``di·4 + dj·2 + dk`` at
    ``(i, j, k)``."""
    B, D, H, W, _ = x.shape
    x = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, D // 2, H // 2, W // 2, 8)


def same_pads(size: int, kernel: int = KERNEL, stride: int = STRIDE) -> tuple[int, int]:
    """XLA's SAME padding of one axis: ``(before, after)`` so that
    ``ceil(size / stride)`` windows come out, the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def site_conv3d(x, w, dtype=None):
    """The stride-2 SAME convolution of every site at once: ``x [B, S·C_in,
    D, H, W]`` (site s's channels at ``s·C_in``), ``w [S, 3, 3, 3, C_in,
    C_out]`` in JAX's layout → ``[B, S·C_out, D', H', W']``, computing in
    ``dtype`` (None: f32). One grouped convolution, ``groups=S``."""
    S, kd, kh, kw, cin, cout = w.shape
    pads = []
    for size in reversed(x.shape[2:]):  # F.pad takes the last axis first
        pads += same_pads(size)
    wt = w.permute(0, 5, 4, 1, 2, 3).reshape(S * cout, cin, kd, kh, kw)
    if dtype is not None:
        x, wt = x.to(dtype), wt.to(dtype)
    return F.conv3d(F.pad(x, pads), wt, stride=STRIDE, groups=S)


class Conv3dSame(nn.Module):
    """The ``weight`` of a bias-free stride-2 SAME convolution
    (:func:`site_conv3d`): JAX's kernel ``[3, 3, 3, C_in, C_out]``, drawn
    as flax's ``lecun_normal`` (a normal truncated at two deviations, of
    variance ``1 / fan_in``) from ``generator``."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(KERNEL, KERNEL, KERNEL, cin, cout))
        fan_in = KERNEL ** 3 * cin
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class SMRI3DNet(nn.Module):
    """``forward(x [B, D, H, W(, C)], train, mask, generator)`` returns
    logits ``[B, num_cls]``; ``mask [B]`` weights rows in every BatchNorm's
    statistics; ``generator`` draws a training forward's dropout mask.

    Parameters: ``conv_i.weight`` (JAX's kernel, its layout),
    ``bn_i.weight`` / ``bn_i.bias`` (JAX's ``scale`` / ``bias``),
    ``head.weight`` (``[num_cls, C]``, the transpose of JAX's kernel) and
    ``head.bias``; no buffers. ``space_to_depth`` folds a single-channel
    input's 2x2x2 blocks into 8 channels before ``conv_0``, and takes an
    8-channel input as already folded (the data pipeline folds once at
    load), so conv_0 takes 8 channels under ``space_to_depth``, else 1.
    ``compute_dtype="bfloat16"`` runs the
    convolutions in bf16; the BatchNorm moments and the head stay f32."""

    @staticmethod
    def leaf_table(n_convs: int = 4) -> LeafTable:
        """The leaves: ``n_convs`` bias-free convolutions and their
        BatchNorms (no running statistics), and the biased head."""
        names = []
        for i in range(n_convs):
            names += [(f"conv_{i}.weight", f"conv_{i}/kernel", False),
                      (f"bn_{i}.weight", f"bn_{i}/scale", False),
                      (f"bn_{i}.bias", f"bn_{i}/bias", False)]
        names += [("head.weight", "head/kernel", True), ("head.bias", "head/bias", False)]
        return LeafTable("SMRI3DNet", tuple(names))

    @staticmethod
    def leaf_table_of(paths) -> LeafTable | None:
        """The table of a tree whose leaf paths (tuples of keys, JAX's or
        the port's) are SMRI3DNet's, else None."""
        tops = {p[0] for p in paths}
        if not {"conv_0", "head"} <= tops:
            return None
        return SMRI3DNet.leaf_table(sum(re.fullmatch(r"conv_\d+", t) is not None for t in tops))

    def __init__(self, channels: tuple = (16, 32, 64, 128), num_cls: int = 2,
                 dropout_rate: float = 0.25, compute_dtype=None, space_to_depth: bool = False,
                 generator=None):
        super().__init__()
        self.channels = tuple(channels)
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.space_to_depth = space_to_depth
        cin = 8 if space_to_depth else 1
        for i, ch in enumerate(self.channels):
            setattr(self, f"conv_{i}", Conv3dSame(cin, ch, generator))
            setattr(self, f"bn_{i}", BatchNorm(ch, track_running_stats=False))
            cin = ch
        self.head = dense(cin, num_cls, generator)
        self._names = [n for n, _, _ in self.leaf_table(len(self.channels)).params]

    def _fold(self, x):
        """Samples ``[N, D, H, W(, C)]`` as ``[N, D, H, W, C]``, folded by
        :func:`space_to_depth_222` where the model asks for it (JAX's
        checks: an 8-channel input is already folded; more than one channel
        or an odd side raises)."""
        if x.ndim == 4:
            x = x[..., None]
        if self.space_to_depth and x.shape[-1] != 8:
            if x.shape[-1] != 1 or any(d % 2 for d in x.shape[1:4]):
                raise ValueError(
                    "space_to_depth needs single-channel input with even spatial dims (or "
                    f"pipeline-prefolded 8-channel input); got shape {tuple(x.shape[1:])}. "
                    "Pad/crop the volumes or set space_to_depth=False.")
            x = space_to_depth_222(x)
        return x

    def _run(self, params, x, mask, train: bool, generator):
        S, B = x.shape[:2]
        x = self._fold(x.reshape(S * B, *x.shape[2:]))
        cdt = compute_dtype_of(self.compute_dtype)
        # [B, S·C, D, H, W]: each site's channels side by side
        h = x.reshape(S, B, *x.shape[1:]).permute(1, 0, 5, 2, 3, 4)
        h = h.reshape(B, -1, *h.shape[3:])
        for i, ch in enumerate(self.channels):
            h = site_conv3d(h, params[f"conv_{i}.weight"], cdt).float()
            h = h.reshape(B, S, ch, *h.shape[2:]).transpose(0, 1)  # [S, B, ch, ...] view
            h = torch.relu(site_batchnorm(h, mask, params[f"bn_{i}.weight"],
                                          params[f"bn_{i}.bias"], getattr(self, f"bn_{i}").eps))
            h = h.transpose(0, 1).reshape(B, S * ch, *h.shape[3:])
        pooled = h.reshape(B, S, self.channels[-1], -1).mean(-1).transpose(0, 1)  # [S, B, C]
        if train:
            pooled = site_dropout(pooled, self.dropout_rate, generator)
        return site_linear(params["head.weight"], params["head.bias"], pooled)

    def forward(self, x, train: bool = True, mask=None, generator=None):
        params = {n: param_at(self, n)[None] for n in self._names}
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        return self._run(params, x[None], mask[None], train, generator)[0]

    def site_forward(self, params, x, mask, stats, generator=None):
        """The training forward of every site at once: ``params`` by
        ``state_dict`` name as site-batched views ``[S, ...]``, ``x [S, B,
        D, H, W(, C)]``, ``mask [S, B]`` (weight-0 rows are padding),
        ``stats`` empty, ``generator`` for the dropout masks. Returns
        ``(logits [S, B, num_cls], {})``; each site's BatchNorms take that
        site's masked moments, as JAX's per-site ``vmap`` does."""
        return self._run(params, x, mask, True, generator), {}
