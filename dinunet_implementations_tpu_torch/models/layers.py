"""Shared layers: the counterparts of the JAX package's ``models/layers.py``.

The one nontrivial piece is :class:`BatchNorm`. Batches are dense
``[B, ...]`` blocks with weight-0 padding rows, so batch statistics are
mask-weighted: a padded row never shifts the mean or variance. With an
all-ones mask this is torch's biased batch variance.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def compute_dtype_of(compute_dtype):
    """Resolve a model's ``compute_dtype`` field ("bfloat16" / "" / None /
    a torch dtype) to ``torch.dtype | None``."""
    if not compute_dtype:
        return None
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, compute_dtype)


def masked_moments(x, mask, dim=0, eps_count: float = 1.0):
    """Weighted mean and biased variance over ``dim``; ``mask`` broadcasts
    against ``x``. Returns ``(mean, var, count)`` with kept dims."""
    if mask is None:
        mean = x.mean(dim=dim, keepdim=True)
        var = (x - mean).square().mean(dim=dim, keepdim=True)
        return mean, var, x.shape[dim]
    w = torch.broadcast_to(mask, x.shape)
    count = torch.clamp(w.sum(dim=dim, keepdim=True), min=eps_count)
    mean = (x * w).sum(dim=dim, keepdim=True) / count
    var = (w * (x - mean).square()).sum(dim=dim, keepdim=True) / count
    return mean, var, count


class BatchNorm(nn.Module):
    """Torch-faithful BatchNorm1d over ``[B, F]`` with masking.

    With ``track_running_stats`` eval normalises by the running statistics,
    and train by the weight-masked batch moments while it updates the
    running statistics (momentum 0.1, unbiased variance). Without it, both
    use the batch moments."""

    def __init__(self, features: int, track_running_stats: bool = False,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.track_running_stats = track_running_stats
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = True, mask=None):
        if train or not self.track_running_stats:
            m = None if mask is None else mask.reshape(-1, *([1] * (x.ndim - 1)))
            mean, var, count = masked_moments(x, m, dim=0)
            if self.track_running_stats:
                with torch.no_grad():
                    n = torch.as_tensor(count, dtype=var.dtype, device=var.device)
                    unbiased = var * (n / torch.clamp(n - 1, min=1))
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean.reshape(-1))
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased.reshape(-1))
            y = (x - mean) * torch.rsqrt(var + self.eps)
        else:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class TorchLinearInit:
    """Torch ``nn.Linear`` initialisation: weights and bias uniform in
    ``±1/sqrt(fan_in)`` (kaiming-uniform with ``a=sqrt(5)``), drawn from an
    explicit generator."""

    @staticmethod
    def uniform_(tensor, fan_in: int, generator=None):
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            return tensor.uniform_(-bound, bound, generator=generator)


def dense(in_features: int, features: int, generator=None) -> nn.Linear:
    """``nn.Linear`` with the torch-style initialisation from
    ``generator``. Parameters stay f32; a caller that computes in bf16 casts
    at the call (:func:`linear`)."""
    lin = nn.Linear(in_features, features)
    TorchLinearInit.uniform_(lin.weight, in_features, generator)
    TorchLinearInit.uniform_(lin.bias, in_features, generator)
    return lin


def linear(lin: nn.Linear, x, dtype=None):
    """Apply ``lin`` computing in ``dtype`` (None = the parameters' f32)."""
    if dtype is None:
        return lin(x)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))
