"""Shared layers: the counterparts of the JAX package's ``models/layers.py``.

The one nontrivial piece is :class:`BatchNorm`. Batches are dense
``[B, ...]`` blocks with weight-0 padding rows, so batch statistics are
mask-weighted: a padded row never shifts the mean or variance. With an
all-ones mask this is torch's biased batch variance.

Training runs every site of a federated round at once, over an explicit
leading site axis: :func:`site_linear`, :func:`site_batchnorm_train`,
:func:`site_batchnorm`, :func:`site_layer_norm` and :func:`site_dropout`
take ``[S, ...]`` inputs and per-site parameters ``[S, ...]`` (stride-0
views of one weight set, whose gradients come back per site), where JAX
maps the per-site step with ``vmap``.
"""

from __future__ import annotations

import functools
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
    """Weighted mean and biased variance over ``dim`` (an int or a tuple,
    e.g. ``(0, 2, 3, 4)`` for per-channel statistics of a convolution's
    ``[B, C, D, H, W]``); ``mask`` broadcasts against ``x``, and the count
    tallies every reduced position it covers (a ``[B, 1, 1, 1, 1]`` mask
    counts ``B·D·H·W``). Returns ``(mean, var, count)`` with kept dims."""
    if mask is None:
        mean = x.mean(dim=dim, keepdim=True)
        var = (x - mean).square().mean(dim=dim, keepdim=True)
        return mean, var, math.prod(x.shape[d] for d in ((dim,) if isinstance(dim, int) else dim))
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


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis (:func:`site_layer_norm`):
    ``weight`` (JAX's ``scale``) ones, ``bias`` zeros, ``eps`` 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return site_layer_norm(x[None], self.weight[None], self.bias[None], self.eps)[0]


class TorchLinearInit:
    """Torch ``nn.Linear`` initialisation: weights and bias uniform in
    ``±1/sqrt(fan_in)`` (kaiming-uniform with ``a=sqrt(5)``), drawn from an
    explicit generator."""

    @staticmethod
    def uniform_(tensor, fan_in: int, generator=None):
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            return tensor.uniform_(-bound, bound, generator=generator)


def dense(in_features: int, features: int, generator=None, bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with the torch-style initialisation from
    ``generator`` (``bias=False``: no bias). Parameters stay f32; a caller
    that computes in bf16 casts at the call (:func:`linear`)."""
    lin = nn.Linear(in_features, features, bias=bias)
    TorchLinearInit.uniform_(lin.weight, in_features, generator)
    if bias:
        TorchLinearInit.uniform_(lin.bias, in_features, generator)
    return lin


def linear(lin: nn.Linear, x, dtype=None):
    """Apply ``lin`` computing in ``dtype`` (None = the parameters' f32)."""
    if dtype is None:
        return lin(x)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def param_at(module: nn.Module, name: str):
    """The tensor at a ``state_dict`` name of ``module``, read through the
    attributes, so that ``torch.func.functional_call``'s tensors are the
    ones read."""
    return functools.reduce(getattr, name.split("."), module)


def site_linear(w, b, x, dtype=None):
    """A dense layer per site: ``x [S, N, in]`` with ``w [S, out, in]``
    (``nn.Linear`` layout) and ``b [S, out]`` (None: no bias), computing in
    ``dtype`` (None = f32). One batched product; each site's weight
    gradient is its own."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    if b is None:
        return torch.bmm(x, w.transpose(1, 2))
    return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))


def site_batchnorm_train(x, mask, weight, bias, running_mean, running_var,
                         momentum: float = 0.1, eps: float = 1e-5):
    """The train step of :class:`BatchNorm` (running statistics tracked) for
    every site at once: ``x [S, B, F]`` normalised by each site's
    ``mask [S, B]``-weighted batch moments, ``weight, bias [S, F]``.

    Returns ``(y, (mean, var))`` with the sites' new running statistics
    ``[S, F]`` (momentum update, unbiased variance). The running statistics
    are inputs, never written in place: the trainer carries them per site
    across micro-batches and averages them across sites afterwards
    (sync-BN)."""
    mean, var, count = masked_moments(x, mask[..., None], dim=1)
    with torch.no_grad():
        unbiased = var * (count / torch.clamp(count - 1, min=1))
        new_mean = (1 - momentum) * running_mean + momentum * mean[:, 0]
        new_var = (1 - momentum) * running_var + momentum * unbiased[:, 0]
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * weight[:, None] + bias[:, None], (new_mean, new_var)


def site_batchnorm(x, mask, weight, bias, eps: float = 1e-5):
    """:class:`BatchNorm` without running statistics for every site at
    once: ``x [S, B, F]``, or ``[S, B, C, *spatial]`` for a convolution's
    per-channel statistics over the batch and every spatial position
    (BatchNorm3d, JAX's ``reduce_axes=(0, 1, 2, 3)``), normalised by each
    site's ``mask [S, B]``-weighted batch moments (train and eval alike);
    ``weight, bias [S, F]`` or ``[S, C]``."""
    lead = (x.shape[0], x.shape[1])
    tail = [1] * (x.ndim - 3)
    m = mask.reshape(*lead, *([1] * (x.ndim - 2)))
    mean, var, _ = masked_moments(x, m, dim=(1,) + tuple(range(3, x.ndim)))
    w = weight.reshape(lead[0], 1, -1, *tail)
    b = bias.reshape(lead[0], 1, -1, *tail)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def site_layer_norm(x, weight, bias, eps: float = 1e-6):
    """flax's ``nn.LayerNorm`` over the last axis for every site at once:
    ``x [S, ..., E]``, ``weight, bias [S, E]``; the variance is flax's
    ``E[x²] - E[x]²`` clipped at 0, and ``eps`` its 1e-6 (torch's default
    is 1e-5)."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean.square(), min=0.0)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (x - mean) * torch.rsqrt(var + eps) * weight.reshape(shape) + bias.reshape(shape)


class SiteBlockDraw:
    """A dropout generator for one rank's ``[K]`` block of ``sites`` sites
    (the process-group site mesh): each draw is made for all sites, as the
    one-device round draws it, and the rows of sites ``start`` to ``start
    + count`` are kept, so that a site's mask does not depend on how the
    sites are spread over ranks. Site-major rows (``[K, ...]`` or ``[K·B,
    ...]``) are what :func:`site_dropout` is given."""

    def __init__(self, generator, sites: int, start: int, count: int):
        self.generator, self.sites, self.start, self.count = generator, sites, start, count

    def rand(self, shape, device):
        rows = shape[0] // self.count  # a site's rows
        full = torch.rand((rows * self.sites,) + tuple(shape[1:]), generator=self.generator,
                          device=device)
        return full[rows * self.start:rows * (self.start + self.count)]


def site_dropout(x, rate: float, generator=None):
    """Dropout with its mask drawn from ``generator`` (on ``x``'s device; a
    :class:`SiteBlockDraw` draws for every site and keeps its block): each
    element kept with probability ``1 - rate`` and scaled by ``1 / (1 -
    rate)``, as flax's ``nn.Dropout``. Every call draws anew, so sites and
    micro-batches get masks of their own. ``rate == 0`` is the
    identity."""
    if rate == 0:
        return x
    if isinstance(generator, SiteBlockDraw):
        u = generator.rand(x.shape, x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
