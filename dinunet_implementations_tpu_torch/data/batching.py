"""Epoch planning: the port's own copy of the JAX package's
``data/batching.py`` (``EpochPlan``, ``FedBatches``, ``epoch_steps``,
``plan_epoch_positions``, ``materialize_plan``, ``plan_epoch``,
``plan_eval``).

All sites of one program take the same number of steps per epoch, so the
plan is a dense ``positions [S, steps, B]`` grid of int32 sample positions
into each site's inventory, ``-1`` marking a padding slot. In ``"wrap"``
mode (train) a site with fewer batches than the epoch's ``steps`` recycles
its reshuffled data, like the reference's cycling DataLoader; ``"mask"``
pads with weight 0 instead. The RNG draw order is the JAX package's, so a
plan from the same seed is byte-identical to it.

The device pipeline ships only the plan; the host pipeline and eval expand
it into dense :class:`FedBatches` (:func:`materialize_plan`), so the two
pipelines read one plan two ways.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .api import SiteArrays


@dataclass
class EpochPlan:
    """Per-(site, step, slot) sample positions into each site's own
    inventory; ``-1`` marks a padding slot (zero input, label and weight)."""

    positions: np.ndarray  # [S, steps, B] int32; -1 = padding

    @property
    def num_sites(self):
        return self.positions.shape[0]

    @property
    def steps(self):
        return self.positions.shape[1]

    @property
    def batch_size(self):
        return self.positions.shape[2]

    @property
    def nbytes(self) -> int:
        return self.positions.nbytes


@dataclass
class FedBatches:
    """A plan's dense host arrays: ``inputs [S, steps, B, ...]``,
    ``labels`` and ``weights [S, steps, B]`` (1 for a real example, 0 for
    padding) and ``indices [S, steps, B]`` (inventory position, -1 for
    padding)."""

    inputs: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    indices: np.ndarray

    @property
    def num_sites(self):
        return self.inputs.shape[0]

    @property
    def steps(self):
        return self.inputs.shape[1]

    @property
    def batch_size(self):
        return self.inputs.shape[2]


def _site_batches(arr, batch_size: int, order: np.ndarray, drop_last: bool):
    """Chunk one site's ordered samples into batches of ``batch_size``,
    the last possibly shorter."""
    n = len(order)
    if drop_last:
        n = (n // batch_size) * batch_size
    return [order[i : i + batch_size] for i in range(0, n, batch_size)]


def _site_batch_count(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def epoch_steps(sites: list[SiteArrays], batch_size: int, drop_last: bool = True) -> int:
    """Steps per epoch for this site set: the largest per-site batch count."""
    return max(_site_batch_count(len(s), batch_size, drop_last) for s in sites)


def plan_epoch_positions(
    sites: list[SiteArrays],
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    pad_mode: str = "wrap",
    steps: int | None = None,
) -> EpochPlan:
    """Build the compact ``[S, steps, B]`` epoch plan (module docstring).
    ``steps`` pins the step-grid height: a taller grid recycles every
    site's shuffled order, a shorter one drops the tail batches."""
    assert pad_mode in ("wrap", "mask")
    target_steps = steps
    assert target_steps is None or target_steps > 0, target_steps
    S = len(sites)
    feat_shape = None
    for s in sites:
        if len(s):
            fs = s.inputs.shape[1:]
            assert feat_shape is None or fs == feat_shape, "heterogeneous feature shapes"
            feat_shape = fs
    assert feat_shape is not None, "all sites empty"

    rng = np.random.default_rng(seed)

    def draw_order(n: int) -> np.ndarray:
        return rng.permutation(n) if shuffle else np.arange(n)

    first_orders = [draw_order(len(s)) for s in sites]
    counts = [_site_batch_count(len(s), batch_size, drop_last) for s in sites]
    steps = max(counts)
    assert steps > 0, (
        f"no site yields a batch: batch_size={batch_size} exceeds every site's sample "
        f"count {[len(s) for s in sites]} with drop_last={drop_last}"
    )

    positions = np.full((S, steps, batch_size), -1, np.int32)
    for si, (site, order, nb) in enumerate(zip(sites, first_orders, counts)):
        n = len(site)
        if nb == 0:
            continue  # mask-only site: all padding
        if pad_mode == "wrap" and nb < steps:
            if drop_last:
                # full batches only: tile the batch-aligned prefixes of the
                # first and the extra orders, then reshape
                usable = (n // batch_size) * batch_size
                extra = -(-(steps - nb) // nb)  # ceil: reshuffles needed
                tiled = np.concatenate(
                    [order[:usable]] + [draw_order(n)[:usable] for _ in range(extra)]
                )
                positions[si] = tiled[: steps * batch_size].reshape(steps, batch_size)
                continue
            batches = _site_batches(site, batch_size, order, drop_last)
            while len(batches) < steps:
                batches.extend(_site_batches(site, batch_size, draw_order(n), drop_last))
            for bi, ix in enumerate(batches[:steps]):
                positions[si, bi, : len(ix)] = ix
            continue
        for bi, ix in enumerate(_site_batches(site, batch_size, order, drop_last)):
            positions[si, bi, : len(ix)] = ix
    if target_steps is not None and target_steps != steps:
        if target_steps < steps:
            positions = positions[:, :target_steps]
        else:
            reps = -(-target_steps // steps)
            positions = np.tile(positions, (1, reps, 1))[:, :target_steps]
    return EpochPlan(positions)


def materialize_plan(sites: list[SiteArrays], plan: EpochPlan) -> FedBatches:
    """Expand a plan into the dense host arrays; padding slots (-1) are
    zero inputs and labels with weight 0, as the device gather makes
    them."""
    S, steps, B = plan.positions.shape
    feat_shape = next(s.inputs.shape[1:] for s in sites if len(s))
    inputs = np.zeros((S, steps, B) + feat_shape, np.float32)
    labels = np.zeros((S, steps, B), np.int32)
    weights = np.zeros((S, steps, B), np.float32)
    indices = np.full((S, steps, B), -1, np.int32)
    for si, site in enumerate(sites):
        flat = plan.positions[si].reshape(-1)
        valid = flat >= 0
        if not valid.any():
            continue
        sel = flat[valid]
        inputs[si].reshape((steps * B,) + feat_shape)[valid] = site.inputs[sel]
        labels[si].reshape(-1)[valid] = site.labels[sel]
        weights[si].reshape(-1)[valid] = 1.0
        indices[si].reshape(-1)[valid] = site.indices[sel]
    return FedBatches(inputs, labels, weights, indices)


def plan_epoch(sites: list[SiteArrays], batch_size: int, seed: int = 0, shuffle: bool = True,
               drop_last: bool = True, pad_mode: str = "wrap",
               steps: int | None = None) -> FedBatches:
    """The dense ``[S, steps, B, ...]`` epoch: :func:`plan_epoch_positions`
    materialized."""
    return materialize_plan(sites, plan_epoch_positions(
        sites, batch_size, seed=seed, shuffle=shuffle, drop_last=drop_last,
        pad_mode=pad_mode, steps=steps))


def plan_eval(sites: list[SiteArrays], batch_size: int) -> FedBatches:
    """One deterministic pass over every sample: no shuffle, no drop,
    padding masked."""
    return plan_epoch(sites, batch_size, shuffle=False, drop_last=False, pad_mode="mask")
