"""A site's dataset as dense arrays, and every site's stacked on one grid:
the port's own copy of the numpy-only part of the JAX package's
``data/api.py`` (``SiteArrays``, ``SiteInventory``,
``stack_site_inventory``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SiteArrays:
    """One site's full dataset as dense arrays (the unit of feeding)."""

    inputs: np.ndarray  # [n, ...] float32
    labels: np.ndarray  # [n] int32
    indices: np.ndarray  # [n] int32 — position in the site's sample inventory

    def __len__(self):
        return len(self.labels)

    def take(self, ix) -> "SiteArrays":
        ix = np.asarray(ix)
        return SiteArrays(self.inputs[ix], self.labels[ix], self.indices[ix])


@dataclass
class SiteInventory:
    """Every site's full dataset stacked on a common ``[S, N_max, ...]``
    grid, the unit of device residency: uploaded once per fit, after which
    each epoch gathers its batches on the device from a compact index plan
    (trainer/steps.py). Sites smaller than ``N_max`` are zero-padded; a plan
    never points a live slot at a pad row (``counts`` bounds the valid
    prefix)."""

    inputs: np.ndarray  # [S, N_max, ...] float32
    labels: np.ndarray  # [S, N_max] int32
    counts: np.ndarray  # [S] int32 — valid rows per site

    @property
    def num_sites(self):
        return self.inputs.shape[0]

    @property
    def nbytes(self) -> int:
        return self.inputs.nbytes + self.labels.nbytes


def stack_site_inventory(sites: list[SiteArrays], rows: int | None = None) -> SiteInventory:
    """Pad heterogeneous sites onto one dense ``[S, N_max, ...]`` grid.
    ``rows`` pins ``N_max``; it must cover the largest site."""
    n_max = max((len(s) for s in sites), default=0)
    assert n_max > 0, "all sites empty"
    if rows is not None:
        assert rows >= n_max, (
            f"pinned inventory rows ({rows}) below the largest site ({n_max} samples)"
        )
        n_max = rows
    feat_shape = next(s.inputs.shape[1:] for s in sites if len(s))
    S = len(sites)
    inputs = np.zeros((S, n_max) + feat_shape, np.float32)
    labels = np.zeros((S, n_max), np.int32)
    counts = np.zeros((S,), np.int32)
    for si, s in enumerate(sites):
        n = len(s)
        counts[si] = n
        if n:
            inputs[si, :n] = s.inputs
            labels[si, :n] = s.labels
    return SiteInventory(inputs, labels, counts)
