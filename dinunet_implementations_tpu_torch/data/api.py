"""A site's dataset as dense arrays, every site's stacked on one grid, and
the dataset / data-handle pair a task reads a site with: the port's own
copy of the JAX package's ``data/api.py`` (``SiteArrays``,
``SiteInventory``, ``stack_site_inventory``, ``SiteDataset``,
``DataHandle``, ``build_site_dataset``).

The dataset keeps the reference's contract (``COINNDataset``: ``cache``,
``state``, ``indices``, ``path()``, the ``load_index`` /
``_load_indices`` / ``__getitem__`` hooks; ``COINNDataHandle`` with
``list_files``), and every dataset materializes once to dense numpy arrays
(:meth:`SiteDataset.as_arrays`), which the trainer stacks across sites.
"""

from __future__ import annotations

import os
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


class SiteDataset:
    """Base dataset: ``cache`` is the task's flat configuration dict,
    ``state`` holds at least ``baseDirectory`` (the site's data root),
    ``mode`` is ``"train"`` or ``"test"``."""

    def __init__(self, cache=None, state=None, mode: str = "train", **kw):
        self.cache = dict(cache or {})
        self.state = dict(state or {})
        self.mode = mode
        self.indices: list = []

    def path(self, cache_key: str = "data_file") -> str:
        """``cache[cache_key]`` under the site's base directory; the base
        directory itself when the key is unset or empty."""
        base = self.state.get("baseDirectory", "")
        name = self.cache.get(cache_key) or ""
        return os.path.join(base, name) if name else base

    def load_index(self, file):
        """Register one inventory entry (a hook subclasses override)."""
        self.indices.append(file)

    def _load_indices(self, files, **kw):
        """Register every inventory entry (a hook subclasses override)."""
        for f in files:
            self.load_index(f)

    def __getitem__(self, ix) -> dict:
        raise NotImplementedError

    def __len__(self):
        return len(self.indices)

    def as_arrays(self) -> SiteArrays:
        """The whole site as dense arrays: by default the stacked
        ``__getitem__`` items; subclasses override with a vectorized
        loader."""
        items = [self[i] for i in range(len(self))]
        inputs = np.stack([np.asarray(it["inputs"], np.float32) for it in items])
        labels = np.asarray([int(it["labels"]) for it in items], np.int32)
        ixs = np.asarray([int(it.get("ix", i)) for i, it in enumerate(items)], np.int32)
        return SiteArrays(inputs, labels, ixs)


class DataHandle:
    """Base data handle: ``list_files`` gives a site's sample inventory."""

    def __init__(self, cache=None, state=None, **kw):
        self.cache = dict(cache or {})
        self.state = dict(state or {})

    def list_files(self) -> list:
        raise NotImplementedError


def build_site_dataset(dataset_cls, handle_cls, cache: dict, state: dict,
                       mode: str = "train") -> SiteDataset:
    """Wire a (dataset, data handle) pair as the reference's ``COINNLocal``
    does on its first round: ``handle.list_files`` into
    ``dataset._load_indices``."""
    handle = handle_cls(cache=cache, state=state)
    ds = dataset_cls(cache=cache, state=state, mode=mode)
    ds._load_indices(handle.list_files())
    return ds
