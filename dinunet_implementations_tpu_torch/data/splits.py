"""Train / validation / test splits by ratio, by k folds or from split
files: the port's own copy of the JAX package's ``data/splits.py``. The
RNG draws are JAX's, in the same order, so the same seed gives the same
index sets."""

from __future__ import annotations

import json
import os

import numpy as np

SPLIT_KEYS = ("train", "validation", "test")


def split_by_ratio(n: int, ratio, seed: int = 0) -> dict:
    """Shuffle ``n`` samples and split them by ``ratio`` (train, val,
    test): train and validation floor to ``int(n * r)``, test takes the
    rest. With no test share the flooring remainder goes to validation."""
    ratio = list(ratio)
    test_share = len(ratio) > 2 and ratio[2] > 0
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * ratio[0])
    n_val = (n - n_train) if not test_share else int(n * ratio[1])
    return {
        "train": np.sort(perm[:n_train]),
        "validation": np.sort(perm[n_train:n_train + n_val]),
        "test": np.sort(perm[n_train + n_val:]),
    }


def kfold_splits(n: int, k: int, seed: int = 0) -> list[dict]:
    """K-fold CV (k ≥ 2): fold ``i`` is the test set, fold ``(i+1) % k``
    validation, the rest train. With k == 2 no fold is left for
    validation: it is empty and the other fold trains."""
    if k < 2:
        raise ValueError(f"num_folds must be >= 2, got {k}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    out = []
    for i in range(k):
        test = folds[i]
        if k == 2:
            val = np.array([], int)
            train = folds[(i + 1) % k]
        else:
            val_j = (i + 1) % k
            val = folds[val_j]
            train = np.concatenate([folds[j] for j in range(k) if j not in (i, val_j)])
        out.append({"train": np.sort(train), "validation": np.sort(val), "test": np.sort(test)})
    return out


def load_split_file(path: str) -> dict:
    """A predefined split JSON, ``{"train": [...], "validation": [...],
    "test": [...]}`` of inventory positions."""
    with open(path) as fh:
        spec = json.load(fh)
    return {k: list(spec.get(k, [])) for k in SPLIT_KEYS}


def resolve_splits(n: int, split_ratio=None, num_folds: int | None = None, split_files=(),
                   base_dir: str = "", seed: int = 0) -> list[dict]:
    """The folds of one site: ``split_files`` if given, else ``num_folds``
    k-fold, else ``split_ratio`` (one fold)."""
    if split_files:
        return [load_split_file(os.path.join(base_dir, f)) for f in split_files]
    if num_folds:
        return kfold_splits(n, int(num_folds), seed)
    return [split_by_ratio(n, split_ratio or (0.8, 0.1, 0.1), seed)]
