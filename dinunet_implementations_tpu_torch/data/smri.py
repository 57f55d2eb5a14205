"""The structural-MRI (T1w volume) dataset: the port's own copy of the JAX
package's ``data/smri.py``.

The ICA dataset's fixture convention (``data/ica.py``): a numpy archive of
volumes ``[N, D, H, W]`` named by ``data_file``, and a ``labels_file``
CSV of ``[index, label]`` rows. With ``space_to_depth`` in the task args
each volume's 2x2x2 blocks are folded into 8 channels once, when the site
is read (:func:`space_to_depth_222_np`); the model takes the folded
8-channel input as is.
"""

from __future__ import annotations

import numpy as np

from .api import SiteArrays, SiteDataset
from .ica import ICADataHandle, load_timecourses


def space_to_depth_222_np(vols: np.ndarray) -> np.ndarray:
    """``[N, D, H, W]`` (or with a trailing singleton channel) → ``[N, D/2,
    H/2, W/2, 8]`` with voxel ``(2i+di, 2j+dj, 2k+dk)`` in channel ``di·4 +
    dj·2 + dk``: the model's ``space_to_depth_222`` on the host. More than
    one channel or an odd side raises ``ValueError``."""
    if vols.ndim == 5:
        if vols.shape[-1] != 1:
            raise ValueError(f"space_to_depth needs single-channel volumes, got C={vols.shape[-1]}")
        vols = vols[..., 0]
    N, D, H, W = vols.shape
    if any(d % 2 for d in (D, H, W)):
        raise ValueError(f"space_to_depth needs even spatial dims, got {(D, H, W)}")
    v = vols.reshape(N, D // 2, 2, H // 2, 2, W // 2, 2)
    return np.ascontiguousarray(np.transpose(v, (0, 1, 3, 5, 2, 4, 6))).reshape(
        N, D // 2, H // 2, W // 2, 8)


class SMRIDataset(SiteDataset):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.data = None

    def _load_indices(self, files, **kw):
        self.data = np.asarray(load_timecourses(self.path(cache_key="data_file")), np.float32)
        if self.cache.get("space_to_depth"):
            self.data = space_to_depth_222_np(self.data)
        self.indices += [list(f) for f in files]

    def __getitem__(self, ix) -> dict:
        data_index, y = self.indices[ix]
        return {"inputs": self.data[int(data_index)], "labels": int(y), "ix": ix}

    def as_arrays(self) -> SiteArrays:
        rows = np.asarray([int(i) for i, _ in self.indices])
        return SiteArrays(
            self.data[rows],
            np.asarray([int(y) for _, y in self.indices], np.int32),
            np.arange(len(rows), dtype=np.int32),
        )


class SMRIDataHandle(ICADataHandle):
    """The ICA handle's inventory: the ``[index, label]`` rows of the
    labels CSV."""
