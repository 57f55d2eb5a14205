"""The ctypes bridge to the native batch TSV reader (``native/fastio.cpp``):
the port's counterpart of the JAX package's ``data/native_io.py``.

One call parses and max-normalizes every subject file of a site on C++
threads, bit-identical to :func:`~.freesurfer.read_aseg_stats` (the same
double as Python's ``float()``, an f64 normalize, an f32 cast). Any failure
(no compiler, a malformed or non-finite value, ragged feature counts)
returns ``None`` and the caller reads the files with the Python reader, as
in JAX: this is host I/O, not a device path. A failed batch is retried
briefly first, and a read that hangs (a dead network mount blocks, it does
not fail) is abandoned.

``READS`` counts the batch reads by the reader that produced them
(``"native"`` or ``"python"``, the latter counted by
:meth:`~.freesurfer.FreeSurferDataset.as_arrays`); :func:`reset_counts`
sets both to 0.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from ..robustness.retry import RetryTimeout, with_retry

_lib = None
_tried = False

#: batch reads since the last :func:`reset_counts`, by the reader that ran
READS = {"native": 0, "python": 0}


def reset_counts() -> None:
    for k in READS:
        READS[k] = 0


class NativeReadError(OSError):
    """The native batch reader reported a failure (rc != 0)."""


def _load():
    global _lib, _tried
    if not _tried:
        _tried = True
        from ..native import build_and_load

        lib = build_and_load("fastio")
        if lib is not None:
            lib.fastio_read_aseg_batch.restype = ctypes.c_int
            lib.fastio_read_aseg_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_long,
            ]
        _lib = lib
    return _lib


# Transient failures on a shared filesystem are retried before the Python
# reader takes over; a malformed file fails deterministically and costs two
# short sleeps. The deadline and per-attempt timeout turn a hung read into a
# fast fallback.
@with_retry(attempts=3, base_delay=0.05, max_delay=0.5, retry_on=(NativeReadError,),
            describe="native aseg batch read", deadline_s=30.0, timeout_s=10.0)
def _read_batch_native(lib, paths: list[str], n_feats: int) -> np.ndarray:
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    out = np.empty((len(paths), n_feats), np.float32)
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.fastio_read_aseg_batch(arr, len(paths), n_feats,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    errbuf, len(errbuf))
    if rc != 0:
        raise NativeReadError(errbuf.value.decode(errors="replace"))
    return out


def read_aseg_batch(paths: list[str], n_feats: int) -> np.ndarray | None:
    """Parse ``paths`` into a ``[len(paths), n_feats]`` float32 matrix, or
    ``None`` when the native reader is unavailable or any file fails (after
    the transient-failure retries)."""
    lib = _load()
    if lib is None or not paths or n_feats <= 0:
        return None
    try:
        out = _read_batch_native(lib, paths, n_feats)
    except (NativeReadError, RetryTimeout) as e:
        logging.getLogger(__name__).warning(
            "native aseg read failed (%s); falling back to the Python reader", e)
        return None
    READS["native"] += 1
    return out
