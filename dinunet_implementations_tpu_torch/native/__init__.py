"""Native (C++) host components, compiled with ``g++`` at first use and
loaded through :mod:`ctypes`: the port's counterpart of the JAX package's
``native/__init__.py``.

- ``fastio.cpp``: the threaded batch parser of FreeSurfer aseg TSVs
  (:func:`~..data.native_io.read_aseg_batch`).

A library goes to ``build/native/<hash>/`` under the checkout, keyed by a
hash of its source and flags (beside ``ops/_build.py``'s
``build/torch_kernels/``), so a fresh checkout builds from the sources in
the repository and an unchanged one reuses its build. The directory is made
``0700`` and the library is loaded only when it and its directory are
owned by this user and writable by nobody else, as in JAX. Any failure (no
compiler, a compile error, an untrusted file) returns ``None``: callers
keep a Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import stat
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _private(path: Path) -> bool:
    """``path`` is a file or directory of this user (not a symlink) that no
    group or other user can write: one ``lstat`` snapshot."""
    st = os.lstat(path)
    kind = stat.S_ISDIR(st.st_mode) or stat.S_ISREG(st.st_mode)
    return kind and st.st_uid == os.getuid() and not (st.st_mode & 0o022)


def build_dir(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds: a hash of its bytes and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_and_load(name: str) -> ctypes.CDLL | None:
    """Compile ``native/<name>.cpp`` (once per source hash) and load it;
    ``None`` on any failure."""
    try:
        out = build_dir(name)
        out.mkdir(mode=0o700, parents=True, exist_ok=True)
        if not _private(out):
            return None
        lib = out / f"lib{name}.so"
        if not lib.exists():
            tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")],
                           check=True, capture_output=True, timeout=120)
            os.chmod(tmp, 0o700)
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        if not _private(lib):
            return None  # not ours, or writable by others: refuse to load
        return ctypes.CDLL(str(lib))
    except (OSError, subprocess.SubprocessError):
        # OSError: g++ missing, an unwritable build directory or a failed
        # load; SubprocessError: the compile failed or timed out
        return None
