"""Builds the port's CUDA sources on first use.

Every ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with :mod:`ctypes`. The
libraries go to ``build/torch_kernels/<hash>/`` under the checkout, keyed by
a hash of the sources and flags, so a fresh checkout builds everything from
the sources in the repository and an unchanged one reuses its build. All
sources compile at once, one ``nvcc`` each, under a file lock in the build
directory, so that processes starting together on an empty directory (the
ranks of a process group) build each library once: the first builds, the
others wait and load. :func:`enable_compile_cache` moves the root
elsewhere (the compile cache).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, and each source's nvcc output
#: (``-Xptxas=-v`` prints registers, shared memory and spills per kernel)
last_build: dict = {}
#: sources compiled and libraries loaded in this process: the serving
#: engine holds both still after its warmup (``compiles_after_warmup``)
BUILDS = 0
LOADS = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet; returns name → path.
    Raises with nvcc's output if any source fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(out_dir)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(out_dir: Path) -> dict[str, Path]:
    t0 = time.monotonic()
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    procs = {}
    for src in _sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    logs, failed = {}, []
    global BUILDS
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
            BUILDS += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{logs[n]}" for n in failed))
    last_build.update(seconds=time.monotonic() - t0, logs=logs, dir=str(out_dir))
    return libs


def enable_compile_cache(path) -> Path:
    """Point the library root at ``path`` (``TrainConfig.compile_cache_dir``,
    CLI ``--compile-cache``), the port's counterpart of JAX's persistent
    compilation cache: libraries build into and load from
    ``<path>/<source hash>/``, so a process loads what an earlier process
    built there, from the same sources and flags, and builds nothing.
    Process-wide and idempotent; a library already loaded stays loaded."""
    global BUILD_ROOT
    root = Path(path).expanduser().resolve()
    root.mkdir(parents=True, exist_ok=True)
    BUILD_ROOT = root
    return root


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    global LOADS
    with _lock:
        if name not in _libs:
            libs = build_all()
            if name not in libs:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(str(libs[name]))
            LOADS += 1
        return _libs[name]
