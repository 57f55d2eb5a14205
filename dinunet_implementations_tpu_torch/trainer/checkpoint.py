"""Checkpoints in the JAX package's file format, without flax or msgpack:
the port's counterpart of its ``trainer/checkpoint.py``.

A file is the flax-msgpack state dict of the trainer's state (the
:mod:`._msgpack` codec), framed with a CRC32 of the payload (magic
``DNTCK1``), written through a temporary file and ``os.replace``; with
``rotate=True`` the previous generation survives as ``<path>.prev``, and a
load that meets a missing, torn or corrupt file falls back to it. Unframed
files (written before the frame existed) still load.

The payload keys are JAX's: ``params``, ``batch_stats``, ``opt_state``
(optax's chain as flax writes it: ``{"0": {"count", "mu", "nu"}, "1": {}}``
for Adam, ``{"0": {}, "1": {}}`` for SGD), ``engine_state`` (``{}`` for
dSGD, rankDAD's per-site ``{"omega": ...}``, powerSGD's per-site ``{"q":
..., "e": ...}``, with None for a dense leaf),
``rng`` (a threefry key, ``uint32 [2]``: the port's int seed ``s`` is
written as ``[s >> 32, s & 0xffffffff]``, which is ``PRNGKey(s)``),
``round``, ``health``, the round metrics ``telemetry`` (``[S]`` leaves),
the staleness ``buffers``,
the ``overlap`` stash and the personalized heads' rows ``personal``
(``{"params": head subtree [S, ...], "opt": {"0": {"count" [S], "mu",
"nu"}, "1": {}}}``; each ``{}`` while its mode is off, restored the
tolerant way JAX restores them), and ``meta_json``.
Trees are in JAX layout (flax kernels ``[in, out]``) through
``weights.train_state_to_jax`` / ``train_state_from_tree``, so a file the
port writes restores in JAX with ``load_checkpoint(path, like=jax_state)``
and a file JAX writes restores here. The model's leaf table (``weights.LeafTable``) comes from the state
at hand (the one saved, or ``like``): a state of a model without running
statistics (MSANNet, SMRI3DNet, MultimodalNet) writes the empty
``batch_stats`` map that JAX writes for it.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import warnings
import zlib

import numpy as np
import torch

from ..weights import (
    _nest,
    _params_to_jax,
    _params_to_port,
    engine_state_from_jax,
    personal_from_jax,
    slot_tree_from_jax,
    table_of,
    telemetry_from_jax,
    train_state_from_tree,
    train_state_to_jax,
)
from ..robustness.health import health_from_numpy
from . import _msgpack
from .steps import TrainState

#: frame = magic + little-endian CRC32 of the msgpack blob + the blob
_MAGIC = b"DNTCK1\n"


class CorruptCheckpointError(RuntimeError):
    """The checkpoint file exists but fails its checksum or decoding."""


def _atomic_write(path: str, data) -> None:
    """Write through a temporary file and ``os.replace``: a kill mid-write
    never leaves a truncated file at ``path``."""
    mode = "wb" if isinstance(data, bytes) else "w"
    tmp = path + ".tmp"
    with open(tmp, mode) as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _frame(blob: bytes) -> bytes:
    return _MAGIC + struct.pack("<I", zlib.crc32(blob)) + blob


def _read_raw(path: str) -> dict:
    """One checkpoint file as its decoded state dict; raises
    :class:`CorruptCheckpointError` on a checksum or decoding failure."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_MAGIC):
        head = len(_MAGIC) + 4
        if len(data) < head:
            raise CorruptCheckpointError(f"{path}: truncated checkpoint frame")
        (crc,) = struct.unpack("<I", data[len(_MAGIC):head])
        blob = data[head:]
        if zlib.crc32(blob) != crc:
            raise CorruptCheckpointError(f"{path}: payload checksum mismatch (torn or corrupt file)")
    else:
        blob = data  # unframed legacy checkpoint
    try:
        raw = _msgpack.unpackb(blob)
    except (ValueError, IndexError, UnicodeDecodeError, TypeError) as e:
        raise CorruptCheckpointError(f"{path}: undecodable checkpoint: {e}") from e
    if not isinstance(raw, dict):
        raise CorruptCheckpointError(f"{path}: not a checkpoint state dict")
    return raw


def _load_raw(path: str, fallback: bool = True) -> dict:
    """Read ``path``, falling back to ``path + '.prev'`` (the rotated
    previous generation) when the primary is missing or corrupt."""
    try:
        return _read_raw(path)
    except (OSError, CorruptCheckpointError) as e:
        prev = path + ".prev"
        if fallback and os.path.exists(prev):
            warnings.warn(f"checkpoint {path} unreadable ({e}); falling back to the previous "
                          f"generation {prev}")
            return _read_raw(prev)
        raise


def _sorted(tree):
    """Nested dicts with their keys sorted at every level (the order flax
    writes a tree in)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _key(seed: int) -> np.ndarray:
    seed = int(seed) & (2 ** 64 - 1)
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _seed(key, default: int) -> int:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype.kind not in "ui":
        return default
    return (int(k[0]) << 32) | int(k[1])


def _meta(raw: dict) -> dict:
    meta = raw.get("meta_json") or "{}"
    if isinstance(meta, bytes):
        meta = meta.decode()
    return json.loads(meta)


def save_checkpoint(path: str, state: TrainState, meta: dict | None = None,
                    rotate: bool = False) -> str:
    """Write ``state`` with ``meta`` (paired with it inside the payload) to
    ``path``. ``rotate=True`` first keeps the previous generation as
    ``path + '.prev'``. With a ``meta``, a human-readable
    ``path + '.meta.json'`` sidecar is written too."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t = train_state_to_jax(state)

    def chain(opt):
        """optax's chain as flax writes it."""
        first = ({"count": np.asarray(opt["count"], np.int32), "mu": _sorted(opt["mu"]),
                  "nu": _sorted(opt["nu"])} if opt else {})
        return {"0": first, "1": {}}

    personal = t["personal"]
    payload = {
        "params": _sorted(t["params"]),
        "batch_stats": _sorted(t["batch_stats"]),
        "opt_state": chain(t["opt_state"]),
        "engine_state": _sorted(t["engine_state"]),
        "rng": _key(t["rng"]),
        "round": np.asarray(t["round"], np.int32),
        "health": _sorted(t["health"]),
        "telemetry": _sorted(t["telemetry"]) if t["telemetry"] is not None else {},
        "buffers": _sorted(t["buffers"]) if t["buffers"] is not None else {},
        "overlap": _sorted(t["overlap"]) if t["overlap"] is not None else {},
        "personal": ({} if personal is None else
                     {"opt": chain(personal["opt"]), "params": _sorted(personal["params"])}),
        "meta_json": json.dumps(meta or {}),
    }
    # serialize before rotating: a failure here must not have moved the old
    # generation away
    framed = _frame(_msgpack.packb(payload))
    if rotate and os.path.exists(path):
        os.replace(path, path + ".prev")
    _atomic_write(path, framed)
    if meta is not None:
        _atomic_write(path + ".meta.json", json.dumps(meta, indent=2, default=float))
    return path


def _device_of(state: TrainState):
    return next(iter(state.params.values())).device


def _same_shapes(got: dict, like: dict) -> bool:
    return got.keys() == like.keys() and all(
        (got[k] is None) == (like[k] is None)
        and (got[k] is None or tuple(got[k].shape) == tuple(like[k].shape)) for k in like)


def load_checkpoint(path: str, like: TrainState, with_meta: bool = False,
                    fallback: bool = True):
    """Restore a state of ``like``'s structure, on its device;
    ``with_meta=True`` also returns the paired meta. ``fallback`` (default
    on) retries ``path + '.prev'`` when ``path`` is missing, torn or
    corrupt.

    Params, running statistics, optimizer state, rng and round must match
    ``like`` (a ``ValueError`` otherwise). As in JAX, the engine state
    restores tolerantly: a stored tree that does not match ``like``'s
    (another engine or knob, absent in an older file) gives ``like``'s
    with a warning, a cold restart of the warm-start carry; so do the
    staleness buffers, the overlap stash and the personalized heads'
    rows. The per-site
    health restores field by field (:func:`_restore_health`), so a robust
    run resumed from a plain checkpoint keeps its counters (JAX's restore
    would start them fresh)."""
    raw = _load_raw(path, fallback=fallback)
    table = table_of(like.params)
    dev = _device_of(like)
    opt = raw.get("opt_state", {})
    first = opt.get("0", {}) if isinstance(opt, dict) else {}
    if bool(first) != bool(like.opt_state):
        raise ValueError(f"checkpoint {path}: optimizer state does not match the current "
                         "optimizer")
    # every TrainState field is named on this side of the file, in the
    # template or in a read below (the AST lint's R006)
    template = {"params": raw["params"], "batch_stats": raw.get("batch_stats", {}),
                "opt_state": first, "engine_state": {}, "rng": _seed(raw.get("rng"), like.rng),
                "round": raw["round"], "health": {}}
    state = train_state_from_tree(template, table, dev)
    for what, got, want in (("params", state.params, like.params),
                            ("batch_stats", state.batch_stats, like.batch_stats)):
        if not _same_shapes(got, want):
            raise ValueError(f"checkpoint {path}: {what} do not match the current model")
    engine_state = like.engine_state
    try:
        # the leaves the live engine aggregates (the shared ones under
        # personalization)
        names = set(next(iter(like.engine_state.values()))) if like.engine_state else None
        stored = engine_state_from_jax(raw.get("engine_state") or {}, table, dev, names)
        ok = stored.keys() == like.engine_state.keys() and all(
            _same_shapes(stored[k], like.engine_state[k]) for k in stored)
    except ValueError:
        ok = False
    if ok:
        engine_state = stored
    elif raw.get("engine_state") or like.engine_state:
        warnings.warn(f"checkpoint {path}: stored engine state does not match the current "
                      "engine's structure; resuming with fresh engine state")
    health = _restore_health(path, raw.get("health") or {}, like.health, dev)
    buffers = _restore_slot_tree(path, "staleness buffers", raw.get("buffers"), like.buffers,
                                 table, dev)
    overlap = _restore_slot_tree(path, "overlap stash", raw.get("overlap"), like.overlap, table,
                                 dev)
    personal = _restore_personal(path, raw.get("personal"), like.personal, table, dev)
    telemetry = _restore_telemetry(path, raw.get("telemetry"), like.telemetry, dev)
    state = TrainState(params=state.params, batch_stats=state.batch_stats,
                       opt_state=state.opt_state, engine_state=engine_state, rng=state.rng,
                       round=state.round, health=health, buffers=buffers, overlap=overlap,
                       personal=personal, telemetry=telemetry)
    return (state, _meta(raw)) if with_meta else state


def _restore_telemetry(path: str, stored, like: dict | None, dev):
    """The round-metric accumulators, restored the tolerant way JAX restores
    them: ``like``'s (None for a telemetry-off run, fresh zeros otherwise)
    when the file holds none (an older file), and, with a warning, when it
    holds other keys or another site count."""
    if not stored or like is None:
        return like
    got = telemetry_from_jax(stored, dev)
    if _same_tree(got, like):
        return got
    warnings.warn(f"checkpoint {path}: stored telemetry accumulators do not match the current "
                  "run (site count or schema changed?); resuming with fresh accumulators")
    return like


def _restore_personal(path: str, stored, want, table, dev):
    """The personalized heads' rows (``stored``, the file's), restored the
    tolerant way JAX restores them: ``want`` (the template's: None for a run
    without personalization, fresh common-model rows otherwise) when the
    file holds none, and, with a warning, when it holds rows of another
    site count or partition."""
    if not stored or want is None:
        return want
    try:
        opt = stored.get("opt") or {}
        first = opt.get("0", {}) if isinstance(opt, dict) else {}
        got = personal_from_jax({"params": stored.get("params"), "opt": first}, table, dev)
        ok = got is not None and _same_tree(got, want)
    except (KeyError, TypeError, ValueError, AttributeError):
        ok = False
    if ok:
        return got
    warnings.warn(f"checkpoint {path}: stored personalized-head rows do not match the current "
                  "run (site count or partition patterns changed?); resuming with fresh "
                  "common-model heads")
    return want


def _same_tree(got, like) -> bool:
    if isinstance(like, dict):
        return (isinstance(got, dict) and got.keys() == like.keys()
                and all(_same_tree(got[k], like[k]) for k in like))
    return tuple(got.shape) == tuple(like.shape) and got.dtype == like.dtype


def _restore_slot_tree(path: str, what: str, stored, want, table, dev):
    """The staleness buffers or the overlap stash (``what``; ``stored``, the
    file's), restored the tolerant way JAX restores them: ``want`` (the
    template's: None while the mode is off, or fresh) when the file holds
    none or one of another shape, the latter with a warning."""
    if not stored or want is None:
        return want
    try:
        got = slot_tree_from_jax(stored, table, dev)
        ok = _same_tree(got, want)
    except (KeyError, TypeError, ValueError):
        ok = False
    if ok:
        return got
    warnings.warn(f"checkpoint {path}: stored {what} do not match the current run (site count "
                  f"or model changed?); resuming with fresh ones")
    return want


def _restore_health(path: str, stored: dict, like: dict, dev) -> dict:
    """The stored per-site health, key by key: each field ``like`` has and
    the file holds at ``like``'s shape comes back in its own dtype
    (``robustness.health.HEALTH_DTYPES``), each other field keeps
    ``like``'s. A field the file lacks (the reputation fields of a robust
    run resumed from a plain checkpoint) stays as ``like`` has it, and one
    ``like`` lacks is dropped, as the epoch's ``_ensure_health`` would do.
    A stored field at another site count gives ``like``'s health whole,
    with a warning."""
    if not stored:
        return like
    if any(k in like and np.shape(v) != tuple(like[k].shape) for k, v in stored.items()):
        warnings.warn(f"checkpoint {path}: stored site-health counters do not match the "
                      "current run (site count changed?); resuming with fresh counters")
        return like
    back = health_from_numpy({k: v for k, v in stored.items() if k in like}, dev)
    return {k: back.get(k, v) for k, v in like.items()}


def load_meta(path: str, fallback: bool = True) -> dict:
    """The meta paired with a checkpoint's state, read without a state
    template; falls back to ``.prev`` as :func:`load_checkpoint` does.
    ``fallback=False`` reads exactly the named generation."""
    return _meta(_load_raw(path, fallback=fallback))


def load_params(path: str, like_params: dict) -> dict:
    """A warm start: only the params of a checkpoint, by ``state_dict``
    name, on ``like_params``' device and checked against its shapes."""
    raw = _load_raw(path)
    dev = next(iter(like_params.values())).device
    params = {k: v.to(dev) for k, v in _params_to_port(raw["params"], table_of(like_params),
                                                      "params").items()}
    if not _same_shapes(params, like_params):
        raise ValueError(f"checkpoint {path}: params do not match the current model")
    return params


def load_inference_state(path: str):
    """``(params, batch_stats, meta)`` of a checkpoint as JAX-layout trees,
    with every training-only part left out: what
    ``InferenceEngine(params=..., batch_stats=...)`` takes. Needs no
    template, so the training run's site count or engine never blocks it;
    falls back to ``.prev`` as every loader does."""
    raw = _load_raw(path)
    return raw.get("params", {}), raw.get("batch_stats", {}) or {}, _meta(raw)


def _tree_leaves(tree) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves`` order: keys sorted
    at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def params_digest(params, batch_stats=None) -> str:
    """Content digest of a weight pair, the publish stream's identity: the
    first 16 hex digits of a sha256 over the leaves of the JAX-layout trees
    in ``jax.tree.leaves`` order, each leaf's ``str((shape, dtype))`` before
    its bytes, so a reshape cannot collide. The same string as the JAX
    package's ``params_digest`` for the same weights: a ``publish.json``
    that a JAX daemon wrote gates correctly here. Takes the JAX trees
    (numpy leaves) or the port's tensors by ``state_dict`` name (as an
    engine's ``weights()`` gives them), which go through the weight
    bridge's to-JAX direction first."""
    stats = batch_stats or {}
    if any(torch.is_tensor(v) for v in params.values()):
        table = table_of(params)
        params = _params_to_jax(params, table)
        stats = _nest({j: stats[n].detach().cpu().numpy() for n, j in table.stats if n in stats})
    h = hashlib.sha256()
    for tree in (params, stats):
        for leaf in _tree_leaves(tree):
            a = np.asarray(leaf)
            h.update(str((a.shape, str(a.dtype))).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]
