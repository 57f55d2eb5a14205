"""The port's checkpoints against the JAX package's, both ways: the stdlib
MessagePack codec (trainer/_msgpack.py) against flax's serializer, files
JAX writes read by the port and files the port writes restored by JAX's
``load_checkpoint``, the CRC frame and its ``.prev`` fallback, the
unframed legacy form, and ``InferenceEngine(checkpoint=...)``.

Every comparison here is exact: a checkpoint moves bits, it computes
nothing."""

import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import ICAArgs, NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.serving import InferenceEngine, ServingError
from dinunet_implementations_tpu_torch.trainer import _msgpack
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.weights import train_state_from_jax, train_state_to_jax

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dinunet_implementations_tpu_torch"
C, W, T, IN, HID, S = 4, 5, 6, 16, 12, 3


def _sorted(t):
    return {k: _sorted(t[k]) for k in sorted(t)} if isinstance(t, dict) else t


def _tree(rng):
    return _sorted({
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "zero_d": np.asarray(7, np.int32), "u32": np.array([0, 2 ** 32 - 1], np.uint32),
        "bool": np.array([True, False]), "f16": np.arange(5, dtype=np.float16),
        "i64": np.arange(-3, 3, dtype=np.int64), "empty": np.zeros((0, 4), np.float32),
        "none": None, "nested": {"b": {}, "a": {"x": None, "y": np.float32(2.5)}},
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129,
             -40000, -2 ** 31 - 1, -2 ** 63])},
        "float": 1.5, "neg_float": -2.25e300, "str": "x" * 31, "str32": "y" * 32,
        "long": "z" * 70000, "unicode": "Ω-site", "bin": b"\x00\xff" * 40000, "true": True,
        "false": False, "list": [1, "a", None], "many": {str(i): i for i in range(17)},
        "complex": 1 - 2j, "meta_json": '{"epoch": 3}',
    })


def _equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(b, np.generic):
        assert type(a) is type(b) and a == b, path
    else:
        assert type(a) is type(b) and a == b, path


def test_codec_writes_flax_bytes_and_reads_them_back():
    tree = _tree(np.random.default_rng(0))
    blob = fser.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == blob
    _equal(_msgpack.unpackb(blob), fser.msgpack_restore(blob))
    _equal(_msgpack.unpackb(_msgpack.packb(tree)), tree)


def test_codec_bfloat16_leaves_cross_as_raw_bits():
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    blob = fser.msgpack_serialize({"w": jx, "s": {"b": jnp.asarray(1.5, jnp.bfloat16)}})
    assert _msgpack.packb({"s": {"b": torch.tensor(1.5, dtype=torch.bfloat16)}, "w": x}) == blob
    back = _msgpack.unpackb(blob)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    assert back["s"]["b"].dtype == torch.bfloat16 and back["s"]["b"].shape == ()
    restored = fser.msgpack_restore(blob)
    assert np.asarray(restored["w"]).dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(restored["w"], np.float32), x.float().numpy())


def test_codec_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"a": {"v": np.arange(7, dtype=np.int32)},
            "w": np.arange(50, dtype=np.float32).reshape(5, 10)}
    blob = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert _msgpack.packb(tree) == blob
    back = _msgpack.unpackb(blob)
    _equal(back, tree)
    # a whole-tree array, and a bf16 one, also chunk and join
    whole = np.arange(40, dtype=np.float64)
    _equal(_msgpack.unpackb(_msgpack.packb(whole)), whole)
    bf = torch.arange(80, dtype=torch.float32).to(torch.bfloat16).reshape(8, 10)
    got = _msgpack.unpackb(_msgpack.packb({"bf": bf}))["bf"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf)


def test_codec_refuses_what_it_cannot_read():
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.unpackb(b"\xc1")
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.unpackb(_msgpack.packb({"a": 1})[:-1])
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.unpackb(_msgpack.packb(1) + b"\x00")
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.packb({"a": object()})


def _jax_state(engine_name="dSGD", opt_name="adam", seed=0, trained=True):
    task = jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))
    engine = make_engine(engine_name, precision_bits="32")
    opt = jsteps.make_optimizer(opt_name, 1e-3)
    state = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(seed),
                                    jnp.zeros((2, T, C, W)), num_sites=S)
    if trained:  # one epoch, so that every leaf holds a value of its own
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((S, 2, 4, T, C, W)).astype(np.float32)
        y = rng.integers(0, 2, (S, 2, 4)).astype(np.int32)
        epoch = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="host")
        state, _ = epoch(state, jnp.asarray(x), jnp.asarray(y), jnp.ones((S, 2, 4)))
        state = state.replace(health={**state.health,
                                      "skips": jnp.asarray([0, 2, 1], jnp.int32)})
    return state


def _port_like(state_j):
    """A port state of the same structure but other values (a template)."""
    like = train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=99, device="cpu")
    zero = lambda d: {k: None if v is None else torch.zeros_like(v) for k, v in d.items()}  # noqa
    like.params = zero(like.params)
    like.health = zero(like.health)
    if like.engine_state:
        like.engine_state = {"omega": zero(like.engine_state["omega"])}
    return like


def _assert_same(got, want):
    """Port training states equal leaf by leaf, bit for bit."""
    a, b = train_state_to_jax(got), train_state_to_jax(want)

    def walk(x, y, p=""):
        if isinstance(y, dict):
            assert x.keys() == y.keys(), p
            for k in y:
                walk(x[k], y[k], f"{p}/{k}")
        elif y is None:
            assert x is None, p
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), p
    walk(a, b)


@pytest.mark.parametrize("engine_name,opt_name", [("dSGD", "adam"), ("rankDAD", "adam"),
                                                  ("dSGD", "sgd")])
def test_a_checkpoint_jax_wrote_restores_in_the_port(tmp_path, engine_name, opt_name):
    state_j = _jax_state(engine_name, opt_name, seed=5)
    path = str(tmp_path / "ckpt.msgpack")
    meta = {"epoch": 3, "best_val_metric": 0.75, "epoch_losses": [0.7, 0.6]}
    jckpt.save_checkpoint(path, state_j, meta=meta)
    got, got_meta = tckpt.load_checkpoint(path, _port_like(state_j), with_meta=True)
    _assert_same(got, train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=5,
                                           device="cpu"))
    assert got.rng == 5 and got.round == int(state_j.round) == 2
    assert got_meta == meta == tckpt.load_meta(path)
    params, stats, meta2 = tckpt.load_inference_state(path)
    assert meta2 == meta
    np.testing.assert_array_equal(params["encoder"]["kernel"],
                                  np.asarray(state_j.params["encoder"]["kernel"]))
    warm = tckpt.load_params(path, _port_like(state_j).params)
    for k, v in warm.items():
        assert torch.equal(v, got.params[k]), k


@pytest.mark.parametrize("engine_name,opt_name", [("dSGD", "adam"), ("rankDAD", "adam"),
                                                  ("dSGD", "sgd")])
def test_a_checkpoint_the_port_wrote_restores_in_jax(tmp_path, engine_name, opt_name):
    state_j = _jax_state(engine_name, opt_name, seed=3)
    port = train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=3, device="cpu")
    path = str(tmp_path / "ckpt.msgpack")
    meta = {"epoch": 2, "best_val_epoch": 1}
    tckpt.save_checkpoint(path, port, meta=meta, rotate=True)
    like = _jax_state(engine_name, opt_name, seed=11, trained=False)
    got, got_meta = jckpt.load_checkpoint(path, like, with_meta=True)
    assert got_meta == meta
    want = jax.tree.map(np.asarray, state_j)
    got = jax.tree.map(np.asarray, got)
    for what in ("params", "batch_stats", "opt_state", "engine_state", "health"):
        wl, gl = jax.tree.leaves(getattr(want, what)), jax.tree.leaves(getattr(got, what))
        assert jax.tree.structure(getattr(want, what)) == jax.tree.structure(getattr(got, what))
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), what
    np.testing.assert_array_equal(got.rng, np.asarray(jax.random.PRNGKey(3)))
    assert int(got.round) == int(state_j.round)
    # JAX's template-free readers take the port's file too
    p, s, m = jckpt.load_inference_state(path)
    assert m == meta and set(p) == set(state_j.params)
    assert jckpt.load_meta(path) == meta


def test_prev_fallback_on_a_missing_torn_or_corrupt_primary(tmp_path):
    state_j = _jax_state(seed=1)
    first = train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=1, device="cpu")
    second = train_state_from_jax(jax.tree.map(np.asarray, _jax_state(seed=2)), rng=2,
                                  device="cpu")
    path = str(tmp_path / "latest.msgpack")
    tckpt.save_checkpoint(path, first, meta={"epoch": 1}, rotate=True)
    tckpt.save_checkpoint(path, second, meta={"epoch": 2}, rotate=True)
    assert os.path.exists(path + ".prev")
    _assert_same(tckpt.load_checkpoint(path, _port_like(state_j)), second)
    with open(path, "rb") as fh:
        good = fh.read()
    for name, bad in (("torn", good[: len(good) // 2]), ("short frame", good[:9]),
                      ("crc", good[:-1] + bytes([good[-1] ^ 1]))):
        with open(path, "wb") as fh:
            fh.write(bad)
        with pytest.warns(UserWarning, match="falling back"):
            got, meta = tckpt.load_checkpoint(path, _port_like(state_j), with_meta=True)
        _assert_same(got, first)
        assert meta == {"epoch": 1}, name
        with pytest.raises(tckpt.CorruptCheckpointError):
            tckpt.load_checkpoint(path, _port_like(state_j), fallback=False)
        # JAX falls back the same way on the port's files
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert jckpt.load_meta(path) == {"epoch": 1}
    os.remove(path)
    with pytest.warns(UserWarning, match="falling back"):
        _assert_same(tckpt.load_checkpoint(path, _port_like(state_j)), first)
    os.remove(path + ".prev")
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(path, _port_like(state_j))


def test_an_unframed_legacy_file_loads(tmp_path):
    state_j = _jax_state(seed=4)
    path = str(tmp_path / "legacy.msgpack")
    payload = {"params": state_j.params, "batch_stats": state_j.batch_stats,
               "opt_state": state_j.opt_state, "engine_state": state_j.engine_state,
               "rng": state_j.rng, "round": state_j.round}  # no health, no meta
    with open(path, "wb") as fh:
        fh.write(fser.to_bytes(payload))
    like = _port_like(state_j)
    got, meta = tckpt.load_checkpoint(path, like, with_meta=True)
    assert meta == {}
    want = train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=4, device="cpu")
    want.health = like.health  # absent: the template's counters
    _assert_same(got, want)


def test_a_mismatched_engine_state_restores_fresh_and_params_must_match(tmp_path):
    dad = _jax_state("rankDAD", seed=6)
    path = str(tmp_path / "dad.msgpack")
    jckpt.save_checkpoint(path, dad)
    dsgd_like = _port_like(_jax_state("dSGD", seed=6, trained=False))
    with pytest.warns(UserWarning, match="engine state"):
        got = tckpt.load_checkpoint(path, dsgd_like)
    assert got.engine_state == {}
    # a 2-site template: the 3-site health counters do not fit
    two = train_state_from_jax(jax.tree.map(np.asarray, dad), rng=6, device="cpu")
    two.health = {k: v[:2] for k, v in two.health.items()}
    two.engine_state = {"omega": {k: None if v is None else v[:2]
                                  for k, v in two.engine_state["omega"].items()}}
    with pytest.warns(UserWarning):
        got = tckpt.load_checkpoint(path, two)
    assert tuple(got.health["skips"].shape) == (2,)
    wide = _port_like(dad)
    wide.params = {k: torch.zeros(tuple(v.shape[:-1]) + (v.shape[-1] + 1,))
                   for k, v in wide.params.items()}
    with pytest.raises(ValueError, match="params"):
        tckpt.load_checkpoint(path, wide)


def _ica_cfg():
    return TrainConfig(task_id=NNComputation.TASK_ICA, ica_args=ICAArgs(
        input_size=IN, hidden_size=HID, num_components=C, window_size=W, temporal_size=T * W))


def test_inference_engine_serves_a_port_checkpoint(tmp_path):
    state_j = _jax_state(seed=8)
    port = train_state_from_jax(jax.tree.map(np.asarray, state_j), rng=8, device="cpu")
    path = str(tmp_path / "checkpoint_best.msgpack")
    tckpt.save_checkpoint(path, port, meta={"best_val_epoch": 4})
    cfg = _ica_cfg()
    rows = np.random.default_rng(2).standard_normal((5, T, C, W)).astype(np.float32)
    p, s = jax.tree.map(np.asarray, state_j.params), jax.tree.map(np.asarray,
                                                                   state_j.batch_stats)
    answers = {}
    for name, kw in (("checkpoint", {"checkpoint": path}),
                     ("params", {"params": p, "batch_stats": s})):
        with InferenceEngine(cfg, device="cpu", row_buckets=(1, 4, 8), **kw) as eng:
            eng.warmup()
            answers[name] = eng.submit(rows).result(timeout=60)
            if name == "checkpoint":
                assert eng.meta == {"best_val_epoch": 4}
    assert answers["checkpoint"].shape == (5, 2)
    np.testing.assert_array_equal(answers["checkpoint"], answers["params"])
    with pytest.raises(ServingError, match="either"):
        InferenceEngine(cfg, device="cpu", checkpoint=path, params=p, batch_stats=s)
    with pytest.raises(ServingError, match="either"):
        InferenceEngine(cfg, device="cpu")


def test_the_port_imports_neither_flax_nor_msgpack():
    for p in PORT.rglob("*.py"):
        for mod in re.findall(r"^\s*(?:import|from)\s+([\w.]+)", p.read_text(), re.M):
            assert mod.split(".")[0] not in ("msgpack", "flax"), (p, mod)
    code = ("import sys\n"
            "import dinunet_implementations_tpu_torch.trainer.checkpoint\n"
            "import dinunet_implementations_tpu_torch.serving\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('msgpack', 'flax', 'jax')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
