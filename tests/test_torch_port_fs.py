"""The FS task of the port against the JAX package: the config block,
``MSANNet`` (forward, per-site gradients), the weight bridge and the JAX
leaf order, the FreeSurfer site data with the native batch reader and its
fallback, the retry wrapper, the demo tree, and ICA's ``num_layers``.

Inputs come from numpy seeds; weights are JAX's, carried across as numpy.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import demo as jdemo
from dinunet_implementations_tpu.data import freesurfer as jfs
from dinunet_implementations_tpu.models import icalstm as jica
from dinunet_implementations_tpu.models import msannet as jmsan
from dinunet_implementations_tpu.robustness import retry as jretry
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch import native as tnative
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.data import freesurfer as tfs
from dinunet_implementations_tpu_torch.data import native_io as tnio
from dinunet_implementations_tpu_torch.engines import lowrank as tlowrank
from dinunet_implementations_tpu_torch.models import msannet as tmsan
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc
from dinunet_implementations_tpu_torch.robustness import retry as tretry
from dinunet_implementations_tpu_torch.runner import registry as treg
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    params_from_jax,
    table_of,
)

# a narrow MSANNet: 12 features, three hidden layers, two classes
IN, HIDDEN, OUT, B = 12, (16, 8, 6), 2, 7
# forward, f32 both sides: the products and the BatchNorm moments sum in
# another order (measured 1.07e-6 on logits up to 2.16 in magnitude, 5e-7
# of the largest)
FWD_TOL = dict(atol=1e-6, rtol=1e-6)
# per-site gradients against JAX's vmap(grad): measured 7.7e-7 of a
# leaf's max |gradient|
GRAD_SHARE = 1e-5


def _jax_msannet(seed=0, **kw):
    task = jsteps.FederatedTask(jmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN, out_size=OUT,
                                              **kw))
    params, stats = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, IN)))
    return task, jax.tree.map(np.asarray, params), stats


def _port_msannet(params, stats, **kw):
    model = tmsan.MSANNet(in_size=IN, hidden_sizes=HIDDEN, out_size=OUT, **kw)
    cfg = tconfig.TrainConfig(fs_args=tconfig.FSArgs(input_size=IN, hidden_sizes=HIDDEN))
    model.load_state_dict(params_from_jax(cfg, params, stats))
    return model


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# -- config --------------------------------------------------------------------


def test_fs_args_keep_the_jax_defaults_and_merge_as_jax_merges():
    jfa = jconfig.FSArgs()
    for f in dataclasses.fields(tconfig.FSArgs):
        assert getattr(tconfig.FSArgs(), f.name) == getattr(jfa, f.name), f.name
    assert {f.name for f in dataclasses.fields(tconfig.FSArgs)} == {
        f.name for f in dataclasses.fields(jconfig.FSArgs)}
    cfg = tconfig.TrainConfig()
    assert cfg.task_args() is cfg.fs_args
    over = {"hidden_sizes": [32, 16], "FS-Classification_args": {"dad_reduction_rank": 4},
            "labels_column": "dx", "bug_compatible_labels": True, "epochs": 7}
    got = tconfig.TrainConfig().with_overrides(over)
    want = jconfig.TrainConfig().with_overrides(over)
    for f in dataclasses.fields(tconfig.FSArgs):
        assert getattr(got.fs_args, f.name) == getattr(want.fs_args, f.name), f.name
    assert got.fs_args.hidden_sizes == (32, 16) and got.epochs == want.epochs == 7
    smri = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_SMRI_3D)
    assert smri.task_args() is smri.smri3d_args
    with pytest.raises(ValueError, match="Invalid task"):
        tconfig.TrainConfig(task_id="nope").task_args()


# -- MSANNet -------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_msannet_forward_matches_jax(train, masked):
    task, params, stats = _jax_msannet()
    assert stats == {}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1, 1], np.float32) if masked else None
    want, _ = task.apply(params, stats, jnp.asarray(x), train=train,
                         mask=None if mask is None else jnp.asarray(mask))
    model = _port_msannet(params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train,
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_msannet_init_is_seeded_and_shaped_as_jax():
    _, params, _ = _jax_msannet()
    cfg = tconfig.TrainConfig(fs_args=tconfig.FSArgs(input_size=IN, hidden_sizes=HIDDEN))
    a, b = (treg.build_model(cfg, device="cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    want = params_from_jax(cfg, params, {})
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert list(treg.build_model(cfg, device="cpu").buffers()) == []
    # torch's uniform ±1/sqrt(fan_in), a bias only on the head
    assert float(a["linear_0.weight"].abs().max()) <= 1 / np.sqrt(IN)
    assert "linear_0.bias" not in a and "fc_out.bias" in a


def test_site_forward_gradients_match_jax_vmap_grad():
    task, params, stats = _jax_msannet(seed=3)
    S = 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((S, B, IN)).astype(np.float32)
    y = rng.integers(0, OUT, (S, B)).astype(np.int32)
    w = (rng.random((S, B)) > 0.3).astype(np.float32)

    def loss(p, xs, ys, ws):
        logits, _ = task.apply(p, stats, xs, train=True, mask=ws)
        return jsteps.cross_entropy(logits, ys, ws)

    want = jax.tree.map(np.asarray, jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    model = _port_msannet(params, stats)
    leaves = {k: v.detach().unsqueeze(0).expand(S, *v.shape).requires_grad_()
              for k, v in model.named_parameters()}
    logits, new_stats = model.site_forward(leaves, torch.from_numpy(x), torch.from_numpy(w), {})
    assert new_stats == {}
    ce = tsteps.cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(w))
    grads = dict(zip(leaves, torch.autograd.grad(ce.sum(), list(leaves.values()))))
    table = tmsan.MSANNet.leaf_table(len(HIDDEN))
    flat = _flat(want)
    for name, path, transposed in table.params:
        g = grads[name].numpy()
        g = g.transpose(0, 2, 1) if transposed else g
        np.testing.assert_allclose(g, flat[path], rtol=0,
                                   atol=GRAD_SHARE * np.abs(flat[path]).max(), err_msg=name)


# -- the weight bridge ---------------------------------------------------------


def test_leaf_table_and_index_follow_jax_flatten():
    _, params, _ = _jax_msannet()
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    table = leaf_table(tconfig.TrainConfig(fs_args=tconfig.FSArgs(hidden_sizes=HIDDEN)))
    assert table == tmsan.MSANNet.leaf_table(3) == table_of(params)
    by_path = {j: n for n, j, _ in table.params}
    assert sorted(by_path) == sorted(paths)
    index = table.leaf_index
    assert {by_path[p]: i for i, p in enumerate(paths)} == index
    # bn_* sorts before fc_out, and fc_out before linear_*
    assert index["bn_0.bias"] == 0 and index["fc_out.bias"] < index["linear_0.weight"]
    assert table.transposed == {"linear_0.weight", "linear_1.weight", "linear_2.weight",
                                "fc_out.weight"}
    model = _port_msannet(params, {})
    assert table_of(dict(model.named_parameters())) == table
    # the ICA table by its config, by its JAX tree and by the port's names
    for bidirectional in (True, False):
        ica = tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_ICA,
                                  ica_args=tconfig.ICAArgs(bidirectional=bidirectional))
        jparams = jica.ICALstm(input_size=8, hidden_size=6, num_comps=3, window_size=2,
                               bidirectional=bidirectional).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 2, 3, 2)))["params"]
        port = treg.build_model(ica, device="cpu").state_dict()
        assert leaf_table(ica) == table_of(jparams) == table_of(port)
        assert leaf_table(ica).model == "ICALstm"
    with pytest.raises(ValueError, match="not the params of a ported model"):
        table_of({"head": {"kernel": np.zeros((2, 2), np.float32)}})


def test_fs_bridge_layouts_and_refusals():
    _, params, _ = _jax_msannet()
    cfg = tconfig.TrainConfig(fs_args=tconfig.FSArgs(input_size=IN, hidden_sizes=HIDDEN))
    sd = params_from_jax(cfg, params, {})
    np.testing.assert_array_equal(sd["linear_1.weight"].numpy(), params["linear_1"]["kernel"].T)
    np.testing.assert_array_equal(sd["bn_2.weight"].numpy(), params["bn_2"]["scale"])
    np.testing.assert_array_equal(sd["fc_out.bias"].numpy(), params["fc_out"]["bias"])
    assert all(v.is_contiguous() for v in sd.values())
    with pytest.raises(ValueError, match="MSANNet.*missing leaves.*linear_2/kernel"):
        params_from_jax(cfg, {k: v for k, v in params.items() if k != "linear_2"}, {})
    with pytest.raises(ValueError, match="MSANNet.*extra leaves.*cls_bn/mean"):
        params_from_jax(cfg, params, {"cls_bn": {"mean": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="not an SMRI3DNet variable tree"):
        params_from_jax(tconfig.TrainConfig(task_id=tconfig.NNComputation.TASK_SMRI_3D),
                        params, {})


def test_k7_routes_at_the_fs_shapes():
    """rankDAD over MSANNet at full width, 5 sites: the r = 10 class
    (``linear_0`` .. ``linear_3``, JAX matrices [66, 256] .. [64, 32]) and
    the r = 2 class (``fc_out``, [32, 2]), each one K7 launch a round. The
    engine hands K7 transposed views of the ``nn.Linear`` gradients, so A =
    Gᵀ; ``linear_0``'s A has rows of 66 values, not whole 16-byte chunks,
    which sends its class to the direct route; the r = 2 class is staged
    (an H100's 132 SMs and 232,448 bytes of opt-in shared memory)."""
    cfg = tconfig.TrainConfig()
    model = treg.build_model(cfg, device="cpu")
    tr = leaf_table(cfg).transposed
    classes: dict = {}
    for name, p in model.named_parameters():
        g = torch.zeros((5,) + tuple(p.shape))
        G = g.transpose(1, 2) if name in tr else g
        if tlowrank.is_compressible(G.shape[1:]):
            classes.setdefault(min(10, *G.shape[1:]), []).append(G)
    assert sorted(classes) == [2, 10]
    assert [tuple(G.shape) for G in classes[10]] == [(5, 66, 256), (5, 256, 128), (5, 128, 64),
                                                     (5, 64, 32)]
    assert [tuple(G.shape) for G in classes[2]] == [(5, 32, 2)]
    routes = {}
    for r, Gs in classes.items():
        assert pc.k7_takes([tuple(G.shape[-2:]) for G in Gs], r)
        g = pc.k7_geometry([tuple(G.shape) for G in Gs], r, all(pc._aligned(G) for G in Gs),
                           132, 232448, [pc._row_major(G) for G in Gs])
        routes[r] = g["route"]
        if r == 10:
            assert "16-byte chunks" in g["why"] and g["blocks"] == 20
    assert routes == {10: "direct", 2: "staged"}


# -- ICA num_layers ------------------------------------------------------------


def test_ica_num_layers_two_builds_one_layer_as_jax():
    """``num_layers`` is a parity field: JAX builds one BiLSTM layer
    whatever its value, and so does the port (forward within the ICA
    tolerance of tests/test_torch_port_icalstm.py)."""
    C, W, T, IN_, HID = 4, 5, 6, 16, 12
    a = dict(num_components=C, window_size=W, temporal_size=T * W, input_size=IN_,
             hidden_size=HID, num_layers=2)
    jcfg = jconfig.TrainConfig(task_id="ICA-Classification", ica_args=jconfig.ICAArgs(**a))
    tcfg = tconfig.TrainConfig(task_id="ICA-Classification", ica_args=tconfig.ICAArgs(**a))
    jmodel = jica.ICALstm(input_size=IN_, hidden_size=HID, num_comps=C, window_size=W,
                          num_layers=2, dropout_rate=0.0)
    task = jsteps.FederatedTask(jmodel)
    params, stats = task.init_variables(jax.random.PRNGKey(0), jnp.zeros((2, T, C, W)))
    assert jcfg.ica_args.num_layers == 2
    model = treg.build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                          jax.tree.map(np.asarray, stats)))
    x = np.random.default_rng(0).standard_normal((3, T, C, W)).astype(np.float32)
    want, _ = task.apply(params, stats, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- FreeSurfer data -----------------------------------------------------------


@pytest.fixture(scope="module")
def fs_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fs_tree"))
    return tdemo.make_fs_demo_tree(root, n_sites=2, subjects=12, seed=4)


def _site(root, i=0):
    return os.path.join(root, "input", f"local{i}", "simulatorRun")


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """The native library built under ``tmp_path`` and loaded afresh, so
    the test owns its build (a concurrent clean of ``build/`` cannot touch
    it) and the counters start at 0."""
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "_tried", False)
    tnio.reset_counts()
    yield tmp_path / "native"
    tnio.reset_counts()


def test_make_fs_demo_tree_writes_the_bytes_jax_writes(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jdemo.make_fs_demo_tree(a, n_sites=3, subjects=10, seed=7)
    tdemo.make_fs_demo_tree(b, n_sites=3, subjects=10, seed=7)

    def files(root):
        out = {}
        for d, _, fs in os.walk(root):
            for f in fs:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
        return out

    got, want = files(b), files(a)
    assert got == want and len(got) > 30
    c = str(tmp_path / "dispatch")
    tdemo.main([c, "--sites", "2", "--subjects", "6"])
    assert os.path.exists(os.path.join(c, "input", "local1", "simulatorRun",
                                       "site2_Covariate.csv"))
    with pytest.raises(ValueError, match="unknown demo task"):
        tdemo.make_demo_tree(c, "sMRI-3D-Classification")


@pytest.mark.parametrize("bug_compatible", [False, True])
def test_coerce_label_matches_jax(bug_compatible):
    for y in ("True", "false", " TRUE ", "1", "0", "2.0", 1, 0, True, False, np.int64(1)):
        assert tfs.coerce_label(y, bug_compatible) == jfs.coerce_label(y, bug_compatible), y


def test_read_aseg_stats_and_site_data_match_jax(fs_tree, private_build):
    d = _site(fs_tree, 1)
    for f in sorted(glob.glob(os.path.join(d, "*.txt")))[:5]:
        got, want = tfs.read_aseg_stats(f), jfs.read_aseg_stats(f)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    cfg = tconfig.resolve_site_configs(tconfig.TrainConfig(), fs_tree)[1]
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), fs_tree)[1]
    cache, jcache = treg.task_cache(cfg), dataclasses.asdict(jcfg.task_args())
    assert cache == jcache
    files = tfs.FSVDataHandle(cache=cache, state={"baseDirectory": d}).list_files()
    assert files == jfs.FSVDataHandle(cache=jcache, state={"baseDirectory": d}).list_files()
    ds = tfs.FreeSurferDataset(cache=cache, state={"baseDirectory": d})
    jds = jfs.FreeSurferDataset(cache=jcache, state={"baseDirectory": d})
    ds._load_indices(files)
    jds._load_indices(files)
    assert ds.indices == jds.indices
    got, want = ds.as_arrays(), jds.as_arrays()
    assert tnio.READS == {"native": 1, "python": 0}
    for k in ("inputs", "labels", "indices"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k
    item = ds[2]
    assert item["labels"] == jds[2]["labels"] and np.array_equal(item["inputs"], got.inputs[2])


def test_native_reader_is_bit_equal_to_the_python_reader(fs_tree, private_build):
    files = sorted(glob.glob(os.path.join(_site(fs_tree, 0), "*.txt")))
    want = np.stack([tfs.read_aseg_stats(f) for f in files])
    got = tnio.read_aseg_batch(files, want.shape[1])
    assert got is not None and got.dtype == np.float32 and got.tobytes() == want.tobytes()
    # the library was built under the private root, in a 0700 directory
    libs = list(private_build.glob("*/libfastio.so"))
    assert len(libs) == 1 and (libs[0].parent.stat().st_mode & 0o777) == 0o700
    assert tnio.READS["native"] == 1


def test_native_reader_falls_back_as_jax_does(tmp_path, fs_tree, private_build):
    """The cases of JAX's tests/test_native_io.py: a wrong feature count, a
    missing file, empty arguments, a malformed value and non-finite values
    each give None, and the dataset reads with the Python reader."""
    files = sorted(glob.glob(os.path.join(_site(fs_tree, 0), "*.txt")))
    assert tnio.read_aseg_batch(files[:3], 9999) is None
    assert tnio.read_aseg_batch(files[:2] + ["/nonexistent/nope.txt"], 66) is None
    assert tnio.read_aseg_batch([], 66) is None
    assert tnio.read_aseg_batch(files[:1], 0) is None
    ok = tmp_path / "ok.txt"
    ok.write_text("name\tvalue\n" + "".join(f"r{i}\t{i + 1}.5\n" for i in range(3)))
    assert tnio.read_aseg_batch([str(ok)], 3) is not None
    for n, text in enumerate(("a\t1.5abc\nb\t2.0\nc\t3.0\n", "\t1.5\nb\t2.0\nc\t3.0\n",
                              "a\t1.5\nb\tnan\nc\t3.0\n", "a\t1.5\nb\t-inf\nc\t3.0\n")):
        bad = tmp_path / f"bad{n}.txt"
        bad.write_text("name\tvalue\n" + text)
        assert tnio.read_aseg_batch([str(ok), str(bad)], 3) is None, text
    assert tnio.READS == {"native": 1, "python": 0}
    # a site whose file holds a NaN reads through the Python reader, as JAX's
    d = tmp_path / "site"
    d.mkdir()
    (d / "cov.csv").write_text("freesurferfile,isControl\na.txt,True\nb.txt,False\n")
    (d / "a.txt").write_text("name\tvalue\nx\t1.0\ny\t2.0\n")
    (d / "b.txt").write_text("name\tvalue\nx\tnan\ny\t2.0\n")
    cache = {"labels_file": "cov.csv", "labels_column": "isControl",
             "data_column": "freesurferfile"}
    got, want = (m.FreeSurferDataset(cache=cache, state={"baseDirectory": str(d)})
                 for m in (tfs, jfs))
    for ds in (got, want):
        ds._load_indices(["a.txt", "b.txt"])
    g, w = got.as_arrays(), want.as_arrays()
    assert g.inputs.tobytes() == w.inputs.tobytes() and np.isnan(g.inputs[1, 0])
    assert tnio.READS == {"native": 1, "python": 1}


def test_native_build_refuses_a_library_others_can_write(private_build, monkeypatch):
    assert tnative.build_and_load("fastio") is not None
    lib = next(private_build.glob("*/libfastio.so"))
    os.chmod(lib, 0o722)
    assert tnative.build_and_load("fastio") is None
    os.chmod(lib, 0o700)
    os.chmod(lib.parent, 0o777)
    assert tnative.build_and_load("fastio") is None
    os.chmod(lib.parent, 0o700)
    # no compiler: None, and the dataset falls back
    lib.unlink()
    monkeypatch.setattr(tnative.subprocess, "run", _no_gxx)
    assert tnative.build_and_load("fastio") is None
    # the port builds its own copy of the source
    assert tnative.SRC_DIR.parent.name == "dinunet_implementations_tpu_torch"
    assert (tnative.SRC_DIR / "fastio.cpp").is_file()


def _no_gxx(*a, **kw):
    raise FileNotFoundError("g++")


# -- the retry wrapper ---------------------------------------------------------


def _flaky(fail_times, exc=OSError):
    calls = []

    def f(x):
        calls.append(x)
        if len(calls) <= fail_times:
            raise exc("transient")
        return x * 2

    return f, calls


@pytest.mark.parametrize("fails", [0, 2, 3])
def test_with_retry_matches_jax(fails):
    out = []
    for mod in (jretry, tretry):
        f, calls = _flaky(fails)
        sleeps = []
        g = mod.with_retry(f, attempts=3, base_delay=0.1, max_delay=0.15, seed=5,
                           sleep=sleeps.append)
        try:
            res = g(4)
        except OSError as e:
            res = type(e).__name__
        out.append((res, len(calls), sleeps))
    assert out[0] == out[1]


def test_with_retry_deadline_and_timeout_match_jax():
    for mod in (jretry, tretry):
        t = [0.0]

        def clock():
            return t[0]

        def slow_fail():
            t[0] += 10.0
            raise OSError("down")

        sleeps = []
        g = mod.with_retry(slow_fail, attempts=5, deadline_s=15.0, sleep=sleeps.append,
                           clock=clock, seed=0)
        with pytest.raises(OSError):
            g()
        assert len(sleeps) == 1 and sleeps[0] <= 5.0  # the second failure is past 15 s

        def hang():
            import time

            time.sleep(0.5)

        h = mod.with_retry(hang, attempts=2, timeout_s=0.05, sleep=lambda s: None)
        with pytest.raises(mod.RetryTimeout):
            h()
        with pytest.raises(ValueError, match="attempts"):
            mod.with_retry(hang, attempts=0)


@pytest.mark.parametrize("retry_on_timeout", [True, False])
def test_with_retry_on_timeout_matches_jax(retry_on_timeout):
    """``retry_on_timeout=False``: the first timed-out attempt is fatal even
    under ``retry_on=(OSError,)`` (a ``RetryTimeout`` is an ``OSError``);
    ``True`` retries it. Both packages make the same attempts, sleep the
    same backoffs on the same fake clock and raise the same exception."""
    out = []
    for mod in (jretry, tretry):
        import threading

        calls, sleeps, release = [], [], threading.Event()

        def hangs():
            calls.append(1)
            release.wait(2.0)

        g = mod.with_retry(hangs, attempts=3, base_delay=0.1, seed=7, timeout_s=0.05,
                           retry_on=(OSError,), retry_on_timeout=retry_on_timeout,
                           sleep=sleeps.append, clock=lambda: 0.0)
        try:
            with pytest.raises(mod.RetryTimeout) as info:
                g()
        finally:
            release.set()
        out.append((len(calls), sleeps, type(info.value).__name__))
    assert out[0] == out[1]
    assert out[1][0] == (3 if retry_on_timeout else 1)
