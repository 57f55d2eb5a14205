"""The sMRI task of the port against the JAX package: the config block,
``SMRI3DNet`` (the SAME padding, the space-to-depth fold, forward in f32
and bf16, the masked BatchNorm, per-site gradients), the weight bridge,
the site data, epochs under dSGD, rankDAD and powerSGD, a ``FedRunner``
fit, checkpoints both ways, serving and the command line.

The model is narrow: 8³ volumes and channels (4, 8). Inputs come from
numpy seeds; weights are JAX's, carried across as numpy. Dropout is off
where the two are compared through training (the two frameworks draw
their masks from different generators).
"""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.data import smri as jsmri
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import cnn3d as jcnn
from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.serving import engine as jserving
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import smri as tsmri
from dinunet_implementations_tpu_torch.engines import lowrank as tlowrank
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import cnn3d as tcnn
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc
from dinunet_implementations_tpu_torch.runner import cli as tcli
from dinunet_implementations_tpu_torch.runner import fed_runner as trunner
from dinunet_implementations_tpu_torch.runner import registry as treg
from dinunet_implementations_tpu_torch.serving import engine as tserving
from dinunet_implementations_tpu_torch.trainer import checkpoint as tckpt
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    params_from_jax,
    table_of,
    train_state_from_jax,
    train_state_to_jax,
)

TASK = "sMRI-3D-Classification"
CH, VOL = (4, 8), (8, 8, 8)
# forward, f32 both sides: the convolutions and the BatchNorm moments sum
# in other orders (measured 1.8e-7 on logits up to 1.21)
FWD_TOL = dict(atol=1e-6, rtol=1e-6)
# bf16 convolutions: both round each convolution's output to bf16 (measured
# 6.0e-8 on logits up to 0.50, where bf16 moves JAX's logits by 1.85e-4
# from its f32 ones); the port is held to a twentieth of that move, so a
# port that ran only some of the convolutions in bf16 fails
BF16_ATOL = 1e-5
BF16_SHARE = 0.05
# per-site gradients against JAX's vmap(grad), a share of each leaf's max
# |gradient| (measured 5.3e-7)
GRAD_SHARE = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_net(seed=0, shape=VOL, **kw):
    kw = {"channels": CH, "num_cls": 2, "dropout_rate": 0.0, **kw}
    task = jsteps.FederatedTask(jcnn.SMRI3DNet(**kw))
    params, stats = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2,) + shape))
    return task, jax.tree.map(np.asarray, params), stats


def _cfg(**kw):
    return tconfig.TrainConfig(task_id=TASK, smri3d_args=tconfig.SMRI3DArgs(channels=CH, **kw))


def _port_net(params, stats, space_to_depth=False, **kw):
    model = tcnn.SMRI3DNet(channels=CH, num_cls=2, dropout_rate=0.0,
                           space_to_depth=space_to_depth, **kw)
    model.load_state_dict(params_from_jax(_cfg(space_to_depth=space_to_depth), params, stats))
    return model


# -- config --------------------------------------------------------------------


def test_smri_args_keep_the_jax_defaults_and_merge_as_jax_merges():
    for tcls, jcls in ((tconfig.SMRI3DArgs, jconfig.SMRI3DArgs),
                       (tconfig.MultimodalArgs, jconfig.MultimodalArgs)):
        assert {f.name for f in dataclasses.fields(tcls)} == {
            f.name for f in dataclasses.fields(jcls)}
        for f in dataclasses.fields(tcls):
            assert getattr(tcls(), f.name) == getattr(jcls(), f.name), f.name
    cfg = tconfig.TrainConfig(task_id=TASK)
    assert cfg.task_args() is cfg.smri3d_args
    assert cfg.smri3d_args.channels == (16, 32, 64, 128) and not cfg.smri3d_args.space_to_depth
    over = {"channels": [4, 8], "sMRI-3D-Classification_args": {"space_to_depth": True},
            "Multimodal-Classification_args": {"embed_dim": 64}, "volume_shape": [16, 16, 16],
            "dad_tol": 0.01, "epochs": 3}
    got = tconfig.TrainConfig(task_id=TASK).with_overrides(over)
    want = jconfig.TrainConfig(task_id=TASK).with_overrides(over)
    for block in ("smri3d_args", "multimodal_args", "fs_args"):
        assert dataclasses.asdict(getattr(got, block)) == dataclasses.asdict(
            getattr(want, block)), block
    assert got.smri3d_args.channels == (4, 8) and got.multimodal_args.embed_dim == 64
    with pytest.raises(ValueError, match="Invalid task"):
        tconfig.TrainConfig(task_id="nope").task_args()


# -- the model -----------------------------------------------------------------


def test_same_padding_is_not_padding_one():
    """flax's SAME at kernel 3, stride 2 on a side of 4 pads 0 before and 1
    after: a one-hot voxel at (2, 2, 2) under an all-ones kernel lands in
    8 output windows summing to 8, where ``padding=1`` gives 1. Odd sides
    pad 1 and 1. Held against flax's ``nn.Conv`` on both."""
    assert tcnn.same_pads(4) == (0, 1) and tcnn.same_pads(7) == (1, 1)
    assert tcnn.same_pads(32) == (0, 1) and tcnn.same_pads(1) == (1, 1)
    x = np.zeros((1, 4, 4, 4, 1), np.float32)
    x[0, 2, 2, 2, 0] = 1.0
    w = torch.ones(1, 3, 3, 3, 1, 1)
    got = tcnn.site_conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), w)
    assert float(got.sum()) == 8.0
    assert float(torch.nn.functional.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                            w[0].permute(4, 3, 0, 1, 2), stride=2,
                                            padding=1).sum()) == 1.0
    rng = np.random.default_rng(0)
    for shape in ((4, 4, 4), (7, 9, 6), (5, 5, 5)):
        x = rng.standard_normal((2,) + shape + (3,)).astype(np.float32)
        conv = fnn.Conv(5, kernel_size=(3, 3, 3), strides=(2, 2, 2), use_bias=False)
        v = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
        k = torch.from_numpy(np.asarray(v["params"]["kernel"]))
        got = tcnn.site_conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), k[None])
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-6,
                                   rtol=1e-6, err_msg=str(shape))


def test_space_to_depth_follows_jax_channel_order_and_checks():
    rng = np.random.default_rng(12)
    vols = rng.standard_normal((3, 8, 6, 4)).astype(np.float32)
    want = np.asarray(jcnn.space_to_depth_222(jnp.asarray(vols)[..., None]))
    got = tcnn.space_to_depth_222(torch.from_numpy(vols)[..., None]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsmri.space_to_depth_222_np(vols),
                                  jsmri.space_to_depth_222_np(vols))
    np.testing.assert_array_equal(tsmri.space_to_depth_222_np(vols[..., None]), want)
    for bad, match in ((vols[:, :7], "even spatial dims"),
                       (np.repeat(vols[..., None], 2, -1), "single-channel")):
        for mod in (tsmri, jsmri):
            with pytest.raises(ValueError, match=match):
                mod.space_to_depth_222_np(bad)
    # the model's own checks, as JAX's: odd sides or several channels raise,
    # an 8-channel input is taken as folded by the pipeline
    m = tcnn.SMRI3DNet(channels=(4,), space_to_depth=True)
    for shape in ((2, 7, 8, 8), (2, 8, 8, 8, 3)):
        with pytest.raises(ValueError, match="space_to_depth"):
            m(torch.ones(shape), train=False)
    assert m.conv_0.weight.shape == (3, 3, 3, 8, 4)
    assert tcnn.SMRI3DNet(channels=(4,)).conv_0.weight.shape == (3, 3, 3, 1, 4)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("fold", ["raw", "model", "pipeline"])
def test_smri3d_forward_matches_jax(fold, masked, train):
    """Dropout 0: the train forward differs from eval only in the mask of
    the statistics. ``model`` folds in the model, ``pipeline`` takes the
    folded volumes as the dataset gives them (JAX's model keeps its flag)."""
    s2d = fold != "raw"
    task, params, stats = _jax_net(space_to_depth=s2d)
    x = np.random.default_rng(1).standard_normal((5,) + VOL).astype(np.float32)
    if fold == "pipeline":
        x = jsmri.space_to_depth_222_np(x)
    mask = np.array([1, 0, 1, 1, 0], np.float32) if masked else None
    want, _ = task.apply(params, stats, jnp.asarray(x), train=train,
                         mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = _port_net(params, stats, s2d)(torch.from_numpy(x), train=train,
                                            mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_smri3d_bf16_forward_matches_jax():
    task, params, stats = _jax_net(shape=(16, 16, 16))
    jb = task.model.clone(compute_dtype="bfloat16")
    x = np.random.default_rng(22).standard_normal((2, 16, 16, 16)).astype(np.float32)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x), train=False))
    want_f32 = np.asarray(task.model.apply({"params": params}, jnp.asarray(x), train=False))
    model = _port_net(params, stats, compute_dtype="bfloat16")
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
        f32 = _port_net(params, stats)(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)
    bf16_move = float(np.abs(want - want_f32).max())
    assert float(np.abs(got.numpy() - want).max()) <= BF16_SHARE * bf16_move
    assert float((got - f32).abs().max()) > 1e-5  # the convolutions ran in bf16


def test_smri3d_masked_batchnorm_ignores_padding():
    """A padding row (weight 0, values 100) moves no BatchNorm statistic:
    the port's counterpart of JAX's test of the same name."""
    task, params, stats = _jax_net()
    model = _port_net(params, stats)
    x3 = torch.from_numpy(np.random.default_rng(2).standard_normal((3,) + VOL).astype(np.float32))
    x4 = torch.cat([x3, 100.0 * torch.ones((1,) + VOL)])
    with torch.no_grad():
        base = model(x3, train=True, mask=torch.ones(3))
        padded = model(x4, train=True, mask=torch.tensor([1.0, 1.0, 1.0, 0.0]))
        # the statistics do move without the mask
        unmasked = model(x4, train=True)
    np.testing.assert_allclose(padded[:3].numpy(), base.numpy(), atol=1e-5)
    assert float((unmasked[:3] - base).abs().max()) > 1e-2


def test_smri3d_init_is_seeded_and_shaped_as_jax():
    _, params, _ = _jax_net(space_to_depth=True)
    cfg = _cfg(space_to_depth=True)
    a, b = (treg.build_model(cfg, device="cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    want = params_from_jax(cfg, params, {})
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    # lecun-normal truncated at 2σ, σ from conv_0's fan-in 27·8
    w = a["conv_0.weight"]
    std = (1 / (27 * 8)) ** 0.5 / .87962566103423978
    assert float(w.abs().max()) <= 2 * std and 0.5 * std < float(w.std()) < 1.2 * std


def test_site_forward_gradients_match_jax_vmap_grad():
    task, params, stats = _jax_net(seed=3)
    S, B = 3, 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((S, B) + VOL).astype(np.float32)
    y = rng.integers(0, 2, (S, B)).astype(np.int32)
    w = np.array([[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 1, 1]], np.float32)

    def loss(p, xs, ys, ws):
        logits, _ = task.apply(p, stats, xs, train=True, mask=ws)
        return jsteps.cross_entropy(logits, ys, ws)

    want = _flat(jax.tree.map(np.asarray, jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))))
    model = _port_net(params, stats)
    leaves = {k: v.detach().unsqueeze(0).expand(S, *v.shape).requires_grad_()
              for k, v in model.named_parameters()}
    logits, new_stats = model.site_forward(leaves, torch.from_numpy(x), torch.from_numpy(w), {})
    assert new_stats == {}
    ce = tsteps.cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(w))
    grads = dict(zip(leaves, torch.autograd.grad(ce.sum(), list(leaves.values()))))
    for name, path, transposed in tcnn.SMRI3DNet.leaf_table(len(CH)).params:
        g = grads[name].numpy()
        g = g.transpose(0, 2, 1) if transposed else g
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=GRAD_SHARE * np.abs(want[path]).max(), err_msg=name)


# -- the weight bridge and the K7 routes -----------------------------------------


def test_leaf_table_follows_jax_flatten_and_tells_the_model():
    _, params, _ = _jax_net()
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    table = leaf_table(_cfg())
    assert table == tcnn.SMRI3DNet.leaf_table(2) == table_of(params)
    by_path = {j: n for n, j, _ in table.params}
    assert sorted(by_path) == sorted(paths)
    assert {by_path[p]: i for i, p in enumerate(paths)} == table.leaf_index
    assert table.transposed == {"head.weight"}
    assert table_of(_port_net(params, {}).state_dict()) == table
    assert leaf_table(tconfig.TrainConfig(task_id=TASK)) == tcnn.SMRI3DNet.leaf_table(4)
    with pytest.raises(ValueError, match="SMRI3DNet.*missing leaves.*conv_1/kernel"):
        params_from_jax(_cfg(), {k: v for k, v in params.items() if k != "conv_1"}, {})


def test_k7_routes_at_the_smri_shapes():
    """rankDAD over SMRI3DNet at full width (channels 16..128, the volumes
    folded by the pipeline), 8 sites: the r = 10 class holds the four
    kernels as JAX's matrices [216, 16], [432, 32], [864, 64] and [1728,
    128], row-major; its iterates and a ring of 3 stages exceed half an
    SM's shared memory, so K7 takes the direct route. The r = 2 class
    (``head``, [128, 2] through a transposed view) is staged. Without the
    fold conv_0's matrix is [27, 16], the same routes."""
    for s2d, m0 in ((True, 216), (False, 27)):
        cfg = tconfig.TrainConfig(task_id=TASK, agg_engine="rankDAD").with_overrides(
            {"space_to_depth": s2d})
        model = treg.build_model(cfg, device="cpu")
        tr = leaf_table(cfg).transposed
        classes: dict = {}
        for name, p in model.named_parameters():
            g = torch.zeros((8,) + tuple(p.shape))
            G = g.transpose(1, 2) if name in tr else g.reshape(8, -1, g.shape[-1])
            if tlowrank.is_compressible(G.shape[1:]):
                classes.setdefault(min(10, *G.shape[1:]), []).append(G)
        assert [tuple(G.shape[1:]) for G in classes[10]] == [(m0, 16), (432, 32), (864, 64),
                                                             (1728, 128)]
        assert [tuple(G.shape[1:]) for G in classes[2]] == [(128, 2)]
        routes = {}
        for r, Gs in classes.items():
            assert pc.k7_takes([tuple(G.shape[-2:]) for G in Gs], r)
            g = pc.k7_geometry([tuple(G.shape) for G in Gs], r,
                               all(pc._aligned(G) for G in Gs), 132, 232448,
                               [pc._row_major(G) for G in Gs])
            routes[r] = g["route"]
            if r == 10:
                assert "exceed half" in g["why"] and g["blocks"] == 32
        assert routes == {10: "direct", 2: "staged"}


# -- the site data -------------------------------------------------------------


def _make_smri_tree(root, n_sites=2, subjects=16, shape=VOL, seed=11, sizes=None):
    """Site trees of JAX's tests/test_extensions.py ``_make_smri_tree``
    (sites of ``sizes`` subjects when given)."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n_sites):
        n = subjects if sizes is None else sizes[i]
        d = os.path.join(root, "input", f"local{i}", "simulatorRun")
        os.makedirs(d)
        y = rng.integers(0, 2, n)
        X = rng.normal(size=(n,) + shape).astype(np.float32)
        X += (y[:, None, None, None] * 1.5).astype(np.float32)
        np.savez(os.path.join(d, "volumes.npz"), X)
        with open(os.path.join(d, "labels.csv"), "w") as fh:
            fh.write("index,label\n")
            for j in range(n):
                fh.write(f"{j},{int(y[j])}\n")
        spec.append({"data_file": {"value": "volumes.npz"}, "labels_file": {"value": "labels.csv"},
                     "channels": {"value": list(CH)}, "volume_shape": {"value": list(shape)}})
    with open(os.path.join(root, "inputspec.json"), "w") as fh:
        json.dump(spec, fh)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _make_smri_tree(str(tmp_path_factory.mktemp("smri_tree")), sizes=(20, 15))


@pytest.mark.parametrize("s2d", [False, True])
def test_smri_site_data_matches_jax(tree, s2d):
    d = os.path.join(tree, "input", "local1", "simulatorRun")
    over = {"space_to_depth": s2d}
    cfg = tconfig.resolve_site_configs(tconfig.TrainConfig(task_id=TASK), tree)[1]
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(task_id=TASK), tree)[1]
    cache = treg.task_cache(cfg.with_overrides(over))
    jcache = dataclasses.asdict(jcfg.with_overrides(over).task_args())
    assert cache == jcache
    files = tsmri.SMRIDataHandle(cache=cache, state={"baseDirectory": d}).list_files()
    assert files == jsmri.SMRIDataHandle(cache=jcache, state={"baseDirectory": d}).list_files()
    ds = tsmri.SMRIDataset(cache=cache, state={"baseDirectory": d})
    jds = jsmri.SMRIDataset(cache=jcache, state={"baseDirectory": d})
    ds._load_indices(files)
    jds._load_indices(files)
    got, want = ds.as_arrays(), jds.as_arrays()
    for k in ("inputs", "labels", "indices"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k
    assert got.inputs.shape[1:] == ((4, 4, 4, 8) if s2d else VOL)
    assert treg.get_task(TASK).serving.sample_shape(cfg.with_overrides(over)) == \
        jregistry.get_task(TASK).serving.sample_shape(jcfg.with_overrides(over))


# -- epochs --------------------------------------------------------------------

SIZES, B, LR, EPOCHS = (7, 10, 9), 4, 1e-3, 2
# rank 3 truncates both kernels' matrices ([27, 4] and [36, 8]); rank 10
# would factor them whole
DAD = dict(dad_reduction_rank=3, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)
TABLE = tcnn.SMRI3DNet.leaf_table(len(CH))
# the first round's aggregate (mu / (1 - b1) after one Adam step): dSGD sums
# in another order (measured 4.5e-8 absolute); rankDAD and powerSGD at a
# share of each leaf's max |aggregate| (measured 1.6e-5 rankDAD, 4.0e-6
# powerSGD, both on the head's full-rank r = 2 factor); the losses
# (measured 1.2e-7 dSGD, 6.0e-8 rankDAD, 0 powerSGD); params after two
# epochs (measured 7.1e-8, 3.4e-8, 3.0e-8)
AGG_TOL = dict(atol=1e-6, rtol=1e-4)
AGG_SHARE = {"rankDAD": 1e-3, "powerSGD": 1e-4}
LOSS_TOL = dict(atol=1e-5, rtol=0)
PARAM_ATOL = 1e-4


def _sites(seed=0):
    rng = np.random.default_rng(seed)
    return [jdata.SiteArrays(rng.standard_normal((n,) + VOL).astype(np.float32),
                             rng.integers(0, 2, n).astype(np.int32),
                             np.arange(n, dtype=np.int32)) for n in SIZES]


def _setups(engine_name):
    task = jsteps.FederatedTask(jcnn.SMRI3DNet(channels=CH, num_cls=2, dropout_rate=0.0))
    engine = make_engine(engine_name, precision_bits="32",
                         **(DAD if engine_name == "rankDAD" else {}),
                         **({"dad_reduction_rank": 3} if engine_name == "powerSGD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state_j = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                      jnp.zeros((2,) + VOL), num_sites=len(SIZES))
    epoch_j = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="device")
    if engine_name == "rankDAD":
        eng_t = make_rankdad(precision_bits="32", transposed=TABLE.transposed, **DAD)
    elif engine_name == "powerSGD":
        eng_t = make_powersgd(3, precision_bits="32", transposed=TABLE.transposed,
                              leaf_index=TABLE.leaf_index)
    else:
        eng_t = make_dsgd("32")
    epoch_t = tsteps.make_train_epoch_fn(
        tsteps.FederatedTask(tcnn.SMRI3DNet(channels=CH, num_cls=2, dropout_rate=0.0)), eng_t,
        tsteps.make_optimizer("adam", LR), device="cpu")
    return (state_j, epoch_j), (train_state_from_jax(jax.tree.map(np.asarray, state_j),
                                                     device="cpu"), epoch_t)


@pytest.mark.parametrize("engine_name", ["dSGD", "rankDAD", "powerSGD"])
def test_smri_epochs_match_jax(engine_name):
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plans = [jbatching.plan_epoch_positions(sites, B, seed=e, pad_mode="wrap").positions
             for e in range(EPOCHS)]
    (state_j, epoch_j), (state_t, epoch_t) = _setups(engine_name)
    one_j, _ = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                       jnp.asarray(plans[0][:, :1]))
    one_t, _ = epoch_t(state_t, inv.inputs, inv.labels, plans[0][:, :1])
    got = _flat(train_state_to_jax(one_t)["opt_state"]["mu"])
    want = _flat(jax.tree.map(np.asarray, one_j.opt_state[0].mu))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if engine_name == "dSGD":
            np.testing.assert_allclose(got[k] / 0.1, w / 0.1, err_msg=k, **AGG_TOL)
        else:
            np.testing.assert_allclose(got[k] / 0.1, w / 0.1, rtol=0, err_msg=k,
                                       atol=AGG_SHARE[engine_name] * np.abs(w / 0.1).max())
    end_j, end_t, loss_j, loss_t = state_j, state_t, [], []
    for idx in plans:
        end_j, lj = epoch_j(end_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                            jnp.asarray(idx))
        end_t, lt = epoch_t(end_t, inv.inputs, inv.labels, idx)
        loss_j.append(np.asarray(lj))
        loss_t.append(lt.numpy())
    np.testing.assert_allclose(np.concatenate(loss_t), np.concatenate(loss_j), **LOSS_TOL)
    got = _flat(train_state_to_jax(end_t)["params"])
    for k, w in _flat(jax.tree.map(np.asarray, end_j.params)).items():
        np.testing.assert_allclose(got[k], w, atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_smri_eval_takes_each_site_on_its_own_rows_as_jax():
    sites = _sites(seed=5)
    fb = jbatching.plan_eval(sites, B)
    (state_j, _), (state_t, _) = _setups("dSGD")
    task_j = jsteps.FederatedTask(jcnn.SMRI3DNet(channels=CH, num_cls=2, dropout_rate=0.0))
    task_j.has_batch_stats = False
    task_t = tsteps.FederatedTask(tcnn.SMRI3DNet(channels=CH, num_cls=2))
    assert not tsteps.eval_folds_sites(task_t.model)
    pj, lj, wj = (np.asarray(a) for a in jsteps.make_eval_fn(task_j)(
        state_j, jnp.asarray(fb.inputs), jnp.asarray(fb.labels), jnp.asarray(fb.weights)))
    pt, lt, wt = (a.numpy() for a in tsteps.make_eval_fn(task_t, device="cpu")(
        state_t, fb.inputs, fb.labels, fb.weights))
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(wt, wj)


# -- fits, checkpoints, serving and the command line ---------------------------

FIT_BATCH = 4
# a fit's epoch losses, validation loss, pooled and per-site test metrics
# (rounded to 5 decimals by the trainer), measured on this tree: dSGD and
# rankDAD (rank 10 factors these kernels whole) 0 / 6.0e-8 / 0 / 0,
# powerSGD 0 / 0 / 0 / 0
FIT_TOL = (dict(atol=1e-5, rtol=0), 1e-5, 1e-4, 1e-4)


@pytest.fixture
def no_dropout(monkeypatch):
    """Both registries build the model with dropout 0."""
    jspec, tspec = jregistry.TASKS[TASK], treg.TASKS[TASK]
    monkeypatch.setitem(jregistry.TASKS, TASK, dataclasses.replace(
        jspec, build_model=lambda cfg: jspec.build_model(cfg).clone(dropout_rate=0.0)))

    def build(cfg, generator=None, use_kernel=True):
        model = tspec.build_model(cfg, generator, use_kernel)
        model.dropout_rate = 0.0
        return model

    monkeypatch.setitem(treg.TASKS, TASK, dataclasses.replace(tspec, build_model=build))


@pytest.fixture(scope="module")
def start(tree, tmp_path_factory):
    """A JAX checkpoint of the tree's model: every fit here starts from its
    params."""
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(task_id=TASK), tree)[0]
    model = jregistry.get_task(TASK).build_model(cfg)
    state = jloop.FederatedTrainer(cfg, model, None).init_state(jnp.ones((2,) + VOL),
                                                                num_sites=2)
    path = str(tmp_path_factory.mktemp("start") / "start.msgpack")
    jckpt.save_checkpoint(path, state)
    return path


def _compare_fits(got, want):
    loss_tol, val_atol, metric_atol, site_atol = FIT_TOL
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], **loss_tol)
    assert got["best_val_epoch"] == want["best_val_epoch"]
    np.testing.assert_allclose(got["best_val_metric"], want["best_val_metric"], atol=val_atol,
                               rtol=0)
    np.testing.assert_allclose(got["test_metrics"], want["test_metrics"], atol=metric_atol, rtol=0)
    np.testing.assert_allclose(got["site_test_metrics"], want["site_test_metrics"],
                               atol=site_atol, rtol=0)


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD", "powerSGD"])
def test_smri_fedrunner_fit_matches_jax(tree, start, tmp_path, no_dropout, engine):
    kw = dict(agg_engine=engine, epochs=2, batch_size=FIT_BATCH, seed=2, monitor_metric="loss",
              pretrained_path=start)
    want = jrunner.FedRunner(jconfig.TrainConfig(task_id=TASK), data_path=tree,
                             out_dir=str(tmp_path / "j"), mesh=None, **kw).run(
        folds=[0], verbose=False)
    got = trunner.FedRunner(tconfig.TrainConfig(task_id=TASK), data_path=tree,
                            out_dir=str(tmp_path / "t"), device="cpu", **kw).run(
        folds=[0], verbose=False)
    _compare_fits(got[0], want[0])
    fold = tmp_path / "t" / "remote" / "simulatorRun" / TASK / "fold_0"
    for name in ("logs.json", "test_metrics.csv", "checkpoint_best.msgpack"):
        assert (fold / name).is_file(), name


@pytest.mark.parametrize("engine", ["rankDAD", "powerSGD"])
def test_smri_checkpoints_cross_both_ways(tree, tmp_path, engine):
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(task_id=TASK, agg_engine=engine),
                                       tree)[0]
    tr = jloop.FederatedTrainer(cfg, jregistry.get_task(TASK).build_model(cfg), None)
    state_j = tr.init_state(jnp.ones((2,) + VOL), num_sites=2)
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(path, state_j, meta={"fold": 0})
    like = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    got = tckpt.load_checkpoint(path, like)
    a, b = _flat(train_state_to_jax(got)), _flat(train_state_to_jax(like))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    out = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(out, got, meta={"fold": 0})
    back, meta = jckpt.load_checkpoint(out, state_j, with_meta=True)
    assert meta == {"fold": 0} and back.batch_stats == {}
    want = jax.tree.map(np.asarray, state_j)
    for part in ("params", "engine_state"):
        fw, fb = _flat(getattr(want, part)), _flat(jax.tree.map(np.asarray, getattr(back, part)))
        assert fw.keys() == fb.keys(), part
        for k in fw:
            if fw[k].dtype != object:
                np.testing.assert_array_equal(fb[k], fw[k], err_msg=f"{part} {k}")


def test_smri_serving_matches_jax_and_the_trainer_eval(tree, start):
    """One dispatch of three requests padded to a bucket of 8, the port's
    engine from a JAX checkpoint against JAX's engine and against the
    trainer's ``eval_forward`` on the same padded rows: the mask keeps the
    pad rows out of the BatchNorm moments."""
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(task_id=TASK), tree)[0]
    tcfg = tconfig.resolve_site_configs(tconfig.TrainConfig(task_id=TASK), tree)[0]
    rng = np.random.default_rng(6)
    reqs = [rng.standard_normal((n,) + VOL).astype(np.float32) for n in (2, 1, 3)]
    jeng = jserving.InferenceEngine(jcfg, checkpoint=start, row_buckets=(8,))
    teng = tserving.InferenceEngine(tcfg, checkpoint=start, row_buckets=(8,), device="cpu")
    try:
        jeng.warmup()
        teng.warmup()
        jr = [jserving._Req(r) for r in reqs]
        tr = [tserving._Req(r) for r in reqs]
        jeng._dispatch_infer(jr, 8)
        teng._dispatch_infer(tr, 8)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.future.result(timeout=30), b.future.result(timeout=30),
                                       atol=1e-6, rtol=1e-6)
        rows = np.zeros((8,) + VOL, np.float32)
        rows[:6] = np.concatenate(reqs)
        w = torch.tensor([1.0] * 6 + [0.0] * 2)
        want = tsteps.eval_forward(teng.task, torch.from_numpy(rows), None, w).numpy()
        np.testing.assert_array_equal(np.concatenate([r.future.result() for r in tr]), want[:6])
    finally:
        jeng.close()
        teng.close()


def test_smri_cli_matches_jax(tree, start, tmp_path, capsys, no_dropout):
    """Both command lines, ``--task sMRI-3D-Classification`` under rankDAD
    on the tree, fold 0: the same JSON line within the fit tolerance."""
    args = ["--data-path", tree, "--task", TASK, "--engine", "rankDAD", "--epochs", "2",
            "--folds", "0", "--batch-size", str(FIT_BATCH), "--quiet", "--set", "seed=2",
            "--set", f"pretrained_path={start}"]
    assert jcli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(got) == len(want) == 1 and list(got[0]) == list(want[0])
    assert got[0]["best_val_epoch"] == want[0]["best_val_epoch"]
    for k in ("test_loss", "test_auc"):
        np.testing.assert_allclose(got[0][k], want[0][k], atol=FIT_TOL[2], rtol=0)
