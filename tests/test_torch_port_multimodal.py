"""The multimodal FS+ICA task of the port against the JAX package:
``MultimodalNet`` (the packed input, attention, LayerNorm and GELU as flax
computes them, forward in f32 and bf16, per-site gradients), the weight
bridge, the site data and the demo tree, epochs under dSGD, rankDAD and
powerSGD, a ``FedRunner`` fit, checkpoints both ways, serving, the command
line, the K7 routes at full width and the refusals (ring attention, A11;
DP-SGD, A10).

The model is narrow: embed 32, 4 heads, 1 layer (the demo tree's
inputspec). Inputs come from numpy seeds; weights are JAX's, carried
across as numpy. Dropout is off where the two are compared through
training.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.core import config as jconfig
from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.data import demo as jdemo
from dinunet_implementations_tpu.data import multimodal as jmm
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import transformer as jtr
from dinunet_implementations_tpu.runner import cli as jcli
from dinunet_implementations_tpu.runner import fed_runner as jrunner
from dinunet_implementations_tpu.runner import registry as jregistry
from dinunet_implementations_tpu.serving import engine as jserving
from dinunet_implementations_tpu.trainer import checkpoint as jckpt
from dinunet_implementations_tpu.trainer import loop as jloop
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core import config as tconfig
from dinunet_implementations_tpu_torch.data import demo as tdemo
from dinunet_implementations_tpu_torch.data import multimodal as tmm
from dinunet_implementations_tpu_torch.engines import lowrank as tlowrank
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import layers as tlayers
from dinunet_implementations_tpu_torch.models import transformer as ttr
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

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

TASK = "Multimodal-Classification"
# the packed sample: 10 FS features, 3 windows of 4 components x 5 values
FS, C, W, NW = 10, 4, 5, 3
NARROW = dict(embed_dim=32, num_heads=4, num_layers=1, mlp_ratio=4, num_cls=2)
PACKED = FS + NW * C * W
# forward, f32 both sides: products, softmax and LayerNorms sum in other
# orders (measured 6.0e-7 on logits up to 1.52)
FWD_TOL = dict(atol=1e-6, rtol=1e-6)
# bf16 products with an f32 softmax and residual stream: the two round the
# same products to bf16, each a ulp (2**-8) of a value apart where a sum
# lands on a rounding boundary (measured 7.4e-3 on logits up to 1.08)
BF16_ATOL = 2e-2
# per-site gradients against JAX's vmap(grad), a share of each leaf's max
# |gradient| (measured 5.8e-7)
GRAD_SHARE = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_net(seed=0, **kw):
    kw = {"fs_input_size": FS, "num_comps": C, "window_size": W, "dropout_rate": 0.0,
          **NARROW, **kw}
    task = jsteps.FederatedTask(jtr.MultimodalNet(**kw))
    params, stats = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, PACKED)))
    return task, jax.tree.map(np.asarray, params), stats


def _cfg(**kw):
    a = dict(fs_input_size=FS, num_components=C, window_size=W, window_stride=W,
             temporal_size=NW * W, **{k: v for k, v in NARROW.items() if k != "num_cls"})
    return tconfig.TrainConfig(task_id=TASK, multimodal_args=tconfig.MultimodalArgs(**{**a, **kw}))


def _port_net(params, stats, **kw):
    model = treg.build_model(_cfg(**kw), device="cpu")
    model.dropout_rate = 0.0
    model.load_state_dict(params_from_jax(_cfg(**kw), params, stats))
    return model


def _x(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, PACKED)).astype(np.float32)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layers", [1, 2])
def test_multimodal_forward_matches_jax(layers, train):
    """Dropout 0: train and eval compute the same logits."""
    task, params, stats = _jax_net(num_layers=layers)
    x = _x(5)
    want, _ = task.apply(params, stats, jnp.asarray(x), train=train)
    model = _port_net(params, stats, num_layers=layers)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_multimodal_bf16_forward_matches_jax():
    task, params, stats = _jax_net(num_layers=2)
    jb = task.model.clone(compute_dtype="bfloat16")
    x = _x(3, seed=21)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x), train=False))
    model = _port_net(params, stats, num_layers=2, compute_dtype="bfloat16")
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
        f32 = _port_net(params, stats, num_layers=2)(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)
    assert float((got - f32).abs().max()) > 1e-4  # the products ran in bf16


def test_attention_layernorm_and_gelu_are_flax_s():
    """The pieces that differ from PyTorch's defaults, one by one: the
    attention of JAX's ``dot_product_attention`` (bf16 q, k, v: f32 logits
    and softmax, the output at v's dtype), flax's LayerNorm (ε 1e-6, E[x²] -
    E[x]²) and flax's tanh GELU."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 7, 4, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jtr.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = ttr.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    wb = jtr.dot_product_attention(qb, kb, vb)
    gb = ttr.dot_product_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert gb.dtype == torch.bfloat16 and wb.dtype == jnp.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(wb, np.float32), atol=2e-2)
    x = (rng.standard_normal((3, 5, 16)) * 3 + 2).astype(np.float32)
    ln = fnn.LayerNorm()
    lv = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod = tlayers.LayerNorm(16)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ln.apply(lv, jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    assert mod.eps == 1e-6
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(fnn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_multimodal_init_is_seeded_and_shaped_as_jax():
    _, params, _ = _jax_net()
    a, b = (treg.build_model(_cfg(), device="cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    want = params_from_jax(_cfg(), params, {})
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert a["pos_embed"].shape == (1, NW + 2, 32) and a["cls"].shape == (1, 1, 32)
    big = treg.build_model(tconfig.TrainConfig(task_id=TASK), device="cpu").state_dict()
    assert 0.015 < float(big["pos_embed"].std()) < 0.025  # normal(0.02)
    assert float(big["fs_embed.weight"].abs().max()) <= 1 / np.sqrt(66)


def test_site_forward_gradients_match_jax_vmap_grad():
    task, params, stats = _jax_net(seed=3, num_layers=2)
    S, B = 3, 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((S, B, PACKED)).astype(np.float32)
    y = rng.integers(0, 2, (S, B)).astype(np.int32)
    w = np.array([[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 1, 1]], np.float32)

    def loss(p, xs, ys, ws):
        logits, _ = task.apply(p, stats, xs, train=True, mask=ws)
        return jsteps.cross_entropy(logits, ys, ws)

    want = _flat(jax.tree.map(np.asarray, jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))))
    model = _port_net(params, stats, num_layers=2)
    leaves = {k: v.detach().unsqueeze(0).expand(S, *v.shape).requires_grad_()
              for k, v in model.named_parameters()}
    logits, new_stats = model.site_forward(leaves, torch.from_numpy(x), torch.from_numpy(w), {})
    assert new_stats == {}
    ce = tsteps.cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(w))
    grads = dict(zip(leaves, torch.autograd.grad(ce.sum(), list(leaves.values()))))
    for name, path, transposed in ttr.MultimodalNet.leaf_table(2).params:
        g = grads[name].numpy()
        g = g.transpose(0, 2, 1) if transposed else g
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=GRAD_SHARE * np.abs(want[path]).max(), err_msg=name)


# -- the weight bridge, the K7 routes and the refusals --------------------------


def test_leaf_table_follows_jax_flatten_and_tells_the_model():
    _, params, _ = _jax_net(num_layers=2)
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    table = leaf_table(_cfg(num_layers=2))
    assert table == ttr.MultimodalNet.leaf_table(2) == table_of(params)
    by_path = {j: n for n, j, _ in table.params}
    assert sorted(by_path) == sorted(paths)
    assert {by_path[p]: i for i, p in enumerate(paths)} == table.leaf_index
    assert "cls" not in table.transposed and "pos_embed" not in table.transposed
    assert "block_1.attn.qkv.weight" in table.transposed
    assert table_of(_port_net(*_jax_net()[1:]).state_dict()) == ttr.MultimodalNet.leaf_table(1)
    with pytest.raises(ValueError, match="MultimodalNet.*missing leaves.*ln_f/scale"):
        params_from_jax(_cfg(num_layers=2), {**params, "ln_f": {"bias": params["ln_f"]["bias"]}},
                        {})


def test_k7_routes_at_the_multimodal_shapes():
    """rankDAD over MultimodalNet at full width (embed 256, 4 blocks, 98
    windows), 64 sites: the r = 10 class holds 19 leaves of 7 shapes
    (``fs_embed`` [66, 256], ``ica_embed`` [1000, 256], ``pos_embed`` [100,
    256], each block's qkv, proj, mlp1 and mlp2), more than one launch of
    K7 takes (``k7_takes``), so ``k7_launches`` cuts it into a launch of 16
    buckets whose rows are whole 16-byte chunks (staged) and one of the
    other three with ``fs_embed``, whose rows of 66 values put it on the
    direct route; no class goes to the plain version. The r = 2 class
    (``head``, [256, 2] through a transposed view) is one staged launch.
    ``cls`` ([1, 256]) is not compressed."""
    cfg = tconfig.TrainConfig(task_id=TASK, agg_engine="rankDAD")
    model = treg.build_model(cfg, device="cpu")
    tr = leaf_table(cfg).transposed
    classes: dict = {}
    names: dict = {}
    dense = []
    for name, p in model.named_parameters():
        g = torch.zeros((64,) + tuple(p.shape))
        G = g.transpose(1, 2) if name in tr else g.reshape(64, -1, g.shape[-1])
        if tlowrank.is_compressible(G.shape[1:]):
            r = min(10, *G.shape[1:])
            classes.setdefault(r, []).append(G)
            names.setdefault(r, []).append(name)
        else:
            dense.append(name)
    assert "cls" in dense and "pos_embed" not in dense
    assert len(classes[10]) == 19 and len(classes[2]) == 1
    shapes = [tuple(G.shape[1:]) for G in classes[10]]
    assert {(66, 256), (1000, 256), (100, 256)} <= set(shapes) and len(set(shapes)) == 7
    assert not pc.k7_takes(shapes, 10) and len(classes[10]) > pc.MAX_BUCKETS
    launches = pc.k7_launches(classes[10], 10)
    assert sorted(k for ks in launches for k in ks) == list(range(19))
    assert [len(ks) for ks in launches] == [16, 3]
    assert names[10].index("fs_embed.weight") in launches[1]
    geo = [pc.k7_geometry([tuple(classes[10][k].shape) for k in ks], 10,
                          all(pc._aligned(classes[10][k]) for k in ks), 132, 232448,
                          [pc._row_major(classes[10][k]) for k in ks]) for ks in launches]
    assert [g["route"] for g in geo] == ["staged", "direct"] and geo[0]["blocks"] == 1024
    assert all(pc.k7_takes([shapes[k] for k in ks], 10) for ks in launches)
    Gs = classes[2]
    assert pc.k7_launches(Gs, 2) == [[0]]
    g = pc.k7_geometry([tuple(G.shape) for G in Gs], 2, all(pc._aligned(G) for G in Gs), 132,
                       232448, [pc._row_major(G) for G in Gs])
    assert g["route"] == "staged" and g["blocks"] == 64
    # no class goes to the plain version by shape; on the CPU both run it
    tlowrank.POWERITER_PLAIN_CLASSES = 0
    grads = {n: torch.randn((2,) + tuple(p.shape)) for n, p in model.named_parameters()}
    make_rankdad(transposed=tr).aggregate(grads, {"omega": {}}, torch.ones(2))
    assert tlowrank.POWERITER_PLAIN_CLASSES == 0


def test_ring_attention_and_dp_sgd_are_refused(tmp_path):
    """Ring attention (forced, or the registry's auto-ring under a model
    axis) names A11; a forced ring without a model axis is JAX's
    ValueError. DP-SGD (the BASELINE multimodal config's privacy) is no
    longer refused: a one-epoch DP fit reports its ε."""
    with pytest.raises(NotImplementedError, match="A11"):
        treg.build_model(tconfig.TrainConfig(task_id=TASK, model_axis_size=2), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        ttr.MultimodalNet(attention="ring")
    for reg, cfg in ((treg, tconfig.TrainConfig), (jregistry, jconfig.TrainConfig)):
        with pytest.raises(ValueError, match="needs model_axis_size >= 2"):
            reg.get_task(TASK).build_model(cfg(task_id=TASK).with_overrides({"attention": "ring"}))
    with pytest.raises(NotImplementedError, match="A11"):
        treg.build_model(tconfig.TrainConfig(task_id="ICA-Classification", model_axis_size=2),
                         device="cpu")
    with pytest.raises(ValueError, match="Invalid task"):
        treg.get_task("nope")
    tree = tdemo.make_multimodal_demo_tree(str(tmp_path / "tree"), n_sites=2, subjects=8)
    res = trunner.FedRunner(tconfig.TrainConfig(dp_clip=1.0, dp_noise_multiplier=1.0, epochs=1),
                            data_path=tree, device="cpu").run(folds=[0], verbose=False)
    assert res[0]["dp_epsilon"] > 0 and res[0]["dp_delta"] == 1e-5


# -- the site data and the demo tree ---------------------------------------------


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_make_multimodal_demo_tree_writes_the_bytes_jax_writes(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jdemo.make_multimodal_demo_tree(a, n_sites=3, subjects=7, seed=5)
    tdemo.make_multimodal_demo_tree(b, n_sites=3, subjects=7, seed=5)
    got = _files(b)
    assert got == _files(a) and len(got) > 20
    c, d = str(tmp_path / "jdispatch"), str(tmp_path / "tdispatch")
    jdemo.main([c, "--task", TASK, "--sites", "2", "--subjects", "4"])
    tdemo.main([d, "--task", "mm", "--sites", "2", "--subjects", "4"])
    assert _files(c) == _files(d)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdemo.make_multimodal_demo_tree(str(tmp_path_factory.mktemp("mm_tree")), n_sites=2,
                                           subjects=22, seed=3)


def test_multimodal_site_data_matches_jax(tree):
    d = os.path.join(tree, "input", "local1", "simulatorRun")
    cfg = tconfig.resolve_site_configs(tconfig.TrainConfig(), tree)[1]
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[1]
    assert cfg.task_id == jcfg.task_id == TASK  # the inputspec names the task
    cache, jcache = treg.task_cache(cfg), dataclasses.asdict(jcfg.task_args())
    assert cache == jcache
    files = tmm.MultimodalDataHandle(cache=cache, state={"baseDirectory": d}).list_files()
    assert files == jmm.MultimodalDataHandle(cache=jcache, state={"baseDirectory": d}).list_files()
    ds = tmm.MultimodalDataset(cache=cache, state={"baseDirectory": d})
    jds = jmm.MultimodalDataset(cache=jcache, state={"baseDirectory": d})
    ds._load_indices(files)
    jds._load_indices(files)
    assert ds.indices == jds.indices
    got, want = ds.as_arrays(), jds.as_arrays()
    for k in ("inputs", "labels", "indices"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k
    assert got.inputs.shape[1] == 16 + 4 * 8 * 10
    assert np.array_equal(ds[3]["inputs"], jds[3]["inputs"]) and ds[3]["labels"] == jds[3]["labels"]
    assert treg.get_task(TASK).serving.sample_shape(cfg) == \
        jregistry.get_task(TASK).serving.sample_shape(jcfg) == (16 + 4 * 8 * 10,)
    full = tconfig.TrainConfig(task_id=TASK)
    assert treg.get_task(TASK).serving.sample_shape(full) == (66 + 98 * 1000,)


# -- epochs --------------------------------------------------------------------

SIZES, B, LR, EPOCHS = (7, 10, 9), 4, 1e-3, 2
DAD = dict(dad_reduction_rank=10, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)
TABLE = ttr.MultimodalNet.leaf_table(1)
# the first round's aggregate (mu / (1 - b1) after one Adam step): dSGD sums
# in another order; rankDAD and powerSGD at a share of each leaf's max
# |aggregate|, per-site gradients of rank up to 20 (4 rows of 5 tokens)
# factored at r = 10 from one start (measured 5.4e-7 dSGD, 1.7e-4 rankDAD,
# 1.5e-5 powerSGD); the losses (measured 1.2e-7 but rankDAD's).
AGG_TOL = dict(atol=1e-6, rtol=1e-4)
AGG_SHARE = {"rankDAD": 1e-3, "powerSGD": 1e-4}
LOSS_TOL = dict(atol=1e-5, rtol=0)
# rankDAD's later losses follow params parted on the lr scale (below), as
# tests/test_torch_port_train.py's DAD_LOSS_ATOL holds them (measured
# 5.4e-5); its first loss is held to LOSS_TOL
DAD_LOSS_ATOL = 3e-3
# Params after the epochs. The key third of each qkv bias has a gradient
# that is zero up to rounding (a constant added to all of one query's
# logits leaves its softmax as it is), so it takes Adam steps of about lr
# of either sign: two correct trajectories part by up to 2·lr a round
# there (measured 8.6e-4 after 4 rounds), and everywhere under rankDAD,
# whose rank-10 factors of those gradients are unconverged after 5
# refinements (measured 2.0e-3, mlp1). Elsewhere under dSGD and powerSGD
# they agree to rounding.
PARAM_ATOL = 1e-4
KEY_BIAS = slice(NARROW["embed_dim"], 2 * NARROW["embed_dim"])


def _sites(seed=0):
    rng = np.random.default_rng(seed)
    return [jdata.SiteArrays(rng.standard_normal((n, PACKED)).astype(np.float32),
                             rng.integers(0, 2, n).astype(np.int32),
                             np.arange(n, dtype=np.int32)) for n in SIZES]


def _setups(engine_name):
    task = jsteps.FederatedTask(jtr.MultimodalNet(fs_input_size=FS, num_comps=C, window_size=W,
                                                  dropout_rate=0.0, **NARROW))
    engine = make_engine(engine_name, precision_bits="32",
                         **(DAD if engine_name == "rankDAD" else {}))
    opt = jsteps.make_optimizer("adam", LR)
    state_j = jsteps.init_train_state(task, engine, opt, jax.random.PRNGKey(0),
                                      jnp.zeros((2, PACKED)), num_sites=len(SIZES))
    epoch_j = jsteps.make_train_epoch_fn(task, engine, opt, mesh=None, pipeline="device")
    if engine_name == "rankDAD":
        eng_t = make_rankdad(precision_bits="32", transposed=TABLE.transposed, **DAD)
    elif engine_name == "powerSGD":
        eng_t = make_powersgd(precision_bits="32", transposed=TABLE.transposed,
                              leaf_index=TABLE.leaf_index)
    else:
        eng_t = make_dsgd("32")
    model = treg.build_model(_cfg(), device="cpu")
    model.dropout_rate = 0.0
    epoch_t = tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), eng_t,
                                         tsteps.make_optimizer("adam", LR), device="cpu")
    return (task, state_j, epoch_j), (model, train_state_from_jax(
        jax.tree.map(np.asarray, state_j), device="cpu"), epoch_t)


@pytest.mark.parametrize("engine_name", ["dSGD", "rankDAD", "powerSGD"])
def test_multimodal_epochs_match_jax(engine_name):
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plans = [jbatching.plan_epoch_positions(sites, B, seed=e, pad_mode="wrap").positions
             for e in range(EPOCHS)]
    (_, state_j, epoch_j), (_, state_t, epoch_t) = _setups(engine_name)
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
    loss_t, loss_j = np.concatenate(loss_t), np.concatenate(loss_j)
    np.testing.assert_allclose(loss_t[0], loss_j[0], **LOSS_TOL)
    if engine_name == "rankDAD":
        np.testing.assert_allclose(loss_t, loss_j, atol=DAD_LOSS_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(loss_t, loss_j, **LOSS_TOL)
    got = _flat(train_state_to_jax(end_t)["params"])
    lr_scale = 2 * LR * sum(idx.shape[1] for idx in plans)
    for k, w in _flat(jax.tree.map(np.asarray, end_j.params)).items():
        g = got[k].copy()
        if k.endswith("attn/qkv/bias"):
            np.testing.assert_allclose(g[KEY_BIAS], w[KEY_BIAS], atol=lr_scale, rtol=0, err_msg=k)
            g[KEY_BIAS] = w[KEY_BIAS]
        atol = lr_scale if engine_name == "rankDAD" else PARAM_ATOL
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


def test_multimodal_eval_folds_the_sites_into_one_forward():
    """No layer of the model mixes rows, so the eval of every site's rows
    in one forward is JAX's per-site eval."""
    sites = _sites(seed=5)
    fb = jbatching.plan_eval(sites, B)
    (task_j, state_j, _), (model, state_t, _) = _setups("dSGD")
    assert tsteps.eval_folds_sites(model)
    pj, lj, wj = (np.asarray(a) for a in jsteps.make_eval_fn(task_j)(
        state_j, jnp.asarray(fb.inputs), jnp.asarray(fb.labels), jnp.asarray(fb.weights)))
    pt, lt, wt = (a.numpy() for a in tsteps.make_eval_fn(tsteps.FederatedTask(model),
                                                         device="cpu")(
        state_t, fb.inputs, fb.labels, fb.weights))
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(wt, wj)


# -- fits, checkpoints, serving and the command line ---------------------------

FIT_BATCH = 4
# a fit's epoch losses, validation loss, pooled and per-site test metrics
# (rounded to 5 decimals by the trainer), measured on this tree: at most
# 6.0e-8 on the losses under dSGD, rankDAD (JAX's cold-start Ω) and
# powerSGD (JAX's first Q); the rounded metrics 1e-5 apart at most (a last
# digit)
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


def _jax_omega(G, r, device=None):
    """JAX's cold-start Ω for a leaf of this shape, handed across."""
    from dinunet_implementations_tpu.engines import lowrank as jlowrank

    m, n = (int(d) for d in tuple(getattr(G, "shape", G))[-2:])
    om = torch.from_numpy(np.array(jlowrank.default_omega(np.zeros((m, n)), r)))
    return om if device is None else om.to(device)


def _jax_q(seed, index, n, r, device=None):
    """JAX's first powerSGD Q of the leaf at ``index``, handed across."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    q = torch.from_numpy(np.array(jax.random.normal(key, (n, r), jnp.float32)))
    return q if device is None else q.to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    from dinunet_implementations_tpu_torch.engines import powersgd as tpowersgd
    from dinunet_implementations_tpu_torch.engines import rankdad as trankdad

    monkeypatch.setattr(trankdad, "default_omega", _jax_omega)
    monkeypatch.setattr(tpowersgd, "default_q", _jax_q)


@pytest.fixture(scope="module")
def start(tree, tmp_path_factory):
    """A JAX checkpoint of the tree's model: every fit here starts from its
    params."""
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    model = jregistry.get_task(TASK).build_model(cfg)
    state = jloop.FederatedTrainer(cfg, model, None).init_state(jnp.ones((2, 336)), num_sites=2)
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
def test_multimodal_fedrunner_fit_matches_jax(tree, start, tmp_path, no_dropout, jax_draws,
                                              engine):
    """``FedRunner(TrainConfig())`` over the demo tree, whose inputspec names
    the task and the narrow widths."""
    kw = dict(agg_engine=engine, epochs=2, batch_size=FIT_BATCH, seed=2, monitor_metric="loss",
              pretrained_path=start)
    want = jrunner.FedRunner(jconfig.TrainConfig(), data_path=tree, out_dir=str(tmp_path / "j"),
                             mesh=None, **kw).run(folds=[0], verbose=False)
    got = trunner.FedRunner(tconfig.TrainConfig(), data_path=tree, out_dir=str(tmp_path / "t"),
                            device="cpu", **kw).run(folds=[0], verbose=False)
    _compare_fits(got[0], want[0])
    fold = tmp_path / "t" / "remote" / "simulatorRun" / TASK / "fold_0"
    for name in ("logs.json", "test_metrics.csv", "checkpoint_best.msgpack"):
        assert (fold / name).is_file(), name


@pytest.mark.parametrize("engine", ["rankDAD", "powerSGD"])
def test_multimodal_checkpoints_cross_both_ways(tree, tmp_path, engine):
    cfg = jconfig.resolve_site_configs(jconfig.TrainConfig(agg_engine=engine), tree)[0]
    tr = jloop.FederatedTrainer(cfg, jregistry.get_task(TASK).build_model(cfg), None)
    state_j = tr.init_state(jnp.ones((2, 336)), num_sites=2)
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


def test_multimodal_serving_matches_jax_and_the_trainer_eval(tree, start):
    """One dispatch of three requests padded to a bucket of 8, the port's
    engine from a JAX checkpoint against JAX's engine; each answer is the
    trainer's ``eval_forward`` of its rows alone (no layer mixes rows)."""
    jcfg = jconfig.resolve_site_configs(jconfig.TrainConfig(), tree)[0]
    tcfg = tconfig.resolve_site_configs(tconfig.TrainConfig(), tree)[0]
    rng = np.random.default_rng(6)
    reqs = [rng.standard_normal((n, 336)).astype(np.float32) for n in (2, 1, 3)]
    jeng = jserving.InferenceEngine(jcfg, checkpoint=start, row_buckets=(8,))
    teng = tserving.InferenceEngine(tcfg, checkpoint=start, row_buckets=(8,), device="cpu")
    try:
        jeng.warmup()
        teng.warmup()
        jr = [jserving._Req(r) for r in reqs]
        tr = [tserving._Req(r) for r in reqs]
        jeng._dispatch_infer(jr, 8)
        teng._dispatch_infer(tr, 8)
        for a, b, r in zip(tr, jr, reqs):
            got = a.future.result(timeout=30)
            np.testing.assert_allclose(got, b.future.result(timeout=30), atol=1e-6, rtol=1e-6)
            alone = tsteps.eval_forward(teng.task, torch.from_numpy(r)).numpy()
            np.testing.assert_allclose(got, alone, atol=1e-6, rtol=0)
    finally:
        jeng.close()
        teng.close()


def test_multimodal_cli_matches_jax(tree, start, tmp_path, capsys, no_dropout, jax_draws):
    """Both command lines under powerSGD on the tree (its inputspec names
    the task), fold 0, then the port's ``--site 0``."""
    args = ["--data-path", tree, "--engine", "powerSGD", "--epochs", "2", "--folds", "0",
            "--batch-size", str(FIT_BATCH), "--quiet", "--set", "seed=2",
            "--set", f"pretrained_path={start}"]
    assert jcli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert tcli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(got) == len(want) == 1 and list(got[0]) == list(want[0])
    assert got[0]["best_val_epoch"] == want[0]["best_val_epoch"]
    for k in ("test_loss", "test_auc"):
        np.testing.assert_allclose(got[0][k], want[0][k], atol=FIT_TOL[2], rtol=0)
    site = ["--data-path", tree, "--task", TASK, "--site", "0", "--epochs", "1", "--quiet",
            "--device", "cpu", "--out-dir", str(tmp_path / "site")]
    assert tcli.main(site) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["test_loss"])


def test_cholqr_factors_in_float64_where_the_f32_chain_breaks_down():
    """The power iteration's CholeskyQR takes JAX's f32 chain for every
    member whose f32 Cholesky holds, bit for bit, and gives a member whose
    f32 Cholesky breaks down its Gram again, accumulated in float64 and
    rounded to f32 once: on the card cuBLAS's f32 Gram of a nearly
    rank-deficient iterate of 1024 rows was off by as much as the second
    round's shift and its Cholesky NaN (the full-width multimodal rankDAD
    epoch's ``mlp2`` leaves). Here the CPU's f32 Gram breaks down the same
    way at a smaller shift: two columns 7.4e-5 apart, shift 1e-8. The
    broken member is finite, equal bit for bit to the chain on the rounded
    float64 Gram, and within 5e-3 of JAX's ``_cholqr_once_multi`` (its last
    column is the two columns' difference over a shifted Gram of condition
    ~1e8, which carries the Grams' one-ulp difference: measured 1.3e-3)."""
    from dinunet_implementations_tpu.engines import lowrank as jl

    rng = np.random.default_rng(1)
    bad = rng.standard_normal((1024, 10)).astype(np.float32)
    eps = 10 ** rng.uniform(-4.5, -3)  # 7.4e-5
    bad[:, 9] = bad[:, 8] + eps * rng.standard_normal(1024).astype(np.float32)
    good = np.random.default_rng(2).standard_normal((1024, 10)).astype(np.float32)
    Y, shift = torch.from_numpy(np.stack([bad, good])), 1e-8
    Yn, _ = tlowrank._normalize_cols(Y)

    def chain(gram):
        gram = gram + (shift * gram.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-30)[..., None, None] \
            * torch.eye(10)
        chol, info = torch.linalg.cholesky_ex(gram)
        return Yn @ torch.linalg.solve_triangular(chol, torch.eye(10).expand_as(gram),
                                                  upper=False).mT, info

    f32, info32 = chain(Yn.mT @ Yn)
    f64, info64 = chain((Yn.double().mT @ Yn.double()).float())
    assert info32.tolist()[0] > 0 and info32.tolist()[1] == 0 and info64.tolist() == [0, 0]
    Q, _ = tlowrank._cholqr_once(Y, shift)
    assert bool(Q.isfinite().all())
    assert torch.equal(Q[0], f64[0]) and torch.equal(Q[1], f32[1])
    jq, _ = jl._cholqr_once_multi([jnp.asarray(bad), jnp.asarray(good)], shift)
    for k in range(2):
        np.testing.assert_allclose(Q[k].numpy(), np.asarray(jq[k]), atol=5e-3, rtol=0)


def test_cholqr_on_the_cards_broken_iterates_matches_jax():
    """Three iterates on which the plain power iteration's CholeskyQR broke
    down on the card (``scripts/torch_rankdad_probe.py``: the full-width
    multimodal rankDAD epoch, ``mlp2`` leaves [1024, 256], the second round
    at shift 1e-7), each with the shifted Gram cuBLAS formed for it there
    (its smallest eigenvalue -2.5e-7 .. -5e-10): that Gram's f32 Cholesky
    breaks down here too. JAX's round on the same iterates is finite,
    batched and alone (its Gram's smallest eigenvalue is 8.3e-7 ..
    1.1e-6). The port's CholeskyQR2 of them is finite, orthonormal within
    1e-3 and within 5e-4 of JAX's (measured 9.4e-5: their last columns
    span a subspace of condition ~1e7)."""
    from dinunet_implementations_tpu.engines import lowrank as jl

    z = np.load(os.path.join(os.path.dirname(__file__), "data", "cholqr_card_iterates.npz"))
    Y, card_gram, shift = z["Y"], z["gram"], float(z["shift"])
    assert (torch.linalg.cholesky_ex(torch.from_numpy(card_gram))[1] > 0).all()
    jq, _ = jl._cholqr_once_multi([jnp.asarray(y) for y in Y], shift)
    for k in range(len(Y)):
        alone, _ = jl._cholqr_once_multi([jnp.asarray(Y[k])], shift)
        assert np.isfinite(np.asarray(jq[k])).all() and np.isfinite(np.asarray(alone[0])).all()
    Q, _ = tlowrank._cholqr_multi(torch.from_numpy(Y))
    assert bool(Q.isfinite().all())
    np.testing.assert_allclose((Q.mT @ Q).numpy(), np.broadcast_to(np.eye(10), (len(Y), 10, 10)),
                               atol=1e-3, rtol=0)
    jq2, _ = jl._cholqr_multi([jnp.asarray(y) for y in Y])
    for k in range(len(Y)):
        np.testing.assert_allclose(Q[k].numpy(), np.asarray(jq2[k]), atol=5e-4, rtol=0)
