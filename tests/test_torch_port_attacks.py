"""The port's hostile-site slice against the JAX package: ``AttackPlan``
(JSON both ways, validation, code masks across window chunkings), each
attack family of ``make_attack_fn`` with JAX's noise and collusion draws
handed across, the robust reducers and the norm clip on ties, dead sites
and an all-dead coordinate, every engine under every ``robust_agg`` on
JAX's per-site gradients of a small MSANNet (its ``nn.Linear`` weights
stored transposed, its JAX leaf order not the port's), powerSGD epochs of
that MSANNet and a rankDAD epoch of a small ICA-LSTM under a fault plan
and an attack plan, and the reputation quarantine of a persistent
attacker.

The JAX side runs its Pallas LSTM kernels in interpret mode and rankDAD's
power iteration as its plain loop. Inputs are made with numpy from a seed.
Each tolerance is stated beside its test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel import collectives as jcoll
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.robustness import attacks as jattacks
from dinunet_implementations_tpu.robustness import faults as jfaults
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.core.config import FSArgs, NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models import msannet as tmsan
from dinunet_implementations_tpu_torch.parallel import collectives as tcoll
from dinunet_implementations_tpu_torch.robustness import attacks as tattacks
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    params_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)

# the small ICA-LSTM of tests/test_torch_port_train.py, 5 sites of unequal
# size, batch 4
C, W, T, IN, HID, B = 4, 5, 6, 16, 12, 4
ICA = TrainConfig(task_id=NNComputation.TASK_ICA)
SIZES = (9, 17, 13, 12, 10)
S = len(SIZES)
# a small MSANNet: 12 features, three hidden layers, two classes; its
# factorized leaves fall into two rank classes (10 and the head's 2)
FS_IN, FS_HIDDEN = 12, (16, 12, 12)
FS = TrainConfig(fs_args=FSArgs(input_size=FS_IN, hidden_sizes=FS_HIDDEN))
FS_TABLE = leaf_table(FS)
LR = 1e-3
DAD = dict(dad_reduction_rank=10, dad_num_pow_iters=5, dad_tol=1e-3, dad_warm_start=True)
MODES = ("norm_clip", "trimmed_mean", "coordinate_median")
# every family on its own site, each over its own window
PLAN = jattacks.AttackPlan(sign_flip=((1, 0, -1),), scale=((2, 0, 1),), scale_factor=10.0,
                           noise=((3, 1, 2),), noise_std=0.05, noise_seed=7,
                           free_rider=((4, 2, -1),), collude=((0, 3, -1), (3, 3, -1)),
                           collude_seed=3, collude_scale=5.0)
# the deterministic families only: the epochs against JAX
DET_PLAN = jattacks.AttackPlan(sign_flip=((1, 0, -1),), scale=((2, 1, 2),), scale_factor=10.0,
                               free_rider=((4, 0, 1),))
# a drop, a straggler and one NaN round
FAULTS = jfaults.FaultPlan(drop=((0, 1, 1),), delay_at=((3, 2, 1),), nan_at=((0, 2),))


def _tplan(plan):
    return tattacks.AttackPlan.from_json(plan.to_json())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# -- AttackPlan ----------------------------------------------------------------


def test_attack_plan_json_both_ways_and_validation(tmp_path):
    port = _tplan(PLAN)
    assert port.to_json() == PLAN.to_json()
    assert jattacks.AttackPlan.from_json(port.to_json()) == PLAN
    assert tattacks.AttackPlan.from_json(json.dumps(PLAN.to_json())) == port
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(PLAN.to_json()))
    for arg in (f"@{p}", str(p), json.dumps(PLAN.to_json())):
        assert tattacks.parse_attack_plan(arg) == port
    assert tattacks.parse_attack_plan(None) is None and tattacks.parse_attack_plan("") is None
    assert port.attacker_sites() == PLAN.attacker_sites() == (0, 1, 2, 3, 4)
    for bad, match in (({"sign_flip": ((1, 2),)}, "triples"),
                       ({"scale": ((-1, 0, 2),)}, "bad AttackPlan"),
                       ({"noise": ((0, 5, 2),)}, "bad AttackPlan"),
                       ({"noise_std": -1.0}, "noise_std"),
                       ({"sign_flip": ((1, 0, 10),), "scale": ((1, 5, -1),)}, "overlap")):
        for mod in (tattacks, jattacks):
            with pytest.raises(ValueError, match=match):
                mod.AttackPlan(**bad)
    for mod in (tattacks, jattacks):
        with pytest.raises(ValueError, match="unknown AttackPlan keys"):
            mod.AttackPlan.from_json({"sign_flop": []})


@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
def test_attack_codes_equal_jax_across_window_chunkings(chunk):
    """Bit for bit JAX's ``[S, rounds]`` codes for any window split."""
    port, rounds = _tplan(PLAN), 8
    want = PLAN.codes(6, 0, rounds)
    got = np.concatenate([tattacks.attack_window(port, 6, r0, min(chunk, rounds - r0))
                          for r0 in range(0, rounds, chunk)], axis=1)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tattacks.attack_window(port, 6, 3, 4),
                                  jattacks.attack_window(PLAN, 6, 3, 4))
    assert tattacks.attack_window(tattacks.AttackPlan(), 6, 0, 4) is None
    assert tattacks.attack_window(None, 6, 0, 4) is None


# -- the transform -------------------------------------------------------------


def _jax_msannet(seed=0):
    task = jsteps.FederatedTask(JMSANNet(in_size=FS_IN, hidden_sizes=FS_HIDDEN, out_size=2))
    params, _ = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, FS_IN)))
    return task, params


def _to_port(tree, sites, cfg=FS):
    """A JAX params-shaped tree of ``[S, ...]`` leaves as the port's dict."""
    per = [params_from_jax(cfg, jax.tree.map(lambda a, s=s: np.asarray(a[s]), tree), {})
           for s in range(sites)]
    names = [n for n, _, _ in leaf_table(cfg).params]
    return {k: torch.stack([p[k] for p in per]) for k in names}


def _jax_draw(kind, key, shape, device):
    """JAX's own draws for the port's transform: ``make_attack_fn``'s keys."""
    if kind == "noise":
        seed, site, rnd, i = key
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), site), rnd)
    else:
        seed, rnd, i = key
        k = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    d = jax.random.normal(jax.random.fold_in(k, i), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(d)).to(device)


_JAX_FNS: dict = {}  # jitted JAX functions shared by the cases of a test


@pytest.mark.parametrize("rnd", [0, 1, 3])
def test_each_attack_family_matches_jax(rnd):
    """Each site of a 6-site round under its family (site 5 honest), the
    port's transform with JAX's draws against JAX's ``make_attack_fn`` under
    ``vmap``. Sign-flip, scale and free-rider are one f32 product on the
    same operands: bit for bit. Noise adds ``noise_std · ε`` to JAX's ε,
    which XLA fuses into one multiply-add: within 2 ulps of the leaf's
    largest value (2.4e-7 of it). Collusion scales the shared direction by
    ‖g‖ / ‖d‖, sums of squares in another order: 4 ulps (rtol 5e-7;
    measured 2.7e-7)."""
    _, params = _jax_msannet()
    rng = np.random.default_rng(rnd)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal((6,) + p.shape).astype(np.float32)), params)
    codes = PLAN.codes(6, rnd, 1)[:, 0]
    if "attack" not in _JAX_FNS:
        _JAX_FNS["attack"] = jax.jit(jax.vmap(jattacks.make_attack_fn(PLAN),
                                              in_axes=(0, 0, None, 0)))
    want = _JAX_FNS["attack"](grads, jnp.asarray(codes), jnp.int32(rnd),
                              jnp.arange(6, dtype=jnp.int32))
    port = tattacks.make_attack_fn(_tplan(PLAN), FS_TABLE, draw=_jax_draw)
    got = port(_to_port(grads, 6), codes, torch.as_tensor(codes), rnd)
    want_t = _to_port(want, 6)
    exact = np.isin(codes, (tattacks.ATTACK_NONE, tattacks.ATTACK_SIGN_FLIP,
                            tattacks.ATTACK_SCALE, tattacks.ATTACK_FREE_RIDER))
    noisy = codes == tattacks.ATTACK_NOISE
    for k, w in want_t.items():
        g, w = got[k].numpy(), w.numpy()
        np.testing.assert_array_equal(g[exact], w[exact], err_msg=k)
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0,
                                   atol=2.4e-7 * np.abs(w[noisy]).max(initial=0.0), err_msg=k)
        np.testing.assert_allclose(g[~exact & ~noisy], w[~exact & ~noisy], rtol=5e-7, atol=0,
                                   err_msg=k)
    assert noisy.any() == (rnd in (1, 2)) and (codes == tattacks.ATTACK_COLLUDE).any() == (rnd == 3)


def test_default_draws_replay_by_site_round_and_leaf():
    """The port's own draws are a function of (seed, site, round, leaf):
    the same cell draws the same numbers whatever the call, another site,
    round or leaf other ones; the transform of a noise site changes only
    that site."""
    assert tattacks.draw_seed("noise", (7, 3, 1, 2)) == tattacks.draw_seed("noise", (7, 3, 1, 2))
    seeds = {tattacks.draw_seed("noise", k) for k in
             ((7, 3, 1, 2), (7, 4, 1, 2), (7, 3, 2, 2), (7, 3, 1, 3), (8, 3, 1, 2))}
    assert len(seeds) == 5 and tattacks.draw_seed("collude", (7, 3, 1)) not in seeds
    a = tattacks.default_draw("noise", (7, 3, 1, 2), (4, 5), "cpu")
    assert torch.equal(a, tattacks.default_draw("noise", (7, 3, 1, 2), (4, 5), "cpu"))
    g = {"encoder.weight": torch.ones(6, 16, 20), "encoder.bias": torch.ones(6, 16)}
    port = tattacks.make_attack_fn(_tplan(PLAN))
    codes = PLAN.codes(6, 1, 1)[:, 0]
    out1, out2 = (port(g, codes, torch.as_tensor(codes), 1) for _ in range(2))
    for k in g:
        assert torch.equal(out1[k], out2[k])
        changed = (out1[k] != g[k]).reshape(6, -1).any(1).numpy()
        np.testing.assert_array_equal(changed, codes != 0, err_msg=k)


# -- the reducers --------------------------------------------------------------


def _reducer_cases():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((7, 5, 6)).astype(np.float32)
    vals[:, 0, 0] = 1.5  # a tie across every site
    vals[2:5, 1] = vals[1, 1]  # ties among some
    vals[6] = 0.0  # a dead site's zeroed payload
    w = np.array([3, 1, 2, 4, 2.5, 1, 0], np.float32)
    dead = np.zeros(7, np.float32)
    return vals, [w, dead, np.array([1, 0, 0, 0, 0, 0, 0], np.float32), w * 0.01]


@pytest.mark.parametrize("mode,trim", [("trimmed_mean", 0.0), ("trimmed_mean", 0.2),
                                       ("trimmed_mean", 0.35), ("coordinate_median", None)])
def test_reducers_match_jax(mode, trim):
    """Ties, a zero-weight site, one live site, all dead (reduces to 0) and
    fractional weights. The median picks a value: bit for bit. The trimmed
    mean sums the kept band in sorted order, as XLA's reduce may not:
    within 2 ulps of the largest value (2.4e-7 relative)."""
    vals, weights = _reducer_cases()
    for w in weights:
        if mode == "trimmed_mean":
            want = np.asarray(jcoll.weighted_trimmed_mean(jnp.asarray(vals), jnp.asarray(w), trim))
            got = tcoll.robust_site_reduce(torch.from_numpy(vals), torch.from_numpy(w), mode, trim)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2.4e-7 * np.abs(vals).max())
        else:
            want = np.asarray(jcoll.weighted_coordinate_median(jnp.asarray(vals), jnp.asarray(w)))
            got = tcoll.robust_site_reduce(torch.from_numpy(vals), torch.from_numpy(w), mode)
            np.testing.assert_array_equal(got.numpy(), want)
        if not w.any():
            assert not got.any()
    for mod in (tcoll, jcoll):
        with pytest.raises(ValueError, match="trim_frac"):
            mod.weighted_trimmed_mean(vals if mod is jcoll else torch.from_numpy(vals),
                                      weights[0] if mod is jcoll else torch.from_numpy(weights[0]),
                                      0.5)


def test_clip_site_gradients_matches_jax():
    """The norm clip of 6 sites, one 40x the others and one dead (weight 0,
    zero gradient), against JAX's under ``vmap``: the median norm and the
    scales are f32 sums of squares in another order, 2 ulps (2.4e-7)."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((6, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((6, 5)).astype(np.float32)}
    for v in tree.values():
        v[2] *= 40.0
        v[5] = 0.0
    w = np.array([2, 3, 1, 4, 2, 0], np.float32)
    want = jax.vmap(lambda g, wi: jcoll.clip_site_gradients(g, wi, SITE_AXIS, 2.5),
                    axis_name=SITE_AXIS)(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    got = tcoll.clip_site_gradients({k: torch.from_numpy(v) for k, v in tree.items()},
                                    torch.from_numpy(w), 2.5)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2.4e-7, atol=0)
    assert np.abs(got["a"][2].numpy()).max() < np.abs(tree["a"][2]).max() / 10  # clipped
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])  # under the threshold


@pytest.mark.parametrize("mode", ["trimmed_mean", "coordinate_median"])
def test_robust_reduce_tree_reduces_each_leaf_as_alone(mode):
    """One sort of the whole tree's flat ``[S, N]`` buffer gives each leaf
    what its own reduction gives (the reducers act per coordinate), on the
    reducers' ties, dead site and all-dead weights, with a bf16 leaf
    (reduced in f32) and a 1-D one: the median picks a value, bit for bit;
    the trimmed mean's sum over the sites may take another order in
    another layout, within 2 ulps of the largest value (2.4e-7 relative,
    as against JAX's); ``site_flat`` and
    ``site_unflat`` give each leaf back in its shape and dtype;
    ``site_sq_norms`` is each site's sum of squares within 1e-6 of the
    float64 sum (an f32 sum of 42 terms in another order)."""
    vals, weights = _reducer_cases()
    tree = {"a": torch.from_numpy(vals), "b": torch.from_numpy(vals[:, 0]).to(torch.bfloat16),
            "c": torch.from_numpy(vals[:, 1, :3].copy())}
    for w in map(torch.from_numpy, weights):
        got = tcoll.robust_reduce_tree(tree, w, mode, 0.2)
        for k, v in tree.items():
            want = tcoll.robust_site_reduce(v.float(), w, mode, 0.2)
            assert got[k].dtype == torch.float32, k
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0, err_msg=k,
                                       atol=0 if mode == "coordinate_median"
                                       else 2.4e-7 * np.abs(vals).max())
    back = tcoll.site_unflat(tcoll.site_flat(tree), tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    want = sum(v.double().square().reshape(7, -1).sum(1) for v in tree.values())
    np.testing.assert_allclose(tcoll.site_sq_norms(tree).numpy(), want.numpy(), rtol=1e-6)
    assert tcoll.robust_reduce_tree({}, torch.from_numpy(weights[0]), mode) == {}


# -- the engines on JAX's gradients --------------------------------------------


def _sites(model="fs", seed=0, cls=jdata.SiteArrays):
    rng = np.random.default_rng(seed)
    shape = (FS_IN,) if model == "fs" else (T, C, W)
    return [cls(rng.standard_normal((n,) + shape).astype(np.float32),
                rng.integers(0, 2, n).astype(np.int32), np.arange(n, dtype=np.int32))
            for n in SIZES]


def _jax_task(model):
    if model == "fs":
        return (jsteps.FederatedTask(JMSANNet(in_size=FS_IN, hidden_sizes=FS_HIDDEN, out_size=2)),
                jnp.zeros((2, FS_IN)))
    return (jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                            window_size=W, num_cls=2, use_pallas=True,
                                            dropout_rate=0.0)), jnp.zeros((2, T, C, W)))


def _port_task(model):
    if model == "fs":
        return tsteps.FederatedTask(tmsan.MSANNet(in_size=FS_IN, hidden_sizes=FS_HIDDEN,
                                                  out_size=2))
    return tsteps.FederatedTask(tm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, dropout_rate=0.0))


@pytest.fixture(scope="module")
def jax_round():
    return _jax_round()


def _jax_round():
    """The first round's per-site gradients of the small MSANNet (JAX's
    vmap(grad)), sign-flipped on site 1 and scaled 10x on site 2, with
    their example weights and a liveness vector dropping site 4."""
    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plan = jbatching.plan_epoch_positions(sites, B, seed=0).positions[:, :1]
    task, params = _jax_msannet()
    xb, yb, wb = jax.vmap(jsteps._gather_batch, in_axes=(0, 0, 0, None))(
        jnp.asarray(inv.inputs), jnp.asarray(inv.labels), jnp.asarray(plan), None)

    def loss(p, x, y, w):
        logits, _ = task.apply(p, {}, x, train=True, mask=w, mutable=True)
        return jsteps.cross_entropy(logits, y, w)

    grads = jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0))(params, xb[:, 0], yb[:, 0],
                                                              wb[:, 0])
    mult = jnp.asarray([1.0, -1.0, 10.0, 1.0, 1.0])
    grads = jax.tree.map(lambda g: g * mult.reshape((S,) + (1,) * (g.ndim - 1)), grads)
    live = np.array([1, 1, 1, 1, 0], np.float32)
    return params, grads, np.array(wb[:, 0].sum(1)), live


def _jax_engine(name, mode, rank=10):
    if name == "rankDAD":
        return make_engine(name, precision_bits="32", robust_agg=mode,
                           **dict(DAD, fused_poweriter=False))
    kw = {"dad_reduction_rank": rank} if name == "powerSGD" else {}
    return make_engine(name, precision_bits="32", robust_agg=mode, **kw)


def _port_engine(name, mode, cfg=FS, rank=10):
    table = leaf_table(cfg)
    if name == "rankDAD":
        return make_rankdad(precision_bits="32", transposed=table.transposed, robust_agg=mode,
                            **DAD)
    if name == "powerSGD":
        return make_powersgd(rank, precision_bits="32", transposed=table.transposed,
                             leaf_index=table.leaf_index, robust_agg=mode)
    return make_dsgd("32", robust_agg=mode)


# Per leaf: within a share of the leaf's max |value| (dSGD: elementwise f32
# on the same payloads, sums in another order; the low-rank engines' f32
# floor) or within 4x JAX's own spread, whichever is larger: the farthest
# JAX's result moves over three draws of a relative noise of 1e-7 (one
# ulp) on its gradients. A robust reduce is not linear, so where a factor is ill-determined
# (the noise columns of a leaf whose per-site rank, at most the batch of 4,
# is under r = 10; a nearly rank-1 sketch of a rank-2 leaf) the result
# follows the basis, and JAX's own spread there reaches 1e-3 to 5e-2 of
# the leaf's max.
ENGINE_SHARE = {"dSGD": 1e-6, "rankDAD": 1e-4, "powerSGD": 1e-5}
SPREAD_FACTOR, NUDGES = 4.0, 3


def _check_at_spread(what, got, want, nudged, share):
    for k, w in want.items():
        tol = max(share * np.abs(w).max(), SPREAD_FACTOR * np.abs(nudged[k] - w).max(), 1e-12)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["dSGD", "rankDAD", "powerSGD"])
def test_engine_robust_aggregate_matches_jax(jax_round, name, mode):
    """Every engine under every mode on JAX's per-site gradients of one
    round (a sign-flipped site, a 10x site, a dead site), against JAX's
    engine under ``vmap``; powerSGD's q and each site's e too."""
    params, grads, n, live = jax_round
    eng = _jax_engine(name, mode)
    task, sample = _jax_task("fs")
    state_j = jsteps.init_train_state(task, eng, jsteps.make_optimizer("adam", LR),
                                      jax.random.PRNGKey(0), sample, num_sites=S)
    fn = jax.jit(jax.vmap(lambda g, st, w, lv: eng.aggregate(g, st, w, SITE_AXIS, live=lv),
                          axis_name=SITE_AXIS))
    rng = np.random.default_rng(1)
    nudged = [jax.tree.map(
        lambda g: g * (1 + 1e-7 * rng.standard_normal(g.shape).astype(np.float32)), grads)
        for _ in range(NUDGES)]
    runs = [jax.tree.map(np.asarray, fn(g, state_j.engine_state, jnp.asarray(n),
                                        jnp.asarray(live))) for g in [grads] + nudged]
    agg_j, es_j = runs[0]
    # the spread: the largest move of any nudged run, leaf by leaf
    agg_n, es_n = (jax.tree.map(lambda w, *ns: max(ns, key=lambda v: np.abs(v - w).max()),
                                runs[0][i], *[r[i] for r in runs[1:]]) for i in (0, 1))
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    agg_t, es_t = _port_engine(name, mode).aggregate(
        _to_port(grads, S), state_t.engine_state, torch.from_numpy(n),
        live=torch.from_numpy(live))
    got = train_state_to_jax(dataclasses.replace(state_t, params=agg_t, engine_state=es_t))
    first = lambda t: _flat(jax.tree.map(lambda a: a[0], t))  # noqa: E731
    _check_at_spread(f"{name} {mode} aggregate", _flat(got["params"]), first(agg_j),
                     first(agg_n), ENGINE_SHARE[name])
    if name == "powerSGD":
        factors = lambda t: {k: v for k, v in _flat(t).items() if v.dtype != object}  # noqa
        _check_at_spread(f"powerSGD {mode}", factors(got["engine_state"]), factors(es_j),
                         factors(es_n), ENGINE_SHARE[name])


def test_robust_modes_are_checked_as_in_jax():
    for make in (lambda **k: make_dsgd(**k), lambda **k: make_powersgd(**k),
                 lambda **k: make_rankdad(**k)):
        with pytest.raises(ValueError, match="robust_agg must be one of"):
            make(robust_agg="krum")
        with pytest.raises(ValueError, match="trim_frac"):
            make(robust_agg="trimmed_mean", robust_trim_frac=0.5)
        make(robust_agg="norm_clip", robust_trim_frac=0.5)  # unused by the clip


# -- epochs under faults and attacks -------------------------------------------


def _epoch_setup(model, name, mode, plan, rank, rep=dict(reputation_z=1.5,
                                                         reputation_rounds=2)):
    task, sample = _jax_task(model)
    opt = jsteps.make_optimizer("adam", LR)
    eng = _jax_engine(name, mode, rank)
    state_j = jsteps.init_train_state(task, eng, opt, jax.random.PRNGKey(0), sample,
                                      num_sites=S, reputation=True)
    epoch_j = jsteps.make_train_epoch_fn(task, eng, opt, mesh=None, pipeline="device",
                                         attack_plan=plan, robust_agg=mode, **rep)
    epoch_t = tsteps.make_train_epoch_fn(
        _port_task(model), _port_engine(name, mode, FS if model == "fs" else ICA, rank),
        tsteps.make_optimizer("adam", LR), device="cpu", attack_plan=_tplan(plan),
        robust_agg=mode, **rep)
    return state_j, epoch_j, train_state_from_jax(jax.tree.map(np.asarray, state_j),
                                                  device="cpu"), epoch_t


# The first round's aggregate (mu / (1 - b1) after one Adam step) per leaf
# at a share of its max |value| (the shares of tests/test_torch_port_train.py:
# f32 sums in another order; rankDAD's noise columns), a leaf that is
# rounding noise (cls_fc1.bias of the ICA-LSTM, before a BatchNorm) at the
# share of the tree's largest; the losses at LOSS_TOL, after rankDAD's
# first round at DAD_LOSS_ATOL (params part on the lr scale); the int
# health fields equal; the anomaly score, a moving average of z-scores of
# norms, within ANOMALY_ATOL (measured <= 2.2e-6), after rankDAD's parted
# rounds within DAD_ANOMALY_ATOL (0.1 of a z-score's change of 0.02 with
# the distances to an aggregate that parts at DAD_AGG_SHARE).
EPOCH_SHARE = {"dSGD": 1e-5, "powerSGD": 1e-4, "rankDAD": 1e-3}
NOISE_LEAVES = ("cls_fc1/bias",)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
DAD_LOSS_ATOL = 3e-3
ANOMALY_ATOL, DAD_ANOMALY_ATOL = 1e-4, 1e-2


def _first_round_check(name, got, want):
    g, w = _flat(got), _flat(want)
    top = max(np.abs(v).max() for v in w.values())
    for k, v in w.items():
        scale = top if k in NOISE_LEAVES else np.abs(v).max()
        np.testing.assert_allclose(g[k] / 0.1, v / 0.1, rtol=0,
                                   atol=EPOCH_SHARE[name] * scale / 0.1 + 1e-12,
                                   err_msg=f"first-round aggregate {k}")


def _epochs_against_jax(model, name, mode, epochs=2, rank=10):
    """``epochs`` epochs' rounds of ``model`` under ``FAULTS`` and
    ``DET_PLAN`` on both sides, as one-round epochs on their windows of the
    global round counter; the first round's aggregate is checked."""
    sites = _sites(model)
    inv = jdata.stack_site_inventory(sites)
    idx = np.concatenate([jbatching.plan_epoch_positions(sites, B, seed=e).positions
                          for e in range(epochs)], axis=1)
    rounds = idx.shape[1]
    state_j, epoch_j, state_t, epoch_t = _epoch_setup(model, name, mode, DET_PLAN, rank)
    live, nan = jfaults.fault_window(FAULTS, S, 0, rounds)
    nan, attack = nan.astype(np.float32), DET_PLAN.codes(S, 0, rounds)
    losses_j, losses_t = [], []
    for r in range(rounds):
        w = slice(r, r + 1)
        state_j, lj = epoch_j(state_j, jnp.asarray(inv.inputs), jnp.asarray(inv.labels),
                              jnp.asarray(idx[:, w]), jnp.asarray(live[:, w]),
                              jnp.asarray(nan[:, w]), jnp.asarray(attack[:, w]))
        state_t, lt = epoch_t(state_t, inv.inputs, inv.labels, idx[:, w], live[:, w], nan[:, w],
                              attack[:, w])
        losses_j.append(np.asarray(lj))
        losses_t.append(lt.numpy())
        if r == 0:
            _first_round_check(name, train_state_to_jax(state_t)["opt_state"]["mu"],
                               state_j.opt_state[0].mu)
    return (np.concatenate(losses_t), np.concatenate(losses_j), train_state_to_jax(state_t),
            jax.tree.map(np.asarray, state_j))


def _check_health(got, want, anomaly_atol=ANOMALY_ATOL):
    assert got.keys() == want.keys() and "anomaly" in got
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if k == "anomaly":
            np.testing.assert_allclose(got[k], w, atol=anomaly_atol, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("mode", ["trimmed_mean", "coordinate_median"])
def test_powersgd_epochs_under_faults_and_attacks_match_jax(mode):
    """Two powerSGD epochs of the small MSANNet with a drop, a straggler and
    a NaN round beside sign-flip, scale and free-rider sites: the first
    round's aggregate, the losses and every health field, reputation
    included. At rank 1: a softmax layer's per-site gradient has rank C-1
    < C = n, so at r = n its P holds a column of rounding noise, which the
    weighted sum cancels and a robust reduce does not (JAX's own aggregate
    of the 2-class output moves by 4 % of its max under one-ulp noise);
    at r = 1 every P is determined. The engine test above covers r = 10
    at JAX's spread."""
    lt, lj, got, want = _epochs_against_jax("fs", "powerSGD", mode, rank=1)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    _check_health(got["health"], want.health)
    assert got["health"]["skips"].sum() > 0 and np.isfinite(lt).all()


@pytest.mark.parametrize("mode", ["norm_clip", "trimmed_mean"])
def test_dsgd_epochs_under_faults_and_attacks_match_jax(mode):
    """Two dSGD epochs of the small MSANNet with a drop, a straggler and a
    NaN round beside sign-flip, scale and free-rider sites: the first
    round's aggregate, the losses, every health field (the median:
    the powerSGD case below)."""
    lt, lj, got, want = _epochs_against_jax("fs", "dSGD", mode)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    _check_health(got["health"], want.health)


def test_rankdad_trimmed_mean_epoch_matches_jax():
    """One rankDAD ``trimmed_mean`` epoch of the small MSANNet under the
    same plans: the first round's aggregate, the first loss at LOSS_TOL,
    the rest at DAD_LOSS_ATOL, the health fields."""
    lt, lj, got, want = _epochs_against_jax("fs", "rankDAD", "trimmed_mean", epochs=1)
    np.testing.assert_allclose(lt[0], lj[0], **LOSS_TOL)
    np.testing.assert_allclose(lt, lj, atol=DAD_LOSS_ATOL, rtol=0)
    _check_health(got["health"], want.health, DAD_ANOMALY_ATOL)


def test_attack_mask_without_a_plan_raises_as_in_jax():
    task = _port_task("fs")
    opt = tsteps.make_optimizer("adam", LR)
    epoch = tsteps.make_train_epoch_fn(task, make_dsgd(), opt, device="cpu")
    state = tsteps.init_train_state(task, make_dsgd(), opt, num_sites=S)
    inv = jdata.stack_site_inventory(_sites())
    plan = jbatching.plan_epoch_positions(_sites(), B, seed=0).positions[:, :1]
    with pytest.raises(ValueError, match="attack_plan"):
        epoch(state, inv.inputs, inv.labels, plan, None, None, np.zeros((S, 1), np.int32))


# -- the reputation layer ------------------------------------------------------


def test_reputation_quarantines_a_persistent_attacker_as_jax_does():
    """JAX's ``test_reputation_quarantines_persistent_attacker`` on both
    sides: 8 sites of a small MSANNet, site 2 scaling its gradient 50x,
    ``trimmed_mean``, z 2, 3 rounds. The anomaly z flags only the attacker,
    its suspect streak latches the quarantine; every health field as JAX's
    (anomaly within ANOMALY_ATOL), the losses at LOSS_TOL."""
    S8, steps, B8, D = 8, 4, 4, 6
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S8, steps, B8, D)).astype(np.float32)
    y = (np.arange(S8 * steps * B8).reshape(S8, steps, B8) % 2).astype(np.int32)
    w = np.ones((S8, steps, B8), np.float32)
    plan = jattacks.AttackPlan(scale=((2, 0, -1),), scale_factor=50.0)
    am = jattacks.attack_window(plan, S8, 0, steps)
    task = jsteps.FederatedTask(JMSANNet(in_size=D, hidden_sizes=(8,), out_size=2))
    opt = jsteps.make_optimizer("adam", 1e-2)
    eng = make_engine("dSGD", robust_agg="trimmed_mean")
    state_j = jsteps.init_train_state(task, eng, opt, jax.random.PRNGKey(0), jnp.asarray(x[0, 0]),
                                      num_sites=S8, reputation=True)
    rep = dict(attack_plan=plan, robust_agg="trimmed_mean", reputation_z=2.0,
               reputation_rounds=3)
    fn = jsteps.make_train_epoch_fn(task, eng, opt, mesh=None, **rep)
    cfg = TrainConfig(fs_args=FSArgs(input_size=D, hidden_sizes=(8,)))
    model = tmsan.MSANNet(in_size=D, hidden_sizes=(8,), out_size=2)
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, state_j.params), {}))
    port_opt = tsteps.make_optimizer("adam", 1e-2)
    fn_t = tsteps.make_train_epoch_fn(tsteps.FederatedTask(model), make_dsgd(
        robust_agg="trimmed_mean"), port_opt, device="cpu", pipeline="host",
        **dict(rep, attack_plan=_tplan(plan)))
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    for _ in range(2):
        state_j, lj = fn(state_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), None,
                         jnp.asarray(am))
        state_t, lt = fn_t(state_t, x, y, w, None, am)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOSS_TOL)
    h = {k: v.numpy() for k, v in state_t.health.items()}
    assert h["quarantined"].tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    assert h["anomaly"][2] == h["anomaly"].max() and h["anomaly"][2] > 0.3
    assert h["suspect_streak"][2] >= 3
    assert h["skips"][2] > 0 and (h["skips"][np.arange(S8) != 2] == 0).all()
    _check_health(h, jax.tree.map(np.asarray, state_j.health))
    z = fn_t.reputation_z_trace[0]
    assert z.shape == (steps, S8) and torch.isnan(z[-1, 2])  # quarantined: sat out
