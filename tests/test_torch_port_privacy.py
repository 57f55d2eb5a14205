"""The port's privacy plane against the JAX package's, module by module:
the RDP accountant (``privacy/accounting.py``), the DP-SGD transform with
JAX's noise handed across (``privacy/dpsgd.py``), the secure-aggregation
masked mean and dSGD's masked wire (``privacy/secure_agg.py``,
``engines/dsgd.py``) against JAX's under ``jax.vmap`` over the site axis,
and the personalized-head partition (``privacy/personalize.py``).

Inputs are made with numpy from a seed. The leaves are a small MSANNet's
(its ``nn.Linear`` weights stored transposed, its JAX leaf order not the
port's) and a small ICA-LSTM's. Each tolerance is stated beside its test.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu import privacy as jprivacy
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import MSANNet as JMSANNet
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS
from dinunet_implementations_tpu.privacy import accounting as jacct
from dinunet_implementations_tpu.privacy import dpsgd as jdpsgd
from dinunet_implementations_tpu.privacy import personalize as jpers
from dinunet_implementations_tpu.privacy import secure_agg as jsecure
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch import privacy as tprivacy
from dinunet_implementations_tpu_torch.engines import make_dsgd, make_powersgd, make_rankdad
from dinunet_implementations_tpu_torch.models import icalstm as tm
from dinunet_implementations_tpu_torch.models.msannet import MSANNet
from dinunet_implementations_tpu_torch.privacy import accounting as tacct
from dinunet_implementations_tpu_torch.privacy import dpsgd as tdpsgd
from dinunet_implementations_tpu_torch.privacy import personalize as tpers
from dinunet_implementations_tpu_torch.privacy import secure_agg as tsecure
from dinunet_implementations_tpu_torch.trainer import steps as tsteps
from dinunet_implementations_tpu_torch.weights import table_of

FS_IN, FS_HIDDEN, S = 12, (16, 12), 5
FS_TABLE = MSANNet.leaf_table(len(FS_HIDDEN))
RTOL_ACCT = 1e-12


def _jax_msannet(seed=0):
    task = jsteps.FederatedTask(JMSANNet(in_size=FS_IN, hidden_sizes=FS_HIDDEN, out_size=2))
    params, _ = task.init_variables(jax.random.PRNGKey(seed), jnp.zeros((2, FS_IN)))
    return params


def _site_grads(params, seed, sites=S, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        (scale * rng.standard_normal((sites,) + p.shape)).astype(np.float32)), params)


def _to_port(tree, sites, table=FS_TABLE):
    """A JAX params-shaped tree of ``[S, ...]`` leaves (or a subtree) as
    the port's dict, in the table's order."""
    flat = {}
    for n, j, tr in table.params:
        node = tree
        try:
            for k in j.split("/"):
                node = node[k]
        except KeyError:
            continue
        a = np.asarray(node)
        flat[n] = torch.from_numpy(np.array(np.swapaxes(a, -1, -2) if tr else a))
    return flat


# -- the accountant ------------------------------------------------------------


@pytest.mark.parametrize("q,sigma", [(1.0, 0.5), (0.25, 0.5), (0.05, 1.0), (0.5, 2.0),
                                     (0.0, 1.0), (0.3, 0.0)])
def test_rdp_of_one_step_equals_jax(q, sigma):
    """Every integer order's RDP, each to 1e-12 relative (the same float64
    formula: equal in practice); σ = 0 is infinite on both sides."""
    for order in tacct.DEFAULT_ORDERS:
        got = tacct.rdp_sampled_gaussian(q, sigma, order)
        want = jacct.rdp_sampled_gaussian(q, sigma, order)
        if math.isinf(want):
            assert math.isinf(got)
        else:
            assert got == pytest.approx(want, rel=RTOL_ACCT, abs=0.0)


def test_accountant_epsilon_and_json_equal_jax():
    """A ledger stepped through several (σ, q, steps) gives JAX's ε and
    order at every δ, to 1e-12 relative; its JSON round-trips through both
    packages' ``from_json``; a noiseless ledger is infinite; the validation
    errors are JAX's."""
    t, j = tacct.RdpAccountant(), jacct.RdpAccountant()
    assert t.epsilon(1e-5) == j.epsilon(1e-5) == (0.0, None)
    for sigma, q, steps in ((0.25, 0.5, 3), (0.25, 0.125, 8), (1.0, 1.0, 2)):
        t.step(sigma, q, steps)
        j.step(sigma, q, steps)
        for delta in (1e-5, 1e-3):
            (te, to), (je, jo) = t.epsilon(delta), j.epsilon(delta)
            assert te == pytest.approx(je, rel=RTOL_ACCT) and to == jo
    blob = json.loads(json.dumps(t.to_json()))
    assert blob == json.loads(json.dumps(j.to_json()))
    for cls in (tacct.RdpAccountant, jacct.RdpAccountant):
        back = cls.from_json(blob)
        assert back.steps == t.steps and back.epsilon(1e-5) == t.epsilon(1e-5)
    none = tacct.RdpAccountant().step(0.0, 0.5, steps=3)
    assert math.isinf(none.epsilon(1e-5)[0])
    assert json.loads(json.dumps(none.to_json()))["rdp"][0] is None
    for bad in (lambda m: m.rdp_sampled_gaussian(1.5, 1.0, 2),
                lambda m: m.rdp_sampled_gaussian(0.5, 1.0, 1),
                lambda m: m.rdp_to_epsilon((2,), (1.0,), 0.0),
                lambda m: m.RdpAccountant().step(1.0, 0.5, steps=-1),
                lambda m: m.RdpAccountant(rdp=np.zeros(3)),
                lambda m: m.RdpAccountant.from_json([1])):
        for mod in (tacct, jacct):
            with pytest.raises(ValueError):
                bad(mod)


def test_sampling_fraction_and_effective_sigma_equal_jax():
    for args in ((8, 1, [64, 16, 32]), (8, 2, [16]), (8, 1, []), (8, 1, [0, 32]),
                 (16, 3, [100, 400, 0, 250])):
        assert tacct.sampling_fraction(*args) == jacct.sampling_fraction(*args)
    assert tacct.MEAN_CLIP_SENSITIVITY_FACTOR == jacct.MEAN_CLIP_SENSITIVITY_FACTOR
    for s in (0.0, 0.5, 1.3):
        assert tacct.effective_noise_multiplier(s) == jacct.effective_noise_multiplier(s)


def test_the_package_exports_jax_privacy_names():
    assert set(tprivacy.__all__) == set(jprivacy.__all__)
    assert tsecure.SECURE_AGGS == jsecure.SECURE_AGGS


# -- the DP-SGD transform --------------------------------------------------------


def _jax_dp_draw(kind, key, shape, device):
    """JAX's noise for the port's transform: ``make_dp_fn``'s keys."""
    assert kind == "dp"
    seed, site, rnd, i = key
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), site), rnd)
    return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(k, i), tuple(shape),
                                                       jnp.float32))).to(device)


_JAX_FNS: dict = {}


@pytest.mark.parametrize("rnd,head", [(0, ()), (3, ()), (2, ("fc_out",)), (5, ("linear_0",))])
def test_dp_transform_with_jax_draws_matches_jax(rnd, head):
    """Five sites' gradients at scales from under to far over the clip,
    one site all zero: the port's transform with JAX's draws against JAX's
    ``make_dp_fn`` under ``vmap``, within 1e-6 of each leaf's largest
    value (the norm sums leaves in another order, and XLA fuses the noise's
    multiply-add). Head leaves pass through untouched, bit for bit."""
    params = _jax_msannet()
    grads = jax.tree.map(lambda g: g * jnp.asarray([0.01, 0.3, 1.0, 4.0, 0.0]).reshape(
        (S,) + (1,) * (g.ndim - 1)), _site_grads(params, rnd))
    skip_j = jpers.head_leaf_paths(params, head) if head else frozenset()
    key = ("dp", head)
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax.jit(jax.vmap(jdpsgd.make_dp_fn(1.0, 0.5, 7, skip_j),
                                         in_axes=(0, None, 0)))
    want = _to_port(_JAX_FNS[key](grads, jnp.int32(rnd), jnp.arange(S, dtype=jnp.int32)), S)
    skip_t = tpers.head_leaf_paths(set(want), head, FS_TABLE) if head else frozenset()
    dp = tdpsgd.make_dp_fn(1.0, 0.5, 7, skip_t, FS_TABLE, draw=_jax_dp_draw)
    got = dp(_to_port(grads, S), rnd)
    src = _to_port(grads, S)
    assert list(got) == list(src)
    for k, w in want.items():
        if k in skip_t:
            assert torch.equal(got[k], src[k]), k
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * max(np.abs(w.numpy()).max(), 1e-30), err_msg=k)


def test_clip_only_bounds_the_norm_and_leaves_small_sites_alone():
    """σ = 0: each site's shared norm ends at most C (to one f32 rounding of
    the product), a site under the clip is returned bit for bit, and a
    site over it is scaled by one factor; noise without a clip and
    negative knobs are JAX's ValueErrors; 0 and 0 builds nothing."""
    grads = _to_port(_site_grads(_jax_msannet(), 9, scale=1.0), S)
    grads = {k: g * torch.tensor([0.001, 0.01, 1.0, 10.0, 100.0]).reshape(
        (S,) + (1,) * (g.dim() - 1)) for k, g in grads.items()}
    out = tdpsgd.make_dp_fn(1.0, 0.0, table=FS_TABLE)(grads, 4)
    norm = lambda t: torch.sqrt(sum((v.reshape(S, -1) ** 2).sum(1) for v in t.values()))  # noqa
    n_in, n_out = norm(grads), norm(out)
    assert (n_out <= 1.0 + 1e-6).all()
    small = n_in < 1.0
    assert small[:2].all() and not small[2:].any()
    for k in grads:
        assert torch.equal(out[k][small], grads[k][small]), k
    torch.testing.assert_close(n_out[~small], torch.ones(int((~small).sum())), rtol=1e-6,
                               atol=0)
    for mod in (tdpsgd, jdpsgd):
        assert mod.make_dp_fn(0.0, 0.0) is None
        for args, match in (((0.0, 1.0), "needs dp_clip"), ((-1.0, 0.0), "dp_clip"),
                            ((1.0, -0.5), "dp_noise_multiplier")):
            with pytest.raises(ValueError, match=match):
                mod.make_dp_fn(*args)
        assert mod.dp_enabled(1.0, 0.0) and not mod.dp_enabled(0.0, 0.0)


def test_default_draws_replay_by_seed_site_round_and_leaf():
    """The port's own noise is a function of (seed, site, round, leaf):
    two calls agree bit for bit; another round or seed draws anew; the
    draws are standard normal in the JAX leaf shape."""
    grads = {k: torch.zeros_like(v) for k, v in _to_port(_site_grads(_jax_msannet(), 1), S)
             .items()}
    a = tdpsgd.make_dp_fn(1.0, 1.0, 3, table=FS_TABLE)(grads, 2)
    b = tdpsgd.make_dp_fn(1.0, 1.0, 3, table=FS_TABLE)(grads, 2)
    c = tdpsgd.make_dp_fn(1.0, 1.0, 3, table=FS_TABLE)(grads, 5)
    d = tdpsgd.make_dp_fn(1.0, 1.0, 4, table=FS_TABLE)(grads, 2)
    for k in grads:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k]) and not torch.equal(a[k], d[k])
        assert not torch.equal(a[k][0], a[k][1])
    flat = torch.cat([v.reshape(-1) for v in a.values()])
    assert abs(float(flat.mean())) < 0.1 and abs(float(flat.std()) - 1.0) < 0.1
    eps = tdpsgd.default_draw("dp", (3, 1, 2, FS_TABLE.leaf_index["linear_0.weight"]),
                              (FS_IN, FS_HIDDEN[0]), "cpu")
    assert torch.equal(a["linear_0.weight"][1], eps.mT)


# -- secure aggregation ------------------------------------------------------------


def _jax_masked(grads, weight, live, seed, rnd, pads):
    key = ("mask", live is None, pads)
    if key not in _JAX_FNS:
        if live is None:
            fn = jax.vmap(lambda g, w, r: jsecure.masked_weighted_mean(
                g, w, SITE_AXIS, seed, r, pads=pads), in_axes=(0, 0, None), axis_name=SITE_AXIS)
        else:
            fn = jax.vmap(lambda g, w, r, lv: jsecure.masked_weighted_mean(
                g, w, SITE_AXIS, seed, r, live=lv, pads=pads), in_axes=(0, 0, None, 0),
                axis_name=SITE_AXIS)
        _JAX_FNS[key] = jax.jit(fn)
    args = (grads, jnp.asarray(weight), jnp.int32(rnd))
    if live is not None:
        args += (jnp.asarray(live),)
    return jax.tree.map(lambda a: a[0], _JAX_FNS[key](*args))


@pytest.mark.parametrize("dead", [(), (1,), (0, 3)])
@pytest.mark.parametrize("rnd", [0, 7])
def test_masked_weighted_mean_equals_jax_bit_for_bit(dead, rnd):
    """The masked mean of five sites (example-count weights, dead sites
    zeroed upstream as ``mask_dead_site`` does) equals JAX's under
    ``vmap(axis_name=...)`` bit for bit, with and without pads on both
    sides: the grid, the rounding and the int32 sum are exact."""
    params = _jax_msannet()
    grads = _site_grads(params, 11 + rnd, scale=0.05)
    weight = np.array([4, 3, 4, 2, 1], np.float32)
    live = None
    if dead:
        live = np.ones(S, np.float32)
        live[list(dead)] = 0.0
        weight = weight * live
        grads = jax.tree.map(lambda g: g * jnp.asarray(live).reshape(
            (S,) + (1,) * (g.ndim - 1)), grads)
    tw = torch.from_numpy(weight)
    tl = None if live is None else torch.from_numpy(live)
    for pads in (True, False):
        want = _to_port(_jax_masked(grads, weight, live, 5, rnd, pads), 1)
        got = tsecure.masked_weighted_mean(_to_port(grads, S), tw, 5, rnd, live=tl, pads=pads,
                                           leaf_index=FS_TABLE.leaf_index,
                                           transposed=FS_TABLE.transposed)
        for k, w in want.items():
            assert got[k].dtype == torch.float32
            assert got[k].numpy().tobytes() == w.numpy().tobytes(), (pads, k)


def test_mask_equals_nopads_and_the_pads_wrap():
    """The port's "mask" and "mask-nopads" engines agree bit for bit at
    full liveness and with a dead site, while the pads really move each
    site's int32 wire value (they wrap mod 2**32, and cancel in the sum);
    the masked mean is within a grid step of the plain float mean."""
    grads = _to_port(_site_grads(_jax_msannet(), 3, scale=0.1), S)
    weight = torch.tensor([5.0, 1.0, 3.0, 2.0, 4.0])
    on = make_dsgd(secure_agg="mask", secure_agg_seed=2)
    off = make_dsgd(secure_agg="mask-nopads")
    plain = make_dsgd()
    for live in (None, torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])):
        a, _ = on.aggregate(grads, {}, weight, live=live, rnd=3)
        b, _ = off.aggregate(grads, {}, weight, live=live, rnd=3)
        c, _ = plain.aggregate(grads, {}, weight, live=live)
        w = weight * (1.0 if live is None else live)
        for k in grads:
            assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
            # each site rounds to half a grid step Δ of the weighted deltas
            amax = float((grads[k] * (w / w.sum()).reshape((S,) + (1,) * (grads[k].dim() - 1)))
                         .abs().max())
            step = 2.0 ** (math.ceil(math.log2(amax)) - tsecure.fraction_bits(S))
            # plus one f32 rounding of the float mean
            ulp = 2.0 ** -23 * float(c[k].abs().max())
            assert float((a[k] - c[k]).abs().max()) <= S * step / 2 + ulp, k
    pad = tsecure.default_pad((2, 0, 1, 3, 0), (4096,), "cpu")
    assert pad.dtype == torch.int32 and int(pad.min()) < -2 ** 30 and int(pad.max()) > 2 ** 30
    big = torch.tensor([2 ** 31 - 1], dtype=torch.int32)
    assert int((big + torch.tensor([1], dtype=torch.int32))[0]) == -2 ** 31
    with pytest.raises(ValueError, match="round counter"):
        on.aggregate(grads, {}, weight)
    for mod in (tsecure, jsecure):
        with pytest.raises(ValueError, match="secure_agg must be one of"):
            mod.secure_agg_enabled("pads")


@pytest.mark.parametrize("sites", [1, 2, 3, 5, 32, 64, 1000, 5_000_000])
def test_fraction_bits_equal_jax(sites):
    assert tsecure.fraction_bits(sites) == jsecure.fraction_bits(sites)
    assert (2 ** tsecure.fraction_bits(sites)) * max(sites, 1) <= 2 ** 31 or sites > 2 ** 22


def test_secure_agg_composition_refusals_are_jax_s():
    """The refusals of JAX's ``make_dsgd``: the gather-based reducers, the
    quantized wire codecs and a DCN codec; ``norm_clip`` composes; the
    low-rank engines refuse any mode but "off"."""
    for mode in ("trimmed_mean", "coordinate_median"):
        for mk in (make_dsgd, lambda **k: make_engine("dSGD", **k)):
            with pytest.raises(ValueError, match="gather-based reducers"):
                mk(secure_agg="mask", robust_agg=mode)
    for mk in (make_dsgd, lambda **k: make_engine("dSGD", **k)):
        with pytest.raises(ValueError, match="float codec grid"):
            mk(secure_agg="mask", wire_quant="int8")
        with pytest.raises(ValueError, match="DCN wire codec"):
            mk(secure_agg="mask", dcn_wire_quant="int8")
        mk(secure_agg="mask", robust_agg="norm_clip")
        mk(secure_agg="mask-nopads", dcn_wire_quant="none")
    for mk in (make_rankdad, make_powersgd):
        with pytest.raises(ValueError, match="only supported by the dSGD engine"):
            mk(secure_agg="mask")


def test_secure_dsgd_engine_equals_jax_with_norm_clip_and_a_dead_site():
    """dSGD's masked wire with the norm clip and a dead site, the port's
    engine against JAX's under ``vmap``: the clip's scales are f32 products
    of norms summed in another order, so within 2 grid steps (2·Δ, Δ the
    leaf's power-of-two grid step) of JAX's aggregate."""
    params = _jax_msannet()
    grads = _site_grads(params, 21, scale=0.2)
    weight = np.array([4, 3, 4, 2, 1], np.float32)
    live = np.array([1, 1, 0, 1, 1], np.float32)
    jeng = make_engine("dSGD", robust_agg="norm_clip", secure_agg="mask", secure_agg_seed=4)
    fn = jax.jit(jax.vmap(lambda g, w, lv: jeng.aggregate(g, {}, w, SITE_AXIS, live=lv,
                                                          rnd=jnp.int32(2))[0],
                          axis_name=SITE_AXIS))
    want = _to_port(jax.tree.map(lambda a: a[0], fn(grads, weight, live)), 1)
    teng = make_dsgd(robust_agg="norm_clip", secure_agg="mask", secure_agg_seed=4)
    got, _ = teng.aggregate(_to_port(grads, S), {}, torch.from_numpy(weight),
                            live=torch.from_numpy(live), rnd=2)
    fb = tsecure.fraction_bits(S)
    for k, w in want.items():
        delta = 2.0 ** (math.ceil(math.log2(float(np.abs(w.numpy()).max()) + 1e-30)) - fb + 1)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * delta, err_msg=k)


# -- personalized heads -------------------------------------------------------------


def _ica_params():
    model = jm.ICALstm(input_size=8, hidden_size=6, num_comps=3, window_size=4, num_cls=2,
                       use_pallas=False, dropout_rate=0.0)
    params, _ = jsteps.FederatedTask(model).init_variables(jax.random.PRNGKey(0),
                                                           jnp.zeros((2, 5, 3, 4)))
    return params


@pytest.mark.parametrize("which,patterns", [("fs", ("fc_out",)), ("fs", ("linear_1", "bn_0")),
                                            ("ica", ("cls_fc3",)), ("ica", ("cls_",)),
                                            ("ica", ("lstm/rev",))])
def test_head_partition_picks_jax_s_leaves(which, patterns):
    """The port matches the "/"-joined JAX path, so a pattern picks the same
    leaves as JAX's ``head_leaf_paths`` whatever the ``state_dict`` name;
    the shared leaves' index is their place in JAX's flattened shared
    subtree (powerSGD's first Q, the pads)."""
    params = _jax_msannet() if which == "fs" else _ica_params()
    table = table_of(params)
    jpaths = {"/".join(p) for p in jpers.head_leaf_paths(params, patterns)}
    port = {n for n, _, _ in table.params}
    head = tpers.head_leaf_paths(port, patterns, table)
    assert {j for n, j, _ in table.params if n in head} == jpaths
    shared = jpers.strip_tree(params, jpers.head_leaf_paths(params, patterns), keep_head=False)
    order = ["/".join(jpers.leaf_path_of(kp))
             for kp, _ in jax.tree_util.tree_flatten_with_path(shared)[0]]
    index = tpers.shared_leaf_index(table, head)
    jpath = {n: j for n, j, _ in table.params}
    assert sorted(index, key=index.get) == [next(n for n in port if jpath[n] == p)
                                            for p in order]


def test_pattern_validation_and_helpers_match_jax():
    """JAX's errors for a mask that matches nothing and for one that
    matches every leaf; ``strip_tree`` / ``merge_head`` / ``zero_head`` /
    ``graft_shared`` over the port's dicts; the fresh rows stack the
    global head with a per-site Adam count."""
    params = _jax_msannet()
    tp = {k: v[0] for k, v in _to_port(jax.tree.map(lambda a: a[None], params), 1).items()}
    for pats, match in ((("nonexistent_layer",), "no parameter leaf"),
                        (("kernel", "bias", "scale"), "EVERY parameter")):
        with pytest.raises(ValueError, match=match):
            jpers.head_leaf_paths(params, pats)
        with pytest.raises(ValueError, match=match):
            tpers.head_leaf_paths(tp, pats)
    assert tpers.head_leaf_paths(tp, ()) == tpers.head_leaf_paths(tp, ("",)) == frozenset()
    head = tpers.head_leaf_paths(tp, ("fc_out",))
    assert head == {"fc_out.weight", "fc_out.bias"}
    h = tpers.strip_tree(tp, head, keep_head=True)
    sh = tpers.strip_tree(tp, head, keep_head=False)
    assert set(h) == head and set(sh) | set(h) == set(tp) and not set(sh) & set(h)
    bumped = {k: v * 3 for k, v in h.items()}
    merged = tpers.merge_head(tp, bumped)
    assert list(merged) == list(tp)
    assert torch.equal(merged["fc_out.weight"], tp["fc_out.weight"] * 3)
    z = tpers.zero_head(tp, head)
    assert not z["fc_out.bias"].any() and torch.equal(z["linear_0.weight"], tp["linear_0.weight"])
    g = tpers.graft_shared(tp, {k: v + 1 for k, v in sh.items()}, head)
    assert list(g) == list(tp) and not g["fc_out.weight"].any()
    assert torch.equal(g["linear_1.weight"], tp["linear_1.weight"] + 1)
    opt = tsteps.make_optimizer("adam", 1e-2)
    rows = tpers.default_personal(4, tp, head, opt)
    assert rows["opt"]["count"].shape == (4,) and rows["opt"]["count"].dtype == torch.int32
    for k in head:
        assert rows["params"][k].shape == (4,) + tuple(tp[k].shape)
        assert torch.equal(rows["params"][k][2], tp[k])
        assert rows["params"][k].data_ptr() != tp[k].data_ptr()
    jrows = jpers.default_personal(4, params, jpers.head_leaf_paths(params, ("fc_out",)),
                                   jsteps.make_optimizer("adam", 1e-2))
    assert np.asarray(jrows["opt"][0].count).shape == (4,)


def test_per_row_adam_equals_jax_per_site_optax():
    """The heads' optimizer rows: Adam with a ``[S]`` count (rows gated so
    that they advance unevenly) equals optax's per-row update under
    ``vmap``, to 1e-6."""
    import optax

    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((3, 4, 2)).astype(np.float32)
    jopt = jsteps.make_optimizer("adam", 1e-2)
    topt = tsteps.make_optimizer("adam", 1e-2)
    jp = jnp.asarray(p0)
    js = jax.vmap(jopt.init)(jp)
    tp = torch.from_numpy(p0.copy())
    ts = {"count": torch.zeros(3, dtype=torch.int32), "mu": {"w": torch.zeros(3, 4, 2)},
          "nu": {"w": torch.zeros(3, 4, 2)}}
    for step in range(4):
        g = rng.standard_normal((3, 4, 2)).astype(np.float32)
        gate = np.array([1, step % 2, step < 1], bool)
        u, ns = jax.vmap(jopt.update)(jnp.asarray(g), js, jp)
        nj = optax.apply_updates(jp, u)
        gj = jnp.asarray(gate).reshape(3, 1, 1)
        jp = jnp.where(gj, nj, jp)
        js = jax.tree.map(lambda n, o: jnp.where(jnp.asarray(gate).reshape(
            (3,) + (1,) * (n.ndim - 1)), n, o), ns, js)
        upd, nts = topt.update({"w": torch.from_numpy(g)}, ts)
        tg = torch.from_numpy(gate)
        tp = torch.where(tg.reshape(3, 1, 1), tp + upd["w"], tp)
        ts = tsteps._freeze_dead(tg, nts, ts)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ts["count"].numpy(), np.asarray(js[0].count))


def test_icalstm_site_eval_equals_the_folded_eval():
    """``ICALstm.site_forward`` in eval mode with every site on the global
    head gives the folded eval's logits (two LSTM calls a step either way,
    no dropout at the model's rate): within 1e-6 (batched products per
    site against one over the folded rows)."""
    torch.manual_seed(0)
    model = tm.ICALstm(input_size=8, hidden_size=6, num_comps=3, window_size=4, num_cls=2)
    model.eval()
    x = torch.randn(3, 2, 5, 3, 4)
    params = {k: v.detach().unsqueeze(0).expand(3, *v.shape)
              for k, v in model.named_parameters()}
    stats = dict(model.named_buffers())
    with torch.inference_mode():
        want = model(x.reshape(6, 5, 3, 4), train=False).reshape(3, 2, -1)
        got, _ = model.site_forward(params, x, None, stats, train=False)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
