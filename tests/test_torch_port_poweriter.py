"""The port's power iteration (``engines/lowrank.py`` and the plain version
of kernel K7 in ``ops/poweriter_cuda.py``) against the JAX package's two
paths: the legacy ``lowrank.subspace_iteration_grouped(fused=False)`` and
the Pallas kernel ``poweriter_pallas.fused_subspace_iteration_grouped``
run in interpret mode on the CPU.

Inputs are made with numpy from a seed; Ω crosses as numpy (the port draws
its own cold-start Ω, from another generator). The kernel itself runs only
on the card, where ``chip_smoke.py`` holds it against ``poweriter_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import lowrank as jl
from dinunet_implementations_tpu.ops import poweriter_pallas as pp
from dinunet_implementations_tpu_torch.engines import lowrank as tl
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc

ITERS = 5
# f32: the port and JAX sum the products in other orders; the two JAX paths
# differ by 1.2e-7 on these inputs, the port by as much
F32_TOL = 1e-5
# bf16 operands: both sides round the same f32 values to bf16, but an f32
# intermediate one ulp apart can round to the neighbouring bf16 value
# (2**-9 relative), which the next product carries
BF16_TOL = 1e-3


def _low_rank(rng, m, n, k):
    return ((rng.standard_normal((m, k)) @ rng.standard_normal((k, n))) / np.sqrt(k)).astype(
        np.float32)


def _groups(seed=0):
    """Two rank classes, several shape buckets: r=4 holds full-rank members
    of two shapes (a duplicate shape shares a bucket), rank-deficient
    members of rank 6 > r and of rank exactly r, and an all-zero member;
    r=2 holds a [9, 2] member and a full-rank [6, 5] one."""
    rng = np.random.default_rng(seed)
    cls4 = [rng.standard_normal((12, 7)), rng.standard_normal((9, 7)),
            rng.standard_normal((12, 7)), _low_rank(rng, 14, 9, 6), _low_rank(rng, 10, 8, 4),
            np.zeros((7, 5))]
    cls2 = [rng.standard_normal((9, 2)), rng.standard_normal((6, 5))]
    return [([g.astype(np.float32) for g in cls4], 4), ([g.astype(np.float32) for g in cls2], 2)]


def _cold(groups):
    return [[np.asarray(jl.default_omega(jnp.asarray(g), r)) for g in gs] for gs, r in groups]


def _warm(groups, seed=1):
    """Warm starts: the Q of a factorization of a perturbed G (the next
    round's gradient shares most of this one's subspace)."""
    rng = np.random.default_rng(seed)
    out = []
    for gs, r in groups:
        prev = [jnp.asarray(g + 0.05 * rng.standard_normal(g.shape).astype(np.float32)) for g in gs]
        res = jl.subspace_iteration_grouped([(prev, r, None)], ITERS, 1e-3)[0]
        out.append([np.asarray(q) for _, q in res])
    return out


def _jax(groups, oms, tol, bf16, fused):
    jg = [([jnp.asarray(g) for g in gs], r, [jnp.asarray(o) for o in om])
          for (gs, r), om in zip(groups, oms)]
    dt = jnp.bfloat16 if bf16 else None
    if fused:
        out = pp.fused_subspace_iteration_grouped(jg, ITERS, tol, matmul_dtype=dt)
    else:
        out = jl.subspace_iteration_grouped(jg, ITERS, tol, matmul_dtype=dt, fused=False)
    return [[(np.asarray(p), np.asarray(q)) for p, q in cls] for cls in out]


def _port(groups, oms, tol, bf16):
    tg = [([torch.from_numpy(g) for g in gs], r, [torch.from_numpy(o) for o in om])
          for (gs, r), om in zip(groups, oms)]
    out = tl.subspace_iteration_grouped(tg, ITERS, tol,
                                        matmul_dtype=torch.bfloat16 if bf16 else None)
    return [[(p.numpy(), q.numpy()) for p, q in cls] for cls in out]


def _assert_factors_close(got, want, tol):
    for ci, (gc, wc) in enumerate(zip(got, want, strict=True)):
        for mi, ((gp, gq), (wp, wq)) in enumerate(zip(gc, wc, strict=True)):
            where = f"class {ci} member {mi}"
            assert gp.shape == wp.shape and gq.shape == wq.shape, where
            np.testing.assert_allclose(gp, wp, atol=tol, rtol=0, err_msg=f"{where} P")
            np.testing.assert_allclose(gq, wq, atol=tol, rtol=0, err_msg=f"{where} Q")
            np.testing.assert_allclose(gp @ gq.T, wp @ wq.T, atol=tol, rtol=0,
                                       err_msg=f"{where} PQᵀ")


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("tol", [1e-3, 0.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_matches_jax_legacy(start, tol, dtype):
    groups = _groups()
    oms = _cold(groups) if start == "cold" else _warm(groups)
    bf16 = dtype == "bf16"
    got = _port(groups, oms, tol, bf16)
    _assert_factors_close(got, _jax(groups, oms, tol, bf16, fused=False),
                          BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_kernel_version_matches_jax_pallas_interpret(dtype):
    """``poweriter_plain`` on the class's shape buckets, as the kernel takes
    them, against the Pallas kernel it replaces."""
    groups = _groups(seed=2)
    oms = _warm(groups, seed=3)
    bf16 = dtype == "bf16"
    want = _jax(groups, oms, 1e-3, bf16, fused=True)
    got = []
    for (gs, _), om in zip(groups, oms):
        P, Q, trips = pc.poweriter_plain([torch.from_numpy(g)[None] for g in gs],
                                         [torch.from_numpy(o)[None] for o in om], ITERS, 1e-3,
                                         torch.bfloat16 if bf16 else None)
        assert trips.dtype == torch.int32 and trips.shape == (len(gs),)
        got.append([(p[0].numpy(), q[0].numpy()) for p, q in zip(P, Q)])
    _assert_factors_close(got, want, BF16_TOL if bf16 else F32_TOL)


def test_trip_counts_follow_each_members_own_convergence():
    """A member warm-started from its own right singular subspace (the
    steady state of warm starts: Ω = the last round's Q = VΣ) converges in
    one refinement, a full-rank Gaussian one runs every trip, the zero
    member stops after one. The trips are JAX's per-member semantics:
    stopping JAX's loop after a member's trip count gives bitwise its
    result at the full count (the member was frozen), and one trip fewer
    does not."""
    groups = [_groups()[0]]
    oms = _cold(groups)
    gs, r = groups[0]
    _, sv, vt = np.linalg.svd(gs[4])
    oms[0][4] = (vt[:r].T * sv[:r]).astype(np.float32)
    stack = [torch.from_numpy(g)[None] for g in gs]
    _, _, trips = pc.poweriter_plain(stack, [torch.from_numpy(o)[None] for o in oms[0]], ITERS,
                                     1e-3)
    trips = trips.tolist()
    assert trips[0] == ITERS and trips[4] == 1 and trips[5] == 1, trips
    full = jl.subspace_iteration_grouped(
        [([jnp.asarray(g) for g in gs], r, [jnp.asarray(o) for o in oms[0]])], ITERS, 1e-3)[0]
    for i, t in enumerate(trips):
        cut = jl.subspace_iteration_grouped(
            [([jnp.asarray(g) for g in gs], r, [jnp.asarray(o) for o in oms[0]])], t, 1e-3)[0]
        np.testing.assert_array_equal(np.asarray(cut[i][0]), np.asarray(full[i][0]))
        if t < ITERS and np.abs(gs[i]).max() > 0:
            short = jl.subspace_iteration_grouped(
                [([jnp.asarray(g) for g in gs], r, [jnp.asarray(o) for o in oms[0]])],
                t - 1, 1e-3)[0]
            assert not np.array_equal(np.asarray(short[i][0]), np.asarray(full[i][0]))


def test_rank_below_r_reconstruction_matches_jax():
    """Members whose rank is below r: their columns past the rank are
    orthonormalized rounding noise, on which JAX's own two paths disagree
    at O(1) in P. The reconstruction PQᵀ, which is what the engine ships,
    agrees to the scale of that noise: JAX's two paths differ by up to
    2.3e-4·max|G| on such members (seeds 0-7), and each recovers G to
    ~1e-4·max|G|, so the port is held at 5e-4·max|G| to the legacy path
    and to G itself."""
    rng = np.random.default_rng(7)
    gs = [_low_rank(rng, 10, 10, 2), _low_rank(rng, 8, 6, 1)]
    oms = [[np.asarray(jl.default_omega(jnp.asarray(g), 4)) for g in gs]]
    want = _jax([(gs, 4)], oms, 1e-3, False, fused=False)[0]
    got = _port([(gs, 4)], oms, 1e-3, False)[0]
    for g, (gp, gq), (wp, wq) in zip(gs, got, want):
        tol = 5e-4 * np.abs(g).max()
        np.testing.assert_allclose(gp @ gq.T, wp @ wq.T, atol=tol, rtol=0)
        np.testing.assert_allclose(gp @ gq.T, g, atol=tol, rtol=0)


def test_cholqr_and_lp_matmul_match_jax():
    rng = np.random.default_rng(4)
    ys = [rng.standard_normal((11, 4)).astype(np.float32), np.zeros((6, 3), np.float32),
          _low_rank(rng, 9, 4, 2)]
    for y in ys:
        (wq,), (wn,) = jl._cholqr_multi([jnp.asarray(y)])
        gq, gn = tl._cholqr_multi(torch.from_numpy(y)[None])
        np.testing.assert_allclose(gn[0].numpy(), np.asarray(wn), atol=1e-6, rtol=1e-6)
        if np.linalg.matrix_rank(y) == y.shape[1] or not y.any():
            # full rank or zero: the same orthonormal Q (a rank-deficient Y's
            # columns past its rank are rounding noise, as in JAX)
            qq = gq[0].numpy()
            np.testing.assert_allclose(qq, np.asarray(wq), atol=F32_TOL, rtol=0)
            np.testing.assert_allclose(qq.T @ qq, np.eye(y.shape[1]), atol=1e-5)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = rng.standard_normal((7, 3)).astype(np.float32)
    for dt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_allclose(
            tl.lp_matmul(torch.from_numpy(a), torch.from_numpy(b), tdt).numpy(),
            np.asarray(jl.lp_matmul(jnp.asarray(a), jnp.asarray(b), dt)), atol=1e-6, rtol=1e-6)


def test_shapes_groups_and_default_omega():
    g = {"w": torch.zeros(3, 4, 5), "b": torch.zeros(5), "thin": torch.zeros(1, 5)}
    want = jl.lowrank_rank_groups({k: jnp.zeros(v.shape) for k, v in g.items()}, 10)
    assert tl.lowrank_rank_groups(g, 10) == (want[0], want[1])
    assert tl.to_matrix(g["w"]).shape == (12, 5)
    assert tl.from_matrix(torch.ones(12, 5), g["w"]).shape == (3, 4, 5)
    om = tl.default_omega(torch.zeros(12, 5), 3)
    assert om.shape == (5, 3) and om.dtype == torch.float32
    assert torch.equal(om, tl.default_omega((12, 5), 3))  # the per-shape draw is fixed
    assert not torch.equal(om[:, 0], tl.default_omega((13, 5), 3)[:, 0])
    assert tl.subspace_iteration_grouped([], ITERS, 1e-3) == []


def test_fused_wrapper_runs_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(5)
    G = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    om = torch.from_numpy(rng.standard_normal((3, 6, 2)).astype(np.float32))
    before = pc.POWERITER_LAUNCHES
    got = pc.poweriter_fused(G, om, ITERS, 1e-3)
    want = pc.poweriter_plain(G, om, ITERS, 1e-3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert pc.POWERITER_LAUNCHES == before  # the CPU path launches nothing
    # a transposed view (how the engine hands an nn.Linear weight over)
    # gives the same factors as the contiguous matrix
    Gt = G.transpose(1, 2).contiguous().transpose(1, 2)
    for a, b in zip(pc.poweriter_plain(Gt, om, ITERS, 1e-3), want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    G = torch.zeros(2, 8, 6)
    with pytest.raises(ValueError, match="one CUDA device"):
        pc.poweriter_fused(G, torch.zeros(2, 6, 2, device="meta"), ITERS, 1e-3)
    # the shared-memory gate is computed before any launch
    assert pc.class_smem_bytes([(1000, 696)], 10) == 4 * 10 * 1696
    assert pc.class_smem_bytes([(1000, 256), (256, 696)], 10) <= pc.SMEM_LIMIT
    assert pc.class_smem_bytes([(4000, 2000)], 16) > pc.SMEM_LIMIT


def test_k7_shape_gate_refuses_what_the_kernel_does_not_take():
    """``k7_takes``: the static per-class gate, as JAX's ``class_fits_vmem``."""
    flagship = [(1000, 256), (256, 696), (174, 696), (696, 174), (348, 256), (256, 64), (64, 2)]
    assert pc.k7_takes(flagship, 10)
    assert pc.k7_takes([(64, 2)], 2)
    assert not pc.k7_takes(flagship, pc.MAX_RANK + 1)  # r = 17
    assert not pc.k7_takes([(32, 24)] * (pc.MAX_BUCKETS + 1), 10)  # 17 buckets
    assert pc.k7_takes([(32, 24)] * pc.MAX_BUCKETS, 10)
    big = [(4000, 3000)]
    assert pc.class_smem_bytes(big, 16) > pc.SMEM_LIMIT and not pc.k7_takes(big, 16)


def test_k7_launches_cut_a_class_of_more_than_16_buckets():
    """``k7_launches``: a class of at most 16 stacks is one launch in member
    order; a larger one is launches of at most 16, the stacks whose rows
    are whole 16-byte chunks first, so an unaligned one (rows of 66 values,
    the direct route's) shares the last launch; what the kernel takes at
    no launch (r = 17, iterates over the shared-memory limit) is None."""
    def stack(m, n, transposed=False):
        return torch.zeros(2, n, m).transpose(1, 2) if transposed else torch.zeros(2, m, n)

    assert pc.k7_launches([stack(32, 24)] * pc.MAX_BUCKETS, 10) == [list(range(16))]
    odd = stack(66, 256, transposed=True)  # A = Gᵀ has rows of 66 values
    assert not pc._aligned(odd) and pc._aligned(stack(32, 24))
    Gs = [odd] + [stack(32, 24)] * 17 + [stack(48, 24, transposed=True)]
    launches = pc.k7_launches(Gs, 10)
    assert launches == [list(range(1, 17)), [0, 17, 18]]
    assert all(pc.k7_takes([tuple(Gs[k].shape[1:]) for k in ks], 10) for ks in launches)
    assert pc.k7_launches([stack(32, 24)] * 40, 10) == [
        list(range(16)), list(range(16, 32)), list(range(32, 40))]
    assert pc.k7_launches(Gs, pc.MAX_RANK + 1) is None
    assert pc.k7_launches([stack(4000, 3000)], 16) is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_class_of_more_than_16_buckets_takes_several_launches_and_matches_jax(dtype):
    """A class of 18 buckets through the engine with ``use_kernel=True``:
    cut into launches (on the CPU each runs the plain version), not sent to
    the plain version by shape, its factors in member order equal to the
    one plain call's bit for bit and to JAX's legacy loop at the tolerance
    of ``test_grouped_matches_jax_legacy``."""
    rng = np.random.default_rng(21)
    shapes = [(12, 7), (9, 7), (14, 9), (10, 8), (7, 5), (11, 6)] * 3
    cls = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cls[4] = _low_rank(rng, 7, 5, 4)  # rank exactly r
    groups = [(cls, 4)]
    oms = _warm(groups, seed=22)
    bf16 = dtype == "bf16"
    mm = torch.bfloat16 if bf16 else None
    tg = [([torch.from_numpy(g) for g in cls], 4, [torch.from_numpy(o) for o in oms[0]])]
    assert len(pc.k7_launches([g[None] for g in tg[0][0]], 4)) == 2
    before = tl.POWERITER_PLAIN_CLASSES
    got = tl.subspace_iteration_grouped(tg, ITERS, 1e-3, matmul_dtype=mm)
    assert tl.POWERITER_PLAIN_CLASSES == before
    plain = tl.subspace_iteration_grouped(tg, ITERS, 1e-3, matmul_dtype=mm, use_kernel=False)
    for (p, q), (pp_, qp) in zip(got[0], plain[0], strict=True):
        assert torch.equal(p, pp_) and torch.equal(q, qp)
    _assert_factors_close([[(p.numpy(), q.numpy()) for p, q in got[0]]],
                          _jax(groups, oms, 1e-3, bf16, fused=False),
                          BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("tol", [1e-3, 0.0])
def test_rank_above_the_kernel_goes_to_the_plain_loop_and_matches_jax(tol):
    """An r = 17 class (``dad_reduction_rank`` > 16, valid in JAX) is routed
    to the plain version before any launch and counted; its factors match
    JAX's legacy loop at the tolerance of ``test_grouped_matches_jax_legacy``.
    A class K7 takes is not counted."""
    rng = np.random.default_rng(8)
    cls17 = [rng.standard_normal((24, 20)).astype(np.float32), _low_rank(rng, 30, 18, 17),
             rng.standard_normal((24, 20)).astype(np.float32)]
    groups = [(cls17, 17), _groups()[1]]
    oms = _cold(groups)
    before = tl.POWERITER_PLAIN_CLASSES
    got = _port(groups, oms, tol, False)
    assert tl.POWERITER_PLAIN_CLASSES == before + 1
    _assert_factors_close(got, _jax(groups, oms, tol, False, fused=False), F32_TOL)
    # the same classes on the plain path by request are not a routing decision
    tg = [([torch.from_numpy(g) for g in gs], r, None) for gs, r in groups]
    tl.subspace_iteration_grouped(tg, ITERS, tol, use_kernel=False)
    assert tl.POWERITER_PLAIN_CLASSES == before + 1
