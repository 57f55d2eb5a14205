"""K3/K5's launch geometry (``ops/bilstm_cuda.py:bidir_geometry``) and the
data flow of their cluster recurrence, checked on the CPU before the card is
touched.

The cluster route runs both directions in one launch: the first half of the
clusters direction 0, the second half direction 1. Block k of a cluster owns
hidden units ``[j0[k], j0[k + 1])`` of its direction with all four gates of
them; the blocks exchange h once a step through a double buffer; the reverse
direction reads ``xp2[T-1-s]`` at its step s and stores at x-time ``T-1-s``;
K5 sums each owned (row, unit)'s f32 h in the block. ``_cluster_emulation``
runs that data flow in plain PyTorch over the projection
``bilstm_proj_plain`` and is held against ``bilstm_fwd_plain``; the
projection followed by a plain recurrence is also held against the JAX
package's Pallas kernels (interpret mode). ``chip_smoke.py`` holds the
kernels themselves against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.ops import lstm_pallas as jl
from dinunet_implementations_tpu_torch.ops import bilstm_cuda as tb
from dinunet_implementations_tpu_torch.ops import lstm_cuda as tl

H100_SMS, H100_SMEM = 132, 232448
#: cudaOccupancyMaxActiveClusters of clusters of 4 on an H100: a GPC holds
#: whole clusters only, so 30, not 132 // 4 = 33
H100_SLOTS = {4: 30}
STATIC_SMEM = 1024  # kept free beside the dynamic share (column map, owner table)
FLAGSHIP_H = 174
# the emulation sums each gate column's product over the rank's own slice
# of W_hh, in f32: the same terms as the plain version in another order
EMULATION_TOL = 1e-6
# tests/test_torch_port_bidir.py's tolerances against the Pallas kernels:
# f32, the two frameworks sum in other orders; bf16, a last-bit flip of a
# bf16 stream or operand (2**-8 relative) moves later values
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
T, D, H, B, S = 6, 5, 8, 4, 3


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("rows", [1, 16, 512])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_flagship_geometry_is_one_wave_of_both_directions_under_the_opt_in(rows, dtype, pool):
    g = tb.bidir_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM, H100_SLOTS, pool)
    assert g["route"] == "cluster" and g["waves"] == 1 and g["pool"] == pool
    slots = H100_SLOTS.get(g["C"], H100_SMS // g["C"])
    assert g["blocks"] == 2 * g["clusters"] * g["C"] and 2 * g["clusters"] <= slots
    assert g["clusters"] * g["R"] >= rows > (g["clusters"] - 1) * g["R"]
    assert g["smem"] + STATIC_SMEM <= H100_SMEM and g["threads"] <= 1024
    assert g["rp"] >= g["R"] and g["threads"] % 32 == 0
    if dtype is None:  # the f32 W_hh slice of a cluster of 2 is 242 KB
        assert g["C"] == 4 and g["j0"] == [0, 44, 88, 131, 174]
        # each thread a 2-column tile of its rows: 2 · cp >= 4 · smax columns
        assert 2 * (g["threads"] // g["row_groups"]) >= 4 * g["smax"]
    if rows == 512 and dtype is None:
        assert (g["R"], g["clusters"], g["rpt"], g["rp"]) == (35, 15, 8, 40)
        # W_hh 122,496 + h 27,840 + exchange 14,432 + pre 28,160 + carry
        # 7,040 (+ pool 7,040): narrow under the opt-in
        assert g["smem"] == (207_008 if pool else 199_968)


@pytest.mark.parametrize("H_", [8, 174, 175])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_slices_cover_the_hidden_units_exactly(H_, dtype):
    for rows in (1, 16, 512):
        g = tb.bidir_geometry(rows, H_, dtype, H100_SMS, H100_SMEM, H100_SLOTS)
        assert g["route"] == "cluster" and g["j0"] == tl.k1_column_map(H_, g["C"])
        sizes = np.diff(g["j0"])
        assert sizes.min() >= 1 and g["smax"] == sizes.max()
        owned = np.concatenate([np.arange(a, b) for a, b in zip(g["j0"][:-1], g["j0"][1:])])
        np.testing.assert_array_equal(owned, np.arange(H_))  # no gap, no overlap


def test_an_H_that_fits_no_cluster_of_8_takes_the_stream_route():
    g = tb.bidir_geometry(512, 400, None, H100_SMS, H100_SMEM)
    assert g["route"] == "stream"
    # the first design's kernel: the fewest rows a block (1, 2, 4, 8) that
    # keep both directions' blocks within the SMs
    assert (g["R"], g["blocks"], g["waves"]) == (8, 128, 1)
    assert [tb.bidir_stream_geometry(r, 400, H100_SMS)["R"] for r in (65, 66, 67, 131, 264)] == \
        [1, 1, 2, 2, 4]
    assert tb.bidir_geometry(16, 20000, torch.bfloat16, H100_SMS, H100_SMEM)["route"] == "stream"
    # a cluster of 8 holds H = 256 in f32 (the W_hh slice 131 KB), not in
    # clusters of 2 or 4
    assert tb.bidir_geometry(512, 256, None, H100_SMS, H100_SMEM)["C"] == 8


def test_clusters_the_card_runs_at_once_set_the_rows_a_cluster():
    """Both directions share the card's cluster slots: at 30 slots of 4,
    512 rows take 35 rows a cluster in 15 clusters a direction; 32 rows a
    cluster (16 a direction) would take two waves."""
    two = tb.bidir_cluster_geometry(512, FLAGSHIP_H, 4, 32, None, H100_SMEM, 30)
    assert two["clusters"] == 16 and two["waves"] == 2
    g = tl.settle_geometry(
        lambda slots: tb.bidir_geometry(512, FLAGSHIP_H, None, H100_SMS, H100_SMEM, slots),
        lambda geo: 30)
    assert (g["C"], g["R"], g["clusters"], g["waves"]) == (4, 35, 15, 1)


def _c_smem(g, H_, dtype):
    """The dynamic shared memory the C side carves for this geometry
    (``csrc/bilstm_fwd.cu``), worked out independently of the Python
    launcher."""
    smax, rp, C = g["smax"], g["rp"], g["C"]
    assert smax == -(-H_ // C)
    pool = rp * smax if g["pool"] else 0
    if dtype is None:  # lstm_cluster.cuh:cluster_smem_bytes + the pool sums
        wst = 4 * smax
        return (-(-H_ * wst * 4 // 16) * 16
                + 4 * (H_ * rp + 2 * smax * (rp | 1) + rp * wst + rp * smax + pool))
    nw = -(-4 * smax // 8) * 8  # mma_smem_bytes: wT, hA, exchange, pre, carry, pool
    ks = -(-H_ // 16) * 16 + 8
    return (-(-nw * ks * 2 // 16) * 16 + -(-rp * ks * 2 // 16) * 16
            + 4 * (2 * smax * (rp | 1) + rp * (nw + 8) + rp * smax + pool))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_geometry_record_is_what_the_c_entry_reads(dtype):
    for rows, pool in ((1, False), (16, True), (512, True)):
        g = tb.bidir_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM, H100_SLOTS, pool)
        v = list(tl._geom_ints(g))
        assert len(v) == 17 and v[0] == 1
        assert v[1:8] == [g["C"], g["R"], g["rpt"], g["row_groups"], g["threads"], g["smem"],
                          g["smax"]]
        assert v[8:9 + g["C"]] == g["j0"] and g["rp"] == g["rpt"] * g["row_groups"]
        assert g["smem"] == _c_smem(g, FLAGSHIP_H, dtype)
        if dtype is None:  # a thread's tile: 1, 2, 4 or 8 rows
            assert g["rpt"] in (1, 2, 4, 8)
            assert g["threads"] <= (640 if g["rpt"] == 8 else 512)
        else:  # the mma's 16-row tiles, at most 3; a warp for each pair of n-tiles
            n_tiles = -(-4 * g["smax"] // 8)  # 8 columns each
            assert g["rpt"] == 16 and g["row_groups"] <= 3 and g["threads"] <= 704
            assert g["threads"] >= 32 * -(-n_tiles // 2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _recurrence_over_xp2(xp2, whh2, h02, c02, cdt=None):
    """Both directions' plain loops over the projection ``xp2 [T, B, 8H]``
    (bias inside): the streams [2, T, B, H] in x-time, the carries after
    each direction's own last step, and K5's pool."""
    sdt = torch.bfloat16 if cdt else torch.float32
    T_, B_, _ = xp2.shape
    H_ = whh2.shape[-1]
    streams = torch.zeros((6, 2, T_, B_, H_))
    carries, pools = [], []
    for d in (0, 1):
        whh = whh2[d].to(sdt).float().permute(1, 0, 2).reshape(H_, 4 * H_)
        h, c, total = h02[d], c02[d], torch.zeros((B_, H_))
        for s in range(T_):
            t = T_ - 1 - s if d else s
            pre = xp2[t, :, 4 * H_ * d:4 * H_ * (d + 1)] + h.to(sdt).float() @ whh
            i, f, o = (torch.sigmoid(pre[:, q * H_:(q + 1) * H_]) for q in range(3))
            g = torch.tanh(pre[:, 3 * H_:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            total = total + h
            for n, v in enumerate((h, c, i, f, o, g)):
                streams[n, d, t] = v
        carries.append((h, c))
        pools.append(total / T_)
    return ([s.to(sdt) for s in streams] + [torch.stack([h for h, _ in carries]),
                                            torch.stack([c for _, c in carries]),
                                            torch.cat(pools, -1)])


def _cluster_emulation(x, wih2, b2, whh2, h02, c02, g):
    """The cluster kernel's data flow in plain PyTorch, f32: for each
    direction, clusters of ``R`` rows; per step s each rank gathers h from
    every rank's ``buf[s % 2]``, computes all four gates of its own units
    from ``xp2[t]`` (t = T-1-s for the reverse direction) and its own W_hh
    columns, writes its new h into its own ``buf[(s + 1) % 2]``, stores its
    streams at x-time t and adds the f32 h to its own pool sums."""
    T_, B_, _ = x.shape
    H_ = whh2.shape[-1]
    C, R, j0 = g["C"], g["R"], g["j0"]
    xp2 = tb.bilstm_proj_plain(x, wih2, b2)
    streams = torch.full((6, 2, T_, B_, H_), float("nan"))
    hT, cT, pool = (torch.full(s, float("nan")) for s in ((2, B_, H_), (2, B_, H_), (B_, 2 * H_)))
    own = [slice(j0[k], j0[k + 1]) for k in range(C)]
    for d in (0, 1):
        whh = whh2[d].permute(1, 0, 2).reshape(H_, 4 * H_)
        for row0 in range(0, B_, R):
            rows = slice(row0, min(B_, row0 + R))
            buf = [[h02[d, rows, u].clone(), None] for u in own]
            carry = [c02[d, rows, u].clone() for u in own]
            sums = [torch.zeros_like(c) for c in carry]
            for s in range(T_):
                t = T_ - 1 - s if d else s
                h_prev = torch.cat([buf[k][s % 2] for k in range(C)], -1)  # the gather
                for k, u in enumerate(own):
                    cols = [4 * H_ * d + q * H_ + j for q in range(4) for j in range(u.start, u.stop)]
                    wcols = [q * H_ + j for q in range(4) for j in range(u.start, u.stop)]
                    pre = xp2[t, rows][:, cols] + h_prev @ whh[:, wcols]
                    n = u.stop - u.start
                    i, f, o = (torch.sigmoid(pre[:, q * n:(q + 1) * n]) for q in range(3))
                    gg = torch.tanh(pre[:, 3 * n:])
                    carry[k] = f * carry[k] + i * gg
                    h = o * torch.tanh(carry[k])
                    buf[k][(s + 1) % 2] = h
                    sums[k] = sums[k] + h
                    for m, v in enumerate((h, carry[k], i, f, o, gg)):
                        streams[m, d, t, rows, u] = v
            hT[d, rows] = torch.cat([buf[k][T_ % 2] for k in range(C)], -1)
            cT[d, rows] = torch.cat(carry, -1)
            pool[rows, d * H_:(d + 1) * H_] = torch.cat(sums, -1) / T_
    return (*streams, hT, cT, pool)


def test_ownership_map_and_time_map_reproduce_the_plain_forward():
    T_, B_, D_, H_ = 6, 5, 7, 10
    # 16 SMs and a small opt-in force clusters of 4 (a cluster of 2 does not
    # fit), ragged slices 3/3/2/2 and ragged rows: 2 clusters of 3 rows a
    # direction
    g = tb.bidir_geometry(B_, H_, None, sms=16, smem_optin=2100)
    assert (g["C"], g["R"], g["clusters"]) == (4, 3, 2) and g["j0"] == [0, 3, 6, 8, 10]
    rng = np.random.default_rng(0)
    args = (_rand(rng, T_, B_, D_), _rand(rng, 2, 4, D_, H_, scale=0.3),
            _rand(rng, 2, 4, H_, scale=0.1), _rand(rng, 2, 4, H_, H_, scale=0.3),
            _rand(rng, 2, B_, H_, scale=0.5), _rand(rng, 2, B_, H_, scale=0.5))
    want = tb.bilstm_fwd_plain(*args, pool=True)
    got = _cluster_emulation(*args, g)
    names = ("hs2", "cs2", "i2", "f2", "o2", "g2", "hT2", "cT2", "pool")
    for name, a, b in zip(names, got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=EMULATION_TOL, rtol=0, err_msg=name)


def _site_rows(a):
    """[S, T, B, ·] site-native → [T, S·B, ·] site-major rows."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return np.array(a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1, a.shape[-1]))


@pytest.mark.parametrize("cdt,tol", [(None, F32), (torch.bfloat16, BF16)])
def test_projection_then_recurrence_matches_the_plain_forward_and_pallas(cdt, tol):
    rng = np.random.default_rng(1)
    x4 = rng.standard_normal((S, T, B, D)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
         (((2, 4, D, H), 0.4), ((2, 4, H), 0.2), ((2, 4, H, H), 0.4))]
    h4, c4 = ((rng.standard_normal((2, S, B, H)) * 0.5).astype(np.float32) for _ in "hc")
    x = torch.from_numpy(_site_rows(x4))
    wih2, b2, whh2 = map(torch.from_numpy, w)
    h02, c02 = (torch.from_numpy(np.ascontiguousarray(a.reshape(2, S * B, H))) for a in (h4, c4))
    xp2 = tb.bilstm_proj_plain(x, wih2, b2, cdt)
    assert xp2.shape == (T, S * B, 8 * H) and xp2.dtype == torch.float32
    got = _recurrence_over_xp2(xp2, whh2, h02, c02, cdt)
    plain = tb.bilstm_fwd_plain(x, wih2, b2, whh2, h02, c02, cdt, pool=True)
    names = ("hs2", "cs2", "i2", "f2", "o2", "g2", "hT2", "cT2", "pool")
    for name, a, b in zip(names, got, plain, strict=True):
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), err_msg=name, **tol)

    jcdt = jnp.bfloat16 if cdt else None
    # K5's Pallas kernel: x [S, T, B, D], carries [2, S, B, H]
    want = jl._fwd_pool_call4(*map(jnp.asarray, (x4, *w, h4, c4)), compute_dtype=jcdt)
    for k in range(6):
        for d in (0, 1):
            np.testing.assert_allclose(got[k][d].float().numpy(), _site_rows(want[6 * d + k]),
                                       err_msg=f"{names[k]}[{d}]", **tol)
    for k, name in ((12, "hT2"), (13, "cT2")):
        np.testing.assert_allclose(got[k - 6].numpy(), np.asarray(want[k]).reshape(2, S * B, H),
                                   err_msg=name, **tol)
    pool = np.concatenate([np.asarray(want[14]), np.asarray(want[15])], -1).reshape(S * B, 2 * H)
    np.testing.assert_allclose(got[8].numpy(), pool, err_msg="pool", **tol)
    # K3's Pallas kernel on the same rows, unbatched
    want = jl._fwd_bidir_call(*map(jnp.asarray, (x.numpy(), *w, h02.numpy(), c02.numpy())),
                              compute_dtype=jcdt)
    for k in range(6):
        for d in (0, 1):
            np.testing.assert_allclose(got[k][d].float().numpy(),
                                       np.asarray(jnp.asarray(want[6 * d + k], jnp.float32)),
                                       err_msg=f"K3 {names[k]}[{d}]", **tol)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[12]), err_msg="K3 hT2", **tol)
    np.testing.assert_allclose(got[7].numpy(), np.asarray(want[13]), err_msg="K3 cT2", **tol)


def test_route_counters_stay_still_on_the_cpu():
    rng = np.random.default_rng(2)
    args = (_rand(rng, 4, 3, 5), _rand(rng, 2, 4, 5, 6), _rand(rng, 2, 4, 6),
            _rand(rng, 2, 4, 6, 6), _rand(rng, 2, 3, 6), _rand(rng, 2, 3, 6))
    names = ("BIDIR_FWD_LAUNCHES", "POOL_FWD_LAUNCHES", "BIDIR_PROJ_LAUNCHES",
             "BIDIR_CLUSTER_CALLS", "BIDIR_STREAM_CALLS")
    before = [getattr(tb, n) for n in names]
    tb.bilstm_fwd_fused(*args)
    tb.bilstm_fwd_fused(*args, residuals=False)
    tb.bilstm_pool_fwd_fused(*args)
    xp2 = tb.bilstm_proj_fused(*args[:3])
    assert torch.equal(xp2, tb.bilstm_proj_plain(*args[:3]))
    assert [getattr(tb, n) for n in names] == before
