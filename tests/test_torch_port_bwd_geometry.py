"""K2's, K4's and K6's cluster BPTT (``csrc/lstm_bwd_cluster.cuh``): the
launch geometry (``ops/lstm_cuda.py:bwd_geometry``, ``ops/bilstm_cuda.py:
bidir_bwd_geometry``, K4's own occupancy and cache key) and the data flow of
the reduce-scatter, checked on the CPU before the card is touched.

Block q of a cluster owns hidden units ``[j0[q], j0[q + 1])`` of its
direction. Per step it computes the four dp of its units, multiplies them by
its rows of W_hhᵀ into a partial dh of all H columns (its own double
buffer), and, after the cluster barrier, sums its units' slice of every
rank's partials in rank order: the next dh carry. ``_bptt_emulation`` runs
that data flow rank by rank in plain PyTorch, for one direction with a dhs
stream (K2), for two directions with the x-time map and dhs at the stream
dtype, a full stream or a per-row constant (K4), and with an f32 per-row
constant (K6), and is held against ``lstm_bwd_plain`` / ``bilstm_bwd_plain``
and the JAX package's Pallas kernels (interpret mode). ``chip_smoke.py``
holds the kernels themselves against the plain versions on the card.
"""

import contextlib
from pathlib import Path

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
STATIC_SMEM = 1024  # kept free beside the dynamic share
FLAGSHIP_H = 174
# The emulation and the plain version sum the same products in other
# orders (C partial sums over unit slices, in rank order, against four
# per-gate products): f32 agrees to rounding. In bf16 both round dp to the
# bf16 operand; a last-bit flip of one operand (2**-8 relative) moves the
# carries of earlier steps, so bf16 is held at the port's bf16 tolerance.
EMULATION_F32 = dict(atol=1e-6, rtol=0)
# against the Pallas kernels, as tests/test_torch_port_lstm_bwd.py and
# tests/test_torch_port_bidir.py: f32, the two frameworks sum in other
# orders, compounded over the reversed recurrence; bf16 as above
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
DTYPES = [(None, EMULATION_F32, F32), ("bfloat16", BF16, BF16)]


def _geometry(rows, dtype, dirs):
    return tl.bwd_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM, H100_SLOTS, dirs)


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("rows", [16, 512])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_flagship_geometry_is_one_wave_under_the_opt_in(rows, dtype, dirs):
    g = _geometry(rows, dtype, dirs)
    assert g["route"] == "cluster" and g["waves"] == 1 and g["dirs"] == dirs
    slots = H100_SLOTS.get(g["C"], H100_SMS // g["C"])
    assert g["blocks"] == dirs * g["clusters"] * g["C"] and dirs * g["clusters"] <= slots
    assert g["clusters"] * g["R"] >= rows > (g["clusters"] - 1) * g["R"]
    assert g["smem"] + STATIC_SMEM <= H100_SMEM and g["threads"] % 32 == 0
    if dtype is None:  # the f32 W_hhᵀ slice of a cluster of 2 is 242 KB
        assert g["C"] == 4 and g["j0"] == [0, 44, 88, 131, 174]
        assert g["threads"] <= 512 and g["rpt"] in (1, 2, 4, 8)
        # each thread a 2-column tile of its rows: 2 · cp >= H columns
        assert 2 * (g["threads"] // g["row_groups"]) >= FLAGSHIP_H
    else:  # the tensor cores: 16-row m-tiles, a warp a pair of n-tiles
        assert g["C"] == 2 and g["rpt"] == 16 and g["threads"] == 32 * 11
    if dirs == 2:
        assert g == tb.bidir_bwd_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM, H100_SLOTS)


@pytest.mark.parametrize("dirs,want", [
    # K6: 15 clusters a direction of 35 rows, 8 rows a thread in 5 row
    # groups; W 122,496 + dp 28,160 + partials 48,720 + carry 6,160
    (2, (35, 15, 8, 40, 480, 205_536)),
    # K2: 29 clusters of 18 rows, 4 rows a thread (8 would pad to 24)
    (1, (18, 29, 4, 20, 480, 164_800)),
])
def test_the_512_row_fold_fills_the_card_in_one_wave(dirs, want):
    g = tl.settle_geometry(
        lambda slots: tl.bwd_geometry(512, FLAGSHIP_H, None, H100_SMS, H100_SMEM, slots, dirs),
        lambda geo: 30)
    assert (g["R"], g["clusters"], g["rpt"], g["rp"], g["threads"], g["smem"]) == want
    assert g["waves"] == 1 and g["C"] == 4
    # 32 rows a cluster of K6 would take 16 clusters a direction: two waves
    assert tl.bwd_cluster_geometry(512, FLAGSHIP_H, 4, 32, None, H100_SMEM, 30, 2)["waves"] == 2


@pytest.mark.parametrize("H_", [8, 174, 175])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_slices_cover_the_hidden_units_exactly(H_, dtype):
    for dirs in (1, 2):
        for rows in (1, 16, 512):
            g = tl.bwd_geometry(rows, H_, dtype, H100_SMS, H100_SMEM, H100_SLOTS, dirs)
            assert g["route"] == "cluster" and g["j0"] == tl.k1_column_map(H_, g["C"])
            sizes = np.diff(g["j0"])
            assert sizes.min() >= 1 and g["smax"] == sizes.max()
            owned = np.concatenate([np.arange(a, b) for a, b in zip(g["j0"][:-1], g["j0"][1:])])
            np.testing.assert_array_equal(owned, np.arange(H_))  # no gap, no overlap


def test_an_H_that_fits_no_cluster_of_8_takes_the_stream_route():
    for dirs in (1, 2):
        g = tl.bwd_geometry(512, 400, None, H100_SMS, H100_SMEM, None, dirs)
        # the first design: the fewest rows a block (1, 2, 4, 8) that keep
        # every direction's blocks within its share of the SMs
        assert g["route"] == "stream" and g["dirs"] == dirs and g["waves"] == 1
        assert g["R"] == (8 if dirs == 2 else 4) and g["smem"] == 40 * g["R"] * 400
    assert tb.bidir_bwd_geometry(512, 400, None, H100_SMS, H100_SMEM)["route"] == "stream"
    assert [tl.bwd_stream_geometry(r, 400, H100_SMS, 2)["R"] for r in (65, 66, 67, 131, 264)] == \
        [1, 1, 2, 2, 4]
    assert [tl.bwd_stream_geometry(r, 400, H100_SMS)["R"] for r in (132, 133, 264, 265)] == \
        [1, 2, 2, 4]
    # bf16's slice of H = 400 fits a cluster of 8; a far wider H fits none
    assert tl.bwd_geometry(16, 400, torch.bfloat16, H100_SMS, H100_SMEM)["C"] == 8
    assert tl.bwd_geometry(16, 20000, torch.bfloat16, H100_SMS, H100_SMEM)["route"] == "stream"


def _c_smem(g, H_, dtype):
    """The dynamic shared memory the C side carves for this geometry
    (``csrc/lstm_bwd_cluster.cuh``), worked out independently of the
    Python launcher."""
    smax, rp, R, C = g["smax"], g["rp"], g["R"], g["C"]
    assert smax == -(-H_ // C)
    if dtype is None:  # bwd_smem_bytes: W^T, dp transposed, partials, carry, all f32
        hw = H_ + H_ % 2
        return 4 * (4 * smax * hw + 4 * smax * rp + 2 * R * hw + R * smax)
    nb = -(-H_ // 8) * 8  # bwd_mma_smem_bytes: wB, dA (bf16), partials, carry (f32)
    ks = -(-4 * smax // 16) * 16 + 8
    hst = -(-nb // 16) * 16 + 8
    return (-(-nb * ks * 2 // 16) * 16 + -(-rp * ks * 2 // 16) * 16
            + 4 * (2 * R * hst + R * smax))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_geometry_record_is_what_the_c_entry_reads(dtype):
    for dirs in (1, 2):
        for rows in (1, 16, 512):
            g = _geometry(rows, dtype, dirs)
            v = list(tl._geom_ints(g))
            assert len(v) == 17 and v[0] == 1
            assert v[1:8] == [g["C"], g["R"], g["rpt"], g["row_groups"], g["threads"], g["smem"],
                              g["smax"]]
            assert v[8:9 + g["C"]] == g["j0"] and g["rp"] == g["rpt"] * g["row_groups"]
            assert g["smem"] == _c_smem(g, FLAGSHIP_H, dtype)
            if dtype is not None:  # at most 3 m-tiles; a warp for each pair of n-tiles
                assert g["row_groups"] <= 3 and g["threads"] <= 384
    # the stream route launches the record's rows a block and refuses
    # threads or bytes other than its own: 4H threads to 32s, at most
    # 1024, and 40 R H bytes (dp, partials and carries, f32)
    s = tl._geom_ints(tl.bwd_stream_geometry(512, 400))
    assert list(s)[:7] == [0, 0, 4, 0, 0, 1024, 64_000]
    s = tl._geom_ints(tl.bwd_stream_geometry(16, FLAGSHIP_H))
    assert list(s)[:7] == [0, 0, 1, 0, 0, 704, 6_960]


def _bptt_emulation(ai, af, ao, ag, cs, whh, c0, dhs, dhT, dcT, g, cdt=None):
    """The cluster BPTT's data flow in plain PyTorch, rank by rank. Streams
    ``[dirs, T, B, H]`` in x-time, ``whh [dirs, 4, H, H]``, carries ``[dirs,
    B, H]``, ``dhs`` one ``[T or 1, B, H]`` per direction. Direction 0 walks t
    = T-1..0, direction 1 t = 0..T-1; clusters of ``R`` rows; per step each
    rank q takes its dh carry as the sum, in rank order, of every rank's
    partial of the previous step at its units (dhT at the first step),
    writes the dp of its units, and puts ``dp_q @ W_hhᵀ[q's rows]`` (all H
    columns) into its own ``buf[s % 2]``. Returns ``(dp [T, B, dirs·4H],
    dh0, dc0)``."""
    sdt = torch.bfloat16 if cdt else torch.float32
    dirs, T, B, H = cs.shape
    C, R, j0 = g["C"], g["R"], g["j0"]
    own = [slice(j0[q], j0[q + 1]) for q in range(C)]
    dp = torch.full((T, B, dirs * 4 * H), float("nan"), dtype=sdt)
    dh0, dc0 = (torch.full((dirs, B, H), float("nan")) for _ in "hc")
    for d in range(dirs):
        wT = whh[d].to(sdt).float().transpose(1, 2)  # W_hhᵀ[k, m, j]
        for row0 in range(0, B, R):
            rows = slice(row0, min(B, row0 + R))
            buf = [[None, None] for _ in range(C)]
            dcc = [dcT[d, rows, u].clone() for u in own]
            for s in range(T):
                t = s if d == 1 else T - 1 - s
                tp = t + 1 if d == 1 else t - 1
                for q, u in enumerate(own):
                    if s == 0:
                        carry = dhT[d, rows, u]
                    else:  # the reduce-scatter: every rank's partial at q's units
                        carry = buf[0][(s - 1) % 2][:, u]
                        for p in range(1, C):
                            carry = carry + buf[p][(s - 1) % 2][:, u]
                    dh = dhs[d][t if dhs[d].shape[0] == T else 0, rows, u].float() + carry
                    i, f, o, gg, c = (a[d, t, rows, u].float() for a in (ai, af, ao, ag, cs))
                    c_prev = cs[d, tp, rows, u].float() if 0 <= tp < T else c0[d, rows, u]
                    tc = torch.tanh(c)
                    dc = dh * o * (1 - tc * tc) + dcc[q]
                    dps = (dc * gg * i * (1 - i), dc * c_prev * f * (1 - f),
                           dh * tc * o * (1 - o), dc * i * (1 - gg * gg))
                    for k, v in enumerate(dps):
                        dp[t, rows, d * 4 * H + k * H:d * 4 * H + (k + 1) * H][:, u] = v.to(sdt)
                    ops = torch.cat([v.to(sdt).float() for v in dps], -1)  # column k·sk + m
                    w_rows = torch.cat([wT[k, u, :] for k in range(4)], 0)  # [4·sk, H]
                    buf[q][s % 2] = ops @ w_rows
                    dcc[q] = dc * f
            for q, u in enumerate(own):
                acc = buf[0][(T - 1) % 2][:, u]
                for p in range(1, C):
                    acc = acc + buf[p][(T - 1) % 2][:, u]
                dh0[d, rows, u], dc0[d, rows, u] = acc, dcc[q]
    return dp, dh0, dc0


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_f32(a)).to(dtype)


def _check(got, want, names, tol):
    for name, g, w in zip(names, got, want, strict=True):
        np.testing.assert_allclose(g.float().numpy(), _f32(w), err_msg=name, **tol)


T, D, H, B, S = 6, 5, 10, 5, 2


def _split_bwd(dp, dh0, dc0):
    """One direction's dp as its four gate blocks, then dh0, dc0."""
    return [dp[..., k * H:(k + 1) * H] for k in range(4)] + [dh0, dc0]


def _small_geometry(rows, cdt, dirs):
    """Clusters of 4 over H = 10 (ragged slices 3/3/2/2) and R = 4 rows (a
    ragged last cluster): the kernel's record for this shape."""
    g = tl.bwd_cluster_geometry(rows, H, 4, 4, torch.bfloat16 if cdt else None, dirs=dirs)
    assert g["j0"] == [0, 3, 6, 8, 10] and g["clusters"] * 4 > rows
    return g


@pytest.mark.parametrize("cdt,emul_tol,tol", DTYPES)
def test_one_direction_with_a_dhs_stream_matches_the_plain_bwd_and_pallas(cdt, emul_tol, tol):
    rng = np.random.default_rng(11)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x, wih4, b4, whh4 = f(T, B, D), f(4, D, H, scale=0.4), f(4, H, scale=0.2), f(4, H, H, scale=0.4)
    h0, c0 = f(B, H, scale=0.5), f(B, H, scale=0.5)
    outs = jl._fwd_fused_callable(cdt)(*map(jnp.asarray, (x, wih4, b4, whh4, h0, c0)))
    sdt = torch.bfloat16 if cdt else torch.float32
    acts = [outs[k] for k in (2, 3, 4, 5, 1)]  # i, f, o, g, cs
    dhs = jnp.asarray(f(T, B, H), jnp.bfloat16 if cdt else jnp.float32)
    dhT, dcT = f(B, H), f(B, H)
    port = [_t(a, sdt) for a in acts]
    tdt = torch.bfloat16 if cdt else None
    got = _bptt_emulation(*(a[None] for a in port), torch.from_numpy(whh4)[None],
                          torch.from_numpy(c0)[None], [_t(dhs, sdt)], torch.from_numpy(dhT)[None],
                          torch.from_numpy(dcT)[None], _small_geometry(B, cdt, 1), cdt)
    names = ("dp_i", "dp_f", "dp_o", "dp_g", "dh0", "dc0")
    got = _split_bwd(got[0], got[1][0], got[2][0])
    plain = tl.lstm_bwd_plain(*port, torch.from_numpy(whh4), torch.from_numpy(c0), _t(dhs, sdt),
                              torch.from_numpy(dhT), torch.from_numpy(dcT), tdt)
    _check(got, [a.float().numpy() for a in _split_bwd(*plain)], names, emul_tol)
    want = jl._bwd_callable(cdt)(*acts, jnp.asarray(whh4), jnp.asarray(c0), dhs, jnp.asarray(dhT),
                                 jnp.asarray(dcT))
    _check(got, want, names, tol)


def _site_rows(a):
    """[S, T, B, ·] site-native → the port's [T, S·B, ·] site-major rows."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return np.array(a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1, a.shape[-1]))


def _carry_rows(a):
    """[2, S, B, H] → [2, S·B, H]."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return np.array(a.reshape(2, -1, a.shape[-1]))


@pytest.mark.parametrize("cdt,emul_tol,tol", DTYPES)
def test_two_directions_with_an_f32_constant_match_the_plain_bwd_and_pallas(cdt, emul_tol, tol):
    """K6's form: the x-time streams of both directions from the site-batched
    Pallas forward (K5), the pool's cotangent dpool / T as an f32 per-row
    constant; S·B = 6 rows in clusters of 4 a direction."""
    Bs = 3
    rng = np.random.default_rng(12)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x4 = f(S, T, Bs, D)
    wih2, b2, whh2 = f(2, 4, D, H, scale=0.4), f(2, 4, H, scale=0.2), f(2, 4, H, H, scale=0.4)
    h4, c4 = f(2, S, Bs, H, scale=0.5), f(2, S, Bs, H, scale=0.5)
    jcdt = jnp.bfloat16 if cdt else None
    outs = jl._fwd_pool_call4(*map(jnp.asarray, (x4, wih2, b2, whh2, h4, c4)), compute_dtype=jcdt)
    dpf, dpr = f(S, Bs, H) / T, f(S, Bs, H) / T
    dhT4, dcT4 = f(2, S, Bs, H), f(2, S, Bs, H)
    sdt = torch.bfloat16 if cdt else torch.float32
    streams = [torch.stack([torch.from_numpy(_site_rows(outs[k])),
                            torch.from_numpy(_site_rows(outs[6 + k]))]).to(sdt)
               for k in (2, 3, 4, 5, 1)]
    const = [torch.from_numpy(np.ascontiguousarray(d.reshape(1, S * Bs, H))) for d in (dpf, dpr)]
    carries = [torch.from_numpy(_carry_rows(a)) for a in (c4, dhT4, dcT4)]
    got = _bptt_emulation(*streams, torch.from_numpy(whh2), carries[0], const, *carries[1:],
                          _small_geometry(S * Bs, cdt, 2), cdt)
    tdt = torch.bfloat16 if cdt else None
    plain = tb.bilstm_bwd_plain(*streams, torch.from_numpy(whh2), carries[0], *const, *carries[1:],
                                tdt)
    names = ("dp", "dh02", "dc02")
    _check(got, [a.float().numpy() for a in plain], names, emul_tol)
    want = jl._bwd_pool_call4(tuple(outs[2:6]), tuple(outs[8:12]), outs[1], outs[7],
                              jnp.asarray(whh2), jnp.asarray(c4), jnp.asarray(dpf),
                              jnp.asarray(dpr), jnp.asarray(dhT4), jnp.asarray(dcT4), jcdt)
    for k in range(8):
        np.testing.assert_allclose(got[0][..., k * H:(k + 1) * H].float().numpy(),
                                   _site_rows(want[k]), err_msg=f"dp gate block {k}", **tol)
    np.testing.assert_allclose(got[1].numpy(), _carry_rows(want[8]), err_msg="dh02", **tol)
    np.testing.assert_allclose(got[2].numpy(), _carry_rows(want[9]), err_msg="dc02", **tol)


def test_route_counters_stay_still_on_the_cpu():
    rng = np.random.default_rng(13)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)  # noqa: E731
    names_k2 = ("BWD_LAUNCHES", "BWD_CLUSTER_CALLS", "BWD_STREAM_CALLS")
    names_k6 = ("POOL_BWD_LAUNCHES", "BIDIR_BWD_CLUSTER_CALLS", "BIDIR_BWD_STREAM_CALLS")
    before = [getattr(tl, n) for n in names_k2] + [getattr(tb, n) for n in names_k6]
    k2 = [r(4, 3, 6) for _ in range(5)] + [r(4, 6, 6), r(3, 6), r(4, 3, 6), r(3, 6), r(3, 6)]
    got = tl.lstm_bwd_fused(*k2, geometry=tl.bwd_geometry(3, 6))
    assert all(torch.equal(a, b) for a, b in zip(got, tl.lstm_bwd_plain(*k2)))
    k6 = [r(2, 4, 3, 6) for _ in range(5)] + [r(2, 4, 6, 6), r(2, 3, 6), r(3, 6), r(3, 6),
                                              r(2, 3, 6), r(2, 3, 6)]
    got = tb.bilstm_pool_bwd_fused(*k6, geometry=tb.bidir_bwd_geometry(3, 6))
    want = tb.bilstm_bwd_plain(*k6[:7], k6[7][None], k6[8][None], *k6[9:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    after = [getattr(tl, n) for n in names_k2] + [getattr(tb, n) for n in names_k6]
    assert after == before


def test_phase_summary_reads_the_bptt_clock():
    """The cluster BPTT stamps five points a step (lstm_bwd_cluster.cuh:
    kBwdPhases) into the same record as the forward's clock; the summary
    names its four phases."""
    T_ = 3
    prof = torch.zeros(5 * T_ + 2, dtype=torch.int64)
    step = torch.tensor([0, 100, 110, 410, 500])  # cycles: cotangents, sync, product, barrier
    prof[:5 * T_] = torch.cat([step + 500 * s for s in range(T_)])
    prof[5 * T_], prof[5 * T_ + 1] = 0, 500 * (T_ - 1) + 500  # 1 ns a cycle
    out = tl.phase_summary(prof, T_, tl.BWD_PHASES)
    assert tl.BWD_PHASES == ("cotangents", "sync", "product", "barrier")
    assert [round(out[f"{k}_us"], 6) for k in tl.BWD_PHASES] == [0.1, 0.01, 0.3, 0.09]
    assert out["step_us"] == pytest.approx(0.5) and out["ghz"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# K4 (dn_bilstm_bwd) on the same core: both directions with their dhs at the
# stream dtype, a full [T, B, H] stream (time stride B·H) or a [1, B, H]
# per-row constant (time stride 0), the reverse direction's dhs read at its
# x-time t as its streams are


@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("cdt,emul_tol,tol", DTYPES)
def test_two_directions_with_stream_dtype_dhs_match_the_plain_bwd_and_pallas(cdt, emul_tol, tol,
                                                                              const):
    """K4's form: the x-time residuals of JAX's unbatched forward kernel
    (K3), dhs at the stream dtype, B = 5 rows in clusters of 4 a direction
    (a ragged last cluster of one row)."""
    rng = np.random.default_rng(14 + const)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x, wih2, b2 = f(T, B, D), f(2, 4, D, H, scale=0.4), f(2, 4, H, scale=0.2)
    whh2, h02, c02 = f(2, 4, H, H, scale=0.4), f(2, B, H, scale=0.5), f(2, B, H, scale=0.5)
    jcdt = jnp.bfloat16 if cdt else None
    outs = jl._fwd_bidir_call(*map(jnp.asarray, (x, wih2, b2, whh2, h02, c02)),
                              compute_dtype=jcdt)
    jsdt = jnp.bfloat16 if cdt else jnp.float32
    n = 1 if const else T
    dhsf, dhsr = jnp.asarray(f(n, B, H), jsdt), jnp.asarray(f(n, B, H), jsdt)
    dhT2, dcT2 = f(2, B, H), f(2, B, H)
    sdt = torch.bfloat16 if cdt else torch.float32
    streams = [torch.stack([_t(outs[k], sdt), _t(outs[6 + k], sdt)]) for k in (2, 3, 4, 5, 1)]
    dhs = [_t(dhsf, sdt), _t(dhsr, sdt)]
    carries = [torch.from_numpy(a) for a in (c02, dhT2, dcT2)]
    got = _bptt_emulation(*streams, torch.from_numpy(whh2), carries[0], dhs, *carries[1:],
                          _small_geometry(B, cdt, 2), cdt)
    assert got[0].dtype == sdt and not any(bool(a.float().isnan().any()) for a in got)
    plain = tb.bilstm_bwd_plain(*streams, torch.from_numpy(whh2), carries[0], *dhs, *carries[1:],
                                torch.bfloat16 if cdt else None)
    names = ("dp", "dh02", "dc02")
    _check(got, [a.float().numpy() for a in plain], names, emul_tol)
    want = jl._bwd_bidir_call(tuple(outs[2:6]), tuple(outs[8:12]), outs[1], outs[7],
                              jnp.asarray(whh2), jnp.asarray(c02), dhsf, dhsr,
                              jnp.asarray(dhT2), jnp.asarray(dcT2), jcdt)
    for k in range(8):
        np.testing.assert_allclose(got[0][..., k * H:(k + 1) * H].float().numpy(), _f32(want[k]),
                                   err_msg=f"dp gate block {k}", **tol)
    _check(got[1:], want[8:], ("dh02", "dc02"), tol)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_k4_reads_the_two_direction_record_and_refuses_no_route(dtype):
    """``dn_bilstm_bwd`` takes K6's two-direction record (its occupancy
    aside): the cluster route at the flagship's rows, and on the stream
    route the record's rows a block, threads and bytes, which the C side
    launches as they are (it no longer picks its own rows a block)."""
    for rows in (16, 512):
        g = tb.bidir_bwd_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM, H100_SLOTS)
        assert g["route"] == "cluster" and g["dirs"] == 2 and g["waves"] == 1
        v = list(tl._geom_ints(g))
        assert v[0] == 1 and v[5:7] == [g["threads"], g["smem"]]
        assert g["smem"] == _c_smem(g, FLAGSHIP_H, dtype)
    # the stream route: R = 1 at 16 rows (16 blocks a direction within 66
    # SMs), 8 at 512; threads 4H to 32s, 40 R H bytes
    for rows, R in ((16, 1), (512, 8)):
        s = tl.bwd_stream_geometry(rows, FLAGSHIP_H, H100_SMS, dirs=2)
        assert list(tl._geom_ints(s))[:7] == [0, 0, R, 0, 0, 704, 40 * R * FLAGSHIP_H]
    src = (Path(tl.__file__).resolve().parents[1] / "csrc" / "bilstm_bwd.cu").read_text()
    assert "rows_per_block" not in src  # the record's R, never the C side's own


def test_k4_settles_on_its_own_occupancy_under_its_own_key(monkeypatch):
    """K4's geometry is settled on ``dn_bilstm_k4_max_active_clusters``
    (its bf16 instance reads a bf16 dhs, K6's an f32 constant) and cached
    under its own key, so neither kernel reads the other's entry: here the
    card runs fewer of K4's bf16 clusters of 2 than of K6's, and K4 takes
    more rows a cluster to stay in one wave."""
    asked = []

    def occupancy(entry, key, code, rows, H_, geom):
        asked.append((entry, key[0]))
        return {"dn_bilstm_k4_max_active_clusters": 40}.get(entry, 66) if geom[1] == 2 else 30

    monkeypatch.setattr(tb, "_geometries", {})
    monkeypatch.setattr(tb, "device_limits", lambda dev: (H100_SMS, H100_SMEM))
    monkeypatch.setattr(tb, "_kernel", lambda lib, entry: entry)
    monkeypatch.setattr(tb, "cluster_occupancy", occupancy)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    bf = torch.bfloat16
    k6 = tb.device_bidir_bwd_geometry("cuda:0", 512, FLAGSHIP_H, bf)
    k4 = tb.device_k4_geometry("cuda:0", 512, FLAGSHIP_H, bf)
    assert {e for e, _ in asked} == {"dn_bilstm_bwd_max_active_clusters",
                                     "dn_bilstm_k4_max_active_clusters"}
    assert all(k == ("k4" if "k4" in e else "k6") for e, k in asked)
    assert (k6["C"], k6["R"], k6["clusters"]) == (2, 16, 32) and k6["waves"] == 1
    assert k4["C"] == 2 and k4["R"] > k6["R"] and 2 * k4["clusters"] <= 40
    keys = set(tb._geometries)
    assert ("k4", torch.device("cuda:0"), 512, FLAGSHIP_H, True) in keys
    assert ("k6", torch.device("cuda:0"), 512, FLAGSHIP_H, True) in keys
    # f32: the same kernel instance for both, the same geometry
    assert tb.device_k4_geometry("cuda:0", 512, FLAGSHIP_H) == \
        tb.device_bidir_bwd_geometry("cuda:0", 512, FLAGSHIP_H)


def test_k4_counters_stay_still_on_the_cpu():
    rng = np.random.default_rng(15)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)  # noqa: E731
    names = ("BIDIR_BWD_LAUNCHES", "K4_CLUSTER_CALLS", "K4_STREAM_CALLS")
    before = [getattr(tb, n) for n in names]
    head = [r(2, 4, 3, 6) for _ in range(5)] + [r(2, 4, 6, 6), r(2, 3, 6)]
    for n in (4, 1):  # a full stream, a per-row constant
        args = head + [r(n, 3, 6), r(n, 3, 6), r(2, 3, 6), r(2, 3, 6)]
        want = tb.bilstm_bwd_plain(*args)
        for geometry in (None, tb.bidir_bwd_geometry(3, 6), tl.bwd_stream_geometry(3, 6, dirs=2)):
            got = tb.bilstm_bwd_fused(*args, geometry=geometry)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [getattr(tb, n) for n in names] == before
