"""K1's launch geometry (``ops/lstm_cuda.py:k1_geometry``) and the ownership
map its cluster recurrence runs on, checked on the CPU before the card is
touched.

The cluster kernel (``csrc/lstm_fwd.cu:lstm_rec_cluster_kernel``) gives
block k of a cluster the hidden units ``[j0[k], j0[k + 1])`` with all four
gates of them, and the blocks exchange h once a step through a double
buffer. ``_cluster_emulation`` runs that data flow in plain PyTorch, rank by
rank through the column map the kernel is given, and the result is held
against ``lstm_recurrence_plain``; ``chip_smoke.py`` holds the kernel itself
against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from dinunet_implementations_tpu_torch.ops import lstm_cuda as tl

H100_SMS, H100_SMEM = 132, 232448
FLAGSHIP_H = 174
# the emulation sums each gate column's product over the rank's own slice
# of W_hh, in f32: the same terms as the plain version in another order
EMULATION_TOL = 1e-6


@pytest.mark.parametrize("rows", [1, 16, 512])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_flagship_geometry_is_one_wave_under_the_opt_in(rows, dtype):
    g = tl.k1_geometry(rows, FLAGSHIP_H, dtype, H100_SMS, H100_SMEM)
    assert g["route"] == "cluster" and g["waves"] == 1
    assert g["blocks"] == g["clusters"] * g["C"] <= H100_SMS
    assert g["clusters"] * g["R"] >= rows > (g["clusters"] - 1) * g["R"]
    assert g["smem"] <= H100_SMEM and g["threads"] <= 1024
    assert g["rp"] == g["rpt"] * g["row_groups"] >= g["R"]
    # each thread owns one gate column of the block: 4 · smax of them
    assert g["threads"] // g["row_groups"] >= 4 * g["smax"]
    if dtype is None:  # the W_hh slice of a cluster of 2 is 242 KB in f32
        assert g["C"] == 4 and g["j0"] == [0, 44, 88, 131, 174]
    if rows == 512 and dtype is None:
        assert (g["R"], g["clusters"], g["blocks"]) == (16, 32, 128)
        assert 145_000 < g["smem"] < 160_000


@pytest.mark.parametrize("H", [8, 174, 175])
@pytest.mark.parametrize("C", tl.K1_CLUSTER_SIZES)
def test_slices_cover_the_hidden_units_exactly(H, C):
    j0 = tl.k1_column_map(H, C)
    sizes = np.diff(j0)
    assert j0[0] == 0 and j0[-1] == H and len(j0) == C + 1
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    owned = np.concatenate([np.arange(a, b) for a, b in zip(j0[:-1], j0[1:])])
    np.testing.assert_array_equal(owned, np.arange(H))  # no gap, no overlap
    for rows in (1, 16, 512):
        g = tl.k1_geometry(rows, H, None, H100_SMS, H100_SMEM)
        assert g["route"] == "cluster" and g["j0"] == tl.k1_column_map(H, g["C"])
        assert g["smax"] == max(np.diff(g["j0"]))


def test_cluster_sizes_grow_with_the_slice_and_a_too_large_H_streams():
    pick = {(H, dt): tl.k1_geometry(512, H, dt, H100_SMS, H100_SMEM)
            for H, dt in ((128, None), (FLAGSHIP_H, None), (FLAGSHIP_H, torch.bfloat16),
                          (256, None), (400, None), (600, torch.bfloat16))}
    assert [pick[k].get("C") for k in pick] == [2, 4, 2, 8, None, None]
    for H, dt in ((400, None), (600, torch.bfloat16)):
        g = pick[(H, dt)]
        assert g["route"] == "stream" and g["R"] in (1, 2, 4, 8)
        assert g["smem"] == 4 * g["R"] * 6 * H <= H100_SMEM and g["waves"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        tl.k1_geometry(4, 20000, None, H100_SMS, H100_SMEM)


def test_clusters_the_card_runs_at_once_set_the_rows_a_cluster():
    """A GPC holds whole clusters only: an H100 runs 30 clusters of 4 at
    once, not 132 // 4 = 33 (cudaOccupancyMaxActiveClusters), so 512 rows
    take 18 rows a cluster in 29 clusters, one wave, not 16 in 32."""
    g = tl.k1_geometry(512, FLAGSHIP_H, None, H100_SMS, H100_SMEM, cluster_slots={4: 30})
    assert (g["C"], g["R"], g["clusters"], g["waves"]) == (4, 18, 29, 1)
    assert g["smem"] <= H100_SMEM and g["threads"] <= 1024
    assert tl.k1_cluster_geometry(512, FLAGSHIP_H, 4, 16, None, H100_SMEM, 30)["waves"] == 2
    assert tl.k1_cluster_geometry(512, FLAGSHIP_H, 2, 8, None, H100_SMEM) is None  # 242 KB slice


def test_rows_past_one_wave_take_several_waves_of_fitting_clusters():
    g = tl.k1_geometry(100_000, FLAGSHIP_H, None, H100_SMS, H100_SMEM)
    assert g["route"] == "cluster" and g["waves"] > 1
    assert g["smem"] <= H100_SMEM and g["threads"] <= 1024
    assert g["clusters"] * g["R"] >= 100_000


def test_geometry_record_is_what_the_c_entry_reads():
    g = tl.k1_geometry(512, FLAGSHIP_H, None, H100_SMS, H100_SMEM)
    v = list(tl._geom_ints(g))
    assert v[:8] == [1, 4, 16, 8, 2, 384, g["smem"], 44] and v[8:13] == g["j0"]
    s = tl.k1_geometry(512, 400, None, H100_SMS, H100_SMEM)
    v = list(tl._geom_ints(s))
    assert v[0] == 0 and (v[2], v[5], v[6]) == (s["R"], s["threads"], s["smem"])


def _cluster_emulation(x, wih4, b4, whh4, h0, c0, g):
    """The cluster kernel's data flow in plain PyTorch, f32: clusters of
    ``R`` rows; per step each rank gathers h_{t-1} from every rank's
    ``buf[t % 2]``, computes all four gates of its own units from the
    projection and its own W_hh columns, and writes its new h into its own
    ``buf[(t + 1) % 2]``. The outputs are the ranks' slices concatenated."""
    T, B, _ = x.shape
    H = whh4.shape[-1]
    C, R, j0 = g["C"], g["R"], g["j0"]
    xp = tl.lstm_proj_plain(x, wih4, b4)
    whh = whh4.permute(1, 0, 2).reshape(H, 4 * H)
    streams = torch.zeros((6, T, B, H))
    hT, cT = torch.zeros((B, H)), torch.zeros((B, H))
    for row0 in range(0, B, R):
        rows = slice(row0, min(B, row0 + R))
        own = [slice(j0[k], j0[k + 1]) for k in range(C)]
        buf = [[h0[rows, u].clone(), None] for u in own]
        carry = [c0[rows, u].clone() for u in own]
        for t in range(T):
            h_prev = torch.cat([buf[k][t % 2] for k in range(C)], -1)  # the gather
            for k, u in enumerate(own):
                cols = [gate * H + j for gate in range(4) for j in range(u.start, u.stop)]
                pre = xp[t, rows][:, cols] + h_prev @ whh[:, cols]
                s = u.stop - u.start
                i, f, o = (torch.sigmoid(pre[:, q * s:(q + 1) * s]) for q in range(3))
                gg = torch.tanh(pre[:, 3 * s:])
                carry[k] = f * carry[k] + i * gg
                h = o * torch.tanh(carry[k])
                buf[k][(t + 1) % 2] = h
                for n, v in enumerate((h, carry[k], i, f, o, gg)):
                    streams[n, t, rows, u] = v
        hT[rows] = torch.cat([buf[k][T % 2] for k in range(C)], -1)
        cT[rows] = torch.cat(carry, -1)
    return (*streams, hT, cT)


def test_ownership_map_reproduces_the_plain_recurrence():
    T, B, D, H = 6, 5, 7, 10
    # 8 SMs and a small opt-in force a cluster of 4 (a cluster of 2 does
    # not fit), ragged slices 3/3/2/2 and ragged rows: 2 clusters of 3 rows
    g = tl.k1_geometry(B, H, None, sms=8, smem_optin=2000)
    assert (g["C"], g["R"], g["clusters"]) == (4, 3, 2) and g["j0"] == [0, 3, 6, 8, 10]
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale)  # noqa: E731
                                               .astype(np.float32))
    args = (f(T, B, D), f(4, D, H, scale=0.3), f(4, H, scale=0.1), f(4, H, H, scale=0.3),
            f(B, H, scale=0.5), f(B, H, scale=0.5))
    want = tl.lstm_recurrence_plain(*args, residuals=True)
    got = _cluster_emulation(*args, g)
    names = ("hs", "cs", "i", "f", "o", "g", "hT", "cT")
    for name, a, b in zip(names, got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=EMULATION_TOL, rtol=0, err_msg=name)


def test_projection_plain_version_is_the_recurrences_input():
    """``lstm_proj_plain`` is x W_ih + b with the gates side by side, at the
    compute dtype's operands; the CPU wrapper runs it without a launch."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32))
    wih4 = torch.from_numpy(rng.standard_normal((4, 5, 6)).astype(np.float32))
    b4 = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    for cdt in (None, torch.bfloat16):
        xp = tl.lstm_proj_plain(x, wih4, b4, cdt)
        assert xp.shape == (3, 2, 24) and xp.dtype == torch.float32
        xr, wr = (x, wih4) if cdt is None else (x.bfloat16().float(), wih4.bfloat16().float())
        for k in range(4):
            np.testing.assert_allclose(xp[..., 6 * k:6 * (k + 1)].numpy(),
                                       (xr @ wr[k] + b4[k]).numpy(), atol=1e-5, rtol=1e-6)
    before = tl.PROJ_LAUNCHES
    assert torch.equal(tl.lstm_proj_fused(x, wih4, b4), tl.lstm_proj_plain(x, wih4, b4))
    assert tl.PROJ_LAUNCHES == before


def test_route_counters_stay_still_on_the_cpu():
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
            [(4, 3, 5), (4, 5, 6), (4, 6), (4, 6, 6), (3, 6), (3, 6)]]
    before = (tl.LAUNCHES, tl.K1_CLUSTER_CALLS, tl.K1_STREAM_CALLS, tl.PROJ_LAUNCHES)
    tl.lstm_recurrence_fused(*args, residuals=True)
    assert (tl.LAUNCHES, tl.K1_CLUSTER_CALLS, tl.K1_STREAM_CALLS, tl.PROJ_LAUNCHES) == before
