"""K7's staged route (``csrc/poweriter.cu``: ``poweriter_staged_kernel``):
the launch geometry (``ops/poweriter_cuda.py:k7_geometry``), the launch
records, and the data flow of the staged products, checked on the CPU
before the card is touched.

A member's row-major side A (G, or Gᵀ for a transposed view) streams
through a ring of shared-memory stages. ``A x`` walks column bands of A
(64 rows by 64 columns, two tensor boxes), eight lanes a row summing
every eighth 16-byte chunk across the bands in column order; ``Aᵀy`` walks row bands (``band_rows`` rows, up to
1024 columns), each thread 4 columns summing across the bands in band
order. bf16 rounds each G value once as it leaves the tile and each
iterate once a pass. ``_staged_emulation`` runs that data flow band by band
in plain PyTorch and is held against ``poweriter_plain`` and the JAX
package's Pallas kernel (interpret mode). ``chip_smoke.py`` holds the
kernel itself against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinunet_implementations_tpu.engines import lowrank as jl
from dinunet_implementations_tpu.ops import poweriter_pallas as pp
from dinunet_implementations_tpu_torch.core.config import NNComputation, TrainConfig
from dinunet_implementations_tpu_torch.engines import lowrank as tl
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc
from dinunet_implementations_tpu_torch.runner.registry import get_task
from dinunet_implementations_tpu_torch.weights import leaf_table

H100_SMS, H100_SMEM = 132, 232448
ITERS = 5
# The emulation sums each product band by band and the plain version in
# one matmul: f32 agrees to rounding (the JAX paths differ by 1.2e-7 on
# such inputs, tests/test_torch_port_poweriter.py). In bf16 both round the
# same f32 values to bf16, but an f32 intermediate one ulp apart can round
# to the neighbouring bf16 value (2**-9 relative), which the next product
# carries: the port's bf16 tolerance.
F32_TOL = 1e-5
BF16_TOL = 1e-3


@pytest.fixture(scope="module")
def flagship_classes():
    """``{r: [(L, m, n), ...], ...}`` and the row-major flags of the
    full-width ICA-LSTM's compressible leaves at 32 sites, rank 10, in the
    JAX matrix orientation (an ``nn.Linear`` weight is a transposed view)."""
    cfg = TrainConfig(task_id=NNComputation.TASK_ICA)
    model = get_task(cfg.task_id).build_model(cfg, torch.Generator().manual_seed(0))
    tr = leaf_table(cfg).transposed
    classes: dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)[::-1] if name in tr else tuple(p.shape)
        if tl.is_compressible(shape):
            m, n = tl._matrix_shape(shape)
            classes.setdefault(min(10, m, n), []).append(((32, m, n), name not in tr))
    return {r: ([s for s, _ in v], [rm for _, rm in v]) for r, v in classes.items()}


def test_the_flagship_classes_are_staged_two_blocks_an_sm_in_one_wave(flagship_classes):
    assert sorted(flagship_classes) == [2, 10]
    shapes10, rm10 = flagship_classes[10]
    assert sum(L for L, _, _ in shapes10) == 224 and (32, 1000, 256) in shapes10
    for r, (shapes, row_major) in flagship_classes.items():
        g = pc.k7_geometry(shapes, r, True, H100_SMS, H100_SMEM, row_major)
        assert g["route"] == "staged" and g["blocks_per_sm"] == 2 and g["waves"] == 1
        assert g["blocks"] <= 2 * H100_SMS and g["threads"] == 256
        # the iterates and the ring, with the static arrays, under half the opt-in
        assert g["smem"] + pc._STAGED_STATIC_SMEM <= H100_SMEM // 2
        assert g["smem"] == pc.staged_smem_bytes([s[1:] for s in shapes], r, g["stages"])
    g10 = pc.k7_geometry(shapes10, 10, True, H100_SMS, H100_SMEM, rm10)
    # r = 10: iterates 4·10·(1000 + 256) = 50,240 B, 1 KB to align the
    # ring, three 16 KB stages
    assert (g10["stages"], g10["smem"]) == (3, 100_416)
    g2 = pc.k7_geometry(*[flagship_classes[2][0]], 2, True, H100_SMS, H100_SMEM,
                        flagship_classes[2][1])
    assert (g2["stages"], g2["smem"]) == (4, 4 * 2 * 68 + 1024 + 4 * 16384)
    # what the occupancy query reports decides the waves
    assert pc.k7_geometry(shapes10, 10, True, H100_SMS, H100_SMEM, rm10, 1)["waves"] == 2


def test_the_tiles_fit_a_stage_and_follow_the_layout(flagship_classes):
    shapes, row_major = flagship_classes[10]
    g = pc.k7_geometry(shapes, 10, True, H100_SMS, H100_SMEM, row_major)
    floats = pc.STAGE_BYTES // 4
    for (_, m, n), rm, (band_rows, band_cols) in zip(shapes, row_major, g["tiles"]):
        ra, ca = (m, n) if rm else (n, m)
        assert band_rows % 4 == 0 and band_rows * min(1024, ca) <= floats
        assert band_cols == 64 and 64 * band_cols == floats  # a column band is a stage
    # the encoder's Gᵀ [256, 1000]: 4 rows of 1000
    assert pc.staged_tiles(256, 1000) == (4, 64)
    # cls_fc2's Gᵀ [64, 256]: 16 rows of 256
    assert pc.staged_tiles(64, 256) == (16, 64)
    # narrow rows fill a stage with more of them; rows past 1024 columns
    # are cut into column chunks
    assert pc.staged_tiles(2, 64) == (64, 64)
    assert pc.staged_tiles(20, 12) == (4 * (4096 // 48), 64)
    assert pc.staged_tiles(64, 4000) == (4, 64)
    # a width off 4 values has no whole 16-byte rows
    assert pc.staged_tiles(20, 3) is None and pc.staged_tiles(256, 1001) is None


def test_a_class_over_half_an_sm_takes_the_direct_route_while_k7_takes_it():
    shapes = [(2, 2000, 1000)]
    assert pc.k7_takes([s[1:] for s in shapes], 16)
    g = pc.k7_geometry(shapes, 16, True, H100_SMS, H100_SMEM)
    assert g["route"] == "direct" and "shared memory" in g["why"]
    assert g["smem"] == pc.class_smem_bytes([(2000, 1000)], 16) and g["order"] == [0]
    # four stages do not fit beside the flagship r = 10 iterates, three do
    assert pc.staged_smem_bytes([(1000, 256)], 10, 4) > H100_SMEM // 2 - pc._STAGED_STATIC_SMEM


def test_unaligned_members_or_rows_take_the_direct_route():
    g = pc.k7_geometry([(4, 96, 64)], 4, False, H100_SMS, H100_SMEM)
    assert g["route"] == "direct" and "16-byte chunks" in g["why"]
    base = torch.zeros(4 * 96 * 64 + 4)
    assert pc._aligned(base[:4 * 96 * 64].view(4, 96, 64))
    assert not pc._aligned(base[1:1 + 4 * 96 * 64].view(4, 96, 64))  # the base
    wide = torch.zeros(4, 96, 67)
    assert not pc._aligned(wide[..., :64])  # a row pitch of 67 values
    assert pc._aligned(torch.zeros(4, 96, 68)[..., :64])  # a pitch of 68, a width of 64
    assert not pc._aligned(torch.zeros(4, 96, 68)[..., :65])  # a width of 65
    # widths off 4 take the direct route even where the caller's strides pass
    g = pc.k7_geometry([(4, 96, 65)], 4, True, H100_SMS, H100_SMEM)
    assert g["route"] == "direct" and "16-byte chunks" in g["why"]
    # a transposed view: A = Gᵀ, its rows are G's columns
    assert pc._aligned(torch.zeros(4, 64, 96).transpose(1, 2))
    assert not pc._aligned(torch.zeros(4, 63, 97).transpose(1, 2)[:, :96])
    assert not pc._row_major(torch.zeros(4, 64, 96).transpose(1, 2))
    # a member stride that is not a multiple of 4 values
    assert not pc._aligned(torch.zeros(600).as_strided((3, 24, 8), (194, 8, 1)))


def test_the_block_order_is_largest_first_and_a_permutation(flagship_classes):
    shapes, row_major = flagship_classes[10]
    g = pc.k7_geometry(shapes, 10, True, H100_SMS, H100_SMEM, row_major)
    assert sorted(g["order"]) == list(range(len(shapes)))
    sizes = [shapes[k][1] * shapes[k][2] for k in g["order"]]
    assert sizes == sorted(sizes, reverse=True) and shapes[g["order"][0]][1:] == (1000, 256)
    recs = pc.launch_records(shapes, g)
    # blocks are numbered consecutively in launch order ...
    assert [first for _, first, _ in recs] == list(np.cumsum([0] + [shapes[k][0]
                                                                   for k, _, _ in recs])[:-1])
    # ... and each bucket's trips land at its members' place in member order
    starts = np.cumsum([0] + [L for L, _, _ in shapes])[:-1]
    assert all(order == starts[k] for k, _, order in recs)
    covered = sorted(i for k, _, order in recs for i in range(order, order + shapes[k][0]))
    assert covered == list(range(sum(L for L, _, _ in shapes)))
    # a stable sort: equal sizes keep member order; the direct route keeps it all
    g3 = pc.k7_geometry([(2, 8, 8), (3, 16, 16), (1, 8, 8)], 4, True, H100_SMS, H100_SMEM)
    assert g3["order"] == [1, 0, 2]
    assert pc.launch_records([(2, 8, 8), (3, 16, 16), (1, 8, 8)], g3) == [(1, 0, 2), (0, 3, 0),
                                                                        (2, 5, 5)]
    d = pc.k7_direct_geometry(shapes, 10)
    assert all(first == order for _, first, order in pc.launch_records(shapes, d))


def test_the_geometry_record_is_what_the_c_entry_reads():
    g = pc.k7_geometry([(32, 1000, 256)], 10, True, H100_SMS, H100_SMEM, [False])
    assert list(pc._geom_ints(g)) == [1, g["stages"], g["smem"]]
    assert list(pc._geom_ints(pc.k7_direct_geometry([(32, 1000, 256)], 10))) == [0, 0, 0]
    # the C side recomputes the dynamic shared memory from the records
    # (4·r·max(round4(m) + round4(n)) + 1024 + stages·16 KB) and refuses
    # a record whose bytes differ; the stage size is one constant on both
    # sides
    src = (pc._build.CSRC / "poweriter.cu").read_text()
    assert "a.smem = 4 * r * (int)iterates + 1024 + a.stages * 4 * kStageFloats;" in src
    assert "constexpr int kStageFloats = kBand * kBand;" in src and pc.STAGE_BYTES == 4 * 64 * 64
    assert f"constexpr int kStagedFields = {pc._FIELDS};" in src
    assert f"constexpr int kThreads = {pc.THREADS};" in src


def test_route_counters_stay_still_on_the_cpu():
    rng = np.random.default_rng(3)
    G = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    om = torch.from_numpy(rng.standard_normal((3, 24, 4)).astype(np.float32))
    before = (pc.POWERITER_LAUNCHES, pc.POWERITER_STAGED_CALLS, pc.POWERITER_DIRECT_CALLS)
    for geometry in (None, pc.k7_direct_geometry([(3, 40, 24)], 4)):
        got = pc.poweriter_fused(G, om, ITERS, 1e-3, geometry=geometry)
        for a, b in zip(got, pc.poweriter_plain(G, om, ITERS, 1e-3)):
            assert torch.equal(a, b)
    assert (pc.POWERITER_LAUNCHES, pc.POWERITER_STAGED_CALLS,
            pc.POWERITER_DIRECT_CALLS) == before


def test_the_phase_summary_reads_the_clock():
    # 1.5 GHz: 3000 cycles are 2 µs; A x 1500 and Aᵀy 900 cycles, 300 of
    # them ring waits and 150 issuing copies; the chain 300
    prof = [1500, 900, 300, 3000, 1_000, 300, 3_000, 5, 1, 150]
    out = pc.k7_phase_summary(prof, [(32, 64, 2), (32, 1000, 256)])
    assert out["total_us"] == pytest.approx(2.0) and out["ghz"] == pytest.approx(1.5)
    assert out["products_us"] == pytest.approx(1.3) and out["ring_wait_us"] == pytest.approx(0.2)
    assert out["issue_us"] == pytest.approx(0.1) and out["chain_us"] == pytest.approx(0.2)
    assert out["other_us"] == pytest.approx(0.2)
    assert (out["ax_us"], out["aty_us"]) == (pytest.approx(1.0), pytest.approx(0.6))
    assert sum(out[f"{p}_share"] for p in pc.K7_PHASES) == pytest.approx(1.0)
    assert (out["passes"], out["trips"], out["member_shape"]) == (12, 5, [1000, 256])


# ---------------------------------------------------------------------------
# the staged data flow, band by band


def _rnd(a, bf16):
    return a.to(torch.bfloat16).float() if bf16 else a


def _ax(A, x, band_cols, row_chunk):
    """A x over column bands of row chunks: eight lanes a row, lane k
    summing the band's 16-byte chunks k, k + 8, ... across the bands in
    column order, then the eight added pairwise (lanes xor 1, 2, 4)."""
    ra, ca = A.shape
    out = torch.empty(ra, x.shape[1])
    for r0 in range(0, ra, row_chunk):
        acc = torch.zeros(8, min(row_chunk, ra - r0), x.shape[1])
        for c0 in range(0, ca, band_cols):
            for j in range(c0, min(c0 + band_cols, ca), 4):
                acc[(j - c0) // 4 % 8] += A[r0:r0 + row_chunk, j:j + 4] @ x[j:j + 4]
        pairs = [acc[2 * i] + acc[2 * i + 1] for i in range(4)]
        out[r0:r0 + row_chunk] = (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])
    return out


def _aty(A, y, band_rows, col_chunk):
    """Aᵀ y over row bands of column chunks: each column's sums across the
    bands in band order."""
    ra, ca = A.shape
    out = torch.empty(ca, y.shape[1])
    for c0 in range(0, ca, col_chunk):
        acc = torch.zeros(min(col_chunk, ca - c0), y.shape[1])
        for r0 in range(0, ra, band_rows):
            acc = acc + A[r0:r0 + band_rows, c0:c0 + col_chunk].T @ y[r0:r0 + band_rows]
        out[c0:c0 + col_chunk] = acc
    return out


def _staged_emulation(G, om, num_iters, tol, bf16, tiles, row_chunk=64, col_chunk=1024):
    """The staged kernel's loop for each member of G [L, m, n]: A is G when
    G is row-major, else Gᵀ; each G value rounded once (bf16), each iterate
    rounded once a pass after its f32 value was kept where it is a result."""
    band_rows, band_cols = tiles
    rm = pc._row_major(G)
    Ps, Qs, trips = [], [], []
    for g, o in zip(G, om):
        A = _rnd(g if rm else g.T, bf16)

        def g_times(z):  # G z
            return _ax(A, z, band_cols, row_chunk) if rm else _aty(A, z, band_rows, col_chunk)

        def gt_times(p):  # Gᵀ p
            return _aty(A, p, band_rows, col_chunk) if rm else _ax(A, p, band_cols, row_chunk)

        P, _ = tl._cholqr_multi(g_times(_rnd(o, bf16))[None])
        P = P[0]
        Z = gt_times(_rnd(P, bf16))
        sig = torch.linalg.vector_norm(Z, dim=0)
        delta, t = float("inf"), 0
        while t < num_iters and delta > tol:
            Y = g_times(_rnd(Z, bf16))
            P, colnorms = tl._cholqr_multi(Y[None])
            P, sig_new = P[0], torch.sqrt(colnorms[0])
            delta = float(torch.linalg.vector_norm(sig_new - sig)
                          / torch.clamp(torch.linalg.vector_norm(sig), min=1e-12))
            sig = sig_new
            Z = gt_times(_rnd(P, bf16))
            t += 1
        Ps.append(P)
        Qs.append(Z)
        trips.append(t)
    return torch.stack(Ps), torch.stack(Qs), torch.tensor(trips, dtype=torch.int32)


def _member(rng, m, n, k):
    d = 0.7 ** np.arange(k)
    a = rng.standard_normal((m, k)) * d
    return ((a @ rng.standard_normal((k, n))) / np.sqrt(k)
            + 1e-3 * rng.standard_normal((m, n))).astype(np.float32)


# (m, n, transposed, band_rows, band_cols, row_chunk, col_chunk): bands and
# chunks far smaller than the card's, so that small shapes cross many of
# them, with ragged last bands and chunks in both directions; A's width a
# multiple of 4, as the staged route takes it
CASES = [(37, 28, False, 8, 16, 16, 12), (28, 37, True, 4, 8, 8, 20),
         (20, 52, True, 12, 32, 64, 1024)]


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=["row-major", "transposed", "one-chunk"])
def test_the_staged_data_flow_matches_the_plain_version_and_pallas(case, bf16, start):
    m, n, transposed, band_rows, band_cols, row_chunk, col_chunk = case
    r = 4
    rng = np.random.default_rng(11)
    gs = np.stack([_member(rng, m, n, 8) for _ in range(3)])
    gs[0] = 0.0  # a dead site
    if start == "cold":
        om = np.asarray(jl.default_omega(jnp.asarray(gs[1]), r))
        oms = np.broadcast_to(om, (3, n, r)).copy()
    else:
        prev = gs + 0.05 * rng.standard_normal(gs.shape).astype(np.float32)
        res = jl.subspace_iteration_grouped([([jnp.asarray(g) for g in prev], r, None)],
                                            ITERS, 1e-3)[0]
        oms = np.stack([np.asarray(q) for _, q in res])
    G = torch.from_numpy(gs)
    if transposed:  # an nn.Linear weight: a transposed view of [n, m] storage
        G = G.transpose(1, 2).contiguous().transpose(1, 2)
    assert pc._row_major(G) != transposed
    om_t = torch.from_numpy(oms)
    mm = torch.bfloat16 if bf16 else None
    got = _staged_emulation(G, om_t, ITERS, 1e-3, bf16, (band_rows, band_cols), row_chunk,
                            col_chunk)
    plain = pc.poweriter_plain(G, om_t, ITERS, 1e-3, mm)
    tol = BF16_TOL if bf16 else F32_TOL
    for a, b in zip(got[:2], plain[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0)
    assert torch.equal(got[2], plain[2])
    assert not got[0][0].any() or torch.equal(got[0][0], plain[0][0])
    # against the Pallas kernel K7 replaces, one bucket
    want = pp.fused_subspace_iteration_grouped(
        [([jnp.asarray(g) for g in gs], r, [jnp.asarray(o) for o in oms])], ITERS, 1e-3,
        matmul_dtype=jnp.bfloat16 if bf16 else None)[0]
    for i, (wp, wq) in enumerate(want):
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(wp), atol=tol, rtol=0)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(wq), atol=tol, rtol=0)


def test_the_emulated_bands_cover_a_at_the_cards_tiles():
    """At the card's tiles the band products add up to the whole product,
    for a class's worth of layouts: every value of A is in exactly one band
    of each walk."""
    rng = np.random.default_rng(5)
    for ra, ca in ((256, 1000), (174, 696), (64, 256), (2, 64), (300, 1100), (37, 132)):
        A = torch.from_numpy(rng.standard_normal((ra, ca)).astype(np.float32))
        band_rows, band_cols = pc.staged_tiles(ra, ca)
        x = torch.from_numpy(rng.standard_normal((ca, 3)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((ra, 3)).astype(np.float32))
        torch.testing.assert_close(_ax(A, x, band_cols, 64), A @ x, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(_aty(A, y, band_rows, 1024), A.T @ y, atol=1e-4, rtol=1e-5)
