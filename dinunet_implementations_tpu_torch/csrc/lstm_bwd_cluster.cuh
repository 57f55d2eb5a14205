// The LSTM backward through time over a thread-block cluster, written once
// for one direction (K2, lstm_bwd.cu) and for two (K4 and K6,
// bilstm_bwd.cu): the cluster route of all three. The backward counterpart of K1's and K3/K5's
// cluster recurrences (lstm_fwd.cu:lstm_rec_cluster_kernel,
// bilstm_fwd.cu:bilstm_rec_cluster_kernel / bilstm_rec_mma_kernel).
//
// Per step and row of a direction, as lstm_bwd.cu's first design:
//   dh = dhs[t] + dh_carry;  dc = dh * o * (1 - tanh(c)^2) + dc_carry
//   dp_i, dp_f, dp_o, dp_g from dh, dc and the forward's residuals
//   dh_carry <- sum_k dp_k @ W_hh[k]^T;  dc_carry <- dc * f
//
// What bounded the first design: every block walked all T steps and every
// thread streamed its column of W_hh^T (0.48 MB in f32) from L2 in a
// dependent loop of H loads, each value feeding only R (4 or 8) FMAs: about
// 6 GB of L2 reads a call at the 512-row training fold.
//
// What this design does about it. A cluster of C blocks carries R rows of
// one direction; block q owns the hidden units [m0, m1) = [j0[q], j0[q+1])
// (ops/lstm_cuda.py:k1_column_map) and:
// 1. holds W_hh^T[k, m0:m1, :] of all four gates in shared memory for the
//    whole sequence, loaded once: rows c = k * sk + (m - m0), all H columns;
// 2. at each step reads its units' slice of the streams, computes their four
//    dp (written to global memory at the stream dtype) and keeps dc in
//    shared memory; dp's operand copy (bf16-rounded in bf16 mode, the TPU
//    kernel's dp.astype(cdt)) stays in the block;
// 3. computes partial[r, j] = sum_{c < 4 sk} dp[r, c] * W^T[c, j] over its
//    own slice for every output column j, into a double-buffered f32
//    [R, H] buffer in its own shared memory;
// 4. one split cluster barrier; then, at the next step, it reads its own
//    unit slice of every rank's partial buffer through distributed shared
//    memory and adds them in rank order: the next dh carry of its units (a
//    reduce-scatter).
// The reduce-scatter moves rows x H floats a block a step; the other split
// (a block owns output columns and gathers all of dp) would move rows x 4H
// and its gather buffer would not fit beside W_hh^T. dh0 is the sum of the
// last step's partials, dc0 the dc carry, written by the owning rank.
// The sums run in another order than the first design's (C partial sums
// over unit slices, in rank order, where it summed over m per gate, then
// the gates): deterministic, within ~1e-6 relative of it in f32.
//
// f32: bwd_cluster_kernel, a 2-column by RPT-row register tile a thread,
// as bilstm_rec_cluster_kernel. bf16:
// bwd_cluster_mma_kernel, the product on the tensor cores (mma.sync
// m16n8k16, f32 accumulators): A is dp [rows padded to 16, 4 sk padded to
// 16], B the W_hh^T slice as ldmatrix operands.
//
// Two directions (K4, K6): the first half of the grid's clusters is direction
// 0, which walks t = T-1..0, the second half direction 1 (x-time streams),
// t = 0..T-1; each has its own c_prev neighbour (c[t-1] or c[t+1]) and c0
// at its first step. The launch geometry is worked out in Python
// (ops/lstm_cuda.py:bwd_geometry) and checked here.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "lstm_cluster.cuh"

namespace dn {

struct BwdArgs {
  const void* ai;  // [dirs, T, B, H] contiguous, stream dtype: the forward's residuals
  const void* af;
  const void* ao;
  const void* ag;
  const void* cs;
  const void* wT;  // W_hh^T[d, k, m, j] at (4 d + k) * swk + m * swm + j, stream dtype
  long long swk, swm;
  const float* c0;     // [dirs, B, H] contiguous
  const void* dhs[2];  // per direction: dhs[t, b, j] at t*sdt + b*sdb + j (sdt 0: constant)
  long long sdt[2], sdb[2];
  const float* dhT;  // [dirs, B, H] contiguous
  const float* dcT;
  void* dp;    // [T, B, dirs * 4H] contiguous, stream dtype; direction d at d * 4H
  float* dh0;  // [dirs, B, H] f32
  float* dc0;
  int T, B, H, dirs;
  // null, or [5 T + 2]: the phase clock of block 0 (kBwdPhases)
  long long* prof;
};

// The phase clock of a cluster BPTT step: the stamps ops/lstm_cuda.py:
// BWD_PHASES reads (the dh reduce and the cotangents; the block barrier; the
// product; the cluster barrier).
enum { kBwdStart, kBwdCotangents, kBwdSync, kBwdProduct, kBwdBarrier, kBwdPhases };

// row stride of the SIMT W_hh^T slice and of its partial buffer: H rounded
// up to even, so that a thread's float2 of columns 2 cq, 2 cq + 1 is aligned
__host__ __device__ inline int bwd_hw(int H) { return H + (H & 1); }

// Dynamic shared memory of a block of bwd_cluster_kernel, all f32: the
// W_hh^T slice [4 smax, hw], dp transposed [4 smax, rp], the partials [2,
// R, hw] and the dc carry [R, smax].
__host__ __device__ inline size_t bwd_smem_bytes(const ClusterGeom& g, int H) {
  const size_t hw = bwd_hw(H);
  return sizeof(float) * (4 * (size_t)g.smax * hw + 4 * (size_t)g.smax * g.rp +
                          2 * (size_t)g.R * hw + (size_t)g.R * g.smax);
}

// The tensor-core layout (bwd_cluster_mma_kernel): wB [nb, ks] bf16, the
// W_hh^T slice transposed, row j (an output column, the .col operand) over
// k = c; A [rp, ks] bf16, dp as the row-major operand; the partials [2, R,
// hst] f32; the dc carry [R, smax] f32. nb = H rounded up to 8 (an mma's
// n), ks = mma_kstride(4 smax), rp = R rounded up to 16 (an mma's m), hst =
// nb rounded up to 16 plus 8 (8 mod 16 words: the accumulators' float2
// stores hit every bank once a half-warp).
__host__ __device__ inline int bwd_mma_nb(int H) { return (H + 7) / 8 * 8; }
__host__ __device__ inline int bwd_mma_hst(int H) { return (bwd_mma_nb(H) + 15) / 16 * 16 + 8; }

__host__ __device__ inline size_t bwd_mma_smem_bytes(const ClusterGeom& g, int H) {
  const size_t ks = mma_kstride(4 * g.smax);
  return align16((size_t)bwd_mma_nb(H) * ks * 2) + align16((size_t)g.rp * ks * 2) +
         sizeof(float) * (2 * (size_t)g.R * bwd_mma_hst(H) + (size_t)g.R * g.smax);
}

// This block's direction, first row and rows: the first half of the
// clusters runs direction 0, the second half direction 1.
struct BwdPlace {
  int dir, row0, nrows;
};

__device__ __forceinline__ BwdPlace bwd_place(const ClusterGeom& g, int B, int dirs) {
  const int per_dir = (B + g.R - 1) / g.R;
  const int q = blockIdx.x / g.C;
  const int dir = dirs == 2 && q >= per_dir ? 1 : 0;
  const int row0 = (q - dir * per_dir) * g.R;
  return {dir, row0, min(g.R, B - row0)};
}

// The (row, own unit) items of a thread in the cotangent phase, the same at
// every step: unit mm = threadIdx.x % sk of rows r0, r0 + rl, ... (rl =
// blockDim.x / sk row lanes; the last blockDim.x % sk threads idle), so that
// consecutive threads touch consecutive units of a row and no step divides.
struct BwdItems {
  int mm, r0, rl;
  bool active;
};

__device__ __forceinline__ BwdItems bwd_items(int sk) {
  const int rl = blockDim.x / sk;
  return {(int)threadIdx.x % sk, (int)threadIdx.x / sk, rl, (int)threadIdx.x < rl * sk};
}

// Rows a thread handles at once in the cotangent phase: all their loads are
// in flight before the first is used.
constexpr int kBwdChunk = 4;

// The sum over the C ranks of a cluster, in rank order, of their value at
// offset o of the buffer `buf` in their shared memory: every remote load in
// flight before the first add.
__device__ __forceinline__ float reduce_partials(cooperative_groups::cluster_group& cluster,
                                                 float* buf, int o, int C) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) v[q] = cluster.map_shared_rank(buf, q)[o];
  float acc = v[0];
#pragma unroll
  for (int q = 1; q < kMaxCluster; ++q)
    if (q < C) acc += v[q];
  return acc;
}

// Copies n values src(i) to dst[i], kLoadsInFlight loads in flight a
// thread: a block of few threads loads its W_hh^T slice from L2 without
// waiting on each load in turn.
constexpr int kLoadsInFlight = 16;

template <typename T, typename Src>
__device__ __forceinline__ void load_slice(T* dst, int n, Src src) {
  for (int base = threadIdx.x; base < n; base += kLoadsInFlight * blockDim.x) {
    T v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) v[u] = src(i);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// The streams of step s (x-time t; c_prev at x-time tp, c0 when tp is
// outside [0, T)) for this thread's unit and rows rb, rb + rl, ...: up to
// kBwdChunk rows of i, f, o, g, c, c_prev and dhs, as f32, into v.
template <typename S, typename DH>
__device__ __forceinline__ void bwd_load(const BwdArgs& a, const BwdPlace& pl,
                                         const BwdItems& it, int m0, int s, int rb,
                                         float (&v)[kBwdChunk][7]) {
  const int T = a.T, B = a.B, H = a.H, j = m0 + it.mm;
  const int t = pl.dir ? s : T - 1 - s;
  const int tp = pl.dir ? t + 1 : t - 1;
  const bool first_step = tp < 0 || tp >= T;
  const long long plane = (long long)pl.dir * T * B * H;
  const long long at = plane + ((long long)t * B + pl.row0) * H + j;
  const long long ap = plane + ((long long)tp * B + pl.row0) * H + j;
  const float* c0 = a.c0 + (long long)pl.dir * B * H + (long long)pl.row0 * H + j;
  const long long sdb = a.sdb[pl.dir];
  const DH* dhs = static_cast<const DH*>(a.dhs[pl.dir]) + t * a.sdt[pl.dir] + pl.row0 * sdb + j;
#pragma unroll
  for (int u = 0; u < kBwdChunk; ++u) {
    const int r = rb + u * it.rl;
    if (r < pl.nrows) {
      const long long o = (long long)r * H;
      v[u][0] = to_f(static_cast<const S*>(a.ai)[at + o]);
      v[u][1] = to_f(static_cast<const S*>(a.af)[at + o]);
      v[u][2] = to_f(static_cast<const S*>(a.ao)[at + o]);
      v[u][3] = to_f(static_cast<const S*>(a.ag)[at + o]);
      v[u][4] = to_f(static_cast<const S*>(a.cs)[at + o]);
      v[u][5] = first_step ? c0[o] : to_f(static_cast<const S*>(a.cs)[ap + o]);
      v[u][6] = to_f(dhs[r * sdb]);
    }
  }
}

// The cotangent phase of step s for this thread's items: the dh carry (dhT
// at the first step, else the sum of every rank's partial of the previous
// step `prev`, in rank order), then dc and the four dp: dp to global
// memory, their operands to put(r, c, value) for c = k sk + mm, dc * f to
// the carry dcc [R, smax], which only this thread reads and writes.
// (Loading the next step's streams earlier, between the barrier's halves or
// before the product, does not pay: the barrier's acquire or the product
// absorbs their time; PERF.md.)
template <typename S, typename DH, typename Put>
__device__ __forceinline__ void bwd_cotangents(cooperative_groups::cluster_group& cluster,
                                               const BwdArgs& a, const BwdPlace& pl,
                                               const ClusterGeom& g, const BwdItems& it, int m0,
                                               int sk, int s, int pstride, float* prev, float* dcc,
                                               Put put) {
  if (!it.active) return;
  const int T = a.T, B = a.B, H = a.H, mm = it.mm, j = m0 + it.mm;
  const int t = pl.dir ? s : T - 1 - s;
  const long long carry = (long long)pl.dir * B * H + (long long)pl.row0 * H + j;
  const long long gd = 4LL * H * a.dirs;  // dp's row stride
  S* dp = static_cast<S*>(a.dp) + ((long long)t * B + pl.row0) * gd + (long long)pl.dir * 4 * H +
          j;
  for (int rb = it.r0; rb < pl.nrows; rb += kBwdChunk * it.rl) {
    float v[kBwdChunk][7], dh[kBwdChunk];
    bwd_load<S, DH>(a, pl, it, m0, s, rb, v);
#pragma unroll
    for (int u = 0; u < kBwdChunk; ++u) {
      const int r = rb + u * it.rl;
      if (r < pl.nrows)
        dh[u] = s == 0 ? a.dhT[carry + (long long)r * H]
                       : reduce_partials(cluster, prev, r * pstride + j, g.C);
    }
#pragma unroll
    for (int u = 0; u < kBwdChunk; ++u) {
      const int r = rb + u * it.rl;
      if (r < pl.nrows) {
        const float ig = v[u][0], fg = v[u][1], og = v[u][2], gg = v[u][3], c = v[u][4];
        const float c_prev = v[u][5];
        const float dhv = v[u][6] + dh[u];
        const float tc = tanhf(c);
        const float dc = dhv * og * (1.f - tc * tc) + dcc[r * g.smax + mm];
        const float dpi = (dc * gg) * ig * (1.f - ig);
        const float dpf = (dc * c_prev) * fg * (1.f - fg);
        const float dpo = (dhv * tc) * og * (1.f - og);
        const float dpg = (dc * ig) * (1.f - gg * gg);
        S* d = dp + (long long)r * gd;
        d[0] = from_f<S>(dpi);
        d[H] = from_f<S>(dpf);
        d[2 * H] = from_f<S>(dpo);
        d[3 * H] = from_f<S>(dpg);
        put(r, mm, dpi);
        put(r, sk + mm, dpf);
        put(r, 2 * sk + mm, dpo);
        put(r, 3 * sk + mm, dpg);
        dcc[r * g.smax + mm] = dc * fg;
      }
    }
  }
}

// The end of the chain: dh0 of the own units is the sum of the last step's
// partials `last` in rank order, dc0 the carry. Then one more cluster
// barrier: no block may exit while another still reads its partials.
__device__ __forceinline__ void bwd_terminal(cooperative_groups::cluster_group& cluster,
                                             const BwdArgs& a, const BwdPlace& pl,
                                             const ClusterGeom& g, const BwdItems& it, int m0,
                                             int pstride, float* last, const float* dcc) {
  if (it.active) {
    const long long carry = (long long)pl.dir * a.B * a.H + m0 + it.mm;
    for (int r = it.r0; r < pl.nrows; r += it.rl) {
      const long long o = carry + (long long)(pl.row0 + r) * a.H;
      a.dh0[o] = reduce_partials(cluster, last, r * pstride + m0 + it.mm, g.C);
      a.dc0[o] = dcc[r * g.smax + it.mm];
    }
  }
  cluster_arrive();
  cluster_wait();
}

// the seed of the dc carry of this thread's items, from dcT
__device__ __forceinline__ void bwd_seed(const BwdArgs& a, const BwdPlace& pl,
                                         const ClusterGeom& g, const BwdItems& it, int m0,
                                         float* dcc) {
  if (!it.active) return;
  const long long carry = (long long)pl.dir * a.B * a.H + m0 + it.mm;
  for (int r = it.r0; r < pl.nrows; r += it.rl)
    dcc[r * g.smax + it.mm] = a.dcT[carry + (long long)(pl.row0 + r) * a.H];
}

// The most threads of a SIMT block, bounded as for one block an SM (128
// registers a thread): under a tighter bound ptxas spills the cotangent
// phase's loaded values, and a spill store waits for its load, so every
// row's loads wait in turn.
constexpr int kBwdSimtThreads = 512;

// The f32 instance: each thread a tile of output columns 2 cq, 2 cq + 1 by
// rows r0 .. r0 + RPT - 1 of the partial product, over the block's 4 sk
// rows of W_hh^T; every W value loaded from shared memory feeds 2 RPT FMAs.
template <int RPT>
__global__ void __launch_bounds__(kBwdSimtThreads, 1) bwd_cluster_kernel(BwdArgs a, ClusterGeom g) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int H = a.H, RP = g.rp, R = g.R, smax = g.smax, hw = bwd_hw(H);
  float* ws = reinterpret_cast<float*>(bwd_smem);  // [4 smax, hw] own rows of W_hh^T
  float* dpo = ws + 4 * smax * hw;                   // [4 smax, RP] own dp, transposed
  float* part = dpo + 4 * smax * RP;  // [2, R, hw] own partials, double-buffered
  float* dcc = part + 2 * R * hw;     // [R, smax] own f32 dc carry

  const BwdPlace pl = bwd_place(g, a.B, a.dirs);
  const int rank = (int)cluster.block_rank();
  const int m0 = g.j0[rank], sk = g.j0[rank + 1] - m0, cols = 4 * sk;
  // W_hh^T[k, m0 + c % sk, :] of the direction once: row c is gate c / sk
  const float* wT = static_cast<const float*>(a.wT) + (long long)pl.dir * 4 * a.swk;
  load_slice(ws, cols * hw, [&](int idx) {
    const int c = idx / hw, j = idx - c * hw, k = c / sk;
    return j < H ? wT[k * a.swk + (long long)(m0 + c - k * sk) * a.swm + j] : 0.f;
  });
  for (int idx = threadIdx.x; idx < 4 * smax * RP; idx += blockDim.x) dpo[idx] = 0.f;
  const BwdItems it = bwd_items(sk);
  bwd_seed(a, pl, g, it, m0, dcc);
  __syncthreads();  // the zeros are in place before step 0 writes its dp

  // the product's share of this thread (a thread of a row group beyond the
  // H / 2 column pairs idles in it)
  const int cp = blockDim.x / g.rg;
  const int cq = threadIdx.x % cp, r0 = (threadIdx.x / cp) * RPT;
  const bool owns = 2 * cq < H;
  constexpr int NP = RPT >= 2 ? 1 : 2;  // independent partial sums a row
  long long* stamp = a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? a.prof : nullptr;
  if (stamp) stamp[kBwdPhases * a.T] = global_ns();

  for (int s = 0; s < a.T; ++s) {
    if (stamp) stamp[kBwdPhases * s + kBwdStart] = clock64();
    float* cur = part + (s & 1) * R * hw;
    float* prev = part + ((s + 1) & 1) * R * hw;
    // 1. dh from every rank's partials, dc and dp of the own units
    bwd_cotangents<float, float>(cluster, a, pl, g, it, m0, sk, s, hw, prev, dcc,
                                 [&](int r, int c, float v) { dpo[c * RP + r] = v; });
    if (stamp) stamp[kBwdPhases * s + kBwdCotangents] = clock64();
    __syncthreads();
    if (stamp) stamp[kBwdPhases * s + kBwdSync] = clock64();

    // 2. cur[r, j] = sum_{c < 4 sk} dp[r, c] W^T[c, j], a 2 x RPT tile a thread
    if (owns) {
      float acc[NP][RPT][2];
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[q][r][0] = acc[q][r][1] = 0.f;
      const float* wc = ws + 2 * cq;
      const float* dr = dpo + r0;
      // U rows of W at a time, every operand loaded before the first FMA
      constexpr int U = RPT >= 4 ? 4 : 8;
      int c = 0;
      for (; c + U <= cols; c += U) {
        float2 w[U];
        float dv[U][RPT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          w[u] = *reinterpret_cast<const float2*>(wc + (c + u) * hw);
          load_rows<RPT>(dr + (c + u) * RP, dv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[u % NP][r][0] = fmaf(dv[u][r], w[u].x, acc[u % NP][r][0]);
            acc[u % NP][r][1] = fmaf(dv[u][r], w[u].y, acc[u % NP][r][1]);
          }
      }
      for (; c < cols; ++c) {
        const float2 w = *reinterpret_cast<const float2*>(wc + c * hw);
        float dv[RPT];
        load_rows<RPT>(dr + c * RP, dv);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[0][r][0] = fmaf(dv[r], w.x, acc[0][r][0]);
          acc[0][r][1] = fmaf(dv[r], w.y, acc[0][r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r0 + r < R) {
          float2 v = make_float2(acc[0][r][0], acc[0][r][1]);
#pragma unroll
          for (int q = 1; q < NP; ++q) v.x += acc[q][r][0], v.y += acc[q][r][1];
          *reinterpret_cast<float2*>(cur + (r0 + r) * hw + 2 * cq) = v;
        }
      }
    }
    if (stamp) stamp[kBwdPhases * s + kBwdProduct] = clock64();
    // 3. one cluster barrier: every rank's partials of this step are written
    //    (and every read of the other buffer, at this step's start, is done)
    cluster_arrive();
    cluster_wait();
    if (stamp) stamp[kBwdPhases * s + kBwdBarrier] = clock64();
  }
  if (stamp) stamp[kBwdPhases * a.T + 1] = global_ns();
  bwd_terminal(cluster, a, pl, g, it, m0, hw, part + ((a.T - 1) & 1) * R * hw, dcc);
}

// the most threads of the tensor-core block (12 warps, 168 registers a
// thread; a warp takes several n-tile pairs when H > 192)
constexpr int kBwdMmaThreads = 384;

// The bf16 instance on the tensor cores: warp w computes the n-tile pairs
// (16 output columns) w, w + warps, ... over every m-tile, each W^T fragment
// loaded once for every m-tile, two independent accumulator chains. MT
// m-tiles, 1 to 3, sizes the accumulators.
template <typename DH, int MT>
__global__ void __launch_bounds__(kBwdMmaThreads) bwd_cluster_mma_kernel(BwdArgs a, ClusterGeom g) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int H = a.H, R = g.R, RP = g.rp, smax = g.smax;
  const int nb = bwd_mma_nb(H), ks = mma_kstride(4 * smax), hst = bwd_mma_hst(H);
  __nv_bfloat16* wB = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dA = reinterpret_cast<__nv_bfloat16*>(bwd_smem + align16((size_t)nb * ks * 2));
  float* part = reinterpret_cast<float*>(bwd_smem + align16((size_t)nb * ks * 2) +
                                         align16((size_t)RP * ks * 2));  // [2, R, hst]
  float* dcc = part + 2 * R * hst;  // [R, smax]

  const BwdPlace pl = bwd_place(g, a.B, a.dirs);
  const int rank = (int)cluster.block_rank();
  const int m0 = g.j0[rank], sk = g.j0[rank + 1] - m0, cols = 4 * sk;
  // wB[j, c] = W_hh^T[k, m0 + c % sk, j] of the direction, c = k sk + unit;
  // zero beyond H and 4 sk (consecutive threads read consecutive j), stored
  // transposed; written out here, not through load_slice with a store
  // functor, which measured 0.02-0.05 ms slower a call (PERF.md)
  const __nv_bfloat16* wT = static_cast<const __nv_bfloat16*>(a.wT) + (long long)pl.dir * 4 * a.swk;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int base = threadIdx.x; base < ks * nb; base += kLoadsInFlight * blockDim.x) {
    __nv_bfloat16 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x, c = idx / nb, j = idx - c * nb, k = c / sk;
      v[u] = c < cols && j < H ? wT[k * a.swk + (long long)(m0 + c - k * sk) * a.swm + j]
                               : zero;
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int idx = base + u * blockDim.x, c = idx / nb;
      if (idx < ks * nb) wB[(idx - c * nb) * ks + c] = v[u];
    }
  }
  for (int idx = threadIdx.x; idx < RP * ks; idx += blockDim.x) dA[idx] = zero;
  const BwdItems it = bwd_items(sk);
  bwd_seed(a, pl, g, it, m0, dcc);
  __syncthreads();  // the zeros are in place before step 0 writes its dp

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int NT = nb / 8, KT = (cols + 15) / 16, pairs = (NT + 1) / 2;
  const int gq = lane >> 2, tq = lane & 3;  // an accumulator fragment's row and column pair
  long long* stamp = a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? a.prof : nullptr;
  if (stamp) stamp[kBwdPhases * a.T] = global_ns();

  for (int s = 0; s < a.T; ++s) {
    if (stamp) stamp[kBwdPhases * s + kBwdStart] = clock64();
    float* cur = part + (s & 1) * R * hst;
    float* prev = part + ((s + 1) & 1) * R * hst;
    // 1. dh from every rank's partials, dc and dp of the own units; dp's
    //    bf16 operand into dA
    bwd_cotangents<__nv_bfloat16, DH>(
        cluster, a, pl, g, it, m0, sk, s, hst, prev, dcc,
        [&](int r, int c, float v) { dA[r * ks + c] = __float2bfloat16(v); });
    if (stamp) stamp[kBwdPhases * s + kBwdCotangents] = clock64();
    __syncthreads();
    if (stamp) stamp[kBwdPhases * s + kBwdSync] = clock64();

    // 2. cur = dp W^T on the tensor cores
    for (int pr = warp; pr < pairs; pr += warps) {
      const int na = 2 * pr, nbt = min(2 * pr + 1, NT - 1);
      const bool second = 2 * pr + 1 < NT;
      const __nv_bfloat16* bp =
          wB + ((lane & 16 ? nbt : na) * 8 + (lane & 7)) * ks + ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* ap = dA + (lane & 15) * ks + (lane >> 4) * 8;
      float acc[MT][2][4] = {};
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b[4];
        ldsm_x4(b, bp + kt * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          ldsm_x4(af, ap + m * 16 * ks + kt * 16);
          mma_bf16(acc[m][0], af, b[0], b[1]);
          mma_bf16(acc[m][1], af, b[2], b[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (e == 0 || second) {
            const int c = (e ? nbt : na) * 8 + 2 * tq;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = m * 16 + gq + 8 * hh;
              if (r < R)
                *reinterpret_cast<float2*>(cur + r * hst + c) =
                    make_float2(acc[m][e][2 * hh], acc[m][e][2 * hh + 1]);
            }
          }
    }
    if (stamp) stamp[kBwdPhases * s + kBwdProduct] = clock64();
    // 3. one cluster barrier, as bwd_cluster_kernel
    cluster_arrive();
    cluster_wait();
    if (stamp) stamp[kBwdPhases * s + kBwdBarrier] = clock64();
  }
  if (stamp) stamp[kBwdPhases * a.T + 1] = global_ns();
  bwd_terminal(cluster, a, pl, g, it, m0, hst, part + ((a.T - 1) & 1) * R * hst, dcc);
}

// ---------------------------------------------------------------------------
// launch

// Launches the kernel instance K over the clusters of geometry g. The
// launcher is static: lstm_bwd.cu and bilstm_bwd.cu each build a library of
// their own from this header, and a template's function-local static (the
// record of the shared memory K was opened up to, one for each instance K)
// would otherwise be one object across the process (STB_GNU_UNIQUE): one
// library's record would skip the other's cudaFuncSetAttribute.
template <auto K>
static cudaError_t bwd_launch(const BwdArgs& a, const ClusterGeom& g, int threads, size_t smem,
                             int dev, const DeviceInfo& info, cudaStream_t stream,
                             int* max_active) {
  static std::atomic<int> smem_set[kMaxDevices];
  cudaError_t err = open_smem(K, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.dirs * ((a.B + g.R - 1) / g.R) * g.C;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(K, (unsigned)blocks, threads, smem, g.C, stream, max_active, a, g);
}

// The cluster route at the geometry record `geom` (ops/lstm_cuda.py:
// bwd_geometry): dtype 0 the f32 SIMT kernel at geom[3] rows a thread (1,
// 2, 4, 8), 1 the bf16 tensor-core kernel at geom[4] m-tiles, whose dhs is
// of type DH. Checks what the kernels rely on (the column map, the threads,
// the shared memory the kernel carves); with max_active, writes
// cudaOccupancyMaxActiveClusters there and launches nothing.
template <typename DH>
cudaError_t bwd_cluster_run(int dtype, const BwdArgs& a, const int* geom, cudaStream_t stream,
                            int* max_active) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  if (geom[0] != 1 || (a.dirs != 1 && a.dirs != 2)) return cudaErrorInvalidValue;
  ClusterGeom g;
  err = read_cluster_geom(geom, a.H, 4 * geom[7], &g);
  if (err != cudaSuccess) return err;
  const int threads = geom[5];
  if (threads < 32 || threads % 32) return cudaErrorInvalidValue;
  if (dtype == 1) {
    const int pairs = (bwd_mma_nb(a.H) / 8 + 1) / 2;
    const size_t smem = bwd_mma_smem_bytes(g, a.H);
    if (geom[3] != 16 || threads > kBwdMmaThreads || threads > 32 * (pairs > 4 ? pairs : 4) ||
        (size_t)geom[6] != smem)
      return cudaErrorInvalidValue;
    switch (g.rg) {
      case 1:
        return bwd_launch<bwd_cluster_mma_kernel<DH, 1>>(a, g, threads, smem, dev, *info, stream,
                                                           max_active);
      case 2:
        return bwd_launch<bwd_cluster_mma_kernel<DH, 2>>(a, g, threads, smem, dev, *info, stream,
                                                           max_active);
      case 3:
        return bwd_launch<bwd_cluster_mma_kernel<DH, 3>>(a, g, threads, smem, dev, *info, stream,
                                                           max_active);
      default: return cudaErrorInvalidValue;
    }
  }
  const int cp = threads / g.rg;
  const size_t smem = bwd_smem_bytes(g, a.H);
  if (dtype != 0 || threads > kBwdSimtThreads || threads % g.rg || cp % 32 || 2 * cp < a.H ||
      (size_t)geom[6] != smem)
    return cudaErrorInvalidValue;
  switch (geom[3]) {
    case 1:
      return bwd_launch<bwd_cluster_kernel<1>>(a, g, threads, smem, dev, *info, stream,
                                                max_active);
    case 2:
      return bwd_launch<bwd_cluster_kernel<2>>(a, g, threads, smem, dev, *info, stream,
                                                max_active);
    case 4:
      return bwd_launch<bwd_cluster_kernel<4>>(a, g, threads, smem, dev, *info, stream,
                                                max_active);
    case 8:
      return bwd_launch<bwd_cluster_kernel<8>>(a, g, threads, smem, dev, *info, stream,
                                                max_active);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dn
