// The fused power iteration of one rank class (rankDAD's subspace iteration).
//
// Replaces: dinunet_implementations_tpu/ops/poweriter_pallas.py:_poweriter_kernel
// (reached through _poweriter_call / fused_subspace_iteration_grouped). For
// every member G [m, n] of the class, with r columns:
//   P = cholqr2(G Ω);  sig = |columns of G^T P|;  delta = inf
//   while trips < num_iters and delta > tol:
//     Y = G (G^T P);  P = cholqr2(Y);  sig' = sqrt(|columns of Y|)
//     delta = |sig' - sig| / max(|sig|, 1e-12);  sig = sig';  ++trips
//   Q = G^T P
// cholqr2 is two rounds (shift 1e-6, then 1e-7) of: normalize the columns
// (an exactly-zero column becomes the canonical basis vector), Gram
// + (shift * trace + 1e-30) I, Cholesky, triangular inverse, Y L^-T.
// bf16 mode (the lp_matmul policy): the operands of G Ω, G^T P and G (G^T P)
// are rounded to bf16 and the products accumulate in f32; normalization,
// Gram, Cholesky and sig stay f32.
//
// Per-member early exit is exact. The JAX loops run until the worst member
// of the loop is done (the legacy loop over all classes, the Pallas kernel
// over its bucket) and freeze every finished member, so a member's result
// depends only on its own trips. Here each member is one thread block with
// its own loop and no grid-wide synchronization; the block stops at its own
// delta <= tol or num_iters trips. The first G^T P of each trip is the one
// the previous step computed for the same P, so it is reused, and so is the
// last one as Q: 2 + 2 * trips passes over G a member.
//
// What bounds it on this card. Each member's G is read from device memory
// once per product: at the flagship a round's r = 10 class holds 30.7 M f32
// values (122.9 MB), more than the 50 MB L2 and far more than the 132 SMs'
// shared memory (about 30 MB), so G cannot stay on chip as the TPU kernel
// keeps it in VMEM. Streamed, the class's 2 + 2 * trips passes take one
// 36.7 us pass over 122.9 MB at 3.35 TB/s each (0.44 ms for a cold 5-trip
// round); their FMAs, 2.33 M a pass an SM on average, take about as long at
// half the SIMT FMA rate. So the staged route is built to keep HBM busy:
//
// The staged route (poweriter_staged_kernel). One launch per rank class
// (up to 16 shape buckets, their descriptors and tensor maps in the
// kernel's parameters: no table is copied to the device), one block per
// member, each with its own loop and no grid-wide synchronization. The
// wrapper numbers the blocks largest member first, so that the 1 MB
// members start at once and the small ones fill in behind them; each
// record carries its members' index in member order, where trips are
// written. The kernel is bounded to 128 registers so that two blocks share
// an SM: at the flagship 264 slots hold the 224 members in one wave. A is
// G or G^T, whichever is row-major in memory, read in place through its
// strides. Its tiles stream through a ring of 2-4 stages of 16 KB of
// dynamic shared memory, filled by the copy engines: the warp that is the
// last to finish a tile (a count a stage) refills its stage with the tile
// `stages` ahead, and each warp waits on the stage's mbarrier for the
// tile's bytes; no block-wide barrier stands between two tiles, and no
// warp waits for a stage to empty.
//   Y = A x walks column bands of 64 rows by 64 columns, copied as two
// 64 x 32 boxes of the bucket's tensor map (zero past A's edges, 128-byte
// swizzled): eight lanes own two rows, each lane a 16-byte chunk of each
// box, their R sums in registers across the bands, added across the eight
// lanes when the row chunk is done; x arrives as float4 reads that eight
// lanes of a row spread over eight bank groups.
//   Y = A^T y walks row bands [band_rows, <= 1024 columns], one bulk copy
// a row: thread t owns 4 columns and their 4 R sums across the bands, y
// arrives as broadcast float4 reads of 4 rows.
// Each sum runs in a fixed order. (One tile layout for both products, row
// strips, would need a reduction across the threads that split a row in
// A x; the two band orders read each byte of G once a pass all the same.)
// bf16 mode rounds each G value once as it leaves the tile and each
// iterate once a pass, in place, after its f32 value was written out where
// it is a result; products accumulate in f32. The iterates P [r][m] and
// G^T P [r][n] stay in shared memory (column-major, padded to 4), the r x r
// work (Gram, Cholesky, inverse) runs in one warp, as in the direct route.

// The direct route (poweriter_direct_kernel, the first design), for a
// class the staged route does not take (a member or a row of A not in
// whole 16-byte chunks, or iterates and ring over half an SM's shared
// memory): the same
// loop with the iterates in shared memory, and each product reading G with
// scalar loads, one warp a row of A (A x) or one thread a column (A^T y),
// one shared-memory operand load per FMA, at one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace dn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 16;
constexpr int kMaxBuckets = 16;

// One shape bucket of the class for the direct kernel (the first twelve
// fields of the wrapper's record): members l = 0 .. count-1 are blocks
// first + l of the launch, in member order.
struct Bucket {
  long long g;           // address of member 0's G[0, 0] (f32)
  long long sl, sm, sn;  // element strides: member, G's rows, G's columns (sm or sn is 1)
  long long om, oml;     // Ω [n, r] row-major f32 of member 0; member stride (0: shared)
  long long p, q;        // out: P [count, m, r] and Q [count, n, r], contiguous f32
  long long m, n, first, count;
};

struct Buckets {
  Bucket b[kMaxBuckets];
  int size;
};

// an operand of a large product: rounded to the product's input type
template <typename T>
__device__ __forceinline__ float op(float v) {
  return v;
}
template <>
__device__ __forceinline__ float op<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[c][i] = sum_j A[i, j] x[c][j] for the rows i of A (A[i, j] at
// A + i * lda + j): one warp a row, lanes along it, r sums reduced by shuffles.
template <typename T, int R>
__device__ void rows_times(const float* __restrict__ A, long long lda, int rows, int cols,
                           const float* x, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += kWarps) {
    const float* a = A + (long long)i * lda;
    float acc[R];
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = 0.f;
    for (int j = lane; j < cols; j += 32) {
      const float av = op<T>(__ldg(a + j));
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] = fmaf(av, op<T>(x[c * cols + j]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = warp_sum(acc[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < R; ++c) out[c * rows + i] = acc[c];
    }
  }
}

// out[c][j] = sum_i A[i, j] y[c][i] for the columns j of A: one thread a
// column, looping over the rows; a warp reads a row's neighbouring values.
template <typename T, int R>
__device__ void cols_times(const float* __restrict__ A, long long lda, int rows, int cols,
                           const float* y, float* out) {
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float acc[R];
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = 0.f;
    const float* a = A + j;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float av = op<T>(__ldg(a + (long long)i * lda));
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] = fmaf(av, op<T>(y[c * rows + i]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) out[c * cols + j] = acc[c];
  }
}

// The member's matrix as A = G (row-major) or A = G^T (G column-major).
struct Mat {
  const float* a;
  long long lda;
  int m, n;
  bool g_is_a;
};

// z [r][n] = G^T p, p [r][m]
template <typename T, int R>
__device__ void gt_times(const Mat& g, const float* p, float* z) {
  if (g.g_is_a)
    cols_times<T, R>(g.a, g.lda, g.m, g.n, p, z);
  else
    rows_times<T, R>(g.a, g.lda, g.n, g.m, p, z);
}

// y [r][m] = G z, z [r][n]
template <typename T, int R>
__device__ void g_times(const Mat& g, const float* z, float* y) {
  if (g.g_is_a)
    rows_times<T, R>(g.a, g.lda, g.m, g.n, z, y);
  else
    cols_times<T, R>(g.a, g.lda, g.n, g.m, z, y);
}

// norms[c] = |x[c]| over x [r][len], column c at x + c * ld: one warp a column
template <int R>
__device__ void col_norms(const float* x, int len, int ld, float* norms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < R; c += kWarps) {
    float s = 0.f;
    for (int i = lane; i < len; i += 32) s = fmaf(x[c * ld + i], x[c * ld + i], s);
    s = warp_sum(s);
    if (lane == 0) norms[c] = sqrtf(s);
  }
}

struct Small {  // the block's r x r scratch
  float* gram;  // [R][R]
  float* chol;  // [R][R] lower
  float* linv;  // [R][R] lower
};

// One shifted CholeskyQR round of y [r][m] (column c at y + c * ld), in
// place; norms gets the pre-normalization column norms.
template <int R>
__device__ void cholqr_round(float* y, int m, int ld, float shift, float* norms, const Small& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  col_norms<R>(y, m, ld, norms);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * m; idx += kThreads) {
    const int c = idx / m, i = idx - c * m;
    const float nc = norms[c];
    float& v = y[c * ld + i];
    v = nc > 0.f ? v / fmaxf(nc, 1e-30f) : (i == c ? 1.f : 0.f);
  }
  __syncthreads();
  // the Gram's lower triangle, one warp a pair (a, b <= a)
  for (int pr = warp; pr < R * (R + 1) / 2; pr += kWarps) {
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= pr) ++a;
    const int b = pr - a * (a + 1) / 2;
    float acc = 0.f;
    for (int i = lane; i < m; i += 32) acc = fmaf(y[a * ld + i], y[b * ld + i], acc);
    acc = warp_sum(acc);
    if (lane == 0) s.gram[a * R + b] = s.gram[b * R + a] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    float tr = 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) tr += s.gram[c * R + c];
    const float add = shift * tr + 1e-30f;
    __syncwarp();
    if (lane < R) {
      s.gram[lane * R + lane] += add;
      for (int k = 0; k < R; ++k) s.chol[lane * R + k] = 0.f;
    }
    __syncwarp();
    // Cholesky-Banachiewicz, lane = row (lowrank._small_cholesky)
    for (int j = 0; j < R; ++j) {
      if (lane == j) {
        float acc = 0.f;
        for (int k = 0; k < j; ++k) acc = fmaf(s.chol[j * R + k], s.chol[j * R + k], acc);
        s.chol[j * R + j] = sqrtf(s.gram[j * R + j] - acc);
      }
      __syncwarp();
      if (lane > j && lane < R) {
        float acc = 0.f;
        for (int k = 0; k < j; ++k) acc = fmaf(s.chol[lane * R + k], s.chol[j * R + k], acc);
        s.chol[lane * R + j] = (s.gram[lane * R + j] - acc) / s.chol[j * R + j];
      }
      __syncwarp();
    }
    // forward-substitution inverse, lane = column (lowrank._small_tril_inverse)
    if (lane < R) {
      for (int i = 0; i < R; ++i) {
        float acc = 0.f;
        for (int k = 0; k < i; ++k) acc = fmaf(s.chol[i * R + k], s.linv[k * R + lane], acc);
        s.linv[i * R + lane] = ((i == lane ? 1.f : 0.f) - acc) / s.chol[i * R + i];
      }
    }
  }
  __syncthreads();
  // y <- y L^-T, row by row: y[c][i] = sum_{k <= c} y[k][i] Linv[c][k]
  for (int i = threadIdx.x; i < m; i += kThreads) {
    float row[R];
#pragma unroll
    for (int c = 0; c < R; ++c) row[c] = y[c * ld + i];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k <= c; ++k) acc = fmaf(row[k], s.linv[c * R + k], acc);
      y[c * ld + i] = acc;
    }
  }
  __syncthreads();
}

template <int R>
__device__ void cholqr2(float* y, int m, int ld, float* norms, float* scratch_norms,
                        const Small& s) {
  cholqr_round<R>(y, m, ld, 1e-6f, norms, s);
  cholqr_round<R>(y, m, ld, 1e-7f, scratch_norms, s);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    poweriter_direct_kernel(const __grid_constant__ Buckets bs, int num_iters, float tol, int* trips) {
  extern __shared__ float smem[];
  __shared__ float gram[R * R], chol[R * R], linv[R * R];
  __shared__ float norms[R], norms2[R], sig[R];
  __shared__ float s_delta;
  int k = 0;
  while (k + 1 < bs.size && (long long)blockIdx.x >= bs.b[k + 1].first) ++k;
  const Bucket& bk = bs.b[k];
  const long long l = (long long)blockIdx.x - bk.first;
  const int m = (int)bk.m, n = (int)bk.n;
  float* P = smem;      // [R][m]: the iterate (and each Y = G G^T P)
  float* Z = P + R * m;  // [R][n]: Ω, then G^T P
  const Small s{gram, chol, linv};
  Mat g;
  g.a = reinterpret_cast<const float*>(bk.g) + l * bk.sl;
  g.m = m;
  g.n = n;
  g.g_is_a = bk.sn == 1;
  g.lda = g.g_is_a ? bk.sm : bk.sn;

  const float* om = reinterpret_cast<const float*>(bk.om) + l * bk.oml;
  for (int idx = threadIdx.x; idx < n * R; idx += kThreads) {
    const int j = idx / R, c = idx - j * R;
    Z[c * n + j] = om[idx];
  }
  __syncthreads();
  g_times<T, R>(g, Z, P);
  __syncthreads();
  cholqr2<R>(P, m, m, norms, norms2, s);
  gt_times<T, R>(g, P, Z);
  __syncthreads();
  col_norms<R>(Z, n, n, sig);
  __syncthreads();

  float delta = INFINITY;
  int t = 0;
  while (t < num_iters && delta > tol) {
    g_times<T, R>(g, Z, P);  // Z holds G^T P of the current P
    __syncthreads();
    cholqr2<R>(P, m, m, norms, norms2, s);
    if (threadIdx.x == 0) {
      float num = 0.f, den = 0.f;
      for (int c = 0; c < R; ++c) {
        const float sn = sqrtf(norms[c]);  // |G G^T p| ~ sigma^2 -> sigma scale
        const float d = sn - sig[c];
        num = fmaf(d, d, num);
        den = fmaf(sig[c], sig[c], den);
        sig[c] = sn;
      }
      s_delta = sqrtf(num) / fmaxf(sqrtf(den), 1e-12f);
    }
    gt_times<T, R>(g, P, Z);
    __syncthreads();
    delta = s_delta;
    ++t;
  }

  float* pout = reinterpret_cast<float*>(bk.p) + l * m * R;
  float* qout = reinterpret_cast<float*>(bk.q) + l * n * R;
  for (int idx = threadIdx.x; idx < m * R; idx += kThreads) {
    const int i = idx / R, c = idx - i * R;
    pout[idx] = P[c * m + i];
  }
  for (int idx = threadIdx.x; idx < n * R; idx += kThreads) {
    const int j = idx / R, c = idx - j * R;
    qout[idx] = Z[c * n + j];
  }
  if (threadIdx.x == 0) trips[blockIdx.x] = t;
}

// ---------------------------------------------------------------------------
// The staged route

constexpr int kStagedFields = 14;
constexpr int kMaxStages = 4;
constexpr int kBand = 64;                // rows and columns of a column-band tile of A (A x)
constexpr int kBox = 32;                 // columns of one of its two tensor boxes (128 bytes)
constexpr int kColChunk = 4 * kThreads;  // columns of A a row-band tile holds: four a thread
constexpr int kStageFloats = kBand * kBand;  // a stage: one column-band tile, 16 KB

// One shape bucket of a staged launch, packed by the wrapper as fourteen
// int64 values: Bucket's twelve, then the member order and the row band.
struct StagedBucket {
  long long g, sl, sm, sn, om, oml, p, q, m, n;
  long long first;      // the launch's block of member 0 (largest members first)
  long long count;
  long long order;      // member 0's index in member order: its trip count is trips[order + l]
  long long band_rows;  // rows of a row-band tile of A (a multiple of 4)
};

// The launch's buckets and, for each, the tensor map of its members' A
// as [count, ra, ca] (ca fastest) with 64 x 32 boxes, 128-byte swizzled.
struct StagedBuckets {
  CUtensorMap map[kMaxBuckets];
  StagedBucket b[kMaxBuckets];
  int size;
};
static_assert(sizeof(StagedBuckets) + 40 <= 4096, "kernel parameters over 4 KB");

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier primitives (shared::cta)
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine, both
// addresses 16-byte aligned; completes on `bar` as transaction bytes
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// one box of a 3D tensor map at (column, row, member) -> shared (1024-byte
// aligned), zero past the tensor's edges; completes on `bar`
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map, int col, int row,
                                            int member, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row), "r"(member),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}

// The phase clock, for measurements: thread 0 of one block (a member of
// the largest bucket) sums clock64() cycles spent in the products (A x and
// A^T y apart), in the ring waits inside them (for a tile to land), in
// refilling the ring (the copies' issue, when its warp finished a tile
// last), and in the r x r chain (the two CholeskyQR rounds and the sigma
// update), into shared memory, so that the clock holds no registers across
// the loops.
enum { kClkAx, kClkAty, kClkWait, kClkIssue, kClkChain, kClkLen };

struct Clock {
  bool on;
  long long* acc;  // shared [kClkLen]
  __device__ __forceinline__ long long now() const { return on ? clock64() : 0; }
  __device__ __forceinline__ void add(int k, long long since) const {
    if (on) acc[k] += clock64() - since;
  }
};

// A member's A (G or G^T, whichever is row-major) and its tiles.
struct StagedMat {
  const float* a;  // A[0, 0]
  const CUtensorMap* map;
  long long lda;
  int member;  // this block's member of the bucket (the map's third coordinate)
  int ra, ca;  // A's rows and columns (ca a multiple of 4)
  int band_rows;
};

// The ring: `stages` stages of kStageFloats floats (1024-byte aligned),
// each with a barrier that completes when its tile has landed (`full`, one
// arrival: the refiller's expect_tx) and a count of the warps done with it
// (`done`). Tiles are numbered across the member's passes: tile j uses
// stage j % stages, the (j / stages)-th time. The warp that is the last to
// finish a tile refills its stage with the tile `stages` ahead, so no warp
// waits for a stage to empty; thread 0 issues a pass's first tiles.
struct Ring {
  float* base;
  int stages;
  unsigned long long* full;
  int* done;
};

// Whether this warp is the last to finish the tile in stage s (lane 0's
// answer, for the whole warp). The last one resets the count, and its
// copies into the stage follow every warp's reads of it.
__device__ __forceinline__ bool ring_release(const Ring& ring, int s) {
  __syncwarp();
  int last = 0;
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    last = atomicAdd(ring.done + s, 1) == kWarps - 1;
    if (last) {
      ring.done[s] = 0;
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  }
  return __shfl_sync(0xffffffffu, last, 0);
}

// Column-band tile k of A into the stage of tile j: row chunk k / nb of
// kBand rows, columns [b * kBand, (b + 1) * kBand) for b = k % nb, as two
// boxes of kBand x kBox (zero past A's edges).
__device__ __forceinline__ void refill_band(const StagedMat& g, const Ring& ring, int k, int nb,
                                            int j, const Clock& clk) {
  const long long i0 = clk.now();
  const int s = j % ring.stages, rc = k / nb, b = k - rc * nb;
  float* dst = ring.base + s * kStageFloats;
  mbar_arrive_expect_tx(ring.full + s, 4 * kStageFloats);
  tensor_copy(dst, g.map, b * kBand, rc * kBand, g.member, ring.full + s);
  tensor_copy(dst + kBand * kBox, g.map, b * kBand + kBox, rc * kBand, g.member, ring.full + s);
  clk.add(kClkIssue, i0);
}

// Row-band tile k of A into the stage of tile j: column chunk k / nb of up
// to kColChunk columns, rows [b * band_rows, ...) for b = k % nb, one bulk
// copy a row at a pitch of the chunk's columns.
__device__ __forceinline__ void refill_rows(const StagedMat& g, const Ring& ring, int k, int nb,
                                            int j, const Clock& clk) {
  const long long i0 = clk.now();
  const int s = j % ring.stages, cc = k / nb, b = k - cc * nb;
  const int r0 = b * g.band_rows, rows = min(g.band_rows, g.ra - r0);
  const int c0 = cc * kColChunk, cols = min(kColChunk, g.ca - c0);
  float* dst = ring.base + s * kStageFloats;
  mbar_arrive_expect_tx(ring.full + s, 4 * rows * cols);
  const float* src = g.a + (long long)r0 * g.lda + c0;
  for (int i = 0; i < rows; ++i)
    bulk_copy(dst + i * cols, src + (long long)i * g.lda, 4 * cols, ring.full + s);
  clk.add(kClkIssue, i0);
}

// tiles of a pass: column bands of row chunks (A x), row bands of column
// chunks (A^T y)
__device__ __forceinline__ int ax_tiles(const StagedMat& g) {
  return ((g.ca + kBand - 1) / kBand) * ((g.ra + kBand - 1) / kBand);
}
__device__ __forceinline__ int aty_tiles(const StagedMat& g) {
  return ((g.ra + g.band_rows - 1) / g.band_rows) * ((g.ca + kColChunk - 1) / kColChunk);
}

// out [R][ra] (column c at out + c * ldo) = A x, x [R][ca] (column c at
// x + c * ldx, already at the operand type). Tiles: column bands of 64
// columns of row chunks of 64 rows, chunk-major. Eight lanes own two rows
// (rw and rw + 32 of the tile), lane ks the 16-byte chunk ks of each box
// (columns c0 + 4 ks and c0 + 32 + 4 ks), and keep their R sums in
// registers over the chunk's bands, added in column order; the eight are
// added pairwise (lanes xor 1, then 2, then 4) when the chunk is done.
// Chunk q of a box row r sits at chunk q ^ (r % 8) (the 128-byte swizzle),
// so the eight lanes of a row read eight bank groups. `kt`: the member's
// tiles before this pass.
template <typename T, int R>
__device__ void pass_ax(const StagedMat& g, const float* x, int ldx, float* out, int ldo,
                        const Ring& ring, int kt, const Clock& clk) {
  const int nb = (g.ca + kBand - 1) / kBand, nt = ax_tiles(g);
  const int rw = threadIdx.x >> 3, ks = threadIdx.x & 7, sw = (ks ^ (rw & 7)) * 4;
  const bool producer = threadIdx.x == 0;
  float acc[2][R];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[h][c] = 0.f;
  if (producer) {  // the last pass's reads of the stages are behind a block barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < min(ring.stages, nt); ++k) refill_band(g, ring, k, nb, kt + k, clk);
  }
  int s = kt % ring.stages, parity = (kt / ring.stages) & 1, b = 0, r0 = 0;
#pragma unroll 1
  for (int k = 0; k < nt; ++k) {
    const long long w0 = clk.now();
    mbar_wait(ring.full + s, parity);
    clk.add(kClkWait, w0);
    const float* tl = ring.base + s * kStageFloats + rw * kBox + sw;
#pragma unroll
    for (int box = 0; box < 2; ++box) {
      const int col = b * kBand + box * kBox + 4 * ks;
      if (col < g.ca) {
        const float4 v0 = *reinterpret_cast<const float4*>(tl + box * kBand * kBox);
        const float4 v1 = *reinterpret_cast<const float4*>(tl + box * kBand * kBox + 32 * kBox);
        const float a0[4] = {op<T>(v0.x), op<T>(v0.y), op<T>(v0.z), op<T>(v0.w)};
        const float a1[4] = {op<T>(v1.x), op<T>(v1.y), op<T>(v1.z), op<T>(v1.w)};
        const float* xr = x + col;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const float4 x4 = *reinterpret_cast<const float4*>(xr + c * ldx);
          acc[0][c] = fmaf(a0[0], x4.x, acc[0][c]);
          acc[1][c] = fmaf(a1[0], x4.x, acc[1][c]);
          acc[0][c] = fmaf(a0[1], x4.y, acc[0][c]);
          acc[1][c] = fmaf(a1[1], x4.y, acc[1][c]);
          acc[0][c] = fmaf(a0[2], x4.z, acc[0][c]);
          acc[1][c] = fmaf(a1[2], x4.z, acc[1][c]);
          acc[0][c] = fmaf(a0[3], x4.w, acc[0][c]);
          acc[1][c] = fmaf(a1[3], x4.w, acc[1][c]);
        }
      }
    }
    if (ring_release(ring, s) && k + ring.stages < nt && (threadIdx.x & 31) == 0)
      refill_band(g, ring, k + ring.stages, nb, kt + k + ring.stages, clk);
    if (++b == nb) {  // the chunk's sums are complete
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + rw + 32 * h;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          float v = acc[h][c];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if (ks == 0 && row < g.ra) out[c * ldo + row] = v;
          acc[h][c] = 0.f;
        }
      }
      b = 0;
      r0 += kBand;
    }
    if (++s == ring.stages) {
      s = 0;
      parity ^= 1;
    }
  }
  __syncthreads();
}

// out [R][ca] (column c at out + c * ldo) = A^T y, y [R][ra] (column c at
// y + c * ldy, already at the operand type, zero past ra). Tiles: row bands
// of column chunks, chunk-major. Thread t owns columns 4t .. 4t + 3 of the
// chunk and their 4 R sums, in registers over the chunk's bands, added in
// row order; each y value is a broadcast read for 4 columns' FMAs. A last
// band's rows past ra, read in a group of 4, hold whatever the stage held
// (the ring starts zeroed and only ever holds this member's G), times the
// zero y past ra.
template <typename T, int R>
__device__ void pass_aty(const StagedMat& g, const float* y, int ldy, float* out, int ldo,
                         const Ring& ring, int kt, const Clock& clk) {
  const int br = g.band_rows, nb = (g.ra + br - 1) / br, nt = aty_tiles(g), q = threadIdx.x;
  const bool producer = threadIdx.x == 0;
  float acc[4][R];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[j][c] = 0.f;
  if (producer) {  // the last pass's reads of the stages are behind a block barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < min(ring.stages, nt); ++k) refill_rows(g, ring, k, nb, kt + k, clk);
  }
  int s = kt % ring.stages, parity = (kt / ring.stages) & 1, b = 0, c0 = 0;
  int cols = min(kColChunk, g.ca), nq = cols >> 2;
#pragma unroll 1
  for (int k = 0; k < nt; ++k) {
    const long long w0 = clk.now();
    mbar_wait(ring.full + s, parity);
    clk.add(kClkWait, w0);
    const float* tl = ring.base + s * kStageFloats + 4 * q;
    const int r0 = b * br, groups = (min(br, g.ra - r0) + 3) >> 2;
    if (q < nq) {
#pragma unroll 1
      for (int g4 = 0; g4 < groups; ++g4) {
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(tl + (4 * g4 + r) * cols);
          a[r][0] = op<T>(v.x);
          a[r][1] = op<T>(v.y);
          a[r][2] = op<T>(v.z);
          a[r][3] = op<T>(v.w);
        }
        const float* yr = y + r0 + 4 * g4;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const float4 y4 = *reinterpret_cast<const float4*>(yr + c * ldy);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][c] = fmaf(a[0][j], y4.x, acc[j][c]);
            acc[j][c] = fmaf(a[1][j], y4.y, acc[j][c]);
            acc[j][c] = fmaf(a[2][j], y4.z, acc[j][c]);
            acc[j][c] = fmaf(a[3][j], y4.w, acc[j][c]);
          }
        }
      }
    }
    if (ring_release(ring, s) && k + ring.stages < nt && (threadIdx.x & 31) == 0)
      refill_rows(g, ring, k + ring.stages, nb, kt + k + ring.stages, clk);
    if (++b == nb) {  // the chunk's sums are complete
      if (q < nq) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < R; ++c) {
            out[c * ldo + c0 + 4 * q + j] = acc[j][c];
            acc[j][c] = 0.f;
          }
        }
      }
      b = 0;
      c0 += kColChunk;
      cols = min(kColChunk, g.ca - c0);
      nq = cols >> 2;
    }
    if (++s == ring.stages) {
      s = 0;
      parity ^= 1;
    }
  }
  __syncthreads();
}

// y [R][m] = G z, z [R][n] (leading dimensions ldy, ldz); kt: the
// member's tiles so far, which this pass advances
template <typename T, int R>
__device__ void staged_g_times(const StagedMat& g, bool g_is_a, const float* z, int ldz, float* y,
                               int ldy, const Ring& ring, int& kt, const Clock& clk) {
  const long long p0 = clk.now();
  if (g_is_a) {
    pass_ax<T, R>(g, z, ldz, y, ldy, ring, kt, clk);
    kt += ax_tiles(g);
  } else {
    pass_aty<T, R>(g, z, ldz, y, ldy, ring, kt, clk);
    kt += aty_tiles(g);
  }
  clk.add(g_is_a ? kClkAx : kClkAty, p0);
}

// z [R][n] = G^T p, p [R][m]
template <typename T, int R>
__device__ void staged_gt_times(const StagedMat& g, bool g_is_a, const float* p, int ldp, float* z,
                                int ldz, const Ring& ring, int& kt, const Clock& clk) {
  const long long p0 = clk.now();
  if (g_is_a) {
    pass_aty<T, R>(g, p, ldp, z, ldz, ring, kt, clk);
    kt += aty_tiles(g);
  } else {
    pass_ax<T, R>(g, p, ldp, z, ldz, ring, kt, clk);
    kt += ax_tiles(g);
  }
  clk.add(g_is_a ? kClkAty : kClkAx, p0);
}

// Ends a pass's use of an f32 iterate x [R][len] (column c at x + c * ld):
// writes it to out [len, R] when it is a result, then rounds it in place to
// the next product's operand type (once a pass: bf16 rounds here and
// nowhere in the product loops).
template <typename T, int R>
__device__ void settle_iterate(float* x, int len, int ld, float* out, bool write, bool round) {
  for (int idx = threadIdx.x; idx < len * R; idx += kThreads) {
    const int i = idx / R, c = idx - i * R;
    const float v = x[c * ld + i];
    if (write) out[idx] = v;
    if (round) x[c * ld + i] = op<T>(v);
  }
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2)
    poweriter_staged_kernel(const __grid_constant__ StagedBuckets bs, int stages, int num_iters,
                            float tol, int* trips, long long* prof) {
  extern __shared__ __align__(16) float staged_smem[];
  __shared__ float gram[R * R], chol[R * R], linv[R * R];
  __shared__ float norms[R], norms2[R], sig[R];
  __shared__ float s_delta;
  __shared__ long long clk_acc[kClkLen];
  __shared__ __align__(8) unsigned long long full_bar[kMaxStages];
  __shared__ int done_count[kMaxStages];
  float* smem = staged_smem;
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  // the clocked block is the one prof[8] names (set by the caller)
  const Clock clk{prof != nullptr && threadIdx.x == 0 && (long long)blockIdx.x == prof[8], clk_acc};
  if (clk.on) {
    for (int i = 0; i < kClkLen; ++i) clk_acc[i] = 0;
    prof[4] = global_ns();
    prof[3] = clock64();
  }
  int k = 0;
  while (k + 1 < bs.size && (long long)blockIdx.x >= bs.b[k + 1].first) ++k;
  const StagedBucket& bk = bs.b[k];
  const long long l = (long long)blockIdx.x - bk.first;
  const int m = (int)bk.m, n = (int)bk.n, mp = round4(m), np = round4(n);
  float* P = smem;       // [R][mp]: the iterate (and each Y = G G^T P), zero past m
  float* Z = P + R * mp;  // [R][np]: Ω, then G^T P, zero past n
  // the ring, 1024-byte aligned for the swizzled boxes (the launch's
  // dynamic shared memory has 1024 bytes of room for it)
  float* ring_base = reinterpret_cast<float*>(
      (reinterpret_cast<unsigned long long>(Z + R * np) + 1023) & ~1023ull);
  const Ring ring{ring_base, stages, full_bar, done_count};
  const Small s{gram, chol, linv};
  const bool g_is_a = bk.sn == 1;
  StagedMat g;
  g.a = reinterpret_cast<const float*>(bk.g) + l * bk.sl;
  g.map = &bs.map[k];
  g.lda = g_is_a ? bk.sm : bk.sn;
  g.member = (int)l;
  g.ra = g_is_a ? m : n;
  g.ca = g_is_a ? n : m;
  g.band_rows = (int)bk.band_rows;

  // the iterates' pads and the ring start zeroed
  for (int idx = threadIdx.x; idx < R * (mp + np); idx += kThreads) smem[idx] = 0.f;
  for (int idx = threadIdx.x; idx < stages * kStageFloats; idx += kThreads) ring_base[idx] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full_bar + i, 1);
      done_count[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the zeroed ring, to the copies
  __syncthreads();
  int kt = 0;
  {
    const float* om = reinterpret_cast<const float*>(bk.om) + l * bk.oml;
    for (int idx = threadIdx.x; idx < n * R; idx += kThreads) {
      const int j = idx / R, c = idx - j * R;
      Z[c * np + j] = op<T>(om[idx]);  // G Ω's operand, rounded once
    }
  }
  __syncthreads();
  staged_g_times<T, R>(g, g_is_a, Z, np, P, mp, ring, kt, clk);
  long long c0 = clk.now();
  cholqr2<R>(P, m, mp, norms, norms2, s);
  clk.add(kClkChain, c0);
  float delta = INFINITY;
  bool more = 0 < num_iters && delta > tol;
  if (!more || kBf16)
    settle_iterate<T, R>(P, m, mp, reinterpret_cast<float*>(bk.p) + l * m * R, !more, kBf16);
  staged_gt_times<T, R>(g, g_is_a, P, mp, Z, np, ring, kt, clk);
  col_norms<R>(Z, n, np, sig);
  __syncthreads();
  if (kBf16 && more) settle_iterate<T, R>(Z, n, np, nullptr, false, true);

  int t = 0;
  while (more) {
    staged_g_times<T, R>(g, g_is_a, Z, np, P, mp, ring, kt, clk);  // Z holds G^T P of the current P
    c0 = clk.now();
    cholqr2<R>(P, m, mp, norms, norms2, s);
    if (threadIdx.x == 0) {
      float num = 0.f, den = 0.f;
      for (int c = 0; c < R; ++c) {
        const float sn = sqrtf(norms[c]);  // |G G^T p| ~ sigma^2 -> sigma scale
        const float d = sn - sig[c];
        num = fmaf(d, d, num);
        den = fmaf(sig[c], sig[c], den);
        sig[c] = sn;
      }
      s_delta = sqrtf(num) / fmaxf(sqrtf(den), 1e-12f);
    }
    __syncthreads();
    clk.add(kClkChain, c0);
    delta = s_delta;
    ++t;
    more = t < num_iters && delta > tol;
    if (!more || kBf16)
      settle_iterate<T, R>(P, m, mp, reinterpret_cast<float*>(bk.p) + l * m * R, !more, kBf16);
    staged_gt_times<T, R>(g, g_is_a, P, mp, Z, np, ring, kt, clk);
    if (kBf16 && more) settle_iterate<T, R>(Z, n, np, nullptr, false, true);
  }
  settle_iterate<T, R>(Z, n, np, reinterpret_cast<float*>(bk.q) + l * n * R, true, false);
  if (threadIdx.x == 0) trips[bk.order + l] = t;
  if (clk.on) {
    prof[0] = clk_acc[kClkAx];
    prof[1] = clk_acc[kClkAty];
    prof[2] = clk_acc[kClkWait];
    prof[5] = clk_acc[kClkChain];
    prof[3] = clock64() - prof[3];
    prof[6] = global_ns();
    prof[7] = t;
    prof[8] = k;  // the member's bucket
    prof[9] = clk_acc[kClkIssue];
  }
}

// ---------------------------------------------------------------------------
// Launchers

template <typename T, int R>
struct Inst {};

template <typename T, typename F>
cudaError_t with_rank(int r, F f) {
  switch (r) {
#define DN_RANK(k) \
  case k:          \
    return f(Inst<T, k>{});
    DN_RANK(1) DN_RANK(2) DN_RANK(3) DN_RANK(4) DN_RANK(5) DN_RANK(6) DN_RANK(7) DN_RANK(8)
    DN_RANK(9) DN_RANK(10) DN_RANK(11) DN_RANK(12) DN_RANK(13) DN_RANK(14) DN_RANK(15)
    DN_RANK(16)
#undef DN_RANK
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype 0: f32 products; 1: bf16 operands, f32 accumulation
template <typename F>
cudaError_t with_instance(int dtype, int r, F f) {
  if (dtype == 0) return with_rank<float>(r, f);
  if (dtype == 1) return with_rank<__nv_bfloat16>(r, f);
  return cudaErrorInvalidValue;
}

struct Launch {
  Buckets buckets;
  int count, max_mn, num_iters;
  float tol;
  int* trips;
  cudaStream_t stream;
};

template <typename T, int R>
cudaError_t launch_direct(Inst<T, R>, const Launch& a) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (size_t)R * (size_t)a.max_mn;
  err = open_smem(poweriter_direct_kernel<T, R>, smem, dev, *info, smem_set);
  if (err != cudaSuccess) return err;
  poweriter_direct_kernel<T, R><<<a.count, kThreads, smem, a.stream>>>(a.buckets, a.num_iters,
                                                                        a.tol, a.trips);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t open_staged(int smem) {
  static std::atomic<int> smem_set[kMaxDevices];
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  return open_smem(poweriter_staged_kernel<T, R>, (size_t)smem, dev, *info, smem_set);
}

struct StagedLaunch {
  StagedBuckets buckets;
  int count, stages, smem, num_iters;
  float tol;
  int* trips;
  long long* prof;
  cudaStream_t stream;
};

template <typename T, int R>
cudaError_t launch_staged(Inst<T, R>, const StagedLaunch& a) {
  cudaError_t err = open_staged<T, R>(a.smem);
  if (err != cudaSuccess) return err;
  poweriter_staged_kernel<T, R><<<a.count, kThreads, a.smem, a.stream>>>(
      a.buckets, a.stages, a.num_iters, a.tol, a.trips, a.prof);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t max_active_staged(Inst<T, R>, int smem, int* out) {
  cudaError_t err = open_staged<T, R>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, poweriter_staged_kernel<T, R>,
                                                       kThreads, (size_t)smem);
}

// Whether the staged kernel takes bucket v (fourteen int64): 16-byte
// aligned members (a nonzero member stride) and rows of A, a width of A in
// whole 16-byte chunks, and a row band that fits a stage.
bool staged_takes(const long long* v) {
  const long long g = v[0], sl = v[1], sm = v[2], sn = v[3], m = v[8], n = v[9];
  const bool g_is_a = sn == 1;
  const long long lda = g_is_a ? sm : sn, ca = g_is_a ? n : m, br = v[13];
  if (g % 16 != 0 || lda % 4 != 0 || ca % 4 != 0) return false;
  if (v[11] > 1 && (sl % 4 != 0 || sl <= 0)) return false;
  return br >= 4 && br % 4 == 0 && br * (ca < kColChunk ? ca : kColChunk) <= kStageFloats;
}

// The tensor map of bucket v's A as [count, ra, ca], kBand x kBox boxes,
// 128-byte swizzle, zero past the edges.
cudaError_t encode_map(const long long* v, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const long long sl = v[1], sm = v[2], sn = v[3], m = v[8], n = v[9], count = v[11];
  const bool g_is_a = sn == 1;
  const long long lda = g_is_a ? sm : sn, ra = g_is_a ? m : n, ca = g_is_a ? n : m;
  const cuuint64_t dims[3] = {(cuuint64_t)ca, (cuuint64_t)ra, (cuuint64_t)count};
  const cuuint64_t strides[2] = {(cuuint64_t)(4 * lda),
                                 (cuuint64_t)(4 * (count > 1 ? sl : lda * ra))};
  const cuuint32_t box[3] = {kBox, kBand, 1}, elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                              reinterpret_cast<void*>(v[0]), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch for one rank class. `buckets` is a host array of `nbuckets`
// records of fourteen int64 (StagedBucket's field order), all of rank r,
// their `first` blocks consecutive from 0 in launch order and their `order`
// ranges a permutation of the members; `max_mn` is the largest m + n among
// them; trips: int32, one per member, in member order. dtype 0: f32
// products; 1: bf16 operands, f32 accumulation.
// geom: {route, stages, smem}: route 0 is the direct kernel (launch order
// must be member order; the other fields are not read), route 1 the staged
// kernel with a ring of `stages` stages of 4 * kStageFloats bytes (16 KB)
// and `smem` bytes of dynamic shared memory, which must be the kernel's
// own count. prof: null, or the staged route's phase clock int64[10] of the
// block prof[8] names: cycles in A x, in A^T y, in ring waits, total;
// global ns at the start; cycles in the r x r chain; global ns at the end;
// trips; bucket; cycles issuing copies.
// Returns the cudaError_t of the launch (0 = launched).
int dn_poweriter(int dtype, const long long* buckets, int nbuckets, int r, int max_mn,
                 int num_iters, float tol, void* trips, const int* geom, void* prof,
                 void* stream) {
  if (nbuckets < 1 || nbuckets > kMaxBuckets || r < 1 || r > kMaxRank || max_mn < 2 ||
      num_iters < 0 || (geom[0] != 0 && geom[0] != 1))
    return cudaErrorInvalidValue;
  long long count = 0;
  for (int k = 0; k < nbuckets; ++k) {
    const long long* v = buckets + (long long)k * kStagedFields;
    if (v[10] != count || v[11] < 1 || v[8] < 1 || v[9] < 1) return cudaErrorInvalidValue;
    count += v[11];
  }
  for (int k = 0; k < nbuckets; ++k) {  // the member order is a permutation
    const long long* v = buckets + (long long)k * kStagedFields;
    if (v[12] < 0 || v[12] + v[11] > count) return cudaErrorInvalidValue;
    for (int k2 = 0; k2 < k; ++k2) {
      const long long* w = buckets + (long long)k2 * kStagedFields;
      if (v[12] < w[12] + w[11] && w[12] < v[12] + v[11]) return cudaErrorInvalidValue;
    }
  }
  if (geom[0] == 0) {
    if (prof) return cudaErrorInvalidValue;
    Launch a{};
    for (int k = 0; k < nbuckets; ++k) {
      const long long* v = buckets + (long long)k * kStagedFields;
      if (v[12] != v[10]) return cudaErrorInvalidValue;
      a.buckets.b[k] = Bucket{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11]};
    }
    a.buckets.size = nbuckets;
    a.count = (int)count;
    a.max_mn = max_mn;
    a.num_iters = num_iters;
    a.tol = tol;
    a.trips = static_cast<int*>(trips);
    a.stream = static_cast<cudaStream_t>(stream);
    return with_instance(dtype, r, [&](auto inst) { return launch_direct(inst, a); });
  }
  StagedLaunch a{};
  a.stages = geom[1];
  if (a.stages < 2 || a.stages > kMaxStages) return cudaErrorInvalidValue;
  long long iterates = 0;
  for (int k = 0; k < nbuckets; ++k) {
    const long long* v = buckets + (long long)k * kStagedFields;
    if (!staged_takes(v)) return cudaErrorInvalidValue;
    const long long mn = round4((int)v[8]) + round4((int)v[9]);
    if (mn > iterates) iterates = mn;
    a.buckets.b[k] = StagedBucket{v[0], v[1], v[2], v[3], v[4], v[5], v[6],
                                  v[7], v[8], v[9], v[10], v[11], v[12], v[13]};
    const cudaError_t err = encode_map(v, &a.buckets.map[k]);
    if (err != cudaSuccess) return err;
  }
  // the iterates, 1024 bytes to align the ring, the ring
  a.smem = 4 * r * (int)iterates + 1024 + a.stages * 4 * kStageFloats;
  if (a.smem != geom[2]) return cudaErrorInvalidValue;
  a.buckets.size = nbuckets;
  a.count = (int)count;
  a.num_iters = num_iters;
  a.tol = tol;
  a.trips = static_cast<int*>(trips);
  a.prof = static_cast<long long*>(prof);
  a.stream = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, r, [&](auto inst) { return launch_staged(inst, a); });
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the staged kernel of
// this dtype and rank at `smem` bytes of dynamic shared memory, on the
// current device, into *out.
int dn_poweriter_max_active_blocks(int dtype, int r, int smem, int* out) {
  return with_instance(dtype, r, [&](auto inst) { return max_active_staged(inst, smem, out); });
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
