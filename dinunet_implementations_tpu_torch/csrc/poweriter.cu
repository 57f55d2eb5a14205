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
// (or L2) once per product: at the flagship a round's class holds 30.7 M
// f32 values (122.9 MB), more than the 50 MB L2 and far more than 227 KB of
// shared memory, so G cannot stay on chip as the TPU kernel keeps it in
// VMEM. The bytes that must move (G once, Ω, P, Q) take ~0.037 ms; the
// products, 2 m n r FLOP each, ~8 GFLOP for a cold 5-trip round, take
// ~0.12 ms at the f32 peak: the operations bound it.
//
// What this first design does about it. One launch per rank class (up to
// 16 shape buckets), one block per member. The buckets' descriptors (G's
// pointer and strides, Ω, P, Q, m, n) travel in the kernel's parameters, so
// a launch needs no table copied to the device and the host never waits for
// the stream; members of any shapes share the launch and a transposed leaf
// is read in place through its strides. The iterates P [r][m] and G^T P
// [r][n] stay in shared memory (column-major, so a warp reads consecutive
// rows), the class's largest m + n sets the dynamic shared memory. Each
// product reads G coalesced: "A" is G or G^T, whichever is row-major in
// memory; A x (one warp per row of A, lanes along the row, r partial sums
// reduced by shuffles) and A^T y (one thread per column of A, looping over
// rows, neighbouring threads on neighbouring addresses). The r x r work
// (Gram, Cholesky, inverse) runs in one warp, lanes over rows or columns.
// The products are scalar FMAs with a shared-memory operand each: a later
// PR can stage G tiles and use the tensor cores (wgmma) in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace dn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 16;
constexpr int kMaxBuckets = 16;
constexpr int kBucketFields = 12;

// One shape bucket of the class, packed by the wrapper as twelve int64
// values: members l = 0 .. count-1 are blocks first + l of the launch.
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

// norms[c] = |x[c]| over x [r][len]: one warp a column
template <int R>
__device__ void col_norms(const float* x, int len, float* norms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < R; c += kWarps) {
    float s = 0.f;
    for (int i = lane; i < len; i += 32) s = fmaf(x[c * len + i], x[c * len + i], s);
    s = warp_sum(s);
    if (lane == 0) norms[c] = sqrtf(s);
  }
}

struct Small {  // the block's r x r scratch
  float* gram;  // [R][R]
  float* chol;  // [R][R] lower
  float* linv;  // [R][R] lower
};

// One shifted CholeskyQR round of y [r][m], in place; norms gets the
// pre-normalization column norms.
template <int R>
__device__ void cholqr_round(float* y, int m, float shift, float* norms, const Small& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  col_norms<R>(y, m, norms);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * m; idx += kThreads) {
    const int c = idx / m, i = idx - c * m;
    const float nc = norms[c];
    y[idx] = nc > 0.f ? y[idx] / fmaxf(nc, 1e-30f) : (i == c ? 1.f : 0.f);
  }
  __syncthreads();
  // the Gram's lower triangle, one warp a pair (a, b <= a)
  for (int pr = warp; pr < R * (R + 1) / 2; pr += kWarps) {
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= pr) ++a;
    const int b = pr - a * (a + 1) / 2;
    float acc = 0.f;
    for (int i = lane; i < m; i += 32) acc = fmaf(y[a * m + i], y[b * m + i], acc);
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
    for (int c = 0; c < R; ++c) row[c] = y[c * m + i];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k <= c; ++k) acc = fmaf(row[k], s.linv[c * R + k], acc);
      y[c * m + i] = acc;
    }
  }
  __syncthreads();
}

template <int R>
__device__ void cholqr2(float* y, int m, float* norms, float* scratch_norms, const Small& s) {
  cholqr_round<R>(y, m, 1e-6f, norms, s);
  cholqr_round<R>(y, m, 1e-7f, scratch_norms, s);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    poweriter_kernel(const __grid_constant__ Buckets bs, int num_iters, float tol, int* trips) {
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
  cholqr2<R>(P, m, norms, norms2, s);
  gt_times<T, R>(g, P, Z);
  __syncthreads();
  col_norms<R>(Z, n, sig);
  __syncthreads();

  float delta = INFINITY;
  int t = 0;
  while (t < num_iters && delta > tol) {
    g_times<T, R>(g, Z, P);  // Z holds G^T P of the current P
    __syncthreads();
    cholqr2<R>(P, m, norms, norms2, s);
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

struct Launch {
  Buckets buckets;
  int count, max_mn, num_iters;
  float tol;
  int* trips;
  cudaStream_t stream;
};

template <typename T, int R>
cudaError_t launch(const Launch& a) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (size_t)R * (size_t)a.max_mn;
  err = open_smem(poweriter_kernel<T, R>, smem, dev, *info, smem_set);
  if (err != cudaSuccess) return err;
  poweriter_kernel<T, R><<<a.count, kThreads, smem, a.stream>>>(a.buckets, a.num_iters, a.tol,
                                                                 a.trips);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rank(const Launch& a, int r) {
  switch (r) {
#define DN_RANK(k) \
  case k:          \
    return launch<T, k>(a);
    DN_RANK(1) DN_RANK(2) DN_RANK(3) DN_RANK(4) DN_RANK(5) DN_RANK(6) DN_RANK(7) DN_RANK(8)
    DN_RANK(9) DN_RANK(10) DN_RANK(11) DN_RANK(12) DN_RANK(13) DN_RANK(14) DN_RANK(15)
    DN_RANK(16)
#undef DN_RANK
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: f32 products; 1: bf16 operands, f32 accumulation. `buckets` is a
// host array of `nbuckets` Bucket records (twelve int64 each, in Bucket's
// field order), all of rank r, their `first` members consecutive from 0;
// `max_mn` is the largest m + n among them. trips: int32, one per member.
// Returns the cudaError_t of the launch (0 = launched).
int dn_poweriter(int dtype, const long long* buckets, int nbuckets, int r, int max_mn,
                 int num_iters, float tol, void* trips, void* stream) {
  if (nbuckets < 1 || nbuckets > kMaxBuckets || r < 1 || r > kMaxRank || max_mn < 2 ||
      num_iters < 0)
    return cudaErrorInvalidValue;
  Launch a{};
  long long count = 0;
  for (int k = 0; k < nbuckets; ++k) {
    const long long* v = buckets + (long long)k * kBucketFields;
    a.buckets.b[k] = Bucket{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11]};
    if (v[10] != count || v[11] < 1) return cudaErrorInvalidValue;
    count += v[11];
  }
  a.buckets.size = nbuckets;
  a.count = (int)count;
  a.max_mn = max_mn;
  a.num_iters = num_iters;
  a.tol = tol;
  a.trips = static_cast<int*>(trips);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rank<float>(a, r);
  if (dtype == 1) return dispatch_rank<__nv_bfloat16>(a, r);
  return cudaErrorInvalidValue;
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
