// Helpers of the LSTM forward recurrences that run over a thread-block
// cluster: K1's (lstm_fwd.cu, lstm_rec_cluster_kernel) and K3/K5's
// (bilstm_fwd.cu, bilstm_rec_cluster_kernel). The cell update, the cluster
// barrier in two halves, the phase clock, the geometry record that the
// Python launchers work out (ops/lstm_cuda.py:k1_geometry,
// ops/bilstm_cuda.py:bidir_geometry) and its check, and the cluster launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace dn {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// The cell update of one unit of one row, from its four gate
// pre-activations p[0], p[off], p[2*off], p[3*off], which it overwrites with
// the gates i, f, o, g, and its carry *c, which it updates; returns h.
__device__ __forceinline__ float cell(float* p, int off, float* c) {
  const float ig = sigmoid(p[0]);
  const float fg = sigmoid(p[off]);
  const float og = sigmoid(p[2 * off]);
  const float gg = tanhf(p[3 * off]);
  const float cn = fg * *c + ig * gg;
  p[0] = ig, p[off] = fg, p[2 * off] = og, p[3 * off] = gg;
  *c = cn;
  return og * tanhf(cn);
}

// The phase clock of a cluster recurrence, for measurements: one thread
// stamps clock64() at these points of every step t, at prof[5 t + k], and
// the global timer (ns) at the first and the last stamp, at prof[5 T] and
// prof[5 T + 1], which converts cycles to time.
enum { kStepStart, kGathered, kProduct, kGates, kBarrier, kPhases };

__device__ __forceinline__ long long global_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}

// A cluster barrier in two halves: arrive (release: this thread's shared
// memory writes are visible to every rank that waits), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// n consecutive f32 values from shared memory, 16 or 8 bytes at a time
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + q);
      v[q] = f.x, v[q + 1] = f.y, v[q + 2] = f.z, v[q + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

constexpr int kMaxCluster = 8;

// the widest H the cluster route takes (a W_hh slice of 8 blocks holds
// H x H/2 values: above about 340 in f32 and 480 in bf16 none fits)
constexpr int kMaxClusterH = 512;

struct ClusterGeom {
  int C;      // blocks a cluster
  int R;      // rows a cluster
  int rg;     // row groups: the threads are rg groups of blockDim.x / rg
  int rp;     // rows held in shared memory, rg * (rows a group) >= R
  int smax;   // the largest slice of hidden units
  int wst;    // row stride of the W_hh slice and of pre, >= 4 * smax
  int j0[kMaxCluster + 1];  // rank k owns hidden units [j0[k], j0[k + 1])
};

// row stride of the h exchange buffer [smax, rpb]: odd, so that a warp
// writing one row's units and a warp reading one unit's rows both hit
// distinct banks
__host__ __device__ inline int exchange_stride(int rp) { return rp | 1; }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of one block of K1's layout: the W_hh slice [H, wst]
// at the operand type, then f32 h of every unit [H, rp], the own h slice
// double-buffered [2, smax, rp | 1], pre [rp, wst] and the carry [rp, smax].
template <typename S>
__host__ __device__ inline size_t cluster_smem_bytes(const ClusterGeom& g, int H) {
  return align16((size_t)H * g.wst * sizeof(S)) +
         sizeof(float) * ((size_t)H * g.rp + 2 * (size_t)g.smax * exchange_stride(g.rp) +
                          (size_t)g.rp * g.wst + (size_t)g.rp * g.smax);
}

// The geometry record (kGeomLen ints): [0] route (0 streaming, 1 cluster);
// cluster: [1] C, [2] R, [3] rows a thread (or a tile), [4] row groups,
// [5] threads, [6] dynamic shared memory, [7] smax, [8 .. 8 + C] the column
// map j0. K1's streaming route reads [2] rows a block, [5] and [6].
constexpr int kGeomLen = 8 + kMaxCluster + 1;

// Reads a cluster record into *g with row stride wst, and checks what every
// cluster kernel relies on: each unit owned by exactly one rank, no slice
// wider than smax. The caller checks its threads and shared memory.
inline cudaError_t read_cluster_geom(const int* geom, int H, int wst, ClusterGeom* g) {
  const int C = geom[1], rpt = geom[3];
  if ((C != 2 && C != 4 && C != 8) || H > kMaxClusterH || geom[7] < 1 || wst < 4 * geom[7])
    return cudaErrorInvalidValue;
  *g = ClusterGeom{C, geom[2], geom[4], geom[4] * rpt, geom[7], wst, {}};
  if (g->R < 1 || g->rg < 1 || g->rp < g->R) return cudaErrorInvalidValue;
  for (int k = 0; k <= C; ++k) g->j0[k] = geom[8 + k];
  if (g->j0[0] != 0 || g->j0[C] != H) return cudaErrorInvalidValue;
  for (int k = 0; k < C; ++k) {
    const int s = g->j0[k + 1] - g->j0[k];
    if (s < 1 || s > g->smax) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The owner table of the column map: j0s[k] = j0[k], and owner[j] the rank
// that owns unit j.
__device__ __forceinline__ void owner_table(const ClusterGeom& g, int* j0s, unsigned char* owner) {
  if (threadIdx.x <= g.C) j0s[threadIdx.x] = g.j0[threadIdx.x];
  for (int q = 0; q < g.C; ++q)
    for (int j = g.j0[q] + threadIdx.x; j < g.j0[q + 1]; j += blockDim.x) owner[j] = q;
}

// This thread's share of a step's gather (worked out once, before the
// steps): row r = threadIdx.x % RP of units gj, gj + gstep, ...; a warp
// reads consecutive rows of one unit (contiguous on both sides).
struct GatherShare {
  int gstep, gr, gj;
};

__device__ __forceinline__ GatherShare gather_share(int RP, int H) {
  const int gstep = blockDim.x / RP;
  return {gstep, (int)threadIdx.x % RP, (int)threadIdx.x < gstep * RP ? (int)threadIdx.x / RP : H};
}

// The gather of a step: h_{t-1} of every unit j < H and row r < RP from the
// exchange buffer `cur` [smax, rpb] of the rank that owns j, handed to
// put(j, r, value), four loads in flight. Needs owner_table's j0s, owner.
template <typename Put>
__device__ __forceinline__ void gather(cooperative_groups::cluster_group& cluster, float* cur,
                                       const int* j0s, const unsigned char* owner, int H, int rpb,
                                       const GatherShare& sh, Put put) {
  for (int j = sh.gj; j < H; j += 4 * sh.gstep) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ju = j + u * sh.gstep;
      if (ju < H) {
        const int q = owner[ju];
        v[u] = cluster.map_shared_rank(cur, q)[(ju - j0s[q]) * rpb + sh.gr];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j + u * sh.gstep < H) put(j + u * sh.gstep, sh.gr, v[u]);
  }
}

// ---------------------------------------------------------------------------
// bf16 products on the tensor cores (mma.sync m16n8k16, f32 accumulators)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory: lane i gives the address of row
// i % 8 of matrix i / 8 (16 bytes, 16-byte aligned); r[q] is matrix q's
// fragment (row lane / 4, elements 2 (lane % 4), + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a a 16x16 bf16 tile (row-major fragments a[0..3]), b a 16x8
// tile (column-major fragments b0, b1), d 16x8 f32 (d[0..1] row lane / 4,
// d[2..3] row lane / 4 + 8, columns 2 (lane % 4), + 1)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The row stride, in bf16 values, of an mma operand whose k runs over n
// values: n rounded up to 16 (an mma's k), plus 8, an odd number of 16-byte
// chunks, so that ldmatrix's eight row addresses hit distinct banks.
__host__ __device__ inline int mma_kstride(int n) { return (n + 15) / 16 * 16 + 8; }

// Launches `kernel` over `blocks` blocks in clusters of C, or, when
// max_active is not null, writes cudaOccupancyMaxActiveClusters of that
// configuration there and launches nothing.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), unsigned blocks, int threads, size_t smem,
                           int C, cudaStream_t stream, int* max_active, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active) return cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dn
