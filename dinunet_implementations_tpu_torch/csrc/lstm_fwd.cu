// K1: single-direction LSTM forward over a whole sequence, in two launches.
//
// Replaces: dinunet_implementations_tpu/ops/lstm_pallas.py:_fwd_fused_kernel
// (:91; called at :158 by _fwd_fused_call, behind lstm_recurrence_fused and
// lstm_forward_fused). Per step t and row b, for the gates in the order
// i, f, o, g:
//   pre_k = (x_t @ W_ih[k] + b[k]) + h @ W_hh[k]
//   i, f, o = sigmoid(pre_i, pre_f, pre_o);  g = tanh(pre_g)
//   c = f * c + i * g;  h = o * tanh(c)
// It writes hs (and, when the caller passes them, the residuals cs, i, f, o,
// g) at the stream dtype, and hT, cT in f32 straight from the carry.
// bf16 mode: x, W_ih, W_hh and the h fed to the recurrent product are bf16;
// products of two bf16 values are exact in f32 and are accumulated in f32,
// which is what the TPU kernel's preferred_element_type=f32 dots compute.
//
// What bounds it on this card. The recurrence is 98 serial steps (flagship:
// T=98, D=256, H=174), each 2*rows*H*4H FLOP against W_hh (4*H*H values,
// 484 KB in f32). The first design (PRs 1-4) kept the i2h product inside the
// loop: every step re-read all of W_ih and W_hh (1.2 MB in f32) from L2 and
// waited on the latency of each thread's chain of 430 dependent loads, about
// 25 us a step (PERF.md). Each stage below takes work off that step.
//
// Stage 1, lstm_proj_kernel: the i2h product depends on no step, so it
// leaves the loop. One tiled SIMT GEMM over all T*rows rows (64x64 output
// tiles, K staged through shared memory in chunks of 16, a 4x4 micro-tile a
// thread, f32 accumulation) writes xp = x W_ih + b into an f32
// scratch [T, rows, 4H] that the wrapper allocates. Writing and reading it
// back is the design's own cost (140 MB at 512 rows). A step of the
// recurrence then streams only W_hh: 174 loads a column instead of 430.
//
// Stage 2, lstm_rec_cluster_kernel: W_hh is split over a thread-block
// cluster of C blocks (C in 2, 4, 8, the smallest whose slice fits). Block k
// owns hidden units [j0_k, j0_{k+1}) and all four gates of them, so the cell
// update never leaves the block; it holds its W_hh columns in shared memory
// for the whole sequence, and a step reads no weight from L2 at all. The
// blocks exchange h once a step through distributed shared memory: each
// gathers h_{t-1} from every rank's buffer, computes its gates, writes its
// new h slice into its own second buffer, and the cluster meets at one
// barrier, whose arrive and wait halves the stream stores sit between. A
// thread owns one gate column and RPT rows, and loads the operands of
// several units before their FMAs, so that it waits on one shared-memory
// latency per chunk, not per unit. A step is then bounded by the product's
// shared-memory loads and FMAs at the training fold, and by the latencies
// of the gather, the gates and the barrier at serving sizes (the phase
// clock, kPhases, measures each). The launch geometry (C, rows a cluster,
// threads, the column map) is worked out in Python
// (ops/lstm_cuda.py:k1_geometry) and checked here.
//
// lstm_rec_stream_kernel is stage 1's recurrence, kept for shapes whose
// W_hh slice fits no cluster of 8 (H above about 340 in f32): each block owns
// up to 8 rows, walks all T steps, and streams W_hh from L2 every step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dn;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// ---------------------------------------------------------------------------
// Stage 1: the i2h projection

struct ProjArgs {
  const void* x;  // x[t, b, d] at t*sxt + b*sxb + d
  long long sxt, sxb;
  const void* wih;  // W_ih[k, d, j] at k*swk + d*swd + j
  long long swk, swd;
  const float* b;  // b[k, j] at k*sbk + j
  long long sbk;
  float* xp;  // [T, B, 4H] contiguous f32
  int T, B, D, H;
};

constexpr int kTM = 64, kTN = 64, kTK = 16, kProjThreads = 256;

template <typename S>
__global__ void __launch_bounds__(kProjThreads) lstm_proj_kernel(ProjArgs a) {
  // +4: the K-major stores of a row chunk land in two banks, not one
  __shared__ __align__(16) float As[kTK][kTM + 4];
  __shared__ __align__(16) float Bs[kTK][kTN + 4];
  const int M = a.T * a.B, N = 4 * a.H, tid = threadIdx.x;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const S* x = static_cast<const S*>(a.x);
  const S* w = static_cast<const S*>(a.wih);

  // what this thread stages: 4 consecutive d of one row of x, and 4
  // consecutive columns of one d of W_ih
  const int am = tid / 4, ak = (tid % 4) * 4;
  long long xrow = -1;
  if (m0 + am < M) {
    const int t = (m0 + am) / a.B, b = m0 + am - t * a.B;
    xrow = t * a.sxt + (long long)b * a.sxb;
  }
  const int bk = tid / 16, bn = (tid % 16) * 4;
  long long wcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + bn + i;
    const int k = n / a.H;
    wcol[i] = n < N ? k * a.swk + (n - k * a.H) : -1;
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.D; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = k0 + ak + i;
      As[ak + i][am] = (xrow >= 0 && d < a.D) ? to_f(x[xrow + d]) : 0.f;
    }
    const int d = k0 + bk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Bs[bk][bn + i] = (wcol[i] >= 0 && d < a.D) ? to_f(w[wcol[i] + d * a.swd]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const int k = n / a.H;
    const float bias = a.b[k * a.sbk + (n - k * a.H)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) a.xp[(long long)m * N + n] = acc[i][j] + bias;
    }
  }
}

// ---------------------------------------------------------------------------
// The recurrence over xp

struct RecArgs {
  const float* xp;  // [T, B, 4H] f32: x W_ih + b
  const void* whh;  // W_hh[k, h, j] at k*suk + h*suh + j
  long long suk, suh;
  const float* h0;  // [B, H] contiguous
  const float* c0;
  void* hs;  // [T, B, H] contiguous, stream dtype; cs..ag may be null
  void* cs;
  void* ai;
  void* af;
  void* ao;
  void* ag;
  float* hT;  // [B, H] f32
  float* cT;
  int T, B, H;
  // null, or [5 T + 2]: the cluster kernel's phase clock (see kPhases)
  long long* prof;
};

// The cluster kernel's phase clock, for measurements: block 0's thread 0
// stamps clock64() at these points of every step t, at prof[5 t + k], and
// the global timer (ns) at the first and the last stamp, at prof[5 T] and
// prof[5 T + 1], which converts cycles to time.
enum { kStepStart, kGathered, kProduct, kGates, kBarrier, kPhases };

__device__ __forceinline__ long long global_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}

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

// The streams of unit j of row `row` at step t from what cell() left: the
// gates in p, the carry c and h.
template <typename S>
__device__ __forceinline__ void write_streams(const RecArgs& a, const float* p, int off, float c,
                                              float h, int t, int row, int j) {
  const long long o = ((long long)t * a.B + row) * a.H + j;
  store<S>(a.hs, o, h);
  store<S>(a.cs, o, c);
  store<S>(a.ai, o, p[0]);
  store<S>(a.af, o, p[off]);
  store<S>(a.ao, o, p[2 * off]);
  store<S>(a.ag, o, p[3 * off]);
  if (t == a.T - 1) {
    const long long q = (long long)row * a.H + j;
    a.hT[q] = h;  // the f32 carry, never the stream dtype
    a.cT[q] = c;
  }
}

// A cluster barrier in two halves: arrive (release: this thread's shared
// memory writes are visible to every rank that waits), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Stage 1's recurrence: R rows a block, W_hh streamed from L2 every step.
template <typename S, int R>
__global__ void __launch_bounds__(1024) lstm_rec_stream_kernel(RecArgs a) {
  extern __shared__ float stream_smem[];
  const int H = a.H, G = 4 * H;
  float* hsm = stream_smem;  // [R, H] h as the recurrent product reads it
  float* csm = hsm + R * H;  // [R, H] f32 cell carry
  float* pre = csm + R * H;  // [R, 4H] gate pre-activations
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const S* whh = static_cast<const S*>(a.whh);

  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    const long long o = (long long)(row0 + r) * H + j;
    hsm[idx] = r < nrows ? as_operand<S>(a.h0[o]) : 0.f;
    csm[idx] = r < nrows ? a.c0[o] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      const int k = col / H, j = col - k * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const S* u = whh + k * a.suk + j;
#pragma unroll 8
      for (int h = 0; h < H; ++h) {
        const float uv = to_f(u[h * a.suh]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hsm[r * H + h], uv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = r < nrows ? a.xp[((long long)t * a.B + row0 + r) * G + col] : 0.f;
        pre[r * G + col] = xv + acc[r];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H;
      float* p = pre + r * G + j;
      const float h = cell(p, H, csm + idx);
      hsm[idx] = as_operand<S>(h);
      if (r < nrows) write_streams<S>(a, p, H, csm[idx], h, t, row0 + r, j);
    }
    __syncthreads();
  }
}

// Stage 2's geometry, from ops/lstm_cuda.py:k1_geometry.
constexpr int kMaxCluster = 8;

// the widest H the cluster route takes (a W_hh slice of 8 blocks holds
// H x H/2 values: above about 340 in f32 and 480 in bf16 none fits)
constexpr int kMaxClusterH = 512;

struct ClusterGeom {
  int C;      // blocks a cluster
  int R;      // rows a cluster
  int rg;     // row groups: the threads are rg groups of cp = blockDim.x / rg columns
  int rp;     // rows held in shared memory, rg * RPT >= R
  int smax;   // the largest slice of hidden units
  int wst;    // 4 * smax: row stride of the W_hh slice and of pre
  int j0[kMaxCluster + 1];  // rank k owns hidden units [j0[k], j0[k + 1])
};

// row stride of the h exchange buffer [smax, rpb]: odd, so that a warp
// writing one row's units and a warp reading one unit's rows both hit
// distinct banks
__host__ __device__ inline int exchange_stride(int rp) { return rp | 1; }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of one cluster block; the layout the kernel carves.
template <typename S>
__host__ __device__ inline size_t cluster_smem_bytes(const ClusterGeom& g, int H) {
  return align16((size_t)H * g.wst * sizeof(S)) +
         sizeof(float) * ((size_t)H * g.rp + 2 * (size_t)g.smax * exchange_stride(g.rp) +
                          (size_t)g.rp * g.wst + (size_t)g.rp * g.smax);
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

template <typename S, int RPT>
__global__ void __launch_bounds__(1024) lstm_rec_cluster_kernel(RecArgs a, ClusterGeom g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  __shared__ int j0s[kMaxCluster + 1];
  __shared__ unsigned char owner[kMaxClusterH];  // the rank that owns each unit
  const int H = a.H, G = 4 * H, RP = g.rp, smax = g.smax, wst = g.wst;
  const int rpb = exchange_stride(RP);
  S* ws = reinterpret_cast<S*>(cluster_smem);  // [H, wst] this block's W_hh columns
  float* hl = reinterpret_cast<float*>(cluster_smem + align16((size_t)H * wst * sizeof(S)));
  float* buf = hl + H * RP;           // [2, smax, rpb] own h slice, double-buffered
  float* pre = buf + 2 * smax * rpb;  // [RP, wst] own gate pre-activations
  float* csm = pre + RP * wst;        // [RP, smax] own f32 cell carry
  // hl [H, RP]: h_{t-1} of every unit and row, at the operand type,
  // transposed so that a thread reads its RPT rows in one load

  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / g.C) * g.R;
  const int nrows = min(g.R, a.B - row0);
  const int j0 = g.j0[rank], sk = g.j0[rank + 1] - j0, cols = 4 * sk;
  if (threadIdx.x <= g.C) j0s[threadIdx.x] = g.j0[threadIdx.x];
  for (int q = 0; q < g.C; ++q)
    for (int j = g.j0[q] + threadIdx.x; j < g.j0[q + 1]; j += blockDim.x) owner[j] = q;

  // W_hh[:, own columns] once: local column c is gate c / sk of unit j0 + c % sk
  const S* whh = static_cast<const S*>(a.whh);
  for (int idx = threadIdx.x; idx < H * cols; idx += blockDim.x) {
    const int h = idx / cols, c = idx - h * cols;
    const int k = c / sk;
    ws[h * wst + c] = whh[k * a.suk + h * a.suh + j0 + c - k * sk];
  }
  // h0 into buf[0], c0 into the carry
  for (int idx = threadIdx.x; idx < RP * sk; idx += blockDim.x) {
    const int r = idx / sk, jj = idx - r * sk;
    const long long o = (long long)(row0 + r) * H + j0 + jj;
    buf[jj * rpb + r] = r < nrows ? a.h0[o] : 0.f;
    csm[r * smax + jj] = r < nrows ? a.c0[o] : 0.f;
  }
  // every block of the cluster has started and written buf[0]
  cluster.sync();

  const int cp = blockDim.x / g.rg;
  const int c = threadIdx.x % cp, r0 = (threadIdx.x / cp) * RPT;
  const bool owns = c < cols;
  long long xcol = 0;
  if (owns) {
    const int k = c / sk;
    xcol = k * H + j0 + c - k * sk;
  }
  constexpr int NP = RPT >= 4 ? 1 : 4 / RPT;  // independent partial sums a row
  long long* stamp = a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? a.prof : nullptr;
  if (stamp) stamp[kPhases * a.T] = global_ns();
  const int per = smax * rpb;
  // the gather's share of this thread: row gr of units gj, gj + gstep, ...
  // (a warp reads consecutive rows of one unit: contiguous on both sides)
  const int gstep = blockDim.x / RP, gr = threadIdx.x % RP;
  const int gj = threadIdx.x < gstep * RP ? threadIdx.x / RP : H;

  for (int t = 0; t < a.T; ++t) {
    if (stamp) stamp[kPhases * t + kStepStart] = clock64();
    // this thread's xp, loaded first: its latency hides behind the gather
    float xv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + r;
      xv[r] = owns && row < nrows ? a.xp[((long long)t * a.B + row0 + row) * G + xcol] : 0.f;
    }

    // 1. gather h_{t-1} from every rank's buf[t & 1], four loads in flight
    float* cur = buf + (t & 1) * per;
    for (int j = gj; j < H; j += 4 * gstep) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ju = j + u * gstep;
        if (ju < H) {
          const int q = owner[ju];
          v[u] = cluster.map_shared_rank(cur, q)[(ju - j0s[q]) * rpb + gr];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u * gstep < H) hl[(j + u * gstep) * RP + gr] = as_operand<S>(v[u]);
    }
    __syncthreads();
    if (stamp) stamp[kPhases * t + kGathered] = clock64();

    // 2. pre = xp[t] + h W_hh[:, own columns]
    if (owns) {
      float acc[NP][RPT];
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[q][r] = 0.f;
      const S* wc = ws + c;
      const float* hr = hl + r0;
      // U units at a time, every operand loaded before the first FMA: a
      // warp then waits on one shared-memory latency per U units, not per
      // unit (64 registers a thread bound U at RPT = 8)
      constexpr int U = RPT >= 4 ? 4 : 8;
      int h = 0;
      for (; h + U <= H; h += U) {
        float w[U], hv[U][RPT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          w[u] = to_f(wc[(h + u) * wst]);
          load_rows<RPT>(hr + (h + u) * RP, hv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[u % NP][r] = fmaf(hv[u][r], w[u], acc[u % NP][r]);
      }
      for (; h < H; ++h) {
        const float w = to_f(wc[h * wst]);
        float hv[RPT];
        load_rows<RPT>(hr + h * RP, hv);
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[0][r] = fmaf(hv[r], w, acc[0][r]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float s = acc[0][r];
#pragma unroll
        for (int q = 1; q < NP; ++q) s += acc[q][r];
        pre[(r0 + r) * wst + c] = xv[r] + s;
      }
    }
    __syncthreads();
    if (stamp) stamp[kPhases * t + kProduct] = clock64();

    // 3. gates and carries of the own units; the new h slice goes to the
    //    own buf[(t + 1) & 1], which no rank reads during this step
    float* nxt = buf + ((t + 1) & 1) * per;
    for (int idx = threadIdx.x; idx < RP * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      nxt[jj * rpb + r] = cell(pre + r * wst + jj, sk, csm + r * smax + jj);
    }
    if (stamp) stamp[kPhases * t + kGates] = clock64();
    // 4. the cluster barrier, its two halves around the stream stores (each
    //    thread stores the units it updated, from its own shared-memory
    //    writes): once every rank has arrived, every rank has read
    //    buf[t & 1] and written buf[(t + 1) & 1]; after the last step's,
    //    no rank reads another's shared memory any more
    cluster_arrive();
    for (int idx = threadIdx.x; idx < nrows * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      write_streams<S>(a, pre + r * wst + jj, sk, csm[r * smax + jj], nxt[jj * rpb + r], t,
                       row0 + r, j0 + jj);
    }
    cluster_wait();
    if (stamp) stamp[kPhases * t + kBarrier] = clock64();
  }
  if (stamp) stamp[kPhases * a.T + 1] = global_ns();
}

// ---------------------------------------------------------------------------
// Launchers

template <typename S>
cudaError_t launch_proj(const ProjArgs& a, cudaStream_t stream) {
  const dim3 grid((4 * a.H + kTN - 1) / kTN, (a.T * a.B + kTM - 1) / kTM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  lstm_proj_kernel<S><<<grid, kProjThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// geom[0] route: 0 streaming, 1 cluster. Streaming: geom[2] rows a block
// (1, 2, 4, 8), geom[5] threads, geom[6] dynamic shared memory. Cluster:
// geom[1] C, [2] R, [3] RPT, [4] row groups, [5] threads, [6] shared
// memory, [7] smax, [8 .. 8 + C] the column map j0.
constexpr int kGeomLen = 8 + kMaxCluster + 1;

template <typename S, int R>
cudaError_t launch_stream(const RecArgs& a, const int* geom, int dev, const DeviceInfo& info,
                          cudaStream_t stream) {
  static std::atomic<int> smem_set[kMaxDevices];
  const int threads = geom[5];
  const size_t smem = sizeof(float) * (size_t)R * 6 * a.H;
  if ((size_t)geom[6] != smem || threads < 32 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  cudaError_t err = open_smem(lstm_rec_stream_kernel<S, R>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  lstm_rec_stream_kernel<S, R><<<(a.B + R - 1) / R, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Reads and checks the cluster geometry; the shared memory must be what the
// kernel carves, every unit owned by one rank.
template <typename S>
cudaError_t cluster_geom(const int* geom, int H, ClusterGeom* g) {
  const int C = geom[1], rpt = geom[3], threads = geom[5];
  if ((C != 2 && C != 4 && C != 8) || H > kMaxClusterH) return cudaErrorInvalidValue;
  *g = ClusterGeom{C, geom[2], geom[4], geom[4] * rpt, geom[7], 4 * geom[7], {}};
  if (g->R < 1 || g->rg < 1 || g->rp < g->R || threads > 1024 || threads % g->rg ||
      (threads / g->rg) % 32 || threads / g->rg < g->wst)
    return cudaErrorInvalidValue;
  for (int k = 0; k <= C; ++k) g->j0[k] = geom[8 + k];
  if (g->j0[0] != 0 || g->j0[C] != H) return cudaErrorInvalidValue;
  for (int k = 0; k < C; ++k) {
    const int s = g->j0[k + 1] - g->j0[k];
    if (s < 1 || s > g->smax) return cudaErrorInvalidValue;
  }
  if ((size_t)geom[6] != cluster_smem_bytes<S>(*g, H)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename S, int RPT>
cudaError_t cluster_call(const RecArgs* a, const int* geom, int dev, const DeviceInfo& info,
                         cudaStream_t stream, int* max_active) {
  static std::atomic<int> smem_set[kMaxDevices];
  ClusterGeom g;
  cudaError_t err = cluster_geom<S>(geom, a->H, &g);
  if (err != cudaSuccess) return err;
  const size_t smem = geom[6];
  err = open_smem(lstm_rec_cluster_kernel<S, RPT>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a->B + g.R - 1) / g.R * g.C);
  cfg.blockDim = dim3(geom[5]);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active) return cudaOccupancyMaxActiveClusters(max_active, lstm_rec_cluster_kernel<S, RPT>, &cfg);
  err = cudaLaunchKernelEx(&cfg, lstm_rec_cluster_kernel<S, RPT>, *a, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename S>
cudaError_t rec_call(const RecArgs* a, const int* geom, cudaStream_t stream, int* max_active) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  if (geom[0] == 1) {
    switch (geom[3]) {
      case 1: return cluster_call<S, 1>(a, geom, dev, *info, stream, max_active);
      case 2: return cluster_call<S, 2>(a, geom, dev, *info, stream, max_active);
      case 4: return cluster_call<S, 4>(a, geom, dev, *info, stream, max_active);
      case 8: return cluster_call<S, 8>(a, geom, dev, *info, stream, max_active);
      default: return cudaErrorInvalidValue;
    }
  }
  if (geom[0] != 0 || max_active) return cudaErrorInvalidValue;
  switch (geom[2]) {
    case 1: return launch_stream<S, 1>(*a, geom, dev, *info, stream);
    case 2: return launch_stream<S, 2>(*a, geom, dev, *info, stream);
    case 4: return launch_stream<S, 4>(*a, geom, dev, *info, stream);
    case 8: return launch_stream<S, 8>(*a, geom, dev, *info, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: f32 x/W/streams; 1: bf16 x/W/streams. b, xp, h0, c0, hT, cT are
// f32. Each returns the cudaError_t of its launch (0 = launched).

// Stage 1: xp [T, B, 4H] = x W_ih + b.
int dn_lstm_proj(int dtype, const void* x, long long sxt, long long sxb,
                 const void* wih, long long swk, long long swd,
                 const void* b, long long sbk, void* xp, int T, int B, int D, int H,
                 void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1) return cudaErrorInvalidValue;
  ProjArgs a{x, sxt, sxb, wih, swk, swd, static_cast<const float*>(b), sbk,
             static_cast<float*>(xp), T, B, D, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_proj<float>(a, s);
  if (dtype == 1) return launch_proj<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

// The recurrence over xp, on the route and geometry `geom` (kGeomLen ints).
// prof: null, or the cluster kernel's phase clock [5 T + 2] (int64).
int dn_lstm_rec(int dtype, const void* xp, const void* whh, long long suk, long long suh,
                const void* h0, const void* c0,
                void* hs, void* cs, void* ai, void* af, void* ao, void* ag,
                void* hT, void* cT, int T, int B, int H, const int* geom, void* prof,
                void* stream) {
  if (T < 1 || B < 1 || H < 1 || !geom) return cudaErrorInvalidValue;
  if (prof && geom[0] != 1) return cudaErrorInvalidValue;
  RecArgs a{static_cast<const float*>(xp), whh, suk, suh, static_cast<const float*>(h0),
            static_cast<const float*>(c0), hs, cs, ai, af, ao, ag,
            static_cast<float*>(hT), static_cast<float*>(cT), T, B, H,
            static_cast<long long*>(prof)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rec_call<float>(&a, geom, s, nullptr);
  if (dtype == 1) return rec_call<__nv_bfloat16>(&a, geom, s, nullptr);
  return cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of a cluster geometry for B rows into *out.
int dn_lstm_max_active_clusters(int dtype, int B, int H, const int* geom, int* out) {
  if (B < 1 || H < 1 || !geom || !out || geom[0] != 1) return cudaErrorInvalidValue;
  RecArgs a{};
  a.B = B;
  a.H = H;
  if (dtype == 0) return rec_call<float>(&a, geom, nullptr, out);
  if (dtype == 1) return rec_call<__nv_bfloat16>(&a, geom, nullptr, out);
  return cudaErrorInvalidValue;
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
