// Bidirectional LSTM forward over a whole sequence, both directions in one
// launch, i2h projection fused: K3 (dn_bilstm_fwd) and K5 (dn_bilstm_pool_fwd,
// the same sweep plus the time-mean pool).
//
// Replaces: dinunet_implementations_tpu/ops/lstm_pallas.py:_fwd_bidir_kernel
// (K3, reached through _fwd_bidir_call / bilstm_recurrence_fused and the
// unbatched rule of _pool_fwd_kcall) and :_fwd_pool_kernel4 (K5, reached
// through _fwd_pool_call4 / the site-batched rule of _pool_fwd_kcall). Per
// direction d (0 = forward, 1 = reverse), step s and row b, gates i, f, o, g:
//   t = s (forward) or T-1-s (reverse): the x block the step consumes
//   pre_k = x_t @ W_ih[d, k] + h @ W_hh[d, k] + b[d, k]
//   i, f, o = sigmoid(pre_i, pre_f, pre_o);  g = tanh(pre_g)
//   c = f * c + i * g;  h = o * tanh(c)
// Every stream of both directions is written at x-time t: hs[1, t] is the
// reverse state after consuming x[T-1..t]. Nothing is ever flipped. The
// streams are [2, T, B, H] at the stream dtype (the residuals cs, i, f, o, g
// only when the caller passes them); hT, cT [2, B, H] are the f32 carries.
// K5 also writes pool [B, 2H] f32: each direction's f32 h (before any
// rounding to the stream dtype) summed over its own time, times 1/T.
// bf16 mode: x, W_ih, W_hh and the h fed to the recurrent product are bf16;
// products of two bf16 values are exact in f32 and are accumulated in f32,
// as the TPU kernel's preferred_element_type=f32 dots.
//
// What bounds it on this card. Each direction is K1's recurrence: 98 serial
// steps (flagship: T=98, D=256, H=174), each 2*rows*H*4H FLOP against that
// direction's W_hh, after an i2h product that depends on no step.
//
// The cluster route (K1's design, carried over to both directions):
// 1. The i2h product of both directions is one launch (lstm_fwd.cu): wih2
//    [2, 4, D, H] read as [8, D, H], x read once, xp2 [T, B, 8H] f32 into a
//    scratch that the wrapper allocates; direction d's gates sit at columns
//    d*4H + k*H + j. f32: K1's SIMT GEMM, in the tiles the shape fills
//    (lstm_proj_wide_kernel at the training fold, lstm_proj_kernel at
//    serving sizes); bf16: lstm_proj_mma_kernel on the tensor cores
//    (lstm_proj_kernel when D is not a multiple of 8).
// 2. The recurrence: the first half of the grid's clusters runs direction
//    0, the second half direction 1. Block k of a cluster owns hidden units
//    [j0_k, j0_{k+1}) of its direction, all four gates of them, and holds
//    their W_hh columns in shared memory for the whole sequence; the blocks
//    exchange h once a step through distributed shared memory
//    (double-buffered, one split cluster barrier a step), as K1 does. At its
//    step s the reverse direction reads xp2[T-1-s] and stores at x-time
//    T-1-s; a direction's terminal carry is its state after its own last
//    step. K5's pool: each (row, unit) is updated by the same thread at
//    every step, which adds the f32 h to its sum in shared memory.
//    f32, bilstm_rec_cluster_kernel: each thread computes a 2-column by
//    RPT-row tile of the product, so that every W_hh value loaded from
//    shared memory feeds 2 x RPT FMAs. bf16, bilstm_rec_mma_kernel: the
//    product on the tensor cores (mma.sync m16n8k16, f32 accumulators), h
//    and the transposed W_hh slice as bf16 operands in shared memory.
// A step is then bounded by the product's FMAs at the f32 training fold,
// and by latencies elsewhere: the h gather, the product's dependent chain,
// the gates, the barrier (the phase clock, kPhases, measures each;
// PERF.md). The launch geometry is worked out in Python
// (ops/bilstm_cuda.py:bidir_geometry) and checked here.
//
// The stream route, bilstm_fwd_kernel below (the first design), stays for
// shapes whose W_hh slice fits no cluster of 8 (H above about 340 in f32):
// blockIdx.y picks the direction, blockIdx.x a group of R rows, and each
// block walks all T steps with the i2h product inside the loop, streaming
// both weights from L2 every step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "lstm_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dn;

struct Args {
  const void* x;  // x[t, b, d] at t*sxt + b*sxb + d
  long long sxt, sxb;
  const void* wih;  // [2, 4, D, H] contiguous
  const float* b;   // [2, 4, H] contiguous
  const void* whh;  // [2, 4, H, H] contiguous
  const float* h0;  // [2, B, H] contiguous
  const float* c0;
  void* hs;  // [2, T, B, H] contiguous, stream dtype; cs..ag may be null
  void* cs;
  void* ai;
  void* af;
  void* ao;
  void* ag;
  float* hT;  // [2, B, H] f32
  float* cT;
  float* pool;  // [B, 2H] f32, K5 only
  int T, B, D, H;
};

template <typename S, int R>
__device__ __forceinline__ void stage_x(const Args& a, float* xs, int t, int row0, int nrows) {
  const S* x = static_cast<const S*>(a.x);
  for (int idx = threadIdx.x; idx < R * a.D; idx += blockDim.x) {
    const int r = idx / a.D, d = idx - r * a.D;
    xs[idx] = r < nrows ? to_f(x[t * a.sxt + (long long)(row0 + r) * a.sxb + d]) : 0.f;
  }
}

template <typename S, int R, bool POOL>
__global__ void __launch_bounds__(1024) bilstm_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, H = a.H, G = 4 * H, T = a.T;
  const int dir = blockIdx.y;
  float* xs = smem;          // [R, D] this step's inputs
  float* hsm = xs + R * D;   // [R, H] h as the recurrent product reads it
  float* csm = hsm + R * H;  // [R, H] f32 cell carry
  float* pre = csm + R * H;  // [R, 4H] gate pre-activations
  float* psm = pre + R * G;  // [R, H] f32 pool sum (K5)
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const S* wih = static_cast<const S*>(a.wih) + (long long)dir * 4 * D * H;
  const S* whh = static_cast<const S*>(a.whh) + (long long)dir * 4 * H * H;
  const float* bias = a.b + dir * G;
  const long long carry = (long long)dir * a.B * H;         // [2, B, H]
  const long long plane = (long long)dir * T * a.B * H;     // [2, T, B, H]

  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    const long long o = carry + (long long)(row0 + r) * H + j;
    hsm[idx] = r < nrows ? as_operand<S>(a.h0[o]) : 0.f;
    csm[idx] = r < nrows ? a.c0[o] : 0.f;
    if (POOL) psm[idx] = 0.f;
  }
  stage_x<S, R>(a, xs, dir ? T - 1 : 0, row0, nrows);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = dir ? T - 1 - s : s;
    // 1. pre[r, k*H + j] for every gate column this thread owns
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      const int k = col / H, j = col - k * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const S* w = wih + (long long)k * D * H + j;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float wv = to_f(w[(long long)d * H]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[r * D + d], wv, acc[r]);
      }
      const S* u = whh + (long long)k * H * H + j;
#pragma unroll 8
      for (int h = 0; h < H; ++h) {
        const float uv = to_f(u[(long long)h * H]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hsm[r * H + h], uv, acc[r]);
      }
      const float bk = bias[col];
#pragma unroll
      for (int r = 0; r < R; ++r) pre[r * G + col] = acc[r] + bk;
    }
    __syncthreads();

    // 2. gates, carries and streams at x-time t; x of the next step is
    //    staged meanwhile (nothing in this phase reads xs)
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H;
      const float* p = pre + r * G;
      const float ig = sigmoid(p[j]);
      const float fg = sigmoid(p[H + j]);
      const float og = sigmoid(p[2 * H + j]);
      const float gg = tanhf(p[3 * H + j]);
      const float c = fg * csm[idx] + ig * gg;
      const float h = og * tanhf(c);
      csm[idx] = c;
      hsm[idx] = as_operand<S>(h);
      if (POOL) psm[idx] += h;  // the f32 h, before any stream rounding
      if (r < nrows) {
        const long long o = plane + ((long long)t * a.B + row0 + r) * H + j;
        store<S>(a.hs, o, h);
        store<S>(a.cs, o, c);
        store<S>(a.ai, o, ig);
        store<S>(a.af, o, fg);
        store<S>(a.ao, o, og);
        store<S>(a.ag, o, gg);
        if (s == T - 1) {
          const long long q = carry + (long long)(row0 + r) * H + j;
          a.hT[q] = h;  // the f32 carry, never the stream dtype
          a.cT[q] = c;
        }
      }
    }
    if (s + 1 < T) stage_x<S, R>(a, xs, dir ? t - 1 : t + 1, row0, nrows);
    __syncthreads();
  }

  if (POOL) {  // each thread reads back only the sums it accumulated itself
    const float inv_t = 1.f / (float)T;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H;
      if (r < nrows) a.pool[(long long)(row0 + r) * 2 * H + dir * H + j] = psm[idx] * inv_t;
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster route: both directions' recurrences over xp2

struct RecArgs {
  const float* xp;  // [T, B, 8H] f32: x W_ih + b, direction d at columns d*4H + k*H + j
  const void* whh;  // [2, 4, H, H] contiguous, stream dtype
  const float* h0;  // [2, B, H] contiguous
  const float* c0;
  void* hs;  // [2, T, B, H] contiguous, stream dtype; cs..ag may be null
  void* cs;
  void* ai;
  void* af;
  void* ao;
  void* ag;
  float* hT;  // [2, B, H] f32
  float* cT;
  float* pool;  // [B, 2H] f32 (K5)
  int T, B, H;
  // null, or [5 T + 2]: the phase clock of block 0 (direction 0), kPhases
  long long* prof;
};

// This block's direction, first row and rows: the first half of the
// clusters runs direction 0, the second half direction 1.
struct Place {
  int dir, row0, nrows;
};

__device__ __forceinline__ Place place(const ClusterGeom& g, int B) {
  const int per_dir = (B + g.R - 1) / g.R;
  const int q = blockIdx.x / g.C;
  const int dir = q >= per_dir ? 1 : 0;
  const int row0 = (q - dir * per_dir) * g.R;
  return {dir, row0, min(g.R, B - row0)};
}

// The streams of unit j of row `row` at the direction's step s, x-time t,
// from what cell() left: the gates in p, the carry c and h. The terminal
// carry is the state after the direction's own last step (s == T - 1: x-time
// 0 for the reverse direction).
template <typename S>
__device__ __forceinline__ void write_step(const RecArgs& a, const float* p, int off, float c,
                                           float h, int dir, int s, int t, int row, int j) {
  const long long o = (((long long)dir * a.T + t) * a.B + row) * a.H + j;
  store<S>(a.hs, o, h);
  store<S>(a.cs, o, c);
  store<S>(a.ai, o, p[0]);
  store<S>(a.af, o, p[off]);
  store<S>(a.ao, o, p[2 * off]);
  store<S>(a.ag, o, p[3 * off]);
  if (s == a.T - 1) {
    const long long q = ((long long)dir * a.B + row) * a.H + j;
    a.hT[q] = h;  // the f32 carry, never the stream dtype
    a.cT[q] = c;
  }
}

// The most threads of a block. 8 rows a thread: 102 registers a thread for
// the 2 x 8 tile and its operands. Fewer rows: one row group of at most 2
// smax <= 512 columns; bounded as for two such blocks an SM, 64 registers a
// thread (left free, ptxas gives these latency-bound products more
// registers and a slower schedule).
constexpr int kRows8Threads = 640, kSimtThreads = 512;

// The f32 instance of the cluster recurrence (bf16: bilstm_rec_mma_kernel).
template <int RPT, bool POOL>
__global__ void __launch_bounds__(RPT == 8 ? kRows8Threads : kSimtThreads, RPT == 8 ? 1 : 2)
    bilstm_rec_cluster_kernel(RecArgs a, ClusterGeom g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  __shared__ int j0s[kMaxCluster + 1];
  __shared__ unsigned char owner[kMaxClusterH];  // the rank that owns each unit
  const int H = a.H, RP = g.rp, smax = g.smax, wst = g.wst;
  const int rpb = exchange_stride(RP);
  // K1's layout (cluster_smem_bytes), then K5's pool sums
  float* ws = reinterpret_cast<float*>(cluster_smem);  // [H, wst] this block's W_hh columns
  float* hl = ws + align16((size_t)H * wst * sizeof(float)) / sizeof(float);
  float* buf = hl + H * RP;           // [2, smax, rpb] own h slice, double-buffered
  float* pre = buf + 2 * smax * rpb;  // [RP, wst] own gate pre-activations
  float* csm = pre + RP * wst;        // [RP, smax] own f32 cell carry
  float* psm = csm + RP * smax;       // [RP, smax] own f32 pool sums (K5)

  const Place pl = place(g, a.B);
  const int rank = (int)cluster.block_rank();
  const int j0 = g.j0[rank], sk = g.j0[rank + 1] - j0, cols = 4 * sk;
  owner_table(g, j0s, owner);

  // the direction's W_hh[:, own columns] once: local column c is gate c / sk
  // of unit j0 + c % sk
  const float* whh = static_cast<const float*>(a.whh) + (long long)pl.dir * 4 * H * H;
  for (int idx = threadIdx.x; idx < H * cols; idx += blockDim.x) {
    const int h = idx / cols, c = idx - h * cols;
    const int k = c / sk;
    ws[h * wst + c] = whh[((long long)k * H + h) * H + j0 + c - k * sk];
  }
  // h0 into buf[0], c0 into the carry
  const long long carry = (long long)pl.dir * a.B * H;
  for (int idx = threadIdx.x; idx < RP * sk; idx += blockDim.x) {
    const int r = idx / sk, jj = idx - r * sk;
    const long long o = carry + (long long)(pl.row0 + r) * H + j0 + jj;
    buf[jj * rpb + r] = r < pl.nrows ? a.h0[o] : 0.f;
    csm[r * smax + jj] = r < pl.nrows ? a.c0[o] : 0.f;
    if (POOL) psm[r * smax + jj] = 0.f;
  }
  // every block of the cluster has started and written buf[0]
  cluster.sync();

  // the product's share of this thread: columns 2 cq and 2 cq + 1 (a 4 sk
  // wide slice never splits a pair), rows r0 .. r0 + RPT - 1
  const int cp = blockDim.x / g.rg;
  const int cq = threadIdx.x % cp, r0 = (threadIdx.x / cp) * RPT;
  const bool owns = 2 * cq < cols;
  long long xcol[2] = {0, 0};
  if (owns) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * cq + e, k = c / sk;
      xcol[e] = (long long)pl.dir * 4 * H + k * H + j0 + c - k * sk;
    }
  }
  constexpr int NP = RPT >= 2 ? 1 : 2;  // independent partial sums a row
  long long* stamp = a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? a.prof : nullptr;
  if (stamp) stamp[kPhases * a.T] = global_ns();
  const int per = smax * rpb;
  const long long G8 = 8LL * H;
  const GatherShare share = gather_share(RP, H);

  for (int s = 0; s < a.T; ++s) {
    const int t = pl.dir ? a.T - 1 - s : s;  // the x block this step consumes
    if (stamp) stamp[kPhases * s + kStepStart] = clock64();
    // this thread's xp, loaded first: its latency hides behind the gather
    float xv[RPT][2];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const bool ok = owns && r0 + r < pl.nrows;
      const float* xr = a.xp + ((long long)t * a.B + pl.row0 + r0 + r) * G8;
      xv[r][0] = ok ? xr[xcol[0]] : 0.f;
      xv[r][1] = ok ? xr[xcol[1]] : 0.f;
    }

    // 1. gather h_{t-1} from every rank's buf[s & 1]
    float* cur = buf + (s & 1) * per;
    gather(cluster, cur, j0s, owner, H, rpb, share,
           [&](int j, int r, float v) { hl[j * RP + r] = v; });
    __syncthreads();
    if (stamp) stamp[kPhases * s + kGathered] = clock64();

    // 2. pre = xp[t] + h W_hh[:, own columns], a 2 x RPT tile a thread
    if (owns) {
      float acc[NP][RPT][2];
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[q][r][0] = acc[q][r][1] = 0.f;
      const float* wc = ws + 2 * cq;
      const float* hr = hl + r0;
      // U units at a time, every operand loaded before the first FMA
      constexpr int U = RPT >= 4 ? 4 : 8;
      int h = 0;
      for (; h + U <= H; h += U) {
        float2 w[U];
        float hv[U][RPT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          w[u] = *reinterpret_cast<const float2*>(wc + (h + u) * wst);
          load_rows<RPT>(hr + (h + u) * RP, hv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[u % NP][r][0] = fmaf(hv[u][r], w[u].x, acc[u % NP][r][0]);
            acc[u % NP][r][1] = fmaf(hv[u][r], w[u].y, acc[u % NP][r][1]);
          }
      }
      for (; h < H; ++h) {
        const float2 w = *reinterpret_cast<const float2*>(wc + h * wst);
        float hv[RPT];
        load_rows<RPT>(hr + h * RP, hv);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[0][r][0] = fmaf(hv[r], w.x, acc[0][r][0]);
          acc[0][r][1] = fmaf(hv[r], w.y, acc[0][r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float2 v = make_float2(acc[0][r][0], acc[0][r][1]);
#pragma unroll
        for (int q = 1; q < NP; ++q) v.x += acc[q][r][0], v.y += acc[q][r][1];
        v.x += xv[r][0], v.y += xv[r][1];
        *reinterpret_cast<float2*>(pre + (r0 + r) * wst + 2 * cq) = v;
      }
    }
    __syncthreads();
    if (stamp) stamp[kPhases * s + kProduct] = clock64();

    // 3. gates and carries of the own units; the new h slice goes to the
    //    own buf[(s + 1) & 1], which no rank reads during this step. The
    //    thread that updates a (row, unit) is the same at every step, so it
    //    alone adds to that pool sum: the f32 h, before any rounding.
    float* nxt = buf + ((s + 1) & 1) * per;
    for (int idx = threadIdx.x; idx < RP * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      const float h = cell(pre + r * wst + jj, sk, csm + r * smax + jj);
      nxt[jj * rpb + r] = h;
      if (POOL) psm[r * smax + jj] += h;
    }
    if (stamp) stamp[kPhases * s + kGates] = clock64();
    // 4. the cluster barrier, its two halves around the stream stores, as K1
    cluster_arrive();
    for (int idx = threadIdx.x; idx < pl.nrows * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      write_step<float>(a, pre + r * wst + jj, sk, csm[r * smax + jj], nxt[jj * rpb + r], pl.dir,
                        s, t, pl.row0 + r, j0 + jj);
    }
    cluster_wait();
    if (stamp) stamp[kPhases * s + kBarrier] = clock64();
  }
  if (stamp) stamp[kPhases * a.T + 1] = global_ns();

  if (POOL) {  // each thread reads back only the sums it accumulated itself
    const float inv_t = 1.f / (float)a.T;
    for (int idx = threadIdx.x; idx < RP * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      if (r < pl.nrows)
        a.pool[(long long)(pl.row0 + r) * 2 * H + pl.dir * H + j0 + jj] = psm[r * smax + jj] * inv_t;
    }
  }
}

template <typename S, int R, bool POOL>
cudaError_t launch(const Args& a, int dev, const DeviceInfo& info, cudaStream_t stream) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)R * (a.D + 6 * a.H + (POOL ? a.H : 0));
  cudaError_t err = open_smem(bilstm_fwd_kernel<S, R, POOL>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  int threads = ((4 * a.H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((a.B + R - 1) / R, 2);
  bilstm_fwd_kernel<S, R, POOL><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, bool POOL>
cudaError_t dispatch_rows(const Args& a, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  // two directions: each gets half of the SMs for its row blocks
  const int half = info->sms.load() / 2 > 0 ? info->sms.load() / 2 : 1;
  switch (rows_per_block(a.B, half)) {
    case 1: return launch<S, 1, POOL>(a, dev, *info, stream);
    case 2: return launch<S, 2, POOL>(a, dev, *info, stream);
    case 4: return launch<S, 4, POOL>(a, dev, *info, stream);
    default: return launch<S, 8, POOL>(a, dev, *info, stream);
  }
}

template <bool POOL>
int run(int dtype, const Args& a, void* stream) {
  if (a.T < 1 || a.B < 1 || a.D < 1 || a.H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rows<float, POOL>(a, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16, POOL>(a, s);
  return cudaErrorInvalidValue;
}

// The bf16 instance of the cluster recurrence: the recurrent product on the
// tensor cores, mma.sync m16n8k16 with f32 accumulators; the rest as
// bilstm_rec_cluster_kernel. A block's shared memory (mma_smem_bytes):
//   wT [nw, ks] bf16, the W_hh slice transposed: row c is gate c / sk of
//       unit j0 + c % sk over h, the .col operand that ldmatrix loads; rows
//       c >= 4 sk and columns h >= H zero
//   hA [rp, ks] bf16, h_{t-1} as the row-major operand; rows >= R and
//       columns >= H zero
//   buf [2, smax, rp | 1] f32, the h exchange as K1's
//   pre [rp, wst] f32, carry [rp, smax] f32, pool sums [rp, smax] f32 (K5)
// nw = 4 smax rounded up to 8 (an mma's n), wst = nw + 8 (a row stride of
// 8 mod 32 words: the accumulators' float2 stores hit every bank once a
// half-warp), ks = mma_kstride(H), rp = R rounded up to 16 (an mma's m), at
// most 3 tiles. Warp w computes n-tiles 2w and 2w + 1 (16 columns) over
// every m-tile, two independent accumulator chains, each W_hh fragment
// loaded once for every m-tile; it loads the xp its accumulators meet into
// registers at the step's start, behind the gather.
__host__ __device__ inline int mma_nw(int smax) { return (4 * smax + 7) / 8 * 8; }

template <bool POOL>
__host__ __device__ inline size_t mma_smem_bytes(const ClusterGeom& g, int H) {
  const int nw = mma_nw(g.smax), ks = mma_kstride(H);
  return align16((size_t)nw * ks * 2) + align16((size_t)g.rp * ks * 2) +
         sizeof(float) * (2 * (size_t)g.smax * exchange_stride(g.rp) + (size_t)g.rp * g.wst +
                          (size_t)g.rp * g.smax * (POOL ? 2 : 1));
}

// the most threads of the bf16 block (one warp for each pair of n-tiles: 22
// at H = 174 in clusters of 2), 93 registers a thread
constexpr int kMmaThreads = 704;

// MT m-tiles, 1 to 3 (rec_mma_tiles): the accumulators and their xp (16 MT
// registers) are sized by it, so that the one-tile instance, which the
// serving and training sizes take, spills nothing
template <int MT, bool POOL>
__global__ void __launch_bounds__(kMmaThreads) bilstm_rec_mma_kernel(RecArgs a, ClusterGeom g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  __shared__ int j0s[kMaxCluster + 1];
  __shared__ unsigned char owner[kMaxClusterH];  // the rank that owns each unit
  const int H = a.H, R = g.R, RP = g.rp, smax = g.smax, wst = g.wst;
  const int nw = mma_nw(smax), ks = mma_kstride(H), rpb = exchange_stride(RP);
  __nv_bfloat16* wT = reinterpret_cast<__nv_bfloat16*>(cluster_smem);
  __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(cluster_smem + align16((size_t)nw * ks * 2));
  float* buf = reinterpret_cast<float*>(cluster_smem + align16((size_t)nw * ks * 2) +
                                        align16((size_t)RP * ks * 2));
  float* pre = buf + 2 * smax * rpb;
  float* csm = pre + RP * wst;
  float* psm = csm + RP * smax;

  const Place pl = place(g, a.B);
  const int rank = (int)cluster.block_rank();
  const int j0 = g.j0[rank], sk = g.j0[rank + 1] - j0, cols = 4 * sk;
  owner_table(g, j0s, owner);

  // the direction's W_hh[:, own columns] once, transposed (consecutive
  // threads read consecutive units of one h)
  const __nv_bfloat16* whh = static_cast<const __nv_bfloat16*>(a.whh) + (long long)pl.dir * 4 * H * H;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < ks * nw; idx += blockDim.x) {
    const int h = idx / nw, c = idx - h * nw;
    const int k = c / sk;
    wT[c * ks + h] = c < cols && h < H ? whh[((long long)k * H + h) * H + j0 + c - k * sk] : zero;
  }
  for (int idx = threadIdx.x; idx < RP * ks; idx += blockDim.x) hA[idx] = zero;
  // h0 into buf[0], c0 into the carry
  const long long carry = (long long)pl.dir * a.B * H;
  for (int idx = threadIdx.x; idx < R * sk; idx += blockDim.x) {
    const int r = idx / sk, jj = idx - r * sk;
    const long long o = carry + (long long)(pl.row0 + r) * H + j0 + jj;
    buf[jj * rpb + r] = r < pl.nrows ? a.h0[o] : 0.f;
    csm[r * smax + jj] = r < pl.nrows ? a.c0[o] : 0.f;
    if (POOL) psm[r * smax + jj] = 0.f;
  }
  // every block of the cluster has started and written buf[0]
  cluster.sync();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NT = nw / 8, KT = (ks - 8) / 16;
  const int gq = lane >> 2, tq = lane & 3;  // an accumulator fragment's row and column pair
  // this warp's n-tiles na, nb (nb = na on an odd last pair, computed and
  // dropped); this lane's ldmatrix rows of wT (n-tile lane / 16, row lane % 8,
  // k half lane / 8 % 2) and of hA (row lane % 16, k half lane / 16)
  const int na = 2 * warp, nb = min(2 * warp + 1, NT - 1);
  const bool pair = na < NT, second = 2 * warp + 1 < NT;
  const __nv_bfloat16* bp = wT + ((lane & 16 ? nb : na) * 8 + (lane & 7)) * ks + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* ap = hA + (lane & 15) * ks + (lane >> 4) * 8;
  // the xp columns this lane's accumulators meet: n-tile e, column 2 tq + q
  long long xcol[2][2];
  bool xok[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = (e ? nb : na) * 8 + 2 * tq + q, k = c / sk;
      xok[e][q] = pair && (e == 0 || second) && c < cols;
      xcol[e][q] = (long long)pl.dir * 4 * H + k * H + j0 + c - k * sk;
    }
  long long* stamp = a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? a.prof : nullptr;
  if (stamp) stamp[kPhases * a.T] = global_ns();
  const int per = smax * rpb;
  const long long G8 = 8LL * H;
  const GatherShare share = gather_share(R, H);

  for (int s = 0; s < a.T; ++s) {
    const int t = pl.dir ? a.T - 1 - s : s;  // the x block this step consumes
    if (stamp) stamp[kPhases * s + kStepStart] = clock64();
    // this lane's xp, loaded first: its latency hides behind the gather
    float xv[MT][2][4];
    const float* xt = a.xp + ((long long)t * a.B + pl.row0) * G8;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int r = m * 16 + gq + 8 * hh;
            xv[m][e][2 * hh + q] = r < pl.nrows && xok[e][q] ? xt[r * G8 + xcol[e][q]] : 0.f;
          }

    // 1. gather h_{t-1} from every rank's buf[s & 1], as the bf16 operand
    float* cur = buf + (s & 1) * per;
    gather(cluster, cur, j0s, owner, H, rpb, share,
           [&](int j, int r, float v) { hA[r * ks + j] = __float2bfloat16(v); });
    __syncthreads();
    if (stamp) stamp[kPhases * s + kGathered] = clock64();

    // 2. pre = xp[t] + h W_hh[:, own columns] on the tensor cores
    if (pair) {
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
            const int c = (e ? nb : na) * 8 + 2 * tq;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(pre + (m * 16 + gq + 8 * hh) * wst + c) =
                  make_float2(acc[m][e][2 * hh] + xv[m][e][2 * hh],
                              acc[m][e][2 * hh + 1] + xv[m][e][2 * hh + 1]);
          }
    }
    __syncthreads();
    if (stamp) stamp[kPhases * s + kProduct] = clock64();

    // 3. gates and carries of the own units, as bilstm_rec_cluster_kernel
    float* nxt = buf + ((s + 1) & 1) * per;
    for (int idx = threadIdx.x; idx < R * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      const float h = cell(pre + r * wst + jj, sk, csm + r * smax + jj);
      nxt[jj * rpb + r] = h;
      if (POOL) psm[r * smax + jj] += h;
    }
    if (stamp) stamp[kPhases * s + kGates] = clock64();
    // 4. the cluster barrier, its two halves around the stream stores
    cluster_arrive();
    for (int idx = threadIdx.x; idx < pl.nrows * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      write_step<__nv_bfloat16>(a, pre + r * wst + jj, sk, csm[r * smax + jj], nxt[jj * rpb + r],
                                pl.dir, s, t, pl.row0 + r, j0 + jj);
    }
    cluster_wait();
    if (stamp) stamp[kPhases * s + kBarrier] = clock64();
  }
  if (stamp) stamp[kPhases * a.T + 1] = global_ns();

  if (POOL) {  // each thread reads back only the sums it accumulated itself
    const float inv_t = 1.f / (float)a.T;
    for (int idx = threadIdx.x; idx < R * sk; idx += blockDim.x) {
      const int r = idx / sk, jj = idx - r * sk;
      if (r < pl.nrows)
        a.pool[(long long)(pl.row0 + r) * 2 * H + pl.dir * H + j0 + jj] = psm[r * smax + jj] * inv_t;
    }
  }
}

// The cluster route's launch. Reads and checks the geometry: the shared
// memory must be what the kernel carves (K1's layout, and K5's pool sums),
// each thread two columns of rg row groups.
template <int RPT, bool POOL>
cudaError_t rec_cluster(const RecArgs& a, const int* geom, int dev, const DeviceInfo& info,
                        cudaStream_t stream, int* max_active) {
  static std::atomic<int> smem_set[kMaxDevices];
  ClusterGeom g;
  cudaError_t err = read_cluster_geom(geom, a.H, 4 * geom[7], &g);
  if (err != cudaSuccess) return err;
  const int threads = geom[5], cp = threads / g.rg;
  const size_t smem = cluster_smem_bytes<float>(g, a.H) + (POOL ? sizeof(float) * g.rp * g.smax : 0);
  if (geom[3] != RPT || threads > (RPT == 8 ? kRows8Threads : kSimtThreads) || threads % g.rg ||
      cp % 32 ||
      2 * cp < g.wst || (size_t)geom[6] != smem)
    return cudaErrorInvalidValue;
  err = open_smem(bilstm_rec_cluster_kernel<RPT, POOL>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks = 2LL * ((a.B + g.R - 1) / g.R) * g.C;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(bilstm_rec_cluster_kernel<RPT, POOL>, (unsigned)blocks, threads, smem,
                        g.C, stream, max_active, a, g);
}

// The bf16 route's launch: the same checks for the tensor-core layout.
template <int MT, bool POOL>
cudaError_t rec_mma(const RecArgs& a, const ClusterGeom& g, int threads, size_t smem, int dev,
                    const DeviceInfo& info, cudaStream_t stream, int* max_active) {
  static std::atomic<int> smem_set[kMaxDevices];
  cudaError_t err = open_smem(bilstm_rec_mma_kernel<MT, POOL>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks = 2LL * ((a.B + g.R - 1) / g.R) * g.C;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(bilstm_rec_mma_kernel<MT, POOL>, (unsigned)blocks, threads, smem, g.C,
                        stream, max_active, a, g);
}

template <bool POOL>
cudaError_t rec_mma_tiles(const RecArgs& a, const int* geom, int dev, const DeviceInfo& info,
                          cudaStream_t stream, int* max_active) {
  ClusterGeom g;
  cudaError_t err = read_cluster_geom(geom, a.H, mma_nw(geom[7]) + 8, &g);
  if (err != cudaSuccess) return err;
  const int threads = geom[5], pairs = (mma_nw(g.smax) / 8 + 1) / 2;
  const size_t smem = mma_smem_bytes<POOL>(g, a.H);
  if (geom[3] != 16 || threads > kMmaThreads || threads % 32 || threads < 32 * pairs ||
      (size_t)geom[6] != smem)
    return cudaErrorInvalidValue;
  switch (g.rg) {
    case 1: return rec_mma<1, POOL>(a, g, threads, smem, dev, info, stream, max_active);
    case 2: return rec_mma<2, POOL>(a, g, threads, smem, dev, info, stream, max_active);
    case 3: return rec_mma<3, POOL>(a, g, threads, smem, dev, info, stream, max_active);
    default: return cudaErrorInvalidValue;
  }
}

// f32: the SIMT kernel at the geometry's rows a thread; bf16: the tensor cores
template <bool POOL>
cudaError_t rec_dispatch(int dtype, const RecArgs& a, const int* geom, cudaStream_t stream,
                         int* max_active) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  if (geom[0] != 1) return cudaErrorInvalidValue;
  if (dtype == 1) return rec_mma_tiles<POOL>(a, geom, dev, *info, stream, max_active);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (geom[3]) {
    case 1: return rec_cluster<1, POOL>(a, geom, dev, *info, stream, max_active);
    case 2: return rec_cluster<2, POOL>(a, geom, dev, *info, stream, max_active);
    case 4: return rec_cluster<4, POOL>(a, geom, dev, *info, stream, max_active);
    case 8: return rec_cluster<8, POOL>(a, geom, dev, *info, stream, max_active);
    default: return cudaErrorInvalidValue;
  }
}

int rec_run(int dtype, int pool, const RecArgs& a, const int* geom, cudaStream_t stream,
            int* max_active) {
  return pool ? rec_dispatch<true>(dtype, a, geom, stream, max_active)
              : rec_dispatch<false>(dtype, a, geom, stream, max_active);
}

}  // namespace

extern "C" {

// K3. dtype 0: f32 x/W/streams; 1: bf16 x/W/streams. b, h0, c0, hT, cT are
// f32. cs, ai, af, ao, ag may be null (no residuals). Returns the
// cudaError_t of the launch (0 = launched).
int dn_bilstm_fwd(int dtype, const void* x, long long sxt, long long sxb, const void* wih,
                  const void* b, const void* whh, const void* h0, const void* c0,
                  void* hs, void* cs, void* ai, void* af, void* ao, void* ag,
                  void* hT, void* cT, int T, int B, int D, int H, void* stream) {
  Args a{x, sxt, sxb, wih, static_cast<const float*>(b), whh,
         static_cast<const float*>(h0), static_cast<const float*>(c0),
         hs, cs, ai, af, ao, ag, static_cast<float*>(hT), static_cast<float*>(cT), nullptr,
         T, B, D, H};
  return run<false>(dtype, a, stream);
}

// K5: K3 with every residual stream written, plus pool [B, 2H] f32.
int dn_bilstm_pool_fwd(int dtype, const void* x, long long sxt, long long sxb, const void* wih,
                       const void* b, const void* whh, const void* h0, const void* c0,
                       void* hs, void* cs, void* ai, void* af, void* ao, void* ag,
                       void* hT, void* cT, void* pool, int T, int B, int D, int H,
                       void* stream) {
  if (!cs || !ai || !af || !ao || !ag || !pool) return cudaErrorInvalidValue;
  Args a{x, sxt, sxb, wih, static_cast<const float*>(b), whh,
         static_cast<const float*>(h0), static_cast<const float*>(c0),
         hs, cs, ai, af, ao, ag, static_cast<float*>(hT), static_cast<float*>(cT),
         static_cast<float*>(pool), T, B, D, H};
  return run<true>(dtype, a, stream);
}

// The cluster route of K3 (pool 0) and K5 (pool 1): the recurrence of both
// directions over xp2 [T, B, 8H] f32 (dn_lstm_proj with 8 gates), on the
// geometry `geom` (kGeomLen ints, ops/bilstm_cuda.py:bidir_geometry).
// whh [2, 4, H, H] contiguous at the stream dtype; h0, c0, hT, cT [2, B, H]
// f32; pool [B, 2H] f32. K5 needs every residual stream. prof: null, or the
// phase clock [5 T + 2] (int64).
int dn_bilstm_rec(int dtype, int pool, const void* xp, const void* whh, const void* h0,
                  const void* c0, void* hs, void* cs, void* ai, void* af, void* ao, void* ag,
                  void* hT, void* cT, void* poolp, int T, int B, int H, const int* geom,
                  void* prof, void* stream) {
  if (T < 1 || B < 1 || H < 1 || !geom) return cudaErrorInvalidValue;
  if (pool && (!cs || !ai || !af || !ao || !ag || !poolp)) return cudaErrorInvalidValue;
  RecArgs a{static_cast<const float*>(xp), whh, static_cast<const float*>(h0),
            static_cast<const float*>(c0), hs, cs, ai, af, ao, ag, static_cast<float*>(hT),
            static_cast<float*>(cT), static_cast<float*>(poolp), T, B, H,
            static_cast<long long*>(prof)};
  return rec_run(dtype, pool, a, geom, static_cast<cudaStream_t>(stream), nullptr);
}

// cudaOccupancyMaxActiveClusters of the cluster route at `geom` for B rows
// into *out (clusters of both directions together).
int dn_bilstm_max_active_clusters(int dtype, int pool, int B, int H, const int* geom, int* out) {
  if (B < 1 || H < 1 || !geom || !out) return cudaErrorInvalidValue;
  RecArgs a{};
  a.B = B;
  a.H = H;
  return rec_run(dtype, pool, a, geom, nullptr, out);
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
