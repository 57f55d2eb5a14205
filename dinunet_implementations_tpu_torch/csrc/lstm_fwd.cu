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
// Stage 1, the projection: the i2h product depends on no step, so it
// leaves the loop. One tiled SIMT GEMM over all T*rows rows (f32
// accumulation) writes xp = x W_ih + b into an f32 scratch [T, rows, 4H]
// that the wrapper allocates. Writing and reading it back is the design's
// own cost (140 MB at 512 rows). A step of the recurrence then streams only
// W_hh: 174 loads a column instead of 430. Two tilings of the same sums in
// the same order (bit-identical results), chosen by shape in dn_lstm_proj:
// lstm_proj_kernel (64x64 output tiles, a 4x4 micro-tile a thread; also the
// bf16 instance) for grids that leave SMs idle, lstm_proj_wide_kernel
// (128x128, 8x8 a thread) once its grid fills the card.
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
// The projection also serves K3/K5 (bilstm_fwd.cu), both directions' 8
// gates in one launch; their bf16 projection runs on the tensor cores
// (lstm_proj_mma_kernel; lstm_proj_kernel when D is not a multiple of 8).
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
#include "lstm_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dn;

// ---------------------------------------------------------------------------
// Stage 1: the i2h projection

struct ProjArgs {
  const void* x;  // x[t, b, d] at t*sxt + b*sxb + d
  long long sxt, sxb;
  const void* wih;  // W_ih[k, d, j] at k*swk + d*swd + j
  long long swk, swd;
  const float* b;  // b[k, j] at k*sbk + j
  long long sbk;
  float* xp;  // [T, B, G H] contiguous f32
  int T, B, D, H;
  int G;  // gates: 4 (K1), or 8 (K3/K5: both directions' W_ih read as one [8, D, H])
};

constexpr int kTM = 64, kTN = 64, kTK = 16, kProjThreads = 256;

template <typename S>
__global__ void __launch_bounds__(kProjThreads) lstm_proj_kernel(ProjArgs a) {
  // +4: the K-major stores of a row chunk land in two banks, not one
  __shared__ __align__(16) float As[kTK][kTM + 4];
  __shared__ __align__(16) float Bs[kTK][kTN + 4];
  const int M = a.T * a.B, N = a.G * a.H, tid = threadIdx.x;
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

// The f32 projection of a grid that fills the card: lstm_proj_kernel's
// function and per-output order of sums (fmaf over d = 0, 1, ...:
// bit-identical results) in 128x128 output tiles, 256 threads of 8x8
// outputs each, K in chunks of 8 through two shared-memory stages, the next
// chunk's global loads held in registers while the current one computes:
// every operand loaded from shared memory feeds 8 FMAs, against 4 in
// lstm_proj_kernel.
constexpr int kWM = 128, kWN = 128, kWK = 8, kWThreads = 256;

// two blocks an SM: 128 registers a thread
__global__ void __launch_bounds__(kWThreads, 2) lstm_proj_wide_kernel(ProjArgs a) {
  // +4: the K-major stores of a row's 4 d land in distinct banks
  __shared__ __align__(16) float As[2][kWK][kWM + 4];
  __shared__ __align__(16) float Bs[2][kWK][kWN];
  const int M = a.T * a.B, N = a.G * a.H, tid = threadIdx.x;
  const int m0 = blockIdx.y * kWM, n0 = blockIdx.x * kWN;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.wih);
  // what this thread stages: 4 consecutive d of row tid / 2, and 4
  // consecutive columns of W_ih at d = tid / 32
  const int am = tid >> 1, ak = (tid & 1) * 4, bk = tid >> 5, bn = (tid & 31) * 4;
  long long xrow = -1;
  if (m0 + am < M) {
    const int t = (m0 + am) / a.B, b = m0 + am - t * a.B;
    xrow = t * a.sxt + (long long)b * a.sxb;
  }
  long long wcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + bn + i, k = n / a.H;
    wcol[i] = n < N ? k * a.swk + (n - k * a.H) : -1;
  }
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = k0 + ak + i;
      ra[i] = xrow >= 0 && d < a.D ? x[xrow + d] : 0.f;
      rb[i] = wcol[i] >= 0 && k0 + bk < a.D ? w[wcol[i] + (k0 + bk) * a.swd] : 0.f;
    }
  };
  auto put = [&](int st) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[st][ak + i][am] = ra[i];
    *reinterpret_cast<float4*>(&Bs[st][bk][bn]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };
  // this thread's outputs: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j
  // and 64 + tx*4 + j (two halves: a warp's float4 reads stay 256 bytes)
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  put(0);
  __syncthreads();
  for (int k0 = 0, st = 0; k0 < a.D; k0 += kWK, st ^= 1) {
    const bool more = k0 + kWK < a.D;
    if (more) fetch(k0 + kWK);
#pragma unroll
    for (int kk = 0; kk < kWK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (more) put(st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    if (n >= N) continue;
    const int k = n / a.H;
    const float bias = a.b[k * a.sbk + (n - k * a.H)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m < M) a.xp[(long long)m * N + n] = acc[i][j] + bias;
    }
  }
}

// K3/K5's bf16 projection on the tensor cores: xp [M, N] f32 = x [M, D]
// Wt[N, D]^T + b, with W_ih of both directions passed transposed (d
// contiguous: the wrapper's one conversion copy to bf16 writes it so).
// 128x128 output tiles, 8 warps of 64x32 outputs (mma.sync m16n8k16, f32
// accumulators), K in chunks of 32 copied global -> shared by cp.async, 16
// bytes at a time, two stages: the next chunk's copy runs behind the
// current chunk's products. bf16 products are exact in f32, so this is
// lstm_proj_kernel's function up to the order of the f32 sums. x's rows
// and D must be 16-byte aligned (the wrapper sees to it).
struct MmaProjArgs {
  const __nv_bfloat16* x;  // x[t, b, d] at t*sxt + b*sxb + d
  long long sxt, sxb;
  const __nv_bfloat16* wt;  // Wt[n, d] at n*ldw + d
  long long ldw;
  const float* b;  // [N]
  float* xp;       // [T, B, N] contiguous f32
  int T, B, D, N;
};

constexpr int kGM = 128, kGN = 128, kGK = 32, kGThreads = 256, kGLd = kGK + 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(kGThreads) lstm_proj_mma_kernel(MmaProjArgs a) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kGM * kGLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kGN * kGLd];
  __shared__ long long xrow[kGM];
  const int M = a.T * a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  if (tid < kGM) {
    const int m = m0 + tid;
    long long o = -1;
    if (m < M) {
      const int t = m / a.B, b = m - t * a.B;
      o = t * a.sxt + (long long)b * a.sxb;
    }
    xrow[tid] = o;
  }
  __syncthreads();
  // a stage: 128 rows of x and of Wt, 4 chunks of 8 values each; this
  // thread copies chunk tid % 4 of rows tid / 4 and tid / 4 + 64
  auto stage = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 4 + 64 * i, d = k0 + (tid & 3) * 8;
      const long long o = xrow[r];
      const bool ax = o >= 0 && d < a.D, bw = n0 + r < a.N && d < a.D;
      cp_async16(&As[st][r * kGLd + (tid & 3) * 8], ax ? a.x + o + d : a.x, ax);
      cp_async16(&Bs[st][r * kGLd + (tid & 3) * 8], bw ? a.wt + (n0 + r) * a.ldw + d : a.wt, bw);
    }
    asm volatile("cp.async.commit_group;");
  };
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4] = {};
  const int chunks = (a.D + kGK - 1) / kGK;
  stage(0, 0);
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) {
      stage((kc + 1) & 1, (kc + 1) * kGK);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kc & 1];
    const __nv_bfloat16* bs = Bs[kc & 1];
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * kGLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)  // n-tiles 2 nj and 2 nj + 1
        ldsm_x4(bf[nj], bs + (wn + nj * 16 + (lane & 16 ? 8 : 0) + (lane & 7)) * kGLd + kk +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();  // every warp is done with this stage before it is copied over
  }

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn + ni * 8 + 2 * tq;  // N = 8H is even: n < N holds n + 1 too
    if (n >= a.N) continue;
    const float b0 = a.b[n], b1 = a.b[n + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + mi * 16 + gq + 8 * hh;
        if (m < M)
          *reinterpret_cast<float2*>(a.xp + (long long)m * a.N + n) =
              make_float2(acc[mi][ni][2 * hh] + b0, acc[mi][ni][2 * hh + 1] + b1);
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
  owner_table(g, j0s, owner);

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
  const GatherShare share = gather_share(RP, H);

  for (int t = 0; t < a.T; ++t) {
    if (stamp) stamp[kPhases * t + kStepStart] = clock64();
    // this thread's xp, loaded first: its latency hides behind the gather
    float xv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + r;
      xv[r] = owns && row < nrows ? a.xp[((long long)t * a.B + row0 + row) * G + xcol] : 0.f;
    }

    // 1. gather h_{t-1} from every rank's buf[t & 1]
    float* cur = buf + (t & 1) * per;
    gather(cluster, cur, j0s, owner, H, rpb, share,
           [&](int j, int r, float v) { hl[j * RP + r] = as_operand<S>(v); });
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
  const dim3 grid((a.G * a.H + kTN - 1) / kTN, (a.T * a.B + kTM - 1) / kTM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  lstm_proj_kernel<S><<<grid, kProjThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// f32: the 128x128 tiles once their grid fills every SM with its two
// blocks; a smaller grid leaves SMs idle, and the 64x64 tiles spread the
// same sums over four times the blocks.
cudaError_t launch_proj_f32(const ProjArgs& a, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.G * a.H + kWN - 1) / kWN, (a.T * a.B + kWM - 1) / kWM);
  if ((long long)grid.x * grid.y < 2LL * info->sms.load()) return launch_proj<float>(a, stream);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  lstm_proj_wide_kernel<<<grid, kWThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

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
// kernel carves, each thread one column of rg row groups.
template <typename S>
cudaError_t cluster_geom(const int* geom, int H, ClusterGeom* g) {
  cudaError_t err = read_cluster_geom(geom, H, 4 * geom[7], g);
  if (err != cudaSuccess) return err;
  const int threads = geom[5];
  if (threads > 1024 || threads % g->rg || (threads / g->rg) % 32 || threads / g->rg < g->wst)
    return cudaErrorInvalidValue;
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
  return launch_cluster(lstm_rec_cluster_kernel<S, RPT>, (a->B + g.R - 1) / g.R * g.C, geom[5],
                        smem, g.C, stream, max_active, *a, g);
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

// Stage 1: xp [T, B, G H] = x W_ih + b, G = gates (4, or 8 for both
// directions of K3/K5 in one launch); f32 in the tiles its shape fills
// (launch_proj_f32), bf16 in lstm_proj_kernel.
int dn_lstm_proj(int dtype, int gates, const void* x, long long sxt, long long sxb,
                 const void* wih, long long swk, long long swd,
                 const void* b, long long sbk, void* xp, int T, int B, int D, int H,
                 void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1 || (gates != 4 && gates != 8)) return cudaErrorInvalidValue;
  ProjArgs a{x, sxt, sxb, wih, swk, swd, static_cast<const float*>(b), sbk,
             static_cast<float*>(xp), T, B, D, H, gates};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_proj_f32(a, s);
  if (dtype == 1) return launch_proj<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

// K3/K5's bf16 projection on the tensor cores: xp [T, B, N] f32 = x Wt^T +
// b for Wt [N, D] bf16 (rows at ldw), b [N] f32, N even; x's strides, D, ldw
// and both pointers 16-byte aligned (multiples of 8 values).
int dn_lstm_proj_mma(const void* x, long long sxt, long long sxb, const void* wt, long long ldw,
                     const void* b, void* xp, int T, int B, int D, int N, void* stream) {
  if (T < 1 || B < 1 || D < 1 || N < 2 || N % 2 || sxt % 8 || sxb % 8 || D % 8 || ldw % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kGN - 1) / kGN, (T * B + kGM - 1) / kGM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  MmaProjArgs a{static_cast<const __nv_bfloat16*>(x), sxt, sxb,
                static_cast<const __nv_bfloat16*>(wt), ldw, static_cast<const float*>(b),
                static_cast<float*>(xp), T, B, D, N};
  lstm_proj_mma_kernel<<<grid, kGThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
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
