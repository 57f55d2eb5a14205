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
// steps (flagship: T=98, D=256, H=174), each 2*rows*(D+H)*4H FLOP against
// that direction's 1.2 MB of f32 weights, which do not fit one block's
// shared memory and stream from L2 every step. As measured for K1 (PERF.md),
// a step waits on the latency of each thread's chain of L2 loads more than
// on their bytes or FLOP.
//
// What this design does about it. The TPU kernel interleaves the two
// directions in one grid sweep so that one chain's matmuls fill the MXU
// while the other waits; on this card the two chains are simply independent
// blocks: blockIdx.y picks the direction (its weights and its time map),
// blockIdx.x a group of R rows, and each block walks all T steps with its h
// and c in shared memory, as K1 does. The launcher picks R so that both
// directions' blocks fit one wave on the SMs (the fewest rows a block with
// 2 * ceil(rows / R) <= SMs). The pool is a per-thread f32 sum in shared
// memory: a thread always owns the same (row, column) pairs, so it needs no
// barrier. Clusters over the gate columns and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

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

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

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

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
