// Single-direction LSTM forward over a whole sequence, i2h projection fused.
//
// Replaces: dinunet_implementations_tpu/ops/lstm_pallas.py:_fwd_fused_kernel
// (reached through _fwd_fused_call / lstm_recurrence_fused /
// lstm_forward_fused). Per step t and row b, for the gates in the order
// i, f, o, g:
//   pre_k = x_t @ W_ih[k] + h @ W_hh[k] + b[k]
//   i, f, o = sigmoid(pre_i, pre_f, pre_o);  g = tanh(pre_g)
//   c = f * c + i * g;  h = o * tanh(c)
// It writes hs (and, when the caller passes them, the residuals cs, i, f, o,
// g) at the stream dtype, and hT, cT in f32 straight from the carry.
// bf16 mode: x, W_ih, W_hh and the h fed to the recurrent product are bf16;
// products of two bf16 values are exact in f32 and are accumulated in f32,
// which is what the TPU kernel's preferred_element_type=f32 dots compute.
//
// What bounds it on this card. The recurrence is 98 serial steps (flagship:
// T=98, D=256, H=174). Each step needs 2*rows*(D+H)*4H FLOP (0.6 MFLOP a
// row) against the whole weight set, 4*(D+H)*H values = 1.2 MB in f32
// (0.6 MB in bf16), which does not fit one block's 227 KB of shared memory.
// At the serving buckets (rows <= 16) the FLOP are trivial; what bounds a
// step is reading those weight bytes from L2 into the SMs that own rows,
// and, as measured on an H100 (PERF.md), more the latency of each thread's
// chain of L2 loads (~25 us a step) than their bytes.
//
// What this first design does about it. Rows are independent, so each
// block owns R rows (R = 1..8, picked so that the grid fills the SMs) and
// walks all T steps in a loop, keeping h and c in shared memory. Each thread
// owns gate columns; it streams its W column once per step from L2 (the
// weights stay resident in the 50 MB L2 across steps) and reuses each
// weight value for all R rows from registers. Nothing is exchanged between
// blocks. With few rows the card is mostly idle: one block per row, one SM
// each. Splitting the 4H gate columns across a thread-block cluster with h
// exchanged through distributed shared memory, and wgmma for the 512-row
// training fold, are later work.

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
  const void* wih;  // W_ih[k, d, j] at k*swk + d*swd + j
  long long swk, swd;
  const float* b;  // b[k, j] at k*sbk + j
  long long sbk;
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

template <typename S, int R>
__global__ void __launch_bounds__(1024) lstm_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, H = a.H, G = 4 * H;
  float* xs = smem;         // [R, D] this step's inputs
  float* hsm = xs + R * D;  // [R, H] h as the recurrent product reads it
  float* csm = hsm + R * H; // [R, H] f32 cell carry
  float* pre = csm + R * H; // [R, 4H] gate pre-activations
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const S* wih = static_cast<const S*>(a.wih);
  const S* whh = static_cast<const S*>(a.whh);

  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    const long long o = (long long)(row0 + r) * H + j;
    hsm[idx] = r < nrows ? as_operand<S>(a.h0[o]) : 0.f;
    csm[idx] = r < nrows ? a.c0[o] : 0.f;
  }
  stage_x<S, R>(a, xs, 0, row0, nrows);
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // 1. pre[r, k*H + j] for every gate column this thread owns
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      const int k = col / H, j = col - k * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const S* w = wih + k * a.swk + j;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float wv = to_f(w[d * a.swd]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[r * D + d], wv, acc[r]);
      }
      const S* u = whh + k * a.suk + j;
#pragma unroll 8
      for (int h = 0; h < H; ++h) {
        const float uv = to_f(u[h * a.suh]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hsm[r * H + h], uv, acc[r]);
      }
      const float bias = a.b[k * a.sbk + j];
#pragma unroll
      for (int r = 0; r < R; ++r) pre[r * G + col] = acc[r] + bias;
    }
    __syncthreads();

    // 2. gates, carries and streams; x of the next step is staged meanwhile
    //    (nothing in this phase reads xs)
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
      if (r < nrows) {
        const long long o = ((long long)t * a.B + row0 + r) * H + j;
        store<S>(a.hs, o, h);
        store<S>(a.cs, o, c);
        store<S>(a.ai, o, ig);
        store<S>(a.af, o, fg);
        store<S>(a.ao, o, og);
        store<S>(a.ag, o, gg);
        if (t == a.T - 1) {
          const long long q = (long long)(row0 + r) * H + j;
          a.hT[q] = h;  // the f32 carry, never the stream dtype
          a.cT[q] = c;
        }
      }
    }
    if (t + 1 < a.T) stage_x<S, R>(a, xs, t + 1, row0, nrows);
    __syncthreads();
  }
}

template <typename S, int R>
cudaError_t launch(const Args& a, int dev, const DeviceInfo& info, cudaStream_t stream) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)R * (a.D + 2 * a.H + 4 * a.H);
  cudaError_t err = open_smem(lstm_fwd_kernel<S, R>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  int threads = ((4 * a.H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int blocks = (a.B + R - 1) / R;
  lstm_fwd_kernel<S, R><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_rows(const Args& a, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  switch (rows_per_block(a.B, info->sms.load())) {
    case 1: return launch<S, 1>(a, dev, *info, stream);
    case 2: return launch<S, 2>(a, dev, *info, stream);
    case 4: return launch<S, 4>(a, dev, *info, stream);
    default: return launch<S, 8>(a, dev, *info, stream);
  }
}

}  // namespace

extern "C" {

// dtype 0: f32 x/W/streams; 1: bf16 x/W/streams. b, h0, c0, hT, cT are f32.
// Returns the cudaError_t of the launch (0 = launched).
int dn_lstm_fwd(int dtype, const void* x, long long sxt, long long sxb,
                const void* wih, long long swk, long long swd,
                const void* b, long long sbk,
                const void* whh, long long suk, long long suh,
                const void* h0, const void* c0,
                void* hs, void* cs, void* ai, void* af, void* ao, void* ag,
                void* hT, void* cT, int T, int B, int D, int H, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1) return cudaErrorInvalidValue;
  Args a{x, sxt, sxb, wih, swk, swd, static_cast<const float*>(b), sbk,
         whh, suk, suh, static_cast<const float*>(h0), static_cast<const float*>(c0),
         hs, cs, ai, af, ao, ag, static_cast<float*>(hT), static_cast<float*>(cT),
         T, B, D, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rows<float>(a, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
