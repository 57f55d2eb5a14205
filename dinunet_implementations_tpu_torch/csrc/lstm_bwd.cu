// Single-direction LSTM backward through time over a whole sequence.
//
// Replaces: dinunet_implementations_tpu/ops/lstm_pallas.py:_bwd_kernel
// (reached through _bwd_call / _vjp_fused_bwd, the backward of
// lstm_recurrence_fused). Time runs backwards; per step t and row b, with
// the forward's residual streams i, f, o, g, c and c_prev (c0 at t = 0):
//   dh  = dhs[t] + dh_carry
//   dc  = dh * o * (1 - tanh(c)^2) + dc_carry
//   dp_i = dc*g * i(1-i),  dp_f = dc*c_prev * f(1-f),
//   dp_o = dh*tanh(c) * o(1-o),  dp_g = dc*i * (1-g^2)
//   dh_carry <- sum_k dp_k @ W_hh[k]^T,   dc_carry <- dc * f
// The carries are seeded with dhT, dcT and kept in f32. It writes the gate
// pre-activation cotangents dp [T, B, 4H] (gates i, f, o, g side by side, at
// the stream dtype) and dh0, dc0 in f32. The weight gradients are products
// over dp outside the kernel, as in the TPU version.
// bf16 mode: the streams and W_hh are bf16, and each dp is rounded to bf16
// before the recurrent product (the TPU kernel's dp.astype(cdt)); products
// of two bf16 values are exact in f32 and are accumulated in f32.
//
// What bounds it on this card. Like the forward, 98 serial steps (flagship:
// T=98, H=174). Each step is 2*rows*4H*H FLOP against the transposed W_hh,
// 4*H*H values = 0.48 MB in f32, streamed from L2; the per-step streams
// are a few KB a row. At the 512-row training fold the FLOP (12 GFLOP a
// call) bound it against f32 peak, the bytes (~0.35 GB) in bf16.
//
// Two routes, chosen in Python by shape before any launch
// (ops/lstm_cuda.py:bwd_geometry) and passed as a record:
// - the cluster route (lstm_bwd_cluster.cuh): a thread-block cluster holds
//   W_hh^T in its blocks' shared memory, each block the rows of its own
//   hidden units, and reduce-scatters dh through distributed shared memory
//   once a step; f32 on a SIMT register tile, bf16 on mma.sync;
// - the stream route, lstm_bwd_kernel below (the first design), for a
//   W_hh^T whose slice fits no cluster of 8 (H above about 340 in f32).
//
// What the first design does. The forward's structure: a block
// owns R rows (K1's rows-per-block choice) and walks all T steps in a loop,
// the f32 carries in shared memory, the ragged last block masked. Each
// thread owns one (gate, column) pair of the product and streams its
// column of W_hh^T, which the wrapper transposes once per call, so the
// threads of a warp read neighbouring addresses; the four per-gate partial
// sums meet in shared memory and are added in gate order, as the TPU
// kernel's four dots are. Two barriers a step: every dp of a row is in
// shared memory before the product reads it, and every partial is written
// before the new carry sums them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "lstm_bwd_cluster.cuh"

namespace {

using namespace dn;

struct Args {
  const void* ai;  // [T, B, H] contiguous, stream dtype: the forward's residuals
  const void* af;
  const void* ao;
  const void* ag;
  const void* cs;
  const void* wT;  // W_hh^T[k, m, j] = W_hh[k, j, m] at k*swk + m*swm + j
  long long swk, swm;
  const float* c0;  // [B, H] contiguous
  const void* dhs;  // dhs[t, b, j] at t*sdt + b*sdb + j, stream dtype
  long long sdt, sdb;
  const float* dhT;  // [B, H] contiguous
  const float* dcT;
  void* dp;  // [T, B, 4H] contiguous, stream dtype, gates i, f, o, g
  float* dh0;  // [B, H] f32
  float* dc0;
  int T, B, H;
};

template <typename S, int R>
__global__ void __launch_bounds__(1024) lstm_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 4 * H, RH = R * a.H;
  float* dps = smem;         // [R, 4H] this step's dp, as the product reads them
  float* part = dps + R * G; // [4, R, H] per-gate partial products
  float* dhc = part + 4 * RH; // [R, H] f32 dh carry
  float* dcc = dhc + RH;      // [R, H] f32 dc carry
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const S* ai = static_cast<const S*>(a.ai);
  const S* af = static_cast<const S*>(a.af);
  const S* ao = static_cast<const S*>(a.ao);
  const S* ag = static_cast<const S*>(a.ag);
  const S* cs = static_cast<const S*>(a.cs);
  const S* dhs = static_cast<const S*>(a.dhs);
  const S* wT = static_cast<const S*>(a.wT);
  S* dp = static_cast<S*>(a.dp);

  // Steps 1 and 3 map (row, column) to threads the same way, so a thread
  // reads back only the carries it wrote itself.
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    const long long q = (long long)(row0 + r) * H + j;
    dhc[idx] = r < nrows ? a.dhT[q] : 0.f;
    dcc[idx] = r < nrows ? a.dcT[q] : 0.f;
  }

  for (int t = a.T - 1; t >= 0; --t) {
    // 1. the gate pre-activation cotangents of this step
    for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H;
      float* drow = dps + r * G;
      if (r >= nrows) {  // ragged last block: inert zeros
        drow[j] = drow[H + j] = drow[2 * H + j] = drow[3 * H + j] = 0.f;
        continue;
      }
      const long long o = ((long long)t * a.B + row0 + r) * H + j;
      const float ig = to_f(ai[o]), fg = to_f(af[o]), og = to_f(ao[o]), gg = to_f(ag[o]);
      const float c = to_f(cs[o]);
      const float c_prev = t > 0 ? to_f(cs[o - (long long)a.B * H])
                                 : a.c0[(long long)(row0 + r) * H + j];
      const float dh = to_f(dhs[t * a.sdt + (long long)(row0 + r) * a.sdb + j]) + dhc[idx];
      const float tc = tanhf(c);
      const float dc = dh * og * (1.f - tc * tc) + dcc[idx];
      const float dpi = (dc * gg) * ig * (1.f - ig);
      const float dpf = (dc * c_prev) * fg * (1.f - fg);
      const float dpo = (dh * tc) * og * (1.f - og);
      const float dpg = (dc * ig) * (1.f - gg * gg);
      const long long po = ((long long)t * a.B + row0 + r) * G + j;
      dp[po] = from_f<S>(dpi);
      dp[po + H] = from_f<S>(dpf);
      dp[po + 2 * H] = from_f<S>(dpo);
      dp[po + 3 * H] = from_f<S>(dpg);
      drow[j] = as_operand<S>(dpi);
      drow[H + j] = as_operand<S>(dpf);
      drow[2 * H + j] = as_operand<S>(dpo);
      drow[3 * H + j] = as_operand<S>(dpg);
      dcc[idx] = dc * fg;
    }
    __syncthreads();

    // 2. part[k, r, j] = sum_m dp_k[r, m] * W_hh^T[k, m, j]
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      const int k = col / H, j = col - k * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const S* w = wT + k * a.swk + j;
      const float* d = dps + k * H;
#pragma unroll 8
      for (int m = 0; m < H; ++m) {
        const float wv = to_f(w[m * a.swm]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(d[r * G + m], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part[k * RH + r * H + j] = acc[r];
    }
    __syncthreads();

    // 3. the new dh carry, the four gates added in order. No barrier after
    //    it: the next step 1 reads dhc[idx] from the thread that wrote it,
    //    and part is rewritten only after the barrier that ends that step 1.
    for (int idx = threadIdx.x; idx < RH; idx += blockDim.x)
      dhc[idx] = ((part[idx] + part[RH + idx]) + part[2 * RH + idx]) + part[3 * RH + idx];
  }

  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    if (r < nrows) {
      const long long q = (long long)(row0 + r) * H + j;
      a.dh0[q] = dhc[idx];
      a.dc0[q] = dcc[idx];
    }
  }
}

// The stream record (ops/lstm_cuda.py:bwd_stream_geometry) gives the rows a
// block, the threads and the shared memory; a record this launcher would
// not launch as it says is refused.
template <typename S, int R>
cudaError_t launch(const Args& a, const int* geom, int dev, const DeviceInfo& info,
                   cudaStream_t stream) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)R * (4 * a.H + 4 * a.H + 2 * a.H);
  int threads = ((4 * a.H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (geom[5] != threads || (size_t)geom[6] != smem) return cudaErrorInvalidValue;
  cudaError_t err = open_smem(lstm_bwd_kernel<S, R>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + R - 1) / R;
  lstm_bwd_kernel<S, R><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_rows(const Args& a, const int* geom, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  switch (geom[2]) {
    case 1: return launch<S, 1>(a, geom, dev, *info, stream);
    case 2: return launch<S, 2>(a, geom, dev, *info, stream);
    case 4: return launch<S, 4>(a, geom, dev, *info, stream);
    case 8: return launch<S, 8>(a, geom, dev, *info, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: f32 streams and W_hh^T; 1: bf16. c0, dhT, dcT, dh0, dc0 are f32.
// geom: the route and its geometry (kGeomLen ints, ops/lstm_cuda.py:
// bwd_geometry): [0] 1 the cluster route (lstm_bwd_cluster.cuh), 0 the
// stream route (lstm_bwd_kernel above, at [2] rows a block, [5] threads and
// [6] bytes of shared memory).
// prof: null, or the cluster route's phase clock [5 T + 2] (int64).
// Returns the cudaError_t of the launch (0 = launched).
int dn_lstm_bwd(int dtype, const void* ai, const void* af, const void* ao, const void* ag,
                const void* cs, const void* wT, long long swk, long long swm,
                const void* c0, const void* dhs, long long sdt, long long sdb,
                const void* dhT, const void* dcT, void* dp, void* dh0, void* dc0,
                int T, int B, int H, const int* geom, void* prof, void* stream) {
  if (T < 1 || B < 1 || H < 1 || !geom) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geom[0] == 1) {
    BwdArgs b{ai, af, ao, ag, cs, wT, swk, swm, static_cast<const float*>(c0), {dhs, nullptr},
              {sdt, 0}, {sdb, 0}, static_cast<const float*>(dhT), static_cast<const float*>(dcT),
              dp, static_cast<float*>(dh0), static_cast<float*>(dc0), T, B, H, 1,
              static_cast<long long*>(prof)};
    return bwd_cluster_run<__nv_bfloat16>(dtype, b, geom, s, nullptr);
  }
  if (geom[0] != 0 || prof) return cudaErrorInvalidValue;
  Args a{ai, af, ao, ag, cs, wT, swk, swm, static_cast<const float*>(c0),
         dhs, sdt, sdb, static_cast<const float*>(dhT), static_cast<const float*>(dcT),
         dp, static_cast<float*>(dh0), static_cast<float*>(dc0), T, B, H};
  if (dtype == 0) return dispatch_rows<float>(a, geom, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(a, geom, s);
  return cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of the cluster route at `geom` for B rows
// into *out.
int dn_lstm_bwd_max_active_clusters(int dtype, int B, int H, const int* geom, int* out) {
  if (B < 1 || H < 1 || !geom || !out) return cudaErrorInvalidValue;
  BwdArgs a{};
  a.B = B;
  a.H = H;
  a.dirs = 1;
  return bwd_cluster_run<__nv_bfloat16>(dtype, a, geom, nullptr, out);
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
