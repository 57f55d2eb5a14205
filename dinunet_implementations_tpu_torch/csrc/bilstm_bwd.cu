// Bidirectional LSTM backward through time, both directions in one launch:
// K4 (dn_bilstm_bwd) and K6 (dn_bilstm_pool_bwd, the cotangent of a time-mean
// pool as a per-row f32 constant).
//
// Replaces: dinunet_implementations_tpu/ops/lstm_pallas.py:_bwd_bidir_kernel
// (K4, reached through _bwd_bidir_call / _vjp_bidir_bwd and the unbatched
// rule of _pool_bwd_kcall) and :_bwd_pool_kernel4 (K6, reached through
// _bwd_pool_call4 / the site-batched rule of _pool_bwd_kcall). The forward's
// streams are stored in x-time (bilstm_fwd.cu), so each direction's chain
// walks its own time backwards over x-time blocks: the forward direction
// t = T-1..0, the reverse direction t = 0..T-1. Per step and row, with that
// direction's i, f, o, g, c at t and c_prev, the cell state one step earlier
// in the direction's own time (forward: c[t-1], c0 at t = 0; reverse:
// c[t+1], one x-time step LATER, c0 at t = T-1):
//   dh  = dhs[t] + dh_carry
//   dc  = dh * o * (1 - tanh(c)^2) + dc_carry
//   dp_i = dc*g * i(1-i),  dp_f = dc*c_prev * f(1-f),
//   dp_o = dh*tanh(c) * o(1-o),  dp_g = dc*i * (1-g^2)
//   dh_carry <- sum_k dp_k @ W_hh[d, k]^T,   dc_carry <- dc * f
// The carries are seeded with dhT, dcT and kept in f32. dhs is a full
// [T, B, H] stream or a per-row constant (time stride 0): at the stream
// dtype for K4 (JAX's unbatched pool casts dpool/T to it), in f32 for K6.
// It writes dp [T, B, 8H] at the stream dtype (the forward direction's
// gates i, f, o, g, then the reverse direction's, side by side: the one
// [T, B, 8H] concat the weight-gradient products take) and dh0, dc0
// [2, B, H] in f32. bf16 mode: each dp is rounded to bf16 before the
// recurrent product, as the TPU kernel's dp.astype(cdt).
//
// What bounds it on this card. Each direction is K2's chain: 98 serial
// steps (flagship H=174), each 2*rows*4H*H FLOP against that direction's
// transposed W_hh (0.48 MB in f32). At 512 rows the FLOP bound it against
// f32 peak, the bytes in bf16.
//
// K4 and K6 each take one of two routes, chosen in Python by shape before
// any launch (ops/bilstm_cuda.py:bidir_bwd_geometry, on the card
// device_k4_geometry / device_bidir_bwd_geometry, each settled on its own
// kernel's occupancy) and passed as a record: K2's cluster BPTT
// (lstm_bwd_cluster.cuh) with half of the clusters a direction, each on its
// own time map, K4 reading its dhs stream (or constant) at the stream
// dtype, K6 its f32 constant; or, for a W_hh^T whose slice fits no cluster
// of 8, the stream route, the first design below, at the record's rows a
// block.
//
// What the first design does. K2's first design with a direction index:
// blockIdx.y picks the direction (its W_hh^T, its time map and c_prev
// neighbour), blockIdx.x a group of R rows; each block walks all T steps
// with its f32 carries in shared memory. Each thread owns a (gate, column)
// pair of the product and streams its column of W_hh^T, which the wrapper
// transposes once per call; the four per-gate partial sums meet in shared
// memory and are added in gate order, as the TPU kernel's dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "lstm_bwd_cluster.cuh"

namespace {

using namespace dn;

struct Args {
  const void* ai;  // [2, T, B, H] contiguous, stream dtype: the forward's residuals
  const void* af;
  const void* ao;
  const void* ag;
  const void* cs;
  const void* wT;   // [2, 4, H, H] contiguous: W_hh^T[d, k, m, j] = W_hh[d, k, j, m]
  const float* c0;  // [2, B, H] contiguous
  const void* dhs[2];  // per direction: dhs[t, b, j] at t*sdt + b*sdb + j (sdt 0: constant)
  long long sdt[2], sdb[2];
  const float* dhT;  // [2, B, H] contiguous
  const float* dcT;
  void* dp;     // [T, B, 8H] contiguous, stream dtype
  float* dh0;   // [2, B, H] f32
  float* dc0;
  int T, B, H;
};

// S: stream and weight dtype; DH: dtype of the dhs cotangent
template <typename S, typename DH, int R>
__global__ void __launch_bounds__(1024) bilstm_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 4 * H, RH = R * a.H, T = a.T;
  const int dir = blockIdx.y;
  float* dps = smem;           // [R, 4H] this step's dp, as the product reads them
  float* part = dps + R * G;   // [4, R, H] per-gate partial products
  float* dhc = part + 4 * RH;  // [R, H] f32 dh carry
  float* dcc = dhc + RH;       // [R, H] f32 dc carry
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const long long plane = (long long)dir * T * a.B * H;  // [2, T, B, H]
  const long long carry = (long long)dir * a.B * H;      // [2, B, H]
  const S* ai = static_cast<const S*>(a.ai) + plane;
  const S* af = static_cast<const S*>(a.af) + plane;
  const S* ao = static_cast<const S*>(a.ao) + plane;
  const S* ag = static_cast<const S*>(a.ag) + plane;
  const S* cs = static_cast<const S*>(a.cs) + plane;
  const DH* dhs = static_cast<const DH*>(a.dhs[dir]);
  const long long sdt = a.sdt[dir], sdb = a.sdb[dir];
  const S* wT = static_cast<const S*>(a.wT) + (long long)dir * 4 * H * H;
  S* dp = static_cast<S*>(a.dp);

  // Steps 1 and 3 map (row, column) to threads the same way, so a thread
  // reads back only the carries it wrote itself.
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H;
    const long long q = carry + (long long)(row0 + r) * H + j;
    dhc[idx] = r < nrows ? a.dhT[q] : 0.f;
    dcc[idx] = r < nrows ? a.dcT[q] : 0.f;
  }

  for (int s = 0; s < T; ++s) {
    const int t = dir ? s : T - 1 - s;
    const int tp = dir ? t + 1 : t - 1;  // c_prev's x-time
    // 1. the gate pre-activation cotangents of this step
    for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H;
      float* drow = dps + r * G;
      if (r >= nrows) {  // ragged last block: inert zeros
        drow[j] = drow[H + j] = drow[2 * H + j] = drow[3 * H + j] = 0.f;
        continue;
      }
      const long long row = row0 + r;
      const long long o = ((long long)t * a.B + row) * H + j;
      const float ig = to_f(ai[o]), fg = to_f(af[o]), og = to_f(ao[o]), gg = to_f(ag[o]);
      const float c = to_f(cs[o]);
      const float c_prev = (tp >= 0 && tp < T) ? to_f(cs[((long long)tp * a.B + row) * H + j])
                                               : a.c0[carry + row * H + j];
      const float dh = to_f(dhs[t * sdt + row * sdb + j]) + dhc[idx];
      const float tc = tanhf(c);
      const float dc = dh * og * (1.f - tc * tc) + dcc[idx];
      const float dpi = (dc * gg) * ig * (1.f - ig);
      const float dpf = (dc * c_prev) * fg * (1.f - fg);
      const float dpo = (dh * tc) * og * (1.f - og);
      const float dpg = (dc * ig) * (1.f - gg * gg);
      const long long po = ((long long)t * a.B + row) * 2 * G + dir * G + j;
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

    // 2. part[k, r, j] = sum_m dp_k[r, m] * W_hh^T[d, k, m, j]
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      const int k = col / H, j = col - k * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const S* w = wT + (long long)k * H * H + j;
      const float* d = dps + k * H;
#pragma unroll 8
      for (int m = 0; m < H; ++m) {
        const float wv = to_f(w[(long long)m * H]);
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
      const long long q = carry + (long long)(row0 + r) * H + j;
      a.dh0[q] = dhc[idx];
      a.dc0[q] = dcc[idx];
    }
  }
}

// geom: the stream record (ops/lstm_cuda.py:bwd_stream_geometry), whose rows
// a block, threads and shared memory are launched as it says or the record
// is refused.
template <typename S, typename DH, int R>
cudaError_t launch(const Args& a, const int* geom, int dev, const DeviceInfo& info,
                   cudaStream_t stream) {
  // the largest dynamic shared memory this instance was opened up to, by device
  static std::atomic<int> smem_set[kMaxDevices];
  const size_t smem = sizeof(float) * (size_t)R * (4 * a.H + 4 * a.H + 2 * a.H);
  int threads = ((4 * a.H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (geom[5] != threads || (size_t)geom[6] != smem) return cudaErrorInvalidValue;
  cudaError_t err = open_smem(bilstm_bwd_kernel<S, DH, R>, smem, dev, info, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + R - 1) / R, 2);
  bilstm_bwd_kernel<S, DH, R><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename DH>
cudaError_t dispatch_rows(const Args& a, const int* geom, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  cudaError_t err = current_device(&dev, &info);
  if (err != cudaSuccess) return err;
  switch (geom[2]) {
    case 1: return launch<S, DH, 1>(a, geom, dev, *info, stream);
    case 2: return launch<S, DH, 2>(a, geom, dev, *info, stream);
    case 4: return launch<S, DH, 4>(a, geom, dev, *info, stream);
    case 8: return launch<S, DH, 8>(a, geom, dev, *info, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* ai, const void* af, const void* ao, const void* ag, const void* cs,
               const void* wT, const void* c0, const void* dhsf, long long sdtf, long long sdbf,
               const void* dhsr, long long sdtr, long long sdbr, const void* dhT,
               const void* dcT, void* dp, void* dh0, void* dc0, int T, int B, int H) {
  return Args{ai, af, ao, ag, cs, wT, static_cast<const float*>(c0), {dhsf, dhsr},
              {sdtf, sdtr}, {sdbf, sdbr}, static_cast<const float*>(dhT),
              static_cast<const float*>(dcT), dp, static_cast<float*>(dh0),
              static_cast<float*>(dc0), T, B, H};
}

// The cluster route of both directions (lstm_bwd_cluster.cuh) at the
// record geom, dhs read as DH.
template <typename DH>
cudaError_t cluster_route(int dtype, const Args& a, const int* geom, void* prof,
                          cudaStream_t stream, int* max_active) {
  const long long hh = (long long)a.H * a.H;
  const BwdArgs b{a.ai, a.af, a.ao, a.ag, a.cs, a.wT, hh, a.H, a.c0,
                  {a.dhs[0], a.dhs[1]}, {a.sdt[0], a.sdt[1]}, {a.sdb[0], a.sdb[1]},
                  a.dhT, a.dcT, a.dp, a.dh0, a.dc0, a.T, a.B, a.H, 2,
                  static_cast<long long*>(prof)};
  return bwd_cluster_run<DH>(dtype, b, geom, stream, max_active);
}

}  // namespace

extern "C" {

// K4. dtype 0: f32 streams, W_hh^T and dhs; 1: bf16. c0, dhT, dcT, dh0, dc0
// are f32. A dhs time stride of 0 makes it a per-row constant. geom: the
// route and its geometry (kGeomLen ints, ops/bilstm_cuda.py:
// bidir_bwd_geometry): [0] 1 the cluster route (lstm_bwd_cluster.cuh, half
// of the clusters a direction, dhs at the stream dtype), 0 the stream route
// (bilstm_bwd_kernel above, at [2] rows a block, [5] threads and [6] bytes
// of shared memory). prof: null, or the cluster route's phase clock
// [5 T + 2] (int64, direction 0's block 0). Returns the cudaError_t of the
// launch (0 = launched).
int dn_bilstm_bwd(int dtype, const void* ai, const void* af, const void* ao, const void* ag,
                  const void* cs, const void* wT, const void* c0,
                  const void* dhsf, long long sdtf, long long sdbf,
                  const void* dhsr, long long sdtr, long long sdbr,
                  const void* dhT, const void* dcT, void* dp, void* dh0, void* dc0,
                  int T, int B, int H, const int* geom, void* prof, void* stream) {
  if (T < 1 || B < 1 || H < 1 || !geom) return cudaErrorInvalidValue;
  const Args a = make_args(ai, af, ao, ag, cs, wT, c0, dhsf, sdtf, sdbf, dhsr, sdtr, sdbr,
                           dhT, dcT, dp, dh0, dc0, T, B, H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the f32 SIMT kernel reads a float dhs; the bf16 tensor-core kernel a bf16 one
  if (geom[0] == 1) return cluster_route<__nv_bfloat16>(dtype, a, geom, prof, s, nullptr);
  if (geom[0] != 0 || prof) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_rows<float, float>(a, geom, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16, __nv_bfloat16>(a, geom, s);
  return cudaErrorInvalidValue;
}

// K6: dpoolf, dpoolr [B, H] f32 contiguous, the pool cotangent already
// divided by T, taken as a per-row constant at every step. geom: the route
// and its geometry (kGeomLen ints, ops/bilstm_cuda.py:bidir_bwd_geometry):
// [0] 1 the cluster route (lstm_bwd_cluster.cuh, half of the clusters a
// direction), 0 the stream route (bilstm_bwd_kernel above, at [2] rows a
// block, [5] threads and [6] bytes of shared memory). prof: null, or
// the cluster route's phase clock [5 T + 2] (int64, direction 0's block 0).
int dn_bilstm_pool_bwd(int dtype, const void* ai, const void* af, const void* ao,
                       const void* ag, const void* cs, const void* wT, const void* c0,
                       const void* dpoolf, const void* dpoolr, const void* dhT,
                       const void* dcT, void* dp, void* dh0, void* dc0, int T, int B, int H,
                       const int* geom, void* prof, void* stream) {
  if (T < 1 || B < 1 || H < 1 || !geom) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(ai, af, ao, ag, cs, wT, c0, dpoolf, 0, H, dpoolr, 0, H,
                           dhT, dcT, dp, dh0, dc0, T, B, H);
  if (geom[0] == 1) return cluster_route<float>(dtype, a, geom, prof, s, nullptr);
  if (geom[0] != 0 || prof) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_rows<float, float>(a, geom, s);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16, float>(a, geom, s);
  return cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of K6's cluster route at `geom` for B rows
// into *out (clusters of both directions together).
int dn_bilstm_bwd_max_active_clusters(int dtype, int B, int H, const int* geom, int* out) {
  if (B < 1 || H < 1 || !geom || !out) return cudaErrorInvalidValue;
  Args a{};
  a.B = B;
  a.H = H;
  return cluster_route<float>(dtype, a, geom, nullptr, nullptr, out);
}

// The same for K4's cluster route, whose bf16 instance reads a bf16 dhs (its
// registers, and so the clusters the card runs at once, are its own).
int dn_bilstm_k4_max_active_clusters(int dtype, int B, int H, const int* geom, int* out) {
  if (B < 1 || H < 1 || !geom || !out) return cudaErrorInvalidValue;
  Args a{};
  a.B = B;
  a.H = H;
  return cluster_route<__nv_bfloat16>(dtype, a, geom, nullptr, nullptr, out);
}

const char* dn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
