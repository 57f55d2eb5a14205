// Helpers shared by the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu): stream
// dtype conversions, the per-device attributes a launcher reads, and the
// rows-per-block choice. Each kernel source builds into its own shared
// library, so every library holds its own copy of the static state here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace dn {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// an operand of a recurrent product: cast to the weights' dtype first
template <typename S>
__device__ __forceinline__ float as_operand(float v) { return to_f(from_f<S>(v)); }

template <typename S>
__device__ __forceinline__ void store(void* p, long long i, float v) {
  if (p) static_cast<S*>(p)[i] = from_f<S>(v);
}

// Per-device attributes, read once per device: a launch sits on the serving
// path, where host time per dispatch shows as idle time on the card.
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  std::atomic<int> sms{0};
  std::atomic<int> smem_optin{0};
};

inline cudaError_t current_device(int* dev, const DeviceInfo** info) {
  static DeviceInfo infos[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = infos[*dev];
  if (d.sms.load() == 0) {
    int sms = 0, smem = 0;
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    d.smem_optin.store(smem);
    d.sms.store(sms);
  }
  *info = &d;
  return cudaSuccess;
}

// Rows per block: the fewest (1, 2, 4, 8) that keep the grid within one
// wave of blocks over the card's SMs.
inline int rows_per_block(int rows, int sms) {
  int r = 1;
  while (r < 8 && (rows + r - 1) / r > sms) r *= 2;
  return r;
}

// Opens a kernel instance up to `smem` bytes of dynamic shared memory on
// device `dev`, once per instance and device; `smem_set` is the instance's
// own record of what it was opened up to.
template <typename K>
cudaError_t open_smem(K kernel, size_t smem, int dev, const DeviceInfo& info,
                      std::atomic<int>* smem_set) {
  if (smem > (size_t)info.smem_optin.load()) return cudaErrorInvalidValue;
  if ((int)smem > smem_set[dev].load()) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store((int)smem);
  }
  return cudaSuccess;
}

}  // namespace dn
