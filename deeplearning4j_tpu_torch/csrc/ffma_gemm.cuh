// Helpers that every kernel source of the port includes: the f32 <-> storage
// dtype conversions (float32, bfloat16), the 16-byte alignment test of an
// operand, and the host-side device selection and SM count of a launch. (No
// FFMA GEMM lives here any more; the name stays because
// tests/test_torch_training_kernels.py edits this header by name.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dl4j {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

inline cudaError_t sm_count(int device, int* num_sms) {
  return cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace dl4j
