// Shared helpers for the attention kernels: element conversion for the two
// supported element types (fp32 and bf16) and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pandora {

// dtype codes passed through the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// -0.7 * FLT_MAX: the value a causally masked score takes in the plain
// attention (ops/attention_xla.py), so fully masked rows agree with it.
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  // Value of x after a round trip through the element type.
  __device__ static float round(float x) { return x; }
  // Two consecutive elements; p must be 8-byte aligned.
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // Two consecutive elements; p must be 4-byte aligned.
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace pandora
