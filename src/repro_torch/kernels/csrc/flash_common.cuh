// Pieces shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels: conversions between the
// stored type and the f32 the kernels compute in, and the strides of a
// (B, S, H, hd) tensor whose last dimension is contiguous.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Strides {                      // element strides of dims (B, S, H)
  int64_t b, s, h;
};

}  // namespace
