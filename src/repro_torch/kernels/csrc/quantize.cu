// int8 block quantization with error feedback (K2) and its inverse (K3)
// for Hopper (sm_90a), hand-written CUDA C++.
//
// K2 `quantize_ef` replaces the Pallas TPU kernel `_quant_kernel` of
// src/repro/kernels/quantize.py:22 (wrapped by `quantize_ef`, :35). Per
// block of 256 values:
//
//   y       = x + err                     (x f32, or bf16 widened exactly)
//   scale   = max|y| / 127.0f             (an IEEE division)
//   q       = clamp(rint(y / max(scale, 1e-30f)), -127, 127)   (int8)
//   new_err = y - q * scale
//
// K3 `dequantize` replaces `_dequant_kernel` (quantize.py:63, wrapped by
// `dequantize`, :68): x = q * scale per 256-block, written through an
// output pointer so the parameter server lands a push straight in its
// receive row.
//
// The arithmetic is held equal to the jnp reference, not merely close:
//   * `jnp.round` rounds half to even, so q uses `rintf` (round to
//     nearest even in the default mode), not `roundf`;
//   * the divisions are IEEE (nvcc's default -prec-div=true; the build
//     passes no --use_fast_math), so a tie stays a tie;
//   * `q * scale` and `y - q * scale` are separate roundings in the
//     reference, so they use `__fmul_rn` / `__fsub_rn`, which nvcc does
//     not contract into one fused multiply-add.
// The error-feedback buffer then follows the reference bit for bit, round
// after round, and does not drift.
//
// What bounds them on the H100: bytes. K2 reads x (4 or 2 B) and err (4 B)
// and writes q (1 B), new_err (4 B) and a scale per 256 values: 13 B per
// value in f32, far below the ~295 FLOP/byte ridge. K3 reads 1 B and
// writes 4 B per value. The design keeps the traffic at that minimum:
//   * one warp owns one 256-block; lane l handles values l, l+32, ...,
//     l+224, so every load and store of a warp is one contiguous,
//     coalesced segment, and the block's absmax meets in a butterfly of
//     five shuffles with no shared memory;
//   * new_err may alias err (the wrapper writes it in place), since each
//     value is read once before it is written;
//   * nothing is staged: each value is read once and written once.
// Wider (16-byte) loads and more values per thread are left for a later
// PR.
//
// Launch shape. A thread block (CTA) holds `block` / 256 warps, one
// 256-block each: `block`, a multiple of 256 up to 8,192 (1,024
// threads), is a runtime argument that kernels/autotune.py chooses (the
// reference's grid block, autotune.py:303). A warp's arithmetic does not
// depend on its CTA, so every block gives the same bits; a CTA past the
// last 256-block masks its idle warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;                  // values per scale (QBLOCK)
constexpr int kMaxThreads = 1024;            // 32 warps: block <= 8,192
constexpr int kPerLane = kBlock / 32;        // values per lane

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
quantize_ef_kernel(const T* __restrict__ x, const float* err,
                   int8_t* __restrict__ q, float* __restrict__ scales,
                   float* new_err, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int64_t base = blk * kBlock;
  float y[kPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t idx = base + i * 32 + lane;
    y[i] = __fadd_rn(widen(x[idx]), err[idx]);
    amax = fmaxf(amax, fabsf(y[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(amax, 127.0f);
  const float denom = fmaxf(scale, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t idx = base + i * 32 + lane;
    const float qv = fminf(fmaxf(rintf(__fdiv_rn(y[i], denom)), -127.f), 127.f);
    q[idx] = static_cast<int8_t>(qv);
    new_err[idx] = __fsub_rn(y[i], __fmul_rn(qv, scale));
  }
  if (lane == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kMaxThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int64_t base = blk * kBlock;
  const float scale = scales[blk];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t idx = base + i * 32 + lane;
    out[idx] = __fmul_rn(static_cast<float>(q[idx]), scale);
  }
}

// the grid of `block`-value CTAs over n_blocks 256-blocks; false when
// `block` is no multiple of 256 in [256, 8192] or the grid is too large
bool shape_for(int64_t n_blocks, int block, dim3* grid, dim3* threads) {
  if (block < kBlock || block > kMaxThreads / 32 * kBlock || block % kBlock)
    return false;
  const int64_t warps = block / kBlock;
  const int64_t ctas = (n_blocks + warps - 1) / warps;
  if (ctas > 0x7fffffff) return false;
  *grid = dim3(static_cast<unsigned>(ctas));
  *threads = dim3(static_cast<unsigned>(32 * warps));
  return true;
}

}  // namespace

// Plain C entry points, loaded with ctypes. `n` is the number of values,
// a positive multiple of 256; `block` the values per thread block, a
// multiple of 256 in [256, 8192]. x_dtype: 0 = float32, 1 = bfloat16.
// Each launches on `stream`, does not synchronise, allocates nothing,
// and returns the cudaError_t of the launch (0 on success).
extern "C" int quantize_ef(const void* x, int x_dtype, const float* err,
                           int8_t* q, float* scales, float* new_err,
                           int64_t n, int block, void* stream) {
  dim3 grid, threads;
  if (n <= 0 || n % kBlock != 0 ||
      !shape_for(n / kBlock, block, &grid, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = n / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    quantize_ef_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), err, q, scales, new_err, n_blocks);
  else if (x_dtype == 1)
    quantize_ef_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), err, q, scales, new_err,
        n_blocks);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize(const int8_t* q, const float* scales, float* out,
                          int64_t n, int block, void* stream) {
  dim3 grid, threads;
  if (n <= 0 || n % kBlock != 0 ||
      !shape_for(n / kBlock, block, &grid, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scales, out, n / kBlock);
  return static_cast<int>(cudaGetLastError());
}
