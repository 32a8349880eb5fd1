// Pieces shared by the SSD scan's tensor-core kernels (ssd_scan.cu) and
// its backward's (ssd_scan_bwd.cu): the swizzle atom's alignment of the
// dynamic shared memory, and a chunk's cumulative log decay scanned by
// one block.
#pragma once

#include <stdint.h>

#include "flash_tc.cuh"

namespace {

// first 1024-byte boundary at or after p (the swizzle atom's alignment)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = tc::smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// cum_s[i] = inclusive sum of dt * A over positions [0, n) of chunk c,
// dt_s[i] = dt; n <= NT * (the loop's rounds), all NT threads of the
// block take part. `d` is the calling file's shape: d.row(b, t), d.Q, d.H.
template <int NT, typename D>
__device__ __forceinline__ void block_cumsum(float* cum_s, float* dt_s,
                                             float* wsum, const float* dt,
                                             const D& d, int b, int h, int c,
                                             int n, float A) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += NT) {
    const int i = base + tid;
    const float dv = i < n ? dt[d.row(b, c * d.Q + i) * d.H + h] : 0.f;
    float v = dv * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[w] = v;
    __syncthreads();
    float seg = 0.f;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) {
      if (k < w) v += wsum[k];
      seg += wsum[k];
    }
    if (i < n) {
      cum_s[i] = carry + v;
      dt_s[i] = dv;
    }
    carry += seg;
    __syncthreads();                     // wsum reused; cum_s visible
  }
}

}  // namespace
