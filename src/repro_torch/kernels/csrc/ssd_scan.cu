// Mamba-2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (wrapped by `ssd_scan_fwd` and
// kernels/ops.py:ssd_scan). It computes what the JAX model computes,
// `repro.models.mamba.ssd_scan_ref` (mamba.py:70-138), final state
// included, in the model layout:
//
//   x (B, S, H, P) f32|bf16, dt (B, S, H) f32 (after softplus),
//   a_log (H,) f32, b/c (B, S, G, N) in x's type, H % G == 0
//   -> y (B, S, H, P) in x's type, state (B, H, P, N) f32
//
// with A = -exp(a_log), xdt = x * dt in f32 and, per chunk of Q positions
// (cum the inclusive cumulative sum of dt * A, reset at every chunk):
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) xdt_s
//           + exp(cum_t) C_t . state_in
//   state = exp(cum_last) state_in + sum_s exp(cum_last - cum_s) xdt_s B_s^T
// Head h reads B/C group h / (H/G). A ragged tail (S % Q != 0) is a short
// last chunk: positions >= S are never read, which equals the reference's
// dt = 0 padding (its padded steps are identities).
//
// Differences from the TPU kernel, by design:
//   * The Pallas grid walked the chunks of one (batch, head) in order and
//     carried the state in VMEM scratch. Blocks on the H100 run in
//     parallel in no order, and a grid over (b, h) alone would fill 64-128
//     of the 132 SMs. So the scan is four kernels, each parallel over
//     chunks (the chunked design of the Mamba-2 paper, arXiv:2405.21060):
//       1. ssd_cumsum      cum (B, H, S): per chunk, a block scan of dt * A;
//       2. ssd_chunk_cb    CB (B, G, nc, Q, Q) = B_s . C_t, per group, once
//                          for all H/G heads of the group (lower triangle);
//       3. ssd_chunk_state each chunk's own state contribution (no carry);
//       4. ssd_state_pass  the carry: one thread per state element walks the
//                          chunks in order, leaving each chunk's incoming
//                          state in place of its contribution, and writes
//                          the final state;
//       5. ssd_chunk_scan  y per (chunk, 64-row tile): the incoming state's
//                          term, then the masked quadratic form over CB.
//   * The wrapper's repeats of B/C to heads and its cast of xdt to x's
//     type (ops.py:71-78) are gone: groups by index, xdt in f32 (the model
//     keeps it in f32, mamba.py:101).
//   * The final state is an output (the prefill cache needs it).
//
// What bounds it on the H100. At the serve's largest prefill (B 2, S 2048,
// H 64, P 64, G 1, N 128, Q 256, bf16) the inputs and outputs are ~75 MB
// (~22 us at 3.35 TB/s) and the products ~17 GFLOP (~18 us on the bf16
// tensor cores, ~0.26 ms at the f32 CUDA-core rate). This first version
// computes in f32 FMAs on the CUDA cores, so the FMAs bound it. What the
// design does about that: every product is a 64 x 64 output tile per
// block of 256 threads, each thread 4 x 4 outputs from float4 reads of two
// shared-memory operand panels (16 FMAs per 3 shared-memory wavefronts);
// C.B^T is computed once per group, not once per head; tiles above the
// diagonal are skipped; exp is taken only where the mask keeps it (the
// upper triangle's cum_t - cum_s > 0 would overflow). The scratch (cum, CB,
// chunk states; ~39 MB at that shape) stays mostly in the 50 MB L2.
// Tensor cores (wgmma on TMA-fed tiles) are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;          // output tile edge
constexpr int kK = 32;          // depth of one shared-memory stage
constexpr int kLd = kT + 4;     // panel row stride: float4-aligned, and
                                // transposed stores hit 8 banks, not 1
constexpr int kMaxQ = 256;      // largest chunk (one cumsum block)

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][4 tx + j], k < kK.
__device__ __forceinline__ void tile_fma(const float* a, const float* b,
                                         float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Shape of one call, and the chunk a block works on.
struct Dims {
  int B, S, H, P, G, N, Q, nc;
  __device__ int64_t row(int b, int t) const { return (int64_t)b * S + t; }
  __device__ int valid(int c) const { return min(Q, S - c * Q); }
};

// 1. cum[b, h, t] = inclusive sum of dt * A over t's chunk up to t.
__global__ void __launch_bounds__(kMaxQ)
ssd_cumsum(const float* __restrict__ dt, const float* __restrict__ a_log,
           float* __restrict__ cum, Dims d) {
  __shared__ float warp_sum[kMaxQ / 32];
  const int c = blockIdx.x, b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int i = threadIdx.x, lane = i & 31, w = i >> 5;
  const bool ok = i < d.valid(c);
  const int t = c * d.Q + i;
  const float A = -expf(a_log[h]);
  float v = ok ? dt[d.row(b, t) * d.H + h] * A : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sum[w] = v;
  __syncthreads();
  for (int k = 0; k < w; ++k) v += warp_sum[k];
  if (ok) cum[((int64_t)b * d.H + h) * d.S + t] = v;
}

// Stage a kT-row x kK-column panel of a (rows, cols) row-major tensor
// into smem transposed: dst[k][r] = src(r0 + r, k0 + k), zero outside
// rows < r_end, cols < k_end. Reads are coalesced along the columns.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src,
                                       int64_t row_stride, int r0, int r_end,
                                       int k0, int k_end) {
  using C = Cvt<T>;
  for (int idx = threadIdx.x; idx < kT * kK; idx += kThreads) {
    const int r = idx / kK, k = idx % kK;
    float v = 0.f;
    if (r0 + r < r_end && k0 + k < k_end)
      v = C::load(src[(int64_t)(r0 + r) * row_stride + k0 + k]);
    dst[k * kLd + r] = v;
  }
}

// 2. cb[b, g, c, s, t] = B_s . C_t for s, t in chunk c (tiles with
// s-tile <= t-tile; the others are never read).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_cb(const T* __restrict__ bm, const T* __restrict__ cm,
             float* __restrict__ cb, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  const int nt = (d.Q + kT - 1) / kT;
  const int c = blockIdx.x / (nt * nt);
  const int ts = (blockIdx.x / nt) % nt, tt = blockIdx.x % nt;
  if (ts > tt) return;
  const int b = blockIdx.y / d.G, g = blockIdx.y % d.G;
  const int qv = d.valid(c);
  const int64_t rs = (int64_t)d.G * d.N;
  const T* bsrc = bm + d.row(b, c * d.Q) * rs + (int64_t)g * d.N;
  const T* csrc = cm + d.row(b, c * d.Q) * rs + (int64_t)g * d.N;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < d.N; n0 += kK) {
    load_t(sa, bsrc, rs, ts * kT, qv, n0, d.N);
    load_t(sb, csrc, rs, tt * kT, qv, n0, d.N);
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = cb + (((int64_t)b * d.G + g) * d.nc + c) * d.Q * d.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ts * kT + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tt * kT + 4 * tx + j;
      if (s < d.Q && t < d.Q) out[(int64_t)s * d.Q + t] = acc[i][j];
    }
  }
}

// Chunk-local copies of cum and dt for positions [0, n) of chunk c.
__device__ __forceinline__ void load_chunk_scalars(
    float* cum_s, float* dt_s, const float* cum, const float* dt, Dims d,
    int b, int h, int c, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = c * d.Q + i;
    cum_s[i] = cum[((int64_t)b * d.H + h) * d.S + t];
    dt_s[i] = dt[d.row(b, t) * d.H + h];
  }
}

// 3. states[b, h, c, n, p] = sum_s exp(cum_last - cum_s) xdt_s[p] B_s[n]
// over chunk c alone. One block per (chunk, n-tile, p-tile, b, h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ bm, const float* __restrict__ cum,
                float* __restrict__ states, Dims d) {
  using C = Cvt<T>;
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ];
  const int ntn = (d.N + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  const int c = blockIdx.x / (ntn * ntp);
  const int n0 = (blockIdx.x / ntp) % ntn * kT, p0 = blockIdx.x % ntp * kT;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int g = h / (d.H / d.G);
  const int qv = d.valid(c);
  load_chunk_scalars(cum_s, dt_s, cum, dt, d, b, h, c, qv);
  __syncthreads();
  const float last = cum_s[qv - 1];
  const int64_t xrs = (int64_t)d.H * d.P, brs = (int64_t)d.G * d.N;
  const T* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
  const T* bsrc = bm + d.row(b, c * d.Q) * brs + (int64_t)g * d.N;
  float acc[4][4];
  zero(acc);
  for (int s0 = 0; s0 < qv; s0 += kK) {
    for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
      const int k = idx / kT, col = idx % kT, s = s0 + k;
      float bv = 0.f, xv = 0.f;
      if (s < qv && n0 + col < d.N)
        bv = C::load(bsrc[(int64_t)s * brs + n0 + col]);
      if (s < qv && p0 + col < d.P)
        xv = C::load(xsrc[(int64_t)s * xrs + p0 + col]) * dt_s[s] *
             expf(last - cum_s[s]);
      sa[k * kLd + col] = bv;
      sb[k * kLd + col] = xv;
    }
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = states + (((int64_t)b * d.H + h) * d.nc + c) * d.N * d.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tx + j;
      if (n < d.N && p < d.P) out[(int64_t)n * d.P + p] = acc[i][j];
    }
  }
}

// 4. The carry across chunks, one thread per (b, h, n, p): states[c]
// becomes the state entering chunk c; the final state goes to `state`
// (B, H, P, N).
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ cum,
               float* __restrict__ state, Dims d) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= d.N * d.P) return;
  const int64_t bh = blockIdx.y;
  float* st = states + bh * d.nc * d.N * d.P + e;
  const float* cm = cum + bh * d.S;
  float carry = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const float own = st[(int64_t)c * d.N * d.P];
    st[(int64_t)c * d.N * d.P] = carry;
    const float decay = expf(cm[min((c + 1) * d.Q, d.S) - 1]);
    carry = carry * decay + own;
  }
  const int n = e / d.P, p = e % d.P;
  state[(bh * d.P + p) * d.N + n] = carry;
}

// 5. y for one (chunk, 64-row tile, p-tile, b, h): exp(cum_t) C_t .
// state_in, then the masked quadratic form sum_{s<=t} CB[s][t]
// exp(cum_t - cum_s) xdt_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ cm, const float* __restrict__ cum,
               const float* __restrict__ cb,
               const float* __restrict__ states, T* __restrict__ y, Dims d) {
  using C = Cvt<T>;
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ];
  const int nt = (d.Q + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  const int c = blockIdx.x / (nt * ntp);
  const int t0 = (blockIdx.x / ntp) % nt * kT, p0 = blockIdx.x % ntp * kT;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int g = h / (d.H / d.G);
  const int qv = d.valid(c);
  if (t0 >= qv) return;
  const int s_end = min(t0 + kT, qv);      // positions this tile can see
  load_chunk_scalars(cum_s, dt_s, cum, dt, d, b, h, c, s_end);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
  zero(acc);

  // the incoming state's term (none for the first chunk)
  if (c > 0) {
    const int64_t crs = (int64_t)d.G * d.N;
    const T* csrc = cm + d.row(b, c * d.Q) * crs + (int64_t)g * d.N;
    const float* s_in =
        states + (((int64_t)b * d.H + h) * d.nc + c) * d.N * d.P;
    for (int n0 = 0; n0 < d.N; n0 += kK) {
      load_t(sa, csrc, crs, t0, qv, n0, d.N);
      for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
        const int k = idx / kT, p = idx % kT;
        sb[k * kLd + p] = (n0 + k < d.N && p0 + p < d.P)
                              ? s_in[(int64_t)(n0 + k) * d.P + p0 + p]
                              : 0.f;
      }
      __syncthreads();
      tile_fma(sa, sb, acc);
      __syncthreads();
    }
  }
  __syncthreads();                         // cum_s, dt_s visible
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    const float e = t < qv ? expf(cum_s[t]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= e;
  }

  // the masked quadratic form over s <= t
  const int64_t xrs = (int64_t)d.H * d.P;
  const T* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
  const float* cbc =
      cb + (((int64_t)b * d.G + g) * d.nc + c) * d.Q * d.Q;
  for (int s0 = 0; s0 < s_end; s0 += kK) {
    for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
      const int k = idx / kT, col = idx % kT, s = s0 + k, t = t0 + col;
      float w = 0.f, xv = 0.f;
      if (s < s_end && s <= t && t < qv)  // select: exp only below diagonal
        w = cbc[(int64_t)s * d.Q + t] * expf(cum_s[t] - cum_s[s]);
      if (s < s_end && p0 + col < d.P)
        xv = C::load(xsrc[(int64_t)s * xrs + p0 + col]) * dt_s[s];
      sa[k * kLd + col] = w;
      sb[k * kLd + col] = xv;
    }
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }

  T* ydst = y + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tx + j;
      if (t < qv && p < d.P) ydst[(int64_t)t * xrs + p] = C::store(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a_log,
                   const void* bm, const void* cm, void* y, float* state,
                   float* cum, float* cb, float* states, Dims d,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const int nt = (d.Q + kT - 1) / kT;
  const int ntn = (d.N + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  cudaError_t err;
  ssd_cumsum<<<dim3(d.nc, d.B * d.H), kMaxQ, 0, stream>>>(dt, a_log, cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_cb<T><<<dim3(d.nc * nt * nt, d.B * d.G), kThreads, 0, stream>>>(
      bt, ct, cb, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_state<T><<<dim3(d.nc * ntn * ntp, d.B * d.H), kThreads, 0,
                       stream>>>(xt, dt, bt, cum, states, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<<<dim3((d.N * d.P + kThreads - 1) / kThreads, d.B * d.H),
                   kThreads, 0, stream>>>(states, cum, state, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan<T><<<dim3(d.nc * nt * ntp, d.B * d.H), kThreads, 0,
                      stream>>>(xt, dt, ct, cum, cb, states,
                                static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16
// (x, b, c and y). Every tensor contiguous. Scratch, allocated by the
// caller: cum (B, H, S) f32, cb (B, G, nc, Q, Q) f32, states
// (B, H, nc, N, P) f32, with nc = ceil(S / Q). Launches on `stream`, does
// not synchronise, allocates nothing, and returns the first cudaError_t
// of its launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt,
                            const float* a_log, const void* b, const void* c,
                            void* y, float* state, float* cum, float* cb,
                            float* states, int dtype, int B, int S, int H,
                            int P, int G, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || H % G != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, S, H, P, G, N, Q, (S + Q - 1) / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dt, a_log, b, c, y, state, cum, cb, states, d, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, a_log, b, c, y, state, cum, cb, states,
                                d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
