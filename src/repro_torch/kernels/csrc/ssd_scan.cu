// Mamba-2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (wrapped by `ssd_scan_fwd` and
// kernels/ops.py:ssd_scan). It computes what the JAX model computes,
// `repro.models.mamba.ssd_scan_ref` (mamba.py:70-138), final state
// included, in the model layout:
//
//   x (B, S, H, P) f32|bf16, dt (B, S, H) f32 (after softplus),
//   a_log (H,) f32|bf16, b/c (B, S, G, N) in x's type, H % G == 0
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
//     of the 132 SMs. So the scan is a few kernels, each parallel over
//     chunks (the chunked design of the Mamba-2 paper, arXiv:2405.21060):
//     C.B^T per group, each chunk's own state, a carry pass over the
//     chunks, and y per (chunk, 64-row tile).
//   * The wrapper's repeats of B/C to heads and its cast of xdt to x's
//     type (ops.py:71-78) are gone: groups by index, xdt in f32 (the model
//     keeps it in f32, mamba.py:101).
//   * The final state is an output (the prefill cache needs it).
//
// What bounds it on the H100. At the serve's largest prefill (B 2, S 2048,
// H 64, P 64, G 1, N 128, Q 256, bf16) the inputs and outputs are ~75 MB
// (~22 us at 3.35 TB/s) and the products ~13 GFLOP (~13 us on the bf16
// tensor cores, ~0.2 ms at the f32 CUDA-core rate): the bytes bound it,
// provided the products run on the tensor cores.
//
// Two instances, picked by the wrapper from dtype and widths and named
// by `instance` (a choice of design, not a fallback):
//
// * bf16 at P 64 and N 64 or 128 (mamba2-1.3b, jamba): four kernels on
//   the tensor cores, `wgmma` m64n64k16 from 128-byte-swizzled shared
//   tiles (flash_tc.cuh), every sum in f32:
//     1. ssd_chunk_cb_tc     CB[t][s] = C_t . B_s per group, once for all
//                            H/G heads; one warpgroup per (64 x 64) tile
//                            on or below the diagonal; C and B are
//                            K-major tiles copied by cp.async (exact);
//                            f32 out, rows padded to whole tiles.
//     2. ssd_chunk_state_tc  states_c[n][p] = sum_s B_s[n] (exp(cum_last
//                            - cum_s) dt_s x_s[p]) per (b, h, chunk); N/64
//                            warpgroups of 64 state rows each. B goes by
//                            cp.async into a swizzled tile read as the
//                            transposed (MN-major) A operand; the scaled x
//                            is written by the threads, rounded to bf16,
//                            as the MN-major B operand. Positions walk in
//                            tiles of 64 through two stages: the next B
//                            tile's copy and the next x tile's scaling run
//                            while the current products do. Also writes
//                            the chunk's total log decay for the carry.
//     3. ssd_state_carry     the carry on the CUDA cores: four state
//                            elements a thread walk the chunks in order in
//                            f32; each chunk's incoming state is written
//                            once in bf16, [p][n], the K-major B tile the
//                            scan wants; the final state in f32.
//     4. ssd_chunk_scan_tc   y per (b, h, chunk, 64-row t tile), one
//                            warpgroup: the inter term C_t . S_in^T
//                            (both K-major, like Q.K^T; none in chunk 0),
//                            its rows scaled by exp(cum_t); then for each
//                            s tile at or below t's, the weights
//                            W[t][s] = CB[t][s] exp(cum_t - cum_s) dt_s
//                            built in registers in the accumulator's
//                            fragment layout, masked to s <= t < valid
//                            before the exp (above the diagonal
//                            cum_t - cum_s > 0 overflows) on the diagonal
//                            and ragged tiles only, rounded to bf16 in
//                            pairs as the register A operand, times the
//                            unscaled x_s tile (MN-major, like V in P.V).
//                            The next x tile's copy (two stages) and the
//                            next tile's W run while the current products
//                            do (W during the inter term for the first).
//   The operands rounded to bf16 are W, the scaled x and S_in; B, C and
//   x reach the tensor cores as they are. Each kernel computes the chunk's
//   cumulative decay itself (a block scan of dt * A over at most 256
//   values in shared memory): no cum scratch and no cumsum launch.
//   Load balance over the triangle: one block per t tile, the heaviest
//   tiles (most s tiles) first in the grid, so the short ones fill the
//   last wave; with thousands of blocks at the serve's shapes (4,096 at
//   (2, 2048)) and four resident per SM this balances without pairing
//   t tiles in one block (pairing would hold a second warpgroup idle).
// * float32 (any width) and bf16 at other widths (the smoke widths P/N
//   16/32): five kernels on the CUDA cores, f32 FMAs: ssd_cumsum (cum per
//   chunk), ssd_chunk_cb, ssd_chunk_state, ssd_state_pass and
//   ssd_chunk_scan. f32 stays off the tensor cores because TF32 would
//   break the f32 tolerance (1e-3) and the f32 prefill-vs-decode check.
//   Every product is a 64 x 64 output tile per block of 256 threads, each
//   thread 4 x 4 outputs from float4 reads of two shared-memory panels;
//   tiles above the diagonal are skipped; exp only where the mask keeps
//   it.
//
// Scratch lives in one workspace the caller allocates
// (`ssd_scan_workspace_bytes`), carved here.
//
// Later work, not here: the carry fused into the state kernel (its f32
// chunk states are the largest scratch traffic), a producer warp with TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;          // output tile edge
constexpr int kK = 32;          // depth of one shared-memory stage
constexpr int kLd = kT + 4;     // panel row stride: float4-aligned, and
                                // transposed stores hit 8 banks, not 1
constexpr int kMaxQ = 256;      // largest chunk (one cumsum block)
constexpr int kWG = 128;        // threads of one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shape of one call, and the chunk a block works on.
struct Dims {
  int B, S, H, P, G, N, Q, nc;
  const void* a_log;            // (H,) f32 or bf16
  int a_bf16;
  __device__ int64_t row(int b, int t) const { return (int64_t)b * S + t; }
  __device__ int valid(int c) const { return min(Q, S - c * Q); }
  __device__ float A(int h) const {   // A = -exp(a_log[h])
    const float v = a_bf16
        ? __bfloat162float(static_cast<const bf16*>(a_log)[h])
        : static_cast<const float*>(a_log)[h];
    return -expf(v);
  }
};

// ---------------------------------------------------------------------------
// The CUDA-core instance (f32; bf16 at widths other than P 64 / N 64|128)
// ---------------------------------------------------------------------------

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

// 1. cum[b, h, t] = inclusive sum of dt * A over t's chunk up to t.
__global__ void __launch_bounds__(kMaxQ)
ssd_cumsum(const float* __restrict__ dt, float* __restrict__ cum, Dims d) {
  __shared__ float warp_sum[kMaxQ / 32];
  const int c = blockIdx.x, b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int i = threadIdx.x, lane = i & 31, w = i >> 5;
  const bool ok = i < d.valid(c);
  const int t = c * d.Q + i;
  const float A = d.A(h);
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

// ---------------------------------------------------------------------------
// The tensor-core instance (bf16, P 64, N 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kTcP = 64;                 // head dim the instance takes
constexpr int kTileBytesX = kT * kTcP * 2;   // a 64 x 64 bf16 tile

template <int N> struct TcSmem {
  static constexpr int kTileN = kT * N * 2;    // a 64 x N bf16 tile
  // C tile and B tile
  static constexpr int kCb = 2 * kTileN + 1024;
  // two stages of (B tile, scaled-x tile)
  static constexpr int kState = 2 * (kTileN + kTileBytesX) + 1024;
  // C tile, S_in tile, two x tiles
  static constexpr int kScan = 2 * kTileN + 2 * kTileBytesX + 1024;
};

// first 1024-byte boundary at or after p (the swizzle atom's alignment)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = tc::smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// cum_s[i] = inclusive sum of dt * A over positions [0, n) of chunk c,
// dt_s[i] = dt; n <= kMaxQ, all NT threads of the block take part.
template <int NT>
__device__ __forceinline__ void block_cumsum(float* cum_s, float* dt_s,
                                             float* wsum, const float* dt,
                                             const Dims& d, int b, int h,
                                             int c, int n, float A) {
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

// 1. CB[t][s] = C_t . B_s for the 64 x 64 tile (tt, ts <= tt) of chunk c,
// f32, rows of Qp = 64 nt values (tiles whose rows all lie past the
// chunk's valid positions are never read and not written).
template <int N>
__global__ void __launch_bounds__(kWG)
ssd_chunk_cb_tc(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                float* __restrict__ cb, Dims d) {
  using M = TcSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sc = tc::smem_addr(align1024(smem_raw));
  const uint32_t sb = sc + M::kTileN;
  const int nt = (d.Q + kT - 1) / kT, qp = nt * kT;
  const int c = blockIdx.x / (nt * nt);
  const int ts = (blockIdx.x / nt) % nt, tt = blockIdx.x % nt;
  const int qv = d.valid(c);
  if (ts > tt || tt * kT >= qv) return;
  const int b = blockIdx.y / d.G, g = blockIdx.y % d.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t rs = (int64_t)d.G * d.N;
  const int64_t off = d.row(b, c * d.Q) * rs + (int64_t)g * d.N;
  tc::load_tile<kT, N, kWG>(sc, cm + off, rs, tt * kT, qv, tid);
  tc::load_tile<kT, N, kWG>(sb, bm + off, rs, ts * kT, qv, tid);
  tc::cp_commit();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  tc::cp_wait<0>();
  tc::fence_to_async();
  __syncthreads();
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::mma_ss<64>(acc, tc::desc_k<kT>(sc, kk), tc::desc_k<kT>(sb, kk),
                   kk > 0);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::reg_fence(acc);
  float* out = cb + (((int64_t)b * d.G + g) * d.nc + c) * qp * qp +
               (int64_t)(tt * kT + warp * 16 + lane / 4) * qp + ts * kT +
               2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (int64_t)8 * r * qp + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// Rows [s0, s0 + 64) of one head's x, scaled by dt_s exp(last - cum_s)
// and rounded to bf16, into the swizzled 64 x 64 tile at `tile`; rows at
// or past qv are zero.
template <int NT>
__device__ __forceinline__ void write_scaled_x(uint8_t* tile,
                                               const bf16* xsrc,
                                               int64_t xrs, int s0, int qv,
                                               float last,
                                               const float* cum_s,
                                               const float* dt_s) {
  for (int i = threadIdx.x; i < kT * kTcP / 8; i += NT) {
    const int r = i / (kTcP / 8), ch = i % (kTcP / 8), s = s0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (s < qv) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(xsrc + s * xrs + ch * 8);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      const float f = dt_s[s] * expf(last - cum_s[s]);
      out.x = tc::pack_bf16(__bfloat162float(v[0]) * f,
                            __bfloat162float(v[1]) * f);
      out.y = tc::pack_bf16(__bfloat162float(v[2]) * f,
                            __bfloat162float(v[3]) * f);
      out.z = tc::pack_bf16(__bfloat162float(v[4]) * f,
                            __bfloat162float(v[5]) * f);
      out.w = tc::pack_bf16(__bfloat162float(v[6]) * f,
                            __bfloat162float(v[7]) * f);
    }
    *reinterpret_cast<uint4*>(tile + tc::chunk_offset<kT>(r, ch)) = out;
  }
}

// 2. contrib[b, h, c][p][n] = sum_s B_s[n] (exp(cum_last - cum_s) dt_s
// x_s[p]) over chunk c alone, and totals[b, h, c] = cum_last.
template <int N>
__global__ void __launch_bounds__(2 * N)
ssd_chunk_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ bm, float* __restrict__ contrib,
                   float* __restrict__ totals, Dims d) {
  using M = TcSmem<N>;
  constexpr int NT = 2 * N;                  // N / 64 warpgroups
  constexpr int kStage = M::kTileN + kTileBytesX;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ], wsum[NT / 32];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sbase = tc::smem_addr(base);
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const int qv = d.valid(c), ns = (qv + kT - 1) / kT;
  const int64_t brs = (int64_t)d.G * d.N, xrs = (int64_t)d.H * kTcP;
  const bf16* bsrc = bm + d.row(b, c * d.Q) * brs + (int64_t)g * d.N;
  const bf16* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * kTcP;
  tc::load_tile<kT, N, NT>(sbase, bsrc, brs, 0, qv, tid);
  tc::cp_commit();
  block_cumsum<NT>(cum_s, dt_s, wsum, dt, d, b, h, c, qv, d.A(h));
  const float last = cum_s[qv - 1];
  write_scaled_x<NT>(base + M::kTileN, xsrc, xrs, 0, qv, last, cum_s, dt_s);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int j = 0; j < ns; ++j) {
    const uint32_t st = sbase + (j & 1) * kStage;
    const int nxt = ((j + 1) & 1) * kStage;
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();               // stage j landed; stage j - 1 consumed
    if (j + 1 < ns) {
      tc::load_tile<kT, N, NT>(sbase + nxt, bsrc, brs, (j + 1) * kT, qv,
                               tid);
      tc::cp_commit();
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_ss_mn<64>(acc, tc::desc_mn<kT>(st + wg * kT * 128, kk),
                        tc::desc_mn<kT>(st + M::kTileN, kk), 1);
    tc::wg_commit();
    if (j + 1 < ns)                // next x tile while the products run
      write_scaled_x<NT>(base + nxt + M::kTileN, xsrc, xrs, (j + 1) * kT,
                         qv, last, cum_s, dt_s);
    tc::wg_wait<0>();
    tc::reg_fence(acc);
  }
  // rows n = 64 wg + 16 warp + lane / 4 (+ 8), columns p = 8 j + 2 (lane
  // % 4) (+ 1); stored [p][n]
  float* out = contrib + ((int64_t)bh * d.nc + c) * kTcP * N +
               wg * kT + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(int64_t)(8 * j + 2 * (lane % 4) + (e & 1)) * N + 8 * (e >> 1)] =
          acc[4 * j + e];
  if (tid == 0) totals[(int64_t)bh * d.nc + c] = last;
}

// 3. The carry across chunks, four elements of one (b, h) state a thread,
// in f32: s_in[b, h, c] (bf16, [p][n]) = the state entering chunk c >= 1;
// the final state (B, H, P, N) f32.
__global__ void __launch_bounds__(kThreads)
ssd_state_carry(const float* __restrict__ contrib,
                const float* __restrict__ totals, bf16* __restrict__ s_in,
                float* __restrict__ state, Dims d) {
  const int pn = d.P * d.N;
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= pn) return;
  const int64_t bh = blockIdx.y;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc; ++c) {
    const int64_t at = (bh * d.nc + c) * pn + e;
    const float4 own = *reinterpret_cast<const float4*>(contrib + at);
    if (c > 0) {
      uint2 v;
      v.x = tc::pack_bf16(carry.x, carry.y);
      v.y = tc::pack_bf16(carry.z, carry.w);
      *reinterpret_cast<uint2*>(s_in + at) = v;
    }
    const float decay = expf(totals[bh * d.nc + c]);
    carry.x = carry.x * decay + own.x;
    carry.y = carry.y * decay + own.y;
    carry.z = carry.z * decay + own.z;
    carry.w = carry.w * decay + own.w;
  }
  *reinterpret_cast<float4*>(state + bh * pn + e) = carry;
}

// W[t][s] = CB[t][s] exp(cum_t - cum_s) dt_s for the s tile at s0, in
// the accumulator's fragment layout rounded to bf16 in pairs (the A
// operand of W.x): element i at row r0 + 8 ((i >> 1) & 1), column s0 +
// 8 (i / 4) + 2 q4 + (i & 1). `masked` (the diagonal and a ragged tile)
// keeps s <= t < qv, tested before the exp.
__device__ __forceinline__ void build_w(uint32_t (&wa)[16], const float* cbt,
                                        int qp, int r0, int q4, int s0,
                                        int qv, bool masked,
                                        const float (&ct)[2],
                                        const float* cum_s,
                                        const float* dt_s) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1, t = r0 + 8 * r;
    const int s = s0 + 8 * (i / 4) + 2 * q4;
    float w[2] = {0.f, 0.f};
    if (!masked || (s <= t && t < qv)) {
      const float2 v =
          *reinterpret_cast<const float2*>(cbt + (int64_t)t * qp + s);
      const float cv[2] = {v.x, v.y};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!masked || s + e <= t)
          w[e] = cv[e] * tc::ex2((ct[r] - cum_s[s + e]) * kLog2e) *
                 dt_s[s + e];
    }
    wa[i / 2] = tc::pack_bf16(w[0], w[1]);
  }
}

// 4. y for one (b, h, chunk, 64-row t tile): exp(cum_t) C_t . S_in^T,
// then sum over s tiles <= t's of W[t][s] x_s. Each tile's W is built
// while the previous product runs.
template <int N>
__global__ void __launch_bounds__(kWG)
ssd_chunk_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ cm, const float* __restrict__ cb,
                  const bf16* __restrict__ s_in, bf16* __restrict__ y,
                  Dims d) {
  using M = TcSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ], wsum[kWG / 32];
  const uint32_t sc = tc::smem_addr(align1024(smem_raw));
  const uint32_t ss = sc + M::kTileN, sx = ss + M::kTileN;
  const int nt = (d.Q + kT - 1) / kT, qp = nt * kT;
  const int per = d.nc * d.B * d.H;
  const int tt = nt - 1 - blockIdx.x / per;   // heaviest tiles first
  const int c = blockIdx.x % per % d.nc, bh = blockIdx.x % per / d.nc;
  const int b = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int qv = d.valid(c), t0 = tt * kT;
  if (t0 >= qv) return;
  const int s_end = min(t0 + kT, qv), ns = tt + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q4 = lane % 4;
  const int r0 = t0 + warp * 16 + lane / 4;   // this thread's rows r0, +8
  const int64_t crs = (int64_t)d.G * d.N, xrs = (int64_t)d.H * kTcP;
  const bf16* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * kTcP;
  tc::load_tile<kT, N, kWG>(sc, cm + d.row(b, c * d.Q) * crs +
                                    (int64_t)g * d.N, crs, t0, qv, tid);
  if (c > 0)
    tc::load_tile<kT, N, kWG>(
        ss, s_in + ((int64_t)bh * d.nc + c) * kTcP * N, N, 0, kTcP, tid);
  tc::load_tile<kT, kTcP, kWG>(sx, xsrc, xrs, 0, qv, tid);
  tc::cp_commit();
  block_cumsum<kWG>(cum_s, dt_s, wsum, dt, d, b, h, c, s_end, d.A(h));
  float ct[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    ct[r] = r0 + 8 * r < s_end ? cum_s[r0 + 8 * r] : 0.f;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  tc::cp_wait<0>();
  tc::fence_to_async();
  __syncthreads();                 // C, S_in and x tile 0 landed
  if (ns > 1) {
    tc::load_tile<kT, kTcP, kWG>(sx + kTileBytesX, xsrc, xrs, kT, qv, tid);
    tc::cp_commit();
  }
  // the masked form's tiles: the diagonal one (j == tt) and, in a
  // ragged tile, every one
  const bool ragged = t0 + kT > qv;
  const float* cbt = cb + (((int64_t)b * d.G + g) * d.nc + c) * qp * qp;
  uint32_t wa[16];
  if (c > 0) {                     // the incoming state's term
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      tc::mma_ss<64>(acc, tc::desc_k<kT>(sc, kk), tc::desc_k<kT>(ss, kk),
                     kk > 0);
    tc::wg_commit();
  }
  build_w(wa, cbt, qp, r0, q4, 0, qv, ragged || tt == 0, ct, cum_s, dt_s);
  if (c > 0) {
    tc::wg_wait<0>();
    tc::reg_fence(acc);
    const float e[2] = {expf(ct[0]), expf(ct[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= e[(i >> 1) & 1];
  }

  for (int j = 0; j < ns; ++j) {
    const int s0 = j * kT;
    if (j > 0) {
      tc::cp_wait<0>();
      tc::fence_to_async();
      __syncthreads();             // x tile j landed; tile j - 1 consumed
      if (j + 1 < ns) {
        tc::load_tile<kT, kTcP, kWG>(sx + ((j + 1) & 1) * kTileBytesX,
                                     xsrc, xrs, s0 + kT, qv, tid);
        tc::cp_commit();
      }
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_rs<64>(acc, &wa[4 * kk],
                     tc::desc_mn<kT>(sx + (j & 1) * kTileBytesX, kk), 1);
    tc::wg_commit();
    uint32_t wn[16];               // the next tile's W, while this runs
    if (j + 1 < ns)
      build_w(wn, cbt, qp, r0, q4, s0 + kT, qv, ragged || j + 1 == tt, ct,
              cum_s, dt_s);
    tc::wg_wait<0>();
    tc::reg_fence(acc);
    tc::reg_fence(wa);
#pragma unroll
    for (int i = 0; i < 16; ++i) wa[i] = wn[i];
  }

  bf16* ydst = y + d.row(b, c * d.Q) * xrs + (int64_t)h * kTcP + 2 * q4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + 8 * r;
    if (t >= qv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ydst + t * xrs + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// Workspace and launches
// ---------------------------------------------------------------------------

constexpr int64_t kAlign = 256;

int64_t aligned(int64_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

// Scratch of one call, carved from one workspace in this order.
struct Ws {
  // CUDA-core instance: cum (B, H, S), cb (B, G, nc, Q, Q), states
  // (B, H, nc, N, P), all f32.
  // Tensor-core instance: cb (B, G, nc, Qp, Qp) f32, contrib
  // (B, H, nc, P, N) f32, totals (B, H, nc) f32, s_in (B, H, nc, P, N)
  // bf16, with Qp = Q rounded up to 64.
  int64_t bytes[4];
  int64_t total() const {
    return aligned(bytes[0]) + aligned(bytes[1]) + aligned(bytes[2]) +
           aligned(bytes[3]);
  }
  void* part(void* ws, int i) const {
    int64_t off = 0;
    for (int k = 0; k < i; ++k) off += aligned(bytes[k]);
    return static_cast<uint8_t*>(ws) + off;
  }
};

Ws workspace(int instance, int B, int S, int H, int P, int G, int N,
             int Q) {
  const int64_t nc = (S + Q - 1) / Q;
  if (instance == 1) {
    const int64_t qp = (Q + kT - 1) / kT * kT;
    return Ws{{4 * B * G * nc * qp * qp, 4LL * B * H * nc * P * N,
               4LL * B * H * nc, 2LL * B * H * nc * P * N}};
  }
  return Ws{{4LL * B * H * S, 4 * B * G * nc * Q * Q,
             4LL * B * H * nc * N * P, 0}};
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const void* bm,
                   const void* cm, void* y, float* state, const Ws& w,
                   void* ws, Dims d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  float* cum = static_cast<float*>(w.part(ws, 0));
  float* cb = static_cast<float*>(w.part(ws, 1));
  float* states = static_cast<float*>(w.part(ws, 2));
  const int nt = (d.Q + kT - 1) / kT;
  const int ntn = (d.N + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  cudaError_t err;
  ssd_cumsum<<<dim3(d.nc, d.B * d.H), kMaxQ, 0, stream>>>(dt, cum, d);
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

template <int N>
cudaError_t launch_tc(const void* x, const float* dt, const void* bm,
                      const void* cm, void* y, float* state, const Ws& w,
                      void* ws, Dims d, cudaStream_t stream) {
  using M = TcSmem<N>;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(bm);
  const bf16* ct = static_cast<const bf16*>(cm);
  float* cb = static_cast<float*>(w.part(ws, 0));
  float* contrib = static_cast<float*>(w.part(ws, 1));
  float* totals = static_cast<float*>(w.part(ws, 2));
  bf16* s_in = static_cast<bf16*>(w.part(ws, 3));
  const int nt = (d.Q + kT - 1) / kT;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_chunk_state_tc<N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  M::kState)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_scan_tc<N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  M::kScan)) != cudaSuccess)
    return err;
  ssd_chunk_cb_tc<N><<<dim3(d.nc * nt * nt, d.B * d.G), kWG, M::kCb,
                       stream>>>(bt, ct, cb, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_state_tc<N><<<dim3(d.nc, d.B * d.H), 2 * N, M::kState,
                          stream>>>(xt, dt, bt, contrib, totals, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_carry<<<dim3((d.P * d.N / 4 + kThreads - 1) / kThreads,
                         d.B * d.H), kThreads, 0, stream>>>(
      contrib, totals, s_in, state, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_tc<N><<<nt * d.nc * d.B * d.H, kWG, M::kScan, stream>>>(
      xt, dt, ct, cb, s_in, static_cast<bf16*>(y), d);
  return cudaGetLastError();
}

bool takes(int instance, int dtype, int P, int N) {
  if (instance == 0) return dtype == 0 || dtype == 1;
  return instance == 1 && dtype == 1 && P == kTcP && (N == 64 || N == 128);
}

}  // namespace

// Bytes of scratch one call needs (0 for shapes no instance takes), for
// the caller's workspace. instance: 0 = CUDA cores, 1 = tensor cores.
extern "C" int64_t ssd_scan_workspace_bytes(int instance, int B, int S,
                                            int H, int P, int G, int N,
                                            int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0)
    return 0;
  return workspace(instance, B, S, H, P, G, N, Q).total();
}

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16
// (x, b, c and y); a_dtype likewise for a_log. instance 0 runs the
// CUDA-core kernels (any width), 1 the tensor-core kernels (bf16, P 64,
// N 64 or 128, 16-byte aligned x, b and c); a shape the named instance
// does not take returns cudaErrorInvalidValue, a misaligned pointer
// cudaErrorMisalignedAddress. Every tensor contiguous. `ws` holds at
// least ssd_scan_workspace_bytes(...) bytes (ws_bytes says how many).
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the first cudaError_t of its launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt,
                            const void* a_log, const void* b, const void* c,
                            void* y, float* state, void* ws,
                            int64_t ws_bytes, int dtype, int a_dtype,
                            int instance, int B, int S, int H, int P, int G,
                            int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || H % G != 0 || B * H > 65535 || a_dtype < 0 ||
      a_dtype > 1 || !takes(instance, dtype, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Ws w = workspace(instance, B, S, H, P, G, N, Q);
  if (ws_bytes < w.total() ||
      reinterpret_cast<uintptr_t>(ws) % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, S, H, P, G, N, Q, (S + Q - 1) / Q, a_log, a_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 1) {
    const void* rows[4] = {x, b, c, y};
    for (int i = 0; i < 4; ++i)
      if (reinterpret_cast<uintptr_t>(rows[i]) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    err = N == 64 ? launch_tc<64>(x, dt, b, c, y, state, w, ws, d, s)
                  : launch_tc<128>(x, dt, b, c, y, state, w, ws, d, s);
  } else if (dtype == 0) {
    err = launch<float>(x, dt, b, c, y, state, w, ws, d, s);
  } else {
    err = launch<bf16>(x, dt, b, c, y, state, w, ws, d, s);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of a tensor-core kernel at state width N
// (64 or 128; 0 otherwise), for reports. kernel: 0 = ssd_chunk_cb_tc,
// 1 = ssd_chunk_state_tc, 2 = ssd_chunk_scan_tc.
extern "C" int ssd_scan_tc_smem(int kernel, int N) {
  if (N != 64 && N != 128) return 0;
  const int cb = N == 64 ? TcSmem<64>::kCb : TcSmem<128>::kCb;
  const int st = N == 64 ? TcSmem<64>::kState : TcSmem<128>::kState;
  const int sc = N == 64 ? TcSmem<64>::kScan : TcSmem<128>::kScan;
  return kernel == 0 ? cb : kernel == 1 ? st : kernel == 2 ? sc : 0;
}
