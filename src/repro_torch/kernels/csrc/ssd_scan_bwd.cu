// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a),
// hand-written CUDA C++ on the CUDA cores.
//
// JAX has no kernel here: it differentiates the jnp scan `_ssd_inner`
// (src/repro/models/mamba.py:91) by autodiff. This is that gradient for
// the port's K5 (ssd_scan.cu), wrapped by kernels/ssd_scan_bwd.py and
// kernels/ops.py:ssd_scan_bwd, in the model layout:
//
//   x (B, S, H, P) f32|bf16, dt (B, S, H) f32, a_log (H,) f32|bf16,
//   b/c (B, S, G, N) in x's type, dy (B, S, H, P) in x's type,
//   dstate (B, H, P, N) f32 or null (zeros)
//   -> dx (B, S, H, P), db/dc (B, S, G, N) in x's type, ddt (B, S, H) f32,
//      da_log (H,) in a_log's type
//
// The forward, per (b, h) and chunk of Q positions (cum the inclusive
// cumulative sum of dt * A within the chunk, A = -exp(a_log), xdt = x dt,
// `last` the chunk's last valid position):
//   y_t   = sum_{s<=t} (C_t . B_s) e^{cum_t - cum_s} xdt_s + e^{cum_t} C_t S_in
//   S_out = e^{cum_last} S_in + sum_s e^{cum_last - cum_s} xdt_s B_s^T
// Its gradient, chunk by chunk:
//   * S_in of every chunk, recomputed in f32 (each chunk's own state, then
//     a forward carry); nothing is saved by the forward.
//   * dS_out by a reverse carry: dS_out(last chunk) = dstate,
//     dS_out(c - 1) = e^{cum_last(c)} dS_out(c) + sum_t e^{cum_t} dy_t C_t^T.
//   * dxdt_s = sum_{t>=s} (C_t . B_s) e^{cum_t - cum_s} dy_t
//              + e^{cum_last - cum_s} dS_out B_s;  dx = dxdt dt.
//   * per head, with G_ts = dy_t . xdt_s:
//       dC_t = sum_{s<=t} G_ts e^{cum_t - cum_s} B_s + e^{cum_t} dy_t S_in
//       dB_s = sum_{t>=s} G_ts e^{cum_t - cum_s} C_t
//              + e^{cum_last - cum_s} xdt_s dS_out
//     then summed over the H/G heads of each group.
//   * the log decay: every term of y_t carries e^{cum_t}, every term of
//     S_out e^{cum_last}, and every use of xdt_s e^{-cum_s}, so
//       dcum_t = dy_t . y_t - xdt_t . dxdt_t (+ <dS_out, S_out> at `last`)
//     with dy_t . y_t = C_t . dC_t (per head, before the group sum);
//     dl = the reverse cumulative sum of dcum within the chunk;
//     ddt = x . dxdt + dl A.
//   * da_log = A sum_{b, t} dl dt = sum_{b, t} dcum_t cum_t. Taken so, the
//     sum multiplies each dcum_t's rounding by |cum_t| (~100 late in a
//     chunk of 256) while the dcum_t of a chunk sum to ~0: f32 loses ~1e-2
//     on heads whose sum cancels. So it is summed term by term instead,
//     each exponent times its own term's derivative, as autodiff does:
//       sum_{s<=t} (dy_t . xdt_s) CB_ts e^{cum_t - cum_s} (cum_t - cum_s)
//       + sum_s (cum_last - cum_s) xdt_s . (e^{cum_last - cum_s} dS_out B_s)
//       + sum_t cum_t e^{cum_t} C_t . (dy_t S_in)
//       + cum_last e^{cum_last} <dS_out, S_in>
//     where every large |cum| meets a term that carries e^{cum} with it.
//
// A ragged tail (S % Q != 0) is a short last chunk: positions >= S are
// never read and get no gradient; `last` is the last valid position, which
// equals the reference's dt = 0 padding (its padded steps are identities).
//
// Design, for a right kernel first (speed is later work):
//   * Thirteen launches, each parallel over chunks (blocks run in no
//     order on 132 SMs; the chunk carries are two short sequential
//     passes over chunks, one thread per state element).
//   * Every product is a 64 x 64 output tile per block of 256 threads,
//     each thread 4 x 4 outputs, f32 FMAs from two shared-memory panels
//     (K5's CUDA-core tiling). The masked weights are built on the fly:
//     masked to s <= t *before* the exp, since above the diagonal
//     cum_t - cum_s > 0 overflows.
//   * dC and dB recompute their G tile (dy . xdt over P) per output tile
//     in shared memory; no S x S matrix per head reaches device memory.
//   * Cross-block sums are two passes, no atomics: db/dc are written per
//     head in f32 and summed over each group's heads by a second kernel;
//     da_log's terms are written per (position, head, tile) by the dxdt
//     and dC kernels, summed per (b, h, chunk) by the finalize and over
//     (b, chunk) in a fixed order by a last one. A call's gradient is the
//     same bits from run to run.
//   * Every sum is f32; dy and the inputs are read in their type.
//
// What bounds it on the H100. At the learner's (1, 2048, 64 heads, P 64,
// N 128, chunk 256) bf16 the inputs and outputs are ~54 MB (~16 us at
// 3.35 TB/s) and the products ~24 GFLOP, ~24 us on the bf16 tensor
// cores: the function's bound. This kernel also writes and reads back
// ~67 MB of f32 chunk states and ~100 MB of other f32 scratch, and its
// f32 FMAs run on the CUDA cores, where the products alone take ~0.35 ms
// at the f32 peak. Moving them onto `wgmma` is later work.
//
// Scratch lives in one workspace the caller allocates
// (`ssd_scan_bwd_workspace_bytes`), carved here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;          // output tile edge
constexpr int kK = 32;          // depth of one shared-memory stage
constexpr int kLd = kT + 4;     // panel row stride (float4-aligned)
constexpr int kMaxQ = 256;      // largest chunk (one block scans it)
constexpr int kWarps = kThreads / 32;

// Shape of one call, and the chunk a block works on.
struct Dims {
  int B, S, H, P, G, N, Q, nc;
  const void* a_log;            // (H,) f32 or bf16
  int a_bf16;
  __device__ int64_t row(int b, int t) const { return (int64_t)b * S + t; }
  __device__ int valid(int c) const { return min(Q, S - c * Q); }
  __device__ int group(int h) const { return h / (H / G); }
  __device__ float A(int h) const {   // A = -exp(a_log[h])
    const float v = a_bf16
        ? __bfloat162float(static_cast<const bf16*>(a_log)[h])
        : static_cast<const float*>(a_log)[h];
    return -expf(v);
  }
};

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

// Stage a kK-row x kT-column panel as it lies: dst[k][col] = src(k0 + k,
// c0 + col), zero outside rows < k_end, cols < c_end.
template <typename T>
__device__ __forceinline__ void load_n(float* dst, const T* src,
                                       int64_t row_stride, int k0, int k_end,
                                       int c0, int c_end) {
  using C = Cvt<T>;
  for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
    const int k = idx / kT, col = idx % kT;
    float v = 0.f;
    if (k0 + k < k_end && c0 + col < c_end)
      v = C::load(src[(int64_t)(k0 + k) * row_stride + c0 + col]);
    dst[k * kLd + col] = v;
  }
}

// The block's sum of v (every thread of the block calls it), in a fixed
// order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();                       // wsum free for reuse
  if (lane == 0) wsum[w] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < kWarps; ++k) total += wsum[k];
  return total;
}

// 1. cum[b, h, t] = inclusive sum of dt * A over t's chunk up to t.
__global__ void __launch_bounds__(kMaxQ)
ssd_bwd_cumsum(const float* __restrict__ dt, float* __restrict__ cum,
               Dims d) {
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

// 2. cb[b, g, c, t, s] = C_t . B_s for the 64 x 64 tiles with s-tile <=
// t-tile whose rows reach the chunk's valid positions (the only ones read).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_cb(const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ cb, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  const int nt = (d.Q + kT - 1) / kT;
  const int c = blockIdx.x / (nt * nt);
  const int tt = (blockIdx.x / nt) % nt, ts = blockIdx.x % nt;
  const int qv = d.valid(c);
  if (ts > tt || tt * kT >= qv) return;
  const int b = blockIdx.y / d.G, g = blockIdx.y % d.G;
  const int64_t rs = (int64_t)d.G * d.N;
  const T* bsrc = bm + d.row(b, c * d.Q) * rs + (int64_t)g * d.N;
  const T* csrc = cm + d.row(b, c * d.Q) * rs + (int64_t)g * d.N;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < d.N; n0 += kK) {
    load_t(sa, csrc, rs, tt * kT, qv, n0, d.N);
    load_t(sb, bsrc, rs, ts * kT, qv, n0, d.N);
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = cb + (((int64_t)b * d.G + g) * d.nc + c) * d.Q * d.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tt * kT + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = ts * kT + 4 * tx + j;
      if (t < d.Q && s < d.Q) out[(int64_t)t * d.Q + s] = acc[i][j];
    }
  }
}

// 3. One chunk's own state, [n][p], per (b, h, chunk, n-tile, p-tile):
//   kGrad false: s_in[b, h, c + 1] = sum_s B_s[n] x_s[p] dt_s
//                                    e^{cum_last - cum_s}
//   kGrad true:  dsout[b, h, c - 1] = sum_t C_t[n] dy_t[p] e^{cum_t}
//                (c >= 1)
// (`lm` B or C, `rv` x or dy); the carries below fold them in.
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_state(const T* __restrict__ rv, const float* __restrict__ dt,
                    const T* __restrict__ lm, const float* __restrict__ cum,
                    float* __restrict__ out_base, Dims d) {
  using C = Cvt<T>;
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  __shared__ float scale_s[kMaxQ];
  const int ntn = (d.N + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  const int c = blockIdx.x / (ntn * ntp);
  if (kGrad && c == 0) return;             // dS_in of chunk 0: unused
  const int n0 = (blockIdx.x / ntp) % ntn * kT, p0 = blockIdx.x % ntp * kT;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H, g = d.group(h);
  const int qv = d.valid(c);
  const float* cm = cum + ((int64_t)b * d.H + h) * d.S + c * d.Q;
  const float last = cm[qv - 1];
  for (int i = threadIdx.x; i < qv; i += kThreads)
    scale_s[i] = kGrad ? expf(cm[i])
                       : dt[d.row(b, c * d.Q + i) * d.H + h] *
                             expf(last - cm[i]);
  __syncthreads();
  const int64_t rrs = (int64_t)d.H * d.P, lrs = (int64_t)d.G * d.N;
  const T* rsrc = rv + d.row(b, c * d.Q) * rrs + (int64_t)h * d.P;
  const T* lsrc = lm + d.row(b, c * d.Q) * lrs + (int64_t)g * d.N;
  float acc[4][4];
  zero(acc);
  for (int s0 = 0; s0 < qv; s0 += kK) {
    for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
      const int k = idx / kT, col = idx % kT, s = s0 + k;
      float lv = 0.f, rw = 0.f;
      if (s < qv && n0 + col < d.N)
        lv = C::load(lsrc[(int64_t)s * lrs + n0 + col]);
      if (s < qv && p0 + col < d.P)
        rw = C::load(rsrc[(int64_t)s * rrs + p0 + col]) * scale_s[s];
      sa[k * kLd + col] = lv;
      sb[k * kLd + col] = rw;
    }
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }
  const int slots = kGrad ? d.nc : d.nc + 1;
  const int slot = kGrad ? c - 1 : c + 1;
  float* out = out_base +
               (((int64_t)b * d.H + h) * slots + slot) * d.N * d.P;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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

// cum at the last valid position of chunk c of one (b, h) row of cum.
__device__ __forceinline__ float chunk_last(const float* cm, const Dims& d,
                                            int c) {
  return cm[min((c + 1) * d.Q, d.S) - 1];
}

// 4. The forward carry, one thread per (b, h, n, p): s_in[c + 1] holds
// chunk c's own state and becomes S_out(c) = S_in(c + 1); s_in[0] = 0.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(float* __restrict__ s_in, const float* __restrict__ cum,
                   Dims d) {
  const int np = d.N * d.P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= np) return;
  const int64_t bh = blockIdx.y;
  float* st = s_in + bh * (d.nc + 1) * np + e;
  const float* cm = cum + bh * d.S;
  float carry = 0.f;
  st[0] = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const int64_t at = (int64_t)(c + 1) * np;
    carry = carry * expf(chunk_last(cm, d, c)) + st[at];
    st[at] = carry;
  }
}

// 5. The reverse carry, one thread per (b, h, n, p): dsout[c] = dS_out(c),
// from dstate (B, H, P, N) (zeros when null) at the last chunk; dsout[c]
// holds U(c + 1) for c < nc - 1 on entry.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_grad_pass(float* __restrict__ dsout, const float* __restrict__ cum,
                  const float* __restrict__ dstate, Dims d) {
  const int np = d.N * d.P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= np) return;
  const int64_t bh = blockIdx.y;
  const int n = e / d.P, p = e % d.P;
  float* gs = dsout + bh * d.nc * np + e;
  const float* cm = cum + bh * d.S;
  float g = dstate ? dstate[(bh * d.P + p) * d.N + n] : 0.f;
  gs[(int64_t)(d.nc - 1) * np] = g;
  for (int c = d.nc - 2; c >= 0; --c) {
    g = g * expf(chunk_last(cm, d, c + 1)) + gs[(int64_t)c * np];
    gs[(int64_t)c * np] = g;
  }
}

// 6. dlast[b, h, c] = <dS_out(c), S_out(c)>, the derivative through
// e^{cum_last}, and the carry's term of da_log, kterm[b, h, c] =
// cum_last e^{cum_last} <dS_out(c), S_in(c)>; one block per (chunk, b * h).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_last(const float* __restrict__ dsout, const float* __restrict__ s_in,
             const float* __restrict__ cum, float* __restrict__ dlast,
             float* __restrict__ kterm, Dims d) {
  __shared__ float wsum[kWarps];
  const int c = blockIdx.x;
  const int64_t bh = blockIdx.y, np = (int64_t)d.N * d.P;
  const float* g = dsout + (bh * d.nc + c) * np;
  const float* s = s_in + (bh * (d.nc + 1) + c + 1) * np;
  float v = 0.f, u = 0.f;
  for (int64_t e = threadIdx.x; e < np; e += kThreads) {
    v += g[e] * s[e];
    u += g[e] * s[e - np];                 // S_in(c) = s_in[c]
  }
  v = block_sum(v, wsum);
  u = block_sum(u, wsum);
  if (threadIdx.x == 0) {
    const float last = chunk_last(cum + bh * d.S, d, c);
    dlast[bh * d.nc + c] = v;
    kterm[bh * d.nc + c] = last * expf(last) * u;
  }
}

// 7. dxdt (f32, B, S, H, P) for one (chunk, 64-row s tile, p tile, b, h):
// e^{cum_last - cum_s} B_s . dS_out, then sum over t >= s of
// CB[t][s] e^{cum_t - cum_s} dy_t. Beside it the same sums with each term
// times its exponent (cum_last - cum_s, cum_t - cum_s), dotted with xdt_s
// over the tile's p: pair[b, s, h, p tile], da_log's terms through xdt_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dxdt(const T* __restrict__ x, const float* __restrict__ dt,
             const T* __restrict__ dy, const T* __restrict__ bm,
             const float* __restrict__ cum, const float* __restrict__ cb,
             const float* __restrict__ dsout, float* __restrict__ dxdt,
             float* __restrict__ pair, Dims d) {
  using C = Cvt<T>;
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sw[kK * kLd];   // sa times cum_t - cum_s
  __shared__ __align__(16) float sb[kK * kLd];
  __shared__ float cum_s[kMaxQ];
  const int nt = (d.Q + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  const int c = blockIdx.x / (nt * ntp);
  const int s0 = (blockIdx.x / ntp) % nt * kT, p0 = blockIdx.x % ntp * kT;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H, g = d.group(h);
  const int qv = d.valid(c);
  if (s0 >= qv) return;
  const float* cm = cum + (int64_t)bh * d.S + c * d.Q;
  for (int i = threadIdx.x; i < qv; i += kThreads) cum_s[i] = cm[i];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4], accw[4][4];
  zero(acc);

  // the state gradient's term
  const int64_t brs = (int64_t)d.G * d.N;
  const T* bsrc = bm + d.row(b, c * d.Q) * brs + (int64_t)g * d.N;
  const float* gsrc = dsout + ((int64_t)bh * d.nc + c) * d.N * d.P;
  for (int n0 = 0; n0 < d.N; n0 += kK) {
    load_t(sa, bsrc, brs, s0, qv, n0, d.N);
    load_n(sb, gsrc, d.P, n0, d.N, p0, d.P);
    __syncthreads();
    tile_fma(sa, sb, acc);
    __syncthreads();
  }
  const float last = cum_s[qv - 1];        // cum_s visible since the loop
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    const float l = s < qv ? last - cum_s[s] : 0.f;
    const float e = s < qv ? expf(l) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] *= e;
      accw[i][j] = acc[i][j] * l;
    }
  }

  // the masked form over t >= s
  const int64_t xrs = (int64_t)d.H * d.P;
  const T* dsrc = dy + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
  const float* cbc = cb + (((int64_t)b * d.G + g) * d.nc + c) * d.Q * d.Q;
  for (int t0 = s0; t0 < qv; t0 += kK) {
    for (int idx = threadIdx.x; idx < kK * kT; idx += kThreads) {
      const int k = idx / kT, col = idx % kT, t = t0 + k, s = s0 + col;
      float w = 0.f, wl = 0.f, v = 0.f;
      if (t < qv && s <= t) {              // select: exp only where kept
        const float l = cum_s[t] - cum_s[s];
        w = cbc[(int64_t)t * d.Q + s] * expf(l);
        wl = w * l;
      }
      if (t < qv && p0 + col < d.P)
        v = C::load(dsrc[(int64_t)t * xrs + p0 + col]);
      sa[k * kLd + col] = w;
      sw[k * kLd + col] = wl;
      sb[k * kLd + col] = v;
    }
    __syncthreads();
    tile_fma(sa, sb, acc);
    tile_fma(sw, sb, accw);
    __syncthreads();
  }

  float* out = dxdt + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tx + j;
      if (s < qv && p < d.P) out[(int64_t)s * xrs + p] = acc[i][j];
    }
  }
  // xdt_s . accw_s over the tile's p: the 16 threads of a row are the
  // lanes that differ in their low four bits
  const T* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tx + j;
      if (s < qv && p < d.P)
        v += C::load(xsrc[(int64_t)s * xrs + p]) * accw[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tx == 0 && s < qv) {
      const int64_t r = d.row(b, c * d.Q + s);
      pair[(r * d.H + h) * ntp + p0 / kT] = v * dt[r * d.H + h];
    }
  }
}

// 8. One head's dC (kDB false) or dB (kDB true), f32 (B, S, H, N), for one
// (chunk, 64-row r tile, n tile, b, h); r is t for dC and s for dB:
//   dC_r = e^{cum_r} dy_r S_in       + sum_{k<=r} G[r][k] B_k
//   dB_r = e^{cum_last - cum_r} dt_r x_r dS_out + sum_{k>=r} G[r][k] C_k
// with G[r][k] = (dy_r . x_k) dt_k e^{cum_r - cum_k} (dC) or
// (x_r . dy_k) dt_r e^{cum_k - cum_r} (dB), each 64 x 64 tile of G built in
// shared memory from a product over P, masked before the exp. dC also
// writes inter[b, t, h, n tile] = cum_t C_t . (its state's term) over the
// tile's n: da_log's term through e^{cum_t} (0 in the first chunk).
template <typename T, bool kDB>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcb(const T* __restrict__ x, const float* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const T* __restrict__ dy, const float* __restrict__ cum,
            const float* __restrict__ s_in, const float* __restrict__ dsout,
            float* __restrict__ out, float* __restrict__ inter, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd];
  __shared__ __align__(16) float sb[kK * kLd];
  __shared__ __align__(16) float gs[kT * kLd];   // G tile, [k][r]
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ];
  const int nt = (d.Q + kT - 1) / kT, ntn = (d.N + kT - 1) / kT;
  const int c = blockIdx.x / (nt * ntn);
  const int rt = (blockIdx.x / ntn) % nt, r0 = rt * kT;
  const int n0 = blockIdx.x % ntn * kT;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H, g = d.group(h);
  const int qv = d.valid(c);
  if (r0 >= qv) return;
  const float* cmm = cum + (int64_t)bh * d.S + c * d.Q;
  for (int i = threadIdx.x; i < qv; i += kThreads) {
    cum_s[i] = cmm[i];
    dt_s[i] = dt[d.row(b, c * d.Q + i) * d.H + h];
  }
  __syncthreads();
  const float last = cum_s[qv - 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t xrs = (int64_t)d.H * d.P, brs = (int64_t)d.G * d.N;
  const T* xsrc = x + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
  const T* dsrc = dy + d.row(b, c * d.Q) * xrs + (int64_t)h * d.P;
  const T* lsrc = kDB ? xsrc : dsrc;       // rows r
  const T* rsrc = kDB ? dsrc : xsrc;       // columns k of G
  const T* zsrc =
      (kDB ? cm : bm) + d.row(b, c * d.Q) * brs + (int64_t)g * d.N;
  float acc[4][4];
  zero(acc);

  // the state's term (none for dC of the first chunk: S_in = 0)
  if (kDB || c > 0) {
    const float* st = kDB
        ? dsout + ((int64_t)bh * d.nc + c) * d.N * d.P
        : s_in + ((int64_t)bh * (d.nc + 1) + c) * d.N * d.P;
    for (int p0 = 0; p0 < d.P; p0 += kK) {
      load_t(sa, lsrc, xrs, r0, qv, p0, d.P);
      // sb[k][n] = st[n][p0 + k]: the state is stored [n][p]
      for (int idx = threadIdx.x; idx < kT * kK; idx += kThreads) {
        const int n = idx / kK, k = idx % kK;
        sb[k * kLd + n] = (n0 + n < d.N && p0 + k < d.P)
                              ? st[(int64_t)(n0 + n) * d.P + p0 + k]
                              : 0.f;
      }
      __syncthreads();
      tile_fma(sa, sb, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      const float f = r >= qv ? 0.f
                      : kDB   ? dt_s[r] * expf(last - cum_s[r])
                              : expf(cum_s[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= f;
    }
  }
  if (!kDB) {
    // the 16 threads of a row are the lanes that differ in their low four
    // bits
    const T* csrc = cm + d.row(b, c * d.Q) * brs + (int64_t)g * d.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (c > 0 && r < qv && n < d.N)
          v += Cvt<T>::load(csrc[(int64_t)r * brs + n]) * acc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tx == 0 && r < qv)
        inter[(d.row(b, c * d.Q + r) * d.H + h) * ntn + n0 / kT] =
            v * cum_s[r];
    }
  }

  // the masked form: k tiles at or below r's (dC), at or above (dB)
  const int nkt = (qv + kT - 1) / kT;
  const int kt0 = kDB ? rt : 0, kt1 = kDB ? nkt - 1 : rt;
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * kT;
    float gacc[4][4];
    zero(gacc);
    for (int p0 = 0; p0 < d.P; p0 += kK) {
      load_t(sa, lsrc, xrs, r0, qv, p0, d.P);
      load_t(sb, rsrc, xrs, k0, qv, p0, d.P);
      __syncthreads();
      tile_fma(sa, sb, gacc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * tx + j;
        float v = 0.f;
        if (r < qv && k < qv && (kDB ? k >= r : k <= r))
          v = gacc[i][j] *
              (kDB ? dt_s[r] * expf(cum_s[k] - cum_s[r])
                   : dt_s[k] * expf(cum_s[r] - cum_s[k]));
        gs[(4 * tx + j) * kLd + 4 * ty + i] = v;
      }
    }
    for (int half = 0; half < kT / kK; ++half) {
      const int kb = k0 + half * kK;
      load_n(sb, zsrc, brs, kb, qv, n0, d.N);
      __syncthreads();                       // gs and sb complete
      tile_fma(gs + half * kK * kLd, sb, acc);
      __syncthreads();
    }
  }

  float* dst = out + d.row(b, c * d.Q) * d.H * d.N + (int64_t)h * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (r < qv && n < d.N) dst[(int64_t)r * d.H * d.N + n] = acc[i][j];
    }
  }
}

// 9. Per (chunk, b * h): dx = dxdt dt; dcum_t = C_t . dC_t - dt_t (x_t .
// dxdt_t) (+ dlast at the last valid position); dl its reverse cumulative
// sum; ddt = x . dxdt + dl A; dapart[b, h, c] = the chunk's terms of
// da_log (pair and inter over their tiles, summed over t, + kterm). One
// warp per position for the sums over P and N, one thread per position
// for the scan.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finalize(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ cm, const float* __restrict__ dxdt,
                 const float* __restrict__ dch,
                 const float* __restrict__ dlast,
                 const float* __restrict__ pair,
                 const float* __restrict__ inter,
                 const float* __restrict__ kterm, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dapart,
                 Dims d) {
  using C = Cvt<T>;
  __shared__ float dt_s[kMaxQ], dcum_s[kMaxQ], xdx_s[kMaxQ], da_s[kMaxQ];
  __shared__ float wsum[kWarps];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / d.H, h = bh % d.H, g = d.group(h);
  const int qv = d.valid(c);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int i = tid; i < qv; i += kThreads)
    dt_s[i] = dt[d.row(b, c * d.Q + i) * d.H + h];
  __syncthreads();
  const float dl_last = dlast[(int64_t)bh * d.nc + c];
  for (int t = w; t < qv; t += kWarps) {
    const int64_t r = d.row(b, c * d.Q + t);
    const int64_t xo = (r * d.H + h) * d.P;
    float s1 = 0.f, s2 = 0.f;
    for (int p = lane; p < d.P; p += 32) {
      const float v = dxdt[xo + p];
      s1 += v * C::load(x[xo + p]);
      dx[xo + p] = C::store(v * dt_s[t]);
    }
    const int64_t co = (r * d.H + h) * d.N, go = (r * d.G + g) * d.N;
    for (int n = lane; n < d.N; n += 32)
      s2 += dch[co + n] * C::load(cm[go + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      xdx_s[t] = s1;
      dcum_s[t] = s2 - dt_s[t] * s1 + (t == qv - 1 ? dl_last : 0.f);
      const int ntp = (d.P + kT - 1) / kT, ntn = (d.N + kT - 1) / kT;
      float a = 0.f;
      for (int k = 0; k < ntp; ++k) a += pair[(r * d.H + h) * ntp + k];
      for (int k = 0; k < ntn; ++k) a += inter[(r * d.H + h) * ntn + k];
      da_s[t] = a;
    }
  }
  __syncthreads();
  // reverse inclusive scan: thread i takes position qv - 1 - i
  const bool ok = tid < qv;
  const int t = qv - 1 - tid;
  float v = ok ? dcum_s[t] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  for (int k = 0; k < w; ++k) v += wsum[k];
  float part = 0.f;
  if (ok) {                                // v = dl_t
    ddt[d.row(b, c * d.Q + t) * d.H + h] = xdx_s[t] + v * d.A(h);
    part = da_s[t];
  }
  part = block_sum(part, wsum);
  if (tid == 0)
    dapart[(int64_t)bh * d.nc + c] = part + kterm[(int64_t)bh * d.nc + c];
}

// 10. db / dc (B, S, G, N) in x's type: the per-head f32 gradients
// summed over each group's H/G heads, one thread per output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const float* __restrict__ dbh,
                  const float* __restrict__ dch, T* __restrict__ db,
                  T* __restrict__ dc, Dims d) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t total = (int64_t)d.B * d.S * d.G * d.N;
  if (e >= total) return;
  const int n = e % d.N, g = (e / d.N) % d.G;
  const int64_t bs = e / ((int64_t)d.G * d.N);
  const int hg = d.H / d.G;
  const int64_t at = (bs * d.H + (int64_t)g * hg) * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < hg; ++j) {
    sb += dbh[at + (int64_t)j * d.N];
    sc += dch[at + (int64_t)j * d.N];
  }
  db[e] = Cvt<T>::store(sb);
  dc[e] = Cvt<T>::store(sc);
}

// 11. da_log[h] = the sum over (b, chunk) of dapart, in a fixed order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dalog(const float* __restrict__ dapart, void* __restrict__ da_log,
              Dims d) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= d.H) return;
  float s = 0.f;
  for (int b = 0; b < d.B; ++b)
    for (int c = 0; c < d.nc; ++c)
      s += dapart[((int64_t)b * d.H + h) * d.nc + c];
  if (d.a_bf16)
    static_cast<bf16*>(da_log)[h] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(da_log)[h] = s;
}

// ---------------------------------------------------------------------------
// Workspace and launches
// ---------------------------------------------------------------------------

constexpr int64_t kAlign = 256;
constexpr int kParts = 12;

int64_t aligned(int64_t bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// Scratch of one call, all f32, carved from one workspace in this order:
// cum (B, H, S), cb (B, G, nc, Q, Q), s_in (B, H, nc + 1, N, P), dsout
// (B, H, nc, N, P), dxdt (B, S, H, P), dC and dB per head (B, S, H, N)
// each, dlast and dapart (B, H, nc) each, da_log's terms pair (B, S, H,
// p tiles), inter (B, S, H, n tiles) and kterm (B, H, nc).
struct Ws {
  int64_t bytes[kParts];
  int64_t total() const {
    int64_t t = 0;
    for (int i = 0; i < kParts; ++i) t += aligned(bytes[i]);
    return t;
  }
  float* part(void* ws, int i) const {
    int64_t off = 0;
    for (int k = 0; k < i; ++k) off += aligned(bytes[k]);
    return reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + off);
  }
};

Ws workspace(int B, int S, int H, int P, int G, int N, int Q) {
  const int64_t nc = (S + Q - 1) / Q, bh = (int64_t)B * H;
  const int64_t bs = (int64_t)B * S;
  const int64_t ntp = (P + kT - 1) / kT, ntn = (N + kT - 1) / kT;
  return Ws{{4 * bh * S, 4LL * B * G * nc * Q * Q,
             4 * bh * (nc + 1) * N * P, 4 * bh * nc * N * P,
             4 * bs * H * P, 4 * bs * H * N, 4 * bs * H * N, 4 * bh * nc,
             4 * bh * nc, 4 * bs * H * ntp, 4 * bs * H * ntn,
             4 * bh * nc}};
}

template <typename T>
cudaError_t launch(const void* x_, const float* dt, const void* b_,
                   const void* c_, const void* dy_, const float* dstate,
                   void* dx_, float* ddt, void* da_log, void* db_, void* dc_,
                   const Ws& w, void* ws, Dims d, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* bm = static_cast<const T*>(b_);
  const T* cm = static_cast<const T*>(c_);
  const T* dy = static_cast<const T*>(dy_);
  float* cum = w.part(ws, 0);
  float* cb = w.part(ws, 1);
  float* s_in = w.part(ws, 2);
  float* dsout = w.part(ws, 3);
  float* dxdt = w.part(ws, 4);
  float* dch = w.part(ws, 5);
  float* dbh = w.part(ws, 6);
  float* dlast = w.part(ws, 7);
  float* dapart = w.part(ws, 8);
  float* pair = w.part(ws, 9);
  float* inter = w.part(ws, 10);
  float* kterm = w.part(ws, 11);
  const int nt = (d.Q + kT - 1) / kT;
  const int ntn = (d.N + kT - 1) / kT, ntp = (d.P + kT - 1) / kT;
  const int bh = d.B * d.H;
  const dim3 carry((d.N * d.P + kThreads - 1) / kThreads, bh);
  cudaError_t err;
#define SSD_BWD_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
  ssd_bwd_cumsum<<<dim3(d.nc, bh), kMaxQ, 0, stream>>>(dt, cum, d);
  SSD_BWD_CHECK();
  ssd_bwd_chunk_cb<T><<<dim3(d.nc * nt * nt, d.B * d.G), kThreads, 0,
                        stream>>>(bm, cm, cb, d);
  SSD_BWD_CHECK();
  ssd_bwd_chunk_state<T, false><<<dim3(d.nc * ntn * ntp, bh), kThreads, 0,
                                  stream>>>(x, dt, bm, cum, s_in, d);
  SSD_BWD_CHECK();
  ssd_bwd_state_pass<<<carry, kThreads, 0, stream>>>(s_in, cum, d);
  SSD_BWD_CHECK();
  ssd_bwd_chunk_state<T, true><<<dim3(d.nc * ntn * ntp, bh), kThreads, 0,
                                 stream>>>(dy, dt, cm, cum, dsout, d);
  SSD_BWD_CHECK();
  ssd_bwd_grad_pass<<<carry, kThreads, 0, stream>>>(dsout, cum, dstate, d);
  SSD_BWD_CHECK();
  ssd_bwd_last<<<dim3(d.nc, bh), kThreads, 0, stream>>>(dsout, s_in, cum,
                                                        dlast, kterm, d);
  SSD_BWD_CHECK();
  ssd_bwd_dxdt<T><<<dim3(d.nc * nt * ntp, bh), kThreads, 0, stream>>>(
      x, dt, dy, bm, cum, cb, dsout, dxdt, pair, d);
  SSD_BWD_CHECK();
  ssd_bwd_dcb<T, false><<<dim3(d.nc * nt * ntn, bh), kThreads, 0, stream>>>(
      x, dt, bm, cm, dy, cum, s_in, dsout, dch, inter, d);
  SSD_BWD_CHECK();
  ssd_bwd_dcb<T, true><<<dim3(d.nc * nt * ntn, bh), kThreads, 0, stream>>>(
      x, dt, bm, cm, dy, cum, s_in, dsout, dbh, nullptr, d);
  SSD_BWD_CHECK();
  ssd_bwd_finalize<T><<<dim3(d.nc, bh), kThreads, 0, stream>>>(
      x, dt, cm, dxdt, dch, dlast, pair, inter, kterm,
      static_cast<T*>(dx_), ddt, dapart, d);
  SSD_BWD_CHECK();
  const int64_t groups = (int64_t)d.B * d.S * d.G * d.N;
  ssd_bwd_group_sum<T><<<(unsigned)((groups + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      dbh, dch, static_cast<T*>(db_), static_cast<T*>(dc_), d);
  SSD_BWD_CHECK();
  ssd_bwd_dalog<<<(d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dapart, da_log, d);
#undef SSD_BWD_CHECK
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch one call needs (0 for an invalid shape), for the
// caller's workspace.
extern "C" int64_t ssd_scan_bwd_workspace_bytes(int B, int S, int H, int P,
                                                int G, int N, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0)
    return 0;
  return workspace(B, S, H, P, G, N, Q).total();
}

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16
// (x, b, c, dy, dx, db, dc); a_dtype likewise for a_log and da_log; dt,
// ddt and dstate are f32, dstate may be null (zeros). Every tensor
// contiguous; Q = min(chunk, S) <= 256; H % G == 0; B * H <= 65535. `ws`
// holds at least ssd_scan_bwd_workspace_bytes(...) bytes (ws_bytes says
// how many), 256-byte aligned. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the first cudaError_t of
// its launches (0 on success); an argument it does not take returns
// cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd(const void* x, const float* dt,
                            const void* a_log, const void* b, const void* c,
                            const void* dy, const float* dstate, void* dx,
                            float* ddt, void* da_log, void* db, void* dc,
                            void* ws, int64_t ws_bytes, int dtype,
                            int a_dtype, int B, int S, int H, int P, int G,
                            int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || Q > S || H % G != 0 || B * H > 65535 || dtype < 0 ||
      dtype > 1 || a_dtype < 0 || a_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ws w = workspace(B, S, H, P, G, N, Q);
  if (ws_bytes < w.total() || reinterpret_cast<uintptr_t>(ws) % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, S, H, P, G, N, Q, (S + Q - 1) / Q, a_log, a_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(x, dt, b, c, dy, dstate, dx, ddt, da_log,
                                 db, dc, w, ws, d, s)
                 : launch<bf16>(x, dt, b, c, dy, dstate, dx, ddt, da_log, db,
                                dc, w, ws, d, s);
  return static_cast<int>(err);
}
