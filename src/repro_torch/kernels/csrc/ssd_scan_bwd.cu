// Backward of the Mamba-2 SSD chunked scan (K5b) for Hopper (sm_90a),
// hand-written CUDA C++.
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
// Two instances, picked by the wrapper from dtype and widths and named by
// `instance` (a choice of design, not a fallback):
//
// * bf16 at P 64 and N 64 or 128 (mamba2-1.3b, jamba): seven launches,
//   every product on the tensor cores (`wgmma` m64n64k16 / m64n128k16
//   from 128-byte-swizzled shared tiles, flash_tc.cuh), every sum in f32:
//     1. ssd_bwd_states_tc   per (b, h, chunk), K5's ssd_chunk_state_tc
//                            twice over (blockIdx.z): the chunk's own
//                            state sum_s B_s (x_s dt_s e^{last - cum_s})
//                            and dS_out's own term U = sum_t C_t (dy_t
//                            e^{cum_t}), [p][n] f32, B^T / C^T read as the
//                            transposed A operand; also cum_last.
//     2. ssd_bwd_carry_tc    the forward and reverse carries in f32 on the
//                            CUDA cores, four elements a thread: S_in and
//                            dS_out of every chunk written as bf16 pairs
//                            ([p][n], the K- and MN-major operand tile the
//                            products read), and per block the partial
//                            dots <dS_out, S_out> and <dS_out, S_in> from
//                            the f32 states (dlast and the carry's term
//                            of da_log).
//     3. ssd_bwd_dbx_tc      the column kernel: one warpgroup per (b,
//                            group, chunk, 64-row s tile, slice of kSlice
//                            heads); per head, the state terms (B_s .
//                            dS_out into dxdt, (x_s dt_s e^{last - cum_s})
//                            . dS_out into dB), then for every t tile at
//                            or after s's, G^T = x_s . dy_t^T over P and
//                            CB^T = B_s . C_t^T over N (both exact bf16
//                            operands, f32 accumulators), the masked decay
//                            L, the column sums of E, and dxdt += (CB L)^T
//                            dy_t, dB += W^T C_t with W = G dt_s L. dx =
//                            dxdt dt and x . dxdt leave from registers;
//                            dB sums over the slice's heads in registers
//                            and is written once per slice (f32).
//     4. ssd_bwd_dc_tc       the row kernel: one warpgroup per (b, group,
//                            chunk, 64-row t tile, slice); per head, the
//                            state terms (Y = C_t . S_in for C_t . dC_t,
//                            (dy_t e^{cum_t}) . S_in into dC), then for
//                            every s tile at or before t's, G = dy_t .
//                            x_s^T and CB = C_t . B_s^T, the row sums and
//                            the pair sum of E, and dC += W B_s.
//     5. ssd_bwd_finalize_tc per (chunk, b, h): dcum, its reverse
//                            cumulative sum dl, ddt, the chunk's da_log.
//     6. ssd_bwd_group_sum   the slices' partial dB and dC, summed in
//                            order into db, dc (bf16).
//     7. ssd_bwd_dalog       da_log over (b, chunk) in order.
//   dcum and da_log come from f32 tiles, never from the rounded products:
//   with the f32 tile E_ts = CB_ts e^{cum_t - cum_s} G_ts dt_s (masked,
//   s <= t), C_t . dC_t(intra) = sum_s E_ts (a row sum, dc kernel) and
//   xdt_s . dxdt_s(intra) = sum_t E_ts (a column sum, dbx kernel, which
//   leaves out dt_s: that sum is x_s . dxdt_s for ddt), and da_log's intra
//   term is sum E_ts (cum_t - cum_s) (dc kernel); the state terms keep
//   their term-by-term form above. Each row and column sum has one owning
//   block; the finalize adds them. No atomics: two calls give equal bits.
//   Operands: x, dy, B and C reach the tensor cores as they are. Every
//   computed operand (W, CB L, the scaled x and dy, S_in, dS_out) enters
//   its product as a bf16 pair hi + lo, hi = bf16(v), lo = bf16(v - hi),
//   two products (three where both operands are pairs: lo . lo, below
//   2^-16 of the term, is left out), so each carries ~16 bits of its f32
//   value: rounded once to bf16, W and the states put db, dc and ddt at
//   1.2-4.4x the card's elementwise limit (tests/test_torch_ssd_bwd_
//   tiles.py); split, the largest error is the outputs' own bf16 rounding.
//   Masking as the forward's: only the diagonal and ragged tiles test s
//   <= t < valid, before the exp; tiles above the diagonal are skipped.
//   G is built once per (t tile, s tile) and kernel: the column kernel
//   computes G^T = x . dy^T so that its products' A operands stay in
//   registers (K4b's split); each recomputes its CB tile (cheap at N 128).
//   Scratch: the f32 own states and U (B, H, nc, P, N), their bf16 pairs,
//   four f32 scalars per (b, position, head), and the slices' f32 dB and
//   dC partials (B, S, G, H/G/kSlice, N): 1/kSlice of the per-head
//   gradients the CUDA-core instance writes.
//   Seven launches remain of thirteen, each for a reason: the carries
//   walk the chunks in order (a pass after every chunk's state); every
//   row sum and column sum has one owning block, so the row and column
//   kernels are two; the finalize needs both; and the group and da_log
//   sums add partials of many blocks in a fixed order after them.
//   FLOPs executed at the learner's (1, 2048, 64 heads, P 64, N 128,
//   chunk 256): ~73 GFLOP against the function's 23.7 (the hi + lo pairs
//   double the weighted products, CB is recomputed per head and kernel,
//   and the states are computed apart from the forward): ~74 us at the
//   bf16 peak. ptxas at N 128 (sm_90a): ssd_bwd_dbx_tc 255 registers
//   with 204 B of spills, ssd_bwd_dc_tc 255 with 44 B, ssd_bwd_states_tc
//   91 with none; dbx and dc take 107,520 B of dynamic shared memory
//   (two blocks an SM), states 66,560 B (chip_smoke.py's phase 2 prints
//   them for both widths).
//   What bounds it on the H100: its ~54 MB of inputs and outputs take
//   ~16 us and the function's products ~24 us, so the function's bound
//   is ~24 us; this design executes ~3x the products, moves ~0.2 GB of
//   f32 and bf16 scratch, and its one warpgroup a block waits on each of
//   its products and then on its exponentials: 0.33 ms at (1, 2048) on
//   an H100 80GB HBM3 at 700 W, the column and row kernels 0.63 of it
//   (PERF.md).
//
// * float32 (any width) and bf16 at other widths (the smoke widths): the
//   first version, on the CUDA cores, unchanged:
//     * Thirteen launches, each parallel over chunks (blocks run in no
//       order on 132 SMs; the chunk carries are two short sequential
//       passes over chunks, one thread per state element).
//     * Every product is a 64 x 64 output tile per block of 256 threads,
//       each thread 4 x 4 outputs, f32 FMAs from two shared-memory panels
//       (K5's CUDA-core tiling). The masked weights are built on the fly:
//       masked to s <= t *before* the exp, since above the diagonal
//       cum_t - cum_s > 0 overflows.
//     * dC and dB recompute their G tile (dy . xdt over P) per output tile
//       in shared memory; no S x S matrix per head reaches device memory.
//     * Cross-block sums are two passes, no atomics: db/dc are written per
//       head in f32 and summed over each group's heads by a second kernel;
//       da_log's terms are written per (position, head, tile) by the dxdt
//       and dC kernels, summed per (b, h, chunk) by the finalize and over
//       (b, chunk) in a fixed order by a last one. A call's gradient is the
//       same bits from run to run.
//     * Every sum is f32; dy and the inputs are read in their type.
//
//   What bounds it on the H100. At the learner's (1, 2048, 64 heads, P 64,
//   N 128, chunk 256) bf16 the inputs and outputs are ~54 MB (~16 us at
//   3.35 TB/s) and the products ~24 GFLOP, ~24 us on the bf16 tensor
//   cores: the function's bound. This kernel also writes and reads back
//   ~67 MB of f32 chunk states and ~100 MB of other f32 scratch, and its
//   f32 FMAs run on the CUDA cores, where the products alone take ~0.35 ms
//   at the f32 peak. f32 stays off the tensor cores: TF32 would break its
//   1e-3 tolerance.
//
// Both instances' scratch lives in one workspace the caller allocates
// (`ssd_scan_bwd_workspace_bytes`, per instance), carved here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "ssd_tc.cuh"

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
// The tensor-core instance (bf16, P 64, N 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                  // threads of one warpgroup
constexpr int kTcP = 64;                  // head dim the instance takes
constexpr int kSlice = 4;                 // heads a dbx / dc block walks
constexpr int kTileX = kT * kTcP * 2;     // a 64 x 64 bf16 tile
constexpr int kCarryElems = 4 * kThreads; // state elements of a carry block
constexpr float kLog2e = 1.4426950408889634f;

template <int N> struct TcSmem {
  static constexpr int kTileN = kT * N * 2;   // a 64 x N bf16 tile
  // two stages of (B or C tile, scaled x or dy as hi and lo tiles)
  static constexpr int kState = 2 * (kTileN + 2 * kTileX) + 1024;
  // dbx: B_s, x_s, dS_out hi and lo, two stages of (dy_t, C_t);
  // dc: C_t, dy_t, S_in hi and lo, two stages of (x_s, B_s)
  static constexpr int kPair = 3 * kTileN + kTileX + 2 * (kTileX + kTileN)
                               + 1024;
};

// (a, b) as bf16 pairs hi = bf16(v), lo = bf16(v - hi), packed as a
// register operand's two values: the two products carry ~16 bits of v
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the values at row r, columns 8 j + 2 q4 and + 1 of a swizzled 64-row
// tile of 64 bf16 columns: an accumulator fragment's positions
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int r,
                                            int j, int q4) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + tc::chunk_offset<kT>(r, j) + 4 * q4));
}

// Rows [s0, s0 + 64) of one head's x (dy when `grad`), each scaled by
// dt_s e^{last - cum_s} (e^{cum_s}), as bf16 pairs into the swizzled
// 64 x 64 tiles hi and lo; rows at or past qv are zero.
template <int NT>
__device__ __forceinline__ void write_scaled_split(
    uint8_t* hi, uint8_t* lo, const bf16* src, int64_t rs, int s0, int qv,
    bool grad, float last, const float* cum_s, const float* dt_s) {
  for (int i = threadIdx.x; i < kT * kTcP / 8; i += NT) {
    const int r = i / (kTcP / 8), ch = i % (kTcP / 8), s = s0 + r;
    uint32_t h[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
    if (s < qv) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + s * rs + ch * 8);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      const float f = grad ? expf(cum_s[s])
                           : dt_s[s] * expf(last - cum_s[s]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2(__bfloat162float(v[2 * e]) * f,
               __bfloat162float(v[2 * e + 1]) * f, h[e], l[e]);
    }
    const uint32_t off = tc::chunk_offset<kT>(r, ch);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// 1. Per (b, h, chunk), [p][n] f32: blockIdx.z 0, own[c] = sum_s B_s[n]
// (x_s[p] dt_s e^{cum_last - cum_s}) and totals[c] = cum_last; 1, u[c] =
// sum_t C_t[n] (dy_t[p] e^{cum_t}) (c >= 1). N/64 warpgroups of 64 state
// rows, position tiles of 64 through two stages (ssd_scan.cu's
// ssd_chunk_state_tc, the scaled operand as a bf16 pair).
template <int N>
__global__ void __launch_bounds__(2 * N)
ssd_bwd_states_tc(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const float* __restrict__ dt, const bf16* __restrict__ bm,
                  const bf16* __restrict__ cm, float* __restrict__ own,
                  float* __restrict__ u, float* __restrict__ totals,
                  Dims d) {
  using M = TcSmem<N>;
  constexpr int NT = 2 * N;
  constexpr int kStage = M::kTileN + 2 * kTileX;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ], wsum[NT / 32];
  const bool grad = blockIdx.z == 1;
  const int c = blockIdx.x, bh = blockIdx.y;
  if (grad && c == 0) return;              // dS_out(-1): unused
  uint8_t* base = align1024(smem_raw);
  const uint32_t sbase = tc::smem_addr(base);
  const int b = bh / d.H, h = bh % d.H, g = d.group(h);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const int qv = d.valid(c), ns = (qv + kT - 1) / kT;
  const int64_t brs = (int64_t)d.G * d.N, xrs = (int64_t)d.H * kTcP;
  const bf16* lsrc = (grad ? cm : bm) + d.row(b, c * d.Q) * brs +
                     (int64_t)g * d.N;
  const bf16* rsrc = (grad ? dy : x) + d.row(b, c * d.Q) * xrs +
                     (int64_t)h * kTcP;
  tc::load_tile<kT, N, NT>(sbase, lsrc, brs, 0, qv, tid);
  tc::cp_commit();
  block_cumsum<NT>(cum_s, dt_s, wsum, dt, d, b, h, c, qv, d.A(h));
  const float last = cum_s[qv - 1];
  write_scaled_split<NT>(base + M::kTileN, base + M::kTileN + kTileX, rsrc,
                         xrs, 0, qv, grad, last, cum_s, dt_s);
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
      tc::load_tile<kT, N, NT>(sbase + nxt, lsrc, brs, (j + 1) * kT, qv,
                               tid);
      tc::cp_commit();
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_ss_mn<64>(acc, tc::desc_mn<kT>(st + wg * kT * 128, kk),
                        tc::desc_mn<kT>(st + M::kTileN, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_ss_mn<64>(acc, tc::desc_mn<kT>(st + wg * kT * 128, kk),
                        tc::desc_mn<kT>(st + M::kTileN + kTileX, kk), 1);
    tc::wg_commit();
    if (j + 1 < ns)                // next tile's operand while these run
      write_scaled_split<NT>(base + nxt + M::kTileN,
                             base + nxt + M::kTileN + kTileX, rsrc, xrs,
                             (j + 1) * kT, qv, grad, last, cum_s, dt_s);
    tc::wg_wait<0>();
    tc::reg_fence(acc);
  }
  // rows n = 64 wg + 16 warp + lane / 4 (+ 8), columns p = 8 j + 2 (lane
  // % 4) (+ 1); stored [p][n]
  float* out = (grad ? u : own) + ((int64_t)bh * d.nc + c) * kTcP * N +
               wg * kT + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(int64_t)(8 * j + 2 * (lane % 4) + (e & 1)) * N + 8 * (e >> 1)] =
          acc[4 * j + e];
  if (!grad && tid == 0) totals[(int64_t)bh * d.nc + c] = last;
}

__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, float4 v) {
  uint2 h, l;
  split2(v.x, v.y, h.x, l.x);
  split2(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// 2. The carries, four state elements a thread, kCarryElems a block,
// P N / kCarryElems blocks per (b, h), in f32. Forward: own[c] becomes
// S_out(c) = S_in(c + 1) (the last chunk's stays in registers), and S_in(c)
// (c >= 1) is written as a bf16 pair.
// Reverse: dS_out(last chunk) = dstate ((B, H, P, N) is [p][n]; zeros when
// null), dS_out(c - 1) = e^{cum_last(c)} dS_out(c) + u[c], each written
// as a bf16 pair. Per (b, h, chunk) and block, the partial dots lastp =
// <dS_out(c), S_out(c)> and kp = <dS_out(c), S_in(c)> of the f32 states.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_carry_tc(float* __restrict__ own, const float* __restrict__ u,
                 const float* __restrict__ totals,
                 const float* __restrict__ dstate, bf16* __restrict__ sin_hi,
                 bf16* __restrict__ sin_lo, bf16* __restrict__ dso_hi,
                 bf16* __restrict__ dso_lo, float* __restrict__ lastp,
                 float* __restrict__ kp, Dims d) {
  __shared__ float wsum[kWarps];
  const int pn = kTcP * d.N, nblk = gridDim.x;
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const int64_t bh = blockIdx.y;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc; ++c) {
    const int64_t at = (bh * d.nc + c) * pn + e;
    if (c > 0) store_split4(sin_hi + at, sin_lo + at, s);
    const float4 o = *reinterpret_cast<const float4*>(own + at);
    const float decay = expf(totals[bh * d.nc + c]);
    s = make_float4(s.x * decay + o.x, s.y * decay + o.y,
                    s.z * decay + o.z, s.w * decay + o.w);
    if (c + 1 < d.nc) *reinterpret_cast<float4*>(own + at) = s;
  }
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstate) {
    const float* ds = dstate + bh * pn + e;
    g = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
  float4 so = s;                           // S_out of the last chunk
  for (int c = d.nc - 1; c >= 0; --c) {
    const int64_t at = (bh * d.nc + c) * pn + e;
    store_split4(dso_hi + at, dso_lo + at, g);
    const float4 si = c > 0 ? *reinterpret_cast<const float4*>(own + at - pn)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float v = block_sum(dot4(g, so), wsum);
    const float w = block_sum(dot4(g, si), wsum);
    if (threadIdx.x == 0) {
      lastp[(bh * d.nc + c) * nblk + blockIdx.x] = v;
      kp[(bh * d.nc + c) * nblk + blockIdx.x] = w;
    }
    if (c > 0) {
      const float decay = expf(totals[bh * d.nc + c]);
      const float4 o = *reinterpret_cast<const float4*>(u + at);
      g = make_float4(g.x * decay + o.x, g.y * decay + o.y,
                      g.z * decay + o.z, g.w * decay + o.w);
    }
    so = si;                               // S_out(c - 1) = S_in(c)
  }
}

// The block's (b, group, chunk, own tile, head slice) of the dbx and dc
// kernels' grid: own tiles heaviest first (the dbx kernel's s tile 0
// and the dc kernel's last t tile walk the most tile pairs).
struct PairBlock {
  int own, c, sl, b, g, h0, h1;
  __device__ PairBlock(const Dims& d, int nsl, bool rows_last) {
    const int nt = (d.Q + kT - 1) / kT, per = d.nc * nsl;
    const int k = blockIdx.x / per;
    own = rows_last ? nt - 1 - k : k;
    c = blockIdx.x % per % d.nc;
    sl = blockIdx.x % per / d.nc;
    b = blockIdx.y / d.G;
    g = blockIdx.y % d.G;
    const int hg = d.H / d.G;
    h0 = g * hg + sl * kSlice;
    h1 = min(g * hg + hg, h0 + kSlice);
  }
};

// 3. The column kernel, one warpgroup per (b, group, chunk, 64-row s tile,
// slice of kSlice heads): per head, dxdt_s = e^{last - cum_s} B_s . dS_out
// + sum_{t>=s} (CB L)^T_st dy_t and dB_s (summed over the slice's heads)
// = (x_s dt_s e^{last - cum_s}) . dS_out^T + sum_{t>=s} W^T_st C_t, with
// G^T = x_s . dy_t^T and CB^T = B_s . C_t^T of each t tile at or after
// s's, L = e^{cum_t - cum_s}, W = G dt_s L. Writes dx = dxdt dt (bf16),
// xdx_s = x_s . dxdt_s (the column sum of CB L G plus the state term's,
// from f32 tiles), dac_s = (last - cum_s) dt_s x_s . dxdt_s(state) (da_log's
// term through xdt), and the slice's f32 dB partial dbp (B, S, G, nsl, N).
template <int N>
__global__ void __launch_bounds__(kWG, 2)
ssd_bwd_dbx_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ bm, const bf16* __restrict__ cm,
               const bf16* __restrict__ dy, const bf16* __restrict__ d_hi,
               const bf16* __restrict__ d_lo, bf16* __restrict__ dx,
               float* __restrict__ xdx, float* __restrict__ dac,
               float* __restrict__ dbp, Dims d, int nsl) {
  using M = TcSmem<N>;
  constexpr int kStage = kTileX + M::kTileN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ], wsum[kWG / 32];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sbs = tc::smem_addr(base);        // B_s
  const uint32_t sx = sbs + M::kTileN;             // x_s
  const uint32_t dhi = sx + kTileX, dlo = dhi + M::kTileN;  // dS_out
  const uint32_t sst = dlo + M::kTileN;            // stage k: dy_t, C_t
  const uint8_t* xp = base + M::kTileN;
  const PairBlock pb(d, nsl, false);
  const int c = pb.c, b = pb.b, g = pb.g;
  const int qv = d.valid(c), s0 = pb.own * kT;
  if (s0 >= qv) return;
  const int steps = (qv + kT - 1) / kT - pb.own;   // t tiles at or after
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q4 = lane % 4;
  const int r0 = s0 + warp * 16 + lane / 4;   // this thread's rows r0, +8
  const int64_t crs = (int64_t)d.G * d.N, xrs = (int64_t)d.H * kTcP;
  const int64_t crow = d.row(b, c * d.Q);
  const bf16* bg = bm + crow * crs + (int64_t)g * d.N;
  const bf16* cg = cm + crow * crs + (int64_t)g * d.N;
  tc::load_tile<kT, N, kWG>(sbs, bg, crs, s0, qv, tid);
  float acc[N / 2];                           // dB over the slice's heads
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int h = pb.h0; h < pb.h1; ++h) {
    const bf16* xh = x + crow * xrs + (int64_t)h * kTcP;
    const bf16* dyh = dy + crow * xrs + (int64_t)h * kTcP;
    const int64_t so = (((int64_t)b * d.H + h) * d.nc + c) * kTcP * N;
    __syncthreads();                 // the previous head's tiles consumed
    tc::load_tile<kT, kTcP, kWG>(sx, xh, xrs, s0, qv, tid);
    tc::load_tile<kT, N, kWG>(dhi, d_hi + so, N, 0, kTcP, tid);
    tc::load_tile<kT, N, kWG>(dlo, d_lo + so, N, 0, kTcP, tid);
    tc::load_tile<kT, kTcP, kWG>(sst, dyh, xrs, s0, qv, tid);
    tc::load_tile<kT, N, kWG>(sst + kTileX, cg, crs, s0, qv, tid);
    tc::cp_commit();
    block_cumsum<kWG>(cum_s, dt_s, wsum, dt, d, b, h, c, qv, d.A(h));
    const float last = cum_s[qv - 1];
    float cs[2], dts[2], ls[2], es[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r0 + 8 * r;
      const bool ok = s < qv;
      cs[r] = ok ? cum_s[s] : 0.f;
      dts[r] = ok ? dt_s[s] : 0.f;
      ls[r] = ok ? last - cs[r] : 0.f;
      es[r] = ok ? expf(ls[r]) : 0.f;
    }
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();                 // the head's tiles and stage 0 landed

    // the state's terms: dxdt = B_s . dS_out (rows scaled after), dB +=
    // (x_s dt_s e^{last - cum_s}) . dS_out^T
    uint32_t xa_h[16], xa_l[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float2 v = tile_pair(xp, r0 - s0 + 8 * r, i / 4, q4);
      const float f = dts[r] * es[r];
      split2(v.x * f, v.y * f, xa_h[i / 2], xa_l[i / 2]);
    }
    float dxa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      tc::mma_ss<64>(dxa, tc::desc_k<kT>(sbs, kk), tc::desc_k<kT>(dhi, kk),
                     1);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      tc::mma_ss<64>(dxa, tc::desc_k<kT>(sbs, kk), tc::desc_k<kT>(dlo, kk),
                     1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_rs<N>(acc, &xa_h[4 * kk], tc::desc_mn<kT>(dhi, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_rs<N>(acc, &xa_l[4 * kk], tc::desc_mn<kT>(dhi, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      tc::mma_rs<N>(acc, &xa_h[4 * kk], tc::desc_mn<kT>(dlo, kk), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(dxa);
    tc::reg_fence(acc);
    tc::reg_fence(xa_h);
    tc::reg_fence(xa_l);
    float xst[2] = {0.f, 0.f}, col[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float2 v = tile_pair(xp, r0 - s0 + 8 * r, i / 4, q4);
      dxa[i] *= es[r];
      dxa[i + 1] *= es[r];
      xst[r] += v.x * dxa[i] + v.y * dxa[i + 1];
    }

    // the masked form over the t tiles at or after s's
    for (int st = 0; st < steps; ++st) {
      const int t0 = s0 + st * kT;
      const uint32_t stg = sst + (st & 1) * kStage;
      if (st > 0) {
        tc::cp_wait<0>();
        tc::fence_to_async();
        __syncthreads();             // stage st landed; st - 1 consumed
      }
      if (st + 1 < steps) {
        const uint32_t nx = sst + ((st + 1) & 1) * kStage;
        tc::load_tile<kT, kTcP, kWG>(nx, dyh, xrs, t0 + kT, qv, tid);
        tc::load_tile<kT, N, kWG>(nx + kTileX, cg, crs, t0 + kT, qv, tid);
        tc::cp_commit();
      }
      float gv[32], cbv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) gv[i] = cbv[i] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTcP / 16; ++kk)
        tc::mma_ss<64>(gv, tc::desc_k<kT>(sx, kk), tc::desc_k<kT>(stg, kk),
                       kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::mma_ss<64>(cbv, tc::desc_k<kT>(sbs, kk),
                       tc::desc_k<kT>(stg + kTileX, kk), kk > 0);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::reg_fence(gv);
      tc::reg_fence(cbv);
      // rows s, columns t: the diagonal and ragged tiles test s <= t < qv
      // before the exp
      const bool masked = st == 0 || t0 + kT > qv || s0 + kT > qv;
      uint32_t ch[16], cl[16], wh[16], wl[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1, s = r0 + 8 * r;
        const int t = t0 + 8 * (i / 4) + 2 * q4;
        float cbl[2], w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cbl[e] = w[e] = 0.f;
          if (!masked || (s <= t + e && t + e < qv)) {
            const float L = tc::ex2((cum_s[t + e] - cs[r]) * kLog2e);
            cbl[e] = cbv[i + e] * L;
            col[r] += cbl[e] * gv[i + e];
            w[e] = gv[i + e] * dts[r] * L;
          }
        }
        split2(cbl[0], cbl[1], ch[i / 2], cl[i / 2]);
        split2(w[0], w[1], wh[i / 2], wl[i / 2]);
      }
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<64>(dxa, &ch[4 * kk], tc::desc_mn<kT>(stg, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<64>(dxa, &cl[4 * kk], tc::desc_mn<kT>(stg, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<N>(acc, &wh[4 * kk], tc::desc_mn<kT>(stg + kTileX, kk),
                      1);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<N>(acc, &wl[4 * kk], tc::desc_mn<kT>(stg + kTileX, kk),
                      1);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::reg_fence(dxa);
      tc::reg_fence(acc);
      tc::reg_fence(ch);
      tc::reg_fence(cl);
      tc::reg_fence(wh);
      tc::reg_fence(wl);
    }

    // the row's four lanes (q4) hold its columns
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        col[r] += __shfl_xor_sync(0xffffffffu, col[r], off);
        xst[r] += __shfl_xor_sync(0xffffffffu, xst[r], off);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r0 + 8 * r;
      if (s >= qv) continue;
      if (q4 == 0) {
        const int64_t at = (crow + s) * d.H + h;
        xdx[at] = col[r] + xst[r];
        dac[at] = ls[r] * dts[r] * xst[r];
      }
      bf16* out = dx + (crow + s) * xrs + (int64_t)h * kTcP + 2 * q4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(dxa[4 * j + 2 * r] * dts[r],
                                  dxa[4 * j + 2 * r + 1] * dts[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r0 + 8 * r;
    if (s >= qv) continue;
    float* out = dbp + (((crow + s) * d.G + g) * nsl + pb.sl) * d.N + 2 * q4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// 4. The row kernel, one warpgroup per (b, group, chunk, 64-row t tile,
// slice of kSlice heads): dC_t summed over the slice's heads =
// (dy_t e^{cum_t}) . S_in + sum_{s<=t} W_ts B_s, with G = dy_t . x_s^T and
// CB = C_t . B_s^T of each s tile at or before t's, W = G dt_s L. Per
// head, from f32 tiles: cdc_t = C_t . dC_t = the row sum of E = CB W plus
// Cstate_t = e^{cum_t} dy_t . (C_t . S_in) (Y on the tensor cores), and
// dar_t = sum_s E_ts (cum_t - cum_s) + cum_t Cstate_t (da_log's terms
// through the pairs and e^{cum_t}). Writes the slice's f32 dC partial dcp
// (B, S, G, nsl, N).
template <int N>
__global__ void __launch_bounds__(kWG, 2)
ssd_bwd_dc_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              const bf16* __restrict__ dy, const bf16* __restrict__ s_hi,
              const bf16* __restrict__ s_lo, float* __restrict__ cdc,
              float* __restrict__ dar, float* __restrict__ dcp, Dims d,
              int nsl) {
  using M = TcSmem<N>;
  constexpr int kStage = kTileX + M::kTileN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[kMaxQ], dt_s[kMaxQ], wsum[kWG / 32];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sc = tc::smem_addr(base);         // C_t
  const uint32_t sdy = sc + M::kTileN;             // dy_t
  const uint32_t shi = sdy + kTileX, slo = shi + M::kTileN;  // S_in
  const uint32_t sst = slo + M::kTileN;            // stage k: x_s, B_s
  const uint8_t* dyp = base + M::kTileN;
  const PairBlock pb(d, nsl, true);
  const int c = pb.c, b = pb.b, g = pb.g, tt = pb.own;
  const int qv = d.valid(c), t0 = tt * kT;
  if (t0 >= qv) return;
  const int s_end = min(t0 + kT, qv), ns = tt + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q4 = lane % 4;
  const int r0 = t0 + warp * 16 + lane / 4;   // this thread's rows r0, +8
  const int64_t crs = (int64_t)d.G * d.N, xrs = (int64_t)d.H * kTcP;
  const int64_t crow = d.row(b, c * d.Q);
  const bf16* bg = bm + crow * crs + (int64_t)g * d.N;
  const bf16* cg = cm + crow * crs + (int64_t)g * d.N;
  tc::load_tile<kT, N, kWG>(sc, cg, crs, t0, qv, tid);
  float acc[N / 2];                           // dC over the slice's heads
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int h = pb.h0; h < pb.h1; ++h) {
    const bf16* xh = x + crow * xrs + (int64_t)h * kTcP;
    const bf16* dyh = dy + crow * xrs + (int64_t)h * kTcP;
    __syncthreads();                 // the previous head's tiles consumed
    tc::load_tile<kT, kTcP, kWG>(sdy, dyh, xrs, t0, qv, tid);
    if (c > 0) {
      const int64_t so = (((int64_t)b * d.H + h) * d.nc + c) * kTcP * N;
      tc::load_tile<kT, N, kWG>(shi, s_hi + so, N, 0, kTcP, tid);
      tc::load_tile<kT, N, kWG>(slo, s_lo + so, N, 0, kTcP, tid);
    }
    tc::load_tile<kT, kTcP, kWG>(sst, xh, xrs, 0, qv, tid);
    tc::load_tile<kT, N, kWG>(sst + kTileX, bg, crs, 0, qv, tid);
    tc::cp_commit();
    block_cumsum<kWG>(cum_s, dt_s, wsum, dt, d, b, h, c, s_end, d.A(h));
    float ct[2], rs[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ct[r] = r0 + 8 * r < s_end ? cum_s[r0 + 8 * r] : 0.f;
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();                 // the head's tiles and stage 0 landed

    if (c > 0) {                     // the incoming state's terms
      float y[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::mma_ss<64>(y, tc::desc_k<kT>(sc, kk), tc::desc_k<kT>(shi, kk),
                       1);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::mma_ss<64>(y, tc::desc_k<kT>(sc, kk), tc::desc_k<kT>(slo, kk),
                       1);
      tc::wg_commit();
      // dy_t e^{cum_t} in the A fragment's layout, as a bf16 pair, while
      // Y runs
      float et[2], dyv[32];
      uint32_t ah[16], al[16];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        et[r] = r0 + 8 * r < s_end ? expf(ct[r]) : 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const float2 v = tile_pair(dyp, r0 - t0 + 8 * r, i / 4, q4);
        dyv[i] = v.x;
        dyv[i + 1] = v.y;
        split2(v.x * et[r], v.y * et[r], ah[i / 2], al[i / 2]);
      }
      tc::wg_wait<0>();
      tc::reg_fence(y);
#pragma unroll
      for (int i = 0; i < 32; ++i) rs[(i >> 1) & 1] += dyv[i] * y[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] *= et[r];
        pr[r] = ct[r] * rs[r];
      }
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTcP / 16; ++kk)
        tc::mma_rs<N>(acc, &ah[4 * kk], tc::desc_mn<kT>(shi, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kTcP / 16; ++kk)
        tc::mma_rs<N>(acc, &al[4 * kk], tc::desc_mn<kT>(shi, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kTcP / 16; ++kk)
        tc::mma_rs<N>(acc, &ah[4 * kk], tc::desc_mn<kT>(slo, kk), 1);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::reg_fence(acc);
      tc::reg_fence(ah);
      tc::reg_fence(al);
    }

    // the masked form over the s tiles at or before t's
    for (int j = 0; j < ns; ++j) {
      const uint32_t stg = sst + (j & 1) * kStage;
      if (j > 0) {
        tc::cp_wait<0>();
        tc::fence_to_async();
        __syncthreads();             // stage j landed; j - 1 consumed
      }
      if (j + 1 < ns) {
        const uint32_t nx = sst + ((j + 1) & 1) * kStage;
        tc::load_tile<kT, kTcP, kWG>(nx, xh, xrs, (j + 1) * kT, qv, tid);
        tc::load_tile<kT, N, kWG>(nx + kTileX, bg, crs, (j + 1) * kT, qv,
                                  tid);
        tc::cp_commit();
      }
      float gv[32], cbv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) gv[i] = cbv[i] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTcP / 16; ++kk)
        tc::mma_ss<64>(gv, tc::desc_k<kT>(sdy, kk), tc::desc_k<kT>(stg, kk),
                       kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        tc::mma_ss<64>(cbv, tc::desc_k<kT>(sc, kk),
                       tc::desc_k<kT>(stg + kTileX, kk), kk > 0);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::reg_fence(gv);
      tc::reg_fence(cbv);
      // rows t, columns s: the diagonal and ragged tiles test s <= t < qv
      // before the exp
      const bool masked = j == tt || t0 + kT > qv;
      const int s0 = j * kT;
      uint32_t wh[16], wl[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1, t = r0 + 8 * r;
        const int s = s0 + 8 * (i / 4) + 2 * q4;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          w[e] = 0.f;
          if (!masked || (s + e <= t && t < qv)) {
            const float l = ct[r] - cum_s[s + e];
            w[e] = gv[i + e] * dt_s[s + e] * tc::ex2(l * kLog2e);
            const float ev = cbv[i + e] * w[e];
            rs[r] += ev;
            pr[r] += ev * l;
          }
        }
        split2(w[0], w[1], wh[i / 2], wl[i / 2]);
      }
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<N>(acc, &wh[4 * kk], tc::desc_mn<kT>(stg + kTileX, kk),
                      1);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        tc::mma_rs<N>(acc, &wl[4 * kk], tc::desc_mn<kT>(stg + kTileX, kk),
                      1);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::reg_fence(acc);
      tc::reg_fence(wh);
      tc::reg_fence(wl);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off);
        pr[r] += __shfl_xor_sync(0xffffffffu, pr[r], off);
      }
    if (q4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r0 + 8 * r;
        if (t >= qv) continue;
        const int64_t at = (crow + t) * d.H + h;
        cdc[at] = rs[r];
        dar[at] = pr[r];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + 8 * r;
    if (t >= qv) continue;
    float* out = dcp + (((crow + t) * d.G + g) * nsl + pb.sl) * d.N + 2 * q4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// 5. Per (chunk, b * h): dcum_t = cdc_t - dt_t xdx_t (+ <dS_out, S_out>
// at the last valid position); dl its reverse cumulative sum; ddt = xdx +
// dl A; dapart = sum_t (dar + dac) + cum_last e^{cum_last} <dS_out, S_in>.
// One thread per position.
__global__ void __launch_bounds__(kMaxQ)
ssd_bwd_finalize_tc(const float* __restrict__ dt,
                    const float* __restrict__ cdc,
                    const float* __restrict__ xdx,
                    const float* __restrict__ dar,
                    const float* __restrict__ dac,
                    const float* __restrict__ lastp,
                    const float* __restrict__ kp,
                    const float* __restrict__ totals,
                    float* __restrict__ ddt, float* __restrict__ dapart,
                    Dims d, int nblk) {
  __shared__ float wsum[kWarps];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / d.H, h = bh % d.H;
  const int qv = d.valid(c);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t bc = (int64_t)bh * d.nc + c;
  float dl_last = 0.f, kt = 0.f;
  for (int k = 0; k < nblk; ++k) {
    dl_last += lastp[bc * nblk + k];
    kt += kp[bc * nblk + k];
  }
  // reverse inclusive scan: thread i takes position qv - 1 - i
  const bool ok = tid < qv;
  const int t = qv - 1 - tid;
  const int64_t at = ok ? d.row(b, c * d.Q + t) * d.H + h : 0;
  float v = 0.f, xd = 0.f, part = 0.f;
  if (ok) {
    xd = xdx[at];
    v = cdc[at] - dt[at] * xd + (tid == 0 ? dl_last : 0.f);
    part = dar[at] + dac[at];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  for (int k = 0; k < w; ++k) v += wsum[k];
  if (ok) ddt[at] = xd + v * d.A(h);      // v = dl_t
  part = block_sum(part, wsum);
  if (tid == 0) {
    const float last = totals[bc];
    dapart[bc] = part + last * expf(last) * kt;
  }
}

// ---------------------------------------------------------------------------
// Workspace and launches
// ---------------------------------------------------------------------------

constexpr int64_t kAlign = 256;
constexpr int kParts = 16;

int64_t aligned(int64_t bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// Scratch of one call, carved from one workspace in this order.
//   CUDA-core instance, all f32: cum (B, H, S), cb (B, G, nc, Q, Q), s_in
//   (B, H, nc + 1, N, P), dsout (B, H, nc, N, P), dxdt (B, S, H, P), dC
//   and dB per head (B, S, H, N) each, dlast and dapart (B, H, nc) each,
//   da_log's terms pair (B, S, H, p tiles), inter (B, S, H, n tiles) and
//   kterm (B, H, nc).
//   Tensor-core instance: own and u (B, H, nc, P, N) f32, totals (B, H,
//   nc) f32, the bf16 pairs of S_in and dS_out (B, H, nc, P, N) (hi, lo,
//   hi, lo), lastp and kp (B, H, nc, P N / kCarryElems) f32, cdc, xdx, dar
//   and dac (B, S, H) f32, the slices' dB and dC partials (B, S, G, nsl,
//   N) f32, dapart (B, H, nc) f32.
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

int slices(int H, int G) { return (H / G + kSlice - 1) / kSlice; }

Ws workspace(int instance, int B, int S, int H, int P, int G, int N,
             int Q) {
  const int64_t nc = (S + Q - 1) / Q, bh = (int64_t)B * H;
  const int64_t bs = (int64_t)B * S;
  if (instance == 1) {
    const int64_t st = bh * nc * P * N, nblk = (int64_t)P * N / kCarryElems;
    const int64_t part = bs * G * slices(H, G) * N;
    return Ws{{4 * st, 4 * st, 4 * bh * nc, 2 * st, 2 * st, 2 * st, 2 * st,
               4 * bh * nc * nblk, 4 * bh * nc * nblk, 4 * bs * H,
               4 * bs * H, 4 * bs * H, 4 * bs * H, 4 * part, 4 * part,
               4 * bh * nc}};
  }
  const int64_t ntp = (P + kT - 1) / kT, ntn = (N + kT - 1) / kT;
  return Ws{{4 * bh * S, 4LL * B * G * nc * Q * Q,
             4 * bh * (nc + 1) * N * P, 4 * bh * nc * N * P,
             4 * bs * H * P, 4 * bs * H * N, 4 * bs * H * N, 4 * bh * nc,
             4 * bh * nc, 4 * bs * H * ntp, 4 * bs * H * ntn,
             4 * bh * nc, 0, 0, 0, 0}};
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


template <int N>
cudaError_t launch_tc(const bf16* x, const float* dt, const bf16* bm,
                      const bf16* cm, const bf16* dy, const float* dstate,
                      bf16* dx, float* ddt, void* da_log, bf16* db,
                      bf16* dc, const Ws& w, void* ws, Dims d,
                      cudaStream_t stream) {
  using M = TcSmem<N>;
  float* own = w.part(ws, 0);
  float* u = w.part(ws, 1);
  float* totals = w.part(ws, 2);
  bf16* sin_hi = reinterpret_cast<bf16*>(w.part(ws, 3));
  bf16* sin_lo = reinterpret_cast<bf16*>(w.part(ws, 4));
  bf16* dso_hi = reinterpret_cast<bf16*>(w.part(ws, 5));
  bf16* dso_lo = reinterpret_cast<bf16*>(w.part(ws, 6));
  float* lastp = w.part(ws, 7);
  float* kp = w.part(ws, 8);
  float* cdc = w.part(ws, 9);
  float* xdx = w.part(ws, 10);
  float* dar = w.part(ws, 11);
  float* dac = w.part(ws, 12);
  float* dbp = w.part(ws, 13);
  float* dcp = w.part(ws, 14);
  float* dapart = w.part(ws, 15);
  const int nt = (d.Q + kT - 1) / kT, nsl = slices(d.H, d.G);
  const int nblk = kTcP * d.N / kCarryElems, bh = d.B * d.H;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_states_tc<N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  M::kState)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dbx_tc<N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  M::kPair)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dc_tc<N>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  M::kPair)) != cudaSuccess)
    return err;
#define SSD_BWD_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
  ssd_bwd_states_tc<N><<<dim3(d.nc, bh, 2), 2 * N, M::kState, stream>>>(
      x, dy, dt, bm, cm, own, u, totals, d);
  SSD_BWD_CHECK();
  ssd_bwd_carry_tc<<<dim3(nblk, bh), kThreads, 0, stream>>>(
      own, u, totals, dstate, sin_hi, sin_lo, dso_hi, dso_lo, lastp, kp, d);
  SSD_BWD_CHECK();
  const dim3 pairs(nt * d.nc * nsl, d.B * d.G);
  ssd_bwd_dbx_tc<N><<<pairs, kWG, M::kPair, stream>>>(
      x, dt, bm, cm, dy, dso_hi, dso_lo, dx, xdx, dac, dbp, d, nsl);
  SSD_BWD_CHECK();
  ssd_bwd_dc_tc<N><<<pairs, kWG, M::kPair, stream>>>(
      x, dt, bm, cm, dy, sin_hi, sin_lo, cdc, dar, dcp, d, nsl);
  SSD_BWD_CHECK();
  ssd_bwd_finalize_tc<<<dim3(d.nc, bh), kMaxQ, 0, stream>>>(
      dt, cdc, xdx, dar, dac, lastp, kp, totals, ddt, dapart, d, nblk);
  SSD_BWD_CHECK();
  Dims ds = d;                      // the slices stand in for the heads
  ds.H = d.G * nsl;
  const int64_t groups = (int64_t)d.B * d.S * d.G * d.N;
  ssd_bwd_group_sum<bf16><<<(unsigned)((groups + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(dbp, dcp, db, dc, ds);
  SSD_BWD_CHECK();
  ssd_bwd_dalog<<<(d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dapart, da_log, d);
#undef SSD_BWD_CHECK
  return cudaGetLastError();
}

bool takes(int instance, int dtype, int P, int N) {
  if (instance == 0) return dtype == 0 || dtype == 1;
  return instance == 1 && dtype == 1 && P == kTcP && (N == 64 || N == 128);
}

}  // namespace

// Bytes of scratch one call needs (0 for shapes the instance does not
// take), for the caller's workspace. instance: 0 = CUDA cores, 1 = tensor
// cores.
extern "C" int64_t ssd_scan_bwd_workspace_bytes(int instance, int B, int S,
                                                int H, int P, int G, int N,
                                                int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      H % G != 0 || instance < 0 || instance > 1 ||
      (instance == 1 && !takes(1, 1, P, N)))
    return 0;
  return workspace(instance, B, S, H, P, G, N, Q).total();
}

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16
// (x, b, c, dy, dx, db, dc); a_dtype likewise for a_log and da_log; dt,
// ddt and dstate are f32, dstate may be null (zeros). instance 0 runs the
// CUDA-core kernels (any width), 1 the tensor-core kernels (bf16, P 64,
// N 64 or 128, 16-byte aligned x, b, c, dy, dx, db and dc); a shape the
// named instance does not take returns cudaErrorInvalidValue, a
// misaligned pointer cudaErrorMisalignedAddress. Every tensor contiguous;
// Q = min(chunk, S) <= 256; H % G == 0; B * H <= 65535. `ws` holds at
// least ssd_scan_bwd_workspace_bytes(instance, ...) bytes (ws_bytes says
// how many), 256-byte aligned. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the first cudaError_t of
// its launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const float* dt,
                            const void* a_log, const void* b, const void* c,
                            const void* dy, const float* dstate, void* dx,
                            float* ddt, void* da_log, void* db, void* dc,
                            void* ws, int64_t ws_bytes, int dtype,
                            int a_dtype, int instance, int B, int S, int H,
                            int P, int G, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || Q > S || H % G != 0 || B * H > 65535 || a_dtype < 0 ||
      a_dtype > 1 || !takes(instance, dtype, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Ws w = workspace(instance, B, S, H, P, G, N, Q);
  if (ws_bytes < w.total() || reinterpret_cast<uintptr_t>(ws) % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, S, H, P, G, N, Q, (S + Q - 1) / Q, a_log, a_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 1) {
    const void* rows[7] = {x, b, c, dy, dx, db, dc};
    for (int i = 0; i < 7; ++i)
      if (reinterpret_cast<uintptr_t>(rows[i]) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const bf16* xt = static_cast<const bf16*>(x);
    const bf16* bt = static_cast<const bf16*>(b);
    const bf16* ct = static_cast<const bf16*>(c);
    const bf16* dyt = static_cast<const bf16*>(dy);
    bf16* dxt = static_cast<bf16*>(dx);
    bf16* dbt = static_cast<bf16*>(db);
    bf16* dct = static_cast<bf16*>(dc);
    err = N == 64 ? launch_tc<64>(xt, dt, bt, ct, dyt, dstate, dxt, ddt,
                                  da_log, dbt, dct, w, ws, d, s)
                  : launch_tc<128>(xt, dt, bt, ct, dyt, dstate, dxt, ddt,
                                   da_log, dbt, dct, w, ws, d, s);
  } else if (dtype == 0) {
    err = launch<float>(x, dt, b, c, dy, dstate, dx, ddt, da_log, db, dc, w,
                        ws, d, s);
  } else {
    err = launch<bf16>(x, dt, b, c, dy, dstate, dx, ddt, da_log, db, dc, w,
                       ws, d, s);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of a tensor-core kernel at state width N
// (64 or 128; 0 otherwise), for reports. kernel: 0 = ssd_bwd_states_tc,
// 1 = ssd_bwd_dbx_tc, 2 = ssd_bwd_dc_tc.
extern "C" int ssd_scan_bwd_tc_smem(int kernel, int N) {
  if (N != 64 && N != 128) return 0;
  const int st = N == 64 ? TcSmem<64>::kState : TcSmem<128>::kState;
  const int pr = N == 64 ? TcSmem<64>::kPair : TcSmem<128>::kPair;
  return kernel == 0 ? st : kernel == 1 || kernel == 2 ? pr : 0;
}
