// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (wrapped by `flash_attention_fwd`
// and kernels/ops.py:flash_attention). It computes the same function as
// the JAX model's prefill attention (models/transformer.py: repeat_kv +
// flash_attention_ref), in the port's layout:
//
//   q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> o (B, Sq, H, hd)
//   o[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/(H/KV)]) @ v[b,:,h/(H/KV)]
//   lse[b,h,i] = m + log(max(l, 1e-30))       (optional, f32, (B, H, Sq))
//
// with scale = hd^-0.5, f32 accumulation, masked scores -1e30, optional
// causal mask "key j visible to query i iff j <= i + q_offset", and the
// normaliser 1/max(l, 1e-30), as in the Pallas kernel and the jnp
// reference. The probabilities are rounded to the input type before the
// P.V product, as the reference does (`p.astype(v.dtype)`). The row
// log-sum-exp is the one `_flash_fwd_lse` returns (models/attention.py:207)
// for the backward (flash_attention_bwd.cu); a null `lse` pointer skips it,
// which is how the serving path calls the kernel.
//
// Differences from the TPU kernel, by design:
//   * GQA by index: KV head = h / (H/KV); no repeated copy of k/v.
//   * Strided inputs: (B, S, H, hd) is read through its strides (the last
//     dim must be contiguous), so the wrapper makes no transposed copies.
//   * Ragged lengths: any Sq/Sk. Ragged tiles are zero-filled and masked
//     here; the Pallas kernel asserted divisibility instead.
//   * The TPU grid walked the k-blocks in order and carried (acc, m, l)
//     in VMEM scratch between grid steps. Blocks on the H100 run in
//     parallel in no order, so one thread block owns a q-tile of one
//     (b, h) and loops over the k-tiles itself, up to the causal limit.
//
// What bounds it on the H100. At the StableLM-1.6B prefill shapes
// (H = 32, hd = 64, S = 128..512, bf16) the work is 4*S^2*hd/2 FLOP per
// head against 4*S*hd*2 bytes per head moved, about S/4 FLOP per byte:
// below the card's ~295 FLOP/byte ridge, so the least time is the bytes
// of q, k, v and o over 3.35 TB/s; at the training context (S = 4,096)
// it is ~1,000 FLOP per byte and the tensor cores' 989 TFLOP/s bound it.
//
// Two instances, chosen by dtype and head dim inside the C entry point
// (a choice of design, not a fallback):
//
// * bf16 at hd 64, 112 and 128: `flash_fwd_kernel_tc`, on the tensor cores.
//   One block of two warpgroups owns 128 query rows of one (b, h), each
//   warpgroup 64 of them, and walks the key tiles of 64 up to the causal
//   limit of its rows; tiles wholly above the diagonal are never loaded,
//   and only the diagonal tiles and the ragged tail are masked. Q goes
//   into shared memory once; K and V tiles go through a ring of two
//   stages, filled with 16-byte cp.async copies (zero-filled past Sk)
//   that overlap the current tile's products. S = Q.K^T is `wgmma`
//   m64n64k16 with both operands in shared memory (flash_tc.cuh); the
//   online softmax runs on the f32 accumulator in registers (row max and
//   sum over the four lanes of a quad), on raw scores with the scale
//   folded into one FMA before each exponential (one MUFU.EX2 each: at
//   hd 64 the exponentials, not the products, are the scarcest work);
//   P is rounded to bf16 in registers and is the register A operand of
//   O += P.V, whose B is the V tile read MN-major with the transpose bit.
//   l sums the unrounded f32 p. At hd 64 a thread holds at most 128
//   registers, so two blocks share an SM and one block's softmax runs
//   while the other's products do (faster on the card than key tiles of
//   128 at one block per SM). Causal blocks start with the longest
//   rows (highest q-tile first), so the last wave is the short tiles.
//   The wrapper requires 16-byte aligned rows (strides multiples of 8
//   elements) for the copies and raises otherwise.
//   Launch shape: block_q, the query rows of a block, is 128 (two
//   warpgroups) or 64 (one, 128 threads, two or four blocks an SM), a
//   runtime argument that kernels/autotune.py chooses (the reference's
//   tuned (block_q, block_k), autotune.py:339; block_k stays 64). A
//   warpgroup's 64 rows walk the same key tiles in the same order at
//   either block_q: a block loads the tiles up to its last row's causal
//   limit, and each warpgroup skips those past its own rows' limit
//   (`wg_end`), so the second warpgroup of a 128-row block computes
//   what a 64-row block over its rows computes, product for product, and
//   every block_q gives the same bits.
// * float32 (any hd), and bf16 at hd 16 and 32: `flash_fwd_kernel`, the
//   first version, on the CUDA cores. f32 keeps it because TF32 would
//   break the f32 tolerance (2e-5); hd 16/32 are only the smoke configs.
//   Each k/v element is staged once per q-tile in shared memory as f32;
//   a query row is split over hd/32 neighbouring threads (32 of its q and
//   accumulator values each), whose partial dot products meet in a
//   shuffle; the online-softmax rescale is paid once per 16 keys; k-tiles
//   past the causal limit are never loaded. hd 112 runs the hd-128 tile
//   (`Tile<112>`, four threads a row), its columns 112..127 zero.
//
// Later work, not here: a producer warp with TMA and `setmaxnreg`,
// overlap of one warpgroup's softmax with its own next products,
// persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // flash_attention.py:20
constexpr int kThreads = 128;        // threads per block
constexpr int kSub = 16;             // keys per online-softmax update

template <int HD> struct Tile {
  // tile width: hd 112 runs the hd-128 tiles, columns 112..127 zero
  static constexpr int kTw = HD > 64 ? 128 : HD;
  static constexpr int kDpt = kTw < 32 ? kTw : 32;    // dims per thread
  static constexpr int kTpr = kTw / kDpt;             // threads per row
  static constexpr int kBq = kThreads / kTpr;         // query rows / block
  static constexpr int kBk = kTw <= 64 ? 64 : 32;     // keys per smem tile
  static_assert(HD <= kTw && HD % 8 == 0, "bad head dim");
  static_assert(kBk % kSub == 0, "k tile must hold whole sub-chunks");
  static_assert(kTw % kDpt == 0 && 32 % kTpr == 0, "bad tile width");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int group, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int q_offset, float scale) {
  using C = Cvt<T>;
  constexpr int DPT = Tile<HD>::kDpt;
  constexpr int TPR = Tile<HD>::kTpr;
  constexpr int BQ = Tile<HD>::kBq;
  constexpr int BK = Tile<HD>::kBk;
  constexpr int TW = Tile<HD>::kTw;
  __shared__ float k_tile[BK][TW];
  __shared__ float v_tile[BK][TW];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid % TPR;               // which interleaved dim slice
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;              // GQA: kv head by index
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;

  float qr[DPT], acc[DPT];
  const T* qrow = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_ok && i * TPR + t < HD ? C::load(qrow[i * TPR + t]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys past the last valid query row of this tile are all masked
  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1 + q_offset;
    k_end = min(Sk, last_q + 1);
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                     // previous tile fully consumed
    for (int idx = tid; idx < BK * TW; idx += kThreads) {
      const int r = idx / TW, d = idx % TW;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk && d < HD) {           // ragged tail: zero, masked below
        kx = C::load(kb[(int64_t)kp * ks.s + d]);
        vx = C::load(vb[(int64_t)kp * vs.s + d]);
      }
      k_tile[r][d] = kx;
      v_tile[r][d] = vx;
    }
    __syncthreads();

    const int kn = min(BK, k_end - k0);
    for (int j0 = 0; j0 < kn; j0 += kSub) {
      float s[kSub];
      float m_loc = kNegInf;
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          dot = fmaf(qr[i], k_tile[j][i * TPR + t], dot);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kp = k0 + j;
        const bool ok = kp < Sk && (!causal || kp <= qpos);
        s[c] = ok ? dot * scale : kNegInf;
        m_loc = fmaxf(m_loc, s[c]);
      }
      const float m_new = fmaxf(m, m_loc);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        const float pr = C::round(p);    // p.astype(v.dtype)
        const int j = j0 + c;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(pr, v_tile[j][i * TPR + t], acc[i]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + (int64_t)qi * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (i * TPR + t < HD) orow[i * TPR + t] = C::store(acc[i] / denom);
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * Sq + qi] = m + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64 / 112 / 128: the tensor-core instance. Head dim 112
// (kimi-k2) runs the hd-128 tiles: columns 112..127 of every Q, K and V
// tile are zero-filled by the copies (cp.async with a source size of 0),
// so they add nothing to Q.K^T, the scale is the caller's 112^-0.5, and
// only the 112 real output columns are stored. No padded copy of q/k/v
// is made in global memory; rows there are 224 bytes, 14 chunks.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int BQ> struct TcFwd {
  // tile width: the head dim rounded up to whole 64-column blocks; hd
  // 112 runs the hd-128 tiles with columns 112..127 zero-filled
  static constexpr int kTW = (HD + 63) / 64 * 64;
  static constexpr int kBQ = BQ;                       // 64 rows a warpgroup
  static constexpr int kThreads = 2 * BQ;              // BQ / 64 warpgroups
  static constexpr int kBK = 64;                       // keys per tile
  // at most 128 registers a thread at hd 64 (two 128-row or four 64-row
  // blocks an SM), 255 at 112 / 128 (one 128-row or two 64-row blocks),
  // so one block's softmax overlaps another's products
  static constexpr int kMinBlocks = (kTW == 64 ? 2 : 1) * (128 / BQ);
  static_assert(BQ == 64 || BQ == 128, "one or two warpgroups");
  static constexpr int kQBytes = kBQ * kTW * 2;
  static constexpr int kKVBytes = kBK * kTW * 2;       // one K or V tile
  // Q, then two stages of (K, V); +1024 to align the base
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;
};

template <int HD, int BQ>
__global__ void __launch_bounds__(TcFwd<HD, BQ>::kThreads,
                                  TcFwd<HD, BQ>::kMinBlocks)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int group, int Sq,
                    int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                    int causal, int q_offset, float scale) {
  using P = TcFwd<HD, BQ>;
  constexpr int BK = P::kBK, NT = P::kThreads, TW = P::kTW;
  constexpr int NS = BK / 2, NO = TW / 2;   // accumulator floats / thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (tc::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + P::kQBytes;     // stage s: K at skv + 2 s KV

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int wq0 = q0 + wg * 64;              // this warpgroup's rows
  const int r0 = wq0 + warp * 16 + g;        // this thread's: r0, r0 + 8

  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ, Sq) + q_offset);
  const int n_tiles = (k_end + BK - 1) / BK;
  // keys a row of this warpgroup may see: < wg_end; all rows see < wg_all
  const int wg_end = wq0 >= Sq ? 0 : causal ? min(wq0 + 64, Sq) + q_offset
                                            : Sk;
  const int wg_all = causal ? wq0 + 1 + q_offset : Sk;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  tc::load_tile<BQ, TW, NT, HD>(sq, qb, qs.s, q0, Sq, tid);
  tc::load_tile<BK, TW, NT, HD>(skv, kb, ks.s, 0, Sk, tid);
  tc::load_tile<BK, TW, NT, HD>(skv + P::kKVBytes, vb, vs.s, 0, Sk, tid);
  tc::cp_commit();

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  // running max of the raw scores (m) and partial row sums (l); every
  // row sees key 0 in tile 0, so m is finite from the first tile on
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float c = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    const uint32_t sk = skv + (j & 1) * 2 * P::kKVBytes;
    const uint32_t sv = sk + P::kKVBytes;
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();                 // tile j landed; tile j - 1 consumed
    if (j + 1 < n_tiles) {           // next tile into the other stage
      const uint32_t nk = skv + ((j + 1) & 1) * 2 * P::kKVBytes;
      tc::load_tile<BK, TW, NT, HD>(nk, kb, ks.s, k0 + BK, Sk, tid);
      tc::load_tile<BK, TW, NT, HD>(nk + P::kKVBytes, vb, vs.s, k0 + BK,
                                    Sk, tid);
      tc::cp_commit();
    }
    if (k0 >= wg_end) continue;      // above this warpgroup's diagonal

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      tc::mma_ss<BK>(s, tc::desc_k<BQ>(sq + wg * 64 * 128, kk),
                     tc::desc_k<BK>(sk, kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);

    // raw scores: mask (diagonal and ragged tiles only) to -1e30, row
    // max; the scale folds into one FMA before each exponential:
    // p = exp(scale s - scale m) = 2^(c s - c m), c = scale log2(e)
    const bool masked = k0 + BK > Sk || k0 + BK > wg_all;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (masked) {
        const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        if (col >= Sk || (causal && col > row + q_offset)) s[i] = kNegInf;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], mc[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = tc::ex2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
    }
    // p summed unrounded, rounded to bf16 as P.V's A operand
    uint32_t pa[NS / 2];
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = tc::ex2(fmaf(s[i], c, -mc[r]));
      const float p1 = tc::ex2(fmaf(s[i + 1], c, -mc[r]));
      lsum[r] += p0 + p1;
      pa[i / 2] = tc::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= corr[(i >> 1) & 1];

    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      tc::mma_rs<TW>(oacc, &pa[4 * kk], tc::desc_mn<BK>(sv, kk), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(oacc);
    tc::reg_fence(pa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(oacc[i] / denom, oacc[i + 1] / denom);
    }
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * Sq + row] = m[r] * scale + logf(denom);
  }
}

template <int HD, int BQ>
cudaError_t launch_tc_shape(const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int Sq, int Sk,
                            int H, int KV, const Strides* st, int causal,
                            int q_offset, float scale, cudaStream_t stream) {
  using P = TcFwd<HD, BQ>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<HD, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel_tc<HD, BQ><<<grid, P::kThreads, P::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, H / KV,
      Sq, Sk, st[0], st[1], st[2], st[3], causal, q_offset, scale);
  return cudaGetLastError();
}

// the tensor-core instance at block_q 64 or 128
template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Sk, int H, int KV,
                      int block_q, const Strides* st, int causal,
                      int q_offset, float scale, cudaStream_t stream) {
  if (block_q == 128)
    return launch_tc_shape<HD, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, st,
                                    causal, q_offset, scale, stream);
  if (block_q == 64)
    return launch_tc_shape<HD, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, st,
                                   causal, q_offset, scale, stream);
  return cudaErrorInvalidValue;
}

// 16-byte aligned rows: what the tensor-core instance's copies need
bool rows_aligned(const void* const* ptrs, int n, const Strides* st) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0 || st[i].b % 8 ||
        st[i].s % 8 || st[i].h % 8)
      return false;
  }
  return true;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV,
                   int block_q, const Strides* st, int causal, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = Tile<HD>::kBq;
  if (block_q != BQ) return cudaErrorInvalidValue;   // its one shape
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / KV, Sq, Sk,
      st[0], st[1], st[2], st[3], causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int Sq, int Sk, int H, int KV,
                        int block_q, const Strides* st, int causal,
                        int q_offset, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, KV, block_q, st, causal, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, block_q, st, causal, q_offset, scale, stream);
    case 64:
    case 112:
    case 128:
      // bf16 at hd 64 / 112 / 128 runs the tensor-core instance instead
      if constexpr (std::is_same_v<T, float>)
        return hd == 64 ? launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, block_q, st, causal, q_offset, scale, stream)
             : hd == 112 ? launch<T, 112>(q, k, v, o, lse, B, Sq, Sk, H, KV, block_q, st, causal, q_offset, scale, stream)
                         : launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, block_q, st, causal, q_offset, scale, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// bf16 at hd 64 / 112 / 128 runs the tensor-core instance, which needs 16-byte
// aligned pointers and strides that are multiples of 8 elements
// (cudaErrorMisalignedAddress otherwise) and takes block_q 64 or 128;
// every other case runs the CUDA-core instance, whose one block_q is its
// tile's (Tile<HD>::kBq: 128 at hd 16 / 32, 64 at 64, 32 at 112 / 128).
// strides: 12 element strides, (B, S, H) of q, k, v, o in that order.
// lse: null, or (B, H, Sq) contiguous f32 for the row log-sum-exp.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int block_q, const int64_t* strides,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, lse, B, Sq, Sk, H, KV, block_q,
                             st, causal, q_offset, scale, s);
  else if (dtype == 1 && (hd == 64 || hd == 112 || hd == 128)) {
    const void* ptrs[4] = {q, k, v, o};
    if (!rows_aligned(ptrs, 4, st))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = hd == 64    ? launch_tc<64>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                      block_q, st, causal, q_offset, scale, s)
          : hd == 112 ? launch_tc<112>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                       block_q, st, causal, q_offset, scale, s)
                      : launch_tc<128>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                       block_q, st, causal, q_offset, scale, s);
  } else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, Sq, Sk, H, KV,
                                     block_q, st, causal, q_offset, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of the tensor-core instance at head dim
// `hd` (64, 112 or 128) and block_q `bq` (64 or 128); 0 otherwise, for
// reports.
extern "C" int flash_attention_fwd_tc_smem(int hd, int bq) {
  if (bq == 128)
    return hd == 64    ? TcFwd<64, 128>::kSmem
           : hd == 112 ? TcFwd<112, 128>::kSmem
           : hd == 128 ? TcFwd<128, 128>::kSmem : 0;
  if (bq == 64)
    return hd == 64    ? TcFwd<64, 64>::kSmem
           : hd == 112 ? TcFwd<112, 64>::kSmem
           : hd == 128 ? TcFwd<128, 64>::kSmem : 0;
  return 0;
}
