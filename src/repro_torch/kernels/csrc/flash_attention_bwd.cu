// Flash-attention backward (K4b) for Hopper (sm_90a), hand-written CUDA C++.
//
// The JAX package has no Pallas kernel for this: its training gradient is
// the plain-jnp custom VJP `_flash_vjp_bwd` (src/repro/models/attention.py:
// 232-291). This kernel computes the same function from the forward's
// output and row log-sum-exp (flash_attention.cu with `lse`), in the
// port's layout:
//
//   q, o, dO (B, Sq, H, hd); k, v (B, Sk, KV, hd); lse (B, H, Sq) f32
//   delta[b,h,i] = sum_d dO[b,i,h,d] * o[b,i,h,d]                   (f32)
//   P[i,j]  = exp(scale * q_i . k_j - lse_i), 0 where masked
//   dP[i,j] = dO_i . v_j
//   dS[i,j] = P[i,j] * (dP[i,j] - delta_i) * scale
//   dq_i = sum_j dS[i,j] k_j;  dk_j = sum_i dS[i,j] q_i;  dv_j = sum_i P[i,j] dO_i
//
// with scale = hd^-0.5, the causal mask "key j visible to query i iff
// j <= i + q_offset", and dq/dk/dv written in the input type. GQA by
// index: KV head = h / (H/KV), and dk/dv of a KV head sum over its group
// of query heads inside the kernel, with no repeated copy of k/v and no
// atomics: each output element is written once, so two calls on one
// input give the same bits.
//
// Both instances are two kernels launched back to back on one stream
// from one C call (one K4b launch for the wrapper's count): a dq kernel
// over (q-tile, b, h), which also computes delta and writes it to the
// scratch the dk/dv kernel over (k-tile, b, kv head) reads; the latter
// walks the query heads of its group and, for each, the q-tiles from the
// first query that can see its keys. Ragged lengths: any Sq/Sk; staged
// rows past the end are zero and masked (P = 0) and never written.
// The split recomputes Q.K^T and dO.V^T in both kernels (7 products
// where 5 would do) and buys determinism without atomics.
//
// What bounds it on the H100. At the training shape (B 2, S 512, H 32,
// hd 64, bf16, causal) the work is about 5 * 2 * S^2/2 * hd FLOP per head
// against ~8 * S * hd * 2 bytes per head, ~S/3 FLOP per byte: below the
// ~295 FLOP/byte ridge, so the least time is the bytes over 3.35 TB/s; at
// S = 4,096 the tensor cores' 989 TFLOP/s bound it.
//
// Two instances, chosen by dtype and head dim inside the C entry point
// (a choice of design, not a fallback):
//
// * bf16 at hd 64, 112 and 128: `flash_bwd_dq_tc_kernel` and
//   `flash_bwd_dkv_tc_kernel`, on the tensor cores (flash_tc.cuh). Blocks
//   of two warpgroups; the dq kernel owns 128 query rows (64 per
//   warpgroup) with Q and dO in shared memory and walks key tiles of 64
//   through a two-stage cp.async ring: S = Q.K^T and dP = dO.V^T with
//   both operands in shared memory, P = exp(S scale - lse) and dS = P
//   (dP - delta) scale in f32 registers, then dQ += dS.K with dS rounded
//   to bf16 as the register A operand and the K tile read MN-major. The
//   dk/dv kernel owns 128 keys (64 per warpgroup) with K and V in shared
//   memory and walks (head, q-tile) steps of 64 queries (32 at hd 128, to
//   hold four accumulators in registers) through the ring: S^T = K.Q^T,
//   dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T
//   rounded to bf16 as register operands. P and dS reach their products
//   in bf16 where the reference keeps f32, as FlashAttention 2 and 3 do;
//   the sums stay f32 (relative L2 ~2.6e-3 per gradient against the f32
//   plain version, limit 2e-2). Each exponential is one FMA and one
//   MUFU.EX2. Tiles above a warpgroup's diagonal are skipped, and only
//   diagonal and ragged tiles are masked. At hd 64 the dq kernel holds at
//   most 128 registers a thread (two blocks per SM; ptxas spills a few
//   bytes, and it was still faster on the card than one block). The
//   wrapper requires 16-byte aligned rows for the copies and raises
//   otherwise. Head dim 112 (kimi-k2) runs the hd-128 tiles, as the
//   forward does: the copies zero-fill columns 112..127 of every Q, dO, K
//   and V tile, so they add nothing to S or dP and their dQ/dK/dV columns
//   stay zero; delta sums the 112 real columns, the scale is the caller's
//   112^-0.5, and only the 112 real columns are stored. No padded copy is
//   made in global memory.
// * float32 (any hd), and bf16 at hd 16 and 32: `flash_bwd_dq_kernel` and
//   `flash_bwd_dkv_kernel`, the first version, every product in f32 FMAs
//   on the CUDA cores from the stored values (the f32 tolerance 2e-3 rules
//   out TF32; hd 16/32 are only the smoke configs). A query (key) row is
//   split over hd/16 neighbouring threads, 16 of its values each; k and v
//   (q and dO) are staged as f32 in shared memory; partial dot products
//   meet in shuffles. hd 112 runs the hd-128 layout (eight threads a
//   row) with columns 112..127 zero, since 112 / 16 threads would not
//   divide a warp.
//
// Later work, not here: a producer warp with TMA and `setmaxnreg`, the
// overlap of one warpgroup's exponentials with its own next products,
// persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 128;        // threads per block

template <int HD> struct BwdTile {
  // tile width: hd 112 runs the hd-128 tiles, columns 112..127 zero
  static constexpr int kTw = HD > 64 ? 128 : HD;
  static constexpr int kDpt = 16;                     // dims per thread
  static constexpr int kTpr = kTw / kDpt;             // threads per row
  static constexpr int kRows = kThreads / kTpr;       // own rows per block
  static constexpr int kStage = kTw <= 64 ? 64 : 32;  // staged rows per tile
  static_assert(HD <= kTw && HD % 8 == 0, "bad head dim");
  static_assert(kTw % kDpt == 0 && 32 % kTpr == 0, "bad tile width");
};

// dot product of a row split over TPR neighbouring lanes
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta_out, T* __restrict__ dq,
                    int H, int group, int Sq, int Sk, Strides qs, Strides ks,
                    Strides vs, Strides os, Strides dos, Strides dqs,
                    int causal, int q_offset, float scale) {
  using C = Cvt<T>;
  constexpr int DPT = BwdTile<HD>::kDpt;
  constexpr int TPR = BwdTile<HD>::kTpr;
  constexpr int ROWS = BwdTile<HD>::kRows;
  constexpr int BK = BwdTile<HD>::kStage;
  constexpr int TW = BwdTile<HD>::kTw;
  __shared__ float k_tile[BK][TW];
  __shared__ float v_tile[BK][TW];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid % TPR;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;

  float qr[DPT], dor[DPT], acc[DPT];
  float dlt = 0.f;
  {
    const T* qrow = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
    const T* orow = o + b * os.b + (int64_t)qi * os.s + h * os.h;
    const T* drow = dout + b * dos.b + (int64_t)qi * dos.s + h * dos.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * TPR + t;
      const bool ok = row_ok && d < HD;
      qr[i] = ok ? C::load(qrow[d]) : 0.f;
      dor[i] = ok ? C::load(drow[d]) : 0.f;
      dlt = fmaf(dor[i], ok ? C::load(orow[d]) : 0.f, dlt);
      acc[i] = 0.f;
    }
  }
  dlt = row_sum<TPR>(dlt);
  const int64_t lrow = ((int64_t)b * H + h) * Sq + qi;
  const float lse_i = row_ok ? lse[lrow] : 0.f;
  if (row_ok && t == 0) delta_out[lrow] = dlt;

  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + ROWS, Sq) - 1 + q_offset;
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
      if (kp < Sk && d < HD) {
        kx = C::load(kb[(int64_t)kp * ks.s + d]);
        vx = C::load(vb[(int64_t)kp * vs.s + d]);
      }
      k_tile[r][d] = kx;
      v_tile[r][d] = vx;
    }
    __syncthreads();

    const int kn = min(BK, k_end - k0);
    for (int j = 0; j < kn; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s = fmaf(qr[i], k_tile[j][i * TPR + t], s);
        dp = fmaf(dor[i], v_tile[j][i * TPR + t], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int kp = k0 + j;
      const bool ok = row_ok && kp < Sk && (!causal || kp <= qpos);
      const float p = ok ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - dlt) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(ds, k_tile[j][i * TPR + t], acc[i]);
    }
  }

  if (row_ok) {
    T* out = dq + b * dqs.b + (int64_t)qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (i * TPR + t < HD) out[i * TPR + t] = C::store(acc[i]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KV, int Sq, int Sk,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs, int causal, int q_offset,
                     float scale) {
  using C = Cvt<T>;
  constexpr int DPT = BwdTile<HD>::kDpt;
  constexpr int TPR = BwdTile<HD>::kTpr;
  constexpr int ROWS = BwdTile<HD>::kRows;
  constexpr int BQ = BwdTile<HD>::kStage;
  constexpr int TW = BwdTile<HD>::kTw;
  __shared__ float q_tile[BQ][TW];
  __shared__ float do_tile[BQ][TW];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid % TPR;
  const int b = blockIdx.y / KV;
  const int hk = blockIdx.y % KV;
  const int group = H / KV;
  const int k0 = blockIdx.x * ROWS;
  const int kj = k0 + row;
  const bool key_ok = kj < Sk;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  {
    const T* krow = k + b * ks.b + (int64_t)kj * ks.s + hk * ks.h;
    const T* vrow = v + b * vs.b + (int64_t)kj * vs.s + hk * vs.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * TPR + t;
      const bool ok = key_ok && d < HD;
      kr[i] = ok ? C::load(krow[d]) : 0.f;
      vr[i] = ok ? C::load(vrow[d]) : 0.f;
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
  }
  // the first query that can see any key of this tile
  const int q_begin = causal ? max(0, k0 - q_offset) : 0;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((int64_t)b * H + h) * Sq;
    const float* eb = delta + ((int64_t)b * H + h) * Sq;
    for (int qs0 = q_begin; qs0 < Sq; qs0 += BQ) {
      __syncthreads();                   // previous tile fully consumed
      for (int idx = tid; idx < BQ * TW; idx += kThreads) {
        const int r = idx / TW, d = idx % TW;
        const int qp = qs0 + r;
        float qx = 0.f, dx = 0.f;
        if (qp < Sq && d < HD) {
          qx = C::load(qb[(int64_t)qp * qs.s + d]);
          dx = C::load(db[(int64_t)qp * dos.s + d]);
        }
        q_tile[r][d] = qx;
        do_tile[r][d] = dx;
      }
      for (int r = tid; r < BQ; r += kThreads) {
        const int qp = qs0 + r;
        lse_tile[r] = qp < Sq ? lb[qp] : 0.f;
        delta_tile[r] = qp < Sq ? eb[qp] : 0.f;
      }
      __syncthreads();

      const int qn = min(BQ, Sq - qs0);
      for (int i = 0; i < qn; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          s = fmaf(kr[d], q_tile[i][d * TPR + t], s);
          dp = fmaf(vr[d], do_tile[i][d * TPR + t], dp);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        const bool ok = key_ok && (!causal || kj <= qs0 + i + q_offset);
        const float p = ok ? expf(s * scale - lse_tile[i]) : 0.f;
        const float ds = p * (dp - delta_tile[i]) * scale;
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          dva[d] = fmaf(p, do_tile[i][d * TPR + t], dva[d]);
          dka[d] = fmaf(ds, q_tile[i][d * TPR + t], dka[d]);
        }
      }
    }
  }

  if (key_ok) {
    T* ko = dk + b * dks.b + (int64_t)kj * dks.s + hk * dks.h;
    T* vo = dv + b * dvs.b + (int64_t)kj * dvs.s + hk * dvs.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      if (i * TPR + t >= HD) continue;
      ko[i * TPR + t] = C::store(dka[i]);
      vo[i * TPR + t] = C::store(dva[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64 / 112 / 128: the tensor-core instance
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct TcBwd {
  // tile width: the head dim rounded up to whole 64-column blocks; hd
  // 112 runs the hd-128 tiles with columns 112..127 zero-filled
  static constexpr int kTW = (HD + 63) / 64 * 64;
  static constexpr int kThreads = 256;                 // two warpgroups
  // dq kernel: 128 query rows (64 per warpgroup), key tiles of 64
  static constexpr int kBQ = 128, kBK = 64;
  static constexpr int kQBytes = kBQ * kTW * 2, kKBytes = kBK * kTW * 2;
  // Q, dO, two stages of (K, V), lse and delta of the rows
  static constexpr int kDqSmem = 2 * kQBytes + 4 * kKBytes + 2 * kBQ * 4
                                 + 1024;
  // at hd 64 two dq blocks share an SM (<= 128 registers a thread)
  static constexpr int kDqMinBlocks = kTW == 64 ? 2 : 1;
  // dk/dv kernel: 128 keys (64 per warpgroup), query tiles of 64 (32 at
  // hd 112 / 128, for registers)
  static constexpr int kBKV = 128, kBQT = kTW == 64 ? 64 : 32;
  static constexpr int kKVBytes = kBKV * kTW * 2, kQTBytes = kBQT * kTW * 2;
  // K, V, two stages of (Q, dO), then two stages of (lse, delta)
  static constexpr int kDkvSmem = 2 * kKVBytes + 4 * kQTBytes
                                  + 4 * kBQT * 4 + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw,
                                                 uint32_t* addr) {
  const uint32_t a = tc::smem_addr(raw);
  *addr = (a + 1023) & ~1023u;
  return raw + (*addr - a);
}

template <int HD>
__global__ void __launch_bounds__(256, TcBwd<HD>::kDqMinBlocks)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta_out, bf16* __restrict__ dq,
                       int H, int group, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, Strides os, Strides dos,
                       Strides dqs, int causal, int q_offset, float scale) {
  using P = TcBwd<HD>;
  constexpr int BQ = P::kBQ, BK = P::kBK, NT = P::kThreads, TW = P::kTW;
  constexpr int NS = BK / 2, NO = TW / 2;   // accumulator floats / thread
  extern __shared__ uint8_t smem_raw[];
  uint32_t sq;
  uint8_t* base = aligned_smem(smem_raw, &sq);
  const uint32_t sdo = sq + P::kQBytes;
  const uint32_t skv = sdo + P::kQBytes;    // stage s: K at skv + 2 s K
  float* s_lse = reinterpret_cast<float*>(base + 2 * P::kQBytes +
                                          4 * P::kKBytes);
  float* s_delta = s_lse + BQ;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int wq0 = q0 + wg * 64;
  const int r0 = wq0 + warp * 16 + g;       // this thread's: r0, r0 + 8

  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ, Sq) + q_offset);
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wg_end = wq0 >= Sq ? 0 : causal ? min(wq0 + 64, Sq) + q_offset
                                            : Sk;
  const int wg_all = causal ? wq0 + 1 + q_offset : Sk;

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  tc::load_tile<BQ, TW, NT, HD>(sq, q + b * qs.b + h * qs.h, qs.s, q0, Sq,
                                tid);
  tc::load_tile<BQ, TW, NT, HD>(sdo, dout + b * dos.b + h * dos.h, dos.s,
                                q0, Sq, tid);
  tc::load_tile<BK, TW, NT, HD>(skv, kb, ks.s, 0, Sk, tid);
  tc::load_tile<BK, TW, NT, HD>(skv + P::kKBytes, vb, vs.s, 0, Sk, tid);
  tc::cp_commit();

  // delta = rowsum(dO * O) in f32, two threads per row; written for the
  // dk/dv kernel too
  const int64_t lrow0 = ((int64_t)b * H + h) * Sq;
  {
    const int rl = tid / 2, half = tid % 2, row = q0 + rl;
    float d = 0.f;
    if (row < Sq) {
      const bf16* orow = o + b * os.b + (int64_t)row * os.s + h * os.h;
      const bf16* drow = dout + b * dos.b + (int64_t)row * dos.s +
                         h * dos.h;
#pragma unroll
      for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          d = fmaf(df.x, of.x, d);
          d = fmaf(df.y, of.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      s_delta[rl] = d;
      s_lse[rl] = row < Sq ? lse[lrow0 + row] : 0.f;
      if (row < Sq) delta_out[lrow0 + row] = d;
    }
  }
  __syncthreads();
  // P = exp(scale s - lse) = 2^(c s - lse log2(e)), c = scale log2(e)
  const float c = scale * kLog2e;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = s_lse[r0 - q0 + 8 * r] * kLog2e;
    dl_r[r] = s_delta[r0 - q0 + 8 * r];
  }

  float dqacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqacc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    const uint32_t sk = skv + (j & 1) * 2 * P::kKBytes;
    const uint32_t sv = sk + P::kKBytes;
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();                 // tile j landed; tile j - 1 consumed
    if (j + 1 < n_tiles) {
      const uint32_t nk = skv + ((j + 1) & 1) * 2 * P::kKBytes;
      tc::load_tile<BK, TW, NT, HD>(nk, kb, ks.s, k0 + BK, Sk, tid);
      tc::load_tile<BK, TW, NT, HD>(nk + P::kKBytes, vb, vs.s, k0 + BK, Sk,
                                    tid);
      tc::cp_commit();
    }
    if (k0 >= wg_end) continue;      // above this warpgroup's diagonal

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      tc::mma_ss<BK>(s, tc::desc_k<BQ>(sq + wg * 64 * 128, kk),
                     tc::desc_k<BK>(sk, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      tc::mma_ss<BK>(dp, tc::desc_k<BQ>(sdo + wg * 64 * 128, kk),
                     tc::desc_k<BK>(sv, kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);
    tc::reg_fence(dp);

    // P = exp(s * scale - lse), 0 where masked; dS = P (dP - delta) scale,
    // rounded to bf16 as dS.K's A
    const bool masked = k0 + BK > Sk || k0 + BK > wg_all;
    uint32_t dsa[NS / 2];
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = tc::ex2(fmaf(s[i + e], c, -lse_r[r]));
        if (masked) {
          const int col = k0 + (i / 4) * 8 + 2 * t + e;
          if (col >= Sk || (causal && col > r0 + 8 * r + q_offset)) p = 0.f;
        }
        ds[e] = p * (dp[i + e] - dl_r[r]) * scale;
      }
      dsa[i / 2] = tc::pack_bf16(ds[0], ds[1]);
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      tc::mma_rs<TW>(dqacc, &dsa[4 * kk], tc::desc_mn<BK>(sk, kk), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(dqacc);
    tc::reg_fence(dsa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + b * dqs.b + (int64_t)row * dqs.s + h * dqs.h;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(dqacc[i], dqacc[i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int H, int KV, int Sq, int Sk, Strides qs,
                        Strides ks, Strides vs, Strides dos, Strides dks,
                        Strides dvs, int causal, int q_offset, float scale) {
  using P = TcBwd<HD>;
  constexpr int BKV = P::kBKV, BQT = P::kBQT, NT = P::kThreads;
  constexpr int TW = P::kTW;
  constexpr int NS = BQT / 2, NO = TW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint32_t sk;
  uint8_t* base = aligned_smem(smem_raw, &sk);
  const uint32_t sv = sk + P::kKVBytes;
  const uint32_t sst = sv + P::kKVBytes;    // stage s: Q, dO at sst + 2 s QT
  const int f_off = 2 * P::kKVBytes + 4 * P::kQTBytes;
  const uint32_t sf = sk + f_off;           // stage s: lse, delta
  const float* f_base = reinterpret_cast<const float*>(base + f_off);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int group = H / KV;
  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / KV, hk = blockIdx.y % KV;
  const int wk0 = k0 + wg * 64;             // this warpgroup's keys
  const int kr0 = wk0 + warp * 16 + g;      // this thread's: kr0, kr0 + 8

  // the first query that can see any key of this block
  const int q_begin = causal ? max(0, k0 - q_offset) : 0;
  const int nqt = q_begin < Sq ? (Sq - q_begin + BQT - 1) / BQT : 0;
  const int total = group * nqt;            // (head, q-tile) steps

  auto load_stage = [&](int it) {
    const int hh = hk * group + it / nqt;
    const int qs0 = q_begin + (it % nqt) * BQT;
    const uint32_t st = sst + (it & 1) * 2 * P::kQTBytes;
    tc::load_tile<BQT, TW, NT, HD>(st, q + b * qs.b + hh * qs.h, qs.s, qs0,
                                   Sq, tid);
    tc::load_tile<BQT, TW, NT, HD>(st + P::kQTBytes, dout + b * dos.b +
                                   hh * dos.h, dos.s, qs0, Sq, tid);
    const int64_t lrow = ((int64_t)b * H + hh) * Sq;
    const uint32_t fs = sf + (it & 1) * 2 * BQT * 4;
    tc::load_row_f32<BQT, NT>(fs, lse + lrow, qs0, Sq, tid);
    tc::load_row_f32<BQT, NT>(fs + BQT * 4, delta + lrow, qs0, Sq, tid);
  };

  tc::load_tile<BKV, TW, NT, HD>(sk, k + b * ks.b + hk * ks.h, ks.s, k0, Sk,
                                 tid);
  tc::load_tile<BKV, TW, NT, HD>(sv, v + b * vs.b + hk * vs.h, vs.s, k0, Sk,
                                 tid);
  if (total > 0) load_stage(0);
  tc::cp_commit();

  float dkacc[NO], dvacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dkacc[i] = dvacc[i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int qs0 = q_begin + (it % nqt) * BQT;
    const uint32_t sq = sst + (it & 1) * 2 * P::kQTBytes;
    const uint32_t sdo = sq + P::kQTBytes;
    const float* fl = f_base + (it & 1) * 2 * BQT;   // lse; delta after
    tc::cp_wait<0>();
    tc::fence_to_async();
    __syncthreads();                 // stage it landed; it - 1 consumed
    if (it + 1 < total) {
      load_stage(it + 1);
      tc::cp_commit();
    }
    // no query of the tile sees a key of this warpgroup, or no key
    if (wk0 >= Sk || (causal && qs0 + BQT - 1 + q_offset < wk0)) continue;

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      tc::mma_ss<BQT>(s, tc::desc_k<BKV>(sk + wg * 64 * 128, kk),
                      tc::desc_k<BQT>(sq, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      tc::mma_ss<BQT>(dp, tc::desc_k<BKV>(sv + wg * 64 * 128, kk),
                      tc::desc_k<BQT>(sdo, kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);
    tc::reg_fence(dp);

    // rows are keys, columns queries: P^T and dS^T, rounded to bf16 as
    // the A operands of dV += P^T.dO and dK += dS^T.Q
    const bool masked = qs0 + BQT > Sq || wk0 + 64 > Sk ||
                        (causal && wk0 + 63 > qs0 + q_offset);
    const float cs = scale * kLog2e;       // P = 2^(cs s - lse log2(e))
    uint32_t pa[NS / 2], dsa[NS / 2];
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i >> 1) & 1;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (i / 4) * 8 + 2 * t + e;
        p[e] = tc::ex2(fmaf(s[i + e], cs, -fl[c] * kLog2e));
        if (masked) {
          const int qi = qs0 + c, kj = kr0 + 8 * r;
          if (qi >= Sq || kj >= Sk || (causal && kj > qi + q_offset))
            p[e] = 0.f;
        }
        ds[e] = p[e] * (dp[i + e] - fl[BQT + c]) * scale;
      }
      pa[i / 2] = tc::pack_bf16(p[0], p[1]);
      dsa[i / 2] = tc::pack_bf16(ds[0], ds[1]);
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      tc::mma_rs<TW>(dvacc, &pa[4 * kk], tc::desc_mn<BQT>(sdo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      tc::mma_rs<TW>(dkacc, &dsa[4 * kk], tc::desc_mn<BQT>(sq, kk), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(dvacc);
    tc::reg_fence(dkacc);
    tc::reg_fence(pa);
    tc::reg_fence(dsa);
  }
  tc::cp_wait<0>();                  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr0 + 8 * r;
    if (row >= Sk) continue;
    bf16* ko = dk + b * dks.b + (int64_t)row * dks.s + hk * dks.h;
    bf16* vo = dv + b * dvs.b + (int64_t)row * dvs.s + hk * dvs.h;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(ko + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(dkacc[i], dkacc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vo + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(dvacc[i], dvacc[i + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV;
  const Strides* st;     // q, k, v, o, dout, dq, dk, dv
  int causal, q_offset;
  float scale;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int ROWS = BwdTile<HD>::kRows;
  const Strides* st = a.st;
  const dim3 grid_q((a.Sq + ROWS - 1) / ROWS, a.B * a.H);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.H, a.H / a.KV, a.Sq, a.Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], a.causal, a.q_offset, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.Sk + ROWS - 1) / ROWS, a.B * a.KV);
  flash_bwd_dkv_kernel<T, HD><<<grid_k, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KV,
      a.Sq, a.Sk, st[0], st[1], st[2], st[4], st[6], st[7], a.causal,
      a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using P = TcBwd<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kDkvSmem);
  if (err != cudaSuccess) return err;
  const Strides* st = a.st;
  const dim3 grid_q((a.Sq + P::kBQ - 1) / P::kBQ, a.B * a.H);
  flash_bwd_dq_tc_kernel<HD><<<grid_q, P::kThreads, P::kDqSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.H, a.H / a.KV, a.Sq, a.Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], a.causal, a.q_offset, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.Sk + P::kBKV - 1) / P::kBKV, a.B * a.KV);
  flash_bwd_dkv_tc_kernel<HD><<<grid_k, P::kThreads, P::kDkvSmem,
                                stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.H, a.KV, a.Sq, a.Sk, st[0], st[1], st[2], st[4], st[6], st[7],
      a.causal, a.q_offset, a.scale);
  return cudaGetLastError();
}

// 16-byte aligned rows: what the tensor-core instance's copies need
bool rows_aligned(const Args& a) {
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0 || a.st[i].b % 8 ||
        a.st[i].s % 8 || a.st[i].h % 8)
      return false;
  }
  return true;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64:
    case 112:
    case 128:
      // bf16 at hd 64 / 112 / 128 runs the tensor-core instance instead
      if constexpr (std::is_same_v<T, float>)
        return hd == 64    ? launch<T, 64>(a, stream)
             : hd == 112 ? launch<T, 112>(a, stream)
                         : launch<T, 128>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16
// (q, k, v, o, dout, dq, dk, dv all of it). lse and delta: (B, H, Sq)
// contiguous f32; delta is scratch that this call fills. strides: 24
// element strides, (B, S, H) of q, k, v, o, dout, dq, dk, dv in that order.
// Launches two kernels on `stream`, does not synchronise, allocates
// nothing, and returns the first failing cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int dtype, int B, int Sq,
                                   int Sk, int H, int KV, int hd,
                                   const int64_t* strides, int causal,
                                   int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv,
               B, Sq, Sk, H, KV, st, causal, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_hd<float>(hd, a, s));
  if (dtype == 1 && (hd == 64 || hd == 112 || hd == 128)) {
    if (!rows_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(hd == 64    ? launch_tc<64>(a, s)
                            : hd == 112 ? launch_tc<112>(a, s)
                                        : launch_tc<128>(a, s));
  }
  if (dtype == 1)
    return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) of the tensor-core instance's dq
// (kernel 0) or dk/dv (kernel 1) kernel at head dim `hd` (64, 112 or 128;
// 0 otherwise), for reports.
extern "C" int flash_attention_bwd_tc_smem(int hd, int kernel) {
  if (hd == 64) return kernel == 0 ? TcBwd<64>::kDqSmem : TcBwd<64>::kDkvSmem;
  if (hd == 112)
    return kernel == 0 ? TcBwd<112>::kDqSmem : TcBwd<112>::kDkvSmem;
  if (hd == 128)
    return kernel == 0 ? TcBwd<128>::kDqSmem : TcBwd<128>::kDkvSmem;
  return 0;
}
