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
// of q, k, v and o over 3.35 TB/s. This first version does its
// arithmetic in f32 FMAs on the CUDA cores (no tensor cores, no wgmma),
// so in practice it is bound by those FMAs and by shared-memory reads,
// not by device memory. What the design does about it:
//   * every k/v element is read from device memory once per q-tile and
//     staged, converted to f32, in shared memory; the reads are coalesced
//     along hd;
//   * a query row is split over hd/32 neighbouring threads, each holding
//     32 of its q and accumulator values in registers, so registers stay
//     well under the limit for hd = 128; a thread owns every (hd/32)-th
//     dimension, so a warp reads consecutive shared-memory words with no
//     bank conflicts, and the partial dot products meet in a shuffle;
//   * the online-softmax rescale (one expf per row) is paid once per 16
//     keys, not once per key;
//   * k-tiles past the causal limit of the q-tile are never loaded.
// Moving the products onto the tensor cores (wgmma with TMA-fed tiles and
// a warp-specialised pipeline) is the next step and is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // flash_attention.py:20
constexpr int kThreads = 128;        // threads per block
constexpr int kSub = 16;             // keys per online-softmax update

template <int HD> struct Tile {
  static constexpr int kDpt = HD < 32 ? HD : 32;      // dims per thread
  static constexpr int kTpr = HD / kDpt;              // threads per row
  static constexpr int kBq = kThreads / kTpr;         // query rows / block
  static constexpr int kBk = HD <= 64 ? 64 : 32;      // keys per smem tile
  static_assert(kBk % kSub == 0, "k tile must hold whole sub-chunks");
  static_assert(HD % kDpt == 0 && 32 % kTpr == 0, "bad head dim");
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
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];

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
    qr[i] = row_ok ? C::load(qrow[i * TPR + t]) : 0.f;
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
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {                     // ragged tail: zero, masked below
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
    for (int i = 0; i < DPT; ++i) orow[i * TPR + t] = C::store(acc[i] / denom);
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * Sq + qi] = m + logf(denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV,
                   const Strides* st, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int BQ = Tile<HD>::kBq;
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
                        const Strides* st, int causal, int q_offset,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// strides: 12 element strides, (B, S, H) of q, k, v, o in that order.
// lse: null, or (B, H, Sq) contiguous f32 for the row log-sum-exp.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   const int64_t* strides, int causal,
                                   int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                             q_offset, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, Sq, Sk, H, KV, st,
                                     causal, q_offset, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
