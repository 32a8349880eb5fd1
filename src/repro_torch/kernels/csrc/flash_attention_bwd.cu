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
// with scale = hd^-0.5, all products in f32 from the stored values (the
// reference casts dO to f32 and promotes q/k/v), the causal mask "key j
// visible to query i iff j <= i + q_offset", and dq/dk/dv written in the
// input type. GQA by index: KV head = h / (H/KV), and dk/dv of a KV head sum
// over its group of query heads inside the kernel, with no repeated copy
// of k/v and no atomics.
//
// Design (simple first):
//   * `flash_bwd_dq_kernel`: one block per (q-tile, b, h). A query row
//     is split over hd/16 neighbouring threads (16 of its q, dO and dq
//     values in registers each); it computes delta for its rows (and
//     writes it for the second kernel), then walks the k-tiles up to the
//     causal limit, staging k and v (as f32) in shared memory, and
//     accumulates dq in registers.
//   * `flash_bwd_dkv_kernel`: one block per (k-tile, b, kv head). A key
//     row holds k, v, dk, dv (16 values each per thread); the block walks
//     the query heads of its group and, for each, the q-tiles from the
//     first query that can see the tile, staging q, dO, lse and delta in
//     shared memory, and accumulates dk and dv in f32 registers. Each
//     output element is written once.
//   * Ragged lengths: any Sq/Sk. Staged rows past the end are zero and
//     masked (P = 0); rows past the end are never written.
//   * The two kernels launch back to back on one stream from one C call
//     (one K4b launch for the wrapper's count); the dq kernel writes the
//     delta scratch the dk/dv kernel reads.
//
// What bounds it on the H100. At the training shape (B 2, S 512, H 32,
// hd 64, bf16, causal) the work is about 5 * 2 * S^2/2 * hd FLOP per head
// (QK^T and dO.V^T recomputed, dq, dk, dv) against ~8 * S * hd * 2 bytes per
// head, ~S/3 FLOP per byte: below the ~295 FLOP/byte ridge, so the least
// time is the bytes over 3.35 TB/s. Like the forward, this first version
// does its products in f32 FMAs on the CUDA cores (no tensor cores), so it
// is bound by those FMAs, the shuffles that finish each dot product, and
// shared-memory reads, not by device memory. Moving the five products onto
// `wgmma` is left for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 128;        // threads per block

template <int HD> struct BwdTile {
  static constexpr int kDpt = 16;                     // dims per thread
  static constexpr int kTpr = HD / kDpt;              // threads per row
  static constexpr int kRows = kThreads / kTpr;       // own rows per block
  static constexpr int kStage = HD <= 64 ? 64 : 32;   // staged rows per tile
  static_assert(HD % kDpt == 0 && 32 % kTpr == 0, "bad head dim");
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
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];

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
      qr[i] = row_ok ? C::load(qrow[d]) : 0.f;
      dor[i] = row_ok ? C::load(drow[d]) : 0.f;
      dlt = fmaf(dor[i], row_ok ? C::load(orow[d]) : 0.f, dlt);
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
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
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
    for (int i = 0; i < DPT; ++i) out[i * TPR + t] = C::store(acc[i]);
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
  __shared__ float q_tile[BQ][HD];
  __shared__ float do_tile[BQ][HD];
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
      kr[i] = key_ok ? C::load(krow[d]) : 0.f;
      vr[i] = key_ok ? C::load(vrow[d]) : 0.f;
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
      for (int idx = tid; idx < BQ * HD; idx += kThreads) {
        const int r = idx / HD, d = idx % HD;
        const int qp = qs0 + r;
        float qx = 0.f, dx = 0.f;
        if (qp < Sq) {
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
      ko[i * TPR + t] = C::store(dka[i]);
      vo[i * TPR + t] = C::store(dva[i]);
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

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
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
  if (dtype == 1)
    return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
