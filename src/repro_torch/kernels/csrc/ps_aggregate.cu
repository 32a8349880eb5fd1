// Fused parameter-server aggregation + solver update (K1) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_agg_kernel` of
// src/repro/kernels/ps_aggregate.py:27 (wrapped by `ps_aggregate`, :66),
// which the JAX software PS calls per shard on a TPU
// (core/software_ps.py:187). One read-modify-write pass over a shard:
//
//   g = mean over the NL learner rows (f32 sum, then / NL)
//   sgd:          p -= lr * g
//   momentum:     m = momentum * m + g;            p -= lr * m
//   adam:         m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
//                 p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
//   easgd_center: p += beta * g       (rows hold beta-scaled x_i - center)
//   average:      p = g               (rows hold weights: model averaging)
//
// The solver is a template parameter, so each update is its own kernel
// with no branch per element. The hyper-parameters are runtime floats; the
// caller passes (1 - b1) and (1 - b2) as it computes them (in double, then
// rounded to f32), the values JAX's f32 arrays see for `1 - b1`.
//
// Adam's bias correction. The 1-based step t comes in as f32 and
// 1 - b^t is taken in f32 with `powf`, as the Pallas kernel and the jnp
// oracle `ps_aggregate_ref` do (the JAX CPU parameter server's numpy twin
// takes b^t in float64 instead; the two differ by ~1e-7 relative, inside
// the 1e-5 / 1e-6 tolerances of tests/test_kernels.py:71-73).
//
// Layout and differences from the TPU kernel, by design:
//   * In place. p/m/v are the PS's device-resident state; the kernel
//     updates them where they lie (the TPU kernel returned new arrays that
//     the host copied back).
//   * Strided rows. rows (NL, F) are read through a row stride, so the PS
//     hands the shard's column slice of its (n_learners, padded) receive
//     buffer straight in: no contiguous copy per shard (JAX's CPU path
//     made one, core/software_ps.py:209).
//   * F is any positive count (the PS pads shards to multiples of 256);
//     the tail of the grid is masked, so a block that does not divide F
//     is never a fault.
//
// Launch shape. Each block (CTA) of 256 threads owns `block` consecutive
// values, 1 to 2,048, a runtime argument that kernels/autotune.py
// chooses (the reference's grid block, autotune.py:266); thread t
// handles values t, t + 256, ... of the block's range, so every load and
// store of a warp is one coalesced segment. The values a thread handles,
// ceil(block / 256), is a template parameter (1 to 8), its loop unrolled
// (a loop with a runtime trip count took more registers for adam than
// eight blocks an SM leave a thread, and was slower on the card). The
// shape changes which thread computes a value, never how: each value's
// sum over rows and its update are the same instructions in the same
// order, so every block gives the same bits.
//
// What bounds it on the H100: bytes. Per value it reads NL row values and
// p (and m, v) and writes p (and m, v): (NL + 6) * 4 bytes for adam, about
// 2 FLOP per byte, far below the ~295 FLOP/byte ridge. Every value is
// read once and written once, consecutive threads touch consecutive
// addresses of every array, and the learner sum is kept in a register.
// Vector (16-byte) loads are left for a later PR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Solver { kSgd = 0, kMomentum = 1, kAdam = 2, kEasgdCenter = 3,
              kAverage = 4 };

struct Hyper {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, momentum, beta, step;
};

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;   // values a thread: block <= 2,048

template <int S>
__device__ __forceinline__ void update(const float* __restrict__ rows,
                                       int64_t row_stride, int n_rows,
                                       float* __restrict__ p,
                                       float* __restrict__ m,
                                       float* __restrict__ v, int64_t i,
                                       const Hyper& h) {
  float sum = 0.f;
  for (int r = 0; r < n_rows; ++r) sum += rows[r * row_stride + i];
  const float g = sum / static_cast<float>(n_rows);
  if (S == kSgd) {
    p[i] = p[i] - h.lr * g;
  } else if (S == kMomentum) {
    const float mn = h.momentum * m[i] + g;
    m[i] = mn;
    p[i] = p[i] - h.lr * mn;
  } else if (S == kAdam) {
    const float mn = h.b1 * m[i] + h.one_minus_b1 * g;
    const float vn = h.b2 * v[i] + h.one_minus_b2 * g * g;
    const float mh = mn / (1.f - powf(h.b1, h.step));
    const float vh = vn / (1.f - powf(h.b2, h.step));
    m[i] = mn;
    v[i] = vn;
    p[i] = p[i] - h.lr * mh / (sqrtf(vh) + h.eps);
  } else if (S == kEasgdCenter) {
    p[i] = p[i] + h.beta * g;
  } else {  // kAverage
    p[i] = g;
  }
}

// VPT = ceil(block / 256) values a thread, masked to the block and to f
template <int S, int VPT>
__global__ void __launch_bounds__(kThreads)
ps_aggregate_kernel(const float* __restrict__ rows, int64_t row_stride,
                    int n_rows, float* __restrict__ p, float* __restrict__ m,
                    float* __restrict__ v, int64_t f, int block, Hyper h) {
  const int64_t base = (int64_t)blockIdx.x * block;
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    const int j = u * kThreads + threadIdx.x;
    const int64_t i = base + j;
    if (j < block && i < f) update<S>(rows, row_stride, n_rows, p, m, v, i, h);
  }
}

template <int S, int VPT>
cudaError_t launch(const float* rows, int64_t row_stride, int n_rows,
                   float* p, float* m, float* v, int64_t f, int block,
                   Hyper h, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((f + block - 1) / block));
  ps_aggregate_kernel<S, VPT><<<grid, kThreads, 0, stream>>>(
      rows, row_stride, n_rows, p, m, v, f, block, h);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_block(const float* rows, int64_t row_stride, int n_rows,
                         float* p, float* m, float* v, int64_t f, int block,
                         Hyper h, cudaStream_t s) {
  switch ((block + kThreads - 1) / kThreads) {
    case 1: return launch<S, 1>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 2: return launch<S, 2>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 3: return launch<S, 3>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 4: return launch<S, 4>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 5: return launch<S, 5>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 6: return launch<S, 6>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 7: return launch<S, 7>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case 8: return launch<S, 8>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. solver: 0 sgd, 1 momentum,
// 2 adam, 3 easgd_center, 4 average. rows: n_rows rows of f values,
// row r at rows + r * row_stride (elements). p/m/v: f values each,
// updated in place (m/v are read and written only by the solvers that
// use them). block: values per thread block, 1 to 2,048. Launches on
// `stream`, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int ps_aggregate(const float* rows, int64_t row_stride,
                            int n_rows, float* p, float* m, float* v,
                            int64_t f, int block, int solver, float lr,
                            float b1, float b2, float one_minus_b1,
                            float one_minus_b2, float eps, float momentum,
                            float beta, float step, void* stream) {
  if (n_rows <= 0 || f <= 0 || row_stride < f || block <= 0 ||
      block > kThreads * kMaxPerThread || (f + block - 1) / block > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, b1, b2, one_minus_b1, one_minus_b2, eps, momentum,
                beta, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (solver) {
    case kSgd: return launch_block<kSgd>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case kMomentum: return launch_block<kMomentum>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case kAdam: return launch_block<kAdam>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case kEasgdCenter: return launch_block<kEasgdCenter>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    case kAverage: return launch_block<kAverage>(rows, row_stride, n_rows, p, m, v, f, block, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
