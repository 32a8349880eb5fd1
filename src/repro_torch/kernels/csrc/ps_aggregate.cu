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
//     the tail of the grid is masked. One thread per value, no block size
//     to fit.
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

template <int S>
__global__ void __launch_bounds__(kThreads)
ps_aggregate_kernel(const float* __restrict__ rows, int64_t row_stride,
                    int n_rows, float* __restrict__ p, float* __restrict__ m,
                    float* __restrict__ v, int64_t f, Hyper h) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= f) return;
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

template <int S>
cudaError_t launch(const float* rows, int64_t row_stride, int n_rows,
                   float* p, float* m, float* v, int64_t f, Hyper h,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((f + kThreads - 1) / kThreads));
  ps_aggregate_kernel<S><<<grid, kThreads, 0, stream>>>(
      rows, row_stride, n_rows, p, m, v, f, h);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. solver: 0 sgd, 1 momentum,
// 2 adam, 3 easgd_center, 4 average. rows: n_rows rows of f values,
// row r at rows + r * row_stride (elements). p/m/v: f values each,
// updated in place (m/v are read and written only by the solvers that
// use them). Launches on `stream`, does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
extern "C" int ps_aggregate(const float* rows, int64_t row_stride,
                            int n_rows, float* p, float* m, float* v,
                            int64_t f, int solver, float lr, float b1,
                            float b2, float one_minus_b1,
                            float one_minus_b2, float eps, float momentum,
                            float beta, float step, void* stream) {
  if (n_rows <= 0 || f <= 0 || row_stride < f ||
      (f + kThreads - 1) / kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, b1, b2, one_minus_b1, one_minus_b2, eps, momentum,
                beta, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (solver) {
    case kSgd: return launch<kSgd>(rows, row_stride, n_rows, p, m, v, f, h, s);
    case kMomentum: return launch<kMomentum>(rows, row_stride, n_rows, p, m, v, f, h, s);
    case kAdam: return launch<kAdam>(rows, row_stride, n_rows, p, m, v, f, h, s);
    case kEasgdCenter: return launch<kEasgdCenter>(rows, row_stride, n_rows, p, m, v, f, h, s);
    case kAverage: return launch<kAverage>(rows, row_stride, n_rows, p, m, v, f, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
