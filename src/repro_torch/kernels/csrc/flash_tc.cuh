// Hopper tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) and of the SSD scan's
// tensor-core instance (ssd_scan.cu): 16-byte cp.async copies
// into swizzled shared-memory tiles, wgmma matrix descriptors for those
// tiles, and the warpgroup matrix multiplies themselves (inline PTX,
// sm_90a only).
//
// Shared-memory tile layout. A tile of ROWS rows of a (.., S, .., HD) bf16
// tensor (one row = one token's HD values) is kept as HD/64 column blocks,
// each ROWS rows of 64 values (128 bytes). Inside a block, the 16-byte
// chunk c of row r sits at chunk position c ^ (r % 8): the 128-byte
// swizzle that wgmma's layout type 1 reads, with eight rows (1024 bytes)
// per swizzle atom. Every tile starts on a 1024-byte boundary.
//
// One tile serves as either operand kind of `wgmma`:
//   * K-major (reduced over HD: the A or B of Q.K^T, dO.V^T, K.Q^T,
//     V.dO^T): the k-step kk of 16 values starts at column block kk / 4,
//     byte 32 * (kk % 4) of the row; 8-row groups lie 1024 bytes apart.
//   * MN-major (reduced over the rows, HD is N: the B of P.V, dS.K,
//     P^T.dO, dS^T.Q, read with the transpose bit): the k-step kk of 16
//     rows starts at row 16 * kk; 8-row groups lie 1024 bytes apart, and
//     the 64-wide column blocks ROWS * 128 bytes apart. The same layout
//     and descriptor serve as a transposed A operand (`mma_ss_mn`), its
//     64 M values one column block: the SSD state's B^T.x.
//
// Register fragments. A warpgroup's m64nN f32 accumulator gives thread
// (warp w, lane l) rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
// (+ 1) in d[4 j .. 4 j + 3]. The bf16 A operand of an m64k16 product
// taken from registers has the same layout for its 16 columns, so the
// 8 accumulator values d[8 kk .. 8 kk + 7], rounded to bf16 in pairs,
// are the A fragment of k-step kk: a score tile becomes the A operand
// of the next product without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk `c` (0 .. HD/8 - 1) of row `r`
template <int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return ((c >> 3) * ROWS + r) * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's completed shared-memory writes visible to wgmma
// (the async proxy); then a barrier publishes them to the warpgroups
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [row0, row0 + ROWS) of one head (row r at g + r * stride,
// VALID contiguous bf16) into the swizzled tile at `tile`, HD values a
// row: rows >= nrows and columns >= VALID (a head dim padded up to the
// tile's, e.g. 112 in a 128-wide tile) zero-filled. All NT threads of
// the block take part.
template <int ROWS, int HD, int NT, int VALID = HD>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* g,
                                          int64_t stride, int row0,
                                          int nrows, int tid) {
  constexpr int kChunks = ROWS * HD / 8;
  static_assert(kChunks % NT == 0, "tile must split evenly over threads");
  static_assert(VALID % 8 == 0 && VALID <= HD, "whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < kChunks / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / (HD / 8), c = i % (HD / 8);
    const int gr = row0 + r;
    const bool ok = gr < nrows && c < VALID / 8;
    cp_async16(tile + chunk_offset<ROWS>(r, c),
               g + (ok ? (int64_t)gr * stride + c * 8 : 0), ok);
  }
}

// Copy n f32 values starting at row0 (zero past nrows) to `dst`.
template <int N, int NT>
__device__ __forceinline__ void load_row_f32(uint32_t dst, const float* g,
                                             int row0, int nrows, int tid) {
  for (int i = tid; i < N; i += NT) {
    const bool ok = row0 + i < nrows;
    cp_async4(dst + 4 * i, g + (ok ? row0 + i : 0), ok);
  }
}

// wgmma matrix descriptor: start address, leading and stride byte
// offsets, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step kk (16 values of HD) of a ROWS-row tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k-step kk (16 rows) of a ROWS-row tile, HD as N
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma registers
// across the asynchronous product (call after wg_wait)
template <int M>
__device__ __forceinline__ void reg_fence(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// 2^x in one MUFU.EX2 (denormal results flush to zero): the softmax's
// exponentials are the kernels' scarcest instruction at hd 64
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64 x N, f32) (+)= A (m64 x k16, shared, K-major) . B (N x k16,
// shared, K-major)^T; acc = 0 overwrites d
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc);
// d (m64 x N, f32) (+)= A (m64 x k16, registers) . B (k16 x N, shared,
// MN-major)
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t b, int acc);
// d (m64 x N, f32) (+)= A (m64 x k16, shared, MN-major: read with the
// transpose bit, its descriptor as desc_mn's with M as N) . B (k16 x N,
// shared, MN-major)
template <int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t a,
                                          uint64_t b, int acc);

template <> __device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void mma_ss_mn<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


}  // namespace tc
