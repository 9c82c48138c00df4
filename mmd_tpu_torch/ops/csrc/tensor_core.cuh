// Tensor-core building blocks shared by the port's Hopper (sm_90a) kernels:
// the fused GELU-MLP (mlp_fwd.cu, mlp_bwd.cu) and flash attention
// (flash_attn_fwd.cu, flash_attn_bwd.cu through flash_common.cuh).
//   * cp.async copies of tiles from device memory into shared memory, 16
//     bytes a thread, rows past the end zero-filled (the src-size-0 form);
//   * ldmatrix loads of mma.sync operand fragments from shared memory;
//   * bf16 mma.sync m16n8k16 with fp32 accumulators;
//   * 3xTF32: an fp32 product on the TF32 tensor cores (mma.sync m16n8k8)
//     with each operand split into hi = tf32(x) and lo = tf32(x - hi) and
//     hi.hi + hi.lo + lo.hi accumulated in fp32, which keeps the error of
//     fp32 FMA (only lo.lo, ~2^-22 of a product, is dropped).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "... mma.m16n8k8"), with g = lane / 4 and q = lane % 4:
//   bf16 m16n8k16: A (16 x 16) a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..),
//     a2 = (g, 2q + 8..), a3 = (g + 8, 2q + 8..); B (16 x 8) b0 = (k 2q..2q+1,
//     n g), b1 = (k 2q + 8.., n g);
//   tf32 m16n8k8: A (16 x 8) a0 = (g, q), a1 = (g + 8, q), a2 = (g, q + 4),
//     a3 = (g + 8, q + 4); B (8 x 8) b0 = (k q, n g), b1 = (k q + 4, n g);
//   C (16 x 8, both) c0..c1 = (g, 2q..2q+1), c2..c3 = (g + 8, 2q..2q+1).
// ldmatrix moves 8 x 8 blocks of 16-bit values; a row of one block is 16
// bytes, i.e. 4 fp32 values, and lane l receives the 4 bytes at (row l / 4,
// 4-byte column l % 4): for an fp32 tile that is exactly the tf32 A and B
// fragment layout, so the same instruction loads both types (non-transposed
// only: .trans moves 16-bit halves).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmd_tc {

using bf16 = __nv_bfloat16;

// -- copies ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a trip through registers; zeros when
// !valid (then nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying a (rows x cols) block of T, row stride ld_src, into shared
// memory at row stride ld_dst, 16 bytes a copy; rows at or past `valid` are
// filled with zeros. cols * sizeof(T), ld_src * sizeof(T) and ld_dst *
// sizeof(T) are multiples of 16. The copies are asynchronous: wait for them
// (cp_async_wait_all, or a committed group), then a barrier, before any
// thread reads the tile.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* src, int64_t ld_src,
                                          int rows, int cols, int64_t valid) {
    constexpr int PER_COPY = 16 / sizeof(T);
    const int per_row = cols / PER_COPY;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
        const int r = i / per_row;
        const int c = PER_COPY * (i % per_row);
        const bool ok = r < valid;
        cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
    }
}

// -- fragments -------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// The bf16 A fragment of rows m0..m0+15, k0..k0+15 of a tile stored [m][k]
// (k contiguous, row stride ld elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4(a, s + (m0 + (i & 1) * 8 + r) * ld + k0 + (i >> 1) * 8);
}

// The same fragment of a tile stored [k][m] (m contiguous).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4_t(a, s + (k0 + (i >> 1) * 8 + r) * ld + m0 + (i & 1) * 8);
}

// bf16 B fragments of k0..k0+15 and two n-tiles, n0..n0+7 (b[0], b[1]) and
// n0+8..n0+15 (b[2], b[3]), of a tile stored [n][k] (k contiguous).
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4(b, s + (n0 + (i >> 1) * 8 + r) * ld + k0 + (i & 1) * 8);
}

// The same fragments of a tile stored [k][n] (n contiguous).
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4_t(b, s + (k0 + (i & 1) * 8 + r) * ld + n0 + (i >> 1) * 8);
}

// The tf32 A fragment (raw fp32 bits) of rows m0..m0+15, k0..k0+7 of an fp32
// tile stored [m][k] (row stride ld floats, ld * 4 a multiple of 16).
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* s, int ld, int m0,
                                           int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4(a, s + (m0 + (i & 1) * 8 + r) * ld + k0 + (i >> 1) * 4);
}

// tf32 B fragments (raw fp32 bits) of k0..k0+7 and two n-tiles, n0..n0+7
// (b[0], b[1]) and n0+8..n0+15 (b[2], b[3]), of an fp32 tile stored [n][k].
__device__ __forceinline__ void load_b_f32(uint32_t (&b)[4], const float* s, int ld, int k0,
                                           int n0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    ldsm_x4(b, s + (n0 + (i >> 1) * 8 + r) * ld + k0 + (i & 1) * 4);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// -- products --------------------------------------------------------------------

// c += a b for one 16 x 8 tile, bf16 operands
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for one 16 x 8 tile, tf32 operands (k 8)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo with hi and lo tf32 (round to nearest, ties away: cvt.rna)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(lo)
        : "f"(__uint_as_float(x) - __uint_as_float(hi)));
}

// An fp32 operand fragment split for 3xTF32.
template <int N>
struct Split {
    uint32_t hi[N], lo[N];
    __device__ __forceinline__ explicit Split(const uint32_t (&x)[N]) {
#pragma unroll
        for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
    }
};

// c += a b in fp32 on the TF32 tensor cores: the two small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
    mma_tf32(c, a.lo, bh0, bh1);
    mma_tf32(c, a.hi, bl0, bl1);
    mma_tf32(c, a.hi, bh0, bh1);
}

}  // namespace mmd_tc
