// Shared pieces of the fused GELU-MLP kernels (mlp_fwd.cu, mlp_bwd.cu) and
// of their mask oracle (mlp_masks.cu), for Hopper (sm_90a):
//   * the tanh-GELU and its derivative, as mmd_tpu/ops/mlp.py writes them;
//   * the MLP's two dropout masks, drawn from philox.cuh at the absolute
//     row-major index: the hidden mask at row * F + f with the first seed,
//     the output mask at row * D + d with the second, the same draws the
//     unfused path's two elementwise dropouts make. `keep_byte` is the one
//     function every kernel draws them with, so the oracle's dump tests the
//     very bits the forward and the backward use;
//   * bf16 tensor-core products: mma.sync m16n8k16 with fp32 accumulators,
//     operands loaded from shared memory with ldmatrix (.trans where the
//     tile is stored with the product's k dimension across its rows).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and q = lane % 4: A (16 x 16) a0 = (g, 2q..2q+1), a1 = (g + 8,
// 2q), a2 = (g, 2q + 8), a3 = (g + 8, 2q + 8); B (16 x 8) b0 = (k 2q..2q+1,
// n g), b1 = (k 2q + 8, n g); C (16 x 8) c0..c1 = (g, 2q..2q+1), c2..c3 =
// (g + 8, 2q..2q+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mmd_mlp {

using bf16 = __nv_bfloat16;

constexpr float GELU_C = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float GELU_K = 0.044715f;

// mmd_tpu/ops/mlp.py::_gelu_tanh
__device__ __forceinline__ float gelu_tanh(float a) {
    return 0.5f * a * (1.f + tanhf(GELU_C * (a + GELU_K * a * a * a)));
}

// d gelu_tanh / da, as mmd_tpu/ops/mlp.py::_bwd_kernel writes it
__device__ __forceinline__ float gelu_tanh_grad(float a) {
    const float t = tanhf(GELU_C * (a + GELU_K * a * a * a));
    return 0.5f * (1.f + t) +
           0.5f * a * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_K * a * a);
}

// One dropout mask. With on == 0 every element is kept and scale is 1.
struct Mask {
    uint64_t seed;
    uint32_t threshold;                     // keep when the draw is below it
    float scale;                            // 1 / (1 - rate), or 1
    int on;
};

// Keep bits of elements row * ld + col8 .. + 7 of a row-major (rows, ld)
// mask, bit e for element col8 + e. ld and col8 are multiples of 8, so the
// eight draws are lanes 0..3 of two consecutive Philox groups.
__device__ __forceinline__ uint32_t keep_byte(const Mask& m, uint64_t row, int ld, int col8) {
    if (!m.on) return 0xFFu;
    const uint64_t group = (row * static_cast<uint64_t>(ld) + col8) >> 2;
    const uint4 r0 = mmd_philox::group_bits(m.seed, group);
    const uint4 r1 = mmd_philox::group_bits(m.seed, group + 1);
    const uint32_t t = m.threshold;
    return static_cast<uint32_t>(r0.x < t) | static_cast<uint32_t>(r0.y < t) << 1 |
           static_cast<uint32_t>(r0.z < t) << 2 | static_cast<uint32_t>(r0.w < t) << 3 |
           static_cast<uint32_t>(r1.x < t) << 4 | static_cast<uint32_t>(r1.y < t) << 5 |
           static_cast<uint32_t>(r1.z < t) << 6 | static_cast<uint32_t>(r1.w < t) << 7;
}

// A (ROWS x COLS) tile of keep bits in shared memory, one byte per 8
// columns: rows row0.., columns col0.. of a mask whose rows are ld long.
template <int ROWS, int COLS>
__device__ __forceinline__ void fill_keep(uint8_t* bits, const Mask& m, int64_t row0, int ld,
                                          int col0) {
    static_assert(COLS % 8 == 0, "keep tiles hold whole bytes");
    for (int i = threadIdx.x; i < ROWS * (COLS / 8); i += blockDim.x) {
        const int r = i / (COLS / 8);
        const int c8 = 8 * (i % (COLS / 8));
        bits[i] = static_cast<uint8_t>(keep_byte(m, static_cast<uint64_t>(row0 + r), ld, col0 + c8));
    }
}

// keep * scale of element (r, c) of a tile filled by fill_keep
template <int COLS>
__device__ __forceinline__ float keep_scale(const uint8_t* bits, const Mask& m, int r, int c) {
    return (bits[r * (COLS / 8) + (c >> 3)] >> (c & 7)) & 1u ? m.scale : 0.f;
}

// -- tiles ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a trip through registers; zeros when
// !valid (then nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying a (rows x cols) bf16 block, row stride ld_src, into shared
// memory at row stride ld_dst, 16 bytes a copy; rows at or past `valid` are
// filled with zeros. cols, ld_src and ld_dst are multiples of 8. The copies
// are asynchronous: cp_async_wait_all(), then a barrier, before any thread
// reads the tile.
__device__ __forceinline__ void load_tile(bf16* dst, int ld_dst, const bf16* src, int64_t ld_src,
                                          int rows, int cols, int64_t valid) {
    const int per_row = cols / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
        const int r = i / per_row;
        const int c = 8 * (i % per_row);
        const bool ok = r < valid;
        cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
    }
}

// -- tensor-core products ------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a b for one 16 x 8 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows m0..m0+15, k0..k0+15 of a tile stored [m][k]
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

// B fragments of k0..k0+15 and two n-tiles, n0..n0+7 (b[0], b[1]) and
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

__device__ __forceinline__ void store_bf16x2(bf16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace mmd_mlp
