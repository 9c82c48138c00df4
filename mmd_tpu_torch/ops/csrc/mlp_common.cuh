// Shared pieces of the fused GELU-MLP kernels (mlp_fwd.cu, mlp_bwd.cu) and
// of their mask oracle (mlp_masks.cu), for Hopper (sm_90a):
//   * the tanh-GELU with its derivative, as mmd_tpu/ops/mlp.py writes
//     them, from one fast tanh: the one GELU both kernels take;
//   * the MLP's two dropout masks, drawn from philox.cuh at the absolute
//     row-major index: the hidden mask at row * F + f with the first seed,
//     the output mask at row * D + d with the second, the same draws the
//     unfused path's two elementwise dropouts make. `keep_byte` is the one
//     function every kernel draws them with, so the oracle's dump tests the
//     very bits the forward and the backward use.
// Both kernels' products run on wgmma (wgmma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mmd_mlp {

// The widest D the forward and backward kernels take (D a multiple of 128
// up to it). D 128 and 256 run the one-kernel forward and pass A with x
// resident; above 256 both run on mlp_tile.cuh's tiles, whose shared memory
// and registers do not grow with D. 1024 is the widest D held against the
// plain versions on the card.
constexpr int MAX_D = 1024;

constexpr float GELU_C = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float GELU_K = 0.044715f;

// gelu_tanh(a) (mmd_tpu/ops/mlp.py::_gelu_tanh) and its derivative from
// one tanh, taken as 1 - 2 / (1 + e^2u) with the fast exponential and
// division (ex2.approx, rcp.approx): within ~1e-7 of tanhf (absolute; the
// relative error near u = 0 is larger, but 0.5 a (1 + t) and the
// derivative only see t's absolute error), far below the bf16 rounding of
// h and da; the derivative as mmd_tpu/ops/mlp.py::_bwd_kernel writes it.
// The one GELU of both kernels: the forward takes g alone (the compiler
// drops dg), so the backward's recomputed h is the forward's h wherever
// their fp32 a agree.
__device__ __forceinline__ void gelu_tanh_and_grad_fast(float a, float& g, float& dg) {
    const float u = GELU_C * (a + GELU_K * a * a * a);
    const float t = 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
    g = 0.5f * a * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_K * a * a);
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

}  // namespace mmd_mlp
