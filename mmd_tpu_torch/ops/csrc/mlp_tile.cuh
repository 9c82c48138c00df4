// A 128 x 128 output tile of a bf16 product on wgmma, its operands streamed
// through a 3-stage cp.async ring of 64 along the contraction, for Hopper
// (sm_90a). Shared by the fused GELU-MLP kernels: the backward's weight
// and dx products (mlp_bwd.cu pass B) and, at D above 256, both launches
// of the forward (mlp_fwd.cu) and the backward's pass A.
//
// A CTA is two warpgroups (256 threads); warpgroup wg computes rows 64 wg
// .. 64 wg + 63 of the tile into its m64n128 accumulator (wgmma.cuh's
// layout: acc[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e).
// Operands in 128-byte-swizzled shared memory (wgmma.cuh), three layouts:
//   TILE_MN_MN  both contracted over their rows (dW1 = x^T dab, dW2 = hb^T
//               dyb): two MN-major stages;
//   TILE_K_K    both contracted over their columns (dx = dab w1^T): a is
//               [BT rows][K], b is [BT rows][K], K-major;
//   TILE_K_MN   a contracted over its columns, b over its rows (a = x w1,
//               y = h w2: x (N, D) and w1 (D, F) as they lie): a K-major,
//               b MN-major.
// Rows of a at or past `valid` read zeros (and so add nothing); for
// TILE_MN_MN `valid` bounds the contraction rows of both operands.

#pragma once

#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace mmd_mlp_tile {

using mmd_tc::bf16;

constexpr int THREADS = 256;      // two warpgroups of 64 rows
constexpr int BT = 128;           // output tile, both sides
constexpr int BKW = 64;           // contraction a stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int TILE = BT * BKW * 2;                   // bytes of an operand's stage
constexpr int SMEM = STAGES * 2 * TILE + 1024;       // + the 1024-byte alignment

enum Layout { TILE_MN_MN, TILE_K_K, TILE_K_MN };

// A K-major stage: ROWS rows of 64 bf16 from src (row stride ld), rows at or
// past `valid` zero.
template <int ROWS>
__device__ __forceinline__ void load_kmajor(unsigned char* dst, const bf16* src, int64_t ld,
                                            int64_t valid) {
    for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
        const int r = i >> 3, c = i & 7;
        const bool ok = r < valid;
        mmd_tc::cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), ok ? src + r * ld + c * 8 : src,
                           ok);
    }
}

// An MN-major stage: BKW rows of 128 bf16 (two atoms) from src (row stride
// ld), rows at or past `valid` zero.
__device__ __forceinline__ void load_mnmajor(unsigned char* dst, const bf16* src, int64_t ld,
                                             int64_t valid) {
    for (int i = threadIdx.x; i < BKW * 16; i += THREADS) {
        const int k = i >> 4, c = i & 15;
        const bool ok = k < valid;
        mmd_tc::cp_async16(dst + (c >> 3) * (BKW * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4),
                           ok ? src + k * ld + c * 8 : src, ok);
    }
}

// One 128 x 128 output tile over `iters` stages of BKW: warpgroup wg's 64 x
// 128 half in acc. For TILE_MN_MN a and b point at the first contraction
// row, rows advance by lda / ldb; otherwise a is [BT rows][K] with `valid`
// rows, and b is [BT rows][K] (TILE_K_K) or [K rows][BT] (TILE_K_MN, its
// rows advancing by ldb). A stage is overwritten two iterations after its
// products were issued: wgmma.wait_group 1 has retired them by then.
template <int LAYOUT>
__device__ __forceinline__ void product_tile(float (&acc)[64], unsigned char* smem,
                                             const bf16* a, int64_t lda, const bf16* b,
                                             int64_t ldb, int64_t valid, int iters) {
    using namespace mmd_wgmma;
    const int wg = threadIdx.x >> 7;
    auto load = [&](int i) {
        unsigned char* as = smem + (i % STAGES) * 2 * TILE;
        const int64_t k = static_cast<int64_t>(i) * BKW;
        if constexpr (LAYOUT == TILE_MN_MN) {
            load_mnmajor(as, a + k * lda, lda, valid - k);
            load_mnmajor(as + TILE, b + k * ldb, ldb, valid - k);
        } else if constexpr (LAYOUT == TILE_K_K) {
            load_kmajor<BT>(as, a + k, lda, valid);
            load_kmajor<BT>(as + TILE, b + k, ldb, BT);
        } else {
            load_kmajor<BT>(as, a + k, lda, valid);
            load_mnmajor(as + TILE, b + k * ldb, ldb, BKW);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 2; ++s) {
        if (s < iters) load(s);
        mmd_tc::cp_async_commit();
    }
    for (int i = 0; i < iters; ++i) {
        mmd_tc::cp_async_wait<STAGES - 3>();
        fence_async_shared();
        __syncthreads();                        // stage i is in; stage i - 2 is retired
        if (i + STAGES - 2 < iters) load(i + STAGES - 2);
        mmd_tc::cp_async_commit();
        const uint32_t as = mmd_tc::smem_addr(smem + (i % STAGES) * 2 * TILE);
        const uint32_t bs = as + TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKW; kk += 16) {
            if constexpr (LAYOUT == TILE_MN_MN) {
                wgmma_n128<1, 1>(acc, desc_mnmajor(as + wg * (BKW * 128) + kk * 128, BKW * 128),
                                 desc_mnmajor(bs + kk * 128, BKW * 128), i > 0 || kk > 0);
            } else if constexpr (LAYOUT == TILE_K_K) {
                wgmma_n128<0, 0>(acc, desc_kmajor(as + wg * 64 * 128 + kk * 2),
                                 desc_kmajor(bs + kk * 2), i > 0 || kk > 0);
            } else {
                wgmma_n128<0, 1>(acc, desc_kmajor(as + wg * 64 * 128 + kk * 2),
                                 desc_mnmajor(bs + kk * 128, BKW * 128), i > 0 || kk > 0);
            }
        }
        wgmma_commit();
        wgmma_wait<1>();
    }
    wgmma_wait<0>();
}

}  // namespace mmd_mlp_tile
