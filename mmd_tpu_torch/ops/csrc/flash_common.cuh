// Tiles and tensor-core products shared by the flash-attention forward
// (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu) for Hopper (sm_90a).
//
// A CTA is 4 warps. Every product of both kernels is one of two shapes,
// computed by one warp for its 16 rows, over N n8 tiles (N = 8: a whole
// 64-row tile):
//   scores  C (16 x 8N) += A (16 x DH) . B^T, with A the warp's 16 rows of a
//           tile stored [m][d] and B 8N rows of a tile stored [n][d]:
//           S = Q K^T and dP = dO V^T (query rows), S^T = K Q^T and
//           dP^T = V dO^T (key rows);
//   pv      O (16 x DH) += W (16 x 8N) . B, with W in registers in the C
//           fragment layout of `scores` and B 8N rows of a tile stored
//           [k][d]: P V, dS K, P^T dO and dS^T Q.
// So a weight tile never leaves registers between its two products: the C
// fragments of two adjacent n8 tiles of `scores` are one m16k16 A fragment
// of `pv` (bf16), or, with the k index of each 8-key block permuted, one
// m16k8 A fragment (tf32, 3xTF32) -- see Ops<float, DH>::pv.
//
// Tiles hold 64 rows of one head (DH elements) with rows padded by 16
// bytes. A row is then DH / 2 + 4 words (bf16) or DH + 4 (fp32): for DH a
// multiple of 16 an odd multiple of 4 words, so the 8 rows an ldmatrix
// reads start in 8 distinct 4-bank groups, and the 32 scalar loads of an
// fp32 B fragment in `pv` (word 2 q LD + g, LD = 4 or 20 mod 32) hit 32
// distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace mmd_flash {

using mmd_tc::bf16;

constexpr int BLOCK = 64;                    // query rows and keys per tile
constexpr int WARPS = 4;                     // 16 rows of a tile each
constexpr int THREADS = 32 * WARPS;
constexpr int NT = BLOCK / 8;                // n8 tiles of a score row
constexpr int KEEP_STRIDE = BLOCK + 4;       // dropout-mask bytes per row
constexpr float LN2 = 0.69314718055994531f;
constexpr float LOG2E = 1.4426950408889634f;

// The head dims both kernels take: every multiple of 16 from 32 to 128, as
// the JAX package sends every head dim from 32 up to its kernel (dh above
// 128, or off the multiples of 16, takes the explicit path: ROADMAP §C).
// ops/attention.py builds one library a head dim (-DMMD_HEAD_DIM=96), so
// that the builds run side by side and a run builds only the head dims it
// meets; without the define a source instantiates all seven (so
// `profile_kernels ptxas` reports every instantiation).
#ifdef MMD_HEAD_DIM
#define MMD_FLASH_HEAD_DIMS(X) X(MMD_HEAD_DIM)
#else
#define MMD_FLASH_HEAD_DIMS(X) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#endif

template <typename T, int DH>
struct Tile {
    static constexpr int LD = DH + 16 / static_cast<int>(sizeof(T));  // elements per row
    static constexpr int ELEMS = BLOCK * LD;
    static constexpr size_t BYTES = ELEMS * sizeof(T);
};

// Start copying rows r0..r0+63 of one head (DH elements at `src`, row stride
// ld_src) into a tile; rows at or past `len` are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int64_t ld_src, int r0,
                                          int len) {
    mmd_tc::load_tile(dst, Tile<T, DH>::LD, src + static_cast<int64_t>(r0) * ld_src, ld_src,
                      BLOCK, DH, static_cast<int64_t>(len) - r0);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
    mmd_tc::store_bf16x2(p, v0, v1);
}

template <typename T, int DH>
struct Ops;

// bf16: m16n8k16, weights rounded to bf16 as the A operand of `pv` (the TPU
// kernel's rounding points: P before P V, p keep scale before dV, dS before
// dQ and dK). Up to dh 64 the A operand of `scores` is held in registers
// across the kernel's loop (DH / 4 registers a matrix). From dh 80 up it is
// read from its tile at each use, as fp32 does: held, the backward's two A
// matrices (40-64 registers) beside its 80-128 dk/dv accumulators would
// spill, as they did at dh 128.
template <int DH>
struct Ops<bf16, DH> {
    static constexpr int LD = Tile<bf16, DH>::LD;
    static constexpr bool kHeld = DH <= 64;
    struct Held {
        uint32_t f[DH / 16][4];
    };
    struct Streamed {
        const bf16* s;
        int m0;
    };
    using A = typename std::conditional<kHeld, Held, Streamed>::type;

    __device__ __forceinline__ static void load_a(A& a, const bf16* s, int m0) {
        if constexpr (kHeld) {
#pragma unroll
            for (int ks = 0; ks < DH / 16; ++ks) mmd_tc::load_a(a.f[ks], s, LD, m0, 16 * ks);
        } else {
            a = A{s, m0};
        }
    }

    template <int N>
    __device__ __forceinline__ static void scores(float (&c)[N][4], const A& a, const bf16* b) {
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
            uint32_t fa[4];
            if constexpr (kHeld) {
#pragma unroll
                for (int i = 0; i < 4; ++i) fa[i] = a.f[ks][i];
            } else {
                mmd_tc::load_a(fa, a.s, LD, a.m0, 16 * ks);
            }
#pragma unroll
            for (int np = 0; np < N / 2; ++np) {
                uint32_t f[4];
                mmd_tc::load_b(f, b, LD, 16 * ks, 16 * np);
                mmd_tc::mma(c[2 * np], fa, f[0], f[1]);
                mmd_tc::mma(c[2 * np + 1], fa, f[2], f[3]);
            }
        }
    }

    template <int N>
    __device__ __forceinline__ static void pv(float (&o)[DH / 8][4], const float (&w)[N][4],
                                              const bf16* b) {
#pragma unroll
        for (int kb = 0; kb < N / 2; ++kb) {
            const uint32_t a[4] = {mmd_tc::pack_bf16x2(w[2 * kb][0], w[2 * kb][1]),
                                   mmd_tc::pack_bf16x2(w[2 * kb][2], w[2 * kb][3]),
                                   mmd_tc::pack_bf16x2(w[2 * kb + 1][0], w[2 * kb + 1][1]),
                                   mmd_tc::pack_bf16x2(w[2 * kb + 1][2], w[2 * kb + 1][3])};
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t f[4];
                mmd_tc::load_b_t(f, b, LD, 16 * kb, 16 * np);
                mmd_tc::mma(o[2 * np], a, f[0], f[1]);
                mmd_tc::mma(o[2 * np + 1], a, f[2], f[3]);
            }
        }
    }
};

// fp32: 3xTF32 on m16n8k8. The A operand of `scores` is read from its tile
// at each use (holding it split would take 2 * DH / 2 registers a matrix).
template <int DH>
struct Ops<float, DH> {
    static constexpr int LD = Tile<float, DH>::LD;
    struct A {
        const float* s;
        int m0;
    };

    __device__ __forceinline__ static void load_a(A& a, const float* s, int m0) { a = A{s, m0}; }

    template <int N>
    __device__ __forceinline__ static void scores(float (&c)[N][4], const A& a, const float* b) {
#pragma unroll
        for (int ks = 0; ks < DH / 8; ++ks) {
            uint32_t raw[4];
            mmd_tc::load_a_f32(raw, a.s, LD, a.m0, 8 * ks);
            const mmd_tc::Split<4> af(raw);
#pragma unroll
            for (int np = 0; np < N / 2; ++np) {
                uint32_t f[4];
                mmd_tc::load_b_f32(f, b, LD, 8 * ks, 16 * np);
                const mmd_tc::Split<4> bf(f);
                mmd_tc::mma_3xtf32(c[2 * np], af, bf.hi[0], bf.hi[1], bf.lo[0], bf.lo[1]);
                mmd_tc::mma_3xtf32(c[2 * np + 1], af, bf.hi[2], bf.hi[3], bf.lo[2], bf.lo[3]);
            }
        }
    }

    // The C fragment of n8 tile j holds W at columns 8j + 2q and 8j + 2q + 1.
    // Taken as the k index q and q + 4 of an m16k8 A fragment, it multiplies
    // B rows 8j + 2q and 8j + 2q + 1: the sum over k is the same, in another
    // order. B is read with scalar loads (row stride = 4 mod 32 words: the 32
    // lanes hit 32 banks).
    template <int N>
    __device__ __forceinline__ static void pv(float (&o)[DH / 8][4], const float (&w)[N][4],
                                              const float* b) {
        const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const uint32_t raw[4] = {__float_as_uint(w[j][0]), __float_as_uint(w[j][2]),
                                     __float_as_uint(w[j][1]), __float_as_uint(w[j][3])};
            const mmd_tc::Split<4> af(raw);
            const float* r0 = b + (8 * j + 2 * q) * LD + g;
#pragma unroll
            for (int nt = 0; nt < DH / 8; ++nt) {
                const uint32_t f[2] = {__float_as_uint(r0[8 * nt]), __float_as_uint(r0[LD + 8 * nt])};
                const mmd_tc::Split<2> bf(f);
                mmd_tc::mma_3xtf32(o[nt], af, bf.hi[0], bf.hi[1], bf.lo[0], bf.lo[1]);
            }
        }
    }
};

template <int N, int M>
__device__ __forceinline__ void zero(float (&x)[N][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j) x[i][j] = 0.f;
}

}  // namespace mmd_flash
