// The disentangled-attention machinery shared by the DeBERTa attention
// forward (deberta_attn_fwd.cu) and backward (deberta_attn_bwd.cu) for
// Hopper (sm_90a): both compute a tile pair's scores with this code.
//
// For query t and key s of a length-T sequence,
//   score[t, s] = (q_t . k_s + q_t . PK[T-1-t+s] + k_s . PQ[T-1-s+t]) * scale.
// The position terms as band products. For the 64-row tile pair (t0, s0)
// the PK rows that serve it are the 128-row band from T-64-t0+s0, and
// local band row 63 - r + c serves pair (r, c); the PQ band starts at
// T-64-s0+t0, and row 63 - c + r serves (r, c). So, with 64-row tiles:
//   c2p = diag(Q_tile PK_band^T):   score (r, c) takes element (r, 63-r+c)
//   p2c = diag(K_tile PQ_band^T)^T: score (r, c) takes element (c, 63-c+r)
// A CTA owns one 64-row tile (its "own" rows: queries, or keys in the
// backward's transposed frame) and walks the other 64-row tiles. Rows r of
// warp w use band rows [48 - 16w, 128 - 16w): a window of 80 rows (10 n8
// tiles, 5 k16 steps). The c2p and p2c products leave their mma as C
// fragments in registers and go through a 64 x 88 fp32 tile in shared
// memory, where each score fragment reads its diagonal element. 88 floats
// a row (24 mod 32): the 8-byte fragment stores are free of bank
// conflicts, the diagonal reads 2-way.
//
// The bands come from a ring of three 64-row chunks per table: at step i
// a CTA reads chunks i and i + 1 of each, so each step loads one new chunk
// of each table (cp.async, a step ahead) and never a whole band.
//
// Tiles are kept in the input dtype (rows padded by 16 bytes, as in
// flash_common.cuh); every product is an mma.sync: bf16 m16n8k16 with fp32
// accumulators, fp32 as 3xTF32 on m16n8k8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace mmd_deberta {

using namespace mmd_flash;

constexpr int WIN = 80;                      // band rows in one warp's window
constexpr int G_LD = 88;                     // floats a row of the band scores' tile
constexpr float NEG = -3.402823466e38f;      // finfo(float32).min

template <typename T>
struct Skew {                                // the backward's dSk row stride, elements
    static constexpr int LD = sizeof(T) == 2 ? 136 : 132;
};

// Shared memory of a CTA: its own tile X (and X2 when PAIRED: the
// backward's second own tile), the walked tiles Y and Y2, two rings of
// three band chunks; the band scores' fp32 tile, which the backward's dSk
// shares; COLS x 64 floats of per-column values.
template <typename T, int DH, bool PAIRED>
struct Smem {
    static constexpr int OWN = PAIRED ? 2 : 1;
    static constexpr size_t TILES = (OWN + 8) * Tile<T, DH>::BYTES;
    static constexpr size_t G = static_cast<size_t>(BLOCK) * G_LD * sizeof(float);
    static constexpr size_t DSK =
        PAIRED ? static_cast<size_t>(BLOCK) * Skew<T>::LD * sizeof(T) : 0;
    static constexpr size_t SHARED = G > DSK ? G : DSK;
    static constexpr int COLS = PAIRED ? 3 : 1;
    static constexpr size_t BYTES = TILES + SHARED + COLS * BLOCK * sizeof(float);
};

// The rows of one band: rows 0..63 in chunk `lo`, 64..127 in chunk `hi`.
template <typename T, int DH>
struct Band {
    const T* lo;
    const T* hi;
    __device__ __forceinline__ const T* row(int j) const {
        constexpr int LD = Tile<T, DH>::LD;
        return j < BLOCK ? lo + j * LD : hi + (j - BLOCK) * LD;
    }
};

template <typename T, int DH>
struct BandOps;

// bf16 products of the band terms.
template <int DH>
struct BandOps<bf16, DH> {
    using Op = Ops<bf16, DH>;
    static constexpr int LD = Tile<bf16, DH>::LD;
    static constexpr int SLD = Skew<bf16>::LD;

    // c (16 x 8N) += A (16 x DH) . band rows [n0, n0 + 8N)^T
    template <int N>
    __device__ __forceinline__ static void scores(float (&c)[N][4], const typename Op::A& a,
                                                  const Band<bf16, DH>& band, int n0) {
        const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
            for (int np = 0; np < N / 2; ++np) {
                uint32_t f[4];
                mmd_tc::ldsm_x4(f, band.row(n0 + 16 * np + (i >> 1) * 8 + r) + 16 * ks +
                                       (i & 1) * 8);
                mmd_tc::mma(c[2 * np], a.f[ks], f[0], f[1]);
                mmd_tc::mma(c[2 * np + 1], a.f[ks], f[2], f[3]);
            }
        }
    }

    // o (16 x DH) += dSk rows [m0, +16) x cols [k0, +16 ks) . band rows [k0, ...)
    __device__ __forceinline__ static void own(float (&o)[DH / 8][4], const bf16* dsk, int m0,
                                               int k0, int steps, const Band<bf16, DH>& band) {
        const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kk = 0; kk < steps; ++kk) {
            const int k = k0 + 16 * kk;
            uint32_t a[4];
            mmd_tc::load_a(a, dsk, SLD, m0, k);
            const bf16* brow = band.row(k + (i & 1) * 8 + r) + (i >> 1) * 8;
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t f[4];
                mmd_tc::ldsm_x4_t(f, brow + 16 * np);
                mmd_tc::mma(o[2 * np], a, f[0], f[1]);
                mmd_tc::mma(o[2 * np + 1], a, f[2], f[3]);
            }
        }
    }

    // o (16 band rows x DH) += dSk^T rows [j0, +16) x k [k0, +16 steps) . x rows k
    __device__ __forceinline__ static void grad(float (&o)[DH / 8][4], const bf16* dsk, int j0,
                                                int k0, int steps, const bf16* x) {
        for (int kk = 0; kk < steps; ++kk) {
            const int k = k0 + 16 * kk;
            uint32_t a[4];
            mmd_tc::load_a_t(a, dsk, SLD, j0, k);
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t f[4];
                mmd_tc::load_b_t(f, x, LD, k, 16 * np);
                mmd_tc::mma(o[2 * np], a, f[0], f[1]);
                mmd_tc::mma(o[2 * np + 1], a, f[2], f[3]);
            }
        }
    }
};

// fp32: 3xTF32. `own` and `grad` take the k index of an m16k8 fragment in
// the permuted order of Ops<float, DH>::pv (k q and q + 4 are rows 2q and
// 2q + 1), so the scalar loads of B (row stride 4 mod 32 words) and of the
// transposed dSk (132 = 4 mod 32) hit 32 banks.
template <int DH>
struct BandOps<float, DH> {
    using Op = Ops<float, DH>;
    static constexpr int LD = Tile<float, DH>::LD;
    static constexpr int SLD = Skew<float>::LD;

    template <int N>
    __device__ __forceinline__ static void scores(float (&c)[N][4], const typename Op::A& a,
                                                  const Band<float, DH>& band, int n0) {
        const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
        for (int ks = 0; ks < DH / 8; ++ks) {
            uint32_t raw[4];
            mmd_tc::load_a_f32(raw, a.s, LD, a.m0, 8 * ks);
            const mmd_tc::Split<4> af(raw);
#pragma unroll
            for (int np = 0; np < N / 2; ++np) {
                uint32_t f[4];
                mmd_tc::ldsm_x4(f, band.row(n0 + 16 * np + (i >> 1) * 8 + r) + 8 * ks +
                                       (i & 1) * 4);
                const mmd_tc::Split<4> bf(f);
                mmd_tc::mma_3xtf32(c[2 * np], af, bf.hi[0], bf.hi[1], bf.lo[0], bf.lo[1]);
                mmd_tc::mma_3xtf32(c[2 * np + 1], af, bf.hi[2], bf.hi[3], bf.lo[2], bf.lo[3]);
            }
        }
    }

    __device__ __forceinline__ static void own(float (&o)[DH / 8][4], const float* dsk, int m0,
                                               int k0, int steps, const Band<float, DH>& band) {
        const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
        for (int kk = 0; kk < 2 * steps; ++kk) {
            const int k = k0 + 8 * kk;
            const float2 x0 = *reinterpret_cast<const float2*>(dsk + (m0 + g) * SLD + k + 2 * q);
            const float2 x1 =
                *reinterpret_cast<const float2*>(dsk + (m0 + g + 8) * SLD + k + 2 * q);
            const uint32_t raw[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                     __float_as_uint(x0.y), __float_as_uint(x1.y)};
            const mmd_tc::Split<4> af(raw);
            const float* r0 = band.row(k + 2 * q) + g;
            const float* r1 = band.row(k + 2 * q + 1) + g;
#pragma unroll
            for (int nt = 0; nt < DH / 8; ++nt) {
                const uint32_t f[2] = {__float_as_uint(r0[8 * nt]), __float_as_uint(r1[8 * nt])};
                const mmd_tc::Split<2> bf(f);
                mmd_tc::mma_3xtf32(o[nt], af, bf.hi[0], bf.hi[1], bf.lo[0], bf.lo[1]);
            }
        }
    }

    __device__ __forceinline__ static void grad(float (&o)[DH / 8][4], const float* dsk, int j0,
                                                int k0, int steps, const float* x) {
        const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
        for (int kk = 0; kk < 2 * steps; ++kk) {
            const int k = k0 + 8 * kk;
            const float* d0 = dsk + (k + 2 * q) * SLD + j0 + g;
            const float* d1 = d0 + SLD;
            const uint32_t raw[4] = {__float_as_uint(d0[0]), __float_as_uint(d0[8]),
                                     __float_as_uint(d1[0]), __float_as_uint(d1[8])};
            const mmd_tc::Split<4> af(raw);
            const float* r0 = x + (k + 2 * q) * LD + g;
#pragma unroll
            for (int nt = 0; nt < DH / 8; ++nt) {
                const uint32_t f[2] = {__float_as_uint(r0[8 * nt]),
                                       __float_as_uint(r0[LD + 8 * nt])};
                const mmd_tc::Split<2> bf(f);
                mmd_tc::mma_3xtf32(o[nt], af, bf.hi[0], bf.hi[1], bf.lo[0], bf.lo[1]);
            }
        }
    }
};


// One CTA's operands: its own tiles X, X2 (X2 null in the forward) and the
// walked tiles Y, Y2 of a batch row and head (row stride d_model), the
// table whose band gives the own term and the other table. Score rows are
// X's rows.
template <typename T, int DH>
struct Frame {
    const T *x, *x2, *y, *y2, *own_tab, *other_tab;
    int own_tile, t_len, d_model;
};

// The CTA's shared memory (layout of Smem<T, DH, PAIRED>).
template <typename T, int DH, bool PAIRED>
struct Shared {
    static constexpr int TE = Tile<T, DH>::ELEMS;
    T *xs, *x2s, *ys, *y2s, *ring_own, *ring_other;
    float* gs;                   // the band scores' tile ...
    T* dsk;                      // ... and dSk, in the same bytes
    float* col;                  // [COLS][BLOCK] per walked row

    __device__ __forceinline__ explicit Shared(float4* smem) {
        T* base = reinterpret_cast<T*>(smem);
        xs = base;
        x2s = PAIRED ? xs + TE : nullptr;
        ys = xs + Smem<T, DH, PAIRED>::OWN * TE;
        y2s = ys + TE;
        ring_own = y2s + TE;
        ring_other = ring_own + 3 * TE;
        gs = reinterpret_cast<float*>(ring_other + 3 * TE);
        dsk = reinterpret_cast<T*>(gs);
        col = reinterpret_cast<float*>(reinterpret_cast<char*>(gs) +
                                       Smem<T, DH, PAIRED>::SHARED);
    }

    // own-term chunk c covers table rows T-64-64 o + 64 c (ring slot c % 3);
    // other-term chunk c (-1 <= c < T / 64) rows T-64+64 o-64 c (slot (c+1) % 3)
    __device__ __forceinline__ void load_own_chunk(const Frame<T, DH>& f, int c) const {
        copy_tile<T, DH>(ring_own + (c % 3) * TE, f.own_tab, f.d_model,
                         f.t_len - BLOCK - BLOCK * f.own_tile + BLOCK * c, 2 * f.t_len);
    }
    __device__ __forceinline__ void load_other_chunk(const Frame<T, DH>& f, int c) const {
        copy_tile<T, DH>(ring_other + ((c + 1) % 3) * TE, f.other_tab, f.d_model,
                         f.t_len - BLOCK + BLOCK * f.own_tile - BLOCK * c, 2 * f.t_len);
    }
    __device__ __forceinline__ void load_y(const Frame<T, DH>& f, int i) const {
        copy_tile<T, DH>(ys, f.y, f.d_model, BLOCK * i, f.t_len);
    }
    __device__ __forceinline__ void load_y2(const Frame<T, DH>& f, int i) const {
        copy_tile<T, DH>(y2s, f.y2, f.d_model, BLOCK * i, f.t_len);
    }
    __device__ __forceinline__ void load_walked(const Frame<T, DH>& f, int i) const {
        load_y(f, i);
        load_y2(f, i);
    }
    // the first step's band chunks: own 0 and 1, other -1 and 0
    __device__ __forceinline__ void load_first_bands(const Frame<T, DH>& f) const {
        load_own_chunk(f, 0);
        load_own_chunk(f, 1);
        load_other_chunk(f, -1);
        load_other_chunk(f, 0);
    }
    // the backward's first step: own tiles, walked tiles 0, bands; one
    // commit group
    __device__ __forceinline__ void load_first(const Frame<T, DH>& f) const {
        copy_tile<T, DH>(xs, f.x, f.d_model, BLOCK * f.own_tile, f.t_len);
        copy_tile<T, DH>(x2s, f.x2, f.d_model, BLOCK * f.own_tile, f.t_len);
        load_walked(f, 0);
        load_first_bands(f);
        mmd_tc::cp_async_commit();
    }
    // step i's bands: own chunks i, i + 1; other chunks i, i - 1
    __device__ __forceinline__ Band<T, DH> own_band(int i) const {
        return {ring_own + (i % 3) * TE, ring_own + ((i + 1) % 3) * TE};
    }
    __device__ __forceinline__ Band<T, DH> other_band(int i) const {
        return {ring_other + ((i + 1) % 3) * TE, ring_other + (i % 3) * TE};
    }
};

// C fragments (16 rows from m0, 8N columns from n0) into the band scores'
// tile.
template <int N>
__device__ __forceinline__ void store_g(float* gs, const float (&c)[N][4], int m0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(gs + (m0 + g + 8 * h) * G_LD + n0 + 8 * nt + 2 * q) =
                make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
}

// A (this warp's 16 rows from m0) . the warp's window of the band^T into
// the band scores' tile, in two products (48 and 32 columns: fewer
// accumulators live at once).
template <typename T, int DH>
__device__ __forceinline__ void band_scores(float* gs, const typename Ops<T, DH>::A& a,
                                            const Band<T, DH>& band, int m0) {
    using BO = BandOps<T, DH>;
    const int n0 = 48 - m0;
    {
        float c[6][4];
        zero(c);
        BO::template scores<6>(c, a, band, n0);
        store_g(gs, c, m0, 0);
    }
    float c[4][4];
    zero(c);
    BO::template scores<4>(c, a, band, n0 + 48);
    store_g(gs, c, m0, 48);
}

// The unscaled scores of this warp's 16 rows against the walked tile:
// content X Y^T, the own term (this warp's rows of X . band^T, each score
// taking element (r, 63 - r + c): local column 15 - r % 16 + c of the
// window) and the other term (the walked tile's rows of Y . other band^T,
// written by their warps; score (r, c) takes element (c, 63 - c + r)).
// Ends with every warp past one barrier and the tile still being read.
template <typename T, int DH, bool PAIRED>
__device__ __forceinline__ void tile_scores(float (&s)[NT][4], const Shared<T, DH, PAIRED>& sh,
                                            int i) {
    using Op = Ops<T, DH>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int m0 = 16 * warp;
    zero(s);
    {
        typename Op::A xa;
        Op::load_a(xa, sh.xs, m0);
        Op::template scores<NT>(s, xa, sh.ys);
        band_scores<T, DH>(sh.gs, xa, sh.own_band(i), m0);
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1);
            s[nt][e] += sh.gs[(m0 + r) * G_LD + 15 - r + 8 * nt + 2 * q + (e & 1)];
        }
    __syncwarp();
    {
        typename Op::A ya;
        Op::load_a(ya, sh.ys, m0);
        band_scores<T, DH>(sh.gs, ya, sh.other_band(i), m0);
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 8 * nt + 2 * q + (e & 1);
            s[nt][e] += sh.gs[c * G_LD + 15 - (c & 15) + m0 + g + 8 * (e >> 1)];
        }
}

// C fragments of 16 rows (from row m0 of `dst`, row stride ld) to memory.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, int64_t ld, const float (&acc)[DH / 8][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt)
            store2(dst + (g + 8 * h) * ld + 8 * nt + 2 * q, acc[nt][2 * h], acc[nt][2 * h + 1]);
}

}  // namespace mmd_deberta
