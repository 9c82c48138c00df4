// The forward of both Swinv2 window attentions, for Hopper (sm_90a): the
// serving kernel #7 (swin_window_attn.cu) and the fine-tuning forward #8
// (swin_window_attn_train.cu) run this one body, which differs only in how
// it makes the log2-domain scores s2 of a (window w, batch row, head h):
//   Inputs::kNormalized (#8): q' arrives L2-normalized per head and scaled
//     by the clamped logit scale times log2(e), k L2-normalized, the bias
//     per window in the log2 domain:
//       s2[i, j] = q'_i . k_j + bias[w, h, i, j]
//   Inputs::kRaw (#7): q and k arrive as the projections leave them, with
//     the clamped logit scale exp(min(logit_scale_h, ln 100)) per head and a
//     natural-log bias, one tile per window (shifted blocks: the position
//     bias plus twice the shift mask) or one for every window (bw = 0):
//       s2[i, j] = (q_i . k_j) * (scale[h] log2(e) / max(|q_i|, 1e-12))
//                  * (1 / max(|k_j|, 1e-12)) + log2(e) bias[bw, h, i, j]
// and then, for both,
//   o_i = sum_j exp2(s2[i, j] - m_i) v_j / max(sum_j exp2(s2[i, j] - m_i), 1e-37).
// The cosine normalization is folded into the scores: the products run on
// the raw tiles as they land, and the norms (fp32, from the tile's values
// in the input dtype) scale the fragment of scores afterwards. Normalizing
// first, as the TPU kernel does, would round q^ scale log2(e) to bf16
// before its product: at logit scale 100 that moves s2 by ~0.05.
//
// The design (n = 64, dh in {32, 64}):
//   * one CTA of 4 warps per (head, window, group of batch rows); it walks
//     the group's rows, which takes the place of the TPU grid's batch
//     blocks. Each warp owns 16 of the window's 64 query rows and runs its
//     products on the tensor cores through flash_common.cuh (bf16 mma.sync
//     m16n8k16; fp32 as 3xTF32 on m16n8k8); the weights stay in registers
//     from `scores` to `pv`;
//   * the (bw, h) bias tile is read from device memory once per CTA into
//     registers in the C-fragment layout of the scores (32 floats a
//     thread), under the first copy, and added to every row of the group;
//   * q, k and v are copied in the input dtype by cp.async into two
//     shared-memory stages: the next batch row's tiles land while this row
//     computes;
//   * kRaw's norms: a query row's squares come from the A fragment (bf16)
//     or the warp's rows of the tile (fp32), summed over the 4 lanes of the
//     row by two shuffles; every warp computes the 64 keys' norms itself,
//     lane l those of keys l and l + 32 (16-byte rows read without bank
//     conflicts), and hands each lane the 16 it needs by shuffles: no
//     barrier;
//   * row max and sums in fp32 over the 4 lanes of a row; in bf16 the
//     unnormalized P is rounded to bf16 before P V and l is the fp32 sum of
//     the unrounded weights, as the TPU kernel's p16 and ls; no atomics, so
//     the results are deterministic.
//
// Larger windows (n = 64 T, T > 1: 16 x 16 windows n 256, 24 x 24 n 576,
// 32 x 32 n 1024) run `forward_blocked`: a window's scores no longer fit a
// warp's registers (16 rows x n keys: 128 floats a thread at n 256), so
//   * one CTA of 4 warps per (query tile of 64 rows, head, window, group of
//     batch rows), each warp 16 rows, the same products as above;
//   * it walks the window's keys in blocks of 64, an online softmax per row
//     (exp2, fp32 running max m and sum l, acc rescaled by exp2(m_old -
//     m_new); the final sum floored at 1e-37). It keeps the running max:
//     in bf16 the weight rounded before P V is exp2(s - m_running), not the
//     TPU's exp2(s - m_final) -- the same relative rounding, at another
//     point; tests/test_torch_swin_blocked_mirror.py mirrors this order;
//   * the bias is read per key block (the 16 x 64 part a warp needs, 32
//     floats a thread, issued before the block's copy is awaited), not held
//     for the whole window;
//   * the k and v blocks come by cp.async through a ring of two stages, the
//     query tile of each batch row into one of two buffers by the row's
//     parity: the next block lands while this one computes;
//   * kRaw's norms per key block as above (raw_factors: the block's keys,
//     and the query rows' again).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace mmd_swin {

namespace F = mmd_flash;

constexpr int N = 64;                        // tokens per window (8 x 8)

enum class Inputs { kNormalized, kRaw };

template <typename T, int DH>
constexpr size_t fwd_smem_bytes() {
    return 2 * 3 * F::Tile<T, DH>::BYTES;    // two stages of q, k and v tiles
}

// Sums of squares for kRaw's norms, in fp32 from the input dtype's values.
template <typename T, int DH>
struct Squares;

template <int DH>
struct Squares<F::bf16, DH> {
    // This lane's part of the squares of the warp's rows g (ss[0]) and g + 8
    // (ss[1]), from the A fragment: a0, a2 hold row g, a1, a3 row g + 8.
    __device__ __forceinline__ static void rows(float (&ss)[2],
                                                const typename F::Ops<F::bf16, DH>::A& a) {
        ss[0] = ss[1] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 x =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.f[ks][i]));
                ss[i & 1] = fmaf(x.x, x.x, ss[i & 1]);
                ss[i & 1] = fmaf(x.y, x.y, ss[i & 1]);
            }
    }

    // The squares of one tile row, 16 bytes a load.
    __device__ __forceinline__ static float row(const F::bf16* r) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 8) {
            const uint4 u = *reinterpret_cast<const uint4*>(r + c);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 x = __bfloat1622float2(h[i]);
                s = fmaf(x.x, x.x, s);
                s = fmaf(x.y, x.y, s);
            }
        }
        return s;
    }
};

template <int DH>
struct Squares<float, DH> {
    // This lane's part of the squares of the warp's rows g and g + 8: the
    // columns 4 i + q, read from the tile (row stride = 4 mod 32 words: the
    // 32 lanes hit 32 banks).
    __device__ __forceinline__ static void rows(float (&ss)[2],
                                                const typename F::Ops<float, DH>::A& a) {
        constexpr int LD = F::Tile<float, DH>::LD;
        const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float* x = a.s + (a.m0 + g + 8 * r) * LD + q;
            ss[r] = 0.f;
#pragma unroll
            for (int i = 0; i < DH / 4; ++i) ss[r] = fmaf(x[4 * i], x[4 * i], ss[r]);
        }
    }

    __device__ __forceinline__ static float row(const float* r) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(r + c);
            s = fmaf(x.x, x.x, s);
            s = fmaf(x.y, x.y, s);
            s = fmaf(x.z, x.z, s);
            s = fmaf(x.w, x.w, s);
        }
        return s;
    }
};

// kRaw's factors for one batch row: qf[r] = scale[h] log2(e) / max(|q|, 1e-12)
// for the lane's rows g + 8 r, kf[nt][e] = 1 / max(|k|, 1e-12) for its score
// columns 8 nt + 2 q + e.
template <typename T, int DH>
__device__ __forceinline__ void raw_factors(float (&qf)[2], float (&kf)[F::NT][2],
                                            const typename F::Ops<T, DH>::A& qa, const T* ks,
                                            float qscale) {
    constexpr int LD = F::Tile<T, DH>::LD;
    const int lane = threadIdx.x & 31, q = lane & 3;
    float ss[2];
    Squares<T, DH>::rows(ss, qa);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 1);
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 2);
        qf[r] = qscale / fmaxf(sqrtf(ss[r]), 1e-12f);
    }
    // lane l: keys l and l + 32; the lane holding key j is j mod 32
    const float k0 = 1.f / fmaxf(sqrtf(Squares<T, DH>::row(ks + lane * LD)), 1e-12f);
    const float k1 = 1.f / fmaxf(sqrtf(Squares<T, DH>::row(ks + (lane + 32) * LD)), 1e-12f);
#pragma unroll
    for (int nt = 0; nt < F::NT; ++nt) {
        const int src = (8 * nt + 2 * q) & 31;
        const float kn = nt < F::NT / 2 ? k0 : k1;
        kf[nt][0] = __shfl_sync(0xffffffffu, kn, src);
        kf[nt][1] = __shfl_sync(0xffffffffu, kn, src + 1);
    }
}

// The body of both kernels (see the top of the file). Grid (heads, windows,
// groups), F::THREADS threads, fwd_smem_bytes<T, DH>() of dynamic shared
// memory; each CTA walks per_group batch rows. scale and shared_bias are
// kRaw's (shared_bias: one bias tile for every window).
template <typename T, int DH, Inputs IN>
__device__ __forceinline__ void forward(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const float* __restrict__ bias,
                                        const float* __restrict__ scale, T* __restrict__ o,
                                        int batch, int heads, bool shared_bias, int per_group) {
    static_assert(N == F::BLOCK, "a window is one tile of the flash products");
    constexpr bool RAW = IN == Inputs::kRaw;
    using Op = F::Ops<T, DH>;
    constexpr int TE = F::Tile<T, DH>::ELEMS;
    constexpr int NT = F::NT;
    extern __shared__ float4 smem4[];
    T* tiles = reinterpret_cast<T*>(smem4);  // [2 stages][q, k, v][N][LD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int h = blockIdx.x;
    const int w = blockIdx.y;
    const int b0 = blockIdx.z * per_group;
    const int c = heads * DH;
    // the (window, batch row b) tile of this head starts at row_base(b)
    const size_t head_base = static_cast<size_t>(w) * batch * N * c + static_cast<size_t>(h) * DH;
    auto row_base = [&](int b) { return head_base + static_cast<size_t>(b) * N * c; };
    auto copy_row = [&](int stage, int b) {
        T* s = tiles + stage * 3 * TE;
        const size_t off = row_base(b);
        F::copy_tile<T, DH>(s, q + off, c, 0, N);
        F::copy_tile<T, DH>(s + TE, k + off, c, 0, N);
        F::copy_tile<T, DH>(s + 2 * TE, v + off, c, 0, N);
    };
    copy_row(0, b0);
    mmd_tc::cp_async_commit();

    // The warp's 16 bias rows, once for the group, at the score fragment's
    // (row g + 8 r, key 8 nt + 2 qd + {0, 1}), under the first copy; kRaw's
    // in the log2 domain.
    const int bw = RAW && shared_bias ? 0 : w;
    float bs[NT][4];
    const float* bt = bias + ((static_cast<size_t>(bw) * heads + h) * N + 16 * warp + g) * N + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(bt + 8 * r * N + 8 * nt));
            if constexpr (RAW) {
                bs[nt][2 * r] = x.x * F::LOG2E;
                bs[nt][2 * r + 1] = x.y * F::LOG2E;
            } else {
                bs[nt][2 * r] = x.x;
                bs[nt][2 * r + 1] = x.y;
            }
        }
    float qscale = 0.f;
    if constexpr (RAW) qscale = __ldg(scale + h) * F::LOG2E;

    for (int i = 0; i < per_group; ++i) {
        const int cur = i & 1;
        if (i + 1 < per_group) copy_row(cur ^ 1, b0 + i + 1);   // under this row's work
        mmd_tc::cp_async_commit();
        mmd_tc::cp_async_wait<1>();          // this row's tiles have landed
        __syncthreads();
        const T* qs = tiles + cur * 3 * TE;

        typename Op::A qa;
        Op::load_a(qa, qs, 16 * warp);
        float sc[NT][4];
        F::zero(sc);
        Op::template scores<NT>(sc, qa, qs + TE);
        if constexpr (RAW) {
            float qf[2], kf[NT][2];
            raw_factors<T, DH>(qf, kf, qa, qs + TE, qscale);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sc[nt][e] = fmaf(sc[nt][e] * qf[e >> 1], kf[nt][e & 1], bs[nt][e]);
        } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[nt][e] += bs[nt][e];
        }
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        float l[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(sc[nt][e] - mx[e >> 1]);
                l[e >> 1] += p;              // the fp32 weights, as the TPU kernel sums them
                sc[nt][e] = p;
            }
        float acc[DH / 8][4];
        F::zero(acc);
        Op::template pv<NT>(acc, sc, qs + 2 * TE);

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            const float inv = 1.f / fmaxf(l[r], 1e-37f);
            T* orow = o + row_base(b0 + i) + static_cast<size_t>(16 * warp + g + 8 * r) * c;
#pragma unroll
            for (int n = 0; n < DH / 8; ++n)
                F::store2(orow + 8 * n + 2 * qd, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        }
        __syncthreads();                     // this stage is free for the row after next
    }
}

// -- n = 64 T, T > 1 ----------------------------------------------------------

template <typename T, int DH>
constexpr size_t blocked_fwd_smem_bytes() {
    return 2 * F::Tile<T, DH>::BYTES         // the query tiles of two batch rows
           + 2 * 2 * F::Tile<T, DH>::BYTES;  // two stages of k and v blocks
}

// The body of both kernels for n = 64 T, T > 1 (see the top of the file).
// Grid (heads x T, windows, groups): blockIdx.x = h T + query tile;
// F::THREADS threads, blocked_fwd_smem_bytes<T, DH>() of dynamic shared
// memory; each CTA walks per_group batch rows, each of them T key blocks.
template <typename T, int DH, Inputs IN>
__device__ __forceinline__ void forward_blocked(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v,
                                                const float* __restrict__ bias,
                                                const float* __restrict__ scale,
                                                T* __restrict__ o, int batch, int heads, int n,
                                                bool shared_bias, int per_group) {
    constexpr bool RAW = IN == Inputs::kRaw;
    using Op = F::Ops<T, DH>;
    constexpr int TE = F::Tile<T, DH>::ELEMS;
    constexpr int NT = F::NT;
    extern __shared__ float4 smem4[];
    T* qbuf = reinterpret_cast<T*>(smem4);   // [2 rows][N][LD]
    T* ring = qbuf + 2 * TE;                 // [2 stages][k, v][N][LD]

    const int tiles = n / N;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int h = blockIdx.x / tiles, qt = blockIdx.x - h * tiles;
    const int w = blockIdx.y;
    const int b0 = blockIdx.z * per_group;
    const int c = heads * DH;
    const size_t head_base = static_cast<size_t>(w) * batch * n * c + static_cast<size_t>(h) * DH;
    auto row_base = [&](int b) { return head_base + static_cast<size_t>(b) * n * c; };
    const int steps = per_group * tiles;     // (batch row, key block) in order
    auto copy_step = [&](int s) {
        const int i = s / tiles, kt = s - i * tiles;
        const size_t off = row_base(b0 + i);
        T* st = ring + (s & 1) * 2 * TE;
        F::copy_tile<T, DH>(st, k + off, c, N * kt, n);
        F::copy_tile<T, DH>(st + TE, v + off, c, N * kt, n);
        if (kt == 0) F::copy_tile<T, DH>(qbuf + (i & 1) * TE, q + off, c, N * qt, n);
    };
    copy_step(0);
    mmd_tc::cp_async_commit();

    // this lane's bias rows (query N qt + 16 warp + g + 8 r) of the (bw, h)
    // tile; a key block's part at + N kt
    const int bw = RAW && shared_bias ? 0 : w;
    const float* bt = bias +
                      (static_cast<size_t>(bw * heads + h) * n + N * qt + 16 * warp + g) * n +
                      2 * qd;
    float qscale = 0.f;
    if constexpr (RAW) qscale = __ldg(scale + h) * F::LOG2E;

    typename Op::A qa;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, acc[DH / 8][4];
    for (int s = 0; s < steps; ++s) {
        const int i = s / tiles, kt = s - i * tiles;
        if (s + 1 < steps) copy_step(s + 1);  // under this block's work
        mmd_tc::cp_async_commit();
        float bs[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float2 x = __ldg(reinterpret_cast<const float2*>(
                    bt + static_cast<size_t>(8 * r) * n + N * kt + 8 * nt));
                bs[nt][2 * r] = RAW ? x.x * F::LOG2E : x.x;
                bs[nt][2 * r + 1] = RAW ? x.y * F::LOG2E : x.y;
            }
        mmd_tc::cp_async_wait<1>();          // this block's tiles have landed
        __syncthreads();
        const T* ks = ring + (s & 1) * 2 * TE;
        if (kt == 0) {                       // a new batch row
            Op::load_a(qa, qbuf + (i & 1) * TE, 16 * warp);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = -CUDART_INF_F;
                l[r] = 0.f;
            }
            F::zero(acc);
        }
        float sc[NT][4];
        F::zero(sc);
        Op::template scores<NT>(sc, qa, ks);
        if constexpr (RAW) {
            // the query norms again with each block's key norms: a few
            // FMAs a row beside the block's products
            float qf[2], kf[NT][2];
            raw_factors<T, DH>(qf, kf, qa, ks, qscale);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sc[nt][e] = fmaf(sc[nt][e] * qf[e >> 1], kf[nt][e & 1], bs[nt][e]);
        } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[nt][e] += bs[nt][e];
        }
        float bm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], sc[nt][e]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
            const float m_new = fmaxf(mx[r], bm[r]);
            alpha[r] = exp2f(mx[r] - m_new);  // 0 at the first block
            mx[r] = m_new;
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(sc[nt][e] - mx[e >> 1]);
                l[e >> 1] += p;              // the fp32 weights
                sc[nt][e] = p;
            }
#pragma unroll
        for (int d = 0; d < DH / 8; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
        Op::template pv<NT>(acc, sc, ks + TE);

        if (kt == tiles - 1) {               // the row's last key block
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                const float inv = 1.f / fmaxf(l[r], 1e-37f);
                T* orow = o + row_base(b0 + i) +
                          static_cast<size_t>(N * qt + 16 * warp + g + 8 * r) * c;
#pragma unroll
                for (int d = 0; d < DH / 8; ++d)
                    F::store2(orow + 8 * d + 2 * qd, acc[d][2 * r] * inv,
                              acc[d][2 * r + 1] * inv);
            }
        }
        __syncthreads();                     // this stage is free for the block after next
    }
}

// Above 48 KB of dynamic shared memory a kernel has to be allowed it, once
// per device: `raised`, the caller's own for each kernel, holds a bit for
// each device where that is done.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int device, std::atomic<uint64_t>& raised) {
    const uint64_t bit = uint64_t{1} << device;
    if (smem <= 48 * 1024 || (raised.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
    return err;
}

// The checks of the entry points (n = 64, or 64 T for `forward_blocked`
// and the blocked backward), then `device` made current if it is not
// already.
inline cudaError_t enter(int windows, int batch, int n, int heads, int groups, int device) {
    if (n < N || n % N != 0 || n > 65535 || windows <= 0 || windows > 65535 || batch <= 0 ||
        batch > 65535 || heads <= 0 || heads > 65535 || groups <= 0 || groups > 65535 ||
        batch % groups != 0 || device < 0 || device >= 64) {
        return cudaErrorInvalidValue;
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return err;
}

}  // namespace mmd_swin
