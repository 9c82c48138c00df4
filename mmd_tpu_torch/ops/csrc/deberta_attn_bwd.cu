// DeBERTa-v3 disentangled attention backward for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces mmd_tpu/models/deberta.py::_deberta_attn_fused_bwd_call (its
// Pallas body _deberta_attn_bwd_kernel, behind the custom VJP
// _deberta_attn_trainable) on the fine-tuning path: the backward of every
// one of DeBERTa-v3-xsmall's 12 attentions.
//
// What it computes, per batch row b and head h, for query t and key s of a
// length-T sequence, from q, k, v (B, T, D), the (2T, D) tables PK and PQ,
// the (B, T) key mask and the output gradient do:
//   score[t, s] = (q_t . k_s + q_t . PK[T-1-t+s] + k_s . PQ[T-1-s+t]) * scale
//                 (finfo(float32).min where key s is masked)
//   P = softmax_s(score),  dP[t, s] = do_t . v_s,  D_t = sum_s P dP
//   ds[t, s] = P (dP - D_t) * scale, 0 where key s is masked
//   dv_s  = sum_t P[t, s] do_t
//   dq_t  = sum_s ds[t, s] (k_s + PK[T-1-t+s])
//   dk_s  = sum_t ds[t, s] (q_t + PQ[T-1-s+t])
//   dPK[r] = sum_b sum_{T-1-t+s=r} ds[t, s] q_t
//   dPQ[r] = sum_b sum_{T-1-s+t=r} ds[t, s] k_s
// The scores are recomputed from the operands, so nothing T x T sized
// crosses device memory, and D_t comes from P and dP themselves (not from
// the forward's rounded output). A row with no valid key has the uniform P
// of the forward; its ds is zero, as the reference's `where` makes it. dq,
// dk, dv are written in the input dtype, dPK and dPQ in fp32.
//
// The position terms as band products. For the 64-row tile pair (t0, s0)
// the PK rows that serve it are the 128-row band from T-64-t0+s0, and
// local band row 63 - r + c serves pair (r, c); the PQ band starts at
// T-64-s0+t0, and row 63 - c + r serves (r, c). So, with 64-row tiles:
//   c2p  = diag(Q_tile PK_band^T):   score (r, c) takes element (r, 63-r+c)
//   p2c  = diag(K_tile PQ_band^T)^T: score (r, c) takes element (c, 63-c+r)
//   dSk[r][63 - r + c] = dS[r][c], 0 elsewhere (64 x 128): then
//   dq  += dS K + dSk PK_band,  dPK_band += dSk^T Q_tile,
// and the same with dS^T, K and PQ for dk and dPQ. Each band of a CTA's
// walk overlaps the next by 64 rows, so a CTA sums its band gradients in
// registers and writes each row of its own (T + 64)-row slice once.
//
// On the TPU the grid runs in order over the batch and the kernel adds each
// row's table gradients into one revisited output block. Blocks on Hopper
// run in no order, so the table gradients go through the slices and a
// fixed-order sum, with no atomics: the result is the same every run.
//   1. stats   one CTA per (64-query tile, head, b) walks the key tiles
//              with an online softmax: row max m and 1/l of the log2-domain
//              scores, and D = sum P dP, into a (3, B, H, T) fp32 scratch;
//   2. grad    one launch, two kinds of CTA. dq: one CTA per (query tile,
//              head, b) walks the key tiles, recomputes P and dS, keeps dq
//              in registers and writes the dPK slice. dk/dv: one CTA per
//              (key tile, head, b) does the same in the transposed frame,
//              where rows are keys: K for Q, V for dO, Q and dO walked, PQ
//              for PK and the columns' statistics; it writes dk, dv and the
//              dPQ slice. The same code serves both;
//   3. reduce  dPK[r] and dPQ[r] = the sum over b, then over tiles, of the
//              slices' rows that map to r.
//
// What bounds it on this card: the tensor cores. Counted as the TPU kernel
// counts it, 20 * B * T^2 * D operations against 8 * B * T * D elements of
// q, k, v, do and their gradients: at the fine-tuning shape (B 8, T 256,
// D 384) ~640 operations per bf16 byte, above the ~295 where the tensor
// cores and not device memory are the limit. The three passes recompute
// the scores three times, the band products cover 80 of the 128 band rows
// a warp (5/4 of the 64 x 64 x dh of a content product), and in bf16 dS
// goes into its products as hi + lo (below): ~2.3x the TPU kernel's count.
// The slices are 2 * B * (T / 64) * (T + 64) * D fp32, written once and
// read once by the reduce (63 MB a call at the fine-tuning shape).
//
// What the design does about that:
//   * 4 warps a CTA, 16 rows of its own tile each, as the flash kernels
//     (flash_common.cuh): every product on mma.sync, bf16 m16n8k16 with
//     fp32 accumulators, fp32 as 3xTF32 on m16n8k8; tiles kept in the input
//     dtype in shared memory (rows padded by 16 bytes);
//   * the band products cover each warp's window: rows r of warp w serve
//     band rows [48 - 16w, 128 - 16w), 80 rows (10 n8 tiles, 5 k16 steps);
//     of the band gradient, warp w owns band rows [16w, +16) and [64 + 16w,
//     +16), whose dS rows span 16(w + 1) and 16(4 - w) rows: 80 a warp;
//   * the bands come from a ring of three 64-row chunks per table; each
//     step loads one chunk of each with cp.async a step ahead, and the
//     walked tiles' copies for the next step start as soon as the step's
//     last product that reads them is done;
//   * c2p and p2c leave their mma as C fragments in registers and go
//     through a 64 x 88 fp32 tile in shared memory, where each score
//     fragment reads its diagonal element. 88 floats a row (24 mod 32):
//     the 8-byte fragment stores are free of bank conflicts, the diagonal
//     reads 2-way (a row stride that is free for both would have to be
//     0 mod 4 for the stores and odd for the reads);
//   * dSk shares that space: each warp zero-fills its rows' window and
//     scatters its dS fragments on the diagonal; 136 bf16 (272 bytes) or
//     132 fp32 a row, so ldmatrix and the fp32 transposed loads read
//     without bank conflicts;
//   * rounding points in bf16: P is rounded to bf16 as the A operand of
//     dV += P^T dO, as the flash backward does; dS goes into dq, dk, dPK
//     and dPQ as bf16 hi + bf16 lo (two products), which keeps its fp32
//     value to ~2^-17: the table gradients are held to fp32 tolerances;
//   * the grid: at the fine-tuning shape 192 stats CTAs and 384 grad CTAs
//     (bf16 dh 64: 113 KB of shared memory each, two an SM).
// The tiles, band rings and score products (Band, BandOps, Shared,
// tile_scores) are deberta_common.cuh's, shared with the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "deberta_common.cuh"

namespace {

using namespace mmd_deberta;

constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float round_as(float x, float*) { return x; }
__device__ __forceinline__ float round_as(float x, bf16*) {
    return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
struct Params {
    const T *q, *k, *v, *pk, *pq, *dout;
    const uint8_t* key_valid;
    float* stats;                // (3, B, H, T): m (log2 domain), 1 / l, D
    float* ws;                   // (2, B, T / 64, T + 64, D): the dPK, dPQ slices
    T *dq, *dk, *dv;
    int batch, t_len, num_heads;
    float scale, scale_log2;
};

// dP (or dP^T) of this warp's rows: X2 Y2^T
template <typename T, int DH>
__device__ __forceinline__ void tile_dp(float (&dp)[NT][4], const Shared<T, DH, true>& sh) {
    using Op = Ops<T, DH>;
    zero(dp);
    typename Op::A a;
    Op::load_a(a, sh.x2s, 16 * (threadIdx.x >> 5));
    Op::template scores<NT>(dp, a, sh.y2s);
}

// ---------------------------------------------------------------------------
// 1. row statistics: m (log2 domain), 1 / l and D = sum_s P dP
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_bwd_stats_kernel(const Params<T> p) {
    extern __shared__ float4 smem4[];
    const Shared<T, DH, true> sh(smem4);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int o = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_len = p.t_len, d_model = p.num_heads * DH, n = t_len / BLOCK;
    const size_t row0 = static_cast<size_t>(b) * t_len * d_model + static_cast<size_t>(h) * DH;
    const Frame<T, DH> f{p.q + row0, p.dout + row0, p.k + row0, p.v + row0,
                         p.pk + static_cast<size_t>(h) * DH, p.pq + static_cast<size_t>(h) * DH,
                         o, t_len, d_model};
    const uint8_t* mb = p.key_valid + static_cast<size_t>(b) * t_len;
    float* kvalid = sh.col;
    sh.load_first(f);

    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f},
          d_run[2] = {0.f, 0.f};
    for (int i = 0; i < n; ++i) {
        mmd_tc::cp_async_wait_all();
        __syncthreads();
        if (i + 1 < n) {
            sh.load_own_chunk(f, i + 2);
            sh.load_other_chunk(f, i + 1);
        }
        mmd_tc::cp_async_commit();
        if (tid < BLOCK) kvalid[tid] = mb[BLOCK * i + tid] != 0 ? 1.f : 0.f;
        float s[NT][4], dp[NT][4];
        tile_scores<T, DH>(s, sh, i);
        tile_dp<T, DH>(dp, sh);
        __syncthreads();                     // the band scores' tile and Y, Y2 are free
        if (i + 1 < n) sh.load_walked(f, i + 1);
        mmd_tc::cp_async_commit();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = NEG;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                    const int c = 8 * nt + 2 * qd + (e & 1);
                    s[nt][e] = kvalid[c] != 0.f ? s[nt][e] * p.scale_log2 : NEG;
                    mx = fmaxf(mx, s[nt][e]);
                }
            // the 4 lanes of a row are one quad
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[hr], mx);
            const float alpha = exp2f(m_run[hr] - m_new);
            float psum = 0.f, dsum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                    const float pe = exp2f(s[nt][e] - m_new);
                    psum += pe;
                    dsum = fmaf(pe, dp[nt][e], dsum);
                }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
                dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
            }
            l_run[hr] = l_run[hr] * alpha + psum;
            d_run[hr] = d_run[hr] * alpha + dsum;
            m_run[hr] = m_new;
        }
    }
    mmd_tc::cp_async_wait_all();
    if (qd == 0) {
        const size_t rows = static_cast<size_t>(p.batch) * p.num_heads * t_len;
        const size_t r0 = (static_cast<size_t>(b) * p.num_heads + h) * t_len + BLOCK * o +
                          16 * warp + g;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const float inv = 1.f / l_run[hr];   // l >= 1: the row max contributes exp2(0)
            p.stats[r0 + 8 * hr] = m_run[hr];
            p.stats[rows + r0 + 8 * hr] = inv;
            p.stats[2 * rows + r0 + 8 * hr] = d_run[hr] * inv;
        }
    }
}

// ---------------------------------------------------------------------------
// 2. gradients: dq and the dPK slices (KEYS false), dk, dv and the dPQ
//    slices (KEYS true, the transposed frame)
// ---------------------------------------------------------------------------

// dS (or, as lo, what bf16 rounding left of it) of this warp's fragments
// onto the diagonal of dSk: dSk[r][63 - r + c] = w[r][c].
template <typename T>
__device__ __forceinline__ void skew_store(T* dsk, const float (&w)[NT][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + g + 8 * (e >> 1);
            put(dsk + r * Skew<T>::LD + BLOCK - 1 - r + 8 * nt + 2 * q + (e & 1), w[nt][e]);
        }
}

// Zeros over this warp's rows of dSk, columns [48 - 16 w, 128 - 16 w).
template <typename T>
__device__ __forceinline__ void zero_window(T* dsk) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
    constexpr int CH = WIN / PER;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * CH; idx += 32) {
        const int r = 16 * warp + idx / CH;
        *reinterpret_cast<uint4*>(dsk + r * Skew<T>::LD + 48 - 16 * warp + (idx % CH) * PER) =
            make_uint4(0u, 0u, 0u, 0u);
    }
}

template <typename T, int DH, bool KEYS>
__device__ __forceinline__ void grad_cta(const Params<T>& p, int o, int h, int b) {
    using Op = Ops<T, DH>;
    using BO = BandOps<T, DH>;
    constexpr bool SPLIT = sizeof(T) == 2;   // dS as bf16 hi + lo
    extern __shared__ float4 smem4[];
    const Shared<T, DH, true> sh(smem4);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int t_len = p.t_len, d_model = p.num_heads * DH, n = t_len / BLOCK;
    const size_t head = static_cast<size_t>(h) * DH;
    const size_t row0 = static_cast<size_t>(b) * t_len * d_model + head;
    const Frame<T, DH> f = KEYS
        ? Frame<T, DH>{p.k + row0, p.v + row0, p.q + row0, p.dout + row0, p.pq + head,
                       p.pk + head, o, t_len, d_model}
        : Frame<T, DH>{p.q + row0, p.dout + row0, p.k + row0, p.v + row0, p.pk + head,
                       p.pq + head, o, t_len, d_model};
    const uint8_t* mb = p.key_valid + static_cast<size_t>(b) * t_len;
    const size_t rows = static_cast<size_t>(p.batch) * p.num_heads * t_len;
    const float* stats = p.stats + (static_cast<size_t>(b) * p.num_heads + h) * t_len;
    // this CTA's slice: (T + 64) rows, row 0 at table row T - 64 - 64 o
    float* slice = p.ws + (KEYS ? static_cast<size_t>(p.batch) * n * (t_len + BLOCK) * d_model : 0)
                   + (static_cast<size_t>(b) * n + o) * (t_len + BLOCK) * d_model + head;
    float* col = sh.col;                     // dq: key valid; dk/dv: m, 1/l, D of the queries
    sh.load_first(f);

    // this lane's own rows: 16 warp + g and + 8
    const int own0 = BLOCK * o + 16 * warp + g;
    float rm[2], ril[2], rd[2];              // dq: the rows' statistics
    bool rok[2];                             // dk/dv: the rows' keys are valid
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int t = own0 + 8 * hr;
        if constexpr (KEYS) {
            rok[hr] = mb[t] != 0;
        } else {
            rm[hr] = stats[t];
            ril[hr] = stats[rows + t];
            rd[hr] = stats[2 * rows + t];
        }
    }

    float acc[DH / 8][4], dv_acc[DH / 8][4], band_lo[DH / 8][4], band_hi[DH / 8][4];
    zero(acc);
    zero(band_lo);
    zero(band_hi);
    if constexpr (KEYS) zero(dv_acc);

    for (int i = 0; i < n; ++i) {
        mmd_tc::cp_async_wait_all();
        __syncthreads();                     // the step's tiles have landed; dSk is free
        if (i + 1 < n) {
            sh.load_own_chunk(f, i + 2);
            sh.load_other_chunk(f, i + 1);
        }
        mmd_tc::cp_async_commit();
        if (tid < BLOCK) {
            const int t = BLOCK * i + tid;
            if constexpr (KEYS) {
                col[tid] = stats[t];
                col[BLOCK + tid] = stats[rows + t];
                col[2 * BLOCK + tid] = stats[2 * rows + t];
            } else {
                col[tid] = mb[t] != 0 ? 1.f : 0.f;
            }
        }
        float s[NT][4], w[NT][4];
        tile_scores<T, DH>(s, sh, i);
        tile_dp<T, DH>(w, sh);
        // s <- P (or P^T), w <- dS (or dS^T)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hr = e >> 1;
                const int c = 8 * nt + 2 * qd + (e & 1);
                const bool ok = KEYS ? rok[hr] : col[c] != 0.f;
                const float m = KEYS ? col[c] : rm[hr];
                const float il = KEYS ? col[BLOCK + c] : ril[hr];
                const float dr = KEYS ? col[2 * BLOCK + c] : rd[hr];
                const float pe = exp2f((ok ? s[nt][e] * p.scale_log2 : NEG) - m) * il;
                s[nt][e] = pe;
                w[nt][e] = ok ? pe * (w[nt][e] - dr) * p.scale : 0.f;
            }
        if constexpr (KEYS) Op::template pv<NT>(dv_acc, s, sh.y2s);   // dv += P^T dO
        Op::template pv<NT>(acc, w, sh.ys);                            // += dS Y
        if constexpr (SPLIT) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = w[nt][e] - round_as(w[nt][e], (T*)nullptr);
            Op::template pv<NT>(acc, s, sh.ys);
        }
        __syncthreads();                     // the band scores' tile and Y, Y2 are free
        if (i + 1 < n) sh.load_walked(f, i + 1);
        mmd_tc::cp_async_commit();
        zero_window(sh.dsk);
        __syncwarp();
        skew_store(sh.dsk, w);
        __syncthreads();
        // position terms: own rows . band, and the band gradient's two blocks
        const Band<T, DH> band = sh.own_band(i);
        BO::own(acc, sh.dsk, 16 * warp, 48 - 16 * warp, WIN / 16, band);
        BO::grad(band_lo, sh.dsk, 16 * warp, 48 - 16 * warp, warp + 1, sh.xs);
        BO::grad(band_hi, sh.dsk, BLOCK + 16 * warp, 0, 4 - warp, sh.xs);
        if constexpr (SPLIT) {
            __syncthreads();
            skew_store(sh.dsk, s);
            __syncthreads();
            BO::own(acc, sh.dsk, 16 * warp, 48 - 16 * warp, WIN / 16, band);
            BO::grad(band_lo, sh.dsk, 16 * warp, 48 - 16 * warp, warp + 1, sh.xs);
            BO::grad(band_hi, sh.dsk, BLOCK + 16 * warp, 0, 4 - warp, sh.xs);
        }
        // band rows [0, 64) are final: slice rows 64 i + [0, 64)
        store_rows<float, DH>(slice + static_cast<size_t>(BLOCK * i + 16 * warp) * d_model,
                              d_model, band_lo);
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                band_lo[nt][e] = band_hi[nt][e];
                band_hi[nt][e] = 0.f;
            }
    }
    mmd_tc::cp_async_wait_all();
    store_rows<float, DH>(slice + static_cast<size_t>(BLOCK * n + 16 * warp) * d_model, d_model,
                          band_lo);
    T* out = (KEYS ? p.dk : p.dq) + row0 + static_cast<size_t>(BLOCK * o + 16 * warp) * d_model;
    store_rows<T, DH>(out, d_model, acc);
    if constexpr (KEYS) {
        store_rows<T, DH>(p.dv + row0 + static_cast<size_t>(BLOCK * o + 16 * warp) * d_model,
                          d_model, dv_acc);
    }
}

// blockIdx.y < heads: the dq CTAs; the rest: the dk/dv CTAs
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_bwd_grad_kernel(const Params<T> p) {
    if (static_cast<int>(blockIdx.y) < p.num_heads) {
        grad_cta<T, DH, false>(p, blockIdx.x, blockIdx.y, blockIdx.z);
    } else {
        grad_cta<T, DH, true>(p, blockIdx.x, blockIdx.y - p.num_heads, blockIdx.z);
    }
}

// ---------------------------------------------------------------------------
// 3. out[r] = sum over b, then over tiles, of the slice rows that map to r
//    (blockIdx.y: 0 dPK, 1 dPQ)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(REDUCE_THREADS)
deberta_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dpk,
                          float* __restrict__ dpq, int batch, int t_len, int d_model) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS + threadIdx.x;
    const int c4 = d_model / 4;
    if (idx >= static_cast<int64_t>(2 * t_len) * c4) return;
    const int r = static_cast<int>(idx / c4);
    const int col = 4 * static_cast<int>(idx % c4);
    const int tiles = t_len / BLOCK;
    const size_t slice = static_cast<size_t>(t_len + BLOCK) * d_model;
    const float* src = ws + (blockIdx.y ? static_cast<size_t>(batch) * tiles * slice : 0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < batch; ++b) {
        for (int tile = 0; tile < tiles; ++tile) {
            const int local = r - (t_len - BLOCK - BLOCK * tile);
            if (local < 0 || local >= t_len + BLOCK) continue;
            const float4 x = *reinterpret_cast<const float4*>(
                src + (static_cast<size_t>(b) * tiles + tile) * slice +
                static_cast<size_t>(local) * d_model + col);
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
        }
    }
    *reinterpret_cast<float4*>((blockIdx.y ? dpq : dpk) + static_cast<size_t>(r) * d_model + col) =
        acc;
}

// Above 48 KB of dynamic shared memory a kernel has to be allowed it, once
// per device: `raised` holds a bit for each device where that is done.
template <typename T, int DH>
cudaError_t launch(const Params<T>& p, float* dpk, float* dpq, int device,
                   cudaStream_t stream) {
    constexpr size_t smem = Smem<T, DH, true>::BYTES;
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        cudaError_t err = cudaFuncSetAttribute(deberta_bwd_stats_kernel<T, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(deberta_bwd_grad_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
        }
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    const int tiles = p.t_len / BLOCK;
    deberta_bwd_stats_kernel<T, DH><<<dim3(tiles, p.num_heads, p.batch), THREADS, smem,
                                      stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    deberta_bwd_grad_kernel<T, DH><<<dim3(tiles, 2 * p.num_heads, p.batch), THREADS, smem,
                                     stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int64_t outs = static_cast<int64_t>(2 * p.t_len) * (p.num_heads * DH / 4);
    deberta_bwd_reduce_kernel<<<dim3(static_cast<unsigned>(
                                         (outs + REDUCE_THREADS - 1) / REDUCE_THREADS), 2),
                                REDUCE_THREADS, 0, stream>>>(p.ws, dpk, dpq, p.batch, p.t_len,
                                                             p.num_heads * DH);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_typed(const void* const* in, void* stats, void* ws, void* const* grads,
                         void* dpk, void* dpq, int batch, int t_len, int num_heads,
                         float scale, int device, cudaStream_t stream) {
    const Params<T> p{static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
                      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
                      static_cast<const T*>(in[4]), static_cast<const T*>(in[6]),
                      static_cast<const uint8_t*>(in[5]), static_cast<float*>(stats),
                      static_cast<float*>(ws), static_cast<T*>(grads[0]),
                      static_cast<T*>(grads[1]), static_cast<T*>(grads[2]),
                      batch, t_len, num_heads, scale, scale * LOG2E};
    return launch<T, DH>(p, static_cast<float*>(dpk), static_cast<float*>(dpq), device, stream);
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, dout, dq, dk, dv are (batch,
// t_len, heads * head_dim) and pk, pq (2 * t_len, heads * head_dim), all of
// one dtype (0 = float32, 1 = bfloat16), contiguous and 16-byte aligned;
// key_valid is (batch, t_len) uint8; dpk and dpq are (2 * t_len, heads *
// head_dim) fp32. stats is a (3, batch, heads, t_len) fp32 scratch and ws an
// fp32 scratch of 2 * batch * (t_len / 64) * (t_len + 64) * heads * head_dim
// floats; neither needs zeroing (every element read is first written).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mmd_deberta_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* pk, const void* pq, const void* key_valid,
                                    const void* dout, void* stats, void* ws, void* dq,
                                    void* dk, void* dv, void* dpk, void* dpq, int batch,
                                    int t_len, int num_heads, int head_dim, float scale,
                                    int dtype, int device, void* stream) {
    if (batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 32767 || t_len <= 0 ||
        t_len % BLOCK != 0 || device < 0 || device >= 64) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* in[7] = {q, k, v, pk, pq, key_valid, dout};
    void* grads[3] = {dq, dk, dv};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_typed<float, 32>(in, stats, ws, grads, dpk, dpq, batch, t_len, num_heads,
                                       scale, device, st);
    if (dtype == 0 && head_dim == 64)
        return launch_typed<float, 64>(in, stats, ws, grads, dpk, dpq, batch, t_len, num_heads,
                                       scale, device, st);
    if (dtype == 1 && head_dim == 32)
        return launch_typed<bf16, 32>(in, stats, ws, grads, dpk, dpq, batch, t_len, num_heads,
                                      scale, device, st);
    if (dtype == 1 && head_dim == 64)
        return launch_typed<bf16, 64>(in, stats, ws, grads, dpk, dpq, batch, t_len, num_heads,
                                      scale, device, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
