// DeBERTa-v3 disentangled attention backward for Hopper (sm_90a).
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
// The scores are recomputed from the operands in fp32, so nothing T x T
// sized crosses device memory, and D_t comes from P and dP themselves (not
// from the forward's rounded output). A row with no valid key has the
// uniform P of the forward; its ds is zero, as the reference's `where`
// makes it. dq, dk, dv are written in the input dtype, dPK and dPQ in fp32.
//
// On the TPU the grid runs in order over the batch and the kernel adds each
// row's table gradients into one revisited output block. Blocks on Hopper
// run in no order, so the table gradients go through a workspace and a
// fixed-order sum, with no atomics, and the result is the same every run:
//   1. stats   one CTA per (64-query tile, head, b) walks the key tiles
//              with an online softmax: row max m and 1/l of the log2-domain
//              scores, and D = sum P dP, into a (3, B, H, T) fp32 scratch;
//   2. dq      one CTA per (query tile, head, b) walks the key tiles,
//              recomputes P and dP, keeps dq in registers, and adds each
//              tile pair's 127-row band of dPK into this CTA's own (T + 64,
//              D) slice of the workspace (no other CTA touches it);
//   3. dkdv    one CTA per (64-key tile, head, b) walks the query tiles,
//              keeps dk and dv in registers and adds the dPQ bands into
//              its own slice;
//   4. reduce  dPK[r] (and dPQ[r]) = the sum over b, then over tiles, of
//              the slices' rows that map to r, in that fixed order.
//
// What bounds it on this card: operations. Counted as the TPU kernel counts
// it, 20 * B * T^2 * D operations against 8 * B * T * D elements of q, k,
// v, do and their gradients: at the fine-tuning shape (B 8, T 256, D 384)
// ~640 operations per bf16 byte, above the ~295 where the tensor cores and
// not device memory are the limit. This first version runs its products on
// the CUDA cores in fp32 (67 TFLOP/s) and recomputes the scores three
// times (stats, dq, dkdv): 17 products of dh per (t, s) pair against the
// reference's 10, plus the RMW traffic of the band slices.
//
// What the design does about that (first version: simple and right):
//   * 256 threads a CTA; in the score phases each thread holds a 4 x 4 block
//     of scores at rows ty + 16 j and columns tx + 16 i, as the forward
//     kernel does, so the c2p and p2c rows it needs lie on 7 diagonals of
//     the staged 128-row PK and PQ bands;
//   * q, k, v, do tiles and both bands live in shared memory as fp32 with
//     rows padded to dh + 4 floats; P and ds go through shared memory once
//     a tile pair;
//   * dq and dk fold the content and position terms into one product over
//     (k + PK band) and (q + PQ band);
//   * T % 64 == 0 and dh in {32, 64}, as the forward kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                       // query rows per tile
constexpr int BN = 64;                       // keys per tile
constexpr int BAND = 128;                    // PK / PQ rows per tile pair (127 used)
constexpr int THREADS = 256;
constexpr int P_STRIDE = BN + 4;
constexpr float NEG = -3.402823466e38f;      // finfo(float32).min

__device__ __forceinline__ void load16(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 x) {
    acc.x = fmaf(a, x.x, acc.x);
    acc.y = fmaf(a, x.y, acc.y);
    acc.z = fmaf(a, x.z, acc.z);
    acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows x DH values of a row-major array (row stride `stride` elements) into
// shared memory as fp32 rows of DH + 4 floats.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int stride, int rows) {
    constexpr int ST = DH + 4;
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = DH / VEC;            // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int r = i / CPR;
        const int ch = i % CPR;
        float x[VEC];
        load16(src + static_cast<size_t>(r) * stride + ch * VEC, x);
        float* d = dst + r * ST + ch * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
            *reinterpret_cast<float4*>(d + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        }
    }
}

// The unscaled scores of this thread's 4 x 4 block (rows ty + 16 j, keys
// tx + 16 i): content + c2p + p2c, from the staged q and k tiles and the
// PK / PQ bands of the tile pair (local band row 63 - r + c for PK, 63 - c
// + r for PQ).
template <int DH>
__device__ __forceinline__ void score_tile(const float* qs, const float* ks,
                                           const float* pks, const float* pqs,
                                           int ty, int tx, float (&s)[4][4]) {
    constexpr int ST = DH + 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DH; d += 4) {
        float4 qv[4], kv[4], pkv[7], pqv[7];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            qv[j] = *reinterpret_cast<const float4*>(qs + (ty + 16 * j) * ST + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            kv[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * ST + d);
#pragma unroll
        for (int e = 0; e < 7; ++e) {
            pkv[e] = *reinterpret_cast<const float4*>(pks + (63 + tx - ty + 16 * (e - 3)) * ST + d);
            pqv[e] = *reinterpret_cast<const float4*>(pqs + (63 - tx + ty + 16 * (e - 3)) * ST + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float x = dot4(qv[j], kv[i], s[j][i]);     // content
                x = dot4(qv[j], pkv[i - j + 3], x);         // c2p
                s[j][i] = dot4(kv[i], pqv[j - i + 3], x);   // p2c
            }
    }
}

// dP of this thread's 4 x 4 block: do rows ty + 16 j against v rows tx + 16 i.
template <int DH>
__device__ __forceinline__ void dot_tile(const float* as, const float* bs, int ty, int tx,
                                         float (&s)[4][4]) {
    constexpr int ST = DH + 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DH; d += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            av[j] = *reinterpret_cast<const float4*>(as + (ty + 16 * j) * ST + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            bv[i] = *reinterpret_cast<const float4*>(bs + (tx + 16 * i) * ST + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[j][i] = dot4(av[j], bv[i], s[j][i]);
    }
}

struct Geom {
    int t_len, num_heads, d_model;
    float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// 1. row statistics: m (log2 domain), 1 / l and D = sum_s P dP
// ---------------------------------------------------------------------------
template <int DH>
struct StatsSmem {
    static constexpr int ST = DH + 4;
    static constexpr size_t BYTES =
        static_cast<size_t>(4 * 64 + 2 * BAND) * ST * sizeof(float) + BN * sizeof(int);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ pk, const T* __restrict__ pq,
             const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
             float* __restrict__ m_out, float* __restrict__ inv_l_out,
             float* __restrict__ d_out, Geom g) {
    constexpr int ST = DH + 4;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [BM][ST]
    float* dos = qs + BM * ST;                      // [BM][ST]
    float* ks = dos + BM * ST;                      // [BN][ST]
    float* vs = ks + BN * ST;                       // [BN][ST]
    float* pks = vs + BN * ST;                      // [BAND][ST]
    float* pqs = pks + BAND * ST;                   // [BAND][ST]
    int* kvalid = reinterpret_cast<int*>(pqs + BAND * ST);   // [BN]

    const int tid = threadIdx.x;
    const int ty = tid >> 4;
    const int tx = tid & 15;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BM;
    const int t_len = g.t_len;
    const int d_model = g.d_model;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const size_t bt = static_cast<size_t>(b) * t_len * d_model + head_off;
    const uint8_t* mb = key_valid + static_cast<size_t>(b) * t_len;

    stage<T, DH>(qs, q + bt + static_cast<size_t>(t0) * d_model, d_model, BM);
    stage<T, DH>(dos, dout + bt + static_cast<size_t>(t0) * d_model, d_model, BM);

    float m_run[4], l_run[4], d_run[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m_run[j] = -CUDART_INF_F;
        l_run[j] = 0.f;
        d_run[j] = 0.f;
    }
    for (int s0 = 0; s0 < t_len; s0 += BN) {
        __syncthreads();                     // the previous tile is consumed
        stage<T, DH>(ks, k + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
        stage<T, DH>(vs, v + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
        stage<T, DH>(pks, pk + static_cast<size_t>(t_len - BM - t0 + s0) * d_model + head_off,
                     d_model, BAND);
        stage<T, DH>(pqs, pq + static_cast<size_t>(t_len - BN - s0 + t0) * d_model + head_off,
                     d_model, BAND);
        if (tid < BN) kvalid[tid] = mb[s0 + tid] != 0;
        __syncthreads();

        float s[4][4], dp[4][4];
        score_tile<DH>(qs, ks, pks, pqs, ty, tx, s);
        dot_tile<DH>(dos, vs, ty, tx, dp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float mx = NEG;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                s[j][i] = kvalid[tx + 16 * i] ? s[j][i] * g.scale_log2 : NEG;
                mx = fmaxf(mx, s[j][i]);
            }
            // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_run[j], mx);
            const float alpha = exp2f(m_run[j] - m_new);
            float psum = 0.f, dsum = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = exp2f(s[j][i] - m_new);
                psum += p;
                dsum = fmaf(p, dp[j][i], dsum);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) {
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
                dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
            }
            l_run[j] = l_run[j] * alpha + psum;
            d_run[j] = d_run[j] * alpha + dsum;
            m_run[j] = m_new;
        }
    }
    if (tx == 0) {
        const size_t row0 = (static_cast<size_t>(b) * g.num_heads + h) * t_len + t0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const size_t r = row0 + ty + 16 * j;
            const float inv = 1.f / l_run[j];    // l >= 1: the row max contributes exp2(0)
            m_out[r] = m_run[j];
            inv_l_out[r] = inv;
            d_out[r] = d_run[j] * inv;
        }
    }
}

// P and ds of this thread's 4 x 4 block into the [BM][P_STRIDE] tiles ps
// (when given) and dss, from the raw scores s and dP.
__device__ __forceinline__ void weights_tile(const float (&s)[4][4], const float (&dp)[4][4],
                                             const int* kvalid, const float* mrow,
                                             const float* invl, const float* drow, int ty,
                                             int tx, const Geom& g, float* ps, float* dss) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int c = tx + 16 * i;
            const bool ok = kvalid[c] != 0;
            const float p = exp2f((ok ? s[j][i] * g.scale_log2 : NEG) - mrow[r]) * invl[r];
            if (ps != nullptr) ps[r * P_STRIDE + c] = p;
            dss[r * P_STRIDE + c] = ok ? p * (dp[j][i] - drow[r]) * g.scale : 0.f;
        }
    }
}

// Add one tile pair's 127-row table-gradient band into a CTA's workspace
// slice: band[rr] = sum over the (row, col) pairs of the tile on diagonal rr
// of ds * x, where rr = 63 - row + col (FOR_PK: x = the query row, the pair
// is (i, i + rr - 63)) or rr = 63 - col + row (x = the key row, the pair is
// (j + rr - 63, j)). `dst` points at the slice row of band row 0, head
// columns.
template <int DH, bool FOR_PK>
__device__ __forceinline__ void add_band(const float* dss, const float* xs, float* dst,
                                         int d_model) {
    constexpr int ST = DH + 4;
    constexpr int C4 = DH / 4;
    for (int item = threadIdx.x; item < (2 * 64 - 1) * C4; item += THREADS) {
        const int rr = item / C4;
        const int c = 4 * (item % C4);
        const int lo = rr < 63 ? 63 - rr : 0;
        const int hi = rr > 63 ? 127 - rr : 64;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int a = lo; a < hi; ++a) {
            // FOR_PK: a is the query row i, the key is i + rr - 63;
            // else a is the key j, the query row is j + rr - 63
            const int other = a + rr - 63;
            const float d = FOR_PK ? dss[a * P_STRIDE + other] : dss[other * P_STRIDE + a];
            fma4(acc, d, *reinterpret_cast<const float4*>(xs + a * ST + c));
        }
        float4* out = reinterpret_cast<float4*>(dst + static_cast<size_t>(rr) * d_model + c);
        *out = add4(*out, acc);
    }
}

// ---------------------------------------------------------------------------
// 2. dq and the dPK bands: one CTA per (query tile, head, b)
// ---------------------------------------------------------------------------
template <int DH>
struct DqSmem {
    static constexpr int ST = DH + 4;
    static constexpr size_t BYTES =
        (static_cast<size_t>(4 * 64 + 2 * BAND) * ST + BM * P_STRIDE + 3 * BM) * sizeof(float)
        + BN * sizeof(int);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ pk, const T* __restrict__ pq,
          const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
          const float* __restrict__ m_in, const float* __restrict__ inv_l_in,
          const float* __restrict__ d_in, T* __restrict__ dq, float* __restrict__ ws, Geom g) {
    constexpr int ST = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [BM][ST]
    float* dos = qs + BM * ST;                      // [BM][ST]
    float* ks = dos + BM * ST;                      // [BN][ST]
    float* vs = ks + BN * ST;                       // [BN][ST]
    float* pks = vs + BN * ST;                      // [BAND][ST]
    float* pqs = pks + BAND * ST;                   // [BAND][ST]
    float* dss = pqs + BAND * ST;                   // [BM][P_STRIDE]
    float* mrow = dss + BM * P_STRIDE;              // [BM]
    float* invl = mrow + BM;                        // [BM]
    float* drow = invl + BM;                        // [BM]
    int* kvalid = reinterpret_cast<int*>(drow + BM);   // [BN]

    const int tid = threadIdx.x;
    const int ty = tid >> 4;
    const int tx = tid & 15;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BM;
    const int t_len = g.t_len;
    const int d_model = g.d_model;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const size_t bt = static_cast<size_t>(b) * t_len * d_model + head_off;
    const uint8_t* mb = key_valid + static_cast<size_t>(b) * t_len;
    // this CTA's (T + 64, D) workspace slice; its row 0 is table row T-64-t0
    float* slice = ws + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (t_len + 64) * d_model
                   + head_off;

    stage<T, DH>(qs, q + bt + static_cast<size_t>(t0) * d_model, d_model, BM);
    stage<T, DH>(dos, dout + bt + static_cast<size_t>(t0) * d_model, d_model, BM);
    if (tid < BM) {
        const size_t r = (static_cast<size_t>(b) * g.num_heads + h) * t_len + t0 + tid;
        mrow[tid] = m_in[r];
        invl[tid] = inv_l_in[r];
        drow[tid] = d_in[r];
    }

    // In the accumulation phase this thread owns row `row` and columns
    // [4 * (4 * c + sub), +4) of dq.
    const int row = tid >> 2;
    const int sub = tid & 3;
    float4 acc[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int s0 = 0; s0 < t_len; s0 += BN) {
        __syncthreads();                     // the previous tile is consumed
        stage<T, DH>(ks, k + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
        stage<T, DH>(vs, v + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
        stage<T, DH>(pks, pk + static_cast<size_t>(t_len - BM - t0 + s0) * d_model + head_off,
                     d_model, BAND);
        stage<T, DH>(pqs, pq + static_cast<size_t>(t_len - BN - s0 + t0) * d_model + head_off,
                     d_model, BAND);
        if (tid < BN) kvalid[tid] = mb[s0 + tid] != 0;
        __syncthreads();

        {
            float s[4][4], dp[4][4];
            score_tile<DH>(qs, ks, pks, pqs, ty, tx, s);
            dot_tile<DH>(dos, vs, ty, tx, dp);
            weights_tile(s, dp, kvalid, mrow, invl, drow, ty, tx, g, nullptr, dss);
        }
        __syncthreads();

        // dq[row] += sum_j ds[row, j] (k_j + PK band[63 - row + j])
        const float* dsr = dss + row * P_STRIDE;
#pragma unroll 4
        for (int j = 0; j < BN; ++j) {
            const float d = dsr[j];
            const float4* kr = reinterpret_cast<const float4*>(ks + j * ST);
            const float4* pr = reinterpret_cast<const float4*>(pks + (63 - row + j) * ST);
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) fma4(acc[c], d, add4(kr[4 * c + sub], pr[4 * c + sub]));
        }
        // the band's table row T-64-t0+s0+rr is slice row s0 + rr
        add_band<DH, true>(dss, qs, slice + static_cast<size_t>(s0) * d_model, d_model);
    }

    T* dst = dq + bt + static_cast<size_t>(t0 + row) * d_model;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        const int col = 4 * (4 * c + sub);
        store_as(dst + col + 0, acc[c].x);
        store_as(dst + col + 1, acc[c].y);
        store_as(dst + col + 2, acc[c].z);
        store_as(dst + col + 3, acc[c].w);
    }
}

// ---------------------------------------------------------------------------
// 3. dk, dv and the dPQ bands: one CTA per (key tile, head, b)
// ---------------------------------------------------------------------------
template <int DH>
struct DkdvSmem {
    static constexpr int ST = DH + 4;
    static constexpr size_t BYTES =
        (static_cast<size_t>(4 * 64 + 2 * BAND) * ST + 2 * BM * P_STRIDE + 3 * BM) * sizeof(float)
        + BN * sizeof(int);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ pk, const T* __restrict__ pq,
            const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
            const float* __restrict__ m_in, const float* __restrict__ inv_l_in,
            const float* __restrict__ d_in, T* __restrict__ dk, T* __restrict__ dv,
            float* __restrict__ ws, Geom g) {
    constexpr int ST = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);   // [BN][ST]
    float* vs = ks + BN * ST;                       // [BN][ST]
    float* qs = vs + BN * ST;                       // [BM][ST]
    float* dos = qs + BM * ST;                      // [BM][ST]
    float* pks = dos + BM * ST;                     // [BAND][ST]
    float* pqs = pks + BAND * ST;                   // [BAND][ST]
    float* ps = pqs + BAND * ST;                    // [BM][P_STRIDE]
    float* dss = ps + BM * P_STRIDE;                // [BM][P_STRIDE]
    float* mrow = dss + BM * P_STRIDE;              // [BM]
    float* invl = mrow + BM;                        // [BM]
    float* drow = invl + BM;                        // [BM]
    int* kvalid = reinterpret_cast<int*>(drow + BM);   // [BN]

    const int tid = threadIdx.x;
    const int ty = tid >> 4;
    const int tx = tid & 15;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int s0 = blockIdx.x * BN;
    const int t_len = g.t_len;
    const int d_model = g.d_model;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const size_t bt = static_cast<size_t>(b) * t_len * d_model + head_off;
    // this CTA's workspace slice; its row 0 is table row T-64-s0
    float* slice = ws + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (t_len + 64) * d_model
                   + head_off;

    stage<T, DH>(ks, k + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
    stage<T, DH>(vs, v + bt + static_cast<size_t>(s0) * d_model, d_model, BN);
    if (tid < BN) kvalid[tid] = key_valid[static_cast<size_t>(b) * t_len + s0 + tid] != 0;

    // In the accumulation phase this thread owns key `kj` and columns
    // [4 * (4 * c + sub), +4) of dk and dv.
    const int kj = tid >> 2;
    const int sub = tid & 3;
    float4 dk_acc[CHUNKS], dv_acc[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int t0 = 0; t0 < t_len; t0 += BM) {
        __syncthreads();                     // the previous tile is consumed
        stage<T, DH>(qs, q + bt + static_cast<size_t>(t0) * d_model, d_model, BM);
        stage<T, DH>(dos, dout + bt + static_cast<size_t>(t0) * d_model, d_model, BM);
        stage<T, DH>(pks, pk + static_cast<size_t>(t_len - BM - t0 + s0) * d_model + head_off,
                     d_model, BAND);
        stage<T, DH>(pqs, pq + static_cast<size_t>(t_len - BN - s0 + t0) * d_model + head_off,
                     d_model, BAND);
        if (tid < BM) {
            const size_t r = (static_cast<size_t>(b) * g.num_heads + h) * t_len + t0 + tid;
            mrow[tid] = m_in[r];
            invl[tid] = inv_l_in[r];
            drow[tid] = d_in[r];
        }
        __syncthreads();

        {
            float s[4][4], dp[4][4];
            score_tile<DH>(qs, ks, pks, pqs, ty, tx, s);
            dot_tile<DH>(dos, vs, ty, tx, dp);
            weights_tile(s, dp, kvalid, mrow, invl, drow, ty, tx, g, ps, dss);
        }
        __syncthreads();

        // dv[kj] += sum_i P[i, kj] do_i;  dk[kj] += sum_i ds[i, kj] (q_i + PQ band[63 - kj + i])
#pragma unroll 4
        for (int i = 0; i < BM; ++i) {
            const float p = ps[i * P_STRIDE + kj];
            const float d = dss[i * P_STRIDE + kj];
            const float4* dor = reinterpret_cast<const float4*>(dos + i * ST);
            const float4* qr = reinterpret_cast<const float4*>(qs + i * ST);
            const float4* pr = reinterpret_cast<const float4*>(pqs + (63 - kj + i) * ST);
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                fma4(dv_acc[c], p, dor[4 * c + sub]);
                fma4(dk_acc[c], d, add4(qr[4 * c + sub], pr[4 * c + sub]));
            }
        }
        // the band's table row T-64-s0+t0+rr is slice row t0 + rr
        add_band<DH, false>(dss, ks, slice + static_cast<size_t>(t0) * d_model, d_model);
    }

    const size_t off = bt + static_cast<size_t>(s0 + kj) * d_model;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        const int col = 4 * (4 * c + sub);
        store_as(dk + off + col + 0, dk_acc[c].x);
        store_as(dk + off + col + 1, dk_acc[c].y);
        store_as(dk + off + col + 2, dk_acc[c].z);
        store_as(dk + off + col + 3, dk_acc[c].w);
        store_as(dv + off + col + 0, dv_acc[c].x);
        store_as(dv + off + col + 1, dv_acc[c].y);
        store_as(dv + off + col + 2, dv_acc[c].z);
        store_as(dv + off + col + 3, dv_acc[c].w);
    }
}

// ---------------------------------------------------------------------------
// 4. out[r] = sum over b, then over tiles, of the slice rows that map to r
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
deberta_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int batch, int t_len,
              int d_model) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int c4 = d_model / 4;
    if (idx >= static_cast<int64_t>(2 * t_len) * c4) return;
    const int r = static_cast<int>(idx / c4);
    const int col = 4 * static_cast<int>(idx % c4);
    const int tiles = t_len / 64;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < batch; ++b) {
        for (int tile = 0; tile < tiles; ++tile) {
            // slice row 0 of tile `tile` is table row T - 64 - 64 * tile
            const int local = r - (t_len - 64 - 64 * tile);
            if (local < 0 || local >= t_len + 64) continue;
            const float4 x = *reinterpret_cast<const float4*>(
                ws + ((static_cast<size_t>(b) * tiles + tile) * (t_len + 64) + local) * d_model
                + col);
            acc = add4(acc, x);
        }
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * d_model + col) = acc;
}

struct Args {
    const void *q, *k, *v, *pk, *pq, *key_valid, *dout;
    float *stats, *ws;
    void *dq, *dk, *dv;
    float *dpk, *dpq;
    int batch, t_len, num_heads;
    float scale;
};

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* pk = static_cast<const T*>(a.pk);
    const T* pq = static_cast<const T*>(a.pq);
    const T* dout = static_cast<const T*>(a.dout);
    const uint8_t* kv = static_cast<const uint8_t*>(a.key_valid);
    const Geom g{a.t_len, a.num_heads, a.num_heads * DH, a.scale, a.scale * 1.4426950408889634f};
    const size_t rows = static_cast<size_t>(a.batch) * a.num_heads * a.t_len;
    float* m = a.stats;
    float* inv_l = a.stats + rows;
    float* dsum = a.stats + 2 * rows;
    // the dq pass's slices hold the dPK bands, the dkdv pass's the dPQ bands
    const size_t slice_floats =
        static_cast<size_t>(a.batch) * (a.t_len / 64) * (a.t_len + 64) * g.d_model;
    float* ws_pk = a.ws;
    float* ws_pq = a.ws + slice_floats;
    const dim3 grid(a.t_len / 64, a.num_heads, a.batch);

    cudaError_t err = cudaFuncSetAttribute(deberta_bwd_stats_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(StatsSmem<DH>::BYTES));
    if (err != cudaSuccess) return err;
    deberta_bwd_stats_kernel<T, DH><<<grid, THREADS, StatsSmem<DH>::BYTES, stream>>>(
        q, k, v, pk, pq, kv, dout, m, inv_l, dsum, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    err = cudaFuncSetAttribute(deberta_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DqSmem<DH>::BYTES));
    if (err != cudaSuccess) return err;
    deberta_bwd_dq_kernel<T, DH><<<grid, THREADS, DqSmem<DH>::BYTES, stream>>>(
        q, k, v, pk, pq, kv, dout, m, inv_l, dsum, static_cast<T*>(a.dq), ws_pk, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    err = cudaFuncSetAttribute(deberta_bwd_dkdv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(DkdvSmem<DH>::BYTES));
    if (err != cudaSuccess) return err;
    deberta_bwd_dkdv_kernel<T, DH><<<grid, THREADS, DkdvSmem<DH>::BYTES, stream>>>(
        q, k, v, pk, pq, kv, dout, m, inv_l, dsum, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), ws_pq, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const int64_t outs = static_cast<int64_t>(2 * a.t_len) * (g.d_model / 4);
    const unsigned blocks = static_cast<unsigned>((outs + THREADS - 1) / THREADS);
    deberta_bwd_reduce_kernel<<<blocks, THREADS, 0, stream>>>(ws_pk, a.dpk, a.batch, a.t_len, g.d_model);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    deberta_bwd_reduce_kernel<<<blocks, THREADS, 0, stream>>>(ws_pq, a.dpq, a.batch, a.t_len, g.d_model);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, dout, dq, dk, dv are (batch,
// t_len, heads * head_dim) and pk, pq (2 * t_len, heads * head_dim), all of
// one dtype (0 = float32, 1 = bfloat16) and contiguous; key_valid is (batch,
// t_len) uint8; dpk and dpq are (2 * t_len, heads * head_dim) fp32. stats is
// a (3, batch, heads, t_len) fp32 scratch and ws a ZEROED fp32 workspace of
// 2 * batch * (t_len / 64) * (t_len + 64) * heads * head_dim floats. Returns
// the cudaError_t of the launches (0 on success).
extern "C" int mmd_deberta_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* pk, const void* pq, const void* key_valid,
                                    const void* dout, void* stats, void* ws, void* dq,
                                    void* dk, void* dv, void* dpk, void* dpq, int batch,
                                    int t_len, int num_heads, int head_dim, float scale,
                                    int dtype, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 65535 ||
        t_len <= 0 || t_len % BM != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{q, k, v, pk, pq, key_valid, dout,
                 static_cast<float*>(stats), static_cast<float*>(ws), dq, dk, dv,
                 static_cast<float*>(dpk), static_cast<float*>(dpq),
                 batch, t_len, num_heads, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32) return launch<float, 32>(a, st);
    if (dtype == 0 && head_dim == 64) return launch<float, 64>(a, st);
    if (dtype == 1 && head_dim == 32) return launch<__nv_bfloat16, 32>(a, st);
    if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
