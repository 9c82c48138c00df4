// Flash-attention backward for Hopper (sm_90a), non-causal, with an optional
// (B, S) key mask and optional attention dropout.
//
// Replaces mmd_tpu/ops/attention.py::_flash_bwd (its Pallas body
// _bwd_kernel, behind the custom VJPs _fused_attention_core[_masked]) on the
// training path: the backward of each of the fusion model's eight
// attentions, (T, S) in {512, 64}^2, D 256, 8 heads.
//
// What it computes, per batch row b and head h, from q, k, v, the forward's
// o and natural-log lse, the output gradient do, and the dropout seed:
//   p[t, s]  = exp(q[t] . k[s] / sqrt(dh) - lse[t])  (0 for a masked key or a
//              row whose lse is -inf, i.e. a row with no valid key)
//   keep     = the forward's mask, regenerated from (seed, index) (philox.cuh)
//   D[t]     = sum_d do[t, d] o[t, d]                 (holds with dropout)
//   dv[s]   += sum_t p keep scale do[t]
//   dp[t, s] = do[t] . v[s]
//   ds[t, s] = p (dp keep scale - D[t])
//   dq[t]    = sum_s ds k[s] / sqrt(dh)
//   dk[s]    = sum_t ds q[t] / sqrt(dh)
// with keep scale = 1 when there is no dropout. Sums are fp32; dq, dk and dv
// are returned in the input dtype, as the TPU kernel does.
//
// On the TPU the grid runs in order and the kernel carries dk/dv sums in
// revisited output blocks across query tiles. Blocks on Hopper run in no
// order, so this is TWO PASSES over the score matrix, chosen over fp32
// atomics for dq because it is deterministic (a training step gives the
// same grads every run) and needs no zeroed scratch:
//   1. rowdot   D[b, h, t] into a (B, H, T) fp32 scratch;
//   2. dkdv     one CTA per (64-key tile, head, batch row) walks the query
//               tiles, recomputes p and dp, and keeps dk and dv in registers;
//   3. dq       one CTA per (64-row query tile, head, batch row) walks the
//               key tiles, recomputes p and dp, and keeps dq in registers.
// Both passes redraw the dropout mask of each 64 x 64 tile into shared
// memory (fill_keep_tile), exactly as the forward draws it.
//
// What bounds it on this card: arithmetic. Counted as the TPU kernel counts
// it, 10 * B * H * T * S * dh operations (score, dp, dv, dk, dq products)
// against q, k, v, o, do read once and dq, dk, dv written once: T / 2.5
// operations per fp32 byte at S = T, ~200 for the 512-token shapes, far
// above the ~20 where 67 TFLOP/s of fp32 FMA meets 3.35 TB/s. The two
// passes recompute the score and dp products, 14 instead of 10 products of
// dh per weight, and add one Philox call per 4 weights to each pass.
//
// What the design does about that (first version: simple and right):
//   * 256 threads a CTA; in the score phases 4 threads share a row of the
//     tile, holding that row of q (pre-scaled into the exp2 domain) or do
//     in registers and 16 of the tile's 64 keys each, as the forward does;
//   * tiles of K, V, Q and dO are staged in shared memory as fp32 with rows
//     padded to dh + 4 floats, so the float4 reads of a warp fall in
//     different banks;
//   * in the dkdv pass the weights p keep scale and ds go through shared
//     memory, and each thread then owns one key and dh / 4 columns of dk and
//     dv; in the dq pass each thread owns dh / 4 columns of its row's dq;
//   * plain FMA on the CUDA cores. Tensor cores (mma.sync / wgmma) and one
//     pass with the score tile shared by both products are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int BLOCK_M = 64;                  // query rows per tile
constexpr int BLOCK_N = 64;                  // keys per tile
constexpr int TPR = 4;                       // threads per row in the score phases
constexpr int THREADS = 256;
constexpr int PER_THREAD = BLOCK_N / TPR;    // keys (or rows) per thread
constexpr int S_STRIDE = BLOCK_N + 4;        // floats per row of a weight tile
constexpr int KEEP_STRIDE = BLOCK_N + 4;     // mask bytes per row
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BLOCK_M * TPR == THREADS && BLOCK_N * TPR == THREADS,
              "one row (or key) per 4 threads");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + 64) of head h of a (B, L, D) tensor into an fp32 tile of
// row stride DH + 4; rows at or past `len` become zeros.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* base, int r0, int len,
                                           int d_model, int tid) {
    constexpr int ROW = DH + 4;
    for (int i = tid; i < 64 * DH; i += THREADS) {
        const int j = i / DH;
        const int d = i % DH;
        const int r = r0 + j;
        dst[j * ROW + d] = r < len ? to_float(base[static_cast<size_t>(r) * d_model + d]) : 0.f;
    }
}

template <int DH>
__device__ __forceinline__ float dot_row(const float (&x)[DH], const float* row) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float acc = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 y = r4[d4];
        acc = fmaf(x[4 * d4 + 0], y.x, acc);
        acc = fmaf(x[4 * d4 + 1], y.y, acc);
        acc = fmaf(x[4 * d4 + 2], y.z, acc);
        acc = fmaf(x[4 * d4 + 3], y.w, acc);
    }
    return acc;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
    acc.x = fmaf(a, x.x, acc.x);
    acc.y = fmaf(a, x.y, acc.y);
    acc.z = fmaf(a, x.z, acc.z);
    acc.w = fmaf(a, x.w, acc.w);
}

// ---------------------------------------------------------------------------
// 1. D[b, h, t] = sum_d do o
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int batch, int t_len, int num_heads) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t rows = static_cast<int64_t>(batch) * t_len * num_heads;
    if (idx >= rows) return;
    const int h = static_cast<int>(idx % num_heads);
    const int64_t bt = idx / num_heads;      // b * T + t
    const size_t base = static_cast<size_t>(bt) * num_heads * DH + static_cast<size_t>(h) * DH;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) acc = fmaf(to_float(dout[base + d]), to_float(o[base + d]), acc);
    const int64_t b = bt / t_len;
    const int64_t t = bt % t_len;
    delta[(b * num_heads + h) * t_len + t] = acc;
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one CTA per (key tile, head, batch row)
// ---------------------------------------------------------------------------
template <int DH>
struct DkdvSmem {
    static constexpr int ROW = DH + 4;
    static constexpr size_t BYTES =
        (4 * 64 * ROW + 2 * BLOCK_M * S_STRIDE + 2 * BLOCK_M) * sizeof(float)
        + BLOCK_N * sizeof(int) + BLOCK_M * KEEP_STRIDE;
};

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int num_heads,
            float scale_log2, float sm_scale, mmd_philox::Dropout drop) {
    constexpr int ROW = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);   // [BLOCK_N][ROW]
    float* vs = ks + BLOCK_N * ROW;                 // [BLOCK_N][ROW]
    float* qs = vs + BLOCK_N * ROW;                 // [BLOCK_M][ROW]
    float* dos = qs + BLOCK_M * ROW;                // [BLOCK_M][ROW]
    float* pds = dos + BLOCK_M * ROW;               // [BLOCK_M][S_STRIDE]  p keep scale
    float* dss = pds + BLOCK_M * S_STRIDE;          // [BLOCK_M][S_STRIDE]  ds
    float* lse2 = dss + BLOCK_M * S_STRIDE;         // [BLOCK_M] log2 domain
    float* drow = lse2 + BLOCK_M;                   // [BLOCK_M]
    int* kvalid = reinterpret_cast<int*>(drow + BLOCK_M);            // [BLOCK_N]
    uint8_t* keep = reinterpret_cast<uint8_t*>(kvalid + BLOCK_N);    // [BLOCK_M][KEEP_STRIDE]

    const int tid = threadIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int s0 = blockIdx.x * BLOCK_N;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* dob = dout + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const float* lseb = lse + (static_cast<size_t>(b) * num_heads + h) * t_len;
    const float* deltab = delta + (static_cast<size_t>(b) * num_heads + h) * t_len;

    stage_rows<T, DH>(ks, kb, s0, s_len, d_model, tid);
    stage_rows<T, DH>(vs, vb, s0, s_len, d_model, tid);
    if (tid < BLOCK_N) {
        const int s = s0 + tid;
        kvalid[tid] = (s < s_len) &&
                      (key_valid == nullptr || key_valid[static_cast<size_t>(b) * s_len + s] != 0);
    }

    // In the accumulation phase this thread owns key `kj` and columns
    // [4 * (4 * c + sub), +4) of its dk and dv rows.
    const int sub = tid % TPR;
    const int kj = tid / TPR;
    float4 dk_acc[CHUNKS], dv_acc[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        dv_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int t0 = 0; t0 < t_len; t0 += BLOCK_M) {
        __syncthreads();                     // the previous tile is consumed
        stage_rows<T, DH>(qs, qb, t0, t_len, d_model, tid);
        stage_rows<T, DH>(dos, dob, t0, t_len, d_model, tid);
        if (tid < BLOCK_M) {
            const int t = t0 + tid;
            lse2[tid] = t < t_len ? lseb[t] * LOG2E : -CUDART_INF_F;
            drow[tid] = t < t_len ? deltab[t] : 0.f;
        }
        if constexpr (DROP) {
            mmd_philox::fill_keep_tile<BLOCK_M, BLOCK_N, KEEP_STRIDE>(
                keep, tid, THREADS, b, h, num_heads, t0, t_len, s0, s_len, drop);
        }
        __syncthreads();

        // Score phase: row r, keys j = sub + TPR * i.
        {
            const int r = tid / TPR;
            const float l2 = lse2[r];
            const bool row_live = l2 != -CUDART_INF_F;
            float x[DH];
#pragma unroll
            for (int d = 0; d < DH; ++d) x[d] = qs[r * ROW + d] * scale_log2;
            float p[PER_THREAD];
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i) {
                const int j = sub + TPR * i;
                const float s = dot_row<DH>(x, ks + j * ROW);
                p[i] = (row_live && kvalid[j]) ? exp2f(s - l2) : 0.f;
            }
#pragma unroll
            for (int d = 0; d < DH; ++d) x[d] = dos[r * ROW + d];
            const float dr = drow[r];
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i) {
                const int j = sub + TPR * i;
                const float dp = dot_row<DH>(x, vs + j * ROW);
                float ksc = 1.f;
                if constexpr (DROP) ksc = keep[r * KEEP_STRIDE + j] ? drop.scale : 0.f;
                pds[r * S_STRIDE + j] = p[i] * ksc;
                dss[r * S_STRIDE + j] = p[i] * (dp * ksc - dr);
            }
        }
        __syncthreads();

        // Accumulation phase: dv[kj] += sum_r pd[r, kj] do[r]; dk[kj] += sum_r ds[r, kj] q[r].
#pragma unroll 4
        for (int r = 0; r < BLOCK_M; ++r) {
            const float pd = pds[r * S_STRIDE + kj];
            const float ds = dss[r * S_STRIDE + kj];
            const float4* dor = reinterpret_cast<const float4*>(dos + r * ROW);
            const float4* qr = reinterpret_cast<const float4*>(qs + r * ROW);
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                fma4(dv_acc[c], pd, dor[4 * c + sub]);
                fma4(dk_acc[c], ds, qr[4 * c + sub]);
            }
        }
    }

    const int s = s0 + kj;
    if (s < s_len) {
        const size_t off = (static_cast<size_t>(b) * s_len + s) * d_model + head_off;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            const int col = 4 * (4 * c + sub);
            store_as(dk + off + col + 0, dk_acc[c].x * sm_scale);
            store_as(dk + off + col + 1, dk_acc[c].y * sm_scale);
            store_as(dk + off + col + 2, dk_acc[c].z * sm_scale);
            store_as(dk + off + col + 3, dk_acc[c].w * sm_scale);
            store_as(dv + off + col + 0, dv_acc[c].x);
            store_as(dv + off + col + 1, dv_acc[c].y);
            store_as(dv + off + col + 2, dv_acc[c].z);
            store_as(dv + off + col + 3, dv_acc[c].w);
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per (query tile, head, batch row)
// ---------------------------------------------------------------------------
template <int DH>
struct DqSmem {
    static constexpr int ROW = DH + 4;
    static constexpr size_t BYTES =
        (2 * BLOCK_N * ROW + BLOCK_M * S_STRIDE) * sizeof(float)
        + BLOCK_N * sizeof(int) + BLOCK_M * KEEP_STRIDE;
};

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t_len, int s_len, int num_heads,
          float scale_log2, float sm_scale, mmd_philox::Dropout drop) {
    constexpr int ROW = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);   // [BLOCK_N][ROW]
    float* vs = ks + BLOCK_N * ROW;                 // [BLOCK_N][ROW]
    float* dss = vs + BLOCK_N * ROW;                // [BLOCK_M][S_STRIDE]
    int* kvalid = reinterpret_cast<int*>(dss + BLOCK_M * S_STRIDE);   // [BLOCK_N]
    uint8_t* keep = reinterpret_cast<uint8_t*>(kvalid + BLOCK_N);     // [BLOCK_M][KEEP_STRIDE]

    const int tid = threadIdx.x;
    const int r = tid / TPR;
    const int sub = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BLOCK_M;
    const int t = t0 + r;
    const bool row_ok = t < t_len;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const size_t row_off = (static_cast<size_t>(b) * t_len + t) * d_model + head_off;
    const size_t stat = (static_cast<size_t>(b) * num_heads + h) * t_len + t;

    // This thread's row of q (pre-scaled into the exp2 domain) and of do.
    float qr[DH], dor[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
        qr[d] = row_ok ? to_float(q[row_off + d]) * scale_log2 : 0.f;
        dor[d] = row_ok ? to_float(dout[row_off + d]) : 0.f;
    }
    const float l2 = row_ok ? lse[stat] * LOG2E : -CUDART_INF_F;
    const float dr = row_ok ? delta[stat] : 0.f;
    const bool row_live = l2 != -CUDART_INF_F;

    float4 acc[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int s0 = 0; s0 < s_len; s0 += BLOCK_N) {
        __syncthreads();                     // the previous tile is consumed
        stage_rows<T, DH>(ks, kb, s0, s_len, d_model, tid);
        stage_rows<T, DH>(vs, vb, s0, s_len, d_model, tid);
        if (tid < BLOCK_N) {
            const int s = s0 + tid;
            kvalid[tid] = (s < s_len) &&
                          (key_valid == nullptr || key_valid[static_cast<size_t>(b) * s_len + s] != 0);
        }
        if constexpr (DROP) {
            mmd_philox::fill_keep_tile<BLOCK_M, BLOCK_N, KEEP_STRIDE>(
                keep, tid, THREADS, b, h, num_heads, t0, t_len, s0, s_len, drop);
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int j = sub + TPR * i;
            const float s = dot_row<DH>(qr, ks + j * ROW);
            const float p = (row_live && kvalid[j]) ? exp2f(s - l2) : 0.f;
            const float dp = dot_row<DH>(dor, vs + j * ROW);
            float ksc = 1.f;
            if constexpr (DROP) ksc = keep[r * KEEP_STRIDE + j] ? drop.scale : 0.f;
            dss[r * S_STRIDE + j] = p * (dp * ksc - dr);
        }
        __syncwarp();                        // the row's ds was written by this warp

        const float4* dsr = reinterpret_cast<const float4*>(dss + r * S_STRIDE);
#pragma unroll 4
        for (int j4 = 0; j4 < BLOCK_N / 4; ++j4) {
            const float4 d4 = dsr[j4];
            const float dsj[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float4* kr = reinterpret_cast<const float4*>(ks + (4 * j4 + jj) * ROW);
#pragma unroll
                for (int c = 0; c < CHUNKS; ++c) fma4(acc[c], dsj[jj], kr[4 * c + sub]);
            }
        }
    }

    if (row_ok) {
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            T* dst = dq + row_off + 4 * (4 * c + sub);
            store_as(dst + 0, acc[c].x * sm_scale);
            store_as(dst + 1, acc[c].y * sm_scale);
            store_as(dst + 2, acc[c].z * sm_scale);
            store_as(dst + 3, acc[c].w * sm_scale);
        }
    }
}

struct Args {
    const void *q, *k, *v, *key_valid, *o, *dout, *lse;
    void *delta, *dq, *dk, *dv;
    int batch, t_len, s_len, num_heads;
};

template <typename T, int DH, bool DROP>
cudaError_t launch(const Args& a, const mmd_philox::Dropout& drop, cudaStream_t stream) {
    const float sm_scale = 1.f / sqrtf(static_cast<float>(DH));
    const float scale_log2 = sm_scale * LOG2E;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const uint8_t* kv = static_cast<const uint8_t*>(a.key_valid);
    const float* lse = static_cast<const float*>(a.lse);
    float* delta = static_cast<float*>(a.delta);

    const int64_t rows = static_cast<int64_t>(a.batch) * a.t_len * a.num_heads;
    rowdot_kernel<T, DH><<<static_cast<unsigned>((rows + THREADS - 1) / THREADS), THREADS, 0,
                           stream>>>(static_cast<const T*>(a.o), dout, delta, a.batch, a.t_len,
                                     a.num_heads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t dkdv_smem = DkdvSmem<DH>::BYTES;
    err = cudaFuncSetAttribute(dkdv_kernel<T, DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem));
    if (err != cudaSuccess) return err;
    const dim3 kgrid((a.s_len + BLOCK_N - 1) / BLOCK_N, a.num_heads, a.batch);
    dkdv_kernel<T, DH, DROP><<<kgrid, THREADS, dkdv_smem, stream>>>(
        q, k, v, kv, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.t_len, a.s_len, a.num_heads, scale_log2, sm_scale, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t dq_smem = DqSmem<DH>::BYTES;
    err = cudaFuncSetAttribute(dq_kernel<T, DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem));
    if (err != cudaSuccess) return err;
    const dim3 qgrid((a.t_len + BLOCK_M - 1) / BLOCK_M, a.num_heads, a.batch);
    dq_kernel<T, DH, DROP><<<qgrid, THREADS, dq_smem, stream>>>(
        q, k, v, kv, dout, lse, delta, static_cast<T*>(a.dq), a.t_len, a.s_len,
        a.num_heads, scale_log2, sm_scale, drop);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rate(const Args& a, const mmd_philox::Dropout& drop, int dropout,
                        cudaStream_t stream) {
    return dropout ? launch<T, DH, true>(a, drop, stream) : launch<T, DH, false>(a, drop, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 for
// q, k, v, o, do and the outputs dq, dk, dv; lse is (B, H, T) fp32 natural
// log; delta is a (B, H, T) fp32 scratch. key_valid is a (B, S) uint8 array
// (nonzero = valid key) or NULL. dropout: 0 = none, 1 = regenerate the
// forward's attention-dropout mask from (seed, threshold) and scale kept
// weights by drop_scale. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int mmd_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq, void* dk, void* dv,
                                  int batch, int t_len, int s_len, int num_heads,
                                  int head_dim, int dtype, uint64_t seed,
                                  uint32_t threshold, float drop_scale, int dropout,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || t_len <= 0 || s_len <= 0 || num_heads <= 0 ||
        num_heads > 65535 || batch > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv,
                 batch, t_len, s_len, num_heads};
    const mmd_philox::Dropout dp{seed, threshold, drop_scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32) return launch_rate<float, 32>(a, dp, dropout, st);
    if (dtype == 0 && head_dim == 64) return launch_rate<float, 64>(a, dp, dropout, st);
    if (dtype == 1 && head_dim == 32) return launch_rate<__nv_bfloat16, 32>(a, dp, dropout, st);
    if (dtype == 1 && head_dim == 64) return launch_rate<__nv_bfloat16, 64>(a, dp, dropout, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
