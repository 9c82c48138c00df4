// Flash-attention forward for Hopper (sm_90a), non-causal, with an optional
// (B, S) key mask and optional attention dropout.
//
// Replaces mmd_tpu/ops/attention.py::_flash_fwd (its Pallas body
// _fwd_kernel) on the serving path: every text-encoder layer (T = S = 512,
// masked), every ViT layer (T = S = 64) and the eight attentions of the
// fusion model ((T, S) in {512, 64}^2); and on the training path the
// fusion model's eight attentions with dropout on the attention weights.
//
// What it computes, per batch row b and head h:
//   o[b, t, h]   = sum_s softmax_s(q[b,t,h] . k[b,s,h] / sqrt(dh) | valid keys) v[b,s,h]
//   lse[b, h, t] = log sum_{valid s} exp(q[b,t,h] . k[b,s,h] / sqrt(dh))
// q is (B, T, D), k and v are (B, S, D), D = H * dh, all row-major and
// contiguous; heads are split by strides here, never by transposes in device
// memory. lse is the NATURAL log (the TPU kernel stores log2). A query row
// with no valid key gets o = 0 and lse = -inf: the mask is a boolean, the
// running max is taken over valid keys only and l sums valid keys only, so
// no -1e9 bias can turn such a row into a uniform softmax.
//
// Dropout (rate > 0, the DROP instantiation): the normalized weight of
// (b, h, t, s) is kept when the Philox draw of its row-major index in the
// (B, H, T, S) weights is below `threshold` (philox.cuh), and kept weights
// are scaled by 1 / (1 - rate):
//   o[b, t, h] = sum_s p[t, s] keep[t, s] scale v[s] / l[t]
// l and lse sum the UNDROPPED p, so lse does not depend on the mask and the
// backward (flash_attn_bwd.cu) regenerates the mask from the seed alone.
// Each 64 x 64 tile's mask is drawn into shared memory, one Philox call per
// 4 keys of a row, while K and V are staged. rate = 0 compiles the
// instantiation without any of it, so serving results are unchanged bit for
// bit.
//
// What bounds it on this card: the score work, 4 * B * H * T * S * dh
// operations, against K/V bytes, 2 * B * S * D elements read once from
// device memory (the T / 64 query tiles that re-read a K/V tile find it in
// the 50 MB L2). That is T operations per bf16 K/V byte (T / 2 in fp32):
// 512 for the text and evidence shapes, 64 for the ViT's. Plain FMA on the
// CUDA cores (67 TFLOP/s fp32 against 3.35 TB/s) stops being the limit at
// ~20 operations per byte, so at every shape of the slice this kernel is
// bound by its arithmetic and by the shared-memory bandwidth that feeds it,
// not by device memory. Dropout adds one Philox4x32-10 call (~100 integer
// instructions) per 4 weights against the 4 * dh = 128 FMAs of each
// weight's score and P.V at the fusion model's dh = 32: roughly a fifth
// more issued instructions, still no device-memory traffic.
//
// What the design does about that (first version: simple and right):
//   * one CTA of 256 threads per (64-row query tile, head, batch row);
//     4 threads share a query row, each holding the whole pre-scaled q row
//     in registers and 16 of the tile's 64 keys;
//   * S is walked in 64-key tiles staged in shared memory as fp32; rows
//     are padded so the float4 reads of the 4 threads of a row fall in
//     different banks, which cuts shared-memory instructions 4x against
//     scalar reads;
//   * online softmax in fp32 in the exp2 domain (scale and log2(e) folded
//     into q once), P kept in fp32 in shared memory and P.V accumulated in
//     fp32: bf16 and fp32 inputs share one code path;
//   * plain FMA on the CUDA cores. Tensor cores (mma.sync / wgmma with TMA)
//     are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int BLOCK_M = 64;                  // query rows per CTA
constexpr int BLOCK_N = 64;                  // keys per shared-memory tile
constexpr int TPR = 4;                       // threads per query row
constexpr int THREADS = BLOCK_M * TPR;       // 256
constexpr int KEYS_PER_THREAD = BLOCK_N / TPR;
constexpr int P_STRIDE = BLOCK_N + 4;        // floats per P row (16-byte aligned, bank-skewed)
constexpr int KEEP_STRIDE = BLOCK_N + 4;     // mask bytes per row (bank-skewed)
constexpr float LN2 = 0.69314718055994531f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DH>
struct Smem {
    static constexpr int K_STRIDE = DH + 4;  // floats per K row
    static constexpr int K_FLOATS = BLOCK_N * K_STRIDE;
    static constexpr int V_FLOATS = BLOCK_N * DH;
    static constexpr int P_FLOATS = BLOCK_M * P_STRIDE;
    static constexpr size_t BYTES =
        (K_FLOATS + V_FLOATS + P_FLOATS) * sizeof(float) + BLOCK_N * sizeof(int);
    static constexpr size_t DROP_BYTES = BYTES + BLOCK_M * KEEP_STRIDE;
};

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                 T* __restrict__ o, float* __restrict__ lse,
                 int t_len, int s_len, int num_heads, float scale_log2,
                 mmd_philox::Dropout drop) {
    static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
    using S = Smem<DH>;
    constexpr int CHUNKS = DH / 16;          // float4 output chunks per thread

    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);      // [BLOCK_N][K_STRIDE]
    float* vs = ks + S::K_FLOATS;                      // [BLOCK_N][DH]
    float* ps = vs + S::V_FLOATS;                      // [BLOCK_M][P_STRIDE]
    int* kvalid = reinterpret_cast<int*>(ps + S::P_FLOATS);  // [BLOCK_N]
    uint8_t* keep = reinterpret_cast<uint8_t*>(kvalid + BLOCK_N);  // DROP only

    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int sub = tid % TPR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t = blockIdx.x * BLOCK_M + row;
    const int d_model = num_heads * DH;
    const bool row_ok = t < t_len;

    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const uint8_t* mb = key_valid ? key_valid + static_cast<size_t>(b) * s_len : nullptr;

    // The whole query row, pre-scaled into the exp2 domain.
    float qr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
        qr[d] = row_ok ? to_float(qb[static_cast<size_t>(t) * d_model + d]) * scale_log2 : 0.f;
    }

    // This thread owns output columns [4 * (4 * c + sub), +4) for c < CHUNKS.
    float4 acc[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m_run = -CUDART_INF_F;             // running max over valid keys (log2 domain)
    float l_run = 0.f;                       // running sum over valid keys

    for (int s0 = 0; s0 < s_len; s0 += BLOCK_N) {
        __syncthreads();                     // the previous tile is consumed
        for (int i = tid; i < BLOCK_N * DH; i += THREADS) {
            const int j = i / DH;
            const int d = i % DH;
            const int s = s0 + j;
            float kx = 0.f, vx = 0.f;        // ragged tail: zeros, never garbage
            if (s < s_len) {
                kx = to_float(kb[static_cast<size_t>(s) * d_model + d]);
                vx = to_float(vb[static_cast<size_t>(s) * d_model + d]);
            }
            ks[j * S::K_STRIDE + d] = kx;
            vs[j * DH + d] = vx;
        }
        if (tid < BLOCK_N) {
            const int s = s0 + tid;
            kvalid[tid] = (s < s_len) && (mb == nullptr || mb[s] != 0);
        }
        if constexpr (DROP) {
            mmd_philox::fill_keep_tile<BLOCK_M, BLOCK_N, KEEP_STRIDE>(
                keep, tid, THREADS, b, h, num_heads, blockIdx.x * BLOCK_M, t_len, s0,
                s_len, drop);
        }
        __syncthreads();

        // Scores of this thread's keys j = sub + TPR * i.
        float sc[KEYS_PER_THREAD];
        float tile_max = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < KEYS_PER_THREAD; ++i) {
            const int j = sub + TPR * i;
            const float4* kr = reinterpret_cast<const float4*>(ks + j * S::K_STRIDE);
            float dot = 0.f;
#pragma unroll
            for (int d4 = 0; d4 < DH / 4; ++d4) {
                const float4 kk = kr[d4];
                dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
                dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
                dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
                dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
            }
            sc[i] = kvalid[j] ? dot : -CUDART_INF_F;
            tile_max = fmaxf(tile_max, sc[i]);
        }
        // The TPR threads of a row are adjacent lanes of one warp.
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(m_run, tile_max);
        // While no valid key has been seen m_new is -inf: subtract 0 instead
        // so that exp2 gives exact zeros rather than NaN.
        const float m_use = (m_new == -CUDART_INF_F) ? 0.f : m_new;
        const float alpha = exp2f(m_run - m_use);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < KEYS_PER_THREAD; ++i) {
            const float p = exp2f(sc[i] - m_use);
            psum += p;                       // l sums the undropped weights
            if constexpr (DROP) {
                const int j = sub + TPR * i;
                ps[row * P_STRIDE + j] = p * (keep[row * KEEP_STRIDE + j] ? drop.scale : 0.f);
            } else {
                ps[row * P_STRIDE + sub + TPR * i] = p;
            }
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l_run = l_run * alpha + psum;
        m_run = m_new;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
        }
        __syncwarp();                        // the row's P was written by this warp

        const float4* pr = reinterpret_cast<const float4*>(ps + row * P_STRIDE);
#pragma unroll 4
        for (int j4 = 0; j4 < BLOCK_N / 4; ++j4) {
            const float4 p4 = pr[j4];
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float4* vr = reinterpret_cast<const float4*>(vs + (4 * j4 + jj) * DH);
#pragma unroll
                for (int c = 0; c < CHUNKS; ++c) {
                    const float4 vv = vr[4 * c + sub];
                    acc[c].x = fmaf(pj[jj], vv.x, acc[c].x);
                    acc[c].y = fmaf(pj[jj], vv.y, acc[c].y);
                    acc[c].z = fmaf(pj[jj], vv.z, acc[c].z);
                    acc[c].w = fmaf(pj[jj], vv.w, acc[c].w);
                }
            }
        }
    }

    if (row_ok) {
        const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
        T* ob = o + (static_cast<size_t>(b) * t_len + t) * d_model + head_off;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            T* dst = ob + 4 * (4 * c + sub);
            store_as(dst + 0, acc[c].x * inv);
            store_as(dst + 1, acc[c].y * inv);
            store_as(dst + 2, acc[c].z * inv);
            store_as(dst + 3, acc[c].w * inv);
        }
        if (sub == 0) {
            lse[(static_cast<size_t>(b) * num_heads + h) * t_len + t] =
                l_run > 0.f ? (m_run + log2f(l_run)) * LN2 : -CUDART_INF_F;
        }
    }
}

template <typename T, int DH, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid,
                   void* o, void* lse, int batch, int t_len, int s_len, int num_heads,
                   const mmd_philox::Dropout& drop, cudaStream_t stream) {
    const size_t smem = DROP ? Smem<DH>::DROP_BYTES : Smem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH, DROP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((t_len + BLOCK_M - 1) / BLOCK_M, num_heads, batch);
    const float scale_log2 = LOG2E / sqrtf(static_cast<float>(DH));
    flash_fwd_kernel<T, DH, DROP><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(key_valid), static_cast<T*>(o),
        static_cast<float*>(lse), t_len, s_len, num_heads, scale_log2, drop);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rate(const void* q, const void* k, const void* v, const void* key_valid,
                        void* o, void* lse, int batch, int t_len, int s_len, int num_heads,
                        const mmd_philox::Dropout& drop, int dropout, cudaStream_t stream) {
    if (dropout)
        return launch<T, DH, true>(q, k, v, key_valid, o, lse, batch, t_len, s_len,
                                   num_heads, drop, stream);
    return launch<T, DH, false>(q, k, v, key_valid, o, lse, batch, t_len, s_len,
                                num_heads, drop, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// key_valid is a (B, S) uint8 array (nonzero = valid key) or NULL.
// dropout: 0 = none (seed, threshold and drop_scale unused), 1 = attention
// dropout with keep threshold `threshold` and scale `drop_scale`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mmd_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, void* o, void* lse,
                                  int batch, int t_len, int s_len, int num_heads,
                                  int head_dim, int dtype, uint64_t seed,
                                  uint32_t threshold, float drop_scale, int dropout,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || t_len <= 0 || s_len < 0 || num_heads <= 0 ||
        num_heads > 65535 || batch > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const mmd_philox::Dropout dp{seed, threshold, drop_scale};
    if (dtype == 0 && head_dim == 32)
        return launch_rate<float, 32>(q, k, v, key_valid, o, lse, batch, t_len, s_len,
                                      num_heads, dp, dropout, st);
    if (dtype == 0 && head_dim == 64)
        return launch_rate<float, 64>(q, k, v, key_valid, o, lse, batch, t_len, s_len,
                                      num_heads, dp, dropout, st);
    if (dtype == 1 && head_dim == 32)
        return launch_rate<__nv_bfloat16, 32>(q, k, v, key_valid, o, lse, batch, t_len,
                                              s_len, num_heads, dp, dropout, st);
    if (dtype == 1 && head_dim == 64)
        return launch_rate<__nv_bfloat16, 64>(q, k, v, key_valid, o, lse, batch, t_len,
                                              s_len, num_heads, dp, dropout, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
