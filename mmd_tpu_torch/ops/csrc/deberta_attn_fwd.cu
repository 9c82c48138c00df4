// DeBERTa-v3 disentangled attention forward for Hopper (sm_90a).
//
// Replaces mmd_tpu/models/deberta.py::_deberta_attn_fused (its Pallas body
// _deberta_attn_kernel) on the DeBERTa serving path: the attention of every
// one of DeBERTa-v3-xsmall's 12 layers.
//
// What it computes, per batch row b and head h (dh = D / H), for query t and
// key s of a length-T sequence:
//   score[t, s] = (q_t . k_s + q_t . PK[T-1-t+s] + k_s . PQ[T-1-s+t]) * scale
//   score[t, s] = finfo(float32).min where key s is masked
//   o_t = softmax_s(score[t, :]) . v
// q, k, v are (B, T, D); PK and PQ are (2T, D) tables shared by the batch
// (the key and query projections of the relative embeddings, gathered by
// the diagonal maps; row 2T-1 is padding and never read); key_valid is a
// (B, T) uint8 mask. Heads are split by strides here, never by transposes
// in device memory. A masked key's score is the most negative finite
// float, not -inf, as in the reference: a query row with no valid key gets
// the uniform mean of V, and padded query rows are computed like any other.
// Scores stay in fp32 (the TPU kernel's bf16 score rounding, LOWP_SCORES,
// is not reproduced).
//
// What bounds it on this card: operations. 8 * B * T^2 * D per call (the
// content, c2p, p2c and P.V products) against (4 B T + 4 T) D elements of
// q/k/v/o/PK/PQ: at the serving shape (B 16, T 512, D 384) about 480
// operations per bf16 byte, above the ~295 where the tensor cores and not
// device memory are the limit. This first version runs the products on the
// CUDA cores in fp32 (67 TFLOP/s), so it is bound by its FMAs and by the
// shared-memory reads that feed them.
//
// What the design does about that (first version: simple and right):
//   * one CTA of 256 threads per (64-query tile, head, batch row), looping
//     over 64-key tiles with an online softmax in fp32 (exp2 domain);
//   * per key tile, the Q tile, K and V tiles and the two 127-row bands of
//     PK and PQ that the tile pair touches are staged in shared memory as
//     fp32 (16-byte loads, bank-skewed rows);
//   * each thread computes a 4 x 4 block of scores at rows ty + 16 j and
//     columns tx + 16 i: the c2p and p2c rows it needs then lie on 7
//     diagonals, so one d-step reads 4 q, 4 k, 7 PK and 7 PQ float4s for
//     48 x 4 FMAs;
//   * P goes through shared memory once per tile for P.V; T % 64 == 0 and
//     dh in {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                       // query rows per CTA
constexpr int BN = 64;                       // keys per tile
constexpr int BAND = 128;                    // PK / PQ rows per tile pair (127 used)
constexpr int THREADS = 256;                 // 16 x 16 threads, 4 x 4 scores each
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

__device__ __forceinline__ float comp(const float4 a, int i) {
    return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <int DH>
struct Smem {
    static constexpr int ST = DH + 4;        // floats per staged row
    static constexpr size_t FLOATS =
        static_cast<size_t>(BM + 2 * BN + 2 * BAND) * ST + BM * P_STRIDE;
    static constexpr size_t BYTES = FLOATS * sizeof(float) + BN * sizeof(int);
};

// rows x DH values of a row-major array (row stride `stride` elements) into
// shared memory as fp32 rows of Smem<DH>::ST floats.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int stride, int rows) {
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = DH / VEC;            // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int r = i / CPR;
        const int ch = i % CPR;
        float x[VEC];
        load16(src + static_cast<size_t>(r) * stride + ch * VEC, x);
        float* d = dst + r * Smem<DH>::ST + ch * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
            *reinterpret_cast<float4*>(d + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        }
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ pk,
                    const T* __restrict__ pq, const uint8_t* __restrict__ key_valid,
                    T* __restrict__ o, int t_len, int num_heads, float scale_log2) {
    using S = Smem<DH>;
    constexpr int ST = S::ST;
    constexpr int E = DH / 16;               // output columns per thread

    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [BM][ST]
    float* ks = qs + BM * ST;                      // [BN][ST]
    float* vs = ks + BN * ST;                      // [BN][ST]
    float* pks = vs + BN * ST;                     // [BAND][ST]
    float* pqs = pks + BAND * ST;                  // [BAND][ST]
    float* ps = pqs + BAND * ST;                   // [BM][P_STRIDE]
    int* kvalid = reinterpret_cast<int*>(ps + BM * P_STRIDE);  // [BN]

    const int tid = threadIdx.x;
    const int ty = tid >> 4;                 // rows ty + 16 j
    const int tx = tid & 15;                 // score columns tx + 16 i
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BM;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * t_len * d_model + head_off;
    const uint8_t* mb = key_valid + static_cast<size_t>(b) * t_len;

    stage<T, DH>(qs, qb + static_cast<size_t>(t0) * d_model, d_model, BM);

    float m_run[4], l_run[4], acc[4][E];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m_run[j] = -CUDART_INF_F;
        l_run[j] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
    }

    for (int s0 = 0; s0 < t_len; s0 += BN) {
        __syncthreads();                     // the previous tile is consumed
        stage<T, DH>(ks, kb + static_cast<size_t>(s0) * d_model, d_model, BN);
        stage<T, DH>(vs, vb + static_cast<size_t>(s0) * d_model, d_model, BN);
        // local row 63 - r + c of the PK band is table row T-1-(t0+r)+(s0+c);
        // local row 63 - c + r of the PQ band is table row T-1-(s0+c)+(t0+r)
        const int base_k = t_len - BM - t0 + s0;
        const int base_q = t_len - BN - s0 + t0;
        stage<T, DH>(pks, pk + static_cast<size_t>(base_k) * d_model + head_off, d_model, BAND);
        stage<T, DH>(pqs, pq + static_cast<size_t>(base_q) * d_model + head_off, d_model, BAND);
        if (tid < BN) kvalid[tid] = mb[s0 + tid] != 0;
        __syncthreads();

        float s[4][4];
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

#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float mx = NEG;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                s[j][i] = kvalid[tx + 16 * i] ? s[j][i] * scale_log2 : NEG;
                mx = fmaxf(mx, s[j][i]);
            }
            // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            // m_new is finite (NEG at least), so a first tile of masked keys
            // gives p = 1 for each and alpha = 0 against the initial -inf
            const float m_new = fmaxf(m_run[j], mx);
            const float alpha = exp2f(m_run[j] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = exp2f(s[j][i] - m_new);
                psum += p;
                ps[(ty + 16 * j) * P_STRIDE + tx + 16 * i] = p;
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
            l_run[j] = l_run[j] * alpha + psum;
            m_run[j] = m_new;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
        }
        __syncwarp();                        // a row's P is written and read by one half-warp

#pragma unroll 2
        for (int c = 0; c < BN; c += 4) {
            float4 pv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                pv[j] = *reinterpret_cast<const float4*>(ps + (ty + 16 * j) * P_STRIDE + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const float* vr = vs + (c + cc) * ST + tx * E;
                float vv[E];
#pragma unroll
                for (int e = 0; e < E; ++e) vv[e] = vr[e];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float p = comp(pv[j], cc);
#pragma unroll
                    for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
                }
            }
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int t = t0 + ty + 16 * j;
        const float inv = 1.f / l_run[j];    // l >= 1: the row max contributes exp2(0)
        T* orow = o + (static_cast<size_t>(b) * t_len + t) * d_model + head_off + tx * E;
#pragma unroll
        for (int e = 0; e < E; ++e) store_as(orow + e, acc[j][e] * inv);
    }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pk,
                   const void* pq, const void* key_valid, void* o, int batch, int t_len,
                   int num_heads, float scale, cudaStream_t stream) {
    const size_t smem = Smem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(deberta_attn_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(t_len / BM, num_heads, batch);
    const float scale_log2 = scale * 1.4426950408889634f;
    deberta_attn_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(pk), static_cast<const T*>(pq),
        static_cast<const uint8_t*>(key_valid), static_cast<T*>(o), t_len, num_heads,
        scale_log2);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, o are (batch, t_len, heads *
// head_dim), pk and pq (2 * t_len, heads * head_dim), all of one dtype and
// contiguous; key_valid is (batch, t_len) uint8. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int mmd_deberta_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* pk, const void* pq, const void* key_valid,
                                    void* o, int batch, int t_len, int num_heads,
                                    int head_dim, float scale, int dtype, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 65535 ||
        t_len <= 0 || t_len % BM != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch<float, 32>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads, scale, st);
    if (dtype == 0 && head_dim == 64)
        return launch<float, 64>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads, scale, st);
    if (dtype == 1 && head_dim == 32)
        return launch<__nv_bfloat16, 32>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads, scale, st);
    if (dtype == 1 && head_dim == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
