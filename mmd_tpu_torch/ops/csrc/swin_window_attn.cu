// Swinv2 cosine window attention, serving forward, for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/swin_attention.py::swin_window_attention_infer (its
// Pallas body _infer_kernel) on the Swinv2 serving path: the window
// attention of every one of Swinv2-base's 24 blocks.
//
// What it computes, per window w, batch row b and head h, on the RAW
// post-projection q, k, v (window-major (nW, B, n, C), C = heads * dh):
//   q^ = q / max(|q|, 1e-12),  k^ = k / max(|k|, 1e-12)      per head, fp32
//   s[i, j] = (q^_i . k^_j) * scale[h] + bias[w, h, i, j]      natural log
//   o_i = sum_j exp(s[i, j] - m_i) v_j / max(sum_j exp(s[i, j] - m_i), 1e-37)
// scale[h] is the clamped logit scale exp(min(logit_scale_h, ln 100)); bias
// is fp32 (nWb, heads, n, n) with nWb = nW (the continuous position bias
// plus twice the shifted-window mask) or nWb = 1 (no shift: one bias for
// every window). The TPU kernel takes its bias and scale in the log2
// domain and rounds the squares to the input dtype before the norms; this
// kernel takes natural-log inputs and keeps the norms in fp32.
//
// What bounds it on this card: bytes. Per (window, batch row, head) it
// reads three 64 x 32 tiles and writes one, against 4 * 64 * 64 * 32
// operations: 64 operations per bf16 byte of q/k/v/o (32 in fp32), below
// the ~295 where the tensor cores would be the limit. The bias is shared by
// the batch rows of a window, so it is read from the L2 cache after the
// first of them.
//
// What the design does about that (first version: simple and right):
//   * one CTA of 256 threads per (head, batch row, window); 4 threads share
//     a query row, each holding the whole normalized, scaled q row in
//     registers and 16 of the window's 64 keys;
//   * q, k and v are read once, 16 bytes a thread, normalized on the way
//     into shared memory (fp32, bank-skewed rows), so nothing of the
//     normalization goes through device memory;
//   * scores, softmax and P.V in fp32 (plain FMA on the CUDA cores),
//     P kept in shared memory; n = 64 and dh in {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;                        // tokens per window (8 x 8)
constexpr int TPR = 4;                       // threads per query row
constexpr int THREADS = N * TPR;             // 256
constexpr int KEYS_PER_THREAD = N / TPR;     // 16
constexpr int P_STRIDE = N + 4;              // floats per P row
constexpr float LOG2E = 1.4426950408889634f;

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

template <int DH>
struct Smem {
    static constexpr int QK_STRIDE = DH + 4;
    static constexpr int Q_FLOATS = N * QK_STRIDE;
    static constexpr int V_FLOATS = N * DH;
    static constexpr int P_FLOATS = N * P_STRIDE;
    static constexpr size_t BYTES = (2 * Q_FLOATS + V_FLOATS + P_FLOATS) * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
swin_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ scale, T* __restrict__ o,
                 int batch, int heads, int bias_windows) {
    using S = Smem<DH>;
    constexpr int PER = DH / TPR;            // values of a row each thread loads
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // values per 16 bytes
    constexpr int CHUNKS = DH / 16;          // float4 output chunks per thread
    static_assert(PER % VEC == 0, "a thread's slice of a row is whole 16-byte loads");

    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);       // [N][QK_STRIDE]
    float* ks = qs + S::Q_FLOATS;                       // [N][QK_STRIDE]
    float* vs = ks + S::Q_FLOATS;                       // [N][DH]
    float* ps = vs + S::V_FLOATS;                       // [N][P_STRIDE]

    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int sub = tid % TPR;
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int w = blockIdx.z;
    const int c = heads * DH;
    const size_t base = (static_cast<size_t>(w) * batch + b) * N * c +
                        static_cast<size_t>(h) * DH;

    // Load this thread's PER values of row `row`, normalize per head.
    {
        const size_t off = base + static_cast<size_t>(row) * c + sub * PER;
        float qv[PER], kv[PER], vv[PER];
#pragma unroll
        for (int e = 0; e < PER; e += VEC) {
            load16(q + off + e, qv + e);
            load16(k + off + e, kv + e);
            load16(v + off + e, vv + e);
        }
        float qq = 0.f, kk = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) {
            qq = fmaf(qv[e], qv[e], qq);
            kk = fmaf(kv[e], kv[e], kk);
        }
        // the TPR threads of a row are adjacent lanes of one warp
        qq += __shfl_xor_sync(0xffffffffu, qq, 1);
        qq += __shfl_xor_sync(0xffffffffu, qq, 2);
        kk += __shfl_xor_sync(0xffffffffu, kk, 1);
        kk += __shfl_xor_sync(0xffffffffu, kk, 2);
        const float qn = fmaxf(sqrtf(qq), 1e-12f);
        const float kn = fmaxf(sqrtf(kk), 1e-12f);
        const float sh = scale[h];
#pragma unroll
        for (int e = 0; e < PER; ++e) {
            qs[row * S::QK_STRIDE + sub * PER + e] = (qv[e] / qn) * sh;
            ks[row * S::QK_STRIDE + sub * PER + e] = kv[e] / kn;
            vs[row * DH + sub * PER + e] = vv[e];
        }
    }
    __syncthreads();

    float qr[DH];
    {
        const float4* qrow = reinterpret_cast<const float4*>(qs + row * S::QK_STRIDE);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 x = qrow[d4];
            qr[4 * d4] = x.x; qr[4 * d4 + 1] = x.y; qr[4 * d4 + 2] = x.z; qr[4 * d4 + 3] = x.w;
        }
    }
    const int bw = bias_windows == 1 ? 0 : w;
    const float* brow = bias + ((static_cast<size_t>(bw) * heads + h) * N + row) * N;

    float sc[KEYS_PER_THREAD];
    float mx = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
        const int j = sub + TPR * i;
        const float4* kr = reinterpret_cast<const float4*>(ks + j * S::QK_STRIDE);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        sc[i] = dot + __ldg(brow + j);
        mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
        const float p = exp2f((sc[i] - mx) * LOG2E);
        l += p;
        ps[row * P_STRIDE + sub + TPR * i] = p;
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    __syncwarp();                            // the row's P was written by this warp

    // This thread owns output columns [4 * (4 * ch + sub), +4) for ch < CHUNKS.
    float4 acc[CHUNKS];
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) acc[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* pr = reinterpret_cast<const float4*>(ps + row * P_STRIDE);
#pragma unroll 4
    for (int j4 = 0; j4 < N / 4; ++j4) {
        const float4 p4 = pr[j4];
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const float4* vr = reinterpret_cast<const float4*>(vs + (4 * j4 + jj) * DH);
#pragma unroll
            for (int ch = 0; ch < CHUNKS; ++ch) {
                const float4 x = vr[4 * ch + sub];
                acc[ch].x = fmaf(pj[jj], x.x, acc[ch].x);
                acc[ch].y = fmaf(pj[jj], x.y, acc[ch].y);
                acc[ch].z = fmaf(pj[jj], x.z, acc[ch].z);
                acc[ch].w = fmaf(pj[jj], x.w, acc[ch].w);
            }
        }
    }
    const float inv = 1.f / fmaxf(l, 1e-37f);
    T* orow = o + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
        T* dst = orow + 4 * (4 * ch + sub);
        store_as(dst + 0, acc[ch].x * inv);
        store_as(dst + 1, acc[ch].y * inv);
        store_as(dst + 2, acc[ch].z * inv);
        store_as(dst + 3, acc[ch].w * inv);
    }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* scale, void* o, int windows, int batch, int heads,
                   int bias_windows, cudaStream_t stream) {
    const size_t smem = Smem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(swin_attn_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(heads, batch, windows);
    swin_attn_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(scale),
        static_cast<T*>(o), batch, heads, bias_windows);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, o are (windows, batch, 64,
// heads * head_dim) contiguous, bias (bias_windows, heads, 64, 64) fp32 with
// bias_windows 1 or windows, scale (heads,) fp32. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int mmd_swin_window_attn_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* scale, void* o,
                                        int windows, int batch, int n, int heads,
                                        int head_dim, int bias_windows, int dtype,
                                        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n != N || windows <= 0 || windows > 65535 || batch <= 0 || batch > 65535 ||
        heads <= 0 || (bias_windows != 1 && bias_windows != windows)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch<float, 32>(q, k, v, bias, scale, o, windows, batch, heads, bias_windows, st);
    if (dtype == 0 && head_dim == 64)
        return launch<float, 64>(q, k, v, bias, scale, o, windows, batch, heads, bias_windows, st);
    if (dtype == 1 && head_dim == 32)
        return launch<__nv_bfloat16, 32>(q, k, v, bias, scale, o, windows, batch, heads, bias_windows, st);
    if (dtype == 1 && head_dim == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, bias, scale, o, windows, batch, heads, bias_windows, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
