// Swinv2 window attention for fine-tuning, forward and backward, for Hopper
// (sm_90a).
//
// Replaces mmd_tpu/ops/swin_attention.py::_call_fwd (its Pallas body
// _kernel) and ::_swin_attn_bwd (its Pallas body _bwd_kernel), the custom
// VJP `swin_window_attention`, on the fine-tuning path of Swinv2-base: the
// window attention of each of its 24 blocks, forward and backward.
//
// What it computes, per window w, batch row b and head h, on window-major
// (nW, B, n, C) inputs, C = heads * dh, n = 64:
//   s[i, j] = q'_i . k_j + bias[w, h, i, j]           (log2 domain)
//   P = softmax2(s): exp2(s - m_i) / max(sum_j exp2(s - m_i), 1e-37)
//   o_i = sum_j P[i, j] v_j                                  (forward)
//   dP[i, j] = do_i . v_j,  D_i = sum_j P dP
//   ds[i, j] = ln2 * P (dP - D_i)
//   dq'_i = sum_j ds[i, j] k_j,  dk_j = sum_i ds[i, j] q'_i,
//   dv_j = sum_i P[i, j] do_i,  dbias[w, h] = sum_b ds      (backward)
// q' arrives L2-normalized per head and pre-scaled by the clamped logit
// scale times log2(e), k L2-normalized, both in the caller's code, where
// autograd differentiates the normalization; bias is fp32 (nW, heads, n, n)
// in the log2 domain (the continuous position bias plus twice the shift
// mask, times log2(e)). Scores, softmax and sums are fp32; outputs are in
// the input dtype, dbias in fp32. The TPU kernel packs the bias into lane
// segments and rounds P to the input dtype before P.V; neither is carried
// over (Mosaic layout details).
//
// dbias sums over the batch. The TPU grid runs in order and adds each batch
// block into one revisited output block; here one CTA per (head, window,
// group of batch rows) keeps its group's sum in registers, writes it to a
// (groups, nW, heads, n, n) fp32 workspace, and a second kernel sums the
// groups in a fixed order: deterministic, no atomics.
//
// What bounds it on this card: bytes. Per (window, batch row, head) the
// forward reads three 64 x dh tiles and writes one for 4 * 64 * 64 * dh
// operations, 64 operations per bf16 byte at dh 32; the backward reads five
// and writes three for 10 * 64 * 64 * dh, ~100 a byte; both below the
// ~295 where the tensor cores would be the limit. The bias tile is shared
// by the batch rows of a window, so it comes from the L2 cache after the
// first of them.
//
// What the design does about that (first version: simple and right):
//   * 256 threads a CTA; 4 threads share a query row, each holding that row
//     of q' (and of do) in registers and 16 of the window's 64 keys, as the
//     serving kernel (swin_window_attn.cu) does;
//   * tiles are read once, 16 bytes a thread, into shared memory as fp32
//     with rows padded to dh + 4 floats; P and ds go through shared memory
//     once for the three products of the backward;
//   * plain FMA on the CUDA cores; n = 64 and dh in {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 64;                        // tokens per window (8 x 8)
constexpr int TPR = 4;                       // threads per query row
constexpr int THREADS = N * TPR;             // 256
constexpr int KEYS_PER_THREAD = N / TPR;     // 16
constexpr int P_STRIDE = N + 4;              // floats per P / ds row
constexpr float LN2 = 0.6931471805599453f;

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

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 x) {
    acc.x = fmaf(a, x.x, acc.x);
    acc.y = fmaf(a, x.y, acc.y);
    acc.z = fmaf(a, x.z, acc.z);
    acc.w = fmaf(a, x.w, acc.w);
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

// This thread's PER values of row `row` of one (n, C) window tile, head
// columns, into an fp32 shared-memory tile of row stride DH + 4.
template <typename T, int DH>
__device__ __forceinline__ void stage_row(float* dst, const T* src, int row, int sub, int c) {
    constexpr int PER = DH / TPR;
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    static_assert(PER % VEC == 0, "a thread's slice of a row is whole 16-byte loads");
    float x[PER];
#pragma unroll
    for (int e = 0; e < PER; e += VEC) load16(src + static_cast<size_t>(row) * c + sub * PER + e, x + e);
    float* d = dst + row * (DH + 4) + sub * PER;
#pragma unroll
    for (int e = 0; e < PER; e += 4) {
        *reinterpret_cast<float4*>(d + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
}

template <int DH>
__device__ __forceinline__ void row_regs(const float* tile, int row, float (&x)[DH]) {
    const float4* r4 = reinterpret_cast<const float4*>(tile + row * (DH + 4));
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 y = r4[d4];
        x[4 * d4] = y.x; x[4 * d4 + 1] = y.y; x[4 * d4 + 2] = y.z; x[4 * d4 + 3] = y.w;
    }
}

// The softmax weights of this thread's 16 keys (j = sub + 4 i) of row `row`:
// scores from q' in registers, the staged k tile and the bias row.
template <int DH>
__device__ __forceinline__ void softmax_row(const float (&qr)[DH], const float* ks,
                                            const float* brow, int sub,
                                            float (&p)[KEYS_PER_THREAD]) {
    float mx = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
        const int j = sub + TPR * i;
        p[i] = dot_row<DH>(qr, ks + j * (DH + 4)) + __ldg(brow + j);
        mx = fmaxf(mx, p[i]);
    }
    // the TPR threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
        p[i] = exp2f(p[i] - mx);
        l += p[i];
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) p[i] *= inv;
}

// ---------------------------------------------------------------------------
// #8: the forward, one CTA per (head, batch row, window)
// ---------------------------------------------------------------------------
template <int DH>
struct FwdSmem {
    static constexpr size_t BYTES = (3 * N * (DH + 4) + N * P_STRIDE) * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
swin_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, T* __restrict__ o, int batch, int heads) {
    constexpr int ST = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [N][ST]
    float* ks = qs + N * ST;                        // [N][ST]
    float* vs = ks + N * ST;                        // [N][ST]
    float* ps = vs + N * ST;                        // [N][P_STRIDE]

    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int sub = tid % TPR;
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int w = blockIdx.z;
    const int c = heads * DH;
    const size_t base = (static_cast<size_t>(w) * batch + b) * N * c + static_cast<size_t>(h) * DH;

    stage_row<T, DH>(qs, q + base, row, sub, c);
    stage_row<T, DH>(ks, k + base, row, sub, c);
    stage_row<T, DH>(vs, v + base, row, sub, c);
    __syncthreads();

    float qr[DH];
    row_regs<DH>(qs, row, qr);
    const float* brow = bias + ((static_cast<size_t>(w) * heads + h) * N + row) * N;
    float p[KEYS_PER_THREAD];
    softmax_row<DH>(qr, ks, brow, sub, p);
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) ps[row * P_STRIDE + sub + TPR * i] = p[i];
    __syncwarp();                            // the row's P was written by this warp

    // This thread owns output columns [4 * (4 * ch + sub), +4) for ch < CHUNKS.
    float4 acc[CHUNKS];
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) acc[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* pr = ps + row * P_STRIDE;
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
        const float pj = pr[j];
        const float4* vr = reinterpret_cast<const float4*>(vs + j * ST);
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) fma4(acc[ch], pj, vr[4 * ch + sub]);
    }
    T* orow = o + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
        T* dst = orow + 4 * (4 * ch + sub);
        store_as(dst + 0, acc[ch].x);
        store_as(dst + 1, acc[ch].y);
        store_as(dst + 2, acc[ch].z);
        store_as(dst + 3, acc[ch].w);
    }
}

// ---------------------------------------------------------------------------
// #9: the backward, one CTA per (head, window, group of batch rows)
// ---------------------------------------------------------------------------
template <int DH>
struct BwdSmem {
    static constexpr size_t BYTES = (4 * N * (DH + 4) + 2 * N * P_STRIDE) * sizeof(float);
};

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float4 x) {
    store_as(dst + 0, x.x);
    store_as(dst + 1, x.y);
    store_as(dst + 2, x.z);
    store_as(dst + 3, x.w);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
swin_train_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, const T* __restrict__ dout, T* __restrict__ dq,
           T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ ws, int windows,
           int batch, int heads, int per_group) {
    constexpr int ST = DH + 4;
    constexpr int CHUNKS = DH / 16;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [N][ST]
    float* ks = qs + N * ST;                        // [N][ST]
    float* vs = ks + N * ST;                        // [N][ST]
    float* dos = vs + N * ST;                       // [N][ST]
    float* ps = dos + N * ST;                       // [N][P_STRIDE]
    float* dss = ps + N * P_STRIDE;                 // [N][P_STRIDE]

    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int sub = tid % TPR;
    const int h = blockIdx.x;
    const int w = blockIdx.y;
    const int grp = blockIdx.z;
    const int c = heads * DH;
    const float* brow = bias + ((static_cast<size_t>(w) * heads + h) * N + row) * N;

    float dbias[KEYS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) dbias[i] = 0.f;

    for (int b = grp * per_group; b < (grp + 1) * per_group; ++b) {
        const size_t base = (static_cast<size_t>(w) * batch + b) * N * c +
                            static_cast<size_t>(h) * DH;
        __syncthreads();                     // the previous batch row is consumed
        stage_row<T, DH>(qs, q + base, row, sub, c);
        stage_row<T, DH>(ks, k + base, row, sub, c);
        stage_row<T, DH>(vs, v + base, row, sub, c);
        stage_row<T, DH>(dos, dout + base, row, sub, c);
        __syncthreads();

        {
            float x[DH];
            row_regs<DH>(qs, row, x);
            float p[KEYS_PER_THREAD];
            softmax_row<DH>(x, ks, brow, sub, p);
            row_regs<DH>(dos, row, x);
            float dp[KEYS_PER_THREAD];
            float dsum = 0.f;
#pragma unroll
            for (int i = 0; i < KEYS_PER_THREAD; ++i) {
                dp[i] = dot_row<DH>(x, vs + (sub + TPR * i) * ST);
                dsum = fmaf(p[i], dp[i], dsum);
            }
            dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
            dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
#pragma unroll
            for (int i = 0; i < KEYS_PER_THREAD; ++i) {
                const int j = sub + TPR * i;
                const float ds = LN2 * p[i] * (dp[i] - dsum);
                ps[row * P_STRIDE + j] = p[i];
                dss[row * P_STRIDE + j] = ds;
                dbias[i] += ds;
            }
        }
        __syncthreads();

        // dq'[row] = sum_j ds[row, j] k_j: this thread's columns
        // [4 * (4 * ch + sub), +4); then dk[row], dv[row] with `row` as the key.
        float4 a[CHUNKS], bk[CHUNKS], bv[CHUNKS];
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
            a[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
            bk[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
            bv[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
            const float d = dss[row * P_STRIDE + j];
            const float dt = dss[j * P_STRIDE + row];
            const float pt = ps[j * P_STRIDE + row];
            const float4* kr = reinterpret_cast<const float4*>(ks + j * ST);
            const float4* qr = reinterpret_cast<const float4*>(qs + j * ST);
            const float4* dr = reinterpret_cast<const float4*>(dos + j * ST);
#pragma unroll
            for (int ch = 0; ch < CHUNKS; ++ch) {
                fma4(a[ch], d, kr[4 * ch + sub]);
                fma4(bk[ch], dt, qr[4 * ch + sub]);
                fma4(bv[ch], pt, dr[4 * ch + sub]);
            }
        }
        const size_t off = base + static_cast<size_t>(row) * c;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
            const int col = 4 * (4 * ch + sub);
            store4(dq + off + col, a[ch]);
            store4(dk + off + col, bk[ch]);
            store4(dv + off + col, bv[ch]);
        }
    }

    float* wrow = ws + (((static_cast<size_t>(grp) * windows + w) * heads + h) * N + row) * N;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) wrow[sub + TPR * i] = dbias[i];
}

// dbias[e] = sum over groups g of ws[g, e], in the order of g.
__global__ void __launch_bounds__(THREADS)
swin_train_dbias_kernel(const float* __restrict__ ws, float* __restrict__ dbias, int groups,
                    int64_t elems) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (idx >= elems) return;
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += ws[g * elems + idx];
    dbias[idx] = acc;
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                       int windows, int batch, int heads, cudaStream_t stream) {
    const size_t smem = FwdSmem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(swin_train_fwd_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    swin_train_fwd_kernel<T, DH><<<dim3(heads, batch, windows), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(o), batch, heads);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, void* dq, void* dk, void* dv, void* dbias, void* ws,
                       int windows, int batch, int heads, int groups, cudaStream_t stream) {
    const size_t smem = BwdSmem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(swin_train_bwd_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    swin_train_bwd_kernel<T, DH><<<dim3(heads, windows, groups), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(ws), windows, batch,
        heads, batch / groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int64_t elems = static_cast<int64_t>(windows) * heads * N * N;
    swin_train_dbias_kernel<<<static_cast<unsigned>((elems + THREADS - 1) / THREADS), THREADS, 0,
                          stream>>>(static_cast<const float*>(ws), static_cast<float*>(dbias),
                                    groups, elems);
    return cudaGetLastError();
}

bool geometry_ok(int windows, int batch, int n, int heads) {
    return n == N && windows > 0 && windows <= 65535 && batch > 0 && batch <= 65535 &&
           heads > 0 && heads <= 65535;
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, o, dout, dq, dk, dv are
// (windows, batch, 64, heads * head_dim) contiguous, of one dtype (0 =
// float32, 1 = bfloat16); bias and dbias (windows, heads, 64, 64) fp32; ws
// an fp32 workspace of groups * windows * heads * 64 * 64 floats, groups
// dividing batch. Each returns the cudaError_t of its launches (0 on
// success).
extern "C" int mmd_swin_attn_train_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, int windows, int batch,
                                       int n, int heads, int head_dim, int dtype, int device,
                                       void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!geometry_ok(windows, batch, n, heads)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_fwd<float, 32>(q, k, v, bias, o, windows, batch, heads, st);
    if (dtype == 0 && head_dim == 64)
        return launch_fwd<float, 64>(q, k, v, bias, o, windows, batch, heads, st);
    if (dtype == 1 && head_dim == 32)
        return launch_fwd<__nv_bfloat16, 32>(q, k, v, bias, o, windows, batch, heads, st);
    if (dtype == 1 && head_dim == 64)
        return launch_fwd<__nv_bfloat16, 64>(q, k, v, bias, o, windows, batch, heads, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mmd_swin_attn_train_bwd(const void* q, const void* k, const void* v,
                                       const void* bias, const void* dout, void* dq, void* dk,
                                       void* dv, void* dbias, void* ws, int windows, int batch,
                                       int n, int heads, int head_dim, int groups, int dtype,
                                       int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!geometry_ok(windows, batch, n, heads) || groups <= 0 || groups > 65535 ||
        batch % groups != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_bwd<float, 32>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows, batch,
                                     heads, groups, st);
    if (dtype == 0 && head_dim == 64)
        return launch_bwd<float, 64>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows, batch,
                                     heads, groups, st);
    if (dtype == 1 && head_dim == 32)
        return launch_bwd<__nv_bfloat16, 32>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows,
                                             batch, heads, groups, st);
    if (dtype == 1 && head_dim == 64)
        return launch_bwd<__nv_bfloat16, 64>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows,
                                             batch, heads, groups, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
