// (Residual +) LayerNorm forward for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/ln.py::_ln_pallas (its Pallas bodies _ln_kernel and
// _ln_res_kernel) on the Swinv2 serving path: the patch-embedding norm, the
// two post-norms of every block (with the residual shortcut), the norm after
// each patch merge, and the final norm -- 53 calls per Swinv2-base forward.
//
// What it computes, per row of a (rows, C) tensor y:
//   mean = sum(y) / C,  var = sum((y - mean)^2) / C     (fp32, two passes)
//   out  = (y - mean) * rsqrt(var + eps) * scale + bias (+ shortcut)
// in fp32, cast once to y's dtype. The shortcut, when given, has y's shape
// and dtype and is added in fp32 before that one cast. scale and bias are
// fp32 (C,).
//
// What bounds it on this card: bytes. It reads y (and the shortcut) once and
// writes out once, ~10 operations per element: 2 or 3 tensors x rows x C x
// itemsize over 3.35 TB/s, far below the ~295 operations per byte where
// arithmetic would take over.
//
// What the design does about that (first version: simple and right):
//   * one warp per row, eight rows per 256-thread block; the row stays in
//     registers between the two statistics passes and the output pass, so
//     y is read from device memory exactly once;
//   * 16-byte loads and stores (8 bf16 or 4 fp32 values a lane), lanes on
//     neighbouring 16-byte chunks of the row;
//   * C a multiple of 128 up to 1024, so a lane holds at most 32 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                     // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 1024;

template <typename T> struct Vec;            // values in one 16-byte chunk
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

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

__device__ __forceinline__ void store16(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const T* __restrict__ y, const T* __restrict__ shortcut,
          const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ out, int rows, int c, float eps) {
    constexpr int V = Vec<T>::N;
    constexpr int PER = MAX_C / (32 * V);    // chunks a lane holds at most
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= rows) return;                 // whole warps leave together
    const int nch = c / V;
    const size_t off = static_cast<size_t>(row) * c;

    float v[PER][V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int ch = i * 32 + lane;
        if (ch < nch) {
            load16(y + off + ch * V, v[i]);
#pragma unroll
            for (int e = 0; e < V; ++e) sum += v[i][e];
        }
    }
    const float mean = warp_sum(sum) / static_cast<float>(c);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        if (i * 32 + lane < nch) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const float d = v[i][e] - mean;
                sq += d * d;
            }
        }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(c) + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int ch = i * 32 + lane;
        if (ch < nch) {
            float sc[V], bs[V], res[V], o[V];
#pragma unroll
            for (int e = 0; e < V; e += 4) {
                load16(scale + ch * V + e, sc + e);
                load16(bias + ch * V + e, bs + e);
            }
            if (RES) load16(shortcut + off + ch * V, res);
#pragma unroll
            for (int e = 0; e < V; ++e) {
                o[e] = (v[i][e] - mean) * rstd * sc[e] + bs[e];
                if (RES) o[e] += res[e];
            }
            store16(out + off + ch * V, o);
        }
    }
}

template <typename T>
cudaError_t launch(const void* y, const void* shortcut, const void* scale,
                   const void* bias, void* out, int rows, int c, float eps,
                   cudaStream_t stream) {
    const dim3 grid((rows + WARPS - 1) / WARPS);
    if (shortcut != nullptr) {
        ln_kernel<T, true><<<grid, THREADS, 0, stream>>>(
            static_cast<const T*>(y), static_cast<const T*>(shortcut),
            static_cast<const float*>(scale), static_cast<const float*>(bias),
            static_cast<T*>(out), rows, c, eps);
    } else {
        ln_kernel<T, false><<<grid, THREADS, 0, stream>>>(
            static_cast<const T*>(y), nullptr,
            static_cast<const float*>(scale), static_cast<const float*>(bias),
            static_cast<T*>(out), rows, c, eps);
    }
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// shortcut is NULL for the plain LayerNorm. All pointers 16-byte aligned,
// every tensor contiguous. Returns the cudaError_t of the launch.
extern "C" int mmd_layernorm_fwd(const void* y, const void* shortcut,
                                 const void* scale, const void* bias, void* out,
                                 int rows, int c, float eps, int dtype, int device,
                                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows <= 0 || c <= 0 || c % 128 != 0 || c > MAX_C) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(y, shortcut, scale, bias, out, rows, c, eps, st);
    if (dtype == 1) return launch<__nv_bfloat16>(y, shortcut, scale, bias, out, rows, c, eps, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
