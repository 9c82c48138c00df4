// Inverted dropout with the mask drawn in the kernel, for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/dropout.py::_call (its Pallas body _kernel): every
// elementwise dropout of the fusion training step -- the two inside each
// MLP (after GELU on (N, 4D) and after fc2 on (N, D)) and the one between
// the layers of each classifier head -- forward and backward. The backward
// is this same kernel on the incoming gradient with the same seed, as
// _dropout_core_bwd does.
//
// What it computes, over a contiguous tensor of n elements in row-major
// order:
//   y[i] = x[i] * (bits(seed, i) < threshold ? scale : 0),  scale = 1 / (1 - rate)
// with bits from philox.cuh, the product taken in fp32 and rounded once to
// the output type (fp32 or bf16). Any n and any trailing dimension: the
// TPU's D % 128 gate is a layout rule of Mosaic's, not part of the function.
//
// What bounds it on this card: device memory. It reads n elements and
// writes n, 2 * n * itemsize bytes, and does one Philox4x32-10 call (~100
// integer instructions) per 4 elements, well under what the SMs can issue
// in the time the bytes take at 3.35 TB/s.
//
// What the design does about that: each thread takes 8 consecutive elements
// a step -- two 16-byte loads in fp32, one in bf16 -- and two Philox calls
// that give their 8 draws; a grid-stride loop keeps a few waves of blocks in
// flight; the mask never exists in memory, so the backward reads only the
// gradient. The last n % 8 elements go one per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
    uint64_t seed;
    uint32_t threshold;
    float scale;
};

__device__ __forceinline__ float keep_scale(uint32_t bits, const Params& p) {
    return bits < p.threshold ? p.scale : 0.f;
}

__device__ __forceinline__ void load8(const float* x, int64_t i, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* y, int64_t i, const float (&v)[8]) {
    reinterpret_cast<float4*>(y)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(y)[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, int64_t i, float (&v)[8]) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(__nv_bfloat16* y, int64_t i, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    reinterpret_cast<uint4*>(y)[i] = raw;
}

__device__ __forceinline__ float load1(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* x, int64_t i) { return __bfloat162float(x[i]); }
__device__ __forceinline__ void store1(float* y, int64_t i, float v) { y[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* y, int64_t i, float v) { y[i] = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, Params p) {
    const int64_t n8 = n / 8;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    for (int64_t i = first; i < n8; i += stride) {
        const uint4 r0 = mmd_philox::group_bits(p.seed, static_cast<uint64_t>(2 * i));
        const uint4 r1 = mmd_philox::group_bits(p.seed, static_cast<uint64_t>(2 * i + 1));
        const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        float v[8];
        load8(x, i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = v[j] * keep_scale(bits[j], p);
        store8(y, i, v);
    }
    const int64_t t = 8 * n8 + first;        // the ragged tail, < 8 elements
    if (first < 8 && t < n) {
        const uint32_t bits = mmd_philox::element_bits(p.seed, static_cast<uint64_t>(t));
        store1(y, t, load1(x, t) * keep_scale(bits, p));
    }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, Params p, cudaStream_t stream) {
    const int64_t n8 = n / 8;
    int64_t blocks = (n8 + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks of 256 per SM, grid-stride beyond
    dropout_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, p);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. x and
// y are contiguous, 16-byte aligned, n elements each (they may be the same
// buffer). Returns the cudaError_t of the launch (0 on success).
extern "C" int mmd_dropout(const void* x, void* y, int64_t n, uint64_t seed,
                           uint32_t threshold, float scale, int dtype, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Params p{seed, threshold, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x, y, n, p, st);
    if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, p, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
