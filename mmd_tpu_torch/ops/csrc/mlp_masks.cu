// The fused MLP's two dropout masks, dumped: the oracle of mlp_fwd.cu and
// mlp_bwd.cu, for Hopper (sm_90a).
//
// Replaces benchmarks/validate_mlp_tpu.py::_dump_masks, the TPU replica of
// mmd_tpu/ops/mlp.py::_fwd_kernel's draw pattern that returns the two
// keep-masks so that a float64 host oracle can reproduce the fused forward
// and every output of the backward. It writes
//   m1[row, f] = keep * scale of the hidden mask (seed 1, index row * F + f)
//   m2[row, d] = keep * scale of the output mask (seed 2, index row * D + d)
// as fp32, through mlp_common.cuh's keep_byte: the function the forward and
// the backward draw their masks with, so the dump shows their very bits.
//
// What bounds it on this card: device memory, 4 (F + D) bytes written a row
// against one Philox4x32-10 call (~100 integer instructions) per 4 elements.
// Each thread takes 8 consecutive elements a step (one keep_byte, two
// 16-byte stores) in a grid-stride loop.

#include "mlp_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void write8(float* out, int64_t unit, int ld, const mmd_mlp::Mask& m) {
    const int64_t row = unit / (ld / 8);
    const int c8 = 8 * static_cast<int>(unit % (ld / 8));
    const uint32_t bits = mmd_mlp::keep_byte(m, static_cast<uint64_t>(row), ld, c8);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (bits >> e) & 1u ? m.scale : 0.f;
    float4* p = reinterpret_cast<float4*>(out + row * ld + c8);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(THREADS)
mlp_masks_kernel(float* __restrict__ m1, float* __restrict__ m2, int64_t n, int d, int f,
                 mmd_mlp::Mask k1, mmd_mlp::Mask k2) {
    const int64_t units1 = n * (f / 8), units = units1 + n * (d / 8);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; u < units;
         u += stride) {
        if (u < units1) {
            write8(m1, u, f, k1);
        } else {
            write8(m2, u - units1, d, k2);
        }
    }
}

}  // namespace

// C entry point, bound with ctypes. m1 (n, f) and m2 (n, d) are contiguous
// fp32 outputs; d and f are multiples of 8. dropout: 0 = none (both masks
// all ones), 1 = the masks of seed1 (hidden) and seed2 (output) with
// `threshold` and `scale`. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mmd_mlp_masks(void* m1, void* m2, int64_t n, int d, int f, uint64_t seed1,
                             uint64_t seed2, uint32_t threshold, float scale, int dropout,
                             int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || d <= 0 || f <= 0 || d % 8 != 0 || f % 8 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float s = dropout ? scale : 1.f;
    const mmd_mlp::Mask k1{seed1, threshold, s, dropout}, k2{seed2, threshold, s, dropout};
    const int64_t units = n * ((f + d) / 8);
    int64_t blocks = (units + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    mlp_masks_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(m1),
                                                            static_cast<float*>(m2), n, d, f, k1,
                                                            k2);
    return static_cast<int>(cudaGetLastError());
}
