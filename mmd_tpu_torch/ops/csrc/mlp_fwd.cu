// Fused GELU-MLP forward with in-kernel dropout, for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/mlp.py::_mlp_fwd_call (its Pallas body _fwd_kernel):
// the forward of each of the fusion model's six MLPs in a bf16 train step
// with dropout, rows N = 256 x 512 (text queries) or 256 x 64 (image
// queries), D 256, F 1024.
//
// What it computes, for x (N, D) bf16, w1 (D, F) bf16, b1 (F,) fp32, w2
// (F, D) bf16 and b2 (D,) fp32, with the rounding points of the TPU kernel:
//   a = x w1 + b1                        fp32 products, fp32 sums
//   h = bf16(gelu_tanh(a) * m1)          m1 = keep * scale at row * F + f
//   y = bf16((h w2 + b2) * m2)           m2 = keep * scale at row * D + d
// with the masks of mlp_common.cuh (seed 1 for m1, seed 2 for m2; both 1
// when dropout is off). Nothing F wide reaches device memory.
//
// What bounds it on this card: arithmetic. 4 N D F operations against
// 4 N D bytes of x and y (plus the 1 MB of weights): F = 1024 operations a
// byte, far above the ~295 where 989 TFLOP/s of bf16 tensor-core work
// meets 3.35 TB/s.
//
// What the design does about that (first version: simple and right):
//   * one CTA of 8 warps takes 64 rows; its x tile stays in shared memory
//     while it walks F in chunks of 64 columns;
//   * per chunk it stages w1[:, chunk] and w2[chunk, :] in shared memory,
//     draws the chunk's hidden keep bits (one Philox call per 4 elements),
//     computes the 64 x 64 block of a on the tensor cores (mma.sync
//     m16n8k16, bf16 in, fp32 out), applies bias, GELU and the mask in
//     registers, stores h in bf16 to shared memory, and adds h w2[chunk, :]
//     into the 64 x D fp32 accumulator that the 8 warps hold in registers;
//   * rows are padded by 8 elements in shared memory, so the 8 row
//     addresses of an ldmatrix fall in different banks;
//   * tiles arrive by cp.async, all copies of a tile in flight at once; no
//     double buffering or warp specialization yet: two CTAs per SM overlap
//     one's loads with the other's products. wgmma with TMA is the next
//     step.
// Any N (the last tile's missing rows read zeros and store nothing); D 128
// or 256; F a multiple of 128.

#include "mlp_common.cuh"
#include "tensor_core.cuh"

namespace {

using mmd_tc::bf16;
using mmd_mlp::Mask;

constexpr int THREADS = 256;
constexpr int BM = 64;          // rows a CTA
constexpr int FC = 64;          // hidden columns a chunk
constexpr int PAD = 8;
constexpr int LDH = FC + PAD;   // row stride of the chunk-wide tiles

template <int D>
struct Smem {
    static constexpr int LDX = D + PAD;
    static constexpr int X = 0;                          // [BM][LDX] x
    static constexpr int W1 = X + BM * LDX * 2;          // [D][LDH] w1[:, chunk]
    static constexpr int W2 = W1 + D * LDH * 2;          // [FC][LDX] w2[chunk, :]
    static constexpr int H = W2 + FC * LDX * 2;          // [BM][LDH] h
    static constexpr int KEEP = H + BM * LDH * 2;        // [BM][FC / 8] hidden keep bits
    static constexpr int BYTES = KEEP + BM * FC / 8;
    // the output keep bits, [BM][D / 8], reuse the w1 tile after the loop
    static_assert(BM * D / 8 <= D * LDH * 2, "output keep bits fit the w1 tile");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ y, int64_t n, int f,
               Mask m1, Mask m2) {
    using S = Smem<D>;
    constexpr int LDX = S::LDX;
    constexpr int YN = D / 32;                  // 8-column tiles of y a warp
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem + S::X);
    bf16* w1s = reinterpret_cast<bf16*>(smem + S::W1);
    bf16* w2s = reinterpret_cast<bf16*>(smem + S::W2);
    bf16* hs = reinterpret_cast<bf16*>(smem + S::H);
    uint8_t* keep = smem + S::KEEP;

    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    const int64_t valid = n - row0;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    // this warp's 16 x 32 block of a chunk's hidden tile, and 32 x D/4 of y
    const int hm = (warp & 3) * 16, hn = (warp >> 2) * 32;
    const int ym = (warp & 1) * 32, yn = (warp >> 1) * (D / 4);

    mmd_tc::load_tile(xs, LDX, x + row0 * D, D, BM, D, valid);
    float acc[2][YN][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < YN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int c0 = 0; c0 < f; c0 += FC) {
        __syncthreads();                        // the last chunk's readers are done
        mmd_tc::load_tile(w1s, LDH, w1 + c0, f, D, FC, D);
        mmd_tc::load_tile(w2s, LDX, w2 + static_cast<int64_t>(c0) * D, D, FC, D, FC);
        mmd_mlp::fill_keep<BM, FC>(keep, m1, row0, f, c0);
        mmd_tc::cp_async_wait_all();
        __syncthreads();

        // a = x w1[:, chunk] for this warp's 16 x 32 block
        float h[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
#pragma unroll 4
        for (int k0 = 0; k0 < D; k0 += 16) {
            uint32_t a[4];
            mmd_tc::load_a(a, xs, LDX, hm, k0);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                uint32_t b[4];
                mmd_tc::load_b_t(b, w1s, LDH, k0, hn + 16 * j);
                mmd_tc::mma(h[2 * j], a, b[0], b[1]);
                mmd_tc::mma(h[2 * j + 1], a, b[2], b[3]);
            }
        }
        // + b1, GELU, hidden dropout, bf16 -> hs
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = hn + 8 * j + 2 * q;
            const float bias0 = b1[c0 + col], bias1 = b1[c0 + col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = hm + g + 8 * half;
                const float v0 = mmd_mlp::gelu_tanh(h[j][2 * half] + bias0) *
                                 mmd_mlp::keep_scale<FC>(keep, m1, r, col);
                const float v1 = mmd_mlp::gelu_tanh(h[j][2 * half + 1] + bias1) *
                                 mmd_mlp::keep_scale<FC>(keep, m1, r, col + 1);
                mmd_tc::store_bf16x2(hs + r * LDH + col, v0, v1);
            }
        }
        __syncthreads();

        // y += h w2[chunk, :] for this warp's 32 x D/4 block
#pragma unroll
        for (int k0 = 0; k0 < FC; k0 += 16) {
            uint32_t a[2][4];
            mmd_tc::load_a(a[0], hs, LDH, ym, k0);
            mmd_tc::load_a(a[1], hs, LDH, ym + 16, k0);
#pragma unroll
            for (int j = 0; j < YN / 2; ++j) {
                uint32_t b[4];
                mmd_tc::load_b_t(b, w2s, LDX, k0, yn + 16 * j);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mmd_tc::mma(acc[i][2 * j], a[i], b[0], b[1]);
                    mmd_tc::mma(acc[i][2 * j + 1], a[i], b[2], b[3]);
                }
            }
        }
    }

    // + b2, output dropout, bf16 -> y
    __syncthreads();
    uint8_t* keep2 = smem + S::W1;
    mmd_mlp::fill_keep<BM, D>(keep2, m2, row0, D, 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < YN; ++j) {
            const int col = yn + 8 * j + 2 * q;
            const float bias0 = b2[col], bias1 = b2[col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = ym + 16 * i + g + 8 * half;
                if (r >= valid) continue;
                const float v0 = (acc[i][j][2 * half] + bias0) *
                                 mmd_mlp::keep_scale<D>(keep2, m2, r, col);
                const float v1 = (acc[i][j][2 * half + 1] + bias1) *
                                 mmd_mlp::keep_scale<D>(keep2, m2, r, col + 1);
                mmd_tc::store_bf16x2(y + (row0 + r) * D + col, v0, v1);
            }
        }
}

template <int D>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, int64_t n, int f, const Mask& m1, const Mask& m2,
                   cudaStream_t stream) {
    const int bytes = Smem<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(mlp_fwd_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (n + BM - 1) / BM;
    mlp_fwd_kernel<D><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(y), n,
        f, m1, m2);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x (n, d), w1 (d, f), w2 (f, d) and y
// (n, d) are contiguous bf16; b1 (f,) and b2 (d,) fp32. d is 128 or 256, f a
// multiple of 128. dropout: 0 = none, 1 = the masks of seed1 (hidden) and
// seed2 (output) with `threshold` and `scale`. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int mmd_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, int64_t n, int d, int f, uint64_t seed1,
                           uint64_t seed2, uint32_t threshold, float scale, int dropout,
                           int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || f <= 0 || f % 128 != 0 || (n + BM - 1) / BM > 0x7FFFFFFF) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float s = dropout ? scale : 1.f;
    const Mask m1{seed1, threshold, s, dropout}, m2{seed2, threshold, s, dropout};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 128) return launch<128>(x, w1, b1, w2, b2, y, n, f, m1, m2, st);
    if (d == 256) return launch<256>(x, w1, b1, w2, b2, y, n, f, m1, m2, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
