// Flash-attention forward for Hopper (sm_90a), non-causal, with an optional
// (B, S) key mask and optional attention dropout, on the tensor cores.
//
// Replaces mmd_tpu/ops/attention.py::_flash_fwd (its Pallas body
// _fwd_kernel) on the serving path: every text-encoder layer (T = S = 512,
// masked), every ViT layer (T = S = 64) and the eight attentions of the
// fusion model ((T, S) in {512, 64}^2); and on the training path the
// fusion model's eight attentions with dropout on the attention weights,
// and FakeNet's twelve (baselines/fakenet.py: 2 heads of dh 128).
//
// Head dims 32 to 128 in steps of 16 (MMD_FLASH_HEAD_DIMS), in fp32 and
// bf16, with and without dropout: one template on DH, whose tiles, products
// and loops all follow DH / 16 and DH / 8. A tile is 64 (DH + 16 / sizeof)
// elements: at dh 128 17,408 B (bf16) or 33,792 B (fp32), so the five tiles
// and the keep tile take 91,648 B (two CTAs an SM) or 173,568 B (one); at
// dh 96 71,168 B or 132,608 B; at dh 112 81,408 B or 153,088 B. bf16 reads
// Q's A fragments from its tile at each use from dh 80 up
// (flash_common.cuh) instead of holding them. ptxas -v (sm_90a), rate 0 /
// dropout: dh 128 bf16 149 / 132 registers, fp32 167 / 137; dh 96 bf16
// 129 / 127, fp32 138 / 156; dh 112 bf16 127 / 145, fp32 144 / 128, the
// last with 28 bytes of spill stores (20 of loads: ptxas kept it to 128
// registers though one CTA an SM fits its shared memory); dh 48 and 80
// no spill.
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
// rate = 0 compiles the instantiation without any of it.
//
// bf16 rounds where the TPU kernel rounds: P (times keep and scale) goes to
// bf16 before P.V; scores, the softmax statistics and the accumulators are
// fp32. The fp32 instantiation keeps fp32 error with 3xTF32 (tensor_core.cuh).
//
// What bounds it on this card: 4 * B * H * T * S * dh operations (Q K^T and
// P V) against 2 * (B * T * D + B * S * D) elements of q, o, k and v moved
// once: T / 2 operations per bf16 byte at S = T, so the 512-token shapes are
// bound by the tensor cores (989 TFLOP/s bf16; 3xTF32 does three TF32
// products at 495 TFLOP/s for each fp32 one) and the ViT's 64-token shape
// by device memory (3.35 TB/s). Besides the products each weight costs an
// exp2 and a few FMAs on the CUDA cores, and with dropout 1/4 of a
// Philox4x32-10 call (~100 integer instructions): at dh 32 that, not the
// tensor cores, sets the pace of the dropout instantiation.
//
// What the design does about that:
//   * one CTA of 4 warps per (64-row query tile, head, batch row); each warp
//     owns 16 query rows and walks S in 64-key tiles;
//   * Q is copied once with cp.async and held as A fragments (ldmatrix);
//     K and V tiles are double-buffered with cp.async, so the copy of tile
//     j + 1 (and the Philox draw of tile j's mask into shared memory) runs
//     under the products of tile j; rows past the sequence end are
//     zero-filled; rows are padded so ldmatrix hits no bank twice
//     (flash_common.cuh);
//   * S = Q K^T on mma.sync into fp32 registers; the key mask adds -inf to
//     masked and out-of-range keys before the max; the online softmax runs
//     in registers in the exp2 domain, with scale * log2(e) applied to the
//     fp32 scores, the row max over the 4 lanes of a row (two shuffles) and
//     the row sum kept per lane until the end; a row that has seen no valid
//     key subtracts 0 instead of -inf, so exp2 gives zeros and never NaN;
//   * P never leaves registers: its C fragments are the A operand of P V,
//     with V through ldmatrix.trans (bf16) or scalar loads (fp32);
//   * the epilogue scales by 1 / l and writes o in the input dtype and lse
//     in natural log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace mmd_flash;

template <typename T, int DH>
constexpr size_t smem_bytes(bool drop) {
    // Q, two K and two V tiles, the key bias, the keep tile
    return 5 * Tile<T, DH>::BYTES + BLOCK * sizeof(float) +
           (drop ? BLOCK * KEEP_STRIDE : 0);
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                 T* __restrict__ o, float* __restrict__ lse,
                 int t_len, int s_len, int num_heads, float scale_log2,
                 mmd_philox::Dropout drop) {
    static_assert(DH % 16 == 0 && DH >= 32 && DH <= 128,
                  "head dim must be a multiple of 16 in [32, 128]");
    using Op = Ops<T, DH>;
    constexpr int TE = Tile<T, DH>::ELEMS;

    extern __shared__ float4 smem4[];
    T* qs = reinterpret_cast<T*>(smem4);              // [BLOCK][LD]
    T* ks = qs + TE;                                   // [2][BLOCK][LD]
    T* vs = ks + 2 * TE;                               // [2][BLOCK][LD]
    float* kbias = reinterpret_cast<float*>(vs + 2 * TE);        // [BLOCK]: 0 or -inf
    uint8_t* keep = reinterpret_cast<uint8_t*>(kbias + BLOCK);   // DROP: [BLOCK][KEEP_STRIDE]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BLOCK;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const uint8_t* mb = key_valid ? key_valid + static_cast<size_t>(b) * s_len : nullptr;
    const int n_tiles = (s_len + BLOCK - 1) / BLOCK;

    copy_tile<T, DH>(qs, qb, d_model, t0, t_len);
    copy_tile<T, DH>(ks, kb, d_model, 0, s_len);
    copy_tile<T, DH>(vs, vb, d_model, 0, s_len);
    mmd_tc::cp_async_commit();

    // Rows g and g + 8 of the warp's 16: running max (log2 domain) and this
    // lane's part of the running sum, over valid keys.
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    float acc[DH / 8][4];
    zero(acc);
    typename Op::A qa;

    for (int j = 0; j < n_tiles; ++j) {
        const int s0 = j * BLOCK;
        const int cur = (j & 1) * TE;
        if (j + 1 < n_tiles) {                 // the next tile, under this one's work
            copy_tile<T, DH>(ks + (TE - cur), kb, d_model, s0 + BLOCK, s_len);
            copy_tile<T, DH>(vs + (TE - cur), vb, d_model, s0 + BLOCK, s_len);
        }
        mmd_tc::cp_async_commit();
        if (tid < BLOCK) {
            const int s = s0 + tid;
            kbias[tid] = (s < s_len && (mb == nullptr || mb[s] != 0)) ? 0.f : -CUDART_INF_F;
        }
        if constexpr (DROP) {
            mmd_philox::fill_keep_tile<BLOCK, BLOCK, KEEP_STRIDE>(
                keep, tid, THREADS, b, h, num_heads, t0, t_len, s0, s_len, drop);
        }
        mmd_tc::cp_async_wait<1>();            // this tile (and Q) has landed
        __syncthreads();
        if (j == 0) Op::load_a(qa, qs, 16 * warp);

        float sc[NT][4];
        zero(sc);
        Op::template scores<NT>(sc, qa, ks + cur);

        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = sc[nt][e] * scale_log2 + kbias[8 * nt + 2 * qd + (e & 1)];
                sc[nt][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float m_use[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            // no valid key yet: subtract 0, so exp2(-inf) gives 0, not NaN
            m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
            alpha[r] = exp2f(m_run[r] - m_use[r]);
            m_run[r] = m_new;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float p = exp2f(sc[nt][e] - m_use[r]);
                l_run[r] += p;                 // l sums the undropped weights
                if constexpr (DROP) {
                    const int row = 16 * warp + g + 8 * r;
                    p *= keep[row * KEEP_STRIDE + 8 * nt + 2 * qd + (e & 1)] ? drop.scale : 0.f;
                }
                sc[nt][e] = p;
            }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }
        Op::template pv<NT>(acc, sc, vs + cur);
        __syncthreads();                       // this tile's buffers are free
    }
    mmd_tc::cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int t = t0 + 16 * warp + g + 8 * r;
        if (t >= t_len) continue;
        const float inv = l > 0.f ? 1.f / l : 0.f;
        T* orow = o + (static_cast<size_t>(b) * t_len + t) * d_model + head_off;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
            store2(orow + 8 * n + 2 * qd, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        if (qd == 0) {
            lse[(static_cast<size_t>(b) * num_heads + h) * t_len + t] =
                l > 0.f ? (m_run[r] + log2f(l)) * LN2 : -CUDART_INF_F;
        }
    }
}

template <typename T, int DH, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid,
                   void* o, void* lse, int batch, int t_len, int s_len, int num_heads,
                   const mmd_philox::Dropout& drop, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, DH>(DROP);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH, DROP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((t_len + BLOCK - 1) / BLOCK, num_heads, batch);
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
// head_dim: one of the library's MMD_FLASH_HEAD_DIMS (any other returns
// cudaErrorInvalidValue). q, k, v and o are 16-byte aligned. key_valid is a (B, S) uint8 array
// (nonzero = valid key) or NULL. dropout: 0 = none (seed, threshold and
// drop_scale unused), 1 = attention dropout with keep threshold `threshold`
// and scale `drop_scale`. Returns the cudaError_t of the launch (0 on
// success).
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
#define MMD_FWD_CASE(DH)                                                                   \
    if (head_dim == DH) {                                                                  \
        if (dtype == 0)                                                                    \
            return launch_rate<float, DH>(q, k, v, key_valid, o, lse, batch, t_len, s_len, \
                                          num_heads, dp, dropout, st);                     \
        if (dtype == 1)                                                                    \
            return launch_rate<__nv_bfloat16, DH>(q, k, v, key_valid, o, lse, batch,       \
                                                  t_len, s_len, num_heads, dp, dropout,    \
                                                  st);                                     \
    }
    MMD_FLASH_HEAD_DIMS(MMD_FWD_CASE)
#undef MMD_FWD_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
