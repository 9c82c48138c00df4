// DeBERTa-v3 disentangled attention forward for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces mmd_tpu/models/deberta.py::_deberta_attn_fused (its Pallas body
// _deberta_attn_kernel) on the DeBERTa serving and fine-tuning paths: the
// attention of every one of DeBERTa-v3-xsmall's 12 layers.
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
// Rounding points in bf16: P is rounded to bf16 as the A operand of P.V, as
// the TPU kernel rounds e (deberta.py:271, :279) and the flash forward does.
// The row sum l is taken from the fp32 p, where the TPU kernel sums the
// rounded e (:272-273): the two differ at about 2^-9 relative.
//
// What bounds it on this card: operations. 8 * B * T^2 * D per call (the
// content, c2p, p2c and P.V products) against (4 B T + 4 T) D elements of
// q/k/v/o/PK/PQ: at the serving shape (B 16, T 512, D 384) about 480
// operations per bf16 byte, above the ~295 where the tensor cores and not
// device memory are the limit. The band products cover 80 of a band's 128
// rows a warp, 5/4 of a content product each: 9 B T^2 D operations done.
//
// What the design does about that:
//   * one CTA of 4 warps per (64-query tile, head, b), 16 query rows a
//     warp, walking the 64-key tiles with an online softmax (exp2 domain)
//     held in registers; every product on mma.sync (bf16 m16n8k16 with fp32
//     accumulators; fp32 as 3xTF32 on m16n8k8);
//   * the scores of a tile pair are deberta_common.cuh's tile_scores, the
//     backward's code: content Q K^T, c2p and p2c as products with skewed
//     windows of the table bands, read back along their diagonals;
//   * the weights stay in registers from the scores to P.V (the C fragments
//     of `scores` are the A fragments of `pv`, flash_common.cuh);
//   * Q, K, V and the band chunks come in by cp.async in the input dtype;
//     each step loads one new 64-row chunk of each table into its ring a
//     step ahead, V for the step as the step begins, and the next K tile as
//     soon as the step's scores are done: three barriers a step;
//   * shared memory: 9 tiles and the band scores' tile, 106 KB at bf16
//     dh 64 (two CTAs an SM), 69 KB at bf16 dh 32 (three), 106 KB at fp32
//     dh 32, 179 KB at fp32 dh 64 (one);
//   * no atomics: the same call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "deberta_common.cuh"

namespace {

using namespace mmd_deberta;

template <typename T>
struct Params {
    const T *q, *k, *v, *pk, *pq;
    const uint8_t* key_valid;
    T* o;
    int t_len, num_heads;
    float scale_log2;
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
deberta_attn_kernel(const Params<T> p) {
    using Op = Ops<T, DH>;
    extern __shared__ float4 smem4[];
    const Shared<T, DH, false> sh(smem4);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, qd = lane & 3;
    const int o = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t_len = p.t_len, d_model = p.num_heads * DH, n = t_len / BLOCK;
    const size_t head = static_cast<size_t>(h) * DH;
    const size_t row0 = static_cast<size_t>(b) * t_len * d_model + head;
    const Frame<T, DH> f{p.q + row0, nullptr, p.k + row0, p.v + row0,
                         p.pk + head, p.pq + head, o, t_len, d_model};
    const uint8_t* mb = p.key_valid + static_cast<size_t>(b) * t_len;
    float* kvalid = sh.col;
    copy_tile<T, DH>(sh.xs, f.x, d_model, BLOCK * o, t_len);
    sh.load_y(f, 0);
    sh.load_first_bands(f);
    mmd_tc::cp_async_commit();

    float acc[DH / 8][4];
    zero(acc);
    // this lane's rows 16 warp + g and + 8: running max (log2 domain) and
    // this lane's part of the running sum (its quad holds the rest)
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
    for (int i = 0; i < n; ++i) {
        mmd_tc::cp_async_wait_all();
        __syncthreads();                     // K and the bands have landed; V is free
        sh.load_y2(f, i);
        mmd_tc::cp_async_commit();
        if (i + 1 < n) {
            sh.load_own_chunk(f, i + 2);
            sh.load_other_chunk(f, i + 1);
        }
        mmd_tc::cp_async_commit();
        if (tid < BLOCK) kvalid[tid] = mb[BLOCK * i + tid] != 0 ? 1.f : 0.f;
        float s[NT][4];
        tile_scores<T, DH>(s, sh, i);        // past its barrier, nothing reads K
        if (i + 1 < n) sh.load_y(f, i + 1);
        mmd_tc::cp_async_commit();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = NEG;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                    const int c = 8 * nt + 2 * qd + (e & 1);
                    s[nt][e] = kvalid[c] != 0.f ? s[nt][e] * p.scale_log2 : NEG;
                    mx = fmaxf(mx, s[nt][e]);
                }
            // the 4 lanes of a row are one quad
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            // m_new is finite (NEG at least), so a first tile of masked keys
            // gives p = 1 for each and alpha = 0 against the initial -inf
            const float m_new = fmaxf(m_run[hr], mx);
            const float alpha = exp2f(m_run[hr] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                    s[nt][e] = exp2f(s[nt][e] - m_new);
                    psum += s[nt][e];
                }
            l_run[hr] = l_run[hr] * alpha + psum;
            m_run[hr] = m_new;
#pragma unroll
            for (int nt = 0; nt < DH / 8; ++nt) {
                acc[nt][2 * hr] *= alpha;
                acc[nt][2 * hr + 1] *= alpha;
            }
        }
        mmd_tc::cp_async_wait<2>();          // V (the bands and next K may fly on)
        __syncthreads();
        Op::template pv<NT>(acc, s, sh.y2s);
    }
    mmd_tc::cp_async_wait_all();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float l = l_run[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;           // l >= 1: the row max contributes exp2(0)
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
            acc[nt][2 * hr] *= inv;
            acc[nt][2 * hr + 1] *= inv;
        }
    }
    store_rows<T, DH>(p.o + row0 + static_cast<size_t>(BLOCK * o + 16 * warp) * d_model,
                      d_model, acc);
}

// Above 48 KB of dynamic shared memory a kernel has to be allowed it, once
// per device: `raised` holds a bit for each device where that is done.
template <typename T, int DH>
cudaError_t launch(const Params<T>& p, int batch, int device, cudaStream_t stream) {
    constexpr size_t smem = Smem<T, DH, false>::BYTES;
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        const cudaError_t err = cudaFuncSetAttribute(
            deberta_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    deberta_attn_kernel<T, DH><<<dim3(p.t_len / BLOCK, p.num_heads, batch), THREADS, smem,
                                     stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* pk,
                         const void* pq, const void* key_valid, void* o, int batch, int t_len,
                         int num_heads, float scale, int device, cudaStream_t stream) {
    const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(pk),
                      static_cast<const T*>(pq), static_cast<const uint8_t*>(key_valid),
                      static_cast<T*>(o), t_len, num_heads, scale * LOG2E};
    return launch<T, DH>(p, batch, device, stream);
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, o are (batch, t_len, heads *
// head_dim), pk and pq (2 * t_len, heads * head_dim), all of one dtype
// (0 = float32, 1 = bfloat16), contiguous and 16-byte aligned; key_valid is
// (batch, t_len) uint8, nonzero = valid. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int mmd_deberta_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* pk, const void* pq, const void* key_valid,
                                    void* o, int batch, int t_len, int num_heads,
                                    int head_dim, float scale, int dtype, int device,
                                    void* stream) {
    if (batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 65535 || t_len <= 0 ||
        t_len % BLOCK != 0 || device < 0 || device >= 64) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_typed<float, 32>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads,
                                       scale, device, st);
    if (dtype == 0 && head_dim == 64)
        return launch_typed<float, 64>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads,
                                       scale, device, st);
    if (dtype == 1 && head_dim == 32)
        return launch_typed<bf16, 32>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads,
                                      scale, device, st);
    if (dtype == 1 && head_dim == 64)
        return launch_typed<bf16, 64>(q, k, v, pk, pq, key_valid, o, batch, t_len, num_heads,
                                      scale, device, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
