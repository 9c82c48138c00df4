// Flash-attention backward for Hopper (sm_90a), non-causal, with an optional
// (B, S) key mask and optional attention dropout, on the tensor cores.
//
// Replaces mmd_tpu/ops/attention.py::_flash_bwd (its Pallas body
// _bwd_kernel, behind the custom VJPs _fused_attention_core[_masked]) on the
// training path: the backward of each of the fusion model's eight
// attentions, (T, S) in {512, 64}^2, D 256, 8 heads; of the encoders'
// attentions when they are fine-tuned; and of FakeNet's twelve
// (baselines/fakenet.py: D 256, 2 heads of dh 128).
//
// Head dims 32 to 128 in steps of 16 (MMD_FLASH_HEAD_DIMS), in fp32 and
// bf16, with and without dropout. At dh 128 the six tiles, the lse/delta
// rows and the keep tile take 109,312 B in bf16 (two CTAs an SM) and
// 207,616 B in fp32, under the 227 KB opt-in limit at one CTA an SM (dh
// 112: 97,024 B and 183,040 B; dh 96: 84,736 B and 158,464 B): no pass is
// split for shared memory. bf16 reads the A fragments of its own tiles
// from shared memory at each use from dh 80 up (flash_common.cuh), and
// dkdv walks a query tile in four slices there (see dkdv_kernel).
//
// What it computes, per batch row b and head h, from q, k, v, the forward's
// o and natural-log lse, the output gradient do, and the dropout seed:
//   p[t, s]  = exp(q[t] . k[s] / sqrt(dh) - lse[t])  (0 for a masked key or a
//              row whose lse is -inf, i.e. a row with no valid key)
//   keep     = the forward's mask, regenerated from (seed, index) (philox.cuh)
//   D[t]     = sum_d do[t, d] o[t, d]                 (holds with dropout)
//   dv[s]   += sum_t p keep scale do[t]
//   dp[t, s] = do[t] . v[s]
//   ds[t, s] = p (dp keep scale - D[t])
//   dq[t]    = sum_s ds k[s] / sqrt(dh)
//   dk[s]    = sum_t ds q[t] / sqrt(dh)
// with keep scale = 1 when there is no dropout. Sums are fp32; dq, dk and dv
// are returned in the input dtype, as the TPU kernel does. In bf16, p keep
// scale is rounded to bf16 before dv and ds before dq and dk, where the TPU
// kernel rounds them.
//
// On the TPU the grid runs in order and the kernel carries dk/dv sums in
// revisited output blocks across query tiles. Blocks on Hopper run in no
// order, so this is TWO PASSES over the score matrix, chosen over fp32
// atomics for dq because it is deterministic (a training step gives the
// same grads every run) and needs no zeroed scratch (one pass with a
// per-key-tile dq workspace would need ~1 GB at the train step's shapes):
//   1. rowdot   D[b, h, t] into a (B, H, T) fp32 scratch;
//   2. dkdv     one CTA per (64-key tile, head, batch row) walks the query
//               tiles, recomputes p and dp, and keeps dk and dv in registers;
//   3. dq       one CTA per (64-row query tile, head, batch row) walks the
//               key tiles, recomputes p and dp, and keeps dq in registers.
// Both passes redraw the dropout mask of each 64 x 64 tile into shared
// memory (fill_keep_tile), exactly as the forward draws it.
//
// What bounds it on this card: the tensor cores. Counted as the TPU kernel
// counts it, 10 * B * H * T * S * dh operations (score, dp, dv, dk, dq
// products) against q, k, v, o, do read once and dq, dk, dv written once:
// T / 4 operations per bf16 byte at S = T, 128 for the 512-token shapes,
// under the 295 where 989 TFLOP/s meets 3.35 TB/s only for the 64-token
// ones. The two passes recompute the score and dp products (14 instead of
// 10 products of dh a weight), and each pass draws one Philox4x32-10 call
// (~100 integer instructions) per 4 weights when dropout is on -- at dh 32
// more issue slots than the products.
//
// What the design does about that:
//   * 4 warps a CTA, 16 rows of the CTA's tile each; all five products on
//     mma.sync (bf16 m16n8k16, or 3xTF32 on m16n8k8 in fp32) with fp32
//     accumulators (flash_common.cuh);
//   * the CTA's own tiles (K and V in dkdv, Q and dO in dq) are copied once;
//     the walked tiles are double-buffered with cp.async, so the copy of
//     tile j + 1 and the Philox draw of tile j's mask run under the
//     products of tile j;
//   * dkdv computes the transposed tile: S^T = K Q^T and dP^T = V dO^T, so
//     p^T keep scale and ds^T come out as C fragments of the (key, query)
//     tile and feed dV += P^T dO and dK += dS^T Q straight from registers;
//     the keep bits are read from the same (query, key) shared tile the
//     forward draws, at the transposed coordinates;
//   * dq computes S = Q K^T and dP = dO V^T, then ds, then dQ += dS K;
//   * a weight is 0 for a masked or out-of-range key and for a row whose
//     lse is -inf: exp2 never sees s - (-inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace mmd_flash;

constexpr int ROWDOT_THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// keep scale of weight (row r, key c) of a tile filled by fill_keep_tile
__device__ __forceinline__ float keep_at(const uint8_t* keep, int r, int c, float scale) {
    return keep[r * KEEP_STRIDE + c] ? scale : 0.f;
}

// ---------------------------------------------------------------------------
// 1. D[b, h, t] = sum_d do o
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(ROWDOT_THREADS)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int batch, int t_len, int num_heads) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * ROWDOT_THREADS + threadIdx.x;
    const int64_t rows = static_cast<int64_t>(batch) * t_len * num_heads;
    if (idx >= rows) return;
    const int h = static_cast<int>(idx % num_heads);
    const int64_t bt = idx / num_heads;      // b * T + t
    const size_t base = static_cast<size_t>(bt) * num_heads * DH + static_cast<size_t>(h) * DH;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) acc = fmaf(to_float(dout[base + d]), to_float(o[base + d]), acc);
    const int64_t b = bt / t_len;
    const int64_t t = bt % t_len;
    delta[(b * num_heads + h) * t_len + t] = acc;
}

// Six tiles (two of the CTA's own, two double-buffered pairs), up to two
// (BLOCK) fp32 rows, the keep tile.
template <typename T, int DH>
constexpr size_t smem_bytes(bool drop) {
    return 6 * Tile<T, DH>::BYTES + 2 * BLOCK * sizeof(float) +
           (drop ? BLOCK * KEEP_STRIDE : 0);
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one CTA per (key tile, head, batch row)
// ---------------------------------------------------------------------------
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int num_heads,
            float scale_log2, float sm_scale, mmd_philox::Dropout drop) {
    using Op = Ops<T, DH>;
    constexpr int TE = Tile<T, DH>::ELEMS;
    constexpr int LD = Tile<T, DH>::LD;
    // fp32 at dh 64 spills with whole 64-query slices (and still with two of
    // 32, by ptxas -v): it takes four slices of 16, 143 registers, no spill.
    // dh 128 holds 128 dk/dv accumulators a lane and walks four slices of
    // 16 in both dtypes, as a loop (ptxas -v, sm_90a): bf16 210 / 226
    // registers (rate 0 / dropout), fp32 246 / 246, no spill. Two slices
    // of 32 spilled in bf16 with dropout (255 registers, 36 bytes), and the
    // four slices unrolled spilled 24 bytes there and 44 / 24 in fp32.
    // The head dims between take the choice of their neighbour above:
    // fp32 dh 48 that of fp32 dh 64 (four slices, unrolled), dh 80-112 that
    // of dh 128 (four slices as a loop) in both dtypes, since 80-112
    // accumulators a lane sit closer to dh 128's 128 than to dh 64's 64.
    // ptxas -v, rate 0 / dropout: dh 96 bf16 173 / 165 registers, fp32
    // 168 / 168; dh 112 bf16 168 / 168, fp32 180 / 172; no spill. fp32 dh
    // 80 at rate 0 spills 8 bytes (168 registers); the rest of dh 48 and
    // 80 none.
    constexpr int PARTS = ((sizeof(T) == 4 && DH >= 48) || DH > 64) ? 4 : 1;
    constexpr int PART_UNROLL = DH > 64 ? 1 : PARTS;
    constexpr int N = NT / PARTS;
    extern __shared__ float4 smem4[];
    T* ks = reinterpret_cast<T*>(smem4);     // [BLOCK][LD]
    T* vs = ks + TE;                          // [BLOCK][LD]
    T* qs = vs + TE;                          // [2][BLOCK][LD]
    T* dos = qs + 2 * TE;                     // [2][BLOCK][LD]
    float* lse2 = reinterpret_cast<float*>(dos + 2 * TE);      // [BLOCK] log2 domain
    float* drow = lse2 + BLOCK;                                 // [BLOCK]
    uint8_t* keep = reinterpret_cast<uint8_t*>(drow + BLOCK);   // [BLOCK query][KEEP_STRIDE]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int s0 = blockIdx.x * BLOCK;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* dob = dout + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const float* lseb = lse + (static_cast<size_t>(b) * num_heads + h) * t_len;
    const float* deltab = delta + (static_cast<size_t>(b) * num_heads + h) * t_len;
    const int n_tiles = (t_len + BLOCK - 1) / BLOCK;

    copy_tile<T, DH>(ks, kb, d_model, s0, s_len);
    copy_tile<T, DH>(vs, vb, d_model, s0, s_len);
    copy_tile<T, DH>(qs, qb, d_model, 0, t_len);
    copy_tile<T, DH>(dos, dob, d_model, 0, t_len);
    mmd_tc::cp_async_commit();

    // This lane's keys: rows g and g + 8 of the warp's 16.
    const int key_local[2] = {16 * warp + g, 16 * warp + g + 8};
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int s = s0 + key_local[r];
        key_ok[r] = s < s_len &&
                    (key_valid == nullptr || key_valid[static_cast<size_t>(b) * s_len + s] != 0);
    }

    float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
    zero(dk_acc);
    zero(dv_acc);
    typename Op::A ka, va;

    for (int j = 0; j < n_tiles; ++j) {
        const int t0 = j * BLOCK;
        const int cur = (j & 1) * TE;
        if (j + 1 < n_tiles) {
            copy_tile<T, DH>(qs + (TE - cur), qb, d_model, t0 + BLOCK, t_len);
            copy_tile<T, DH>(dos + (TE - cur), dob, d_model, t0 + BLOCK, t_len);
        }
        mmd_tc::cp_async_commit();
        if (tid < BLOCK) {
            const int t = t0 + tid;
            lse2[tid] = t < t_len ? lseb[t] * LOG2E : -CUDART_INF_F;
            drow[tid] = t < t_len ? deltab[t] : 0.f;
        }
        if constexpr (DROP) {
            mmd_philox::fill_keep_tile<BLOCK, BLOCK, KEEP_STRIDE>(
                keep, tid, THREADS, b, h, num_heads, t0, t_len, s0, s_len, drop);
        }
        mmd_tc::cp_async_wait<1>();
        __syncthreads();
        if (j == 0) {
            Op::load_a(ka, ks, 16 * warp);
            Op::load_a(va, vs, 16 * warp);
        }

        // The tile's queries in PARTS slices of N n8 tiles: P^T rows are this
        // warp's keys, columns the slice's queries. At dh 128 the slices
        // run as a loop: unrolled, ptxas interleaves them beside the 128
        // accumulators and spills.
#pragma unroll(PART_UNROLL)
        for (int part = 0; part < PARTS; ++part) {
            const int c0 = part * 8 * N;
            float pt[N][4];
            zero(pt);
            Op::template scores<N>(pt, ka, qs + cur + c0 * LD);
            float w[N][4];                     // p keep scale, then ds
#pragma unroll
            for (int nt = 0; nt < N; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = c0 + 8 * nt + 2 * qd + (e & 1);
                    const float l2 = lse2[c];
                    const float p = (key_ok[e >> 1] && l2 != -CUDART_INF_F)
                                        ? exp2f(pt[nt][e] * scale_log2 - l2)
                                        : 0.f;
                    pt[nt][e] = p;
                    w[nt][e] = DROP ? p * keep_at(keep, c, key_local[e >> 1], drop.scale) : p;
                }
            Op::template pv<N>(dv_acc, w, dos + cur + c0 * LD);

            zero(w);
            Op::template scores<N>(w, va, dos + cur + c0 * LD);      // dP^T
#pragma unroll
            for (int nt = 0; nt < N; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = c0 + 8 * nt + 2 * qd + (e & 1);
                    const float dp =
                        DROP ? w[nt][e] * keep_at(keep, c, key_local[e >> 1], drop.scale)
                             : w[nt][e];
                    w[nt][e] = pt[nt][e] * (dp - drow[c]);
                }
            Op::template pv<N>(dk_acc, w, qs + cur + c0 * LD);
        }
        __syncthreads();
    }
    mmd_tc::cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int s = s0 + key_local[r];
        if (s >= s_len) continue;
        const size_t off = (static_cast<size_t>(b) * s_len + s) * d_model + head_off;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
            const int col = 8 * n + 2 * qd;
            store2(dk + off + col, dk_acc[n][2 * r] * sm_scale, dk_acc[n][2 * r + 1] * sm_scale);
            store2(dv + off + col, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per (query tile, head, batch row). ptxas -v (sm_90a),
// rate 0 / dropout: dh 128 bf16 175 / 178 registers, fp32 185 / 183; dh 96
// bf16 164 / 168, fp32 179 / 179; dh 112 bf16 165 / 177, fp32 198 / 179;
// no spill, but bf16 dh 48 with dropout (8 bytes at 128 registers: its
// two A matrices are held).
// ---------------------------------------------------------------------------
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t_len, int s_len, int num_heads,
          float scale_log2, float sm_scale, mmd_philox::Dropout drop) {
    using Op = Ops<T, DH>;
    constexpr int TE = Tile<T, DH>::ELEMS;
    extern __shared__ float4 smem4[];
    T* qs = reinterpret_cast<T*>(smem4);     // [BLOCK][LD]
    T* dos = qs + TE;                         // [BLOCK][LD]
    T* ks = dos + TE;                         // [2][BLOCK][LD]
    T* vs = ks + 2 * TE;                      // [2][BLOCK][LD]
    float* kbias = reinterpret_cast<float*>(vs + 2 * TE);       // [BLOCK]: 0 or -inf
    uint8_t* keep = reinterpret_cast<uint8_t*>(kbias + BLOCK);  // [BLOCK][KEEP_STRIDE]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int t0 = blockIdx.x * BLOCK;
    const int d_model = num_heads * DH;
    const size_t head_off = static_cast<size_t>(h) * DH;
    const T* qb = q + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* dob = dout + static_cast<size_t>(b) * t_len * d_model + head_off;
    const T* kb = k + static_cast<size_t>(b) * s_len * d_model + head_off;
    const T* vb = v + static_cast<size_t>(b) * s_len * d_model + head_off;
    const uint8_t* mb = key_valid ? key_valid + static_cast<size_t>(b) * s_len : nullptr;
    const int n_tiles = (s_len + BLOCK - 1) / BLOCK;

    copy_tile<T, DH>(qs, qb, d_model, t0, t_len);
    copy_tile<T, DH>(dos, dob, d_model, t0, t_len);
    copy_tile<T, DH>(ks, kb, d_model, 0, s_len);
    copy_tile<T, DH>(vs, vb, d_model, 0, s_len);
    mmd_tc::cp_async_commit();

    // This lane's rows g and g + 8 of the warp's 16: lse (log2) and D.
    const int row_local[2] = {16 * warp + g, 16 * warp + g + 8};
    float l2[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int t = t0 + row_local[r];
        const size_t stat = (static_cast<size_t>(b) * num_heads + h) * t_len + t;
        l2[r] = t < t_len ? lse[stat] * LOG2E : -CUDART_INF_F;
        dr[r] = t < t_len ? delta[stat] : 0.f;
    }

    float acc[DH / 8][4];
    zero(acc);
    typename Op::A qa, doa;

    for (int j = 0; j < n_tiles; ++j) {
        const int s0 = j * BLOCK;
        const int cur = (j & 1) * TE;
        if (j + 1 < n_tiles) {
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
        mmd_tc::cp_async_wait<1>();
        __syncthreads();
        if (j == 0) {
            Op::load_a(qa, qs, 16 * warp);
            Op::load_a(doa, dos, 16 * warp);
        }

        float s[NT][4], dp[NT][4];
        zero(s);
        zero(dp);
        Op::template scores<NT>(s, qa, ks + cur);
        Op::template scores<NT>(dp, doa, vs + cur);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int c = 8 * nt + 2 * qd + (e & 1);
                // kbias is -inf for a masked key; l2 is -inf for a row with
                // no valid key: either way the weight is exactly 0
                const float p = (kbias[c] == 0.f && l2[r] != -CUDART_INF_F)
                                    ? exp2f(s[nt][e] * scale_log2 - l2[r])
                                    : 0.f;
                const float d = DROP ? dp[nt][e] * keep_at(keep, row_local[r], c, drop.scale)
                                     : dp[nt][e];
                s[nt][e] = p * (d - dr[r]);
            }
        Op::template pv<NT>(acc, s, ks + cur);
        __syncthreads();
    }
    mmd_tc::cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int t = t0 + row_local[r];
        if (t >= t_len) continue;
        T* dst = dq + (static_cast<size_t>(b) * t_len + t) * d_model + head_off;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
            store2(dst + 8 * n + 2 * qd, acc[n][2 * r] * sm_scale, acc[n][2 * r + 1] * sm_scale);
    }
}

struct Args {
    const void *q, *k, *v, *key_valid, *o, *dout, *lse;
    void *delta, *dq, *dk, *dv;
    int batch, t_len, s_len, num_heads;
};

template <typename T, int DH, bool DROP>
cudaError_t launch(const Args& a, const mmd_philox::Dropout& drop, cudaStream_t stream) {
    const float sm_scale = 1.f / sqrtf(static_cast<float>(DH));
    const float scale_log2 = sm_scale * LOG2E;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const uint8_t* kv = static_cast<const uint8_t*>(a.key_valid);
    const float* lse = static_cast<const float*>(a.lse);
    float* delta = static_cast<float*>(a.delta);

    const int64_t rows = static_cast<int64_t>(a.batch) * a.t_len * a.num_heads;
    rowdot_kernel<T, DH><<<static_cast<unsigned>((rows + ROWDOT_THREADS - 1) / ROWDOT_THREADS),
                           ROWDOT_THREADS, 0, stream>>>(static_cast<const T*>(a.o), dout, delta,
                                                        a.batch, a.t_len, a.num_heads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    constexpr size_t smem = smem_bytes<T, DH>(DROP);
    err = cudaFuncSetAttribute(dkdv_kernel<T, DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 kgrid((a.s_len + BLOCK - 1) / BLOCK, a.num_heads, a.batch);
    dkdv_kernel<T, DH, DROP><<<kgrid, THREADS, smem, stream>>>(
        q, k, v, kv, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.t_len, a.s_len, a.num_heads, scale_log2, sm_scale, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    err = cudaFuncSetAttribute(dq_kernel<T, DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 qgrid((a.t_len + BLOCK - 1) / BLOCK, a.num_heads, a.batch);
    dq_kernel<T, DH, DROP><<<qgrid, THREADS, smem, stream>>>(
        q, k, v, kv, dout, lse, delta, static_cast<T*>(a.dq), a.t_len, a.s_len,
        a.num_heads, scale_log2, sm_scale, drop);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rate(const Args& a, const mmd_philox::Dropout& drop, int dropout,
                        cudaStream_t stream) {
    return dropout ? launch<T, DH, true>(a, drop, stream) : launch<T, DH, false>(a, drop, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 for
// q, k, v, o, do and the outputs dq, dk, dv (all 16-byte aligned);
// head_dim one of the library's MMD_FLASH_HEAD_DIMS; lse is
// (B, H, T) fp32 natural log; delta is a (B, H, T) fp32 scratch. key_valid
// is a (B, S) uint8 array (nonzero = valid key) or NULL. dropout: 0 = none,
// 1 = regenerate the forward's attention-dropout mask from (seed,
// threshold) and scale kept weights by drop_scale. Returns the cudaError_t
// of the launches (0 on success).
extern "C" int mmd_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq, void* dk, void* dv,
                                  int batch, int t_len, int s_len, int num_heads,
                                  int head_dim, int dtype, uint64_t seed,
                                  uint32_t threshold, float drop_scale, int dropout,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || t_len <= 0 || s_len <= 0 || num_heads <= 0 ||
        num_heads > 65535 || batch > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv,
                 batch, t_len, s_len, num_heads};
    const mmd_philox::Dropout dp{seed, threshold, drop_scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MMD_BWD_CASE(DH)                                                     \
    if (head_dim == DH) {                                                    \
        if (dtype == 0) return launch_rate<float, DH>(a, dp, dropout, st);   \
        if (dtype == 1) return launch_rate<__nv_bfloat16, DH>(a, dp, dropout, st); \
    }
    MMD_FLASH_HEAD_DIMS(MMD_BWD_CASE)
#undef MMD_BWD_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
