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
// the input dtype, dbias in fp32.
//
// Both kernels take one CTA of 4 warps per (head, window, group of batch
// rows) and walk the group's rows in a loop, which takes the place of the
// TPU grid's batch blocks; the caller chooses the groups (swin_attention.py:
// batch_groups for the forward, bwd_batch_groups for the backward).
//
// What bounds it on this card: bytes. Per (window, batch row, head) the
// forward reads three 64 x dh tiles and writes one for 4 * 64 * 64 * dh
// operations, 32 operations per bf16 byte; the backward reads five and
// writes three for 10 * 64 * 64 * dh, 40 a byte; both well below the ~295
// where the tensor cores would be the limit.
//
// Both do about that the same way:
//   * 4 warps, each owning 16 of the window's 64 rows, as the flash
//     kernels do (flash_common.cuh): every product on the tensor cores
//     (bf16 mma.sync m16n8k16; fp32 as 3xTF32 on m16n8k8), a weight tile
//     kept in registers from the product that makes it (`scores`) to the
//     one that uses it (`pv`);
//   * the (window, head) bias tile is read from device memory once per CTA,
//     16 rows x 64 keys a warp, into registers in the C-fragment layout of
//     the scores (32 floats a thread), and added to every batch row of the
//     group;
//   * the tiles are copied in the input dtype with cp.async into two
//     shared-memory stages: the next batch row's tiles land while this row
//     computes;
//   * the row max and sums are fp32 over the 4 lanes of a row (two
//     shuffles); no atomics, so the results are deterministic.
//
// #8, the forward (swin_train_fwd_kernel): the body it shares with the
// serving kernel #7, swin_fwd.cuh (Inputs::kNormalized): q', k and v a
// stage (30 KB at bf16 dh 32); in bf16 the unnormalized P is rounded to
// bf16 before P V and o is divided by max(l, 1e-37) after it, as the TPU
// kernel does.
//
// #9, the backward (swin_train_bwd_kernel): q', k, v and do a stage, and
// the weight tiles below (76 KB at bf16 dh 32: two CTAs an SM). A CTA owns
// whole 64 x 64 windows, so dk and dv need no sum across CTAs and each
// batch row is one pass of two halves, a barrier between them:
//   * query side, warp w its 16 query rows: S = Q'K^T + bias and dP = dO V^T
//     (dP's products issued right after S's, to run under the softmax); m
//     and 1/l by shuffles, P; D = rowsum(P dP) (the TPU kernel's D, not
//     dO . O: no output is saved); dS; dQ' = dS K. dS is added into dbias,
//     kept in registers in the bias's own fragment layout across the
//     group, and P and dS go to shared memory as 64 x 64 weight tiles;
//   * key side, warp w its 16 keys: dV = P^T dO and dK = dS^T Q' in one
//     loop, the A fragments of P^T and dS^T read from the weight tiles
//     transposed (ldmatrix.trans in bf16, scalar loads in fp32). Sharing P
//     and dS this way beat recomputing the transposed tile from the query
//     side's m, 1/l and D (S^T = K Q'^T, dP^T = V dO^T, as the flash
//     backward's dkdv pass does): 0.79 against 0.76-0.85 ms of device time
//     a bf16 fine-tuning step, 1.66-1.68 against 2.07 in fp32 (NVIDIA H100
//     80GB HBM3, 700 W; profile_kernels.py swin_bwd_calls, both in one
//     run); the order of work above took bf16 to 0.76;
//   * mma.sync and ldmatrix are asm volatile and issue in program order,
//     so the products are ordered by hand: a weight product runs over all
//     n tiles of a k step before the next, and the lo products before the
//     hi ones, which keeps the mma.sync of one accumulator apart;
//   * P and dS are fp32 in the TPU body. In bf16 each goes into its
//     products (dQ', dV, dK) as bf16 hi + bf16 lo, two mma.sync on one B
//     fragment, which keeps it to ~2^-17 (a single bf16 P or dS would cost
//     up to 2^-9 of an output, as much as its own rounding); fp32 runs
//     3xTF32, which splits its operands already;
//   * the batch split is the backward's own (swin_attention.py:
//     bwd_batch_groups: the fewest groups that give 132 CTAs). With one
//     group a CTA walks every batch row of its (window, head) and writes
//     dbias itself: one launch (Swinv2-base stage 0 at batch 8). With more,
//     each CTA writes its group's sum to a (groups, nW, heads, 64, 64) fp32
//     workspace and swin_train_dbias_kernel sums the groups in their order:
//     two launches (stages 1-3: 2, 4 and 8 groups). Measured as above,
//     that beat one group wherever one group leaves the card short of CTAs
//     (stage 2: 13.7 us a call at 4 groups, 22.7 at one), and beat summing
//     the groups of a (window, head) as one thread-block cluster through
//     distributed shared memory (19.6 us at 4 groups, 14.7 at 2: clusters
//     of 4-8 CTAs of 76 KB schedule worse). No atomics either way: two
//     calls give the same bits.
// n = 64 and dh in {32, 64} throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "swin_fwd.cuh"

namespace {

namespace F = mmd_flash;
namespace S = mmd_swin;

constexpr int N = 64;                        // tokens per window (8 x 8)
constexpr int SUM_THREADS = 256;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// #8: the forward, one CTA of 4 warps per (head, window, group of batch rows):
// the body both Swin forwards share (swin_fwd.cuh)
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(F::THREADS)
swin_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, T* __restrict__ o, int batch, int heads,
                      int per_group) {
    S::forward<T, DH, S::Inputs::kNormalized>(q, k, v, bias, nullptr, o, batch, heads, false,
                                              per_group);
}

// ---------------------------------------------------------------------------
// #9: the backward, one CTA of 4 warps per (head, window, group of batch rows)
// ---------------------------------------------------------------------------
// The weights the key side reads transposed: P and dS, 64 x 64 each, stored
// [query][key] as the query side holds them; in bf16 each as a hi and a lo
// tile. Rows of 144 bytes (bf16: the 8 rows an ldmatrix reads fall in
// distinct banks) or 68 floats (fp32: the transposed scalar loads of `pv_t`
// hit 32 banks).
template <typename T>
struct WTile {
    static constexpr int LD = sizeof(T) == 2 ? N + 8 : N + 4;
    static constexpr int ELEMS = N * LD;
    static constexpr int COUNT = sizeof(T) == 2 ? 4 : 2;   // P (hi, lo), dS (hi, lo)
    static constexpr size_t BYTES = COUNT * ELEMS * sizeof(T);
};

template <typename T, int DH>
constexpr size_t bwd_smem_bytes() {
    // two stages of q', k, v and do tiles; the weight tiles
    return 2 * 4 * F::Tile<T, DH>::BYTES + WTile<T>::BYTES;
}

// o += A B over the DH / 8 n tiles of B fragments f: mma.sync issues in
// program order (asm volatile), so the products of one accumulator are kept
// DH / 8 apart.
template <int DH>
__device__ __forceinline__ void mma_pairs(float (&o)[DH / 8][4], const uint32_t (&a)[4],
                                          const uint32_t (&f)[DH / 16][4]) {
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
        mmd_tc::mma(o[2 * np], a, f[np][0], f[np][1]);
        mmd_tc::mma(o[2 * np + 1], a, f[np][2], f[np][3]);
    }
}

// (x0, x1) as two bf16 pairs: hi rounded to nearest, lo what that left
// (exact in fp32), rounded in turn.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(x0, x1);
    const float2 rf = __bfloat1622float2(r);
    hi = *reinterpret_cast<const uint32_t*>(&r);
    lo = mmd_tc::pack_bf16x2(x0 - rf.x, x1 - rf.y);
}

// o += W B, as Ops::pv, with the fp32 weights W kept to ~2^-17: 3xTF32 splits
// them already; in bf16 each goes in as bf16 hi and bf16 lo (what rounding
// to bf16 left, exact in fp32), two mma.sync on one B fragment.
template <int DH>
__device__ __forceinline__ void pv_exact(float (&o)[DH / 8][4], const float (&w)[F::NT][4],
                                         const float* b) {
    F::Ops<float, DH>::template pv<F::NT>(o, w, b);
}

template <int DH>
__device__ __forceinline__ void pv_exact(float (&o)[DH / 8][4], const float (&w)[F::NT][4],
                                         const F::bf16* b) {
    constexpr int LD = F::Tile<F::bf16, DH>::LD;
#pragma unroll
    for (int kb = 0; kb < F::NT / 2; ++kb) {
        // the A fragment of Ops<bf16>::pv: rows g, g + 8, keys 2q.., 2q + 8..
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float* x = w[2 * kb + (j >> 1)] + 2 * (j & 1);
            split_bf16x2(x[0], x[1], hi[j], lo[j]);
        }
        uint32_t f[DH / 16][4];
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) mmd_tc::load_b_t(f[np], b, LD, 16 * kb, 16 * np);
        mma_pairs<DH>(o, lo, f);
        mma_pairs<DH>(o, hi, f);
    }
}

// This warp's C fragments of a weight tile W (its 16 query rows) into shared
// memory: fp32 as it is; bf16 as hi at dst and lo at dst + one tile.
__device__ __forceinline__ void put_w(float* dst, const float (&w)[F::NT][4]) {
    const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < F::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
            F::store2(dst + (r0 + 8 * r) * WTile<float>::LD + 8 * nt + 2 * (lane & 3),
                      w[nt][2 * r], w[nt][2 * r + 1]);
}

__device__ __forceinline__ void put_w(F::bf16* dst, const float (&w)[F::NT][4]) {
    const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < F::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            uint32_t* at = reinterpret_cast<uint32_t*>(
                dst + (r0 + 8 * r) * WTile<F::bf16>::LD + 8 * nt + 2 * (lane & 3));
            split_bf16x2(w[nt][2 * r], w[nt][2 * r + 1], at[0], at[WTile<F::bf16>::ELEMS / 2]);
        }
}

// o1 += W1^T B1 and o2 += W2^T B2 for this warp's 16 keys: W1, W2 weight
// tiles put by `put_w` (their rows the 64 queries), B1, B2 (query, dh)
// tiles; the two products interleaved, as neither waits on the other. bf16:
// the A fragments of W^T read by ldmatrix.trans, hi and lo, two mma.sync on
// one B fragment.
template <int DH>
__device__ __forceinline__ void pv_t(float (&o1)[DH / 8][4], const F::bf16* w1,
                                     const F::bf16* b1, float (&o2)[DH / 8][4],
                                     const F::bf16* w2, const F::bf16* b2) {
    constexpr int LD = F::Tile<F::bf16, DH>::LD;
    constexpr int WLD = WTile<F::bf16>::LD, WE = WTile<F::bf16>::ELEMS;
    const int m0 = 16 * (threadIdx.x >> 5);
#pragma unroll
    for (int kb = 0; kb < F::NT / 2; ++kb) {
        uint32_t hi1[4], lo1[4], hi2[4], lo2[4], f1[DH / 16][4], f2[DH / 16][4];
        mmd_tc::load_a_t(hi1, w1, WLD, m0, 16 * kb);
        mmd_tc::load_a_t(lo1, w1 + WE, WLD, m0, 16 * kb);
        mmd_tc::load_a_t(hi2, w2, WLD, m0, 16 * kb);
        mmd_tc::load_a_t(lo2, w2 + WE, WLD, m0, 16 * kb);
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
            mmd_tc::load_b_t(f1[np], b1, LD, 16 * kb, 16 * np);
            mmd_tc::load_b_t(f2[np], b2, LD, 16 * kb, 16 * np);
        }
        mma_pairs<DH>(o1, lo1, f1);
        mma_pairs<DH>(o2, lo2, f2);
        mma_pairs<DH>(o1, hi1, f1);
        mma_pairs<DH>(o2, hi2, f2);
    }
}

// fp32, 3xTF32 on m16n8k8, in Ops<float>::pv's order of k: k index q is
// query 8 j + 2 q, q + 4 is 8 j + 2 q + 1, so that the scalar loads of both
// operands hit 32 banks.
template <int DH>
__device__ __forceinline__ void pv_t(float (&o1)[DH / 8][4], const float* w1, const float* b1,
                                     float (&o2)[DH / 8][4], const float* w2, const float* b2) {
    constexpr int LD = F::Tile<float, DH>::LD;
    constexpr int WLD = WTile<float>::LD;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int m0 = 16 * (threadIdx.x >> 5);
    auto a_frag = [&](const float* w, int j) {
        const float* a0 = w + (8 * j + 2 * q) * WLD + m0 + g;
        const uint32_t raw[4] = {__float_as_uint(a0[0]), __float_as_uint(a0[8]),
                                 __float_as_uint(a0[WLD]), __float_as_uint(a0[WLD + 8])};
        return mmd_tc::Split<4>(raw);
    };
    auto b_frag = [&](const float* b, int j, int nt) {
        const float* r0 = b + (8 * j + 2 * q) * LD + g + 8 * nt;
        const uint32_t f[2] = {__float_as_uint(r0[0]), __float_as_uint(r0[LD])};
        return mmd_tc::Split<2>(f);
    };
#pragma unroll
    for (int j = 0; j < F::NT; ++j) {
        const mmd_tc::Split<4> a1 = a_frag(w1, j), a2 = a_frag(w2, j);
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
            const mmd_tc::Split<2> f1 = b_frag(b1, j, nt), f2 = b_frag(b2, j, nt);
            mmd_tc::mma_3xtf32(o1[nt], a1, f1.hi[0], f1.hi[1], f1.lo[0], f1.lo[1]);
            mmd_tc::mma_3xtf32(o2[nt], a2, f2.hi[0], f2.hi[1], f2.lo[0], f2.lo[1]);
        }
    }
}

// This warp's 16 rows (16 warp + g, + 8) of a (64, C) gradient tile at dst, head columns.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, int c, const float (&acc)[DH / 8][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
    const int r0 = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        T* row = dst + static_cast<size_t>(r0 + 8 * r) * c + 2 * qd;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) F::store2(row + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
    }
}

// `out` is dbias with one group, else the (groups, nW, heads, n, n) workspace.
template <typename T, int DH>
__global__ void __launch_bounds__(F::THREADS)
swin_train_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const T* __restrict__ dout,
                      T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ out, int batch, int heads, int per_group) {
    using Op = F::Ops<T, DH>;
    constexpr int TE = F::Tile<T, DH>::ELEMS;
    constexpr int NT = F::NT;
    extern __shared__ float4 smem4[];
    T* tiles = reinterpret_cast<T*>(smem4);  // [2 stages][q', k, v, do][N][LD]
    T* wp = tiles + 2 * 4 * TE;              // P: [query][key], bf16 hi then lo
    T* wds = wp + WTile<T>::COUNT / 2 * WTile<T>::ELEMS;   // dS, the same

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int r0 = 16 * warp + g;            // this lane's rows: r0 and r0 + 8
    const int h = blockIdx.x;
    const int w = blockIdx.y;
    const int b0 = blockIdx.z * per_group;
    const int c = heads * DH;
    // the (window, batch row b) tile of this head starts at row_base(b)
    const size_t head_base = static_cast<size_t>(w) * batch * N * c + static_cast<size_t>(h) * DH;
    auto row_base = [&](int b) { return head_base + static_cast<size_t>(b) * N * c; };
    auto copy_row = [&](int stage, int b) {
        T* s = tiles + stage * 4 * TE;
        const size_t off = row_base(b);
        F::copy_tile<T, DH>(s, q + off, c, 0, N);
        F::copy_tile<T, DH>(s + TE, k + off, c, 0, N);
        F::copy_tile<T, DH>(s + 2 * TE, v + off, c, 0, N);
        F::copy_tile<T, DH>(s + 3 * TE, dout + off, c, 0, N);
    };
    copy_row(0, b0);
    mmd_tc::cp_async_commit();

    // The bias once for the group, under the first copy, at this lane's
    // score fragments (query r0 + 8 r, key 8 nt + 2 qd + {0, 1}); db, the
    // group's dbias, has its layout.
    const float* bw = bias + (static_cast<size_t>(w) * heads + h) * N * N;
    float bs[NT][4], db[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(
                bw + (r0 + 8 * r) * N + 8 * nt + 2 * qd));
            bs[nt][2 * r] = x.x;
            bs[nt][2 * r + 1] = x.y;
        }
    F::zero(db);

    for (int i = 0; i < per_group; ++i) {
        const int cur = i & 1;
        if (i + 1 < per_group) copy_row(cur ^ 1, b0 + i + 1);   // under this row's work
        mmd_tc::cp_async_commit();
        mmd_tc::cp_async_wait<1>();          // this row's tiles have landed
        __syncthreads();
        const T* qs = tiles + cur * 4 * TE;
        const T* ks = qs + TE;
        const T* vs = qs + 2 * TE;
        const T* dos = qs + 3 * TE;
        const size_t base = row_base(b0 + i);

        // query side: P and dS of this warp's 16 queries, then dQ' = dS K
        {
            typename Op::A a, ao;
            Op::load_a(a, qs, 16 * warp);
            Op::load_a(ao, dos, 16 * warp);
            float p[NT][4], ds[NT][4];
            F::zero(p);
            F::zero(ds);
            Op::template scores<NT>(p, a, ks);
            Op::template scores<NT>(ds, ao, vs);     // dP, under the softmax
            float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[nt][e] += bs[nt][e];
                    mx[e >> 1] = fmaxf(mx[e >> 1], p[nt][e]);
                }
            float l[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[nt][e] = exp2f(p[nt][e] - mx[e >> 1]);
                    l[e >> 1] += p[nt][e];
                }
            float inv[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                inv[r] = 1.f / fmaxf(l[r], 1e-37f);
            }
            float d[2] = {0.f, 0.f};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[nt][e] *= inv[e >> 1];
                    d[e >> 1] += p[nt][e] * ds[nt][e];
                }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
                d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    ds[nt][e] = LN2 * p[nt][e] * (ds[nt][e] - d[e >> 1]);
                    db[nt][e] += ds[nt][e];
                }
            put_w(wp, p);
            put_w(wds, ds);
            float acc[DH / 8][4];
            F::zero(acc);
            pv_exact<DH>(acc, ds, ks);
            store_rows<T, DH>(dq + base, c, acc);
        }
        __syncthreads();                     // P and dS are in shared memory

        // key side, this warp's 16 keys: dV = P^T dO, dK = dS^T Q'
        {
            float dva[DH / 8][4], dka[DH / 8][4];
            F::zero(dva);
            F::zero(dka);
            pv_t<DH>(dva, wp, dos, dka, wds, qs);
            store_rows<T, DH>(dv + base, c, dva);
            store_rows<T, DH>(dk + base, c, dka);
        }
        __syncthreads();                     // this stage and P, dS are free
    }

    float* o = out + ((static_cast<size_t>(blockIdx.z) * gridDim.y + w) * heads + h) * N * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
            F::store2(o + (r0 + 8 * r) * N + 8 * nt + 2 * qd, db[nt][2 * r], db[nt][2 * r + 1]);
}

// dbias[e] = sum over groups g of ws[g, e], in the order of g.
__global__ void __launch_bounds__(SUM_THREADS)
swin_train_dbias_kernel(const float* __restrict__ ws, float* __restrict__ dbias, int groups,
                        int64_t elems) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * SUM_THREADS + threadIdx.x;
    if (idx >= elems) return;
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += ws[g * elems + idx];
    dbias[idx] = acc;
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                       int windows, int batch, int heads, int groups, int device,
                       cudaStream_t stream) {
    constexpr size_t smem = S::fwd_smem_bytes<T, DH>();
    static std::atomic<uint64_t> raised{0};
    cudaError_t err = S::allow_smem(swin_train_fwd_kernel<T, DH>, smem, device, raised);
    if (err != cudaSuccess) return err;
    swin_train_fwd_kernel<T, DH><<<dim3(heads, windows, groups), F::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(o), batch, heads, batch / groups);
    return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, void* dq, void* dk, void* dv, void* dbias, void* ws,
                       int windows, int batch, int heads, int groups, int device,
                       cudaStream_t stream) {
    constexpr size_t smem = bwd_smem_bytes<T, DH>();
    static std::atomic<uint64_t> raised{0};
    cudaError_t err = S::allow_smem(swin_train_bwd_kernel<T, DH>, smem, device, raised);
    if (err != cudaSuccess) return err;
    swin_train_bwd_kernel<T, DH><<<dim3(heads, windows, groups), F::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(groups == 1 ? dbias : ws), batch, heads, batch / groups);
    err = cudaGetLastError();
    if (err != cudaSuccess || groups == 1) return err;
    const int64_t elems = static_cast<int64_t>(windows) * heads * N * N;
    swin_train_dbias_kernel<<<static_cast<unsigned>((elems + SUM_THREADS - 1) / SUM_THREADS),
                              SUM_THREADS, 0, stream>>>(static_cast<const float*>(ws),
                                                        static_cast<float*>(dbias), groups,
                                                        elems);
    return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, o, dout, dq, dk, dv are
// (windows, batch, 64, heads * head_dim) contiguous, of one dtype (0 =
// float32, 1 = bfloat16); bias and dbias (windows, heads, 64, 64) fp32;
// groups divides batch; ws is an fp32 workspace of groups * windows * heads
// * 64 * 64 floats, unused (and may be NULL) when groups is 1. Each returns
// the cudaError_t of its launches (0 on success).
extern "C" int mmd_swin_attn_train_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, int windows, int batch,
                                       int n, int heads, int head_dim, int groups, int dtype,
                                       int device, void* stream) {
    cudaError_t err = S::enter(windows, batch, n, heads, groups, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_fwd<float, 32>(q, k, v, bias, o, windows, batch, heads, groups, device, st);
    if (dtype == 0 && head_dim == 64)
        return launch_fwd<float, 64>(q, k, v, bias, o, windows, batch, heads, groups, device, st);
    if (dtype == 1 && head_dim == 32)
        return launch_fwd<__nv_bfloat16, 32>(q, k, v, bias, o, windows, batch, heads, groups,
                                             device, st);
    if (dtype == 1 && head_dim == 64)
        return launch_fwd<__nv_bfloat16, 64>(q, k, v, bias, o, windows, batch, heads, groups,
                                             device, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mmd_swin_attn_train_bwd(const void* q, const void* k, const void* v,
                                       const void* bias, const void* dout, void* dq, void* dk,
                                       void* dv, void* dbias, void* ws, int windows, int batch,
                                       int n, int heads, int head_dim, int groups, int dtype,
                                       int device, void* stream) {
    cudaError_t err = S::enter(windows, batch, n, heads, groups, device);
    if (err == cudaSuccess && groups > 1 && ws == nullptr) err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch_bwd<float, 32>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows, batch,
                                     heads, groups, device, st);
    if (dtype == 0 && head_dim == 64)
        return launch_bwd<float, 64>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows, batch,
                                     heads, groups, device, st);
    if (dtype == 1 && head_dim == 32)
        return launch_bwd<__nv_bfloat16, 32>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows,
                                             batch, heads, groups, device, st);
    if (dtype == 1 && head_dim == 64)
        return launch_bwd<__nv_bfloat16, 64>(q, k, v, bias, dout, dq, dk, dv, dbias, ws, windows,
                                             batch, heads, groups, device, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
