// Fused GELU-MLP backward with the dropout masks regenerated in the kernel,
// for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/mlp.py::_mlp_bwd_call (its Pallas body _bwd_kernel):
// the backward of each of the fusion model's six MLPs in a bf16 train step
// with dropout (N = 256 x 512 or 256 x 64 rows, D 256, F 1024).
//
// What it computes, from x, w1, b1, w2, the output gradient dy (all as the
// forward takes them) and the two mask seeds, with the rounding points of
// the TPU kernel:
//   a   = x w1 + b1,  h = gelu_tanh(a) m1        (recomputed, fp32)
//   dyf = dy m2,  dyb = bf16(dyf),  hb = bf16(h)
//   dh  = dyb w2^T m1,  da = dh gelu_tanh'(a),  dab = bf16(da)
//   dx  = bf16(dab w1^T)
//   dW1 = x^T dab,  db1 = sum_rows da,  dW2 = hb^T dyb,  db2 = sum_rows dyf
// dW1, dW2, db1 and db2 are fp32, as the TPU kernel returns them.
//
// On the TPU the grid runs in order and the kernel adds every row block's
// dW and db into the same output blocks. Blocks on Hopper run in no order
// and one CTA cannot hold dW1 + dW2 (2 MB in fp32), so this is two passes
// and a reduction, deterministic (a step gives the same grads every run)
// and free of atomics:
//   A. mlp_dx_kernel      one CTA per 64 rows walks F in chunks of 64:
//                         recomputes a and dh for the chunk, forms dab in
//                         shared memory and adds dab w1[:, chunk]^T into dx,
//                         held in registers; it also writes dyb, which it
//                         builds first, to an (N, D) workspace;
//   B. mlp_dw_kernel      one CTA per (32 hidden columns, group of rows)
//                         walks its rows 64 at a time: recomputes a, h and dh
//                         for its columns from x and pass A's dyb, and adds
//                         hb^T dyb into dW2[chunk, :] and x^T dab into
//                         dW1[:, chunk], both held in registers, and the
//                         column sums of da into db1; the first column
//                         chunk's CTAs rebuild dyb from dy and sum dyf into
//                         db2. Each group writes its fp32 partial sums to a
//                         workspace;
//   C. mlp_reduce_kernel  sums the groups' partials in a fixed order.
// Products: A does 3 of N D F multiply-adds (a, dh, dx) and B 4 (a, dh,
// dW2, dW1): 14 N D F operations against the TPU body's 10.
//
// What bounds it on this card: arithmetic, counted as the TPU kernel needs
// it, 10 N D F operations against x, dy and dx (6 N D bytes) and the
// weights: as for the forward, far above the bf16 ridge.
//
// What the design does about that (first version: simple and right): the
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out)
// from shared-memory tiles padded against bank conflicts, with ldmatrix
// .trans where a product contracts over rows (hb^T dyb, x^T dab); tiles
// arrive by cp.async; the hidden mask is redrawn per tile into shared
// memory with keep_byte, as the forward draws it, and the output mask once
// a row (pass A, and pass B's first column chunk). No double buffering
// yet. D 128 or 256; F a multiple of 128; any N (missing rows of the last
// tile read zeros and contribute nothing).

#include "mlp_common.cuh"
#include "tensor_core.cuh"

namespace {

using mmd_tc::bf16;
using mmd_mlp::Mask;

constexpr int THREADS = 256;
constexpr int BM = 64;          // rows a tile
constexpr int FCA = 64;         // hidden columns a chunk, pass A
constexpr int FCB = 32;         // hidden columns a CTA, pass B
constexpr int PAD = 8;
constexpr int LDA = FCA + PAD;
constexpr int LDB = FCB + PAD;

// dyb = bf16(dy m2) of a tile into shared memory, and into dyb_out (the
// tile's rows of an (N, D) array) unless that is null; dy rows past
// `valid` are zeros. Thread t handles the same 8 columns of every row it
// touches, so it can keep their fp32 column sums in `colsum`.
template <int D>
__device__ __forceinline__ void load_dy(bf16* dys, int ld, const bf16* dy, bf16* dyb_out,
                                        int64_t row0, int64_t valid, const uint8_t* keep2,
                                        const Mask& m2, float (&colsum)[8]) {
    static_assert(THREADS % (D / 8) == 0, "a thread keeps its columns");
    for (int i = threadIdx.x; i < BM * (D / 8); i += THREADS) {
        const int r = i / (D / 8);
        const int c = 8 * (i % (D / 8));
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid) raw = *reinterpret_cast<const uint4*>(dy + (row0 + r) * D + c);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 p = __bfloat1622float2(hv[j]);
            v[2 * j] = p.x * mmd_mlp::keep_scale<D>(keep2, m2, r, c + 2 * j);
            v[2 * j + 1] = p.y * mmd_mlp::keep_scale<D>(keep2, m2, r, c + 2 * j + 1);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) colsum[j] += v[j];
        uint4 out;
        __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int j = 0; j < 4; ++j) ho[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(dys + r * ld + c) = out;
        if (dyb_out != nullptr && r < valid) {
            *reinterpret_cast<uint4*>(dyb_out + (row0 + r) * D + c) = out;
        }
    }
}

// The 16 x 8*NT block (rows m0.., hidden columns n0..) of a = x w1c and of
// dh = dyb w2c^T, with w1c stored [D][ldw1] (hidden columns contiguous) and
// w2c stored [hidden][ldx].
template <int D, int NT>
__device__ __forceinline__ void hidden_products(float (&a)[NT][4], float (&dh)[NT][4],
                                                const bf16* xs, const bf16* dys, int ldx,
                                                const bf16* w1s, int ldw1, const bf16* w2s,
                                                int m0, int n0) {
    static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[j][e] = dh[j][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t ax[4], ad[4];
        mmd_tc::load_a(ax, xs, ldx, m0, k0);
        mmd_tc::load_a(ad, dys, ldx, m0, k0);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
            uint32_t b[4];
            mmd_tc::load_b_t(b, w1s, ldw1, k0, n0 + 16 * j);
            mmd_tc::mma(a[2 * j], ax, b[0], b[1]);
            mmd_tc::mma(a[2 * j + 1], ax, b[2], b[3]);
            mmd_tc::load_b(b, w2s, ldx, k0, n0 + 16 * j);
            mmd_tc::mma(dh[2 * j], ad, b[0], b[1]);
            mmd_tc::mma(dh[2 * j + 1], ad, b[2], b[3]);
        }
    }
}

// -- pass A: dx ----------------------------------------------------------------

template <int D>
struct SmemA {
    static constexpr int LDX = D + PAD;
    static constexpr int X = 0;                          // [BM][LDX] x
    static constexpr int DY = X + BM * LDX * 2;          // [BM][LDX] dyb
    static constexpr int W1 = DY + BM * LDX * 2;         // [D][LDA] w1[:, chunk]
    static constexpr int W2 = W1 + D * LDA * 2;          // [FCA][LDX] w2[chunk, :]
    static constexpr int DA = W2 + FCA * LDX * 2;        // [BM][LDA] dab
    static constexpr int KEEP = DA + BM * LDA * 2;       // [BM][FCA / 8] hidden keep bits
    static constexpr int BYTES = KEEP + BM * FCA / 8;
    // the output keep bits, [BM][D / 8], use the dab tile before the loop
    static_assert(BM * D / 8 <= BM * LDA * 2, "output keep bits fit the dab tile");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ dy, bf16* __restrict__ dx, bf16* __restrict__ dyb,
              int64_t n, int f, Mask m1, Mask m2) {
    using S = SmemA<D>;
    constexpr int LDX = S::LDX;
    constexpr int XN = D / 32;                  // 8-column tiles of dx a warp
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem + S::X);
    bf16* dys = reinterpret_cast<bf16*>(smem + S::DY);
    bf16* w1s = reinterpret_cast<bf16*>(smem + S::W1);
    bf16* w2s = reinterpret_cast<bf16*>(smem + S::W2);
    bf16* das = reinterpret_cast<bf16*>(smem + S::DA);
    uint8_t* keep = smem + S::KEEP;

    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    const int64_t valid = n - row0;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int hm = (warp & 3) * 16, hn = (warp >> 2) * 32;
    const int xm = (warp & 1) * 32, xn = (warp >> 1) * (D / 4);

    uint8_t* keep2 = smem + S::DA;
    mmd_mlp::fill_keep<BM, D>(keep2, m2, row0, D, 0);
    mmd_tc::load_tile(xs, LDX, x + row0 * D, D, BM, D, valid);
    __syncthreads();
    float unused[8] = {};
    load_dy<D>(dys, LDX, dy, dyb, row0, valid, keep2, m2, unused);

    float acc[2][XN][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < XN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int c0 = 0; c0 < f; c0 += FCA) {
        __syncthreads();                        // the last chunk's readers are done
        mmd_tc::load_tile(w1s, LDA, w1 + c0, f, D, FCA, D);
        mmd_tc::load_tile(w2s, LDX, w2 + static_cast<int64_t>(c0) * D, D, FCA, D, FCA);
        mmd_mlp::fill_keep<BM, FCA>(keep, m1, row0, f, c0);
        mmd_tc::cp_async_wait_all();
        __syncthreads();

        float a[4][4], dh[4][4];
        hidden_products<D, 4>(a, dh, xs, dys, LDX, w1s, LDA, w2s, hm, hn);
        // da = dh m1 gelu'(a + b1) -> bf16 -> das
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = hn + 8 * j + 2 * q;
            const float bias0 = b1[c0 + col], bias1 = b1[c0 + col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = hm + g + 8 * half;
                const float d0 = dh[j][2 * half] * mmd_mlp::keep_scale<FCA>(keep, m1, r, col) *
                                 mmd_mlp::gelu_tanh_grad(a[j][2 * half] + bias0);
                const float d1 = dh[j][2 * half + 1] *
                                 mmd_mlp::keep_scale<FCA>(keep, m1, r, col + 1) *
                                 mmd_mlp::gelu_tanh_grad(a[j][2 * half + 1] + bias1);
                mmd_tc::store_bf16x2(das + r * LDA + col, d0, d1);
            }
        }
        __syncthreads();

        // dx += dab w1[:, chunk]^T: B[k = f][n = d] = w1s[d][f]
#pragma unroll
        for (int k0 = 0; k0 < FCA; k0 += 16) {
            uint32_t av[2][4];
            mmd_tc::load_a(av[0], das, LDA, xm, k0);
            mmd_tc::load_a(av[1], das, LDA, xm + 16, k0);
#pragma unroll
            for (int j = 0; j < XN / 2; ++j) {
                uint32_t b[4];
                mmd_tc::load_b(b, w1s, LDA, k0, xn + 16 * j);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mmd_tc::mma(acc[i][2 * j], av[i], b[0], b[1]);
                    mmd_tc::mma(acc[i][2 * j + 1], av[i], b[2], b[3]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < XN; ++j) {
            const int col = xn + 8 * j + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = xm + 16 * i + g + 8 * half;
                if (r < valid) {
                    mmd_tc::store_bf16x2(dx + (row0 + r) * D + col, acc[i][j][2 * half],
                                          acc[i][j][2 * half + 1]);
                }
            }
        }
}

// -- pass B: partial dW1, dW2, db1, db2 -----------------------------------------

template <int D>
struct SmemB {
    static constexpr int LDX = D + PAD;
    static constexpr int X = 0;                          // [BM][LDX] x
    static constexpr int DY = X + BM * LDX * 2;          // [BM][LDX] dyb
    static constexpr int W1 = DY + BM * LDX * 2;         // [D][LDB] w1[:, chunk]
    static constexpr int W2 = W1 + D * LDB * 2;          // [FCB][LDX] w2[chunk, :]
    static constexpr int H = W2 + FCB * LDX * 2;         // [BM][LDB] hb
    static constexpr int DA = H + BM * LDB * 2;          // [BM][LDB] dab
    static constexpr int KEEP = DA + BM * LDB * 2;       // [BM][FCB / 8] hidden keep bits
    static constexpr int RED = KEEP + BM * FCB / 8;      // [4][FCB] fp32 db1 partials
    static constexpr int BYTES = RED + 4 * FCB * 4;
    // the output keep bits, [BM][D / 8], use the hb and dab tiles, which
    // are written only after dyb is built
    static_assert(BM * D / 8 <= 2 * BM * LDB * 2, "output keep bits fit hb and dab");
    // the end-of-kernel db2 reduction, [THREADS][8] fp32, uses the x tile
    static_assert(THREADS * 8 * 4 <= BM * LDX * 2, "db2 partials fit the x tile");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ dy, const bf16* __restrict__ dyb,
              float* __restrict__ ws, int64_t n, int f, int64_t group_rows, Mask m1,
              Mask m2) {
    using S = SmemB<D>;
    constexpr int LDX = S::LDX;
    constexpr int W2N = D / 32;                 // 8-column tiles of dW2 a warp
    constexpr int W1M = D / 128;                // 16-row tiles of dW1 a warp
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem + S::X);
    bf16* dys = reinterpret_cast<bf16*>(smem + S::DY);
    bf16* w1s = reinterpret_cast<bf16*>(smem + S::W1);
    bf16* w2s = reinterpret_cast<bf16*>(smem + S::W2);
    bf16* hs = reinterpret_cast<bf16*>(smem + S::H);
    bf16* das = reinterpret_cast<bf16*>(smem + S::DA);
    uint8_t* keep = smem + S::KEEP;
    uint8_t* keep2 = smem + S::H;
    float* red = reinterpret_cast<float*>(smem + S::RED);

    const int c0 = blockIdx.x * FCB;
    const int64_t first = static_cast<int64_t>(blockIdx.y) * group_rows;
    const int64_t last = first + group_rows < n ? first + group_rows : n;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int hm = (warp & 3) * 16, hn = (warp >> 2) * 16;     // 16 x 16 of a, dh
    const int w2m = (warp & 1) * 16, w2n = (warp >> 1) * (D / 4);   // of dW2 (FCB x D)
    const int w1m = warp * (D / 8);                             // of dW1 (D x FCB)

    mmd_tc::load_tile(w1s, LDB, w1 + c0, f, D, FCB, D);
    mmd_tc::load_tile(w2s, LDX, w2 + static_cast<int64_t>(c0) * D, D, FCB, D, FCB);

    float dw2[W2N][4], dw1[W1M][4][4];
#pragma unroll
    for (int j = 0; j < W2N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw2[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < W1M; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw1[i][j][e] = 0.f;
    float db1 = 0.f;                            // thread t < FCB: column c0 + t
    float db2[8] = {};                          // this thread's 8 columns of dyf

    // The CTAs of the first column chunk redraw the output mask to build dyb
    // and sum dyf into db2; the others load the dyb that pass A wrote.
    const bool first_chunk = blockIdx.x == 0;
    for (int64_t row0 = first; row0 < last; row0 += BM) {
        const int64_t valid = last - row0;
        __syncthreads();                        // the last tile's readers are done
        mmd_tc::load_tile(xs, LDX, x + row0 * D, D, BM, D, valid);
        if (first_chunk) {
            mmd_mlp::fill_keep<BM, D>(keep2, m2, row0, D, 0);
        } else {
            mmd_tc::load_tile(dys, LDX, dyb + row0 * D, D, BM, D, valid);
        }
        mmd_mlp::fill_keep<BM, FCB>(keep, m1, row0, f, c0);
        mmd_tc::cp_async_wait_all();
        __syncthreads();
        if (first_chunk) {
            load_dy<D>(dys, LDX, dy, nullptr, row0, valid, keep2, m2, db2);
            __syncthreads();
        }

        float a[2][4], dh[2][4];
        hidden_products<D, 2>(a, dh, xs, dys, LDX, w1s, LDB, w2s, hm, hn);
        // hb = bf16(gelu(a + b1) m1) -> hs; da = dh m1 gelu'(a + b1) -> das
        float colda[2][2] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int col = hn + 8 * j + 2 * q;
            const float bias[2] = {b1[c0 + col], b1[c0 + col + 1]};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = hm + g + 8 * half;
                float hv[2], dv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float av = a[j][2 * half + e] + bias[e];
                    const float k = mmd_mlp::keep_scale<FCB>(keep, m1, r, col + e);
                    hv[e] = mmd_mlp::gelu_tanh(av) * k;
                    dv[e] = dh[j][2 * half + e] * k * mmd_mlp::gelu_tanh_grad(av);
                    colda[j][e] += dv[e];       // zero on rows past the end: dy is 0
                }
                mmd_tc::store_bf16x2(hs + r * LDB + col, hv[0], hv[1]);
                mmd_tc::store_bf16x2(das + r * LDB + col, dv[0], dv[1]);
            }
        }
        // db1: sum the warp's 16 rows over the lanes of one column, then
        // the 4 row blocks in order
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float v = colda[j][e];
                v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
                v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
                v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
                if (g == 0) red[(warp & 3) * FCB + hn + 8 * j + 2 * q + e] = v;
            }
        __syncthreads();
        if (threadIdx.x < FCB) {
            const int t = threadIdx.x;
            db1 += ((red[t] + red[FCB + t]) + red[2 * FCB + t]) + red[3 * FCB + t];
        }

        // dW2[chunk, :] += hb^T dyb: A[m = f][k = r] = hs[r][f], B[k = r][n = d] = dys[r][d]
#pragma unroll
        for (int k0 = 0; k0 < BM; k0 += 16) {
            uint32_t ah[4];
            mmd_tc::load_a_t(ah, hs, LDB, w2m, k0);
#pragma unroll
            for (int j = 0; j < W2N / 2; ++j) {
                uint32_t b[4];
                mmd_tc::load_b_t(b, dys, LDX, k0, w2n + 16 * j);
                mmd_tc::mma(dw2[2 * j], ah, b[0], b[1]);
                mmd_tc::mma(dw2[2 * j + 1], ah, b[2], b[3]);
            }
        }
        // dW1[:, chunk] += x^T dab: A[m = d][k = r] = xs[r][d], B[k = r][n = f] = das[r][f]
#pragma unroll
        for (int k0 = 0; k0 < BM; k0 += 16) {
            uint32_t b[2][4];
            mmd_tc::load_b_t(b[0], das, LDB, k0, 0);
            mmd_tc::load_b_t(b[1], das, LDB, k0, 16);
#pragma unroll
            for (int i = 0; i < W1M; ++i) {
                uint32_t ax[4];
                mmd_tc::load_a_t(ax, xs, LDX, w1m + 16 * i, k0);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    mmd_tc::mma(dw1[i][2 * j], ax, b[j][0], b[j][1]);
                    mmd_tc::mma(dw1[i][2 * j + 1], ax, b[j][2], b[j][3]);
                }
            }
        }
    }

    // this group's partials: ws[group] = [dW1 (D, f) | dW2 (f, D) | db1 (f) | db2 (D)]
    const int64_t total = 2 * static_cast<int64_t>(D) * f + f + D;
    float* out = ws + blockIdx.y * total;
    float* out_dw1 = out;
    float* out_dw2 = out + static_cast<int64_t>(D) * f;
    float* out_db1 = out_dw2 + static_cast<int64_t>(D) * f;
    float* out_db2 = out_db1 + f;
#pragma unroll
    for (int j = 0; j < W2N; ++j) {
        const int col = w2n + 8 * j + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = w2m + g + 8 * half;
            *reinterpret_cast<float2*>(out_dw2 + static_cast<int64_t>(c0 + r) * D + col) =
                make_float2(dw2[j][2 * half], dw2[j][2 * half + 1]);
        }
    }
#pragma unroll
    for (int i = 0; i < W1M; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = 8 * j + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = w1m + 16 * i + g + 8 * half;
                *reinterpret_cast<float2*>(out_dw1 + static_cast<int64_t>(r) * f + c0 + col) =
                    make_float2(dw1[i][j][2 * half], dw1[i][j][2 * half + 1]);
            }
        }
    if (threadIdx.x < FCB) out_db1[c0 + threadIdx.x] = db1;
    if (blockIdx.x == 0) {
        // db2: the threads that share a column group, in order
        __syncthreads();
        float* part = reinterpret_cast<float*>(smem + S::X);
#pragma unroll
        for (int j = 0; j < 8; ++j) part[threadIdx.x * 8 + j] = db2[j];
        __syncthreads();
        for (int col = threadIdx.x; col < D; col += THREADS) {
            float s = 0.f;
            for (int t = (col / 8) % (D / 8); t < THREADS; t += D / 8) s += part[t * 8 + col % 8];
            out_db2[col] = s;
        }
    }
}

// -- C: the fixed-order sum over groups -------------------------------------------

__global__ void __launch_bounds__(THREADS)
mlp_reduce_kernel(const float* __restrict__ ws, int groups, int64_t total,
                  float* __restrict__ dw1, float* __restrict__ dw2, float* __restrict__ db1,
                  float* __restrict__ db2, int64_t dw_size, int f) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < total;
         i += stride) {
        float s = 0.f;
        for (int gi = 0; gi < groups; ++gi) s += ws[gi * total + i];
        if (i < dw_size) {
            dw1[i] = s;
        } else if (i < 2 * dw_size) {
            dw2[i - dw_size] = s;
        } else if (i < 2 * dw_size + f) {
            db1[i - 2 * dw_size] = s;
        } else {
            db2[i - 2 * dw_size - f] = s;
        }
    }
}

struct Args {
    const void *x, *w1, *b1, *w2, *dy;
    void *dx, *dyb, *ws, *dw1, *db1, *dw2, *db2;
    int64_t n;
    int f, groups;
    int64_t group_rows;
};

template <int D>
cudaError_t launch(const Args& a, const Mask& m1, const Mask& m2, cudaStream_t stream) {
    const bf16* x = static_cast<const bf16*>(a.x);
    const bf16* w1 = static_cast<const bf16*>(a.w1);
    const float* b1 = static_cast<const float*>(a.b1);
    const bf16* w2 = static_cast<const bf16*>(a.w2);
    const bf16* dy = static_cast<const bf16*>(a.dy);

    const int smem_a = SmemA<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(mlp_dx_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
    if (err != cudaSuccess) return err;
    bf16* dyb = static_cast<bf16*>(a.dyb);
    mlp_dx_kernel<D><<<static_cast<unsigned>((a.n + BM - 1) / BM), THREADS, smem_a, stream>>>(
        x, w1, b1, w2, dy, static_cast<bf16*>(a.dx), dyb, a.n, a.f, m1, m2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int smem_b = SmemB<D>::BYTES;
    err = cudaFuncSetAttribute(mlp_dw_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
    if (err != cudaSuccess) return err;
    mlp_dw_kernel<D><<<dim3(a.f / FCB, a.groups), THREADS, smem_b, stream>>>(
        x, w1, b1, w2, dy, dyb, static_cast<float*>(a.ws), a.n, a.f, a.group_rows, m1, m2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int64_t dw_size = static_cast<int64_t>(D) * a.f;
    const int64_t total = 2 * dw_size + a.f + D;
    int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132 * 8) blocks = 132 * 8;
    mlp_reduce_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const float*>(a.ws), a.groups, total, static_cast<float*>(a.dw1),
        static_cast<float*>(a.dw2), static_cast<float*>(a.db1), static_cast<float*>(a.db2),
        dw_size, a.f);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x, dy and dx (n, d), w1 (d, f) and w2
// (f, d) are contiguous bf16; b1 (f,) fp32; dw1 (d, f), dw2 (f, d), db1 (f,)
// and db2 (d,) contiguous fp32 outputs; dyb an (n, d) bf16 workspace and ws
// an fp32 workspace of groups x (2 d f + f + d). Rows [g * group_rows, (g + 1) * group_rows) form group
// g; group_rows is a multiple of 64 and groups * group_rows >= n. d is 128
// or 256, f a multiple of 128. dropout: 0 = none, 1 = the forward's masks
// of seed1 (hidden) and seed2 (output). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int mmd_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* dy, void* dx, void* dyb, void* ws, void* dw1, void* db1,
                           void* dw2, void* db2, int64_t n, int d, int f, int groups, int64_t group_rows,
                           uint64_t seed1, uint64_t seed2, uint32_t threshold, float scale,
                           int dropout, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || f <= 0 || f % 128 != 0 || groups <= 0 || groups > 65535 ||
        group_rows <= 0 || group_rows % BM != 0 || groups * group_rows < n ||
        (n + BM - 1) / BM > 0x7FFFFFFF) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const float s = dropout ? scale : 1.f;
    const Mask m1{seed1, threshold, s, dropout}, m2{seed2, threshold, s, dropout};
    const Args a{x, w1, b1, w2, dy, dx, dyb, ws, dw1, db1, dw2, db2, n, f, groups, group_rows};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 128) return launch<128>(a, m1, m2, st);
    if (d == 256) return launch<256>(a, m1, m2, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
