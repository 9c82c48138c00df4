// Fused GELU-MLP backward with the dropout masks regenerated in the kernel,
// for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/mlp.py::_mlp_bwd_call (its Pallas body _bwd_kernel):
// the backward of each of the fusion model's six MLPs in a bf16 train step
// with dropout (N = 256 x 512 or 256 x 64 rows, D 256, F 1024; at the CLI's
// --embed_dim 384 and 512, D 384 / F 1536 and D 512 / F 2048).
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
// What bounds it on this card: arithmetic, 10 N D F operations (the five
// products above) against x, dy and dx (6 N D bytes) and the weights: far
// above the bf16 ridge. The TPU kernel keeps hb and dab in VMEM and adds
// every row block's dW into one output block, in grid order. Blocks on
// Hopper run in no order, one CTA cannot hold dW1 + dW2 (2 MB in fp32),
// and a CTA that keeps a 128 x D dx accumulator in registers has none left
// for the hidden products. So each product is computed once, and what
// links them goes through device memory: 4 N F bytes of hb and dab,
// written once and read once. Every product runs on wgmma (the warpgroup
// instruction, operands in 128-byte-swizzled shared memory filled by
// cp.async): mma.sync reached about a quarter of the bf16 peak here. Three
// launches, deterministic (fixed-order sums, no atomics):
//   A. mlp_bwd_hidden_kernel  one CTA per 128 rows (two warpgroups of 64),
//        x and dyb resident in shared memory (dyb built once from dy and
//        the output mask, and written out). It walks F in 64-column
//        chunks, w1[:, chunk] and w2[chunk, :] streamed through a 4-stage
//        ring, 64 rows of D a stage; each warpgroup issues a = x w1 and
//        dh = dyb w2^T for its rows (m64n64k16). At the end of a chunk it
//        forms hb and dab (one tanh for GELU and its derivative) into the
//        (N, F) workspaces, and the column sums of da, per warp and then
//        over the CTA, into a db1 partial row. The hidden keep bits of the
//        next chunk are drawn a slice a stage.
//   B. mlp_bwd_product_kernel  one launch of 128 x 128 output tiles
//        (m64n128k16 a warpgroup), 3 stages of 64 along the contraction,
//        two CTAs an SM: dW1 = x^T dab and dW2 = hb^T dyb with both
//        operands MN-major, split over K = N into the row groups of
//        ops/mlp.py::backward_groups (fp32 partials), then dx = bf16(dab
//        w1^T) (K-major, K = F, no split). No Philox, nothing recomputed.
//   C. mlp_bwd_reduce_kernel  sums the groups' dW partials and the row
//        tiles' db1 and db2 partials, in a fixed order.
// 10 N D F operations, the TPU body's count. D 128 or 256 as above; every
// other multiple of 128 up to MAX_D (mlp_common.cuh) runs pass A as the two
// launches A0 and A1 described before pass B, with x and dyb streamed along
// D; F a multiple of 128; any N (missing rows of the last tile read zeros
// and contribute nothing).

#include <atomic>

#include "mlp_common.cuh"
#include "mlp_tile.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

using mmd_tc::bf16;
using mmd_mlp::Mask;
using mmd_wgmma::align_1024;
using mmd_wgmma::desc_kmajor;
using mmd_wgmma::desc_mnmajor;
using mmd_wgmma::fence_async_shared;
using mmd_wgmma::static_for;
using mmd_wgmma::wgmma_commit;
using mmd_wgmma::wgmma_fence;
using mmd_wgmma::wgmma_n64;
using mmd_wgmma::wgmma_wait;

constexpr int THREADS = 256;
static_assert(THREADS == mmd_mlp_tile::THREADS, "pass B's tiles are two warpgroups");

// pass A
constexpr int BM = 128;           // rows a CTA: two warpgroups of 64
constexpr int FC = 64;            // hidden columns a chunk
constexpr int KS = 64;            // rows of w1 (columns of w2) a weight stage
constexpr int STAGES_A = 4;

// pass B: 128 x 128 output tiles of mlp_tile.cuh, 3 stages of 64
using mmd_mlp_tile::BKW;
using mmd_mlp_tile::BT;
using mmd_mlp_tile::product_tile;
using mmd_mlp_tile::TILE_K_K;
using mmd_mlp_tile::TILE_MN_MN;
constexpr int SMEM_B = mmd_mlp_tile::SMEM;
constexpr int GROUP_ALIGN = 64;   // group_rows is a multiple of this

// pass C
constexpr int SLICES_C = THREADS / 8;     // partial rows summed side by side
constexpr int DW_BLOCKS_C = 132 * 4;      // most blocks on the dW sums

int64_t row_tiles(int64_t n) { return (n + BM - 1) / BM; }

// The workspace: hb and dab (N, F) bf16, dyb (N, D) bf16, then fp32
// partials: dW [groups][dW1 (D, F) | dW2 (F, D)], db1 [row tiles][F], db2
// [row tiles][D]. Every piece starts on a 16-byte boundary (F and D are
// multiples of 128).
struct Work {
    bf16 *hb, *dab, *dyb;
    float *dw, *db1, *db2;
};

int64_t workspace_bytes(int64_t n, int d, int f, int groups) {
    const int64_t t = row_tiles(n);
    return 2 * (2 * n * f + n * d) + 4 * (2 * int64_t{groups} * d * f + t * f + t * d);
}

Work carve(void* ws, int64_t n, int d, int f, int groups) {
    Work w;
    w.hb = static_cast<bf16*>(ws);
    w.dab = w.hb + n * f;
    w.dyb = w.dab + n * f;
    w.dw = reinterpret_cast<float*>(w.dyb + n * d);
    w.db1 = w.dw + 2 * int64_t{groups} * d * f;
    w.db2 = w.db1 + row_tiles(n) * f;
    return w;
}

// -- pass A: hb, dab, dyb and the bias partials ---------------------------------

template <int D>
struct SmemA {
    static constexpr int X = 0;                          // x, K-major, D / 64 blocks
    static constexpr int BLOCK = BM * 128;               // one block: 64 columns
    static constexpr int DY = X + (D / 64) * BLOCK;      // dyb, the same layout
    static constexpr int W = DY + (D / 64) * BLOCK;      // the weight stages
    static constexpr int W1_BYTES = KS * 128;            // w1 slice, MN-major, one atom
    static constexpr int STAGE = W1_BYTES + FC * 128;    // + w2 slice, K-major
    static constexpr int KEEP_BYTES = BM * FC / 8;       // a chunk's hidden keep bits
    static constexpr int KEEP1 = W + STAGES_A * STAGE;   // [2][BM][FC / 8]
    static constexpr int KEEP2 = KEEP1 + 2 * KEEP_BYTES; // [BM][D / 8]
    static constexpr int DB1 = KEEP2 + BM * D / 8;       // [8 warps][FC] fp32
    static constexpr int BYTES = DB1 + 8 * FC * 4 + 1024;    // + the alignment
    // the dyf column sums, [THREADS][8] fp32, use the weight stages before
    // the first is loaded
    static_assert(THREADS * 8 * 4 <= STAGES_A * STAGE, "db2 partials fit the stages");
    static_assert(BYTES <= 232448, "one CTA an SM");
};

// Byte offset of element (r, c) in a K-major tile of BM rows stored as
// 64-column blocks (c a multiple of 8: a 16-byte chunk).
__device__ __forceinline__ int kmajor_at(int r, int c) {
    return (c >> 6) * (BM * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// dyb = bf16(dy m2) of a tile into shared memory (K-major, swizzled) and
// into dyb_out (the tile's rows of an (N, D) array); dy rows past `valid`
// are zeros. Thread t handles the same 8 columns of every row it touches,
// so it keeps their fp32 column sums in `colsum`.
template <int D>
__device__ __forceinline__ void build_dyb(unsigned char* dys, const bf16* dy, bf16* dyb_out,
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
        *reinterpret_cast<uint4*>(dys + kmajor_at(r, c)) = out;
        if (r < valid) *reinterpret_cast<uint4*>(dyb_out + (row0 + r) * D + c) = out;
    }
}

// The state a thread of pass A carries between its calls below.
struct HiddenTile {
    int64_t row0, valid, tile;
    int f;
    int wg, warp, g, q;
    Mask m1;
};

// The epilogue of one chunk (hidden columns c0..c0 + 63) from its
// accumulators: hb = bf16(gelu(a + b1) m1) and dab = bf16(dh m1 gelu'(a +
// b1)) out, and the warp's column sums of da (over its 16 rows, lanes in a
// fixed order) into the db1 scratch, [8 warps][FC].
__device__ __forceinline__ void hidden_epilogue(const HiddenTile& h, const float (&acc_a)[32],
                                                const float (&acc_d)[32], const float* b1,
                                                int c0, const uint8_t* kb, float* db1s,
                                                const Work& ws) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {               // the 8-column tiles of the chunk
        const int col = 8 * j + 2 * h.q;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + c0 + col);
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = h.wg * 64 + (h.warp & 3) * 16 + h.g + 8 * half;
            float hv[2], dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float av = acc_a[4 * j + 2 * half + e] + (e ? bias.y : bias.x);
                const float k = mmd_mlp::keep_scale<FC>(kb, h.m1, r, col + e);
                float gl, dg;
                mmd_mlp::gelu_tanh_and_grad_fast(av, gl, dg);
                hv[e] = gl * k;
                dv[e] = acc_d[4 * j + 2 * half + e] * k * dg;
                dsum[e] += dv[e];               // zero on rows past the end: dyb is 0
            }
            if (r < h.valid) {
                const int64_t at = (h.row0 + r) * h.f + c0 + col;
                mmd_tc::store_bf16x2(ws.hb + at, hv[0], hv[1]);
                mmd_tc::store_bf16x2(ws.dab + at, dv[0], dv[1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float v = dsum[e];
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
            if (h.g == 0) db1s[h.warp * FC + col + e] = v;
        }
    }
}

// db1 of one chunk for the tile: the 8 warps' partials in order (threads
// 0..FC-1; after a barrier that follows the chunk's epilogue).
__device__ __forceinline__ void hidden_db1(const HiddenTile& h, const float* db1s, int c0,
                                           const Work& ws) {
    if (threadIdx.x < FC) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += db1s[w * FC + threadIdx.x];
        ws.db1[h.tile * h.f + c0 + threadIdx.x] = s;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_hidden_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ dy, Work ws, int64_t n, int f, Mask m1,
                      Mask m2) {
    using S = SmemA<D>;
    constexpr int SLICES = D / KS;              // weight stages a chunk
    constexpr int KEEP_ROWS = BM / SLICES;      // hidden keep rows drawn a stage
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    uint8_t* keep1 = smem + S::KEEP1;
    uint8_t* keep2 = smem + S::KEEP2;
    float* db1s = reinterpret_cast<float*>(smem + S::DB1);
    const uint32_t xs = mmd_tc::smem_addr(smem + S::X);
    const uint32_t dys = mmd_tc::smem_addr(smem + S::DY);

    HiddenTile h;
    h.tile = blockIdx.x;
    h.row0 = h.tile * BM;
    h.valid = n - h.row0;
    h.f = f;
    h.warp = threadIdx.x >> 5;
    h.wg = h.warp >> 2;
    h.g = (threadIdx.x & 31) >> 2;
    h.q = threadIdx.x & 3;
    h.m1 = m1;
    const int64_t row0 = h.row0;

    // x (in flight while dyb is built), the output keep bits, dyb and the
    // tile's column sums of dyf, summed over the threads of a column in order
    for (int i = threadIdx.x; i < BM * (D / 8); i += THREADS) {
        const int r = i / (D / 8), c = 8 * (i % (D / 8));
        const bool ok = r < h.valid;
        mmd_tc::cp_async16(smem + S::X + kmajor_at(r, c), ok ? x + (row0 + r) * D + c : x, ok);
    }
    mmd_tc::cp_async_commit();
    mmd_mlp::fill_keep<BM, D>(keep2, m2, row0, D, 0);
    __syncthreads();
    {
        float colsum[8] = {};
        build_dyb<D>(smem + S::DY, dy, ws.dyb, row0, h.valid, keep2, m2, colsum);
        float* part = reinterpret_cast<float*>(smem + S::W);
#pragma unroll
        for (int j = 0; j < 8; ++j) part[threadIdx.x * 8 + j] = colsum[j];
        __syncthreads();
        for (int col = threadIdx.x; col < D; col += THREADS) {
            float s = 0.f;
            for (int t = col / 8; t < THREADS; t += D / 8) s += part[t * 8 + col % 8];
            ws.db2[h.tile * D + col] = s;
        }
        __syncthreads();                        // the stages take the partials' place
    }

    const int chunks = f / FC;
    const int iters = chunks * SLICES;
    auto load_stage = [&](int it) {
        const int c0 = (it / SLICES) * FC, kd = (it % SLICES) * KS;
        unsigned char* st = smem + S::W + (it % STAGES_A) * S::STAGE;
        // w1[kd.., c0..c0 + 63]: KS rows of one MN-major atom
        for (int i = threadIdx.x; i < KS * 8; i += THREADS) {
            const int k = i >> 3, c = i & 7;
            mmd_tc::cp_async16(st + k * 128 + ((c ^ (k & 7)) << 4),
                               w1 + static_cast<int64_t>(kd + k) * f + c0 + c * 8, true);
        }
        // w2[c0.., kd..kd + 63]: FC rows, K-major
        for (int i = threadIdx.x; i < FC * 8; i += THREADS) {
            const int r = i >> 3, c = i & 7;
            mmd_tc::cp_async16(st + S::W1_BYTES + r * 128 + ((c ^ (r & 7)) << 4),
                               w2 + static_cast<int64_t>(c0 + r) * D + kd + c * 8, true);
        }
    };
    auto fill_keep1 = [&](int chunk, int r0, int rows) {     // rows r0.. of a chunk's bits
        uint8_t* kb = keep1 + (chunk & 1) * S::KEEP_BYTES;
        for (int i = threadIdx.x; i < rows * (FC / 8); i += THREADS) {
            const int r = r0 + i / (FC / 8), c8 = 8 * (i % (FC / 8));
            kb[r * (FC / 8) + c8 / 8] = static_cast<uint8_t>(mmd_mlp::keep_byte(
                m1, static_cast<uint64_t>(row0 + r), f, chunk * FC + c8));
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES_A - 2; ++s) {
        if (s < iters) load_stage(s);
        mmd_tc::cp_async_commit();
    }
    fill_keep1(0, 0, BM);

    // A stage is overwritten two stages after its products were issued:
    // wgmma.wait_group 1 has retired them by then. The epilogue waits for
    // all of its chunk's products (reading the accumulators of a product in
    // flight would make ptxas serialize every wgmma).
    float acc_a[32] = {}, acc_d[32] = {};
    for (int c = 0; c < chunks; ++c) {
        static_for<0, SLICES>([&](auto slice_tag) {
            constexpr int s = decltype(slice_tag)::value;
            const int it = c * SLICES + s;
            mmd_tc::cp_async_wait<STAGES_A - 3>();
            fence_async_shared();
            __syncthreads();                    // stage `it` is in; stage it - 2 is retired
            if (s == 0 && c > 0) hidden_db1(h, db1s, (c - 1) * FC, ws);
            if (it + STAGES_A - 2 < iters) load_stage(it + STAGES_A - 2);
            mmd_tc::cp_async_commit();
            if (c + 1 < chunks) fill_keep1(c + 1, s * KEEP_ROWS, KEEP_ROWS);

            const uint32_t st = mmd_tc::smem_addr(smem + S::W + (it % STAGES_A) * S::STAGE);
            const uint32_t xa = xs + s * S::BLOCK + h.wg * 64 * 128;
            const uint32_t da = dys + s * S::BLOCK + h.wg * 64 * 128;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS; kk += 16) {
                const int acc = s > 0 || kk > 0;
                wgmma_n64<0, 1>(acc_a, desc_kmajor(xa + kk * 2),
                                desc_mnmajor(st + kk * 128, KS * 128), acc);
                wgmma_n64<0, 0>(acc_d, desc_kmajor(da + kk * 2),
                                desc_kmajor(st + S::W1_BYTES + kk * 2), acc);
            }
            wgmma_commit();
            wgmma_wait<1>();
        });
        wgmma_wait<0>();
        hidden_epilogue(h, acc_a, acc_d, b1, c * FC, keep1 + (c & 1) * S::KEEP_BYTES, db1s,
                        ws);
    }
    __syncthreads();
    hidden_db1(h, db1s, (chunks - 1) * FC, ws);
}

// -- pass A at D above 256: dyb first, then (row tile, 128 hidden columns) tiles ----
// Pass A above holds x and dyb for 128 rows in shared memory: 192 KB at D
// 384 and 256 KB at D 512, with the weight stages beside them past the 227
// KB a CTA may have. So above D 256 pass A streams x and dyb along D, in
// two launches:
//   A0. mlp_bwd_dyb_kernel  dyb = bf16(dy m2) into the workspace and each
//       row tile's column sums of dyf (its db2 partial row);
//   A1. mlp_bwd_hidden_wide_kernel  one CTA per (128-row tile, 128 hidden
//       columns): a = x w1[:, f0..] and dh = dyb w2[f0.., :]^T over D in
//       stages of 64 (x, w1, dyb and w2 slices, 64 KB a stage, 3 stages:
//       one CTA an SM), then the epilogue of pass A above on the tile:
//       hb, dab and the tile's db1 partial (its 8 warps' column sums in
//       order). x and dyb are read from L2 once per 128 hidden columns.
//       ptxas -v (sm_90a): A1 247 registers (its two m64n128
//       accumulators are 128 a thread), A0 54; no spill.
// Passes B and C are the same launches at every D.

// One CTA per (128-row tile, 128 columns of D); thread t keeps the 8
// columns 8 (t % 16) of the slice and walks rows t / 16, t / 16 + 16, ...;
// the 16 row slices' column sums are added in order.
__global__ void __launch_bounds__(THREADS)
mlp_bwd_dyb_kernel(const bf16* __restrict__ dy, Work ws, int64_t n, int d, Mask m2) {
    constexpr int SLICES = THREADS / (BT / 8);
    __shared__ float part[SLICES][BT];
    const int ct = d / BT;
    const int64_t tile = blockIdx.x / ct;
    const int d0 = static_cast<int>(blockIdx.x % ct) * BT;
    const int64_t row0 = tile * BM;
    const int64_t valid = n - row0;
    const int u = threadIdx.x % (BT / 8), slice = threadIdx.x / (BT / 8);
    const int c = d0 + 8 * u;
    float colsum[8] = {};
    for (int r = slice; r < BM && r < valid; r += SLICES) {
        const int64_t row = row0 + r;
        const uint4 raw = *reinterpret_cast<const uint4*>(dy + row * d + c);
        const uint32_t bits = mmd_mlp::keep_byte(m2, static_cast<uint64_t>(row), d, c);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint4 out;
        __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 p = __bfloat1622float2(hv[j]);
            const float v0 = p.x * ((bits >> (2 * j)) & 1u ? m2.scale : 0.f);
            const float v1 = p.y * ((bits >> (2 * j + 1)) & 1u ? m2.scale : 0.f);
            colsum[2 * j] += v0;
            colsum[2 * j + 1] += v1;
            ho[j] = __floats2bfloat162_rn(v0, v1);
        }
        *reinterpret_cast<uint4*>(ws.dyb + row * d + c) = out;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) part[slice][8 * u + j] = colsum[j];
    __syncthreads();
    if (threadIdx.x < BT) {
        float s = 0.f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) s += part[sl][threadIdx.x];
        ws.db2[tile * d + d0 + threadIdx.x] = s;
    }
}

struct SmemW {
    static constexpr int TILE = mmd_mlp_tile::TILE;    // 128 x 64 bf16
    static constexpr int STAGE = 4 * TILE;             // x, w1, dyb, w2 slices
    static constexpr int STAGES = mmd_mlp_tile::STAGES;
    static constexpr int KEEP = STAGES * STAGE;        // [BT][BT / 8] hidden keep bits
    static constexpr int DB1 = KEEP + BT * BT / 8;     // [8 warps][BT] fp32
    static constexpr int BYTES = DB1 + 8 * BT * 4 + 1024;      // + the alignment
    static_assert(BYTES <= 232448, "one CTA an SM");
};

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_hidden_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w2, Work ws,
                           int64_t n, int d, int f, Mask m1) {
    using S = SmemW;
    using mmd_mlp_tile::load_kmajor;
    using mmd_mlp_tile::load_mnmajor;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    uint8_t* keep = smem + S::KEEP;
    float* db1s = reinterpret_cast<float*>(smem + S::DB1);
    const int ft = f / BT;
    const int64_t tile = blockIdx.x / ft;
    const int f0 = static_cast<int>(blockIdx.x % ft) * BT;
    const int64_t row0 = tile * BM;
    const int64_t valid = n - row0;
    const int warp = threadIdx.x >> 5, wg = warp >> 2;
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    const bf16* xt = x + row0 * d;
    const bf16* dyt = ws.dyb + row0 * d;
    const int iters = d / BKW;
    auto load = [&](int i) {
        unsigned char* st = smem + (i % S::STAGES) * S::STAGE;
        const int64_t k = static_cast<int64_t>(i) * BKW;
        load_kmajor<BT>(st, xt + k, d, valid);
        load_mnmajor(st + S::TILE, w1 + k * f + f0, f, BKW);
        load_kmajor<BT>(st + 2 * S::TILE, dyt + k, d, valid);
        load_kmajor<BT>(st + 3 * S::TILE, w2 + static_cast<int64_t>(f0) * d + k, d, BT);
    };
#pragma unroll
    for (int s = 0; s < S::STAGES - 2; ++s) {
        if (s < iters) load(s);
        mmd_tc::cp_async_commit();
    }
    // the tile's hidden keep bits while the first stage lands
    mmd_mlp::fill_keep<BT, BT>(keep, m1, row0, f, f0);

    // a stage is overwritten two iterations after its products were issued
    // (wgmma.wait_group 1 has retired them by then); the epilogue waits for
    // all of them
    float acc_a[64] = {}, acc_d[64] = {};
    for (int i = 0; i < iters; ++i) {
        mmd_tc::cp_async_wait<S::STAGES - 3>();
        fence_async_shared();
        __syncthreads();                        // stage i is in; stage i - 2 is retired
        if (i + S::STAGES - 2 < iters) load(i + S::STAGES - 2);
        mmd_tc::cp_async_commit();
        const uint32_t st = mmd_tc::smem_addr(smem + (i % S::STAGES) * S::STAGE);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKW; kk += 16) {
            const int acc = i > 0 || kk > 0;
            mmd_wgmma::wgmma_n128<0, 1>(acc_a, desc_kmajor(st + wg * 64 * 128 + kk * 2),
                                        desc_mnmajor(st + S::TILE + kk * 128, BKW * 128), acc);
            mmd_wgmma::wgmma_n128<0, 0>(acc_d,
                                        desc_kmajor(st + 2 * S::TILE + wg * 64 * 128 + kk * 2),
                                        desc_kmajor(st + 3 * S::TILE + kk * 2), acc);
        }
        wgmma_commit();
        wgmma_wait<1>();
    }
    wgmma_wait<0>();

    // hb = bf16(gelu(a + b1) m1), dab = bf16(dh m1 gelu'(a + b1)), and the
    // warps' column sums of da (rows past the end add 0: their dyb is 0)
    const int wm = wg * 64 + (warp & 3) * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + f0 + col);
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = wm + g + 8 * half;
            float hv[2], dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float av = acc_a[4 * j + 2 * half + e] + (e ? bias.y : bias.x);
                const float k = mmd_mlp::keep_scale<BT>(keep, m1, r, col + e);
                float gl, dg;
                mmd_mlp::gelu_tanh_and_grad_fast(av, gl, dg);
                hv[e] = gl * k;
                dv[e] = acc_d[4 * j + 2 * half + e] * k * dg;
                dsum[e] += dv[e];
            }
            if (r < valid) {
                const int64_t at = (row0 + r) * f + f0 + col;
                mmd_tc::store_bf16x2(ws.hb + at, hv[0], hv[1]);
                mmd_tc::store_bf16x2(ws.dab + at, dv[0], dv[1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float v = dsum[e];
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
            v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
            if (g == 0) db1s[warp * BT + col + e] = v;
        }
    }
    __syncthreads();
    if (threadIdx.x < BT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += db1s[w * BT + threadIdx.x];
        ws.db1[tile * f + f0 + threadIdx.x] = s;
    }
}

// -- pass B: dW1, dW2 partials and dx -------------------------------------------
// (the tile: mlp_tile.cuh's product_tile)

// Block order: the dW tiles of group 0 (dW1 then dW2), of group 1, ...,
// then the dx tiles, the D / 128 tiles of a row block side by side, so that
// the tiles that read the same rows run together. DC: D as a constant (128,
// 256), or 0 for the wide path's D, which `d` gives.
template <int DC>
__global__ void __launch_bounds__(THREADS, 2)
mlp_bwd_product_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, Work ws,
                       bf16* __restrict__ dx, int64_t n, int d, int f, int groups,
                       int64_t group_rows) {
    const int D = DC ? DC : d;
    const int DT = D / BT;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = align_1024(smem_raw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int wm = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows of the tile
    const int ft = f / BT;
    const int per_group = 2 * DT * ft;
    float acc[64] = {};

    const int64_t bid = blockIdx.x;
    if (bid < static_cast<int64_t>(groups) * per_group) {
        const int grp = static_cast<int>(bid / per_group);
        int t = static_cast<int>(bid % per_group);
        const int64_t r0 = grp * group_rows;
        const int64_t rows = n - r0 < group_rows ? n - r0 : group_rows;
        const int iters = static_cast<int>((rows + BKW - 1) / BKW);
        float* out = ws.dw + static_cast<int64_t>(grp) * 2 * D * f;
        int64_t ld;
        if (t < DT * ft) {                      // dW1[d0.., f0..] = x^T dab
            const int d0 = (t / ft) * BT, f0 = (t % ft) * BT;
            product_tile<TILE_MN_MN>(acc, smem, x + r0 * D + d0, D, ws.dab + r0 * f + f0, f,
                                     rows, iters);
            out += static_cast<int64_t>(d0) * f + f0;
            ld = f;
        } else {                                // dW2[f0.., d0..] = hb^T dyb
            t -= DT * ft;
            const int f0 = (t / DT) * BT, d0 = (t % DT) * BT;
            product_tile<TILE_MN_MN>(acc, smem, ws.hb + r0 * f + f0, f, ws.dyb + r0 * D + d0, D,
                                     rows, iters);
            out += static_cast<int64_t>(D) * f + static_cast<int64_t>(f0) * D + d0;
            ld = D;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = wm + g + 8 * half, c = 8 * j + 2 * q;
                *reinterpret_cast<float2*>(out + r * ld + c) =
                    make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            }
        return;
    }
    // dx[row0.., d0..] = bf16(dab w1^T): w1 (D, F) is [n][k]
    const int64_t t = bid - static_cast<int64_t>(groups) * per_group;
    const int64_t row0 = (t / DT) * BT;
    const int d0 = static_cast<int>(t % DT) * BT;
    const int64_t valid = n - row0;
    product_tile<TILE_K_K>(acc, smem, ws.dab + row0 * f, f, w1 + static_cast<int64_t>(d0) * f,
                           f, valid, f / BKW);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = wm + g + 8 * half, c = d0 + 8 * j + 2 * q;
            if (r < valid) {
                mmd_tc::store_bf16x2(dx + (row0 + r) * D + c, acc[4 * j + 2 * half],
                                     acc[4 * j + 2 * half + 1]);
            }
        }
}

// -- C: the fixed-order sums ------------------------------------------------------

// Blocks [0, dw_blocks) sum the dW partials over the groups, in group
// order, four floats a thread; then 8 columns a block of db1 and of db2,
// each over the row tiles' partial rows: 32 slices of rows side by side,
// each in row order, then the slices in order.
__global__ void __launch_bounds__(THREADS)
mlp_bwd_reduce_kernel(Work ws, float* __restrict__ grads, int d, int f, int groups,
                      int64_t tiles, int dw_blocks) {
    const int64_t dw_size = static_cast<int64_t>(d) * f;
    if (static_cast<int>(blockIdx.x) < dw_blocks) {
        const int64_t quads = 2 * dw_size / 4;
        const float4* src = reinterpret_cast<const float4*>(ws.dw);
        float4* dst = reinterpret_cast<float4*>(grads);
        for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < quads;
             i += static_cast<int64_t>(dw_blocks) * THREADS) {
            float4 s = src[i];
            for (int gi = 1; gi < groups; ++gi) {
                const float4 v = src[gi * quads + i];
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            }
            dst[i] = s;
        }
        return;
    }
    __shared__ float part[THREADS];
    int b = static_cast<int>(blockIdx.x) - dw_blocks;
    const float* src = ws.db1;
    float* dst = grads + 2 * dw_size;           // db1, then db2
    int ld = f;
    if (b >= f / 8) {
        b -= f / 8;
        src = ws.db2;
        dst += f;
        ld = d;
    }
    const int col = 8 * b + (threadIdx.x & 7), slice = threadIdx.x >> 3;
    float s = 0.f;
    for (int64_t r = slice; r < tiles; r += SLICES_C) s += src[r * ld + col];
    part[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < 8) {
        float total = 0.f;
        for (int sl = 0; sl < SLICES_C; ++sl) total += part[sl * 8 + threadIdx.x];
        dst[col] = total;
    }
}

// Passes B and C, the same launches at every D (DC: D as a constant, or 0).
template <int DC>
cudaError_t launch_products_and_sums(const bf16* x, const bf16* w1, bf16* dx, float* grads,
                                     const Work& ws, int64_t n, int d, int f, int groups,
                                     int64_t group_rows, cudaStream_t stream) {
    const int64_t tiles = row_tiles(n);
    const int64_t products = static_cast<int64_t>(groups) * 2 * (d / BT) * (f / BT) +
                             (n + BT - 1) / BT * (d / BT);
    mlp_bwd_product_kernel<DC><<<static_cast<unsigned>(products), THREADS, SMEM_B, stream>>>(
        x, w1, ws, dx, n, d, f, groups, group_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int64_t quads = 2 * static_cast<int64_t>(d) * f / 4;
    int64_t dw_blocks = (quads + THREADS - 1) / THREADS;
    if (dw_blocks > DW_BLOCKS_C) dw_blocks = DW_BLOCKS_C;
    mlp_bwd_reduce_kernel<<<static_cast<unsigned>(dw_blocks + f / 8 + d / 8), THREADS, 0,
                            stream>>>(ws, grads, d, f, groups, tiles,
                                      static_cast<int>(dw_blocks));
    return cudaGetLastError();
}

// Above 48 KB of dynamic shared memory a kernel has to be allowed it, once
// per device: `raised` holds a bit for each device where that is done.
template <int D>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                   const bf16* dy, bf16* dx, float* grads, const Work& ws, int64_t n, int f,
                   int groups, int64_t group_rows, const Mask& m1, const Mask& m2, int device,
                   cudaStream_t stream) {
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        cudaError_t err = cudaFuncSetAttribute(mlp_bwd_hidden_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SmemA<D>::BYTES);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(mlp_bwd_product_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B);
        }
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    const int64_t tiles = row_tiles(n);
    mlp_bwd_hidden_kernel<D><<<static_cast<unsigned>(tiles), THREADS, SmemA<D>::BYTES, stream>>>(
        x, w1, b1, w2, dy, ws, n, f, m1, m2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_products_and_sums<D>(x, w1, dx, grads, ws, n, D, f, groups, group_rows,
                                       stream);
}

// D above 256: passes A0 and A1, then B and C.
cudaError_t launch_wide(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                        const bf16* dy, bf16* dx, float* grads, const Work& ws, int64_t n, int d,
                        int f, int groups, int64_t group_rows, const Mask& m1, const Mask& m2,
                        int device, cudaStream_t stream) {
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        cudaError_t err = cudaFuncSetAttribute(mlp_bwd_hidden_wide_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SmemW::BYTES);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(mlp_bwd_product_kernel<0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B);
        }
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    const int64_t tiles = row_tiles(n);
    mlp_bwd_dyb_kernel<<<static_cast<unsigned>(tiles * (d / BT)), THREADS, 0, stream>>>(
        dy, ws, n, d, m2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlp_bwd_hidden_wide_kernel<<<static_cast<unsigned>(tiles * (f / BT)), THREADS, SmemW::BYTES,
                                 stream>>>(x, w1, b1, w2, ws, n, d, f, m1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return launch_products_and_sums<0>(x, w1, dx, grads, ws, n, d, f, groups, group_rows,
                                       stream);
}

}  // namespace

// Bytes of the workspace mmd_mlp_bwd takes for n rows, widths d and f, and
// `groups` row groups.
extern "C" int64_t mmd_mlp_bwd_workspace(int64_t n, int d, int f, int groups) {
    return workspace_bytes(n, d, f, groups);
}

// C entry point, bound with ctypes. x, dy and dx (n, d), w1 (d, f) and w2
// (f, d) are contiguous bf16; b1 (f,) fp32; grads the fp32 outputs [dW1
// (d, f) | dW2 (f, d) | db1 (f) | db2 (d)], written whole; ws a workspace
// of mmd_mlp_bwd_workspace(n, d, f, groups) bytes, 16-byte aligned, that
// needs no zeroing. Rows [g * group_rows, (g + 1) * group_rows) form group
// g: group_rows is a multiple of 64 and every group holds rows. d is a
// multiple of 128 up to MAX_D, f a multiple of 128. dropout: 0 = none, 1 = the forward's masks of
// seed1 (hidden) and seed2 (output). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int mmd_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* dy, void* dx, void* grads, void* ws, int64_t ws_bytes,
                           int64_t n, int d, int f, int groups, int64_t group_rows,
                           uint64_t seed1, uint64_t seed2, uint32_t threshold, float scale,
                           int dropout, int device, void* stream) {
    if (n <= 0 || f <= 0 || f % BT != 0 || f % FC != 0 || groups <= 0 || groups > 65535 ||
        group_rows <= 0 || group_rows % GROUP_ALIGN != 0 || (groups - 1) * group_rows >= n ||
        groups * group_rows < n || row_tiles(n) > 0x7FFFFFFF / 2 || device < 0 ||
        device >= 64 || d <= 0 || d % BT != 0 || d > mmd_mlp::MAX_D ||
        row_tiles(n) > 0x7FFFFFFF / (f / BT) / 2 || ws_bytes < workspace_bytes(n, d, f, groups)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float s = dropout ? scale : 1.f;
    const Mask m1{seed1, threshold, s, dropout}, m2{seed2, threshold, s, dropout};
    const Work w = carve(ws, n, d, f, groups);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* w1b = static_cast<const bf16*>(w1);
    const float* b1f = static_cast<const float*>(b1);
    const bf16* w2b = static_cast<const bf16*>(w2);
    const bf16* dyb = static_cast<const bf16*>(dy);
    bf16* dxb = static_cast<bf16*>(dx);
    float* gf = static_cast<float*>(grads);
    if (d == 128) {
        return launch<128>(xb, w1b, b1f, w2b, dyb, dxb, gf, w, n, f, groups, group_rows, m1, m2,
                           device, st);
    }
    if (d == 256) {
        return launch<256>(xb, w1b, b1f, w2b, dyb, dxb, gf, w, n, f, groups, group_rows, m1, m2,
                           device, st);
    }
    return launch_wide(xb, w1b, b1f, w2b, dyb, dxb, gf, w, n, d, f, groups, group_rows, m1, m2,
                       device, st);
}
