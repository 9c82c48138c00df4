// Fused GELU-MLP forward with in-kernel dropout, for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/mlp.py::_mlp_fwd_call (its Pallas body _fwd_kernel):
// the forward of each of the fusion model's six MLPs in a bf16 train step
// with dropout, rows N = 256 x 512 (text queries) or 256 x 64 (image
// queries), D 256, F 1024; at the CLI's --embed_dim 384 and 512, D 384 / F
// 1536 and D 512 / F 2048 (the two-launch path at the end of this note).
//
// What it computes, for x (N, D) bf16, w1 (D, F) bf16, b1 (F,) fp32, w2
// (F, D) bf16 and b2 (D,) fp32, with the rounding points of the TPU kernel:
//   a = x w1 + b1                        fp32 products, fp32 sums
//   h = bf16(gelu_tanh(a) * m1)          m1 = keep * scale at row * F + f
//   y = bf16((h w2 + b2) * m2)           m2 = keep * scale at row * D + d
// with the masks of mlp_common.cuh (seed 1 for m1, seed 2 for m2; both 1
// when dropout is off). Nothing F wide reaches device memory. Each row's y
// sums the chunks of F in order, on one CTA: no split, no atomics, the
// same bits every call.
//
// What bounds it on this card. 4 N D F tensor-core operations against 4 N D
// bytes of x and y: F = 1024 operations a byte, far above the ~295 where
// 989 TFLOP/s of bf16 meets 3.35 TB/s. But the work that is not a product
// weighs as much: at dropout 0.1, N F / 4 + N D / 4 Philox4x32-10 calls of
// ~70 integer instructions (the integer pipe does 64 lanes a clock an SM,
// against 1024 bf16 multiply-adds on the tensor cores), one tanh a hidden
// element, and every 128-row tile reads all of w1 and w2 (1 MB) from L2. So
// the design is about overlap, and about keeping the products' pipeline
// free of stalls.
//
//   * One CTA per 128 rows, one CTA an SM: two consumer warpgroups of 64
//     rows and a producer warpgroup (setmaxnreg: 56 registers for it, 224
//     for each consumer). x stays in shared memory for the whole kernel,
//     K-major and 128-byte swizzled (64 KB at D 256).
//   * F is walked in chunks of 64 columns. Stage p of a ring in shared
//     memory holds w1[:, chunk p] and w2[chunk p - 1, :] (MN-major, 64 KB at
//     D 256), chunk p's b1 and a slice of the tile's output keep bits: the
//     two products issued together read one stage. Two stages fit beside x
//     at D 256 (a third would need 264 KB), four at D 128. The producer refills a stage as soon as both
//     consumers release it: one thread issues the TMA loads (which swizzle
//     and count their bytes on the stage's mbarrier), the warpgroup copies
//     b1 and draws the output keep bits while they fly.
//   * A consumer warpgroup, chunk c: wait for its products (a = x w1[:, c],
//     wgmma m64n64k16 with both operands in shared memory, and y += h w2[c -
//     1, :]); add b1, take GELU (mlp_common.cuh's, the one #4 recomputes h
//     with) and the hidden keep bits in place; release the stage; pack h to
//     bf16 straight into the A fragments of the next product (h never
//     touches shared memory); issue
//     a = x w1[:, c + 1] and y += h w2[c, :] (wgmma m64n256k16, A from
//     registers; m64n128 at D 128) as one group; then draw chunk c + 1's
//     hidden keep bits into registers before waiting for those products (8
//     Philox calls a thread; lanes q and q ^ 1 share each call). No
//     accumulator is read while a product is in flight: ptxas would then
//     serialize every wgmma (C7514). A wgmma's issue waits while the tensor
//     cores' queue is full, so the draws mostly follow the products rather
//     than overlap them, and the two warpgroups run in step (PERF.md §6).
//   * The tail: b2 and the output keep bits, bf16, staged through the
//     warpgroup's own rows of the x tile and stored 16 bytes a thread.
// Any N (the last tile's missing rows read zeros and store nothing); D 128
// or 256; F a multiple of 128.
//
// D above 256 (the fusion CLI's --embed_dim 384 and 512; every multiple of
// 128 up to MAX_D, mlp_common.cuh) takes a design of its own: the one above
// does not stretch. x resident is 96 KB a 128-row tile at D 384, a stage of
// w1 and w2 96 KB, and each consumer's 64 x D fp32 y accumulator is 192
// registers a thread at D 384 and 256 at D 512, past the 224 a consumer
// gets. Of the two ways out -- (a) split y's columns over CTAs, each
// recomputing the hidden chunk for its slice (at D 512, 1.5 times the
// products and twice the hidden Philox draws with two slices of 256
// columns, 2.5 and 4 times with four of 128), or
// (b) two launches with h in device memory -- this takes (b), the way #4's
// pass A already works: no product or mask bit is computed twice, and both
// launches are one tile shape, mlp_tile.cuh's 128 x 128 wgmma tile over a
// 3-stage cp.async ring (A K-major, B MN-major as the weights lie), two
// CTAs an SM:
//   1. h = bf16(gelu(x w1 + b1) m1) into an (N, F) bf16 workspace: a tile
//      per (128 rows, 128 hidden columns), the contraction over D;
//   2. y = bf16((h w2 + b2) m2): a tile per (128 rows, 128 output columns),
//      the contraction over F in order, so each row's y sums F in one fixed
//      order and has the same bits every call.
// The rounding points, the GELU and the masks are those above (the keep
// bits of a tile drawn into shared memory with mlp_common.cuh's fill_keep
// before its products). It costs 4 N F bytes of h written and read back
// (1.07 GB at N 131,072, F 2,048) that the fused design never moves: at
// the text MLP of D 512 that is 0.32 ms at 3.35 TB/s beside the products'
// 0.56 ms bound. ptxas -v (sm_90a): both launches 126 registers, no spill
// (two CTAs an SM allow 128).

#include <cuda.h>

#include <atomic>

#include "mlp_common.cuh"
#include "mlp_tile.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

using mmd_mlp::Mask;
using mmd_tc::bf16;
using mmd_tc::cp_async16;
using mmd_tc::smem_addr;
using mmd_wgmma::fence_async_shared;
using mmd_wgmma::fence_operand;
using mmd_wgmma::mbar_arrive;
using mmd_wgmma::mbar_wait;
using mmd_wgmma::static_for;

constexpr int BM = 128;                 // rows a CTA: two consumer warpgroups of 64
constexpr int FC = 64;                  // hidden columns a chunk
constexpr int WG = 128;                 // threads a warpgroup
constexpr int CONSUMERS = 2 * WG;
constexpr int THREADS = CONSUMERS + WG; // and the producer
constexpr int SMEM_MAX = 232448;
// registers a thread after setmaxnreg: the producer's, and the consumers'
// share of what the launch gave the CTA's three warpgroups (setmaxnreg.inc
// waits until the registers it asks for are free: asking for more hangs)
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = (3 * LAUNCH_REGS - PRODUCER_REGS) / 2 / 8 * 8;

template <int D>
struct Smem {
    static constexpr int BLOCK = BM * 128;               // x: one 64-column K-major block
    static constexpr int X = 0;                          // x, D / 64 blocks
    static constexpr int W = X + (D / 64) * BLOCK;       // the ring's weights
    static constexpr int W1_BYTES = D * 128;             // w1[:, chunk]: [D rows][128 bytes]
    static constexpr int W2_BYTES = FC * D * 2;          // w2[chunk, :]: D / 64 atoms of
                                                         // [FC rows][128 bytes]
    static constexpr int STAGE = W1_BYTES + W2_BYTES;
    static constexpr int B1_BYTES = FC * 4;              // a chunk's b1
    static constexpr int KEEP_BYTES = BM * D / 8;        // the output keep bits [BM][D / 8]
    static constexpr int FIT = (SMEM_MAX - 1024 - W - KEEP_BYTES - 256) / (STAGE + B1_BYTES);
    static constexpr int RING = FIT < 4 ? FIT : 4;
    static constexpr int B1 = W + RING * STAGE;          // [RING][B1_BYTES]
    static constexpr int KEEP = B1 + RING * B1_BYTES;
    static constexpr int BARS = KEEP + KEEP_BYTES;       // full[RING], empty[RING]
    static constexpr int BYTES = BARS + 2 * RING * 8 + 1024;    // + the 1024-byte alignment
    static_assert(RING >= 2, "a stage loads while the one before it is read");
    static_assert(BYTES <= SMEM_MAX, "one CTA an SM");
};

// Byte offset of element (r, c) in a K-major tile of BM rows stored as
// 64-column blocks (c a multiple of 8: a 16-byte chunk), as mlp_bwd.cu's
// pass A lays out x.
__device__ __forceinline__ int kmajor_at(int r, int c) {
    return (c >> 6) * (BM * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// What both roles know of the tile.
struct Tile {
    int64_t row0, valid;
    int f, chunks;
    Mask m1, m2;
    const float* b1;
};

// The weights of stage p (0 <= p <= chunks), by one thread: w1[:, chunk p]
// (p < chunks; one box of 64 columns x D rows) and w2[chunk p - 1, :] (p > 0;
// D / 64 boxes of 64 rows x 64 columns, the MN-major atoms) by TMA, which
// writes them 128-byte swizzled and counts their bytes on the stage's full
// barrier.
template <int D>
__device__ __forceinline__ void load_stage(unsigned char* smem, const CUtensorMap* w1m,
                                           const CUtensorMap* w2m, const Tile& tl, int p) {
    using S = Smem<D>;
    unsigned char* st = smem + S::W + (p % S::RING) * S::STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS) + p % S::RING;
    mmd_wgmma::mbar_expect_tx(
        full, (p < tl.chunks ? S::W1_BYTES : 0) + (p > 0 ? S::W2_BYTES : 0));
    if (p < tl.chunks) mmd_wgmma::tma_load_2d(st, w1m, p * FC, 0, full);
    if (p > 0) {
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
            mmd_wgmma::tma_load_2d(st + S::W1_BYTES + a * FC * 128, w2m, a * 64, (p - 1) * FC,
                                   full);
        }
    }
}

// The rest of stage p, by threads t of NT: chunk p's slice of b1 (p <
// chunks) and output keep rows [p r, (p + 1) r) of the tile, r = ceil(BM /
// (chunks + 1)).
template <int D, int NT>
__device__ __forceinline__ void draw_stage(unsigned char* smem, const Tile& tl, int p, int t) {
    using S = Smem<D>;
    if (p < tl.chunks && t < FC / 4) {
        reinterpret_cast<float4*>(smem + S::B1 + (p % S::RING) * S::B1_BYTES)[t] =
            reinterpret_cast<const float4*>(tl.b1 + p * FC)[t];
    }
    const int per = (BM + tl.chunks) / (tl.chunks + 1);
    const int r0 = p * per;
    const int rows = BM - r0 < per ? BM - r0 : per;
    uint8_t* k2 = smem + S::KEEP;
    for (int i = t; i < rows * (D / 8); i += NT) {
        const int r = r0 + i / (D / 8), c8 = 8 * (i % (D / 8));
        k2[r * (D / 8) + c8 / 8] = static_cast<uint8_t>(
            mmd_mlp::keep_byte(tl.m2, static_cast<uint64_t>(tl.row0 + r), D, c8));
    }
}

// a = x w1[:, chunk] for the warpgroup's 64 rows: xa its rows of x, w1s the
// stage's w1.
template <int D>
__device__ __forceinline__ void hidden_product(float (&acc)[32], uint32_t xa, uint32_t w1s) {
    static_for<0, D / 16>([&](auto kt) {
        constexpr int k = decltype(kt)::value;
        mmd_wgmma::wgmma_n64<0, 1>(
            acc, mmd_wgmma::desc_kmajor(xa + (k / 4) * Smem<D>::BLOCK + (k % 4) * 32),
            mmd_wgmma::desc_mnmajor(w1s + k * 16 * 128, FC * 128), k > 0);
    });
}

// y += h w2[chunk, :]: h the chunk's four k16 A fragments, w2s the stage's w2.
template <int D>
__device__ __forceinline__ void output_product(float (&acc)[D / 2], const uint32_t (&h)[4][4],
                                               uint32_t w2s) {
    static_for<0, FC / 16>([&](auto kt) {
        constexpr int k = decltype(kt)::value;
        const uint64_t b = mmd_wgmma::desc_mnmajor(w2s + k * 16 * 128, FC * 128);
        if constexpr (D == 256) {
            mmd_wgmma::wgmma_rs_n256<1>(acc, h[k], b, 1);
        } else {
            mmd_wgmma::wgmma_rs_n128<1>(acc, h[k], b, 1);
        }
    });
}

// The hidden keep bits of the thread's 32 elements of the chunk at column
// c0 (rows r and r + 8, columns 8 j + 2 q + e), bit 4 j + 2 h + e for row r
// + 8 h: the m64n64 accumulator's order. Elements 4 k .. 4 k + 3 of a row
// share one Philox call, and so do lanes q and q ^ 1: the even lane draws
// row r, the odd one row r + 8, and one shuffle swaps the halves.
__device__ __forceinline__ uint32_t hidden_keep(const Mask& m, int64_t row0, int r, int f,
                                                int c0, int q) {
    if (!m.on) return 0xFFFFFFFFu;
    const int odd = q & 1;
    const uint64_t group =
        (static_cast<uint64_t>(row0 + r + 8 * odd) * f + c0 + 4 * (q >> 1)) >> 2;
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {               // columns 8 j .. 8 j + 7
        const uint4 v = mmd_philox::group_bits(m.seed, group + 2 * j);
        const uint32_t t = m.threshold;
        mine |= (static_cast<uint32_t>(v.x < t) | static_cast<uint32_t>(v.y < t) << 1 |
                 static_cast<uint32_t>(v.z < t) << 2 | static_cast<uint32_t>(v.w < t) << 3)
                << (4 * j);
    }
    const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, mine, 1);
    const uint32_t half = odd ? 0xCCCCCCCCu : 0x33333333u;    // this lane's 2 of each 4
    const uint32_t row_r = odd ? other : mine, row_r8 = odd ? mine : other;
    return ((row_r & half) >> (2 * odd)) | ((row_r8 & half) >> (2 * odd)) << 2;
}

// acc = gelu(acc + b1) * m1 in place for the thread's two rows and its 16
// columns of a chunk (the m64n64 accumulator layout); bias1 the chunk's b1,
// keep the elements' keep bits (hidden_keep). GELU is #4's, whose
// derivative goes unused here.
__device__ __forceinline__ void hidden_epilogue(float (&acc)[32], const float* bias1,
                                                uint32_t keep, int q, float scale) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(bias1 + 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float g, dg;
            mmd_mlp::gelu_tanh_and_grad_fast(acc[4 * j + e] + (e & 1 ? bias.y : bias.x), g, dg);
            acc[4 * j + e] = g * ((keep >> (4 * j + e)) & 1u ? scale : 0.f);
        }
    }
}

template <int D>
__device__ __forceinline__ void consume(unsigned char* smem, const bf16* x, const float* b2,
                                        bf16* y, const Tile& tl) {
    using S = Smem<D>;
    constexpr int RING = S::RING;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
    uint64_t* empty = full + RING;
    const int wg = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;    // rows r and r + 8
    const uint32_t xa = smem_addr(smem + S::X) + wg * 64 * 128;
    const uint32_t ring = smem_addr(smem + S::W);

    // x, rows past the end zero
    for (int i = threadIdx.x; i < BM * (D / 8); i += CONSUMERS) {
        const int rr = i / (D / 8), c = 8 * (i % (D / 8));
        const bool ok = rr < tl.valid;
        cp_async16(smem + S::X + kmajor_at(rr, c), ok ? x + (tl.row0 + rr) * D + c : x, ok);
    }

    mmd_tc::cp_async_commit();
    mmd_tc::cp_async_wait<0>();
    fence_async_shared();
    mmd_wgmma::named_sync(1, CONSUMERS);        // x is in, for both warpgroups

    float acc_y[D / 2], acc_a[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_y[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_a[i] = 0.f;
    uint32_t h[4][4];

    mbar_wait(&full[0], 0);
    mmd_wgmma::wgmma_fence();
    hidden_product<D>(acc_a, xa, ring);
    mmd_wgmma::wgmma_commit();
    uint32_t keep = hidden_keep(tl.m1, tl.row0, r, tl.f, 0, q);    // behind the product

    for (int c = 0; c < tl.chunks; ++c) {
        const int slot = c % RING;
        // a of chunk c and y of c - 1: stage c is done with once the
        // epilogue has read its b1
        mmd_wgmma::wgmma_wait<0>();
        fence_operand(acc_a);
        fence_operand(acc_y);
        hidden_epilogue(acc_a,
                        reinterpret_cast<const float*>(smem + S::B1 + slot * S::B1_BYTES),
                        keep, q, tl.m1.scale);
        mbar_arrive(&empty[slot]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                h[t][i] = mmd_tc::pack_bf16x2(acc_a[8 * t + 2 * i], acc_a[8 * t + 2 * i + 1]);
            }

        const int p = c + 1;
        mbar_wait(&full[p % RING], (p / RING) & 1);
        const uint32_t st = ring + (p % RING) * S::STAGE;
        mmd_wgmma::wgmma_fence();
        if (p < tl.chunks) hidden_product<D>(acc_a, xa, st);
        output_product<D>(acc_y, h, st + S::W1_BYTES);
        mmd_wgmma::wgmma_commit();
        if (p < tl.chunks) keep = hidden_keep(tl.m1, tl.row0, r, tl.f, p * FC, q);
    }
    mmd_wgmma::wgmma_wait<0>();
    fence_operand(acc_y);

    // + b2, output dropout, bf16: staged in the warpgroup's own rows of x
    // (its products have retired), then 16 bytes a thread to y
    fence_async_shared();
    const uint8_t* k2 = smem + S::KEEP;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(b2 + 8 * j + 2 * q);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int rr = r + 8 * half;
            const uint32_t bits = k2[rr * (D / 8) + j] >> (2 * q);
            const float v0 = (acc_y[4 * j + 2 * half] + bias.x) * (bits & 1u ? tl.m2.scale : 0.f);
            const float v1 =
                (acc_y[4 * j + 2 * half + 1] + bias.y) * (bits & 2u ? tl.m2.scale : 0.f);
            mmd_tc::store_bf16x2(
                reinterpret_cast<bf16*>(smem + S::X + kmajor_at(rr, 8 * j) + 4 * q), v0, v1);
        }
    }
    mmd_wgmma::named_sync(2 + wg, WG);
    for (int i = threadIdx.x & (WG - 1); i < 64 * (D / 8); i += WG) {
        const int rr = wg * 64 + i / (D / 8), c = 8 * (i % (D / 8));
        if (rr < tl.valid) {
            *reinterpret_cast<uint4*>(y + (tl.row0 + rr) * D + c) =
                *reinterpret_cast<const uint4*>(smem + S::X + kmajor_at(rr, c));
        }
    }
}

// The producer warpgroup, stage p: once both consumers have released its
// slot, one thread starts its loads, and the warpgroup copies b1 and draws
// the output keep bits while they fly.
template <int D>
__device__ __forceinline__ void produce(unsigned char* smem, const CUtensorMap* w1m,
                                        const CUtensorMap* w2m, const Tile& tl) {
    using S = Smem<D>;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
    uint64_t* empty = full + S::RING;
    const int t = threadIdx.x - CONSUMERS;
    for (int p = 0; p <= tl.chunks; ++p) {
        if (p >= S::RING) mbar_wait(&empty[p % S::RING], (p / S::RING - 1) & 1);
        if (t == 0) load_stage<D>(smem, w1m, w2m, tl, p);
        draw_stage<D, WG>(smem, tl, p, t);
        mbar_arrive(&full[p % S::RING]);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap w1_map,
               const float* __restrict__ b1, const __grid_constant__ CUtensorMap w2_map,
               const float* __restrict__ b2, bf16* __restrict__ y, int64_t n, int f, Mask m1,
               Mask m2) {
    using S = Smem<D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = mmd_wgmma::align_1024(smem_raw);
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    const Tile tl{row0, n - row0, f, f / FC, m1, m2, b1};
    if (threadIdx.x == 0) {
        uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
        for (int s = 0; s < S::RING; ++s) {
            mmd_wgmma::mbar_init(&full[s], WG);
            mmd_wgmma::mbar_init(&full[S::RING + s], CONSUMERS);
        }
        mmd_wgmma::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x >= CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
        produce<D>(smem, &w1_map, &w2_map, tl);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    consume<D>(smem, x, b2, y, tl);
}

// -- D above 256: two launches of 128 x 128 tiles ---------------------------------

constexpr int WIDE_SMEM = mmd_mlp_tile::SMEM + mmd_mlp_tile::BT * mmd_mlp_tile::BT / 8;

// One 128 x 128 tile of out (n, cols) = epilogue(a (n, k) b (k, cols) +
// bias) m: HIDDEN, out = h = bf16(gelu(a w1 + b1) m1) (a = x, k = D, cols =
// F); otherwise out = y = bf16((h w2 + b2) m2) (a = h, k = F, cols = D).
// Block t is row tile t / (cols / 128), column tile t % (cols / 128): the
// tiles that read the same rows of a run side by side.
template <bool HIDDEN>
__global__ void __launch_bounds__(mmd_mlp_tile::THREADS, 2)
mlp_fwd_wide_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const float* __restrict__ bias, bf16* __restrict__ out, int64_t n, int k,
                    int cols, Mask m) {
    using namespace mmd_mlp_tile;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = mmd_wgmma::align_1024(smem_raw);
    uint8_t* keep = smem + STAGES * 2 * TILE;              // [BT][BT / 8]
    const int ct = cols / BT;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x / ct) * BT;
    const int c0 = static_cast<int>(blockIdx.x % ct) * BT;
    const int64_t valid = n - row0;
    // the tile's keep bits; product_tile's barriers make them visible
    mmd_mlp::fill_keep<BT, BT>(keep, m, row0, cols, c0);
    float acc[64] = {};
    product_tile<TILE_K_MN>(acc, smem, a + row0 * k, k, b + c0, cols, valid, k / BKW);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int wm = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows of the tile
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(bias + c0 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = wm + g + 8 * half;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float x = acc[4 * j + 2 * half + e] + (e ? bb.y : bb.x);
                const float ks = mmd_mlp::keep_scale<BT>(keep, m, r, col + e);
                if constexpr (HIDDEN) {
                    float gl, dg;
                    mmd_mlp::gelu_tanh_and_grad_fast(x, gl, dg);
                    v[e] = gl * ks;
                } else {
                    v[e] = x * ks;
                }
            }
            if (r < valid) mmd_tc::store_bf16x2(out + (row0 + r) * cols + c0 + col, v[0], v[1]);
        }
    }
}

int64_t wide_workspace_bytes(int64_t n, int d, int f) {
    return d > 256 ? 2 * n * f : 0;
}

cudaError_t launch_wide(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, void* h, int64_t n, int d, int f,
                        const Mask& m1, const Mask& m2, int device, cudaStream_t stream) {
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        cudaError_t err = cudaFuncSetAttribute(
            mlp_fwd_wide_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(mlp_fwd_wide_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
        }
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    constexpr int BT = mmd_mlp_tile::BT;
    const int64_t tiles = (n + BT - 1) / BT;
    mlp_fwd_wide_kernel<true>
        <<<static_cast<unsigned>(tiles * (f / BT)), mmd_mlp_tile::THREADS, WIDE_SMEM, stream>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
            static_cast<const float*>(b1), static_cast<bf16*>(h), n, d, f, m1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlp_fwd_wide_kernel<false>
        <<<static_cast<unsigned>(tiles * (d / BT)), mmd_mlp_tile::THREADS, WIDE_SMEM, stream>>>(
            static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
            static_cast<const float*>(b2), static_cast<bf16*>(y), n, f, d, m2);
    return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda), looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
                cudaSuccess ||
            found != cudaDriverEntryPointSuccess) {
            p = nullptr;
        }
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// The tensor map of a row-major bf16 (rows, cols) matrix read in boxes of
// 64 columns (128 bytes) x box_rows rows, 128-byte swizzled.
cudaError_t box_map(CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
                    int box_rows) {
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t steps[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                  strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
               ? cudaSuccess
               : cudaErrorInvalidValue;
}

// Above 48 KB of dynamic shared memory a kernel has to be allowed it, once
// per device: `raised` holds a bit for each device where that is done.
template <int D>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, int64_t n, int f, const Mask& m1, const Mask& m2,
                   int device, cudaStream_t stream) {
    static std::atomic<uint64_t> raised{0};
    const uint64_t bit = uint64_t{1} << device;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
        const cudaError_t err = cudaFuncSetAttribute(
            mlp_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_relaxed);
    }
    CUtensorMap w1_map, w2_map;
    cudaError_t err = box_map(&w1_map, w1, D, f, D);
    if (err == cudaSuccess) err = box_map(&w2_map, w2, f, D, FC);
    if (err != cudaSuccess) return err;
    mlp_fwd_kernel<D><<<static_cast<unsigned>((n + BM - 1) / BM), THREADS, Smem<D>::BYTES,
                        stream>>>(
        static_cast<const bf16*>(x), w1_map, static_cast<const float*>(b1), w2_map,
        static_cast<const float*>(b2), static_cast<bf16*>(y), n, f, m1, m2);
    return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace mmd_mlp_fwd takes for n rows and widths d, f: the
// (n, f) bf16 h of the two-launch path at d above 256, none at 128 and 256.
extern "C" int64_t mmd_mlp_fwd_workspace(int64_t n, int d, int f) {
    return wide_workspace_bytes(n, d, f);
}

// C entry point, bound with ctypes. x (n, d), w1 (d, f), w2 (f, d) and y
// (n, d) are contiguous bf16; b1 (f,) and b2 (d,) fp32. d is a multiple of
// 128 up to MAX_D, f a multiple of 128; ws a 16-byte aligned workspace of
// mmd_mlp_fwd_workspace(n, d, f) bytes (NULL when that is 0). dropout: 0 =
// none, 1 = the masks of seed1 (hidden) and seed2 (output) with `threshold`
// and `scale`. Returns the cudaError_t of the launches (0 on success).
extern "C" int mmd_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, void* ws, int64_t ws_bytes, int64_t n, int d,
                           int f, uint64_t seed1, uint64_t seed2, uint32_t threshold, float scale,
                           int dropout, int device, void* stream) {
    if (n <= 0 || f <= 0 || f % 128 != 0 || d <= 0 || d % 128 != 0 || d > mmd_mlp::MAX_D ||
        (n + BM - 1) / BM > 0x7FFFFFFF / ((f > d ? f : d) / 128) || device < 0 ||
        device >= 64 || ws_bytes < wide_workspace_bytes(n, d, f)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float s = dropout ? scale : 1.f;
    const Mask m1{seed1, threshold, s, dropout}, m2{seed2, threshold, s, dropout};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 128) return launch<128>(x, w1, b1, w2, b2, y, n, f, m1, m2, device, st);
    if (d == 256) return launch<256>(x, w1, b1, w2, b2, y, n, f, m1, m2, device, st);
    return launch_wide(x, w1, b1, w2, b2, y, ws, n, d, f, m1, m2, device, st);
}
