// (Residual +) LayerNorm forward for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/ln.py::_ln_pallas (its Pallas bodies _ln_kernel and
// _ln_res_kernel) on the Swinv2 serving path: the patch-embedding norm, the
// two post-norms of every block (with the residual shortcut), the norm after
// each patch merge, and the final norm -- 53 calls per Swinv2-base forward.
//
// What it computes, per row of a (rows, C) tensor y:
//   mean = sum(y) / C,  var = sum((y - mean)^2) / C     (fp32, two passes)
//   out  = (y - mean) * rsqrt(var + eps) * scale + bias (+ shortcut)
// in fp32, cast once to y's dtype. The shortcut, when given, has y's shape
// and dtype and is added in fp32 before that one cast. scale and bias are
// fp32 (C,).
//
// What bounds it on this card: bytes. It reads y (and the shortcut) once and
// writes out once, ~10 operations per element: 2 or 3 tensors x rows x C x
// itemsize over 3.35 TB/s, far below the ~295 operations per byte where
// arithmetic would take over. At a served batch's geometries a call moves
// 4-50 MB, 1.3-15 us at that rate, so a call is also paced by how soon its
// loads are in flight and how many stay in flight (Little's law: ~20 KB an
// SM at ~0.7 us of memory latency).
//
// What the design does about that:
//   * each warp streams its own row tiles (RG x RPW rows, ~2 KB of y)
//     through its own ring of 2-4 stages in shared memory: lane 0 moves a
//     tile of the contiguous (rows, C) tensor, one byte range, with one
//     bulk copy (cp.async.bulk, the TMA's 1-D form), and the shortcut's
//     tile with a second into the same stage; both complete on the stage's
//     mbarrier, so y and the shortcut arrive together, and the next tiles
//     stay in flight while the warp reduces this one. A warp refills a
//     stage once all its lanes have read it (__syncwarp, then a proxy
//     fence), so no warp waits on another. The last tile is ragged: its
//     copies and its expected bytes count only the rows it has;
//   * persistent blocks of 8 warps (as many as the card holds at once, no
//     more than the tiles need) walk the tiles with a grid stride, one warp
//     a tile at a time: small tiles keep the walk even at every size;
//   * the kernel is specialised by C (CH = C / 128): a row is NCH 16-byte
//     chunks, read by LPR lanes (16 where NCH is an odd multiple of 16, as
//     at C 128 in bf16, else 32), so a warp takes RPW = 32 / LPR rows at
//     once and no lane idles; each lane holds PER = NCH / LPR chunks of a
//     row, the arrays are exact and no guard is left in the loops. Lanes
//     read neighbouring chunks, a quarter-warp 128 contiguous bytes of
//     shared memory (no bank conflict), and store 16 bytes at a time
//     straight from registers;
//   * scale and bias are read once per block into the registers of the
//     lanes that own those columns (a lane always owns the same columns);
//   * statistics in fp32, two passes over registers: each lane sums its
//     chunks in order, then a butterfly over the row's lanes gives every
//     lane the same sum; no atomics, so repeated calls give the same bits.
//
// tests/test_torch_ln_mirror.py mirrors the order of work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"                         // mbarriers

namespace {

using mmd_wgmma::fence_async_shared;
using mmd_wgmma::mbar_arrive;
using mmd_wgmma::mbar_expect_tx;
using mmd_wgmma::mbar_init;
using mmd_wgmma::mbar_init_fence;
using mmd_wgmma::mbar_wait;

// The kernel names a minimum of 1 block an SM in its launch bounds:
// without it ptxas held the C 512 ring to the 80 registers at which three
// blocks fit (the rings' shared memory allows two) and spilled.
constexpr int WARPS = 8;                     // warps a block
constexpr int MAX_C = 1024;
constexpr int TILE_TARGET = 2 * 1024;        // bytes of one tensor's tile
constexpr int RING_TARGET = 96 * 1024;       // bytes of a block's rings
constexpr int MAX_DEVICES = 64;

// The shape of the work at C = 128 CH for element type T.
template <typename T, int CH>
struct Geo {
    static constexpr int C = 128 * CH;
    static constexpr int V = 16 / sizeof(T);               // values a chunk
    static constexpr int ROW_BYTES = C * static_cast<int>(sizeof(T));
    static constexpr int NCH = ROW_BYTES / 16;             // chunks a row
    static constexpr int LPR = NCH % 32 == 0 ? 32 : 16;    // lanes a row
    static constexpr int RPW = 32 / LPR;                   // rows a warp at once
    static constexpr int PER = NCH / LPR;                  // chunks a lane
    static constexpr int RG_FIT = TILE_TARGET / (RPW * ROW_BYTES);
    static constexpr int RG = RG_FIT > 0 ? RG_FIT : 1;     // row groups a tile
    static constexpr int TR = RPW * RG;                    // rows a tile
    static constexpr int TILE = TR * ROW_BYTES;            // bytes of a tensor's tile
    static_assert(NCH % LPR == 0 && TILE % 128 == 0, "C must be a multiple of 128");
};

// A warp's ring: a stage holds y's tile and, with a shortcut, the shortcut's.
template <typename T, int CH, bool RES>
struct Ring {
    static constexpr int STAGE = Geo<T, CH>::TILE * (RES ? 2 : 1);
    static constexpr int FIT = RING_TARGET / (WARPS * STAGE);
    static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
    static constexpr size_t SMEM =
        static_cast<size_t>(WARPS) * STAGES * (STAGE + sizeof(uint64_t));
};

// -- 16-byte chunks -----------------------------------------------------------------

__device__ __forceinline__ void unpack(const uint4& u, float (&out)[4]) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&out)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ uint4 pack(const float (&in)[4]) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
}

__device__ __forceinline__ uint4 pack(const float (&in)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return u;
}

// `bytes` (a multiple of 16) from global memory to shared memory by the
// TMA, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(mmd_tc::smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(mmd_tc::smem_addr(bar))
        : "memory");
}

// -- the rows ------------------------------------------------------------------------

// The columns of scale and bias that lane `sub` of a row owns: chunks
// i LPR + sub, i < PER.
template <typename T, int CH>
struct Params {
    using G = Geo<T, CH>;
    float sc[G::PER][G::V], bs[G::PER][G::V];

    __device__ __forceinline__ void load(const float* scale, const float* bias, int sub) {
#pragma unroll
        for (int i = 0; i < G::PER; ++i) {
            const int col = (i * G::LPR + sub) * G::V;
#pragma unroll
            for (int e = 0; e < G::V; e += 4) {
                const float4 s = *reinterpret_cast<const float4*>(scale + col + e);
                const float4 b = *reinterpret_cast<const float4*>(bias + col + e);
                sc[i][e] = s.x, sc[i][e + 1] = s.y, sc[i][e + 2] = s.z, sc[i][e + 3] = s.w;
                bs[i][e] = b.x, bs[i][e + 1] = b.y, bs[i][e + 2] = b.z, bs[i][e + 3] = b.w;
            }
        }
    }
};

// Sum over the LPR lanes of a row (offsets LPR / 2 .. 1: the two rows of a
// warp at LPR 16 stay apart); every lane of the row ends with the same sum.
template <int LPR, int N>
__device__ __forceinline__ void row_sum(float (&x)[N]) {
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < N; ++g) x[g] += __shfl_xor_sync(0xffffffffu, x[g], off);
    }
}

// A warp's tile: row group g is the tile's row g RPW + lane / LPR, of
// which lane sub = lane % LPR holds chunks i LPR + sub. yt and xt point at
// the tile's y and shortcut in the ring's stage, ot at its first output
// row; rows from `valid` on are neither read nor written. y's chunks stay
// in registers as loaded (16 bytes each) through the two statistics
// passes; the output pass reads y and the shortcut again from shared
// memory, which spares the registers (scale and bias take 2 PER V of them).
template <typename T, int CH, bool RES>
__device__ __forceinline__ void norm_rows(const T* yt, const T* xt, T* ot, int valid,
                                          const Params<T, CH>& p, float eps, int lane) {
    using G = Geo<T, CH>;
    const int sub = lane % G::LPR;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    int row[G::RG];
    int off[G::RG][G::PER];                  // of each chunk, from the tile's start
#pragma unroll
    for (int g = 0; g < G::RG; ++g) {
        row[g] = g * G::RPW + lane / G::LPR;
#pragma unroll
        for (int i = 0; i < G::PER; ++i) off[g][i] = row[g] * G::C + (i * G::LPR + sub) * G::V;
    }
    uint4 yr[G::RG][G::PER];
    // every load of the tile first
#pragma unroll
    for (int g = 0; g < G::RG; ++g) {
#pragma unroll
        for (int i = 0; i < G::PER; ++i) {
            yr[g][i] = row[g] < valid ? *reinterpret_cast<const uint4*>(yt + off[g][i]) : zero;
        }
    }
    float mean[G::RG], rstd[G::RG];
#pragma unroll
    for (int g = 0; g < G::RG; ++g) {
        mean[g] = 0.f;
#pragma unroll
        for (int i = 0; i < G::PER; ++i) {
            float v[G::V];
            unpack(yr[g][i], v);
#pragma unroll
            for (int e = 0; e < G::V; ++e) mean[g] += v[e];
        }
    }
    row_sum<G::LPR>(mean);
#pragma unroll
    for (int g = 0; g < G::RG; ++g) {
        mean[g] = mean[g] / static_cast<float>(G::C);
        rstd[g] = 0.f;
#pragma unroll
        for (int i = 0; i < G::PER; ++i) {
            float v[G::V];
            unpack(yr[g][i], v);
#pragma unroll
            for (int e = 0; e < G::V; ++e) {
                const float d = v[e] - mean[g];
                rstd[g] += d * d;
            }
        }
    }
    row_sum<G::LPR>(rstd);
#pragma unroll
    for (int g = 0; g < G::RG; ++g) {
        rstd[g] = rsqrtf(rstd[g] / static_cast<float>(G::C) + eps);
        if (row[g] >= valid) continue;
#pragma unroll
        for (int i = 0; i < G::PER; ++i) {
            float v[G::V], res[G::V], o[G::V];
            unpack(*reinterpret_cast<const uint4*>(yt + off[g][i]), v);
            if constexpr (RES) unpack(*reinterpret_cast<const uint4*>(xt + off[g][i]), res);
#pragma unroll
            for (int e = 0; e < G::V; ++e) {
                o[e] = (v[e] - mean[g]) * rstd[g] * p.sc[i][e] + p.bs[i][e];
                if constexpr (RES) o[e] += res[e];
            }
            *reinterpret_cast<uint4*>(ot + off[g][i]) = pack(o);
        }
    }
}

// -- the kernel ----------------------------------------------------------------------

// Lane 0 of a warp: tile t of y (and the shortcut) into `stage`, counted
// on `bar`; a ragged last tile's copies and bytes count only its rows.
template <typename T, int CH, bool RES>
__device__ __forceinline__ void fill(unsigned char* stage, uint64_t* bar, const T* y,
                                     const T* x, int t, int rows) {
    using G = Geo<T, CH>;
    const int r0 = t * G::TR;
    const uint32_t bytes = static_cast<uint32_t>(min(G::TR, rows - r0)) * G::ROW_BYTES;
    const size_t at = static_cast<size_t>(r0) * G::C;
    mbar_expect_tx(bar, RES ? 2 * bytes : bytes);
    bulk_load(stage, y + at, bytes, bar);
    if constexpr (RES) bulk_load(stage + G::TILE, x + at, bytes, bar);
    mbar_arrive(bar);
}

// The ring: the warp's k-th tile (tile (blockIdx.x WARPS + warp) +
// k gridDim.x WARPS) goes through stage k % STAGES; lane 0 fills the first
// STAGES stages at once, then refills a stage as soon as the warp has read
// it, and every lane waits for a stage's fill number k / STAGES (parity
// (k / STAGES) & 1).
template <typename T, int CH, bool RES>
__global__ void __launch_bounds__(WARPS * 32, 1)
ln_kernel(const T* __restrict__ y, const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, T* __restrict__ out, int rows, float eps) {
    using G = Geo<T, CH>;
    using R = Ring<T, CH, RES>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned char* ring = smem + warp * R::STAGES * R::STAGE;
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + WARPS * R::STAGES * R::STAGE) + warp * R::STAGES;
    const int tiles = (rows + G::TR - 1) / G::TR;
    const int stride = gridDim.x * WARPS;
    const int first = blockIdx.x * WARPS + warp;
    if (lane == 0) {
#pragma unroll
        for (int s = 0; s < R::STAGES; ++s) mbar_init(&full[s], 1);
        mbar_init_fence();
#pragma unroll
        for (int s = 0; s < R::STAGES; ++s) {
            if (first + s * stride < tiles) {
                fill<T, CH, RES>(ring + s * R::STAGE, &full[s], y, x, first + s * stride, rows);
            }
        }
    }
    __syncwarp();

    Params<T, CH> p;
    p.load(scale, bias, lane % G::LPR);
    int k = 0;
    for (int t = first; t < tiles; t += stride, ++k) {
        const int s = k % R::STAGES;
        mbar_wait(&full[s], (k / R::STAGES) & 1);
        const T* yt = reinterpret_cast<const T*>(ring + s * R::STAGE);
        norm_rows<T, CH, RES>(yt, yt + G::TR * G::C, out + static_cast<size_t>(t) * G::TR * G::C,
                              min(G::TR, rows - t * G::TR), p, eps, lane);
        __syncwarp();                        // every lane has read the stage
        const int next = t + R::STAGES * stride;
        if (lane == 0 && next < tiles) {
            fence_async_shared();            // those reads before the async proxy's writes
            fill<T, CH, RES>(ring + s * R::STAGE, &full[s], y, x, next, rows);
        }
    }
}

// -- launch --------------------------------------------------------------------------

struct Args {
    const void* y;
    const void* x;                           // the shortcut, or null
    const float* scale;
    const float* bias;
    void* out;
    int rows;
    float eps;
    int device;
    cudaStream_t stream;
};

// The grid: as many blocks as the card holds at once (found once a device
// for each build, after allowing it its shared memory), no more than give
// each warp a tile.
template <typename T, int CH, bool RES>
cudaError_t launch(const Args& a) {
    using G = Geo<T, CH>;
    constexpr int threads = WARPS * 32;
    constexpr size_t smem = Ring<T, CH, RES>::SMEM;
    auto kernel = ln_kernel<T, CH, RES>;
    static std::atomic<int> resident[MAX_DEVICES];
    int cap = resident[a.device].load(std::memory_order_relaxed);
    if (cap == 0) {
        cudaError_t err = cudaSuccess;
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
        }
        int per_sm = 0, sms = 0;
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        }
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
        if (err != cudaSuccess) return err;
        if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
        cap = per_sm * sms;
        resident[a.device].store(cap, std::memory_order_relaxed);
    }
    const int blocks = (a.rows + WARPS * G::TR - 1) / (WARPS * G::TR);
    kernel<<<blocks < cap ? blocks : cap, threads, smem, a.stream>>>(
        static_cast<const T*>(a.y), static_cast<const T*>(a.x), a.scale, a.bias,
        static_cast<T*>(a.out), a.rows, a.eps);
    return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t by_width(int ch, const Args& a) {
    switch (ch) {
        case 1: return launch<T, 1, RES>(a);
        case 2: return launch<T, 2, RES>(a);
        case 3: return launch<T, 3, RES>(a);
        case 4: return launch<T, 4, RES>(a);
        case 5: return launch<T, 5, RES>(a);
        case 6: return launch<T, 6, RES>(a);
        case 7: return launch<T, 7, RES>(a);
        case 8: return launch<T, 8, RES>(a);
        default: return cudaErrorInvalidValue;
    }
}

int run(const void* y, const void* shortcut, const void* scale, const void* bias, void* out,
        int rows, int c, float eps, int dtype, int device, void* stream) {
    if (rows <= 0 || c <= 0 || c % 128 != 0 || c > MAX_C || device < 0 ||
        device >= MAX_DEVICES) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Args a{y, shortcut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                 out, rows, eps, device, static_cast<cudaStream_t>(stream)};
    const int ch = c / 128;
    const bool res = shortcut != nullptr;
    if (dtype == 0) {
        err = res ? by_width<float, true>(ch, a) : by_width<float, false>(ch, a);
    } else if (dtype == 1) {
        err = res ? by_width<__nv_bfloat16, true>(ch, a) : by_width<__nv_bfloat16, false>(ch, a);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // namespace

// The C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// shortcut is NULL for the plain LayerNorm. All pointers 16-byte aligned,
// every tensor contiguous. `device` is made current only if it is not
// already. Returns the cudaError_t of the launch.
extern "C" int mmd_layernorm_fwd(const void* y, const void* shortcut, const void* scale,
                                 const void* bias, void* out, int rows, int c, float eps,
                                 int dtype, int device, void* stream) {
    return run(y, shortcut, scale, bias, out, rows, c, eps, dtype, device, stream);
}
