// Counter-based random bits for the port's dropout masks: Philox4x32-10
// (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011;
// the Random123 constants and round function).
//
// Every mask bit of the port is a pure function of (64-bit seed, absolute
// element index): element i takes lane (i & 3) of philox4x32_10(counter =
// (i >> 2) as two 32-bit words, 0, 0; key = the seed's two 32-bit words).
// A forward and its backward therefore regenerate the same mask whatever
// their tiling, and ops/dropout.py::philox4x32 computes the same bits in
// plain PyTorch. This replaces the TPU's on-chip PRNG and its strip seeding
// (mmd_tpu/ops/attention.py::_strip_keep), which existed only to make two
// different tilings agree.
//
// An element is kept when its 32 bits are below
// min(int((1 - rate) * 2^32), 2^32 - 1), the TPU kernels' threshold; the
// wrappers compute it in Python and pass it in.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmd_philox {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t lo0 = 0xD2511F53u * c.x;
        const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
        const uint32_t lo1 = 0xCD9E8D57u * c.z;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
        c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    }
    return c;
}

// The 32-bit draws of elements 4 * group .. 4 * group + 3.
__device__ __forceinline__ uint4 group_bits(uint64_t seed, uint64_t group) {
    return philox4x32_10(
        make_uint4(static_cast<uint32_t>(group), static_cast<uint32_t>(group >> 32), 0u, 0u),
        static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

__device__ __forceinline__ uint32_t lane(const uint4& r, int i) {
    return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

// The 32-bit draw of element `idx`.
__device__ __forceinline__ uint32_t element_bits(uint64_t seed, uint64_t idx) {
    return lane(group_bits(seed, idx >> 2), static_cast<int>(idx & 3));
}

struct Dropout {
    uint64_t seed;
    uint32_t threshold;                      // keep when the draw is below it
    float scale;                             // 1 / (1 - rate)
};

// Attention dropout: keep[r * STRIDE + j] = 1 when weight (row t0 + r, key
// s0 + j) of head (b, h) is kept; the weights' row-major index runs over
// (B, H, T, S). One Philox call covers 4 keys of a row when the index of the
// first is a multiple of 4 (always, when S % 4 == 0). Rows past T are left
// unset: nothing reads them. STRIDE is a multiple of 4 bytes.
template <int ROWS, int KEYS, int STRIDE>
__device__ __forceinline__ void fill_keep_tile(uint8_t* keep, int tid, int nthreads,
                                               int b, int h, int num_heads, int t0,
                                               int t_len, int s0, int s_len,
                                               const Dropout& dp) {
    static_assert(KEYS % 4 == 0 && STRIDE % 4 == 0, "keep tiles pack 4 keys a word");
    constexpr int QUADS = KEYS / 4;
    for (int gi = tid; gi < ROWS * QUADS; gi += nthreads) {
        const int r = gi / QUADS;
        const int q4 = gi % QUADS;
        const int t = t0 + r;
        if (t >= t_len) continue;
        const uint64_t flat =
            ((static_cast<uint64_t>(b) * num_heads + h) * t_len + t) * s_len + s0 + 4 * q4;
        uint32_t bits[4];
        if ((flat & 3) == 0) {
            const uint4 g = group_bits(dp.seed, flat >> 2);
            bits[0] = g.x; bits[1] = g.y; bits[2] = g.z; bits[3] = g.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) bits[e] = element_bits(dp.seed, flat + e);
        }
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) packed |= static_cast<uint32_t>(bits[e] < dp.threshold) << (8 * e);
        *reinterpret_cast<uint32_t*>(keep + r * STRIDE + 4 * q4) = packed;
    }
}

}  // namespace mmd_philox
