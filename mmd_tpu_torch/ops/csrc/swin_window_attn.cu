// Swinv2 cosine window attention, serving forward, for Hopper (sm_90a).
//
// Replaces mmd_tpu/ops/swin_attention.py::swin_window_attention_infer (its
// Pallas body _infer_kernel) on the Swinv2 serving path: the window
// attention of every one of Swinv2-base's 24 blocks.
//
// What it computes, per window w, batch row b and head h, on the RAW
// post-projection q, k, v (window-major (nW, B, n, C), C = heads * dh):
//   q^ = q / max(|q|, 1e-12),  k^ = k / max(|k|, 1e-12)      per head, fp32
//   s[i, j] = (q^_i . k^_j) * scale[h] + bias[w, h, i, j]      natural log
//   o_i = sum_j exp(s[i, j] - m_i) v_j / max(sum_j exp(s[i, j] - m_i), 1e-37)
// scale[h] is the clamped logit scale exp(min(logit_scale_h, ln 100)); bias
// is fp32 (nWb, heads, n, n) with nWb = nW (the continuous position bias
// plus twice the shifted-window mask) or nWb = 1 (no shift: one bias for
// every window). The TPU kernel takes its bias and scale in the log2
// domain and rounds the squares to the input dtype before the norms; this
// kernel takes natural-log inputs and keeps the norms in fp32.
//
// What bounds it on this card: bytes. Per (window, batch row, head) it
// reads three 64 x dh tiles and writes one, against 4 * 64 * 64 * dh
// operations: 32 operations per bf16 byte of q/k/v/o, well below the ~295
// where the tensor cores would be the limit. The bias is shared by the
// batch rows of a window.
//
// What the design does about that: it runs the fine-tuning forward's body
// (swin_fwd.cuh, Inputs::kRaw) -- every product on the tensor cores, one
// CTA of 4 warps per (head, window, group of batch rows), the group from
// swin_attention.py::batch_groups, the bias tile read once per CTA into
// registers (natural log to log2 on the way), q, k and v double-buffered
// by cp.async -- with the cosine normalization and the logit scale folded
// into the scores, so q and k are read once, as they are, and nothing of
// the normalization goes through device memory or shared memory.
//
// Windows of n = 64 T tokens, T > 1 (16 x 16 and 24 x 24 windows), run
// swin_attn_blocked_kernel over the same file's blocked body
// (mmd_swin::forward_blocked): a CTA a (query tile, head, window, group),
// the keys walked in blocks of 64 with an online softmax, the bias read a
// block at a time. Its bound: 4 n^2 dh operations against the 8 n dh bytes
// of bf16 q/k/v/o is n / 2 operations a byte -- 128 at n 256, under the
// ~295 where the tensor cores would be the limit, 288 at n 576, at it --
// beside the bias, n^2 fp32 a (window, head), shared by the batch rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "swin_fwd.cuh"

namespace {

namespace F = mmd_flash;
namespace S = mmd_swin;

template <typename T, int DH>
__global__ void __launch_bounds__(F::THREADS)
swin_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ scale,
                 T* __restrict__ o, int batch, int heads, int bias_windows, int per_group) {
    S::forward<T, DH, S::Inputs::kRaw>(q, k, v, bias, scale, o, batch, heads, bias_windows == 1,
                                       per_group);
}

template <typename T, int DH>
__global__ void __launch_bounds__(F::THREADS)
swin_attn_blocked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ scale, T* __restrict__ o, int batch, int heads,
                         int n, int bias_windows, int per_group) {
    S::forward_blocked<T, DH, S::Inputs::kRaw>(q, k, v, bias, scale, o, batch, heads, n,
                                               bias_windows == 1, per_group);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* scale, void* o, int windows, int batch, int n, int heads,
                   int bias_windows, int groups, int device, cudaStream_t stream) {
    if (n != S::N) {
        constexpr size_t smem = S::blocked_fwd_smem_bytes<T, DH>();
        static std::atomic<uint64_t> raised{0};
        cudaError_t err = S::allow_smem(swin_attn_blocked_kernel<T, DH>, smem, device, raised);
        if (err != cudaSuccess) return err;
        swin_attn_blocked_kernel<T, DH>
            <<<dim3(heads * (n / S::N), windows, groups), F::THREADS, smem, stream>>>(
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const float*>(bias), static_cast<const float*>(scale),
                static_cast<T*>(o), batch, heads, n, bias_windows, batch / groups);
        return cudaGetLastError();
    }
    constexpr size_t smem = S::fwd_smem_bytes<T, DH>();
    static std::atomic<uint64_t> raised{0};
    cudaError_t err = S::allow_smem(swin_attn_kernel<T, DH>, smem, device, raised);
    if (err != cudaSuccess) return err;
    swin_attn_kernel<T, DH><<<dim3(heads, windows, groups), F::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(scale), static_cast<T*>(o),
        batch, heads, bias_windows, batch / groups);
    return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, o are (windows, batch, n,
// heads * head_dim) contiguous with n = 64 T (T >= 1), bias (bias_windows,
// heads, n, n) fp32 with bias_windows 1 or windows, scale (heads,) fp32;
// groups divides batch.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int mmd_swin_window_attn_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* scale, void* o,
                                        int windows, int batch, int n, int heads,
                                        int head_dim, int bias_windows, int groups, int dtype,
                                        int device, void* stream) {
    cudaError_t err = S::enter(windows, batch, n, heads, groups, device);
    if (err == cudaSuccess && bias_windows != 1 && bias_windows != windows)
        err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && head_dim == 32)
        return launch<float, 32>(q, k, v, bias, scale, o, windows, batch, n, heads,
                                 bias_windows, groups, device, st);
    if (dtype == 0 && head_dim == 64)
        return launch<float, 64>(q, k, v, bias, scale, o, windows, batch, n, heads,
                                 bias_windows, groups, device, st);
    if (dtype == 1 && head_dim == 32)
        return launch<__nv_bfloat16, 32>(q, k, v, bias, scale, o, windows, batch, n,
                                         heads, bias_windows, groups, device, st);
    if (dtype == 1 && head_dim == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, bias, scale, o, windows, batch, n,
                                         heads, bias_windows, groups, device, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
