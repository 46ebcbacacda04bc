// Column compactor for bank drains, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/compact.py::_compact_kernel.
// The TPU kernel selects the active columns with a one-hot matmul
// X[M, C]·S[C, W] accumulated over channel tiles, because its toolchain
// has no gather.  Here each output element is one gathered load:
//
//   out[(mi·n + p)·mt + r, w] = store_p(X_p[mi·mt + r, slots[w]])
//
// for tile mi, plane p < n and row r < mt, and 0 where slots[w] < 0.
// store_p writes float32, bfloat16 (__float2bfloat16_rn: round to nearest
// even, as astype(bfloat16)), or int16 as clip(v·scale_p, -32768, 32767)
// truncated toward zero (__float2int_rz, as a float32 to int16 astype).
//
// Bound: bytes.  Each mapped column of each plane read once and the
// interleaved [n·M, W] output written once, no arithmetic to speak of.
// Design: a 32 x 8 thread block per 32 output columns x 8 rows of one
// plane (blockIdx.z), consecutive threads on consecutive output columns,
// so the writes are coalesced and the reads are too wherever the map is
// monotonic (the engine's active slots are sorted).  Rows stride over the
// grid so any M fits.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/compact.py::compact_kernel_reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANES = 4;

// One plane per blockIdx.z: the plane pointer and scale are uniform in a
// block and picked with selects, so the kernel indexes no array of
// parameters (a dynamically indexed parameter array lands in local
// memory).
template <int KIND>
__global__ void __launch_bounds__(256)
compact(const float* __restrict__ x0, const float* __restrict__ x1,
        const float* __restrict__ x2, const float* __restrict__ x3, float s0,
        float s1, float s2, float s3, const int* __restrict__ slots,
        void* __restrict__ out, int n, int M, int C, int W, int mt) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    const int p = blockIdx.z;
    const float* __restrict__ x = p == 0 ? x0 : p == 1 ? x1 : p == 2 ? x2 : x3;
    const float scale = p == 0 ? s0 : p == 1 ? s1 : p == 2 ? s2 : s3;
    const int col = slots[w];
    for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < M;
         r += gridDim.y * blockDim.y) {
        const int mi = r / mt;
        const size_t at = ((size_t)(mi * n + p) * mt + (r - mi * mt)) * W + w;
        const float v = col >= 0 ? x[(size_t)r * C + col] : 0.0f;
        if (KIND == 0) {
            static_cast<float*>(out)[at] = v;
        } else if (KIND == 1) {
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
        } else {
            const float q = fminf(fmaxf(v * scale, -32768.0f), 32767.0f);
            static_cast<int16_t*>(out)[at] =
                static_cast<int16_t>(__float2int_rz(q));
        }
    }
}

}  // namespace

// One compaction of n (1..4) float32 planes x0..x{n-1} [M, C] (unused
// pointers null) through slots int32 [W] (-1: empty column) into out
// [n·M, W]: out_kind 0 float32, 1 bfloat16, 2 int16 with the per-plane
// scales s0..s3.  Needs mt | M.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sd_compact(const float* x0, const float* x1, const float* x2,
                          const float* x3, int n, const int* slots, void* out,
                          int out_kind, float s0, float s1, float s2,
                          float s3, int M, int C, int W, int mt,
                          void* stream) {
    if (n < 1 || n > MAX_PLANES || M < 1 || C < 1 || W < 1 || mt < 1 ||
        M % mt)
        return static_cast<int>(cudaErrorInvalidValue);
    const float* xs[MAX_PLANES] = {x0, x1, x2, x3};
    for (int p = 0; p < n; ++p)
        if (xs[p] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(32, 8);
    const int row_blocks = (M + 7) / 8;
    const dim3 grid((W + 31) / 32, row_blocks < 65535 ? row_blocks : 65535,
                    n);
    switch (out_kind) {
    case 0:
        compact<0><<<grid, block, 0, s>>>(x0, x1, x2, x3, s0, s1, s2, s3,
                                          slots, out, n, M, C, W, mt);
        break;
    case 1:
        compact<1><<<grid, block, 0, s>>>(x0, x1, x2, x3, s0, s1, s2, s3,
                                          slots, out, n, M, C, W, mt);
        break;
    case 2:
        compact<2><<<grid, block, 0, s>>>(x0, x1, x2, x3, s0, s1, s2, s3,
                                          slots, out, n, M, C, W, mt);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
