// TV line resampling, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/tvline.py::_tv_kernel,
// which computes out = X·W0 + frac ⊙ (X·W1) as two [L, W]×[W, px]
// matmuls on the matrix unit.  Column p of W0 holds two non-zeros (rows
// k_p, k_p+1) and of W1 three (k_p .. k_p+2), so each output pixel reads
// three samples of its line:
//
//   a = x[l, k]·W0[k, p] + x[l, k+1]·W0[k+1, p]
//   b = x[l, k]·W1[k, p] + x[l, k+1]·W1[k+1, p] + x[l, k+2]·W1[k+2, p]
//   out[l, p] = a + frac[l]·b
//
// with k = k_p and the five weights read from the host's own W0/W1
// (kernels/tvline.py::pixel_columns), so the weights are the reference's
// numbers; a column with k_p + 2 >= W (k = -1 here) stays zero.
//
// Bound: bytes (the framed columns the pixels touch read once, the
// pixels written once; 10 operations per pixel).  At the decode's shapes
// (~64 lines of 512 samples, 384 pixels) the launch itself is most of
// the time.  Design: one thread per (line, pixel), consecutive threads on
// consecutive pixels, so the table loads and the output stores are
// coalesced and a warp's three line reads fall in a few cache lines; a
// thread loads its pixel's table once and strides over the lines when
// there are more than a grid's 65535 rows.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/tvline.py::tv_kernel_reference.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
tvline(const float* __restrict__ x, const float* __restrict__ frac,
       const int* __restrict__ kcol, const float* __restrict__ taps,
       float* __restrict__ out, int L, int W, int P) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const int k = kcol[p];
    if (k < 0) {
        for (int l = blockIdx.y; l < L; l += gridDim.y)
            out[(size_t)l * P + p] = 0.0f;
        return;
    }
    const float t0 = taps[p], t1 = taps[P + p], t2 = taps[2 * P + p],
                t3 = taps[3 * P + p], t4 = taps[4 * P + p];
    for (int l = blockIdx.y; l < L; l += gridDim.y) {
        const float* row = x + (size_t)l * W + k;
        const float x0 = row[0], x1 = row[1], x2 = row[2];
        const float a = x0 * t0 + x1 * t1;
        const float b = x0 * t2 + x1 * t3 + x2 * t4;
        out[(size_t)l * P + p] = a + frac[l] * b;
    }
}

}  // namespace

// Resample the float32 lines x [L, W] with per-line offsets frac [L]
// through the per-pixel table (kcol [P] int32, taps [5, P] float32) into
// out [L, P].  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sd_tvline(const float* x, const float* frac, const int* kcol,
                         const float* taps, float* out, int L, int W, int P,
                         void* stream) {
    if (L < 1 || W < 3 || P < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 block(128);
    const dim3 grid((P + 127) / 128, L < 65535 ? L : 65535);
    tvline<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        x, frac, kcol, taps, out, L, W, P);
    return static_cast<int>(cudaGetLastError());
}
