// TV line resampling, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/tvline.py::_tv_kernel,
// which computes out = X·W0 + frac ⊙ (X·W1) as two [L, W]×[W, px]
// matmuls on the matrix unit, X the block's line windows framed on the
// host.  Column p of W0 holds two non-zeros (rows k_p, k_p+1) and of W1
// three (k_p .. k_p+2), so each output pixel reads three samples of its
// line's window, and a window is only an address into the block's
// samples v [n]: X[l, k] = v[clip(start_l + k, 0, n − 1)], the host's
// own clip.  So the kernel reads v directly:
//
//   x_j = v[clip(start_l + k + j, 0, n − 1)],  j = 0, 1, 2
//   a = x_0·W0[k, p] + x_1·W0[k+1, p]
//   b = x_0·W1[k, p] + x_1·W1[k+1, p] + x_2·W1[k+2, p]
//   out[l, p] = a + frac[l]·b
//
// with k = k_p and the five weights read from the host's own W0/W1
// (kernels/tvline.py::pixel_columns), so the weights are the reference's
// numbers; a column with k_p + 2 >= W (k = -1 here) stays zero.  A framed
// [L, W] matrix is the same call with v = X flattened and start_l = l·W
// (starts == nullptr): k + 2 < W, so no read crosses a row.
//
// Bound: bytes (the samples the lines' pixels touch read once, the
// pixels written once; 10 operations per pixel).  At the decode's shapes
// (~64 lines, 384 pixels) the launch itself is most of the time.
// Design: one thread per (line, pixel), consecutive threads on
// consecutive pixels, so the table loads and the output stores are
// coalesced and a warp's three line reads fall in a few cache lines; a
// thread loads its pixel's table once and strides over the lines when
// there are more than a grid's 65535 rows.  One body serves both forms:
// the clip is a no-op inside a framed row.  The launch is latency-bound,
// so each thread loads its first line's start and offset ahead of its
// pixel's column: loaded after the column's branch, the start put a
// third round trip before the sample loads, and the stream form traced
// slower than the framed one.  The plain PyTorch versions are
// sigdigger_tpu_torch/kernels/tvline.py::tv_kernel_reference and
// tv_stream_reference.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
tvline(const float* __restrict__ v, int n, const int* __restrict__ starts,
       const float* __restrict__ frac, const int* __restrict__ kcol,
       const float* __restrict__ taps, float* __restrict__ out, int L, int W,
       int P) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int l = blockIdx.y;
    long long s = starts ? (long long)__ldg(starts + l) : (long long)l * W;
    float fr = __ldg(frac + l);
    const int k = kcol[p];
    if (k < 0) {
        for (; l < L; l += gridDim.y) out[(size_t)l * P + p] = 0.0f;
        return;
    }
    const float t0 = taps[p], t1 = taps[P + p], t2 = taps[2 * P + p],
                t3 = taps[3 * P + p], t4 = taps[4 * P + p];
    const long long last = n - 1;
    for (;;) {
        const long long i = s + k;
        const float x0 = __ldg(v + max(0LL, min(i, last)));
        const float x1 = __ldg(v + max(0LL, min(i + 1, last)));
        const float x2 = __ldg(v + max(0LL, min(i + 2, last)));
        const float a = x0 * t0 + x1 * t1;
        const float b = x0 * t2 + x1 * t3 + x2 * t4;
        out[(size_t)l * P + p] = a + fr * b;
        l += gridDim.y;
        if (l >= L) break;
        s = starts ? (long long)__ldg(starts + l) : (long long)l * W;
        fr = __ldg(frac + l);
    }
}

}  // namespace

// Resample L lines of the float32 samples v [n], line l's window starting
// at starts[l] (int32 [L]; nullptr: v is a framed [L, W] matrix and line
// l starts at l·W), with per-line offsets frac [L], through the per-pixel
// table (kcol [P] int32, taps [5, P] float32) into out [L, P].  Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int sd_tvline(const float* v, int n, const int* starts,
                         const float* frac, const int* kcol,
                         const float* taps, float* out, int L, int W, int P,
                         void* stream) {
    if (L < 1 || n < 1 || W < 3 || P < 1 ||
        (starts == nullptr && (long long)L * W > n))
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(128);
    const dim3 grid((P + 127) / 128, L < 65535 ? L : 65535);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    tvline<<<grid, block, 0, s>>>(v, n, starts, frac, kcol, taps, out, L,
                                  W, P);
    return static_cast<int>(cudaGetLastError());
}
