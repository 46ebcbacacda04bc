// Four-step (Bailey) PSD stages shared by the fused FM kernel
// (channelizer2.cu), the standalone PSD kernel (psd.cu) and the PSD read
// from the channelizer's window buffer (psd_xw.cu).
//
// An N-point DFT with N = A·B is a DFT_A down the columns of the frame
// laid out as x[a][b] = x[a·B + b], a twiddle W_N^{k1·b}, and a DFT_B
// along the rows; |X[k2·A + k1]|² lands at (k1, k2).
//
//   psd_frames  one block per frame: the frame (optionally windowed)
//               into shared memory, DFT_A with thread = column and
//               U = 16 k1 rows in registers, the twiddle in place after
//               a barrier, DFT_B with thread = k2; writes the frame's
//               |X|² partial [A, B].  W_A^n and W_B^n come from one
//               table each: W_A^{k·a} = W_A^{(k·a) mod A}.
//   psd_sum     the partials summed in frame order (deterministic, no
//               atomics), times the scale; optionally blended into a
//               running PSD, prev + α·(new − prev).
//
// A and B are powers of two in [16, 128], template parameters, so the
// index arithmetic is shifts and masks and each shape gets the register
// budget of its own block size (A·B/16 threads; at A = B = 64 that is
// 256 threads and up to 255 registers, where a 1024-thread bound would
// cap every shape at 64).  A block takes psd_frames_smem(A, B) bytes of
// dynamic shared memory (above 48 KB only after cudaFuncSetAttribute).
// Bound: operations, 2·8·A·B·(A+B) flops of dense DFTs per frame
// against 8·A·B bytes read; the partials are read once more by psd_sum.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "ops.cuh"

namespace four_step {

constexpr int U = 16;  // k1 rows per thread

constexpr size_t psd_frames_smem(int a, int b) {
    return sizeof(float) * (2 * (size_t)a * (b + 1) + 2 * (size_t)a +
                            2 * (size_t)b);
}

inline bool psd_shape_ok(int a, int b) {
    auto pow2 = [](int v) { return v >= 16 && v <= 128 && !(v & (v - 1)); };
    return pow2(a) && pow2(b);
}

// Block f reads frame j = f % fb of group g = f / fb: its element (a, b)
// is x[g·group_stride + j·frame_stride + a·row_stride + b] (real) and
// the same plus im_off (imaginary); fb = 1 and group_stride =
// frame_stride read consecutive frames.  win [A·B] is null when the
// frames arrive windowed.
template <typename T, int A, int B>
__global__ void __launch_bounds__(A * B / U)
psd_frames(const T* __restrict__ x, float in_gain,
           const float* __restrict__ win, size_t frame_stride,
           size_t row_stride, size_t im_off, int fb, size_t group_stride,
           const float* __restrict__ wa_re, const float* __restrict__ wa_im,
           const float* __restrict__ wb_re, const float* __restrict__ wb_im,
           const float* __restrict__ tw_re, const float* __restrict__ tw_im,
           float* __restrict__ part) {
    extern __shared__ float smem[];
    constexpr int bs = B + 1;
    constexpr int nt = A * B / U;
    float* sr = smem;
    float* si = sr + A * bs;
    float* ar = si + A * bs;
    float* ai = ar + A;
    float* br = ai + A;
    float* bi = br + B;
    const int tid = threadIdx.x;
    const size_t fr = blockIdx.x;
    for (int i = tid; i < A; i += nt) {
        ar[i] = wa_re[i];
        ai[i] = wa_im[i];
    }
    for (int i = tid; i < B; i += nt) {
        br[i] = wb_re[i];
        bi[i] = wb_im[i];
    }
    const T* xf = x + (fr / fb) * group_stride + (fr % fb) * frame_stride;
    for (int i = tid; i < A * B; i += nt) {
        const int a = i / B, b = i % B;
        const size_t off = (size_t)a * row_stride + b;
        float vr = deq(xf[off], in_gain);
        float vi = deq(xf[im_off + off], in_gain);
        if (win != nullptr) {
            const float w = win[i];
            vr *= w;
            vi *= w;
        }
        sr[a * bs + b] = vr;
        si[a * bs + b] = vi;
    }
    __syncthreads();

    const int col = tid % B;        // b in DFT_A, k2 in DFT_B
    const int k1_0 = (tid / B) * U;
    float accr[U], acci[U];
#pragma unroll
    for (int u = 0; u < U; ++u) accr[u] = acci[u] = 0.0f;
    // DFT_A over rows: s1[k1][b] = Σ_a W_A^{k1·a} x[a][b]
    for (int a = 0; a < A; ++a) {
        const float xr = sr[a * bs + col], xi = si[a * bs + col];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int idx = ((k1_0 + u) * a) & (A - 1);
            const float cr = ar[idx], ci = ai[idx];
            accr[u] += cr * xr - ci * xi;
            acci[u] += cr * xi + ci * xr;
        }
    }
    __syncthreads();
    // twiddle W_N^{k1·b}, in place
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int k1 = k1_0 + u;
        const float tr = tw_re[k1 * B + col], ti = tw_im[k1 * B + col];
        sr[k1 * bs + col] = accr[u] * tr - acci[u] * ti;
        si[k1 * bs + col] = accr[u] * ti + acci[u] * tr;
        accr[u] = acci[u] = 0.0f;
    }
    __syncthreads();
    // DFT_B over columns: s3[k1][k2] = Σ_b s2[k1][b] W_B^{b·k2}
    for (int b = 0; b < B; ++b) {
        const int idx = (b * col) & (B - 1);
        const float cr = br[idx], ci = bi[idx];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const float xr = sr[(k1_0 + u) * bs + b];
            const float xi = si[(k1_0 + u) * bs + b];
            accr[u] += xr * cr - xi * ci;
            acci[u] += xr * ci + xi * cr;
        }
    }
    float* out = part + fr * (size_t)(A * B);
#pragma unroll
    for (int u = 0; u < U; ++u)
        out[(k1_0 + u) * B + col] = accr[u] * accr[u] + acci[u] * acci[u];
}

// psd[i] = scale · Σ_f part[f][i], frames in order; with prev, the
// result is prev[i] + α·(that − prev[i]).
__global__ void __launch_bounds__(256)
psd_sum(const float* __restrict__ part, float* __restrict__ psd,
        int frames, int n, float scale, const float* __restrict__ prev,
        float alpha) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float acc = 0.0f;
    for (int fr = 0; fr < frames; ++fr) acc += part[(size_t)fr * n + i];
    float out = acc * scale;
    if (prev != nullptr) out = prev[i] + alpha * (out - prev[i]);
    psd[i] = out;
}

// Launch both stages for F frames of one shape on stream s (frames in
// groups of fb, group_stride apart: 0 means consecutive; prev null: no
// blend); returns the error of a refused shared-memory request, else
// cudaSuccess (launch errors are read by the caller with
// cudaGetLastError()).
template <typename T, int A, int B>
cudaError_t launch_psd(const T* x, float in_gain, const float* win,
                       size_t frame_stride, size_t row_stride, size_t im_off,
                       const float* wa_re, const float* wa_im,
                       const float* wb_re, const float* wb_im,
                       const float* tw_re, const float* tw_im, float* part,
                       float* psd, int F, float scale, cudaStream_t s,
                       int fb = 1, size_t group_stride = 0,
                       const float* prev = nullptr, float alpha = 1.0f) {
    if (group_stride == 0) group_stride = frame_stride * fb;
    constexpr size_t smem = psd_frames_smem(A, B);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            psd_frames<T, A, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    psd_frames<T, A, B><<<F, A * B / U, smem, s>>>(
        x, in_gain, win, frame_stride, row_stride, im_off, fb, group_stride,
        wa_re, wa_im, wb_re, wb_im, tw_re, tw_im, part);
    constexpr int n = A * B;
    psd_sum<<<(n + 255) / 256, 256, 0, s>>>(part, psd, F, n, scale, prev,
                                            alpha);
    return cudaSuccess;
}

// The same for a shape known at run time (A, B as psd_shape_ok takes
// them): one instantiation per shape.
template <typename T, int A>
cudaError_t launch_psd_b(const T* x, float in_gain, const float* win,
                         size_t frame_stride, size_t row_stride,
                         size_t im_off, const float* wa_re,
                         const float* wa_im, const float* wb_re,
                         const float* wb_im, const float* tw_re,
                         const float* tw_im, float* part, float* psd, int B,
                         int F, float scale, cudaStream_t s) {
#define SD_PSD_B(BB)                                                      \
    case BB:                                                              \
        return launch_psd<T, A, BB>(x, in_gain, win, frame_stride,        \
                                    row_stride, im_off, wa_re, wa_im,     \
                                    wb_re, wb_im, tw_re, tw_im, part,     \
                                    psd, F, scale, s);
    switch (B) {
        SD_PSD_B(16)
        SD_PSD_B(32)
        SD_PSD_B(64)
        SD_PSD_B(128)
    }
#undef SD_PSD_B
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_psd_any(const T* x, float in_gain, const float* win,
                           size_t frame_stride, size_t row_stride,
                           size_t im_off, const float* wa_re,
                           const float* wa_im, const float* wb_re,
                           const float* wb_im, const float* tw_re,
                           const float* tw_im, float* part, float* psd,
                           int A, int B, int F, float scale, cudaStream_t s) {
#define SD_PSD_A(AA)                                                      \
    case AA:                                                              \
        return launch_psd_b<T, AA>(x, in_gain, win, frame_stride,         \
                                   row_stride, im_off, wa_re, wa_im,      \
                                   wb_re, wb_im, tw_re, tw_im, part, psd, \
                                   B, F, scale, s);
    switch (A) {
        SD_PSD_A(16)
        SD_PSD_A(32)
        SD_PSD_A(64)
        SD_PSD_A(128)
    }
#undef SD_PSD_A
    return cudaErrorInvalidValue;
}

}  // namespace four_step
