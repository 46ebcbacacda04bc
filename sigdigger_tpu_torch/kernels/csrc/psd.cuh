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
// The fast path takes A and B powers of two in [16, 128] as template
// parameters, so the index arithmetic is shifts and masks and each shape
// gets the register budget of its own block size (A·B/16 threads; at
// A = B = 64 that is 256 threads and up to 255 registers, where a
// 1024-thread bound would cap every shape at 64).  A block takes
// psd_frames_smem(A, B) bytes of dynamic shared memory (above 48 KB only
// after cudaFuncSetAttribute).
//
// Every other factoring the reference's PallasPSDConfig makes (A = 2^⌊log2
// N / 2⌋ or the caller's A, B = N/A: A and B down to 1, B not a power of
// two as at N = 1536, B up to 256 at N = 32768) takes the general form,
// with A and B at run time and one output element per thread and step:
//   psd_frames_any  one block per frame with the frame and the DFT_A
//                   output both in shared memory (16·N bytes, N up to
//                   14336);
//   psd_pass_a/_b   past that, two passes over device scratch [F, 2, N]:
//                   DFT_A and the twiddle, then DFT_B and |X|², each
//                   frame spread over several blocks.
// The general form is a plain one, right before fast: no size that takes
// it is on a hot path (the offset estimator's 64- and 128-point PSDs,
// odd receiver psd_fft values).
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

// The shapes of the template fast path.
inline bool psd_shape_ok(int a, int b) {
    auto pow2 = [](int v) { return v >= 16 && v <= 128 && !(v & (v - 1)); };
    return pow2(a) && pow2(b);
}

constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

// Shared memory of psd_frames_any: the frame and the DFT_A output.
inline size_t psd_any_smem(int a, int b) {
    return sizeof(float) * 4 * (size_t)a * b;
}

// The general form runs in two passes over device scratch (F·2·A·B
// floats) when one frame does not fit a block.
inline bool psd_two_pass(int a, int b) {
    return !psd_shape_ok(a, b) && psd_any_smem(a, b) > SMEM_MAX;
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

// The general form.  Element (a, b) of frame fr, dequantized and
// windowed, as psd_frames reads it.
template <typename T>
struct FrameReader {
    const T* xf;
    float in_gain;
    const float* win;
    size_t row_stride, im_off;
    int B;

    __device__ __forceinline__ float2 operator()(int a, int b) const {
        const size_t off = (size_t)a * row_stride + b;
        float vr = deq(xf[off], in_gain);
        float vi = deq(xf[im_off + off], in_gain);
        if (win != nullptr) {
            const float w = win[a * B + b];
            vr *= w;
            vi *= w;
        }
        return make_float2(vr, vi);
    }
};

// A frame already in [A, B] planes (shared memory or scratch).
struct PlaneReader {
    const float* re;
    const float* im;
    int B;

    __device__ __forceinline__ float2 operator()(int a, int b) const {
        return make_float2(re[a * B + b], im[a * B + b]);
    }
};

template <typename T>
__device__ __forceinline__ const T* frame_at(const T* x, size_t fr, int fb,
                                             size_t frame_stride,
                                             size_t group_stride) {
    return x + (fr / fb) * group_stride + (fr % fb) * frame_stride;
}

// Outputs i = start, start + step, ... of DFT_A and the twiddle:
// out[k1][b] = W_N^{k1·b} · Σ_a W_A^{(k1·a) mod A} · in(a, b).
template <typename Reader>
__device__ void any_dft_a(const Reader& in, int A, int B,
                          const float* __restrict__ wa_re,
                          const float* __restrict__ wa_im,
                          const float* __restrict__ tw_re,
                          const float* __restrict__ tw_im,
                          float* __restrict__ out_re,
                          float* __restrict__ out_im, int start, int step) {
    for (int i = start; i < A * B; i += step) {
        const int k1 = i / B, b = i - (i / B) * B;
        float sr = 0.0f, si = 0.0f;
        int idx = 0;                       // (k1·a) mod A
        for (int a = 0; a < A; ++a) {
            const float2 v = in(a, b);
            const float cr = wa_re[idx], ci = wa_im[idx];
            sr += cr * v.x - ci * v.y;
            si += cr * v.y + ci * v.x;
            idx += k1;
            if (idx >= A) idx -= A;
        }
        const float tr = tw_re[i], ti = tw_im[i];
        out_re[i] = sr * tr - si * ti;
        out_im[i] = sr * ti + si * tr;
    }
}

// Outputs i of DFT_B and the power: out[k1][k2] = |Σ_b s[k1][b] ·
// W_B^{(b·k2) mod B}|².
__device__ inline void any_dft_b(const float* __restrict__ s_re,
                                 const float* __restrict__ s_im, int A,
                                 int B, const float* __restrict__ wb_re,
                                 const float* __restrict__ wb_im,
                                 float* __restrict__ out, int start,
                                 int step) {
    for (int i = start; i < A * B; i += step) {
        const int k1 = i / B, k2 = i - (i / B) * B;
        const float* rr = s_re + (size_t)k1 * B;
        const float* ri = s_im + (size_t)k1 * B;
        float sr = 0.0f, si = 0.0f;
        int idx = 0;                       // (b·k2) mod B
        for (int b = 0; b < B; ++b) {
            const float cr = wb_re[idx], ci = wb_im[idx];
            sr += rr[b] * cr - ri[b] * ci;
            si += rr[b] * ci + ri[b] * cr;
            idx += k2;
            if (idx >= B) idx -= B;
        }
        out[i] = sr * sr + si * si;
    }
}

constexpr int ANY_THREADS = 256;

// One block per frame: the frame into shared memory, DFT_A and the
// twiddle into a second buffer, DFT_B and |X|² into the partial.
template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
psd_frames_any(const T* __restrict__ x, float in_gain,
               const float* __restrict__ win, size_t frame_stride,
               size_t row_stride, size_t im_off, int fb, size_t group_stride,
               const float* __restrict__ wa_re,
               const float* __restrict__ wa_im,
               const float* __restrict__ wb_re,
               const float* __restrict__ wb_im,
               const float* __restrict__ tw_re,
               const float* __restrict__ tw_im, float* __restrict__ part,
               int A, int B) {
    extern __shared__ float smem[];
    const int n = A * B;
    float* xr = smem;
    float* xi = xr + n;
    float* sr = xi + n;
    float* si = sr + n;
    const size_t fr = blockIdx.x;
    const FrameReader<T> rd{frame_at(x, fr, fb, frame_stride, group_stride),
                            in_gain, win, row_stride, im_off, B};
    for (int i = threadIdx.x; i < n; i += ANY_THREADS) {
        const float2 v = rd(i / B, i - (i / B) * B);
        xr[i] = v.x;
        xi[i] = v.y;
    }
    __syncthreads();
    any_dft_a(PlaneReader{xr, xi, B}, A, B, wa_re, wa_im, tw_re, tw_im, sr,
              si, threadIdx.x, ANY_THREADS);
    __syncthreads();
    any_dft_b(sr, si, A, B, wb_re, wb_im, part + fr * (size_t)n,
              threadIdx.x, ANY_THREADS);
}

// Two passes for a frame past shared memory: grid (F, chunks), frame
// blockIdx.x spread over the chunks; scratch holds [F, 2, N].
template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
psd_pass_a(const T* __restrict__ x, float in_gain,
           const float* __restrict__ win, size_t frame_stride,
           size_t row_stride, size_t im_off, int fb, size_t group_stride,
           const float* __restrict__ wa_re, const float* __restrict__ wa_im,
           const float* __restrict__ tw_re, const float* __restrict__ tw_im,
           float* __restrict__ scratch, int A, int B) {
    const size_t fr = blockIdx.x;
    const size_t n = (size_t)A * B;
    const FrameReader<T> rd{frame_at(x, fr, fb, frame_stride, group_stride),
                            in_gain, win, row_stride, im_off, B};
    float* out = scratch + fr * 2 * n;
    any_dft_a(rd, A, B, wa_re, wa_im, tw_re, tw_im, out, out + n,
              blockIdx.y * ANY_THREADS + threadIdx.x,
              gridDim.y * ANY_THREADS);
}

__global__ void __launch_bounds__(ANY_THREADS)
psd_pass_b(const float* __restrict__ scratch,
           const float* __restrict__ wb_re, const float* __restrict__ wb_im,
           float* __restrict__ part, int A, int B) {
    const size_t fr = blockIdx.x;
    const size_t n = (size_t)A * B;
    const float* in = scratch + fr * 2 * n;
    any_dft_b(in, in + n, A, B, wb_re, wb_im, part + fr * n,
              blockIdx.y * ANY_THREADS + threadIdx.x,
              gridDim.y * ANY_THREADS);
}

// Launch the general form and psd_sum for F frames of any A·B on stream
// s (arguments as launch_psd's; scratch [F, 2, A·B] floats, read only
// when psd_two_pass(A, B)).
template <typename T>
cudaError_t launch_psd_gen(const T* x, float in_gain, const float* win,
                           size_t frame_stride, size_t row_stride,
                           size_t im_off, const float* wa_re,
                           const float* wa_im, const float* wb_re,
                           const float* wb_im, const float* tw_re,
                           const float* tw_im, float* part, float* scratch,
                           float* psd, int A, int B, int F, float scale,
                           cudaStream_t s, int fb, size_t group_stride,
                           const float* prev, float alpha) {
    if (A < 1 || B < 1 || F < 1) return cudaErrorInvalidValue;
    const int n = A * B;
    if (psd_two_pass(A, B)) {
        if (scratch == nullptr) return cudaErrorInvalidValue;
        const dim3 grid(F, (n + 8 * ANY_THREADS - 1) / (8 * ANY_THREADS));
        psd_pass_a<T><<<grid, ANY_THREADS, 0, s>>>(
            x, in_gain, win, frame_stride, row_stride, im_off, fb,
            group_stride, wa_re, wa_im, tw_re, tw_im, scratch, A, B);
        psd_pass_b<<<grid, ANY_THREADS, 0, s>>>(scratch, wb_re, wb_im, part,
                                                A, B);
    } else {
        const size_t smem = psd_any_smem(A, B);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                psd_frames_any<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return e;
        }
        psd_frames_any<T><<<F, ANY_THREADS, smem, s>>>(
            x, in_gain, win, frame_stride, row_stride, im_off, fb,
            group_stride, wa_re, wa_im, wb_re, wb_im, tw_re, tw_im, part, A,
            B);
    }
    psd_sum<<<(n + 255) / 256, 256, 0, s>>>(part, psd, F, n, scale, prev,
                                            alpha);
    return cudaSuccess;
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

// The same for a shape known at run time: the template fast path for
// the shapes psd_shape_ok takes (one instantiation per shape), the
// general form for every other one (scratch as launch_psd_gen reads it).
template <typename T, int A>
cudaError_t launch_psd_b(const T* x, float in_gain, const float* win,
                         size_t frame_stride, size_t row_stride,
                         size_t im_off, const float* wa_re,
                         const float* wa_im, const float* wb_re,
                         const float* wb_im, const float* tw_re,
                         const float* tw_im, float* part, float* psd, int B,
                         int F, float scale, cudaStream_t s, int fb,
                         size_t group_stride, const float* prev,
                         float alpha) {
#define SD_PSD_B(BB)                                                      \
    case BB:                                                              \
        return launch_psd<T, A, BB>(x, in_gain, win, frame_stride,        \
                                    row_stride, im_off, wa_re, wa_im,     \
                                    wb_re, wb_im, tw_re, tw_im, part,     \
                                    psd, F, scale, s, fb, group_stride,   \
                                    prev, alpha);
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
                           const float* tw_im, float* part, float* scratch,
                           float* psd, int A, int B, int F, float scale,
                           cudaStream_t s, int fb = 1,
                           size_t group_stride = 0,
                           const float* prev = nullptr, float alpha = 1.0f) {
    if (group_stride == 0) group_stride = frame_stride * fb;
    if (!psd_shape_ok(A, B))
        return launch_psd_gen<T>(x, in_gain, win, frame_stride, row_stride,
                                 im_off, wa_re, wa_im, wb_re, wb_im, tw_re,
                                 tw_im, part, scratch, psd, A, B, F, scale,
                                 s, fb, group_stride, prev, alpha);
#define SD_PSD_A(AA)                                                      \
    case AA:                                                              \
        return launch_psd_b<T, AA>(x, in_gain, win, frame_stride,         \
                                   row_stride, im_off, wa_re, wa_im,      \
                                   wb_re, wb_im, tw_re, tw_im, part, psd, \
                                   B, F, scale, s, fb, group_stride,      \
                                   prev, alpha);
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
