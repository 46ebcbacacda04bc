// Batched CMA blind equalizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/equalizer.py::_cma_kernel:
// per channel, a K-tap complex FIR adapted per symbol with the
// soft-clipped, power-normalised constant-modulus update
//
//   y      = Σ_j t_j·b_j                (b_0 the newest symbol)
//   e      = y·(|y|² − 1),  e ← e / max(|e|, 1)
//   g      = (1 − locked)·rate / (1e-6 + Σ_j |b_j|²)
//   t_j   ← t_j − g·e·conj(b_j)
//
// over time-major [T, C] re/im planes, with per-channel rate and lock
// rows, the taps carried in and written back.
//
// Bound: latency.  The update feeds back, so a lane's T symbols are T
// dependent steps (~130 operations each at K = 5); the bytes (the planes
// read once and written once) and the operations would take a few
// microseconds.  Design: one thread per channel walking its symbols;
// the K taps and the delay line live in registers (K a template
// parameter); consecutive threads own consecutive channels, so every
// load and store of a time step is coalesced across the warp; the next
// CHUNK steps' inputs are loaded while the current ones run.  The
// arithmetic repeats the plain version's operations in its order
// (yr + tr·br − ti·bi, power seeded at 1e-6, s = 1/max(|e|, 1),
// g = (1 − locked)·rate/power), and the library is built with
// -fmad=false, so no multiply and add contract into an FMA: the kernel
// agrees with sigdigger_tpu_torch/kernels/equalizer.py::
// cma_kernel_reference bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;

template <int K>
__global__ void __launch_bounds__(128)
cma(const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ taps_re, const float* __restrict__ taps_im,
    const float* __restrict__ rate, const float* __restrict__ locked,
    float* __restrict__ y_re, float* __restrict__ y_im,
    float* __restrict__ taps_re_out, float* __restrict__ taps_im_out, int T,
    int C) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const float rt = rate[c];
    const float unlocked = 1.0f - locked[c];
    float tr[K], ti[K], br[K], bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        tr[j] = taps_re[(size_t)j * C + c];
        ti[j] = taps_im[(size_t)j * C + c];
        br[j] = 0.0f;
        bi[j] = 0.0f;
    }
    float nr[CHUNK], ni[CHUNK];
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
        const bool in = s < T;
        nr[s] = in ? x_re[(size_t)s * C + c] : 0.0f;
        ni[s] = in ? x_im[(size_t)s * C + c] : 0.0f;
    }
    for (int i0 = 0; i0 < T; i0 += CHUNK) {
        float cr[CHUNK], ci[CHUNK];
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
            cr[s] = nr[s];
            ci[s] = ni[s];
            const int at = i0 + CHUNK + s;
            nr[s] = at < T ? x_re[(size_t)at * C + c] : 0.0f;
            ni[s] = at < T ? x_im[(size_t)at * C + c] : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
            const int i = i0 + s;
            if (i >= T) break;
#pragma unroll
            for (int j = K - 1; j > 0; --j) {
                br[j] = br[j - 1];
                bi[j] = bi[j - 1];
            }
            br[0] = cr[s];
            bi[0] = ci[s];
            float yr = 0.0f, yi = 0.0f;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                yr = yr + tr[j] * br[j] - ti[j] * bi[j];
                yi = yi + tr[j] * bi[j] + ti[j] * br[j];
            }
            y_re[(size_t)i * C + c] = yr;
            y_im[(size_t)i * C + c] = yi;
            const float p = yr * yr + yi * yi;
            float er = yr * (p - 1.0f);
            float ei = yi * (p - 1.0f);
            const float emag = sqrtf(er * er + ei * ei);
            const float sc = 1.0f / fmaxf(emag, 1.0f);
            er = er * sc;
            ei = ei * sc;
            float power = 1e-6f;
#pragma unroll
            for (int j = 0; j < K; ++j)
                power = power + br[j] * br[j] + bi[j] * bi[j];
            const float g = unlocked * rt / power;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float nt = tr[j] - g * (er * br[j] + ei * bi[j]);
                ti[j] = ti[j] - g * (ei * br[j] - er * bi[j]);
                tr[j] = nt;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
        taps_re_out[(size_t)j * C + c] = tr[j];
        taps_im_out[(size_t)j * C + c] = ti[j];
    }
}

template <int K>
void launch(const float* x_re, const float* x_im, const float* taps_re,
            const float* taps_im, const float* rate, const float* locked,
            float* y_re, float* y_im, float* taps_re_out, float* taps_im_out,
            int T, int C, cudaStream_t stream) {
    const dim3 block(128);
    const dim3 grid((C + 127) / 128);
    cma<K><<<grid, block, 0, stream>>>(x_re, x_im, taps_re, taps_im, rate,
                                       locked, y_re, y_im, taps_re_out,
                                       taps_im_out, T, C);
}

}  // namespace

// One CMA block: x_re, x_im [T, C] float32; taps_re, taps_im [K, C]; rate,
// locked [C] → y_re, y_im [T, C] and taps_re_out, taps_im_out [K, C]
// (fresh buffers).  K = 5, the bank's tap count (the only one built).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sd_cma(const float* x_re, const float* x_im,
                      const float* taps_re, const float* taps_im,
                      const float* rate, const float* locked, float* y_re,
                      float* y_im, float* taps_re_out, float* taps_im_out,
                      int T, int C, int K, void* stream) {
    if (T < 1 || C < 1 || K != 5) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    launch<5>(x_re, x_im, taps_re, taps_im, rate, locked, y_re, y_im,
              taps_re_out, taps_im_out, T, C,
              static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}
