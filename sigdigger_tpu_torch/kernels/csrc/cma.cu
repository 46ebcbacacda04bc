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
// rows, the taps carried in and written back (the delay line restarts
// at zero every block, as in the plain version).
//
// Bound: latency.  The taps feed back, so a lane's T symbols are T
// dependent steps; the bytes (the planes read once and written once) and
// the operations would take a few microseconds.  The floor is T times
// the cycles of one step of the chain alone (cma_chain times it;
// equalizer.py::cma_step_cycles).  Only y, e, its clip scale and the
// taps carry from step to step: the power and g depend on the symbols
// alone.  So the kernel is warp-specialized, one block per WL lanes:
//   - a walker warp (lane = channel) steps only the chain, from shared
//     memory: the shift, y, the error, the clip scale and the tap update,
//     with the taps and the delay line in registers;
//   - three helper warps stage the symbol chunks into a ring of NB
//     chunks in shared memory with cp.async, two chunks ahead; compute
//     g of every step of the next chunk (the power in the plain version's
//     order, the IEEE division); and store the walker's y of the last
//     chunk, coalesced rows of WL lanes.
// Each super-step ends in one block barrier.  The clip scale 1/max(|e|,
// 1) is branch-free (clip_scale, on fastops.cuh's correctly rounded
// sequences), equal to the IEEE operations on every float32 |e|²: an
// IEEE square root and division on the chain each hold a slow-path
// branch, and so would a warp vote for a fallback, each a point the
// compiler schedules nothing across.  |e|² overflows to +inf once a lane's
// |y| passes ~2.6e6; the scale is then 0, as the IEEE operations give.
// Every other add and multiply is the plain version's, in its order, and
// the library is built with -fmad=false, so the kernel agrees with
// sigdigger_tpu_torch/kernels/equalizer.py::cma_kernel_reference bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastops.cuh"

namespace {

constexpr int WL = 32;                 // lanes a block: the walker warp's
constexpr int HT = 24;                 // steps a chunk
constexpr int NB = 3;                  // chunks in the symbol ring
constexpr int HELPERS = 96;            // threads of the helper warps
constexpr int THREADS = 32 + HELPERS;
constexpr int RPH = HT * WL / HELPERS; // rows of a chunk a helper owns
constexpr int U = 8;                   // steps the walker loads at once
static_assert(HELPERS % WL == 0 && HT % (HELPERS / WL) == 0 && HT % U == 0,
              "a helper owns one lane of a run of whole rows");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the block barrier of the super-steps, and the helpers' own
__device__ __forceinline__ void block_sync() {
    asm volatile("bar.sync 0, %0;" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void helper_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(HELPERS) : "memory");
}

// The clip scale 1 / max(|e|, 1) of q = |e|², as the IEEE operations
// 1.0f / fmaxf(sqrtf(q), 1.0f) give it, without a branch: 1 where q <= 1
// (the rounded |e| is then at most 1) and where q is NaN (fmaxf drops
// it); rcp_sqrt_fast(q) on (1, FLT_MAX]; 0 at q = +inf.
// clip_check holds it against the IEEE operations on every float32.  (The
// plain version's torch.clamp keeps a NaN that fmaxf drops; a NaN q
// comes only from a NaN y, which turns the taps NaN either way.)
__device__ __forceinline__ float clip_scale(float q) {
    const float fast = rcp_sqrt_fast(q);
    const float other = q > 1.0f ? 0.0f : 1.0f;
    return q > 1.0f && q < __int_as_float(0x7f800000) ? fast : other;
}

template <int K>
struct Lane {
    float tr[K], ti[K];    // taps
    float br[K], bi[K];    // delay line, b[0] the newest symbol
};

// One step of the chain on symbol (xr, xi) with the step's gain g;
// returns y.  The plain version's operations in its order.
template <int K>
__device__ __forceinline__ void cma_step(Lane<K>& s, float xr, float xi,
                                         float g, float& yr_out,
                                         float& yi_out) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
        s.br[j] = s.br[j - 1];
        s.bi[j] = s.bi[j - 1];
    }
    s.br[0] = xr;
    s.bi[0] = xi;
    float yr = 0.0f, yi = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        yr = yr + s.tr[j] * s.br[j] - s.ti[j] * s.bi[j];
        yi = yi + s.tr[j] * s.bi[j] + s.ti[j] * s.br[j];
    }
    yr_out = yr;
    yi_out = yi;
    const float p = yr * yr + yi * yi;
    float er = yr * (p - 1.0f);
    float ei = yi * (p - 1.0f);
    const float sc = clip_scale(er * er + ei * ei);
    er = er * sc;
    ei = ei * sc;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float nt = s.tr[j] - g * (er * s.br[j] + ei * s.bi[j]);
        s.ti[j] = s.ti[j] - g * (ei * s.br[j] - er * s.bi[j]);
        s.tr[j] = nt;
    }
}

// The walker over the first n rows of a chunk (FULL: n = HT): symbols
// xr, xi and gains g [HT][WL] in shared memory, y into yr, yi [HT][WL].
// The next U rows' inputs load while the current U run.
template <int K, bool FULL>
__device__ __forceinline__ void walk_chunk(Lane<K>& s,
                                           const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           const float* __restrict__ g,
                                           float* __restrict__ yr,
                                           float* __restrict__ yi, int lane,
                                           int n) {
    float nx[U], ny[U], ng[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        nx[u] = xr[u * WL + lane];
        ny[u] = xi[u * WL + lane];
        ng[u] = g[u * WL + lane];
    }
#pragma unroll 1
    for (int r0 = 0; r0 < HT; r0 += U) {
        float cx[U], cy[U], cg[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            cx[u] = nx[u];
            cy[u] = ny[u];
            cg[u] = ng[u];
        }
        if (r0 + U < HT) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int q = (r0 + U + u) * WL + lane;
                nx[u] = xr[q];
                ny[u] = xi[q];
                ng[u] = g[q];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!FULL && r0 + u >= n) return;
            float a, b;
            cma_step<K>(s, cx[u], cy[u], cg[u], a, b);
            yr[(r0 + u) * WL + lane] = a;
            yi[(r0 + u) * WL + lane] = b;
        }
    }
}

// g = unl_rt / (1e-6 + Σ_j |b_j|²) of rows r0 .. r0 + n - 1 of a chunk
// into g [HT][WL], b_j the symbol j rows back: in the chunk's slot `cur`,
// in the previous chunk's slot `prev` ([2][HT][WL], re then im) or, with
// prev null (the block's first chunk), zero.  The K symbols of a row
// slide through registers, so a row costs two shared-memory loads.
template <int K>
__device__ __forceinline__ void chunk_gains(const float* cur,
                                            const float* prev, int r0,
                                            int n, int lane, float unl_rt,
                                            float* __restrict__ g) {
    // the window before row r0: w[i] = the symbol of row r0 - 1 - i
    float wr[K], wi[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const int r = r0 - 1 - i;
        wr[i] = wi[i] = 0.0f;
        if (i == K - 1) continue;
        if (r >= 0) {
            wr[i] = cur[r * WL + lane];
            wi[i] = cur[HT * WL + r * WL + lane];
        } else if (prev != nullptr) {
            wr[i] = prev[(HT + r) * WL + lane];
            wi[i] = prev[HT * WL + (HT + r) * WL + lane];
        }
    }
#pragma unroll 4
    for (int r = r0; r < r0 + n; ++r) {
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
            wr[j] = wr[j - 1];
            wi[j] = wi[j - 1];
        }
        wr[0] = cur[r * WL + lane];
        wi[0] = cur[HT * WL + r * WL + lane];
        float power = 1e-6f;
#pragma unroll
        for (int j = 0; j < K; ++j)
            power = power + wr[j] * wr[j] + wi[j] * wi[j];
        g[r * WL + lane] = unl_rt / power;
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
cma_ws(const float* __restrict__ x_re, const float* __restrict__ x_im,
       const float* __restrict__ taps_re, const float* __restrict__ taps_im,
       const float* __restrict__ rate, const float* __restrict__ locked,
       float* __restrict__ y_re, float* __restrict__ y_im,
       float* __restrict__ taps_re_out, float* __restrict__ taps_im_out,
       int T, int C) {
    __shared__ __align__(16) float ring[NB * 2 * HT * WL];  // symbols
    __shared__ __align__(16) float gbuf[2 * HT * WL];       // gains
    __shared__ __align__(16) float ybuf[2 * 2 * HT * WL];   // outputs
    const int c0 = blockIdx.x * WL;
    const int nch = (T + HT - 1) / HT;
    auto slot = [&](int k) { return ring + (k % NB) * 2 * HT * WL; };

    if (threadIdx.x < 32) {
        // the walker (lanes past C walk zeros and store nothing)
        const int lane = threadIdx.x;
        const int c = c0 + lane < C ? c0 + lane : C - 1;
        Lane<K> s;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            s.tr[j] = taps_re[(size_t)j * C + c];
            s.ti[j] = taps_im[(size_t)j * C + c];
            s.br[j] = 0.0f;
            s.bi[j] = 0.0f;
        }
        block_sync();
        for (int k = 0; k <= nch; ++k) {
            if (k < nch) {
                const float* x = slot(k);
                const float* g = gbuf + (k & 1) * HT * WL;
                float* y = ybuf + (k & 1) * 2 * HT * WL;
                const int n = min(HT, T - k * HT);
                if (n == HT)
                    walk_chunk<K, true>(s, x, x + HT * WL, g, y, y + HT * WL,
                                        lane, n);
                else
                    walk_chunk<K, false>(s, x, x + HT * WL, g, y,
                                         y + HT * WL, lane, n);
            }
            block_sync();
        }
        if (c0 + lane < C) {
#pragma unroll
            for (int j = 0; j < K; ++j) {
                taps_re_out[(size_t)j * C + c] = s.tr[j];
                taps_im_out[(size_t)j * C + c] = s.ti[j];
            }
        }
        return;
    }

    // the helpers: helper h owns lane h % WL, rows row0 .. row0 + RPH - 1
    // of a chunk (a warp one row at a time, coalesced)
    const int h = threadIdx.x - 32;
    const int lane = h % WL, row0 = h / WL * RPH;
    const int c = c0 + lane;
    const bool live = c < C;
    const int cc = live ? c : C - 1;
    const float unl_rt = (1.0f - locked[cc]) * rate[cc];
    // chunk k into its ring slot (zeros past T and C); one commit group a
    // call, empty past the last chunk
    auto load = [&](int k) {
        if (k < nch) {
            float* dst = slot(k);
#pragma unroll
            for (int i = 0; i < RPH; ++i) {
                const int row = row0 + i, t = k * HT + row;
                const int q = row * WL + lane;
                if (live && t < T) {
                    cp_async4(dst + q, x_re + (size_t)t * C + c);
                    cp_async4(dst + HT * WL + q, x_im + (size_t)t * C + c);
                } else {
                    dst[q] = 0.0f;
                    dst[HT * WL + q] = 0.0f;
                }
            }
        }
        cp_async_commit();
    };
    auto gains = [&](int k) {
        chunk_gains<K>(slot(k), k > 0 ? slot(k - 1) : nullptr, row0, RPH,
                       lane, unl_rt, gbuf + (k & 1) * HT * WL);
    };
    auto store = [&](int k) {
        const float* y = ybuf + (k & 1) * 2 * HT * WL;
#pragma unroll
        for (int i = 0; i < RPH; ++i) {
            const int row = row0 + i, t = k * HT + row;
            if (live && t < T) {
                y_re[(size_t)t * C + c] = y[row * WL + lane];
                y_im[(size_t)t * C + c] = y[HT * WL + row * WL + lane];
            }
        }
    };
    load(0);
    load(1);
    cp_async_wait<1>();
    helper_sync();
    gains(0);
    block_sync();
    for (int k = 0; k <= nch; ++k) {
        // chunk k + 2 into the slot chunk k - 1 left; then chunk k + 1's
        // gains (its symbols and chunk k's last rows), chunk k - 1's y
        load(k + 2);
        cp_async_wait<1>();
        helper_sync();
        if (k + 1 < nch) gains(k + 1);
        if (k >= 1) store(k - 1);
        block_sync();
    }
}

// The walker alone, on one warp (lanes 0..WL-1 = channels, clamped to
// C): the first HT rows of x_re, x_im and their gains in shared memory,
// walked `steps` / HT times by walk_chunk, the walker's own code.
// out[0]: clock64 cycles a step; out[1]: the SM clock in GHz (clock64
// over %globaltimer); out[2..]: a sink for the final taps.
template <int K>
__global__ void __launch_bounds__(32, 1)
cma_chain(const float* __restrict__ x_re, const float* __restrict__ x_im,
          const float* __restrict__ taps_re,
          const float* __restrict__ taps_im, const float* __restrict__ rate,
          const float* __restrict__ locked, int C, int steps,
          float* __restrict__ out) {
    __shared__ float xs[2 * HT * WL], gs[HT * WL], ys[2 * HT * WL];
    const int lane = threadIdx.x;
    const int c = lane < C ? lane : C - 1;
    for (int r = 0; r < HT; ++r) {
        xs[r * WL + lane] = x_re[(size_t)r * C + c];
        xs[HT * WL + r * WL + lane] = x_im[(size_t)r * C + c];
    }
    __syncwarp();
    const float unl_rt = (1.0f - locked[c]) * rate[c];
    chunk_gains<K>(xs, nullptr, 0, HT, lane, unl_rt, gs);
    Lane<K> s;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        s.tr[j] = taps_re[(size_t)j * C + c];
        s.ti[j] = taps_im[(size_t)j * C + c];
        s.br[j] = 0.0f;
        s.bi[j] = 0.0f;
    }
    __syncwarp();
    const int chunks = steps / HT;
    uint64_t ns0, ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
    const long long t0 = clock64();
    for (int k = 0; k < chunks; ++k)
        walk_chunk<K, true>(s, xs, xs + HT * WL, gs, ys, ys + HT * WL, lane,
                            HT);
    const long long t1 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    if (lane == 0) {
        out[0] = static_cast<float>(t1 - t0) / (chunks * HT);
        out[1] = static_cast<float>(t1 - t0) / static_cast<float>(ns1 - ns0);
    }
    float sink = ys[(HT - 1) * WL + lane];
#pragma unroll
    for (int j = 0; j < K; ++j) sink += s.tr[j] + s.ti[j];
    out[2 + lane] = sink;
}

// Every float32 bit pattern q: clip_scale(q) against 1.0f / fmaxf(
// __fsqrt_rn(q), 1.0f) with IEEE operations.  counts: [0] values that
// differ, [1] values checked.
__global__ void __launch_bounds__(256)
clip_check(unsigned long long* __restrict__ counts) {
    unsigned long long bad = 0, n = 0;
    const unsigned long long stride = (unsigned long long)gridDim.x * 256;
    for (unsigned long long i = (unsigned long long)blockIdx.x * 256 +
                                threadIdx.x;
         i < (1ull << 32); i += stride) {
        const float q = __uint_as_float(static_cast<unsigned>(i));
        const float want = __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(q), 1.0f));
        ++n;
        bad += __float_as_uint(clip_scale(q)) != __float_as_uint(want);
    }
    atomicAdd(&counts[0], bad);
    atomicAdd(&counts[1], n);
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
    if (T < 1 || C < 1 || K != 5)
        return static_cast<int>(cudaErrorInvalidValue);
    cma_ws<5><<<(C + WL - 1) / WL, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
        x_re, x_im, taps_re, taps_im, rate, locked, y_re, y_im, taps_re_out,
        taps_im_out, T, C);
    return static_cast<int>(cudaGetLastError());
}

// The walker's chain alone (cma_chain): x_re, x_im [>= HT, C], taps
// [5, C], rate, locked [C]; out [2 + 32] float32.  steps >= HT.
extern "C" int sd_cma_chain(const float* x_re, const float* x_im,
                            const float* taps_re, const float* taps_im,
                            const float* rate, const float* locked, int C,
                            int steps, float* out, void* stream) {
    if (C < 1 || steps < HT) return static_cast<int>(cudaErrorInvalidValue);
    cma_chain<5><<<1, WL, 0, static_cast<cudaStream_t>(stream)>>>(
        x_re, x_im, taps_re, taps_im, rate, locked, C, steps, out);
    return static_cast<int>(cudaGetLastError());
}

// clip_check over every float32: counts [2] uint64, zeroed here.
extern "C" int sd_cma_clip_check(unsigned long long* counts, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned long long),
                                    s);
    if (e != cudaSuccess) return static_cast<int>(e);
    clip_check<<<132 * 8, 256, 0, s>>>(counts);
    return static_cast<int>(cudaGetLastError());
}
