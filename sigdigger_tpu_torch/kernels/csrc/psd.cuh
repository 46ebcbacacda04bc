// Four-step (Bailey) PSD stages shared by the fused FM kernel
// (channelizer2.cu), the standalone PSD kernel (psd.cu) and the PSD read
// from the channelizer's window buffer (psd_xw.cu).
//
// An N-point DFT with N = A·B is a DFT_A down the columns of the frame
// laid out as x[a][b] = x[a·B + b], a twiddle W_N^{k1·b}, and a DFT_B
// along the rows; |X[k2·A + k1]|² lands at (k1, k2).
//
// The fast path takes A and B powers of two in [16, 128] as template
// parameters and computes both DFTs as FFTs in registers:
//
//   psd_frames  one block of fft_threads(N) threads per frame, blocks in
//               thread-block clusters of CLUSTER frames, one launch.  The
//               frame's raw rows are copied into shared memory with
//               16-byte cp.async (plain loads when a row is not 16-byte
//               aligned), with the tables beside them.  Each L-point DFT
//               (L = A down the columns, L = B along the rows) is the
//               Stockham radix plan Plan<L>: per pass every thread holds
//               8 complex values in registers, runs 8/R radix-R
//               butterflies with constant twiddles after the pass
//               twiddle W_L^n, and exchanges through shared memory.  The
//               first pass of DFT_A dequantizes and windows as it reads
//               the raw rows; the last applies W_N^{k1·b}; the last pass
//               of DFT_B writes |X|².  The frame sum: each block of a
//               cluster owns a slice of the bins, every block pushes each
//               owner its slice (st.async into distributed shared
//               memory, completing on the owner's mbarrier), and the
//               owner adds them in rank (frame) order.  With more than
//               one cluster the owners write partials, and the last
//               block to finish each slice (an integer counter) adds the
//               clusters' partials in order; the scale and the blend
//               prev + α·(new − prev) come last.
//   psd_sum     the general form's frame sum (below).
//
// Every twiddle comes from the float64-built tables of
// fft.py::psd_constants: W_A^n and W_B^n (wa, wb: the pass twiddle W_L^n
// of a pass with stride Ns and radix R is W_L^{(j mod Ns)·r·L/(Ns·R)})
// and W_N^{k1·b} (tw); the butterflies' own twiddles are W_8^1 = (1 −
// i)/√2, −i and W_8^3.  Stockham passes leave the output in natural
// order, so no digit reversal is needed.  No float atomics: two launches
// on the same input are bit-equal.  A block takes psd_frames_smem(A, B)
// bytes of dynamic shared memory (above 48 KB, past A·B = 4096, only
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
//                   frame spread over several blocks;
// and psd_sum over the F per-frame partials.  The general form is a
// plain one, right before fast: no size that takes it is on a hot path
// (the offset estimator's 64- and 128-point PSDs, odd receiver psd_fft
// values).
// Bound: bytes, 8·N bytes (float32) read per frame against 5·N·log2 N
// flops of FFT.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ops.cuh"

namespace four_step {

// Frames per thread-block cluster: the frame sum's first level.
constexpr int CLUSTER = 8;

// The radix plan of each length L: the Stockham passes' radices, first
// pass first (fft.py::PSD_PLANS mirrors it; tests/test_torch_psd_plan.py
// holds the two equal and runs the same passes on the CPU).
template <int L>
struct Plan;
template <>
struct Plan<16> {
    static constexpr int n = 2, r0 = 4, r1 = 4, r2 = 1;
};
template <>
struct Plan<32> {
    static constexpr int n = 2, r0 = 8, r1 = 4, r2 = 1;
};
template <>
struct Plan<64> {
    static constexpr int n = 2, r0 = 8, r1 = 8, r2 = 1;
};
template <>
struct Plan<128> {
    static constexpr int n = 3, r0 = 8, r1 = 4, r2 = 4;
};

// Radix of pass p of L's plan.
template <int L>
__host__ __device__ constexpr int plan_radix(int p) {
    return p == 0 ? Plan<L>::r0 : p == 1 ? Plan<L>::r1 : Plan<L>::r2;
}

// Ns of pass p: the product of the radices before it.
template <int L>
__host__ __device__ constexpr int plan_ns(int p) {
    int ns = 1;
    for (int i = 0; i < p; ++i) ns *= plan_radix<L>(i);
    return ns;
}

// Threads a frame: 8 complex values each, at most 512.
__host__ __device__ constexpr int fft_threads(int n) {
    return n / 8 < 512 ? n / 8 : 512;
}

constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

// The frame as complex [A][B + 1] (the odd row stride keeps the row
// passes, whose lanes run down a column, free of bank conflicts); the
// raw rows and, at the end, |X|² [A][B + 1] alias it.
__host__ __device__ constexpr size_t psd_frame_bytes(int a, int b) {
    return sizeof(float2) * (size_t)a * (b + 1);
}

// Dynamic shared memory of psd_frames: the frame (whose upper half takes
// the frame sum's receive rows once the FFT is done), an mbarrier and a
// flag (16 bytes), and W_A^n, W_B^n (re, im), staged with the frame.
// The window and W_N^{k1·b} are read from device memory (L2) where they
// are used: staging them with the frame doubled the bytes a block waits
// for before its first pass.  Below 48 KB up to A·B = 4096.
constexpr size_t psd_frames_smem(int a, int b) {
    return psd_frame_bytes(a, b) + 16 + sizeof(float) * (2 * a + 2 * b);
}

// Clusters of a launch: the frame sum's partials.
constexpr int psd_parts(int frames) {
    return (frames + CLUSTER - 1) / CLUSTER;
}

// The constants as one float32 buffer (fft.py::psd_pack): W_A^n and
// W_B^n (re, im), the twiddles tw [A, B] (re, im), then, for psd_xw, the
// window w2d [A, B].
struct Consts {
    const float *wa_re, *wa_im, *wb_re, *wb_im, *tw_re, *tw_im, *w2d;
};

inline Consts unpack(const float* c, int a, int b) {
    const size_t n = (size_t)a * b;
    const float* tw = c + 2 * a + 2 * b;
    return {c, c + a, c + 2 * a, c + 2 * a + b, tw, tw + n, tw + 2 * n};
}

// The shapes of the template fast path.
inline bool psd_shape_ok(int a, int b) {
    auto pow2 = [](int v) { return v >= 16 && v <= 128 && !(v & (v - 1)); };
    return pow2(a) && pow2(b);
}

// Shared memory of psd_frames_any: the frame and the DFT_A output.
inline size_t psd_any_smem(int a, int b) {
    return sizeof(float) * 4 * (size_t)a * b;
}

// The general form runs in two passes over device scratch (F·2·A·B
// floats) when one frame does not fit a block.
inline bool psd_two_pass(int a, int b) {
    return !psd_shape_ok(a, b) && psd_any_smem(a, b) > SMEM_MAX;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
// a·(−i)
__device__ __forceinline__ float2 cmul_mi(float2 a) {
    return make_float2(a.y, -a.x);
}

// In-place forward DFT of R values, v[k] = Σ_r v[r]·W_R^{r·k}.
template <int R>
__device__ __forceinline__ void dft_r(float2* v);

template <>
__device__ __forceinline__ void dft_r<2>(float2* v) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft_r<4>(float2* v) {
    const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
    const float2 a2 = cadd(v[1], v[3]), a3 = cmul_mi(csub(v[1], v[3]));
    v[0] = cadd(a0, a2);
    v[2] = csub(a0, a2);
    v[1] = cadd(a1, a3);
    v[3] = csub(a1, a3);
}

template <>
__device__ __forceinline__ void dft_r<8>(float2* v) {
    constexpr float H = 0.70710678118654752f;   // √2/2
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft_r<4>(e);
    dft_r<4>(o);
    // o[k]·W_8^k: W_8^1 = (1 − i)/√2, W_8^2 = −i, W_8^3 = −(1 + i)/√2
    const float2 o1 = make_float2(H * (o[1].x + o[1].y),
                                  H * (o[1].y - o[1].x));
    const float2 o2 = cmul_mi(o[2]);
    const float2 o3 = make_float2(H * (o[3].y - o[3].x),
                                  -H * (o[3].x + o[3].y));
    v[0] = cadd(e[0], o[0]);
    v[4] = csub(e[0], o[0]);
    v[1] = cadd(e[1], o1);
    v[5] = csub(e[1], o1);
    v[2] = cadd(e[2], o2);
    v[6] = csub(e[2], o2);
    v[3] = cadd(e[3], o3);
    v[7] = csub(e[3], o3);
}

// One Stockham pass of every L-point DFT of the frame: NF of them (one
// per column, COLS, or per row), butterfly u of the frame taking DFT c =
// u mod NF and butterfly j = u / NF of it.  The butterfly reads elements
// j + r·L/R through ld(c, e), applies W_{Ns·R}^{(j mod Ns)·r} (a W_L
// table lookup) and the radix-R DFT, and after a barrier writes element
// (j / Ns)·Ns·R + j mod Ns + r·Ns through st(c, e, v).  The barrier
// makes every pass safe in place; a second one closes it.
template <int N, int L, int R, int NS, int NF, class Ld, class St>
__device__ __forceinline__ void stockham_pass(
    const Ld& ld, const St& st, const float* wl_re, const float* wl_im) {
    constexpr int NT = fft_threads(N);
    constexpr int PER = N / R / NT;   // butterflies per thread
    constexpr int STEP = L / (NS * R);
    float2 v[PER][R];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int u = threadIdx.x + i * NT;
        const int c = u % NF, j = u / NF;
#pragma unroll
        for (int r = 0; r < R; ++r) v[i][r] = ld(c, j + r * (L / R));
        if constexpr (NS > 1) {
            const int jn = (j % NS) * STEP;
#pragma unroll
            for (int r = 1; r < R; ++r) {
                const int idx = jn * r;
                v[i][r] = cmul(v[i][r], make_float2(wl_re[idx], wl_im[idx]));
            }
        }
        dft_r<R>(v[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int u = threadIdx.x + i * NT;
        const int c = u % NF, j = u / NF;
        const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
        for (int r = 0; r < R; ++r) st(c, base + r * NS, v[i][r]);
    }
    __syncthreads();
}

// Element (a, b) of the raw frame in shared memory, dequantized and
// windowed (win null: the frames arrive windowed).
template <typename T, int A, int B>
struct RawLoad {
    const T* raw;          // [2][A][B]: real rows, then imaginary rows
    float in_gain;
    const float* win;

    __device__ __forceinline__ float2 operator()(int b, int a) const {
        const int i = a * B + b;
        float vr = deq(raw[i], in_gain);
        float vi = deq(raw[A * B + i], in_gain);
        if (win != nullptr) {
            const float w = win[i];
            vr *= w;
            vi *= w;
        }
        return make_float2(vr, vi);
    }
};

// The frame [A][B + 1] as DFT_A (c = column b, e = row) or DFT_B (c =
// row k1, e = column) sees it.
template <int ST, bool COLS>
struct Frame {
    float2* s;

    __device__ __forceinline__ int at(int c, int e) const {
        return COLS ? e * ST + c : c * ST + e;
    }
    __device__ __forceinline__ float2 operator()(int c, int e) const {
        return s[at(c, e)];
    }
    __device__ __forceinline__ void operator()(int c, int e,
                                               float2 v) const {
        s[at(c, e)] = v;
    }
};

// DFT_A's last pass stores s1[k1][b]·W_N^{k1·b}.
template <int B>
struct TwiddleStore {
    float2* s;
    const float* tw_re;
    const float* tw_im;

    __device__ __forceinline__ void operator()(int b, int k1,
                                               float2 v) const {
        const int i = k1 * B + b;
        s[k1 * (B + 1) + b] =
            cmul(v, make_float2(tw_re[i], tw_im[i]));
    }
};

// DFT_B's last pass stores |X|² at (k1, k2), over the frame it read.
template <int B>
struct PowerStore {
    float* p;

    __device__ __forceinline__ void operator()(int k1, int k2,
                                               float2 v) const {
        p[k1 * (B + 1) + k2] = v.x * v.x + v.y * v.y;
    }
};

// Passes P.. of DFT_A (columns, L = A).
template <typename T, int A, int B, int P>
__device__ __forceinline__ void dft_a(const RawLoad<T, A, B>& raw,
                                      float2* s, const float* wa_re,
                                      const float* wa_im, const float* tw_re,
                                      const float* tw_im) {
    constexpr int R = plan_radix<A>(P), NS = plan_ns<A>(P);
    constexpr bool last = P + 1 == Plan<A>::n;
    const Frame<B + 1, true> f{s};
    if constexpr (P == 0)
        stockham_pass<A * B, A, R, NS, B>(raw, f, wa_re, wa_im);
    else if constexpr (last)
        stockham_pass<A * B, A, R, NS, B>(
            f, TwiddleStore<B>{s, tw_re, tw_im}, wa_re, wa_im);
    else
        stockham_pass<A * B, A, R, NS, B>(f, f, wa_re, wa_im);
    if constexpr (!last) dft_a<T, A, B, P + 1>(raw, s, wa_re, wa_im, tw_re,
                                               tw_im);
}

// Passes P.. of DFT_B (rows, L = B); the last writes |X|².
template <int A, int B, int P>
__device__ __forceinline__ void dft_b(float2* s, const float* wb_re,
                                      const float* wb_im) {
    constexpr int R = plan_radix<B>(P), NS = plan_ns<B>(P);
    constexpr bool last = P + 1 == Plan<B>::n;
    const Frame<B + 1, false> f{s};
    if constexpr (last) {
        stockham_pass<A * B, B, R, NS, A>(
            f, PowerStore<B>{reinterpret_cast<float*>(s)}, wb_re, wb_im);
    } else {
        stockham_pass<A * B, B, R, NS, A>(f, f, wb_re, wb_im);
        dft_b<A, B, P + 1>(s, wb_re, wb_im);
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

// n floats (n % 4 == 0) from src into shared memory at dst (16-byte
// aligned): 16-byte cp.async when src is aligned, else plain loads.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int tid, int nt) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int q = tid; q < n / 4; q += nt)
            cp_async16(dst + 4 * q, src + 4 * q);
    } else {
        for (int i = tid; i < n; i += nt) dst[i] = src[i];
    }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of a shared::cta address in block `rank`
// of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r)
                 : "r"(a), "r"(rank));
    return r;
}

// Four floats into another block's shared memory, completing on its
// mbarrier.
__device__ __forceinline__ void push4(unsigned dst, float a, float b, float c,
                                      float d, unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
        "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
        : "memory");
}

// Whether the mbarrier's phase `parity` has completed (a bounded wait),
// with the data of the pushes that completed it visible.
__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// The result of bin i: scale · sum, blended into prev when given.
__device__ __forceinline__ float psd_out(float sum, int i, float scale,
                                         const float* prev, float alpha) {
    const float out = sum * scale;
    return prev == nullptr ? out : prev[i] + alpha * (out - prev[i]);
}

// Block f reads frame f: frame j = f % fb of group g = f / fb, whose
// element (a, b) is x[g·group_stride + j·frame_stride + a·row_stride +
// b] (real) and the same plus im_off (imaginary); fb = 1 and
// group_stride = frame_stride read consecutive frames.  win [A·B] is
// null when the frames arrive windowed.  Blocks past `frames` (the last
// cluster's padding) add nothing.
//
// The frame sum: block `rank` of a cluster owns bins [rank·N/8,
// (rank+1)·N/8) in (k1, k2) order.  Every block pushes each owner its
// slice of |X|² (st.async into the owner's receive rows, one per rank,
// completing on the owner's mbarrier); the owner adds its rows in rank
// order.  With one cluster that is the result (scale, then the blend
// with prev); with more, each owner writes its slice of the cluster's
// partial to part [clusters, A·B], and the last owner of a slice to
// arrive (an integer counter, count[rank], reset for the next launch)
// adds the partials in cluster order.  No float atomics: the order of
// every sum is fixed.
template <typename T, int A, int B>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(fft_threads(A * B))
psd_frames(const T* __restrict__ x, float in_gain,
           const float* __restrict__ win, size_t frame_stride,
           size_t row_stride, size_t im_off, int fb, size_t group_stride,
           int frames, const float* __restrict__ wa_re,
           const float* __restrict__ wa_im, const float* __restrict__ wb_re,
           const float* __restrict__ wb_im, const float* __restrict__ tw_re,
           const float* __restrict__ tw_im, float* __restrict__ part,
           unsigned* __restrict__ count, float* __restrict__ psd,
           float scale, const float* __restrict__ prev, float alpha) {
    constexpr int N = A * B, NT = fft_threads(N), ST = B + 1;
    constexpr int SLICE = N / CLUSTER;
    extern __shared__ __align__(16) unsigned char fft_smem[];
    float2* s = reinterpret_cast<float2*>(fft_smem);
    const float* pw = reinterpret_cast<const float*>(fft_smem);
    // |X|² [A][B + 1] fills the lower half of the frame at the end, the
    // receive rows [CLUSTER][SLICE] take the upper half; after the frame
    // come the mbarrier and a flag, then W_A^n and W_B^n
    float* recv = reinterpret_cast<float*>(fft_smem) + A * ST;
    uint64_t* bar =
        reinterpret_cast<uint64_t*>(fft_smem + psd_frame_bytes(A, B));
    int* last = reinterpret_cast<int*>(bar + 1);
    float* wa = reinterpret_cast<float*>(bar + 2);
    float* wb = wa + 2 * A;
    const int fr = blockIdx.x;
    const int tid = threadIdx.x;
    const int rank = fr % CLUSTER;
    const int valid = min(CLUSTER, frames - (fr - rank));
    const unsigned bar_a = smem_u32(bar);
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (fr < frames) {
        const T* xf = x + (size_t)(fr / fb) * group_stride +
                      (size_t)(fr % fb) * frame_stride;
        T* raw = reinterpret_cast<T*>(fft_smem);
        constexpr int CPR = B * (int)sizeof(T) / 16;   // chunks a row
        const bool vec =
            ((reinterpret_cast<uintptr_t>(xf) |
              (row_stride * sizeof(T)) | (im_off * sizeof(T))) & 15) == 0;
        if (vec) {
            for (int q = tid; q < 2 * A * CPR; q += NT) {
                const int row = q / CPR;                // plane·A + a
                const T* g = xf + (row / A) * im_off +
                             (size_t)(row % A) * row_stride +
                             (q % CPR) * (16 / (int)sizeof(T));
                cp_async16(raw + (size_t)q * (16 / sizeof(T)), g);
            }
        } else {
            for (int q = tid; q < 2 * N; q += NT) {
                const int row = q / B;
                raw[q] = xf[(row / A) * im_off +
                            (size_t)(row % A) * row_stride + q % B];
            }
        }
        stage(wa, wa_re, A, tid, NT);
        stage(wa + A, wa_im, A, tid, NT);
        stage(wb, wb_re, B, tid, NT);
        stage(wb + B, wb_im, B, tid, NT);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        dft_a<T, A, B, 0>(RawLoad<T, A, B>{raw, in_gain, win}, s, wa,
                          wa + A, tw_re, tw_im);
        dft_b<A, B, 0>(s, wb, wb + B);
    }
    // no block pushes before every block's FFT is done and its mbarrier
    // set
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (fr < frames) {
        // four bins a push: bin i goes to row `rank` of owner i / SLICE
        for (int q = tid; q < N / 4; q += NT) {
            const int i = 4 * q, o = i / SLICE;
            const float* p = pw + (i / B) * ST + i % B;
            push4(cluster_addr(smem_u32(recv + rank * SLICE + i % SLICE), o),
                  p[0], p[1], p[2], p[3], cluster_addr(bar_a, o));
        }
    }
    if (tid == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                bar_a),
            "r"(valid * SLICE * (int)sizeof(float))
            : "memory");
    for (unsigned k = 0; !mbar_try(bar_a, 0); ++k)
        if (k == (1u << 22)) __trap();   // a push never came: fail, not hang
    // no block exits before every push into every block has landed
    // (the wait comes last, on every path out)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    auto leave = [] {
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    };
    const int parts = gridDim.x / CLUSTER;
    for (int i = tid; i < SLICE; i += NT) {
        float acc = 0.0f;
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r)
            if (r < valid) acc += recv[r * SLICE + i];
        const int bin = rank * SLICE + i;
        if (parts == 1)
            psd[bin] = psd_out(acc, bin, scale, prev, alpha);
        else
            part[(size_t)(fr / CLUSTER) * N + bin] = acc;
    }
    if (parts == 1) return leave();
    // the last owner of this slice to finish adds the partials
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(count + rank, 1u) == (unsigned)parts - 1;
    __syncthreads();
    if (!*last) return leave();
    __threadfence();
    for (int i = tid; i < SLICE; i += NT) {
        const int bin = rank * SLICE + i;
        float acc = 0.0f;
        for (int c = 0; c < parts; ++c)
            acc += __ldcg(part + (size_t)c * N + bin);
        psd[bin] = psd_out(acc, bin, scale, prev, alpha);
    }
    if (tid == 0) count[rank] = 0;
    leave();
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

// Launch the FFT stages for F frames of one shape on stream s (frames
// in groups of fb, group_stride apart: 0 means consecutive; prev null:
// no blend; part [psd_parts(F), A·B] floats and count [CLUSTER], zero
// before the launch and after it, read when F > CLUSTER); returns the
// error of a refused shared-memory request, else cudaSuccess (launch
// errors are read by the caller with cudaGetLastError()).
template <typename T, int A, int B>
cudaError_t launch_psd(const T* x, float in_gain, const float* win,
                       size_t frame_stride, size_t row_stride, size_t im_off,
                       const float* wa_re, const float* wa_im,
                       const float* wb_re, const float* wb_im,
                       const float* tw_re, const float* tw_im, float* part,
                       unsigned* count, float* psd, int F, float scale,
                       cudaStream_t s, int fb = 1, size_t group_stride = 0,
                       const float* prev = nullptr, float alpha = 1.0f) {
    if (group_stride == 0) group_stride = frame_stride * fb;
    constexpr size_t smem = psd_frames_smem(A, B);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            psd_frames<T, A, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    psd_frames<T, A, B><<<psd_parts(F) * CLUSTER, fft_threads(A * B), smem,
                          s>>>(
        x, in_gain, win, frame_stride, row_stride, im_off, fb, group_stride,
        F, wa_re, wa_im, wb_re, wb_im, tw_re, tw_im, part, count, psd, scale,
        prev, alpha);
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
                         const float* tw_im, float* part, unsigned* count,
                         float* psd, int B, int F, float scale,
                         cudaStream_t s, int fb, size_t group_stride,
                         const float* prev, float alpha) {
#define SD_PSD_B(BB)                                                      \
    case BB:                                                              \
        return launch_psd<T, A, BB>(x, in_gain, win, frame_stride,        \
                                    row_stride, im_off, wa_re, wa_im,     \
                                    wb_re, wb_im, tw_re, tw_im, part,     \
                                    count, psd, F, scale, s, fb,          \
                                    group_stride, prev, alpha);
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
                           unsigned* count, float* psd, int A, int B, int F,
                           float scale, cudaStream_t s, int fb = 1,
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
                                   wb_re, wb_im, tw_re, tw_im, part,      \
                                   count, psd, B, F, scale, s, fb,        \
                                   group_stride, prev, alpha);
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
