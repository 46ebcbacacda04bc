// Channelizer stages shared by the v2 FM kernel (channelizer2.cu), the v1
// FM kernel (channelizer.cu), the raw bank (rawbank.cu) and the audio bank
// (audio.cu).
//
//   tc::chan_rot_disc_tc, tc::raw_rot_tc  the tensor-core core (3xTF32
//                  wgmma, end of this file): kernel2's and the v1 kernel's
//                  channelize, rotate and discriminate against the
//                  previous rotated row -> f [M, C] and its last row; the
//                  raw bank's channelize and rotate, with raw_rot's
//                  epilogue
//   audio_fir      banded decimating FIR over [ftail_in | f], or over f
//                  with zeros before the block -> audio [M/Da, C]
//   tail_copy      the last T rows of [tail | x]: the carried FIR tail of
//                  a block, however many rows the block has
//   raw_rot        channelize and rotate (cos/sin) with no demodulation,
//                  plus power partials of up to 64 rows inside one time
//                  tile: the audio bank (audio.cu)
//
// Two rotators, as the TPU kernel has them (channelizer2.py:153-183):
//   TABLE   e^{-jmθ} = Q[m/64]·R[m%64], both tables float64-built on the
//           host (snapped grid, m_tile % 64 == 0);
//   cos/sin ph = φ0[mi] + m_local·θ in float32 with one start phase per
//           time tile of mt rows, then cos and -sin of ph.  The phase
//           reaches mt·2π rad, where one float32 rounding step is ~1e-3
//           rad at mt = 2048, so it is an explicit __fmaf_rn (one
//           rounding, as the plain version's exact float64 value rounded
//           once), and sincosf (not __sinf/__cosf) reduces the argument
//           accurately.  No fast-math flag.
//
// raw_rot (the audio bank) runs the product on the float32 CUDA cores
// (below); every other stage's product runs on the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ops.cuh"

namespace chan {

constexpr int K = 64;        // taps per window
constexpr int TM = 64;       // rows per block
constexpr int TC = 64;       // channels per block
constexpr int KC = 32;       // taps per shared-memory chunk
constexpr int XS = KC + 1;   // padded row stride of the x chunk
constexpr int MAX_KA = 256;  // audio taps held in shared memory

// Banded decimating audio FIR:
//   audio[j, c] = Σ_t a[t] · f_ext[j·Da − t + Ka − 1, c],
//   f_ext = [ftail_in (Ka−1 rows) | f (M rows)], or zeros before f
//   when TAIL is false (the v1 kernel's global banded matrix)
// the indexing of the reference's banded matrices.
//
// Bound: bytes.  2·Ka·(M/Da)·C flops (34 MFLOP at the bench) against the
// 32 MiB f scratch read once (each f row feeds Ka/Da audio rows; the
// repeats hit L2).  Design: one thread per output, consecutive threads
// on consecutive channels so every tap's row read is one coalesced line.
template <bool BF16, bool TAIL>
__global__ void __launch_bounds__(256)
audio_fir(const float* __restrict__ f, const float* __restrict__ ftail_in,
          const float* __restrict__ ataps, void* __restrict__ audio,
          int M, int C, int ka, int da) {
    __shared__ float taps[MAX_KA];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < ka; i += blockDim.x * blockDim.y) taps[i] = ataps[i];
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (c >= C || j >= M / da) return;
    float acc = 0.0f;
    for (int t = 0; t < ka; ++t) {
        const int row = j * da - t + ka - 1;
        float v;
        if (row >= ka - 1)
            v = f[(size_t)(row - (ka - 1)) * C + c];
        else
            v = TAIL ? ftail_in[(size_t)row * C + c] : 0.0f;
        acc += taps[t] * v;
    }
    if (BF16) {
        // round to nearest even, as astype(bfloat16) does
        static_cast<__nv_bfloat16*>(audio)[(size_t)j * C + c] =
            __float2bfloat16_rn(acc);
    } else {
        static_cast<float*>(audio)[(size_t)j * C + c] = acc;
    }
}

// The carried tail of a block: out[r] = ext[n + r] over
// ext = [tail (T rows) | x (n rows)], r < T.  With n >= T it is the last
// T rows of x; with n < T it starts inside the old tail.
__global__ void tail_copy(const float* __restrict__ tail,
                          const float* __restrict__ x,
                          float* __restrict__ out, int T, int n, int C) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= T * C) return;
    const int r = k / C, c = k % C;
    const int e = n + r;
    out[k] = e < T ? tail[(size_t)e * C + c] : x[(size_t)(e - T) * C + c];
}

// Row blocks of raw_rot per m-tile (host and device: the power passes
// sum that many partials per tile).
__host__ __device__ inline int raw_groups(int mt) {
    return (mt + TM - 1) / TM;
}

// Channelize and rotate with no demodulation, the raw bank's stage and the
// audio bank's first one: Y = Xw·H (K taps, any K, in chunks of KC), row m
// of m-tile mi times e^{-j(φ0[mi] + m_local·θ_c)} (the phase an explicit
// __fmaf_rn, rounded once) -> y_re, y_im [M, C].  Each m-tile is covered
// by gpt = ceil(mt/64) row blocks, the last one ragged when 64 does not
// divide mt, so no block straddles two tiles: block (mi, g) holds rows
// mi·mt + 64g .. min(+64, (mi+1)·mt) and writes Σ |y|² of its rows per
// channel to pow_part [M/mt·gpt, C], row mi·gpt + g.  mt | M.
template <typename T>
__global__ void __launch_bounds__(256)
raw_rot(const T* __restrict__ xr, const T* __restrict__ xi, float in_gain,
        const float* __restrict__ h_re, const float* __restrict__ h_im,
        const float* __restrict__ theta, const float* __restrict__ phi0,
        float* __restrict__ y_re, float* __restrict__ y_im,
        float* __restrict__ pow_part, int M, int C, int K, int mt) {
    __shared__ float xs_re[TM * XS];
    __shared__ float xs_im[TM * XS];
    __shared__ float hs_re[KC * TC];
    __shared__ float hs_im[KC * TC];
    __shared__ float red[16 * TC];

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int c0 = blockIdx.x * TC;
    const int gpt = raw_groups(mt);
    const int mi = blockIdx.y / gpt;
    const int m0 = mi * mt + (blockIdx.y % gpt) * TM;
    const int m_end = (mi + 1) * mt;      // rows from here are the next tile's

    float acc_re[4][4], acc_im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
        for (int i = tid; i < TM * KC; i += 256) {
            const int lr = i / KC, kk = i % KC;
            const int k = k0 + kk;
            const bool in = k < K && m0 + lr < m_end;
            const size_t at = (size_t)(m0 + lr) * K + k;
            xs_re[lr * XS + kk] = in ? deq(xr[at], in_gain) : 0.0f;
            xs_im[lr * XS + kk] = in ? deq(xi[at], in_gain) : 0.0f;
        }
        for (int i = tid; i < KC * TC; i += 256) {
            const int kk = i / TC, c = c0 + i % TC;
            const bool in = c < C && k0 + kk < K;
            hs_re[i] = in ? h_re[(size_t)(k0 + kk) * C + c] : 0.0f;
            hs_im[i] = in ? h_im[(size_t)(k0 + kk) * C + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            float ar[4], ai[4], br[4], bi[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ar[i] = xs_re[(ty * 4 + i) * XS + kk];
                ai[i] = xs_im[(ty * 4 + i) * XS + kk];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                br[j] = hs_re[kk * TC + tx + 16 * j];
                bi[j] = hs_im[kk * TC + tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc_re[i][j] += ar[i] * br[j] - ai[i] * bi[j];
                    acc_im[i][j] += ar[i] * bi[j] + ai[i] * br[j];
                }
        }
        __syncthreads();
    }

    // rotate: ph = φ0[mi] + m_local·θ, rounded once
    float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= C) continue;
        const float th = theta[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty * 4 + i;
            if (m >= m_end) continue;
            const float ml = static_cast<float>(m - mi * mt);
            const float ph = __fmaf_rn(ml, th, phi0[(size_t)mi * C + c]);
            float sn, cs;
            sincosf(ph, &sn, &cs);
            const float ci = -sn;
            const float yr = acc_re[i][j], yi = acc_im[i][j];
            const float rr = yr * cs - yi * ci;
            const float ri = yr * ci + yi * cs;
            y_re[(size_t)m * C + c] = rr;
            y_im[(size_t)m * C + c] = ri;
            psum[j] += rr * rr + ri * ri;
        }
    }
    // the block's rows per channel, summed in row-group order
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * TC + tx + 16 * j] = psum[j];
    __syncthreads();
    if (tid < TC && c0 + tid < C) {
        float s = 0.0f;
        for (int g = 0; g < 16; ++g) s += red[g * TC + tid];
        pow_part[(size_t)blockIdx.y * C + c0 + tid] = s;
    }
}

// Launch tail_copy on stream s: out [T, C] = the last T rows of
// [tail (T rows) | x (n rows)].
inline void launch_tail(const float* tail, const float* x, float* out, int T,
                        int n, int C, cudaStream_t s) {
    const int total = T * C;
    tail_copy<<<(total + 255) / 256, 256, 0, s>>>(tail, x, out, T, n, C);
}

// The grid of raw_rot over M rows.
inline dim3 raw_grid(int M, int C, int mt) {
    return dim3((C + TC - 1) / TC, (M / mt) * raw_groups(mt));
}

// Launch audio_fir on stream s (ftail_in null: zeros before the block).
inline void launch_audio(const float* f, const float* ftail_in,
                         const float* ataps, void* audio, bool bf16, int M,
                         int C, int ka, int da, cudaStream_t s) {
    const dim3 block(64, 4);
    const dim3 grid((C + 63) / 64, (M / da + 3) / 4);
    if (ftail_in == nullptr)
        audio_fir<false, false><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                       audio, M, C, ka, da);
    else if (bf16)
        audio_fir<true, true><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                     audio, M, C, ka, da);
    else
        audio_fir<false, true><<<grid, block, 0, s>>>(f, ftail_in, ataps,
                                                      audio, M, C, ka, da);
}

// ---------------------------------------------------------------------
// The tensor-core channelize core (Hopper wgmma), the raw bank's
// (rawbank.cu), kernel2's (channelizer2.cu) and the v1 kernel's
// (channelizer.cu) first stage.
//
// The complex product Y = Xw·H is one real GEMM:
//   A = [xr | xi]                      [M, 2Kp]
//   B = [[h_re, h_im], [−h_im, h_re]]  [2Kp, 2C], columns interleaved as
//       (re, im) per channel, so the two adjacent accumulator columns a
//       thread holds are one channel's Y_re and Y_im;
// Kp is K rounded up to a multiple of 8 (zero taps).  wgmma's .tf32 form
// takes B only K-major, so the wrappers build B once, transposed, as
// bmat [2C, 2Kp] float32 (channelizer2.py / rawbank.py tc_bmat).
//
// Accuracy: 3xTF32.  Single-pass TF32 keeps ~11 significant bits, short
// of the raw bank's 1e-5 and the discriminator's tolerances.  Each
// operand v splits into hi = rna_tf32(v) and lo = rna_tf32(v − hi);
// the sum of lo·hi + hi·lo + hi·hi accumulates in float32 and misses
// only lo·lo, ~2^-22 of each product.  An int8 or int16 window times
// the power-of-two gain (1/64, 1/4096) is exact in two parts.  The
// window is dequantized before the split, as the plain version does
// (with a power-of-two gain the order changes no bit).
//
// Bound: the product, 3 passes × 8·M·K·C flops on the TF32 tensor cores
// (12.9 GFLOP, 0.026 ms at 495 TFLOP/s for M 8192, K 64, C 1024), beside
// the bytes of the windows read and the outputs written.  Design:
// - a block owns one tile of TCH = 32 channels, so its B slice (64 rows
//   × 2Kp, hi and lo: 64 KiB at K 64) is split once and stays resident
//   in shared memory, laid out as wgmma's no-swizzle K-major core
//   matrices (8 rows × 16 bytes);
// - three warpgroups walk the block's row tiles of 64, each its own, so
//   that one's epilogue overlaps another's product; the grid is sized to
//   the SMs (one block each: ~174 KiB of shared memory at K 64).  The
//   epilogue is latency-bound (table loads, sincosf, atan2), so the
//   warps an SM holds set its pace: 32 channels and three warpgroups
//   keep 12 warps on an SM (64 channels and two kept 8, four
//   warpgroups of 32 channels spill under the 128 registers a thread);
// - a warpgroup stages a tile's windows, dequantized, into shared memory
//   with a row stride ≡ 16 (mod 32) floats, so the float4 loads of its
//   wgmma A fragments (registers) are free of bank conflicts, splits
//   them into hi/lo in registers and issues 3 wgmma m64n64k8 a k-step
//   (each pair of k-steps into a fresh accumulator, added in float32);
//   at K 64 each thread loads its 16-byte chunks of the next tile into
//   registers before this tile's epilogue, so the loads fly under it;
// - the epilogue stays on the CUDA cores: the accumulators go to a Y
//   tile in the same staging memory, then each warp takes a group of
//   rows over the block's 32 channels to rotate, discriminate or sum
//   powers, and stores coalesced rows.
// The warpgroups load their windows themselves rather than through a
// producer warp's TMA ring: the A fragments need the padded layout
// above, which a bulk copy cannot write, and a tiled TMA map needs
// 16-byte row strides (K·size % 16), which K 5 does not have.
// kernel2's tiles overlap by one row (63 new rows a tile): row 0 is the
// previous row the discriminator needs, computed by the same tensor-core
// product, so there is no CUDA-core halo and no order between tiles.
namespace tc {

constexpr int TCH = 32;            // channels a block
constexpr int NB = 2 * TCH;        // B rows a block (re, im per channel)
constexpr int NG = NB / 8;         // core-matrix row groups
constexpr int TR = 64;             // rows a tile (one wgmma M)
constexpr int WG = 3;              // warpgroups a block
constexpr int THREADS = 128 * WG;
constexpr int RG = 128 / TCH;      // epilogue row groups: one warp each
constexpr int NACC = NB / 2;       // accumulator registers a thread
constexpr int YS = TCH + 4;        // Y tile row stride: 4g + t banks
constexpr size_t SMEM_MAX = 232448;

__host__ __device__ constexpr int kpad(int k) { return (k + 7) & ~7; }

// staging row stride (floats) of 2·kp values, ≡ 16 mod 32
__host__ __device__ constexpr int stage_stride(int kp) {
    return (2 * kp) % 32 == 0 ? 2 * kp + 16 : 2 * kp;
}

__host__ __device__ constexpr int stage_floats(int kp) {
    return TR * stage_stride(kp) > 2 * TR * YS ? TR * stage_stride(kp)
                                               : 2 * TR * YS;
}

// dynamic shared memory of a block: B hi and lo, a staging area and
// power-reduction rows per warpgroup
__host__ __device__ constexpr size_t smem_bytes(int kp) {
    return sizeof(float) * (2 * (size_t)NB * 2 * kp +
                            WG * ((size_t)stage_floats(kp) + RG * TCH));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// offset between the two 16-byte K chunks of a k-step (LBO) and between
// 8-row groups (SBO), each in 16-byte units
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo,
                                         unsigned sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the warpgroup's own barrier (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// d[64x64] = A[64x8] (registers) · B[8x64] (shared memory) + (keep ?
// d : 0), TF32 products summed into float32
__device__ __forceinline__ void mma_k8(float (&d)[NACC], const uint32_t* a,
                                       uint64_t b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// Shared-memory float offset of B element (row n, logical k kk) in the
// core-matrix layout: chunk kk/4 of NG row groups of 8 rows × 4 values.
__device__ __forceinline__ int b_off(int n, int kk) {
    return ((kk >> 2) * NG + (n >> 3)) * 32 + (n & 7) * 4 + (kk & 3);
}

// The contraction column of bmat that logical column kk = 8s + q holds.
// A thread's fragment of k-step s is (col q, col q + 4) = (t, t + 4); one
// float4 of a staged row at 16·(s/2) + 4t serves steps s and s + 1, so
// logical (s, q) reads staged column 16·(s/2) + 4·(q%4) + 2·(s%2) + q/4.
__device__ __forceinline__ int b_col(int kk) {
    const int s = kk >> 3, q = kk & 7;
    return 16 * (s >> 1) + 4 * (q & 3) + 2 * (s & 1) + (q >> 2);
}

// The block's B slice (channels c0 .. c0+TCH-1) into shared memory, split
// into hi and lo.  All threads.
__device__ __forceinline__ void load_b(float* bh, float* bl,
                                       const float* __restrict__ bmat,
                                       int c0, int C, int kp) {
    const int w = 2 * kp;
    for (int i = threadIdx.x; i < NB * w; i += THREADS) {
        const int n = i / w, kk = i - (i / w) * w;
        const int row = 2 * c0 + n;
        const float v = row < 2 * C ? bmat[(size_t)row * w + b_col(kk)]
                                    : 0.0f;
        const uint32_t hi = tf32_rna(v);
        const float lo = v - __uint_as_float(hi);
        bh[b_off(n, kk)] = __uint_as_float(hi);
        bl[b_off(n, kk)] = __uint_as_float(tf32_rna(lo));
    }
    // wgmma reads B through the async proxy: make these stores visible
    // to it (before the block barrier that follows)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Tile rows p < 64 (window row m_base + p, zeros outside [m_lo, m_hi))
// into the warpgroup's staging area: columns [0, kp) the real plane,
// [kp, 2kp) the imaginary one, zeros past K.
template <typename T, int KP>
__device__ __forceinline__ void stage_rows(float* st,
                                           const T* __restrict__ xr,
                                           const T* __restrict__ xi,
                                           float in_gain, int K, int kp_rt,
                                           int m_base, int m_lo, int m_hi,
                                           int tid) {
    const int kp = KP ? KP : kp_rt;
    const int w = 2 * kp, rs = stage_stride(kp);
    for (int i = tid; i < TR * w; i += 128) {
        const int p = i / w, j = i - (i / w) * w;
        const int m = m_base + p;
        const int im = j >= kp;
        const int k = j - im * kp;
        float v = 0.0f;
        if (m >= m_lo && m < m_hi && k < K)
            v = deq((im ? xi : xr)[(size_t)m * K + k], in_gain);
        st[p * rs + j] = v;
    }
}

// The staging of K 64 windows from 16-byte aligned planes: each thread
// loads its N 16-byte chunks of a tile at once (into registers, so the
// next tile's loads fly during this tile's epilogue), then converts them
// into the staging area.  Chunk q of a tile: plane q / (TR·CPR), row
// (q / CPR) % TR, chunk q % CPR of the row; consecutive threads read
// consecutive 16 bytes.
template <typename T>
struct VecStage {
    static constexpr int PER = 16 / sizeof(T);     // values a chunk
    static constexpr int CPR = 64 / PER;           // chunks a row and plane
    static constexpr int N = 2 * TR * CPR / 128;   // chunks a thread
    uint4 v[N];

    __device__ __forceinline__ void load(const T* __restrict__ xr,
                                         const T* __restrict__ xi,
                                         int m_base, int m_lo, int m_hi,
                                         int tid) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int q = tid + 128 * j;
            const int plane = q / (TR * CPR);
            const int r = (q / CPR) % TR, c = q % CPR;
            const int m = m_base + r;
            v[j] = make_uint4(0u, 0u, 0u, 0u);
            if (m >= m_lo && m < m_hi)
                v[j] = __ldg(reinterpret_cast<const uint4*>(
                    (plane ? xi : xr) + (size_t)m * 64 + c * PER));
        }
    }

    __device__ __forceinline__ void store(float* st, float in_gain,
                                          int tid) const {
        constexpr int rs = stage_stride(64);
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int q = tid + 128 * j;
            const int plane = q / (TR * CPR);
            const int r = (q / CPR) % TR, c = q % CPR;
            const T* e = reinterpret_cast<const T*>(&v[j]);
            float* dst = st + r * rs + plane * 64 + c * PER;
#pragma unroll
            for (int i = 0; i < PER; i += 4)
                *reinterpret_cast<float4*>(dst + i) = make_float4(
                    deq(e[i], in_gain), deq(e[i + 1], in_gain),
                    deq(e[i + 2], in_gain), deq(e[i + 3], in_gain));
        }
    }
};

// One k-step pair's A fragments from the staged rows: hi and lo of
// steps 2·s2 and 2·s2 + 1 (4 registers each).
__device__ __forceinline__ void frag_pair(const float* st, int rs, int s2,
                                          int lane, int warp,
                                          uint32_t (&hi)[8],
                                          uint32_t (&lo)[8]) {
    const int g = lane >> 2, t = lane & 3;
    const float4 u = *reinterpret_cast<const float4*>(
        st + (16 * warp + g) * rs + 16 * s2 + 4 * t);
    const float4 v = *reinterpret_cast<const float4*>(
        st + (16 * warp + g + 8) * rs + 16 * s2 + 4 * t);
    // fragment order (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    const float f[8] = {u.x, v.x, u.y, v.y, u.z, v.z, u.w, v.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        hi[i] = tf32_rna(f[i]);
        lo[i] = tf32_rna(f[i] - __uint_as_float(hi[i]));
    }
}

// The three passes of one k-step pair into acc, from zero: the small
// products (lo·hi, hi·lo) of both steps first, then hi·hi.
__device__ __forceinline__ void mma_pair(float (&acc)[NACC],
                                         const uint32_t* hi,
                                         const uint32_t* lo, unsigned bh,
                                         unsigned bl, int s2) {
    // k-step s = 2·s2 + h reads B chunks 2s and 2s + 1
    const unsigned off0 = 2 * s2 * 2 * NG * 128;
    const unsigned off1 = off0 + 2 * NG * 128;
    const uint64_t h0 = desc(bh + off0, NG * 128, 128);
    const uint64_t h1 = desc(bh + off1, NG * 128, 128);
    wg_fence();
    mma_k8(acc, lo, h0, 0);
    mma_k8(acc, hi, desc(bl + off0, NG * 128, 128), 1);
    mma_k8(acc, lo + 4, h1, 1);
    mma_k8(acc, hi + 4, desc(bl + off1, NG * 128, 128), 1);
    mma_k8(acc, hi, h0, 1);
    mma_k8(acc, hi + 4, h1, 1);
    wg_commit();
}

// d = the staged tile's 64 rows times the block's B slice.  Each k-step
// pair sums into a fresh tensor-core accumulator, which is then added
// to d in float32 on the CUDA cores: the tensor cores align and
// truncate each product sum to the accumulator's magnitude, so a long
// chain of them (48 products of 8 at K 64) drifts far enough to flip
// the discriminator's branch on noise channels, where pair sums added
// in float32 round like a float32 loop.
// The next pair's fragments load while the current pair runs.
template <int KP>
__device__ __forceinline__ void product(float (&d)[NACC], const float* st,
                                        unsigned bh, unsigned bl, int kp_rt,
                                        int tid) {
    const int kp = KP ? KP : kp_rt;
    const int rs = stage_stride(kp), pairs = kp / 8;
    const int lane = tid & 31, warp = tid >> 5;
    float acc[NACC];
    uint32_t hi[2][8], lo[2][8];
    auto add = [&]() {
        wg_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int i = 0; i < NACC; ++i) d[i] += acc[i];
    };
#pragma unroll
    for (int i = 0; i < NACC; ++i) d[i] = 0.0f;
    frag_pair(st, rs, 0, lane, warp, hi[0], lo[0]);
#pragma unroll
    for (int s2 = 0; s2 < pairs; s2 += 2) {
        mma_pair(acc, hi[0], lo[0], bh, bl, s2);
        if (s2 + 1 < pairs)
            frag_pair(st, rs, s2 + 1, lane, warp, hi[1], lo[1]);
        add();
        if (s2 + 1 < pairs) {
            mma_pair(acc, hi[1], lo[1], bh, bl, s2 + 1);
            if (s2 + 2 < pairs)
                frag_pair(st, rs, s2 + 2, lane, warp, hi[0], lo[0]);
            add();
        }
    }
}

// The accumulators into the Y tile: ys_re / ys_im [64, YS], channel
// 4j + t of rows 16·warp + g and + 8 from registers 4j .. 4j + 3.
__device__ __forceinline__ void acc_to_tile(const float (&d)[NACC],
                                            float* ys_re, float* ys_im,
                                            int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int p = 16 * warp + g;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
        const int cc = 4 * j + t;
        ys_re[p * YS + cc] = d[4 * j];
        ys_im[p * YS + cc] = d[4 * j + 1];
        ys_re[(p + 8) * YS + cc] = d[4 * j + 2];
        ys_im[(p + 8) * YS + cc] = d[4 * j + 3];
    }
}

// The block's shared memory: B hi, B lo, then per warpgroup its staging
// area and its power row.
struct Smem {
    float* bh;
    float* bl;
    float* st;
    float* red;
};

__device__ __forceinline__ Smem carve(float* base, int kp, int wg) {
    Smem s;
    s.bh = base;
    s.bl = s.bh + NB * 2 * kp;
    float* own = s.bl + NB * 2 * kp +
                 (size_t)wg * (stage_floats(kp) + RG * TCH);
    s.st = own;
    s.red = own + stage_floats(kp);
    return s;
}

// Raw bank: channelize and rotate (cos/sin of φ0[mi] + m_local·θ, the
// phase one __fmaf_rn), as raw_rot computes it -> y_re, y_im [M, C];
// tile i is row block (mi, g) of raw_rot's grid (rows mi·mt + 64g ..
// min(+64, (mi+1)·mt)) and writes Σ |y|² of its rows to pow_part row i.
template <typename T, int KP>
__global__ void __launch_bounds__(THREADS, 1)
raw_rot_tc(const T* __restrict__ xr, const T* __restrict__ xi,
           float in_gain, const float* __restrict__ bmat,
           const float* __restrict__ theta, const float* __restrict__ phi0,
           float* __restrict__ y_re, float* __restrict__ y_im,
           float* __restrict__ pow_part, int M, int C, int K, int kp_rt,
           int mt, bool vec) {
    extern __shared__ __align__(1024) float tc_smem[];
    const int kp = KP ? KP : kp_rt;
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int c0 = blockIdx.x * TCH;
    const Smem sm = carve(tc_smem, kp, wg);
    load_b(sm.bh, sm.bl, bmat, c0, C, kp);
    __syncthreads();
    const unsigned bh = smem_u32(sm.bh), bl = smem_u32(sm.bl);
    const int gpt = raw_groups(mt);
    const int n_tiles = (M / mt) * gpt;
    float* ys_re = sm.st;
    float* ys_im = sm.st + TR * YS;
    const int cc = tid % TCH, grp = tid / TCH;
    const int c = c0 + cc;
    const float th = c < C ? theta[c] : 0.0f;
    float d[NACC];
    VecStage<T> pre;
    const int first = blockIdx.y * WG + wg, step = gridDim.y * WG;
    auto rows = [&](int i, int& mi, int& m0, int& m_end) {
        mi = i / gpt;
        m0 = mi * mt + (i - mi * gpt) * TR;
        m_end = min(m0 + TR, (mi + 1) * mt);
    };
    if (vec && first < n_tiles) {
        int mi, m0, m_end;
        rows(first, mi, m0, m_end);
        pre.load(xr, xi, m0, m0, m_end, tid);
    }
    for (int i = first; i < n_tiles; i += step) {
        int mi, m0, m_end;
        rows(i, mi, m0, m_end);
        if (vec)
            pre.store(sm.st, in_gain, tid);
        else
            stage_rows<T, KP>(sm.st, xr, xi, in_gain, K, kp, m0, m0, m_end,
                              tid);
        wg_sync(wg);
        product<KP>(d, sm.st, bh, bl, kp, tid);
        wg_sync(wg);
        acc_to_tile(d, ys_re, ys_im, tid);
        wg_sync(wg);
        if (vec && i + step < n_tiles) {
            int ni, n0, n_end;
            rows(i + step, ni, n0, n_end);
            pre.load(xr, xi, n0, n0, n_end, tid);
        }
        float psum = 0.0f;
        if (c < C) {
            const float ph0 = phi0[(size_t)mi * C + c];
            const int rows_in = min(TR, m_end - m0);
#pragma unroll 4
            for (int p = grp; p < rows_in; p += RG) {
                const int m = m0 + p;
                const float ml = static_cast<float>(m - mi * mt);
                const float ph = __fmaf_rn(ml, th, ph0);
                float sn, cs;
                sincosf(ph, &sn, &cs);
                const float ci = -sn;
                const float yr = ys_re[p * YS + cc], yi = ys_im[p * YS + cc];
                const float rr = yr * cs - yi * ci;
                const float ri = yr * ci + yi * cs;
                y_re[(size_t)m * C + c] = rr;
                y_im[(size_t)m * C + c] = ri;
                psum += rr * rr + ri * ri;
            }
        }
        sm.red[grp * TCH + cc] = psum;
        wg_sync(wg);
        if (grp == 0 && c < C) {
            float tot = sm.red[cc];
#pragma unroll
            for (int k = 1; k < RG; ++k) tot += sm.red[k * TCH + cc];
            pow_part[(size_t)i * C + c] = tot;
        }
        wg_sync(wg);
    }
}

// kernel2's stage (a), and the v1 kernel's (cos/sin, mt = M): channelize,
// rotate (Q[m/64]·R[m%64] or cos/sin of φ0[mi] + m_local·θ), discriminate
// against the previous rotated row (the carried one at m = 0) -> f [M, C],
// last row.  Tile i holds rows m0 − 1 .. m0 + 62, m0 = 63·i, and writes f
// rows m0 .. m0 + 62.
template <typename T, bool TABLE, int KP>
__global__ void __launch_bounds__(THREADS, 1)
chan_rot_disc_tc(const T* __restrict__ xr, const T* __restrict__ xi,
                 float in_gain, const float* __restrict__ bmat,
                 const float* __restrict__ q, const float* __restrict__ r,
                 const float* __restrict__ theta,
                 const float* __restrict__ phi0,
                 const float* __restrict__ prev_re,
                 const float* __restrict__ prev_im, float* __restrict__ f,
                 float* __restrict__ last_re, float* __restrict__ last_im,
                 int M, int C, int K, int kp_rt, int mt, float quad_gain,
                 bool vec) {
    extern __shared__ __align__(1024) float tc_smem[];
    const int kp = KP ? KP : kp_rt;
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int c0 = blockIdx.x * TCH;
    const Smem sm = carve(tc_smem, kp, wg);
    load_b(sm.bh, sm.bl, bmat, c0, C, kp);
    __syncthreads();
    const unsigned bh = smem_u32(sm.bh), bl = smem_u32(sm.bl);
    const int n_tiles = (M + TR - 2) / (TR - 1);
    float* ys_re = sm.st;
    float* ys_im = sm.st + TR * YS;
    const int qs = mt >> 6;
    const int cc = tid % TCH, grp = tid / TCH;
    const int c = c0 + cc;
    const float th = !TABLE && c < C ? theta[c] : 0.0f;
    float d[NACC];
    VecStage<T> pre;
    const int first = blockIdx.y * WG + wg, step = gridDim.y * WG;
    if (vec && first < n_tiles)
        pre.load(xr, xi, (TR - 1) * first - 1, 0, M, tid);
    for (int i = first; i < n_tiles; i += step) {
        const int m0 = (TR - 1) * i;
        if (vec)
            pre.store(sm.st, in_gain, tid);
        else
            stage_rows<T, KP>(sm.st, xr, xi, in_gain, K, kp, m0 - 1, 0, M,
                              tid);
        wg_sync(wg);
        product<KP>(d, sm.st, bh, bl, kp, tid);
        wg_sync(wg);
        acc_to_tile(d, ys_re, ys_im, tid);
        wg_sync(wg);
        if (vec && i + step < n_tiles)
            pre.load(xr, xi, (TR - 1) * (i + step) - 1, 0, M, tid);
        // rotate and discriminate in one pass: the thread's channel over
        // rows [ps, pe] of its row group (0..16, 16..32, 32..48, 48..63),
        // the previous rotated row in registers; row 0 of the first tile
        // is the carried, already rotated, row.  The row's place in its
        // m-tile advances by one a row, without a division.
        constexpr int RR = TR / RG;
        const int ps = grp * RR;
        const int pe = min(grp == RG - 1 ? TR - 1 : ps + RR, M - m0);
        if (c < C && ps <= pe) {
            int m = m0 - 1 + ps;
            int mi = m < 0 ? 0 : m / mt, off = m < 0 ? 0 : m - mi * mt;
            auto rotate = [&](int p, float& rr, float& ri) {
                float cr, ci;
                if (TABLE) {
                    const int g = off >> 6, rw = off & 63;
                    const size_t qr = (size_t)(mi * 2 * qs + g) * C + c;
                    const float qre = q[qr];
                    const float qim = q[qr + (size_t)qs * C];
                    const float rre = r[(size_t)rw * C + c];
                    const float rim = r[(size_t)(64 + rw) * C + c];
                    cr = qre * rre - qim * rim;
                    ci = qre * rim + qim * rre;
                } else {
                    const float ph = __fmaf_rn(static_cast<float>(off), th,
                                               phi0[(size_t)mi * C + c]);
                    float sn, cs;
                    sincosf(ph, &sn, &cs);
                    cr = cs;
                    ci = -sn;
                }
                const float yr = ys_re[p * YS + cc];
                const float yi = ys_im[p * YS + cc];
                rr = yr * cr - yi * ci;
                ri = yr * ci + yi * cr;
                if (++off == mt) {
                    off = 0;
                    ++mi;
                }
            };
            float pr, pi;
            if (m < 0) {
                pr = prev_re[c];
                pi = prev_im[c];
            } else {
                rotate(ps, pr, pi);
            }
#pragma unroll 4
            for (int p = ps + 1; p <= pe; ++p) {
                float rr, ri;
                rotate(p, rr, ri);
                // atan2(Y[m]·conj(Y[m-1]))·quad_gain
                const float dr = rr * pr + ri * pi;
                const float di = ri * pr - rr * pi;
                f[(size_t)(m0 - 1 + p) * C + c] =
                    sd_atan2(di, dr) * quad_gain;
                pr = rr;
                pi = ri;
            }
            if (m0 - 1 + pe == M - 1 && pe > ps) {
                last_re[c] = pr;
                last_im[c] = pi;
            }
        }
        wg_sync(wg);
    }
}

// The grid of a tensor-core stage: channel tiles × row-tile groups, as
// many blocks as SMs (one block an SM) or the channel tiles alone.
inline dim3 grid(int C, int n_tiles) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int ct = (C + TCH - 1) / TCH;
    int groups = sms / ct;
    const int most = (n_tiles + WG - 1) / WG;
    groups = groups < 1 ? 1 : (groups > most ? most : groups);
    return dim3(ct, groups);
}

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Allow kernel k `bytes` of dynamic shared memory (a host call of about
// a microsecond, made before each launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
    return cudaFuncSetAttribute(k,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// Launch raw_rot_tc on stream s (unrolled for Kp 64, a run-time Kp else).
template <typename T>
cudaError_t launch_raw(const T* xr, const T* xi, float in_gain,
                       const float* bmat, const float* theta,
                       const float* phi0, float* y_re, float* y_im,
                       float* pow_part, int M, int C, int K, int mt,
                       cudaStream_t s) {
    const int kp = kpad(K);
    const size_t bytes = smem_bytes(kp);
    if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
    const dim3 g = grid(C, (M / mt) * raw_groups(mt));
    cudaError_t e;
    if (kp == 64) {
        e = allow_smem(raw_rot_tc<T, 64>, bytes);
        if (e != cudaSuccess) return e;
        raw_rot_tc<T, 64><<<g, THREADS, bytes, s>>>(
            xr, xi, in_gain, bmat, theta, phi0, y_re, y_im, pow_part, M, C,
            K, kp, mt, K == 64 && aligned16(xr) && aligned16(xi));
    } else {
        e = allow_smem(raw_rot_tc<T, 0>, bytes);
        if (e != cudaSuccess) return e;
        raw_rot_tc<T, 0><<<g, THREADS, bytes, s>>>(
            xr, xi, in_gain, bmat, theta, phi0, y_re, y_im, pow_part, M, C,
            K, kp, mt, false);
    }
    return cudaSuccess;
}

// Launch chan_rot_disc_tc at K 64 on stream s.
template <typename T, bool TABLE>
cudaError_t launch_chan(const T* xr, const T* xi, float in_gain,
                        const float* bmat, const float* q, const float* r,
                        const float* theta, const float* phi0,
                        const float* prev_re, const float* prev_im, float* f,
                        float* last_re, float* last_im, int M, int C, int mt,
                        float quad_gain, cudaStream_t s) {
    constexpr int kp = 64;
    const size_t bytes = smem_bytes(kp);
    const cudaError_t e = allow_smem(chan_rot_disc_tc<T, TABLE, kp>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 g = grid(C, (M + TR - 2) / (TR - 1));
    chan_rot_disc_tc<T, TABLE, kp><<<g, THREADS, bytes, s>>>(
        xr, xi, in_gain, bmat, q, r, theta, phi0, prev_re, prev_im, f,
        last_re, last_im, M, C, 64, kp, mt, quad_gain,
        aligned16(xr) && aligned16(xi));
    return cudaSuccess;
}

}  // namespace tc

}  // namespace chan
