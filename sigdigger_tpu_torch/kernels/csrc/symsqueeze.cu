// Symbol-rate squeeze of the recovery drain, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/symsqueeze.py::
// _squeeze_kernel.  The TPU kernel sums each group of R rows with a
// block-diagonal 0/1 matmul in chunks, because its toolchain has no
// segmented sum.  Here each output row-group i of R input rows is summed
// directly into all three output planes:
//
//   out_r[i, c] = Σ_{r<R} sr[i·R + r, c] · st[i·R + r, c]
//   out_i[i, c] = Σ_{r<R} si[i·R + r, c] · st[i·R + r, c]
//   out_s[i, c] = Σ_{r<R} st[i·R + r, c]
//
// summed in row order.  Each product is rounded before it is added
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// (plane * st).sum() rounds it, so the two agree bit for bit whenever a
// group holds at most two strobes, which the engine's sps >= R + 1 rule
// guarantees.  No atomics: the result is the same on every run.
//
// Bound: bytes.  3 planes [M, C] read once and 3 planes [M/R, C] written
// once, 2 operations per input element.  Design: R is a template
// parameter (2, 4 and 8, and a generic instantiation with R a runtime
// loop bound), so a thread issues all 3·R loads of its group before the
// first add, as last-use loads (ld.global.lu: each input is read once).
// On the vector path (C % 4 == 0 and every base pointer 16-byte aligned,
// chosen by the host) a thread owns four consecutive columns of one
// row-group: 3·R float4 loads, three float4 stores; consecutive threads
// take consecutive column quads, so every access is a coalesced 16-byte
// one.  The scalar path takes one column per thread for any C and any
// 4-byte aligned view.  Both walk the (row-group, column) items with a
// grid-stride loop over a grid of the SM count times the blocks of 512
// threads an SM holds.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/symsqueeze.py::squeeze_kernel_reference.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float4 mul_rn(float4 a, float4 s) {
    return make_float4(__fmul_rn(a.x, s.x), __fmul_rn(a.y, s.y),
                       __fmul_rn(a.z, s.z), __fmul_rn(a.w, s.w));
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float mul_rn(float a, float s) {
    return __fmul_rn(a, s);
}

__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}

// One row-group of RT rows (RT > 0: all loads first; RT == 0: R rows in
// a runtime loop) of element type V (float4 or float) at `at`, `ld`
// elements of V apart.
template <int RT, typename V>
__device__ __forceinline__ void group_sum(const V* __restrict__ sr,
                                          const V* __restrict__ si,
                                          const V* __restrict__ st,
                                          size_t at, size_t ld, int R,
                                          V& ar, V& ai, V& as) {
    if constexpr (RT > 0) {
        V a[RT], b[RT], s[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            a[r] = __ldlu(sr + at + r * ld);
            b[r] = __ldlu(si + at + r * ld);
            s[r] = __ldlu(st + at + r * ld);
        }
        ar = mul_rn(a[0], s[0]);
        ai = mul_rn(b[0], s[0]);
        as = s[0];
#pragma unroll
        for (int r = 1; r < RT; ++r) {
            ar = add_rn(ar, mul_rn(a[r], s[r]));
            ai = add_rn(ai, mul_rn(b[r], s[r]));
            as = add_rn(as, s[r]);
        }
    } else {
        V s = __ldlu(st + at);
        ar = mul_rn(__ldlu(sr + at), s);
        ai = mul_rn(__ldlu(si + at), s);
        as = s;
        for (int r = 1; r < R; ++r) {
            at += ld;
            s = __ldlu(st + at);
            ar = add_rn(ar, mul_rn(__ldlu(sr + at), s));
            ai = add_rn(ai, mul_rn(__ldlu(si + at), s));
            as = add_rn(as, s);
        }
    }
}

// W columns per item row (C/4 on the vector path, C on the scalar one),
// `rows` output rows; item t is (row t / W, column t % W).
template <int RT, typename V>
__global__ void __launch_bounds__(THREADS)
squeeze(const V* __restrict__ sr, const V* __restrict__ si,
        const V* __restrict__ st, V* __restrict__ out_r,
        V* __restrict__ out_i, V* __restrict__ out_s, int rows, int W,
        int R) {
    // n < 2^31 (the host checks), so the item index and its division
    // stay in 32 bits
    const unsigned n = static_cast<unsigned>(rows) * W;
    const unsigned stride = gridDim.x * THREADS;
    const int rg = RT > 0 ? RT : R;
    for (unsigned t = blockIdx.x * THREADS + threadIdx.x; t < n;
         t += stride) {
        const unsigned i = t / W;
        const size_t at = (size_t)i * rg * W + (t - i * W);
        V ar, ai, as;
        group_sum<RT, V>(sr, si, st, at, W, R, ar, ai, as);
        out_r[t] = ar;
        out_i[t] = ai;
        out_s[t] = as;
    }
}

template <int RT, typename V>
int launch(const float* sr, const float* si, const float* st, float* out_r,
           float* out_i, float* out_s, int rows, int W, int R,
           cudaStream_t s) {
    // resident blocks per SM and SM count, once per device
    static int per_sm[64], sms[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (per_sm[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[dev], squeeze<RT, V>, THREADS, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (per_sm[dev] < 1) per_sm[dev] = 1;
    }
    const size_t n = (size_t)rows * W;
    const size_t need = (n + THREADS - 1) / THREADS;
    const size_t full = (size_t)sms[dev] * per_sm[dev];
    const int grid = static_cast<int>(need < full ? need : full);
    squeeze<RT, V><<<grid, THREADS, 0, s>>>(
        reinterpret_cast<const V*>(sr), reinterpret_cast<const V*>(si),
        reinterpret_cast<const V*>(st), reinterpret_cast<V*>(out_r),
        reinterpret_cast<V*>(out_i), reinterpret_cast<V*>(out_s), rows, W, R);
    return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_r(const float* sr, const float* si, const float* st, float* out_r,
             float* out_i, float* out_s, int rows, int W, int R,
             cudaStream_t s) {
    switch (R) {
    case 2:
        return launch<2, V>(sr, si, st, out_r, out_i, out_s, rows, W, R, s);
    case 4:
        return launch<4, V>(sr, si, st, out_r, out_i, out_s, rows, W, R, s);
    case 8:
        return launch<8, V>(sr, si, st, out_r, out_i, out_s, rows, W, R, s);
    default:
        return launch<0, V>(sr, si, st, out_r, out_i, out_s, rows, W, R, s);
    }
}

}  // namespace

// One squeeze of the float32 planes sr, si, st [M, C] (contiguous) into
// out_r, out_i, out_s [M/R, C] (contiguous).  Needs R >= 2 dividing M.
// vec 1 takes the float4 path, which needs C % 4 == 0 and all six
// pointers 16-byte aligned; vec 0 the scalar path.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int sd_symsqueeze(const float* sr, const float* si, const float* st,
                             float* out_r, float* out_i, float* out_s, int M,
                             int C, int R, int vec, void* stream) {
    if (M < 1 || C < 1 || R < 2 || M % R ||
        (size_t)(M / R) * C > 0x7fffffffu) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows = M / R;
    if (vec) {
        const size_t any = reinterpret_cast<size_t>(sr) |
                           reinterpret_cast<size_t>(si) |
                           reinterpret_cast<size_t>(st) |
                           reinterpret_cast<size_t>(out_r) |
                           reinterpret_cast<size_t>(out_i) |
                           reinterpret_cast<size_t>(out_s);
        if (C % 4 || any % 16) return static_cast<int>(cudaErrorInvalidValue);
        return launch_r<float4>(sr, si, st, out_r, out_i, out_s, rows, C / 4,
                                R, s);
    }
    return launch_r<float>(sr, si, st, out_r, out_i, out_s, rows, C, R, s);
}
