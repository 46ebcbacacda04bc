// Column compactor for bank drains, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/compact.py::_compact_kernel.
// The TPU kernel selects the active columns with a one-hot matmul
// X[M, C]·S[C, W] accumulated over channel tiles, because its toolchain
// has no gather.  Here each output element is a gathered value:
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
// Design: each thread owns a run of V consecutive output columns, the
// width of one 16-byte store (V = 4 float32, 8 bfloat16 or int16), and
// ROWS rows of one plane (blockIdx.z), all of whose loads are issued
// before the first store.  A run whose V source columns are consecutive
// and start 16-byte aligned (the run table `runs`, built on the host by
// compact.py::run_table when the map is set; the engine's active slots
// are sorted, and its map at full width is the identity) reads them with
// V/4 float4 loads; any other run gathers V scalars, -1 columns giving 0.
// When V divides W every run ends in one 16-byte store; otherwise the
// rows are not 16-byte aligned and every run stores its columns one by
// one, the last run of a row holding the W mod V tail.  Rows stride over
// the grid so any M fits.  The plain PyTorch version is
// sigdigger_tpu_torch/kernels/compact.py::compact_kernel_reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANES = 4;
constexpr int RUNS_X = 32;   // runs per block row (threadIdx.x)
constexpr int ROWS_Y = 8;    // thread rows per block (threadIdx.y)
constexpr int ROWS = 4;      // rows per thread, loads in flight together

// Each output kind: its element type, the run width V of a 16-byte
// store, the conversion, and the element's bits for packing a store.
template <int KIND>
struct Out;
template <>
struct Out<0> {
    using T = float;
    static constexpr int V = 4;
    __device__ static T cast(float v, float) { return v; }
    __device__ static uint32_t bits(T e) { return __float_as_uint(e); }
};
template <>
struct Out<1> {
    using T = __nv_bfloat16;
    static constexpr int V = 8;
    __device__ static T cast(float v, float) { return __float2bfloat16_rn(v); }
    __device__ static uint32_t bits(T e) { return __bfloat16_as_ushort(e); }
};
template <>
struct Out<2> {
    using T = int16_t;
    static constexpr int V = 8;
    __device__ static T cast(float v, float scale) {
        const float q = fminf(fmaxf(v * scale, -32768.0f), 32767.0f);
        return static_cast<int16_t>(__float2int_rz(q));
    }
    __device__ static uint32_t bits(T e) { return static_cast<uint16_t>(e); }
};

// V converted elements as one 16-byte word, element 0 lowest (the
// little-endian order of consecutive columns).
template <int KIND>
__device__ __forceinline__ uint4 pack(const float (&v)[Out<KIND>::V],
                                      float scale) {
    using O = Out<KIND>;
    constexpr int PER = O::V / 4;   // elements per 32-bit word
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int e = 0; e < PER; ++e)
            w[q] |= O::bits(O::cast(v[q * PER + e], scale)) << (32 / PER * e);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// One plane per blockIdx.z: the plane pointer and scale are uniform in a
// block and picked with selects, so the kernel indexes no array of
// parameters (a dynamically indexed parameter array lands in local
// memory).
template <int KIND, bool VSTORE>
__global__ void __launch_bounds__(RUNS_X * ROWS_Y)
compact(const float* __restrict__ x0, const float* __restrict__ x1,
        const float* __restrict__ x2, const float* __restrict__ x3, float s0,
        float s1, float s2, float s3, const int* __restrict__ slots,
        const int* __restrict__ runs, int vec_loads, void* __restrict__ out,
        int n, int M, int C, int W, int mt) {
    using O = Out<KIND>;
    using T = typename O::T;
    constexpr int V = O::V;
    const int j = blockIdx.x * RUNS_X + threadIdx.x;
    const int w0 = j * V;
    if (w0 >= W) return;
    const int p = blockIdx.z;
    const float* __restrict__ x = p == 0 ? x0 : p == 1 ? x1 : p == 2 ? x2 : x3;
    const float scale = p == 0 ? s0 : p == 1 ? s1 : p == 2 ? s2 : s3;
    const bool contig = vec_loads && runs[j];
    int col[V];
#pragma unroll
    for (int i = 0; i < V; ++i) col[i] = w0 + i < W ? slots[w0 + i] : -1;
    T* __restrict__ o = static_cast<T*>(out);

    const int step = gridDim.y * ROWS_Y * ROWS;
    for (int r0 = (blockIdx.y * ROWS_Y + threadIdx.y) * ROWS; r0 < M;
         r0 += step) {
        float v[ROWS][V];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int r = r0 + k;
            const float* __restrict__ src = x + (size_t)min(r, M - 1) * C;
            if (contig) {
#pragma unroll
                for (int q = 0; q < V / 4; ++q) {
                    const float4 f = __ldg(
                        reinterpret_cast<const float4*>(src + col[0]) + q);
                    v[k][4 * q] = f.x;
                    v[k][4 * q + 1] = f.y;
                    v[k][4 * q + 2] = f.z;
                    v[k][4 * q + 3] = f.w;
                }
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i)
                    v[k][i] = col[i] >= 0 ? __ldg(src + col[i]) : 0.0f;
            }
        }
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int r = r0 + k;
            if (r >= M) continue;
            const int mi = r / mt;
            T* __restrict__ row =
                o + ((size_t)(mi * n + p) * mt + (r - mi * mt)) * W + w0;
            if (VSTORE) {
                *reinterpret_cast<uint4*>(row) = pack<KIND>(v[k], scale);
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i)
                    if (w0 + i < W) row[i] = O::cast(v[k][i], scale);
            }
        }
    }
}

template <int KIND>
void launch(const float* x0, const float* x1, const float* x2,
            const float* x3, float s0, float s1, float s2, float s3,
            const int* slots, const int* runs, int vec_loads, void* out,
            int n, int M, int C, int W, int mt, cudaStream_t s) {
    constexpr int V = Out<KIND>::V;
    const int n_runs = (W + V - 1) / V;
    const dim3 block(RUNS_X, ROWS_Y);
    const int row_blocks = (M + ROWS_Y * ROWS - 1) / (ROWS_Y * ROWS);
    const dim3 grid((n_runs + RUNS_X - 1) / RUNS_X,
                    row_blocks < 65535 ? row_blocks : 65535, n);
    if (W % V == 0)
        compact<KIND, true><<<grid, block, 0, s>>>(
            x0, x1, x2, x3, s0, s1, s2, s3, slots, runs, vec_loads, out, n, M,
            C, W, mt);
    else
        compact<KIND, false><<<grid, block, 0, s>>>(
            x0, x1, x2, x3, s0, s1, s2, s3, slots, runs, vec_loads, out, n, M,
            C, W, mt);
}

}  // namespace

// One compaction of n (1..4) float32 planes x0..x{n-1} [M, C] (unused
// pointers null) through slots int32 [W] (-1: empty column) into out
// [n·M, W]: out_kind 0 float32, 1 bfloat16, 2 int16 with the per-plane
// scales s0..s3.  runs int32 [ceil(W / V)] (V = 4 for float32, else 8)
// flags the runs whose source columns are consecutive and 16-byte
// aligned; vec_loads = 0 ignores it (planes not 16-byte aligned).  The
// output must be 16-byte aligned.  Needs mt | M.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int sd_compact(const float* x0, const float* x1, const float* x2,
                          const float* x3, int n, const int* slots,
                          const int* runs, int vec_loads, void* out,
                          int out_kind, float s0, float s1, float s2,
                          float s3, int M, int C, int W, int mt,
                          void* stream) {
    if (n < 1 || n > MAX_PLANES || M < 1 || C < 1 || W < 1 || mt < 1 ||
        M % mt || reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const float* xs[MAX_PLANES] = {x0, x1, x2, x3};
    for (int p = 0; p < n; ++p)
        if (xs[p] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (out_kind) {
    case 0:
        launch<0>(x0, x1, x2, x3, s0, s1, s2, s3, slots, runs, vec_loads, out,
                  n, M, C, W, mt, s);
        break;
    case 1:
        launch<1>(x0, x1, x2, x3, s0, s1, s2, s3, slots, runs, vec_loads, out,
                  n, M, C, W, mt, s);
        break;
    case 2:
        launch<2>(x0, x1, x2, x3, s0, s1, s2, s3, slots, runs, vec_loads, out,
                  n, M, C, W, mt, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
