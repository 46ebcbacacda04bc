// Single-fetch drain packer of the analyzer, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigdigger_tpu/kernels/drainpack.py::_pack_kernel.
// The TPU kernel selects each section's live columns with per-group
// one-hot matmuls Σ_g X_g·S_g, because its toolchain has no gather.  Here
// each output element is one gathered value:
//
//   data section s (tiles t0..t0+cnt, G lane groups of ws = W/G lanes),
//   output tile t, row r, lane l:
//     g = l / ws,  col = idx_s[l % ws],
//     out = col < 0 ? 0
//         : trunc(clip(x_s[((t − t0)·G + g)·mt + r, col]·scale_s,
//                      −32768, 32767))
//   status tile: rows 0-2 the 3-lane residual of sq[status[l]], rows 3-5
//   that of pw[status[l]], rows 6.. zero, where residual3(v) is
//     u = clip(v·256, −32768, 32766), h = floor(u),
//     r1 = (u − h)·32768, m = floor(r1), lo = floor((r1 − m)·32768).
//
// Each step is one IEEE float32 operation, written with the _rn
// intrinsics so that no multiply and add contract into an FMA, and the
// int16 conversion truncates toward zero (__float2int_rz) as astype does:
// the kernel, the plain version and the reference's one-hot matmul agree
// bit for bit on finite input.
//
// Bound: bytes.  The live source columns read once and the int16 buffer
// written once (a few operations per element); a sparse map reads whole
// 32-byte sectors, so its floor is the sectors its columns touch.
// Design:
// - The block table (drainpack.py::block_table, built on the host once
//   per layout) gives each block a run of at most ROWS·(THREADS/ox)
//   output rows of one section, or of the status tile, or zero rows: the
//   block reads its section, rows and source rows from two int4 loads and
//   searches for nothing.  blockIdx.y takes a span of ox·8 lanes.
// - Each thread owns 8 consecutive lanes, one 16-byte int16x8 store a
//   row (section widths are multiples of 8, so the 8 lanes lie in one
//   lane group), loads their 8 map entries once as two int4s, and issues
//   the gathered loads of its ROWS rows through the read-only path
//   before the first quantize.
// - Where the 8 columns are consecutive and 16-byte aligned (the
//   engine's active slots are sorted), they load as two float4s.  A warp
//   of 256 lanes with any other run loads lane-interleaved instead (one
//   instruction, 32 consecutive lanes: a few cache lines for a sorted
//   map, where 8 lanes a thread would touch 32 lines an instruction) and
//   turns its values into 16-byte stores through shared memory.
// - Lanes with no mapped column, the status tile's rows 6.. and the
//   zero rows take their stores with no loads.
// The plain PyTorch version is
// sigdigger_tpu_torch/kernels/drainpack.py::pack_kernel_reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;     // rows per thread, loads in flight together
constexpr int LANES = 8;    // lanes per thread: one 16-byte store

// block table entry kinds (drainpack.py::SECTION_IDS): the six data
// planes, then the status tile's rows 0-5, then rows of zeros
constexpr int STATUS = 6;
constexpr int ZERO = 7;

__device__ __forceinline__ uint32_t quant(float v, float scale) {
    const float q = fminf(fmaxf(__fmul_rn(v, scale), -32768.0f), 32767.0f);
    return static_cast<uint16_t>(static_cast<int16_t>(__float2int_rz(q)));
}

__device__ __forceinline__ uint32_t residual3(float v, int lane) {
    const float u = fminf(fmaxf(__fmul_rn(v, 256.0f), -32768.0f), 32766.0f);
    const float h = floorf(u);
    const float r1 = __fmul_rn(__fsub_rn(u, h), 32768.0f);
    const float m = floorf(r1);
    const float lo = floorf(__fmul_rn(__fsub_rn(r1, m), 32768.0f));
    const float pick = lane == 0 ? h : lane == 1 ? m : lo;
    return static_cast<uint16_t>(static_cast<int16_t>(__float2int_rz(pick)));
}

// 8 int16 lanes (low 16 bits of each word) as one 16-byte store, lane 0
// lowest (the little-endian order of consecutive lanes)
__device__ __forceinline__ void store8(int16_t* dst, const uint32_t (&q)[8]) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(q[0] | (q[1] << 16), q[2] | (q[3] << 16),
                   q[4] | (q[5] << 16), q[6] | (q[7] << 16));
}

__device__ __forceinline__ void zero_rows(int16_t* o, int rt, int nrows,
                                          int ry, int W) {
    for (int r = rt; r < nrows; r += ry)
        *reinterpret_cast<uint4*>(o + (size_t)r * W) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void load8(const int* __restrict__ p, int (&c)[8]) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
}

// A warp's 256 lanes of rows rt + k·ry (k < ROWS) of a data run, gathered
// lane-interleaved: thread t loads lanes t + 32j (j < 8), so each load
// instruction covers 32 consecutive lanes, whose columns are close
// together when the map is sorted (a few cache lines, not 32), then
// quantizes them into the warp's stage in shared memory and stores lanes
// 8t..8t+7 of each row as one 16-byte word.  lw: the warp's first lane;
// src0: the run's first source row of lane group 0; o: its first output
// row.
__device__ __forceinline__ void gather_warp(
    const float* __restrict__ x, const int* __restrict__ map, int ws,
    float scale, int src0, int mt, int C, int W, int lw, int rt, int ry,
    int nrows, int16_t* __restrict__ o, uint16_t (*stage)[256]) {
    const int t = threadIdx.x & 31;
    int col[LANES], srow[LANES];
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
        const int l = lw + t + 32 * j;
        const int g = l / ws;
        col[j] = __ldg(map + (l - g * ws));
        srow[j] = src0 + g * mt + rt;
    }
    float v[ROWS][LANES];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (rt + k * ry >= nrows) continue;
#pragma unroll
        for (int j = 0; j < LANES; ++j)
            v[k][j] = col[j] >= 0
                ? __ldg(x + (size_t)(srow[j] + k * ry) * C + col[j]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (rt + k * ry >= nrows) continue;
#pragma unroll
        for (int j = 0; j < LANES; ++j)
            stage[k][t + 32 * j] = static_cast<uint16_t>(quant(v[k][j], scale));
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (rt + k * ry >= nrows) continue;
        *reinterpret_cast<uint4*>(o + (size_t)(rt + k * ry) * W + lw + 8 * t) =
            *reinterpret_cast<const uint4*>(&stage[k][8 * t]);
    }
}

// The planes, maps and rows are separate parameters picked with selects
// on the block's uniform section, so the kernel indexes no array of
// parameters.
__global__ void __launch_bounds__(THREADS)
pack(const int4* __restrict__ table, const float* __restrict__ x_audio,
     const float* __restrict__ x_dsr, const float* __restrict__ x_dsi,
     const float* __restrict__ x_dst, const float* __restrict__ x_yre,
     const float* __restrict__ x_yim, const int* __restrict__ map_audio,
     const int* __restrict__ map_dig, const int* __restrict__ map_raw,
     const int* __restrict__ map_status, const float* __restrict__ sq,
     const float* __restrict__ pw, int16_t* __restrict__ out, int C, int W,
     int mt, int ox, int vec) {
    // entry: (kind, first output row, first source row, rows) and
    // (section width, scale bits, -, -)
    const int4 e0 = __ldg(table + 2 * blockIdx.x);
    const int4 e1 = __ldg(table + 2 * blockIdx.x + 1);
    const int kind = e0.x, nrows = e0.w;
    const int ry = THREADS / ox;            // thread rows of the block
    const int rt = threadIdx.x / ox;
    const int l0 = (blockIdx.y * ox + threadIdx.x % ox) * LANES;
    if (rt >= ry || l0 >= W) return;
    int16_t* __restrict__ o = out + (size_t)e0.y * W + l0;

    if (kind == ZERO) {
        zero_rows(o, rt, nrows, ry, W);
        return;
    }
    if (kind == STATUS) {
        int col[LANES];
        load8(map_status + l0, col);
        for (int r = rt; r < nrows; r += ry) {
            const float* __restrict__ src = r < 3 ? sq : pw;
            float v[LANES];
            uint32_t q[LANES];
#pragma unroll
            for (int i = 0; i < LANES; ++i)
                v[i] = col[i] >= 0 ? __ldg(src + col[i]) : 0.0f;
#pragma unroll
            for (int i = 0; i < LANES; ++i) q[i] = residual3(v[i], r % 3);
            store8(o + (size_t)r * W, q);
        }
        return;
    }

    const float* __restrict__ x =
        kind == 0 ? x_audio : kind == 1 ? x_dsr : kind == 2 ? x_dsi
        : kind == 3 ? x_dst : kind == 4 ? x_yre : x_yim;
    const int* __restrict__ map =
        kind == 0 ? map_audio : kind <= 3 ? map_dig : map_raw;
    const int ws = e1.x;
    const float scale = __int_as_float(e1.y);
    const int g = l0 / ws;
    int col[LANES];
    load8(map + (l0 - g * ws), col);
    bool any = false, dense = vec && col[0] >= 0 && (col[0] & 3) == 0;
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
        any |= col[i] >= 0;
        dense &= col[i] == col[0] + i;
    }
    // a warp whose 256 lanes lie in the buffer (a block row of 32
    // octets) and are not all dense runs gathers lane-interleaved
    if (ox == 32 && (int)(blockIdx.y + 1) * 256 <= W &&
        !__all_sync(0xffffffffu, dense)) {
        __shared__ __align__(16) uint16_t stage[THREADS / 32][ROWS][256];
        gather_warp(x, map, ws, scale, e0.z, mt, C, W,
                    (int)blockIdx.y * 256, rt, ry, nrows,
                    out + (size_t)e0.y * W, stage[rt]);
        return;
    }
    if (!any) {
        zero_rows(o, rt, nrows, ry, W);
        return;
    }
    // source row of output row rt + k·ry: e0.z + g·mt + rt + k·ry
    const float* __restrict__ src = x + (size_t)(e0.z + g * mt + rt) * C;
    float v[ROWS][LANES];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (rt + k * ry >= nrows) continue;
        const float* __restrict__ row = src + (size_t)k * ry * C;
        if (dense) {
            const float4* f = reinterpret_cast<const float4*>(row + col[0]);
            const float4 a = __ldg(f), b = __ldg(f + 1);
            v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
            v[k][4] = b.x; v[k][5] = b.y; v[k][6] = b.z; v[k][7] = b.w;
        } else {
#pragma unroll
            for (int i = 0; i < LANES; ++i)
                v[k][i] = col[i] >= 0 ? __ldg(row + col[i]) : 0.0f;
        }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (rt + k * ry >= nrows) continue;
        uint32_t q[LANES];
#pragma unroll
        for (int i = 0; i < LANES; ++i)
            q[i] = quant(v[k][i], scale);     // 0 for an empty lane
        store8(o + (size_t)(rt + k * ry) * W, q);
    }
}

}  // namespace

// One pack into out int16 [rows, W] (16-byte aligned) by the n_blocks
// entries of `table` (int32 [n_blocks, 8], drainpack.py::block_table):
// the float32 planes [rows_s, C] of the sections present (null where
// absent), their int32 column maps (-1: empty lane; 16-byte aligned, W/G
// entries each, W/G a multiple of 8), the status map [W] and the float32
// status rows sq and pw [1, C].  ox: lane octets a block row spans
// (min(W/8, 32)); vec: the planes' base pointers are 16-byte aligned and
// C % 4 == 0, so dense runs of columns load as float4s.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int sd_drainpack(const int* table, int n_blocks,
                            const float* x_audio, const float* x_dsr,
                            const float* x_dsi, const float* x_dst,
                            const float* x_yre, const float* x_yim,
                            const int* map_audio, const int* map_dig,
                            const int* map_raw, const int* map_status,
                            const float* sq, const float* pw, int16_t* out,
                            int C, int W, int mt, int ox, int vec,
                            void* stream) {
    if (table == nullptr || n_blocks < 1 || map_status == nullptr ||
        sq == nullptr || pw == nullptr || C < 1 || W < LANES ||
        W % LANES || mt < 6 || ox < 1 || ox > THREADS ||
        reinterpret_cast<uintptr_t>(out) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const int octets = W / LANES;
    const dim3 grid(n_blocks, (octets + ox - 1) / ox);
    pack<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(table), x_audio, x_dsr, x_dsi, x_dst,
        x_yre, x_yim, map_audio, map_dig, map_raw, map_status, sq, pw, out, C,
        W, mt, ox, vec);
    return static_cast<int>(cudaGetLastError());
}
