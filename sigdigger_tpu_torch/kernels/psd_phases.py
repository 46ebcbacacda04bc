"""Where the time of the FFT stages' PSD kernel goes, phase by phase.

    python -m sigdigger_tpu_torch.kernels.psd_phases

On a CUDA card: builds a copy of ``csrc/psd.cu`` whose ``psd_frames``
records the global timer (``%globaltimer``, ns) at its phase boundaries
in thread 0 of every block, launches it at the standalone PSD's bench
shape (N 4096, F 128, float32 and int16) and at frame_stride 4's 32
frames, and prints, over 30 launches, the median of each block's phase
times: the frame load (16-byte ``cp.async``), the FFT passes, the wait
at the cluster barrier, the pushes to the owners, the wait for the
owner's rows, the slice sum, and the last block's sum of the clusters'
partials; with the kernel's span (first block start to last block
end) and how much later than the median block the slowest one finished
its FFT.  The copy lives under ``kernels/build/``; the package's own
library is not touched.  A phase time is device time between two timer
reads of one block; the span leaves out the launch itself.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from sigdigger_tpu_torch.kernels import _build, fft
from sigdigger_tpu_torch.native import UPLOAD_KIND

# (mark, the line of csrc/psd.cuh it goes after; "^" before)
_MARKS = [
    (0, "    const unsigned bar_a = smem_u32(bar);\n"),
    (1, '        asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
        "        __syncthreads();\n"),
    (2, "        dft_b<A, B, 0>(s, wb, wb + B);\n"),
    (3, '    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: '
        '"memory");\n    if (fr < frames) {\n'),
    (4, "^    for (unsigned k = 0; !mbar_try(bar_a, 0); ++k)\n"),
    (5, "        if (k == (1u << 22)) __trap();   // a push never came: "
        "fail, not hang\n"),
    (6, "^    if (parts == 1) return leave();\n"),
    (7, "^    leave();\n}\n"),
]
PHASES = ["load", "fft", "cluster wait", "push", "receive", "slice sum",
          "partials sum"]

_TIMER = """
__device__ unsigned long long sd_phase_t[1024][8];
#define SD_MARK(k)                                                    \\
    if (threadIdx.x == 0 && blockIdx.x < 1024) {                      \\
        unsigned long long t;                                         \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));         \\
        sd_phase_t[blockIdx.x][k] = t;                                \\
    }
"""

_ENTRIES = """
extern "C" int sd_phase_times(void* out) {
    return (int)cudaMemcpyFromSymbol(out, sd_phase_t, sizeof(sd_phase_t));
}
extern "C" int sd_phase_zero() {
    static unsigned long long zero[1024][8];
    return (int)cudaMemcpyToSymbol(sd_phase_t, zero, sizeof(zero));
}
"""


def build() -> ctypes.CDLL:
    """Compile the timed copy of psd.cu and bind it."""
    work = os.path.join(_build.BUILD_DIR, "psd_phases")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work)
    cuh = os.path.join(work, "psd.cuh")
    src = open(cuh).read()
    head, kernel = src.split("psd_frames(const T* __restrict__ x", 1)
    for k, anchor in _MARKS:
        before = anchor.startswith("^")
        line = anchor.lstrip("^")
        if kernel.count(line) != 1:
            raise RuntimeError(f"psd_phases: mark {k} has no unique place "
                               f"in psd_frames ({line.strip()!r})")
        kernel = kernel.replace(
            line, f"SD_MARK({k})\n{line}" if before
            else f"{line}SD_MARK({k})\n")
    head = head.replace("namespace four_step {", _TIMER +
                        "namespace four_step {", 1)
    with open(cuh, "w") as fh:
        fh.write(head + "psd_frames(const T* __restrict__ x" + kernel)
    with open(os.path.join(work, "psd.cu"), "a") as fh:
        fh.write(_ENTRIES)
    lib_path = os.path.join(work, "libpsd_phases.so")
    out = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", work, "-o", lib_path,
         os.path.join(work, "psd.cu")], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"psd_phases build failed:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.sd_psd.argtypes = _build.SIGNATURES["psd"]["sd_psd"]
    lib.sd_psd.restype = ctypes.c_int
    lib.sd_phase_times.argtypes = [ctypes.c_void_p]
    return lib


def phases(lib: ctypes.CDLL, frames: int, i16: bool,
           reps: int = 30) -> dict:
    """Median phase times (µs) of one block, the kernel's span and the
    slowest block's FFT lag, over ``reps`` launches at N 4096."""
    n = 4096
    p = fft.PSD(fft.PSDConfig(fft_size=n, frames_per_block=frames),
                2.048e6, in_i16=i16, device="cuda")
    rng = np.random.default_rng(frames)
    x = (rng.standard_normal(n * frames)
         + 1j * rng.standard_normal(n * frames)).astype(np.complex64)
    xp = torch.from_numpy(p.prepare(x)).cuda()
    a, b = p.cfg.a, p.cfg.b
    out = torch.empty((a, b), device="cuda")
    buf = torch.zeros(_build.SCRATCH_COUNTERS + fft.psd_parts(frames) * n,
                      device="cuda")
    count = buf.data_ptr()
    args = (xp.data_ptr(), UPLOAD_KIND[xp.dtype], p.params.in_gain,
            p.consts["pack"].data_ptr(), out.data_ptr(),
            count + 4 * _build.SCRATCH_COUNTERS, None, count, a, b, frames,
            p.params.scale)
    blocks = fft.psd_parts(frames) * fft.PSD_CLUSTER
    steps, spans, lags = [], [], []
    for _ in range(reps):
        lib.sd_phase_zero()
        if _build.launch(lib.sd_psd, xp.device, *args) != 0:
            raise RuntimeError("psd_phases: launch failed")
        torch.cuda.synchronize()
        t = np.zeros((1024, 8), np.uint64)
        lib.sd_phase_times(t.ctypes.data)
        t = t[:blocks].astype(np.int64)
        last = t[:, 7] > 0                      # the partials' summers
        d = np.diff(t[:frames, :7], axis=1) / 1e3
        summed = ((t[last, 7] - t[last, 6]) / 1e3) if last.any() else [0.0]
        steps.append(list(np.median(d, axis=0)) + [float(np.max(summed))])
        end = max(t[:, 6].max(), t[:, 7].max())
        spans.append((end - t[:, 0].min()) / 1e3)
        fft_end = t[:frames, 2]
        lags.append((fft_end.max() - np.median(fft_end)) / 1e3)
    want = fft.psd_kernel_reference(xp, p.consts, p.params)
    err = float(((out - want).abs() / want.abs()).max())
    med = np.median(np.array(steps), axis=0)
    return {"phases_us": {k: round(float(v), 3) for k, v in
                          zip(PHASES, med)},
            "span_us": round(float(np.median(spans)), 3),
            "slowest_fft_lag_us": round(float(np.median(lags)), 3),
            "worst_bin_rel_err": err}


def main() -> None:
    lib = build()
    for frames, i16 in ((128, False), (128, True), (32, True)):
        r = phases(lib, frames, i16)
        print(f"psd_frames N 4096 F {frames} "
              f"{'int16' if i16 else 'float32'}: {r}", flush=True)


if __name__ == "__main__":
    main()
