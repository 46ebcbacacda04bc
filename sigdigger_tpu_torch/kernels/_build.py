"""Build, bind and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/lib<name>.so`` next to
this file, at first use; a library is rebuilt when any source or header
in ``csrc/`` is newer than it.  All stale sources compile in parallel,
one ``nvcc`` each.  The libraries are bound with ``ctypes``: every
pointer and the stream are ``c_void_p``, and each entry point returns
``cudaGetLastError()`` for the wrapper to check.

Every public kernel function is built by :func:`kernel` from its name,
its CUDA body, its plain PyTorch version, the argument whose device
decides, and its argument check with that check's key: the check runs
once per key (:func:`checked_once`), each call is span ``launch``, and
``<fn>.launches`` counts the CUDA launches.  Every CUDA body calls its
entry point through :func:`launch`: pointers go as the plain ints of
``data_ptr()`` (the bound ``argtypes`` convert them, ``None`` is NULL),
the stream handle comes from ``torch._C._cuda_getCurrentRawStream``
with no ``Stream`` object, and the device is made current only when the
tensors lie on another one.  :func:`scratch` keeps one scratch buffer
per device and stream for the kernels' partials and counters.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

from sigdigger_tpu_torch.utils import profiling

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# entry points of each library: name -> argtypes (restype is c_int)
SIGNATURES = {
    "audio": {
        "sd_audio": (
            [_P, _P, _I, _F]        # xr, xi, in_kind, in_gain
            + [_P] * 7              # h_re h_im prm taps2 ataps phi0 phs0
            + [_P] * 9              # carries in (audio.py STATE order)
            + [_P] * 11             # audio, carries out, power
            + [_P] * 9              # rr ri pow_part sq_t gain f1 f2 a1 a2
            + [_I] * 10             # M C K mt ka ka2 da ssb hang seed_tile
            + [_F] * 3              # quad_gain beta one_m_beta
            + [_P]),                # stream
        "sd_audio_hang_chain": (
            [_P] * 4                # rr ri prm agcs
            + [_I] * 2              # C steps
            + [_P, _P]),            # out stream
        "sd_audio_hang_ops_check": [_P, _P],    # counts stream
    },
    "compact": {
        "sd_compact": (
            [_P] * 4 + [_I]         # x0..x3, n
            + [_P, _P, _I]          # slots, runs, vec_loads
            + [_P, _I]              # out, out_kind
            + [_F] * 4              # s0..s3
            + [_I] * 4              # M C W mt
            + [_P]),                # stream
    },
    "channelizer": {
        "sd_kernel1": (
            [_P] * 12               # xr xi bmat theta phi0 prev_re prev_im
                                    # ataps audio last_re last_im f_scr
            + [_I] * 4              # M C ka da
            + [_F, _P]),            # quad_gain stream
    },
    "channelizer2": {
        "sd_kernel2": (
            [_P, _I, _F]            # xw, in_kind, in_gain
            + [_P]                  # bmat
            + [_I] + [_P] * 4       # table_rot q r theta phi0
            + [_P] * 4              # prev_re prev_im ftail ataps
            + [_I] + [_P] * 5       # fuse_psd w2d w64_re w64_im tw_re tw_im
            + [_P, _I]              # audio, audio_bf16
            + [_P] * 7              # last_re last_im ftail_out psd
                                    # f_scr psd_part psd_count
            + [_I] * 5              # M C mt ka da
            + [_F, _F, _P]),        # quad_gain psd_scale stream
    },
    "drainpack": {
        "sd_drainpack": (
            [_P, _I]                # table n_blocks
            + [_P] * 6              # audio d_sr d_si d_st y_re y_im
            + [_P] * 4              # maps: audio digital raw status
            + [_P] * 3              # sq pw out
            + [_I] * 5              # C W mt ox vec
            + [_P]),                # stream
    },
    "psd": {
        "sd_psd": (
            [_P, _I, _F]            # x, in_kind, in_gain
            + [_P] * 5              # consts psd part scratch count
            + [_I] * 3              # A B F
            + [_F, _P]),            # scale stream
    },
    "psd_xw": {
        "sd_psd_xw": (
            [_P, _I, _P]            # xw, in_kind, consts
            + [_I, _P, _F]          # ema prev alpha
            + [_P] * 4              # psd part scratch count
            + [_I] * 5              # M A B fb stride
            + [_F, _P]),            # scale stream
    },
    "rawbank": {
        "sd_rawbank": (
            [_P, _P, _I, _F]        # xr, xi, in_kind, in_gain
            + [_P] * 7              # bmat theta phi0 y_re y_im power
                                    # pow_part
            + [_I] * 4              # M C K mt
            + [_P]),                # stream
    },
    "recovery": {
        "sd_recovery": (
            [_P] * 9                # y_re y_im state prm taps sym_re
                                    # sym_im strobe state_out
            + [_I] * 4              # M C K keq
            + [_F, _F, _P]),        # adc one_m_adc stream
        "sd_recovery_smem_bytes": [_I],    # K
        "sd_recovery_chain": (
            [_P] * 4                # y_re y_im state prm
            + [_I] * 4              # C K keq steps
            + [_F, _F, _P, _P]),    # adc one_m_adc out stream
    },
    "cma": {
        "sd_cma": (
            [_P] * 10               # x_re x_im taps_re taps_im rate locked
                                    # y_re y_im taps_re_out taps_im_out
            + [_I] * 3              # T C K
            + [_P]),                # stream
        "sd_cma_chain": (
            [_P] * 6                # x_re x_im taps_re taps_im rate locked
            + [_I] * 2              # C steps
            + [_P, _P]),            # out stream
        "sd_cma_clip_check": [_P, _P],      # counts stream
    },
    "symsqueeze": {
        "sd_symsqueeze": (
            [_P] * 6                # sr si st out_r out_i out_s
            + [_I] * 4              # M C R vec
            + [_P]),                # stream
    },
    "tvline": {
        "sd_tvline": (
            [_P, _I, _P]            # v n starts (null: framed)
            + [_P] * 4              # frac kcol taps out
            + [_I] * 3              # L W P
            + [_P]),                # stream
    },
}

# flags of one library only: the recovery and CMA loops feed back, so
# their arithmetic must round as the plain version's separate multiply
# and add do (no FMA contraction)
EXTRA_FLAGS = {"recovery": ["-fmad=false"], "cma": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + \
        glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(lib)


def build_all(force: bool = False) -> dict[str, float]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the
    seconds each build took and writes ``build/<name>.log`` (the
    ``-Xptxas -v`` register and spill report)."""
    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(CSRC, "*.cu")))
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = f"{lib_path(n)}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(n, []), "-I", CSRC,
             "-o", tmp,
             os.path.join(CSRC, f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{n}.log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def load_library(name: str = "channelizer2") -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(lib_path(name))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(fn, dev: torch.device, *args) -> int:
    """Call the entry point ``fn`` with ``args`` and the handle of
    ``dev``'s current stream last, with ``dev`` current: a
    ``torch.cuda.device`` context is entered only when another device is
    current.  Returns ``fn``'s error code."""
    cur = torch.cuda.current_device()
    if dev.index is None or dev.index == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(cur))
    with torch.cuda.device(dev.index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def checked_once(memo: set, key, check) -> None:
    """Run ``check()``, which raises ``ValueError`` on arguments a kernel
    does not take, the first time ``key`` is seen; ``key`` enters
    ``memo`` only once ``check()`` has passed.  ``key`` must hold every
    property ``check`` reads (shapes, strides, dtypes, devices, sizes)."""
    if key not in memo:
        check()
        memo.add(key)


def tensor_key(*tensors) -> tuple:
    """What an argument check reads of each tensor: its shape, dtype,
    device index and contiguity (``None`` for an absent one), flat, so
    that a key is cheap to build, hash and compare."""
    key = []
    for t in tensors:
        key += (None,) if t is None else (t.shape, t.dtype, t.get_device(),
                                          t.is_contiguous())
    return tuple(key)


class Unlaunched(Exception):
    """Raised by a CUDA body that has its result without a launch (an
    empty input): the entry returns ``value`` and counts no launch."""

    def __init__(self, value) -> None:
        super().__init__()
        self.value = value


def kernel(name: str, cuda, plain, *, at: int = 0, key=None, check=None,
           doc: str | None = None):
    """The public kernel function ``name``.  A call whose argument ``at``
    is a CUDA tensor runs ``check`` the first time its ``key`` is seen
    (both take the call's arguments; the key must hold every property the
    check reads), then the CUDA body ``cuda``, and counts one launch in
    ``<fn>.launches``; a call on a CPU tensor runs the plain version
    ``plain`` and counts nothing; any other device raises ``ValueError``.
    Each call is span ``launch`` with attribute ``kernel=name``.
    ``<fn>.cuda`` is the CUDA path alone, ``<fn>.checked`` the keys that
    have passed, and ``doc`` the function's docstring."""

    def on_cuda(*args, **kw):
        if key is not None:
            checked_once(fn.checked, key(*args, **kw),
                         lambda: check(*args, **kw))
        try:
            out = cuda(*args, **kw)
        except Unlaunched as e:
            return e.value
        fn.launches += 1
        return out

    def dispatch(*args, **kw):
        dev = args[at].device
        if dev.type == "cuda":
            return on_cuda(*args, **kw)
        if dev.type == "cpu":
            return plain(*args, **kw)
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")

    dispatch.__name__ = dispatch.__qualname__ = name
    dispatch.__doc__ = doc
    fn = profiling.launch(name)(dispatch)
    fn.launches, fn.checked, fn.cuda = 0, set(), on_cuda
    return fn


# device scratch of the kernels: (device index, raw stream) -> buffer
_SCRATCH: dict = {}

# 32-bit counters at the head of every scratch buffer; a kernel that
# counts there leaves them at zero
SCRATCH_COUNTERS = 16


def scratch(dev: torch.device, numel: int) -> torch.Tensor:
    """A float32 buffer on ``dev``: SCRATCH_COUNTERS words of counters,
    zero between launches, then at least ``numel`` floats.  One per
    device and stream, grown (zeroed) as needed: launches on one stream
    run in order, so each may reuse what the one before it wrote, and
    callers read nothing back from it."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel + SCRATCH_COUNTERS:
        buf = torch.zeros(numel + SCRATCH_COUNTERS,
                          device=torch.device("cuda", idx))
        _SCRATCH[key] = buf
    return buf
