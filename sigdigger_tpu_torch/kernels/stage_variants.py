"""Where the time of the tensor-core stages goes: each of
``csrc/chan.cuh``'s ``raw_rot_tc`` and ``chan_rot_disc_tc`` timed whole
and with one part taken out.

    python -m sigdigger_tpu_torch.kernels.stage_variants

Builds ``rawbank.cu``, ``channelizer2.cu`` and ``channelizer.cu`` from
copies of ``csrc/``
in a temporary directory, once as they are and once for each variant
(the epilogue, the tensor-core product or the window staging removed by
a text edit of ``chan.cuh``), and prints, per variant, the device time
of each stage from ``torch.profiler`` at the bench shapes: the raw bank
on float32 planes and kernel2 unfused with the table rotator on an
int16 upload (1024 channels, M 8192, K 64, m_tile 2048); and the v1
kernel's ``chan_rot_disc_tc`` (cos/sin, float32 windows) at the entry's
256 channels, M 1024, one row tile a warpgroup.  A variant's outputs are
not meaningful; its time is.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from sigdigger_tpu_torch.kernels import _build

_EPI_RAW = ("        float psum = 0.0f;\n        if (c < C) {\n"
            "            const float ph0",
            "            pow_part[(size_t)i * C + c] = tot;\n        }\n")
_EPI_K2 = ("        // rotate and discriminate in one pass",
           "        wg_sync(wg);\n    }\n}\n\n"
           "// The grid of a tensor-core stage")
_PRODUCT = "        product<KP>(d, sm.st, bh, bl, kp, tid);\n"
_STAGE = ["            pre.store(sm.st, in_gain, tid);\n",
          "            pre.load(xr, xi, n0, n0, n_end, tid);\n",
          "            pre.load(xr, xi, (TR - 1) * (i + step) - 1, 0, M, "
          "tid);\n"]


def _cut(src: str, start: str, end: str, keep_end: bool) -> str:
    a = src.index(start)
    b = src.index(end, a) + (0 if keep_end else len(end))
    return src[:a] + src[b:]


def variants(src: str) -> dict[str, str]:
    """``chan.cuh`` as it is and with each part removed."""
    out = {"whole": src}
    s = _cut(src, *_EPI_RAW, keep_end=False)
    out["no epilogue"] = _cut(s, *_EPI_K2, keep_end=True)
    assert src.count(_PRODUCT) == 2
    # a stand-in that still reads the staging area
    out["no product"] = src.replace(
        _PRODUCT, "        for (int q = 0; q < NACC; ++q) "
        "d[q] = sm.st[q * 3 + tid];\n")
    s = src
    for line in _STAGE:
        assert line in s, line
        s = s.replace(line, "            ;\n")
    out["no staging"] = s
    return out


def _build_variant(src_dir: str, chan: str, out_dir: str) -> list:
    shutil.copytree(src_dir, out_dir)
    with open(os.path.join(out_dir, "chan.cuh"), "w") as fh:
        fh.write(chan)
    return [subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", out_dir, "-o",
         os.path.join(out_dir, f"lib{lib}.so"),
         os.path.join(out_dir, f"{lib}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib in ("rawbank", "channelizer2", "channelizer")]


def _bind(path: str, lib: str, name: str):
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes = _build.SIGNATURES[lib][name]
    fn.restype = ctypes.c_int
    return fn


def _device_ms(fn, stage: str, reps: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if stage in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            return us / max(ev.count, 1) / 1e3
    return float("nan")


def main() -> int:
    from sigdigger_tpu_torch.kernels import channelizer as ch1
    from sigdigger_tpu_torch.kernels import channelizer2 as ch2
    from sigdigger_tpu_torch.kernels import rawbank

    if not torch.cuda.is_available():
        print("stage_variants: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(11)
    fs, c, m, mt = 102.4e6, 1024, 8192, 2048
    f0s = np.linspace(-50e6, 49.9e6, c)
    bank = rawbank.RawBank(rawbank.RawBankConfig(
        sample_rate=fs, n_channels=c, block_out=m, m_tile=mt), "cuda")
    bank.begin_defer()
    for i, f0 in enumerate(f0s):
        bank.configure_channel(i, f0=float(f0), bw=400e3)
    bank.end_defer()
    x = (0.3 * (rng.standard_normal(bank.cfg.block_in) + 1j
                * rng.standard_normal(bank.cfg.block_in))).astype(
                    np.complex64)
    xr, xi = (torch.from_numpy(a).cuda() for a in bank.frame(x))
    phi0 = torch.from_numpy(bank._phi_tiles()).cuda()
    chan = ch2.MatChannelizer2(ch2.MatChannelizer2Config(
        sample_rate=fs, n_channels=c, block_out=m, m_tile=mt,
        audio_decim=32, in_i16=True, audio_bf16=True, fuse_psd=False),
        f0s, 800e3, device="cuda")
    xw = torch.from_numpy(chan._frame(x)).cuda()
    dev = torch.device("cuda")
    y_re, y_im = (torch.empty((m, c), device=dev) for _ in range(2))
    power = torch.empty((1, c), device=dev)
    pow_part = torch.empty((m // 64, c), device=dev)
    audio = torch.empty((m // 32, c), device=dev, dtype=torch.bfloat16)
    last = [torch.empty((1, c), device=dev) for _ in range(2)]
    ftail = torch.empty((63, c), device=dev)
    f_scr = torch.empty((m, c), device=dev)
    k = chan.consts
    v1 = ch1.MatChannelizer(ch1.MatChannelizerConfig(
        sample_rate=25.6e6, n_channels=256, decimation=64, audio_decim=8,
        block_out=1024), np.linspace(-12e6, 12e6, 256), 200e3, "cuda")
    w, _ = ch1.make_windows(v1.cfg, x[:v1.cfg.block_in],
                            np.zeros(63, np.complex64))
    w_re, w_im = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in (w.real, w.imag))
    row = torch.zeros((1, 256), device=dev)
    v1_out = torch.empty((128 + 2, 256), device=dev)
    v1_scr = torch.empty((1024, 256), device=dev)
    src = open(os.path.join(_build.CSRC, "chan.cuh")).read()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _build_variant(_build.CSRC, text,
                                      os.path.join(tmp, str(i)))
                 for i, (name, text) in enumerate(variants(src).items())}
        for name, ps in procs.items():
            for p in ps:
                out, _ = p.communicate()
                if p.returncode:
                    raise RuntimeError(f"{name}: nvcc failed\n{out}")
        print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
        for i, name in enumerate(procs):
            d = os.path.join(tmp, str(i))
            raw = _bind(os.path.join(d, "librawbank.so"), "rawbank",
                        "sd_rawbank")
            k2 = _bind(os.path.join(d, "libchannelizer2.so"),
                       "channelizer2", "sd_kernel2")

            def run_raw():
                err = _build.launch(
                    raw, dev, xr.data_ptr(), xi.data_ptr(), 0, 1.0,
                    bank.consts["bmat"].data_ptr(),
                    bank.consts["theta"].data_ptr(), phi0.data_ptr(),
                    y_re.data_ptr(), y_im.data_ptr(), power.data_ptr(),
                    pow_part.data_ptr(), m, c, 64, mt)
                assert err == 0, err

            def run_k2():
                err = _build.launch(
                    k2, dev, xw.data_ptr(), 1, chan.params.in_gain,
                    k["bmat"].data_ptr(), 1, k["q"].data_ptr(),
                    k["r"].data_ptr(), None, None, chan._prev_re.data_ptr(),
                    chan._prev_im.data_ptr(), chan._ftail.data_ptr(),
                    k["ataps"].data_ptr(), 0, None, None, None, None, None,
                    audio.data_ptr(), 1, last[0].data_ptr(),
                    last[1].data_ptr(), ftail.data_ptr(), None,
                    f_scr.data_ptr(), None, None, m, c, mt, 64, 32,
                    chan.params.quad_gain, 1.0)
                assert err == 0, err

            k1 = _bind(os.path.join(d, "libchannelizer.so"),
                       "channelizer", "sd_kernel1")

            def run_k1():
                o = v1_out.data_ptr()
                err = _build.launch(
                    k1, dev, w_re.data_ptr(), w_im.data_ptr(),
                    v1.consts["bmat"].data_ptr(),
                    v1.consts["theta"].data_ptr(), row.data_ptr(),
                    row.data_ptr(), row.data_ptr(),
                    v1.consts["ataps"].data_ptr(), o, o + 128 * 1024,
                    o + 129 * 1024, v1_scr.data_ptr(), 1024, 256, 64, 8,
                    v1.params.quad_gain)
                assert err == 0, err

            print(f"{name}: raw_rot_tc "
                  f"{_device_ms(run_raw, 'raw_rot_tc'):.4f} ms, "
                  f"chan_rot_disc_tc (table, int16) "
                  f"{_device_ms(run_k2, 'chan_rot_disc_tc'):.4f} ms, "
                  f"v1 chan_rot_disc_tc (cos/sin, f32, C 256, M 1024) "
                  f"{_device_ms(run_k1, 'chan_rot_disc_tc'):.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
