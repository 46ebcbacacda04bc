"""The one kernel entry (``kernels/_build.py::kernel``) that builds every
public kernel function of the port.

Each of the 13 entries is called with the arguments its bank hands it on
one block (captured from the bank at a small size).  On the CPU a call
runs the plain version and counts no launch, a call on another device
than ``cuda`` or ``cpu`` raises with the entry's name, and a traced call
is one ``launch`` span with the entry's name.  On the card, the five
kernels whose checks moved into the entry (``kernel2``, ``raw_kernel``,
``recovery_kernel``, ``compact_kernel``, ``audio_kernel``) still refuse
a call that differs from an already-checked one in one checked property
of one argument: its shape, dtype, device or contiguity.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sigdigger_tpu_torch.kernels import (
    audio,
    channelizer,
    channelizer2,
    compact,
    drainpack,
    equalizer,
    fft,
    rawbank,
    recovery,
    symsqueeze,
    tvline,
)
from sigdigger_tpu_torch.utils import profiling

FS = 2_048_000.0
C = 8


def _x(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _captured(mod, name: str, run) -> tuple:
    """The (args, kwargs) of the first call ``run()`` makes to the kernel
    function ``mod.name``."""
    fn, seen = getattr(mod, name), []

    def record(*a, **k):
        seen.append((a, k))
        return fn(*a, **k)

    setattr(mod, name, record)
    try:
        run()
    finally:
        setattr(mod, name, fn)
    return seen[0]


def _kernel2(dev):
    cfg = channelizer2.MatChannelizer2Config(
        sample_rate=FS, n_channels=C, block_out=512, m_tile=512)
    chan = channelizer2.MatChannelizer2(cfg, np.linspace(-8e5, 7e5, C),
                                        1e5, device=dev)
    return lambda: chan.feed_packed(chan._frame(_x(cfg.block_in)))


def _kernel1(dev):
    cfg = channelizer.MatChannelizerConfig(sample_rate=FS, n_channels=C,
                                           block_out=256)
    chan = channelizer.MatChannelizer(cfg, np.linspace(-8e5, 7e5, C), 1e5,
                                      device=dev)
    return lambda: chan.feed(_x(cfg.block_in))


def _raw(dev):
    cfg = rawbank.RawBankConfig(sample_rate=FS, n_channels=C,
                                block_out=256, m_tile=128)
    bank = rawbank.RawBank(cfg, device=dev)
    return lambda: bank.feed(_x(cfg.block_in))


def _audio(dev):
    cfg = audio.AudioBankConfig(sample_rate=FS, n_channels=C,
                                block_out=512, m_tile=256)
    bank = audio.AudioBank(cfg, device=dev)
    return lambda: bank.feed(_x(cfg.block_in))


def _recovery(dev):
    bank = recovery.RecoveryBank(
        recovery.RecoveryBankConfig(n_channels=C, block_len=128),
        device=dev)
    return lambda: bank.feed(_x(128 * C).reshape(128, C))


def _compact(dev):
    comp = compact.ColumnCompactor(compact.ColumnCompactorConfig(
        n_rows=16, n_channels=C, width=8, n_planes=2), device=dev)
    comp.set_mapping([3, 1, 4, 0, 5, 2, 6, 7])
    planes = [torch.from_numpy(_x(16 * C, s).real.reshape(16, C).copy())
              for s in (1, 2)]
    return lambda: comp.dispatch(*planes)


def _squeeze(dev):
    sq = symsqueeze.SymbolSqueeze(symsqueeze.SymbolSqueezeConfig(
        n_rows=16, n_channels=C, group=4), device=dev)
    st = (np.arange(16 * C).reshape(16, C) % 5 == 0).astype(np.float32)
    return lambda: sq.dispatch(_x(16 * C).real.reshape(16, C).copy(),
                               _x(16 * C).imag.reshape(16, C).copy(), st)


def _pack(dev):
    cfg = drainpack.DrainPackerConfig(n_rows=64, audio_rows=16,
                                      n_channels=C, width=8)
    pk = drainpack.DrainPacker(cfg, device=dev)
    pk.set_mappings(list(range(C)), audio=[0, 1], digital=[2, 3], raw=[4])

    def plane(rows, seed):
        return _x(rows * C, seed).real.reshape(rows, C).copy()

    return lambda: pk.dispatch(
        audio=plane(16, 1), sq=plane(1, 2), pw=plane(1, 3),
        dig=(plane(64, 4), plane(64, 5), plane(64, 6)),
        raw=(plane(64, 7), plane(64, 8)))


def _psd(dev):
    psd = fft.PSD(fft.PSDConfig(fft_size=256, frames_per_block=4,
                                frames_per_program=4), FS, device=dev)
    return lambda: psd.feed(_x(1024))


def _psd_from_xw(dev):
    return fft.PSDFromXW(fft.PSDConfig(fft_size=4096, frames_per_block=4,
                                       frames_per_program=4), 256, FS,
                         device=dev)


def _xw() -> np.ndarray:
    return _x(512 * 64).real.reshape(512, 64).copy()


def _psd_xw(dev):
    psd = _psd_from_xw(dev)
    return lambda: psd.feed(_xw())


def _psd_xw_ema(dev):
    psd = _psd_from_xw(dev)
    return lambda: psd.feed_ema(_xw())


def _tv(dev):
    tv = tvline.LineResampler(tvline.LineResamplerConfig(width=64,
                                                         pixels=16),
                              device=dev)
    tv.set_step(64 * 0.85 / 16)
    frac = np.linspace(0.0, 0.9, 5).astype(np.float32)
    return lambda: tv.resample(_x(5 * 64).real.reshape(5, 64), frac)


def _cma(dev):
    bank = equalizer.CMABank(equalizer.CMABankConfig(n_channels=C,
                                                     block_len=32),
                             device=dev)
    return lambda: bank(_x(C * 32).reshape(C, 32))


def _plain_raw(xr, xi, h_re, h_im, theta, phi0, p, bmat=None):
    return rawbank.raw_kernel_reference(xr, xi, h_re, h_im, theta, phi0, p)


def _plain_tv(x, frac, wts, starts=None):
    return (tvline.tv_kernel_reference(x, frac, wts) if starts is None
            else tvline.tv_stream_reference(x, starts, frac, wts))


# name -> (module, the argument whose device decides, the bank's block,
# the plain version)
ENTRIES = {
    "kernel2": (channelizer2, 0, _kernel2, channelizer2.kernel2_reference),
    "kernel1": (channelizer, 0, _kernel1, channelizer.kernel1_reference),
    "raw_kernel": (rawbank, 0, _raw, _plain_raw),
    "audio_kernel": (audio, 0, _audio, audio.audio_kernel_reference),
    "recovery_kernel": (recovery, 0, _recovery,
                        recovery.recovery_kernel_reference),
    "compact_kernel": (compact, 1, _compact,
                       lambda planes, slots, runs, cfg:
                       compact.compact_kernel_reference(planes, slots,
                                                        cfg)),
    "squeeze_kernel": (symsqueeze, 2, _squeeze,
                       symsqueeze.squeeze_kernel_reference),
    "pack_kernel": (drainpack, 1, _pack, drainpack.pack_kernel_reference),
    "psd_kernel": (fft, 0, _psd, fft.psd_kernel_reference),
    "psd_xw_kernel": (fft, 0, _psd_xw, fft.psd_xw_kernel_reference),
    "psd_xw_ema_kernel": (fft, 0, _psd_xw_ema,
                          fft.psd_xw_kernel_reference),
    "tv_kernel": (tvline, 0, _tv, _plain_tv),
    "cma_kernel": (equalizer, 0, _cma, equalizer.cma_kernel_reference),
}


def _args(name: str, dev) -> tuple:
    mod, _, bank, _ = ENTRIES[name]
    return _captured(mod, name, bank(dev))


def _same(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name", list(ENTRIES))
def test_cpu_call_runs_the_plain_version_and_counts_nothing(name,
                                                            monkeypatch):
    mod, _, _, plain = ENTRIES[name]
    fn = getattr(mod, name)
    assert fn.__name__ == fn.__wrapped__.__name__ == name
    args, kw = _args(name, "cpu")
    # the CUDA path would call the entry point through `launch`
    monkeypatch.setattr(mod, "launch", None)
    before, checked = fn.launches, set(fn.checked)
    got = fn(*args, **kw)
    assert fn.launches == before and fn.checked == checked
    _same(got, plain(*args, **kw))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_call_on_another_device_raises_with_the_entry_name(name):
    mod, at, _, _ = ENTRIES[name]
    fn = getattr(mod, name)
    args, kw = _args(name, "cpu")
    args = list(args)
    args[at] = args[at].to("meta")
    before = fn.launches
    with pytest.raises(ValueError,
                       match=f"^{name} runs on cuda or cpu, not meta$"):
        fn(*args, **kw)
    assert fn.launches == before


@pytest.mark.parametrize("name", list(ENTRIES))
def test_traced_call_is_one_launch_span(name):
    mod, _, _, _ = ENTRIES[name]
    fn = getattr(mod, name)
    args, kw = _args(name, "cpu")
    profiling.clear()
    fn(*args, **kw)
    assert profiling.records() == []            # untraced: no span
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*args, **kw)
    recs = [r for r in profiling.records() if r.name == "launch"]
    profiling.clear()
    assert [r.attrs for r in recs] == [{"kernel": name}]


# ---------------------------------------------------------------------------
# on the card: a checked key does not let a changed argument through
# ---------------------------------------------------------------------------

def _with(args: tuple, kw: dict, where, change) -> tuple:
    """``args`` with the tensor at ``where`` (an index, or an index then
    a key or index inside that argument) replaced by ``change(t)``."""
    args = list(args)
    if isinstance(where, int):
        args[where] = change(args[where])
        return tuple(args), kw
    i, j = where
    inner = args[i]
    if isinstance(inner, dict):
        args[i] = dict(inner, **{j: change(inner[j])})
    else:
        inner = list(inner)
        inner[j] = change(inner[j])
        args[i] = tuple(inner)
    return tuple(args), kw


# the 2-D argument of each moved kernel that a changed call alters
MOVED = {
    "kernel2": (4,),                    # ftail [Ka-1, C]
    "raw_kernel": (1,),                 # xi [M, K]
    "recovery_kernel": (1,),            # y_im [M, C]
    "compact_kernel": ((0, 1),),        # the second plane [M, C]
    "audio_kernel": (1, (2, "h_re")),   # xi [M, K], the taps [K, C]
}

CHANGES = {
    "shape": lambda t: t[:-1],
    "dtype": lambda t: t.double(),
    "device": lambda t: t.cpu(),
    "contiguity": lambda t: t.t().contiguous().t(),
}


@pytest.mark.cuda
@pytest.mark.parametrize("change", list(CHANGES))
@pytest.mark.parametrize("name", list(MOVED))
def test_changed_call_after_a_checked_one_still_raises(name, change):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    mod = ENTRIES[name][0]
    fn = getattr(mod, name)
    args, kw = _args(name, torch.device("cuda"))
    before = fn.launches
    fn(*args, **kw)                      # checked: its key is in the memo
    assert fn.launches == before + 1
    for where in MOVED[name]:
        bad_args, bad_kw = _with(args, kw, where, CHANGES[change])
        with pytest.raises(ValueError):
            fn(*bad_args, **bad_kw)
    assert fn.launches == before + 1
