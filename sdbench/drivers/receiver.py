"""Driver of the cells whose configuration's ``entry`` is ``receiver``:
the program's ``KernelReceiver``, fed and drained one block at a time as
its ``run(pipeline_depth=...)`` does.

What it takes from the program: the receiver (the system under test),
the names of the methods the spans stand in for, and the kernel
wrappers' launch counters.  The roofline counts come from the
benchmark's own :mod:`sdbench.roofline`.
"""

from __future__ import annotations

import numpy as np

from sdbench import roofline
from sdbench.traffic import channel_freqs

# the receiver's defaults that the reference assumes (configuration's
# ``assumed``): a receiver that departs from them is not this cell
_ASSUMED = ("taps", "audio_taps", "m_tile", "i16_scale")


class Program:
    def __init__(self, cfg: dict, wl: dict, device: str) -> None:
        from sigdigger_tpu_torch.kernels import channelizer2, fft
        from sigdigger_tpu_torch.receiver import KernelReceiver

        self.rx = KernelReceiver(
            sample_rate=cfg["sample_rate"], f0s=channel_freqs(cfg),
            bw=cfg["bw_hz"], mode=cfg["mode"],
            decimation=cfg["decimation"], block_out=cfg["block_out"],
            psd_fft=cfg["psd_fft"], device=device,
            snap_grid=wl["snap_grid"], in_i16=cfg["in_i16"],
            audio_bf16=cfg["audio_bf16"], audio_decim=cfg["audio_decim"])
        rc = self.rx.cfg
        for key in _ASSUMED:
            want = cfg["assumed"][key]
            want = min(want, rc.block_out) if key == "m_tile" else want
            if getattr(rc, key) != want:
                raise RuntimeError(f"the receiver's {key} is "
                                   f"{getattr(rc, key)}, the configuration "
                                   f"assumes {want}")
        self.fused = bool(rc.fuse_psd)
        self.block_in = rc.block_in
        self._counters = {"kernel2": channelizer2.kernel2}
        if not self.fused:
            self._counters["psd_xw"] = fft.psd_xw_kernel
        self.bounds_ms = {"kernel2": roofline.kernel2_ms(
            rc.block_out, rc.n_channels, 2 if rc.in_i16 else 4,
            2 if rc.audio_bf16 else 4, rc.audio_taps, rc.audio_decim,
            fused=self.fused, mt=None if self.fused else rc.m_tile)}
        if not self.fused:
            self.bounds_ms["psd_xw"] = roofline.psd_xw_ms(
                cfg["psd_fft"], rc.block_in // cfg["psd_fft"],
                2 if rc.in_i16 else 4, ema=False)

    # -- the timed path -------------------------------------------------
    def feed(self, x: np.ndarray):
        return self.rx.feed_async(x)

    def drain(self, handle) -> dict:
        b = self.rx.drain(handle)
        return {"audio": b.audio, "psd": b.psd}

    # -- what the harness reads around it -------------------------------
    def span_targets(self) -> list[tuple]:
        """(object, method, span name): framing, each kernel's host
        call, and the drain."""
        t = [(self.rx._chan, "_frame", "frame"),
             (self.rx._chan, "feed_packed", "kernel2"),
             (self.rx, "drain", "drain")]
        if not self.fused:
            t.append((self.rx._psd, "feed_async", "psd_xw"))
        return t

    block_span = "kernel2"

    def launches(self) -> dict[str, int]:
        return {k: fn.launches for k, fn in self._counters.items()}

    def close(self) -> None:
        del self.rx
