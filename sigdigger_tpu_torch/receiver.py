"""KernelReceiver — the port's streaming receiver (counterpart of
``sigdigger_tpu/receiver.py``).

A signal source feeds fixed blocks; the host frames each block into one
packed window buffer, uploads it once, and one call of the fused kernel
(``kernels/channelizer2.kernel2``) channelizes, FM-demodulates and
decimates every channel and computes the block's PSD.  The host fetches
the audio and the 64×64 PSD block and folds the PSD into a running EMA.

Only FM mode on the fused geometry is ported; the digital modes and the
unfused PSD geometries raise ``NotImplementedError`` naming the
ROADMAP.md entry that will port them.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Protocol

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels.channelizer2 import (
    UNSUPPORTED,
    MatChannelizer2,
    MatChannelizer2Config,
)
from sigdigger_tpu_torch.kernels.fft import PSDConfig, PSDFold


class BlockSource(Protocol):
    """What :meth:`KernelReceiver.run` reads from."""

    eos: bool

    def read(self, n: int) -> np.ndarray: ...


@dataclass
class ReceiverBlock:
    """One processed block."""

    psd: np.ndarray                   # running natural-order PSD [N]
    audio: np.ndarray                 # [T_audio, C]


class KernelReceiver:
    """Multi-channel FM receiver on the fused CUDA kernel.

    Runs on ``cuda`` unless ``device`` says otherwise; ``device="cpu"``
    runs the kernel's plain PyTorch version.
    """

    def __init__(
        self,
        sample_rate: float,
        f0s: np.ndarray,
        bw: float,
        mode: str = "fm",
        decimation: int = 64,
        block_out: int = 2048,
        psd_fft: int = 4096,
        device: str | torch.device | None = None,
        snap_grid: bool = True,
        in_i16: bool = False,
        audio_bf16: bool = False,
        audio_decim: int = 8,
        in_i8: bool = False,
    ) -> None:
        if mode != "fm":
            raise NotImplementedError(
                f"mode {mode!r} is pending in ROADMAP.md queue 1 item 3 "
                "(receiver digital modes, on the raw and recovery bank "
                "kernels of queue 2 items 4-5)")
        if not snap_grid:
            raise NotImplementedError(UNSUPPORTED)
        self.device = resolve_device(device)
        f0s = np.asarray(f0s, np.float64)
        self.mode = mode
        # the fused geometry: the four-step PSD rides the channelizer's
        # call (the reference's receiver.py:94-96 rule; the config
        # refuses any other geometry)
        self.cfg = MatChannelizer2Config(
            sample_rate=float(sample_rate), n_channels=len(f0s),
            taps=64, decimation=decimation, audio_taps=64,
            audio_decim=audio_decim, block_out=block_out,
            m_tile=min(2048, block_out), in_i16=in_i16, in_i8=in_i8,
            audio_bf16=audio_bf16, psd_fft=psd_fft,
        )
        self._chan = MatChannelizer2(self.cfg, f0s, bw, device=self.device)
        frames = self.cfg.block_in // psd_fft
        self._psd = PSDFold(PSDConfig(
            fft_size=psd_fft, frames_per_block=frames,
            frames_per_program=min(8, frames)))

    @property
    def channel_rate(self) -> float:
        return self.cfg.channel_rate

    @property
    def audio_rate(self) -> float:
        return self.cfg.channel_rate / self.cfg.audio_decim

    @property
    def block_in(self) -> int:
        return self.cfg.block_in

    def feed(self, x: np.ndarray) -> ReceiverBlock:
        return self.drain(self.feed_async(x))

    def feed_async(self, x: np.ndarray):
        """Frame, upload once and launch one block, deferring every
        device-to-host fetch.  Returns an in-flight handle for
        :meth:`drain`; handles MUST be drained in feed order (the PSD
        EMA fold is sequential)."""
        audio = self._chan.feed_async(x)
        return (self._chan.psd_block, audio)

    def drain(self, handle) -> ReceiverBlock:
        psd_h, a = handle
        psd = self._psd.fold(psd_h.cpu().numpy())
        audio = a.cpu()
        if audio.dtype != torch.float32:      # bf16 drain
            audio = audio.float()
        return ReceiverBlock(psd=psd, audio=audio.numpy())

    def run(self, source: BlockSource,
            max_blocks: int | None = None,
            pipeline_depth: int = 1) -> Iterator[ReceiverBlock]:
        """Stream blocks from ``source`` (anything with ``.eos`` and
        ``.read(n)``).  ``pipeline_depth > 1`` keeps that many blocks in
        flight, so the next block's framing and upload overlap the
        previous block's kernel."""
        inflight: deque = deque()
        n = 0
        while not source.eos:
            if max_blocks is not None and n >= max_blocks:
                break
            x = source.read(self.block_in)
            inflight.append(self.feed_async(x))
            n += 1
            if len(inflight) >= pipeline_depth:
                yield self.drain(inflight.popleft())
        while inflight:
            yield self.drain(inflight.popleft())

    # -- state carried across blocks ----------------------------------
    def state_dict(self) -> dict:
        """The carried state as plain numpy arrays."""
        ch = self._chan
        return {
            "history": ch._history.copy(),
            "prev_re": ch._prev_re.cpu().numpy(),
            "prev_im": ch._prev_im.cpu().numpy(),
            "ftail": ch._ftail.cpu().numpy(),
            "psd": self._psd.psd.copy(),
            "psd_count": self._psd._count,
        }

    def load_state(self, d: dict) -> None:
        """Restore :meth:`state_dict` output (or the same values read
        off a reference receiver)."""
        ch = self._chan
        c = ch.cfg.n_channels

        def dev(name, shape):
            a = np.asarray(d[name], np.float32).reshape(shape)
            return torch.as_tensor(a.copy(), device=self.device)

        ch._history = np.asarray(d["history"], np.complex64).copy()
        ch._prev_re = dev("prev_re", (1, c))
        ch._prev_im = dev("prev_im", (1, c))
        ch._ftail = dev("ftail", (ch.cfg.audio_taps - 1, c))
        self._psd.psd = np.asarray(d["psd"], np.float64).copy()
        self._psd._count = int(d["psd_count"])
