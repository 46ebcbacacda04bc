"""KernelReceiver — the port's streaming receiver (counterpart of
``sigdigger_tpu/receiver.py``).

A signal source feeds fixed blocks.  In FM mode the host frames each
block into one packed window buffer and uploads it once; one call of
the FM channelizer kernel (``kernels/channelizer2.kernel2``)
channelizes, FM-demodulates and decimates every channel.  The PSD comes
out of the same call on the fused geometry (snapped grid, decimation
64, ``psd_fft`` 4096, ``m_tile % 256 == 0``); otherwise it is read from
the same upload by ``kernels/fft.psd_xw_kernel`` when its frames are
the upload's rows (decimation 64, ``psd_fft`` 2048 or 4096), and
computed from the raw IQ by ``kernels/fft.psd_kernel`` when they are
not.  In the digital modes (``psk``/``fsk``/``ask``) three kernels run
per block: the standalone PSD, the raw bank
(``kernels/rawbank.raw_kernel``) and the recovery bank
(``kernels/recovery.recovery_kernel``), whose input planes never leave
the device.  The host fetches the audio or the symbols and strobes,
and folds the PSD into a running EMA.

Each block is traced (``utils/profiling``) while a ``torch.profiler``
session is active: ``rx.feed`` (its framing ``rx.frame``, uploads
``rx.upload`` and kernel calls ``launch``) and ``rx.drain`` (``rx.wait``
for the block's last launch, the fetches ``rx.fetch``, the bf16
conversion ``rx.convert``, the PSD fold ``rx.fold``), under the block
id that :meth:`KernelReceiver.feed_async` assigns and its handle
carries.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Protocol

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels.channelizer2 import (
    MatChannelizer2,
    MatChannelizer2Config,
)
from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig, PSDFold, PSDFromXW
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig
from sigdigger_tpu_torch.kernels.recovery import (
    KIND_ASK,
    KIND_FSK,
    KIND_PSK,
    RecoveryBank,
    RecoveryBankConfig,
)
from sigdigger_tpu_torch.native import counts_per_unit
from sigdigger_tpu_torch.types import WindowFunction
from sigdigger_tpu_torch.utils import profiling

_KINDS = {"psk": KIND_PSK, "fsk": KIND_FSK, "ask": KIND_ASK}
_HOST = torch.device("cpu")


def _fetch(t: torch.Tensor) -> torch.Tensor:
    return profiling.copy_to("rx.fetch", t, _HOST)


class BlockSource(Protocol):
    """What :meth:`KernelReceiver.run` reads from."""

    eos: bool

    def read(self, n: int) -> np.ndarray: ...


@dataclass
class Inflight:
    """A block fed and not yet drained."""

    block: int                     # its id (``profiling.new_block``)
    outs: tuple                    # the device outputs to fetch
    done: torch.cuda.Event | None  # recorded after its last launch while
    #                                tracing on a card, else None


@dataclass
class ReceiverBlock:
    """One processed block."""

    psd: np.ndarray                   # running natural-order PSD [N]
    audio: np.ndarray | None = None   # [T_audio, C] (fm mode)
    symbols: np.ndarray | None = None  # [T, C] complex64 (digital modes)
    strobes: np.ndarray | None = None  # [T, C] bool (digital modes)


class KernelReceiver:
    """Multi-channel receiver on the port's CUDA kernels.

    mode: ``"fm"`` (channelize + demod + audio, with the PSD fused or
    beside it) or ``"psk"``/``"fsk"``/``"ask"`` (PSD, raw bank, then the
    recovery bank at ``baud`` symbols/s, ``psk_order`` for psk).
    ``snap_grid`` snaps the FM channel centres to the block-rate grid
    (table rotator); ``snap_grid=False`` keeps them and carries the
    rotator phase across blocks (cos/sin rotator).  Runs on
    ``cuda`` unless ``device`` says otherwise; ``device="cpu"`` runs the
    kernels' plain PyTorch versions.
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
        baud: float | None = None,
        psk_order: int = 4,
        device: str | torch.device | None = None,
        snap_grid: bool = True,
        in_i16: bool = False,
        audio_bf16: bool = False,
        audio_decim: int = 8,
        in_i8: bool = False,
    ) -> None:
        if mode != "fm" and mode not in _KINDS:
            raise ValueError(f"mode must be fm, psk, fsk or ask, not {mode!r}")
        self.device = resolve_device(device)
        self._fed = self._drained = 0
        f0s = np.asarray(f0s, np.float64)
        n_channels = len(f0s)
        self.mode = mode
        self.audio_decim = audio_decim
        frames = block_out * decimation // psd_fft
        psd_cfg = PSDConfig(fft_size=psd_fft, frames_per_block=frames,
                            frames_per_program=min(8, frames))
        if mode == "fm":
            # the reference's receiver.py:94-107 and 146-169: the PSD is
            # fused on the Bailey geometry, read from the channelizer's
            # upload when its rows are the PSD's frames (B == taps ==
            # decimation), and a kernel of its own on the raw IQ else
            m_tile = min(2048, block_out)
            fuse = (snap_grid and psd_fft == 4096 and decimation == 64
                    and m_tile % 256 == 0)
            self.cfg = MatChannelizer2Config(
                sample_rate=float(sample_rate), n_channels=n_channels,
                taps=64, decimation=decimation, audio_taps=64,
                audio_decim=audio_decim, block_out=block_out,
                m_tile=m_tile, in_i16=in_i16, in_i8=in_i8,
                audio_bf16=audio_bf16, fuse_psd=fuse, psd_fft=psd_fft,
            )
            self._chan = MatChannelizer2(self.cfg, f0s, bw,
                                         device=self.device,
                                         snap_grid=snap_grid)
            self._shared_psd = psd_cfg.b == 64 and decimation == 64
            if fuse:
                self._psd = PSDFold(psd_cfg)
            elif self._shared_psd:
                self._psd = PSDFromXW(
                    psd_cfg, block_out, float(sample_rate),
                    WindowFunction.BLACKMANN_HARRIS,
                    in_scale=1.0 / counts_per_unit(
                        in_i16, in_i8, self.cfg.i16_scale, self.cfg.i8_scale),
                    device=self.device)
            else:
                self._psd = PSD(psd_cfg, float(sample_rate),
                                WindowFunction.BLACKMANN_HARRIS,
                                device=self.device)
            return
        # digital modes: the raw bank's planes chain into the recovery
        # bank on the device; the PSD is its own kernel on the raw IQ
        # (receiver.py:109-145, 166-169)
        self.cfg = RawBankConfig(
            sample_rate=float(sample_rate), n_channels=n_channels, taps=64,
            decimation=decimation, block_out=block_out,
            m_tile=min(2048, block_out))
        self._chan = None
        self._raw = RawBank(self.cfg, device=self.device)
        self._rec = RecoveryBank(RecoveryBankConfig(
            n_channels=n_channels, block_len=block_out), device=self.device)
        self._psd = PSD(psd_cfg, float(sample_rate),
                        WindowFunction.BLACKMANN_HARRIS, device=self.device)
        sps = self.channel_rate / float(baud or (self.channel_rate / 4))
        self._raw.begin_defer()
        self._rec.begin_defer()
        for i, f0 in enumerate(f0s):
            self._raw.configure_channel(i, f0=float(f0), bw=bw)
            self._rec.configure_channel(
                i, kind=_KINDS[mode], sps=sps,
                order=psk_order if mode == "psk" else 2,
                loop_bw=0.005, clock_gain=0.05, use_mf=(mode == "psk"))
        self._raw.end_defer()
        self._rec.end_defer()

    @property
    def channel_rate(self) -> float:
        return self.cfg.channel_rate

    @property
    def audio_rate(self) -> float:
        return self.cfg.channel_rate / self.audio_decim

    @property
    def block_in(self) -> int:
        return self.cfg.block_in

    def feed(self, x: np.ndarray) -> ReceiverBlock:
        return self.drain(self.feed_async(x))

    def feed_async(self, x: np.ndarray) -> Inflight:
        """Frame, upload and launch one block, deferring every
        device-to-host fetch.  Returns an in-flight handle for
        :meth:`drain`; handles MUST be drained in feed order (the PSD
        EMA fold is sequential)."""
        block = profiling.new_block()
        with profiling.span("rx.feed", block=block, cpu=True,
                            inflight=self._fed - self._drained):
            outs = self._launch(x)
            done = None
            if self.device.type == "cuda" and profiling.enabled():
                done = torch.cuda.Event()
                done.record()
        self._fed += 1
        return Inflight(block, outs, done)

    def _launch(self, x: np.ndarray) -> tuple:
        if self.mode == "fm":
            if self.cfg.fuse_psd:
                # one upload, one launch: the PSD block comes out of the
                # channelizer's own call
                audio = self._chan.feed_async(x)
                return (self._chan.psd_block, audio)
            if self._shared_psd:
                # one upload, two kernels
                xw = profiling.copy_to(
                    "rx.upload", torch.from_numpy(self._chan._frame(x)),
                    self.device)
                return (self._psd.feed_async(xw), self._chan.feed_packed(xw))
            return (self._psd.feed_async(x), self._chan.feed_async(x))
        psd_h = self._psd.feed_async(x)
        # device-resident chaining: the raw planes never visit the host
        y_re, y_im = self._raw.feed_frames(*self._raw.frame(x), fetch=False)
        return (psd_h,) + self._rec.feed_planes(y_re, y_im, fetch=False)

    def drain(self, handle: Inflight) -> ReceiverBlock:
        self._drained += 1
        with profiling.span("rx.drain", block=handle.block):
            with profiling.span("rx.wait"):
                if handle.done is not None:
                    handle.done.synchronize()
            outs = handle.outs
            psd = self._psd.fold(_fetch(outs[0]).numpy())
            if self.mode == "fm":
                audio = _fetch(outs[1])
                if audio.dtype != torch.float32:      # bf16 drain
                    with profiling.span("rx.convert"):
                        audio = audio.float()
                return ReceiverBlock(psd=psd, audio=audio.numpy())
            sym_re, sym_im, strobe = outs[1:]
            return ReceiverBlock(
                psd=psd,
                symbols=_fetch(torch.complex(sym_re, sym_im)).numpy(),
                strobes=_fetch(strobe > 0.5).numpy())

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
        out = {"psd": self._psd.psd.copy(), "psd_count": self._psd._count}
        if self.mode == "fm":
            ch = self._chan
            out.update(history=ch._history.copy(),
                       prev_re=ch._prev_re.cpu().numpy(),
                       prev_im=ch._prev_im.cpu().numpy(),
                       ftail=ch._ftail.cpu().numpy())
            if not ch.snap_grid:
                out["phi"] = ch._phi.copy()
        else:
            st = self._rec.state
            out.update(history=self._raw._history.copy(),
                       phi=self._raw._phi.copy(),
                       rec_state=(st.cpu().numpy() if isinstance(
                           st, torch.Tensor) else np.array(st)))
        return out

    def load_state(self, d: dict) -> None:
        """Restore :meth:`state_dict` output (or the same values read
        off a reference receiver: its channelizer's carries in FM mode,
        with its rotator phase ``_phi`` when the grid is not snapped,
        its raw bank's ``_history``/``_phi`` and recovery ``state`` in
        the digital modes)."""
        c = self.cfg.n_channels
        self._psd.psd = np.asarray(d["psd"], np.float64).copy()
        self._psd._count = int(d["psd_count"])
        if self.mode != "fm":
            self._raw._history = np.asarray(d["history"],
                                            np.complex64).copy()
            self._raw._phi = np.asarray(d["phi"], np.float64).copy()
            rows = self._rec.STATE_ROWS
            self._rec.state = torch.as_tensor(np.asarray(
                d["rec_state"], np.float32).reshape(rows, c).copy(),
                device=self.device)
            return
        ch = self._chan

        def dev(name, shape):
            a = np.asarray(d[name], np.float32).reshape(shape)
            return torch.as_tensor(a.copy(), device=self.device)

        ch._history = np.asarray(d["history"], np.complex64).copy()
        ch._prev_re = dev("prev_re", (1, c))
        ch._prev_im = dev("prev_im", (1, c))
        ch._ftail = dev("ftail", (ch.cfg.audio_taps - 1, c))
        if not ch.snap_grid:
            ch._phi = np.asarray(d["phi"], np.float64).reshape(1, c).copy()
