"""The analyzer session protocol (counterpart of
``sigdigger_tpu/analyzer/engine.py``).

The engine is a block-synchronous pipeline (reference
Suscan/Analyzer.cpp:111-623 re-designed): each ``step()`` pulls one
fixed-size IQ block from the source, folds the PSD, runs every
inspector chain and emits typed messages.  ``start()`` wraps the same
step loop in a pump thread for live use, preserving the reference's
async message-queue API (``read()`` ≙ suscan_analyzer_read).

Inspector lifecycle follows the async request protocol (reference
Suscan/Analyzer.cpp:411-598): opens and config changes are
acknowledged with InspectorMessages carrying the request id.

:class:`Analyzer` carries everything a subclass inherits: the message
queue, the source setters, ``step`` with the PSD and channel messages,
the wide-spectrum hop, watermarks, Doppler tracking, estimators,
inspector spectra and the pump thread.  Its own DSP is the class path:
``_build_dsp`` and ``_compute_block`` on ``dsp.channelizer`` and
``dsp.spectrum``, with one ``inspectors/`` chain per open inspector
(any of the reference's six classes).  ``kernel_engine.KernelAnalyzer``
overrides the DSP and the inspector lifecycle to run the session on the
kernel banks.
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.analyzer.detector import ChannelDetector
from sigdigger_tpu_torch.analyzer.messages import (
    ChannelMessage,
    InspectorMessage,
    InspectorMessageKind,
    Message,
    MessageKind,
    OrbitReport,
    PSDMessage,
    SamplesMessage,
    SourceInfoMessage,
    StatusMessage,
)
from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS
from sigdigger_tpu_torch.dsp.channelizer import Channelizer
from sigdigger_tpu_torch.dsp.spectrum import SpectrumEstimator
from sigdigger_tpu_torch.inspectors import inspector_class
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import SignalSource, make_source
from sigdigger_tpu_torch.types import (
    AnalyzerMode,
    AnalyzerParams,
    Channel,
    SourceInfo,
    next_pow2,
)


def _host(v) -> np.ndarray:
    """``v`` as a host array: a tensor (which may lie on the card) is
    fetched, anything else taken as numpy takes it."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class MessageQueue:
    """The analyzer's message queue: an unbounded FIFO that takes a
    block's messages in one hand-off (one lock, one notify) and gives a
    consumer everything queued under one lock.  Order is FIFO across
    single and batched puts from any thread."""

    def __init__(self) -> None:
        self._items: deque = deque()
        self._ready = threading.Condition(threading.Lock())

    def put(self, msg: Message) -> None:
        self.put_many((msg,))

    def put_many(self, msgs) -> int:
        """Queue ``msgs`` in order; returns the hand-offs it took (1, or
        0 for an empty list)."""
        if not msgs:
            return 0
        with self._ready:
            self._items.extend(msgs)
            self._ready.notify(len(msgs))
        return 1

    def get(self, timeout: float | None = None) -> Message | None:
        """The oldest message, waiting up to ``timeout`` seconds (for
        ever when None); None when the time runs out."""
        with self._ready:
            if not self._ready.wait_for(lambda: self._items, timeout):
                return None
            return self._items.popleft()

    def get_all(self) -> list:
        """Every queued message, oldest first, without waiting."""
        with self._ready:
            out = list(self._items)
            self._items.clear()
        return out


class AnalyzerState(enum.Enum):
    """reference include/UIMediator.h:55-61 capture state machine."""

    HALTED = "halted"
    RUNNING = "running"
    HALTING = "halting"


@dataclass
class _InspectorSlot:
    handle: int
    inspector_id: int
    class_name: str
    inspector: Any                # None on the kernel path
    chan_handle: int            # channelizer handle / bank slot index
    equiv_rate: float
    bandwidth: float
    lo: float
    estimators: set[str]
    spectrum_source: int = 0    # 0=none, 1=input spectrum
    # sample watermark (reference setInspectorWatermarkAsync,
    # Suscan/Analyzer.cpp:497-507): SamplesMessages are held until at
    # least `watermark` samples have accumulated
    watermark: int = 0
    wm_buf: list = field(default_factory=list)
    wm_count: int = 0
    # Doppler correction (reference setInspectorDopplerCorrection /
    # disableDopplerCorrection, include/Suscan/Analyzer.h:353-354):
    # an OrbitPredictor-like object with .predict(unix_time, freq_hz)
    orbit: Any = None
    orbit_corr: float = 0.0       # last applied LO shift (Hz)
    orbit_last_report: float = -1e18


class Analyzer:
    """Channel-mode analyzer session.

    Synchronous core: ``step()`` processes one block and enqueues
    messages.  Live mode: ``start()``/``halt()`` run the pump thread,
    messages drained with ``read(timeout)``.  Runs on ``cuda`` unless
    ``device`` says otherwise.
    """

    DEFAULT_FRAMES_PER_BLOCK = 8

    def __init__(
        self,
        profile: SourceProfile | None = None,
        params: AnalyzerParams | None = None,
        source: SignalSource | None = None,
        block_size: int | None = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if source is None:
            if profile is None:
                raise ValueError("need a profile or a source")
            source = make_source(profile)
        self.source = source
        self.profile = source.profile
        self.params = params or AnalyzerParams()

        rate = self.source.sample_rate
        w = next_pow2(self.params.window_size)
        self.params.window_size = w
        self.block_size = block_size or w * self.DEFAULT_FRAMES_PER_BLOCK
        if self.block_size % w:
            raise ValueError(
                f"block_size {self.block_size} not a multiple of window {w}"
            )

        self._detector = ChannelDetector(self.params, rate, w)
        self._build_dsp()

        # wide-spectrum (sweep) mode: the engine hops a tunable source
        # across [min_freq, max_freq] (reference AnalyzerParams mode +
        # hop range, include/Suscan/AnalyzerParams.h:45-60;
        # Analyzer::setHopRange)
        self._hop_rng = np.random.default_rng(0)
        self._hop_index = 0
        if self.params.mode == AnalyzerMode.WIDE_SPECTRUM:
            if not hasattr(self.source, "set_frequency"):
                raise ValueError(
                    "wide-spectrum mode needs a tunable source")
            if self.params.max_freq <= self.params.min_freq:
                raise ValueError("wide-spectrum mode needs a hop range")

        self._mq = MessageQueue()
        self._inspectors: dict[int, _InspectorSlot] = {}
        self._by_id: dict[int, int] = {}       # inspector_id → handle
        self._next_handle = 1
        self._state = AnalyzerState.HALTED
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.RLock()

        self._last_psd_emit = 0.0
        self._last_chan_emit = 0.0
        self._blocks = 0
        self._samples_done = 0
        self._t_start = None
        self._wall0: float | None = None   # capture-start unix time
        self._measured_rate = 0.0
        # Doppler-corrected inspectors emit an ORBIT_REPORT at most
        # this often (stream seconds)
        self.orbit_report_interval = 1.0
        # baseband filters: callables fed every raw block before DSP —
        # the reference's analyzer-thread tee used for raw IQ recording
        # (reference Default/Source/SourceWidget.cpp:1174-1190)
        self._bb_filters: list = []

        self.emit_source_info()

    # ------------------------------------------------------------------
    # DSP strategy hooks — the kernel-path engine (analyzer/
    # kernel_engine.py KernelAnalyzer) overrides these to run the same
    # session protocol on the bank kernels.
    # ------------------------------------------------------------------
    def _build_dsp(self) -> None:
        """Construct the spectrum estimator and channel machinery."""
        self._spectrum = SpectrumEstimator(
            self.params.window_size, self.source.sample_rate,
            self.params.window_function, self.params.spectrum_avg_alpha,
            device=self.device)
        self._channelizer = Channelizer(
            self.source.sample_rate, fft_size=self.params.window_size,
            device=self.device)

    def _compute_block(self, x: np.ndarray) -> list:
        """Channelize + run every inspector chain over one block.
        Returns [(slot, samples, extras, raw_baseband), ...]; the raw
        baseband is fetched only for a slot with estimators or an
        inspector spectrum, the messages that read it."""
        outputs = self._channelizer.feed(x)
        sample_msgs = []
        for slot in self._inspectors.values():
            y = outputs.get(slot.chan_handle)
            if y is None:
                continue
            result = slot.inspector.process(y[None, :])
            samples = result.pop("samples")[0].cpu().numpy()
            extras = {k: _host(v)[0] for k, v in result.items()}
            raw = (y.cpu().numpy()
                   if slot.estimators or slot.spectrum_source else None)
            sample_msgs.append((slot, samples, extras, raw))
        return sample_msgs

    def install_baseband_filter(self, fn) -> None:
        """Register ``fn(samples: np.ndarray) -> None`` on the raw
        source stream (recording tee)."""
        with self._lock:
            self._bb_filters.append(fn)

    def remove_baseband_filter(self, fn) -> None:
        with self._lock:
            try:
                self._bb_filters.remove(fn)
            except ValueError:
                pass

    # ------------------------------------------------------------------
    # message queue
    # ------------------------------------------------------------------
    def read(self, timeout: float | None = None) -> Message | None:
        """Blocking message read (≙ suscan_analyzer_read)."""
        return self._mq.get(timeout)

    def poll(self) -> list[Message]:
        """Drain all queued messages without blocking."""
        return self._mq.get_all()

    def _emit(self, msg: Message) -> None:
        self._mq.put(msg)

    # ------------------------------------------------------------------
    # source control (sync setters, reference Suscan/Analyzer.cpp:117-273)
    # ------------------------------------------------------------------
    @property
    def sample_rate(self) -> float:
        return self.source.sample_rate

    @property
    def state(self) -> AnalyzerState:
        return self._state

    def set_frequency(self, freq: float, lnb: float = 0.0) -> None:
        self.profile.freq = float(freq)
        self.profile.lnb_freq = float(lnb)
        self.emit_source_info()

    def set_throttle(self, enabled: bool) -> None:
        self.profile.throttle = bool(enabled)

    # sync source setters (reference Suscan/Analyzer.cpp:117-273)
    def set_gain(self, name: str, value: float) -> None:
        self.profile.gains[str(name)] = float(value)
        self.emit_source_info()

    def set_antenna(self, name: str) -> None:
        self.profile.antenna = str(name)
        self.emit_source_info()

    def set_bandwidth(self, bw: float) -> None:
        self.profile.bandwidth = float(bw)
        self.emit_source_info()

    def set_ppm(self, ppm: float) -> None:
        self.profile.ppm = float(ppm)
        self.emit_source_info()

    def set_dc_remove(self, enabled: bool) -> None:
        self.profile.dc_remove = bool(enabled)
        self.emit_source_info()

    def set_iq_reverse(self, enabled: bool) -> None:
        self.profile.iq_reverse = bool(enabled)
        self.emit_source_info()

    def set_agc(self, enabled: bool) -> None:
        self.profile.agc = bool(enabled)
        self.emit_source_info()

    def set_sweep_strategy(self, strategy) -> None:
        from sigdigger_tpu_torch.types import SweepStrategy

        self.params.sweep_strategy = (
            strategy if isinstance(strategy, SweepStrategy)
            else SweepStrategy(str(strategy)))

    def set_spectrum_partitioning(self, part) -> None:
        from sigdigger_tpu_torch.types import SpectrumPartitioning

        self.params.spectrum_partitioning = (
            part if isinstance(part, SpectrumPartitioning)
            else SpectrumPartitioning(str(part)))

    def set_buffering_size(self, size: int) -> None:
        """Sweep-mode block size (reference Scanner RTT-based buffering,
        Panoramic/Scanner.cpp:494-500)."""
        self.block_size = max(1, int(size))

    def set_history_size(self, size: int) -> None:
        self._history_size = max(0, int(size))

    def replay(self, enabled: bool) -> None:
        if not self.source.seekable:
            self._emit(StatusMessage(code=-1,
                                     message="source not seekable"))
            return
        if enabled:
            with self._lock:
                self.source.seek(0)

    def seek(self, position: int) -> None:
        if not self.source.seekable:
            self._emit(StatusMessage(code=-1, message="source not seekable"))
            return
        with self._lock:
            self.source.seek(position)

    def set_loop(self, enabled: bool) -> None:
        self.profile.loop = bool(enabled)

    def set_hop_range(self, min_freq: float, max_freq: float) -> None:
        """Adjust the wide-spectrum sweep range (reference
        Analyzer::setHopRange, Suscan/Analyzer.cpp)."""
        if max_freq <= min_freq:
            self._emit(StatusMessage(code=-3, message="bad hop range"))
            return
        self.params.min_freq = float(min_freq)
        self.params.max_freq = float(max_freq)

    def _next_hop(self) -> float:
        """Next sweep frequency per strategy/partitioning (reference
        include/Suscan/Analyzer.h:263-271 semantics)."""
        from sigdigger_tpu_torch.types import SpectrumPartitioning, SweepStrategy

        usable = self.sample_rate * self.params.hop_relative_bw
        span = self.params.max_freq - self.params.min_freq
        n_parts = max(1, int(np.ceil(span / usable)))
        if self.params.spectrum_partitioning == \
                SpectrumPartitioning.DISCRETE:
            if self.params.sweep_strategy == SweepStrategy.STOCHASTIC:
                part = int(self._hop_rng.integers(0, n_parts))
            else:
                part = self._hop_index % n_parts
                self._hop_index += 1
            return self.params.min_freq + usable * (part + 0.5)
        if self.params.sweep_strategy == SweepStrategy.STOCHASTIC:
            return float(self._hop_rng.uniform(
                self.params.min_freq + usable / 2,
                self.params.max_freq - usable / 2))
        frac = (self._hop_index % 64) / 64.0
        self._hop_index += 1
        return self.params.min_freq + usable / 2 + frac * (span - usable)

    def _step_wide_spectrum(self) -> bool:
        """One sweep hop: retune → read → PSD message at the hop
        frequency (clients stitch with SpectrumView)."""
        with self._lock:
            if self.source.eos:
                self._emit(Message(kind=MessageKind.EOS))
                return False
            hop = self._next_hop()
            self.source.set_frequency(hop)
            try:
                self.source.read(self.params.window_size)  # settle
                x = self.source.read(self.block_size)
            except Exception as e:  # noqa: BLE001
                self._emit(StatusMessage(code=-2, message=str(e)))
                self._emit(Message(kind=MessageKind.READ_ERROR))
                return False
            self._spectrum.reset()
            self._spectrum.feed(x)
            shifted = self._spectrum.shifted()
        self._samples_done += self.block_size
        self._emit(PSDMessage(
            fft_size=self.params.window_size,
            sample_rate=self.sample_rate,
            measured_sample_rate=self._measured_rate,
            frequency=hop, data=shifted,
        ))
        return True

    @property
    def source_info(self) -> SourceInfo:
        return SourceInfo(
            sample_rate=self.source.sample_rate,
            measured_sample_rate=self._measured_rate or
            self.source.sample_rate,
            frequency=self.profile.freq,
            lnb_frequency=self.profile.lnb_freq,
            bandwidth=self.profile.bandwidth or self.source.sample_rate,
            ppm=self.profile.ppm,
            antenna=self.profile.antenna,
            dc_remove=self.profile.dc_remove,
            iq_reverse=self.profile.iq_reverse,
            agc_enabled=self.profile.agc,
            seekable=self.source.seekable,
            has_time=self.profile.start_time > 0,
            source_start_time=self.profile.start_time,
            source_end_time=(
                self.profile.start_time
                + self.source.total_samples / self.source.sample_rate
                if self.profile.start_time > 0
                and getattr(self.source, "total_samples", 0)
                else 0.0),
            gains=dict(self.profile.gains),
        )

    def get_source_time(self) -> float:
        """Timestamp (unix seconds) of the sample at the current
        stream position (reference Analyzer::getSourceTimeStamp,
        Suscan/Analyzer.cpp:301-308 → suscan_analyzer_get_source_time;
        displayed by Default/SourceTimeWidget).  Timed sources (file
        captures with a start time) advance from their start; live
        sources report the capture-anchored stream time."""
        pos_t = self.source.position / self.sample_rate
        if self.profile.start_time > 0:
            return self.profile.start_time + pos_t
        if self._wall0 is not None:
            return self._wall0 + pos_t
        return time.time()

    def emit_source_info(self) -> None:
        self._emit(SourceInfoMessage(info=self.source_info))

    # ------------------------------------------------------------------
    # inspector API (async protocol, reference Suscan/Analyzer.cpp:411-598)
    # ------------------------------------------------------------------
    def open_inspector(self, class_name: str, channel: Channel,
                       request_id: int = 0,
                       config: dict[str, Any] | None = None) -> int:
        """Open a demod chain on ``channel``; returns the handle
        immediately and acknowledges with an OPEN InspectorMessage
        carrying ``request_id`` (reference open_ex_async semantics)."""
        if class_name not in INSPECTOR_SCHEMAS:
            self._emit(InspectorMessage(
                inspector_kind=InspectorMessageKind.WRONG_KIND,
                request_id=request_id, class_name=class_name))
            raise ValueError(f"unknown inspector class {class_name!r}")
        cls = inspector_class(class_name)
        with self._lock:
            bw = channel.bw or (channel.f_high - channel.f_low)
            bw = max(bw, self.sample_rate / self.params.window_size * 8)
            # audio channels are capped like the reference's
            # min(fs/2, 200 kHz) rule (Default/Audio/AudioProcessor.cpp:117)
            if class_name == "audio":
                bw = min(bw, self.sample_rate / 2.0, 200e3)
            ch = self._channelizer.open(channel.fc, bw)
            equiv_rate = self._channelizer.output_rate(ch)
            insp = cls(equiv_rate, 1, device=self.device)
            if config:
                insp.set_config(config)
            handle = self._next_handle
            self._next_handle += 1
            slot = _InspectorSlot(
                handle=handle, inspector_id=handle,
                class_name=class_name, inspector=insp, chan_handle=ch,
                equiv_rate=equiv_rate, bandwidth=bw, lo=channel.fc,
                estimators=set(),
            )
            self._inspectors[handle] = slot
            self._by_id[handle] = handle
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.OPEN,
            request_id=request_id, handle=handle, inspector_id=handle,
            class_name=class_name, config=insp.config.copy(),
            equiv_rate=equiv_rate, bandwidth=bw, lo=channel.fc,
        ))
        return handle

    def _slot(self, handle: int, request_id: int = 0) -> _InspectorSlot | None:
        slot = self._inspectors.get(handle)
        if slot is None:
            self._emit(InspectorMessage(
                inspector_kind=InspectorMessageKind.WRONG_HANDLE,
                request_id=request_id, handle=handle))
        return slot

    def set_inspector_config(self, handle: int, config: dict[str, Any],
                             request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            slot.inspector.set_config(config)
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_CONFIG,
            request_id=request_id, handle=handle,
            inspector_id=slot.inspector_id, class_name=slot.class_name,
            config=slot.inspector.config.copy(),
        ))

    def set_inspector_id(self, handle: int, inspector_id: int,
                         request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            self._by_id.pop(slot.inspector_id, None)
            slot.inspector_id = inspector_id
            self._by_id[inspector_id] = handle
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_ID,
            request_id=request_id, handle=handle, inspector_id=inspector_id,
        ))

    def set_inspector_freq(self, handle: int, freq: float,
                           request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            self._channelizer.set_frequency(slot.chan_handle, freq)
            slot.lo = freq
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_FREQ,
            request_id=request_id, handle=handle, lo=freq,
        ))

    def set_inspector_bandwidth(self, handle: int, bw: float,
                                request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            self._channelizer.set_bandwidth(slot.chan_handle, bw)
            slot.bandwidth = bw
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_BANDWIDTH,
            request_id=request_id, handle=handle, bandwidth=bw,
        ))

    def set_inspector_watermark(self, handle: int, watermark: int,
                                request_id: int = 0) -> None:
        """Hold SamplesMessages until ``watermark`` samples accumulate
        (reference setInspectorWatermarkAsync, Suscan/Analyzer.cpp:
        497-507).  0/1 restores per-block delivery."""
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            slot.watermark = max(0, int(watermark))
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_WATERMARK,
            request_id=request_id, handle=handle,
            inspector_id=slot.inspector_id,
        ))

    # ------------------------------------------------------------------
    # Doppler correction (reference include/Suscan/Analyzer.h:353-354,
    # suscan_analyzer_inspector_set_tle_async; applied live by the
    # audio chain, Default/Audio/AudioProcessor.cpp:429-450)
    # ------------------------------------------------------------------
    def set_inspector_doppler_correction(self, handle: int, predictor,
                                         request_id: int = 0) -> None:
        """Track a satellite on this inspector: ``predictor`` is an
        `orbit.OrbitPredictor` (or anything with
        ``predict(unix_time, freq_hz) -> PassInfo``).  The engine
        retunes the channel LO every block to follow the predicted
        Doppler shift and emits periodic ORBIT_REPORT messages."""
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            slot.orbit = predictor
            slot.orbit_last_report = -1e18
        # apply immediately so the first block is already corrected
        self._apply_doppler(slot, self._rx_time())

    def disable_doppler_correction(self, handle: int,
                                   request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            slot.orbit = None
            if slot.orbit_corr:
                slot.orbit_corr = 0.0
                self._retune_channel(slot, slot.lo)

    def _retune_channel(self, slot: _InspectorSlot, f0: float) -> None:
        """Move a slot's channel center WITHOUT changing the
        user-visible ``slot.lo`` (Doppler tracking)."""
        self._channelizer.set_frequency(slot.chan_handle, f0)

    def _rx_time(self) -> float:
        """Stream-anchored unix time: capture start + stream position.
        Replayed files evolve Doppler in stream time (the signal was
        recorded in real time), and throttled/faster-than-real-time
        runs stay deterministic."""
        if self._wall0 is None:
            self._wall0 = time.time()
        return self._wall0 + self._samples_done / self.sample_rate

    def _apply_doppler(self, slot: _InspectorSlot,
                       rx_time: float) -> None:
        # snapshot the predictor under the lock: a control thread may
        # disable the correction (slot.orbit = None) concurrently
        with self._lock:
            pred = slot.orbit
        if pred is None:
            return
        info = pred.predict(rx_time, self.profile.freq + slot.lo)
        corr = float(info.doppler_hz)
        with self._lock:
            if slot.handle not in self._inspectors or \
                    slot.orbit is None:
                return
            # skip sub-Hz retunes (control-rate discipline)
            if abs(corr - slot.orbit_corr) >= 1.0:
                slot.orbit_corr = corr
                self._retune_channel(slot, slot.lo + corr)
        if rx_time - slot.orbit_last_report >= \
                self.orbit_report_interval:
            slot.orbit_last_report = rx_time
            self._emit(InspectorMessage(
                inspector_kind=InspectorMessageKind.ORBIT_REPORT,
                handle=slot.handle, inspector_id=slot.inspector_id,
                class_name=slot.class_name, lo=slot.lo,
                payload=OrbitReport(
                    rx_time=rx_time,
                    azimuth_deg=info.azimuth_deg,
                    elevation_deg=info.elevation_deg,
                    distance_km=info.range_km,
                    freq_corr_hz=corr,
                    vlos_vel_kms=info.range_rate_kms,
                )))

    def _apply_orbit_corrections(self) -> None:
        with self._lock:       # control threads mutate _inspectors
            orbiting = [s for s in self._inspectors.values()
                        if s.orbit is not None]
        if not orbiting:
            return
        rx_time = self._rx_time()
        for slot in orbiting:
            self._apply_doppler(slot, rx_time)

    def _emit_block_msgs(self, msgs, now: float) -> int:
        """Queue one block's payloads ``[(slot, samples, extras, raw),
        ...]`` in one hand-off.  For each slot in order: its
        SamplesMessage, or its watermark flush once the watermark is
        reached (nothing while it only buffers); then its estimators;
        then its inspector spectrum.  Returns the hand-offs it took."""
        with self._lock:        # wm_buf is flushed by control threads
            held = [None if slot.watermark <= 1 and not slot.wm_buf
                    else self._hold(slot, samples, extras)
                    for slot, samples, extras, _ in msgs]
        out = []
        for (slot, samples, extras, raw), parts in zip(msgs, held):
            if parts is None:
                out.append(SamplesMessage(
                    inspector_id=slot.inspector_id, handle=slot.handle,
                    samples=samples, extras=extras, timestamp=now))
            elif parts:
                out.append(self._joined(slot, parts, now))
            if slot.estimators:
                out += self._estimator_msgs(slot, raw)
            if slot.spectrum_source:
                out += self._inspector_spectrum_msgs(slot, raw)
        return self._mq.put_many(out)

    def _hold(self, slot: _InspectorSlot, samples, extras) -> list:
        """Buffer one payload under the slot's watermark (the engine
        lock held); the buffered parts once the watermark is reached,
        else an empty list."""
        slot.wm_buf.append((samples, extras))
        slot.wm_count += len(samples)
        if slot.wm_count < slot.watermark:
            return []
        return self._take_watermark(slot)

    def _take_watermark(self, slot: _InspectorSlot) -> list:
        with self._lock:
            parts, slot.wm_buf, slot.wm_count = slot.wm_buf, [], 0
        return parts

    def _flush_watermark(self, slot: _InspectorSlot, now: float) -> None:
        parts = self._take_watermark(slot)
        if parts:
            self._emit(self._joined(slot, parts, now))

    @staticmethod
    def _joined(slot: _InspectorSlot, parts: list,
                now: float) -> SamplesMessage:
        """One SamplesMessage of a slot's buffered payloads."""
        samples = np.concatenate([np.atleast_1d(s) for s, _ in parts])
        extras: dict[str, Any] = {}
        for _, e in parts:
            for k, v in (e or {}).items():
                a = np.asarray(v)
                if a.ndim == 0:          # scalars: last value wins
                    extras[k] = v
                else:
                    extras.setdefault(k, []).append(a)
        extras = {k: (np.concatenate(v) if isinstance(v, list) else v)
                  for k, v in extras.items()}
        return SamplesMessage(
            inspector_id=slot.inspector_id, handle=slot.handle,
            samples=samples, extras=extras, timestamp=now)

    def set_estimator(self, handle: int, estimator_id: str, enabled: bool,
                      request_id: int = 0) -> None:
        """Toggle an in-channel estimator (reference
        Suscan/Analyzer.cpp:551-565; ids 'baud', 'offset')."""
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            if enabled:
                slot.estimators.add(estimator_id)
            else:
                slot.estimators.discard(estimator_id)

    def set_spectrum_source(self, handle: int, source_id: int,
                            request_id: int = 0) -> None:
        """Select the per-inspector secondary spectrum (reference
        Suscan/Analyzer.cpp:539-549; 0=off, 1=channel input)."""
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        slot.spectrum_source = int(source_id)

    def close_inspector(self, handle: int, request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        self._flush_watermark(slot, time.time())
        with self._lock:
            self._channelizer.close(slot.chan_handle)
            self._by_id.pop(slot.inspector_id, None)
            del self._inspectors[handle]
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.CLOSE,
            request_id=request_id, handle=handle,
            inspector_id=slot.inspector_id,
        ))

    # ------------------------------------------------------------------
    # pipeline
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Process one block; returns False when the source is done."""
        if self.params.mode == AnalyzerMode.WIDE_SPECTRUM:
            return self._step_wide_spectrum()
        with self._lock:
            if self.source.eos:
                self._emit(Message(kind=MessageKind.EOS))
                return False
            try:
                x = self.source.read(self.block_size)
            except Exception as e:  # noqa: BLE001 — maps to READ_ERROR
                self._emit(StatusMessage(code=-2, message=str(e)))
                self._emit(Message(kind=MessageKind.READ_ERROR))
                return False
            looped = self.source.looped
            for bb in self._bb_filters:
                bb(x)

            if self._t_start is None:
                self._t_start = time.monotonic()
            self._feed_spectrum(x)
            sample_msgs = self._compute_block(x)

        # emit outside the lock
        self._blocks += 1
        self._samples_done += self.block_size
        elapsed = time.monotonic() - self._t_start
        if elapsed > 0:
            self._measured_rate = self._samples_done / elapsed

        now = time.time()
        stream_t = self._samples_done / self.sample_rate
        if ((stream_t - self._last_psd_emit >= self.params.psd_update_interval
                or self._blocks == 1)
                # a pipelined spectrum (kernel engine, depth>1) has
                # nothing folded yet on the first block(s) — hold the
                # PSD message until real data exists
                and getattr(self._spectrum, "_count", 1) > 0):
            self._last_psd_emit = stream_t
            shifted = self._spectrum.shifted()
            self._detector.feed(shifted)
            self._emit(PSDMessage(
                fft_size=self.params.window_size,
                sample_rate=self.sample_rate,
                measured_sample_rate=self._measured_rate,
                frequency=self.profile.freq,
                looped=looped, data=shifted, timestamp=now,
            ))
        if stream_t - self._last_chan_emit >= \
                self.params.channel_update_interval:
            self._last_chan_emit = stream_t
            channels = self._detector.detect(self.profile.freq)
            if channels:
                self._emit(ChannelMessage(channels=channels))

        self._emit_block_msgs(sample_msgs, now)
        self._apply_orbit_corrections()
        return True

    def _feed_spectrum(self, x: np.ndarray) -> None:
        """Spectrum-path hook: subclasses may fold the PSD elsewhere
        (the kernel engine shares the channelizer's packed upload)."""
        self._spectrum.feed(x)

    def _estimator_msgs(self, slot: _InspectorSlot, y: np.ndarray) -> list:
        from sigdigger_tpu_torch.analyzer.estimators import estimate

        out = []
        for est_id in sorted(slot.estimators):
            value = estimate(est_id, y, slot.equiv_rate,
                             device=self.device)
            if value is not None:
                out.append(InspectorMessage(
                    inspector_kind=InspectorMessageKind.ESTIMATOR,
                    handle=slot.handle, inspector_id=slot.inspector_id,
                    estimator_id=est_id, estimator_value=float(value),
                ))
        return out

    def _inspector_spectrum_msgs(self, slot: _InspectorSlot,
                                 y: np.ndarray) -> list:
        n = min(1024, 1 << int(np.log2(max(len(y), 2))))
        if n < 64:
            return []
        frame = y[:n] * np.hanning(n)
        spec = np.fft.fftshift(np.abs(np.fft.fft(frame)) ** 2).astype(
            np.float32)
        return [InspectorMessage(
            inspector_kind=InspectorMessageKind.SPECTRUM,
            handle=slot.handle, inspector_id=slot.inspector_id,
            spectrum_data=spec, spectrum_rate=slot.equiv_rate,
        )]

    # ------------------------------------------------------------------
    # pump thread (live mode)
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._state == AnalyzerState.RUNNING:
            return
        self._stop.clear()
        self._state = AnalyzerState.RUNNING
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="analyzer-pump")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.step():
                break
        self._state = AnalyzerState.HALTED
        self._emit(Message(kind=MessageKind.HALT))

    def halt(self, join_timeout: float = 10.0) -> None:
        """Ordered teardown (reference HALTING→HALTED flow,
        App/Application.cpp:461-495)."""
        self._state = AnalyzerState.HALTING
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None
        else:
            self._state = AnalyzerState.HALTED
            self._emit(Message(kind=MessageKind.HALT))
        self.source.close()
