"""KernelAnalyzer — the dynamic analyzer session on the port's kernel
banks (counterpart of ``sigdigger_tpu/analyzer/kernel_engine.py``).

It runs the session protocol of :class:`~.engine.Analyzer` — message
taxonomy, async inspector acks, the config-key contract (reference
Suscan/Analyzer.cpp:111-623) — on the hand-written CUDA kernels:

- spectrum → ``kernels/fft.py``: read from the channelizer's shared
  upload (``PSDFromXW.feed_ema``, the EMA on the device) when a
  bucket's decimation equals the taps and the PSD's B, else the
  standalone ``PSD`` on the raw block;
- channel extraction → ``kernels/rawbank.py`` (raw streams, power,
  estimators and inspector spectra, and the recovery bank's input);
- "audio" inspectors → ``kernels/audio.py`` (AM/FM/USB/LSB/RAW with
  squelch, AGC, cutoff and volume; the su_agc hang follower in the
  kernel);
- "psk"/"fsk"/"ask" inspectors → ``kernels/recovery.py``;
- the drain → ``kernels/drainpack.py``: while the active slots fit
  ``compact_cols``, one int16 buffer per bucket holds every section at
  its own width (the digital planes squeezed ``symbol_group``× by
  ``kernels/symsqueeze.py`` first), and a section too narrow for the
  buffer's lane grouping drains through its own int16
  ``kernels/compact.py`` compactor; with ``drain_pack=False`` the
  compactors drain every section at ``compact_cols``; past that width,
  the full planes.

Open, retune and close are constant updates of a pre-allocated slot
shared by the banks.  Per-channel decimation is bucketed: each declared
decimation class has its own bank trio, and an inspector lands in the
slowest bucket that covers its bandwidth.  Audio is resampled to
``audio.sample-rate`` on the host by linear interpolation.  The host
demap of a drained block runs one numpy pass per inspector class
(``analyzer/demap.py``), on a plan kept per bucket until the block
layout or a demap parameter changes.

Where the port's signature differs from the reference's:
- ``device`` takes the place of ``interpret``; ``in_i16`` and
  ``drain_bf16`` default to on for ``cuda`` and off for ``cpu``.
- ``symbol_group`` squeezes only on the packed drain, as in the
  reference.
- ``mesh`` is a ``parallel.Mesh`` of ``torch.device``s driven by this
  process (``parallel/banks.py``); ``device`` defaults to its first
  device.  A ("ch",) mesh shards the banks and the PSD's frames on the
  channel axis, a ("time", "ch") mesh time-shards the banks
  (``parallel/timebanks.py``).  As in the reference, a meshed session
  keeps the block power-EMA AGC (``hang_agc`` off), uploads float32
  frames, and builds no squeeze, compactor, packer or shared-upload
  PSD: it drains the full planes.

Each block is traced (``utils/profiling``) while a ``torch.profiler``
session is active, under the block id :meth:`KernelAnalyzer._compute_block`
assigns: on the stepping thread ``an.feed`` (the framing ``an.frame``,
the upload ``an.upload``, the PSD's ``an.psd`` and the banks'
``an.dispatch``; the drain queue's depth at the put as its attribute
``queue_depth``), and on the thread that drains it ``an.drain`` (the
copies ``an.fetch``, the demap ``an.demap`` with the slots its class
passes took, ``batched``, and those the per-slot demap took,
``per_slot``, and the emission ``an.emit`` with its ``messages`` and
the queue ``handoffs`` they took, one a block).  Each drained block
leaves a record, its id and the number of SAMPLES payloads it emitted, or the error its
drain raised: :meth:`KernelAnalyzer.wait_block` waits for one and
raises for a block whose drain failed.  With no profiler a span costs
one flag read.

Three faults of the reference are not carried over:
- ``kernel_engine.py:929`` (``ADVICE.md``): the threaded drain fetches
  without the engine lock but demaps the slots' state under it, so
  control calls from other threads never race the demap;
- ``kernel_engine.py:1084``: the side compactors' planes are selected
  per section when the section drains, where the reference builds every
  section's tuple first and ``tuple(dig)`` raises with an audio or raw
  side and no digital inspector;
- ``kernel_engine.py:1271``: the side-compactor fetch loop does not
  rebind the block's compaction flag.
"""

from __future__ import annotations

import operator
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.analyzer.demap import DemapPlan
from sigdigger_tpu_torch.analyzer.engine import Analyzer, _host, _InspectorSlot
from sigdigger_tpu_torch.analyzer.estimators import prepare as prepare_est
from sigdigger_tpu_torch.analyzer.messages import (
    InspectorMessage,
    InspectorMessageKind,
)
from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS, Config
from sigdigger_tpu_torch.kernels.audio import AudioBank, AudioBankConfig
from sigdigger_tpu_torch.kernels.compact import (
    ColumnCompactor,
    ColumnCompactorConfig,
)
from sigdigger_tpu_torch.kernels.drainpack import (
    A_SCALE,
    D_SCALE,
    R_SCALE,
    T_SCALE,
    DrainPacker,
    DrainPackerConfig,
)
from sigdigger_tpu_torch.kernels.fft import PSD, PSDConfig, PSDFromXW
from sigdigger_tpu_torch.kernels.rawbank import RawBank, RawBankConfig
from sigdigger_tpu_torch.kernels.recovery import (
    KIND_ASK,
    KIND_FSK,
    KIND_PSK,
    RecoveryBank,
    RecoveryBankConfig,
)
from sigdigger_tpu_torch.kernels.symsqueeze import (
    SymbolSqueeze,
    SymbolSqueezeConfig,
)
from sigdigger_tpu_torch.native import I8_SCALE, I16_SCALE, counts_per_unit
from sigdigger_tpu_torch.types import AnalyzerMode, Channel
from sigdigger_tpu_torch.utils import largest_divisor, profiling
from sigdigger_tpu_torch.utils.logger import Logger

_DIGITAL = {"psk": KIND_PSK, "fsk": KIND_FSK, "ask": KIND_ASK}


def ks_schema_keys(slot) -> set[str]:
    """All schema keys of a slot's inspector class (warn only on keys
    that exist in the contract yet have no kernel-path effect)."""
    return {f.name for f in INSPECTOR_SCHEMAS[slot.class_name]}


class _HostResampler:
    """Streaming linear-interpolation rate converter (numpy)."""

    def __init__(self, rate_in: float, rate_out: float) -> None:
        self.ratio = float(rate_in) / float(rate_out)
        self._pos = 0.0
        self._last = 0.0

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if not len(x):
            return x
        ext = np.concatenate([[self._last], np.asarray(x, np.float64)])
        # output sample k sits at input position _pos + k*ratio (in ext
        # coordinates, +1 for the carried sample)
        n_out = int(np.floor((len(ext) - 1 - self._pos) / self.ratio))
        if n_out <= 0:
            self._pos -= len(x)
            self._last = x[-1]
            return np.zeros(0, np.float32)
        pos = self._pos + np.arange(n_out) * self.ratio
        out = np.interp(pos, np.arange(len(ext)) - 1.0, ext)
        self._pos = self._pos + n_out * self.ratio - len(x)
        self._last = x[-1]
        return out.astype(np.float32)


class _Entry(list):
    """One block's bucket handles in the pipeline, with its block id."""

    def __init__(self, handles: list, block: int | None) -> None:
        super().__init__(handles)
        self.block = block


class _KernelSlotExtra:
    """Per-inspector host-side bits the banks don't hold."""

    def __init__(self, idx: int, config: Config) -> None:
        self.idx = idx
        self.config = config
        self.resampler: _HostResampler | None = None
        self.pw_acc = 0.0
        self.pw_cnt = 0
        self.offset = 0.0           # afc.offset / ask.offset (Hz)
        self.bucket = None          # _Bucket hosting this slot
        self.agc_ema: float | None = None  # digital drain AGC power EMA
        # EMA-tracked decision ranges (stable symbol boundaries across
        # blocks — reference Decider fixed min/max)
        self.dec_span: float | None = None   # fsk |freq| span
        self.dec_vmax: float | None = None   # ask amplitude max


# config keys each inspector class honors on the kernel path; a set of
# any OTHER schema key is acknowledged but logged loudly (reference
# contract: Default/GenericInspector/InspectorCtl/*.cpp)
_HONORED_KEYS: dict[str, set[str]] = {
    "audio": {"audio.cutoff", "audio.volume", "audio.sample-rate",
              "audio.demodulator", "audio.squelch",
              "audio.squelch-level", "agc.enabled", "agc.gain",
              "agc.ts"},
    "psk": {"afc.bits-per-symbol", "afc.costas-order", "afc.loop-bw",
            "afc.offset", "mf.type", "mf.roll-off", "clock.baud",
            "clock.gain", "clock.phase", "clock.running", "clock.type",
            "equalizer.type", "equalizer.rate", "equalizer.locked",
            "agc.enabled", "agc.gain", "agc.ts"},
    "fsk": {"fsk.bits-per-symbol", "fsk.phase", "fsk.quad-demod",
            "mf.type", "mf.roll-off", "clock.baud", "clock.gain",
            "clock.phase", "clock.running", "clock.type",
            # the fsk discriminator is amplitude-invariant: the gain-
            # control contract is honored trivially
            "agc.enabled", "agc.gain", "agc.ts"},
    "ask": {"ask.bits-per-symbol", "ask.channel", "ask.loop-bw",
            "ask.offset", "ask.use-pll", "mf.type", "mf.roll-off",
            "clock.baud", "clock.gain", "clock.phase", "clock.running",
            "clock.type", "agc.enabled", "agc.gain", "agc.ts"},
    "raw": {"agc.enabled", "agc.gain", "agc.ts"},
    "power": {"power.integrate-samples"},
}


class _Bucket:
    """One (decimation) class of pre-allocated inspector slots: its own
    RawBank + AudioBank + RecoveryBank at equiv_rate = fs/decimation
    (reference per-inspector decimation choice, Tasks/LPFTask.cpp:52-69)."""

    def __init__(self, decimation: int, raw: RawBank, audio: AudioBank,
                 rec: RecoveryBank, n_slots: int) -> None:
        self.decimation = decimation
        self.raw = raw
        self.audio = audio
        self.rec = rec
        self.free = list(range(n_slots - 1, -1, -1))
        # device-side active-column compaction (kernels/compact.py):
        # built by the engine when n_slots >= compact_cols; cmap maps
        # slot idx -> compact column while the active set fits
        self.comp_digital: ColumnCompactor | None = None
        self.comp_raw: ColumnCompactor | None = None
        self.comp_audio: ColumnCompactor | None = None
        self.cmap: dict[int, int] = {}
        self.active: list[int] = []
        # per-section active slot lists ("audio" slots, "digital" =
        # psk/fsk/ask, "raw" = slots that consume the raw planes on the
        # host): the packed drain packs each section at its own width
        self.active_by: dict[str, list[int]] = {
            "audio": [], "digital": [], "raw": []}
        # single-fetch drain packers, keyed by their layout (sections
        # present, widths, digital rows); a new variant is a new Python
        # object over the same kernel
        self.packers: dict[tuple, DrainPacker] = {}
        # device symbol-rate squeeze of the digital planes (built when
        # the engine runs with symbol_group > 1)
        self.squeeze: SymbolSqueeze | None = None
        # int16 compactors for sections too narrow for the packer's lane
        # grouping, keyed (section, width, rows)
        self.sides: dict[tuple, ColumnCompactor] = {}
        # time-sharded wrappers (("time", "ch") mesh; parallel/timebanks)
        self.t_raw = None
        self.t_audio = None
        self.t_rec = None
        # the demap's plan of the last block layout drained
        # (analyzer/demap.py)
        self.plan: DemapPlan | None = None

    @property
    def channel_rate(self) -> float:
        return self.raw.cfg.channel_rate

    @property
    def audio_rate(self) -> float:
        return self.audio.cfg.audio_rate


class KernelAnalyzer(Analyzer):
    """Analyzer running its hot path on the port's kernel banks.

    ``decimations`` declares the available (bw, rate) bucket classes —
    each gets ``n_slots`` pre-allocated inspector slots at
    equiv_rate = fs / decimation; ``open_inspector`` places each
    inspector in the slowest bucket that still covers its bandwidth
    (with a 1.25 guard).  ``decimation`` names the primary bucket.
    Runs on ``cuda`` unless ``device`` says otherwise.
    """

    # drain records kept (ids and counts: a few hundred kB)
    RECORDS = 4096

    def __init__(self, profile=None, params=None, source=None,
                 block_size: int | None = None, n_slots: int = 128,
                 decimation: int = 64, audio_decim: int = 8,
                 decimations: tuple[int, ...] | None = None,
                 device=None, mesh=None,
                 compact_cols: int = 32,
                 pipeline_depth: int = 1,
                 in_i16: bool | None = None,
                 drain_bf16: bool | None = None,
                 drain_pack: bool = True,
                 in_i8: bool = False,
                 symbol_group: int = 1,
                 drain_thread: bool = False) -> None:
        if mesh is not None:
            from sigdigger_tpu_torch.parallel.banks import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, got "
                                f"{type(mesh).__name__}")
            if device is None:
                device = mesh.home
        self._mesh = mesh
        self._compact_cols = int(compact_cols)
        # int16 packed uploads (in-kernel dequantization at 4096
        # counts/unit) default on for cuda, off for cpu so CPU runs stay
        # exact; in_i8 (opt-in) at 64 counts/unit
        self._in_i16 = in_i16
        self._in_i8 = bool(in_i8)
        # bf16 drains of the audio and digital compactors (raw IQ stays
        # float32); same default policy as in_i16
        self._drain_bf16 = drain_bf16
        # single-fetch int16 drain packing (kernels/drainpack.py): the
        # whole per-block drain in ONE device-to-host copy.  Quantization:
        # audio 1/4096, soft symbols 1/8192, raw IQ 1/4096, strobes exact
        self._drain_pack = bool(drain_pack)
        # depth > 1 overlaps the next block's framing/upload with the
        # previous block's device compute and drain (messages lag
        # depth-1 blocks; flushed at EOS)
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: list = []
        # symbol_group R > 1 squeezes the digital planes R× on the device
        # before the packed drain (kernels/symsqueeze.py); requires sps
        # >= R+1 on every digital inspector (validated at configure)
        self._symbol_group = max(1, int(symbol_group))
        # drain_thread moves fetch + demap + message emission to a
        # worker so the host demap overlaps the next block
        self._drain_thread_on = bool(drain_thread)
        self._drain_worker = None
        self._drain_q = None
        self._n_slots = int(n_slots)
        self._defer_compact = False
        # version of what the demap reads of the slots: every control
        # call that changes it (open, close, config, bandwidth, an
        # estimator, a spectrum source; the compact-map refresh) bumps
        # it, and a bucket's demap plan is rebuilt at the next block
        # (a retune changes nothing the demap reads)
        self._plan_version = 0
        self._decimation = int(decimation)
        self._audio_decim = int(audio_decim)
        self._decimations = tuple(sorted(
            set(decimations or ()) | {int(decimation)}, reverse=True))
        # id of the last block step() took in, and each drained block's
        # record {id: (SAMPLES payloads, error or None)}
        self.last_block: int | None = None
        self._records: OrderedDict = OrderedDict()
        self._records_cv = threading.Condition()
        super().__init__(profile=profile, params=params, source=source,
                         block_size=block_size, device=device)

    # ------------------------------------------------------------------
    # DSP construction
    # ------------------------------------------------------------------
    def _build_dsp(self) -> None:
        rate = self.source.sample_rate
        w = self.params.window_size
        dev = self.device
        on_card = dev.type == "cuda"
        if self._in_i16 is None:
            self._in_i16 = on_card
        if self._drain_bf16 is None:
            self._drain_bf16 = on_card
        mesh = self._mesh
        # a ("time", "ch") mesh time-shards one wideband stream on the
        # banks; a ("ch",) mesh shards their channels
        self._tmesh = (mesh is not None and "time" in mesh.axis_names
                       and mesh.shape["time"] > 1)
        n_mesh = mesh.shape["ch"] if mesh is not None else 1
        if self._n_slots % n_mesh:
            raise ValueError(
                f"n_slots {self._n_slots} must be a multiple of the "
                f"mesh size {n_mesh}")
        frames = self.block_size // w
        if frames % n_mesh:
            raise ValueError(
                f"PSD frames per block {frames} must be a multiple of "
                f"the mesh size {n_mesh}")
        self._spectrum = PSD(
            PSDConfig(fft_size=w, frames_per_block=frames,
                      frames_per_program=largest_divisor(frames // n_mesh,
                                                         8)),
            rate, self.params.window_function,
            alpha=self.params.spectrum_avg_alpha, device=dev)
        if mesh is not None:
            from sigdigger_tpu_torch.parallel.banks import shard_psd

            shard_psd(self._spectrum, mesh)

        in_scale = I8_SCALE if self._in_i8 else I16_SCALE
        self._buckets: dict[int, _Bucket] = {}
        for d in self._decimations:
            if self.block_size % (d * self._audio_decim):
                raise ValueError(
                    f"block_size {self.block_size} must be a multiple "
                    f"of decimation*audio_decim = "
                    f"{d * self._audio_decim}")
            block_out = self.block_size // d
            m_tile = largest_divisor(block_out, 2048)
            if m_tile % self._audio_decim:
                raise ValueError(
                    f"derived m_tile {m_tile} not a multiple of audio "
                    f"decimation {self._audio_decim}")
            # the reference's FIR chunk choice (kernel_engine.py:364-365)
            ft = (1024 if m_tile % 1024 == 0
                  and 1024 % self._audio_decim == 0 else 0)
            audio = AudioBank(AudioBankConfig(
                sample_rate=rate, n_channels=self._n_slots,
                decimation=d, audio_decim=self._audio_decim,
                block_out=block_out, m_tile=m_tile, enable_ssb=True,
                in_scale=in_scale, fir_tile=ft,
                # the su_agc hang follower runs in the kernel on single-
                # device sessions; meshed sessions keep the block power-
                # EMA AGC (the follower state is a sequential cross-
                # shard carry), as the reference's kernel_engine.py:370-375
                hang_agc=mesh is None), device=dev)
            raw = RawBank(RawBankConfig(
                sample_rate=rate, n_channels=self._n_slots,
                decimation=d, block_out=block_out, m_tile=m_tile,
                in_scale=in_scale), device=dev)
            rec = RecoveryBank(RecoveryBankConfig(
                n_channels=self._n_slots, block_len=block_out), device=dev)
            bucket = _Bucket(d, raw, audio, rec, self._n_slots)
            if self._tmesh:
                from sigdigger_tpu_torch.parallel.timebanks import (
                    TimeShardedAudioBank,
                    TimeShardedRawBank,
                    TimeShardedRecoveryBank,
                )

                bucket.t_raw = TimeShardedRawBank(raw, mesh)
                bucket.t_audio = TimeShardedAudioBank(audio, mesh)
                bucket.t_rec = TimeShardedRecoveryBank(rec, mesh)
            elif mesh is not None:
                from sigdigger_tpu_torch.parallel.banks import (
                    shard_audio_bank,
                    shard_raw_bank,
                    shard_recovery_bank,
                )

                shard_audio_bank(audio, mesh)
                shard_raw_bank(raw, mesh)
                shard_recovery_bank(rec, mesh)
            if self._symbol_group > 1 and mesh is None:
                bucket.squeeze = SymbolSqueeze(SymbolSqueezeConfig(
                    n_rows=block_out, n_channels=self._n_slots,
                    group=self._symbol_group), device=dev)
            if mesh is None and 0 < self._compact_cols <= self._n_slots:
                cw = self._compact_cols
                bucket.comp_digital = ColumnCompactor(ColumnCompactorConfig(
                    n_rows=block_out, n_channels=self._n_slots, width=cw,
                    n_planes=3, out_bf16=self._drain_bf16), device=dev)
                bucket.comp_raw = ColumnCompactor(ColumnCompactorConfig(
                    n_rows=block_out, n_channels=self._n_slots, width=cw,
                    n_planes=2), device=dev)
                bucket.comp_audio = ColumnCompactor(ColumnCompactorConfig(
                    n_rows=block_out // self._audio_decim,
                    n_channels=self._n_slots, width=cw, n_planes=1,
                    out_bf16=self._drain_bf16), device=dev)
            self._buckets[d] = bucket

        # the spectrum shares the channelizer upload when a bucket's
        # window geometry matches the four-step factorization
        # (decimation == taps == B): per block the host uploads ONE
        # buffer for PSD + AudioBank + RawBank
        self._psd_bucket = None
        if mesh is None and self.params.mode != AnalyzerMode.WIDE_SPECTRUM:
            b_fac = self._spectrum.cfg.b
            for d in self._decimations:
                if d == b_fac and self._buckets[d].raw.cfg.taps == b_fac:
                    self._spectrum = PSDFromXW(
                        self._spectrum.cfg, m_rows=self.block_size // d,
                        sample_rate=rate,
                        window=self.params.window_function,
                        alpha=self.params.spectrum_avg_alpha,
                        in_scale=1.0 / counts_per_unit(self._in_i16,
                                                       self._in_i8),
                        device=dev)
                    self._psd_bucket = self._buckets[d]
                    break

        primary = self._buckets[self._decimation]
        self._audio_bank = primary.audio      # primary-bucket aliases
        self._raw_bank = primary.raw
        self._rec_bank = primary.rec
        self._kslots: dict[int, _KernelSlotExtra] = {}

    @property
    def channel_rate(self) -> float:
        return self._raw_bank.cfg.channel_rate

    @property
    def audio_rate(self) -> float:
        return self._audio_bank.cfg.audio_rate

    def _pick_bucket(self, bw: float) -> _Bucket:
        """The slowest bucket (largest decimation) whose channel rate
        still covers the requested bandwidth with a 1.25 guard,
        falling back to the fastest bucket."""
        for d in self._decimations:          # sorted descending
            b = self._buckets[d]
            if b.channel_rate >= bw * 1.25 and b.free:
                return b
        return self._buckets[self._decimations[-1]]

    def _refresh_compact(self, bucket: _Bucket) -> None:
        """Rebuild the bucket's slot->compact-column mapping (a rewrite
        of the compactors' maps).  When the active set outgrows the
        compact width the drain falls back to full planes."""
        self._plan_version += 1
        if bucket.comp_digital is None or self._defer_compact:
            return
        active = sorted(ks.idx for ks in self._kslots.values()
                        if ks.bucket is bucket)
        if len(active) > bucket.comp_digital.cfg.width:
            bucket.cmap = {}
            bucket.active = []
            return
        bucket.cmap = {idx: i for i, idx in enumerate(active)}
        bucket.active = active
        bucket.active_by = self._active_by(bucket)
        for comp in (bucket.comp_digital, bucket.comp_raw,
                     bucket.comp_audio):
            comp.set_mapping(active)
        ab = bucket.active_by
        for packer in bucket.packers.values():
            cfg = packer.cfg
            if (len(active) <= cfg.width
                    and len(ab["audio"]) <= cfg.audio_width
                    and len(ab["digital"]) <= cfg.digital_width
                    and len(ab["raw"]) <= cfg.raw_width):
                packer.set_mappings(active, audio=ab["audio"],
                                    digital=ab["digital"], raw=ab["raw"])
            # else: a stale variant, which _get_packer's width key no
            # longer selects
        for (sec, w, _rows), comp in bucket.sides.items():
            if len(ab[sec]) <= w:
                comp.set_mapping(ab[sec])

    def _active_by(self, bucket: _Bucket) -> dict[str, list[int]]:
        by: dict[str, list[int]] = {"audio": [], "digital": [],
                                    "raw": []}
        for slot in self._inspectors.values():
            ks = self._kslots[slot.handle]
            if ks.bucket is not bucket:
                continue
            if slot.class_name == "audio":
                by["audio"].append(ks.idx)
            elif slot.class_name in _DIGITAL:
                by["digital"].append(ks.idx)
            if self._needs_host_raw(slot, ks):
                by["raw"].append(ks.idx)
        return {k: sorted(v) for k, v in by.items()}

    def _needs_host_raw(self, slot, ks: _KernelSlotExtra) -> bool:
        """Whether this slot's raw [M] channel column must cross to the
        host.  Power inspectors whose integration window is a whole
        number of blocks are served by the device block-power row
        instead."""
        if slot.estimators or slot.spectrum_source:
            return True
        if slot.class_name == "raw":
            return True
        if slot.class_name == "power":
            n_int = max(1, int(ks.config["power.integrate-samples"]))
            return n_int % ks.bucket.raw.cfg.block_out != 0
        return False

    def bulk_config(self):
        """Context manager batching many open/close/configure calls:
        per-channel device constant uploads and compact-map refreshes
        are suspended and flushed ONCE on exit."""
        @contextmanager
        def _bulk():
            banks = [b for bk in self._buckets.values()
                     for b in (bk.raw, bk.audio, bk.rec)]
            with self._lock:
                for b in banks:
                    b.begin_defer()
                self._defer_compact = True
            try:
                yield
            finally:
                with self._lock:
                    for b in banks:
                        b.end_defer()
                    self._defer_compact = False
                    for bk in self._buckets.values():
                        self._refresh_compact(bk)
        return _bulk()

    def set_estimator(self, handle: int, estimator_id: str,
                      enabled: bool, request_id: int = 0) -> None:
        with self._lock:
            # the change and the demap's parameter version move together
            super().set_estimator(handle, estimator_id, enabled,
                                  request_id)
            self._plan_version += 1
        slot = self._inspectors.get(handle)
        if slot is None:
            return
        ks = self._kslots[handle]
        if enabled:
            # build the estimator's PSD now, not on the first drained
            # block (ADVICE.md, tasks/psdutil.py:58)
            prepare_est(estimator_id, ks.bucket.raw.cfg.block_out,
                        slot.equiv_rate, self.device)
        with self._lock:
            self._refresh_compact(ks.bucket)

    def set_spectrum_source(self, handle: int, source_id: int,
                            request_id: int = 0) -> None:
        with self._lock:
            super().set_spectrum_source(handle, source_id, request_id)
            self._plan_version += 1
        slot = self._inspectors.get(handle)
        if slot is not None:
            with self._lock:
                self._refresh_compact(self._kslots[handle].bucket)

    # ------------------------------------------------------------------
    # inspector lifecycle (the ack protocol of the base engine)
    # ------------------------------------------------------------------
    def open_inspector(self, class_name: str, channel: Channel,
                       request_id: int = 0,
                       config: dict[str, Any] | None = None) -> int:
        if class_name not in INSPECTOR_SCHEMAS:
            self._emit(InspectorMessage(
                inspector_kind=InspectorMessageKind.WRONG_KIND,
                request_id=request_id, class_name=class_name))
            raise ValueError(f"unknown inspector class {class_name!r}")
        with self._lock:
            bw = channel.bw or (channel.f_high - channel.f_low)
            bw = max(bw, self.sample_rate /
                     self.params.window_size * 8)
            if class_name == "audio":
                bw = min(bw, self.sample_rate / 2.0, 200e3)
            bucket = self._pick_bucket(bw)
            if not bucket.free:
                self._emit(InspectorMessage(
                    inspector_kind=InspectorMessageKind.WRONG_OBJECT,
                    request_id=request_id, class_name=class_name))
                raise RuntimeError(
                    f"all {self._n_slots} kernel slots of the "
                    f"1/{bucket.decimation} bucket in use")
            idx = bucket.free.pop()
            cfgobj = Config(INSPECTOR_SCHEMAS[class_name])
            if config:
                cfgobj.update(config)
            equiv_rate = bucket.channel_rate

            bucket.raw.configure_channel(
                idx, f0=channel.fc, bw=bw / 2.0, reset_state=True)
            handle = self._next_handle
            self._next_handle += 1
            slot = _InspectorSlot(
                handle=handle, inspector_id=handle,
                class_name=class_name, inspector=None, chan_handle=idx,
                equiv_rate=equiv_rate, bandwidth=bw, lo=channel.fc,
                estimators=set(),
            )
            ks = _KernelSlotExtra(idx, cfgobj)
            ks.bucket = bucket
            self._inspectors[handle] = slot
            self._by_id[handle] = handle
            self._kslots[handle] = ks
            self._apply_config(slot, ks, reset_state=True)
            self._refresh_compact(bucket)
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.OPEN,
            request_id=request_id, handle=handle, inspector_id=handle,
            class_name=class_name, config=cfgobj.copy(),
            equiv_rate=equiv_rate, bandwidth=bw, lo=channel.fc,
        ))
        return handle

    def _apply_config(self, slot: _InspectorSlot, ks: _KernelSlotExtra,
                      reset_state: bool = False) -> None:
        c = ks.config
        name = slot.class_name
        bucket = ks.bucket
        if name == "audio":
            cutoff = min(float(c["audio.cutoff"]),
                         0.9 * bucket.audio_rate)
            bucket.audio.configure_channel(
                ks.idx, f0=slot.lo, bw=slot.bandwidth / 2.0,
                mode=int(c["audio.demodulator"]), cutoff=cutoff,
                # manual agc.gain applies when AGC is off (reference
                # GainControl semantics), folded into the volume row
                volume=float(c["audio.volume"]) * (
                    1.0 if bool(c["agc.enabled"])
                    else float(c["agc.gain"])),
                squelch=bool(c["audio.squelch"]),
                squelch_level=float(c["audio.squelch-level"]),
                agc=bool(c["agc.enabled"]),
                # 0.0 restores the bank's default squelch-EMA constant
                agc_ts=(float(c["agc.ts"])
                        if bool(c["agc.enabled"]) else 0.0),
                reset_state=reset_state)
            target = float(c["audio.sample-rate"])
            ks.resampler = (_HostResampler(bucket.audio_rate, target)
                            if abs(target - bucket.audio_rate) > 1e-6
                            else None)
        elif name in _DIGITAL:
            kw: dict[str, Any] = {}
            if name == "psk":
                bps = max(1, int(c["afc.bits-per-symbol"]))
                order = int(c["afc.costas-order"])
                if order not in (2, 4, 8):
                    order = min(1 << bps, 8)
                loop_bw = float(c["afc.loop-bw"])
                ks.offset = float(c["afc.offset"])
                kw.update(eq_enabled=int(c["equalizer.type"]) == 1,
                          eq_rate=float(c["equalizer.rate"]),
                          eq_locked=bool(c["equalizer.locked"]))
            elif name == "ask":
                order = 2
                loop_bw = float(c["ask.loop-bw"])
                ks.offset = float(c["ask.offset"])
                kw.update(pll=bool(c["ask.use-pll"]))
            else:                                # fsk
                order = 2
                loop_bw = None    # derived from the baud rate below
                ks.offset = 0.0
                kw.update(quad_demod=bool(c["fsk.quad-demod"]),
                          fsk_phase=float(c["fsk.phase"]))
            baud = max(float(c["clock.baud"]), 1e-3)
            sps = max(2.0, bucket.channel_rate / baud)
            if self._symbol_group > 1 and sps < self._symbol_group + 1:
                raise ValueError(
                    f"symbol_group={self._symbol_group} requires "
                    f"sps >= {self._symbol_group + 1} on every digital "
                    f"inspector (got sps={sps:.2f}); the squeezed "
                    "drain would collide strobes")
            if loop_bw is None:
                # the fsk contract exposes no loop key; size the
                # coherent-path PLL at 5% of the symbol rate
                loop_bw = 0.05 / sps
            bucket.rec.configure_channel(
                ks.idx, kind=_DIGITAL[name], sps=sps, order=order,
                loop_bw=loop_bw,
                clock_gain=float(c["clock.gain"]),
                mf_rolloff=float(c["mf.roll-off"]),
                use_mf=int(c["mf.type"]) == 1,
                running=bool(c["clock.running"]),
                manual_clock=int(c["clock.type"]) == 0,
                clock_phase=float(c["clock.phase"]),
                reset_state=reset_state, **kw)
            # manual carrier offset shifts the channel mix (reference
            # AfcControl/AskControl offset semantics)
            bucket.raw.configure_channel(
                ks.idx, f0=slot.lo + ks.offset)

    def set_inspector_config(self, handle: int, config: dict[str, Any],
                             request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        honored = _HONORED_KEYS.get(slot.class_name, set())
        ignored = [k for k in config
                   if k not in honored and k in ks_schema_keys(slot)]
        if ignored:
            Logger.instance().warning(
                f"kernel path does not honor {sorted(ignored)} on "
                f"{slot.class_name!r} inspector {handle} (accepted, "
                "no effect)", domain="kernel_engine")
        with self._lock:
            ks = self._kslots[handle]
            ks.config.update(config)
            self._apply_config(slot, ks)
            self._plan_version += 1
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_CONFIG,
            request_id=request_id, handle=handle,
            inspector_id=slot.inspector_id, class_name=slot.class_name,
            config=ks.config.copy(),
        ))

    def set_inspector_freq(self, handle: int, freq: float,
                           request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            ks = self._kslots[handle]
            slot.lo = freq
            ks.bucket.raw.configure_channel(ks.idx,
                                            f0=freq + ks.offset)
            if slot.class_name == "audio":
                ks.bucket.audio.configure_channel(ks.idx, f0=freq)
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_FREQ,
            request_id=request_id, handle=handle, lo=freq,
        ))

    def _retune_channel(self, slot, f0: float) -> None:
        """Doppler-corrected LO move on the bank constants (the path of
        set_inspector_freq, without touching the user-visible
        slot.lo)."""
        ks = self._kslots[slot.handle]
        ks.bucket.raw.configure_channel(ks.idx, f0=f0 + ks.offset)
        if slot.class_name == "audio":
            ks.bucket.audio.configure_channel(ks.idx, f0=f0)

    def set_inspector_bandwidth(self, handle: int, bw: float,
                                request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        with self._lock:
            ks = self._kslots[handle]
            self._plan_version += 1
            slot.bandwidth = bw
            ks.bucket.raw.configure_channel(ks.idx, bw=bw / 2.0)
            if slot.class_name == "audio":
                ks.bucket.audio.configure_channel(ks.idx, bw=bw / 2.0)
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.SET_BANDWIDTH,
            request_id=request_id, handle=handle, bandwidth=bw,
        ))

    def close_inspector(self, handle: int, request_id: int = 0) -> None:
        slot = self._slot(handle, request_id)
        if slot is None:
            return
        import time as _time

        self._flush_watermark(slot, _time.time())
        with self._lock:
            ks = self._kslots.pop(handle)
            # mask the slot: silence the audio column, then recycle
            ks.bucket.audio.configure_channel(ks.idx, mode=0,
                                              volume=0.0)
            ks.bucket.free.append(ks.idx)
            self._by_id.pop(slot.inspector_id, None)
            del self._inspectors[handle]
            self._refresh_compact(ks.bucket)
        self._emit(InspectorMessage(
            inspector_kind=InspectorMessageKind.CLOSE,
            request_id=request_id, handle=handle,
            inspector_id=slot.inspector_id,
        ))

    # ------------------------------------------------------------------
    # block compute on the kernel banks
    # ------------------------------------------------------------------
    def _upload(self, bucket: _Bucket, x: np.ndarray) -> torch.Tensor:
        """Frame one block into the bucket's packed window buffer
        (int16/int8 when asked) and upload it once."""
        with profiling.span("an.frame"):
            xw = bucket.raw.frame_packed(x, i16=self._in_i16, i8=self._in_i8)
        return profiling.copy_to("an.upload", torch.from_numpy(xw),
                                 self.device)

    def _compute_block(self, x: np.ndarray) -> list:
        """Depth-``pipeline_depth`` block pipeline: dispatch block n,
        drain block n-(depth-1).  Messages lag (depth-1) blocks;
        ``_flush_pipeline`` drains the tail at EOS."""
        block = profiling.new_block()
        self.last_block = block
        with profiling.span("an.feed", block=block, cpu=True) as feed:
            by_bucket: dict[int, list] = {}
            for slot in self._inspectors.values():
                ks = self._kslots[slot.handle]
                by_bucket.setdefault(ks.bucket.decimation, []).append(slot)
            xw_shared = None
            if self._psd_bucket is not None:
                # ONE packed upload feeds the PSD and this bucket's banks;
                # the EMA folds on the device, fetched when a message is
                # due
                xw_shared = self._upload(self._psd_bucket, x)
                with profiling.span("an.psd"):
                    self._spectrum.feed_ema(xw_shared)
            with profiling.span("an.dispatch"):
                handles = [self._dispatch_bucket(
                    self._buckets[d], slots, x,
                    xw_shared if self._buckets[d] is self._psd_bucket
                    else None)
                    for d, slots in by_bucket.items()]
            for h in handles:
                h["block"] = block
            self._inflight.append(_Entry(handles, block))
            if len(self._inflight) < self._pipeline_depth:
                return []
            entry = self._inflight.pop(0)
            if self._drain_thread_on:
                depth = self._queue_drain(entry)
                if feed is not None:
                    feed.attrs["queue_depth"] = depth
                return []
            return self._drain_sync(entry)

    def _drain_sync(self, entry) -> list:
        """Drain ``entry`` on this thread and record it; the caller
        emits the payloads."""
        block = getattr(entry, "block", None)
        try:
            with profiling.span("an.drain", block=block):
                msgs = self._drain_entry(entry)
        except Exception as e:
            self._record(block, 0, e)
            raise
        self._record(block, len(msgs), None)
        return msgs

    def _record(self, block: int | None, emitted: int,
                error: BaseException | None) -> None:
        if block is None:
            return
        with self._records_cv:
            self._records[block] = (emitted, error)
            while len(self._records) > self.RECORDS:
                self._records.popitem(last=False)
            self._records_cv.notify_all()

    def wait_block(self, block: int, timeout: float | None = None) -> int:
        """Wait until block ``block`` (an id :attr:`last_block` gave) has
        drained and its payloads are emitted; returns how many SAMPLES
        payloads it emitted, one per inspector it fed, in the order they
        entered the queue after the previous block's.  Raises
        ``RuntimeError`` when the block's drain or emission failed, and
        ``TimeoutError`` when ``timeout`` seconds pass first.  Only the
        newest :attr:`RECORDS` blocks are kept: wait for a block soon."""
        with self._records_cv:
            if not self._records_cv.wait_for(
                    lambda: block in self._records, timeout):
                raise TimeoutError(f"block {block} not drained in "
                                   f"{timeout} s")
            emitted, error = self._records[block]
        if error is not None:
            raise RuntimeError(f"block {block}: its drain raised "
                               f"{error!r}") from error
        return emitted

    def _feed_spectrum(self, x: np.ndarray) -> None:
        if self._psd_bucket is None:
            super()._feed_spectrum(x)
        # else: _compute_block feeds the PSD from the shared upload

    def _drain_entry(self, handles) -> list:
        return [m for hs in handles for m in self._drain_bucket(hs)]

    def _flush_pipeline(self) -> list:
        out = []
        while self._inflight:
            out.extend(self._drain_sync(self._inflight.pop(0)))
        return out

    # ------------------------------------------------------------------
    # threaded drain: fetch + demap + emission on a worker, so the host
    # demap overlaps the next block's framing, upload and compute
    # ------------------------------------------------------------------
    def _queue_drain(self, entry) -> int:
        """Hand ``entry`` to the drain worker; returns the queue's depth
        after the put."""
        import queue as _q

        if self._drain_q is None:
            # maxsize well above the step() throttle point, so the
            # producer's put() never blocks while it holds the engine
            # lock (the worker takes that lock to demap and emit)
            self._drain_q = _q.Queue(
                maxsize=self._pipeline_depth + 6)
            self._drain_worker = threading.Thread(
                target=self._drain_loop, daemon=True,
                name="kernel-drain")
            self._drain_worker.start()
        self._drain_q.put(entry)
        return self._drain_q.qsize()

    def _drain_loop(self) -> None:
        import time as _time

        while True:
            entry = self._drain_q.get()
            if entry is None:
                self._drain_q.task_done()
                return
            block = getattr(entry, "block", None)
            msgs, error = [], None
            try:
                with profiling.span("an.drain", block=block):
                    msgs = self._drain_entry(entry)
                    with profiling.span("an.emit",
                                        messages=len(msgs)) as emit:
                        n = self._emit_block_msgs(msgs, _time.time())
                        if emit is not None:
                            emit.attrs["handoffs"] = n
            except Exception as e:  # noqa: BLE001 — worker must live
                error = e
                Logger.instance().error(
                    f"drain worker failed on block {block}: {e!r}",
                    domain="kernel_engine")
            finally:
                self._record(block, len(msgs), error)
                self._drain_q.task_done()

    def step(self) -> bool:
        import time as _time

        if self._drain_q is not None:
            # backpressure OUTSIDE the engine lock: never let the
            # drain queue grow past the pipeline depth + slack
            while self._drain_q.qsize() > self._pipeline_depth + 2:
                _time.sleep(0.002)
        ok = super().step()
        if not ok and self._inflight:
            # EOS with blocks still in flight: drain and emit the tail
            entries = list(self._inflight)
            self._inflight.clear()
            if self._drain_thread_on and self._drain_q is not None:
                for e in entries:
                    self._drain_q.put(e)
            else:
                now = _time.time()
                for e in entries:
                    self._emit_block_msgs(self._drain_sync(e), now)
        if not ok and self._drain_q is not None:
            self._drain_q.join()   # every queued drain emitted at EOS
        return ok

    def _dispatch_bucket(self, bucket: _Bucket, slots: list,
                         x: np.ndarray, xw=None) -> dict:
        """Frame + dispatch every bank this bucket's slots need; returns
        a handle of DEVICE tensors (plus the mapping snapshot) for
        :meth:`_drain_bucket`.  ``xw`` is an already-uploaded packed
        window buffer (the PSD share in _compute_block); when None the
        bucket frames and uploads its own — ONE upload feeds both
        banks."""
        any_audio = any(s.class_name == "audio" for s in slots)
        any_digital = any(s.class_name in _DIGITAL for s in slots)
        # the [M, C] raw planes only cross to the host when a slot
        # consumes them there (raw payloads, estimators, spectrum
        # sources, non-block-aligned power); the digital chain and
        # block-aligned power consume them ON DEVICE
        need_host_raw = any(
            self._needs_host_raw(s, self._kslots[s.handle])
            for s in slots if s.handle in self._kslots)
        any_power_fast = any(
            s.class_name == "power"
            and s.handle in self._kslots
            and not self._needs_host_raw(s, self._kslots[s.handle])
            for s in slots)
        need_raw_compute = need_host_raw or any_digital or any_power_fast

        # device-side column compaction: only active-slot columns cross
        # to the host; cmap empty = fall back to full planes
        comp = bool(bucket.cmap) and all(
            self._kslots[s.handle].idx in bucket.cmap for s in slots)

        h: dict = {"bucket": bucket, "slots": slots, "comp": comp,
                   "cmap": dict(bucket.cmap)}
        if self._tmesh:
            # ("time", "ch") mesh: the time-sharded wrappers frame the
            # block themselves (input halos for the audio chain); the
            # full planes drain
            if any_audio:
                h["audio"] = bucket.t_audio.feed(x, fetch=False)
                h["sq"] = bucket.audio._sq
                h["sq_level"] = bucket.audio._sq_level.copy()
                h["squelch"] = bucket.audio._squelch.copy()
            y_re = y_im = None
            if need_raw_compute:
                y_re, y_im = bucket.t_raw.feed(x, fetch=False)
                h["power"] = bucket.raw._power_dev
            if any_digital:
                h["dig"] = bucket.t_rec.feed_planes(y_re, y_im, fetch=False)
            if need_host_raw:
                h["raw"] = (y_re, y_im)
            return h
        # a meshed session feeds float32 frames, as the reference's
        frames = bucket.raw.frame(x) if self._mesh is not None else None
        if xw is None and frames is None:
            xw = self._upload(bucket, x)
        audio = None
        if any_audio:
            audio = (bucket.audio.feed_frames(*frames, fetch=False)
                     if frames is not None else
                     bucket.audio.feed_packed(xw, fetch=False))
            h["sq_level"] = bucket.audio._sq_level.copy()
            h["squelch"] = bucket.audio._squelch.copy()
        y_re = y_im = None
        if need_raw_compute:
            y_re, y_im = (bucket.raw.feed_frames(*frames, fetch=False)
                          if frames is not None else
                          bucket.raw.feed_packed(xw, fetch=False))
        dig = None
        if any_digital:
            dig = bucket.rec.feed_planes(y_re, y_im, fetch=False)

        if comp and self._drain_pack:
            # single-fetch drain: ONE launch packs audio, squelch, power,
            # digital and raw active columns as scaled int16; a section
            # too narrow for the packer's lane grouping drains through
            # its own int16 compactor (`sides`)
            if dig is not None and bucket.squeeze is not None:
                dig = bucket.squeeze.dispatch(*dig)
                h["squeezed"] = True
            packer, sides = self._get_packer(
                bucket, any_audio, any_digital, need_host_raw)
            h["packer"] = packer
            # per-section column maps, snapshotted with the dispatch
            # (a pipelined drain demaps with the maps the pack was
            # built from)
            h["pmaps"] = {
                sec: {idx: col for col, idx in enumerate(cols)}
                for sec, cols in bucket.active_by.items()}
            h["pack"] = packer.dispatch(
                audio=audio if packer.cfg.has_audio else None,
                sq=bucket.audio._sq if any_audio else None,
                pw=bucket.raw._power_dev if need_raw_compute else None,
                dig=dig if packer.cfg.has_digital else None,
                raw=((y_re, y_im)
                     if packer.cfg.has_raw and need_host_raw else None))
            # each side takes its own section's planes: the reference
            # builds every section's tuple first, and tuple(dig) raises
            # when an audio or raw side drains with no digital slot
            # (kernel_engine.py:1084)
            planes = {"audio": (audio,), "digital": dig,
                      "raw": (y_re, y_im)}
            h["sides"] = {sec: (side, side.dispatch(*planes[sec]))
                          for sec, side in sides.items()}
            return h

        if any_audio:
            h["audio"] = (bucket.comp_audio.dispatch(audio) if comp
                          else audio)
            h["sq"] = bucket.audio._sq        # this block's squelch rows
        if need_raw_compute:
            h["power"] = bucket.raw._power_dev
        if any_digital:
            h["dig"] = (bucket.comp_digital.dispatch(*dig)
                        if comp else dig)
        if need_host_raw:
            h["raw"] = (bucket.comp_raw.dispatch(y_re, y_im) if comp
                        else (y_re, y_im))
        return h

    def _get_packer(self, bucket: _Bucket, any_audio: bool,
                    any_digital: bool, need_raw: bool) -> tuple:
        """The bucket's packer for this block's sections at the widths
        the active slots need, and the side compactors of the sections
        that leave it (the reference's rules, kernel_engine.py:1148-1237).
        A variant seen first builds a Python object; the kernel is the
        same."""
        def w8(n: int) -> int:
            w = 8
            while w < n:
                w *= 2
            return w

        ab = bucket.active_by
        block_out = bucket.raw.cfg.block_out
        audio_rows = block_out // self._audio_decim
        dig_rows = (block_out // self._symbol_group
                    if bucket.squeeze is not None else block_out)
        w_a = w8(len(ab["audio"])) if any_audio else 0
        w_d = w8(len(ab["digital"])) if any_digital else 0
        w_r = w8(len(ab["raw"])) if need_raw else 0
        # the status tile carries every active slot; per-section widths
        # (powers of two × 8) divide it, so lane grouping lines up
        width = max(w8(len(bucket.active)), w_a, w_d, w_r)
        # a section narrower than half the buffer leaves the packer for
        # its own int16 compactor (the reference's rule, kept: it
        # defines the drain's layout)
        side_a = any_audio and width > 2 * w_a
        side_d = any_digital and width > 2 * w_d
        side_r = need_raw and width > 2 * w_r
        key = (any_audio and not side_a, any_digital and not side_d,
               need_raw and not side_r, width,
               w_a if not side_a else 0, w_d if not side_d else 0,
               w_r if not side_r else 0, dig_rows)
        packer = bucket.packers.get(key)
        if packer is None:
            # small packer tiles: the 6-row status tile pads to a whole
            # m_tile of int16 zeros
            groups = []
            if any_audio and not side_a:
                groups.append((audio_rows, width // w_a))
            if any_digital and not side_d:
                groups.append((dig_rows, width // w_d))
            if need_raw and not side_r:
                groups.append((block_out, width // w_r))
            m_tile = 0
            for mt in (64, 32, 16):
                if (audio_rows % mt or block_out % mt
                        or dig_rows % mt):
                    continue
                if all((rows // mt) % g == 0 for rows, g in groups):
                    m_tile = mt
                    break
            packer = DrainPacker(DrainPackerConfig(
                n_rows=block_out, audio_rows=audio_rows,
                n_channels=self._n_slots, width=width,
                has_audio=any_audio and not side_a,
                has_digital=any_digital and not side_d,
                has_raw=need_raw and not side_r,
                audio_width=w_a if not side_a else 0,
                digital_width=w_d if not side_d else 0,
                raw_width=w_r if not side_r else 0,
                digital_rows=dig_rows, m_tile=m_tile), device=self.device)
            packer.set_mappings(bucket.active, audio=ab["audio"],
                                digital=ab["digital"], raw=ab["raw"])
            bucket.packers[key] = packer
        sides = {}
        if side_a:
            sides["audio"] = self._get_side(
                bucket, "audio", w_a, audio_rows, (A_SCALE,))
        if side_d:
            sides["digital"] = self._get_side(
                bucket, "digital", w_d, dig_rows,
                (D_SCALE, D_SCALE, T_SCALE))
        if side_r:
            sides["raw"] = self._get_side(
                bucket, "raw", w_r, block_out, (R_SCALE, R_SCALE))
        return packer, sides

    def _get_side(self, bucket: _Bucket, section: str, width: int,
                  rows: int, scales: tuple) -> ColumnCompactor:
        key = (section, width, rows)
        comp = bucket.sides.get(key)
        if comp is None:
            comp = ColumnCompactor(ColumnCompactorConfig(
                n_rows=rows, n_channels=self._n_slots, width=width,
                n_planes=len(scales), out_i16=True, scales=scales),
                device=self.device)
            comp.set_mapping(bucket.active_by[section])
            bucket.sides[key] = comp
        return comp

    def _drain_bucket(self, h: dict) -> list:
        """Fetch a dispatched block (without the engine lock, so the
        transfer overlaps the next block's dispatch), then demap it into
        per-slot messages with the lock held: the demap reads and
        updates the slots' config and host state, which control calls
        on other threads change (ADVICE.md, kernel_engine.py:929)."""
        with profiling.span("an.fetch"):
            fetched = self._fetch(h)
        with self._lock, profiling.span("an.demap") as demap:
            msgs = self._demap(h, *fetched)
            if demap is not None:
                # how many slots the class passes took, and how many the
                # per-slot demap
                demap.attrs.update(batched=h.get("batched"),
                                   per_slot=h.get("per_slot"))
            return msgs

    def _fetch(self, h: dict) -> tuple:
        """The host side of one dispatched block: (audio, squelch_open,
        soft symbol planes (re, im), strobe plane, raw re, raw im, block
        power), None where the block has no such drain."""
        if "pack" in h:
            return self._fetch_pack(h)
        bucket: _Bucket = h["bucket"]
        comp = h["comp"]
        audio_out = soft = strobe = y_re = y_im = power = None
        squelch_open = None
        if "audio" in h:
            if comp:
                audio_out = bucket.comp_audio.fetch(h["audio"])[0]
            else:
                audio_out = _host(h["audio"])
            sq = _host(h["sq"])[0]
            squelch_open = (~h["squelch"]) | (sq >= h["sq_level"])
        if "dig" in h:
            # the planes as drained: each slot's column becomes complex
            # symbols and strobes in the demap, not the whole planes
            if comp:
                *soft, strobe = bucket.comp_digital.fetch(h["dig"])
            else:
                *soft, strobe = (_host(a) for a in h["dig"])
        if "raw" in h:
            if comp:
                y_re, y_im = bucket.comp_raw.fetch(h["raw"])
            else:
                y_re, y_im = (_host(a) for a in h["raw"])
        # the [1, C] power row crosses whenever the block has one: which
        # slots read it (raw AGC, block-aligned power) is their config's
        # at demap time, which a control call may change after the fetch
        if "power" in h:
            power = _host(h["power"])[0]
        return audio_out, squelch_open, soft, strobe, y_re, y_im, power

    def _fetch_pack(self, h: dict) -> tuple:
        """:meth:`_fetch` of a packed block: one copy of the pack and one
        per side compactor; the status rows back at full slot width."""
        sec = h["packer"].fetch(h["pack"])
        audio_out = sec.get("audio")
        soft = strobe = None
        if "soft" in sec:
            soft = (sec["soft"].real, sec["soft"].imag)
            strobe = sec["strobe"]
        y_re, y_im = sec.get("y_re"), sec.get("y_im")
        for name, (side, out) in h["sides"].items():
            planes = side.fetch(out)
            if name == "audio":
                audio_out = planes[0]
            elif name == "digital":
                soft, strobe = planes[:2], planes[2]
            else:
                y_re, y_im = planes
        # the status tile holds every active slot in compact order
        n = self._n_slots
        idx = np.fromiter(h["cmap"].keys(), np.int64, len(h["cmap"]))
        col = np.fromiter(h["cmap"].values(), np.int64, len(h["cmap"]))
        power = np.zeros(n, np.float32)
        power[idx] = sec["power"][col]
        squelch_open = None
        if audio_out is not None:
            sq = np.zeros(n, np.float32)
            sq[idx] = sec["sq"][col]
            squelch_open = (~h["squelch"]) | (sq >= h["sq_level"])
        return audio_out, squelch_open, soft, strobe, y_re, y_im, power

    def _demap(self, h: dict, audio_out, squelch_open, soft, strobe,
               y_re, y_im, power) -> list:
        """Per-slot messages of one fetched block, in the order of the
        block's slots: one numpy pass per inspector class of the block's
        plan (:meth:`_demap_plan`), then its per-lane step
        (``analyzer/demap.py``).  Sets ``h["batched"]`` and
        ``h["per_slot"]``, the slots each took.  The caller holds the
        engine lock."""
        plan = self._demap_plan(h, y_re is not None,
                                0 if soft is None else len(soft[0]))
        out: list = [None] * len(h["slots"])
        plan.run(out, audio_out, squelch_open, soft, strobe, y_re, y_im,
                 power)
        h["batched"], h["per_slot"] = plan.batched, len(plan.per_slot)
        return [m for m in out if m is not None]

    def _demap_plan(self, h: dict, has_raw: bool, rows: int) -> DemapPlan:
        """The bucket's demap plan for block ``h``: the cached one while
        the block's slots, section maps, drain flags and the parameter
        version are those it was built for, else a new one, built from
        the slots' configuration now."""
        bucket: _Bucket = h["bucket"]
        pmaps = h.get("pmaps")
        slots = h["slots"]
        squeezed = bool(h.get("squeezed"))
        key = (self._plan_version, h["comp"], squeezed, has_raw, rows)
        maps = (pmaps if pmaps is not None
                else h["cmap"] if h["comp"] else None)
        plan = bucket.plan
        if (plan is not None and plan.key == key and plan.maps == maps
                and len(plan.slots) == len(slots)
                and all(map(operator.is_, plan.slots, slots))):
            return plan
        audio, digital, power, per_slot = [], [], [], []
        for pos, slot in enumerate(slots):
            # a control thread may close a slot while its last block is
            # in flight (pipeline_depth > 1): closed slots simply stop
            # producing messages (reference close semantics)
            ks = self._kslots.get(slot.handle)
            if ks is None:
                continue
            name = slot.class_name
            if pmaps is None:
                a_col = d_col = r_col = (h["cmap"][ks.idx] if h["comp"]
                                         else ks.idx)
            else:
                # the packed drain compacts each section at its own
                # width: a slot missing from its class's map (membership
                # changed while the block was in flight) skips this block
                a_col = pmaps["audio"].get(ks.idx)
                d_col = pmaps["digital"].get(ks.idx)
                r_col = pmaps["raw"].get(ks.idx)
                if ((name == "audio" and a_col is None)
                        or (name in _DIGITAL and d_col is None)
                        or (name == "raw" and r_col is None)
                        or (name == "power" and r_col is None
                            and self._needs_host_raw(slot, ks))):
                    continue
            # the raw class and power off the block grid take the
            # per-lane step alone
            if name == "raw" or (name == "power" and has_raw
                                 and r_col is not None):
                per_slot.append((pos, slot, ks, r_col))
                continue
            if name == "power":           # reads the status row alone
                power.append((pos, slot, ks, ks.idx))
                continue
            (audio if name == "audio" else digital).append(
                (pos, slot, ks, a_col if name == "audio" else d_col))
            # after its class pass: the raw column, the resampler
            est = bool(slot.estimators or slot.spectrum_source)
            if est or ks.resampler is not None:
                per_slot.append((pos, slot, ks, r_col if est else None))
        plan = DemapPlan(key, maps, slots, audio, digital, power, per_slot,
                         bucket.raw.cfg.block_out, rows, squeezed)
        bucket.plan = plan
        return plan
