"""Driver of the cells whose configuration's ``entry`` is ``session``:
the program's ``KernelAnalyzer`` with the configuration's inspector mix,
fed one block a step through its own ``step()`` and drained through its
drain worker, as a deployment runs it.

A block goes in through a source that hands over the block the harness
gave; ``feed`` returns the block's id and the carries it entered with.
``drain`` waits on the session's record of that block, takes its SAMPLES
messages off the session's queue, and returns them with the carries the
block entered and left with: the banks' device carries copied on the
device in stream order (no synchronize), the rotator phases, and the
demap's host followers as the demap of the block found and left them.
A block the session still holds in its own pipeline is flushed through
the session's end-of-stream path first.  A block whose drain failed
raises, so the harness counts it as failed.

What it takes from the program: the session (the system under test),
the names of the methods the spans stand in for, the kernel wrappers'
launch counters, and the carries.  The roofline counts come from the
benchmark's own :mod:`sdbench.roofline_session`.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from sdbench import roofline_session, session_mix

# the audio bank's carries, in its order, with their rows
_AUDIO_CARRIES = ("prev_re", "prev_im", "ftail1", "ftail2", "atail1",
                  "atail2", "sq", "dc", "agcs")


def _handover(sample_rate: float):
    """A source that hands over one block the caller gave, and is at its
    end while it holds none."""
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.base import SignalSource

    class Handover(SignalSource):
        def __init__(self) -> None:
            super().__init__(SourceProfile(type="synth",
                                           sample_rate=int(sample_rate)))
            self.block = None

        @property
        def eos(self) -> bool:
            return self.block is None

        def _read_impl(self, n: int) -> np.ndarray:
            x, self.block = self.block, None
            if x is None or len(x) != n:
                raise ValueError(f"a block of {n} samples was due")
            return x

    return Handover()


class Program:
    def __init__(self, cfg: dict, wl: dict, device: str) -> None:
        from sigdigger_tpu_torch import KernelAnalyzer
        from sigdigger_tpu_torch.analyzer.messages import (
            InspectorMessage,
            SamplesMessage,
        )
        from sigdigger_tpu_torch.types import AnalyzerParams, Channel

        if not hasattr(KernelAnalyzer, "wait_block"):
            raise RuntimeError("this program's session keeps no per-block "
                               "drain record: it cannot run this cell")
        self._samples_kind = SamplesMessage
        self.block_in = cfg["block_out"] * cfg["decimation"]
        self.depth = int(cfg["pipeline_depth"])
        self.src = _handover(cfg["sample_rate"])
        params = AnalyzerParams()
        params.window_size = cfg["window_size"]
        self.an = an = KernelAnalyzer(
            source=self.src, params=params, block_size=self.block_in,
            n_slots=cfg["n_slots"], decimation=cfg["decimation"],
            audio_decim=cfg["audio_decim"],
            compact_cols=cfg["compact_cols"],
            pipeline_depth=self.depth, symbol_group=cfg["symbol_group"],
            drain_thread=cfg["drain_thread"], in_i16=cfg["in_i16"],
            drain_bf16=cfg["drain_bf16"], device=device)
        an.poll()
        mix = session_mix.expand(cfg)
        with an.bulk_config():
            self.handles = [
                an.open_inspector(ins["class"], Channel(fc=ins["fc"],
                                                        bw=ins["bw"]),
                                  request_id=i + 1, config=ins["config"])
                for i, ins in enumerate(mix)]
        opens = [m for m in an.poll() if isinstance(m, InspectorMessage)
                 and m.inspector_kind.value == "open"]
        if [m.request_id for m in opens] != list(range(1, len(mix) + 1)):
            raise RuntimeError(f"{len(opens)} of {len(mix)} inspectors "
                               "acknowledged their opening")
        (self.bucket,) = {an._kslots[h].bucket for h in self.handles}
        self.index = {h: i for i, h in enumerate(self.handles)}
        lanes = session_mix.lanes(cfg)
        self._digital = [self.handles[i] for i in lanes["digital"]]
        self._check_assumed(cfg)
        self.bounds_ms = roofline_session.bounds_ms(cfg)

        # the demap's host followers, as each block's demap found them
        # and left them
        self._demaps: dict = {}
        demap = an._demap

        def demap_and_keep(h, *fetched):
            before = self._followers()
            out = demap(h, *fetched)
            self._demaps[h.get("block")] = (before, self._followers())
            return out

        an._demap = demap_and_keep
        self._entries: dict = {}      # block id -> carries it entered with
        self._fed: deque = deque()    # ids fed since the last flush
        self._queued: deque = deque() # SAMPLES messages not yet claimed

    def _check_assumed(self, cfg: dict) -> None:
        """The session's defaults that the reference assumes
        (configuration's ``assumed``): a session that departs from them
        is not this cell."""
        from sigdigger_tpu_torch.config import INSPECTOR_SCHEMAS
        from sigdigger_tpu_torch.kernels import drainpack

        a, b = cfg["assumed"], self.bucket
        want = dict(a)
        # the tile is the largest divisor of the block up to m_tile
        want["m_tile"] = max(d for d in range(1, a["m_tile"] + 1)
                             if cfg["block_out"] % d == 0)
        fb = max(d for d in range(1, a["psd_frames_per_program"] + 1)
                 if self.an._spectrum.cfg.frames_per_block % d == 0)
        want["psd_frames_per_program"] = fb
        have = {
            "taps": b.raw.cfg.taps, "audio_taps": b.audio.cfg.audio_taps,
            "audio_fir_taps": b.audio.cfg.audio_fir_taps,
            "m_tile": b.raw.cfg.m_tile if b.raw.cfg.m_tile
            == b.audio.cfg.m_tile else None,
            "psd_frames_per_program":
                self.an._spectrum.cfg.frames_per_program,
            "i16_scale": b.raw.cfg.in_scale,
            "audio_dc_alpha": b.audio.cfg.dc_alpha,
            "squelch_alpha": b.audio.cfg.sq_alpha,
            "hang_agc": b.audio.cfg.hang_agc,
            "mf_taps": b.rec.cfg.mf_taps_max, "eq_taps": b.rec.cfg.eq_taps,
            "rec_dc_alpha": b.rec.cfg.dc_alpha,
            # the rate of a lane no equalizer key configures
            "rec_eq_rate": float(b.rec._eq_rate[-1]),
            "psd_alpha": self.an.params.spectrum_avg_alpha,
            "psd_window": self.an.params.window_function.name,
            "drain_scales": [drainpack.A_SCALE, drainpack.D_SCALE,
                             drainpack.T_SCALE, drainpack.S_SCALE],
        }
        bad = {k: (v, want[k]) for k, v in have.items() if v != want[k]}
        for cls, keys in a["inspector_defaults"].items():
            schema = {f.name: f.default for f in INSPECTOR_SCHEMAS[cls]}
            bad.update({f"{cls}.{k}": (schema.get(k), v)
                        for k, v in keys.items() if schema.get(k) != v})
        if not (self.an._in_i16 and self.an._psd_bucket is b
                and b.squeeze is not None):
            bad["path"] = "no int16 upload, shared-upload PSD or squeeze"
        if bad:
            raise RuntimeError(f"the session departs from what the "
                               f"configuration assumes: {bad}")

    # -- the carries ------------------------------------------------------
    def _followers(self) -> dict:
        """The demap's host followers of the digital inspectors, by lane."""
        ks = [self.an._kslots[h] for h in self._digital]
        return {"agc_ema": {j: k.agc_ema for j, k in enumerate(ks)},
                "dec_span": {j: k.dec_span for j, k in enumerate(ks)},
                "dec_vmax": {j: k.dec_vmax for j, k in enumerate(ks)}}

    def _carries(self) -> dict:
        """The banks' carries now, copied in stream order."""
        b = self.bucket
        au = b.audio
        planes = [torch.as_tensor(getattr(au, "_" + n))
                  for n in _AUDIO_CARRIES]
        psd = self.an._spectrum
        acc = getattr(psd, "_psd_dev", None)
        return {
            "n_slots": au.cfg.n_channels,
            "aud": torch.cat([p.reshape(-1) for p in planes]),
            "aud_layout": [(n, p.shape[0]) for n, p in
                           zip(_AUDIO_CARRIES, planes)],
            "aud_phi": au._phi.copy(), "raw_phi": b.raw._phi.copy(),
            "rec": torch.as_tensor(b.rec.state).clone(),
            "psd": (None if acc is None else acc.clone(), psd._count),
        }

    # -- the timed path -------------------------------------------------
    def feed(self, x: np.ndarray):
        carries = self._carries()
        self.src.block = x
        if not self.an.step():
            raise RuntimeError("the session took no block")
        block = self.an.last_block
        self._entries[block] = carries
        self._fed.append(block)
        return block

    def drain(self, block) -> dict:
        # the session holds the last depth-1 blocks fed since its last
        # flush; its end-of-stream path drains what it holds
        if self.depth > 1 and block in list(self._fed)[1 - self.depth:]:
            self.an.step()
            self._fed.clear()
        while self._fed and self._fed[0] <= block:
            self._fed.popleft()
        entry = self._entries.pop(block)
        count = self.an.wait_block(block, timeout=600.0)
        self._queued.extend(m for m in self.an.poll()
                            if isinstance(m, self._samples_kind))
        if len(self._queued) < count:
            raise RuntimeError(f"block {block}: {count} SAMPLES messages "
                               f"recorded, {len(self._queued)} queued")
        msgs = [self._queued.popleft() for _ in range(count)]
        later = [b for b in self._entries if b > block]
        exit_ = self._entries[min(later)] if later else self._carries()
        return {"msgs": msgs, "index": self.index, "entry": entry,
                "exit": exit_, "demap": self._demaps.pop(block)}

    # -- what the harness reads around it -------------------------------
    def span_targets(self) -> list[tuple]:
        """(object, method, span name): framing, each kernel's host call,
        the drain's fetch and the demap."""
        from sigdigger_tpu_torch.kernels.compact import ColumnCompactor
        from sigdigger_tpu_torch.kernels.drainpack import DrainPacker

        b = self.bucket
        return [(b.raw, "frame_packed", "frame"),
                (self.an._spectrum, "feed_ema", "psd"),
                (b.raw, "_call", "raw"), (b.audio, "_call", "audio"),
                (b.rec, "_call", "recovery"),
                (b.squeeze, "dispatch", "squeeze"),
                # the packer and its side compactors are built at the
                # first block: the class's method stands in for each
                (DrainPacker, "dispatch", "pack"),
                (ColumnCompactor, "dispatch", "compact"),
                (self.an, "_fetch", "fetch"),
                (self.an, "_demap", "demap")]

    block_span = "raw"

    def launches(self) -> dict[str, int]:
        from sigdigger_tpu_torch.kernels import (
            audio,
            compact,
            drainpack,
            fft,
            rawbank,
            recovery,
            symsqueeze,
        )

        return {"raw": rawbank.raw_kernel.launches,
                "audio": audio.audio_kernel.launches,
                "recovery": recovery.recovery_kernel.launches,
                "squeeze": symsqueeze.squeeze_kernel.launches,
                "pack": drainpack.pack_kernel.launches,
                "compact": compact.compact_kernel.launches,
                "psd": fft.psd_xw_ema_kernel.launches}

    def close(self) -> None:
        q = self.an._drain_q
        if q is not None:
            q.put(None)
            self.an._drain_worker.join(timeout=60.0)
        del self.an
