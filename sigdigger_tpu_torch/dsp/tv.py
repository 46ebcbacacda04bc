"""Analog TV line processor — the `su_tv_processor_t` equivalent
(counterpart of ``sigdigger_tpu/dsp/tv.py``).

Decodes analog video by locking to horizontal sync pulses and stacking
lines into frames (reference Default/GenericInspector/
TVProcessorWorker.h:36-76).  The structure work stays on the host in
numpy, vectorized as in the reference: sync runs as run-length segments
of the thresholded luminance, hsync/vsync by width, the line period by a
flywheel on the median hsync spacing (tolerant of dropped pulses), line
starts between hsyncs interpolated at the flywheel period, and field
restarts at vsync.  The per-line resample to ``pixels_per_line`` runs
on the device (``kernels/tvline.py``) with ``backend="device"``, or as
the reference's truncating host gather with ``backend="host"``.

Works on blocks; state (period, phase, partial frame, AGC followers)
carries across calls, so streaming equals one-shot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sigdigger_tpu_torch.backend import resolve_device


@dataclass
class TVProcessorParams:
    sample_rate: float
    line_rate: float = 15625.0        # PAL: 625 lines × 25 fps
    lines_per_frame: int = 312        # one field
    pixels_per_line: int = 384
    sync_level: float = 0.15          # normalized threshold
    sync_min_fraction: float = 0.03   # hsync width ≳ 3% of a line
    vsync_fraction: float = 0.3       # sync longer than this → vsync
    loop_gain: float = 0.1
    invert: bool = False              # True when sync is at max level

    @property
    def samples_per_line(self) -> float:
        return self.sample_rate / self.line_rate


class TVProcessor:
    """``backend="auto"`` resamples lines on the device kernel
    (``kernels/tvline.py``) when ``device`` is CUDA and on the host
    otherwise; "host"/"device" force.  As in the reference, the device
    path needs ``pixels_per_line % 128 == 0``, else the host gather runs
    (the two differ in their numbers: the device path interpolates, the
    host gather truncates), so both packages give the same frames for
    the same parameters.  ``backend`` reports the path that runs.
    Runs on ``cuda`` unless ``device`` says otherwise.

    ``feeds`` counts the blocks fed, ``line_feeds`` those that produced
    lines (one device resample each), and ``locked_at`` is the index of
    the first of those, or None."""

    STATE = ("_period", "_next", "_row", "_frame", "_carry", "_agc_lo",
             "_agc_hi")

    def __init__(self, params: TVProcessorParams, backend: str = "auto",
                 device=None) -> None:
        self.p = params
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "device" if self.device.type == "cuda" else "host"
        if backend == "device" and params.pixels_per_line % 128:
            backend = "host"
        self.backend = backend
        self._resampler = None
        self._period = params.samples_per_line
        self._next: float | None = None   # expected next line start
        self._row = 0
        self._frame = np.zeros(
            (params.lines_per_frame, params.pixels_per_line), np.float32)
        self._carry = np.zeros(0, np.float32)
        self.frames: list[np.ndarray] = []
        self._agc_lo = 0.0
        self._agc_hi = 1.0
        self.feeds = 0
        self.line_feeds = 0
        self.locked_at: int | None = None

    def _line_resampler(self):
        from sigdigger_tpu_torch.kernels.tvline import (
            LineResampler,
            LineResamplerConfig,
        )

        if self._resampler is None:
            p = self.p
            # widest window any in-range period needs (+2 interp taps)
            w_need = int(np.ceil(
                p.pixels_per_line
                * (1.1 * p.samples_per_line * 0.85
                   / p.pixels_per_line))) + 3
            width = -(-w_need // 128) * 128
            self._resampler = LineResampler(LineResamplerConfig(
                width=width, pixels=p.pixels_per_line), device=self.device)
        return self._resampler

    def _device_lines(self, v: np.ndarray, line_starts: np.ndarray,
                      offs0: float, step: float) -> np.ndarray:
        """Resample every line on the device (true linear interpolation
        — the host gather truncates): the resampler reads each line's
        window from ``v`` at the integer start, clipped to the block as
        the reference's host framing clips it."""
        rs = self._line_resampler()
        rs.set_step(step)
        pos = line_starts + offs0
        ints = np.floor(pos).astype(np.int64)
        frac = (pos - ints).astype(np.float32)
        return rs.resample_lines(v, ints, frac)

    # -- state --------------------------------------------------------

    def state_dict(self) -> dict:
        """The host state (period, phase, partial frame, carry, AGC
        followers) and the resampler's step, copied."""
        st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in ((k, getattr(self, k)) for k in self.STATE)}
        st["_step"] = (self._resampler._step if self._resampler is not None
                       else None)
        return st

    def load_state(self, state: dict) -> None:
        """Continue from ``state_dict()`` or from the same attributes of
        a reference processor (its resampler's ``_step`` as ``_step``)."""
        for k in self.STATE:
            v = state[k]
            setattr(self, k, np.array(v, np.float32) if k in
                    ("_frame", "_carry") else v)
        step = state.get("_step")
        if step is not None and self.backend == "device":
            self._line_resampler().set_step(step)

    # -- helpers ------------------------------------------------------

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        lo = np.percentile(x, 1)
        hi = np.percentile(x, 99)
        self._agc_lo += 0.2 * (lo - self._agc_lo)
        self._agc_hi += 0.2 * (hi - self._agc_hi)
        span = max(self._agc_hi - self._agc_lo, 1e-9)
        v = (x - self._agc_lo) / span
        return 1.0 - v if self.p.invert else v

    @staticmethod
    def _sync_runs(sync: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of True runs, vectorized RLE."""
        d = np.diff(sync.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if sync[0]:
            starts = np.concatenate([[0], starts])
        if sync[-1]:
            ends = np.concatenate([ends, [len(sync)]])
        return starts, ends

    def _line_starts(self, hstarts: np.ndarray,
                     limit: float) -> np.ndarray:
        """Merge measured hsync anchors with flywheel-interpolated fills
        for dropped pulses; all positions < ``limit``."""
        per = self._period
        pieces: list[np.ndarray] = []
        prev = self._next
        if len(hstarts):
            if prev is not None and hstarts[0] - prev > 0.5 * per:
                k = int(round((hstarts[0] - prev) / per))
                if 0 < k <= 4096:    # bridge a bounded gap only
                    pieces.append(prev + np.arange(k) *
                                  (hstarts[0] - prev) / k)
            for a, b in zip(hstarts[:-1], hstarts[1:]):
                k = max(1, int(round((b - a) / per)))
                pieces.append(a + np.arange(k) * (b - a) / k)
            pieces.append(np.array([hstarts[-1]], np.float64))
            tail_from = hstarts[-1]
        elif prev is not None:
            tail_from = prev - per
            pieces.append(np.array([], np.float64))
        else:
            return np.zeros(0, np.float64)
        # free-run past the last anchor up to the limit
        n_tail = int((limit - tail_from) / per) - 1
        if n_tail > 0:
            pieces.append(tail_from + per * (1 + np.arange(n_tail)))
        out = np.concatenate(pieces) if pieces else np.zeros(0)
        return out[out < limit]

    # -- main entry ----------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[np.ndarray]:
        """Feed demodulated luminance; returns any completed frames."""
        p = self.p
        self.feeds += 1
        x = np.concatenate([self._carry,
                            np.asarray(samples, np.float32)])
        v = self._normalize(x)
        per_nom = p.samples_per_line
        done: list[np.ndarray] = []

        sync = v < p.sync_level
        starts, ends = self._sync_runs(sync)
        # a run touching the block end is incomplete — defer it
        if len(starts) and len(ends) and ends[-1] == len(v) and sync[-1]:
            starts, ends = starts[:-1], ends[:-1]
        lengths = ends - starts
        hmin = p.sync_min_fraction * per_nom
        vmin = p.vsync_fraction * per_nom
        is_v = lengths >= vmin
        is_h = (lengths >= hmin) & ~is_v
        hstarts = starts[is_h].astype(np.float64)
        vstarts = starts[is_v].astype(np.float64)
        vends = ends[is_v].astype(np.float64)

        # flywheel period from median hsync spacing
        if len(hstarts) >= 2:
            diffs = np.diff(hstarts)
            ok = (diffs > 0.85 * per_nom) & (diffs < 1.15 * per_nom)
            if ok.any():
                self._period += p.loop_gain * (
                    float(np.median(diffs[ok])) - self._period)
                self._period = float(np.clip(
                    self._period, 0.9 * per_nom, 1.1 * per_nom))

        per = self._period
        limit = len(v) - 1.5 * per   # lines must fit fully in the block
        line_starts = self._line_starts(hstarts, limit)

        if len(line_starts) == 0:
            # unlocked / starving: keep a short tail, drop the rest
            keep_from = max(0, len(x) - int(3 * per))
            self._carry = x[keep_from:]
            if self._next is not None:
                self._next -= keep_from
                if self._next < -per:
                    self._next = None
            return done

        if self.locked_at is None:
            self.locked_at = self.feeds - 1
        self.line_feeds += 1
        # resample every line of the block at once
        offs0 = p.sync_min_fraction * per_nom * 2
        step = per * 0.85 / p.pixels_per_line
        if self.backend == "device":
            lines = self._device_lines(v, line_starts, offs0, step)
        else:
            # ONE truncating gather for every line (host path)
            offs = offs0 + np.arange(p.pixels_per_line) * step
            idx = (line_starts[:, None] + offs[None, :]).astype(np.int64)
            np.clip(idx, 0, len(v) - 1, out=idx)
            lines = v[idx].astype(np.float32)       # (L, pixels)

        # segment rows at vsync positions (field restarts)
        seg_id = np.searchsorted(vstarts, line_starts)
        lpf = p.lines_per_frame
        first_seg = True
        for seg in np.unique(seg_id):
            if not first_seg or seg > 0:
                # vsync boundary before this segment: field restart
                if self._row > lpf // 2:
                    done.append(self._frame.copy())
                self._row = 0
            first_seg = False
            block = lines[seg_id == seg]
            written = 0
            while written < len(block):
                room = lpf - self._row
                take = min(room, len(block) - written)
                self._frame[self._row:self._row + take] = \
                    block[written:written + take]
                self._row += take
                written += take
                if self._row >= lpf:
                    done.append(self._frame.copy())
                    self._row = 0

        # carry: keep a search window before the next expected line
        last = float(line_starts[-1])
        nxt = last + per
        if len(vends) and vends[-1] > last:
            nxt = max(nxt, float(vends[-1]))
        keep_from = max(0, int(nxt - 0.3 * per))
        self._carry = x[keep_from:]
        self._next = nxt - keep_from
        self.frames.extend(done)
        return done
