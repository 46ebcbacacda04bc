"""The analyzer session's host demap: one numpy pass per inspector class
over a drained block (``KernelAnalyzer._demap``), then one per-lane step.

A :class:`DemapPlan` is one bucket layout's demap: for each class pass
its lanes (their positions in the block's slot list, their slots and
host state, their columns in the fetched section and their status
rows), and the per-lane scalars their configuration gives.  The engine
builds a plan when the block's layout or a demap parameter changes and
reuses it for every other block.  Every audio, psk, fsk, ask and
block-aligned power lane takes its class pass; each decision and each
AGC rule is written once, here.  The per-lane step then does only what
is truly per lane: it attaches the raw column (the message's fourth
element) to lanes with estimators or spectrum sources, runs an audio
lane's host resampler on its column, demaps the raw class with its
``agc.ts`` follower in channel samples, and integrates power over raw
samples off the block grid.  The ``an.demap`` span's ``batched`` counts
the lanes of the class passes and ``per_slot`` those that took the
per-lane step; a lane with an estimator counts in both.

The passes work on views of the fetched [rows, columns] sections: a
class whose lanes sit in consecutive columns is a slice (no copy), any
other one column gather.  A lane's samples are a view of its pass's
result: its column, or its row where the fsk and ask decisions take
each lane's strobed rows from a lane-major copy.

The passes compute what a demap of one lane at a time computes, element
by element and in the same precision.  Each per-lane scalar enters the
float32 arithmetic as the float32 that the scalar form's Python float
is cast to (numpy's weak scalars): a difference of two such scalars is
taken in float64 first, then cast.  The AGC's coefficient ``1 - exp(-n / tau)``
is the scalar form's, computed once per lane when the plan is built,
and a lane's mean power is taken over its own contiguous row, as the
scalar form's was.  The followers (``agc_ema``, ``dec_span``,
``dec_vmax``, ``pw_acc``, ``pw_cnt``) are read from each lane's host
state and written back every block, so the state stays where the rest
of the session reads it.
"""

from __future__ import annotations

import numpy as np

# digital lanes in pass order: psk (grouped by bits per symbol), fsk,
# ask; the session's mixes open them in this order, so a plan's digital
# section is one slice
_ORDER = {"psk": 0, "fsk": 1, "ask": 2}
_BPS_KEY = {"psk": "afc.bits-per-symbol", "fsk": "fsk.bits-per-symbol",
            "ask": "ask.bits-per-symbol"}


def decide_phase(syms: np.ndarray, bits: int) -> np.ndarray:
    levels = 1 << bits
    sector = np.round(np.angle(syms) * levels / (2.0 * np.pi))
    # a whole number in [-levels/2, levels/2]: its remainder modulo the
    # power of two is its two's complement masked (float32 np.mod takes
    # a slow scalar loop, the most of this decision's time)
    return (sector.astype(np.int32) & (levels - 1)).astype(np.uint8)


class _Lanes:
    """One class pass's lanes, in pass order: (position in the block's
    slot list, slot, host state, column in the fetched section).
    ``sel`` selects their columns: a slice where they are consecutive."""

    def __init__(self, lanes: list) -> None:
        self.pos = [p for p, _, _, _ in lanes]
        self.slots = [s for _, s, _, _ in lanes]
        self.kss = [k for _, _, k, _ in lanes]
        self.idx = np.array([k.idx for k in self.kss], np.int64)
        cols = np.array([c for _, _, _, c in lanes], np.int64)
        n = len(cols)
        self.sel = (slice(int(cols[0]), int(cols[0]) + n)
                    if n and np.array_equal(cols, np.arange(cols[0],
                                                            cols[0] + n))
                    else cols)

    def __len__(self) -> int:
        return len(self.pos)


def _follower(kss: list, attr: str) -> tuple[np.ndarray, np.ndarray]:
    """A float64 follower of each lane and where it is still None."""
    vals = [getattr(k, attr) for k in kss]
    none = np.array([v is None for v in vals], bool)
    return np.array([np.nan if v is None else v for v in vals],
                    np.float64), none


class DemapPlan:
    """The class passes of one block layout.

    ``key`` and ``maps`` are what the engine matched the block against
    (its parameter version and drain flags; the section maps), ``slots``
    the block's slot list.  ``audio``, ``digital`` and ``power`` are the
    class passes' lanes, ``per_slot`` those of the per-lane step as
    (position, slot, host state, raw column or None).
    ``block_out`` is the bucket's channel samples a block, ``rows`` the
    drained digital rows, ``squeezed`` whether the symbol squeeze ran."""

    def __init__(self, key: tuple, maps, slots: list, audio: list,
                 digital: list, power: list, per_slot: list,
                 block_out: int, rows: int, squeezed: bool) -> None:
        self.key, self.maps, self.slots = key, maps, slots
        self.per_slot = per_slot
        self.audio = _Lanes(audio)
        self.power = _Lanes(power)
        self.block_out, self.rows, self.squeezed = block_out, rows, squeezed
        self.n_int = np.array(
            [max(1, int(k.config["power.integrate-samples"]))
             for k in self.power.kss], np.int64)
        self._digital_lanes(digital)
        self.batched = len(self.audio) + len(self.dig) + len(self.power)

    def _digital_lanes(self, lanes: list) -> None:
        def bits(lane) -> int:
            slot, ks = lane[1], lane[2]
            return max(1, int(ks.config[_BPS_KEY[slot.class_name]]))

        lanes = sorted(lanes, key=lambda ln: (
            _ORDER[ln[1].class_name],
            bits(ln) if ln[1].class_name == "psk" else 0, ln[3]))
        self.dig = d = _Lanes(lanes)
        names = [s.class_name for s in d.slots]
        bps = [bits(ln) for ln in lanes]
        n_psk, n_fsk = names.count("psk"), names.count("fsk")
        # psk groups [a, b) of one bits-per-symbol; the fsk and ask runs
        self.psk = []
        for j in range(n_psk):
            if j == 0 or bps[j] != bps[j - 1]:
                self.psk.append([j, j + 1, bps[j]])
            else:
                self.psk[-1][1] = j + 1
        self.fsk = (n_psk, n_psk + n_fsk)
        self.ask = (n_psk + n_fsk, len(d))
        levels = np.array([1 << b for b in bps], np.float32)
        self.levels, self.top = levels, levels - 1
        # the gain of the psk and ask lanes (fsk is amplitude-invariant),
        # the drained stream's gain control (reference
        # InspectorCtl/GainControl.cpp): manual ``agc.gain`` where AGC is
        # off; where on, a power-EMA normalizer whose time constant is
        # ``agc.ts`` symbol periods, stepped once per block
        n_elapsed = self.block_out if self.squeezed else self.rows
        self.gain = np.ones(len(d), np.float32)
        on, alpha, self.off_kss = [], [], []
        for j, (name, ks) in enumerate(zip(names, d.kss)):
            if name == "fsk":
                continue
            c = ks.config
            if not bool(c["agc.enabled"]):
                self.gain[j] = np.float32(float(c["agc.gain"]))
                self.off_kss.append(ks)
                continue
            baud = max(float(c["clock.baud"]), 1e-3)
            sps = max(2.0, ks.bucket.channel_rate / baud)
            tau = max(float(c["agc.ts"]) * sps, 1.0)
            on.append(j)
            alpha.append(1.0 - np.exp(-n_elapsed / tau))
        self.on = np.array(on, np.int64)
        self.alpha = np.array(alpha, np.float64)
        self.on_kss = [d.kss[j] for j in on]

    # ------------------------------------------------------------------
    def run(self, out: list, audio_out, squelch_open, soft, strobe, y_re,
            y_im, power) -> None:
        """Fill ``out`` (one entry a slot of the block) at the plan's
        lanes' positions with their message tuples, and step their
        followers."""
        if len(self.audio):
            a = self.audio
            for p, slot, x, sq in zip(a.pos, a.slots, audio_out.T[a.sel],
                                      squelch_open[a.idx].tolist()):
                out[p] = (slot, x, {"squelch_open": sq}, None)
        if len(self.dig):
            self._digital(out, soft, strobe, power)
        if len(self.power):
            self._power(out, power)
        for pos, slot, ks, col in self.per_slot:
            raw = (None if y_re is None or col is None else
                   (y_re[:, col] + 1j * y_im[:, col]).astype(np.complex64))
            name = slot.class_name
            if name == "raw":
                g = np.float32(_raw_gain(ks, power, len(raw)))
                out[pos] = (slot, raw * g, {}, raw)
            elif name == "power":
                out[pos] = (slot, _integrate(ks, raw), {}, raw)
            else:
                x, extras = out[pos][1:3]
                if ks.resampler is not None:
                    x = ks.resampler(x)
                out[pos] = (slot, x, extras, raw)

    def _digital(self, out: list, soft, strobe, power) -> None:
        d = self.dig
        sym = soft[0][:, d.sel] + 1j * soft[1][:, d.sel]   # [rows, lanes]
        st = strobe[:, d.sel] > 0.5
        gain = self._gains(sym, power)
        for a, b in ((0, self.fsk[0]), self.ask):
            if a < b:
                sym[:, a:b] *= gain[a:b]
        for a, b, bits in self.psk:
            ids = decide_phase(sym[:, a:b], bits)
            for p, slot, x, s, i in zip(d.pos[a:b], d.slots[a:b],
                                        sym[:, a:b].T, st[:, a:b].T,
                                        ids.T):
                out[p] = (slot, x, {"strobes": s, "symbols": i}, None)
        for (a, b), decide in ((self.fsk, self._decide_fsk),
                               (self.ask, self._decide_ask)):
            if a == b:
                continue
            # a row a lane: the decisions take each lane's strobed rows
            vals = np.ascontiguousarray(sym[:, a:b].real.T)
            sts = np.ascontiguousarray(st[:, a:b].T)
            ids = decide(vals, sts, a, b)
            for p, slot, x, s, i in zip(d.pos[a:b], d.slots[a:b], vals,
                                        sts, ids):
                out[p] = (slot, x, {"strobes": s, "symbols": i}, None)

    def _gains(self, sym: np.ndarray, power) -> np.ndarray:
        """The float32 gain of each lane this block (1 on fsk lanes), the
        AGC followers stepped."""
        for k in self.off_kss:
            k.agc_ema = None
        gain = self.gain.copy()
        if not len(self.on):
            return gain
        if self.squeezed:
            # the device block-power row (pre-MF channel power): the
            # squeezed drain has no full-rate stream on the host to measure
            p = np.maximum(
                power[self.dig.idx[self.on]].astype(np.float64), 1e-12)
        elif self.rows:
            # each lane's own contiguous row, as the scalar form summed
            p = np.mean(np.abs(sym.T[self.on]) ** 2, axis=1).astype(
                np.float64)
        else:
            gain[self.on] = 1.0           # no estimate this block
            return gain
        prev, none = _follower(self.on_kss, "agc_ema")
        ema = np.where(none, p, prev + self.alpha * (p - prev))
        for k, v in zip(self.on_kss, ema.tolist()):
            k.agc_ema = v
        gain[self.on] = 1.0 / np.sqrt(np.maximum(ema, 1e-12))
        return gain

    def _strobed(self, mag: np.ndarray, st: np.ndarray, a: int, attr: str):
        """Each lane's (row's) strobe count, the lanes with strobes, and
        their EMA-tracked decision range (follower ``attr``, fed the max
        of ``mag`` over the lane's strobes), None without any."""
        counts = st.sum(axis=1)
        seen = np.flatnonzero(counts)
        if not seen.size:
            return counts, seen, None
        m = np.where(st, mag, -np.inf).max(axis=1)[seen].astype(np.float64)
        kss = [self.dig.kss[a + j] for j in seen.tolist()]
        prev, none = _follower(kss, attr)
        dec = np.where(none, m, prev + 0.1 * (m - prev))
        for k, v in zip(kss, dec.tolist()):
            setattr(k, attr, v)
        return counts, seen, dec

    def _decide_fsk(self, vals: np.ndarray, st: np.ndarray, a: int,
                    b: int) -> list:
        # per-lane decision span: symbol boundaries stay put across
        # blocks (reference Decider fixed min/max)
        counts, seen, dec = self._strobed(np.abs(vals), st, a, "dec_span")
        lo = np.zeros(b - a, np.float32)
        width = np.ones(b - a, np.float32)
        if dec is not None:
            span = np.maximum(dec, 1e-12)
            lo64, hi64 = -span * (1 + 1e-6), span * (1 + 1e-6)
            lo[seen] = lo64
            width[seen] = hi64 - lo64
        idx = np.floor((vals[st] - np.repeat(lo, counts))
                       / np.repeat(width, counts)
                       * np.repeat(self.levels[a:b], counts))
        ids = np.clip(idx, 0, np.repeat(self.top[a:b], counts))
        return np.split(ids.astype(np.uint8), np.cumsum(counts)[:-1])

    def _decide_ask(self, vals: np.ndarray, st: np.ndarray, a: int,
                    b: int) -> list:
        counts, seen, dec = self._strobed(vals, st, a, "dec_vmax")
        vmax = np.ones(b - a, np.float32)
        if dec is not None:
            vmax[seen] = np.maximum(dec, 1e-12)
        top = np.repeat(self.top[a:b], counts)
        idx = np.round(vals[st] / np.repeat(vmax, counts) * top)
        return np.split(np.clip(idx, 0, top).astype(np.uint8),
                        np.cumsum(counts)[:-1])

    def _power(self, out: list, power) -> None:
        """Block-aligned integration on the [1, C] block-power row (mean
        |y|² × M)."""
        pw, m = self.power, self.block_out
        acc = np.array([k.pw_acc for k in pw.kss], np.float64)
        acc += power[pw.idx].astype(np.float64) * m
        cnt = np.array([k.pw_cnt for k in pw.kss], np.int64) + m
        due = cnt >= self.n_int
        val = np.sqrt(acc / self.n_int).astype(np.float32)
        acc[due] = 0.0
        cnt[due] = 0
        for j, (p, slot, k, a, c, d) in enumerate(zip(
                pw.pos, pw.slots, pw.kss, acc.tolist(), cnt.tolist(),
                due.tolist())):
            k.pw_acc, k.pw_cnt = a, c
            out[p] = (slot, val[j:j + 1] if d else val[j:j], {}, None)


def _raw_gain(ks, power, n: int) -> float:
    """A raw lane's gain: ``agc.gain`` where AGC is off; where on, a
    power-EMA follower of time constant ``agc.ts`` channel samples,
    seeded by the block power, over the block's ``n`` samples."""
    c = ks.config
    if not bool(c["agc.enabled"]):
        ks.agc_ema = None
        return float(c["agc.gain"])
    p = max(float(power[ks.idx]), 1e-12)
    tau = max(float(c["agc.ts"]), 1.0)
    alpha = 1.0 - np.exp(-n / tau)
    if ks.agc_ema is None:
        ks.agc_ema = p
    else:
        ks.agc_ema += alpha * (p - ks.agc_ema)
    return 1.0 / np.sqrt(max(ks.agc_ema, 1e-12))


def _integrate(ks, raw: np.ndarray) -> np.ndarray:
    """A power lane's readings over its raw samples: windows of
    ``power.integrate-samples`` that need not line up with the blocks,
    carried in the ``pw_acc``, ``pw_cnt`` followers."""
    n_int = max(1, int(ks.config["power.integrate-samples"]))
    p = (raw.real.astype(np.float64) ** 2
         + raw.imag.astype(np.float64) ** 2)
    out = []
    pos = 0
    while pos < len(p):
        take = min(n_int - ks.pw_cnt, len(p) - pos)
        ks.pw_acc += float(p[pos:pos + take].sum())
        ks.pw_cnt += take
        pos += take
        if ks.pw_cnt == n_int:
            out.append(np.sqrt(ks.pw_acc / n_int))
            ks.pw_acc, ks.pw_cnt = 0.0, 0
    return np.asarray(out, np.float32)
