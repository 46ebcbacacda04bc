"""The session's host demap (``analyzer/demap.py``: class passes, then a
per-lane step) against the per-slot demap it replaced, kept below
verbatim as the plain reference.

Both demap the same fetched block from the same slots' host state: the
message tuples must be identical (slot, values, dtypes, shapes, order;
every array also byte for byte) and so must each slot's followers
(``agc_ema``, ``dec_span``, ``dec_vmax``, ``pw_acc``, ``pw_cnt``, and a
host resampler's position) after every block.  The synthetic cases run
the 1024-inspector cell's layout (832 audio, 48 psk, 8 fsk, 8 ask, 128
power) at its block shapes, with the cases' changes; the real session is
the small ``session-mix`` of ``session_small.py`` on its own drain
worker.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from sigdigger_tpu_torch import KernelAnalyzer
from sigdigger_tpu_torch.analyzer.kernel_engine import (
    _DIGITAL,
    _Bucket,
    _KernelSlotExtra,
)
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.sources import SynthBandSource
from sigdigger_tpu_torch.types import AnalyzerParams, Channel

# ---------------------------------------------------------------------------
# the plain reference: the per-slot demap and its helpers, verbatim
# ---------------------------------------------------------------------------

def _decide_phase(syms: np.ndarray, bits: int) -> np.ndarray:
    levels = 1 << bits
    sector = np.round(np.angle(syms) * levels / (2.0 * np.pi))
    return np.mod(sector, levels).astype(np.uint8)


def _decide_interval(v: np.ndarray, lo: float, hi: float,
                     bits: int) -> np.ndarray:
    levels = 1 << bits
    idx = np.floor((v - lo) / (hi - lo) * levels)
    return np.clip(idx, 0, levels - 1).astype(np.uint8)


def _decide_amplitude(v: np.ndarray, bits: int,
                      vmax: float | None = None) -> np.ndarray:
    if vmax is None:
        vmax = max(float(np.max(v)) if v.size else 0.0, 1e-12)
    levels = 1 << bits
    idx = np.round(v / vmax * (levels - 1))
    return np.clip(idx, 0, levels - 1).astype(np.uint8)


def _gain_from_power(self, ks: _KernelSlotExtra, p: float | None,
                     n_elapsed: int) -> float:
    """Gain-control contract for the drained digital stream
    (reference InspectorCtl/GainControl.cpp): manual ``agc.gain``
    when AGC is off; when on, a power-EMA normalizer whose time
    constant is ``agc.ts`` symbol periods, fed the power estimate
    ``p`` over ``n_elapsed`` channel-rate samples (None: no
    estimate this block, unit gain)."""
    c = ks.config
    if not bool(c["agc.enabled"]):
        ks.agc_ema = None
        return float(c["agc.gain"])
    if p is None:
        return 1.0
    baud = max(float(c["clock.baud"]), 1e-3)
    sps = max(2.0, ks.bucket.channel_rate / baud)
    tau = max(float(c["agc.ts"]) * sps, 1.0)
    alpha = 1.0 - np.exp(-n_elapsed / tau)
    if ks.agc_ema is None:
        ks.agc_ema = p
    else:
        ks.agc_ema += alpha * (p - ks.agc_ema)
    return 1.0 / np.sqrt(max(ks.agc_ema, 1e-12))


def per_slot_demap(self, h: dict, audio_out, squelch_open, soft,
                   strobe, y_re, y_im, power) -> list:
    """Per-slot messages of one fetched block; the caller holds the
    engine lock."""
    bucket: _Bucket = h["bucket"]
    pmaps = h.get("pmaps")
    msgs = []
    for slot in h["slots"]:
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
        c = ks.config
        raw_col = None
        if y_re is not None and r_col is not None and (
                name in ("raw", "power")
                or slot.estimators or slot.spectrum_source):
            raw_col = (y_re[:, r_col]
                       + 1j * y_im[:, r_col]).astype(np.complex64)
        if name == "audio":
            aud = audio_out[:, a_col]
            if ks.resampler is not None:
                aud = ks.resampler(aud)
            extras = {"squelch_open": bool(squelch_open[ks.idx])}
            msgs.append((slot, aud, extras, raw_col))
        elif name == "raw":
            if bool(c["agc.enabled"]):
                # power-EMA follower honoring agc.ts (channel
                # samples), seeded by the block power
                p = max(float(power[ks.idx]), 1e-12)
                tau = max(float(c["agc.ts"]), 1.0)
                alpha = 1.0 - np.exp(-len(raw_col) / tau)
                if ks.agc_ema is None:
                    ks.agc_ema = p
                else:
                    ks.agc_ema += alpha * (p - ks.agc_ema)
                g = 1.0 / np.sqrt(max(ks.agc_ema, 1e-12))
            else:
                ks.agc_ema = None
                g = float(c["agc.gain"])
            msgs.append((slot, raw_col * np.float32(g), {}, raw_col))
        elif name == "power":
            n_int = max(1, int(c["power.integrate-samples"]))
            out = []
            if raw_col is None:
                # device fast path: block-aligned integration on
                # the [1, C] block-power row (mean |y|² × M)
                m_blk = bucket.raw.cfg.block_out
                ks.pw_acc += float(power[ks.idx]) * m_blk
                ks.pw_cnt += m_blk
                if ks.pw_cnt >= n_int:
                    out.append(np.sqrt(ks.pw_acc / n_int))
                    ks.pw_acc, ks.pw_cnt = 0.0, 0
            else:
                p = (raw_col.real.astype(np.float64) ** 2
                     + raw_col.imag.astype(np.float64) ** 2)
                pos = 0
                while pos < len(p):
                    take = min(n_int - ks.pw_cnt, len(p) - pos)
                    ks.pw_acc += float(p[pos:pos + take].sum())
                    ks.pw_cnt += take
                    pos += take
                    if ks.pw_cnt == n_int:
                        out.append(np.sqrt(ks.pw_acc / n_int))
                        ks.pw_acc, ks.pw_cnt = 0.0, 0
            msgs.append((slot, np.asarray(out, np.float32), {},
                         raw_col))
        else:                              # psk / fsk / ask
            sym = soft[0][:, d_col] + 1j * soft[1][:, d_col]
            st = strobe[:, d_col] > 0.5
            if name != "fsk":              # fsk is amp-invariant
                if h.get("squeezed"):
                    # the device block-power row (pre-MF channel
                    # power): the squeezed drain has no full-rate
                    # stream on the host to measure
                    g = _gain_from_power(
                        self, ks, max(float(power[ks.idx]), 1e-12),
                        bucket.raw.cfg.block_out)
                else:
                    g = _gain_from_power(
                        self, ks, float(np.mean(np.abs(sym) ** 2))
                        if len(sym) else None, len(sym))
                sym = sym * np.float32(g)
            if name == "psk":
                bps = max(1, int(c["afc.bits-per-symbol"]))
                ids = _decide_phase(sym, bps)
                extras = {"strobes": st, "symbols": ids}
                msgs.append((slot, sym, extras, raw_col))
            elif name == "fsk":
                bps = max(1, int(c["fsk.bits-per-symbol"]))
                vals = np.real(sym)
                if st.any():
                    # per-slot EMA-tracked decision span: symbol
                    # boundaries stay put across blocks (reference
                    # Decider fixed min/max)
                    m = float(np.max(np.abs(vals[st])))
                    ks.dec_span = m if ks.dec_span is None else \
                        ks.dec_span + 0.1 * (m - ks.dec_span)
                    span = max(ks.dec_span, 1e-12)
                    ids = _decide_interval(
                        vals[st], -span * (1 + 1e-6),
                        span * (1 + 1e-6), bps)
                else:
                    ids = np.zeros(0, np.uint8)
                extras = {"strobes": st, "symbols": ids}
                msgs.append((slot, vals, extras, raw_col))
            else:
                bps = max(1, int(c["ask.bits-per-symbol"]))
                vals = np.real(sym)
                if st.any():
                    m = float(np.max(vals[st]))
                    ks.dec_vmax = m if ks.dec_vmax is None else \
                        ks.dec_vmax + 0.1 * (m - ks.dec_vmax)
                    ids = _decide_amplitude(
                        vals[st], bps,
                        vmax=max(ks.dec_vmax, 1e-12))
                else:
                    ids = np.zeros(0, np.uint8)
                extras = {"strobes": st, "symbols": ids}
                msgs.append((slot, vals, extras, raw_col))
    return msgs


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

FOLLOWERS = ("agc_ema", "dec_span", "dec_vmax", "pw_acc", "pw_cnt")


def state(an: KernelAnalyzer) -> dict:
    """Each slot's demap state: its followers and its resampler's."""
    out = {}
    for h, ks in an._kslots.items():
        rs = ks.resampler
        out[h] = (tuple(getattr(ks, f) for f in FOLLOWERS),
                  None if rs is None else (rs._pos, rs._last))
    return out


def restore(an: KernelAnalyzer, st: dict) -> None:
    for h, (vals, rs) in st.items():
        ks = an._kslots[h]
        for f, v in zip(FOLLOWERS, vals):
            setattr(ks, f, v)
        if rs is not None:
            ks.resampler._pos, ks.resampler._last = rs


def same_array(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)
    assert np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes()


def same_messages(got: list, want: list) -> None:
    assert len(got) == len(want)
    for (s1, x1, e1, r1), (s2, x2, e2, r2) in zip(got, want):
        assert s1 is s2
        same_array(x1, x2)
        assert e1.keys() == e2.keys()
        for k in e1:
            if isinstance(e2[k], np.ndarray):
                same_array(e1[k], e2[k])
            else:
                assert type(e1[k]) is type(e2[k]) and e1[k] == e2[k]
        assert (r1 is None) == (r2 is None)
        if r2 is not None:
            same_array(r1, r2)


def demap_both(an: KernelAnalyzer, h: dict, fetched: tuple,
               demap=None) -> list:
    """The batched demap of one block (``demap``, else the session's),
    held to the reference's messages and end state from the same start
    state."""
    with an._lock:
        start = state(an)
        want = per_slot_demap(an, dict(h), *fetched)
        end = state(an)
        restore(an, start)
        got = (demap or an._demap)(h, *fetched)
        assert state(an) == end
    same_messages(got, want)
    return got


# ---------------------------------------------------------------------------
# the 1024-inspector cell's layout, synthetic blocks
# ---------------------------------------------------------------------------

RATE = 102.4e6
BLOCK_OUT = 8192
DECIMATION = 64
AUDIO_DECIM = 32
CELL = [("audio", 832, {"audio.demodulator": 2, "audio.volume": 1.0,
                        "audio.sample-rate": 50000}),
        ("psk", 48, {"afc.bits-per-symbol": 2, "clock.baud": 200000.0}),
        ("fsk", 8, {"fsk.bits-per-symbol": 1, "clock.baud": 200000.0}),
        ("ask", 8, {"ask.bits-per-symbol": 1, "clock.baud": 200000.0}),
        ("power", 128, {"power.integrate-samples": BLOCK_OUT})]


def session(mix=CELL, edit=None, **kw) -> KernelAnalyzer:
    """A 1024-slot session at the cell's geometry with ``mix``'s
    inspectors opened in order; ``edit(i, cls)`` gives inspector i's
    config changes."""
    kw.setdefault("symbol_group", 4)
    kw.setdefault("compact_cols", 1024)
    src = SynthBandSource(SourceProfile(type="synth", sample_rate=RATE),
                          [])
    an = KernelAnalyzer(source=src, params=AnalyzerParams(window_size=4096),
                        block_size=BLOCK_OUT * DECIMATION, n_slots=1024,
                        decimation=DECIMATION, audio_decim=AUDIO_DECIM,
                        device="cpu", **kw)
    i = 0
    with an.bulk_config():
        for cls, count, cfg in mix:
            for _ in range(count):
                cfg_i = dict(cfg, **(edit(i, cls) if edit else {}))
                an.open_inspector(cls, Channel(fc=-48e6 + 93.75e3 * i,
                                               bw=200e3), config=cfg_i)
                i += 1
    an.poll()
    return an


def handles(an: KernelAnalyzer, cls: str) -> list[int]:
    return [h for h, s in an._inspectors.items() if s.class_name == cls]


def w8(n: int) -> int:
    w = 8
    while w < n:
        w *= 2
    return w


def block(an: KernelAnalyzer, rng, no_strobes=()) -> tuple[dict, tuple]:
    """What ``_dispatch_bucket`` and ``_fetch`` would hand the demap for
    the session as it stands: the block's layout and synthetic fetched
    planes of its shapes (the packed drain's quantization steps), the
    digital lanes of ``no_strobes`` (handles) without a strobe."""
    bucket = an._buckets[DECIMATION]
    slots = [s for s in an._inspectors.values()
             if an._kslots[s.handle].bucket is bucket]
    kss = [an._kslots[s.handle] for s in slots]
    comp = bool(bucket.cmap) and all(k.idx in bucket.cmap for k in kss)
    h = {"bucket": bucket, "slots": slots, "comp": comp,
         "cmap": dict(bucket.cmap), "block": 0}
    names = {s.class_name for s in slots}
    digital = bool(names & set(_DIGITAL))
    host_raw = any(an._needs_host_raw(s, k) for s, k in zip(slots, kss))
    n = an._n_slots
    ab = bucket.active_by
    squeeze = 1
    if comp and an._drain_pack:
        h["pmaps"] = {sec: {idx: col for col, idx in enumerate(cols)}
                      for sec, cols in ab.items()}
        if digital and bucket.squeeze is not None:
            h["squeezed"] = True
            squeeze = an._symbol_group
        width = {sec: w8(len(cols)) for sec, cols in ab.items()}
    else:
        w = bucket.comp_digital.cfg.width if comp else n
        width = {"audio": w, "digital": w, "raw": w}

    def col_of(k, sec):
        if "pmaps" in h:
            return h["pmaps"][sec].get(k.idx)
        return h["cmap"][k.idx] if comp else k.idx

    rows = BLOCK_OUT // squeeze
    audio_out = squelch = soft = strobe = y_re = y_im = None
    if "audio" in names:
        audio_out = (rng.integers(-3000, 3000, (BLOCK_OUT // AUDIO_DECIM,
                                                width["audio"]))
                     / 4096).astype(np.float32)
        squelch = rng.random(n) < 0.5
    if digital:
        soft = tuple((rng.integers(-8000, 8000, (rows, width["digital"]))
                      / 8192).astype(np.float32) for _ in range(2))
        strobe = (rng.random((rows, width["digital"]))
                  < 1.0 / (8 // squeeze)).astype(np.float32)
        for hd in no_strobes:
            col = col_of(an._kslots[hd], "digital")
            if col is not None:
                strobe[:, col] = 0.0
    if host_raw:
        y_re, y_im = ((rng.integers(-4000, 4000, (BLOCK_OUT, width["raw"]))
                       / 4096).astype(np.float32) for _ in range(2))
    power = rng.uniform(0.0, 1e-2, n).astype(np.float32)
    power[::97] = 0.0
    return h, (audio_out, squelch, soft, strobe, y_re, y_im, power)


def run_blocks(an, blocks=3, seed=0, between=None, no_strobes=(),
               layout=None):
    """``blocks`` blocks through both demaps; ``between(b)`` runs before
    block b's demap (after its layout was taken), ``layout(h)`` edits a
    block's layout.  Returns each block's plan."""
    rng = np.random.default_rng(seed)
    plans = []
    for b in range(blocks):
        h, fetched = block(an, rng, no_strobes if b % 2 == 0 else ())
        if layout is not None:
            layout(h)
        if between is not None:
            between(b)
        msgs = demap_both(an, h, fetched)
        assert msgs
        plans.append(h["bucket"].plan)
        # a lane takes a class pass, the per-lane step or both; the raw
        # class and power off the block grid take the per-lane step alone
        alone = [s for _, s, _, _ in plans[-1].per_slot
                 if s.class_name in ("raw", "power")]
        assert h["batched"] + len(alone) <= len(h["slots"])
        assert h["per_slot"] == len(plans[-1].per_slot)
    return plans


def _agc(i: int, cls: str) -> dict:
    if cls not in ("psk", "ask"):
        return {}
    return [{"agc.enabled": False, "agc.gain": 2.5},
            {"agc.ts": 10.0}, {}, {"agc.enabled": False}][i % 4]


def _psk_bits(i: int, cls: str) -> dict:
    return {"afc.bits-per-symbol": 1 + i % 3} if cls == "psk" else {}


def _bits(i: int, cls: str) -> dict:
    key = {"fsk": "fsk.bits-per-symbol", "ask": "ask.bits-per-symbol"}
    return {key[cls]: 1 + i % 2} if cls in key else {}


def _swap(mix, cls, n, new):
    """``mix`` with ``n`` fewer ``cls`` inspectors and ``new`` added."""
    out = [(c, k - n if c == cls else k, cfg) for c, k, cfg in mix]
    return out + new


CASES = {
    "packed-squeezed": dict(),
    "packed-unsqueezed": dict(kw=dict(symbol_group=1)),
    "unpacked-compact": dict(kw=dict(drain_pack=False)),
    "unpacked-full": dict(kw=dict(compact_cols=0)),
    "unpacked-compact-unsqueezed": dict(kw=dict(drain_pack=False,
                                                symbol_group=1)),
    "agc-on-off-gain": dict(edit=_agc),
    "agc-unsqueezed": dict(edit=_agc, kw=dict(symbol_group=1)),
    "psk-1-2-3-bits": dict(edit=_psk_bits),
    "fsk-ask-bits": dict(edit=_bits),
    "no-strobes": dict(no_strobes=("fsk", "ask", "psk")),
    "resampled-audio": dict(mix=_swap(CELL, "audio", 2, [
        ("audio", 2, {"audio.demodulator": 2,
                      "audio.sample-rate": 44100})])),
    "raw-lanes": dict(mix=_swap(CELL, "power", 8, [
        ("raw", 4, {}), ("raw", 4, {"agc.enabled": False,
                                    "agc.gain": 3.0})])),
    "raw-lanes-unpacked": dict(kw=dict(drain_pack=False), mix=_swap(
        CELL, "power", 8, [("raw", 8, {})])),
    "power-aligned-and-not": dict(mix=_swap(CELL, "power", 8, [
        ("power", 2, {"power.integrate-samples": 2 * BLOCK_OUT}),
        ("power", 2, {"power.integrate-samples": 3 * BLOCK_OUT}),
        ("power", 2, {"power.integrate-samples": 1000}),
        ("power", 2, {"power.integrate-samples": 20000})])),
    "power-unaligned-unpacked": dict(kw=dict(drain_pack=False),
                                     mix=_swap(CELL, "power", 2, [
        ("power", 2, {"power.integrate-samples": 1000})])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_demap_equals_per_slot(case):
    c = CASES[case]
    an = session(c.get("mix", CELL), c.get("edit"), **c.get("kw", {}))
    no_strobes = [h for cls in c.get("no_strobes", ())
                  for h in handles(an, cls)]
    plans = run_blocks(an, blocks=3, no_strobes=no_strobes)
    # the plan is built once for the layout and kept
    assert plans[0] is plans[1] is plans[2]


def lane_kinds(plan, handle) -> tuple[bool, bool]:
    """Whether the lane of ``handle`` takes a class pass of ``plan``, and
    whether it takes the per-lane step."""
    passed = any(s.handle == handle
                 for lanes in (plan.audio, plan.dig, plan.power)
                 for s in lanes.slots)
    alone = any(slot.handle == handle for _, slot, _, _ in plan.per_slot)
    return passed, alone


def test_lane_with_an_estimator_demaps_alone():
    """A lane with an estimator or a spectrum source demaps in its class
    pass, then takes the per-lane step alone for its raw column: its
    message carries the column and equals the reference's bit for
    bit."""
    an = session(_swap(CELL, "power", 2, []))
    psk, audio = handles(an, "psk")[3], handles(an, "audio")[5]
    ask = handles(an, "ask")[1]
    an.set_estimator(psk, "baud", True)
    an.set_estimator(audio, "offset", True)
    an.set_spectrum_source(ask, 1)
    run_blocks(an)
    h, fetched = block(an, np.random.default_rng(5))
    msgs = demap_both(an, h, fetched)
    assert h["per_slot"] == 3 and h["batched"] == 1022
    for hd in (psk, audio, ask):
        assert lane_kinds(h["bucket"].plan, hd) == (True, True)
        (msg,) = [m for m in msgs if m[0].handle == hd]
        assert msg[3] is not None and msg[3].dtype == np.complex64


RAW_COLUMN_CASES = {
    "fsk-spectrum-source": ("fsk", 2, "spectrum"),
    "ask-spectrum-source": ("ask", 5, "spectrum"),
    "fsk-estimator": ("fsk", 6, "estimator"),
    "resampled-audio": ("audio", 0, "resampler"),
    "resampled-audio-with-estimator": ("audio", 0, "both"),
}


@pytest.mark.parametrize("case", sorted(RAW_COLUMN_CASES))
def test_lane_with_its_own_step_takes_its_class_pass(case):
    """fsk and ask lanes with a spectrum source or an estimator, and an
    audio lane with a host resampler (with and without an estimator),
    demap in their class pass and then take the per-lane step: each
    message equals the reference's bit for bit over three blocks, and
    carries the raw column exactly where the lane has an estimator or a
    spectrum source."""
    cls, j, what = RAW_COLUMN_CASES[case]
    mix = CELL
    if cls == "audio":
        mix = _swap(CELL, "audio", 1, [
            ("audio", 1, {"audio.demodulator": 2,
                          "audio.sample-rate": 44100})])
    an = session(mix)
    hd = handles(an, cls)[-1 if cls == "audio" else j]
    if what == "spectrum":
        an.set_spectrum_source(hd, 1)
    elif what in ("estimator", "both"):
        an.set_estimator(hd, "offset", True)
    plans = run_blocks(an, blocks=3, seed=7)
    assert plans[0] is plans[1] is plans[2]
    assert lane_kinds(plans[0], hd) == (True, True)
    h, fetched = block(an, np.random.default_rng(8))
    msgs = demap_both(an, h, fetched)
    (msg,) = [m for m in msgs if m[0].handle == hd]
    assert (msg[3] is not None) == (what != "resampler")
    assert h["batched"] == 1024


def test_slot_closed_in_flight_stops_producing():
    an = session()
    closing = [handles(an, c)[2] for c in ("audio", "psk", "fsk", "ask",
                                           "power")]

    def close(b):
        if b == 1:
            for h in closing:
                an.close_inspector(h)

    plans = run_blocks(an, between=close)
    assert plans[1] is not plans[0]
    h, fetched = block(an, np.random.default_rng(9))
    assert not {s.handle for s in h["slots"]} & set(closing)
    demap_both(an, h, fetched)


def test_slot_missing_from_its_section_map_skips_the_block():
    an = session(_swap(CELL, "power", 4, [
        ("raw", 2, {}), ("power", 2, {"power.integrate-samples": 1000})]))
    gone = {sec: [an._kslots[handles(an, c)[j]].idx for j in (0, 1)]
            for sec, c in (("audio", "audio"), ("digital", "psk"),
                           ("raw", "raw"))}
    gone["raw"].append(an._kslots[handles(an, "power")[-1]].idx)

    def drop(h):
        for sec, idxs in gone.items():
            for idx in idxs:
                del h["pmaps"][sec][idx]

    rng = np.random.default_rng(3)
    h, fetched = block(an, rng)
    drop(h)
    msgs = demap_both(an, h, fetched)
    assert len(msgs) == len(h["slots"]) - 7


def test_config_change_rebuilds_the_plan_and_retune_keeps_it():
    an = session()
    psk, ask = handles(an, "psk"), handles(an, "ask")
    audio = handles(an, "audio")

    def retune(b):
        for j, hd in enumerate(audio[:64] + psk[:8]):
            an.set_inspector_freq(hd, -40e6 + 1e3 * b + 93.75e3 * j)

    plans = run_blocks(an, between=retune)
    assert plans[0] is plans[1] is plans[2]

    def configure(b):
        if b == 1:
            an.set_inspector_config(psk[0], {"afc.bits-per-symbol": 3})
            an.set_inspector_config(ask[0], {"agc.enabled": False,
                                             "agc.gain": 0.25})
            an.set_inspector_config(audio[0], {"audio.sample-rate": 48000})

    plans = run_blocks(an, between=configure, seed=1)
    assert plans[1] is not plans[0] and plans[2] is plans[1]
    assert plans[1].per_slot and plans[1].per_slot[0][1].handle == audio[0]


# ---------------------------------------------------------------------------
# the small session-mix session, drained on its own worker
# ---------------------------------------------------------------------------

def small_program(extra=()):
    """The small ``session-mix`` session's program on the CPU, with
    ``extra`` inspectors ((class, config)) opened after its mix."""
    from session_small import small_session

    from sdbench.drivers.session import Program

    cell = small_session()
    cfg = copy.deepcopy(cell.config)
    if extra:
        cfg.update(n_slots=cfg["n_slots"] + 8,
                   compact_cols=cfg["compact_cols"] + 8)
    prog = Program(cfg, cell.traffic, "cpu")
    for cls, conf in extra:
        prog.an.open_inspector(cls, Channel(fc=5e6, bw=200e3), config=conf)
    prog.an.poll()
    return prog


def feed(prog, blocks: int, seed: int = 0) -> None:
    """``blocks`` noise blocks with a few carriers through the session,
    its pipeline drained at the end."""
    rng = np.random.default_rng(seed)
    an = prog.an
    t = np.arange(prog.block_in)
    for b in range(blocks):
        x = 0.01 * (rng.standard_normal(prog.block_in)
                    + 1j * rng.standard_normal(prog.block_in))
        for f in (1e6, 26e6, 31e6, -47.9e6):
            x = x + 0.1 * np.exp(2j * np.pi * (f / 102.4e6)
                                 * (t + b * prog.block_in))
        prog.src.block = x.astype(np.complex64)
        assert an.step()
    for e in an._inflight:
        an._queue_drain(e)
    an._inflight.clear()
    an._drain_q.join()


def test_small_session_drain_equals_per_slot():
    prog = small_program()
    an = prog.an
    inner = an._demap
    checked, failures = [], []

    def both(h, *fetched):
        try:
            out = demap_both(an, h, fetched, inner)
            checked.append(len(out))
            return out
        except AssertionError as e:  # the worker would swallow it
            failures.append(e)
            return inner(h, *fetched)

    an._demap = both
    try:
        feed(prog, 5)
    finally:
        prog.close()
    assert not failures, failures[0]
    assert checked == [16] * 5


@pytest.mark.parametrize("extra,want", [
    ((), (16, 0)),
    ((("audio", {"audio.demodulator": 2, "audio.sample-rate": 44100}),
      ("raw", {})), (17, 2)),
], ids=["mix", "resampled-and-raw"])
def test_demap_span_counts_its_lanes(extra, want):
    """Traced, the ``an.demap`` span of each block carries how many
    slots the class passes took (``batched``) and how many took the
    per-lane step (``per_slot``): a resampled audio lane takes both, a
    raw lane the per-lane step alone."""
    from torch.profiler import ProfilerActivity, profile

    from sigdigger_tpu_torch.utils import profiling

    prog = small_program(extra)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            feed(prog, 2)
    finally:
        prog.close()
    counts = [(r.attrs["batched"], r.attrs["per_slot"])
              for r in profiling.records() if r.name == "an.demap"]
    assert counts == [want] * 2
