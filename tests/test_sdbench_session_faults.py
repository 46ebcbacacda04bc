"""A session run broken underneath comes out not correct: one fault
planted, through the harness's ``program_hook``, in each of the audio
bank, the recovery bank (on every digital lane, on the fsk and ask lanes
alone, from the block's second half on, and on one lane by 2%), the
squeeze, the pack and the demap, and one carry not carried (one card: no
exchange between chips to leave out)."""

from __future__ import annotations

import pytest
import torch
from session_small import run, small_session


def audio_bank(prog):
    """One audio sample of one lane is off where the audio bank makes
    it."""
    bank = prog.bucket.audio
    call = bank._call

    def altered(*a):
        out = call(*a)
        audio = out[0].clone()
        audio[5, 3] += 0.25
        return (audio,) + tuple(out[1:])

    bank._call = altered


def recovery_bank(prog):
    """The recovery bank's soft symbols come out 5% large."""
    bank = prog.bucket.rec
    call = bank._call

    def altered(*a):
        sr, si, st, state = call(*a)
        return sr * 1.05, si * 1.05, st, state

    bank._call = altered


def _scaled_symbols(prog, factor, classes=("psk", "fsk", "ask"),
                    lanes=None, from_row=0):
    """The recovery bank's soft symbols come out ``factor`` large on the
    digital inspectors of ``classes`` (the first ``lanes`` of them, or
    all), from channel row ``from_row`` of the block on."""
    an, bank = prog.an, prog.bucket.rec
    cols = [an._kslots[h].idx for h in prog.handles
            if an._inspectors[h].class_name in classes][:lanes]
    call = bank._call

    def altered(*a):
        sr, si, st, state = call(*a)
        sr, si = sr.clone(), si.clone()
        for p in (sr, si):
            p[from_row:, cols] *= factor
        return sr, si, st, state

    bank._call = altered


def recovery_fsk_ask(prog):
    """The fsk and ask inspectors' soft symbols alone come out 5%
    large."""
    _scaled_symbols(prog, 1.05, classes=("fsk", "ask"))


def recovery_late_rows(prog):
    """Every digital inspector's soft symbols come out 5% large from the
    block's second half on."""
    _scaled_symbols(prog, 1.05, from_row=prog.bucket.rec.cfg.block_len
                    // 2)


def recovery_one_lane(prog):
    """One fsk inspector's soft symbols come out 2% large."""
    _scaled_symbols(prog, 1.02, classes=("fsk",), lanes=1)


def squeeze(prog):
    """The squeeze hands each group's sums to the next group's row."""
    sq = prog.bucket.squeeze
    dispatch = sq.dispatch

    def altered(*a):
        return tuple(torch.roll(p, 1, 0) for p in dispatch(*a))

    sq.dispatch = altered


def pack(monkeypatch):
    """One int16 of the pack's audio section is off by 64 steps."""
    from sigdigger_tpu_torch.kernels.drainpack import DrainPacker

    dispatch = DrainPacker.dispatch

    def altered(self, **kw):
        out = dispatch(self, **kw).clone()
        out[1, 2] += 64
        return out

    monkeypatch.setattr(DrainPacker, "dispatch", altered)


def demap(prog):
    """The demap hands two audio inspectors each other's columns."""
    an = prog.an
    inner = an._demap

    def altered(h, *fetched):
        msgs = inner(h, *fetched)
        audio = [i for i, m in enumerate(msgs)
                 if m[0].class_name == "audio"]
        a, b = audio[0], audio[1]
        msgs[a], msgs[b] = ((msgs[a][0],) + msgs[b][1:],
                            (msgs[b][0],) + msgs[a][1:])
        return msgs

    an._demap = altered


def carry_not_carried(prog):
    """The audio bank keeps its decimating FIR's tail as it was."""
    bank = prog.bucket.audio
    call = bank._call

    def altered(xr, xi, consts, carries, *rest):
        out = call(xr, xi, consts, carries, *rest)
        return out[:3] + (carries[2],) + out[4:]

    bank._call = altered


@pytest.mark.parametrize("fault", ["audio_bank", "recovery_bank",
                                   "recovery_fsk_ask", "recovery_late_rows",
                                   "recovery_one_lane", "squeeze", "pack",
                                   "demap", "carry_not_carried"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    cell = small_session()
    if fault == "pack":
        pack(monkeypatch)
        r = run(cell)
    else:
        r = run(cell, hook=globals()[fault])
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]
