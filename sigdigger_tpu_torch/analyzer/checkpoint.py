"""Analyzer checkpoint / resume (counterpart of
``sigdigger_tpu/analyzer/checkpoint.py``).

Two engine formats share the container, as in the reference.

The class-path :class:`Analyzer` saves the reference's generic format
(``checkpoint.py:41-80,234-275``): ``meta.json`` with the stream offset,
the profile and parameters, the spectrum's frame count, the
channelizer's frame index and every inspector (class, config, centre,
bandwidth, estimators, spectrum source and the channel's residual
phase), ``psd.npy`` (the running PSD) and ``tail.npy`` (the
channelizer's overlap tail).  A load reopens the inspectors with their
config and restores those carries; the demod loops' own states (AGC,
Costas, clock, equalizer) are not in the format and re-acquire, as in
the reference.

The ``KernelAnalyzer``'s checkpoint holds the session's DSP state, not only its
configuration: the stream offset, the PSD accumulator and every bank
carry plane (framing history, rotator phases, FIR tails, squelch and DC
EMAs, the hang-AGC follower, the full recovery loop state), plus every
inspector's config, bucket and slot column, so a capture replay resumes
exactly where it stopped.  A restored session is bit-identical to the
uninterrupted one: the per-slot constant columns are rebuilt from the
saved configs, which are their only inputs.

The zip layout is the reference's (``FORMAT_VERSION`` 2): ``meta.json``,
``psd.npy`` and per bucket ``b{d}.raw_hist``, ``b{d}.raw_phi``,
``b{d}.aud{carry}`` over :data:`_AUDIO_CARRIES` and ``b{d}.rec_state``,
each an ``.npy``.  A checkpoint the reference's ``KernelAnalyzer``
writes loads here, and one written here loads there.  The port's carries
have the reference's shapes and types; each is converted to the port's
type on load and checked for its shape, and the device PSD EMA is
rebuilt from the natural-order PSD in the kernels' digit layout, as the
reference rebuilds its own (``checkpoint.py:224-229``).

Either package loads the other's checkpoint of either format.

The reference's fault at ``checkpoint.py:89-92`` is not carried over: a
save with the threaded drain first lets the drain worker finish the
blocks it has queued, then drains the blocks still in flight, so every
block's messages leave in stream order.
"""

from __future__ import annotations

import json
import time
import zipfile

import numpy as np
import torch

from sigdigger_tpu_torch.analyzer.engine import Analyzer
from sigdigger_tpu_torch.analyzer.estimators import prepare as prepare_est
from sigdigger_tpu_torch.analyzer.kernel_engine import KernelAnalyzer, _host
from sigdigger_tpu_torch.dsp.spectrum import SpectrumState
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import AnalyzerParams, Channel

FORMAT_VERSION = 2

_AUDIO_CARRIES = ("_history", "_prev_re", "_prev_im", "_ftail1",
                  "_ftail2", "_atail1", "_atail2", "_sq", "_dc",
                  "_agcs", "_phi", "_phs_a")


def save_checkpoint(analyzer, path: str) -> None:
    """Write ``analyzer``'s session to the zip at ``path``."""
    if not isinstance(analyzer, KernelAnalyzer):
        _save_generic(analyzer, path)
        return
    an = analyzer
    # land on a block edge, in stream order: the drain worker first
    # emits the blocks it has queued, then the blocks still in flight
    # are drained here (their messages are emitted, not lost)
    if an._drain_q is not None:
        an._drain_q.join()
    if an._inflight:
        an._emit_block_msgs(an._flush_pipeline(), time.time())

    arrays: dict[str, np.ndarray] = {}
    slots = []
    for handle, slot in an._inspectors.items():
        ks = an._kslots[handle]
        s = {
            "handle": handle,
            "inspector_id": slot.inspector_id,
            "class": slot.class_name,
            "config": ks.config.as_dict(),
            "f0": slot.lo,
            "bw": slot.bandwidth,
            "estimators": sorted(slot.estimators),
            "spectrum_source": slot.spectrum_source,
            "decimation": ks.bucket.decimation,
            "idx": ks.idx,
            "pw_acc": ks.pw_acc,
            "pw_cnt": ks.pw_cnt,
            "agc_ema": ks.agc_ema,
            "dec_span": ks.dec_span,
            "dec_vmax": ks.dec_vmax,
        }
        if ks.resampler is not None:
            s["rs_pos"] = float(ks.resampler._pos)
            s["rs_last"] = float(ks.resampler._last)
        slots.append(s)
    for d, b in an._buckets.items():
        pre = f"b{d}."
        arrays[pre + "raw_hist"] = _host(b.raw._history)
        arrays[pre + "raw_phi"] = _host(b.raw._phi)
        for nm in _AUDIO_CARRIES:
            arrays[pre + "aud" + nm] = _host(getattr(b.audio, nm))
        arrays[pre + "rec_state"] = _host(b.rec.state)

    spec = an._spectrum
    psd = spec._host_psd() if hasattr(spec, "_host_psd") else spec.psd
    meta = {
        "version": FORMAT_VERSION,
        "engine": "kernel",
        "position": an.source.position,
        "profile": an.profile.to_dict(),
        "params": an.params.to_dict(),
        "psd_count": spec._count,
        "samples_done": an._samples_done,
        "block_size": an.block_size,
        "n_slots": an._n_slots,
        "decimation": an._decimation,
        "audio_decim": an._audio_decim,
        "decimations": list(an._decimations),
        "compact_cols": an._compact_cols,
        "symbol_group": an._symbol_group,
        "inspectors": slots,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        with z.open("psd.npy", "w") as f:
            np.save(f, np.asarray(psd))
        for name, a in arrays.items():
            with z.open(name + ".npy", "w") as f:
                np.save(f, a)


def _save_generic(analyzer: Analyzer, path: str) -> None:
    """The class path's checkpoint, in the reference's generic format."""
    chz = analyzer._channelizer
    spec = analyzer._spectrum
    slots = []
    for handle, slot in analyzer._inspectors.items():
        n_sub, idx = chz.slot_of(slot.chan_handle)
        ch = chz._buckets[n_sub].slots[idx]
        slots.append({
            "handle": handle,
            "inspector_id": slot.inspector_id,
            "class": slot.class_name,
            "config": slot.inspector.config.as_dict(),
            "f0": ch.f0,
            "bw": slot.bandwidth,
            "estimators": sorted(slot.estimators),
            "spectrum_source": slot.spectrum_source,
            "phase": ch.phase,
        })
    meta = {
        "version": FORMAT_VERSION,
        "position": analyzer.source.position,
        "profile": analyzer.profile.to_dict(),
        "params": analyzer.params.to_dict(),
        "psd_count": spec.state.count,
        "frame_index": chz._frame_index,
        "inspectors": slots,
        "samples_done": analyzer._samples_done,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        with z.open("psd.npy", "w") as f:
            np.save(f, _host(spec.state.psd))
        with z.open("tail.npy", "w") as f:
            np.save(f, _host(chz._tail))


def _load_generic(meta: dict, z: zipfile.ZipFile, device,
                  options: dict) -> Analyzer:
    """A class-path ``Analyzer`` from the reference's generic format."""
    analyzer = Analyzer(profile=SourceProfile.from_dict(meta["profile"]),
                        params=AnalyzerParams.from_dict(meta["params"]),
                        device=device, **options)
    if analyzer.source.seekable:
        analyzer.source.seek(meta["position"])
    chz = analyzer._channelizer
    spec = analyzer._spectrum
    psd = np.load(z.open("psd.npy"))
    analyzer._spectrum.state = SpectrumState(
        psd=torch.as_tensor(_like(psd, spec.state.psd, "psd")).to(
            analyzer.device),
        count=meta["psd_count"])
    chz._tail = torch.as_tensor(_like(np.load(z.open("tail.npy")), chz._tail,
                                      "tail")).to(analyzer.device)
    chz._frame_index = meta["frame_index"]
    analyzer._samples_done = meta["samples_done"]

    for s in meta["inspectors"]:
        handle = analyzer.open_inspector(
            s["class"], Channel(fc=s["f0"], bw=s["bw"]),
            config=s["config"])
        slot = analyzer._inspectors[handle]
        analyzer.set_inspector_id(handle, s["inspector_id"])
        for est in s["estimators"]:
            slot.estimators.add(est)
        slot.spectrum_source = s["spectrum_source"]
        n_sub, idx = chz.slot_of(slot.chan_handle)
        chz._buckets[n_sub].slots[idx].phase = s["phase"]
    analyzer.poll()   # drop replayed open acks
    return analyzer


def _like(saved: np.ndarray, current, name: str) -> np.ndarray:
    """``saved`` as the port's carry ``current``: its type, its shape."""
    cur = _host(current)
    if saved.shape != cur.shape:
        raise ValueError(f"checkpoint carry {name} has shape {saved.shape}, "
                         f"the session's is {cur.shape}")
    return np.ascontiguousarray(saved, dtype=cur.dtype)


def _load_kernel(meta: dict, z: zipfile.ZipFile, device,
                 options: dict) -> KernelAnalyzer:
    an = KernelAnalyzer(
        profile=SourceProfile.from_dict(meta["profile"]),
        params=AnalyzerParams.from_dict(meta["params"]),
        block_size=meta["block_size"], n_slots=meta["n_slots"],
        decimation=meta["decimation"], audio_decim=meta["audio_decim"],
        decimations=tuple(meta["decimations"]),
        compact_cols=meta["compact_cols"],
        symbol_group=meta["symbol_group"], device=device, **options)
    if an.source.seekable:
        an.source.seek(meta["position"])
    an._samples_done = meta["samples_done"]

    with an.bulk_config():
        for s in meta["inspectors"]:
            bucket = an._buckets[s["decimation"]]
            # steer the reopen into the slot's ORIGINAL column: the
            # saved carry planes live at those columns
            bucket.free.remove(s["idx"])
            bucket.free.append(s["idx"])
            handle = an.open_inspector(
                s["class"], Channel(fc=s["f0"], bw=s["bw"]),
                config=s["config"])
            slot = an._inspectors[handle]
            ks = an._kslots[handle]
            if ks.idx != s["idx"] or \
                    ks.bucket.decimation != s["decimation"]:
                raise ValueError(
                    f"restore placed inspector {s['inspector_id']} at "
                    f"bucket 1/{ks.bucket.decimation} slot {ks.idx}, "
                    f"checkpoint says 1/{s['decimation']} slot "
                    f"{s['idx']}")
            an.set_inspector_id(handle, s["inspector_id"])
            for est in s["estimators"]:
                slot.estimators.add(est)
                prepare_est(est, ks.bucket.raw.cfg.block_out,
                            slot.equiv_rate, an.device)
            slot.spectrum_source = s["spectrum_source"]
            ks.pw_acc = s["pw_acc"]
            ks.pw_cnt = s["pw_cnt"]
            ks.agc_ema = s["agc_ema"]
            ks.dec_span = s["dec_span"]
            ks.dec_vmax = s["dec_vmax"]
            if "rs_pos" in s and ks.resampler is not None:
                ks.resampler._pos = s["rs_pos"]
                ks.resampler._last = s["rs_last"]

    # overwrite the bank carries AFTER every reopen (opens reset their
    # slot's columns of these planes)
    def arr(name):
        return np.load(z.open(name + ".npy"))

    for d, b in an._buckets.items():
        pre = f"b{d}."
        b.raw._history = _like(arr(pre + "raw_hist"), b.raw._history,
                               pre + "raw_hist")
        b.raw._phi = _like(arr(pre + "raw_phi"), b.raw._phi,
                           pre + "raw_phi")
        for nm in _AUDIO_CARRIES:
            setattr(b.audio, nm, _like(arr(pre + "aud" + nm),
                                       getattr(b.audio, nm),
                                       pre + "aud" + nm))
        b.rec.state = _like(arr(pre + "rec_state"), b.rec.state,
                            pre + "rec_state")

    spec = an._spectrum
    psd = np.load(z.open("psd.npy"))
    spec.psd = psd.astype(np.float64)
    spec._count = meta["psd_count"]
    if hasattr(spec, "_psd_dev") and spec._count > 0:
        # natural bin order → the kernels' (k1, k2) digit layout [A, B]
        cfg = spec.cfg
        spec._psd_dev = torch.from_numpy(np.ascontiguousarray(
            psd.astype(np.float32).reshape(cfg.b, cfg.a).T)).to(an.device)
    an.poll()   # drop replayed open acks
    return an


def load_checkpoint(path: str, device=None, **options):
    """The session resumed from the checkpoint at ``path``, on ``device``
    (``None``: the card): a ``KernelAnalyzer`` for the kernel format, a
    class-path ``Analyzer`` for the generic one.  ``options`` are further
    arguments of that class which the checkpoint does not record
    (``pipeline_depth``, ``drain_thread``, ``drain_pack``, ...;
    ``block_size`` for the class path)."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint version {meta['version']} too new")
        if meta.get("engine") != "kernel":
            return _load_generic(meta, z, device, options)
        return _load_kernel(meta, z, device, options)
