"""Mesh sharding of the functional receiver pipeline (counterpart of
``sigdigger_tpu/parallel/sharding.py``).

The reference maps its concurrency axes onto a ("time", "ch") mesh and
runs ``pipeline.py``'s step under ``shard_map``:

- ``ch`` — the per-channel constants and demod state are split on the
  channel axis; no communication inside a step;
- ``time`` — each shard processes a contiguous time slice of the block;
  the overlap-save history comes from the left neighbour (a
  ``ppermute``) and the PSD folds are combined with the closed-form EMA
  weights (a weighted ``psum``).

Here one process drives every cell of a :class:`~.banks.Mesh` (the
reference's single controller): each ``ppermute`` is the left
neighbour's tail copied to the shard's device, and each ``psum`` a sum
in shard order.  The big FFT of a time slice runs once, on the row's
first device, and its spectra are copied to the row's other channel
blocks (the reference computes them on every device of the row).  Cells
owned by another process (``parallel/distributed.py``) are skipped:
their channels' outputs come back as :class:`LocalShards`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.dsp.filters import _conv_real
from sigdigger_tpu_torch.inspectors.audio import dc_follow
from sigdigger_tpu_torch.parallel.banks import Mesh, default_devices
from sigdigger_tpu_torch.pipeline import (
    _DEMODS,
    PipelineConfig,
    _extract,
    _stft,
)

_TWO_PI = 2.0 * np.pi
# the carried state that is not split on the channel axis
_REPLICATED = ("tail", "frame_parity", "psd", "psd_count")
# the per-channel constants (rows); the rest is replicated
_CH_CONSTS = ("idx", "resp", "k0", "dphi")
_RECURRENT = ("quad_prev", "lpf_tail", "dc", "agc", "costas", "mf_tail",
              "clock")


def make_mesh(n_time: int = 1, n_ch: int | None = None,
              devices=None) -> Mesh:
    """2-D mesh over ("time", "ch"): every visible card by default; an
    explicit list may repeat a device."""
    devices = list(devices if devices is not None else default_devices())
    if n_ch is None:
        n_ch = len(devices) // n_time
    if n_time * n_ch > len(devices) or n_time * n_ch == 0:
        raise ValueError(f"need {n_time * n_ch} devices, have "
                         f"{len(devices)}")
    grid = np.empty(n_time * n_ch, dtype=object)
    grid[:] = devices[:n_time * n_ch]
    return Mesh(grid.reshape(n_time, n_ch), axis_names=("time", "ch"))


class LocalShards:
    """The shards of a ``[C, T]`` output that this process computed:
    ``shards`` holds ``(index, tensor)`` pairs, ``index`` a tuple of
    slices into the global ``shape`` (the reference's addressable
    shards)."""

    def __init__(self, shards: list, shape: tuple) -> None:
        self.shards = shards
        self.shape = shape


def _put_rows(whole, part, rows: slice, n: int):
    """``whole`` with its channel ``rows`` replaced by ``part`` (a copy;
    leaves without a channel axis stay)."""
    if isinstance(whole, tuple):
        return tuple(_put_rows(w, p, rows, n) for w, p in zip(whole, part))
    if whole.dim() == 0 or whole.shape[0] != n:
        return whole
    whole = whole.clone()
    whole[rows] = part.to(whole.device)
    return whole


def _tree(v, fn):
    return tuple(fn(t) for t in v) if isinstance(v, tuple) else fn(v)


class _Split:
    """Row (channel) blocks of the pipeline's per-channel tensors."""

    def __init__(self, n_channels: int, n_ch: int) -> None:
        if n_channels % n_ch:
            raise ValueError(f"n_channels {n_channels} not divisible by "
                             f"ch-mesh size {n_ch}")
        self.n = n_channels
        self.lc = n_channels // n_ch

    def rows(self, v: torch.Tensor, c: int, dev) -> torch.Tensor:
        if v.dim() >= 1 and v.shape[0] == self.n:
            v = v[c * self.lc:(c + 1) * self.lc]
        return v.to(dev)

    def consts(self, consts: dict, c: int, dev) -> dict:
        return {k: (self.rows(v, c, dev) if k in _CH_CONSTS
                    else _tree(v, lambda t: t.to(dev)))
                for k, v in consts.items()}

    def state(self, state: dict, c: int, dev) -> dict:
        return {k: (v if k in _REPLICATED
                    else _tree(v, lambda t: self.rows(t, c, dev)))
                for k, v in state.items()}


def sharded_pipeline_step(cfg: PipelineConfig, mesh: Mesh,
                          consts: dict[str, Any], state: dict[str, Any], x,
                          handoff: str = "replica"):
    """One block through the pipeline on every local cell of ``mesh``.

    Where the reference's body is the per-device view under
    ``shard_map``, this is the controller's: ``x`` is the whole block,
    split into ``n_time`` contiguous slices, and ``consts``/``state``
    are whole, split into the cells' channel blocks.  Returns (state,
    outputs) with the state's channel rows updated for the local cells
    and every output ``[C, T]`` whole (one process) or as
    :class:`LocalShards`."""
    n_t, n_c = mesh.shape["time"], mesh.shape["ch"]
    devs = mesh.devices
    local = mesh.local()
    home = mesh.home
    hop = cfg.hop
    split = _Split(cfg.n_channels, n_c)
    x = torch.as_tensor(x).to(dtype=torch.complex64)
    if x.shape[0] % n_t:
        raise ValueError(f"block of {x.shape[0]} samples not divisible by "
                         f"time-mesh size {n_t}")
    xs = x.reshape(n_t, -1)
    my_frames = xs.shape[1] // hop
    if my_frames % 2 or xs.shape[1] % hop:
        # the PSD folds every other frame: a shard's fold weights hold
        # only for an even number of whole hops
        raise ValueError(f"a time shard of {xs.shape[1]} samples is not an "
                         f"even number of {hop}-sample hops")
    frames_per_shard = my_frames // 2

    # --- big FFT of every time slice; the halo is the left shard's tail
    rows = [t for t in range(n_t) if local[t].any()]
    spectra, parts = {}, []
    alpha = consts["psd_alpha"]
    for t in rows:
        dev = devs[t, 0]
        tail = (state["tail"] if t == 0 else xs[t - 1][-hop:]).to(dev)
        zero = torch.zeros_like(state["psd"])
        one = torch.ones_like(state["psd_count"])
        spec, _, psd_part, _ = _stft(
            tail, xs[t].to(dev), consts["taps"].to(dev),
            consts["psd_scale"].to(dev),
            (state["psd"] if t == 0 else zero).to(dev),
            (state["psd_count"] if t == 0 else one).to(dev),
            alpha.to(dev), cfg.fft_size)
        spectra[t] = spec
        parts.append((t, psd_part))
    # exact cross-shard EMA: psd = Σ_t D^(n_time-1-t)·psd_part_t, with
    # D = (1-α)^f and the seed only on shard 0
    decay = torch.tensor(np.float32((1.0 - cfg.psd_alpha)
                                    ** frames_per_shard))
    psd = None
    for t, part in parts:
        w = (decay ** float(n_t - 1 - t)).to(part.device)
        term = (w * part).to(home)
        psd = term if psd is None else psd + term

    new_state = dict(state)
    if local[n_t - 1].any():
        new_state["tail"] = xs[n_t - 1][-hop:].to(state["tail"].device)
    new_state["psd"] = psd.to(state["psd"].device)
    new_state["psd_count"] = state["psd_count"] + n_t * frames_per_shard
    new_state["frame_parity"] = state["frame_parity"] + n_t * my_frames

    outputs: dict[str, list] = {}
    carried: dict[int, dict] = {}
    for c in range(n_c):
        if not local[:, c].any():
            continue
        c_out, c_state = _channel_block(
            cfg, [devs[t, c] for t in range(n_t)], split, consts, state,
            spectra, c, my_frames, handoff)
        carried[c] = c_state
        for k, per_t in c_out.items():
            outputs.setdefault(k, []).append(
                (c, torch.cat([o.to(home) for o in per_t], dim=1)))

    # the local channel blocks' carries, back into the whole state
    for c, cs in carried.items():
        rows = slice(c * split.lc, (c + 1) * split.lc)
        for k, v in cs.items():
            if k not in _REPLICATED:
                new_state[k] = _put_rows(new_state[k], v, rows,
                                         cfg.n_channels)
    out: dict[str, Any] = {}
    for k, blocks in outputs.items():
        if len(blocks) == n_c:
            out[k] = torch.cat([b for _, b in blocks])
        else:
            t_len = blocks[0][1].shape[1]
            out[k] = LocalShards(
                [((slice(c * split.lc, (c + 1) * split.lc),
                   slice(0, t_len)), b) for c, b in blocks],
                (cfg.n_channels, t_len))
    out["psd"] = psd
    return new_state, out


def _channel_block(cfg, devs, split: _Split, consts, state, spectra, c: int,
                   my_frames: int, handoff: str):
    """Channel block ``c`` over the time shards in order: (outputs per
    key as a list over time shards, the carried per-channel state)."""
    n_t = len(devs)
    half = cfg.n_sub // 2
    k1 = cfg.audio_taps - 1
    per_t = [split.consts(consts, c, d) for d in devs]
    st0 = split.state(state, c, devs[0])
    ys, phis = [], []
    for t, dev in enumerate(devs):
        k = per_t[t]
        # frame parity and residual phase continue across time shards
        parity = state["frame_parity"].to(dev) + t * my_frames
        phi = torch.remainder(
            st0["phi"].to(dev) + k["dphi"] * np.float32(t * my_frames * half),
            _TWO_PI)
        y, phi_new, _ = _extract(spectra[t].to(dev), k, phi, parity,
                                 cfg.n_sub, cfg.fft_size)
        ys.append(y)
        phis.append(phi_new)
    cs = dict(st0)
    cs["phi"] = torch.remainder(phis[-1], _TWO_PI)
    outs: dict[str, list] = {}
    if cfg.demod == "fm":
        prev_y = st0["quad_prev"]
        prev_f = st0["lpf_tail"].real
        audio = []
        for t, (dev, y) in enumerate(zip(devs, ys)):
            prev = prev_y.to(dev)
            shifted = torch.cat([prev[:, None], y[:, :-1]], dim=1)
            f = torch.angle(y * torch.conj(shifted)) * np.float32(1.0 / np.pi)
            audio.append(_conv_real(torch.cat([prev_f.to(dev), f], dim=1),
                                    per_t[t]["audio_taps"]))
            prev_y, prev_f = y[:, -1], f[:, -k1:]
        cs["quad_prev"] = prev_y
        cs["lpf_tail"] = prev_f.to(torch.complex64)
        outs["audio"] = audio
    elif cfg.demod == "am":
        # the DC follower is linear in its carry: each shard runs from a
        # zero carry, and its true carry is the decayed prefix sum of
        # the earlier shards' folds (the reference's closed form)
        a_dc = np.float32(0.9995)
        t_len = ys[0].shape[1]
        decay_t = torch.tensor(a_dc) ** t_len
        ramp = torch.tensor(a_dc) ** torch.arange(1, t_len + 1,
                                                  dtype=torch.float32)
        folds, zeros = [], []
        for dev, y in zip(devs, ys):
            zfold, a_zero = dc_follow(torch.abs(y),
                                      torch.zeros(y.shape[0], device=dev))
            folds.append(zfold)
            zeros.append(a_zero)
        prev_a = st0["lpf_tail"].real
        c_run = st0["dc"]
        audio = []
        for t, dev in enumerate(devs):
            # c0_t = D^t·dc + Σ_{s<t} D^(t-1-s)·fold_s
            c0 = (decay_t ** float(t)) * st0["dc"]
            for s in range(t):
                c0 = c0 + (decay_t ** float(t - 1 - s)) * folds[s].to(
                    c0.device)
            c0 = c0.to(dev)
            a = zeros[t] - ramp.to(dev)[None, :] * c0[:, None]
            audio.append(_conv_real(torch.cat([prev_a.to(dev), a], dim=1),
                                    per_t[t]["audio_taps"]))
            prev_a = a[:, -k1:]
            c_run = decay_t.to(dev) * c0 + folds[t]
        cs["dc"] = c_run
        cs["lpf_tail"] = prev_a.to(torch.complex64)
        outs["audio"] = audio
    elif cfg.demod == "psk" and handoff == "exact" and n_t > 1:
        # exact sequential hand-off of the loop chain (AGC, Costas, MF,
        # Gardner): time shard s starts from shard s-1's final state
        rec = {k: st0[k] for k in ("agc", "costas", "mf_tail", "clock")}
        for t, dev in enumerate(devs):
            st = dict(st0)
            st.update({k: _tree(v, lambda x, d=dev: x.to(d))
                       for k, v in rec.items()})
            st2, out = _DEMODS["psk"](cfg, per_t[t], st, ys[t])
            rec = {k: st2[k] for k in rec}
            for key, v in out.items():
                outs.setdefault(key, []).append(v)
        cs.update(rec)
    else:
        # raw, and psk with handoff="replica": every time shard runs
        # from the carried state; the last shard's state is carried (the
        # reference's documented deviation for recurrent loops, exact
        # with n_time == 1)
        last = None
        for t, dev in enumerate(devs):
            st = {k: _tree(v, lambda x, d=dev: x.to(d))
                  for k, v in st0.items() if k not in _REPLICATED}
            last, out = _DEMODS[cfg.demod](cfg, per_t[t], st, ys[t])
            for key, v in out.items():
                outs.setdefault(key, []).append(v)
        for key in _RECURRENT:
            if key in last:
                cs[key] = last[key]
    return outs, cs


def shard_pipeline(cfg: PipelineConfig, mesh: Mesh,
                   handoff: str = "replica"):
    """``make(consts, state)`` → a step ``(consts, state, x) → (state,
    outputs)`` over ``mesh``, as the reference's.

    ``handoff`` is the cross-time-shard treatment of the recurrent psk
    state: "replica" (every time shard from the carried state) or
    "exact" (sequential hand-off, equal to n_time=1).  FM and AM are
    exact under either (halo, closed-form DC reshard)."""
    if handoff not in ("replica", "exact"):
        raise ValueError(f"handoff must be 'replica' or 'exact', got "
                         f"{handoff!r}")

    def make(consts, state):
        def step(consts, state, x):
            return sharded_pipeline_step(cfg, mesh, consts, state, x,
                                         handoff=handoff)
        return step

    return make


def _demod_output_keys(cfg: PipelineConfig):
    return {"fm": ["audio"], "am": ["audio"],
            "psk": ["symbols", "strobes"], "raw": ["iq"]}[cfg.demod]
