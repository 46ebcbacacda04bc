"""Time-sharded kernel banks over a ("time", "ch") mesh (counterpart of
``sigdigger_tpu/parallel/timebanks.py``).

Each bank runs on a contiguous time slice of the block per "time" row
of the mesh and on a channel block per "ch" column, one launch per mesh
cell, driven by this process (``parallel/banks.py``).  One mechanism
per recurrence structure, as in the reference:

- **RawBank — stateless split.**  Window rows and rotator-phase tiles
  split on "time", the per-channel constants on "ch"; the block power
  is the mean of the time shards' means.
- **AudioBank — input halos.**  Each time shard's windows are extended
  LEFT by ``halo`` rows (whole time tiles) and the first
  ``halo / audio_decim`` audio rows are dropped, so the discriminator
  and both FIRs see their full context: FM and RAW are exact.  The
  squelch power EMA and the AM DC follower are linear in their carried
  state: with ``exact=True`` pass A runs every shard from zero seeds,
  a scan in shard order turns those contributions into each shard's
  true seeds, and pass B injects them at the shard's first real tile
  (``AudioBankConfig.seed_tile``) — two launches per cell.  With the
  AGC on, halo rows still see halo-depth gain context inside the FIR
  window (the reference's documented residual).  Shard 0's halo is the
  previous block's last windows, kept on the host.
- **RecoveryBank — exact hand-off.**  The carrier, clock and CMA loops
  are per-sample recurrences: time shard s runs from shard s−1's final
  state.  The reference runs every shard on every turn and keeps shard
  s's outputs on turn s; running each shard once, in order, gives the
  same result with n_time launches per channel block instead of n².
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.kernels import audio, rawbank, recovery
from sigdigger_tpu_torch.kernels.audio import (
    PARAM_ROWS,
    AudioBankConfig,
    AudioParams,
    _band_matrix,
    _dc_matrices,
)
from sigdigger_tpu_torch.kernels.rawbank import RawParams
from sigdigger_tpu_torch.parallel.banks import (
    AUDIO_COLS,
    ColumnShards,
    Mesh,
    _derive_bmat,
    default_devices,
)

_TWO_PI = 2.0 * np.pi
_SQA = PARAM_ROWS.index("sqa")


def make_time_ch_mesh(n_time: int, n_ch: int, devices=None) -> Mesh:
    """A ("time", "ch") mesh over ``n_time * n_ch`` devices: every
    visible card by default; an explicit list may repeat a device."""
    devices = list(devices if devices is not None else default_devices())
    if len(devices) < n_time * n_ch:
        raise ValueError(
            f"need {n_time * n_ch} devices, have {len(devices)}")
    grid = np.empty(n_time * n_ch, dtype=object)
    grid[:] = devices[:n_time * n_ch]
    return Mesh(grid.reshape(n_time, n_ch), axis_names=("time", "ch"))


def _div_le(n: int, limit: int, multiple_of: int = 1) -> int:
    d = min(n, limit)
    d -= d % multiple_of
    while d >= multiple_of and n % d:
        d -= multiple_of
    if d < multiple_of:
        raise ValueError(f"no divisor of {n} ≤ {limit} that is a "
                         f"multiple of {multiple_of}")
    return d


def _phase_rows(base: np.ndarray, rate: np.ndarray, row0: np.ndarray,
                per_tile: int, tiles_per_shard: int) -> np.ndarray:
    """Per-tile start phases of every time shard, float64-built, mod 2π:
    shard s tile t starts at absolute row ``row0[s] + t*per_tile``.
    ``[n_time, tiles_per_shard, C]`` float32 (the reference keeps the
    same rows 8 apart)."""
    t = np.arange(tiles_per_shard, dtype=np.float64)[:, None]
    out = [np.mod(base[None, :] + (r + t * per_tile) * rate[None, :],
                  _TWO_PI) for r in row0]
    return np.stack(out).astype(np.float32)


class _Cells:
    """The mesh's cells with the channel blocks of a bank's constants."""

    def __init__(self, mesh: Mesh, n_channels: int, col_keys,
                 derive=None) -> None:
        self.n_t, self.n_c = mesh.shape["time"], mesh.shape["ch"]
        self.devices = mesh.devices
        self.shards = ColumnShards(n_channels, self.n_c, col_keys, derive)
        self.local_c = self.shards.local_c

    def consts(self, consts: dict, t: int, c: int) -> dict:
        return self.shards.consts(consts, c, self.devices[t, c])

    def cols(self, v: torch.Tensor, t: int, c: int) -> torch.Tensor:
        return self.shards.cols(v, c, self.devices[t, c])


def _grid(parts, home) -> torch.Tensor:
    """``parts[t][c]`` joined: time shards on rows, channel blocks on
    columns, on ``home``."""
    return torch.cat([torch.cat([p.to(home) for p in row], dim=1)
                      for row in parts])


def _cols(parts, home) -> torch.Tensor:
    return torch.cat([p.to(home) for p in parts], dim=1)


class TimeShardedRawBank:
    """RawBank over a ("time", "ch") mesh — stateless row split."""

    def __init__(self, bank, mesh: Mesh) -> None:
        self.bank = bank
        self.mesh = mesh
        cfg = bank.cfg
        n_t = mesh.shape["time"]
        self.n_t = n_t
        if cfg.block_out % n_t:
            raise ValueError(
                f"block_out {cfg.block_out} not divisible by time-mesh "
                f"size {n_t}")
        self.local_m = cfg.block_out // n_t
        self.mt = _div_le(self.local_m, cfg.m_tile)
        self.params = RawParams(mt=self.mt, in_gain=bank.params.in_gain)
        self._cells = _Cells(mesh, cfg.n_channels, ("h_re", "h_im", "theta"),
                             _derive_bmat)

    def _phi_tiles(self) -> np.ndarray:
        b = self.bank
        row0 = np.arange(self.n_t, dtype=np.float64) * self.local_m
        return _phase_rows(b._phi, b._theta64, row0, self.mt,
                           self.local_m // self.mt)

    def feed(self, x: np.ndarray, fetch: bool = True):
        b = self.bank
        cfg = b.cfg
        cells = self._cells
        xw_re, xw_im = b.frame(x)
        phi = torch.from_numpy(self._phi_tiles())
        lm = self.local_m
        planes, powers = [], []
        for t in range(self.n_t):
            rows, pw = [], []
            for c in range(cells.n_c):
                dev = cells.devices[t, c]
                k = cells.consts(b.consts, t, c)
                y_re, y_im, power = rawbank.raw_kernel(
                    torch.from_numpy(xw_re[t * lm:(t + 1) * lm]).to(dev),
                    torch.from_numpy(xw_im[t * lm:(t + 1) * lm]).to(dev),
                    k["h_re"], k["h_im"], k["theta"],
                    cells.cols(phi[t], t, c), self.params, k["bmat"])
                rows.append((y_re, y_im))
                pw.append(power)
            planes.append(rows)
            powers.append(_cols(pw, b.device))
        y_re = _grid([[p[0] for p in row] for row in planes], b.device)
        y_im = _grid([[p[1] for p in row] for row in planes], b.device)
        power = powers[0]
        for p in powers[1:]:
            power = power + p
        b._phi = np.mod(b._phi + b._theta64 * cfg.block_out, _TWO_PI)
        b._power_dev = power / self.n_t
        b._power_host = None
        if fetch:
            return y_re.cpu().numpy(), y_im.cpu().numpy()
        return y_re, y_im

    @property
    def block_power(self) -> np.ndarray:
        return self.bank.block_power


class TimeShardedAudioBank:
    """AudioBank over a ("time", "ch") mesh — input-halo overlap-save.

    ``halo`` window rows of left context per shard (by default the
    discriminator and both FIR depths, which makes FM and RAW exact),
    rounded up to whole time tiles.  ``exact=True`` reshards the squelch
    EMA and the AM DC follower exactly with two passes (module
    docstring); the squelch decisions, block power and AM with the AGC
    off then equal the single-device stream when the tile cadence
    matches.
    """

    def __init__(self, bank, mesh: Mesh, halo: int | None = None,
                 exact: bool = True) -> None:
        self.bank = bank
        self.mesh = mesh
        self.exact = exact
        cfg = bank.cfg
        n_t = mesh.shape["time"]
        self.n_t = n_t
        if cfg.block_out % (n_t * cfg.audio_decim):
            raise ValueError(
                f"block_out {cfg.block_out} not divisible by "
                f"n_time*audio_decim = {n_t}*{cfg.audio_decim}")
        local_m = cfg.block_out // n_t
        self.local_m = local_m
        self.mt = _div_le(local_m, cfg.m_tile, multiple_of=cfg.audio_decim)
        if halo is None:
            halo = cfg.audio_taps + cfg.audio_fir_taps * cfg.audio_decim
        # whole time tiles: the seeds inject exactly at the first real
        # tile, and the trim stays audio_decim-aligned
        halo += (-halo) % self.mt
        self.halo = halo
        self.seed_tile = halo // self.mt if exact else 0
        self._cells = _Cells(mesh, cfg.n_channels, AUDIO_COLS)
        lc = self._cells.local_c
        local_cfg = AudioBankConfig(
            sample_rate=cfg.sample_rate, n_channels=lc, taps=cfg.taps,
            decimation=cfg.decimation, audio_taps=cfg.audio_taps,
            audio_decim=cfg.audio_decim,
            audio_fir_taps=cfg.audio_fir_taps, block_out=local_m + halo,
            m_tile=self.mt, quad_gain=cfg.quad_gain, dc_alpha=cfg.dc_alpha,
            sq_alpha=cfg.sq_alpha, enable_ssb=cfg.enable_ssb,
            in_scale=cfg.in_scale, hang_agc=cfg.hang_agc,
            seed_tile=self.seed_tile)
        self.params = AudioParams.of(local_cfg)
        self._trim = halo // cfg.audio_decim
        # the local geometry's band matrix, its taps and DC matrices
        bt = _band_matrix(local_cfg.fir_tile, cfg.audio_taps,
                          cfg.audio_decim)
        tdc, dcpow = _dc_matrices(local_cfg)
        self._static = {
            "bt": torch.from_numpy(bt),
            "ataps": torch.from_numpy(bt[0, :cfg.audio_taps][::-1].copy()),
            "tdc": torch.from_numpy(tdc),
            "dcpow": torch.from_numpy(dcpow)}
        # per-shard EMA decay over the REAL region (the transitions are
        # linear: state_out = decay·state_in + contribution)
        self._real_tiles = local_m // self.mt
        beta_dc = float(cfg.dc_alpha) ** cfg.audio_decim
        self._decay_dc = np.float32(beta_dc ** (local_m // cfg.audio_decim))
        ka, ka2 = cfg.audio_taps, cfg.audio_fir_taps
        self._zero_rows = {"prev": 1, "ftail": ka - 1, "atail": ka2 - 1}
        # shard 0's halo = the previous block's last `halo` window rows
        self._halo_re = np.zeros((halo, cfg.taps), np.float32)
        self._halo_im = np.zeros((halo, cfg.taps), np.float32)

    def _stacked_frames(self, xw_re, xw_im):
        """Each time shard's haloed window rows ``[local_m + halo, K]``."""
        h, lm = self.halo, self.local_m
        ext_re = np.concatenate([self._halo_re, xw_re])
        ext_im = np.concatenate([self._halo_im, xw_im])
        parts = [(ext_re[s * lm:s * lm + h + lm],
                  ext_im[s * lm:s * lm + h + lm]) for s in range(self.n_t)]
        self._halo_re = xw_re[-h:].copy()
        self._halo_im = xw_im[-h:].copy()
        return parts

    def _phases(self):
        b = self.bank
        da = b.cfg.audio_decim
        tiles = (self.local_m + self.halo) // self.mt
        row0 = (np.arange(self.n_t, dtype=np.float64) * self.local_m
                - self.halo)
        phi0 = _phase_rows(b._phi, b._theta64, row0, self.mt, tiles)
        phs0 = _phase_rows(b._phs_a, b._omega_a64, row0 / da,
                           self.mt // da, tiles)
        return torch.from_numpy(phi0), torch.from_numpy(phs0)

    def _consts(self, t: int, c: int) -> dict:
        k = dict(self._cells.consts(self.bank.consts, t, c))
        dev = self._cells.devices[t, c]
        k.update({n: v.to(dev) for n, v in self._static.items()})
        return k

    def feed(self, x: np.ndarray, fetch: bool = True):
        b = self.bank
        cfg = b.cfg
        cells = self._cells
        n_t, n_c, lc = self.n_t, cells.n_c, cells.local_c
        frames = self._stacked_frames(*b.frame(x))
        phi0, phs0 = self._phases()
        home = b.device
        sq0 = torch.as_tensor(b._sq).to(home)
        dc0 = torch.as_tensor(b._dc).to(home)
        agcs = torch.as_tensor(b._agcs).to(home)
        cell = {}
        for t in range(n_t):
            for c in range(n_c):
                dev = cells.devices[t, c]

                def zeros(rows, dev=dev):
                    return torch.zeros((rows, lc), device=dev)

                z = self._zero_rows
                cell[t, c] = dict(
                    xr=torch.from_numpy(frames[t][0]).to(dev),
                    xi=torch.from_numpy(frames[t][1]).to(dev),
                    consts=self._consts(t, c),
                    head=(zeros(z["prev"]), zeros(z["prev"]),
                          zeros(z["ftail"]), zeros(z["ftail"]),
                          zeros(z["atail"]), zeros(z["atail"])),
                    agcs=cells.cols(agcs, t, c),
                    phi0=cells.cols(phi0[t], t, c),
                    phs0=cells.cols(phs0[t], t, c))

        def run(t, c, sq, dc):
            k = cell[t, c]
            dev = cells.devices[t, c]
            return audio.audio_kernel(
                k["xr"], k["xi"], k["consts"],
                k["head"] + (sq.to(dev), dc.to(dev), k["agcs"]),
                k["phi0"], k["phs0"], self.params)

        # the seeds of each cell: the carries for all when not exact
        seeds = {(t, c): (cells.cols(sq0, 0, c), cells.cols(dc0, 0, c))
                 for t in range(n_t) for c in range(n_c)}
        if self.exact and n_t > 1:
            for c in range(n_c):
                dev = cells.devices[0, c]
                zero = torch.zeros((1, lc), device=dev)
                # pass A: zero seeds → each shard's transition terms
                b_terms = [run(t, c, zero, zero) for t in range(n_t)]
                sqa = cells.consts(b.consts, 0, c)["params"][_SQA:_SQA + 1]
                decay_sq = (1.0 - sqa) ** self._real_tiles
                decay_dc = torch.tensor(self._decay_dc, device=dev)
                run_sq, run_dc = seeds[0, c]
                for s in range(1, n_t):
                    run_sq = decay_sq * run_sq + b_terms[s - 1][7].to(dev)
                    run_dc = decay_dc * run_dc + b_terms[s - 1][8].to(dev)
                    seeds[s, c] = (run_sq, run_dc)
        outs = {(t, c): run(t, c, *seeds[t, c])
                for t in range(n_t) for c in range(n_c)}
        trim = self._trim
        audio_out = _grid([[outs[t, c][0][trim:] for c in range(n_c)]
                           for t in range(n_t)], home)
        last = [outs[n_t - 1, c] for c in range(n_c)]
        b._sq = _cols([o[7] for o in last], home)
        b._dc = _cols([o[8] for o in last], home)
        b._agcs = _cols([o[10] for o in last], home)
        power = _cols([outs[0, c][9] for c in range(n_c)], home)
        for t in range(1, n_t):
            power = power + _cols([outs[t, c][9] for c in range(n_c)], home)
        b._sq_host = None
        b._power_dev = power / n_t
        b._power_host = None
        b._phi = np.mod(b._phi + b._theta64 * cfg.block_out, _TWO_PI)
        b._phs_a = np.mod(b._phs_a + b._omega_a64 * cfg.audio_out, _TWO_PI)
        return audio_out.cpu().numpy() if fetch else audio_out

    def squelch_open(self) -> np.ndarray:
        return self.bank.squelch_open()


class TimeShardedRecoveryBank:
    """RecoveryBank over a ("time", "ch") mesh — exact hand-off."""

    def __init__(self, bank, mesh: Mesh) -> None:
        self.bank = bank
        self.mesh = mesh
        cfg = bank.cfg
        n_t = mesh.shape["time"]
        self.n_t = n_t
        if cfg.block_len % n_t:
            raise ValueError(
                f"block_len {cfg.block_len} not divisible by "
                f"time-mesh size {n_t}")
        self.local_m = cfg.block_len // n_t
        self._cells = _Cells(mesh, cfg.n_channels, ("params", "mf"))

    def feed_planes(self, y_re, y_im, fetch: bool = True):
        b = self.bank
        cells = self._cells
        home = b.device
        y_re = torch.as_tensor(y_re).to(home)
        y_im = torch.as_tensor(y_im).to(home)
        state = torch.as_tensor(b.state).to(home)
        lm = self.local_m
        parts, states = [], []
        for c in range(cells.n_c):
            st = cells.cols(state, 0, c)
            col = []
            for t in range(self.n_t):
                dev = cells.devices[t, c]
                k = cells.consts(b.consts, t, c)
                rows = slice(t * lm, (t + 1) * lm)
                sr, si, sb, st = recovery.recovery_kernel(
                    cells.cols(y_re[rows], t, c),
                    cells.cols(y_im[rows], t, c), st.to(dev),
                    k["params"], k["mf"], b.params)
                col.append((sr, si, sb))
            parts.append(col)
            states.append(st)
        sr, si, strobe = (
            torch.cat([torch.cat([parts[c][t][i].to(home)
                                  for c in range(cells.n_c)], dim=1)
                       for t in range(self.n_t)]) for i in range(3))
        b.state = _cols(states, home)
        if not fetch:
            return sr, si, strobe
        return (torch.complex(sr, si).cpu().numpy(),
                (strobe > 0.5).cpu().numpy())
