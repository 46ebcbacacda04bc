"""The benchmark's one traffic generator: a traffic file's parameters and
a seed in, a ring of IQ blocks out.

A band is a sum of FM carriers (a sinusoidal tone each, at the traffic's
deviation), pure carriers and complex white noise, each carrier on a
channel's requested centre.  The phases are closed forms of the sample
index, so the ring's blocks join without a seam except where the ring
wraps.  The carriers and the noise are computed on ``device`` (a
``torch.Generator`` there for the noise), in float64 for the phases, and
the ring is handed back in host memory as complex64, where a front end
would deliver it.  The same seed gives the same ring on the same kind of
device; the set of carriers and the block sizes never depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

# carriers summed in one pass: [CHUNK, block_in] float64 temporaries
CHUNK = 32


def channel_freqs(cfg: dict) -> np.ndarray:
    """The configuration's requested channel centres, Hz."""
    return np.linspace(cfg["f0_lo_hz"], cfg["f0_hi_hz"], cfg["n_channels"])


def block_in(cfg: dict) -> int:
    return cfg["block_out"] * cfg["decimation"]


def carriers(cfg: dict, wl: dict, seed: int) -> dict[str, np.ndarray]:
    """Each carrier's frequency, amplitude, FM index, tone, tone phase
    and start phase (the tones and phases drawn from ``seed``)."""
    f0s = channel_freqs(cfg)
    fm = wl["fm"]
    chans = np.arange(fm["first_channel"], cfg["n_channels"], fm["every"])
    rng = np.random.default_rng(seed)
    tone = rng.uniform(fm["tone_lo_hz"], fm["tone_hi_hz"], len(chans))
    psi = rng.uniform(0.0, 2 * np.pi, len(chans))
    phi = rng.uniform(0.0, 2 * np.pi, len(chans) + len(wl["carriers"]))
    pure = np.array([c["channel"] for c in wl["carriers"]], int)
    return {
        "channel": np.concatenate([chans, pure]),
        "freq": np.concatenate([f0s[chans], f0s[pure]]),
        "amp": np.concatenate([np.full(len(chans), fm["amplitude"]),
                               [c["amplitude"] for c in wl["carriers"]]]),
        "beta": np.concatenate([fm["deviation_hz"] / tone,
                                np.zeros(len(pure))]),
        "tone": np.concatenate([tone, np.zeros(len(pure))]),
        "psi": np.concatenate([psi, np.zeros(len(pure))]),
        "phi": phi,
    }


def make_ring(cfg: dict, wl: dict, seed: int,
              device: str | torch.device) -> np.ndarray:
    """``[ring_blocks, block_in]`` complex64 in host memory."""
    dev = torch.device(device)
    n = block_in(cfg)
    fs = float(cfg["sample_rate"])
    car = carriers(cfg, wl, seed)
    par = {k: torch.as_tensor(v, dtype=torch.float64, device=dev)[:, None]
           for k, v in car.items() if k != "channel"}
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    ring = torch.empty((wl["ring_blocks"], n), dtype=torch.complex64,
                       device=dev)
    idx = torch.arange(n, dtype=torch.float64, device=dev)
    two_pi = 2.0 * np.pi
    for b in range(wl["ring_blocks"]):
        t = ((b * n) + idx)[None, :] / fs
        re = torch.zeros(n, dtype=torch.float64, device=dev)
        im = torch.zeros(n, dtype=torch.float64, device=dev)
        for s in range(0, par["freq"].shape[0], CHUNK):
            p = {k: v[s:s + CHUNK] for k, v in par.items()}
            ph = (torch.remainder(p["freq"] * t, 1.0) * two_pi
                  + p["beta"] * torch.sin(two_pi * p["tone"] * t + p["psi"])
                  + p["phi"])
            re += (p["amp"] * torch.cos(ph)).sum(0)
            im += (p["amp"] * torch.sin(ph)).sum(0)
        noise = torch.randn((2, n), generator=gen, device=dev,
                            dtype=torch.float32) * wl["noise_sigma"]
        ring[b] = torch.complex(re.float() + noise[0], im.float() + noise[1])
    out = ring.cpu().numpy()
    del ring
    return out
