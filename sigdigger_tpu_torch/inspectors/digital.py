"""The "psk", "fsk" and "ask" digital inspector classes (counterpart of
``sigdigger_tpu/inspectors/digital.py``).

Chain structure mirrors the engine-side inspectors the reference
configures through the InspectorCtl panels (reference
Default/GenericInspector/InspectorCtl/*.cpp):

- psk: AGC → Costas carrier recovery (afc.*) → RRC matched filter
  (mf.*) → CMA equalizer (equalizer.*) → clock recovery (clock.*) →
  complex soft symbols.
- fsk: quadrature discriminator (fsk.*) → matched filter → clock
  recovery → frequency soft values.
- ask: AGC → optional PLL (ask.use-pll) → envelope → matched filter →
  clock recovery → amplitude soft values.

Every block returns dense [C, T'] soft streams plus a strobe mask
marking recovered symbols (compact with ``samples[strobes]``), decided
symbol ids in the chain's decision space, and for psk the Costas loop's
frequency estimate: tensors on the inspector's device.  The AGC,
Costas and Gardner stages are per-sample step loops on the device; the
CMA equalizer launches ``csrc/cma.cu`` on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sigdigger_tpu_torch.dsp.agc import AGC, AGCParams
from sigdigger_tpu_torch.dsp.clock import GardnerClock, manual_sample
from sigdigger_tpu_torch.dsp.decider import (
    decide_amplitude,
    decide_frequency,
    decide_phase,
)
from sigdigger_tpu_torch.dsp.equalizer import CMAEqualizer
from sigdigger_tpu_torch.dsp.filters import FirFilter, rrc_taps
from sigdigger_tpu_torch.dsp.pll import PLL, CostasLoop
from sigdigger_tpu_torch.dsp.quad import QuadDemod
from sigdigger_tpu_torch.inspectors.base import Inspector, register_inspector

CLOCK_MANUAL = 0
CLOCK_GARDNER = 1


class _DigitalBase(Inspector):
    """Shared clock-recovery plumbing for psk/fsk/ask."""

    def _build_clock(self) -> None:
        cfg = self.config
        self.baud = float(cfg["clock.baud"])
        self.sps = self.sample_rate / max(self.baud, 1e-9)
        self.clock_type = int(cfg["clock.type"])
        self.clock_running = bool(cfg["clock.running"])
        self._manual_phase = float(cfg["clock.phase"])
        if self.clock_type == CLOCK_GARDNER and self.sps >= 2.0:
            self._clock = GardnerClock(
                self.channels, sps=self.sps,
                gain=float(cfg["clock.gain"]), device=self.device)
        else:
            self._clock = None  # manual interval sampling

    def _build_mf(self) -> None:
        cfg = self.config
        if int(cfg["mf.type"]) == 1 and self.sps >= 2.0:
            # unit-energy taps: matched filtering preserves signal power,
            # keeping downstream loop gains amplitude-stable
            taps = rrc_taps(self.sps, span=6,
                            rolloff=float(cfg["mf.roll-off"]))
            self._mf = FirFilter(taps, self.channels, device=self.device)
        else:
            self._mf = None

    def _build_agc(self) -> None:
        cfg = self.config
        self._agc = (AGC(self.channels,
                         AGCParams(tau=cfg["agc.ts"] * self.sps),
                         device=self.device)
                     if cfg["agc.enabled"] else None)

    def _block(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        return x[None, :] if x.ndim == 1 else x

    def _recover_symbols(self, soft: torch.Tensor) -> tuple:
        """soft: [C, T] complex at sample rate → (dense symbols, strobe
        mask)."""
        if not self.clock_running:
            return soft, torch.ones(soft.shape, dtype=torch.bool,
                                    device=soft.device)
        if self._clock is not None:
            return self._clock(soft.to(torch.complex64))
        # manual: fixed-interval averaging; all outputs are symbols
        syms = manual_sample(soft.to(torch.complex64), self.sps,
                             self._manual_phase)
        return syms, torch.ones(syms.shape, dtype=torch.bool,
                                device=syms.device)


@register_inspector
class PskInspector(_DigitalBase):
    class_name = "psk"

    def _build(self) -> None:
        cfg = self.config
        self.bps = max(1, int(cfg["afc.bits-per-symbol"]))
        order = int(cfg["afc.costas-order"])
        if order not in (2, 4, 8):
            order = 1 << self.bps
        self.order = min(order, 8)
        self._build_clock()
        self._build_agc()
        self._costas = CostasLoop(self.channels,
                                  loop_bw=float(cfg["afc.loop-bw"]),
                                  order=self.order, device=self.device)
        self._build_mf()
        self._eq = (CMAEqualizer(self.channels,
                                 rate=float(cfg["equalizer.rate"]),
                                 locked=bool(cfg["equalizer.locked"]),
                                 device=self.device)
                    if int(cfg["equalizer.type"]) == 1 else None)

    def process(self, x) -> dict[str, Any]:
        x = self._block(x)
        y = self._agc(x) if self._agc is not None else x
        y = self._costas(y)
        if self._mf is not None:
            y = self._mf(y)
        if self._eq is not None:
            y = self._eq(y)
        syms, strobes = self._recover_symbols(y)
        # the Costas detector locks constellation points onto angles
        # 2*pi*k/M, so sector 0 is centered on angle 0
        ids = decide_phase(syms, self.bps, offset=0.0)
        return {"samples": syms, "strobes": strobes, "symbols": ids,
                "freq_offset": self._costas.frequency_estimate}


@register_inspector
class FskInspector(_DigitalBase):
    class_name = "fsk"

    def _build(self) -> None:
        cfg = self.config
        self.bps = max(1, int(cfg["fsk.bits-per-symbol"]))
        self.phase_off = float(cfg["fsk.phase"])
        self._build_clock()
        self._quad = QuadDemod(self.channels, gain=1.0 / np.pi,
                               device=self.device)
        self._build_mf()

    def process(self, x) -> dict[str, Any]:
        x = self._block(x)
        f = self._quad(x)                    # [-1, 1] normalized freq
        soft = f.to(torch.complex64)
        if self._mf is not None:
            soft = self._mf(soft)
        syms, strobes = self._recover_symbols(soft)
        ids = decide_frequency(syms.real, self.bps)
        return {"samples": syms, "strobes": strobes, "symbols": ids}


@register_inspector
class AskInspector(_DigitalBase):
    class_name = "ask"

    def _build(self) -> None:
        cfg = self.config
        self.bps = max(1, int(cfg["ask.bits-per-symbol"]))
        self.use_pll = bool(cfg["ask.use-pll"])
        self._build_clock()
        self._build_agc()
        self._pll = (PLL(self.channels, loop_bw=float(cfg["ask.loop-bw"]),
                         device=self.device)
                     if self.use_pll else None)
        self._build_mf()

    def process(self, x) -> dict[str, Any]:
        x = self._block(x)
        y = self._agc(x) if self._agc is not None else x
        if self._pll is not None:
            y = self._pll(y)
        env = torch.abs(y).to(torch.complex64)
        if self._mf is not None:
            env = self._mf(env)
        syms, strobes = self._recover_symbols(env)
        ids = decide_amplitude(syms.real, self.bps)
        return {"samples": syms, "strobes": strobes, "symbols": ids}
