"""WaveSampler — offline symbol extraction over a capture selection
(counterpart of ``sigdigger_tpu/tasks/sampler.py``).

reference Tasks/WaveSampler.cpp:97-333 with include/SamplingProperties.h:
26-52: three sync modes (MANUAL interval averaging, GARDNER closed-loop
incl. inline quad demod for FSK, ZERO_CROSSING threshold slicing) over a
decision space (AMPLITUDE / PHASE / FREQUENCY), emitting sample sets the
Decider then maps to symbol ids.  The projection, the MANUAL averaging,
the Gardner clock and the decisions run on the port's ``dsp`` on
``cuda`` unless ``device`` says otherwise; the ZERO_CROSSING slicer is
host numpy, as in the reference.  The sets hold numpy arrays.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.clock import (
    GardnerClock,
    manual_sample,
    zero_crossing_sample,
)
from sigdigger_tpu_torch.dsp.decider import (
    DecisionSpace,
    decide_amplitude,
    decide_frequency,
    decide_interval,
    decide_phase,
)
from sigdigger_tpu_torch.dsp.quad import quad_demod
from sigdigger_tpu_torch.tasks.base import CancellableTask


class SyncMode(enum.Enum):
    MANUAL = "manual"
    GARDNER = "gardner"
    ZERO_CROSSING = "zero-crossing"


@dataclass
class SamplingProperties:
    """reference include/SamplingProperties.h:26-52."""

    mode: SyncMode = SyncMode.MANUAL
    space: DecisionSpace = DecisionSpace.AMPLITUDE
    baud: float = 9600.0
    sample_rate: float = 1_000_000.0
    bits_per_symbol: int = 1
    loop_gain: float = 0.05
    sampling_phase: float = 0.0   # MANUAL mode start offset [samples]
    threshold: float = 0.0        # ZERO_CROSSING slicer level


@dataclass
class WaveSampleSet:
    """One emitted batch (reference WaveSampler emits SampleSets)."""

    soft: np.ndarray      # soft decision values
    symbols: np.ndarray   # decided symbol ids


class WaveSampler(CancellableTask):
    def __init__(self, data: np.ndarray, props: SamplingProperties,
                 device=None) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.props = props
        self.device = resolve_device(device)
        self.sets: list[WaveSampleSet] = []
        self._done = False

    # -- decision space projection -------------------------------------
    def _soft_signal(self) -> torch.Tensor:
        x = torch.as_tensor(self.data).to(self.device)
        if self.props.space in (DecisionSpace.AMPLITUDE,
                                DecisionSpace.PHASE):
            return x  # complex kept; decided on |.| later
        # FREQUENCY: inline quad demod (reference WaveSampler does the
        # same for FSK in Gardner mode, Tasks/WaveSampler.cpp:192-205)
        return quad_demod(x, gain=1.0).to(torch.complex64)

    def _decide(self, soft: torch.Tensor) -> torch.Tensor:
        p = self.props
        if p.space == DecisionSpace.PHASE:
            return decide_phase(soft, p.bits_per_symbol)
        if p.space == DecisionSpace.AMPLITUDE:
            return decide_amplitude(torch.abs(soft), p.bits_per_symbol)
        return decide_frequency(torch.real(soft), p.bits_per_symbol)

    def work(self) -> bool:
        p = self.props
        sps = p.sample_rate / p.baud
        soft_sig = self._soft_signal()

        if p.mode == SyncMode.MANUAL:
            soft = manual_sample(soft_sig, sps, p.sampling_phase)
        elif p.mode == SyncMode.GARDNER:
            if sps < 2.0:
                raise ValueError("GARDNER needs >=2 samples/symbol")
            clk = GardnerClock(1, sps=sps, gain=p.loop_gain,
                               device=self.device)
            sym, strobes = clk(soft_sig[None, :])
            soft = sym[0][strobes[0]]
        else:  # ZERO_CROSSING — real soft values
            base = (torch.abs(soft_sig)
                    if p.space == DecisionSpace.AMPLITUDE
                    else torch.real(soft_sig))
            vals = zero_crossing_sample(base, sps, p.threshold)
            # slicer output is already bipolar around the threshold
            ids = decide_interval(
                vals, float(vals.min() - 1e-9), float(vals.max() + 1e-9),
                p.bits_per_symbol).numpy()
            self.sets.append(WaveSampleSet(soft=vals, symbols=ids))
            self.result = self.sets
            self.set_progress(1.0, "done")
            return False

        ids = self._decide(soft)
        self.sets.append(WaveSampleSet(soft=soft.cpu().numpy(),
                                       symbols=ids.cpu().numpy()))
        self.result = self.sets
        self.set_progress(1.0, "done")
        return False
