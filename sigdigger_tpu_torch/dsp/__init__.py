"""DSP modules of the port (counterpart of ``sigdigger_tpu/dsp``): the
host-side design helpers (numpy, float64-built: ``filters``, ``window``,
``pll.loop_gains``, ``iir``, ``snr``), the class path's streaming stages
on torch tensors (``ncqo``, ``quad``, ``filters``' FIR application,
``resample``, ``agc``, ``pll``, ``clock``, ``decider``, ``equalizer``,
``spectrum``, ``channelizer``), and the analog TV processor (``tv``).
Exports the reference's names."""

from sigdigger_tpu_torch.dsp.agc import AGC, AGCParams
from sigdigger_tpu_torch.dsp.channelizer import Channelizer
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
    symbols_to_bits,
)
from sigdigger_tpu_torch.dsp.filters import (
    FirFilter,
    fir_apply,
    fir_lowpass,
    rrc_taps,
)
from sigdigger_tpu_torch.dsp.iir import IIRFilter, butterworth_sos, notch_sos
from sigdigger_tpu_torch.dsp.ncqo import NCQO, mix_frequency
from sigdigger_tpu_torch.dsp.pll import PLL, CostasLoop, loop_gains
from sigdigger_tpu_torch.dsp.quad import QuadDemod, quad_demod
from sigdigger_tpu_torch.dsp.resample import Resampler
from sigdigger_tpu_torch.dsp.spectrum import SpectrumEstimator, psd_frequencies
from sigdigger_tpu_torch.dsp.window import window_energy, window_taps

__all__ = [
    "AGC",
    "AGCParams",
    "Channelizer",
    "CostasLoop",
    "DecisionSpace",
    "FirFilter",
    "IIRFilter",
    "butterworth_sos",
    "notch_sos",
    "GardnerClock",
    "NCQO",
    "PLL",
    "QuadDemod",
    "Resampler",
    "SpectrumEstimator",
    "decide_amplitude",
    "decide_frequency",
    "decide_interval",
    "decide_phase",
    "fir_apply",
    "fir_lowpass",
    "loop_gains",
    "manual_sample",
    "mix_frequency",
    "psd_frequencies",
    "quad_demod",
    "rrc_taps",
    "symbols_to_bits",
    "window_energy",
    "window_taps",
    "zero_crossing_sample",
]
