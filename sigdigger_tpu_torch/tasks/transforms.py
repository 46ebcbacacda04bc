"""Block-transform tasks over captured IQ arrays (counterpart of
``sigdigger_tpu/tasks/transforms.py``).

One class per reference task (reference Tasks/): LPFTask, AGCTask,
QuadDemodTask, DelayedConjTask, CostasRecoveryTask, PLLSyncTask,
HistogramFeeder — all are CancellableTasks processing 4096/8192-sample
blocks with progress, mirroring the originals' block structure.  The
math runs on the port's class-path primitives (``dsp/agc.py``,
``filters.py``, ``pll.py``, ``quad.py``) on ``cuda`` unless ``device``
says otherwise; each block goes to the device and its output comes back
as numpy, as the reference's tasks take and give numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.dsp.agc import AGC, AGCParams
from sigdigger_tpu_torch.dsp.filters import FirFilter, fir_lowpass
from sigdigger_tpu_torch.dsp.pll import PLL, CostasLoop
from sigdigger_tpu_torch.dsp.quad import QuadDemod
from sigdigger_tpu_torch.tasks.base import CancellableTask

_BLOCK = 4096      # reference Tasks/AGCTask.cpp:30
_BLOCK_LPF = 8192  # reference Tasks/LPFTask.cpp:22


class _BlockTask(CancellableTask):
    """Shared scaffolding: stream self.data through _process(block)."""

    block = _BLOCK

    def __init__(self, data: np.ndarray) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.out = None
        self._pos = 0
        self._chunks: list[np.ndarray] = []

    def _process(self, block: np.ndarray):
        raise NotImplementedError

    def work(self) -> bool:
        end = min(self._pos + self.block, len(self.data))
        y = self._process(self.data[self._pos:end])
        if isinstance(y, torch.Tensor):
            y = y.cpu().numpy()
        self._chunks.append(y)
        self._pos = end
        self.set_progress(end / max(len(self.data), 1))
        if end >= len(self.data):
            self.result = self.out = np.concatenate(self._chunks) \
                if self._chunks else np.zeros(0, np.complex64)
            return False
        return True


class LPFTask(_BlockTask):
    """Low-pass filter at ``bandwidth`` (Hz) without decimation
    (reference Tasks/LPFTask.cpp:44-111; a direct FIR keeps the same
    contract: same rate out, zero-flush tail)."""

    block = _BLOCK_LPF

    def __init__(self, data: np.ndarray, sample_rate: float,
                 bandwidth: float, taps: int = 255, device=None) -> None:
        super().__init__(data)
        self.device = resolve_device(device)
        cutoff = min(1.0, bandwidth / sample_rate)  # /(fs/2) → *2/fs
        self._fir = FirFilter(fir_lowpass(taps, cutoff), channels=1,
                              device=self.device)

    def _process(self, block: np.ndarray):
        return self._fir(block[None, :])[0]


class AGCTask(_BlockTask):
    """reference Tasks/AGCTask.cpp:22-71 (tau in samples)."""

    def __init__(self, data: np.ndarray, tau: float = 100.0,
                 device=None) -> None:
        super().__init__(data)
        self.device = resolve_device(device)
        self._agc = AGC(1, AGCParams(tau=tau), device=self.device)

    def _process(self, block: np.ndarray):
        return self._agc(block[None, :])[0]


class QuadDemodTask(_BlockTask):
    """reference Tasks/QuadDemodTask.cpp:50-60 — output is real
    (1/pi)·arg(x[n]·conj(x[n-1])) stored in the I rail."""

    def __init__(self, data: np.ndarray, device=None) -> None:
        super().__init__(data)
        self.device = resolve_device(device)
        self._quad = QuadDemod(1, device=self.device)

    def _process(self, block: np.ndarray):
        return self._quad(block[None, :])[0].to(torch.complex64)


class DelayedConjTask(_BlockTask):
    """Cyclostationary transform x[n]·conj(x[n-tau]) (reference
    Tasks/DelayedConjTask.cpp; used for baud detection).  Host numpy, as
    in the reference."""

    def __init__(self, data: np.ndarray, delay: int = 1) -> None:
        super().__init__(data)
        self.delay = int(delay)
        self._hist = np.zeros(self.delay, np.complex64)

    def _process(self, block: np.ndarray) -> np.ndarray:
        ext = np.concatenate([self._hist, block])
        self._hist = ext[-self.delay:].copy()
        return (ext[self.delay:] * np.conj(ext[:-self.delay])).astype(
            np.complex64)


class CostasRecoveryTask(_BlockTask):
    """reference Tasks/CostasRecoveryTask.cpp:26-60: arm filter +
    Costas loop over the selection."""

    def __init__(self, data: np.ndarray, sample_rate: float,
                 arm_bw: float, loop_bw: float, order: int = 2,
                 device=None) -> None:
        super().__init__(data)
        self.device = resolve_device(device)
        cutoff = min(1.0, 2.0 * arm_bw / sample_rate)
        self._arm = FirFilter(fir_lowpass(63, cutoff), channels=1,
                              device=self.device)
        self._loop = CostasLoop(1, loop_bw=loop_bw / sample_rate,
                                order=order, device=self.device)

    def _process(self, block: np.ndarray):
        return self._loop(self._arm(block[None, :]))[0]


class PLLSyncTask(_BlockTask):
    """reference Tasks/PLLSyncTask.cpp:24-58."""

    def __init__(self, data: np.ndarray, sample_rate: float,
                 loop_bw: float, device=None) -> None:
        super().__init__(data)
        self.device = resolve_device(device)
        self._pll = PLL(1, loop_bw=loop_bw / sample_rate, device=self.device)

    def _process(self, block: np.ndarray):
        return self._pll(block[None, :])[0]


class HistogramFeeder(CancellableTask):
    """Per-sample histogram over a decision space (reference
    Tasks/HistogramFeeder.cpp:36-87).  Host numpy, as in the reference."""

    def __init__(self, data: np.ndarray, space: str = "amplitude",
                 bins: int = 256, limits: tuple[float, float] | None = None
                 ) -> None:
        super().__init__()
        self.data = np.asarray(data, np.complex64)
        self.space = space
        self.bins = bins
        self.limits = limits
        self.hist = np.zeros(bins, np.int64)
        self._pos = 0
        self._prev = 0.0 + 0.0j

    def _soft(self, block: np.ndarray) -> np.ndarray:
        if self.space == "amplitude":
            return np.abs(block)
        if self.space == "phase":
            return np.angle(block)
        if self.space == "frequency":
            ext = np.concatenate([[self._prev], block])
            self._prev = block[-1]
            return np.angle(ext[1:] * np.conj(ext[:-1]))
        raise ValueError(f"unknown decision space {self.space}")

    def work(self) -> bool:
        end = min(self._pos + _BLOCK, len(self.data))
        v = self._soft(self.data[self._pos:end])
        if self.limits is None:
            self.limits = ((-np.pi, np.pi) if self.space != "amplitude"
                           else (0.0, float(np.abs(self.data).max()) + 1e-9))
        h, _ = np.histogram(v, bins=self.bins, range=self.limits)
        self.hist += h
        self._pos = end
        self.set_progress(end / len(self.data))
        if end >= len(self.data):
            self.result = self.hist
            return False
        return True
