"""CMA blind equalizer (counterpart of ``sigdigger_tpu/dsp/equalizer.py``).

The reference inspectors expose an `equalizer.{type,rate,locked}` config
(reference Default/GenericInspector/InspectorCtl/EqualizerControl.cpp):
type 0 = bypass, 1 = constant-modulus algorithm.  An N-tap complex FIR
adapted per symbol with the soft-clipped, power-normalized CMA error
e = y·(|y|² − 1); taps frozen when ``locked``.

The same math as the port's CMA bank, so an adapting
:class:`CMAEqualizer` runs on it: each call lays the block out as
``[T, C]`` float32 planes for ``kernels/equalizer.py::cma_kernel``
(``cma_apply``), which launches ``csrc/cma.cu`` on the card and runs
``cma_kernel_reference`` on the CPU.  The taps carry across calls and
the delay line restarts at each call, as the reference's ``_cma_scan``
does.  ``rate`` is the kernel's rate row.  The kernel is built for 5
taps: on the card any other count raises ``ValueError``, as the bank
does.

A locked equalizer launches no kernel: as the reference's locked scan
skips the update, it computes y = Σ_j taps_j·x[t − j] with the carried
taps over a fresh delay line (:func:`locked_fir`) and leaves the taps
untouched.  A zero gain would not do: past |y| ≈ 7e12 (or on an inf or
NaN sample) the error is not finite, 0·NaN is NaN, and the taps would
be lost for every later block.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels.equalizer import cma_apply, centre_taps


def locked_fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The locked equalizer's output: ``x`` complex64 [C, T] through the
    K-tap FIR ``taps`` [C, K] over a delay line that starts at zero,
    ``y[t] = sum(taps * buf)`` with ``buf[j] = x[t - j]`` (the
    reference's order)."""
    k = taps.shape[1]
    padded = torch.nn.functional.pad(x, (k - 1, 0))
    buf = padded.unfold(1, k, 1).flip(-1)            # [C, T, K]
    return (taps[:, None, :] * buf).sum(-1)


class CMAEqualizer:
    """Streaming CMA over [C, T] symbol-spaced blocks.  Runs on ``cuda``
    unless ``device`` says otherwise."""

    def __init__(self, channels: int, taps: int = 5,
                 rate: float = 1e-3, locked: bool = False,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.channels = channels
        self.n_taps = taps
        self.rate = float(rate)
        self.locked = bool(locked)
        self._rate = torch.full((channels,), self.rate, device=self.device)
        # the kernel's lock row: only an adapting equalizer launches it
        self._unlocked = torch.zeros(channels, device=self.device)
        self.reset()

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        if self.locked:
            y = locked_fir(x, self.taps)
        else:
            y, self.taps_re, self.taps_im = cma_apply(
                x, self.taps_re, self.taps_im, self._rate, self._unlocked)
        return y[0] if squeeze else y

    @property
    def taps(self) -> torch.Tensor:
        """The taps as the reference holds them: complex64 [C, K]."""
        return torch.complex(self.taps_re, self.taps_im).T

    def reset(self) -> None:
        self.taps_re, self.taps_im = centre_taps(self.n_taps, self.channels,
                                                 self.device)

    def state_dict(self) -> dict[str, np.ndarray]:
        """The taps, complex64 [C, K]."""
        return {"taps": self.taps.cpu().numpy()}

    def load_state(self, state: dict) -> None:
        """Continue from ``state_dict()`` or from a reference equalizer's
        ``taps`` (complex [C, K]) as a numpy array."""
        taps = np.asarray(state["taps"], np.complex64)
        if taps.shape != (self.channels, self.n_taps):
            raise ValueError(f"taps: want {(self.channels, self.n_taps)}, "
                             f"got {taps.shape}")
        self.taps_re = torch.as_tensor(np.ascontiguousarray(taps.real.T),
                                       device=self.device)
        self.taps_im = torch.as_tensor(np.ascontiguousarray(taps.imag.T),
                                       device=self.device)
