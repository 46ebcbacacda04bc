"""The "raw" and "power" inspector classes (counterpart of
``sigdigger_tpu/inspectors/simple.py``).

- raw:   passthrough of channel baseband with optional AGC — feeds the
  TimeWindow capture path (reference Default/Inspection/
  InspToolWidget.cpp:558-628) and raw recording.
- power: RMS time series with an integration window — feeds
  RMSInspector (reference Default/RMSInspector/RMSInspector.cpp:40-80).
  The power sums run in float64 on the inspector's device, as the
  reference's run in float64 numpy; a partial window carries across
  blocks.
"""

from __future__ import annotations

from typing import Any

import torch

from sigdigger_tpu_torch.dsp.agc import AGC, AGCParams
from sigdigger_tpu_torch.inspectors.base import Inspector, register_inspector


@register_inspector
class RawInspector(Inspector):
    class_name = "raw"

    def _build(self) -> None:
        self._agc = (
            AGC(self.channels, AGCParams(tau=self.config["agc.ts"]),
                device=self.device)
            if self.config["agc.enabled"] else None
        )
        self._gain = float(self.config["agc.gain"])

    def process(self, x) -> dict[str, Any]:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        if self._agc is not None:
            y = self._agc(x)
        else:
            y = x * self._gain
        return {"samples": y}


@register_inspector
class PowerInspector(Inspector):
    class_name = "power"

    def _build(self) -> None:
        self._n_int = max(1, int(self.config["power.integrate-samples"]))
        self._acc = torch.zeros(self.channels, dtype=torch.float64,
                                device=self.device)     # partial sum
        self._cnt = 0

    def process(self, x) -> dict[str, Any]:
        """Returns RMS points: sqrt(mean |x|^2) over each full
        integration window; partial windows carry across blocks."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        if x.ndim == 1:
            x = x[None, :]
        p = (x.real.to(torch.float64) ** 2 + x.imag.to(torch.float64) ** 2)
        n, t = self._n_int, x.shape[1]
        out = []
        pos = 0
        if self._cnt:
            # close the window carried from the last block
            pos = min(n - self._cnt, t)
            self._acc = self._acc + p[:, :pos].sum(dim=1)
            self._cnt += pos
            if self._cnt == n:
                out.append(torch.sqrt(self._acc / n)[:, None])
                self._acc = torch.zeros_like(self._acc)
                self._cnt = 0
        full = (t - pos) // n
        if full:
            sums = p[:, pos:pos + full * n].reshape(-1, full, n).sum(dim=2)
            out.append(torch.sqrt(sums / n))
            pos += full * n
        if pos < t:
            self._acc = self._acc + p[:, pos:].sum(dim=1)
            self._cnt += t - pos
        samples = (torch.cat(out, dim=1) if out
                   else torch.zeros((x.shape[0], 0), dtype=torch.float64,
                                    device=self.device))
        return {"samples": samples.to(torch.float32)}
