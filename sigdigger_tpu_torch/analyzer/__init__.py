"""The analyzer session of the port (counterpart of
``sigdigger_tpu/analyzer``): the session protocol (``engine``), its run
on the kernel banks (``kernel_engine``), the typed messages, the channel
detector, the in-channel estimators, the request tracker, the PSD
mediator and the panoramic sweep.  Names resolve lazily, so
``import sigdigger_tpu_torch.analyzer`` stays light."""

from __future__ import annotations

_MESSAGES = (
    "ChannelMessage", "InspectorMessage", "InspectorMessageKind",
    "Message", "MessageKind", "PSDMessage", "SamplesMessage",
    "SourceInfoMessage", "StatusMessage",
)

__all__ = ["Analyzer", "AnalyzerRequest", "AnalyzerRequestTracker",
           "AnalyzerState", "KernelAnalyzer", *_MESSAGES]


def __getattr__(name):
    if name in ("Analyzer", "AnalyzerState"):
        from sigdigger_tpu_torch.analyzer import engine

        return getattr(engine, name)
    if name == "KernelAnalyzer":
        from sigdigger_tpu_torch.analyzer.kernel_engine import KernelAnalyzer

        return KernelAnalyzer
    if name in ("AnalyzerRequest", "AnalyzerRequestTracker"):
        from sigdigger_tpu_torch.analyzer import tracker

        return getattr(tracker, name)
    if name in _MESSAGES:
        from sigdigger_tpu_torch.analyzer import messages

        return getattr(messages, name)
    raise AttributeError(name)
