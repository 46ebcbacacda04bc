"""sigdigger_tpu_torch — the PyTorch/CUDA port of sigdigger_tpu.

The port runs on one NVIDIA Hopper card: plain tensor code is PyTorch,
and each Pallas kernel of the JAX package becomes a CUDA C++ kernel
written by hand for ``sm_90a`` (``kernels/csrc/``).  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU
each kernel wrapper runs its plain PyTorch version.

Entry points: ``KernelReceiver`` (the wideband receiver),
``KernelAnalyzer`` (the dynamic analyzer session on the kernel banks),
``Analyzer`` (the same session protocol on the class path: channelizer,
spectrum and ``inspectors/``), with ``AnalyzerState`` and the typed
messages, ``app.LiveSession`` (the live session: wire server, REPL,
web view, audio and recorder around either engine),
``pipeline.pipeline_step`` (the functional receiver), and the command
line, ``python -m sigdigger_tpu_torch {info,psd,demod,symbols,rms,tv,
scan,doppler,live,serve,remote}`` (``cli.py``).  The light names of
the reference's top level (the types, ``Config``, ``SourceProfile``,
``Library``) are here too.

The package never imports JAX or ``sigdigger_tpu``: it keeps its own
copy of every constant builder it needs.
"""

from __future__ import annotations

from sigdigger_tpu_torch.config import Config, ConfigSchema
from sigdigger_tpu_torch.profiles import SourceProfile
from sigdigger_tpu_torch.types import (
    AnalyzerMode,
    AnalyzerParams,
    Channel,
    SampleFormat,
    WindowFunction,
)
from sigdigger_tpu_torch.version import __version__

_TYPES = ("AnalyzerMode", "AnalyzerParams", "Channel", "SampleFormat",
          "SourceProfile", "WindowFunction", "Config", "ConfigSchema")
_RECEIVER = ("KernelReceiver", "ReceiverBlock")
_ANALYZER = (
    "Analyzer", "AnalyzerState", "KernelAnalyzer", "ChannelMessage",
    "InspectorMessage", "InspectorMessageKind", "Message", "MessageKind",
    "PSDMessage", "SamplesMessage", "SourceInfoMessage", "StatusMessage",
)

__all__ = [*_TYPES, *_RECEIVER, *_ANALYZER, "Library", "__version__"]


def __getattr__(name):
    # heavy imports resolved lazily so `import sigdigger_tpu_torch`
    # stays light
    if name in _RECEIVER:
        from sigdigger_tpu_torch import receiver

        return getattr(receiver, name)
    if name in _ANALYZER:
        from sigdigger_tpu_torch import analyzer

        return getattr(analyzer, name)
    if name == "Library":
        from sigdigger_tpu_torch.library import Library

        return Library
    raise AttributeError(name)
