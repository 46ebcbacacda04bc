"""sigdigger_tpu_torch — the PyTorch/CUDA port of sigdigger_tpu.

The port runs on one NVIDIA Hopper card: plain tensor code is PyTorch,
and each Pallas kernel of the JAX package becomes a CUDA C++ kernel
written by hand for ``sm_90a`` (``kernels/csrc/``).  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU
each kernel wrapper runs its plain PyTorch version.

The package never imports JAX or ``sigdigger_tpu``: it keeps its own
copy of every constant builder it needs.
"""

from __future__ import annotations

__all__ = ["KernelReceiver", "ReceiverBlock"]


def __getattr__(name):
    # heavy imports resolved lazily so `import sigdigger_tpu_torch`
    # stays light
    if name in ("KernelReceiver", "ReceiverBlock"):
        from sigdigger_tpu_torch import receiver

        return getattr(receiver, name)
    raise AttributeError(name)
