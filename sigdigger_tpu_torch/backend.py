"""Device resolution for the port's entry points.

``device=None`` means the card: the port's hot path is written for
CUDA, so a missing card is an error, never a silent move to the CPU.
Callers that want the plain PyTorch versions (the tests) pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

# Full-precision float32 products everywhere, set once for the process:
# the reference's kernels accumulate in float32, and TF32 (about three
# decimal digits) would put matmuls and convolutions of the plain
# versions outside the parity tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as
    given, with a CUDA device checked for availability."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sigdigger_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions")
    return dev
