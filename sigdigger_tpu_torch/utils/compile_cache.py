"""Where the built kernels live (counterpart of
``sigdigger_tpu/utils/compile_cache.py``).

The reference turns on JAX's persistent XLA compilation cache.  The
port has no XLA: its compiled artefacts are ``kernels/_build.py``'s
nvcc outputs, one ``lib<name>.so`` per ``csrc/*.cu``, rebuilt only when
a source or header is newer.  :func:`enable` names their directory.
"""

from __future__ import annotations

import os

from sigdigger_tpu_torch.kernels import _build


def enable(path: str | None = None) -> str:
    """Set the directory of the nvcc outputs to ``path`` (created if
    needed; the package's ``kernels/build`` when None) and return it.
    Libraries already loaded stay loaded."""
    if path is not None:
        os.makedirs(path, exist_ok=True)
        _build.BUILD_DIR = os.path.abspath(path)
    return _build.BUILD_DIR
