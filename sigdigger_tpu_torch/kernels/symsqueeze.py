"""Symbol-rate squeeze of the recovery drain (counterpart of
``sigdigger_tpu/kernels/symsqueeze.py``).

The recovery bank emits channel-rate ``[M, C]`` soft-symbol planes and a
strobe plane marking the symbol instants.  Draining them whole at ~1024
open inspectors moves sps times the bytes the symbols carry, so the
planes are reduced ``group`` times on the device before the drain:

    out_v[i]  = Σ_{r<R} strobe[i·R + r] · plane[i·R + r]
    out_st[i] = Σ_{r<R} strobe[i·R + r]

The products come first, as in the reference (``symsqueeze.py:73-75``):
the strobe multiplies, it does not select.  The reduction is exact when
every R-row group holds at most one strobe; the engine enforces
``sps >= R + 1`` on every digital slot of the bucket (Gardner strobe
spacing jitters ±1 around sps), so a group never holds more than two,
and a sum of at most two nonzero products rounds once whatever the
order.

The reference sums each group with a block-diagonal 0/1 matmul in
chunks (its TPU toolchain had no gather or segmented sum);
:func:`squeeze_kernel` launches the hand-written ``csrc/symsqueeze.cu``
on CUDA tensors and runs :func:`squeeze_kernel_reference` on CPU
tensors.  Neither tiles the planes, so the config has none of the
reference's ``channel_tile``, ``m_tile`` and ``chunk``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels._build import (
    kernel,
    launch,
    load_library,
    tensor_key,
)


@dataclass(frozen=True)
class SymbolSqueezeConfig:
    n_rows: int                  # M (channel-rate rows per block)
    n_channels: int              # C
    group: int                   # R (rows summed per output row)

    def __post_init__(self):
        assert self.group >= 2
        assert self.n_rows % self.group == 0

    @property
    def out_rows(self) -> int:
        return self.n_rows // self.group


def squeeze_kernel_reference(sr: torch.Tensor, si: torch.Tensor,
                             st: torch.Tensor, group: int) -> tuple:
    """Plain PyTorch version of ``_squeeze_kernel``: float32 ``[M, C]``
    soft re, soft im and strobe planes → the three ``[M/R, C]`` group
    sums."""
    m, c = st.shape
    r = group

    def fold(v):
        return v.reshape(m // r, r, c).sum(1)

    return fold(sr * st), fold(si * st), fold(st)


def _check(sr, si, st, group: int) -> None:
    dev = st.device
    shape = tuple(st.shape)
    for name, t in (("sr", sr), ("si", si), ("st", st)):
        if (t.dim() != 2 or tuple(t.shape) != shape
                or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"squeeze_kernel {name}: want contiguous float32 [M, C] "
                f"like st on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    m, c = shape
    if group < 2 or m % group or (m // group) * c >= 2 ** 31:
        raise ValueError(f"squeeze_kernel needs group >= 2 dividing M and "
                         f"fewer than 2^31 outputs a plane, got M={m}, "
                         f"C={c}, group={group}")


def _squeeze_cuda(sr, si, st, group: int) -> tuple:
    m, c = st.shape
    # one allocation for the three planes (each a contiguous view); a new
    # one every call, since the threaded drain holds earlier blocks'
    out = torch.empty((3, m // group, c), device=st.device)
    ptrs = (sr.data_ptr(), si.data_ptr(), st.data_ptr())
    # the float4 path: C a multiple of 4 (so the planes of `out` stay
    # 16-byte aligned) and the inputs' base pointers 16-byte aligned
    vec = int(c % 4 == 0 and (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    o, plane = out.data_ptr(), (m // group) * c * 4
    err = launch(load_library("symsqueeze").sd_symsqueeze, st.device,
                 *ptrs, o, o + plane, o + 2 * plane, m, c, group, vec)
    if err != 0:
        raise RuntimeError(f"sd_symsqueeze launch failed: CUDA error {err}")
    squeeze_kernel.path = "vector" if vec else "scalar"
    return out.unbind(0)


squeeze_kernel = kernel(
    "squeeze_kernel", _squeeze_cuda, squeeze_kernel_reference, at=2,
    key=lambda sr, si, st, group: tensor_key(sr, si, st) + (group,),
    check=_check, doc="""One squeeze of the float32 ``[M, C]`` planes
    (soft re, soft im, strobe) by ``group``.  ``squeeze_kernel.path``
    says which path the last CUDA launch took: ``"vector"`` (float4,
    C % 4 == 0 and 16-byte aligned inputs) or ``"scalar"``.""")
squeeze_kernel.path = None


class SymbolSqueeze:
    """Device-side R× reduction of (soft_re, soft_im, strobe) planes.
    Runs on ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg: SymbolSqueezeConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)

    def dispatch(self, sr, si, st) -> tuple:
        """Device-resident (soft_re, soft_im, strobe) → squeezed device
        planes (same order, ``group``× fewer rows)."""
        sr, si, st = (torch.as_tensor(p).to(self.device)
                      for p in (sr, si, st))
        return squeeze_kernel(sr, si, st, self.cfg.group)
