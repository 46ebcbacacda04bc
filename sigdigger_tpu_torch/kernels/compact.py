"""Device-side column compaction for bank drains (counterpart of
``sigdigger_tpu/kernels/compact.py``).

The analyzer banks emit dense ``[M, n_slots]`` planes, but a session
rarely uses every pre-allocated slot.  The compactor gathers the active
columns on the device so only they cross to the host:

    out[p·mt + r, w] = X_p[r, slots[w]]   in row tiles of ``m_tile``

with columns that have no slot left 0.  Several planes of one shape
compact into ONE plane-interleaved output (rows of tile mi are ``[plane
0 rows | plane 1 rows | ...]``), so a bank drain is one dispatch and one
fetch; :meth:`ColumnCompactor.fetch` de-interleaves it.  The output is
float32, bfloat16 (round to nearest even) or int16
(``clip(v·scale)``, truncated toward zero as a float-to-int16 cast does).

The reference gathers with a one-hot selection matmul (its TPU toolchain
had no gather); :func:`compact_kernel` launches a gather written by hand
in ``csrc/compact.cu`` on CUDA tensors and runs
:func:`compact_kernel_reference` on CPU tensors.  The column map is a
small device tensor (int32 ``[W]``, -1 for an empty column) rewritten in
place by :meth:`ColumnCompactor.set_mapping`; nothing is rebuilt.  Beside
it lies the map's run table (:func:`run_table`): the kernel moves runs of
consecutive output columns, one 16-byte store each, and reads a run whose
source columns are consecutive and 16-byte aligned with vector loads.

Non-finite inputs: the gather copies a mapped column's value as it is
and never reads an unmapped column.  The one-hot matmul also multiplies
every unmapped column of a row by 0, so an inf or NaN there turns that
row's whole output into NaN in the reference and not here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels._build import (
    kernel,
    launch,
    load_library,
    tensor_key,
)

MAX_PLANES = 4               # planes one kernel launch gathers


@dataclass(frozen=True)
class ColumnCompactorConfig:
    n_rows: int                  # M
    n_channels: int              # C (bank slot count)
    width: int                   # W (compact columns)
    n_planes: int = 1            # planes compacted per dispatch
    m_tile: int = 0              # rows per interleaved tile (0 → auto)
    out_bf16: bool = False       # drain bf16 (halves the D2H bytes)
    out_i16: bool = False        # drain scaled int16 (per-plane scales)
    scales: tuple[float, ...] = ()   # quantization scale per plane
                                     # (required with out_i16)

    def __post_init__(self):
        if self.out_i16:
            assert not self.out_bf16
            assert len(self.scales) == self.n_planes
        if self.m_tile == 0:
            mt = min(self.n_rows, 2048)
            while self.n_rows % mt:
                mt -= 1
            object.__setattr__(self, "m_tile", mt)
        assert self.n_rows % self.m_tile == 0

    @property
    def dtype(self) -> torch.dtype:
        return (torch.int16 if self.out_i16
                else torch.bfloat16 if self.out_bf16 else torch.float32)


def _store(v: torch.Tensor, dtype: torch.dtype, scale: float | None
           ) -> torch.Tensor:
    if dtype == torch.int16:
        v = torch.clamp(v * torch.tensor(np.float32(scale)),
                        -32768.0, 32767.0)
    return v.to(dtype)


def compact_kernel_reference(planes: tuple, slots: torch.Tensor,
                             cfg: ColumnCompactorConfig) -> torch.Tensor:
    """Plain PyTorch version of ``_compact_kernel``: ``planes`` are
    ``n_planes`` float32 ``[M, C]``, ``slots`` int32 ``[W]`` (-1: empty
    column).  Returns the interleaved ``[n·M, W]`` output in
    ``cfg.dtype``."""
    m, w, n, mt = cfg.n_rows, cfg.width, cfg.n_planes, cfg.m_tile
    idx = slots.long().clamp(min=0)
    mapped = (slots >= 0)[None, :]
    out = torch.empty((m // mt, n, mt, w), dtype=cfg.dtype,
                      device=slots.device)
    for p, x in enumerate(planes):
        v = torch.where(mapped, x[:, idx], torch.zeros((), device=x.device))
        out[:, p] = _store(v, cfg.dtype, cfg.scales[p] if cfg.out_i16
                           else None).reshape(m // mt, mt, w)
    return out.reshape(n * m, w)


_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}


def run_width(dtype: torch.dtype) -> int:
    """Output columns of one 16-byte store: 4 float32, else 8."""
    return 4 if dtype == torch.float32 else 8


def run_table(slots, n_channels: int, dtype: torch.dtype) -> np.ndarray:
    """The kernel's run table of a column map: int32 ``[ceil(W / V)]``,
    1 where run j (output columns ``j·V .. j·V+V-1``, V =
    :func:`run_width`) lies wholly inside the map and its source columns
    are consecutive, mapped and start at a multiple of 4 in rows of a
    multiple of 4 floats (so its loads are 16-byte aligned float4s), else
    0 (the kernel gathers that run column by column)."""
    slots = np.asarray(slots, np.int64)
    v = run_width(dtype)
    n_runs = -(-len(slots) // v)
    table = np.zeros(n_runs, np.int32)
    if n_channels % 4:
        return table
    full = len(slots) // v
    runs = slots[:full * v].reshape(full, v)
    table[:full] = (np.all(runs == runs[:, :1] + np.arange(v), axis=1)
                    & (runs[:, 0] >= 0) & (runs[:, 0] % 4 == 0))
    return table


def _check(planes: tuple, slots: torch.Tensor, runs: torch.Tensor,
           cfg: ColumnCompactorConfig) -> None:
    dev = slots.device
    m, c, w, n = cfg.n_rows, cfg.n_channels, cfg.width, cfg.n_planes
    if not 1 <= n <= MAX_PLANES or len(planes) != n:
        raise ValueError(f"compact_kernel takes 1..{MAX_PLANES} planes and "
                         f"the config's {n}, got {len(planes)}")
    for p, x in enumerate(planes):
        if (tuple(x.shape) != (m, c) or x.dtype != torch.float32
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(
                f"compact_kernel plane {p}: want contiguous float32 "
                f"{(m, c)} on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    if (tuple(slots.shape) != (w,) or slots.dtype != torch.int32
            or not slots.is_contiguous()):
        raise ValueError(f"compact_kernel slots: want contiguous int32 "
                         f"({w},), got {slots.dtype} {tuple(slots.shape)}")
    n_runs = -(-w // run_width(cfg.dtype))
    if (tuple(runs.shape) != (n_runs,) or runs.dtype != torch.int32
            or runs.device != dev or not runs.is_contiguous()):
        raise ValueError(f"compact_kernel runs: want contiguous int32 "
                         f"({n_runs},) on {dev}, got {runs.dtype} "
                         f"{tuple(runs.shape)} on {runs.device}")


def _compact_cuda(planes: tuple, slots: torch.Tensor, runs: torch.Tensor,
                  cfg: ColumnCompactorConfig) -> torch.Tensor:
    dev = slots.device
    m, c, w, n = cfg.n_rows, cfg.n_channels, cfg.width, cfg.n_planes
    ptrs = [x.data_ptr() for x in planes]
    # the run table's float4 loads need 16-byte aligned planes: a
    # property of this call's pointers, so no part of the check
    vec_loads = int(all(q % 16 == 0 for q in ptrs))
    out = torch.empty((n * m, w), dtype=cfg.dtype, device=dev)
    scales = list(cfg.scales if cfg.out_i16 else ())
    scales += [1.0] * (MAX_PLANES - len(scales))
    err = launch(load_library("compact").sd_compact, dev,
                 *ptrs, *[None] * (MAX_PLANES - n), n, slots.data_ptr(),
                 runs.data_ptr(), vec_loads, out.data_ptr(),
                 _OUT_KIND[cfg.dtype],
                 *(float(np.float32(s)) for s in scales), m, c, w,
                 cfg.m_tile)
    if err != 0:
        raise RuntimeError(f"sd_compact launch failed: CUDA error {err}")
    return out


def _compact_plain(planes: tuple, slots: torch.Tensor, runs: torch.Tensor,
                   cfg: ColumnCompactorConfig) -> torch.Tensor:
    return compact_kernel_reference(planes, slots, cfg)


compact_kernel = kernel(
    "compact_kernel", _compact_cuda, _compact_plain, at=1,
    # everything _check reads: each tensor's shape, dtype, device and
    # contiguity, the plane count and the config
    key=lambda planes, slots, runs, cfg: tensor_key(
        *planes, slots, runs) + (len(planes), cfg),
    check=_check, doc="""One compaction through the map ``slots`` and
    its :func:`run_table` ``runs`` (the plain version reads no run
    table).""")


class ColumnCompactor:
    """Compacts active slot columns out of dense bank planes.  Runs on
    ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg: ColumnCompactorConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._slots = torch.full((cfg.width,), -1, dtype=torch.int32,
                                 device=self.device)
        self._runs = torch.zeros(-(-cfg.width // run_width(cfg.dtype)),
                                 dtype=torch.int32, device=self.device)

    def set_mapping(self, slots: list[int]) -> None:
        """slots[w] = bank column for compact column w (the device map
        and its run table are rewritten in place, never rebuilt)."""
        assert len(slots) <= self.cfg.width, (len(slots), self.cfg.width)
        new = np.full(self.cfg.width, -1, np.int32)
        new[:len(slots)] = np.asarray(slots, np.int64)
        self._slots.copy_(torch.from_numpy(new))
        self._runs.copy_(torch.from_numpy(
            run_table(new, self.cfg.n_channels, self.cfg.dtype)))

    def dispatch(self, *planes) -> torch.Tensor:
        """Dispatch the compaction; returns the DEVICE interleaved
        output (fetch deferred — callers pipeline the drain)."""
        assert len(planes) == self.cfg.n_planes
        planes = tuple(torch.as_tensor(p).to(self.device) for p in planes)
        return compact_kernel(planes, self._slots, self._runs, self.cfg)

    def fetch(self, stacked) -> tuple[np.ndarray, ...]:
        """ONE device-to-host fetch of a dispatched output,
        de-interleaved into n_planes float32 ``[M, W]`` arrays."""
        cfg = self.cfg
        host = torch.as_tensor(stacked).cpu()
        i16 = host.dtype == torch.int16
        stacked = host.float().numpy()
        m_tiles = cfg.n_rows // cfg.m_tile
        v = stacked.reshape(m_tiles, cfg.n_planes, cfg.m_tile, cfg.width)
        planes = [np.ascontiguousarray(v[:, p].reshape(cfg.n_rows,
                                                       cfg.width))
                  for p in range(cfg.n_planes)]
        if i16:
            for p, scale in enumerate(cfg.scales):
                planes[p] *= np.float32(1.0 / scale)
        return tuple(planes)

    def __call__(self, *planes) -> tuple[np.ndarray, ...]:
        """planes: n_planes ``[M, C]`` float32 tensors → tuple of ``[M,
        W]`` numpy arrays (dispatch + single fetch)."""
        return self.fetch(self.dispatch(*planes))
