"""Single-fetch drain packing for the analyzer (counterpart of
``sigdigger_tpu/kernels/drainpack.py``).

Every per-block drain payload of a bucket goes into ONE scaled-int16
buffer, with per-section compact widths, so the drain pays one
device-to-host copy with few bytes:

    audio tiles     : audio-slot columns    audio[Ma, C] @ S_a  × 4096
    status tile     : rows 0-2 squelch EMA  sq[1, C] @ S  (3-lane residual)
                      rows 3-5 block power  pow[1, C] @ S (3-lane residual)
    digital tiles   : soft re/im + strobe   [Md, C] @ S_d  × 8192/16384
    raw tiles       : raw channel re/im     [M, C] @ S_r  × 4096

Section ``s`` has width ``w_s`` dividing the buffer lane width ``W``,
and ``G_s = W / w_s`` consecutive time tiles pack into the lane groups
of one output tile: lane ``l`` of output tile ``t`` holds group ``g = l
// w_s`` of source tile ``(t - t0)·G + g``, column ``idx[l % w_s]``.
The layout (``DrainPackerConfig.sections``, ``group``,
``_pick_m_tile``, ``total_tiles``) is the reference's line for line.

Values quantize as ``clip(v·scale, -32768, 32767)`` truncated toward
zero, as ``astype(int16)`` does.  Status values do not: channel powers
routinely sit below 1/512 of full scale, where one ×256 lane rounds to
zero, so each is split over three int16 lanes, ``h = floor(v·256)``,
``m = floor((v·256 − h)·2¹⁵)``, ``l`` the floor of the next residual,
and decoded on the host in float64 to ~4e-12 absolute.

The reference selects the columns with per-group one-hot matmuls (its
TPU toolchain had no gather).  Here each section's map is a column-index
list on the device (int32, -1 for an empty lane), rewritten in place by
:meth:`DrainPacker.set_mappings`: a slot-lifecycle change never rebuilds
anything.  :func:`pack_kernel` launches the hand-written
``csrc/drainpack.cu`` on CUDA tensors and runs
:func:`pack_kernel_reference` on CPU tensors.  The kernel takes section
widths that are multiples of 8 (the engine's are powers of two × 8):
each of its threads stores 8 lanes at once.  Its blocks find their
section, rows and source rows in :func:`block_table`, built once per
layout and device; a dispatch passes only the planes' pointers.  Every
step of the quantizer and of the residual split is one IEEE float32
operation on both sides, so for finite input the kernel, the plain
version and the reference agree bit for bit.

Non-finite inputs: the gather reads only mapped columns.  The one-hot
matmul also multiplies every unmapped column of a row by 0, so an inf or
NaN there turns that row's whole section into NaN in the reference and
not here (as for ``kernels/compact.py``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
from sigdigger_tpu_torch.kernels._build import (
    checked_once,
    kernel,
    launch,
    load_library,
    tensor_key,
)
from sigdigger_tpu_torch.utils import largest_divisor

A_SCALE = 4096.0       # audio samples (±8 range)
S_SCALE = 256.0        # squelch EMA / block power (±128 range)
D_SCALE = 8192.0       # digital soft symbols (±4 range)
T_SCALE = 16384.0      # strobe 0/1 (exact)
R_SCALE = 4096.0       # raw channel IQ (±8, matches the i16 upload)

_SCALES = {"audio": A_SCALE, "d_sr": D_SCALE, "d_si": D_SCALE,
           "d_st": T_SCALE, "y_re": R_SCALE, "y_im": R_SCALE}

# plane name -> section-selection name
_SEL_OF = {"audio": "audio", "d_sr": "digital", "d_si": "digital",
           "d_st": "digital", "y_re": "raw", "y_im": "raw"}


@dataclass(frozen=True)
class DrainPackerConfig:
    n_rows: int                  # M (raw plane rows)
    audio_rows: int              # Ma (= M // audio_decim)
    n_channels: int              # C
    width: int                   # W: buffer lane width (status width)
    has_audio: bool = True
    has_digital: bool = True
    has_raw: bool = True
    # per-section compact widths; 0 -> width (no lane grouping).
    # Must divide `width`.
    audio_width: int = 0
    digital_width: int = 0
    raw_width: int = 0
    m_tile: int = 0              # 0 → auto (≤1024, fits all sections)
    digital_rows: int = 0        # Md (0 → n_rows; symbol-squeezed
                                 # digital planes have M/group rows)

    def __post_init__(self):
        assert self.n_rows % self.audio_rows == 0
        if self.digital_rows == 0:
            object.__setattr__(self, "digital_rows", self.n_rows)
        for name in ("audio_width", "digital_width", "raw_width"):
            w = getattr(self, name)
            if w == 0:
                object.__setattr__(self, name, self.width)
            elif self.width % w:
                raise ValueError(
                    f"{name} {w} must divide width {self.width}")
        if self.m_tile == 0:
            object.__setattr__(self, "m_tile", self._pick_m_tile())
        mt = self.m_tile
        assert self.audio_rows % mt == 0 and self.n_rows % mt == 0
        if self.has_digital:
            assert self.digital_rows % mt == 0
        if self.has_audio:
            assert (self.audio_rows // mt) % self.group("audio") == 0
        if self.has_digital:
            assert (self.digital_rows // mt) % self.group("digital") == 0
        if self.has_raw:
            assert (self.n_rows // mt) % self.group("raw") == 0
        # the status tile carries 2 values × 3 residual lanes
        assert mt >= 6, (
            f"m_tile {mt} too small for the 6-row status tile")

    def group(self, section: str) -> int:
        return self.width // getattr(self, f"{section}_width")

    def _pick_m_tile(self) -> int:
        mt = largest_divisor(self.audio_rows, 1024)
        while mt >= 6:
            ok = True
            if self.has_audio and \
                    (self.audio_rows // mt) % self.group("audio"):
                ok = False
            if self.has_digital and (
                    self.digital_rows % mt
                    or (self.digital_rows // mt)
                    % self.group("digital")):
                ok = False
            if self.has_raw and \
                    (self.n_rows // mt) % self.group("raw"):
                ok = False
            if ok:
                return mt
            nxt = mt - 1
            while nxt >= 6 and self.audio_rows % nxt:
                nxt -= 1
            mt = nxt
        raise ValueError(
            "no m_tile satisfies the section grouping constraints "
            f"(audio_rows={self.audio_rows}, n_rows={self.n_rows}, "
            f"widths={self.audio_width}/{self.digital_width}/"
            f"{self.raw_width} of {self.width})")

    def sections(self) -> list[tuple[str, int, int, int]]:
        """[(name, first out tile, out tile count, lane groups)]."""
        mt = self.m_tile
        t = 0
        out = []
        if self.has_audio:
            g = self.group("audio")
            n = (self.audio_rows // mt) // g
            out.append(("audio", t, n, g))
            t += n
        out.append(("status", t, 1, 1))
        t += 1
        pt = self.n_rows // mt
        if self.has_digital:
            g = self.group("digital")
            dt = self.digital_rows // mt
            for name in ("d_sr", "d_si", "d_st"):
                out.append((name, t, dt // g, g))
                t += dt // g
        if self.has_raw:
            g = self.group("raw")
            for name in ("y_re", "y_im"):
                out.append((name, t, pt // g, g))
                t += pt // g
        return out

    @property
    def total_tiles(self) -> int:
        s = self.sections()
        return s[-1][1] + s[-1][2]

    def plane_rows(self, name: str) -> int:
        """Rows of the source plane a data section reads."""
        return {"audio": self.audio_rows, "y_re": self.n_rows,
                "y_im": self.n_rows}.get(name, self.digital_rows)


def _quantize(v: torch.Tensor, scale: float) -> torch.Tensor:
    v = torch.clamp(v * torch.tensor(np.float32(scale)), -32768.0, 32767.0)
    return v.to(torch.int16)


def _residual3(v: torch.Tensor) -> torch.Tensor:
    """v·S_SCALE split over (floor, 2×15-bit residual) lanes → int16
    ``[3, n]``."""
    v = torch.clamp(v * torch.tensor(np.float32(S_SCALE)), -32768.0,
                    32766.0)
    h = torch.floor(v)
    r1 = (v - h) * torch.tensor(np.float32(32768.0))
    m = torch.floor(r1)
    lo = torch.floor((r1 - m) * torch.tensor(np.float32(32768.0)))
    return torch.stack([h, m, lo]).to(torch.int16)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns ``idx`` of ``x`` (0 where idx < 0)."""
    v = x[:, idx.long().clamp(min=0)]
    return torch.where((idx >= 0)[None, :], v,
                       torch.zeros((), dtype=v.dtype, device=v.device))


def pack_kernel_reference(planes: dict, sq: torch.Tensor, pw: torch.Tensor,
                          maps: dict, cfg: DrainPackerConfig
                          ) -> torch.Tensor:
    """Plain PyTorch version of ``_pack_kernel``.  ``planes`` maps each
    data section of ``cfg.sections()`` to its float32 plane; ``sq`` and
    ``pw`` are float32 ``[1, C]``; ``maps`` holds the int32 index lists
    ``"status"`` ``[W]`` and one ``[w_s]`` per present section (-1: an
    empty lane).  Returns the int16 ``[total_tiles·m_tile, W]`` buffer."""
    mt, w = cfg.m_tile, cfg.width
    out = torch.zeros((cfg.total_tiles * mt, w), dtype=torch.int16,
                      device=sq.device)
    for name, t0, cnt, g in cfg.sections():
        at = t0 * mt
        if name == "status":
            out[at:at + 3] = _residual3(_gather(sq, maps["status"])[0])
            out[at + 3:at + 6] = _residual3(_gather(pw, maps["status"])[0])
            continue
        ws = w // g
        q = _quantize(_gather(planes[name], maps[_SEL_OF[name]]),
                      _SCALES[name])
        # source tile local·g + gi → out tile local, lanes gi·ws...
        out[at:at + cnt * mt] = (q.reshape(cnt, g, mt, ws)
                                 .permute(0, 2, 1, 3)
                                 .reshape(cnt * mt, w))
    return out


# block table entry kinds (csrc/drainpack.cu): the data planes, then the
# status tile's rows 0-5, then rows of zeros
SECTION_IDS = {"audio": 0, "d_sr": 1, "d_si": 2, "d_st": 3, "y_re": 4,
               "y_im": 5, "status": 6, "zero": 7}
# the data planes, then the maps, in the kernel's argument order
_PLANE_ORDER = tuple(SECTION_IDS)[:6]
_MAP_ORDER = ("audio", "digital", "raw")
BLOCK_THREADS = 256    # threads of a block (csrc/drainpack.cu THREADS)
THREAD_ROWS = 4        # rows of one thread (ROWS there)
LANES = 8              # lanes of one thread: one 16-byte int16 store
MIN_BLOCKS = 264       # two blocks for each of the H100's 132 SMs


def lane_octets(width: int) -> int:
    """Lane octets (8 lanes, one thread) that one block row spans."""
    return min(width // LANES, 32)


def block_table(cfg: DrainPackerConfig) -> np.ndarray:
    """The kernel's block table, int32 ``[n_blocks, 8]``: each entry is
    (kind, first output row, first source row of lane group 0, rows,
    section width, scale's float32 bits, 0, 0) for a run of output rows
    of one data tile, the status tile's rows 0-5 (kind ``"status"``), or
    rows of zeros (the status tile's rows 6..).  Lane group ``g`` of a
    data run reads source rows ``first + g·m_tile ..``.  Every output
    row is in exactly one entry; the table depends on the layout only.
    A run is at most ``k·BLOCK_THREADS/lane_octets(W)`` rows, ``k`` rows
    a thread: the largest ``k`` of 4, 2, 1 that still gives MIN_BLOCKS
    blocks, else 1 (small packs spread over the SMs, large ones keep 4
    rows of loads in flight a thread)."""
    mt, w = cfg.m_tile, cfg.width
    octets = w // LANES
    spans = -(-octets // lane_octets(w))       # blocks across the lanes
    for k in (THREAD_ROWS, 2, 1):
        rb = k * (BLOCK_THREADS // lane_octets(w))
        rows = []

        def run(kind, out0, src0, n, ws=0, scale=0.0):
            bits = int(np.float32(scale).view(np.int32))
            for r in range(0, n, rb):
                rows.append((SECTION_IDS[kind], out0 + r, src0 + r,
                             min(rb, n - r), ws, bits, 0, 0))

        for name, t0, cnt, g in cfg.sections():
            if name == "status":
                run("status", t0 * mt, 0, 6)
                run("zero", t0 * mt + 6, 0, mt - 6)
                continue
            for t in range(cnt):
                run(name, (t0 + t) * mt, t * g * mt, mt, w // g,
                    _SCALES[name])
        if len(rows) * spans >= MIN_BLOCKS:
            break
    return np.array(rows, np.int32)


def _check(planes: dict, sq, pw, maps: dict, cfg: DrainPackerConfig,
           dev: torch.device) -> None:
    c, w = cfg.n_channels, cfg.width

    def need(name, t, shape, dtype):
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != dev or not t.is_contiguous()):
            got = ("nothing" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"pack_kernel {name}: want contiguous {dtype} "
                             f"{shape} on {dev}, got {got}")

    need("sq", sq, (1, c), torch.float32)
    need("pw", pw, (1, c), torch.float32)
    need("status map", maps.get("status"), (w,), torch.int32)
    for name, _, _, g in cfg.sections():
        if name != "status":
            need(name, planes.get(name), (cfg.plane_rows(name), c),
                 torch.float32)
            need(f"{_SEL_OF[name]} map", maps.get(_SEL_OF[name]),
                 (w // g,), torch.int32)


class _Plan:
    """One layout's launch on one device: the block table on the device,
    the data sections present and the maps they read, with their slots
    in the entry point's arguments, the arguments that do not change
    between dispatches, and the argument keys already checked.  Kept in
    ``_PLANS`` under the layout's ``id`` while the layout lives, and
    dropped when it is freed, before another object can take its
    ``id``."""

    def __init__(self, cfg: DrainPackerConfig, dev: torch.device) -> None:
        widths = [cfg.width // g for *_, g in cfg.sections()]
        if any(ws % LANES for ws in widths):
            raise ValueError(f"pack_kernel: section widths {widths}; the "
                             f"kernel takes multiples of {LANES}")
        table = block_table(cfg)
        self.table = torch.from_numpy(table).to(dev)
        self.table_ptr = self.table.data_ptr()
        self.n_blocks = len(table)
        self.names = [n for n, *_ in cfg.sections() if n != "status"]
        self.sels = [s for s in _MAP_ORDER
                     if any(_SEL_OF[n] == s for n in self.names)]
        self.x_slots = [_PLANE_ORDER.index(n) for n in self.names]
        self.m_slots = [6 + _MAP_ORDER.index(s) for s in self.sels]
        self.shape = (cfg.total_tiles * cfg.m_tile, cfg.width)
        self.ints = (cfg.n_channels, cfg.width, cfg.m_tile,
                     lane_octets(cfg.width))
        self.vec_ok = cfg.n_channels % 4 == 0
        self.checked: set = set()


_PLANS: dict = {}           # (id(layout), device) -> _Plan


def _pack_cuda(planes: dict, sq, pw, maps: dict,
               cfg: DrainPackerConfig) -> torch.Tensor:
    dev = sq.device
    plan = _PLANS.get((id(cfg), dev))
    if plan is None:
        key = (id(cfg), dev)
        plan = _PLANS[key] = _Plan(cfg, dev)
        weakref.finalize(cfg, _PLANS.pop, key, None)
    xs = [planes.get(n) for n in plan.names]
    ms = [maps.get(s) for s in plan.sels]
    status = maps.get("status")
    # the key holds everything _check reads: the layout (the plan's own,
    # so the memo lives and dies with the layout) and each tensor's
    # shape, dtype, device and contiguity
    checked_once(plan.checked, tensor_key(sq, pw, status, *xs, *ms),
                 lambda: _check(planes, sq, pw, maps, cfg, dev))
    # the six planes, then the audio, digital and raw maps (0: absent);
    # the OR of a group's pointers is 16-byte aligned when each is
    ptrs = [0] * 9
    planes_or = 0
    for i, x in zip(plan.x_slots, xs):
        ptrs[i] = p = x.data_ptr()
        planes_or |= p
    sp = maps_or = status.data_ptr()
    for i, m in zip(plan.m_slots, ms):
        ptrs[i] = p = m.data_ptr()
        maps_or |= p
    if maps_or % 16:
        raise ValueError("pack_kernel: the column maps must be 16-byte "
                         "aligned (the kernel reads 8 entries as two int4)")
    # dense runs of 8 columns load as two float4s: rows of a multiple of
    # 4 floats and 16-byte aligned planes
    vec = int(plan.vec_ok and planes_or % 16 == 0)
    out = torch.empty(plan.shape, dtype=torch.int16, device=dev)
    err = launch(load_library("drainpack").sd_drainpack, dev,
                 plan.table_ptr, plan.n_blocks, *ptrs, sp, sq.data_ptr(),
                 pw.data_ptr(), out.data_ptr(), *plan.ints, vec)
    if err != 0:
        raise RuntimeError(f"sd_drainpack launch failed: CUDA error {err}")
    return out


# the argument check runs in _pack_cuda, on the layout's own memo
pack_kernel = kernel("pack_kernel", _pack_cuda, pack_kernel_reference,
                     at=1, doc="""One pack (arguments as
    :func:`pack_kernel_reference`).""")


class DrainPacker:
    """Packs a bucket's entire per-block drain into one int16 fetch.
    Runs on ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg: DrainPackerConfig,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._maps = {"status": self._empty(cfg.width)}
        for sec, present in (("audio", cfg.has_audio),
                             ("digital", cfg.has_digital),
                             ("raw", cfg.has_raw)):
            if present:
                self._maps[sec] = self._empty(getattr(cfg, f"{sec}_width"))
        self._zrow = torch.zeros((1, cfg.n_channels), device=self.device)

    def _empty(self, n: int) -> torch.Tensor:
        return torch.full((n,), -1, dtype=torch.int32, device=self.device)

    def set_mapping(self, slots: list[int]) -> None:
        """All sections share one mapping (requires every per-section
        width == width, so no lane grouping is active).  The engine
        calls :meth:`set_mappings`; this one is the reference's API,
        which its ported status-precision test drives."""
        maps = {}
        for sec in self._maps:
            if sec == "status":
                continue
            assert self.cfg.group(sec) == 1, (
                "set_mapping needs ungrouped sections; use "
                "set_mappings for per-section widths")
            maps[sec] = slots
        self.set_mappings(slots, **maps)

    def set_mappings(self, status: list[int], *, audio=None,
                     digital=None, raw=None) -> None:
        """Per-section slot->column maps.  ``status`` covers every
        active slot (squelch + power rows); each section lists only
        the slots whose columns it drains.  The device lists are
        rewritten in place."""
        for sec, slots in (("status", status), ("audio", audio),
                           ("digital", digital), ("raw", raw)):
            dst = self._maps.get(sec)
            if dst is None:
                continue
            slots = slots or []
            assert len(slots) <= dst.numel(), (sec, slots, dst.numel())
            new = np.full(dst.numel(), -1, np.int32)
            new[:len(slots)] = np.asarray(slots, np.int64)
            dst.copy_(torch.from_numpy(new))

    def dispatch(self, *, audio=None, sq=None, pw=None, dig=None,
                 raw=None) -> torch.Tensor:
        """All device-resident; returns the device int16 pack."""
        cfg = self.cfg
        planes = {}
        if cfg.has_audio:
            assert audio is not None
            planes["audio"] = audio
        if cfg.has_digital:
            assert dig is not None and len(dig) == 3
            planes.update(zip(("d_sr", "d_si", "d_st"), dig))
        if cfg.has_raw:
            assert raw is not None and len(raw) == 2
            planes.update(zip(("y_re", "y_im"), raw))
        planes = {k: self._on_device(v) for k, v in planes.items()}
        return pack_kernel(planes,
                           self._zrow if sq is None else self._on_device(sq),
                           self._zrow if pw is None else self._on_device(pw),
                           self._maps, cfg)

    def _on_device(self, v) -> torch.Tensor:
        """``v`` as a tensor on the packer's device; a tensor already
        there passes as it is."""
        if isinstance(v, torch.Tensor) and v.device == self._zrow.device:
            return v
        return torch.as_tensor(v).to(self.device)

    def fetch(self, handle, buf: np.ndarray | None = None) -> dict:
        """ONE device-to-host copy → dequantized numpy sections (each at
        its own section width).  ``buf`` short-circuits the copy when
        the caller already pulled the pack."""
        cfg = self.cfg
        mt = cfg.m_tile
        if buf is None:
            buf = torch.as_tensor(handle).cpu().numpy()
        lay = {name: (t0, cnt, grp)
               for name, t0, cnt, grp in cfg.sections()}
        out: dict = {}

        def sect(name):
            """Un-group a section back to [rows, w_section]."""
            t0, cnt, grp = lay[name]
            b = buf[t0 * mt:(t0 + cnt) * mt]
            if grp == 1:
                return b
            ws = cfg.width // grp
            # lane group g of out tile `local` holds source tile
            # local*grp + g
            return (b.reshape(cnt, mt, grp, ws)
                     .transpose(0, 2, 1, 3)
                     .reshape(cnt * grp * mt, ws))

        if cfg.has_audio:
            out["audio"] = sect("audio").astype(np.float32) * (
                1.0 / A_SCALE)
        st0 = lay["status"][0] * mt
        st = buf[st0:st0 + 6].astype(np.float64)

        def dec3(r0):
            return ((st[r0] + st[r0 + 1] * (1.0 / 32768.0)
                     + st[r0 + 2] * (1.0 / (32768.0 * 32768.0)))
                    * (1.0 / S_SCALE)).astype(np.float32)

        out["sq"] = dec3(0)
        out["power"] = dec3(3)
        if cfg.has_digital:
            sr = sect("d_sr").astype(np.float32)
            si = sect("d_si").astype(np.float32)
            out["soft"] = (sr + 1j * si) * (1.0 / D_SCALE)
            out["strobe"] = sect("d_st") > (T_SCALE / 2)
        if cfg.has_raw:
            out["y_re"] = sect("y_re").astype(np.float32) * (
                1.0 / R_SCALE)
            out["y_im"] = sect("y_im").astype(np.float32) * (
                1.0 / R_SCALE)
        return out
