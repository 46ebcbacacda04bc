"""Channel-sharded kernel banks over a device mesh (counterpart of
``sigdigger_tpu/parallel/banks.py``).

The reference shards the banks behind ``KernelAnalyzer`` (raw, audio,
recovery) and the four-step PSD over a ``jax.sharding.Mesh`` with
``shard_map``: every per-channel constant column and state plane is
split on the channel axis, the framed input is replicated, and each
shard runs the same kernel built for its local channel count.  The PSD
shards its frames instead and sums the partial ``[A, B]`` folds.

The port keeps that design with one controller: a :class:`Mesh` is a
grid of ``torch.device``s driven by this process.  ``shard_*`` replaces
the bank's ``_call`` on the instance with a launch per shard: the
shard's columns of every per-channel constant and carry are copied to
its device, the kernel runs there at the local width, and the outputs
are joined on the bank's own device in shard order.  The column copies
of the constants are cached until the bank uploads new ones, so
``configure_channel`` (open, retune, close) keeps working without
rebuilding anything — the reference's contract.

A mesh may name one device more than once: ``[torch.device("cpu")] * 4``
runs four shards on the CPU (the tests), ``[cuda:0] * 2`` two shards on
one card.  Shards on one device run one after another on its stream;
each gets its own column copies, so no shard's constants or carries
alias another's.
"""

from __future__ import annotations

import numpy as np
import torch

from sigdigger_tpu_torch.backend import resolve_device
# the wrappers are looked up on their modules at call time, as the
# unsharded banks do
from sigdigger_tpu_torch.kernels import audio, fft, rawbank, recovery
from sigdigger_tpu_torch.kernels.tcsplit import tc_bmat


class Mesh:
    """A grid of ``torch.device``s with named axes, driven by one
    process (the reference's ``jax.sharding.Mesh``): ``devices`` is the
    object ndarray, ``axis_names`` its axes and ``shape[name]`` their
    sizes.  A CUDA device without a card raises."""

    def __init__(self, devices, axis_names: tuple[str, ...],
                 ranks=None) -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_device(d) for d in grid.flat]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        # the process that drives each cell (parallel/distributed.py);
        # one process drives them all by default
        self.ranks = (np.zeros(grid.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))

    def local(self) -> np.ndarray:
        """Which cells this process drives."""
        return self.ranks == process_index()

    @property
    def home(self) -> torch.device:
        """The first device: a meshed session's carries and outputs live
        there."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def default_devices() -> list[torch.device]:
    """Every visible CUDA device (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_ch_mesh(n_ch: int, devices=None) -> Mesh:
    """A 1-D ("ch",) mesh over ``n_ch`` devices: every visible card by
    default; an explicit list may repeat a device."""
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if len(devices) < n_ch:
        raise ValueError(f"need {n_ch} devices, have {len(devices)}")
    return Mesh(devices[:n_ch], axis_names=("ch",))


def _local_channels(n_channels: int, n_shards: int) -> int:
    """Channels a shard holds (the reference also picks a channel tile,
    which the port's kernels do not take)."""
    if n_channels % n_shards:
        raise ValueError(
            f"n_channels {n_channels} not divisible by mesh size "
            f"{n_shards}")
    return n_channels // n_shards


class ColumnShards:
    """A bank's per-channel tensors split into ``n`` column blocks, each
    copied to a device; the copies of the constants are cached until the
    bank uploads a new dict (``configure_channel`` does)."""

    def __init__(self, n_channels: int, n: int, col_keys: tuple[str, ...],
                 derive=None) -> None:
        self.local_c = _local_channels(n_channels, n)
        self.col_keys = col_keys
        self._derive = derive
        self._src = None
        self._cache: dict = {}

    def cols(self, t: torch.Tensor, s: int, dev: torch.device
             ) -> torch.Tensor:
        """Columns of shard ``s`` of ``t [..., C]``, contiguous on
        ``dev``."""
        lc = self.local_c
        return t[..., s * lc:(s + 1) * lc].to(dev).contiguous()

    def consts(self, consts: dict, s: int, dev: torch.device) -> dict:
        if consts is not self._src:
            self._src, self._cache = consts, {}
        key = (s, dev)
        if key not in self._cache:
            local = {k: (self.cols(v, s, dev) if k in self.col_keys
                         else v.to(dev)) for k, v in consts.items()}
            if self._derive is not None:
                self._derive(local)
            self._cache[key] = local
        return self._cache[key]


def join(parts, home: torch.device, dim: int = -1) -> torch.Tensor:
    """The shards' outputs joined on ``home`` in shard order."""
    return torch.cat([p.to(home) for p in parts], dim=dim)


def _derive_bmat(local: dict) -> None:
    # the tensor-core B of the shard's own columns
    local["bmat"] = tc_bmat(local["h_re"], local["h_im"])


def replicate(t: torch.Tensor, devices) -> dict:
    """One copy of ``t`` per distinct device (the replicated input)."""
    return {d: t.to(d) for d in dict.fromkeys(devices)}


def shard_raw_bank(bank, mesh: Mesh, axis: str = "ch"):
    """Shard a ``kernels.rawbank.RawBank`` over ``mesh[axis]`` in place."""
    devs = axis_devices(mesh, axis)
    shards = ColumnShards(bank.cfg.n_channels, mesh.shape[axis],
                          ("h_re", "h_im", "theta"), _derive_bmat)
    home = bank.device
    p = bank.params

    def call(xr, xi, consts, phi0):
        xrs, xis = replicate(xr, devs), replicate(xi, devs)
        outs = []
        for s, dev in enumerate(devs):
            c = shards.consts(consts, s, dev)
            outs.append(rawbank.raw_kernel(
                xrs[dev], xis[dev], c["h_re"], c["h_im"], c["theta"],
                shards.cols(phi0, s, dev), p, c["bmat"]))
        return tuple(join(o, home) for o in zip(*outs))

    bank._call = call
    bank.mesh = mesh
    return bank


# the audio bank's per-channel constants; the rest (the band matrix, its
# taps and the DC matrices) are replicated
AUDIO_COLS = ("h_re", "h_im", "params", "taps2")


def shard_audio_bank(bank, mesh: Mesh, axis: str = "ch"):
    """Shard a ``kernels.audio.AudioBank`` over ``mesh[axis]`` in place."""
    devs = axis_devices(mesh, axis)
    shards = ColumnShards(bank.cfg.n_channels, mesh.shape[axis], AUDIO_COLS)
    home = bank.device
    p = bank.params

    def call(xr, xi, consts, carries, phi0, phs0):
        xrs, xis = replicate(xr, devs), replicate(xi, devs)
        outs = []
        for s, dev in enumerate(devs):
            outs.append(audio.audio_kernel(
                xrs[dev], xis[dev], shards.consts(consts, s, dev),
                tuple(shards.cols(t, s, dev) for t in carries),
                shards.cols(phi0, s, dev), shards.cols(phs0, s, dev), p))
        return tuple(join(o, home) for o in zip(*outs))

    bank._call = call
    bank.mesh = mesh
    return bank


def shard_recovery_bank(bank, mesh: Mesh, axis: str = "ch"):
    """Shard a ``kernels.recovery.RecoveryBank`` over ``mesh[axis]`` in
    place.  Its inputs are the raw bank's planes, split by columns."""
    devs = axis_devices(mesh, axis)
    shards = ColumnShards(bank.cfg.n_channels, mesh.shape[axis],
                          ("params", "mf"))
    home = bank.device
    p = bank.params

    def call(y_re, y_im, state, consts):
        outs = []
        for s, dev in enumerate(devs):
            c = shards.consts(consts, s, dev)
            outs.append(recovery.recovery_kernel(
                shards.cols(y_re, s, dev), shards.cols(y_im, s, dev),
                shards.cols(state, s, dev), c["params"], c["mf"], p))
        return tuple(join(o, home) for o in zip(*outs))

    bank._call = call
    bank.mesh = mesh
    return bank


def shard_psd(psd, mesh: Mesh, axis: str = "ch"):
    """Shard a ``kernels.fft.PSD``'s *frames* over ``mesh[axis]``: each
    shard folds power over its frames with the GLOBAL normalization and
    the partial ``[A, B]`` folds are summed in shard order on the PSD's
    device (the reference's one ``psum``)."""
    cfg = psd.cfg
    n = mesh.shape[axis]
    fb = cfg.frames_per_program
    if cfg.frames_per_block % (n * fb):
        raise ValueError(
            f"frames_per_block {cfg.frames_per_block} not divisible by "
            f"mesh size x frames_per_program = {n}x{fb}")
    devs = axis_devices(mesh, axis)
    consts = {d: {k: v.to(d) for k, v in psd.consts.items()}
              for d in dict.fromkeys(devs)}
    width = cfg.frames_per_block // n * cfg.b
    home = psd.device

    def call(xp):
        out = None
        for s, dev in enumerate(devs):
            part = fft.psd_kernel(
                xp[:, s * width:(s + 1) * width].to(dev).contiguous(),
                consts[dev], psd.params).to(home)
            out = part if out is None else out + part
        return out

    psd._call = call
    psd.mesh = mesh
    return psd


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis`` at index 0 of every other axis."""
    i = mesh.axis_names.index(axis)
    idx = [0] * len(mesh.axis_names)
    out = []
    for j in range(mesh.shape[axis]):
        idx[i] = j
        out.append(mesh.devices[tuple(idx)])
    return out

