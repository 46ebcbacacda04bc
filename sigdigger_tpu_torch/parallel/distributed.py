"""Multi-process runtime for the sharded receiver (counterpart of
``sigdigger_tpu/parallel/distributed.py``).

The reference scales past one host with JAX's multi-process runtime.
The port's multi-process layer is ``torch.distributed``, and it spans
only the axis that needs no per-step collective:

- :func:`initialize` — ``torch.distributed.init_process_group``,
  idempotent, a no-op for a single process; ``gloo`` where a process
  has no card of its own (CPU devices, or several ranks sharing one
  card: NCCL refuses two ranks on one card), ``nccl`` where each rank
  has one;
- :func:`make_hybrid_mesh` — a ("time", "ch") mesh whose **time** axis
  (halos and PSD sums every block) stays within a process and whose
  **ch** axis (channels are independent) spans processes.  Each process
  drives its own cells (``Mesh.ranks``), so a step exchanges nothing
  between processes;
- :func:`host_array` — the block each process feeds (the reference's
  per-host scatter into a global array);
- :func:`local_outputs` — this process's output shards, i.e. the
  result gather is implicit: every process drains exactly the channels
  it serves.

Usage (the same program in every process):

    distributed.initialize("localhost:PORT", n_procs, pid)
    mesh = distributed.make_hybrid_mesh(n_time=4, devices=local_devs)
    step = shard_pipeline(cfg, mesh)(consts, state)
    state, out = step(consts, state, distributed.host_array(mesh, None, x))
    audio = distributed.local_outputs(out["audio"])
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sigdigger_tpu_torch.parallel.banks import (
    Mesh,
    default_devices,
    process_index,
)
from sigdigger_tpu_torch.parallel.sharding import LocalShards

_initialized = False


def _backend(num_processes: int) -> str:
    """``nccl`` when every rank can have a card of its own, else
    ``gloo``."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Bring up the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0.  With no process
    count the environment's ``WORLD_SIZE``/``RANK`` are read; one
    process is a no-op."""
    global _initialized
    if _initialized:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1:
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    torch.distributed.init_process_group(
        backend or _backend(num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _initialized = True


def shutdown() -> None:
    """Leave the process group (the counterpart of the reference's
    process exit)."""
    global _initialized
    if _initialized and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _initialized = False


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def make_hybrid_mesh(n_time: int | None = None, n_ch: int | None = None,
                     devices=None) -> Mesh:
    """("time", "ch") mesh with time within a process, ch across.

    ``devices`` are THIS process's devices (every visible card by
    default; the reference takes the global list, which no process here
    can drive): every process contributes the same number, laid out as
    a local grid ``[n_time, per_proc // n_time]``, and the channel axis
    concatenates the processes' grids in rank order."""
    local = list(devices if devices is not None else default_devices())
    n_proc = process_count()
    per_proc = len(local)
    total = per_proc * n_proc
    if n_time is None:
        n_time = per_proc if n_ch is None else total // n_ch
    if n_ch is None:
        n_ch = total // n_time
    if n_time * n_ch != total:
        raise ValueError(f"{n_time}x{n_ch} != {total} devices")
    if n_time > per_proc or per_proc % n_time:
        raise ValueError(
            f"time axis ({n_time}) exchanges halos every block and must "
            f"fit within one process's devices ({per_proc})")
    grid = np.empty((per_proc // n_time, n_time), dtype=object)
    grid.flat[:] = local
    cols = [grid.T] * n_proc
    ranks = [np.full(grid.T.shape, r) for r in range(n_proc)]
    return Mesh(np.concatenate(cols, axis=1), axis_names=("time", "ch"),
                ranks=np.concatenate(ranks, axis=1))


def host_array(mesh: Mesh, spec, local_data, global_shape=None):
    """The block this process feeds.  For the receiver input (split on
    "time", replicated on "ch") every process passes the SAME full
    block and gets it back as a tensor; for channel-major data each
    process passes its channels' rows and ``global_shape``, and they are
    placed at :func:`process_channels` of a zero array."""
    data = torch.as_tensor(np.asarray(local_data))
    if global_shape is None or tuple(global_shape) == tuple(data.shape):
        return data
    out = torch.zeros(tuple(global_shape), dtype=data.dtype)
    out[process_channels(mesh, global_shape[0])] = data
    return out


def local_outputs(arr) -> list[tuple[tuple, np.ndarray]]:
    """This process's output shards as (index, data) pairs — the
    implicit result gather: each process consumes its own channels."""
    if isinstance(arr, LocalShards):
        return [(index, t.cpu().numpy()) for index, t in arr.shards]
    return [((slice(None),) * arr.dim(), arr.cpu().numpy())]


def process_channels(mesh: Mesh, n_channels: int) -> slice:
    """The contiguous channel range this process's cells own when
    ``[C]``-leading arrays are split on "ch"."""
    n_ch = mesh.shape["ch"]
    per = n_channels // n_ch
    mine = [j for j in range(n_ch) if mesh.ranks[0, j] == process_index()]
    if not mine:
        return slice(0, 0)
    return slice(min(mine) * per, (max(mine) + 1) * per)
