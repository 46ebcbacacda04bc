"""Multi-device execution of the port (counterpart of
``sigdigger_tpu/parallel``).

One process drives a :class:`~.banks.Mesh`, a grid of ``torch.device``s
(the reference's ``Mesh`` plus ``shard_map`` has one controller too):
``banks`` shards the kernel banks and the PSD on the channel axis,
``timebanks`` adds the time axis, ``sharding`` shards the functional
pipeline, and ``distributed`` spans the channel axis over processes
with ``torch.distributed``.
"""

from sigdigger_tpu_torch.parallel import distributed
from sigdigger_tpu_torch.parallel.banks import (
    Mesh,
    make_ch_mesh,
    shard_audio_bank,
    shard_psd,
    shard_raw_bank,
    shard_recovery_bank,
)
from sigdigger_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_pipeline,
    sharded_pipeline_step,
)

__all__ = ["make_mesh", "shard_pipeline", "sharded_pipeline_step",
           "distributed", "make_ch_mesh", "shard_audio_bank",
           "shard_psd", "shard_raw_bank", "shard_recovery_bank", "Mesh"]
