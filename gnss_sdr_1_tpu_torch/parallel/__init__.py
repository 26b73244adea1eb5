"""Multi-device sharding: channel data-parallelism, time blocks with a halo
exchange, and hosts joined by torch.distributed.

The port's counterpart of `gnss_sdr_1_tpu/parallel/`.  Satellite channels
shard across a mesh of devices ('channel' axis), each shard an ordinary
`TrackingEngine` on its device; the acquisition grid splits its PRN rows
the same way; a long IQ stream shards over a 'time' axis, the blocks joined
by an overlap-save halo exchange.  One process drives its local devices;
`init_distributed` joins hosts (NCCL on the card, gloo on the CPU).
"""

from .sharded import (
    ChannelShardedAcquisition,
    ChannelShardedEngine,
    freq_xlating_fir_time_sharded,
)
from .sharding import (
    ChannelShards,
    Mesh,
    channel_mesh,
    gather_channel_tree,
    halo_exchange_blocks,
    host_channel_mesh,
    init_distributed,
    replicate,
    shard_channel_tree,
    shard_host_channel_tree,
    time_mesh,
)

__all__ = [
    "channel_mesh", "shard_channel_tree", "replicate", "time_mesh",
    "halo_exchange_blocks", "init_distributed", "host_channel_mesh",
    "shard_host_channel_tree",
    "Mesh", "ChannelShards", "gather_channel_tree", "ChannelShardedEngine",
    "ChannelShardedAcquisition", "freq_xlating_fir_time_sharded",
]
