"""Out-of-core data of the port: streaming BinMapper construction (a
mergeable quantile sketch, :mod:`.sketch`), host-resident binned blocks
with their prefetch to the card (:mod:`.block_store`), and the streamed
per-block grower and rounds (:mod:`.stream_grow`), and their composition
with a row mesh, a row source of the same grower: per-shard block stores
and one histogram merge per block-round (:mod:`.stream_dp`).
"""

from .block_store import (BlockStore, ColumnViewStore, OOCBlockError,
                          shard_block_store)
from .sketch import GKSummary, StreamingBinMapperBuilder, schema_digest
from .stream_dp import (StreamMesh, choose_stream_dp_devices,
                        drain_shard_odometers, setup_stream_shards,
                        stream_dp_goss_round)
from .stream_grow import (SerialSource, stream_goss_round, stream_grow_tree,
                          stream_plain_round)

__all__ = [
    "BlockStore",
    "ColumnViewStore",
    "OOCBlockError",
    "GKSummary",
    "schema_digest",
    "SerialSource",
    "StreamMesh",
    "StreamingBinMapperBuilder",
    "choose_stream_dp_devices",
    "drain_shard_odometers",
    "setup_stream_shards",
    "shard_block_store",
    "stream_dp_goss_round",
    "stream_goss_round",
    "stream_grow_tree",
    "stream_plain_round",
]
