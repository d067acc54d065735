"""Out-of-core data of the port: streaming BinMapper construction (a
mergeable quantile sketch, :mod:`.sketch`), host-resident binned blocks
with their prefetch to the card (:mod:`.block_store`), and the streamed
per-block growers and rounds (:mod:`.stream_grow`).  The streamed
data-parallel composition (``data/stream_dp.py``) is ROADMAP slice 6,
item 12b.
"""

from .block_store import BlockStore, ColumnViewStore, OOCBlockError
from .sketch import GKSummary, StreamingBinMapperBuilder, schema_digest
from .stream_grow import stream_goss_round, stream_grow_tree, stream_plain_round

__all__ = [
    "BlockStore",
    "ColumnViewStore",
    "OOCBlockError",
    "GKSummary",
    "schema_digest",
    "StreamingBinMapperBuilder",
    "stream_goss_round",
    "stream_grow_tree",
    "stream_plain_round",
]
