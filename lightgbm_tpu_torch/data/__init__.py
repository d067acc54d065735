"""Data-side helpers of the port beside ``Dataset``: for now only the binning
schema's fingerprint (:func:`.sketch.schema_digest`), which checkpoints carry.

The reference's out-of-core stack (the GK sketch, ``StreamingBinMapperBuilder``,
``BlockStore``, ``Dataset.from_blocks``) is ROADMAP slice 5, item 11.
"""

from .sketch import schema_digest

__all__ = ["schema_digest"]
