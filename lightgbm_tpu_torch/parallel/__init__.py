"""Multi-device training — the port of ``lightgbm_tpu/parallel/``.

``mesh`` holds the device mesh, row sharding and the collectives over
per-shard lists; ``data_parallel`` the sharded row work the growers take
(``tree_learner="data"`` / ``"voting"`` and the 2-D mesh);
``feature_parallel`` the split exchange and the column sharding
(``tree_learner="feature"``).  :func:`set_virtual_devices` places ``n``
virtual shards on one device, the counterpart of the reference's virtual
CPU mesh.
"""

from .mesh import Mesh, set_virtual_devices

__all__ = ["Mesh", "set_virtual_devices"]
