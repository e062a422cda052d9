"""Multi-chip / multi-host parallelism.

The reference's parallelism is threads claiming range windows under a
mutex (keyhunt.cpp:3824-3841) plus a shared read-only bloom/table. The
mesh re-design (SURVEY.md §2.4):

- ``partition``: deterministic static range partitioning (replaces the
  lock; capability of the bodiless reference RangePartitioner,
  include/keyhunt/core/distributed.h:307-345 — here it actually works).
- ``mesh``: shard_map'd BSGS search over a device mesh — every device owns
  a disjoint range slice (data parallel over the 'shard' axis), the baby
  table and stride tables are replicated, and hit counts are aggregated
  with a psum across the devices.
- ``brute_mesh``: the same range sharding for the brute/hash modes —
  every device runs the fused walk+hash+membership chunk on its slice.
"""

from .partition import RangePartitioner, RangeSlice  # noqa: F401
from .mesh import ShardedBSGSEngine, ShardedTableBSGSEngine  # noqa: F401
from .brute_mesh import ShardedBruteEngine  # noqa: F401
