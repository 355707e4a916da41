"""ZeRO over data-parallel ranks: the shard plan and its collectives
(``partition.py``, stages 1-3) and stage 3's gather on use (``prefetch.py``)."""

from .partition import (LeafShard, ShardedLeaf, ZeroPartition, leaf_shard,  # noqa: F401
                        shard_plan, stage3_plan, stage3_shard, storage_bytes)
