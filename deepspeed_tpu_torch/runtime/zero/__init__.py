"""ZeRO over data-parallel ranks (stages 1 and 2): the shard plan and its
collectives (``partition.py``)."""

from .partition import (LeafShard, ShardedLeaf, ZeroPartition, leaf_shard,  # noqa: F401
                        shard_plan, storage_bytes)
