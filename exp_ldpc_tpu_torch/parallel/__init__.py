"""Device parallelism: shot sharding, check-partition sharding,
rounds-axis sharding, and the fused sample+decode pipeline, over
``torch.distributed`` process groups (``mesh.py``).  The names and
``__all__`` of ``exp_ldpc_tpu/parallel/__init__.py``.
"""
from .check_shard import ShardedBPDecoder, ShardedTanner
from .mesh import DATA_AXIS, MODEL_AXIS, init_distributed, make_mesh
from .pipeline import StorageDecodePipeline
from .rounds_shard import RoundsShardedSpacetimeBP

# the K4 check-partition decoder lives in exp_ldpc_tpu_torch.decoders.bp_bsr_shard
# (it depends on .mesh for the axis names; decoders/__init__ imports it last)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "init_distributed",
    "make_mesh",
    "StorageDecodePipeline",
    "ShardedBPDecoder",
    "ShardedTanner",
    "RoundsShardedSpacetimeBP",
]
