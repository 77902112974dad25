"""Training steps on a single device, and the tensor-parallel mesh of the
generation engine (one process drives every shard)."""
from .env import TPMesh, tp_mesh
from .hybrid import TrainStep
from .quantized_allreduce import (allreduce_sum, quantized_collective_bytes,
                                  quantized_matmul_allreduce,
                                  quantized_ring_allreduce)
from .sharding_annotations import (HeadSharding, gather_heads, kv_pool_spec,
                                   kv_scale_spec, shard_heads)

__all__ = ["HeadSharding", "TPMesh", "TrainStep", "allreduce_sum",
           "gather_heads", "kv_pool_spec", "kv_scale_spec",
           "quantized_collective_bytes", "quantized_matmul_allreduce",
           "quantized_ring_allreduce", "shard_heads", "tp_mesh"]
