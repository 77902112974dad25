"""The mesh, the collectives over its axes, the train steps over its
``data`` (ZeRO stages 0-3), ``model``, ``seq`` and ``expert`` axes and
the pipelined one over ``pipe`` (x ``data`` x ``model``), context
parallelism, and the tensor-parallel pieces of the generation engine;
one process drives every shard."""
from .collective import (Group, P2POp, ReduceOp, all_gather, all_reduce,
                         alltoall, barrier, batch_isend_irecv, broadcast,
                         get_group, irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send, wait)
from .context_parallel import (context_parallel_attention,
                               seq_axis_in_scope, seq_chunk_offset)
from .data_parallel import DataParallel
from .env import (Mesh, ParallelEnv, TPMesh, build_mesh, get_rank,
                  get_world_size, global_mesh, init_parallel_env,
                  is_initialized, set_global_mesh, tp_mesh)
from .hybrid import (CompiledTrainStep, TrainStep, make_fused_update,
                     zero_shard_update)
from .pipeline_compile import GPTPipeAdapter, PipelinedTrainStep, PipeStagePlan
from .quantized_allreduce import (allreduce_sum, quantized_collective_bytes,
                                  quantized_matmul_allreduce,
                                  quantized_ring_allreduce)
from .sharding_annotations import (HeadSharding, gather_heads, kv_pool_spec,
                                   kv_scale_spec, shard_heads)
from .topology import CommunicateTopology, HybridCommunicateGroup, ParallelMode

__all__ = [
    "CommunicateTopology", "CompiledTrainStep", "DataParallel",
    "GPTPipeAdapter", "Group", "HeadSharding", "HybridCommunicateGroup",
    "Mesh", "P2POp", "ParallelEnv", "ParallelMode", "PipeStagePlan",
    "PipelinedTrainStep", "ReduceOp", "TPMesh", "TrainStep", "all_gather",
    "all_reduce", "allreduce_sum", "alltoall", "barrier",
    "batch_isend_irecv", "broadcast", "build_mesh",
    "context_parallel_attention", "gather_heads",
    "get_group", "get_rank", "get_world_size", "global_mesh",
    "init_parallel_env", "irecv", "is_initialized", "isend", "kv_pool_spec",
    "kv_scale_spec", "make_fused_update", "new_group",
    "quantized_collective_bytes", "quantized_matmul_allreduce",
    "quantized_ring_allreduce", "recv", "reduce", "reduce_scatter",
    "scatter", "send", "seq_axis_in_scope", "seq_chunk_offset",
    "set_global_mesh", "shard_heads", "tp_mesh", "wait", "zero_shard_update"]
