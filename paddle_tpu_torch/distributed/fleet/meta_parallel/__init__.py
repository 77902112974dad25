"""The tensor-parallel layers, the RNG trackers and the mixture of
experts (``paddle_tpu/distributed/fleet/meta_parallel``)."""
from .moe_layer import EXPERT_AXIS, MoELayer
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding,
                        copy_to_model_parallel)
from .random_rng import (MODEL_PARALLEL_RNG, RNGStatesTracker,
                         get_rng_state_tracker, model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "EXPERT_AXIS", "MODEL_PARALLEL_RNG",
           "MoELayer", "ParallelCrossEntropy", "RNGStatesTracker",
           "RowParallelLinear", "VocabParallelEmbedding",
           "copy_to_model_parallel", "get_rng_state_tracker",
           "model_parallel_random_seed"]
