"""Autoregressive generation on the ragged and legacy steps: paged KV
cache, continuous-batching scheduler, sampling, and the engine that
composes them (engine.py documents the flow)."""
from .decode_attention import (chunk_prefill_attention,
                               chunk_prefill_attention_reference,
                               dense_causal_reference,
                               paged_decode_attention,
                               paged_decode_attention_reference,
                               ragged_paged_attention,
                               ragged_paged_attention_reference)
from .engine import (DEFAULT_PREFILL_CHUNK_TOKENS, GenerationConfig,
                     GenerationEngine, GenerationHandle, GenerationResult)
from .fused import (ChunkedPrefillStep, FusedDecodeStep, RaggedStep,
                    decode_batch_menu)
from .kv_cache import (DeviceKVPool, OutOfPagesError, PagedKVCache,
                       UnknownSequenceError, scatter_pool_update)
from .metrics import GenerationMetrics
from .model import TinyCausalLM, params_from_numpy
from .sampling import (SampleStream, SamplingParams, hash_uniform,
                       sample_token, sample_tokens_batch)
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        SequenceState)

__all__ = [
    "DEFAULT_PREFILL_CHUNK_TOKENS", "ChunkedPrefillStep",
    "ContinuousBatchingScheduler", "DeviceKVPool", "FusedDecodeStep",
    "GenerationConfig", "GenerationEngine", "GenerationHandle",
    "GenerationMetrics", "GenerationRequest", "GenerationResult",
    "OutOfPagesError", "PagedKVCache", "RaggedStep", "SampleStream",
    "SamplingParams", "SequenceState", "TinyCausalLM",
    "UnknownSequenceError", "chunk_prefill_attention",
    "chunk_prefill_attention_reference", "decode_batch_menu",
    "dense_causal_reference", "hash_uniform", "paged_decode_attention",
    "paged_decode_attention_reference", "params_from_numpy",
    "ragged_paged_attention", "ragged_paged_attention_reference",
    "sample_token", "sample_tokens_batch", "scatter_pool_update",
]
