"""Autoregressive generation on the ragged and legacy steps: paged KV
cache, continuous-batching scheduler, sampling (host and device),
speculative decoding, the host-free decode loop, and the engine that
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
from .fused import (ChunkedPrefillStep, FusedDecodeStep,
                    LoopedRaggedStep, RaggedStep, decode_batch_menu)
from .kv_cache import (DeviceKVPool, KVQuantMismatchError,
                       OutOfPagesError, PagedKVCache, UnknownSequenceError,
                       compact_prefix_deltas, page_chain_hash,
                       scatter_pool_update)
from .metrics import GenerationMetrics
from .model import TinyCausalLM, params_from_numpy
from .sampling import (SampleStream, SamplingParams, hash_uniform,
                       hash_uniform_device, sample_token,
                       sample_tokens_batch, sample_tokens_device)
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        SequenceState)
from .speculation import NgramIndex, NgramProposer, verify_accept

__all__ = [
    "DEFAULT_PREFILL_CHUNK_TOKENS", "ChunkedPrefillStep",
    "ContinuousBatchingScheduler", "DeviceKVPool", "FusedDecodeStep",
    "GenerationConfig", "GenerationEngine", "GenerationHandle",
    "GenerationMetrics", "GenerationRequest", "GenerationResult",
    "KVQuantMismatchError", "LoopedRaggedStep", "NgramIndex", "NgramProposer", "OutOfPagesError",
    "PagedKVCache", "RaggedStep", "SampleStream",
    "SamplingParams", "SequenceState", "TinyCausalLM",
    "UnknownSequenceError", "chunk_prefill_attention",
    "chunk_prefill_attention_reference", "compact_prefix_deltas",
    "decode_batch_menu",
    "dense_causal_reference", "hash_uniform", "hash_uniform_device",
    "paged_decode_attention",
    "page_chain_hash", "paged_decode_attention_reference",
    "params_from_numpy",
    "ragged_paged_attention", "ragged_paged_attention_reference",
    "sample_token", "sample_tokens_batch", "sample_tokens_device",
    "scatter_pool_update", "verify_accept",
]
