"""Attention over the paged KV cache, and the dense causal oracle.

Under the JAX package's names, each of the three paged attentions is its
kernel's wrapper (ops/paged_attention.py), which sends CUDA tensors
through the hand-written kernel and CPU tensors through its plain
PyTorch version (the ``*_reference`` names):

- ``ragged_paged_attention``: the ragged step's packed decode rows and
  prefill chunks;
- ``paged_decode_attention``: one query row per sequence (the legacy
  step's fused and eager decode);
- ``chunk_prefill_attention``: one sequence's prefill chunk (the legacy
  step's ChunkedPrefillStep); ``chunk_prefill_attention_reference`` is
  its dense core over keys already gathered in position order, the JAX
  reference's signature.

Each takes ``k_scale`` / ``v_scale``, the ``[P, H]`` scales of an int8
pool (``DeviceKVPool.layer_scales``), and refuses an int8 pool without
them or scales with a float pool.  Each takes ``mesh=`` too: under a
tensor-parallel mesh the pools, scales and queries are lists of head
shards and the call runs once per shard, returning the output shards.

Their masking makes padded keys contribute exactly zero
(``exp(NEG_INF - m)`` underflows to 0.0), so padding the key or
descriptor axis never changes a live row beyond float reassociation.
"""
import math

import torch

from ..ops.paged_attention import (
    NEG_INF,
    chunk_prefill_attention_dense as chunk_prefill_attention_reference,
    chunk_prefill_attention_kernel as chunk_prefill_attention,
    paged_decode_attention_kernel as paged_decode_attention,
    paged_decode_attention_torch as paged_decode_attention_reference,
    ragged_paged_attention_kernel as ragged_paged_attention,
    ragged_paged_attention_torch as ragged_paged_attention_reference)


def dense_causal_reference(q, k, v, scale=None):
    """Dense causal full-recompute attention for ONE sequence: q, k, v
    [T, H, D]; row t attends over keys [0, t].  Returns [T, H, D]."""
    t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("qhd,khd->hqk", q, k) * scale
    causal = (torch.arange(t, device=q.device)[:, None]
              >= torch.arange(t, device=q.device)[None, :])
    logits = torch.where(causal[None], logits,
                         torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", weights, v)


__all__ = ["NEG_INF", "chunk_prefill_attention",
           "chunk_prefill_attention_reference", "dense_causal_reference",
           "paged_decode_attention", "paged_decode_attention_reference",
           "ragged_paged_attention", "ragged_paged_attention_reference"]
