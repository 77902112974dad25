"""Scaled dot-product attention: the flash kernels where they apply, the
composite softmax(q·kᵀ)·v otherwise (the JAX package's
``ops/attention.py``)."""
import math

import torch

from .flash_attention import (flash_attention, mask_is_flash_compatible,
                              shapes_fit_kernels)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, return_weights=False,
                                 use_flash=None, generator=None):
    """q, k, v: [B, H, L, D].  attn_mask: additive float mask
    broadcastable to [B, H, Lq, Lk].  Returns ``(out, weights or None)``.

    ``use_flash`` (None means off: the port has no global flag) takes
    the flash kernels when there is no weight dropout, no weights are
    asked for, the mask varies only by batch and key, and the shapes fit
    the kernels.  Lq == 1 (one decode row) always takes the composite:
    its causal mask is all visible.  Causal masks align bottom-right
    (row i sees keys up to i + Lk - Lq); masked logits are -1e9.  Weight
    dropout draws from `generator`, which it then requires."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[-2] == 1:
        is_causal = False
        use_flash = False
    if use_flash and not return_weights and dropout_p == 0.0 \
            and mask_is_flash_compatible(attn_mask) \
            and shapes_fit_kernels(q.shape[-2], k.shape[-2], q.shape[-1]):
        return flash_attention(q, k, v, attn_mask=attn_mask,
                               causal=is_causal), None
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if attn_mask is not None:
        logits = logits + attn_mask
    if is_causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(lq, lk, dtype=torch.bool,
                            device=q.device).tril(lk - lq)
        logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
    weights = torch.softmax(logits, dim=-1)
    weights_d = weights
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit "
                             "torch.Generator: pass generator=")
        keep = torch.rand(weights.shape, generator=generator,
                          device=weights.device) < 1.0 - dropout_p
        weights_d = torch.where(keep, weights / (1.0 - dropout_p),
                                torch.zeros_like(weights))
    out = torch.einsum("bhqk,bhkd->bhqd", weights_d, v)
    return out, (weights if return_weights else None)
