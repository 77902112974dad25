"""Transformer layers: the JAX package's ``nn/layers/transformer.py``
(multi-head attention with its caches, the encoder and decoder layers and
stacks, and the encoder-decoder ``Transformer``).

Attention goes through ``ops/attention.py::scaled_dot_product_attention``
on its composite path, as the JAX layer's does by default; weight dropout
and the dropout layers draw from the generator passed down each call.
Masks are additive and broadcast to [B, H, Lq, Lk]; a bool or integer
mask becomes 0 where set and -1e9 elsewhere, in q's dtype.  As in the
reference, `TransformerEncoder` and `TransformerDecoder` fill layers 1..N-1
with deep copies of the layer they are given, so every layer starts with
the same weights.  Weights are drawn from the `generator` each layer is
built with (``layers.py``); ParamAttr arguments (``weight_attr``,
``bias_attr``) are not ported.  ``scan_layers=True`` runs the encoder's
layers through ``scan_stack.scan_layer_stack``."""
import collections
import copy

import torch
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from . import functional as F
from .layers import Dropout, LayerNorm, Linear
from .scan_stack import scan_layer_stack


def _convert_attention_mask(attn_mask, dtype):
    """A bool or integer mask as 0 (set) / -1e9 (unset) in `dtype`; a
    float mask unchanged."""
    if attn_mask is None or attn_mask.is_floating_point():
        return attn_mask
    keep = attn_mask if attn_mask.dtype == torch.bool else attn_mask != 0
    return torch.where(keep, 0.0, -1e9).to(dtype)


def _stack(layer, num_layers):
    return nn.ModuleList([layer] + [copy.deepcopy(layer)
                                    for _ in range(num_layers - 1)])


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections.  ``Cache`` (k, v) grows by the new
    keys each call; ``StaticCache`` holds projected keys and values that
    are reused as they are (cross attention)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, generator):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.k_proj = Linear(self.kdim, embed_dim, generator=generator)
        self.v_proj = Linear(self.vdim, embed_dim, generator=generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator)

    def _split_heads(self, x):
        b, length = x.shape[0], x.shape[1]
        return x.reshape(b, length, self.num_heads,
                         self.head_dim).permute(0, 2, 1, 3)

    @staticmethod
    def _merge_heads(x):
        b, h, length, d = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, length, h * d)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(key if value is None
                                              else value))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], self.num_heads, 0, self.head_dim,
                            device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, generator=None):
        """Returns out, then the weights if `need_weights`, then the grown
        ``Cache`` if one was given: a tuple when more than out."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)
        out, weights = scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, q.dtype),
            dropout_p=self.dropout if self.training else 0.0,
            return_weights=self.need_weights, generator=generator)
        outs = [self.out_proj(self._merge_heads(out))]
        if self.need_weights:
            outs.append(weights)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return outs[0] if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward block, each with a residual;
    LayerNorm after each (post-norm) or before (``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, generator):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None, generator=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask,
                                 generator=generator)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache,
                                        generator=generator)
        src = residual + self.dropout1(src, generator)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src)),
                                        generator))
        src = residual + self.dropout2(src, generator)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None,
                 scan_layers=False):
        super().__init__()
        self.layers = _stack(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm
        # the JAX encoder's lax.scan over the layers: here a loop with the
        # scan's arithmetic (nn/scan_stack.py)
        self.scan_layers = scan_layers

    def forward(self, src, src_mask=None, cache=None, generator=None):
        output = src
        new_caches = []
        if self.scan_layers and cache is None and self.num_layers > 1:
            output = scan_layer_stack(self.layers, output, mask=src_mask,
                                      generator=generator)
            return output if self.norm is None else self.norm(output)
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask, generator=generator)
            else:
                output, new_cache = layer(output, src_mask, cache[i],
                                          generator=generator)
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over `memory`, then a feed-forward
    block, each with a residual and a LayerNorm as in the encoder
    layer."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, generator):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            generator=generator)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout,
                                             generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, generator=None):
        """`cache`: (the self-attention ``Cache``, the cross-attention
        ``StaticCache``), as `gen_cache` makes it."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                 generator=generator)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0], generator=generator)
        tgt = residual + self.dropout1(tgt, generator)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1],
                              generator=generator)
        if isinstance(tgt, tuple):
            tgt = tgt[0]
        tgt = residual + self.dropout2(tgt, generator)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt)),
                                        generator))
        tgt = residual + self.dropout3(tgt, generator)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, cache[1]))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, generator=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask,
                               generator=generator)
            else:
                output, new_cache = layer(output, memory, tgt_mask,
                                          memory_mask, cache[i],
                                          generator=generator)
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """An encoder over `src` and a decoder over `tgt` reading the
    encoder's output; a final LayerNorm on each with
    ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, custom_encoder=None,
                 custom_decoder=None, *, generator):
        super().__init__()
        layer_args = (d_model, nhead, dim_feedforward, dropout, activation,
                      attn_dropout, act_dropout, normalize_before)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*layer_args, generator=generator),
                num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*layer_args, generator=generator),
                num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None, generator=None):
        memory = self.encoder(src, src_mask, generator=generator)
        return self.decoder(tgt, memory, tgt_mask, memory_mask,
                            generator=generator)

    def generate_square_subsequent_mask(self, length):
        """[length, length] float32, 0 on and below the diagonal and -inf
        above it, on the model's device."""
        device = next(self.parameters()).device
        return torch.full((length, length), -torch.inf,
                          device=device).triu(1)
