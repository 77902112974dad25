"""GPT, the decoder-only transformer the JAX package trains
(``paddle_tpu/models/gpt.py``), on one device or over a group of
tensor-, context- and expert-parallel ranks.

Called on tensors, every layer computes with its whole weights.  Called
on per-rank lists inside a ``distributed.spmd`` scope (the train steps
do that for a mesh with a ``model``, ``seq`` or ``expert`` axis), each
rank computes with its shards: the attention's head-major qkv columns
keep whole heads in a contiguous column shard (each ``model`` rank runs
H/tp heads), the tied head multiplies ``copy_to_model_parallel(h)`` by
its vocabulary shard and `ParallelCrossEntropy` takes the sharded
logits; under a ``seq`` axis each rank holds L/S positions, the
embedding adds its global offset and attention is
``parallel.context_parallel`` (``cp_mode`` "ring" or "ulysses"; weight
dropout is skipped there, with a warning, as in JAX); with
``num_experts`` > 0 every block's MLP is a top-2 `MoELayer`, and the
loss adds ``moe_aux_weight`` times each block's load-balance loss.

Attention takes the flash kernels with ``use_flash=True`` (and
``attn_dropout`` 0), the composite otherwise.  The LM head is tied to
the token embedding: one parameter, whose gradient sums both uses.
Dropout draws from the generator passed down each call (the train step
owns it).  ``scan_layers`` runs the blocks through
``nn.scan_stack.scan_layer_stack`` (not with experts, and not for one
block, as in JAX), checkpointing each block when ``remat`` is set;
``remat`` alone changes nothing, as in the JAX model."""
import warnings

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import spmd
from ..distributed.fleet.meta_parallel.moe_layer import MoELayer
from ..distributed.fleet.meta_parallel.mp_layers import \
    copy_to_model_parallel
from ..nn import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                  ParallelCrossEntropy, RowParallelLinear,
                  VocabParallelEmbedding)
from ..nn import functional as F
from ..nn.scan_stack import scan_layer_stack
from ..ops.attention import scaled_dot_product_attention
from ..parallel.context_parallel import (context_parallel_attention,
                                         seq_axis_in_scope, seq_chunk_offset)
from .weights import NumpyWeights


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=None, max_seq_len=1024,
                 dropout=0.1, attn_dropout=None, use_flash=False,
                 remat=False, cp_mode="ring", scan_layers=False,
                 num_experts=0, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden = ffn_hidden or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        # attention-weight dropout; 0.0 keeps the flash path eligible
        self.attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.use_flash = use_flash
        self.remat = remat
        # context parallelism over a 'seq' axis: "ring" or "ulysses"
        self.cp_mode = cp_mode
        self.scan_layers = scan_layers
        # 0: dense MLPs; else each block's MLP is a top-2 MoELayer
        self.num_experts = num_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=128, dropout=0.0, **kw)


def gpt2_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def check_config(config):
    """ValueError for a ``cp_mode`` other than "ring" or "ulysses"."""
    if config.cp_mode not in (None, "ring", "ulysses"):
        raise ValueError(f"unknown context-parallel mode: "
                         f"{config.cp_mode!r}")


class GPTAttention(nn.Module):
    """Causal self-attention: column-parallel QKV, row-parallel output."""

    def __init__(self, config, generator):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                        generator=generator)
        self.out_proj = RowParallelLinear(h, h, input_is_parallel=True,
                                          generator=generator)
        self.dropout = config.attn_dropout
        self.use_flash = config.use_flash
        self.cp_mode = config.cp_mode

    def forward(self, x, generator=None):
        _, _, xs = spmd.ranks_of(self, x)
        gens = spmd.listed(generator, len(xs))
        q, k, v = [], [], []
        for t in spmd.listed(self.qkv(x), 1):
            b, l, _ = t.shape
            # head-major qkv layout: columns grouped per head as (q, k, v),
            # so a contiguous column shard holds whole (local) heads
            qi, ki, vi = t.reshape(b, l, -1, 3, self.head_dim).permute(
                3, 0, 2, 1, 4)                  # each [B, H_local, L, D]
            q.append(qi)
            k.append(ki)
            v.append(vi)
        if isinstance(x, list) and seq_axis_in_scope():
            if self.dropout and self.training:
                warnings.warn(
                    "attention-weight dropout is skipped under sequence "
                    "parallelism (residual/MLP dropout still applies)",
                    stacklevel=2)
            out = context_parallel_attention(q, k, v, mode=self.cp_mode,
                                             causal=True,
                                             use_flash=self.use_flash)
        else:
            out = [scaled_dot_product_attention(
                qi, ki, vi, is_causal=True,
                dropout_p=self.dropout if self.training else 0.0,
                use_flash=self.use_flash, generator=g)[0]
                for qi, ki, vi, g in zip(q, k, v, gens)]
        merged = [o.permute(0, 2, 1, 3).reshape(o.shape[0], o.shape[2], -1)
                  for o in out]
        return self.out_proj(spmd.unlisted(merged, x))


class GPTMLP(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.ffn_hidden,
                                          gather_output=False,
                                          generator=generator)
        self.fc_out = RowParallelLinear(config.ffn_hidden,
                                        config.hidden_size,
                                        input_is_parallel=True,
                                        generator=generator)

    def forward(self, x):
        h = self.fc_in(x)
        h = [F.gelu(t) for t in h] if isinstance(h, list) else F.gelu(h)
        return self.fc_out(h)


class GPTBlock(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size)
        self.attn = GPTAttention(config, generator)
        self.ln2 = LayerNorm(config.hidden_size)
        if config.num_experts:
            self.mlp = MoELayer(config.hidden_size, config.ffn_hidden,
                                config.num_experts,
                                capacity_factor=config.moe_capacity_factor,
                                aux_weight=config.moe_aux_weight,
                                generator=generator)
        else:
            self.mlp = GPTMLP(config, generator)
        self.drop = Dropout(config.dropout)

    def forward(self, x, generator=None):
        _, mods, xs = spmd.ranks_of(self, x)
        gens = spmd.listed(generator, len(xs))
        h = [m.ln1(t) for m, t in zip(mods, xs)]
        a = spmd.listed(self.attn(spmd.unlisted(h, x), generator), 1)
        xs = [t + m.drop(ai, g) for m, t, ai, g in zip(mods, xs, a, gens)]
        h = [m.ln2(t) for m, t in zip(mods, xs)]
        o = spmd.listed(self.mlp(spmd.unlisted(h, x)), 1)
        xs = [t + m.drop(oi, g) for m, t, oi, g in zip(mods, xs, o, gens)]
        return spmd.unlisted(xs, x)


class GPTModel(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size,
                                          generator=generator)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size,
                             generator=generator)
        self.drop = Dropout(config.dropout)
        self.blocks = nn.ModuleList(GPTBlock(config, generator)
                                    for _ in range(config.num_layers))
        self.ln_f = LayerNorm(config.hidden_size)

    def embed(self, input_ids, generator=None):
        """Token + position embedding, then dropout; under a ``seq`` axis
        each rank's positions start at its chunk's global offset."""
        _, mods, ids = spmd.ranks_of(self, input_ids)
        gens = spmd.listed(generator, len(ids))
        tok = spmd.listed(self.wte(input_ids), 1)
        offsets = seq_chunk_offset(ids[0].shape[1]) if isinstance(
            input_ids, list) else [0]
        out = []
        for m, i, t, off, g in zip(mods, ids, tok, offsets, gens):
            pos = off + torch.arange(i.shape[1], device=i.device)
            out.append(m.drop(t + m.wpe(pos)[None], g))
        return spmd.unlisted(out, input_ids)

    def run_blocks(self, x, generator=None):
        """Every block in turn: through `scan_layer_stack` under
        ``scan_layers`` (dense blocks, more than one), a loop
        otherwise."""
        cfg = self.config
        if cfg.scan_layers and not cfg.num_experts and len(self.blocks) > 1:
            return scan_layer_stack(self.blocks, x, remat=cfg.remat,
                                    generator=generator)
        for blk in self.blocks:
            x = blk(x, generator)
        return x

    def forward(self, input_ids, generator=None):
        h = self.run_blocks(self.embed(input_ids, generator), generator)
        if isinstance(h, list):
            _, mods, _ = spmd.ranks_of(self, h)
            return [m.ln_f(t) for m, t in zip(mods, h)]
        return self.ln_f(h)


class GPTForPretraining(NumpyWeights, nn.Module):
    """GPT with its LM head tied to the token embedding, on `device`
    (None means the card; without one it raises).  Weights are drawn on
    the CPU from `seed` and then moved, so one seed gives the same
    weights on every device.  Weights move between the packages by
    `from_numpy_params` and `numpy_params` (names like
    ``gpt.blocks.0.attn.qkv.weight``)."""

    def __init__(self, config, seed=0, device=None):
        super().__init__()
        dev = resolve_device(device, "GPTForPretraining")
        check_config(config)
        self.config = config
        self.gpt = GPTModel(config, torch.Generator().manual_seed(seed))
        self.to(dev)

    def _vocab_sharded(self, mods):
        return mods[0].gpt.wte.weight.shape[0] < self.config.vocab_size

    def lm_logits(self, h):
        """Final norm + the tied LM head: ``ln_f(h) @ wteᵀ``, on each
        rank its vocabulary shard's columns (all of them where the step
        left the table whole: a vocabulary the axis does not divide)."""
        _, mods, hs = spmd.ranks_of(self, h)
        hs = [m.gpt.ln_f(t) for m, t in zip(mods, hs)]
        if self._vocab_sharded(mods):
            hs = copy_to_model_parallel(hs)
        return spmd.unlisted([F.matmul(t, m.gpt.wte.weight, transpose_y=True)
                              for m, t in zip(mods, hs)], h)

    def _hidden(self, input_ids, generator=None):
        return self.gpt.run_blocks(self.gpt.embed(input_ids, generator),
                                   generator)

    def forward(self, input_ids, generator=None):
        return self.lm_logits(self._hidden(input_ids, generator))

    def head_loss(self, h, labels):
        """Mean cross entropy from post-block hidden states (over the
        vocabulary shards in a group)."""
        logits = self.lm_logits(h)
        lbl = [t.unsqueeze(-1) for t in spmd.listed(labels, 1)]
        _, mods, _ = spmd.ranks_of(self, h)
        if self._vocab_sharded(mods):
            loss = ParallelCrossEntropy()(logits, lbl)
        else:
            loss = [F.softmax_with_cross_entropy(z, li) for z, li in zip(
                spmd.listed(logits, 1), lbl)]
        return spmd.unlisted([t.mean() for t in loss], labels)

    def loss(self, input_ids, labels, generator=None):
        """`head_loss` plus, with experts, ``moe_aux_weight`` times each
        block's load-balance loss of this forward."""
        out = spmd.listed(self.head_loss(self._hidden(input_ids, generator),
                                         labels), 1)
        _, mods, _ = spmd.ranks_of(self, input_ids)
        for r, m in enumerate(mods):
            aux = None
            for blk in m.gpt.blocks:
                a = getattr(blk.mlp, "aux_loss", None)
                if a is not None:
                    term = a * blk.mlp.aux_weight
                    aux = term if aux is None else aux + term
            if aux is not None:
                out[r] = out[r] + aux
        return spmd.unlisted(out, input_ids)
