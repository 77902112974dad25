"""GPT, the decoder-only transformer the JAX package trains
(``paddle_tpu/models/gpt.py``), at model-parallel degree 1 on one
device.

Attention takes the flash kernels with ``use_flash=True`` (and
``attn_dropout`` 0), the composite otherwise.  The LM head is tied to
the token embedding: one parameter, whose gradient sums both uses.
Dropout draws from the generator passed down each call (the train step
owns it).  Options of the JAX model this port does not run raise at
build: mixture of experts, context parallelism (``cp_mode``), and the
XLA compile strategies ``scan_layers`` and ``remat`` (the same
arithmetic as the plain loop)."""
import torch
from torch import nn

from ..device import resolve_device
from ..nn import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                  ParallelCrossEntropy, RowParallelLinear,
                  VocabParallelEmbedding)
from ..nn import functional as F
from ..ops.attention import scaled_dot_product_attention
from .weights import NumpyWeights


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=None, max_seq_len=1024,
                 dropout=0.1, attn_dropout=None, use_flash=False,
                 remat=False, cp_mode=None, scan_layers=False,
                 num_experts=0):
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
        self.cp_mode = cp_mode
        self.scan_layers = scan_layers
        self.num_experts = num_experts


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=128, dropout=0.0, **kw)


def gpt2_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def check_config(config):
    """Raise NotImplementedError for what the port does not run."""
    refused = {"num_experts > 0 (mixture of experts)": config.num_experts,
               "cp_mode (context parallelism over a 'seq' axis)":
                   config.cp_mode is not None,
               "scan_layers=True": config.scan_layers,
               "remat=True": config.remat}
    for what, on in refused.items():
        if on:
            raise NotImplementedError(f"GPT: {what} is not ported yet")


class GPTAttention(nn.Module):
    """Causal self-attention: column-parallel QKV, row-parallel output."""

    def __init__(self, config, generator):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = ColumnParallelLinear(h, 3 * h, generator=generator)
        self.out_proj = RowParallelLinear(h, h, generator=generator)
        self.dropout = config.attn_dropout
        self.use_flash = config.use_flash

    def forward(self, x, generator=None):
        b, l, _ = x.shape
        # head-major qkv layout: columns grouped per head as (q, k, v)
        qkv = self.qkv(x).reshape(b, l, -1, 3, self.head_dim)
        q, k, v = qkv.permute(3, 0, 2, 1, 4)     # each [B, H, L, D]
        out, _ = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            use_flash=self.use_flash, generator=generator)
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(b, l, -1))


class GPTMLP(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.ffn_hidden,
                                          generator=generator)
        self.fc_out = RowParallelLinear(config.ffn_hidden,
                                        config.hidden_size,
                                        generator=generator)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTBlock(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size)
        self.attn = GPTAttention(config, generator)
        self.ln2 = LayerNorm(config.hidden_size)
        self.mlp = GPTMLP(config, generator)
        self.drop = Dropout(config.dropout)

    def forward(self, x, generator=None):
        x = x + self.drop(self.attn(self.ln1(x), generator), generator)
        return x + self.drop(self.mlp(self.ln2(x)), generator)


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
        """Token + position embedding, then dropout."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)[None]
        return self.drop(x, generator)

    def run_blocks(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x

    def forward(self, input_ids, generator=None):
        return self.ln_f(self.run_blocks(self.embed(input_ids, generator),
                                         generator))


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

    def lm_logits(self, h):
        """Final norm + the tied LM head: ``ln_f(h) @ wteᵀ``."""
        return F.linear(self.gpt.ln_f(h), self.gpt.wte.weight.t())

    def _hidden(self, input_ids, generator=None):
        return self.gpt.run_blocks(self.gpt.embed(input_ids, generator),
                                   generator)

    def forward(self, input_ids, generator=None):
        return self.lm_logits(self._hidden(input_ids, generator))

    def head_loss(self, h, labels):
        """Mean cross entropy from post-block hidden states."""
        logits = self.lm_logits(h)
        return ParallelCrossEntropy()(logits, labels.unsqueeze(-1)).mean()

    def loss(self, input_ids, labels, generator=None):
        return self.head_loss(self._hidden(input_ids, generator), labels)
