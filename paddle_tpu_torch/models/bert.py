"""BERT, the encoder the JAX package pretrains (``paddle_tpu/models/
bert.py``): word, position and token-type embeddings, the transformer
encoder of ``nn/transformer.py`` with GELU, a Tanh pooler over the first
position, the MLM head tied to the word embeddings and the NSP head.

Without ``token_type_ids`` the type-0 row is added (not "no type
embedding").  ``attention_mask`` is [B, L], additive (0 keep, a large
negative drop) or bool / integer (set = keep), and is seen as
[B, 1, 1, L].  Dropout, weight dropout included, draws from the
generator passed down each call (the train step owns it)."""
import torch
from torch import nn

from ..device import resolve_device
from ..nn import (Dropout, Embedding, LayerNorm, Linear, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn import functional as F
from .weights import NumpyWeights


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=3072, max_seq_len=512,
                 type_vocab_size=2, dropout=0.1, scan_layers=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden = ffn_hidden
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.scan_layers = scan_layers


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, ffn_hidden=128, max_seq_len=128,
                      dropout=0.0, **kw)


def positions(input_ids):
    """[B, L] position ids 0..L-1 on the ids' device."""
    b, length = input_ids.shape
    return torch.arange(length, device=input_ids.device).expand(b, length)


def encoder_mask(attention_mask):
    """A [B, L] attention mask as [B, 1, 1, L], or None."""
    if attention_mask is None:
        return None
    return attention_mask.reshape(attention_mask.shape[0], 1, 1,
                                  attention_mask.shape[1])


def encoder_stack(config, generator):
    """The post-norm GELU encoder of `config`'s width and depth; every
    layer starts as a copy of the first."""
    layer = TransformerEncoderLayer(
        config.hidden_size, config.num_heads, config.ffn_hidden,
        dropout=config.dropout, activation="gelu", generator=generator)
    return TransformerEncoder(layer, config.num_layers,
                              scan_layers=config.scan_layers)


class BertEmbeddings(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h,
                                         generator=generator)
        self.position_embeddings = Embedding(config.max_seq_len, h,
                                             generator=generator)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               generator=generator)
        self.layer_norm = LayerNorm(h)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None, generator=None):
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(positions(input_ids)))
        if token_type_ids is None:
            emb = emb + self.token_type_embeddings.weight[0]
        else:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb), generator)


class BertModel(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, generator)
        self.encoder = encoder_stack(config, generator)
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             generator=generator)
        self.pooler_act = Tanh()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        """(sequence output [B, L, h], pooled [B, h])."""
        x = self.embeddings(input_ids, token_type_ids, generator)
        x = self.encoder(x, encoder_mask(attention_mask),
                         generator=generator)
        return x, self.pooler_act(self.pooler(x[:, 0]))


class BertForPretraining(NumpyWeights, nn.Module):
    """BERT with its MLM and NSP heads, on `device` (None means the card;
    without one it raises).  Weights are drawn on the CPU from `seed` and
    then moved.  Weights move between the packages by `from_numpy_params`
    and `numpy_params` (names like
    ``bert.encoder.layers.0.self_attn.q_proj.weight``)."""

    def __init__(self, config, seed=0, device=None):
        super().__init__()
        dev = resolve_device(device, "BertForPretraining")
        generator = torch.Generator().manual_seed(seed)
        self.config = config
        self.bert = BertModel(config, generator)
        h = config.hidden_size
        self.mlm_transform = Linear(h, h, generator=generator)
        self.mlm_norm = LayerNorm(h)
        self.nsp_head = Linear(h, 2, generator=generator)
        self.to(dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        """(MLM logits [B, L, vocab], NSP logits [B, 2])."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                generator)
        mlm_h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = F.linear(mlm_h,
                              self.bert.embeddings.word_embeddings.weight.t())
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, input_ids, mlm_labels, nsp_labels=None,
             token_type_ids=None, generator=None):
        """The MLM cross entropy averaged over every position (a -100
        label counts 0), plus the NSP cross entropy when `nsp_labels` is
        given."""
        mlm_logits, nsp_logits = self(input_ids, token_type_ids,
                                      generator=generator)
        mlm_loss = F.softmax_with_cross_entropy(
            mlm_logits, mlm_labels.unsqueeze(-1)).mean()
        if nsp_labels is None:
            return mlm_loss
        return mlm_loss + F.softmax_with_cross_entropy(
            nsp_logits, nsp_labels.reshape(-1, 1)).mean()
