"""ERNIE (``paddle_tpu/models/ernie.py``): BERT's encoder with sentence
and, with ``use_task_id``, task embeddings; an MLM head tied to the word
embeddings, averaged over the positions whose label is not -100, and a
sentence-order head; a sequence classifier over the pooled output; and
the host-side knowledge masking that makes the MLM labels.

Without ``sent_ids`` / ``task_ids`` the type-0 rows are added.  Dropout
draws from the generator passed down each call."""
import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import Dropout, Embedding, LayerNorm, Linear, Tanh
from ..nn import functional as F
from .bert import encoder_mask, encoder_stack, positions
from .weights import NumpyWeights


class ErnieConfig:
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=3072, max_seq_len=512,
                 type_vocab_size=2, task_type_vocab_size=3, dropout=0.1,
                 use_task_id=False, scan_layers=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden = ffn_hidden
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.task_type_vocab_size = task_type_vocab_size
        self.dropout = dropout
        self.use_task_id = use_task_id
        self.scan_layers = scan_layers


def ernie_base(**kw):
    return ErnieConfig(**kw)


def ernie_tiny(**kw):
    return ErnieConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                       num_heads=4, ffn_hidden=128, max_seq_len=128,
                       dropout=0.0, **kw)


class ErnieEmbeddings(nn.Module):
    """word + position + sentence [+ task] embeddings, in that order."""

    def __init__(self, config, generator):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h,
                                         generator=generator)
        self.position_embeddings = Embedding(config.max_seq_len, h,
                                             generator=generator)
        self.sent_embeddings = Embedding(config.type_vocab_size, h,
                                         generator=generator)
        self.task_embeddings = (
            Embedding(config.task_type_vocab_size, h, generator=generator)
            if config.use_task_id else None)
        self.layer_norm = LayerNorm(h)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, sent_ids=None, task_ids=None,
                generator=None):
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(positions(input_ids)))
        if sent_ids is None:
            emb = emb + self.sent_embeddings.weight[0]
        else:
            emb = emb + self.sent_embeddings(sent_ids)
        if self.task_embeddings is not None:
            if task_ids is None:
                emb = emb + self.task_embeddings.weight[0]
            else:
                emb = emb + self.task_embeddings(task_ids)
        return self.dropout(self.layer_norm(emb), generator)


class ErnieModel(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config, generator)
        self.encoder = encoder_stack(config, generator)
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             generator=generator)
        self.pooler_act = Tanh()

    def forward(self, input_ids, sent_ids=None, task_ids=None,
                attention_mask=None, generator=None):
        """(sequence output [B, L, h], pooled [B, h])."""
        x = self.embeddings(input_ids, sent_ids, task_ids, generator)
        x = self.encoder(x, encoder_mask(attention_mask),
                         generator=generator)
        return x, self.pooler_act(self.pooler(x[:, 0]))


class ErnieForPretraining(NumpyWeights, nn.Module):
    """ERNIE with its MLM and sentence-order heads, on `device` (None
    means the card; without one it raises); weights drawn on the CPU from
    `seed`, then moved."""

    def __init__(self, config, seed=0, device=None):
        super().__init__()
        dev = resolve_device(device, "ErnieForPretraining")
        generator = torch.Generator().manual_seed(seed)
        self.ernie = ErnieModel(config, generator)
        self.config = config
        h = config.hidden_size
        self.mlm_transform = Linear(h, h, generator=generator)
        self.mlm_norm = LayerNorm(h)
        self.sop_head = Linear(h, 2, generator=generator)
        self.to(dev)

    def forward(self, input_ids, sent_ids=None, task_ids=None,
                attention_mask=None, generator=None):
        """(MLM logits [B, L, vocab], sentence-order logits [B, 2])."""
        seq, pooled = self.ernie(input_ids, sent_ids, task_ids,
                                 attention_mask, generator)
        mlm_h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = F.matmul(
            mlm_h, self.ernie.embeddings.word_embeddings.weight,
            transpose_y=True)
        return mlm_logits, self.sop_head(pooled)

    def loss(self, input_ids, mlm_labels, sop_labels=None, sent_ids=None,
             generator=None):
        """The MLM cross entropy summed over positions whose label is not
        -100 and divided by their count (at least 1), plus the
        sentence-order cross entropy when `sop_labels` is given."""
        mlm_logits, sop_logits = self(input_ids, sent_ids,
                                      generator=generator)
        per_pos = F.softmax_with_cross_entropy(mlm_logits,
                                               mlm_labels.unsqueeze(-1))
        valid = (mlm_labels != F.IGNORE_INDEX).float().unsqueeze(-1)
        mlm_loss = (per_pos * valid).sum() / valid.sum().clamp(min=1.0)
        if sop_labels is None:
            return mlm_loss
        return mlm_loss + F.softmax_with_cross_entropy(
            sop_logits, sop_labels.unsqueeze(-1)).mean()


class ErnieForSequenceClassification(NumpyWeights, nn.Module):
    """A linear classifier over ERNIE's pooled output, on `device` (None
    means the card)."""

    def __init__(self, config, num_classes=2, seed=0, device=None):
        super().__init__()
        dev = resolve_device(device, "ErnieForSequenceClassification")
        generator = torch.Generator().manual_seed(seed)
        self.ernie = ErnieModel(config, generator)
        self.dropout = Dropout(config.dropout)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 generator=generator)
        self.to(dev)

    def forward(self, input_ids, sent_ids=None, attention_mask=None,
                generator=None):
        _, pooled = self.ernie(input_ids, sent_ids,
                               attention_mask=attention_mask,
                               generator=generator)
        return self.classifier(self.dropout(pooled, generator))


# the default stream of `apply_knowledge_mask`: successive calls make
# fresh masking decisions, and the same sequence of calls the same ones
_MASK_RNG = np.random.RandomState(0)


def apply_knowledge_mask(input_ids, spans, mask_id, rng=None,
                         mask_prob=0.15):
    """ERNIE's knowledge masking, on the host: each (start, end) span of
    `spans` (one list per row, half-open) is masked whole with
    probability `mask_prob`, drawn from `rng` (default: the module's
    stream).  Returns (masked ids, MLM labels): the original ids on
    masked positions, -100 elsewhere."""
    rng = rng or _MASK_RNG
    ids = np.array(input_ids, copy=True)
    labels = np.full_like(ids, F.IGNORE_INDEX)
    for b, row_spans in enumerate(spans):
        for (s, e) in row_spans:
            if rng.rand() < mask_prob:
                labels[b, s:e] = ids[b, s:e]
                ids[b, s:e] = mask_id
    return ids, labels
