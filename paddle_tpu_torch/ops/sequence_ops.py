"""Sequence ops of ``paddle_tpu/ops/sequence_ops.py`` over the padded
(batch, time, ...) layout with per-row lengths: the linear-chain CRF
(`linear_chain_crf`, `crf_decoding`), the NCE loss (`nce`) and beam
search (`beam_search`, `beam_search_decode`) in the dense (batch, beam)
layout.  The rest of that module is not ported yet.

The recursions over time are Python loops of a few tensor ops a step,
with no host read: JAX's ``lax.scan`` bodies written out.  `nce` draws
its negative classes on the CPU (`draw_negatives`), so the card and
the CPU draw the same ids for one seed."""
import math

import torch
import torch.nn.functional as F

from ..amp.auto_cast import cast_inputs
from .math import topk
from .nn_extra import gather_tree

# an inactive or closed-off candidate's score
NEG_INF = -1e9


def beam_candidates(pre_ids, pre_scores, ids, scores, end_id,
                    is_accumulated=True):
    """The candidates `beam_search` ranks: their accumulated scores and
    ids [batch·beam, K], a finished beam's row replaced by itself at its
    frozen score and -1e9 elsewhere."""
    finished = (pre_ids.reshape(-1) == end_id)[:, None]
    acc = scores if is_accumulated else pre_scores.reshape(-1, 1) + \
        torch.log(torch.clamp(scores, min=1e-20))
    first = (torch.arange(scores.shape[1], device=scores.device) == 0)[
        None, :]
    neg = torch.full((), NEG_INF, dtype=acc.dtype, device=acc.device)
    acc = torch.where(finished, torch.where(
        first, pre_scores.reshape(-1, 1).to(acc.dtype), neg), acc)
    cand = torch.where(finished, torch.where(
        first, pre_ids.reshape(-1, 1).to(ids.dtype),
        torch.full((), end_id, dtype=ids.dtype, device=ids.device)), ids)
    return acc, cand


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None):
    """One expansion step.  `pre_ids`/`pre_scores` [batch·beam, 1] are the
    beams so far, `ids`/`scores` [batch·beam, K] their candidates and
    the candidates' scores (accumulated, or probabilities to add to
    ``pre_scores`` in log space).  A finished beam (its last id
    `end_id`) offers only itself, at its frozen score, every other
    candidate at -1e9.  The top `beam_size` of each batch row's beam·K
    candidates win, equal scores in index order.  Returns the chosen ids
    [batch·beam, 1] int64, their scores [batch·beam, 1] and each one's
    parent, the flat beam row it extends [batch·beam] int64."""
    bb, k = scores.shape
    batch = bb // beam_size
    acc, cand = beam_candidates(pre_ids, pre_scores, ids, scores, end_id,
                                is_accumulated)
    top_score, top_pos = topk(acc.reshape(batch, beam_size * k), beam_size)
    parent = (torch.div(top_pos, k, rounding_mode="floor")
              + torch.arange(batch, device=top_pos.device)[:, None]
              * beam_size).reshape(-1)
    sel = torch.gather(cand.reshape(batch, beam_size * k), 1, top_pos)
    return (sel.reshape(-1, 1).to(torch.int64), top_score.reshape(-1, 1),
            parent.to(torch.int64))


def _steps(xs):
    if isinstance(xs, (list, tuple)):
        return torch.stack([x.reshape(-1) for x in xs])
    return xs.reshape(len(xs), -1)


def beam_search_decode(step_ids, step_parents, beam_size, end_id, name=None):
    """Full sequences [T, batch, beam] from per-step choices: lists of
    [batch·beam, 1] ids and [batch·beam] flat parents (or [T,
    batch·beam] tensors), backtracked through `gather_tree`."""
    ids = _steps(step_ids)
    parents = _steps(step_parents)
    t, bb = ids.shape
    batch = bb // beam_size
    return gather_tree(ids.reshape(t, batch, beam_size),
                       parents.reshape(t, batch, beam_size) % beam_size)


def _crf_ll(emission, transition, label, length):
    """Per-sequence log-likelihood [B, 1] (the JAX ``_crf_ll``):
    transition rows 0 and 1 are the start and stop scores, the rest the
    [N, N] tag-to-tag scores; a masked logsumexp recursion over each
    row's `length`, less the gold path's score."""
    B, T, N = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    lab = label.long()
    lens = length.long()
    alpha = start[None, :] + emission[:, 0, :]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emission[:, t, :]
        alpha = torch.where((t < lens)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    t_idx = torch.arange(T, device=emission.device)[None, :]
    valid = t_idx < lens[:, None]
    em_gold = torch.gather(emission, 2, lab[:, :, None])[..., 0]
    em_sum = torch.where(valid, em_gold, 0.0).sum(dim=1)
    if T > 1:
        tr_gold = trans[lab[:, :-1], lab[:, 1:]]
        tr_sum = torch.where(t_idx[:, 1:] < lens[:, None], tr_gold,
                             0.0).sum(dim=1)
    else:
        tr_sum = torch.zeros(B, dtype=emission.dtype,
                             device=emission.device)
    # a length of 0 reads the last position, as a negative index does
    last = torch.gather(lab, 1, ((lens - 1) % T)[:, None])[:, 0]
    gold = start[lab[:, 0]] + em_sum + tr_sum + stop[last]
    return (gold - log_z)[:, None]


def linear_chain_crf(input, transition, label, length, name=None):
    """Log-likelihood [B, 1] of the gold tag paths `label` [B, T] under a
    linear-chain CRF of emissions `input` [B, T, N] and `transition`
    [N + 2, N], each row over its `length`; negate and mean for a
    training loss.  The gradient is autograd's."""
    return _crf_ll(*cast_inputs("linear_chain_crf", input, transition),
                   label, length)


def crf_decoding(input, transition, length, name=None):
    """The Viterbi paths [B, T] int64 (the JAX ``_viterbi``): each row's
    best tags over its `length`, a tie to the lower tag, 0 past the
    length; no gradient."""
    emission, transition = cast_inputs("crf_decoding", input, transition)
    B, T, N = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    lens = length.long()
    tags = torch.arange(N, device=emission.device)[None, :]
    with torch.no_grad():
        alpha = start[None, :] + emission[:, 0, :]
        back = []
        for t in range(1, T):
            scores = alpha[:, :, None] + trans[None, :, :]
            alive = (t < lens)[:, None]
            back.append(torch.where(alive, torch.argmax(scores, dim=1),
                                    tags))
            alpha = torch.where(alive, scores.amax(dim=1)
                                + emission[:, t, :], alpha)
        tag = torch.argmax(alpha + stop[None, :], dim=1)
        path = [tag]
        for t in range(T - 2, -1, -1):
            prev = torch.gather(back[t], 1, tag[:, None])[:, 0]
            tag = torch.where(t + 1 < lens, prev, tag)
            path.append(tag)
        path = torch.stack(path[::-1], dim=1)
        valid = torch.arange(T, device=path.device)[None, :] < lens[:, None]
        return torch.where(valid, path, 0).to(torch.int64)


def draw_negatives(seed, num_samples, vocab, sampler):
    """`nce`'s negative class ids [num_samples] int64, drawn on the CPU:
    from a generator of its own seeded with `seed`, or for seed 0 from
    torch's default CPU generator.  "log_uniform" draws
    ``floor(exp(u log(vocab + 1)) - 1)`` in float32 (clipped to the
    vocabulary), anything else uniformly."""
    gen = torch.Generator().manual_seed(seed) if seed else None
    if sampler == "log_uniform":
        u = torch.rand(num_samples, generator=gen)
        ids = (torch.exp(u * math.log(vocab + 1.0)) - 1.0).to(torch.int32)
        return ids.clamp(0, vocab - 1).to(torch.int64)
    return torch.randint(0, vocab, (num_samples,), generator=gen)


def log_uniform_log_prob(ids, vocab):
    """log P(k) of the log-uniform sampler, ``(log(k + 2) - log(k + 1)) /
    log(vocab + 1)``, in float32."""
    k = ids.to(torch.float32)
    return torch.log(torch.log((k + 2.0) / (k + 1.0))) - torch.log(
        torch.log(torch.tensor(vocab + 1.0, device=k.device)))


def nce(input, weight, label, bias=None, num_total_classes=None,
        num_neg_samples=10, sampler="uniform", seed=0, name=None):
    """The NCE cost [B, 1] of `input` [B, D] against the true classes
    `label` ([B] or [B, L]) and `num_neg_samples` negatives shared across
    the batch, over class weights `weight` [V, D] and `bias` [V]; each
    class priced by its own sampler probability (``-log V`` for the
    uniform sampler)."""
    x, weight, bias = cast_inputs("nce", input, weight, bias)
    V = num_total_classes or weight.shape[0]
    neg = draw_negatives(seed, num_neg_samples, V, sampler).to(x.device)
    lbl = label.reshape(label.shape[0], -1).long()
    pos_logit = torch.einsum("bd,bld->bl", x, weight[lbl])
    neg_logit = x @ weight[neg].T
    if bias is not None:
        pos_logit = pos_logit + bias[lbl]
        neg_logit = neg_logit + bias[neg][None, :]
    if sampler == "log_uniform":
        log_q_pos = log_uniform_log_prob(lbl, V)
        log_q_neg = log_uniform_log_prob(neg, V)[None, :]
    else:
        log_q_pos = log_q_neg = -torch.log(torch.tensor(
            float(V), dtype=x.dtype, device=x.device))
    pos_cost = -F.logsigmoid(pos_logit - log_q_pos)
    neg_cost = -F.logsigmoid(-(neg_logit - log_q_neg))
    return (pos_cost.sum(dim=1) + neg_cost.sum(dim=1))[:, None]


__all__ = ["beam_candidates", "beam_search", "beam_search_decode",
           "crf_decoding", "linear_chain_crf", "nce"]
