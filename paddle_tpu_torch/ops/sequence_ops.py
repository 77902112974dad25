"""The sequence ops of ``paddle_tpu/ops/sequence_ops.py`` over the padded
(batch, time, ...) layout with per-row lengths: the linear-chain CRF
(`linear_chain_crf`, `crf_decoding`), the sampled losses (`nce`,
`sample_logits`, `sampling_id`), beam search (`beam_search`,
`beam_search_decode`) in the dense (batch, beam) layout, the positional
and window ops (`add_position_encoding`, `im2sequence`, `row_conv`,
`conv_shift`), the segment pools and the ``sequence_*`` family.

The recursions over time are Python loops of a few tensor ops a step,
with no host read: JAX's ``lax.scan`` bodies written out.  The random
ops draw on the CPU from a generator of their own (`cpu_generator`), so
the card and the CPU draw the same values for one seed.  Where the
output's shape depends on the data (`segment_pool`'s segment count,
`sequence_pad`, `sequence_unpad`, `sequence_expand`, `sequence_expand_as`
without `maxlen`), the lengths or ids are read back to the host, as in
JAX, which reads them at trace time.

Two ops compute what the reference means where the JAX package does
not: `sequence_conv` zeroes each row's input at and past its length
before it gathers the windows (JAX masks only the output, so a window
near a row's end reads the padding), and `row_conv` keeps JAX's
signature and result: it takes no lengths, so its lookahead crosses
into the padding and the next sequence would not be kept out."""
import math

import numpy as np
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


def cpu_generator(seed):
    """The CPU generator a random op of this module draws from: one of its
    own seeded with `seed`, or for seed 0 torch's default CPU generator
    (which ``paddle.seed`` seeds)."""
    return torch.Generator().manual_seed(seed) if seed else None


def draw_negatives(seed, num_samples, vocab, sampler):
    """`nce`'s negative class ids [num_samples] int64, drawn on the CPU:
    from a generator of its own seeded with `seed`, or for seed 0 from
    torch's default CPU generator.  "log_uniform" draws
    ``floor(exp(u log(vocab + 1)) - 1)`` in float32 (clipped to the
    vocabulary), anything else uniformly."""
    gen = cpu_generator(seed)
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


def sample_logits(logits, label, num_samples, seed=0, name=None):
    """Sampled softmax's inputs: each row's true-class logits (`label`
    [B] or [B, L]) then `num_samples` log-uniform negatives shared by the
    batch (drawn as `nce` draws them).  Returns the picked logits [B, L +
    S] and their class ids [B, L + S] int64 (no gradient)."""
    logits, = cast_inputs("sample_logits", logits)
    B, V = logits.shape
    neg = draw_negatives(seed, num_samples, V, "log_uniform").to(
        logits.device)
    ids = torch.cat([label.reshape(B, -1).long(),
                     neg[None, :].expand(B, num_samples)], dim=1)
    return torch.gather(logits, 1, ids), ids


def sampling_id(x, min=0.0, max=1.0, seed=0, name=None):
    """One column id per row of the probabilities `x` [B, C], int64: the
    argmax of ``log(max(x, 1e-20))`` plus Gumbel noise drawn on the CPU
    (`cpu_generator`), the categorical draw of JAX's
    ``jax.random.categorical``; no gradient."""
    u = torch.rand(tuple(x.shape), generator=cpu_generator(seed)).to(
        x.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    with torch.no_grad():
        return torch.argmax(torch.log(torch.clamp(x.float(), min=1e-20))
                            + gumbel, dim=1)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """``alpha x + beta enc`` of `input` [B, T, D], the sinusoid table's
    first ceil(D / 2) channels ``sin(t / 10000^(i / half))`` and the
    rest the matching cosines."""
    x, = cast_inputs("add_position_encoding", input)
    _, T, D = x.shape
    half = (D + 1) // 2
    pos = torch.arange(T, dtype=x.dtype, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=x.dtype,
                                          device=x.device) / half)
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)[:, :D - half]],
                    dim=1)
    return alpha * x + beta * enc[None, :, :]


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """The patches of an NCHW image as rows [B · out_h · out_w, C kh kw]
    (`nn_ops.unfold`, transposed): each image's windows in row-major
    order."""
    from .nn_ops import unfold

    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    cols = unfold(input, list(k), strides=stride, paddings=padding)
    B, ckk, L = cols.shape
    return cols.transpose(1, 2).reshape(B * L, ckk)


def row_conv(input, weight, name=None):
    """The lookahead convolution ``y[t] = sum_j weight[j] x[t + j]`` of
    `input` [B, T, D] under `weight` [k, D], zeros past T.  It takes no
    lengths (the JAX signature): a row's lookahead reads its padding,
    where the reference's stays inside each sequence."""
    x, w = cast_inputs("row_conv", input, weight)
    k, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + T, :] * w[j][None, None, :]
    return out


def conv_shift(x, y, name=None):
    """The circular correlation ``out[i, j] = sum_k x[i, (j + k - W // 2)
    mod N] y[i, k]`` of `x` [B, N] and `y` [B, W]."""
    x, y = cast_inputs("conv_shift", x, y)
    N, W = x.shape[1], y.shape[1]
    shifts = torch.arange(W, device=x.device) - W // 2
    idx = (torch.arange(N, device=x.device)[None, :] + shifts[:, None]) % N
    return torch.einsum("bwn,bw->bn", x[:, idx], y)


def _host_ints(v):
    """Integer values (a tensor, an array or a list) as a flat host
    int64 array: the boundary where the data decides a shape."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v).astype(np.int64).reshape(-1)


def _lens(length, device):
    """Per-row lengths as a flat int64 tensor on `device`."""
    if isinstance(length, torch.Tensor):
        return length.reshape(-1).long().to(device)
    return torch.as_tensor(_host_ints(length), device=device)


def _valid(lens, T):
    """[B, T] bool: position t < the row's length."""
    return torch.arange(T, device=lens.device)[None, :] < lens[:, None]


def _trail(mask, x):
    """`mask` [B, T] broadcastable over `x`'s trailing dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def segment_pool(x, segment_ids, pool_type="SUM", name=None):
    """Rows of `x` pooled by their segment id ("SUM", "MEAN", "MAX" or
    "MIN"), over max(id) + 1 segments (the ids read back to the host).
    A segment no row names pools to 0 (SUM, MEAN), or to -inf (MAX) and
    +inf (MIN) as ``jax.ops.segment_max`` and ``segment_min`` give."""
    kind = pool_type.upper()
    if kind not in ("SUM", "MEAN", "MAX", "MIN"):
        raise ValueError(f"unknown segment pool {pool_type}")
    ids_host = _host_ints(segment_ids)
    n_seg = int(ids_host.max()) + 1 if ids_host.size else 0
    x, = cast_inputs(f"segment_{kind.lower()}", x)
    ids = _lens(segment_ids, x.device)
    shape = (n_seg,) + tuple(x.shape[1:])
    if kind in ("SUM", "MEAN"):
        out = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add(
            0, ids, x)
        if kind == "SUM":
            return out
        count = torch.zeros(n_seg, dtype=x.dtype, device=x.device).index_add(
            0, ids, torch.ones_like(ids, dtype=x.dtype))
        return out / torch.clamp(count, min=1.0).reshape(
            (-1,) + (1,) * (x.dim() - 1))
    big = torch.finfo(x.dtype).max if x.is_floating_point() else None
    init = (float("-inf") if kind == "MAX" else float("inf")) \
        if big is not None else (torch.iinfo(x.dtype).min if kind == "MAX"
                                 else torch.iinfo(x.dtype).max)
    index = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    return torch.full(shape, init, dtype=x.dtype, device=x.device
                      ).scatter_reduce(0, index, x, "amax" if kind == "MAX"
                                       else "amin", include_self=True)


def segment_sum(x, segment_ids, name=None):
    return segment_pool(x, segment_ids, "SUM")


def segment_mean(x, segment_ids, name=None):
    return segment_pool(x, segment_ids, "MEAN")


def segment_max(x, segment_ids, name=None):
    return segment_pool(x, segment_ids, "MAX")


def segment_min(x, segment_ids, name=None):
    return segment_pool(x, segment_ids, "MIN")


def sequence_pool(input, length, pool_type="average", name=None):
    """Each row of `input` [B, T, ...] pooled over its first `length`
    steps: "sum", "average" (or "mean"), "sqrt" (the sum over
    sqrt(length)), "max" (-3.4e38 where a row has no step), "last" (a
    length of 0 reads the last step, as JAX's negative index does) or
    "first"; the counts floored at 1."""
    x, = cast_inputs("sequence_pool", input)
    T = x.shape[1]
    lens = _lens(length, x.device)
    mask = _trail(_valid(lens, T), x).to(x.dtype)
    kind = pool_type.lower()
    if kind in ("sum", "average", "mean", "sqrt"):
        total = torch.sum(x * mask, dim=1)
        if kind == "sum":
            return total
        count = torch.clamp(torch.sum(mask, dim=1), min=1.0)
        return total / (count if kind != "sqrt" else torch.sqrt(count))
    if kind == "max":
        return torch.amax(torch.where(mask > 0, x, torch.full(
            (), -3.4e38, dtype=x.dtype, device=x.device)), dim=1)
    if kind == "last":
        idx = ((lens - 1) % T).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.gather(x, 1, idx.expand((x.shape[0], 1)
                                             + tuple(x.shape[2:])))[:, 0]
    if kind == "first":
        return x[:, 0]
    raise ValueError(f"unknown sequence pool {pool_type}")


def sequence_first_step(input, length, name=None):
    return sequence_pool(input, length, "first")


def sequence_last_step(input, length, name=None):
    return sequence_pool(input, length, "last")


def sequence_softmax(input, length, name=None):
    """The softmax over time of each row's first `length` steps, 0
    past them."""
    x, = cast_inputs("sequence_softmax", input)
    mask = _trail(_valid(_lens(length, x.device), x.shape[1]), x)
    out = torch.softmax(torch.where(mask, x, torch.full(
        (), -1e9, dtype=x.dtype, device=x.device)), dim=1)
    return torch.where(mask, out, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def sequence_reverse(x, length, name=None):
    """Each row's first `length` steps reversed, its padding in place."""
    T = x.shape[1]
    lens = _lens(length, x.device)[:, None]
    idx = torch.arange(T, device=x.device)[None, :]
    src = torch.where(idx < lens, lens - 1 - idx, idx)
    src = _trail(src, x).expand(x.shape)
    return torch.gather(x, 1, src)


def _rows_of(lens):
    """(row, step) host index arrays of every valid step of `lens`, in
    row-major order."""
    rows = np.repeat(np.arange(len(lens)), lens)
    steps = np.concatenate([np.arange(n) for n in lens]) if len(lens) \
        else np.zeros(0, np.int64)
    return rows, steps.astype(np.int64)


def sequence_pad(x, lengths, pad_value=0.0, maxlen=None, name=None):
    """Concatenated rows `x` [sum(lengths), ...] to a padded batch [B, T,
    ...] (T = `maxlen`, else the longest), `pad_value` past each length;
    returns it and the lengths [B] int64 (host lengths, the LoD boundary
    as in JAX)."""
    lens = _host_ints(lengths)
    T = int(maxlen or (lens.max() if lens.size else 0))
    rows, steps = _rows_of(lens)
    out = torch.full((len(lens), T) + tuple(x.shape[1:]), pad_value,
                     dtype=x.dtype, device=x.device)
    out = out.index_put((torch.as_tensor(rows, device=x.device),
                         torch.as_tensor(steps, device=x.device)), x)
    return out, torch.as_tensor(lens, device=x.device)


def sequence_unpad(x, length, name=None):
    """A padded batch [B, T, ...] to its rows' valid steps concatenated
    [sum(length), ...] (host lengths)."""
    rows, steps = _rows_of(_host_ints(length))
    return x[torch.as_tensor(rows, device=x.device),
             torch.as_tensor(steps, device=x.device)]


def sequence_expand(x, ref_lengths, name=None):
    """Row i of `x` repeated ``ref_lengths[i]`` times (host lengths)."""
    lens = _host_ints(ref_lengths)
    return x[torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                             device=x.device)]


def sequence_conv(input, weight, length, context_length=None,
                  context_start=None, name=None):
    """The context-window convolution of `input` [B, T, D] under `weight`
    [context_length · D, M]: step t reads steps ``t + context_start`` ..
    ``t + context_start + context_length - 1`` (``context_start``
    defaults to ``-(context_length - 1) // 2``), one matmul over the
    gathered windows, 0 past each length.  Each row's input is zeroed at
    and past its length first, so a window reads zeros outside its
    sequence as the reference's LoD op does; the JAX package masks only
    the output, and a window near a row's end reads its padding."""
    x, w = cast_inputs("sequence_conv", input, weight)
    B, T, D = x.shape
    ctx = context_length or w.shape[0] // D
    start = context_start if context_start is not None else -(ctx - 1) // 2
    valid = _valid(_lens(length, x.device), T)
    x = torch.where(valid[:, :, None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    cols = []
    for j in range(ctx):
        off = start + j
        if off < 0:
            seg = F.pad(x[:, :max(T + off, 0)], (0, 0, min(-off, T), 0))
        else:
            seg = F.pad(x[:, off:], (0, 0, 0, min(off, T)))
        cols.append(seg)
    out = torch.cat(cols, dim=2) @ w
    return out * valid[:, :, None].to(out.dtype)


def sequence_concat(inputs, lengths, name=None):
    """Row b of the output is each input's first ``lengths[i][b]`` steps
    in turn, zeros after, over T = the inputs' summed widths; returns it
    and the summed lengths [B] int64.  No host read: a step past its
    length is written to a spare column that is cut off."""
    x0 = inputs[0]
    B = x0.shape[0]
    T_out = sum(int(x.shape[1]) for x in inputs)
    out = torch.zeros((B, T_out + 1) + tuple(x0.shape[2:]), dtype=x0.dtype,
                      device=x0.device)
    offsets = torch.zeros(B, dtype=torch.int64, device=x0.device)
    for x, n in zip(inputs, lengths):
        n = _lens(n, x0.device)
        T = x.shape[1]
        t = torch.arange(T, device=x0.device)[None, :]
        dest = torch.where(t < n[:, None], offsets[:, None] + t, T_out)
        rows = torch.arange(B, device=x0.device)[:, None].expand(B, T)
        out = out.index_put((rows, dest), x.to(out.dtype))
        offsets = offsets + n
    return out[:, :T_out], offsets


def sequence_enumerate(x, length, win_size, pad_value=0, name=None):
    """The windows ``[x[b, t], ..., x[b, t + win_size - 1]]`` of the ids
    `x` [B, T] as [B, T, win_size], `pad_value` where a window reaches
    past the row's length."""
    T = x.shape[1]
    lens = _lens(length, x.device)
    cols = []
    for k in range(win_size):
        shifted = F.pad(x[:, k:], (0, k), value=pad_value)
        valid = (torch.arange(T, device=x.device)[None, :] + k) < lens[:, None]
        cols.append(torch.where(valid, shifted, torch.full(
            (), pad_value, dtype=x.dtype, device=x.device)))
    return torch.stack(cols, dim=-1)


def sequence_expand_as(x, ref_length, maxlen=None, name=None):
    """Each row ``x[b]`` repeated over its `ref_length` steps [B, T,
    ...], zeros after, T = `maxlen` or the longest (read back to the
    host)."""
    lens = _lens(ref_length, x.device)
    T = int(maxlen) if maxlen is not None else (
        int(lens.max()) if lens.numel() else 0)
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    mask = _valid(lens, T).reshape((x.shape[0], T) + (1,) * (x.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def sequence_reshape(x, length, new_dim, name=None):
    """Each row's valid steps [B, T, D] read with the width `new_dim`:
    [B, T D / new_dim, new_dim] and the lengths ``length D / new_dim``
    (int64).  Raises ValueError where a row's valid size does not divide
    (the lengths read back to the host, as JAX checks eager ones)."""
    B, T, D = (int(s) for s in x.shape)
    if (T * D) % new_dim:
        raise ValueError(f"T*D={T * D} not divisible by new_dim={new_dim}")
    if (D % new_dim) and (new_dim % D):
        raise ValueError("new_dim must divide or be divisible by D")
    lens = _host_ints(length)
    if ((lens * D) % new_dim).any():
        raise ValueError(
            "sequence_reshape would drop data: per-row valid sizes "
            f"{(lens * D).tolist()} not divisible by new_dim={new_dim}")
    out_lens = _lens(length, x.device) * D // new_dim
    return x.reshape(B, (T * D) // new_dim, new_dim), out_lens


def sequence_scatter(x, index, updates, length, name=None):
    """`x` [N] with ``updates[b, j]`` added at ``index[b, j]`` for each
    row's first `length` positions (the others add 0 at index 0)."""
    valid = _valid(_lens(length, x.device), index.shape[1])
    flat_idx = torch.where(valid, index.long(), 0).reshape(-1)
    flat_upd = torch.where(valid, updates, torch.zeros(
        (), dtype=updates.dtype, device=updates.device)).reshape(-1)
    return x.index_add(0, flat_idx, flat_upd.to(x.dtype))


def sequence_slice(x, length, offset, slice_length, name=None):
    """Row b's steps ``offset[b]`` .. ``offset[b] + slice_length[b] - 1``
    at the front of a [B, T, ...] output, zeros after (and where the
    slice runs past T); returns it and `slice_length` (int64)."""
    T = x.shape[1]
    offs = _lens(offset, x.device)
    n = _lens(slice_length, x.device)
    src = offs[:, None] + torch.arange(T, device=x.device)[None, :]
    keep = _valid(n, T) & (src < T)
    gathered = torch.gather(x, 1, _trail(torch.clamp(src, max=T - 1), x
                                         ).expand(x.shape))
    return torch.where(_trail(keep, x), gathered, torch.zeros(
        (), dtype=x.dtype, device=x.device)), n


__all__ = ["add_position_encoding", "beam_candidates", "beam_search",
           "beam_search_decode", "conv_shift", "crf_decoding",
           "im2sequence", "linear_chain_crf", "nce", "row_conv",
           "sample_logits", "sampling_id", "segment_max", "segment_mean",
           "segment_min", "segment_pool", "segment_sum", "sequence_concat",
           "sequence_conv", "sequence_enumerate", "sequence_expand",
           "sequence_expand_as", "sequence_first_step",
           "sequence_last_step", "sequence_pad", "sequence_pool",
           "sequence_reshape", "sequence_reverse", "sequence_scatter",
           "sequence_slice", "sequence_softmax", "sequence_unpad"]
