"""Beam search (``paddle_tpu/ops/sequence_ops.py``: `beam_search`,
`beam_search_decode`), in the dense (batch, beam) layout, on the device.
The rest of that module is not ported yet."""
import torch

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


__all__ = ["beam_candidates", "beam_search", "beam_search_decode"]
