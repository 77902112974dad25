"""Functions of ``paddle_tpu/ops/nn_extra.py``: `gather_tree` (the
beam-search backtrace), and `celu` and `pairwise_distance`, which the
`CELU` and `PairwiseDistance` layers need.  The rest of that module is
not ported yet."""
import torch

from ..amp.auto_cast import cast_inputs


def gather_tree(ids, parents):
    """Full beams from per-step choices: `ids` and `parents` [T, batch,
    beam] (a parent is the beam index, within its batch row, that a
    step's choice extends), walked backwards from each final beam on
    the device; [T, batch, beam] tokens."""
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beams))
        beams = torch.gather(parents[t], 1, beams)
    return torch.stack(toks[::-1])


def celu(x, alpha=1.0, name=None):
    x, = cast_inputs("celu", x)
    return torch.clamp(x, min=0.0) + torch.clamp(
        alpha * (torch.exp(x / alpha) - 1.0), max=0.0)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    x, y = cast_inputs("pairwise_distance", x, y)
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


__all__ = ["celu", "gather_tree", "pairwise_distance"]
