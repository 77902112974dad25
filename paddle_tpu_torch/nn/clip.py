"""Gradient clipping (``paddle_tpu/nn/__init__.py``): callables over
``[(param, grad), ...]`` that the eager optimizer step applies before
its updates.  Norms are taken in float32; a norm clip scales by ``min(1,
clip_norm / max(norm, 1e-6))``; a parameter with ``need_clip = False``
keeps its gradient (it still counts in the global norm).  A sparse
gradient (``Embedding(sparse=True)``) is made dense first, as the
reference merges its SelectedRows."""
import torch


def _need_clip(p):
    return getattr(p, "need_clip", True)


def _densify(params_grads):
    return [(p, g.to_dense() if g is not None and g.is_sparse else g)
            for p, g in params_grads]


def _scale(norm, clip_norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-6), max=1.0)


class ClipGradByGlobalNorm:
    """Every gradient scaled by one factor from the norm of all of
    them."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        params_grads = _densify(params_grads)
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = _scale(norm, self.clip_norm)
        return [(p, g) if g is None or not _need_clip(p)
                else (p, (g * clip).to(g.dtype)) for p, g in params_grads]


class ClipGradByNorm:
    """Each gradient scaled by a factor from its own norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in _densify(params_grads):
            if g is None or not _need_clip(p):
                out.append((p, g))
                continue
            clip = _scale(torch.sqrt(g.float().square().sum()),
                          self.clip_norm)
            out.append((p, (g * clip).to(g.dtype)))
        return out


class ClipGradByValue:
    """Each gradient clipped elementwise to [min, max] (min = -max by
    default)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g) if g is None or not _need_clip(p)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in _densify(params_grads)]


def utils_clip_grad_norm_(parameters, max_norm):
    """Clip the ``.grad`` of `parameters` in place by their global
    norm."""
    clip = ClipGradByGlobalNorm(max_norm)
    pg = [(p, p.grad) for p in parameters if p.grad is not None]
    for (p, _), (_, g) in zip(pg, clip(pg)):
        p.grad = g
