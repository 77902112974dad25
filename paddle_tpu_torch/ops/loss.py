"""Loss functions (``paddle_tpu/ops/loss.py``), with the JAX package's
arithmetic: a hard label is clamped into the class range before it is
gathered, so `ignore_index` (-100 by default) never indexes a class.
The cross entropies are on the AMP black list; the others cast their
float32 inputs under dygraph AMP by their JAX op's name."""
import torch

from ..amp.auto_cast import cast_inputs

IGNORE_INDEX = -100


def _reduce_loss(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _hard_label(label, logits, axis):
    """An integer label with the class axis of size 1 squeezed away."""
    li = label
    if li.dim() == logits.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    return li.long()


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=IGNORE_INDEX,
                               return_softmax=False):
    """``-log_softmax(logits)`` at the label along `axis`, the class axis
    kept at size 1; 0 where the label is `ignore_index`.  A
    `soft_label` is a distribution: ``-sum(label * logp)``.  With
    `return_softmax`, also ``softmax(logits)``."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        li = _hard_label(label, logits, axis)
        safe = li.clamp(0, logits.shape[axis] - 1).unsqueeze(axis)
        picked = logp.gather(axis, safe)
        loss = torch.where(li.unsqueeze(axis) == ignore_index,
                           torch.zeros_like(picked), -picked)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def cross_entropy(input, label, weight=None, ignore_index=IGNORE_INDEX,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """``-log_softmax(input)`` at the label along `axis`
    (``log(max(input, 1e-30))`` without `use_softmax`), times the label's
    class `weight`, 0 at `ignore_index`; a `soft_label` is a
    distribution, ``-sum(label * logp)``.  The hard-label mean divides
    the sum by the summed weights of the labels not ignored (their count
    without `weight`), at least 1e-12; otherwise `reduction` is "mean",
    "sum" or "none"."""
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(torch.clamp(input, min=1e-30)))
    if soft_label:
        return _reduce_loss(-(label * logp).sum(dim=axis), reduction)
    li = label
    if li.dim() == input.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    safe = li.long().clamp(0, input.shape[axis] - 1)
    loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(li == ignore_index, torch.zeros_like(loss), loss)
    if reduction != "mean":
        return _reduce_loss(loss, reduction)
    if weight is not None:
        w_safe = label.long().clamp(0, weight.shape[0] - 1)
        denom = torch.where(label == ignore_index,
                            torch.zeros((), dtype=weight.dtype,
                                        device=weight.device),
                            weight[w_safe]).sum()
    else:
        denom = (label != ignore_index).sum().to(loss.dtype)
    return loss.sum() / torch.clamp(denom, min=1e-12)


def nll_loss(input, label, weight=None, ignore_index=IGNORE_INDEX,
             reduction="mean", name=None):
    """``-input[label]`` along axis 1, times the label's class `weight`;
    `ignore_index` is accepted and not applied, and the mean is over
    every entry, as in the JAX package."""
    input, weight = cast_inputs("nll_loss", input, weight)
    loss = -input.gather(1, label.long().unsqueeze(1)).squeeze(1)
    if weight is not None:
        loss = loss * weight[label.long()]
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    """``(input - label)²``, reduced by `reduction`."""
    input, label = cast_inputs("mse_loss", input, label)
    return _reduce_loss((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("l1_loss", input, label)
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber: ``0.5 d² / delta`` below `delta`, ``|d| - 0.5 delta`` above,
    times `delta`."""
    input, label = cast_inputs("smooth_l1", input, label)
    d = input - label
    ad = torch.abs(d)
    out = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce_loss(out * delta, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = cast_inputs("bce_loss", input, label, weight)
    eps = 1e-12
    out = -(label * torch.log(torch.clamp(input, min=eps))
            + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        out = out * weight
    return _reduce_loss(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable ``max(z, 0) - z y + log(1 + exp(-|z|))``; a
    `pos_weight` scales the positive term."""
    logit, label, weight, pos_weight = cast_inputs(
        "bce_with_logits", logit, label, weight, pos_weight)
    z, y = logit, label
    logexp = torch.logaddexp(-torch.abs(z), torch.zeros((), dtype=z.dtype,
                                                         device=z.device))
    if pos_weight is None:
        out = torch.clamp(z, min=0) - z * y + logexp
    else:
        lw = y * (pos_weight - 1) + 1
        out = (1 - y) * z + lw * (logexp + torch.clamp(-z, min=0))
    if weight is not None:
        out = out * weight
    return _reduce_loss(out, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label (log label - input)`` (log of at least 1e-12); batchmean
    divides the sum by the batch."""
    input, label = cast_inputs("kldiv_loss", input, label)
    out = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / float(input.shape[0])
    return _reduce_loss(out, reduction)


def hinge_loss(input, label, name=None):
    input, label = cast_inputs("hinge_loss", input, label)
    return torch.clamp(1.0 - (2.0 * label - 1.0) * input, min=0.0)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = cast_inputs("margin_rank", input, other, label)
    return _reduce_loss(torch.clamp(-label * (input - other) + margin,
                                    min=0.0), reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    num = torch.sum(x1 * x2, dim=axis)
    den = torch.sqrt(torch.sum(x1 * x1, dim=axis)) * torch.sqrt(
        torch.sum(x2 * x2, dim=axis))
    return num / torch.clamp(den, min=eps)


def square_error_cost(input, label):
    input, label = cast_inputs("square_error", input, label)
    return (input - label).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, normalizer = cast_inputs("sigmoid_focal", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + torch.logaddexp(
        -torch.abs(z), torch.zeros((), dtype=z.dtype, device=z.device))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce_loss(out, reduction)


__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_similarity", "cross_entropy", "hinge_loss", "kl_div",
           "l1_loss", "margin_ranking_loss", "mse_loss", "nll_loss",
           "sigmoid_focal_loss", "smooth_l1_loss", "softmax_with_cross_entropy",
           "square_error_cost"]
