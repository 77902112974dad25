"""`cos_sim` of ``paddle_tpu/ops/loss_extra.py``; the rest of that module
is not ported yet."""
import torch

from ..amp.auto_cast import cast_inputs


def cos_sim(x, y, name=None):
    """Row-wise cosine similarity [N, 1] of `x` [N, D] and `y` [N, D], or
    `y` [1, D] broadcast over the rows of `x`; the norms' product floored
    at 1e-12."""
    x, y = cast_inputs("cos_sim", x, y)
    if y.shape[0] == 1 and x.shape[0] != 1:
        y = y.expand(x.shape)
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    prod = torch.sum(x * y, dim=1, keepdim=True)
    return prod / torch.clamp(xn * yn, min=1e-12)


__all__ = ["cos_sim"]
