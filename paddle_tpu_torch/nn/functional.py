"""The functional ops GPT, BERT and ERNIE need, with the JAX package's
semantics (``paddle_tpu/ops/nn_ops.py``, ``ops/loss.py``).  Mixed dtypes
promote as JAX promotes them: a bfloat16 operand meeting a float32 one
computes in float32."""
import torch


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight [in, out], in the promoted dtype
    of x and weight (float32 x and bfloat16 weight: float32)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    return out if bias is None else out + bias


def layer_norm(x, weight, bias, epsilon=1e-5):
    """Normalise over the last axis: mean, centred variance,
    ``(x - mean) * rsqrt(var + epsilon)``, then weight and bias (which
    promote a bfloat16 x to their float32)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + epsilon) * weight + bias


def gelu(x):
    """Exact GELU, ``0.5 x (1 + erf(x / sqrt 2))`` (approximate=False)."""
    return torch.nn.functional.gelu(x)


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def dropout(x, p, training=True, generator=None):
    """``upscale_in_train`` dropout: keep with probability 1 - p and
    divide by it; identity when not training or p == 0.  The keep mask
    draws from `generator`, which it then requires."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def embedding(ids, weight):
    """Rows of `weight` [num, dim] at integer `ids`."""
    return torch.nn.functional.embedding(ids.long(), weight)


IGNORE_INDEX = -100


def softmax_with_cross_entropy(logits, label):
    """Per-position ``-log_softmax(logits)[label]`` with a trailing 1
    ([..., 1]); a label [..., 1] is squeezed first; IGNORE_INDEX
    positions give 0 (their label is clamped before the gather)."""
    logp = torch.log_softmax(logits, dim=-1)
    li = label
    if li.dim() == logits.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    li = li.long()
    safe = li.clamp(0, logits.shape[-1] - 1)
    picked = logp.gather(-1, safe.unsqueeze(-1))
    return torch.where((li == IGNORE_INDEX).unsqueeze(-1),
                       torch.zeros_like(picked), -picked)
