"""Mixture of experts with expert parallelism over an ``expert`` mesh axis
(``paddle_tpu/distributed/fleet/meta_parallel/moe_layer.py``).

GShard top-2 routing as dense one-hot products (no sorting, no dynamic
shapes): `top2_dispatch` gives each token's combine weights over
(expert, capacity slot) and the load-balance loss.  The expert weights
are whole ``[E, ...]`` stacks with ``dist_spec`` ``("expert",)``: the
train steps give each ``expert`` rank E/ep of them.  In a group whose
``expert`` axis is live, each rank's dispatched tokens go to their
experts' ranks by one all-to-all and come back by its inverse (the
transpose of each is the other); outside any group the whole stack runs
with no exchange, as does a stack the step left whole (E not divisible
by the axis).  The expert FFN's GELU is the tanh form (``jax.nn.gelu``'s
default).
"""
import math

import torch

from ....nn import functional as F
from ....nn.initializer import Constant, XavierNormal
from ....nn.layer import create_parameter
from ... import spmd

EXPERT_AXIS = "expert"


def _one_hot(idx, n, dtype):
    """Rows of `n` with a 1 at `idx`; an index outside [0, n) gives a
    row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[:, None] == torch.arange(n, device=idx.device)[None]).to(
        dtype)


def top2_dispatch(logits, capacity):
    """GShard top-2 routing of `logits` [N, E]: ``(combine [N, E, C],
    dispatch bool [N, E, C], aux_loss)``.  A token's second choice queues
    behind every first choice of that expert; tokens past `capacity` are
    dropped (their combine rows are 0).  The aux loss is
    ``E * sum_e mean(mask1_e) * mean(probs_e)``."""
    n, e = logits.shape
    probs = torch.softmax(logits, -1)
    mask1 = _one_hot(probs.argmax(-1), e, logits.dtype)
    mask2 = _one_hot((probs * (1.0 - mask1)).argmax(-1), e, logits.dtype)

    density = mask1.mean(0)
    density_proxy = probs.mean(0)
    aux = (density * density_proxy).sum() * (e * e) / e

    pos1 = torch.cumsum(mask1, 0) - mask1
    pos1_tok = (pos1 * mask1).sum(1)
    keep1 = pos1_tok < capacity
    count1 = mask1.sum(0, keepdim=True)
    pos2 = torch.cumsum(mask2, 0) - mask2 + count1
    pos2_tok = (pos2 * mask2).sum(1)
    keep2 = pos2_tok < capacity

    g1 = (probs * mask1).sum(1)
    g2 = (probs * mask2).sum(1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    cap1 = _one_hot(pos1_tok.to(torch.int32), capacity, logits.dtype)
    cap2 = _one_hot(pos2_tok.to(torch.int32), capacity, logits.dtype)
    combine = ((g1 * keep1)[:, None, None] * mask1[:, :, None]
               * cap1[:, None, :]
               + (g2 * keep2)[:, None, None] * mask2[:, :, None]
               * cap2[:, None, :])
    return combine, combine > 0.0, aux


def capacity_of(tokens, num_experts, capacity_factor):
    return max(int(math.ceil(2 * tokens / num_experts * capacity_factor)), 4)


class MoELayer(torch.nn.Module):
    """Top-2 gated mixture of expert FFNs: ``forward(x [B, S, H]) -> [B, S,
    H]``; the load-balance loss of the last forward is in ``aux_loss``
    (each rank's module holds its rank's)."""

    def __init__(self, hidden_size, ffn_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, aux_weight=0.01, name=None, *,
                 generator=None):
        super().__init__()
        if top_k != 2:
            raise ValueError("MoELayer implements GShard top-2 gating")
        self.hidden_size = hidden_size
        self.ffn_hidden = ffn_hidden
        self.num_experts = e = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self.aux_loss = None

        def weight(shape):
            return create_parameter(shape, default_initializer=XavierNormal(),
                                    generator=generator)

        def bias(shape):
            return create_parameter(shape, is_bias=True,
                                    default_initializer=Constant(0.0),
                                    generator=generator)

        self.gate_weight = weight([hidden_size, e])
        self.w1 = weight([e, hidden_size, ffn_hidden])
        self.b1 = bias([e, ffn_hidden])
        self.w2 = weight([e, ffn_hidden, hidden_size])
        self.b2 = bias([e, hidden_size])
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.dist_spec = (EXPERT_AXIS,)
            p.is_distributed = True

    def _experts(self, m, buf):
        """The experts `m` holds on their tokens [e_local, n, H], in the
        promoted dtype of the tokens and the weights."""
        dt = torch.promote_types(buf.dtype, m.w1.dtype)
        h1 = torch.nn.functional.gelu(
            torch.einsum("ech,ehf->ecf", buf.to(dt), m.w1.to(dt))
            + m.b1[:, None, :], approximate="tanh")
        dt = torch.promote_types(h1.dtype, m.w2.dtype)
        return torch.einsum("ecf,efh->ech", h1.to(dt), m.w2.to(dt)) \
            + m.b2[:, None, :]

    def forward(self, x):
        grp, mods, xs = spmd.ranks_of(self, x)
        e = self.num_experts
        # a stack the step left whole (E not divisible) runs on each rank
        ep = grp.axis_size(EXPERT_AXIS) if mods[0].w1.shape[0] < e else 1
        routed, expert_in = [], []
        for m, xi in zip(mods, xs):
            b, s, h = xi.shape
            tokens = xi.reshape(b * s, h)
            cap = capacity_of(b * s, e, self.capacity_factor)
            combine, dispatch, aux = top2_dispatch(
                F.matmul_promoted(tokens, m.gate_weight).float(), cap)
            m.aux_loss = aux.float()
            routed.append((combine.to(xi.dtype), cap, xi.shape))
            expert_in.append(torch.einsum("nec,nh->ech",
                                          dispatch.to(xi.dtype), tokens))
        if ep == 1:
            expert_out = [self._experts(m, buf)
                          for m, buf in zip(mods, expert_in)]
        else:
            e_local = e // ep
            bufs = grp.all_to_all(
                [buf.reshape(ep, e_local, cap, buf.shape[-1])
                 for buf, (_, cap, _) in zip(expert_in, routed)],
                EXPERT_AXIS, 0, 0)
            outs = []
            for m, buf, (_, cap, _) in zip(mods, bufs, routed):
                hdim = buf.shape[-1]
                out = self._experts(m, buf.transpose(0, 1).reshape(
                    e_local, ep * cap, hdim))
                outs.append(out.reshape(e_local, ep, cap, hdim)
                            .transpose(0, 1).contiguous())
            expert_out = [o.reshape(e, cap, o.shape[-1]) for o, (_, cap, _)
                          in zip(grp.all_to_all(outs, EXPERT_AXIS, 0, 0),
                                 routed)]
        ys = [torch.einsum("nec,ech->nh", comb.to(eo.dtype), eo)
              .reshape(shape)
              for (comb, _, shape), eo in zip(routed, expert_out)]
        return spmd.unlisted(ys, x)


__all__ = ["EXPERT_AXIS", "MoELayer", "capacity_of", "top2_dispatch"]
