"""Context parallelism over a ``seq`` mesh axis: ring attention and
Ulysses (``paddle_tpu/parallel/context_parallel.py``).

Each ``seq`` rank holds a contiguous chunk of the sequence, [B, H,
L/S, D]; the ranks run as one group over per-rank lists
(``distributed.spmd``), and causal masks use global positions (rank
``r`` holds positions ``r L/S ..``).

- Ring: the K/V chunks rotate around the ring (rank k receives rank
  k - 1's) while each rank accumulates an online softmax for its own
  queries: S block products of [L/S, L/S], the score memory L²/S² per
  step.  Rows that have seen no visible key yet keep the running max at
  NEG_INF; their weights are re-masked to 0.  Composite torch ops, as
  the JAX ring is composite einsums.
- Ulysses: an all-to-all turns [B, H, L/S, D] into [B, H/S, L, D]
  (heads scattered, sequence gathered), attention runs over the whole
  sequence on H/S heads, and the inverse all-to-all brings the rows
  back.  With ``use_flash`` it runs the flash kernels
  (``ops.flash_attention.FlashAttention``, no key mask), whose refusal
  of a shape raises; the heads must divide by S.

Both are differentiable through the collectives' transposes.
"""
import math

import torch

from ..distributed import spmd
from ..ops.attention import scaled_dot_product_attention
from ..ops.flash_attention import FlashAttention, shapes_fit_kernels

NEG_INF = -1e30
SEQ_AXIS = "seq"


def seq_axis_in_scope(axis_name=SEQ_AXIS):
    """True inside a group scope whose `axis_name` axis has size > 1."""
    state = spmd.current()
    return state is not None and state[0].axis_size(axis_name) > 1


def seq_chunk_offset(local_len, axis_name=SEQ_AXIS):
    """Each rank's global sequence offset (its `axis_name` index times
    `local_len`), a list over the open group's ranks; ``[0]`` outside
    one."""
    state = spmd.current()
    if state is None:
        return [0]
    grp = state[0]
    return [grp.coord(r, axis_name) * local_len for r in range(grp.size)]


def ring_attention(grp, q, k, v, causal, axis_name=SEQ_AXIS):
    """q, k, v: per-rank lists of [B, H, L/S, D] chunks; the per-rank
    outputs, in q's dtype."""
    n = grp.axis_size(axis_name)
    ranks = [grp.coord(r, axis_name) for r in range(grp.size)]
    lq, lk = q[0].shape[2], k[0].shape[2]
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    qs = [(x * scale).float() for x in q]
    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
           for x in q]
    m = [torch.full(x.shape[:3], NEG_INF, dtype=torch.float32,
                    device=x.device) for x in q]
    lsum = [torch.zeros(x.shape[:3], dtype=torch.float32, device=x.device)
            for x in q]
    kc, vc = list(k), list(v)
    for i in range(n):
        for r, rank in enumerate(ranks):
            s = torch.einsum("bhqd,bhkd->bhqk", qs[r], kc[r].float())
            if causal:
                src = (rank - i) % n
                dev = s.device
                qpos = rank * lq + torch.arange(lq, device=dev)
                kpos = src * lk + torch.arange(lk, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m[r], s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
            alpha = torch.exp(m[r] - m_new)
            lsum[r] = lsum[r] * alpha + p.sum(-1)
            acc[r] = acc[r] * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc[r].float())
            m[r] = m_new
        if i < n - 1:
            kc = grp.ppermute(kc, axis_name, 1)
            vc = grp.ppermute(vc, axis_name, 1)
    return [(a / torch.where(ls > 0, ls, torch.ones_like(ls))[..., None])
            .to(x.dtype) for a, ls, x in zip(acc, lsum, q)]


def ulysses_attention(grp, q, k, v, causal, use_flash,
                      axis_name=SEQ_AXIS):
    """q, k, v: per-rank lists of [B, H, L/S, D] chunks; attention over
    the gathered sequence on H/S heads per rank."""
    n = grp.axis_size(axis_name)
    heads = q[0].shape[1]
    if heads % n:
        raise ValueError(f"ulysses requires heads ({heads}) divisible by "
                         f"seq-axis size ({n})")
    qg = grp.all_to_all(q, axis_name, 1, 2)
    kg = grp.all_to_all(k, axis_name, 1, 2)
    vg = grp.all_to_all(v, axis_name, 1, 2)
    scale = 1.0 / math.sqrt(qg[0].shape[-1])
    out = []
    for qi, ki, vi in zip(qg, kg, vg):
        b, h, lq, d = qi.shape
        lk = ki.shape[2]
        if use_flash:
            if not shapes_fit_kernels(lq, lk, d):
                raise ValueError(f"the flash kernels do not take Lq {lq}, "
                                 f"Lk {lk}, head_dim {d}")
            o = FlashAttention.apply(
                (qi * scale).reshape(b * h, lq, d).contiguous(),
                ki.reshape(b * h, lk, d).contiguous(),
                vi.reshape(b * h, lk, d).contiguous(), None, causal, h)
            out.append(o.reshape(b, h, lq, d))
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", (qi * scale).float(), ki.float())
        if causal:
            visible = torch.ones(lq, lk, dtype=torch.bool,
                                 device=s.device).tril(lk - lq)
            s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, -1)
        out.append(torch.einsum("bhqk,bhkd->bhqd", w, vi.float())
                   .to(qi.dtype))
    return grp.all_to_all(out, axis_name, 2, 1)


def context_parallel_attention(q, k, v, mode="ring", axis_name=SEQ_AXIS,
                               causal=True, use_flash=False):
    """Sequence-parallel attention of per-rank lists of [B, H, L/S, D]
    chunks inside a group scope; outside one (or on tensors), plain
    scaled dot-product attention."""
    if not (isinstance(q, list) and seq_axis_in_scope(axis_name)):
        outs = [scaled_dot_product_attention(
            qi, ki, vi, is_causal=causal, use_flash=use_flash)[0]
            for qi, ki, vi in zip(*(spmd.listed(t, 1) for t in (q, k, v)))]
        return spmd.unlisted(outs, q)
    grp = spmd.current()[0]
    if mode in (None, "ring"):
        return ring_attention(grp, q, k, v, causal, axis_name)
    if mode == "ulysses":
        return ulysses_attention(grp, q, k, v, causal, use_flash, axis_name)
    raise ValueError(f"unknown context-parallel mode: {mode!r}")


__all__ = ["NEG_INF", "SEQ_AXIS", "context_parallel_attention",
           "ring_attention", "seq_axis_in_scope", "seq_chunk_offset",
           "ulysses_attention"]
