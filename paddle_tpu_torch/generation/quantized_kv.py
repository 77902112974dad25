"""Int8 KV pools: per-page per-head abs-max scales and the shared math.

An int8 pool stores each K/V element as a signed byte on a per-page grid:
every physical page carries one float32 abs-max scale per head (k and v
separately, per layer), ``[num_pages + 1, H]`` beside the pool (the last
row is the sink page's, see kv_cache).  A stored element decodes as::

    value = int8 * (scale[page, head] * (1 / 127))

with the factor computed first (`dequant_factor`).  The CUDA kernels
dequantize each staged page block with that expression and the plain
versions dequantize their gathered view with it, so the operands entering
the score and P.V products are bitwise equal on both paths.  Quantize is
``round(x * (127 / max(s, SCALE_EPS)))`` clipped to +-127, round half to
even (``torch.round``, like ``jnp.round``): the same expression order as
the JAX package, so the two packages write bitwise-equal bytes and scales.

`quantized_pool_write` is the one write path (the ragged and fused steps'
in-step writes, and the pool's eager writes), three steps:

1. scatter-MAX each written row's per-head abs-max into the page scales
   (a page's scales only grow while it is live; the pool zeroes them when
   it hands the page out again);
2. REQUANTIZE the touched pages from the old scale to the new one, so old
   rows stay readable under the one per-page scale (a reused page's stale
   bytes decode to zero under its zero scale and stay zero);
3. quantize the new rows against the final scale and scatter them.

Step 2 writes identical bytes for duplicate page entries (it transforms
content that predates the write), so a scatter that lets any duplicate
win stays deterministic; step 3's (page, row) targets are unique, sink
rows aside.  Sentinel rows (page id ``num_pages``) land in the sink page
and the sink's own scale row, never a real page's.
"""
import numpy as np
import torch

QMAX = 127.0
INV_QMAX = np.float32(1.0 / 127.0)
# divisor floor for all-zero pages: with scale == 0 every payload value is
# 0 (the scale is an abs-max over a superset of the payload), so the floor
# only keeps 0/0 out of the arithmetic and never rounds a real value
SCALE_EPS = np.float32(1e-30)


def dequant_factor(scale):
    """``scale * (1/127)``: the multiplier int8 storage decodes with."""
    return scale * float(INV_QMAX)


def quantize_int8(x, scale):
    """Symmetric int8 quantization of `x` against an abs-max `scale`
    (broadcastable), in float32.  ``127 / max(s, eps)`` is a true
    tensor division (a Python scalar over a tensor would take the
    reciprocal and multiply, which rounds differently)."""
    safe = torch.clamp(scale.float(), min=float(SCALE_EPS))
    q = torch.round(x.float() * (safe.new_full((), QMAX) / safe))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize_int8(q, scale):
    """int8 -> float32 with the ``q * (scale / 127)`` factor."""
    return q.float() * dequant_factor(scale.float())


def quantized_pool_write(pool, scale, pages, rows, x, layout):
    """Write payload rows ``x[i]`` ([n, H, D], any float dtype) into
    ``(pages[i], rows[i])`` of one int8 pool and its ``[P + 1, H]`` float32
    scale array, IN PLACE; returns ``(pool, scale)``.

    The pool's last page is the sink: page ids at or past it are clamped
    onto it, so sentinel rows write the sink page and the sink's scale row.
    `layout` is the pool's: "token" ``[P + 1, page_size, H, D]`` or
    "kernel" ``[H, P + 1, page_size, D]``; the scale array is ``[P + 1,
    H]`` in both."""
    sink = scale.shape[0] - 1
    pages = torch.clamp(pages.long(), max=sink)
    rows = rows.long()
    x = x.float()
    a = torch.amax(torch.abs(x), dim=-1)                  # [n, H]
    s_old = scale[pages]                                  # [n, H]
    scale.scatter_reduce_(0, pages[:, None].expand_as(a), a, "amax")
    s_new = scale[pages]
    q = quantize_int8(x, s_new[:, :, None])               # [n, H, D]
    if layout == "kernel":
        # per-row copies of the touched pages, [H, n, page_size, D]
        so = s_old.t()[:, :, None, None]
        sn = s_new.t()[:, :, None, None]
        pool[:, pages] = quantize_int8(
            dequantize_int8(pool[:, pages], so), sn)
        pool[:, pages, rows] = q.transpose(0, 1)
    else:
        # [n, page_size, H, D]
        so = s_old[:, None, :, None]
        sn = s_new[:, None, :, None]
        pool[pages] = quantize_int8(dequantize_int8(pool[pages], so), sn)
        pool[pages, rows] = q
    return pool, scale
