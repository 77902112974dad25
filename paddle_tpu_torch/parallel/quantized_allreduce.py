"""The sharded step's two all-reduces per layer, after the row-split
``wo`` and ``w2`` matmuls (``paddle_tpu/parallel/quantized_allreduce.py``).

- `allreduce_sum` is the float32 all-reduce GSPMD places there in the JAX
  package: every partial is copied to each distinct device and summed in
  shard order 0..tp-1, so every shard holds the same bits.
- `quantized_ring_allreduce` is the EQuARX-style int8 ring, hop by hop as
  the JAX package runs it under ``shard_map``: the rows are padded to a
  multiple of tp and cut into tp chunks; a reduce-scatter of tp-1 hops,
  each shipping the running chunk as int8 plus its scalar abs-max scale
  to shard ``(i + 1) % tp``, where it is dequantized and the local chunk
  added; then an all-gather that quantizes each finished chunk once and
  walks it round the ring, every shard (its owner included) reading it
  through the same dequant, so the result is bit-identical on every
  shard.  The rounding is ``generation/quantized_kv.py``'s, the JAX
  package's.

Plain PyTorch: the JAX package computes both outside any Pallas kernel.
A partial list holds one tensor per shard, on that shard's device; so
does each result.
"""
import torch
import torch.nn.functional as F

from ..generation.quantized_kv import dequantize_int8, quantize_int8


def allreduce_sum(partials, mesh):
    """The float32 all-reduce: the sum of `partials` in shard order, one
    copy per distinct device, as a per-shard list."""
    def total(i):
        dev = mesh.devices[i]
        acc = partials[0].to(dev)
        for p in partials[1:]:
            acc = acc + p.to(dev)
        return acc

    return mesh.per_device(total)


def _quant(x):
    """(int8, float32 scalar scale) of one chunk: its abs-max, rounded by
    the one quantization home."""
    s = torch.amax(torch.abs(x)).float()
    return quantize_int8(x, s), s


def quantized_ring_allreduce(partials, mesh):
    """Sum the per-shard ``[rows, d]`` `partials` through the quantized
    ring; returns the per-shard results, bit-identical across shards."""
    n = mesh.size
    if n == 1:
        return list(partials)
    rows, d = partials[0].shape
    pad = (-rows) % n
    chunks = [(F.pad(p, (0, 0, 0, pad)) if pad else p).reshape(n, -1, d)
              for p in partials]
    devs = mesh.devices
    # reduce-scatter: after hop t shard i holds the running sum of chunk
    # (i - t) mod n; after n - 1 hops the full sum of chunk (i - n + 2)
    acc = [chunks[i][(i + 1) % n] for i in range(n)]
    for t in range(n - 1):
        sent = [_quant(a) for a in acc]
        acc = [dequantize_int8(sent[(i - 1) % n][0].to(devs[i]),
                               sent[(i - 1) % n][1].to(devs[i]))
               + chunks[i][(i - t) % n] for i in range(n)]
    own = [(i - (n - 2)) % n for i in range(n)]
    # all-gather: each finished chunk quantized once, walked round the ring
    held = [_quant(a) for a in acc]
    out = [torch.zeros_like(c) for c in chunks]
    for i in range(n):
        out[i][own[i]] = dequantize_int8(*held[i])
    for t in range(n - 1):
        held = [(held[(i - 1) % n][0].to(devs[i]),
                 held[(i - 1) % n][1].to(devs[i])) for i in range(n)]
        for i in range(n):
            out[i][(own[i] - 1 - t) % n] = dequantize_int8(*held[i])
    full = [o.reshape(-1, d) for o in out]
    return [f[:rows] for f in full] if pad else full


def quantized_matmul_allreduce(mesh):
    """``qmm(a, w)``: the per-shard products ``a[i] @ w[i]`` of a
    column-split activation and a row-split weight, summed through the
    quantized ring; a drop-in for the two row-split matmuls and their
    float32 all-reduce."""
    def qmm(a, w):
        return quantized_ring_allreduce([x @ y for x, y in zip(a, w)], mesh)

    return qmm


def quantized_collective_bytes(num_layers, rows, d_model, tp_degree):
    """Estimated on-wire bytes of ONE sharded dispatch's two per-layer
    all-reduces under the quantized ring: the int8 payload times the ring
    factor ``2 (N-1)/N``, plus the per-hop scale scalars (the JAX
    package's arithmetic)."""
    if tp_degree <= 1:
        return 0
    payload = int(rows) * int(d_model)           # int8: 1 byte/elem
    per_ar = (payload * 2 * (tp_degree - 1) / tp_degree
              + 2 * (tp_degree - 1) * 4)         # scale scalars
    return int(2 * num_layers * per_ar)
