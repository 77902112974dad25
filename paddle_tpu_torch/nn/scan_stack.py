"""Scan over identical layers (``paddle_tpu/nn/scan_stack.py``).

JAX stacks the layers' parameters and runs one traced body under
``lax.scan``, to keep the program's size constant in depth.  Torch
compiles nothing ahead, so here the scan is a plain loop over the
layers with the scan's arithmetic: each layer's output is cast to the
carry's dtype (the input's) before the next, and with ``remat`` each
layer runs under activation checkpointing (``jax.checkpoint`` of the
body), its recompute drawing the dropout masks of its forward.  Dropout
draws from the generator passed down, layer after layer.  A call on a
per-rank list inside a ``distributed.spmd`` scope checkpoints each
layer across the group's ranks.
"""
from ..distributed import spmd


def _check_identical(layers):
    names = sorted(n for n, _ in layers[0].named_parameters())
    for layer in layers[1:]:
        got = sorted(n for n, _ in layer.named_parameters())
        if got != names:
            raise ValueError(
                "scan_layer_stack requires identically-structured layers; "
                f"got param sets {names} vs {got}")


def _carry(y, x):
    if isinstance(x, list):
        return [yi.to(xi.dtype) for yi, xi in zip(y, x)]
    return y.to(x.dtype)


def scan_layer_stack(layers, x, mask=None, remat=False, op_type=None,
                     generator=None):
    """`layers` (identically structured) applied in turn to `x`; `mask`,
    when given, is each layer's second argument and `generator` its
    ``generator=``."""
    layers = list(layers)
    if len(layers) == 1:
        args = (x,) if mask is None else (x, mask)
        return layers[0](*args, generator=generator)
    _check_identical(layers)
    for layer in layers:
        args = (x,) if mask is None else (x, mask)
        if remat:
            _, mods, _ = spmd.ranks_of(layer, x)
            y = spmd.checkpoint_ranks(
                mods, spmd.listed(generator, 1),
                lambda a=args, lyr=layer: lyr(*a, generator=generator))
        else:
            y = layer(*args, generator=generator)
        x = _carry(y, x)
    return x
