"""`summary` (``paddle_tpu/hapi/model_summary.py``): a table of each
leaf module's output shape and parameter count, collected by forward
hooks on a dry run (zeros of `input_size` on the network's device, or
the given `input`), and the totals."""
import numpy as np
import torch

from ..device import resolve_device

__all__ = ["summary", "summary_string"]


def _num_params(layer):
    """(total, trainable) over the parameters registered directly on
    this layer (leaves only — sublayers report their own rows)."""
    own = [p for p in layer._parameters.values() if p is not None]
    return sum(int(np.prod(p.shape)) for p in own), \
        sum(int(np.prod(p.shape)) for p in own if p.requires_grad)


def _totals(net):
    ps = list(net.parameters())
    return (sum(int(np.prod(p.shape)) for p in ps),
            sum(int(np.prod(p.shape)) for p in ps if p.requires_grad))


def _device_of(net):
    for t in net.parameters():
        return t.device
    for t in net.buffers():
        return t.device
    return resolve_device(None, "summary")


def _zeros(net, shape, dtype="float32"):
    """Zeros of `shape` (None or a negative size: 1) in numpy dtype
    `dtype`, on `net`'s device."""
    dims = [1 if d is None or int(d) < 0 else int(d) for d in shape]
    return torch.from_numpy(np.zeros(dims, np.dtype(dtype))).to(
        _device_of(net))


def _shape_of(out):
    if hasattr(out, "shape"):
        return list(out.shape)
    if isinstance(out, (list, tuple)):
        return [_shape_of(o) for o in out if o is not None][:2]
    return []


def summary_string(net, input_size=None, dtypes=None, input=None):
    """(text, stats) form of summary()."""
    rows = []
    handles = []

    def hook_for(name, layer):
        def hook(lyr, inputs, outputs):
            total, trainable = _num_params(lyr)
            rows.append((f"{type(lyr).__name__}-{len(rows) + 1}",
                         name, _shape_of(outputs), total))

        return hook

    for name, layer in net.named_modules(remove_duplicate=False):
        if not layer._modules:  # leaves only
            handles.append(layer.register_forward_hook(
                hook_for(name, layer)))

    try:
        if input is not None:
            net(*input if isinstance(input, (list, tuple)) else (input,))
        elif input_size is not None:
            sizes = input_size if isinstance(input_size, list) \
                and isinstance(input_size[0], (list, tuple)) \
                else [input_size]
            dts = dtypes or ["float32"] * len(sizes)
            args = [_zeros(net, s, dt) for s, dt in zip(sizes, dts)]
            net(*args)
    finally:
        for h in handles:
            h.remove()

    total, trainable = _totals(net)

    w_layer = max([len(r[0]) for r in rows] + [12]) + 2
    w_shape = max([len(str(r[2])) for r in rows] + [12]) + 2
    lines = ["-" * (w_layer + w_shape + 14),
             f"{'Layer (type)':<{w_layer}}{'Output Shape':<{w_shape}}"
             f"{'Param #':>12}",
             "=" * (w_layer + w_shape + 14)]
    for tag, _, shape, n in rows:
        lines.append(f"{tag:<{w_layer}}{str(shape):<{w_shape}}{n:>12,}")
    lines += ["=" * (w_layer + w_shape + 14),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * (w_layer + w_shape + 14)]
    stats = {"total_params": total, "trainable_params": trainable}
    return "\n".join(lines), stats


def summary(net, input_size=None, dtypes=None, input=None):
    """Print the per-layer table; returns {total_params, trainable_params}
    Works with either an input_size
    (zeros dry run) or concrete `input` tensors; with neither, prints
    parameter totals only."""
    if input_size is None and input is None:
        total, trainable = _totals(net)
        print(f"Total params: {total:,}")
        print(f"Trainable params: {trainable:,}")
        return {"total_params": total, "trainable_params": trainable}
    text, stats = summary_string(net, input_size, dtypes, input)
    print(text)
    return stats
