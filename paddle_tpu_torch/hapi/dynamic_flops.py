"""`flops` and `static_flops` (``paddle_tpu/hapi/dynamic_flops.py``):
forward FLOPs of a module counted by forward hooks over a dry run, by
the JAX package's rules for convolutions, linears and norms (the
tensor-parallel linears, which are no ``Linear`` there, not counted);
`custom_ops` adds rules per module class.  `static_flops` counts a
static ``Program``'s matmul and conv2d ops from their variables'
shapes."""
import numpy as np

from .model_summary import _zeros

__all__ = ["flops", "static_flops"]


def _count_conv(layer, inputs, output):
    # 2 * Cin/groups * prod(k) * (N * Cout * out_spatial)
    w = layer.weight
    kshape = list(w.shape)
    out = np.prod(output.shape)  # N * Cout * spatial
    groups = int(getattr(layer, "_groups", 1) or 1)
    cin = int(inputs[0].shape[1])
    # weight layout differs between conv ([Cout, Cin/g, k..]) and
    # transpose conv ([Cin, Cout/g, k..]): derive MACs from the INPUT
    # channel count, which is layout-independent
    per_out = 2 * (cin // groups) * int(np.prod(kshape[2:]))
    return int(out * per_out)


def _count_linear(layer, inputs, output):
    w = layer.weight
    return int(2 * np.prod(output.shape) * w.shape[0])


def _count_norm(layer, inputs, output):
    return int(2 * np.prod(inputs[0].shape))


def _default_table():
    from ..nn.layers import common as CM
    from ..nn.layers import conv as C
    from ..nn.layers import norm as N

    table = {}
    for mod, names, fn in [
        (C, ["Conv2D"], _count_conv),
        (CM, ["Linear"], _count_linear),
        (N, ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
             "LayerNorm"], _count_norm),
    ]:
        for n in names:
            table[getattr(mod, n)] = fn
    return table


def flops(net, input_size=None, custom_ops=None, print_detail=False,
          inputs=None):
    """Total forward FLOPs of `net` on a zeros dry run (dynamic_flops.py
    contract).  custom_ops: {LayerClass: fn(layer, inputs, output) -> int}.
    """
    from ..nn.layers.common import ColumnParallelLinear, RowParallelLinear

    table = _default_table()
    custom = dict(custom_ops or {})

    per_layer = []
    handles = []

    def hook_for(name, layer, fn):
        def hook(lyr, h_inputs, h_output):
            n = int(fn(lyr, h_inputs, h_output))
            per_layer.append((name, type(lyr).__name__, n))

        return hook

    for name, layer in net.named_modules(remove_duplicate=False):
        # user counters first, by exact type then isinstance, so a
        # custom counter for a Conv2D subclass beats the default rule
        fn = custom.get(type(layer))
        if fn is None:
            for cls, counter in custom.items():
                if isinstance(layer, cls):
                    fn = counter
                    break
        if fn is None and not isinstance(
                layer, (ColumnParallelLinear, RowParallelLinear)):
            for cls, counter in table.items():
                if isinstance(layer, cls):
                    fn = counter
                    break
        if fn is not None:
            handles.append(layer.register_forward_hook(
                hook_for(name, layer, fn)))

    try:
        if inputs is not None:
            net(*inputs if isinstance(inputs, (list, tuple)) else (inputs,))
        else:
            if input_size is None:
                raise ValueError(
                    "flops() needs input_size or inputs (FLOPs depend on "
                    "activation shapes, unlike summary())")
            sizes = input_size if isinstance(input_size, list) \
                and isinstance(input_size[0], (list, tuple)) \
                else [input_size]
            net(*[_zeros(net, s) for s in sizes])
    finally:
        for h in handles:
            h.remove()

    total = sum(n for _, _, n in per_layer)
    if print_detail:
        for name, kind, n in per_layer:
            print(f"{name:<40}{kind:<20}{n:>16,}")
        print(f"{'Total FLOPs:':<60}{total:>16,}")
    return total


def static_flops(program, print_detail=False):
    """FLOPs of a static Program: estimated from its matmul/conv ops'
    recorded shapes (the static-graph counterpart)."""
    total = 0
    for block in program.blocks:
        for op in block.ops:
            ins = getattr(op, "in_order", None) or op.input_names()
            outs = getattr(op, "out_order", None) or op.output_names()
            if op.type in ("matmul", "mul", "fc"):
                shapes = [block.var(n).shape for n in ins[:2]] \
                    if len(ins) >= 2 else []
                if len(shapes) == 2 and len(shapes[0]) >= 2 \
                        and len(shapes[1]) >= 2:
                    m = int(np.prod([abs(s) for s in shapes[0][:-1]]))
                    k = abs(shapes[0][-1])
                    n = abs(shapes[1][-1])
                    total += 2 * m * k * n
            elif op.type == "conv2d" and outs and len(ins) >= 2:
                oshape = block.var(outs[0]).shape
                wshape = block.var(ins[1]).shape
                total += int(2 * np.prod([abs(s) for s in oshape])
                             * np.prod([abs(s) for s in wshape[1:]]))
    if print_detail:
        print(f"Total FLOPs: {total:,}")
    return total
