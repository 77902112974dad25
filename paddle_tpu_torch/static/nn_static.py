"""Static-graph op emission (``paddle_tpu/static/nn_static.py``), exposed
as ``static.nn``.

Each emitted Operator keeps the JAX package's ``type``, ``in_order`` and
``out_order`` (the AMP policy and `append_backward` key on them) and
carries `fn`, the op's function of tensors.  The ported ops are those of
ResNet-50's training program (conv2d, batch_norm with its fused act,
pool2d, relu, the elementwise ops, flatten, fc, softmax_with_cross_entropy
and mean); dropout, control flow and the rest of the JAX file are not
ported yet.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..nn.functional import batch_stats
from .param_helper import create_parameter
from .program import default_main_program, Variable


def _cur_block():
    return default_main_program().current_block()


def _pair(x, n=2):
    if isinstance(x, (list, tuple)):
        return tuple(int(v) for v in x) * (1 if len(x) == n else n)
    return (int(x),) * n


def _conv_padding(padding, k, stride, dilation, nd):
    """A paddle padding spec as [(lo, hi)] per spatial dim (or the string
    "SAME" / "VALID")."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def emit(op_type, ins, outs_spec, fn, attrs=None):
    """ins: list[(slot, Variable)].  outs_spec entries are either
    (slot, shape, dtype) — a fresh output var — or (slot, Variable) —
    an IN-PLACE alias (the op writes back into an existing var, the
    MeanOut/ParamOut pattern).  fn: positional input tensors -> a tensor
    or a tuple of them."""
    block = _cur_block()
    outs = []
    inputs = {}
    in_order = []
    for slot, v in ins:
        inputs.setdefault(slot, []).append(v.name)
        in_order.append(v.name)
    outputs = {}
    out_order = []
    for spec in outs_spec:
        if len(spec) == 2 and isinstance(spec[1], Variable):
            o = spec[1]  # alias: write back in place
        else:
            slot, shape, dtype = spec
            o = block.create_var(shape=shape, dtype=dtype)
        outputs.setdefault(spec[0], []).append(o.name)
        out_order.append(o.name)
        outs.append(o)
    op = block.append_op(op_type, inputs, outputs, attrs or {}, fn=fn)
    op.in_order = in_order
    op.out_order = out_order
    return outs[0] if len(outs) == 1 else outs


def _infer_eltwise_shape(x, y):
    try:
        return list(np.broadcast_shapes(tuple(x.shape or ()),
                                        tuple(y.shape or ())))
    except ValueError:
        return x.shape


_ELEMENTWISE = {
    "elementwise_add": lambda a, b: a + b,
    "elementwise_sub": lambda a, b: a - b,
    "elementwise_mul": lambda a, b: a * b,
    "elementwise_div": lambda a, b: a / b,
}


def _elementwise_emit(op_type, x, y, reverse=False):
    fn = _ELEMENTWISE[op_type]
    if not isinstance(y, Variable):
        c = float(y)
        if reverse:
            return emit(op_type, [("Y", x)], [("Out", x.shape, x.dtype)],
                        lambda b: fn(c, b), attrs={"scalar": c,
                                                   "reverse": True})
        return emit(op_type, [("X", x)], [("Out", x.shape, x.dtype)],
                    lambda a: fn(a, c), attrs={"scalar": c,
                                               "reverse": False})
    shape = _infer_eltwise_shape(x, y)
    if reverse:
        x, y = y, x
    return emit(op_type, [("X", x), ("Y", y)], [("Out", shape, x.dtype)], fn)


# ---- data & feed ----

def data(name, shape, dtype="float32"):
    """paddle.static.data: a fed variable (no gradient)."""
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, stop_gradient=True)


# ---- layers ----

def fc(x, size, weight_attr=None, bias_attr=None, activation=None,
       name=None):
    in_dim = int(np.prod(x.shape[1:])) if len(x.shape) > 2 else x.shape[-1]
    w = create_parameter([in_dim, size], x.dtype, attr=weight_attr)
    ins = [("Input", x), ("W", w)]

    def fn(xv, wv, *b):
        xf = xv.reshape(xv.shape[0], -1) if xv.ndim > 2 else xv
        out = xf @ wv
        if b:
            out = out + b[0]
        return out

    if bias_attr is not False:
        b = create_parameter([size], x.dtype, attr=bias_attr, is_bias=True)
        ins.append(("Bias", b))
    out = emit("fc", ins, [("Out", [x.shape[0], size], x.dtype)], fn)
    if activation:
        out = _maybe_act(out, activation)
    return out


def relu(x, name=None):
    return emit("relu", [("X", x)], [("Out", x.shape, x.dtype)], torch.relu)


def mean(x, name=None):
    return emit("reduce_mean", [("X", x)], [("Out", [1], x.dtype)],
                lambda v: v.mean().reshape(1))


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1):
    def fn(lg, l):
        logp = F.log_softmax(lg, dim=axis)
        if soft_label:
            return -(l * logp).sum(dim=axis, keepdim=True)
        li = l
        if li.ndim == lg.ndim and li.shape[axis] == 1:
            li = li.squeeze(axis)
        return -torch.take_along_dim(logp, li[..., None].long(), dim=axis)

    shape = list(logits.shape)
    shape[axis] = 1
    return emit("softmax_with_cross_entropy",
                [("Logits", logits), ("Label", label)],
                [("Loss", shape, logits.dtype)], fn,
                attrs={"soft_label": soft_label, "axis": axis})


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    """NCHW input, OIHW filter, the same padding on both sides of each
    dim (string and asymmetric paddings are not ported yet)."""
    k = _pair(filter_size)
    s = _pair(stride)
    d = _pair(dilation)
    pad = _conv_padding(padding, k, s, d, 2)
    if (isinstance(pad, str) or any(lo != hi for lo, hi in pad)
            or data_format != "NCHW"):
        raise NotImplementedError(
            f"conv2d with padding={padding!r}, data_format={data_format!r} "
            "is not ported yet (symmetric explicit paddings, NCHW)")
    C = input.shape[1]
    w = create_parameter([num_filters, C // groups, k[0], k[1]], input.dtype,
                         attr=param_attr)
    ins = [("Input", input), ("Filter", w)]
    ph, pw = pad[0][0], pad[1][0]

    def fn(xv, wv, *b):
        out = F.conv2d(xv, wv, None, s, (ph, pw), d, groups)
        if b:
            out = out + b[0].reshape(1, -1, 1, 1)
        return out

    if bias_attr is not False:
        b = create_parameter([num_filters], input.dtype, attr=bias_attr,
                             is_bias=True)
        ins.append(("Bias", b))

    H, W = input.shape[2], input.shape[3]
    oh = (H + 2 * ph - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (W + 2 * pw - d[1] * (k[1] - 1) - 1) // s[1] + 1
    out = emit("conv2d", ins,
               [("Output", [input.shape[0], num_filters, oh, ow],
                 input.dtype)],
               fn, attrs={"strides": list(s), "paddings": pad,
                          "dilations": list(d), "groups": groups})
    return _maybe_act(out, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, name=None):
    """Max pooling pads with -inf (a tie's gradient goes to the first
    maximum in window order); average pooling counts the padding."""
    if global_pooling:
        def fn(v):
            if pool_type == "max":
                return v.amax(dim=(2, 3), keepdim=True)
            return v.mean(dim=(2, 3), keepdim=True)

        return emit("pool2d", [("X", input)],
                    [("Out", [input.shape[0], input.shape[1], 1, 1],
                      input.dtype)],
                    fn, attrs={"global_pooling": True,
                               "pooling_type": pool_type})
    k = _pair(pool_size)
    s = _pair(pool_stride)
    p = _pair(pool_padding)

    def fn(v):
        if pool_type == "max":
            return F.max_pool2d(v, k, s, p)
        return F.avg_pool2d(v, k, s, p, count_include_pad=True)

    H, W = input.shape[2], input.shape[3]
    oh = (H + 2 * p[0] - k[0]) // s[0] + 1
    ow = (W + 2 * p[1] - k[1]) // s[1] + 1
    return emit("pool2d", [("X", input)],
                [("Out", [input.shape[0], input.shape[1], oh, ow],
                  input.dtype)],
                fn, attrs={"global_pooling": False, "pooling_type": pool_type,
                           "ksize": list(k), "strides": list(s),
                           "paddings": list(p)})


_BN_ACTS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None):
    """Training: statistics in float32 over every axis but 1, the
    variance biased (E[x²] − mean²); the running stats move by
    ``m * momentum + stat * (1 - momentum)`` with that same variance and
    are written back in place (MeanOut / VarianceOut alias Mean /
    Variance); the output returns to the input's dtype after the fused
    act."""
    if act is not None and act not in _BN_ACTS:
        raise ValueError(f"batch_norm act={act!r} unsupported; "
                         f"one of {sorted(_BN_ACTS)} or None")
    C = input.shape[1]
    scale = create_parameter([C], "float32", attr=param_attr,
                             default_value=1.0)
    bias = create_parameter([C], "float32", attr=bias_attr, is_bias=True)
    mean = create_parameter([C], "float32", default_value=0.0,
                            stop_gradient=True, name_hint="bn_mean")
    var = create_parameter([C], "float32", default_value=1.0,
                           stop_gradient=True, name_hint="bn_var")

    reduce_axes = tuple(i for i in range(len(input.shape)) if i != 1)
    shape = [1, C] + [1] * (len(input.shape) - 2)

    def fn(v, sc, b, m, va):
        vf = v.float() if v.dtype != torch.float32 else v
        if is_test:
            mean_u, var_u = m, va
        else:
            mean_u, var_u = batch_stats(vf, reduce_axes)
        out = (vf - mean_u.reshape(shape)) * torch.rsqrt(
            var_u.reshape(shape) + epsilon)
        out = out * sc.reshape(shape) + b.reshape(shape)
        if act:
            out = _BN_ACTS[act](out)
        out = out.to(v.dtype)
        if is_test:
            return out
        new_m = m * momentum + mean_u * (1.0 - momentum)
        new_v = va * momentum + var_u * (1.0 - momentum)
        return out, new_m, new_v

    ins = [("X", input), ("Scale", scale), ("Bias", bias), ("Mean", mean),
           ("Variance", var)]
    attrs = {"is_test": is_test, "momentum": momentum,
             "epsilon": epsilon, "act": act}
    if is_test:
        return emit("batch_norm", ins, [("Y", input.shape, input.dtype)],
                    fn, attrs=attrs)
    out, _, _ = emit("batch_norm", ins,
                     [("Y", input.shape, input.dtype),
                      ("MeanOut", mean), ("VarianceOut", var)],
                     fn, attrs=attrs)
    return out


def flatten(x, axis=1, name=None):
    shape = [int(np.prod(x.shape[:axis]) or -1), int(np.prod(x.shape[axis:]))]

    def fn(v):
        return v.reshape(v.shape[0] if axis == 1 else -1, -1)

    return emit("flatten", [("X", x)], [("Out", shape, x.dtype)], fn,
                attrs={"axis": axis})


def _maybe_act(out, act):
    if act == "relu":
        return relu(out)
    if act in ("tanh", "sigmoid", "softmax"):
        raise NotImplementedError(f"the {act} op is not ported yet")
    if act:
        raise ValueError(f"unsupported act {act!r}")
    return out
