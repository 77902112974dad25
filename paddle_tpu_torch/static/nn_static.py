"""Static-graph op emission (``paddle_tpu/static/nn_static.py``), exposed
as ``static.nn``.

Each emitted Operator keeps the JAX package's ``type``, ``in_order`` and
``out_order`` (the AMP policy and `append_backward` key on them) and
carries `fn`, the op's function of tensors.  The ported ops are those of
ResNet-50's training program (conv2d, batch_norm with its fused act,
pool2d, relu, the elementwise ops, flatten, fc, softmax_with_cross_entropy
and mean) and of the Paddle book's static programs: dropout, reshape,
embedding, matmul, the tanh, sigmoid and softmax activations, transpose,
reduce_sum, cross_entropy, accuracy, the comparisons, concat, layer_norm,
nce and crf_decoding; and the sequence family (``sequence_pool`` and its
first and last steps, ``sequence_softmax``, ``sequence_reverse``,
``sequence_conv``, ``sequence_concat``, ``sequence_enumerate``,
``sequence_expand``, ``sequence_expand_as``, ``sequence_reshape``,
``sequence_scatter``, ``sequence_slice``) and ``row_conv``, each an op
over ``ops.sequence_ops``' function whose output shapes come from one
run of it on zeros (`_infer_emit`, JAX's ``eval_shape``).  Control flow
is ``controlflow.py``, StaticRNN and the utility ops ``extras.py``; the
rest of the JAX file is not ported yet.

Dropout draws its mask from a counter-based hash of the op's base seed,
its persistable step counter and each element's index
(``generation.sampling.hash_uniform_device``): the executor advances the
counter once a run, so every run draws a fresh mask, the grad op
differentiates the forward's own, and the card and the CPU draw the same
mask for one seed.
"""
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..generation.sampling import (_GOLDEN, _MASK32, _mix32_device,
                                   _mulmod32, hash_uniform_device)
from ..nn.functional import batch_stats
from ..ops import sequence_ops as S
from .param_helper import create_parameter
from .program import (_identity, convert_dtype, default_main_program,
                      Variable)


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

_COMPARE = {
    "less_than": lambda a, b: a < b,
    "less_equal": lambda a, b: a <= b,
    "greater_than": lambda a, b: a > b,
    "greater_equal": lambda a, b: a >= b,
    "equal": lambda a, b: a == b,
    "not_equal": lambda a, b: a != b,
}


def _compare_emit(op_type, x, y):
    """A comparison op: a bool output, against a var or a python
    scalar."""
    fn = _COMPARE[op_type]
    if not isinstance(y, Variable):
        c = float(y)
        return emit(op_type, [("X", x)], [("Out", x.shape, "bool")],
                    lambda a: fn(a, c), attrs={"scalar": c})
    shape = _infer_eltwise_shape(x, y)
    return emit(op_type, [("X", x), ("Y", y)], [("Out", shape, "bool")], fn)


def less_than(x, y):
    return _compare_emit("less_than", x, y)


def greater_than(x, y):
    return _compare_emit("greater_than", x, y)


def equal(x, y):
    return _compare_emit("equal", x, y)


def not_equal(x, y):
    return _compare_emit("not_equal", x, y)


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
    return _maybe_act(out, activation)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    def fn(a, b):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = torch.matmul(a, b)
        return out * alpha if alpha != 1.0 else out

    xs, ys = list(x.shape), list(y.shape)
    if transpose_x:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    return emit("matmul_v2", [("X", x), ("Y", y)],
                [("Out", xs[:-1] + [ys[-1]], x.dtype)], fn,
                attrs={"trans_x": transpose_x, "trans_y": transpose_y,
                       "alpha": alpha})


def _maybe_act(out, act):
    """`out` through the static emitter of an activation attr string
    (`fc`'s `activation`, the norms' `act`); no string, `out` itself."""
    if not act:
        return out
    table = {"relu": relu, "tanh": tanh_act, "sigmoid": sigmoid_act,
             "softmax": softmax}
    if act not in table:
        raise ValueError(f"unsupported activation attr {act!r}; "
                         f"one of {sorted(table)}")
    return table[act](out)


def relu(x, name=None):
    return emit("relu", [("X", x)], [("Out", x.shape, x.dtype)], torch.relu)


def tanh_act(x, name=None):
    return emit("tanh", [("X", x)], [("Out", x.shape, x.dtype)], torch.tanh)


def sigmoid_act(x, name=None):
    return emit("sigmoid", [("X", x)], [("Out", x.shape, x.dtype)],
                torch.sigmoid)


def softmax(x, axis=-1, name=None):
    return emit("softmax", [("X", x)], [("Out", x.shape, x.dtype)],
                lambda v: torch.softmax(v, dim=axis), attrs={"axis": axis})


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    shape = [x.shape[p] for p in perm] if x.shape else x.shape
    return emit("transpose2", [("X", x)], [("Out", shape, x.dtype)],
                lambda v: v.permute(perm), attrs={"axis": perm})


def mean(x, name=None):
    return emit("reduce_mean", [("X", x)], [("Out", [1], x.dtype)],
                lambda v: v.mean().reshape(1))


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    axis = tuple(dim) if isinstance(dim, (list, tuple)) else dim
    shape = [1] if axis is None and not keep_dim else x.shape

    def fn(v):
        if axis is None:
            out = v.sum()
            return out.reshape(shape) if not keep_dim else out.reshape(
                [1] * v.dim())
        return v.sum(dim=axis, keepdim=keep_dim)

    return emit("reduce_sum", [("X", x)], [("Out", shape, x.dtype)], fn,
                attrs={"dim": list(axis) if isinstance(axis, tuple)
                       else axis, "keep_dim": keep_dim})


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the probabilities `input` (floored at 1e-12) at `label`;
    `ignore_index` is accepted and never read, as in the JAX package."""
    def fn(p, lab):
        logp = torch.log(torch.clamp(p, min=1e-12))
        if soft_label:
            return -(lab * logp).sum(dim=-1, keepdim=True)
        li = lab
        if li.dim() == p.dim() and li.shape[-1] == 1:
            li = li.squeeze(-1)
        return -torch.take_along_dim(logp, li[..., None].long(), dim=-1)

    shape = list(input.shape[:-1]) + [1]
    return emit("cross_entropy", [("X", input), ("Label", label)],
                [("Y", shape, input.dtype)], fn,
                attrs={"soft_label": soft_label})


def accuracy(input, label, k=1):
    """The share of rows whose argmax is the label ([1] float32; `k` is
    accepted and never read, as in the JAX package)."""
    def fn(p, lab):
        pred = torch.argmax(p, dim=-1)
        return (pred == lab.reshape(pred.shape)).float().mean().reshape(1)

    return emit("accuracy", [("Out", input), ("Label", label)],
                [("Accuracy", [1], "float32")], fn)


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


def _dropout_keep(base, step, shape, keep_p):
    """The keep mask of one run: element i kept where the hash uniform of
    (the run's seed, i) is below `keep_p`, the run's seed a 32-bit mix of
    `base` and the step counter `step` ([1] int32, on the device: no host
    read)."""
    seed = _mix32_device(_mulmod32(step.to(torch.int64) & _MASK32, _GOLDEN)
                         ^ base)
    n = int(np.prod(shape))
    u = hash_uniform_device(seed, torch.arange(n, device=step.device))
    return (u < keep_p).reshape(shape)


def dropout(x, dropout_prob=0.5, is_test=False, seed=None, name=None):
    """upscale_in_train dropout; at `is_test` or probability 0 the
    identity.  A persistable int32 step counter (``dropout_step_N``, in
    ``program._rng_step_vars``) feeds the mask with the base seed: `seed`,
    else torch's initial seed (``paddle.seed``) mixed with the counter's
    name, so stacked dropouts draw apart."""
    if is_test or dropout_prob == 0.0:
        return emit("dropout", [("X", x)], [("Out", x.shape, x.dtype)],
                    _identity, attrs={"dropout_prob": dropout_prob,
                                      "is_test": is_test, "seed": seed or 0})
    ctr = create_parameter([1], "int32", default_value=0, stop_gradient=True,
                           name_hint="dropout_step")
    if seed is not None:
        base = int(seed) & _MASK32
    else:
        base = ((torch.initial_seed() & _MASK32)
                ^ zlib.crc32(ctr.name.encode())) & 0x7FFFFFFF
    prog = default_main_program()
    if not hasattr(prog, "_rng_step_vars"):
        prog._rng_step_vars = []
    prog._rng_step_vars.append(ctr.name)
    keep_p = 1.0 - dropout_prob

    def fn(v, c):
        keep = _dropout_keep(base, c, v.shape, keep_p)
        return torch.where(keep, v / keep_p, 0.0)

    return emit("dropout", [("X", x), ("Seed", ctr)],
                [("Out", x.shape, x.dtype)], fn,
                attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                       "seed": base})


def reshape(x, shape, name=None):
    """A 0 keeps the input's dim; a -1 first dim takes the run's batch."""
    shape2 = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]

    def fn(v):
        return v.reshape([v.shape[0] if s == -1 and i == 0 else s
                          for i, s in enumerate(shape2)])

    return emit("reshape2", [("X", x)], [("Out", shape2, x.dtype)], fn,
                attrs={"shape": list(shape2)})


def flatten(x, axis=1, name=None):
    shape = [int(np.prod(x.shape[:axis]) or -1), int(np.prod(x.shape[axis:]))]

    def fn(v):
        return v.reshape(v.shape[0] if axis == 1 else -1, -1)

    return emit("flatten", [("X", x)], [("Out", shape, x.dtype)], fn,
                attrs={"axis": axis})


def embedding(input, size, padding_idx=None, param_attr=None,
              dtype="float32"):
    """``lookup_table_v2`` of a new [size[0], size[1]] table; a lookup of
    `padding_idx` gives zeros (a negative one masks nothing, as in the
    JAX package)."""
    w = create_parameter(list(size), dtype, attr=param_attr)

    def fn(idx, wv):
        out = wv[idx.long()]
        if padding_idx is not None:
            out = out * (idx != padding_idx)[..., None].to(out.dtype)
        return out

    return emit("lookup_table_v2", [("Ids", input), ("W", w)],
                [("Out", list(input.shape) + [size[1]], dtype)], fn,
                attrs={"padding_idx": padding_idx})


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Normalizes over the dims from `begin_norm_axis` (biased variance
    E[(x - mean)²]), then the float32 scale and shift of that size."""
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    ins = [("X", input)]
    if scale:
        ins.append(("Scale", create_parameter(
            norm_shape, "float32", attr=param_attr, default_value=1.0)))
    if shift:
        ins.append(("Bias", create_parameter(
            norm_shape, "float32", attr=bias_attr, is_bias=True)))

    def fn(v, *wb):
        v2 = v.reshape(tuple(v.shape[:begin_norm_axis]) + (-1,))
        m = v2.mean(dim=-1, keepdim=True)
        var = torch.square(v2 - m).mean(dim=-1, keepdim=True)
        out = (v2 - m) * torch.rsqrt(var + epsilon)
        if scale:
            out = out * wb[0]
        if shift:
            out = out + wb[-1]
        return out.reshape(v.shape)

    out = emit("layer_norm", ins, [("Y", input.shape, input.dtype)], fn,
               attrs={"begin_norm_axis": begin_norm_axis,
                      "epsilon": epsilon, "scale": scale, "shift": shift})
    return _maybe_act(out, act)


def concat_static(xs, axis=0):
    shape = list(xs[0].shape)
    ax = axis % len(shape)
    shape[ax] = sum(x.shape[ax] for x in xs)
    return emit("concat", [(f"X{i}", x) for i, x in enumerate(xs)],
                [("Out", shape, xs[0].dtype)],
                lambda *vs: torch.cat(vs, dim=axis))


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """`ops.sequence_ops.nce` over a new [num_total_classes, D] weight and
    bias.  As in the JAX package, `sample_weight`, `custom_dist` and
    `is_sparse` are accepted and never read."""
    D = int(input.shape[-1])
    w = create_parameter([num_total_classes, D], input.dtype,
                         attr=param_attr)
    ins = [("Input", input), ("Label", label), ("Weight", w)]
    if bias_attr is not False:
        ins.append(("Bias", create_parameter([num_total_classes],
                                             input.dtype, attr=bias_attr,
                                             is_bias=True)))

    def fn(xv, lv, wv, *rest):
        return S.nce(xv, wv, lv, rest[0] if rest else None,
                     num_total_classes, num_neg_samples, sampler, seed)

    return emit("nce", ins, [("Out", [input.shape[0], 1], input.dtype)], fn)


def crf_decoding(input, param_attr, label=None, length=None):
    """`ops.sequence_ops.crf_decoding` under the transition var
    `param_attr` (the one `linear_chain_crf` trains)."""
    ins = [("Emission", input), ("Transition", param_attr),
           ("Length", length)]
    return emit("crf_decoding", ins,
                [("Out", list(input.shape[:2]), "int64")],
                lambda ev, tv, lv: S.crf_decoding(ev, tv, lv))


def fill_constant(shape, dtype, value):
    """A source op: `shape` filled with `value` on the run's device."""
    dt = convert_dtype(dtype)
    return emit("fill_constant", [], [("Out", list(shape), dtype)],
                lambda device: torch.full(tuple(shape), value, dtype=dt,
                                          device=device),
                attrs={"shape": list(shape), "value": value})


def _infer_emit(op_type, fn, ins, attrs=None):
    """`emit` an op whose output shapes and dtypes come from one run of
    `fn` on zero CPU tensors of its inputs' shapes (a -1 dim taken as 1),
    JAX's ``jax.eval_shape``: an output's leading 1 becomes -1 where an
    input's leading dim is -1."""
    with torch.no_grad():
        outs = fn(*[torch.zeros([1 if int(d) < 0 else int(d)
                                 for d in v.shape], dtype=v.dtype)
                    for _, v in ins])
    multi = isinstance(outs, tuple)
    dyn_batch = any(v.shape and int(v.shape[0]) < 0 for _, v in ins)
    spec = []
    for i, o in enumerate(outs if multi else (outs,)):
        shape = list(o.shape)
        if dyn_batch and shape and shape[0] == 1:
            shape[0] = -1
        spec.append((f"Out{i}" if multi or i else "Out", shape, o.dtype))
    return emit(op_type, ins, spec, fn, attrs=attrs)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """`ops.sequence_ops.row_conv` under a new [future_context_size + 1,
    D] filter."""
    w = create_parameter([future_context_size + 1, int(input.shape[-1])],
                         input.dtype, attr=param_attr)
    return _maybe_act(_infer_emit("row_conv", S.row_conv,
                                  [("X", input), ("Filter", w)]), act)


def sequence_pool(input, length, pool_type="average"):
    return _infer_emit(
        "sequence_pool", lambda xv, lv: S.sequence_pool(xv, lv, pool_type),
        [("X", input), ("Length", length)])


def sequence_first_step(input, length):
    return _infer_emit("sequence_first_step", S.sequence_first_step,
                       [("X", input), ("Length", length)])


def sequence_last_step(input, length):
    return _infer_emit("sequence_last_step", S.sequence_last_step,
                       [("X", input), ("Length", length)])


def sequence_softmax(input, length):
    return _infer_emit("sequence_softmax", S.sequence_softmax,
                       [("X", input), ("Length", length)])


def sequence_reverse(x, length, name=None):
    return _infer_emit("sequence_reverse", S.sequence_reverse,
                       [("X", x), ("Length", length)])


def sequence_conv(input, length, num_filters, filter_size=3,
                  filter_stride=1, padding=True, padding_start=None,
                  param_attr=None, bias_attr=None, act=None, name=None):
    """`ops.sequence_ops.sequence_conv` under a new [filter_size · D,
    num_filters] filter.  As the JAX package's, it makes no bias whatever
    `bias_attr` says, and reads neither `filter_stride` nor
    `padding`."""
    w = create_parameter([filter_size * int(input.shape[-1]), num_filters],
                         input.dtype, attr=param_attr)

    def fn(xv, lv, wv):
        return S.sequence_conv(xv, wv, lv, context_length=filter_size,
                               context_start=padding_start)

    return _maybe_act(_infer_emit(
        "sequence_conv", fn, [("X", input), ("Length", length),
                              ("Filter", w)]), act)


def sequence_concat(inputs, lengths, name=None):
    """The concatenated rows and their lengths (two outputs)."""
    n = len(inputs)
    return _infer_emit(
        "sequence_concat",
        lambda *vals: S.sequence_concat(list(vals[:n]), list(vals[n:])),
        [(f"X{i}", v) for i, v in enumerate(inputs)]
        + [(f"Len{i}", v) for i, v in enumerate(lengths)])


def sequence_enumerate(input, length, win_size, pad_value=0, name=None):
    return _infer_emit(
        "sequence_enumerate",
        lambda xv, lv: S.sequence_enumerate(xv, lv, win_size, pad_value),
        [("X", input), ("Length", length)])


def sequence_expand(x, ref_lengths, name=None):
    """Its output's row count is the sum of `ref_lengths`, so they are
    host values (a list or an array), not a program Variable."""
    if isinstance(ref_lengths, Variable):
        raise TypeError(
            "static sequence_expand needs host lengths (list/ndarray): the "
            "output shape is data-dependent")
    return _infer_emit("sequence_expand",
                       lambda xv: S.sequence_expand(xv, ref_lengths),
                       [("X", x)])


def sequence_expand_as(x, y, ref_length, name=None):
    """Each row of `x` over `ref_length` steps of y's time width."""
    T = int(y.shape[1])
    return _infer_emit(
        "sequence_expand_as",
        lambda xv, yv, lv: S.sequence_expand_as(xv, lv, maxlen=T),
        [("X", x), ("Y", y), ("RefLen", ref_length)])


def sequence_reshape(input, length, new_dim, name=None):
    """The reshaped rows and their lengths (two outputs)."""
    return _infer_emit(
        "sequence_reshape",
        lambda xv, lv: S.sequence_reshape(xv, lv, new_dim),
        [("X", input), ("Length", length)])


def sequence_scatter(input, index, updates, length, name=None):
    return _infer_emit(
        "sequence_scatter", S.sequence_scatter,
        [("X", input), ("Ids", index), ("Updates", updates),
         ("Length", length)])


def sequence_slice(input, length, offset, slice_length, name=None):
    """The slices and their lengths (two outputs)."""
    return _infer_emit(
        "sequence_slice", S.sequence_slice,
        [("X", input), ("Length", length), ("Offset", offset),
         ("SliceLen", slice_length)])
