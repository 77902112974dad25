"""Port parity: the static graph's sequence functions (``static.nn``'s
``sequence_*`` family and ``row_conv``, ops of the port's `Program`),
each program built alike in both packages, the port's scope carried
from the JAX startup's (``jax_static_start.numpy_start``), both run on
the CPU: every fetched output and every parameter gradient
(``append_backward``) within 1e-5.  The inputs are zero past each
length, where JAX's ``sequence_conv`` agrees with the port's (it reads
a row's padding: ``test_torch_sequence_ops.py``).  As in JAX, the
static ``sequence_conv`` makes no bias whatever ``bias_attr`` says."""
import numpy as np
import pytest
import torch_threads  # noqa: F401

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from test_torch_static_controlflow import _hold, _run_both

B, T, D = 3, 5, 4
RNG = np.random.default_rng(0)
LENS = np.array([5, 2, 3])
X = (RNG.standard_normal((B, T, D))
     * (np.arange(T)[None, :, None] < LENS[:, None, None])).astype(np.float32)
IDS = RNG.integers(0, 9, (B, T))


def _with_grads(static, loss, outs):
    return [loss] + list(outs) + [g for _, g in static.append_backward(loss)]


def _total(static, outs):
    total = static.nn.mean(outs[0])
    for o in outs[1:]:
        total = total + static.nn.mean(o)
    return total


def _pools(static):
    x = static.data("x", [B, T, D])
    n = static.data("len", [B], "int64")
    c = static.nn.sequence_conv(x, n, 6, filter_size=3, act="tanh",
                                bias_attr=None)
    outs = [static.nn.sequence_pool(c, n, k)
            for k in ("sum", "average", "sqrt", "max", "last", "first")]
    outs += [static.nn.sequence_first_step(c, n),
             static.nn.sequence_last_step(c, n),
             static.nn.sequence_softmax(c, n),
             static.nn.sequence_reverse(c, n),
             static.nn.row_conv(x, 2, act="tanh")]
    return _with_grads(static, _total(static, outs), outs)


def _rest(static):
    x = static.data("x", [B, T, D])
    n = static.data("len", [B], "int64")
    ids = static.data("ids", [B, T], "int64")
    w = static.create_parameter([D], "float32")
    xw = x * w
    cat, cat_len = static.nn.sequence_concat([xw, xw], [n, n])
    rs, rs_len = static.nn.sequence_reshape(xw, n, 2)
    sl, sl_len = static.nn.sequence_slice(xw, n, n * 0 + 1, n - 1)
    first = static.nn.sequence_first_step(xw, n)
    ea = static.nn.sequence_expand_as(first, xw, n)
    ex = static.nn.sequence_expand(first, [2, 0, 1])
    flat = static.nn.reshape(xw, [B * T * D])
    sc = static.nn.sequence_scatter(flat, ids, static.data("upd", [B, T]), n)
    floats = [cat, rs, sl, ea, ex, sc]
    ints = [cat_len, rs_len, sl_len,
            static.nn.sequence_enumerate(ids, n, 3, pad_value=-1)]
    return _with_grads(static, _total(static, floats), floats + ints)


@pytest.mark.parametrize("build", [_pools, _rest], ids=["pools", "rest"])
def test_static_sequence_program_matches_jax(build):
    _hold(*_run_both(build, {"x": X, "len": LENS, "ids": IDS,
                             "upd": X[..., 0].copy()}))


def test_static_sequence_conv_makes_no_bias():
    """``bias_attr`` is read by neither package: one filter parameter."""
    for static in (jstatic, tstatic):
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [B, T, D])
            n = static.data("len", [B], "int64")
            static.nn.sequence_conv(x, n, 6, bias_attr=True)
        params = [v for v in main.global_block().vars.values()
                  if getattr(v, "is_parameter", False)
                  or type(v).__name__ == "Parameter"]
        assert [tuple(p.shape) for p in params] == [(3 * D, 6)], static


def test_static_sequence_expand_needs_host_lengths():
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [B, D])
        n = tstatic.data("len", [B], "int64")
        with pytest.raises(TypeError, match="host lengths"):
            tstatic.nn.sequence_expand(x, n)
