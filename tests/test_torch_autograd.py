"""Port parity: ``paddle.autograd`` (``paddle_tpu_torch.autograd``:
`backward`, `grad` with ``create_graph`` and ``allow_unused``, `PyLayer`
with its `PyLayerContext`, the grad-mode switches and their top-level
names) against the JAX package's on the CPU, values and gradients within
1e-5.  `PyLayer.backward` returns one gradient per tensor argument that
needs one, as in JAX; the port maps them onto torch's one per forward
argument."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.autograd as jautograd
import paddle_tpu_torch as ptorch
from paddle_tpu_torch import autograd as pautograd

TOL = 1e-5
RNG = np.random.default_rng(0)
A = RNG.standard_normal((3, 4)).astype(np.float32)
B = RNG.standard_normal((3, 4)).astype(np.float32)


def _jt(a, grad=True):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _pt(a, grad=True):
    return torch.tensor(a, requires_grad=grad)


def _layers(P, M):
    """The same user layers over a package: `P` its top level, `M` its
    autograd module."""

    class Exp(M.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = P.exp(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return P.multiply(dy, y)

    class ScaledMulAdd(M.PyLayer):
        """(x * y * scale, x + y): two tensor arguments, a float one, two
        outputs; its backward deliberately doubles y's gradient."""

        @staticmethod
        def forward(ctx, x, scale, y):
            ctx.save_for_backward(x, y)
            ctx.scale = scale
            return P.multiply(x, y) * scale, P.add(x, y)

        @staticmethod
        def backward(ctx, d_prod, d_sum):
            x, y = ctx.saved_tensor()
            return (P.multiply(d_prod, y) * ctx.scale + d_sum,
                    (P.multiply(d_prod, x) * ctx.scale + d_sum) * 2.0)

    class OnlyY(M.PyLayer):
        """x needs no gradient: backward returns y's alone."""

        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x)
            return P.multiply(x, y)

        @staticmethod
        def backward(ctx, dout):
            (x,) = ctx.saved_tensor()
            return P.multiply(dout, x)

    return Exp, ScaledMulAdd, OnlyY


JEXP, JSMA, JONLY = _layers(paddle, jautograd)
PEXP, PSMA, PONLY = _layers(ptorch, pautograd)


def test_pylayer_custom_backward_matches_jax():
    jx, px = _jt(A), _pt(A)
    paddle.sum(JEXP.apply(jx)).backward()
    PEXP.apply(px).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(px.grad.numpy(), np.exp(A), rtol=1e-6)


@pytest.mark.parametrize("y_grad", [True, False], ids=["both", "x_only"])
def test_pylayer_grads_map_onto_tensor_arguments(y_grad):
    """Two outputs, a float argument between the tensors: each tensor
    argument that needs a gradient gets its own, in order, as JAX's."""
    cot = RNG.standard_normal((3, 4)).astype(np.float32)
    jx, jy, px, py = _jt(A), _jt(B, y_grad), _pt(A), _pt(B, y_grad)
    jp, js = JSMA.apply(jx, 0.5, jy)
    pp, ps = PSMA.apply(px, 0.5, py)
    np.testing.assert_allclose(pp.detach().numpy(), np.asarray(jp._data),
                               rtol=TOL, atol=TOL)
    paddle.sum(jp * _jt(cot, False) + js).backward()
    (pp * torch.from_numpy(cot) + ps).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=TOL, atol=TOL)
    if y_grad:
        np.testing.assert_allclose(py.grad.numpy(),
                                   np.asarray(jy.grad._data), rtol=TOL,
                                   atol=TOL)
    else:
        assert py.grad is None and jy.grad is None


def test_pylayer_backward_of_the_argument_that_needs_it():
    """x needs no gradient, so backward returns one, for y."""
    jx, jy, px, py = _jt(A, False), _jt(B), _pt(A, False), _pt(B)
    paddle.sum(JONLY.apply(jx, jy)).backward()
    PONLY.apply(px, py).sum().backward()
    np.testing.assert_allclose(py.grad.numpy(), np.asarray(jy.grad._data),
                               rtol=TOL, atol=TOL)
    assert px.grad is None


def test_pylayer_without_grad_returns_the_forward_outputs():
    out = PEXP.apply(_pt(A, False))
    assert not out.requires_grad
    with ptorch.no_grad():
        assert not PEXP.apply(_pt(A)).requires_grad


def test_grad_accumulation_diamond_and_across_calls():
    """The JAX golden tests: a diamond sums both paths; two backward calls
    accumulate."""
    x = _pt(np.array([2.0, 3.0], np.float32))
    a = ptorch.multiply(x, x)
    pautograd.backward(ptorch.sum(ptorch.add(a, ptorch.add(a, x))))
    np.testing.assert_allclose(x.grad.numpy(), 4 * x.detach().numpy() + 1,
                               rtol=1e-6)
    z = _pt(np.ones(3, np.float32))
    for _ in range(2):
        pautograd.backward(ptorch.sum(ptorch.multiply(z, z)))
    np.testing.assert_allclose(z.grad.numpy(), 4 * np.ones(3), rtol=1e-6)


def test_backward_with_grad_tensors_matches_jax():
    """Non-scalar outputs, one seeded with a cotangent, one with ones;
    a tensor that needs no gradient is skipped."""
    cot = RNG.standard_normal((3, 4)).astype(np.float32)
    jx, px = _jt(A), _pt(A)
    jautograd.backward([paddle.tanh(jx), paddle.exp(jx), _jt(B, False)],
                       [_jt(cot, False), None, None])
    pautograd.backward([torch.tanh(px), torch.exp(px), _pt(B, False)],
                       [torch.from_numpy(cot), None, None])
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=TOL, atol=TOL)


def test_grad_with_create_graph_matches_jax():
    """Double grad: d(3x^2)/dx = 6x; `grad` writes no ``.grad``."""
    jx, px = _jt(np.array([3.0, -1.5], np.float32)), _pt(
        np.array([3.0, -1.5], np.float32))
    (jg1,) = paddle.grad(paddle.sum(jx * jx * jx), jx, create_graph=True)
    (jg2,) = paddle.grad(paddle.sum(jg1), jx)
    (g1,) = ptorch.grad((px * px * px).sum(), px, create_graph=True)
    (g2,) = ptorch.grad(g1.sum(), px)
    np.testing.assert_allclose(g1.detach().numpy(), np.asarray(jg1._data),
                               rtol=TOL)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2._data), rtol=TOL)
    np.testing.assert_allclose(g2.numpy(), [18.0, -9.0], rtol=1e-6)
    assert px.grad is None


def test_grad_allow_unused_matches_jax():
    jx, jy, px, py = _jt(A), _jt(B), _pt(A), _pt(B)
    with pytest.raises(RuntimeError):
        paddle.grad(paddle.sum(jx * 2.0), [jx, jy])
    with pytest.raises(RuntimeError):
        ptorch.grad((px * 2.0).sum(), [px, py])
    jg = paddle.grad(paddle.sum(jx * 2.0), [jx, jy], allow_unused=True)
    g = ptorch.grad((px * 2.0).sum(), [px, py], allow_unused=True)
    assert jg[1] is None and g[1] is None
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jg[0]._data))


def test_grad_mode_switches_and_names():
    """`enable_grad`, `is_grad_enabled`, `set_grad_enabled` and `grad` at
    the top level as in JAX; ``autograd.backward_mode.backward``."""
    for name in ("grad", "enable_grad", "is_grad_enabled",
                 "set_grad_enabled", "no_grad"):
        assert hasattr(paddle, name) and hasattr(ptorch, name), name
    assert ptorch.is_grad_enabled()
    with ptorch.no_grad():
        assert not ptorch.is_grad_enabled()
        with ptorch.enable_grad():
            assert ptorch.is_grad_enabled()
    ptorch.set_grad_enabled(False)
    try:
        assert not ptorch.is_grad_enabled()
    finally:
        ptorch.set_grad_enabled(True)
    from paddle_tpu_torch.autograd.backward_mode import backward
    assert backward is pautograd.backward
    assert {"PyLayer", "PyLayerContext", "backward"} <= set(
        pautograd.__all__)
