"""``paddle.autograd`` (``paddle_tpu/autograd.py`` and
``core/autograd.py``'s `grad`) on torch's autograd: `backward`, `grad`,
`PyLayer` with its `PyLayerContext`, and the grad-mode switches.

`PyLayer` is a ``torch.autograd.Function`` made for each subclass: its
``backward`` returns one gradient per tensor argument that needs one, in
order (the JAX package's convention), and the Function hands torch one
per forward argument, None for the rest.  `grad` returns dense tensors
where a sparse embedding gives a sparse COO one (JAX's `grad` densifies
its ``IndexedSlices``); `backward` leaves a leaf's sparse ``.grad``
sparse."""
import sys
import types

import torch
from torch import enable_grad, is_grad_enabled, no_grad, set_grad_enabled


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` (one or a list; those that
    need no gradient are skipped) into the leaves' ``.grad``, each seeded
    with its `grad_tensors` entry or ones."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    pairs = [(t, torch.ones_like(t) if g is None else g)
             for t, g in zip(tensors, grad_tensors) if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs],
                                retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of `outputs` (each seeded with ones where
    `grad_outputs` gives none) with respect to `inputs`, as a list, dense
    even where the graph gives a sparse one; None for an input the
    outputs do not reach with `allow_unused`, else RuntimeError.  With
    `create_graph` the gradients are differentiable."""
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    grad_outputs = [torch.ones_like(o) if g is None else g
                    for o, g in zip(outputs, grad_outputs)]
    res = torch.autograd.grad(outputs, inputs, grad_outputs,
                              retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=allow_unused)
    return [g.to_dense() if g is not None and g.is_sparse else g
            for g in res]


class PyLayerContext:
    """What a `PyLayer`'s forward keeps for its backward."""

    def __init__(self):
        self._saved = []
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return self._saved


class PyLayer:
    """A user-defined forward and backward::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                y, = ctx.saved_tensor()
                return dy * y

    ``Exp.apply(x)`` runs `forward` without recording a graph, and its
    outputs' gradients go through `backward`, which returns one gradient
    per tensor argument that requires one (or one alone)."""

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            layer = cls

            def forward(fctx, kwargs, *args):
                fctx.pctx = PyLayerContext()
                out = layer.forward(fctx.pctx, *args, **kwargs)
                return tuple(out) if isinstance(out, list) else out

            def backward(fctx, *cots):
                grads = layer.backward(fctx.pctx, *cots)
                if not isinstance(grads, (list, tuple)):
                    grads = (grads,)
                grads = iter(grads)
                # kwargs first, then one slot per forward argument
                return (None,) + tuple(next(grads, None) if need else None
                                       for need in fctx.needs_input_grad[1:])

            fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
                      {"forward": staticmethod(forward),
                       "backward": staticmethod(backward)})
            cls._torch_function = fn
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        return cls._function().apply(kwargs, *args)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError


# the reference's layout: paddle.autograd.backward_mode.backward
backward_mode = types.ModuleType(__name__ + ".backward_mode")
backward_mode.backward = backward
sys.modules[backward_mode.__name__] = backward_mode

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "is_grad_enabled", "no_grad", "set_grad_enabled"]
