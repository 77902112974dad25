"""Static parameters: a var in the main program and an ``init`` op in the
startup program (``paddle_tpu/static/param_helper.py``), with the
initializers and ``ParamAttr`` they take.

An ``init`` op's fn is ``fn(generator, device)``: the executor runs the
startup program's init ops in order on one ``torch.Generator`` of its
device, seeded from the startup program's ``random_seed``.  Values need
not equal the JAX package's draws; the weight carry
(``models/weights.py::scope_from_numpy``) makes them equal where a test
needs it.
"""
import torch

from ..nn.initializer import Constant, XavierNormal
from .program import convert_dtype, default_main_program, \
    default_startup_program, dtype_name


class ParamAttr:
    """The fields of ``paddle.ParamAttr`` that `create_parameter` reads.
    A regularizer raises: the JAX static path never applies one (the
    dygraph ``nn.ParamAttr`` takes it, for the eager step)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        if regularizer is not None:
            raise NotImplementedError(
                "ParamAttr(regularizer=...) is not ported to the static "
                "graph: its JAX path never applies one")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_value=None, stop_gradient=False,
                     name_hint="param", default_initializer=None):
    attr = ParamAttr._to_attr(attr)
    main = default_main_program()
    startup = default_startup_program()
    name = (name or (attr.name if attr and attr.name else None)
            or main._unique_name("b" if is_bias else name_hint))
    v = main.global_block().create_parameter(name=name, shape=shape,
                                             dtype=dtype)
    v.stop_gradient = stop_gradient or (attr is not None
                                        and not attr.trainable)
    v.trainable = not v.stop_gradient
    v.optimize_attr = {"learning_rate": attr.learning_rate if attr else 1.0}

    init = attr.initializer if attr and attr.initializer else None
    if init is None:
        init = default_initializer  # non-mutating: attr may be shared
    if init is None:
        if default_value is not None:
            init = Constant(default_value)
        elif is_bias:
            init = Constant(0.0)
        else:
            init = XavierNormal()
    v.initializer = init

    # the var's twin in the startup program, with its init op; drawn in
    # float32 and cast to the declared dtype (an int32 counter stays int)
    torch_dtype = convert_dtype(dtype)
    sv = startup.global_block().create_parameter(name=name, shape=shape,
                                                 dtype=dtype)
    sv.initializer = init
    startup.global_block().append_op(
        "init", {}, {"Out": [name]},
        {"shape": shape, "dtype": dtype_name(torch_dtype)},
        fn=lambda generator, device: init(shape, torch.float32, generator,
                                          device).to(torch_dtype))
    return v
