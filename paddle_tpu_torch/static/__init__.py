"""The static graph (``paddle.static``) of the JAX package's
``paddle_tpu/static/``, on PyTorch: `Program`, `program_guard`, `data`,
the ops of ``static.nn``, `append_backward`, ``Optimizer.minimize``,
``static.amp.decorate`` and the `Executor` with its `Scope`.

What trains ResNet-50 (``bench.py::bench_resnet``) is ported: conv2d,
batch_norm, pool2d, relu, the elementwise ops, flatten, fc,
softmax_with_cross_entropy and mean, with their grad ops, static bf16
AMP, ``run``, ``run_chained`` and ``cost_analysis``.
"""
from . import amp_static as amp
from . import nn_static as nn
from .backward import append_backward, gradients
from .executor import (CompiledBlock, Executor, Scope, global_scope,
                       replay_ops)
from .nn_static import data
from .param_helper import ParamAttr, create_parameter
from .program import (Block, Operator, Parameter, Program, Variable,
                      default_main_program, default_startup_program,
                      name_scope, program_guard)

amp_decorate = amp.amp_decorate

__all__ = ["Block", "CompiledBlock", "Executor", "Operator", "ParamAttr",
           "Parameter", "Program", "Scope", "Variable", "amp",
           "amp_decorate", "append_backward", "create_parameter", "data",
           "default_main_program", "default_startup_program", "global_scope",
           "gradients", "name_scope", "nn", "program_guard", "replay_ops"]
