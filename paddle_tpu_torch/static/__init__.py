"""The static graph (``paddle.static``) of the JAX package's
``paddle_tpu/static/``, on PyTorch: `Program`, `program_guard`, `data`,
the ops of ``static.nn``, `append_backward`, ``Optimizer.minimize``,
``static.amp.decorate`` and the `Executor` with its `Scope`.

What trains ResNet-50 (``bench.py::bench_resnet``) is ported: conv2d,
batch_norm, pool2d, relu, the elementwise ops, flatten, fc,
softmax_with_cross_entropy and mean, with their grad ops, static bf16
AMP, ``run``, ``run_chained`` and ``cost_analysis``.  So is what the
Paddle book's static programs use: dropout, embedding, reshape, the
activations and the rest of ``nn_static.py``'s ported ops; control flow
(``cond``, ``while_loop``, ``switch_case``, ``case``) and `StaticRNN`
over sub-blocks; `Print`, `Assert`, ``select_input``/``select_output``
and ``assign_value``; and the inference clone
(``Program.clone(for_test=True)``).
"""
from . import amp_static as amp
from . import nn_static as nn
from .backward import append_backward, gradients
from .controlflow import case, cond, switch_case, while_loop
from .executor import (CompiledBlock, Executor, Scope, global_scope,
                       replay_ops)
from .extras import (Assert, Print, StaticRNN, assign_value, select_input,
                     select_output)
from .nn_static import accuracy, data
from .param_helper import ParamAttr, create_parameter
from .program import (Block, Operator, Parameter, Program, Variable,
                      default_main_program, default_startup_program,
                      name_scope, program_guard)

amp_decorate = amp.amp_decorate

# ``static.nn`` carries control flow and the builders, as in the JAX
# package
nn.cond = cond
nn.while_loop = while_loop
nn.switch_case = switch_case
nn.case = case
nn.Print = Print
nn.Assert = Assert
nn.select_input = select_input
nn.select_output = select_output
nn.StaticRNN = StaticRNN
nn.create_parameter = create_parameter

__all__ = ["Assert", "Block", "CompiledBlock", "Executor", "Operator",
           "ParamAttr", "Parameter", "Print", "Program", "Scope",
           "StaticRNN", "Variable", "accuracy", "amp", "amp_decorate",
           "append_backward", "assign_value", "case", "cond",
           "create_parameter", "data", "default_main_program",
           "default_startup_program", "global_scope", "gradients",
           "name_scope", "nn", "program_guard", "replay_ops",
           "select_input", "select_output", "switch_case", "while_loop"]
