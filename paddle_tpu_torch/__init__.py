"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It serves the generation engine's ragged and legacy steps on an NVIDIA
GPU, with the ragged, paged-decode and chunk-prefill attention kernels;
trains GPT (``models.GPTForPretraining``, ``optimizer.AdamW``,
``parallel.TrainStep``) through the flash-attention forward, dK/dV and
dQ kernels, all written by hand in CUDA C++ for sm_90a (ops/, csrc/);
and pretrains BERT and ERNIE (``models.BertForPretraining``,
``ErnieForPretraining``) on the transformer layers of ``nn``, under the
compiled step's update rules and LR schedulers (``optimizer``); and
trains ResNet-50 through the static ``Program``/``Executor`` with
``append_backward``, static bf16 AMP and Momentum (``static``); and
trains the vision models in dygraph (``vision.models``: LeNet, ResNet,
VGG, MobileNet) through autograd and the optimizers' eager `step`; and
serves a fleet of generation replicas (``serving.FleetRouter``: in
process, in a subprocess or over TCP, with live migration, the page
service, prefill/decode handoff and ``serving.FleetSupervisor``); and
trains GPT over a mesh of ``data`` (ZeRO 0-3), ``pipe``, ``model``
(tensor parallel, ``distributed.fleet.meta_parallel``), ``seq``
(context parallel, ring and Ulysses) and ``expert`` (mixture of
experts) axes, one process running each data shard's ranks in lockstep
(``distributed.spmd``); and trains in dygraph under AMP
(``amp.auto_cast``, ``amp.GradScaler``: the bf16 flash kernels on GPT's
eager step) and through the high-level surface: ``io.DataLoader`` over
datasets and samplers, ``hapi.Model`` with ``metric`` and
``callbacks``, ``summary``, ``flops``, and ``save``/``load`` in the
JAX package's checkpoint format; and trains and decodes the recurrent
nets (``nn.LSTM``, ``nn.GRU``, ``nn.SimpleRNN``, their cells, ``nn.RNN``,
``nn.BiRNN``, ``nn.BeamSearchDecoder`` with ``nn.dynamic_decode``) over
the op library (``ops``: creation, math, manipulation, activations,
losses, beam search; ``tensor``; the creation, math and manipulation
functions and ``to_tensor`` at the top level, as ``paddle.*``); and
runs the rest of the Paddle book: ``cos_sim``, ``linear_chain_crf``,
``crf_decoding`` and ``nce`` at the top level, ``seed``, ``no_grad``,
``enable_static`` and the mode-aware ``create_parameter``; the static
graph's sub-blocks (``static.nn.cond``, ``while_loop``, ``switch_case``,
``case``, ``static.StaticRNN``), static dropout and the inference
clone (``Program.clone(for_test=True)``); and trains text models over
sequences with sparse embedding tables: the sequence op family and the
segment pools, the loss and metric long tail, the selected-rows
functions (``ops``, at the top level), ``Embedding(sparse=True)`` with
the eager step's lazy row update, and ``autograd`` (``PyLayer``,
``backward``, ``grad``).
It imports torch and numpy, never jax and never paddle_tpu.  Entry
points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel call takes the kernel's plain
PyTorch version.
"""
# serving first: its fleet tier imports the generation engine, which
# imports serving.admission back
from . import serving  # noqa: I001
import torch
from . import amp, autograd, callbacks, distributed, generation, hapi, io, \
    metric, models, nn, ops, optimizer, parallel, profiler, regularizer, \
    static, vision
from . import tensor
from .dtype import convert_dtype as _convert_dtype
from .framework import get_rng_state, load, save, seed, set_rng_state
from .ops import creation as _creation
from .ops import manipulation as _manipulation
from .ops import math as _math
from .ops.creation import *  # noqa: F401,F403
from .ops.manipulation import *  # noqa: F401,F403
from .ops.math import *  # noqa: F401,F403
from .autograd import enable_grad, grad, is_grad_enabled, set_grad_enabled
from .ops import framework_ops as _framework_ops
from .ops import loss_extra as _loss_extra
from .ops import sequence_ops as _sequence_ops
from .ops.framework_ops import *  # noqa: F401,F403
from .ops.loss_extra import *  # noqa: F401,F403
from .ops.sequence_ops import *  # noqa: F401,F403
from .generation import (GenerationConfig, GenerationEngine,
                         SamplingParams, TinyCausalLM)
from .hapi import Model, flops, summary

Tensor = torch.Tensor
no_grad = torch.no_grad


def enable_static():
    static.program._dygraph_mode = False


def disable_static():
    static.program._dygraph_mode = True


def in_dynamic_mode():
    return static.program._dygraph_mode


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, device=None,
                     generator=None, **kw):
    """A parameter of `shape`: in dygraph an eager one (``nn.layer.
    create_parameter``: a random initializer draws from `generator` on
    the CPU, then the parameter moves to `device`, where None means the
    card and raises without one), under `enable_static` a static one in
    the default programs (``static.create_parameter``)."""
    if in_dynamic_mode():
        if kw:
            raise TypeError(f"create_parameter: unsupported kwargs in "
                            f"dygraph mode: {sorted(kw)}")
        from .device import resolve_device
        from .nn.layer import create_parameter as eager_parameter

        p = eager_parameter(list(shape), attr, is_bias, default_initializer,
                            generator=generator,
                            dtype=_convert_dtype(dtype))
        if p is not None:
            p.data = p.data.to(resolve_device(device, "create_parameter"))
            if name:
                p.name = name
        return p
    return static.create_parameter(shape, dtype=dtype, name=name, attr=attr,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer,
                                   **kw)


__all__ = _creation.__all__ + _manipulation.__all__ + _math.__all__ \
    + _framework_ops.__all__ + _loss_extra.__all__ + _sequence_ops.__all__ \
    + ["GenerationConfig", "GenerationEngine", "Model", "SamplingParams",
       "Tensor", "TinyCausalLM", "amp", "autograd", "callbacks",
       "create_parameter", "disable_static", "distributed", "enable_grad",
       "enable_static", "flops", "generation", "get_rng_state", "grad",
       "hapi", "in_dynamic_mode", "io", "is_grad_enabled", "load",
       "metric", "models", "nn", "no_grad", "ops", "optimizer", "parallel",
       "profiler", "regularizer", "save", "seed", "serving",
       "set_grad_enabled", "set_rng_state", "static", "summary", "tensor",
       "vision"]
