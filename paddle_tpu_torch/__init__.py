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
JAX package's checkpoint format.
It imports torch and numpy, never jax and never paddle_tpu.  Entry
points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel call takes the kernel's plain
PyTorch version.
"""
# serving first: its fleet tier imports the generation engine, which
# imports serving.admission back
from . import serving  # noqa: I001
from . import amp, callbacks, distributed, generation, hapi, io, metric, \
    models, nn, ops, optimizer, parallel, profiler, regularizer, static, \
    vision
from .framework import load, save
from .generation import (GenerationConfig, GenerationEngine,
                         SamplingParams, TinyCausalLM)
from .hapi import Model, flops, summary

__all__ = ["GenerationConfig", "GenerationEngine", "Model",
           "SamplingParams", "TinyCausalLM", "amp", "callbacks",
           "distributed", "flops", "generation", "hapi", "io", "load",
           "metric", "models", "nn", "ops", "optimizer", "parallel",
           "profiler", "regularizer", "save", "serving", "static",
           "summary", "vision"]
