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
service, prefill/decode handoff and ``serving.FleetSupervisor``).
It imports torch and numpy, never jax and never paddle_tpu.  Entry
points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel call takes the kernel's plain
PyTorch version.
"""
# serving first: its fleet tier imports the generation engine, which
# imports serving.admission back
from . import serving  # noqa: I001
from . import generation, models, nn, ops, optimizer, parallel, profiler, \
    regularizer, static, vision
from .generation import (GenerationConfig, GenerationEngine,
                         SamplingParams, TinyCausalLM)

__all__ = ["GenerationConfig", "GenerationEngine", "SamplingParams",
           "TinyCausalLM", "generation", "models", "nn", "ops", "optimizer",
           "parallel", "profiler", "regularizer", "serving", "static",
           "vision"]
