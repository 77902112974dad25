"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It serves the generation engine's ragged and legacy steps on an NVIDIA
GPU, with the ragged, paged-decode and chunk-prefill attention kernels
written by hand in CUDA C++ for sm_90a (ops/, csrc/).  It imports torch and numpy, never jax and never
paddle_tpu.  Entry points run on the card unless the caller asks for
the CPU (``GenerationConfig(device="cpu")``), where every kernel call
takes the kernel's plain PyTorch version.
"""
from . import generation, ops, profiler, serving
from .generation import (GenerationConfig, GenerationEngine,
                         SamplingParams, TinyCausalLM)

__all__ = ["GenerationConfig", "GenerationEngine", "SamplingParams",
           "TinyCausalLM", "generation", "ops", "profiler", "serving"]
