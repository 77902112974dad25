"""Hand-written CUDA kernels of the port, each beside its wrapper and
its plain PyTorch version."""
from .flash_attention import (flash_attention_bwd_dkdv_kernel,
                              flash_attention_bwd_dkdv_torch,
                              flash_attention_bwd_dq_kernel,
                              flash_attention_bwd_dq_torch,
                              flash_attention_fwd_kernel,
                              flash_attention_fwd_torch)
from .paged_attention import (RAGGED_Q_BLOCK, chunk_prefill_attention_kernel,
                              chunk_prefill_attention_torch,
                              paged_decode_attention_kernel,
                              paged_decode_attention_torch,
                              ragged_paged_attention_kernel,
                              ragged_paged_attention_torch,
                              ragged_score_blocks)

__all__ = ["RAGGED_Q_BLOCK", "flash_attention_bwd_dkdv_kernel",
           "flash_attention_bwd_dkdv_torch", "flash_attention_bwd_dq_kernel",
           "flash_attention_bwd_dq_torch", "flash_attention_fwd_kernel",
           "flash_attention_fwd_torch", "chunk_prefill_attention_kernel",
           "chunk_prefill_attention_torch", "paged_decode_attention_kernel",
           "paged_decode_attention_torch", "ragged_paged_attention_kernel",
           "ragged_paged_attention_torch", "ragged_score_blocks"]
