"""The op library (``paddle_tpu/ops``: creation, math, manipulation, the
activation and dropout functions, losses, the loss and metric long tail
of ``loss_extra``, the sequence ops with the CRF, NCE and beam search,
and the selected-rows functions of ``framework_ops``) and the port's
hand-written CUDA kernels, each beside its wrapper and its plain
PyTorch version."""
from . import creation, framework_ops, loss, loss_extra, manipulation, \
    math, nn_extra, nn_ops, sequence_ops
from .creation import *  # noqa: F401,F403
from .framework_ops import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .loss_extra import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
from .sequence_ops import *  # noqa: F401,F403
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

__all__ = creation.__all__ + framework_ops.__all__ + loss.__all__ \
    + loss_extra.__all__ \
    + manipulation.__all__ \
    + math.__all__ + nn_ops.__all__ + sequence_ops.__all__ + [
        "RAGGED_Q_BLOCK", "chunk_prefill_attention_kernel",
        "chunk_prefill_attention_torch", "flash_attention_bwd_dkdv_kernel",
        "flash_attention_bwd_dkdv_torch", "flash_attention_bwd_dq_kernel",
        "flash_attention_bwd_dq_torch", "flash_attention_fwd_kernel",
        "flash_attention_fwd_torch", "paged_decode_attention_kernel",
        "paged_decode_attention_torch", "ragged_paged_attention_kernel",
        "ragged_paged_attention_torch", "ragged_score_blocks"]
