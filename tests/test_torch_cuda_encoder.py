"""BERT and ERNIE pretraining on the card against the CPU.  Every test
here is marked ``cuda`` and skips without a card (decided inside the
test, never at import).  On a machine with one (JAX not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_encoder.py

Three bf16-amp AdamW steps under a LinearWarmup over PolynomialDecay
schedule, from the same weights and batch on both devices: losses within
1e-4 relative (TF32 off, so only the fp32 summation order differs), and
no kernel of the port launched (attention takes the composite path).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch.models import (BertForPretraining, ErnieForPretraining,
                                     apply_knowledge_mask, bert_tiny,
                                     ernie_tiny)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import TrainStep

pytestmark = pytest.mark.cuda
B, L, STEPS = 2, 64, 3


def _launches():
    wrappers = [fa.flash_attention_fwd_kernel,
                fa.flash_attention_bwd_dkdv_kernel,
                fa.flash_attention_bwd_dq_kernel,
                pa.ragged_paged_attention_kernel,
                pa.paged_decode_attention_kernel,
                pa.chunk_prefill_attention_kernel]
    return sum(w.launches for w in wrappers)


def _batch(model_cls, vocab):
    rng = np.random.RandomState(0)
    ids = rng.randint(4, vocab, (B, L)).astype(np.int64)
    if model_cls is BertForPretraining:
        labels = rng.randint(0, vocab, (B, L)).astype(np.int64)
    else:
        spans = [[(s, s + 2) for s in range(0, L, 2)] for _ in range(B)]
        ids, labels = apply_knowledge_mask(ids, spans, 3, rng=rng,
                                           mask_prob=0.3)
    return torch.from_numpy(ids), torch.from_numpy(labels)


@pytest.mark.parametrize("model_cls,config", [
    (BertForPretraining, bert_tiny), (ErnieForPretraining, ernie_tiny)],
    ids=["bert", "ernie"])
def test_card_train_steps_match_cpu(model_cls, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    named = model_cls(cfg, seed=4, device="cpu").numpy_params()
    batch = _batch(model_cls, cfg.vocab_size)
    runs = []
    for device in ("cuda", "cpu"):
        model = model_cls.from_numpy_params(named, cfg, device=device)
        sched = plr.LinearWarmup(plr.PolynomialDecay(1e-3, decay_steps=4),
                                 warmup_steps=1, start_lr=1e-4,
                                 end_lr=1e-3)
        tr = TrainStep(model, lambda m, *b, generator: m.loss(
            *b, generator=generator), AdamW(learning_rate=sched),
            amp_dtype=torch.bfloat16, device=device)
        before = _launches()
        runs.append([float(tr.step(*batch)) for _ in range(STEPS)])
        assert _launches() == before
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4, atol=0)
    assert runs[0][-1] < runs[0][0]
