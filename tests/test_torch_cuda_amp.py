"""Dygraph AMP and the high-level surface on the card against the CPU.
Every test here is marked ``cuda`` and skips without a card (decided
inside the test, never at import).  On a machine with one (JAX not
needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_amp.py

GPT tiny (``use_flash=True``, dropout 0): two eager O1 ``auto_cast`` +
``GradScaler`` + AdamW steps from the same weights and batch on both
devices, losses within 1e-2 relative (a bf16 loss: 1-2 ulps), the scales
equal, and each flash kernel launched num_layers x steps times on the
card, all in bfloat16.  ``hapi.Model(LeNet).fit`` over a 2-worker
DataLoader, fp32 with TF32 off: every step's loss within 1e-5 relative
and the accuracies equal (``chip_smoke.py`` phase 18 runs both at full
width)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import amp, callbacks, hapi, io, metric, nn
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.vision.models import LeNet

pytestmark = pytest.mark.cuda
FLASH = (fa.flash_attention_fwd_kernel, fa.flash_attention_bwd_dkdv_kernel,
         fa.flash_attention_bwd_dq_kernel)
B, L, STEPS = 2, 64, 2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _amp_steps(model, ids, lbl):
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    scaler = amp.GradScaler()
    losses = []
    for _ in range(STEPS):
        with amp.auto_cast():
            loss = model.loss(ids, lbl)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses, scaler._scale


def test_gpt_eager_amp_runs_the_bf16_flash_kernels():
    _needs_card()
    cfg = gpt_tiny(use_flash=True)
    cpu = GPTForPretraining(cfg, seed=2, device="cpu")
    card = GPTForPretraining.from_numpy_params(cpu.numpy_params(), cfg,
                                               device="cuda")
    rng = np.random.RandomState(0)
    ids, lbl = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L)))
                for _ in range(2))
    before = [dict(w.launches_by_dtype) for w in FLASH]
    got, got_scale = _amp_steps(card, ids.cuda(), lbl.cuda())
    moved = [{k: w.launches_by_dtype[k] - b[k] for k in b}
             for w, b in zip(FLASH, before)]
    want, want_scale = _amp_steps(cpu, ids, lbl)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got_scale == want_scale
    assert moved == [{"float32": 0, "bfloat16": cfg.num_layers * STEPS}] * 3


def _lenet_fit(device, x, y):
    net = LeNet(generator=torch.Generator().manual_seed(0), device=device)
    model = hapi.Model(net)
    model.prepare(Adam(learning_rate=1e-3, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), metric.Accuracy())
    steps = []

    class Rec(callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            steps.append((logs["loss"], logs["acc"]))

    loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=32,
                           shuffle=True, num_workers=2, places=device,
                           timeout=120)
    np.random.seed(0)
    model.fit(loader, epochs=2, callbacks=[Rec()], verbose=0)
    return steps


def test_hapi_lenet_fit_matches_cpu():
    _needs_card()
    rs = np.random.RandomState(1)
    x = rs.rand(128, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (128, 1)).astype(np.int64)
    got, want = _lenet_fit("cuda", x, y), _lenet_fit("cpu", x, y)
    assert len(got) == len(want) == 8
    for (lg, ag), (lw, aw) in zip(got, want):
        np.testing.assert_allclose(lg, lw, rtol=1e-5)
        assert ag == aw
