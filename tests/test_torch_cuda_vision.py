"""The dygraph vision slice on the card against the CPU.  Every test here
is marked ``cuda`` and skips without a card (decided inside the test,
never at import).  On a machine with one (JAX not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_vision.py

From one carried state, with TF32 off so that only the fp32 summation
order differs: three LeNet steps under the eager Adam step (plain, and
with a global-norm clip, L2 decay and a per-parameter learning rate),
losses within 1e-4 relative and parameters within 1e-4 of each tensor's
largest magnitude; MobileNetV2's eval logits within 1e-4; no kernel of
the port launched.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.vision import models as pvm

pytestmark = pytest.mark.cuda
TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _launches():
    return sum(w.launches for w in (
        fa.flash_attention_fwd_kernel, fa.flash_attention_bwd_dkdv_kernel,
        fa.flash_attention_bwd_dq_kernel, pa.ragged_paged_attention_kernel,
        pa.paged_decode_attention_kernel, pa.chunk_prefill_attention_kernel))


def _share(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("options", [
    lambda: {}, lambda: dict(grad_clip=pnn.ClipGradByGlobalNorm(1.0),
                             weight_decay=popt.L2Decay(1e-4))],
    ids=["plain", "clip-decay"])
def test_lenet_steps_match_cpu(options):
    _card()
    weights = layer_to_numpy(pvm.LeNet(device="cpu"))
    rng = np.random.RandomState(0)
    img = rng.rand(32, 1, 28, 28).astype(np.float32)
    lbl = rng.randint(0, 10, (32, 1)).astype(np.int64)
    before = _launches()
    runs = {}
    for device in ("cuda", "cpu"):
        net = layer_from_numpy(pvm.LeNet(device="cpu"), weights, device)
        net.fc[0].weight.optimize_attr = {"learning_rate": 0.5}
        opt = popt.Adam(1e-3, parameters=net.parameters(), **options())
        x, y = (torch.from_numpy(a).to(device) for a in (img, lbl))
        losses = []
        for _ in range(3):
            loss = F.softmax_with_cross_entropy(net(x), y).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs[device] = losses, dict(net.named_parameters())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=TOL)
    for n, p in runs["cpu"][1].items():
        assert _share(runs["cuda"][1][n].detach(), p.detach()) <= TOL, n
    assert _launches() == before


def test_mobilenet_v2_eval_matches_cpu():
    _card()
    card = pvm.mobilenet_v2(scale=0.5).eval()
    cpu = layer_from_numpy(pvm.mobilenet_v2(scale=0.5, device="cpu"),
                           layer_to_numpy(card), "cpu").eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 96, 96)
                         .astype(np.float32))
    with torch.no_grad():
        assert _share(card(x.cuda()), cpu(x)) <= TOL
