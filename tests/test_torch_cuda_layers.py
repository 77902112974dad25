"""The convolution, norm, resampling and pooling layers on the card
against the CPU.  Every test here is marked ``cuda`` and skips without a
card (decided inside the test, never at import).  On a machine with one
(JAX not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_layers.py

A small CycleGAN iteration (``chip_smoke.py``'s networks at ngf = ndf =
8, two residual blocks, 32x32), card against the CPU, the card's ReLUs
taking the CPU's decisions (``chip_smoke.relu_decisions``): every loss
term within 1e-5 relative and every gradient within 1e-4 of its
tensor's largest magnitude (fp32, TF32 off, cuDNN on as phase 21 (a)); every function and
layer of ``chip_smoke.layer_sweep_cases``, forward and backward, card
(cuDNN on) against the CPU within ``chip_smoke.LAYER_SWEEP_TOL``; the
new layers land on the card when built without a device (``chip_smoke``
phase 21 runs CycleGAN at its published widths)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import chip_smoke
from paddle_tpu_torch import nn

pytestmark = pytest.mark.cuda
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
SMALL = dict(chip_smoke.CYCLEGAN, ngf=8, ndf=8, blocks=2, image=32)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_small_cyclegan_iteration_card_vs_cpu():
    _needs_card()
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

    images = chip_smoke.cyclegan_images(np.random.default_rng(0), SMALL)
    cpu = chip_smoke.port_cyclegan(SMALL, seed=0)
    card = tuple(layer_from_numpy(new, layer_to_numpy(old), "cuda")
                 for new, old in zip(chip_smoke.port_cyclegan(SMALL, seed=1),
                                     cpu))
    runs, decisions = {}, None
    for dev, nets in (("cpu", cpu), ("cuda", card)):
        opts = dict(chip_smoke.cyclegan_optimizers(nets, SMALL), grads=[])
        with chip_smoke.relu_decisions(nets, decisions) as (decisions, _):
            out = chip_smoke.cyclegan_iteration(
                nets, opts, *[torch.from_numpy(a).to(dev) for a in images],
                c=SMALL)
        runs[dev] = ({k: float(v) for k, v in out.items()},
                     opts["grads"][0])
    for k, want in runs["cpu"][0].items():
        np.testing.assert_allclose(runs["cuda"][0][k], want, rtol=LOSS_TOL,
                                   atol=0, err_msg=k)
    for n, want in runs["cpu"][1].items():
        got = runs["cuda"][1][n]
        assert got.device.type == "cuda"
        assert chip_smoke.share(got.cpu(), want) <= GRAD_TOL, n


def test_every_ported_layer_card_vs_cpu():
    _needs_card()
    for name, fn, inputs, kw in chip_smoke.layer_sweep_cases():
        c_out, c_grad = chip_smoke.sweep_run(fn, inputs, kw, "cpu")
        g_out, g_grad = chip_smoke.sweep_run(fn, inputs, kw, "cuda")
        for got, want in zip(g_out + g_grad, c_out + c_grad):
            assert got.device.type == "cuda", name
            if want.is_floating_point():
                err = chip_smoke.share(got.detach().cpu(), want.detach())
                assert err <= chip_smoke.LAYER_SWEEP_TOL, (name, err)
            else:
                assert torch.equal(got.cpu(), want), name


def test_new_layers_build_on_the_card_by_default():
    _needs_card()
    g = torch.Generator()
    for layer in (nn.Conv2D(2, 3, 3, generator=g), nn.BatchNorm2D(2),
                  nn.Conv2DTranspose(2, 3, 3, generator=g),
                  nn.Conv3D(2, 3, 3, generator=g), nn.GroupNorm(1, 2),
                  nn.InstanceNorm2D(2), nn.SyncBatchNorm(2),
                  nn.Bilinear(2, 3, 4, generator=g)):
        assert all(p.device.type == "cuda" for p in layer.parameters())
