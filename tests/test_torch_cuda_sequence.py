"""The sparse embedding step and the sequence ops on the card against the
CPU.  Every test here is marked ``cuda`` and skips without a card
(decided inside the test, never at import).  On a machine with one (JAX
not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_sequence.py

Two lazy Adam and Adagrad steps of a sparse embedding, card against
CPU: the same touched rows, every entry within 1e-6 of the CPU's, the
untouched rows bitwise the start.  A 2,000,000 x 128 fp32 table (1.02
GB) with lazy Adam, 8 x 16 ids a step: after a first step (which makes
Adam's 2 GB of state), a second backward and step raise
``torch.cuda.max_memory_allocated`` by at most 16 MiB above what was
held before them (a dense gradient alone would take 1,024 MB), the rows
outside the step's ids stay bitwise, and the touched rows equal a dense
Adam step on those rows within 1e-6.  ``sequence_conv`` and
``sequence_pool`` ("sqrt") with their gradients within 1e-5 of each
tensor's largest magnitude (fp32, TF32 off)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu_torch as P
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.models import layer_from_numpy

pytestmark = pytest.mark.cuda
MIB = 2**20


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _loss(emb, ids):
    out = emb(ids)
    return (out * out).mean()


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_sparse_step_card_matches_cpu(rule):
    _needs_card()
    w0 = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    steps = (np.array([[1, 2], [3, 1]]), np.array([[2, 5], [5, 7]]))
    out = {}
    for dev in ("cpu", "cuda"):
        emb = layer_from_numpy(nn.Embedding(
            50, 8, sparse=True, generator=torch.Generator()), {
            "weight": w0}, device=dev)
        opt = getattr(optimizer, rule)(learning_rate=0.1,
                                       parameters=emb.parameters())
        for ids in steps:
            _loss(emb, torch.from_numpy(ids).to(dev)).backward()
            assert emb.weight.grad.is_sparse
            assert emb.weight.grad.device.type == dev
            opt.step()
            opt.clear_grad()
        out[dev] = emb.weight.detach().cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-6, atol=1e-6)
    untouched = [i for i in range(50) if i not in (1, 2, 3, 5, 7)]
    np.testing.assert_array_equal(out["cuda"][untouched], w0[untouched])


def test_large_table_step_stays_sparse_on_the_card():
    _needs_card()
    rows, dim = 2_000_000, 128
    emb = nn.Embedding(rows, dim, sparse=True,
                       generator=torch.Generator().manual_seed(0)).cuda()
    opt = optimizer.Adam(learning_rate=0.1, parameters=emb.parameters())
    rng = np.random.default_rng(0)
    first, second = (torch.from_numpy(rng.integers(0, rows, (8, 16))).cuda()
                     for _ in range(2))
    _loss(emb, first).backward()
    opt.step()
    opt.clear_grad()
    st = opt._states[id(emb.weight)]
    touched = torch.unique(second)
    before_w = emb.weight.detach()[touched].clone()
    before_m = {k: st[k][touched].clone() for k in ("moment1", "moment2")}
    b1p, b2p = st["beta1_pow"].clone(), st["beta2_pow"].clone()
    probe = torch.tensor([0, 1, rows - 1], device="cuda")
    probe = probe[~torch.isin(probe, torch.cat([first.reshape(-1),
                                                second.reshape(-1)]))]
    probe_w = emb.weight.detach()[probe].clone()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _loss(emb, second).backward()
    grad = emb.weight.grad.coalesce()
    opt.step()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - held
    assert rise <= 16 * MIB, rise / MIB
    assert torch.equal(emb.weight.detach()[probe], probe_w)
    # the touched rows against a dense Adam step on those rows alone
    dense = optimizer.Adam(learning_rate=0.1)
    want, _ = dense.update(before_w, grad.values(), {
        **before_m, "beta1_pow": b1p, "beta2_pow": b2p}, 0.1)
    torch.testing.assert_close(emb.weight.detach()[grad.indices()[0]], want,
                               rtol=1e-6, atol=1e-6)


def test_sequence_conv_pool_card_matches_cpu():
    _needs_card()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 12, 16)).astype(np.float32)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    lens = np.array([12, 5, 1, 9])
    runs = {}
    for dev in ("cpu", "cuda"):
        xt, wt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w))
        out = P.sequence_pool(torch.tanh(P.sequence_conv(
            xt, wt, torch.from_numpy(lens).to(dev), context_length=3)),
            torch.from_numpy(lens).to(dev), "sqrt")
        assert out.device.type == dev
        cot = torch.linspace(-1, 1, out.numel(), device=dev).reshape(
            out.shape)
        runs[dev] = [out] + list(torch.autograd.grad((out * cot).sum(),
                                                     [xt, wt]))
    for got, want in zip(runs["cuda"], runs["cpu"]):
        got, want = got.detach().cpu().double(), want.detach().double()
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
