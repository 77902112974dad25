"""The recurrent layers and beam-search decoding on the card against the
CPU.  Every test here is marked ``cuda`` and skips without a card
(decided inside the test, never at import).  On a machine with one (JAX
not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_rnn.py

Each cell and stack (SimpleRNN tanh and relu, LSTM, GRU; forward and
bidirect; with and without `sequence_length`) from one set of weights on
both devices: outputs, final states and the gradients of the input and
every parameter within 1e-5 of each tensor's largest magnitude (fp32,
TF32 off: only the summation order differs), every tensor on the card
where the layer's are.  A beam decode over a GRU cell: the ids equal and
the scores within 1e-5 (``chip_smoke.py`` phase 19 runs the book's two
models at full width).  Ops given only host data make it on the card."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import nn
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

pytestmark = pytest.mark.cuda
B, T, D, H = 4, 9, 12, 16
TOL = 1e-5
LENS = [9, 5, 1, 7]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _share(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [leaf for x in v for leaf in _flat(x)]
    return [v]


def _both(build, x_shape, call):
    """The layer on the CPU and its copy on the card, each called on one
    input with `call`; every output and gradient compared."""
    cpu = build(torch.Generator().manual_seed(0))
    card = layer_from_numpy(build(torch.Generator().manual_seed(1)),
                            layer_to_numpy(cpu), device="cuda")
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(2))
    runs = []
    for layer, dev in ((cpu, "cpu"), (card, "cuda")):
        xi = x.to(dev).detach().requires_grad_()
        outs = _flat(call(layer, xi))
        assert all(o.device.type == dev for o in outs)
        sum(o.square().sum() for o in outs).backward()
        runs.append((outs, xi.grad, [p.grad for p in layer.parameters()]))
    (co, cg, cp), (go, gg, gp) = runs
    for a, b in zip(go + [gg] + gp, co + [cg] + cp):
        assert _share(a, b) <= TOL, _share(a, b)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_on_the_card_match_the_cpu(cell):
    _needs_card()
    _both(lambda g: getattr(nn, cell)(D, H, generator=g), (B, D),
          lambda layer, x: layer(x))


@pytest.mark.parametrize("mode", ["SimpleRNN", "SimpleRNN_relu", "LSTM",
                                  "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("lens", [False, True])
def test_stacks_on_the_card_match_the_cpu(mode, direction, lens):
    _needs_card()
    cls, _, act = mode.partition("_")
    kw = {"activation": act} if act else {}

    def call(layer, x):
        seq = torch.tensor(LENS, device=x.device) if lens else None
        return layer(x, sequence_length=seq)

    _both(lambda g: getattr(nn, cls)(D, H, num_layers=2, direction=direction,
                                     generator=g, **kw), (B, T, D), call)


def test_beam_decode_on_the_card_matches_the_cpu():
    _needs_card()
    g = torch.Generator().manual_seed(0)
    parts = [nn.Embedding(20, H, generator=g), nn.GRUCell(H, H, generator=g),
             nn.Linear(H, 20, generator=g)]
    h0 = torch.randn(3, H, generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", "cuda"):
        emb, cell, out = (layer_from_numpy(p, layer_to_numpy(p), dev)
                          for p in parts)

        def step(ids, states, emb=emb, cell=cell, out=out):
            h, _ = cell(emb(ids), states[0])
            return out(h), (h,)

        runs.append(nn.dynamic_decode(nn.BeamSearchDecoder(
            step, 0, 1, 4), inits=(h0.to(dev),), max_step_num=8,
            return_length=True))
    (ci, cs, cl), (gi, gs, gl) = runs
    assert gi.device.type == "cuda"
    assert torch.equal(gi.cpu(), ci) and torch.equal(gl.cpu(), cl)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=TOL,
                               atol=TOL)


def test_host_data_alone_runs_on_the_card():
    """Ops given only host data (numpy arrays) put it on the card, as
    the JAX package puts it on its default device."""
    _needs_card()
    import paddle_tpu_torch as P

    a, b = (np.random.default_rng(k).standard_normal((3, 4)).astype(
        np.float32) for k in (0, 1))
    for out in (P.concat([a, b]), P.stack([a, b]), P.exp(a), P.add(a, b),
                P.one_hot(np.array([0, 2]), 3)):
        assert out.device.type == "cuda"
    np.testing.assert_allclose(P.exp(a).cpu().numpy(), np.exp(a), rtol=1e-6)
