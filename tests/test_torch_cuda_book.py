"""The book's new ops and static sub-blocks on the card against the CPU.
Every test here is marked ``cuda`` and skips without a card (decided
inside the test, never at import).  On a machine with one (JAX not
needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_book.py

`linear_chain_crf` (values and the gradients of emissions and
transitions), `nce` (the same negative ids on both devices, values and
gradients), `cos_sim` and ``Embedding(padding_idx)`` within 1e-5 of each
tensor's largest magnitude (fp32, TF32 off: only the summation order
differs); `crf_decoding`'s paths equal; static dropout's masks equal
(a counter-based hash of the seed, the step and the index); a program
with a `StaticRNN` and a `cond`, its step-1 loss within 1e-5 relative
and every gradient within 1e-5 of its largest, its ``for_test`` clone's
output within 1e-5 (``chip_smoke.py`` phase 20 runs the book's chapters
at their widths)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu_torch as P
from paddle_tpu_torch import nn, static
from paddle_tpu_torch.models.weights import scope_from_numpy, scope_to_numpy
from paddle_tpu_torch.ops import sequence_ops

pytestmark = pytest.mark.cuda
TOL = 1e-5
B, T, N, D, V = 6, 9, 5, 16, 300


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _share(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _both(fn, *arrays):
    """`fn` over `arrays` as leaf tensors on each device (floats
    differentiated under a seeded cotangent): per device, (outputs,
    gradients)."""
    runs = {}
    for dev in ("cpu", "cuda"):
        xs = [torch.from_numpy(a).to(dev) for a in arrays]
        for x in xs:
            if x.is_floating_point():
                x.requires_grad_()
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert all(o.device.type == dev for o in outs)
        loss = sum((o * torch.linspace(-1, 1, o.numel(), device=dev)
                    .reshape(o.shape)).sum()
                   for o in outs if o.is_floating_point())
        grads = torch.autograd.grad(loss, [x for x in xs if x.requires_grad])
        runs[dev] = ([o.detach().cpu() for o in outs],
                     [g.cpu() for g in grads])
    return runs


def _hold(runs):
    for a, b in zip(runs["cuda"][0] + runs["cuda"][1],
                    runs["cpu"][0] + runs["cpu"][1]):
        assert _share(a, b) <= TOL


def test_crf_card_vs_cpu():
    _needs_card()
    rng = np.random.default_rng(0)
    em = rng.standard_normal((B, T, N)).astype(np.float32)
    tr = rng.standard_normal((N + 2, N)).astype(np.float32)
    lab = rng.integers(0, N, (B, T))
    lens = np.array([T, 1, 4, T - 1, 2, 7])
    _hold(_both(lambda e, t, lb, ln: P.linear_chain_crf(e, t, lb, ln),
                em, tr, lab, lens))
    got = P.crf_decoding(torch.from_numpy(em).cuda(),
                         torch.from_numpy(tr).cuda(),
                         torch.from_numpy(lens).cuda())
    want = P.crf_decoding(torch.from_numpy(em), torch.from_numpy(tr),
                          torch.from_numpy(lens))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_card_vs_cpu(sampler, monkeypatch):
    _needs_card()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((V, D)).astype(np.float32)
    b = rng.standard_normal(V).astype(np.float32)
    lbl = rng.integers(0, V, (B, 2))
    drawn, draw = [], sequence_ops.draw_negatives

    def record(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    monkeypatch.setattr(sequence_ops, "draw_negatives", record)
    _hold(_both(lambda xv, wv, bv, lv: P.nce(
        xv, wv, lv, bias=bv, num_total_classes=V, num_neg_samples=10,
        sampler=sampler, seed=3), x, w, b, lbl))
    assert len(drawn) == 2 and torch.equal(drawn[0], drawn[1])
    assert drawn[0].device.type == "cpu"


def test_cos_sim_and_padded_embedding_card_vs_cpu():
    _needs_card()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.standard_normal((1, D)).astype(np.float32)
    _hold(_both(P.cos_sim, x, y))
    ids = rng.integers(0, 10, (B, 4))
    ids[:, 0] = 9
    cpu = nn.Embedding(10, D, padding_idx=-1,
                       generator=torch.Generator().manual_seed(0))
    card = nn.Embedding(10, D, padding_idx=-1,
                        generator=torch.Generator().manual_seed(0)).cuda()
    outs = [m(torch.from_numpy(ids).to(dev))
            for m, dev in ((cpu, "cpu"), (card, "cuda"))]
    for m, o in zip((cpu, card), outs):
        assert not o[:, 0].any()
        o.square().sum().backward()
        assert not m.weight.grad[9].any()
    assert _share(outs[1], outs[0]) <= TOL
    assert _share(card.weight.grad, cpu.weight.grad) <= TOL


def _program():
    """A StaticRNN over embedded ids, a cond on the sign of its summed
    states, dropout, and Adam; its for_test clone taken before
    minimize."""
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [T, B], dtype="int64")
        h0 = static.data("h0", [B, D])
        rnn = static.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(init=h0)
            nxt = static.nn.fc(static.nn.embedding(xt, [V, D]) + prev, D,
                               activation="tanh")
            rnn.update_memory(prev, nxt)
            rnn.step_output(nxt)
        hs = static.nn.reshape(rnn(), [T * B, D])
        out = static.nn.cond(static.nn.reduce_sum(hs) > 0.0,
                             lambda: static.nn.fc(hs, 4),
                             lambda: static.nn.fc(hs, 4) * 2.0)
        out = static.nn.dropout(out, dropout_prob=0.3, seed=9)
        loss = static.nn.mean(static.nn.tanh_act(out))
        test = main.clone(for_test=True)
        P.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, test, out


def test_static_rnn_cond_dropout_program_card_vs_cpu():
    _needs_card()
    main, startup, loss, test, out = _program()
    grads = [v.name + "@GRAD" for v in main.all_parameters()
             if main.global_block().has_var(v.name + "@GRAD")]
    # the embedding, the step fc and each branch fc with their biases
    assert len(grads) == 7
    rng = np.random.default_rng(3)
    feed = {"x": rng.integers(0, V, (T, B)),
            "h0": rng.standard_normal((B, D)).astype(np.float32)}
    cpu_scope = static.Scope()
    static.Executor("cpu").run(startup, scope=cpu_scope)
    scopes = {"cpu": cpu_scope,
              "cuda": scope_from_numpy(scope_to_numpy(cpu_scope), "cuda")}
    runs = {}
    for dev, scope in scopes.items():
        exe = static.Executor(dev)
        runs[dev] = [exe.run(main, feed=feed, fetch_list=[loss, out] + grads,
                             scope=scope) for _ in range(2)]
        runs[dev].append(exe.run(test, feed=feed, fetch_list=[out],
                                 scope=scope))
    for step in range(2):
        (lc, oc, *gc), (lg, og, *gg) = runs["cpu"][step], runs["cuda"][step]
        np.testing.assert_allclose(lg, lc, rtol=TOL)
        # dropout drew the same mask on both devices
        np.testing.assert_array_equal(og != 0, oc != 0)
        for a, b in zip(gg, gc):
            assert _share(torch.from_numpy(a), torch.from_numpy(b)) <= TOL
    assert _share(torch.from_numpy(runs["cuda"][2][0]),
                  torch.from_numpy(runs["cpu"][2][0])) <= TOL
