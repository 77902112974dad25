"""Port parity: the PaddlePaddle book's chapters that
``test_torch_book_models.py`` does not hold, at ``tests/test_book.py``'s
sizes, one source for both packages (``chip_smoke.book_chapters`` for
the dygraph chapters, ``chip_smoke.book_program`` for the static
ones): fit_a_line, recognize_digits, word2vec with NCE, semantic roles
with the CRF, the recommender, the StaticRNN encoder-decoder and image
classification.

Each chapter runs 3 steps in both packages on the CPU from the JAX
model's weights (``models.layer_from_numpy``) or one start scope
(``jax_static_start.numpy_start``, ``scope_from_numpy``), its losses
within 1e-5 relative, dropout
0 (word2vec's negatives patched to the ids JAX drew); then the chapter
alone on the port for its ``test_book.py`` step count, from the same
weights with its dropout on and the port's own sampler, held to that
chapter's own assertion."""
import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.static as jstatic
import paddle_tpu_torch as ptorch
from jax_static_start import numpy_start
import paddle_tpu_torch.static as tstatic
from paddle_tpu.ops import sequence_ops as JS
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.models.weights import scope_from_numpy
from paddle_tpu_torch.ops import sequence_ops as PS
from torch_op_parity import with_params

LOSS_TOL = 1e-5
PARITY_STEPS = 3

# tests/test_book.py's sizes, learning rates, step counts and asserted
# ratio of the last loss to the first
DYGRAPH = {
    "recognize_digits": dict(
        build=dict(filters=(8, 16), kernel=5, image=28, classes=10,
                   pool=False),
        data=dict(batch=64, image=28, classes=10), lr=2e-3, steps=30,
        ratio=0.6),
    "word2vec": dict(build=dict(vocab=50, dim=16, neg=8),
                     data=dict(batch=128, vocab=50), lr=5e-2, steps=40,
                     ratio=0.6),
    "semantic_roles": dict(build=dict(vocab=40, dim=16, labels=5),
                           data=dict(batch=8, seq=10, min_len=10, vocab=40,
                                     labels=5), lr=5e-2, steps=25),
    "recommender": dict(build=dict(users=30, items=40, dim=8),
                        data=dict(batch=64, users=30, items=40), lr=5e-2,
                        steps=20, ratio=0.8),
}
STATIC = {
    "fit_a_line": dict(size=dict(batch=64, features=13), opt="SGD",
                       kw=dict(learning_rate=0.1), steps=15, ratio=0.5),
    "static_rnn": dict(size=dict(seq=6, batch=8, vocab=20, dim=12),
                       opt="Adam", kw=dict(learning_rate=1e-2), steps=20,
                       ratio=0.8),
    "image_classification": dict(
        size=dict(batch=8, image=32, classes=10), opt="Momentum",
        kw=dict(learning_rate=0.05, momentum=0.9), steps=60, ratio=0.6),
}

JAX_CHAPTERS = chip_smoke.book_chapters(
    paddle, jnn, JF, jnn.Layer,
    lambda layer, shape, is_bias=False: layer.create_parameter(
        shape, is_bias=is_bias))
PORT_CHAPTERS = chip_smoke.port_book_chapters()


def _jax_negatives(seed, n, vocab, sampler):
    return torch.tensor(np.asarray(jax.random.randint(
        JS._op_key(seed), (n,), 0, vocab)))


def _jax_train(model, batch, lr, steps):
    """`steps` Adam steps of the JAX model, each traced into one jitted
    function instead of one compile per eager op: the model's own forward
    under ``jax.value_and_grad`` (the parameters' data swapped for the
    traced values), then the JAX optimizer's ``update``, the rule its
    eager ``step`` applies to each parameter.  Word2vec's NCE key,
    ``sequence_ops._op_key(step + 1)`` in JAX's eager run, comes in as an
    argument, so one compile serves every step."""
    params = model.parameters()
    args = [paddle.to_tensor(a) for a in batch]
    opt = paddle.optimizer.Adam(learning_rate=lr, parameters=params)

    def loss_of(datas, key):
        op_key = JS._op_key
        try:
            JS._op_key = lambda seed: key
            return with_params(params, datas,
                               lambda: model.loss(*args)._data)
        finally:
            JS._op_key = op_key

    @jax.jit
    def train_step(datas, states, key):
        loss, grads = jax.value_and_grad(loss_of)(datas, key)
        new = [opt.update(d, g, s, lr)
               for d, g, s in zip(datas, grads, states)]
        return loss, [n[0] for n in new], [n[1] for n in new]

    datas = [p._data for p in params]
    states = [opt._state_for(p) for p in params]
    losses = []
    for step in range(steps):
        loss, datas, states = train_step(datas, states,
                                         JS._op_key(step + 1))
        losses.append(float(loss))
    return losses


def _train(model, batch, lr, steps):
    opt = popt.Adam(learning_rate=lr, parameters=model.parameters())
    args = [torch.from_numpy(a) for a in batch]
    losses = []
    for _ in range(steps):
        loss = model.loss(*args)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, args


@pytest.mark.parametrize("which", list(DYGRAPH))
def test_dygraph_chapter(which, monkeypatch):
    spec = DYGRAPH[which]
    batch = chip_smoke.chapter_batch(np.random.default_rng(3), which,
                                     spec["data"])
    paddle.seed(5)
    jm = JAX_CHAPTERS[which](**spec["build"])
    start = {n: np.array(t._data) for n, t in jm.state_dict().items()}
    pm = layer_from_numpy(PORT_CHAPTERS[which](**spec["build"]), start,
                          device="cpu")
    jl = _jax_train(jm, batch, spec["lr"], PARITY_STEPS)
    with monkeypatch.context() as m:
        m.setattr(PS, "draw_negatives", _jax_negatives)
        pl, _ = _train(pm, batch, spec["lr"], PARITY_STEPS)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL, atol=0)

    # the chapter alone on the port, from the same weights
    pm = layer_from_numpy(PORT_CHAPTERS[which](**spec["build"]), start,
                          device="cpu")
    losses, args = _train(pm, batch, spec["lr"], spec["steps"])
    if which == "semantic_roles":
        words, labels, lens = args
        path = pm.decode(words, lens)
        assert (path.numpy() == labels.numpy()).mean() > 0.5  # random: 0.2
    else:
        assert losses[-1] < spec["ratio"] * losses[0], losses


def _static_runs(pkg, which, spec, drop, steps, scope=None):
    """`steps` runs of the chapter's program in `pkg` (the JAX static
    module or the port's); a JAX run starts from its startup's
    ``numpy_start`` scope and returns it, a port run uses `scope`
    (filled by the port's startup where it lacks a var)."""
    opt_mod = paddle.optimizer if pkg is jstatic else popt
    opt = getattr(opt_mod, spec["opt"])
    main, startup, loss, _, _ = chip_smoke.book_program(
        pkg, lambda lo: opt(**spec["kw"]).minimize(lo), which, spec["size"],
        drop=drop, small=True)
    feed = chip_smoke.chapter_batch(np.random.default_rng(4), which,
                                    spec["size"])
    start = None
    if pkg is jstatic:
        exe, scope, start = pkg.Executor(), pkg.Scope(), numpy_start(startup)
        for n, v in start.items():
            scope.set(n, jax.numpy.asarray(v))
    else:
        exe = pkg.Executor("cpu")
        exe.run(startup, scope=scope)
    losses = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for _ in range(steps)]
    return losses, start


@pytest.mark.parametrize("which", list(STATIC))
def test_static_chapter(which):
    spec = STATIC[which]
    jl, start = _static_runs(jstatic, which, spec, 0.0, PARITY_STEPS)
    pl, _ = _static_runs(tstatic, which, spec, 0.0, PARITY_STEPS,
                         scope_from_numpy(start, "cpu"))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL, atol=0)

    # the chapter alone on the port, from the same start, dropout on;
    # test_book.py's paddle.seed(7) fixes the dropout masks' base seed
    ptorch.seed(7)
    losses, _ = _static_runs(tstatic, which, spec, 1.0, spec["steps"],
                             scope_from_numpy(start, "cpu"))
    if which == "image_classification":
        assert np.mean(losses[-5:]) < spec["ratio"] * losses[0], losses
    else:
        assert losses[-1] < spec["ratio"] * losses[0], losses
