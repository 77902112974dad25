"""Port parity: the PaddlePaddle book's two recurrent models, chapter 06's
sentiment LSTM and chapter 08's GRU encoder-decoder with beam search,
and chapter 06's convolution net (``chip_smoke.book_models``, one source
for both packages), at toy widths (2 layers, H 16, V 64; the convolution
net E 16, 16 filters), three Adam steps (the convolution net: three
Adagrad steps on its sparse embedding gradient) from the JAX model's
weights carried by ``models.layer_from_numpy``, both on the CPU (each
JAX step traced into one jitted value, gradient and update; under
``jit`` the JAX embedding's gradient is dense, and Adagrad moves no row
a step leaves at zero, so the port's lazy update is held to it).

Every step's loss within 1e-5 relative, and after the last step every
parameter within 1e-4 of its tensor's largest magnitude; a parameter
whose JAX gradient is exactly 0 (the padding id's embedding row: its
positions are masked out) is bounded as ``test_torch_bert.py`` bounds
one, moved exactly where JAX's moved and at most 2 x the summed step
sizes from it.  After training, the translation model's beam ids equal
JAX's."""
import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import layer_from_numpy
from torch_op_parity import with_params

STEPS, LR = 3, 5e-3
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
SENTIMENT = dict(vocab=64, emb=16, hidden=16, layers=2, classes=2)
TRANSLATION = dict(vocab=64, word=16, hidden=16)
CONVOLUTION = dict(vocab=64, emb=16, filters=16, classes=2)
B, T_SENT, T_TRANS, BEAM = 4, 8, 6, 3


def _jax_state(layer):
    return {n: np.array(t._data) for n, t in layer.state_dict().items()}


def _train(model, loss_fn, opt, steps):
    """Losses of `steps` eager steps of the port's model, and the
    parameters after the last."""
    losses = []
    for _ in range(steps):
        loss = loss_fn()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    final = {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}
    return losses, final


def _jax_train(model, args, steps, opt_cls="Adam"):
    """`steps` `opt_cls` steps of the JAX model, each one call of a jitted
    function (instead of one compile per eager op): its ``loss`` under
    ``jax.value_and_grad`` (the parameters' data swapped for the traced
    values), then the JAX optimizer's ``update``, the rule its eager
    ``step`` applies.  Returns the losses, the first step's gradients
    (None where the eager tape gives none: a parameter the loss does not
    reach) and the parameters after the last, which the model keeps."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    opt = getattr(paddle.optimizer, opt_cls)(learning_rate=LR,
                                             parameters=params)
    targs = [paddle.to_tensor(a) for a in args]

    def loss_of(datas):
        return with_params(params, datas, lambda: model.loss(*targs)._data)

    @jax.jit
    def step(datas, states):
        loss, grads = jax.value_and_grad(loss_of)(datas)
        new = [opt.update(d, g, st, LR)
               for d, g, st in zip(datas, grads, states)]
        return loss, grads, [n[0] for n in new], [n[1] for n in new]

    datas = [p._data for p in params]
    states = [opt._state_for(p) for p in params]
    losses, first = [], None
    for _ in range(steps):
        loss, grads, datas, states = step(datas, states)
        losses.append(float(loss))
        if first is None:
            first = {n: np.asarray(g) for (n, _), g in zip(named, grads)}
    for p, d in zip(params, datas):
        p._data = d
    return losses, first, {n: np.array(d) for (n, _), d in zip(named,
                                                                datas)}


def _run_both(build_args, cls_index, loss_args, opt_cls="Adam"):
    """The JAX model and its port copy trained alike: (JAX losses, JAX
    first gradients, JAX start, JAX final), (port losses, final), and the
    two trained models."""
    jcls = chip_smoke.book_models(paddle, jnn, JF, jnn.Layer)[cls_index]
    pcls = chip_smoke.port_book_models()[cls_index]
    paddle.seed(3)
    jm = jcls(**build_args)
    start = _jax_state(jm)
    pm = layer_from_numpy(pcls(**build_args), start, device="cpu")
    pargs = [torch.from_numpy(a) for a in loss_args]
    popt_ = getattr(popt, opt_cls)(learning_rate=LR,
                                   parameters=pm.parameters())
    jl, jg, jf = _jax_train(jm, loss_args, STEPS, opt_cls)
    pl, pf = _train(pm, lambda: pm.loss(*pargs), popt_, STEPS)
    return (jl, jg, start, jf), (pl, pf), jm, pm


def _hold(jax_run, port_run):
    (jl, jg, start, jf), (pl, pf) = jax_run, port_run
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL, atol=0)
    assert pl[-1] < pl[0]
    assert set(pf) == set(jf)
    for n, want in jf.items():
        got = pf[n]
        diff = np.abs(got.astype(np.float64) - want)
        assert diff.max() <= 2 * STEPS * LR, n
        assert np.array_equal(got, start[n]) == np.array_equal(
            want, start[n]), n
        zero = jg[n] is None or not np.any(jg[n])
        if not zero:
            tol = PARAM_TOL * np.abs(want).max()
            assert diff.max() <= tol, (n, diff.max(), tol)


@pytest.fixture(scope="module")
def sentiment():
    rng = np.random.default_rng(0)
    ids, lens, label = chip_smoke.sentiment_batch(
        rng, B, T_SENT, SENTIMENT["vocab"], 3)
    return _run_both(SENTIMENT, 0, (ids, lens, label))


@pytest.fixture(scope="module")
def convolution():
    rng = np.random.default_rng(2)
    ids, lens, label = chip_smoke.sentiment_batch(
        rng, B, T_SENT, CONVOLUTION["vocab"], 3)
    return _run_both(CONVOLUTION, 2, (ids, lens, label), "Adagrad")


@pytest.fixture(scope="module")
def translation():
    rng = np.random.default_rng(1)
    src, src_len, trg = chip_smoke.translation_batch(
        rng, B, T_TRANS, TRANSLATION["vocab"])
    src_len[1:] -= np.array([2, 3, 1])               # some padded sources
    return _run_both(TRANSLATION, 1, (src, src_len, trg)), (src, src_len)


def test_sentiment_lstm_three_adam_steps_match_jax(sentiment):
    """Chapter 06: losses, then every parameter (the padding row's
    gradient is exactly 0 in both)."""
    jax_run, port_run, _, _ = sentiment
    _hold(jax_run, port_run)
    assert not np.any(jax_run[1]["embedding.weight"][0])


def test_translation_gru_three_adam_steps_match_jax(translation):
    """Chapter 08, teacher-forced: losses, then every parameter."""
    (jax_run, port_run, _, _), _ = translation
    _hold(jax_run, port_run)


def test_translation_beam_ids_after_training_match_jax(translation):
    """Beam search (beam 3, 5 steps) over the trained models: ids and
    lengths identical, the final scores within 1e-5."""
    (_, _, jm, pm), (src, src_len) = translation
    want = jm.beam_decode(paddle.to_tensor(src), paddle.to_tensor(src_len),
                          BEAM, 5)
    with torch.no_grad():
        got = pm.beam_decode(torch.from_numpy(src), torch.from_numpy(
            src_len), BEAM, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]._data))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]._data))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]._data),
                               rtol=1e-5, atol=1e-5)
    assert got[0].shape == (B, 5, BEAM)


def test_convolution_net_three_sparse_adagrad_steps_match_jax(convolution):
    """Chapter 06's convolution_net: the port's embedding gradient is
    sparse (one row per lookup) and its step lazy; losses, then every
    parameter, and the rows no review names stay as they started."""
    jax_run, port_run, _, pm = convolution
    _hold(jax_run, port_run)
    assert pm.embedding._sparse
    ids = chip_smoke.sentiment_batch(np.random.default_rng(2), B, T_SENT,
                                     CONVOLUTION["vocab"], 3)[0]
    unused = np.setdiff1d(np.arange(CONVOLUTION["vocab"]), ids)
    start, final = jax_run[2]["embedding.weight"], port_run[1][
        "embedding.weight"]
    np.testing.assert_array_equal(final[unused], start[unused])
