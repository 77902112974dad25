"""Port parity: the CRF pair (`linear_chain_crf`, `crf_decoding`), `nce`,
`cos_sim` and ``Embedding(padding_idx=...)`` against the JAX package on
the CPU, values and gradients within 1e-5.

The port cannot replay JAX's threefry draws, so the NCE arithmetic is
held with ``sequence_ops.draw_negatives`` patched to return the ids JAX
drew (``jax.random`` on ``sequence_ops._op_key(seed)``), and the port's
own sampler by its distribution: a chi-square test over 20,000 draws.
The CRF oracle is the JAX package's ``_crf_ll`` and ``_viterbi`` traced
once into jitted functions at module scope."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptorch
from paddle_tpu.core.tensor import _wrap_data
from paddle_tpu.ops import sequence_ops as JS
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.ops import sequence_ops as PS

TOL = 1e-5
B, T, N = 5, 6, 4
RNG = np.random.default_rng(0)
EMISSION = RNG.standard_normal((B, T, N)).astype(np.float32)
TRANSITION = RNG.standard_normal((N + 2, N)).astype(np.float32)
LABEL = RNG.integers(0, N, (B, T))
LENGTH = np.array([T, 1, 3, T - 1, 2])   # 1..T mixed in one batch
COT = RNG.standard_normal((B, 1)).astype(np.float32)

_crf_value_grad = jax.jit(jax.value_and_grad(
    lambda e, t: jnp.sum(JS._crf_ll(e, t, jnp.asarray(LABEL),
                                    jnp.asarray(LENGTH)) * COT),
    argnums=(0, 1)))
_crf_ll = jax.jit(JS._crf_ll)
_viterbi = jax.jit(JS._viterbi)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def test_linear_chain_crf_matches_jax():
    """Log-likelihoods and the gradients of emissions and transitions
    (autograd) against JAX's, lengths 1..T in one batch."""
    want_ll = np.asarray(_crf_ll(EMISSION, TRANSITION, LABEL, LENGTH))
    _, (want_ge, want_gt) = _crf_value_grad(EMISSION, TRANSITION)
    e, t = _t(EMISSION, True), _t(TRANSITION, True)
    ll = ptorch.linear_chain_crf(e, t, _t(LABEL), _t(LENGTH))
    assert ll.shape == (B, 1)
    np.testing.assert_allclose(ll.detach().numpy(), want_ll, rtol=TOL,
                               atol=TOL)
    (ll * _t(COT)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_ge),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gt),
                               rtol=TOL, atol=TOL)
    # a padded position's emission gets no gradient
    assert not e.grad[1, 1:].any()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_crf_decoding_matches_jax(ties):
    """The Viterbi paths equal JAX's, 0 past each length; with integer
    scores, equal paths tie and the lower tag wins in both."""
    e, tr = EMISSION, TRANSITION
    if ties:
        e, tr = np.round(e), np.round(tr)
    want = np.asarray(_viterbi(e, tr, LENGTH))
    got = ptorch.crf_decoding(_t(e, True), _t(tr), _t(LENGTH))
    assert got.dtype == torch.int64 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1, 1:].any()


V, S, DIM = 23, 6, 5
NCE_SEED = 7
NCE_CASES = [(sampler, bias, label_shape)
             for sampler in ("uniform", "log_uniform")
             for bias in (True, False)
             for label_shape in ((B,), (B, 2))]


def _nce_inputs(label_shape):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((B, DIM)).astype(np.float32),
            rng.standard_normal((V, DIM)).astype(np.float32),
            rng.standard_normal(V).astype(np.float32),
            rng.integers(0, V, label_shape),
            rng.standard_normal((B, 1)).astype(np.float32))


@functools.cache
def _jax_nce():
    """Every NCE case's JAX cost and the gradients of x, w and b under its
    cotangent, the JAX package's `nce` traced into one jitted function;
    and the ids each case's sampler drew (``jax.random`` on
    ``_op_key(NCE_SEED)``)."""
    inputs = [_nce_inputs(shape) for _, _, shape in NCE_CASES]

    def loss(floats):
        total, costs = 0.0, []
        with paddle.no_grad():
            for (sampler, bias, _), (x, w, b), (_, _, _, lbl, cot) in zip(
                    NCE_CASES, floats, inputs):
                cost = paddle.nce(_wrap_data(x), _wrap_data(w),
                                  paddle.to_tensor(lbl),
                                  bias=_wrap_data(b) if bias else None,
                                  num_total_classes=V, num_neg_samples=S,
                                  sampler=sampler, seed=NCE_SEED)._data
                costs.append(cost)
                total = total + jnp.sum(cost * cot)
        return total, costs

    floats = [tuple(jnp.asarray(a) for a in i[:3]) for i in inputs]
    (_, costs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        floats)
    key = JS._op_key(NCE_SEED)
    ids = {"log_uniform": np.asarray(JS._log_uniform_sample(key, S, V)),
           "uniform": np.asarray(jax.random.randint(key, (S,), 0, V))}
    return ([np.asarray(c) for c in costs],
            [[np.asarray(g) for g in gs] for gs in grads], ids)


@pytest.mark.parametrize("case", range(len(NCE_CASES)), ids=[
    f"{s}-{'bias' if b else 'no_bias'}-labels_{'BL' if len(sh) > 1 else 'B'}"
    for s, b, sh in NCE_CASES])
def test_nce_matches_jax_on_jax_ids(case, monkeypatch):
    sampler, bias, label_shape = NCE_CASES[case]
    x, w, b, lbl, cot = _nce_inputs(label_shape)
    costs, grads, ids = _jax_nce()
    monkeypatch.setattr(PS, "draw_negatives",
                        lambda seed, n, vocab, s: torch.tensor(ids[sampler]))
    pargs = [_t(a, True) for a in (x, w, b)]
    pcost = ptorch.nce(pargs[0], pargs[1], _t(lbl),
                       bias=pargs[2] if bias else None,
                       num_total_classes=V, num_neg_samples=S,
                       sampler=sampler, seed=NCE_SEED)
    assert pcost.shape == (B, 1)
    np.testing.assert_allclose(pcost.detach().numpy(), costs[case],
                               rtol=TOL, atol=TOL)
    (pcost * _t(cot)).sum().backward()
    for want, p in zip(grads[case][:3 if bias else 2], pargs):
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=TOL, atol=TOL)
    if not bias:
        assert pargs[2].grad is None


@pytest.mark.parametrize("sampler", ["log_uniform", "uniform"])
def test_nce_sampler_distribution(sampler):
    """20,000 draws of V = 50 classes against the sampler's probabilities
    (``log_uniform_log_prob``, or 1/V) by a chi-square test; one seed
    draws the same ids again, seed 0 follows ``paddle.seed``."""
    vocab, n = 50, 20000
    ids = PS.draw_negatives(11, n, vocab, sampler)
    assert ids.dtype == torch.int64 and 0 <= ids.min() and ids.max() < vocab
    counts = np.bincount(ids.numpy(), minlength=vocab)
    if sampler == "log_uniform":
        p = np.exp(PS.log_uniform_log_prob(torch.arange(vocab),
                                           vocab).double().numpy())
    else:
        p = np.full(vocab, 1.0 / vocab)
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-5)
    stat = (((counts - n * p) ** 2) / (n * p)).sum()
    assert scipy.stats.chi2.sf(stat, vocab - 1) > 1e-3, stat
    assert torch.equal(ids, PS.draw_negatives(11, n, vocab, sampler))
    ptorch.seed(3)
    a = PS.draw_negatives(0, 100, vocab, sampler)
    ptorch.seed(3)
    assert torch.equal(a, PS.draw_negatives(0, 100, vocab, sampler))


def test_log_uniform_log_prob_matches_jax():
    k = np.arange(40)
    np.testing.assert_allclose(
        PS.log_uniform_log_prob(torch.from_numpy(k), 40).numpy(),
        np.asarray(JS._log_uniform_log_prob(jnp.asarray(k), 40)),
        rtol=1e-6)


@pytest.mark.parametrize("rows", [B, 1], ids=["rows", "broadcast_y"])
def test_cos_sim_matches_jax(rows):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, DIM)).astype(np.float32)
    y = rng.standard_normal((rows, DIM)).astype(np.float32)
    x[2] = 0.0                  # a zero row: the 1e-12 floor
    cot = rng.standard_normal((B, 1)).astype(np.float32)
    jx, jy = (paddle.to_tensor(a, stop_gradient=False) for a in (x, y))
    jout = paddle.cos_sim(jx, jy)
    paddle.sum(jout * paddle.to_tensor(cot)).backward()
    px, py = _t(x, True), _t(y, True)
    pout = ptorch.cos_sim(px, py)
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout._data),
                               rtol=TOL, atol=TOL)
    (pout * _t(cot)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(py.grad.numpy(), np.asarray(jy.grad._data),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("padding_idx", [3, -2], ids=["index", "negative"])
def test_embedding_padding_idx_matches_jax(padding_idx):
    """The row is zero from construction, its lookups are zeros and it
    gets no gradient; outputs and the weight's gradient equal JAX's."""
    vocab, dim = 9, 4
    row = padding_idx % vocab
    port = pnn.Embedding(vocab, dim, padding_idx=padding_idx,
                         generator=torch.Generator().manual_seed(0))
    assert not port.weight[row].any() and port.weight.abs().sum() > 0
    paddle.seed(4)
    jl = jnn.Embedding(vocab, dim, padding_idx=padding_idx)
    port = layer_from_numpy(port, {"weight": np.asarray(jl.weight._data)},
                            device="cpu")
    ids = np.array([[row, 1, 2], [0, row, row]])
    cot = np.random.default_rng(5).standard_normal((2, 3, dim)).astype(
        np.float32)
    jout = jl(paddle.to_tensor(ids))
    paddle.sum(jout * paddle.to_tensor(cot)).backward()
    pout = port(torch.from_numpy(ids))
    assert not pout[0, 0].any() and not pout[1, 1:].any()
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout._data),
                               rtol=TOL, atol=TOL)
    (pout * torch.from_numpy(cot)).sum().backward()
    assert not port.weight.grad[row].any()
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(jl.weight.grad._data), rtol=TOL,
                               atol=TOL)


def test_sparse_embedding_still_refused():
    with pytest.raises(NotImplementedError, match="sparse"):
        pnn.Embedding(4, 2, sparse=True)
