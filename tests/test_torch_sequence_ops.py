"""Port parity: the CRF pair (`linear_chain_crf`, `crf_decoding`), `nce`,
`cos_sim` and ``Embedding(padding_idx=...)``; the positional and window
ops, the segment pools and the ``sequence_*`` family (each one case of
``torch_op_parity``, every JAX result traced into one jitted forward and
gradient at module scope); `sample_logits` and `sampling_id`; each
against the JAX package on the CPU, values and gradients within 1e-5 of
each tensor's largest magnitude, integer outputs equal.  The JAX golden
tests of ``tests/test_sequence_ops.py`` have counterparts here, and
each place where the port computes what the reference means and JAX
does not has a test that shows it.

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
from torch_op_parity import case, hold, jax_traced, rand_f, rand_i, run, \
    share

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
    """No longer refused: ``Embedding(sparse=True)`` builds and its weight
    gets a sparse COO gradient of one row per lookup (held against JAX in
    ``test_torch_sparse_grad.py``)."""
    emb = pnn.Embedding(4, 2, sparse=True,
                        generator=torch.Generator().manual_seed(0))
    emb(torch.tensor([[1, 3, 1]])).sum().backward()
    assert emb.weight.grad.is_sparse
    assert emb.weight.grad._values().shape == (3, 2)


# ---- the positional and window ops, segments and the sequence family ----

X3 = rand_f((4, 6, 3), seed=11)
SEQ_LENS = np.array([6, 3, 1, 4])
# zero past each length: there JAX's sequence_conv agrees with the port's
X3_ZERO = X3 * (np.arange(6)[None, :, None] < SEQ_LENS[:, None, None])
FLAT = rand_f((10, 3), seed=12)
SEG_IDS = np.array([0, 0, 1, 3, 3, 2, 1])
CONCAT = ([rand_f((3, 4, 2), seed=13), rand_f((3, 3, 2), seed=14)],
          [np.array([2, 4, 0]), np.array([3, 1, 2])])
IDS = rand_i((3, 6), 9, seed=15)

SEQUENCE = {
    "add_position_encoding": case("add_position_encoding", X3, alpha=0.7,
                                  beta=1.3),
    "add_position_encoding_odd": case("add_position_encoding",
                                      rand_f((2, 4, 5), seed=16)),
    "im2sequence": case("im2sequence", rand_f((2, 3, 5, 6), seed=17),
                        filter_size=2, stride=2),
    "im2sequence_pad": case("im2sequence", rand_f((1, 2, 4, 5), seed=18),
                            filter_size=[2, 3], stride=1, padding=1),
    "row_conv": case("row_conv", X3, rand_f((3, 3), seed=19)),
    "conv_shift": case("conv_shift", rand_f((3, 7), seed=20),
                       rand_f((3, 3), seed=21)),
    "conv_shift_5": case("conv_shift", rand_f((2, 6), seed=22),
                         rand_f((2, 5), seed=23)),
    **{f"segment_{k}": case(f"segment_{k}", rand_f((7, 3), seed=24),
                            SEG_IDS) for k in ("sum", "mean", "max", "min")},
    "segment_pool": case("segment_pool", rand_f((7,), seed=25), SEG_IDS,
                         "MEAN"),
    **{f"sequence_pool_{k}": case("sequence_pool", X3, SEQ_LENS, k)
       for k in ("sum", "average", "sqrt", "max", "last", "first")},
    "sequence_pool_2d": case("sequence_pool", X3[..., 0], SEQ_LENS, "sqrt"),
    "sequence_first_step": case("sequence_first_step", X3, SEQ_LENS),
    "sequence_last_step": case("sequence_last_step", X3, SEQ_LENS),
    "sequence_softmax": case("sequence_softmax", X3[..., 0], SEQ_LENS),
    "sequence_softmax_3d": case("sequence_softmax", X3, SEQ_LENS),
    "sequence_reverse": case("sequence_reverse", X3, SEQ_LENS),
    "sequence_pad": case("sequence_pad", FLAT, np.array([3, 5, 2]),
                         pad_value=-1.0),
    "sequence_pad_maxlen": case("sequence_pad", FLAT, np.array([3, 5, 2]),
                                maxlen=7),
    "sequence_unpad": case("sequence_unpad", rand_f((3, 5, 2), seed=26),
                           np.array([3, 5, 2])),
    "sequence_expand": case("sequence_expand", rand_f((3, 2), seed=27),
                            [2, 0, 3]),
    "sequence_concat": case("sequence_concat", *CONCAT),
    "sequence_enumerate": case("sequence_enumerate", IDS,
                               np.array([6, 2, 4]), 3, pad_value=-1),
    "sequence_expand_as": case("sequence_expand_as", rand_f((3, 2), seed=31),
                               np.array([2, 3, 1])),
    "sequence_expand_as_maxlen": case("sequence_expand_as",
                                      rand_f((3,), seed=32),
                                      np.array([2, 3, 1]), maxlen=4),
    "sequence_reshape": case("sequence_reshape", rand_f((3, 4, 2), seed=33),
                             np.array([2, 4, 1]), 1),
    "sequence_reshape_wide": case("sequence_reshape",
                                  rand_f((3, 4, 2), seed=34),
                                  np.array([2, 4, 0]), 4),
    "sequence_scatter": case("sequence_scatter", rand_f((8,), seed=35),
                             np.array([[1, 3, 3], [2, 0, 7]]),
                             rand_f((2, 3), seed=36), np.array([3, 1])),
    "sequence_slice": case("sequence_slice", rand_f((3, 5, 2), seed=37),
                           np.array([5, 4, 5]), np.array([1, 0, 3]),
                           np.array([2, 4, 3])),
}


# the cases whose JAX function reads its ids or lengths on the host (a
# traced value cannot be read back): run eagerly
EAGER = {"segment_sum", "segment_mean", "segment_max", "segment_min",
         "segment_pool", "sequence_pad", "sequence_pad_maxlen",
         "sequence_unpad", "sequence_expand_as"}


# on inputs zero past each length (there the packages' outputs agree)
CONV = {
    "sequence_conv": case("sequence_conv", X3_ZERO, rand_f((9, 5), seed=28),
                          SEQ_LENS),
    "sequence_conv_4": case("sequence_conv", X3_ZERO,
                            rand_f((12, 5), seed=29), SEQ_LENS,
                            context_length=4),
    "sequence_conv_start0": case("sequence_conv", X3_ZERO,
                                 rand_f((6, 2), seed=30), SEQ_LENS,
                                 context_length=2, context_start=0),
}


@pytest.fixture(scope="module")
def sequence_results():
    out = jax_traced([(k, c) for k, c in list(SEQUENCE.items())
                      + list(CONV.items()) if k not in EAGER])
    out.update({k: run(SEQUENCE[k], jax=True) for k in EAGER})
    return out


@pytest.mark.parametrize("name", list(SEQUENCE))
def test_sequence_family_matches_jax(name, sequence_results):
    hold(SEQUENCE[name], *sequence_results[name], fwd_tol=TOL)


@pytest.mark.parametrize("name", list(CONV))
def test_sequence_conv_matches_jax(name, sequence_results):
    """Outputs and the weight's gradient as JAX's; the input's gradient
    as JAX's at each row's valid steps and 0 past them, where the JAX
    windows read the padding (`test_sequence_conv_keeps_each_window_
    inside_its_sequence`)."""
    (want,), (want_gx, want_gw) = sequence_results[name]
    (got,), (got_gx, got_gw) = run(CONV[name], jax=False)
    valid = (np.arange(6)[None, :] < SEQ_LENS[:, None])[..., None]
    assert share(got, want) <= TOL
    assert share(got_gw, want_gw) <= TOL
    assert share(got_gx, np.where(valid, want_gx, 0.0)) <= TOL
    assert not got_gx[~np.broadcast_to(valid, got_gx.shape)].any()


def _np(t):
    return t.detach().cpu().numpy()


def test_add_position_encoding_golden():
    out = _np(ptorch.add_position_encoding(torch.zeros(1, 3, 4)))
    np.testing.assert_allclose(out[0, 0], [0.0, 0.0, 1.0, 1.0], atol=1e-6)
    assert abs(out[0, 1, 0] - np.sin(1.0)) < 1e-5
    assert abs(out[0, 1, 2] - np.cos(1.0)) < 1e-5


def test_im2sequence_row_conv_conv_shift_golden():
    seq = ptorch.im2sequence(torch.arange(16.0).reshape(1, 1, 4, 4),
                             filter_size=2, stride=2)
    assert seq.shape == (4, 4)
    np.testing.assert_allclose(_np(seq)[0], [0, 1, 4, 5])
    out = _np(ptorch.row_conv(torch.ones(1, 3, 2), torch.ones(2, 2)))
    np.testing.assert_allclose(out[0, :, 0], [2.0, 2.0, 1.0])
    xs = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    got = ptorch.conv_shift(xs, torch.tensor([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose(_np(got), _np(xs), rtol=1e-6)


def test_segment_pool_golden():
    x = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    ids = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    for fn, want in ((ptorch.segment_sum, [[3.0], [12.0]]),
                     (ptorch.segment_mean, [[1.5], [6.0]]),
                     (ptorch.segment_max, [[2.0], [8.0]]),
                     (ptorch.segment_min, [[1.0], [4.0]])):
        np.testing.assert_allclose(_np(fn(x, ids)), want)


def test_sequence_pool_softmax_reverse_golden():
    x = torch.tensor([[1.0, 2.0, 9.0], [3.0, 9.0, 9.0]])
    lt = torch.tensor([2, 1])
    for kind, want in (("sum", [3.0, 3.0]), ("average", [1.5, 3.0]),
                       ("max", [2.0, 3.0])):
        np.testing.assert_allclose(
            _np(ptorch.sequence_pool(x[..., None], lt, kind)).reshape(-1),
            want)
    np.testing.assert_allclose(
        _np(ptorch.sequence_last_step(x[..., None], lt)).reshape(-1),
        [2.0, 3.0])
    np.testing.assert_allclose(
        _np(ptorch.sequence_first_step(x[..., None], lt)).reshape(-1),
        [1.0, 3.0])
    sm = _np(ptorch.sequence_softmax(x, lt))
    e = np.exp([1.0, 2.0])
    np.testing.assert_allclose(sm[0], list(e / e.sum()) + [0.0], rtol=1e-6)
    np.testing.assert_allclose(sm[1], [1.0, 0.0, 0.0], atol=1e-7)
    rv = _np(ptorch.sequence_reverse(x, lt))
    np.testing.assert_allclose(rv, [[2.0, 1.0, 9.0], [3.0, 9.0, 9.0]])


def test_sequence_pad_unpad_expand_roundtrip_golden():
    flat = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    padded, lens = ptorch.sequence_pad(flat, np.array([3, 2]),
                                       pad_value=-1.0)
    assert padded.shape == (2, 3, 2)
    np.testing.assert_allclose(_np(padded)[1, 2], [-1.0, -1.0])
    np.testing.assert_allclose(_np(ptorch.sequence_unpad(padded, lens)),
                               _np(flat))
    ex = ptorch.sequence_expand(flat[:2], np.array([2, 1]))
    np.testing.assert_allclose(_np(ex), _np(flat)[[0, 0, 1]])


def test_sequence_conv_identity_window_golden():
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 4, 3).astype(
        np.float32))
    out = _np(ptorch.sequence_conv(x, torch.eye(3), torch.tensor([4, 2]),
                                   context_length=1, context_start=0))
    np.testing.assert_allclose(out[0], _np(x)[0], rtol=1e-6)
    np.testing.assert_allclose(out[1, :2], _np(x)[1, :2], rtol=1e-6)
    np.testing.assert_allclose(out[1, 2:], 0.0)


def test_sequence_concat_enumerate_expand_as_golden():
    out, ol = ptorch.sequence_concat(
        [torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.float32),
         torch.tensor([[5, 0], [6, 7]], dtype=torch.float32)],
        [torch.tensor([2, 1]), torch.tensor([1, 2])])
    np.testing.assert_allclose(_np(out), [[1, 2, 5, 0, 0], [3, 6, 7, 0, 0]])
    np.testing.assert_array_equal(_np(ol), [3, 3])
    e = ptorch.sequence_enumerate(torch.tensor([[1, 2, 3, 0]]),
                                  torch.tensor([3]), 2)
    np.testing.assert_array_equal(_np(e)[0], [[1, 2], [2, 3], [3, 0], [0, 0]])
    ea = ptorch.sequence_expand_as(torch.tensor([[9.0], [8.0]]),
                                   torch.tensor([2, 3]))
    np.testing.assert_allclose(_np(ea)[..., 0], [[9, 9, 0], [8, 8, 8]])


def test_sequence_reshape_scatter_slice_golden():
    r, rl = ptorch.sequence_reshape(
        torch.arange(12, dtype=torch.float32).reshape(2, 3, 2),
        torch.tensor([2, 3]), 1)
    assert r.shape == (2, 6, 1)
    np.testing.assert_array_equal(_np(rl), [4, 6])
    s = ptorch.sequence_scatter(torch.zeros(6), torch.tensor([[1, 3], [2, 0]]),
                                torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
                                torch.tensor([2, 1]))
    np.testing.assert_allclose(_np(s), [0, 1, 3, 2, 0, 0])
    sl, sll = ptorch.sequence_slice(
        torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.float32),
        torch.tensor([4, 4]), torch.tensor([1, 0]), torch.tensor([2, 3]))
    np.testing.assert_allclose(_np(sl), [[2, 3, 0, 0], [5, 6, 7, 0]])
    np.testing.assert_array_equal(_np(sll), [2, 3])
    with pytest.raises(ValueError, match="drop data"):
        ptorch.sequence_reshape(torch.zeros(2, 4, 2), torch.tensor([1, 4]), 4)


def test_sample_logits_matches_jax_on_jax_ids(monkeypatch):
    """The picked logits, their ids and the logits' gradient equal JAX's
    on JAX's log-uniform negatives; the true labels come first."""
    rng = np.random.default_rng(40)
    logits = rng.standard_normal((4, 20)).astype(np.float32)
    label = rng.integers(0, 20, (4, 2))
    cot = rng.standard_normal((4, 8)).astype(np.float32)
    jl = paddle.to_tensor(logits, stop_gradient=False)
    jpicked, jids = paddle.sample_logits(jl, paddle.to_tensor(label), 6,
                                         seed=5)
    paddle.sum(jpicked * paddle.to_tensor(cot)).backward()
    neg = np.asarray(JS._log_uniform_sample(JS._op_key(5), 6, 20))
    monkeypatch.setattr(PS, "draw_negatives",
                        lambda seed, n, vocab, s: torch.tensor(neg))
    pl = _t(logits, True)
    picked, ids = ptorch.sample_logits(pl, _t(label), 6, seed=5)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids._data))
    np.testing.assert_array_equal(_np(ids)[:, :2], label)
    np.testing.assert_allclose(_np(picked), np.asarray(jpicked._data),
                               rtol=TOL, atol=TOL)
    (picked * _t(cot)).sum().backward()
    np.testing.assert_allclose(pl.grad.numpy(), np.asarray(jl.grad._data),
                               rtol=TOL, atol=TOL)
    assert ids.dtype == torch.int64 and not ids.requires_grad


def test_sampling_id_draws_its_distribution():
    """A one-hot row always gives its column (JAX's golden case); 20,000
    draws of a fixed distribution pass a chi-square test against it
    (JAX's threefry draws cannot be replayed); a seed draws again the
    same ids."""
    assert int(ptorch.sampling_id(torch.tensor([[0.0, 1.0, 0.0]]))[0]) == 1
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    probs = torch.from_numpy(np.tile(p, (20000, 1)))
    ids = ptorch.sampling_id(probs, seed=9)
    assert ids.dtype == torch.int64 and ids.shape == (20000,)
    counts = np.bincount(ids.numpy(), minlength=4)
    stat = (((counts - 20000 * p) ** 2) / (20000 * p)).sum()
    assert scipy.stats.chi2.sf(stat, 3) > 1e-3, stat
    assert torch.equal(ids, ptorch.sampling_id(probs, seed=9))


def test_sequence_conv_keeps_each_window_inside_its_sequence():
    """The reference's LoD op reads zeros outside a sequence; JAX's
    masks only its output, so the last valid step's window reads the
    padding: [1, 2 | 100, 100] at length 2, window 3 of ones."""
    x = np.array([[[1.0], [2.0], [100.0], [100.0]]], np.float32)
    w, lens = np.ones((3, 1), np.float32), np.array([2])
    port = ptorch.sequence_conv(_t(x), _t(w), _t(lens))
    jax_out = paddle.sequence_conv(paddle.to_tensor(x), paddle.to_tensor(w),
                                   paddle.to_tensor(lens))
    np.testing.assert_array_equal(_np(port)[0, :, 0], [3.0, 3.0, 0.0, 0.0])
    np.testing.assert_array_equal(np.asarray(jax_out._data)[0, :, 0],
                                  [3.0, 103.0, 0.0, 0.0])


def test_row_conv_takes_no_lengths_as_in_jax():
    """``row_conv`` keeps JAX's signature and result: with no lengths, a
    row's lookahead reads past its sequence (the reference's would stop
    at the length-2 sequence's end and give 2 at step 1)."""
    x = np.array([[[1.0], [2.0], [100.0]]], np.float32)
    w = np.ones((2, 1), np.float32)
    port = _np(ptorch.row_conv(_t(x), _t(w)))
    want = np.asarray(paddle.row_conv(paddle.to_tensor(x),
                                      paddle.to_tensor(w))._data)
    np.testing.assert_array_equal(port, want)
    assert port[0, 1, 0] == 102.0


def test_empty_rows_and_segments_hold_jax_values():
    """A row of length 0 pools to JAX's values (max -3.4e38, last the
    last step, first the first), a segment id that never occurs to -inf
    (max) and +inf (min) as ``jax.ops.segment_max``/``segment_min``
    give (``scatter_reduce`` alone would leave its initial value)."""
    x = rand_f((3, 4, 2), seed=41)
    lens = np.array([4, 0, 2])
    for kind in ("max", "last", "first", "sum", "average", "sqrt"):
        want = np.asarray(paddle.sequence_pool(
            paddle.to_tensor(x), paddle.to_tensor(lens), kind)._data)
        got = _np(ptorch.sequence_pool(_t(x), _t(lens), kind))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (_np(ptorch.sequence_pool(_t(x), _t(lens), "max"))[1]
            == np.float32(-3.4e38)).all()
    v, ids = rand_f((4, 2), seed=42), np.array([0, 3, 3, 0])
    for fn in ("segment_max", "segment_min", "segment_sum", "segment_mean"):
        want = np.asarray(getattr(paddle, fn)(paddle.to_tensor(v),
                                              paddle.to_tensor(ids))._data)
        got = _np(getattr(ptorch, fn)(_t(v), _t(ids)))
        np.testing.assert_array_equal(got, want)
    assert np.isneginf(_np(ptorch.segment_max(_t(v), _t(ids)))[1:3]).all()
    assert np.isposinf(_np(ptorch.segment_min(_t(v), _t(ids)))[1:3]).all()


def test_the_sequence_family_has_the_jax_names():
    """Every name of the JAX module's ``__all__`` is exported by the port's
    module, its ``ops`` and its top level."""
    for name in JS.__all__:
        assert hasattr(PS, name) and hasattr(ptorch.ops, name) \
            and hasattr(ptorch, name), name
