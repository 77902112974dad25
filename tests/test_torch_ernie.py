"""Port parity: ERNIE (``paddle_tpu_torch.models.ernie``).

The JAX package's ``ErnieForPretraining`` at ``ernie_tiny`` with task
embeddings (vocab 1024, hidden 64, 2 layers, 4 heads, FFN 128, dropout
0), its weights carried into the port, on one numpy batch (B 2, L 32)
whose MLM labels come from the JAX ``apply_knowledge_mask`` (-100 off the
masked spans):
- the loss and the sentence-order logits at atol = rtol = 1e-5 (fp32 on
  both sides, other summation orders); the MLM logits at rtol 1e-5 and
  atol 1e-5 of their largest magnitude (a logit sums 64 products with a
  Normal(0, 1) table row, so it reaches about 30, and its rounding is
  absolute at that scale); every parameter's gradient at 1e-4; under
  additive, bool and integer attention masks, with sentence and task ids
  given and defaulted;
- ``apply_knowledge_mask`` bitwise against the JAX function, from an
  explicit stream and from each module's default stream;
- 3 AdamW steps with a -100-masked batch against ``CompiledTrainStep``
  on a one-device mesh, fp32, at ``test_torch_train_step.py``'s
  tolerances.
"""
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.models.ernie as jernie
from paddle_tpu.parallel.env import build_mesh
from paddle_tpu.parallel.hybrid import CompiledTrainStep
from paddle_tpu_torch.models import ernie as pernie
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=128, dropout=0.0, use_task_id=True)
B, L, MASK_ID = 2, 32, 3


def _np(t):
    return np.asarray(t._data)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else paddle.to_tensor(a) for a in arrays]


def _spans(rng):
    """Each row cut into spans of 1-4 tokens."""
    out = []
    for _ in range(B):
        cuts = np.cumsum(rng.integers(1, 5, L))
        cuts = [0] + [int(c) for c in cuts if c < L] + [L]
        out.append(list(zip(cuts[:-1], cuts[1:])))
    return out


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TINY["vocab_size"], (B, L)).astype(np.int64)
    masked, mlm = jernie.apply_knowledge_mask(
        ids, _spans(rng), MASK_ID, rng=np.random.RandomState(seed),
        mask_prob=0.3)
    sent = (np.arange(L) >= L // 2).astype(np.int64)[None].repeat(B, 0)
    task = np.full((B, L), 2, np.int64)
    sop = np.array([1, 0], np.int64)
    assert 0 < (mlm != -100).sum() < mlm.size
    return masked, mlm, sop, sent, task


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    paddle.seed(13)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**TINY))
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    pm = pernie.ErnieForPretraining.from_numpy_params(
        named, pernie.ErnieConfig(**TINY), device="cpu")
    ids, mlm, sop, sent, _ = _batch()
    loss = jm.loss(*_j(ids, mlm, sop, sent))
    loss.backward()
    grads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    return jm, named, pm, float(_np(loss)), grads


def _attention_mask(kind):
    keep = np.ones((B, L), bool)
    keep[0, L - 5:] = False
    if kind == "bool":
        return keep
    if kind == "int":
        return keep.astype(np.int32)
    return np.where(keep, 0.0, -1e9).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "additive", "bool", "int"])
@pytest.mark.parametrize("ids_given", [True, False],
                         ids=["sent_task_given", "defaulted"])
def test_logits_match_jax(pair, mask, ids_given):
    jm, _, pm, _, _ = pair
    ids, _, _, sent, task = _batch()
    if not ids_given:
        sent = task = None
    am = None if mask is None else _attention_mask(mask)
    jmlm, jsop = jm(*_j(ids, sent, task, am))
    pmlm, psop = pm(*_t(ids, sent, task, am))
    assert pmlm.shape == (B, L, TINY["vocab_size"]) and psop.shape == (B, 2)
    _assert_logits_close(pmlm, _np(jmlm))
    np.testing.assert_allclose(psop.detach().numpy(), _np(jsop), **TOL)


def test_default_sentence_and_task_are_the_type_0_rows(pair):
    _, _, pm, _, _ = pair
    ids = _batch()[0]
    zeros = np.zeros_like(ids)
    default, _ = pm(*_t(ids))
    explicit, _ = pm(*_t(ids, zeros, zeros))
    torch.testing.assert_close(default, explicit, rtol=0, atol=0)


def test_loss_and_every_grad_match_jax(pair):
    jm, named, pm, loss, grads = pair
    ids, mlm, sop, sent, _ = _batch()
    pm.zero_grad(set_to_none=True)
    got = pm.loss(*_t(ids, mlm, sop, sent))
    np.testing.assert_allclose(float(got.detach()), loss, **TOL)
    got.backward()
    params = dict(pm.named_parameters())
    assert set(params) == set(grads) == set(named)
    for n, g in grads.items():
        np.testing.assert_allclose(params[n].grad.numpy(), g, err_msg=n,
                                   **GRAD_TOL)


def test_mlm_loss_averages_over_the_labelled_positions_only(pair):
    """-100 positions add nothing and count nothing: the MLM loss equals
    the mean over the labelled positions, and with every label -100 the
    loss is 0 (the denominator is at least 1), as in JAX."""
    jm, _, pm, _, _ = pair
    ids, mlm, _, sent, _ = _batch()
    logits, _ = pm(*_t(ids, sent))
    logp = torch.log_softmax(logits, -1)
    valid = torch.from_numpy(mlm != -100)
    picked = logp.gather(-1, torch.from_numpy(np.maximum(mlm, 0))[..., None])
    want = -picked[..., 0][valid].mean()
    got = pm.loss(*_t(ids, mlm, None, sent))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    none = np.full_like(mlm, -100)
    assert float(pm.loss(*_t(ids, none, None, sent)).detach()) == 0.0
    assert float(_np(jm.loss(*_j(ids, none, None, sent)))) == 0.0


def test_knowledge_mask_is_bitwise_the_jax_function(monkeypatch):
    """From an explicit stream and from each module's default stream
    (both reset to RandomState(0)): the same call sequence masks the same
    spans, whole."""
    rng = np.random.default_rng(9)
    ids = rng.integers(4, 1000, (B, L))
    spans = _spans(rng)
    for seed in (0, 5):
        want = jernie.apply_knowledge_mask(ids, spans, MASK_ID,
                                           rng=np.random.RandomState(seed))
        got = pernie.apply_knowledge_mask(ids, spans, MASK_ID,
                                          rng=np.random.RandomState(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(jernie, "_MASK_RNG", np.random.RandomState(0))
    monkeypatch.setattr(pernie, "_MASK_RNG", np.random.RandomState(0))
    calls = []
    for _ in range(3):
        want = jernie.apply_knowledge_mask(ids, spans, MASK_ID)
        got = pernie.apply_knowledge_mask(ids, spans, MASK_ID)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        calls.append(got[1])
    # the default stream moves on between calls
    assert not all(np.array_equal(calls[0], c) for c in calls[1:])
    masked, labels = got
    for row, row_spans in zip(range(B), spans):
        for s, e in row_spans:
            span = labels[row, s:e]
            assert (span == -100).all() or (span == ids[row, s:e]).all()
            assert ((masked[row, s:e] == MASK_ID) == (span != -100)).all()


def test_sequence_classification_matches_jax():
    paddle.seed(17)
    cfg = dict(TINY, use_task_id=False)
    jm = jernie.ErnieForSequenceClassification(jernie.ErnieConfig(**cfg),
                                               num_classes=3)
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    pm = pernie.ErnieForSequenceClassification.from_numpy_params(
        named, pernie.ErnieConfig(**cfg), device="cpu", num_classes=3)
    ids, _, _, sent, _ = _batch(2)
    am = _attention_mask("bool")
    want = _np(jm(*_j(ids, sent, am)))
    got = pm(*_t(ids, sent, am))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for n, v in pm.numpy_params().items():
        np.testing.assert_array_equal(v, named[n])


def test_numpy_params_round_trip_bitwise(pair):
    _, named, pm, _, _ = pair
    back = pm.numpy_params()
    assert set(back) == set(named)
    for n, v in named.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)
    short = {n: v for n, v in named.items() if "task_embeddings" not in n}
    with pytest.raises(ValueError, match="names differ"):
        pernie.ErnieForPretraining.from_numpy_params(
            short, pernie.ErnieConfig(**TINY), device="cpu")


def test_encoder_layers_start_equal():
    pm = pernie.ErnieForPretraining(
        pernie.ErnieConfig(**dict(TINY, num_layers=3)), seed=1,
        device="cpu")
    layers = pm.ernie.encoder.layers
    first = dict(layers[0].named_parameters())
    for layer in layers[1:]:
        for n, p in layer.named_parameters():
            assert torch.equal(p, first[n]), n


def test_scan_layers_matches_jax(pair):
    """``scan_layers=True`` builds and runs the encoder's layers through
    the scan's loop: the loss and every gradient hold to the JAX model
    as the plain port does."""
    jm, named, _, loss, grads = pair
    pm = pernie.ErnieForPretraining.from_numpy_params(
        named, pernie.ErnieConfig(**TINY, scan_layers=True), device="cpu")
    ids, mlm, sop, sent, _ = _batch()
    got = pm.loss(*_t(ids, mlm, sop, sent))
    np.testing.assert_allclose(float(got.detach()), loss, **TOL)
    got.backward()
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n], err_msg=n,
                                   **GRAD_TOL)


@pytest.mark.parametrize("build", [
    lambda: pernie.ErnieForPretraining(pernie.ernie_tiny()),
    lambda: pernie.ErnieForPretraining.from_numpy_params(
        pernie.ErnieForPretraining(pernie.ernie_tiny(),
                                   device="cpu").numpy_params(),
        pernie.ernie_tiny()),
    lambda: pernie.ErnieForSequenceClassification(pernie.ernie_tiny())],
    ids=["pretraining", "from_numpy_params", "classifier"])
def test_entry_points_default_to_the_card(build):
    """On the card unless asked for the CPU; without a card they raise
    rather than carry on on the CPU."""
    if torch.cuda.is_available():
        assert next(build().parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        build()


def test_three_adamw_steps_over_masked_labels_match_compiled_train_step():
    """fp32: each loss within 1e-5 relative; all but 1 in 10^4 parameter
    entries within 1e-5 after 3 steps, every entry within 2 x 3 x lr
    (the key projection's bias, whose exact gradient is 0, moves by
    rounding noise alone and is held by that bound only)."""
    steps, lr = 3, 1e-3
    paddle.seed(19)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**TINY))
    named = {n: np.array(p._data) for n, p in jm.named_parameters()}
    jtr = CompiledTrainStep(
        jm, lambda m, i, l, s: m.loss(i, l, s),
        paddle.optimizer.AdamW(learning_rate=lr,
                               parameters=jm.parameters()),
        build_mesh({"data": 1}))
    ids, mlm, sop, _, _ = _batch(3)
    want = [float(_np(jtr.step(ids, mlm, sop))) for _ in range(steps)]
    final = {n: np.asarray(v) for n, v in jtr.params.items()}
    pm = pernie.ErnieForPretraining.from_numpy_params(
        named, pernie.ErnieConfig(**TINY), device="cpu")
    tr = TrainStep(pm, lambda m, i, l, s, generator: m.loss(
        i, l, s, generator=generator), AdamW(learning_rate=lr),
        device="cpu")
    got = [float(tr.step(*_t(ids, mlm, sop))) for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    far, total = 0, 0
    for n, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - final[n])
        assert diff.max() <= 2 * steps * lr, n
        if not n.endswith("self_attn.k_proj.bias"):
            far += int((diff > 1e-5).sum())
            total += diff.size
    assert far <= total * 1e-4, (far, total)
