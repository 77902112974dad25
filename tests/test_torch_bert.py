"""Port parity: BERT pretraining (``paddle_tpu_torch.models.bert``).

The JAX package's ``BertForPretraining`` at ``bert_tiny`` (vocab 1024,
hidden 64, 2 layers, 4 heads, FFN 128, dropout 0), its weights carried
into the port, on the same numpy batch (B 2, L 32; a few MLM labels
-100):
- the loss and the NSP logits at atol = rtol = 1e-5 (fp32 on both sides,
  other summation orders); the MLM logits at rtol 1e-5 and atol 1e-5 of
  their largest magnitude (each sums 64 products of the unit-scale MLM
  state with a Normal(0, 1) table row, so it reaches about 30, and its
  rounding is absolute at that scale: a logit near 0 keeps it); every
  parameter's gradient (JAX eager ``loss.backward()``) at 1e-4; under
  additive, bool and integer attention masks, and with
  ``token_type_ids`` given and defaulted;
- 3 steps of ``TrainStep`` with AdamW under a ``LinearWarmup`` over
  ``PolynomialDecay`` schedule against ``CompiledTrainStep`` on a
  one-device mesh, fp32 and bf16 amp, and fp32 without NSP labels (the
  pooler and NSP head off the loss's path), with the tolerances of
  ``test_torch_train_step.py`` (bound by the schedule's rates).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.parallel.env import build_mesh
from paddle_tpu.parallel.hybrid import CompiledTrainStep
from paddle_tpu_torch.models import BertConfig, BertForPretraining, bert_tiny
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import TrainStep

TOL = dict(atol=1e-5, rtol=1e-5)
# bert_tiny's widths, for configurations that change its depth or dropout
TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_hidden=128, max_seq_len=128, dropout=0.0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, L, VOCAB = 2, 32, 1024
STEPS, WD = 3, 0.01
TRAIN_TOLS = {None: dict(loss=1e-5, param=1e-5, share=1e-4),
              "bf16": dict(loss=1e-4, param=5e-4, share=1e-3)}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, L)).astype(np.int32)
    mlm = rng.integers(0, VOCAB, (B, L)).astype(np.int32)
    mlm[:, ::5] = -100
    types = (np.arange(L) >= L // 2).astype(np.int32)[None].repeat(B, 0)
    nsp = np.array([0, 1], np.int32)
    return ids, mlm, nsp, types


def _np(t):
    return np.asarray(t._data)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [paddle.to_tensor(a) for a in arrays]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its named weights, the port model, JAX loss and
    grads with NSP labels and token types)."""
    paddle.seed(11)
    jm = JaxBert(jax_bert_tiny())
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    pm = BertForPretraining.from_numpy_params(named, bert_tiny(),
                                              device="cpu")
    ids, mlm, nsp, types = _batch()
    loss = jm.loss(*_j(ids, mlm, nsp, types))
    loss.backward()
    grads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    return jm, named, pm, float(_np(loss)), grads


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _attention_mask(kind):
    keep = np.ones((B, L), bool)
    keep[1, L - 7:] = False
    if kind == "bool":
        return keep
    if kind == "int":
        return keep.astype(np.int64)
    return np.where(keep, 0.0, -1e4).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "additive", "bool", "int"])
def test_logits_match_jax(pair, mask):
    jm, _, pm, _, _ = pair
    ids, _, _, types = _batch()
    am = None if mask is None else _attention_mask(mask)
    jmlm, jnsp = jm(*_j(ids, types), None if am is None else _j(am)[0])
    pmlm, pnsp = pm(*_t(ids, types), None if am is None else _t(am)[0])
    assert pmlm.shape == (B, L, VOCAB) and pnsp.shape == (B, 2)
    _assert_logits_close(pmlm, _np(jmlm))
    np.testing.assert_allclose(pnsp.detach().numpy(), _np(jnsp), **TOL)
    if mask is not None:
        # a masked key changes the outputs: the mask is applied
        free, _ = pm(*_t(ids, types))
        assert not torch.allclose(free[1], pmlm[1], atol=1e-3)


def test_loss_and_every_grad_match_jax(pair):
    jm, named, pm, loss, grads = pair
    ids, mlm, nsp, types = _batch()
    pm.zero_grad(set_to_none=True)
    got = pm.loss(*_t(ids, mlm, nsp, types))
    np.testing.assert_allclose(float(got.detach()), loss, **TOL)
    got.backward()
    params = dict(pm.named_parameters())
    assert set(params) == set(grads) == set(named)
    for n, g in grads.items():
        np.testing.assert_allclose(params[n].grad.numpy(), g, err_msg=n,
                                   **GRAD_TOL)
    # without NSP labels the loss is the MLM term alone
    want = float(_np(jm.loss(*_j(ids, mlm))))
    np.testing.assert_allclose(float(pm.loss(*_t(ids, mlm)).detach()),
                               want, **TOL)


def test_default_token_types_are_the_type_0_row(pair):
    """No ``token_type_ids`` adds row 0 of the type table: bitwise the
    network of explicit zeros, and JAX's default."""
    jm, _, pm, _, _ = pair
    ids = _batch()[0]
    zeros = np.zeros_like(ids)
    default, _ = pm(*_t(ids))
    explicit, _ = pm(*_t(ids, zeros))
    torch.testing.assert_close(default, explicit, rtol=0, atol=0)
    _assert_logits_close(default, _np(jm(*_j(ids))[0]))


def test_numpy_params_round_trip_bitwise(pair):
    _, named, pm, _, _ = pair
    back = pm.numpy_params()
    assert set(back) == set(named)
    for n, v in named.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)
    wrong_name = dict(named)
    wrong_name["bert.pooler.kernel"] = wrong_name.pop("bert.pooler.weight")
    with pytest.raises(ValueError, match="names differ"):
        BertForPretraining.from_numpy_params(wrong_name, bert_tiny(),
                                             device="cpu")
    wrong_shape = dict(named, **{"nsp_head.weight": np.zeros((2, 64),
                                                             np.float32)})
    with pytest.raises(ValueError, match="nsp_head.weight: shape"):
        BertForPretraining.from_numpy_params(wrong_shape, bert_tiny(),
                                             device="cpu")


def test_encoder_layers_start_equal():
    """The reference deep-copies layer 0 into layers 1..N-1, so the port
    starts every layer with layer 0's weights too."""
    pm = BertForPretraining(BertConfig(**dict(TINY, num_layers=3)), seed=2,
                            device="cpu")
    layers = pm.bert.encoder.layers
    first = dict(layers[0].named_parameters())
    for layer in layers[1:]:
        for n, p in layer.named_parameters():
            assert torch.equal(p, first[n]), n
    paddle.seed(2)
    jm = JaxBert(JaxConfig(**dict(TINY, num_layers=3)))
    jlayers = jm.bert.encoder.layers
    j0 = dict(jlayers[0].named_parameters())
    for n, p in jlayers[2].named_parameters():
        np.testing.assert_array_equal(_np(p), _np(j0[n]))


def test_scan_layers_matches_jax(pair):
    """``scan_layers=True`` builds and runs the encoder's layers through
    the scan's loop: the loss and every gradient hold to the JAX model
    (which runs the loop) as the plain port does."""
    jm, named, _, loss, grads = pair
    pm = BertForPretraining.from_numpy_params(
        named, bert_tiny(scan_layers=True), device="cpu")
    ids, mlm, nsp, types = _batch()
    got = pm.loss(*_t(ids, mlm, nsp, types))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n], err_msg=n,
                                   **GRAD_TOL)


@pytest.mark.parametrize("build", [
    lambda: BertForPretraining(bert_tiny()),
    lambda: BertForPretraining.from_numpy_params(
        BertForPretraining(bert_tiny(), device="cpu").numpy_params(),
        bert_tiny())], ids=["model", "from_numpy_params"])
def test_entry_points_default_to_the_card(build):
    """On the card unless asked for the CPU; without a card they raise
    rather than carry on on the CPU."""
    if torch.cuda.is_available():
        assert next(build().parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        build()


# ---------------------------- the train step ------------------------------

def _schedule(lr_module):
    """A warm-up step from 1e-4, then a polynomial decay from 1e-3: the
    three steps run at 1e-4, 1e-3 and 7.75e-4."""
    return lr_module.LinearWarmup(
        lr_module.PolynomialDecay(1e-3, decay_steps=4, end_lr=1e-4),
        warmup_steps=1, start_lr=1e-4, end_lr=1e-3)


def _noise_only(name, shape):
    """The key projection's bias: adding it shifts every logit of a query
    row alike, so its exact gradient is 0 and only rounding noise moves
    it."""
    return np.full(shape, name.endswith("self_attn.k_proj.bias"))


def _port_loss(m, *batch, generator):
    return m.loss(*batch, generator=generator)


def _jax_run(amp, n_batch):
    paddle.seed(7)
    model = JaxBert(jax_bert_tiny())
    named = {n: np.array(p._data) for n, p in model.named_parameters()}
    opt = paddle.optimizer.AdamW(learning_rate=_schedule(
        paddle.optimizer.lr), weight_decay=WD,
        parameters=model.parameters())
    tr = CompiledTrainStep(model, lambda m, *batch: m.loss(*batch), opt,
                           build_mesh({"data": 1}),
                           amp_dtype=jnp.bfloat16 if amp else None)
    batch = _batch(1)[:n_batch]
    losses = [float(np.asarray(tr.step(*batch)._data))
              for _ in range(STEPS)]
    return named, losses, {n: np.asarray(v) for n, v in tr.params.items()}


def _port_step(named, amp, seed=0, dropout=0.0):
    model = BertForPretraining.from_numpy_params(
        named, BertConfig(**dict(TINY, dropout=dropout)), device="cpu")
    sched = _schedule(plr)
    return TrainStep(model, _port_loss, AdamW(learning_rate=sched,
                                              weight_decay=WD),
                     amp_dtype=torch.bfloat16 if amp else None, seed=seed,
                     device="cpu"), sched


@pytest.mark.parametrize("amp,n_batch", [(None, 3), ("bf16", 3), (None, 2)],
                         ids=["fp32", "bf16", "fp32-mlm-only"])
def test_three_scheduled_adamw_steps_match_compiled_train_step(amp,
                                                               n_batch):
    """With NSP labels every parameter has a gradient; MLM only, the
    pooler and the NSP head are off the loss's path: JAX gives them a
    zero gradient, so AdamW still decays them and advances their state,
    and the port must do the same."""
    named, losses, final = _jax_run(amp, n_batch)
    tr, sched = _port_step(named, amp)
    batch = _t(*_batch(1)[:n_batch])
    rates = []
    got = []
    for _ in range(STEPS):
        rates.append(tr.optimizer.get_lr())
        got.append(float(tr.step(*batch)))
    np.testing.assert_allclose(rates, [1e-4, 1e-3, 7.75e-4], rtol=1e-12)
    assert sched.last_epoch == STEPS
    tol = TRAIN_TOLS[amp]
    np.testing.assert_allclose(got, losses, rtol=tol["loss"], atol=0)
    assert got[-1] < got[0]
    far, total = 0, 0
    for n, p in tr.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        diff = np.abs(p.detach().numpy() - final[n])
        # an Adam step moves a weight by at most about its rate
        assert diff.max() <= 2 * sum(rates), n
        # moved (weight decay alone included) exactly where JAX's moved
        assert (np.array_equal(p.detach().numpy(), named[n])
                == np.array_equal(final[n], named[n])), n
        live = diff[~_noise_only(n, diff.shape)]
        far += int((live > tol["param"]).sum())
        total += live.size
    assert far <= total * tol["share"], (far, total)


def test_bf16_amp_embedding_sum_is_bf16_until_layer_norm():
    """Under bf16 amp the rounded tables add word + position + type row
    in bf16 (the JAX order); the LayerNorm's f32 weight promotes, so the
    encoder and the MLM logits run in f32."""
    model = BertForPretraining(bert_tiny(), device="cpu")
    tr = TrainStep(model, _port_loss, AdamW(1e-3),
                   amp_dtype=torch.bfloat16, device="cpu")
    seen = {}
    emb = model.bert.embeddings
    hooks = [emb.layer_norm.register_forward_hook(
        lambda m, a, o: seen.update(ln_in=a[0].dtype, ln_out=o.dtype)),
        model.bert.encoder.register_forward_hook(
            lambda m, a, o: seen.update(encoder=o.dtype))]
    try:
        loss = tr.loss(*_t(*_batch()[:3]))
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"ln_in": torch.bfloat16, "ln_out": torch.float32,
                    "encoder": torch.float32}
    assert loss.dtype == torch.float32


def test_dropout_draws_from_the_step_seed():
    """dropout 0.1 (weight dropout included): one seed gives the same
    losses twice, another seed other losses."""
    named = BertForPretraining(bert_tiny(), device="cpu").numpy_params()
    batch = _t(*_batch()[:3])

    def losses(seed):
        tr, _ = _port_step(named, None, seed=seed, dropout=0.1)
        return [float(tr.step(*batch)) for _ in range(2)]

    a, b, c = losses(3), losses(3), losses(4)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]
