"""Port parity: GPT (``paddle_tpu_torch.models.gpt``).

The JAX package's ``GPTForPretraining`` (vocab 512, hidden 64, 2 layers,
2 heads, L 64, dropout 0), its weights carried into the port, on the same
numpy token batch; attention through the composite path and through the
flash path (the JAX side runs its Pallas kernels in interpret mode, the
port its kernels' plain versions).  Logits and loss at atol = rtol = 1e-5
(fp32 on both sides, other summation orders); every parameter's gradient
(JAX eager ``loss.backward()``) at 1e-4 (sums over the 2 x 64 positions).
The functional ops GPT is built from are held to the JAX package's at
1e-5 in fp32 (bf16 inputs: equal dtypes, and the tolerance stated in
the test).
"""
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn import functional as PF

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)
B, L = 2, 64


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32))


@pytest.fixture(scope="module", params=[False, True],
                ids=["composite", "flash"])
def pair(request):
    """(JAX model, port model, JAX logits, loss and grads) per path."""
    paddle.seed(11)
    jm = JaxGPT(JaxConfig(use_flash=request.param, **CFG))
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    pm = pgpt.GPTForPretraining.from_numpy_params(
        named, pgpt.GPTConfig(use_flash=request.param, **CFG), device="cpu")
    ids, lbl = _batch()
    logits = np.asarray(jm(paddle.to_tensor(ids))._data)
    loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lbl))
    loss.backward()
    grads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    return jm, pm, named, logits, float(np.asarray(loss._data)), grads


def test_logits_and_loss_match_jax(pair):
    _, pm, _, logits, loss, _ = pair
    ids, lbl = _batch()
    t_ids, t_lbl = torch.from_numpy(ids), torch.from_numpy(lbl)
    got = pm(t_ids)
    assert got.shape == (B, L, CFG["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), logits, **TOL)
    np.testing.assert_allclose(float(pm.loss(t_ids, t_lbl).detach()), loss, **TOL)


def test_every_grad_matches_jax(pair):
    _, pm, named, _, _, grads = pair
    ids, lbl = _batch()
    pm.zero_grad(set_to_none=True)
    pm.loss(torch.from_numpy(ids), torch.from_numpy(lbl)).backward()
    got = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert set(got) == set(grads) == set(named)
    for n in grads:
        np.testing.assert_allclose(got[n], grads[n], err_msg=n, **GRAD_TOL)


def test_lm_head_is_tied_to_the_token_embedding(pair):
    """One parameter: the head reads wte, and its grad sums the lookup's
    and the head's uses."""
    _, pm, _, _, _, _ = pair
    names = [n for n, _ in pm.named_parameters()]
    assert "gpt.wte.weight" in names and not any("head" in n for n in names)
    ids, _ = _batch()
    h = pm.gpt(torch.from_numpy(ids))          # GPTModel: blocks + ln_f
    np.testing.assert_allclose(
        pm(torch.from_numpy(ids)).detach().numpy(),
        (h @ pm.gpt.wte.weight.t()).detach().numpy(), **TOL)


def test_numpy_params_round_trip_is_bitwise(pair):
    _, pm, named, _, _, _ = pair
    out = pm.numpy_params()
    assert set(out) == set(named)
    for n in named:
        assert out[n].dtype == named[n].dtype
        np.testing.assert_array_equal(out[n], named[n])
    again = pgpt.GPTForPretraining.from_numpy_params(
        out, pgpt.GPTConfig(**CFG), device="cpu").numpy_params()
    for n in named:
        np.testing.assert_array_equal(again[n], named[n])


def test_from_numpy_params_refuses_a_wrong_tree():
    model = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG), device="cpu")
    named = model.numpy_params()
    named.pop("gpt.ln_f.bias")
    with pytest.raises(ValueError, match="missing"):
        pgpt.GPTForPretraining.from_numpy_params(
            named, pgpt.GPTConfig(**CFG), device="cpu")
    named = model.numpy_params()
    named["gpt.wpe.weight"] = named["gpt.wpe.weight"][:3]
    with pytest.raises(ValueError, match="shape"):
        pgpt.GPTForPretraining.from_numpy_params(
            named, pgpt.GPTConfig(**CFG), device="cpu")


def test_seeded_init_follows_the_jax_distributions():
    """XavierNormal linears, Normal(0, 0.02) vocab table, Normal(0, 1)
    positions, zero biases, unit LayerNorm weights; one seed gives one
    model."""
    cfg = pgpt.GPTConfig(vocab_size=2048, hidden_size=128, num_layers=1,
                         num_heads=2, max_seq_len=256)
    a = pgpt.GPTForPretraining(cfg, seed=5, device="cpu").numpy_params()
    b = pgpt.GPTForPretraining(cfg, seed=5, device="cpu").numpy_params()
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])
    std = {"gpt.wte.weight": 0.02, "gpt.wpe.weight": 1.0,
           "gpt.blocks.0.attn.qkv.weight": np.sqrt(2 / (128 + 384)),
           "gpt.blocks.0.mlp.fc_out.weight": np.sqrt(2 / (512 + 128))}
    for n, s in std.items():
        assert abs(a[n].std() / s - 1) < 0.05, n
    assert not a["gpt.blocks.0.attn.qkv.bias"].any()
    assert (a["gpt.blocks.0.ln1.weight"] == 1).all()


def _both(*arrays):
    return ([paddle.to_tensor(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


@pytest.mark.parametrize("x_dtype", [np.float32, "bf16"])
def test_functional_ops_match_jax(x_dtype):
    """linear (weight [in, out]; f32 x and bf16 weight promote to f32),
    layer_norm (a bf16 input promotes at its f32 weight), exact gelu,
    embedding and softmax_with_cross_entropy (labels [..., 1], -100
    ignored) against the JAX package's functional ops."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    g = (1 + rng.standard_normal(8)).astype(np.float32)
    # bf16: x - mean is rounded at the inputs' ulp (2^-7 at |x| ~ 2) in
    # both frameworks, at other points, then scaled by |g| up to ~3
    tol = TOL if x_dtype == np.float32 else dict(atol=5e-2, rtol=2e-2)
    (jx, jw, jb, jg), (tx, tw, tb, tg) = _both(x, w, b, g)
    if x_dtype == "bf16":
        jw, tw = jw.astype("bfloat16"), tw.to(torch.bfloat16)
        jxn, txn = jx.astype("bfloat16"), tx.to(torch.bfloat16)
    else:
        jxn, txn = jx, tx
    cases = [(JF.linear(jx, jw, jb), PF.linear(tx, tw, tb)),
             (JF.layer_norm(jxn, [8], jg, jx[0, 0]),
              PF.layer_norm(txn, tg, tx[0, 0])),
             (JF.gelu(jxn), PF.gelu(txn))]
    for jout, tout in cases:
        assert str(tout.dtype).split(".")[-1] == str(jout._data.dtype)
        np.testing.assert_allclose(tout.float().numpy(),
                                   np.asarray(jout._data, np.float32), **tol)
    ids = rng.integers(0, 6, (2, 5))
    np.testing.assert_array_equal(
        PF.embedding(torch.from_numpy(ids), tw).float().numpy(),
        np.asarray(JF.embedding(paddle.to_tensor(ids), jw)._data,
                   np.float32))
    lbl = rng.integers(0, 8, (2, 5, 1))
    lbl[0, 0] = -100
    want = np.asarray(paddle.nn.functional.softmax_with_cross_entropy(
        jx, paddle.to_tensor(lbl))._data)
    got = PF.softmax_with_cross_entropy(tx, torch.from_numpy(lbl)).numpy()
    assert got.shape == want.shape == (2, 5, 1) and got[0, 0, 0] == 0
    np.testing.assert_allclose(got, want, **TOL)


def test_dropout_is_upscale_in_train_from_its_generator():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    y = PF.dropout(x, 0.25, generator=gen)
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert PF.dropout(x, 0.25, training=False) is x
    assert PF.dropout(x, 0.0, generator=gen) is x
    with pytest.raises(ValueError, match="torch.Generator"):
        PF.dropout(x, 0.25)
