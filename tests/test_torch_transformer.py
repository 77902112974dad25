"""Port parity: the transformer layers (``paddle_tpu_torch.nn.transformer``)
against the JAX package's ``paddle_tpu.nn`` layers in eager mode.

Weights are carried from the JAX layer into the port by name (the JAX
``named_parameters()`` names are the port's ``state_dict`` keys); the
inputs are numpy draws from a seed.  Outputs and attention weights at
atol = rtol = 1e-5 (fp32 on both sides, other summation orders): the
encoder-decoder ``Transformer`` in both ``normalize_before`` modes with
a causal target mask and a padding source mask, the decoder run token by
token through its ``Cache`` / ``StaticCache``, the encoder's cache, and
multi-head attention under additive, bool and integer masks.
"""
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn

TOL = dict(atol=1e-5, rtol=1e-5)
D, HEADS, FF = 32, 4, 64
B, LS, LT = 2, 7, 5


def _np(t):
    return np.asarray(t._data)


def _carry(jax_layer, port_layer):
    """Load the JAX layer's weights into the port layer, strictly by
    name."""
    state = {n: torch.from_numpy(np.array(p._data))
             for n, p in jax_layer.named_parameters()}
    port_layer.load_state_dict(state, strict=True)
    return port_layer


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, LS, D)).astype(np.float32)
    tgt = rng.standard_normal((B, LT, D)).astype(np.float32)
    keep = np.ones((B, 1, 1, LS), bool)
    keep[1, ..., LS - 2:] = False            # row 1: its last 2 are padding
    return src, tgt, keep


@pytest.fixture(scope="module", params=[False, True],
                ids=["post_norm", "pre_norm"])
def transformer(request):
    paddle.seed(5)
    jm = jnn.Transformer(d_model=D, nhead=HEADS, num_encoder_layers=2,
                         num_decoder_layers=2, dim_feedforward=FF,
                         dropout=0.0, normalize_before=request.param)
    pm = _carry(jm, pnn.Transformer(
        d_model=D, nhead=HEADS, num_encoder_layers=2, num_decoder_layers=2,
        dim_feedforward=FF, dropout=0.0, normalize_before=request.param,
        generator=_gen()))
    return jm, pm


def test_transformer_forward_matches_jax(transformer):
    jm, pm = transformer
    src, tgt, keep = _inputs()
    jmask = jm.generate_square_subsequent_mask(LT)
    pmask = pm.generate_square_subsequent_mask(LT)
    np.testing.assert_array_equal(pmask.numpy(), _np(jmask))
    want = jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
              src_mask=paddle.to_tensor(keep), tgt_mask=jmask,
              memory_mask=paddle.to_tensor(keep))
    got = pm(torch.from_numpy(src), torch.from_numpy(tgt),
             src_mask=torch.from_numpy(keep), tgt_mask=pmask,
             memory_mask=torch.from_numpy(keep))
    assert got.shape == (B, LT, D)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_decoder_token_by_token_through_its_caches_matches_jax(
        transformer):
    """Each step's output against JAX's, and the last against the port's
    own full causal run: the Cache grows by one key a step, the
    StaticCache holds the projected memory."""
    jm, pm = transformer
    src, tgt, keep = _inputs(1)
    jmem = jm.encoder(paddle.to_tensor(src))
    pmem = pm.encoder(torch.from_numpy(src))
    np.testing.assert_allclose(pmem.detach().numpy(), _np(jmem), **TOL)
    jcache, pcache = jm.decoder.gen_cache(jmem), pm.decoder.gen_cache(pmem)
    assert isinstance(pcache[0][0], pnn.MultiHeadAttention.Cache)
    assert isinstance(pcache[0][1], pnn.MultiHeadAttention.StaticCache)
    steps = []
    for t in range(LT):
        jo, jcache = jm.decoder(paddle.to_tensor(tgt[:, t:t + 1]), jmem,
                                None, paddle.to_tensor(keep), jcache)
        po, pcache = pm.decoder(torch.from_numpy(tgt[:, t:t + 1]), pmem,
                                None, torch.from_numpy(keep), pcache)
        np.testing.assert_allclose(po.detach().numpy(), _np(jo), **TOL)
        assert pcache[0][0].k.shape == (B, HEADS, t + 1, D // HEADS)
        steps.append(po)
    full = pm.decoder(torch.from_numpy(tgt), pmem,
                      pm.generate_square_subsequent_mask(LT),
                      torch.from_numpy(keep))
    np.testing.assert_allclose(torch.cat(steps, 1).detach().numpy(),
                               full.detach().numpy(), **TOL)


def test_encoder_cache_matches_jax():
    paddle.seed(6)
    jl = jnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0)
    jenc = jnn.TransformerEncoder(jl, 2)
    penc = _carry(jenc, pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                    generator=_gen()), 2))
    src, _, _ = _inputs(2)
    jx, px = paddle.to_tensor(src), torch.from_numpy(src)
    jo, jc = jenc(jx, None, jenc.gen_cache(jx))
    po, pc = penc(px, None, penc.gen_cache(px))
    np.testing.assert_allclose(po.detach().numpy(), _np(jo), **TOL)
    for (jk, jv), (pk, pv) in zip(jc, pc):
        np.testing.assert_allclose(pk.detach().numpy(), _np(jk), **TOL)
        np.testing.assert_allclose(pv.detach().numpy(), _np(jv), **TOL)


def _mask(kind, rng):
    keep = rng.random((B, 1, LT, LS)) > 0.3
    keep[..., 0] = True                      # no row fully masked
    if kind == "bool":
        return keep
    if kind == "int":
        return keep.astype(np.int32)
    return np.where(keep, 0.0, -1e4).astype(np.float32)


@pytest.mark.parametrize("kind", ["additive", "bool", "int"])
def test_attention_masks_and_weights_match_jax(kind):
    """Cross attention with weights asked for and a growing Cache: out,
    weights and the cache's keys against JAX; a bool mask and its int
    form give the same output as the additive 0 / -1e9 mask."""
    paddle.seed(7)
    jm = jnn.MultiHeadAttention(D, HEADS, need_weights=True)
    pm = _carry(jm, pnn.MultiHeadAttention(D, HEADS, need_weights=True,
                                           generator=_gen()))
    rng = np.random.default_rng(3)
    src, tgt, _ = _inputs(3)
    mask = _mask(kind, rng)
    jout, jw, jcache = jm(paddle.to_tensor(tgt), paddle.to_tensor(src),
                          paddle.to_tensor(src), paddle.to_tensor(mask),
                          jm.gen_cache(paddle.to_tensor(src)))
    pout, pw, pcache = pm(torch.from_numpy(tgt), torch.from_numpy(src),
                          torch.from_numpy(src), torch.from_numpy(mask),
                          pm.gen_cache(torch.from_numpy(src)))
    np.testing.assert_allclose(pout.detach().numpy(), _np(jout), **TOL)
    np.testing.assert_allclose(pw.detach().numpy(), _np(jw), **TOL)
    np.testing.assert_allclose(pcache.k.detach().numpy(), _np(jcache.k),
                               **TOL)
    if kind != "additive":
        keep = _mask("bool", np.random.default_rng(3))
        additive = torch.from_numpy(
            np.where(keep, 0.0, -1e9).astype(np.float32))
        pm.need_weights = False
        plain = pm(torch.from_numpy(tgt), torch.from_numpy(src),
                   torch.from_numpy(src), additive)
        np.testing.assert_allclose(pout.detach().numpy(),
                                   plain.detach().numpy(), rtol=0, atol=0)


def test_scan_layers_matches_jax():
    """``TransformerEncoder(scan_layers=True)`` against the JAX encoder's
    ``lax.scan`` (3 layers, a padding mask, a final norm) within 1e-5,
    and against the port's own loop bitwise, at dropout 0.1 from one
    generator seed (the scan's loop draws as the loop does)."""
    paddle.seed(6)
    jl = jnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0)
    jenc = jnn.TransformerEncoder(jl, 3, norm=jnn.LayerNorm(D),
                                  scan_layers=True)
    src, _, keep = _inputs()
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    want = _np(jenc(paddle.to_tensor(src), paddle.to_tensor(mask)))
    encs = []
    for scan in (True, False):
        pl = pnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                         generator=_gen())
        encs.append(_carry(jenc, pnn.TransformerEncoder(
            pl, 3, norm=pnn.LayerNorm(D), scan_layers=scan)))
    got = encs[0](torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for enc in encs:
        for m in enc.modules():
            if isinstance(m, pnn.Dropout):
                m.p = 0.1
            if isinstance(m, pnn.MultiHeadAttention):
                m.dropout = 0.1
    a, b = (enc(torch.from_numpy(src), torch.from_numpy(mask),
                generator=_gen(3)) for enc in encs)
    assert torch.equal(a, b)


def test_stacked_layers_start_equal():
    """Layers 1..N-1 are deep copies of the layer given, as in the
    reference: equal values, separate parameters."""
    enc = pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(D, HEADS, FF, generator=_gen()), 3)
    first = dict(enc.layers[0].named_parameters())
    for layer in enc.layers[1:]:
        for n, p in layer.named_parameters():
            assert torch.equal(p, first[n]) and p is not first[n]


def test_dropout_draws_from_the_generator_passed_down():
    """Attention-weight and activation dropout 0.1 in training: one seed
    gives one output twice, another seed another; without a generator it
    raises."""
    layer = pnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.1,
                                        generator=_gen())
    x = torch.from_numpy(_inputs()[0])
    a, b, c = (layer(x, generator=_gen(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        layer(x)
    layer.eval()
    torch.testing.assert_close(layer(x), layer(x), rtol=0, atol=0)
