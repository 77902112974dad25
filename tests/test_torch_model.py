"""Port parity: TinyCausalLM.

Weights are bitwise equal to the JAX model's for one seed (both draw
from one seeded numpy generator in the same order).  Forward values are
compared at atol = rtol = 1e-5: fp32 on both sides, but XLA and PyTorch
sum matmuls and softmaxes in different orders.  Argmax ids must be
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu_torch import generation as pgen

from gen_oracle import greedy_oracle  # noqa: E402 cross-module memo

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)


@pytest.fixture(scope="module")
def models():
    return jgen.TinyCausalLM(**CFG), pgen.TinyCausalLM(**CFG, device="cpu")


def _numpy_tree(jax_model):
    tree = jax_model.decode_params()
    return {
        "tok_emb": np.asarray(tree["tok_emb"]),
        "pos_emb": np.asarray(tree["pos_emb"]),
        "blocks": [{k: np.asarray(v) for k, v in b.items()}
                   for b in tree["blocks"]],
        "ln_f_s": np.asarray(tree["ln_f_s"]),
        "ln_f_b": np.asarray(tree["ln_f_b"]),
        "head": np.asarray(tree["head"]),
    }


def _assert_params_equal(port_params, tree):
    for key in ("tok_emb", "pos_emb", "ln_f_s", "ln_f_b", "head"):
        np.testing.assert_array_equal(port_params[key].numpy(), tree[key])
    assert len(port_params["blocks"]) == len(tree["blocks"])
    for pb, jb in zip(port_params["blocks"], tree["blocks"]):
        assert set(pb) == set(jb)
        for key in jb:
            np.testing.assert_array_equal(pb[key].numpy(), jb[key])


@pytest.mark.parametrize("cfg", [CFG, dict(vocab_size=50, num_layers=3,
                                           num_heads=4, head_dim=16,
                                           mlp_ratio=4, max_positions=64,
                                           seed=11)])
def test_seeded_weights_bitwise_equal_to_jax(cfg):
    tree = _numpy_tree(jgen.TinyCausalLM(**cfg))
    _assert_params_equal(
        pgen.TinyCausalLM(**cfg, device="cpu").decode_params(), tree)


def test_params_from_numpy_round_trips(models):
    jm, pm = models
    tree = _numpy_tree(jm)
    _assert_params_equal(pgen.params_from_numpy(tree, device="cpu"), tree)
    loaded = pgen.TinyCausalLM.from_numpy_params(tree, num_heads=2,
                                                 device="cpu")
    assert (loaded.num_layers, loaded.num_heads, loaded.head_dim,
            loaded.vocab_size) == (2, 2, 8, 48)
    _assert_params_equal(loaded.decode_params(), tree)
    # and back out of the port through numpy: the same bits
    again = pgen.params_from_numpy(
        {k: ([{bk: bv.numpy() for bk, bv in b.items()} for b in v]
             if k == "blocks" else v.numpy())
         for k, v in pm.decode_params().items()}, device="cpu")
    _assert_params_equal(again, tree)


def test_prefill_matches_jax(models):
    jm, pm = models
    tokens = [5, 9, 1, 33, 47, 0, 12]
    jl, jk, jv = jm.prefill(np.asarray(tokens, np.int32))
    pl, pk, pv = pm.prefill(tokens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    with pytest.raises(ValueError, match="max_positions"):
        pm.prefill(list(range(pm.max_positions + 1)))


def test_greedy_reference_token_identical_to_jax(models):
    jm, pm = models
    prompt = [9, 9, 9, 4, 2]
    assert pm.greedy_reference(prompt, 5) == greedy_oracle(jm, prompt, 5)


def _packed_step(num_pages, page_size):
    """One mixed step over a pool holding earlier tokens: decode rows of
    A (position 7) and B (position 2), then a 4-row chunk of C
    (positions 3..6), then 4 inert slots; descriptor 3 is padding."""
    pt = np.array([[0, 1], [2, 0], [3, 4], [0, 0]], np.int32)
    tokens = np.array([3, 17, 40, 2, 9, 11, 0, 0, 0, 0], np.int32)
    positions = np.array([7, 2, 3, 4, 5, 6, 0, 0, 0, 0], np.int32)
    desc_row = np.array([0, 1, 2, 2, 2, 2])
    pages = np.full(10, num_pages, np.int32)
    pages[:6] = pt[desc_row, positions[:6] // page_size]
    rows = np.zeros(10, np.int32)
    rows[:6] = positions[:6] % page_size
    return dict(tokens=tokens, positions=positions, pages=pages, rows=rows,
                page_tables=pt, starts=np.array([0, 1, 2, 0], np.int32),
                lens=np.array([1, 1, 4, 0], np.int32),
                kv_lens=np.array([8, 3, 7, 0], np.int32))


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_ragged_step_fn_matches_jax(models, layout):
    jm, pm = models
    rng = np.random.default_rng(5)
    p, ps, h, d = 8, 4, 2, 8
    step = _packed_step(p, ps)
    shape = (h, p, ps, d) if layout == "kernel" else (p, ps, h, d)
    k0 = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    v0 = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    order = ("tokens", "positions", "pages", "rows", "page_tables",
             "starts", "lens", "kv_lens")
    jfn = jm.ragged_step_fn(ps, p, use_kernel=False, pool_layout=layout)
    (jids, jlogits), jk, jv = jfn(
        jm.decode_params(), *[jnp.asarray(step[k]) for k in order],
        [jnp.asarray(a) for a in k0], [jnp.asarray(a) for a in v0])

    # the port's pools carry one more page: the sink
    pad = [(0, 0)] * 4
    pad[1 if layout == "kernel" else 0] = (0, 1)

    def port_pools(arrays):
        return [torch.from_numpy(np.pad(a, pad)) for a in arrays]

    pfn = pm.ragged_step_fn(ps, p, pool_layout=layout)
    (pids, plogits), pk, pv = pfn(
        pm.decode_params(), *[torch.from_numpy(step[k]) for k in order],
        port_pools(k0), port_pools(v0))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), **TOL)

    def real_pages(t):
        a = t.numpy()
        return a[:, :p] if layout == "kernel" else a[:p]

    for ours, theirs in zip(pk + pv, list(jk) + list(jv)):
        np.testing.assert_allclose(real_pages(ours), np.asarray(theirs),
                                   **TOL)
