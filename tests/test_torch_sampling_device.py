"""Port parity: the device sampler and its counter-based stream.

`hash_uniform_device` (torch, int64 arithmetic masked to 32 bits) against
the JAX package's `hash_uniform` on numpy and on jnp: bit-exact, edge
seeds and counters included.  `sample_tokens_device` (torch) against the
JAX package's `sample_tokens_device` (jnp) and its host sampler
`sample_tokens_batch` (numpy), row for row and counter for counter, over
the JAX loop suite's sampling menu and 24 draws at its vocabulary of 48;
at a vocabulary of 2,000 and 50,304 against the port's own host
sampler (both port twins compute in float64 from the exponential on,
where JAX's float32 twins part on about 1% of rows at 50,304: see
`paddle_tpu_torch/generation/sampling.py`); and a stream that crosses
between the host and the device keeps one key sequence.  All exact:
tokens and counters are integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.generation import sampling as jsampling
from paddle_tpu_torch.generation import sampling as psampling

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)

# the JAX loop suite's menu (tests/test_looped_decode.py _SAMPLER_MENU)
MENU = [
    dict(),                                              # greedy
    dict(temperature=0.7, seed=11),
    dict(temperature=1.3, top_k=5, seed=12),
    dict(temperature=0.9, top_p=0.8, seed=13),
    dict(temperature=1.0, top_k=9, top_p=0.6, seed=14),
    dict(temperature=2.5, top_k=1, seed=15),             # k = 1
    dict(temperature=0.4, top_p=0.999, seed=16),
]


def _as_int32(a):
    return np.asarray(a, np.uint32).view(np.int32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hash_uniform_device_bit_exact_with_jax(dtype):
    """Every pair of edge seeds and counters (0, 1, 2**31 - 1, 2**31,
    2**32 - 1) and 512 random pairs: the torch twin equals the JAX
    package's numpy and jnp streams bit for bit, from int32 inputs
    holding uint32 values (as the loop carries them) or int64 ones."""
    rng = np.random.default_rng(7)
    seeds = np.concatenate([np.repeat(EDGES, EDGES.size),
                            rng.integers(0, 2**32, 512, dtype=np.uint32)])
    counters = np.concatenate([np.tile(EDGES, EDGES.size),
                               rng.integers(0, 2**32, 512,
                                            dtype=np.uint32)])
    host = jsampling.hash_uniform(seeds, counters)
    dev = np.asarray(jsampling.hash_uniform(
        jnp.asarray(_as_int32(seeds)), jnp.asarray(_as_int32(counters)),
        jnp))
    if dtype == torch.int32:
        ts, tc = (torch.from_numpy(_as_int32(a)) for a in (seeds, counters))
    else:
        ts, tc = (torch.from_numpy(a.astype(np.int64))
                  for a in (seeds, counters))
    ours = psampling.hash_uniform_device(ts, tc)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), host)
    np.testing.assert_array_equal(ours.numpy(), dev)
    np.testing.assert_array_equal(
        psampling.hash_uniform(seeds, counters), host)
    assert np.all((host >= 0.0) & (host < 1.0))


def _menu_arrays(params):
    return (np.array([p.temperature for p in params], np.float32),
            np.array([p.top_k or 0 for p in params], np.int32),
            np.array([1.0 if p.top_p is None else p.top_p for p in params],
                     np.float32),
            np.array([p.seed for p in params], np.int32))


def test_device_sampler_row_parity_menu():
    """The torch device sampler equals the JAX device sampler and the
    JAX host sampler, row for row, across the menu and 24 draws at the
    JAX suite's vocabulary: the same tokens and the same counters
    (stochastic rows consume one draw per call, greedy rows none)."""
    rng = np.random.default_rng(3)
    params = [jgen.SamplingParams(**spec) for spec in MENU]
    temps, top_ks, top_ps, seeds = _menu_arrays(params)
    host_rngs = [jsampling.SampleStream(p.seed) for p in params]
    jctr = np.zeros(len(params), np.int32)
    pctr = torch.zeros(len(params), dtype=torch.int32)
    for _ in range(24):
        logits = rng.standard_normal((len(params), 48)).astype(
            np.float32) * 3.0
        want = jsampling.sample_tokens_batch(logits, params, host_rngs)
        jtok, jctr = jsampling.sample_tokens_device(
            logits, temps, top_ks, top_ps, seeds, jctr)
        jctr = np.asarray(jctr)
        ptok, pctr = psampling.sample_tokens_device(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(top_ps),
            torch.from_numpy(seeds), pctr)
        assert ptok.dtype == torch.int32 and pctr.dtype == torch.int32
        assert ptok.tolist() == want
        assert ptok.tolist() == [int(t) for t in np.asarray(jtok)]
        assert pctr.tolist() == jctr.tolist()
        assert pctr.tolist() == [r.counter for r in host_rngs]
    assert host_rngs[0].counter == 0
    assert all(r.counter == 24 for r in host_rngs[1:])


@pytest.mark.parametrize("vocab,draws", [(2000, 48), (50304, 12)])
def test_device_sampler_equals_host_sampler_at_large_vocab(vocab, draws):
    """The port's two twins at a large vocabulary (GPT-2's padded 50,304
    among them), row for row over the menu, tokens and counters: here
    float32 reductions in another order would pick neighbouring tokens
    (see the module docstring of the port's sampler)."""
    rng = np.random.default_rng(4)
    params = [psampling.SamplingParams(**spec) for spec in MENU]
    temps, top_ks, top_ps, seeds = _menu_arrays(params)
    host_rngs = [psampling.SampleStream(p.seed) for p in params]
    ctr = torch.zeros(len(params), dtype=torch.int32)
    for _ in range(draws):
        logits = rng.standard_normal((len(params), vocab)).astype(
            np.float32) * 3.0
        want = psampling.sample_tokens_batch(logits, params, host_rngs)
        tok, ctr = psampling.sample_tokens_device(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(top_ps),
            torch.from_numpy(seeds), ctr)
        assert tok.tolist() == want
        assert ctr.tolist() == [r.counter for r in host_rngs]


def test_device_sampler_counter_wraps_like_jax():
    """A counter at 2**32 - 1 (int32 -1) wraps to 0 as the JAX device
    loop's int32 add does, and the draw it makes is the host stream's."""
    p = jgen.SamplingParams(temperature=0.8, seed=5)
    logits = np.random.default_rng(1).standard_normal((2, 32)).astype(
        np.float32)
    start = _as_int32([2**32 - 1, 2**31 - 1])
    jtok, jctr = jsampling.sample_tokens_device(
        logits, np.full(2, 0.8, np.float32), np.zeros(2, np.int32),
        np.ones(2, np.float32), np.full(2, 5, np.int32), start)
    ptok, pctr = psampling.sample_tokens_device(
        torch.from_numpy(logits), torch.full((2,), 0.8),
        torch.zeros(2, dtype=torch.int32), torch.ones(2),
        torch.full((2,), 5, dtype=torch.int32), torch.from_numpy(start))
    assert ptok.tolist() == [int(t) for t in np.asarray(jtok)]
    assert pctr.tolist() == np.asarray(jctr).tolist() == [0, -2**31]
    hosts = [jsampling.SampleStream(5, counter=int(c))
             for c in np.asarray(start).view(np.uint32)]
    assert ptok.tolist() == [jsampling.sample_token(row, p, r)
                             for row, r in zip(logits, hosts)]


def test_device_sampler_stream_crossing():
    """A stream sampled host -> device -> host keeps one key sequence:
    the device returns the advanced counter and the host continues it,
    identically to a pure-host run (the JAX suite's crossing test, on the
    port's two samplers)."""
    p = psampling.SamplingParams(temperature=0.8, top_k=12, seed=99)
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((1, 32)).astype(np.float32)
              for _ in range(9)]
    pure = psampling.SampleStream(99)
    want = [psampling.sample_tokens_batch(b, [p], [pure])[0] for b in blocks]
    mixed = psampling.SampleStream(99)
    got = []
    for i, b in enumerate(blocks):
        if i % 3 == 1:      # every third draw on the device sampler
            toks, ctr = psampling.sample_tokens_device(
                torch.from_numpy(b), torch.tensor([p.temperature]),
                torch.tensor([p.top_k], dtype=torch.int32),
                torch.tensor([1.0]),
                torch.tensor([p.seed], dtype=torch.int32),
                torch.tensor([mixed.counter], dtype=torch.int32))
            got.append(int(toks[0]))
            mixed.counter = int(ctr[0]) & 0xFFFFFFFF
        else:
            got.append(psampling.sample_tokens_batch(b, [p], [mixed])[0])
    assert got == want and mixed.counter == pure.counter == 9


def test_device_sampler_ties_follow_numpy():
    """Equal logits: greedy takes the first maximum (numpy's argmax), and
    top-p ranks equal probabilities by a STABLE order, so the nucleus is
    the host's."""
    logits = np.zeros((3, 16), np.float32)
    logits[:, 3] = logits[:, 9] = 1.0
    params = [jgen.SamplingParams(),
              jgen.SamplingParams(temperature=1.0, top_p=0.3, seed=2),
              jgen.SamplingParams(temperature=1.0, top_p=0.05, seed=4)]
    temps, top_ks, top_ps, seeds = _menu_arrays(params)
    rngs = [jsampling.SampleStream(p.seed) for p in params]
    want = jsampling.sample_tokens_batch(logits, params, rngs)
    ptok, _ = psampling.sample_tokens_device(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
        torch.from_numpy(seeds), torch.zeros(3, dtype=torch.int32))
    assert ptok.tolist() == want
    assert want[0] == 3 and want[2] == 3
