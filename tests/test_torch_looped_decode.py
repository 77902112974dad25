"""Port parity: the host-free decode loop.

`ragged_loop_fn` (N ragged decode steps in one call, on-device sampling,
stop matching and done masks) on the port against the JAX package's on
the same inputs: the ``[S, N+K+6]`` output exact and the pools (int8
scales too) within 1e-5.  Then the engine with ``loop_steps=4`` on the
CPU, token for token (ids AND finish reasons) against the port's own
``loop_steps=1`` engine and the JAX loop engine on its ragged step with
the jnp reference attention: greedy, seeded stochastic, stop tokens and
stop sequences, per-request ``max_new_tokens`` at the loop's edges,
speculation inside the loop, int8 pools, both layouts, forced
preemption and a late join; the loop's fetch and wasted-step accounting
equal to the JAX engine's; `prewarm`; and the single-step fall-back for
stop shapes past the loop's caps.  On the CPU the loop runs eagerly; on
the card it is a CUDA graph, held to the eager run bitwise by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` phase 7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.profiler.monitor import StatRegistry as JStatRegistry
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.profiler.monitor import StatRegistry

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11]]
REPEATS = [[5, 6, 9, 1, 5, 6], [4, 4, 4, 4, 4], [1, 2, 3, 1, 2, 3],
           [7, 7, 7, 2, 7, 7]]
TOL = dict(atol=1e-5, rtol=1e-5)
LOOP_STATS = (pmetrics.LOOP_EARLY_EXITS, pmetrics.LOOP_WASTED_STEPS,
              pmetrics.DECODE_HOST_FETCHES_PER_TOKEN,
              pmetrics.SPEC_PROPOSED_TOKENS, pmetrics.SPEC_ACCEPTED_TOKENS,
              pmetrics.TOKENS_TOTAL)


def _reset_stats():
    for reg in (StatRegistry.instance(), JStatRegistry.instance()):
        for name in list(reg.stats()):
            if name.startswith(pmetrics.PREFIX):
                reg.get_stat(name).reset()


@pytest.fixture(autouse=True)
def _fresh_stats():
    _reset_stats()
    yield


@pytest.fixture(scope="module")
def models():
    return jgen.TinyCausalLM(**MODEL), pgen.TinyCausalLM(**MODEL,
                                                         device="cpu")


def _run(pkg, model, loop_steps, prompts=PROMPTS, n=10, sampling=None,
         stops=None, **kw):
    """One engine of `pkg` until idle: ([(tokens, finish reason)], stats
    snapshot).  `n` is an int or a per-request function."""
    cfg = dict(max_decode_slots=4, num_pages=128, page_size=4,
               prefill_chunk_tokens=3, loop_steps=loop_steps)
    cfg.update(kw)
    if pkg is jgen:
        cfg.update(kv_backend="device", step_mode="ragged", use_kernel=False)
    else:
        cfg.update(device="cpu")
    _reset_stats()
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(**cfg),
                               start=False)
    hs = []
    for i, p in enumerate(prompts):
        spec = sampling(i) if sampling else None
        hs.append(eng.submit(
            p, max_new_tokens=n(i) if callable(n) else n,
            sampling=pkg.SamplingParams(**spec) if spec
            else pkg.SamplingParams(),
            stop_tokens=stops(i) if stops else ()))
    eng.run_until_idle()
    out = [(h.result(timeout=5).token_ids, h.result(timeout=5)
            .finish_reason) for h in hs]
    snap = eng.metrics.snapshot()
    assert eng.cache.utilization() == 0.0
    eng.shutdown()
    return out, snap


@pytest.fixture(scope="module")
def jax_runs(models):
    memo = {}

    def get(key, **kw):
        if key not in memo:
            memo[key] = _run(jgen, models[0], **kw)
        return memo[key]

    return get


# -------------------------- the loop function ------------------------------


def _loop_inputs(s, ms, ns, ls, kk):
    """One loop's inputs: a greedy row with a stop sequence (drafting 2
    tokens when kk allows), a stochastic row whose counter wraps past
    2**32, a greedy row with a stop token and a 1-token budget (1 draft),
    a dead row."""
    kd = max(kk, 1)
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 0], [7, 8, 9, 10],
                   [0, 0, 0, 0]], np.int32)
    stop_ids = np.full((s, ms), -1, np.int32)
    stop_ids[2, 0] = 7
    stop_seqs = np.full((s, ns, ls), -1, np.int32)
    stop_seqs[0, 0, ls - 2:] = [5, 6]
    stop_seq_lens = np.zeros((s, ns), np.int32)
    stop_seq_lens[0, 0] = 2
    tail = np.full((s, ls - 1), -1, np.int32)
    tail[0, -1] = 3
    drafts = np.zeros((s, kd), np.int32)
    if kk:
        drafts[0, :2] = [1, 2]
        drafts[2, 0] = 40
    return [np.array([3, 17, 40, 0], np.int32),           # cur_tok
            np.array([5, 3, 8, 0], np.int32),             # cur_pos
            np.array([1, 1, 1, 0], np.int32),             # live
            pt,
            np.array([0, 0.9, 0, 0], np.float32),         # temps
            np.array([0, 10, 0, 0], np.int32),            # top_ks
            np.array([1, 0.9, 1, 1], np.float32),         # top_ps
            np.array([0, 2**31 + 5, 0, 0], np.uint32).view(np.int32),
            np.array([0, 2**32 - 2, 0, 0], np.uint32).view(np.int32),
            np.array([5, 4, 1, 0], np.int32),             # remaining
            stop_ids, stop_seqs, stop_seq_lens, tail, drafts,
            np.array([min(kk, 2), 0, min(kk, 1), 0], np.int32)]


@pytest.mark.parametrize("layout,kv_dtype,spec_tokens", [
    ("token", "float32", 0), ("kernel", "float32", 2),
    ("token", "int8", 2), ("kernel", "int8", 0)])
def test_ragged_loop_fn_matches_jax(models, layout, kv_dtype, spec_tokens):
    """The loop function on the port and on JAX over the same pools and
    rows — greedy, stochastic (counter wrapping), drafts, a stop token,
    a stop sequence, a one-token budget, a dead row: the [S, N+K+6]
    output is exact, the pools (and int8 scales) within 1e-5."""
    jm, pm = models
    rng = np.random.default_rng(0)
    p, ps, h, d = 16, 4, 2, 8
    s, n_steps, ms, ns, ls = 4, 3, 3, 2, 3
    args = _loop_inputs(s, ms, ns, ls, spec_tokens)
    quant = kv_dtype == "int8"
    shape = (h, p, ps, d) if layout == "kernel" else (p, ps, h, d)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(4)]
        scales = [rng.uniform(0.5, 2, (p, h)).astype(np.float32)
                  for _ in range(4)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(4)]
        scales = []
    kw = dict(kv_quant=quant, spec_tokens=spec_tokens, loop_steps=n_steps,
              max_stop_ids=ms, max_stop_seqs=ns, max_stop_len=ls)
    jfn = jm.ragged_loop_fn(ps, p, use_kernel=False, pool_layout=layout,
                            **kw)
    pfn = pm.ragged_loop_fn(ps, p, pool_layout=layout, **kw)

    def groups(arrs, wrap):
        out = [[wrap(a) for a in arrs[:2]], [wrap(a) for a in arrs[2:]]]
        return out

    jstate = groups(pools, jnp.asarray) + (
        groups(scales, jnp.asarray) if quant else [])
    jres = jfn(jm.decode_params(), *[jnp.asarray(a) for a in args], *jstate)
    pad = [(0, 0)] * 4
    pad[1 if layout == "kernel" else 0] = (0, 1)   # the port's sink page
    pstate = groups(pools, lambda a: torch.from_numpy(np.pad(a, pad))) + (
        groups(scales, lambda a: torch.from_numpy(
            np.pad(a, [(0, 1), (0, 0)]))) if quant else [])
    pres = pfn(pm.decode_params(), *[torch.from_numpy(a) for a in args],
               *pstate)
    out = pres[0].numpy()
    assert pres[0].dtype == torch.int32
    assert out.shape == (s, n_steps + spec_tokens + 6)
    np.testing.assert_array_equal(out, np.asarray(jres[0]))
    assert out[3, n_steps + spec_tokens] == 0          # the dead row
    assert (out[:, -1] == out[0, -1]).all()
    for ours, theirs in zip(pres[1:], jres[1:]):
        for a, b in zip(ours, theirs):
            a = a.numpy()
            a = a[:, :p] if (a.ndim == 4 and layout == "kernel") else a[:p]
            np.testing.assert_allclose(a.astype(np.float32),
                                       np.asarray(b).astype(np.float32),
                                       **TOL)


# ----------------------------- the step owner ------------------------------


def test_loop_prewarm_and_compile_count(models):
    """`prewarm` touches a pages bucket without a call (True when new);
    traffic then adds no bucket; compile_count is the buckets touched."""
    eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        max_decode_slots=4, num_pages=128, page_size=4,
        prefill_chunk_tokens=3, loop_steps=4, device="cpu"), start=False)
    lp = eng._loop
    assert lp is not None and not lp.use_graph
    assert lp.prewarm(2) is True
    assert lp.prewarm(2) is False
    assert lp.prewarm(4) is True
    before = lp.compile_count
    assert lp.cached_buckets() == [2, 4]
    hs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    eng.run_until_idle()
    for h in hs:
        h.result(timeout=5)
    assert lp.compile_count == before
    assert lp.last_uploads == 1 and lp.last_dispatches == 1
    eng.shutdown()


# ------------------------------ engines -------------------------------------


def _mixed_sampling(i):
    return ([None, dict(temperature=0.9, top_k=10, top_p=0.9, seed=42),
             dict(stop_sequences=[(20, 45), (3, 3, 3)]),
             dict(temperature=1.1, seed=7)] * 2)[i]


MIXED_PROMPTS = PROMPTS + [[2, 4, 6, 8], [3, 1, 4, 1, 5], [6], [8, 8]]


def _mixed_n(i):
    return (12, 9, 12, 10, 1, 2, 4, 5)[i]


def _mixed_stops(i):
    return (44,) if i == 0 else ()


@pytest.mark.parametrize("kv_dtype,layout", [("float32", "token"),
                                             ("int8", "kernel")])
def test_loop_mixed_batch_identical_to_n1_and_jax(models, jax_runs,
                                                  kv_dtype, layout):
    """Greedy and seeded stochastic rows, a stop token, stop sequences,
    budgets of 1, 2, 4 and 5 tokens (below, at and across N = 4), four
    requests waiting for a slot (they join at loop boundaries): N = 4 on
    the port equals N = 1 on the port and N = 4 on JAX, ids and finish
    reasons; the loop's early exits, wasted steps and fetches per token
    equal the JAX engine's, fetches per token at most 1/N."""
    kw = dict(prompts=MIXED_PROMPTS, n=_mixed_n, sampling=_mixed_sampling,
              stops=_mixed_stops, kv_dtype=kv_dtype, pool_layout=layout)
    want, jsnap = jax_runs(("mixed", kv_dtype, layout), loop_steps=4, **kw)
    got, snap = _run(pgen, models[1], 4, **kw)
    one, snap1 = _run(pgen, models[1], 1, **kw)
    assert got == want
    assert got == one
    assert [len(t) for t, _ in got[4:]] == [1, 2, 4, 5]
    assert any(r == "stop" for _, r in got)
    for key in LOOP_STATS:
        assert snap[key] == jsnap[key], key
    assert snap[pmetrics.LOOP_STEPS] == 4
    assert 0 < snap[pmetrics.DECODE_HOST_FETCHES_PER_TOKEN] <= 1 / 4 + 0.05
    assert snap[pmetrics.LOOP_WASTED_STEPS] > 0
    assert snap[pmetrics.DECODE_DISPATCHES_PER_STEP] == 1
    assert snap[pmetrics.DECODE_HOST_SYNCS_PER_STEP] <= 1
    assert snap1[pmetrics.LOOP_STEPS] == 1
    assert snap1[pmetrics.DECODE_HOST_FETCHES_PER_TOKEN] == 0.0


@pytest.mark.parametrize("layout", ["kernel"])
def test_loop_speculation_identical(models, jax_runs, layout):
    """ngram drafts verified inside the loop (iteration 0): N = 4 with
    speculation equals JAX's, the port's N = 1 with speculation and the
    port's plain engine, with drafts accepted, and the same spec counts
    as the JAX engine."""
    kw = dict(prompts=REPEATS, spec_mode="ngram", spec_tokens=3,
              pool_layout=layout)
    want, jsnap = jax_runs(("spec", layout), loop_steps=4, **kw)
    got, snap = _run(pgen, models[1], 4, **kw)
    one, _ = _run(pgen, models[1], 1, **kw)
    plain, _ = _run(pgen, models[1], 1, prompts=REPEATS)
    assert got == want == one == plain
    for key in LOOP_STATS:
        assert snap[key] == jsnap[key], key
    assert snap[pmetrics.SPEC_ACCEPTED_TOKENS] > 0


def test_loop_preemption_identical(models, jax_runs):
    """A pool sized to thrash: the loop's reservation of its whole write
    horizon rolls back on a shortfall and the boundary takes the single
    step, which preempts; the streams equal JAX's loop engine and the
    port's N = 1, and the pool drains."""
    kw = dict(num_pages=9, prefill_chunk_tokens=2, n=12)
    want, jsnap = jax_runs("preempt", loop_steps=4, **kw)
    got, snap = _run(pgen, models[1], 4, **kw)
    one, _ = _run(pgen, models[1], 1, **kw)
    assert got == want
    assert [t for t, _ in got] == [t for t, _ in one]
    assert snap.get(pmetrics.PREEMPTED_TOTAL, 0) > 0
    assert snap.get(pmetrics.PREEMPTED_TOTAL, 0) \
        == jsnap.get(pmetrics.PREEMPTED_TOTAL, 0)


def test_loop_early_exit_and_wasted_steps(models):
    """A lone row stopping mid-loop ends the loop early (the remaining
    iterations run masked on the card, and are not counted in iters_run):
    an early exit is counted and the stream equals N = 1's."""
    base = models[1].greedy_reference(PROMPTS[0], 12)
    kw = dict(prompts=[PROMPTS[0]], n=12, stops=lambda i: (base[5],))
    got, snap = _run(pgen, models[1], 4, **kw)
    one, _ = _run(pgen, models[1], 1, **kw)
    assert got == one == [(base[:5], "stop")]
    assert snap[pmetrics.LOOP_EARLY_EXITS] >= 1


def test_loop_oversize_stops_fall_back(models):
    """Stop ids past the loop's cap (8) send the boundary down the single
    step: the same output as N = 1 and the oracle, and no loop call."""
    lots = tuple(range(100, 112))     # outside the vocab: none fires
    got, snap = _run(pgen, models[1], 4, prompts=[PROMPTS[0]], n=8,
                     stops=lambda i: lots)
    one, _ = _run(pgen, models[1], 1, prompts=[PROMPTS[0]], n=8,
                  stops=lambda i: lots)
    assert got == one
    assert got[0][0] == models[1].greedy_reference(PROMPTS[0], 8)
    assert snap[pmetrics.DECODE_HOST_FETCHES_PER_TOKEN] == 0.0


def test_loop_needs_a_model_with_ragged_loop_fn():
    class NoLoop:
        num_layers, num_heads, head_dim, vocab_size = 1, 1, 4, 8

        def ragged_step_fn(self, *a, **kw):
            raise NotImplementedError

        def decode_params(self, device=None):
            raise NotImplementedError

    with pytest.raises(ValueError, match="ragged_loop_fn"):
        pgen.GenerationEngine(NoLoop(), pgen.GenerationConfig(
            loop_steps=4, device="cpu"), start=False)
