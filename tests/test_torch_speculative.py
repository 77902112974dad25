"""Port parity: speculative decoding through the ragged step.

The port's pieces against the JAX package's on the same inputs:
`verify_accept` (numpy and torch twins, exact), the prompt-lookup
proposer (exact proposals, the index equal to the rescan),
`PagedKVCache.truncate` (typed errors, LIFO reuse, int8 scale resets,
retained rows), `ragged_step_fn(spec_tokens=K)` (ints exact, the
augmented logits within 1e-5), and the engine with ``spec_mode="ngram"``
on the CPU against the JAX spec engine on its ragged step with the jnp
reference attention, token for token: greedy at chunk 0, 2 and 3 on
float32, bfloat16 and int8 pools in both layouts, a mixed batch with
stochastic rows, forced preemption, and stop sequences.  The JAX engine
runs are shared through a module fixture (each costs seconds of JAX
compiles).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.generation import metrics as jmetrics
from paddle_tpu.generation.speculation import NgramProposer as JProposer
from paddle_tpu.generation.speculation import verify_accept as jverify
from paddle_tpu.profiler.monitor import StatRegistry as JStatRegistry
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.generation.speculation import (NgramProposer,
                                                     verify_accept)
from paddle_tpu_torch.profiler.monitor import StatRegistry

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11]]
TOL = dict(atol=1e-5, rtol=1e-5)


def _reset_stats():
    """Zero both packages' generation stats: each run's snapshot is its
    own."""
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


def _run(pkg, model, prompts=PROMPTS, n=16, sampling=None, stops=None,
         **kw):
    """One engine of `pkg` serving `prompts` until idle: ([(tokens,
    finish reason)], stats snapshot, page utilization at the end)."""
    cfg = dict(max_decode_slots=4, num_pages=64, page_size=4,
               prefill_chunk_tokens=3)
    cfg.update(kw)
    if pkg is jgen:
        cfg.update(kv_backend="device", step_mode="ragged", use_kernel=False)
        if cfg.get("kv_dtype") == "bfloat16":
            cfg["kv_dtype"] = jnp.bfloat16
    else:
        cfg.update(device="cpu")
    _reset_stats()
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(**cfg),
                               start=False)
    hs = []
    for i, p in enumerate(prompts):
        spec = sampling(i) if sampling else None
        s = pkg.SamplingParams(**spec) if spec else pkg.SamplingParams()
        hs.append(eng.submit(p, max_new_tokens=n, sampling=s,
                             stop_tokens=stops(i) if stops else ()))
    eng.run_until_idle()
    out = [(h.result(timeout=5).token_ids, h.result(timeout=5)
            .finish_reason) for h in hs]
    snap = eng.metrics.snapshot()
    util = eng.cache.utilization()
    eng.shutdown()
    return out, snap, util


@pytest.fixture(scope="module")
def jax_runs(models):
    """Memoized JAX engine runs, keyed by their settings."""
    memo = {}

    def get(key, **kw):
        if key not in memo:
            memo[key] = _run(jgen, models[0], **kw)
        return memo[key]

    return get


def _tokens(out):
    return [t for t, _ in out]


# --------------------------- accept rule ----------------------------------


def _amax_window(amax, starts, k):
    t = len(amax)
    rows = np.clip(np.asarray(starts)[:, None] + np.arange(k + 1)[None, :],
                   0, t - 1)
    return np.asarray(amax)[rows]


@pytest.mark.parametrize("twin", ["numpy", "torch"])
def test_verify_accept_hand_built_rows(twin):
    """The JAX suite's hand-built accept cases, on both twins: a partial
    accept, a full accept (bonus from the last row), a non-leading match
    (never counted), a plain decode row and a len-0 descriptor."""
    def run(amax, tokens, starts, lens, k):
        args = (_amax_window(amax, starts, k), tokens, starts, lens)
        if twin == "torch":
            args = tuple(torch.as_tensor(np.asarray(a)) for a in args)
        acc, bonus = verify_accept(*args, k)
        return np.asarray(acc), np.asarray(bonus)

    tokens = np.array([10, 20, 30, 40, 5, 0, 0, 0], np.int32)
    starts = np.array([0, 4, 0], np.int32)
    lens = np.array([4, 1, 0], np.int32)
    amax = np.array([20, 30, 7, 9, 11, 0, 0, 0], np.int32)
    acc, bonus = run(amax, tokens, starts, lens, 3)
    assert acc.tolist() == [2, 0, 0]
    assert bonus[0] == amax[2] and bonus[1] == amax[4]
    amax2 = np.array([20, 30, 40, 9, 11, 0, 0, 0], np.int32)
    acc2, bonus2 = run(amax2, tokens, starts, lens, 3)
    assert acc2[0] == 3 and bonus2[0] == 9
    amax3 = np.array([99, 30, 40, 9, 11, 0, 0, 0], np.int32)
    acc3, _ = run(amax3, tokens, starts, lens, 3)
    assert acc3[0] == 0


def test_verify_accept_twins_equal_jax_fuzz():
    """Random windows, packed axes and descriptors — lens 0 and 1, draft
    rows, chunk descriptors longer than 1 + K, starts near the axis end —
    through the port's numpy and torch twins and the JAX package's numpy
    and jnp ones: all four give the same ints."""
    rng = np.random.default_rng(0)
    for trial in range(300):
        k = int(rng.integers(0, 5))
        s = int(rng.integers(1, 6))
        t = int(rng.integers(1, 24))
        amax = rng.integers(0, 3, (s, k + 1)).astype(np.int32)
        tokens = rng.integers(0, 3, t).astype(np.int32)
        starts = rng.integers(0, t, s).astype(np.int32)
        lens = rng.integers(0, k + 4, s).astype(np.int32)
        want = [np.asarray(a) for a in jverify(amax, tokens, starts, lens,
                                               k)]
        host = verify_accept(amax, tokens, starts, lens, k)
        dev = verify_accept(*(torch.from_numpy(a) for a in
                              (amax, tokens, starts, lens)), k)
        got_all = [host, [a.numpy() for a in dev]]
        if trial % 100 == 0:   # the jnp twin runs eagerly: a sample of it
            got_all.append([np.asarray(a) for a in jverify(
                jnp.asarray(amax), jnp.asarray(tokens), jnp.asarray(starts),
                jnp.asarray(lens), k, np_mod=jnp)])
        for got in got_all:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=str(trial))
        assert dev[0].dtype == torch.int32


# ----------------------------- proposer -----------------------------------


def test_ngram_proposer_prompt_lookup():
    """The JAX suite's proposer cases on the port's proposer."""
    p = NgramProposer(max_ngram=3, min_ngram=1)
    assert p.propose([5, 6, 9, 1, 5, 6], 3) == [9, 1, 5]
    assert p.propose([5, 6, 1, 5, 6, 2, 5, 6], 2) == [2, 5]
    assert p.propose([1, 5, 6, 7, 5, 6, 8, 1, 5, 6], 1) == [7]
    assert p.propose([4, 4, 4, 4, 4], 2) == [4]
    assert p.propose([1, 2, 3, 4, 5], 4) == []
    assert p.propose([1, 2], 0) == []
    with pytest.raises(ValueError, match="min_ngram"):
        NgramProposer(max_ngram=2, min_ngram=3)
    with pytest.raises(ValueError, match="max_lookback"):
        NgramProposer(max_ngram=3, max_lookback=3)


def test_ngram_proposals_equal_jax_and_rescan():
    """Over a fuzz of repetitive histories and proposer shapes: the
    port's proposals equal the JAX proposer's, its index equals its own
    rescan, and the persistent per-sequence index (propose_for, growing
    one token at a time, with a shrunken history rebuilding) equals the
    one-shot proposal; retain evicts."""
    rng = np.random.default_rng(11)
    for trial in range(40):
        shape = dict(max_ngram=int(rng.integers(1, 4)), min_ngram=1,
                     max_lookback=int(rng.integers(6, 40)))
        ours, theirs = NgramProposer(**shape), JProposer(**shape)
        hist = [int(t) for t in rng.integers(0, 5,
                                             size=rng.integers(2, 60))]
        if len(hist) > 8 and rng.random() < 0.7:
            hist = hist + hist[2:7]
        for k in (1, 3, 5):
            got = ours.propose(hist, k)
            assert got == theirs.propose(hist, k), (trial, k, hist)
            assert got == ours._propose_rescan(hist, k), (trial, k, hist)
        for n in range(1, len(hist) + 1):
            assert ours.propose_for("s", hist[:n], 4) == \
                theirs.propose(hist[:n], 4)
        short = hist[:3]
        assert ours.propose_for("s", short, 4) == ours.propose(short, 4)
        ours.retain(["other"])
        assert "s" not in ours._indexes


# ------------------------------ truncate -----------------------------------


def _caches(layout="token", dtype="float32"):
    """The port's DeviceKVPool (CPU) and the JAX package's host
    PagedKVCache, for bookkeeping side by side."""
    return (pgen.DeviceKVPool(2, 2, 8, num_pages=16, page_size=4,
                              dtype=pgen.engine._kv_dtype(dtype),
                              pool_layout=layout, device="cpu"),
            jgen.PagedKVCache(2, 2, 8, num_pages=16, page_size=4))


def test_truncate_typed_errors():
    for cache in (pgen.PagedKVCache(2, 2, 8, num_pages=16, page_size=4),
                  _caches()[0]):
        with pytest.raises(pgen.UnknownSequenceError):
            cache.truncate("nope", 0)
        cache.allocate("a")
        cache.reserve("a", 10)
        with pytest.raises(ValueError, match="only rewinds"):
            cache.truncate("a", 11)
        with pytest.raises(ValueError, match="only rewinds"):
            cache.truncate("a", -1)
        assert cache.truncate("a", 10) == 0          # no-op rewind
        assert cache.truncate("a", 5) == 1           # page 3 of 3 freed
        assert cache.seq_len("a") == 5
        assert len(cache.page_table("a")) == 2
        assert cache.truncate("a", 0) == 2
        assert cache.page_table("a") == ()
        cache.free("a")
        assert cache.num_free_pages == cache.num_pages
        with pytest.raises(pgen.UnknownSequenceError):
            cache.truncate("a", 0)


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_truncate_churn_matches_jax_bookkeeping(layout, dtype):
    """Reserve / truncate / free churn on the port's pool and the JAX
    package's cache: the same page tables, freed counts and free pages at
    every step (the freed pages return in LIFO order, so the next
    reservation takes them back in table order), and the pool drains
    to all-free."""
    ours, theirs = _caches(layout, dtype)
    ops = [("a", "reserve", 11), ("b", "reserve", 5), ("a", "truncate", 6),
           ("c", "reserve", 9), ("b", "truncate", 1), ("a", "reserve", 3),
           ("c", "truncate", 4), ("b", "reserve", 12), ("a", "truncate", 1),
           ("c", "reserve", 2)]
    for sid in ("a", "b", "c"):
        ours.allocate(sid)
        theirs.allocate(sid)
    for sid, op, n in ops:
        assert getattr(ours, op)(sid, n) == getattr(theirs, op)(sid, n)
        for s in ("a", "b", "c"):
            assert ours.page_table(s) == theirs.page_table(s), (sid, op, n)
        assert ours.num_free_pages == theirs.num_free_pages
    for sid in ("a", "b", "c"):
        ours.free(sid)
    assert ours.num_free_pages == ours.num_pages


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_truncate_resets_int8_scales_and_keeps_retained_rows(layout):
    """int8 pool: a truncate resets the dropped pages' scale rows (and
    only theirs); the retained positions read back bitwise; the rewound
    span rewrites like a never-written one, against a fresh pool given
    the same writes."""
    rng = np.random.default_rng(1)
    pool, _ = _caches(layout, "int8")
    pool.allocate("s")
    pool.allocate("t")
    k = torch.from_numpy(rng.standard_normal((1, 2, 12, 2, 8)).astype(
        np.float32))
    pool.reserve("s", 10)
    pool.reserve("t", 4)
    pool.write_prefill_batch(["s"], [0], [10], k[:, :, :10], -k[:, :, :10])
    pool.write_prefill_batch(["t"], [0], [4], k[:, :, :4], k[:, :, :4])
    pages = pool.page_table("s")
    assert np.all(pool.k_scale[:, list(pages)] > 0)
    before = pool.k_pool[:, list(pages[:2])].copy()
    assert pool.truncate("s", 6) == 1
    dropped = pages[2]
    ks, vs = pool.k_scale, pool.v_scale
    assert np.all(ks[:, dropped] == 0) and np.all(vs[:, dropped] == 0)
    assert np.all(ks[:, list(pages[:2])] > 0)
    assert np.all(ks[:, list(pool.page_table("t"))] > 0)
    np.testing.assert_array_equal(pool.k_pool[:, list(pages[:2])], before)
    # the rewound span rewrites: the same bytes as one fresh write of the
    # final content
    start = pool.reserve("s", 4)
    assert start == 6 and pool.page_table("s")[2] == dropped
    pool.write_prefill_batch(["s"], [6], [4], k[:, :, 8:12], -k[:, :, 8:12])
    fresh, _ = _caches(layout, "int8")
    fresh.allocate("s")
    fresh.reserve("s", 10)
    fresh.write_prefill_batch(["s"], [0], [6], k[:, :, :6], -k[:, :, :6])
    fresh.write_prefill_batch(["s"], [6], [4], k[:, :, 8:12],
                              -k[:, :, 8:12])
    got = pool.k_pool[:, list(pool.page_table("s"))]
    want = fresh.k_pool[:, list(fresh.page_table("s"))]
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    pool.free("s")
    pool.free("t")
    assert pool.num_free_pages == pool.num_pages


# ------------------------- the step function -------------------------------


def _spec_step(num_pages, page_size, drafts):
    """One packed step: descriptor 0 speculates (its token at position
    7, then len(drafts) drafts), descriptor 1 is a plain decode row at
    position 2, descriptor 2 a 3-row chunk at positions 3..5, then two
    inert slots; descriptor 3 is padding."""
    k = len(drafts)
    pt = np.array([[0, 1, 5], [2, 0, 0], [3, 4, 0], [0, 0, 0]], np.int32)
    lens = np.array([1 + k, 1, 3, 0], np.int32)
    pos0 = [7, 2, 3]
    starts = np.array([0, 1 + k, 2 + k, 0], np.int32)
    toks = [3] + list(drafts) + [17] + [40, 2, 9]
    positions = [7 + j for j in range(1 + k)] + [2] + [3, 4, 5]
    t = len(toks) + 2
    tokens = np.zeros(t, np.int32)
    tokens[:len(toks)] = toks
    pos = np.zeros(t, np.int32)
    pos[:len(toks)] = positions
    desc = np.repeat(np.arange(3), lens[:3])
    pages = np.full(t, num_pages, np.int32)
    pages[:len(toks)] = pt[desc, pos[:len(toks)] // page_size]
    rows = np.zeros(t, np.int32)
    rows[:len(toks)] = pos[:len(toks)] % page_size
    kv = np.array([pos0[0] + 1 + k, 3, 6, 0], np.int32)
    return dict(tokens=tokens, positions=pos, pages=pages, rows=rows,
                page_tables=pt, starts=starts, lens=lens, kv_lens=kv)


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_ragged_step_fn_spec_epilogue_matches_jax(models, layout):
    """``ragged_step_fn(spec_tokens=3)`` on the port and on JAX over one
    packed step, the drafts grown one verified token at a time (a
    rejected, a partly and a fully accepted window): ints [S, 3] exact,
    the augmented logits [S, V + 3] and the pools within 1e-5."""
    jm, pm = models
    rng = np.random.default_rng(5)
    p, ps, h, d, kk = 8, 4, 2, 8, 3
    shape = (h, p, ps, d) if layout == "kernel" else (p, ps, h, d)
    k0 = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    v0 = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    order = ("tokens", "positions", "pages", "rows", "page_tables",
             "starts", "lens", "kv_lens")
    jfn = jm.ragged_step_fn(ps, p, use_kernel=False, pool_layout=layout,
                            spec_tokens=kk)
    pfn = pm.ragged_step_fn(ps, p, pool_layout=layout, spec_tokens=kk)
    pad = [(0, 0)] * 4
    pad[1 if layout == "kernel" else 0] = (0, 1)
    drafts = [47, 47, 47]
    seen = set()
    for _ in range(kk + 1):
        step = _spec_step(p, ps, drafts)
        (jints, jaug), jk, jv = jfn(
            jm.decode_params(), *[jnp.asarray(step[k]) for k in order],
            [jnp.asarray(a) for a in k0], [jnp.asarray(a) for a in v0])
        (pints, paug), pk, pv = pfn(
            pm.decode_params(), *[torch.from_numpy(step[k]) for k in order],
            [torch.from_numpy(np.pad(a, pad)) for a in k0],
            [torch.from_numpy(np.pad(a, pad)) for a in v0])
        np.testing.assert_array_equal(pints.numpy(), np.asarray(jints))
        np.testing.assert_allclose(paug.numpy(), np.asarray(jaug), **TOL)
        for ours, theirs in zip(pk + pv, list(jk) + list(jv)):
            a = ours.numpy()
            a = a[:, :p] if layout == "kernel" else a[:p]
            np.testing.assert_allclose(a, np.asarray(theirs), **TOL)
        acc, bonus = int(pints[0, 1]), int(pints[0, 2])
        seen.add(acc)
        if acc == kk:
            break
        drafts[acc] = bonus      # the model's own token: verified next
    assert seen == {0, 1, 2, 3}


# ------------------------------ engines ------------------------------------


def _jax_spec_off(jax_runs, dtype, n):
    """The JAX spec-off engine's tokens at this storage dtype."""
    out, _, _ = jax_runs(("off", dtype, n), n=n, kv_dtype=dtype)
    return _tokens(out)


@pytest.mark.parametrize("chunk,dtype,layout", [
    (0, "float32", "token"), (2, "float32", "kernel"),
    (3, "bfloat16", "token"), (2, "int8", "token"),
    (3, "int8", "kernel")])
def test_spec_greedy_token_identical_to_jax(models, jax_runs, chunk, dtype,
                                            layout):
    """Greedy speculative decode on the port equals the JAX spec engine
    and the JAX spec-off engine token for token, with drafts accepted
    (and on int8 rewound), and the pool drained."""
    n = 14
    kw = dict(n=n, spec_mode="ngram", prefill_chunk_tokens=chunk,
              kv_dtype=dtype, pool_layout=layout)
    want, jsnap, _ = jax_runs(("spec", chunk, dtype, layout), **kw)
    got, snap, util = _run(pgen, models[1], **kw)
    assert got == want
    assert _tokens(got) == _jax_spec_off(jax_runs, dtype, n)
    assert snap[pmetrics.SPEC_ACCEPTED_TOKENS] \
        == jsnap[jmetrics.SPEC_ACCEPTED_TOKENS] > 0
    assert snap[pmetrics.SPEC_PROPOSED_TOKENS] \
        == jsnap[jmetrics.SPEC_PROPOSED_TOKENS]
    if dtype == "int8":
        assert snap[pmetrics.SPEC_REWIND_TOKENS] > 0
    assert util == 0.0


def test_spec_mixed_batch_stochastic_beside_speculating(models, jax_runs):
    """Seeded stochastic rows decode beside speculating greedy rows,
    host-sampled from the augmented logits: identical to the JAX spec
    engine and to the port's spec-off engine, at <= 1 sync per step."""
    def sampling(i):
        return (dict(temperature=0.9, top_k=10, top_p=0.9, seed=41 + i)
                if i % 2 else None)

    kw = dict(n=12, sampling=sampling, spec_mode="ngram")
    want, _, _ = jax_runs("mixed", **kw)
    got, snap, _ = _run(pgen, models[1], **kw)
    off, _, _ = _run(pgen, models[1], n=12, sampling=sampling)
    assert got == want == off
    assert snap[pmetrics.SPEC_ACCEPTED_TOKENS] > 0
    assert snap[pmetrics.DECODE_HOST_SYNCS_PER_STEP] <= 1


def test_spec_forced_preemption_mid_speculation(models, jax_runs):
    """A pool sized to thrash: sequences are preempted while the batch
    speculates and re-prefill; tokens and preemption counts equal the JAX
    spec engine's, and the pool drains despite the per-step truncates."""
    kw = dict(n=14, num_pages=9, prefill_chunk_tokens=2, spec_mode="ngram")
    want, jsnap, _ = jax_runs("preempt", **kw)
    got, snap, util = _run(pgen, models[1], **kw)
    assert got == want
    assert _tokens(got) == _jax_spec_off(jax_runs, "float32", 14)
    assert snap.get(pmetrics.PREEMPTED_TOTAL, 0) \
        == jsnap.get(jmetrics.PREEMPTED_TOTAL, 0) > 0
    assert snap[pmetrics.SPEC_ACCEPTED_TOKENS] > 0
    assert util == 0.0


def test_stop_sequences_spec_never_streams_past_stop(models, jax_runs):
    """Stop sequences completing inside an accepted run, and a stop
    token, clip the speculating stream exactly where the JAX spec engine
    and the plain engine clip it."""
    free = models[1].greedy_reference([1, 2, 3], 20)

    def sampling(i):
        return (dict(stop_sequences=[tuple(free[5:7])]) if i == 0 else
                dict(stop_sequences=[(3, 3, 3), (free[2],)]) if i == 1
                else None)

    def stops(i):
        return (free[8],) if i == 2 else ()

    prompts = [[1, 2, 3], [1, 2, 3], [1, 2, 3], [9, 9, 9, 4, 2]]
    kw = dict(prompts=prompts, n=20, sampling=sampling, stops=stops,
              spec_mode="ngram")
    want, _, _ = jax_runs("stops", **kw)
    got, _, util = _run(pgen, models[1], **kw)
    off, _, _ = _run(pgen, models[1], prompts=prompts, n=20,
                     sampling=sampling, stops=stops)
    assert got == want == off
    assert got[0] == (free[:6], "stop")
    assert got[1] == (free[:2], "stop")
    assert got[2] == (free[:8], "stop")
    assert util == 0.0


def test_spec_one_dispatch_le_one_sync_every_step(models):
    """Every speculative step is one step call with <= 1 host sync,
    whatever the accept outcome; the stream equals the oracle."""
    cfg = pgen.GenerationConfig(max_decode_slots=2, num_pages=64,
                                page_size=4, prefill_chunk_tokens=2,
                                spec_mode="ngram", device="cpu")
    eng = pgen.GenerationEngine(models[1], cfg, start=False)
    h = eng.submit([1] * 9, max_new_tokens=16)
    reg = StatRegistry.instance()
    disp = reg.get_stat(pmetrics.DECODE_DISPATCHES_PER_STEP)
    sync = reg.get_stat(pmetrics.DECODE_HOST_SYNCS_PER_STEP)
    while eng.scheduler.active() or eng.scheduler.pending_count():
        if eng.step():
            assert disp.get() == 1
            assert sync.get() <= 1
    assert h.result(timeout=5).token_ids == models[1].greedy_reference(
        [1] * 9, 16)
    assert eng.metrics.snapshot()[pmetrics.SPEC_ACCEPTANCE_RATE] > 0
    eng.shutdown()


def test_spec_retires_more_tokens_per_step_and_keeps_the_menu(models):
    """The same work in strictly fewer engine steps, the same tokens, and
    exactly the spec-off engine's signatures (one per pages bucket)."""
    def run(spec):
        eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
            max_decode_slots=4, num_pages=64, page_size=4,
            prefill_chunk_tokens=3, spec_mode=spec, device="cpu"),
            start=False)
        hs = [eng.submit(p, max_new_tokens=24) for p in PROMPTS]
        steps = eng.run_until_idle()
        out = [h.result(timeout=5).token_ids for h in hs]
        n, buckets = eng._ragged.compile_count, eng._ragged.cached_buckets()
        assert n == len(buckets)
        eng.shutdown()
        return out, steps, n

    spec_out, spec_steps, spec_n = run("ngram")
    off_out, off_steps, off_n = run(None)
    assert spec_out == off_out
    assert spec_steps < off_steps
    assert spec_n == off_n


def test_spec_budget_clips_drafts_and_pool_pressure_drops_them(models):
    """A tight step_token_budget clips drafts, never a decode or chunk
    row; a lone sequence with no page to spare drops its drafts instead
    of preempting or failing."""
    pm = models[1]
    out, snap, _ = _run(pgen, pm, n=12, step_token_budget=5,
                        spec_mode="ngram")
    assert _tokens(out) == [pm.greedy_reference(p, 12) for p in PROMPTS]
    assert snap[pmetrics.DECODE_DISPATCHES_PER_STEP] == 1
    one, snap1, _ = _run(pgen, pm, prompts=[PROMPTS[0]], n=12,
                         step_token_budget=5, spec_mode="ngram")
    assert _tokens(one) == [pm.greedy_reference(PROMPTS[0], 12)]
    assert snap1[pmetrics.SPEC_PROPOSED_TOKENS] > 0
    # prompt + 9 tokens need exactly the pool's 4 pages of 4: no slack
    tight, snap2, util = _run(pgen, pm, prompts=[[1, 2, 3]], n=9,
                              num_pages=4, prefill_chunk_tokens=0,
                              spec_mode="ngram")
    assert _tokens(tight) == [pm.greedy_reference([1, 2, 3], 9)]
    assert snap2.get(pmetrics.PREEMPTED_TOTAL, 0) == 0
    assert util == 0.0


def test_spec_metric_schema_matches_jax(models):
    """At build, before any step, the spec and loop stats the JAX engine
    stamps are in the port's snapshot under the same names; after a run
    the books balance (rewound == proposed - accepted)."""
    jeng = jgen.GenerationEngine(models[0], jgen.GenerationConfig(
        kv_backend="device", step_mode="ragged", spec_mode="ngram"),
        start=False)
    jkeys = {k for k in jeng.metrics.snapshot()
             if "spec_" in k or "loop" in k or "fetches" in k}
    jeng.shutdown()
    eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        spec_mode="ngram", num_pages=64, page_size=4, device="cpu"),
        start=False)
    snap = eng.metrics.snapshot()
    assert snap[pmetrics.SPEC_MODE] == "ngram"
    assert jkeys and jkeys <= set(snap)
    hs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS]
    eng.run_until_idle()
    for h in hs:
        h.result(timeout=5)
    snap = eng.metrics.snapshot()
    assert snap[pmetrics.SPEC_REWIND_TOKENS] == \
        snap[pmetrics.SPEC_PROPOSED_TOKENS] - \
        snap[pmetrics.SPEC_ACCEPTED_TOKENS]
    assert 0 < snap[pmetrics.SPEC_ACCEPTANCE_RATE] <= 1
    assert snap[pmetrics.SPEC_DRAFT_ROWS] > 0
    eng.shutdown()
    off = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        device="cpu"), start=False)
    assert off.metrics.snapshot()[pmetrics.SPEC_MODE] == "off"
    assert off._spec is None and off._ragged.spec_tokens == 0
    off.shutdown()


@pytest.mark.parametrize("kw", [
    dict(spec_mode="bogus"), dict(spec_mode="ngram", spec_tokens=0),
    dict(spec_mode="ngram", step_mode="legacy"),
    dict(loop_steps=0), dict(loop_steps=4, step_mode="legacy")],
    ids=["mode", "tokens", "spec_legacy", "loop_zero", "loop_legacy"])
def test_config_validation_raises_jax_errors(kw):
    """Bad speculation and loop settings raise the JAX package's
    ValueError, message for message."""
    with pytest.raises(ValueError) as jerr:
        jgen.GenerationConfig(**kw)
    with pytest.raises(ValueError) as perr:
        pgen.GenerationConfig(device="cpu", **kw)
    assert str(perr.value).split(";")[0].split("(")[0] \
        == str(jerr.value).split(";")[0].split("(")[0]


def test_spec_and_loop_resolve_to_the_ragged_step(models):
    """spec_mode and loop_steps > 1 build on the CPU (no longer refused),
    alone and together, and resolve an unset step mode to the ragged
    step even with a legacy decode named; spec_tokens defaults to 4."""
    for kw in (dict(spec_mode="ngram"), dict(loop_steps=4),
               dict(spec_mode="ngram", loop_steps=4, decode="fused")):
        eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
            device="cpu", **kw), start=False)
        assert eng.step_mode == "ragged"
        assert (eng._spec is not None) == ("spec_mode" in kw)
        assert eng._ragged.spec_tokens == (4 if "spec_mode" in kw else 0)
        assert (eng._loop is not None) == ("loop_steps" in kw)
        eng.shutdown()
