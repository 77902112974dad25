"""Port parity: the generation engine end to end.

The port's engine on the CPU (``device="cpu"``: every attention call
takes the CUDA kernel's plain version) against the JAX engine on its
ragged step with device pools and the jnp reference attention
(``use_kernel=False``), on the same model weights and prompts.  The
contract is TOKEN identity — greedy and seeded stochastic, chunked,
preempted, stopped — not bitwise logits: the two frameworks sum in
different orders, and the tests here never compare bits across them.
"""
import math

import numpy as np
import pytest
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving.bucketing import ShapeBucketer

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11]]


@pytest.fixture(autouse=True)
def _fresh_port_stats():
    reg = StatRegistry.instance()
    for name in list(reg.stats()):
        if name.startswith(pmetrics.PREFIX):
            reg.get_stat(name).reset()
    yield


@pytest.fixture(scope="module")
def models():
    return jgen.TinyCausalLM(**MODEL), pgen.TinyCausalLM(**MODEL,
                                                         device="cpu")


def _sampling(pkg, spec):
    return pkg.SamplingParams(**spec) if spec else pkg.SamplingParams()


def _run(pkg, model, requests, *, slots=4, pages=64, page_size=4,
         chunk=3):
    """Serve `requests` ([(prompt, kwargs)], kwargs may hold a
    "sampling" dict of SamplingParams arguments) on one engine of `pkg`
    until idle; returns (results, engine) with the engine shut down."""
    cfg = dict(max_decode_slots=slots, num_pages=pages, page_size=page_size,
               prefill_chunk_tokens=chunk)
    if pkg is jgen:
        cfg.update(kv_backend="device", step_mode="ragged",
                   use_kernel=False)
    else:
        cfg.update(device="cpu")
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(**cfg),
                               start=False)
    handles = []
    for prompt, kw in requests:
        kw = dict(kw)
        kw["sampling"] = _sampling(pkg, kw.get("sampling"))
        handles.append(eng.submit(prompt, **kw))
    eng.run_until_idle()
    results = [h.result(timeout=5) for h in handles]
    eng.shutdown()
    return results, eng


def _both(models, requests, **kw):
    jres, _ = _run(jgen, models[0], requests, **kw)
    pres, peng = _run(pgen, models[1], requests, **kw)
    return jres, pres, peng


def _tokens(results):
    return [r.token_ids for r in results]


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_greedy_token_identical_to_jax(models, chunk):
    reqs = [(p, {"max_new_tokens": 12}) for p in PROMPTS]
    jres, pres, peng = _both(models, reqs, chunk=chunk)
    assert _tokens(pres) == _tokens(jres)
    assert all(len(r.token_ids) == 12 for r in pres)
    assert peng.cache.utilization() == 0.0


@pytest.mark.parametrize("greedy_mix", [False, True])
def test_seeded_stochastic_token_identical_to_jax(models, greedy_mix):
    """Temperature/top-k/top-p streams from the same seeds, alone and in
    a batch mixed with greedy rows (the step then fetches logits)."""
    reqs = []
    for i, p in enumerate(PROMPTS):
        spec = (None if greedy_mix and i % 2 else
                dict(temperature=0.9, top_k=10, top_p=0.9, seed=41 + i))
        reqs.append((p, {"max_new_tokens": 10, "sampling": spec}))
    jres, pres, _ = _both(models, reqs, chunk=2 if greedy_mix else 3)
    assert _tokens(pres) == _tokens(jres)


def test_forced_preemption_token_identical_to_jax(models):
    """A pool sized to thrash: victims (decoding and mid-chunk)
    re-prefill and every token still matches."""
    reqs = [(p, {"max_new_tokens": 12}) for p in PROMPTS]
    jres, pres, peng = _both(models, reqs, pages=9, chunk=2)
    assert _tokens(pres) == _tokens(jres)
    assert sum(r.preemptions for r in pres) > 0
    assert [r.preemptions for r in pres] == [r.preemptions for r in jres]
    assert peng.cache.utilization() == 0.0


def test_max_new_tokens_zero_and_stop_tokens(models):
    free, _ = _run(jgen, models[0], [([1, 2, 3], {"max_new_tokens": 8})],
                   chunk=2)
    stop = free[0].token_ids[2]
    reqs = [([1, 2], {"max_new_tokens": 0}),
            ([1, 2, 3], {"max_new_tokens": 8, "stop_tokens": (stop,)})]
    jres, pres, _ = _both(models, reqs, chunk=2)
    assert _tokens(pres) == _tokens(jres)
    assert pres[0].token_ids == [] and pres[0].finish_reason == "length"
    assert pres[1].finish_reason == "stop"
    assert pres[1].token_ids == free[0].token_ids[:2]


def test_one_dispatch_le_one_sync_per_step_zero_waste(models):
    """Every step is exactly 1 step call with <= 1 host sync (0 for a
    mid-prompt chunk-only step) and 8 packed uploads, and the ragged step
    dispatches no masked dummy rows."""
    cfg = pgen.GenerationConfig(max_decode_slots=2, num_pages=64,
                                page_size=4, prefill_chunk_tokens=2,
                                device="cpu")
    eng = pgen.GenerationEngine(models[1], cfg, start=False)
    h = eng.submit([1] * 9, max_new_tokens=4)       # 9 tokens / chunk 2
    h2 = None
    reg = StatRegistry.instance()
    disp = reg.get_stat(pmetrics.DECODE_DISPATCHES_PER_STEP)
    sync = reg.get_stat(pmetrics.DECODE_HOST_SYNCS_PER_STEP)
    uploads = reg.get_stat(pmetrics.STEP_HOST_UPLOADS)
    chunk_only_syncs = []
    while eng.scheduler.active() or eng.scheduler.pending_count():
        mid_prefill = bool(eng.scheduler.prefilling()) and \
            not eng.scheduler.decode_ready()
        if eng.step():
            assert disp.get() == 1
            assert sync.get() <= 1
            assert uploads.get() == 8
            if mid_prefill:
                chunk_only_syncs.append(sync.get())
        if h2 is None and not eng.scheduler.prefilling():
            # a second prompt joins the decoding one: combined steps
            h2 = eng.submit([3, 4, 5], max_new_tokens=5)
    assert chunk_only_syncs and all(s == 0 for s in chunk_only_syncs[:-1])
    assert len(h.result(timeout=5).token_ids) == 4
    assert len(h2.result(timeout=5).token_ids) == 5
    snap = eng.stats()
    assert snap["generation.padded_token_waste"] == 0
    assert 0 < snap["generation.step_row_utilization"] <= 1
    assert snap["generation.kernel_path"] == "ragged:torch-reference"
    eng.shutdown()


def test_compile_count_equals_pages_buckets_touched(models):
    """compile_count keeps its meaning: the distinct pages buckets the
    steps dispatched — whatever the batch size, chunk mix or sampling."""
    cfg = pgen.GenerationConfig(max_decode_slots=4, num_pages=64,
                                page_size=4, prefill_chunk_tokens=3,
                                device="cpu")
    eng = pgen.GenerationEngine(models[1], cfg, start=False)
    menu = ShapeBucketer(batch_buckets=(1,), length_buckets=(
        ShapeBucketer.geometric_menu(64, start=1)))
    touched = set()
    real_step = eng._ragged.step

    def spy(*args):
        touched.add(menu.length_bucket(max(np.shape(args[4])[1], 1)))
        return real_step(*args)

    eng._ragged.step = spy
    rng = np.random.default_rng(9)
    for n, plen, greedy in ((1, 7, True), (4, 7, False), (3, 7, True),
                            (1, 40, True)):
        hs = [eng.submit(rng.integers(1, 40, plen).tolist(),
                         max_new_tokens=6,
                         sampling=(pgen.SamplingParams() if greedy else
                                   pgen.SamplingParams(temperature=0.8,
                                                       seed=i)))
              for i in range(n)]
        eng.run_until_idle()
        for h in hs:
            assert len(h.result(timeout=5).token_ids) == 6
    assert eng._ragged.compile_count == len(touched)
    assert eng._ragged.cached_buckets() == sorted(touched)
    # 40 + 6 tokens at page_size 4 reach 12 pages: buckets 1 .. 16
    assert sorted(touched) == [1, 2, 4, 8, 16]
    assert eng.stats()["generation.decode_compiles_total"] == len(touched)
    assert max(touched) == 2 ** math.ceil(math.log2(math.ceil(46 / 4)))
    eng.shutdown()


def test_host_sampler_bit_exact_with_jax():
    """The counter-based stream and the nucleus sampler are the JAX
    host sampler's arithmetic: identical draws and identical tokens."""
    from paddle_tpu.generation import sampling as jsampling

    from paddle_tpu_torch.generation import sampling as psampling

    seeds = np.arange(0, 4000, 7, dtype=np.uint32) * np.uint32(2654435761)
    counters = np.arange(seeds.size, dtype=np.uint32) * np.uint32(977)
    np.testing.assert_array_equal(
        psampling.hash_uniform(seeds, counters),
        jsampling.hash_uniform(seeds, counters))
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 48)).astype(np.float32) * 3
    specs = [dict(), dict(temperature=0.7, seed=1),
             dict(temperature=1.3, top_k=5, seed=2),
             dict(temperature=0.9, top_p=0.8, seed=3), dict(),
             dict(temperature=1.0, top_k=12, top_p=0.95, seed=4)]
    for _ in range(3):   # consecutive draws of the same streams
        outs = []
        for pkg in (psampling, jsampling):
            params = [_sampling(pkg, s) for s in specs]
            streams = [pkg.SampleStream(p.seed, counter=5) for p in params]
            outs.append(pkg.sample_tokens_batch(logits, params, streams))
        assert outs[0] == outs[1]
        logits = np.roll(logits, 1, axis=1)
