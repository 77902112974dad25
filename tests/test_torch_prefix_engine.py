"""Port parity: prefix caching through the serving engine.

The port's warm engine (``prefix_cache=True``) on the CPU against the
JAX package's warm engine (device pools, the jnp reference attention) on
the same weights and traffic, token for token, with the prefix counters
equal (hit tokens, pages registered, COW copies, evictions, prefill
tokens, preemptions, the peak of shared pages), and against the port's
own cold engine (``prefix_cache=False``) token for token.  Traffic is
sequential waves over one system prompt, so later requests see the
cache.  The cases follow the JAX package's prefix-cache engine tests
without a mesh: the ragged step, the legacy chunked step, and the
one-shot modes (a warm suffix through the eager chunk path); bfloat16
pools in both layouts, int8 pools; forced preemption, eviction before
preemption, admission waiting for pages, first-admission hit counting,
the decode-tail index and a two-turn conversation; speculation and the
host-free loop over a warm cache; the page service between engines; and
`TinyCausalLM.prefill_chunk` against the JAX model's at 2e-5.  The JAX
runs are memoized per module (each costs seconds of compiles).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.generation import decode_attention as jdec
from paddle_tpu.profiler.monitor import StatRegistry as JStatRegistry
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pm
from paddle_tpu_torch.profiler.monitor import StatRegistry

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 3 full pages at PS=4
PROMPTS = [SYSTEM + [7, 7], SYSTEM + [1], SYSTEM + [9, 9, 9], SYSTEM]
# the seeding wave, then every prompt in a wave of its own
SEQUENTIAL = [[PROMPTS[0]]] + [[p] for p in PROMPTS]
COUNTERS = (pm.PREFIX_CACHE_HIT_TOKENS, pm.PREFIX_PAGES_REGISTERED,
            pm.COW_COPIES, pm.PREFIX_EVICTIONS, pm.PREFILL_TOKENS_TOTAL,
            pm.PREEMPTED_TOTAL, pm.PREFIX_CACHE_HIT_RATE,
            pm.PREFILL_CHUNKS_TOTAL)


@pytest.fixture(scope="module")
def models():
    jax_model = jgen.TinyCausalLM(**MODEL)
    params = jax_model.decode_params()
    port = pgen.TinyCausalLM.from_numpy_params(
        {k: (np.asarray(v) if k != "blocks" else
             [{n: np.asarray(a) for n, a in b.items()} for b in v])
         for k, v in params.items()},
        num_heads=MODEL["num_heads"], seed=MODEL["seed"], device="cpu")
    return jax_model, port


def _config(pkg, cfg):
    cfg = dict(dict(max_decode_slots=4, num_pages=64, page_size=4,
                    prefill_chunk_tokens=3), **cfg)
    if pkg is jgen:
        cfg.update(kv_backend="device", use_kernel=False)
        if cfg.get("step_mode") == "legacy":
            cfg["jit_prefill"] = bool(cfg["prefill_chunk_tokens"])
        else:
            cfg["step_mode"] = "ragged"
        if cfg.get("kv_dtype") == "bfloat16":
            cfg["kv_dtype"] = jnp.bfloat16
    else:
        cfg["device"] = "cpu"
    return pkg.GenerationConfig(**cfg)


def _serve(pkg, model, waves=SEQUENTIAL, n=8, seeds=None, engine=None,
           **cfg):
    """Serve `waves` (lists of prompts; each wave submitted together and
    stepped until idle) on one engine of `pkg` with its own stat
    registry.  Returns the streams, each request's prefix hit tokens and
    preemptions, the counters, the peak of shared pages over the steps,
    and the engine (shut down unless `engine` is "keep")."""
    reg = JStatRegistry() if pkg is jgen else StatRegistry()
    eng = pkg.GenerationEngine(model, _config(pkg, cfg),
                               metrics=pkg.GenerationMetrics(registry=reg),
                               start=False)
    handles, peak, i = [], 0, 0
    for wave in waves:
        for p in wave:
            s = (pkg.SamplingParams(temperature=0.9, top_k=10, top_p=0.9,
                                    seed=seeds[i])
                 if seeds is not None and seeds[i] is not None
                 else pkg.SamplingParams())
            handles.append(eng.submit(p, max_new_tokens=n, sampling=s))
            i += 1
        while eng.scheduler.active() or eng.scheduler.pending_count():
            eng.step()
            peak = max(peak, eng.cache.shared_pages)
    results = [h.result(timeout=5) for h in handles]
    snap = reg.stats()
    out = dict(tokens=[r.token_ids for r in results],
               hits=[h.prefix_hit_tokens for h in handles],
               preemptions=[r.preemptions for r in results],
               counters={c: snap.get(c, 0) for c in COUNTERS},
               peak_shared=peak, engine=eng)
    if engine != "keep":
        eng.shutdown()
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    memo = {}

    def get(key, **kw):
        if key not in memo:
            memo[key] = _serve(jgen, models[0], **kw)
        return memo[key]

    return get


def _held(models, jax_runs, key, **kw):
    """The port's warm run held to the JAX warm run (tokens, hits,
    preemptions, counters, peak shared pages) and to the port's cold run
    (tokens).  Returns the port's warm run."""
    warm = _serve(pgen, models[1], prefix_cache=True, **kw)
    theirs = jax_runs(key, prefix_cache=True, **kw)
    cold = _serve(pgen, models[1], prefix_cache=False, **kw)
    assert warm["tokens"] == theirs["tokens"]
    assert warm["tokens"] == cold["tokens"]
    assert warm["hits"] == theirs["hits"]
    assert warm["preemptions"] == theirs["preemptions"]
    assert warm["counters"] == theirs["counters"]
    assert warm["peak_shared"] == theirs["peak_shared"]
    assert cold["counters"][pm.PREFIX_CACHE_HIT_TOKENS] == 0
    return warm


def _oracle(model, prompt, n=8):
    return model.greedy_reference(prompt, n)


@pytest.mark.parametrize("kw", [
    dict(), dict(step_mode="legacy"),
    dict(step_mode="legacy", decode="eager"),
    dict(step_mode="legacy", decode="eager", prefill_chunk_tokens=0),
    dict(step_mode="legacy", prefill_chunk_tokens=0),
    dict(prefill_chunk_tokens=0)],
    ids=["ragged", "legacy_fused", "legacy_eager", "one_shot_eager",
         "one_shot_fused", "ragged_one_shot"])
def test_warm_greedy_identical_to_jax_cold_and_oracle(models, jax_runs, kw):
    """Every warm request after the seed hits (the exact-multiple prompt
    clipped to 11 tokens, which copies its tail page on write), and the
    streams equal the JAX warm engine's, the port's cold engine's and
    the full-recompute oracle's."""
    warm = _held(models, jax_runs, ("greedy",) + tuple(sorted(kw.items())),
                 **kw)
    for p, toks in zip([PROMPTS[0]] + PROMPTS, warm["tokens"]):
        assert toks == _oracle(models[1], p)
    assert warm["hits"] == [0, 12, 12, 12, 11]
    assert warm["counters"][pm.COW_COPIES] == 1
    # a warm request prefills only its suffix
    assert warm["counters"][pm.PREFILL_TOKENS_TOTAL] == \
        14 + 14 + 13 + 15 + 12 - (12 + 12 + 12 + 11)


def test_warm_stochastic_identical_to_jax_and_cold(models, jax_runs):
    _held(models, jax_runs, "stochastic",
          seeds=[41, 42, 43, 44, 45])


def test_warm_chunked_skips_cached_chunks(models, jax_runs):
    """Fully cached pages cost no chunk dispatch: the warm request's
    3-token suffix is one chunk of 3."""
    waves = [[SYSTEM + [7, 7]], [SYSTEM + [9, 9, 9]]]
    warm = _held(models, jax_runs, "chunks", waves=waves,
                 step_mode="legacy")
    assert warm["hits"] == [0, 12]
    assert warm["counters"][pm.PREFILL_CHUNKS_TOTAL] == 5 + 1


def test_warm_forced_preemption(models, jax_runs):
    """A pool tight enough to preempt mid-decode: victims re-match their
    own cached run on re-admission and still give the oracle's stream."""
    warm = _held(models, jax_runs, "preempt", waves=[PROMPTS], num_pages=14)
    assert sum(warm["preemptions"]) > 0
    for p, toks in zip(PROMPTS, warm["tokens"]):
        assert toks == _oracle(models[1], p)


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="bfloat16"),
    dict(kv_dtype="bfloat16", pool_layout="kernel"),
    dict(pool_layout="kernel", step_mode="legacy"),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int8", pool_layout="kernel", step_mode="legacy",
         prefill_chunk_tokens=0)],
    ids=["bf16", "bf16_kernel", "f32_kernel_legacy", "int8",
         "int8_kernel_one_shot"])
def test_warm_pool_dtypes_and_layouts(models, jax_runs, kw):
    """bfloat16 and int8 pools, both layouts: a warm hit aliases the same
    stored bytes (and int8 scales) a cold prefill would write, so warm
    equals cold and the JAX warm engine at storage precision."""
    warm = _held(models, jax_runs, ("dtype",) + tuple(sorted(kw.items())),
                 **kw)
    assert warm["hits"][1:] == [12, 12, 12, 11]


def test_shared_system_prompt_holds_one_copy(models, jax_runs):
    """Four concurrent users of one system prompt alias its 3 pages: the
    shared-page peak covers them, and the pool holds far fewer pages than
    four copies."""
    waves = [[SYSTEM + [47]], [SYSTEM + [40 + i] for i in range(4)]]
    warm = _held(models, jax_runs, "shared", waves=waves, n=4)
    assert warm["peak_shared"] >= 3
    assert warm["hits"] == [0, 12, 12, 12, 12]


def test_eviction_before_preemption(models, jax_runs):
    """A resident cache is never a reason to preempt: a divergent long
    prompt that cannot fit beside the cached run evicts it instead."""
    waves = [[SYSTEM], [[40, 41, 42, 43, 44, 45, 46, 47] * 3]]
    warm = _held(models, jax_runs, "evict", waves=waves, max_decode_slots=2,
                 num_pages=10)
    assert warm["counters"][pm.PREFIX_EVICTIONS] > 0
    assert warm["counters"][pm.PREEMPTED_TOTAL] == 0


def test_warm_admission_waits_for_pages(models):
    """The admission gate does not count a match's own cached pages both
    as aliased for free and as evictable: the warm request waits in line
    for a live sequence to retire, then completes, instead of failing its
    suffix reserve."""
    outs = []
    for pkg, model in zip((jgen, pgen), models):
        reg = JStatRegistry() if pkg is jgen else StatRegistry()
        eng = pkg.GenerationEngine(model, _config(pkg, dict(
            max_decode_slots=2, num_pages=8, prefix_cache=True)),
            metrics=pkg.GenerationMetrics(registry=reg), start=False)
        h0 = eng.submit(SYSTEM, max_new_tokens=8)
        eng.run_until_idle()
        other = [30 + i for i in range(12)]
        h_a = eng.submit(other, max_new_tokens=4)
        for _ in range(32):
            eng.step()
            if h_a.first_token_s is not None:
                break
        eng.step()
        suffix = [21, 22, 23, 24, 25, 26]
        h_b = eng.submit(SYSTEM + suffix, max_new_tokens=3)
        eng.run_until_idle()
        outs.append([h.result(timeout=5).token_ids for h in (h0, h_a, h_b)]
                    + [h_b.prefix_hit_tokens])
        eng.shutdown()
    assert outs[0] == outs[1]
    assert outs[1][2] == _oracle(models[1], SYSTEM + [21, 22, 23, 24, 25,
                                                      26], 3)
    assert outs[1][3] == len(SYSTEM)


def test_hit_rate_counts_first_admissions_only(models, jax_runs):
    """Prompts sharing no full page, in a pool tight enough to preempt:
    re-admissions re-match their own runs, and none of it counts as a
    hit."""
    waves = [[[10 + i] * 12 for i in range(4)]]
    warm = _held(models, jax_runs, "hit_rate", waves=waves, num_pages=14)
    assert sum(warm["preemptions"]) > 0
    assert warm["counters"][pm.PREFIX_CACHE_HIT_TOKENS] == 0


def test_preempted_sequence_warm_resumes_from_its_own_run(models, jax_runs):
    waves = [[SYSTEM], [SYSTEM + [7], SYSTEM + [8]]]
    warm = _held(models, jax_runs, "own_run", waves=waves, n=10,
                 max_decode_slots=2, num_pages=16)
    assert warm["counters"][pm.PREFILL_TOKENS_TOTAL] < \
        len(SYSTEM) + 2 * (len(SYSTEM) + 1)


def test_decode_tail_and_two_turn_conversation(models, jax_runs):
    """Full pages of generated tokens join the index at retire: turn 2
    (turn 1's prompt, its streamed answer and new text) hits past the
    old prompt into the answer, and its stream equals the oracle's.
    Turn 1 registers 3 prompt pages, then 1 tail page."""
    p1 = SYSTEM + [7, 7]
    first = _serve(pgen, models[1], waves=[[p1]], prefix_cache=True)
    assert first["counters"][pm.PREFIX_PAGES_REGISTERED] == 3 + 2
    answer = first["tokens"][0]
    p2 = p1 + answer + [2, 4]
    warm = _held(models, jax_runs, "two_turn", waves=[[p1], [p2]])
    assert warm["tokens"][1] == _oracle(models[1], p2)
    assert warm["hits"][1] > len(p1)


def test_prefix_cache_off_is_inert_and_auto_is_off_on_the_cpu(models):
    for setting in (False, None):
        run = _serve(pgen, models[1], prefix_cache=setting,
                     engine="keep")
        eng = run["engine"]
        assert not eng.prefix_cache_enabled
        assert run["hits"] == [0] * 5
        assert eng.cache.shared_pages == 0
        assert eng.cache.num_free_pages == eng.cache.num_pages
        eng.shutdown()


def test_engine_leak_invariant_and_metric_schema(models):
    run = _serve(pgen, models[1], waves=SEQUENTIAL + SEQUENTIAL,
                 prefix_cache=True, engine="keep")
    eng = run["engine"]
    assert eng.cache.prefix_cached_pages == eng.cache.pages_in_use > 0
    snap = eng.stats()
    for name in (pm.PREFIX_CACHE_HIT_TOKENS, pm.PREFIX_CACHE_HIT_RATE,
                 pm.SHARED_PAGES, pm.COW_COPIES, pm.PREFIX_EVICTIONS,
                 pm.PREFIX_PAGES_REGISTERED):
        assert name in snap
    assert 0 < snap[pm.PREFIX_CACHE_HIT_RATE] < 1
    assert snap["cache.prefix_cached_pages"] == eng.cache.pages_in_use
    eng.cache.flush_prefix_cache()
    assert eng.cache.num_free_pages == eng.cache.num_pages
    eng.shutdown()


def test_prefix_cache_needs_a_resumable_prefill(models):
    class NoChunk(pgen.TinyCausalLM):
        prefill_chunk = property()    # hide the eager chunk protocol

    m = NoChunk(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
                device="cpu")
    with pytest.raises(ValueError, match="prefix_cache=True needs"):
        pgen.GenerationEngine(m, pgen.GenerationConfig(
            prefix_cache=True, prefill_chunk_tokens=0, device="cpu"),
            start=False)
    eng = pgen.GenerationEngine(m, pgen.GenerationConfig(
        prefix_cache=True, prefill_chunk_tokens=2, device="cpu"),
        start=False)
    assert eng.prefix_cache_enabled
    eng.shutdown()
    with pytest.raises(ValueError, match="prefix_cache must be"):
        pgen.GenerationConfig(prefix_cache="yes", device="cpu")


@pytest.mark.parametrize("kw", [
    dict(spec_mode="ngram", spec_tokens=3),
    dict(loop_steps=4),
    dict(spec_mode="ngram", spec_tokens=3, loop_steps=4,
         pool_layout="kernel")],
    ids=["spec", "loop", "spec_loop_kernel"])
def test_speculation_and_loop_over_a_warm_cache(models, jax_runs, kw):
    """Drafts and the loop's horizon write only private pages (their COW
    guards): the warm spec and loop engines equal the JAX ones and the
    port's cold ones, with repeated spans so drafts are accepted."""
    rep = SYSTEM + [5, 6, 9, 1, 5, 6, 9, 1]
    waves = [[rep], [rep + [5]], [rep[:12]], [rep + [4, 4]]]
    warm = _held(models, jax_runs, ("spec",) + tuple(sorted(kw.items())),
                 waves=waves, n=10, **kw)
    assert warm["hits"][1:] == [20, 11, 20]


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8"),
                                dict(step_mode="legacy",
                                     pool_layout="kernel")],
                         ids=["f32", "int8", "legacy_kernel"])
def test_page_service_export_import_between_engines(models, kw):
    """A run exported from a warm engine and imported into a fresh one
    (of the other layout) serves that engine's first request from the
    import: it prefills only its suffix, and its stream equals the
    exporting engine's.  Importing into an engine of another pool dtype
    returns 0 and installs nothing."""
    src = _serve(pgen, models[1], waves=[[PROMPTS[0]]], prefix_cache=True,
                 engine="keep", **kw)
    payload = src["engine"].export_prefix_pages(PROMPTS[2])
    assert payload["tokens"] == SYSTEM and payload["k"].shape[1] == 3
    assert len(payload) == (5 if kw.get("kv_dtype") == "int8" else 3)
    src["engine"].shutdown()
    other = dict(kw, pool_layout="token" if kw.get("pool_layout") ==
                 "kernel" else "kernel")
    reg = StatRegistry()
    dst = pgen.GenerationEngine(models[1], _config(pgen, dict(
        other, prefix_cache=True)),
        metrics=pgen.GenerationMetrics(registry=reg), start=False)
    assert dst.import_prefix_pages(payload) == 3
    h = dst.submit(PROMPTS[2], max_new_tokens=8)
    dst.run_until_idle()
    assert h.prefix_hit_tokens == 12
    assert reg.stats()[pm.PREFILL_TOKENS_TOTAL] == 3
    ref = _serve(pgen, models[1], waves=[[PROMPTS[2]]], prefix_cache=False,
                 **kw)
    assert h.result(timeout=5).token_ids == ref["tokens"][0]
    dst.shutdown()
    wrong = pgen.GenerationEngine(models[1], _config(pgen, dict(
        prefix_cache=True, kv_dtype="bfloat16" if kw.get("kv_dtype")
        else "int8")), start=False)
    assert wrong.import_prefix_pages(payload) == 0
    assert wrong.cache.num_free_pages == wrong.cache.num_pages
    wrong.shutdown()
    off = pgen.GenerationEngine(models[1], _config(pgen, {}), start=False)
    assert off.export_prefix_pages(SYSTEM) is None
    assert off.import_prefix_pages(payload) == 0
    off.shutdown()


@pytest.mark.parametrize("start", [0, 5, 9])
def test_prefill_chunk_matches_jax(models, start):
    """`TinyCausalLM.prefill_chunk` with the plain chunk attention over
    the chunk's keys against the JAX model's with its reference, on the
    same prefix keys: logits and the keys the callback saw within
    2e-5."""
    jm, pmod = models
    rng = np.random.default_rng(start)
    tokens = rng.integers(0, MODEL["vocab_size"], 4).tolist()
    hd = (MODEL["num_heads"], MODEL["head_dim"])
    prefix = [(rng.standard_normal((start,) + hd).astype(np.float32),
               rng.standard_normal((start,) + hd).astype(np.float32))
              for _ in range(MODEL["num_layers"])]
    seen = {}

    def attend_for(pkg):
        def attend(layer, q, k, v):
            pk, pv = prefix[layer]
            if pkg is jgen:
                k_all = jnp.concatenate([jnp.asarray(pk), k])
                v_all = jnp.concatenate([jnp.asarray(pv), v])
                seen[("jax", layer)] = np.asarray(k)
                return jdec.chunk_prefill_attention_reference(
                    q, k_all, v_all, start)
            k_all = torch.cat([torch.from_numpy(pk), k])
            v_all = torch.cat([torch.from_numpy(pv), v])
            seen[("port", layer)] = k.numpy()
            return pgen.chunk_prefill_attention_reference(q, k_all, v_all,
                                                          start)
        return attend

    theirs = np.asarray(jm.prefill_chunk(np.asarray(tokens, np.int32),
                                         start, attend_for(jgen)))
    ours = pmod.prefill_chunk(tokens, start, attend_for(pgen)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=2e-5)
    for layer in range(MODEL["num_layers"]):
        np.testing.assert_allclose(seen[("port", layer)],
                                   seen[("jax", layer)], atol=2e-5,
                                   rtol=2e-5)
