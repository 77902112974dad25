"""Port parity: the legacy serving step end to end.

The port's engine with ``step_mode="legacy"`` on the CPU (every attention
call takes the CUDA kernels' plain versions) against the JAX engine with
device pools, ``step_mode="legacy"`` and the jnp reference attention
(``use_kernel=False``), on the same model weights and prompts.  The
contract is TOKEN identity — greedy and seeded stochastic, fused and
eager decode, chunked and one-shot prefill, preempted, stopped — not
bitwise logits: the two frameworks sum in different orders.  Then, within
the port: legacy against ragged, and the legacy step's counters.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.generation.fused import decode_batch_menu
from paddle_tpu_torch.profiler.monitor import StatRegistry

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


def _config(pkg, *, slots=4, pages=64, page_size=4, chunk=3,
            step_mode="legacy", decode="fused"):
    cfg = dict(max_decode_slots=slots, num_pages=pages, page_size=page_size,
               prefill_chunk_tokens=chunk, step_mode=step_mode)
    if step_mode == "legacy":
        cfg["decode"] = decode
    if pkg is jgen:
        # the jitted chunk step wherever chunking is on; the one-shot
        # prefill on its eager path
        cfg.update(kv_backend="device", use_kernel=False,
                   jit_prefill=bool(chunk))
    else:
        cfg.update(device="cpu")
    return pkg.GenerationConfig(**cfg)


def _run(pkg, model, requests, **kw):
    """Serve `requests` ([(prompt, kwargs)], kwargs may hold a "sampling"
    dict of SamplingParams arguments) on one engine of `pkg` until idle;
    returns (results, engine) with the engine shut down."""
    eng = pkg.GenerationEngine(model, _config(pkg, **kw), start=False)
    handles = []
    for prompt, kw_req in requests:
        kw_req = dict(kw_req)
        kw_req["sampling"] = _sampling(pkg, kw_req.get("sampling"))
        handles.append(eng.submit(prompt, **kw_req))
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


def _greedy(n=12):
    return [(p, {"max_new_tokens": n}) for p in PROMPTS]


@pytest.mark.parametrize("kw", [
    dict(chunk=1), dict(chunk=2), dict(chunk=3),
    dict(chunk=3, decode="eager"), dict(chunk=0),
    dict(chunk=0, decode="eager"), dict(chunk=0, step_mode="ragged")],
    ids=["fused_chunk1", "fused_chunk2", "fused_chunk3", "eager_chunk3",
         "fused_one_shot", "eager_one_shot", "ragged_one_shot"])
def test_greedy_token_identical_to_jax(models, kw):
    jres, pres, peng = _both(models, _greedy(), **kw)
    assert _tokens(pres) == _tokens(jres)
    assert all(len(r.token_ids) == 12 for r in pres)
    assert peng.cache.utilization() == 0.0


@pytest.mark.parametrize("greedy_mix", [False, True])
def test_seeded_stochastic_token_identical_to_jax(models, greedy_mix):
    """Temperature/top-k/top-p streams from the same seeds, alone and in
    a batch mixed with greedy rows (the fused step then fetches
    logits)."""
    reqs = []
    for i, p in enumerate(PROMPTS):
        spec = (None if greedy_mix and i % 2 else
                dict(temperature=0.9, top_k=10, top_p=0.9, seed=41 + i))
        reqs.append((p, {"max_new_tokens": 10, "sampling": spec}))
    jres, pres, _ = _both(models, reqs, chunk=2 if greedy_mix else 3)
    assert _tokens(pres) == _tokens(jres)


@pytest.mark.parametrize("chunk", [2, 0])
def test_forced_preemption_token_identical_to_jax(models, chunk):
    """A pool sized to thrash: victims (decoding and mid-chunk)
    re-prefill, every token still matches and so do the preemption
    counts."""
    jres, pres, peng = _both(models, _greedy(), pages=9, chunk=chunk)
    assert _tokens(pres) == _tokens(jres)
    assert sum(r.preemptions for r in pres) > 0
    assert [r.preemptions for r in pres] == [r.preemptions for r in jres]
    assert peng.cache.utilization() == 0.0


@pytest.mark.parametrize("chunk", [2, 0])
def test_max_new_tokens_zero_and_stop_tokens(models, chunk):
    free, _ = _run(jgen, models[0], [([1, 2, 3], {"max_new_tokens": 8})],
                   chunk=chunk)
    stop = free[0].token_ids[2]
    reqs = [([1, 2], {"max_new_tokens": 0}),
            ([1, 2, 3], {"max_new_tokens": 8, "stop_tokens": (stop,)})]
    jres, pres, _ = _both(models, reqs, chunk=chunk)
    assert _tokens(pres) == _tokens(jres)
    assert pres[0].token_ids == [] and pres[0].finish_reason == "length"
    assert pres[1].finish_reason == "stop"
    assert pres[1].token_ids == free[0].token_ids[:2]


@pytest.mark.parametrize("kw", [dict(chunk=2), dict(chunk=3, decode="eager"),
                                dict(chunk=0)],
                         ids=["fused_chunked", "eager_chunked",
                              "fused_one_shot"])
def test_legacy_token_identical_to_ragged_in_the_port(models, kw):
    """Within the port, on the CPU: the legacy step and the ragged step
    serve the same streams, greedy and seeded stochastic mixed."""
    reqs = [(p, {"max_new_tokens": 10, "sampling": (
        dict(temperature=0.8, top_k=8, seed=7 + i) if i == 1 else None)})
        for i, p in enumerate(PROMPTS)]
    legacy, _ = _run(pgen, models[1], reqs, **kw)
    ragged, _ = _run(pgen, models[1], reqs,
                     chunk=kw["chunk"] or 3, step_mode="ragged")
    assert _tokens(legacy) == _tokens(ragged)


def test_fused_step_is_one_dispatch_one_sync(models):
    """A decode-only fused step is exactly 1 step call with 1 host sync;
    a step with a packed chunk adds one call per chunk; the eager decode
    issues a write and an attention call per layer."""
    eng = pgen.GenerationEngine(models[1], _config(pgen, chunk=2),
                                start=False)
    reg = StatRegistry.instance()
    disp = reg.get_stat(pmetrics.DECODE_DISPATCHES_PER_STEP)
    sync = reg.get_stat(pmetrics.DECODE_HOST_SYNCS_PER_STEP)
    h1 = eng.submit([1, 2, 3], max_new_tokens=16)
    for _ in range(3):                 # h1 through prefill into decode
        eng.step()
    assert eng.scheduler.decode_ready()
    for _ in range(3):
        eng.step()                     # pure decode steps
        assert (disp.get(), sync.get()) == (1, 1)
    eng.submit([1] * 8, max_new_tokens=1)
    eng.scheduler.admit(limit=4)
    eng.step()                         # one chunk call + the decode call
    assert disp.get() == 2
    eng.run_until_idle()
    assert len(h1.result(timeout=5).token_ids) == 16
    eng.shutdown()
    eager = pgen.GenerationEngine(
        models[1], _config(pgen, chunk=0, decode="eager"), start=False)
    eager.submit([1, 2, 3], max_new_tokens=4)
    eager.step()
    eager.step()
    assert (disp.get(), sync.get()) == (2 * MODEL["num_layers"], 1)
    eager.run_until_idle()
    eager.shutdown()


def test_fused_dummy_rows_never_write_a_mapped_page(models):
    """3 live sequences padded to the 4-row bucket: the dummy row's K/V
    lands in the sink page, so every page outside the live page tables
    stays exactly zero, and the padding is counted as waste."""
    eng = pgen.GenerationEngine(models[1], _config(pgen, pages=16, chunk=0),
                                start=False)
    handles = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:3]]
    eng.step()                         # prefill + first decode
    for _ in range(3):
        eng.step()                     # fused decode with a dummy 4th row
        owned = set()
        for s in eng.scheduler.active():
            owned |= set(eng.cache.page_table(s.seq_id))
        for page in set(range(eng.cache.num_pages)) - owned:
            assert not eng.cache.k_pool[:, page].any()
            assert not eng.cache.v_pool[:, page].any()
    eng.run_until_idle()
    for h, p in zip(handles, PROMPTS[:3]):
        assert h.result(timeout=5).token_ids == models[1].greedy_reference(
            p, 8)
    assert eng.stats()["generation.padded_token_waste"] > 0
    eng.shutdown()


def test_compile_count_bounded_by_the_bucket_menu(models):
    """Repeat traffic through seen buckets adds no signature; the counts
    equal the signatures cached and land in the decode and prefill
    compile metrics; the pre-warm tags the ones it recorded first."""
    eng = pgen.GenerationEngine(models[1], _config(pgen, chunk=2),
                                start=False)

    def burst():
        hs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        eng.run_until_idle()
        for h in hs:
            h.result(timeout=5)

    burst()
    first = (eng._fused.compile_count, eng._chunk_step.compile_count)
    burst()
    assert (eng._fused.compile_count, eng._chunk_step.compile_count) == first
    buckets = eng._fused.cached_buckets()
    assert len(buckets) == first[0]
    menu_b = decode_batch_menu(4)
    assert all(b in menu_b for b, _, _ in buckets)
    assert first[0] <= len(menu_b) * 7 * 2      # pages menu 1..64, greedy
    snap = eng.stats()
    assert snap["generation.decode_compiles_total"] == first[0]
    assert snap["generation.prefill_compiles_total"] == first[1]
    assert snap["generation.decode_compiles_prewarm"] >= 1
    assert snap["generation.decode_cache_hits"] > 0
    eng.shutdown()


def test_failed_dispatch_resets_pools_and_engine_keeps_serving(models):
    """A fused decode call that dies after writing the pools: the cache
    comes back on fresh zeroed storage and later requests serve
    token-identically to the full-recompute oracle."""
    model = models[1]
    eng = pgen.GenerationEngine(model, _config(pgen, chunk=2), start=False)
    h = eng.submit([1, 2, 3], max_new_tokens=6)
    eng.step()
    eng.step()                         # prompt consumed, first token out

    class Boom(RuntimeError):
        pass

    real = dict(eng._fused._fns)

    def poisoned(fn):
        def call(*args):
            fn(*args)                  # the pools ARE written ...
            raise Boom("step died after writing the pools")
        return call

    old_pools = eng.cache.take_pool_state()
    eng._fused._fns = {g: poisoned(fn) for g, fn in real.items()}
    with pytest.raises(Boom):
        eng.step()
    eng._fused._fns = real
    fresh = eng.cache.take_pool_state()
    assert all(f is not o for f, o in zip(fresh, old_pools))
    assert all(not bool(f.any()) for f in fresh)
    for state in eng.scheduler.active():   # the worker's contract
        eng.scheduler.retire(state)
        state.handle.set_exception(Boom("poisoned step"))
    with pytest.raises(Boom):
        h.result(timeout=5)
    h2 = eng.submit([4, 5], max_new_tokens=6)
    eng.run_until_idle()
    assert h2.result(timeout=5).token_ids == model.greedy_reference([4, 5],
                                                                    6)
    eng.shutdown()


def test_legacy_config_validation(models):
    """decode= names a legacy path; the ragged step refuses it, and the
    auto step mode takes the legacy step for it.  The fused decode's
    batch menu holds every slot, and a model without the legacy step's
    methods is refused at build."""
    with pytest.raises(ValueError, match="step_mode='ragged'"):
        pgen.GenerationConfig(step_mode="ragged", decode="eager",
                              device="cpu")
    with pytest.raises(ValueError, match="decode must be"):
        pgen.GenerationConfig(decode="warp", device="cpu")
    eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        decode="eager", device="cpu"), start=False)
    assert (eng.step_mode, eng.decode_mode) == ("legacy", "eager")
    assert eng.stats()["generation.kernel_path"] == "eager:torch-reference"
    fused = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        step_mode="legacy", max_decode_slots=6, device="cpu"), start=False)
    assert fused._fused._bucketer.batch_buckets == decode_batch_menu(6) \
        == (1, 2, 4, 6)

    class RaggedOnly:
        num_layers, num_heads, head_dim = 1, 1, 4

        def ragged_step_fn(self):
            raise NotImplementedError

        def decode_params(self):
            raise NotImplementedError

    with pytest.raises(ValueError, match="decode_step_fn"):
        pgen.GenerationEngine(RaggedOnly(), pgen.GenerationConfig(
            step_mode="legacy", device="cpu"), start=False)
