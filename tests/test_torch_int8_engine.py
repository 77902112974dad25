"""Port parity: the int8 KV-pool serving mode end to end.

The port's engine with ``kv_dtype="int8"`` on the CPU (every attention
call takes the CUDA kernels' plain versions, dequantizing with the
kernels' expression) against the JAX engine with int8 device pools and
the jnp reference attention (``use_kernel=False``), on the same weights
and prompts.  Quantization changes values once, at the write, and the
two packages write bitwise-equal bytes and scales, so the contract is
TOKEN identity — greedy and seeded stochastic, the ragged step and the
legacy step (fused and eager decode, chunked and one-shot prefill), both
pool layouts, a pool tight enough to preempt — plus the same
``generation.kv_scale_bytes``.  Against the float32 oracle the contract
is the quality gate of the JAX package (generation/quality.py).
"""
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.generation import quality as jquality
from paddle_tpu.profiler.monitor import StatRegistry as JaxStatRegistry
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import quality as pquality
from paddle_tpu_torch.profiler.monitor import StatRegistry

L, H, D, PS = 2, 2, 8, 4
MODEL = dict(vocab_size=64, num_layers=L, num_heads=H, head_dim=D,
             max_positions=512, seed=0)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]


@pytest.fixture(scope="module")
def models():
    return jgen.TinyCausalLM(**MODEL), pgen.TinyCausalLM(**MODEL,
                                                         device="cpu")


def _config(pkg, **kw):
    cfg = dict(dict(max_decode_slots=4, num_pages=64, page_size=PS), **kw)
    if pkg is jgen:
        # the jitted chunk step wherever the legacy step chunks
        cfg.update(kv_backend="device", use_kernel=False,
                   jit_prefill=bool(cfg.get("prefill_chunk_tokens")))
    else:
        cfg.update(device="cpu")
    return pkg.GenerationConfig(**cfg)


def _run(pkg, model, new_tokens=10, **kw):
    """Serve PROMPTS (the odd ones seeded stochastic) on one engine of
    `pkg` with its own stat registry; returns (token streams, results,
    snapshot)."""
    reg = JaxStatRegistry() if pkg is jgen else StatRegistry()
    eng = pkg.GenerationEngine(model, _config(pkg, **kw),
                               metrics=pkg.GenerationMetrics(registry=reg),
                               start=False)
    try:
        handles = []
        for i, p in enumerate(PROMPTS):
            sampling = (pkg.SamplingParams(temperature=0.8, top_k=8,
                                           seed=100 + i)
                        if i % 2 else pkg.SamplingParams())
            handles.append(eng.submit(p, max_new_tokens=new_tokens,
                                      sampling=sampling))
        eng.run_until_idle()
        results = [h.result(timeout=30) for h in handles]
        snap = eng.stats()
    finally:
        eng.shutdown()
    return [r.token_ids for r in results], results, snap


CASES = {
    "ragged_chunk4": dict(step_mode="ragged", prefill_chunk_tokens=4),
    "ragged_chunk4_kernel_layout": dict(step_mode="ragged",
                                        prefill_chunk_tokens=4,
                                        pool_layout="kernel"),
    "legacy_fused_chunk4": dict(step_mode="legacy", decode="fused",
                                prefill_chunk_tokens=4),
    "legacy_eager_one_shot_kernel_layout": dict(
        step_mode="legacy", decode="eager", prefill_chunk_tokens=0,
        pool_layout="kernel"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_int8_token_identical_to_jax(models, name):
    jtok, _, jsnap = _run(jgen, models[0], kv_dtype="int8", **CASES[name])
    ptok, _, psnap = _run(pgen, models[1], kv_dtype="int8", **CASES[name])
    assert ptok == jtok
    assert all(len(t) == 10 for t in ptok)
    assert psnap["generation.kv_quant_dtype"] == "int8"
    assert psnap["cache.kv_dtype"] == "int8"
    scale_bytes = psnap["generation.kv_scale_bytes"]
    assert scale_bytes == jsnap["generation.kv_scale_bytes"] > 0
    assert psnap["generation.kv_bytes_moved"] == \
        jsnap["generation.kv_bytes_moved"]
    assert psnap["generation.kv_bytes_moved"] > scale_bytes


def test_int8_forced_preemption_token_identical_to_jax(models):
    """A pool of 11 pages forces preemption on the ragged step: victims
    re-prefill through the same quantized writes, every token and
    preemption count still matches the JAX engine's."""
    kw = CASES["ragged_chunk4"]
    jtok, jres, _ = _run(jgen, models[0], kv_dtype="int8", num_pages=11,
                         **kw)
    ptok, pres, psnap = _run(pgen, models[1], kv_dtype="int8",
                             num_pages=11, **kw)
    assert ptok == jtok
    assert psnap.get("generation.preempted_total", 0) > 0
    assert [r.preemptions for r in pres] == [r.preemptions for r in jres]


def test_int8_engine_matches_its_own_float_oracle_on_the_quality_gate(
        models):
    """The port's quality report on the JAX package's seeded workload
    passes the JAX thresholds: >= 99% greedy agreement with the float32
    engine, max logit drift < 0.25 and within 4x the single-rounding
    ideal + 0.05."""
    pm = models[1]
    rep = pquality.kv_quality_report(
        pm, _config(pgen), _config(pgen, kv_dtype="int8"),
        max_new_tokens=12)
    assert rep["agreement"] >= 0.99, rep
    assert rep["max_logit_drift"] < 0.25, rep
    assert rep["max_logit_drift"] <= \
        rep["ideal_fake_quant_drift"] * 4 + 0.05, rep
    assert rep["drift_steps"] == 6 * 8


def test_quality_report_matches_jax(models):
    """The port's kv_quality_report against the JAX one on one seeded
    prompt (the legacy eager one-shot engines, cheap to compile for the
    JAX side): agreement exactly, drifts within 1e-5."""
    prompts = jquality.seeded_prompts(MODEL["vocab_size"], n_prompts=1)
    assert pquality.seeded_prompts(MODEL["vocab_size"],
                                   n_prompts=1) == prompts
    kw = dict(step_mode="legacy", decode="eager", prefill_chunk_tokens=0)
    jrep = jquality.kv_quality_report(
        models[0], _config(jgen, **kw), _config(jgen, kv_dtype="int8", **kw),
        prompts=prompts, max_new_tokens=8)
    prep = pquality.kv_quality_report(
        models[1], _config(pgen, **kw), _config(pgen, kv_dtype="int8", **kw),
        prompts=prompts, max_new_tokens=8)
    assert prep["agreement"] == jrep["agreement"]
    assert prep["positions"] == jrep["positions"]
    assert prep["drift_steps"] == jrep["drift_steps"]
    for key in ("max_logit_drift", "mean_logit_drift",
                "ideal_fake_quant_drift"):
        assert abs(prep[key] - jrep[key]) <= 1e-5, (key, prep, jrep)


def test_int8_pool_quantizes_every_write_path(models):
    """Every step path leaves int8 bytes and non-zero scales in the pool
    it wrote (nothing quietly stored floats), and an int8 engine counts
    its scale bytes from the first step."""
    pm = models[1]
    for kw in CASES.values():
        eng = pgen.GenerationEngine(
            pm, _config(pgen, kv_dtype="int8", **kw),
            metrics=pgen.GenerationMetrics(registry=StatRegistry()),
            start=False)
        h = eng.submit(PROMPTS[0], max_new_tokens=1)
        eng.step()
        state = eng.cache.take_pool_state()
        assert [t.dtype for t in state] == \
            [torch.int8] * (2 * L) + [torch.float32] * (2 * L)
        assert all(float(s.max()) > 0 for s in state[2 * L:])
        assert eng.stats()["generation.kv_scale_bytes"] > 0
        eng.run_until_idle()
        h.result(timeout=5)
        eng.shutdown()
