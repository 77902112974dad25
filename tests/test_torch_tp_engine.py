"""Port parity: the generation engine under a tensor-parallel mesh.

The port's mesh engines (``GenerationConfig(mesh=tp_mesh(4, devices=
["cpu"] * 4))``: four head shards driven by one process, each paged
attention call once per shard on the kernel's plain version) against the
JAX package's mesh engines (``tp_mesh(4)`` over the conftest's forced
host devices) on the same weights and prompts, and against the port's
single-device engines.  The contract is TOKEN identity, greedy and seeded
stochastic, through the ragged step, the legacy step (fused decode,
chunked and one-shot prefill) and on float32, bfloat16 and int8 pools;
the quantized all-reduce is held to its float32-collective sibling by
the JAX package's agreement gate.  Each JAX engine runs once, memoized at
module scope, and the cases share its streams.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.parallel import tp_mesh as jax_tp_mesh
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.parallel import tp_mesh
from paddle_tpu_torch.profiler.monitor import StatRegistry

from gen_oracle import greedy_oracle  # noqa: E402  cross-module memo

TP = 4
MODEL = dict(vocab_size=48, num_layers=2, num_heads=4, head_dim=8, seed=3)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11]]
NEW = 10
# the legacy step's two prefills, and the ragged step
LEGACY = dict(step_mode="legacy", decode="fused", prefill_chunk_tokens=0)
CHUNKED = dict(step_mode="legacy", decode="fused", prefill_chunk_tokens=3)
RAGGED = dict(prefill_chunk_tokens=3)
# each port setting's JAX counterpart (the JAX engine spells its steps
# differently on the CPU)
JAX_OF = {"legacy": {}, "chunked": dict(jit_prefill=True,
                                        prefill_chunk_tokens=3),
          "ragged": dict(kv_backend="device", step_mode="ragged",
                         prefill_chunk_tokens=3)}
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(autouse=True)
def _fresh_port_stats():
    reg = StatRegistry.instance()
    for name in list(reg.stats()):
        if name.startswith(pmetrics.PREFIX):
            reg.get_stat(name).reset()
    yield


@pytest.fixture(scope="module")
def models():
    jmodel = jgen.TinyCausalLM(**MODEL)
    tree = {k: np.asarray(v) if not isinstance(v, list) else
            [{n: np.asarray(a) for n, a in b.items()} for b in v]
            for k, v in jmodel.decode_params().items()}
    pmodel = pgen.TinyCausalLM.from_numpy_params(
        tree, num_heads=MODEL["num_heads"], seed=MODEL["seed"],
        device="cpu")
    return jmodel, pmodel


@pytest.fixture(scope="module")
def mesh():
    return tp_mesh(TP, devices=["cpu"] * TP)


def _sampling(pkg, i):
    """Greedy on odd rows, seeded stochastic on even ones."""
    return (pkg.SamplingParams() if i % 2 else
            pkg.SamplingParams(temperature=0.8, top_k=8, seed=11 + i))


def _run(pkg, model, cfg, prompts=PROMPTS, new=NEW, stochastic=True):
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(**{
        **dict(max_decode_slots=4, num_pages=64, page_size=4), **cfg}),
        start=False)
    hs = [eng.submit(p, max_new_tokens=new,
                     sampling=(_sampling(pkg, i) if stochastic
                               else pkg.SamplingParams()))
          for i, p in enumerate(prompts)]
    eng.run_until_idle()
    results = [h.result(timeout=5) for h in hs]
    snap = eng.stats()
    eng.shutdown()
    return [r.token_ids for r in results], results, snap, eng


_JAX = {}


def _jax(models, mode, **extra):
    """The JAX mesh engine's streams for one setting, run once per
    module."""
    key = (mode, tuple(sorted(extra.items())))
    if key not in _JAX:
        cfg = {**JAX_OF[mode], **extra, "mesh": jax_tp_mesh(TP)}
        toks, _, snap, _ = _run(jgen, models[0], cfg)
        _JAX[key] = toks, snap
    return _JAX[key]


def _port(models, mesh, settings, **extra):
    return _run(pgen, models[1], {**settings, **extra,
                                  **({"mesh": mesh} if mesh else
                                     {"device": "cpu"})})


# --------------------- the legacy step (test_sharded_decode) ---------------


@pytest.mark.parametrize("mode,settings", [("legacy", LEGACY),
                                           ("chunked", CHUNKED)])
def test_sharded_legacy_token_identical(models, mesh, mode, settings):
    """The fused decode with one-shot or chunked prefill on the mesh:
    greedy and seeded stochastic streams equal the JAX mesh engine's and
    the port's single-device engine's; greedy rows the oracle's."""
    want, _ = _jax(models, mode)
    got, _, snap, eng = _port(models, mesh, settings)
    single, _, _, _ = _port(models, None, settings)
    assert got == want == single
    for i in (1, 3):
        assert got[i] == greedy_oracle(models[0], PROMPTS[i], NEW)
    assert eng.cache.utilization() == 0.0
    assert snap["generation.mesh_devices"] == TP


@pytest.mark.parametrize("mode,settings", [("legacy", LEGACY),
                                           ("chunked", CHUNKED),
                                           ("ragged", RAGGED)])
def test_sharded_token_identical_under_forced_preemption(models, mesh, mode,
                                                         settings):
    """A pool sized to thrash: victims re-prefill through the sharded
    path (chunks mid-prefill included) and every stream still equals the
    JAX mesh engine's unpreempted one."""
    want, _ = _jax(models, mode)
    got, results, _, eng = _port(models, mesh, settings, num_pages=9)
    assert got == want
    assert sum(r.preemptions for r in results) > 0
    assert eng.cache.utilization() == 0.0


def test_sharded_stochastic_matches_the_eager_single_device(models, mesh):
    """Seeded stochastic rows through the sharded logits equal the port's
    eager one-device decode seed for seed (the JAX test's oracle)."""
    got, _, _, _ = _port(models, mesh, LEGACY)
    eager, _, _, _ = _port(models, None, dict(LEGACY, decode="eager"))
    assert got == eager


@pytest.mark.parametrize("settings", [LEGACY, RAGGED],
                         ids=["legacy", "ragged"])
def test_sharded_bf16_pools_match_unsharded(models, mesh, settings):
    """bf16 pools: the sharded write casts at storage as the unsharded
    one does, so the streams equal the unsharded port's and the JAX mesh
    engine's."""
    mode = "legacy" if settings is LEGACY else "ragged"
    want, _ = _jax(models, mode, kv_dtype="bfloat16")
    got, _, _, _ = _port(models, mesh, settings, kv_dtype="bfloat16")
    single, _, _, _ = _port(models, None, settings, kv_dtype="bfloat16")
    assert got == single == want


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("mode,settings", [("legacy", LEGACY),
                                           ("ragged", RAGGED)])
def test_sharded_engine_both_pool_layouts(models, mesh, layout, mode,
                                          settings):
    """The kernel layout shards on its head axis (axis 0) and stays a
    drop-in; per-shard pool bytes are 1/tp of the one-device pool's."""
    want, _ = _jax(models, mode)
    got, _, _, eng = _port(models, mesh, settings, pool_layout=layout)
    _, _, _, single = _port(models, None, settings, pool_layout=layout)
    assert got == want
    shards = eng.cache.bytes_per_shard()
    assert len(shards) == TP
    assert all(b * TP == single.cache.bytes_per_shard()[0] for b in shards)


def test_sharded_step_is_one_dispatch_one_sync(models, mesh):
    """Every shard's work of a legacy decode step is ONE step call: the
    per-shard attention and the all-reduces live inside it."""
    eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, mesh=mesh, **LEGACY),
        start=False)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=8)
    eng.step()
    for _ in range(3):
        eng.step()
        stats = eng.metrics.snapshot()
        assert stats["generation.decode_dispatches_per_step"] == 1
        assert stats["generation.decode_host_syncs_per_step"] <= 1
    eng.run_until_idle()
    first = eng._fused.compile_count
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=8)
    eng.run_until_idle()
    # repeat traffic through seen buckets adds no signature
    assert eng._fused.compile_count == first
    eng.shutdown()


def test_sharded_failed_step_recovery_keeps_serving(models, mesh):
    """A step dying after its writes leaves the cache on fresh SHARDED
    storage, and later requests decode correctly."""
    eng = pgen.GenerationEngine(models[1], pgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, mesh=mesh, **LEGACY),
        start=False)
    fused = eng._fused
    real = dict(fused._fns)

    def dying(fn):
        def step(*args):
            fn(*args)
            raise RuntimeError("device fell over mid-step")
        return step

    fused._fns = {g: dying(fn) for g, fn in real.items()}
    old = [p for entry in eng.cache.take_pool_state() for p in entry]
    eng.start()
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="mid-step"):
            h.result(timeout=30)
        with eng._lock:
            fused._fns = real
            kp, _ = eng.cache.layer_pools(0)
            assert isinstance(kp, list) and len(kp) == TP
            new = [p for entry in eng.cache.take_pool_state()
                   for p in entry]
            assert not ({p.data_ptr() for p in new}
                        & {p.data_ptr() for p in old})
        h2 = eng.submit([1, 2, 3], max_new_tokens=6)
        assert list(h2.tokens(timeout=30)) == greedy_oracle(
            models[0], [1, 2, 3], 6)
    finally:
        eng.shutdown()


def test_mesh_metrics_in_snapshot(models, mesh):
    """generation.mesh_devices, collective_bytes_per_step (2 all-reduces
    a layer over the padded [B, d_model] fp32 block, ring factor
    2(N-1)/N: the JAX formula and value) and collective_quantized in the
    snapshot; an unsharded engine reports 1, 0 and 0."""
    m = models[1]
    d_model = m.num_heads * m.head_dim
    want = int(2 * m.num_layers * (4 * d_model * 4) * 2 * (TP - 1) / TP)
    for pkg, model, cfg in (
            (jgen, models[0], dict(mesh=jax_tp_mesh(TP))),
            (pgen, models[1], dict(mesh=mesh, **LEGACY))):
        eng = pkg.GenerationEngine(model, pkg.GenerationConfig(
            max_decode_slots=4, num_pages=64, page_size=4, **cfg),
            start=False)
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=6)
        eng.step()
        eng.step()
        stats = eng.metrics.snapshot()
        assert stats["generation.mesh_devices"] == TP
        assert stats["generation.collective_bytes_per_step"] == want
        assert stats["generation.collective_quantized"] == 0
        eng.run_until_idle()
        eng.shutdown()
    _, _, snap, _ = _port(models, None, RAGGED)
    assert snap["generation.mesh_devices"] == 1
    assert snap["generation.collective_bytes_per_step"] == 0
    assert snap["generation.collective_quantized"] == 0


def test_sharded_config_validation(models, mesh):
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="fused"):
        pgen.GenerationEngine(models[1], pgen.GenerationConfig(
            mesh=mesh, step_mode="legacy", decode="eager"), start=False)
    with pytest.raises(ValueError, match="tp_axis"):
        pgen.GenerationConfig(mesh=mesh, tp_axis="warp")
    with pytest.raises(ValueError, match="without a mesh"):
        pgen.GenerationConfig(tp_axis="model", **cpu)
    with pytest.raises(ValueError, match="TPMesh"):
        pgen.GenerationConfig(mesh=object(), **cpu)
    # heads not divisible by the mesh axis: typed at engine build
    odd = pgen.TinyCausalLM(vocab_size=16, num_layers=1, num_heads=3,
                            head_dim=4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pgen.GenerationEngine(odd, pgen.GenerationConfig(mesh=mesh),
                              start=False)
    # the engine's device is the mesh's first
    with pytest.raises(ValueError, match="first device"):
        pgen.GenerationEngine(models[1], pgen.GenerationConfig(
            mesh=tp_mesh(TP, devices=["meta"] * TP), **cpu), start=False)
    cfg = pgen.GenerationConfig(mesh=mesh)
    assert cfg.device == "cpu" and cfg.tp_axis == "model"
    eng = pgen.GenerationEngine(models[1], cfg, start=False)
    assert (eng.tp_degree, eng.tp_axis, eng.mesh) == (TP, "model", mesh)
    eng.shutdown()


# ----------------------- the ragged step on the mesh ------------------------


def test_ragged_mesh_token_identical(models, mesh):
    """test_ragged_step.py's and test_mesh_kernels.py's ragged mesh
    engine: greedy and seeded stochastic streams equal the JAX mesh
    engine's and the port's single-device engine's, at one call and at
    most one host sync per step, with the mesh's gauges."""
    want, _ = _jax(models, "ragged")
    got, _, snap, eng = _port(models, mesh, RAGGED)
    single, _, _, _ = _port(models, None, RAGGED)
    assert got == want == single
    assert snap["generation.decode_dispatches_per_step"] == 1
    assert snap["generation.decode_host_syncs_per_step"] <= 1
    assert snap["generation.mesh_devices"] == TP
    assert snap["generation.collective_bytes_per_step"] > 0
    assert snap["generation.kernel_path"] == "ragged:torch-reference"


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_ragged_mesh_layouts_and_preemption(models, mesh, layout):
    """Both layouts on a thrashing pool with 2-token chunks: greedy
    streams equal the oracle."""
    got, results, _, eng = _run(pgen, models[1], dict(
        mesh=mesh, prefill_chunk_tokens=2, num_pages=10,
        pool_layout=layout), new=8, stochastic=False)
    for toks, p in zip(got, PROMPTS):
        assert toks == greedy_oracle(models[0], p, 8)
    assert sum(r.preemptions for r in results) > 0
    assert eng.cache.utilization() == 0.0


def test_ragged_mesh_prefix_warm_identical(models, mesh):
    """Warm starts through the sharded ragged step: warm equals cold
    equals the JAX warm mesh engine, with real aliasing."""
    def run(pkg, model, cfg):
        eng = pkg.GenerationEngine(model, pkg.GenerationConfig(
            max_decode_slots=4, num_pages=64, page_size=4, **cfg),
            start=False)
        outs, hits = [], []
        for sfx in ([7, 7], [5, 5]):
            h = eng.submit(SYSTEM + sfx, max_new_tokens=6)
            eng.run_until_idle()
            outs.append(h.result(timeout=5).token_ids)
            hits.append(h.prefix_hit_tokens)
        eng.shutdown()
        return outs, hits

    want, jhits = run(jgen, models[0], dict(
        JAX_OF["ragged"], mesh=jax_tp_mesh(TP), prefix_cache=True))
    warm, hits = run(pgen, models[1], dict(RAGGED, mesh=mesh,
                                           prefix_cache=True))
    cold, cold_hits = run(pgen, models[1], dict(RAGGED, mesh=mesh))
    assert warm == cold == want
    assert hits == jhits and hits[1] >= 8 and cold_hits == [0, 0]


# ------------------------ int8 pools, quantized ring ------------------------


def test_int8_mesh_token_identity(models, mesh):
    """int8 pools on the mesh (scales head-sharded): streams equal the
    JAX int8 mesh engine's and the port's single-device int8 engine's,
    greedy and seeded stochastic."""
    want, _ = _jax(models, "ragged", kv_dtype="int8")
    got, _, snap, _ = _port(models, mesh, RAGGED, kv_dtype="int8")
    single, _, _, _ = _port(models, None, RAGGED, kv_dtype="int8")
    assert got == want == single
    assert snap["generation.mesh_devices"] == TP


def test_quantized_collectives_engine(models, mesh):
    """The quantized ring cuts collective_bytes_per_step >= 3x, stamps
    collective_quantized 1 (0 on its float32-collective sibling), keeps
    >= 0.99 greedy agreement with the sibling, and equals the JAX
    quantized-collective mesh engine's streams."""
    kw = dict(RAGGED, kv_dtype="int8")
    base, _, snap_fp, _ = _port(models, mesh, kw)
    quant, _, snap_q, _ = _port(models, mesh, kw, quantized_collectives=True)
    want, jsnap = _jax(models, "ragged", kv_dtype="int8",
                       quantized_collectives=True)
    assert snap_fp["generation.collective_quantized"] == 0
    assert snap_q["generation.collective_quantized"] == 1
    fp_bytes = snap_fp["generation.collective_bytes_per_step"]
    q_bytes = snap_q["generation.collective_bytes_per_step"]
    assert fp_bytes / q_bytes >= 3.0, (fp_bytes, q_bytes)
    assert q_bytes == jsnap["generation.collective_bytes_per_step"]
    total = sum(len(t) for t in base)
    agree = sum(x == y for tb, tq in zip(base, quant)
                for x, y in zip(tb, tq))
    assert agree / total >= 0.99, (agree, total, base, quant)
    assert quant == want
    # inert without a mesh: the flag reads 0
    _, _, snap_one, _ = _port(models, None, kw, quantized_collectives=True)
    assert snap_one["generation.collective_quantized"] == 0
    assert snap_one["generation.collective_bytes_per_step"] == 0
