"""Port parity: the serving features on a tensor-parallel mesh.

Speculative decoding, the host-free decode loop, prefix caching (the
ragged step, the legacy chunked step and the one-shot modes' eager warm
suffix), page export and import, the page codec, the chaos import drill
and a fleet's live drain, each on the port's mesh engine or sharded pool
(``tp_mesh(4, devices=["cpu"] * 4)``), held token for token to the JAX
package's mesh engine (``tp_mesh(4)`` over the conftest's forced host
devices) and to the port's single-device engine, and byte for byte where
pages move: a page exported from a sharded pool is the page an unsharded
pool exports.  Each JAX engine runs once, memoized at module scope.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.parallel import tp_mesh as jax_tp_mesh
from paddle_tpu.serving.disagg import pagecodec as jcodec
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import metrics as pmetrics
from paddle_tpu_torch.parallel import tp_mesh
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.disagg import pagecodec as pcodec
from paddle_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                            ReplicaSpec)

from gen_oracle import greedy_oracle  # noqa: E402  cross-module memo

TP = 4
MODEL = dict(vocab_size=48, num_layers=2, num_heads=4, head_dim=8, seed=3)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11]]
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 3 full pages at PS=4
WARM = [SYSTEM + [7, 7], SYSTEM + [1], SYSTEM + [9, 9, 9], SYSTEM]
BASE = dict(max_decode_slots=4, num_pages=64, page_size=4)


@pytest.fixture(autouse=True)
def _fresh_port_stats():
    reg = StatRegistry.instance()
    for name in list(reg.stats()):
        if name.startswith((pmetrics.PREFIX, fleet_mod.PREFIX)):
            reg.get_stat(name).reset()
    yield


def _port_model(jmodel, heads):
    tree = {k: np.asarray(v) if not isinstance(v, list) else
            [{n: np.asarray(a) for n, a in b.items()} for b in v]
            for k, v in jmodel.decode_params().items()}
    return pgen.TinyCausalLM.from_numpy_params(tree, num_heads=heads,
                                               seed=jmodel.seed,
                                               device="cpu")


@pytest.fixture(scope="module")
def models():
    jmodel = jgen.TinyCausalLM(**MODEL)
    return jmodel, _port_model(jmodel, MODEL["num_heads"])


@pytest.fixture(scope="module")
def mesh():
    return tp_mesh(TP, devices=["cpu"] * TP)


def _sampling(pkg, i):
    return (pkg.SamplingParams() if i % 2 else
            pkg.SamplingParams(temperature=0.8, top_k=8, seed=11 + i))


def _serve(pkg, model, cfg, prompts=PROMPTS, new=10, stochastic=False,
           sequential=False):
    """Serve `prompts` on one engine until idle (one at a time with
    `sequential`, so later prompts see the earlier ones' cache)."""
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(
        **{**BASE, **cfg}), start=False)
    hs = []
    for i, p in enumerate(prompts):
        hs.append(eng.submit(p, max_new_tokens=new,
                             sampling=(_sampling(pkg, i) if stochastic
                                       else pkg.SamplingParams())))
        if sequential:
            eng.run_until_idle()
    eng.run_until_idle()
    out = [h.result(timeout=5).token_ids for h in hs]
    snap = eng.stats()
    eng.shutdown()
    return out, hs, snap, eng


_JAX = {}


def _jax(models, key, cfg, **kw):
    """A JAX mesh engine's streams and snapshot, run once per module."""
    if key not in _JAX:
        out, hs, snap, _ = _serve(jgen, models[0],
                                  {**cfg, "mesh": jax_tp_mesh(TP)}, **kw)
        _JAX[key] = out, [h.prefix_hit_tokens for h in hs], snap
    return _JAX[key]


# ------------------------ speculation, the loop ---------------------------


def test_spec_mesh_4dev_token_identical(models, mesh):
    """Speculation through the sharded ragged step: token-identical to
    the JAX speculating mesh engine and to the port's unsharded
    non-speculative engine, with drafts accepted, per-shard pools at 1/tp,
    one call and at most one sync per step."""
    want, _, _ = _jax(models, "spec", dict(
        kv_backend="device", step_mode="ragged", prefill_chunk_tokens=3,
        spec_mode="ngram"), new=12)
    got, _, snap, eng = _serve(pgen, models[1], dict(
        mesh=mesh, prefill_chunk_tokens=3, spec_mode="ngram"), new=12)
    single, _, _, one = _serve(pgen, models[1], dict(
        device="cpu", prefill_chunk_tokens=3), new=12)
    assert got == want == single
    assert snap["generation.spec_accepted_tokens"] > 0
    assert snap["generation.decode_dispatches_per_step"] == 1
    assert snap["generation.decode_host_syncs_per_step"] <= 1
    assert snap["generation.mesh_devices"] == TP
    k_shards, _ = eng.cache.layer_pools(0)
    assert all(s.numel() * TP == one.cache.layer_pools(0)[0].numel()
               for s in k_shards)


def test_truncate_refcount_drain_mesh():
    """The drain invariant on the sharded pool: truncate is bookkeeping
    only, and every page comes back."""
    cache = pgen.DeviceKVPool(2, 4, 8, num_pages=16, page_size=4,
                              mesh=tp_mesh(TP, devices=["cpu"] * TP))
    cache.allocate("a")
    cache.reserve("a", 10)
    assert cache.truncate("a", 3) == 2
    cache.free("a")
    cache.flush_prefix_cache()
    assert cache.num_free_pages == cache.num_pages


def test_loop_mesh_token_identical(models, mesh):
    """The host-free loop (N=4) on the mesh: token-identical to the JAX
    mesh loop and to the port's unsharded N=1 run, greedy and seeded
    stochastic, with the collective traffic of each iteration counted as
    the JAX loop counts it."""
    loop = dict(prefill_chunk_tokens=3, num_pages=128, loop_steps=4)
    want, _, jsnap = _jax(models, "loop", dict(
        loop, kv_backend="device", step_mode="ragged"), stochastic=True)
    got, _, snap, _ = _serve(pgen, models[1], dict(loop, mesh=mesh),
                             stochastic=True)
    single, _, _, _ = _serve(pgen, models[1], dict(
        loop, loop_steps=1, device="cpu"), stochastic=True)
    assert got == want == single
    assert snap["generation.mesh_devices"] == TP
    assert snap["generation.collective_bytes_per_step"] > 0
    assert snap["generation.collective_bytes_per_step"] == \
        jsnap["generation.collective_bytes_per_step"]
    assert snap["generation.decode_host_fetches_per_token"] <= 1 / 2


# ---------------------------- prefix caching ------------------------------


@pytest.mark.parametrize("mode", ["chunked", "one_shot", "ragged"])
def test_warm_token_identical_on_mesh(models, mesh, mode):
    """Warm starts over a shared system prompt on the mesh (the legacy
    chunked step, the one-shot modes' eager warm suffix through the
    per-shard chunk call, and the ragged step): every prompt after the
    first hits the cache, and the streams equal the JAX warm mesh
    engine's and the port's cold single-device engine's."""
    port_cfg, jax_cfg = {
        "chunked": (dict(step_mode="legacy", decode="fused",
                         prefill_chunk_tokens=3),
                    dict(jit_prefill=True, prefill_chunk_tokens=3)),
        "one_shot": (dict(step_mode="legacy", decode="fused",
                          prefill_chunk_tokens=0), {}),
        "ragged": (dict(prefill_chunk_tokens=3),
                   dict(kv_backend="device", step_mode="ragged",
                        prefill_chunk_tokens=3))}[mode]
    want, jhits, _ = _jax(models, "warm-" + mode,
                          dict(jax_cfg, prefix_cache=True), prompts=WARM,
                          new=8, sequential=True)
    got, hs, snap, _ = _serve(pgen, models[1], dict(
        port_cfg, mesh=mesh, prefix_cache=True), prompts=WARM, new=8,
        sequential=True)
    cold, _, _, _ = _serve(pgen, models[1], dict(port_cfg, device="cpu"),
                           prompts=WARM, new=8, sequential=True)
    assert got == want == cold
    hits = [h.prefix_hit_tokens for h in hs]
    assert hits == jhits and all(h > 0 for h in hits[1:])
    assert snap["generation.prefix_cache_hit_tokens"] == sum(hits)


# ------------------------- pages crossing pools ---------------------------


def _filled(pkg, layout, dtype, mesh=None, heads=4, tokens=11, seed=5):
    """A pool of `pkg` holding sequence "src" of `tokens` seeded rows."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, tokens, heads, 8)).astype(np.float32)
    v = rng.standard_normal((2, tokens, heads, 8)).astype(np.float32)
    if pkg is jgen:
        pool = jgen.DeviceKVPool(2, heads, 8, num_pages=8, page_size=4,
                                 dtype=np.dtype(dtype), pool_layout=layout,
                                 mesh=mesh)
        pool.allocate("src")
        pool.append_prefill("src", k, v)
        return pool
    pool = pgen.DeviceKVPool(2, heads, 8, num_pages=8, page_size=4,
                             dtype=getattr(torch, dtype), pool_layout=layout,
                             device="cpu", mesh=mesh)
    pool.allocate("src")
    pool.reserve("src", tokens)
    pool.write_prefill_batch(["src"], [0], [tokens],
                             torch.from_numpy(k[None]),
                             torch.from_numpy(v[None]))
    return pool


def _export(pool):
    return [torch.as_tensor(np.asarray(x))
            for x in pool.export_pages(pool.page_table("src"))]


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_export_import_bitwise_mesh(mesh, layout, dtype):
    """A head-sharded pool exports the canonical payload of an unsharded
    one and of the JAX sharded pool, bit for bit (int8 scales included),
    and an import into a sharded pool re-installs it bitwise: its
    gathered rows are the unsharded pool's, its storage still the shard
    lists."""
    sharded = _filled(pgen, layout, dtype, mesh)
    plain = _filled(pgen, layout, dtype)
    jsharded = _filled(jgen, layout, dtype, jax_tp_mesh(TP))
    sp = _export(sharded)
    for a, b, c in zip(sp, _export(plain), _export(jsharded)):
        assert torch.equal(a, b) and torch.equal(a, c)
    dst = pgen.DeviceKVPool(2, 4, 8, num_pages=8, page_size=4,
                            dtype=getattr(torch, dtype), pool_layout=layout,
                            mesh=mesh)
    pages = dst.import_pages(*sp)
    for a, b in zip(sp, dst.export_pages(pages)):
        assert torch.equal(a, b)
    dst.allocate("imp")
    dst.adopt_imported("imp", pages, 11)
    for a, b in zip(dst.gather_prefix("imp", 0, 11),
                    plain.gather_prefix("src", 0, 11)):
        assert torch.equal(a, b)
    kp, _ = dst.layer_pools(0)
    assert isinstance(kp, list) and len(kp) == TP
    if dtype == "int8":
        ks, _ = dst.layer_scales(0)
        assert isinstance(ks, list) and all(s.shape[1] == 1 for s in ks)


@pytest.mark.parametrize("level", ["delta", "raw"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_codec_roundtrip_bitwise_sharded_mesh(mesh, layout, level):
    """The canonical payload a sharded pool exports roundtrips bitwise
    through the page codec, and its wire frames are the JAX codec's for
    the JAX sharded pool's payload."""
    def payload(pool):
        out = pool.export_pages(pool.page_table("src"))
        return {"tokens": list(range(8)), "k": out[0], "v": out[1]}

    pp = payload(_filled(pgen, layout, "float32", mesh))
    jp = payload(_filled(jgen, layout, "float32", jax_tp_mesh(TP)))
    penc = pcodec.encode_payload(pp, level)
    dec = pcodec.decode_payload(penc)
    assert list(dec["tokens"]) == pp["tokens"]
    for f in ("k", "v"):
        assert dec[f].dtype == pp[f].dtype
        assert torch.equal(dec[f], pp[f])
    jenc = jcodec.encode_payload({k: (np.asarray(v) if k != "tokens"
                                      else v) for k, v in jp.items()},
                                 level)
    for f in ("k", "v"):
        assert penc[f]["data"] == jenc[f]["data"]


def test_import_failure_consistent_on_mesh():
    """The chaos drill on the mesh: a live-migration import that dies
    mid-install gives every imported page back (pages_in_use 0), a retry
    adopts the snapshot, and the stream completes as the oracle's."""
    jmodel = jgen.TinyCausalLM(vocab_size=32, num_layers=2, num_heads=4,
                               head_dim=8, seed=5)
    model4 = _port_model(jmodel, 4)
    cfg = pgen.GenerationConfig(
        **BASE, prefix_cache=True, step_mode="legacy", decode="fused",
        prefill_chunk_tokens=0, mesh=tp_mesh(TP, devices=["cpu"] * TP))
    a = pgen.GenerationEngine(model4, cfg, start=False)
    h = a.submit(SYSTEM + [2], max_new_tokens=6)
    for _ in range(4):
        a.step()
    _, live = a.evacuate_for_migration()
    snap = live[0]
    b = pgen.GenerationEngine(model4, cfg, start=False)
    orig = b.cache.adopt_imported
    calls = []

    def boom(*args, **kwargs):
        if not calls:
            calls.append(1)
            raise RuntimeError("chaos: killed mid-install")
        return orig(*args, **kwargs)

    b.cache.adopt_imported = boom
    assert b.import_sequence(dict(snap)) is False
    assert b.cache.pages_in_use == 0
    b.cache.adopt_imported = orig
    assert b.import_sequence(snap) is True
    b.run_until_idle()
    assert h.result(timeout=5).token_ids == \
        greedy_oracle(jmodel, SYSTEM + [2], 6)
    a.shutdown()
    b.shutdown()


def test_fleet_live_drain_of_mesh_replicas(models, mesh):
    """Two in-process replicas, each a mesh engine: a drain in mid-decode
    migrates its residents LIVE (sequence snapshots through the canonical
    payload, zero replayed tokens), and every stream is the oracle's; a
    subprocess replica refuses a mesh config."""
    cfg = dict(BASE, prefix_cache=True, mesh=mesh)
    fl = FleetRouter([ReplicaSpec(f"r{i}", models[1],
                                  pgen.GenerationConfig(**cfg))
                      for i in range(2)],
                     FleetConfig(start=False, seed=0))
    hs = [fl.submit(p, max_new_tokens=10, session="s")
          for p in WARM[:2]]
    home = fl.replica_of("s")
    eng = fl._replicas[home].engine
    for _ in range(6):
        eng.step()
    assert any(s.n_generated > 0 for s in eng.scheduler.active())
    fl.drain(home, migrate=True)
    fl.run_until_idle()
    for p, h in zip(WARM, hs):
        assert h.result(timeout=5).token_ids == greedy_oracle(
            models[0], p, 10)
    reg = StatRegistry.instance()
    assert reg.get_stat(fleet_mod.LIVE_MIGRATED_TOTAL).get() >= 1
    assert reg.get_stat(fleet_mod.MIGRATED_REPLAY_TOKENS).get() == 0
    fl.shutdown()
    with pytest.raises(ValueError, match="process boundary"):
        FleetRouter([ReplicaSpec("p", models[1],
                                 pgen.GenerationConfig(**cfg),
                                 transport="proc")],
                    FleetConfig(start=False))
