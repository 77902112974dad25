"""Port parity: the fleet tier (paddle_tpu_torch.serving.fleet).

The port's FleetRouter over in-process replicas of the port's engine on
the CPU, every stream held to the JAX single-engine oracle on the same
weights (greedy: the JAX model's full recompute; seeded stochastic: one
JAX engine), token for token, through every routing outcome: prefix
affinity, the session rung, least-loaded, spill and shed, random
routing, capacity routing, drains (queued, mid-stream, without
migration, past the drain budget), restart, deadlines, started worker
threads and the latency-aware load score.  ``stats_snapshot`` carries
the JAX fleet's keys.  The cases follow the JAX package's fleet tests.
"""
import threading

import numpy as np
import pytest
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.profiler.monitor import StatRegistry as JStatRegistry
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.admission import (DeadlineExceededError,
                                                RequestTooLargeError,
                                                ServerBusyError)
from paddle_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                            ReplicaSpec)

from gen_oracle import greedy_oracle  # noqa: E402

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 3 full pages at PS=4
PROMPTS = [SYSTEM + [7, 7], SYSTEM + [1], SYSTEM + [9, 9, 9], SYSTEM]


@pytest.fixture(autouse=True)
def _fresh_fleet_stats():
    for reg, prefix in ((StatRegistry.instance(), fleet_mod.PREFIX),
                        (JStatRegistry.instance(), jfleet.PREFIX)):
        for name in list(reg.stats()):
            if name.startswith(prefix):
                reg.get_stat(name).reset()
    yield


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


def _cfg(**kw):
    return pgen.GenerationConfig(**{**dict(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True,
        device="cpu"), **kw})


def _fleet(models, n=2, routing="affinity", cfgs=None, start=False,
           model=None, **cfg_kw):
    cfgs = cfgs or [_cfg(**cfg_kw) for _ in range(n)]
    specs = [ReplicaSpec(f"r{i}", model or models[1], c)
             for i, c in enumerate(cfgs)]
    return FleetRouter(specs, FleetConfig(routing=routing, start=start,
                                          seed=0))


def _ref(models, prompt, n):
    return greedy_oracle(models[0], prompt, n)


def _stat(name):
    return StatRegistry.instance().get_stat(name).get()


def _requests_per_replica(fl):
    snap = fl.stats_snapshot()
    return {n: r.get("generation", {}).get("generation.requests_total", 0)
            for n, r in snap["replicas"].items() if "generation" in r}


# ------------------------------ routing ladder -----------------------------


def test_submit_streams_and_matches_single_replica_oracle(models):
    fl = _fleet(models)
    hs = []
    for p in PROMPTS:
        hs.append(fl.submit(p, max_new_tokens=8))
        fl.run_until_idle()
    for p, h in zip(PROMPTS, hs):
        assert h.result(timeout=5).token_ids == _ref(models, p, 8)
    assert list(hs[-1].tokens(timeout=1)) == hs[-1].result().token_ids
    fl.shutdown()


def test_prefix_affinity_converges_same_system_prompt(models):
    fl = _fleet(models)
    hs = []
    for p in PROMPTS[:3]:
        hs.append(fl.submit(p, max_new_tokens=8))
        fl.run_until_idle()
    for p, h in zip(PROMPTS, hs):
        assert h.result(timeout=5).token_ids == _ref(models, p, 8)
    counts = _requests_per_replica(fl)
    assert sorted(counts.values()) == [0, 3], counts
    assert _stat(fleet_mod.ROUTED_PREFIX) == 3
    assert all(h.prefix_hit_tokens > 0 for h in hs[1:])
    assert _stat(fleet_mod.PREFIX_ROUTED_MISSED) == 1
    assert _stat(fleet_mod.PREFIX_ROUTED_CONFIRMED) == 2
    fl.shutdown()


def test_session_affinity_pins_multi_turn_conversation(models):
    fl = _fleet(models)
    p1 = SYSTEM + [7, 7]
    h1 = fl.submit(p1, max_new_tokens=8, session="s1")
    fl.run_until_idle()
    answer = h1.result(timeout=5).token_ids
    assert answer == _ref(models, p1, 8)
    pinned = fl.replica_of("s1")
    assert pinned is not None
    p2 = p1 + answer + [2, 4]
    h2 = fl.submit(p2, max_new_tokens=8, session="s1")
    fl.run_until_idle()
    assert h2.result(timeout=5).token_ids == _ref(models, p2, 8)
    assert fl.replica_of("s1") == pinned
    assert _stat(fleet_mod.ROUTED_AFFINITY) == 1
    assert h2.prefix_hit_tokens > len(p1)   # into the answer's pages
    fl.shutdown()


def test_short_prompts_route_least_loaded(models):
    fl = _fleet(models)
    fl.submit([1, 2, 3], max_new_tokens=2)
    fl.submit([4, 5, 6], max_new_tokens=2)
    assert _stat(fleet_mod.ROUTED_BALANCE) == 2
    depths = [r["queue_depth"]
              for r in fl.stats_snapshot()["replicas"].values()]
    assert sorted(depths) == [1, 1]
    fl.run_until_idle()
    fl.shutdown()


def test_spill_then_shed_only_when_every_gate_closed(models):
    fl = _fleet(models, queue_depth=1)
    fl.submit(SYSTEM + [7, 7], max_new_tokens=4)
    h2 = fl.submit(SYSTEM + [1], max_new_tokens=4)
    assert _stat(fleet_mod.ROUTED_SPILL) == 1
    assert _stat(fleet_mod.SHED_TOTAL) == 0
    with pytest.raises(ServerBusyError):
        fl.submit(SYSTEM + [9, 9, 9], max_new_tokens=4)
    assert _stat(fleet_mod.SHED_TOTAL) == 1
    fl.run_until_idle()
    h3 = fl.submit(SYSTEM + [9, 9, 9], max_new_tokens=4)
    fl.run_until_idle()
    assert h3.result(timeout=5).token_ids == \
        _ref(models, SYSTEM + [9, 9, 9], 4)
    assert h2.result(timeout=5).token_ids == _ref(models, SYSTEM + [1], 4)
    fl.shutdown()


def test_prefix_routing_is_measured_not_assumed(models):
    fl = _fleet(models)
    h1 = fl.submit(SYSTEM + [7], max_new_tokens=4)
    fl.run_until_idle()
    h1.result(timeout=5)
    home = max(_requests_per_replica(fl).items(), key=lambda kv: kv[1])[0]
    fl._replicas[home].engine.cache.flush_prefix_cache()
    missed = _stat(fleet_mod.PREFIX_ROUTED_MISSED)
    h2 = fl.submit(SYSTEM + [8], max_new_tokens=4)
    fl.run_until_idle()
    assert h2.result(timeout=5).token_ids == _ref(models, SYSTEM + [8], 4)
    assert h2.prefix_hit_tokens == 0
    assert _stat(fleet_mod.PREFIX_ROUTED_MISSED) == missed + 1
    fl.shutdown()


def test_random_routing_is_the_ablation_baseline(models):
    fl = _fleet(models, routing="random")
    hs = []
    for p in PROMPTS[:2]:
        hs.append(fl.submit(p, max_new_tokens=8, session="sx"))
        fl.run_until_idle()
    for p, h in zip(PROMPTS, hs):
        assert h.result(timeout=5).token_ids == _ref(models, p, 8)
    assert _stat(fleet_mod.ROUTED_AFFINITY) == 0
    assert _stat(fleet_mod.ROUTED_PREFIX) == 0
    assert _stat(fleet_mod.ROUTED_RANDOM) == 2
    fl.shutdown()


def test_heterogeneous_fleet_routes_by_capacity(models):
    fl = _fleet(models, cfgs=[_cfg(num_pages=4), _cfg(num_pages=64)])
    long_prompt = [int(t) for t in
                   np.random.default_rng(0).integers(0, 48, 40)]
    h = fl.submit(long_prompt, max_new_tokens=4)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == _ref(models, long_prompt, 4)
    counts = _requests_per_replica(fl)
    assert counts["r1"] == 1 and counts["r0"] == 0
    with pytest.raises(RequestTooLargeError):
        fl.submit([1] * 300, max_new_tokens=4)
    fl.shutdown()


# ------------------------------ drain / restart ----------------------------


def test_drain_migrates_queued_requests_cold(models):
    fl = _fleet(models)
    hs = [fl.submit(p, max_new_tokens=8) for p in PROMPTS[:3]]
    home = max(fl.stats_snapshot()["replicas"].items(),
               key=lambda kv: kv[1].get("queue_depth", 0))[0]
    fl.drain(home)
    assert _stat(fleet_mod.MIGRATED_TOTAL) == 3
    fl.run_until_idle()
    for p, h in zip(PROMPTS, hs):
        assert h.result(timeout=5).token_ids == _ref(models, p, 8)
    assert fl.stats_snapshot()["replicas"][home] == {"state": "stopped"}
    h = fl.submit(SYSTEM, max_new_tokens=4)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM, 4)
    fl.shutdown()


def test_midstream_drain_resubmit_token_identity(models):
    """Greedy and seeded stochastic requests drained mid-stream resume on
    the sibling; the client sees one stream identical to one JAX
    engine's, with no gap and no duplicate."""
    fl = _fleet(models)
    p_greedy, p_stoch = SYSTEM + [7, 7], SYSTEM + [1]
    hg = fl.submit(p_greedy, max_new_tokens=10, session="s1")
    hs = fl.submit(p_stoch, max_new_tokens=10, session="s1",
                   sampling=pgen.SamplingParams(temperature=0.9, top_k=10,
                                                top_p=0.9, seed=123))
    eng = fl._replicas[fl.replica_of("s1")].engine
    for _ in range(8):
        eng.step()
    assert any(s.n_generated > 0 for s in eng.scheduler.active())
    fl.drain(fl.replica_of("s1"), migrate=True)
    fl.run_until_idle()
    rg, rs = hg.result(timeout=5), hs.result(timeout=5)
    assert rg.token_ids == _ref(models, p_greedy, 10)
    cold = jgen.GenerationEngine(models[0], jgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True),
        start=False)
    hc = cold.submit(p_stoch, max_new_tokens=10,
                     sampling=jgen.SamplingParams(temperature=0.9, top_k=10,
                                                  top_p=0.9, seed=123))
    cold.run_until_idle()
    assert rs.token_ids == hc.result(timeout=5).token_ids
    cold.shutdown()
    assert list(hg.tokens(timeout=1)) == rg.token_ids
    assert list(hs.tokens(timeout=1)) == rs.token_ids
    assert _stat(fleet_mod.MIGRATED_TOTAL) >= 2
    fl.shutdown()


def test_drain_without_migration_lets_residents_finish(models):
    fl = _fleet(models)
    h = fl.submit(SYSTEM + [7, 7], max_new_tokens=8, session="s1")
    home = fl.replica_of("s1")
    for _ in range(3):
        fl._replicas[home].engine.step()
    fl.drain(home, migrate=False)
    assert h.result(timeout=5).token_ids == \
        _ref(models, SYSTEM + [7, 7], 8)
    assert _stat(fleet_mod.MIGRATED_TOTAL) == 0
    assert fl._replicas[home].state == "stopped"
    fl.shutdown()


def test_drain_timeout_migrates_stragglers_instead_of_wedging(models):
    fl = _fleet(models)
    h = fl.submit(SYSTEM + [7, 7], max_new_tokens=8, session="s1")
    home = fl.replica_of("s1")
    for _ in range(3):
        fl._replicas[home].engine.step()
    fl.drain(home, migrate=False, timeout=0)
    assert fl._replicas[home].state == "stopped"
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == \
        _ref(models, SYSTEM + [7, 7], 8)
    assert _stat(fleet_mod.MIGRATED_TOTAL) == 1
    fl.restart(home)
    assert fl._replicas[home].state == "serving"
    fl.shutdown()


def test_restart_rebuilds_replica_from_spec(models):
    fl = _fleet(models)
    fl.drain("r0")
    fl.restart("r0")
    assert fl._replicas["r0"].state == "serving"
    assert fl._replicas["r0"].engine.cache.pages_in_use == 0
    fl.drain("r1")
    h = fl.submit(SYSTEM, max_new_tokens=4)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM, 4)
    assert _requests_per_replica(fl)["r0"] == 1
    fl.shutdown()


def test_add_and_remove_replica_at_runtime(models):
    fl = _fleet(models, n=1)
    fl.add_replica(ReplicaSpec("r9", models[1], _cfg()))
    assert fl._replicas["r9"].state == "serving"
    fl.drain("r0")
    h = fl.submit(SYSTEM + [2], max_new_tokens=4)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM + [2], 4)
    fl.remove_replica("r0")
    assert "r0" not in fl._replicas
    fl.shutdown()


# --------------------------- contract / observability ----------------------


def test_deadline_error_passes_through_the_fleet(models):
    fl = _fleet(models)
    h = fl.submit(SYSTEM, max_new_tokens=4, timeout_ms=0)
    fl.run_until_idle()
    with pytest.raises(DeadlineExceededError):
        h.result(timeout=1)
    fl.shutdown()


def _snapshot_after_traffic(fl, n_reps):
    hs = [fl.submit([1, 2, 3], max_new_tokens=2),
          fl.submit([4, 5, 6], max_new_tokens=2)]
    fl.run_until_idle()
    for h in hs:
        h.result(timeout=30)
    return fl.stats_snapshot()


def test_stats_snapshot_schema_matches_jax(models, monkeypatch):
    """The capacity-planning export: the same top-level keys, the same
    fleet.* names and the same per-replica entry keys as the JAX
    fleet's, after the same traffic; generation and cache stats per
    replica.  Each package's fleet counts into a fresh process registry
    here, so no other test's replica names appear."""
    monkeypatch.setattr(StatRegistry, "_instance", StatRegistry())
    monkeypatch.setattr(JStatRegistry, "_instance", JStatRegistry())
    fl = _fleet(models)
    snap = _snapshot_after_traffic(fl, 2)
    fl.shutdown()
    jspecs = [jfleet.ReplicaSpec(f"r{i}", models[0], jgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True))
        for i in range(2)]
    jfl = jfleet.FleetRouter(jspecs, jfleet.FleetConfig(start=False,
                                                        seed=0))
    jsnap = _snapshot_after_traffic(jfl, 2)
    jfl.shutdown()
    assert set(snap) == set(jsnap)
    assert set(snap["fleet"]) == set(jsnap["fleet"])
    for name in ("r0", "r1"):
        rep = snap["replicas"][name]
        assert set(rep) == set(jsnap["replicas"][name])
        assert rep["state"] == "serving" and rep["transport"] == "inproc"
        assert "generation.requests_total" in rep["generation"]
        assert "pages_in_use" in rep["cache"]
        assert f"{fleet_mod.REPLICA_QUEUE_DEPTH}.{name}" in snap["fleet"]
    assert snap["fleet"][fleet_mod.ROUTED_BALANCE] == \
        jsnap["fleet"][jfleet.ROUTED_BALANCE] == 2


def test_thread_based_replicas_with_started_workers(models):
    fl = _fleet(models, start=True)
    hs = [fl.submit(p, max_new_tokens=4, session=f"w{i}")
          for i, p in enumerate(PROMPTS[:2])]
    for p, h in zip(PROMPTS, hs):
        assert h.result(timeout=30).token_ids == _ref(models, p, 4)
    fl.shutdown()


# ----------------------------- engine drain hooks --------------------------


def test_engine_evacuate_extracts_queue_then_actives(models):
    eng = pgen.GenerationEngine(models[1], _cfg(max_decode_slots=1,
                                                prefix_cache=False),
                                start=False)
    h1 = eng.submit(SYSTEM + [7, 7], max_new_tokens=8)
    h2 = eng.submit(SYSTEM + [1], max_new_tokens=8)
    h3 = eng.submit(SYSTEM, max_new_tokens=8)
    for _ in range(4):
        eng.step()
    queued = eng.evacuate(include_active=False)
    assert [r.prompt for r, _ in queued] == [SYSTEM + [1], SYSTEM]
    assert all(emitted == 0 for _, emitted in queued)
    assert len(eng.scheduler.active()) == 1
    active = eng.evacuate(include_active=True)
    assert len(active) == 1
    req, emitted = active[0]
    assert req.prompt == SYSTEM + [7, 7] and emitted > 0
    assert not eng.scheduler.active()
    assert eng.cache.pages_in_use == 0
    assert not (h1.done() or h2.done() or h3.done())
    eng.shutdown()


def test_engine_fleet_hooks_describe_load_and_step_progress(models):
    """describe and load_info carry the router's keys; step_seq counts
    completed steps and in_step is False between them; a caller's handle
    keeps its preset submitted_s and gets done callbacks."""
    import os

    eng = pgen.GenerationEngine(models[1], _cfg(), start=False)
    d = eng.describe()
    assert d["pid"] == os.getpid() and d["device"] == "cpu"
    assert (d["page_size"], d["num_pages"], d["max_decode_slots"]) == \
        (4, 64, 4)
    assert eng.load_info() == {"queue_depth": 0, "active": 0,
                               "pages_in_use": 0, "num_pages": 64,
                               "idle": True}
    h = pgen.GenerationHandle()
    h.submitted_s = 123.0
    seen = []
    h.add_done_callback(seen.append)
    assert eng.submit(SYSTEM, max_new_tokens=4, handle=h) is h
    assert eng.load_info()["queue_depth"] == 1
    steps = eng.run_until_idle()
    assert eng.step_seq == steps and eng.in_step is False
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM, 4)
    assert h.submitted_s == 123.0 and seen == [h] and h.n_streamed == 4
    eng.shutdown()


def test_latency_aware_load_prefers_fast_replica(models):
    fl = _fleet(models)
    r0, r1 = fl._replicas["r0"], fl._replicas["r1"]
    warm = [fl.submit([1, 2, 3], max_new_tokens=1),
            fl.submit([4, 5, 6], max_new_tokens=1)]
    fl.run_until_idle()
    for h in warm:
        h.result(timeout=10)
    r0.ttft_ewma, r1.ttft_ewma = 0.50, 0.01
    assert r0.load(0.01) > r1.load(0.01)
    assert r0.load(0.01) - r1.load(0.01) <= r0._TTFT_LOAD_CAP
    assert r0.load(None) == pytest.approx(r1.load(None))
    before = _requests_per_replica(fl)
    for _ in range(3):
        h = fl.submit([1, 2, 3], max_new_tokens=1)
        fl.run_until_idle()
        h.result(timeout=10)
        r0.ttft_ewma, r1.ttft_ewma = 0.50, 0.01
    after = _requests_per_replica(fl)
    assert after["r0"] == before["r0"], (before, after)
    assert after["r1"] == before["r1"] + 3, (before, after)
    assert fl.stats_snapshot()["replicas"]["r1"]["ttft_ewma_s"] is not None
    fl.shutdown()


def test_slow_replica_sheds_new_traffic_under_skewed_prompts():
    long_model = pgen.TinyCausalLM(vocab_size=48, num_layers=2, num_heads=2,
                                   head_dim=8, max_positions=600, seed=3,
                                   device="cpu")
    fl = _fleet(None, model=long_model,
                cfgs=[_cfg(num_pages=256, prefix_cache=False)
                      for _ in range(2)])
    rng = np.random.default_rng(5)
    long_prompt = rng.integers(1, 40, 400).tolist()
    h = fl.submit(long_prompt, max_new_tokens=1, session="slow")
    fl.run_until_idle()
    h.result(timeout=10)
    slow_name = fl.replica_of("slow")
    fast_name = next(n for n in fl._replicas if n != slow_name)
    fl._sessions["fast"] = fast_name
    h = fl.submit([1, 2], max_new_tokens=1, session="fast")
    fl.run_until_idle()
    h.result(timeout=10)
    slow, fast = fl._replicas[slow_name], fl._replicas[fast_name]
    assert slow.ttft_ewma > fast.ttft_ewma
    before = _requests_per_replica(fl)
    for _ in range(4):
        h = fl.submit(rng.integers(1, 40, 3).tolist(), max_new_tokens=1)
        fl.run_until_idle()
        h.result(timeout=10)
    after = _requests_per_replica(fl)
    assert after[fast_name] - before[fast_name] == 4
    assert after[slow_name] == before[slow_name]
    fl.shutdown()


def test_fifo_engine_lock_serves_waiters_in_order():
    """A waiter on the engine's step lock gets it before the holder can
    take it back (the stepping worker's release and re-acquire), so a
    fleet's import or cancel waits one step, not many."""
    from paddle_tpu_torch.generation.engine import _FifoLock

    lock = _FifoLock()
    order = []
    lock.acquire()
    started = threading.Event()

    def waiter():
        started.set()
        with lock:
            order.append("waiter")

    t = threading.Thread(target=waiter)
    t.start()
    started.wait()
    while lock._tickets < 2:   # the waiter has its ticket
        pass
    lock.release()
    with lock:                 # the holder asks again at once
        order.append("holder")
    t.join()
    assert order == ["waiter", "holder"]


def test_shared_counters_and_the_engine_lock_under_thread_stress():
    """More threads than cores, a shortened switch interval: the kernel
    launch counts (counted from every in-process replica's worker
    thread, a capturing thread recording its own apart) and the engine
    lock lose no update."""
    import os
    import sys

    from paddle_tpu_torch.generation.engine import _FifoLock
    from paddle_tpu_torch.ops import paged_attention as pa

    w = pa.ragged_paged_attention_kernel
    n_threads, n_each = 2 * (os.cpu_count() or 2) + 2, 300
    lock, box, recorded = _FifoLock(), [0], []
    before = (w.launches, w.launches_by_dtype["float32"])

    def work(i):
        if i == 0:   # one thread records, as a capture does
            with pa.recording_launches() as rec:
                for _ in range(n_each):
                    pa._count(w, "float32")
            recorded.append(rec)
            return
        for _ in range(n_each):
            pa._count(w, "float32")
            with lock:
                v = box[0]
                box[0] = v + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    want = (n_threads - 1) * n_each
    assert box[0] == want
    assert (w.launches - before[0],
            w.launches_by_dtype["float32"] - before[1]) == (want, want)
    assert recorded[0][w][0] == n_each
    pa.add_launches(recorded[0])
    assert w.launches - before[0] == want + n_each
