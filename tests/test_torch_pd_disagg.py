"""Port parity: prefill/decode disaggregation as a routing policy, and
cancel, on the port's fleet (paddle_tpu_torch.serving).

A prefill-class replica parks every sequence the moment its prompt is
consumed (a live-migration snapshot: page bytes, the sampling stream,
counters) and the router places it on a decode-class sibling: zero
replayed tokens, every stream (greedy and seeded stochastic) equal to
the JAX single-engine oracle on the same weights.  Role is a routing
preference: long prompts prefer the prefill class, short ones the decode
class, all-mixed fleets never hand off.  Handoffs move through the
stepped collection and the watchdog backstop, survive the prefill
replica's death, and cancel cleanly wherever the request lives (a slot,
the queue, a parked handoff).  The cases follow the JAX package's P/D
tests.
"""
import time

import numpy as np
import pytest

from paddle_tpu import generation as jgen
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                            ReplicaSpec)

from dist_capability import (SUBPROC_SKIP_REASON,  # noqa: E402
                             subprocess_replicas_available)
from gen_oracle import greedy_oracle  # noqa: E402

needs_subproc = pytest.mark.skipif(
    not subprocess_replicas_available(), reason=SUBPROC_SKIP_REASON)

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 12 tokens
LONG = [SYSTEM + [7, 7], SYSTEM + [1], SYSTEM + [9, 9, 9], SYSTEM + [2]]


@pytest.fixture(autouse=True)
def _fresh_fleet_stats():
    reg = StatRegistry.instance()
    for name in list(reg.stats()):
        if name.startswith(fleet_mod.PREFIX):
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


def _ref(models, prompt, n):
    return greedy_oracle(models[0], prompt, n)


def _stat(name):
    return StatRegistry.instance().get_stat(name).get()


def _split_fleet(models, threshold=8, n_decode=1, transport="inproc",
                 **fleet_kw):
    """One prefill replica and `n_decode` decode replicas; the threshold
    makes every LONG prompt prefill-class work."""
    specs = [ReplicaSpec("pf0", models[1], _cfg(), role="prefill",
                         transport=transport)]
    specs += [ReplicaSpec(f"dc{i}", models[1], _cfg(), role="decode",
                          transport=transport) for i in range(n_decode)]
    kw = dict(start=True, seed=0, pd_prefill_threshold_tokens=threshold)
    kw.update(fleet_kw)
    return FleetRouter(specs, FleetConfig(**kw))


def _requests_per_replica(fl):
    snap = fl.stats_snapshot()
    return {n: r.get("generation", {}).get("generation.requests_total", 0)
            for n, r in snap["replicas"].items()}


# ------------------------------ the split path -----------------------------


def test_split_fleet_token_identity_zero_replay(models):
    fl = _split_fleet(models)
    try:
        hs = [fl.submit(p, max_new_tokens=8) for p in LONG]
        for p, h in zip(LONG, hs):
            r = h.result(timeout=60)
            assert r.token_ids == _ref(models, p, 8)
            assert r.finish_reason == "length"
            assert list(h.tokens(timeout=1)) == r.token_ids
        assert _stat(fleet_mod.PD_HANDOFFS) == len(LONG)
        assert _stat(fleet_mod.PD_HANDOFF_TOKENS) >= len(LONG)
        assert _stat(fleet_mod.PD_HANDOFF_WALL_S) >= 0.0
        assert _stat(fleet_mod.ROUTED_ROLE) == len(LONG)
        assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == 0
        assert _stat(fleet_mod.LIVE_MIGRATED_TOTAL) == len(LONG)
        # the prefill replica sampled exactly each stream's first token
        pf = fl._replicas["pf0"].engine.metrics.snapshot()
        assert pf["generation.tokens_total"] == len(LONG)
    finally:
        fl.shutdown()


def test_split_fleet_stochastic_stream_through_handoff(models):
    """The sampling stream rides the snapshot: the decode side continues
    the stream the prefill side started, equal to one JAX engine's."""
    fl = _split_fleet(models)
    try:
        h = fl.submit(SYSTEM, max_new_tokens=10,
                      sampling=pgen.SamplingParams(temperature=0.8, top_k=6,
                                                   seed=77))
        got = h.result(timeout=60).token_ids
    finally:
        fl.shutdown()
    eng = jgen.GenerationEngine(models[0], jgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True),
        start=False)
    ho = eng.submit(SYSTEM, max_new_tokens=10,
                    sampling=jgen.SamplingParams(temperature=0.8, top_k=6,
                                                 seed=77))
    eng.run_until_idle()
    assert got == ho.result(timeout=10).token_ids
    assert _stat(fleet_mod.PD_HANDOFFS) == 1
    eng.shutdown()


def test_role_threshold_segregates_traffic(models):
    fl = _split_fleet(models, threshold=10)
    try:
        short = [fl.submit([5, 6], max_new_tokens=4) for _ in range(3)]
        longs = [fl.submit(p, max_new_tokens=4) for p in LONG[:2]]
        for h in short:
            assert h.result(timeout=60).token_ids == _ref(models, [5, 6], 4)
        for h, p in zip(longs, LONG[:2]):
            assert h.result(timeout=60).token_ids == _ref(models, p, 4)
        per = _requests_per_replica(fl)
        assert per["pf0"] == 2
        assert per["dc0"] == 5   # 3 short + 2 imported continuations
        assert _stat(fleet_mod.PD_HANDOFFS) == 2
        assert _stat(fleet_mod.ROUTED_ROLE) >= 5
    finally:
        fl.shutdown()


def test_mixed_ablation_never_hands_off(models):
    specs = [ReplicaSpec(f"m{i}", models[1], _cfg()) for i in range(2)]
    fl = FleetRouter(specs, FleetConfig(start=True, seed=0,
                                        pd_prefill_threshold_tokens=8))
    try:
        hs = [fl.submit(p, max_new_tokens=8) for p in LONG]
        for p, h in zip(LONG, hs):
            assert h.result(timeout=60).token_ids == _ref(models, p, 8)
        assert _stat(fleet_mod.PD_HANDOFFS) == 0
        assert _stat(fleet_mod.ROUTED_ROLE) == 0
    finally:
        fl.shutdown()


def test_stepped_fleet_collects_handoffs_without_threads(models):
    fl = _split_fleet(models, start=False)
    try:
        h = fl.submit(SYSTEM, max_new_tokens=6)
        fl.run_until_idle()
        assert h.result(timeout=10).token_ids == _ref(models, SYSTEM, 6)
        assert _stat(fleet_mod.PD_HANDOFFS) == 1
        assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == 0
    finally:
        fl.shutdown()


def test_watchdog_backstop_collects_when_poke_disabled(models):
    fl = _split_fleet(models, watchdog_interval_s=0.05)
    try:
        fl._replicas["pf0"].transport.engine.on_handoff = None
        h = fl.submit(SYSTEM, max_new_tokens=6)
        assert h.result(timeout=30).token_ids == _ref(models, SYSTEM, 6)
        assert _stat(fleet_mod.PD_HANDOFFS) == 1
    finally:
        fl.shutdown()


def test_prefill_death_after_handoff_loses_nothing(models):
    fl = _split_fleet(models, start=False)
    try:
        h = fl.submit(SYSTEM, max_new_tokens=8)
        pf = fl._replicas["pf0"]
        eng = pf.transport.engine
        eng.on_handoff = None
        for _ in range(50):
            if eng.handoffs_pending():
                break
            eng.step()
        assert eng.handoffs_pending()
        assert eng.load_info()["idle"] is False   # parked work is work
        pf.state = "dead"
        for item in pf.transport.take_handoffs():
            fl._place_handoff(item, exclude="pf0")
        fl.run_until_idle()
        assert h.result(timeout=10).token_ids == _ref(models, SYSTEM, 8)
        assert _stat(fleet_mod.PD_HANDOFFS) == 1
        assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == 0
    finally:
        fl.shutdown()


def test_parked_handoffs_leave_with_a_drain(models):
    """An engine's parked snapshots ride its drain: live, as snapshots;
    cold, as requests with their emitted count."""
    for live in (True, False):
        eng = pgen.GenerationEngine(models[1], _cfg(), start=False)
        eng.enable_handoff()
        h = eng.submit(SYSTEM, max_new_tokens=8)
        while not eng.handoffs_pending():
            eng.step()
        cold, snaps = eng.drain_work(migrate=True, live=live)
        if live:
            assert cold == [] and len(snaps) == 1
            assert snaps[0]["future"] is h and snaps[0]["n_generated"] == 1
        else:
            assert snaps == [] and len(cold) == 1
            assert cold[0][0].future is h and cold[0][1] == 1
        assert not h.done()


@pytest.mark.slow
@needs_subproc
def test_prefill_sigkill_over_proc_streams_complete(models):
    fl = _split_fleet(models, transport="proc", n_decode=1,
                      respawn_backoff_s=0.05, heartbeat_dead_after=2.0,
                      watchdog_interval_s=0.1)
    try:
        hs = [fl.submit(p, max_new_tokens=8) for p in LONG]
        time.sleep(0.2)
        fl._replicas["pf0"].transport.kill()
        for p, h in zip(LONG, hs):
            assert h.result(timeout=120).token_ids == _ref(models, p, 8)
        dc = fl._replicas["dc0"].transport
        dc.flush_prefix()
        deadline = time.monotonic() + 30
        while dc.stats()["cache"]["pages_in_use"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
            dc.flush_prefix()
    finally:
        fl.shutdown()


# ---------------------------------- cancel ---------------------------------


def test_engine_cancel_active_stream_frees_everything(models):
    eng = pgen.GenerationEngine(models[1], _cfg(), start=False)
    h = eng.submit(SYSTEM, max_new_tokens=200)
    for _ in range(6):
        eng.step()
    assert eng.cancel(h) is True
    r = h.result(timeout=10)
    assert r.finish_reason == "cancelled"
    oracle = _ref(models, SYSTEM, max(1, len(r.token_ids)))
    assert r.token_ids == oracle[:len(r.token_ids)]
    assert eng.cancel(h) is False
    eng.run_until_idle()
    eng.cache.flush_prefix_cache()
    assert eng.cache.stats()["pages_in_use"] == 0
    eng.shutdown()


def test_engine_cancel_queued_request_never_hangs(models):
    eng = pgen.GenerationEngine(models[1], _cfg(), start=False)
    victim = eng.submit(SYSTEM, max_new_tokens=8)
    assert eng.cancel(victim) is True
    r = victim.result(timeout=10)
    assert r.finish_reason == "cancelled" and r.token_ids == []
    survivor = eng.submit(SYSTEM, max_new_tokens=8)
    eng.run_until_idle()
    assert survivor.result(timeout=10).token_ids == _ref(models, SYSTEM, 8)
    eng.shutdown()


def test_engine_cancel_drops_a_parked_handoff(models):
    """A snapshot parked for a handoff and not yet collected cancels: the
    client gets its first token and "cancelled", and nothing is left
    parked."""
    eng = pgen.GenerationEngine(models[1], _cfg(), start=False)
    eng.enable_handoff()
    h = eng.submit(SYSTEM, max_new_tokens=8)
    while not eng.handoffs_pending():
        eng.step()
    assert eng.cancel(h) is True
    r = h.result(timeout=10)
    assert r.finish_reason == "cancelled"
    assert r.token_ids == _ref(models, SYSTEM, 1)
    assert not eng.handoffs_pending() and eng.take_handoffs() == []
    assert eng.cache.pages_in_use == eng.cache.prefix_cached_pages
    eng.shutdown()


def test_inproc_transport_cancel_paths(models):
    fl = FleetRouter([ReplicaSpec("solo", models[1], _cfg())],
                     FleetConfig(start=True, seed=0))
    try:
        rep = fl._replicas["solo"]
        h = fl.submit(SYSTEM, max_new_tokens=300)
        deadline = time.monotonic() + 30
        while not rep.transport.cancel(h):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert h.result(timeout=10).finish_reason == "cancelled"
        assert rep.transport.cancel(h) is False
    finally:
        fl.shutdown()
