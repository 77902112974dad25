"""The fleet tier's engine hooks on the card.  Every test here is marked
``cuda`` and skips without a card (decided inside the test, never at
import).  On a machine with one (JAX not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_fleet.py
"""
import pytest
import torch

from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import FleetConfig, FleetRouter, ReplicaSpec

pytestmark = pytest.mark.cuda

SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engines run the CUDA kernels")


def _model():
    return pgen.TinyCausalLM(vocab_size=48, num_layers=2, num_heads=2,
                             head_dim=8, seed=3)


def _cfg(**kw):
    return pgen.GenerationConfig(**{**dict(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True),
        **kw})


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_live_migration_round_trip_between_card_engines_is_bitwise(
        kv_dtype, layout):
    """A mid-decode resident exported from one card engine and imported
    into another: its pages on the importer, exported again, are bitwise
    the snapshot's (scales too), and both streams then finish alike."""
    _need_card()
    model = _model()
    a = pgen.GenerationEngine(model, _cfg(kv_dtype=kv_dtype,
                                          pool_layout=layout), start=False)
    ref = pgen.GenerationEngine(model, _cfg(kv_dtype=kv_dtype,
                                            pool_layout=layout), start=False)
    h = a.submit(SYSTEM + [7, 7], max_new_tokens=10)
    hr = ref.submit(SYSTEM + [7, 7], max_new_tokens=10)
    for _ in range(6):
        a.step()
    _, live = a.evacuate_for_migration()
    (snap,) = live
    assert snap["k"].device.type == "cpu"
    b = pgen.GenerationEngine(model, _cfg(kv_dtype=kv_dtype,
                                          pool_layout=layout), start=False)
    assert b.import_sequence(snap)
    st = next(s for s in b.scheduler.active() if s.handle is h)
    again = b.cache.export_pages(b.cache.page_table(st.seq_id))
    fields = ("k", "v", "k_scale", "v_scale")[:len(again)]
    for field, got in zip(fields, again):
        assert torch.equal(got, snap[field]), field
    b.run_until_idle()
    ref.run_until_idle()
    assert h.result(timeout=30).token_ids == hr.result(timeout=30).token_ids
    for eng in (a, b, ref):
        eng.shutdown()


def test_two_loop_replicas_serve_concurrently_without_a_capture_error():
    """Two in-process card replicas with loop_steps=4 on their worker
    threads, both capturing their loops while the other steps: every
    stream finishes, equal to one engine's at N=1, and the ragged
    launches equal num_layers x the replicas' steps and loop calls."""
    _need_card()
    model = _model()
    prompts = [SYSTEM + [i, i + 1] for i in range(8)]
    one = pgen.GenerationEngine(model, _cfg(), start=False)
    hs = [one.submit(p, max_new_tokens=12) for p in prompts]
    one.run_until_idle()
    want = [h.result(timeout=30).token_ids for h in hs]
    one.shutdown()
    fl = FleetRouter([ReplicaSpec(f"l{i}", model, _cfg(loop_steps=4))
                      for i in range(2)],
                     FleetConfig(start=True, seed=0, routing="random"))
    engines = [fl._replicas[n].engine for n in ("l0", "l1")]
    steps = [0, 0]
    for i, eng in enumerate(engines):
        real = eng._ragged.step

        def counted(*args, i=i, real=real):
            steps[i] += 1
            return real(*args)

        eng._ragged.step = counted
    loop0 = [(e._loop.replays, e._loop.captures) for e in engines]
    pa.ragged_paged_attention_kernel.launches = 0
    try:
        hs = [fl.submit(p, max_new_tokens=12) for p in prompts]
        got = [h.result(timeout=120).token_ids for h in hs]
        assert got == want
        calls = sum(e._loop.loop_steps * (e._loop.replays - r
                                          + e._loop.captures - c)
                    for e, (r, c) in zip(engines, loop0))
        assert pa.ragged_paged_attention_kernel.launches == \
            2 * (sum(steps) + calls)
        assert sum(e._loop.captures for e in engines) >= 2
    finally:
        fl.shutdown()

