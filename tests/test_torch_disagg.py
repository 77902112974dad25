"""Port parity: the disaggregated fleet (paddle_tpu_torch.serving.disagg).

The port's wire formats against the JAX package's: RPC frames (plain and
chunked) byte for byte, the page codec's ``data`` bytes at both levels
for float32, bfloat16 and int8 payloads (and the port decoding the JAX
package's frames), ``page_chain_hashes``, and ``FleetPrefixIndex`` op for
op.  Then the port's engines and fleets on the CPU against the JAX
single-engine oracle (greedy: the JAX model's full recompute; seeded
stochastic: one JAX engine), token for token: live migration resuming in
mid-decode with zero re-prefill, ``import_sequence`` refusing without
capacity, an in-process drain with zero replayed tokens, page adoption
over the peer-to-peer data plane, and subprocess replicas (token
identity, adoption, a SIGKILL remigrating every stream).  The weights
move from the JAX model as numpy.
"""
import itertools
import pickle
import random
import socket
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import generation as jgen
from paddle_tpu.serving.disagg import page_service as jps
from paddle_tpu.serving.disagg import pagecodec as jcodec
from paddle_tpu.serving.disagg import rpc as jrpc
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation.metrics import GenerationMetrics
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.admission import ServingError
from paddle_tpu_torch.serving.disagg import page_service as pps
from paddle_tpu_torch.serving.disagg import pagecodec as pcodec
from paddle_tpu_torch.serving.disagg import rpc as prpc
from paddle_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                            ReplicaSpec)

from dist_capability import (SUBPROC_SKIP_REASON,  # noqa: E402
                             subprocess_replicas_available)
from gen_oracle import greedy_oracle  # noqa: E402

needs_subproc = pytest.mark.skipif(
    not subprocess_replicas_available(), reason=SUBPROC_SKIP_REASON)

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 3 full pages at PS=4


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


_STOCH = {}


def _stoch_ref(models, prompt, n, seed):
    """The JAX package's seeded-stochastic single-engine stream
    (memoized: each JAX engine pays its compiles)."""
    key = (tuple(prompt), n, seed)
    if key not in _STOCH:
        _STOCH[key] = _stoch_run(models, prompt, n, seed)
    return _STOCH[key]


def _stoch_run(models, prompt, n, seed):
    eng = jgen.GenerationEngine(models[0], jgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, prefix_cache=True),
        start=False)
    h = eng.submit(prompt, max_new_tokens=n, sampling=jgen.SamplingParams(
        temperature=0.9, top_k=10, seed=seed))
    eng.run_until_idle()
    out = h.result(timeout=30).token_ids
    eng.shutdown()
    return out


def _stoch(seed):
    return pgen.SamplingParams(temperature=0.9, top_k=10, seed=seed)


def _fleet(models, n=2, transport="inproc", cfgs=None, start=False,
           **fleet_kw):
    cfgs = cfgs or [_cfg() for _ in range(n)]
    specs = [ReplicaSpec(f"d{i}", models[1], c, transport=transport)
             for i, c in enumerate(cfgs)]
    return FleetRouter(specs, FleetConfig(start=start, seed=0, **fleet_kw))


def _stat(name):
    return StatRegistry.instance().get_stat(name).get()


def _requests_per_replica(fl):
    snap = fl.stats_snapshot()
    return {n: r.get("generation", {}).get("generation.requests_total", 0)
            for n, r in snap["replicas"].items() if "generation" in r}


# ------------------------------- rpc framing -------------------------------


class _Wire:
    """A socket stand-in that keeps every byte written to it."""

    def __init__(self):
        self.data = bytearray()

    def sendall(self, b):
        self.data += b


@pytest.mark.parametrize("msg", [
    {"op": "submit", "rid": 7, "sid": 3, "prompt": [1, 2, 3],
     "kwargs": {"max_new_tokens": 8, "timeout_ms": None}},
    {"ev": "token", "sid": 3, "t": 42, "n": 0},
    {"resp": 7, "ok": {"queue_depth": 0, "idle": True, "pages": (1, 2)}},
    {"ev": "hb", "load": {"active": 2}, "seq": 17, "in_step": False,
     "deltas": [("add", 123456789), ("drop", 5)], "data": ("127.0.0.1", 9)},
])
@pytest.mark.parametrize("chunk", [None, 16])
def test_rpc_frames_byte_equal_to_jax(msg, chunk, monkeypatch):
    """The same plain message writes the same wire bytes through both
    packages' send_frame, whole and fragmented (fragment ids counted from
    1 in both)."""
    monkeypatch.setattr(jrpc, "_frag_ids", itertools.count(1))
    monkeypatch.setattr(prpc, "_frag_ids", itertools.count(1))
    jw, pw = _Wire(), _Wire()
    jrpc.send_frame(jw, msg, chunk_bytes=chunk)
    prpc.send_frame(pw, msg, chunk_bytes=chunk)
    assert bytes(pw.data) == bytes(jw.data)
    frames, off = 0, 0
    while off < len(pw.data):
        (n,) = prpc._HEADER.unpack_from(pw.data, off)
        off += prpc._HEADER.size + n
        frames += 1
    assert (frames > 1) == bool(chunk)   # fragmented only when asked


def test_rpc_frame_roundtrip_fragments_and_eof():
    """The port's codec end to end over a socketpair: a chunked payload
    reassembles exactly around an unrelated frame, an out-of-order
    fragment poisons the channel typed, and a closed peer reads as
    ChannelClosed."""
    a, b = socket.socketpair()
    try:
        big = {"op": "import_seq", "snap": bytes(range(256)) * 20}
        prpc.send_frame(a, big, chunk_bytes=512)
        frames = []
        b.settimeout(0.5)
        try:
            while True:
                frames.append(prpc.recv_frame(b))
        except (socket.timeout, TimeoutError):
            pass
        assert len(frames) > 1 and all(len(f["data"]) <= 512
                                       for f in frames)
        asm = prpc.FrameAssembler()
        assert asm.feed(frames[0]) is None
        assert asm.feed({"ev": "hb"}) == {"ev": "hb"}
        out = None
        for f in frames[1:]:
            out = asm.feed(f)
        assert out == big
        with pytest.raises(ValueError, match="out of order"):
            prpc.FrameAssembler().feed(frames[1])
        prpc.send_frame(a, {"second": True})
        b.settimeout(None)
        assert prpc.recv_frame(b) == {"second": True}
        a.close()
        with pytest.raises(prpc.ChannelClosed):
            prpc.recv_frame(b)
    finally:
        b.close()


def _tcp_pair():
    """A loopback TCP connection through the port's ReplicaListener."""
    from paddle_tpu_torch.serving.disagg.tcp import ReplicaListener

    listener = ReplicaListener()
    client = socket.create_connection(listener.address, timeout=5)
    server = listener.accept(timeout=5)
    listener.close()
    return client, server


def test_frames_over_loopback_tcp_survive_partial_reads_and_eof():
    """Over a real TCP connection: a frame round trips, a frame dribbled
    3 bytes at a time decodes to one object, and a peer closing in
    mid-frame reads as ChannelClosed."""
    import threading

    client, server = _tcp_pair()
    try:
        prpc.send_frame(client, {"op": "ping", "rid": 1})
        assert prpc.recv_frame(server) == {"op": "ping", "rid": 1}
        payload = pickle.dumps({"ev": "token", "t": 42, "n": 0})
        wire = prpc._HEADER.pack(len(payload)) + payload

        def dribble():
            for i in range(0, len(wire), 3):
                client.sendall(wire[i:i + 3])
                time.sleep(0.001)

        th = threading.Thread(target=dribble, daemon=True)
        th.start()
        assert prpc.recv_frame(server) == {"ev": "token", "t": 42, "n": 0}
        th.join(timeout=5)
        assert not th.is_alive()
        client.sendall(wire[:len(wire) // 2])
        client.close()
        with pytest.raises(prpc.ChannelClosed):
            prpc.recv_frame(server)
    finally:
        server.close()


def test_listener_bring_up_failures_are_typed():
    """A port in use, a worker that exits before dialing back, and no
    dial-back before the deadline each raise TcpConnectError."""
    import types

    from paddle_tpu_torch.serving.disagg.tcp import (ReplicaListener,
                                                     TcpConnectError)

    squatter = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    squatter.bind(("127.0.0.1", 0))
    squatter.listen(1)
    try:
        with pytest.raises(TcpConnectError, match="cannot listen"):
            ReplicaListener(port=squatter.getsockname()[1])
    finally:
        squatter.close()
    listener = ReplicaListener()
    try:
        corpse = types.SimpleNamespace(poll=lambda: 1, returncode=1)
        with pytest.raises(TcpConnectError, match="worker exited"):
            listener.accept(timeout=30.0, proc=corpse)
        with pytest.raises(TcpConnectError, match="no dial-back"):
            listener.accept(timeout=0.3)
    finally:
        listener.close()


# -------------------------------- page codec -------------------------------


def _payload(dtype, pages=3, seed=0):
    """The same export payload as (numpy for the JAX codec, torch for the
    port's): K/V ``[L, n, ps, H, D]`` of smooth rows (compressible) and,
    for int8, the ``[L, n, H]`` scales."""
    rng = np.random.default_rng(seed)
    shape = (2, pages, 4, 2, 8)
    base = np.cumsum(rng.standard_normal(shape).astype(np.float32) * 0.05,
                     axis=2)
    if dtype == "int8":
        k = np.clip(np.round(base * 60), -127, 127).astype(np.int8)
        v = np.clip(np.round(-base * 50), -127, 127).astype(np.int8)
        ks = rng.random((2, pages, 2)).astype(np.float32)
        vs = rng.random((2, pages, 2)).astype(np.float32)
        j = {"tokens": list(range(pages * 4)), "k": k, "v": v,
             "k_scale": ks, "v_scale": vs}
        p = {"tokens": list(range(pages * 4)), "k": torch.from_numpy(k),
             "v": torch.from_numpy(v), "k_scale": torch.from_numpy(ks),
             "v_scale": torch.from_numpy(vs)}
        return j, p
    if dtype == "bfloat16":
        kt = torch.from_numpy(base).to(torch.bfloat16)
        vt = torch.from_numpy(-base).to(torch.bfloat16)
        k = kt.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        v = vt.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return ({"tokens": list(range(pages * 4)), "k": k, "v": v},
                {"tokens": list(range(pages * 4)), "k": kt, "v": vt})
    return ({"tokens": list(range(pages * 4)), "k": base, "v": -base},
            {"tokens": list(range(pages * 4)), "k": torch.from_numpy(base),
             "v": torch.from_numpy(-base)})


@pytest.mark.parametrize("level", ["delta", "raw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pagecodec_bytes_equal_to_jax(dtype, level):
    """Each array's wire ``data`` (and its filter, codec and shape) equals
    the JAX codec's for the same payload; the dtype travels by name; the
    port decodes its own frame and the JAX package's bitwise; wire and
    raw byte counts agree."""
    jp, pp = _payload(dtype)
    jenc = jcodec.encode_payload(jp, level)
    penc = pcodec.encode_payload(pp, level)
    assert penc["pv"] == jenc["pv"] and penc["level"] == jenc["level"]
    assert penc["tokens"] == jenc["tokens"]
    for f in ("k", "v", "k_scale", "v_scale"):
        assert (f in penc) == (f in jenc)
        if f not in jenc:
            continue
        for key in ("filter", "codec", "data"):
            assert penc[f][key] == jenc[f][key], (f, key)
        assert tuple(penc[f]["shape"]) == tuple(jenc[f]["shape"])
        assert penc[f]["dtype"] == np.dtype(jenc[f]["dtype"]).name
    if level == "delta":
        assert penc["k"]["filter"] == "delta"   # smooth rows compress
    assert pcodec.wire_bytes(penc) == jcodec.wire_bytes(jenc)
    assert pcodec.raw_bytes(penc) == jcodec.raw_bytes(jenc)
    assert pcodec.payload_nbytes(pp) == jcodec.payload_nbytes(jp)
    for enc in (penc, jenc):
        out = pcodec.decode_payload(enc)
        for f in ("k", "v", "k_scale", "v_scale"):
            if f in pp:
                assert out[f].dtype == pp[f].dtype
                assert torch.equal(out[f].view(torch.uint8)
                                   if out[f].dtype != torch.uint8
                                   else out[f],
                                   pp[f].view(torch.uint8))


def test_pagecodec_incompressible_falls_back_raw_and_errors_typed():
    noise = torch.from_numpy(np.random.default_rng(1).integers(
        -128, 128, (2, 2, 4, 2, 8)).astype(np.int8))
    enc = pcodec.encode_payload({"tokens": [1], "k": noise, "v": noise,
                                 "k_scale": torch.ones(2, 2, 2),
                                 "v_scale": torch.ones(2, 2, 2)})
    assert enc["k"]["filter"] == "raw"
    assert torch.equal(pcodec.decode_payload(enc)["k"], noise)
    assert pcodec.negotiate(1, ("zstd", "raw")) == "raw"
    with pytest.raises(pcodec.PageCodecError):
        pcodec.negotiate(2, ("raw",))
    with pytest.raises(pcodec.PageCodecError):
        pcodec.negotiate(1, ("zstd",))
    bad = dict(enc, pv=9)
    with pytest.raises(pcodec.PageCodecError):
        pcodec.decode_payload(bad)
    broken = {**enc, "k": {**enc["k"], "codec": "lz77"}}
    with pytest.raises(pcodec.PageCodecError):
        pcodec.decode_payload(broken)


# ----------------------- chain hashes and the fleet index ------------------


def test_page_chain_hashes_equal_to_jax():
    rng = np.random.default_rng(3)
    for ps in (1, 4, 16):
        for n in (0, 3, 17, 64):
            toks = rng.integers(0, 50304, n).tolist()
            assert pps.page_chain_hashes(toks, ps) == \
                jps.page_chain_hashes(toks, ps)


def test_chain_hashes_match_the_port_cache_deltas():
    """The deltas the port's cache logs at registration use exactly the
    hashes page_chain_hashes computes from raw tokens."""
    pool = pgen.DeviceKVPool(2, 2, 8, num_pages=16, page_size=4,
                             device="cpu")
    pool.enable_prefix_deltas()
    pool.allocate("s")
    pool.reserve("s", len(SYSTEM))
    pool.register_prefix("s", SYSTEM)
    assert pool.take_prefix_deltas() == [
        ("add", h) for h in pps.page_chain_hashes(SYSTEM, 4)]
    pool.free("s")
    assert pool.flush_prefix_cache() == 3
    assert sorted(h for op, h in pool.take_prefix_deltas()
                  if op == "drop") == sorted(pps.page_chain_hashes(SYSTEM, 4))


def test_fleet_prefix_index_agrees_with_jax_op_for_op():
    """A seeded mix of add/drop deltas, replica drops, compactions and
    lookups (with and without a holder filter) through both indexes:
    every return value and every gauge equal after each op."""
    rng = random.Random(5)
    prompts = [SYSTEM + [i, i + 1, 7, 7, 2] for i in range(6)] + [SYSTEM]
    chains = sorted({h for p in prompts for h in
                     pps.page_chain_hashes(p, 4)})
    names = ["a", "b", "c", "d"]
    j, p = jps.FleetPrefixIndex(), pps.FleetPrefixIndex()
    for _ in range(400):
        op = rng.random()
        if op < 0.45:
            name = rng.choice(names)
            deltas = [(rng.choice(("add", "add", "drop")),
                       rng.choice(chains)) for _ in range(rng.randrange(4))]
            j.apply(name, deltas)
            p.apply(name, deltas)
        elif op < 0.5:
            name = rng.choice(names)
            j.drop_replica(name)
            p.drop_replica(name)
        elif op < 0.55:
            live = rng.sample(names, rng.randrange(1, 4))
            assert p.compact(live) == j.compact(live)
        else:
            prompt = rng.choice(prompts)
            filt = (None if rng.random() < 0.5
                    else set(rng.sample(names, 2)))
            assert p.lookup(prompt, 4, filt) == j.lookup(prompt, 4, filt)
            chain = rng.choice(chains)
            assert p.holders_of(chain) == j.holders_of(chain)
        assert p.chains_held() == j.chains_held()
        assert p.chains_held("a") == j.chains_held("a")
        assert (p.compactions, p.chains_compacted) == \
            (j.compactions, j.chains_compacted)


# ------------------------- engine live migration ---------------------------


def test_engine_live_migration_resumes_mid_decode(models):
    """A mid-decode resident exported from engine A and imported into B
    resumes where it left off: greedy and seeded stochastic streams equal
    the JAX single-engine oracle, B prefills nothing, and the snapshot's
    pages exported again from B are bitwise the snapshot's bytes."""
    p = SYSTEM + [7, 7]
    a = pgen.GenerationEngine(models[1], _cfg(), start=False)
    hg = a.submit(p, max_new_tokens=10)
    hs = a.submit(SYSTEM + [1], max_new_tokens=10, sampling=_stoch(123))
    for _ in range(6):
        a.step()
    assert all(s.n_generated > 0 for s in a.scheduler.active())
    cold, live = a.evacuate_for_migration()
    assert cold == [] and len(live) == 2
    for snap in live:   # host tensors, never device ones
        assert snap["k"].device.type == "cpu"
        assert snap["rng"].counter >= 0
    breg = StatRegistry()
    b = pgen.GenerationEngine(models[1], _cfg(),
                              metrics=GenerationMetrics(registry=breg),
                              start=False)
    for snap in live:
        assert b.import_sequence(snap)
        st = next(s for s in b.scheduler.active()
                  if s.handle is snap["future"])
        again = b.cache.export_pages(b.cache.page_table(st.seq_id))
        assert torch.equal(again[0], snap["k"])
        assert torch.equal(again[1], snap["v"])
    b.run_until_idle()
    assert hg.result(timeout=5).token_ids == _ref(models, p, 10)
    assert hs.result(timeout=5).token_ids == \
        _stoch_ref(models, SYSTEM + [1], 10, 123)
    assert breg.get_stat("generation.prefill_tokens_total").get() == 0
    a.shutdown()
    b.shutdown()


def test_import_sequence_refuses_without_capacity(models):
    """A full engine refuses an import (no slot, or a pool too small even
    after eviction) and stays whole; an int8 engine refuses float32
    pages; the refused snapshot still imports elsewhere and completes
    identically."""
    a = pgen.GenerationEngine(models[1], _cfg(), start=False)
    h = a.submit(SYSTEM + [7, 7], max_new_tokens=8)
    for _ in range(4):
        a.step()
    _, live = a.evacuate_for_migration()
    snap = live[0]
    full = pgen.GenerationEngine(models[1], _cfg(max_decode_slots=1),
                                 start=False)
    hf = full.submit(SYSTEM, max_new_tokens=8)
    for _ in range(3):
        full.step()
    assert full.import_sequence(dict(snap)) is False
    tiny = pgen.GenerationEngine(models[1], _cfg(num_pages=2), start=False)
    assert tiny.import_sequence(dict(snap)) is False
    assert tiny.cache.pages_in_use == 0
    q8 = pgen.GenerationEngine(models[1], _cfg(kv_dtype="int8"),
                               start=False)
    assert q8.import_sequence(dict(snap)) is False
    assert q8.cache.pages_in_use == 0 and not q8.scheduler.active()
    b = pgen.GenerationEngine(models[1], _cfg(), start=False)
    assert b.import_sequence(snap)
    b.run_until_idle()
    assert h is snap["future"]
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM + [7, 7], 8)
    full.run_until_idle()
    assert hf.result(timeout=5).token_ids == _ref(models, SYSTEM, 8)
    for eng in (a, full, tiny, q8, b):
        eng.shutdown()


def test_failed_import_gives_every_page_back(models):
    """A snapshot that fails mid-install (a poisoned field after the
    pages landed) is refused and leaks no page."""
    a = pgen.GenerationEngine(models[1], _cfg(), start=False)
    a.submit(SYSTEM + [7, 7], max_new_tokens=8)
    for _ in range(4):
        a.step()
    _, live = a.evacuate_for_migration()
    b = pgen.GenerationEngine(models[1], _cfg(), start=False)
    assert b.import_sequence(dict(live[0], cache_len=10 ** 6)) is False
    assert b.cache.pages_in_use == 0 and not b.scheduler.active()
    a.shutdown()
    b.shutdown()


# ---------------------------- in-process fleet -----------------------------


def test_inproc_drain_live_migration_zero_replay(models):
    """A drain in mid-decode with live migration on: the streams resume
    on the sibling with zero replayed tokens, identical to the JAX
    oracle, and the client streams are gap- and duplicate-free."""
    fl = _fleet(models)
    hg = fl.submit(SYSTEM + [7, 7], max_new_tokens=10, session="s1")
    hs = fl.submit(SYSTEM + [1], max_new_tokens=10, sampling=_stoch(123),
                   session="s1")
    home = fl.replica_of("s1")
    eng = fl._replicas[home].engine
    for _ in range(8):
        eng.step()
    assert any(s.n_generated > 0 for s in eng.scheduler.active())
    fl.drain(home, migrate=True)
    fl.run_until_idle()
    rg, rs = hg.result(timeout=5), hs.result(timeout=5)
    assert rg.token_ids == _ref(models, SYSTEM + [7, 7], 10)
    assert rs.token_ids == _stoch_ref(models, SYSTEM + [1], 10, 123)
    assert list(hg.tokens(timeout=1)) == rg.token_ids
    assert list(hs.tokens(timeout=1)) == rs.token_ids
    assert _stat(fleet_mod.LIVE_MIGRATED_TOTAL) == 2
    assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == 0
    assert _stat(fleet_mod.MIGRATED_TOTAL) == 2
    fl.shutdown()


def test_cold_resubmit_ablation_counts_replayed_tokens(models):
    fl = _fleet(models, live_migration=False)
    h = fl.submit(SYSTEM + [7, 7], max_new_tokens=10, session="s1")
    home = fl.replica_of("s1")
    eng = fl._replicas[home].engine
    for _ in range(6):
        eng.step()
    emitted = max(s.n_generated for s in eng.scheduler.active())
    assert emitted > 0
    fl.drain(home, migrate=True)
    fl.run_until_idle()
    r = h.result(timeout=5)
    assert r.token_ids == _ref(models, SYSTEM + [7, 7], 10)
    assert list(h.tokens(timeout=1)) == r.token_ids
    assert _stat(fleet_mod.LIVE_MIGRATED_TOTAL) == 0
    assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == emitted
    fl.shutdown()


def test_live_migration_falls_back_cold_when_sibling_full(models):
    fl = _fleet(models, cfgs=[_cfg(max_decode_slots=1) for _ in range(2)])
    blocker = fl.submit(SYSTEM, max_new_tokens=10, session="blk")
    other = fl.replica_of("blk")
    beng = fl._replicas[other].engine
    for _ in range(3):
        beng.step()
    target = next(n for n in fl._replicas if n != other)
    fl._sessions["tgt"] = target
    h = fl.submit(SYSTEM + [7, 7], max_new_tokens=10, session="tgt")
    eng = fl._replicas[target].engine
    for _ in range(6):
        eng.step()
    fl.drain(target, migrate=True)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == \
        _ref(models, SYSTEM + [7, 7], 10)
    assert list(h.tokens(timeout=1)) == h.result().token_ids
    assert _stat(fleet_mod.LIVE_MIGRATED_TOTAL) == 0
    assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) > 0
    assert blocker.result(timeout=5).token_ids == _ref(models, SYSTEM, 10)
    fl.shutdown()


@pytest.mark.parametrize("codec", ["compressed", "raw"])
def test_page_service_adopts_warm_prefix_on_other_replica(models, codec):
    """Replica A registers the prefix; a request pinned to replica B gets
    the run peer to peer and prefills only its suffix: zero page bytes
    through the router, the hit confirmed, the stream the JAX oracle's."""
    fl = _fleet(models, page_codec=codec)
    h1 = fl.submit(SYSTEM + [7], max_new_tokens=4)
    fl.run_until_idle()
    h1.result(timeout=5)
    counts = _requests_per_replica(fl)
    holder = max(counts, key=counts.get)
    other = next(n for n in fl._replicas if n != holder)
    assert counts[other] == 0
    fl._sessions["pin"] = other
    h2 = fl.submit(SYSTEM + [9, 9], max_new_tokens=4, session="pin")
    assert fl.wait_transfers(timeout=10)
    fl.run_until_idle()
    assert h2.result(timeout=5).token_ids == _ref(models, SYSTEM + [9, 9], 4)
    assert h2.prefix_hit_tokens == len(SYSTEM)
    assert _stat(fleet_mod.PAGE_ADOPTIONS) == 1
    assert _stat(fleet_mod.PAGES_ADOPTED) == 3
    assert _stat(fleet_mod.PAGE_RELAY_BYTES) == 0
    assert _stat(fleet_mod.PAGE_P2P_BYTES) > 0
    raw = 2 * 2 * 3 * 4 * 2 * 8 * 4   # K and V of 3 float32 pages
    assert _stat(fleet_mod.PAGE_RAW_BYTES) == raw
    if codec == "raw":
        assert _stat(fleet_mod.PAGE_P2P_BYTES) == raw
    gstats = fl.stats_snapshot()["replicas"][other]["generation"]
    assert gstats["generation.prefill_tokens_total"] == 2
    fl.shutdown()


def test_heartbeat_metrics_and_transport_validation(models):
    fl = _fleet(models)
    snap = fl.stats_snapshot()["fleet"]
    for key in (fleet_mod.REPLICA_HEARTBEAT_AGE,
                fleet_mod.REPLICA_DEAD_TOTAL, fleet_mod.LIVE_MIGRATED_TOTAL,
                fleet_mod.MIGRATED_REPLAY_TOKENS, fleet_mod.PAGE_ADOPTIONS,
                fleet_mod.PAGES_ADOPTED):
        assert key in snap, key
    for name in ("d0", "d1"):
        assert snap[f"{fleet_mod.REPLICA_HEARTBEAT_AGE}.{name}"] == 0.0
    fl.shutdown()
    with pytest.raises(ValueError, match="transport"):
        ReplicaSpec("x", models[1], _cfg(), transport="carrier-pigeon")
    with pytest.raises(ValueError, match="transport"):
        FleetConfig(transport="bogus")
    from paddle_tpu_torch.serving.disagg.transport import SubprocTransport

    with pytest.raises(ValueError, match="process boundary"):
        SubprocTransport(ReplicaSpec("m", models[1], _cfg(mesh=object())))


# ---------------------------- subprocess fleet -----------------------------


@needs_subproc
def test_subproc_fleet_token_identity_and_page_adoption(models):
    """Replicas in child processes (the port's worker, on the CPU its
    config names): greedy and seeded stochastic streams equal the JAX
    oracle, and a warm prefix registered in one child is adopted by the
    other over the data plane."""
    import os

    fl = _fleet(models, transport="proc", async_adoption=False)
    for rep in fl._replicas.values():
        d = rep.transport.describe()
        assert d["pid"] != os.getpid() and d["device"] == "cpu"
    hg = fl.submit(SYSTEM + [7, 7], max_new_tokens=10)
    hs = fl.submit(SYSTEM + [1], max_new_tokens=10, sampling=_stoch(123))
    fl.run_until_idle()
    rg = hg.result(timeout=30)
    assert rg.token_ids == _ref(models, SYSTEM + [7, 7], 10)
    assert hs.result(timeout=30).token_ids == \
        _stoch_ref(models, SYSTEM + [1], 10, 123)
    assert list(hg.tokens(timeout=1)) == rg.token_ids
    lookup = None
    deadline = time.monotonic() + 20
    while lookup is None and time.monotonic() < deadline:
        fl.stats_snapshot()
        lookup = fl._page_index.lookup(SYSTEM + [9], 4)
        if lookup is None:
            time.sleep(0.05)
    assert lookup is not None
    other = next(n for n in fl._replicas if n != lookup[0])
    fl._sessions["pin"] = other
    h3 = fl.submit(SYSTEM + [9], max_new_tokens=4, session="pin")
    fl.run_until_idle()
    assert h3.result(timeout=30).token_ids == _ref(models, SYSTEM + [9], 4)
    assert h3.prefix_hit_tokens == len(SYSTEM)
    assert _stat(fleet_mod.PAGE_ADOPTIONS) >= 1
    assert _stat(fleet_mod.PAGE_RELAY_BYTES) == 0
    assert all(r["transport"] == "proc"
               for r in fl.stats_snapshot()["replicas"].values())
    fl.shutdown()


@pytest.mark.slow
@needs_subproc
def test_subproc_midstream_drain_live_migration_zero_replay(models):
    """A drain in mid-stream of a child replica live-migrates its
    residents over the process boundary (page bytes as host tensors in
    the frames): the sibling child resumes with zero replayed tokens,
    the streams equal the JAX oracle, gap- and duplicate-free."""
    fl = _fleet(models, transport="proc")
    hg = fl.submit(SYSTEM + [7, 7], max_new_tokens=32, session="s1")
    hs = fl.submit(SYSTEM + [1], max_new_tokens=32, sampling=_stoch(77),
                   session="s1")
    home = fl.replica_of("s1")
    tr = fl._replicas[home].transport
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with tr._lock:
            emitted = [e["emitted"] for e in tr._inflight.values()]
        if emitted and min(emitted) >= 3:
            break
        time.sleep(0.02)
    assert emitted and min(emitted) >= 3, "stream never started"
    fl.drain(home, migrate=True)
    fl.run_until_idle()
    rg, rs = hg.result(timeout=60), hs.result(timeout=60)
    assert rg.token_ids == _ref(models, SYSTEM + [7, 7], 32)
    assert rs.token_ids == _stoch_ref(models, SYSTEM + [1], 32, 77)
    assert list(hg.tokens(timeout=1)) == rg.token_ids
    assert list(hs.tokens(timeout=1)) == rs.token_ids
    assert _stat(fleet_mod.LIVE_MIGRATED_TOTAL) >= 1
    assert _stat(fleet_mod.MIGRATED_REPLAY_TOKENS) == 0
    fl.shutdown()


@needs_subproc
def test_subproc_crash_remigrates_queued_and_inflight_typed(models):
    """SIGKILL a child replica: every stream it held completes on the
    sibling, identical to the JAX oracle; the death is counted and the
    slot restarts into a fresh process; a lone replica's death resolves
    its stream with a typed error."""
    fl = _fleet(models, transport="proc")
    prompts = [SYSTEM + [7, 7], SYSTEM + [1], SYSTEM + [9, 9, 9]]
    hs = [fl.submit(p, max_new_tokens=6) for p in prompts]
    loads = {}
    for name, rep in fl._replicas.items():
        with rep.transport._lock:
            loads[name] = len(rep.transport._inflight)
    home = max(loads, key=loads.get)
    fl._replicas[home].transport.kill()
    for p, h in zip(prompts, hs):
        assert h.result(timeout=60).token_ids == _ref(models, p, 6)
    assert _stat(fleet_mod.REPLICA_DEAD_TOTAL) == 1
    assert fl._replicas[home].state == "dead"
    assert fl.stats_snapshot()["replicas"][home] == {"state": "dead"}
    fl.restart(home)
    assert fl._replicas[home].state == "serving"
    h = fl.submit(SYSTEM, max_new_tokens=4)
    fl.run_until_idle()
    assert h.result(timeout=30).token_ids == _ref(models, SYSTEM, 4)
    fl.shutdown()
    fl2 = _fleet(models, n=1, transport="proc")
    h2 = fl2.submit(SYSTEM, max_new_tokens=200 - len(SYSTEM))
    fl2._replicas["d0"].transport.kill()
    with pytest.raises(ServingError):
        h2.result(timeout=60)
    fl2.shutdown()


@needs_subproc
def test_subproc_child_without_the_device_fails_the_build_typed(models):
    """A replica whose config names CUDA on a host without it fails its
    build handshake with the typed error from the child: nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the build would succeed")
    from paddle_tpu_torch.serving.disagg.transport import SubprocTransport

    spec = ReplicaSpec("gpu", models[1], _cfg(device="cuda"),
                       transport="proc")
    with pytest.raises(RuntimeError, match="CUDA"):
        SubprocTransport(spec)
