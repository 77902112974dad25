"""Port parity: the control plane (FleetSupervisor) and chaos hardening of
the port's fleet (paddle_tpu_torch.serving).

``FaultPlan`` decides the same faults as the JAX package's for the same
seed and rules, frame for frame (and corrupts the same bytes); the
circuit breaker walks its states; the supervisor resurrects dead
replicas, honours the respawn backoff and the crash-loop cap, and scales
each class of a role-split fleet on its own signal; the bounded RPC
machinery times out typed; and the chaos drill (a seeded kill and stall
schedule over subprocess replicas of the port) hangs nothing, leaks no
page and keeps every surviving stream identical to the fault-free run.
The cases follow the JAX package's control-plane and chaos tests.
"""
import itertools
import random
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu import generation as jgen
from paddle_tpu.serving.disagg import faults as jfaults
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.profiler.monitor import StatRegistry
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving.admission import (ReplicaTimeoutError,
                                                ServerBusyError,
                                                ServingError)
from paddle_tpu_torch.serving.control import (FleetSupervisor,
                                              SupervisorConfig)
from paddle_tpu_torch.serving.disagg import faults as pfaults
from paddle_tpu_torch.serving.disagg.chaos import (chaos_drill,
                                                   full_matrix_plans,
                                                   kill_stall_plans)
from paddle_tpu_torch.serving.disagg.rpc import recv_frame, send_frame
from paddle_tpu_torch.serving.disagg.transport import (RpcPolicy,
                                                       SubprocTransport)
from paddle_tpu_torch.serving.fleet import (CircuitBreaker, FleetConfig,
                                            FleetRouter, ReplicaSpec)

from dist_capability import (SUBPROC_SKIP_REASON,  # noqa: E402
                             subprocess_replicas_available)
from gen_oracle import greedy_oracle  # noqa: E402

needs_subproc = pytest.mark.skipif(
    not subprocess_replicas_available(), reason=SUBPROC_SKIP_REASON)

MODEL = dict(vocab_size=48, num_layers=2, num_heads=2, head_dim=8, seed=3)
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


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


def _fleet(models, n=1, **kw):
    specs = [ReplicaSpec(f"r{i}", models[1], _cfg()) for i in range(n)]
    return FleetRouter(specs, FleetConfig(**{**dict(start=False, seed=0),
                                             **kw}))


# ------------------------------- fault plans -------------------------------


def _rules(mod, rng_seed):
    """The same seeded mix of windowed and probabilistic rules, built in
    one package."""
    rng = random.Random(rng_seed)
    points = ["submit", "stats", "token", "done", "hb", "resp", "any"]
    out = []
    for _ in range(12):
        kind = rng.choice(mod.KINDS)
        kw = dict(direction=rng.choice(["send", "recv", None]),
                  after=rng.randrange(4), count=1 + rng.randrange(3),
                  side=rng.choice(["parent", "parent", "child"]))
        if rng.random() < 0.4:
            kw["prob"] = rng.random()
        out.append(mod.FaultRule(rng.choice(points), kind, **kw))
    return out


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_decisions_equal_to_jax(seed):
    """The same rules and seed decide the same faults on the same frame
    sequence, in both halves (parent and child), armed and disarmed."""
    rng = random.Random(seed + 1)
    frames = [(rng.choice(["send", "recv"]),
               rng.choice(["submit", "stats", "token", "done", "hb",
                           "resp", "load"])) for _ in range(300)]
    for holder in ("parent", "child"):
        jp = jfaults.FaultPlan(_rules(jfaults, seed), seed=seed,
                               holder=holder)
        pp = pfaults.FaultPlan(_rules(pfaults, seed), seed=seed,
                               holder=holder)
        for i, (direction, point) in enumerate(frames):
            if i == 150:
                jp.disarm()
                pp.disarm()
            if i == 200:
                jp.arm()
                pp.arm()
            got = [(r.kind, r.point) for r in pp._take(direction, point)]
            want = [(r.kind, r.point) for r in jp._take(direction, point)]
            assert got == want, (holder, i)
        assert pp.fired_kinds() == jp.fired_kinds()
        assert [(f["kind"], f["point"], f["direction"]) for f in pp.fired] \
            == [(f["kind"], f["point"], f["direction"]) for f in jp.fired]
    jc = jfaults.FaultPlan(_rules(jfaults, seed), seed=seed).child_spec()
    pc = pfaults.FaultPlan(_rules(pfaults, seed), seed=seed).child_spec()
    assert (pc is None) == (jc is None)
    if pc is not None:
        assert pc["seed"] == jc["seed"] and pc["armed"] == jc["armed"]
        assert [(r.point, r.kind, r.after, r.count) for r in pc["rules"]] \
            == [(r.point, r.kind, r.after, r.count) for r in jc["rules"]]


class _Shell:
    """The transport surface FaultPlan.on_send/on_recv touch, keeping
    the bytes it writes."""

    def __init__(self, sock=None):
        self._sock = sock or self
        self._wlock = threading.Lock()
        self.data = bytearray()
        self.killed = 0
        self.stalls = []

    def sendall(self, b):
        self.data += b

    def kill(self):
        self.killed += 1

    def _send_stall(self, stall_s):
        self.stalls.append(stall_s)

    def _send_plain(self, msg):
        send_frame(self._sock, msg, self._wlock)

    def _recv_plain(self):
        return recv_frame(self._sock)


@pytest.mark.parametrize("kind", ["corrupt", "truncate", "dup", "drop"])
def test_faulty_send_writes_the_bytes_jax_writes(kind):
    """A send-side fault puts the same bytes on the wire as the JAX
    package's plan with the same seed (corrupt's flipped bytes come from
    the plan's RNG)."""
    msg = {"op": "submit", "rid": 1, "payload": list(range(40))}
    jshell, pshell = _Shell(), _Shell()
    jfaults.FaultPlan([jfaults.FaultRule("submit", kind, after=0)],
                      seed=9).on_send(jshell, msg)
    pfaults.FaultPlan([pfaults.FaultRule("submit", kind, after=0)],
                      seed=9).on_send(pshell, msg)
    assert bytes(pshell.data) == bytes(jshell.data)


def test_fault_rule_window_and_plan_reproducible():
    rule = pfaults.FaultRule("submit", "drop", direction="send", after=1,
                             count=2)
    rng = random.Random(0)
    assert [rule._matches("send", "submit", rng) for _ in range(5)] == \
        [False, True, True, False, False]

    def run(seed):
        plan = pfaults.FaultPlan([pfaults.FaultRule("any", "drop",
                                                    prob=0.5)], seed=seed)
        return [bool(plan._take("send", "submit")) for _ in range(20)]

    assert run(3) == run(3) and run(3) != run(4)
    with pytest.raises(ValueError, match="kind"):
        pfaults.FaultRule("submit", "explode")
    with pytest.raises(ValueError, match="side"):
        pfaults.FaultRule("submit", "drop", side="sideways")


def test_faulty_recv_drop_dup_corrupt_kill_stall():
    a, b = socket.socketpair()
    shell = _Shell(b)
    plan = pfaults.FaultPlan([
        pfaults.FaultRule("token", "drop", after=0),
        pfaults.FaultRule("token", "dup", after=1),
        pfaults.FaultRule("done", "kill", after=0),
        pfaults.FaultRule("hb", "stall", after=0, stall_s=7.5),
        pfaults.FaultRule("resp", "corrupt", after=0)])
    for f in ({"ev": "token", "sid": 1, "t": 5, "n": 0},
              {"ev": "token", "sid": 1, "t": 6, "n": 1},
              {"ev": "done", "sid": 1, "result": {}},
              {"ev": "hb", "load": {}}, {"resp": 9, "ok": True}):
        send_frame(a, f)
    assert plan.on_recv(shell) == []
    assert [f["t"] for f in plan.on_recv(shell)] == [6, 6]
    assert plan.on_recv(shell)[0]["ev"] == "done" and shell.killed == 1
    assert plan.on_recv(shell)[0]["ev"] == "hb" and shell.stalls == [7.5]
    with pytest.raises(pfaults.FaultInjected):
        plan.on_recv(shell)
    a.close()
    b.close()


def test_chaos_schedules_equal_to_jax():
    """The drill's seeded schedules name the same rules as the JAX
    package's: the full matrix (every kind, the spare free of fatal
    kinds) and the kill-and-stall schedule."""
    from paddle_tpu.serving.disagg import chaos as jchaos

    names = ["a", "b", "c"]
    for seed in (5, 11):
        mine, theirs = full_matrix_plans(seed, names), \
            jchaos.full_matrix_plans(seed, names)
        assert {n: [(r.point, r.kind, r.direction, r.after, r.delay_s)
                    for r in p.rules] for n, p in mine.items()} == \
            {n: [(r.point, r.kind, r.direction, r.after, r.delay_s)
                 for r in p.rules] for n, p in theirs.items()}
        assert not any(r.kind in pfaults.FATAL_KINDS
                       for r in mine["a"].rules)
        ks, jk = kill_stall_plans(seed, names), \
            jchaos.kill_stall_plans(seed, names)
        assert {n: [(r.point, r.kind, r.after) for r in p.rules]
                for n, p in ks.items()} == \
            {n: [(r.point, r.kind, r.after) for r in p.rules]
             for n, p in jk.items()}
    with pytest.raises(ValueError, match="2 replicas"):
        full_matrix_plans(0, ["solo"])


# --------------------------- bounded RPC, breaker ---------------------------


def _bare_transport(sock, rpc):
    """A SubprocTransport shell over a raw socket: the RPC wait and
    retry machinery with no worker behind it."""
    t = SubprocTransport.__new__(SubprocTransport)
    t.name = "bare"
    t.rpc = rpc
    t._faults = None
    t._jitter = random.Random(0)
    t.timeout_total = 0
    t._sock = sock
    t._wlock = threading.Lock()
    t._lock = threading.Lock()
    t._ids = itertools.count(1)
    t._rpc_waits = {}
    t._inflight = {}
    t._dead = threading.Event()
    return t


def test_rpc_deadlines_bounded_and_retries_only_idempotent():
    a, b = socket.socketpair()
    t = _bare_transport(a, RpcPolicy(timeout_s=0.1, retries=3,
                                     backoff_s=0.01))
    with pytest.raises(ReplicaTimeoutError, match="deadline"):
        t._call_idempotent({"op": "stats"})
    assert t.timeout_total == 3   # every attempt bounded by the policy
    with pytest.raises(ReplicaTimeoutError):
        t._call({"op": "submit"})
    assert t.timeout_total == 4 and t._rpc_waits == {}
    with pytest.raises(AssertionError):
        t._call_idempotent({"op": "submit"})
    for bad in (dict(timeout_s=0), dict(retries=0), dict(backoff_s=-1)):
        with pytest.raises(ValueError):
            RpcPolicy(**bad)
    assert issubclass(ReplicaTimeoutError, (ServingError, TimeoutError))
    a.close()
    b.close()


def test_circuit_breaker_state_machine():
    opened = []
    b = CircuitBreaker(threshold=2, cooldown_s=0.05,
                       on_open=lambda: opened.append(1))
    assert b.state == "closed" and b.routable() and b.admit()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and opened == [1]
    assert not b.routable(hb_age=0.0)
    time.sleep(0.06)
    assert not b.routable(hb_age=99.0)
    assert b.routable(hb_age=0.0)
    assert b.admit(hb_age=0.0) and b.state == "half-open"
    assert not b.admit(hb_age=0.0)
    b.record_failure()
    assert b.state == "open" and opened == [1, 1]
    time.sleep(0.06)
    assert b.admit(hb_age=0.0)
    b.record_busy()                      # back-pressure releases the probe
    assert b.state == "half-open" and b.admit(hb_age=0.0)
    b.record_success()
    assert b.state == "closed" and b.failures == 0
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


def test_breaker_gates_routing_and_all_open_sheds_typed(models):
    fl = _fleet(models, n=2, breaker_threshold=1, breaker_cooldown_s=30.0)
    fl._replicas["r0"].breaker.record_failure()
    h = fl.submit(SYSTEM, max_new_tokens=2)
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == _ref(models, SYSTEM, 2)
    snap = fl.stats_snapshot()
    assert snap["replicas"]["r0"]["generation"].get(
        "generation.requests_total", 0) == 0
    assert snap["replicas"]["r0"]["breaker"] == "open"
    assert snap["fleet"][fleet_mod.BREAKER_STATE + ".r0"] == 2
    fl._replicas["r1"].breaker.record_failure()
    with pytest.raises(ServerBusyError, match="circuit breaker"):
        fl.submit(SYSTEM, max_new_tokens=2)
    assert _stat(fleet_mod.SHED_TOTAL) == 1
    assert _stat(fleet_mod.BREAKER_OPEN_TOTAL) == 2
    fl.shutdown()


def test_breaker_half_open_probe_recovers_inproc(models):
    want = _ref(models, SYSTEM, 2)
    fl = _fleet(models, n=1, breaker_threshold=1, breaker_cooldown_s=0.05)
    rep = fl._replicas["r0"]
    rep.breaker.record_failure()
    with pytest.raises(ServerBusyError):
        fl.submit(SYSTEM, max_new_tokens=2)   # still cooling down
    time.sleep(0.06)
    h = fl.submit(SYSTEM, max_new_tokens=2)   # the half-open probe
    assert rep.breaker.state == "closed"
    fl.run_until_idle()
    assert h.result(timeout=5).token_ids == want
    fl.shutdown()


def test_restart_backoff_exponential_cap_and_crash_loop(models):
    fl = _fleet(models, n=2, respawn_backoff_s=0.05,
                respawn_backoff_cap_s=0.2, max_respawns=3,
                respawn_reset_s=1000.0)
    rep = fl._replicas["r0"]

    def die():
        rep.state = "serving"
        fl._handle_death(rep.transport)
        assert rep.state == "dead"

    die()
    rep.died_at = time.monotonic()
    with pytest.raises(ServingError, match="backoff"):
        fl.restart("r0", wait=False)
    fl.restart("r0", wait=True)
    assert rep.state == "serving"
    die()
    assert rep.respawns == 2 and _stat(fleet_mod.REPLICA_DEAD_TOTAL) == 2
    fl.restart("r0", wait=True)
    die()
    fl.restart("r0", wait=True)
    assert _stat(fleet_mod.RESPAWN_BACKOFF_S + ".r0") == min(0.2, 0.05 * 4)
    die()
    with pytest.raises(ServingError, match="crash-looping"):
        fl.restart("r0")
    fl.reset_respawn("r0")
    fl.restart("r0", wait=True)
    assert rep.state == "serving"
    fl.shutdown()


# ------------------------------- supervisor --------------------------------


def test_supervisor_config_validates():
    cfg = SupervisorConfig()
    assert (cfg.sustain_ticks, cfg.idle_ticks) == (3, 8)
    assert cfg.scale_up_slot_occupancy is None
    for bad, match in ((dict(interval_s=0), "interval_s"),
                       (dict(scale_up_queue_depth=-1),
                        "scale_up_queue_depth"),
                       (dict(scale_up_ttft_s=0), "scale_up_ttft_s"),
                       (dict(sustain_ticks=0), "sustain_ticks"),
                       (dict(idle_ticks=0), "idle_ticks"),
                       (dict(scale_up_slot_occupancy=1.5),
                        "scale_up_slot_occupancy")):
        with pytest.raises(ValueError, match=match):
            SupervisorConfig(**bad)


def _dead(rep, respawns):
    rep.transport.stop()
    rep.state = "dead"
    rep.died_at = time.monotonic()
    rep.respawns = respawns


def test_tick_resurrects_then_respects_backoff_and_crash_loop(models):
    fl = _fleet(models, n=1, respawn_backoff_s=5.0, max_respawns=2)
    sup = FleetSupervisor(fl)
    try:
        rep = fl._replicas["r0"]
        _dead(rep, 0)                     # a death after a healthy run
        assert sup.tick()["healed"] == 1 and rep.state == "serving"
        assert _stat(fleet_mod.SUPERVISOR_RESTART_TOTAL) == 1
        h = fl.submit(SYSTEM, max_new_tokens=4)
        fl.run_until_idle()
        assert h.result(timeout=10).token_ids == _ref(models, SYSTEM, 4)
        _dead(rep, 1)                     # a quick death owes 5 s
        assert sup.tick()["healed"] == 0 and rep.state == "dead"
        rep.died_at = time.monotonic() - 10.0
        assert sup.tick()["healed"] == 1 and rep.state == "serving"
        _dead(rep, 3)                     # past max_respawns: left dead
        for _ in range(3):
            assert sup.tick()["healed"] == 0
        fl.reset_respawn("r0")
        assert sup.tick()["healed"] == 1 and rep.state == "serving"
    finally:
        sup.stop()
        fl.shutdown()


def _pressured(models, sustain, max_replicas=4, **sup_kw):
    fl = _fleet(models, n=1, max_replicas=max_replicas)

    def factory(i):
        return ReplicaSpec(f"auto{i}", models[1], _cfg())

    sup = FleetSupervisor(fl, spec_factory=factory,
                          config=SupervisorConfig(**{**dict(
                              scale_up_queue_depth=0.5,
                              sustain_ticks=sustain, idle_ticks=2),
                              **sup_kw}))
    return fl, sup


def test_autoscaler_sustain_max_and_drains_only_its_spawns(models):
    fl, sup = _pressured(models, sustain=2, max_replicas=2)
    try:
        hs = [fl.submit(SYSTEM, max_new_tokens=4) for _ in range(4)]
        assert not sup.tick()["spawned"]          # one tick is no trend
        report = sup.tick()
        assert report["spawned"] and set(report["pressure"]) == {"mixed"}
        assert "auto0" in fl._replicas
        for _ in range(3):
            assert not sup.tick()["spawned"]      # at max_replicas
        fl.run_until_idle()
        for h in hs:
            assert h.result(timeout=10).token_ids == _ref(models, SYSTEM, 4)
        assert [sup.tick()["drained"] for _ in range(3)] == \
            [False, True, False]
        assert "auto0" not in fl._replicas and "r0" in fl._replicas
        assert _stat(fleet_mod.AUTOSCALE_SPAWNED) == 1
        assert _stat(fleet_mod.AUTOSCALE_DRAINED) == 1
        for _ in range(4):
            assert not sup.tick()["drained"]      # the base fleet stays
    finally:
        sup.stop()
        fl.shutdown()


def test_autoscaler_scales_each_class_on_its_own_signal(models):
    """On a role-split fleet, TTFT presses only the prefill class and
    decode slot occupancy only the decode class, each with its own
    sustain streak; spawns carry the pressed role."""
    specs = [ReplicaSpec("r0", models[1], _cfg(), role="prefill"),
             ReplicaSpec("r1", models[1], _cfg(), role="decode")]
    fl = FleetRouter(specs, FleetConfig(start=False, seed=0,
                                        max_replicas=4))
    roles = []

    def factory(i, role="mixed"):
        roles.append(role)
        return ReplicaSpec(f"auto{i}", models[1], _cfg(), role=role)

    sup = FleetSupervisor(fl, spec_factory=factory, config=SupervisorConfig(
        scale_up_queue_depth=100.0, scale_up_ttft_s=0.5,
        scale_up_slot_occupancy=0.9, sustain_ticks=2))
    try:
        pre, dec = fl._replicas["r0"], fl._replicas["r1"]
        pre.ttft_ewma = 2.0
        first = sup.tick()
        assert first["pressure"] == {"prefill": True, "decode": False}
        assert not first["spawned"]
        assert sup.tick()["spawned"] and roles == ["prefill"]
        pre.ttft_ewma = 0.0
        dec._describe = {"max_decode_slots": 4}
        dec.transport.load_info = lambda: {
            "queue_depth": 0, "active": 4, "idle": False}
        first = sup.tick()
        assert first["pressure"] == {"prefill": False, "decode": True}
        assert not first["spawned"]
        assert sup.tick()["spawned"]
        assert roles == ["prefill", "decode"]
        assert fl._replicas["auto1"].role == "decode"
        assert _stat(fleet_mod.AUTOSCALE_SPAWNED) == 2
    finally:
        sup.stop()
        fl.shutdown()


def test_supervisor_background_loop_heals(models):
    fl = _fleet(models, n=1)
    rep = fl._replicas["r0"]
    _dead(rep, 0)
    try:
        with FleetSupervisor(fl, config=SupervisorConfig(
                interval_s=0.05)) as sup:
            sup.start()
            deadline = time.monotonic() + 10
            while rep.state != "serving":
                assert time.monotonic() < deadline
                time.sleep(0.05)
        assert sup._thread is None
    finally:
        fl.shutdown()


def test_watchdog_ping_probe_recovers_idle_breaker(models):
    fl = _fleet(models, n=1, start=True, breaker_cooldown_s=0.05,
                watchdog_interval_s=0.05)
    try:
        rep = fl._replicas["r0"]
        for _ in range(fl.config.breaker_threshold):
            rep.breaker.record_failure()
        assert rep.breaker.state == "open"
        time.sleep(0.1)
        deadline = time.monotonic() + 10
        while rep.breaker.state != "closed":
            assert time.monotonic() < deadline
            fl.stats_snapshot()
            time.sleep(0.05)
        assert _stat(fleet_mod.PING_PROBE_TOTAL) >= 1
    finally:
        fl.shutdown()


# -------------------------------- the drill --------------------------------


@needs_subproc
def test_chaos_drill_kill_and_stall_schedule(models):
    """A mid-stream SIGKILL and an engine stalled while its heartbeat
    flows, over three subprocess replicas of the port: the wedge
    watchdog turns the stall into a death, every stream resolves, the
    survivors equal the fault-free run, and no page leaks."""
    report = chaos_drill(models[1], seed=7, n_replicas=3, n_requests=6,
                         new_tokens=8,
                         plans=kill_stall_plans(7, ["c0", "c1", "c2"]),
                         watchdog_s=120.0, engine_kw=dict(device="cpu"))
    assert report["hung"] == 0 and report["leaked_pages"] == 0
    assert report["resolved_ok"] + report["resolved_typed_error"] == 6
    assert report["token_identical"] == report["resolved_ok"]
    assert report["wedge_kill_total"] >= 1
    assert report["replica_dead_total"] >= 1


@pytest.mark.slow
@needs_subproc
def test_chaos_drill_full_matrix_deterministic(models):
    report = chaos_drill(models[1], seed=11, n_replicas=3, n_requests=8,
                         new_tokens=8, watchdog_s=120.0, restart_dead=True,
                         engine_kw=dict(device="cpu"))
    assert report["hung"] == 0 and report["leaked_pages"] == 0
    assert report["resolved_ok"] + report["resolved_typed_error"] == 8
    assert report["token_identical"] == report["resolved_ok"]
    assert {k for kinds in report["faults_fired"].values() for k in kinds}
