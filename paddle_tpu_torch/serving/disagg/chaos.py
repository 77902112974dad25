"""The chaos soak drill: a seeded fault schedule over a multi-replica
fleet driving concurrent requests, with the acceptance invariants
checked in one place.

The drill is the library half the chaos tests run: build a fault-free
ORACLE run first (one inproc engine, seeded
sampling — the reference streams), then run the same workload through
a subprocess fleet whose RPC codecs are wrapped by seeded FaultPlans,
and assert:

1. NO HANG: every handle resolves — tokens or a typed ServingError —
   inside the global watchdog budget;
2. TOKEN IDENTITY: every stream that resolved with a result matches
   the fault-free oracle exactly (seeded sampling + the remigration
   ladder make this a hard invariant, not a hope), and the STREAMED
   token sequence equals the result (the ordered stream protocol:
   no dupes, no holes, no reordering);
3. NO LEAKS: after the survivors drain and every prefix cache
   flushes, every replica's pool reads all-free (pages_in_use == 0).

Determinism: the fault schedule is a pure function of (seed, traffic
order).  Which requests ride out a fault via remigration vs resolve
typed can depend on timing, but the three invariants above hold on
every run — that is what "chaos scenario as unit test" means here.

Docs: docs/SERVING.md "Failure model".
"""
import random
import threading
import time

import numpy as np

from ...generation import GenerationConfig, GenerationEngine
from ...generation.sampling import SamplingParams
from ..admission import ServingError
from .faults import FATAL_KINDS, FaultPlan, FaultRule

# the named protocol points a full-matrix schedule covers, per
# direction (docs/SERVING.md "Failure model" fault taxonomy)
SEND_POINTS = ("submit", "stats", "export_prefix", "import_seq")
RECV_POINTS = ("token", "done", "hb", "resp")


def full_matrix_plans(seed, names, kinds=None, spare=None):
    """A seeded schedule exercising every fault kind at every named
    injection point, spread over the fleet — with `spare` (default:
    the first name) kept FREE of fatal kinds (kill/stall/corrupt/
    truncate), so surviving streams always have somewhere to land.
    Returns ``{name: FaultPlan}``."""
    rng = random.Random(seed)
    names = list(names)
    if len(names) < 2:
        raise ValueError("a chaos matrix needs >= 2 replicas "
                         "(one stays fatal-free)")
    spare = names[0] if spare is None else spare
    fatal_hosts = [n for n in names if n != spare]
    rules = {n: [] for n in names}
    kinds = tuple(kinds) if kinds else (
        "drop", "delay", "dup", "corrupt", "truncate", "kill", "stall")
    benign_hosts = list(names)
    for kind in kinds:
        hosts = fatal_hosts if kind in FATAL_KINDS else benign_hosts
        points = ([("send", p) for p in SEND_POINTS]
                  + [("recv", p) for p in RECV_POINTS])
        if kind in FATAL_KINDS:
            # one fatal firing per replica is one death: spreading a
            # fatal kind over every point would just kill the same
            # replica at its first hit — pick ONE point per fatal kind
            points = [points[rng.randrange(len(points))]]
        for direction, point in points:
            host = hosts[rng.randrange(len(hosts))]
            rules[host].append(FaultRule(
                point, kind, direction=direction,
                after=rng.randrange(3), count=1,
                delay_s=0.02 + 0.05 * rng.random(),
                stall_s=30.0))
    return {n: FaultPlan(rs, seed=seed + i)
            for i, (n, rs) in enumerate(rules.items())}


def kill_stall_plans(seed, names):
    """The kill-and-stall schedule: one replica killed mid-stream,
    one stalled (wedge-watchdog fodder), the first replica clean."""
    rng = random.Random(seed)
    names = list(names)
    if len(names) < 2:
        raise ValueError("need >= 2 replicas")
    plans = {}
    victims = [n for n in names[1:]]
    kill_host = victims[rng.randrange(len(victims))]
    stall_host = next((n for n in victims if n != kill_host),
                      kill_host)
    plans[kill_host] = FaultPlan(
        [FaultRule("token", "kill", direction="recv",
                   after=2 + rng.randrange(3))], seed=seed)
    if stall_host != kill_host:
        plans[stall_host] = FaultPlan(
            [FaultRule("submit", "stall", direction="send",
                       after=1, stall_s=60.0)], seed=seed + 1)
    return plans


def _oracle_streams(model, cfg_kw, prompts, sampling, new_tokens):
    """The fault-free reference: one inproc engine, same seeded
    workload, batched (batched == sequential is the repo-wide oracle
    contract, so this is THE reference stream set)."""
    eng = GenerationEngine(model, GenerationConfig(**cfg_kw),
                           start=False)
    handles = [eng.submit(p, max_new_tokens=new_tokens, sampling=sp)
               for p, sp in zip(prompts, sampling)]
    eng.run_until_idle()
    out = [h.result(timeout=30).token_ids for h in handles]
    eng.shutdown()
    return out


def chaos_drill(model, *, seed=0, n_replicas=3, n_requests=8,
                prompt_tokens=24, new_tokens=10, vocab=None,
                plans=None, engine_kw=None, fleet_kw=None,
                watchdog_s=120.0, wedge_after_s=2.5,
                orphan_grace_s=2.0, restart_dead=False):
    """Run one seeded chaos soak; returns the report dict (raises
    AssertionError on an invariant breach — a hung stream, a stream
    diverging from the oracle, or leaked pages).

    `plans`: {replica_name: FaultPlan} (default: the full matrix over
    seed).  `engine_kw`: per-replica GenerationConfig overrides (pool
    layout / kv_dtype cells).  `fleet_kw`: FleetConfig overrides (the
    drill defaults to tight chaos-grade deadlines).  `restart_dead`
    additionally restarts every dead replica at the end (exercises
    the respawn-backoff path) before the leak check.

    Two phases: a WARMUP wave (fault plans disarmed, watchdog
    thresholds relaxed) pays every replica's first-shape steps — a
    slow first step on a loaded box must not read as a wedge —
    then the plans arm, the wedge/orphan clocks tighten to
    `wedge_after_s`/`orphan_grace_s`, and the measured chaos wave
    runs against steady-state replicas."""
    from ...profiler.monitor import StatRegistry
    from .. import fleet as fleet_mod
    from ..fleet import FleetConfig, FleetRouter, ReplicaSpec

    reg = StatRegistry.instance()

    def reset_fleet_stats():
        for name in list(reg.stats()):
            if name.startswith(fleet_mod.PREFIX):
                reg.get_stat(name).reset()

    # the report reads the global fleet.* registry: zero it so one
    # drill's counters never smear into the next cell's report
    reset_fleet_stats()
    rng = np.random.default_rng(seed)
    vocab = int(vocab if vocab is not None
                else getattr(model, "vocab_size", 48))
    half = max(2, vocab // 2)
    names = [f"c{i}" for i in range(n_replicas)]
    prompts, sampling = [], []
    for i in range(n_requests):
        # measured prompts draw from the LOWER vocab half; the warmup
        # wave uses the upper half, so nothing it caches can warm them
        prompts.append(rng.integers(
            0, half, int(prompt_tokens)).tolist())
        # mixed batch: half greedy, half seeded stochastic — both must
        # replay identically through every remigration
        sampling.append(SamplingParams() if i % 2 == 0 else
                        SamplingParams(temperature=0.9, top_k=8,
                                       seed=1000 + i))
    cfg_kw = dict(max_decode_slots=4, page_size=4,
                  num_pages=(int(prompt_tokens) + int(new_tokens))
                  * n_requests // 4 + 4 * n_requests,
                  queue_depth=n_requests * 2 + 4, prefix_cache=True)
    cfg_kw.update(engine_kw or {})
    oracle = _oracle_streams(model, cfg_kw, prompts, sampling,
                             new_tokens)

    plans = plans if plans is not None else full_matrix_plans(
        seed, names)
    for plan in plans.values():
        plan.disarm()   # nothing fires until the fleet is warm
    fl_kw = dict(seed=seed, transport="proc", rpc_timeout_s=2.0,
                 rpc_retries=2, rpc_backoff_s=0.02,
                 heartbeat_dead_after=5.0,
                 # relaxed until the warmup wave paid the compiles
                 wedge_after_s=60.0, orphan_grace_s=60.0,
                 breaker_threshold=2,
                 breaker_cooldown_s=0.25, respawn_backoff_s=0.05,
                 fault_plans=plans)
    fl_kw.update(fleet_kw or {})
    specs = [ReplicaSpec(n, model, GenerationConfig(**cfg_kw))
             for n in names]
    fl = FleetRouter(specs, FleetConfig(**fl_kw))
    try:
        # ---- warmup: every replica pays its prefill/decode shape
        # warm-up on upper-half-vocab traffic, at the FULL concurrent
        # batch the chaos wave (and its remigration surges — a crash can
        # dump every stream on one survivor) will drive, so no
        # first-big-batch step lands inside the tightened wedge clock.
        # Session pins force one full wave per replica; then the caches
        # flush and the counters reset — the chaos wave starts
        # steady-state with clean books.
        warm_batch = min(n_requests,
                         int(cfg_kw.get("max_decode_slots", 4)))
        warm = []
        for i, name in enumerate(names):
            for j in range(warm_batch):
                sess = f"__warm{i}_{j}"
                fl._sessions[sess] = name
                # the SAME greedy/stochastic mix as the measured wave:
                # a mixed decode batch is its own shape family on the
                # eager path, and an unwarmed one compiles for seconds —
                # indistinguishable from a wedge to any finite clock
                warm_sp = (SamplingParams() if j % 2 == 0 else
                           SamplingParams(temperature=0.9, top_k=8,
                                          seed=7000 + i * warm_batch + j))
                warm.append((sess, fl.submit(
                    rng.integers(half, vocab, int(prompt_tokens)).tolist(),
                    max_new_tokens=new_tokens, sampling=warm_sp,
                    session=sess)))
        for sess, h in warm:
            h.result(timeout=watchdog_s)
            fl._sessions.pop(sess, None)
        for name, rep in fl._replicas.items():
            rep.transport.flush_prefix()
            rep.transport.take_prefix_deltas()
            fl._page_index.drop_replica(name)
        reset_fleet_stats()
        fl.config.wedge_after_s = float(wedge_after_s)
        fl.config.orphan_grace_s = float(orphan_grace_s)
        for plan in plans.values():
            plan.arm()
        t0 = time.monotonic()
        arrivals = [[] for _ in range(n_requests)]
        streamed = [None] * n_requests
        outcomes = [None] * n_requests   # "ok" | exception | "hung"
        handles = [None] * n_requests

        def consume(i, h):
            toks = []
            try:
                for t in h.tokens(timeout=watchdog_s):
                    arrivals[i].append(time.monotonic())
                    toks.append(t)
                streamed[i] = toks
                outcomes[i] = "ok"
            except ServingError as e:
                outcomes[i] = e
            except Exception as e:   # noqa: BLE001 — anything else is a
                outcomes[i] = e      # drill failure, reported not raised

        threads = []
        for i, (p, sp) in enumerate(zip(prompts, sampling)):
            try:
                h = fl.submit(p, max_new_tokens=new_tokens, sampling=sp)
            except ServingError as e:
                outcomes[i] = e
                continue
            handles[i] = h
            th = threading.Thread(target=consume, args=(i, h), daemon=True)
            th.start()
            threads.append(th)
            time.sleep(0.01)   # deterministic-ish traffic order for the
            # per-rule frame counters without serializing the streams
        deadline = time.monotonic() + watchdog_s
        for th in threads:
            th.join(timeout=max(0.1, deadline - time.monotonic()))
        hung = sum(1 for i, th in enumerate(threads) if th.is_alive())
        recovery_wall = time.monotonic() - t0

        # ---- invariant 1: no hangs (tokens or typed error, nothing else)
        assert hung == 0, f"{hung} streams hung past the {watchdog_s}s " \
                          f"global watchdog"
        # ---- invariant 2: surviving streams token-identical to oracle,
        # and the streamed sequence IS the result (ordered protocol)
        identical = 0
        mismatches = []
        for i, out in enumerate(outcomes):
            if out != "ok":
                continue
            result = handles[i].result(timeout=1).token_ids
            if result != oracle[i]:
                mismatches.append((i, "result", result, oracle[i]))
            elif streamed[i] != result:
                mismatches.append((i, "stream", streamed[i], result))
            else:
                identical += 1
        assert not mismatches, f"streams diverged from the fault-free " \
                               f"oracle: {mismatches[:2]}"
        # ---- invariant 3: drained + flushed == all-free, no page leaks
        if restart_dead:
            for name, rep in fl._replicas.items():
                if rep.state == "dead":
                    try:
                        fl.restart(name, wait=True)
                    except ServingError:
                        pass   # crash-loop cap is a legal outcome
        fl.run_until_idle()
        leaked = 0
        for name, rep in fl._replicas.items():
            if rep.state != "serving" or not rep.transport.alive():
                continue
            try:
                rep.transport.flush_prefix()
                stats = rep.transport.stats()
            except ServingError:
                continue   # died/wedged at the very end: nothing to leak
            leaked += int(stats.get("cache", {}).get("pages_in_use", 0))
        assert leaked == 0, f"{leaked} pages leaked after drain + flush"

        snap = fl.stats_snapshot()["fleet"]
        # per-stream inter-arrival gaps ONLY — diffing a cross-stream
        # concatenation would pollute the percentiles with meaningless
        # (often negative) boundary deltas between unrelated streams
        per_stream = [np.diff(np.asarray(a)) for a in arrivals
                      if len(a) > 1]
        gaps = (np.concatenate(per_stream) if per_stream
                else np.zeros(0))
        fired = {n: p.fired_kinds() for n, p in plans.items()}
        report = {
            "seed": seed,
            "replicas": n_replicas,
            "requests": n_requests,
            "resolved_ok": sum(1 for o in outcomes if o == "ok"),
            "resolved_typed_error":
                sum(1 for o in outcomes
                    if o is not None and o != "ok"),
            "hung": hung,
            "token_identical": identical,
            "leaked_pages": leaked,
            "faults_fired": fired,
            "recovery_wall_s": round(recovery_wall, 3),
            "stream_gap_p50_s": round(float(np.percentile(gaps, 50)), 4)
                if gaps.size else None,
            "stream_gap_p95_s": round(float(np.percentile(gaps, 95)), 4)
                if gaps.size else None,
            "replica_dead_total": snap.get("fleet.replica_dead_total", 0),
            "wedge_kill_total": snap.get("fleet.wedge_kill_total", 0),
            "breaker_open_total": snap.get("fleet.breaker_open_total", 0),
            "replica_timeout_total":
                snap.get("fleet.replica_timeout_total", 0),
            "orphan_remigrated_total":
                snap.get("fleet.orphan_remigrated_total", 0),
            "migrated_total": snap.get("fleet.migrated_total", 0),
            "migrated_replay_tokens":
                snap.get("fleet.migrated_replay_tokens", 0),
            "live_migrated_total":
                snap.get("fleet.live_migrated_total", 0),
        }
        return report
    finally:
        # shutdown is idempotent: an invariant breach or a
        # mid-drill exception must not leak worker processes
        fl.shutdown()


__all__ = ["chaos_drill", "full_matrix_plans", "kill_stall_plans",
           "SEND_POINTS", "RECV_POINTS"]
