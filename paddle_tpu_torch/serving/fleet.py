"""Fleet tier: multi-replica generation serving with prefix-affinity
and SLO-aware routing.

Everything below `serving/` and `generation/` batches inside ONE
process: a single `GenerationEngine` owns one KV pool, one prefix
index, one admission queue.  Heavy traffic needs N engine replicas —
possibly heterogeneous (a long-context replica and a low-latency
replica behind one API) — and a front door that makes page-locality
decisions an engine cannot see: which replica already holds a session's
warm pages, which one likely has a prompt's system prefix indexed,
which one has slack.  The FleetRouter is that front door::

    submit(prompt, session=...) ── routing ladder ──> replica engine
         <- GenerationHandle           │                (its own pools,
            (same streaming            │                 prefix index,
             contract)                 │                 AdmissionQueue)
                                       ▼
          1. SESSION AFFINITY   a session id pins follow-up turns to
                                the replica holding their warm pages
          2. PREFIX AFFINITY    hash of the prompt's leading page-
                                aligned tokens prefers the replica
                                whose prefix index LIKELY holds it —
                                measured, not assumed: the router
                                confirms every prefix bet against the
                                handle's prefix_hit_tokens stamp
          3. LEAST LOADED       queue depth + resident pages + measured
                                TTFT EWMA relative to the fastest
                                candidate (a slow replica sheds new
                                traffic under skewed prompt lengths)
          spill                 a full first choice falls through the
                                remaining candidates by load
          shed                  every candidate's admission gate
                                closed -> fleet.shed_total +
                                ServerBusyError (typed, synchronous)

Per-replica admission is the serving AdmissionQueue unchanged (typed
ServerBusyError / DeadlineExceededError); the fleet only ADDS the
cross-replica hop, so a fleet of one behaves exactly like a bare
engine.

The fleet is DISAGGREGATED (serving/disagg): every replica sits behind
a ReplicaTransport — `InprocTransport` (direct-object engine, the
deterministic CPU oracle) or `SubprocTransport` (one OS process per
replica, pickled RPC over a socketpair, heartbeat liveness; a crashed
process is detected and its in-flight ledger remigrates, streams
resolve typed instead of hanging).  The prefix-affinity rung reads a
fleet-level `FleetPrefixIndex` fed by register/evict deltas each
replica's cache reports — MEASURED bookkeeping centralized in the
router, page BYTES moved point-to-point on demand: when the index
says a different replica holds a prompt's warm run, the router ships
the pages so the chosen replica adopts a run it never prefilled.

Drain (`drain(name)`) stops admissions to a replica and moves its
not-yet-finished work to siblings: live decode residents as TRUE LIVE
MIGRATIONS — page bytes + position + sampling RNG ship to a sibling
that RESUMES the stream with zero replayed tokens — and everything
else (plus any resident no sibling can adopt) as COLD RESUBMITS:
sampling is seeded per request, so a resubmit replays the identical
stream, and a relay handle skips the tokens the client already
received (counted in fleet.migrated_replay_tokens — the live-vs-cold
A/B).  migrate=False lets residents finish first, then joins the
worker.  `restart(name)` rebuilds the replica from its spec (fresh
pools, empty prefix index, a fresh process for subprocess replicas);
stale prefix-affinity bets against it are caught by the confirmation
loop AND the fleet index drop, not assumed away.

Token-identity oracle (tests/test_fleet.py): whatever the routing
outcome — affinity hit, prefix spill, shed-and-retry, mid-stream drain
with resubmit — every completed request's tokens are identical to a
single-replica cold run of the same prompt, greedy and seeded
stochastic alike; and `fleet.shed_total` only increments when every
replica's admission gate is closed.

Docs: docs/SERVING.md "Fleet tier".
"""
import math
import threading
import time
import zlib

import numpy as np

from ..generation.engine import GenerationHandle
from ..generation.sampling import SamplingParams
from ..generation.scheduler import GenerationRequest
from ..profiler.monitor import StatRegistry
from .admission import (ReplicaTimeoutError, RequestTooLargeError,
                        ServerBusyError, ServingError)
from .disagg import pagecodec
from .disagg.page_service import FleetPrefixIndex
from .disagg.transport import HEARTBEAT_S, RpcPolicy, build_transport

PREFIX = "fleet."

ROUTED_AFFINITY = PREFIX + "routed_affinity"
ROUTED_PREFIX = PREFIX + "routed_prefix"
ROUTED_BALANCE = PREFIX + "routed_balance"
ROUTED_RANDOM = PREFIX + "routed_random"
ROUTED_SPILL = PREFIX + "routed_spill"
SHED_TOTAL = PREFIX + "shed_total"
MIGRATED_TOTAL = PREFIX + "migrated_total"
PREFIX_ROUTED_CONFIRMED = PREFIX + "prefix_routed_confirmed"
PREFIX_ROUTED_MISSED = PREFIX + "prefix_routed_missed"
REPLICA_QUEUE_DEPTH = PREFIX + "replica_queue_depth"
# disaggregation tier (serving/disagg): heartbeat liveness, live
# migration vs cold-resubmit accounting, page-service adoptions
REPLICA_HEARTBEAT_AGE = PREFIX + "replica_heartbeat_age_s"
REPLICA_DEAD_TOTAL = PREFIX + "replica_dead_total"
LIVE_MIGRATED_TOTAL = PREFIX + "live_migrated_total"
MIGRATED_REPLAY_TOKENS = PREFIX + "migrated_replay_tokens"
PAGE_ADOPTIONS = PREFIX + "page_adoptions"
PAGES_ADOPTED = PREFIX + "pages_adopted"
# chaos-hardening tier: per-replica circuit breakers,
# bounded-RPC deadline misses, wedge watchdog kills, orphaned-stream
# remigration, and exponential respawn backoff
BREAKER_OPEN_TOTAL = PREFIX + "breaker_open_total"
BREAKER_STATE = PREFIX + "breaker_state"
REPLICA_TIMEOUT_TOTAL = PREFIX + "replica_timeout_total"
WEDGE_KILL_TOTAL = PREFIX + "wedge_kill_total"
ORPHAN_REMIGRATED_TOTAL = PREFIX + "orphan_remigrated_total"
RESPAWN_BACKOFF_S = PREFIX + "respawn_backoff_s"
# cross-host fleet tier: prefill/decode disaggregation as a
# routing policy, supervisor liveness probes, and autoscaling
PD_HANDOFFS = PREFIX + "pd_handoffs"
PD_HANDOFF_TOKENS = PREFIX + "pd_handoff_tokens"
PD_HANDOFF_WALL_S = PREFIX + "pd_handoff_wall_s"
ROUTED_ROLE = PREFIX + "routed_role"
PING_PROBE_TOTAL = PREFIX + "ping_probe_total"
SUPERVISOR_RESTART_TOTAL = PREFIX + "supervisor_restart_total"
AUTOSCALE_SPAWNED = PREFIX + "autoscale_spawned"
AUTOSCALE_DRAINED = PREFIX + "autoscale_drained"
REPLICA_COUNT = PREFIX + "replica_count"
# data-plane tier: p2p page transfer, compressed payloads,
# async adoption.  relay_bytes counts page bytes that crossed the
# ROUTER's socket (must stay 0 on the p2p path — counter-asserted);
# p2p wire/raw bytes carry the compression-ratio arithmetic.
PAGE_RELAY_BYTES = PREFIX + "page_relay_bytes"
PAGE_P2P_BYTES = PREFIX + "page_p2p_bytes"
PAGE_RAW_BYTES = PREFIX + "page_raw_bytes"
PAGE_TRANSFERS_FAILED = PREFIX + "page_transfers_failed"
PAGE_TRANSFERS_CANCELLED = PREFIX + "page_transfers_cancelled"
PREFIX_INDEX_COMPACTIONS = PREFIX + "prefix_index_compactions"


class FleetMetrics:
    """fleet.* counters/gauges in the profiler StatRegistry (the
    serving./generation. pattern one tier up).  Routing counters split
    by the rung that actually placed the request; the per-replica
    queue-depth gauges land under ``fleet.replica_queue_depth.<name>``
    with the bare name carrying the fleet-wide MAX (the saturation
    signal load shedding is about)."""

    def __init__(self, registry=None):
        self._reg = registry or StatRegistry.instance()
        # touch every counter so the very first snapshot carries the
        # complete schema (shed_total == 0 is a statement, not a gap)
        for name in (ROUTED_AFFINITY, ROUTED_PREFIX, ROUTED_BALANCE,
                     ROUTED_RANDOM, ROUTED_SPILL, SHED_TOTAL,
                     MIGRATED_TOTAL, PREFIX_ROUTED_CONFIRMED,
                     PREFIX_ROUTED_MISSED, REPLICA_QUEUE_DEPTH,
                     REPLICA_HEARTBEAT_AGE, REPLICA_DEAD_TOTAL,
                     LIVE_MIGRATED_TOTAL, MIGRATED_REPLAY_TOKENS,
                     PAGE_ADOPTIONS, PAGES_ADOPTED,
                     BREAKER_OPEN_TOTAL, BREAKER_STATE,
                     REPLICA_TIMEOUT_TOTAL, WEDGE_KILL_TOTAL,
                     ORPHAN_REMIGRATED_TOTAL, RESPAWN_BACKOFF_S,
                     PD_HANDOFFS, PD_HANDOFF_TOKENS, PD_HANDOFF_WALL_S,
                     ROUTED_ROLE, PING_PROBE_TOTAL,
                     SUPERVISOR_RESTART_TOTAL, AUTOSCALE_SPAWNED,
                     AUTOSCALE_DRAINED, REPLICA_COUNT,
                     PAGE_RELAY_BYTES, PAGE_P2P_BYTES, PAGE_RAW_BYTES,
                     PAGE_TRANSFERS_FAILED, PAGE_TRANSFERS_CANCELLED,
                     PREFIX_INDEX_COMPACTIONS):
            self._reg.get_stat(name)

    def _stat(self, name):
        return self._reg.get_stat(name)

    def count_routed(self, rung):
        self._stat({"affinity": ROUTED_AFFINITY, "prefix": ROUTED_PREFIX,
                    "balance": ROUTED_BALANCE,
                    "random": ROUTED_RANDOM}[rung]).increase()

    def count_spill(self):
        self._stat(ROUTED_SPILL).increase()

    def count_shed(self):
        self._stat(SHED_TOTAL).increase()

    def count_migrated(self, n=1):
        if n:
            self._stat(MIGRATED_TOTAL).increase(n)

    def count_prefix_confirmed(self, hit):
        self._stat(PREFIX_ROUTED_CONFIRMED if hit
                   else PREFIX_ROUTED_MISSED).increase()

    def count_replica_dead(self):
        self._stat(REPLICA_DEAD_TOTAL).increase()

    def count_live_migrated(self, n=1):
        if n:
            self._stat(LIVE_MIGRATED_TOTAL).increase(n)

    def count_replay_tokens(self, n):
        """Stream tokens a COLD resubmit recomputes that the client
        already streamed (the relay swallows them) — live migration's
        structural 0 vs the cold baseline's full replay, per drain."""
        if n:
            self._stat(MIGRATED_REPLAY_TOKENS).increase(int(n))

    def count_page_adoption(self, pages):
        """One page-service transfer that indexed `pages` new pages on
        the adopting replica."""
        self._stat(PAGE_ADOPTIONS).increase()
        if pages:
            self._stat(PAGES_ADOPTED).increase(int(pages))

    def count_page_relay_bytes(self, n):
        """Page bytes that crossed the ROUTER's socket (relay path).
        The p2p zero-relay assertion reads this counter."""
        if n:
            self._stat(PAGE_RELAY_BYTES).increase(int(n))

    def count_page_p2p_bytes(self, wire, raw):
        """Page bytes that moved replica→replica on the data socket:
        `wire` as encoded (post-codec), `raw` what the same transfer
        would have weighed uncompressed — the compression ratio is
        raw/wire."""
        if wire:
            self._stat(PAGE_P2P_BYTES).increase(int(wire))
        if raw:
            self._stat(PAGE_RAW_BYTES).increase(int(raw))

    def count_transfer_failed(self):
        """One adoption transfer degraded typed to the cold-prefill
        ladder (holder/importer trouble, codec mismatch, deadline)."""
        self._stat(PAGE_TRANSFERS_FAILED).increase()

    def count_transfer_cancelled(self):
        """One queued transfer cancelled before moving bytes: the
        index no longer wants it (importer already holds the chain,
        or a party died)."""
        self._stat(PAGE_TRANSFERS_CANCELLED).increase()

    def count_index_compactions(self, chains):
        """One prefix-index GC sweep that dropped `chains` chains with
        no live holder."""
        if chains:
            self._stat(PREFIX_INDEX_COMPACTIONS).increase(int(chains))

    def count_breaker_open(self):
        """A circuit breaker tripped open: `breaker_threshold`
        consecutive transport faults took the replica out of every
        routing gate."""
        self._stat(BREAKER_OPEN_TOTAL).increase()

    def count_replica_timeout(self):
        """One bounded RPC missed its deadline (ReplicaTimeoutError)."""
        self._stat(REPLICA_TIMEOUT_TOTAL).increase()

    def count_wedge_kill(self):
        """The wedge watchdog killed an alive-but-stalled replica."""
        self._stat(WEDGE_KILL_TOTAL).increase()

    def count_orphan_remigrated(self):
        """A stream whose completion event was lost (idle worker,
        lingering ledger entry) was remigrated by the orphan sweep."""
        self._stat(ORPHAN_REMIGRATED_TOTAL).increase()

    def count_pd_handoff(self, tokens, wall_s):
        """One prefill→decode handoff: a finished prefill's page run
        shipped to a decode-class sibling.  `tokens` is the cache
        length that moved; `wall_s` the park-to-placement wall (gauge:
        the latest handoff's wall, the drain-latency signal)."""
        self._stat(PD_HANDOFFS).increase()
        if tokens:
            self._stat(PD_HANDOFF_TOKENS).increase(int(tokens))
        self._stat(PD_HANDOFF_WALL_S).set(round(float(wall_s), 4))

    def count_routed_role(self):
        """A request placed on a replica whose ROLE matched the
        request class (prefill-heavy → prefill replica, interactive →
        decode replica) — the segregation signal of the P/D rung."""
        self._stat(ROUTED_ROLE).increase()

    def count_ping_probe(self):
        """One synthetic watchdog ping probe sent to earn an idle
        replica's breaker its half-open recovery."""
        self._stat(PING_PROBE_TOTAL).increase()

    def count_supervisor_restart(self):
        """The control plane resurrected a dead/stopped replica."""
        self._stat(SUPERVISOR_RESTART_TOTAL).increase()

    def count_autoscale(self, up):
        self._stat(AUTOSCALE_SPAWNED if up
                   else AUTOSCALE_DRAINED).increase()

    def set_replica_count(self, n):
        self._stat(REPLICA_COUNT).set(int(n))

    def set_breaker_state(self, name, score):
        """0 = closed, 1 = half-open, 2 = open; bare gauge = max."""
        self._stat(f"{BREAKER_STATE}.{name}").set(int(score))

    def set_max_breaker_state(self, score):
        self._stat(BREAKER_STATE).set(int(score))

    def set_respawn_backoff(self, name, backoff_s):
        self._stat(f"{RESPAWN_BACKOFF_S}.{name}").set(
            round(float(backoff_s), 3))
        self._stat(RESPAWN_BACKOFF_S).set(round(float(backoff_s), 3))

    def set_heartbeat_age(self, name, age):
        self._stat(f"{REPLICA_HEARTBEAT_AGE}.{name}").set(
            round(float(age), 3))

    def set_max_heartbeat_age(self, age):
        self._stat(REPLICA_HEARTBEAT_AGE).set(round(float(age), 3))

    def set_replica_queue_depth(self, name, depth):
        self._stat(f"{REPLICA_QUEUE_DEPTH}.{name}").set(int(depth))

    def set_max_queue_depth(self, depth):
        self._stat(REPLICA_QUEUE_DEPTH).set(int(depth))

    def snapshot(self):
        return {k: v for k, v in self._reg.stats().items()
                if k.startswith(PREFIX)}


class CircuitBreaker:
    """Per-replica consecutive-failure circuit breaker.

    States::

        closed ──(threshold consecutive transport FAULTS)──> open
        open ──(cooldown elapsed AND a fresh heartbeat)──> half-open
        half-open ──(probe success)──> closed
        half-open ──(probe failure)──> open (cooldown re-arms)

    A FAULT is a transport failure — an RPC deadline miss, a dead
    channel — never an admission-load rejection (`ServerBusyError` is
    back-pressure, not breakage: it feeds the load score, not the
    breaker).  While open the replica leaves EVERY routing gate; the
    half-open probe rides heartbeat recovery (the replica proved it is
    alive again) and admits exactly one request, whose outcome decides
    the state.  Thread-safe: router threads, transport reader threads,
    and the watchdog all touch it."""

    STATE_SCORE = {"closed": 0, "half-open": 1, "open": 2}

    def __init__(self, threshold=3, cooldown_s=1.0, on_open=None):
        if int(threshold) < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.failures = 0
        self._opened_at = 0.0
        self._probe = False
        self._on_open = on_open
        self._lock = threading.Lock()

    @property
    def score(self):
        """The gauge encoding: 0 closed, 1 half-open, 2 open."""
        return self.STATE_SCORE[self.state]

    def _half_open_ready(self, hb_age, hb_fresh_s):
        return (time.monotonic() - self._opened_at >= self.cooldown_s
                and float(hb_age) <= float(hb_fresh_s))

    def routable(self, hb_age=0.0, hb_fresh_s=1.0):
        """Read-only gate for candidate filtering: could a request be
        admitted here right now?  Never claims the half-open probe —
        that happens in admit(), at the moment of actual submission."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return self._half_open_ready(hb_age, hb_fresh_s)
            return not self._probe

    def admit(self, hb_age=0.0, hb_fresh_s=1.0):
        """The submission-time gate: like routable(), but an open
        breaker whose cooldown elapsed under a fresh heartbeat
        transitions to half-open HERE, and the caller claims the one
        probe slot — record_success/record_failure/record_busy MUST
        follow, or the probe slot stays taken."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if not self._half_open_ready(hb_age, hb_fresh_s):
                    return False
                self.state = "half-open"
                self._probe = False
            if self._probe:
                return False
            self._probe = True
            return True

    def record_success(self):
        with self._lock:
            self.failures = 0
            self._probe = False
            self.state = "closed"

    def record_busy(self):
        """Admission-load rejection: releases a claimed probe without
        counting a fault — a busy replica is healthy."""
        with self._lock:
            self._probe = False

    def record_failure(self):
        with self._lock:
            self.failures += 1
            self._probe = False
            if self.state == "half-open" \
                    or self.failures >= self.threshold:
                reopened = self.state != "open"
                self.state = "open"
                self._opened_at = time.monotonic()
            else:
                return
        if reopened and self._on_open is not None:
            self._on_open()

    def reset(self):
        """Administrative reset (restart() rebuilds the replica — its
        fault history died with the old process)."""
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self._probe = False


class ReplicaSpec:
    """One replica's build recipe: a protocol model plus its OWN
    GenerationConfig — heterogeneous fleets (long-context next to
    low-latency) are just different specs behind one router.  The
    router keeps the spec so `restart(name)` can rebuild the engine
    after a drain.

    transport: "inproc" (direct-object engine, the deterministic CPU
        oracle path), "proc" (one OS process per replica behind the
        SubprocTransport RPC boundary — model and config must pickle,
        mesh configs are rejected; see serving/disagg), or "tcp" (the
        same worker process dialing back over a real TCP socket — the
        cross-host rung; see serving/disagg/tcp.py).  A
        FleetConfig.transport override applies to every spec.
    role: "mixed" (default — prefills and decodes, the classic
        replica), "prefill" (chews prompts; at prefill completion the
        router ships the finished page run to a decode-class sibling
        that streams the rest), or "decode" (preferred target of both
        the interactive-request rung and prefill handoffs).  Role is a
        ROUTING PREFERENCE, never a capability wall: any replica can
        still serve any request when its preferred class is full.
    host / port: the TCP listener's bind address for transport="tcp"
        (default 127.0.0.1 / ephemeral); ignored by other kinds."""

    __slots__ = ("name", "model", "config", "transport", "role",
                 "host", "port")

    def __init__(self, name, model, config=None, transport="inproc",
                 role="mixed", host=None, port=None):
        self.name = str(name)
        self.model = model
        self.config = config
        if transport not in ("inproc", "proc", "tcp"):
            raise ValueError(
                f"transport must be 'inproc', 'proc' or 'tcp', got "
                f"{transport!r}")
        self.transport = transport
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'mixed', got "
                f"{role!r}")
        self.role = role
        self.host = host
        self.port = None if port is None else int(port)


class _MigrationRelay:
    """Engine-side handle adapter for a drain-migrated request.

    The sibling replica re-runs the prompt COLD; because sampling is
    seeded per request, the resubmitted stream is token-identical to
    the original, so this relay swallows the first `skip` tokens (the
    client already streamed them from the draining replica) and
    forwards the rest into the client's untouched handle — the client
    observes one continuous, gap-free, duplicate-free stream.  TTFT
    probes and the prefix_hit_tokens stamp stay the CLIENT handle's:
    first admission wins, exactly as for preemption re-admission."""

    __slots__ = ("_client", "_skip", "_skip0", "_pushed", "submitted_s",
                 "first_token_s")

    def __init__(self, client, skip):
        self._client = client
        self._skip = int(skip)
        self._skip0 = int(skip)
        self._pushed = 0
        self.submitted_s = None      # own clock; client keeps original
        self.first_token_s = None

    @property
    def prefix_hit_tokens(self):
        return self._client.prefix_hit_tokens

    @prefix_hit_tokens.setter
    def prefix_hit_tokens(self, v):
        self._client.prefix_hit_tokens = v

    def client_and_delivered(self):
        """(client handle, stream tokens the client has received) — the
        skip count a SECOND migration of the same request needs.  The
        client's own n_streamed counter is the FLOOR: whatever the
        relay bookkeeping says, a replay must never re-push a token
        the client already has."""
        return self._client, max(self._skip0, self._pushed,
                                 getattr(self._client, "n_streamed", 0))

    def _push_token(self, token):
        if self.first_token_s is None:
            self.first_token_s = time.monotonic()
        self._pushed += 1
        if self._skip > 0:
            self._skip -= 1
            return
        self._client._push_token(token)

    def _finish(self, result):
        # the replayed result IS the request's result: token_ids cover
        # the whole stream, already delivered + newly forwarded
        self._client._finish(result)

    def set_exception(self, exc):
        self._client.set_exception(exc)

    def done(self):
        return self._client.done()


class _Replica:
    """One live replica BEHIND A TRANSPORT: the router's view is the
    duck-typed transport contract (serving/disagg/transport.py) — an
    in-process engine and a subprocess replica look identical from
    here — plus the admission state the router flips and the measured
    TTFT EWMA the latency-aware load score folds in."""

    _TTFT_EWMA_ALPHA = 0.3   # same smoothing as generation.tokens_per_s
    _TTFT_LOAD_CAP = 4.0     # a slow replica weighs at most like this
    # many queued requests: bounded back-pressure, never starvation

    def __init__(self, spec, start, transport_kind, on_death=None,
                 rpc=None, fault_plan=None, breaker=None):
        self.spec = spec
        self.kind = transport_kind
        self.state = "stopped"
        self.transport = None
        self._describe = None
        self._on_death = on_death
        self._rpc = rpc
        self._fault_plan = fault_plan
        # the chaos-hardening state the router keeps PER replica: a
        # consecutive-failure circuit breaker and the respawn-backoff
        # clocks (consecutive quick deaths ⇒ exponential restart
        # backoff, capped into a crash-loop refusal)
        self.breaker = breaker or CircuitBreaker()
        self.respawns = 0
        self.built_at = 0.0
        self.died_at = None
        # measured time-to-first-token EWMA (seconds; None = no sample
        # yet).  Updated from handle done-callbacks, which fire on
        # engine worker threads — the float swap is a benign last-
        # writer-wins race for a smoothed load signal.
        self.ttft_ewma = None
        self.build(start)

    def observe_ttft(self, handle):
        """Fold one completed request's measured TTFT into the EWMA
        (requests that never produced a first token — typed failures,
        sheds — carry no latency signal and are skipped)."""
        if handle.first_token_s is None or handle.submitted_s is None:
            return
        ttft = handle.first_token_s - handle.submitted_s
        if ttft < 0:
            return
        prev = self.ttft_ewma
        self.ttft_ewma = (ttft if prev is None else
                          self._TTFT_EWMA_ALPHA * ttft
                          + (1 - self._TTFT_EWMA_ALPHA) * prev)

    def build(self, start):
        self.transport = build_transport(self.spec, self.kind,
                                         start=start, rpc=self._rpc,
                                         fault_plan=self._fault_plan)
        self.transport.on_death = self._on_death
        self._describe = self.transport.describe()
        self.state = "serving"
        self.built_at = time.monotonic()
        self.died_at = None
        # a rebuilt replica is a new process in spirit: its latency
        # and fault history died with the old engine
        self.ttft_ewma = None
        self.breaker.reset()

    @property
    def name(self):
        return self.spec.name

    @property
    def role(self):
        return getattr(self.spec, "role", "mixed")

    @property
    def accepting(self):
        return self.state == "serving" and self.transport.alive()

    @property
    def engine(self):
        """The direct engine object — inproc transports only (tests
        and the stepped oracle drive it); None across a process
        boundary."""
        return getattr(self.transport, "engine", None)

    @property
    def registry(self):
        return getattr(self.transport, "registry", None)

    def can_fit(self, prompt_len, max_new):
        """Could this replica EVER hold the request (pool + positions)?
        The capacity pre-filter that makes heterogeneous fleets work:
        a long prompt routes straight to the long-context replica
        instead of bouncing off a small one's typed rejection.
        Answered from the transport's static describe() — no RPC on
        the routing path."""
        d = self._describe
        if math.ceil((prompt_len + 1) / d["page_size"]) > d["num_pages"]:
            return False
        max_pos = d["max_positions"]
        mn = (d["default_max_new_tokens"] if max_new is None
              else int(max_new))
        return max_pos is None or prompt_len + mn <= max_pos

    def load(self, ttft_baseline=None):
        """Queue depth + live slots + resident-page fraction + measured
        latency — what 'least loaded' compares.  Pages enter as a
        FRACTION so queue position dominates and pool residency breaks
        ties (a replica with warm pages but an empty queue still reads
        near-idle).  `ttft_baseline` (the fastest candidate's TTFT
        EWMA) folds LATENCY in as a relative term: a replica measuring
        k-times the baseline TTFT carries k-1 extra load — a 2x-slower
        replica weighs like one extra queued request — CAPPED at
        _TTFT_LOAD_CAP so one pathological sample against a
        microsecond baseline cannot starve the replica forever: once
        the fast sibling queues past the cap, traffic flows back, the
        slow replica completes requests, and its EWMA decays (it only
        updates on completions).  Under skewed prompt lengths new
        traffic therefore drains toward the replica actually answering
        fast, without ever wedging the slow one out of the fleet.
        Replicas with no sample yet (or without a baseline) add
        nothing — cold replicas are worth probing, not penalizing.
        Load reads the transport's load_info: exact for inproc,
        heartbeat-fresh for subprocess replicas."""
        info = self.transport.load_info()
        score = (info["queue_depth"] + info["active"]
                 + info["pages_in_use"] / max(1, info["num_pages"]))
        if ttft_baseline and self.ttft_ewma:
            score += min(self.ttft_ewma / ttft_baseline - 1.0,
                         self._TTFT_LOAD_CAP)
        return score

    def queue_depth(self):
        return self.transport.load_info()["queue_depth"]


class FleetConfig:
    """Router knobs.

    routing: "affinity" (the session → prefix → least-loaded ladder)
        or "random" (uniform choice — the A/B baseline the ladder is
        measured against).
    affinity_block_tokens: page alignment of the prefix-affinity hash —
        the prompt's leading ``floor((len-1)/block)*block`` tokens are
        hashed (matching match_prefix's full-page, clip-to-len-1
        semantics so the hash covers exactly what a warm hit could
        alias).  None = auto: the smallest page_size in the fleet.
    start: start each replica engine's background worker (tests drive
        steps themselves via run_until_idle and pass False).
    seed: the random-routing RNG seed (reproducible A/B benches).
    transport: override EVERY spec's transport — "inproc", "proc",
        "tcp", or None (each ReplicaSpec keeps its own).
    pd_prefill_threshold_tokens: the P/D routing split — a prompt at
        least this long prefers prefill-class replicas (whose finished
        runs hand off to decode-class siblings); shorter interactive
        requests prefer decode-class replicas so a prompt wave never
        queues ahead of their first token.  Only matters when the
        fleet has non-mixed roles.
    min_replicas / max_replicas: the autoscaler's bounds
        (serving/control.py FleetSupervisor spawns under sustained
        queue depth / TTFT pressure up to `max_replicas`, drains its
        own spawns at idle down to `min_replicas`; None max = never
        scale up beyond the configured specs).
    live_migration: drain/crash migration ships resident sequence
        state to a sibling that RESUMES mid-decode (True, the
        default — migrated_replay_tokens stays 0); False restores the
        cold-resubmit-only path (seeded replay, the ablation baseline).
    heartbeat_dead_after: seconds without a heartbeat before a
        subprocess replica is declared dead (hung, not crashed — a
        crash is caught instantly by socket EOF) and its in-flight
        ledger remigrates.  Inproc replicas never age.
    page_service: fleet-level prefix index + point-to-point page
        transfer (True, the default under routing="affinity"); False
        keeps the stable-hash prefix guess only.

    Data-plane knobs (docs/SERVING.md "Data plane"):

    page_transfer: "p2p" (default — adoption bytes move on a direct
        replica→replica data socket; the router socket carries ZERO
        page bytes) or "relay" (the export-through-the-router
        baseline, also the automatic fallback while a replica's data
        port is not yet advertised).
    page_codec: "compressed" (default — pagecodec delta+zlib with
        per-array raw fallback) or "raw" (passthrough, the A/B
        baseline).  Applies to the p2p wire; the relay baseline
        always ships raw.
    async_adoption: True (default) ships adoption AFTER routing
        returns — the request prefills cold immediately and arriving
        pages warm the NEXT request; False restores the synchronous
        adopt-before-submit path (deterministic tests, ablation).
    max_inflight_transfers: per-importing-replica bound on concurrent
        adoption transfers the async scheduler allows (>= 1).

    Chaos-hardening knobs (docs/SERVING.md "Failure model"):

    rpc_timeout_s / rpc_retries / rpc_backoff_s: the bounded-RPC
        policy every subprocess replica's transport runs — a default
        deadline on EVERY `_call` (never unbounded), with idempotent
        ops retrying up to `rpc_retries` total attempts under
        exponential backoff (+ seeded jitter) from `rpc_backoff_s`.
    breaker_threshold / breaker_cooldown_s: per-replica circuit
        breaker — `threshold` CONSECUTIVE transport faults (timeouts,
        dead channels; never ServerBusyError) open it, taking the
        replica out of every routing gate; after `cooldown_s` a fresh
        heartbeat earns a single half-open probe request.
    wedge_after_s / wedge_hard_after_s: an alive-but-STALLED replica
        (heartbeats flow, the engine's step-progress stamp is frozen
        while it reports work) is killed and remigrated like a crash.
        The soft clock fires after `wedge_after_s` only when the
        engine is NOT inside a step (the step loop cannot take its
        own lock — a true wedge); an engine mid-step (a first-shape
        step or a loop capture is legitimate work) gets the hard ceiling
        `wedge_hard_after_s` (None = 10x the soft clock).
    orphan_grace_s: a stream whose worker reports idle for this long
        while its ledger entry lingers (lost completion event) is
        remigrated by the watchdog's orphan sweep.
    respawn_backoff_s / respawn_backoff_cap_s / max_respawns /
    respawn_reset_s: `restart()` of a replica that died within
        `respawn_reset_s` of its build waits an exponential backoff
        (base * 2^(n-1), capped at the cap); after `max_respawns`
        consecutive quick deaths restart refuses typed (crash loop) —
        `reset_respawn(name)` is the operator override.
    fault_plans: {replica_name: serving.disagg.faults.FaultPlan} —
        deterministic chaos injection on the replica's RPC codec
        (proc transports only; tests/drills, never production).
    watchdog_interval_s: background watchdog sweep period for fleets
        with subprocess replicas (None = auto from the thresholds).
    """

    def __init__(self, routing="affinity", affinity_block_tokens=None,
                 start=True, seed=None, transport=None,
                 live_migration=True, heartbeat_dead_after=10.0,
                 page_service=True, rpc_timeout_s=15.0, rpc_retries=3,
                 rpc_backoff_s=0.05, breaker_threshold=3,
                 breaker_cooldown_s=1.0, wedge_after_s=10.0,
                 wedge_hard_after_s=None,
                 orphan_grace_s=5.0, respawn_backoff_s=0.5,
                 respawn_backoff_cap_s=30.0, max_respawns=5,
                 respawn_reset_s=30.0, fault_plans=None,
                 watchdog_interval_s=None,
                 pd_prefill_threshold_tokens=64,
                 min_replicas=1, max_replicas=None,
                 page_transfer="p2p", page_codec="compressed",
                 async_adoption=True, max_inflight_transfers=2):
        if routing not in ("affinity", "random"):
            raise ValueError(
                f"routing must be 'affinity' or 'random', got {routing!r}")
        self.routing = routing
        if affinity_block_tokens is not None \
                and int(affinity_block_tokens) < 1:
            raise ValueError(
                f"affinity_block_tokens must be >= 1 or None (auto), "
                f"got {affinity_block_tokens}")
        self.affinity_block_tokens = (
            None if affinity_block_tokens is None
            else int(affinity_block_tokens))
        self.start = bool(start)
        self.seed = seed
        if transport not in (None, "inproc", "proc", "tcp"):
            raise ValueError(
                f"transport must be 'inproc', 'proc', 'tcp' or None "
                f"(per-spec), got {transport!r}")
        self.transport = transport
        self.live_migration = bool(live_migration)
        self.heartbeat_dead_after = float(heartbeat_dead_after)
        self.page_service = bool(page_service)
        # RpcPolicy validates timeout/retries/backoff on construction
        # — fail HERE, not at the first replica build
        RpcPolicy(rpc_timeout_s, rpc_retries, rpc_backoff_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_retries = int(rpc_retries)
        self.rpc_backoff_s = float(rpc_backoff_s)
        if int(breaker_threshold) < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got "
                             f"{breaker_threshold}")
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        for knob, val in (("wedge_after_s", wedge_after_s),
                          ("orphan_grace_s", orphan_grace_s),
                          ("respawn_backoff_cap_s",
                           respawn_backoff_cap_s),
                          ("respawn_reset_s", respawn_reset_s)):
            if float(val) <= 0:
                raise ValueError(f"{knob} must be > 0, got {val}")
        self.wedge_after_s = float(wedge_after_s)
        if wedge_hard_after_s is not None \
                and float(wedge_hard_after_s) <= 0:
            raise ValueError(f"wedge_hard_after_s must be > 0 or None "
                             f"(auto 10x), got {wedge_hard_after_s}")
        self.wedge_hard_after_s = (None if wedge_hard_after_s is None
                                   else float(wedge_hard_after_s))
        self.orphan_grace_s = float(orphan_grace_s)
        if float(respawn_backoff_s) < 0:
            raise ValueError(f"respawn_backoff_s must be >= 0, got "
                             f"{respawn_backoff_s}")
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_cap_s = float(respawn_backoff_cap_s)
        if int(max_respawns) < 1:
            raise ValueError(
                f"max_respawns must be >= 1, got {max_respawns}")
        self.max_respawns = int(max_respawns)
        self.respawn_reset_s = float(respawn_reset_s)
        self.fault_plans = dict(fault_plans) if fault_plans else None
        if watchdog_interval_s is not None \
                and float(watchdog_interval_s) <= 0:
            raise ValueError(f"watchdog_interval_s must be > 0 or None, "
                             f"got {watchdog_interval_s}")
        self.watchdog_interval_s = (
            None if watchdog_interval_s is None
            else float(watchdog_interval_s))
        if int(pd_prefill_threshold_tokens) < 1:
            raise ValueError(
                f"pd_prefill_threshold_tokens must be >= 1, got "
                f"{pd_prefill_threshold_tokens}")
        self.pd_prefill_threshold_tokens = int(pd_prefill_threshold_tokens)
        if int(min_replicas) < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        self.min_replicas = int(min_replicas)
        if max_replicas is not None \
                and int(max_replicas) < self.min_replicas:
            raise ValueError(
                f"max_replicas must be >= min_replicas="
                f"{self.min_replicas} or None, got {max_replicas}")
        self.max_replicas = (None if max_replicas is None
                             else int(max_replicas))
        if page_transfer not in ("relay", "p2p"):
            raise ValueError(
                f"page_transfer must be 'relay' or 'p2p', got "
                f"{page_transfer!r}")
        self.page_transfer = page_transfer
        if page_codec not in ("raw", "compressed"):
            raise ValueError(
                f"page_codec must be 'raw' or 'compressed', got "
                f"{page_codec!r}")
        self.page_codec = page_codec
        self.async_adoption = bool(async_adoption)
        if int(max_inflight_transfers) < 1:
            raise ValueError(
                f"max_inflight_transfers must be >= 1, got "
                f"{max_inflight_transfers}")
        self.max_inflight_transfers = int(max_inflight_transfers)


class _TransferScheduler:
    """The async adoption executor: a tiny bounded thread
    pool that moves page bytes AFTER routing returned.  Transfers
    dedup per (importer, chain) — back-to-back requests for one warm
    prefix enqueue one transfer — and each importing replica is
    bounded to `max_inflight` concurrent imports so a popular replica
    cannot be flooded with payloads.  Execution re-checks the fleet
    index first and CANCELS transfers nobody wants anymore (the
    importer registered the chain itself while queued, a party died).
    Everything runs off the routing path: a slow holder costs cold
    prefills, never admission latency."""

    WORKERS = 2

    def __init__(self, router, max_inflight=2):
        self._router = router
        self._max = int(max_inflight)
        self._cv = threading.Condition()
        self._queue = []       # pending transfer dicts, FIFO
        self._keys = set()     # (importer, chain) queued or in flight
        self._inflight = {}    # importer name -> live transfer count
        self._stopped = False
        self._threads = [
            threading.Thread(target=self._loop,
                             name=f"fleet-transfer-{i}", daemon=True)
            for i in range(self.WORKERS)]
        for t in self._threads:
            t.start()

    def request(self, prompt, importer, holder, chain):
        """Enqueue one adoption transfer; False = duplicate/stopped."""
        key = (importer, chain)
        with self._cv:
            if self._stopped or key in self._keys:
                return False
            self._keys.add(key)
            self._queue.append({"prompt": list(prompt),
                                "importer": importer,
                                "holder": holder, "chain": chain})
            self._cv.notify()
        return True

    def _next_locked(self):
        for i, t in enumerate(self._queue):
            if self._inflight.get(t["importer"], 0) < self._max:
                return i
        return None

    def _loop(self):
        while True:
            with self._cv:
                while True:
                    if self._stopped:
                        return
                    i = self._next_locked()
                    if i is not None:
                        break
                    self._cv.wait(0.1)
                t = self._queue.pop(i)
                self._inflight[t["importer"]] = \
                    self._inflight.get(t["importer"], 0) + 1
            try:
                self._router._execute_transfer(t)
            except Exception:   # noqa: BLE001 — a transfer is an
                pass            # optimization; failures are counted
            finally:            # typed inside _execute_transfer
                with self._cv:
                    self._inflight[t["importer"]] -= 1
                    self._keys.discard((t["importer"], t["chain"]))
                    self._cv.notify_all()

    def idle(self):
        with self._cv:
            return not self._queue \
                and not any(self._inflight.values())

    def wait_idle(self, timeout=30.0):
        """Block until queue and in-flight transfers drain (tests and
        run_until_idle); False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or any(self._inflight.values()):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def stop(self):
        with self._cv:
            self._stopped = True
            self._queue.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)


class FleetRouter:
    """N GenerationEngine replicas behind one `submit()` with the same
    streaming GenerationHandle contract as a single engine."""

    def __init__(self, specs, config=None, metrics=None):
        if not specs:
            raise ValueError("a fleet needs at least one ReplicaSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.config = config or FleetConfig()
        self.metrics = metrics or FleetMetrics()
        self._page_index = FleetPrefixIndex()
        # handoff runs awaiting a decode slot: [(item, src_name), ...].
        # Guarded by self._lock; drained and re-parked by
        # _collect_handoffs (backpressure instead of cold replay).
        self._pending_handoffs = []
        cfg = self.config
        if cfg.fault_plans:
            unknown = set(cfg.fault_plans) - set(names)
            if unknown:
                raise ValueError(
                    f"fault_plans name unknown replicas: {sorted(unknown)}")
        rpc = RpcPolicy(cfg.rpc_timeout_s, cfg.rpc_retries,
                        cfg.rpc_backoff_s, seed=cfg.seed or 0)
        self._replicas = {
            s.name: _Replica(
                s, cfg.start, cfg.transport or s.transport,
                on_death=self._on_transport_death, rpc=rpc,
                fault_plan=(cfg.fault_plans or {}).get(s.name),
                breaker=CircuitBreaker(
                    cfg.breaker_threshold, cfg.breaker_cooldown_s,
                    on_open=self._on_breaker_open))
            for s in specs}
        block = self.config.affinity_block_tokens
        if block is None:
            block = min(r._describe["page_size"]
                        for r in self._replicas.values())
        self._block = int(block)
        self._sessions = {}          # session id -> replica name
        self._rng = np.random.default_rng(self.config.seed)
        self._lock = threading.Lock()
        self._closed = False
        self._transfers = None   # lazy async-adoption scheduler
        # a heartbeat this recent counts as "recovered" for the
        # breaker's half-open probe (inproc ages are 0 — always fresh)
        self._hb_fresh_s = max(1.0, 4 * HEARTBEAT_S)
        self._watchdog_gate = threading.Lock()   # one sweep at a time
        self._watchdog_stop = threading.Event()
        self._watchdog_thread = None
        for rep in self._replicas.values():
            self._wire_handoff(rep)
        self._ensure_watchdog()

    def _ensure_watchdog(self):
        """Start the background watchdog when the fleet needs one:
        process/TCP replicas (stale-heartbeat reaping, wedge kills,
        orphan sweeps cannot depend on traffic arriving) or started
        prefill replicas (parked handoffs must drain even when nobody
        is calling run_until_idle).  Idempotent — add_replica() calls
        it again when the fleet's composition changes."""
        if self._watchdog_thread is not None:
            return
        cfg = self.config
        reps = self._replicas.values()
        if not (any(r.kind in ("proc", "tcp") for r in reps)
                or (cfg.start and any(r.role == "prefill"
                                      for r in reps))):
            return
        interval = cfg.watchdog_interval_s
        if interval is None:
            interval = max(0.05, min(cfg.heartbeat_dead_after,
                                     cfg.wedge_after_s,
                                     cfg.orphan_grace_s) / 4)
        self._watchdog_interval = float(interval)
        self._watchdog_thread = threading.Thread(
            target=self._watchdog_loop, name="fleet-watchdog",
            daemon=True)
        self._watchdog_thread.start()

    def _wire_handoff(self, rep):
        """Event-driven prefill→decode handoff: a prefill replica's
        transport (or inproc engine) notifies the router the moment a
        parked run is ready, so placement latency is not bound to a
        polling interval.  The watchdog/run_until_idle pulls stay as
        the backstop (a notification raced with shutdown, a replica
        rebuilt by restart())."""
        if rep.role != "prefill":
            return
        if not self.config.start:
            # stepped fleets are single-threaded by contract:
            # run_until_idle's deterministic pull IS the collector, and
            # a poke thread here could take a parked snap while the
            # step loop reads "everything idle" and returns — placing
            # work into a replica nothing will ever step again
            return
        eng = rep.engine
        if eng is not None:
            eng.on_handoff = self._poke_handoffs
        else:
            rep.transport.on_handoff = self._poke_handoffs

    def _poke_handoffs(self):
        """Handoff notification entry point.  Placement runs on its
        own short-lived thread: the notifier is an engine step thread
        or a transport reader thread, and placement may issue RPCs
        (sibling imports, page adoption) that must never block either
        — a reader thread waiting on its OWN channel's RPC reply would
        deadlock until the deadline."""
        threading.Thread(target=self._collect_handoffs,
                         name="fleet-handoff", daemon=True).start()

    # --------------------------- routing ----------------------------
    def _prefix_key(self, prompt):
        """CRC over the prompt's leading page-aligned tokens (clipped
        to len-1, mirroring match_prefix: the last token always
        prefills).  None when no full block fits — nothing a prefix
        index could hold."""
        n = (len(prompt) - 1) // self._block * self._block
        if n <= 0:
            return None
        return zlib.crc32(np.asarray(prompt[:n], np.int64).tobytes())

    def _candidates(self, prompt_len, max_new):
        return [r for r in self._replicas.values()
                if r.accepting and r.can_fit(prompt_len, max_new)]

    def _pull_prefix_deltas(self):
        """Ingest every live replica's register/evict deltas into the
        fleet prefix index — the measured bookkeeping that replaced
        the CRC guess.  Subprocess replicas accumulate deltas from
        heartbeat frames (no RPC here); inproc replicas drain their
        cache log directly."""
        for rep in self._replicas.values():
            if rep.state in ("stopped", "dead"):
                continue
            try:
                deltas = rep.transport.take_prefix_deltas()
            except ServingError:
                continue
            if deltas:
                self._page_index.apply(rep.name, deltas)

    def _index_lookup(self, prompt):
        """Deepest measured chain for `prompt` across the fleet's
        page-size MENU: each replica's cache hashes chains with its
        OWN page_size, so one lookup per distinct size — filtered to
        the replicas that hash that way — keeps a heterogeneous fleet
        (or an affinity_block_tokens override) fully visible to the
        index instead of silently matching only the min-page-size
        replicas.  Deepest matched-token count wins."""
        sizes = {}
        for r in self._replicas.values():
            if r.state in ("stopped", "dead"):
                continue
            sizes.setdefault(r._describe["page_size"],
                             set()).add(r.name)
        best = None
        for ps, names in sizes.items():
            hit = self._page_index.lookup(prompt, ps, names=names)
            if hit is not None and (best is None or hit[1] > best[1]):
                best = hit
        return best

    def _watchdog_loop(self):
        while not self._watchdog_stop.wait(self._watchdog_interval):
            try:
                self._watchdog()
            except Exception:   # noqa: BLE001 — a watchdog sweep must
                pass            # never die; the next tick retries

    def _watchdog(self):
        """One robustness sweep — runs on every submit, every
        stats_snapshot, and the background watchdog thread (fleets
        with process replicas); reentrancy-guarded and called OUTSIDE
        the routing lock.  Three hunts, all ending in the same death/
        remigration path so streams never hang:

        1. STALE HEARTBEAT: no beat for `heartbeat_dead_after` — a
           hung process (a crashed one is caught instantly by socket
           EOF) — kill + remigrate.
        2. WEDGE: heartbeats flow but the engine's step-progress stamp
           is frozen while the replica reports work (`wedge_after_s`)
           — the heartbeat thread outliving a wedged engine loop —
           kill + remigrate, counted in fleet.wedge_kill_total.
        3. ORPHANS: the worker reports idle while ledger entries
           linger past `orphan_grace_s` (a lost completion event) —
           remigrate just those streams (the replica stays up)."""
        if not self._watchdog_gate.acquire(blocking=False):
            return
        try:
            cfg = self.config
            self._collect_handoffs()
            for rep in list(self._replicas.values()):
                if rep.state != "serving":
                    continue
                t = rep.transport
                if not t.alive():
                    continue   # the death path is already running
                if t.heartbeat_age() > cfg.heartbeat_dead_after:
                    self._kill_replica(rep)
                    continue
                wedged = getattr(t, "wedged", None)
                if wedged is not None and wedged(cfg.wedge_after_s,
                                                 cfg.wedge_hard_after_s):
                    self.metrics.count_wedge_kill()
                    self._kill_replica(rep)
                    continue
                orphans = getattr(t, "take_orphans", None)
                if orphans is not None:
                    for entry in orphans(cfg.orphan_grace_s):
                        self.metrics.count_orphan_remigrated()
                        self._remigrate_entry(entry, exclude=None)
                # synthetic PING probe: an IDLE fleet sends no traffic,
                # so a recovered replica's open breaker would never see
                # the half-open probe request that closes it.  The
                # watchdog claims the probe slot itself and spends a
                # ping on it — success closes the breaker, failure
                # re-arms the cooldown.
                if rep.breaker.state != "closed" and rep.breaker.admit(
                        t.heartbeat_age(), self._hb_fresh_s):
                    self.metrics.count_ping_probe()
                    try:
                        t.ping()
                    except ServingError:
                        rep.breaker.record_failure()
                    else:
                        rep.breaker.record_success()
            # prefix-index GC: drop holder entries for replicas no
            # longer serving — belt-and-braces memory bound alongside
            # the death path's eager drop_replica
            with self._lock:
                live = [r.name for r in self._replicas.values()
                        if r.state == "serving"]
                dropped = self._page_index.compact(live)
            if dropped:
                self.metrics.count_index_compactions(dropped)
        finally:
            self._watchdog_gate.release()

    # --------------------- prefill→decode handoff -------------------
    # How long a handed-off run waits parked for a decode slot before
    # the cold-resubmit fallback (which REPLAYS the prefill) is taken.
    # Parking is free — the snap's pages already left the prefill pool
    # and live parent-side — so a saturated decode class exerts plain
    # backpressure instead of burning replayed tokens.
    HANDOFF_PATIENCE_S = 5.0

    def _collect_handoffs(self):
        """Drain every prefill replica's parked handoffs and place each
        finished page run on a decode-class sibling (live import — zero
        replayed tokens).  A run no sibling can seat RIGHT NOW (decode
        slots full) re-parks in the pending queue and is retried on
        every later pass; only past HANDOFF_PATIENCE_S does it fall to
        the cold seeded resubmit.  Called event-driven (transport/
        engine handoff notifications), from every watchdog sweep, and
        from run_until_idle — all paths funnel through the same
        placement so a handoff can never strand.  Returns the number
        of runs moved."""
        if self._closed:
            return 0
        with self._lock:
            pending, self._pending_handoffs = self._pending_handoffs, []
        for rep in list(self._replicas.values()):
            if rep.role != "prefill" or rep.state in ("stopped", "dead"):
                continue
            take = getattr(rep.transport, "take_handoffs", None)
            if take is None:
                continue
            try:
                items = take()
            except ServingError:
                continue
            pending.extend((item, rep.name) for item in items)
        moved = 0
        parked = []
        for item, src in pending:
            if self._place_handoff(item, exclude=src):
                moved += 1
            else:
                parked.append((item, src))
        if parked:
            with self._lock:
                # new arrivals raced in behind us; keep oldest first
                self._pending_handoffs = parked + self._pending_handoffs
        return moved

    def _place_handoff(self, item, exclude):
        """Place ONE handed-off run.  The snap's pages were freed at
        export (the bytes ride the snap), so the prefill replica's
        pool is already clear; placement is exactly the live-migration
        ladder with the decode class preferred.  Returns True when the
        run found a home (live adoption, or — past the patience
        window — the cold ladder), False to re-park and retry."""
        snap = item["snap"]
        now = time.monotonic()
        waited = max(0.0, now - item.get("t", now))
        patient = waited < self.HANDOFF_PATIENCE_S
        adopted = self._migrate_live(snap, exclude=exclude,
                                     prefer_role="decode",
                                     cold_fallback=not patient)
        if not adopted and patient:
            return False
        self.metrics.count_pd_handoff(
            int(snap.get("cache_len") or 0), waited)
        return True

    def _kill_replica(self, rep):
        kill = getattr(rep.transport, "kill", None)
        if kill is not None:
            kill()
        self._handle_death(rep.transport)

    def _on_breaker_open(self):
        self.metrics.count_breaker_open()

    def _ladder(self, session, key, candidates, holder=None):
        """The ordered (rung, replica) preference list.  Position 0 is
        the ROUTE; everything after it is the spill path (remaining
        candidates, least loaded first).  The prefix rung prefers the
        replica the FLEET INDEX measured as holding the prompt's
        deepest cached chain (`holder`); prompts no index entry covers
        fall back to the stable-hash guess, which keeps cold traffic
        converging on one replica so its index warms."""
        if self.config.routing == "random":
            order = list(candidates)
            self._rng.shuffle(order)
            return [("random", r) for r in order]
        # latency-aware least-loaded: the fastest candidate's measured
        # TTFT EWMA is the baseline every other candidate's latency is
        # scored relative to (docs/SERVING.md "Fleet tier")
        ewmas = [r.ttft_ewma for r in candidates if r.ttft_ewma]
        baseline = min(ewmas) if ewmas else None
        by_load = sorted(candidates, key=lambda r: r.load(baseline))
        prefs, seen = [], set()

        def push(rung, rep):
            if rep is not None and rep.name not in seen:
                prefs.append((rung, rep))
                seen.add(rep.name)

        cand_names = {r.name: r for r in candidates}
        if session is not None:
            push("affinity", cand_names.get(self._sessions.get(session)))
        if holder is not None and holder in cand_names:
            # measured: the fleet index says this replica's prefix
            # index actually holds the prompt's leading pages
            push("prefix", cand_names[holder])
        elif key is not None and len(candidates) > 0:
            # stateless hash preference over the STABLE name order, so
            # every request carrying the same leading tokens converges
            # on one replica — whose index then actually holds the
            # prefix.  Walk forward past non-candidates so a drained
            # replica's keys spread deterministically over survivors.
            stable = sorted(self._replicas.values(), key=lambda r: r.name)
            for off in range(len(stable)):
                rep = stable[(key + off) % len(stable)]
                if rep.name in cand_names:
                    push("prefix", rep)
                    break
        for rep in by_load:
            push("balance", rep)
        return prefs

    def _confirm_prefix(self, handle):
        """The measurement half of prefix routing: once the request
        resolves, its first-admission prefix_hit_tokens stamp says
        whether the bet paid.  A first-of-its-prefix request is
        recorded as a MISS — it seeded the cache, the bet didn't pay
        yet — so the confirmed/missed ratio reads as the real warm
        fraction of prefix-routed traffic, not an assumption."""
        hit = handle.prefix_hit_tokens
        if hit is not None:
            self.metrics.count_prefix_confirmed(hit > 0)

    def _route_and_submit(self, prompt, kwargs, handle, session,
                          exclude=None, prefer_role=None):
        """Run the ladder, count the rung that actually placed the
        request, and return (handle, replica).  Raises ServerBusyError
        (shed — every candidate's gate closed, admission OR breaker)
        or RequestTooLargeError (no candidate could EVER hold it)
        synchronously.  The routing LOCK covers only the bookkeeping
        (candidates, index lookup, ladder, session pins); RPCs —
        page-adoption transfers and the submits themselves — run
        OUTSIDE it, so one slow replica can never serialize fleet
        admission.

        P/D RUNG (ahead of the affinity ladder): in a fleet with
        non-mixed roles, a prompt past `pd_prefill_threshold_tokens`
        prefers the prefill class and anything shorter prefers the
        decode class (mixed replicas belong to both) — the full
        session/prefix/load ladder runs WITHIN the preferred class,
        then the remaining candidates follow load-ordered, so role is
        a preference and never a hard failure.  `prefer_role`
        overrides the length split (the handoff fallback pins
        "decode")."""
        prompt = list(prompt)
        self._watchdog()
        with self._lock:
            if self._closed:
                raise ServingError("fleet router is shut down")
            fit = [r for r in self._candidates(
                len(prompt), kwargs.get("max_new_tokens"))
                if exclude is None or r.name != exclude]
            if not fit:
                if any(r.accepting for r in self._replicas.values()
                       if exclude is None or r.name != exclude):
                    raise RequestTooLargeError(
                        f"no replica can hold a {len(prompt)}-token "
                        f"prompt (+{kwargs.get('max_new_tokens')} new)")
                raise ServingError(
                    "no accepting replica (fleet drained or shut down)")
            candidates = [r for r in fit if r.breaker.routable(
                r.transport.heartbeat_age(), self._hb_fresh_s)]
            if not candidates:
                # capacity exists but every breaker is open: typed
                # shed, same as every admission gate closed
                self.metrics.count_shed()
                raise ServerBusyError(
                    f"fleet saturated: every routable replica's "
                    f"circuit breaker is open ({len(fit)} candidates)")
            key = self._prefix_key(prompt)
            lookup = None
            if self.config.routing == "affinity" \
                    and self.config.page_service:
                self._pull_prefix_deltas()
                lookup = self._index_lookup(prompt)
            holder = lookup[0] if lookup else None
            role_pref = prefer_role
            if role_pref is None and any(
                    r.role != "mixed"
                    for r in self._replicas.values()):
                role_pref = (
                    "prefill" if len(prompt) >=
                    self.config.pd_prefill_threshold_tokens
                    else "decode")
            pref_c = ([r for r in candidates
                       if r.role in (role_pref, "mixed")]
                      if role_pref is not None else candidates)
            if role_pref is not None and pref_c:
                prefs = self._ladder(session, key, pref_c,
                                     holder=holder)
                prefs += self._ladder(
                    None, None,
                    [r for r in candidates if r not in pref_c])
            else:
                prefs = self._ladder(session, key, candidates,
                                     holder=holder)
        last_busy = None
        adoption_tried = False
        for i, (rung, rep) in enumerate(prefs):
            # submission-time breaker gate: claims the one half-open
            # probe slot; a breaker that OPENED since the ladder was
            # built skips the replica
            if not rep.breaker.admit(rep.transport.heartbeat_age(),
                                     self._hb_fresh_s):
                continue
            if not adoption_tried and not self.config.async_adoption:
                # synchronous mode (ablation/deterministic tests):
                # hit-elsewhere moves the bytes BEFORE admission so
                # THIS request is served warm — at the cost of the
                # transfer wall on its critical path
                adoption_tried = self._maybe_adopt_pages(
                    prompt, rep, lookup)
            try:
                rep.transport.submit(prompt, kwargs, handle)
            except ServerBusyError as e:
                last_busy = e
                rep.breaker.record_busy()   # load, not breakage
                continue
            except RequestTooLargeError:
                rep.breaker.record_busy()   # capacity edge, not a fault
                continue
            except ReplicaTimeoutError:
                # the submit RPC missed its bounded deadline: fail
                # fast down the ladder (the ledger entry was popped;
                # if the op actually landed child-side, its stream
                # frames find no entry and drop harmlessly)
                self.metrics.count_replica_timeout()
                rep.breaker.record_failure()
                continue
            except ServingError:
                rep.breaker.record_failure()
                continue   # dead channel / transport fault
            except BaseException:
                # an UNTYPED exception out of the transport (a child-
                # side bug rides the reply wire verbatim) is still a
                # breaker fault — without this, a claimed half-open
                # probe slot would leak and unroute the replica
                # forever.  Re-raise: bugs must stay loud.
                rep.breaker.record_failure()
                raise
            rep.breaker.record_success()
            if self.config.async_adoption:
                # async adoption (the default): the request is already
                # admitted and prefills cold RIGHT NOW; the transfer
                # ships behind it and warms the prefix index for the
                # NEXT request — routing latency never waits on bytes
                self._schedule_adoption(prompt, rep, lookup)
            if i == 0:
                self.metrics.count_routed(rung)
            else:
                self.metrics.count_spill()
            if role_pref is not None and rep.role == role_pref:
                self.metrics.count_routed_role()
            if rung == "prefix" and i == 0:
                client = (handle.client_and_delivered()[0]
                          if isinstance(handle, _MigrationRelay)
                          else handle)
                # hook the confirmation ONLY when this submission
                # is the one whose admission will stamp the handle
                # (stamp still None), and at most once per client —
                # a drain-migrated request re-routed by prefix must
                # not fire a second callback against the ORIGINAL
                # replica's stamp and double-count a bet the new
                # replica never won.  (A started worker can admit
                # and stamp between submit and this check; that
                # rare race under-counts one confirmation, never
                # mis-attributes one.)
                if client.prefix_hit_tokens is None and not getattr(
                        client, "_prefix_confirm_hooked", False):
                    client._prefix_confirm_hooked = True
                    client.add_done_callback(self._confirm_prefix)
            if session is not None:
                with self._lock:
                    self._sessions[session] = rep.name
            # latency measurement: every plainly-submitted request
            # feeds the serving replica's TTFT EWMA at completion.
            # Migration relays are skipped — their first_token_s
            # clock spans two replicas and would smear the signal.
            if not isinstance(handle, _MigrationRelay) and \
                    not getattr(handle, "_ttft_hooked", False):
                handle._ttft_hooked = True
                handle.add_done_callback(rep.observe_ttft)
            self.metrics.set_replica_queue_depth(rep.name,
                                                 rep.queue_depth())
            return handle, rep
        # every candidate's admission gate is closed: fleet-level
        # load shed — the ONLY place shed_total increments
        self.metrics.count_shed()
        raise ServerBusyError(
            f"fleet saturated: all {len(prefs)} routable replicas "
            f"rejected admission") from last_busy

    # --------------------------- client API -------------------------
    def submit(self, prompt, max_new_tokens=None, sampling=None,
               stop_tokens=(), timeout_ms=None, session=None):
        """Route one prompt to a replica; returns a GenerationHandle
        with the engine's exact streaming contract.  `session` pins
        this and follow-up submits carrying the same id to one replica
        (whose pools hold the conversation's warm pages); without it,
        routing falls to prefix affinity, then least-loaded."""
        handle = GenerationHandle()
        # materialize default sampling HERE, not in the replica engine:
        # the params' recorded seed is what makes every later migration
        # (drain resubmit, crash remigration, live-migration cold
        # fallback) replay the identical stream
        sampling = sampling if sampling is not None else SamplingParams()
        handle, _ = self._route_and_submit(
            prompt,
            dict(max_new_tokens=max_new_tokens, sampling=sampling,
                 stop_tokens=stop_tokens, timeout_ms=timeout_ms),
            handle, session)
        return handle

    def generate(self, prompt, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result()

    def replica_of(self, handle_or_session):
        """Debug/test introspection: the replica name a session is
        pinned to (None when unpinned)."""
        return self._sessions.get(handle_or_session)

    # ------------------------- drain / restart ----------------------
    def drain(self, name, migrate=True, timeout=60.0, live=None):
        """Take replica `name` out of service: stop admissions, move
        its unfinished work to siblings, join the worker (or reap the
        process).

        Queued (never-admitted) requests ALWAYS migrate — as cold
        resubmits with their original seeded sampling, so their streams
        are untouched.  With `migrate=True` (default) live slot-holders
        move too — as TRUE LIVE MIGRATIONS when `live`
        (FleetConfig.live_migration default): their resident state
        (page bytes, page table, position, sampling RNG, delivered
        count) ships to a sibling that RESUMES the decode mid-stream,
        so a 10k-token stream moves without replaying a single token
        (fleet.migrated_replay_tokens stays 0).  When a sibling cannot
        adopt (no slot, pool pressure, incompatible layout) — or with
        live=False, the ablation baseline — the request falls back to
        the COLD RESUBMIT ladder: seeded sampling replays the
        identical stream and a relay skips the tokens the client
        already received (counted into migrated_replay_tokens).  With
        `migrate=False` residents finish on the draining replica
        first — but a resident that outlives `timeout` is evacuated
        anyway, so a drain always CONVERGES to "stopped" instead of
        wedging the replica in a half-drained state.  A migrated
        request that finds every sibling's gate closed resolves its
        handle with the typed ServerBusyError (counted in
        fleet.shed_total).  Sessions pinned here unpin; the fleet
        prefix index forgets everything this replica held."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if rep.state != "serving":
                raise ServingError(
                    f"replica {name!r} is {rep.state}, not serving")
            rep.state = "draining"
            for sess in [s for s, n in self._sessions.items()
                         if n == name]:
                del self._sessions[sess]
        if live is None:
            live = self.config.live_migration
        try:
            cold, live_snaps = rep.transport.drain(
                migrate=migrate, live=live, timeout=timeout)
        except ServingError:
            # the replica died mid-drain: its in-flight ledger already
            # remigrated through the death path
            cold, live_snaps = [], []
        for snap in live_snaps:
            self._migrate_live(snap, exclude=name)
        for req, emitted in cold:
            self._migrate(req, emitted, exclude=name)
        self.metrics.count_migrated(len(cold) + len(live_snaps))
        self._page_index.drop_replica(name)
        rep.state = "stopped"
        rep.respawns = 0   # a clean drain is not a crash: restart
        # owes no backoff

    def _migrate_live(self, snap, exclude, prefer_role=None,
                      cold_fallback=True):
        """Place one exported resident on a sibling that RESUMES its
        decode (zero replayed tokens); falls back to the cold-resubmit
        ladder when no sibling can adopt it right now.  `prefer_role`
        (the P/D handoff path passes "decode") stable-partitions the
        candidates so role-matched (+ mixed) siblings are tried first,
        least loaded within each class — a preference, never a wall.
        With `cold_fallback=False` the run is simply reported unplaced
        (False) so the caller can re-park it instead of paying the
        replay.  Returns True when a sibling adopted the run live."""
        handle = snap.get("future")
        remaining = max(1, snap["max_new_tokens"] - snap["n_generated"])
        with self._lock:
            cands = sorted(
                (r for r in self._replicas.values()
                 if r.accepting and r.name != exclude
                 and r.can_fit(len(snap["tokens"]), remaining)
                 and r.breaker.routable(r.transport.heartbeat_age(),
                                        self._hb_fresh_s)),
                key=lambda r: r.load())
        if prefer_role is not None:
            cands.sort(key=lambda r: r.role not in (prefer_role,
                                                    "mixed"))
        for rep in cands:
            try:
                if rep.transport.import_sequence(snap):
                    self.metrics.count_live_migrated()
                    return True
            except ReplicaTimeoutError:
                self.metrics.count_replica_timeout()
                rep.breaker.record_failure()
                continue
            except ServingError:
                continue
        if not cold_fallback:
            return False
        # cold fallback: seeded sampling replays the identical stream,
        # the relay swallows what the client already saw
        req = GenerationRequest(
            snap["prompt"], handle, snap["sampling"],
            max_new_tokens=snap["max_new_tokens"],
            stop_tokens=snap["stop_tokens"],
            deadline=snap.get("deadline"))
        self._migrate(req, snap["n_generated"], exclude=exclude,
                      prefer_role=prefer_role)
        return True

    def _migrate(self, req, emitted, exclude, prefer_role=None):
        """Cold-resubmit one evacuated request on a sibling, preserving
        the client's handle and stream position.  The skipped replay
        is the live-migration A/B's accounting: every token the relay
        swallows lands in fleet.migrated_replay_tokens."""
        handle = req.future
        if isinstance(handle, _MigrationRelay):   # second migration
            client, delivered = handle.client_and_delivered()
        else:
            client, delivered = handle, int(emitted)
        # the client's own delivered counter is the replay-skip FLOOR:
        # no ledger race (a token dispatched while the death path
        # snapshots the entry) can make a resubmit re-stream a token
        # the client already received
        delivered = max(delivered, getattr(client, "n_streamed", 0))
        engine_handle = (_MigrationRelay(client, delivered)
                         if delivered else client)
        self.metrics.count_replay_tokens(delivered)
        timeout_ms = None
        if req.deadline is not None:
            timeout_ms = max(0.0,
                             (req.deadline - time.monotonic()) * 1e3)
        try:
            self._route_and_submit(
                req.prompt,
                dict(max_new_tokens=req.max_new_tokens,
                     sampling=req.params,
                     stop_tokens=req.stop_tokens, timeout_ms=timeout_ms),
                engine_handle, session=None, exclude=exclude,
                prefer_role=prefer_role)
        except ServingError as e:
            # nowhere to go (typed: busy/too-large/drained) — the
            # client holds the handle, so the error lands there
            client.set_exception(e)

    def _adoption_viable_locked(self, rep, holder_name, chain):
        """Preconditions a transfer must (re-)pass under the routing
        lock: a live, layout-compatible holder that is NOT `rep`, for
        a chain `rep` does not already hold.  Returns the holder
        replica or None."""
        if holder_name == rep.name \
                or rep.name in self._page_index.holders_of(chain):
            return None
        src = self._replicas.get(holder_name)
        if src is None or src.state != "serving" \
                or not src.transport.alive():
            return None
        if src._describe["page_size"] != rep._describe["page_size"]:
            # pages only move between layout-compatible pools; the
            # importer would reject the payload anyway, so skip the
            # export round-trip entirely
            return None
        return src

    def _maybe_adopt_pages(self, prompt, rep, lookup):
        """SYNCHRONOUS adoption (async_adoption=False): when the fleet
        index measured a DIFFERENT replica as holding this prompt's
        warm prefix run, move the bytes NOW so `rep` serves this very
        request warm.  Returns True when a transfer was attempted
        (success or not — one attempt per request), False when not
        applicable.  The byte transfer runs OUTSIDE the routing lock:
        bounded RPCs, typed degrade to the cold-prefill ladder — a
        hung holder never stalls fleet admission."""
        if lookup is None:
            return False
        holder_name, _depth, chain = lookup
        with self._lock:
            src = self._adoption_viable_locked(rep, holder_name, chain)
        if src is None:
            return False
        self._adopt_via_wire(prompt, rep, src, chain)
        return True

    def _schedule_adoption(self, prompt, rep, lookup):
        """ASYNC adoption (the default): enqueue the transfer on the
        scheduler and return immediately — the admitted request
        prefills cold, the arriving pages warm the index for the NEXT
        request.  Dedup and in-flight bounding live in the scheduler;
        viability is re-checked at execution time (cancellation)."""
        if lookup is None:
            return False
        holder_name, _depth, chain = lookup
        with self._lock:
            if self._closed:
                return False
            if self._adoption_viable_locked(rep, holder_name,
                                            chain) is None:
                return False
            if self._transfers is None:
                self._transfers = _TransferScheduler(
                    self, self.config.max_inflight_transfers)
        return self._transfers.request(prompt, rep.name, holder_name,
                                       chain)

    def _execute_transfer(self, t):
        """One queued transfer, on a scheduler thread.  Re-checks
        viability first — the index may have stopped wanting this
        transfer while it sat queued (the importer prefilled and
        registered the chain itself, a party died) — and cancels
        instead of moving dead bytes."""
        rep = self._replicas.get(t["importer"])
        with self._lock:
            if self._closed or rep is None or rep.state != "serving" \
                    or not rep.transport.alive():
                self.metrics.count_transfer_cancelled()
                return
            src = self._adoption_viable_locked(rep, t["holder"],
                                               t["chain"])
            if src is None:
                self.metrics.count_transfer_cancelled()
                return
        self._adopt_via_wire(t["prompt"], rep, src, t["chain"])

    def wait_transfers(self, timeout=30.0):
        """Block until every queued/in-flight adoption transfer
        settles (tests, benches, graceful drains).  True when idle."""
        transfers = self._transfers
        if transfers is None:
            return True
        return transfers.wait_idle(timeout)

    def _adopt_via_wire(self, prompt, rep, src, chain):
        """Move one warm prefix run from `src` to `rep` — the byte-
        moving half shared by both adoption modes.  p2p (default):
        `rep` dials `src`'s advertised data port and the payload
        crosses ONE replica→replica socket, compressed at the
        negotiated codec level — zero page bytes on the router
        socket.  relay (ablation, or a data port not yet advertised):
        export through the router, counted into page_relay_bytes.
        Every failure is typed and counted; the request(s) behind it
        just prefill cold."""
        levels = (("delta", "raw")
                  if self.config.page_codec == "compressed"
                  else ("raw",))
        if self.config.page_transfer == "p2p":
            addr_fn = getattr(src.transport, "data_address", None)
            import_from = getattr(rep.transport, "import_prefix_from",
                                  None)
            addr = addr_fn() if addr_fn is not None else None
            if addr is not None and import_from is not None:
                try:
                    res = import_from(addr, prompt,
                                      timeout_s=self.config.rpc_timeout_s,
                                      levels=levels)
                except ReplicaTimeoutError:
                    # the IMPORTER's RPC missed its deadline — its
                    # breaker bookkeeping decides its fate; the
                    # request degrades to the cold-prefill ladder
                    self.metrics.count_replica_timeout()
                    rep.breaker.record_failure()
                    self.metrics.count_transfer_failed()
                    return
                except ServingError:
                    # typed refusal anywhere on the path (dial failed,
                    # deadline, codec mismatch, holder refused): cold
                    # ladder, counted
                    self.metrics.count_transfer_failed()
                    return
                added = res.get("added", 0) if isinstance(res, dict) \
                    else 0
                if added:
                    self.metrics.count_page_adoption(added)
                    self.metrics.count_page_p2p_bytes(
                        res.get("wire_bytes", 0),
                        res.get("raw_bytes", 0))
                    with self._lock:
                        self._page_index.apply(rep.name,
                                               [("add", chain)])
                return
            # no data port advertised yet (heterogeneous fleet member,
            # pre-first-heartbeat): fall through to the relay baseline
        try:
            payload = src.transport.export_prefix(prompt)
        except ReplicaTimeoutError:
            # bounded-deadline miss: the HOLDER is in trouble, the
            # request is not — degrade to the cold-prefill ladder and
            # let the holder's breaker bookkeeping decide its fate
            self.metrics.count_replica_timeout()
            src.breaker.record_failure()
            self.metrics.count_transfer_failed()
            return
        except ServingError:
            self.metrics.count_transfer_failed()
            return
        if not payload:
            return   # evicted since the last delta pull
        self.metrics.count_page_relay_bytes(
            pagecodec.payload_nbytes(payload))
        try:
            added = rep.transport.import_prefix(payload)
        except ReplicaTimeoutError:
            self.metrics.count_replica_timeout()
            rep.breaker.record_failure()
            self.metrics.count_transfer_failed()
            return
        except ServingError:
            self.metrics.count_transfer_failed()
            return
        if added:
            self.metrics.count_page_adoption(added)
            # eager index update (the importer's own delta confirms on
            # the next pull): back-to-back requests must not re-ship
            with self._lock:
                self._page_index.apply(rep.name, [("add", chain)])

    def _handle_death(self, transport):
        """Crash path: mark the replica dead, count it, forget its
        index entries, unpin its sessions, and remigrate its in-flight
        ledger — queued work resubmits on siblings, mid-stream work
        resumes via relay replay; anything with nowhere to go resolves
        with the typed shed.  Streams never hang on a dead process.
        Fired by the transport reader thread on socket EOF and by the
        stale-heartbeat reaper; idempotent per replica generation."""
        rep = next((r for r in self._replicas.values()
                    if r.transport is transport), None)
        if rep is None:
            return
        now = time.monotonic()
        with self._lock:
            if rep.state != "serving":
                return
            rep.state = "dead"
            rep.died_at = now
            # respawn-backoff bookkeeping, counted ONCE per death: a
            # replica dying within respawn_reset_s of its build is
            # crash-looping — the streak drives restart()'s
            # exponential backoff and the crash-loop cap.  A death
            # after a LONG healthy run resets the streak entirely:
            # it owes no backoff (the documented contract).
            quick = now - rep.built_at < self.config.respawn_reset_s
            rep.respawns = rep.respawns + 1 if quick else 0
            for sess in [s for s, n in self._sessions.items()
                         if n == rep.name]:
                del self._sessions[sess]
        self.metrics.count_replica_dead()
        self._page_index.drop_replica(rep.name)
        # handoff snaps live PARENT-side (the worker shipped the bytes
        # before dying), so a prefill replica SIGKILLed mid-handoff
        # loses nothing: place what already arrived, and anything whose
        # handoff frame never made it is still in the in-flight ledger
        # below — cold remigration with replay skip covers it.
        take = getattr(transport, "take_handoffs", None)
        if take is not None:
            for item in take():
                if not self._place_handoff(item, exclude=rep.name):
                    # decode class momentarily full: park it — the
                    # watchdog's collection sweep retries
                    with self._lock:
                        self._pending_handoffs.append((item, rep.name))
        for entry in transport.take_inflight():
            self._remigrate_entry(entry, exclude=rep.name)

    def _on_transport_death(self, transport):
        self._handle_death(transport)

    def _remigrate_entry(self, entry, exclude):
        """Resubmit one in-flight-ledger entry from a dead replica:
        the client handle survives parent-side, seeded sampling
        replays, a relay skips the delivered tokens."""
        handle = entry["handle"]
        if isinstance(handle, _MigrationRelay):
            client, delivered = handle.client_and_delivered()
        else:
            client, delivered = handle, int(entry["emitted"])
        # same floor as _migrate: the client's n_streamed wins over
        # any stale ledger count
        delivered = max(delivered, getattr(client, "n_streamed", 0))
        engine_handle = (_MigrationRelay(client, delivered)
                         if delivered else client)
        self.metrics.count_replay_tokens(delivered)
        kwargs = dict(entry["kwargs"])
        if entry.get("deadline") is not None:
            kwargs["timeout_ms"] = max(
                0.0, (entry["deadline"] - time.monotonic()) * 1e3)
        migrated = False
        try:
            self._route_and_submit(entry["prompt"], kwargs,
                                   engine_handle, session=None,
                                   exclude=exclude)
            migrated = True
        except ServingError as e:
            client.set_exception(e)
        if migrated:
            self.metrics.count_migrated()

    def restart(self, name, wait=True):
        """Bring a drained (or dead) replica back: a FRESH engine from
        its spec — new pools, empty prefix index, empty queue, and for
        subprocess replicas a new OS process.  Prefix-affinity bets
        against the old index self-correct through the confirmation
        loop (first request misses, seeds, re-warms) AND through the
        fleet index, which forgot the old replica at drain/death.

        CRASH-LOOP discipline: a replica that DIED within
        `respawn_reset_s` of its build owes an exponential respawn
        backoff (`respawn_backoff_s * 2^(streak-1)`, capped at
        `respawn_backoff_cap_s`) measured from its death — `wait=True`
        (default) sleeps it off, `wait=False` raises the typed
        ServingError with the remaining seconds so an external
        supervisor can reschedule.  A streak past `max_respawns`
        refuses to respawn at all (typed) until `reset_respawn(name)`:
        a crash-looping replica must not spin the fleet.  Clean drains
        owe nothing."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if rep.state not in ("stopped", "dead"):
                raise ServingError(
                    f"replica {name!r} is {rep.state}; drain it first")
            backoff = 0.0
            if rep.state == "dead" and rep.respawns:
                if rep.respawns > self.config.max_respawns:
                    self.metrics.set_respawn_backoff(
                        name, self.config.respawn_backoff_cap_s)
                    raise ServingError(
                        f"replica {name!r} is crash-looping "
                        f"({rep.respawns} quick deaths > max_respawns="
                        f"{self.config.max_respawns}); fix the cause "
                        f"and reset_respawn({name!r}) to override")
                backoff = min(
                    self.config.respawn_backoff_cap_s,
                    self.config.respawn_backoff_s
                    * 2 ** (rep.respawns - 1))
            self.metrics.set_respawn_backoff(name, backoff)
            remaining = 0.0
            if backoff and rep.died_at is not None:
                remaining = rep.died_at + backoff - time.monotonic()
            if remaining > 0 and not wait:
                raise ServingError(
                    f"replica {name!r} owes {remaining:.2f}s of "
                    f"respawn backoff (streak {rep.respawns}); retry "
                    f"then, or restart(wait=True)")
        if remaining > 0:
            time.sleep(remaining)
        with self._lock:
            if rep.state not in ("stopped", "dead"):
                raise ServingError(
                    f"replica {name!r} became {rep.state} during the "
                    f"respawn backoff")
            if rep.state == "dead":
                rep.transport.stop()   # reap the corpse
            rep.build(self.config.start)
            self._wire_handoff(rep)

    def reset_respawn(self, name):
        """Operator override: clear `name`'s crash-loop streak (and
        its breaker) so the next restart() owes no backoff."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            rep.respawns = 0
            rep.breaker.reset()
        self.metrics.set_respawn_backoff(name, 0.0)

    # ------------------------- fleet scaling ------------------------
    def add_replica(self, spec, start=None):
        """Register and build ONE new replica at runtime — the
        autoscaler's scale-up primitive (and an operator's).  The
        replica is built OUTSIDE the routing lock (a process spawn
        must never serialize admission) and joins the candidate set
        the moment it registers; the watchdog starts if the fleet's
        composition now needs one.  Returns the replica name."""
        cfg = self.config
        with self._lock:
            if self._closed:
                raise ServingError("fleet router is shut down")
            if spec.name in self._replicas:
                raise ValueError(
                    f"duplicate replica name {spec.name!r}")
        rpc = RpcPolicy(cfg.rpc_timeout_s, cfg.rpc_retries,
                        cfg.rpc_backoff_s, seed=cfg.seed or 0)
        rep = _Replica(
            spec, cfg.start if start is None else start,
            cfg.transport or spec.transport,
            on_death=self._on_transport_death, rpc=rpc,
            breaker=CircuitBreaker(
                cfg.breaker_threshold, cfg.breaker_cooldown_s,
                on_open=self._on_breaker_open))
        self._wire_handoff(rep)
        with self._lock:
            if self._closed or spec.name in self._replicas:
                rep.transport.stop()   # lost the registration race
                raise ServingError(
                    f"cannot register replica {spec.name!r}: fleet "
                    f"closed or name taken during build")
            self._replicas[spec.name] = rep
        self._ensure_watchdog()
        self.metrics.set_replica_count(
            sum(1 for r in self._replicas.values()
                if r.state == "serving"))
        return rep.name

    def remove_replica(self, name, timeout=30.0):
        """Drain `name` (unfinished work migrates to siblings) and
        forget it entirely — the autoscaler's scale-down primitive.
        A dead replica is reaped instead of drained."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
        if rep.state == "serving":
            self.drain(name, migrate=True, timeout=timeout)
        elif rep.state == "dead":
            rep.transport.stop()
            rep.state = "stopped"
        with self._lock:
            self._replicas.pop(name, None)
        self.metrics.set_replica_count(
            sum(1 for r in self._replicas.values()
                if r.state == "serving"))

    # --------------------------- lifecycle --------------------------
    def run_until_idle(self, max_steps=100000):
        """Drive every live replica until queues and slots drain —
        stepped inproc replicas are stepped here (tests/benchmarks);
        replicas with background workers (and subprocess replicas,
        which always step themselves) are simply waited on."""
        steps = 0
        while True:
            busy = (bool(self._collect_handoffs())
                    or bool(self._pending_handoffs)
                    or not (self._transfers is None
                            or self._transfers.idle()))
            for rep in list(self._replicas.values()):
                if rep.state in ("stopped", "dead"):
                    continue
                t = rep.transport
                if not t.idle():
                    busy = True
                    t.pump()
            if not busy:
                return steps
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"fleet not idle after {max_steps} "
                                   f"steps")

    def stats_snapshot(self):
        """Fleet-level capacity-planning export: every replica's
        generation.* snapshot + live cache stats keyed by replica name,
        plus the fleet.* routing/shed/migration counters, per-replica
        queue-depth gauges, and the heartbeat-age liveness gauges
        (schema-complete from the first snapshot: 0.0 for inproc
        transports, whose liveness is this process's)."""
        self._watchdog()
        with self._lock:
            self._pull_prefix_deltas()
        replicas = {}
        depths = []
        ages = []
        breaker_scores = []
        for name, rep in list(self._replicas.items()):
            if rep.state in ("stopped", "dead"):
                # a stopped replica queues nothing: zero its gauges so
                # a dashboard never shows pre-drain depth on a dead slot
                self.metrics.set_replica_queue_depth(name, 0)
                self.metrics.set_heartbeat_age(name, 0.0)
                self.metrics.set_breaker_state(name, 0)
                replicas[name] = {"state": rep.state}
                continue
            age = rep.transport.heartbeat_age()
            ages.append(age)
            self.metrics.set_heartbeat_age(name, age)
            score = rep.breaker.score
            breaker_scores.append(score)
            self.metrics.set_breaker_state(name, score)
            depth = rep.queue_depth()
            depths.append(depth)
            self.metrics.set_replica_queue_depth(name, depth)
            info = rep.transport.load_info()
            try:
                stats = rep.transport.stats()
            except ServingError:
                stats = {}
            replicas[name] = {
                "state": rep.state,
                "transport": rep.kind,
                "role": rep.role,
                "queue_depth": depth,
                "active": info["active"],
                "load": round(rep.load(), 3),
                "ttft_ewma_s": (None if rep.ttft_ewma is None
                                else round(rep.ttft_ewma, 4)),
                "heartbeat_age_s": round(age, 3),
                "breaker": rep.breaker.state,
                "respawns": rep.respawns,
                "rpc_timeouts": getattr(rep.transport,
                                        "timeout_total", 0),
                "generation": stats.get("generation", {}),
                "cache": stats.get("cache", {}),
            }
        self.metrics.set_max_queue_depth(max(depths, default=0))
        self.metrics.set_max_heartbeat_age(max(ages, default=0.0))
        self.metrics.set_max_breaker_state(max(breaker_scores,
                                               default=0))
        self.metrics.set_replica_count(
            sum(1 for r in self._replicas.values()
                if r.state == "serving"))
        return {"fleet": self.metrics.snapshot(),
                "prefix_index_chains": self._page_index.chains_held(),
                "prefix_index_compactions": self._page_index.compactions,
                "replicas": replicas}

    def shutdown(self):
        """Stop every replica (typed rejection for anything queued)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._watchdog_stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5.0)
        if self._transfers is not None:
            self._transfers.stop()
        for rep in self._replicas.values():
            if rep.state != "stopped":
                rep.transport.stop()
                rep.state = "stopped"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


__all__ = [
    "FleetRouter", "FleetConfig", "FleetMetrics", "ReplicaSpec",
    "CircuitBreaker",
]
