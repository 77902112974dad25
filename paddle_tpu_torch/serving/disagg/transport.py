"""ReplicaTransport: the replica process boundary.

The FleetRouter never touches a GenerationEngine directly anymore — it
speaks one duck-typed transport contract with two implementations:

- ``InprocTransport`` — the direct-object path (engine in this
  process).  Zero serialization, stepped-mode capable, and therefore
  the deterministic CPU oracle every cross-boundary behavior is
  measured against.
- ``SubprocTransport`` — ONE OS PROCESS per replica: a worker child
  (``python -m paddle_tpu_torch.serving.disagg.worker``) owns a
  single-process GenerationEngine on the device its GenerationConfig
  names (the card by default), and the parent speaks length-prefixed
  pickled RPC over an inherited UNIX socketpair — submit /
  stream-token / cancel / stats / evacuate / restart, with a periodic
  heartbeat carrying load + prefix register/evict deltas.  The parent
  keeps an IN-FLIGHT LEDGER (every submitted-but-unfinished request
  with its delivered token count):
  crash detection (socket EOF or a stale heartbeat) marks the replica
  dead and hands the ledger to the fleet, which remigrates queued work
  and resolves in-flight streams typed — migrated or shed, never hung.
- ``TcpTransport`` (serving/disagg/tcp.py) — the SAME parent logic
  over a real TCP connection the spawned worker dials back to
  (``--connect host:port``), the cross-host path.  Only the channel
  bring-up differs (``_open_channel`` below is the override seam);
  frames, ledger, heartbeats, deadlines, faults are all shared.

The transport contract (duck-typed; every method the router calls):

    alive() heartbeat_age() describe() load_info() stats()
    submit(prompt, kwargs, handle) drain(migrate, live, timeout)
    import_sequence(snap) export_prefix(tokens) import_prefix(payload)
    take_prefix_deltas() flush_prefix() reset_stats() ping()
    cancel(handle) take_handoffs() idle() pump() stop() take_inflight()

Docs: docs/SERVING.md "Disaggregated fleet" (contract + RPC schema)
and "Cross-host fleet" (TCP bring-up, P/D handoff, supervisor).
"""
import itertools
import os
import pickle
import random
import socket
import subprocess
import sys
import threading
import time

from ...generation.engine import (GenerationEngine, GenerationResult)
from ...generation.kv_cache import compact_prefix_deltas
from ...generation.metrics import GenerationMetrics
from ...generation.scheduler import GenerationRequest
from ...profiler.monitor import StatRegistry
from ..admission import ReplicaTimeoutError, ServingError
from .rpc import (ChannelClosed, DEFAULT_CHUNK_BYTES, FrameAssembler,
                  send_frame)

HEARTBEAT_S = 0.25

# ops a timed-out caller may safely re-issue: they read state or
# re-assert idempotent state, so a lost REPLY cannot double-apply
# (cancelling an already-cancelled/finished stream is a no-op, so
# "cancel" qualifies).  submit / import_seq / import_prefix /
# evacuate are NOT here — a lost reply may mean the op landed, and
# re-issuing would double-run it; they fail fast into the fleet's
# remigration ladder instead.
RETRYABLE_OPS = frozenset({"stats", "load", "export_prefix",
                           "flush_prefix", "reset_stats", "ping",
                           "cancel"})


class RpcPolicy:
    """Bounded-RPC knobs for one SubprocTransport: every `_call` gets
    a deadline (`timeout_s` — there is NO unbounded default), and
    idempotent ops retry up to `retries` total attempts with
    exponential backoff + seeded jitter (`backoff_s` base).  The
    FleetRouter builds one from FleetConfig.rpc_* per replica."""

    __slots__ = ("timeout_s", "retries", "backoff_s", "seed")

    def __init__(self, timeout_s=15.0, retries=3, backoff_s=0.05,
                 seed=0):
        if float(timeout_s) <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        if int(retries) < 1:
            raise ValueError(f"retries must be >= 1, got {retries}")
        if float(backoff_s) < 0:
            raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.seed = seed


def build_transport(spec, kind, start=True, rpc=None, fault_plan=None):
    """Transport factory: ``"inproc"``, ``"proc"`` or ``"tcp"``.
    `rpc` is an RpcPolicy (proc/tcp only); `fault_plan` a
    serving.disagg.faults FaultPlan wrapping the frame codec — chaos
    tests/drills only, and only meaningful where there IS a wire."""
    if kind == "proc":
        return SubprocTransport(spec, rpc=rpc, fault_plan=fault_plan)
    if kind == "tcp":
        from .tcp import TcpTransport   # late: tcp imports this module

        return TcpTransport(spec, rpc=rpc, fault_plan=fault_plan)
    if kind == "inproc":
        if fault_plan is not None:
            raise ValueError(
                "fault injection wraps the RPC frame codec; an inproc "
                "replica has no wire to fault — use transport='proc'")
        return InprocTransport(spec, start=start)
    raise ValueError(
        f"transport must be 'inproc', 'proc' or 'tcp', got {kind!r}")


class InprocTransport:
    """The direct-object replica: today's engine-in-process path,
    behind the transport contract — the deterministic CPU oracle the
    subprocess boundary is proven token-identical against."""

    kind = "inproc"

    def __init__(self, spec, start=True):
        self.name = spec.name
        self.role = getattr(spec, "role", "mixed")
        self.registry = StatRegistry()
        self.engine = GenerationEngine(
            spec.model, spec.config,
            metrics=GenerationMetrics(registry=self.registry),
            start=start)
        if self.engine.prefix_cache_enabled:
            self.engine.cache.enable_prefix_deltas()
        if self.role == "prefill":
            # P/D disaggregation: a prefill-class replica parks every
            # sequence the moment its prompt is consumed; the router
            # collects the parked snapshots (take_handoffs) and ships
            # them to a decode-class replica
            self.engine.enable_handoff()
        self.on_death = None   # inproc replicas share our fate
        self.timeout_total = 0   # schema parity: no RPC, no timeouts
        self._data_server = None   # lazy p2p data listener

    # ------------------------- liveness -----------------------------
    def alive(self):
        return not self.engine._closed

    def heartbeat_age(self):
        """0.0 by definition: an in-process engine's liveness IS this
        process's liveness — the gauge stays schema-complete and
        zeroed, exactly what a dashboard should read for it."""
        return 0.0

    # ----------------------- introspection --------------------------
    def describe(self):
        return self.engine.describe()

    def load_info(self):
        return self.engine.load_info()

    def stats(self):
        return {
            "generation":
                self.registry.stats_snapshot("generation.")["stats"],
            "cache": self.engine.cache.stats(),
        }

    # -------------------------- serving -----------------------------
    def submit(self, prompt, kwargs, handle):
        return self.engine.submit(prompt, handle=handle, **kwargs)

    def take_inflight(self):
        return []   # an inproc replica cannot die out from under us

    def ping(self):
        """Liveness probe — the breaker's half-open recovery signal on
        an idle fleet.  Raises typed when the engine is gone, exactly
        like the RPC path."""
        if self.engine._closed:
            raise ServingError(
                f"replica {self.name!r} engine is shut down")
        return True

    def cancel(self, handle):
        return self.engine.cancel(handle)

    def take_handoffs(self):
        """Drain prefill-complete sequence snapshots parked by a
        prefill-class engine (P/D disaggregation).  Each item is
        ``{"snap": <import_sequence snapshot with future=handle>,
        "t": parked-at monotonic stamp}``."""
        return [{"snap": snap, "t": time.monotonic()}
                for snap in self.engine.take_handoffs()]

    # ------------------------ page service --------------------------
    def take_prefix_deltas(self):
        # the cache's delta log carries its own mutex, so the router's
        # submit hot path never waits behind an in-flight engine step
        # just to swap a list
        return self.engine.cache.take_prefix_deltas()

    def export_prefix(self, tokens):
        return self.engine.export_prefix_pages(tokens)

    def import_prefix(self, payload):
        return self.engine.import_prefix_pages(payload)

    def data_address(self):
        """The p2p data plane's (host, port) for this replica — a
        LAZY real TCP listener even in-process, so inproc fleets
        exercise the exact wire path (frames, codec, deadlines) the
        cross-host tier ships on."""
        if self._data_server is None:
            from .data_plane import PageDataServer

            self._data_server = PageDataServer(
                self.engine.export_prefix_pages)
        return self._data_server.address

    def import_prefix_from(self, addr, tokens, timeout_s=15.0,
                           levels=("raw",)):
        """P2P adoption: fetch the warm prefix straight off the
        holder's data port and install it — same contract as the
        worker's op, returns {"added", "wire_bytes", "raw_bytes"}."""
        from .data_plane import fetch_prefix_pages

        payload, wire, raw = fetch_prefix_pages(
            tuple(addr), tokens, timeout_s=timeout_s, levels=levels)
        added = (0 if payload is None
                 else self.engine.import_prefix_pages(payload))
        return {"added": added, "wire_bytes": wire, "raw_bytes": raw}

    def flush_prefix(self):
        return self.engine.cache.flush_prefix_cache()

    def reset_stats(self):
        self.registry.reset_all()

    # ----------------------- drain / migration ----------------------
    def import_sequence(self, snap):
        return self.engine.import_sequence(snap)

    def drain(self, migrate=True, live=True, timeout=60.0):
        """Evacuate this replica's unfinished work and shut the engine
        down.  Returns ``(cold, live_snaps)``: cold resubmits
        ``[(GenerationRequest, emitted)]`` plus live-migration sequence
        snapshots.  One state machine for both transport halves:
        engine.drain_work (migrate=False lets residents finish first,
        stragglers past `timeout` evacuate anyway)."""
        return self.engine.drain_work(migrate=migrate, live=live,
                                      timeout=timeout)

    # ------------------------- lifecycle ----------------------------
    def idle(self):
        sched = self.engine.scheduler
        return not (sched.active() or sched.pending_count()
                    or self.engine.handoffs_pending())

    def pump(self):
        eng = self.engine
        if eng._thread is not None and eng._thread.is_alive():
            time.sleep(0.002)
        else:
            eng.step()

    def stop(self):
        if self._data_server is not None:
            self._data_server.stop()
            self._data_server = None
        self.engine.shutdown()


class SubprocTransport:
    """One OS process per replica, length-prefixed pickled RPC over a
    UNIX socketpair (rpc.py), heartbeat liveness, crash detection with
    an in-flight ledger the fleet remigrates from."""

    kind = "proc"
    BUILD_TIMEOUT_S = 180.0
    # class-level fallbacks: chaos tests build bare RPC shells via
    # __new__ (no worker half), and those must stay wire-correct —
    # chunking off, no handoff poke, assembler made lazily on first
    # read
    chunk_bytes = None
    role = "mixed"
    on_handoff = None
    _assembler = None
    _data_addr = None        # p2p data port, learned from heartbeats
    delta_compactions = 0    # prefix-delta log net-op collapses
    # accumulated-but-undrained prefix deltas past this bound collapse
    # to their net op per chain — a router that goes long between
    # pulls (idle fleet, slow snapshot cadence) stays O(live chains),
    # not O(churn), over week-long uptimes
    DELTA_COMPACT_AT = 1024

    def __init__(self, spec, rpc=None, fault_plan=None):
        cfg = spec.config
        if cfg is not None and getattr(cfg, "mesh", None) is not None:
            raise ValueError(
                "SubprocTransport replicas are single-process engines: "
                "a mesh cannot cross the process boundary (give the "
                "subprocess replica an unsharded config)")
        self.name = spec.name
        self.role = getattr(spec, "role", "mixed")
        self.registry = None       # stats live in the child
        self.engine = None         # no direct-object path
        self.on_death = None       # fleet sets: callback(transport)
        self.on_handoff = None     # fleet sets: prefill-complete poke
        self.rpc = rpc or RpcPolicy()
        self._faults = fault_plan  # chaos: wraps the codec parent-side
        self._jitter = random.Random((spec.name, self.rpc.seed).__repr__())
        self.timeout_total = 0     # RPC deadline misses (drill report)
        # chunked codec: logical frames past this bound ship as
        # fragment carriers, so a multi-MB page export never blocks
        # heartbeats/tokens behind one giant sendall (spec override:
        # tests pin a tiny bound to force chunking on small payloads)
        self.chunk_bytes = int(getattr(spec, "chunk_bytes", None)
                               or DEFAULT_CHUNK_BYTES)
        self._assembler = FrameAssembler()
        # no device variable: the child builds its engine on the
        # device its GenerationConfig names, and a child without the
        # card that config asks for fails the build handshake typed
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self._sock, self._proc = self._open_channel(spec, env)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()   # rpc waits + inflight + deltas
        self._ids = itertools.count(1)  # rids and stream sids alike
        self._rpc_waits = {}            # rid -> (Event, slot dict)
        self._inflight = {}             # sid -> ledger entry
        self._handoffs = []             # prefill-complete snaps parked
        self._deltas = []
        self._load = {"queue_depth": 0, "active": 0, "pages_in_use": 0,
                      "num_pages": 1, "idle": True}
        self._last_hb = time.monotonic()
        # wedge-watchdog inputs: the heartbeat's engine-step progress
        # stamp (seq frozen + load busy == alive-but-stalled) and how
        # long the child has reported itself idle (orphan sweep)
        self._progress_seq = None
        self._progress_at = time.monotonic()
        self._in_step = False
        self._idle_since = None
        self._dead = threading.Event()
        self._closing = False
        self._death_handled = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"replica-{spec.name}-rx",
            daemon=True)
        self._reader.start()
        # the build handshake doubles as the readiness barrier: the
        # child pays its torch import, model rebuild and engine build
        # before replying (BUILD_TIMEOUT_S is that handshake's own
        # deadline; every later RPC is bounded by RpcPolicy.timeout_s).
        # A failed build must not leak the worker: the reader thread
        # keeps the parent socket referenced, so without an explicit
        # kill the child would outlive this constructor forever
        child_faults = (None if fault_plan is None
                        else fault_plan.child_spec())
        try:
            self._describe = self._call(
                {"op": "build",
                 "model": pickle.dumps(spec.model,
                                       protocol=pickle.HIGHEST_PROTOCOL),
                 "config": cfg,
                 "role": self.role, "chunk_bytes": self.chunk_bytes,
                 "faults": child_faults,
                 "data_host": getattr(spec, "host", None)},
                timeout=self.BUILD_TIMEOUT_S)
        except BaseException:
            self._closing = True
            self._proc.kill()
            try:
                self._sock.close()
            except OSError:
                pass
            raise
        # the data-port advert rides the build reply (available before
        # the first heartbeat) and is refreshed by every later beat
        addr = self._describe.pop("data_address", None)
        self._data_addr = None if addr is None else tuple(addr)
        # the liveness clock starts AFTER the handshake: the child's
        # heartbeat thread only exists from here, and a build that took
        # longer than heartbeat_dead_after must not read as a stale
        # replica the reaper kills at the first submit
        self._last_hb = time.monotonic()
        self._progress_at = self._last_hb
        if child_faults is not None:
            # the worker holds its own (seeded) half of the plan;
            # arm()/disarm() on the parent plan re-syncs it over the
            # wire so drills can warm up disarmed, then arm both sides
            fault_plan._hosts.append(self)

    # ------------------------ channel setup -------------------------
    def _open_channel(self, spec, env):
        """Bring up the wire to a freshly spawned worker; returns
        ``(socket, Popen)``.  Base implementation: inherited UNIX
        socketpair.  TcpTransport overrides this with listen /
        spawn-with---connect / accept — everything above the socket
        (frames, ledger, heartbeats, faults) is shared."""
        parent, child = socket.socketpair()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.disagg.worker",
             str(child.fileno())],
            pass_fds=(child.fileno(),), env=env)
        child.close()
        return parent, proc

    # ------------------------- wire pump ----------------------------
    def _send_plain(self, msg):
        """The un-faulted logical-frame write (chunk-capable) — also
        the terminal write the fault plan's passthrough path uses, so
        chunking composes with injected faults."""
        send_frame(self._sock, msg, self._wlock,
                   chunk_bytes=self.chunk_bytes)

    def _recv_plain(self):
        """The un-faulted logical-frame read (fragment-reassembling) —
        single reader thread per channel, so the assembler needs no
        lock."""
        asm = self._assembler
        if asm is None:
            asm = self._assembler = FrameAssembler()
        return asm.recv(self._sock)

    def _send(self, msg):
        """One (possibly fault-injected) frame write."""
        if self._faults is None:
            self._send_plain(msg)
        else:
            self._faults.on_send(self, msg)

    def _sync_child_faults(self, armed):
        """Mirror the parent plan's arm/disarm to the worker's child
        half.  Rid-less fire-and-forget on the PLAIN codec: the frame
        must not itself be subject to the plan, and write order under
        _wlock guarantees it lands before any traffic armed after it."""
        if self._dead.is_set():
            return
        try:
            send_frame(self._sock,
                       {"op": "chaos_arm", "armed": bool(armed)},
                       self._wlock)
        except OSError:
            pass

    def _send_stall(self, stall_s):
        """Chaos: ask the worker to WEDGE its engine (a thread holds
        the step lock for `stall_s`) while its heartbeat thread keeps
        beating — the alive-but-stalled failure the wedge watchdog
        exists for.  Rid-less fire-and-forget, written with the plain
        codec so a stall rule cannot recurse into the fault plan."""
        try:
            send_frame(self._sock,
                       {"op": "chaos_stall", "stall_s": float(stall_s)},
                       self._wlock)
        except OSError:
            pass

    def _read_loop(self):
        try:
            while True:
                if self._faults is None:
                    self._dispatch(self._recv_plain())
                else:
                    for frame in self._faults.on_recv(self):
                        self._dispatch(frame)
        except (ChannelClosed, OSError, EOFError, ValueError):
            pass
        except Exception:   # noqa: BLE001 — a poisoned frame is a dead
            pass            # channel, not a crashed router
        self._mark_dead()

    def _dispatch(self, frame):
        rid = frame.get("resp")
        if rid is not None:
            with self._lock:
                wait = self._rpc_waits.pop(rid, None)
            if wait is not None:
                ev, slot = wait
                slot.update(frame)
                ev.set()
            return
        kind = frame.get("ev")
        if kind == "hb":
            now = time.monotonic()
            self._last_hb = now
            load = frame.get("load", self._load)
            self._load = load
            idle = bool(load.get("idle", True))
            seq = frame.get("seq")
            # the wedge watchdog's progress stamp: the clock re-arms
            # whenever the engine completed a step since the last beat
            # OR the replica is idle (no work ⇒ no progress owed)
            if idle or seq is None or seq != self._progress_seq:
                self._progress_seq = seq
                self._progress_at = now
            self._in_step = bool(frame.get("in_step", False))
            self._idle_since = ((self._idle_since or now) if idle
                                else None)
            deltas = frame.get("deltas")
            if deltas:
                with self._lock:
                    self._deltas.extend(deltas)
                    if len(self._deltas) > self.DELTA_COMPACT_AT:
                        self._deltas = compact_prefix_deltas(
                            self._deltas)
                        self.delta_compactions += 1
            addr = frame.get("data")
            if addr is not None:
                self._data_addr = tuple(addr)
            return
        sid = frame.get("sid")
        with self._lock:
            entry = self._inflight.get(sid)
        if entry is None:
            return   # stream already resolved/migrated elsewhere
        entry["last_event"] = time.monotonic()
        handle = entry["handle"]
        if kind == "token":
            # ordered stream protocol: events carry a per-stream index
            # so a duplicated frame is dropped and a lost frame leaves
            # a HOLE, not a mis-ordered stream — the client only ever
            # sees an exact prefix, backfilled from the authoritative
            # result at completion
            n = frame.get("n")
            if n is None:
                entry["next"] += 1
                entry["emitted"] = entry["base"] + entry["next"]
                handle._push_token(frame["t"])
            elif n == entry["next"]:
                entry["next"] += 1
                handle._push_token(frame["t"])
                ahead = entry["ahead"]
                while entry["next"] in ahead:
                    handle._push_token(ahead.pop(entry["next"]))
                    entry["next"] += 1
                entry["emitted"] = entry["base"] + entry["next"]
            elif n > entry["next"]:
                entry["ahead"][n] = frame["t"]
            # n < next: a duplicated frame — already delivered, drop
        elif kind == "done":
            with self._lock:
                self._inflight.pop(sid, None)
            hit = frame.get("prefix_hit")
            if hit is not None and getattr(handle, "prefix_hit_tokens",
                                           0) is None:
                handle.prefix_hit_tokens = hit
            r = frame["result"]
            # backfill any tokens whose event frames were lost: the
            # result's token_ids are authoritative, and the client has
            # exactly the base+next prefix so far
            for t in r["token_ids"][entry["base"] + entry["next"]:]:
                handle._push_token(t)
            handle._finish(GenerationResult(
                r["token_ids"], r["finish_reason"], r["prompt_len"],
                r["preemptions"]))
        elif kind == "handoff":
            # P/D disaggregation: the prefill replica finished this
            # stream's prompt and shipped the sequence snapshot; the
            # stream continues on a decode replica.  Park the snap for
            # the router (take_handoffs) and heal the client stream to
            # exactly n_generated tokens — the import base — so the
            # decode side never gaps or dupes
            with self._lock:
                self._inflight.pop(sid, None)
            snap = frame["snap"]
            n_gen = int(snap["n_generated"])
            gen = snap["tokens"][len(snap["tokens"]) - n_gen:] \
                if n_gen else []
            for t in gen[entry["base"] + entry["next"]:]:
                handle._push_token(t)
            snap["future"] = handle
            with self._lock:
                self._handoffs.append({"snap": snap,
                                       "t": time.monotonic()})
            if self.on_handoff is not None:
                # poke the router from the reader thread: placement
                # RPCs target SIBLING replicas, never this channel, so
                # the reader cannot deadlock on its own socket
                self.on_handoff()
        elif kind == "error":
            with self._lock:
                self._inflight.pop(sid, None)
            handle.set_exception(frame["exc"])

    def _mark_dead(self):
        with self._lock:
            if self._death_handled:
                return
            self._death_handled = True
            waits = list(self._rpc_waits.values())
            self._rpc_waits.clear()
        self._dead.set()
        err = ServingError(
            f"replica {self.name!r} process died mid-call")
        for ev, slot in waits:
            slot["error"] = err
            ev.set()
        if not self._closing and self.on_death is not None:
            # the fleet remigrates the in-flight ledger; the callback
            # runs on the reader thread AFTER every pending RPC was
            # failed, so a router blocked on this replica unwinds first
            self.on_death(self)

    def _call(self, msg, timeout=None):
        """One RPC round-trip under a BOUNDED deadline — `timeout=None`
        means the transport's RpcPolicy default, never unbounded.  A
        missed deadline raises the typed ReplicaTimeoutError; callers
        that can re-issue safely go through _call_idempotent, everyone
        else fails fast into the fleet's remigration ladder."""
        if self._dead.is_set():
            raise ServingError(
                f"replica {self.name!r} process is dead")
        timeout = (self.rpc.timeout_s if timeout is None
                   else float(timeout))
        rid = next(self._ids)
        ev = threading.Event()
        slot = {}
        with self._lock:
            self._rpc_waits[rid] = (ev, slot)
        msg = dict(msg)
        msg["rid"] = rid
        try:
            self._send(msg)
        except OSError as e:
            with self._lock:
                self._rpc_waits.pop(rid, None)
            raise ServingError(
                f"replica {self.name!r} channel write failed") from e
        if not ev.wait(timeout):
            with self._lock:
                self._rpc_waits.pop(rid, None)
            self.timeout_total += 1
            raise ReplicaTimeoutError(
                f"RPC {msg.get('op')!r} to replica {self.name!r} "
                f"exceeded its {timeout:.1f}s deadline")
        if "error" in slot:
            raise slot["error"]
        return slot.get("ok")

    def _call_idempotent(self, msg, timeout=None):
        """Retry an idempotent op (RETRYABLE_OPS) on deadline misses:
        exponential backoff + seeded jitter under the policy's bounded
        attempt budget.  A dead channel never retries — dead is dead."""
        op = msg.get("op")
        assert op in RETRYABLE_OPS, f"op {op!r} is not idempotent"
        last = None
        for attempt in range(self.rpc.retries):
            try:
                return self._call(msg, timeout)
            except ReplicaTimeoutError as e:
                last = e
                if attempt + 1 < self.rpc.retries \
                        and not self._dead.is_set():
                    time.sleep(self.rpc.backoff_s * (2 ** attempt)
                               * (1.0 + 0.25 * self._jitter.random()))
        raise last

    # ------------------------- liveness -----------------------------
    def alive(self):
        return not self._dead.is_set()

    def heartbeat_age(self):
        return max(0.0, time.monotonic() - self._last_hb)

    def kill(self):
        """Hard-kill the worker process (crash-injection for tests and
        drills, and the watchdog's wedge-kill): SIGKILL, no cleanup —
        the reader thread's EOF is the detection path under test."""
        self._proc.kill()

    def wedged(self, after_s, hard_after_s=None):
        """True when the replica is alive-but-STALLED: it reports work
        (engine not idle) but its heartbeat progress stamp hasn't
        advanced — the heartbeat thread outliving a wedged engine
        loop, the one failure socket EOF and stale heartbeats both
        miss.  Two clocks:

        - SOFT (`after_s`): fires only while the engine is NOT inside
          a step — the step loop cannot even take its own lock (the
          classic stall).  An engine mid-step is doing real work: a
          slow first-shape step or a loop capture must never read as
          a wedge.
        - HARD (`hard_after_s`, default 10x soft): fires regardless —
          a step that holds the lock without completing for THIS long
          is hung inside the dispatch, not compiling.

        The router's watchdog kills and remigrates either case
        exactly like a crash."""
        if self._dead.is_set():
            return False
        if bool(self._load.get("idle", True)):
            return False
        frozen = time.monotonic() - self._progress_at
        if hard_after_s is None:
            hard_after_s = 10.0 * float(after_s)
        if frozen > float(hard_after_s):
            return True
        return frozen > float(after_s) and not self._in_step

    def take_orphans(self, grace_s):
        """In-flight ledger entries the child has silently forgotten:
        the worker has reported itself idle (no queue, no live slots)
        for over `grace_s` while these streams still wait — a lost
        completion event (dropped/corrupted `done` frame).  Pops and
        returns them for remigration: seeded sampling replays the
        identical stream and the relay skips the delivered prefix."""
        now = time.monotonic()
        if self._dead.is_set() or self._idle_since is None \
                or now - self._idle_since < float(grace_s):
            return []
        out = []
        with self._lock:
            for sid, entry in list(self._inflight.items()):
                if now - entry["last_event"] > float(grace_s):
                    out.append(self._inflight.pop(sid))
        return out

    # ----------------------- introspection --------------------------
    def describe(self):
        return dict(self._describe)

    def load_info(self):
        return dict(self._load)   # heartbeat-cached (no RPC on the
        # routing hot path; staleness is one heartbeat period)

    def stats(self):
        if self._dead.is_set():
            return {}
        return self._call_idempotent({"op": "stats"})

    # -------------------------- serving -----------------------------
    def submit(self, prompt, kwargs, handle):
        if getattr(handle, "submitted_s", None) is None:
            handle.submitted_s = time.monotonic()
        sid = next(self._ids)
        timeout_ms = kwargs.get("timeout_ms")
        entry = {
            "prompt": list(prompt),
            "kwargs": dict(kwargs),
            "handle": handle,
            "emitted": 0,
            "base": 0, "next": 0, "ahead": {},
            "last_event": time.monotonic(),
            "deadline": (None if timeout_ms is None else
                         time.monotonic() + float(timeout_ms) / 1e3),
        }
        with self._lock:
            self._inflight[sid] = entry
        try:
            self._call({"op": "submit", "sid": sid,
                        "prompt": list(prompt), "kwargs": dict(kwargs)})
        except BaseException:
            with self._lock:
                claimed = self._inflight.pop(sid, None) is None
            if claimed:
                # The entry is already GONE: the death path snapshotted
                # the ledger while our reply was in flight (remigration
                # owns the stream now), or a done/error frame resolved
                # the handle first.  Ownership left this call either
                # way — report PLACED, because raising here would send
                # the router's rung retry after a request the death
                # path is ALSO resubmitting: two live streams feeding
                # one handle, every token delivered twice.
                return handle
            raise
        return handle

    def take_inflight(self):
        """Drain the in-flight ledger — every submitted-but-unfinished
        request with its delivered-token count.  The death path: the
        fleet resubmits each entry elsewhere (seeded sampling replays
        identically; a relay skips what the client already has)."""
        with self._lock:
            entries = list(self._inflight.values())
            self._inflight.clear()
        return entries

    def ping(self, timeout=None):
        """Synthetic liveness probe: one bounded, retried round-trip.
        The watchdog sends these so an idle fleet's half-open breakers
        earn their recovery without waiting for real traffic."""
        if timeout is None:
            timeout = min(5.0, self.rpc.timeout_s)
        return bool(self._call_idempotent({"op": "ping"},
                                          timeout=timeout))

    def cancel(self, handle):
        """Cancel the in-flight stream owned by `handle`: the worker
        frees its queue slot and pages and resolves the stream with a
        ``finish_reason="cancelled"`` done frame (which settles the
        ledger entry through the normal dispatch path — the client
        handle NEVER hangs).  False when the stream is unknown here
        (already finished, migrated away, or replica dead — the death
        path resolves it instead)."""
        if self._dead.is_set():
            return False
        with self._lock:
            sid = next((s for s, e in self._inflight.items()
                        if e["handle"] is handle), None)
        if sid is None:
            return False
        try:
            return bool(self._call_idempotent({"op": "cancel",
                                               "sid": sid}))
        except ServingError:
            return False

    def take_handoffs(self):
        """Drain prefill-complete sequence snapshots this replica
        shipped up (P/D disaggregation).  Each item: ``{"snap": ...,
        "t": parent-received-at}``; snaps carry page BYTES plus the
        client handle — parent-side state, so they survive the worker
        being SIGKILLed right after the handoff frame left."""
        with self._lock:
            out, self._handoffs = self._handoffs, []
        return out

    # ------------------------ page service --------------------------
    def take_prefix_deltas(self):
        with self._lock:
            out, self._deltas = self._deltas, []
        return out

    def export_prefix(self, tokens):
        # idempotent read: a lost reply just re-exports the same run
        return self._call_idempotent({"op": "export_prefix",
                                      "tokens": [int(t) for t in tokens]})

    def import_prefix(self, payload):
        # NOT retried: a lost reply may mean the pages landed; the
        # import is an optimization and a duplicate would only free
        # itself, but re-shipping multi-MB payloads on a timeout is
        # the wrong trade — fail fast, the cold ladder covers it
        return self._call({"op": "import_prefix", "payload": payload})

    def data_address(self):
        """The replica's advertised p2p data port — (host, port), or
        None until the build reply / first heartbeat delivered it."""
        return self._data_addr

    def import_prefix_from(self, addr, tokens, timeout_s=None,
                           levels=("raw",)):
        """P2P adoption: tell THIS replica to dial the holder's data
        port and fetch the warm prefix itself — the payload crosses
        one replica→replica socket and never this control channel.
        NOT retried, same reasoning as import_prefix; the outer RPC
        deadline wraps the child's bounded fetch with headroom so a
        wedged data socket fails typed HERE, not as a parent timeout
        racing the child's."""
        inner = self.rpc.timeout_s if timeout_s is None \
            else float(timeout_s)
        return self._call(
            {"op": "import_prefix_from", "addr": tuple(addr),
             "tokens": [int(t) for t in tokens], "timeout_s": inner,
             "levels": list(levels)},
            timeout=inner + 5.0)

    def flush_prefix(self):
        return self._call_idempotent({"op": "flush_prefix"})

    def reset_stats(self):
        return self._call_idempotent({"op": "reset_stats"})

    # ----------------------- drain / migration ----------------------
    def import_sequence(self, snap):
        handle = snap.get("future")
        sid = next(self._ids)
        payload = {k: v for k, v in snap.items() if k != "future"}
        entry = {
            "prompt": list(snap["prompt"]),
            "kwargs": {"max_new_tokens": snap["max_new_tokens"],
                       "sampling": snap["sampling"],
                       "stop_tokens": snap["stop_tokens"],
                       "timeout_ms": None},
            "handle": handle,
            "emitted": int(snap["n_generated"]),
            "base": int(snap["n_generated"]), "next": 0, "ahead": {},
            "last_event": time.monotonic(),
            "deadline": snap.get("deadline"),
        }
        with self._lock:
            self._inflight[sid] = entry
        try:
            ok = bool(self._call({"op": "import_seq", "sid": sid,
                                  "snap": payload}))
        except BaseException:
            with self._lock:
                self._inflight.pop(sid, None)
            raise
        if not ok:
            with self._lock:
                self._inflight.pop(sid, None)
        return ok

    def drain(self, migrate=True, live=True, timeout=60.0):
        # the ONE op with its own longer budget — the drain may wait
        # `timeout` for residents to finish — still explicit and
        # bounded, never None
        out = self._call(
            {"op": "evacuate", "migrate": bool(migrate),
             "live": bool(live), "timeout": float(timeout)},
            timeout=float(timeout) + self.rpc.timeout_s)
        cold, live_snaps = [], []
        with self._lock:
            for item in out["cold"]:
                entry = self._inflight.pop(item["sid"], None)
                if entry is None:
                    continue   # resolved while the drain was in flight
                req = GenerationRequest(
                    item["prompt"], entry["handle"], item["sampling"],
                    max_new_tokens=item["max_new_tokens"],
                    stop_tokens=item["stop_tokens"],
                    deadline=item["deadline"])
                cold.append((req, max(int(item["emitted"]),
                                      entry["emitted"])))
            for snap in out["live"]:
                entry = self._inflight.pop(snap.pop("sid"), None)
                if entry is None:
                    continue
                snap["future"] = entry["handle"]
                live_snaps.append(snap)
        self.stop()
        return cold, live_snaps

    # ------------------------- lifecycle ----------------------------
    def idle(self):
        if self._dead.is_set():
            return True
        try:
            load = self._call_idempotent(
                {"op": "load"}, timeout=min(10.0, self.rpc.timeout_s))
        except ServingError:
            return True
        self._load = load
        with self._lock:
            busy = bool(self._inflight or self._handoffs)
        return bool(load.get("idle")) and not busy

    def pump(self):
        time.sleep(0.01)   # the child steps itself; just yield

    def stop(self):
        self._closing = True
        clean = False
        if not self._dead.is_set():
            try:
                self._call({"op": "shutdown"},
                           timeout=min(10.0, self.rpc.timeout_s))
                clean = True
            except ServingError:
                pass
        if not clean:
            # dead or unresponsive (wedged engine, poisoned channel):
            # don't wait out a corpse's grace period — reap it now
            self._proc.kill()
        try:
            self._proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10.0)
        try:
            self._sock.close()
        except OSError:
            pass


__all__ = ["InprocTransport", "SubprocTransport", "build_transport",
           "RpcPolicy", "RETRYABLE_OPS", "HEARTBEAT_S"]
