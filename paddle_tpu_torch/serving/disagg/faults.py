"""Deterministic fault injection for the replica process boundary.

A ``FaultPlan`` wraps the rpc.py frame codec PARENT-SIDE (the
SubprocTransport's sends and its reader thread's receives), so every
chaos scenario — a dropped submit, a duplicated token event, a
corrupted frame, a worker killed mid-export, an engine that wedges
while its heartbeat keeps flowing — is a fast, seeded, reproducible
unit test instead of a flake.  Faults land exactly where real ones
do, on the wire between the router and the replica.

Rules with ``side="child"`` run in the WORKER process instead: the
transport ships them (plus a derived seed) in the build frame, the
worker builds its own plan and wraps ITS half of the codec — so
child→parent frame corruption (a token event the worker mangles
before it ever leaves, a worker that SIGKILLs itself mid-stream) is
covered too, not just the parent's view.  ``arm()``/``disarm()`` on
the parent plan re-sync every attached transport's child half over
the wire.

Fault kinds (``FaultRule.kind``):

================  ========================================================
``drop``          the frame never reaches the peer (a lost datagram in
                  socket clothing: RPC requests time out typed, stream
                  events are healed by sequence numbers / the orphan
                  sweep)
``delay``         the frame is held ``delay_s`` before delivery (send
                  side: the caller thread sleeps; recv side: the reader
                  thread sleeps — everything behind it queues, like a
                  congested link)
``dup``           the frame is delivered twice (stream events carry
                  per-stream sequence numbers so the parent dedups;
                  replies dedup on rid)
``truncate``      a torn write: the length header promises more payload
                  bytes than follow, desyncing the channel — the peer
                  blocks mid-frame and every later RPC times out
``corrupt``       the payload bytes are flipped (seeded positions):
                  send side the worker dies unpickling, recv side the
                  reader declares the channel poisoned — both collapse
                  to the crash path
``kill``          SIGKILL the worker the moment the named point is hit
                  (kill-at-submit, mid-stream, at export/import, at
                  heartbeat) — socket EOF is the detection under test
``stall``         the worker's ENGINE wedges (a thread holds the step
                  lock for ``stall_s``) while its heartbeat thread
                  keeps beating — the alive-but-stalled failure only
                  the wedge watchdog can catch
================  ========================================================

Injection points (``FaultRule.point``): on the send direction the RPC
op name (``"submit"``, ``"stats"``, ``"export_prefix"``,
``"import_seq"``, ``"evacuate"``, ...); on the recv direction the
event kind (``"token"`` — mid-stream, ``"done"``, ``"error"``,
``"hb"`` — heartbeat) or ``"resp"`` (any RPC reply).  ``"any"``
matches every frame in the rule's direction(s).

Determinism: each rule counts its OWN matching frames and fires on
matches ``after .. after+count-1``; a ``prob`` rule draws from the
plan's seeded RNG instead.  Same plan + same traffic order ⇒ same
faults.  ``FaultPlan.fired`` logs every firing for drill reports.

Docs: docs/SERVING.md "Failure model".
"""
import pickle
import random
import threading
import time

from .rpc import _HEADER

KINDS = ("drop", "delay", "dup", "truncate", "corrupt", "kill", "stall")
DIRECTIONS = ("send", "recv")
# kinds that end (or wedge) the replica — a drill keeps at least one
# replica free of these so surviving streams have somewhere to land
FATAL_KINDS = ("kill", "stall", "corrupt", "truncate")


class FaultInjected(ValueError):
    """Raised by recv-side corrupt/truncate rules: the frame codec
    declares the channel poisoned, exactly as a real corrupt frame
    would — the reader thread's dead-channel path is the code under
    test."""


class FaultRule:
    """One scheduled fault: `kind` at `point`, firing on this rule's
    ``after``-th matching frame (then ``count-1`` more).  ``direction``
    restricts matching to "send"/"recv" (None = both — points rarely
    collide across directions anyway).  ``prob`` replaces the
    deterministic window with a seeded coin flip per match.  ``side``
    picks the process that applies the rule: "parent" (the transport's
    codec — default, the historical behavior) or "child" (shipped to
    the worker, which wraps its own sends/recvs; directions are then
    relative to the WORKER, so side="child" direction="send" faults
    the token/done/hb events it emits)."""

    __slots__ = ("point", "kind", "direction", "after", "count",
                 "delay_s", "stall_s", "prob", "side", "_seen")

    def __init__(self, point, kind, direction=None, after=0, count=1,
                 delay_s=0.05, stall_s=30.0, prob=None, side="parent"):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if direction is not None and direction not in DIRECTIONS:
            raise ValueError(
                f"direction must be 'send', 'recv' or None, got "
                f"{direction!r}")
        if side not in ("parent", "child"):
            raise ValueError(
                f"side must be 'parent' or 'child', got {side!r}")
        if int(after) < 0 or int(count) < 1:
            raise ValueError(
                f"need after >= 0 and count >= 1, got after={after} "
                f"count={count}")
        self.point = str(point)
        self.kind = kind
        self.direction = direction
        self.after = int(after)
        self.count = int(count)
        self.delay_s = float(delay_s)
        self.stall_s = float(stall_s)
        self.prob = None if prob is None else float(prob)
        self.side = side
        self._seen = 0

    def _matches(self, direction, point, rng):
        if self.direction is not None and self.direction != direction:
            return False
        if self.point != "any" and self.point != point:
            return False
        n = self._seen
        self._seen += 1
        if self.prob is not None:
            return rng.random() < self.prob
        return self.after <= n < self.after + self.count

    def __repr__(self):
        return (f"FaultRule({self.point!r}, {self.kind!r}, "
                f"after={self.after}, count={self.count})")


class FaultPlan:
    """A seeded schedule of FaultRules applied to one transport's
    frame codec.  Thread-safe (the transport's caller threads and its
    reader thread both consult it); ``fired`` is the audit log drills
    and tests read back."""

    def __init__(self, rules=(), seed=0, armed=True, holder="parent"):
        self.rules = list(rules)
        self.seed = seed
        self.holder = holder   # which process applies this copy:
        # "parent" (the transport) or "child" (the worker's shipped
        # half) — rules tagged for the OTHER side never match here
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.armed = bool(armed)   # a disarmed plan is a pure
        # passthrough and counts nothing: drills build the fleet and
        # pay its compile warmup BEFORE the schedule starts ticking
        self.fired = []   # [{"kind", "point", "direction", "t"}]
        self._hosts = []  # transports whose workers hold this plan's
        # child half — arm()/disarm() re-syncs them over the wire

    def arm(self):
        # children first: the parent half must still be disarmed while
        # the sync frame is in flight, or an armed "any" send rule
        # could fault the sync itself
        for host in list(self._hosts):
            host._sync_child_faults(True)
        self.armed = True

    def disarm(self):
        self.armed = False
        for host in list(self._hosts):
            host._sync_child_faults(False)

    def child_spec(self):
        """The worker-shipped half: ``{"rules", "seed", "armed"}`` for
        this plan's side="child" rules, or None when there are none.
        The seed is derived so parent and child draws never share a
        stream."""
        child = [r for r in self.rules if r.side == "child"]
        if not child:
            return None
        return {"rules": child, "seed": ("child", self.seed),
                "armed": self.armed}

    def _take(self, direction, point):
        """The rules firing on this frame (usually 0 or 1).  Rules
        destined for the other process (side="child" on a parent-held
        plan) never match here — the worker's own copy applies them."""
        with self._lock:
            if not self.armed:
                return []
            hits = [r for r in self.rules if r.side == self.holder
                    and r._matches(direction, point, self._rng)]
            now = time.monotonic()
            for r in hits:
                self.fired.append({"kind": r.kind, "point": point,
                                   "direction": direction, "t": now})
            return hits

    def fired_kinds(self):
        return sorted({f["kind"] for f in self.fired})

    # ---------------------- codec integration -----------------------
    # Both hooks are called by SubprocTransport in place of the plain
    # send_frame/recv_frame; a plan-less transport never enters here.

    def on_send(self, transport, msg):
        """Apply send-direction rules and perform the (possibly
        faulted) write of `msg` on the transport's socket.
        `transport` is any codec host exposing _sock/_wlock/kill()/
        _send_stall()/_send_plain() — the SubprocTransport parent-side,
        the worker's fault host child-side."""
        point = msg.get("op") or msg.get("ev", "?")
        hits = self._take("send", point)
        kinds = {r.kind for r in hits}
        for r in hits:
            if r.kind == "delay":
                time.sleep(r.delay_s)
        if "kill" in kinds:
            # kill-at-named-point: the worker dies the instant the
            # router speaks to it — the frame never leaves
            transport.kill()
            return
        if "stall" in kinds:
            stall_s = max(r.stall_s for r in hits if r.kind == "stall")
            transport._send_stall(stall_s)
        if "drop" in kinds:
            return
        if "corrupt" in kinds or "truncate" in kinds:
            payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            if "corrupt" in kinds:
                # flip the opcode stream from byte 0: deterministic
                # positions from the plan RNG, dense enough that the
                # peer's unpickle cannot survive it
                buf = bytearray(payload)
                buf[0] ^= 0xFF
                for _ in range(max(4, len(buf) // 4)):
                    buf[self._rng.randrange(len(buf))] ^= 0xFF
                payload = bytes(buf)
            else:
                # torn write: promise the full length, deliver half —
                # the peer blocks mid-frame and the channel desyncs
                payload = payload[:max(1, len(payload) // 2)]
                data = _HEADER.pack(len(payload) * 2) + payload
                with transport._wlock:
                    transport._sock.sendall(data)
                return
            data = _HEADER.pack(len(payload)) + payload
            with transport._wlock:
                transport._sock.sendall(data)
            return
        transport._send_plain(msg)
        if "dup" in kinds:
            transport._send_plain(msg)

    def on_recv(self, transport):
        """Read one logical frame off the transport's channel and
        return the list of frames to dispatch (0 = dropped, 2 =
        duplicated).  Raises FaultInjected for corrupt/truncate rules
        — the reader thread's poisoned-channel path."""
        frame = transport._recv_plain()
        point = frame.get("ev") or ("resp" if "resp" in frame
                                    else frame.get("op", "?"))
        hits = self._take("recv", point)
        kinds = {r.kind for r in hits}
        for r in hits:
            if r.kind == "delay":
                time.sleep(r.delay_s)
        if "kill" in kinds:
            # e.g. mid-stream: the worker dies right after this token
            transport.kill()
        if "stall" in kinds:
            stall_s = max(r.stall_s for r in hits if r.kind == "stall")
            transport._send_stall(stall_s)
        if "corrupt" in kinds or "truncate" in kinds:
            raise FaultInjected(
                f"chaos: {sorted(kinds & {'corrupt', 'truncate'})} "
                f"frame at {point!r}")
        if "drop" in kinds:
            return []
        if "dup" in kinds:
            return [frame, frame]
        return [frame]


__all__ = ["FaultPlan", "FaultRule", "FaultInjected", "KINDS",
           "FATAL_KINDS", "DIRECTIONS"]
