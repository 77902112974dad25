"""Replica worker process — the child half of SubprocTransport.

Two launch modes, one serve loop:

- ``python -m paddle_tpu_torch.serving.disagg.worker <fd>`` — inherit
  a UNIX socketpair fd from the parent (same-host SubprocTransport).
- ``python -m paddle_tpu_torch.serving.disagg.worker --connect
  host:port``
  — dial back to the parent's ReplicaListener over TCP
  (TcpTransport, the cross-host path).

Either way the worker builds ONE single-process GenerationEngine from
the pickled build spec (first RPC frame) and serves the transport RPC
contract: submit streams tokens back as events, evacuate ships cold
requests and live sequence snapshots for migration, cancel frees a
stream's slot and pages, a heartbeat thread reports load + prefix
register/evict deltas every ``HEARTBEAT_S``.  A prefill-role worker
additionally parks each sequence at prompt completion and ships the
snapshot up as a ``handoff`` event (P/D disaggregation).  The engine
steps itself on its background worker thread — a replica is exactly the
single-process engine the in-process oracle runs, behind a socket.

The model arrives as its own pickle (TinyCausalLM pickles as constructor
arguments plus numpy arrays) and is rebuilt here on this process's device
of the type it had in the parent; the engine runs on the device its
GenerationConfig names.  A worker that lacks that device (no CUDA for a
"cuda" config) fails the build with the typed error the parent's build
handshake raises — it never carries on on the CPU.

The build frame may carry the CHILD half of a chaos FaultPlan
(side="child" rules + a derived seed): the worker then wraps its own
sends/recvs so child→parent frame corruption, self-SIGKILL and
self-stall are all seeded, reproducible faults too.

Frame schema: docs/SERVING.md "Disaggregated fleet".
"""
import os
import signal
import socket
import sys
import threading
import time
import traceback


class _StreamHandle:
    """Engine-side handle that RELAYS the stream over the socket: the
    duck-typed surface GenerationEngine drives (_push_token/_finish/
    set_exception/done + the stamp attributes), writing one event
    frame per transition.  The parent-side transport reassembles the
    client's GenerationHandle from these frames."""

    __slots__ = ("sid", "_send_event", "submitted_s", "first_token_s",
                 "prefix_hit_tokens", "_done", "_n")

    def __init__(self, sid, send_event):
        self.sid = sid
        self._send_event = send_event
        self.submitted_s = None
        self.first_token_s = None
        self.prefix_hit_tokens = None
        self._done = False
        self._n = 0   # per-stream event index: the parent dedups
        # duplicated frames and detects holes from dropped ones

    def _send(self, obj):
        try:
            self._send_event(obj)
        except OSError:
            pass   # parent gone; this process is about to die anyway

    def _push_token(self, token):
        if self.first_token_s is None:
            self.first_token_s = time.monotonic()
        n = self._n
        self._n += 1
        self._send({"ev": "token", "sid": self.sid, "t": int(token),
                    "n": n})

    def _finish(self, result):
        if self._done:
            return
        self._done = True
        self._send({"ev": "done", "sid": self.sid,
                    "prefix_hit": self.prefix_hit_tokens,
                    "result": {"token_ids": list(result.token_ids),
                               "finish_reason": result.finish_reason,
                               "prompt_len": result.prompt_len,
                               "preemptions": result.preemptions}})

    def set_exception(self, exc):
        if self._done:
            return
        self._done = True
        self._send({"ev": "error", "sid": self.sid, "exc": exc})

    def done(self):
        return self._done


class _Worker:
    def __init__(self, sock):
        from .rpc import FrameAssembler

        self.sock = sock
        self.wlock = threading.Lock()
        self.engine = None
        self.registry = None
        self.chunk_bytes = None   # set by the build frame
        self.faults = None        # child half of a chaos FaultPlan
        self.data_server = None   # p2p page data plane
        self.handles = {}         # sid -> live _StreamHandle (cancel)
        self._hlock = threading.Lock()
        self._assembler = FrameAssembler()
        self._stop_hb = threading.Event()
        # fault-host aliases: FaultPlan.on_send/on_recv drive a codec
        # host through _sock/_wlock/kill/_send_stall/_send_plain —
        # child-side, that host is the worker itself
        self._sock = sock
        self._wlock = self.wlock

    # ------------------------ codec plumbing ------------------------
    def _send_plain(self, msg):
        from .rpc import send_frame

        send_frame(self.sock, msg, self.wlock,
                   chunk_bytes=self.chunk_bytes)

    def _recv_plain(self):
        return self._assembler.recv(self.sock)

    def send_event(self, obj):
        """Event-frame write (token/done/error/hb/handoff): the path
        child-side send faults wrap."""
        if self.faults is None:
            self._send_plain(obj)
        else:
            self.faults.on_send(self, obj)

    def recv(self):
        if self.faults is None:
            return [self._recv_plain()]
        return self.faults.on_recv(self)

    def kill(self):
        """Child-side 'kill' fault: this worker SIGKILLs ITSELF — the
        parent sees exactly what a real crash looks like (socket EOF,
        no goodbye)."""
        os.kill(os.getpid(), signal.SIGKILL)

    def _send_stall(self, stall_s):
        """Child-side 'stall' fault: wedge our own engine."""
        self.op_chaos_stall({"stall_s": stall_s})

    # --------------------------- ops --------------------------------
    def op_build(self, frame):
        import pickle

        from ...generation.engine import GenerationEngine
        from ...generation.metrics import GenerationMetrics
        from ...profiler.monitor import StatRegistry
        from .transport import HEARTBEAT_S

        self.chunk_bytes = frame.get("chunk_bytes")
        fspec = frame.get("faults")
        if fspec is not None:
            from .faults import FaultPlan

            self.faults = FaultPlan(fspec["rules"], seed=fspec["seed"],
                                    armed=fspec["armed"],
                                    holder="child")
        model = frame["model"]
        if isinstance(model, bytes):
            # unpickled HERE, not with the frame: a rebuild that fails
            # (no device of the model's type) answers the build typed
            model = pickle.loads(model)
        self.registry = StatRegistry()
        self.engine = GenerationEngine(
            model, frame["config"],
            metrics=GenerationMetrics(registry=self.registry),
            start=True)
        if self.engine.prefix_cache_enabled:
            self.engine.cache.enable_prefix_deltas()
        if frame.get("role") == "prefill":
            # P/D disaggregation: park each sequence at prompt
            # completion; the engine's step loop notifies us (lock
            # already released) and we ship the snapshots up as
            # handoff events for the router to place on decode
            # replicas
            self.engine.enable_handoff()
            self.engine.on_handoff = self._ship_handoffs
        # the p2p data plane: bind an ephemeral data port siblings
        # dial DIRECTLY for page bytes (advertised in heartbeats and
        # the build reply) — the router's socket stays control-only
        from .data_plane import PageDataServer

        self.data_server = PageDataServer(
            self.engine.export_prefix_pages,
            host=frame.get("data_host") or "127.0.0.1",
            chunk_bytes=self.chunk_bytes)
        threading.Thread(target=self._heartbeat, args=(HEARTBEAT_S,),
                         name="replica-heartbeat", daemon=True).start()
        out = dict(self.engine.describe())
        out["data_address"] = self.data_server.address
        return out

    def _ship_handoffs(self):
        for snap in self.engine.take_handoffs():
            handle = snap.pop("future")
            handle._done = True   # stream continues elsewhere; no
            # late done/error frame may race the handoff
            payload = dict(snap)
            with self._hlock:
                self.handles.pop(handle.sid, None)
            try:
                self.send_event({"ev": "handoff", "sid": handle.sid,
                                 "snap": payload})
            except OSError:
                return   # parent gone; nothing to hand off to

    def _heartbeat(self, interval):
        while not self._stop_hb.wait(interval):
            try:
                deltas = self.engine.cache.take_prefix_deltas()
                # "seq" is the engine's step-progress stamp: this
                # thread deliberately shares NO lock with the step
                # loop, so a wedged engine keeps heartbeating a FROZEN
                # seq while reporting work — exactly the signature the
                # parent's wedge watchdog kills on
                self.send_event(
                    {"ev": "hb", "load": self.engine.load_info(),
                     "seq": self.engine.step_seq,
                     "in_step": self.engine.in_step,
                     "deltas": deltas,
                     # data-port advert: the parent learns (and after
                     # a restart re-learns) where to send siblings
                     # for this replica's page bytes
                     "data": (None if self.data_server is None
                              else self.data_server.address)})
            except OSError:
                return
            except Exception:   # noqa: BLE001 — a heartbeat must never
                pass            # kill the worker; the next beat retries

    def _register(self, sid, handle):
        with self._hlock:
            # opportunistic prune keeps the map at O(live streams)
            for old_sid in [s for s, h in self.handles.items()
                            if h.done()]:
                del self.handles[old_sid]
            self.handles[sid] = handle

    def op_submit(self, frame):
        sid = frame["sid"]
        # the wire is at-least-once (dup faults, RPC redelivery): a
        # sid we already own must NOT start a second stream — the
        # doubled token events would interleave into the parent's one
        # ledger entry as a duplicated client stream
        with self._hlock:
            live = self.handles.get(sid)
            if live is not None and not live.done():
                return True
        handle = _StreamHandle(sid, self.send_event)
        self._register(sid, handle)
        self.engine.submit(frame["prompt"], handle=handle,
                           **frame["kwargs"])
        return True

    def op_cancel(self, frame):
        """Free the stream's queue slot and pages; the engine resolves
        the handle with finish_reason="cancelled", whose done frame
        settles the parent's ledger entry — the client never hangs."""
        with self._hlock:
            handle = self.handles.pop(frame["sid"], None)
        if handle is None or handle.done():
            return False
        return bool(self.engine.cancel(handle))

    def op_load(self, frame):
        return self.engine.load_info()

    def op_stats(self, frame):
        return {
            "generation":
                self.registry.stats_snapshot("generation.")["stats"],
            "cache": self.engine.cache.stats(),
        }

    def op_evacuate(self, frame):
        # the same drain state machine as InprocTransport.drain —
        # engine.drain_work, so the oracle and the process boundary
        # cannot diverge (the child's engine always runs its worker
        # thread, so drain_work's wait loop just sleeps here)
        cold, live_snaps = self.engine.drain_work(
            migrate=frame["migrate"], live=frame["live"],
            timeout=frame["timeout"])
        out = {"cold": [], "live": []}
        for req, emitted in cold:
            out["cold"].append({
                "sid": req.future.sid,
                "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "sampling": req.params,
                "stop_tokens": tuple(req.stop_tokens),
                "deadline": req.deadline,
                "emitted": int(emitted),
            })
        for snap in live_snaps:
            snap["sid"] = snap.pop("future").sid
            out["live"].append(snap)
        return out

    def op_import_seq(self, frame):
        snap = frame["snap"]
        handle = _StreamHandle(frame["sid"], self.send_event)
        self._register(frame["sid"], handle)
        return bool(self.engine.import_sequence(snap, handle=handle))

    def op_export_prefix(self, frame):
        return self.engine.export_prefix_pages(frame["tokens"])

    def op_import_prefix(self, frame):
        return self.engine.import_prefix_pages(frame["payload"])

    def op_import_prefix_from(self, frame):
        """P2P adoption: dial the HOLDER's data port directly, fetch
        + decode the warm prefix, install it locally — the page bytes
        never touch the router's socket.  The dial runs under this
        worker's own fault plan (point "fetch_prefix" / "resp"), so
        the chaos matrix covers the data socket too; a "kill" rule
        SIGKILLs this worker mid-transfer, exactly like the RPC
        channel's kill faults.  Typed failures ride the reply wire
        back and degrade fleet-side to the cold-prefill ladder."""
        from .data_plane import fetch_prefix_pages

        payload, wire, raw = fetch_prefix_pages(
            tuple(frame["addr"]), frame["tokens"],
            timeout_s=float(frame.get("timeout_s", 15.0)),
            levels=frame.get("levels") or ("raw",),
            chunk_bytes=self.chunk_bytes, faults=self.faults,
            kill_cb=self.kill)
        added = (0 if payload is None
                 else self.engine.import_prefix_pages(payload))
        return {"added": added, "wire_bytes": wire, "raw_bytes": raw}

    def op_flush_prefix(self, frame):
        return self.engine.cache.flush_prefix_cache()

    def op_reset_stats(self, frame):
        self.registry.reset_all()
        return True

    def op_ping(self, frame):
        return True

    def op_chaos_arm(self, frame):
        """Parent plan arm()/disarm() mirrored to our child half."""
        if self.faults is not None:
            if frame.get("armed"):
                self.faults.armed = True
            else:
                self.faults.armed = False
        return True

    def op_chaos_stall(self, frame):
        """Chaos-injection hook (serving/disagg/faults.py "stall"):
        WEDGE the engine — a daemon thread holds the step lock for
        `stall_s` — while this serve loop and the heartbeat thread
        keep running.  The replica looks alive (fresh heartbeats, RPC
        replies) but makes no decode progress: the failure mode only
        the parent's wedge watchdog can catch."""
        stall_s = float(frame.get("stall_s", 30.0))
        lock = self.engine._lock

        def hold():
            with lock:
                time.sleep(stall_s)

        threading.Thread(target=hold, name="chaos-stall",
                         daemon=True).start()
        return True

    def op_shutdown(self, frame):
        self._stop_hb.set()
        if self.data_server is not None:
            self.data_server.stop()
        if self.engine is not None:
            self.engine.shutdown()
        return True

    # --------------------------- loop -------------------------------
    def serve(self):
        from ..admission import ServingError
        from .rpc import ChannelClosed

        while True:
            try:
                frames = self.recv()
            except (ChannelClosed, OSError, Exception):  # noqa: B014
                # parent died, or a poisoned inbound frame (chaos
                # corrupt/truncate, real damage) desynced the channel:
                # either way there is nothing left to serve — shut
                # down cleanly, the parent's EOF detection takes over
                self._stop_hb.set()
                if self.engine is not None:
                    self.engine.shutdown()
                return
            stop = False
            for frame in frames:
                if self._serve_one(frame, ServingError):
                    stop = True
            if stop:
                return

    def _serve_one(self, frame, serving_error):
        """Handle one inbound op frame; True means exit the loop."""
        rid = frame.get("rid")
        op = frame.get("op")
        try:
            handler = getattr(self, f"op_{op}", None)
            if handler is None:
                # a frame that decoded but names no op (garbage
                # that survived unpickling) must answer typed, not
                # crash the worker on an AttributeError
                raise serving_error(f"unknown op {op!r}")
            result = handler(frame)
            reply = {"resp": rid, "ok": result}
        except Exception as e:   # noqa: BLE001 — typed errors ride
            reply = {"resp": rid, "error": e}   # the wire back
        if rid is not None:
            try:
                self._send_plain(reply)
            except OSError:
                return True   # parent gone
            except Exception:   # noqa: BLE001 — unpicklable payload:
                try:            # degrade to a typed, serializable error
                    self._send_plain(
                        {"resp": rid, "error": serving_error(
                            f"op {op!r} reply not serializable: "
                            f"{traceback.format_exc(limit=3)}")})
                except OSError:
                    return True
        return op == "shutdown"


def main(argv):
    if argv and argv[0] == "--connect":
        host, _, port = argv[1].rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
    else:
        sock = socket.socket(fileno=int(argv[0]))
    _Worker(sock).serve()


if __name__ == "__main__":
    main(sys.argv[1:])
