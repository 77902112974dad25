"""Peer-to-peer page data plane.

Control/data split: the router's RPC channel keeps carrying small
control frames (submit, heartbeats, index deltas), while page BYTES
move replica→replica over a dedicated data socket — the router's
involvement in adoption drops to index bookkeeping, and its socket
moves ZERO page bytes (counter-asserted in tests/test_data_plane.py).

- ``PageDataServer``: the holder side.  Every replica binds an
  ephemeral loopback/host port at build, advertises ``(host, port)``
  in heartbeats, and serves one-shot ``fetch_prefix`` requests: the
  request names the tokens plus the importer's codec version/levels,
  the reply carries the pagecodec-encoded payload (or a typed error).
  One connection per fetch — no session state to desync, and a torn
  transfer is just a closed socket.

- ``fetch_prefix_pages``: the importer side.  Dials the holder under
  a bounded deadline (the RpcPolicy timeout the caller passes),
  speaks the same chunked-frame codec as the RPC channel
  (rpc.send_frame / FrameAssembler — multi-MB payloads fragment
  instead of head-blocking), and composes with the chaos FaultPlan
  through the standard codec-host surface, so the drill matrix
  (drop/delay/dup/truncate/corrupt/kill) runs unchanged over the
  data socket.  Every failure mode — refused dial, deadline, torn
  frame, codec mismatch — degrades TYPED (PageTransferError /
  PageCodecError), which the fleet maps to the cold-prefill ladder.
"""
import socket
import threading
import time

from ..admission import ServingError
from . import pagecodec
from .rpc import ChannelClosed, FrameAssembler, send_frame


class PageTransferError(ServingError):
    """A p2p page fetch that could not complete (dial refused,
    deadline missed, channel torn mid-frame) — typed, so adoption
    degrades to the cold-prefill ladder instead of hanging a
    request."""


class _DataChannel:
    """One data-socket dial behind the chaos codec-host contract
    (_sock/_wlock/_send_plain/_recv_plain/kill/_send_stall), so a
    FaultPlan wraps the data plane exactly as it wraps the RPC
    channel.  ``kill`` runs the caller's callback (the worker's
    SIGKILL-self child-side; tearing the socket parent-side) and
    ``stall`` holds the dial until the deadline catches it."""

    def __init__(self, sock, faults=None, chunk_bytes=None,
                 kill_cb=None):
        self._sock = sock
        self._wlock = threading.Lock()
        self._faults = faults
        self._chunk = chunk_bytes
        self._assembler = FrameAssembler()
        self._kill_cb = kill_cb

    def _send_plain(self, msg):
        send_frame(self._sock, msg, self._wlock,
                   chunk_bytes=self._chunk)

    def _recv_plain(self):
        return self._assembler.recv(self._sock)

    def send(self, msg):
        if self._faults is None:
            self._send_plain(msg)
        else:
            self._faults.on_send(self, msg)

    def recv(self):
        if self._faults is None:
            return [self._recv_plain()]
        return self._faults.on_recv(self)

    def kill(self):
        if self._kill_cb is not None:
            self._kill_cb()
            return
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _send_stall(self, stall_s):
        time.sleep(float(stall_s))


class PageDataServer:
    """Holder-side data-plane listener: a daemon accept loop serving
    one ``fetch_prefix`` per connection.  ``export_fn(tokens)`` is
    the engine's export_prefix_pages (thread-safe under the engine
    lock); encoding happens here, per-request, at the negotiated
    level — a mixed-version fleet is refused typed, never garbled."""

    REQUEST_TIMEOUT_S = 30.0

    def __init__(self, export_fn, host="127.0.0.1", port=0,
                 chunk_bytes=None):
        self._export = export_fn
        self._chunk = chunk_bytes
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(8)
        self.address = (host, self._sock.getsockname()[1])
        self.requests_served = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="page-data-server",
            daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return   # listener closed: shutdown
            if self._closed:
                # stop() raced our accept: a dial that sneaked in as
                # the listener died must NOT be served by a stopped
                # holder — drop it so the importer degrades typed
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             name="page-data-serve", daemon=True).start()

    def _serve_one(self, conn):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(self.REQUEST_TIMEOUT_S)
            req = FrameAssembler().recv(conn)
            if not isinstance(req, dict) \
                    or req.get("op") != "fetch_prefix":
                raise PageTransferError(
                    f"data socket expects fetch_prefix, got "
                    f"{req.get('op') if isinstance(req, dict) else req!r}")
            level = pagecodec.negotiate(req.get("pv"),
                                        req.get("levels") or ("raw",))
            payload = self._export(list(req.get("tokens", ())))
            enc = (None if payload is None
                   else pagecodec.encode_payload(payload, level))
            reply = {"ok": enc}
        except Exception as e:   # noqa: BLE001 — typed errors ride the
            reply = {"error": e}   # wire back, like the RPC channel
        try:
            send_frame(conn, reply, threading.Lock(),
                       chunk_bytes=self._chunk)
            self.requests_served += 1
        except Exception:   # noqa: BLE001 — importer gone or an
            pass            # unserializable error payload: give up
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self):
        self._closed = True
        # shutdown() BEFORE close(): the accept thread blocked in
        # accept() holds a kernel reference to the listening socket,
        # so close() alone leaves the port accepting until the next
        # (stale) dial is served — shutdown wakes the accept with an
        # error and releases the port NOW
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def fetch_prefix_pages(addr, tokens, timeout_s=15.0,
                       levels=pagecodec.SUPPORTED_LEVELS,
                       chunk_bytes=None, faults=None, kill_cb=None):
    """Importer-side fetch: dial the holder's data port, request the
    warm prefix for `tokens`, decode the reply.  Returns
    ``(payload_or_None, wire_bytes, raw_bytes)``.  Bounded end to end
    by `timeout_s` (dial + both frame directions); every failure is
    typed — PageTransferError for wire trouble, PageCodecError for a
    version/level mismatch, and a holder-side error frame re-raises
    its (Serving-typed) exception here."""
    deadline = time.monotonic() + float(timeout_s)
    try:
        sock = socket.create_connection(tuple(addr),
                                        timeout=float(timeout_s))
    except OSError as e:
        raise PageTransferError(
            f"page data dial to {addr} failed: {e}") from e
    ch = _DataChannel(sock, faults=faults, chunk_bytes=chunk_bytes,
                      kill_cb=kill_cb)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(float(timeout_s))
        try:
            ch.send({"op": "fetch_prefix",
                     "tokens": [int(t) for t in tokens],
                     "pv": pagecodec.VERSION, "levels": list(levels)})
            reply = None
            while reply is None:
                if time.monotonic() > deadline:
                    raise PageTransferError(
                        f"page fetch from {addr} missed its "
                        f"{timeout_s}s deadline")
                frames = ch.recv()   # chaos drop returns [] — re-read
                if frames:
                    reply = frames[0]
        except ServingError:
            raise
        except (socket.timeout, ChannelClosed, OSError, EOFError,
                ValueError) as e:
            # deadline, torn/poisoned frame (FaultInjected is a
            # ValueError), or the holder died mid-transfer
            raise PageTransferError(
                f"page fetch from {addr} failed: "
                f"{type(e).__name__}: {e}") from e
        if not isinstance(reply, dict):
            raise PageTransferError(
                f"page fetch from {addr}: malformed reply")
        if "error" in reply:
            exc = reply["error"]
            if isinstance(exc, ServingError):
                raise exc
            raise PageTransferError(
                f"holder {addr} refused page fetch: {exc!r}")
        enc = reply.get("ok")
        if enc is None:
            return None, 0, 0   # evicted since the last delta pull
        return (pagecodec.decode_payload(enc), pagecodec.wire_bytes(enc),
                pagecodec.raw_bytes(enc))
    finally:
        try:
            sock.close()
        except OSError:
            pass


__all__ = ["PageDataServer", "PageTransferError", "fetch_prefix_pages"]
