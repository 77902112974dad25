"""Length-prefixed pickled frames over a byte-stream socket — the wire
format both halves of the replica process boundary speak (UNIX
socketpair for SubprocTransport, a TCP connection for TcpTransport).

One frame is ``>I`` payload length + a pickled Python object.  Every
RPC request carries ``{"op": ..., "rid": n}`` and is answered by
exactly one ``{"resp": n, "ok": value}`` or ``{"resp": n, "error":
exc}``; everything else on the wire is an EVENT frame (``{"ev": ...}``:
streamed tokens, completions, heartbeats) that needs no reply.  The
schema table lives in docs/SERVING.md "Disaggregated fleet".

CHUNKED payloads: a logical frame whose pickled payload exceeds
`chunk_bytes` is fragmented into ``{"frag": fid, "i": k, "of": n,
"data": bytes}`` carrier frames, each a small frame of its own and
each written under the socket lock INDIVIDUALLY — so a multi-MB page
export or migration snapshot never holds the write lock for one giant
sendall, and heartbeats / token events interleave between fragments
instead of queueing behind them.  The receive side reassembles by
fragment id (``FrameAssembler``); fragments from concurrent senders
interleave safely because each carries its own fid.  Per-frame bytes
on the wire are therefore bounded by ``chunk_bytes`` + the carrier
overhead, whatever the logical payload size.

Pickle is safe here because both endpoints are the same trusted
codebase talking over a channel the parent created (an inherited
socketpair, or a TCP connection the parent listened for and handed to
the child it spawned) — this is a process boundary under one
operator, not an open network protocol.
"""
import itertools
import os
import pickle
import struct

_HEADER = struct.Struct(">I")
# a frame larger than this is a protocol bug, not a payload (page
# exports are the biggest legitimate frames — tens of MB at most)
MAX_FRAME_BYTES = 1 << 30
# default fragmentation bound for chunk-capable senders: big enough
# that RPC chatter never fragments, small enough that one fragment's
# sendall cannot stall heartbeats behind a 100k-token page export
DEFAULT_CHUNK_BYTES = 256 << 10

# fragment ids are per-process unique (pid folded in so both halves
# of a channel can fragment concurrently without colliding)
_frag_ids = itertools.count(1)


class ChannelClosed(EOFError):
    """The peer closed the socket (process exit or crash)."""


def _send_one(sock, payload, lock):
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    data = _HEADER.pack(len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def send_frame(sock, obj, lock=None, chunk_bytes=None):
    """Pickle `obj` and write one logical frame.  `lock` serializes
    concurrent writers (engine worker thread streaming tokens vs the
    heartbeat thread vs RPC replies).  With `chunk_bytes`, a payload
    past the bound ships as fragment carrier frames instead — each
    written under the lock individually, so other writers interleave
    mid-payload (the receiver must run a FrameAssembler)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if chunk_bytes is None or len(payload) <= int(chunk_bytes):
        _send_one(sock, payload, lock)
        return
    chunk = int(chunk_bytes)
    fid = (os.getpid(), next(_frag_ids))
    parts = range(0, len(payload), chunk)
    total = len(parts)
    for k, off in enumerate(parts):
        _send_one(sock, pickle.dumps(
            {"frag": fid, "i": k, "of": total,
             "data": payload[off:off + chunk]},
            protocol=pickle.HIGHEST_PROTOCOL), lock)


def _recv_exact(sock, n):
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ChannelClosed("peer closed the channel")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock):
    """Read one WIRE frame; raises ChannelClosed on EOF (peer death).
    May return a fragment carrier — chunk-capable receivers go through
    FrameAssembler.recv, which reassembles logical frames."""
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"incoming frame claims {length} bytes "
                         f"(> MAX_FRAME_BYTES) — corrupt stream")
    return pickle.loads(_recv_exact(sock, length))


class FrameAssembler:
    """Reassembles fragmented logical frames on one channel's receive
    side.  Each channel has exactly ONE reader thread, so no locking;
    fragments of different fids interleave freely (concurrent senders),
    fragments of one fid arrive in order (one sender wrote them FIFO
    to one socket).  A missing or out-of-order fragment within a fid
    is a desynced channel — typed ValueError, the poisoned-channel
    path, exactly like a corrupt length header."""

    def __init__(self):
        self._parts = {}   # fid -> [data, ...]

    def feed(self, frame):
        """One wire frame in; the completed logical frame out, or None
        while a fragmented payload is still accumulating."""
        if not (isinstance(frame, dict) and "frag" in frame):
            return frame
        fid, i, of = frame["frag"], frame["i"], frame["of"]
        parts = self._parts.setdefault(fid, [])
        if i != len(parts) or not (0 < of <= MAX_FRAME_BYTES):
            self._parts.pop(fid, None)
            raise ValueError(
                f"fragment {i}/{of} of {fid!r} arrived out of order "
                f"(have {len(parts)}) — corrupt stream")
        parts.append(frame["data"])
        if len(parts) < of:
            return None
        del self._parts[fid]
        return pickle.loads(b"".join(parts))

    def recv(self, sock):
        """Read wire frames until one LOGICAL frame completes."""
        while True:
            out = self.feed(recv_frame(sock))
            if out is not None:
                return out
