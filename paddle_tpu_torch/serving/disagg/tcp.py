"""TcpTransport: the replica process boundary over a real TCP socket.

The cross-host rung of the transport ladder.  Everything above the
socket is ``SubprocTransport`` verbatim — length-prefixed pickled
frames, chunked payloads, the in-flight ledger, heartbeat liveness,
RpcPolicy deadlines/retries, FaultPlan chaos wrapping — only the
channel bring-up differs:

1. ``ReplicaListener`` binds ``(spec.host or 127.0.0.1, spec.port or
   ephemeral)`` and listens (port-in-use raises the typed
   ``TcpConnectError`` immediately, not an EADDRINUSE traceback five
   frames deep).
2. The worker is spawned with ``--connect host:port`` instead of an
   inherited socketpair fd — the ONLY part of the handshake that
   assumes one host is the ``subprocess.Popen`` itself, and that seam
   (``_spawn_worker``) is exactly where a remote launcher (ssh, a
   cluster scheduler) slots in.
3. ``accept()`` waits for the dial-back under a bounded deadline,
   polling the child so a worker that dies pre-connect fails fast and
   typed instead of eating the whole accept window.

The accepted socket gets ``TCP_NODELAY`` — the protocol is many small
latency-sensitive frames (tokens, heartbeats, RPC replies) and
Nagle's algorithm would batch exactly the frames we care about.

Docs: docs/SERVING.md "Cross-host fleet".
"""
import socket
import subprocess
import sys
import time

from ..admission import ServingError
from .transport import SubprocTransport


class TcpConnectError(ServingError):
    """TCP channel bring-up failed: port in use, worker died before
    dialing back, or the accept deadline passed."""


class ReplicaListener:
    """One accept()-once listener for a replica's dial-back.

    Binding is split from accepting so the parent can learn the
    EPHEMERAL port (bind to port 0, read it back) BEFORE spawning the
    worker that must dial it."""

    def __init__(self, host="127.0.0.1", port=0, backlog=1):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # no SO_REUSEADDR on an explicit port: two replicas told to
        # share a port is a config bug that must fail loud, not a race
        # one of them silently wins
        try:
            self._sock.bind((host, int(port)))
            self._sock.listen(backlog)
        except OSError as e:
            self._sock.close()
            raise TcpConnectError(
                f"cannot listen on {host}:{port} for replica "
                f"dial-back: {e}") from e

    @property
    def address(self):
        """``(host, port)`` actually bound — the ephemeral port the
        worker must dial."""
        return self._sock.getsockname()[:2]

    def accept(self, timeout, proc=None):
        """Wait for the worker's dial-back; returns the connected
        socket.  Bounded by `timeout`, and polls `proc` so a child
        that died before connecting raises typed immediately."""
        deadline = time.monotonic() + float(timeout)
        self._sock.settimeout(0.2)
        while True:
            if proc is not None and proc.poll() is not None:
                raise TcpConnectError(
                    f"worker exited (rc={proc.returncode}) before "
                    f"dialing back to {self.address}")
            try:
                conn, _peer = self._sock.accept()
                return conn
            except socket.timeout:
                if time.monotonic() > deadline:
                    raise TcpConnectError(
                        f"no dial-back on {self.address} within "
                        f"{float(timeout):.1f}s") from None

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class TcpTransport(SubprocTransport):
    """SubprocTransport whose channel is a TCP connection the spawned
    worker dials back to — the cross-host replica path, with the
    socketpair fleet's entire failure model riding along unchanged."""

    kind = "tcp"
    CONNECT_TIMEOUT_S = 60.0

    def _spawn_worker(self, spec, env, host, port):
        """The one genuinely host-local step.  A remote launcher
        overrides this to start the worker on another machine — the
        returned object only needs poll()/kill()/wait()."""
        return subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.disagg.worker",
             "--connect", f"{host}:{port}"], env=env)

    def _open_channel(self, spec, env):
        listener = ReplicaListener(
            getattr(spec, "host", None) or "127.0.0.1",
            int(getattr(spec, "port", None) or 0))
        proc = None
        try:
            host, port = listener.address
            proc = self._spawn_worker(spec, env, host, port)
            sock = listener.accept(self.CONNECT_TIMEOUT_S, proc=proc)
        except BaseException:
            if proc is not None:
                proc.kill()
            raise
        finally:
            listener.close()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, proc


__all__ = ["TcpTransport", "ReplicaListener", "TcpConnectError"]
