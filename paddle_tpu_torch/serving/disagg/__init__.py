"""The fleet disaggregation subsystem behind the FleetRouter API.

- ``transport``: the replica process boundary — `InprocTransport` (the
  engine object itself) and `SubprocTransport` (one OS process per
  replica, length-prefixed pickled RPC over a UNIX socketpair, heartbeat
  liveness, crash detection) behind one duck-typed contract; ``tcp``
  adds `TcpTransport`, the same worker dialing back over TCP.
- ``page_service``: `FleetPrefixIndex`, the fleet-level prefix/page
  bookkeeping (chain hash -> holders), fed by the caches' register and
  evict deltas; page bytes move point to point through
  GenerationEngine.export_prefix_pages / import_prefix_pages, relayed by
  the router or fetched over ``data_plane`` and coded by ``pagecodec``.
- ``rpc``: the framing codec both transport halves speak.

The worker module (``python -m paddle_tpu_torch.serving.disagg.worker``)
is the subprocess half: one single-process GenerationEngine per replica,
on the device its GenerationConfig names (the card by default).
"""
from .page_service import FleetPrefixIndex, page_chain_hashes
from .tcp import ReplicaListener, TcpConnectError, TcpTransport
from .transport import InprocTransport, SubprocTransport, build_transport

__all__ = [
    "FleetPrefixIndex", "page_chain_hashes",
    "InprocTransport", "SubprocTransport", "build_transport",
    "TcpTransport", "ReplicaListener", "TcpConnectError",
]
