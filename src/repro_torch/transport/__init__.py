"""Process-boundary transports for the packed wire format.

Counterpart of ``repro/transport``: a ``Transport`` ABC with ``inproc``
/ ``tcp`` / ``shmem`` backends, a ``PSServerEndpoint`` that serves
push/pull/policy-gate RPCs for both ``ParameterServer`` and
``ShardedParameterServer`` (with per-shard routing), and the
worker-side ``PSTransportClient``.  Frame layout lives in
``repro_torch.wireformat``; its bytes are the reference's, so clients
and endpoints of the two packages interoperate.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.transport.base import (
    Channel,
    PSTransportClient,
    Transport,
    TransportClosed,
)
from repro_torch.transport.endpoint import PSServerEndpoint, ShardRouter
from repro_torch.transport.inproc import InprocTransport
from repro_torch.transport.shmem import ShmemChannel, ShmemTransport
from repro_torch.transport.tcp import TcpChannel, TcpTransport

#: The transport kinds a spec can name (``transport.kind``).
BACKENDS = ("inproc", "tcp", "shmem")


def make_transport(kind: str, *, n_workers: int = 0, host: str = "127.0.0.1",
                   port: int = 0) -> Transport:
    """Construct (but do not start) one transport backend."""
    if kind == "inproc":
        return InprocTransport()
    if kind == "tcp":
        return TcpTransport(host=host, port=port)
    if kind == "shmem":
        if n_workers < 1:
            raise ValueError("shmem needs n_workers (one slot per worker)")
        return ShmemTransport(n_workers)
    raise ValueError(f"unknown transport {kind!r} (have {BACKENDS})")


def connect(address: Tuple, worker_id: int, *,
            compress: str = "none") -> PSTransportClient:
    """Reconstruct a client from a picklable transport address — the
    entry point for spawned worker processes."""
    from repro_torch.transport import inproc, shmem, tcp

    dispatch = {"inproc": inproc.connect, "tcp": tcp.connect,
                "shmem": shmem.connect}
    if not address or address[0] not in dispatch:
        raise ValueError(f"unknown transport address {address!r}")
    return dispatch[address[0]](address, worker_id, compress=compress)


__all__ = [
    "BACKENDS",
    "Channel",
    "InprocTransport",
    "PSServerEndpoint",
    "PSTransportClient",
    "ShardRouter",
    "ShmemChannel",
    "ShmemTransport",
    "TcpChannel",
    "TcpTransport",
    "Transport",
    "TransportClosed",
    "connect",
    "make_transport",
]
