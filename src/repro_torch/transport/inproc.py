"""In-process loopback transport.

The full frame path — encode, header validation, endpoint dispatch,
reply encode, decode — with no OS transport underneath.  Two jobs:

  * the uniform-API backend for the existing threaded path (a thread's
    "connection" is a direct call into the endpoint), and
  * the serialization-cost baseline in the throughput benchmark: the
    delta between ``inproc`` and ``tcp``/``shmem`` is the OS transport,
    the delta between ``inproc`` and direct ``push_packed`` calls is
    the codec.

Addresses are process-local (a token into a module registry): handing
one to a spawned worker is a usage error and raises on ``connect``.

Counterpart of ``repro/transport/inproc.py``.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Tuple

from repro_torch.transport.base import (
    Channel,
    PSTransportClient,
    Transport,
    TransportClosed,
)
from repro_torch.wireformat import Frame, decode_frame

_REGISTRY: Dict[int, "InprocTransport"] = {}
_TOKENS = itertools.count(1)


class InprocChannel(Channel):
    def __init__(self, transport: "InprocTransport"):
        self._transport = transport

    def request(self, data: bytes) -> Frame:
        endpoint = self._transport._endpoint
        if endpoint is None or self._transport._stopping:
            raise TransportClosed("inproc transport is shut down")
        return decode_frame(endpoint.handle_bytes(data))

    def close(self) -> None:
        pass


class InprocTransport(Transport):
    name = "inproc"

    def __init__(self) -> None:
        self._endpoint = None
        self._token = next(_TOKENS)
        self._pid = os.getpid()
        self._stopping = False

    def serve(self, endpoint) -> None:
        self._endpoint = endpoint
        _REGISTRY[self._token] = self

    def address(self) -> Tuple:
        if self._endpoint is None:
            raise RuntimeError("serve() first")
        return ("inproc", self._pid, self._token)

    def connect(self, worker_id: int, *,
                compress: str = "none") -> PSTransportClient:
        return PSTransportClient(InprocChannel(self), worker_id,
                                 compress=compress)

    def shutdown(self) -> None:
        self._stopping = True
        _REGISTRY.pop(self._token, None)


def connect(address: Tuple, worker_id: int, *,
            compress: str = "none") -> PSTransportClient:
    kind, pid, token = address
    if kind != "inproc":
        raise ValueError(f"not an inproc address: {address!r}")
    if pid != os.getpid():
        raise TransportClosed(
            "inproc addresses are process-local; spawned workers need "
            "tcp or shmem")
    transport = _REGISTRY.get(token)
    if transport is None:
        raise TransportClosed(f"no live inproc transport {token}")
    return transport.connect(worker_id, compress=compress)


__all__ = ["InprocTransport", "InprocChannel", "connect"]
