"""TCP transport: length-prefixed frames over a socket.

Framing is the ``repro_torch.wireformat`` header itself — read exactly 44
bytes, validate, then read exactly ``payload_len`` body bytes.  There
is no resynchronization: a frame that fails header validation (bad
magic/version/length) gets an ERR reply and the connection is closed,
because a corrupt header means the byte stream's framing can no longer
be trusted.

One server thread per connection: a worker blocked in the sync-policy
gate parks its own thread, exactly like the threaded in-process
workers.  A connection that dies after HELLO without BYE (killed
worker, broken pipe mid-push) is reported to
``endpoint.on_disconnect`` so the barrier group drops it.

Counterpart of ``repro/transport/tcp.py``.  A frame body is received
into one preallocated ``bytearray`` (``recv_into``), which the codec
views in place.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional, Tuple

from repro_torch.ft.backoff import CONNECT_POLICY, retry
from repro_torch.transport.base import (
    Channel,
    PSTransportClient,
    Transport,
    TransportClosed,
)
from repro_torch.wireformat import (
    HEADER_SIZE,
    MSG_ERR,
    MSG_HELLO,
    Frame,
    FrameError,
    decode_body,
    decode_header,
    encode_frame,
)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Read exactly ``n`` bytes into a new ``bytearray``.  ``None`` on
    clean EOF at a frame boundary; ``FrameError`` on EOF mid-frame (the
    short-read case)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        except OSError:
            k = 0
        if not k:
            if got == 0:
                return None
            raise FrameError(f"short read: {got} of {n} bytes")
        got += k
    return buf


class TcpTransport(Transport):
    name = "tcp"

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host, self._port = host, port
        self._endpoint = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stopping = False

    # -- server side -----------------------------------------------------
    def serve(self, endpoint) -> None:
        self._endpoint = endpoint
        self._listener = socket.create_server((self._host, self._port))
        self._port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tcp-ps-accept", daemon=True)
        self._accept_thread.start()

    def address(self) -> Tuple:
        if self._listener is None:
            raise RuntimeError("serve() first")
        return ("tcp", self._host, self._port)

    def connect(self, worker_id: int, *,
                compress: str = "none") -> PSTransportClient:
        return connect(self.address(), worker_id, compress=compress)

    def shutdown(self) -> None:
        self._stopping = True
        if self._listener is not None:
            try:
                # close() alone is not enough: the accept thread parked
                # in accept() holds a kernel reference, so the port
                # would stay in LISTEN until a connection woke it — and
                # a same-port failover rebind would see EADDRINUSE.
                # shutdown() aborts the blocked accept immediately.
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="tcp-ps-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """One worker connection: frame in, endpoint call, frame out."""
        worker: Optional[int] = None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                header = _read_exact(conn, HEADER_SIZE)
                if header is None:
                    return  # EOF at a frame boundary
                frame, payload_len = decode_header(bytes(header))
                body = _read_exact(conn, payload_len)
                if body is None:
                    raise FrameError(
                        f"short read: 0 of {payload_len} payload bytes")
                frame = decode_body(frame, body)
                if frame.kind == MSG_HELLO:
                    worker = frame.worker
                reply = self._endpoint.handle(frame)
                conn.sendall(encode_frame(reply))
        except FrameError as e:
            try:
                conn.sendall(encode_frame(Frame(kind=MSG_ERR, error=str(e))))
            except OSError:
                pass
        except OSError:
            pass  # peer vanished mid-write
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            if worker is not None and not self._stopping:
                # The connection is gone — free the worker's seat in the
                # barrier group (idempotent; a no-op after a clean BYE).
                self._endpoint.on_disconnect(worker)


class TcpChannel(Channel):
    def __init__(self, host: str, port: int):
        # no timeout: pushes block in the policy gate
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, data: bytes) -> Frame:
        try:
            self._sock.sendall(data)
            header = self._read_reply(HEADER_SIZE)
            if header is None:
                raise TransportClosed("server closed the connection")
            frame, payload_len = decode_header(bytes(header))
            body = self._read_reply(payload_len)
            if body is None:
                raise TransportClosed("server closed mid-reply")
            return decode_body(frame, body)
        except OSError as e:
            raise TransportClosed(str(e)) from e

    def _read_reply(self, n: int) -> Optional[bytearray]:
        """A reply that ends mid-frame is a server that died while
        sending it (a 2 GB pull takes seconds on the wire): the
        connection is gone, which the client's reconnect path handles,
        not a malformed frame.  (The reference raises ``FrameError``
        here, which its worker does not retry.)"""
        try:
            return _read_exact(self._sock, n)
        except FrameError as e:
            raise TransportClosed(str(e)) from e

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def connect(address: Tuple, worker_id: int, *,
            compress: str = "none") -> PSTransportClient:
    kind, host, port = address
    if kind != "tcp":
        raise ValueError(f"not a tcp address: {address!r}")
    # Bounded connect-retry: a spawned worker routinely races the
    # server's bind (and, under failover, its restart) — ECONNREFUSED
    # here means "not yet", not "never".  TcpChannel.__init__ raises
    # plain OSError, which is exactly what the policy retries on.
    factory = lambda: TcpChannel(host, port)  # noqa: E731
    channel = retry(factory, CONNECT_POLICY, seed=worker_id)
    return PSTransportClient(channel, worker_id, compress=compress,
                             channel_factory=factory)


__all__ = ["TcpTransport", "TcpChannel", "connect"]
