"""Shared-memory transport: per-worker request/reply slots.

Each worker owns one ``multiprocessing.shared_memory`` segment:

    offset 0        state byte (the only cross-process handshake)
    offset 8        44-byte frame header
    offset 64       frame body (lane data starts 64-byte aligned)

State machine (single-producer / single-consumer, one byte):

    0  idle             client may write a request
    1  request ready    server parses IN PLACE, handles, writes reply
    2  reply ready      client reads; the reply stays valid until the
                        client writes its NEXT request over the slot
    3  closed           server shut the segment down

The frame body is written once into the segment and parsed in place on
the server (``torch.frombuffer`` over the mapped view — no intermediate
copy before the endpoint's own copy).  Both sides poll the state byte with
a short sleep: cross-process semaphores would need handle inheritance,
while a name-only address keeps ``connect()`` trivially picklable for
spawned workers.

One server thread per slot, because a push blocks inside the
sync-policy gate and must not stall other workers' slots.

Counterpart of ``repro/transport/shmem.py``, with the same segment
layout and state machine.
"""

from __future__ import annotations

import os
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import List, Optional, Tuple

from repro_torch.transport.base import (
    Channel,
    PSTransportClient,
    Transport,
    TransportClosed,
)
from repro_torch.wireformat import (
    HEADER_SIZE,
    MSG_ERR,
    Frame,
    FrameError,
    decode_body,
    decode_header,
    encode_frame,
)

_IDLE, _REQUEST, _REPLY, _CLOSED = 0, 1, 2, 3
_HEADER_OFF = 8
_BODY_OFF = 64
_POLL_S = 0.0002
#: bytes a segment holds beyond the header and the largest body
_SLACK_BYTES = 4096
#: how long a client waits for its slot to be free before a request
_IDLE_WAIT_S = 600.0


def _attach(name: str, owner_pid: int) -> shared_memory.SharedMemory:
    """Attach without letting a foreign resource tracker unlink the
    segment: before 3.13, ``SharedMemory`` registers the name even on
    attach (bpo-39959), and an *independent* process's tracker would
    destroy the server's live segment when that process exits.

    Workers spawned via ``multiprocessing`` INHERIT the owner's tracker,
    where the attach-registration is a harmless set-add dedup — and
    unregistering there would strip the owner's own registration.  So:
    unregister only when this process is neither the owner nor a
    multiprocessing child (i.e. it runs its own tracker)."""
    shm = shared_memory.SharedMemory(name=name)
    import multiprocessing as mp

    own_tracker = (os.getpid() != owner_pid
                   and mp.parent_process() is None)
    if own_tracker:
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # tracker layout differs / already unregistered
            pass
    return shm


def _wait_state(buf, states, *, timeout: Optional[float] = None,
                stop=None) -> int:
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        s = buf[0]
        if s in states:
            return s
        if s == _CLOSED:
            return s
        if stop is not None and stop():
            return _CLOSED
        if deadline is not None and time.monotonic() > deadline:
            raise TransportClosed(f"timed out waiting for state {states}")
        time.sleep(_POLL_S)


class ShmemTransport(Transport):
    """Server side: one pre-created segment per expected worker id."""

    name = "shmem"

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._endpoint = None
        self._segments: List[shared_memory.SharedMemory] = []
        self._threads: List[threading.Thread] = []
        self._stopping = False

    def serve(self, endpoint) -> None:
        self._endpoint = endpoint
        size = (_BODY_OFF + endpoint.max_payload_bytes()
                + _SLACK_BYTES)
        prefix = f"dsspw-{os.getpid()}-{os.urandom(3).hex()}"
        for w in range(self.n_workers):
            shm = shared_memory.SharedMemory(
                create=True, size=size, name=f"{prefix}-w{w}")
            shm.buf[0] = _IDLE
            self._segments.append(shm)
            t = threading.Thread(target=self._serve_slot, args=(shm, w),
                                 name=f"shmem-ps-w{w}", daemon=True)
            t.start()
            self._threads.append(t)

    def address(self) -> Tuple:
        if not self._segments:
            raise RuntimeError("serve() first")
        return ("shmem", os.getpid(),
                tuple(s.name for s in self._segments))

    def connect(self, worker_id: int, *,
                compress: str = "none") -> PSTransportClient:
        return connect(self.address(), worker_id, compress=compress)

    def shutdown(self) -> None:
        self._stopping = True
        for shm in self._segments:
            try:
                shm.buf[0] = _CLOSED
            except (ValueError, TypeError):
                pass  # already unmapped
        for t in self._threads:
            t.join(timeout=5.0)
        # A slot thread that was gate-blocked at shutdown wakes, writes
        # its final (STOP) reply and stamps _REPLY over our _CLOSED.
        # Re-stamp after the joins so a client's NEXT request fails
        # fast instead of waiting forever on a reply no thread will
        # ever write.  (A client mid-read already passed its state
        # check; header/body bytes are untouched.)
        for shm in self._segments:
            try:
                shm.buf[0] = _CLOSED
            except (ValueError, TypeError):
                pass
        # Frame payloads are views into the mapped segment; exception
        # tracebacks can park the last of them in cyclic garbage, which
        # makes mmap.close() raise BufferError until a collection runs.
        import gc

        gc.collect()
        for shm in self._segments:
            try:
                shm.close()
            except BufferError:
                continue  # a live view pins the map; the tracker reaps it
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def _serve_slot(self, shm: shared_memory.SharedMemory,
                    slot: int) -> None:
        # NOTE: shared memory has no connection, so a killed worker is
        # invisible here (unlike tcp's EOF) — peer-death cleanup is the
        # ProcessWorkerPool's job (it reaps children and calls
        # ``endpoint.on_disconnect`` for abnormal exits).
        buf = shm.buf
        while not self._stopping:
            state = _wait_state(buf, (_REQUEST,),
                                stop=lambda: self._stopping)
            if state != _REQUEST:
                break
            try:
                frame, payload_len = decode_header(
                    bytes(buf[_HEADER_OFF:_HEADER_OFF + HEADER_SIZE]))
                if _BODY_OFF + payload_len > len(buf):
                    raise FrameError(
                        f"payload {payload_len} exceeds slot size")
                # Parse in place: no copy between the segment and the
                # server's device transfer.
                frame = decode_body(
                    frame, buf[_BODY_OFF:_BODY_OFF + payload_len])
                reply = self._endpoint.handle(frame)
            except FrameError as e:
                reply = Frame(kind=MSG_ERR, error=str(e))
            data = encode_frame(reply)
            buf[_HEADER_OFF:_HEADER_OFF + HEADER_SIZE] = data[:HEADER_SIZE]
            body = data[HEADER_SIZE:]
            if body:
                buf[_BODY_OFF:_BODY_OFF + len(body)] = body
            buf[0] = _REPLY


class ShmemChannel(Channel):
    """Client side of one slot.  Replies are parsed in place and stay
    valid until the next ``request`` on this channel (the state-machine
    contract above)."""

    def __init__(self, name: str, owner_pid: int):
        try:
            self._shm = _attach(name, owner_pid)
        except FileNotFoundError as e:
            raise TransportClosed(f"no such segment {name!r}") from e

    def request(self, data: bytes) -> Frame:
        buf = self._shm.buf
        state = _wait_state(buf, (_IDLE, _REPLY), timeout=_IDLE_WAIT_S)
        if state == _CLOSED:
            raise TransportClosed("segment closed by the server")
        if _BODY_OFF + len(data) - HEADER_SIZE > len(buf):
            raise FrameError(f"frame of {len(data)} bytes exceeds the "
                             f"{len(buf)}-byte slot")
        buf[_HEADER_OFF:_HEADER_OFF + HEADER_SIZE] = data[:HEADER_SIZE]
        body = data[HEADER_SIZE:]
        if body:
            buf[_BODY_OFF:_BODY_OFF + len(body)] = body
        buf[0] = _REQUEST
        # The push gate can block the server arbitrarily long: no timeout.
        state = _wait_state(buf, (_REPLY,))
        if state == _CLOSED:
            raise TransportClosed("segment closed by the server")
        frame, payload_len = decode_header(
            bytes(buf[_HEADER_OFF:_HEADER_OFF + HEADER_SIZE]))
        return decode_body(frame, buf[_BODY_OFF:_BODY_OFF + payload_len])

    def close(self) -> None:
        # Reply payloads are parsed in place — drop any of them still
        # sitting in cyclic garbage before unmapping (see shutdown()).
        import gc

        gc.collect()
        try:
            self._shm.close()
        except (ValueError, BufferError):
            pass


def connect(address: Tuple, worker_id: int, *,
            compress: str = "none") -> PSTransportClient:
    kind, owner_pid, names = address
    if kind != "shmem":
        raise ValueError(f"not a shmem address: {address!r}")
    if not 0 <= worker_id < len(names):
        raise ValueError(f"worker {worker_id} has no slot "
                         f"(have {len(names)})")
    return PSTransportClient(ShmemChannel(names[worker_id], owner_pid),
                             worker_id, compress=compress)


__all__ = ["ShmemTransport", "ShmemChannel", "connect"]
