"""Shared constants, dtype policy, pack body and FRAME codec of the
packed wire format.

The lane-aligned ``(rows, 512)`` layout is a wire contract shared with
the reference package: shard regions are padded to multiples of 8 rows
of 512 lanes, and a buffer packed here is byte-identical to one packed
by ``repro``.

The frame codec is the serialization of that buffer for the process
transports (``repro_torch.transport``), after ``repro/wireformat.py``:
a fixed 44-byte little-endian header (magic, version, message kind,
dtype, flags, worker, shard, clock, rows, payload length, aux) and the
buffer's bytes.  The bytes are a wire contract too: a frame encoded
here is byte-identical to the reference's, int8 frames included, so a
worker of either package can talk to an endpoint of the other.

A decoded payload is a CPU ``torch.Tensor`` in the frame's logical
dtype (torch has bfloat16, so no ``ml_dtypes`` is needed); the host
side of the codec is ``numpy`` + ``struct``.  Frame-level int8
quantization stays in numpy on the host, with the reference's exact
operations, so its bytes match.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import TRACE
from repro_torch.perfcount import TRANSPORT, WIRE

#: Lane width of the packed wire buffer.
WIRE_LANES = 512
#: Row multiple that shard regions pad to.
WIRE_ROWS = 8


def pack_flat(leaves: Sequence[torch.Tensor], dtype: torch.dtype,
              rows: Optional[int] = None) -> torch.Tensor:
    """Flatten + concatenate ``leaves`` into a (rows, WIRE_LANES) buffer.

    ``rows=None`` pads to the next full lane row; an explicit ``rows``
    pads/pins to that row count (a plan's 8-aligned shard region).
    """
    WIRE.packs += 1
    flats = [x.reshape(-1).to(dtype) for x in leaves]
    if len(flats) > 1:
        WIRE.leaf_concats += 1
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    target = (rows * WIRE_LANES if rows is not None
              else flat.numel() + (-flat.numel()) % WIRE_LANES)
    if target < flat.numel():
        raise ValueError(f"{flat.numel()} elements do not fit in "
                         f"{rows} x {WIRE_LANES} rows")
    if target > flat.numel():
        flat = torch.nn.functional.pad(flat, (0, target - flat.numel()))
    return flat.reshape(-1, WIRE_LANES)


def resolve_wire_dtype(dtypes: Iterable, default=None) -> Optional[object]:
    """The wire dtype for a collection of leaf dtypes.

    A uniform collection keeps its dtype on the wire (bf16 stays bf16
    bitwise); mixed collections promote to ``default`` (the caller
    passes f32).  Empty collections also yield ``default``.
    """
    dts = set(dtypes)
    return dts.pop() if len(dts) == 1 else default


# ======================================================================
# Frame codec — the process-boundary serialization of the packed buffer.
# ======================================================================

#: First bytes of every frame; rejects cross-protocol garbage cheaply.
FRAME_MAGIC = b"DSPW"
#: Bump on any incompatible header/payload change.
FRAME_VERSION = 1

#: Header layout, little-endian, 44 bytes:
#:   magic(4s) version(B) kind(B) dtype(B) flags(B)
#:   worker(i32) shard(i32) clock(i64) rows(u32) payload_len(u64) aux(f64)
HEADER = struct.Struct("<4sBBBBiiqIQd")
HEADER_SIZE = HEADER.size

# -- message kinds ------------------------------------------------------
MSG_HELLO = 1   # worker joins; reply OK carries clock=version, aux=rows
MSG_PULL = 2    # request packed params; reply OK carries the buffer
MSG_PUSH = 3    # packed gradient push; blocks until the policy releases
MSG_LOSS = 4    # record_loss(clock, aux)
MSG_BYE = 5     # worker leaves the barrier group
MSG_STOP = 6    # server-side stop reply (training over / shutdown)
MSG_OK = 7      # generic success reply
MSG_ERR = 8     # error reply; body is a utf-8 message
MSG_ECHO = 9    # payload round-trip diagnostic (health checks + tests)
MSG_PULL_DELTA = 10  # request: body = client's per-shard version vector
MSG_DELTA = 11  # reply: advanced shards' regions + fresh version vector
MSG_TRACE = 12  # worker ring-buffer flush: body = utf-8 JSON event list
MSG_SUB = 13    # replica subscription: like HELLO but takes no barrier
                # seat (a serving replica must never gate training)

_KINDS = frozenset((MSG_HELLO, MSG_PULL, MSG_PUSH, MSG_LOSS, MSG_BYE,
                    MSG_STOP, MSG_OK, MSG_ERR, MSG_ECHO,
                    MSG_PULL_DELTA, MSG_DELTA, MSG_TRACE, MSG_SUB))

#: Kinds whose body is NOT one (rows, 512) buffer: MSG_ERR carries a
#: utf-8 message, MSG_PULL_DELTA an int64 version vector, MSG_DELTA the
#: structured multi-region delta body (see ``_delta_body``), MSG_TRACE
#: a JSON-encoded drained event batch.
_STRUCTURED_KINDS = frozenset((MSG_ERR, MSG_PULL_DELTA, MSG_DELTA,
                               MSG_TRACE))

# -- flags --------------------------------------------------------------
#: Payload is int8-quantized; dequant scale travels in ``aux`` and the
#: logical (pre-quantization) dtype stays in the header dtype field.
FLAG_INT8 = 0x01
#: DELTA reply is a full-snapshot fallback (client's version vector
#: mismatched) — every non-empty shard's region is in the body.
FLAG_FULL = 0x02

_KNOWN_FLAGS = FLAG_INT8 | FLAG_FULL

# -- dtype codes --------------------------------------------------------
_DTYPES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16,
           3: torch.int8}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}
_DTYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "float16", 3: "int8"}

#: Transports size shared buffers / reject hostile lengths with this.
MAX_PAYLOAD = 1 << 31


class FrameError(ValueError):
    """Malformed / truncated / cross-version frame."""


@dataclasses.dataclass
class Frame:
    """One decoded transport message.

    ``payload`` is a CPU (rows, WIRE_LANES) tensor in the *logical*
    dtype (int8 frames are dequantized on decode); ``error`` is set for
    ``MSG_ERR`` frames instead.  A decoded payload may view the
    transport's receive buffer (shmem parses in place).
    """

    kind: int
    worker: int = -1
    shard: int = -1      # -1 = the full wire buffer (no shard routing)
    clock: int = 0
    flags: int = 0
    aux: float = 0.0
    payload: Optional[torch.Tensor] = None
    error: str = ""
    #: PULL_DELTA request / DELTA reply: per-shard version vector.
    versions: Optional[Tuple[int, ...]] = None
    #: DELTA reply: [(shard_id, (rows, 512) region), ...] for the
    #: shards that advanced past the request's version vector.
    delta: Optional[Sequence[Tuple[int, torch.Tensor]]] = None
    #: TRACE flush: raw utf-8 JSON bytes of a drained event batch.
    blob: Optional[bytes] = None


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous CPU tensor (a CUDA tensor is copied)."""
    return t.detach().cpu().contiguous()


def _wire_array(t: torch.Tensor) -> np.ndarray:
    """A numpy array over ``t``'s bytes (bf16 as int16: numpy has no
    bf16)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _raw(t: torch.Tensor) -> memoryview:
    return memoryview(_wire_array(t)).cast("B")


def _wire_code(t: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise FrameError(f"dtype {t.dtype} has no wire code")
    return code


def _check_wire(t: torch.Tensor, what: str) -> None:
    if t.ndim != 2 or t.shape[1] != WIRE_LANES:
        raise FrameError(f"{what} {tuple(t.shape)} is not a "
                         f"(rows, {WIRE_LANES}) wire buffer")


def _quantize_int8(t: torch.Tensor) -> Tuple[np.ndarray, float]:
    """Symmetric per-frame linear quantization (transport-level, no
    error feedback), in numpy on the host with the reference's exact
    operations: the input widened to f32 (exact from bf16), its largest
    magnitude over 127 as the scale, then round, clip and cast."""
    f = np.asarray(t.float().numpy(), np.float32)
    scale = float(max(np.max(np.abs(f)), 1e-12) / 127.0)
    q = np.clip(np.round(f / scale), -127, 127).astype(np.int8)
    return q, scale


def _delta_body(frame: Frame) -> Tuple[List, int, int]:
    """DELTA reply body: ``<u32 n_shards> <u32 n_entries>
    <i64 versions[n_shards]>`` then per entry ``<u32 shard> <u32 rows>``
    + the shard's (rows, 512) region bytes.  All regions share one wire
    dtype (the header dtype field); header ``rows`` is the summed
    region rows.  Returns (body parts, rows, dtype code)."""
    vers = np.asarray(frame.versions if frame.versions is not None
                      else (), "<i8")
    entries = list(frame.delta or ())
    parts = [struct.pack("<II", vers.size, len(entries)), vers.tobytes()]
    rows, code = 0, None
    for sid, region in entries:
        t = _host(region)
        _check_wire(t, "delta region")
        c = _wire_code(t)
        if code is None:
            code = c
        elif c != code:
            raise FrameError(f"mixed dtypes in delta body "
                             f"({_DTYPE_NAMES[code]}, {_DTYPE_NAMES[c]})")
        parts.append(struct.pack("<II", int(sid), t.shape[0]))
        parts.append(_raw(t))
        rows += t.shape[0]
    return parts, rows, code if code is not None else 0


def encode_frame(frame: Frame, compress: str = "none") -> bytes:
    """Frame -> header + body bytes (the length-prefixed unit every
    transport moves).  ``compress='int8'`` quantizes the payload.  The
    body is copied once, into the returned bytes."""
    if frame.kind not in _KINDS:
        raise FrameError(f"unknown message kind {frame.kind}")
    flags = frame.flags
    aux = frame.aux
    if frame.kind == MSG_ERR:
        parts, rows, code = [frame.error.encode("utf-8")], 0, 3
    elif frame.kind == MSG_PULL_DELTA:
        parts = [np.asarray(frame.versions if frame.versions is not None
                            else (), "<i8").tobytes()]
        rows, code = 0, 0
    elif frame.kind == MSG_DELTA:
        parts, rows, code = _delta_body(frame)
    elif frame.kind == MSG_TRACE:
        parts, rows, code = [frame.blob or b""], 0, 3
    elif frame.payload is None:
        parts, rows, code = [], 0, 0
    else:
        t = _host(frame.payload)
        _check_wire(t, "payload")
        rows, code = t.shape[0], _wire_code(t)
        if compress not in ("int8", "none", "", None):
            raise FrameError(f"unknown frame compression {compress!r}")
        if compress == "int8" and t.dtype != torch.int8:
            q, aux = _quantize_int8(t)
            flags |= FLAG_INT8
            parts = [memoryview(q).cast("B")]
        else:
            # already-int8 buffers ship as-is (dtype code says int8, no
            # FLAG_INT8 — nothing to dequantize on the far side)
            parts = [_raw(t)]
    body_len = sum(len(p) for p in parts)
    header = HEADER.pack(FRAME_MAGIC, FRAME_VERSION, frame.kind, code,
                         flags, frame.worker, frame.shard, frame.clock,
                         rows, body_len, aux)
    TRANSPORT.frames_tx += 1
    TRANSPORT.bytes_tx += HEADER_SIZE + body_len
    if TRACE.enabled and frame.kind != MSG_TRACE:
        TRACE.instant("frame_tx", worker=frame.worker, shard=frame.shard,
                      args={"kind": frame.kind,
                            "bytes": HEADER_SIZE + body_len})
    return b"".join([header, *parts])


def decode_header(buf: bytes) -> Tuple[Frame, int]:
    """Parse + validate the 44-byte header; returns the (payload-less)
    frame and the body length the framing layer must read next.  Every
    reject bumps ``TRANSPORT.header_rejects``."""
    if len(buf) != HEADER_SIZE:
        TRANSPORT.header_rejects += 1
        raise FrameError(f"short header: {len(buf)} of {HEADER_SIZE} bytes")
    (magic, version, kind, dtype_code, flags, worker, shard, clock,
     rows, payload_len, aux) = HEADER.unpack(buf)
    try:
        if magic != FRAME_MAGIC:
            raise FrameError(f"bad magic {magic!r}")
        if version != FRAME_VERSION:
            raise FrameError(f"frame version {version}, "
                             f"expected {FRAME_VERSION}")
        if kind not in _KINDS:
            raise FrameError(f"unknown message kind {kind}")
        if dtype_code not in _DTYPES:
            raise FrameError(f"unknown dtype code {dtype_code}")
        if flags & ~_KNOWN_FLAGS:
            raise FrameError(f"unknown flags 0x{flags:02x}")
        if payload_len > MAX_PAYLOAD:
            raise FrameError(f"payload length {payload_len} exceeds "
                             f"{MAX_PAYLOAD}")
        if kind == MSG_PULL_DELTA and payload_len % 8:
            raise FrameError(
                f"PULL_DELTA body of {payload_len} bytes is not an "
                "int64 version vector")
        if kind == MSG_DELTA and payload_len < 8:
            raise FrameError(
                f"DELTA body of {payload_len} bytes is shorter than "
                "its counts header")
        if kind not in _STRUCTURED_KINDS:
            itemsize = (1 if flags & FLAG_INT8
                        else _DTYPES[dtype_code].itemsize)
            if payload_len != rows * WIRE_LANES * itemsize:
                raise FrameError(
                    f"payload length {payload_len} does not match "
                    f"{rows} x {WIRE_LANES} rows of "
                    f"{_DTYPE_NAMES[dtype_code]}"
                    f"{' (int8 on the wire)' if flags & FLAG_INT8 else ''}")
    except FrameError:
        TRANSPORT.header_rejects += 1
        raise
    frame = Frame(kind=kind, worker=worker, shard=shard, clock=clock,
                  flags=flags, aux=aux)
    frame._dtype = _DTYPES[dtype_code]  # type: ignore[attr-defined]
    frame._rows = rows                  # type: ignore[attr-defined]
    return frame, payload_len


def _writable(body) -> memoryview:
    """``body`` as a writable buffer: ``torch.frombuffer`` views a
    writable one in place (a shmem slot, a tcp receive buffer) and would
    warn on a read-only one, which is copied once here instead."""
    view = memoryview(body)
    return memoryview(bytearray(view)) if view.readonly else view


def decode_body(frame: Frame, body) -> Frame:
    """Attach the body to a ``decode_header`` frame.

    ``body`` may be any buffer; a writable one (bytearray, a shared-
    memory view) is parsed in place, with no copy for uncompressed
    frames; int8 frames are dequantized into the logical dtype here."""
    TRANSPORT.frames_rx += 1
    TRANSPORT.bytes_rx += HEADER_SIZE + len(body)
    if TRACE.enabled and frame.kind != MSG_TRACE:
        TRACE.instant("frame_rx", worker=frame.worker, shard=frame.shard,
                      args={"kind": frame.kind,
                            "bytes": HEADER_SIZE + len(body)})
    if frame.kind == MSG_ERR:
        frame.error = bytes(body).decode("utf-8", "replace")
        return frame
    if frame.kind == MSG_TRACE:
        frame.blob = bytes(body)
        return frame
    if frame.kind == MSG_PULL_DELTA:
        frame.versions = tuple(int(v) for v in np.frombuffer(body, "<i8"))
        return frame
    if frame.kind == MSG_DELTA:
        return _decode_delta_body(frame, body)
    rows = frame._rows  # type: ignore[attr-defined]
    if rows == 0:
        return frame
    dtype = frame._dtype  # type: ignore[attr-defined]
    if frame.flags & FLAG_INT8:
        q = np.frombuffer(body, np.int8).reshape(rows, WIRE_LANES)
        frame.payload = torch.from_numpy(
            q.astype(np.float32) * np.float32(frame.aux)).to(dtype)
    else:
        frame.payload = torch.frombuffer(
            _writable(body), dtype=dtype).view(rows, WIRE_LANES)
    return frame


def _decode_delta_body(frame: Frame, body) -> Frame:
    """Parse a DELTA body (see ``_delta_body``).  Regions view ``body``
    in place, valid as long as the underlying buffer (the same contract
    as an uncompressed pull payload)."""
    view = _writable(body)
    if len(view) < 8:
        raise FrameError("truncated DELTA body: no counts header")
    n_shards, n_entries = struct.unpack_from("<II", view, 0)
    off = 8
    vec_bytes = n_shards * 8
    if len(view) < off + vec_bytes:
        raise FrameError(f"truncated DELTA body: version vector of "
                         f"{n_shards} entries does not fit")
    frame.versions = tuple(
        int(v) for v in np.frombuffer(view[off:off + vec_bytes], "<i8"))
    off += vec_bytes
    dtype = frame._dtype  # type: ignore[attr-defined]
    entries = []
    total_rows = 0
    for _ in range(n_entries):
        if len(view) < off + 8:
            raise FrameError("truncated DELTA body: entry header")
        sid, rows = struct.unpack_from("<II", view, off)
        off += 8
        nbytes = rows * WIRE_LANES * dtype.itemsize
        if len(view) < off + nbytes:
            raise FrameError(f"truncated DELTA body: shard {sid} region "
                             f"of {rows} rows does not fit")
        region = (torch.frombuffer(view, dtype=dtype, count=nbytes
                                   // dtype.itemsize, offset=off)
                  if nbytes else torch.empty(0, dtype=dtype))
        entries.append((int(sid), region.view(rows, WIRE_LANES)))
        off += nbytes
        total_rows += rows
    if off != len(view):
        raise FrameError(f"DELTA body has {len(view) - off} trailing "
                         "bytes")
    if total_rows != frame._rows:  # type: ignore[attr-defined]
        raise FrameError(
            f"DELTA body rows {total_rows} do not match header rows "
            f"{frame._rows}")  # type: ignore[attr-defined]
    frame.delta = entries
    return frame


def decode_frame(data) -> Frame:
    """One-shot decode of a contiguous header+body buffer."""
    view = memoryview(data)
    frame, payload_len = decode_header(bytes(view[:HEADER_SIZE]))
    if len(view) - HEADER_SIZE != payload_len:
        TRANSPORT.header_rejects += 1
        raise FrameError(f"truncated frame: {len(view) - HEADER_SIZE} of "
                         f"{payload_len} payload bytes")
    return decode_body(frame, view[HEADER_SIZE:])
