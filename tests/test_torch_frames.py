"""The frame codec against the reference's: byte-identical frames.

``repro_torch.wireformat`` encodes the same bytes as ``repro.wireformat``
for every message kind and payload dtype (f32, bf16, f16, int8 buffers),
with and without frame-level int8 compression, and for the DELTA and
PULL_DELTA bodies; each package decodes the other's bytes to equal
payloads; header, length and payload-limit errors match; and the port's
codec imports without ``ml_dtypes``.
"""

from __future__ import annotations

import os
import pathlib
import struct
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import wireformat as jw
from repro.perfcount import TRANSPORT as JTRANSPORT
from repro_torch import wireformat as tw
from repro_torch.perfcount import TRANSPORT

ROOT = pathlib.Path(__file__).resolve().parents[1]

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16, "int8": np.int8}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8}


def _buffers(dtype: str, rows: int = 16, seed: int = 0):
    """The same (rows, 512) buffer as a numpy array (reference) and a
    torch tensor (port)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(rows, tw.WIRE_LANES).astype(np.float32) * 3.0
    if dtype == "int8":
        a = np.clip(np.round(a * 20), -127, 127)
    n = a.astype(_NP[dtype])
    t = torch.from_numpy(a).to(_TORCH[dtype])
    return n, t


def _tbytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


PAYLOAD_KINDS = [tw.MSG_HELLO, tw.MSG_PULL, tw.MSG_PUSH, tw.MSG_LOSS,
                 tw.MSG_BYE, tw.MSG_STOP, tw.MSG_OK, tw.MSG_ECHO, tw.MSG_SUB]


def test_constants_match_the_reference():
    assert tw.HEADER.format == jw.HEADER.format
    assert tw.HEADER_SIZE == jw.HEADER_SIZE == 44
    assert tw.FRAME_MAGIC == jw.FRAME_MAGIC
    assert tw.FRAME_VERSION == jw.FRAME_VERSION
    assert tw.MAX_PAYLOAD == jw.MAX_PAYLOAD == 1 << 31
    assert (tw.FLAG_INT8, tw.FLAG_FULL) == (jw.FLAG_INT8, jw.FLAG_FULL)
    for name in ("HELLO", "PULL", "PUSH", "LOSS", "BYE", "STOP", "OK",
                 "ERR", "ECHO", "PULL_DELTA", "DELTA", "TRACE", "SUB"):
        assert getattr(tw, f"MSG_{name}") == getattr(jw, f"MSG_{name}")


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
@pytest.mark.parametrize("kind", PAYLOAD_KINDS)
def test_payload_frames_are_byte_identical(kind, dtype, compress):
    n, t = _buffers(dtype, seed=kind)
    fields = dict(kind=kind, worker=5, shard=2, clock=1 << 40, aux=0.25)
    ref = jw.encode_frame(jw.Frame(payload=n, **fields), compress)
    got = tw.encode_frame(tw.Frame(payload=t, **fields), compress)
    assert got == ref
    # each package decodes the other's bytes to the same payload
    mine, theirs = tw.decode_frame(ref), jw.decode_frame(got)
    assert mine.payload.dtype == _TORCH[dtype]
    assert _tbytes(mine.payload) == np.ascontiguousarray(
        theirs.payload).tobytes()
    for f in ("kind", "worker", "shard", "clock", "flags", "aux"):
        assert getattr(mine, f) == getattr(theirs, f)


@pytest.mark.parametrize("frame", [
    dict(kind=jw.MSG_ERR, error="kaboom ünïcode"),
    dict(kind=jw.MSG_TRACE, worker=3, blob=b'[{"name":"push"}]'),
    dict(kind=jw.MSG_PULL_DELTA, worker=1, versions=(3, -1, 7, 0)),
    dict(kind=jw.MSG_PULL_DELTA, worker=1, versions=()),
    dict(kind=jw.MSG_HELLO, worker=2),
    dict(kind=jw.MSG_LOSS, worker=2, clock=9, aux=2.718),
], ids=["err", "trace", "pull_delta", "pull_delta_empty", "hello", "loss"])
def test_structured_and_empty_frames_are_byte_identical(frame):
    ref = jw.encode_frame(jw.Frame(**frame))
    assert tw.encode_frame(tw.Frame(**frame)) == ref
    mine = tw.decode_frame(ref)
    theirs = jw.decode_frame(ref)
    assert (mine.error, mine.blob, mine.versions, mine.payload) == (
        theirs.error, theirs.blob, theirs.versions, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [False, True])
def test_delta_frames_are_byte_identical(dtype, full):
    n0, t0 = _buffers(dtype, rows=8, seed=1)
    n1, t1 = _buffers(dtype, rows=24, seed=2)
    head = dict(kind=jw.MSG_DELTA, worker=4, clock=12, shard=0,
                flags=jw.FLAG_FULL if full else 0, versions=(5, 3, 9))
    ref = jw.encode_frame(jw.Frame(delta=[(0, n0), (2, n1)], **head))
    got = tw.encode_frame(tw.Frame(delta=[(0, t0), (2, t1)], **head))
    assert got == ref
    mine = tw.decode_frame(ref)
    assert mine.versions == (5, 3, 9) and mine.flags == head["flags"]
    assert [s for s, _ in mine.delta] == [0, 2]
    assert _tbytes(mine.delta[0][1]) == n0.tobytes()
    assert _tbytes(mine.delta[1][1]) == n1.tobytes()
    # an empty delta (nothing advanced) too
    empty = dict(head, versions=(5, 3, 9))
    assert tw.encode_frame(tw.Frame(delta=[], **empty)) == \
        jw.encode_frame(jw.Frame(delta=[], **empty))


def test_int8_of_bf16_matches_the_reference_scale_and_codes():
    """Frame-level int8 is quantized in numpy on the host with the
    reference's operations, so scale and codes are bitwise the
    reference's, and the dequantized bf16 rounds the same way."""
    n, t = _buffers("bfloat16", rows=64, seed=11)
    ref = jw.encode_frame(jw.Frame(kind=jw.MSG_PUSH, payload=n), "int8")
    got = tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=t), "int8")
    assert got == ref
    assert len(got) - tw.HEADER_SIZE == 64 * tw.WIRE_LANES
    back = tw.decode_frame(got).payload
    assert back.dtype == torch.bfloat16
    assert _tbytes(back) == np.ascontiguousarray(
        jw.decode_frame(ref).payload).tobytes()


def test_non_contiguous_views_encode_like_the_contiguous_tensor():
    _, t = _buffers("float32", rows=16, seed=3)
    wide = torch.cat([t, t], dim=1)[:, :tw.WIRE_LANES]
    assert not wide.is_contiguous()
    assert tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=wide)) == \
        tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=t))


def _mangles():
    return [
        lambda b: b[:20],                                 # short header
        lambda b: b"XXXX" + b[4:],                        # bad magic
        lambda b: b[:4] + bytes([99]) + b[5:],            # bad version
        lambda b: b[:5] + bytes([200]) + b[6:],           # unknown kind
        lambda b: b[:6] + bytes([77]) + b[7:],            # unknown dtype
        lambda b: b[:7] + bytes([0x80]) + b[8:],          # unknown flag
        lambda b: b[:-8],                                 # truncated body
        lambda b: _with_len(b, 12345),                    # length != rows
        lambda b: _with_len(b, jw.MAX_PAYLOAD + 1),       # over the limit
    ]


def _with_len(raw: bytes, n: int) -> bytes:
    raw = bytearray(raw)
    struct.pack_into("<Q", raw, 28, n)   # 4s B B B B i i q I -> 28..36
    return bytes(raw)


@pytest.mark.parametrize("i", range(9), ids=[
    "short", "magic", "version", "kind", "dtype", "flags", "truncated",
    "length", "limit"])
def test_header_errors_match_the_reference(i):
    mangle = _mangles()[i]
    raw = mangle(jw.encode_frame(jw.Frame(
        kind=jw.MSG_PUSH, payload=np.zeros((8, 512), np.float32))))
    with pytest.raises(jw.FrameError) as ref:
        jw.decode_frame(raw)
    before = TRANSPORT.header_rejects
    with pytest.raises(tw.FrameError) as got:
        tw.decode_frame(raw)
    assert str(got.value) == str(ref.value)
    assert TRANSPORT.header_rejects == before + 1


@pytest.mark.parametrize("body", [
    b"\x01\x00\x00\x00",                                  # no counts header
    struct.pack("<II", 3, 0) + b"\x00" * 8,              # short vector
    struct.pack("<IIq", 1, 1, 0) + struct.pack("<II", 0, 8),  # region
    struct.pack("<IIq", 1, 0, 0) + b"\x00",              # trailing bytes
], ids=["counts", "vector", "region", "trailing"])
def test_delta_body_errors_match_the_reference(body):
    header = jw.HEADER.pack(jw.FRAME_MAGIC, jw.FRAME_VERSION, jw.MSG_DELTA,
                            0, 0, 0, 0, 0, 0, len(body), 0.0)
    with pytest.raises(jw.FrameError) as ref:
        jw.decode_frame(header + body)
    with pytest.raises(tw.FrameError) as got:
        tw.decode_frame(header + body)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("payload,compress", [
    (torch.zeros(4, 100), "none"),          # not a wire buffer
    (torch.zeros(8, 512, dtype=torch.float64), "none"),   # no wire code
    (torch.zeros(8, 512), "lz4"),           # unknown compression
])
def test_encode_errors(payload, compress):
    with pytest.raises(tw.FrameError):
        tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=payload),
                        compress)
    with pytest.raises(tw.FrameError):
        tw.encode_frame(tw.Frame(kind=99))


def test_counters_count_frames_and_bytes_like_the_reference():
    n, t = _buffers("bfloat16", rows=8)
    before, jbefore = TRANSPORT.snapshot(), JTRANSPORT.snapshot()
    raw = tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=t))
    tw.decode_frame(raw)
    jw.decode_frame(jw.encode_frame(jw.Frame(kind=jw.MSG_PUSH, payload=n)))
    assert TRANSPORT.delta(before) == JTRANSPORT.delta(jbefore) == {
        "frames_tx": 1, "frames_rx": 1, "bytes_tx": len(raw),
        "bytes_rx": len(raw), "header_rejects": 0}


def test_decoded_payload_views_a_writable_receive_buffer():
    """A writable body (a tcp receive buffer, a shmem slot) is parsed in
    place; a read-only one is copied once, so the tensor never aliases
    memory it may not write."""
    _, t = _buffers("float32", rows=8)
    raw = bytearray(tw.encode_frame(tw.Frame(kind=tw.MSG_PUSH, payload=t)))
    f = tw.decode_frame(raw)
    raw[tw.HEADER_SIZE:tw.HEADER_SIZE + 4] = b"\x00\x00\x80\x7f"   # +inf
    assert f.payload[0, 0].item() == float("inf")
    g = tw.decode_frame(bytes(raw))
    assert torch.equal(g.payload, f.payload)


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None   # any import of it now fails
import torch
from repro_torch import wireformat as tw
t = torch.arange(8 * 512, dtype=torch.float32).view(8, 512).bfloat16()
for compress in ("none", "int8"):
    f = tw.decode_frame(tw.encode_frame(
        tw.Frame(kind=tw.MSG_PUSH, payload=t), compress))
    assert f.payload.dtype == torch.bfloat16
assert torch.equal(f.payload.float(), f.payload.float())
from repro_torch import transport  # noqa: F401
from repro_torch.launch import proc_pool  # noqa: F401
print("ok", "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"] is None)
"""


def test_codec_imports_and_runs_without_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok True"
