"""Shared constants, dtype policy and pack body of the packed wire format.

The lane-aligned ``(rows, 512)`` layout is a wire contract shared with
the reference package: shard regions are padded to multiples of 8 rows
of 512 lanes, and a buffer packed here is byte-identical to one packed
by ``repro``.  The frame codec of the process transports is not part of
this module yet (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from repro_torch.perfcount import WIRE

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
