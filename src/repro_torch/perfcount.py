"""Hot-path event counters: the packed wire and the kernel launches.

``WIRE`` counts pytree <-> wire crossings and version-delta pull bytes,
as in the reference package; the packed-wire contract ("a packed push
does no per-leaf work on the server") is asserted on these counts, not
on timings.

``LAUNCHES`` counts hand-written kernel launches, one field per kernel.
A kernel wrapper bumps its field exactly where it launches its kernel on
the card, and nowhere else: a call that takes the plain version (a CPU
tensor) leaves it untouched.  A run that resets the counts, drives the
main path and reads them back shows which kernels the path really went
through (``chip_smoke.py`` does exactly that).

Counters are plain ints bumped under the GIL — cheap enough to stay on
permanently; multi-threaded runs read them after joining the threads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class _CounterBase:
    """Shared reset/snapshot/delta over a dataclass of int fields."""

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def snapshot(self) -> Dict[str, int]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def delta(self, before: Dict[str, int]) -> Dict[str, int]:
        return {k: v - before.get(k, 0) for k, v in self.snapshot().items()}


@dataclasses.dataclass
class HotPathCounters(_CounterBase):
    #: per-leaf concatenations (an ``unpack`` of a leaf split across
    #: shards, ``pack_flat`` over several pieces)
    leaf_concats: int = 0
    #: pytree -> wire and wire -> pytree crossings
    packs: int = 0
    unpacks: int = 0
    #: bytes shipped by version-delta pulls (changed regions only; a
    #: full-snapshot fallback counts its full size)
    delta_bytes_tx: int = 0
    #: bytes a full snapshot would have shipped minus what the delta
    #: shipped
    full_pull_bytes_avoided: int = 0
    #: kernel launches a coalesced flush of K contributions saved over
    #: K separate applies (K - 1 per flush)
    apply_launches_saved: int = 0


@dataclasses.dataclass
class KernelLaunches(_CounterBase):
    fused_update: int = 0
    fused_update_batched: int = 0
    fused_int8_ef: int = 0
    fused_topk_ef: int = 0
    rmsnorm: int = 0
    residual_rmsnorm: int = 0
    flash_attention_fwd: int = 0
    ssm_scan: int = 0


#: Process-global counters — reset + snapshot around the region of
#: interest.
WIRE = HotPathCounters()
LAUNCHES = KernelLaunches()


def snapshot_all() -> Dict[str, Dict[str, int]]:
    """One combined view of every process-global counter group."""
    return {"wire": WIRE.snapshot(), "launches": LAUNCHES.snapshot()}
