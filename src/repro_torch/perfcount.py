"""Hot-path event counters: the packed wire, the frames and the kernel
launches.

``WIRE`` counts pytree <-> wire crossings and version-delta pull bytes,
as in the reference package; the packed-wire contract ("a packed push
does no per-leaf work on the server") is asserted on these counts, not
on timings.  ``TRANSPORT`` counts frames and their bytes at the codec
(``repro_torch.wireformat``), as in the reference package.

``LAUNCHES`` counts hand-written kernel launches, one field per kernel.
A kernel wrapper bumps its field exactly where it launches its kernel on
the card, and nowhere else: a call that takes the plain version (a CPU
tensor) leaves it untouched.  A run that resets the counts, drives the
main path and reads them back shows which kernels the path really went
through (``chip_smoke.py`` does exactly that).

Counters are per process: a spawned worker process has its own, and
reports them in its ``WorkerResult``.

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
    #: live reshard (``repro_torch.ft.reshard``): contributions parked
    #: against a mid-migration shard, contributions replayed onto the
    #: new shards after the swap, and whole pushes translated from a
    #: stale epoch's layout; nothing is lost once
    #: ``reshard_parked == reshard_replayed`` after a migration settles
    reshard_parked: int = 0
    reshard_replayed: int = 0
    reshard_translated: int = 0


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


@dataclasses.dataclass
class TransportCounters(_CounterBase):
    """Frames and bytes at the codec's encode/decode boundary, so every
    backend (tcp, shmem, the in-memory loopback) is counted the same
    way; ``header_rejects`` counts frames refused by header validation."""

    frames_tx: int = 0
    frames_rx: int = 0
    bytes_tx: int = 0
    bytes_rx: int = 0
    header_rejects: int = 0


@dataclasses.dataclass
class MeshCounters(_CounterBase):
    """The device mesh's traffic (``repro_torch.launch.mesh``): the
    collectives launched on sub-groups of more than one rank with their
    result bytes, and the tensors that placing or gathering a block
    allocated.  A mesh whose axes all have one rank leaves every field
    at 0."""

    all_reduce: int = 0
    all_gather: int = 0
    reduce_scatter: int = 0
    broadcast: int = 0
    all_to_all: int = 0
    block_copies: int = 0
    #: the result bytes of each kind (an all-gather's gathered tensor, a
    #: reduce-scatter's block, an all-reduce's tensor, an all-to-all's
    #: received chunks), the ``S`` of the roofline's ring model
    #: (``repro_torch.roofline``)
    all_reduce_bytes: int = 0
    all_gather_bytes: int = 0
    reduce_scatter_bytes: int = 0
    broadcast_bytes: int = 0
    all_to_all_bytes: int = 0


#: Process-global counters — reset + snapshot around the region of
#: interest.
WIRE = HotPathCounters()
LAUNCHES = KernelLaunches()
TRANSPORT = TransportCounters()
MESH = MeshCounters()


def snapshot_all() -> Dict[str, Dict[str, int]]:
    """One combined view of every process-global counter group."""
    return {"wire": WIRE.snapshot(), "transport": TRANSPORT.snapshot(),
            "launches": LAUNCHES.snapshot()}
