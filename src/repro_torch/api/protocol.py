"""``ParameterServerProtocol`` — the one server surface every engine,
endpoint and worker codes against.

``ParameterServer`` (monolithic) and ``ShardedParameterServer`` both
inherit this base, so the transport endpoint, the PS workers and the
process pool never branch on the server's concrete type: every server
answers the full push/pull surface —

    pull / push                tree wire format (per-leaf pytrees)
    pull_packed / push_packed  packed (rows, 512) wire format
    pull_delta                 version-delta pull (changed shards only)
    pull_packed_shard /        per-shard packed regions (the unit the
    push_packed_shard          transport endpoints route on)
    snapshot / shutdown        lifecycle
    add_worker / remove_worker elastic membership
    record_loss / metrics      accounting

The per-shard variants have a default single-shard implementation
(shard 0 == the whole store), so the monolithic server is routable
behind a per-shard endpoint without any adapter.  ``packed_wire``
reports whether the packed surface is live for this instance (it
depends on the constructor's apply mode, not the class).

Import-light on purpose: this module must be importable before torch and
without triggering the rest of ``repro_torch.api`` machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

Params = Any
Grads = Any


@dataclasses.dataclass(frozen=True)
class DeltaPull:
    """Result of a version-delta pull: only the shards that advanced.

    ``versions`` is the server's per-shard version vector at snapshot
    time (the client stores it and sends it back on its next
    ``pull_delta``); ``shards``/``regions`` are the parallel lists of
    advanced shard ids and their packed ``(rows, 512)`` regions
    (torch tensors server-side, numpy host buffers on a transport
    client).  ``full`` marks a full-snapshot fallback — the client's
    version vector did not match the server's shard arity (or ran
    ahead of it), so every non-empty shard's region is included and
    the client should treat the patch as a complete rebuild.
    ``epoch`` is the server's live-reshard epoch at snapshot time: a
    change from the client's last-seen epoch means the shard arity
    (and wire layout) moved under it — the reply is already a full
    snapshot in the NEW layout, and the client must rebuild its
    plan/buffers before patching.
    """

    versions: Tuple[int, ...]
    shards: Tuple[int, ...] = ()
    regions: Tuple[Any, ...] = ()
    full: bool = False
    epoch: int = 0

    @property
    def empty(self) -> bool:
        return not self.shards


class ParameterServerProtocol:
    """Base class + default impls for the unified server surface.

    Subclasses must provide ``pull``, ``push``, ``stop``,
    ``record_loss``, ``add_worker``, ``remove_worker`` and a
    ``version`` counter; packed-mode subclasses additionally provide
    ``pull_packed``/``push_packed`` (the per-shard defaults below then
    come for free on single-shard servers).
    """

    #: concrete servers set this in __init__ ("tree"/"packed"/"fused")
    apply_mode: str = "tree"
    stopped: bool = False
    version: int = 0

    # ---------------------------------------------------- capabilities
    @property
    def packed_wire(self) -> bool:
        """Does this instance hold a resident packed store (i.e. are
        ``*_packed`` calls valid)?  The transport layer speaks packed
        frames only and checks this instead of the concrete type."""
        return self.apply_mode in ("packed", "fused")

    #: plain attribute (not a property) so sharded subclasses can
    #: assign their arity in __init__
    n_shards: int = 1

    def shard_versions(self) -> List[int]:
        return [self.version]

    # ------------------------------------------------------- tree wire
    def pull(self, worker: int) -> Params:
        raise NotImplementedError

    def push(self, worker: int, grads: Grads) -> None:
        raise NotImplementedError

    # ----------------------------------------------------- packed wire
    def pull_packed(self, worker: int = -1):
        raise NotImplementedError(
            f"{type(self).__name__}(apply_mode={self.apply_mode!r}) has "
            "no resident packed store")

    def push_packed(self, worker: int, wire) -> None:
        raise NotImplementedError(
            f"{type(self).__name__}(apply_mode={self.apply_mode!r}) has "
            "no resident packed store")

    def pull_delta(self, worker: int,
                   versions: Optional[Sequence[int]]) -> DeltaPull:
        """Version-delta pull: the shards that advanced past the
        client's ``versions`` vector, or a full-snapshot fallback on a
        vector mismatch.  Packed-mode servers override this; the base
        raises like the other packed calls."""
        raise NotImplementedError(
            f"{type(self).__name__}(apply_mode={self.apply_mode!r}) has "
            "no resident packed store")

    # ------------------------------------- per-shard (default: 1 shard)
    def pull_packed_shard(self, shard: int, worker: int = -1):
        self._only_shard(shard)
        return self.pull_packed(worker)

    def push_packed_shard(self, worker: int, shard: int, buf) -> None:
        self._only_shard(shard)
        self.push_packed(worker, buf)

    def _only_shard(self, shard: int) -> None:
        if shard != 0:
            raise ValueError(
                f"{type(self).__name__} is single-shard: shard must be "
                f"0, got {shard}")

    # ------------------------------------------------------- lifecycle
    def stop(self) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        """Release every gated worker and refuse new work.  Alias of
        ``stop`` today; sessions call this so servers can grow teardown
        steps without touching call sites."""
        self.stop()

    def snapshot(self) -> Params:
        """A consistent pytree snapshot of the global weights."""
        return self.pull(-1)

    @property
    def params(self) -> Params:
        return self.snapshot()

    # ------------------------------------------------------ membership
    def add_worker(self, worker: int) -> None:
        raise NotImplementedError

    def remove_worker(self, worker: int) -> None:
        raise NotImplementedError

    # ------------------------------------------------------ accounting
    def record_loss(self, step: int, loss: float) -> None:
        raise NotImplementedError

    def staleness_profile(self) -> Dict:
        raise NotImplementedError
