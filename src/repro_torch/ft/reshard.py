"""Live resharding: migrate packed shard regions between stores.

Counterpart of ``repro/ft/reshard.py``.  A reshard takes a running
``ShardedParameterServer`` from S shards to S' without stopping
training.  It rides two invariants of the packed wire format:

  * every ``LeafSlice`` occupies a canonically contiguous element range
    (``leaf_off[leaf] + start * row_elems``), and within a shard's wire
    region slices are laid out in that same canonical order — so the
    overlap of an old slice with a new slice is one contiguous copy in
    BOTH wire layouts,
  * an apply writes new buffers and never changes one in place, so a
    reference grabbed under a shard's lock is a consistent snapshot of
    that shard.

``build_migration(old_plan, new_plan)`` intersects the two plans'
canonical partitions into a flat list of ``RegionMove``s

    RegionMove(old_shard, old_off, new_shard, new_off, size)

(element offsets into the flat view of each shard's ``(rows, 512)``
region) — the same moves, in the same order, as the reference builds.
They cover every real element exactly once (padding never moves), so
``migrate`` over the parameter and momentum buffers is a permutation:
bitwise, dtype-preserving, invertible.  It runs on the buffers' device,
one slice copy per move.  The same map translates gradients packed
under the old plan (``migrate_grads``).

The server side of the protocol (retire, copy, swap, release, replay)
is ``ShardedParameterServer.reshard``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.wireformat import WIRE_LANES


@dataclasses.dataclass(frozen=True)
class RegionMove:
    """One contiguous copy between two packed shard regions (element
    offsets into each shard's flat region; ``size`` elements)."""

    old_shard: int
    old_off: int
    new_shard: int
    new_off: int
    size: int


def _canonical_segments(plan) -> List[Tuple[int, int, int, int]]:
    """``(canon_start, size, shard, region_off)`` per slice, sorted by
    canonical position (mirrors ``ShardPlan._build_wire_layout``)."""
    sizes = [math.prod(s) if s else 1 for s in plan.leaf_shapes]
    leaf_off = [0]
    for n in sizes:
        leaf_off.append(leaf_off[-1] + n)
    segs: List[Tuple[int, int, int, int]] = []
    for j, shard in enumerate(plan.shards):
        off = 0
        for sl in shard.slices:
            shape = plan.leaf_shapes[sl.leaf]
            row_elems = math.prod(shape[1:]) if len(shape) > 1 else 1
            segs.append((leaf_off[sl.leaf] + sl.start * row_elems,
                         sl.size, j, off))
            off += sl.size
    segs.sort()
    return segs


@dataclasses.dataclass(frozen=True)
class MigrationMap:
    """The full S -> S' region-move list plus both layouts' row counts."""

    old_n_shards: int
    new_n_shards: int
    old_shard_rows: Tuple[int, ...]
    new_shard_rows: Tuple[int, ...]
    dtype: torch.dtype
    moves: Tuple[RegionMove, ...]

    def migrate(self, old_bufs: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
        """Old per-shard packed buffers -> new per-shard packed buffers,
        on the old buffers' device: one slice copy per move, padding
        zero.  Dtype-preserving, so params and momentum move bitwise."""
        olds = [b.reshape(-1) for b in old_bufs]
        device = next((b.device for b in olds), torch.device("cpu"))
        dtype = olds[0].dtype if olds else self.dtype
        news = [torch.zeros(r * WIRE_LANES, dtype=dtype, device=device)
                for r in self.new_shard_rows]
        for mv in self.moves:
            news[mv.new_shard][mv.new_off:mv.new_off + mv.size].copy_(
                olds[mv.old_shard][mv.old_off:mv.old_off + mv.size])
        return [b.view(-1, WIRE_LANES) for b in news]

    def migrate_grads(self, old_bufs: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Gradient translation is the same permutation (padding rows
        carry zero gradient in both layouts)."""
        return self.migrate(old_bufs)

    def moves_from(self, old_shard: int) -> List[RegionMove]:
        """The moves that source from one old shard — the replay unit
        for a push parked against that shard mid-migration."""
        return [mv for mv in self.moves if mv.old_shard == old_shard]

    def describe(self) -> str:
        lines = [f"MigrationMap: {self.old_n_shards} -> "
                 f"{self.new_n_shards} shards, {len(self.moves)} moves, "
                 f"{sum(m.size for m in self.moves):,} elements"]
        for mv in self.moves:
            lines.append(
                f"  shard {mv.old_shard}[{mv.old_off}:"
                f"{mv.old_off + mv.size}] -> shard {mv.new_shard}"
                f"[{mv.new_off}:{mv.new_off + mv.size}]")
        return "\n".join(lines)


def build_migration(old_plan, new_plan, dtype=None) -> MigrationMap:
    """Intersect the two plans' canonical partitions into contiguous
    region moves.  Both plans must describe the SAME tree."""
    if old_plan.leaf_shapes != new_plan.leaf_shapes:
        raise ValueError(
            "migration requires both plans to describe the same tree "
            f"({len(old_plan.leaf_shapes)} vs "
            f"{len(new_plan.leaf_shapes)} leaves / shapes differ)")
    old_layout = old_plan.wire_layout(dtype)
    new_layout = new_plan.wire_layout(dtype)
    if old_layout.dtype != new_layout.dtype:
        raise ValueError("wire dtypes differ between plans")
    old_segs = _canonical_segments(old_plan)
    new_segs = _canonical_segments(new_plan)
    moves: List[RegionMove] = []
    i = j = 0
    while i < len(old_segs) and j < len(new_segs):
        oc, osz, osh, ooff = old_segs[i]
        nc, nsz, nsh, noff = new_segs[j]
        lo = max(oc, nc)
        hi = min(oc + osz, nc + nsz)
        if hi > lo:
            moves.append(RegionMove(
                old_shard=osh, old_off=ooff + (lo - oc),
                new_shard=nsh, new_off=noff + (lo - nc),
                size=hi - lo))
        if oc + osz <= nc + nsz:
            i += 1
        if nc + nsz <= oc + osz:
            j += 1
    covered = sum(m.size for m in moves)
    if covered != old_layout.total_elems:
        raise AssertionError(
            f"migration map covers {covered} of "
            f"{old_layout.total_elems} elements — plans disagree")
    return MigrationMap(
        old_n_shards=old_plan.n_shards, new_n_shards=new_plan.n_shards,
        old_shard_rows=old_layout.shard_rows,
        new_shard_rows=new_layout.shard_rows,
        dtype=old_layout.dtype, moves=tuple(moves))


def spread_versions(total: int, n_shards: int) -> List[int]:
    """Redistribute a version SUM over a new arity: ``server.version``
    (the sum) is the run's logical clock, so it stays continuous across
    a reshard."""
    base, rem = divmod(int(total), n_shards)
    return [base + (1 if k < rem else 0) for k in range(n_shards)]


def equalized_counts(per_shard_counts: Sequence[Dict[int, int]]
                     ) -> Dict[int, int]:
    """Per-worker push counts for the new trackers: the MINIMUM across
    old shards — the clamp rule failover restore uses, for the same
    reason (a count that runs ahead on some shards could gate two
    workers against each other's barriers forever)."""
    workers: Dict[int, int] = {}
    for counts in per_shard_counts:
        for w, c in counts.items():
            c = int(c)
            workers[w] = c if w not in workers else min(workers[w], c)
    return workers


def live_reshard(server, n_shards: int) -> bool:
    """Live-migrate ``server`` to ``n_shards``; False for a same-arity
    no-op."""
    return server.reshard(n_shards)


def replay_fold(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                lr: float, beta: float, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One parked gradient segment folded into its moved segment:
    ``m' = m*beta + g*scale`` then ``p' = p - lr*m'``, in the store's
    dtype with every operation rounded — the reference's numpy fold.

    ``lr``, ``beta`` and ``scale`` are first rounded to the store dtype
    and passed as 0-d tensors of it: PyTorch would otherwise multiply a
    bf16 tensor by an unrounded Python float in f32.  No fused op, so
    each product and sum rounds as numpy's does.  Deliberately not
    ``fused_update``, whose arithmetic is f32.  Returns new tensors."""
    def scalar(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float64).to(p.dtype).to(p.device)

    seg = torch.add(torch.mul(m, scalar(beta)), torch.mul(g, scalar(scale)))
    return torch.sub(p, torch.mul(scalar(lr), seg)), seg


__all__ = [
    "MigrationMap",
    "RegionMove",
    "build_migration",
    "equalized_counts",
    "live_reshard",
    "replay_fold",
    "spread_versions",
]
