"""Shard planning: partition a parameter tree across S server shards.

A ``ShardPlan`` is a static, deterministic description of which pieces of
which tree leaves live on which shard — the same plan, byte for byte, as
the reference package builds for the same shapes:

  * the tree is flattened once in ``jax.tree_util`` order (dict keys
    sorted, ``repro_torch.tree``); that order is the canonical leaf
    numbering,
  * every leaf is cut into one or more ``LeafSlice``s: the whole leaf,
    or a contiguous ``[start, stop)`` range along its **leading axis**
    (only leaves bigger than the per-shard target are split; scalars and
    single-row leaves never are),
  * slices are bin-packed into ``n_shards`` size-balanced ``Shard``s:
    largest piece first, always into the currently lightest shard (ties
    toward the lowest index) — the LPT heuristic, ≤ 4/3·OPT imbalance,
  * within a shard, slices are sorted by ``(leaf, start)``.

Packed wire format
------------------
The whole tree lives in ONE ``(rows, 512)`` buffer laid out shard by
shard: each shard's slices contiguous in ``(leaf, start)`` order, each
shard region zero-padded to a multiple of 8 rows.  ``pack`` copies every
slice into its place (one ``copy_`` per slice, no index gather);
``unpack`` returns **views** into the wire buffer for every leaf that
lies whole in one shard, and a concatenation only for a leaf that was
split across shards.  ``shard_wire`` is a row-slice view.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.perfcount import WIRE
from repro_torch.wireformat import (WIRE_LANES, WIRE_ROWS, pack_flat,
                                    resolve_wire_dtype)

Tree = Any


@dataclasses.dataclass(frozen=True)
class LeafSlice:
    """One contiguous piece of one tree leaf."""

    leaf: int        # index into the canonical flattened-leaf list
    start: int       # leading-axis start row (0 for whole leaves)
    stop: int        # leading-axis stop row (shape[0], or 1 for scalars)
    whole: bool      # the entire leaf (no slicing needed on the wire)
    size: int        # element count of the piece


@dataclasses.dataclass(frozen=True)
class Shard:
    index: int
    slices: Tuple[LeafSlice, ...]
    size: int        # total element count


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Precomputed flat offsets of a plan's packed wire format (one per
    wire dtype, cached on the plan)."""

    dtype: torch.dtype                        # wire buffer dtype
    total_elems: int                          # real elements (no padding)
    total_rows: int                           # wire buffer rows (512 lanes)
    shard_row_start: Tuple[int, ...]          # first wire row of each shard
    shard_rows: Tuple[int, ...]               # rows per shard (8-aligned)
    slice_offsets: Tuple[Tuple[int, ...], ...]  # per shard: element offset
                                              # of each slice in the shard's
                                              # flat region


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    n_shards: int
    treedef: Any
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    shards: Tuple[Shard, ...]
    leaf_dtypes: Tuple[torch.dtype, ...] = ()
    _wire_layouts: Dict[Any, WireLayout] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    # -- tree pieces -------------------------------------------------------
    def _leaves(self, tree: Tree) -> List[torch.Tensor]:
        leaves = tree_util.leaves(tree)
        if len(leaves) != len(self.leaf_shapes):
            raise ValueError(
                f"tree has {len(leaves)} leaves, plan was built for "
                f"{len(self.leaf_shapes)}")
        return leaves

    def split(self, tree: Tree) -> List[List[torch.Tensor]]:
        """Cut ``tree`` into per-shard piece lists (views)."""
        leaves = self._leaves(tree)
        return [[leaves[sl.leaf] if sl.whole
                 else leaves[sl.leaf][sl.start:sl.stop]
                 for sl in shard.slices] for shard in self.shards]

    def assemble(self, pieces_per_shard: Sequence[Sequence[torch.Tensor]]
                 ) -> Tree:
        """Inverse of ``split``: rebuild the tree from shard pieces (a
        leaf split across shards is concatenated)."""
        parts: Dict[int, Dict[int, torch.Tensor]] = {}
        for shard, pieces in zip(self.shards, pieces_per_shard):
            if len(pieces) != len(shard.slices):
                raise ValueError(
                    f"shard {shard.index}: got {len(pieces)} pieces, "
                    f"plan has {len(shard.slices)} slices")
            for sl, piece in zip(shard.slices, pieces):
                parts.setdefault(sl.leaf, {})[sl.start] = piece
        leaves = []
        for i in range(len(self.leaf_shapes)):
            by_start = parts.get(i)
            if by_start is None:
                raise ValueError(f"leaf {i} missing from shard pieces")
            if len(by_start) == 1:
                (leaf,) = by_start.values()
            else:
                WIRE.leaf_concats += 1
                leaf = torch.cat([by_start[s] for s in sorted(by_start)])
            leaves.append(leaf)
        return tree_util.unflatten(self.treedef, leaves)

    def piece_shape(self, sl: LeafSlice) -> Tuple[int, ...]:
        """Tensor shape of one slice as it travels on the wire."""
        shape = self.leaf_shapes[sl.leaf]
        if sl.whole:
            return shape
        return (sl.stop - sl.start,) + shape[1:]

    # -- packed wire format --------------------------------------------------
    def _resolve_wire_dtype(self, dtype) -> torch.dtype:
        """None -> a uniform tree keeps its dtype on the wire, mixed
        trees promote to f32."""
        if dtype is not None:
            return dtype
        return resolve_wire_dtype(self.leaf_dtypes, default=torch.float32)

    def wire_layout(self, dtype=None) -> WireLayout:
        """The (cached) packed layout for one wire dtype."""
        wdt = self._resolve_wire_dtype(dtype)
        layout = self._wire_layouts.get(wdt)
        if layout is None:
            layout = self._build_wire_layout(wdt)
            self._wire_layouts[wdt] = layout
        return layout

    def _build_wire_layout(self, wdt: torch.dtype) -> WireLayout:
        def shard_region_rows(n_elems: int) -> int:
            if n_elems == 0:
                return 0
            raw = -(-n_elems // WIRE_LANES)              # ceil to full lanes
            return -(-raw // WIRE_ROWS) * WIRE_ROWS      # ceil to 8-row tiles

        rows = tuple(shard_region_rows(s.size) for s in self.shards)
        row_start, acc = [], 0
        for r in rows:
            row_start.append(acc)
            acc += r
        slice_offsets = []
        for shard in self.shards:
            offs, off = [], 0
            for sl in shard.slices:
                offs.append(off)
                off += sl.size
            slice_offsets.append(tuple(offs))
        total = sum(math.prod(s) if s else 1 for s in self.leaf_shapes)
        return WireLayout(dtype=wdt, total_elems=total, total_rows=acc,
                          shard_row_start=tuple(row_start), shard_rows=rows,
                          slice_offsets=tuple(slice_offsets))

    def _wire_spans(self, layout: WireLayout):
        """(shard, slice, flat wire offset) for every slice."""
        for j, shard in enumerate(self.shards):
            base = layout.shard_row_start[j] * WIRE_LANES
            for sl, off in zip(shard.slices, layout.slice_offsets[j]):
                yield j, sl, base + off

    def _row_elems(self, leaf: int) -> int:
        shape = self.leaf_shapes[leaf]
        return math.prod(shape[1:]) if len(shape) > 1 else 1

    def pack(self, tree: Tree, dtype=None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tree -> one (total_rows, 512) wire buffer.

        Every slice is copied into its wire position (casting to the
        wire dtype) and every shard's padding is zeroed, so the result is
        byte-identical to the reference package's ``pack``.  ``out``
        packs into an existing buffer of the layout's shape and dtype
        instead of allocating one.
        """
        layout = self.wire_layout(dtype)
        leaves = self._leaves(tree)
        for i, (x, shape) in enumerate(zip(leaves, self.leaf_shapes)):
            if tuple(x.shape) != shape:
                raise ValueError(f"leaf {i}: shape {tuple(x.shape)} does "
                                 f"not match plan shape {shape}")
        shape = (layout.total_rows, WIRE_LANES)
        if out is None:
            out = torch.empty(shape, dtype=layout.dtype,
                              device=leaves[0].device)
        elif (tuple(out.shape) != shape or out.dtype != layout.dtype
              or not out.is_contiguous()):
            raise ValueError(
                f"pack out= buffer {tuple(out.shape)} {out.dtype} does not "
                f"match layout {shape} {layout.dtype}")
        WIRE.packs += 1
        flat = out.view(-1)
        flats = [x.reshape(-1) for x in leaves]
        for _, sl, pos in self._wire_spans(layout):
            row = self._row_elems(sl.leaf)
            src = flats[sl.leaf][sl.start * row:sl.start * row + sl.size]
            flat[pos:pos + sl.size].copy_(src)
        for j, shard in enumerate(self.shards):
            base = layout.shard_row_start[j] * WIRE_LANES
            flat[base + shard.size:
                 base + layout.shard_rows[j] * WIRE_LANES].zero_()
        return out

    def unpack(self, wire: torch.Tensor, dtype=None) -> Tree:
        """Inverse of ``pack``.  A leaf stored whole is a VIEW into
        ``wire`` (when its dtype is the wire dtype); a leaf split across
        shards is concatenated from its pieces."""
        layout = self.wire_layout(dtype)
        if tuple(wire.shape) != (layout.total_rows, WIRE_LANES):
            raise ValueError(
                f"wire buffer {tuple(wire.shape)} does not match layout "
                f"({layout.total_rows}, {WIRE_LANES})")
        WIRE.unpacks += 1
        flat = wire.reshape(-1)
        pieces: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        for _, sl, pos in self._wire_spans(layout):
            pieces.setdefault(sl.leaf, []).append(
                (sl.start, flat[pos:pos + sl.size]))
        dtypes = self.leaf_dtypes or (torch.float32,) * len(self.leaf_shapes)
        leaves = []
        for i, (shape, dt) in enumerate(zip(self.leaf_shapes, dtypes)):
            parts = [p for _, p in sorted(pieces[i], key=lambda t: t[0])]
            if len(parts) == 1:
                leaf = parts[0]
            else:
                WIRE.leaf_concats += 1
                leaf = torch.cat(parts)
            leaves.append(leaf.view(shape).to(dt))
        return tree_util.unflatten(self.treedef, leaves)

    def shard_wire(self, wire: torch.Tensor, shard: int,
                   dtype=None) -> torch.Tensor:
        """Shard ``shard``'s (rows, 512) region — a pure row-slice view."""
        layout = self.wire_layout(dtype)
        start = layout.shard_row_start[shard]
        return wire[start:start + layout.shard_rows[shard]]

    def shard_wires(self, wire: torch.Tensor,
                    dtype=None) -> List[torch.Tensor]:
        return [self.shard_wire(wire, j, dtype) for j in range(self.n_shards)]

    def shard_pieces_from_wire(self, buf: torch.Tensor, shard: int,
                               dtype=None) -> List[torch.Tensor]:
        """One shard's piece list out of its packed region — per-slice
        views, no concatenation."""
        layout = self.wire_layout(dtype)
        WIRE.unpacks += 1
        flat = buf.reshape(-1)
        dtypes = self.leaf_dtypes or (torch.float32,) * len(self.leaf_shapes)
        return [flat[off:off + sl.size].view(self.piece_shape(sl))
                .to(dtypes[sl.leaf])
                for sl, off in zip(self.shards[shard].slices,
                                   layout.slice_offsets[shard])]

    def pack_shard_pieces(self, pieces: Sequence[torch.Tensor], shard: int,
                          dtype=None) -> torch.Tensor:
        """One shard's piece list -> its (rows, 512) packed region."""
        layout = self.wire_layout(dtype)
        rows = layout.shard_rows[shard]
        if not pieces:
            return torch.zeros((rows, WIRE_LANES), dtype=layout.dtype)
        return pack_flat(pieces, layout.dtype, rows=rows)

    def rebuild(self, n_shards: int, *,
                 split_oversized: bool = True) -> "ShardPlan":
        """The SAME tree re-planned at a new arity — metadata only.

        ``build_shard_plan`` reads nothing but ``.shape``/``.dtype``, so
        the tree is rebuilt from ``meta`` tensors: a live reshard
        re-plans without materializing parameters.  The per-shard size
        target depends on ``n_shards``, so the new plan may slice leaves
        differently — the migration map, not slice identity, relates the
        two layouts.
        """
        dtypes = self.leaf_dtypes or (torch.float32,) * len(self.leaf_shapes)
        metas = [torch.empty(s, dtype=d, device="meta")
                 for s, d in zip(self.leaf_shapes, dtypes)]
        return build_shard_plan(tree_util.unflatten(self.treedef, metas),
                                n_shards, split_oversized=split_oversized)

    # -- introspection -------------------------------------------------------
    @property
    def total_size(self) -> int:
        return sum(s.size for s in self.shards)

    def imbalance(self) -> float:
        """max shard size / mean shard size (1.0 = perfectly balanced)."""
        sizes = [s.size for s in self.shards]
        mean = sum(sizes) / len(sizes)
        return max(sizes) / mean if mean else 1.0

    def describe(self) -> str:
        lines = [f"ShardPlan: {self.n_shards} shards, "
                 f"{len(self.leaf_shapes)} leaves, "
                 f"{self.total_size:,} elements, "
                 f"imbalance {self.imbalance():.3f}"]
        for s in self.shards:
            split = sum(1 for sl in s.slices if not sl.whole)
            lines.append(f"  shard {s.index}: {s.size:,} elements in "
                         f"{len(s.slices)} pieces ({split} split)")
        return "\n".join(lines)


def _leaf_pieces(leaf_idx: int, shape: Tuple[int, ...], target: int,
                 split_oversized: bool) -> List[LeafSlice]:
    size = math.prod(shape) if shape else 1
    lead = shape[0] if shape else 1
    row = size // lead if lead else size
    can_split = (split_oversized and len(shape) >= 1 and lead > 1
                 and size > target and row > 0)
    if not can_split:
        return [LeafSlice(leaf_idx, 0, lead, whole=True, size=size)]
    rows_per_piece = max(1, target // row)
    pieces = []
    for start in range(0, lead, rows_per_piece):
        stop = min(lead, start + rows_per_piece)
        pieces.append(LeafSlice(leaf_idx, start, stop,
                                whole=False, size=(stop - start) * row))
    return pieces


def build_shard_plan(tree: Tree, n_shards: int, *,
                     split_oversized: bool = True) -> ShardPlan:
    """Greedy LPT bin-packing of tree leaves into size-balanced shards.

    Leaves need only ``.shape`` and ``.dtype``."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    leaves, treedef = tree_util.flatten(tree)
    if not leaves:
        raise ValueError("cannot shard an empty tree")
    shapes = tuple(tuple(x.shape) for x in leaves)
    total = sum(math.prod(s) if s else 1 for s in shapes)
    target = max(1, -(-total // n_shards))  # ceil

    pieces: List[LeafSlice] = []
    for i, shape in enumerate(shapes):
        pieces.extend(_leaf_pieces(i, shape, target, split_oversized))

    # Largest-first into the lightest shard; deterministic tie-breaks.
    pieces.sort(key=lambda sl: (-sl.size, sl.leaf, sl.start))
    bins: List[List[LeafSlice]] = [[] for _ in range(n_shards)]
    sizes = [0] * n_shards
    for sl in pieces:
        j = min(range(n_shards), key=lambda k: (sizes[k], k))
        bins[j].append(sl)
        sizes[j] += sl.size

    shards = tuple(
        Shard(index=j,
              slices=tuple(sorted(bins[j], key=lambda sl: (sl.leaf, sl.start))),
              size=sizes[j])
        for j in range(n_shards))
    return ShardPlan(n_shards=n_shards, treedef=treedef,
                     leaf_shapes=shapes, shards=shards,
                     leaf_dtypes=tuple(x.dtype for x in leaves))
