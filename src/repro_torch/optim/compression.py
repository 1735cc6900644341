"""Gradient compression with error feedback.

Counterpart of ``repro/optim/compression.py``.  Two schemes, both with
error feedback so the compression bias does not accumulate (Seide et
al. / Karimireddy et al.):

  * ``int8``  — symmetric linear quantisation (4x smaller than f32, 2x
    smaller than bf16 on the wire);
  * ``topk``  — magnitude top-k sparsification (k as a fraction), dense
    mask representation: what the convergence experiments study is the
    information loss; the byte reduction is priced by
    ``wire_bytes_per_value``.

Two shapes of the same idea:

  * ``Compressor`` (tree wire): per tensor — one scale, or one top-k
    threshold, per leaf — in plain PyTorch;
  * ``PackedCompressor`` (packed wire): one pass over a shard's whole
    ``(rows, 512)`` region with one scale or threshold per ``(8, 512)``
    tile, through the Hopper kernels of ``kernels/fused_compress.py``.

Both decode what they encode: ``apply`` returns the decoded gradient and
the new f32 error state.

On a device mesh each rank compresses its blocks of the leaves
(``launch.steps.make_train_fn``), and the one scalar per leaf is still
the whole leaf's: ``apply`` takes one ``LeafReducer`` per leaf that
reduces a block's partial answers over the mesh axes splitting the leaf
(``WHOLE_LEAF``, the identity, on one device).  int8 all-reduces the
block's ``max |g + e|`` with MAX.  Top-k takes ``k`` of the whole leaf's
count and its k-th largest ``|g + e|`` by an exact radix select over
the f32 bit patterns (``kth_largest``: four rounds of 256-bin
histograms, each summed over the ranks; on one device the same select
over the whole leaf), so the kept set (``|g + e| >= threshold``, ties
kept) is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import fused_compress as fc

Tree = Any


class LeafReducer:
    """How a compressor reads its whole leaf from the block it holds:
    here the block is the whole leaf (one device).  A mesh's reducer
    (``launch.steps.block_reducers``) reduces over the axes that split
    the leaf."""

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the leaf's blocks, in place."""
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the leaf's blocks, in place."""
        return t

    def numel(self, block: torch.Tensor) -> int:
        """The whole leaf's element count."""
        return block.numel()


WHOLE_LEAF = LeafReducer()


def kth_largest(a: torch.Tensor, k: int,
                reducer: LeafReducer = WHOLE_LEAF) -> torch.Tensor:
    """The exact k-th largest value (1-based, repeats counted, as
    ``torch.topk(a, k).values[-1]``) of a non-negative f32 leaf of which
    ``a`` is a block: non-negative floats order as their int32 bit
    patterns, so four rounds, from the high byte down, histogram the
    next byte of the candidates (the elements whose higher bytes match
    the prefix found so far) into 256 bins, sum the counts over the
    blocks, and keep the bin that holds the k-th largest.  A 0-d f32
    tensor on ``a``'s device; no host sync (the bins are a fixed-size
    ``index_add_``, where ``torch.bincount`` would read the input's
    range back to the host)."""
    bits = a.reshape(-1).view(torch.int32)
    dev = bits.device
    prefix = torch.zeros((), dtype=torch.int32, device=dev)
    want = torch.full((), k, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev).expand(bits.numel())
    for shift in (24, 16, 8, 0):
        byte = torch.bitwise_and(torch.bitwise_right_shift(bits, shift), 255)
        if shift < 24:
            high = shift + 8
            off = (torch.bitwise_right_shift(bits, high)
                   != torch.bitwise_right_shift(prefix, high))
            byte = torch.where(off, 256, byte)      # the spill bin
        counts = torch.zeros(257, dtype=torch.int64, device=dev).index_add_(
            0, byte, one)[:256].contiguous()
        reducer.sum_(counts)
        # at or above bin b: the elements whose byte is at least b
        at_or_above = counts.flip(0).cumsum(0).flip(0)
        b = ((at_or_above >= want).sum() - 1).reshape(1)
        want = want - (at_or_above.gather(0, b) - counts.gather(0, b))[0]
        prefix = torch.bitwise_or(prefix,
                                  torch.bitwise_left_shift(b[0].int(), shift))
    return prefix.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    # (grads, error_state[, reducers]) -> (compressed-but-decoded grads,
    # new_error); reducers: one ``LeafReducer`` per leaf, default the
    # whole leaf's
    apply: Callable[..., Tuple[Tree, Tree]]
    init_error: Callable[[Tree], Tree]
    wire_bytes_per_value: float


def _zeros_like_f32(tree: Tree) -> Tree:
    return tree_util.tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        tree)


def _tree_apply(one: Callable) -> Callable:
    """Lift a per-tensor ``(g, e, reducer) -> (g', e')`` into a tree
    apply that returns the (decoded tree, error tree) pair."""
    def apply(grads: Tree, err: Tree,
              reducers: Optional[List[LeafReducer]] = None
              ) -> Tuple[Tree, Tree]:
        gl, treedef = tree_util.flatten(grads)
        el = tree_util.leaves(err)
        if len(gl) != len(el):
            raise ValueError(f"{len(gl)} gradient leaves, {len(el)} error "
                             "leaves")
        rs = reducers if reducers is not None else [WHOLE_LEAF] * len(gl)
        outs: List[Tuple[torch.Tensor, torch.Tensor]] = [
            one(g, e, r) for g, e, r in zip(gl, el, rs)]
        return (tree_util.unflatten(treedef, [o[0] for o in outs]),
                tree_util.unflatten(treedef, [o[1] for o in outs]))

    return apply


def int8_compressor() -> Compressor:
    def one(g: torch.Tensor, e: torch.Tensor, r: LeafReducer):
        gf = g.float() + e
        amax = r.max_(gf.abs().max().reshape(1)).clamp(min=1e-12)[0]
        # IEEE division on every device (see ``ref.fused_int8_ef_ref``)
        scale = amax / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    return Compressor("int8", _tree_apply(one), _zeros_like_f32, 1.0)


def topk_compressor(fraction: float = 0.05) -> Compressor:
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction in (0, 1]")

    def one(g: torch.Tensor, e: torch.Tensor, r: LeafReducer):
        gf = g.float() + e
        k = max(1, int(fraction * r.numel(gf)))
        thresh = kth_largest(gf.abs(), k, r)
        kept = gf * (gf.abs() >= thresh).float()
        return kept.to(g.dtype), gf - kept

    # indices (4 B) + values (2 B) per kept value, k fraction of tensor
    return Compressor(f"topk({fraction})", _tree_apply(one),
                      _zeros_like_f32, 6.0 * fraction)


@dataclasses.dataclass(frozen=True)
class PackedCompressor:
    """Wire compression over one packed ``(rows, 512)`` shard region:
    ``apply(wire_grads, wire_err) -> (decoded_grads, new_err)``, one
    kernel launch per region."""

    name: str
    apply: Callable[[Any, Any], Tuple[Any, Any]]
    wire_bytes_per_value: float


def make_packed_compressor(name: Optional[str], *,
                           fraction: float = 0.05
                           ) -> Optional[PackedCompressor]:
    """Fused wire compressor for the packed push path (None = identity)."""
    if name in ("none", "", None):
        return None
    if name == "int8":
        return PackedCompressor("int8", fc.fused_int8_ef, 1.0)
    if name == "topk":
        if not 0.0 < fraction <= 1.0:
            raise ValueError("fraction in (0, 1]")
        return PackedCompressor(
            f"topk({fraction})",
            lambda g, e: fc.fused_topk_ef(g, e, fraction=fraction),
            6.0 * fraction)
    raise ValueError(f"unknown wire compressor {name!r}")


def make_compressor(name: Optional[str], **kw) -> Compressor:
    if name in ("none", "", None):
        # Identity, with a real grads-shaped error state so code that
        # round-trips (grads, err) works unchanged without compression.
        return Compressor("none", lambda g, e, reducers=None: (g, e),
                          _zeros_like_f32, 2.0)
    if name == "int8":
        return int8_compressor()
    if name == "topk":
        return topk_compressor(**kw)
    raise ValueError(f"unknown compressor {name!r}")
