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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import fused_compress as fc

Tree = Any


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    # (grads, error_state) -> (compressed-but-decoded grads, new_error)
    apply: Callable[[Tree, Tree], Tuple[Tree, Tree]]
    init_error: Callable[[Tree], Tree]
    wire_bytes_per_value: float


def _zeros_like_f32(tree: Tree) -> Tree:
    return tree_util.tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        tree)


def _tree_apply(one: Callable) -> Callable:
    """Lift a per-tensor ``(g, e) -> (g', e')`` into a tree apply that
    returns the (decoded tree, error tree) pair."""
    def apply(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
        gl, treedef = tree_util.flatten(grads)
        el = tree_util.leaves(err)
        if len(gl) != len(el):
            raise ValueError(f"{len(gl)} gradient leaves, {len(el)} error "
                             "leaves")
        outs: List[Tuple[torch.Tensor, torch.Tensor]] = [
            one(g, e) for g, e in zip(gl, el)]
        return (tree_util.unflatten(treedef, [o[0] for o in outs]),
                tree_util.unflatten(treedef, [o[1] for o in outs]))

    return apply


def int8_compressor() -> Compressor:
    def one(g: torch.Tensor, e: torch.Tensor):
        gf = g.float() + e
        amax = gf.abs().max().clamp(min=1e-12)
        # IEEE division on every device (see ``ref.fused_int8_ef_ref``)
        scale = amax / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    return Compressor("int8", _tree_apply(one), _zeros_like_f32, 1.0)


def topk_compressor(fraction: float = 0.05) -> Compressor:
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction in (0, 1]")

    def one(g: torch.Tensor, e: torch.Tensor):
        gf = g.float() + e
        flat = gf.reshape(-1)
        k = max(1, int(fraction * flat.numel()))
        thresh = torch.topk(flat.abs(), k).values[-1]
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
        return Compressor("none", lambda g, e: (g, e), _zeros_like_f32, 2.0)
    if name == "int8":
        return int8_compressor()
    if name == "topk":
        return topk_compressor(**kw)
    raise ValueError(f"unknown compressor {name!r}")
