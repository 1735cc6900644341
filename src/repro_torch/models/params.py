"""Declarative parameter trees.

Each architecture declares its weights once as a tree (nested dicts) of
``ParamDef`` (shape + logical sharding axes + initializer).  From that
one declaration:

  * ``init_tree``  — random tensors from a ``torch.Generator``,
  * ``spec_tree``  — the ``PartitionSpec`` of every leaf under a rule
    set (size-aware: non-dividing mappings drop, see sharding.py), the
    block each rank of a mesh stores,
  * ``sds_tree``   — shapes and dtypes as ``meta`` tensors (no memory
    behind them, at any model size),
  * ``count``      — exact parameter counts.

``from_numpy_tree`` carries the reference package's parameters across:
the same nested dict, names, shapes and stacked-layer axis, so the
packed wire plan applies unchanged and both packages compute the same
thing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float = 1.0                    # stddev multiplier for 'normal'
    fan_in_dims: Tuple[int, ...] = ()     # dims whose product is fan-in
    dtype: Optional[str] = None           # override model dtype
    axes: Tuple[Optional[str], ...] = ()  # logical axis per dim (the
    #                                       reference's); () = replicated

    def __post_init__(self):
        if self.axes and len(self.shape) != len(self.axes):
            raise ValueError(f"rank mismatch {self.shape} vs {self.axes}")

    def stddev(self) -> float:
        fan_in = 1
        for d in self.fan_in_dims:
            fan_in *= self.shape[d]
        return self.scale / math.sqrt(max(1, fan_in))


def init_tree(defs: Any, generator: torch.Generator, default_dtype: str,
              device: torch.device) -> Any:
    """Random init in flatten order, one ``randn`` draw per normal leaf
    from ``generator`` (which must live on ``device``)."""
    def make(d: ParamDef) -> torch.Tensor:
        dt = torch_dtype(d.dtype or default_dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init in ("normal", "embed"):
            x = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return (x * d.stddev()).to(dt)
        raise ValueError(f"unknown init {d.init!r}")

    return tree_util.tree_map(make, defs)


def spec_tree(defs: Any, rules) -> Any:
    """Each leaf's ``PartitionSpec`` under ``rules`` (``None``: every
    leaf replicated)."""
    from repro_torch.models.sharding import PartitionSpec

    def spec(d: ParamDef):
        if rules is None:
            return PartitionSpec()
        return rules.spec(d.axes or (None,) * len(d.shape), d.shape)

    return tree_util.tree_map(spec, defs)


def sds_tree(defs: Any, default_dtype: str) -> Any:
    """Each leaf's shape and dtype as a ``meta`` tensor."""
    return tree_util.tree_map(
        lambda d: torch.empty(d.shape, device="meta",
                              dtype=torch_dtype(d.dtype or default_dtype)),
        defs)


def count(defs: Any) -> int:
    return sum(math.prod(d.shape) for d in tree_util.leaves(defs))


def from_numpy_tree(tree: Any, device, dtype: Optional[torch.dtype] = None
                    ) -> Any:
    """The reference's parameter tree (leaves converted with
    ``np.asarray``; bf16 leaves widened to f32, which is lossless) as the
    port's tree on ``device``.  ``dtype`` casts every leaf (e.g. back to
    ``torch.bfloat16``); ``None`` keeps the numpy dtype."""
    def conv(x) -> torch.Tensor:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: numpy-only type
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))   # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_util.tree_map(conv, tree)
