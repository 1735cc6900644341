"""Assigned input shapes and shape-only input trees for every cell.

Counterpart of ``repro/configs/shapes.py``:

  train_4k     seq 4096,    global batch 256   -> train_step
  prefill_32k  seq 32768,   global batch 32    -> serve prefill
  decode_32k   seq 32768,   global batch 128   -> serve_step (1 new token,
                                                 KV/state cache of seq_len)
  long_500k    seq 524288,  global batch 1     -> serve_step, sub-quadratic
                                                 attention archs only

``input_specs`` and ``state_sds`` return trees of ``meta`` tensors (the
reference's ``ShapeDtypeStruct``s): shapes and dtypes with no memory
behind them, at any size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import torch_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs with sub-quadratic attention (SWA / recurrent / hybrid) run
# long_500k; pure full-attention archs skip it
SUB_QUADRATIC = {"h2o-danube-1.8b", "xlstm-125m", "jamba-v0.1-52b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUB_QUADRATIC
    return True


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs as ``meta`` tensors for the given cell (token ids
    int32, as the reference declares them)."""
    b, l = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _sds((b, l), torch.int32),
               "labels": _sds((b, l), torch.int32)}
        if cfg.family == "audio":
            out = {"frames": _sds((b, l, cfg.d_model),
                                  torch_dtype(cfg.dtype)), **out}
        return out
    # decode: one new token against a cache of length seq_len
    return {"token": _sds((b, 1), torch.int32)}


def state_sds(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """Decode cache/state as ``meta`` tensors (kind == 'decode')."""
    from repro_torch.models import registry
    b, l = shape.global_batch, shape.seq_len
    fam = registry.family(cfg)
    if cfg.family == "audio":
        return fam.init_state(cfg, b, l, l, device="meta")
    return fam.init_state(cfg, b, l, device="meta")
