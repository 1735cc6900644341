"""Partitioned compute on a mesh for the transformer family (``dense``,
``vlm``, ``moe``) and the hybrid (Jamba): Megatron sequence- or
tensor-parallel layers over 'model' and per-layer FSDP gathers over
'data'.

Counterpart of what GSPMD makes of ``repro/models/transformer.py`` and
``repro/models/hybrid.py`` under the reference's rules
(``models/sharding.py``, role 'tp'): the values are the reference's,
the memory and the work per rank the blocks that the specs give.  Every
rank stores its block of each parameter (``launch.mesh.place``); the
step (``launch/steps.py``) computes the loss of its batch rows through
``Partition.loss``, which runs the family's loss (``transformer.loss_fn``,
``hybrid.loss_fn``) itself with a ``Partition`` in place of its
``Whole`` hooks (one forward serves one device and a mesh):

* FSDP.  Layer i's blocks are gathered over 'data' when layer i runs and
  dropped after it (all-gather forward, reduce-scatter backward); under
  ``remat="full"`` the gather sits inside the checkpointed layer, so the
  recompute gathers again.  The embedding tables and the final norm take
  the same gather.  The gradients arrive as blocks, summed over 'data'.
* ``sp=True`` (the reference's default): the residual stream is split
  along the sequence over 'model'.  Attention projects the rank's own
  block, gathers K and V along the sequence and keeps its queries,
  masked at the block's global offset with rotary at its global
  positions.  The MLP gathers its input along the sequence, multiplies
  by its column blocks of ``w_gate``/``w_up`` and its row block of
  ``w_down``, and reduce-scatters back to sequence blocks.
* ``sp=False``: the residual is whole on every rank; attention splits
  its heads over 'model' where they divide (q, k, v by columns, ``wo``
  by rows, then an all-reduce; K and V are broadcast to the query heads
  before a rank takes its own), and the MLP is Megatron's (f, split
  products, g).
* The embedding looks up the rank's vocabulary block (others' tokens
  masked to zero) and reduce-scatters to sequence blocks (all-reduces
  under ``sp=False``); the unembedding makes vocabulary-split logits,
  and the cross entropy reduces its max and its sum of exponentials over
  'model', the target's logit coming from its owner.
* An MoE FFN has no expert parallelism yet (ROADMAP item 14): its
  leaves are gathered whole per layer, over 'data' and 'model'.  Under
  SP each rank routes its own sequence block where the reference's
  chunks of ``cfg.moe_chunk`` tokens lie within it (the aux loss then
  averaged over 'model'), and otherwise the whole sequence, keeping its
  block of the output; under TP every rank computes the FFN whole.  The
  aux loss's two means of each chunk are averaged over the batch's
  ranks before their product (``launch.mesh.batch_means``), so its
  value and gradient are the reference's over the global batch.

The hybrid runs the same hooks slot by slot (``layer(w, slot)``: each
period slot has a tree of its own; its attention without rotary, its
dense and MoE FFNs as above), and a Mamba slot splits its inner dim
``di`` over 'model' as the reference's specs do (``repro/models/
ssm.py``): each rank computes its ``di / m`` channels over the whole
sequence (gathered under SP), its product with ``w_bcdt``'s row block
summed over 'model' into the whole (B, C, dt), ``ssm_scan`` on
``(rows, l, di / m)`` (the channels are independent), the partial sums
of ``w_out``'s row block reduce-scattered to sequence blocks (SP) or
all-reduced (TP).  ``w_in``'s storage block is not the rank's channels:
the reference splits its ``2·di`` columns in one block a rank and then
the product into ``xin`` and ``z``, so each layer moves the halves of
the storage blocks to the ranks of their channels with one all-to-all
over 'model' (``_channels``).

Each leaf's gradient ends up summed over exactly the mesh axes along
which its compute was split and its storage is not (``sum_axes``):
'data' through the FSDP reduce-scatter (or an all-reduce for a leaf
that 'data' does not split), 'pod' for every leaf, 'model' for the
leaves that sequence parallelism computes on blocks (attention and
norms) and, under tensor parallelism, for those a rank uses only a head
block of; never for a Mamba leaf, whose rank computes its channels over
the whole sequence.  Then one division by the batch's ranks.

Prefill (``serving=True``, ``launch.steps.build_prefill_step``) runs
``transformer.forward_prefill`` through the same hooks under
``no_grad``: the FSDP gathers and the SP or TP layers as above, and

* the cache: ``attention(collect_kv=True)`` returns the rank's own
  post-rotary K/V block, the block ``transformer.cache_specs`` gives it
  (batch rows over the data axes, ``cache_seq`` over 'model': under SP
  the block before the sequence gather; under TP the heads gathered
  over 'model', then the rank's sequence block).  qwen1.5-32b's
  prefill_32k cache is ``P(None, 'data', 'model')`` on 16 x 16 and
  ``P(None, ('pod', 'data'), 'model')`` on 2 x 16 x 16, for K, V and
  the int8 scales alike; ``check_cache`` refuses a layout where the two
  differ, and a sliding window's ring;
* attention goes over chunks of the rank's queries
  (``layers.grouped_attention`` without a gradient), each row's softmax
  as before;
* the last position: under SP the last 'model' rank's normed row is
  broadcast to its group; each rank makes its vocabulary block of the
  logits, and the greedy token is the first index of the largest value
  over the blocks (``greedy``);
* no aux loss is reduced (prefill has none).

The hybrid's prefill (``build_prefill_step``) is its loss on blocks
under ``no_grad``, the aux loss over the global batch as in training.

Decode (``decoding=True``, ``launch.steps.build_serve_step``) runs
``transformer.forward_decode`` (and the hybrid's, below) through the
same hooks under the reference's decode rules (``sp=False``, role
'tp'): per layer the FSDP gathers and the TP MLP (an MoE's experts
whole) as above, the embedding and the vocabulary-split logits and
``greedy`` as in prefill, and

* the cache: each rank holds the block ``transformer.cache_specs``
  gives it, the batch rows over the batch's axes and the sequence over
  whatever of ('data', 'model') the batch left free (``decode_cache``):
  ``P(None, 'data', 'model')``, or for a replicated batch
  (``decode_batch_shard=False``: qwen1.5-32b, mistral-large-123b)
  ``P(None, None, ('data', 'model'))``.  The rank's block index along
  the sequence comes from that spec, its axes in the tuple's order;
* attention (``decode_attention``): q, k and v of the rank's head
  block, the new token's K/V gathered over 'model' where 'model'
  splits the K/V heads, written (quantized per (token, head) for the
  int8 cache) by the one rank whose block holds slot ``index % S``;
  q's heads gathered over 'model'; every head scores the rank's own
  sequence block, validity from the global slot index, and one
  log-sum-exp combine over the cache's sequence axes joins the blocks
  (``combine``): the largest score (an all-reduce MAX), the sum of the
  exponentials (SUM), then the weighted V (SUM) of probabilities
  rounded to V's dtype as the reference rounds them, which needs the
  whole sum before the product; a block with no valid slot adds zero.
  The rank's head block of the output times ``wo``'s row block is
  all-reduced over 'model', the reference's psum of that small
  partial; this partial and the MLP's (rows x d elements a token) are
  summed in f32 and rounded once, as the one-device product rounds its
  sum;
* a sliding window's ring cache is refused.

The hybrid's decode (``hybrid.forward_decode``) runs the same hooks
slot by slot: its attention slot as above on that group's KV block
(``P(None, 'data', 'model')`` for decode_32k's 128 rows, ``P(None,
None, ('data', 'model'))`` for long_500k's one), its FFNs as above, and
each Mamba slot on the rank's ``di / m`` channels (``mamba_decode``):
the residual is whole on every rank, the rank's ``w_in`` columns come
by ``_channels``' all-to-all, the block's product with ``w_bcdt``'s
row block is all-reduced over 'model' into the whole (B, C, dt)
(``reduce_bcdt``), the rank's block of the conv tail and of ``h``
(``hybrid.state_specs``: rows over the batch's axes, channels over
'model', in the blocks of ``conv_b``; ``decode_cache`` checks it) takes
its one recurrence step in place, and the block's partial product with
``w_out``'s row block is all-reduced over 'model' (``reduce_out``),
summed in f32 and rounded once as ``wo``'s.  An MoE slot still gathers its experts whole
per layer (no expert parallelism yet).

What this does not partition (``partition_for`` returns None and the
step gathers whole leaves): xLSTM and Whisper, role 'dp' configs and a
mesh of one rank.  A transformer or hybrid config under role 'tp' that
it cannot split is refused, not gathered whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.launch.mesh import (all_gather_cat, all_reduce_sum_,
                                     batch_means, broadcast_, copy_to_group,
                                     exchange_grad, gather_grad,
                                     gather_replicated, reduce_from_group,
                                     scatter_grad, split_dims)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import registry, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (AxisRules, PartitionSpec,
                                         is_spec, mesh_axis_sizes)

P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dim_axes(spec: PartitionSpec, dim: int) -> Tuple[str, ...]:
    return _axes(spec[dim]) if dim < len(spec) else ()


def _split_over(spec: PartitionSpec, axis: str) -> bool:
    return any(axis in _axes(e) for e in spec)


def _spec_paths(specs: Any, prefix: Tuple[Any, ...] = ()
               ) -> List[Tuple[Tuple[Any, ...], PartitionSpec]]:
    """(path, spec) of every leaf of a spec tree, in flatten order (a
    tuple's entries, the hybrid's slots, by index)."""
    if is_spec(specs):
        return [(prefix, specs)]
    if isinstance(specs, (list, tuple)):
        keys = range(len(specs))
    else:
        keys = sorted(specs)
    out = []
    for k in keys:
        out.extend(_spec_paths(specs[k], prefix + (k,)))
    return out


def _layer_specs(p_spec: Any) -> List[Any]:
    """The spec trees of one layer: the transformer's, or each of the
    hybrid's period slots."""
    if "slots" in p_spec:
        return list(p_spec["slots"])
    return [p_spec["layers"]]


def _leaf_kind(path: Tuple[Any, ...]) -> str:
    """How ``Partition.layer`` fetches a layer leaf: ``"whole"`` (an MoE
    FFN's, no expert parallelism), ``"w_in"`` (the Mamba's input
    projection, whose storage block is not the rank's channels) or
    ``"block"``."""
    if path[0] == "moe":
        return "whole"
    if path == ("mamba", "w_in"):
        return "w_in"
    return "block"


def partition_for(cfg: ModelConfig, mesh, rules: AxisRules, p_spec: Any,
                  batch_axes: Tuple[str, ...], *, serving: bool = False,
                  decoding: bool = False) -> Optional["Partition"]:
    """The partition of ``cfg``'s step on ``mesh``, or None where this
    module leaves the step to gather whole leaves (another family, role
    'dp', a mesh of one rank).  Raises for a transformer under role 'tp'
    that it cannot split: a GELU MLP, a batch that does not split over
    every axis but 'model' (decode aside: there a replicated batch
    leaves 'data' to the cache's sequence), or a vocabulary, MLP width
    or Mamba inner dim that 'model' does not split; with ``decoding``,
    a sliding window's ring cache too.  ``serving``: the transformers'
    prefill partition (no aux loss); ``decoding``: the decode partition
    of the transformers and the hybrid (``Partition.decode_cache``
    places its cache or state)."""
    sizes = mesh_axis_sizes(mesh)
    if (cfg.family not in ("dense", "vlm", "moe", "hybrid")
            or rules.rules.get("model") != "model"
            or math.prod(sizes.values()) == 1):
        return None
    why = None
    live = {a for a, n in sizes.items() if n > 1}
    layers = _layer_specs(p_spec)
    if cfg.act != "silu":
        why = f"act={cfg.act!r} (only the SwiGLU MLP is split)"
    elif decoding and cfg.sliding_window is not None:
        why = ("a sliding window's ring cache (its slots are not blocks "
               "of the sequence)")
    elif (not decoding
          and live - {"model"} != {a for a in batch_axes if sizes[a] > 1}):
        why = (f"the batch splits over {tuple(batch_axes)}, not every "
               f"axis but 'model' of {sizes}")
    elif sizes.get("model", 1) > 1:
        if not _split_over(p_spec["embed"], "model"):
            why = "'model' does not split the vocabulary"
        elif any("mlp" in w and not _split_over(w["mlp"]["w_up"], "model")
                 for w in layers):
            why = "'model' does not split the MLP width"
        elif any("mamba" in w and not _split_over(w["mamba"]["conv_b"],
                                                  "model") for w in layers):
            why = "'model' does not split the Mamba inner dim"
    if why is not None:
        raise ValueError(f"{cfg.name}: the step on {sizes} cannot be "
                         f"partitioned: {why}")
    return Partition(cfg, mesh, rules, p_spec, batch_axes,
                     serving=serving or decoding, decoding=decoding)


def _scores(q: torch.Tensor, k: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """One query's scores over a block of the cache, as
    ``layers._attention_grouped`` makes them: q (b, 1, hkv, g, d), k (b,
    s, hkv, d), valid (s,) -> f32 (b, hkv, g, 1, s), the products summed
    in f32 and divided by a tensor sqrt(d), invalid slots at
    ``NEG_INF``."""
    d = q.shape[-1]
    scores = torch.einsum("blhgd,bmhd->bhglm", q.float(), k.float())
    scores = scores / torch.full((), math.sqrt(d), dtype=torch.float32,
                                 device=scores.device)
    return scores.masked_fill(~valid, L.NEG_INF)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class Partition(transformer.Whole):
    """One rank's share of the transformer's compute on ``mesh``: the
    hooks of ``transformer.Whole`` over the rank's blocks."""

    def __init__(self, cfg: ModelConfig, mesh, rules: AxisRules,
                 p_spec: Any, batch_axes: Tuple[str, ...] = (), *,
                 serving: bool = False, decoding: bool = False):
        sizes = mesh_axis_sizes(mesh)
        self.serving = serving
        self.decoding = decoding
        self.batch_axes = tuple(batch_axes)
        # the aux loss's means over the global batch (none in prefill)
        means = None if serving else batch_means(mesh, batch_axes)
        super().__init__(means or moe_lib.local_means)
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = sizes
        self.sp = rules.attn_mode == "sp"
        self.m = sizes.get("model", 1)
        self.mg = mesh.get_group("model") if self.m > 1 else None
        self.rank = mesh.get_local_rank("model") if self.m > 1 else 0
        self.dg = mesh.get_group("data") if sizes.get("data", 1) > 1 \
            else None
        # the Mamba's w_in: storage rank s's column blocks 2s and 2s + 1
        # go to the ranks whose xin (block r) or z (block m + r) they are
        m = self.m
        self.w_in_routes = [[c if c < m else c - m
                             for c in (2 * s, 2 * s + 1)] for s in range(m)]
        self.p_spec = p_spec
        # per slot (the transformer's one layer, the hybrid's period
        # slots): each leaf's per-layer spec and how it is fetched
        self.slot_specs, self.slot_kinds = [], []
        for slot in _layer_specs(p_spec):
            paths = _spec_paths(slot)
            self.slot_specs.append([P(*s[1:]) for _, s in paths])
            self.slot_kinds.append([_leaf_kind(path) for path, _ in paths])
        attn = [w["attn"] for w in _layer_specs(p_spec) if "attn" in w]
        # per-layer dims: wq (d, hq, hd), wk (d, hkv, hd)
        self.heads_split = bool(attn) and "model" in _dim_axes(
            attn[0]["wq"], 2)
        self.kv_split = bool(attn) and "model" in _dim_axes(
            attn[0]["wk"], 2)
        self.batch_ranks = math.prod(
            n for a, n in sizes.items() if a != "model")
        self.sum_axes = [self._sum_axes(path, spec)
                         for path, spec in _spec_paths(p_spec)]

    # ------------------------------------------------------ gradients
    def _sum_axes(self, path: Tuple[str, ...], spec: PartitionSpec
                  ) -> Tuple[str, ...]:
        """The mesh axes a leaf's gradient is summed over after the
        FSDP reduce-scatter (see the module docstring)."""
        out = []
        for a in ("pod", "data"):
            if self.sizes.get(a, 1) > 1 and not _split_over(spec, a):
                out.append(a)
        # a Mamba leaf's compute is the rank's channels over the whole
        # sequence under SP and TP alike: it is its own block's whole
        # gradient ('model' splits every one of them, ``partition_for``)
        if (self.m > 1 and not _split_over(spec, "model")
                and "mamba" not in path):
            name = path[-1]
            if self.sp:
                out.append("model")
            elif self.heads_split and (
                    name in ("q_norm", "k_norm")
                    or (not self.kv_split and name in ("wk", "wv", "bk",
                                                       "bv"))):
                out.append("model")
        return tuple(out)

    def reduce_grads(self, grads: List[torch.Tensor],
                     loss: torch.Tensor) -> List[torch.Tensor]:
        """The blocks' gradients summed over ``sum_axes`` in f32 and
        divided once by the batch's ranks; the loss averaged over the
        batch's ranks."""
        n = torch.full((), self.batch_ranks, dtype=torch.float32,
                       device=loss.device)
        out = []
        for g, axes in zip(grads, self.sum_axes):
            g = g if g.dtype == torch.float32 else g.float()
            for a in axes:
                all_reduce_sum_(g, self.mesh.get_group(a))
            out.append(g.div_(n))
        for a, size in self.sizes.items():
            if a != "model" and size > 1:
                all_reduce_sum_(loss, self.mesh.get_group(a))
        loss.div_(n)
        return out

    # ------------------------------------------------------ FSDP
    def fsdp(self, x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        """``x``'s block gathered over 'data' (its 'model' split kept)."""
        if self.dg is None:
            return x
        for i, entry in enumerate(spec):
            axes = _axes(entry)
            if "data" in axes:
                if axes != ("data",):
                    raise ValueError(f"an FSDP dimension over {axes}")
                x = gather_grad(x, self.dg, i)
        return x

    def _whole(self, x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        """``x``'s block gathered over 'model' too: under SP each rank's
        use of it is a part of its gradient (reduce-scattered back),
        under TP every rank's use is the whole (its block kept)."""
        if self.m == 1:
            return x
        gather = gather_grad if self.sp else gather_replicated
        for i, entry in enumerate(spec):
            if "model" in _axes(entry):
                x = gather(x, self.mg, i)
        return x

    def _channels(self, x: torch.Tensor) -> torch.Tensor:
        """The Mamba ``w_in`` columns of this rank's channels from its
        storage block.  The reference splits the ``2·di`` columns in one
        block a rank and then the product into ``xin`` and ``z``
        (``repro/models/ssm.py``), so a rank's block is not its
        channels: with ``cb = di / m``, column block ``c`` (``cb``
        columns) lies in storage rank ``c // 2``'s block, and rank ``r``
        needs blocks ``r`` (``xin``) and ``m + r`` (``z``).  One
        all-to-all over 'model' sends each half of a storage block to the
        rank of its channels (``w_in_routes``); it arrives as ``[xin,
        z]``.  Backward, each half's gradient returns to its one owner."""
        if self.m == 1:
            return x
        return exchange_grad(x, self.mg, x.dim() - 1, self.w_in_routes)

    def layer(self, w: Dict[str, Any], slot: int = 0) -> Dict[str, Any]:
        flat, treedef = tree_util.flatten(w)
        out = []
        for x, s, kind in zip(flat, self.slot_specs[slot],
                              self.slot_kinds[slot]):
            if kind == "w_in":
                x = self._channels(x)
            x = self.fsdp(x, s)
            out.append(self._whole(x, s) if kind == "whole" else x)
        return tree_util.unflatten(treedef, out)

    def final_norm(self, w: Dict[str, torch.Tensor]):
        return {k: self.fsdp(v, self.p_spec["final_norm"][k])
                for k, v in w.items()}

    # ------------------------------------------------------ forward
    def embed(self, cfg: ModelConfig, tokens: torch.Tensor,
              block: torch.Tensor) -> torch.Tensor:
        table = self.fsdp(block, self.p_spec["embed"])
        if self.m == 1:
            return table[tokens]
        vb = table.shape[0]
        local = tokens.long() - self.rank * vb
        own = (local >= 0) & (local < vb)
        rows = table[local.clamp(0, vb - 1)]
        out = torch.where(own[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        if self.sp:
            return scatter_grad(out, self.mg, 1)
        return reduce_from_group(out, self.mg)

    def positions(self, l: int, device) -> torch.Tensor:
        """The sequence block's global positions under SP."""
        if not self.sp or self.m == 1:
            return torch.arange(l, device=device)
        if l % self.m:
            raise ValueError(f"sequence {l} does not split over "
                             f"{self.m} 'model' ranks")
        lb = l // self.m
        return torch.arange(self.rank * lb, (self.rank + 1) * lb,
                            device=device)

    def attention(self, cfg: ModelConfig, h: torch.Tensor,
                  w: Dict[str, torch.Tensor], cos: torch.Tensor,
                  sin: torch.Tensor, collect_kv: bool = False):
        """The attention sublayer on the rank's block; with
        ``collect_kv`` (prefill) also the rank's block of the cache's
        post-rotary (k, v) (module docstring)."""
        window = cfg.sliding_window
        if self.sp:
            q, k, v = L._qkv(cfg, h, w, cos, sin)
            kv = (k, v)
            if self.m > 1:
                k = gather_grad(k, self.mg, 1)
                v = gather_grad(v, self.mg, 1)
            lq = q.shape[1]
            mask = L.causal_window_mask(lq, k.shape[1],
                                        q_offset=self.rank * lq,
                                        window=window, device=q.device)
            out = L._out_project(L.grouped_attention(q, k, v, mask),
                                 w["wo"])
            return (out, kv) if collect_kv else out
        split = self.m > 1 and self.heads_split
        hf = copy_to_group(h, self.mg) if split else h
        q, k, v = L._qkv(cfg, hf, w, cos, sin)
        l, hq = q.shape[1], q.shape[2]
        if collect_kv:
            kv = (self._cache_block(k), self._cache_block(v))
        g = cfg.n_heads // cfg.n_kv_heads
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        if split and not self.kv_split:
            k = k.narrow(2, self.rank * hq, hq)
            v = v.narrow(2, self.rank * hq, hq)
        mask = L.causal_window_mask(l, l, window=window, device=q.device)
        out = L._out_project(L.heads_attention(cfg, q, k, v, mask), w["wo"])
        out = reduce_from_group(out, self.mg) if split else out
        return (out, kv) if collect_kv else out

    def _cache_block(self, t: torch.Tensor) -> torch.Tensor:
        """Under TP: the cache's block of a whole-sequence K or V whose
        heads this rank may hold a block of: every head, the rank's
        sequence block."""
        if self.m == 1:
            return t
        if self.heads_split and self.kv_split:
            t = all_gather_cat(t, self.mg, 2)
        l = t.shape[1]
        if l % self.m:
            raise ValueError(f"sequence {l} does not split over {self.m} "
                             "'model' ranks")
        lb = l // self.m
        return t.narrow(1, self.rank * lb, lb).contiguous()

    def check_cache(self, cache_spec: Dict[str, PartitionSpec]) -> None:
        """Raise unless every cache leaf's spec splits exactly the rank's
        blocks of the prefill: the batch rows over the batch's axes, the
        sequence over 'model' (axes of one rank aside)."""
        cfg, sizes = self.cfg, self.sizes
        if cfg.sliding_window is not None:
            raise ValueError(f"{cfg.name}: a sliding window's ring cache "
                             "is not a block of the prefill's sequence")
        want = {}
        rows = tuple(a for a in self.batch_axes if sizes[a] > 1)
        if rows:
            want[1] = rows
        if self.m > 1:
            want[2] = ("model",)
        for name, spec in cache_spec.items():
            got = {d: tuple(a for a in axes if sizes[a] > 1)
                   for d, axes in split_dims(spec, self.mesh).items()}
            if got != want:
                raise ValueError(
                    f"{cfg.name}: cache {name!r} is split as {spec} "
                    f"({got}), the prefill's blocks as {want}")

    # ------------------------------------------------------ decode
    def decode_cache(self, cache_spec: Any) -> None:
        """Place the decode cache or state (``cache_spec``: the
        transformers' flat tree, or the hybrid's ``kv`` and ``mamba``).
        A KV leaf's spec must split its batch rows (dim 1) over the
        batch's axes and nothing but its sequence (dim 2) besides, the
        same way for every KV leaf.  A Mamba leaf (``conv`` (groups,
        slots, rows, k - 1, di), ``h`` (groups, slots, rows, di, ds))
        must split its rows (dim 2) over the batch's axes and its
        channels over 'model' alone, in the blocks of the Mamba
        parameters' channels (``conv_b``), and nothing else.  Any other
        layout is refused, naming the leaf.  Sets the sequence's live
        axes (``seq_axes``, from the KV leaves' spec in its order: the
        first major), their groups, and this rank's block index among
        ``seq_blocks``."""
        sizes, mesh = self.sizes, self.mesh
        rows = tuple(a for a in self.batch_axes if sizes[a] > 1)
        conv_b = [w["mamba"]["conv_b"] for w in _layer_specs(self.p_spec)
                  if "mamba" in w]
        chans = ("model",) if self.m > 1 else ()
        seq = None
        for path, spec in _spec_paths(cache_spec):
            got = {d: tuple(a for a in axes if sizes[a] > 1)
                   for d, axes in split_dims(spec, mesh).items()}
            if path[0] == "mamba":
                dim = {"conv": 4, "h": 3}.get(path[-1])
                ok = (dim is not None and bool(conv_b)
                      and got.pop(2, ()) == rows
                      and got.pop(dim, ()) == chans
                      and all(tuple(a for a in _dim_axes(c, 1)
                                    if sizes[a] > 1) == chans
                              for c in conv_b))
                want = (f"its rows over {rows} and its channels over "
                        f"{chans}, as the Mamba parameters' channels")
            else:
                s = got.pop(2, ())
                ok = got.pop(1, ()) == rows and seq in (None, s)
                seq = s
                want = (f"its batch rows over {rows} and its sequence "
                        "like every other KV leaf's")
            if not ok or got:
                raise ValueError(
                    f"{self.cfg.name}: decode cache "
                    f"{'/'.join(map(str, path))!r} is split as {spec}, "
                    f"not as {want}")
        self.seq_axes = seq or ()
        self.seq_groups = [mesh.get_group(a) for a in self.seq_axes]
        self.seq_blocks = math.prod(sizes[a] for a in self.seq_axes)
        self.seq_block = 0
        for a in self.seq_axes:
            self.seq_block = (self.seq_block * sizes[a]
                              + mesh.get_local_rank(a))

    def decode_attention(self, cfg: ModelConfig, h: torch.Tensor,
                         w: Dict[str, torch.Tensor],
                         cache: Dict[str, torch.Tensor], index: int
                         ) -> torch.Tensor:
        """One token's attention on the rank's blocks: the head block's
        q, k, v; the new token's K/V whole (gathered over 'model' where
        it splits them), written by the owner of slot ``index % S``;
        every head over the rank's sequence block, joined over the
        cache's sequence axes (``combine``); the output's head block
        times ``wo``'s row block, summed over 'model' (module
        docstring)."""
        b = h.shape[0]
        s_l = cache["k"].shape[1]
        s_max = s_l * self.seq_blocks
        cos = sin = None
        if cfg.use_rope:
            pos = torch.full((b, 1), index, dtype=torch.int32,
                             device=h.device)
            cos, sin = L.rotary_embedding(pos, cfg.resolved_head_dim,
                                          cfg.rope_theta)
        q, k, v = L._qkv(cfg, h, w, cos, sin)
        split = self.m > 1 and self.heads_split
        if split:
            q = all_gather_cat(q, self.mg, 2)
            if self.kv_split:
                k = all_gather_cat(k, self.mg, 2)
                v = all_gather_cat(v, self.mg, 2)
        slot = index % s_max
        own = slot // s_l == self.seq_block
        at = slot % s_l
        if "k_scale" in cache:
            if own:
                kq, ks = L.quantize_kv(k)
                vq, vs = L.quantize_kv(v)
                cache["k"][:, at] = kq[:, 0]
                cache["v"][:, at] = vq[:, 0]
                cache["k_scale"][:, at] = ks[:, 0]
                cache["v_scale"][:, at] = vs[:, 0]
            ck = L.dequantize_kv(cache["k"], cache["k_scale"], h.dtype)
            cv = L.dequantize_kv(cache["v"], cache["v_scale"], h.dtype)
        else:
            if own:
                cache["k"][:, at] = k[:, 0].to(cache["k"].dtype)
                cache["v"][:, at] = v[:, 0].to(cache["v"].dtype)
            ck, cv = cache["k"], cache["v"]
        # validity of each slot of the block by its global index, as
        # ``layers.decode_attention_block`` (no ring: refused)
        first = self.seq_block * s_l
        slots = torch.arange(first, first + s_l, device=h.device)
        valid = (slot - slots) % s_max <= index
        hq, hkv, hd = q.shape[2], ck.shape[2], q.shape[-1]
        scores = _scores(q.reshape(b, 1, hkv, hq // hkv, hd), ck, valid)
        out = self.combine(scores, cv)
        # (b, hkv, g, 1, d) -> (b, 1, hq, d)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd).to(q.dtype)
        if not split:
            return L._out_project(out, w["wo"])
        hb = hq // self.m
        out = L._out_project(out.narrow(2, self.rank * hb, hb), w["wo"],
                             wide=True)
        return reduce_from_group(out, self.mg).to(h.dtype)

    def combine(self, scores: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        """The attention output (b, hkv, g, 1, d) in f32 from each
        sequence block's scores (``_scores``) and V (b, s, hkv, d), as
        the reference's softmax over the whole sequence: the largest
        score over the cache's sequence axes (an all-reduce MAX), the
        sum of the exponentials (SUM), then each block's probabilities,
        rounded to V's dtype as the reference rounds them, times its V,
        summed (SUM).  A block with no valid slot has exponentials of
        zero: it adds nothing."""
        big = scores.amax(dim=-1)
        for g in self.seq_groups:
            all_reduce_sum_(big, g, op=dist.ReduceOp.MAX)
        e = torch.exp(scores - big[..., None])
        total = e.sum(dim=-1)
        for g in self.seq_groups:
            all_reduce_sum_(total, g)
        probs = (e / total[..., None]).to(v.dtype).float()
        out = torch.einsum("bhglm,bmhd->bhgld", probs, v.float())
        for g in self.seq_groups:
            all_reduce_sum_(out, g)
        return out

    def _mlp(self, h: torch.Tensor, w: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        if self.m == 1:
            return L.mlp_block(self.cfg, h, w)
        if self.decoding:
            # a token's partial sums (rows x d) are summed in f32 and
            # rounded once, as the one-device product rounds its sum
            out = L.mlp_block(self.cfg, h, w, wide=True)
            return reduce_from_group(out, self.mg).to(h.dtype)
        hg = (gather_grad(h, self.mg, 1) if self.sp
              else copy_to_group(h, self.mg))
        out = L.mlp_block(self.cfg, hg, w)
        if self.sp:
            return scatter_grad(out, self.mg, 1)
        return reduce_from_group(out, self.mg)

    def mamba(self, cfg: ModelConfig, h: torch.Tensor,
              w: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The Mamba sublayer on the rank's block of channels over the
        whole sequence (the scan and the conv need it): the input
        gathered along the sequence (SP) or entering split compute (TP);
        the product with ``w_bcdt``'s row block summed over 'model' into
        the whole (B, C, dt) forward and its gradient summed backward
        (every rank's channels read it); ``ssm_scan`` on ``(rows, l,
        di / m)``; the partial sums of ``w_out``'s row block
        reduce-scattered back to sequence blocks (SP) or all-reduced
        (TP)."""
        if self.m == 1:
            return ssm.mamba_block(cfg, h, w)
        mg = self.mg
        hg = gather_grad(h, mg, 1) if self.sp else copy_to_group(h, mg)
        out = ssm.mamba_block(
            cfg, hg, w,
            reduce_bcdt=lambda t: copy_to_group(reduce_from_group(t, mg),
                                                mg))
        if self.sp:
            return scatter_grad(out, mg, 1)
        return reduce_from_group(out, mg)

    def mamba_decode(self, cfg: ModelConfig, h: torch.Tensor,
                     w: Dict[str, torch.Tensor],
                     state: Dict[str, torch.Tensor]):
        """One token's Mamba sublayer on the rank's block of channels and
        of the state (module docstring): the residual is whole on every
        rank (TP), the rank's ``w_in`` columns came through ``layer``'s
        ``_channels``; the block's product with ``w_bcdt``'s row block
        is summed over 'model' into the whole (B, C, dt)
        (``reduce_bcdt``), the state block stepped, and the partial
        product of the block's ``y`` with ``w_out``'s row block summed
        over 'model' (``reduce_out``), both in f32 and rounded once.
        (out, the new state block)."""
        if self.m == 1:
            return ssm.mamba_decode(cfg, h, w, state)
        return ssm.mamba_decode(cfg, h, w, state,
                                reduce_bcdt=self.reduce_bcdt,
                                reduce_out=self.reduce_out)

    def reduce_bcdt(self, t: torch.Tensor) -> torch.Tensor:
        """A decode's partial (B, C, dt) in f32, summed over 'model' in
        place."""
        return all_reduce_sum_(t, self.mg)

    def reduce_out(self, t: torch.Tensor) -> torch.Tensor:
        """A decode's partial Mamba output in f32, summed over 'model'."""
        return reduce_from_group(t, self.mg)

    def ffn(self, cfg: ModelConfig, h: torch.Tensor, w: Dict[str, Any]):
        if "moe" in w:
            return self._moe(h, w["moe"])
        return self._mlp(h, w["mlp"]), None

    def _moe(self, h: torch.Tensor, w: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The MoE FFN over whole experts: (out, the aux loss, whose
        gradient reaches each rank as its share)."""
        cfg = self.cfg
        if self.m == 1 or not self.sp:
            return moe_lib.moe_block(cfg, h, w, self.moe_means)
        lb = h.shape[1]
        m = torch.full((), self.m, dtype=torch.float32, device=h.device)
        if 0 < cfg.moe_chunk <= lb and lb % cfg.moe_chunk == 0:
            # the reference's chunks lie within this block: route them
            # here; the aux loss is the mean of every chunk's
            out, aux = moe_lib.moe_block(cfg, h, w, self.moe_means)
            if self.serving:
                return out, aux
            return out, reduce_from_group(aux, self.mg) / m
        out, aux = moe_lib.moe_block(cfg, gather_grad(h, self.mg, 1), w,
                                     self.moe_means)
        return (out.narrow(1, self.rank * lb, lb),
                _ScaleGrad.apply(aux, 1.0 / self.m))

    def unembed(self, cfg: ModelConfig, x: torch.Tensor,
                block: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's vocabulary block of the logits (rows, l, v /
        model) in f32, the padded columns masked."""
        if self.m > 1:
            x = (gather_grad(x, self.mg, 1) if self.sp
                 else copy_to_group(x, self.mg))
        return self.unembed_row(cfg, x, block, name)

    def last_row(self, cfg: ModelConfig, x: torch.Tensor,
                 w: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The normed last position (rows, 1, d) on every rank: under SP
        the last 'model' rank's, broadcast to its group."""
        row = super().last_row(cfg, x, w)
        if self.sp and self.m > 1:
            broadcast_(row, self.mg, self.m - 1)
        return row

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """``argmax`` over the vocabulary blocks of the last position's
        logits: the largest value (an all-reduce MAX over 'model'), then
        the least global index among the ranks that hold it (MIN), the
        first index as ``argmax`` takes it."""
        last = logits[:, -1]
        idx = torch.argmax(last, dim=-1)
        if self.m == 1:
            return idx
        vb = last.shape[-1]
        val = torch.gather(last, -1, idx[:, None])[:, 0]
        top = all_reduce_sum_(val.clone(), self.mg, op=dist.ReduceOp.MAX)
        cand = torch.where(val == top, idx + self.rank * vb,
                           torch.full_like(idx, vb * self.m))
        return all_reduce_sum_(cand, self.mg, op=dist.ReduceOp.MIN)

    def unembed_row(self, cfg: ModelConfig, x: torch.Tensor,
                    block: torch.Tensor, name: str) -> torch.Tensor:
        """The vocabulary block of the logits of rows every rank of the
        'model' group holds whole."""
        table = self.fsdp(block, self.p_spec[name])
        logits = L.unembed(x, table)
        vb = table.shape[0]
        v0 = self.rank * vb
        if v0 + vb > cfg.vocab_size:
            col = torch.arange(v0, v0 + vb, device=x.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, L.NEG_INF)
        return logits

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      ignore_id: int = -1) -> torch.Tensor:
        """Mean token NLL over the rank's rows from vocabulary-split
        logits: the max and the sum of exponentials reduced over
        'model', the target's logit from the rank that owns it."""
        if self.m == 1:
            return L.cross_entropy(logits, labels, ignore_id)
        vb = logits.shape[-1]
        v0 = self.rank * vb
        top = logits.detach().amax(dim=-1)
        all_reduce_sum_(top, self.mg, op=dist.ReduceOp.MAX)
        shifted = logits - top[..., None]
        sumexp = torch.exp(shifted).sum(dim=-1)
        local = labels.clamp(min=0).long() - v0
        own = (local >= 0) & (local < vb)
        gold = torch.gather(shifted, -1,
                            local.clamp(0, vb - 1)[..., None])[..., 0]
        gold = torch.where(own, gold, torch.zeros((), device=gold.device))
        sumexp, gold = reduce_from_group(torch.stack([sumexp, gold]),
                                         self.mg).unbind(0)
        nll = torch.log(sumexp) - gold
        weights = (labels != ignore_id).float()
        return torch.sum(nll * weights) / torch.clamp(torch.sum(weights),
                                                      min=1.0)

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The family's loss (``transformer.loss_fn``,
        ``hybrid.loss_fn``) on the rank's blocks: the loss is the mean
        over the rank's rows, the same on every rank of one 'model'
        group."""
        return registry.family(self.cfg).loss_fn(self.cfg, params, batch,
                                                 self)

