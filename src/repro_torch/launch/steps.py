"""Train / prefill / serve step builders with their placements on a mesh.

Counterpart of ``repro/launch/steps.py``.  ``build_train_step``,
``build_prefill_step`` and ``build_serve_step`` return a ``StepBundle``:
the step function, the ``PartitionSpec`` trees of its arguments and
results (the reference's ``in_shardings``/``out_shardings``, which
``launch.mesh.place`` applies), the arguments it updates in place (the
reference's ``donate_argnums``) and its inputs' shapes as ``meta``
tensors.

Execution model.  Under GSPMD a sharding never changes a value, so the
port keeps the reference's values and its per-device storage:

* one process per device (``torch.distributed``), the ranks laid out on
  a ``DeviceMesh`` with named axes (``launch/mesh.py``);
* every tensor of the step is stored as its rank's block of the spec
  that ``AxisRules.spec`` gives it: params, optimizer state, the DSSP
  ring and the batch;
* the transformers (dense, ``vlm``, MoE) and the hybrid (Jamba) under
  role 'tp' (``models/partition.py``) compute on blocks too: layer i's
  parameters are gathered over 'data' when layer i runs (FSDP; an MoE's
  experts whole), the compute along 'model' is Megatron's
  (sequence-parallel or tensor-parallel; a Mamba's on its channel
  block), and the gradients arrive as blocks, summed over the axes the
  compute was split along, then divided once by the batch's ranks;
* their prefill computes on blocks the same way, under ``no_grad``
  (``build_prefill_step``): for the transformers attention over chunks
  of the rank's queries, the rank's block of the KV cache as
  ``cache_specs`` gives it, the greedy token an argmax over the
  vocabulary blocks; for the hybrid its loss over the global batch; it
  gathers no whole parameter;
* their decode computes on blocks too (``build_serve_step``): per
  layer the FSDP gather, heads over 'model', attention of every head
  over the rank's block of the KV cache's sequence joined by a
  log-sum-exp combine over the cache's sequence axes, the hybrid's
  Mamba slots on the rank's channel block of the layer and of the
  recurrent state, the cache and state updated in place where they
  lie; it gathers neither a whole parameter (an MoE's experts aside)
  nor the cache's whole sequence nor a whole Mamba state leaf;
* every other config (xLSTM, Whisper, role 'dp', a sliding window's
  ring cache), their prefill and decode gather each parameter whole
  and run the model on the rank's batch rows, then average the
  gradients over the batch's mesh axes (an f32 ``all_reduce`` sum, a
  division by a tensor) and take each rank's block: ranks on one
  'model' coordinate repeat the same work (ROADMAP queue 1, item 14);
* an MoE's aux loss takes its two means over the global batch in both
  train steps and in the hybrid's prefill (``launch.mesh.batch_means``);
* wire compression (``make_train_fn(compressor=)``, the ``Trainer``'s)
  compresses each rank's gradient blocks before the ring, with the
  error state in blocks; the one scalar per whole leaf (int8's max,
  top-k's threshold) is reduced over the axes that split the leaf
  (``block_reducers``);
* the ring and the optimizer update each rank's blocks in place;
  Adafactor's means over whole leaves are sums over the blocks, summed
  over the axes that split them (``block_means``);
* a mesh whose axes all have one rank runs no collective and copies no
  parameter: the step computes with the stored tensors themselves.

With mesh rules installed attention takes the reference's mesh
formulations (``layers.attention``, or ``models/partition.py``'s on
blocks) and no flash kernel; the norms go through the kernel registry
as without a mesh.  Host decisions (the DSSP delay) must be the same on
every rank: the caller passes the same value to each (the ``Trainer``
broadcasts its controller's choice).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.shapes import ShapeSpec, input_specs, state_sds
from repro_torch.core import dssp_spmd
from repro_torch.launch.mesh import (all_reduce_mean, all_reduce_sum_,
                                     batch_means, block_view, gather,
                                     gather_leaf, spec_axes, split_dims)
from repro_torch.launch.train import OPTIMIZER_RANGE, RING_RANGE
from repro_torch.models import registry, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import sds_tree, spec_tree
from repro_torch.models.partition import partition_for
from repro_torch.models.sharding import (AxisRules, PartitionSpec, is_spec,
                                         mesh_axis_sizes, rules_for_mesh,
                                         use_rules)
from repro_torch.optim.compression import (WHOLE_LEAF, Compressor,
                                           LeafReducer)
from repro_torch.optim.optimizers import (Optimizer, whole_mean,
                                          make_optimizer,
                                          state_partition_specs)

P = PartitionSpec


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    in_shardings: Tuple         # PartitionSpec trees, one per argument
    out_shardings: Any          # PartitionSpec trees of the results
    donate_argnums: Tuple[int, ...]   # arguments updated in place
    input_sds: Tuple            # meta tensors matching fn's signature
    rules: AxisRules
    #: the step computes on blocks (``models.partition``); False: it
    #: gathers every parameter whole
    partitioned: bool = False


def batch_specs(cfg: ModelConfig, rules: AxisRules, sds: Dict[str, Any]):
    """Every input split on its leading (batch) dimension."""
    def spec(x):
        axes = ["batch"] + [None] * (len(x.shape) - 1)
        return rules.spec(axes, x.shape)

    return tree_util.tree_map(spec, sds)


def _batch_axes(b_spec: Any) -> Tuple[str, ...]:
    """The mesh axes the batch's rows are split over (what the gradients
    and the loss are averaged over)."""
    specs = tree_util.leaves(b_spec, is_leaf=is_spec)
    return spec_axes(specs[0], 0) if specs else ()


def _local_grads(loss_fn: Callable, params: Any, batch: Dict[str, Any],
                 accum: int, row0: int = 0, blocks: int = 1):
    """(loss, grads) of the rank's rows, as its share of the global
    batch's mean (the mean over the ``blocks`` ranks that split the rows
    is the global value).

    With ``accum`` > 1 the rows go in the reference's interleaved
    microbatches: microbatch a = global rows a::accum, of which this
    rank (global rows ``row0`` on) holds its local rows
    ``(a - row0) % accum :: accum``; the gradients are summed in f32
    over ``g / accum``.  Where a rank holds fewer rows of a microbatch
    than its share (fewer rows than microbatches), its loss and
    gradients are weighted by its rows over that share, and a rank with
    none skips it.  Without accumulation the gradients come in the
    parameters' dtype."""
    leaves, treedef = tree_util.flatten(params)

    def one(mb):
        live = [x.detach().requires_grad_() for x in leaves]
        loss, _ = loss_fn(tree_util.unflatten(treedef, live), mb)
        return loss.detach(), list(torch.autograd.grad(loss, live))

    if accum <= 1:
        return one(batch)
    rows = tree_util.leaves(batch)[0].shape[0]
    share = rows * blocks // accum / blocks      # a rank's fair share
    dev = leaves[0].device
    div = torch.full((), accum, dtype=torch.float32, device=dev)
    g_acc = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
             for x in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for a in range(accum):
        first = (a - row0) % accum
        n = len(range(first, rows, accum))
        if n == 0:
            continue
        loss, g = one({k: x[first::accum] for k, x in batch.items()})
        weight = None if n == share else torch.full(
            (), n / share, dtype=torch.float32, device=dev)
        if weight is not None:
            loss = loss * weight
        loss_sum = loss_sum + loss
        for acc, gi in zip(g_acc, g):
            gi = gi.float() if weight is None else gi.float() * weight
            acc.add_(gi / div)
    return loss_sum / div, g_acc


def _row_block(b_spec: Any, mesh) -> Tuple[int, int]:
    """(this rank's block index, block count) of the batch's rows."""
    sizes = mesh_axis_sizes(mesh)
    idx, n = 0, 1
    for a in _batch_axes(b_spec):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def make_train_fn(mesh, rules: AxisRules, opt: Optimizer, cfg: ModelConfig,
                  p_spec: Any, o_spec: Any, b_spec: Any, *,
                  use_pipeline: bool, accum: int = 1, partition: bool = True,
                  compressor: Optional[Compressor] = None) -> Callable:
    """The mesh train step ``(params, opt_state, pipeline, batch, delay,
    err=()) -> (params, opt_state, pipeline, {"loss": loss})`` over this
    rank's blocks (see the module docstring); params, optimizer state,
    ring and error state are updated in place.  ``delay`` is a host int,
    the same on every rank.  With ``cfg`` a config that
    ``models.partition`` partitions (and ``partition``), the step
    computes on blocks (``Partition.loss``) and gathers no whole
    parameter; otherwise it gathers each parameter whole and runs
    ``registry.loss_fn(cfg)`` (an MoE's with the aux loss over the
    global batch).
    With a ``compressor`` that is not the identity, the gradient blocks
    are compressed before the ring against ``err``, the error state's
    blocks (f32, the leaves' specs)."""
    sizes = mesh_axis_sizes(mesh)
    reduce_axes = tuple(a for a in _batch_axes(b_spec) if sizes[a] > 1)
    p_specs = tree_util.leaves(p_spec, is_leaf=is_spec)
    split = [bool(split_dims(s, mesh)) for s in p_specs]
    row_idx, row_blocks = _row_block(b_spec, mesh)
    part = (partition_for(cfg, mesh, rules, p_spec, _batch_axes(b_spec))
            if partition else None)
    loss_fn = registry.loss_fn(cfg, batch_means(mesh, reduce_axes))
    opt_kw = ({"means": block_means(p_specs, mesh)}
              if opt.name == "adafactor" and any(split) else {})
    compress = compressor is not None and compressor.name != "none"
    reducers = block_reducers(p_specs, mesh) if compress else None

    def whole_grads(params, batch, row0):
        """Gradients of the gathered leaves, averaged over the batch's
        axes in f32, as each rank's blocks."""
        full = gather(params, p_spec, mesh)
        loss, grads = _local_grads(loss_fn, full, batch, accum, row0,
                                   row_blocks)
        if reduce_axes:
            wide = [g if g.dtype == torch.float32 else g.float()
                    for g in grads]
            all_reduce_mean(wide + [loss], reduce_axes, mesh)
            grads = wide
        return loss, [block_view(g, s, mesh) if sp else g
                      for g, s, sp in zip(grads, p_specs, split)]

    def train_step(params, opt_state, pipeline, batch, delay, err=()):
        with use_rules(rules):
            leaves, treedef = tree_util.flatten(params)
            row0 = row_idx * tree_util.leaves(batch)[0].shape[0]
            if part is not None:
                loss, grads = _local_grads(part.loss, params, batch, accum,
                                           row0, row_blocks)
                grads = part.reduce_grads(list(grads), loss)
            else:
                loss, grads = whole_grads(params, batch, row0)
            blocks = tree_util.unflatten(treedef, [
                g.to(p.dtype) for g, p in zip(grads, leaves)])
            del grads
            if compress:
                blocks, new_err = compressor.apply(blocks, err, reducers)
                with torch.no_grad():
                    for e, n in zip(tree_util.leaves(err),
                                    tree_util.leaves(new_err)):
                        e.copy_(n)
                del new_err
            if use_pipeline:
                with torch.profiler.record_function(RING_RANGE):
                    blocks, valid, pipeline = dssp_spmd.push_pop(
                        pipeline, blocks, delay)
                staleness, lr_scale = delay, valid
            else:
                staleness, lr_scale = 0, 1.0
            with torch.profiler.record_function(OPTIMIZER_RANGE):
                params, opt_state = opt.update(
                    blocks, opt_state, params, staleness=staleness,
                    lr_scale=lr_scale, **opt_kw)
        return params, opt_state, pipeline, {"loss": loss}

    train_step.partition = part
    return train_step


class _BlockReducer(LeafReducer):
    """A leaf split over ``groups`` (the live mesh axes that split it):
    reductions over their ranks, ``n`` blocks in all."""

    def __init__(self, groups, n: int):
        self.groups, self.n = groups, n

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        for g in self.groups:
            all_reduce_sum_(t, g, op=torch.distributed.ReduceOp.MAX)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        for g in self.groups:
            all_reduce_sum_(t, g)
        return t

    def numel(self, block: torch.Tensor) -> int:
        return block.numel() * self.n


def block_reducers(p_specs, mesh) -> list:
    """Per leaf, the ``optim.compression.LeafReducer`` that reads the
    whole leaf from this rank's block: over the live mesh axes that
    split it; ``WHOLE_LEAF`` for a leaf no axis splits."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for spec in p_specs:
        axes = [a for ax in split_dims(spec, mesh).values() for a in ax
                if sizes[a] > 1]
        out.append(_BlockReducer([mesh.get_group(a) for a in axes],
                                 math.prod(sizes[a] for a in axes))
                   if axes else WHOLE_LEAF)
    return out


def block_means(p_specs, mesh) -> list:
    """Per leaf, Adafactor's ``mean(x, dim, pdim, keepdim)`` over the
    whole leaf from this rank's block: a sum over the block, summed over
    the mesh axes that split the leaf's dimension ``pdim`` (every split
    axis for ``pdim`` None), divided by the whole count (a tensor
    divisor); ``torch.mean`` for a leaf no axis splits."""
    sizes = mesh_axis_sizes(mesh)

    def make(spec):
        dims = split_dims(spec, mesh)
        if not dims:
            return whole_mean

        def mean(x, dim, pdim, keepdim=False):
            if dim is None:
                axes = [a for ax in dims.values() for a in ax]
                s, count = x.sum(), x.numel()
            else:
                axes = list(dims.get(pdim, ()))
                s, count = x.sum(dim=dim, keepdim=keepdim), x.shape[dim]
            for a in axes:
                if sizes[a] > 1:
                    all_reduce_sum_(s, mesh.get_group(a))
                    count *= sizes[a]
            return s / torch.full((), count, dtype=s.dtype, device=s.device)

        return mean

    return [make(s) for s in p_specs]


def _meta_scalar() -> torch.Tensor:
    return torch.empty((), dtype=torch.int32, device="meta")


# ------------------------------------------------------------------ train
def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                     sync: str = "dssp", s_upper: int = 1,
                     optimizer: Optional[Optimizer] = None,
                     lr: float = 3e-4, partition: bool = True) -> StepBundle:
    """``partition=False``: the step gathers every parameter whole even
    where ``models.partition`` would split its compute."""
    rules = rules_for_mesh(mesh, sp=cfg.sequence_parallel,
                           role=cfg.model_axis_role)
    opt = optimizer or make_optimizer(cfg.optimizer, lr)
    use_pipeline = sync in ("ssp", "dssp")

    defs = registry.param_defs(cfg)
    p_sds = sds_tree(defs, cfg.dtype)
    p_spec = spec_tree(defs, rules)
    o_sds = opt.init(p_sds)
    o_spec = state_partition_specs(opt, p_spec, p_sds)
    b_sds = input_specs(cfg, shape)
    b_spec = batch_specs(cfg, rules, b_sds)
    if use_pipeline:
        pipe_sds = dssp_spmd.init_pipeline(p_sds, s_upper + 1)
        pipe_spec = dssp_spmd.pipeline_specs(p_spec, s_upper + 1)
    else:
        pipe_sds, pipe_spec = (), ()
    accum = math.gcd(max(1, cfg.grad_accum), shape.global_batch)

    fn = make_train_fn(mesh, rules, opt, cfg, p_spec, o_spec, b_spec,
                       use_pipeline=use_pipeline, accum=accum,
                       partition=partition)
    in_sh = (p_spec, o_spec, pipe_spec, b_spec, P())
    out_sh = (p_spec, o_spec, pipe_spec, {"loss": P()})
    input_sds = (p_sds, o_sds, pipe_sds, b_sds, _meta_scalar())
    return StepBundle(fn, in_sh, out_sh, (0, 1, 2), input_sds, rules,
                      fn.partition is not None)


# ------------------------------------------------------------------ helpers
def _rows_axes_entry(rules: AxisRules, b: int):
    """The spec entry of a batch dimension of ``b`` rows."""
    spec = rules.spec(("batch",), (b,))
    return spec[0] if len(spec) else None


def _non_batch_dims(spec: PartitionSpec, mesh, batch_entry
                    ) -> Tuple[int, ...]:
    """The split dimensions of a leaf other than its batch dimension:
    the dimension that carries the batch's entry (the batch's logical
    axis comes first in every layout, and no other dimension can take
    the same mesh axes)."""
    dims = split_dims(spec, mesh)
    if batch_entry is not None and batch_entry in tuple(spec):
        dims.pop(tuple(spec).index(batch_entry), None)
    return tuple(dims)


# ------------------------------------------------------------------ prefill
def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                       partition: bool = True) -> StepBundle:
    """The transformers under role 'tp' compute on blocks
    (``models.partition``, ``serving=True``): the bundle gathers no
    parameter and returns the rank's block of the token and of the
    cache.  The hybrid under role 'tp' computes its loss on blocks
    (``Partition.loss`` under ``no_grad``, the MoE aux loss over the
    global batch), the same on every rank.  Every other config, a mesh
    of one rank and ``partition=False`` gather the parameters whole."""
    # prefill/serve always use TP weight layouts: model_axis_role='dp' is
    # a training choice
    rules = rules_for_mesh(mesh, sp=cfg.sequence_parallel, role="tp")
    defs = registry.param_defs(cfg)
    p_sds = sds_tree(defs, cfg.dtype)
    p_spec = spec_tree(defs, rules)
    b_sds = input_specs(cfg, shape)
    b_spec = batch_specs(cfg, rules, b_sds)
    b = shape.global_batch
    entry = _rows_axes_entry(rules, b)
    part = None

    if cfg.family in ("dense", "moe", "vlm"):
        cache_spec = transformer.cache_specs(cfg, b, shape.seq_len, rules)
        tok_spec = rules.spec(("batch",), (b,))
        if cfg.model_axis_role == "tp" and partition:
            part = partition_for(cfg, mesh, rules, p_spec,
                                 _batch_axes(b_spec), serving=True)
        if part is not None:
            part.check_cache(cache_spec)

            def prefill(params, batch):
                with use_rules(rules), torch.no_grad():
                    logits, cache = transformer.forward_prefill(
                        cfg, params, batch["tokens"], part)
                    token = part.greedy(logits)
                return token, cache
        else:
            def prefill(params, batch):
                with use_rules(rules), torch.no_grad():
                    full = gather(params, p_spec, mesh)
                    logits, cache = transformer.forward_prefill(
                        cfg, full, batch["tokens"])
                    token = torch.argmax(logits[:, -1], dim=-1)
                    cache = {k: _own_block(v, cache_spec[k], mesh, entry)
                             for k, v in cache.items()}
                return token, cache

        out_sh = (tok_spec, cache_spec)
    else:
        # ssm/hybrid/audio: prefill = full forward, the loss over the
        # global batch (the reference's trunk compute)
        reduce_axes = _batch_axes(b_spec)
        if (cfg.family == "hybrid" and cfg.model_axis_role == "tp"
                and partition):
            # the loss, not a cache: the aux loss's means are global
            part = partition_for(cfg, mesh, rules, p_spec, reduce_axes)
        if part is not None:
            def loss_of(params, batch):
                return part.loss(params, batch)[0]
        else:
            # an MoE's aux loss over the global batch, as in the train
            # step (a product of the rank's means would not be)
            loss_fn = registry.loss_fn(cfg, batch_means(mesh, reduce_axes))

            def loss_of(params, batch):
                return loss_fn(gather(params, p_spec, mesh), batch)[0]

        def prefill(params, batch):
            with use_rules(rules), torch.no_grad():
                loss = loss_of(params, batch).float()
                all_reduce_mean([loss], reduce_axes, mesh)
            return loss

        out_sh = P()

    in_sh = (p_spec, b_spec)
    prefill.partition = part
    return StepBundle(prefill, in_sh, out_sh, (), (p_sds, b_sds), rules,
                      part is not None)


def _own_block(x: torch.Tensor, spec: PartitionSpec, mesh,
               entry) -> torch.Tensor:
    """This rank's block of a result computed for its own batch rows:
    its other split dimensions narrowed (a copy only where one is)."""
    dims = _non_batch_dims(spec, mesh, entry)
    return block_view(x, spec, mesh, dims).clone() if dims else x


# ------------------------------------------------------------------ decode
def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeSpec) -> StepBundle:
    """The transformers and the hybrid under role 'tp' decode on blocks
    (``models.partition``, ``decoding=True``): the bundle gathers no
    whole parameter (an MoE's experts aside), no whole sequence of the
    cache and no whole Mamba state leaf, updates the rank's cache and
    state blocks in place and returns the rank's rows of the token.
    Every other config (xLSTM, Whisper, a ring cache) and a mesh of one
    rank gather the parameters and the cache's sequence whole."""
    # decode always uses TP weight sharding (sp=False, role='tp')
    rules = rules_for_mesh(mesh, sp=False, role="tp")
    if not cfg.decode_batch_shard:
        # the cache only fits when cache_seq takes both mesh axes; the
        # batch stays replicated
        rules = AxisRules(dict(rules.rules, batch=None),
                          rules.axis_sizes, rules.mesh)
    defs = registry.param_defs(cfg)
    p_sds = sds_tree(defs, cfg.dtype)
    p_spec = spec_tree(defs, rules)
    fam = registry.family(cfg)

    cache_sds = state_sds(cfg, shape)
    b, l = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        cache_spec = fam.state_specs(cfg, b, l, l, rules)
    else:
        cache_spec = fam.state_specs(cfg, b, l, rules)
    tok_sds = torch.empty((b, 1), dtype=torch.int32, device="meta")
    tok_spec = rules.spec(("batch", None), (b, 1))
    entry = _rows_axes_entry(rules, b)
    c_specs = tree_util.leaves(cache_spec, is_leaf=is_spec)
    part = None
    if (cfg.family in ("dense", "vlm", "moe", "hybrid")
            and cfg.model_axis_role == "tp"):
        part = partition_for(cfg, mesh, rules, p_spec, spec_axes(tok_spec),
                             decoding=True)
    if part is not None:
        part.decode_cache(cache_spec)

        def serve_step(params, token, cache, index):
            """``cache`` (this rank's blocks) is updated in place;
            ``index`` is a host int."""
            with use_rules(rules), torch.no_grad():
                logits, cache = fam.decode_fn(cfg, params, token, cache,
                                              index, part)
                next_token = part.greedy(logits)[:, None]
            return next_token, cache
    else:
        def serve_step(params, token, cache, index):
            """``cache`` (this rank's blocks) is updated in place;
            ``index`` is a host int."""
            with use_rules(rules), torch.no_grad():
                full = gather(params, p_spec, mesh)
                blocks, treedef = tree_util.flatten(cache)
                dims = [_non_batch_dims(s, mesh, entry) for s in c_specs]
                rows = [gather_leaf(x, s, mesh, d) if d else x
                        for x, s, d in zip(blocks, c_specs, dims)]
                logits, rows_out = fam.decode_fn(
                    cfg, full, token, tree_util.unflatten(treedef, rows),
                    index)
                for x, r, s, d in zip(blocks, tree_util.leaves(rows_out),
                                      c_specs, dims):
                    if d:
                        x.copy_(block_view(r, s, mesh, d))
                next_token = torch.argmax(logits[:, -1], dim=-1)[:, None]
            return next_token, cache

    in_sh = (p_spec, tok_spec, cache_spec, P())
    out_sh = (tok_spec, cache_spec)
    input_sds = (p_sds, tok_sds, cache_sds, _meta_scalar())
    serve_step.partition = part
    return StepBundle(serve_step, in_sh, out_sh, (2,), input_sds, rules,
                      part is not None)


def build_step(cfg: ModelConfig, mesh, shape: ShapeSpec, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape)
    return build_serve_step(cfg, mesh, shape)
