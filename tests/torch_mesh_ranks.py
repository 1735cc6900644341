"""Rank programs for the port's mesh tests (``tests/test_torch_mesh.py``).

Each function runs in one spawned process of
``repro_torch.launch.mesh.run_ranks`` (the default group already
started over gloo), imports only torch and ``repro_torch``, and returns
numpy values for the test process to hold against the reference.
"""

from __future__ import annotations

import contextlib
import math
import os
from unittest import mock

import numpy as np
import torch

from repro_torch import tree as tree_util

ARCH = "h2o-danube-1.8b"
SEQ, BATCH = 32, 4
DECODE_STEPS = 4
ADAFACTOR_STEPS = 2


def _np_tree(tree):
    return [x.detach().float().numpy().copy() for x in tree_util.leaves(tree)]


def _data(cfg, batch=BATCH):
    from repro_torch.data.synthetic import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=batch)


def _mesh_counts():
    from repro_torch.perfcount import MESH
    return MESH.snapshot()


def trainer_ranks(rank, world, shape, axes, ref_params, steps, lr):
    """The ``Trainer`` and the ``spmd`` session with mesh rules (SP, TP
    role) on ``shape``: momentum, DSSP [1, 3], the reference's initial
    parameters.  Returns the losses, delays and (rank 0) the gathered
    parameters of each, and the mesh counters."""
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import gather, make_mesh, place
    from repro_torch.launch.train import Trainer
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.models.sharding import rules_for_mesh
    from repro_torch.perfcount import MESH

    mesh = make_mesh(shape, axes)
    cfg = get_smoke_config(ARCH)
    rules = rules_for_mesh(mesh, sp=True, role="tp")
    full = from_numpy_tree(ref_params, "cpu")
    out = {}
    MESH.reset()
    t = Trainer(cfg, _data(cfg), sync="dssp", s_lower=1, s_upper=3, lr=lr,
                optimizer="momentum", device="cpu", rules=rules)
    t.params = place(full, t.param_specs, mesh)
    log = t.train(steps)
    whole = gather(t.params, t.param_specs, mesh)
    out["trainer"] = {"losses": log.losses, "delays": log.delays,
                      "params": _np_tree(whole) if rank == 0 else None,
                      "block_shapes": [tuple(x.shape) for x in
                                       tree_util.leaves(t.params)]}
    out["mesh_counts"] = _mesh_counts()

    spec = api.RunSpec(
        model=api.ModelSpec(arch=ARCH),
        data=api.DataSpec(seq_len=SEQ, global_batch=BATCH),
        optimizer=api.OptimizerSpec(name="momentum", lr=lr),
        sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=3))
    with api.build_session(spec, device="cpu", rules=rules) as session:
        session.start()
        # a fresh copy: place keeps unsplit leaves as they are, and the
        # Trainer above updated those in place
        session.trainer.params = place(from_numpy_tree(ref_params, "cpu"),
                                       session.trainer.param_specs, mesh)
        m = session.run(steps)
        whole = gather(session.trainer.params, session.trainer.param_specs,
                       mesh)
    out["session"] = {"losses": session.trainer.log.losses,
                      "final_loss": m["final_loss"],
                      "params": _np_tree(whole) if rank == 0 else None}
    return out


def bundle_ranks(rank, world, shape, axes, ref_params, delays, lr, accum):
    """``build_train_step`` on ``shape`` (the config's rules: DP role,
    TP attention), momentum with damping, ``grad_accum=accum``, explicit
    delays; then ``build_prefill_step`` and one ``build_serve_step``
    token from its cache.  Returns losses, the gathered parameters, the
    prefill's tokens and gathered cache, the decoded tokens (rank 0)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import dssp_spmd
    from repro_torch.data.synthetic import batches
    from repro_torch.launch.mesh import gather, make_mesh, place
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step,
                                          build_train_step)
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.api.session import batch_tensors

    mesh = make_mesh(shape, axes)
    cfg = get_smoke_config(ARCH).scaled(grad_accum=accum)
    full = from_numpy_tree(ref_params, "cpu")
    opt = make_optimizer("momentum", lr, staleness_damping=True)
    bundle = build_train_step(cfg, mesh, ShapeSpec("smoke", SEQ, BATCH,
                                                   "train"),
                              sync="dssp", s_upper=3, optimizer=opt)
    p_sh, o_sh, pipe_sh, b_sh, _ = bundle.in_shardings
    params = place(full, p_sh, mesh)
    state = opt.init(params)
    pipe = dssp_spmd.init_pipeline(params, 4)
    it = batches(cfg, _data(cfg))
    losses = []
    for d in delays:
        batch = place(batch_tensors(next(it), "cpu"), b_sh, mesh)
        params, state, pipe, m = bundle.fn(params, state, pipe, batch, d)
        losses.append(float(m["loss"]))
    whole = gather(params, p_sh, mesh)

    # adafactor, whose update reads whole leaves (RMS, factored moments):
    # the gathered leaves are updated and each rank keeps its blocks
    ada = make_optimizer("adafactor", lr)
    abundle = build_train_step(get_smoke_config(ARCH), mesh,
                               ShapeSpec("smoke", SEQ, BATCH, "train"),
                               sync="bsp", optimizer=ada)
    a_sh, ao_sh, _, ab_sh, _ = abundle.in_shardings
    aparams = place(from_numpy_tree(ref_params, "cpu"), a_sh, mesh)
    astate = ada.init(aparams)
    it = batches(cfg, _data(cfg))
    for _ in range(ADAFACTOR_STEPS):
        batch = place(batch_tensors(next(it), "cpu"), ab_sh, mesh)
        aparams, astate, _, _ = abundle.fn(aparams, astate, (), batch, 0)
    ada_whole = gather(aparams, a_sh, mesh)
    ada_state = gather(astate, ao_sh, mesh)

    # prefill and decode from the reference's initial weights (a fresh
    # copy: the train steps updated the unsplit leaves of ``full``)
    full = from_numpy_tree(ref_params, "cpu")
    pcfg = get_smoke_config(ARCH)
    pre = build_prefill_step(pcfg, mesh, ShapeSpec("p", SEQ, BATCH,
                                                   "prefill"))
    tokens = torch.from_numpy(
        np.random.RandomState(7).randint(0, pcfg.vocab_size,
                                         (BATCH, SEQ))).long()
    pp = place(full, pre.in_shardings[0], mesh)
    pb = place({"tokens": tokens, "labels": tokens}, pre.in_shardings[1],
               mesh)
    tok, cache = pre.fn(pp, pb)
    tok_all = gather(tok, pre.out_shardings[0], mesh)
    cache_all = gather(cache, pre.out_shardings[1], mesh)

    # DECODE_STEPS greedy tokens from an empty cache, on the mesh
    serve = build_serve_step(pcfg, mesh, ShapeSpec("d", SEQ, BATCH,
                                                   "decode"))
    sp, stok_sh, cache_sh, _ = serve.in_shardings
    cache = place(tree_util.tree_map(
        lambda m: torch.zeros(m.shape, dtype=m.dtype), serve.input_sds[2]),
        cache_sh, mesh)
    sparams = place(full, sp, mesh)
    tok = place(tokens[:, :1].clone(), stok_sh, mesh)
    decoded = []
    for index in range(DECODE_STEPS):
        tok, cache = serve.fn(sparams, tok, cache, index)
        decoded.append(gather(tok, stok_sh, mesh).numpy())
    return {"losses": losses,
            "params": _np_tree(whole) if rank == 0 else None,
            "adafactor": {"params": _np_tree(ada_whole),
                          "state": _np_tree(ada_state)}
            if rank == 0 else None,
            "adafactor_blocks": [tuple(x.shape) for x in
                                 tree_util.leaves(astate)],
            "prefill_tokens": tok_all.numpy(),
            "prefill_cache": {k: v.float().numpy()
                              for k, v in cache_all.items()},
            "decoded": decoded,
            "decode_cache": {k: v.float().numpy() for k, v in
                             gather(cache, cache_sh, mesh).items()},
            "cache_blocks": {k: tuple(v.shape) for k, v in cache.items()}}


def cross_pod_ranks(rank, world, x, w_true_seed):
    """(a) ``cross_pod_sync`` of per-pod blocks ``x[pod]`` on a
    (2, 1, 2) (pod, data, model) mesh; (b) the reference's local-SGD
    scenario (``tests/test_cross_pod.py``) with per-pod replicas, k from
    ``DsspScheduleController.period``."""
    from repro_torch.core.dssp_spmd import (DsspScheduleController,
                                            cross_pod_sync, local_sgd_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import PartitionSpec as P

    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    pod = mesh.get_local_rank("pod")
    synced = cross_pod_sync(torch.from_numpy(x[pod]).clone(), mesh,
                            P("pod", None, None)).numpy()

    rng = np.random.RandomState(w_true_seed)
    w_true = rng.randn(16, 1).astype(np.float32)
    X = rng.randn(512, 16).astype(np.float32)
    Y = X @ w_true
    xb = torch.from_numpy(X.reshape(2, 256, 16)[pod])   # this pod's rows
    yb = torch.from_numpy(Y.reshape(2, 256, 1)[pod])
    w = torch.zeros(16, 1)

    def loss(w, x, y):
        return torch.mean((x @ w - y) ** 2)

    def train_step(params, opt_state, pipeline, batch, delay):
        # the reference differentiates the mean over both pods' rows:
        # each replica's gradient is its pod's mean over the pod count
        w = params.detach().requires_grad_()
        g, = torch.autograd.grad(loss(w, *batch) / 2, w)
        with torch.no_grad():
            params.sub_(0.1 * g)
        return params, opt_state, pipeline, {}

    from repro_torch.launch.mesh import all_gather_cat, all_reduce_mean
    drifted, synced_equal, periods = [], [], []

    def replicas_equal(t):
        both = all_gather_cat(t[None], mesh.get_group("pod"), 0)
        return bool(torch.equal(both[0], both[1]))

    def sync(t):
        drifted.append(not replicas_equal(t))     # before the average
        t = cross_pod_sync(t, mesh, P("pod", None, None))
        synced_equal.append(replicas_equal(t))
        return t

    step = local_sgd_step(train_step, sync)

    def global_loss(w):
        mine = loss(w, xb, yb).reshape(1)
        all_reduce_mean([mine], ("pod",), mesh)
        return float(mine)

    ctrl = DsspScheduleController(1, 4)
    l0 = global_loss(w)
    for _ in range(12):
        k = ctrl.period([1.0, 1.3])       # pod step-time telemetry
        periods.append(k)
        for i in range(k):
            w, _, _, _ = step(w, (), (), (xb, yb), 0, i == k - 1)
    return {"synced": synced, "l0": l0, "l1": global_loss(w),
            "periods": periods, "synced_equal": synced_equal,
            "drifted": drifted, "pod": pod}


def pipeline_ranks(rank, world):
    """The reference's 8-device ring semantics
    (``tests/test_distributed.py``): a depth-3 ring whose buffer is split
    over 'data', 4 ranks; each rank's block of the delayed gradients."""
    from repro_torch.core import dssp_spmd
    from repro_torch.launch.mesh import gather, make_mesh, place
    from repro_torch.models.sharding import PartitionSpec as P

    mesh = make_mesh((4,), ("data",))
    spec = {"w": P("data", None)}
    st = dssp_spmd.init_pipeline({"w": torch.zeros(16, 8)}, depth=3)
    pipe_spec = dssp_spmd.pipeline_specs(spec, 3)
    st = place(st, pipe_spec, mesh)
    outs = []
    for t in range(4):
        g = place({"w": torch.full((16, 8), float(t + 1))}, spec, mesh)
        out, valid, st = dssp_spmd.push_pop(st, g, 2)
        whole = gather(out, spec, mesh)["w"]
        outs.append((float(whole[0, 0]), float(valid),
                     tuple(out["w"].shape), bool(torch.all(
                         whole == whole[0, 0]))))
    return outs


def rescale_ranks(rank, world, ref_params):
    """Params placed on a (2, 2) mesh, gathered, then rescaled to 2
    ranks (``rescale_params``, model_parallel 2): the new mesh's gathered
    values (ranks 0-1), the blocks' shapes on both meshes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.elastic import rescale_params
    from repro_torch.launch.mesh import gather, make_mesh, place
    from repro_torch.models import registry
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.models.sharding import rules_for_mesh

    cfg = get_smoke_config(ARCH)
    full = from_numpy_tree(ref_params, "cpu")
    mesh4 = make_mesh((2, 2), ("data", "model"))
    spec4 = registry.param_specs(cfg, rules_for_mesh(mesh4))
    p4 = place(full, spec4, mesh4)
    back = gather(p4, spec4, mesh4)
    p2, mesh2 = rescale_params(cfg, back, 2, model_parallel=2)
    out = {"shape2": tuple(mesh2.shape), "in_mesh2": p2 is not None,
           "blocks4": [tuple(x.shape) for x in tree_util.leaves(p4)]}
    if p2 is not None:
        spec2 = registry.param_specs(cfg, rules_for_mesh(mesh2))
        out["values"] = _np_tree(gather(p2, spec2, mesh2))
        out["blocks2"] = [tuple(x.shape) for x in tree_util.leaves(p2)]
    return out


def cross_pod_cuda_ranks(rank, world, x):
    """``cross_pod_sync`` of this pod's block ``x[pod]`` on the card over
    a (2, 1, 1) (pod, data, model) mesh of two gloo ranks."""
    from repro_torch.core.dssp_spmd import cross_pod_sync
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import PartitionSpec as P

    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    block = torch.from_numpy(x[mesh.get_local_rank("pod")]).to("cuda:0")
    out = cross_pod_sync(block, mesh, P("pod", None, None))
    return {"device": out.device.type, "synced": out.cpu().numpy()}


PARTITION_ARCHS = ("qwen1.5-32b", "chameleon-34b")
#: MoE archs, their ``moe_chunk`` and attention modes: deepseek's chunks
#: of 8 lie within every sequence block (each rank routes its own),
#: qwen3-moe's 256 span the whole sequence (each rank routes the
#: gathered sequence); under TP every rank routes the whole sequence
PARTITION_MOE = (("deepseek-moe-16b", 8, ("sp", "tp")),
                 ("qwen3-moe-235b-a22b", 256, ("sp",)))
PARTITION_DELAYS = (0, 1, 2)


def _stacked_whole_shapes(cfg, p_spec, mesh, layer_blocks=False,
                          gathered=False):
    """The shapes of the layer-stacked leaves that the mesh splits, but
    for those that are also some leaf's block (a block of wq can have
    the whole wk's shape) or, with ``layer_blocks``, one layer of one
    (a layer of deepseek's smoke expert block on (1, 4) has the whole
    stacked shared experts' shape) or, with ``gathered``, one layer of
    one gathered over 'data' (a layer of the hybrid smoke's expert
    block on (2, 2), gathered, has the whole stacked dense MLP's
    shape)."""
    from repro_torch.launch.mesh import block_view, split_dims
    from repro_torch.models import registry
    from repro_torch.models.sharding import PartitionSpec, is_spec
    defs = tree_util.leaves(registry.param_defs(cfg))
    specs = tree_util.leaves(p_spec, is_leaf=is_spec)
    blocks = {tuple(block_view(torch.empty(d.shape, device="meta"), s,
                               mesh).shape) for d, s in zip(defs, specs)}
    if layer_blocks:
        blocks |= {b[1:] for b in blocks}
    if gathered:
        def model_only(spec):
            return PartitionSpec(*[None if e == "data" else e
                                   for e in spec])
        blocks |= {tuple(block_view(torch.empty(d.shape, device="meta"),
                                    model_only(s), mesh).shape)[1:]
                   for d, s in zip(defs, specs)}
    key = "slots" if cfg.family == "hybrid" else "layers"
    layer_defs = tree_util.leaves(registry.param_defs(cfg)[key])
    layer_specs = tree_util.leaves(p_spec[key], is_leaf=is_spec)
    return {tuple(d.shape) for d, s in zip(layer_defs, layer_specs)
            if split_dims(s, mesh)} - blocks


def _allocations(watch, seen, writes=True):
    """A dispatch mode that appends ``(op, shape)`` to ``seen`` for every
    tensor an op that is not a view returns whose shape is in
    ``watch``; with ``writes=False`` not for an op that writes into a
    tensor it was given either (``copy_``: it returns that tensor)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Allocations(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:         # a view of a block allocates nothing
                return out
            if not writes and func._schema.is_mutable:
                return out
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and tuple(t.shape) in watch:
                    seen.append((str(func), tuple(t.shape)))
            return out

    return Allocations()


def _step_run(mesh, cfg, init, lr, partition, watch=False):
    """Three DSSP steps of ``build_train_step`` (damped momentum) from
    ``init``; with ``watch``, every tensor the steps allocate whose shape
    is that of a whole layer-stacked leaf the mesh splits."""
    from repro_torch.api.session import batch_tensors
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import dssp_spmd
    from repro_torch.data.synthetic import batches
    from repro_torch.launch.mesh import gather, place
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.perfcount import MESH

    seen = []
    opt = make_optimizer("momentum", lr, staleness_damping=True)
    bundle = build_train_step(cfg, mesh, ShapeSpec("smoke", SEQ, BATCH,
                                                   "train"),
                              sync="dssp", s_upper=3, optimizer=opt,
                              partition=partition)
    p_sh, _, _, b_sh, _ = bundle.in_shardings
    watch_ = watch
    watch = _stacked_whole_shapes(cfg, p_sh, mesh,
                                  gathered=cfg.family == "hybrid")
    params = place(from_numpy_tree(init, "cpu"), p_sh, mesh)
    state = opt.init(params)
    pipe = dssp_spmd.init_pipeline(params, 4)
    it = batches(cfg, _data(cfg))
    losses, counts = [], []
    for d in PARTITION_DELAYS:
        batch = place(batch_tensors(next(it), "cpu"), b_sh, mesh)
        MESH.reset()
        with (_allocations(watch, seen) if watch
              else contextlib.nullcontext()):
            params, state, pipe, m = bundle.fn(params, state, pipe, batch, d)
        counts.append(MESH.snapshot())
        losses.append(float(m["loss"]))
    return {"losses": losses, "counts": counts, "allocated": seen,
            "watched": sorted(watch) if watch_ else None,
            "partitioned": bundle.partitioned,
            "params": _np_tree(gather(params, p_sh, mesh))}


def partition_ranks(rank, world, meshes, inits, lr):
    """The partitioned train step (``models.partition``) on each of
    ``meshes`` (``(label, shape, axes, whole, moe)``; every mesh over
    the same four ranks) for each arch of ``PARTITION_ARCHS`` under SP
    and TP rules, each over ``PARTITION_DELAYS`` DSSP steps with
    ``grad_accum=2`` and ``remat="full"``; with ``whole``, the
    gather-whole step too, the allocations of both watched; with
    ``moe``, each of ``PARTITION_MOE`` in its modes (and gather-whole
    too with ``whole``).  Returns, per mesh and (arch, sp), losses,
    gathered parameters (rank 0), per-step mesh counts, and the
    allocations of whole layer-stacked leaves seen in the steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for label, shape, axes, whole, moe in meshes:
        mesh = make_mesh(shape, axes)
        for arch in PARTITION_ARCHS:
            for sp in (True, False):
                cfg = get_smoke_config(arch).scaled(
                    sequence_parallel=sp, grad_accum=2, remat="full")
                rec = {"run": _step_run(mesh, cfg, inits[arch], lr, True,
                                        watch=whole)}
                if whole:
                    rec["whole"] = _step_run(mesh, cfg, inits[arch], lr,
                                             False, watch=True)
                if rank != 0:
                    for r in rec.values():
                        r["params"] = None
                out[f"{label}/{arch}/{'sp' if sp else 'tp'}"] = rec
        for arch, chunk, modes in PARTITION_MOE if moe else ():
            for sp in (mode == "sp" for mode in modes):
                cfg = get_smoke_config(arch).scaled(
                    sequence_parallel=sp, grad_accum=2, remat="full",
                    moe_chunk=chunk)
                rec = {"run": _step_run(mesh, cfg, inits[arch], lr, True)}
                if whole:
                    rec["whole"] = _step_run(mesh, cfg, inits[arch], lr,
                                             False)
                if rank != 0:
                    for r in rec.values():
                        r["params"] = None
                out[f"{label}/{arch}/{'sp' if sp else 'tp'}"] = rec
    return out


#: the decode cells whose counts the dry run is held to: the batch
#: replicated and the cache's sequence over both axes, and the batch,
#: the heads and the K/V heads split beside an MoE
DECODE_COUNT_ARCHS = ("qwen1.5-32b", "deepseek-moe-16b")


def dryrun_count_ranks(rank, world, seq, batch):
    """One DSSP step (delay 1, the config's optimizer) of
    ``build_train_step`` on (2, 2) for qwen1.5-32b's, h2o-danube's and
    Jamba's smoke configs, qwen1.5-32b's ``build_prefill_step`` and the
    ``build_serve_step`` of each of ``DECODE_COUNT_ARCHS`` and Jamba: the
    ``perfcount.MESH`` counts of each (what ``launch.dryrun`` predicts
    for the same cell), the prefill's under ``"prefill"``, a decode's
    under ``"decode/<arch>"``, and Jamba's calls of the kernel
    registry's ``ssm_scan`` (``"ssm_scan"``)."""
    from repro_torch.api.session import batch_tensors
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import dssp_spmd
    from repro_torch.data.synthetic import batches
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step)
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.perfcount import MESH
    from repro_torch.kernels import registry as kreg
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    scans = []
    scan = kreg.ssm_scan

    def counted(*a, **kw):
        scans.append(1)
        return scan(*a, **kw)

    for arch in ("qwen1.5-32b", "h2o-danube-1.8b", HYBRID_ARCH):
        cfg = get_smoke_config(arch)
        bundle = build_train_step(cfg, mesh, ShapeSpec("train", seq, batch,
                                                       "train"))
        p_sh, _, _, b_sh, _ = bundle.in_shardings
        params = place(registry.init_params(cfg, seed=0, device="cpu"),
                       p_sh, mesh)
        opt = make_optimizer(cfg.optimizer, 3e-4)
        state = opt.init(params)
        pipe = dssp_spmd.init_pipeline(params, 2)
        rows = place(batch_tensors(next(batches(cfg, _data(cfg, batch))),
                                   "cpu"), b_sh, mesh)
        MESH.reset()
        scans.clear()
        with mock.patch.object(kreg, "ssm_scan", counted):
            bundle.fn(params, state, pipe, rows, 1)
        out[arch] = dict(MESH.snapshot(), ssm_scan=len(scans))
    cfg = get_smoke_config("qwen1.5-32b")
    pre = build_prefill_step(cfg, mesh, ShapeSpec("prefill", seq, batch,
                                                  "prefill"))
    params = place(registry.init_params(cfg, seed=0, device="cpu"),
                   pre.in_shardings[0], mesh)
    tokens = torch.zeros((batch, seq), dtype=torch.long)
    rows = place({"tokens": tokens, "labels": tokens}, pre.in_shardings[1],
                 mesh)
    MESH.reset()
    pre.fn(params, rows)
    out["prefill"] = dict(MESH.snapshot(), partitioned=pre.partitioned)
    for arch in DECODE_COUNT_ARCHS + (HYBRID_ARCH,):
        cfg = get_smoke_config(arch)
        dec = build_serve_step(cfg, mesh, ShapeSpec("decode", seq, batch,
                                                    "decode"))
        p_sh, tok_sh, c_sh, _ = dec.in_shardings
        params = place(registry.init_params(cfg, seed=0, device="cpu"),
                       p_sh, mesh)
        cache = place(registry.family(cfg).init_state(cfg, batch, seq),
                      c_sh, mesh)
        token = place(torch.zeros((batch, 1), dtype=torch.long), tok_sh,
                      mesh)
        MESH.reset()
        # the dry run decodes at the cache's last slot
        dec.fn(params, token, cache, seq - 1)
        out[f"decode/{arch}"] = dict(MESH.snapshot(),
                                     partitioned=dec.partitioned)
    return out


def collective_branch_ranks(rank, world):
    """``all_gather_cat`` and ``reduce_scatter_cat`` along dims 0, 1 and
    2 of a (4, 8, 12) tensor whose values name the rank, through the
    gloo groups' branch (the host exchange) and through the
    single-tensor branch (NCCL's on the
    card), the latter driven here by list-based equivalents of
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` with their
    flat semantics (rank r's chunk is the r-th of the flattened
    buffer)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    def all_gather_into(out, src, group=None):
        n = dist.get_world_size(group)
        dist.all_gather(list(out.view(n, -1).unbind(0)),
                        src.contiguous().view(-1), group=group)

    def reduce_scatter(out, src, group=None):
        full = src.contiguous().clone()
        dist.all_reduce(full, group=group)
        n = dist.get_world_size(group)
        out.copy_(full.view(n, -1)[dist.get_rank(group)].view_as(out))

    x = (torch.arange(4 * 8 * 12, dtype=torch.float32).view(4, 8, 12)
         + 1000.0 * rank)
    out = {}
    for branch in ("gloo", "single"):
        saved = (mesh_lib._gloo, mesh_lib._ALL_GATHER,
                 mesh_lib._REDUCE_SCATTER)
        if branch == "single":
            mesh_lib._gloo = lambda group: False
            mesh_lib._ALL_GATHER = all_gather_into
            mesh_lib._REDUCE_SCATTER = reduce_scatter
        try:
            out[branch] = {
                dim: (mesh_lib.all_gather_cat(x, None, dim).numpy(),
                      mesh_lib.reduce_scatter_cat(x, None, dim).numpy())
                for dim in (0, 1, 2)}
        finally:
            (mesh_lib._gloo, mesh_lib._ALL_GATHER,
             mesh_lib._REDUCE_SCATTER) = saved
    return out


#: the mesh Trainer's compression and checkpoint cases
#: (``tests/test_torch_mesh_trainer.py``): qwen1.5-32b's f32 smoke
#: config (partitioned on every mesh) under SP rules, damped momentum,
#: DSSP [1, 3]
TRAINER_ARCH = "qwen1.5-32b"
TRAINER_STEPS = 3
RESUMED_STEPS = 2
COMPRESSORS = ("int8", "topk")


def _mesh_trainer(cfg, mesh, init, lr, **kw):
    from repro_torch.launch.mesh import place
    from repro_torch.launch.train import Trainer
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.models.sharding import rules_for_mesh
    t = Trainer(cfg, _data(cfg), sync="dssp", s_lower=1, s_upper=3, lr=lr,
                optimizer="momentum", device="cpu",
                rules=rules_for_mesh(mesh, sp=True, role="tp"), **kw)
    if init is not None:
        t.params = place(from_numpy_tree(init, "cpu"), t.param_specs, mesh)
    return t


def _state_np(trainer, mesh):
    """The trainer's whole state (params, optimizer, ring) as numpy
    (every rank gathers)."""
    from repro_torch.launch.mesh import gather
    specs, _ = trainer._mesh_state()
    return [np.asarray(x.detach().numpy()).copy() for x in tree_util.leaves(
        gather(trainer._state(), specs, mesh))]


def _compress_blocks(mesh, sds, specs, seed):
    """Leaves of the params' shapes with many ties (values on a grid of
    1/8), placed in blocks under ``specs`` and compressed on the mesh
    (``launch.steps.block_reducers``), then gathered; against each
    compressor's one-device apply on the whole leaves: per compressor,
    the largest distances of the decoded leaves and of the new error,
    and how many kept (non-zero) masks differ."""
    from repro_torch.launch.mesh import gather, place
    from repro_torch.launch.steps import block_reducers
    from repro_torch.models.sharding import is_spec
    from repro_torch.optim.compression import make_compressor
    sp = tree_util.leaves(specs, is_leaf=is_spec)
    rng = np.random.RandomState(seed)
    out = {}
    for name in COMPRESSORS:
        comp = make_compressor(name)
        grads = tree_util.tree_map(
            lambda s: torch.from_numpy(np.round(rng.randn(*s.shape) * 8)
                                       .astype(np.float32) / 8), sds)
        err = tree_util.tree_map(
            lambda x: torch.from_numpy(rng.randn(*x.shape)
                                       .astype(np.float32) / 64), grads)
        want_g, want_e = comp.apply(grads, err)
        got_g, got_e = comp.apply(place(grads, specs, mesh),
                                  place(err, specs, mesh),
                                  block_reducers(sp, mesh))
        got_g, got_e = gather(got_g, specs, mesh), gather(got_e, specs, mesh)
        pairs = list(zip(tree_util.leaves(got_g), tree_util.leaves(want_g),
                         tree_util.leaves(got_e), tree_util.leaves(want_e)))
        out[name] = {
            "decoded": max(float((a - b).abs().max()) for a, b, _, _ in pairs),
            "error": max(float((c - d).abs().max()) for _, _, c, d in pairs),
            "masks_differ": sum(int(not torch.equal(a != 0, b != 0))
                                for a, b, _, _ in pairs),
            "kept": sum(int((b != 0).sum()) for _, b, _, _ in pairs)}
    return out



def mesh_trainer_ranks(rank, world, meshes, init, lr, ref_dir, out_dir,
                       torn_dir):
    """The mesh ``Trainer`` (``TRAINER_ARCH``) on each of ``meshes``
    (``(label, shape, axes)``): (a) with each of ``COMPRESSORS``,
    ``TRAINER_STEPS`` steps from ``init``: losses, delays, gathered
    params (rank 0); the block compressors against the one-device ones
    on leaves of the params' shapes; (b) on the first mesh only,
    resumed from the reference's checkpoint in ``ref_dir``: its gathered
    state, then ``RESUMED_STEPS`` more steps saved to ``out_dir``: the
    gathered state again (rank 0); (c) on the first mesh, resumed from
    ``torn_dir``, a save torn between its two renames: the step resumed,
    the gathered state (rank 0), the folder's entries after, and how
    often the rank tidied the folder (``CheckpointManager._gc_tmp``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import gather, make_mesh, open_checkpoints
    from repro_torch.models import registry
    from repro_torch.models.sharding import rules_for_mesh
    cfg = get_smoke_config(TRAINER_ARCH)
    out = {}
    for label, shape, axes in meshes:
        mesh = make_mesh(shape, axes)
        for name in COMPRESSORS:
            t = _mesh_trainer(cfg, mesh, init, lr, compressor=name)
            log = t.train(TRAINER_STEPS)
            whole = _np_tree(gather(t.params, t.param_specs, mesh))
            out[f"{label}/{name}"] = {
                "losses": log.losses, "delays": log.delays,
                "err_blocks": [tuple(e.shape) for e in
                               tree_util.leaves(t.err_state)],
                "param_blocks": [tuple(p.shape) for p in
                                 tree_util.leaves(t.params)],
                "params": whole if rank == 0 else None}
        out[f"{label}/blocks"] = _compress_blocks(
            mesh, registry.abstract_params(cfg), registry.param_specs(
                cfg, rules_for_mesh(mesh, sp=True, role="tp")), 7)
    label, shape, axes = meshes[0]
    mesh = make_mesh(shape, axes)
    t = _mesh_trainer(cfg, mesh, None, lr, checkpoint_dir=ref_dir)
    assert t.resume()
    state = _state_np(t, mesh)
    resumed = {"step": t.step_idx, "state": state if rank == 0 else None}
    t.ckpt = open_checkpoints(out_dir, mesh)
    log = t.train(RESUMED_STEPS)
    state = _state_np(t, mesh)
    out["checkpoint"] = {"resumed": resumed, "losses": log.losses,
                         "step": t.step_idx,
                         "state": state if rank == 0 else None}
    with mock.patch.object(CheckpointManager, "_gc_tmp", autospec=True,
                           side_effect=CheckpointManager._gc_tmp) as tidy:
        t = _mesh_trainer(cfg, mesh, None, lr, checkpoint_dir=torn_dir)
    assert t.resume()
    state = _state_np(t, mesh)
    out["torn"] = {"step": t.step_idx, "state": state if rank == 0 else None,
                   "entries": sorted(os.listdir(torn_dir)),
                   "tidied": tidy.call_count}
    return out


#: prefill on blocks (``tests/test_torch_prefill_partition.py``): the
#: int8 cache and QKV bias, the MoE with shared experts (its chunks of
#: 8 within every sequence block)
PREFILL_ARCHS = (("qwen1.5-32b", 0), ("deepseek-moe-16b", 8))


def prefill_cfg(arch, chunk, sp):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch).scaled(sequence_parallel=sp)
    return cfg.scaled(moe_chunk=chunk) if chunk else cfg


def _block_slices(shape, spec, mesh):
    """This rank's block of a tensor of ``shape`` under ``spec``: one
    (start, stop) per dimension."""
    from repro_torch.launch.mesh import block_view
    idx = torch.arange(math.prod(shape)).view(shape)
    blk = block_view(idx, spec, mesh)
    starts = np.unravel_index(int(blk.reshape(-1)[0]), shape)
    return [(int(a), int(a) + blk.shape[d]) for d, a in enumerate(starts)]


def prefill_ranks(rank, world, meshes, inits, tokens):
    """``build_prefill_step`` on each of ``meshes`` for each of
    ``PREFILL_ARCHS`` under SP and TP rules (f32 smoke configs, the
    score budget cut so that the queries go in chunks of 2): per case
    the partitioned flag, the rank's greedy tokens and cache blocks with
    their place in the whole cache, the mesh counts of the call, and
    the allocations of whole layer-stacked leaves it made."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import layers
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.models.sharding import is_spec
    from repro_torch.perfcount import MESH
    out = {}
    toks = torch.from_numpy(tokens).long()
    for label, shape, axes in meshes:
        mesh = make_mesh(shape, axes)
        for arch, chunk in PREFILL_ARCHS:
            for sp in (True, False):
                cfg = prefill_cfg(arch, chunk, sp)
                bundle = build_prefill_step(
                    cfg, mesh, ShapeSpec("p", SEQ, BATCH, "prefill"))
                p_sh, b_sh = bundle.in_shardings
                # two query rows a chunk at a rank's (rows, heads, keys)
                layers.NO_GRAD_SCORE_BYTES = (
                    2 * (BATCH // shape[0]) * cfg.n_heads * SEQ * 4)
                params = place(from_numpy_tree(inits[arch], "cpu"), p_sh,
                               mesh)
                batch = place({"tokens": toks, "labels": toks}, b_sh, mesh)
                watch = _stacked_whole_shapes(cfg, p_sh, mesh, True)
                seen = []
                MESH.reset()
                with _allocations(watch, seen):
                    tok, cache = bundle.fn(params, batch)
                counts = MESH.snapshot()
                cspec = bundle.out_shardings[1]
                whole = {k: (cfg.n_layers, BATCH, SEQ) + tuple(v.shape[3:])
                         for k, v in cache.items()}
                out[f"{label}/{arch}/{'sp' if sp else 'tp'}"] = {
                    "partitioned": bundle.partitioned,
                    "tokens": tok.numpy(),
                    "token_rows": _block_slices(
                        (BATCH,), bundle.out_shardings[0], mesh)[0],
                    "cache": {k: v.numpy() for k, v in cache.items()},
                    "cache_slices": {k: _block_slices(whole[k], cspec[k],
                                                      mesh)
                                     for k in cache},
                    "counts": counts, "allocated": seen,
                    "watched": sorted(watch)}
        layers.NO_GRAD_SCORE_BYTES = 1 << 30
    return out


#: decode on blocks (``tests/test_torch_decode_partition.py``): the int8
#: cache with QKV bias and a replicated batch (its sequence over both
#: axes), GQA with split heads, q/k norms and an MoE, shared experts with
#: split K/V heads
DECODE_ARCHS = ("qwen1.5-32b", "qwen1.5-110b", "qwen3-moe-235b-a22b",
                "deepseek-moe-16b")
#: the decode cache's slots (the prefill's SEQ, then room to decode, in
#: blocks of which a (1, 4) rank's last holds no written slot) and the
#: tokens decoded at positions SEQ, SEQ + 1, ...
DECODE_CACHE = 48
DECODE_TOKENS = 3


def decode_whole_cache(cfg, prefill):
    """The decode cache of ``DECODE_CACHE`` slots whose first ``SEQ``
    hold ``prefill`` (numpy leaves (layers, rows, SEQ, ...)), the rest
    zeros."""
    out = {}
    for k, v in prefill.items():
        whole = np.zeros(v.shape[:2] + (DECODE_CACHE,) + v.shape[3:],
                         dtype=v.dtype)
        whole[:, :, :v.shape[2]] = v
        out[k] = whole
    return out


def decode_ranks(rank, world, meshes, inits, prefills):
    """``build_serve_step`` on each of ``meshes`` for each of
    ``DECODE_ARCHS`` (f32 smoke configs): from the reference's prefill
    (``prefills[arch]``: its greedy tokens and cache), ``DECODE_TOKENS``
    greedy tokens at positions ``SEQ`` on.  Per case the partitioned
    flag, the rank's tokens of each call and their rows, the rank's
    cache blocks after the last call with their place in the whole
    cache, the mesh counts of each call, and the allocations of whole
    layer-stacked leaves or of a whole cache leaf (or one layer of one)
    the calls made."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.perfcount import MESH
    out = {}
    for label, shape, axes in meshes:
        mesh = make_mesh(shape, axes)
        for arch in DECODE_ARCHS:
            cfg = get_smoke_config(arch)
            bundle = build_serve_step(
                cfg, mesh, ShapeSpec("d", DECODE_CACHE, BATCH, "decode"))
            p_sh, tok_sh, c_sh, _ = bundle.in_shardings
            params = place(from_numpy_tree(inits[arch], "cpu"), p_sh, mesh)
            first, prefill = prefills[arch]
            whole = decode_whole_cache(cfg, prefill)
            cache = place({k: torch.from_numpy(v) for k, v in
                           whole.items()}, c_sh, mesh)
            token = place(torch.from_numpy(first).long()[:, None], tok_sh,
                          mesh)
            watch = _stacked_whole_shapes(cfg, p_sh, mesh, True)
            watch |= {v.shape for v in whole.values()}
            watch |= {v.shape[1:] for v in whole.values()}
            seen, tokens, counts = [], [], []
            for i in range(DECODE_TOKENS):
                MESH.reset()
                # the cache's slot is written in place: a (rows, heads,
                # head dim) write can have a stacked bias's shape
                with _allocations(watch, seen, writes=False):
                    token, cache = bundle.fn(params, token, cache, SEQ + i)
                counts.append(MESH.snapshot())
                tokens.append(token[:, 0].numpy().copy())
            out[f"{label}/{arch}"] = {
                "partitioned": bundle.partitioned,
                "tokens": tokens,
                "token_rows": _block_slices((BATCH,), tok_sh, mesh)[0],
                "cache": {k: v.numpy() for k, v in cache.items()},
                "cache_slices": {k: _block_slices(whole[k].shape, c_sh[k],
                                                  mesh)
                                 for k in cache},
                "counts": counts, "allocated": seen,
                "watched": sorted(watch)}
    return out


#: the hybrid's partition cases (``tests/test_torch_hybrid_partition.py``)
HYBRID_ARCH = "jamba-v0.1-52b"


def hybrid_cfg(sp):
    """Jamba's f32 smoke config (MoE with 4 experts, ``di`` 128) as the
    hybrid partition cases run it."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(HYBRID_ARCH).scaled(
        sequence_parallel=sp, grad_accum=2, remat="full")


def swap_w_in_ranges(part):
    """A planted fault: ``part`` takes ``w_in``'s ``z`` columns for
    ``xin`` and the reverse (the storage layout's trap)."""
    channels = part._channels

    def swapped(x):
        xin, z = channels(x).chunk(2, dim=-1)
        return torch.cat([z, xin], dim=-1)

    part._channels = swapped


def hybrid_partition_ranks(rank, world, meshes, init, lr, tokens, plant):
    """The hybrid's partitioned train step on each of ``meshes``
    (``(label, shape, axes)``, every mesh over the same four ranks)
    under SP and TP rules, each over ``PARTITION_DELAYS`` DSSP steps
    with ``grad_accum=2`` and ``remat="full"``, the allocations watched
    on (2, 2); on ``plant`` (a mesh label) the SP step once more with
    ``w_in``'s ranges swapped (``swap_w_in_ranges``); on (2, 2) the
    prefill's loss of ``tokens``, partitioned and gathered whole
    (``partition=False``).  Returns per case the ``_step_run`` record
    (parameters on rank 0 only) and the prefill values."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.models.params import from_numpy_tree
    out = {}
    for label, shape, axes in meshes:
        mesh = make_mesh(shape, axes)
        for sp in (True, False):
            cfg = hybrid_cfg(sp)
            rec = {"run": _step_run(mesh, cfg, init, lr, True,
                                    watch=label == "2x2")}
            if label == plant and sp:
                build = steps.build_train_step

                def planted(*a, **kw):
                    bundle = build(*a, **kw)
                    swap_w_in_ranges(bundle.fn.partition)
                    return bundle

                steps.build_train_step = planted
                try:
                    rec["planted"] = _step_run(mesh, cfg, init, lr, True)
                finally:
                    steps.build_train_step = build
            if rank != 0:
                for r in rec.values():
                    r["params"] = None
            out[f"{label}/{'sp' if sp else 'tp'}"] = rec
        if label == "2x2":
            cfg = hybrid_cfg(True)
            toks = torch.from_numpy(tokens).long()
            for partition in (True, False):
                bundle = steps.build_prefill_step(
                    cfg, mesh, ShapeSpec("p", SEQ, BATCH, "prefill"),
                    partition=partition)
                p_sh, b_sh = bundle.in_shardings
                params = place(from_numpy_tree(init, "cpu"), p_sh, mesh)
                batch = place({"tokens": toks, "labels": toks}, b_sh, mesh)
                out[f"prefill/{partition}"] = {
                    "partitioned": bundle.partitioned,
                    "loss": float(bundle.fn(params, batch))}
    return out


#: the hybrid's decode on blocks
#: (``tests/test_torch_hybrid_decode_partition.py``): the state's KV
#: slots and the tokens decoded from each start's index
HYBRID_DECODE_CACHE = 16
HYBRID_DECODE_TOKENS = 3


def _state_watch(state):
    """The shapes of a whole state leaf, of one group's and of one
    slot's (a Mamba leaf's groups and slots lead)."""
    out = set()
    for path, x in _np_paths(state):
        out |= {x.shape, x.shape[1:]}
        if path[0] == "mamba":
            out.add(x.shape[2:])
    return out


def _np_paths(tree, prefix=()):
    """(path, leaf) of a nested dict of arrays, keys sorted."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k in sorted(tree) for pl in _np_paths(tree[k],
                                                         prefix + (k,))]


def hybrid_decode_ranks(rank, world, cases, init, starts, plant):
    """``build_serve_step`` for Jamba's f32 smoke config on each of
    ``cases`` (``(label, shape, axes, batch)``, every mesh over the same
    four ranks), from each of ``starts[batch]`` (``{name: (first token,
    whole state as numpy, index)}``): ``HYBRID_DECODE_TOKENS`` greedy
    tokens from ``index`` on.  Per case and start the partitioned flag,
    the cache's sequence axes, the rank's tokens of each call and their
    rows, its block of the last call's logits and that block's place,
    its state blocks after the last call with their place in the whole
    state, the mesh counts of each call, and the allocations of whole
    layer-stacked leaves or of a whole state leaf (or one group's or
    slot's of one) the calls made; on ``plant`` (a case label and a
    start) the last call's logits once more with ``reduce_bcdt`` the
    identity."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.perfcount import MESH
    cfg = get_smoke_config(HYBRID_ARCH)
    out = {}
    for label, shape, axes, batch in cases:
        mesh = make_mesh(shape, axes)
        bundle = build_serve_step(
            cfg, mesh, ShapeSpec("d", HYBRID_DECODE_CACHE, batch, "decode"))
        p_sh, tok_sh, c_sh, _ = bundle.in_shardings
        part = bundle.fn.partition
        params = place(from_numpy_tree(init, "cpu"), p_sh, mesh)
        seen_logits = []
        greedy = part.greedy

        def captured(logits):
            seen_logits[:] = [logits[:, -1].numpy().copy()]
            return greedy(logits)

        part.greedy = captured
        watch = _stacked_whole_shapes(cfg, p_sh, mesh, True, gathered=True)
        rows = _block_slices((batch,), tok_sh, mesh)[0]
        for name, (first, whole, index) in starts[batch].items():
            watch_s = watch | _state_watch(whole)

            def decode():
                state = place(tree_util.tree_map(torch.from_numpy, whole),
                              c_sh, mesh)
                token = place(torch.from_numpy(first).long(), tok_sh, mesh)
                seen, tokens, counts = [], [], []
                for i in range(HYBRID_DECODE_TOKENS):
                    MESH.reset()
                    # the state's blocks are written in place
                    with _allocations(watch_s, seen, writes=False):
                        token, state = bundle.fn(params, token, state,
                                                 index + i)
                    counts.append(MESH.snapshot())
                    tokens.append(token[:, 0].numpy().copy())
                return state, tokens, counts, seen

            state, tokens, counts, seen = decode()
            vb = seen_logits[0].shape[-1]
            v0 = (mesh.get_local_rank("model") * vb
                  if "model" in mesh.mesh_dim_names else 0)
            rec = {"partitioned": bundle.partitioned,
                   "seq_axes": part.seq_axes,
                   "tokens": tokens, "token_rows": rows,
                   "logits": seen_logits[0],
                   "logit_slices": [rows, (v0, v0 + vb)],
                   "state": {"/".join(p): x.numpy().copy()
                             for p, x in _np_paths(state)},
                   "state_slices": {
                       "/".join(p): _block_slices(x.shape, c_sh[p[0]][p[1]],
                                                  mesh)
                       for p, x in _np_paths(whole)},
                   "counts": counts, "allocated": seen,
                   "watched": sorted(watch_s)}
            if (label, name) == plant:
                # a planted fault: each rank's (B, C, dt) from its own
                # channels alone
                part.reduce_bcdt = lambda t: t
                try:
                    decode()
                finally:
                    del part.reduce_bcdt
                rec["planted_logits"] = seen_logits[0]
            out[f"{label}/b{batch}/{name}"] = rec
    return out


def host_exchange_ranks(rank, world):
    """Every collective of ``launch.mesh`` on the groups of a (2, 2) and
    a (1, 4) mesh, through the host exchange that serves gloo groups,
    beside the result each should give, made on this rank from every
    rank's input (rank r holds ``_exchange_input(r)``): per case the
    pairs.  The tensors hold small integers, so every sum is exact in
    any order."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    x = _exchange_input(rank)
    routes = {2: [[0, 1], [1, 0]], 4: [[0, 1], [2, 3], [0, 1], [2, 3]]}
    for label, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        for axis in ("data", "model"):
            if mesh_lib.mesh_axis_sizes(mesh)[axis] == 1:
                continue
            group = mesh.get_group(axis)
            members = dist.get_process_group_ranks(group)
            n, me = len(members), dist.get_rank(group)
            xs = [_exchange_input(r) for r in members]
            rec = {}
            for dim in (0, 1, 2):
                rec[f"gather{dim}"] = (
                    mesh_lib.all_gather_cat(x, group, dim),
                    torch.cat(xs, dim))
                if x.shape[dim] % n == 0:
                    step = x.shape[dim] // n
                    rec[f"scatter{dim}"] = (
                        mesh_lib.reduce_scatter_cat(x, group, dim),
                        sum(xs).narrow(dim, me * step, step))
                even = 2 * (x.shape[dim] // 2)
                rec[f"a2a{dim}"] = (
                    mesh_lib.all_to_all_cat(x.narrow(dim, 0, even), group,
                                            dim, routes[n]),
                    torch.cat([xs[u].narrow(dim, 0, even).chunk(2, dim)[i]
                               for u in range(n) for i in range(2)
                               if routes[n][u][i] == me], dim))
            stack = torch.stack(xs)
            for op, want in (("SUM", stack.sum(0)), ("MAX", stack.amax(0)),
                             ("MIN", stack.amin(0))):
                rec[op] = (mesh_lib.all_reduce_sum_(
                    x.clone(), group, op=getattr(dist.ReduceOp, op)), want)
            rec["broadcast"] = (mesh_lib.broadcast_(x.clone(), group, n - 1),
                                xs[n - 1])
            out[f"{label}/{axis}"] = {
                k: (got.numpy(), want.numpy()) for k, (got, want)
                in rec.items()}
    mesh_lib.release_host_exchanges()
    return out


def _exchange_input(rank):
    return (torch.arange(4 * 6 * 8, dtype=torch.float32).view(4, 6, 8) % 7
            + rank)
