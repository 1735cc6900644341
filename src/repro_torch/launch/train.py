"""End-to-end trainer: DSSP-SPMD pipeline + controller + checkpoints.

Counterpart of ``repro/launch/train.py``, on one device (``cuda:0``
unless the caller names another; ``--device cpu`` here) or, with
``rules=`` from ``models.sharding.rules_for_mesh``, on a device mesh of
one process per device (``launch/mesh.py``).  The synchronization mode
is first-class:

    --sync bsp    the gradient applied in the step that computed it
    --sync ssp    delayed-gradient pipeline, fixed delay = max(s_lower, 1)
    --sync dssp   delayed-gradient pipeline, delay re-tuned every step by
                  DsspScheduleController from measured step/collective
                  times

Each step is the model's loss and backward, the optional wire
compression with error feedback, the gradient ring (``push_pop``) and
the optimizer, all updating the trainer's tensors in place (the
reference's jitted step donates them).  The step time the controller
sees is taken after the device has finished the step.

Mesh rules.  The step runs under ``use_rules(rules)``, as the
reference's does: with a mesh installed, attention takes the mesh
formulations and no flash kernel.  With a mesh the step is
``launch.steps.make_train_fn``'s, the function ``build_train_step``
builds, over this rank's blocks (``launch/steps.py``): every rank
generates the global batch and keeps its rows, and the controller's
delay is the mesh's first rank's, broadcast each step.  On a mesh
whose axes all have one rank it computes with the stored tensors and
runs no collective.  Compression compresses each rank's gradient
blocks with the error state in blocks, each leaf's scale or top-k
threshold that of the whole leaf (``launch.steps.block_reducers``), as
the reference compresses the whole summed gradient.  A checkpoint holds
whole leaves in the reference's format: the mesh's first rank gathers
and writes one leaf at a time while the others wait, and on resume
every rank reads each whole leaf and keeps its block
(``launch.mesh.save_blocks``/``restore_blocks``), so a mesh run and a
one-device run, of either package, resume each other.  As in the
reference the error state is not saved.

Fault tolerance: atomic async checkpoints every ``save_every`` steps
(params, optimizer state, DSSP ring buffer, data cursor) in the
reference's format, so either package resumes the other's; ``--resume``
restores all of it and continues bit-exact w.r.t. the data stream.

``--ps-shards N`` (or a process ``--transport``) trains through the
parameter-server engines instead; ``--spec RUN.json`` loads the whole
run from a ``RunSpec`` file.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 20 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import dssp_spmd
from repro_torch.data.synthetic import DataConfig, batches, loss_floor
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.obs.trace import TRACE
from repro_torch.optim.compression import make_compressor
from repro_torch.optim.optimizers import make_optimizer

#: profiler ranges around the two parts of a step that are not the model
RING_RANGE = "spmd gradient ring (push_pop)"
OPTIMIZER_RANGE = "spmd optimizer update"


@dataclasses.dataclass
class TrainLog:
    steps: List[int] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    delays: List[int] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)

    def record(self, step, loss, delay, dt):
        self.steps.append(step)
        self.losses.append(float(loss))
        self.delays.append(int(delay))
        self.step_times.append(dt)


class Trainer:
    """The SPMD trainer (module docstring).  With ``rules=`` whose mesh
    is set, the parameters, optimizer state, ring and error state are
    this rank's blocks, the step is ``launch.steps.make_train_fn``'s,
    compression reduces each leaf's scale or threshold over the ranks
    that split it, and ``save``/``resume`` write and read whole leaves
    one at a time (``launch.mesh.save_blocks``/``restore_blocks``); every
    rank of the mesh builds one and calls ``train`` alike."""

    def __init__(self, cfg, data_cfg: DataConfig, *, sync: str = "dssp",
                 s_lower: int = 0, s_upper: int = 3, lr: float = 3e-3,
                 optimizer: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, keep: int = 3,
                 save_every: int = 50, rules=None,
                 compressor: str = "none",
                 collective_time_fn: Optional[Callable[[], float]] = None,
                 staleness_damping: bool = True, device=None):
        if sync not in ("bsp", "ssp", "dssp"):
            raise ValueError(f"sync {sync!r} not trainable in SPMD mode "
                             "(asp exists in the PS layer only)")
        self.rules = rules
        self.mesh = getattr(rules, "mesh", None)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.sync = sync
        self.s_lower, self.s_upper = s_lower, s_upper
        self.use_pipeline = sync in ("ssp", "dssp")
        self.device = resolve_device(device)
        self.controller = dssp_spmd.DsspScheduleController(
            max(s_lower, 1) if self.use_pipeline else 0, s_upper)
        self.collective_time_fn = collective_time_fn or (lambda: 0.0)
        self.compressor = make_compressor(compressor)
        self.log = TrainLog()

        opt_kw = {}
        opt_name = optimizer or cfg.optimizer
        if opt_name in ("momentum", "adamw", "sgd"):
            opt_kw["staleness_damping"] = staleness_damping
        self.opt = make_optimizer(opt_name, lr, **opt_kw)
        self.loss_fn = registry.loss_fn(cfg)

        self.params = registry.init_params(cfg, seed=0, device=self.device)
        self._mesh_step = None
        if self.mesh is not None:
            from repro_torch.launch.mesh import place
            from repro_torch.launch.steps import make_train_fn
            from repro_torch.optim.optimizers import state_partition_specs
            self.param_specs = registry.param_specs(cfg, rules)
            self.params = place(self.params, self.param_specs, self.mesh)
            # the rows' split decides what the gradients are averaged
            # over; the state of a block is the block of the state (zeros)
            rows = {"tokens": rules.spec(("batch", None),
                                         (data_cfg.global_batch,
                                          data_cfg.seq_len))}
            whole = registry.abstract_params(cfg)
            self.state_specs = state_partition_specs(
                self.opt, self.param_specs, whole)
            self._mesh_step = make_train_fn(
                self.mesh, rules, self.opt, cfg, self.param_specs,
                self.state_specs, rows, use_pipeline=self.use_pipeline,
                compressor=self.compressor)
        self.opt_state = self.opt.init(self.params)
        self.pipeline = (dssp_spmd.init_pipeline(self.params, s_upper + 1)
                         if self.use_pipeline else ())
        # identity compressor: no dead params-sized error buffer
        self.err_state = (self.compressor.init_error(self.params)
                          if self.compressor.name != "none" else ())
        self.step_idx = 0

        if not checkpoint_dir:
            self.ckpt = None
        elif self.mesh is not None:
            from repro_torch.launch.mesh import open_checkpoints
            self.ckpt = open_checkpoints(checkpoint_dir, self.mesh,
                                         keep=keep)
        else:
            self.ckpt = CheckpointManager(checkpoint_dir, keep=keep)
        self.save_every = save_every

    # ------------------------------------------------------------ step
    def step(self, batch, delay: int) -> torch.Tensor:
        """One training step at an explicit ``delay`` (the reference's
        jitted step): loss and backward, compression, the ring, the
        optimizer.  Updates params, optimizer state, ring and error
        state in place; returns the loss (a device scalar, not waited
        for).  On a mesh ``batch`` is the global batch, and the step the
        mesh's (``launch/steps.py``)."""
        if self._mesh_step is not None:
            from repro_torch.launch.mesh import place
            from repro_torch.launch.steps import batch_specs
            rows = place(batch, batch_specs(self.cfg, self.rules, batch),
                         self.mesh)
            (self.params, self.opt_state, self.pipeline,
             metrics) = self._mesh_step(self.params, self.opt_state,
                                        self.pipeline, rows, delay,
                                        self.err_state)
            return metrics["loss"]
        from repro_torch.models.sharding import use_rules
        with use_rules(self.rules):
            return self._step(batch, delay)

    def _step(self, batch, delay: int) -> torch.Tensor:
        leaves, treedef = tree_util.flatten(self.params)
        live = [x.detach().requires_grad_() for x in leaves]
        loss, _ = self.loss_fn(tree_util.unflatten(treedef, live), batch)
        grads = tree_util.unflatten(treedef,
                                    list(torch.autograd.grad(loss, live)))
        del live
        if self.compressor.name != "none":
            grads, self.err_state = self.compressor.apply(grads,
                                                          self.err_state)
        if self.use_pipeline:
            # the delayed gradients are views of their ring slot: the
            # update below consumes them before the next write
            with torch.profiler.record_function(RING_RANGE):
                grads, valid, self.pipeline = dssp_spmd.push_pop(
                    self.pipeline, grads, delay)
            staleness, lr_scale = delay, valid
        else:
            staleness, lr_scale = 0, 1.0
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params, staleness=staleness,
                lr_scale=lr_scale)
        return loss.detach()

    # ------------------------------------------------------------ resume
    def _state(self):
        return {"params": self.params, "opt": self.opt_state,
                "pipeline": self.pipeline}

    def _mesh_state(self):
        """The state's specs and its whole shapes (``meta``) on a mesh."""
        from repro_torch.core.dssp_spmd import pipeline_specs
        whole = registry.abstract_params(self.cfg)
        specs = {"params": self.param_specs, "opt": self.state_specs,
                 "pipeline": (pipeline_specs(self.param_specs,
                                             self.s_upper + 1)
                              if self.use_pipeline else ())}
        like = {"params": whole, "opt": self.opt.init(whole),
                "pipeline": (dssp_spmd.init_pipeline(whole, self.s_upper + 1)
                             if self.use_pipeline else ())}
        return specs, like

    def resume(self) -> bool:
        if self.ckpt is None:
            return False
        state = self._state()
        if self.mesh is not None:
            from repro_torch.launch.mesh import restore_blocks
            step = self.ckpt.latest_step()
            if step is None:
                return False
            specs, like = self._mesh_state()
            extras = restore_blocks(self.ckpt, step, state, like, specs,
                                    self.mesh)
            self.step_idx = extras["next_step"]
            return True
        got = self.ckpt.restore_latest(state)
        if got is None:
            return False
        _, tree, extras = got
        with torch.no_grad():
            for cur, saved in zip(tree_util.leaves(state),
                                  tree_util.leaves(tree)):
                cur.copy_(saved)
        self.step_idx = extras["next_step"]
        return True

    # ------------------------------------------------------------ train
    def train(self, n_steps: int, *, log_every: int = 10,
              verbose: bool = False) -> TrainLog:
        from repro_torch.api.session import batch_tensors
        it = batches(self.cfg, self.data_cfg, start_step=self.step_idx)
        end = self.step_idx + n_steps
        while self.step_idx < end:
            batch = batch_tensors(next(it), self.device)
            if self.sync == "dssp":
                delay = self.controller.delay()
            elif self.sync == "ssp":
                delay = max(self.s_lower, 1)
            else:
                delay = 0
            if self._mesh_step is not None:
                from repro_torch.launch.mesh import broadcast_int
                delay = broadcast_int(delay, self.mesh)
            t_tr = TRACE.now() if TRACE.enabled else 0.0
            t0 = time.monotonic()
            loss = self.step(batch, delay)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            loss = float(loss)
            dt = time.monotonic() - t0
            if TRACE.enabled:
                TRACE.span("compute_step", t_tr, worker=0,
                           clock=self.step_idx,
                           args={"loss": loss, "delay": int(delay)})
            self.controller.observe(dt, self.collective_time_fn())
            self.log.record(self.step_idx, loss, delay, dt)
            if verbose and self.step_idx % log_every == 0:
                print(f"step {self.step_idx:5d} loss {loss:.4f} "
                      f"delay {delay} dt {dt * 1e3:.0f}ms")
            self.step_idx += 1
            if (self.ckpt is not None and self.save_every
                    and self.step_idx % self.save_every == 0):
                self.save()
        if self.ckpt is not None:
            self.save()
            self.ckpt.wait()
        return self.log

    def save(self) -> None:
        extras = {"next_step": self.step_idx,
                  "data_seed": self.data_cfg.seed}
        if self.mesh is not None:
            from repro_torch.launch.mesh import save_blocks
            specs, _ = self._mesh_state()
            save_blocks(self.ckpt, self.step_idx, self._state(), specs,
                        self.mesh, extras)
            return
        self.ckpt.save(self.step_idx, self._state(), extras=extras)


# ----------------------------------------------------- sharded-PS path
def train_ps(cfg, data_cfg: DataConfig, *, sync: str, n_steps: int,
             lr: float, n_shards: int, n_workers: int = 4,
             s_lower: int = 0, s_upper: int = 3,
             compressor: str = "none", apply_mode: str = "tree",
             gating: str = "sharded", straggler: float = 1.0,
             wire_format: str = "tree", transport: str = "inproc",
             arch: Optional[str] = None, smoke: bool = True,
             verbose: bool = False, device=None):
    """Deprecated shim over ``repro_torch.api.build_session``.

    The PS training path lives in the session engines; this wrapper
    keeps the old keyword surface alive, translates it into a
    ``RunSpec`` and returns the trained session's server.
    """
    import warnings

    from repro_torch import api

    warnings.warn(
        "train_ps is deprecated; build a repro_torch.api.RunSpec and call "
        "build_session(spec).run(steps) instead", DeprecationWarning,
        stacklevel=2)
    if transport != "inproc" and arch is None:
        raise ValueError("transport workers rebuild the model from its "
                         "config name — pass arch=")
    spec = spec_from_flags(
        arch=arch or cfg.name, smoke=smoke, sync=sync,
        seq=data_cfg.seq_len, batch=data_cfg.global_batch,
        seed=data_cfg.seed, lr=lr, s_lower=s_lower, s_upper=s_upper,
        compress=compressor, ps_shards=max(1, n_shards),
        ps_workers=n_workers, ps_apply=apply_mode, ps_wire=wire_format,
        ps_gating=gating, ps_straggler=straggler, transport=transport)
    session = api.build_session(spec, verbose=verbose, device=device)
    session.run(n_steps)
    return session.server


# ------------------------------------------------------- flags -> spec
def spec_from_flags(*, arch: str, smoke: bool = True, sync: str = "dssp",
                    model_kernels: str = "auto",
                    seq: int = 64, batch: int = 8,
                    seed: int = 0, lr: float = 3e-3,
                    optimizer: Optional[str] = None,
                    s_lower: int = 0, s_upper: int = 3,
                    compress: str = "none", ps_shards: int = 0,
                    ps_workers: int = 4, ps_apply: str = "tree",
                    ps_wire: str = "tree", ps_gating: str = "sharded",
                    ps_straggler: float = 1.0, ps_coalesce: int = 1,
                    delta_pull: bool = False,
                    transport: str = "inproc",
                    trace_path: str = "",
                    ckpt_dir: str = "", snapshot_every: float = 5.0,
                    resume: bool = False):
    """Translate the historical CLI flag surface into a ``RunSpec``.

    Keeps the old implication chain (`--transport tcp` implies the
    packed wire; packed wire implies the fused apply; process
    transports imply `--ps-shards 1`) so every flag combination that
    used to run still runs — the spec layer itself is stricter and
    rejects the un-implied combinations outright.
    """
    from repro_torch import api

    if transport != "inproc" and ps_shards < 1:
        ps_shards = 1          # process transports live in the PS layer
    if transport != "inproc":
        ps_wire = "packed"     # frames carry the packed buffer only
    if (ps_coalesce > 1 or delta_pull) and ps_shards < 1:
        # No implication here: silently switching the SPMD pipeline to
        # a parameter server (or dropping the knob) would train a
        # different run than the user asked for.
        raise ValueError(
            "--ps-coalesce/--delta-pull act on the parameter server's "
            "packed hot path; the SPMD pipeline has no server — add "
            "--ps-shards N (or --transport tcp/shmem)")
    if ps_coalesce > 1 or delta_pull:
        ps_wire = "packed"     # both knobs ride the packed wire
    if ps_wire == "packed" and ps_apply == "tree":
        ps_apply = "fused"     # packed pushes fold through the kernel
    if ckpt_dir and ps_shards >= 1 and ps_apply == "tree":
        ps_apply = "fused"     # snapshots capture the packed store
    ft = (api.FtSpec(snapshot_every_s=snapshot_every, dir=ckpt_dir,
                     resume=resume)
          if ckpt_dir and ps_shards >= 1 else api.FtSpec())
    if ps_shards >= 1:
        ps = api.ServerSpec(kind="sharded", shards=ps_shards,
                            workers=ps_workers, apply=ps_apply,
                            gating=ps_gating, straggler=ps_straggler,
                            coalesce=ps_coalesce)
        opt = api.OptimizerSpec(lr=lr)
    else:
        ps = api.ServerSpec(kind="none", shards=0, workers=ps_workers)
        opt = api.OptimizerSpec(name=optimizer, lr=lr)
    return api.RunSpec(
        model=api.ModelSpec(arch=arch, smoke=smoke, kernels=model_kernels),
        data=api.DataSpec(seq_len=seq, global_batch=batch, seed=seed),
        optimizer=opt,
        sync=api.SyncSpec(mode=sync, staleness=max(s_lower, 1),
                          s_lower=s_lower, s_upper=s_upper),
        ps=ps,
        wire=api.WireSpec(format=ps_wire if ps_shards >= 1 else "tree",
                          compression=compress,
                          delta_pull=delta_pull and ps_shards >= 1),
        transport=api.TransportSpec(kind=transport),
        obs=api.ObsSpec(trace=bool(trace_path), trace_path=trace_path),
        ft=ft)


# -------------------------------------------------------------------- CLI
#: (flag, default, args attribute) of every wiring flag: what a RunSpec
#: field covers, so ``--spec`` refuses it
_WIRING = (("--arch", "xlstm-125m", "arch"), ("--full", True, "smoke"),
           ("--sync", "dssp", "sync"),
           ("--model-kernels", "auto", "model_kernels"),
           ("--batch", 8, "batch"), ("--seq", 64, "seq"),
           ("--lr", 3e-3, "lr"), ("--optimizer", None, "optimizer"),
           ("--s-lower", 0, "s_lower"), ("--s-upper", 3, "s_upper"),
           ("--compress", "none", "compress"),
           ("--ps-shards", 0, "ps_shards"),
           ("--ps-workers", 4, "ps_workers"),
           ("--ps-apply", "tree", "ps_apply"),
           ("--ps-wire", "tree", "ps_wire"),
           ("--ps-gating", "sharded", "ps_gating"),
           ("--ps-straggler", 1.0, "ps_straggler"),
           ("--ps-coalesce", 1, "ps_coalesce"),
           ("--delta-pull", False, "delta_pull"), ("--trace", "", "trace"),
           ("--transport", "inproc", "transport"),
           ("--ckpt-dir", "", "ckpt_dir"),
           ("--snapshot-every", 5.0, "snapshot_every"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec", default="", metavar="RUN.json",
                    help="load the whole run from a RunSpec JSON file "
                         "(repro_torch.api); every other wiring flag is "
                         "then rejected — the spec is the single source "
                         "of truth")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the RunSpec these flags denote as JSON "
                         "and exit (seed a --spec file)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default cuda:0; "
                         "without CUDA the run raises unless this names "
                         "another device, e.g. cpu)")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the published config")
    ap.add_argument("--sync", default="dssp",
                    choices=["bsp", "ssp", "dssp", "asp"],
                    help="asp is valid only with --ps-shards (PS layer)")
    ap.add_argument("--model-kernels", default="auto", metavar="SPEC",
                    help="worker-step kernel dispatch (repro_torch.kernels."
                         "registry): 'auto' picks per device; a bare "
                         "variant ('pallas' = the CUDA kernels, 'xla' = "
                         "the plain formulations) applies to every op; "
                         "per-op overrides compose as e.g. "
                         "'attention=pallas,ssm_scan=xla_associative'")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--s-lower", type=int, default=0)
    ap.add_argument("--s-upper", type=int, default=3)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--checkpoint-dir", default="",
                    help="SPMD trainer state checkpoints (see --ckpt-dir "
                         "for the parameter-server engines)")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint "
                         "(--checkpoint-dir on SPMD, --ckpt-dir on the "
                         "PS engines)")
    ap.add_argument("--ckpt-dir", default="", metavar="DIR",
                    help="parameter-server snapshots (repro_torch.ft): "
                         "periodically checkpoint the packed shard "
                         "store + version vector + sync-policy state "
                         "here; with --resume, restore the latest "
                         "snapshot before serving (needs --ps-shards)")
    ap.add_argument("--snapshot-every", type=float, default=5.0,
                    metavar="SECONDS",
                    help="server snapshot interval for --ckpt-dir")
    ap.add_argument("--ps-shards", type=int, default=0, metavar="N",
                    help="train through a sharded threaded parameter "
                         "server with N shards (0 = SPMD pipeline path)")
    ap.add_argument("--ps-workers", type=int, default=4)
    ap.add_argument("--ps-apply", default="tree", choices=["tree", "fused"],
                    help="per-shard apply: per leaf, or one fused CUDA "
                         "launch over the packed shard")
    ap.add_argument("--ps-wire", default="tree", choices=["tree", "packed"],
                    help="push/pull wire format: per-leaf trees, or the "
                         "zero-repack packed (rows, 512) buffer (packed "
                         "implies --ps-apply fused; --compress becomes the "
                         "fused wire compression)")
    ap.add_argument("--ps-gating", default="sharded",
                    choices=["sharded", "global"])
    ap.add_argument("--ps-straggler", type=float, default=1.0,
                    help="speed factor of the last PS worker (>1 = slower)")
    ap.add_argument("--ps-coalesce", type=int, default=1, metavar="K",
                    help="coalescing window: fold up to K concurrent "
                         "workers' packed pushes through ONE batched "
                         "kernel launch per shard (implies --ps-wire "
                         "packed; 1 = one launch per push)")
    ap.add_argument("--delta-pull", action="store_true",
                    help="version-delta pulls: workers pull only the "
                         "shard regions that advanced since their last "
                         "pull (implies --ps-wire packed)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record a run-wide trace (repro_torch.obs) and "
                         "write it here on exit: .jsonl = raw event "
                         "lines, anything else = Chrome trace_event JSON")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "tcp", "shmem"],
                    help="PS worker isolation: inproc = threads sharing "
                         "the heap; tcp/shmem = spawned worker PROCESSES "
                         "pushing packed frames over a real wire (implies "
                         "--ps-wire packed; enables --ps-shards 1 if "
                         "unset)")
    return ap


def main(argv=None) -> None:
    from repro_torch import api

    ap = build_parser()
    args = ap.parse_args(argv)

    if args.spec:
        # Every wiring flag (anything a RunSpec field covers) is
        # rejected alongside --spec; only run-control flags (--steps,
        # --device, checkpointing, --dump-spec) compose with it.
        wired = [flag for flag, default, attr in _WIRING
                 if getattr(args, attr) != default]
        if wired:
            ap.error(f"--spec is the single source of truth; drop "
                     f"{', '.join(wired)} (edit the JSON instead)")
        with open(args.spec) as f:
            spec = api.RunSpec.from_json(f.read())
    else:
        spec = spec_from_flags(
            arch=args.arch, smoke=args.smoke, sync=args.sync,
            model_kernels=args.model_kernels,
            seq=args.seq, batch=args.batch, lr=args.lr,
            optimizer=args.optimizer, s_lower=args.s_lower,
            s_upper=args.s_upper, compress=args.compress,
            ps_shards=args.ps_shards, ps_workers=args.ps_workers,
            ps_apply=args.ps_apply, ps_wire=args.ps_wire,
            ps_gating=args.ps_gating, ps_straggler=args.ps_straggler,
            ps_coalesce=args.ps_coalesce, delta_pull=args.delta_pull,
            transport=args.transport, trace_path=args.trace,
            ckpt_dir=args.ckpt_dir, snapshot_every=args.snapshot_every,
            resume=args.resume)
    if args.dump_spec:
        print(spec.to_json())
        return

    cfg = (get_smoke_config(spec.model.arch) if spec.model.smoke
           else get_config(spec.model.arch))

    if spec.engine != "spmd":
        ignored = [flag for flag, on in (
            ("--checkpoint-dir", bool(args.checkpoint_dir)),
            ("--resume", args.resume and not spec.ft.snapshots),
            ("--optimizer", args.optimizer is not None)) if on]
        if ignored:
            print(f"warning: {', '.join(ignored)} only apply to the SPMD "
                  "path and are ignored with --ps-shards (the PS server "
                  "optimizer is SGD/momentum; the PS snapshot dir is "
                  "--ckpt-dir, and --resume works with it)")
        print(f"arch={cfg.name} sync={spec.sync.mode} "
              f"ps_shards={spec.ps.shards} workers={spec.ps.workers} "
              f"params={registry.count_params(cfg):,}")
        with api.build_session(spec, verbose=True,
                               device=args.device) as session:
            session.start()
            rig = getattr(session, "ft_rig", None)
            if spec.ft.resume and rig is not None:
                at = rig.resumed_step
                print(f"resume: {'ok, at server version ' + str(at) if at is not None else 'no snapshot'}")
            m = session.run(args.steps)
        if spec.ft.snapshots and "ft" in m:
            print(f"snapshots: {m['ft']['snapshots']} taken, latest "
                  f"step {m['ft']['latest_step']} in {spec.ft.dir}")
        if m["final_loss"] is not None:
            print(f"final loss {m['final_loss']:.4f} "
                  f"(first {m['first_loss']:.4f})")
        if spec.obs.trace_path:
            print(f"trace written: {spec.obs.trace_path} "
                  f"(python -m repro_torch.obs summarize "
                  f"{spec.obs.trace_path})")
        return

    data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=spec.data.seq_len,
                          global_batch=spec.data.global_batch,
                          seed=spec.data.seed)
    with api.build_session(
            spec, verbose=True, device=args.device,
            checkpoint_dir=args.checkpoint_dir or None,
            save_every=args.save_every,
            resume=args.resume) as session:
        session.start()
        if args.resume:
            at = session.trainer.step_idx
            print(f"resume: {'ok, at step ' + str(at) if session.resumed else 'no checkpoint'}")
        print(f"arch={cfg.name} sync={spec.sync.mode} params="
              f"{registry.count_params(cfg):,} "
              f"loss_floor~{loss_floor(data_cfg):.3f}")
        m = session.run(args.steps)
    print(f"final loss {m['final_loss']:.4f} "
          f"(first {m['first_loss']:.4f}); mean delay "
          f"{m['mean_delay']:.2f}")
    if spec.obs.trace_path:
        print(f"trace written: {spec.obs.trace_path} "
              f"(python -m repro_torch.obs summarize {spec.obs.trace_path})")


if __name__ == "__main__":
    main()
