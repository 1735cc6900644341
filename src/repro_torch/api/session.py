"""``build_session(spec) -> TrainingSession`` — the single wiring path.

Counterpart of ``repro/api/session.py`` for the engines the port has so
far:

  * ``ps-threads``: W worker threads pushing the packed or the tree
    wire into an in-heap ``ShardedParameterServer`` or monolithic
    ``ParameterServer``, with coalesced applies and wire compression as
    the spec asks;
  * ``ps-transport``: W spawned worker processes pushing packed frames
    over tcp or shared memory (``repro_torch.transport``) into a
    ``PSServerEndpoint`` over the same servers; or, with
    ``external_workers=True``, an endpoint the caller's own clients
    drive (``session.address()``), over inproc too.

Both engines arm ``spec.obs`` (the server-side recorder, a metrics
sampler, worker ``MSG_TRACE`` flushes and spills merged into one trace,
exported on close) and ``spec.ft`` (snapshots, resume-before-serve, a
final snapshot on close; on ``ps-transport`` also the live-reshard
trigger); ``reshard`` migrates a running transport session's server by
hand.  Both run ``spec.serve``'s replicas beside the trainers
(``repro_torch.serve``): threads reading the in-heap server on
``ps-threads``, spawned processes on the transport slots after the
workers' on ``ps-transport``; ``metrics()["serve"]`` aggregates them.
The restartable out-of-process server is ``repro_torch.ft.ServerProcess``.

    with build_session(spec) as session:      # start() on enter
        session.run(steps)                    # blocks until trained
        print(session.metrics())
                                              # close() on exit

Device rule: the session runs on ``cuda:0``.  ``device=`` is a
build-time override like ``params=`` and ``step_fn=`` (not a ``RunSpec``
field, so the schema stays the reference's); tests pass
``device="cpu"``.  With no ``device=`` and no CUDA, ``build_session``
raises — it never carries on on the CPU.  Spawned workers and replicas
run on the session's device too (``WorkerTask.device``,
``ReplicaTask.device``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List

import torch

from repro_torch.api.spec import CUSTOM_ARCH, RunSpec, SpecError
from repro_torch.device import resolve_device

_ENGINES: Dict[str, type] = {}
_SERVER_BUILDERS: Dict[str, Callable] = {}


def register_engine(name: str):
    """Class decorator: make ``name`` a buildable session engine."""
    def deco(cls):
        cls.engine = name
        _ENGINES[name] = cls
        return cls
    return deco


def register_server(kind: str):
    """Register a server builder ``fn(spec, params) -> server`` for
    ``ps.kind == kind``."""
    def deco(fn):
        _SERVER_BUILDERS[kind] = fn
        return fn
    return deco


def build_session(spec, **overrides) -> "TrainingSession":
    """The one public entry point: a validated ``RunSpec`` (or a plain
    dict in its ``to_dict`` shape) in, an unstarted session out."""
    if isinstance(spec, dict):
        spec = RunSpec.from_dict(spec)
    if not isinstance(spec, RunSpec):
        raise SpecError(
            f"build_session takes a RunSpec or its dict form, got "
            f"{type(spec).__name__}")
    cls = _ENGINES.get(spec.engine)
    if cls is None:  # the spec layer refuses engines the port lacks
        raise SpecError(f"no session engine registered for {spec.engine!r} "
                        f"(have {sorted(_ENGINES)})")
    return cls(spec, **overrides)


def build_server(spec: RunSpec, params=None, device=None):
    """Construct (only) the spec's parameter server on ``device``."""
    builder = _SERVER_BUILDERS.get(spec.ps.kind)
    if builder is None:
        raise SpecError(f"no server builder registered for "
                        f"ps.kind={spec.ps.kind!r} "
                        f"(have {sorted(_SERVER_BUILDERS)})")
    if params is None:
        params = _registry_params(spec, resolve_device(device))
    return builder(spec, params)


# ===================================================================
# session base
# ===================================================================
class TrainingSession:
    """Context-managed lifecycle over one training run.

    ``start()`` builds the server, ``run(steps)`` trains, ``metrics()``
    reports a summary, ``close()`` releases gated workers.  Idempotent:
    ``start`` after start and ``close`` after close are no-ops.
    """

    engine = "base"
    OVERRIDES: frozenset = frozenset({"verbose", "device"})

    def __init__(self, spec: RunSpec, **overrides):
        unknown = sorted(set(overrides) - self.OVERRIDES)
        if unknown:
            raise SpecError(
                f"unknown build_session override(s) {unknown} for the "
                f"{self.engine!r} engine; valid overrides: "
                f"{sorted(self.OVERRIDES)}")
        self.spec = spec
        self.device = resolve_device(overrides.get("device"))
        self.verbose = bool(overrides.get("verbose", False))
        self._ov = overrides
        self._started = False
        self._closed = False

    def start(self) -> "TrainingSession":
        if not self._started:
            self._start()
            self._started = True
        return self

    def run(self, steps: int) -> Dict[str, Any]:
        """Train for ``steps`` global steps (divided across workers).
        Returns ``metrics()``."""
        if self._closed:
            raise SpecError("session is closed")
        self.start()
        self._run(int(steps))
        return self.metrics()

    def metrics(self) -> Dict[str, Any]:
        raise NotImplementedError

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._started:
            self._close()

    def __enter__(self) -> "TrainingSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _start(self) -> None:
        raise NotImplementedError

    def _run(self, steps: int) -> None:
        raise NotImplementedError

    def _close(self) -> None:
        pass


# ===================================================================
# observability and fault-tolerance rigs
# ===================================================================
class _ObsRig:
    """Per-session lifecycle for ``spec.obs``: enables the server-side
    recorder, runs the metrics sampler, merges worker flushes and spills
    into one ``TraceCollector``, exports on finish."""

    def __init__(self, obs):
        from repro_torch.obs import TraceCollector
        self.obs = obs
        self.collector = TraceCollector()
        self.sampler = None
        self.spill_dir = None
        self.summary = None
        #: the merged timeline, after ``finish``
        self.events = None
        self._done = False

    def start(self, metrics_fn=None) -> None:
        from repro_torch.obs.trace import TRACE
        TRACE.enable(source="server")
        if self.obs.sample_every > 0 and metrics_fn is not None:
            from repro_torch.obs import MetricsSampler
            self.sampler = MetricsSampler(TRACE, metrics_fn,
                                          self.obs.sample_every)
            self.sampler.start()

    def make_spill_dir(self) -> str:
        """Temp dir spawned workers spill their rings into (recovered on
        finish, so a killed worker's events still reach the trace)."""
        import tempfile
        if self.spill_dir is None:
            self.spill_dir = tempfile.mkdtemp(prefix="repro-torch-spill-")
        return self.spill_dir

    def finish(self) -> None:
        """Stop sampling, drain and merge every source, export,
        summarize.  Idempotent."""
        if self._done:
            return
        self._done = True
        import shutil

        from repro_torch.obs import summarize, write_chrome_trace, write_jsonl
        from repro_torch.obs.trace import TRACE
        if self.sampler is not None:
            self.sampler.stop()
        self.collector.ingest_local(TRACE, source="server")
        TRACE.disable()
        if self.spill_dir is not None:
            self.collector.ingest_spill_dir(self.spill_dir)
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        self.events = self.collector.timeline()
        path = self.obs.trace_path
        if path:
            if path.endswith(".jsonl"):
                write_jsonl(self.events, path)
            else:
                write_chrome_trace(self.events, path)
        self.summary = summarize(self.events)


class _FtRig:
    """Per-session lifecycle for ``spec.ft`` on the PS engines: the
    checkpoint manager, the optional resume-before-serve, and the
    periodic ``ServerSnapshotter``; one final snapshot on close."""

    def __init__(self, ft, server):
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.ft.snapshot import ServerSnapshotter, restore_latest
        self.manager = CheckpointManager(ft.dir, keep=ft.keep)
        # Resume BEFORE anything serves: endpoint pull caches are keyed
        # by version, and a restore moves versions backwards.
        self.resumed_step = (restore_latest(server, self.manager)
                             if ft.resume else None)
        self.snapshotter = (
            ServerSnapshotter(server, self.manager,
                              ft.snapshot_every_s).start()
            if ft.snapshot_every_s > 0 else None)
        self._done = False

    def finish(self) -> None:
        """Final snapshot + writer flush; surfaces any async-save
        failure the snapshotter thread parked.  Idempotent."""
        if self._done:
            return
        self._done = True
        if self.snapshotter is not None:
            self.snapshotter.stop(final_save=True)
        self.manager.wait()

    def metrics(self) -> Dict[str, Any]:
        return {
            "resumed_step": self.resumed_step,
            "snapshots": (self.snapshotter.snapshots
                          if self.snapshotter else 0),
            "latest_step": self.manager.latest_step(),
        }


def _obs_snapshot_fn(server):
    """Sampler callable for the PS engines: counters + the policy's
    current effective staleness bound (the DSSP threshold timeline)."""
    from repro_torch.perfcount import snapshot_all

    def snap() -> Dict[str, Any]:
        m = server.metrics
        out = {
            "pushes": m.total_pushes,
            "applied": m.applied_updates,
            "version": server.version,
            "total_wait": round(m.total_wait, 6),
            "max_staleness": m.max_staleness,
            "credit_releases": m.credit_releases,
            "perfcount": snapshot_all(),
        }
        shards = getattr(server, "shards", None)
        pol, trk = ((shards[0].policy, shards[0].tracker) if shards
                    else (getattr(server, "policy", None),
                          getattr(server, "tracker", None)))
        if pol is not None:
            bound = pol.effective_staleness_bound(trk)
            out["effective_threshold"] = (None if bound == float("inf")
                                          else float(bound))
        return out

    return snap


def reshard_due(server, ft, last):
    """``(due, versions)``: is the spec's live-reshard trigger due —
    the manual push round (``ft.reshard_round``) reached, or one shard's
    applied-update growth since ``last`` (its version vector) above
    ``ft.reshard_hot_factor`` x the uniform share (the hot-shard
    policy)?  Shared by the session's watcher and the server process."""
    if ft.reshard_round >= 0 \
            and server.metrics.total_pushes >= ft.reshard_round:
        return True, last
    if ft.reshard_hot_factor > 0.0:
        cur = server.shard_versions()
        if len(cur) == len(last):
            deltas = [c - b for c, b in zip(cur, last)]
            total = sum(deltas)
            if total > 0 and max(deltas) > \
                    ft.reshard_hot_factor * (total / len(deltas)):
                return True, cur
        return False, cur
    return False, last


def _reshard_watch(server, ft, stop) -> None:
    """Background one-shot live-reshard trigger for the in-parent
    sessions (``repro_torch.ft.server_proc`` runs its own)."""
    import time
    last = server.shard_versions()
    while not stop.is_set() and not server.stopped:
        time.sleep(0.02)
        due, last = reshard_due(server, ft, last)
        if due:
            server.reshard(ft.reshard_shards)
            return


# ===================================================================
# server builders
# ===================================================================
def _server_optimizer_factory(spec: RunSpec):
    from repro_torch.ps.server import ServerOptimizer
    opt = spec.optimizer
    damping = (False if opt.staleness_damping is None
               else opt.staleness_damping)
    momentum = opt.momentum if opt.name in (None, "sgd", "momentum") else 0.0
    return lambda: ServerOptimizer(lr=opt.lr, momentum=momentum,
                                   staleness_damping=damping)


def _coalesce_kwargs(spec: RunSpec) -> Dict[str, Any]:
    wait = spec.ps.coalesce_wait_ms
    return {"coalesce": spec.ps.coalesce,
            "coalesce_wait": None if wait is None else wait / 1e3}


def _compression_plan(spec: RunSpec):
    """(tree_compressor, wire_compression) — where the server runs the
    configured compression: the fused wire compression on the packed
    wire, the per-tensor tree compressor on the tree wire; nowhere when
    int8 rides the frames of a process transport
    (``WorkerTask.from_spec``), which are dequantized on receipt."""
    comp = spec.wire.compression
    if comp == "none" or (spec.transport.kind != "inproc"
                          and comp == "int8"):
        return None, None
    if spec.wire.format == "packed":
        return None, comp
    return comp, None


@register_server("mono")
def _build_mono(spec: RunSpec, params):
    from repro_torch.ps.server import ParameterServer
    policy = spec.sync.policy_factory(spec.ps.workers)()
    return ParameterServer(
        params, policy, _server_optimizer_factory(spec)(),
        spec.ps.workers,
        apply_mode="packed" if spec.ps.apply == "packed" else "tree",
        **_coalesce_kwargs(spec))


@register_server("sharded")
def _build_sharded(spec: RunSpec, params):
    from repro_torch.optim.compression import make_compressor
    from repro_torch.ps.sharded.server import ShardedParameterServer
    tree_comp, wire_comp = _compression_plan(spec)
    return ShardedParameterServer(
        params, spec.sync.policy_factory(spec.ps.workers),
        _server_optimizer_factory(spec),
        spec.ps.workers, spec.ps.shards,
        gating=spec.ps.gating, apply_mode=spec.ps.apply,
        compressor=make_compressor(tree_comp) if tree_comp else None,
        wire_compression=wire_comp,
        topk_fraction=spec.wire.topk_fraction,
        **_coalesce_kwargs(spec))


# ===================================================================
# shared model plumbing
# ===================================================================
def _model_setup(spec: RunSpec, model_config=None):
    """(ModelConfig, DataConfig) of a run: the spec's registry
    architecture, or the ``model_config`` override as given (the
    reference's meaning: the spec's ``model`` section is then not
    read)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.synthetic import DataConfig
    cfg = model_config
    if cfg is None:
        if spec.model.arch == CUSTOM_ARCH:
            raise SpecError(
                "model.arch='custom' needs build-time overrides (params=, "
                "step_fn=, batches=, or model_config=); name a registry "
                "architecture to run the model")
        cfg = (get_smoke_config(spec.model.arch) if spec.model.smoke
               else get_config(spec.model.arch))
        if spec.model.kernels != cfg.kernels:
            cfg = dataclasses.replace(cfg, kernels=spec.model.kernels)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=spec.data.seq_len,
                          global_batch=spec.data.global_batch,
                          seed=spec.data.seed)
    return cfg, data_cfg


def _registry_params(spec: RunSpec, device: torch.device,
                     model_config=None):
    from repro_torch.models import registry
    cfg, _ = _model_setup(spec, model_config)
    return registry.init_params(cfg, seed=0, device=device)


def _speed_factors(spec: RunSpec, override) -> List[float]:
    w = spec.ps.workers
    if override is not None:
        if len(override) != w:
            raise SpecError(f"{len(override)} speed factors for "
                            f"{w} workers")
        return list(override)
    return [spec.ps.straggler if i == w - 1 else 1.0 for i in range(w)]


def _default_loss_from_aux(aux) -> float:
    return float(aux["loss"])


def _grads_fn(cfg):
    """``(params, batch) -> (grads, {"loss": loss})``: the model's loss
    and its backward on a parameter tree."""
    from repro_torch import tree as tree_util
    from repro_torch.models import registry
    loss_fn = registry.loss_fn(cfg)

    def grads_of(params, batch):
        leaves, treedef = tree_util.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, _ = loss_fn(tree_util.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return (tree_util.unflatten(treedef, list(grads)),
                {"loss": loss.detach()})

    return grads_of


def packed_step(cfg, plan, device: torch.device, current_plan=None):
    """One worker's packed-wire step ``(wire_p, batch) -> (wire_g,
    aux)``: unpack the pulled wire into leaf views, loss and backward,
    pack the grads into the worker's own gradient wire.

    ``current_plan`` (in-heap workers: ``lambda: server.plan``) follows
    a live reshard: a pulled wire of another row count rebinds the step
    to the server's current plan and a gradient wire of its layout.

    The gradient wire is allocated once and reused every iteration (the
    counterpart of the reference's donated buffer).  Safe: a push folds
    it in (in-heap: the server's kernel is queued on the same stream, so
    it reads the region before anything this worker queues later writes
    it; over a transport: the codec copies it to the host) and keeps no
    reference once the push returns."""
    from repro_torch.wireformat import WIRE_LANES
    grads_of = _grads_fn(cfg)
    bound = {}

    def bind(p) -> None:
        layout = p.wire_layout()
        bound["plan"] = p
        bound["wire_g"] = torch.zeros((layout.total_rows, WIRE_LANES),
                                      dtype=layout.dtype, device=device)

    bind(plan)

    def step(wire_p, batch):
        if (wire_p.shape[0] != bound["wire_g"].shape[0]
                and current_plan is not None):
            bind(current_plan())
        plan, wire_g = bound["plan"], bound["wire_g"]
        grads, aux = grads_of(plan.unpack(wire_p), batch)
        plan.pack(grads, out=wire_g)
        return wire_g, aux

    return step


def worker_batches(cfg, data_cfg, w: int, device: torch.device) -> Iterator:
    """Worker ``w``'s data stream (seed ``data_cfg.seed + 1 + w``, as in
    the reference), as tensors on ``device``: integer arrays (tokens,
    labels) as ``torch.long``, floating ones (Whisper's f32 ``frames``)
    in their own dtype, as the reference's ``jnp.asarray`` keeps it."""
    from repro_torch.data.synthetic import batches as data_batches
    wcfg = dataclasses.replace(data_cfg, seed=data_cfg.seed + 1 + w)
    for b in data_batches(cfg, wcfg):
        yield {k: torch.from_numpy(v).to(
                   device=device,
                   dtype=None if v.dtype.kind == "f" else torch.long)
               for k, v in b.items()}


# ===================================================================
# serving rig (both PS engines)
# ===================================================================
def _serve_threads(session) -> tuple:
    """Start ``spec.serve.replicas`` replica threads against the live
    in-heap server (the ``ps-threads`` engine's serve tier: replicas read
    the server directly, no transport), on the session's device.
    Returns ``(threads, results)``: join the threads, then read the
    results list."""
    spec = session.spec
    if spec.serve.replicas <= 0:
        return [], []
    import threading
    import traceback

    from repro_torch.serve import (BatchQueue, Decoder, DirectSubscription,
                                   ParamSubscriber, Refresher,
                                   ReplicaResult, ReplicaWorker,
                                   drive_replica, replica_chain)
    cfg, _ = _model_setup(spec, session._ov.get("model_config"))
    plan = session.server.plan
    layout = plan.wire_layout()
    sv = spec.serve
    w = spec.ps.workers
    results: List = [None] * sv.replicas
    threads = []

    def run_one(i: int, rid: int) -> None:
        subscriber = ParamSubscriber(DirectSubscription(session.server, rid),
                                     layout, replica_id=rid,
                                     device=session.device)
        refresher = Refresher(subscriber, sv.refresh_every_s)
        refresher.start()
        try:
            decoder = Decoder(cfg, plan, prompt_len=sv.prompt_len,
                              max_new=sv.max_new, max_batch=sv.max_batch,
                              device=session.device)
            decoder.warmup()
            worker = ReplicaWorker(
                rid, subscriber, BatchQueue(), decoder,
                staleness_bound=sv.staleness_bound,
                batch_window_ms=sv.batch_window_ms, max_batch=sv.max_batch)
            results[i] = drive_replica(
                worker, replica_chain(cfg, spec.data.seed, rid,
                                      prompt_len=sv.prompt_len,
                                      max_new=sv.max_new),
                requests=sv.requests, prompt_len=sv.prompt_len,
                pace_s=sv.request_every_ms / 1e3,
                start_at_version=sv.start_at_version)
        except Exception:
            results[i] = ReplicaResult(rid, error=traceback.format_exc())
        finally:
            refresher.stop()

    for i in range(sv.replicas):
        # replica ids sit AFTER the trainers' (workers 0..W-1), the
        # transport engine's slot convention
        t = threading.Thread(target=run_one, args=(i, w + i), daemon=True,
                             name=f"serve-replica-{w + i}")
        t.start()
        threads.append(t)
    return threads, results


# ===================================================================
# engine: threaded parameter server
# ===================================================================
@register_engine("ps-threads")
class ThreadedPSSession(TrainingSession):
    """Worker threads pushing into an in-heap parameter server — the
    Algorithm-1 execution model.  All threads issue onto the device's
    one stream; each launch releases the GIL while it is queued."""

    OVERRIDES = frozenset({
        "verbose", "device", "params", "step_fn", "batches",
        "loss_from_aux", "speed_factors", "timeout", "model_config",
    })

    server = None
    workers: List = []
    obs_rig = None
    ft_rig = None
    #: ``ReplicaResult`` per serving replica, after ``run``
    serve_results = None

    def _start(self) -> None:
        params = self._ov.get("params")
        if params is None:
            params = _registry_params(self.spec, self.device,
                                      self._ov.get("model_config"))
        self.server = build_server(self.spec, params, self.device)
        if self.spec.ft.snapshots:
            self.ft_rig = _FtRig(self.spec.ft, self.server)
        if self.spec.obs.trace:
            self.obs_rig = _ObsRig(self.spec.obs)
            self.obs_rig.start(_obs_snapshot_fn(self.server))
        if self.verbose and self.server.plan is not None:
            print(self.server.plan.describe())

    def _run(self, steps: int) -> None:
        from repro_torch.ps.worker import PSWorker, run_cluster
        spec = self.spec
        w = spec.ps.workers
        iters = max(1, steps // w)
        speeds = _speed_factors(spec, self._ov.get("speed_factors"))
        make_step = self._step_factory()
        batches = self._batches_factory()
        loss_from_aux = self._ov.get("loss_from_aux", _default_loss_from_aux)
        self.workers = [
            PSWorker(i, self.server, make_step(), batches(i), iters,
                     speed_factor=speeds[i], wire_format=spec.wire.format,
                     delta_pull=spec.wire.delta_pull,
                     loss_from_aux=loss_from_aux)
            for i in range(w)]
        serve_threads, serve_results = _serve_threads(self)
        timeout = self._ov.get("timeout", 1200.0)
        run_cluster(self.server, self.workers, timeout=timeout)
        for t in serve_threads:
            t.join(timeout=timeout)
        if serve_threads:
            from repro_torch.serve import raise_on_replica_failure
            self.serve_results = serve_results
            stuck = [t.name for t in serve_threads if t.is_alive()]
            if stuck:
                raise RuntimeError(f"serve replicas {stuck} still running "
                                   f"after {timeout} s")
            raise_on_replica_failure(serve_results)
        if self.obs_rig is not None:
            self.obs_rig.finish()
        if self.verbose:
            m = self.server.metrics
            print(f"pushes={m.total_pushes} applied_updates="
                  f"{self.server.version} wait_s={m.total_wait:.2f} "
                  f"max_stale={m.max_staleness}")

    # -- worker construction ------------------------------------------
    def _step_factory(self):
        """() -> step_fn per worker.  Tree wire: loss and backward on the
        pulled tree, the gradient tree out.  Packed wire: see
        ``packed_step``."""
        step_fn = self._ov.get("step_fn")
        if step_fn is not None:
            return lambda: step_fn
        cfg, _ = _model_setup(self.spec, self._ov.get("model_config"))
        if self.spec.wire.format == "tree":
            grads_of = _grads_fn(cfg)
            return lambda: grads_of
        return lambda: packed_step(cfg, self.server.plan, self.device,
                                   current_plan=lambda: self.server.plan)

    def _batches_factory(self):
        batches = self._ov.get("batches")
        if batches is not None:
            return batches
        cfg, data_cfg = _model_setup(self.spec, self._ov.get("model_config"))
        return lambda w: worker_batches(cfg, data_cfg, w, self.device)

    # -- reporting ----------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out = _ps_metrics(self.engine, self.server, self.obs_rig)
        if self.ft_rig is not None:
            out["ft"] = self.ft_rig.metrics()
        if self.serve_results is not None:
            from repro_torch.serve import aggregate_serve
            out["serve"] = aggregate_serve(self.serve_results)
        return out

    def _close(self) -> None:
        if self.ft_rig is not None:
            self.ft_rig.finish()
        if self.server is not None:
            self.server.shutdown()
        if self.obs_rig is not None:
            self.obs_rig.finish()


# ===================================================================
# engine: process-isolated transport workers
# ===================================================================
@register_engine("ps-transport")
class TransportPSSession(TrainingSession):
    """Spawned worker processes pushing packed frames over a real wire
    (tcp / shmem) into a ``PSServerEndpoint``; or an endpoint for the
    caller's own clients (``external_workers=True``, also over the
    in-process loopback)."""

    OVERRIDES = frozenset({
        "verbose", "device", "params", "external_workers",
        "speed_factors", "timeout", "model_config",
    })

    server = None
    endpoint = None
    transport = None
    #: ``WorkerResult`` per spawned worker, after ``run``
    results = None
    #: ``ReplicaResult`` per spawned serving replica, after ``run``
    serve_results = None
    obs_rig = None
    ft_rig = None

    def _start(self) -> None:
        from repro_torch.transport import PSServerEndpoint, make_transport
        spec = self.spec
        params = self._ov.get("params")
        if params is None:
            params = _registry_params(spec, self.device,
                                      self._ov.get("model_config"))
        self.server = build_server(spec, params, self.device)
        if spec.ft.snapshots:
            self.ft_rig = _FtRig(spec.ft, self.server)
        if spec.obs.trace:
            self.obs_rig = _ObsRig(spec.obs)
        self.endpoint = PSServerEndpoint(
            self.server,
            collector=self.obs_rig.collector if self.obs_rig else None)
        if self.obs_rig is not None:
            self.obs_rig.start(_obs_snapshot_fn(self.server))
        # serving replicas take the transport slots AFTER the trainers'
        # (shmem allocates one segment per id; tcp ignores the count):
        # workers 0..W-1, replicas W..W+R-1
        self.transport = make_transport(
            spec.transport.kind,
            n_workers=spec.ps.workers + spec.serve.replicas,
            host=spec.transport.host, port=spec.transport.port)
        self.transport.serve(self.endpoint)

    def address(self):
        """The picklable transport address clients ``connect`` to."""
        self.start()
        return self.transport.address()

    def reshard(self, n_shards: int) -> bool:
        """Manual live-reshard trigger: migrate the running server's
        packed store to ``n_shards`` partitions WITHOUT stopping
        training (``repro_torch.ft.reshard``).  Workers resync through
        the version-delta full-pull fallback on their next pull.
        Returns False when the server is already at that arity."""
        self.start()
        if not hasattr(self.server, "reshard"):
            raise SpecError(
                "live resharding migrates the sharded server's packed "
                "stores — this spec builds "
                f"ps.kind={self.spec.ps.kind!r}; set ps.kind='sharded' "
                "with ps.apply='fused'")
        return bool(self.server.reshard(int(n_shards)))

    def _run(self, steps: int) -> None:
        if self._ov.get("external_workers"):
            raise SpecError("this session was built with "
                            "external_workers=True — connect your own "
                            "clients to session.address()")
        if self.spec.transport.kind == "inproc":
            raise SpecError(
                "transport.endpoint=True over inproc is the in-process "
                "serialization baseline for external clients — spawned "
                "workers cannot reach an in-process address; use "
                "external_workers=True or transport.kind='tcp'/'shmem'")
        if (self.spec.model.arch == CUSTOM_ARCH
                and self._ov.get("model_config") is None):
            raise SpecError(
                "transport workers rebuild the model from its config — "
                "model.arch='custom' cannot cross the spawn boundary "
                "(pass a registry arch or model_config=, or drive the "
                "endpoint with external_workers=True)")
        from repro_torch.launch.proc_pool import (ProcessWorkerPool,
                                                  WorkerTask,
                                                  raise_on_failure)
        spec = self.spec
        w = spec.ps.workers
        if self.device.type == "cuda":
            # Build the kernel library once, here, so the workers load it
            # instead of each compiling it.
            from repro_torch.kernels import cuda
            cuda.library()
        task = WorkerTask.from_spec(
            spec, max(1, steps // w), device=str(self.device),
            model_config=self._ov.get("model_config"),
            trace_spill=(self.obs_rig.make_spill_dir()
                         if self.obs_rig else ""))
        pool = ProcessWorkerPool(
            self.transport.address(), task, w,
            slowdowns=_speed_factors(spec, self._ov.get("speed_factors")))
        rpool = None
        if spec.serve.replicas > 0:
            from repro_torch.serve import ReplicaPool, ReplicaTask
            rtask = ReplicaTask.from_spec(
                spec, device=str(self.device),
                model_config=self._ov.get("model_config"),
                trace_spill=(self.obs_rig.make_spill_dir()
                             if self.obs_rig else ""))
            rpool = ReplicaPool(self.transport.address(), rtask,
                                spec.serve.replicas, first_id=w)
        pool.start()
        if rpool is not None:
            rpool.start()
        trigger_stop = _start_reshard_watch(self.server, spec.ft)
        timeout = self._ov.get("timeout", 1200.0)
        try:
            self.results = pool.join(timeout=timeout,
                                     endpoint=self.endpoint)
            if rpool is not None:
                # replicas drain their own request load; join them while
                # the wire is still up (their last refreshes and trace
                # flushes ride it)
                self.serve_results = rpool.join(timeout=timeout,
                                                endpoint=self.endpoint)
        finally:
            # Training is over either way: release gated workers and
            # tear the wire down before surfacing failures.
            if trigger_stop is not None:
                trigger_stop.set()
            self.close()
            pool.terminate()
            if rpool is not None:
                rpool.terminate()
        raise_on_failure(self.results)
        if rpool is not None:
            from repro_torch.serve import raise_on_replica_failure
            raise_on_replica_failure(self.serve_results)
        if self.verbose:
            m = self.server.metrics
            done = sum(r.iterations_done for r in self.results)
            print(f"workers={w} ({spec.transport.kind}) "
                  f"iterations={done} pushes={m.total_pushes} "
                  f"applied_updates={self.server.version} "
                  f"max_stale={m.max_staleness}")

    def metrics(self) -> Dict[str, Any]:
        out = _ps_metrics(self.engine, self.server, self.obs_rig)
        if self.results is not None:
            out["iterations_done"] = sum(r.iterations_done
                                         for r in self.results)
        if self.ft_rig is not None:
            out["ft"] = self.ft_rig.metrics()
        if self.serve_results is not None:
            from repro_torch.serve import aggregate_serve
            out["serve"] = aggregate_serve(self.serve_results)
        return out

    def _close(self) -> None:
        if self.ft_rig is not None:
            self.ft_rig.finish()
        if self.server is not None:
            self.server.shutdown()
        if self.transport is not None:
            self.transport.shutdown()
        # After the transport is down: every in-flight TRACE frame has
        # either reached the collector or is in the spill files the rig
        # recovers now.
        if self.obs_rig is not None:
            self.obs_rig.finish()


def _start_reshard_watch(server, ft):
    """Arm ``_reshard_watch`` on a thread when the spec asks for a live
    reshard; returns its stop event (None when unarmed)."""
    if not ft.reshards:
        return None
    import threading
    stop = threading.Event()
    threading.Thread(target=_reshard_watch, args=(server, ft, stop),
                     name="reshard-trigger", daemon=True).start()
    return stop


def _ps_metrics(engine: str, server, obs_rig=None) -> Dict[str, Any]:
    if server is None:
        return {"engine": engine}
    from repro_torch.perfcount import snapshot_all
    m = server.metrics
    losses = [loss for _, _, loss in m.loss_trajectory]
    out = {
        "engine": engine,
        "pushes": m.total_pushes,
        "applied_updates": server.version,
        "max_staleness": m.max_staleness,
        "total_wait": m.total_wait,
        "wait_fraction": m.wait_fraction(),
        "credit_releases": m.credit_releases,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "perfcount": snapshot_all(),
    }
    if obs_rig is not None and obs_rig.summary is not None:
        out["obs"] = obs_rig.summary
    return out
