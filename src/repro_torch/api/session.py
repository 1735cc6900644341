"""``build_session(spec) -> TrainingSession`` — the single wiring path.

Counterpart of ``repro/api/session.py`` for the engine the port has so
far, ``ps-threads``: W worker threads pushing the packed or the tree
wire into an in-heap ``ShardedParameterServer`` or monolithic
``ParameterServer``, with coalesced applies and wire compression as the
spec asks.

    with build_session(spec) as session:      # start() on enter
        session.run(steps)                    # blocks until trained
        print(session.metrics())
                                              # close() on exit

Device rule: the session runs on ``cuda:0``.  ``device=`` is a
build-time override like ``params=`` and ``step_fn=`` (not a ``RunSpec``
field, so the schema stays the reference's); tests pass
``device="cpu"``.  With no ``device=`` and no CUDA, ``build_session``
raises — it never carries on on the CPU.
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
    """(tree_compressor, wire_compression) — where the configured
    compression runs: the fused wire compression on the packed wire,
    the per-tensor tree compressor on the tree wire.  (The reference's
    third place, frame-level int8 over a process transport, comes with
    the transports, ROADMAP queue 1 item 6.)"""
    comp = spec.wire.compression
    if comp == "none":
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

    def _start(self) -> None:
        params = self._ov.get("params")
        if params is None:
            params = _registry_params(self.spec, self.device,
                                      self._ov.get("model_config"))
        self.server = build_server(self.spec, params, self.device)
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
        run_cluster(self.server, self.workers,
                    timeout=self._ov.get("timeout", 1200.0))
        if self.verbose:
            m = self.server.metrics
            print(f"pushes={m.total_pushes} applied_updates="
                  f"{self.server.version} wait_s={m.total_wait:.2f} "
                  f"max_stale={m.max_staleness}")

    # -- worker construction ------------------------------------------
    def _step_factory(self):
        """() -> step_fn per worker.  Tree wire: loss and backward on the
        pulled tree, the gradient tree out.  Packed wire: unpack the
        pulled wire into leaf views, loss and backward, pack the grads
        into the worker's own gradient wire."""
        step_fn = self._ov.get("step_fn")
        if step_fn is not None:
            return lambda: step_fn
        from repro_torch import tree as tree_util
        from repro_torch.models import registry
        from repro_torch.wireformat import WIRE_LANES
        cfg, _ = _model_setup(self.spec, self._ov.get("model_config"))
        loss_fn = registry.loss_fn(cfg)

        def grads_of(params, batch):
            leaves, treedef = tree_util.flatten(params)
            leaves = [x.detach().requires_grad_() for x in leaves]
            loss, _ = loss_fn(tree_util.unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
            return (tree_util.unflatten(treedef, list(grads)),
                    {"loss": loss.detach()})

        if self.spec.wire.format == "tree":
            return lambda: grads_of
        plan = self.server.plan
        layout = plan.wire_layout()
        device = self.device

        def make_step():
            # One gradient wire per worker, reused every iteration (the
            # counterpart of the reference's donated buffer).  Safe: the
            # server folds each region in synchronously inside
            # push_packed — its kernel is queued on the same stream, so
            # it reads the region before anything this worker queues
            # later writes it — and keeps no reference once push_packed
            # returns.
            wire_g = torch.zeros((layout.total_rows, WIRE_LANES),
                                 dtype=layout.dtype, device=device)

            def step(wire_p, batch):
                grads, aux = grads_of(plan.unpack(wire_p), batch)
                plan.pack(grads, out=wire_g)
                return wire_g, aux

            return step

        return make_step

    def _batches_factory(self):
        batches = self._ov.get("batches")
        if batches is not None:
            return batches
        from repro_torch.data.synthetic import batches as data_batches
        cfg, data_cfg = _model_setup(self.spec, self._ov.get("model_config"))
        device = self.device

        def worker_batches(w: int) -> Iterator:
            wcfg = dataclasses.replace(data_cfg, seed=data_cfg.seed + 1 + w)
            for b in data_batches(cfg, wcfg):
                yield {k: torch.from_numpy(v).to(device=device,
                                                 dtype=torch.long)
                       for k, v in b.items()}

        return worker_batches

    # -- reporting ----------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        return _ps_metrics(self.engine, self.server)

    def _close(self) -> None:
        if self.server is not None:
            self.server.shutdown()


def _ps_metrics(engine: str, server) -> Dict[str, Any]:
    if server is None:
        return {"engine": engine}
    from repro_torch.perfcount import snapshot_all
    m = server.metrics
    losses = [loss for _, _, loss in m.loss_trajectory]
    return {
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
