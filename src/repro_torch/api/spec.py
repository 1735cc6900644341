"""The declarative run specification: one frozen config tree per run.

The port's copy of the reference package's ``RunSpec``: the same
sections, fields, defaults, choices and validation, and the same JSON
(``dump_schema`` equals the checked-in ``schema.json``), so one spec
file drives either package.  On top of the reference's rules the port
refuses, with a ``SpecError`` naming the ROADMAP item that ports it,
the one value whose code path is not ported yet, ``ps.kind='none'``
(the SPMD pipeline; ``_require_ported``).  Every architecture of the
reference is accepted.

``RunSpec`` describes *what* to train and *how* the distributed pieces
fit together — model, data, optimizer, synchronization paradigm, server
kind, wire format, transport — and validates the whole combination at
construction time.  Invalid combinations (a tree wire over a process
transport, a fused apply on the monolithic server, ASP on the SPMD
pipeline, ...) raise ``SpecError`` with an actionable message instead
of failing deep inside a worker thread.

The tree is plain data: ``to_dict``/``from_dict`` round-trip it
bitwise, ``to_json``/``from_json`` wrap that for files, and
``dump_schema`` emits the full field/choice/default schema (the CI
API-surface lock).

Importing this module is light (no torch), so tooling can load and
``dump_schema`` anywhere.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional

#: Bump when a field changes meaning; ``from_dict`` accepts its own
#: version only (the schema lock makes accidental drift loud).
SPEC_VERSION = 1

SYNC_MODES = ("bsp", "asp", "ssp", "dssp")
ESTIMATORS = ("last", "ema", "median")
SERVER_KINDS = ("none", "mono", "sharded")
APPLY_MODES = ("tree", "fused", "packed")
GATING_MODES = ("sharded", "global")
WIRE_FORMATS = ("tree", "packed")
WIRE_COMPRESSIONS = ("none", "int8", "topk")
TRANSPORT_KINDS = ("inproc", "tcp", "shmem")

#: Sentinel arch meaning "parameters are supplied at build time"
#: (benchmarks / toy problems that never touch the model registry).
CUSTOM_ARCH = "custom"


class SpecError(ValueError):
    """An invalid RunSpec field or combination of fields."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def _choice(value: str, field: str, choices) -> None:
    _require(value in choices,
             f"{field}={value!r} is not one of {list(choices)}")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What to train.  ``arch`` is a ``repro_torch.configs`` key (dashed CLI
    id) or ``'custom'`` when params/step come from build-time
    overrides; ``smoke`` selects the reduced config.

    ``kernels`` selects worker-step kernel variants via the dispatch
    registry (``repro_torch.kernels.registry``): ``'auto'`` (per-device
    default — the Hopper kernels on CUDA, the plain formulations on the
    CPU), a bare
    variant applied to every op (``'pallas'``/``'xla'``), or
    comma-separated per-op overrides such as
    ``'attention=pallas,ssm_scan=xla_associative'``."""

    arch: str = "xlstm-125m"
    smoke: bool = True
    kernels: str = "auto"

    def __post_init__(self):
        _require(bool(self.arch), "model.arch must be a non-empty name")
        if self.arch != CUSTOM_ARCH:
            from repro_torch.configs import arch_names  # light import
            _require(self.arch in arch_names(),
                     f"model.arch={self.arch!r} is not a known "
                     f"architecture (have {arch_names()} or "
                     f"{CUSTOM_ARCH!r} for build-time overrides)")
        # torch-free half of the kernel registry: validates the grammar
        # and the per-op variant tables
        from repro_torch.kernels.interface import parse_kernels
        try:
            parse_kernels(self.kernels)
        except ValueError as e:
            raise SpecError(str(e)) from e


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """The deterministic synthetic stream (vocab comes from the model)."""

    seq_len: int = 64
    global_batch: int = 8
    seed: int = 0

    def __post_init__(self):
        _require(self.seq_len > 0, "data.seq_len must be positive")
        _require(self.global_batch > 0,
                 "data.global_batch must be positive")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Update rule.  On the SPMD engine ``name`` is a ``repro.optim``
    optimizer (``None`` = the model config's default); on the PS
    engines the server steps SGD/momentum (``name`` must then be
    ``None``, ``'sgd'`` or ``'momentum'``).  ``staleness_damping=None``
    keeps each engine's historical default (SPMD: on, PS server:
    off)."""

    name: Optional[str] = None
    lr: float = 3e-3
    momentum: float = 0.0
    staleness_damping: Optional[bool] = None

    def __post_init__(self):
        _require(self.lr > 0, "optimizer.lr must be positive")
        _require(0.0 <= self.momentum < 1.0,
                 "optimizer.momentum must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """Synchronization paradigm (the paper's axis).  ``staleness`` is
    the SSP threshold; ``[s_lower, s_upper]`` the DSSP range;
    ``estimator`` the Algorithm-2 interval predictor."""

    mode: str = "dssp"
    staleness: int = 1
    s_lower: int = 0
    s_upper: int = 3
    estimator: str = "last"

    def __post_init__(self):
        _choice(self.mode, "sync.mode", SYNC_MODES)
        _choice(self.estimator, "sync.estimator", ESTIMATORS)
        _require(self.staleness >= 0, "sync.staleness must be >= 0")
        _require(0 <= self.s_lower <= self.s_upper,
                 f"sync range needs 0 <= s_lower <= s_upper, got "
                 f"[{self.s_lower}, {self.s_upper}]")

    def policy_factory(self, n_workers: int) -> Callable[[], Any]:
        """Zero-arg factory of fresh ``SyncPolicy`` instances for this
        paradigm — the spec-level face of ``make_policy_factory``."""
        from repro_torch.core.policies import make_policy_factory
        return make_policy_factory(
            self.mode, n_workers=n_workers, staleness=self.staleness,
            s_lower=self.s_lower, s_upper=self.s_upper,
            estimator=self.estimator)


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Where the global weights live.

    ``kind='none'``    SPMD delayed-gradient pipeline (no server).
    ``kind='mono'``    monolithic ``ParameterServer`` (one lock);
                       ``apply`` in {tree, packed}.
    ``kind='sharded'`` ``ShardedParameterServer`` with ``shards``
                       partitions; ``apply`` in {tree, fused}.
    """

    kind: str = "none"
    shards: int = 0
    workers: int = 4
    apply: str = "tree"
    gating: str = "sharded"
    straggler: float = 1.0
    #: Coalescing window: up to this many concurrent workers' packed
    #: pushes fold through ONE batched kernel launch per shard.  1 =
    #: one launch per push (the historical behavior).
    coalesce: int = 1
    #: Flusher linger (milliseconds): how long an applying push waits
    #: for the window to fill before launching a partial batch.  The
    #: latency/batching trade — 0 batches only genuinely concurrent
    #: pushes; None keeps the server default (50 ms when coalescing).
    coalesce_wait_ms: Optional[float] = None

    def __post_init__(self):
        _choice(self.kind, "ps.kind", SERVER_KINDS)
        _choice(self.apply, "ps.apply", APPLY_MODES)
        _choice(self.gating, "ps.gating", GATING_MODES)
        _require(self.workers >= 1, "ps.workers must be >= 1")
        _require(self.straggler >= 1.0,
                 "ps.straggler is a slowdown factor (>= 1.0)")
        _require(self.coalesce >= 1,
                 "ps.coalesce is a window size (>= 1; 1 disables "
                 "coalescing)")
        _require(self.coalesce_wait_ms is None
                 or self.coalesce_wait_ms >= 0.0,
                 "ps.coalesce_wait_ms is a linger in milliseconds "
                 "(>= 0, or null for the server default)")
        if self.kind == "none":
            _require(self.shards == 0,
                     "ps.kind='none' (SPMD pipeline) takes ps.shards=0; "
                     "to shard a parameter server use ps.kind='sharded'")
            _require(self.apply == "tree",
                     "ps.apply selects a server apply path; the SPMD "
                     "pipeline (ps.kind='none') has none — leave it "
                     "'tree'")
            _require(self.coalesce == 1,
                     "ps.coalesce batches server-side applies; the SPMD "
                     "pipeline (ps.kind='none') has no server — set "
                     "ps.kind='mono'/'sharded' or leave ps.coalesce=1")
        elif self.kind == "mono":
            _require(self.shards in (0, 1),
                     "the monolithic server is one shard by definition "
                     f"(ps.shards={self.shards}); use ps.kind='sharded' "
                     "to partition")
            _require(self.apply != "fused",
                     "ps.apply='fused' is the sharded server's batched "
                     "apply; the monolithic server's packed path is "
                     "ps.apply='packed' (or use ps.kind='sharded')")
        else:  # sharded
            _require(self.shards >= 1,
                     "ps.kind='sharded' needs ps.shards >= 1")
            _require(self.apply != "packed",
                     "ps.apply='packed' is the monolithic server's "
                     "resident-wire mode; the sharded equivalent is "
                     "ps.apply='fused'")
        _require(self.gating == "sharded" or self.kind == "sharded",
                 "ps.gating='global' only applies to the sharded "
                 "server (it is the monolithic gating semantics)")


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Push/pull representation: per-leaf pytrees or the zero-repack
    packed (rows, 512) buffer, plus gradient compression."""

    format: str = "tree"
    compression: str = "none"
    topk_fraction: float = 0.05
    #: Version-delta pulls: workers track the server's per-shard
    #: version vector and pull only the shard regions that advanced
    #: (full-snapshot fallback on mismatch).  Packed wire only.
    delta_pull: bool = False

    def __post_init__(self):
        _choice(self.format, "wire.format", WIRE_FORMATS)
        _choice(self.compression, "wire.compression", WIRE_COMPRESSIONS)
        _require(0.0 < self.topk_fraction <= 1.0,
                 "wire.topk_fraction must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """How workers reach the server.  ``inproc`` runs workers in the
    server's process (threads); ``tcp``/``shmem`` spawn real worker
    processes speaking the packed frame protocol.  ``endpoint=True``
    serves the frame codec even in-process (the serialization
    baseline)."""

    kind: str = "inproc"
    endpoint: bool = False
    host: str = "127.0.0.1"
    port: int = 0

    def __post_init__(self):
        _choice(self.kind, "transport.kind", TRANSPORT_KINDS)
        _require(0 <= self.port <= 65535,
                 "transport.port must be a port number (0 = ephemeral)")

    @property
    def serves_endpoint(self) -> bool:
        """True when the run speaks the frame protocol (always for the
        process transports; opt-in for inproc)."""
        return self.kind != "inproc" or self.endpoint


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Run-wide tracing & telemetry (``repro_torch.obs``).

    ``trace=True`` arms the trace recorders everywhere the run executes
    (server process AND spawned workers — their rings merge into one
    timeline).  ``trace_path`` exports the merged trace on session
    close: ``.jsonl`` writes JSONL, anything else writes Chrome
    ``trace_event`` JSON (Perfetto-loadable).  ``sample_every`` > 0
    additionally samples server metrics (staleness histogram, per-worker
    wait, effective threshold) into the trace on that interval
    (seconds).
    """

    trace: bool = False
    trace_path: str = ""
    sample_every: float = 0.0

    def __post_init__(self):
        _require(self.sample_every >= 0.0,
                 "obs.sample_every is an interval in seconds (>= 0; "
                 "0 disables sampling)")
        if not self.trace:
            _require(not self.trace_path,
                     "obs.trace_path exports the recorded trace; it "
                     "needs obs.trace=true")
            _require(self.sample_every == 0.0,
                     "obs.sample_every samples into the recorded trace; "
                     "it needs obs.trace=true")


@dataclasses.dataclass(frozen=True)
class FtSpec:
    """Fault tolerance (``repro_torch.ft``): server snapshots, failover
    resume, worker reconnect, and deterministic chaos injection.

    Snapshots (``snapshot_every_s > 0``) periodically checkpoint the
    server's packed per-shard buffers + momentum + version vector +
    sync-policy state into ``dir`` (keep-K, atomic); ``resume=True``
    restores the latest snapshot before serving.  ``reconnect_tries``
    arms the worker-side failover loop: on a dead server a worker
    backs off (``reconnect_base_s`` doubling up to ``reconnect_max_s``,
    jittered) and re-HELLOs up to that many times.  The ``fault_*``
    fields are the ``FaultPlan`` (kill the server at aggregate push
    round R; worker W SIGKILLs itself at its local iteration R';
    drop/delay frames of a wireformat kind) — ``-1``/``0.0`` sentinels
    mean "never", and the seed makes injected chaos reproducible.
    """

    snapshot_every_s: float = 0.0  # 0 disables periodic snapshots
    keep: int = 3                  # keep-K snapshot GC
    dir: str = ""                  # checkpoint directory
    resume: bool = False           # restore latest snapshot on start
    reconnect_tries: int = 0       # 0 disables worker reconnect
    reconnect_base_s: float = 0.1
    reconnect_max_s: float = 2.0
    fault_kill_server_round: int = -1
    fault_kill_worker: int = -1
    fault_kill_worker_round: int = -1
    fault_drop_kind: int = 0
    fault_drop_prob: float = 0.0
    fault_delay_kind: int = 0
    fault_delay_ms: float = 0.0
    fault_kill_mid_reshard: bool = False
    fault_seed: int = 0
    #: Live reshard (``repro_torch.ft.reshard``): migrate the packed store to
    #: ``reshard_shards`` partitions WITHOUT stopping training, when
    #: the aggregate push count crosses ``reshard_round`` (manual
    #: trigger; -1 = never) and/or whenever one shard's share of the
    #: recent pushes exceeds ``reshard_hot_factor`` x the uniform share
    #: (hot-shard policy, read from the per-shard push metrics; 0
    #: disables).  0 shards disables resharding entirely.
    reshard_shards: int = 0
    reshard_round: int = -1
    reshard_hot_factor: float = 0.0

    def __post_init__(self):
        _require(self.snapshot_every_s >= 0.0,
                 "ft.snapshot_every_s is an interval in seconds (>= 0; "
                 "0 disables snapshots)")
        _require(self.keep >= 1, "ft.keep must keep at least one "
                 "snapshot (>= 1)")
        _require(self.reconnect_tries >= 0,
                 "ft.reconnect_tries must be >= 0 (0 disables worker "
                 "reconnect)")
        _require(self.reconnect_base_s > 0 and self.reconnect_max_s > 0,
                 "ft reconnect backoff delays must be positive")
        _require(0.0 <= self.fault_drop_prob <= 1.0,
                 "ft.fault_drop_prob is a probability in [0, 1]")
        _require(self.fault_delay_ms >= 0.0,
                 "ft.fault_delay_ms is a latency in milliseconds (>= 0)")
        if self.snapshot_every_s > 0 or self.resume:
            _require(bool(self.dir),
                     "ft snapshots/resume need ft.dir (the checkpoint "
                     "directory)")
        _require(self.reshard_shards >= 0,
                 "ft.reshard_shards is a target shard count (>= 1; 0 "
                 "disables live resharding)")
        _require(self.reshard_hot_factor >= 0.0,
                 "ft.reshard_hot_factor is a load-imbalance multiple "
                 "(> 1 makes sense; 0 disables the hot-shard policy)")
        if self.reshard_round >= 0 or self.reshard_hot_factor > 0.0:
            _require(self.reshard_shards >= 1,
                     "a reshard trigger (ft.reshard_round / "
                     "ft.reshard_hot_factor) needs a target arity: set "
                     "ft.reshard_shards >= 1")
        if self.fault_kill_mid_reshard:
            _require(self.reshard_shards >= 1 and self.reshard_round >= 0,
                     "ft.fault_kill_mid_reshard kills the server inside "
                     "a live migration — arm one with ft.reshard_round "
                     ">= 0 and ft.reshard_shards >= 1")

    def fault_plan(self):
        """The picklable ``repro_torch.ft.FaultPlan`` these fields describe."""
        from repro_torch.ft.faults import FaultPlan
        return FaultPlan(
            kill_server_round=self.fault_kill_server_round,
            kill_worker=self.fault_kill_worker,
            kill_worker_round=self.fault_kill_worker_round,
            drop_kind=self.fault_drop_kind,
            drop_prob=self.fault_drop_prob,
            delay_kind=self.fault_delay_kind,
            delay_ms=self.fault_delay_ms,
            kill_mid_reshard=self.fault_kill_mid_reshard,
            seed=self.fault_seed)

    @property
    def snapshots(self) -> bool:
        return self.snapshot_every_s > 0 or self.resume

    @property
    def reshards(self) -> bool:
        """Is a live reshard armed (by round and/or hot-shard policy)?"""
        return self.reshard_shards >= 1 and (
            self.reshard_round >= 0 or self.reshard_hot_factor > 0.0)

    @property
    def faults(self) -> bool:
        return (self.fault_kill_server_round >= 0
                or (self.fault_kill_worker >= 0
                    and self.fault_kill_worker_round >= 0)
                or self.fault_drop_prob > 0.0 or self.fault_delay_ms > 0.0
                or self.fault_kill_mid_reshard)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Online serving tier (``repro_torch.serve``): N replicas ride the SAME
    run as the training workers, keeping a resident packed parameter
    buffer fresh over the transport via version-delta pulls and serving
    decode requests through a continuous-batching queue.

    ``staleness_bound`` is the SSP-style freshness contract mirrored to
    the consumer side: a replica whose resident version vector trails
    the server by more than this many applied updates BLOCKS admission
    (forcing an immediate refresh) instead of serving stale weights —
    the serving analogue of the training gate's bound on gradient
    staleness.  ``refresh_every_s`` is the background refresh cadence
    between forced refreshes; ``batch_window_ms``/``max_batch`` shape
    the continuous-batching window; ``requests``/``prompt_len``/
    ``max_new`` size each replica's closed-loop request stream and
    ``request_every_ms`` paces it (so serving can be spread across the
    training run instead of bursting up front).
    """

    replicas: int = 0              # 0 disables the serving tier
    refresh_every_s: float = 0.05  # background delta-pull cadence
    staleness_bound: int = 4       # max versions behind at admission
    batch_window_ms: float = 2.0   # continuous-batching linger
    max_batch: int = 8             # decode requests per batch
    requests: int = 32             # closed-loop requests per replica
    request_every_ms: float = 0.0  # pacing between submits (0 = burst)
    start_at_version: int = 0      # delay serving until the server has
                                   # applied this many updates (0 = now)
    prompt_len: int = 16
    max_new: int = 8

    def __post_init__(self):
        _require(self.replicas >= 0,
                 "serve.replicas must be >= 0 (0 disables serving)")
        _require(self.refresh_every_s > 0.0,
                 "serve.refresh_every_s is the replica refresh cadence "
                 "in seconds (> 0)")
        _require(self.staleness_bound >= 0,
                 "serve.staleness_bound is the max applied updates a "
                 "replica may trail the server at admission (>= 0)")
        _require(self.batch_window_ms >= 0.0,
                 "serve.batch_window_ms is a linger in milliseconds "
                 "(>= 0; 0 batches only already-queued requests)")
        _require(self.max_batch >= 1, "serve.max_batch must be >= 1")
        _require(self.requests >= 1,
                 "serve.requests is each replica's closed-loop request "
                 "count (>= 1)")
        _require(self.request_every_ms >= 0.0,
                 "serve.request_every_ms paces the request stream in "
                 "milliseconds (>= 0; 0 submits as fast as possible)")
        _require(self.start_at_version >= 0,
                 "serve.start_at_version delays the request stream "
                 "until the server has applied that many updates "
                 "(>= 0; 0 serves from the initial weights)")
        _require(self.prompt_len >= 1, "serve.prompt_len must be >= 1")
        _require(self.max_new >= 1, "serve.max_new must be >= 1")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The whole run, validated as a unit.

    Cross-field rules (each raises ``SpecError`` at construction):

    * process transports (tcp/shmem) and in-process endpoints carry the
      packed wire format only — ``wire.format='tree'`` is rejected;
    * the packed wire needs a packed-resident store — ``ps.apply`` must
      be ``'packed'`` (mono) or ``'fused'`` (sharded);
    * the SPMD pipeline (``ps.kind='none'``) trains bsp/ssp/dssp only
      (ASP exists in the PS layer) and has no packed wire;
    * process transports need a parameter server and a registry arch
      (spawned workers rebuild the model from its config name);
    * compression needs an engine with a compression path (SPMD or the
      sharded server);
    * ``wire.delta_pull`` (version-delta pulls) and ``ps.coalesce > 1``
      (batched server apply) ride the packed wire only — over the tree
      wire both raise;
    * ``ft`` snapshots capture the packed-resident store, so they need
      a parameter server with ``ps.apply='fused'``/``'packed'``; the
      ``FaultPlan`` kills/drops cross a process boundary, so faults and
      worker reconnect need a process transport (and killing/restarting
      the server needs tcp — shmem segments die with their owner);
    * ``serve.replicas > 0`` rides the delta-pull protocol: it needs a
      parameter server, the packed wire with ``wire.delta_pull=true``,
      and a registry arch (replicas rebuild the decode path from the
      config name — ``'custom'`` cannot cross the spawn boundary).
    """

    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    optimizer: OptimizerSpec = dataclasses.field(
        default_factory=OptimizerSpec)
    sync: SyncSpec = dataclasses.field(default_factory=SyncSpec)
    ps: ServerSpec = dataclasses.field(default_factory=ServerSpec)
    wire: WireSpec = dataclasses.field(default_factory=WireSpec)
    transport: TransportSpec = dataclasses.field(
        default_factory=TransportSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    ft: FtSpec = dataclasses.field(default_factory=FtSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)

    def __post_init__(self):
        ps, wire, tp, sync = self.ps, self.wire, self.transport, self.sync
        ft = self.ft
        if self.serve.replicas > 0:
            _require(ps.kind != "none",
                     "serve.replicas subscribe to a live parameter "
                     "server; the SPMD pipeline (ps.kind='none') has "
                     "none — set ps.kind='mono'/'sharded'")
            _require(wire.format == "packed",
                     "serving replicas keep a resident packed buffer; "
                     "set wire.format='packed' (and ps.apply='fused'/"
                     "'packed')")
            _require(wire.delta_pull,
                     "serving replicas refresh via version-delta pulls "
                     "(bytes proportional to change — the high-"
                     "frequency refresh path); set wire.delta_pull="
                     "true")
            _require(self.model.arch != CUSTOM_ARCH,
                     "serving replicas rebuild the decode path from "
                     "the model config name — model.arch='custom' "
                     "cannot serve; name a registry architecture")
        if ft.snapshots:
            _require(ps.kind != "none",
                     "ft snapshots checkpoint a parameter server's "
                     "packed store; the SPMD pipeline (ps.kind='none') "
                     "has its own checkpointing — set ps.kind='mono'/"
                     "'sharded'")
            _require(ps.apply in ("fused", "packed"),
                     "ft snapshots capture the packed-resident store; "
                     "ps.apply='tree' keeps no packed buffers to "
                     "snapshot — set ps.apply='fused' (sharded) or "
                     "'packed' (mono)")
        if ft.reshards:
            _require(ps.kind == "sharded" and ps.apply == "fused",
                     "ft.reshard_* migrates packed regions between the "
                     "sharded server's stores; set ps.kind='sharded' "
                     "and ps.apply='fused'")
            _require(wire.format == "packed" and wire.delta_pull,
                     "live resharding resyncs clients through the "
                     "version-delta full-pull fallback; set wire."
                     "format='packed' and wire.delta_pull=true")
            _require(tp.kind in ("tcp", "shmem"),
                     "live resharding changes the wire layout under "
                     "running workers, which only the frame protocol "
                     "renegotiates — set transport.kind='tcp' or "
                     "'shmem'")
            _require(ft.reshard_shards != ps.shards,
                     f"ft.reshard_shards={ft.reshard_shards} equals "
                     "ps.shards — a live reshard to the same arity is "
                     "a no-op")
        if ft.faults:
            _require(tp.kind != "inproc",
                     "the FaultPlan kills processes and drops frames; "
                     "over transport.kind='inproc' there is no process "
                     "boundary to fault — set transport.kind='tcp' or "
                     "'shmem'")
        if (ft.fault_kill_server_round >= 0 or ft.reconnect_tries > 0
                or ft.fault_kill_mid_reshard):
            _require(tp.kind == "tcp",
                     "killing/restarting the server (and reconnecting "
                     "to it) needs transport.kind='tcp': shmem segments "
                     "die with the server process, so there is nothing "
                     "left to reconnect to")
        if ps.kind == "none":
            _require(sync.mode != "asp",
                     "sync.mode='asp' is not trainable on the SPMD "
                     "pipeline (ps.kind='none'); use a parameter server "
                     "(ps.kind='mono'/'sharded')")
            _require(wire.format == "tree",
                     "wire.format='packed' is the parameter-server hot "
                     "path; the SPMD pipeline has no wire — set "
                     "ps.kind='mono'/'sharded' or wire.format='tree'")
            _require(tp.kind == "inproc" and not tp.endpoint,
                     f"transport.kind={tp.kind!r} moves PS workers into "
                     "separate processes; the SPMD pipeline "
                     "(ps.kind='none') has no PS workers — set "
                     "ps.kind='sharded' (or 'mono') to use a transport")
        if wire.format == "packed":
            _require(ps.apply in ("fused", "packed"),
                     "wire.format='packed' needs a packed-resident "
                     "store: ps.apply='packed' (mono) or 'fused' "
                     "(sharded); ps.apply='tree' re-packs every push")
        if wire.delta_pull:
            _require(wire.format == "packed",
                     "wire.delta_pull serves version-delta pulls of the "
                     "packed snapshot; the tree wire has no per-shard "
                     "version vector to diff against — set wire.format="
                     "'packed' (and ps.apply='fused'/'packed')")
        if ps.coalesce > 1:
            _require(wire.format == "packed",
                     "ps.coalesce batches packed wire buffers through "
                     "one fused launch; the tree wire has nothing to "
                     "stack — set wire.format='packed' (and ps.apply="
                     "'fused'/'packed')")
        if tp.serves_endpoint:
            _require(wire.format == "packed",
                     f"transport.kind={tp.kind!r} carries the packed "
                     "frame protocol only — wire.format='tree' cannot "
                     "cross a process boundary; set wire.format="
                     "'packed' (and ps.apply='fused'/'packed')")
        if tp.kind != "inproc":
            _require(ps.kind != "none",
                     "process transports live in the PS layer; set "
                     "ps.kind='mono' or 'sharded'")
        if wire.compression != "none":
            _require(ps.kind != "mono",
                     f"wire.compression={wire.compression!r} has no "
                     "monolithic-server path; use ps.kind='sharded' "
                     "(fused wire compression) or ps.kind='none' "
                     "(worker-side error feedback)")
        if ps.kind != "none" and self.optimizer.name is not None:
            _require(self.optimizer.name in ("sgd", "momentum"),
                     f"optimizer.name={self.optimizer.name!r}: the "
                     "parameter server steps SGD/momentum (workers send "
                     "raw gradients); rich optimizers run on the SPMD "
                     "engine (ps.kind='none')")
        _require_ported(self)

    # ------------------------------------------------------------ dicts
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = SPEC_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        if not isinstance(d, dict):
            raise SpecError(f"spec must be a dict, got {type(d).__name__}")
        d = dict(d)
        version = d.pop("version", SPEC_VERSION)
        _require(version == SPEC_VERSION,
                 f"spec version {version!r} != supported {SPEC_VERSION}")
        sections = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - set(sections))
        _require(not unknown,
                 f"unknown spec section(s) {unknown}; valid sections: "
                 f"{sorted(sections)}")
        kwargs = {}
        for name, field in sections.items():
            sub = d.get(name)
            if sub is None:
                continue
            sub_cls = field.default_factory
            kwargs[name] = _sub_from_dict(sub_cls, name, sub)
        return cls(**kwargs)

    # ------------------------------------------------------------ json
    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"spec is not valid JSON: {e}") from e
        return cls.from_dict(d)

    # ------------------------------------------------------- conveniences
    def replace(self, **sections) -> "RunSpec":
        """``dataclasses.replace`` that re-runs whole-tree validation."""
        return dataclasses.replace(self, **sections)

    @property
    def engine(self) -> str:
        """Which session engine this spec selects (see repro_torch.api.session)."""
        if self.ps.kind == "none":
            return "spmd"
        if self.transport.serves_endpoint:
            return "ps-transport"
        return "ps-threads"


def _later(what: str, item: str) -> str:
    return (f"{what} is not ported to repro_torch yet (ROADMAP queue 1, "
            f"{item}); run it on the reference package")


def _require_ported(spec: "RunSpec") -> None:
    """Refuse every value whose code path a later slice ports."""
    _require(spec.ps.kind != "none",
             _later("ps.kind='none'", "item 11 (the SPMD pipeline)"))


def _sub_from_dict(sub_cls, section: str, sub: Any):
    if not isinstance(sub, dict):
        raise SpecError(f"spec section {section!r} must be a dict, got "
                        f"{type(sub).__name__}")
    valid = {f.name for f in dataclasses.fields(sub_cls)}
    unknown = sorted(set(sub) - valid)
    _require(not unknown,
             f"unknown field(s) {unknown} in spec section {section!r}; "
             f"valid fields: {sorted(valid)}")
    return sub_cls(**sub)


# ----------------------------------------------------------------- schema
#: field -> closed choice set (the schema surfaces these; validation
#: enforces them in each dataclass's __post_init__).
_FIELD_CHOICES = {
    ("sync", "mode"): SYNC_MODES,
    ("sync", "estimator"): ESTIMATORS,
    ("ps", "kind"): SERVER_KINDS,
    ("ps", "apply"): APPLY_MODES,
    ("ps", "gating"): GATING_MODES,
    ("wire", "format"): WIRE_FORMATS,
    ("wire", "compression"): WIRE_COMPRESSIONS,
    ("transport", "kind"): TRANSPORT_KINDS,
}


def dump_schema() -> Dict[str, Any]:
    """Machine-readable schema of the RunSpec surface: every section,
    field, type, default and closed choice set.
    ``src/repro_torch/api/schema.json`` is a copy of the reference's
    checked-in schema, and this must reproduce it."""
    schema: Dict[str, Any] = {"spec_version": SPEC_VERSION, "sections": {}}
    for sec_field in dataclasses.fields(RunSpec):
        if sec_field.name == "version":
            continue
        sub_cls = sec_field.default_factory
        fields = {}
        for f in dataclasses.fields(sub_cls):
            entry: Dict[str, Any] = {
                "type": _type_name(f.type),
                "default": f.default,
            }
            choices = _FIELD_CHOICES.get((sec_field.name, f.name))
            if choices is not None:
                entry["choices"] = list(choices)
            fields[f.name] = entry
        schema["sections"][sec_field.name] = {
            "class": sub_cls.__name__,
            "fields": fields,
        }
    return schema


def _type_name(annotation) -> str:
    text = annotation if isinstance(annotation, str) else str(annotation)
    return (text.replace("typing.", "")
                .replace("builtins.", "")
                .replace("<class '", "").replace("'>", ""))
