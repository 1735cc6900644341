"""The serving engine: decode requests against the live resident buffer.

Counterpart of ``repro/serve/engine.py``.  Three layers, composed the
same way for process replicas (transport) and thread replicas (in-heap):

  * ``Decoder``: greedy continuation over the packed wire buffer, with
    shapes pinned at construction (``max_batch`` x ``prompt_len``
    prompts, ``max_new`` tokens; a short batch is padded by repeating
    its last row).  The cache families (the dense, MoE and ``vlm``
    transformers) prefill in one forward through
    the kernel registry (attention, residual+RMSNorm and RMSNorm run
    their Hopper kernels on the card) and decode one token a step over
    a KV cache; the recurrent families (the Jamba hybrid) prefill token
    by token through their decode step, as the reference does.  The
    loop is driven from the host under ``torch.inference_mode``; only
    the finished tokens come back to it.
  * ``ReplicaWorker``: the serve loop.  Take a batch from the
    ``BatchQueue``, hold it at the ``wait_fresh`` admission gate until
    the resident buffer is within ``serve.staleness_bound`` of the
    server, snapshot buffer and version atomically, decode, complete
    each request with its latency, admitted staleness and served
    version.
  * ``ReplicaPool`` / ``_replica_main``: spawn-and-join plumbing that
    mirrors ``launch.proc_pool``: replica ids start at the trainer count
    (their transport slots sit after the trainers'), a ``ReplicaTask``
    crosses the spawn boundary, weights never do; the replica plans
    from ``meta`` shapes and runs on the task's device.

Replicas drive themselves closed-loop: each generates its own Markov
prompts (deterministic in ``(data_seed, replica_id, request)``) and
scores the legal-successor fraction of what it decoded, on parameters
that change underneath the decoder.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import TRACE
from repro_torch.serve.batching import BatchQueue, DecodeRequest
from repro_torch.serve.replica import ParamSubscriber, Refresher
from repro_torch.wireformat import WIRE_LANES

#: families whose decode state is a KV cache filled by one prefill
_CACHE_FAMILIES = ("dense", "moe", "vlm")


class Decoder:
    """Greedy decode over a packed wire buffer on one device.

    ``decode(wire, prompts)`` unpacks the buffer into the model tree
    (views of ``wire`` where a leaf lies whole in one shard) and
    continues every prompt by ``max_new`` greedy tokens.  ``prefill``
    and ``step`` are its two halves: ``prefill`` gives the last
    position's logits and the decode state, ``step`` one token's logits
    and the state, updated in place.
    """

    def __init__(self, cfg, plan, *, prompt_len: int, max_new: int,
                 max_batch: int, device=None):
        from repro_torch.models import registry

        if cfg.family == "audio":
            raise ValueError(
                "audio family serving is not supported: its decode path "
                "needs encoder frames, not token prompts")
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)
        self.rows = plan.wire_layout().total_rows
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.max_batch = int(max_batch)
        self._family = registry.family(cfg)
        self._step = registry.decode_fn(cfg)
        self._recurrent = cfg.family not in _CACHE_FAMILIES

    def rebuilt(self, n_shards: int) -> "Decoder":
        """A decoder for the same model at a new shard arity: the serve
        loop swaps to it when a live reshard changes the resident
        buffer's wire layout (the plan re-derived from shapes)."""
        return Decoder(self.cfg, self.plan.rebuild(n_shards),
                       prompt_len=self.prompt_len, max_new=self.max_new,
                       max_batch=self.max_batch, device=self.device)

    def warmup(self) -> None:
        """One full batch against a zeros buffer before the serve loop
        opens, so the first request's latency holds no first-call cost
        (the kernel library's load, the allocator's first blocks)."""
        layout = self.plan.wire_layout()
        wire = torch.zeros((layout.total_rows, WIRE_LANES),
                           dtype=layout.dtype, device=self.device)
        self.decode(wire, np.zeros((self.max_batch, self.prompt_len),
                                   np.int32))

    def params(self, wire) -> Any:
        """The parameter tree of a packed wire (a tensor, or a numpy
        array from the reference's plan): leaves that lie whole in one
        shard are views of the wire on this device."""
        if not isinstance(wire, torch.Tensor):
            wire = torch.from_numpy(np.array(wire))
        return self.plan.unpack(wire.to(self.device))

    @torch.inference_mode()
    def prefill(self, params, tokens: torch.Tensor):
        """tokens (b, prompt_len) on the device -> (last logits (b, v),
        state).  The dense cache is padded to ``prompt_len + max_new``
        along its sequence axis."""
        from repro_torch.models import transformer
        b, l = tokens.shape
        total = l + self.max_new
        if not self._recurrent:
            logits, cache = transformer.forward_prefill(self.cfg, params,
                                                        tokens)
            return logits[:, -1], {
                name: torch.nn.functional.pad(
                    t, [0, 0] * (t.dim() - 3) + [0, total - l])
                for name, t in cache.items()}
        state = self._family.init_state(self.cfg, b, total,
                                        device=self.device)
        last = None
        for i in range(l):
            last, state = self.step(params, tokens[:, i:i + 1], state, i)
        return last, state

    @torch.inference_mode()
    def step(self, params, token: torch.Tensor, state, index: int):
        """token (b, 1) at position ``index`` -> (logits (b, v), state)."""
        logits, state = self._step(params, token, state, index)
        return logits[:, -1], state

    @torch.inference_mode()
    def decode(self, wire, prompts: np.ndarray) -> np.ndarray:
        """(b, prompt_len) int32 prompts -> (b, max_new) greedy ids.
        ``wire`` may be aliased: pass a copy the caller owns."""
        b = prompts.shape[0]
        if prompts.shape != (b, self.prompt_len) or b > self.max_batch:
            raise ValueError(
                f"prompts {prompts.shape} do not fit this decoder "
                f"(<= {self.max_batch} rows of {self.prompt_len})")
        if b < self.max_batch:  # pad: the shapes stay pinned
            pad = np.repeat(prompts[-1:], self.max_batch - b, axis=0)
            prompts = np.concatenate([prompts, pad], axis=0)
        toks = torch.from_numpy(np.ascontiguousarray(prompts)).to(
            device=self.device, dtype=torch.long)
        params = self.params(wire)
        last, state = self.prefill(params, toks)
        next_tok = torch.argmax(last, dim=-1)[:, None]
        out = [next_tok]
        for j in range(self.max_new - 1):
            logits, state = self.step(params, next_tok, state,
                                      self.prompt_len + j)
            next_tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(next_tok)
        return torch.cat(out, dim=1)[:b].cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class ReplicaResult:
    """What one replica hands back when its serve loop drains."""

    replica_id: int
    served: int = 0                 # requests completed
    batches: int = 0                # decode calls
    violations: int = 0             # admissions with staleness > bound
    blocks: int = 0                 # admission-gate stalls
    refreshes: int = 0              # delta pulls that landed
    full_refreshes: int = 0         # of which carried the full snapshot
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    staleness_values: List[int] = dataclasses.field(default_factory=list)
    served_versions: List[int] = dataclasses.field(default_factory=list)
    legal_fraction: float = 0.0     # Markov-legal generated transitions
    span_s: float = 0.0             # first submit -> last completion
    error: Optional[str] = None
    exitcode: Optional[int] = None
    # -- diagnostics (they change no behaviour) -------------------------
    #: region bytes copied into the resident buffer
    refresh_bytes: int = 0
    #: a spawned replica's kernel launches (``perfcount.LAUNCHES``), its
    #: warm-up batch included, and its ``max_memory_allocated`` (0 on
    #: the CPU); thread replicas share their process's counters
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_memory_bytes: int = 0


class ReplicaWorker:
    """The serve loop around one queue, one subscriber and one decoder."""

    def __init__(self, replica_id: int, subscriber: ParamSubscriber,
                 queue: BatchQueue, decoder: Decoder, *,
                 staleness_bound: int, batch_window_ms: float,
                 max_batch: int):
        self.replica_id = int(replica_id)
        self.subscriber = subscriber
        self.queue = queue
        self.decoder = decoder
        self.staleness_bound = int(staleness_bound)
        self.window_s = float(batch_window_ms) / 1e3
        self.max_batch = int(max_batch)

    def serve(self) -> ReplicaResult:
        res = ReplicaResult(self.replica_id)
        sub = self.subscriber
        t_start = time.perf_counter()
        while True:
            batch = self.queue.next_batch(self.max_batch, self.window_s)
            if batch is None:
                break
            # the admission gate: blocks until the resident buffer is
            # within bound (or the server stopped: frozen weights)
            staleness = sub.wait_fresh(self.staleness_bound)
            wire, version = sub.snapshot()
            for _ in range(4):  # bounded: re-snapshot if a reshard races
                n_shards = len(sub.versions)
                if (wire.shape[0] == self.decoder.rows
                        and n_shards == self.decoder.plan.n_shards):
                    break
                # A live reshard landed between batches: the resident
                # buffer is in a new wire layout.  Re-derive the plan at
                # the subscriber's arity; the weights occupy the same
                # canonical element space, so the unpacked tree is the
                # same.  The arity is checked as well as the row count:
                # two arities can share a row count (the dense smoke
                # model has 240 rows at 2, 3 and 6 shards).
                self.decoder = self.decoder.rebuilt(n_shards)
                wire, version = sub.snapshot()
            t0 = TRACE.now() if TRACE.enabled else 0.0
            prompts = np.stack([r.prompt for r in batch]).astype(np.int32)
            tokens = self.decoder.decode(wire, prompts)
            del wire
            if TRACE.enabled:
                TRACE.span("decode_batch", t0, worker=self.replica_id,
                           args={"batch": len(batch),
                                 "staleness": staleness,
                                 "version": version})
            done_t = time.perf_counter()
            for i, r in enumerate(batch):
                r.tokens = tokens[i]
                r.latency_s = done_t - r.enqueue_t
                r.staleness = staleness
                r.version = version
                r.done.set()
                res.latencies_s.append(r.latency_s)
            res.served += len(batch)
            res.batches += 1
            res.staleness_values.append(staleness)
            res.served_versions.append(version)
            if staleness > self.staleness_bound:
                res.violations += 1  # the gate failed: count it loudly
        res.blocks = sub.blocks
        res.refreshes = sub.refreshes
        res.full_refreshes = sub.full_refreshes
        res.refresh_bytes = sub.refresh_bytes
        res.span_s = time.perf_counter() - t_start
        return res


def legal_fraction(chain, prompts: np.ndarray,
                   generated: np.ndarray) -> float:
    """Fraction of generated transitions that are legal successors in
    the Markov chain: 1.0 for a trained model, about branching/vocab
    for random weights."""
    succ = [set(row) for row in np.asarray(chain.successors)]
    legal = total = 0
    for p_row, g_row in zip(prompts, generated):
        prev = int(p_row[-1])
        for tok in g_row:
            tok = int(tok)
            legal += tok in succ[prev]
            total += 1
            prev = tok
    return legal / max(1, total)


def drive_replica(worker: ReplicaWorker, chain, *, requests: int,
                  prompt_len: int, pace_s: float = 0.0,
                  start_at_version: int = 0) -> ReplicaResult:
    """Run one replica closed-loop: a producer thread submits
    ``requests`` deterministic Markov prompts (lightly paced so the
    linger window sees arrivals, not one pre-filled queue), the serve
    loop drains them, and the result is scored for legality.

    ``start_at_version`` holds the request stream back until the server
    has applied that many updates (or stopped), so serving overlaps
    training instead of draining against the initial weights."""
    queue = worker.queue
    rid = worker.replica_id
    sub = worker.subscriber
    while sub.server_version < start_at_version and not sub.stopped:
        sub.staleness()  # refreshes the live view on in-heap subs
        time.sleep(0.02)
    reqs: List[DecodeRequest] = []

    def produce() -> None:
        for i in range(requests):
            row = chain.sample_rows(i, np.array([rid]))[0]
            r = DecodeRequest(request_id=i,
                              prompt=row[:prompt_len].astype(np.int32),
                              enqueue_t=time.perf_counter())
            reqs.append(r)
            queue.submit(r)
            if pace_s > 0:
                time.sleep(pace_s)
        queue.close()

    producer = threading.Thread(target=produce, daemon=True,
                                name=f"replica-requests-{rid}")
    producer.start()
    result = worker.serve()
    producer.join(timeout=30.0)
    done = [r for r in reqs if r.tokens is not None]
    if done:
        result.legal_fraction = legal_fraction(
            chain, np.stack([r.prompt for r in done]),
            np.stack([r.tokens for r in done]))
    return result


# -- spawn plumbing (mirrors launch.proc_pool) ---------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaTask:
    """Everything a spawned replica needs; picklable and small: weights
    arrive over the transport, never the spawn boundary."""

    arch: str
    n_shards: int
    smoke: bool = True
    kernels: str = "auto"
    compress: str = "none"
    requests: int = 32
    request_every_ms: float = 0.0
    start_at_version: int = 0
    prompt_len: int = 16
    max_new: int = 8
    max_batch: int = 8
    batch_window_ms: float = 2.0
    staleness_bound: int = 4
    refresh_every_s: float = 0.05
    data_seed: int = 0
    trace: bool = False
    trace_spill: str = ""
    device: str = "cuda:0"    # the session's device
    #: a ``ModelConfig`` in place of ``arch``/``smoke`` (the session's
    #: ``model_config=`` override)
    model_config: Any = None

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_spec(cls, spec, *, device: str = "cuda:0", model_config=None,
                  trace_spill: str = "") -> "ReplicaTask":
        return cls(arch=spec.model.arch,
                   n_shards=max(1, spec.ps.shards),
                   smoke=spec.model.smoke,
                   kernels=spec.model.kernels,
                   compress=("int8" if spec.wire.compression == "int8"
                             else "none"),
                   requests=spec.serve.requests,
                   request_every_ms=spec.serve.request_every_ms,
                   start_at_version=spec.serve.start_at_version,
                   prompt_len=spec.serve.prompt_len,
                   max_new=spec.serve.max_new,
                   max_batch=spec.serve.max_batch,
                   batch_window_ms=spec.serve.batch_window_ms,
                   staleness_bound=spec.serve.staleness_bound,
                   refresh_every_s=spec.serve.refresh_every_s,
                   data_seed=spec.data.seed,
                   trace=spec.obs.trace,
                   trace_spill=trace_spill,
                   device=device,
                   model_config=model_config)


def replica_chain(cfg, data_seed: int, replica_id: int, *,
                  prompt_len: int, max_new: int):
    """Replica ``replica_id``'s prompt stream: the Markov chain seeded
    ``data_seed + 1000 + replica_id``, as in the reference."""
    from repro_torch.data.synthetic import DataConfig, MarkovLM
    return MarkovLM(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=prompt_len + max_new,
                               global_batch=1,
                               seed=data_seed + 1000 + replica_id))


def _replica_main(task: Dict[str, Any], address, replica_id: int,
                  queue) -> None:
    """Entry point of one spawned serving replica process."""
    result = ReplicaResult(replica_id)
    try:
        import json

        from repro_torch.launch.proc_pool import _task_config
        from repro_torch.models import registry
        from repro_torch.perfcount import LAUNCHES
        from repro_torch.ps.sharded.plan import build_shard_plan
        from repro_torch.serve.replica import TransportSubscription
        from repro_torch.transport import connect

        device = torch.device(task["device"])
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"replica {replica_id} was given {device} and finds "
                    "no CUDA device")
            torch.cuda.set_device(device)
        cfg = _task_config(task)
        plan = build_shard_plan(registry.abstract_params(cfg),
                                task["n_shards"])
        layout = plan.wire_layout()

        spill_fh = None
        if task["trace"]:
            TRACE.enable(source=f"w{replica_id}")
            if task["trace_spill"]:
                os.makedirs(task["trace_spill"], exist_ok=True)
                spill_fh = open(os.path.join(task["trace_spill"],
                                             f"w{replica_id}.jsonl"),
                                "a", encoding="utf-8")

        client = connect(address, replica_id, compress=task["compress"])
        sub = TransportSubscription(client, task["n_shards"])
        if sub.rows != layout.total_rows:
            raise ValueError(
                f"server wire layout has {sub.rows} rows, local plan "
                f"derives {layout.total_rows}: replica task out of sync "
                "with the server")
        subscriber = ParamSubscriber(sub, layout, replica_id=replica_id,
                                     device=device)
        refresher = Refresher(subscriber, task["refresh_every_s"])
        refresher.start()
        try:
            decoder = Decoder(cfg, plan, prompt_len=task["prompt_len"],
                              max_new=task["max_new"],
                              max_batch=task["max_batch"], device=device)
            LAUNCHES.reset()
            decoder.warmup()
            worker = ReplicaWorker(
                replica_id, subscriber, BatchQueue(), decoder,
                staleness_bound=task["staleness_bound"],
                batch_window_ms=task["batch_window_ms"],
                max_batch=task["max_batch"])
            result = drive_replica(
                worker, replica_chain(cfg, task["data_seed"], replica_id,
                                      prompt_len=task["prompt_len"],
                                      max_new=task["max_new"]),
                requests=task["requests"], prompt_len=task["prompt_len"],
                pace_s=task["request_every_ms"] / 1e3,
                start_at_version=task["start_at_version"])
        finally:
            refresher.stop()
            result.launches = LAUNCHES.snapshot()
            if device.type == "cuda":
                result.peak_memory_bytes = torch.cuda.max_memory_allocated(
                    device)
            if TRACE.enabled:
                events = TRACE.drain()
                if events and spill_fh is not None:
                    for e in events:
                        spill_fh.write(json.dumps(e, separators=(",", ":")))
                        spill_fh.write("\n")
                    spill_fh.flush()
                if events:
                    try:
                        client.send_trace(events)
                    except Exception:
                        pass  # server gone: the spill still has them
            sub.close()
            if spill_fh is not None:
                spill_fh.close()
        queue.put(result)
    except BaseException:
        result.error = traceback.format_exc()
        queue.put(result)
        raise


class ReplicaPool:
    """Spawn/join R serving replicas on transport slots from
    ``first_id`` (the trainer count: workers take 0..W-1, replicas
    W..W+R-1, one shmem segment or tcp connection each)."""

    def __init__(self, address, task: ReplicaTask, n_replicas: int, *,
                 first_id: int):
        self.address = address
        self.task = task
        self.n_replicas = int(n_replicas)
        self.first_id = int(first_id)
        self._ctx = multiprocessing.get_context("spawn")
        self._queue = self._ctx.Queue()
        self.procs: List[multiprocessing.Process] = []

    def start(self) -> None:
        task = self.task.to_dict()
        for i in range(self.n_replicas):
            rid = self.first_id + i
            p = self._ctx.Process(
                target=_replica_main,
                args=(task, self.address, rid, self._queue),
                name=f"ps-serve-replica-{rid}", daemon=True)
            p.start()
            self.procs.append(p)

    def join(self, timeout: float = 900.0, *,
             endpoint=None) -> List[ReplicaResult]:
        deadline = time.monotonic() + timeout
        by_id: Dict[int, ReplicaResult] = {}
        reported = set()
        # poll, draining results as they come: a child exits only once
        # its queued result is flushed to the pipe
        while time.monotonic() < deadline:
            self._drain(by_id)
            alive = False
            for i, p in enumerate(self.procs):
                rid = self.first_id + i
                if p.is_alive():
                    alive = True
                elif p.exitcode not in (0, None) and rid not in reported:
                    if endpoint is not None:
                        endpoint.on_disconnect(rid)  # unsubscribe only
                    reported.add(rid)
            if not alive:
                break
            time.sleep(0.05)
        self._drain(by_id)
        results = []
        for i, p in enumerate(self.procs):
            rid = self.first_id + i
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            r = by_id.get(rid) or ReplicaResult(
                rid, error="no result (killed or timed out)")
            r.exitcode = p.exitcode
            results.append(r)
        return results

    def _drain(self, into: Dict[int, ReplicaResult]) -> None:
        import queue as _queue
        while True:
            try:
                r = self._queue.get_nowait()
            except _queue.Empty:
                return
            into[r.replica_id] = r

    def terminate(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=5.0)


def raise_on_replica_failure(results: Sequence[ReplicaResult]) -> None:
    failed = [r for r in results if r is not None and r.error]
    if failed:
        msgs = "\n".join(f"-- replica {r.replica_id} "
                         f"(exit {r.exitcode}) --\n{r.error}"
                         for r in failed)
        raise RuntimeError(f"{len(failed)} replica(s) failed:\n{msgs}")


# -- aggregation ----------------------------------------------------------

def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def aggregate_serve(results: Sequence[ReplicaResult]) -> Dict[str, Any]:
    """One serve-metrics dict from per-replica results: the shape of
    ``session.metrics()['serve']``, the reference's keys."""
    results = [r for r in results if r is not None]
    lat = [s for r in results for s in r.latencies_s]
    stale = [s for r in results for s in r.staleness_values]
    versions = [v for r in results for v in r.served_versions]
    hist: Dict[str, int] = {}
    for s in stale:
        hist[str(s)] = hist.get(str(s), 0) + 1
    span = max((r.span_s for r in results), default=0.0)
    served = sum(r.served for r in results)
    return {
        "replicas": len(results),
        "requests": served,
        "batches": sum(r.batches for r in results),
        "violations": sum(r.violations for r in results),
        "blocks": sum(r.blocks for r in results),
        "refreshes": sum(r.refreshes for r in results),
        "full_refreshes": sum(r.full_refreshes for r in results),
        "requests_per_s": served / span if span > 0 else 0.0,
        "p50_ms": _percentile(lat, 0.50) * 1e3,
        "p99_ms": _percentile(lat, 0.99) * 1e3,
        "staleness_hist": hist,
        "staleness_max": max(stale, default=0),
        "version_min": min(versions, default=-1),
        "version_max": max(versions, default=-1),
        "legal_fraction": (sum(r.legal_fraction for r in results)
                           / len(results)) if results else 0.0,
    }


__all__ = [
    "Decoder",
    "ReplicaPool",
    "ReplicaResult",
    "ReplicaTask",
    "ReplicaWorker",
    "aggregate_serve",
    "drive_replica",
    "legal_fraction",
    "raise_on_replica_failure",
    "replica_chain",
]
