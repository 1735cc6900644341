"""Replica-side parameter subscription: the consumer half of the
version-vector protocol.

Counterpart of ``repro/serve/replica.py``.  A serving replica never
pushes: it *subscribes* to the live parameter server and keeps a
resident copy of the packed (rows, 512) wire buffer fresh through
version-delta pulls.  Each refresh sends the per-shard version vector
of the resident copy and receives only the shard regions that advanced
(a full snapshot on a dominance mismatch, the protocol the training
workers ride).

The resident buffer lives on the replica's device, as a transport
worker's does (``launch/proc_pool.py``): regions are ``copy_``'d into
it in place, on the current stream.  ``snapshot`` hands decode a device
clone taken under the lock, so decode never aliases the buffer the
refresher patches.

Freshness is the SSP bound mirrored to the consumer side.  Every reply
carries the server's aggregate version (the applied-update count), so
the replica knows how far its resident copy trails:

    staleness = last_seen_server_version - sum(resident version vector)

``wait_fresh(bound)`` is the admission gate: while staleness exceeds
``serve.staleness_bound`` the caller blocks (a ``staleness_block`` obs
span), an immediate refresh is forced, and admission proceeds only once
the resident buffer is within the bound again.  A stopped server
freezes the final weights, which are then fresh by definition.

Two subscription backends share the protocol: ``TransportSubscription``
speaks frames over tcp/shmem from a replica process;
``DirectSubscription`` reads an in-heap server from a replica thread
(the ``ps-threads`` engine and the unit tests, where "last heard from"
is a live read).
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import TRACE
from repro_torch.wireformat import WIRE_LANES


class Subscription:
    """One refresh channel to the parameter server.

    ``refresh(versions)`` returns ``(versions', patches, server_version,
    full)`` where ``patches`` is ``[(shard, region), ...]`` for the
    shards that advanced, or ``None`` once the server has stopped.
    """

    n_shards: int = 1
    rows: int = 0

    def refresh(self, versions: Sequence[int]):
        raise NotImplementedError

    def close(self) -> None:
        pass


class TransportSubscription(Subscription):
    """Frames over a live transport: MSG_SUB once, PULL_DELTA forever.

    ``client`` is a ``PSTransportClient``; ``subscribe()``, not
    ``hello()``, registers it, so the replica never takes a barrier seat
    and the training gate never waits on a consumer.  Regions view the
    client's receive buffer (``copy=False``): valid until the next
    request, which the subscriber sends only after copying them."""

    def __init__(self, client, n_shards: int):
        self.client = client
        self.n_shards = int(n_shards)
        self.rows = client.subscribe()
        # the SUB reply's clock is the server version at registration:
        # the subscriber's starting freshness reference
        self.initial_version = int(client.clock)

    def refresh(self, versions: Sequence[int]):
        d = self.client.pull_delta(versions, copy=False)
        if d is None:
            return None  # STOP reply: training over, weights frozen
        # every reply's clock is the server version at reply time
        return d.versions, list(zip(d.shards, d.regions)), \
            int(self.client.clock), d.full

    def close(self) -> None:
        self.client.close()


class DirectSubscription(Subscription):
    """In-heap server access for replica threads.  The regions are the
    server's own shard tensors: every apply makes new ones, so a region
    grabbed here is a consistent snapshot to copy from."""

    def __init__(self, server, replica_id: int):
        self.server = server
        self.replica_id = int(replica_id)
        self.n_shards = int(getattr(server, "n_shards", 1))
        self.rows = server.plan.wire_layout().total_rows

    def refresh(self, versions: Sequence[int]):
        server = self.server
        if server.stopped \
                and tuple(versions) == tuple(server.shard_versions()):
            # Caught up with the FINAL weights: only now may "stopped"
            # freeze the replica (stopping at an older vector would
            # serve pre-final parameters forever).
            return None
        d = server.pull_delta(self.replica_id, tuple(versions))
        regions = [(int(j), r) for j, r in zip(d.shards, d.regions)]
        return tuple(d.versions), regions, int(server.version), d.full

    def live_version(self) -> int:
        """The server's version RIGHT NOW (an in-heap read)."""
        return int(self.server.version)


class ParamSubscriber:
    """The resident packed buffer and its freshness state machine.

    Thread-safe: the background ``Refresher`` patches the buffer while
    decode threads snapshot it and block in ``wait_fresh``.  The
    resident copy starts at the bootstrap vector ``(-1,) * n_shards``
    (dominated by everything, so the first refresh is the full
    snapshot) and is patched region by region in place: steady-state
    refresh bytes follow what changed, never the model size.
    """

    def __init__(self, subscription: Subscription, layout, *,
                 replica_id: int = -1, device=None):
        self.sub = subscription
        self.replica_id = int(replica_id)
        self.layout = layout
        self.device = resolve_device(device)
        self._buf = torch.zeros((layout.total_rows, WIRE_LANES),
                                dtype=layout.dtype, device=self.device)
        self._row_start = layout.shard_row_start
        self._cond = threading.Condition()
        self.versions: Tuple[int, ...] = (-1,) * subscription.n_shards
        #: server version at the LAST reply (what staleness trails)
        self.server_version = int(getattr(subscription,
                                          "initial_version", 0))
        self.stopped = False
        self.refreshes = 0
        self.full_refreshes = 0
        self.blocks = 0
        #: bytes of the regions copied into the resident buffer
        self.refresh_bytes = 0
        #: set by ``wait_fresh`` to demand an out-of-cadence refresh
        self.refresh_needed = threading.Event()

    # -- refresh (Refresher thread / admission-forced) -------------------
    def refresh(self) -> bool:
        """One delta pull into the resident buffer.  Returns False once
        the server has stopped (the resident copy is then final)."""
        t0 = TRACE.now() if TRACE.enabled else 0.0
        try:
            out = self.sub.refresh(self.versions)
        except Exception:
            out = None  # a dead transport is a stopped server for a replica
        with self._cond:
            if out is None:
                self.stopped = True
                self._cond.notify_all()
                return False
            versions, patches, server_version, full = out
            del out
            if len(versions) != len(self.versions):
                # Live reshard: the shard arity changed and the reply is
                # a full snapshot in the NEW layout.  Regions arrive in
                # shard order, so the running sum of their row counts IS
                # the new ``shard_row_start`` (a shard absent from a
                # full reply is empty: zero rows).
                rows_by_shard = [0] * len(versions)
                for j, region in patches:
                    rows_by_shard[int(j)] = int(region.shape[0])
                starts, acc = [], 0
                for r in rows_by_shard:
                    starts.append(acc)
                    acc += r
                self._row_start = tuple(starts)
                self._buf = torch.zeros((acc, WIRE_LANES),
                                        dtype=self._buf.dtype,
                                        device=self.device)
            n_patches = len(patches)
            for j, region in patches:
                r0 = self._row_start[j]
                self._buf[r0:r0 + region.shape[0]].copy_(region)
                self.refresh_bytes += region.numel() * region.element_size()
            # the regions may view a transport's receive buffer (a live
            # view would pin a shmem slot): drop them before the next
            # request
            patches = region = None
            self.versions = tuple(int(v) for v in versions)
            self.server_version = max(self.server_version,
                                      int(server_version))
            self.refreshes += 1
            if full:
                self.full_refreshes += 1
            self._cond.notify_all()
        if TRACE.enabled:
            TRACE.span("replica_refresh", t0, worker=self.replica_id,
                       args={"shards": n_patches, "full": bool(full),
                             "staleness": self.staleness()})
        return True

    # -- freshness -------------------------------------------------------
    #: staleness of a never-refreshed replica: no bound admits it, so the
    #: first decode always waits for the bootstrap full snapshot
    UNBOOTSTRAPPED = 1 << 30

    def _stale_locked(self) -> int:
        if self.versions and min(self.versions) < 0:
            return self.UNBOOTSTRAPPED
        return max(0, self.server_version - sum(self.versions))

    def staleness(self) -> int:
        """Applied updates the resident copy trails the last-heard server
        version by; ``UNBOOTSTRAPPED`` before the first refresh."""
        live = getattr(self.sub, "live_version", None)
        with self._cond:
            if live is not None:
                # in-heap subscription: measure against the server NOW
                self.server_version = max(self.server_version, live())
            return self._stale_locked()

    def wait_fresh(self, bound: int, timeout: float = 60.0) -> int:
        """The admission gate: block until the resident buffer is within
        ``bound`` applied updates of the server (or the server stopped:
        frozen weights are final, hence fresh).  Returns the staleness
        admitted at."""
        stale = self.staleness()
        if stale <= bound or self.stopped:
            return 0 if self.stopped else stale
        t0 = TRACE.now() if TRACE.enabled else 0.0
        self.blocks += 1
        deadline = timeout
        with self._cond:
            while not self.stopped:
                self.refresh_needed.set()  # nudge the Refresher NOW
                stale = self._stale_locked()
                if stale <= bound:
                    break
                if not self._cond.wait(timeout=0.25):
                    deadline -= 0.25
                    if deadline <= 0:
                        raise TimeoutError(
                            f"replica {self.replica_id} stale by {stale} "
                            f"> bound {bound} and no refresh landed "
                            f"within {timeout}s")
            admitted = 0 if self.stopped else stale
        if TRACE.enabled:
            TRACE.span("staleness_block", t0, worker=self.replica_id,
                       args={"bound": bound, "admitted": admitted})
        return admitted

    def snapshot(self) -> Tuple[torch.Tensor, int]:
        """A consistent ``(device clone, aggregate version)`` pair taken
        under the lock: the refresher patches the buffer in place, so
        decode must not alias it, and the version must describe THIS
        copy.  The clone is queued on the current stream, before any
        later patch."""
        with self._cond:
            return self._buf.clone(), max(0, sum(self.versions))

    @property
    def version(self) -> int:
        """Aggregate version of the resident copy (the vector's sum,
        clamped at 0 before the bootstrap)."""
        return max(0, sum(self.versions))


class Refresher(threading.Thread):
    """Background refresh loop: one delta pull every
    ``refresh_every_s``, sooner whenever the admission gate demands
    one.  Exits when the server stops or ``stop()`` is called."""

    def __init__(self, subscriber: ParamSubscriber,
                 refresh_every_s: float):
        super().__init__(daemon=True,
                         name=f"replica-refresh-{subscriber.replica_id}")
        self.subscriber = subscriber
        self.every = float(refresh_every_s)
        # NOT named _stop: threading.Thread owns a private _stop method
        # that join() calls
        self._halt = threading.Event()

    def run(self) -> None:
        sub = self.subscriber
        while not self._halt.is_set():
            if not sub.refresh():
                return  # server stopped: the resident copy is final
            sub.refresh_needed.clear()
            # sleep the cadence, but wake at once on demand
            sub.refresh_needed.wait(timeout=self.every)

    def stop(self, join: bool = True) -> None:
        self._halt.set()
        self.subscriber.refresh_needed.set()
        if join and self.is_alive():
            self.join(timeout=10.0)


def bootstrap_versions(n_shards: int) -> Tuple[int, ...]:
    """The pre-subscription vector: dominated by any server state, so
    the first refresh is always the full snapshot."""
    return (-1,) * int(n_shards)


__all__ = [
    "DirectSubscription",
    "ParamSubscriber",
    "Refresher",
    "Subscription",
    "TransportSubscription",
    "bootstrap_versions",
]
