"""Fault tolerance: snapshots, failover, reconnect, chaos injection.

Counterpart of ``repro/ft``:

  * ``backoff``     — shared bounded-exponential-backoff retry helper
  * ``snapshot``    — server state capture/restore + ``ServerSnapshotter``
  * ``faults``      — deterministic ``FaultPlan`` chaos injection
  * ``server_proc`` — restartable out-of-process server host
  * ``reshard``     — live shard migration (S -> S' without stopping)

Only ``backoff`` is imported eagerly (it is stdlib-only and the
transport layer depends on it); the rest load lazily, so importing
``repro_torch.transport`` never loads the snapshot code into a spawned
worker that does not need it.
"""

from __future__ import annotations

from repro_torch.ft.backoff import (  # noqa: F401
    BackoffPolicy,
    CONNECT_POLICY,
    RECONNECT_POLICY,
    retry,
)

_LAZY = {
    "snapshot_server": "repro_torch.ft.snapshot",
    "restore_server": "repro_torch.ft.snapshot",
    "restore_latest": "repro_torch.ft.snapshot",
    "ServerSnapshotter": "repro_torch.ft.snapshot",
    "SNAPSHOT_VERSION": "repro_torch.ft.snapshot",
    "FaultPlan": "repro_torch.ft.faults",
    "FaultyChannel": "repro_torch.ft.faults",
    "wrap_channel": "repro_torch.ft.faults",
    "ServerProcess": "repro_torch.ft.server_proc",
    "MigrationMap": "repro_torch.ft.reshard",
    "RegionMove": "repro_torch.ft.reshard",
    "build_migration": "repro_torch.ft.reshard",
    "live_reshard": "repro_torch.ft.reshard",
    "spread_versions": "repro_torch.ft.reshard",
    "equalized_counts": "repro_torch.ft.reshard",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.ft' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = ["BackoffPolicy", "CONNECT_POLICY", "RECONNECT_POLICY",
           "retry", *_LAZY]
