"""repro_torch.serve — online serving replicas fed by version-delta pulls.

Counterpart of ``repro/serve``: train and serve the SAME parameters.  N
replicas subscribe to the live parameter server (``MSG_SUB``, no
barrier seat), keep a resident packed wire buffer on their device fresh
through ``MSG_PULL_DELTA`` refreshes (bytes proportional to change),
and decode continuously batched requests behind an SSP-style admission
gate: a replica trailing the server by more than
``serve.staleness_bound`` applied updates blocks until its refresh
lands.

Drive it through ``repro_torch.api`` (the ``serve`` block of a
``RunSpec``, on the ``ps-threads`` and ``ps-transport`` engines) or
assemble the pieces directly:

    from repro_torch.serve import (BatchQueue, Decoder, ParamSubscriber,
                                   Refresher, ReplicaWorker)
"""

from repro_torch.serve.batching import BatchQueue, DecodeRequest
from repro_torch.serve.engine import (
    Decoder,
    ReplicaPool,
    ReplicaResult,
    ReplicaTask,
    ReplicaWorker,
    aggregate_serve,
    drive_replica,
    legal_fraction,
    raise_on_replica_failure,
    replica_chain,
)
from repro_torch.serve.replica import (
    DirectSubscription,
    ParamSubscriber,
    Refresher,
    Subscription,
    TransportSubscription,
    bootstrap_versions,
)

__all__ = [
    "BatchQueue",
    "DecodeRequest",
    "Decoder",
    "DirectSubscription",
    "ParamSubscriber",
    "Refresher",
    "ReplicaPool",
    "ReplicaResult",
    "ReplicaTask",
    "ReplicaWorker",
    "Subscription",
    "TransportSubscription",
    "aggregate_serve",
    "bootstrap_versions",
    "drive_replica",
    "legal_fraction",
    "raise_on_replica_failure",
    "replica_chain",
]
