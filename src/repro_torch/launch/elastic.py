"""Elastic scaling: adapt a running job to a changed resource shape.

Counterpart of ``repro/launch/elastic.py``.  Two independent elasticity
paths, one per engine:

**SPMD pipeline** (this module): node loss (or growth) flow —
  1. the job restarts with however many ranks survive,
  2. ``elastic_mesh(n)`` builds the largest (data, model) mesh that fits,
  3. ``remesh`` places the checkpointed state (whole tensors on the host
     or the device: the transfer buffer) under the new mesh's specs,
     each rank keeping its block,
  4. the data pipeline re-shards itself by (host_index, n_hosts) —
     batch order is a pure function of the step, so no samples are lost
     or duplicated (data/synthetic.py),
  5. DSSP's controller re-learns step intervals within a few steps
     (the paper's adaptivity argument, §III.B).

**Parameter-server layer**: worker membership changes in place (the
per-shard staleness trackers' ``add_worker``/``remove_worker``), and
shard arity by **live resharding** (``repro_torch.ft.reshard``):
``reshard_ps`` below is the launch-layer entry point.
"""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.launch.mesh import elastic_mesh, place
from repro_torch.models import registry
from repro_torch.models.sharding import rules_for_mesh


def remesh(tree: Any, spec: Any, mesh) -> Any:
    """This rank's blocks of ``tree`` (whole tensors) under ``spec`` on
    ``mesh``; ``None`` on a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        return None
    return place(tree, spec, mesh)


def rescale_params(cfg, params: Any, n_devices: int,
                   model_parallel: int = 16) -> Tuple[Any, Any]:
    """Reshard ``params`` (whole tensors) for a cluster that now has
    ``n_devices`` ranks: (this rank's blocks, the new mesh).  Every rank
    of the group calls it; the ranks past ``n_devices`` get ``None``."""
    mesh = elastic_mesh(n_devices, model_parallel=model_parallel)
    rules = rules_for_mesh(mesh)
    specs = registry.param_specs(cfg, rules)
    return remesh(params, specs, mesh), mesh


def reshard_ps(server, n_shards: int) -> bool:
    """PS-side elasticity: migrate a live sharded server to
    ``n_shards`` partitions without stopping training.

    Thin launch-layer alias of ``repro_torch.ft.reshard.live_reshard`` —
    the full protocol (migration map, parked pushes, epoch bump, client
    resync) is documented there.  Returns False when the server is
    already at that arity.
    """
    from repro_torch.ft.reshard import live_reshard
    return live_reshard(server, n_shards)
