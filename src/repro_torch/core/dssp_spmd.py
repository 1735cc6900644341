"""DSSP adapted to the SPMD pipeline: delayed gradients and the
host-side schedule controller.

Counterpart of ``repro/core/dssp_spmd.py`` on one device.  Without a
parameter server the gradient collective *is* the synchronization; the
paper's degree of freedom — how stale may a contribution be before the
system forces a sync — becomes a delay, bounded by [s_L, s_U] so
Theorem 2 carries over:

* **Delayed gradient application.**  The gradient computed at step
  ``t`` enters a ring buffer and is *applied* at step ``t + d``, with
  ``d ∈ [s_L, s_U]`` chosen by the host-side controller, so step
  ``t``'s update no longer waits on step ``t``'s collective.
* **The controller** (``DsspScheduleController``) turns measured step
  and collective times into the delay ``d`` (and, for pods, the
  cross-pod period ``k``) with the paper's simulated-timestamp argmin.

* **Dynamic-period cross-pod averaging** (local SGD).  Pods are the
  paper's workers: every pod takes ``k`` local steps between cross-pod
  averages, ``k ∈ [s_L, s_U]`` from ``DsspScheduleController.period``.
  ``cross_pod_sync`` averages each rank's blocks over the mesh's 'pod'
  axis (``torch.distributed``: one process per device, see
  ``launch/mesh.py``); ``local_sgd_step`` calls it when the host says so.

The ring lives on the device and is written in place (the reference's
jitted step donates it); its ``step`` counter is an int32 0-d tensor on
the host, so choosing a slot never waits on the device.  On a mesh each
rank's ring holds its block of every gradient (``pipeline_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_util

Tree = Any


# ------------------------------------------------------- delayed gradients
class PipelineState(NamedTuple):
    buffer: Tree          # stacked pending grads, leading dim = depth
    step: torch.Tensor    # int32 global step (0-d, on the host)


def init_pipeline(grads_like: Tree, depth: int) -> PipelineState:
    """depth = s_U + 1 ring slots (delay d uses slot (step - d) % depth),
    each slot in its gradient's dtype and on its device."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    buf = tree_util.tree_map(
        lambda g: torch.zeros((depth,) + tuple(g.shape), dtype=g.dtype,
                              device=g.device), grads_like)
    return PipelineState(buffer=buf,
                         step=torch.zeros((), dtype=torch.int32))


def pipeline_specs(grad_specs: Tree, depth: int) -> PipelineState:
    """Buffer shards like the gradient with an unsharded ring dim."""
    from repro_torch.models.sharding import PartitionSpec as P
    from repro_torch.models.sharding import is_spec

    buf = tree_util.tree_map(lambda spec: P(None, *spec), grad_specs,
                             is_leaf=is_spec)
    return PipelineState(buffer=buf, step=P())


def push_pop(state: PipelineState, grads: Tree, delay,
             ) -> Tuple[Tree, torch.Tensor, PipelineState]:
    """Write ``grads`` into the ring; read the gradient from ``delay``
    steps ago.  Returns (delayed_grads, valid_scale, new_state) where
    ``valid_scale`` (f32 0-d, on the host) is 0.0 for the warm-up steps
    that have no gradient to apply yet (t < d) and 1.0 afterwards.

    delay == 0 reproduces BSP exactly (reads what it just wrote).  The
    write goes into ``state.buffer`` in place, cast to the slot's dtype,
    and the delayed gradients are views of their slot: use them before
    the next ``push_pop`` writes that slot.
    """
    leaves = tree_util.leaves(state.buffer)
    depth = leaves[0].shape[0]
    delay = min(max(int(delay), 0), depth - 1)
    step = int(state.step)
    w = step % depth
    r = (step - delay) % depth
    with torch.no_grad():
        for b, g in zip(leaves, tree_util.leaves(grads)):
            b[w].copy_(g)
    delayed = tree_util.tree_map(lambda b: b[r], state.buffer)
    valid = torch.tensor(1.0 if step >= delay else 0.0, dtype=torch.float32)
    return delayed, valid, PipelineState(buffer=state.buffer,
                                         step=state.step + 1)


# ------------------------------------------------------ host-side controller
@dataclasses.dataclass
class DsspScheduleController:
    """Chooses the delay ``d`` and cross-pod period ``k`` at run time.

    The paper's Algorithm-2 recipe — predict near-future intervals from
    the most recent observed ones, then pick the bound in [s_L, s_U] that
    minimizes predicted waiting — specialized to the SPMD streams:

    * ``delay()``: the compute stream (interval = step time) must not
      consume the collective stream's result before it lands; the minimal
      non-waiting delay is ceil(t_coll / t_step) on the *predicted*
      intervals (IntervalEstimator: 'last' = paper, 'ema'/'median'
      robust), clamped to [s_L, s_U].
    * ``period(pod_times)``: pods are the paper's workers; Algorithm 2's
      simulate+argmin runs verbatim on the fastest/slowest pod's
      predicted step intervals to choose extra local steps before the
      next cross-pod average.
    """

    s_lower: int
    s_upper: int
    estimator: str = "last"

    def __post_init__(self):
        from repro_torch.core.controller import IntervalEstimator
        self._est = IntervalEstimator(mode=self.estimator)
        self.history = []

    def observe(self, step_time: float, collective_time: float) -> None:
        """Feed one step's measured (or modelled) timings."""
        self._est.observe(0, max(1e-12, step_time))
        self._est.observe(1, max(0.0, collective_time))
        self.history.append((step_time, collective_time))

    def delay(self) -> int:
        t_step = self._est.predict(0)
        t_coll = self._est.predict(1)
        if t_step is None or t_coll is None:
            return self.s_lower
        d = -(-t_coll // t_step)                     # ceil division
        return int(min(self.s_upper, max(self.s_lower, d)))

    def period(self, pod_step_times) -> int:
        """Cross-pod averaging period from per-pod step times (Alg. 2)."""
        from repro_torch.core.controller import (optimal_extra_iterations,
                                                 simulate_push_times)
        fast, slow = min(pod_step_times), max(pod_step_times)
        r_max = self.s_upper - self.s_lower
        sim_fast = simulate_push_times(0.0, fast, r_max)
        sim_slow = simulate_push_times(0.0, slow, r_max, lead=1)
        r = optimal_extra_iterations(sim_fast, sim_slow)
        return int(min(self.s_upper, max(self.s_lower, self.s_lower + r)))


# --------------------------------------------------- cross-pod local SGD
def cross_pod_sync(tree: Tree, mesh, specs: Tree) -> Tree:
    """Average ``tree`` across the mesh's 'pod' axis, in place, and
    return it.

    ``tree`` holds this rank's blocks under ``specs`` (the reference's
    ``shard_map`` in/out specs, e.g. per-pod replicas stacked on a
    leading dim split over 'pod': each rank then holds its pod's
    replica).  As in the reference's ``shard_map`` manual over 'pod',
    every block is averaged with the blocks of the ranks that differ
    from it only in the 'pod' coordinate; 'data' and 'model' blocks pass
    through untouched.  The mean is a sum over the 'pod' sub-group and
    one division by the pod count, so for 2 pods it is ``pmean`` bit
    for bit ((a + b) / 2 either way round)."""
    from repro_torch.launch.mesh import all_reduce_mean
    from repro_torch.models.sharding import is_spec
    n = len(tree_util.leaves(tree))
    if len(tree_util.leaves(specs, is_leaf=is_spec)) != n:
        raise ValueError("specs do not match the tree's leaves")
    with torch.no_grad():
        all_reduce_mean(tree_util.leaves(tree), ("pod",), mesh)
    return tree


def local_sgd_step(train_step: Callable, sync_params: Callable,
                   ) -> Callable:
    """Wrap a per-pod train step with conditional cross-pod averaging.

    ``do_sync`` is a host bool: the host sets it every k-th step (k from
    ``DsspScheduleController.period()``), and every rank must pass the
    same value."""

    def step(params, opt_state, pipeline, batch, delay, do_sync):
        params, opt_state, pipeline, metrics = train_step(
            params, opt_state, pipeline, batch, delay)
        if do_sync:
            params = sync_params(params)
        return params, opt_state, pipeline, metrics

    return step
