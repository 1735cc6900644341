"""Server-side optimizer settings shared by the parameter servers.

The paper's server steps plain SGD (workers send raw gradients); a
staleness-aware variant scales the step by 1/(1+staleness)
(Omnivore-style momentum tempering).  In the port the step itself is
the fused kernel (``repro_torch.kernels.fused_update``) over packed
regions; this object carries its hyper-parameters per shard.

The reference's monolithic ``ParameterServer`` and its coalescing
window (``CoalesceWindow``, with the batched kernel behind it) come
with ROADMAP queue 1, item 3.
"""

from __future__ import annotations

#: Default linger (seconds) a coalescing flusher waits for its window to
#: fill; kept so the spec layer resolves the same default as the
#: reference (coalescing itself is not ported yet).
DEFAULT_COALESCE_WAIT_S = 0.05


class ServerOptimizer:
    """SGD with optional momentum + staleness-aware damping."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 staleness_damping: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.staleness_damping = staleness_damping

    def scale(self, staleness: int) -> float:
        """The gradient's step scale for a push of this staleness."""
        return 1.0 / (1.0 + staleness) if self.staleness_damping else 1.0
