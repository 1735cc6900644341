"""Logical-axis sharding: one place that maps logical axes -> mesh axes.

Counterpart of ``repro/models/sharding.py``.  Model code and parameter
declarations name *logical* axes ('batch', 'model', 'fsdp',
'cache_seq', ...); ``AxisRules`` maps them onto the physical axes of a
``torch.distributed`` ``DeviceMesh`` ('pod', 'data', 'model'),
**size-aware**: a mapping is dropped for a tensor dimension the mesh
axes do not evenly divide (qwen1.5-32b's 40 heads over a 16-way model
axis, batch 1 over the data axis, whisper's 51865 vocab), a dimension
that does not divide the whole tuple falls back to its longest prefix
that it divides, and no mesh axis shards two dimensions of one tensor.
The specs are the reference's, element for element.

What a spec decides in the port: the block of a tensor each rank
stores (``launch/steps.py``: params, optimizer state, the DSSP ring,
the batch), and, for the transformers under role 'tp', the block of
the compute each rank does (``models/partition.py``
splits the train step's compute by these specs with explicit
collectives).  Elsewhere the step gathers every parameter whole and
runs the model on its rank's batch rows (ROADMAP queue 3).  Hence
``shard`` returns its input: under GSPMD a sharding constraint never
changes a value, and where the port partitions it does so explicitly.
The rules still choose code paths the reference chooses with them: with
a mesh installed, attention takes the reference's sequence-parallel or
tensor-parallel formulation instead of the flash kernel.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, the first
    axis major).  A tuple, so it compares as ``jax.sharding.
    PartitionSpec`` does: entry by entry, trailing ``None``s counting."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class AxisRules:
    """logical-axis -> mesh-axes mapping + mesh axis sizes for div checks."""

    def __init__(self, rules: Dict[str, MeshAxes],
                 axis_sizes: Optional[Dict[str, int]] = None, mesh=None):
        self.rules = dict(rules)
        self.axis_sizes = dict(axis_sizes or {})
        self.mesh = mesh
        self.attn_mode = "tp"   # 'tp' | 'sp', set by the rule builders

    def _mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        m = self.rules.get(logical) if logical else None
        if m is None:
            return ()
        return (m,) if isinstance(m, str) else tuple(m)

    def _divides(self, dim: Optional[int], axes: Sequence[str]) -> bool:
        if dim is None or not self.axis_sizes:
            return True     # unknown shape: trust the caller
        n = 1
        for a in axes:
            n *= self.axis_sizes.get(a, 1)
        return n > 0 and dim % n == 0

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        dims = list(shape) if shape is not None else [None] * len(logical)
        if shape is not None and len(dims) != len(logical):
            raise ValueError(f"rank mismatch: shape {shape} vs axes {logical}")
        phys, used = [], set()
        for ax, dim in zip(logical, dims):
            ms = tuple(a for a in self._mesh_axes(ax) if a not in used)
            # prefix fallback: a dim that does not divide the full tuple
            # may still divide a prefix (e.g. batch 32 over
            # ('data','model') = 256 -> shard over 'data' = 16 only)
            while ms and not self._divides(dim, ms):
                ms = ms[:-1]
            if ms:
                used.update(ms)
                phys.append(ms if len(ms) > 1 else ms[0])
            else:
                phys.append(None)
        while phys and phys[-1] is None:
            phys.pop()
        return PartitionSpec(*phys)


_state = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_spec(logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    r = current_rules()
    return PartitionSpec() if r is None else r.spec(logical, shape)


def shard(x, *logical: Optional[str]):
    """The reference's sharding constraint on logical axes: ``x`` itself.

    A constraint tells GSPMD where to keep a value; it never changes the
    value.  Where the port partitions compute (``models/partition.py``)
    it moves blocks with explicit collectives, so there is no layout to
    pin between operations."""
    return x


def remat_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute of a
    checkpointed layer runs in the backward pass, which autograd runs on
    a device thread of its own for CUDA tensors, where this thread's
    rules are not installed.  Re-install the forward's rules around the
    recompute, so it takes the same code path (a mesh formulation of
    attention, not the flash kernel) and saves the same tensors."""
    return contextlib.nullcontext(), use_rules(current_rules())


def has_mesh() -> bool:
    """Rules with a mesh are installed: the reference's ``_has_mesh``."""
    r = current_rules()
    return r is not None and r.mesh is not None


def sp_mode() -> bool:
    """The installed rules ask for sequence-parallel attention."""
    r = current_rules()
    return r is not None and getattr(r, "attn_mode", "tp") == "sp"


# -- standard rule sets -------------------------------------------------------
def _base_rules(batch_axes, *, fsdp: bool, sp: bool,
                role: str = "tp") -> Dict[str, MeshAxes]:
    """Shared logical->mesh mapping.

    sp=False (Megatron-TP attention): attention heads shard over 'model'.
    sp=True (sequence-parallel attention): the activation seq dim is the
    canonical 'model' sharding; attention weights replicate over 'model'
    but stay FSDP-sharded over 'data'.  role='dp' (small models): the
    'model' axis joins data parallelism and params and optimizer state
    shard over both axes.
    """
    if role == "dp":
        return {
            "batch": tuple(batch_axes) + ("model",),
            "model": None,
            "heads": None,
            "kv_heads": None,
            "fsdp": ("data", "model") if fsdp else None,
            "cache_seq": ("data", "model"),
            "seq": None,
            "attn_mode": None,
        }
    return {
        "batch": batch_axes,
        "model": "model",               # TP dim (ffn/vocab/experts)
        "heads": None if sp else "model",
        "kv_heads": None if sp else "model",
        "fsdp": "data" if fsdp else None,
        "cache_seq": ("data", "model"),  # decode KV-cache sequence shards
        "seq": "model" if sp else None,  # activation sequence dim
        "attn_mode": None,               # marker, read via .rules
    }


def single_pod_rules(axis_sizes: Optional[Dict[str, int]] = None, *,
                     fsdp: bool = True, sp: bool = True, role: str = "tp",
                     mesh=None) -> AxisRules:
    """mesh ('data','model'): DP over data, TP/EP over model; params
    FSDP-sharded over data on a non-TP dim (ZeRO-3 style)."""
    r = AxisRules(_base_rules(("data",), fsdp=fsdp, sp=sp, role=role),
                  axis_sizes, mesh)
    r.attn_mode = "sp" if (sp and role == "tp") else "tp"
    return r


def multi_pod_rules(axis_sizes: Optional[Dict[str, int]] = None, *,
                    fsdp: bool = True, sp: bool = True, role: str = "tp",
                    mesh=None) -> AxisRules:
    """mesh ('pod','data','model'): batch over pod×data; params replicated
    across pods (cross-pod traffic = the gradient average only; this is
    where DSSP's dynamic-period sync applies)."""
    r = AxisRules(_base_rules(("pod", "data"), fsdp=fsdp, sp=sp, role=role),
                  axis_sizes, mesh)
    r.attn_mode = "sp" if (sp and role == "tp") else "tp"
    return r


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def rules_for_mesh(mesh, **kw) -> AxisRules:
    """The standard rules for a ``DeviceMesh``, its axis names and sizes
    read from the mesh; 'pod' among them picks the multi-pod set."""
    sizes = mesh_axis_sizes(mesh)
    multi = "pod" in mesh.mesh_dim_names
    return (multi_pod_rules(sizes, mesh=mesh, **kw) if multi
            else single_pod_rules(sizes, mesh=mesh, **kw))
