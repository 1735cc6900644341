"""Roofline terms of one dry-run cell (``launch/dryrun.py``) on the H100.

Counterpart of ``repro/roofline/analysis.py``.  Per (arch x shape x mesh)
cell the dry run executes one step on fake tensors as rank 0 of a fake
process group and counts what the step does; the three roofline terms
per rank are

  compute    = flops            / (peak FLOP/s per card)
  memory     = bytes            / (HBM bytes/s per card)
  collective = sum over collectives of its ring bytes / (link bytes/s)

The reference reads these from compiled XLA artefacts (``cost_analysis``,
``memory_analysis`` and the post-SPMD HLO text).  The port has none, so
its terms come from what the step executes: flops of the matrix
products by ``torch.utils.flop_counter``'s formulas (the kernels count
their own, ``launch.dryrun``), bytes as the inputs and outputs of every
dispatched op, memory from the storages live during the step, and the
collectives from the records of ``launch.mesh``'s wrappers (kind,
result bytes, group size), not from HLO text.

No counterpart: ``cost_configs`` and ``slstm_correction_flops``
(``repro/roofline/analysis.py:233-298``) correct XLA's cost analysis,
which counts a while-loop body once (the reference's scan over layers,
its chunked attention and MoE, sLSTM's time scan), by a two-point depth
fit and an analytic term.  The port counts every executed op, loops
included, so there is nothing to correct.  ``affine_fit`` stays, the
pure function the reference's tests hold; the dry run uses it only to
save trace time where a layer's Python loops make a full-depth trace
slow (``launch.dryrun.depth_fit``: the MoE and hybrid families), which
is exact for a homogeneous stack.  ``while_trip_counts`` and
``raw_costs`` read HLO and have no counterpart either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

import torch

# NVIDIA H100 80GB HBM3, 700.00 W power limit (the card the port's
# numbers are taken on; the TPU v5e's are the reference's)
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
HBM_BYTES = 80e9             # device memory per card

# The inter-device model of the 256- and 512-rank meshes: the deployment
# it assumes, not a measurement.  DGX H100 nodes of 8 cards on NVLink 4
# (450 GB/s a direction per card), one 400 Gb/s NIC per card between
# nodes.  A group within one node rides NVLink; a group that spans nodes
# is held to its NIC, which every axis of the production meshes does
# (16 ranks an axis, 8 a node).
NODE_SIZE = 8
NVLINK_BW = 450e9            # bytes/s a direction per card inside a node
NIC_BW = 50e9                # bytes/s per card between nodes
ICI_BW = NIC_BW              # the rate of a group that spans nodes

#: the reference's collective kinds (HLO op names), keyed by the port's
#: record kinds (``perfcount.MeshCounters`` field names); the port runs
#: no collective-permute (its all-to-all moves the Mamba's ``w_in``
#: blocks, ``models.partition``)
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "broadcast": "broadcast",
         "all_to_all": "all-to-all"}


def shape_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes of one tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def ring_bytes(kind: str, size: float, n: int) -> float:
    """Per-rank wire bytes of one collective in the ring model, result
    size ``size`` (the reference's ``S``), group size ``n``:
        all-reduce          2.S.(n-1)/n      (reduce + broadcast phases)
        all-gather          S.(n-1)/n        (S = full gathered result)
        reduce-scatter      S.(n-1)          (S = the scattered shard)
        all-to-all          S.(n-1)/n
        collective-permute  S
        broadcast           S.(n-1)/n        (a pipelined ring)
    bf16 reductions are counted at their own width: the port does not
    promote them (the reference halves XLA:CPU's promoted f32 ones)."""
    kind = KINDS.get(kind, kind)
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind == "reduce-scatter":
        return float(size) * (n - 1)
    if kind == "collective-permute":
        return float(size)
    return float(size) * (n - 1) / n


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]       # per-rank wire bytes (ring model)
    count_by_kind: Dict[str, int]
    result_bytes_by_kind: Dict[str, int]  # raw result bytes
    seconds: float = 0.0                # sum of wire bytes / link rate

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def parse_collectives(records: Iterable[Tuple]) -> CollectiveStats:
    """Per-rank wire bytes of every recorded collective (ring model).

    ``records``: ``(kind, result bytes, group size, node-local)`` tuples
    (the first three as ``launch.mesh.COLLECTIVE_LOG`` writes them;
    further fields ignored), keyed under the reference's kind names.  A
    group within one node is timed at NVLink's rate, one across nodes at
    the NIC's."""
    bytes_by: Dict[str, float] = {}
    result_by: Dict[str, int] = {}
    count_by: Dict[str, int] = {}
    seconds = 0.0
    for rec in records:
        kind, size, n = KINDS.get(rec[0], rec[0]), int(rec[1]), int(rec[2])
        local = bool(rec[3]) if len(rec) > 3 else False
        wire = ring_bytes(kind, size, n)
        bytes_by[kind] = bytes_by.get(kind, 0.0) + wire
        result_by[kind] = result_by.get(kind, 0) + size
        count_by[kind] = count_by.get(kind, 0) + 1
        seconds += wire / (NVLINK_BW if local else NIC_BW)
    return CollectiveStats({k: int(v) for k, v in bytes_by.items()},
                           count_by, result_by, seconds)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops: float                 # per rank, executed
    hbm_bytes: float             # per rank, op inputs + outputs
    collective_bytes: float      # per rank, ring model
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float           # 6·N·D (train) / 2·N·D (decode), global
    per_device_argument_bytes: float
    peak_memory_bytes: float
    collective_counts: Dict[str, int]
    n_chips: int                 # ranks of the mesh

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bounded_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (executed flops × ranks): > 1 means the count
        misses work (ops the flop counter does not count), < 1 means
        recompute (remat) or work repeated across ranks."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / (self.flops * self.n_chips)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs in
        bounded_time: useful model flops / (ranks · peak · bounded_time)."""
        denom = self.n_chips * PEAK_FLOPS * self.bounded_time
        return self.model_flops / denom if denom > 0 else 0.0


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D per generated token for
    decode, 2·N·D for prefill (forward only)."""
    from repro_torch.models.registry import count_params
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def extract(counts: Dict[str, float], cfg, shape, mesh_label: str,
            n_chips: int) -> RooflineTerms:
    """The terms of one cell from the dry run's counts: ``flops``,
    ``bytes``, ``argument_bytes``, ``peak_bytes`` and ``collectives``
    (a ``CollectiveStats``, or the records ``parse_collectives``
    reads)."""
    colls = counts["collectives"]
    if not isinstance(colls, CollectiveStats):
        colls = parse_collectives(colls)
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_label,
        flops=float(counts["flops"]), hbm_bytes=float(counts["bytes"]),
        collective_bytes=float(colls.total_bytes),
        t_compute=counts["flops"] / PEAK_FLOPS,
        t_memory=counts["bytes"] / HBM_BW,
        t_collective=colls.seconds,
        model_flops=model_flops(cfg, shape),
        per_device_argument_bytes=float(counts["argument_bytes"]),
        peak_memory_bytes=float(counts["peak_bytes"]),
        collective_counts={k: v for k, v in colls.count_by_kind.items()
                           if v},
        n_chips=int(n_chips),
    )


def format_row(t: RooflineTerms) -> str:
    return (f"{t.arch:>22} {t.shape:>12} {t.mesh:>8} "
            f"{t.flops:>12.3e} {t.hbm_bytes:>12.3e} "
            f"{t.collective_bytes:>12.3e} "
            f"{t.t_compute * 1e3:>10.2f} {t.t_memory * 1e3:>10.2f} "
            f"{t.t_collective * 1e3:>10.2f} {t.dominant:>10} "
            f"{t.useful_flops_ratio:>8.3f} {t.roofline_fraction:>8.3f} "
            f"{t.per_device_argument_bytes / 2**30:>8.2f} "
            f"{t.peak_memory_bytes / 2**30:>8.2f}")


HEADER = (f"{'arch':>22} {'shape':>12} {'mesh':>8} "
          f"{'flops/chip':>12} {'bytes/chip':>12} {'coll_B/chip':>12} "
          f"{'t_comp_ms':>10} {'t_mem_ms':>10} {'t_coll_ms':>10} "
          f"{'dominant':>10} {'useful':>8} {'roofline':>8} {'argGiB':>8} "
          f"{'peakGiB':>8}")
"""The columns of ``format_row``: counts and bounds per rank, not
measurements.  ``bytes/chip`` sums every dispatched op's inputs and
outputs: an upper bound on HBM traffic, since nothing is fused (a fused
kernel reads its inputs and writes its outputs once, counted so).
``argGiB`` is the step's arguments per rank, ``peakGiB`` the most bytes
live at once during the step (arguments included)."""


# ------------------------------------------------- two-point depth fit
def affine_fit(c1: float, c2: float, d1: int, d2: int, L: int) -> float:
    """c(L) from c(d1), c(d2) of a cost affine in depth (the reference's
    fit; the port's counts need none)."""
    return c1 + (c2 - c1) * (L - d1) / float(d2 - d1)
