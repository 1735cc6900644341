"""Device meshes over ``torch.distributed``, and the blocks each rank
stores on one.

Counterpart of ``repro/launch/mesh.py``.  One process per device: a
mesh is a ``DeviceMesh`` with named axes over the ranks of the default
process group (NCCL on the card, gloo on the CPU and for several ranks
sharing one card, which NCCL refuses).  Nothing here starts a group on
import; ``start_group`` starts one where the caller has none.

  single pod:  (16, 16)        axes ('data', 'model')   = 256 ranks
  multi pod:   (2, 16, 16)     axes ('pod', 'data', 'model') = 512 ranks

Blocks.  A ``PartitionSpec`` (``models/sharding.py``) names, per tensor
dimension, the mesh axes it is split over (a tuple: their product, the
first axis major).  ``place`` keeps a rank's block of each leaf,
``gather`` rebuilds whole leaves from the blocks (``all_gather`` over
one axis at a time, the last axis first), ``all_reduce_mean`` averages
over mesh axes.  A dimension over axes of one rank is not split, so on
a mesh whose axes all have one rank ``place`` and ``gather`` return
their inputs and no collective runs (``perfcount.MESH`` counts both).

Collectives with gradients, for compute split over the mesh
(``models/partition.py``): ``gather_grad`` (all-gather forward,
reduce-scatter backward: FSDP's parameter gather, sequence
parallelism's activation gather), ``scatter_grad`` (its transpose),
``gather_replicated`` (a whole gathered for compute every rank repeats),
``copy_to_group`` and ``reduce_from_group`` (Megatron's f and g).
``perfcount.MESH`` counts every collective and its result bytes;
``COLLECTIVE_LOG``, when the dry run sets it, records each one.
Collectives on a gloo group (its ranks on one host) pass through a
shared-memory segment of the group's (``_HostExchange``), CUDA tensors
through pinned host memory.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.models.sharding import PartitionSpec, is_spec, \
    mesh_axis_sizes
from repro_torch.perfcount import MESH


def start_group(rank: int = 0, world_size: int = 1, *, backend: str,
                init_method: Optional[str] = None, store=None) -> None:
    """Start the default process group: ``backend`` ('nccl' or 'gloo')
    over ``store`` or ``init_method`` (``tcp://localhost:<port>``,
    ``file://...``); with neither, a one-rank group on an in-process
    store."""
    if store is None and init_method is None:
        if world_size != 1:
            raise ValueError("a group of several ranks needs a store or "
                             "an init_method")
        store = dist.HashStore()
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of ``devices`` (default: every rank of the default
    group), row-major.  Every rank of the group must call it; a rank
    outside the mesh gets one whose ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(have))
    if len(ranks) < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} devices, have {len(ranks)} — "
            "start more ranks (one process per device) or shrink the mesh")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "repro_torch.launch.mesh.start_group (or "
                           "torch.distributed.init_process_group) first")
    grid = torch.tensor(ranks[:need], dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(_device_type(), grid, mesh_dim_names=tuple(axes))


def elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                 axes: Tuple[str, str] = ("data", "model")):
    """Largest (data, model) mesh that fits ``n_devices`` — used by the
    elastic-scaling path after node loss (launch/elastic.py)."""
    mp = math.gcd(model_parallel, n_devices)
    dp = n_devices // mp
    return make_mesh((dp, mp), axes, devices=list(range(dp * mp)))


# ------------------------------------------------------------ collectives
#: When a list: every collective appends ``(kind, result bytes, group
#: size, whether the group's ranks share one node of NODE_SIZE, dtype,
#: shape of the result)`` to it (the dry run's record,
#: ``repro_torch.roofline``).  None on the hot path: one check a call.
COLLECTIVE_LOG: Optional[list] = None
#: ranks of one node in the roofline's deployment (DGX H100: 8 cards)
NODE_SIZE = 8


def _count(kind: str, result: torch.Tensor, group) -> None:
    nbytes = result.numel() * result.element_size()
    setattr(MESH, kind, getattr(MESH, kind) + 1)
    setattr(MESH, kind + "_bytes", getattr(MESH, kind + "_bytes") + nbytes)
    if COLLECTIVE_LOG is not None:
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else range(dist.get_world_size()))
        local = len({r // NODE_SIZE for r in ranks}) == 1
        COLLECTIVE_LOG.append((kind, nbytes, dist.get_world_size(group),
                               local, result.dtype, tuple(result.shape)))


#: the single-tensor collectives of the non-gloo branches (NCCL's):
#: torch 2.13 renamed ``reduce_scatter_tensor`` and
#: ``all_gather_into_tensor`` (deprecating the old names) to
#: ``reduce_scatter_single`` and ``all_gather_single``, whose
#: ``(output, input, group=)`` arguments are the ones used here; earlier
#: releases (2.11 on the card) have the old names only
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


class _HostExchange:
    """The collectives of a gloo group pass through a shared-memory
    segment of the group's, one slot a rank, not gloo's transport: a
    rank writes its slot, the group meets at a barrier, each rank reads
    what it needs (a reduction sums the slots in rank order, so every
    rank gets the same bits), and meets the group again before the slots
    are reused.  gloo serves ranks of one host (several ranks on one
    card, which NCCL refuses, or CPU ranks); ranks on several hosts take
    NCCL.  The segment grows to the largest message and is unlinked as
    soon as every rank has mapped it; with CUDA in use each rank pins its
    mapping (``cudaHostRegister``), so the copies to and from the card
    are DMA, not staged through pageable memory."""

    def __init__(self, group):
        self.group = group
        self.n, self.me = dist.get_world_size(group), dist.get_rank(group)
        self.shm, self.buf, self.slot, self.pinned = None, None, 0, False

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def slots(self, nbytes: int) -> list:
        """One ``nbytes`` uint8 view a rank (every rank of the group
        asks for the same size at the same collective)."""
        if self.buf is None or nbytes > self.slot:
            # at least double: each new segment is mapped, faulted in
            # and pinned again
            self._grow(max(nbytes, 2 * self.slot, 1))
        return [self.buf.narrow(0, r * self.slot, nbytes)
                for r in range(self.n)]

    def _grow(self, nbytes: int) -> None:
        import multiprocessing as mp
        from multiprocessing import resource_tracker, shared_memory
        self.close()
        slot = -(-nbytes // (1 << 20)) << 20
        name = torch.zeros(64, dtype=torch.uint8)
        if self.me == 0:
            shm = shared_memory.SharedMemory(
                create=True, size=self.n * slot,
                name=f"rmx-{os.getpid()}-{os.urandom(4).hex()}")
            code = shm.name.encode()
            name[:len(code)] = torch.tensor(list(code), dtype=torch.uint8)
        dist.broadcast(name, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        if self.me != 0:
            shm = shared_memory.SharedMemory(
                name=bytes(name.tolist()).rstrip(b"\0").decode())
            if mp.parent_process() is None:     # a tracker of its own
                resource_tracker.unregister(shm._name, "shared_memory")
        self.barrier()
        if self.me == 0:
            shm.unlink()           # the mappings live on until closed
        self.shm, self.slot = shm, slot
        self.buf = torch.frombuffer(shm.buf, dtype=torch.uint8)
        if torch.cuda.is_initialized():
            # cudaHostRegisterPortable; unpinned (pageable copies) if
            # the driver refuses
            self.pinned = int(torch.cuda.cudart().cudaHostRegister(
                self.buf.data_ptr(), self.buf.numel(), 1)) == 0

    def close(self) -> None:
        if self.shm is not None:
            if self.pinned:
                torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
                self.pinned = False
            self.buf = None
            try:
                self.shm.close()
            except BufferError:    # a view still exported: leave it mapped
                _LEAKED.append(self.shm)
            self.shm, self.slot = None, 0


_EXCHANGES: Dict[Tuple[int, ...], _HostExchange] = {}
_LEAKED: list = []


def _exchange(group) -> Optional[_HostExchange]:
    """The host exchange of a gloo ``group`` (None: the default group);
    None for NCCL's."""
    if not _gloo(group):
        return None
    group = dist.group.WORLD if group is None else group
    key = tuple(dist.get_process_group_ranks(group))
    ex = _EXCHANGES.get(key)
    if ex is None:
        if not _EXCHANGES:
            import atexit
            atexit.register(release_host_exchanges)
        ex = _EXCHANGES[key] = _HostExchange(group)
    ex.group = group
    return ex


def host_exchange_bytes() -> int:
    """The bytes of the host exchanges' segments this rank maps now."""
    return sum(ex.buf.numel() for ex in _EXCHANGES.values()
               if ex.buf is not None)


def release_host_exchanges() -> None:
    """Unmap every host exchange's segment (the next collective maps a
    new one).  Every rank of the groups calls it at the same point."""
    for ex in _EXCHANGES.values():
        ex.close()
    _EXCHANGES.clear()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _slot_as(slot: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """A slot's bytes as a tensor of ``like``'s dtype and ``shape`` on
    ``like``'s device (a copy)."""
    return slot.view(like.dtype).view(shape).to(like.device, copy=True)


def all_reduce_sum_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum (or ``op``: ``dist.ReduceOp.MAX``) ``t`` in place over
    ``group``."""
    _count("all_reduce", t, group)
    op = dist.ReduceOp.SUM if op is None else op
    ex = _exchange(group)
    if ex is not None:
        combine = {dist.ReduceOp.SUM: torch.add, dist.ReduceOp.MAX:
                   torch.maximum, dist.ReduceOp.MIN: torch.minimum}[op]
        slots = ex.slots(t.numel() * t.element_size())
        slots[ex.me].copy_(_bytes(t))
        ex.barrier()
        acc = _slot_as(slots[0], t, t.shape)
        for r in range(1, ex.n):
            acc = combine(acc, _slot_as(slots[r], t, t.shape))
        ex.barrier()
        t.copy_(acc)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks, in group-rank order, concatenated
    along ``dim``."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    ex = _exchange(group)
    if ex is not None:
        slots = ex.slots(src.numel() * src.element_size())
        slots[ex.me].copy_(_bytes(src))
        ex.barrier()
        out = torch.stack([_slot_as(x, src, src.shape) for x in slots])
        ex.barrier()
        shape = list(src.shape)
        shape[dim] *= n
        cat = out.movedim(0, dim).reshape(shape)
    else:
        out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        _ALL_GATHER(out, src, group=group)
        shape = list(src.shape)
        shape[dim] *= n
        cat = out.movedim(0, dim).reshape(shape)
    _count("all_gather", cat, group)
    return cat


def reduce_scatter_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut into its ranks' blocks along
    ``dim``: this rank's block."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {n} blocks")
    step = t.shape[dim] // n
    ex = _exchange(group)
    if ex is not None:
        src = t.detach().movedim(dim, 0).contiguous()
        row = src[0].numel() * src.element_size()
        slots = ex.slots(src.numel() * src.element_size())
        slots[ex.me].copy_(_bytes(src))
        ex.barrier()
        me, shape = dist.get_rank(group), (step,) + tuple(src.shape[1:])
        acc = None
        for x in slots:
            part = _slot_as(x.narrow(0, me * step * row, step * row), src,
                            shape)
            acc = part if acc is None else acc + part
        ex.barrier()
        out = acc.movedim(0, dim).contiguous()
    else:
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((step,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _REDUCE_SCATTER(out, src, group=group)
        out = out.movedim(0, dim).contiguous()
    _count("reduce_scatter", out, group)
    return out


def all_to_all_cat(t: torch.Tensor, group, dim: int,
                   routes: Sequence[Sequence[int]]) -> torch.Tensor:
    """Chunks of every rank of ``group`` sent where ``routes`` says: the
    ranks' tensors split along ``dim`` into equal chunks, chunk ``i`` of
    group rank ``s`` going to group rank ``routes[s][i]``.  Returns this
    rank's received chunks concatenated along ``dim``, in order of their
    source rank, then of their index there."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    mine = routes[me]
    src = t.movedim(dim, 0)
    rows = src.shape[0] // len(mine)
    order = sorted(range(len(mine)), key=lambda i: (mine[i], i))
    send = torch.cat([src.narrow(0, i * rows, rows) for i in order]
                     ).contiguous()
    in_splits = [rows * sum(1 for d in mine if d == r) for r in range(n)]
    out_splits = [rows * sum(1 for d in routes[u] if d == me)
                  for u in range(n)]
    shape = (sum(out_splits),) + tuple(send.shape[1:])
    ex = _exchange(group)
    if ex is not None:
        row = send[0].numel() * send.element_size() if len(send) else 0
        slots = ex.slots(max(rows * len(r) for r in routes) * row)
        slots[ex.me].narrow(0, 0, send.numel() * send.element_size()).copy_(
            _bytes(send))
        ex.barrier()
        parts = []
        for u in range(n):
            if not out_splits[u]:
                continue
            first = rows * sum(1 for d in routes[u] if d < me)
            parts.append(_slot_as(
                slots[u].narrow(0, first * row, out_splits[u] * row), send,
                (out_splits[u],) + tuple(send.shape[1:])))
        ex.barrier()
        out = torch.cat(parts)
    else:
        out = torch.empty(shape, dtype=send.dtype, device=send.device)
        dist.all_to_all_single(out, send, out_splits, in_splits,
                               group=group)
    out = out.movedim(0, dim)
    _count("all_to_all", out, group)
    return out


class _Exchange(torch.autograd.Function):
    """``all_to_all_cat`` forward; backward each received chunk's
    gradient goes back to the rank and place it came from (every chunk
    has one owner, so each is its whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, routes):
        ctx.group, ctx.dim, ctx.routes = group, dim, routes
        return all_to_all_cat(x, group, dim, routes)

    @staticmethod
    def backward(ctx, g):
        routes, dim = ctx.routes, ctx.dim
        me, n = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        # the received chunks return to their sources, where they arrive
        # in order of (destination, index): put them back by index
        got = all_to_all_cat(g, ctx.group, dim, _back_routes(routes, n))
        mine = routes[me]
        order = sorted(range(len(mine)), key=lambda i: (mine[i], i))
        rows = got.shape[dim] // len(mine)
        chunks = [None] * len(mine)
        for p, i in enumerate(order):
            chunks[i] = got.narrow(dim, p * rows, rows)
        return torch.cat(chunks, dim), None, None, None


def _back_routes(routes: Sequence[Sequence[int]], n: int) -> list:
    """The routes that send every rank's received chunks (in
    ``all_to_all_cat``'s order) back to their sources."""
    return [[u for u in range(n) for d in routes[u] if d == r]
            for r in range(n)]


def exchange_grad(x: torch.Tensor, group, dim: int,
                  routes: Sequence[Sequence[int]]) -> torch.Tensor:
    return _Exchange.apply(x, group, dim, routes)


class _GatherScatter(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward: FSDP's
    parameter gather and sequence parallelism's activation gather (each
    rank's use of the whole tensor contributes a part of its
    gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g, ctx.group, ctx.dim), None, None


class _ScatterGather(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward: the
    partial sums of a row-split product back to sequence blocks."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's
    block of the gradient: every rank of ``group`` computed the same
    whole result from the gathered tensor, so each holds the whole
    gradient already."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, dist.get_world_size(group)
        ctx.rank = dist.get_rank(group)
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        step = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.rank * step, step).contiguous(), \
            None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward (a tensor
    every rank holds whole enters compute split over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward (the partial
    sums of a split product become the whole on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_grad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherScatter.apply(x, group, dim)


def scatter_grad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ScatterGather.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherReplicated.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class _MeanOverRanks(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``groups`` forward (a sum over
    each group, then one division by a tensor of their count ``n``);
    the gradient unchanged backward.  Every rank's loss holds the same
    mean, and the step divides the gradients summed over the batch's
    ranks once by ``n``: each rank's ``d mean / d x`` is therefore 1,
    not 1/n (``batch_means``)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        y = x.clone()
        for g in groups:
            all_reduce_sum_(y, g)
        return y.div_(torch.full((), n, dtype=y.dtype, device=y.device))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def batch_means(mesh, axes: Sequence[str]):
    """The MoE aux loss's hook (``models.moe.moe_block``) for a step whose
    batch rows are split over ``axes``: ``frac`` and ``meanp`` averaged
    over those ranks before their product, as the reference's means run
    over the global batch; ``meanp`` keeps its gradient (one all-reduce
    of both a live axis and MoE chunk).  None where no axis splits."""
    sizes = mesh_axis_sizes(mesh)
    live = [a for a in axes if sizes[a] > 1]
    if not live:
        return None
    groups = [mesh.get_group(a) for a in live]
    n = math.prod(sizes[a] for a in live)

    def means(frac: torch.Tensor, meanp: torch.Tensor):
        both = _MeanOverRanks.apply(torch.stack([frac, meanp]), groups, n)
        return both[0], both[1]

    return means


def broadcast_(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """``t`` in place from ``group``'s rank ``src`` to all its ranks."""
    _count("broadcast", t, group)
    ex = _exchange(group)
    if ex is not None:
        slots = ex.slots(t.numel() * t.element_size())
        if ex.me == src:
            slots[src].copy_(_bytes(t))
        ex.barrier()
        if ex.me != src:
            t.copy_(_slot_as(slots[src], t, t.shape))
        ex.barrier()
    else:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def broadcast_int(value: int, mesh) -> int:
    """The mesh's first rank's host int on every rank (the DSSP delay:
    a host decision every rank must share).  Over the default group, so
    the mesh must span it."""
    if mesh.size() == 1:
        return int(value)
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}")
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device="cuda" if _device_type() == "cuda" else "cpu")
    _count("broadcast", t, None)
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return int(t.item())


# ------------------------------------------------------------ blocks
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coords(mesh) -> Dict[str, int]:
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def split_dims(spec: PartitionSpec, mesh) -> Dict[int, Tuple[str, ...]]:
    """{dimension: its mesh axes} for the dimensions ``spec`` splits into
    more than one block on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    out = {}
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        if math.prod(sizes[a] for a in axes) > 1:
            out[i] = axes
    return out


def block_view(x: torch.Tensor, spec: PartitionSpec, mesh,
               dims: Optional[Iterable[int]] = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` as a view (``dims``:
    only those dimensions)."""
    sizes = mesh_axis_sizes(mesh)
    coord = None
    for i, axes in split_dims(spec, mesh).items():
        if dims is not None and i not in dims:
            continue
        coord = coord or _coords(mesh)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if x.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(x.shape)} does not "
                             f"split into {n} blocks ({spec})")
        step = x.shape[i] // n
        x = x.narrow(i, idx * step, step)
    return x


def gather_leaf(x: torch.Tensor, spec: PartitionSpec, mesh,
                dims: Optional[Iterable[int]] = None) -> torch.Tensor:
    """The whole of a leaf from this rank's block (``dims``: only those
    dimensions); the block itself where nothing is split."""
    for i, axes in split_dims(spec, mesh).items():
        if dims is not None and i not in dims:
            continue
        for a in reversed(axes):
            if mesh_axis_sizes(mesh)[a] > 1:
                x = all_gather_cat(x, mesh.get_group(a), i)
        MESH.block_copies += 1
    return x


def _spec_leaves(specs: Any) -> list:
    return tree_util.leaves(specs, is_leaf=is_spec)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    flat, treedef = tree_util.flatten(tree)
    sp = _spec_leaves(specs)
    if len(sp) != len(flat):
        raise ValueError(f"{len(flat)} leaves against {len(sp)} specs")
    return tree_util.unflatten(treedef, [fn(x, s) for x, s in zip(flat, sp)])


def place(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf's block on this rank, in storage of its own (a copy
    only where a dimension is split: on a mesh of one rank the leaves
    themselves)."""
    def one(x, spec):
        if not isinstance(x, torch.Tensor) or not split_dims(spec, mesh):
            return x
        MESH.block_copies += 1
        return block_view(x, spec, mesh).clone()

    return _zip_map(one, tree, specs)


def gather(tree: Any, specs: Any, mesh) -> Any:
    """Whole leaves from this rank's blocks (``place``'s inverse)."""
    return _zip_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def _first_rank(mesh) -> bool:
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def open_checkpoints(directory: str, mesh, **kw):
    """A ``checkpoint.manager.CheckpointManager`` on ``directory`` for
    each rank of ``mesh``: the mesh's first rank opens it first, which
    rolls back what a crash mid-save left there, while the others wait;
    they then open it without touching it, so every rank reads the same
    steps.  Every rank of the mesh calls it."""
    from repro_torch.checkpoint.manager import CheckpointManager
    first = _first_rank(mesh)
    if first:
        manager = CheckpointManager(directory, **kw)
    if mesh.size() > 1:
        dist.barrier()
    if not first:
        manager = CheckpointManager(directory, tidy=False, **kw)
    return manager


def save_blocks(manager, step: int, tree: Any, specs: Any, mesh,
                extras: Optional[Dict[str, Any]] = None) -> None:
    """``tree``'s whole leaves, from this rank's blocks under ``specs``,
    as checkpoint ``step`` of ``manager`` (``checkpoint.manager``: the
    reference's format, one ``.npy`` per whole leaf in flatten order).
    The leaves are gathered one at a time in flatten order; the mesh's
    first rank moves each to its host and writes it while the others
    wait, so no device holds more than one whole leaf beyond its
    blocks.  Every rank of the mesh calls it; it returns when the
    checkpoint is committed."""
    from repro_torch.checkpoint.manager import keystr_names, to_host
    first = _first_rank(mesh)
    named, sp = keystr_names(tree), _spec_leaves(specs)
    if len(named) != len(sp):
        raise ValueError(f"{len(named)} leaves against {len(sp)} specs")

    def wholes():
        for (name, x), s in zip(named, sp):
            whole = gather_leaf(x, s, mesh) if isinstance(
                x, torch.Tensor) else x
            if first:
                yield (name,) + to_host(whole)

    if first:
        manager.write(step, wholes(), extras or {})
    else:
        for _ in wholes():
            pass
    if mesh.size() > 1:
        dist.barrier()


def restore_blocks(manager, step: int, blocks: Any, like: Any, specs: Any,
                   mesh) -> Dict[str, Any]:
    """Checkpoint ``step`` of ``manager`` into this rank's ``blocks`` (in
    place) under ``specs``: each whole leaf read on the host one at a
    time (``like``: the whole tree's shapes, ``meta`` tensors will do),
    its block kept.  Returns the checkpoint's extras."""
    flat, sp = tree_util.leaves(blocks), _spec_leaves(specs)
    if not len(flat) == len(sp):
        raise ValueError(f"{len(flat)} leaves against {len(sp)} specs")
    with torch.no_grad():
        for cur, s, whole in zip(flat, sp, manager.leaves(step, like)):
            cur.copy_(block_view(whole, s, mesh))
    return manager.peek_extras(step)


def all_reduce_mean(tensors: Sequence[torch.Tensor], axes: Sequence[str],
                    mesh) -> None:
    """Average ``tensors`` in place over the mesh ``axes`` (a sum over
    each axis's group, then one division by a tensor: the port divides
    by tensors, so CUDA does an IEEE division, not a reciprocal
    multiply)."""
    sizes = mesh_axis_sizes(mesh)
    live = [a for a in axes if sizes[a] > 1]
    if not live:
        return
    n = math.prod(sizes[a] for a in live)
    for t in tensors:
        for a in live:
            all_reduce_sum_(t, mesh.get_group(a))
        t.div_(torch.full((), n, dtype=t.dtype, device=t.device))


def spec_axes(spec: PartitionSpec, dim: int = 0) -> Tuple[str, ...]:
    """The mesh axes ``spec`` gives dimension ``dim`` (none past its
    length)."""
    return _axes(spec[dim]) if dim < len(spec) else ()


# ------------------------------------------------------------ ranks
def _rank_main(fn, rank: int, world_size: int, store_path: str,
               args: tuple, threads: int, queue) -> None:
    import traceback
    torch.set_num_threads(threads)
    try:
        start_group(rank, world_size, backend="gloo",
                    store=dist.FileStore(store_path, world_size))
        queue.put((rank, True, fn(rank, world_size, *args)))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        release_host_exchanges()
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, workdir: str, *, args: tuple = (),
              timeout: float = 120.0, threads: int = 1) -> list:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes on one host, each with the default group started over
    gloo (ranks sharing one card too, which NCCL refuses; a
    ``FileStore`` under ``workdir``, so concurrent runs never share a
    rendezvous);
    the results in rank order.  ``fn`` must be importable by name (a
    module-level function) and return something picklable.  Raises
    with the rank's traceback when one fails, and when ``timeout``
    seconds pass first; every process is stopped either way."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    fd, store_path = tempfile.mkstemp(prefix="rendezvous-", dir=workdir)
    os.close(fd)
    os.unlink(store_path)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, store_path, args,
                               threads, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks did not finish in "
                                   f"{timeout} s (done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"a rank exited with {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        # after a failure the other ranks may wait in a collective for
        # the failed one: stop them at once
        grace = (max(1.0, deadline - time.monotonic())
                 if len(out) == world_size else 0.0)
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join(5)
        if os.path.exists(store_path):
            os.unlink(store_path)
    return [out[r] for r in range(world_size)]
