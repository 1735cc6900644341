"""Optimizers (tree in, tree out, an optax-like minimal API) with
staleness awareness.

Counterpart of ``repro/optim/optimizers.py``: ``init(params) -> state``;
``update(grads, state, params, *, staleness=0, lr_scale=1.0) ->
(new_params, new_state)``.

* ``sgd`` / ``momentum``  — the paper's server update rule.
* ``adamw``               — standard training baseline.
* ``adafactor``           — factored second moment (the >100B configs).
* Every rule accepts ``staleness`` and optionally damps the step by
  1/(1+s) — the Omnivore-style mitigation the paper cites (§II); used by
  the DSSP-SPMD delayed-gradient pipeline.

In place.  Where the reference's jitted step donates the parameters and
the optimizer state, ``update`` writes the new values into the tensors
of ``params`` and ``state`` (under ``torch.no_grad``) and returns those
trees; ``count`` is the one leaf it replaces.  It goes leaf by leaf,
and the elementwise rules (sgd, momentum, adamw) cut a large leaf into
blocks of its first (stacked-layer) axis, so each f32 temporary stays
near ``_BLOCK`` elements: at h2o-danube-1.8b's width one MLP leaf
(24, 2560, 6912) would take 1.7 GB per whole-leaf f32 temporary.
Elementwise math on a block is bitwise the math on the whole leaf.
Adafactor normalises each update by its whole leaf's RMS, so it works a
leaf at a time.

Scalars.  ``count`` is an int32 0-d tensor on the host; the staleness
scale, the bias corrections and Adafactor's decay are f32 0-d tensors
computed on the host as the reference computes them in f32, each
update's operations in the reference's order.  A divisor goes to the
leaves' device first: CUDA divides by a host scalar as a multiplication
by its reciprocal, not by IEEE division.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch import tree as tree_util

Params = Any
Grads = Any

#: elements per block of an elementwise update (64 MB of f32)
_BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _staleness_scale(staleness, damping: bool) -> torch.Tensor:
    if not damping:
        return _f32(1.0)
    return 1.0 / (1.0 + _f32(staleness))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _blocks(*leaves: torch.Tensor) -> Sequence[Tuple[torch.Tensor, ...]]:
    """Matching views of ``leaves`` (one shape) in blocks of their first
    axis of about ``_BLOCK`` elements each."""
    head = leaves[0]
    if head.dim() < 2 or head.numel() <= _BLOCK:
        return [leaves]
    rows = max(1, _BLOCK // max(1, head[0].numel()))
    return list(zip(*(torch.split(x, rows) for x in leaves)))


def _leafwise(fn: Callable, *trees) -> None:
    """``fn(*blocks)`` over every leaf of ``trees`` (one structure), a
    block at a time, without autograd."""
    flat = [tree_util.leaves(t) for t in trees]
    n = len(flat[0])
    if any(len(f) != n for f in flat):
        raise ValueError(f"trees with {[len(f) for f in flat]} leaves")
    with torch.no_grad():
        for leaves in zip(*flat):
            for blocks in _blocks(*leaves):
                fn(*blocks)


def _device_of(tree) -> torch.device:
    leaves = tree_util.leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


# ------------------------------------------------------------------ SGD
def sgd(lr: float, *, staleness_damping: bool = False) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, *, staleness=0, lr_scale=1.0):
        s = lr * lr_scale * _staleness_scale(staleness, staleness_damping)

        def one(p, g):
            p.copy_((p.float() - s * g.float()).to(p.dtype))

        _leafwise(one, params, grads)
        return params, state

    return Optimizer("sgd", init, update)


def momentum(lr: float, beta: float = 0.9, *, nesterov: bool = False,
             staleness_damping: bool = False) -> Optimizer:
    def init(params):
        return tree_util.tree_map(_zeros_f32, params)

    def update(grads, state, params, *, staleness=0, lr_scale=1.0):
        scale = _staleness_scale(staleness, staleness_damping)
        step_lr = lr * lr_scale

        def one(p, g, v):
            gs = g.float() * scale
            v.mul_(beta).add_(gs)                    # beta * v + g * scale
            st = beta * v + gs if nesterov else v
            p.copy_((p.float() - step_lr * st).to(p.dtype))

        _leafwise(one, params, grads, state)
        return params, state

    return Optimizer("momentum", init, update)


# ------------------------------------------------------------------ AdamW
class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, *,
          staleness_damping: bool = False) -> Optimizer:
    def init(params):
        return AdamState(mu=tree_util.tree_map(_zeros_f32, params),
                         nu=tree_util.tree_map(_zeros_f32, params),
                         count=_count0())

    def update(grads, state, params, *, staleness=0, lr_scale=1.0):
        count = state.count + 1
        scale = _staleness_scale(staleness, staleness_damping)
        dev = _device_of(params)
        c1 = (1 - b1 ** count.float()).to(dev)
        c2 = (1 - b2 ** count.float()).to(dev)
        step_lr = lr * lr_scale

        def one(p, g, m, v):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf * scale)
            v.mul_(b2).add_((1 - b2) * torch.square(gf))
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            pf = p.float()
            p.copy_((pf - step_lr * (upd + weight_decay * pf)).to(p.dtype))

        _leafwise(one, params, grads, state.mu, state.nu)
        return params, AdamState(mu=state.mu, nu=state.nu, count=count)

    return Optimizer("adamw", init, update)


# ------------------------------------------------------------------ Adafactor
class AdafactorState(NamedTuple):
    v_row: Any       # factored second moment (rank>=2 leaves)
    v_col: Any
    v_full: Any      # unfactored for vectors
    count: torch.Tensor


def whole_mean(x, dim, pdim, keepdim=False):
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim,
                                                       keepdim=keepdim)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, *,
              staleness_damping: bool = False) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern 2018) without update clipping
    schedules; factored along the last two dims of every rank>=2 leaf."""

    def init(params):
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def rows(p):
            return zeros(() if p.dim() < 2 else p.shape[:-1], p)

        def cols(p):
            return zeros(() if p.dim() < 2 else p.shape[:-2] + p.shape[-1:],
                         p)

        def full(p):
            return zeros(p.shape if p.dim() < 2 else (), p)

        return AdafactorState(v_row=tree_util.tree_map(rows, params),
                              v_col=tree_util.tree_map(cols, params),
                              v_full=tree_util.tree_map(full, params),
                              count=_count0())

    def update(grads, state, params, *, staleness=0, lr_scale=1.0,
               means=None):
        """``means``: per leaf, ``mean(x, dim, pdim, keepdim)`` over the
        whole leaf's dimension ``pdim`` (None: every dimension) of a
        block ``x`` (a mesh step's blocks reduce over their axes);
        default ``torch.mean`` over ``x`` itself."""
        count = state.count + 1
        t = count.float()
        beta = 1.0 - t ** (-decay)
        scale = _staleness_scale(staleness, staleness_damping)
        dev = _device_of(params)
        clip = _f32(clip_threshold).to(dev)
        step_lr = lr * lr_scale

        def one(p, g, vr, vc, vf, mean):
            gf = g.float() * scale
            g2 = torch.square(gf) + eps
            r_ = p.dim()
            if r_ < 2:
                vf.copy_(beta * vf + (1 - beta) * g2)
                u = gf * torch.rsqrt(vf + eps)
            else:
                vr.copy_(beta * vr + (1 - beta) * mean(g2, -1, r_ - 1))
                vc.copy_(beta * vc + (1 - beta) * mean(g2, -2, r_ - 2))
                # normalized row factor keeps the factored product an
                # unbiased estimate of the full second moment
                r = vr / torch.clamp_min(
                    mean(vr, -1, r_ - 2, keepdim=True), eps)
                denom = (torch.sqrt(r)[..., :, None]
                         * torch.sqrt(vc)[..., None, :] + eps)
                u = gf / denom
            rms = torch.sqrt(mean(torch.square(u), None, None) + eps)
            u = u / torch.clamp_min(rms / clip, 1.0)
            p.copy_((p.float() - step_lr * u).to(p.dtype))

        flat: List[List[torch.Tensor]] = [
            tree_util.leaves(t) for t in (params, grads, state.v_row,
                                          state.v_col, state.v_full)]
        per_leaf = means or [whole_mean] * len(flat[0])
        with torch.no_grad():
            for leaves, mean in zip(zip(*flat), per_leaf):
                one(*leaves, mean)
        return params, AdafactorState(v_row=state.v_row, v_col=state.v_col,
                                      v_full=state.v_full, count=count)

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, lr: float = 1e-3, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------- sharding specs
def state_partition_specs(opt: Optimizer, param_specs: Any,
                          param_sds: Any) -> Any:
    """PartitionSpec tree for ``opt``'s state, derived from the params'
    specs (optimizer state shards exactly like its parameter; factored
    Adafactor moments inherit the surviving dims' spec).  ``param_sds``
    gives the ranks (tensors, ``meta`` ones included)."""
    from repro_torch.models.sharding import PartitionSpec as P
    from repro_torch.models.sharding import is_spec

    def norm(spec, rank):
        dims = list(spec) + [None] * (rank - len(spec))
        return dims[:rank]

    if opt.name in ("sgd",):
        return ()
    if opt.name == "momentum":
        return param_specs
    if opt.name == "adamw":
        return AdamState(mu=param_specs, nu=param_specs, count=P())

    if opt.name == "adafactor":
        flat_specs = tree_util.leaves(param_specs, is_leaf=is_spec)
        flat_sds, tdef = tree_util.flatten(param_sds)

        rows, cols, fulls = [], [], []
        for spec, sds in zip(flat_specs, flat_sds):
            rank = len(sds.shape)
            dims = norm(spec, rank)
            if rank < 2:
                rows.append(P())
                cols.append(P())
                fulls.append(P(*dims))
            else:
                rows.append(P(*dims[:-1]))
                cols.append(P(*(dims[:-2] + [dims[-1]])))
                fulls.append(P())
        return AdafactorState(v_row=tree_util.unflatten(tdef, rows),
                              v_col=tree_util.unflatten(tdef, cols),
                              v_full=tree_util.unflatten(tdef, fulls),
                              count=P())
    raise ValueError(f"no spec rule for optimizer {opt.name!r}")
