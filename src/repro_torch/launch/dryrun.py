"""Multi-pod dry run: one step of every (arch × shape × mesh) cell on fake
tensors as rank 0 of a fake process group.

Counterpart of ``repro/launch/dryrun.py``: the same flags, the same
report keys, the same exit code (1 when a cell fails).  No compiler
lowers the port's step, so instead of compiling it the dry run executes
it, allocating nothing:

  1. starts the default process group on ``torch.distributed``'s
     ``"fake"`` backend (a ``FakeStore``) as rank 0 of 256 ranks
     (16 × 16) or 512 (2 × 16 × 16) and builds
     ``launch.mesh.make_production_mesh`` on it; every collective
     returns at once;
  2. builds the cell's ``StepBundle`` (``launch.steps.build_step``) at
     the published config, uncut, and calls its ``fn`` once on this
     rank's blocks of every argument as ``meta`` tensors (shapes and
     dtypes, no memory), so a 123B step allocates nothing.  Not
     ``FakeTensorMode`` on ``cuda``: the step reads host counters (the
     DSSP ring's step) on the host, which fake tensors refuse, and a
     CPU-only torch cannot run autograd on fake CUDA tensors.  The
     card's route is traced all the same: the kernel registry is made to
     take it, and the model's other device choices key on "not the
     CPU";
  3. counts, per rank: flops (the matrix products, by
     ``torch.utils.flop_counter``'s formulas, plus each kernel's own),
     bytes (every dispatched op's inputs and outputs; a kernel's
     inputs read once and outputs written once), the arguments' bytes,
     the most bytes live at once (storages tracked from allocation to
     release) and the collectives (``launch.mesh.COLLECTIVE_LOG``:
     kind, result bytes, group size);
  4. reports ``fits_hbm`` by the reference's rule, the arguments at most
     the card's memory (80 GB), with the peak beside it, and the
     roofline terms (``repro_torch.roofline``).

The kernels do not run: each registry kernel, and each CUDA-graph
replay (the scan's backward, the sLSTM's time loop), is replaced for the
cell by a stand-in that returns empty outputs of the right shape and
counts its inputs and outputs once and its operations (``PERF.md`` §6's
rows; a replay's matrix products).
The dry run restores the default group (there must be none when it
starts), the registry, the mesh and launch counters as it found them,
so it runs inside ``chip_smoke.py`` and pytest.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --out build/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --arch qwen1.5-32b --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import types
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as tree_util
from repro_torch.configs import arch_names, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_step
from repro_torch.models.sharding import is_spec, mesh_axis_sizes
from repro_torch.perfcount import LAUNCHES, MESH
from repro_torch.roofline import analysis as roofline

#: flops of the matrix products, as ``FlopCounterMode`` counts them
_FLOPS = flop_registry

#: aten ops that allocate without writing (their bytes are not traffic)
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh"}


def _tensors(tree: Any) -> list:
    return [x for x in tree_util.leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counts(TorchDispatchMode):
    """Bytes of every dispatched op (inputs + outputs; views, metadata
    and allocations move none, collectives are counted apart) and the
    bytes of the storages live at once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.flops = 0.0
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.kernels: Dict[str, int] = {}

    def track(self, tensors: Sequence[torch.Tensor]) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.current += st.nbytes()
            weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.current)

    def _release(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def kernel(self, name: str, inputs: Sequence[torch.Tensor],
               outputs: Sequence[torch.Tensor], ops: float) -> None:
        """A stand-in kernel: its inputs read once, outputs written
        once, ``ops`` operations."""
        self.bytes += sum(_nbytes(t) for t in (*inputs, *outputs))
        self.flops += ops
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flop = _FLOPS.get(func.overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **(kwargs or {}), out_val=out)
        name = func.overloadpacket.__name__.rstrip("_")
        if (func.namespace == "aten" and not func.is_view
                and name not in _ALLOCATIONS):
            ins = [x for x in tree_util.leaves((args, kwargs or {}))
                   if isinstance(x, torch.Tensor)]
            outs = _tensors(out) if not isinstance(out, torch.Tensor) \
                else [out]
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in outs
                              if not any(t is i for i in ins))
        new = _tensors(out) if not isinstance(out, torch.Tensor) else [out]
        if new:
            self.track(new)
        return out


# ------------------------------------------------------------ stand-ins
@contextlib.contextmanager
def _kernel_stand_ins(counts: _Counts):
    """The registry takes the card's route on any device and calls
    stand-ins in place of the kernels and of the two CUDA-graph replays
    (the scan's backward, the sLSTM's time loop forward and backward:
    on the card one replay each, whose eager bodies would walk the
    sequence step by step here).  Everything is put back on exit."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.interface import resolve
    from repro_torch.models import ssm

    def rmsnorm(x, weight, *, eps=1e-6):
        out = torch.empty_like(x)
        counts.kernel("rmsnorm", (x, weight), (out,), 4 * x.numel())
        return out

    def residual_rmsnorm(x, res, weight, *, eps=1e-6):
        s, out = torch.empty_like(x), torch.empty_like(x)
        counts.kernel("residual_rmsnorm", (x, res, weight), (s, out),
                      4 * x.numel())
        return s, out

    def flash_attention_fwd(q, k, v, *, causal=True, window=None,
                            head_dim=None):
        out = torch.empty_like(q)
        b, lq, hq, d = q.shape
        counts.kernel("flash_attention_fwd", (q, k, v), (out,),
                      4 * b * hq * lq * k.shape[1] * d)
        return out

    def ssm_scan(u, delta, a, bmat, cmat, h0, *, chunk=128):
        b, l, di = u.shape
        ds = a.shape[-1]
        y = torch.empty_like(u)
        h_last = torch.empty((b, di, ds), dtype=torch.float32,
                             device=u.device)
        counts.kernel("ssm_scan", (u, delta, a, bmat, cmat, h0),
                      (y, h_last), 7 * b * l * di * ds)
        return y, h_last

    def scan_backward(tensors, needs):
        u, a = tensors[0], tensors[2]
        b, l, di = u.shape
        grads = tuple(torch.empty_like(t) if n else None
                      for t, n in zip(tensors[:6], needs))
        counts.kernel("ssm_scan_backward", tensors,
                      [g for g in grads if g is not None],
                      3 * 7 * b * l * di * a.shape[-1])
        return grads

    def slstm_ops(gx):
        b, l, heads, g4 = gx.shape
        return 2 * b * l * heads * (g4 // 4) * g4   # h @ wh a step

    def slstm_loop(gx, wh):
        b, l, heads, g4 = gx.shape
        h = torch.empty((b, l, heads, g4 // 4), dtype=gx.dtype,
                        device=gx.device)
        counts.kernel("slstm_forward", (gx, wh), (h,), slstm_ops(gx))
        return h

    def slstm_backward(tensors, needs):
        grads = tuple(torch.empty_like(t) if n else None
                      for t, n in zip(tensors[:2], needs))
        counts.kernel("slstm_backward", tensors,
                      [g for g in grads if g is not None],
                      3 * slstm_ops(tensors[0]))
        return grads

    saved = {(registry, "resolved"): registry.resolved,
             (registry, "_rn"): registry._rn,
             (registry, "_rrn"): registry._rrn,
             (registry, "_fa"): registry._fa,
             (registry, "_scan"): registry._scan,
             (registry, "scan_backward_body"): registry.scan_backward_body,
             (ssm, "slstm_loop"): ssm.slstm_loop,
             (ssm, "slstm_backward_body"): ssm.slstm_backward_body}
    registry.resolved = lambda op, kernels, x: resolve(kernels, op,
                                                       cuda=True)
    registry._rn = types.SimpleNamespace(rmsnorm=rmsnorm)
    registry._rrn = types.SimpleNamespace(residual_rmsnorm=residual_rmsnorm)
    registry._fa = types.SimpleNamespace(
        flash_attention_fwd=flash_attention_fwd,
        kernel_operands=lambda q, k, v: (q, k, v))
    registry._scan = types.SimpleNamespace(ssm_scan=ssm_scan)
    registry.scan_backward_body = scan_backward
    ssm.slstm_loop = slstm_loop
    ssm.slstm_backward_body = slstm_backward
    try:
        yield
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)


# ------------------------------------------------------------ fake ranks
@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group on the ``"fake"`` backend, this process
    rank 0 of ``world_size``; destroyed on exit.  Refuses to replace a
    group the caller has."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a default "
                           "process group (it starts a fake one)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _block_shape(shape, spec, sizes) -> Tuple[int, ...]:
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        out[i] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def _meta_blocks(sds: Any, specs: Any, sizes) -> Any:
    """This rank's block of every ``meta`` leaf of ``sds`` (a real leaf,
    a host step counter the step reads on the host, stays itself)."""
    flat, treedef = tree_util.flatten(sds)
    sp = tree_util.leaves(specs, is_leaf=is_spec) if flat else []
    return tree_util.unflatten(treedef, [
        torch.empty(_block_shape(x.shape, spec, sizes), dtype=x.dtype,
                    device="meta") if x.device.type == "meta" else x
        for x, spec in zip(flat, sp)])


def execute(bundle, mesh, shape: ShapeSpec) -> Dict[str, Any]:
    """Run ``bundle.fn`` once on ``meta`` blocks of its arguments and
    count (module docstring).  Returns flops, bytes, argument and peak
    bytes, the collective records and the stand-in kernels' calls."""
    sizes = mesh_axis_sizes(mesh)
    counts = _Counts()
    log: list = []
    mesh_before, launches_before = MESH.snapshot(), LAUNCHES.snapshot()
    sds = list(bundle.input_sds)
    host = None
    last = sds[-1]
    if isinstance(last, torch.Tensor) and last.dim() == 0:
        sds.pop()       # the step's host int (delay, decode index)
        host = 1 if shape.kind == "train" else shape.seq_len - 1
    args = [_meta_blocks(x, s, sizes)
            for x, s in zip(sds, bundle.in_shardings)]
    if host is not None:
        args.append(host)
    counts.track(_tensors(args))
    arg_bytes = counts.current
    mesh_lib.COLLECTIVE_LOG = log
    try:
        with _kernel_stand_ins(counts), counts:
            bundle.fn(*args)
    finally:
        mesh_lib.COLLECTIVE_LOG = None
        for counter, before in ((MESH, mesh_before),
                                (LAUNCHES, launches_before)):
            for k, v in before.items():
                setattr(counter, k, v)
    return {"flops": counts.flops,
            "bytes": counts.bytes, "argument_bytes": arg_bytes,
            "peak_bytes": counts.peak, "collectives": log,
            "kernels": dict(counts.kernels)}


# ------------------------------------------------------------ cells
def mesh_label(shape: Sequence[int]) -> str:
    return "x".join(str(n) for n in shape)


def depth_fit(cfg) -> Optional[Tuple[Any, Any, int, int, int]]:
    """``(cfg at d1 units, cfg at d2 units, d1, d2, units)`` for the
    families whose Python loops inside a layer (MoE routing over chunks
    and top-k slots, the hybrid's Mamba and MoE) make a full-depth trace
    take many minutes; None for the others, traced at full depth.  Every
    count of a homogeneous stack (flops, bytes, collectives, argument
    and peak bytes) is affine in its depth, so two depths give it
    exactly (the reference fits XLA's costs the same way,
    ``repro/roofline/analysis.py:233``).  A config of at most two units
    is traced at its own depth (None)."""
    if cfg.family == "hybrid":
        p = cfg.attn_period or 1
        units = cfg.n_layers // p
        fit = (cfg.scaled(n_layers=p), cfg.scaled(n_layers=2 * p), 1, 2,
               units)
    elif cfg.moe is not None:
        units = cfg.n_layers
        fit = (cfg.scaled(n_layers=1), cfg.scaled(n_layers=2), 1, 2, units)
    else:
        return None
    return fit if units > 2 else None


def _cell_counts(cfg, mesh, shape, kw) -> Tuple[Dict[str, Any], bool]:
    bundle = build_step(cfg, mesh, shape, **kw)
    counts = execute(bundle, mesh, shape)
    counts["collectives"] = roofline.parse_collectives(counts["collectives"])
    return counts, bundle.partitioned


def _fit(c1: Dict[str, Any], c2: Dict[str, Any], d1: int, d2: int,
         units: int) -> Dict[str, Any]:
    def f(a, b):
        return roofline.affine_fit(a, b, d1, d2, units)

    s1, s2 = c1["collectives"], c2["collectives"]
    kinds = set(s1.count_by_kind) | set(s2.count_by_kind)

    def by(attr):
        one, two = getattr(s1, attr), getattr(s2, attr)
        return {k: int(round(f(one.get(k, 0), two.get(k, 0))))
                for k in kinds}

    out = {k: f(c1[k], c2[k]) for k in ("flops", "bytes", "argument_bytes",
                                        "peak_bytes")}
    out["collectives"] = roofline.CollectiveStats(
        by("bytes_by_kind"), by("count_by_kind"), by("result_bytes_by_kind"),
        f(s1.seconds, s2.seconds))
    out["kernels"] = {k: int(round(f(c1["kernels"].get(k, 0),
                                     c2["kernels"].get(k, 0))))
                      for k in set(c1["kernels"]) | set(c2["kernels"])}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sync: str = "dssp", verbose: bool = True, *,
             cfg=None, shape: Optional[ShapeSpec] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             partition: bool = True, optimizer=None) -> dict:
    """One cell's report.  ``cfg``, ``shape`` and ``mesh_shape`` (axes
    ('data', 'model'), or ('pod', 'data', 'model') for three) replace
    the published config, the named shape and the production mesh;
    ``partition=False`` runs the step that gathers whole parameters;
    ``optimizer`` replaces the config's.  Where ``depth_fit`` gives two
    depths, the cell is counted at both and fitted to its own."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    label = mesh_label(mesh_shape)
    if not cell_applicable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": label,
                "status": "skipped",
                "reason": "full attention is quadratic at 500k "
                          "(DESIGN.md §5)"}
    t0 = time.monotonic()
    n = math.prod(mesh_shape)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    kw: Dict[str, Any] = {}
    if shape.kind == "train":
        kw = {"sync": sync, "partition": partition}
        if optimizer is not None:
            kw["optimizer"] = optimizer
    fitted = depth_fit(cfg)
    with fake_group(n):
        mesh = mesh_lib.make_mesh(mesh_shape, axes)
        if fitted is None:
            counts, partitioned = _cell_counts(cfg, mesh, shape, kw)
            how = "direct"
        else:
            cfg1, cfg2, d1, d2, units = fitted
            c1, partitioned = _cell_counts(cfg1, mesh, shape, kw)
            c2, _ = _cell_counts(cfg2, mesh, shape, kw)
            counts = _fit(c1, c2, d1, d2, units)
            how = f"affine(d{d1},d{d2}->L{units})"
    terms = roofline.extract(counts, cfg, shape, label, n)
    trace_s = time.monotonic() - t0
    if verbose:
        print(f"--- {arch} × {shape_name} × {label} "
              f"(sync={sync if shape.kind == 'train' else '-'}, "
              f"{'partitioned' if partitioned else 'whole leaves'}, "
              f"{how}) ---")
        print(roofline.HEADER)
        print(roofline.format_row(terms))
        sys.stdout.flush()
    return {
        "arch": arch, "shape": shape_name, "mesh": label,
        "status": "ok", "sync": sync if shape.kind == "train" else None,
        "partitioned": partitioned, "fit": how,
        "trace_seconds": round(trace_s, 1),
        "fits_hbm": bool(terms.per_device_argument_bytes
                         <= roofline.HBM_BYTES),
        "flops_per_chip": terms.flops,
        "hbm_bytes_per_chip": terms.hbm_bytes,
        "collective_bytes_per_chip": terms.collective_bytes,
        "t_compute": terms.t_compute,
        "t_memory": terms.t_memory,
        "t_collective": terms.t_collective,
        "dominant": terms.dominant,
        "model_flops": terms.model_flops,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "argument_gib_per_chip": terms.per_device_argument_bytes / 2**30,
        "peak_gib_per_chip": terms.peak_memory_bytes / 2**30,
        "collective_counts": terms.collective_counts,
        "kernel_calls": counts["kernels"],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sync", default="dssp",
                    choices=["bsp", "ssp", "dssp"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = arch_names() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                try:
                    results.append(run_cell(arch, shape, multi,
                                            sync=args.sync))
                except Exception as e:  # a failed cell is a bug: report it
                    failures += 1
                    traceback.print_exc()
                    results.append({
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if multi else "16x16",
                        "status": "error", "error": repr(e)[:500],
                    })
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".",
                                exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1, default=float)

    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n=== dry-run: {ok} ok, {sk} skipped, {failures} failed, "
          f"{len(results)} total ===")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
