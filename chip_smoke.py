#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``--only norms,ssm_scan`` runs only the device, build and those kernel
checks; ``--src DIR`` runs the repro_torch package under DIR, e.g. an
earlier commit's, so its kernels are timed in the same call.)

Phases, in order; any failure exits non-zero and no phase carries on
after an error:

  device   require CUDA; print the card's name and power limit
           (nvidia-smi), the torch and CUDA versions; TF32 off
  build    compile the Hopper kernels of the eight TPU kernels
           (src/repro_torch/kernels/csrc; attention has a wgmma/TMA kernel
           for bf16 and a scalar one for f32) with nvcc, one process per
           source, and load the library; print each kernel's registers
           and spills, and (cuobjdump) the scan kernel's run loop:
           its instructions per exponential, one per (b, t, d, s)
  kernels  each kernel against its plain PyTorch version on the card, at
           the main path's shapes and a few others (ragged sizes, f32 and
           bf16), with its tolerance; median CUDA-event times of the
           kernel, the plain version and one library call where PyTorch
           has one, and the least time the card could take (bound); for
           attention's bf16 and f32 train shapes, the norms' dense and
           Jamba shapes and the scan's main case also device times by
           the profiler (the L2 flushed for the norms and the scan)
  parity   the smoke config trained through ``build_session`` twice on
           the card, kernels vs plain formulations: the losses must agree
  train    ``repro_torch.api.build_session`` on the FULL h2o-danube-1.8b
           (24 layers, d_model 2560, bf16, remat): 8 DSSP steps of 2
           workers through 4 shards with delta pulls; losses finite,
           staleness within s_upper, DSSP extensions == credit releases,
           and every kernel's launch count equal to what the run implies
  profile  two more steps (1 worker) under torch.profiler: device time
           per kernel group, and the device's idle share of two untraced
           steps of the same configuration
  server   the server layer at FULL width: (a) DSSP with coalesced
           applies (ps.coalesce=2) and int8 wire compression, (b) BSP with
           coalesced applies and top-k wire compression, 8 steps of 2
           workers each; losses finite, staleness within s_upper, DSSP
           extensions == credit releases, every shard's coalesce flushes
           summing to its version, and the batched/compression kernels'
           launch counts equal to what the flushes and pushes imply
  paths    the monolithic packed server (coalesced) and the tree wire
           (sharded server, global gate, tree apply) at smoke size, one
           short BSP run each
  jamba parity
           the Jamba smoke config (Mamba, attention, MoE with 4 experts)
           trained through ``build_session`` twice on the card, kernels
           vs plain formulations: the losses must agree
  hybrid   jamba-v0.1-52b at its published widths, cut to one period
           group (8 layers: 7 Mamba, 1 attention) and no experts, passed
           as ``model_config``: 8 DSSP steps of 2 workers through 4
           shards with delta pulls, checked as the train phase is, with
           14 ``ssm_scan`` launches per worker step
  hybrid profile
           two one-worker steps of that configuration under
           torch.profiler, with the ``ssm_scan`` kernel and the scan's
           plain backward as groups of their own

The last two lines of standard output are the JSON kernel table and the
contract line ``{"ok": true, "device": {...}}``.  This script imports
nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # f32 outside the tensor cores
#: exponentials per second on the special function units: 16 results per
#: clock per SM at compute capability 9.0 (CUDA C++ Programming Guide,
#: arithmetic instruction throughput), 132 SMs, 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
#: instructions issued per second, one a clock per lane: 4 schedulers of
#: 32 lanes per SM, 132 SMs, 1.98 GHz
LANE_ISSUE_PER_S = 128 * 132 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


# ----------------------------------------------------------------- timing
class Timer:
    """Median of per-launch CUDA-event times; the L2 cache (50 MB) is
    flushed before every launch so memory-bound kernels read from device
    memory, as on the main path."""

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def device_ms(torch, fn, reps: int = 10, flush=None) -> float:
    """Mean device time of one call of ``fn``: the kernels it launches,
    summed as ``torch.profiler`` traces them (no host time, no gaps);
    0.0 if the tracer saw no kernels.  With ``flush`` (a buffer larger
    than the 50 MB L2), the buffer is zeroed before every call, so the
    call reads from device memory, and the zeroing's own kernels (named
    by tracing one zeroing alone) are left out of the sum."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA

    def kernels(prof):
        return [e for e in prof.events()
                if e.device_type == cuda and not e.is_user_annotation]

    skip = set()
    if flush is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush.zero_()
            torch.cuda.synchronize()
        skip = {e.name for e in kernels(prof)}
        if not skip:   # the tracer saw nothing: no measurement
            return 0.0
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in kernels(prof)
               if e.name not in skip) / 1e3 / reps


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def free_device_memory(torch) -> None:
    """Drop what earlier phases left so each phase's peak is its own: a
    server and its coalescing windows refer to each other, so a closed
    session's buffers wait for the cycle collector."""
    gc.collect()
    torch.cuda.empty_cache()


def bf16_ulp(torch, ref):
    """One bf16 ulp at each value of ``ref`` (f32 tensor)."""
    mag = ref.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def sass_counts(library: str, function: str):
    """Static instruction counts of one kernel of the built library, by
    ``cuobjdump -sass``: the total, the count of each opcode, and the
    loop (backward branch) holding the most MUFU.EX2, its instructions
    and exponentials.  ``function`` is a part of the mangled name; None
    without cuobjdump."""
    import re
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300).stdout
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*)")
    code, inside = [], False   # (address, opcode, branch target or None)
    for line in dump.splitlines():
        if "Function :" in line:
            if code and inside:
                break
            inside = function in line
            continue
        m = insn.search(line) if inside else None
        if m:
            tgt = re.match(r"\s*0x([0-9a-f]+)", m.group(3))
            code.append((int(m.group(1), 16), m.group(2),
                         int(tgt.group(1), 16) if m.group(2) == "BRA"
                         and tgt else None))
    if not code:
        return None
    ops = {}
    for _, op, _ in code:
        ops[op] = ops.get(op, 0) + 1
    out = {"function": function, "instructions": len(code),
           "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    loops = [[c for c in code if tgt <= c[0] <= addr]
             for addr, _, tgt in code if tgt is not None and tgt < addr]
    if loops:
        body = max(loops, key=lambda b: sum(op == "MUFU.EX2"
                                            for _, op, _ in b))
        out["loop_instructions"] = len(body)
        out["loop_ex2"] = sum(op == "MUFU.EX2" for _, op, _ in body)
    return out


# ----------------------------------------------------------------- kernels
def check_fused_update(torch, timer, fu, main_rows):
    out = []
    cases = [("f32 2^24", torch.float32, (1 << 24) // 512),
             ("bf16 2^24", torch.bfloat16, (1 << 24) // 512),
             ("bf16 shard-0 region", torch.bfloat16, main_rows)]
    g = torch.Generator(device="cuda").manual_seed(1)
    for label, dt, rows in cases:
        shape = (rows, 512)
        p, m, gr = (torch.randn(shape, generator=g, device="cuda").to(dt)
                    for _ in range(3))
        kw = dict(lr=3e-3, beta=0.9, scale=1.0)
        po, mo = fu.fused_update(p, m, gr, **kw)
        pr, mr = fu.fused_update_plain(p, m, gr, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(po, pr) and torch.equal(mo, mr)):
            fail(f"fused_update {label}: not bitwise equal to the plain "
                 "version")
        err = max((po.float() - pr.float()).abs().max().item(),
                  (mo.float() - mr.float()).abs().max().item())
        n = p.numel()
        ms = timer(lambda: fu.fused_update(p, m, gr, **kw))
        plain_ms = timer(lambda: fu.fused_update_plain(p, m, gr, **kw))
        lib_ms = None
        sgd = getattr(torch, "_fused_sgd_", None)
        if sgd is not None:   # scale=1: SGD with momentum is this function
            pl, ml = p.clone(), m.clone()
            lib_ms = timer(lambda: sgd(
                [pl], [gr], [ml], weight_decay=0.0, momentum=0.9, lr=3e-3,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            del pl, ml
        bms, by = bound(5 * n * p.element_size(), 5 * n,
                        str(dt).split(".")[1])
        rec = dict(kernel="fused_update", case=label, shape=list(shape),
                   max_abs_err=err, tolerance="bitwise", ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                   bound_by=by)
        say(rec)
        out.append(rec)
        del p, m, gr, po, mo, pr, mr
    return out[-1]


def _bitwise_err(torch, label, outs, refs):
    """Max |kernel - plain| over paired outputs; fails unless bitwise."""
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{label}: {a.dtype} {tuple(a.shape)} against the plain "
                 f"version's {b.dtype} {tuple(b.shape)}")
    errs = [(a.float() - b.float()).abs().max().item() if a.numel() else 0.0
            for a, b in zip(outs, refs)]
    if not all(torch.equal(a, b) for a, b in zip(outs, refs)):
        fail(f"{label}: not bitwise equal to the plain version (max |err| "
             f"per output {errs})")
    return max(errs)


def check_fused_update_batched(torch, timer, fu, main_rows):
    """K gradient regions folded in one launch, against the plain fold (K
    sequential plain steps) and, for the time, two sequential launches
    of the single kernel."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [  # (label, dtype, rows, K, main)
        ("bf16 shard-0 region K=2", torch.bfloat16, main_rows, 2, True),
        ("f32 shard-0 region K=2", torch.float32, main_rows, 2, False),
        ("bf16 shard-0 region K=3", torch.bfloat16, main_rows, 3, False),
        ("bf16 shard-0 region K=1", torch.bfloat16, main_rows, 1, False),
        ("bf16 8 rows K=2", torch.bfloat16, 8, 2, False),
        ("bf16 (0, 512) K=2", torch.bfloat16, 0, 2, False),
    ]
    main = None
    for label, dt, rows, k, is_main in cases:
        shape = (rows, 512)
        p, m = (torch.randn(shape, generator=g, device="cuda").to(dt)
                for _ in range(2))
        gs = [torch.randn(shape, generator=g, device="cuda").to(dt)
              for _ in range(k)]
        kw = dict(lr=3e-3, beta=0.9, scales=[1.0 / (1 + j) for j in range(k)])
        out = fu.fused_update_batched(p, m, gs, **kw)
        ref = fu.fused_update_batched_plain(p, m, gs, **kw)
        err = _bitwise_err(torch, f"fused_update_batched {label}", out, ref)
        rec = dict(kernel="fused_update_batched", case=label,
                   shape=[k, rows, 512], max_abs_err=err,
                   tolerance="bitwise")
        if is_main or (rows == main_rows and dt == torch.float32):
            n = p.numel()
            rec["ms"] = timer(lambda: fu.fused_update_batched(p, m, gs, **kw))
            rec["plain_ms"] = timer(
                lambda: fu.fused_update_batched_plain(p, m, gs, **kw))

            def sequential():
                pp, mm = p, m
                for gj, sj in zip(gs, kw["scales"]):
                    pp, mm = fu.fused_update(pp, mm, gj, lr=3e-3, beta=0.9,
                                             scale=sj)
            rec["sequential_single_kernel_ms"] = timer(sequential)
            # (2 + K) reads and 2 writes per element
            rec["bound_ms"], rec["bound_by"] = bound(
                (4 + k) * n * p.element_size(), (4 * k) * n,
                str(dt).split(".")[1])
            rec["library_ms"] = None   # no one PyTorch call folds K steps
        say(rec)
        if is_main:
            main = rec
        del p, m, gs, out, ref
    return main


def check_fused_compress(torch, timer, fc, main_rows):
    """int8 and top-k error-feedback compression of a shard region, with
    a non-zero carried error, against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [  # (kernel, fraction, label, dtype, rows, main)
        ("fused_int8_ef", None, "bf16 shard-0 region", torch.bfloat16,
         main_rows, True),
        ("fused_int8_ef", None, "f32 shard-0 region", torch.float32,
         main_rows, False),
        ("fused_int8_ef", None, "bf16 8 rows", torch.bfloat16, 8, False),
        ("fused_int8_ef", None, "bf16 (0, 512)", torch.bfloat16, 0, False),
        ("fused_topk_ef", 0.05, "bf16 shard-0 region fraction 0.05",
         torch.bfloat16, main_rows, True),
        ("fused_topk_ef", 0.01, "bf16 shard-0 region fraction 0.01",
         torch.bfloat16, main_rows, False),
        ("fused_topk_ef", 0.25, "bf16 shard-0 region fraction 0.25",
         torch.bfloat16, main_rows, False),
        ("fused_topk_ef", 0.05, "f32 shard-0 region fraction 0.05",
         torch.float32, main_rows, False),
        ("fused_topk_ef", 0.05, "bf16 8 rows", torch.bfloat16, 8, False),
        ("fused_topk_ef", 0.05, "bf16 (0, 512)", torch.bfloat16, 0, False),
    ]
    main = {}
    for name, frac, label, dt, rows, is_main in cases:
        shape = (rows, 512)
        gr = torch.randn(shape, generator=g, device="cuda").to(dt)
        e = 0.01 * torch.randn(shape, generator=g, device="cuda")
        if name == "fused_int8_ef":
            kern = lambda: fc.fused_int8_ef(gr, e)
            plain = lambda: fc.fused_int8_ef_plain(gr, e)
            ops_per_elem = 8      # add, abs, max, divide, round, clip, mul, sub
        else:
            kern = lambda: fc.fused_topk_ef(gr, e, fraction=frac)
            plain = lambda: fc.fused_topk_ef_plain(gr, e, fraction=frac)
            ops_per_elem = 4 + 2 * 24   # 24 rounds of compare + count
        err = _bitwise_err(torch, f"{name} {label}", kern(), plain())
        rec = dict(kernel=name, case=label, shape=list(shape),
                   max_abs_err=err, tolerance="bitwise")
        if frac is not None:
            rec["fraction"] = frac
        if rows == main_rows and (is_main or dt == torch.float32):
            n = gr.numel()
            rec["ms"] = timer(kern)
            rec["plain_ms"] = timer(plain)
            # g read + g' written in g's dtype, e read + e' written in f32
            rec["bound_ms"], rec["bound_by"] = bound(
                n * (2 * gr.element_size() + 8), ops_per_elem * n,
                "float32")
            rec["library_ms"] = None   # no one PyTorch call does this
        say(rec)
        if is_main:
            main[name] = rec
        del gr, e
    return main


def check_norms(torch, timer, rn, rrn):
    g = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    #: the dense step's shape (the table's row) and the Jamba step's
    timed_device = ((4, 1024, 2560), (2, 1024, 4096))
    for dt, shape in ((torch.bfloat16, (4, 1024, 2560)),
                      (torch.bfloat16, (2, 1024, 4096)),
                      (torch.float32, (4, 1024, 2560)),
                      (torch.float32, (3, 7, 2561)),
                      (torch.bfloat16, (5, 1000))):
        x = torch.randn(shape, generator=g, device="cuda").to(dt)
        r = torch.randn(shape, generator=g, device="cuda").to(dt)
        w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g,
                                     device="cuda")).to(dt)
        d = shape[-1]
        rows = x.numel() // d
        for name in ("rmsnorm", "residual_rmsnorm"):
            if name == "rmsnorm":
                kern = lambda: rn.rmsnorm(x, w)
                plain = lambda: rn.rmsnorm_plain(x, w)
                nbytes = (2 * rows * d + d) * x.element_size()
                lib = getattr(torch.nn.functional, "rms_norm", None)
                lib_fn = (lambda: lib(x, (d,), w, 1e-6)) if lib else None
            else:
                kern = lambda: rrn.residual_rmsnorm(x, r, w)
                plain = lambda: rrn.residual_rmsnorm_plain(x, r, w)
                nbytes = (4 * rows * d + d) * x.element_size()
                lib_fn = None
            ko, po = kern(), plain()
            ko = ko if isinstance(ko, tuple) else (ko,)
            po = po if isinstance(po, tuple) else (po,)
            torch.cuda.synchronize()
            err = 0.0
            for a, b in zip(ko, po):
                a, b = a.float(), b.float()
                diff = (a - b).abs()
                err = max(err, diff.max().item())
                if dt == torch.float32:
                    ok = torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                    tol = "rtol=atol=1e-5"
                else:
                    ulp = torch.maximum(bf16_ulp(torch, a),
                                        bf16_ulp(torch, b))
                    ok = bool((diff <= ulp).all())
                    tol = "1 bf16 ulp"
                if not ok:
                    fail(f"{name} {dt} {shape}: max |err| {err} beyond {tol}")
            ms = timer(kern)
            plain_ms = timer(plain)
            lib_ms = timer(lib_fn) if lib_fn is not None else None
            bms, by = bound(nbytes, 4 * rows * d, str(dt).split(".")[1])
            extra = {}
            if dt == torch.bfloat16 and shape in timed_device:
                # device time with the L2 flushed before each call: the
                # event times include the wrapper's host path
                extra["device_ms"] = device_ms(torch, kern, reps=20,
                                               flush=timer.flush)
                if lib_fn is not None:
                    extra["library_device_ms"] = device_ms(
                        torch, lib_fn, reps=20, flush=timer.flush)
            rec = dict(kernel=name, case=f"{str(dt)[6:]} {list(shape)}",
                       shape=list(shape), max_abs_err=err, tolerance=tol,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bms, bound_by=by, **extra)
            say(rec)
            if dt == torch.bfloat16 and shape == (4, 1024, 2560):
                main[name] = rec
    return main


def unmasked_pairs(lq: int, lk: int, causal: bool, window) -> int:
    total = 0
    for i in range(lq):
        qpos = lk - lq + i
        hi = min(lk - 1, qpos) if causal else lk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def check_flash(torch, timer, fa):
    g = torch.Generator(device="cuda").manual_seed(3)
    F = torch.nn.functional
    cases = [
        # (label, b, lq, lk, hq, hkv, d, causal, window, dtype, main)
        ("main: train step", 4, 1024, 1024, 32, 8, 80, True, 4096,
         torch.bfloat16, True),
        ("window at its real size", 1, 8192, 8192, 32, 8, 80, True, 4096,
         torch.bfloat16, False),
        ("f32 train shape", 4, 1024, 1024, 32, 8, 80, True, 4096,
         torch.float32, False),
        ("lq<lk ragged", 2, 1000, 1500, 32, 8, 80, True, 256,
         torch.bfloat16, False),
        ("lq<lk ragged f32", 2, 1000, 1500, 32, 8, 80, True, 256,
         torch.float32, False),
        ("non-causal d=64", 2, 200, 333, 8, 2, 64, False, None,
         torch.float32, False),
        ("window d=128 MQA", 1, 300, 300, 4, 1, 128, True, 64,
         torch.bfloat16, False),
        ("d=8 pads the contraction", 2, 300, 300, 4, 1, 8, True, None,
         torch.bfloat16, False),
        ("non-causal d=128", 2, 200, 333, 8, 2, 128, False, None,
         torch.bfloat16, False),
        ("hybrid path: jamba attention", 2, 1024, 1024, 32, 8, 128, True,
         None, torch.bfloat16, False),
    ]
    main = None
    for (label, b, lq, lk, hq, hkv, d, causal, window, dt,
         is_main) in cases:
        q = torch.randn((b, lq, hq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, lk, hkv, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, lk, hkv, d), generator=g, device="cuda").to(dt)
        kern = lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, window=window)
        if lq * lk * hq > (1 << 31):
            # The plain version's (b, h, lq, lk) f32 scores would take
            # tens of GB: run it over query chunks of 1024.  Causal
            # masking hides every key past the chunk's last query, so the
            # chunk sees k[:, :lk - lq + i1] with its end-aligned
            # positions intact.
            if not causal:
                fail(f"flash_attention_fwd {label}: no chunked plain "
                     "version for a non-causal case this long")

            def plain():
                outs = []
                for i0 in range(0, lq, 1024):
                    i1 = min(lq, i0 + 1024)
                    kk = lk - lq + i1
                    outs.append(fa.flash_attention_plain(
                        q[:, i0:i1], k[:, :kk], v[:, :kk], causal=True,
                        window=window))
                return torch.cat(outs, dim=1)
        else:
            plain = lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window)
        ko, po = kern(), plain()
        torch.cuda.synchronize()
        err = (ko.float() - po.float()).abs().max().item()
        tol = 2e-5 if dt == torch.float32 else 2e-2
        if not (err <= tol) or not torch.isfinite(ko).all():
            fail(f"flash_attention_fwd {label}: max |err| {err} > {tol}")
        ms = timer(kern)
        plain_ms = timer(plain)
        lib_ms = None
        extra = {}
        if is_main or label == "f32 train shape":
            # causal with window >= lk: exactly is_causal
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_ms = timer(sdpa)
            # the event times above include the host's launch path when
            # it outlasts the L2 flush; the profiler's device times do not
            extra = {"device_ms": device_ms(torch, kern),
                     "library_device_ms": device_ms(torch, sdpa)}
        pairs = unmasked_pairs(lq, lk, causal, window)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bms, by = bound(nbytes, 4 * b * hq * pairs * d,
                        str(dt).split(".")[1])
        rec = dict(kernel="flash_attention_fwd", case=label,
                   shape=[[b, lq, hq, d], [b, lk, hkv, d]], causal=causal,
                   window=window, max_abs_err=err, tolerance=f"atol={tol}",
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, **extra)
        say(rec)
        if is_main:
            main = rec
        del q, k, v, ko, po
    return main


def check_ssm_scan(torch, timer, ss, instr_per_state_step=None):
    """The selective scan against its sequential plain version: the
    hybrid path's shape (2, 1024, 8192, ds 16) in f32 with h0 = 0, then
    bf16 u, a ragged di, ds 8, and l not a multiple of the chunk (nor of
    the kernel's 16-step run) with a non-zero h0.

    Tolerance: expf against torch's exp and the order of the C . h sum
    differ by ulps, damped by exp(delta A) < 1: y and h_last within
    1e-5 of the largest f32 output; y stored in bf16 within that plus
    one bf16 ulp (the store rounds values that differ by f32 ulps).
    """
    g = torch.Generator(device="cuda").manual_seed(6)
    F = torch.nn.functional
    cases = [  # (label, b, l, di, ds, u dtype, h0 non-zero, chunk, main)
        ("main: hybrid path", 2, 1024, 8192, 16, torch.float32, False, 128,
         True),
        ("bf16 u", 2, 1024, 8192, 16, torch.bfloat16, False, 128, False),
        ("ragged di 1000", 2, 1024, 1000, 16, torch.float32, False, 128,
         False),
        ("ds 8", 2, 1024, 4096, 8, torch.float32, False, 128, False),
        ("l 1000, chunk 128, h0 != 0", 3, 1000, 3000, 16, torch.float32,
         True, 128, False),
    ]
    main = None
    for label, b, l, di, ds, udt, h0nz, chunk, is_main in cases:
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        u = rnd(b, l, di).to(udt)
        delta = F.softplus(rnd(b, l, di) - 1.0)
        a = -torch.exp(0.5 * rnd(di, ds))
        bmat, cmat = rnd(b, l, ds), rnd(b, l, ds)
        h0 = rnd(b, di, ds) if h0nz else torch.zeros((b, di, ds),
                                                     device="cuda")
        args = (u, delta, a, bmat, cmat, h0)
        kern = lambda: ss.ssm_scan(*args, chunk=chunk)
        plain = lambda: ss.ssm_scan_plain(*args)
        (y, h), (yr, hr) = kern(), plain()
        torch.cuda.synchronize()
        if y.dtype != udt or h.dtype != torch.float32:
            fail(f"ssm_scan {label}: outputs {y.dtype}, {h.dtype}")
        err_y = (y.float() - yr.float()).abs()
        err_h = (h - hr).abs()
        err = max(err_y.max().item(), err_h.max().item())
        ok = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
        ok &= err_h.max().item() <= 1e-5 * max(1.0, hr.abs().max().item())
        tol_y = 1e-5 * max(1.0, yr.float().abs().max().item())
        if udt == torch.float32:
            tol = "1e-5 of max |plain|"
            ok &= err_y.max().item() <= tol_y
        else:
            tol = "y: 1e-5 of max |plain| + 1 bf16 ulp; h_last: 1e-5 of max"
            ulp = torch.maximum(bf16_ulp(torch, y.float()),
                                bf16_ulp(torch, yr.float()))
            ok &= bool((err_y <= ulp + tol_y).all())
        if not ok:
            fail(f"ssm_scan {label}: max |err| {err} beyond {tol}")
        n = b * l * di * ds
        # u read and y written in u's dtype; delta read; B, C, A, h0
        # read and h_last written in f32
        nbytes = (u.numel() * 2 * u.element_size()
                  + delta.numel() * delta.element_size()
                  + 4 * (bmat.numel() + cmat.numel() + a.numel()
                         + 2 * h0.numel()))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # per (b, t, d, s): one exp on the SFUs; dt*A, dt*B, *u, dA*h, +,
        # h*C, + in f32: 7 operations
        t_ops = max(n / SFU_EXP_PER_S, 7 * n / PEAK_FLOPS["float32"]) * 1e3
        extra = {}
        if is_main:
            # flushed device time (the event time holds the wrapper's
            # host path), and the issue-slot time of the kernel's run
            # loop as compiled (the sass phase's instructions per
            # exponential, one exponential a (b, t, d, s)) at 132 SMs x
            # 128 lanes x 1.98 GHz
            extra = {"device_ms": device_ms(torch, kern, reps=10,
                                            flush=timer.flush),
                     "instructions_per_state_step": instr_per_state_step,
                     "issue_slot_ms": instr_per_state_step * n
                     / LANE_ISSUE_PER_S * 1e3
                     if instr_per_state_step else "not measured"}
        rec = dict(kernel="ssm_scan", case=label, shape=[b, l, di, ds],
                   u_dtype=str(udt)[6:], chunk=chunk, max_abs_err=err,
                   tolerance=tol, ms=timer(kern), plain_ms=timer(plain),
                   library_ms=None,   # no one PyTorch call scans
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_bytes_ms=t_bytes, bound_ops_ms=t_ops, **extra)
        say(rec)
        if is_main:
            main = rec
        del u, delta, a, bmat, cmat, h0, y, h, yr, hr, args
    return main


# ----------------------------------------------------------------- runs
def main_path_spec(api, *, full: bool, workers: int, sync: str,
                   kernels: str = "auto", straggler: float = 2.0):
    return api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b", smoke=not full,
                            kernels=kernels),
        data=api.DataSpec(seq_len=1024 if full else 64, global_batch=4),
        optimizer=api.OptimizerSpec(lr=3e-3, momentum=0.9),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=api.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=straggler),
        wire=api.WireSpec(format="packed", delta_pull=True))


def hybrid_spec(api, *, smoke: bool, workers: int, sync: str,
                kernels: str = "auto", straggler: float = 2.0):
    """jamba-v0.1-52b through the main path's server and wire: seq 1024
    and 2 sequences per worker step at full width (seq 64 at smoke
    size)."""
    return api.RunSpec(
        model=api.ModelSpec(arch="jamba-v0.1-52b", smoke=smoke,
                            kernels=kernels),
        data=api.DataSpec(seq_len=64 if smoke else 1024, global_batch=2),
        optimizer=api.OptimizerSpec(lr=3e-3, momentum=0.9),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=api.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=straggler),
        wire=api.WireSpec(format="packed", delta_pull=True))


def hybrid_config():
    """jamba-v0.1-52b at its published widths, cut to one period group
    (8 layers: 7 Mamba slots, attention at offset 3) with every FFN the
    dense SwiGLU (no experts): 2,725,326,848 parameters."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8,
                               moe=None)


def check_parity(torch, api, label: str, spec_of, tol: float = 1e-4):
    """A smoke config on the card, 1 worker, 4 BSP steps: kernels vs
    plain formulations.  ``spec_of(kernels)`` gives the run's spec."""
    runs = {}
    for kernels in ("auto", "xla"):
        with api.build_session(spec_of(kernels)) as s:
            s.run(4)
            runs[kernels] = [l for _, _, l in s.server.metrics.loss_trajectory]
    diff = max(abs(a - b) for a, b in zip(runs["auto"], runs["xla"]))
    say({"phase": "parity", "run": label, "losses_kernels": runs["auto"],
         "losses_plain": runs["xla"], "max_abs_diff": diff, "tol": tol})
    if len(runs["auto"]) != 4 or not diff <= tol:
        fail(f"parity ({label}): kernel and plain losses differ by {diff}")


def run_train(torch, api, label: str, spec, per_step, **overrides):
    """8 DSSP steps of ``spec`` (2 workers, the second slower) through
    ``build_session``; losses finite, staleness within s_upper, DSSP
    extensions == credit releases, every kernel's launches exactly what
    the run implies (``per_step``: launches per worker step; the
    server's ``fused_update`` once per shard version), peak below the
    card's 80 GB.  Returns the launches."""
    from repro_torch.obs.trace import TRACE
    from repro_torch.perfcount import LAUNCHES
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    session = api.build_session(spec, **overrides)
    session.start()
    TRACE.enable(source="server")
    LAUNCHES.reset()
    t0 = time.monotonic()
    m = session.run(8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    events = TRACE.drain()
    TRACE.disable()
    server = session.server
    workers = session.workers
    session.close()

    losses = [l for _, _, l in server.metrics.loss_trajectory]
    passes = sum(w.iterations_done for w in workers)
    if passes != 8 or len(losses) != 8 or not all(map(math.isfinite, losses)):
        fail(f"{label}: {passes} steps, losses {losses}")
    if m["max_staleness"] > spec.sync.s_upper:
        fail(f"{label}: staleness {m['max_staleness']} > s_upper")
    ext = {(e["worker"], e["clock"]) for e in events
           if e["name"] == "dssp_decision"
           and e["args"]["reason"] in ("grant", "credit_spend")}
    if len(ext) != m["credit_releases"]:
        fail(f"{label}: {len(ext)} DSSP extensions != "
             f"{m['credit_releases']} credit releases")
    rows = server.plan.wire_layout().shard_rows
    # no coalescing and no compression on this path
    expected = {name: per_step.get(name, 0) * passes for name in launches}
    expected["fused_update"] = sum(st.version for st, r in
                                   zip(server.shards, rows) if r)
    if launches != expected:
        fail(f"{label}: launches {launches} != expected {expected}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not peak_gb < 80.0:
        fail(f"{label}: peak memory {peak_gb} GB")
    steps = [c for w in workers for c in w.compute_s]
    warm = [c for w in workers for c in w.compute_s[1:]]
    rec = {"phase": label, "steps": passes, "losses": losses,
           "pushes": m["pushes"], "wall_s": wall,
           "pushes_per_s": m["pushes"] / wall,
           "mean_step_s": statistics.mean(steps),
           "mean_step_s_after_first": statistics.mean(warm) if warm else None,
           "max_staleness": m["max_staleness"],
           "credit_releases": m["credit_releases"],
           "dssp_extensions": len(ext), "launches": launches,
           "max_memory_allocated_gb": peak_gb}
    say(rec)
    return launches


#: The server phase's linger: long enough for the two workers' pushes to
#: meet in one window even when their first (warm-up) steps end seconds
#: apart; a worker that finishes leaves the group, which ends a linger.
COALESCE_WAIT_MS = 5000.0


def server_spec(api, *, full: bool, sync: str, compression: str,
                coalesce: int = 2, kind: str = "sharded",
                wire: str = "packed"):
    """The server layer's configuration: h2o-danube-1.8b, 2 workers of
    equal speed, S=4 (sharded), coalescing with a linger long enough for
    both workers' pushes to meet."""
    sharded = kind == "sharded"
    return api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b", smoke=not full),
        data=api.DataSpec(seq_len=1024 if full else 64, global_batch=4),
        optimizer=api.OptimizerSpec(lr=3e-3, momentum=0.9),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=api.ServerSpec(
            kind=kind, shards=4 if sharded else 1, workers=2,
            apply=("fused" if sharded else "packed") if wire == "packed"
            else "tree",
            gating="sharded" if wire == "packed" else "global",
            straggler=1.0, coalesce=coalesce,
            coalesce_wait_ms=COALESCE_WAIT_MS if coalesce > 1 else None),
        wire=api.WireSpec(format=wire, compression=compression,
                          topk_fraction=0.05, delta_pull=wire == "packed"))



def run_server(torch, api, label: str, sync: str, compression: str):
    """One full-width run of the server layer; returns its launches."""
    from repro_torch.obs.trace import TRACE
    from repro_torch.perfcount import LAUNCHES
    spec = server_spec(api, full=True, sync=sync, compression=compression)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    session = api.build_session(spec)
    session.start()
    TRACE.enable(source="server")
    LAUNCHES.reset()
    t0 = time.monotonic()
    m = session.run(8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    events = TRACE.drain()
    TRACE.disable()
    server, workers = session.server, session.workers
    session.close()

    tag = f"server ({label})"
    losses = [l for _, _, l in server.metrics.loss_trajectory]
    passes = sum(w.iterations_done for w in workers)
    if passes != 8 or len(losses) != 8 or not all(map(math.isfinite, losses)):
        fail(f"{tag}: {passes} steps, losses {losses}")
    if m["max_staleness"] > spec.sync.s_upper:
        fail(f"{tag}: staleness {m['max_staleness']} > s_upper")
    ext = {(e["worker"], e["clock"]) for e in events
           if e["name"] == "dssp_decision"
           and e["args"]["reason"] in ("grant", "credit_spend")}
    if sync == "dssp" and len(ext) != m["credit_releases"]:
        fail(f"{tag}: {len(ext)} DSSP extensions != "
             f"{m['credit_releases']} credit releases")
    rows = server.plan.wire_layout().shard_rows
    flushes = [(e["shard"], e["args"]["n"]) for e in events
               if e["name"] == "coalesce_flush"]
    live = [j for j, r in enumerate(rows) if r]
    for j in live:
        got = sum(n for s, n in flushes if s == j)
        if got != server.shards[j].version:
            fail(f"{tag}: shard {j} flushed {got} contributions, version "
                 f"{server.shards[j].version}")
    sizes = [n for _, n in flushes]
    if launches["fused_update_batched"] != sum(1 for n in sizes if n > 1):
        fail(f"{tag}: {launches['fused_update_batched']} batched launches "
             f"for flush sizes {sizes}")
    if launches["fused_update"] != sum(1 for n in sizes if n == 1):
        fail(f"{tag}: {launches['fused_update']} single launches for "
             f"flush sizes {sizes}")
    if 2 not in sizes or (sync == "bsp" and set(sizes) != {2}):
        fail(f"{tag}: flush sizes {sizes}")
    comp = f"fused_{compression}_ef"
    if launches[comp] != m["pushes"] * len(live):
        fail(f"{tag}: {launches[comp]} {comp} launches for {m['pushes']} "
             f"pushes x {len(live)} shards")
    steps = [c for w in workers for c in w.compute_s]
    warm = [c for w in workers for c in w.compute_s[1:]]
    rec = {"phase": "server", "run": label, "steps": passes,
           "losses": losses, "pushes": m["pushes"], "wall_s": wall,
           "flush_sizes": sizes, "launches": launches,
           "max_staleness": m["max_staleness"],
           "credit_releases": m["credit_releases"],
           "dssp_extensions": len(ext),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    say(rec)
    say(f"server ({label}): pushes/s {m['pushes'] / wall}")
    say(f"server ({label}): mean step s {statistics.mean(steps)} "
        f"(after each worker's first: "
        f"{statistics.mean(warm) if warm else None})")
    say(f"server ({label}): wait share {m['wait_fraction']}")
    say(f"server ({label}): peak memory GB "
        f"{torch.cuda.max_memory_allocated() / 1e9}")
    return launches


def run_paths(torch, api):
    """The mono packed server (coalesced) and the tree wire (sharded,
    global gate, tree apply) at smoke size: one short BSP run each."""
    for label, spec in (
            ("mono packed, coalesce 2",
             server_spec(api, full=False, sync="bsp", compression="none",
                         kind="mono")),
            ("tree wire, global gate",
             server_spec(api, full=False, sync="bsp", compression="none",
                         coalesce=1, wire="tree"))):
        with api.build_session(spec) as s:
            m = s.run(4)
            losses = [l for _, _, l in s.server.metrics.loss_trajectory]
        if len(losses) != 4 or not all(map(math.isfinite, losses)):
            fail(f"paths ({label}): losses {losses}")
        say({"phase": "paths", "run": label, "losses": losses,
             "pushes": m["pushes"], "applied_updates": m["applied_updates"],
             "max_staleness": m["max_staleness"]})


#: the port's own kernels, by function name (exactly; the fused norm's
#: one kernel was named residual_rmsnorm_kernel before its register
#: path, which ``--src`` runs of earlier commits still launch)
KERNEL_NAMES = (("ssm_scan kernel", ("ssm_scan_kernel",)),
                ("rmsnorm kernel", ("rmsnorm_kernel",)),
                ("residual_rmsnorm kernel", ("residual_rmsnorm_regs",
                                             "residual_rmsnorm_loop",
                                             "residual_rmsnorm_kernel")))
#: everything else, by a part of the name
KERNEL_GROUPS = (("attention kernel (flash_fwd)", ("flash_fwd",)),
                 ("fused_update kernel", ("fused_update",)),
                 ("f32 matmul (unembed, plain attention backward)",
                  ("f32f32", "sgemm")),
                 ("bf16 matmul", ("gemm", "nvjet", "sm90_", "cutlass",
                                  "xmma")),
                 ("softmax (plain attention backward)", ("softmax",)))
PLAIN_SCAN_BACKWARD = ("plain ssm_scan backward (recompute and autograd "
                       "through ssm_scan_ref)")


def kernel_function(name: str) -> str:
    """``void ns::f<T, 4>(float const*, ...)`` -> ``f``."""
    name = name.split("(", 1)[0].split("<", 1)[0].strip()
    return name.split()[-1].split("::")[-1] if name else name


def kernel_group(name: str) -> str:
    fn = kernel_function(name)
    for group, names in KERNEL_NAMES:
        if fn in names:
            return group
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, reductions, copies)"


def _range_kernels(event, out) -> None:
    """Device kernels launched inside a CPU range, by name (ms summed)."""
    for k in event.kernels:
        out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
    for child in event.cpu_children:
        _range_kernels(child, out)


def timed_steps(torch, api, spec, steps: int, **overrides) -> float:
    """Wall ms per step of ``steps`` steps of a fresh session."""
    free_device_memory(torch)
    with api.build_session(spec, **overrides) as session:
        session.start()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        session.run(steps)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / steps


def profile_step(torch, api, label: str, spec, **overrides):
    """Where a training step's time goes: a fresh one-worker session
    (the process is warm from the phase before), two steps under
    ``torch.profiler``; device time per kernel group and name, and the
    device's idle share of the wall time of two untraced steps of
    another fresh session (tracing every CPU op of the worker threads
    slows the host), and of the traced steps.  Kernels launched inside
    the scan's backward range (``registry.SSM_SCAN_BACKWARD``) form a
    group of their own."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    from repro_torch.kernels.registry import SSM_SCAN_BACKWARD
    steps = 2
    untraced_ms = timed_steps(torch, api, spec, steps, **overrides)
    free_device_memory(torch)
    # the steps run in the session's worker threads: record their CPU
    # ops too, so kernels can be traced to the range that launched them
    threads = _ExperimentalConfig(profile_all_threads=True)
    with api.build_session(spec, **overrides) as session:
        session.start()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=threads) as prof:
            t0 = time.monotonic()
            session.run(steps)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / steps
    by_name, scan_bwd = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name == SSM_SCAN_BACKWARD:
                _range_kernels(e, scan_bwd)
            continue
        if e.is_user_annotation:   # a range's device span, not a kernel
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3 / steps, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:   # the tracer saw no kernels: a measurement, not a fault
        say({"phase": "profile", "run": label, "step_wall_ms": untraced_ms,
             "traced_step_wall_ms": wall_ms,
             "device_busy_ms": "not measured"})
        return
    groups = {}
    for name, (ms, _) in by_name.items():
        ms -= scan_bwd.get(name, 0.0) / steps
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    if scan_bwd:
        groups[PLAIN_SCAN_BACKWARD] = sum(scan_bwd.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    say({"phase": "profile", "run": label, "steps": steps,
         "step_wall_ms": untraced_ms, "traced_step_wall_ms": wall_ms,
         "device_busy_ms": busy, "idle_share": 1.0 - busy / untraced_ms,
         "traced_idle_share": 1.0 - busy / wall_ms,
         "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         "top_kernels": [{"name": k[:90], "ms": ms, "calls": n // steps}
                         for k, (ms, n) in top]})


#: kernel checks that ``--only`` can name
CHECKS = ("fused_update", "norms", "flash", "fused_update_batched",
          "fused_compress", "ssm_scan")


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated kernel checks to run, of "
                    f"{', '.join(CHECKS)}; then only the device, build "
                    "and those checks run, and no contract line is printed")
    ap.add_argument("--src", default="src",
                    help="directory (relative to this script) holding the "
                    "repro_torch package to run, e.g. an unpacked earlier "
                    "commit's src/ to time its kernels beside these")
    args = ap.parse_args(argv)
    if args.only is not None:
        args.only = [c for c in args.only.split(",") if c]
        unknown = set(args.only) - set(CHECKS)
        if unknown:
            ap.error(f"unknown checks {sorted(unknown)}; choose from {CHECKS}")
    return args


def main(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    # -- device ----------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.join(ROOT, args.src))
    from repro_torch import api
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_compress as fc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import residual_rmsnorm as rrn
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import registry
    from repro_torch.ps.sharded.plan import build_shard_plan

    # -- build -----------------------------------------------------------
    t0 = time.monotonic()
    cuda.library()
    say({"phase": "build", "seconds": time.monotonic() - t0,
         "library": os.path.relpath(cuda.library_path(), ROOT)})
    for line in cuda.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            say(line.strip())
    # the scan's main instantiation (f32 u and delta, ds 16, 16-byte
    # loads): its run loop's instructions per exponential are the issue
    # slots one (b, t, d, s) takes
    sass = sass_counts(str(cuda.library_path()),
                       "ssm_scan_kernelIffLi16ELb1E")
    scan_instr = None
    if sass is not None:
        if sass.get("loop_ex2"):
            scan_instr = sass["loop_instructions"] / sass["loop_ex2"]
        say({"phase": "sass", "loop_instructions_per_ex2": scan_instr,
             **sass})

    # -- kernels ---------------------------------------------------------
    timer = Timer(torch)
    cfg = get_config("h2o-danube-1.8b")
    # the main path's shard-0 region, planned from shapes alone
    shapes = tree_util.tree_map(
        lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"),
        registry.param_defs(cfg))
    main_rows = build_shard_plan(shapes, 4).wire_layout().shard_rows[0]
    checks = {
        "fused_update": lambda: {"fused_update": check_fused_update(
            torch, timer, fu, main_rows)},
        "norms": lambda: check_norms(torch, timer, rn, rrn),
        "flash": lambda: {"flash_attention_fwd": check_flash(
            torch, timer, fa)},
        "fused_update_batched": lambda: {
            "fused_update_batched": check_fused_update_batched(
                torch, timer, fu, main_rows)},
        "fused_compress": lambda: check_fused_compress(
            torch, timer, fc, main_rows),
        "ssm_scan": lambda: {"ssm_scan": check_ssm_scan(
            torch, timer, ss, scan_instr)},
    }
    table = {}
    for name in CHECKS:
        if args.only is None or name in args.only:
            table.update(checks[name]())
    del timer
    free_device_memory(torch)
    if args.only is not None:
        say({"kernels_only": args.only, "src": args.src,
             "device": torch.cuda.get_device_name(0)})
        return

    # -- parity, train, profile, server, paths ---------------------------
    n_layers = 24
    check_parity(torch, api, "h2o-danube smoke", lambda kernels:
                 main_path_spec(api, full=False, workers=1, sync="bsp",
                                kernels=kernels, straggler=1.0))
    # remat recomputes every layer's forward in the backward pass
    launches = run_train(
        torch, api, "train",
        main_path_spec(api, full=True, workers=2, sync="dssp"),
        {"flash_attention_fwd": n_layers * 2,
         "residual_rmsnorm": n_layers * 2,
         "rmsnorm": n_layers * 2 + 1})                # + the final norm
    # straggler 1.0: the one worker is also the last, which the spec
    # would otherwise slow down by sleeping
    profile_step(torch, api, "train",
                 main_path_spec(api, full=True, workers=1, sync="bsp",
                                straggler=1.0))
    server_a = run_server(torch, api, "a: dssp, coalesce 2, int8", "dssp",
                          "int8")
    server_b = run_server(torch, api, "b: bsp, coalesce 2, topk 0.05", "bsp",
                          "topk")
    launches["fused_update_batched"] = (server_a["fused_update_batched"]
                                        + server_b["fused_update_batched"])
    launches["fused_int8_ef"] = server_a["fused_int8_ef"]
    launches["fused_topk_ef"] = server_b["fused_topk_ef"]
    run_paths(torch, api)

    # -- jamba parity, hybrid, hybrid profile ----------------------------
    check_parity(torch, api, "jamba smoke (MoE)", lambda kernels:
                 hybrid_spec(api, smoke=True, workers=1, sync="bsp",
                             kernels=kernels, straggler=1.0))
    cut = hybrid_config()
    groups = cut.n_layers // cut.attn_period
    mamba_slots = groups * (cut.attn_period - 1)
    hybrid = run_train(
        torch, api, "hybrid",
        hybrid_spec(api, smoke=False, workers=2, sync="dssp"),
        {"ssm_scan": mamba_slots * 2, "flash_attention_fwd": groups * 2,
         "residual_rmsnorm": cut.n_layers * 2,
         "rmsnorm": cut.n_layers * 2 + 1},
        model_config=cut)
    launches["ssm_scan"] = hybrid["ssm_scan"]
    profile_step(torch, api, "hybrid",
                 hybrid_spec(api, smoke=False, workers=1, sync="bsp",
                             straggler=1.0), model_config=cut)

    replaces = {
        "fused_update": "src/repro/kernels/fused_update.py:37",
        "fused_update_batched": "src/repro/kernels/fused_update.py:124",
        "fused_int8_ef": "src/repro/kernels/fused_compress.py:64",
        "fused_topk_ef": "src/repro/kernels/fused_compress.py:101",
        "rmsnorm": "src/repro/kernels/rmsnorm.py:20",
        "residual_rmsnorm": "src/repro/kernels/residual_rmsnorm.py:28",
        "flash_attention_fwd": "src/repro/kernels/flash_attention.py:34",
        "ssm_scan": "src/repro/kernels/ssm_scan.py:30",
    }
    sources = {
        "fused_update": "fused_update.cu", "rmsnorm": "rmsnorm.cu",
        "fused_update_batched": "fused_update.cu",
        "fused_int8_ef": "fused_compress.cu",
        "fused_topk_ef": "fused_compress.cu",
        "residual_rmsnorm": "residual_rmsnorm.cu",
        "flash_attention_fwd": "flash_attention_sm90.cu",   # bf16
        "ssm_scan": "ssm_scan.cu",
    }
    unlaunched = [name for name in table if launches[name] <= 0]
    if unlaunched:
        fail(f"kernels never launched on their path: {unlaunched}")
    kernels = []
    for name, rec in table.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    say(card)
    say({"kernels": kernels})
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
