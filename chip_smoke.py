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
           and spills (a spill in the bf16 attention kernel fails), and
           (cuobjdump) the scan kernel's run loop: its instructions per
           exponential, one per (b, t, d, s)
  kernels  each kernel against its plain PyTorch version on the card, at
           the main path's shapes and a few others (ragged sizes, f32 and
           bf16; serving's prefill attention and norm shapes; the
           transformer families' train step: attention at head dim 128
           with 64/8, 40/40, 96/8, 64/4 and 16/16 heads, the q/k norms'
           rows of 128 and both norms at widths 2048-12288; ``rmsnorm``
           at xlstm-125m's width 768), with its tolerance, serving's
           ``quantize_kv`` bitwise against the CPU, and the sLSTM time
           loop at xlstm-125m's shape captured as CUDA graphs, forward
           and backward bit for bit the eager loop (times, kernels a
           replay, pool bytes); median CUDA-event times of the
           kernel, the plain version and one library call where PyTorch
           has one, and the least time the card could take (bound); for
           attention's bf16 and f32 train shapes, the norms' dense and
           Jamba shapes and the scan's main case also device times by
           the profiler (the L2 flushed for the norms and the scan);
           bf16 attention is held to one bf16 ulp per element (values
           below 2^-8 counted at its ulp), with the share of elements
           that differ from the plain version printed at each shape; the
           families' shapes also by device time, beside SDPA's and
           ``F.rms_norm``'s
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
           14 ``ssm_scan`` launches per worker step; the scan's backward
           replays one CUDA graph a call (its pool's bytes printed), and
           at the hybrid shape a graph of its own is held bit for bit
           against the eager backward
  hybrid profile
           one one-worker step of that configuration under
           torch.profiler (the trace of its ≈ 180 k kernels takes
           minutes to read back), with the ``ssm_scan`` kernel and the
           scan's plain backward (the graph's kernels, attributed to its
           profiler range) as groups of their own
  transport
           spawned worker processes on the card over the frame protocol
           (``ps-transport``): h2o-danube-1.8b at its published widths
           cut to 13 of 24 layers, the deepest whose packed pull fits one
           2 GiB frame, 8 DSSP steps of 2 worker processes (the second 2x
           slower) over tcp on 127.0.0.1, 4 shards, delta pulls; the
           train phase's checks, with 4 fused_update launches a push in
           this process and each worker process's norm and attention
           launches exactly what its steps imply, and every push applied
           on every shard in frames of the plan's size; wall time,
           pushes/s, compute and wire share, frame bytes per push and
           pull, each process's peak memory and the card's memory.used.
           Then at smoke size: shmem with 2 workers, tcp with int8
           frames, and an inproc endpoint driven by one client of this
           process
  ft       the transport configuration served by a restartable
           ``ServerProcess`` on ``cuda:0`` (``repro_torch.ft``), traced:
           snapshots every 20 s (keep 2, under build/ft/, which git
           ignores, after a check of the free disk), a live reshard 4 -> 6 at push round
           4, and a SIGKILL by the server's own watchdog at round 10;
           the restart restores the 6-shard snapshot into a server the
           spec builds with 4 shards and both workers reconnect and
           finish.  Checked: finite losses continuing the restored
           trajectory, every shard version accounted for, no release
           past s_upper, DSSP extensions == credit releases (exactly in
           the restarted incarnation), parked == replayed, each worker's
           launches per computed step, and the merged trace (both
           incarnations' spills, the workers' spills and MSG_TRACE
           frames): a compute_step per computed step, snapshot_shard
           spans for every shard of every snapshot, a reshard_shard span
           per old shard, failover and reconnect spans, read back from
           its Chrome export by ``summarize``.  Printed: wall time,
           pushes/s, the restart's time to serve, the largest pauses
           beside the reference's 0.5 s bound, snapshot bytes and write
           seconds, each incarnation's peak memory, memory.used.  Then at
           smoke size: a worker killed while gated over shmem and
           respawned, push frames dropped over tcp with reconnects, and
           a server killed inside its reshard that resumes untorn
  serve parity
           the h2o-danube, Jamba (MoE on), deepseek-moe (shared experts),
           chameleon (q/k norms), qwen1.5-32b (QKV bias, int8 KV
           cache) and xlstm-125m (recurrent) smoke configs (f32) decoded
           on the card from one packed wire by ``repro_torch.serve.Decoder``, with the kernels
           and with the plain formulations: logits along the plain
           decoder's greedy tokens within 2e-4 (the int8 cache: within
           how far it moves the plain logits from an f32 cache's, and
           the f32 cache within 2e-4); and the dense ring cache (window 16)
           decoded 40 positions, against the full forward at each
  serve    the train configuration (full width, 2 trainer threads, the
           second 2x slower) for 24 steps while 2 replica threads serve
           16 requests each (prompts of 512, 32 new tokens, batches of
           8, admitted within 4 applied updates once the server has
           applied one): ``run_train``'s checks (arrival staleness up
           to s_upper + 1 in a run this long, no release past s_upper),
           every request served with no violation and a version above 0,
           and the launches of every decode batch, warm-ups included:
           24 ``flash_attention_fwd``, 24 ``residual_rmsnorm`` and 25 +
           49 x 31 ``rmsnorm``; requests/s, latency, each replica's
           refreshes and bytes, peaks; then one batch with the card to
           itself: its wall time, the prefill's and a token's time, and
           the device's idle share (``torch.profiler``)
  serve transport
           the transport configuration (13 layers, 2 worker processes
           over tcp) with 1 spawned replica process refreshing each
           second: the same checks, the replica process's launches
           exactly per batch, its refresh bytes, and pushes/s beside the
           transport phase's; then one xlstm-125m decode batch (8
           prompts of 512, prefilled token by token, 32 new tokens) with
           the card to itself: prefill and token times, its ``rmsnorm``
           launches a token exactly, kernels a token and idle share
  archs    the transformer families, each on its own: qwen1.5-110b,
           qwen1.5-32b, mistral-large-123b, chameleon-34b (vlm),
           qwen3-moe-235b-a22b and deepseek-moe-16b.  Each one's smoke
           config trained twice through ``build_session``, kernels vs
           plain (losses agree); then its published widths cut in depth
           (``ARCH_CUTS``: 1, 3, 2, 3, 1 and 5 layers, 3.13-3.85 B
           parameters), passed as ``model_config``: 4 steps of seq 1024,
           2 sequences a step, 2 DSSP workers (qwen1.5-110b: 1, BSP)
           through 4 shards with delta pulls, checked as the train phase
           is, with per worker step 2L attention and fused-norm launches
           and 2L(1 + 2 qk_norm) + 1 ``rmsnorm``; then one profiled
           one-worker step of deepseek-moe's cut (idle share)
  families xlstm-125m (``ssm``) and whisper-tiny (``audio``) at their
           published configs, uncut (12 layers; 4 + 4): each one's
           smoke parity, then 4 steps of seq 1024, 2 sequences a step,
           2 DSSP workers, checked as the train phase is, with 2L + 1
           ``rmsnorm`` launches a worker step for xLSTM and none for
           Whisper; xLSTM's sLSTM graphs (one backward graph, a forward
           graph a thread, none added by later steps or sessions); then
           one profiled one-worker xLSTM step, the sLSTM replays as
           groups of their own

Each phase boundary prints the script's elapsed seconds.  The last two
lines of standard output are the JSON kernel table and the contract
line ``{"ok": true, "device": {...}}``.  This script imports
nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
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
    summed as ``torch.profiler`` traces them (no host time, no gaps).
    With ``flush`` (a buffer larger than the 50 MB L2), the buffer is
    zeroed before every call, so the call reads from device memory, and
    the zeroing's own kernels (named by tracing one zeroing alone) are
    left out of the sum.  The tracer at times sees no kernel at all in a
    short window (PERF.md §7): a window is traced up to three times, and
    if the tracer still saw no kernel of ``fn`` there is no measurement,
    which fails."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA

    def traced(window, keep, what):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                window()
                torch.cuda.synchronize()
            seen = [e for e in prof.events() if e.device_type == cuda
                    and not e.is_user_annotation and keep(e.name)]
            if seen:
                return seen
        fail(f"device_ms: the profiler saw no kernel of {what} in three "
             "traces")

    skip = set()
    if flush is not None:
        skip = {e.name for e in traced(flush.zero_, lambda name: True,
                                       "the L2 flush")}
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()

    seen = traced(window, lambda name: name not in skip, "the timed call")
    return sum(e.device_time_total for e in seen) / 1e3 / reps


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


def bf16_ulp(torch, ref, floor: float = 2.0 ** -126):
    """One bf16 ulp at each value of ``ref`` (f32 tensor), values below
    ``floor`` counted at ``floor``."""
    mag = ref.abs().clamp(min=floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


#: attention's bf16 outputs below this count at its ulp (2^-15) in the
#: one-ulp check: below it the f32 sums' own error (about 1e-6 on the
#: CPU emulation, 8e-7 with P kept in f32) can exceed a bf16 ulp
FLASH_ULP_FLOOR = 2.0 ** -8


def sass_counts(library: str, function: str):
    """Static instruction counts of one kernel of the built library, by
    ``cuobjdump -sass``: the total, the count of each opcode, and the
    loop (backward branch) holding the most MUFU.EX2, its instructions
    and exponentials.  ``function`` is a part of the mangled name; None
    without cuobjdump."""
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


#: serving's norm shapes at full width: the decode step's (max_batch, 1,
#: d_model) rows (2 n_layers + 1 launches a token) and a prefill batch
#: of max_batch prompts of prompt_len
SERVE_DECODE_ROWS = (8, 1, 2560)
SERVE_PREFILL_ROWS = (8, 512, 2560)
#: the transformer families' train step (2 sequences of 1024): the q/k
#: norms' rows of 128 (64 query heads: qwen1.5-110b, chameleon-34b,
#: qwen3-moe; a lane holds one 16-byte vector and half of each warp
#: idles) and the widths 2048 (deepseek-moe), 5120 (qwen1.5-32b), 8192
#: (qwen1.5-110b, chameleon-34b) and 12288 (mistral-large)
QK_NORM_ROWS = (2, 1024, 64, 128)
ARCH_NORM_ROWS = (QK_NORM_ROWS, (2, 1024, 2048), (2, 1024, 5120),
                  (2, 1024, 8192), (2, 1024, 12288))
#: xlstm-125m's norms at width 768 (``rmsnorm`` only: xLSTM adds its
#: residual plainly): its train step's rows (2 sequences of 1024) and a
#: decode step's (8, 1); a bf16 row is 96 16-byte vectors, one warp with
#: three vectors a lane
XLSTM_NORM_ROWS = ((2, 1024, 768), (8, 1, 768))


def check_norms(torch, timer, rn, rrn):
    g = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    #: the dense step's shape (the table's row), the Jamba step's,
    #: serving's (a decode step's rows and a prefill batch), the
    #: transformer families' (ARCH_NORM_ROWS) and xLSTM's
    timed_device = ((4, 1024, 2560), (2, 1024, 4096), SERVE_DECODE_ROWS,
                    SERVE_PREFILL_ROWS) + ARCH_NORM_ROWS + XLSTM_NORM_ROWS
    for dt, shape in ((torch.bfloat16, (4, 1024, 2560)),
                      (torch.bfloat16, (2, 1024, 4096)),
                      (torch.bfloat16, SERVE_DECODE_ROWS),
                      (torch.bfloat16, SERVE_PREFILL_ROWS),
                      *((torch.bfloat16, rows) for rows in ARCH_NORM_ROWS),
                      *((torch.bfloat16, rows) for rows in XLSTM_NORM_ROWS),
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
            if name == "residual_rmsnorm" and (
                    shape == QK_NORM_ROWS or shape in XLSTM_NORM_ROWS):
                continue    # the q/k norms and xLSTM's have no residual
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
                if name == "rmsnorm" and lib_fn is not None:
                    # the redesign's target: 80% of the byte bound, and no
                    # slower than F.rms_norm, both by flushed device time;
                    # beside them a plain copy of the same bytes
                    dms, lms = rec["device_ms"], rec["library_device_ms"]
                    dst = torch.empty_like(x)
                    cms = device_ms(torch, lambda: dst.copy_(x), reps=20,
                                    flush=timer.flush)
                    say({"rmsnorm_target": {
                        "device_ms": dms, "bound_ms": bms,
                        "share_of_bound": bms / dms,
                        "library_device_ms": lms,
                        "copy_device_ms": cms,
                        "met": dms <= bms / 0.8 and dms <= lms}})
                    del dst
    return main


def check_quantize_kv(torch):
    """Serving's int8 KV quantisation (plain PyTorch, no kernel of its
    own) on the card against the CPU on the same input, at the full
    width's cache shape: codes and scales bit for bit (both divisions
    are tensor by tensor)."""
    from repro_torch.models.layers import quantize_kv
    g = torch.Generator(device="cuda").manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((8, 544, 8, 80), generator=g, device="cuda")
             * 3.0).to(dt)
        q, sc = quantize_kv(x)
        qc, scc = quantize_kv(x.cpu())
        codes = int((q.cpu() != qc).sum())
        scales = int((sc.cpu() != scc).sum())
        say({"kernel": "quantize_kv (plain)", "case": str(dt)[6:],
             "shape": list(x.shape), "codes_differing": codes,
             "scales_differing": scales, "tolerance": "bitwise"})
        if codes or scales:
            fail(f"quantize_kv {dt}: {codes} codes and {scales} scales "
                 "differ from the CPU's")
    return {}


def unmasked_pairs(lq: int, lk: int, causal: bool, window) -> int:
    total = 0
    for i in range(lq):
        qpos = lk - lq + i
        hi = min(lk - 1, qpos) if causal else lk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


#: serving's prefill: 8 prompts of 512 at h2o-danube's heads
SERVE_PREFILL_ATTENTION = "serve prefill"
#: the label prefix of the transformer families' attention shapes
ARCH_ATTENTION = "arch train step: "


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
        (SERVE_PREFILL_ATTENTION, 8, 512, 512, 32, 8, 80, True, 4096,
         torch.bfloat16, False),
        # the transformer families' train step: 2 sequences of 1024,
        # head dim 128, each head layout
        (ARCH_ATTENTION + "qwen1.5-110b, chameleon-34b (64/8)", 2, 1024,
         1024, 64, 8, 128, True, None, torch.bfloat16, False),
        (ARCH_ATTENTION + "qwen1.5-32b (40/40)", 2, 1024, 1024, 40, 40, 128,
         True, None, torch.bfloat16, False),
        (ARCH_ATTENTION + "mistral-large-123b (96/8)", 2, 1024, 1024, 96,
         8, 128, True, None, torch.bfloat16, False),
        (ARCH_ATTENTION + "qwen3-moe-235b-a22b (64/4)", 2, 1024, 1024, 64,
         4, 128, True, None, torch.bfloat16, False),
        (ARCH_ATTENTION + "deepseek-moe-16b (16/16)", 2, 1024, 1024, 16, 16,
         128, True, None, torch.bfloat16, False),
    ]
    main, failures = None, []
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
        a, b_ = ko.float(), po.float()
        diff = (a - b_).abs()
        err = diff.max().item()
        finite = bool(torch.isfinite(ko).all())
        if dt == torch.float32:
            tol = "atol=2e-05"
            ok = finite and err <= 2e-5
            agree = {}
        else:
            # one bf16 ulp of the larger of the two values, each element
            tol = f"1 bf16 ulp (values below {FLASH_ULP_FLOOR} at its ulp)"
            ulp = torch.maximum(bf16_ulp(torch, a, FLASH_ULP_FLOOR),
                                bf16_ulp(torch, b_, FLASH_ULP_FLOOR))
            beyond = int((diff > ulp).sum())
            bare = torch.maximum(bf16_ulp(torch, a), bf16_ulp(torch, b_))
            agree = {"share_differing": (diff > 0).float().mean().item(),
                     "elements_beyond_tolerance": beyond,
                     "elements_beyond_1_ulp_without_floor":
                         int((diff > bare).sum())}
            ok = finite and beyond == 0
            say(f"flash_attention_fwd {label}: share of elements differing "
                f"from the plain version {agree['share_differing']}, "
                f"beyond 1 ulp {beyond} (without the floor "
                f"{agree['elements_beyond_1_ulp_without_floor']}), max "
                f"|err| {err}")
            del ulp, bare
        del a, b_, diff
        if not ok:
            failures.append(f"{label}: max |err| {err}, finite {finite}, "
                            f"beyond {tol}")
            del q, k, v, ko, po
            continue
        ms = timer(kern)
        plain_ms = timer(plain)
        lib_ms = None
        extra = {}
        if (is_main or label in ("f32 train shape", SERVE_PREFILL_ATTENTION)
                or label.startswith(ARCH_ATTENTION)):
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
                   window=window, max_abs_err=err, tolerance=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, **agree, **extra)
        say(rec)
        if is_main:
            main = rec
        del q, k, v, ko, po
    if failures:
        fail("flash_attention_fwd: " + "; ".join(failures))
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


def check_scan_backward_graph(torch, kreg, kref):
    """The scan's backward at the hybrid shape (2, 1024, 8192, 16; f32,
    h0 zeros, as the model calls it) through a graph cache of its own:
    two calls with different inputs (the first captures, the second
    refills the static buffers), each bit for bit the eager
    ``_vjp_through``.  Host-clock seconds of each to a synchronize, and
    the bytes of the graph's private pool."""
    g = torch.Generator(device="cuda").manual_seed(7)
    F = torch.nn.functional
    b, l, di, ds = 2, 1024, 8192, 16
    needs = (True,) * 5 + (False,)
    graphs = kreg.ScanBackwardGraphs()
    rec = {"phase": "hybrid", "run": "scan backward, graphed against eager",
           "shape": [b, l, di, ds], "tolerance": "bitwise"}
    for call in range(2):
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        ts = (rnd(b, l, di), F.softplus(rnd(b, l, di) - 1.0),
              -torch.exp(0.5 * rnd(di, ds)), rnd(b, l, ds), rnd(b, l, ds),
              torch.zeros((b, di, ds), device="cuda"), rnd(b, l, di),
              rnd(b, di, ds))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = kreg._vjp_through(kref.ssm_scan_ref, ts[:6], ts[6:], needs)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        got = graphs(ts, needs)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        for i, (a, w) in enumerate(zip(got, want)):
            if (a is None) != (w is None) or (
                    a is not None and not torch.equal(a, w)):
                err = None if a is None or w is None else \
                    (a - w).abs().max().item()
                fail(f"hybrid: graphed scan backward, call {call}, input "
                     f"{i}: not bitwise the eager one (max |err| {err})")
        rec[f"call {call}"] = {"eager_s": t1 - t0, "graphed_s": t2 - t1}
        del ts, want, got
    rec["graph_pool_bytes"] = graphs.pool_bytes()
    graphs.clear()
    say(rec)


#: xlstm-125m's sLSTM time loop: (batch, length, heads, head dim)
SLSTM_SHAPE = (2, 1024, 4, 192)


def traced_kernels(torch, fn):
    """(kernels, device ms) of one call of ``fn`` as ``torch.profiler``
    traces them (a graph replay's kernels included)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.events()
            if e.device_type == cuda and not e.is_user_annotation]
    return len(seen), sum(e.device_time_total for e in seen) / 1e3


def check_slstm_graphs(torch, kreg, ssm):
    """The sLSTM time loop at xlstm-125m's shape (gates (2, 1024, 4,
    4·192) f32, recurrent weights (4, 192, 768)) through graph caches of
    its own: the forward and the backward, two calls each with new
    inputs (the first captures), each bit for bit the eager loop and
    autograd through it.  Host-clock seconds of every call to a
    synchronize (the first graphed ones include the capture), the
    kernels and device time of one replay (traced), and the bytes of
    each graph's private pool."""
    g = torch.Generator(device="cuda").manual_seed(9)
    b, l, heads, hd = SLSTM_SHAPE
    needs = (True, True)
    fwd = kreg.CudaGraphs(ssm.slstm_forward_body)
    bwd = kreg.CudaGraphs(ssm.slstm_backward_body)
    rec = {"phase": "kernels", "run": "sLSTM loop, graphed against eager",
           "shape": [b, l, heads, 4 * hd], "tolerance": "bitwise"}
    for call in range(2):
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        gx = rnd(b, l, heads, 4 * hd)
        wh = rnd(heads, hd, 4 * hd) / math.sqrt(hd)
        dh = rnd(b, l, heads, hd)
        runs = (("eager_forward", lambda: (ssm.slstm_loop(gx, wh),)),
                ("graphed_forward", lambda: fwd((gx, wh))),
                ("eager_backward", lambda: kreg._vjp_through(
                    ssm.slstm_loop, (gx, wh), (dh,), needs)),
                ("graphed_backward", lambda: bwd((gx, wh, dh), needs)))
        outs, times = {}, {}
        for name, fn in runs:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            outs[name] = fn()
            torch.cuda.synchronize()
            times[f"{name}_s"] = time.monotonic() - t0
        for which in ("forward", "backward"):
            for i, (a, w) in enumerate(zip(outs[f"graphed_{which}"],
                                           outs[f"eager_{which}"])):
                if not torch.equal(a, w):
                    fail(f"sLSTM graphed {which}, call {call}, output {i}: "
                         "not bitwise the eager one (max |err| "
                         f"{(a - w).abs().max().item()})")
        rec[f"call {call}"] = times
    for which, fn in (("forward", lambda: fwd((gx, wh))),
                      ("backward", lambda: bwd((gx, wh, dh), needs))):
        n, ms = traced_kernels(torch, fn)
        rec[f"{which}_replay_kernels"] = n
        rec[f"{which}_replay_device_ms"] = ms
    rec["forward_pool_bytes"] = fwd.pool_bytes()
    rec["backward_pool_bytes"] = bwd.pool_bytes()
    fwd.clear()
    bwd.clear()
    say(rec)
    return {}


# ----------------------------------------------------------------- runs
def main_path_spec(api, *, full: bool, workers: int, sync: str,
                   kernels: str = "auto", straggler: float = 2.0,
                   transport=None, compression: str = "none"):
    return api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b", smoke=not full,
                            kernels=kernels),
        data=api.DataSpec(seq_len=1024 if full else 64, global_batch=4),
        optimizer=api.OptimizerSpec(lr=3e-3, momentum=0.9),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=api.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=straggler),
        wire=api.WireSpec(format="packed", delta_pull=True,
                          compression=compression),
        transport=transport or api.TransportSpec())


def arch_spec(api, arch: str, *, smoke: bool, workers: int, sync: str,
              kernels: str = "auto", straggler: float = 2.0):
    """``arch`` through the main path's server and wire: seq 1024 and 2
    sequences per worker step at full width (seq 64 at smoke size)."""
    return api.RunSpec(
        model=api.ModelSpec(arch=arch, smoke=smoke, kernels=kernels),
        data=api.DataSpec(seq_len=64 if smoke else 1024, global_batch=2),
        optimizer=api.OptimizerSpec(lr=3e-3, momentum=0.9),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=api.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=straggler),
        wire=api.WireSpec(format="packed", delta_pull=True))


JAMBA = "jamba-v0.1-52b"


def hybrid_config():
    """jamba-v0.1-52b at its published widths, cut to one period group
    (8 layers: 7 Mamba slots, attention at offset 3) with every FFN the
    dense SwiGLU (no experts): 2,725,326,848 parameters."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(JAMBA), n_layers=8,
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


def run_train(torch, api, label: str, spec, per_step, *, spawned=False,
              extra=None, steps: int = 8, also=None, arrival_slack: int = 0,
              **overrides):
    """``steps`` (8) DSSP steps of ``spec`` (2 workers, the second
    slower) through ``build_session``; losses finite, no worker released
    past s_upper and the arrival staleness within s_upper (plus
    ``arrival_slack``: in a run long enough for the slower worker to
    fall s_upper behind, the push that arrives one past the bound is
    applied and blocked, so it is recorded at s_upper + 1), DSSP
    extensions == credit releases, every kernel's launches
    exactly what the run implies (``per_step``: launches per worker
    step; the server's ``fused_update`` once per shard version; ``also(
    session)``, called after the run, gives the launches of anything
    else the session ran in this process, e.g. serving replicas), peak
    below the card's 80 GB.  ``spawned``: the workers are processes
    (``ps-transport``), each holding ``per_step`` in its own
    ``WorkerResult``, and this process launches only the server's
    kernel.  ``extra(server, workers, m, wall)`` checks further and
    returns fields for the record.  Returns the record, with the
    launches."""
    from repro_torch.obs.trace import TRACE
    from repro_torch.perfcount import LAUNCHES, TRANSPORT
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    session = api.build_session(spec, **overrides)
    session.start()
    TRACE.enable(source="server")
    LAUNCHES.reset()
    TRANSPORT.reset()
    t0 = time.monotonic()
    m = session.run(steps)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    events = TRACE.drain()
    TRACE.disable()
    server = session.server
    workers = session.results if spawned else session.workers
    more = also(session) if also is not None else {}
    session.close()

    losses = [l for _, _, l in server.metrics.loss_trajectory]
    passes = sum(w.iterations_done for w in workers)
    if (passes != steps or len(losses) != steps
            or not all(map(math.isfinite, losses))):
        fail(f"{label}: {passes} steps, losses {losses}")
    if m["max_staleness"] > spec.sync.s_upper + arrival_slack:
        fail(f"{label}: staleness {m['max_staleness']} > s_upper"
             + (f" + {arrival_slack}" if arrival_slack else ""))
    decisions = [e for e in events if e["name"] == "dssp_decision"]
    released = [e["args"]["gap"] for e in decisions
                if e["args"]["reason"] != "block"]
    if released and max(released) > spec.sync.s_upper:
        fail(f"{label}: a worker released at gap {max(released)} > "
             "s_upper")
    ext = {(e["worker"], e["clock"]) for e in decisions
           if e["args"]["reason"] in ("grant", "credit_spend")}
    if len(ext) != m["credit_releases"]:
        fail(f"{label}: {len(ext)} DSSP extensions != "
             f"{m['credit_releases']} credit releases")
    rows = server.plan.wire_layout().shard_rows
    # no coalescing and no compression on this path
    expected = {name: (0 if spawned else per_step.get(name, 0) * passes)
                + more.get(name, 0) for name in launches}
    expected["fused_update"] = sum(st.version for st, r in
                                   zip(server.shards, rows) if r)
    if launches != expected:
        fail(f"{label}: launches {launches} != expected {expected}")
    if spawned:
        check_worker_launches(label, workers, per_step)
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
           "max_memory_allocated_gb": peak_gb,
           "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    if extra is not None:
        rec.update(extra(server, workers, m, wall))
    say(rec)
    return rec


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


# ----------------------------------------------------------------- transport
def transport_config():
    """h2o-danube-1.8b at its published widths cut to 13 of 24 layers,
    the deepest cut whose packed bf16 pull (S=4) fits one frame:
    2,133,999,616 bytes, under the frame protocol's 2 GiB payload limit
    (14 layers would not fit)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("h2o-danube-1.8b"), n_layers=13)


class MemoryUsedSampler:
    """The card's ``memory.used`` (nvidia-smi, MiB; every process on the
    card) sampled every half second on a thread; ``peak_mib`` after
    ``stop``."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(int(out.stdout.split()[0]))
            self._stop.wait(0.5)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=30)
        if not self.samples:
            fail("transport: nvidia-smi gave no memory.used sample")
        return max(self.samples)


def check_worker_launches(tag, results, per_step):
    """Each worker process's own launch counts: ``per_step`` per step it
    took, no other kernel."""
    for r in results:
        expected = {name: per_step.get(name, 0) * r.iterations_done
                    for name in r.launches}
        if r.launches != expected:
            fail(f"{tag}: worker {r.worker_id} launches {r.launches} != "
                 f"expected {expected}")


def run_transport(torch, api, per_step):
    """The full-width run over tcp through spawned worker processes:
    ``run_train``'s checks, and every push applied on every shard in
    frames of the plan's size."""
    from repro_torch.models import registry
    from repro_torch.perfcount import TRANSPORT
    from repro_torch.ps.sharded.plan import build_shard_plan
    from repro_torch.wireformat import MAX_PAYLOAD, WIRE_LANES
    cut = transport_config()
    layout = build_shard_plan(registry.abstract_params(cut),
                              4).wire_layout()
    frame_bytes = layout.total_rows * WIRE_LANES * layout.dtype.itemsize
    if not frame_bytes <= MAX_PAYLOAD:
        fail(f"transport: a {cut.n_layers}-layer pull is {frame_bytes} "
             f"bytes, over the {MAX_PAYLOAD}-byte frame limit")
    spec = main_path_spec(api, full=True, workers=2, sync="dssp",
                          transport=api.TransportSpec(kind="tcp",
                                                      host="127.0.0.1"))
    tag = f"transport (tcp, full width, {cut.n_layers} layers)"
    live = [j for j, r in enumerate(layout.shard_rows) if r]

    def extra(server, results, m, wall):
        if server.shard_versions() != [m["pushes"] if j in live else 0
                                       for j in range(4)]:
            fail(f"{tag}: shard versions {server.shard_versions()} for "
                 f"{m['pushes']} pushes")
        if server.version != m["pushes"] * len(live):
            fail(f"{tag}: version {server.version} != {m['pushes']} "
                 f"pushes x {len(live)} shards")
        payload = frame_bytes + 44
        for r in results:
            if any(b != payload for b in r.push_bytes):
                fail(f"{tag}: worker {r.worker_id} push frames "
                     f"{r.push_bytes}, expected {payload} bytes each")
        rec = {"run": tag, "frame_payload_bytes": frame_bytes,
               "wait_fraction": m["wait_fraction"],
               "worker_launches": [r.launches for r in results],
               "worker_max_memory_allocated_gb":
                   [r.peak_memory_bytes / 1e9 for r in results],
               "memory_used_peak_mib": sampler.stop(),
               "server_transport": TRANSPORT.snapshot()}
        for r in results:
            # the push's time includes the gate's wait, which the server
            # records per worker
            wait = server.metrics.wait_time.get(r.worker_id, 0.0)
            rec[f"worker {r.worker_id}"] = {
                "compute_s": r.compute_s, "pull_s": r.pull_s,
                "push_s": r.push_s, "iteration_s": r.iteration_s,
                "pull_bytes": r.pull_bytes, "push_bytes": r.push_bytes,
                "gate_wait_s": wait,
                "mean_compute_s": statistics.mean(r.compute_s),
                "mean_round_trip_s": statistics.mean(
                    p + q for p, q in zip(r.pull_s, r.push_s)),
                "mean_round_trip_s_without_wait": (
                    sum(r.pull_s) + sum(r.push_s) - wait) / len(r.pull_s),
                "wire_share": 1.0 - sum(r.compute_s) / sum(r.iteration_s)}
            say(f"transport: worker {r.worker_id} mean compute s "
                f"{statistics.mean(r.compute_s)}, wire share "
                f"{rec[f'worker {r.worker_id}']['wire_share']}, bytes per "
                f"push {statistics.mean(r.push_bytes)}, per pull "
                f"{statistics.mean(r.pull_bytes)}, peak GB "
                f"{r.peak_memory_bytes / 1e9}")
        say(f"transport: wall s {wall}, pushes/s {m['pushes'] / wall}, "
            f"server peak GB {torch.cuda.max_memory_allocated() / 1e9}, "
            f"card memory.used peak MiB {rec['memory_used_peak_mib']}")
        return rec

    sampler = MemoryUsedSampler()
    return run_train(torch, api, "transport", spec, per_step, spawned=True,
                     extra=extra, model_config=cut, timeout=900.0)


def run_transport_paths(torch, api, per_step):
    """At smoke size: shmem with 2 workers, tcp with int8 frames, and an
    inproc endpoint driven by one client of this process."""
    from repro_torch.perfcount import LAUNCHES
    from repro_torch.transport import connect
    shm = os.statvfs("/dev/shm")
    say(f"transport: /dev/shm size bytes {shm.f_frsize * shm.f_blocks}")
    for label, kind, comp in (("shmem, 2 workers", "shmem", "none"),
                              ("tcp, int8 frames", "tcp", "int8")):
        spec = main_path_spec(api, full=False, workers=2, sync="dssp",
                              transport=api.TransportSpec(kind=kind),
                              compression=comp)
        free_device_memory(torch)
        LAUNCHES.reset()
        with api.build_session(spec, timeout=600.0) as s:
            m = s.run(4)
            results = s.results
            losses = [l for _, _, l in s.server.metrics.loss_trajectory]
            live = sum(1 for r in s.server.plan.wire_layout().shard_rows
                       if r)
        tag = f"transport ({label})"
        if len(losses) != 4 or not all(map(math.isfinite, losses)):
            fail(f"{tag}: losses {losses}")
        if LAUNCHES.fused_update != live * m["pushes"]:
            fail(f"{tag}: server launches {LAUNCHES.snapshot()}")
        check_worker_launches(tag, results, per_step)
        say({"phase": "transport paths", "run": label, "losses": losses,
             "pushes": m["pushes"], "applied_updates": m["applied_updates"],
             "push_bytes": [r.push_bytes for r in results],
             "worker_launches": [r.launches for r in results]})
    spec = main_path_spec(api, full=False, workers=1, sync="bsp",
                          transport=api.TransportSpec(kind="inproc",
                                                      endpoint=True))
    with api.build_session(spec, external_workers=True) as s:
        client = connect(s.address(), 0)
        rows = client.hello()
        d = client.pull_delta((-1,) * 4)
        wire = torch.cat(list(d.regions))
        if not torch.equal(wire, s.server.pull_packed().cpu()):
            fail("transport (inproc endpoint): pulled wire differs")
        grads = torch.full((rows, 512), 1e-3, dtype=wire.dtype)
        if not client.push_packed(grads, clock=0):
            fail("transport (inproc endpoint): push answered STOP")
        version = s.server.version
        live = sum(1 for r in s.server.plan.wire_layout().shard_rows if r)
        client.bye()
    if version != live:
        fail(f"transport (inproc endpoint): version {version} after one "
             f"push to {live} shards")
    say({"phase": "transport paths", "run": "inproc endpoint, external "
         "client", "rows": rows, "applied_updates": version})


# -------------------------------------------------------------------- serve
#: serving at full width (each replica: 16 requests of 512-token prompts,
#: 32 new tokens each, batches of 8), fed by delta pulls and admitted
#: within 4 applied updates of the server once it has applied one
SERVE = dict(replicas=2, prompt_len=512, max_new=32, max_batch=8,
             requests=16, staleness_bound=4, start_at_version=1,
             refresh_every_s=0.05)
#: the serve phase's trainer steps (2 workers): the train phase's warm
#: steps take 0.63-0.79 s, and a replica's warm-up and two batches take
#: seconds, so 24 steps keep training going while the replicas serve
SERVE_STEPS = 24


def serve_batch_launches(cfg, max_new: int):
    """Kernel launches of one decode batch of a dense config: the
    prefill's attention and fused norm a layer, its norm a layer and the
    final one; then two norms a layer and the final one a later
    token."""
    n = cfg.n_layers
    return {"flash_attention_fwd": n, "residual_rmsnorm": n,
            "rmsnorm": n + 1 + (2 * n + 1) * (max_new - 1)}


def teacher_forced_logits(torch, dec, wire, prompts, tokens):
    """``dec``'s logits at every generated position, fed ``tokens``
    (b, max_new) after the prompts: (b, max_new, v)."""
    params = dec.params(wire)
    last, state = dec.prefill(params, torch.from_numpy(prompts).long()
                              .to(dec.device))
    out = [last]
    for j in range(tokens.shape[1] - 1):
        tok = torch.from_numpy(tokens[:, j:j + 1]).long().to(dec.device)
        last, state = dec.step(params, tok, state, prompts.shape[1] + j)
        out.append(last)
    return torch.stack(out, dim=1)


#: the smoke configs that serve parity decodes: dense (a window), the
#: hybrid (Mamba, attention, MoE), the MoE transformer with shared
#: experts, the vlm (q/k norms), QKV bias with an int8 KV cache, and
#: xLSTM (the mLSTM and sLSTM recurrences, prefilled token by token)
SERVE_PARITY_ARCHS = ("h2o-danube-1.8b", "jamba-v0.1-52b",
                      "deepseek-moe-16b", "chameleon-34b", "qwen1.5-32b",
                      "xlstm-125m")


def check_serve_parity(torch, tol: float = 2e-4, device: str = "cuda:0"):
    """The ``SERVE_PARITY_ARCHS`` smoke configs (f32) decoded on the card
    from one wire, with the kernels and with the plain formulations:
    logits along the plain decoder's greedy tokens agree within ``tol``.
    An int8 KV cache (qwen1.5-32b) is decoded with an f32 cache too,
    held to ``tol`` there; with its int8 cache the kernels' logits may
    differ from the plain ones by no more than the int8 cache moves the
    plain logits from the f32 cache's (a key whose f32 value differs by
    ulps between the two formulations can round to the next int8 code,
    ROADMAP queue 3).  Then the dense ring cache (the smoke window, 16)
    decoded 40 positions, against the full forward at each."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry, transformer
    from repro_torch.ps.sharded.plan import build_shard_plan
    from repro_torch.serve import Decoder
    rec = {"phase": "serve parity", "tol": tol}
    rng = np.random.RandomState(0)
    for arch in SERVE_PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        params = registry.init_params(cfg, seed=0, device=device)
        plan = build_shard_plan(params, 4)
        wire = plan.pack(params)
        prompts = rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        caches = (cfg.kv_cache_dtype, "") if cfg.kv_cache_dtype else ("",)
        logits, tokens = {}, None
        for cache in caches:
            for kernels in ("xla", "auto"):
                dec = Decoder(dataclasses.replace(
                    cfg, kernels=kernels, kv_cache_dtype=cache), plan,
                    prompt_len=16, max_new=8, max_batch=4, device=device)
                if tokens is None:
                    tokens = dec.decode(wire.clone(), prompts)
                logits[cache, kernels] = teacher_forced_logits(
                    torch, dec, wire.clone(), prompts, tokens)
                if cache == cfg.kv_cache_dtype:
                    rec[f"{arch} tokens ({kernels})"] = \
                        dec.decode(wire.clone(), prompts).tolist()
        errs = {cache: (logits[cache, "auto"] - logits[cache, "xla"]).abs()
                .max().item() for cache in caches}
        rec[f"{arch} max_abs_err"] = errs[cfg.kv_cache_dtype]
        bound = tol
        if cfg.kv_cache_dtype:
            rec[f"{arch} f32 cache max_abs_err"] = errs[""]
            if not errs[""] <= tol:
                fail(f"serve parity ({arch}, f32 cache): kernel and plain "
                     f"logits differ by {errs['']}")
            bound = max(tol, (logits[cfg.kv_cache_dtype, "xla"]
                              - logits["", "xla"]).abs().max().item())
            rec[f"{arch} {cfg.kv_cache_dtype} cache bound"] = bound
        if not errs[cfg.kv_cache_dtype] <= bound:
            fail(f"serve parity ({arch}): kernel and plain logits differ "
                 f"by {errs[cfg.kv_cache_dtype]} (bound {bound})")
    cfg = get_smoke_config("h2o-danube-1.8b")
    params = registry.init_params(cfg, seed=0, device=device)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40))).to(
        device)
    with torch.inference_mode():
        full, _ = transformer.forward(cfg, params, toks)
        cache = transformer.init_cache(cfg, 2, 40, device=device)
        if cache["k"].shape[2] != cfg.sliding_window:
            fail(f"serve parity: ring of {cache['k'].shape[2]} slots")
        err = 0.0
        for i in range(40):
            logits, cache = transformer.forward_decode(
                cfg, params, toks[:, i:i + 1], cache, i)
            err = max(err, (logits[:, 0] - full[:, i]).abs().max().item())
    rec["ring (window 16, 40 positions) max_abs_err"] = err
    say(rec)
    if not err <= tol:
        fail(f"serve parity: the ring cache's logits differ from the full "
             f"forward's by {err}")


def time_decode_batch(torch, cfg, plan, wire, sv, device: str = "cuda:0"):
    """One decode batch of ``cfg`` on ``wire``, the card to itself: the
    wall time of an untraced batch, the prefill's and a later token's
    time (synchronised), and the device's busy time over a traced batch
    (``torch.profiler``), whence its idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Decoder
    dec = Decoder(cfg, plan, prompt_len=sv["prompt_len"],
                  max_new=sv["max_new"], max_batch=sv["max_batch"],
                  device=device)
    prompts = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (sv["max_batch"], sv["prompt_len"])).astype(
        np.int32)
    dec.decode(wire, prompts)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tokens = dec.decode(wire, prompts)
    batch_ms = (time.monotonic() - t0) * 1e3
    if tokens.shape != (sv["max_batch"], sv["max_new"]) or not (
            0 <= tokens.min() and tokens.max() < cfg.vocab_size):
        fail(f"serve: decoded tokens {tokens.shape}, range "
             f"[{tokens.min()}, {tokens.max()}]")
    params = dec.params(wire)
    toks = torch.from_numpy(prompts).long().to(device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    last, state = dec.prefill(params, toks)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    tok = torch.argmax(last, dim=-1)[:, None]
    t0 = time.monotonic()
    for j in range(sv["max_new"] - 1):
        logits, state = dec.step(params, tok, state, sv["prompt_len"] + j)
        tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    token_ms = (time.monotonic() - t0) * 1e3 / (sv["max_new"] - 1)
    del params, state, last, logits
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec.decode(wire, prompts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"batch_ms": batch_ms, "prefill_ms": prefill_ms,
            "decode_ms_per_token": token_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "kernels_per_batch": len(kernels),
            "idle_share": (1.0 - busy_ms / batch_ms if busy_ms > 0
                           else "not measured")}


#: one full-width xlstm-125m decode batch: serving's prompts and batch
XLSTM_DECODE = dict(prompt_len=512, max_new=32, max_batch=8)
#: decode steps traced for the device's busy time a token
XLSTM_TRACED_TOKENS = 8


def time_xlstm_decode(torch, device: str = "cuda:0"):
    """One xlstm-125m decode batch (random weights from seed 0, the
    published config) with the card to itself: 8 prompts of 512 tokens,
    prefilled token by token through the decode step (a recurrent
    family), then 32 new tokens.  After a warm-up batch: the prefill's
    time and a later token's (synchronised), the ``rmsnorm`` launches a
    token (its 12 layers' and the final norm, no other kernel), and,
    over ``XLSTM_TRACED_TOKENS`` traced tokens, the kernels a token and
    the device's busy time, whence the idle share of an untraced
    token."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.perfcount import LAUNCHES
    from repro_torch.ps.sharded.plan import build_shard_plan
    from repro_torch.serve import Decoder
    cfg = get_config("xlstm-125m")
    params = registry.init_params(cfg, seed=0, device=device)
    plan = build_shard_plan(params, 4)
    wire = plan.pack(params)
    del params
    sv = XLSTM_DECODE
    dec = Decoder(cfg, plan, device=device, **sv)
    prompts = np.random.RandomState(12).randint(
        0, cfg.vocab_size, (sv["max_batch"], sv["prompt_len"])).astype(
        np.int32)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tokens = dec.decode(wire, prompts)
    warm_ms = (time.monotonic() - t0) * 1e3
    if tokens.shape != (sv["max_batch"], sv["max_new"]) or not (
            0 <= tokens.min() and tokens.max() < cfg.vocab_size):
        fail(f"xlstm decode: tokens {tokens.shape}, range "
             f"[{tokens.min()}, {tokens.max()}]")
    p = dec.params(wire)
    toks = torch.from_numpy(prompts).long().to(device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    last, state = dec.prefill(p, toks)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    tok = torch.argmax(last, dim=-1)[:, None]
    before = LAUNCHES.snapshot()
    t0 = time.monotonic()
    n_tok = sv["max_new"] - 1
    for j in range(n_tok):
        logits, state = dec.step(p, tok, state, sv["prompt_len"] + j)
        tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    token_ms = (time.monotonic() - t0) * 1e3 / n_tok
    launched = LAUNCHES.delta(before)
    want = {name: (cfg.n_layers + 1) * n_tok if name == "rmsnorm" else 0
            for name in launched}
    if launched != want:
        fail(f"xlstm decode: launches {launched} != expected {want}")
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for j in range(XLSTM_TRACED_TOKENS):
            logits, state = dec.step(p, tok, state, sv["prompt_len"] + j)
            tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 \
        / XLSTM_TRACED_TOKENS
    state_bytes = sum(t.numel() * t.element_size()
                      for kind in state.values() for t in kind.values())
    rec = {"phase": "serve", "run": "xlstm-125m decode batch, the card to "
           "itself", **sv, "warm_batch_ms": warm_ms,
           "prefill_ms": prefill_ms,
           "prefill_ms_per_token": prefill_ms / sv["prompt_len"],
           "decode_ms_per_token": token_ms,
           "rmsnorm_launches_per_token": launched["rmsnorm"] / n_tok,
           "kernels_per_token": len(kernels) / XLSTM_TRACED_TOKENS,
           "device_busy_ms_per_token": busy_ms if busy_ms > 0
           else "not measured",
           "idle_share": (1.0 - busy_ms / token_ms if busy_ms > 0
                          else "not measured"),
           "state_bytes": state_bytes}
    say(rec)
    return rec


def check_serving(tag, m, results, requests: int, bound: int):
    """The serving invariants: every request served, no admission past
    the bound, a version above 0 served, no replica failed."""
    sv = m["serve"]
    if sv["requests"] != requests or sv["violations"] != 0 \
            or sv["staleness_max"] > bound or not sv["version_max"] > 0:
        fail(f"{tag}: serve metrics {sv}")
    for r in results:
        if r.error or not r.refreshes:
            fail(f"{tag}: replica {r.replica_id}: {r.error or r}")


def run_serve(torch, api, per_step, *, device: str = "cuda:0"):
    """Training and serving on one card: ``run_train``'s checks on the
    full-width train configuration with ``SERVE_STEPS`` steps while 2
    replica threads serve from the in-heap server; every request served
    within the staleness bound, and the launches of every decode batch
    (warm-ups included) on top of the trainers'.  Then one batch timed
    with the card to itself.  Returns the run's record."""
    from repro_torch.configs import get_config
    cfg = get_config("h2o-danube-1.8b")
    spec = main_path_spec(api, full=True, workers=2, sync="dssp").replace(
        serve=api.ServeSpec(**SERVE))
    per_batch = serve_batch_launches(cfg, SERVE["max_new"])
    held = {}

    def also(session):
        results = held["results"] = session.serve_results
        held["wire"] = session.server.pull_packed().clone()
        held["plan"] = session.server.plan
        batches = sum(r.batches for r in results) + len(results)
        held["batches"] = batches
        return {name: n * batches for name, n in per_batch.items()}

    def extra(server, workers, m, wall):
        results = held["results"]
        check_serving("serve", m, results,
                      SERVE["replicas"] * SERVE["requests"],
                      SERVE["staleness_bound"])
        return {"serve": m["serve"], "decode_batches": held["batches"],
                "final_version": server.version,
                "served_versions": [r.served_versions for r in results],
                "replica_refreshes": [r.refreshes for r in results],
                "replica_refresh_bytes": [r.refresh_bytes for r in results],
                "memory_used_peak_mib": sampler.stop()}

    sampler = MemoryUsedSampler()
    rec = run_train(torch, api, "serve", spec, per_step, steps=SERVE_STEPS,
                    also=also, extra=extra, arrival_slack=1)
    sv = rec["serve"]
    say(f"serve: requests/s {sv['requests_per_s']}, p50 ms {sv['p50_ms']}, "
        f"p99 ms {sv['p99_ms']}, legal fraction {sv['legal_fraction']}, "
        f"staleness max {sv['staleness_max']}, versions "
        f"{sv['version_min']}-{sv['version_max']} of "
        f"{rec['final_version']}")
    for rid, (n, b) in enumerate(zip(rec["replica_refreshes"],
                                     rec["replica_refresh_bytes"])):
        say(f"serve: replica {rid}: {n} refreshes, {b} bytes")
    say(f"serve: peak memory GB {rec['max_memory_allocated_gb']}, card "
        f"memory.used peak MiB {rec['memory_used_peak_mib']}")
    free_device_memory(torch)
    timing = time_decode_batch(torch, cfg, held.pop("plan"),
                               held.pop("wire"), SERVE, device=device)
    say({"phase": "serve", "run": "one batch, the card to itself",
         **timing})
    return rec


def run_serve_transport(torch, api, per_step):
    """The transport configuration (13 layers) trained by 2 worker
    processes over tcp while 1 spawned replica process serves from
    delta pulls (refreshed each second): the serving invariants, the
    replica's launches per batch exactly, ``run_train``'s checks.
    Returns the run's record."""
    cut = transport_config()
    sv = dict(SERVE, replicas=1, refresh_every_s=1.0)
    spec = main_path_spec(
        api, full=True, workers=2, sync="dssp",
        transport=api.TransportSpec(kind="tcp", host="127.0.0.1")).replace(
        serve=api.ServeSpec(**sv))
    per_batch = serve_batch_launches(cut, sv["max_new"])
    held = {}

    def also(session):
        held["results"] = session.serve_results
        return {}

    def extra(server, workers, m, wall):
        results = held["results"]
        check_serving("serve transport", m, results, sv["requests"],
                      sv["staleness_bound"])
        for r in results:
            want = {name: per_batch.get(name, 0) * (r.batches + 1)
                    for name in r.launches}
            if r.launches != want:
                fail(f"serve transport: replica {r.replica_id} launches "
                     f"{r.launches} != expected {want}")
        return {"serve": m["serve"],
                "replica_launches": [r.launches for r in results],
                "replica_refreshes": [r.refreshes for r in results],
                "replica_refresh_bytes": [r.refresh_bytes for r in results],
                "replica_max_memory_allocated_gb":
                    [r.peak_memory_bytes / 1e9 for r in results],
                "worker_max_memory_allocated_gb":
                    [r.peak_memory_bytes / 1e9 for r in workers],
                "memory_used_peak_mib": sampler.stop()}

    sampler = MemoryUsedSampler()
    return run_train(torch, api, "serve transport", spec, per_step,
                     spawned=True, also=also, extra=extra, model_config=cut,
                     timeout=900.0)


# -------------------------------------------------------------------- archs
#: the transformer families at their published widths, cut in depth to
#: fit one card beside the phase's workers (PERF.md §4): (arch, layers,
#: workers, sync).  qwen1.5-110b's one layer holds 3.85 B parameters, and
#: two workers would reckon at about 73 of the card's 80 GB, so it trains
#: with one (BSP, no straggler).
ARCH_CUTS = (("qwen1.5-110b", 1, 1, "bsp"),
             ("qwen1.5-32b", 3, 2, "dssp"),
             ("mistral-large-123b", 2, 2, "dssp"),
             ("chameleon-34b", 3, 2, "dssp"),
             ("qwen3-moe-235b-a22b", 1, 2, "dssp"),
             ("deepseek-moe-16b", 5, 2, "dssp"))
ARCH_STEPS = 4
#: the MoE architecture whose one-worker step is profiled
ARCH_PROFILED = "deepseek-moe-16b"


def arch_config(arch: str, layers: int):
    """``arch`` at its published widths, cut to ``layers`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=layers)


def arch_launches(cfg):
    """Kernel launches of one worker step of a config, by family.  A
    transformer: per layer and pass (the forward, and its recompute
    under remat) one attention, one fused residual norm, and the
    attention norm with the q/k norms where the config has them; the
    final norm once.  xLSTM: the layer's norm a layer and pass, and the
    final norm (its residual is a plain add; no attention).  Whisper:
    none (layernorm, and attention over an explicit mask, both plain, as
    the reference's never reach its registry)."""
    passes = cfg.n_layers * (2 if cfg.remat == "full" else 1)
    if cfg.family == "ssm":
        return {"rmsnorm": passes + 1}
    if cfg.family == "audio":
        return {}
    return {"flash_attention_fwd": passes, "residual_rmsnorm": passes,
            "rmsnorm": passes * (1 + (2 if cfg.qk_norm else 0)) + 1}


def run_archs(torch, api):
    """The transformer families, each on its own: the smoke config's
    parity (kernels vs plain, through ``build_session``), then
    ``ARCH_STEPS`` steps of the full-width cut through ``run_train``
    (``model_config=``), its records carrying the cut's parameters;
    then one profiled one-worker step of ``ARCH_PROFILED``'s cut.
    Returns the launches of the train runs, summed."""
    total = {}
    for arch, layers, workers, sync in ARCH_CUTS:
        check_parity(torch, api, f"{arch} smoke", lambda kernels: arch_spec(
            api, arch, smoke=True, workers=1, sync="bsp", kernels=kernels,
            straggler=1.0))
        cut = arch_config(arch, layers)
        info = {"arch": arch, "layers": layers, "params": cut.param_count(),
                "active_params": cut.active_param_count(),
                "workers": workers, "sync": sync}
        rec = run_train(
            torch, api, f"arch {arch}",
            arch_spec(api, arch, smoke=False, workers=workers, sync=sync,
                      straggler=2.0 if workers > 1 else 1.0),
            arch_launches(cut), steps=ARCH_STEPS,
            extra=lambda *_: info, model_config=cut)
        for name, n in rec["launches"].items():
            total[name] = total.get(name, 0) + n
        if arch == ARCH_PROFILED:
            profiled = cut
    profile_step(torch, api, f"arch {ARCH_PROFILED}",
                 arch_spec(api, ARCH_PROFILED, smoke=False, workers=1,
                           sync="bsp", straggler=1.0),
                 steps=1, model_config=profiled)
    return total


# ----------------------------------------------------------------- families
#: the recurrent and audio families at their published configs, uncut:
#: xlstm-125m (12 layers, sLSTM at 5 and 11; 81,178,448 parameters) and
#: whisper-tiny (4 + 4 layers; 49,049,088)
FAMILY_ARCHS = ("xlstm-125m", "whisper-tiny")
#: the family whose one-worker step is profiled
FAMILY_PROFILED = "xlstm-125m"


def slstm_graph_counts(ssm) -> dict:
    fwd, bwd = ssm.SLSTM_FORWARD_GRAPHS, ssm.SLSTM_BACKWARD_GRAPHS
    return {"forward_graphs": len(fwd), "backward_graphs": len(bwd),
            "forward_pool_bytes": fwd.pool_bytes(),
            "backward_pool_bytes": bwd.pool_bytes()}


def run_families(torch, api):
    """xlstm-125m (``ssm``) and whisper-tiny (``audio``), each on its
    own: the smoke config's parity (kernels vs plain, through
    ``build_session``), then ``ARCH_STEPS`` steps of the published
    config through ``run_train`` (seq 1024, Whisper's frames as long, 2
    sequences a worker step, 2 DSSP workers [1, 4], straggler 2.0, bf16,
    remat full), with ``arch_launches``' family-aware counts.  For xLSTM
    the sLSTM loop's graphs: one backward graph (the autograd engine's
    one device thread) and a forward graph for each thread that ran the
    loop (each worker, and the device thread's remat recompute), none
    added after the first step, nor by a later session; then one
    profiled one-worker xLSTM step.  Returns the launches of the train
    runs, summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    total = {}
    for arch in FAMILY_ARCHS:
        check_parity(torch, api, f"{arch} smoke", lambda kernels: arch_spec(
            api, arch, smoke=True, workers=1, sync="bsp", kernels=kernels,
            straggler=1.0))
        ssm.SLSTM_FORWARD_GRAPHS.clear()
        ssm.SLSTM_BACKWARD_GRAPHS.clear()
        cfg = get_config(arch)
        info = {"arch": arch, "layers": cfg.n_layers,
                "encoder_layers": cfg.n_encoder_layers,
                "params": cfg.param_count()}
        spec = arch_spec(api, arch, smoke=False, workers=2, sync="dssp")
        rec = run_train(torch, api, f"family {arch}", spec,
                        arch_launches(cfg), steps=ARCH_STEPS,
                        extra=lambda *_: dict(info, **slstm_graph_counts(
                            ssm)))
        for name, n in rec["launches"].items():
            total[name] = total.get(name, 0) + n
        if cfg.family != "ssm":
            continue
        graphs = slstm_graph_counts(ssm)
        if not (1 <= graphs["forward_graphs"] <= spec.ps.workers + 1
                and graphs["backward_graphs"] == 1):
            fail(f"family {arch}: sLSTM graphs {graphs}: one backward "
                 "graph and one forward graph a thread expected")
        say({"phase": f"family {arch}", "slstm_forward_graphs":
             ssm.SLSTM_FORWARD_GRAPHS.summary(), "slstm_backward_graphs":
             ssm.SLSTM_BACKWARD_GRAPHS.summary()})
        profile_step(torch, api, f"family {arch}",
                     arch_spec(api, arch, smoke=False, workers=1, sync="bsp",
                               straggler=1.0), steps=1)
        after = slstm_graph_counts(ssm)
        if (after["forward_graphs"], after["backward_graphs"]) != (
                graphs["forward_graphs"], graphs["backward_graphs"]):
            fail(f"family {arch}: the profile's sessions added sLSTM "
                 f"graphs: {graphs} -> {after}")
        ssm.SLSTM_FORWARD_GRAPHS.clear()
        ssm.SLSTM_BACKWARD_GRAPHS.clear()
    return total


# ----------------------------------------------------------------------- ft
#: the reference's recovery bound for a per-shard pause (its chaos test's
#: assertion on ``snapshot_shard`` spans): printed beside the pauses
PAUSE_BOUND_S = 0.5
#: room the full-width phase needs under ``build/ft/``: two kept
#: snapshots and one in flight, of p and m (≈ 4.27 GB each)
FT_DISK_BYTES = 13 * 10**9
#: where the ft phases write their snapshots and spills (git ignores
#: build/), each run in a directory of its own, removed at its end
FT_WORK_DIR = os.path.join(ROOT, "build", "ft")


def ft_spec(api, *, full: bool, ft_dir: str, kind: str = "tcp", **ft):
    """The transport phase's spec with tracing (a metrics sample every
    half second) and the given ``ft`` fields."""
    spec = main_path_spec(api, full=full, workers=2, sync="dssp",
                          transport=api.TransportSpec(kind=kind,
                                                      host="127.0.0.1"))
    return spec.replace(obs=api.ObsSpec(trace=True, sample_every=0.5),
                        ft=api.FtSpec(dir=ft_dir, **ft))


def _within(events, span, name):
    """The ``name`` events of ``span``'s process inside its interval."""
    end = span["ts"] + span["dur"]
    return [e for e in events if e["name"] == name
            and e["src"] == span["src"] and span["ts"] <= e["ts"] <= end]


def check_trace_spans(tag, events, results):
    """The merged trace's ft spans: one ``compute_step`` per step each
    worker computed (its clocks 0..n-1), ``snapshot_shard`` spans for
    every shard of every snapshot, one ``reshard_shard`` span per old
    shard of every reshard, and reconnect spans of both workers."""
    for r in results:
        steps = [e for e in events if e["name"] == "compute_step"
                 and e["src"] == f"w{r.worker_id}"]
        if (len(steps) != len(r.compute_s)
                or {e["clock"] for e in steps}
                != set(range(r.iterations_done))):
            fail(f"{tag}: worker {r.worker_id} traced "
                 f"{sorted(e['clock'] for e in steps)} for "
                 f"{len(r.compute_s)} computed steps")
        if not any(e["name"] == "reconnect" and e["src"] == f"w{r.worker_id}"
                   for e in events):
            fail(f"{tag}: worker {r.worker_id} has no reconnect span")
    for span in (e for e in events if e["name"] == "snapshot"):
        shards = sorted(e["shard"] for e in
                        _within(events, span, "snapshot_shard"))
        if shards != list(range(span["args"]["shards"])):
            fail(f"{tag}: snapshot {span['args']} of {span['src']} has "
                 f"shard spans {shards}")
    for span in (e for e in events if e["name"] == "reshard"):
        shards = sorted(e["shard"] for e in
                        _within(events, span, "reshard_shard"))
        if shards != list(range(span["args"]["from"])):
            fail(f"{tag}: reshard {span['args']} of {span['src']} has "
                 f"shard spans {shards}")


class FailFast:
    """``ProcessWorkerPool.join``'s endpoint for a server in another
    process: a worker that dies ends the phase at once (its seat in a
    restored server would gate the other worker until the deadline)."""

    def __init__(self, tag: str):
        self.tag = tag

    def on_disconnect(self, worker: int) -> None:
        fail(f"{self.tag}: worker process {worker} died (its traceback "
             "is above)")


def snapshot_extras(ft_dir: str, step: int):
    """One snapshot's extras, read while its server may still write
    others (a ``CheckpointManager`` here would remove their ``.tmp_``
    directories)."""
    with open(os.path.join(ft_dir, f"step_{step:09d}",
                           "manifest.json")) as fh:
        return json.load(fh)["extras"]


def _last_sample(events, src):
    samples = [e for e in events if e["name"] == "metrics_snapshot"
               and e["src"] == src]
    if not samples:
        fail(f"ft: no metrics sample from {src}")
    return max(samples, key=lambda e: e["ts"])


def run_ft(torch, api, per_step, *, device: str = "cuda:0"):
    """The transport configuration through a restartable server process:
    snapshots every 20 s (keep 2), a live reshard 4 -> 6 at push round 4,
    and a SIGKILL by the server's own watchdog at round 10, after which
    the restart restores the 6-shard snapshot into a server the spec
    builds with 4 shards.  Both workers reconnect and finish."""
    import shutil
    out = FT_WORK_DIR
    os.makedirs(out, exist_ok=True)
    free = shutil.disk_usage(out).free
    if free < FT_DISK_BYTES:
        fail(f"ft: {free} bytes free under {out}, the phase needs "
             f"{FT_DISK_BYTES} for its snapshots")
    work = os.path.join(out, f"ft-{os.getpid()}")
    spill = os.path.join(work, "spill")
    cut = transport_config()
    spec = ft_spec(api, full=True, ft_dir=os.path.join(work, "ckpt"),
                   snapshot_every_s=20.0, keep=2, reconnect_tries=40,
                   reconnect_base_s=0.5, reconnect_max_s=5.0,
                   reshard_shards=6, reshard_round=4,
                   fault_kill_server_round=10)
    tag = f"ft (tcp, full width, {cut.n_layers} layers)"
    try:
        _run_ft(torch, api, per_step, spec, cut, spill, tag, work, device)
    finally:
        # gigabytes: never left behind, on success or failure
        shutil.rmtree(spec.ft.dir, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)


def _run_ft(torch, api, per_step, spec, cut, spill, tag, work, device):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import ServerProcess
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    from repro_torch.obs import (TraceCollector, read_trace, summarize,
                                 write_chrome_trace)
    sampler = MemoryUsedSampler()
    sp = ServerProcess(spec, trace_spill=spill, device=device,
                       model_config=cut, start_timeout=600.0)
    pool = None
    try:
        t0 = time.monotonic()
        addr = sp.start()
        pool = ProcessWorkerPool(addr, WorkerTask.from_spec(
            spec, 8, device=device, model_config=cut, trace_spill=spill,
            trace_flush_every=2), 2, slowdowns=[1.0, 2.0])
        pool.start()
        if not sp.wait_dead(600.0):
            fail(f"{tag}: the server's watchdog never fired")
        t_kill = time.monotonic() - t0
        if sp.restart() != addr:
            fail(f"{tag}: the restart moved the address")
        if sp.resumed_step is None:
            fail(f"{tag}: the restart found no snapshot")
        # read now: later snapshots of this incarnation GC it (keep 2)
        restored = snapshot_extras(spec.ft.dir, sp.resumed_step)
        results = pool.join(timeout=600.0, endpoint=FailFast(tag))
        wall = time.monotonic() - t0
        raise_on_failure(results)
        sp.stop(timeout=300.0)
        memory_used = sampler.stop()
        mgr = CheckpointManager(spec.ft.dir, keep=spec.ft.keep)
        final = mgr.peek_extras(mgr.latest_step())
        snapshot_bytes = sum(
            os.path.getsize(os.path.join(root, f))
            for root, _, files in os.walk(mgr._step_dir(mgr.latest_step()))
            for f in files)
        collector = TraceCollector()
        collector.ingest_spill_dir(spill)
        events = collector.timeline()
        chrome = os.path.join(work, "trace.json")
        write_chrome_trace(events, chrome)
        summary = summarize(read_trace(chrome))
    finally:
        if pool is not None:
            pool.terminate()
        sp.stop(timeout=60.0)
        sp.kill()

    # -- the run ----------------------------------------------------------
    if [r.iterations_done for r in results] != [8, 8]:
        fail(f"{tag}: iterations {[r.iterations_done for r in results]}")
    check_worker_launches(tag, [dataclasses.replace(
        r, iterations_done=len(r.compute_s)) for r in results], per_step)
    fm, rm = final["metrics"], restored["metrics"]
    losses = [l for _, _, l in fm["loss_trajectory"]]
    versions_seen = [v for _, v, _ in fm["loss_trajectory"]]
    if (fm["loss_trajectory"][:len(rm["loss_trajectory"])]
            != rm["loss_trajectory"]
            or len(losses) <= len(rm["loss_trajectory"])
            or not all(map(math.isfinite, losses))
            or versions_seen != sorted(versions_seen)):
        fail(f"{tag}: loss trajectory {fm['loss_trajectory']} does not "
             f"continue the restored {rm['loss_trajectory']}")
    if restored["n_shards"] != 6 or final["n_shards"] != 6:
        fail(f"{tag}: restored {restored['n_shards']} shards, final "
             f"{final['n_shards']}: no cross-arity restore")
    inc1_pushes = fm["applied_updates"] - rm["applied_updates"]
    if sum(final["versions"]) - sum(restored["versions"]) != 6 * inc1_pushes:
        fail(f"{tag}: versions {restored['versions']} -> "
             f"{final['versions']} for {inc1_pushes} pushes on 6 shards")
    # -- the merged trace -------------------------------------------------
    srcs = {e["src"] for e in events}
    if not {"server0", "server1", "w0", "w1"} <= srcs:
        fail(f"{tag}: trace sources {sorted(srcs)}")
    frames = set()
    for i in (0, 1):
        path = os.path.join(spill, f"frames-server{i}.jsonl")
        if os.path.exists(path):
            with open(path) as fh:
                frames |= {json.loads(line)["src"] for line in fh
                           if line.strip()}
    if frames != {"w0", "w1"}:
        fail(f"{tag}: MSG_TRACE frames reached the server from {frames}")
    check_trace_spans(tag, events, results)
    failover = [e for e in events if e["name"] == "failover"]
    if (len(failover) != 1 or failover[0]["src"] != "server1"
            or failover[0]["args"]["step"] != sp.resumed_step
            or len(failover[0]["args"]["versions"]) != 6):
        fail(f"{tag}: failover spans {failover}")
    reshards = [(e["src"], e["args"]["from"], e["args"]["to"])
                for e in events if e["name"] == "reshard"]
    if sorted(reshards) != [("server0", 4, 6), ("server1", 4, 6)]:
        fail(f"{tag}: reshards {reshards}")
    s_upper = spec.sync.s_upper
    stale = [e["args"]["staleness"] for e in events if e["name"] == "push"]
    if (not stale or max(stale) > s_upper
            or fm["staleness_hist"] and max(map(int, fm["staleness_hist"]))
            > s_upper):
        fail(f"{tag}: a release past s_upper {s_upper}: {stale}")
    ext = {src: {(e["worker"], e["clock"]) for e in events
                 if e["name"] == "dssp_decision" and e["src"] == src
                 and e["args"]["reason"] in ("grant", "credit_spend")}
           for src in ("server0", "server1")}
    if (len(ext["server1"]) != fm["credit_releases"] - rm["credit_releases"]
            or len(ext["server0"]) < rm["credit_releases"]):
        fail(f"{tag}: DSSP extensions {len(ext['server0'])} + "
             f"{len(ext['server1'])} against credit releases "
             f"{rm['credit_releases']} restored, {fm['credit_releases']} "
             "final")
    last = {src: _last_sample(events, src) for src in ("server0", "server1")}
    reshard0 = [e for e in events if e["name"] == "reshard"
                and e["src"] == "server0"][0]
    if last["server0"]["ts"] < reshard0["ts"] + reshard0["dur"]:
        fail(f"{tag}: no sample of server0 after its reshard")
    wire = [last[src]["args"]["perfcount"]["wire"] for src in last]
    parked = sum(w["reshard_parked"] for w in wire)
    replayed = sum(w["reshard_replayed"] for w in wire)
    if parked != replayed:
        fail(f"{tag}: {parked} contributions parked, {replayed} replayed")
    launches1 = last["server1"]["args"]["perfcount"]["launches"]
    # (a rehearsal on the CPU runs the plain version: no launches)
    if device != "cpu" and launches1["fused_update"] != 6 * inc1_pushes:
        fail(f"{tag}: server1 fused_update launches "
             f"{launches1['fused_update']} for {inc1_pushes} pushes")
    if summary["events"] != len(events):
        fail(f"{tag}: the Chrome export read back {summary['events']} of "
             f"{len(events)} events")

    def durs(name):
        return [e["dur"] for e in events if e["name"] == name]

    writes = [e for e in events if e["name"] == "snapshot_write"]
    rec = {
        "phase": "ft", "run": tag, "wall_s": wall,
        "pushes_per_s": 16 / wall, "kill_at_s": t_kill,
        "restart_to_serve_s": sp.start_s[1], "first_start_s": sp.start_s[0],
        "restore_s": failover[0]["dur"],
        "resumed_step": sp.resumed_step,
        "restored_versions": restored["versions"],
        "final_versions": final["versions"],
        "losses": losses,
        "reconnects": [r.reconnects for r in results],
        "layout_rebuilds": [r.rebuilds for r in results],
        "computed_steps": [len(r.compute_s) for r in results],
        "max_snapshot_shard_pause_s": max(durs("snapshot_shard")),
        "max_reshard_shard_pause_s": max(durs("reshard_shard")),
        "reshard_s": durs("reshard"),
        "pause_bound_s": PAUSE_BOUND_S,
        "snapshots": [(e["src"], e["args"]["step"], e["args"]["bytes"],
                       e["dur"]) for e in writes],
        "final_snapshot_bytes_on_disk": snapshot_bytes,
        "reshard_parked": parked, "reshard_replayed": replayed,
        "dssp_extensions": [len(ext["server0"]), len(ext["server1"])],
        "credit_releases": [rm["credit_releases"], fm["credit_releases"]],
        "server_max_memory_allocated_gb": {
            src: last[src]["args"].get("max_memory_allocated", 0) / 1e9
            for src in last},
        "worker_max_memory_allocated_gb":
            [r.peak_memory_bytes / 1e9 for r in results],
        "memory_used_peak_mib": memory_used,
        "trace_events": len(events),
        "summary": {k: v for k, v in summary.items() if k != "dssp"},
        "dssp_decisions": summary["dssp"]["decisions"]}
    say(rec)
    say(f"ft: wall s {wall}, pushes/s {16 / wall}, restart to serve s "
        f"{sp.start_s[1]} (restore {failover[0]['dur']}), largest pauses "
        f"s: snapshot_shard {rec['max_snapshot_shard_pause_s']}, "
        f"reshard_shard {rec['max_reshard_shard_pause_s']} (reference "
        f"bound {PAUSE_BOUND_S}, not enforced), snapshot writes "
        f"(bytes, s) {[(w['args']['bytes'], w['dur']) for w in writes]}, "
        f"server peak GB {rec['server_max_memory_allocated_gb']}, card "
        f"memory.used peak MiB {memory_used}")


def run_ft_paths(torch, api, per_step, *, device: str = "cuda:0"):
    """At smoke size: a worker killed while gated over shmem, push frames
    dropped over tcp, and a server killed inside a live reshard."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import FaultPlan, ServerProcess
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    from repro_torch.wireformat import MSG_PUSH
    # (a) shmem: worker 1 SIGKILLs itself at iteration 2 while worker 0
    # waits on it at the BSP barrier; its seat is freed and the respawn
    # takes it back exactly once (a second seat would hang the barrier)
    tag = "ft (shmem, a worker killed while gated)"
    spec = main_path_spec(api, full=False, workers=2, sync="bsp",
                          transport=api.TransportSpec(kind="shmem"))
    free_device_memory(torch)
    with api.build_session(spec, external_workers=True) as s:
        task = dataclasses.replace(
            WorkerTask.from_spec(spec, 4, device=device),
            fault_plan=FaultPlan(kill_worker=1,
                                 kill_worker_round=2).to_dict())
        pool = ProcessWorkerPool(s.address(), task, 2)
        pool.start()
        try:
            results = pool.join(timeout=600.0, endpoint=s.endpoint,
                                respawn=1)
        finally:
            pool.terminate()
        raise_on_failure(results)
        seats = [list(st.tracker.workers) for st in s.server.shards]
        pushes = dict(s.server.metrics.pushes)
    if (pool.respawned != [1] or [r.iterations_done for r in results]
            != [4, 4] or any(seats) or pushes[0] != 4 or pushes[1] < 4):
        fail(f"{tag}: respawned {pool.respawned}, iterations "
             f"{[r.iterations_done for r in results]}, seats {seats}, "
             f"pushes {pushes}")
    check_worker_launches(tag, results, per_step)
    say({"phase": "ft paths", "run": tag, "respawned": pool.respawned,
         "pushes": pushes})
    # (b) tcp: a quarter of the push frames dropped before they leave the
    # worker; each drop is a dead connection to the worker, which
    # reconnects and sends its iteration again
    tag = "ft (tcp, push frames dropped)"
    spec = main_path_spec(api, full=False, workers=2, sync="dssp",
                          transport=api.TransportSpec(kind="tcp",
                                                      host="127.0.0.1"))
    spec = spec.replace(ft=api.FtSpec(
        reconnect_tries=10, reconnect_base_s=0.05, reconnect_max_s=0.5,
        fault_drop_kind=MSG_PUSH, fault_drop_prob=0.25, fault_seed=3))
    free_device_memory(torch)
    with api.build_session(spec, timeout=600.0) as s:
        m = s.run(16)
        results = s.results
        losses = [l for _, _, l in s.server.metrics.loss_trajectory]
    reconnects = [r.reconnects for r in results]
    if ([r.iterations_done for r in results] != [8, 8] or m["pushes"] != 16
            or not sum(reconnects) or not all(map(math.isfinite, losses))):
        fail(f"{tag}: iterations {[r.iterations_done for r in results]}, "
             f"pushes {m['pushes']}, reconnects {reconnects}, losses "
             f"{losses}")
    check_worker_launches(tag, [dataclasses.replace(
        r, iterations_done=len(r.compute_s)) for r in results], per_step)
    say({"phase": "ft paths", "run": tag, "reconnects": reconnects,
         "computed_steps": [len(r.compute_s) for r in results]})
    # (c) the server SIGKILLed inside its live reshard 4 -> 6: the restart
    # resumes from a pre-migration snapshot, its trigger finishes the
    # move, and no snapshot on disk mixes two plans
    tag = "ft (tcp, server killed mid-reshard)"
    os.makedirs(FT_WORK_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ft-mid-", dir=FT_WORK_DIR)
    spec = ft_spec(api, full=False, ft_dir=os.path.join(work, "ckpt"),
                   snapshot_every_s=0.05, keep=3, reconnect_tries=40,
                   reconnect_base_s=0.2, reconnect_max_s=2.0,
                   reshard_shards=6, reshard_round=8,
                   fault_kill_mid_reshard=True, fault_delay_kind=MSG_PUSH,
                   fault_delay_ms=40.0)
    sp = ServerProcess(spec, device=device, start_timeout=600.0)
    pool = None
    try:
        addr = sp.start()
        pool = ProcessWorkerPool(addr, WorkerTask.from_spec(
            spec, 12, device=device), 2)
        pool.start()
        if not sp.wait_dead(600.0):
            fail(f"{tag}: the mid-migration kill never fired")
        if sp.restart() != addr:
            fail(f"{tag}: the restart moved the address")
        if sp.resumed_step is None:
            fail(f"{tag}: the restart found no snapshot")
        resumed = snapshot_extras(spec.ft.dir, sp.resumed_step)
        results = pool.join(timeout=600.0, endpoint=FailFast(tag))
        raise_on_failure(results)
        sp.stop(timeout=120.0)
        mgr = CheckpointManager(spec.ft.dir, keep=spec.ft.keep)
        plans = [(e["n_shards"], e["reshard_epoch"], len(e["versions"]),
                  len(e["shards"])) for e in map(mgr.peek_extras,
                                                 mgr.steps())]
        final = mgr.peek_extras(mgr.latest_step())
    finally:
        if pool is not None:
            pool.terminate()
        sp.stop(timeout=60.0)
        sp.kill()
        shutil.rmtree(work, ignore_errors=True)
    losses = [l for _, _, l in final["metrics"]["loss_trajectory"]]
    torn = [p for p in plans if not (p[0] == p[2] == p[3] and (
        (p[0] == 4 and p[1] == 0) or (p[0] == 6 and p[1] >= 1)))]
    if ([r.iterations_done for r in results] != [12, 12] or torn
            or resumed["n_shards"] != 4 or final["n_shards"] != 6
            or not all(map(math.isfinite, losses))
            or not all(r.rebuilds for r in results)):
        fail(f"{tag}: iterations {[r.iterations_done for r in results]}, "
             f"resumed {sp.resumed_step} at {resumed['n_shards']} shards, "
             "snapshots (shards, epoch, versions, shard states) "
             f"{plans}, final {final['n_shards']} shards, rebuilds "
             f"{[r.rebuilds for r in results]}")
    check_worker_launches(tag, [dataclasses.replace(
        r, iterations_done=len(r.compute_s)) for r in results], per_step)
    say({"phase": "ft paths", "run": tag, "resumed_step": sp.resumed_step,
         "snapshots": plans, "restart_to_serve_s": sp.start_s[1]})


#: the port's own kernels, by function name (exactly; each norm's one
#: kernel was named <norm>_kernel before its register path, which
#: ``--src`` runs of earlier commits still launch)
KERNEL_NAMES = (("ssm_scan kernel", ("ssm_scan_kernel",)),
                ("rmsnorm kernel", ("rmsnorm_regs", "rmsnorm_loop",
                                    "rmsnorm_kernel")),
                ("residual_rmsnorm kernel", ("residual_rmsnorm_regs",
                                             "residual_rmsnorm_loop",
                                             "residual_rmsnorm_kernel")))
#: everything else, by a part of the name
KERNEL_GROUPS = (("attention kernel (flash_fwd)", ("flash_fwd",)),
                 ("fused_update kernel", ("fused_update",)),
                 ("f32 matmul (unembed backward, plain attention backward)",
                  ("f32f32", "sgemm")),
                 ("bf16 matmul", ("gemm", "nvjet", "sm90_", "cutlass",
                                  "xmma")),
                 ("softmax (plain attention backward)", ("softmax",)))
PLAIN_SCAN_BACKWARD = ("plain ssm_scan backward (recompute and autograd "
                       "through ssm_scan_ref, one CUDA graph replay)")
SLSTM_FORWARD_GROUP = "sLSTM loop forward (one CUDA graph replay)"
SLSTM_BACKWARD_GROUP = ("sLSTM loop backward (recompute and autograd "
                        "through the loop, one CUDA graph replay)")


def range_groups():
    """Profiler ranges whose device spans hold a graph replay, each with
    its group: (range name, group)."""
    from repro_torch.kernels.registry import SSM_SCAN_BACKWARD
    from repro_torch.models.ssm import SLSTM_BACKWARD, SLSTM_FORWARD
    return ((SSM_SCAN_BACKWARD, PLAIN_SCAN_BACKWARD),
            (SLSTM_FORWARD, SLSTM_FORWARD_GROUP),
            (SLSTM_BACKWARD, SLSTM_BACKWARD_GROUP))


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


def profile_step(torch, api, label: str, spec, steps: int = 2, **overrides):
    """Where a training step's time goes: a fresh one-worker session
    (the process is warm from the phase before), ``steps`` steps under
    ``torch.profiler``; device time per kernel group and name, and the
    device's idle share of the wall time of as many untraced steps of
    another fresh session (tracing every CPU op of the worker threads
    slows the host), and of the traced steps.  Kernels that run inside
    the device span of a graph replay's range (``range_groups``: the
    scan's backward, the sLSTM loop's forward and backward) form a
    group of their own: the tracer ties a graph replay's kernels to no
    CPU op, but the span runs from the range's first kernel (copying the
    inputs in) to its last (cloning the outputs), and the stream runs
    the replay between them."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

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
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = {group: [(e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == cuda and e.is_user_annotation
                     and e.name == name]
             for name, group in range_groups()}
    by_name, in_range = {}, {}
    for e in events:
        # CPU ops, and ranges' device spans, are not kernels
        if e.device_type != cuda or e.is_user_annotation:
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3 / steps, n + 1)
        for group, group_spans in spans.items():
            if any(t0 <= e.time_range.start and e.time_range.end <= t1
                   for t0, t1 in group_spans):
                ms_n = in_range.setdefault(group, {}).setdefault(
                    e.name, [0.0, 0])
                ms_n[0] += e.device_time_total / 1e3
                ms_n[1] += 1
                break
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:   # the tracer saw no kernels: a measurement, not a fault
        say({"phase": "profile", "run": label, "step_wall_ms": untraced_ms,
             "traced_step_wall_ms": wall_ms,
             "device_busy_ms": "not measured"})
        return None
    groups = {}
    for name, (ms, _) in by_name.items():
        ms -= sum(k.get(name, (0.0, 0))[0] for k in in_range.values()) / steps
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    for group, kernels in in_range.items():
        groups[group] = sum(ms for ms, _ in kernels.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {"phase": "profile", "run": label, "steps": steps,
         "step_wall_ms": untraced_ms, "traced_step_wall_ms": wall_ms,
         "device_busy_ms": busy, "idle_share": 1.0 - busy / untraced_ms,
         "traced_idle_share": 1.0 - busy / wall_ms,
         "range_kernels_per_step": {
             group: sum(n for _, n in kernels.values()) / steps
             for group, kernels in in_range.items()},
         "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         "top_kernels": [{"name": k[:90], "ms": ms, "calls": n // steps}
                         for k, (ms, n) in top]}
    say(rec)
    return rec


#: kernel checks that ``--only`` can name
CHECKS = ("fused_update", "norms", "flash", "fused_update_batched",
          "fused_compress", "ssm_scan", "quantize_kv", "slstm")


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
    start = time.monotonic()

    def mark(phase: str) -> None:
        """The script's elapsed seconds as ``phase`` begins."""
        say({"elapsed_s": time.monotonic() - start, "next": phase})
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
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_compress as fc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import registry as kreg
    from repro_torch.kernels import residual_rmsnorm as rrn
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import registry, ssm
    from repro_torch.ps.sharded.plan import build_shard_plan

    # -- build -----------------------------------------------------------
    t0 = time.monotonic()
    cuda.library()
    say({"phase": "build", "seconds": time.monotonic() - t0,
         "library": os.path.relpath(cuda.library_path(), ROOT)})
    source = None
    for line in cuda.build_log.splitlines():
        if line.startswith("=="):
            source = line[2:].strip()
        if (line.startswith("==") or "registers" in line or "spill" in line
                or "wgmma" in line):
            say(line.strip())
        # no register spill in the bf16 attention kernel, at any head dim
        if (source == "flash_attention_sm90.cu" and "spill" in line
                and any(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                   line))):
            fail(f"build: {source} spills registers: {line.strip()}")
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

    mark("kernels")
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
        "quantize_kv": lambda: check_quantize_kv(torch),
        "slstm": lambda: check_slstm_graphs(torch, kreg, ssm),
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

    mark("parity, train, profile, server, paths")
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
         "rmsnorm": n_layers * 2 + 1})["launches"]    # + the final norm
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

    mark("jamba")
    # -- jamba parity, hybrid, hybrid profile ----------------------------
    check_parity(torch, api, "jamba smoke (MoE)", lambda kernels:
                 arch_spec(api, JAMBA, smoke=True, workers=1, sync="bsp",
                           kernels=kernels, straggler=1.0))
    cut = hybrid_config()
    groups = cut.n_layers // cut.attn_period
    mamba_slots = groups * (cut.attn_period - 1)
    hybrid = run_train(
        torch, api, "hybrid",
        arch_spec(api, JAMBA, smoke=False, workers=2, sync="dssp"),
        {"ssm_scan": mamba_slots * 2, "flash_attention_fwd": groups * 2,
         "residual_rmsnorm": cut.n_layers * 2,
         "rmsnorm": cut.n_layers * 2 + 1},
        model_config=cut)["launches"]
    launches["ssm_scan"] = hybrid["ssm_scan"]
    graphs = kreg.SCAN_BACKWARD_GRAPHS
    if len(graphs) == 0:
        fail("hybrid: the scan's backward captured no CUDA graph")
    say({"phase": "hybrid", "scan_backward_graphs": graphs.summary(),
         "graph_pool_bytes": graphs.pool_bytes()})
    check_scan_backward_graph(torch, kreg, kref)
    prof = profile_step(torch, api, "hybrid",
                        arch_spec(api, JAMBA, smoke=False, workers=1,
                                  sync="bsp", straggler=1.0),
                        steps=1, model_config=cut)
    # a backward call copies 8 inputs in and clones 5 gradients out; the
    # replay's own kernels must land in its group too
    scan_kernels = (prof or {}).get("range_kernels_per_step", {}).get(
        PLAIN_SCAN_BACKWARD, 0)
    if prof is not None and not scan_kernels > 13 * mamba_slots:
        fail(f"hybrid profile: the scan backward's group holds "
             f"{scan_kernels} kernels a step: the graph replay's kernels "
             "are not attributed to it")
    graphs.clear()      # the later phases do not run the scan

    mark("transport")
    # -- transport, transport paths --------------------------------------
    layers = transport_config().n_layers
    per_step = {"flash_attention_fwd": layers * 2,
                "residual_rmsnorm": layers * 2, "rmsnorm": layers * 2 + 1}
    transport = run_transport(torch, api, per_step)
    smoke = get_smoke_config("h2o-danube-1.8b")
    passes = smoke.n_layers * (2 if smoke.remat == "full" else 1)
    run_transport_paths(torch, api, {"flash_attention_fwd": passes,
                                     "residual_rmsnorm": passes,
                                     "rmsnorm": passes + 1})

    mark("ft")
    # -- ft, ft paths ----------------------------------------------------
    run_ft(torch, api, {"flash_attention_fwd": layers * 2,
                        "residual_rmsnorm": layers * 2,
                        "rmsnorm": layers * 2 + 1})
    run_ft_paths(torch, api, {"flash_attention_fwd": passes,
                              "residual_rmsnorm": passes,
                              "rmsnorm": passes + 1})

    mark("serve")
    # -- serve parity, serve, serve transport ----------------------------
    check_serve_parity(torch)
    serve = run_serve(torch, api, {"flash_attention_fwd": n_layers * 2,
                                   "residual_rmsnorm": n_layers * 2,
                                   "rmsnorm": n_layers * 2 + 1})
    for name in ("fused_update", "rmsnorm", "residual_rmsnorm",
                 "flash_attention_fwd"):
        launches[name] += serve["launches"][name]
    served = run_serve_transport(torch, api, per_step)
    say(f"serve transport: pushes/s {served['pushes_per_s']} with a "
        f"replica (the transport phase's without one: "
        f"{transport['pushes_per_s']}); replica refresh bytes "
        f"{served['replica_refresh_bytes']} in "
        f"{served['replica_refreshes']} refreshes")

    free_device_memory(torch)
    time_xlstm_decode(torch)
    free_device_memory(torch)

    mark("archs")
    # -- the transformer families ------------------------------------------
    for name, n in run_archs(torch, api).items():
        launches[name] += n
    mark("families")
    # -- the recurrent and audio families ----------------------------------
    for name, n in run_families(torch, api).items():
        launches[name] += n

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
    mark("end")
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
