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
           cut to 8 of 24 layers (a 1.44 GB packed pull a frame; see
           ``transport_config``), 8 DSSP steps of 2 worker processes
           (the second 2x slower) over tcp on 127.0.0.1, 4 shards, delta
           pulls; the train phase's checks, with 4 fused_update
           launches a push in this process and each worker process's
           norm and attention launches exactly what its steps imply,
           and every push applied
           on every shard in frames of the plan's size; wall time,
           pushes/s, compute and wire share, frame bytes per push and
           pull, each process's peak memory and the card's memory.used.
           (Its smoke-size paths run in the serve phase, beside serve
           transport.)
  ft       h2o-danube-1.8b at its published widths cut to
           ``FT_LAYERS`` layers, served by a restartable
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
           smoke size, the three at once: a worker killed while gated
           over shmem and respawned, push frames dropped over tcp with
           reconnects, and a server killed inside its reshard that
           resumes untorn
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
  serve    the train configuration (full width cut to ``SERVE_LAYERS``
           layers, 2 trainer threads, the second 2x slower) for 24
           steps while 2 replica threads serve
           16 requests each (prompts of 512, 32 new tokens, batches of
           8, admitted within 4 applied updates once the server has
           applied one): ``run_train``'s checks (arrival staleness up
           to s_upper + 1 in a run this long, no release past s_upper),
           every request served with no violation and a version above 0,
           and the launches of every decode batch, warm-ups included:
           L ``flash_attention_fwd``, L ``residual_rmsnorm`` and L + 1
           + (2L + 1) x 31 ``rmsnorm`` at L layers; requests/s, latency, each replica's
           refreshes and bytes, peaks; then one batch with the card to
           itself: its wall time, the prefill's and a token's time, and
           the device's idle share (``torch.profiler``)
  serve transport
           h2o-danube-1.8b cut to ``SERVE_TRANSPORT_LAYERS`` layers (2
           worker processes over tcp) with 1 spawned replica process
           refreshing each
           second: the same checks, the replica process's launches
           exactly per batch, its refresh bytes, and pushes/s beside the
           transport phase's.  At once, in a process of its own, the
           transport paths at smoke size: shmem with 2 workers, tcp with
           int8 frames, and an inproc endpoint driven by one client of
           that process (each with its own launch checks); then one
           xlstm-125m decode batch (8
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
  spmd     the SPMD engine (``ps.kind='none'``,
           ``repro_torch.launch.train.Trainer``): its smoke parity
           (DSSP, kernels vs plain); then h2o-danube-1.8b at full width
           and depth (bf16, remat, seq 1024, global batch 4) with the
           config's adamw at lr 1e-4, DSSP [1, 4], 8 steps, the
           controller told of a collective 2.5 times the previous step's
           measured time: losses finite, the first batch's loss lower
           after the steps than before, every delay in
           [1, 4] with the warm steps' mean above 1, 48
           ``flash_attention_fwd``, 48 ``residual_rmsnorm`` and 49
           ``rmsnorm`` launches a step, the warm step time and the peak;
           a profile of two SSP steps (the ring's copy and the optimizer
           as groups of their own); then the four examples
           (``repro_torch.examples``) as processes on the card at their
           smoke sizes, all at once: each exits 0 with its closing line
  mesh     the device mesh (``repro_torch.launch.mesh``, ``launch.steps``):
           a one-rank NCCL group and its (1, 1) mesh on (data, model);
           the spmd phase's full-width run with ``rules_for_mesh``
           (h2o-danube's role 'dp': the reference's plain mesh attention,
           no flash kernel) through the mesh step (``make_train_fn``,
           what ``build_train_step`` builds): its checks, with per step
           the rules-free step's ``rmsnorm`` and ``residual_rmsnorm``
           launches and 0 ``flash_attention_fwd``, each step's gathered
           parameters the stored tensors (same ``data_ptr``) and no
           collective or block copy from the session's start on; the
           warm step, peak and (a profile of two SSP steps) idle share
           beside the rules-free run's; then four ranks sharing the card
           over gloo (CUDA tensors; NCCL refuses two ranks on one
           device) on (2, 2) and (2, 1, 2) (pod, data, model) meshes: 4
           steps of ``build_train_step`` at the smoke config (f32,
           momentum, DSSP), gathered parameters and losses within 1e-5 of
           the same bundle on the one-rank mesh, each rank's norm
           launches exact, collectives run; on the pod mesh, local SGD
           with k from ``DsspScheduleController.period`` of a changing
           pod slowdown (at least two periods, each in [1, 4]): the pods'
           replicas equal bit for bit after each sync, apart before it
  dryrun   (a) ``python -m repro_torch.launch.dryrun`` for the train_4k
           cell of every arch on 16 x 16 (qwen1.5-32b's on 2 x 16 x 16
           too) and the prefill_32k cells of the six transformers and
           Jamba, on the host's cores beside (b)-(d) at the lowest
           priority (``DRYRUN_NICE``), every row printed; (b) the
           partitioned train step at qwen1.5-32b's widths cut to one
           layer, one rank then four gloo ranks on (2, 2) and (1, 4),
           each leaf held to its own update, a planted fault caught;
           (c) the partitioned prefill at the same widths, bf16, the
           int8 cache, ``PREFILL_SEQ`` tokens: four gloo ranks on (1, 4)
           and (2, 2) against one rank, tokens equal, cache blocks by
           the serve checks' rule for int8 codes, a planted fault
           (rotary positions from 0) caught; the peaks, collectives and
           norm launches of (b) and (c) beside the dry run's; (d)
           jamba-v0.1-52b at its published widths cut to one period
           group (``hybrid_config``), f32, ``HYB_SEQ`` tokens: one rank
           then four gloo ranks on (2, 2) and (1, 4) as (b), the Mamba
           on channel blocks (``ssm_scan`` on 8192 / m channels), its
           ``ssm_scan`` and norm launches and collectives the dry run's,
           a planted fault (``w_in``'s ``xin`` and ``z`` ranges swapped)
           caught, and its prefill's loss on (1, 4) against one rank's;
           (e) the partitioned decode at (c)'s cut from (c)'s saved
           one-rank prefill cache (``DECODE_STEPS`` teacher-forced
           tokens, a cache of ``PREFILL_SEQ + DECODE_STEPS`` slots):
           rank 0 alone, then four ranks on (2, 2) (the cache's sequence
           over ('data', 'model')) and (1, 4), tokens equal, the last
           logits' vocabulary block and the cache blocks held to the one
           rank's, the combine over the sequence blocks dropped as a
           planted fault that must be caught, collectives and ``rmsnorm``
           launches the dry run's; (f) Jamba's decode on blocks at (d)'s
           cut in bf16 and in f32 from a seeded state of
           ``HYB_DECODE_SLOTS`` KV slots (``DECODE_STEPS`` teacher-forced
           tokens): rank 0 alone, then four ranks on (2, 2) and (1, 4)
           (the Mamba state on channel blocks over 'model'), the last
           logits, the KV blocks (bit for bit but the written slots), the
           conv tails and ``h`` held to the one rank's (f32: tokens
           equal), in bf16 one call more with every sublayer fed the one
           rank's input and held to its output, ``reduce_bcdt`` the
           identity and the Mamba partials rounded to bf16 before their
           sum as planted faults that must be caught, collectives,
           ``rmsnorm`` launches and peaks the dry run's; (b), (c), (e),
           (d) and (f) run in one spawn of the four ranks

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


#: traces of one window before ``device_ms`` gives up (three blind
#: traces of the flush in a row have been seen on the card)
TRACE_TRIES = 6


def device_ms(torch, fn, reps: int = 10, flush=None) -> float:
    """Mean device time of one call of ``fn``: the kernels it launches,
    summed as ``torch.profiler`` traces them (no host time, no gaps).
    With ``flush`` (a buffer larger than the 50 MB L2), the buffer is
    zeroed before every call, so the call reads from device memory, and
    the zeroing's own kernels (named by tracing a few zeroings alone)
    are left out of the sum.  The tracer at times sees no kernel at all
    in a short window (PERF.md §7): a window is traced up to
    ``TRACE_TRIES`` times, and if the tracer still saw no kernel of
    ``fn`` there is no measurement, which fails."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA

    def traced(window, keep, what):
        for _ in range(TRACE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                window()
                torch.cuda.synchronize()
            seen = [e for e in prof.events() if e.device_type == cuda
                    and not e.is_user_annotation and keep(e.name)]
            if seen:
                return seen
        fail(f"device_ms: the profiler saw no kernel of {what} in "
             f"{TRACE_TRIES} traces")

    def zeroings():
        for _ in range(4):
            flush.zero_()

    skip = set()
    if flush is not None:
        skip = {e.name for e in traced(zeroings, lambda name: True,
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
#: the dryrun phase's decode on blocks (part (e)): qwen1.5-32b's two
#: replicated rows, on every rank (``rmsnorm`` only: decode adds its
#: residual plainly)
MESH_DECODE_ROWS = (2, 1, 5120)
#: part (f): Jamba's decode on blocks, the rows of d_model 4096 a rank
#: holds (two on one rank and on (1, 4), one on (2, 2), whose 'data'
#: splits them), in bf16 and f32
HYBRID_DECODE_ROWS = ((2, 1, 4096), (1, 1, 4096))


def check_norms(torch, timer, rn, rrn):
    g = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    #: the dense step's shape (the table's row), the Jamba step's,
    #: serving's (a decode step's rows and a prefill batch), the
    #: transformer families' (ARCH_NORM_ROWS) and xLSTM's
    timed_device = ((4, 1024, 2560), (2, 1024, 4096), SERVE_DECODE_ROWS,
                    SERVE_PREFILL_ROWS) + ARCH_NORM_ROWS + XLSTM_NORM_ROWS \
        + (MESH_DECODE_ROWS,) + HYBRID_DECODE_ROWS
    for dt, shape in ((torch.bfloat16, (4, 1024, 2560)),
                      (torch.bfloat16, (2, 1024, 4096)),
                      (torch.bfloat16, SERVE_DECODE_ROWS),
                      (torch.bfloat16, SERVE_PREFILL_ROWS),
                      *((torch.bfloat16, rows) for rows in ARCH_NORM_ROWS),
                      *((torch.bfloat16, rows) for rows in XLSTM_NORM_ROWS),
                      (torch.bfloat16, MESH_DECODE_ROWS),
                      *((dt, rows) for dt in (torch.bfloat16, torch.float32)
                        for rows in HYBRID_DECODE_ROWS),
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
                    shape in (QK_NORM_ROWS, MESH_DECODE_ROWS)
                    or shape in XLSTM_NORM_ROWS
                    or shape in HYBRID_DECODE_ROWS):
                continue    # the q/k norms, xLSTM's and decode's have
                #             no fused residual
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
    """A smoke config on the card, 4 steps (1 worker, BSP, on the PS
    engines; the SPMD engine's own sync): kernels vs plain
    formulations.  ``spec_of(kernels)`` gives the run's spec."""
    runs = {}
    for kernels in ("auto", "xla"):
        with api.build_session(spec_of(kernels)) as s:
            s.run(4)
            runs[kernels] = (
                s.trainer.log.losses if s.engine == "spmd" else
                [l for _, _, l in s.server.metrics.loss_trajectory])
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
def danube_cut(layers: int):
    """h2o-danube-1.8b at its published widths cut to ``layers`` of its
    24 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("h2o-danube-1.8b"),
                               n_layers=layers)


def dense_per_step(layers: int) -> dict:
    """A dense worker step's kernel launches at ``layers`` layers under
    remat: attention and the fused norm twice a layer (the recompute),
    the norm twice a layer and the final one."""
    return {"flash_attention_fwd": layers * 2,
            "residual_rmsnorm": layers * 2, "rmsnorm": layers * 2 + 1}


def transport_config():
    """h2o-danube-1.8b at its published widths cut to 8 of 24 layers: a
    packed bf16 pull (S=4) of 1,439,260,672 bytes, one frame each way.
    13 layers (2,133,999,616 bytes) is the deepest cut whose pull fits
    the frame protocol's 2 GiB payload limit, but the transport phase
    spends most of its time on the wire, and at 13 layers the script's
    end mark passed its 1200 s limit (PERF.md: NVIDIA H100 80GB HBM3,
    700 W)."""
    return danube_cut(8)


#: the depth of the phases that prove semantics rather than width
#: (PERF.md §4): ft (a snapshot, a live reshard, a kill and a restart),
#: serve (training beside replicas, every decode batch's launches) and
#: serve transport (a replica process beside worker processes).  Their
#: widths stay h2o-danube-1.8b's; the transport phase keeps its 8
#: layers, the wire measure.
FT_LAYERS = 2
SERVE_LAYERS = 4
SERVE_TRANSPORT_LAYERS = 2


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


def transport_paths_main() -> None:
    """``run_transport_paths`` in a process of its own (``python3 -c``
    from ``run_serve_transport_beside_paths``): the kernels the parent
    built, TF32 off as in ``main``; exits non-zero on any failed check."""
    import torch
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.library()
    smoke = get_smoke_config("h2o-danube-1.8b")
    passes = smoke.n_layers * (2 if smoke.remat == "full" else 1)
    run_transport_paths(torch, api, {"flash_attention_fwd": passes,
                                     "residual_rmsnorm": passes,
                                     "rmsnorm": passes + 1})


def run_serve_transport_beside_paths(torch, api, src: str):
    """Serve transport (``run_serve_transport``) and the transport paths
    (``run_transport_paths``) at once, a thread each, as
    ``run_ft_paths`` runs ft's three paths.  Each has an in-process
    server whose kernel launches, trace events and peak memory its
    checks read exactly, so the paths run in a process of their own
    (``transport_paths_main``), the thread waiting on it; every check
    stays as it is.  Returns serve transport's record; each record
    carries its wall seconds."""
    import threading
    recs, errors = {}, []

    def serve():
        t0 = time.monotonic()
        try:
            recs["serve transport"] = dict(run_serve_transport(
                torch, api, dense_per_step(SERVE_TRANSPORT_LAYERS)),
                seconds=time.monotonic() - t0)
        except BaseException as e:      # fail() exits: re-raised below
            errors.append(e)

    def paths():
        t0 = time.monotonic()
        code = (f"import sys; sys.path.insert(0, {os.path.join(ROOT, src)!r})"
                "; import chip_smoke; chip_smoke.transport_paths_main()")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=ROOT),
                              timeout=900)
        recs["transport paths"] = {"phase": "transport paths",
                                   "run": "a process of its own",
                                   "exit": proc.returncode,
                                   "seconds": time.monotonic() - t0}
        if proc.returncode != 0:
            errors.append(RuntimeError(
                f"transport paths: exit {proc.returncode}"))

    free_device_memory(torch)
    threads = [threading.Thread(target=f) for f in (serve, paths)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rec in recs.values():
        say({k: v for k, v in rec.items() if k in ("phase", "run", "exit",
                                                    "seconds")})
    if errors:
        if isinstance(errors[0], RuntimeError):
            fail(str(errors[0]))
        raise errors[0]
    return recs["serve transport"]


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
    with the card to itself.  The configuration is the train phase's
    cut to ``SERVE_LAYERS`` layers (``per_step``: a worker step's
    launches at that depth).  Returns the run's record."""
    cfg = danube_cut(SERVE_LAYERS)
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
                    also=also, extra=extra, arrival_slack=1,
                    model_config=cfg)
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
    """h2o-danube-1.8b cut to ``SERVE_TRANSPORT_LAYERS`` layers trained
    by 2 worker processes over tcp while 1 spawned replica process
    serves from delta pulls (refreshed each second): the serving
    invariants, the replica's launches per batch exactly,
    ``run_train``'s checks (``per_step``: a worker step's launches at
    that depth).  Returns the run's record."""
    cut = danube_cut(SERVE_TRANSPORT_LAYERS)
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


# --------------------------------------------------------------------- spmd
#: the SPMD phase's run: 8 steps of adamw at a learning rate at which
#: the loss on the first batch falls (recomputed after the steps, with
#: the ring's warm-up steps at lr_scale 0 and each update damped by
#: 1/(1 + delay)); each step's own loss is on a new batch, and the
#: batches' losses at init spread more than 8 steps move them
SPMD_STEPS = 8
SPMD_LR = 1e-4
#: the collective the controller is told of: this many times the
#: previous step's measured time (0 before the first step)
SPMD_COLLECTIVE_FACTOR = 2.5
#: the last line each example prints (``repro_torch.examples``)
EXAMPLE_CLOSING = {
    "quickstart": "on a pod the delay hides the gradient all-reduce.",
    "heterogeneous_ps": "while keeping staleness bounded (<= s_U) unlike "
                        "ASP.",
    "train_lm": "rerun with --resume",
    "serve_decode": "OK: train-and-serve over one live parameter server "
                    "works.",
}
EXAMPLE_TIMEOUT_S = 300


def spmd_spec(api, *, full: bool, sync: str = "dssp",
              kernels: str = "auto"):
    """h2o-danube-1.8b on the SPMD engine (``ps.kind='none'``): the
    config's optimizer (adamw) at ``SPMD_LR``, DSSP [1, 4]; full width
    and depth, bf16, remat, seq 1024, global batch 4 (seq 64, f32 at
    smoke size)."""
    return api.RunSpec(
        model=api.ModelSpec(arch="h2o-danube-1.8b", smoke=not full,
                            kernels=kernels),
        data=api.DataSpec(seq_len=1024 if full else 64, global_batch=4),
        optimizer=api.OptimizerSpec(lr=SPMD_LR),
        sync=api.SyncSpec(mode=sync, s_lower=1, s_upper=4))


def run_spmd(torch, api, per_step, *, label: str = "spmd", on_start=None,
             **overrides):
    """``SPMD_STEPS`` steps of the full-width SPMD run through
    ``build_session`` (``overrides`` passed on: ``rules=`` for the mesh
    phase), its controller told of a collective
    ``SPMD_COLLECTIVE_FACTOR`` times the previous step's measured time
    (the reference's ``collective_time_fn`` hook, read from the
    trainer's log): every loss finite, the first batch's loss lower
    after the steps than at the first step,
    every delay in [s_lower, s_upper] and the warm steps' mean delay
    above s_lower, each kernel's launches exactly ``per_step`` a step,
    the peak below 80 GB.  ``on_start(session)`` runs once the session
    has started, before the steps.  Returns the record, with the
    launches."""
    from repro_torch.api.session import batch_tensors
    from repro_torch.data.synthetic import batches
    from repro_torch.models import registry
    from repro_torch.perfcount import LAUNCHES
    spec = spmd_spec(api, full=True)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    step_times = []       # the trainer's log, once the session starts

    def collective_time() -> float:
        return SPMD_COLLECTIVE_FACTOR * step_times[-1] if step_times else 0.0

    session = api.build_session(spec, collective_time_fn=collective_time,
                                **overrides)
    session.start()
    step_times = session.trainer.log.step_times
    if on_start is not None:
        on_start(session)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    t0 = time.monotonic()
    m = session.run(SPMD_STEPS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    trainer = session.trainer
    losses, delays = list(trainer.log.losses), list(trainer.log.delays)
    step_s = list(trainer.log.step_times)
    params = registry.count_params(trainer.cfg)
    # the first batch again, with the trained parameters: the steps'
    # losses are each on another batch, whose spread at init exceeds what
    # 8 steps move
    first = batch_tensors(next(batches(trainer.cfg, trainer.data_cfg)),
                          trainer.device)
    from repro_torch.models.sharding import use_rules
    with torch.no_grad(), use_rules(trainer.rules):
        first_after = float(trainer.loss_fn(trainer.params, first)[0])
    session.close()
    del session, trainer

    lo, hi = spec.sync.s_lower, spec.sync.s_upper
    if (len(losses) != SPMD_STEPS or not all(map(math.isfinite, losses))
            or not first_after < losses[0]):
        fail(f"{label}: losses {losses} (finite), the first batch's "
             f"{losses[0]} -> {first_after} after the steps (must fall); "
             f"delays {delays}")
    warm_delay = statistics.mean(delays[1:])
    if not all(lo <= d <= hi for d in delays) or not warm_delay > lo:
        fail(f"{label}: delays {delays}: each in [{lo}, {hi}], the warm "
             f"steps' mean above {lo}")
    expected = {name: per_step.get(name, 0) * SPMD_STEPS
                for name in launches}
    if launches != expected:
        fail(f"{label}: launches {launches} != expected {expected}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not peak_gb < 80.0:
        fail(f"{label}: peak memory {peak_gb} GB")
    rec = {"phase": label, "steps": SPMD_STEPS, "params": params,
           "optimizer": "adamw", "lr": SPMD_LR, "losses": losses,
           "first_batch_loss_after": first_after,
           "delays": delays, "mean_delay": m["mean_delay"],
           "warm_mean_delay": warm_delay, "step_s": step_s,
           "warm_step_s": statistics.mean(step_s[1:]),
           "warm_step_s_median": statistics.median(step_s[1:]),
           "wall_s": wall, "launches": launches,
           "launches_per_step": {k: v / SPMD_STEPS
                                 for k, v in launches.items()},
           "max_memory_allocated_gb": peak_gb,
           "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    say(rec)
    return rec


def run_examples(src: str):
    """The four examples of ``repro_torch.examples`` as processes on the
    card at their smoke sizes, all started together (train_lm's
    ``--resume`` run after its first): each must exit 0 and end with its
    closing line."""
    import shutil
    import threading
    ckpt = os.path.join(ROOT, "build", "train_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, src))
    chains = {
        "quickstart": [["--smoke"]],
        "heterogeneous_ps": [["--smoke"]],
        "train_lm": [["--preset", "tiny", "--steps", "10",
                      "--checkpoint-dir", ckpt],
                     ["--preset", "tiny", "--steps", "10",
                      "--checkpoint-dir", ckpt, "--resume"]],
        "serve_decode": [[]],
    }
    results = {}

    def run_chain(name, runs):
        for args in runs:
            t0 = time.monotonic()
            try:
                out = subprocess.run(
                    [sys.executable, "-m", f"repro_torch.examples.{name}",
                     *args], env=env, cwd=ROOT, capture_output=True,
                    text=True, timeout=EXAMPLE_TIMEOUT_S)
                rc, stdout, stderr = out.returncode, out.stdout, out.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = "timeout", str(e.stdout), str(e.stderr)
            lines = [l for l in stdout.splitlines() if l.strip()]
            results.setdefault(name, []).append(
                {"args": args, "rc": rc, "seconds": time.monotonic() - t0,
                 "last_line": lines[-1] if lines else "",
                 "stderr_tail": stderr[-1500:] if rc != 0 else ""})
            if rc != 0:
                return

    threads = [threading.Thread(target=run_chain, args=(n, r))
               for n, r in chains.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    shutil.rmtree(ckpt, ignore_errors=True)
    say({"phase": "examples", "runs": results})
    for name, runs in chains.items():
        got = results.get(name, [])
        if len(got) != len(runs) or any(
                r["rc"] != 0 or not r["last_line"].strip().endswith(
                    EXAMPLE_CLOSING[name]) for r in got):
            fail(f"example {name}: {got}")


def run_spmd_phase(torch, api, src: str):
    """(a) the SPMD smoke parity, (b) the full-width run and a profile
    of two SSP steps of it (a fixed delay of 1: the ring's copy and the
    optimizer each a group), (c) the examples.  Returns the full-width
    run's record, with its launches."""
    from repro_torch.configs import get_config
    check_parity(torch, api, "spmd h2o-danube smoke", lambda kernels:
                 spmd_spec(api, full=False, kernels=kernels))
    # 24 layers, remat: 48, 48 and 49 launches a step
    rec = run_spmd(torch, api, arch_launches(get_config("h2o-danube-1.8b")))
    free_device_memory(torch)
    profile_step(torch, api, "spmd", spmd_spec(api, full=True, sync="ssp"))
    free_device_memory(torch)
    run_examples(src)
    return rec


# --------------------------------------------------------------------- mesh
#: the four-rank rehearsal: ranks sharing the card over gloo (NCCL
#: refuses two ranks on one device), the smoke config (f32), these
#: meshes, this many steps of ``build_train_step`` at these delays
MESH_SHAPES = (((2, 2), ("data", "model")),
               ((2, 1, 2), ("pod", "data", "model")))
MESH_DELAYS = (0, 1, 2, 1)
MESH_LR = 1e-3
MESH_TOL = 1e-5
MESH_RANKS = 4
MESH_RANK_TIMEOUT_S = 300.0
#: every rank's tensors, the one-rank group's and the four ranks'
MESH_DEVICE = "cuda:0"
#: the slow pod's step time over the fast one's, a round each: local
#: SGD's period k = ``DsspScheduleController(1, 4).period`` of them
#: (2, 4, 3, 4, 2, 3 rounds' steps)
POD_SLOWDOWNS = (1.0, 1.5, 2.0, 3.0, 1.3, 1.7)


def mesh_bundle_run(torch, mesh):
    """``build_train_step`` on ``mesh`` for the h2o-danube smoke config
    (f32), DSSP with damped momentum at ``MESH_DELAYS``, from the seed-0
    parameters on ``MESH_DEVICE``: the losses, this rank's launches, and
    the gathered parameters as numpy."""
    from repro_torch import tree as tree_util
    from repro_torch.api.session import batch_tensors
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import dssp_spmd
    from repro_torch.data.synthetic import DataConfig, batches
    from repro_torch.launch.mesh import gather, place
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer
    from repro_torch.perfcount import LAUNCHES
    cfg = get_smoke_config("h2o-danube-1.8b")
    opt = make_optimizer("momentum", MESH_LR, staleness_damping=True)
    bundle = build_train_step(cfg, mesh, ShapeSpec("smoke", 64, 4, "train"),
                              sync="dssp", s_upper=3, optimizer=opt)
    p_sh, _, _, b_sh, _ = bundle.in_shardings
    device = MESH_DEVICE
    params = place(registry.init_params(cfg, seed=0, device=device), p_sh,
                   mesh)
    state = opt.init(params)
    pipe = dssp_spmd.init_pipeline(params, 4)
    it = batches(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=4))
    LAUNCHES.reset()
    losses = []
    for d in MESH_DELAYS:
        batch = place(batch_tensors(next(it), device), b_sh, mesh)
        params, state, pipe, m = bundle.fn(params, state, pipe, batch, d)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return {"losses": losses, "launches": LAUNCHES.snapshot(),
            "params": [x.float().cpu().numpy() for x in
                       tree_util.leaves(gather(params, p_sh, mesh))]}


def mesh_rank(rank: int, world: int, shape, axes):
    """One rank of the four-rank rehearsal on the card (gloo, CUDA
    tensors): the bundle run on ``shape``; on a mesh with 'pod', local
    SGD with k from ``DsspScheduleController.period`` of
    ``POD_SLOWDOWNS``: the pods' replicas equal bit for bit after each
    sync and apart before it."""
    import torch
    from repro_torch.core.dssp_spmd import (DsspScheduleController,
                                            cross_pod_sync, local_sgd_step)
    from repro_torch.launch.mesh import all_gather_cat, make_mesh
    from repro_torch.models.sharding import PartitionSpec
    from repro_torch.perfcount import MESH
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, axes)
    MESH.reset()
    out = mesh_bundle_run(torch, mesh)
    out["mesh"] = MESH.snapshot()
    if rank != 0:
        out["params"] = None
    if "pod" not in axes:
        return out
    device = MESH_DEVICE
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((2, 256, 16), generator=gen, device=device)
    y = x @ torch.randn((16, 1), generator=gen, device=device)
    pod = mesh.get_local_rank("pod")
    xb, yb = x[pod], y[pod]
    group = mesh.get_group("pod")
    drifted, synced = [], []

    def train_step(w, opt_state, pipeline, batch, delay):
        live = w.detach().requires_grad_()
        g, = torch.autograd.grad(
            torch.mean((batch[0] @ live - batch[1]) ** 2) / 2, live)
        with torch.no_grad():
            w.sub_(0.1 * g)
        return w, opt_state, pipeline, {}

    def replicas_equal(w):
        both = all_gather_cat(w[None], group, 0)
        return bool(torch.equal(both[0], both[1]))

    def sync(w):
        drifted.append(not replicas_equal(w))
        w = cross_pod_sync(w, mesh, PartitionSpec("pod", None, None))
        synced.append(replicas_equal(w))
        return w

    step = local_sgd_step(train_step, sync)
    ctrl = DsspScheduleController(1, 4)
    w = torch.zeros((16, 1), device=device)
    periods = []
    for slow in POD_SLOWDOWNS:
        k = ctrl.period([1.0, slow])
        periods.append(k)
        for i in range(k):
            w, _, _, _ = step(w, (), (), (xb, yb), 0, i == k - 1)
    out["local_sgd"] = {"periods": periods, "drifted": drifted,
                        "synced_equal": synced}
    return out


def run_mesh_phase(torch, api, spmd_rec):
    """(a) a one-rank NCCL mesh (1, 1) on (data, model) at full width:
    ``build_session`` with ``rules_for_mesh`` on the spmd engine, the
    spmd phase's run (``run_spmd``) through the mesh step
    (``launch.steps.make_train_fn``, the function ``build_train_step``
    builds): its checks, per step the rules-free step's ``rmsnorm`` and
    ``residual_rmsnorm`` launches and no flash attention, each step's
    gathered parameters the stored tensors themselves (same
    ``data_ptr``) and, from the session's start on, no collective and
    no block copy (``perfcount.MESH``);
    a profile of two SSP steps (idle share); then the smoke bundle on
    that mesh, the one-rank answer for (b).  (b) four ranks sharing the
    card over gloo on (2, 2) and on (2, 1, 2) (pod, data, model): the
    bundle's gathered parameters within ``MESH_TOL`` of (a)'s, each
    rank's norm launches, and local SGD's syncs and periods.  Returns
    the launches of (a)'s full-width run."""
    import torch.distributed as dist
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.sharding import rules_for_mesh
    from repro_torch.perfcount import MESH
    t0 = time.monotonic()
    cfg = get_config("h2o-danube-1.8b")
    # a one-rank NCCL group on an in-process store: no port to pick
    mesh_lib.start_group(0, 1, backend="nccl")
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        rules = rules_for_mesh(mesh, sp=cfg.sequence_parallel,
                               role=cfg.model_axis_role)
        per_step = {name: n for name, n in
                    spmd_rec["launches_per_step"].items()
                    if name in ("rmsnorm", "residual_rmsnorm")}
        stored, seen = [], []
        local_grads = steps_lib._local_grads

        def on_start(session):
            stored.extend(x.data_ptr() for x in
                          tree_util.leaves(session.trainer.params))

        def watched(loss_fn, params, *args):
            # the tensors the mesh step's loss reads
            seen.append([x.data_ptr() for x in tree_util.leaves(params)])
            return local_grads(loss_fn, params, *args)

        MESH.reset()        # placing the parameters counts too
        steps_lib._local_grads = watched
        try:
            rec = run_spmd(torch, api, per_step, label="mesh",
                           on_start=on_start, rules=rules)
        finally:
            steps_lib._local_grads = local_grads
        traffic = MESH.snapshot()
        if (len(seen) != SPMD_STEPS or any(s != stored for s in seen)
                or any(traffic.values())):
            fail(f"mesh: {len(seen)} mesh steps of {SPMD_STEPS}, "
                 f"{sum(s != stored for s in seen)} computing with copies, "
                 f"collectives and copies {traffic} on a one-rank mesh")
        free_device_memory(torch)
        prof = profile_step(torch, api, "mesh",
                            spmd_spec(api, full=True, sync="ssp"),
                            rules=rules)
        free_device_memory(torch)
        one = mesh_bundle_run(torch, mesh)
    finally:
        dist.destroy_process_group()
    say({"phase": "mesh one-rank", "attention": rules.attn_mode,
         "role": cfg.model_axis_role, "collectives": traffic,
         "mesh_steps": len(seen),
         "warm_step_s": rec["warm_step_s"],
         "rules_free_warm_step_s": spmd_rec["warm_step_s"],
         "max_memory_allocated_gb": rec["max_memory_allocated_gb"],
         "rules_free_max_memory_allocated_gb":
             spmd_rec["max_memory_allocated_gb"],
         "max_memory_reserved_gb": rec["max_memory_reserved_gb"],
         "idle_share": (prof or {}).get("idle_share", "not measured"),
         "smoke_bundle_losses": one["losses"]})

    # -- four ranks on the card over gloo --------------------------------
    work = os.path.join(ROOT, "build", "mesh")
    os.makedirs(work, exist_ok=True)
    smoke_per_step = {"rmsnorm": 3, "residual_rmsnorm": 2}   # 2 layers
    for shape, axes in MESH_SHAPES:
        t1 = time.monotonic()
        outs = mesh_lib.run_ranks(mesh_rank, MESH_RANKS, work,
                                  args=(shape, axes),
                                  timeout=MESH_RANK_TIMEOUT_S, threads=2)
        err = max(float(abs(a - b).max())
                  for a, b in zip(outs[0]["params"], one["params"]))
        loss_err = max(abs(a - b) for out in outs
                       for a, b in zip(out["losses"], one["losses"]))
        rec4 = {"phase": "mesh four ranks", "mesh": dict(zip(axes, shape)),
                "seconds": time.monotonic() - t1,
                "max_abs_param_err": err, "max_abs_loss_err": loss_err,
                "tol": MESH_TOL,
                "launches": [o["launches"] for o in outs],
                "collectives": [o["mesh"] for o in outs],
                "local_sgd": outs[0].get("local_sgd")}
        say(rec4)
        if not (err <= MESH_TOL and loss_err <= MESH_TOL):
            fail(f"mesh {shape}: parameters {err} / losses {loss_err} "
                 f"from the one-rank run (tol {MESH_TOL})")
        for rank, o in enumerate(outs):
            want = {k: n * len(MESH_DELAYS)
                    for k, n in smoke_per_step.items()}
            got = {k: o["launches"][k] for k in want}
            if got != want or o["launches"]["flash_attention_fwd"]:
                fail(f"mesh {shape} rank {rank}: launches {o['launches']} "
                     f"(want {want}, no flash attention)")
            if not (o["mesh"]["all_gather"] and o["mesh"]["all_reduce"]):
                fail(f"mesh {shape} rank {rank}: no collective ran "
                     f"({o['mesh']})")
            sgd = o.get("local_sgd")
            if sgd is not None and not (
                    all(sgd["synced_equal"]) and all(sgd["drifted"])
                    and len(sgd["drifted"]) == len(POD_SLOWDOWNS)
                    and len(set(sgd["periods"])) >= 2
                    and all(1 <= k <= 4 for k in sgd["periods"])):
                fail(f"mesh {shape} rank {rank}: local SGD {sgd} (at "
                     f"least two periods, each in [1, 4])")
    say({"phase": "mesh", "seconds": time.monotonic() - t0})
    return rec["launches"]


# ------------------------------------------------------------------- dryrun
#: (a): the dry run's train_4k cell on 16 x 16 for every arch, and this
#: arch's on 2 x 16 x 16, and the prefill_32k cell on 16 x 16 of each of
#: DRYRUN_PREFILL, DRYRUN_JOBS CLI processes at a time on the host's
#: cores, the slowest cells first (DRYRUN_FIRST), after every phase that
#: times the card, beside (b), (c) and (d), whose checks (values, counts,
#: launches, peaks) do not depend on the host's load
DRYRUN_MULTI = "qwen1.5-32b"
DRYRUN_FIRST = ("mistral-large-123b", "qwen1.5-110b", "chameleon-34b",
                "qwen1.5-32b")
DRYRUN_JOBS = 6
#: (a)'s processes run at this niceness: the four ranks of (b)-(d) keep
#: the cores they need, and (a) takes the rest
DRYRUN_NICE = 19
#: the archs whose prefill_32k cell (16 x 16) runs partitioned
DRYRUN_PREFILL = ("mistral-large-123b", "qwen1.5-110b", "chameleon-34b",
                  "qwen1.5-32b", "qwen3-moe-235b-a22b", "deepseek-moe-16b",
                  "jamba-v0.1-52b")
DRYRUN_TIMEOUT_S = 600.0
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
#: (b): qwen1.5-32b at its published widths and the train_4k cell's own
#: sequence (4096), cut in depth to PART_LAYERS layer and in batch to
#: PART_BATCH rows in PART_ACCUM microbatch, in f32, so that the one
#: rank (42 GB by the dry run) and four ranks (11 GB each) fit the card
#: in turn; damped momentum (an update proportional to the gradient,
#: where Adafactor's is normalised to the learning rate's size), BSP
#: for PART_STEPS step (a DSSP ring of two slots would add
#: 4.4 GB a rank; the CPU tests hold the ring and microbatches on
#: blocks); one rank, then four ranks sharing the card over gloo on
#: each of PART_SHAPES.  A (2, 2) step moves about 8 GB of collectives
#: through host memory (gloo): about a minute on an H100's host, so one
#: step.  The learning rate is large so that each leaf's update (lr
#: times its gradient, 7e-4 to 2e-2 at this cell) stands far above the
#: f32 rounding of the leaf (a norm scale of 1.0 rounds at 1.2e-7):
#: each leaf's distance from the one rank is held to PART_REL of the
#: one rank's largest update of that leaf, or of PART_FLOOR times the
#: largest update of any leaf where a leaf's own is smaller.  On
#: PART_PLANT the same
#: step runs once more with the 'model' sum of every gradient dropped:
#: the check must fail it.
PART_ARCH = "qwen1.5-32b"
PART_LAYERS = 1
PART_SEQ = 4096
PART_BATCH = 2
PART_ACCUM = 1
PART_STEPS = 1
PART_LR = 1.0
PART_TOL = 1e-5
PART_REL = 1e-2
PART_FLOOR = 1e-3
PART_SHAPES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")))
PART_PLANT = (1, 4)
#: the reference's collective kinds, by ``perfcount.MESH`` field
MESH_KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
              "all_reduce": "all-reduce", "broadcast": "broadcast",
              "all_to_all": "all-to-all"}


class DryRunCells:
    """Part (a) of the dryrun phase: ``python -m
    repro_torch.launch.dryrun`` for each cell, ``DRYRUN_JOBS`` processes
    at a time, from ``start`` on, on a thread of its own; ``collect``
    waits for them.  Every process it started is stopped when the script
    exits."""

    def __init__(self, src: str, archs, nice: int = 0):
        self.src = os.path.join(ROOT, src)
        self.nice = nice
        first = [a for a in DRYRUN_FIRST if a in archs]
        train = ([(a, "single", "train_4k") for a in first]
                 + [(DRYRUN_MULTI, "multi", "train_4k")]
                 + [(a, "single", "train_4k") for a in archs
                    if a not in first])
        prefill = [(a, "single", "prefill_32k") for a in DRYRUN_PREFILL
                   if a in archs]
        self.cells = train[:DRYRUN_JOBS] + prefill + train[DRYRUN_JOBS:]
        self.procs = []
        self.done = {}
        self.thread = None

    def _cmd(self, arch: str, mesh: str, shape: str):
        out = os.path.join(DRYRUN_DIR, f"{arch}-{mesh}-{shape}.json")
        return out, [sys.executable, "-W", "ignore::FutureWarning", "-m",
                     "repro_torch.launch.dryrun", "--arch", arch,
                     "--shape", shape, "--mesh", mesh, "--out", out]

    def start(self) -> None:
        import atexit
        import threading
        os.makedirs(DRYRUN_DIR, exist_ok=True)
        atexit.register(self.stop)
        self.t0 = time.monotonic()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        env = dict(os.environ, PYTHONPATH=self.src, OMP_NUM_THREADS="1")
        pending, running = list(self.cells), []
        while pending or running:
            while pending and len(running) < DRYRUN_JOBS:
                cell = pending.pop(0)
                out, cmd = self._cmd(*cell)
                log = open(out + ".log", "w")
                p = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=ROOT, preexec_fn=(lambda: os.nice(self.nice))
                    if self.nice else None)
                self.procs.append(p)
                running.append((cell, out, p, log, time.monotonic()))
            for item in list(running):
                cell, out, p, log, t = item
                late = time.monotonic() - t > DRYRUN_TIMEOUT_S
                if p.poll() is None and not late:
                    continue
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
                running.remove(item)
                self.done[cell] = (p.returncode, out,
                                   time.monotonic() - t)
            time.sleep(0.5)

    def collect(self) -> list:
        self.thread.join(DRYRUN_TIMEOUT_S * len(self.cells))
        rows = []
        for cell in sorted(self.cells, key=lambda c: (c[2], c[1], c[0])):
            if cell not in self.done:
                fail(f"dryrun {cell}: did not finish")
            rc, out, seconds = self.done[cell]
            if rc != 0 or not os.path.exists(out):
                with open(out + ".log") as f:
                    tail = f.read()[-3000:]
                fail(f"dryrun {cell}: exit {rc}\n{tail}")
            with open(out) as f:
                rep = json.load(f)
            if len(rep) != 1 or rep[0]["status"] != "ok":
                fail(f"dryrun {cell}: {rep}")
            rows.append(dict(rep[0], process_seconds=seconds))
        return rows

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


#: (d): jamba-v0.1-52b at its published widths as ``hybrid_config`` cuts
#: it (one period group: 7 Mamba slots and attention at slot 3, every
#: FFN the dense SwiGLU), f32, HYB_BATCH rows of HYB_SEQ tokens in
#: PART_ACCUM microbatch, one BSP step of damped momentum at PART_LR, as
#: (b): rank 0 alone, then four gloo ranks on each of HYB_SHAPES, each
#: leaf held to its one-rank update by ``part_check``.  Each rank's
#: Mamba runs its block of ``di / m`` channels over the whole sequence,
#: ``ssm_scan`` on (rows, seq, 8192 / m).  On HYB_PLANT the step runs
#: once more with each rank's ``w_in`` column ranges of ``xin`` and
#: ``z`` swapped (the storage layout's trap): the check must fail it.
#: Then the cut's loss over the same rows (``build_prefill_step``), one
#: rank against four on HYB_PLANT, within HYB_LOSS_TOL.  HYB_SEQ is the
#: cell's 4096 cut to the hybrid phase's 1024: at 4096 the four ranks'
#: planted-fault step on (1, 4) runs the card out of memory, and a
#: longer sequence lengthens the phase (PERF.md §4).
HYB_SEQ = 1024
HYB_BATCH = 2
HYB_SHAPES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")))
HYB_PLANT = (1, 4)
HYB_LOSS_TOL = 1e-4
#: the kernels whose launches a step of (b) or (d) holds to the dry
#: run's stand-in calls
PART_KERNELS = ("rmsnorm", "residual_rmsnorm", "ssm_scan")
#: per train part: its arch, mesh shapes, the mesh of its planted fault
#: and the fault
PARTS = {
    "b": (PART_ARCH, PART_SHAPES, PART_PLANT,
          "the 'model' sum of every gradient dropped"),
    "d": (JAMBA, HYB_SHAPES, HYB_PLANT,
          "each rank's w_in column ranges of xin and z swapped"),
}


def part_cell(part: str = "b"):
    """The (b) or (d) cell: its config, shape and optimizer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.optim import make_optimizer
    if part == "b":
        cfg = get_config(PART_ARCH).scaled(
            n_layers=PART_LAYERS, dtype="float32", grad_accum=PART_ACCUM)
        shape = ShapeSpec("train_4k", PART_SEQ, PART_BATCH, "train")
    else:
        cfg = hybrid_config().scaled(dtype="float32",
                                     grad_accum=PART_ACCUM)
        shape = ShapeSpec("train_4k", HYB_SEQ, HYB_BATCH, "train")
    return cfg, shape, make_optimizer("momentum", PART_LR,
                                      staleness_damping=True)


def part_bundle(mesh, part: str = "b"):
    """The cell's config, shape, optimizer and ``build_train_step``
    bundle on ``mesh`` (BSP)."""
    from repro_torch.launch.steps import build_train_step
    cfg, shape, opt = part_cell(part)
    bundle = build_train_step(cfg, mesh, shape, sync="bsp", optimizer=opt)
    return cfg, shape, opt, bundle


def plant_fault(torch, part: str, partition) -> None:
    """The part's planted fault on ``partition`` (``PARTS``)."""
    if part == "b":
        partition.sum_axes = [tuple(a for a in ax if a != "model")
                              for ax in partition.sum_axes]
        return
    channels = partition._channels

    def swapped(x):
        xin, z = channels(x).chunk(2, dim=-1)
        return torch.cat([z, xin], dim=-1)

    partition._channels = swapped


def _part_step(torch, bundle, opt, cfg, shape, device, mesh, p_sh, b_sh):
    """The cell's ``PART_STEPS`` steps from the seed-0 parameters:
    (params, losses, per-step mesh counts, per-step kernel launches,
    the shapes ``ssm_scan`` was launched on)."""
    from unittest import mock
    from repro_torch.api.session import batch_tensors
    from repro_torch.data.synthetic import DataConfig, batches
    from repro_torch.kernels import registry as kreg
    from repro_torch.launch.mesh import place
    from repro_torch.models import registry
    from repro_torch.perfcount import LAUNCHES, MESH
    params = place(registry.init_params(cfg, seed=0, device=device), p_sh,
                   mesh)
    state = opt.init(params)
    it = batches(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=shape.seq_len,
                                 global_batch=shape.global_batch))
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.reset()
    scan, scans = kreg._scan.ssm_scan, set()

    def scan_seen(u, *a, **kw):
        scans.add(tuple(u.shape))
        return scan(u, *a, **kw)

    losses, counts, launches = [], [], []
    with mock.patch.object(kreg._scan, "ssm_scan", scan_seen):
        for _ in range(PART_STEPS):
            rows = place(batch_tensors(next(it), device), b_sh, mesh)
            MESH.reset()
            before = LAUNCHES.snapshot()
            params, state, _, m = bundle.fn(params, state, (), rows, 0)
            counts.append(MESH.snapshot())
            launches.append({k: v for k, v in LAUNCHES.delta(before).items()
                             if v})
            losses.append(float(m["loss"]))
    del state
    torch.cuda.synchronize(device)
    return params, losses, counts, launches, sorted(scans)


def part_rank(mesh, one_path: str, plant: bool, part: str = "b"):
    """One rank of (b) or (d) on ``mesh``: ``PART_STEPS`` steps of the
    cell from the seed-0 parameters on ``MESH_DEVICE``: losses, per-step
    mesh counts and kernel launches, the shapes ``ssm_scan`` ran on, the
    peak of ``max_memory_allocated`` over the steps.  On a one-rank mesh
    it saves its parameters and, per leaf, its largest update
    ``max |p1 - p0|`` to ``one_path``; a rank of a larger mesh returns,
    per leaf, the largest distance of its block from the block of that.
    With ``plant``, the step runs once more from the seed-0 parameters
    with the part's planted fault (``plant_fault``), and its distances
    are returned too."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint.manager import keystr_names
    from repro_torch.launch.mesh import block_view
    from repro_torch.models import registry
    from repro_torch.models.sharding import is_spec
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, shape, opt, bundle = part_bundle(mesh, part)
    p_sh, _, _, b_sh, _ = bundle.in_shardings
    device = MESH_DEVICE
    t0 = time.monotonic()
    params, losses, counts, launches, scans = _part_step(
        torch, bundle, opt, cfg, shape, device, mesh, p_sh, b_sh)
    out = {"losses": losses, "counts": counts, "launches": launches,
           "scan_shapes": scans, "partitioned": bundle.partitioned,
           "seconds": time.monotonic() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "leaves": [name for name, _ in keystr_names(params)]}
    leaves = tree_util.leaves(params)
    if mesh.size() == 1:
        init = tree_util.leaves(registry.init_params(cfg, seed=0,
                                                     device=device))
        update = [float((p - p0).abs().max()) for p, p0 in zip(leaves, init)]
        del init
        t1 = time.monotonic()
        torch.save({"params": [x.cpu() for x in leaves], "update": update},
                   one_path)
        out["update"] = update
        out["save_seconds"] = time.monotonic() - t1
        return out
    one = torch.load(one_path, mmap=True)["params"]
    specs = tree_util.leaves(p_sh, is_leaf=is_spec)

    def distances(leaves):
        return [float((block_view(w, s, mesh) - x.cpu()).abs().max())
                for w, s, x in zip(one, specs, leaves)]

    out["err"] = distances(leaves)
    if plant:
        del params, leaves
        plant_fault(torch, part, bundle.fn.partition)
        planted = _part_step(torch, bundle, opt, cfg, shape, device, mesh,
                             p_sh, b_sh)[0]
        out["planted_err"] = distances(tree_util.leaves(planted))
    return out


def hybrid_prefill_rank(rank: int, one):
    """(d)'s prefill: the cut's loss over its rows
    (``build_prefill_step``), rank 0 alone on the (1, 1) mesh ``one``
    (every rank builds it: a mesh's groups are made by all), then the
    four ranks on blocks on ``HYB_PLANT``: each loss, the rank's wall
    seconds and peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.api.session import batch_tensors
    from repro_torch.data.synthetic import DataConfig, batches
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import registry
    from repro_torch.configs.shapes import ShapeSpec
    cfg, shape, _ = part_cell("d")
    shape = ShapeSpec("prefill", shape.seq_len, shape.global_batch,
                      "prefill")
    device = MESH_DEVICE
    rows = batch_tensors(next(batches(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch))), device)

    def once(mesh):
        bundle = build_prefill_step(cfg, mesh, shape)
        p_sh, b_sh = bundle.in_shardings
        params = place(registry.init_params(cfg, seed=0, device=device),
                       p_sh, mesh)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        loss = float(bundle.fn(params, place(rows, b_sh, mesh)))
        return {"loss": loss, "partitioned": bundle.partitioned,
                "seconds": time.monotonic() - t0,
                "peak_bytes": torch.cuda.max_memory_allocated(device)}

    out = {}
    if rank == 0:
        out["one"] = once(one)
    release(torch)
    dist.barrier()
    shape_, axes = next(s for s in HYB_SHAPES if s[0] == HYB_PLANT)
    out["four"] = once(make_mesh(shape_, axes))
    return out


def part_check(update, err):
    """The leaves whose distance from the one rank breaks (b)'s bound:
    ``PART_REL`` of the one rank's largest update of the leaf, or of
    ``PART_FLOOR`` times the largest update of any leaf where that is
    larger.  ``[(leaf index, distance, bound)]``."""
    floor = PART_FLOOR * max(update)
    out = []
    for i, (u, e) in enumerate(zip(update, err)):
        bound = PART_REL * max(u, floor)
        if not e <= bound:
            out.append((i, e, bound))
    return out


#: (c): qwen1.5-32b's prefill at its published widths, cut in depth to
#: PREFILL_LAYERS layer, bf16, its int8 KV cache, PREFILL_BATCH rows (one
#: a 'data' rank on (2, 2)) of PREFILL_SEQ tokens: the prefill_32k
#: cell's own length, the longest of the cell, which the four ranks fit
#: (the dry run: 9.72 GB a rank on (1, 4), 8.46 on (2, 2), 29.75 GB the
#: one rank; 4 x 9.72 GB of the card's 80).  In ``dryrun_rank``, after
#: (b), the four gloo
#: ranks sharing the card: rank 0 prefills alone on a (1, 1) mesh (the
#: bundle's gather-whole path, no collective), then every rank prefills
#: on blocks on each of PREFILL_SHAPES.  Each rank's greedy tokens must
#: equal the one rank's rows; its cache block is held to the one rank's
#: block as the serve checks hold int8 codes: at most one step apart,
#: at most PREFILL_FLIP_SHARE of them moved, the f32 scales within
#: PREFILL_SCALE_REL of the block's largest.  On PREFILL_PLANT the
#: prefill runs once more with each block's rotary positions taken from
#: 0 instead of its global offset: the check must fail it.
PREFILL_ARCH = "qwen1.5-32b"
PREFILL_LAYERS = 1
PREFILL_SEQ = 32768
PREFILL_BATCH = 2
PREFILL_SHAPES = (((1, 4), ("data", "model")), ((2, 2), ("data", "model")))
PREFILL_PLANT = (1, 4)
PREFILL_FLIP_SHARE = 1e-3
PREFILL_SCALE_REL = 2.0 ** -7


def prefill_cell():
    """The (c) cell: its config and shape."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    cfg = get_config(PREFILL_ARCH).scaled(n_layers=PREFILL_LAYERS,
                                          dtype="bfloat16")
    return cfg, ShapeSpec("prefill_32k", PREFILL_SEQ, PREFILL_BATCH,
                          "prefill")


def _prefill_once(torch, bundle, params, batch, device):
    """One call of the prefill bundle: (tokens, cache, seconds, peak
    bytes, mesh counts, norm launches)."""
    from repro_torch.perfcount import LAUNCHES, MESH
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    MESH.reset()
    before = LAUNCHES.snapshot()
    t0 = time.monotonic()
    tok, cache = bundle.fn(params, batch)
    torch.cuda.synchronize(device)
    return (tok, cache, time.monotonic() - t0,
            torch.cuda.max_memory_allocated(device), MESH.snapshot(),
            {k: v for k, v in LAUNCHES.delta(before).items() if v})


def prefill_compare(torch, tok, cache, one, token_spec, cache_spec, mesh):
    """This rank's tokens and cache blocks against the one rank's
    blocks: whether the tokens are equal, and ``cache_compare``'s
    figures."""
    from repro_torch.launch.mesh import block_view
    want = block_view(one["tokens"], token_spec, mesh)
    return {"tokens_equal": bool(torch.equal(tok.cpu(), want)),
            **cache_compare(torch, cache, one["cache"], cache_spec, mesh)}


def cache_compare(torch, cache, one, cache_spec, mesh) -> dict:
    """Per leaf of this rank's cache blocks against the one rank's cache
    ``one``: the largest code step and the share of codes moved (int8),
    or the largest distance over the block's largest value (the
    scales)."""
    from repro_torch.launch.mesh import block_view
    out = {}
    for k, v in cache.items():
        got = v.cpu()
        ref = block_view(one[k], cache_spec[k], mesh)
        if got.dtype == torch.int8:
            diff = (got.int() - ref.int()).abs()
            out[k] = {"max_step": int(diff.max()),
                      "moved_share": float((diff > 0).float().mean())}
        else:
            out[k] = {"max_rel": float((got - ref).abs().max()
                                       / ref.abs().max())}
    return out


def prefill_check(cmp) -> list:
    """What breaks (c)'s bounds in ``prefill_compare``'s record."""
    out = [] if cmp["tokens_equal"] else ["tokens"]
    for k, c in cmp.items():
        if k == "tokens_equal":
            continue
        if "max_step" in c and not (c["max_step"] <= 1 and
                                    c["moved_share"] <= PREFILL_FLIP_SHARE):
            out.append((k, c))
        if "max_rel" in c and not c["max_rel"] <= PREFILL_SCALE_REL:
            out.append((k, c))
    return out


def prefill_rank(rank: int, world: int, one_path: str):
    """Part (c) on one of four ranks: rank 0's prefill alone on a (1, 1)
    mesh, saved to ``one_path``; then each of ``PREFILL_SHAPES`` on
    blocks, held to the one rank's (``prefill_compare``), and on
    ``PREFILL_PLANT`` once more with the planted fault."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    device = MESH_DEVICE
    cfg, shape = prefill_cell()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).long()
    batch = {"tokens": tokens.to(device), "labels": tokens.to(device)}
    out = {}
    one_mesh = make_mesh((1, 1), ("data", "model"), devices=[0])
    if rank == 0:
        bundle = build_prefill_step(cfg, one_mesh, shape)
        params = registry.init_params(cfg, seed=0, device=device)
        tok, cache, sec, peak, counts, launches = _prefill_once(
            torch, bundle, params, batch, device)
        torch.save({"tokens": tok.cpu(),
                    "cache": {k: v.cpu() for k, v in cache.items()}},
                   one_path)
        out["one"] = {"partitioned": bundle.partitioned, "seconds": sec,
                      "peak_bytes": peak, "counts": counts,
                      "launches": launches, "tokens": tok.tolist()}
        del bundle, params, tok, cache
        release(torch)
    dist.barrier()
    one = torch.load(one_path)
    for shape_, axes in PREFILL_SHAPES:
        mesh = make_mesh(shape_, axes)
        bundle = build_prefill_step(cfg, mesh, shape)
        p_sh, b_sh = bundle.in_shardings
        tok_sh, cache_sh = bundle.out_shardings
        params = place(registry.init_params(cfg, seed=0, device=device),
                       p_sh, mesh)
        rows = place(batch, b_sh, mesh)
        tok, cache, sec, peak, counts, launches = _prefill_once(
            torch, bundle, params, rows, device)
        rec = {"partitioned": bundle.partitioned, "seconds": sec,
               "peak_bytes": peak, "counts": counts, "launches": launches,
               "compare": prefill_compare(torch, tok, cache, one, tok_sh,
                                          cache_sh, mesh)}
        del tok, cache
        if tuple(shape_) == PREFILL_PLANT:
            part = bundle.fn.partition
            part.positions = lambda l, device: torch.arange(
                l // part.m, device=device)
            tok, cache = _prefill_once(torch, bundle, params, rows,
                                       device)[:2]
            rec["planted"] = prefill_compare(torch, tok, cache, one, tok_sh,
                                             cache_sh, mesh)
            del tok, cache
        out["x".join(map(str, shape_))] = rec
        del params, rows, bundle
        release(torch)
    return out


def prefill_predictions() -> dict:
    """The dry run's count of (c)'s cell on a (1, 1) mesh and on each of
    ``PREFILL_SHAPES``, by mesh shape."""
    from repro_torch.launch import dryrun
    cfg, shape = prefill_cell()
    return {tuple(s): dryrun.run_cell(PREFILL_ARCH, "prefill_32k", False,
                                      verbose=False, cfg=cfg, shape=shape,
                                      mesh_shape=s)
            for s in [(1, 1)] + [s for s, _ in PREFILL_SHAPES]}


def prefill_report(outs, preds, seconds: float) -> None:
    """(c)'s records: the four ranks' ``prefill_rank`` results beside the
    dry run's count of each mesh's cell (``prefill_predictions``); fails
    on a broken bound, an uncaught planted fault, collectives or norm
    launches other than the dry run's."""
    norms = ("rmsnorm", "residual_rmsnorm")
    one, pred = outs[0]["one"], preds[(1, 1)]
    say({"phase": "dryrun prefill one rank", "arch": PREFILL_ARCH,
         "cut": f"{PREFILL_LAYERS} layer(s) of the published widths, bf16, "
                f"int8 cache, batch {PREFILL_BATCH} x seq {PREFILL_SEQ}",
         "partitioned": one["partitioned"], "seconds": one["seconds"],
         "peak_gb": one["peak_bytes"] / 1e9,
         "dryrun_peak_gb": pred["peak_gib_per_chip"] * 2**30 / 1e9,
         "launches": one["launches"], "tokens": one["tokens"]})
    for shape_, axes in PREFILL_SHAPES:
        label = "x".join(map(str, shape_))
        pred = preds[tuple(shape_)]
        peak_pred = pred["peak_gib_per_chip"] * 2**30
        recs = [o[label] for o in outs]
        rec = {"phase": "dryrun prefill four ranks",
               "mesh": dict(zip(axes, shape_)),
               "partitioned": [r["partitioned"] for r in recs],
               "seconds": [r["seconds"] for r in recs],
               "peak_gb": [r["peak_bytes"] / 1e9 for r in recs],
               "dryrun_peak_gb": peak_pred / 1e9,
               "peak_gap_gb": [(r["peak_bytes"] - peak_pred) / 1e9
                               for r in recs],
               "collectives": recs[0]["counts"],
               "dryrun_collectives": pred["collective_counts"],
               "launches": recs[0]["launches"],
               "dryrun_kernel_calls": pred["kernel_calls"],
               "compare": [r["compare"] for r in recs],
               "tol": {"code_step": 1, "moved_share": PREFILL_FLIP_SHARE,
                       "scale_rel": PREFILL_SCALE_REL}}
        if tuple(shape_) == PREFILL_PLANT:
            rec["planted_fault"] = {
                "fault": "each block's rotary positions from 0",
                "caught_on_ranks": [i for i, r in enumerate(recs)
                                    if prefill_check(r["planted"])],
                "compare": [r["planted"] for r in recs]}
        say(rec)
        if not all(rec["partitioned"]):
            fail(f"prefill {label}: a rank did not take the partitioned "
                 "prefill")
        broken = [(i, prefill_check(r["compare"]))
                  for i, r in enumerate(recs) if prefill_check(r["compare"])]
        if broken:
            fail(f"prefill {label}: ranks off the one rank's: {broken}")
        if tuple(shape_) == PREFILL_PLANT and \
                not rec["planted_fault"]["caught_on_ranks"]:
            fail(f"prefill {label}: the planted fault passed the check")
        want_norms = {k: v for k, v in pred["kernel_calls"].items()
                      if k in norms}
        for i, r in enumerate(recs):
            got = {MESH_KINDS[k]: v for k, v in r["counts"].items()
                   if k in MESH_KINDS and v}
            if got != pred["collective_counts"]:
                fail(f"prefill {label} rank {i}: collectives {got}, the "
                     f"dry run's {pred['collective_counts']}")
            if r["launches"] != want_norms or not r["launches"]:
                fail(f"prefill {label} rank {i}: launches {r['launches']}, "
                     f"the dry run's {want_norms}")
    say({"phase": "dryrun prefill", "seconds": seconds})


#: (e): qwen1.5-32b's decode on blocks, (c)'s cut (PREFILL_LAYERS
#: layer of the published widths, bf16, the int8 cache, PREFILL_BATCH
#: rows, replicated: ``decode_batch_shard=False``) with a cache of
#: PREFILL_SEQ + DECODE_STEPS slots whose first PREFILL_SEQ hold (c)'s
#: one-rank prefill cache, so no new prefill runs.  DECODE_STEPS tokens
#: are decoded at positions PREFILL_SEQ on, teacher-forced: the first is
#: (c)'s one-rank greedy token, each next the one rank's previous
#: output.  In ``dryrun_rank`` after (c): rank 0 decodes alone on a (1,
#: 1) mesh (the bundle's gather-whole path, no collective), then every
#: rank on blocks on each of DECODE_SHAPES: the cache's sequence over
#: ('data', 'model') on (2, 2) and over 'model' on (1, 4), 8193 slots a
#: rank.  Each rank's tokens must equal the one rank's; its vocabulary
#: block of the last call's logits (taken at ``Partition.greedy``) must
#: lie within DECODE_LOGIT_REL of the block's largest one-rank logit
#: (bf16: a combine in f32 against the one rank's probabilities rounded
#: to bf16 moves hidden values by an ulp here and there); its cache
#: block, the written slots' codes and scales included, is held by (c)'s
#: rule (``prefill_check``).  On DECODE_PLANT the decode runs once more
#: with the combine over the cache's sequence axes dropped (each rank
#: attends over its own block alone): the check must fail it.
DECODE_STEPS = 4
DECODE_SHAPES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")))
DECODE_PLANT = (1, 4)
DECODE_LOGIT_REL = 2.0 ** -7


def decode_cell():
    """The (e) cell: (c)'s config and the decode shape."""
    from repro_torch.configs.shapes import ShapeSpec
    cfg, _ = prefill_cell()
    return cfg, ShapeSpec("decode_32k", PREFILL_SEQ + DECODE_STEPS,
                          PREFILL_BATCH, "decode")


def _decode_calls(torch, bundle, params, cache, first, forced, device,
                  start: int = PREFILL_SEQ):
    """``DECODE_STEPS`` calls of the decode bundle from position
    ``start``: the first fed ``first``, each next ``forced[i]`` or,
    without ``forced``, the previous output.  (tokens a call, cache,
    seconds a call, peak bytes, mesh counts a call, kernel launches a
    call)."""
    from repro_torch.perfcount import LAUNCHES, MESH
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    tokens, counts, launches, secs = [], [], [], []
    token = first
    for i in range(DECODE_STEPS):
        if forced is not None:
            token = forced[i]
        MESH.reset()
        before = LAUNCHES.snapshot()
        t0 = time.monotonic()
        token, cache = bundle.fn(params, token, cache, start + i)
        torch.cuda.synchronize(device)
        secs.append(time.monotonic() - t0)
        counts.append(MESH.snapshot())
        launches.append({k: v for k, v in LAUNCHES.delta(before).items()
                         if v})
        tokens.append(token[:, 0].cpu())
    return (tokens, cache, secs, torch.cuda.max_memory_allocated(device),
            counts, launches)


def decode_compare(torch, tokens, logits, cache, one, token_spec,
                   cache_spec, mesh):
    """This rank's tokens, last logits and cache blocks against the one
    rank's blocks: whether every call's tokens are equal, the logits'
    largest distance over the block's largest one-rank logit, and
    ``cache_compare``'s figures."""
    from repro_torch.launch.mesh import block_view
    from repro_torch.models.sharding import PartitionSpec
    rows = PartitionSpec(*token_spec[:1])
    out = {"tokens_equal": all(
        bool(torch.equal(t, block_view(o, rows, mesh)))
        for t, o in zip(tokens, one["tokens"]))}
    ref = block_view(one["logits"], PartitionSpec(
        rows[0] if len(rows) else None, "model"), mesh)
    out["logits"] = {"max_rel": float((logits - ref).abs().max()
                                      / ref.abs().max())}
    return dict(out, **cache_compare(torch, cache, one["cache"], cache_spec,
                                     mesh))


def decode_check(cmp) -> list:
    """What breaks (e)'s bounds in ``decode_compare``'s record."""
    out = prefill_check({k: v for k, v in cmp.items() if k != "logits"})
    if not cmp["logits"]["max_rel"] <= DECODE_LOGIT_REL:
        out.append(("logits", cmp["logits"]))
    return out


def decode_rank(rank: int, world: int, prefill_path: str,
                one_path: str):
    """Part (e) on one of four ranks: rank 0's decode alone on a (1, 1)
    mesh from (c)'s saved one-rank prefill (``prefill_path``), its
    tokens, last logits and cache saved to ``one_path``; then each of
    ``DECODE_SHAPES`` on blocks, teacher-forced with the one rank's
    tokens and held to its values (``decode_compare``), and on
    ``DECODE_PLANT`` once more with the planted fault."""
    from unittest import mock
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import layers, registry
    torch.backends.cuda.matmul.allow_tf32 = False
    device = MESH_DEVICE
    cfg, shape = decode_cell()
    pre = torch.load(prefill_path)
    first = pre["tokens"].long()[:, None]
    whole = {}
    for k, v in pre["cache"].items():
        w = torch.zeros(v.shape[:2] + (shape.seq_len,) + v.shape[3:],
                        dtype=v.dtype)
        w[:, :, :v.shape[2]] = v
        whole[k] = w
    del pre
    out = {}
    one_mesh = make_mesh((1, 1), ("data", "model"), devices=[0])
    if rank == 0:
        bundle = build_serve_step(cfg, one_mesh, shape)
        params = registry.init_params(cfg, seed=0, device=device)
        cache = {k: v.to(device) for k, v in whole.items()}
        seen = []
        unembed = layers.unembed

        def captured(*a, **kw):
            logits = unembed(*a, **kw)
            seen[:] = [logits[:, -1].float().cpu()]
            return logits

        with mock.patch.object(layers, "unembed", captured):
            tokens, cache, sec, peak, counts, launches = _decode_calls(
                torch, bundle, params, cache, first.to(device), None,
                device)
        torch.save({"tokens": tokens, "logits": seen[0],
                    "cache": {k: v.cpu() for k, v in cache.items()}},
                   one_path)
        out["one"] = {"partitioned": bundle.partitioned, "seconds": sum(sec),
                      "peak_bytes": peak, "counts": counts,
                      "launches": launches,
                      "tokens": [t.tolist() for t in tokens]}
        del bundle, params, cache
        release(torch)
    dist.barrier()
    one = torch.load(one_path)
    forced = [first] + [t[:, None] for t in one["tokens"][:-1]]
    for shape_, axes in DECODE_SHAPES:
        mesh = make_mesh(shape_, axes)
        bundle = build_serve_step(cfg, mesh, shape)
        p_sh, tok_sh, c_sh, _ = bundle.in_shardings
        part = bundle.fn.partition
        params = place(registry.init_params(cfg, seed=0, device=device),
                       p_sh, mesh)
        feed = [place(t, tok_sh, mesh).to(device) for t in forced]
        seen = []
        greedy = part.greedy

        def captured(logits):
            seen[:] = [logits[:, -1].float().cpu()]
            return greedy(logits)

        part.greedy = captured

        def decode():
            cache = {k: v.to(device)
                     for k, v in place(whole, c_sh, mesh).items()}
            tokens, cache, sec, peak, counts, launches = _decode_calls(
                torch, bundle, params, cache, None, feed, device)
            return (decode_compare(torch, tokens, seen[0], cache, one,
                                   tok_sh, c_sh, mesh),
                    sec, peak, counts, launches)

        cmp, sec, peak, counts, launches = decode()
        rec = {"partitioned": bundle.partitioned, "seconds": sum(sec),
               "peak_bytes": peak, "counts": counts, "launches": launches,
               "seq_axes": part.seq_axes, "compare": cmp}
        if tuple(shape_) == DECODE_PLANT:
            part.seq_groups = []
            rec["planted"] = decode()[0]
        out["x".join(map(str, shape_))] = rec
        del params, bundle, part, feed
        release(torch)
    return out


def decode_predictions() -> dict:
    """The dry run's count of (e)'s cell on a (1, 1) mesh and on each of
    ``DECODE_SHAPES``, by mesh shape."""
    from repro_torch.launch import dryrun
    cfg, shape = decode_cell()
    return {tuple(s): dryrun.run_cell(PREFILL_ARCH, "decode_32k", False,
                                      verbose=False, cfg=cfg, shape=shape,
                                      mesh_shape=s)
            for s in [(1, 1)] + [s for s, _ in DECODE_SHAPES]}


def decode_report(outs, preds, seconds: float) -> dict:
    """(e)'s records: the four ranks' ``decode_rank`` results beside the
    dry run's count of each mesh's cell (``decode_predictions``); fails
    on a broken bound, an uncaught planted fault, or a call's
    collectives or ``rmsnorm`` launches other than the dry run's.
    Returns the kernel launches of (e)'s calls, every rank's (the
    planted fault's aside)."""
    norms = ("rmsnorm", "residual_rmsnorm")
    launched = {}

    def add(calls):
        for call in calls:
            for k, v in call.items():
                launched[k] = launched.get(k, 0) + v

    one, pred = outs[0]["one"], preds[(1, 1)]
    add(one["launches"])
    say({"phase": "dryrun decode one rank", "arch": PREFILL_ARCH,
         "cut": f"{PREFILL_LAYERS} layer(s) of the published widths, bf16, "
                f"int8 cache of {PREFILL_SEQ} + {DECODE_STEPS} slots, "
                f"{PREFILL_BATCH} rows, {DECODE_STEPS} tokens",
         "partitioned": one["partitioned"], "seconds": one["seconds"],
         "peak_gb": one["peak_bytes"] / 1e9,
         "dryrun_peak_gb": pred["peak_gib_per_chip"] * 2**30 / 1e9,
         "launches_per_call": one["launches"][0],
         "tokens": one["tokens"]})
    for shape_, axes in DECODE_SHAPES:
        label = "x".join(map(str, shape_))
        pred = preds[tuple(shape_)]
        peak_pred = pred["peak_gib_per_chip"] * 2**30
        recs = [o[label] for o in outs]
        rec = {"phase": "dryrun decode four ranks",
               "mesh": dict(zip(axes, shape_)),
               "partitioned": [r["partitioned"] for r in recs],
               "cache_seq_axes": recs[0]["seq_axes"],
               "seconds": [r["seconds"] for r in recs],
               "call_seconds": [r["seconds"] / DECODE_STEPS for r in recs],
               "peak_gb": [r["peak_bytes"] / 1e9 for r in recs],
               "dryrun_peak_gb": peak_pred / 1e9,
               "peak_gap_gb": [(r["peak_bytes"] - peak_pred) / 1e9
                               for r in recs],
               "collectives_per_call": recs[0]["counts"][0],
               "dryrun_collectives": pred["collective_counts"],
               "launches_per_call": recs[0]["launches"][0],
               "dryrun_kernel_calls": pred["kernel_calls"],
               "compare": [r["compare"] for r in recs],
               "tol": {"tokens": "equal", "logits_rel": DECODE_LOGIT_REL,
                       "code_step": 1, "moved_share": PREFILL_FLIP_SHARE,
                       "scale_rel": PREFILL_SCALE_REL}}
        if tuple(shape_) == DECODE_PLANT:
            planted = [r["planted"] for r in recs]
            rec["planted_fault"] = {
                "fault": "the combine over the cache's sequence axes "
                         "dropped",
                "caught_on_ranks": [i for i, p in enumerate(planted)
                                    if decode_check(p)],
                "logits_rel_over_tol": [p["logits"]["max_rel"]
                                        / DECODE_LOGIT_REL
                                        for p in planted],
                "compare": planted}
        say(rec)
        if not all(rec["partitioned"]):
            fail(f"decode {label}: a rank did not take the partitioned "
                 "decode")
        broken = [(i, decode_check(r["compare"]))
                  for i, r in enumerate(recs) if decode_check(r["compare"])]
        if broken:
            fail(f"decode {label}: ranks off the one rank's: {broken}")
        if tuple(shape_) == DECODE_PLANT and \
                len(rec["planted_fault"]["caught_on_ranks"]) != len(recs):
            fail(f"decode {label}: the planted fault passed the check on "
                 "a rank")
        want_norms = {k: v for k, v in pred["kernel_calls"].items()
                      if k in norms}
        for i, r in enumerate(recs):
            add(r["launches"])
            for call, (c, n) in enumerate(zip(r["counts"], r["launches"])):
                got = {MESH_KINDS[k]: v for k, v in c.items()
                       if k in MESH_KINDS and v}
                if got != pred["collective_counts"]:
                    fail(f"decode {label} rank {i} call {call}: collectives "
                         f"{got}, the dry run's {pred['collective_counts']}")
                if n != want_norms or not n:
                    fail(f"decode {label} rank {i} call {call}: launches "
                         f"{n}, the dry run's {want_norms}")
    say({"phase": "dryrun decode", "seconds": seconds})
    return launched


#: (f): Jamba's decode on blocks, ``hybrid_config``'s cut (one period
#: group of jamba-v0.1-52b at its published widths: 7 Mamba slots and
#: attention at slot 3, dense FFNs; the MoE slots stay out, as four
#: ranks each holding a quarter of 22.5 GB of experts, one layer's 5.64
#: GB gathered whole and the one-rank run leave too little of the card),
#: HYB_DECODE_BATCH rows, a state of HYB_DECODE_SLOTS KV slots
#: (decode_32k's sequence), in each of HYB_DECODE_DTYPES: bf16, the
#: cell's, and f32 on the same values (the parameters made in bf16, the
#: state drawn from N(0, 1) by a ``torch.Generator`` of seed
#: HYB_DECODE_SEED on the card and rounded to bf16, alike on every rank:
#: K/V of every slot, the conv tails and ``h``; the first token drawn on
#: the host).  DECODE_STEPS tokens are decoded from index
#: HYB_DECODE_START, teacher-forced with the one rank's bf16 tokens:
#: rank 0 alone on a (1, 1) mesh, then every rank on blocks on each of
#: DECODE_SHAPES (the rows over 'data' on (2, 2); the KV cache's
#: sequence and the Mamba channels over 'model').  Each rank's tokens,
#: its vocabulary block of the last logits, its written K/V slots, its
#: conv tail and ``h`` blocks are held to the one rank's (the values
#: within HYB_DECODE_BOUNDS of the dtype, of the block's largest
#: one-rank value), the K/V slots no call wrote bit for bit, the
#: collectives, ``rmsnorm`` launches and peaks to the dry run's.  In f32
#: the tokens must be equal and every bound is HYB_DECODE_REL.  In bf16
#: the tokens are printed and the bounds are twice the largest distance
#: measured on an H100 (PERF.md §6, Jamba's decode): once two decodes
#: round one
#: value apart, every later sublayer rounds apart too, and over 8 layers
#: and 4 calls that grows to 3.6e-2-5.5e-2 of the largest logit (a
#: w_out partial rounded to bf16 before its sum lands no further off).
#: So bf16 is also held sublayer by sublayer (``hybrid_decode_forced``):
#: one call more on each mesh, each sublayer fed the one rank's input of
#: its first call and each Mamba sublayer, past its sum over 'model',
#: the one rank's (B, C, dt).  Each Mamba and FFN sublayer's output, and
#: each Mamba sublayer's summed (B, C, dt), must lie within
#: HYB_FORCED_ULPS bf16 ulps of the one rank's and be apart on at most
#: HYB_FORCED_FRAC of its elements (twice the largest reading there: on
#: (1, 4), where ``w_in``'s column blocks round some ``x`` channels
#: apart, 7.5% of a (B, C, dt) and 6.2% of a Mamba output, by up to 6
#: ulps; a w_out or w_bcdt partial rounded to bf16 before its sum puts
#: 37-42% apart, by 21-100 ulps), and that call's token and logits be
#: the one rank's (HYB_DECODE_REL); the attention's output is printed
#: (one element of q rounded apart moves its whole head: 22-26% of the
#: output there).  On DECODE_PLANT each
#: of HYB_PLANTS runs in bf16: ``local_bcdt`` the 4 calls, whose logits
#: must miss by 10 times HYB_DECODE_REL or more; the bf16 roundings the
#: forced call, which must break its check on every rank.
#: cuBLAS's reduced precision bf16 reductions are off in (f), as TF32
#: is: a product then rounds once, as the partition's f32 partials do,
#: and not once a split-K partial.
HYB_DECODE_SLOTS = 32768
HYB_DECODE_BATCH = 2
HYB_DECODE_START = HYB_DECODE_SLOTS - DECODE_STEPS
HYB_DECODE_SEED = 0
HYB_DECODE_DTYPES = ("bfloat16", "float32")
HYB_DECODE_REL = 2.0 ** -7
HYB_DECODE_BOUNDS = {
    "float32": {"logits": HYB_DECODE_REL, "kv": HYB_DECODE_REL,
                "conv": HYB_DECODE_REL, "h": HYB_DECODE_REL},
    "bfloat16": {"logits": 0.11, "kv": 0.052, "conv": 0.082, "h": 0.082},
}
HYB_FORCED_ULPS = 12.0
HYB_FORCED_FRAC = 0.15
#: each planted fault: what it breaks, the dtypes it runs in, and how
#: many times HYB_DECODE_REL its logits must miss by (None: it runs in
#: the forced call and must break that call's check)
HYB_PLANTS = {
    "local_bcdt": ("reduce_bcdt the identity (each rank's B, C and dt "
                   "from its own channels)", ("bfloat16",), 10.0),
    "bf16_out": ("the w_out partials rounded to bf16 before their sum "
                 "over 'model'", ("bfloat16",), None),
    "bf16_bcdt": ("the w_bcdt partials rounded to bf16 before their sum "
                  "over 'model'", ("bfloat16",), None),
}
#: each rank's peak against the dry run's count for its mesh
HYB_DECODE_PEAK_GAP_GB = 1.0


def hybrid_decode_cell(dtype: str = "bfloat16"):
    """The (f) cell in ``dtype``: its config and the decode shape."""
    from repro_torch.configs.shapes import ShapeSpec
    return (hybrid_config().scaled(dtype=dtype),
            ShapeSpec("decode_32k", HYB_DECODE_SLOTS, HYB_DECODE_BATCH,
                      "decode"))


def hybrid_decode_params(torch, cfg, device, specs=None, mesh=None):
    """The seed-0 parameters, made in bf16 (the rank's blocks of
    ``specs`` on ``mesh``), in ``cfg``'s dtype."""
    from repro_torch import tree as tree_util
    from repro_torch.launch.mesh import place
    from repro_torch.models import registry
    params = registry.init_params(cfg.scaled(dtype="bfloat16"), seed=0,
                                  device=device)
    if specs is not None:
        params = place(params, specs, mesh)
    dt = getattr(torch, cfg.dtype)
    return tree_util.tree_map(
        lambda x: x.to(dt) if x.is_floating_point() else x, params)


def hybrid_decode_state(torch, cfg, shape, device):
    """(f)'s seeded whole state on ``device``, every value a bf16 one,
    the same on every rank."""
    from repro_torch import tree as tree_util
    from repro_torch.models import hybrid
    state = hybrid.init_state(cfg, shape.global_batch, shape.seq_len,
                              device=device)
    g = torch.Generator(device=device).manual_seed(HYB_DECODE_SEED)
    for x in tree_util.leaves(state):
        x.copy_(torch.randn(x.shape, generator=g, device=device).to(
            torch.bfloat16))
    return state


def hybrid_decode_first(torch):
    """(f)'s first token (rows, 1), drawn on the host."""
    cfg, shape = hybrid_decode_cell()
    return torch.randint(
        0, cfg.vocab_size, (shape.global_batch, 1),
        generator=torch.Generator().manual_seed(HYB_DECODE_SEED))


def hybrid_decode_plant(torch, part, fault: str) -> None:
    """Plant ``fault`` of HYB_PLANTS in ``part`` (``del`` the hook's
    attribute to take it out)."""
    if fault == "local_bcdt":
        part.reduce_bcdt = lambda t: t
        return
    name = {"bf16_out": "reduce_out", "bf16_bcdt": "reduce_bcdt"}[fault]
    reduce = getattr(part, name)
    setattr(part, name, lambda t: reduce(t.to(torch.bfloat16).float()))


def _rel(a, b) -> float:
    """The largest distance of ``a`` from ``b`` over ``b``'s largest
    magnitude."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max())


def hybrid_decode_compare(torch, tokens, logits, state, one, token_spec,
                          state_spec, mesh):
    """This rank's tokens, last logits and state blocks against the one
    rank's blocks: whether every call's tokens are equal; the logits',
    the conv tails' and ``h``'s largest distance over the block's
    largest one-rank value; per KV leaf whether the slots no call wrote
    are equal, and the written slots' largest distance over their
    largest one-rank value (None where the block holds none)."""
    from repro_torch.launch.mesh import block_view
    from repro_torch.models.sharding import PartitionSpec
    rows = PartitionSpec(*token_spec[:1])
    out = {"tokens_equal": all(
        bool(torch.equal(t, block_view(o, rows, mesh)))
        for t, o in zip(tokens, one["tokens"]))}
    out["logits"] = {"max_rel": _rel(logits, block_view(
        one["logits"], PartitionSpec(rows[0] if len(rows) else None,
                                     "model"), mesh))}
    for name in ("k", "v"):
        spec = state_spec["kv"][name]
        got = state["kv"][name].cpu()
        want = block_view(one["state"]["kv"][name], spec, mesh)
        slots = block_view(torch.arange(HYB_DECODE_SLOTS),
                           PartitionSpec(*spec[2:3]), mesh)
        kept = slots < HYB_DECODE_START
        written = None
        if not bool(kept.all()):
            written = _rel(got[:, :, ~kept], want[:, :, ~kept])
        out[f"kv/{name}"] = {
            "kept_equal": bool(torch.equal(got[:, :, kept],
                                           want[:, :, kept])),
            "written_max_rel": written}
    for name in ("conv", "h"):
        out[f"mamba/{name}"] = {"max_rel": _rel(
            state["mamba"][name].cpu(),
            block_view(one["state"]["mamba"][name],
                       state_spec["mamba"][name], mesh))}
    return out


def hybrid_decode_check(cmp, dtype: str) -> list:
    """What breaks (f)'s bounds in ``hybrid_decode_compare``'s record:
    every value within HYB_DECODE_BOUNDS of ``dtype``, the unwritten K/V
    slots equal, in f32 every call's tokens equal."""
    bound = HYB_DECODE_BOUNDS[dtype]
    out = ([] if cmp["tokens_equal"] or dtype != "float32"
           else ["tokens"])
    for k, c in cmp.items():
        if k == "tokens_equal":
            continue
        leaf = k.split("/")[-1]
        written = c.get("written_max_rel")
        if "kept_equal" in c and not (c["kept_equal"] and (
                written is None or written <= bound["kv"])):
            out.append((k, c))
        if "max_rel" in c and not c["max_rel"] <= bound[leaf]:
            out.append((k, c))
    return out


#: the decode's sublayers, each a hook of ``transformer.Whole`` and of
#: ``partition.Partition`` taking (cfg, h, ...)
HYB_SUBLAYERS = ("decode_attention", "mamba_decode", "ffn")


def _route_sublayers(part, fn):
    """Send each of HYB_SUBLAYERS of ``part`` through ``fn(i, sublayer,
    cfg, h, *rest)``, ``i`` counting the calls from 0 and ``sublayer``
    the hook itself.  Returns what takes the routing out."""
    count = [0]

    def route(hook):
        def routed(cfg, h, *rest):
            count[0] += 1
            return fn(count[0] - 1, hook, cfg, h, *rest)
        return routed

    for name in HYB_SUBLAYERS:
        setattr(part, name, route(getattr(part, name)))
    return lambda: [part.__dict__.pop(n) for n in HYB_SUBLAYERS]


def _first(out):
    """A sublayer's output tensor (``mamba_decode`` and ``ffn`` return
    it first in a tuple)."""
    return out[0] if isinstance(out, tuple) else out


def hybrid_decode_forced_check(rec) -> list:
    """What breaks the forced call's bounds in ``hybrid_decode_forced``'s
    record: its token, its logits, and each Mamba and FFN sublayer's
    output and each Mamba sublayer's (B, C, dt)."""
    out = [] if rec["token_equal"] else ["token"]
    if not rec["logits_max_rel"] <= HYB_DECODE_REL:
        out.append(("logits", rec["logits_max_rel"]))
    for i, r in enumerate(rec["sublayers"]):
        for what in ("out", "bcdt"):
            if r["name"] == "decode_attention" or what not in r:
                continue
            frac, ulps = r[what]
            if not (frac <= HYB_FORCED_FRAC and ulps <= HYB_FORCED_ULPS):
                out.append((i, r["name"], what, frac, ulps))
    return out


def _bf16_apart(torch, got, want) -> list:
    """[share of the elements of ``got`` apart from ``want``, their largest
    distance in bf16 ulps of ``want`` (values below 2^-8 of its largest
    counted at that ulp)]."""
    got, want = got.float().cpu(), want.float().cpu()
    apart = (got - want).abs()
    ulp = bf16_ulp(torch, want, float(want.abs().max()) * 2.0 ** -8)
    return [float((apart > 0).float().mean()), float((apart / ulp).max())]


def _hybrid_one_rank(torch, dtype, forced, device, one_mesh):
    """Rank 0's decode of (f)'s cell in ``dtype`` alone: greedy from the
    first token, or teacher-forced with ``forced``.  (record, saved
    values: tokens, the first and the last call's logits, state, and per
    sublayer of the first call its name, input, output and, for a Mamba
    sublayer, its (B, C, dt): ``sublayers``)."""
    from unittest import mock
    from repro_torch import tree as tree_util
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import layers, ssm
    from repro_torch.models.transformer import WHOLE
    cfg, shape = hybrid_decode_cell(dtype)
    bundle = build_serve_step(cfg, one_mesh, shape)
    params = hybrid_decode_params(torch, cfg, device)
    state = hybrid_decode_state(torch, cfg, shape, device)
    seen, sublayers = [], []
    unembed, matmul = layers.unembed, ssm._matmul

    def captured(*a, **kw):
        logits = unembed(*a, **kw)
        seen.append(logits[:, -1].float().cpu())
        return logits

    def record(i, hook, cfg_, h, *rest):
        if i >= 2 * cfg.n_layers:
            return hook(cfg_, h, *rest)
        bcdt = []

        def spy(x, wt):
            y = matmul(x, wt)
            if wt is rest[0].get("w_bcdt"):
                bcdt.append(y.cpu())
            return y

        with mock.patch.object(ssm, "_matmul", spy):
            out = hook(cfg_, h, *rest)
        sublayers.append({"name": hook.__name__, "in": h.cpu(),
                          "out": _first(out).cpu(),
                          "bcdt": bcdt[0] if bcdt else None})
        return out

    feed = None if forced is None else [t.to(device) for t in forced]
    unroute = _route_sublayers(WHOLE, record)
    try:
        with mock.patch.object(layers, "unembed", captured):
            tokens, state, secs, peak, counts, launches = _decode_calls(
                torch, bundle, params, state,
                hybrid_decode_first(torch).to(device), feed, device,
                HYB_DECODE_START)
    finally:
        unroute()
    rec = {"partitioned": bundle.partitioned, "call_seconds": secs,
           "peak_bytes": peak, "counts": counts, "launches": launches,
           "tokens": [t.tolist() for t in tokens]}
    saved = {"tokens": tokens, "logits": seen[-1], "first_logits": seen[0],
             "sublayers": sublayers,
             "state": tree_util.tree_map(lambda x: x.cpu(), state)}
    return rec, saved


def hybrid_decode_forced(torch, bundle, params, cfg, shape, feed, one,
                         token_spec, state_spec, mesh, device):
    """One call of the mesh's decode from (f)'s first state, each
    sublayer fed the one rank's input of its first call (``one
    ["sublayers"]``, the rank's rows), and each Mamba sublayer, once the
    mesh has summed its (B, C, dt) over 'model' (``reduce_bcdt``), the
    one rank's (B, C, dt): one value of B, C or dt rounded apart moves
    every channel of the sublayer's output, as does one element of q
    every value of its head.  Whether its token equals the one rank's,
    its logits' largest distance over the block's largest one-rank logit,
    and per sublayer its name and ``_bf16_apart`` of its output
    (``out``) and of its summed (B, C, dt) (``bcdt``) from the one
    rank's."""
    from repro_torch.launch.mesh import block_view, place
    from repro_torch.models.sharding import PartitionSpec
    part = bundle.fn.partition
    rows = PartitionSpec(*token_spec[:1])
    found, seen = [], []
    greedy = part.greedy

    def captured(logits):
        seen[:] = [logits[:, -1].float().cpu()]
        return greedy(logits)

    def fed(i, hook, cfg_, h, *rest):
        sub = one["sublayers"][i]
        rec = {"name": sub["name"]}
        planted = part.__dict__.get("reduce_bcdt")
        reduce = part.reduce_bcdt
        if sub["bcdt"] is not None:
            want = block_view(sub["bcdt"], rows, mesh)

            def one_bcdt(t):
                rec["bcdt"] = _bf16_apart(torch, reduce(t).to(want.dtype),
                                          want)
                return want.to(t.device).float()

            part.reduce_bcdt = one_bcdt
        try:
            out = hook(cfg_, block_view(sub["in"], rows, mesh).to(h.device),
                       *rest)
        finally:
            part.__dict__.pop("reduce_bcdt", None)
            if planted is not None:
                part.reduce_bcdt = planted
        rec["out"] = _bf16_apart(torch, _first(out),
                                 block_view(sub["out"], rows, mesh))
        found.append(rec)
        return out

    state = place(hybrid_decode_state(torch, cfg, shape, device),
                  state_spec, mesh)
    part.greedy = captured
    unroute = _route_sublayers(part, fed)
    try:
        token, _ = bundle.fn(params, feed[0], state, HYB_DECODE_START)
    finally:
        unroute()
        part.greedy = greedy
    want = block_view(one["first_logits"], PartitionSpec(
        rows[0] if len(rows) else None, "model"), mesh)
    return {"token_equal": bool(torch.equal(
                token[:, 0].cpu(), block_view(one["tokens"][0], rows,
                                              mesh))),
            "logits_max_rel": _rel(seen[0], want), "sublayers": found}


def hybrid_decode_rank(rank: int, world: int, one_path: str):
    """Part (f) on one of four ranks, cuBLAS's reduced precision bf16
    reductions off.  Rank 0 alone on a (1, 1) mesh: the bf16 decode,
    greedy, then the f32 decode teacher-forced with its tokens, both
    saved to ``one_path``, and how far the bf16 values lie from the f32
    ones (``bf16_vs_f32``, printed only).  Then in each of
    ``HYB_DECODE_DTYPES`` each of ``DECODE_SHAPES`` on blocks,
    teacher-forced with the bf16 tokens and held to the one rank's
    values of that dtype (``hybrid_decode_compare``), in bf16 one call
    more with each sublayer fed the one rank's input
    (``hybrid_decode_forced``), and on ``DECODE_PLANT`` once more with
    each of ``HYB_PLANTS`` of the dtype."""
    import torch
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return _hybrid_decode_rank(torch, rank, one_path)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _hybrid_decode_rank(torch, rank: int, one_path: str):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, place
    from repro_torch.launch.steps import build_serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    device = MESH_DEVICE
    out = {}
    # every rank takes part in making a mesh's groups
    one_mesh = make_mesh((1, 1), ("data", "model"), devices=[0])
    if rank == 0:
        rec, bf16 = _hybrid_one_rank(torch, "bfloat16", None, device,
                                     one_mesh)
        out["one", "bfloat16"] = rec
        release(torch)
        forced = ([hybrid_decode_first(torch)]
                  + [t[:, None] for t in bf16["tokens"][:-1]])
        rec, f32 = _hybrid_one_rank(torch, "float32", forced, device,
                                    one_mesh)
        out["one", "float32"] = rec
        release(torch)
        apart = {"logits": _rel(bf16["logits"], f32["logits"])}
        for leaf in ("conv", "h"):
            apart[f"mamba/{leaf}"] = _rel(bf16["state"]["mamba"][leaf],
                                          f32["state"]["mamba"][leaf])
        for leaf in ("k", "v"):
            apart[f"kv/{leaf}"] = _rel(
                bf16["state"]["kv"][leaf][:, :, HYB_DECODE_START:],
                f32["state"]["kv"][leaf][:, :, HYB_DECODE_START:])
        out["bf16_vs_f32"] = apart
        torch.save({"bfloat16": bf16, "float32": f32}, one_path)
        del bf16, f32
    dist.barrier()
    ones = torch.load(one_path)
    forced = ([hybrid_decode_first(torch)]
              + [t[:, None] for t in ones["bfloat16"]["tokens"][:-1]])
    for dtype in HYB_DECODE_DTYPES:
        cfg, shape = hybrid_decode_cell(dtype)
        one = ones[dtype]
        for shape_, axes in DECODE_SHAPES:
            mesh = make_mesh(shape_, axes)
            bundle = build_serve_step(cfg, mesh, shape)
            p_sh, tok_sh, c_sh, _ = bundle.in_shardings
            part = bundle.fn.partition
            params = hybrid_decode_params(torch, cfg, device, p_sh, mesh)
            feed = [place(t, tok_sh, mesh).to(device) for t in forced]
            seen = []
            greedy = part.greedy

            def captured(logits):
                seen[:] = [logits[:, -1].float().cpu()]
                return greedy(logits)

            part.greedy = captured

            def decode():
                state = place(hybrid_decode_state(torch, cfg, shape,
                                                  device), c_sh, mesh)
                tokens, state, secs, peak, counts, launches = \
                    _decode_calls(torch, bundle, params, state, None, feed,
                                  device, HYB_DECODE_START)
                return (hybrid_decode_compare(torch, tokens, seen[0],
                                              state, one, tok_sh, c_sh,
                                              mesh),
                        secs, peak, counts, launches)

            def forced_call():
                return hybrid_decode_forced(torch, bundle, params, cfg,
                                            shape, feed, one, tok_sh, c_sh,
                                            mesh, device)

            cmp, secs, peak, counts, launches = decode()
            rec = {"partitioned": bundle.partitioned, "call_seconds": secs,
                   "peak_bytes": peak, "counts": counts,
                   "launches": launches, "seq_axes": part.seq_axes,
                   "compare": cmp, "planted": {}}
            if dtype == "bfloat16":
                rec["forced"] = forced_call()
            for fault, (_, dtypes, factor) in HYB_PLANTS.items():
                if tuple(shape_) != DECODE_PLANT or dtype not in dtypes:
                    continue
                hybrid_decode_plant(torch, part, fault)
                rec["planted"][fault] = (decode()[0] if factor is not None
                                         else forced_call())
                part.__dict__.pop("reduce_bcdt", None)
                part.__dict__.pop("reduce_out", None)
            out[dtype, tuple(shape_)] = rec
            del params, bundle, part, feed
            release(torch)
    return out


def hybrid_decode_predictions() -> dict:
    """The dry run's count of (f)'s cell in each of
    ``HYB_DECODE_DTYPES`` on a (1, 1) mesh and on each of
    ``DECODE_SHAPES``, by (dtype, mesh shape)."""
    from repro_torch.launch import dryrun
    out = {}
    for dtype in HYB_DECODE_DTYPES:
        cfg, shape = hybrid_decode_cell(dtype)
        for s in [(1, 1)] + [s for s, _ in DECODE_SHAPES]:
            out[dtype, tuple(s)] = dryrun.run_cell(
                JAMBA, "decode_32k", False, verbose=False, cfg=cfg,
                shape=shape, mesh_shape=s)
    return out


def _warm(secs) -> list:
    """A decode's call seconds but the first (cold) one's."""
    return list(secs[1:])


def hybrid_decode_report(outs, preds, seconds: float) -> dict:
    """(f)'s records: the four ranks' ``hybrid_decode_rank`` results
    beside the dry run's count of each cell
    (``hybrid_decode_predictions``); fails on a broken bound
    (``hybrid_decode_check``, ``hybrid_decode_forced_check``), a planted
    fault of HYB_PLANTS missed by less than its factor times
    HYB_DECODE_REL or passing the forced call's check, a peak more than
    ``HYB_DECODE_PEAK_GAP_GB`` from the dry run's, or a call's
    collectives or ``rmsnorm`` launches other than the dry run's.
    Returns the kernel launches of (f)'s calls, every rank's (the
    planted faults' aside)."""
    launched = {}

    def check_calls(what, recs, pred):
        for i, r in enumerate(recs):
            for call, (c, n) in enumerate(zip(r["counts"], r["launches"])):
                for k, v in n.items():
                    launched[k] = launched.get(k, 0) + v
                got = {MESH_KINDS[k]: v for k, v in c.items()
                       if k in MESH_KINDS and v}
                if got != pred["collective_counts"]:
                    fail(f"hybrid decode {what} rank {i} call {call}: "
                         f"collectives {got}, the dry run's "
                         f"{pred['collective_counts']}")
                if n != pred["kernel_calls"] or not n:
                    fail(f"hybrid decode {what} rank {i} call {call}: "
                         f"launches {n}, the dry run's "
                         f"{pred['kernel_calls']}")
            gap = (r["peak_bytes"]
                   - pred["peak_gib_per_chip"] * 2**30) / 1e9
            if abs(gap) > HYB_DECODE_PEAK_GAP_GB:
                fail(f"hybrid decode {what} rank {i}: peak "
                     f"{r['peak_bytes'] / 1e9} GB, {gap} GB from the dry "
                     "run's")

    cfg, shape = hybrid_decode_cell()
    for dtype in HYB_DECODE_DTYPES:
        one, pred = outs[0]["one", dtype], preds[dtype, (1, 1)]
        say({"phase": "dryrun hybrid decode one rank", "arch": JAMBA,
             "dtype": dtype,
             "cut": f"{cfg.n_layers} layers (one period group) of the "
                    f"published widths, dense FFNs, a state of "
                    f"{HYB_DECODE_SLOTS} KV slots, {HYB_DECODE_BATCH} "
                    f"rows, {DECODE_STEPS} tokens from {HYB_DECODE_START}",
             "partitioned": one["partitioned"],
             "seconds": sum(one["call_seconds"]),
             "warm_call_seconds": _warm(one["call_seconds"]),
             "peak_gb": one["peak_bytes"] / 1e9,
             "dryrun_peak_gb": pred["peak_gib_per_chip"] * 2**30 / 1e9,
             "launches_per_call": one["launches"][0],
             "dryrun_kernel_calls": pred["kernel_calls"],
             "tokens": one["tokens"],
             "bf16_vs_f32": (outs[0]["bf16_vs_f32"]
                             if dtype == "bfloat16" else None)})
        check_calls(f"{dtype} 1x1", [one], pred)
        for shape_, axes in DECODE_SHAPES:
            label = f"{dtype} " + "x".join(map(str, shape_))
            pred = preds[dtype, tuple(shape_)]
            peak_pred = pred["peak_gib_per_chip"] * 2**30
            recs = [o[dtype, tuple(shape_)] for o in outs]
            rec = {"phase": "dryrun hybrid decode four ranks",
                   "dtype": dtype, "mesh": dict(zip(axes, shape_)),
                   "partitioned": [r["partitioned"] for r in recs],
                   "cache_seq_axes": recs[0]["seq_axes"],
                   "seconds": [sum(r["call_seconds"]) for r in recs],
                   "warm_call_seconds": [_warm(r["call_seconds"])
                                         for r in recs],
                   "peak_gb": [r["peak_bytes"] / 1e9 for r in recs],
                   "dryrun_peak_gb": peak_pred / 1e9,
                   "peak_gap_gb": [(r["peak_bytes"] - peak_pred) / 1e9
                                   for r in recs],
                   "collectives_per_call": recs[0]["counts"][0],
                   "dryrun_collectives": pred["collective_counts"],
                   "launches_per_call": recs[0]["launches"][0],
                   "dryrun_kernel_calls": pred["kernel_calls"],
                   "compare": [r["compare"] for r in recs],
                   "tol": {"tokens": ("equal" if dtype == "float32"
                                      else "printed"),
                           "rel": HYB_DECODE_BOUNDS[dtype],
                           "kv_kept": "bit for bit",
                           "forced": (None if dtype == "float32" else {
                               "ulps": HYB_FORCED_ULPS,
                               "frac": HYB_FORCED_FRAC,
                               "logits": HYB_DECODE_REL})}}
            planted = {}
            for fault in recs[0]["planted"]:
                what, _, factor = HYB_PLANTS[fault]
                got = [r["planted"][fault] for r in recs]
                if factor is None:
                    planted[fault] = {
                        "fault": what, "in": "the forced call",
                        "broken": [hybrid_decode_forced_check(g)
                                   for g in got],
                        "logits_rel": [g["logits_max_rel"] for g in got],
                        "sublayers": [g["sublayers"] for g in got]}
                    continue
                rels = [g["logits"]["max_rel"] for g in got]
                planted[fault] = {
                    "fault": what, "logits_rel": rels,
                    "over_tol": [p / HYB_DECODE_REL for p in rels],
                    "must_exceed": factor, "compare": got}
            if planted:
                rec["planted_faults"] = planted
            if dtype == "bfloat16":
                rec["forced"] = [r["forced"] for r in recs]
            say(rec)
            if not all(rec["partitioned"]):
                fail(f"hybrid decode {label}: a rank did not take the "
                     "partitioned decode")
            broken = [(i, hybrid_decode_check(r["compare"], dtype))
                      for i, r in enumerate(recs)]
            broken += [(i, "forced", hybrid_decode_forced_check(f))
                       for i, f in enumerate(rec.get("forced", []))]
            broken = [b for b in broken if b[-1]]
            if broken:
                fail(f"hybrid decode {label}: ranks off the one rank's: "
                     f"{broken}")
            for fault, p in planted.items():
                if "broken" in p:
                    if not all(p["broken"]):
                        fail(f"hybrid decode {label}: the planted fault "
                             f"{fault} passed the forced call's check on "
                             "a rank")
                elif not min(p["over_tol"]) >= p["must_exceed"]:
                    fail(f"hybrid decode {label}: the planted fault "
                         f"{fault} missed by {min(p['logits_rel'])}, less "
                         f"than {p['must_exceed']} times {HYB_DECODE_REL}")
            check_calls(label, recs, pred)
    say({"phase": "dryrun hybrid decode", "seconds": seconds})
    return launched


#: the one spawn of four ranks that runs (b)-(e): its time limit
DRYRUN_RANK_TIMEOUT_S = 900.0


def dryrun_rank(rank: int, world: int, part_path: str, prefill_path: str,
                hybrid_path: str, decode_path: str, hybrid_decode_path: str):
    """(b)-(f) on one of four ranks sharing the card, in one spawn:
    (b)'s one-rank step on rank 0 alone (a (1, 1) mesh; the others
    wait), (b) on each of ``PART_SHAPES`` (``part_rank``), then (c)
    (``prefill_rank``), then (e) from (c)'s saved prefill
    (``decode_rank``), then (d) as (b) on ``HYB_SHAPES`` and its prefill
    (``hybrid_prefill_rank``), then (f) (``hybrid_decode_rank``).
    Between them every rank frees what the part left (``release``), so
    that four ranks fit the card as they did in spawns of their own.
    Returns each part's record, the bytes the rank kept reserved after
    each (``reserved``), the bytes of pinned host exchange segments it
    mapped then (``exchange``) and the parts' wall seconds
    (``b_seconds``, ``c_seconds``, ``e_seconds``, ``d_seconds``,
    ``f_seconds``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_exchange_bytes, make_mesh
    t0 = time.monotonic()
    out = {"reserved": [], "exchange": []}

    def freed() -> None:
        out["reserved"].append(release(torch))
        out["exchange"].append(host_exchange_bytes())
    one = make_mesh((1, 1), ("data", "model"), devices=[0])

    def progress(what: str) -> None:
        """A line on standard error as each piece starts: where a rank
        was when the spawn's time limit cut it."""
        print(json.dumps({"dryrun_rank": rank, "starts": what,
                          "s": time.monotonic() - t0}), file=sys.stderr,
              flush=True)

    def train_part(part: str, path: str) -> None:
        _, shapes, plant, _ = PARTS[part]
        if rank == 0:
            progress(f"({part}) one rank")
            out[part, "one"] = part_rank(one, path, False, part)
        freed()
        dist.barrier()
        for shape, axes in shapes:
            progress(f"({part}) {shape}")
            out[part, tuple(shape)] = part_rank(
                make_mesh(shape, axes), path, tuple(shape) == plant, part)
            freed()
        dist.barrier()
        if rank == 0:
            os.unlink(path)

    train_part("b", part_path)
    t1 = time.monotonic()
    progress("(c)")
    out["prefill"] = prefill_rank(rank, world, prefill_path)
    freed()
    t2 = time.monotonic()
    progress("(e)")
    out["decode"] = decode_rank(rank, world, prefill_path, decode_path)
    freed()
    t3 = time.monotonic()
    train_part("d", hybrid_path)
    progress("(d) prefill")
    out["d_prefill"] = hybrid_prefill_rank(rank, one)
    freed()
    t4 = time.monotonic()
    progress("(f)")
    out["hybrid_decode"] = hybrid_decode_rank(rank, world,
                                              hybrid_decode_path)
    freed()
    out["b_seconds"], out["c_seconds"] = t1 - t0, t2 - t1
    out["e_seconds"], out["d_seconds"] = t3 - t2, t4 - t3
    out["f_seconds"] = time.monotonic() - t4
    return out


def release(torch) -> int:
    """Free the device memory that a finished part left to the garbage
    collector, the scan backward's CUDA graphs and the allocator's
    cache; the bytes still reserved.  The host exchanges' segments
    (``launch.mesh``) stay mapped and pinned for the next part, whose
    groups have the same ranks (``dryrun_rank`` reports their bytes
    after each part)."""
    import gc
    from repro_torch.kernels import registry as kreg
    kreg.SCAN_BACKWARD_GRAPHS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(MESH_DEVICE)


def part_predictions(part: str) -> dict:
    """The dry run's count of the (b) or (d) cell on a (1, 1) mesh and on
    each of its mesh shapes, by mesh shape."""
    from repro_torch.launch import dryrun
    arch, shapes, _, _ = PARTS[part]
    cfg, shape, opt = part_cell(part)
    return {tuple(s): dryrun.run_cell(arch, "train_4k", False, "bsp",
                                      verbose=False, cfg=cfg, shape=shape,
                                      mesh_shape=s, optimizer=opt)
            for s in [(1, 1)] + [s for s, _ in shapes]}


def part_report(ranks, part: str, preds) -> dict:
    """(b)'s or (d)'s records: the four ranks' ``part_rank`` results
    beside the dry run's count of each mesh's cell
    (``part_predictions``); fails where a rank did not take the
    partitioned step, a leaf breaks ``part_check`` or a loss
    ``PART_TOL``, the planted fault passes, or a step's collectives or
    ``PART_KERNELS`` launches are not the dry run's.  Returns the
    kernel launches of the part's steps, every rank's (the planted
    fault's steps aside)."""
    arch, shapes, plant_shape, fault = PARTS[part]
    cfg, cell, _ = part_cell(part)
    one = ranks[0][part, "one"]
    update = one["update"]
    launched = {}

    def add(steps):
        for step in steps:
            for k, v in step.items():
                launched[k] = launched.get(k, 0) + v

    add(one["launches"])
    say({"phase": f"dryrun ({part}) one rank", "arch": arch,
         "cut": f"{cfg.n_layers} layer(s) of the published widths, "
                f"f32, batch {cell.global_batch} x seq {cell.seq_len}, "
                f"{PART_ACCUM} microbatches, lr {PART_LR}",
         "losses": one["losses"], "partitioned": one["partitioned"],
         "peak_gb": one["peak_bytes"] / 1e9,
         "dryrun_peak_gb": preds[(1, 1)]["peak_gib_per_chip"] * 2**30 / 1e9,
         "scan_shapes": one["scan_shapes"],
         "launches_per_step": one["launches"][0],
         "max_abs_update": dict(zip(one["leaves"], update)),
         "seconds": one["seconds"], "save_seconds": one["save_seconds"]})
    for shape, axes in shapes:
        pred = preds[tuple(shape)]
        plant = tuple(shape) == plant_shape
        outs = [r[part, tuple(shape)] for r in ranks]
        err = [max(o["err"][i] for o in outs)
               for i in range(len(update))]
        peak_pred = pred["peak_gib_per_chip"] * 2**30
        rec = {"phase": f"dryrun ({part}) four ranks", "arch": arch,
               "mesh": dict(zip(axes, shape)),
               "seconds": max(o["seconds"] for o in outs),
               "max_abs_param_err": max(err),
               "err_over_update": {
                   name: e / u if u else None
                   for name, e, u in zip(one["leaves"], err, update)},
               "max_abs_loss_err": max(abs(a - b) for o in outs
                                       for a, b in zip(o["losses"],
                                                       one["losses"])),
               "tol": {"loss": PART_TOL, "rel": PART_REL,
                       "floor": PART_FLOOR},
               "peak_gb": [o["peak_bytes"] / 1e9 for o in outs],
               "dryrun_peak_gb": peak_pred / 1e9,
               "peak_gap_gb": [(o["peak_bytes"] - peak_pred) / 1e9
                               for o in outs],
               "dryrun_argument_gb": pred["argument_gib_per_chip"]
               * 2**30 / 1e9,
               "collectives_per_step": outs[0]["counts"][0],
               "dryrun_collectives": pred["collective_counts"],
               "launches_per_step": outs[0]["launches"][0],
               "dryrun_kernel_calls": pred["kernel_calls"],
               "scan_shapes": [o["scan_shapes"] for o in outs],
               "step_seconds": [o["seconds"] / PART_STEPS
                                for o in outs]}
        broken = part_check(update, err)
        if plant:
            planted = [max(o["planted_err"][i] for o in outs)
                       for i in range(len(update))]
            caught = part_check(update, planted)
            rec["planted_fault"] = {
                "fault": fault,
                "leaves_caught": [one["leaves"][i] for i, _, _ in caught],
                "max_err_over_update": max(
                    e / u for e, u in zip(planted, update) if u)}
        say(rec)
        if not all(o["partitioned"] for o in outs):
            fail(f"dryrun ({part}) {shape}: a rank did not take the "
                 "partitioned step")
        if broken or not rec["max_abs_loss_err"] <= PART_TOL:
            fail(f"dryrun ({part}) {shape}: leaves from the one-rank step "
                 f"{[(one['leaves'][i], e, b) for i, e, b in broken]}"
                 f" / losses {rec['max_abs_loss_err']} (tol "
                 f"{PART_TOL})")
        if plant and not caught:
            fail(f"dryrun ({part}) {shape}: the planted fault passed the "
                 "check")
        kernels = {k: v for k, v in pred["kernel_calls"].items()
                   if k in PART_KERNELS}
        for rank, o in enumerate(outs):
            add(o["launches"])
            for step, (c, n) in enumerate(zip(o["counts"],
                                              o["launches"])):
                got = {MESH_KINDS[k]: v for k, v in c.items()
                       if k in MESH_KINDS and v}
                if got != pred["collective_counts"]:
                    fail(f"dryrun ({part}) {shape} rank {rank} step "
                         f"{step}: collectives {got}, the dry run's "
                         f"{pred['collective_counts']}")
                if n != kernels or not n:
                    fail(f"dryrun ({part}) {shape} rank {rank} step "
                         f"{step}: launches {n}, the dry run's {kernels}")
    return launched


def hybrid_prefill_report(ranks) -> None:
    """(d)'s prefill: every rank's loss on ``HYB_PLANT`` within
    ``HYB_LOSS_TOL`` of rank 0's alone, on blocks."""
    one = ranks[0]["d_prefill"]["one"]
    four = [r["d_prefill"]["four"] for r in ranks]
    rec = {"phase": "dryrun (d) prefill", "arch": JAMBA,
           "mesh": dict(zip(("data", "model"), HYB_PLANT)),
           "one_rank": one, "four_ranks": four,
           "max_abs_loss_err": max(abs(f["loss"] - one["loss"])
                                   for f in four),
           "tol": HYB_LOSS_TOL}
    say(rec)
    if not all(f["partitioned"] for f in four):
        fail("dryrun (d) prefill: a rank did not take the partitioned "
             "prefill")
    if not rec["max_abs_loss_err"] <= HYB_LOSS_TOL:
        fail(f"dryrun (d) prefill: loss {rec['max_abs_loss_err']} from "
             f"the one rank's (tol {HYB_LOSS_TOL})")


def run_dryrun_phase(torch, src: str):
    """(a) the dry run's production cells, each row printed, any error
    fails: started first, on the host's cores beside (b), (c) and (d),
    at the lowest priority (``DRYRUN_NICE``), so that the card's ranks
    keep the cores they need.  (b)
    the partitioned step on the card: ``PART_ARCH`` cut to
    ``PART_LAYERS`` layers at its published widths, one rank, then four
    ranks sharing the card over gloo on each of ``PART_SHAPES``: losses
    within ``PART_TOL`` of the one rank's, every leaf by ``part_check``
    (and on ``PART_PLANT`` a planted fault that it must catch); each
    rank's ``max_memory_allocated`` beside the dry run's peak for the
    same cell on a fake mesh of that shape, the gap printed; each rank's
    collective counts per step equal to the dry run's; each rank's norm
    launches per step equal to the dry run's stand-in calls.  (c) the
    partitioned prefill (``prefill_rank``, ``prefill_report``).  (d)
    Jamba's partitioned step as (b), ``ssm_scan`` on channel blocks
    among the launches held to the dry run's, and its prefill
    (``hybrid_prefill_report``).  (b), (c) and (d) run in one spawn of
    four ranks (``dryrun_rank``): the dry run's counts are made on a
    thread beside it, the checks after it.  (e) the partitioned decode
    (``decode_rank``, ``decode_report``), in the same spawn after (c);
    (f) Jamba's (``hybrid_decode_rank``, ``hybrid_decode_report``) after
    (d).  Returns the kernel launches of (d)'s steps (``part_report``)
    and (e)'s and (f)'s calls."""
    import threading
    from repro_torch.configs import arch_names
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.monotonic()
    cells = DryRunCells(src, arch_names(), nice=DRYRUN_NICE)
    cells.start()

    work = os.path.join(ROOT, "build", "dryrun")
    one_path = os.path.join(work, "one_rank_params.pt")
    prefill_path = os.path.join(work, "prefill_one_rank.pt")
    hybrid_path = os.path.join(work, "hybrid_one_rank_params.pt")
    decode_path = os.path.join(work, "decode_one_rank.pt")
    hybrid_decode_path = os.path.join(work, "hybrid_decode_one_rank.pt")
    paths = (one_path, prefill_path, hybrid_path, decode_path,
             hybrid_decode_path)
    preds = {}

    def predict():
        try:
            preds["b"] = part_predictions("b")
            preds["c"] = prefill_predictions()
            preds["e"] = decode_predictions()
            preds["d"] = part_predictions("d")
            preds["f"] = hybrid_decode_predictions()
        except BaseException as e:        # re-raised after the spawn
            preds["error"] = e

    thread = threading.Thread(target=predict)
    thread.start()
    try:
        t1 = time.monotonic()
        ranks = mesh_lib.run_ranks(dryrun_rank, 4, work, args=paths,
                                   timeout=DRYRUN_RANK_TIMEOUT_S, threads=2)
    finally:
        thread.join()
        for path in paths:
            if os.path.exists(path):
                os.unlink(path)
    if "error" in preds:
        raise preds["error"]
    say({"phase": "dryrun ranks", "seconds": time.monotonic() - t1,
         "b_seconds": ranks[0]["b_seconds"],
         "c_seconds": ranks[0]["c_seconds"],
         "e_seconds": ranks[0]["e_seconds"],
         "d_seconds": ranks[0]["d_seconds"],
         "f_seconds": ranks[0]["f_seconds"],
         "reserved_gb_after_parts": [[b / 1e9 for b in r["reserved"]]
                                     for r in ranks],
         "exchange_gb_after_parts": [[b / 1e9 for b in r["exchange"]]
                                     for r in ranks]})
    part_report(ranks, "b", preds["b"])
    prefill_report([r["prefill"] for r in ranks], preds["c"],
                   ranks[0]["c_seconds"])
    decoded = decode_report([r["decode"] for r in ranks], preds["e"],
                            ranks[0]["e_seconds"])
    launched = part_report(ranks, "d", preds["d"])
    hybrid_prefill_report(ranks)
    hybrid = hybrid_decode_report([r["hybrid_decode"] for r in ranks],
                                  preds["f"], ranks[0]["f_seconds"])
    for calls in (decoded, hybrid):
        for name, n in calls.items():
            launched[name] = launched.get(name, 0) + n

    rows = cells.collect()
    for r in rows:
        say({"phase": "dryrun", "arch": r["arch"], "mesh": r["mesh"],
             "shape": r["shape"],
             "partitioned": r["partitioned"], "fit": r["fit"],
             "fits_hbm": r["fits_hbm"],
             "argument_gib_per_chip": r["argument_gib_per_chip"],
             "peak_gib_per_chip": r["peak_gib_per_chip"],
             "flops_per_chip": r["flops_per_chip"],
             "useful_flops_ratio": r["useful_flops_ratio"],
             "dominant": r["dominant"], "t_compute": r["t_compute"],
             "t_memory": r["t_memory"], "t_collective": r["t_collective"],
             "collective_counts": r["collective_counts"],
             "process_seconds": r["process_seconds"]})
    say({"phase": "dryrun cells", "cells": len(rows),
         "wall_seconds_since_start": time.monotonic() - cells.t0,
         "process_seconds": sum(r["process_seconds"] for r in rows)})
    say({"phase": "dryrun", "seconds": time.monotonic() - t0})
    return launched


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
    """h2o-danube-1.8b cut to ``FT_LAYERS`` layers through a restartable
    server process (``per_step``: a worker step's launches at that
    depth):
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
    cut = danube_cut(FT_LAYERS)
    spec = ft_spec(api, full=True, ft_dir=os.path.join(work, "ckpt"),
                   snapshot_every_s=20.0, keep=2, reconnect_tries=120,
                   reconnect_base_s=0.2, reconnect_max_s=1.0,
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
    """At smoke size, the three at once, each on a thread of its own: a
    worker killed while gated over shmem, push frames dropped over tcp,
    and a server killed inside a live reshard.  Each spawns processes of
    its own, whose start on the card is most of its time; each record
    carries its wall seconds."""
    import threading
    paths = (_ft_worker_killed, _ft_frames_dropped, _ft_killed_mid_reshard)
    recs, errors = [None] * len(paths), []

    def one(i, path):
        t0 = time.monotonic()
        try:
            recs[i] = dict(path(torch, api, per_step, device),
                           seconds=time.monotonic() - t0)
        except BaseException as e:      # fail() exits: re-raised below
            errors.append(e)

    free_device_memory(torch)
    threads = [threading.Thread(target=one, args=(i, path))
               for i, path in enumerate(paths)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rec in recs:
        if rec is not None:
            say(rec)
    if errors:
        raise errors[0]


def _ft_worker_killed(torch, api, per_step, device):
    """shmem: worker 1 SIGKILLs itself at iteration 2 while worker 0
    waits on it at the BSP barrier; its seat is freed and the respawn
    takes it back exactly once (a second seat would hang the barrier)."""
    from repro_torch.ft import FaultPlan
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    tag = "ft (shmem, a worker killed while gated)"
    spec = main_path_spec(api, full=False, workers=2, sync="bsp",
                          transport=api.TransportSpec(kind="shmem"))
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
    return {"phase": "ft paths", "run": tag, "respawned": pool.respawned,
            "pushes": pushes}


def _ft_frames_dropped(torch, api, per_step, device):
    """tcp: a quarter of the push frames dropped before they leave the
    worker; each drop is a dead connection to the worker, which
    reconnects and sends its iteration again."""
    from repro_torch.wireformat import MSG_PUSH
    tag = "ft (tcp, push frames dropped)"
    spec = main_path_spec(api, full=False, workers=2, sync="dssp",
                          transport=api.TransportSpec(kind="tcp",
                                                      host="127.0.0.1"))
    spec = spec.replace(ft=api.FtSpec(
        reconnect_tries=10, reconnect_base_s=0.05, reconnect_max_s=0.5,
        fault_drop_kind=MSG_PUSH, fault_drop_prob=0.25, fault_seed=3))
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
    return {"phase": "ft paths", "run": tag, "reconnects": reconnects,
            "computed_steps": [len(r.compute_s) for r in results]}


def _ft_killed_mid_reshard(torch, api, per_step, device):
    """The server SIGKILLed inside its live reshard 4 -> 6: the restart
    resumes from a pre-migration snapshot, its trigger finishes the
    move, and no snapshot on disk mixes two plans."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import ServerProcess
    from repro_torch.launch.proc_pool import (ProcessWorkerPool, WorkerTask,
                                              raise_on_failure)
    from repro_torch.wireformat import MSG_PUSH
    tag = "ft (tcp, server killed mid-reshard)"
    os.makedirs(FT_WORK_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ft-mid-", dir=FT_WORK_DIR)
    spec = ft_spec(api, full=False, ft_dir=os.path.join(work, "ckpt"),
                   snapshot_every_s=0.05, keep=3, reconnect_tries=120,
                   reconnect_base_s=0.2, reconnect_max_s=1.0,
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
    return {"phase": "ft paths", "run": tag,
            "resumed_step": sp.resumed_step, "snapshots": plans,
            "restart_to_serve_s": sp.start_s[1]}


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


SPMD_RING_GROUP = "SPMD gradient ring (push_pop: the slot copy)"
SPMD_OPTIMIZER_GROUP = "SPMD optimizer (adamw, plain PyTorch)"


def range_groups():
    """Profiler ranges whose device spans form a group of their own
    (a graph replay's, or the SPMD step's ring and optimizer), each
    with its group: (range name, group)."""
    from repro_torch.kernels.registry import SSM_SCAN_BACKWARD
    from repro_torch.launch.train import OPTIMIZER_RANGE, RING_RANGE
    from repro_torch.models.ssm import SLSTM_BACKWARD, SLSTM_FORWARD
    return ((SSM_SCAN_BACKWARD, PLAIN_SCAN_BACKWARD),
            (SLSTM_FORWARD, SLSTM_FORWARD_GROUP),
            (SLSTM_BACKWARD, SLSTM_BACKWARD_GROUP),
            (RING_RANGE, SPMD_RING_GROUP),
            (OPTIMIZER_RANGE, SPMD_OPTIMIZER_GROUP))


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
    check_parity(torch, api, "h2o-danube smoke", lambda kernels:
                 main_path_spec(api, full=False, workers=1, sync="bsp",
                                kernels=kernels, straggler=1.0))
    # remat recomputes every layer's forward in the backward pass
    launches = run_train(
        torch, api, "train",
        main_path_spec(api, full=True, workers=2, sync="dssp"),
        dense_per_step(24))["launches"]
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
    transport = run_transport(
        torch, api, dense_per_step(transport_config().n_layers))
    smoke = get_smoke_config("h2o-danube-1.8b")
    passes = smoke.n_layers * (2 if smoke.remat == "full" else 1)

    mark("ft")
    # -- ft, ft paths ----------------------------------------------------
    run_ft(torch, api, dense_per_step(FT_LAYERS))
    run_ft_paths(torch, api, {"flash_attention_fwd": passes,
                              "residual_rmsnorm": passes,
                              "rmsnorm": passes + 1})

    mark("serve")
    # -- serve parity, serve, serve transport ----------------------------
    check_serve_parity(torch)
    serve = run_serve(torch, api, dense_per_step(SERVE_LAYERS))
    for name in ("fused_update", "rmsnorm", "residual_rmsnorm",
                 "flash_attention_fwd"):
        launches[name] += serve["launches"][name]
    # the transport paths (smoke size) run beside it, in a process of
    # their own
    served = run_serve_transport_beside_paths(torch, api, args.src)
    say(f"serve transport: pushes/s {served['pushes_per_s']} with a "
        f"replica at {SERVE_TRANSPORT_LAYERS} layers (the transport "
        f"phase's without one at {transport_config().n_layers}: "
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
    mark("spmd")
    # -- the SPMD engine, its parity and the examples -----------------------
    spmd = run_spmd_phase(torch, api, args.src)
    for name, n in spmd["launches"].items():
        launches[name] += n
    mark("mesh")
    # -- the device mesh: one rank at full width, four over gloo ----------
    for name, n in run_mesh_phase(torch, api, spmd).items():
        launches[name] += n
    mark("dryrun")
    # -- the dry run's cells; the partitioned step on four ranks ----------
    # (d)'s steps launch the scan and the norms on its four ranks, (e)'s
    # and (f)'s calls the norm
    for name, n in run_dryrun_phase(torch, args.src).items():
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
