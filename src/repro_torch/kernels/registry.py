"""Enum-dispatched kernel registry: ONE call site per worker-step hot op.

Counterpart of ``repro/kernels/registry.py``.  Each public function is
the single entry point the model calls for its op — ``attention``,
``rmsnorm``, ``residual_rmsnorm``, ``ssm_scan`` — dispatched over
``KernelType`` by the validated ``model.kernels`` string
(``repro_torch.kernels.interface``):

    variant            what runs
    -----------------  --------------------------------------------------
    KERNEL             the Hopper kernel, inside a
                       ``torch.autograd.Function`` whose backward is
                       autograd through the matching ``kernels/ref.py``
                       oracle (as the reference pairs each Pallas forward
                       with a ``jax.custom_vjp`` backward)
    PLAIN              the ``kernels/ref.py`` formulation with native
                       autograd
    PLAIN_ASSOCIATIVE  (``ssm_scan`` only) the chunked associative scan

The backward through the oracle is the only place a plain version runs
on the card's main path.  The scan's runs there as one CUDA graph replay
per call (``ScanBackwardGraphs``, a ``CudaGraphs`` cache): the oracle's
recompute and autograd through it, captured once per input signature,
stream and thread, where eager PyTorch would queue some 25 k small
kernels a call from Python.
Attention hands the kernel its inputs as
``flash_attention.kernel_operands`` makes them: a strided or misaligned
view copied, a head dim that is not a multiple of 8 zero-padded, so
those launch the kernel too; the kernel masks ragged tiles itself, so
every sequence length takes it.  What no kernel takes (a head dim above
128, float16) raises.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import residual_rmsnorm as _rrn
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _scan
from repro_torch.kernels.interface import AUTO, KernelType, resolve


def resolved(op: str, kernels: str, x: torch.Tensor) -> KernelType:
    """The variant a spec string picks for ``op`` on ``x``'s device."""
    return resolve(kernels, op, cuda=x.is_cuda)


def _vjp_through(fn: Callable, inputs: Sequence[torch.Tensor],
                 douts: Sequence[torch.Tensor],
                 needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``fn(*inputs)`` for the inputs that need one,
    recomputed through ``fn`` (the plain oracle)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(outs, wrt, douts) if wrt else ())
    return tuple(next(grads) if n else None for n in needs)


# ================================================================ attention
class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        d = q.shape[-1]
        out = _fa.flash_attention_fwd(*_fa.kernel_operands(q, k, v),
                                      causal=causal, window=window,
                                      head_dim=d)
        return out if out.shape[-1] == d else out[..., :d].contiguous()

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = _vjp_through(
            lambda q_, k_, v_: _ref.flash_attention_ref(
                q_, k_, v_, causal=ctx.causal, window=ctx.window),
            (q, k, v), (dout,), ctx.needs_input_grad[:3])
        return grads + (None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kernels: str = AUTO) -> torch.Tensor:
    """q (b, lq, hq, d); k/v (b, lk, hkv, d); GQA; positions END-aligned
    (query i at absolute position lk - lq + i)."""
    if resolved("attention", kernels, q) is KernelType.KERNEL:
        return _Attention.apply(q, k, v, causal, window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)


# ================================================================= rmsnorm
class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rn.rmsnorm(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        grads = _vjp_through(
            lambda x_, w_: _ref.rmsnorm_ref(x_, w_, ctx.eps),
            (x, weight), (dout,), ctx.needs_input_grad[:2])
        return grads + (None,)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            kernels: str = AUTO) -> torch.Tensor:
    """x (..., d), weight (d,) -> same shape/dtype as x; f32 reduction."""
    if resolved("rmsnorm", kernels, x) is KernelType.KERNEL:
        return _RMSNorm.apply(x, weight, eps)
    return _ref.rmsnorm_ref(x, weight, eps)


# ======================================================== residual+rmsnorm
class _ResidualRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, weight, eps: float):
        ctx.save_for_backward(x, res, weight)
        ctx.eps = eps
        return _rrn.residual_rmsnorm(x, res, weight, eps=eps)

    @staticmethod
    def backward(ctx, ds, dout):
        x, res, weight = ctx.saved_tensors
        grads = _vjp_through(
            lambda x_, r_, w_: _ref.residual_rmsnorm_ref(x_, r_, w_, ctx.eps),
            (x, res, weight), (ds, dout), ctx.needs_input_grad[:3])
        return grads + (None,)


def residual_rmsnorm(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                     *, eps: float = 1e-6, kernels: str = AUTO
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pre-norm block glue: ``s = x + res`` (f32) ->
    ``(s, rms_norm(s) * weight)``, both in x's dtype."""
    if resolved("residual_rmsnorm", kernels, x) is KernelType.KERNEL:
        return _ResidualRMSNorm.apply(x, res, weight, eps)
    return _ref.residual_rmsnorm_ref(x, res, weight, eps)


# ================================================================ ssm scan
#: ``torch.profiler.record_function`` range around the scan's backward, so
#: a trace can attribute the plain recompute's device time to it
SSM_SCAN_BACKWARD = "ssm_scan_plain_backward"


def scan_backward_body(tensors: Sequence[torch.Tensor],
                       needs: Sequence[bool]
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """The scan's backward as the reference computes it: ``tensors`` are
    the six saved inputs (u, delta, a, bmat, cmat, h0), then dy and
    dh_last; the gradients of the inputs that ``needs`` marks, recomputed
    through the sequential oracle.  Run eagerly on the CPU; captured as a
    CUDA graph on the card (``ScanBackwardGraphs``)."""
    return _vjp_through(_ref.ssm_scan_ref, tensors[:6], tensors[6:], needs)


class _GraphedCall:
    """``body(tensors, needs)`` for one signature, captured once as a
    CUDA graph over static input buffers.  A call copies its inputs in,
    replays on the caller's current stream, and returns clones of the
    outputs (the next replay overwrites the static outputs)."""

    def __init__(self, body: Callable, tensors: Sequence[torch.Tensor],
                 needs: Tuple[bool, ...]):
        dev = tensors[0].device
        self.static_in = [
            t.detach().clone(memory_format=torch.contiguous_format)
            for t in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):     # warm-up: cuBLAS handles, caches
            body(self.static_in, needs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another worker thread may allocate or wait on its
        # own events while this one captures
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.static_out = body(self.static_in, needs)

    def __call__(self, tensors: Sequence[torch.Tensor]
                 ) -> Tuple[Optional[torch.Tensor], ...]:
        for dst, src in zip(self.static_in, tensors):
            dst.copy_(src)
        self.graph.replay()
        return tuple(None if g is None else g.clone()
                     for g in self.static_out)


class CudaGraphs:
    """One captured ``body(tensors, needs) -> tuple of tensors (or
    None)`` per input signature (device, shapes, dtypes, ``needs``),
    current stream and calling thread, so no two live threads or streams
    ever share a graph's static buffers.  A thread that has finished
    leaves its graphs to the next thread of the same signature and
    stream (each training session runs new worker threads), so the
    count does not grow from one session to the next.  Captures are
    serialised by one lock.  A capture that fails raises: the card never
    falls back to the eager body.  The scan's backward
    (``ScanBackwardGraphs``) and the sLSTM's time loop
    (``models/ssm.py``) each keep one."""

    def __init__(self, body: Callable):
        self.body = body
        self._graphs: Dict[tuple, _GraphedCall] = {}
        self._lock = threading.Lock()

    def __call__(self, tensors: Sequence[torch.Tensor],
                 needs: Sequence[bool] = ()
                 ) -> Tuple[Optional[torch.Tensor], ...]:
        dev = tensors[0].device
        needs = tuple(bool(n) for n in needs)
        sig = (dev, tuple((tuple(t.shape), t.dtype) for t in tensors), needs,
               torch.cuda.current_stream(dev).cuda_stream)
        # the autograd engine's device thread gets a (never-ending) dummy
        # Thread here, so its graphs are never taken over
        me = threading.current_thread()
        graph = self._graphs.get(sig + (me.ident,))
        if graph is None or graph.owner is not me:
            with self._lock:
                graph = self._claim(sig, tensors, needs, me)
        return graph(tensors)

    def _claim(self, sig: tuple, tensors: Sequence[torch.Tensor],
               needs: Tuple[bool, ...], me: threading.Thread
               ) -> _GraphedCall:
        """Under the lock: a finished thread's graph of ``sig`` (first one
        filed under this thread's ident, which a finished thread's may
        carry), or a new capture, owned by ``me`` from now on."""
        key = sig + (me.ident,)
        graph = self._graphs.pop(key, None)   # idents are unique among
        if graph is None:                     # live threads: its owner ended
            done = [k for k, g in self._graphs.items()
                    if k[:-1] == sig and not g.owner.is_alive()]
            graph = (self._graphs.pop(done[0]) if done else
                     _GraphedCall(self.body, tensors, needs))
        graph.owner = me
        self._graphs[key] = graph
        return graph

    def __len__(self) -> int:
        return len(self._graphs)

    def summary(self) -> list:
        """Each graph's key (needs, stream, thread) and the bytes of the
        allocator's segments in its private pool, which hold the body's
        intermediates between replays."""
        segments = torch.cuda.memory_snapshot()
        out = []
        for (dev, _, needs, stream, thread), g in self._graphs.items():
            pool = tuple(g.graph.pool())
            out.append({"device": str(dev), "needs": needs, "stream": stream,
                        "thread": thread, "pool_bytes": sum(
                            seg["total_size"] for seg in segments
                            if tuple(seg["segment_pool_id"]) == pool)})
        return out

    def pool_bytes(self) -> int:
        """Device memory the captured graphs' private pools hold."""
        return sum(g["pool_bytes"] for g in self.summary())

    def clear(self) -> None:
        """Drop every graph and its pool (after the last call of a
        signature; the next call captures again)."""
        with self._lock:
            self._graphs.clear()


class ScanBackwardGraphs(CudaGraphs):
    """The scan backward's graphs: ``scan_backward_body`` captured per
    signature, stream and thread."""

    def __init__(self):
        super().__init__(scan_backward_body)


#: the process's scan-backward graphs (``_SSMScan.backward`` on the card)
SCAN_BACKWARD_GRAPHS = ScanBackwardGraphs()


class _SSMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, a, bmat, cmat, h0, chunk: int):
        ctx.save_for_backward(u, delta, a, bmat, cmat, h0)
        return _scan.ssm_scan(u, delta, a, bmat, cmat, h0, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        # The reference has no backward kernel either: its custom_vjp
        # recomputes through the sequential oracle.  On the card that
        # recompute replays as one CUDA graph.
        tensors = (*ctx.saved_tensors, dy, dh_last)
        needs = ctx.needs_input_grad[:6]
        with torch.profiler.record_function(SSM_SCAN_BACKWARD):
            if dy.is_cuda:
                grads = SCAN_BACKWARD_GRAPHS(tensors, needs)
            else:
                grads = scan_backward_body(tensors, needs)
        return grads + (None,)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a, b) under
    ``combine((a1, b1), (a2, b2)) = (a2 * a1, a2 * b1 + b2)``, in
    log2(n) doubling rounds (Hillis-Steele): round k combines every
    element with the one 2**k before it."""
    k, n = 1, a.shape[1]
    while k < n:
        a, b = (torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1),
                torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1))
        k *= 2
    return a, b


def _ssm_scan_associative(u, delta, a, bmat, cmat, h0, chunk: int):
    """The reference's chunked associative scan: within a chunk the
    recurrence composes as (A-product, B-accumulate) pairs; a loop
    carries the state across chunks, bounding what is materialised to
    (b, chunk, di, ds).  All math in f32."""
    uf, df = u.float(), delta.float()
    abar = torch.exp(df[..., None] * a.float()[None, None])    # (b,l,di,ds)
    bbar = df[..., None] * bmat.float()[:, :, None, :] * uf[..., None]
    cf = cmat.float()
    h = h0.float()
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        acc_a, acc_b = _doubling_scan(abar[:, c0:c0 + chunk],
                                      bbar[:, c0:c0 + chunk])
        hs = acc_a * h[:, None] + acc_b
        ys.append(torch.einsum("bcds,bcs->bcd", hs, cf[:, c0:c0 + chunk]))
        h = hs[:, -1]
    if not ys:
        return u.new_empty(u.shape), h
    return torch.cat(ys, dim=1).to(u.dtype), h


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 128, kernels: str = AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (Mamba S6): ``h_t = exp(delta_t A) h_{t-1} +
    delta_t B_t u_t; y_t = C_t . h_t``.

    u/delta (b, l, di); a (di, ds); bmat/cmat (b, l, ds); h0 (b, di, ds)
    -> (y (b, l, di) in u's dtype, h_last (b, di, ds) f32).  ``chunk``
    is clamped to l and forced to l when it does not divide, as the
    reference does.
    """
    l = u.shape[1]
    chunk = min(chunk, l) if chunk > 0 else l
    if l % chunk:
        chunk = l
    kt = resolved("ssm_scan", kernels, u)
    if kt is KernelType.KERNEL:
        return _SSMScan.apply(u, delta, a, bmat, cmat, h0, chunk)
    if kt is KernelType.PLAIN_ASSOCIATIVE:
        return _ssm_scan_associative(u, delta, a, bmat, cmat, h0, chunk)
    return _ref.ssm_scan_ref(u, delta, a, bmat, cmat, h0)
