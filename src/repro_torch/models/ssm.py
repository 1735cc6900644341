"""State-space / recurrent families: xLSTM (mLSTM + sLSTM) and the Mamba
(S6) block, training and decode.

Counterpart of ``repro/models/ssm.py``: the same parameter names and
shapes, the same order of casts and products.

* mLSTM trains with the stabilized parallel (quadratic) form and
  decodes with the matrix-memory recurrence, both plain PyTorch, as the
  reference's are plain XLA.  The reference's quirks are kept: k is
  divided by sqrt(hd) and the scores by sqrt(hd) again; the masked
  decay entries are ``-inf``, not ``NEG_INF``.
* sLSTM is a true recurrence over time; the reference runs it as one
  ``lax.scan``.  Here the time loop is a ``torch.autograd.Function``
  (``slstm_time_loop``): on the CPU it runs eagerly; on the card its
  forward replays one captured CUDA graph of the loop, and its backward
  one graph of the loop's recompute and autograd through it
  (``SLSTM_FORWARD_GRAPHS``, ``SLSTM_BACKWARD_GRAPHS``; per signature,
  stream and thread, as the scan's backward).  An eager loop would
  queue some 20 kernels a step from Python, tens of thousands a layer.
* Mamba's selective scan goes through
  ``repro_torch.kernels.registry.ssm_scan`` by ``cfg.kernels``: the
  Hopper kernel on the card, the chunked associative scan on the CPU.
  ``mamba_decode`` is one recurrence step in plain PyTorch.

The xLSTM LM (``xlstm_forward``) normalises each layer's input with the
registry's RMSNorm (the Hopper kernel on the card) and adds its residual
plainly.  Decode state (per layer), the analogue of a KV cache:
  mLSTM: C (b,h,d,d), n (b,h,d), m (b,h)
  sLSTM: c,n,h (b,h,d) + m (b,h)
  Mamba: conv tail (b, d_conv-1, d_inner) + ssm state (b, d_inner, d_state)
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import registry as K
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.models.transformer import layer_weights


def mamba_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.expand * d
    ds = cfg.d_state
    dt_rank = max(1, d // 16)
    return {
        "w_in": ParamDef((n, d, 2 * di), fan_in_dims=(1,)),
        "conv_w": ParamDef((n, cfg.d_conv, di), scale=1.0, fan_in_dims=(1,)),
        "conv_b": ParamDef((n, di), init="zeros"),
        "w_bcdt": ParamDef((n, di, 2 * ds + dt_rank), fan_in_dims=(1,)),
        "dt_proj": ParamDef((n, dt_rank, di), fan_in_dims=(1,)),
        "dt_bias": ParamDef((n, di), init="zeros"),
        "a_log": ParamDef((n, di, ds), init="ones"),
        "d_skip": ParamDef((n, di), init="ones"),
        "w_out": ParamDef((n, di, d), fan_in_dims=(1,)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (b, l, di), w (k, di). Returns
    (y, new_tail)."""
    k = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    l = x.shape[1]
    y = xp[:, 0:l] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + l] * w[i]
    new_tail = xp[:, -(k - 1):] if k > 1 else pad
    return (y + b).to(x.dtype), new_tail


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,de->ble") as one matmul."""
    b, l, d = x.shape
    return (x.reshape(b * l, d) @ w).view(b, l, w.shape[-1])


def mamba_block(cfg: ModelConfig, x: torch.Tensor,
                w: Dict[str, Any]) -> torch.Tensor:
    b, l, d = x.shape
    di = cfg.expand * d
    ds = cfg.d_state
    xin, z = _matmul(x, w["w_in"]).split(di, dim=-1)
    xc, _ = _causal_conv(xin, w["conv_w"], w["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    bcdt = _matmul(xc, w["w_bcdt"]).float()
    # the kernel reads B and C contiguous; they are (b, l, ds), small
    bmat = bcdt[..., :ds].contiguous()
    cmat = bcdt[..., ds:2 * ds].contiguous()
    dt = bcdt[..., 2 * ds:]
    delta = F.softplus(_matmul(dt, w["dt_proj"].float())
                       + w["dt_bias"].float())
    a = -torch.exp(w["a_log"].float())
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    chunk = cfg.mamba_chunk if cfg.mamba_chunk > 0 else l
    xcf = xc.float()
    y, _ = K.ssm_scan(xcf, delta, a, bmat, cmat, h0, chunk=chunk,
                      kernels=cfg.kernels)
    y = y + xcf * w["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _matmul(y, w["w_out"])


def mamba_decode(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (b, 1, d); state conv (b, k-1, di), h (b, di, ds) f32.
    Returns (out (b, 1, d), new state)."""
    ds = cfg.d_state
    di = cfg.expand * cfg.d_model
    xin, z = _matmul(x, w["w_in"]).split(di, dim=-1)
    xc, new_tail = _causal_conv(xin, w["conv_w"], w["conv_b"],
                                tail=state["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    bcdt = _matmul(xc, w["w_bcdt"]).float()
    bmat, cmat, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., 2 * ds:]
    delta = F.softplus(_matmul(dt, w["dt_proj"].float())
                       + w["dt_bias"].float())                 # (b, 1, di)
    a = -torch.exp(w["a_log"].float())
    abar = torch.exp(delta[..., None] * a[None, None])[:, 0]   # (b, di, ds)
    xcf = xc.float()
    bbar = (delta[..., None] * bmat[:, :, None, :] * xcf[..., None])[:, 0]
    h = abar * state["h"] + bbar
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])
    y = y + xcf[:, 0] * w["d_skip"].float()
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _matmul(y, w["w_out"]), {"conv": new_tail, "h": h}


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as the reference divides by a Python float: ``c`` in
    x's dtype, a tensor on x's device, so the division is IEEE on the
    card too (a Python-scalar divisor is a multiply by its reciprocal
    there)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul."""
    d = x.shape[-1]
    return (x.reshape(-1, d) @ w.reshape(d, -1)).view(*x.shape[:-1],
                                                       *w.shape[1:])


# ====================================================================== mLSTM
def mlstm_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    return {
        "w_in": ParamDef((n, d, 2 * d), fan_in_dims=(1,)),  # x + gate
        "wq": ParamDef((n, d, h, hd), fan_in_dims=(1,)),
        "wk": ParamDef((n, d, h, hd), fan_in_dims=(1,)),
        "wv": ParamDef((n, d, h, hd), fan_in_dims=(1,)),
        "w_if": ParamDef((n, d, 2 * h), fan_in_dims=(1,)),  # input+forget
        "b_if": ParamDef((n, 2 * h), init="zeros"),
        "w_out": ParamDef((n, d, d), fan_in_dims=(1,)),
    }


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor
                    ) -> torch.Tensor:
    """Stabilized parallel mLSTM (xLSTM paper eq. 19-27).

    q/k/v (b, l, h, d); i/f (b, l, h) pre-activations.  The decay
    matrix is masked with ``-inf`` above the diagonal, as the
    reference's: ``exp(-inf - m)`` is 0 there."""
    b, l, h, d = q.shape
    logf = F.logsigmoid(f_gate.float())                         # (b,l,h)
    cum = torch.cumsum(logf, dim=1)
    # F[t,s] = cum[t] - cum[s]  (decay applied strictly after step s)
    fmat = cum[:, :, None, :] - cum[:, None, :, :]              # (b,t,s,h)
    dmat = fmat + i_gate.float()[:, None, :, :]                 # + i[s]
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    m = dmat.amax(dim=2, keepdim=True)                          # (b,t,1,h)
    dexp = torch.exp(dmat - m)                                  # stabilized
    scores = torch.einsum("blhd,bshd->blsh", q.float(), k.float())
    scores = _div(scores, math.sqrt(d)) * dexp
    norm = torch.maximum(scores.sum(dim=2).abs(),
                         torch.exp(-m[:, :, 0, :]))             # (b,l,h)
    out = torch.einsum("blsh,bshd->blhd", scores.to(v.dtype).float(),
                       v.float())
    return (out / norm[..., None]).to(v.dtype)


def mlstm_block(cfg: ModelConfig, x: torch.Tensor,
                w: Dict[str, Any]) -> torch.Tensor:
    b, l, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin, gate = _matmul(x, w["w_in"]).split(d, dim=-1)
    q = _heads(xin, w["wq"])
    k = _div(_heads(xin, w["wk"]), math.sqrt(hd))
    v = _heads(xin, w["wv"])
    gates = _matmul(xin, w["w_if"]) + w["b_if"]
    i_gate, f_gate = gates.split(h, dim=-1)
    out = _mlstm_parallel(q, k, v, i_gate, f_gate)
    out = out.reshape(b, l, d) * F.silu(gate.float()).to(x.dtype)
    return _matmul(out, w["w_out"])


def mlstm_decode(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (b, 1, d); state C (b,h,d,d), n (b,h,d), m (b,h), f32.
    Returns (out (b, 1, d), new state)."""
    b, _, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin, gate = _matmul(x, w["w_in"]).split(d, dim=-1)
    x0 = xin[:, 0]
    q = _heads(x0, w["wq"])
    k = _div(_heads(x0, w["wk"]), math.sqrt(hd))
    v = _heads(x0, w["wv"])
    gates = x0 @ w["w_if"] + w["b_if"]
    i_pre, f_pre = gates.split(h, dim=-1)                       # (b, h)
    i_pre = i_pre.float()
    logf = F.logsigmoid(f_pre.float())
    m_new = torch.maximum(logf + state["m"], i_pre)
    a = torch.exp(logf + state["m"] - m_new)                    # (b, h)
    bb = torch.exp(i_pre - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c_new = (a[..., None, None] * state["C"]
             + bb[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n_new = a[..., None] * state["n"] + bb[..., None] * kf
    num = torch.einsum("bhkd,bhk->bhd", c_new, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qf).abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).reshape(b, 1, d).to(x.dtype)
    out = out * F.silu(gate.float()).to(x.dtype)
    return _matmul(out, w["w_out"]), {"C": c_new, "n": n_new, "m": m_new}


# ====================================================================== sLSTM
def slstm_defs(cfg: ModelConfig, n: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = cfg.n_heads
    return {
        # 4 gates (z, i, f, o), input + per-head recurrent weights
        "w_x": ParamDef((n, d, 4 * d), fan_in_dims=(1,)),
        "w_h": ParamDef((n, h, d // h, 4 * d // h), fan_in_dims=(2,)),
        "bias": ParamDef((n, 4 * d), init="zeros"),
        "w_out": ParamDef((n, d, d), fan_in_dims=(1,)),
    }


def _slstm_cell(carry: Sequence[torch.Tensor], gx: torch.Tensor):
    """One timestep. carry: (c, n, h, m), each (b, H, hd) / m (b, H);
    gx (b, H, 4*hd) = W_x·x_t + bias + the recurrent term.  Max, mean
    and ``maximum`` split their gradient at ties as the reference's."""
    c, n, h, m = carry
    z_pre, i_pre, f_pre, o_pre = gx.chunk(4, dim=-1)
    # exponential gating with stabilizer state m (scalar per head)
    i_max = i_pre.amax(dim=-1)
    logf = F.logsigmoid(f_pre.mean(dim=-1))                     # (b, H)
    m_new = torch.maximum(logf + m, i_max)
    i_g = torch.exp(i_pre - m_new[..., None])
    f_g = torch.exp(logf + m - m_new)[..., None]
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.maximum(n_new, n_new.new_ones(()))
    return c_new, n_new, h_new, m_new


def slstm_loop(gx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The sLSTM's time loop, eagerly: gx (b, l, H, 4hd) f32 (input
    gates with bias), wh (H, hd, 4hd) f32 -> h (b, l, H, hd) f32, from
    zeros and the stabilizer at -1e30."""
    b, l, heads, g4 = gx.shape
    c = n = h = gx.new_zeros((b, heads, g4 // 4))
    m = gx.new_full((b, heads), -1e30)
    hs: List[torch.Tensor] = []
    for t in range(l):
        rec = torch.einsum("bhk,hkg->bhg", h, wh)
        c, n, h, m = _slstm_cell((c, n, h, m), gx[:, t] + rec)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_forward_body(tensors: Sequence[torch.Tensor],
                       needs: Sequence[bool]) -> Tuple[torch.Tensor]:
    """``slstm_loop`` over (gx, wh): what the card captures as the
    forward graph."""
    return (slstm_loop(*tensors),)


def slstm_backward_body(tensors: Sequence[torch.Tensor],
                        needs: Sequence[bool]
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The loop's backward: ``tensors`` are (gx, wh, dh); the gradients
    of gx and wh that ``needs`` marks, recomputed through
    ``slstm_loop``.  Eager on the CPU; the card's backward graph."""
    return K._vjp_through(slstm_loop, tensors[:2], tensors[2:], needs)


#: ``torch.profiler.record_function`` ranges around the loop's forward
#: and backward, so a trace can attribute the replays' device time
SLSTM_FORWARD = "slstm_loop_forward"
SLSTM_BACKWARD = "slstm_loop_backward"
#: the process's sLSTM graphs (``slstm_time_loop`` on the card)
SLSTM_FORWARD_GRAPHS = K.CudaGraphs(slstm_forward_body)
SLSTM_BACKWARD_GRAPHS = K.CudaGraphs(slstm_backward_body)


class _SLSTMLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, wh):
        ctx.save_for_backward(gx, wh)
        with torch.profiler.record_function(SLSTM_FORWARD):
            if gx.is_cuda:
                return SLSTM_FORWARD_GRAPHS((gx, wh))[0]
            return slstm_loop(gx, wh)

    @staticmethod
    def backward(ctx, dh):
        tensors = (*ctx.saved_tensors, dh)
        needs = ctx.needs_input_grad[:2]
        with torch.profiler.record_function(SLSTM_BACKWARD):
            if dh.is_cuda:
                return SLSTM_BACKWARD_GRAPHS(tensors, needs)
            return slstm_backward_body(tensors, needs)


def slstm_time_loop(gx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``slstm_loop`` under autograd: one graph replay a call and one
    for its backward on the card, the eager loop on the CPU."""
    return _SLSTMLoop.apply(gx, wh)


def slstm_block(cfg: ModelConfig, x: torch.Tensor,
                w: Dict[str, Any]) -> torch.Tensor:
    """Sequential over time; block-diagonal (per-head) recurrence.  The
    bias is added in the storage dtype, before the f32 cast."""
    b, l, d = x.shape
    heads = cfg.n_heads
    gx = (_matmul(x, w["w_x"]) + w["bias"]).float().reshape(
        b, l, heads, 4 * d // heads)
    hs = slstm_time_loop(gx, w["w_h"].float())
    return _matmul(hs.reshape(b, l, d).to(x.dtype), w["w_out"])


def slstm_decode(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, Any],
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (b, 1, d); state c, n, h (b, H, hd), m (b, H), f32."""
    b, _, d = x.shape
    heads = cfg.n_heads
    gx = (x[:, 0] @ w["w_x"] + w["bias"]).float().reshape(
        b, heads, 4 * d // heads)
    rec = torch.einsum("bhk,hkg->bhg", state["h"], w["w_h"].float())
    c, n, h, m = _slstm_cell((state["c"], state["n"], state["h"],
                              state["m"]), gx + rec)
    out = h.reshape(b, 1, d).to(x.dtype)
    return _matmul(out, w["w_out"]), {"c": c, "n": n, "h": h, "m": m}


# =============================================================== xLSTM LM
def xlstm_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """xLSTM[m:s] language model: mLSTM blocks with sLSTM at
    ``cfg.slstm_layers``."""
    n_s = len(cfg.slstm_layers)
    n_m = cfg.n_layers - n_s
    d = cfg.d_model
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, d), init="embed",
                          fan_in_dims=(1,)),
        "final_norm": {"scale": ParamDef((d,), init="ones")},
        "mlstm": mlstm_defs(cfg, n_m),
        "mlstm_norm": {"scale": ParamDef((n_m, d), init="ones")},
    }
    if n_s:
        defs["slstm"] = slstm_defs(cfg, n_s)
        defs["slstm_norm"] = {"scale": ParamDef((n_s, d), init="ones")}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.padded_vocab, d), fan_in_dims=(1,))
    return defs


def _xlstm_layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(kind, index-within-kind)] per layer."""
    plan, im, is_ = [], 0, 0
    for i in range(cfg.n_layers):
        if i in cfg.slstm_layers:
            plan.append(("slstm", is_))
            is_ += 1
        else:
            plan.append(("mlstm", im))
            im += 1
    return plan


def _xlstm_weights(cfg: ModelConfig, params: Dict[str, Any]):
    """Per layer: (kind, index within the kind, its block's weights, its
    norm's weights), as views of the stacked leaves."""
    n = {kind: sum(1 for k, _ in _xlstm_layer_plan(cfg) if k == kind)
         for kind in ("mlstm", "slstm")}
    per = {kind: (layer_weights(params[kind], n[kind]),
                  layer_weights(params[f"{kind}_norm"], n[kind]))
           for kind in n if n[kind]}
    return [(kind, j, per[kind][0][j], per[kind][1][j])
            for kind, j in _xlstm_layer_plan(cfg)]


def _xlstm_layer(cfg: ModelConfig, kind: str, x: torch.Tensor,
                 w: Dict[str, Any], nrm: Dict[str, Any]) -> torch.Tensor:
    blk = mlstm_block if kind == "mlstm" else slstm_block
    return x + blk(cfg, L.rms_norm(x, nrm["scale"], kernels=cfg.kernels), w)


def xlstm_forward(cfg: ModelConfig, params: Dict[str, Any],
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, l) -> logits (b, l, v), and a zero aux loss.
    ``cfg.remat == "full"`` recomputes each layer in the backward pass,
    as the reference's per-layer ``jax.checkpoint``: the mLSTM's (l x l)
    decay and score blocks stay live one layer at a time."""
    x = L.embed(tokens, params["embed"]).to(torch_dtype(cfg.dtype))
    for kind, _, w, nrm in _xlstm_weights(cfg, params):
        if cfg.remat == "full":
            x = checkpoint(_xlstm_layer, cfg, kind, x, w, nrm,
                           use_reentrant=False)
        else:
            x = _xlstm_layer(cfg, kind, x, w, nrm)
    x = L.rms_norm(x, params["final_norm"]["scale"], kernels=cfg.kernels)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return (L.unembed(x, table, cfg.vocab_size),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def xlstm_init_state(cfg: ModelConfig, batch: int, max_seq: int = 0,
                     device=None) -> Dict[str, Any]:
    """Decode state of zeros (the stabilizers at -1e30), f32, stacked
    per kind; ``max_seq`` is unused (the state does not grow)."""
    d = cfg.d_model
    heads = cfg.n_heads
    hd = d // heads
    n_s = len(cfg.slstm_layers)
    n_m = cfg.n_layers - n_s
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    state: Dict[str, Any] = {
        "mlstm": {"C": zeros(n_m, batch, heads, hd, hd),
                  "n": zeros(n_m, batch, heads, hd),
                  "m": torch.full((n_m, batch, heads), -1e30,
                                  dtype=torch.float32, device=device)}}
    if n_s:
        state["slstm"] = {"c": zeros(n_s, batch, heads, hd),
                          "n": zeros(n_s, batch, heads, hd),
                          "h": zeros(n_s, batch, heads, hd),
                          "m": torch.full((n_s, batch, heads), -1e30,
                                          dtype=torch.float32,
                                          device=device)}
    return state


def xlstm_decode(cfg: ModelConfig, params: Dict[str, Any],
                 token: torch.Tensor, state: Dict[str, Any], index: int,
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (b, 1); ``index`` is unused (the state
    carries the position).  Returns (logits (b, 1, v), state), the state
    updated in place."""
    x = L.embed(token, params["embed"]).to(torch_dtype(cfg.dtype))
    for kind, j, w, nrm in _xlstm_weights(cfg, params):
        h = L.rms_norm(x, nrm["scale"], kernels=cfg.kernels)
        st = {key: t[j] for key, t in state[kind].items()}
        step = mlstm_decode if kind == "mlstm" else slstm_decode
        out, new = step(cfg, h, w, st)
        x = x + out
        for key, val in new.items():
            st[key].copy_(val)
    x = L.rms_norm(x, params["final_norm"]["scale"], kernels=cfg.kernels)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.vocab_size), state
