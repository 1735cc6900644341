"""Shared neural building blocks.

Counterpart of ``repro/models/layers.py``: the worker-step hot ops
(attention, RMSNorm, fused residual+RMSNorm) route through
``repro_torch.kernels.registry`` by ``cfg.kernels``; the projections and
the MLP products stay ``torch.matmul``, as the reference leaves them to
XLA.  So do one-token decode attention over a KV cache
(``_attention_grouped``), attention over an explicit mask
(``masked_attention``: Whisper's, and every attention on a mesh),
LayerNorm and the GELU MLP, which the reference computes in XLA too.

Conventions:
  activations   (batch, seq, d_model)                 bf16/f32
  q/k/v         (batch, seq, heads, head_dim)
  softmax/norm accumulation always float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import registry as K
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import has_mesh, sp_mode

NEG_INF = -1e30  # large-but-finite: -inf breaks softmax rows that are fully masked


# ----------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             kernels: str = "auto") -> torch.Tensor:
    """Registry-dispatched RMSNorm (``kernels`` = ``cfg.kernels``)."""
    return K.rmsnorm(x, weight, eps=eps, kernels=kernels)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in the reference's order of casts: f32 mean, f32
    variance of ``x - mean``, ``rsqrt``, then ``* w + b`` in f32, cast
    back to x's dtype.  Plain PyTorch: the reference computes it in XLA,
    outside any kernel."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor,
               w: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, w["scale"], kernels=cfg.kernels)
    return layer_norm(x, w["scale"], w["bias"])


def residual_apply_norm(cfg: ModelConfig, delta: torch.Tensor,
                        x: torch.Tensor, w: Dict[str, torch.Tensor],
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block glue: ``(x + delta, norm(x + delta))``: for
    rmsnorm the registry's fused residual+RMSNorm op, for layernorm the
    unfused form."""
    if cfg.norm == "rmsnorm":
        return K.residual_rmsnorm(delta, x, w["scale"], kernels=cfg.kernels)
    s = x + delta
    return s, layer_norm(s, w["scale"], w["bias"])


# ----------------------------------------------------------------- rotary
def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d); cos/sin (b, s, d/2) or (s, d/2)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:          # (s, d/2) -> broadcast over batch/heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                       # (b, s, d/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def causal_window_mask(lq: int, lk: int, *, q_offset: int = 0,
                       window: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """(lq, lk) bool mask: True = attend. Causal plus optional sliding
    window of width ``window`` (inclusive of self)."""
    qpos = torch.arange(lq, device=device)[:, None] + q_offset
    kpos = torch.arange(lk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Grouped GQA for decode: q (b, lq, hkv, g, d); k/v (b, lk, hkv, d);
    mask (lq, lk), True = attend.

    The reference's XLA form: scores summed in f32 and scaled by
    1/sqrt(d), masked with ``NEG_INF``, softmax in f32, the
    probabilities rounded to v's dtype before ``P·V`` (summed in f32).
    The scale divides by a tensor on the scores' device, an IEEE
    division everywhere (on CUDA a Python scalar divisor is a multiply
    by its reciprocal)."""
    d = q.shape[-1]
    scores = torch.einsum("blhgd,bmhd->bhglm", q.float(), k.float())
    scores = scores / torch.full((), math.sqrt(d), dtype=torch.float32,
                                 device=scores.device)
    scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhglm,bmhd->blhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


#: f32 score bytes of one chunk of queries in ``grouped_attention`` when
#: no gradient is taken (prefill): rows x heads x chunk x keys x 4
NO_GRAD_SCORE_BYTES = 1 << 30


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``_attention_grouped`` over full query heads: q (b, lq, hq, d),
    k/v (b, lk, hkv, d), mask (lq, lk) -> (b, lq, hq, d).  Without a
    gradient (prefill) the queries go in chunks whose f32 scores take at
    most ``NO_GRAD_SCORE_BYTES``: each row's scores, mask and softmax
    are the unchunked form's, and the scores of 32k keys fit a card."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    rows = lq
    if not torch.is_grad_enabled():
        rows = max(1, NO_GRAD_SCORE_BYTES // (b * hq * k.shape[1] * 4))
    outs = [_attention_grouped(
        q[:, i:i + rows].reshape(b, -1, hkv, hq // hkv, d), k, v,
        mask[i:i + rows]).reshape(b, -1, hq, d) for i in range(0, lq, rows)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention with the structured mask
    ``causal_window_mask(lq, lk, q_offset=lk-lq, window=window)``:
    q (b, lq, hq, d); k/v (b, lk, hkv, d) -> (b, lq, hq, d).

    Without a mesh, through the kernel registry (the flash kernel or its
    plain version, by ``cfg.kernels``).  With mesh rules installed
    (``sharding.use_rules``), the reference's mesh formulations in plain
    PyTorch, as the reference computes them in XLA
    (``masked_attention``): sequence-parallel rules take the grouped
    form, tensor-parallel ones the head-broadcast form in query chunks
    of ``cfg.attn_chunk``.  No flash kernel runs on a mesh, in either
    package.

    Decode runs the reference's lq == 1 path, ``_attention_grouped``
    over the cache's slot-validity mask (``decode_attention_block``):
    that mask is a ring's, not the causal structure, so it never reaches
    the flash kernel."""
    if has_mesh():
        lq, lk = q.shape[1], k.shape[1]
        if causal:
            mask = causal_window_mask(lq, lk, q_offset=lk - lq,
                                      window=window, device=q.device)
        else:
            mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
        return masked_attention(cfg, q, k, v, mask)
    return K.attention(q, k, v, causal=causal, window=window,
                       kernels=cfg.kernels)


def _attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Attention over full query heads and an explicit (lq, lk) mask,
    True = attend: q/k/v (b, l, hq, d), k and v already broadcast to hq
    heads.  The reference's XLA form: scores summed in f32 and divided
    by sqrt(d) (a tensor divisor, as in ``_attention_grouped``), masked
    with ``NEG_INF``, softmax in f32, the probabilities rounded to v's
    dtype before ``P·V`` (summed in f32)."""
    d = q.shape[-1]
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    scores = scores / torch.full((), math.sqrt(d), dtype=torch.float32,
                                 device=scores.device)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def masked_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Attention over an explicit (lq, lk) mask (True = attend), as the
    reference computes it when no causal structure is asserted (the
    encoder-decoder's self- and cross-attention) or a mesh is installed:
    it never reaches the kernel registry.  q (b, lq, hq, d); k/v
    (b, lk, hkv, d).

    One query (decode), or sequence-parallel rules (the reference's SP
    mode: heads unsharded, queries seq-sharded), take the grouped form;
    otherwise (TP mode) k and v are broadcast to hq heads and, when
    ``cfg.attn_chunk`` divides lq into more than one chunk, the queries
    go in chunks of that many rows: the same rows, with the score block
    bounded to (chunk x lk) — not an online softmax."""
    lq, hq = q.shape[1], q.shape[2]
    g = hq // k.shape[2]
    if lq == 1 or sp_mode():
        return grouped_attention(q, k, v, mask)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return heads_attention(cfg, q, k, v, mask)


def heads_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The tensor-parallel form over heads already broadcast (q, k, v
    with one head count): when ``cfg.attn_chunk`` divides lq into more
    than one chunk, the queries go in chunks of that many rows."""
    lq = q.shape[1]
    chunk = cfg.attn_chunk
    if chunk <= 0 or lq <= chunk or lq % chunk:
        return _attention_heads(q, k, v, mask)
    return torch.cat([_attention_heads(q[:, i:i + chunk], k, v,
                                       mask[i:i + chunk])
                      for i in range(0, lq, chunk)], dim=1)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matmul."""
    b, l, d = x.shape
    return (x.reshape(b * l, d) @ w.reshape(d, -1)).view(b, l, *w.shape[1:])


def _qkv(cfg: ModelConfig, x: torch.Tensor, w: Dict[str, torch.Tensor],
         cos: Optional[torch.Tensor], sin: Optional[torch.Tensor]):
    """The sublayer's projections, biases, q/k norms and rotary."""
    q = _project(x, w["wq"])
    k = _project(x, w["wk"])
    v = _project(x, w["wv"])
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], kernels=cfg.kernels)
        k = rms_norm(k, w["k_norm"], kernels=cfg.kernels)
    if cfg.use_rope:
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def wide_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (n, k) @ w (k, m) in f32, unrounded: on the card in bf16 one
    tensor-core product that accumulates and writes f32
    (``aten::mm.dtype``), elsewhere an f32 product.
    A mesh sums such partial products over its ranks before it rounds
    them once, as the one-device product rounds its sum."""
    if x.device.type != "cpu" and x.dtype == w.dtype == torch.bfloat16:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _out_project(out: torch.Tensor, wo: torch.Tensor,
                 wide: bool = False) -> torch.Tensor:
    """einsum("blhk,hkd->bld") as one matmul (``wide``: in f32,
    ``wide_product``)."""
    b, l = out.shape[:2]
    hq, hd, d = wo.shape
    x2, w2 = out.reshape(b * l, hq * hd), wo.reshape(hq * hd, d)
    return (wide_product(x2, w2) if wide else x2 @ w2).view(b, l, d)


def attention_block(cfg: ModelConfig, x: torch.Tensor,
                    w: Dict[str, torch.Tensor], cos: torch.Tensor,
                    sin: torch.Tensor, *, collect_kv: bool = False):
    """Full self-attention sublayer (training / prefill path), causal
    with ``cfg.sliding_window``.  With ``collect_kv`` also returns the
    post-rotary ``(k, v)``: the prefill path stacks them into the
    serving KV cache."""
    q, k, v = _qkv(cfg, x, w, cos, sin)
    out = attention(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    out = _out_project(out, w["wo"])
    if collect_kv:
        return out, (k, v)
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (int8 values, f32 per-row scale).  Symmetric.

    Both divisions are tensor by tensor, so the codes are the CPU's on
    the card too: a Python-scalar divisor would be a multiply by its
    reciprocal there, which moves codes at the rounding edges."""
    xf = x.float()
    amax = torch.clamp(torch.amax(xf.abs(), dim=-1), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def decode_attention_block(cfg: ModelConfig, x: torch.Tensor,
                           w: Dict[str, torch.Tensor],
                           cache: Dict[str, torch.Tensor], index: int,
                           ) -> torch.Tensor:
    """One-token decode over a KV cache, updated in place.

    x (b, 1, d); cache {'k','v'} (b, S, hkv, hd) with ring semantics
    when the config's sliding window is smaller than S.  With
    ``cfg.kv_cache_dtype == 'int8'`` the cache holds quantized values
    plus per-(token, head) scales ('k_scale'/'v_scale', (b, S, hkv)).
    ``index`` (the token's position) is a host int: the decode loop is
    driven from Python.
    """
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    cos = sin = None
    if cfg.use_rope:
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        cos, sin = rotary_embedding(pos, cfg.resolved_head_dim,
                                    cfg.rope_theta)
    q, k, v = _qkv(cfg, x, w, cos, sin)

    slot = index % s_max                      # ring slot (SWA caches)
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_scale"][:, slot] = ks[:, 0]
        cache["v_scale"][:, slot] = vs[:, 0]
        ck = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]

    # validity of each ring slot for the current query position: slot s
    # was last written 'age' tokens ago (age = (cur_slot - s) mod S); it
    # holds a real token iff age <= index (cold start: slots "older"
    # than the stream are unwritten and would attend as zero vectors)
    slots = torch.arange(s_max, device=x.device)
    age = (slot - slots) % s_max
    valid = age <= index
    if cfg.sliding_window is not None:
        valid &= age < cfg.sliding_window
    hq, hkv = q.shape[2], ck.shape[2]
    out = _attention_grouped(
        q.reshape(b, 1, hkv, hq // hkv, q.shape[-1]), ck, cv,
        valid[None, :])
    return _out_project(out.reshape(q.shape), w["wo"])


# ----------------------------------------------------------------- MLP
def mlp_block(cfg: ModelConfig, x: torch.Tensor,
              w: Dict[str, torch.Tensor], wide: bool = False
              ) -> torch.Tensor:
    """SwiGLU (``cfg.act == "silu"``) or, for Whisper, the biased GELU
    MLP.  ``jax.nn.gelu`` is the tanh approximation by default, so the
    GELU is ``approximate="tanh"`` on f32.  ``wide``: the SwiGLU's
    ``w_down`` product in f32, unrounded (``wide_product``)."""
    b, l, d = x.shape
    x2 = x.reshape(b * l, d)
    if cfg.act == "silu":
        gate = x2 @ w["w_gate"]
        up = x2 @ w["w_up"]
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        out = wide_product(h, w["w_down"]) if wide else h @ w["w_down"]
        return out.view(b, l, d)
    h = x2 @ w["w_up"] + w["b_up"]
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return (h @ w["w_down"] + w["b_down"]).view(b, l, d)


# ----------------------------------------------------------------- embeddings
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


class _Bf16Unembed(torch.autograd.Function):
    """bf16 x @ table^T on the tensor cores, accumulated and written in
    f32 (``aten::mm.dtype``).  The backward keeps the f32 products that
    autograd of ``x.float() @ table.float().t()`` computes: the
    cotangent is f32, and the reference rounds nothing there either."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        out = wide_product(x.reshape(-1, x.shape[-1]), table.t())
        return out.view(*x.shape[:-1], table.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g2 = g.reshape(-1, table.shape[0])
        gx = gt = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ table.float()).to(x.dtype).view(x.shape)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            gt = (x2.t() @ g2).t().to(table.dtype)
        return gx, gt


def unembed(x: torch.Tensor, table: torch.Tensor,
            vocab_size: Optional[int] = None) -> torch.Tensor:
    """x (b, l, d) @ table^T (v_padded, d) -> f32 logits (b, l, v_padded).

    Products of the storage dtype are exact in f32 and summed in f32, as
    the reference's ``preferred_element_type=float32``: on CUDA in bf16,
    one tensor-core product that accumulates and writes in f32 (on fake
    ``meta`` tensors too, the dry run's trace of the card's route); on
    the CPU an f32 product.  Padded columns are masked to -1e30."""
    if x.device.type != "cpu" and x.dtype == table.dtype == torch.bfloat16:
        logits = _Bf16Unembed.apply(x, table)
    else:
        logits = x.float() @ table.float().t()
    v_padded = table.shape[0]
    if vocab_size is not None and vocab_size < v_padded:
        col = torch.arange(v_padded, device=x.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32; labels (b, l) with ignore_id masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    weights = (labels != ignore_id).float()
    return torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)
