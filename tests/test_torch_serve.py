"""repro_torch's serving path against the reference's, on the CPU: the
dense prefill and KV-cache decode (f32 and int8 caches, the sliding
window's ring), the MoE transformers' and qwen1.5-32b's (int8 cache)
prefill and decode, the Jamba hybrid's decode (Mamba recurrence,
attention cache, MoE), and the ``Decoder`` over one packed wire for the
dense, MoE, ``vlm``, hybrid and ``ssm`` (xLSTM) families.

Parameters come from the reference's ``registry.init_params(cfg,
PRNGKey(0))`` and cross through numpy; token ids come from
``np.random.RandomState`` with the seed each test states.  The
reference runs as its own tests run it (jitted, on the CPU, with
``kernels="auto"``: its plain formulations there, as the port's).

Tolerances, all f32: logits 2e-4 (absolute and relative; the ring cache
3e-4, the hybrid 1e-4), the KV cache 1e-5, the hybrid's scan state and
conv tail 1e-5 of their largest magnitude.  The two packages sum the
projections in different orders (measured differences: logits below
2.3e-6, hybrid logits below 1.3e-5).  ``quantize_kv`` is bitwise on the
same input; inside a decode the int8 codes come from keys that differ
by f32 ulps, so a code may sit one step away at a rounding edge.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.models.config import ModelConfig as JModelConfig
from repro.ps.sharded.plan import build_shard_plan as jax_plan
from repro.serve import Decoder as JDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, registry, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.ps.sharded.plan import build_shard_plan
from repro_torch.serve import Decoder

torch.set_num_threads(2)

TOL = 2e-4
RING_TOL = 3e-4
HYBRID_TOL = 1e-4
KV_TOL = 1e-5
STATE_TOL = 1e-5
JAMBA = "jamba-v0.1-52b"


def _dense(**kw):
    """The reference's serving-consistency config, in both packages."""
    base = dict(name="t", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256,
                dtype="float32", remat="none")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _smoke(arch):
    """An architecture's smoke config in both packages."""
    return (dataclasses.replace(jax_smoke(arch), kernels="auto"),
            get_smoke_config(arch))


def _jamba():
    return _smoke(JAMBA)


def _params(jcfg):
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, from_numpy_tree(jparams, "cpu")


def _tokens(seed, b, l, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, l)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# ------------------------------------------------------------- prefill
def test_prefill_logits_and_kv_cache_match_reference():
    jcfg, cfg = _dense()
    jparams, params = _params(jcfg)
    toks = _tokens(0, 2, 12)
    jlogits, jcache = jtransformer.forward_prefill(jcfg, jparams,
                                                   jnp.asarray(toks))
    with torch.inference_mode():
        logits, cache = transformer.forward_prefill(cfg, params,
                                                    _t(toks).long())
    assert tuple(logits.shape) == (2, 1, cfg.padded_vocab)
    _close(logits, jlogits, TOL, "last-position logits")
    assert sorted(cache) == sorted(jcache) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape == (
            cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.resolved_head_dim)
        _close(cache[name], jcache[name], KV_TOL, name)


# ----------------------------------------------------------- int8 codes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_reference(dtype):
    """Codes and scales bit for bit on one input, with values placed at
    the rounding edges (x / scale = n + 1/2) and an all-zero row (the
    1e-8 floor)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 7, 2, 32) * 3.0).astype(np.float32)
    x[0, 0, 0] = (np.arange(32) - 15.5) * (2.0 / 127.0)
    x[0, 0, 0, 0] = 2.0
    x[1, 1, 1] = 0.0
    if dtype == "bfloat16":
        xt = _t(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = _t(x), jnp.asarray(x)
    q, s = layers.quantize_kv(xt)
    jq, js = jlayers.quantize_kv(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = layers.dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlayers.dequantize_kv(jq, js, jnp.float32)))


# ----------------------------------------------- decode from the prefill
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_decode_continues_prefill_cache(kv_dtype):
    """The reference's ``test_decode_continues_prefill_cache`` setting:
    prefill 6 positions, then decode 6 teacher-forced.  Each step both
    packages start from the reference's cache; the port's logits and
    the slot it wrote are held against the reference's."""
    jcfg, cfg = _dense(kv_cache_dtype=kv_dtype)
    jparams, params = _params(jcfg)
    b, l_prompt, l_total = 2, 6, 12
    toks = _tokens(0, b, l_total)
    full, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(toks))
    _, jcache = jtransformer.forward_prefill(jcfg, jparams,
                                             jnp.asarray(toks[:, :l_prompt]))
    pad = l_total - l_prompt
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, pad))
                         + ((0, 0),) * (v.ndim - 3))
              for k, v in jcache.items()}
    flips = 0
    for i in range(l_prompt, l_total):
        cache = {k: _t(v) for k, v in jcache.items()}
        with torch.inference_mode():
            logits, cache = transformer.forward_decode(
                cfg, params, _t(toks[:, i:i + 1]).long(), cache, i)
        jlogits, jcache = jtransformer.forward_decode(
            jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
            jnp.int32(i))
        _close(logits, jlogits, TOL, f"pos {i}")
        if kv_dtype == "":
            _close(logits[:, 0], full[:, i], TOL, f"pos {i} vs forward")
        for name in sorted(cache):
            got, want = cache[name].numpy(), np.asarray(jcache[name])
            if name in ("k", "v") and kv_dtype == "int8":
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (name, i)
                flips += int((diff > 0).sum())
            else:
                _close(got, want, KV_TOL, f"{name} pos {i}")
    print(f"int8 codes one step apart: {flips}")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-moe-16b",
                                  "qwen1.5-32b"])
def test_smoke_config_prefill_and_decode_match_reference(arch):
    """The MoE transformers (q/k norms and routed experts; routed and
    shared experts) and qwen1.5-32b (QKV bias, head dim 12, an int8
    cache): the prefill's last logits and cache, then 6 teacher-forced
    decode steps, each from the reference's cache, the one-token MoE
    in a single dispatch.  Logits and the slot written are held against
    the reference's; an int8 code may sit one step away."""
    jcfg, cfg = _smoke(arch)
    quantized = cfg.kv_cache_dtype == "int8"
    assert quantized == (arch == "qwen1.5-32b")
    jparams, params = _params(jcfg)
    b, l_prompt, l_total = 2, 6, 12
    toks = _tokens(0, b, l_total)
    jlogits, jcache = jtransformer.forward_prefill(
        jcfg, jparams, jnp.asarray(toks[:, :l_prompt]))
    with torch.inference_mode():
        logits, cache = transformer.forward_prefill(
            cfg, params, _t(toks[:, :l_prompt]).long())
    _close(logits, jlogits, TOL, "prefill logits")
    assert sorted(cache) == sorted(jcache)
    flips = 0

    def check_cache(cache, jcache, what):
        nonlocal flips
        for name in sorted(cache):
            got, want = cache[name].numpy(), np.asarray(jcache[name])
            assert got.shape == want.shape, name
            if name in ("k", "v") and quantized:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (name, what)
                flips += int((diff > 0).sum())
            else:
                _close(got, want, KV_TOL, f"{name} {what}")

    check_cache(cache, jcache, "prefill")
    pad = l_total - l_prompt
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, pad))
                         + ((0, 0),) * (v.ndim - 3))
              for k, v in jcache.items()}
    for i in range(l_prompt, l_total):
        cache = {k: _t(v) for k, v in jcache.items()}
        with torch.inference_mode():
            logits, cache = transformer.forward_decode(
                cfg, params, _t(toks[:, i:i + 1]).long(), cache, i)
        jlogits, jcache = jtransformer.forward_decode(
            jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
            jnp.int32(i))
        _close(logits, jlogits, TOL, f"pos {i}")
        check_cache(cache, jcache, f"pos {i}")
    print(f"{arch}: int8 codes one step apart: {flips}")


def test_sliding_window_ring_cache_matches_reference():
    """``sliding_window=4`` over 10 positions: the port's ring (capped
    at the window) against the reference's ring decode and its windowed
    full forward, position by position."""
    jcfg, cfg = _dense(sliding_window=4)
    jparams, params = _params(jcfg)
    b, l = 2, 10
    toks = _tokens(0, b, l)
    full, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(toks))
    jcache = jregistry.family(jcfg).init_state(jcfg, b, l)
    cache = registry.family(cfg).init_state(cfg, b, l)
    assert cache["k"].shape[2] == 4
    for i in range(l):
        with torch.inference_mode():
            logits, cache = transformer.forward_decode(
                cfg, params, _t(toks[:, i:i + 1]).long(), cache, i)
        jlogits, jcache = jtransformer.forward_decode(
            jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
            jnp.int32(i))
        _close(logits, jlogits, RING_TOL, f"pos {i} vs reference decode")
        _close(logits[:, 0], full[:, i], RING_TOL, f"pos {i} vs forward")


# ---------------------------------------------------------------- hybrid
def test_hybrid_decode_matches_reference_step_by_step():
    """The Jamba smoke config, MoE on: 8 tokens, each package carrying
    its own state; logits, and the Mamba state's ``h`` and ``conv``
    (relative to their largest magnitude), at every step."""
    jcfg, cfg = _jamba()
    assert cfg.moe is not None
    jparams, params = _params(jcfg)
    b, l = 2, 8
    toks = _tokens(1, b, l)
    jstate = jregistry.family(jcfg).init_state(jcfg, b, l)
    state = registry.family(cfg).init_state(cfg, b, l)
    jstep = jax.jit(lambda p, t, s, i: jregistry.decode_fn(jcfg)(p, t, s, i))
    step = registry.decode_fn(cfg)
    for i in range(l):
        jlogits, jstate = jstep(jparams, jnp.asarray(toks[:, i:i + 1]),
                                jstate, jnp.int32(i))
        with torch.inference_mode():
            logits, state = step(params, _t(toks[:, i:i + 1]).long(),
                                 state, i)
        _close(logits, jlogits, HYBRID_TOL, f"logits pos {i}")
        for part, name in (("mamba", "h"), ("mamba", "conv"),
                           ("kv", "k"), ("kv", "v")):
            want = np.asarray(jstate[part][name])
            got = state[part][name].numpy()
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= STATE_TOL * scale, \
                (part, name, i)


def test_mamba_decode_step_matches_reference():
    """One recurrence step of one Mamba slot from a non-zero state."""
    from repro.models import ssm as jssm
    jcfg, cfg = _jamba()
    jparams, params = _params(jcfg)
    slot = 0  # a Mamba slot (attention sits at offset 1)
    jw = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["slots"][slot]["mamba"])
    w = {k: v[0] for k, v in params["slots"][slot]["mamba"].items()}
    rng = np.random.RandomState(4)
    di = cfg.expand * cfg.d_model
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    conv = rng.randn(3, cfg.d_conv - 1, di).astype(np.float32)
    h = rng.randn(3, di, cfg.d_state).astype(np.float32)
    jout, jst = jssm.mamba_decode(jcfg, jnp.asarray(x), jw,
                                  {"conv": jnp.asarray(conv),
                                   "h": jnp.asarray(h)})
    out, st = ssm.mamba_decode(cfg, _t(x), w, {"conv": _t(conv),
                                               "h": _t(h)})
    _close(out, jout, HYBRID_TOL, "out")
    for name in ("conv", "h"):
        want = np.asarray(jst[name])
        assert np.abs(st[name].numpy() - want).max() <= \
            STATE_TOL * np.abs(want).max(), name


# ---------------------------------------------------------------- Decoder
def _decoders(jcfg, cfg, jparams, *, prompt_len, max_new, max_batch,
              n_shards=2):
    """One packed wire (numpy) from the reference's plan, and both
    packages' ``Decoder``s over plans of the same arity."""
    jplan = jax_plan(jparams, n_shards)
    wire = np.asarray(jplan.pack(jparams))
    plan = build_shard_plan(registry.abstract_params(cfg), n_shards)
    assert plan.wire_layout().total_rows == wire.shape[0]
    kw = dict(prompt_len=prompt_len, max_new=max_new, max_batch=max_batch)
    return wire, JDecoder(jcfg, jplan, **kw), Decoder(cfg, plan,
                                                      device="cpu", **kw)


def _reference_logits(jdec, wire, prompts, tokens):
    """The reference decoder's logits at every generated position,
    teacher-forced along ``tokens`` (its own greedy output):
    (b, max_new, v)."""
    p = jdec._unpack(jnp.array(wire))
    toks = jnp.asarray(prompts)
    if not jdec._recurrent:
        last, cache = jdec._prefill(p, toks)
    else:
        cache = jdec._init_state(prompts.shape[0])
        for i in range(prompts.shape[1]):
            last, cache = jdec._step(p, toks[:, i:i + 1], cache,
                                     jnp.int32(i))
            last = last[:, -1]
    out = [last]
    for j in range(tokens.shape[1] - 1):
        logits, cache = jdec._step(p, jnp.asarray(tokens[:, j:j + 1]),
                                   cache, jnp.int32(prompts.shape[1] + j))
        out.append(logits[:, -1])
    return np.stack([np.asarray(o) for o in out], axis=1)


def _port_logits(dec, wire, prompts, tokens):
    params = dec.params(wire)
    last, state = dec.prefill(params, _t(prompts).long())
    out = [last]
    for j in range(tokens.shape[1] - 1):
        logits, state = dec.step(params, _t(tokens[:, j:j + 1]).long(),
                                 state, prompts.shape[1] + j)
        out.append(logits)
    return torch.stack(out, dim=1).numpy()


def _agreeing_tokens(got, want, ref_logits, tol):
    """Greedy tokens must agree wherever the reference's top-2 margin
    exceeds ``tol``; a row whose tokens part at a closer call is not
    compared past it (its prefixes differ).  Returns the positions not
    compared."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    excluded = 0
    for r in range(want.shape[0]):
        for j in range(want.shape[1]):
            if margin[r, j] <= tol:
                if got[r, j] != want[r, j]:
                    excluded += want.shape[1] - j
                    break
                excluded += 1
                continue
            assert got[r, j] == want[r, j], (r, j, margin[r, j])
    return excluded


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe", "vlm",
                                    "ssm"])
def test_decoder_matches_reference_decoder(family):
    """Both packages' ``Decoder``s on one wire and the same prompts:
    teacher-forced logits along the reference's greedy tokens, the
    greedy tokens themselves, and a short batch padded and sliced.
    ``moe`` is deepseek-moe-16b's smoke config (routed and shared
    experts), ``vlm`` chameleon-34b's (q/k norms), ``ssm`` xlstm-125m's
    (mLSTM and sLSTM recurrences, prefilled token by token)."""
    if family in ("dense", "moe", "vlm", "ssm"):
        jcfg, cfg = {"dense": _dense,
                     "moe": lambda: _smoke("deepseek-moe-16b"),
                     "vlm": lambda: _smoke("chameleon-34b"),
                     "ssm": lambda: _smoke("xlstm-125m")}[family]()
        assert cfg.family == family
        kw, tol = dict(prompt_len=8, max_new=6, max_batch=4), TOL
    else:
        jcfg, cfg = _jamba()
        kw, tol = dict(prompt_len=6, max_new=4, max_batch=2), HYBRID_TOL
    jparams, _ = _params(jcfg)
    wire, jdec, dec = _decoders(jcfg, cfg, jparams, **kw)
    prompts = _tokens(2, kw["max_batch"], kw["prompt_len"])

    want = jdec.decode(wire, prompts)
    ref = _reference_logits(jdec, wire, prompts, want)
    got_logits = _port_logits(dec, wire, prompts, want)
    _close(got_logits, ref, tol, "teacher-forced logits")

    got = dec.decode(wire, prompts)
    assert got.shape == want.shape == (kw["max_batch"], kw["max_new"])
    assert got.dtype == np.int32
    excluded = _agreeing_tokens(got, want, ref, tol)
    print(f"{family}: {excluded} of {want.size} token positions within "
          f"the tolerance's margin, not compared")

    short = prompts[:-1]
    got_short = dec.decode(wire, short)
    want_short = jdec.decode(wire, short)
    assert got_short.shape == want_short.shape == (len(short),
                                                   kw["max_new"])
    padded = np.concatenate([short, short[-1:]], axis=0)
    ref_short = _reference_logits(jdec, wire, padded, jdec.decode(
        wire, padded))[:len(short)]
    _agreeing_tokens(got_short, want_short, ref_short, tol)


def test_decoder_rejects_oversized_batches_and_rebuilds_plans():
    jcfg, cfg = _dense()
    jparams, _ = _params(jcfg)
    wire, _, dec = _decoders(jcfg, cfg, jparams, prompt_len=4, max_new=2,
                             max_batch=2)
    with pytest.raises(ValueError, match="do not fit"):
        dec.decode(wire, np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="do not fit"):
        dec.decode(wire, np.zeros((2, 5), np.int32))
    other = dec.rebuilt(3)
    assert other.plan.n_shards == 3 and other.device == dec.device
    # the same weights packed at the new arity decode to the same tokens
    wire3 = other.plan.pack(dec.plan.unpack(_t(wire)))
    prompts = _tokens(5, 2, 4)
    np.testing.assert_array_equal(other.decode(wire3, prompts),
                                  dec.decode(wire, prompts))


def test_decoder_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the decoder would run")
    jcfg, cfg = _dense()
    plan = build_shard_plan(registry.abstract_params(cfg), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Decoder(cfg, plan, prompt_len=4, max_new=2, max_batch=2)
