"""repro_torch's Whisper backbone (``models/encdec.py``) and its building
blocks against the reference's, on the CPU: ``layer_norm`` and the
layernorm branches of ``apply_norm`` / ``residual_apply_norm``, the GELU
MLP, ``_sinusoid``, ``_attention_heads`` and the chunked masked
attention, ``encode``, ``decode_train``, and ``forward_decode`` from
``prefill_cross_kv``; and the worker batches' ``frames``, which reach
the loss as the synthetic stream's f32 values.

Weights are the reference's ``registry.init_params`` of the
whisper-tiny smoke config (d_model 64, 4 heads, 2 + 2 layers), biases
made random where the init leaves them zero; inputs come from
``np.random.RandomState`` with the seed each test states.

Tolerances: 1e-5 of the largest magnitude for f32 outputs (measured:
below 1e-6), 2 bf16 ulps of it for bf16 ones; decode logits 2e-4 and
caches 1e-5, as ``tests/test_torch_serve.py``'s.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jax_batches
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch import api
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.models import encdec, layers
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(2)

ARCH = "whisper-tiny"
TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8
LOGIT_TOL = 2e-4
KV_TOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _params(seed=0):
    """The smoke config's parameters, every zero-initialised bias made
    random (JAX tree, torch tree)."""
    jcfg, _ = _cfgs()
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        if path[-1].key in ("b_up", "b_down", "bias"):
            return jnp.asarray(rng.randn(*leaf.shape).astype(np.float32)
                               * 0.1)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return params, from_numpy_tree(params, "cpu")


def _rand(seed, shape, dtype="float32", scale=1.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)
    return jnp.asarray(x, dtype=jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _close(got, want, tol, what):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max |err| {err} (scale {scale})"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_the_layernorm_branches(dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jx, tx = _rand(0, (3, 5, 64), dtype, scale=3.0)
    jd, td = _rand(1, (3, 5, 64), dtype)
    jw, tw = _rand(2, (64,), dtype)
    jb, tb = _rand(3, (64,), dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(layers.layer_norm(tx, tw, tb), jlayers.layer_norm(jx, jw, jb),
           tol, "layer_norm")
    w, jwd = {"scale": tw, "bias": tb}, {"scale": jw, "bias": jb}
    _close(layers.apply_norm(cfg, tx, w), jlayers.apply_norm(jcfg, jx, jwd),
           tol, "apply_norm")
    s, n = layers.residual_apply_norm(cfg, td, tx, w)
    js, jn = jlayers.residual_apply_norm(jcfg, jd, jx, jwd)
    _close(s, js, tol, "residual sum")
    _close(n, jn, tol, "residual norm")
    assert n.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_is_the_tanh_gelu_with_biases(dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams, params = _params()
    jw = {k: jnp.asarray(v[0], jnp.dtype(dtype))
          for k, v in jparams["encoder"]["mlp"].items()}
    tw = {k: v[0].to(getattr(torch, dtype))
          for k, v in params["encoder"]["mlp"].items()}
    assert sorted(tw) == ["b_down", "b_up", "w_down", "w_up"]
    jx, tx = _rand(4, (2, 7, 64), dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(layers.mlp_block(cfg, tx, tw), jlayers.mlp_block(jcfg, jx, jw),
           tol, "gelu mlp")
    # the exact erf GELU is another function
    h = torch.linspace(-4.0, 4.0, 101)
    assert not torch.allclose(torch.nn.functional.gelu(h),
                              torch.nn.functional.gelu(h, approximate="tanh"),
                              atol=1e-5)


@pytest.mark.parametrize("length,d", [(7, 64), (1024, 384)])
def test_sinusoid_matches_reference(length, d):
    _close(encdec._sinusoid(length, d), jencdec._sinusoid(length, d), TOL,
           "sinusoid")


@pytest.mark.parametrize("chunk", [0, 8, 512])
@pytest.mark.parametrize("kind", ["self", "cross", "causal"])
def test_masked_attention_matches_reference(kind, chunk):
    """Whisper's attention: an explicit mask and no causal structure, so
    the reference computes ``_attention_heads`` (in chunks of
    ``attn_chunk`` query rows when that divides lq into more than one)."""
    jcfg, cfg = _cfgs(attn_chunk=chunk)
    lk = 40 if kind == "cross" else 32
    jq, tq = _rand(5, (2, 32, 4, 16))
    jk, tk = _rand(6, (2, lk, 4, 16))
    jv, tv = _rand(7, (2, lk, 4, 16))
    mask = (np.tril(np.ones((32, lk), bool)) if kind == "causal"
            else np.ones((32, lk), bool))
    want = jlayers.attention(jcfg, jq, jk, jv, mask=jnp.asarray(mask))
    got = layers.masked_attention(cfg, tq, tk, tv, torch.from_numpy(mask))
    _close(got, want, TOL, f"{kind} attention, chunk {chunk}")
    _close(layers._attention_heads(tq, tk, tv, torch.from_numpy(mask)),
           jlayers._attention_heads(jq, jk, jv, jnp.asarray(mask)), TOL,
           "_attention_heads")


def test_encode_and_decode_train_match_reference():
    jcfg, cfg = _cfgs(attn_chunk=8)         # chunked: 4 chunks of 8 rows
    jparams, params = _params()
    jframes, frames = _rand(8, (2, 32, 64), scale=0.1)
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 32))
    jenc = jencdec.encode(jcfg, jparams, jframes)
    enc = encdec.encode(cfg, params, frames)
    _close(enc, jenc, TOL, "encoder states")
    want = jencdec.decode_train(jcfg, jparams, jnp.asarray(toks), jenc)
    got = encdec.decode_train(cfg, params, torch.from_numpy(toks).long(),
                              enc)
    assert got.dtype == torch.float32
    _close(got, want, TOL, "decoder logits")


def test_forward_decode_from_prefill_cross_kv_matches_reference():
    """Encoder states, their cross K/V for every decoder layer, then six
    tokens through ``forward_decode`` over the self-attention cache: the
    logits and every cache leaf against the reference's."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    jframes, frames = _rand(10, (2, 20, 64), scale=0.1)
    toks = np.random.RandomState(11).randint(0, cfg.vocab_size, (2, 6))
    jenc = jencdec.encode(jcfg, jparams, jframes)
    jk, jv = jencdec.prefill_cross_kv(jcfg, jparams, jenc)
    jcache = jencdec.init_cache(jcfg, 2, 8, 20)
    jcache.update(cross_k=jk, cross_v=jv)
    with torch.inference_mode():
        k, v = encdec.prefill_cross_kv(cfg, params,
                                       encdec.encode(cfg, params, frames))
        cache = encdec.init_cache(cfg, 2, 8, 20)
        assert sorted(cache) == sorted(jcache)
        _close(k, jk, KV_TOL, "cross k")
        _close(v, jv, KV_TOL, "cross v")
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
        self_k = cache["self_k"]
        for i in range(toks.shape[1]):
            jlogits, jcache = jencdec.forward_decode(
                jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                jnp.int32(i))
            logits, cache = encdec.forward_decode(
                cfg, params, torch.from_numpy(toks[:, i:i + 1]).long(),
                cache, i)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["self_k"] is self_k                  # updated in place
    for name in jcache:
        _close(cache[name], jcache[name], KV_TOL, name)


def test_worker_frames_reach_the_loss_as_the_streams_f32_values(monkeypatch):
    """A one-worker whisper session on the CPU: every batch's ``frames``
    reach ``encdec.encode`` as f32, equal to the synthetic stream's, and
    the tokens as ``torch.long`` (the worker casts integer arrays only)."""
    from repro_torch.api.session import worker_batches
    cfg = get_smoke_config(ARCH)
    seen = []
    real = encdec.encode

    def spy(cfg_, params, frames):
        seen.append(frames.detach().clone())
        return real(cfg_, params, frames)

    monkeypatch.setattr(encdec, "encode", spy)
    spec = api.RunSpec(
        model=api.ModelSpec(arch=ARCH, smoke=True),
        data=api.DataSpec(seq_len=16, global_batch=2, seed=3),
        sync=api.SyncSpec(mode="bsp", s_lower=1, s_upper=4),
        ps=api.ServerSpec(kind="sharded", shards=2, workers=1,
                          apply="fused"),
        wire=api.WireSpec(format="packed", delta_pull=True))
    with api.build_session(spec, device="cpu", timeout=300.0) as s:
        m = s.run(2)
    assert m["pushes"] == 2 and np.isfinite(m["final_loss"])
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=2, seed=3)
    stream = worker_batches(cfg, data, 0, torch.device("cpu"))
    jstream = jax_batches(jax_smoke(ARCH), JDataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=4))
    assert len(seen) == 2
    for frames in seen:
        batch, jbatch = next(stream), next(jstream)
        assert batch["tokens"].dtype == torch.long
        assert frames.dtype == batch["frames"].dtype == torch.float32
        assert torch.equal(frames, batch["frames"])
        np.testing.assert_array_equal(frames.numpy(), jbatch["frames"])
        assert float(frames.abs().max()) > 0.0
