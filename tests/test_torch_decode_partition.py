"""The transformers' decode on blocks (``launch.steps.build_serve_step``
through ``models.partition`` with ``decoding=True``) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.decode_ranks``; one spawn runs every case) on (2, 2)
and (1, 4) over ('data', 'model') decode the f32 smoke configs of
qwen1.5-32b (QKV bias, an int8 cache, the batch replicated and the
cache's sequence over both axes), qwen1.5-110b (GQA, the batch and the
heads split), qwen3-moe-235b-a22b (q/k norms, an MoE) and
deepseek-moe-16b (shared experts, the K/V heads split too).  The
oracle is the reference's ``build_prefill_step`` and then
``DECODE_TOKENS`` calls of its ``build_serve_step``, jitted on a
one-device mesh: under GSPMD a sharding never changes a value.  The
ranks start from the reference's prefill (its tokens and its cache in
the first ``SEQ`` of ``DECODE_CACHE`` slots).

* Every rank's greedy tokens of every call equal the reference's for
  its rows.
* Every rank's cache block after the last call is the reference
  cache's block that ``cache_specs`` gives it: f32 leaves (K, V, the
  int8 scales) within 1e-5, int8 codes at most one step apart
  (``tests/test_torch_serve.py``).
* The mesh counters of each call, exactly: per layer one FSDP gather
  of each 'data'-split leaf (an MoE's leaves over 'model' too), q's
  heads gathered over 'model' where 'model' splits them and K and V's
  where it splits theirs, a MAX and two SUM all-reduces over each of
  the cache's sequence axes, ``wo``'s all-reduce over 'model' where the
  heads are split and the dense MLP's; the embedding's all-reduce and
  the two of the greedy token.
* No rank allocates a whole layer-stacked leaf, a whole cache leaf or
  one layer's whole cache.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import registry
from repro_torch.models.partition import (_dim_axes, _spec_paths,
                                          _split_over, partition_for)
from repro_torch.models.sharding import PartitionSpec, single_pod_rules

TOL = 1e-5
MESHES = (("2x2", (2, 2), ("data", "model")),
          ("1x4", (1, 4), ("data", "model")))
DEADLINE_S = 180.0
TOKENS = np.random.RandomState(11).randint(
    0, 256, (ranks.BATCH, ranks.SEQ)).astype(np.int32)


def _jax_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _prefills(jm, params):
    """The reference's prefill of ``TOKENS`` per arch: (greedy tokens,
    cache), numpy."""
    out = {}
    for arch in ranks.DECODE_ARCHS:
        cfg = jax_smoke(arch)
        b = jsteps.build_prefill_step(
            cfg, jm, JShapeSpec("p", ranks.SEQ, ranks.BATCH, "prefill"))
        fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        toks = jnp.asarray(TOKENS)
        with jm:
            tok, cache = fn(params[arch], {"tokens": toks, "labels": toks})
        out[arch] = (np.asarray(tok).astype(np.int32),
                     {k: np.asarray(v) for k, v in cache.items()})
    return out


def _decode_oracle(jm, params, prefills):
    """The reference's decode from each prefill: per arch the tokens of
    each call and the cache after the last."""
    out = {}
    for arch in ranks.DECODE_ARCHS:
        cfg = jax_smoke(arch)
        b = jsteps.build_serve_step(
            cfg, jm, JShapeSpec("d", ranks.DECODE_CACHE, ranks.BATCH,
                                "decode"))
        fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        first, prefill = prefills[arch]
        cache = {k: jnp.asarray(v) for k, v in
                 ranks.decode_whole_cache(cfg, prefill).items()}
        token = jnp.asarray(first)[:, None]
        tokens = []
        with jm:
            for i in range(ranks.DECODE_TOKENS):
                token, cache = fn(params[arch], token, cache,
                                  jnp.int32(ranks.SEQ + i))
                tokens.append(np.asarray(token)[:, 0])
        out[arch] = (tokens, {k: np.asarray(v) for k, v in cache.items()})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = {arch: jregistry.init_params(jax_smoke(arch),
                                          jax.random.PRNGKey(0))
              for arch in ranks.DECODE_ARCHS}
    inits = {arch: jax.tree_util.tree_map(np.asarray, p)
             for arch, p in params.items()}
    jm = _jax_mesh()
    prefills = _prefills(jm, params)
    out = {}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.decode_ranks, 4,
                str(tmp_path_factory.mktemp("decode")),
                args=(MESHES, inits, prefills), timeout=DEADLINE_S)
        except BaseException as e:      # re-raised in the test process
            out["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        out["oracle"] = _decode_oracle(jm, params, prefills)
    finally:
        t.join()
    if "error" in out:
        raise out["error"]
    return out


def _expected_counts(cfg, sizes, seq_axes):
    """The collectives of one partitioned decode call by the design
    (module docstring); ``seq_axes``: the live axes of the cache's
    sequence."""
    d, m = sizes["data"], sizes["model"]
    rules = single_pod_rules(sizes, sp=False, role="tp")
    specs = registry.param_specs(cfg, rules)
    n = cfg.n_layers
    ag = ar = 0
    for path, spec in _spec_paths(specs["layers"]):
        if d > 1 and _split_over(spec, "data"):
            ag += n
        if path[0] == "moe" and m > 1 and _split_over(spec, "model"):
            ag += n
    tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
    ag += sum(d > 1 and _split_over(specs[t], "data") for t in tables)
    attn = specs["layers"]["attn"]
    heads = m > 1 and "model" in _dim_axes(attn["wq"], 2)
    kv = m > 1 and "model" in _dim_axes(attn["wk"], 2)
    ag += n * (int(heads) + 2 * int(kv))           # q, and K and V
    ar += n * 3 * len(seq_axes)                    # the combine
    ar += n * (int(heads) + (0 if cfg.moe else int(m > 1)))  # wo, MLP
    ar += 3 if m > 1 else 0                  # embedding, greedy token
    return {"all_gather": ag, "reduce_scatter": 0, "all_reduce": ar,
            "broadcast": 0, "all_to_all": 0}


CASES = [(mesh, arch) for mesh, _, _ in MESHES
         for arch in ranks.DECODE_ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_partitioned_decode_matches_the_reference(mesh, arch, results):
    want_tokens, want_cache = results["oracle"][arch]
    shape = dict((m[0], m[1]) for m in MESHES)[mesh]
    sizes = dict(zip(("data", "model"), shape))
    cfg = get_smoke_config(arch)
    quantized = cfg.kv_cache_dtype == "int8"
    # the cache's sequence takes whatever of ('data', 'model') the batch
    # left free: both for a replicated batch
    seq_axes = tuple(a for a in ("data", "model") if sizes[a] > 1
                     and (a == "model" or not cfg.decode_batch_shard))
    want_counts = _expected_counts(cfg, sizes, seq_axes)
    flips = 0
    for out in results["ranks"]:
        rec = out[f"{mesh}/{arch}"]
        assert rec["partitioned"]
        lo, hi = rec["token_rows"]
        for got, want in zip(rec["tokens"], want_tokens):
            np.testing.assert_array_equal(got, want[lo:hi])
        assert sorted(rec["cache"]) == sorted(want_cache)
        for k, got in rec["cache"].items():
            block = want_cache[k][tuple(slice(a, b) for a, b in
                                        rec["cache_slices"][k])]
            assert got.shape == block.shape, k
            if quantized and k in ("k", "v"):
                diff = np.abs(got.astype(np.int32) - block.astype(np.int32))
                assert diff.max() <= 1, k
                flips += int((diff > 0).sum())
            else:
                np.testing.assert_allclose(got, block, atol=TOL, rtol=0)
        # the rank holds a block of the sequence, never the whole
        blocks = int(np.prod([sizes[a] for a in seq_axes]))
        assert rec["cache"]["k"].shape[2] == ranks.DECODE_CACHE // blocks
        for counts in rec["counts"]:
            got_counts = {k: counts[k] for k in want_counts}
            assert got_counts == want_counts, (got_counts, want_counts)
            assert counts["block_copies"] == 0
        assert rec["watched"] and rec["allocated"] == []
    print(f"{mesh}/{arch}: int8 codes one step apart: {flips}")


class _Mesh:
    """A (2, 2) mesh's names and sizes, all that the refusals read."""
    mesh_dim_names = ("data", "model")
    shape = (2, 2)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_decode_refuses_a_ring_cache_and_places_the_production_cache():
    """A sliding window's ring is refused, not gathered whole, and so is
    a Mamba inner dim that 'model' does not split; the hybrid's decode
    is split.  On the production 16 x 16 mesh (fake ranks) every
    transformer's decode_32k bundle is partitioned, and the cache's
    sequence takes ('data', 'model') beside a replicated batch and
    'model' beside one split over 'data'; Jamba's decode_32k state is
    placed with its KV cache's sequence over 'model' and its Mamba
    channels over 'model', its rows over 'data'."""
    sizes = {"data": 2, "model": 2}
    rules = single_pod_rules(sizes, sp=False, role="tp")
    ring = get_smoke_config("qwen1.5-110b").scaled(sliding_window=8)
    with pytest.raises(ValueError, match="ring"):
        partition_for(ring, _Mesh(), rules, registry.param_specs(ring, rules),
                      ("data",), decoding=True)
    jamba = get_smoke_config("jamba-v0.1-52b")
    part = partition_for(jamba, _Mesh(), rules,
                         registry.param_specs(jamba, rules), ("data",),
                         decoding=True)
    assert part is not None and part.decoding
    wide = type("Mesh", (_Mesh,), {"shape": (1, 4)})()
    wide_rules = single_pod_rules({"data": 1, "model": 4}, sp=False,
                                  role="tp")
    odd = jamba.scaled(d_model=65)       # di 130 does not split over 4
    with pytest.raises(ValueError, match="Mamba inner dim"):
        partition_for(odd, wide, wide_rules,
                      registry.param_specs(odd, wide_rules), ("data",),
                      decoding=True)
    replicated = {"qwen1.5-32b", "mistral-large-123b"}
    with dryrun.fake_group(256):
        mesh = mesh_lib.make_mesh((16, 16), ("data", "model"))
        for arch in ("qwen1.5-110b", "qwen1.5-32b", "mistral-large-123b",
                     "chameleon-34b", "qwen3-moe-235b-a22b",
                     "deepseek-moe-16b"):
            bundle = build_serve_step(get_config(arch), mesh,
                                      SHAPES["decode_32k"])
            want = (PartitionSpec(None, None, ("data", "model"))
                    if arch in replicated
                    else PartitionSpec(None, "data", "model"))
            assert bundle.partitioned, arch
            assert bundle.in_shardings[2]["k"] == want, arch
            part = bundle.fn.partition
            assert part.seq_axes == (("data", "model") if arch in replicated
                                     else ("model",)), arch
            assert part.seq_blocks == (256 if arch in replicated else 16)
        bundle = build_serve_step(get_config("jamba-v0.1-52b"), mesh,
                                  SHAPES["decode_32k"])
        assert bundle.partitioned
        state = bundle.in_shardings[2]
        assert state["kv"]["k"] == PartitionSpec(None, "data", "model")
        assert state["mamba"]["conv"] == PartitionSpec(None, None, "data",
                                                       None, "model")
        assert state["mamba"]["h"] == PartitionSpec(None, None, "data",
                                                    "model")
        part = bundle.fn.partition
        assert part.seq_axes == ("model",) and part.seq_blocks == 16
        # long_500k: one row, replicated; the sequence over both axes
        bundle = build_serve_step(get_config("jamba-v0.1-52b"), mesh,
                                  SHAPES["long_500k"])
        assert bundle.partitioned
        state = bundle.in_shardings[2]
        assert state["kv"]["k"] == PartitionSpec(None, None,
                                                 ("data", "model"))
        assert state["mamba"]["h"] == PartitionSpec(None, None, None,
                                                    "model")
        assert bundle.fn.partition.seq_blocks == 256


def test_decode_cache_refuses_another_state_layout():
    """``decode_cache`` takes the hybrid's state as ``state_specs``
    places it and refuses, naming the leaf, a Mamba state whose channels
    are not split as the Mamba parameters' or whose rows are split over
    another axis than the batch's."""
    from repro_torch.models import hybrid
    P = PartitionSpec
    cfg = get_smoke_config("jamba-v0.1-52b")
    sizes = {"data": 2, "model": 2}
    rules = single_pod_rules(sizes, sp=False, role="tp")
    part = partition_for(cfg, _Mesh(), rules,
                         registry.param_specs(cfg, rules), ("data",),
                         decoding=True)
    spec = hybrid.state_specs(cfg, 2, 16, rules)
    part.decode_cache(spec)
    assert part.seq_axes == ("model",) and part.seq_blocks == 2
    bad_h = dict(spec, mamba=dict(spec["mamba"],
                                  h=P(None, None, "data", None, "model")))
    with pytest.raises(ValueError, match="mamba/h"):
        part.decode_cache(bad_h)
    bad_conv = dict(spec, mamba=dict(spec["mamba"],
                                     conv=P(None, None, "model")))
    with pytest.raises(ValueError, match="mamba/conv"):
        part.decode_cache(bad_conv)
