"""The transformers' prefill on blocks (``launch.steps.build_prefill_step``
through ``models.partition`` with ``serving=True``) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.prefill_ranks``; one spawn runs every case) on
(2, 2) and (1, 4) over ('data', 'model') prefill qwen1.5-32b's f32
smoke config (QKV bias, an int8 cache) and deepseek-moe-16b's (routed
and shared experts, chunks of 8 within every sequence block) under
sequence-parallel and tensor-parallel rules, the queries in chunks of
two rows.  The oracle is the reference's ``build_prefill_step`` jitted
on a one-device mesh: under GSPMD a sharding never changes a value.

* Every rank's greedy tokens equal the reference's for its rows.
* Every rank's cache block is the reference cache's block that
  ``cache_specs`` gives it: f32 leaves (K, V, the int8 scales) within
  1e-5, int8 codes at most one step apart (a key that differs by f32
  ulps can round to the next code; ``tests/test_torch_serve.py``).
* The mesh counters of the call, exactly: per layer one FSDP gather of
  each 'data'-split leaf (an MoE's leaves over 'model' too), under SP
  one K, one V and one MLP-input gather and the MLP's reduce-scatter,
  under TP the heads' gathers for the cache and the Megatron
  all-reduces; the embedding's reduce-scatter (SP) or all-reduce (TP),
  under SP one broadcast of the last position, and the two all-reduces
  of the greedy token.  Prefill has no backward.
* No rank allocates a whole layer-stacked leaf.
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry, transformer
from repro_torch.models.partition import (_dim_axes, _spec_paths,
                                          _split_over, partition_for)
from repro_torch.models.sharding import (PartitionSpec, multi_pod_rules,
                                         single_pod_rules)

TOL = 1e-5
MESHES = (("2x2", (2, 2), ("data", "model")),
          ("1x4", (1, 4), ("data", "model")))
DEADLINE_S = 180.0
TOKENS = np.random.RandomState(7).randint(
    0, 256, (ranks.BATCH, ranks.SEQ)).astype(np.int32)


def _oracle():
    """The reference's prefill (token, cache) per (arch, mode)."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    out = {}
    for arch, chunk in ranks.PREFILL_ARCHS:
        for sp in (True, False):
            cfg = jax_smoke(arch).scaled(sequence_parallel=sp)
            cfg = cfg.scaled(moe_chunk=chunk) if chunk else cfg
            b = jsteps.build_prefill_step(
                cfg, jm, JShapeSpec("p", ranks.SEQ, ranks.BATCH, "prefill"))
            fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                         out_shardings=b.out_shardings)
            params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
            toks = jnp.asarray(TOKENS)
            with jm:
                tok, cache = fn(params, {"tokens": toks, "labels": toks})
            out[f"{arch}/{'sp' if sp else 'tp'}"] = (
                np.asarray(tok), {k: np.asarray(v) for k, v in cache.items()})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inits = {arch: jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jax_smoke(arch),
                                          jax.random.PRNGKey(0)))
        for arch, _ in ranks.PREFILL_ARCHS}
    out = {}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.prefill_ranks, 4,
                str(tmp_path_factory.mktemp("prefill")),
                args=(MESHES, inits, TOKENS), timeout=DEADLINE_S)
        except BaseException as e:      # re-raised in the test process
            out["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        out["oracle"] = _oracle()
    finally:
        t.join()
    if "error" in out:
        raise out["error"]
    return out


def _expected_counts(cfg, sizes, sp: bool):
    """The collectives of one partitioned prefill by the design (module
    docstring)."""
    d, m = sizes["data"], sizes["model"]
    rules = single_pod_rules(sizes, sp=sp, role="tp")
    specs = registry.param_specs(cfg, rules)
    n = cfg.n_layers
    ag = rs = ar = 0
    for path, spec in _spec_paths(specs["layers"]):
        if d > 1 and _split_over(spec, "data"):
            ag += n
        if path[0] == "moe" and m > 1 and _split_over(spec, "model"):
            ag += n
    tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
    ag += sum(d > 1 and _split_over(specs[t], "data") for t in tables)
    moe = cfg.moe is not None
    attn = specs["layers"]["attn"]
    heads = m > 1 and "model" in _dim_axes(attn["wq"], 2)
    kv = m > 1 and "model" in _dim_axes(attn["wk"], 2)
    if m > 1 and sp:
        ag += n * (2 + (0 if moe else 1))          # K, V, the MLP input
        rs += 1 + (0 if moe else n)                # embedding, MLP out
    elif m > 1:
        ag += n * 2 * (heads and kv)               # the cache's heads
        ar += 1 + n * (int(heads) + (0 if moe else 1))
    ar += 2 if m > 1 else 0                        # the greedy token
    bc = 1 if (m > 1 and sp) else 0
    return {"all_gather": ag, "reduce_scatter": rs, "all_reduce": ar,
            "broadcast": bc}


CASES = [(mesh, arch, mode) for mesh, _, _ in MESHES
         for arch, _ in ranks.PREFILL_ARCHS for mode in ("sp", "tp")]


@pytest.mark.parametrize("mesh,arch,mode", CASES)
def test_partitioned_prefill_matches_the_reference(mesh, arch, mode,
                                                   results):
    want_tok, want_cache = results["oracle"][f"{arch}/{mode}"]
    shape = dict((m[0], m[1]) for m in MESHES)[mesh]
    sizes = dict(zip(("data", "model"), shape))
    chunk = dict(ranks.PREFILL_ARCHS)[arch]
    cfg = ranks.prefill_cfg(arch, chunk, mode == "sp")
    want_counts = _expected_counts(cfg, sizes, mode == "sp")
    quantized = cfg.kv_cache_dtype == "int8"
    flips = 0
    for out in results["ranks"]:
        rec = out[f"{mesh}/{arch}/{mode}"]
        assert rec["partitioned"]
        lo, hi = rec["token_rows"]
        np.testing.assert_array_equal(rec["tokens"], want_tok[lo:hi])
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
        # the rank holds a block of the sequence where 'model' splits it
        full = want_cache["k"].shape
        assert rec["cache"]["k"].shape[2] == full[2] // sizes["model"]
        got_counts = {k: rec["counts"][k] for k in want_counts}
        assert got_counts == want_counts, (got_counts, want_counts)
        assert rec["counts"]["block_copies"] == 0
        assert rec["watched"] and rec["allocated"] == []
    print(f"{mesh}/{arch}/{mode}: int8 codes one step apart: {flips}")


def test_prefill_refuses_a_cache_layout_it_cannot_produce():
    """A sliding window's ring, or a cache whose batch the data axis
    does not split (its sequence then over ('data', 'model')), is
    refused, not gathered whole."""

    class Mesh:                      # the sizes and names are all it reads
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    sizes = {"data": 2, "model": 2}
    rules = single_pod_rules(sizes, sp=True, role="tp")
    for cfg, batch, match in (
            (get_smoke_config("qwen1.5-32b").scaled(sliding_window=8), 4,
             "ring"),
            (get_smoke_config("qwen1.5-32b"), 1, "split as")):
        part = partition_for(cfg, Mesh(), rules,
                             registry.param_specs(cfg, rules), ("data",),
                             serving=True)
        with pytest.raises(ValueError, match=match):
            part.check_cache(transformer.cache_specs(cfg, batch, 32, rules))
    # the production layout coincides (the module docstring's example)
    cfg = get_smoke_config("qwen1.5-32b")
    part = partition_for(cfg, Mesh(), rules, registry.param_specs(cfg, rules),
                         ("data",), serving=True)
    spec = transformer.cache_specs(cfg, 4, 32, rules)
    part.check_cache(spec)
    assert set(spec.values()) == {PartitionSpec(None, "data", "model")}
    # qwen1.5-32b's prefill_32k cell on the production meshes
    big = get_config("qwen1.5-32b")
    for rules, batch in ((single_pod_rules({"data": 16, "model": 16}),
                          "data"),
                         (multi_pod_rules({"pod": 2, "data": 16,
                                           "model": 16}), ("pod", "data"))):
        spec = transformer.cache_specs(big, 32, 32768, rules)
        assert set(spec.values()) == {PartitionSpec(None, batch, "model")}
