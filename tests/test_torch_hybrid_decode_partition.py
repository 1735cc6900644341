"""The hybrid's (Jamba's) decode on blocks (``launch.steps.build_serve_step``
through ``models.partition`` with ``decoding=True``) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.hybrid_decode_ranks``; one spawn runs every case) on
(2, 2) and (1, 4) over ('data', 'model') decode Jamba's f32 smoke
config (8 layers in two period groups of a Mamba, an attention and two
more Mamba slots, MoE with 4 experts top-2 on every second slot, Mamba
inner dim 128): batch 2 on both meshes (the rows over 'data', the KV
cache's sequence over 'model'), and batch 1 on (2, 2), long_500k's
replicated rows (the sequence over ('data', 'model')).  Each case
decodes ``HYBRID_DECODE_TOKENS`` greedy tokens from two starts: a zero
state from index 0 (blocks with no valid slot), and a seeded state
(N(0, 1) K/V, conv tails and ``h``) from index 13 of a 16-slot cache, so
that the validity crosses every block.  The oracle is the reference's
``build_serve_step`` jitted on a one-device mesh from the same numpy
parameters and state (its logits from the reference's
``hybrid.forward_decode``, the function that step calls): under GSPMD a
sharding never changes a value.

* Every rank's greedy tokens of every call equal the reference's for
  its rows.
* The rank's block of the last call's logits and its block of every
  state leaf (K, V, the conv tails, ``h``) after the last call within
  ``TOL`` (1e-5) of the reference's, relative to the largest magnitude
  of the reference's logits or leaf, the rule of
  ``tests/test_torch_serve.py``'s hybrid decode: the one-device port
  itself sits up to 1.8e-5 from the reference at these values (up to
  12 in ``h``), as XLA and PyTorch order their f32 sums differently.
* The mesh counters of each call, exactly (``_expected_counts``).
* No rank allocates a whole layer-stacked leaf, a whole state leaf, or
  one group's or one slot's whole state.
* On (1, 4) the seeded start once more with ``reduce_bcdt`` the
  identity (each rank's B, C and dt from its own channels) lands far
  from the reference's logits.
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
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.models.partition import (_dim_axes, _layer_specs,
                                          _spec_paths, _split_over)
from repro_torch.models.sharding import single_pod_rules

TOL = 1e-5
#: (label, mesh shape, axes, batch)
CASES = (("2x2", (2, 2), ("data", "model"), 2),
         ("1x4", (1, 4), ("data", "model"), 2),
         ("2x2", (2, 2), ("data", "model"), 1))
#: the start's name and its first index
STARTS = (("zero", 0), ("seeded", 13))
PLANT = ("1x4", "seeded")
DEADLINE_S = 180.0


def _starts():
    """Per batch, per start: (first token (b, 1), whole state as numpy,
    index)."""
    cfg = get_smoke_config(ranks.HYBRID_ARCH)
    out = {}
    for batch in sorted({c[3] for c in CASES}):
        rng = np.random.RandomState(7 + batch)
        zeros = jax.tree_util.tree_map(
            np.asarray, jhybrid.init_state(jax_smoke(ranks.HYBRID_ARCH),
                                           batch,
                                           ranks.HYBRID_DECODE_CACHE))
        out[batch] = {}
        for name, index in STARTS:
            state = {k: {n: (np.zeros_like(x) if name == "zero" else
                             rng.standard_normal(x.shape).astype(x.dtype))
                         for n, x in v.items()}
                     for k, v in zeros.items()}
            first = rng.randint(0, cfg.vocab_size, (batch, 1)).astype(
                np.int32)
            out[batch][name] = (first, state, index)
    return out


def _oracle(params, starts):
    """The reference's decode from each start: per batch and start the
    tokens of each call, the last call's logits and the state after
    it."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    cfg = jax_smoke(ranks.HYBRID_ARCH)
    logits_of = jax.jit(
        lambda p, t, c, i: jhybrid.forward_decode(cfg, p, t, c, i)[0])
    out = {}
    for batch, by_start in starts.items():
        b = jsteps.build_serve_step(
            cfg, jm, JShapeSpec("d", ranks.HYBRID_DECODE_CACHE, batch,
                                "decode"))
        fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        for name, (first, state, index) in by_start.items():
            cache = jax.tree_util.tree_map(jnp.asarray, state)
            token = jnp.asarray(first)
            tokens = []
            with jm:
                for i in range(ranks.HYBRID_DECODE_TOKENS):
                    at = jnp.int32(index + i)
                    logits = logits_of(params, token, cache, at)
                    token, cache = fn(params, token, cache, at)
                    tokens.append(np.asarray(token)[:, 0])
            out[batch, name] = {
                "tokens": tokens,
                "logits": np.asarray(logits)[:, -1],
                "state": {f"{k}/{n}": np.asarray(x)
                          for k, v in cache.items() for n, x in v.items()}}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One four-rank run of every case, and the oracle, computed in this
    process while the ranks run."""
    params = jregistry.init_params(jax_smoke(ranks.HYBRID_ARCH),
                                   jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    starts = _starts()
    out = {}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.hybrid_decode_ranks, 4,
                str(tmp_path_factory.mktemp("hybrid_decode")),
                args=(CASES, init, starts, PLANT), timeout=DEADLINE_S)
        except BaseException as e:      # re-raised in the test process
            out["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        out["oracle"] = _oracle(params, starts)
    finally:
        t.join()
    if "error" in out:
        raise out["error"]
    return out


def _seq_axes(sizes, batch):
    """The live axes of the KV cache's sequence: 'model', and 'data'
    too where the batch does not split over it."""
    rows_split = sizes["data"] > 1 and batch % sizes["data"] == 0
    return tuple(a for a in ("data", "model") if sizes[a] > 1
                 and (a == "model" or not rows_split))


def _expected_counts(cfg, sizes, seq_axes):
    """The collectives of one partitioned decode call by the design
    (``models.partition``'s docstring): per period slot of each group
    one FSDP gather of each 'data'-split leaf and an MoE's leaves
    gathered over 'model'; an attention slot's q heads gathered over
    'model' where it splits them and K and V's where it splits theirs,
    a MAX and two SUM all-reduces over each of the cache's sequence
    axes and ``wo``'s all-reduce where the heads are split; a Mamba
    slot's ``w_in`` moved by one all-to-all and its (B, C, dt) and
    output all-reduced over 'model'; a dense MLP's all-reduce; the
    embedding's all-reduce and the two of the greedy token."""
    d, m = sizes["data"], sizes["model"]
    specs = registry.param_specs(cfg, single_pod_rules(sizes, sp=False,
                                                       role="tp"))
    ag = ar = a2a = 0
    for slot in _layer_specs(specs):
        for path, spec in _spec_paths(slot):
            ag += d > 1 and _split_over(spec, "data")
            ag += path[0] == "moe" and m > 1 and _split_over(spec, "model")
        if "attn" in slot:
            heads = m > 1 and "model" in _dim_axes(slot["attn"]["wq"], 2)
            kv = m > 1 and "model" in _dim_axes(slot["attn"]["wk"], 2)
            ag += int(heads) + 2 * int(kv)
            ar += 3 * len(seq_axes) + int(heads)
        if "mamba" in slot and m > 1:
            a2a += 1
            ar += 2
        if "mlp" in slot and m > 1:
            ar += 1
    groups = cfg.n_layers // cfg.attn_period
    tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
    top = sum(d > 1 and _split_over(specs[t], "data") for t in tables)
    return {"all_gather": groups * ag + top, "reduce_scatter": 0,
            "all_reduce": groups * ar + (3 if m > 1 else 0),
            "broadcast": 0, "all_to_all": groups * a2a}


def _close(got, whole, slices, what):
    """``got`` within ``TOL`` of its block of ``whole``, relative to the
    largest magnitude of ``whole``."""
    ref = whole[tuple(slice(a, b) for a, b in slices)]
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(whole).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case,start", [(c, s) for c in CASES
                                        for s, _ in STARTS],
                         ids=lambda v: v[0] + f"-b{v[3]}"
                         if isinstance(v, tuple) else v)
def test_partitioned_hybrid_decode_matches_the_reference(case, start,
                                                         results):
    label, shape, axes, batch = case
    want = results["oracle"][batch, start]
    sizes = dict(zip(axes, shape))
    cfg = get_smoke_config(ranks.HYBRID_ARCH)
    seq_axes = _seq_axes(sizes, batch)
    want_counts = _expected_counts(cfg, sizes, seq_axes)
    for out in results["ranks"]:
        rec = out[f"{label}/b{batch}/{start}"]
        assert rec["partitioned"]
        assert tuple(rec["seq_axes"]) == seq_axes
        lo, hi = rec["token_rows"]
        for got, ref in zip(rec["tokens"], want["tokens"]):
            np.testing.assert_array_equal(got, ref[lo:hi])
        _close(rec["logits"], want["logits"], rec["logit_slices"],
               "logits")
        assert sorted(rec["state"]) == sorted(want["state"])
        for k, got in rec["state"].items():
            assert got.size < want["state"][k].size, k
            _close(got, want["state"][k], rec["state_slices"][k], k)
        for counts in rec["counts"]:
            got_counts = {k: counts[k] for k in want_counts}
            assert got_counts == want_counts, (got_counts, want_counts)
            assert counts["block_copies"] == 0
        assert rec["watched"] and rec["allocated"] == []


def test_planted_identity_reduce_bcdt_fails_the_check(results):
    """With each rank's B, C and dt from its own channels alone, the
    (1, 4) seeded start's logits land far outside the tolerance."""
    label, start = PLANT
    case = next(c for c in CASES if c[0] == label)
    want = results["oracle"][case[3], start]["logits"]
    scale = float(np.abs(want).max())
    worst = 0.0
    for out in results["ranks"]:
        rec = out[f"{label}/b{case[3]}/{start}"]
        block = want[tuple(slice(a, b) for a, b in rec["logit_slices"])]
        worst = max(worst, float(np.abs(rec["planted_logits"]
                                        - block).max()))
    assert worst > 100 * TOL * scale, (worst, scale)

