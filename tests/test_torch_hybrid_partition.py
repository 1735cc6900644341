"""The hybrid's (Jamba's) train step and prefill on blocks
(``repro_torch.models.partition`` through ``launch.steps``) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.hybrid_partition_ranks``; one spawn runs every case)
on (1, 4) and (2, 2) over ('data', 'model') and on (2, 1, 2) over
('pod', 'data', 'model') run Jamba's f32 smoke config (two period
groups of a Mamba, an attention and two more Mamba slots, MoE with 4
experts on every second slot, Mamba inner dim 128: 32 channels a rank
on (1, 4)) under sequence-parallel and tensor-parallel rules: three
DSSP steps of damped momentum with two microbatches and
``remat="full"``.  The oracle is the reference's ``build_train_step``
jitted on a one-device mesh with ``kernels="xla"`` (its Pallas scan does
not run on this jax): under GSPMD a sharding never changes a value.

* Losses and every parameter within 1e-5 of the oracle.
* The mesh counters of each step, exactly as the design gives them
  (``_expected_counts``): per slot and microbatch the FSDP gather of
  each 'data'-split leaf, the Mamba's ``w_in`` blocks moved over 'model'
  by an all-to-all, an MoE's leaves gathered over 'model', under SP the Mamba's, the
  MLP's and the MoE's input gathers and K and V; again in the recompute
  but for the closing reduce-scatter of an MLP slot; every
  gather-with-gradient reduce-scattered backward and every
  reduce-scatter gathered.
* No rank allocates a whole layer-stacked leaf that the mesh splits.
* On (1, 4) a step whose ``w_in`` ranges are swapped (``xin`` for
  ``z``: the storage layout's trap) lands far from the oracle.
* The prefill's loss on (2, 2), on blocks and gathered whole, equals
  the reference's within 1e-5: the MoE aux loss's two means run over
  the global batch in both.
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
from repro.core import dssp_spmd as jdssp
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jbatches
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import tree as tree_util
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.models.partition import _layer_specs, _spec_paths
from repro_torch.models.sharding import (is_spec, multi_pod_rules,
                                         single_pod_rules)

LR = 1e-3
TOL = 1e-5
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
PLANT = "1x4"
DEADLINE_S = 180.0
TOKENS = np.random.RandomState(3).randint(
    0, 256, (ranks.BATCH, ranks.SEQ)).astype(np.int32)


def _jax_cfg():
    return jax_smoke(ranks.HYBRID_ARCH).scaled(grad_accum=2, kernels="xla")


def _oracle():
    """The reference's losses and parameters over the ranks' delays
    (damped momentum, two microbatches, from ``PRNGKey(0)``), and its
    prefill's loss of ``TOKENS``."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    cfg = _jax_cfg()
    opt = jmake_optimizer("momentum", LR, staleness_damping=True)
    b = jsteps.build_train_step(
        cfg, jm, JShapeSpec("smoke", ranks.SEQ, ranks.BATCH, "train"),
        sync="dssp", s_upper=3, optimizer=opt)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    pre = jsteps.build_prefill_step(
        cfg, jm, JShapeSpec("p", ranks.SEQ, ranks.BATCH, "prefill"))
    toks = jnp.asarray(TOKENS)
    with jm:
        prefill = float(jax.jit(pre.fn)(params, {"tokens": toks,
                                                 "labels": toks}))
    state = opt.init(params)
    pipe = jdssp.init_pipeline(
        jax.tree_util.tree_map(jnp.zeros_like, params), 4)
    it = jbatches(cfg, JDataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=ranks.SEQ,
                                   global_batch=ranks.BATCH))
    losses = []
    with jm:
        for d in ranks.PARTITION_DELAYS:
            bt = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, state, pipe, m = fn(params, state, pipe, bt,
                                        jnp.int32(d))
            losses.append(float(m["loss"]))
    return {"losses": losses, "prefill": prefill,
            "params": [np.asarray(x, np.float32)
                       for x in jax.tree_util.tree_leaves(params)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One four-rank run of every case, and the oracle, computed in this
    process while the ranks run."""
    init = jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(_jax_cfg(), jax.random.PRNGKey(0)))
    meshes = [(label, shape, axes) for label, (shape, axes)
              in MESHES.items()]
    out = {}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.hybrid_partition_ranks, 4,
                str(tmp_path_factory.mktemp("hybrid")),
                args=(meshes, init, LR, TOKENS, PLANT), timeout=DEADLINE_S)
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


def _rules(sizes, sp):
    make = multi_pod_rules if "pod" in sizes else single_pod_rules
    return make(dict(sizes), sp=sp, role="tp")


def _expected_counts(cfg, sizes, sp: bool, accum: int):
    """All-gathers and reduce-scatters of one step under ``remat="full"``
    by the design (module docstring): per microbatch, each slot of each
    group gathers in its forward and again in its recompute, but for
    the closing reduce-scatter of an MLP slot under SP (nothing after
    it is saved, so the recompute stops before it); a gather with a
    gradient is reduce-scattered backward (an MoE leaf gathered over
    'model' under TP keeps its block instead), a reduce-scatter
    gathered; the embedding and unembedding add their FSDP gathers and,
    under SP, the embedding's reduce-scatter and the unembedding's
    sequence gather; each Mamba slot's ``w_in`` takes an all-to-all in
    its forward, its recompute and its backward."""
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    specs = registry.param_specs(cfg, _rules(sizes, sp))
    act = 1 if (sp and m > 1) else 0
    ag = rs = a2a = 0
    for slot in _layer_specs(specs):
        fwd_ag = grad_ag = fwd_rs = 0
        for path, spec in _spec_paths(slot):
            fsdp = d > 1 and "data" in spec
            fwd_ag += fsdp
            grad_ag += fsdp
            if path == ("mamba", "w_in") and m > 1:
                a2a += 3           # forward, recompute, backward
            if path[0] == "moe" and m > 1 and "model" in spec:
                fwd_ag += 1
                grad_ag += act
        if "attn" in slot:
            fwd_ag += 2 * act
            grad_ag += 2 * act
        if "mamba" in slot:
            fwd_ag, grad_ag, fwd_rs = fwd_ag + act, grad_ag + act, act
        fwd_ag, grad_ag = fwd_ag + act, grad_ag + act     # the FFN input
        if "mlp" in slot:
            fwd_rs += act
        tail = act if "mlp" in slot else 0
        ag += 2 * fwd_ag + fwd_rs
        rs += fwd_rs + (fwd_rs - tail) + grad_ag
    groups = cfg.n_layers // cfg.attn_period
    tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
    top = sum("data" in specs[t] for t in tables) if d > 1 else 0
    ag = groups * ag + top + 2 * act
    rs = groups * rs + top + 2 * act
    return {"all_gather": accum * ag, "reduce_scatter": accum * rs,
            "all_to_all": accum * groups * a2a}


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, atol=tol, rtol=0)


@pytest.mark.parametrize("mesh,mode", [(m, mode) for m in MESHES
                                       for mode in ("sp", "tp")])
def test_partitioned_hybrid_step_matches_the_reference(mesh, mode, results):
    want = results["oracle"]
    shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    cfg = ranks.hybrid_cfg(mode == "sp")
    want_counts = _expected_counts(cfg, sizes, mode == "sp", 2)
    for out in results["ranks"]:
        run = out[f"{mesh}/{mode}"]["run"]
        assert run["partitioned"]
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   atol=TOL, rtol=0)
        assert run["allocated"] == []
        assert (run["watched"] is None) == (mesh != "2x2")
        if run["watched"] is not None:
            assert run["watched"]
        for step in run["counts"]:
            got = {k: step[k] for k in want_counts}
            assert got == want_counts, (got, want_counts)
            assert step["all_reduce"] > 0 and step["block_copies"] == 0
    _close(results["ranks"][0][f"{mesh}/{mode}"]["run"]["params"],
           want["params"])


def test_planted_w_in_swap_fails_the_check(results):
    """The check above catches the trap of ``w_in``'s layout: with each
    rank's ``xin`` and ``z`` column ranges swapped the (1, 4) step's
    parameters land far outside the tolerance."""
    planted = results["ranks"][0][f"{PLANT}/sp"]["planted"]
    want = results["oracle"]["params"]
    worst = max(float(np.abs(x - y).max())
                for x, y in zip(planted["params"], want))
    assert worst > 100 * TOL, worst


@pytest.mark.parametrize("partition", [True, False])
def test_hybrid_prefill_loss_is_the_references_over_the_global_batch(
        partition, results):
    """The prefill's loss on (2, 2): on blocks (``Partition.loss``) and
    gathered whole (``partition=False``), the MoE aux loss's means over
    the global batch in both, the reference's value."""
    want = results["oracle"]["prefill"]
    for out in results["ranks"]:
        rec = out[f"prefill/{partition}"]
        assert rec["partitioned"] == partition
        assert abs(rec["loss"] - want) <= TOL, (rec["loss"], want)


def test_partition_for_splits_jamba_and_refuses_an_unsplit_mamba():
    """``partition_for`` splits the hybrid under role 'tp'; a Mamba inner
    dim that 'model' does not divide is refused, not gathered whole."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.partition import partition_for

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 4)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    sizes = {"data": 1, "model": 4}
    cfg = get_smoke_config(ranks.HYBRID_ARCH)
    rules = _rules(sizes, True)
    part = partition_for(cfg, Mesh(), rules, registry.param_specs(cfg, rules),
                         ("data",))
    assert part is not None and len(part.slot_specs) == cfg.attn_period
    bad = cfg.scaled(d_model=65)         # di 130 does not split over 4
    specs = registry.param_specs(bad, rules)
    assert not any("model" in s for s in tree_util.leaves(
        specs["slots"][0]["mamba"]["conv_b"], is_leaf=is_spec))
    with pytest.raises(ValueError, match="Mamba inner dim"):
        partition_for(bad, Mesh(), rules, specs, ("data",))
