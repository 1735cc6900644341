"""Partitioned compute on the mesh (``repro_torch.models.partition``, the
partitioned path of ``launch.steps.make_train_fn``) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.partition_ranks``) on (2, 2) and (1, 4) over
('data', 'model') and on (2, 1, 2) over ('pod', 'data', 'model') run
qwen1.5-32b's and chameleon-34b's f32 smoke configs under
sequence-parallel (``sp=True``) and tensor-parallel (``sp=False``)
rules: three DSSP steps of damped momentum with two microbatches and
``remat="full"``.  The MoE transformers (deepseek-moe-16b under SP and
TP, qwen3-moe under SP) run on (1, 4), where every rank holds every
batch row, and on (2, 2), where the aux loss's two means are averaged
over the batch's ranks (``launch.mesh.batch_means``) in the partitioned
and the gather-whole step alike.  The oracle is the reference's
``build_train_step`` on a one-device mesh (``tests/test_torch_mesh.py``'s):
under GSPMD a sharding never changes a value, so one device is the
answer for every mesh and both modes.  Losses and parameters are held within 1e-5, of the oracle
and (on (2, 2)) of the port's gather-whole step.  On (2, 2), where FSDP and
the 'model' split meet, each step's allocations are watched.  The mesh
counters of each step are held to the design exactly: each layer's FSDP gathers and, under
SP, its K, V and MLP-input gathers once per microbatch, again in the
recompute under remat, and one reduce-scatter for each in the backward.
No rank allocates a whole layer-stacked leaf that the mesh splits (the
gather-whole step does).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, registry
from repro_torch.models.sharding import (AxisRules, is_spec,
                                         multi_pod_rules, single_pod_rules)

LR = 1e-3
TOL = 1e-5
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
DEADLINE_S = 180.0


@pytest.fixture(scope="module")
def inits():
    archs = ranks.PARTITION_ARCHS + tuple(a for a, _, _ in
                                          ranks.PARTITION_MOE)
    return {arch: jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jax_smoke(arch),
                                          jax.random.PRNGKey(0)))
            for arch in archs}


def _oracle():
    """The reference's losses and parameters per arch: its
    ``build_train_step`` jitted on a one-device mesh, the same delays,
    damped momentum, from ``PRNGKey(0)``; one microbatch for the dense
    archs (two give the same mean within f32 rounding, and compile twice
    as long), the ranks' two and ``moe_chunk`` for the MoE archs."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    out = {}
    cfgs = [(arch, jax_smoke(arch)) for arch in ranks.PARTITION_ARCHS]
    # the MoE's chunks and microbatches decide its routing and aux loss
    cfgs += [(arch, jax_smoke(arch).scaled(grad_accum=2, moe_chunk=chunk))
             for arch, chunk, _ in ranks.PARTITION_MOE]
    for arch, cfg in cfgs:
        opt = jmake_optimizer("momentum", LR, staleness_damping=True)
        b = jsteps.build_train_step(
            cfg, jm, JShapeSpec("smoke", ranks.SEQ, ranks.BATCH, "train"),
            sync="dssp", s_upper=3, optimizer=opt)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
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
        out[arch] = {"losses": losses,
                     "params": [np.asarray(x, np.float32) for x in
                                jax.tree_util.tree_leaves(params)]}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory, inits):
    """One four-rank run over every mesh (each a ``DeviceMesh`` over the
    same ranks), shared by the cases, and the oracle, computed in this
    process while the ranks run."""
    meshes = [(label, shape, axes, label == "2x2", label in MOE_MESHES)
              for label, (shape, axes) in MESHES.items()]
    out = {}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.partition_ranks, 4,
                str(tmp_path_factory.mktemp("partition")),
                args=(meshes, inits, LR), timeout=DEADLINE_S)
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


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, atol=tol, rtol=0)


def _rules(sizes, sp):
    """``rules_for_mesh``'s rules for a mesh of ``sizes`` (the specs need
    only the axis sizes)."""
    make = multi_pod_rules if "pod" in sizes else single_pod_rules
    return make(dict(sizes), sp=sp, role="tp")


def _expected_counts(cfg, sizes, sp: bool, accum: int, remat: bool):
    """All-gathers and reduce-scatters of one step, by the design: per
    microbatch, each layer gathers its 'data'-split leaves (FSDP) and,
    under SP on a split 'model' axis, its K, V and MLP input; the
    recompute under remat gathers again (its closing reduce-scatter is
    not recomputed: nothing after it is saved); every gather of the
    forward is reduce-scattered in the backward and every forward
    reduce-scatter gathered; the embedding (SP) reduce-scatters to
    sequence blocks and the unembedding gathers the sequence back."""
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    specs = registry.param_specs(cfg, _rules(sizes, sp))
    layer = tree_util.leaves(specs["layers"], is_leaf=is_spec)
    fsdp_layer = sum("data" in s for s in layer) if d > 1 else 0
    tables = ["embed"] + ([] if cfg.tie_embeddings else ["unembed"])
    fsdp_top = sum("data" in specs[t] for t in tables) if d > 1 else 0
    act = 1 if (sp and m > 1) else 0
    n = cfg.n_layers
    passes = 2 if remat else 1
    gathers = n * (fsdp_layer + 3 * act)         # a layer's forward
    ag = gathers * passes + fsdp_top + act + (n + 1) * act
    rs = n * act + act + gathers + fsdp_top + act
    return {"all_gather": accum * ag, "reduce_scatter": accum * rs}


CASES = [(mesh, arch, mode) for mesh in MESHES
         for arch in ranks.PARTITION_ARCHS for mode in ("sp", "tp")]


@pytest.mark.parametrize("mesh,arch,mode", CASES)
def test_partitioned_step_matches_the_reference(mesh, arch, mode, results):
    outs = results["ranks"]
    shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    want = results["oracle"][arch]
    key = f"{mesh}/{arch}/{mode}"
    cfg = get_smoke_config(arch).scaled(sequence_parallel=mode == "sp")
    want_counts = _expected_counts(cfg, sizes, mode == "sp", 2, True)
    for out in outs:
        run = out[key]["run"]
        assert run["partitioned"]
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   atol=TOL, rtol=0)
        # no tensor a step allocates is a whole layer-stacked leaf that
        # the mesh splits (watched on (2, 2))
        assert run["allocated"] == []
        assert (run["watched"] is None) == (mesh != "2x2")
        for step in run["counts"]:
            got = {k: step[k] for k in want_counts}
            assert got == want_counts, (got, want_counts)
            assert step["all_reduce"] > 0 and step["block_copies"] == 0
    rec0 = outs[0][key]
    _close(rec0["run"]["params"], want["params"])
    if "whole" in rec0:
        # the gather-whole step (it allocates the whole stacked leaves
        # the partitioned step never does)
        whole = rec0["whole"]
        assert not whole["partitioned"] and whole["allocated"]
        np.testing.assert_allclose(rec0["run"]["losses"], whole["losses"],
                                   atol=TOL, rtol=0)
        _close(rec0["run"]["params"], whole["params"])


#: (1, 4): every rank holds every row; (2, 2): the aux loss's means are
#: averaged over 'data'; the gather-whole step runs on (2, 2) too
MOE_MESHES = ("1x4", "2x2")
MOE_CASES = [(arch, mode) for arch, _, modes in ranks.PARTITION_MOE
             for mode in modes]


@pytest.mark.parametrize("mesh,arch,mode", [("1x4",) + c for c in MOE_CASES])
def test_partitioned_moe_step_matches_the_reference(mesh, arch, mode,
                                                    results):
    """The MoE transformers' partitioned step (experts gathered whole
    per layer, no expert parallelism; under SP deepseek's chunks of 8
    routed on each rank's own block, qwen3-moe's 256 on the gathered
    sequence) on (1, 4) against the reference on one device."""
    want = results["oracle"][arch]
    for out in results["ranks"]:
        run = out[f"{mesh}/{arch}/{mode}"]["run"]
        assert run["partitioned"]
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   atol=TOL, rtol=0)
    _close(results["ranks"][0][f"{mesh}/{arch}/{mode}"]["run"]["params"],
           want["params"])


@pytest.mark.parametrize("mesh,arch,mode", [("2x2",) + c for c in MOE_CASES])
def test_partitioned_moe_step_matches_the_gather_whole_step(mesh, arch,
                                                           mode, results):
    """On (2, 2) each rank routes its own rows; the aux loss's two means
    of each chunk are averaged over 'data' before their product, so the
    term and its gradient are the reference's over the global batch:
    the partitioned and the gather-whole step both land within 1e-5 of
    the reference on one device."""
    want = results["oracle"][arch]
    for out in results["ranks"]:
        rec = out[f"{mesh}/{arch}/{mode}"]
        assert rec["run"]["partitioned"] and not rec["whole"]["partitioned"]
        for step in ("run", "whole"):
            np.testing.assert_allclose(rec[step]["losses"], want["losses"],
                                       atol=TOL, rtol=0)
    rec0 = results["ranks"][0][f"{mesh}/{arch}/{mode}"]
    _close(rec0["run"]["params"], want["params"])
    _close(rec0["whole"]["params"], want["params"])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_seq_block_mask_and_rotary_are_the_whole_sequences_rows(m, window):
    """A rank's block of the causal (and sliding-window) mask, its
    queries at the block's global offset against the gathered keys, and
    its rotary angles at the block's global positions, equal the whole
    sequence's rows."""
    l, hd = 32, 16
    lb = l // m
    whole = layers.causal_window_mask(l, l, window=window)
    cos, sin = layers.rotary_embedding(torch.arange(l), hd, 1e6)
    for r in range(m):
        rows = slice(r * lb, (r + 1) * lb)
        block = layers.causal_window_mask(lb, l, q_offset=r * lb,
                                          window=window)
        assert torch.equal(block, whole[rows])
        c, s = layers.rotary_embedding(torch.arange(r * lb, (r + 1) * lb),
                                       hd, 1e6)
        assert torch.equal(c, cos[rows]) and torch.equal(s, sin[rows])


def test_partition_covers_only_the_transformer_with_tp_role():
    """``partition_for`` splits the transformers' compute (dense, vlm,
    moe) and the hybrid's (Jamba) under role 'tp' and leaves every other
    config to the gather-whole step."""
    from repro_torch.models.partition import partition_for

    class Mesh:                      # the sizes and names are all it reads
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    sizes = {"data": 2, "model": 2}
    for arch, want in (("qwen1.5-32b", True), ("chameleon-34b", True),
                       ("deepseek-moe-16b", True),
                       ("qwen3-moe-235b-a22b", True),
                       ("h2o-danube-1.8b", False),     # role 'dp'
                       ("jamba-v0.1-52b", True), ("xlstm-125m", False),
                       ("whisper-tiny", False)):
        cfg = get_smoke_config(arch)
        rules = _rules(sizes, True) if cfg.model_axis_role == "tp" else \
            AxisRules(dict(_rules(sizes, True).rules, model=None), sizes)
        part = partition_for(cfg, Mesh(), rules,
                             registry.param_specs(cfg, rules), ("data",))
        assert (part is not None) == want, arch


def test_partition_refuses_a_tp_transformer_it_cannot_split():
    """A transformer under role 'tp' that ``partition_for`` cannot split
    (a GELU MLP; a batch that does not split over 'data') is refused,
    not silently gathered whole."""
    from repro_torch.models.partition import partition_for

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    sizes = {"data": 2, "model": 2}
    rules = _rules(sizes, True)
    cfg = get_smoke_config("qwen1.5-32b")
    specs = registry.param_specs(cfg, rules)
    with pytest.raises(ValueError, match="batch splits over"):
        partition_for(cfg, Mesh(), rules, specs, ())
    gelu = cfg.scaled(act="gelu")
    with pytest.raises(ValueError, match="act='gelu'"):
        partition_for(gelu, Mesh(), rules, registry.param_specs(gelu, rules),
                      ("data",))
