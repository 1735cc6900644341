"""repro_torch's Jamba hybrid (Mamba, attention, MoE) against the
reference's, on the CPU.

Parameters come from the reference's ``registry.init_params(cfg,
PRNGKey(0))`` and cross through numpy; batches are the shared synthetic
stream.  The f32 smoke config (8 layers in two period groups of 4, slot
1 attention, MoE with 4 experts on every second slot) is run with its
MoE and with ``moe=None``, which is how the chip runs the full-width
config.

Tolerance 2e-5 (absolute and relative) on the loss and on every gradient
leaf: f32 throughout, the same order of products, but the scan's ``exp``
and ``C . h`` sums, the matmuls' reductions and the associative scan's
combine tree round differently in the two packages; measured errors
are below 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jax_batches
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.ps.sharded.plan import build_shard_plan as jax_plan
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe
from repro_torch.models import registry
from repro_torch.models.params import from_numpy_tree
from repro_torch.ps.sharded.plan import build_shard_plan

torch.set_num_threads(2)

TOL = 2e-5
ARCH = "jamba-v0.1-52b"
#: the chip's cut: one period group at full width, no experts
CHIP_CUT = dict(n_layers=8, moe=None)


def _cfgs(moe_on: bool):
    over = {} if moe_on else {"moe": None}
    return (dataclasses.replace(jax_smoke(ARCH), kernels="xla", **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


@pytest.fixture(scope="module", params=[True, False], ids=["moe", "no-moe"])
def reference(request):
    """(moe_on, JAX params, batch, loss, aux, grads)."""
    jcfg, _ = _cfgs(request.param)
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    data = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                       global_batch=2, seed=5)
    batch = next(jax_batches(jcfg, data))
    (loss, aux), grads = jax.value_and_grad(
        jregistry.loss_fn(jcfg), has_aux=True)(params, batch)
    return request.param, params, batch, float(loss), aux, grads


@pytest.mark.parametrize("overrides", [
    dict(kernels="xla"),                    # sequential scan
    dict(kernels="auto"),                   # associative scan on the CPU
    dict(kernels="pallas", remat="full"),   # autograd.Functions + remat
])
def test_loss_and_every_gradient_leaf_match_reference(reference, overrides):
    moe_on, params, batch, jloss, jaux, jgrads = reference
    cfg = dataclasses.replace(_cfgs(moe_on)[1], **overrides)
    leaves, treedef = tree_util.flatten(from_numpy_tree(params, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    loss, aux = registry.loss_fn(cfg)(tree_util.unflatten(treedef, leaves),
                                      tbatch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) <= TOL
    assert abs(float(aux["loss"].detach()) - float(jaux["loss"])) <= TOL
    assert abs(float(aux["aux_loss"].detach()) - float(jaux["aux_loss"])) \
        <= TOL
    if moe_on:
        assert float(aux["aux_loss"].detach()) > 0.0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for t, j in zip(grads, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("which", ["full", "smoke", "chip-cut"])
def test_count_params_matches_reference(which):
    if which == "full":
        cfg, jcfg = get_config(ARCH), jax_full(ARCH)
    elif which == "smoke":
        cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    else:
        cfg = dataclasses.replace(get_config(ARCH), **CHIP_CUT)
        jcfg = dataclasses.replace(jax_full(ARCH), **CHIP_CUT)
    assert registry.count_params(cfg) == jregistry.count_params(jcfg)
    if which == "chip-cut":
        assert registry.count_params(cfg) == 2_725_326_848


def test_full_config_is_the_reference_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_full(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))


@pytest.mark.parametrize("n_shards", [1, 4])
def test_pack_is_byte_identical_to_reference(n_shards):
    params = jregistry.init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))
    tparams = from_numpy_tree(params, "cpu")
    jplan, tplan = jax_plan(params, n_shards), build_shard_plan(tparams,
                                                                 n_shards)
    assert tplan.leaf_shapes == jplan.leaf_shapes
    jwire = np.asarray(jplan.pack(params))
    twire = tplan.pack(tparams)
    assert twire.shape == jwire.shape
    assert twire.contiguous().view(torch.uint8).numpy().tobytes() == \
        jwire.tobytes()


@pytest.mark.parametrize("moe_chunk", [0, 8, 256])   # 8: four chunks
def test_moe_block_matches_reference(moe_chunk):
    jcfg = dataclasses.replace(jax_smoke(ARCH), moe_chunk=moe_chunk)
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(1))
    jw = jax.tree_util.tree_map(lambda x: x[0], params["slots"][1]["moe"])
    x = np.random.RandomState(6).randn(2, 32, jcfg.d_model) \
        .astype(np.float32)
    jy, jaux = jmoe.moe_block(jcfg, jnp.asarray(x), jw)
    cfg = dataclasses.replace(get_smoke_config(ARCH), moe_chunk=moe_chunk)
    ty, taux = moe.moe_block(cfg, torch.from_numpy(x),
                             from_numpy_tree(jw, "cpu"))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-5


def test_route_breaks_ties_toward_the_lower_expert_as_top_k_does():
    """A zero router gives every expert the same probability: top-k must
    pick experts 0 and 1, and the capacity cut keeps the first tokens,
    exactly as ``lax.top_k`` does in the reference."""
    jcfg = jax_smoke(ARCH)
    x = np.random.RandomState(7).randn(2, 16, jcfg.d_model) \
        .astype(np.float32)
    router = np.zeros((jcfg.d_model, jcfg.moe.n_experts), np.float32)
    jc, jd, jaux = jmoe._route(jcfg, jnp.asarray(x), jnp.asarray(router))
    tc, td, taux = moe._route(get_smoke_config(ARCH), torch.from_numpy(x),
                              torch.from_numpy(router))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=0)
    assert float(taux) == float(jaux)
    assert td[..., 2:, :].sum() == 0      # experts 2, 3 never chosen


def _spec(mod):
    return mod.RunSpec(
        model=mod.ModelSpec(arch=ARCH, smoke=True),
        data=mod.DataSpec(seq_len=32, global_batch=2, seed=3),
        optimizer=mod.OptimizerSpec(lr=5e-2, momentum=0.9),
        sync=mod.SyncSpec(mode="bsp", s_lower=1, s_upper=4),
        ps=mod.ServerSpec(kind="sharded", shards=4, workers=1,
                          apply="fused", straggler=1.0),
        wire=mod.WireSpec(format="packed", delta_pull=True))


def _losses(session):
    return [loss for _, _, loss in session.server.metrics.loss_trajectory]


def test_one_worker_bsp_session_matches_reference_step_by_step():
    steps = 4
    with japi.build_session(_spec(japi)) as s:
        s.run(steps)
        jlosses = _losses(s)
    params = jregistry.init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))
    with api.build_session(_spec(api), device="cpu", timeout=300.0,
                           params=from_numpy_tree(params, "cpu")) as s:
        m = s.run(steps)
        tlosses = _losses(s)
    assert len(tlosses) == len(jlosses) == steps
    assert jlosses[-1] < jlosses[0]          # the steps really moved
    for a, b in zip(tlosses, jlosses):
        assert abs(a - b) <= 1e-4, (tlosses, jlosses)
    assert m["pushes"] == steps and m["applied_updates"] == 4 * steps


def test_model_config_override_runs_the_given_config():
    """``model_config=`` replaces the spec's registry config in the
    server's parameters, the worker step and the data, as in the
    reference's SPMD engine: here the smoke config without experts."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), moe=None)
    with api.build_session(_spec(api), device="cpu", timeout=300.0,
                           model_config=cfg) as s:
        m = s.run(2)
        n = sum(int(np.prod(shape)) for shape in s.server.plan.leaf_shapes)
    assert n == registry.count_params(cfg) < registry.count_params(
        get_smoke_config(ARCH))
    assert m["pushes"] == 2 and all(np.isfinite(m[k]) for k in
                                    ("first_loss", "final_loss"))
