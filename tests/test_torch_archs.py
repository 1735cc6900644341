"""repro_torch's model families against the reference's, on the CPU:
the dense qwen1.5-110b, qwen1.5-32b (QKV bias, head dim 12 in its smoke
config) and mistral-large-123b, the ``vlm`` chameleon-34b (q/k norms),
the MoE transformers qwen3-moe-235b-a22b (q/k norms) and
deepseek-moe-16b (shared experts), the recurrent xlstm-125m (``ssm``:
mLSTM and sLSTM) and the encoder-decoder whisper-tiny (``audio``:
layernorm, GELU, f32 frames).

Parameters come from the reference's ``registry.init_params(cfg,
PRNGKey(0))`` and cross through numpy; batches are the shared synthetic
stream.  The reference runs with ``kernels="xla"``.

Tolerance 1e-5 (absolute and relative) on the loss, the aux loss and
every gradient leaf of the f32 smoke configs: the same products in the
same order, but the matmuls' reductions round differently in the two
packages.  Counts and packed bytes are exact; the one-worker sessions'
losses agree within 1e-4 after four applied steps.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import arch_names as jax_arch_names
from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jax_batches
from repro.models import registry as jregistry
from repro.ps.sharded.plan import build_shard_plan as jax_plan
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.models import registry
from repro_torch.models.params import from_numpy_tree
from repro_torch.ps.sharded.plan import build_shard_plan

torch.set_num_threads(2)

TOL = 1e-5
ARCHS = ("qwen1.5-110b", "qwen1.5-32b", "mistral-large-123b",
         "chameleon-34b", "qwen3-moe-235b-a22b", "deepseek-moe-16b",
         "xlstm-125m", "whisper-tiny")
#: published widths cut in depth, as the card trains them: layers, and
#: the cut's parameter count (xlstm-125m and whisper-tiny uncut)
CHIP_CUTS = {"qwen1.5-110b": (1, 3_850_405_888),
             "qwen1.5-32b": (3, 3_134_013_440),
             "mistral-large-123b": (2, 3_573_608_448),
             "chameleon-34b": (3, 3_149_980_416),
             "qwen3-moe-235b-a22b": (1, 3_732_418_816),
             "deepseek-moe-16b": (5, 3_358_742_528),
             "xlstm-125m": (12, 81_178_448),
             "whisper-tiny": (4, 49_049_088)}


def _named_shapes(tree, prefix=""):
    """[(path, shape)] in flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_shapes(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _named_shapes(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape))]


def _torch_batch(batch):
    """A reference batch as the port's workers see it: integer arrays
    as ``torch.long``, float ones (Whisper's frames) in their dtype."""
    return {k: torch.from_numpy(np.asarray(v)) if np.asarray(v).dtype.kind
            == "f" else torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def test_the_port_runs_every_transformer_arch_and_refuses_the_rest():
    """The port refuses no architecture any more: every one of the
    reference's builds a CPU session of its smoke config, the model
    section's defaults (xlstm-125m) included."""
    assert sorted(arch_names()) == sorted(jax_arch_names())
    assert set(ARCHS) <= set(arch_names())
    assert api.ModelSpec().arch == "xlstm-125m"
    for arch in [None] + sorted(arch_names()):
        model = api.ModelSpec() if arch is None else api.ModelSpec(arch=arch)
        spec = _spec(api, model.arch).replace(model=model)
        with api.build_session(spec, device="cpu", timeout=300.0) as s:
            n = sum(int(np.prod(shape)) for shape in
                    s.server.plan.leaf_shapes)
        assert n == get_smoke_config(model.arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_full(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke(arch))


@pytest.mark.parametrize("which", ["full", "smoke", "chip-cut"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch, which):
    if which == "full":
        cfg, jcfg = get_config(arch), jax_full(arch)
    elif which == "smoke":
        cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    else:
        n = CHIP_CUTS[arch][0]
        cfg = dataclasses.replace(get_config(arch), n_layers=n)
        jcfg = dataclasses.replace(jax_full(arch), n_layers=n)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert registry.count_params(cfg, active_only=True) == \
        jregistry.count_params(jcfg, active_only=True)
    if cfg.moe is None:
        assert cfg.active_param_count() == cfg.param_count()
    else:
        assert cfg.active_param_count() < cfg.param_count()
    if which == "chip-cut":
        assert cfg.param_count() == CHIP_CUTS[arch][1]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_names_and_shapes_match_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    theirs = _named_shapes(jax.eval_shape(
        lambda: jregistry.init_params(jcfg, jax.random.PRNGKey(0))))
    assert _named_shapes(registry.abstract_params(cfg)) == theirs
    params = registry.init_params(cfg, seed=0, device="cpu")
    assert _named_shapes(params) == theirs
    assert ("moe" in params.get("layers", {})) == (cfg.moe is not None)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """(arch, JAX params, batch, loss, aux, grads) with kernels='xla'."""
    jcfg = dataclasses.replace(jax_smoke(request.param), kernels="xla")
    params = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    data = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                       global_batch=2, seed=5)
    batch = next(jax_batches(jcfg, data))
    (loss, aux), grads = jax.value_and_grad(
        jregistry.loss_fn(jcfg), has_aux=True)(params, batch)
    return request.param, params, batch, float(loss), aux, grads


@pytest.mark.parametrize("overrides", [
    dict(kernels="xla"),
    dict(kernels="pallas"),             # autograd.Function path (plain on CPU)
    dict(kernels="auto", remat="full"),  # per-layer recompute, aux included
])
def test_loss_aux_and_every_gradient_leaf_match_reference(reference,
                                                          overrides):
    arch, params, batch, jloss, jaux, jgrads = reference
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    leaves, treedef = tree_util.flatten(from_numpy_tree(params, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, aux = registry.loss_fn(cfg)(tree_util.unflatten(treedef, leaves),
                                      _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) <= TOL
    # the reference's parts: the nll and the aux loss where it has an
    # aux term (the transformers, Jamba), the zero aux loss otherwise
    assert sorted(aux) == sorted(jaux)
    for name in jaux:
        assert abs(float(aux[name].detach()) - float(jaux[name])) <= TOL
    if cfg.moe is not None:
        # the aux loss is in the loss: nll + weight * aux
        assert float(aux["aux_loss"].detach()) > 0.0
        assert abs(float(loss.detach()) - float(aux["loss"].detach())
                   - cfg.moe.aux_loss_weight
                   * float(aux["aux_loss"].detach())) <= TOL
    else:
        assert float(aux["aux_loss"].detach()) == 0.0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for t, j in zip(grads, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "chameleon-34b",
                                  "xlstm-125m", "whisper-tiny"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_pack_is_byte_identical_to_reference(arch, n_shards):
    params = jregistry.init_params(jax_smoke(arch), jax.random.PRNGKey(0))
    tparams = from_numpy_tree(params, "cpu")
    jplan, tplan = jax_plan(params, n_shards), build_shard_plan(tparams,
                                                                 n_shards)
    assert tplan.leaf_shapes == jplan.leaf_shapes
    jwire = np.asarray(jplan.pack(params))
    twire = tplan.pack(tparams)
    assert twire.shape == jwire.shape
    assert twire.contiguous().view(torch.uint8).numpy().tobytes() == \
        jwire.tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_worker_step_frees_its_trees_without_the_cycle_collector(arch):
    """One worker step (unpacked parameters in, gradients out, remat on)
    leaves no reference cycle holding a parameter or gradient tensor:
    with the cycle collector off, both trees die once the caller drops
    them.  At full width a retained step holds gigabytes on the card
    until the collector happens to run."""
    from repro_torch.api.session import _grads_fn
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full",
                              kernels="pallas")
    grads_of = _grads_fn(cfg)
    batch = _torch_batch(next(jax_batches(jax_smoke(arch), JDataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=1))))
    params = registry.init_params(cfg, seed=0, device="cpu")
    grads_of(params, batch)                  # first use: lazy imports
    gc.collect()
    gc.disable()
    try:
        leaves = [x.clone() for x in tree_util.leaves(params)]
        refs = [weakref.ref(x) for x in leaves]
        grads, _ = grads_of(tree_util.unflatten(
            tree_util.flatten(params)[1], leaves), batch)
        refs += [weakref.ref(x) for x in tree_util.leaves(grads)]
        del leaves, grads
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert alive == 0, f"{alive} of {len(refs)} tensors held by a cycle"


def _spec(mod, arch, workers=1):
    return mod.RunSpec(
        model=mod.ModelSpec(arch=arch, smoke=True),
        data=mod.DataSpec(seq_len=32, global_batch=2, seed=3),
        optimizer=mod.OptimizerSpec(lr=5e-2, momentum=0.9),
        sync=mod.SyncSpec(mode="bsp", s_lower=1, s_upper=4),
        ps=mod.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=1.0),
        wire=mod.WireSpec(format="packed", delta_pull=True))


def _losses(session):
    return [loss for _, _, loss in session.server.metrics.loss_trajectory]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_arch_trains_through_a_cpu_session(arch):
    """Each architecture's smoke config through ``build_session`` on the
    CPU: 2 DSSP workers, 2 steps, finite losses."""
    spec = _spec(api, arch, workers=2).replace(
        sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=4))
    with api.build_session(spec, device="cpu", timeout=300.0) as s:
        m = s.run(2)
        n = sum(int(np.prod(shape)) for shape in s.server.plan.leaf_shapes)
    assert n == get_smoke_config(arch).param_count()
    assert m["pushes"] == 2
    assert all(np.isfinite(m[k]) for k in ("first_loss", "final_loss"))


def test_one_worker_bsp_session_matches_reference_step_by_step():
    """deepseek-moe-16b (routed and shared experts, aux loss in the
    gradient): four BSP steps of one worker, loss for loss."""
    _bsp_session_parity("deepseek-moe-16b")


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
def test_one_worker_bsp_session_of_the_recurrent_and_audio_families(arch):
    """xlstm-125m (mLSTM, the sLSTM loop's autograd ``Function``) and
    whisper-tiny (the f32 frames through the worker's batches): four
    BSP steps of one worker, loss for loss."""
    _bsp_session_parity(arch)


def _bsp_session_parity(arch: str, steps: int = 4) -> None:
    with japi.build_session(_spec(japi, arch)) as s:
        s.run(steps)
        jlosses = _losses(s)
    params = jregistry.init_params(jax_smoke(arch), jax.random.PRNGKey(0))
    with api.build_session(_spec(api, arch), device="cpu", timeout=300.0,
                           params=from_numpy_tree(params, "cpu")) as s:
        m = s.run(steps)
        tlosses = _losses(s)
    assert len(tlosses) == len(jlosses) == steps
    # the weights moved: each step's batch is new, so the loss need not
    # fall in four steps, but it must not repeat
    assert len(set(jlosses)) == steps
    for a, b in zip(tlosses, jlosses):
        assert abs(a - b) <= 1e-4, (tlosses, jlosses)
    print(f"losses: port {tlosses}, reference {jlosses}")
    assert m["pushes"] == steps and m["applied_updates"] == 4 * steps
