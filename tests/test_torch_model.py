"""repro_torch's dense transformer against the reference's: the f32
h2o-danube smoke config on JAX-initialised parameters, one batch of the
shared synthetic stream — the loss and EVERY gradient leaf agree within
1e-5."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jax_batches
from repro.models import registry as jregistry
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import DataConfig, batches
from repro_torch.models import layers
from repro_torch.models import registry
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """(JAX params, batch, loss, grads) with kernels='xla'."""
    cfg = dataclasses.replace(jax_smoke("h2o-danube-1.8b"), kernels="xla")
    params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    data = JDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                       global_batch=2, seed=5)
    batch = next(jax_batches(cfg, data))
    (loss, _), grads = jax.value_and_grad(
        jregistry.loss_fn(cfg), has_aux=True)(params, batch)
    return params, batch, float(loss), grads


def _port_loss_and_grads(params_np, batch, **cfg_overrides):
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-1.8b"),
                              **cfg_overrides)
    params = from_numpy_tree(params_np, "cpu")
    leaves, treedef = tree_util.flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    loss, aux = registry.loss_fn(cfg)(tree_util.unflatten(treedef, leaves),
                                      tbatch)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), tree_util.unflatten(treedef, list(grads)),
            aux)


def test_data_stream_is_the_reference_stream():
    cfg = get_smoke_config("h2o-danube-1.8b")
    jcfg = jax_smoke("h2o-danube-1.8b")
    for seed in (0, 7):
        ours = batches(cfg, DataConfig(cfg.vocab_size, 16, 3, seed=seed))
        theirs = jax_batches(jcfg, JDataConfig(jcfg.vocab_size, 16, 3,
                                               seed=seed))
        for _ in range(2):
            a, b = next(ours), next(theirs)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("overrides", [
    dict(kernels="xla"),
    dict(kernels="pallas"),             # autograd.Function path (plain on CPU)
    dict(kernels="auto", remat="full"),  # per-layer recompute
])
def test_loss_and_every_gradient_leaf_match_reference(reference, overrides):
    params, batch, jloss, jgrads = reference
    loss, grads, aux = _port_loss_and_grads(params, batch, **overrides)
    assert abs(loss - jloss) <= TOL
    assert float(aux["loss"].detach()) == loss
    jleaves, _ = jax.tree_util.tree_flatten(jgrads)
    tleaves = tree_util.leaves(grads)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def test_param_defs_and_names_match_reference():
    cfg = get_smoke_config("h2o-danube-1.8b")
    jcfg = jax_smoke("h2o-danube-1.8b")
    ours = tree_util.leaves(registry.param_defs(cfg))
    theirs = jax.tree_util.tree_leaves(
        jregistry.param_defs(jcfg),
        is_leaf=lambda x: hasattr(x, "fan_in_dims"))
    assert [(d.shape, d.init, d.fan_in_dims) for d in ours] == \
        [(d.shape, d.init, d.fan_in_dims) for d in theirs]
    assert registry.count_params(cfg) == jregistry.count_params(jcfg)
    params = registry.init_params(cfg, seed=0, device="cpu")
    assert [tuple(x.shape) for x in tree_util.leaves(params)] == \
        [d.shape for d in ours]
    again = registry.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_util.leaves(params), tree_util.leaves(again)))


def test_init_params_defaults_to_the_card_and_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: init would run")
    cfg = get_smoke_config("h2o-danube-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.init_params(cfg, seed=0)


def test_full_config_is_the_reference_config():
    from repro.configs import get_config as jax_full
    from repro_torch.configs import get_config
    assert dataclasses.asdict(get_config("h2o-danube-1.8b")) == \
        dataclasses.asdict(jax_full("h2o-danube-1.8b"))
    assert get_config("h2o-danube-1.8b").param_count() == \
        jax_full("h2o-danube-1.8b").param_count()


def test_causal_window_mask_is_what_the_kernels_compute():
    from repro.models import layers as jlayers
    for lq, lk, win in ((8, 8, None), (8, 8, 3), (4, 9, 5)):
        ours = layers.causal_window_mask(lq, lk, q_offset=lk - lq,
                                         window=win)
        theirs = jlayers.causal_window_mask(lq, lk, q_offset=lk - lq,
                                            window=win)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
