"""The port's optimizers against the reference's ``repro.optim``.

Three updates of sgd, momentum (and Nesterov), adamw (with weight
decay) and adafactor, from the same numpy parameters and gradients:
a vector leaf, a matrix and a rank-3 leaf (Adafactor's unfactored and
factored branches), in f32 and bf16, at staleness 0 and 2, with the
1/(1+s) damping on and off, and ``lr_scale`` 0 (a warm-up step of the
ring: the moments still move) and 1.  The elementwise rules run in
blocks of 16 elements here, so the block walk is exercised too.

Tolerance: every parameter and state leaf within ``rtol=2e-6,
atol=1e-7`` in f32 (the scalars' ``pow`` and ``rsqrt`` may sit an ulp
from XLA's), and bf16 parameters within one bf16 ulp of their
magnitude; ``count`` equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import tree as tree_util
from repro_torch.optim import optimizers as topt

SHAPES = {"vec": (7,), "mat": (5, 6), "stack": (3, 4, 5)}

RULES = [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
         ("adamw", {"weight_decay": 0.1}), ("adafactor", {})]


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_tree(t, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in t.items()}


def _torch_tree(t, dtype):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in t.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("lr_scale", [0.0, 1.0])
@pytest.mark.parametrize("damping", [False, True])
@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule,kw", RULES,
                         ids=["sgd", "momentum", "nesterov", "adamw",
                              "adafactor"])
def test_three_updates_match_the_reference(rule, kw, dtype, staleness,
                                           damping, lr_scale, monkeypatch):
    monkeypatch.setattr(topt, "_BLOCK", 16)
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(3)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    lr = 3e-2

    jo = jopt.make_optimizer(rule, lr, staleness_damping=damping, **kw)
    to = topt.make_optimizer(rule, lr, staleness_damping=damping, **kw)
    jp, tp = _jax_tree(p0, jdt), _torch_tree(p0, tdt)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(_jax_tree(g, jdt), js, jp, staleness=staleness,
                           lr_scale=jnp.float32(lr_scale))
        tp, ts = to.update(_torch_tree(g, tdt), ts, tp, staleness=staleness,
                           lr_scale=torch.tensor(lr_scale))

    for k in SHAPES:
        want, got = _np(jp[k]), _np(tp[k])
        assert tp[k].dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7,
                                       err_msg=k)
        else:
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(got - want) <= ulp), k
        if lr_scale == 0.0:     # a warm-up step leaves the params alone
            np.testing.assert_array_equal(got, _np(_torch_tree(p0, tdt)[k]))

    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = tree_util.leaves(ts)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == tuple(np.shape(a))
        if np.asarray(a).dtype == np.int32:         # count
            assert b.dtype == torch.int32 and int(b) == int(a) == 3
        else:
            np.testing.assert_allclose(_np(b), _np(a), rtol=2e-6, atol=1e-7)


def test_state_field_names_are_the_reference_checkpoint_keys():
    assert topt.AdamState._fields == jopt.AdamState._fields
    assert topt.AdafactorState._fields == jopt.AdafactorState._fields
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lamb")
