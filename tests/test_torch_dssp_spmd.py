"""The port's delayed-gradient ring and schedule controller against the
reference's ``repro.core.dssp_spmd``.

``push_pop`` is held bit for bit (each step's delayed gradient, its
``valid`` scale and the whole ring) over a random delay sequence that
includes delays above ``depth - 1`` (clipped) and the warm-up steps;
``DsspScheduleController.delay()`` and ``period()`` are held exactly
equal on the same observation streams, for each interval estimator.
The reference's own semantics tests follow, ported.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dssp_spmd as jd
from repro_torch import tree as tree_util
from repro_torch.core import dssp_spmd as td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_push_pop_is_bitwise_the_reference_over_random_delays(dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (5,), "b": {"c": (2, 3)}}
    depth = 4
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def draw():
        return {"a": rng.standard_normal(5).astype(np.float32),
                "b": {"c": rng.standard_normal((2, 3)).astype(np.float32)}}

    like = draw()
    jst = jd.init_pipeline(jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, jdt), like), depth)
    tst = td.init_pipeline(tree_util.tree_map(
        lambda x: torch.zeros(x.shape, dtype=tdt), like), depth)
    delays = [0, 2, 1, 5, 3, 0, 7, 2, 2, 1, 3, 6, 0, 1]   # 5, 7, 6 clip to 3
    for delay in delays:
        g = draw()        # f32 in; the ring stores its own dtype
        jout, jvalid, jst = jd.push_pop(
            jst, jax.tree_util.tree_map(jnp.asarray, g), jnp.int32(delay))
        tout, tvalid, tst = td.push_pop(
            tst, tree_util.tree_map(torch.from_numpy, g), delay)
        assert float(tvalid) == float(jvalid)
        assert tvalid.dtype == torch.float32
        for a, b in zip(jax.tree_util.tree_leaves(jout),
                        tree_util.leaves(tout)):
            assert b.dtype == tdt
            np.testing.assert_array_equal(
                b.float().numpy(), np.asarray(a.astype(jnp.float32)))
    assert int(tst.step) == int(jst.step) == len(delays)
    assert tst.step.dtype == torch.int32
    for a, b in zip(jax.tree_util.tree_leaves(jst.buffer),
                    tree_util.leaves(tst.buffer)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("estimator", ["last", "ema", "median"])
def test_controller_delay_and_period_equal_the_reference(estimator):
    rng = np.random.default_rng(11)
    for s_lower, s_upper in ((0, 3), (1, 4), (2, 8)):
        jc = jd.DsspScheduleController(s_lower, s_upper, estimator)
        tc = td.DsspScheduleController(s_lower, s_upper, estimator)
        assert tc.delay() == jc.delay() == s_lower   # nothing observed
        for _ in range(40):
            step = float(rng.uniform(0.01, 0.2))
            coll = float(rng.choice([0.0, rng.uniform(0.0, 1.0)]))
            jc.observe(step, coll)
            tc.observe(step, coll)
            assert tc.delay() == jc.delay()
            pods = list(rng.uniform(0.5, 4.0, size=int(rng.integers(2, 5))))
            assert tc.period(pods) == jc.period(pods)
        assert tc.history == jc.history


# ---------------------------------------------- the reference's own tests
def test_push_pop_ring_semantics():
    g1 = {"w": torch.ones(3)}
    st = td.init_pipeline(g1, depth=3)
    # delay 2: first two steps invalid, then grads from t-2 emerge
    outs = []
    for t in range(4):
        g = {"w": torch.full((3,), float(t + 1))}
        out, valid, st = td.push_pop(st, g, 2)
        outs.append((float(out["w"][0]), float(valid)))
    assert outs[0][1] == 0.0 and outs[1][1] == 0.0
    assert outs[2] == (1.0, 1.0)      # step 2 applies grad from step 0
    assert outs[3] == (2.0, 1.0)


def test_controller_delay_tracks_collective_time():
    c = td.DsspScheduleController(1, 8)
    for _ in range(3):
        c.observe(step_time=0.1, collective_time=0.25)
    assert c.delay() == 3                  # ceil(0.25 / 0.1)
    for _ in range(8):
        c.observe(step_time=0.1, collective_time=1.5)
    assert c.delay() == 8                  # clamped at s_upper
    for _ in range(8):
        c.observe(step_time=0.1, collective_time=0.0)
    assert c.delay() == 1                  # never below s_lower


def test_controller_period_from_pod_skew():
    c = td.DsspScheduleController(2, 10)
    # homogeneous pods: Alg-2 alignment = one extra local step (the next
    # push of the slowest pod lands exactly one interval later)
    homog = c.period([1.0, 1.0])
    assert homog == 3                       # s_lower + 1
    # a 3x slower pod: the fast pod runs more extra local steps
    skewed = c.period([1.0, 3.0])
    assert skewed > homog
    assert skewed <= 10                     # bounded by s_upper


def test_init_pipeline_refuses_an_empty_ring():
    with pytest.raises(ValueError, match="depth"):
        td.init_pipeline({"w": torch.ones(2)}, 0)
