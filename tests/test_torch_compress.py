"""repro_torch's wire compression against the reference's, on the CPU.

The same numpy inputs go through both packages:

* the plain versions of the fused int8 and top-k kernels
  (``repro_torch.kernels.ref``) equal the reference's oracles
  (``repro.kernels.ref``) bit for bit, and its Pallas kernels run in
  interpret mode within the reference's own atol of 1e-6;
* the top-k kernel keeps about ``fraction`` of each tile and both obey
  the error-feedback identity ``decoded + residual == g + carried``;
* the per-tensor tree compressors equal the reference's, top-k's
  threshold (an exact radix select, ``kth_largest``) on ties too;
* a sharded server with fused int8 or top-k wire compression agrees
  with the reference server fed the same pushes, within 1e-5: the
  decoded gradients match, and the servers' applies differ by the
  reference kernel's FMA contraction (1 ulp per apply, ROADMAP queue 3).

On the card the wrappers launch the Hopper kernels instead (tests marked
``cuda`` in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_compress import fused_int8_ef as jax_int8
from repro.kernels.fused_compress import fused_topk_ef as jax_topk
from repro.optim import compression as jcomp
from repro_torch.core.policies import make_policy_factory
from repro_torch.kernels import fused_compress as fc
from repro_torch.kernels import ref as tref
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import compression as tcomp
from repro_torch.perfcount import LAUNCHES
from repro_torch.ps.server import ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows: int, dtype: str, seed: int, err_scale: float = 0.01):
    """g in the wire dtype, a non-zero f32 error state, both packages."""
    rng = np.random.RandomState(seed)
    g = rng.randn(rows, 512).astype(np.float32)
    e = (rng.randn(rows, 512) * err_scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(g, jdt), jnp.asarray(e),
            torch.from_numpy(g).to(tdt), torch.from_numpy(e))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bitwise(a, b) -> None:
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 24, 64])
def test_int8_plain_is_the_oracle_bitwise_and_the_interpret_kernel(
        dtype, rows):
    jg, je, tg, te = _inputs(rows, dtype, seed=rows)
    dq, er = fc.fused_int8_ef(tg, te)
    assert dq.dtype == tg.dtype and er.dtype == torch.float32
    jdq, jer = jref.fused_int8_ef_ref(jg, je)
    _bitwise(dq, jdq)
    _bitwise(er, jer)
    kdq, ker = jax_int8(jg, je, interpret=True)
    np.testing.assert_allclose(_np(dq), _np(kdq), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(er), _np(ker), atol=1e-6, rtol=1e-6)
    # error feedback: decoded + residual == input + carried error (the
    # residual is taken before the decoded value is stored in bf16, so
    # in bf16 the identity holds to that one rounding)
    gap = np.abs(_np(dq) + _np(er) - (_np(tg) + _np(te)))
    if dtype == "float32":
        assert gap.max() <= 1e-5
    else:   # half a bf16 ulp of the decoded value, plus f32 rounding
        assert np.all(gap <= np.spacing(np.abs(_np(dq))) * 2.0 ** 15 + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [0.01, 0.02, 0.05, 0.25])
def test_topk_plain_is_the_oracle_bitwise_and_the_interpret_kernel(
        dtype, fraction):
    jg, je, tg, te = _inputs(32, dtype, seed=7)
    dq, er = fc.fused_topk_ef(tg, te, fraction=fraction)
    jdq, jer = jref.fused_topk_ef_ref(jg, je, fraction=fraction)
    _bitwise(dq, jdq)
    _bitwise(er, jer)
    kdq, ker = jax_topk(jg, je, fraction=fraction, interpret=True)
    np.testing.assert_allclose(_np(dq), _np(kdq), atol=1e-6)
    np.testing.assert_allclose(_np(er), _np(ker), atol=1e-6)


@pytest.mark.parametrize("fraction", [0.02, 0.05, 0.25])
def test_topk_keeps_its_fraction_and_feeds_back_the_rest(fraction):
    rng = np.random.RandomState(7)
    g = torch.from_numpy(rng.randn(32, 512).astype(np.float32))
    e = torch.zeros((32, 512))
    dq, er = fc.fused_topk_ef(g, e, fraction=fraction)
    kept = float((dq != 0).float().mean())
    assert fraction * 0.8 <= kept <= fraction * 1.5, kept
    # every tile keeps at least its target
    per_tile = (dq != 0).reshape(4, -1).sum(dim=1)
    assert int(per_tile.min()) >= fc.topk_target(fraction)
    np.testing.assert_allclose((dq + er).numpy(), g.numpy(), atol=1e-5)
    # what is kept is kept whole: the largest magnitudes of each tile
    tiles = g.abs().reshape(4, -1)
    kept_mask = (dq != 0).reshape(4, -1)
    for t in range(4):
        assert tiles[t][kept_mask[t]].min() >= tiles[t][~kept_mask[t]].max()


def test_empty_region_passes_through_and_bad_shapes_raise():
    z = torch.zeros((0, 512))
    for fn in (fc.fused_int8_ef, fc.fused_topk_ef):
        out, err = fn(z, z)
        assert out is z and err is z
    with pytest.raises(ValueError, match="8-row-aligned"):
        fc.fused_int8_ef(torch.zeros(7, 512), torch.zeros(7, 512))
    with pytest.raises(ValueError, match="8-row-aligned"):
        fc.fused_int8_ef(torch.zeros(8, 256), torch.zeros(8, 256))
    with pytest.raises(ValueError, match="error state"):
        fc.fused_topk_ef(torch.zeros(8, 512), torch.zeros(16, 512))
    with pytest.raises(ValueError, match="fraction"):
        fc.fused_topk_ef(torch.zeros(8, 512), torch.zeros(8, 512),
                         fraction=0.0)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    assert fc.fused_int8_ef_plain is tref.fused_int8_ef_ref
    assert fc.fused_topk_ef_plain is tref.fused_topk_ef_ref
    before = LAUNCHES.snapshot()
    g = torch.randn(8, 512)
    fc.fused_int8_ef(g, torch.zeros_like(g))
    fc.fused_topk_ef(g, torch.zeros_like(g))
    assert LAUNCHES.snapshot() == before


def test_topk_target_is_rounded_like_the_reference():
    for fraction in (0.01, 0.05, 1.0 / 3.0, 0.25):
        assert fc.topk_target(fraction) == float(np.float32(fraction * 4096))


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_tree_compressors_equal_the_reference(name):
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(16, 40).astype(np.float32),
            "b": {"c": rng.randn(300).astype(np.float32)}}
    ours = tcomp.make_compressor(name)
    theirs = jcomp.make_compressor(name)
    tg = from_numpy_tree(tree, "cpu")
    jg = jax.tree_util.tree_map(jnp.asarray, tree)
    terr, jerr = ours.init_error(tg), theirs.init_error(jg)
    for _ in range(3):
        tout, terr = ours.apply(tg, terr)
        jout, jerr = theirs.apply(jg, jerr)
        for a, b in zip(jax.tree_util.tree_leaves(tout),
                        jax.tree_util.tree_leaves(jout)):
            _bitwise(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(terr),
                        jax.tree_util.tree_leaves(jerr)):
            _bitwise(a, b)
    assert ours.name == theirs.name
    assert ours.wire_bytes_per_value == theirs.wire_bytes_per_value
    ident = tcomp.make_compressor("none")
    out, err = ident.apply(tg, ident.init_error(tg))
    assert out is tg and err["a"].dtype == torch.float32


def _magnitudes(kind: str, n: int, rng) -> np.ndarray:
    if kind == "ties":
        a = rng.randint(-3, 4, n).astype(np.float32) / 8
    elif kind == "subnormal":
        a = (rng.randn(n) * 1e-40).astype(np.float32)
    else:
        a = rng.randn(n).astype(np.float32)
    if kind == "inf_nan":
        a[rng.randint(0, n, 3)] = np.inf
        a[rng.randint(0, n, 2)] = np.nan
    return np.abs(a)


@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal", "inf_nan"])
def test_kth_largest_is_the_kth_of_torch_topk(kind):
    """The radix select's k-th largest (repeats counted) is
    ``torch.topk``'s last value, for every k of small leaves."""
    rng = np.random.RandomState(11)
    for n in (1, 5, 257, 1000):
        a = torch.from_numpy(_magnitudes(kind, n, rng))
        for k in sorted({1, min(2, n), n // 3 + 1, n // 2 + 1, n}):
            want = torch.topk(a, k).values[-1]
            got = tcomp.kth_largest(a, k)
            assert got.shape == () and got.dtype == torch.float32
            assert torch.equal(got, want) or (got.isnan() and want.isnan())


def test_tree_topk_equals_the_reference_on_ties():
    """Leaves full of ties at the threshold: the kept set is the
    reference's (ties kept), bit for bit."""
    rng = np.random.RandomState(5)
    tree = {"a": rng.randint(-4, 5, (16, 40)).astype(np.float32) / 8,
            "b": rng.randint(-2, 3, 300).astype(np.float32) / 4}
    ours = tcomp.make_compressor("topk", fraction=0.1)
    theirs = jcomp.make_compressor("topk", fraction=0.1)
    tg = from_numpy_tree(tree, "cpu")
    jg = jax.tree_util.tree_map(jnp.asarray, tree)
    terr, jerr = ours.init_error(tg), theirs.init_error(jg)
    for _ in range(3):
        tout, terr = ours.apply(tg, terr)
        jout, jerr = theirs.apply(jg, jerr)
        for a, b in zip(jax.tree_util.tree_leaves((tout, terr)),
                        jax.tree_util.tree_leaves((jout, jerr))):
            _bitwise(a, b)


def test_packed_compressor_factory():
    assert tcomp.make_packed_compressor("none") is None
    assert tcomp.make_packed_compressor("int8").name == "int8"
    topk = tcomp.make_packed_compressor("topk", fraction=0.1)
    assert topk.name == "topk(0.1)"
    assert topk.wire_bytes_per_value == pytest.approx(0.6)
    with pytest.raises(ValueError, match="fraction"):
        tcomp.make_packed_compressor("topk", fraction=1.5)
    with pytest.raises(ValueError, match="unknown"):
        tcomp.make_packed_compressor("fp4")


def _params():
    rng = np.random.RandomState(0)
    return {"w0": rng.randn(24, 512).astype(np.float32),
            "w1": rng.randn(16, 128).astype(np.float32),
            "b": rng.randn(300).astype(np.float32)}


def _grads(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in _params().items()}


@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_compressed_server_agrees_with_the_reference_server(compression):
    from repro.core.policies import make_policy_factory as jfactory
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    params = _params()
    port = ShardedParameterServer(
        from_numpy_tree(params, "cpu"), make_policy_factory("asp"),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9), 2, 3,
        apply_mode="fused", wire_compression=compression,
        topk_fraction=0.1)
    ref = JServer(jax.tree_util.tree_map(jnp.asarray, params),
                  jfactory("asp"), lambda: JOpt(lr=0.05, momentum=0.9),
                  2, 3, apply_mode="fused", wire_compression=compression,
                  topk_fraction=0.1)
    for k in range(4):
        g = _grads(10 + k)
        port.push_packed(k % 2, port.plan.pack(from_numpy_tree(g, "cpu")))
        ref.push_packed(k % 2, ref.plan.pack(
            jax.tree_util.tree_map(jnp.asarray, g)))
    # the carried per-(worker, shard) error feedback agrees
    for w in (0, 1):
        for j in range(3):
            np.testing.assert_allclose(
                port._wire_err[w][j].numpy(),
                np.asarray(ref._wire_err[w][j]), atol=1e-6)
    np.testing.assert_allclose(port.pull_packed().numpy(),
                               np.asarray(ref.pull_packed()), atol=1e-5,
                               rtol=0)
    # compression really moved the result away from the raw gradients
    raw = ShardedParameterServer(
        from_numpy_tree(params, "cpu"), make_policy_factory("asp"),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9), 2, 3,
        apply_mode="fused")
    for k in range(4):
        raw.push_packed(k % 2, raw.plan.pack(
            from_numpy_tree(_grads(10 + k), "cpu")))
    drift = float((raw.pull_packed() - port.pull_packed()).abs().max())
    assert 0.0 < drift < (0.05 if compression == "int8" else 1.0), drift
    # a departing worker's error state goes with it
    port.remove_worker(1)
    assert 1 not in port._wire_err and 0 in port._wire_err
    for srv in (port, ref, raw):
        srv.stop()


def test_tree_wire_compression_agrees_with_the_reference_server():
    from repro.core.policies import make_policy_factory as jfactory
    from repro.optim.compression import make_compressor as jmake
    from repro.ps.server import ServerOptimizer as JOpt
    from repro.ps.sharded.server import ShardedParameterServer as JServer
    params = _params()
    port = ShardedParameterServer(
        from_numpy_tree(params, "cpu"), make_policy_factory("asp"),
        lambda: ServerOptimizer(lr=0.05, momentum=0.9), 1, 2,
        apply_mode="tree", compressor=tcomp.make_compressor("int8"))
    ref = JServer(jax.tree_util.tree_map(jnp.asarray, params),
                  jfactory("asp"), lambda: JOpt(lr=0.05, momentum=0.9),
                  1, 2, apply_mode="tree", compressor=jmake("int8"))
    for k in range(3):
        g = _grads(20 + k)
        port.push(0, from_numpy_tree(g, "cpu"))
        ref.push(0, jax.tree_util.tree_map(jnp.asarray, g))
    ours, theirs = port.pull(0), ref.pull(0)
    for name in params:
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.asarray(theirs[name]), atol=1e-5,
                                   rtol=0)
    port.stop(), ref.stop()
