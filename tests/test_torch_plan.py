"""repro_torch's shard plan and packed wire against the reference's.

The packed ``(rows, 512)`` layout is a wire contract: the port's
``plan.pack`` of the h2o-danube smoke parameters must be byte-identical
to ``repro``'s, for S in {1, 4, 16} and in f32 and bf16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import registry as jregistry
from repro.ps.sharded.plan import build_shard_plan as jax_plan
from repro_torch import tree as tree_util
from repro_torch.models.params import from_numpy_tree
from repro_torch.perfcount import WIRE
from repro_torch.ps.sharded.plan import build_shard_plan

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    cfg = get_smoke_config("h2o-danube-1.8b")
    return jregistry.init_params(cfg, jax.random.PRNGKey(0))


def _trees(jax_params, dtype: str):
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    jax_params)
        return jp, from_numpy_tree(jp, "cpu", torch.bfloat16)
    return jax_params, from_numpy_tree(jax_params, "cpu")


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shards", [1, 4, 16])
def test_pack_is_byte_identical_to_reference(jax_params, dtype, n_shards):
    jtree, ttree = _trees(jax_params, dtype)
    jplan = jax_plan(jtree, n_shards)
    tplan = build_shard_plan(ttree, n_shards)
    assert tplan.leaf_shapes == jplan.leaf_shapes
    assert [[(s.leaf, s.start, s.stop, s.whole, s.size) for s in sh.slices]
            for sh in tplan.shards] == \
        [[(s.leaf, s.start, s.stop, s.whole, s.size) for s in sh.slices]
         for sh in jplan.shards]
    jl, tl = jplan.wire_layout(), tplan.wire_layout()
    assert (tl.total_rows, tl.shard_row_start, tl.shard_rows,
            tl.slice_offsets) == (jl.total_rows, jl.shard_row_start,
                                  jl.shard_rows, jl.slice_offsets)
    jwire, twire = jplan.pack(jtree), tplan.pack(ttree)
    assert tuple(twire.shape) == tuple(jwire.shape)
    assert str(twire.dtype).split(".")[1] == str(jwire.dtype)
    assert _bytes(twire) == _bytes(jwire)


@pytest.mark.parametrize("n_shards", [1, 4, 16])
def test_unpack_and_shard_wires_round_trip(jax_params, n_shards):
    _, tree = _trees(jax_params, "float32")
    plan = build_shard_plan(tree, n_shards)
    wire = plan.pack(tree)
    back = plan.unpack(wire)
    for a, b in zip(tree_util.leaves(tree), tree_util.leaves(back)):
        assert torch.equal(a, b)
    regions = plan.shard_wires(wire)
    assert torch.equal(torch.cat([r for r in regions if r.shape[0]]), wire)
    for j, region in enumerate(regions):
        assert region.data_ptr() == wire[plan.wire_layout()
                                          .shard_row_start[j]:].data_ptr()
        pieces = plan.shard_pieces_from_wire(region, j)
        for got, want in zip(pieces, plan.split(tree)[j]):
            assert torch.equal(got, want)
        assert torch.equal(plan.pack_shard_pieces(plan.split(tree)[j], j),
                           region)


def test_unpack_returns_views_for_whole_leaves(jax_params):
    """A leaf stored whole is a view into the wire buffer (what the
    worker turns into a leaf tensor without a copy); only a leaf split
    across shards is concatenated."""
    _, tree = _trees(jax_params, "float32")
    for n_shards in (1, 16):
        plan = build_shard_plan(tree, n_shards)
        wire = plan.pack(tree)
        lo = wire.data_ptr()
        hi = lo + wire.numel() * wire.element_size()
        split = {sl.leaf for sh in plan.shards for sl in sh.slices
                 if not sl.whole}
        WIRE.reset()
        leaves = tree_util.leaves(plan.unpack(wire))
        assert WIRE.leaf_concats == len(split)
        for i, leaf in enumerate(leaves):
            inside = lo <= leaf.data_ptr() < hi
            assert inside == (i not in split), (n_shards, i)
        if n_shards == 1:
            assert not split


def test_pack_into_existing_buffer_zeroes_padding(jax_params):
    _, tree = _trees(jax_params, "float32")
    plan = build_shard_plan(tree, 4)
    out = torch.full((plan.wire_layout().total_rows, 512), 7.0)
    got = plan.pack(tree, out=out)
    assert got is out
    assert torch.equal(out, plan.pack(tree))
    with pytest.raises(ValueError, match="does not match"):
        plan.pack(tree, out=torch.zeros(8, 512))


def test_pack_rejects_mismatched_leaves(jax_params):
    _, tree = _trees(jax_params, "float32")
    plan = build_shard_plan(tree, 2)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="does not match plan shape"):
        plan.pack(bad)
    with pytest.raises(ValueError, match="does not match layout"):
        plan.unpack(torch.zeros(8, 512))
