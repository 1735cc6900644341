"""The port's logical-axis sharding (``repro_torch.models.sharding``) and
every spec derived from it, equal to the reference's, element for
element.

* ``AxisRules.spec`` under every rule set — single and multi pod × sp ×
  role (tp, dp) × fsdp — at axis sizes (16, 16), (2, 16, 16), (2, 4) and
  (2, 2, 2): the reference's cases (``tests/test_sharding_rules.py``)
  and a hypothesis property over random logical axes and shapes.
* ``spec_tree`` of every architecture's full config under every rule
  set; ``state_partition_specs`` of the four optimizers (Adafactor's
  factored moments); ``pipeline_specs``.
* The decode state's placement (``cache_specs``/``state_specs`` of
  every family, through the registry), ``batch_specs``, and
  ``input_specs``/``state_sds`` shapes and dtypes for every (arch,
  shape) cell that ``cell_applicable`` allows, with no memory behind
  them.
"""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.core import dssp_spmd as jdssp
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models import sharding as jsharding
from repro.models.params import sds_tree as jsds_tree
from repro.models.params import spec_tree as jspec_tree
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.optimizers import state_partition_specs as jstate_specs
from repro_torch import tree as tree_util
from repro_torch.configs import arch_names, get_config
from repro_torch.configs import shapes
from repro_torch.core import dssp_spmd
from repro_torch.launch import steps
from repro_torch.models import registry, sharding
from repro_torch.models.params import sds_tree, spec_tree
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import state_partition_specs

P = sharding.PartitionSpec
SIZES = {"data": 16, "model": 16}
SIZES3 = {"pod": 2, "data": 16, "model": 16}
AXIS_SIZES = [SIZES, SIZES3, {"data": 2, "model": 4},
              {"pod": 2, "data": 2, "model": 2}]
RULE_KW = [dict(sp=sp, role=role, fsdp=fsdp) for sp, role, fsdp in
           itertools.product((True, False), ("tp", "dp"), (True, False))]
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")
LOGICAL = (None, "batch", "model", "heads", "kv_heads", "fsdp", "cache_seq",
           "seq", "unknown")


def _rules(pkg, sizes, **kw):
    multi = "pod" in sizes
    return (pkg.multi_pod_rules if multi else pkg.single_pod_rules)(
        sizes, **kw)


def _rule_pairs():
    for sizes in AXIS_SIZES:
        for kw in RULE_KW:
            yield _rules(jsharding, sizes, **kw), _rules(sharding, sizes, **kw)


def _same(ref_tree, port_tree):
    """Leaf for leaf, the reference's PartitionSpecs equal the port's."""
    a = jax.tree_util.tree_leaves(ref_tree, is_leaf=lambda x: isinstance(
        x, JP))
    b = tree_util.leaves(port_tree, is_leaf=sharding.is_spec)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(x, JP) and isinstance(y, P)
        assert tuple(x) == tuple(y) and x == y, (x, y)


# ----------------------------------------------------- the reference's cases
def test_divisible_dims_shard():
    r = sharding.single_pod_rules(SIZES)
    assert r.spec(("batch", None, None), (256, 4096, 2560)) == P("data")
    assert r.spec((None, "fsdp", "model"), (24, 2560, 6912)) == \
        P(None, "data", "model")


def test_non_divisible_dims_drop():
    r = sharding.single_pod_rules(SIZES)
    assert r.spec((None, "fsdp", "model", None),
                  (64, 5120, 40, 128)) == P(None, "data")
    assert r.spec(("batch", None), (1, 524288)) == P()


def test_multi_axis_mapping_and_dedup():
    r = sharding.multi_pod_rules(SIZES3)
    assert r.spec(("batch", None), (256, 4096)) == P(("pod", "data"))
    s = r.spec((None, "cache_seq", "fsdp"), (8, 32768, 4096))
    assert s == P(None, ("data", "model"))


def test_partial_multi_axis_divisibility():
    r = sharding.multi_pod_rules(SIZES3)
    assert r.spec(("batch",), (32,)) == P(("pod", "data"))
    assert r.spec(("batch",), (16,)) == P("pod")
    assert r.spec(("batch",), (1,)) == P()


def test_rank_mismatch_and_unknown_shape():
    r = sharding.single_pod_rules(SIZES)
    with pytest.raises(ValueError, match="rank mismatch"):
        r.spec(("batch",), (4, 4))
    # no shape: every mapping trusted, as the reference does
    assert r.spec(("batch", "fsdp")) == \
        jsharding.single_pod_rules(SIZES).spec(("batch", "fsdp"))


def test_rules_context_and_logical_spec():
    r = sharding.single_pod_rules(SIZES)
    assert sharding.current_rules() is None
    assert sharding.logical_spec(("batch",), (32,)) == P()
    with sharding.use_rules(r):
        assert sharding.current_rules() is r
        assert sharding.logical_spec(("batch",), (32,)) == P("data")
        x = np.zeros(3)
        assert sharding.shard(x, "batch") is x
        assert not sharding.has_mesh() and sharding.sp_mode()
    assert sharding.current_rules() is None


@pytest.mark.parametrize("kw", RULE_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("sizes", AXIS_SIZES, ids=lambda s: "x".join(
    map(str, s.values())))
def test_rule_sets_equal_the_reference(sizes, kw):
    ref, port = _rules(jsharding, sizes, **kw), _rules(sharding, sizes, **kw)
    assert port.rules == ref.rules
    assert port.attn_mode == ref.attn_mode
    assert port.axis_sizes == ref.axis_sizes


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_spec_property_equals_the_reference(data):
    sizes = data.draw(st.sampled_from(AXIS_SIZES))
    kw = data.draw(st.sampled_from(RULE_KW))
    rank = data.draw(st.integers(1, 5))
    logical = data.draw(st.lists(st.sampled_from(LOGICAL), min_size=rank,
                                 max_size=rank))
    shape = data.draw(st.lists(st.sampled_from(
        (1, 2, 3, 4, 6, 8, 12, 16, 32, 40, 48, 64, 256, 51872, 32768)),
        min_size=rank, max_size=rank))
    ref = _rules(jsharding, sizes, **kw).spec(logical, shape)
    port = _rules(sharding, sizes, **kw).spec(logical, shape)
    assert tuple(ref) == tuple(port) and ref == port


# ----------------------------------------------------- derived spec trees
@pytest.mark.parametrize("arch", arch_names())
def test_param_and_optimizer_specs_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jdefs, defs = jregistry.param_defs(jcfg), registry.param_defs(cfg)
    jsds = jsds_tree(jdefs, jcfg.dtype)
    sds = sds_tree(defs, cfg.dtype)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jsds)] == \
        [tuple(x.shape) for x in tree_util.leaves(sds)]
    assert all(x.device.type == "meta" for x in tree_util.leaves(sds))
    for jr, tr in _rule_pairs():
        jspec, tspec = jspec_tree(jdefs, jr), spec_tree(defs, tr)
        _same(jspec, tspec)
        _same(jdssp.pipeline_specs(jspec, 4),
              dssp_spmd.pipeline_specs(tspec, 4))
        for name in OPTIMIZERS:
            _same(jstate_specs(jmake_optimizer(name), jspec, jsds),
                  state_partition_specs(make_optimizer(name), tspec, sds))
    _same(jspec_tree(jdefs, None), spec_tree(defs, None))


def test_optimizer_specs_follow_params():
    """The reference's ``test_opt_state_specs_follow_params``."""
    cfg = get_config("h2o-danube-1.8b")
    rules = sharding.single_pod_rules(SIZES)
    defs = registry.param_defs(cfg)
    p_spec = spec_tree(defs, rules)
    p_sds = sds_tree(defs, cfg.dtype)
    st_ = state_partition_specs(make_optimizer("adamw", 1e-3), p_spec, p_sds)
    assert st_.mu == p_spec and st_.nu == p_spec and st_.count == P()
    st_ = state_partition_specs(make_optimizer("adafactor"), p_spec, p_sds)
    assert st_.v_row["layers"]["mlp"]["w_gate"] == P(None, "data")
    assert st_.v_col["layers"]["mlp"]["w_gate"] == P(None, "model")
    assert state_partition_specs(make_optimizer("sgd"), p_spec, p_sds) == ()


def test_whisper_padded_vocab_shards():
    cfg = get_config("whisper-tiny")
    specs = spec_tree(registry.param_defs(cfg),
                      sharding.single_pod_rules(SIZES))
    assert cfg.padded_vocab % 16 == 0 and tuple(specs["embed"])[0] == "model"


def _cells():
    for arch in arch_names():
        for name in jshapes.SHAPES:
            yield arch, name


@pytest.mark.parametrize("arch", arch_names())
def test_shapes_and_decode_state_specs_equal_the_reference(arch):
    assert shapes.SHAPES == {k: shapes.ShapeSpec(**vars(v))
                             for k, v in jshapes.SHAPES.items()}
    assert shapes.SUB_QUADRATIC == jshapes.SUB_QUADRATIC
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, jshape in jshapes.SHAPES.items():
        ok = jshapes.cell_applicable(arch, name)
        assert shapes.cell_applicable(arch, name) == ok
        if not ok:
            continue
        shape = shapes.SHAPES[name]
        jin, tin = jshapes.input_specs(jcfg, jshape), \
            shapes.input_specs(cfg, shape)
        assert sorted(jin) == sorted(tin)
        for k in jin:
            assert tuple(jin[k].shape) == tuple(tin[k].shape)
            assert str(jin[k].dtype) == str(tin[k].dtype).split(".")[-1]
            assert tin[k].device.type == "meta"
        for jr, tr in _rule_pairs():
            _same(jsteps.batch_specs(jcfg, jr, jin),
                  steps.batch_specs(cfg, tr, tin))
        if shape.kind != "decode":
            continue
        jstate = jshapes.state_sds(jcfg, jshape)
        tstate = shapes.state_sds(cfg, shape)
        assert [(tuple(x.shape), str(x.dtype)) for x in
                jax.tree_util.tree_leaves(jstate)] == \
            [(tuple(x.shape), str(x.dtype).split(".")[-1])
             for x in tree_util.leaves(tstate)]
        assert all(x.device.type == "meta" for x in tree_util.leaves(tstate))
        b, l = shape.global_batch, shape.seq_len
        for jr, tr in itertools.chain(_rule_pairs(), [(None, None)]):
            if cfg.family == "audio":
                jsp = jregistry.family(jcfg).state_specs(jcfg, b, l, l, jr)
                tsp = registry.family(cfg).state_specs(cfg, b, l, l, tr)
            else:
                jsp = jregistry.family(jcfg).state_specs(jcfg, b, l, jr)
                tsp = registry.family(cfg).state_specs(cfg, b, l, tr)
            _same(jsp, tsp)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "h2o-danube-1.8b"])
def test_int8_cache_specs_equal_the_reference(arch):
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    jcfg = jget_config(arch).scaled(kv_cache_dtype="int8")
    cfg = get_config(arch).scaled(kv_cache_dtype="int8")
    for jr, tr in _rule_pairs():
        _same(jtransformer.cache_specs(jcfg, 128, 32768, jr),
              transformer.cache_specs(cfg, 128, 32768, tr))
