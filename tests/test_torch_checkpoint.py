"""The port's checkpoint manager against the reference's, on one disk
format.

Save/restore round trips (f32 and bf16, bitwise), torn ``.tmp_``
directories ignored and removed, keep-K, a failed async write raised on
the next call, leaf names equal to ``jax.tree_util.keystr``'s, and
snapshots crossing packages: a reference-written f32 snapshot read by
the port and a port-written one read by the reference, bit for bit,
and a reference-written bf16 snapshot (``.npy`` descr ``V2``) read by
the port as bf16 by the manifest's dtype.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten as jflatten
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import keystr_names


def _tree(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"shard001": {"p": torch.randn(16, 512, generator=g).to(dtype),
                         "m": torch.randn(16, 512, generator=g).to(dtype)},
            "shard000": {"p": torch.randn(8, 512, generator=g).to(dtype),
                         "m": torch.zeros(8, 512, dtype=dtype)},
            "extra": [torch.arange(5, dtype=torch.int32),
                      (torch.tensor(2.5),)]}


def _leaves(tree):
    return [x for _, x in keystr_names(tree)]


def _bits(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("async_save", [True, False])
def test_save_restore_round_trip_is_bitwise(tmp_path, dtype, async_save):
    tree = _tree(dtype)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    mgr.save(7, tree, {"note": "x", "versions": [1, 2]})
    mgr.wait()
    step, back, extras = mgr.restore_latest(tree)
    assert step == 7 and extras == {"note": "x", "versions": [1, 2]}
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    manifest = json.loads((tmp_path / "step_000000007" /
                           "manifest.json").read_text())
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    want = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert dtypes["['shard000']['p']"] == want
    assert dtypes["['extra'][0]"] == "int32"


def test_torn_tmp_dirs_are_ignored_and_collected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _tree())
    (tmp_path / "step_000000005.tmp_").mkdir()         # crash mid-save
    (tmp_path / "step_000000009").mkdir()              # no manifest
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    assert not (tmp_path / "step_000000005.tmp_").exists()
    assert mgr2.latest_step() == 1
    assert JManager(str(tmp_path)).steps() == [1]      # same rule


def test_keep_k_and_async_failure_surfaces_on_next_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(seed=s))
    mgr.wait()
    assert mgr.steps() == [3, 4]
    with pytest.raises(KeyError):
        mgr.restore(4, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, dict(_tree(), shard000={"p": torch.zeros(3, 512),
                                               "m": torch.zeros(8, 512)}))
    # a FILE where the writer's .tmp_ directory goes: the write fails
    # on the writer thread and is raised on the caller's next call
    bad = CheckpointManager(str(tmp_path / "sub"), keep=1)
    (tmp_path / "sub" / "step_000000001.tmp_").write_text("in the way")
    bad.save(1, _tree())
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                       # raised once, then cleared


def test_leaf_names_are_the_references_keystr_names():
    tree = _tree()
    jtree = jax.tree_util.tree_map(lambda t: np.asarray(t), tree)
    jnames = [name for name, _ in jflatten(jtree)[0]]
    assert [n for n, _ in keystr_names(tree)] == jnames
    assert "['shard000']['p']" in jnames


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def test_f32_snapshots_cross_packages_bit_for_bit(tmp_path):
    tree = _tree(torch.float32, seed=3)
    # reference writes, port reads
    JManager(str(tmp_path / "ref"), async_save=False).save(
        4, _to_jax(tree), {"from": "ref"})
    step, back, extras = CheckpointManager(
        str(tmp_path / "ref")).restore_latest(tree)
    assert step == 4 and extras == {"from": "ref"}
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert _bits(a) == _bits(b)
    # port writes, reference reads
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        5, tree, {"from": "port"})
    step, jback, extras = JManager(str(tmp_path / "port")).restore_latest(
        _to_jax(tree))
    assert step == 5 and extras == {"from": "port"}
    for a, b in zip(_leaves(tree), jax.tree_util.tree_leaves(jback)):
        assert np.asarray(b).tobytes() == a.numpy().tobytes()
    # the two managers wrote the same files
    for name in ("arr_00000.npy", "arr_00003.npy"):
        ref = np.load(tmp_path / "ref" / "step_000000004" / name)
        ours = np.load(tmp_path / "port" / "step_000000005" / name)
        assert ref.dtype == ours.dtype and ref.tobytes() == ours.tobytes()


def test_reference_bf16_snapshot_reads_back_as_bf16(tmp_path):
    """The reference saves a bf16 leaf through ml_dtypes: a ``V2`` array
    with "bfloat16" in the manifest.  The port views it back as
    ``torch.bfloat16`` by the manifest's dtype (the reference's own
    restore cannot: jnp refuses a ``|V2`` array)."""
    tree = _tree(torch.bfloat16, seed=5)
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    JManager(str(tmp_path), async_save=False).save(2, jtree)
    manifest = json.loads((tmp_path / "step_000000002" /
                           "manifest.json").read_text())
    entry = {e["name"]: e for e in manifest["leaves"]}["['shard000']['p']"]
    assert entry["dtype"] == "bfloat16"
    arr = np.load(tmp_path / "step_000000002" / entry["file"])
    assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    _, back, _ = CheckpointManager(str(tmp_path)).restore_latest(tree)
    for a, b, j in zip(_leaves(tree), _leaves(back),
                       jax.tree_util.tree_leaves(jtree)):
        assert b.dtype == a.dtype and _bits(a) == _bits(b)
        if a.dtype == torch.bfloat16:
            assert np.asarray(j).view(np.int16).tobytes() == _bits(b)
    # and the port's own bf16 file holds the same bits as ml_dtypes'
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        2, tree)
    ours = np.load(tmp_path / "port" / "step_000000002" / entry["file"])
    assert ours.tobytes() == arr.tobytes()
    assert ours.view(ml_dtypes.bfloat16).tobytes() == arr.tobytes()
