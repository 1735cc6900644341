"""The mesh ``Trainer``'s wire compression and checkpoints
(``repro_torch.launch.train`` with ``rules=`` on a mesh) against the
reference.

Four gloo ranks (``launch.mesh.run_ranks``, the rank program
``torch_mesh_ranks.mesh_trainer_ranks``) train qwen1.5-32b's f32 smoke
config (partitioned: SP rules, damped momentum, DSSP [1, 3]) on (2, 2)
and (1, 4) over ('data', 'model'):

* with ``compressor="int8"`` and ``"topk"``, three steps from the
  reference's initial parameters: losses, delays and parameters within
  1e-5 of the reference's ``Trainer`` with the same compressor on a
  one-device mesh (``tests/test_torch_partition.py``'s oracle), the
  error state kept in blocks;
* the block compressors (each leaf's scale or top-k threshold reduced
  over the axes that split it) on leaves of the parameters' shapes full
  of ties, gathered, bit for bit against the one-device compressors on
  the whole leaves: decoded values, new error, and top-k's kept masks;
* checkpoints across packages and meshes: the ranks resume the
  reference's one-device checkpoint (its state to the bit), train two
  more steps (within 1e-5 of the reference resumed from the same
  checkpoint), and save; the reference's ``Trainer`` resumes that
  checkpoint to the bit;
* a save torn between its two renames (the committed step set aside as
  ``.old_``, its successor still ``.tmp_``): the four ranks open the
  folder together and resume the set-aside snapshot.

The reference's runs compile in this process while the ranks run.
"""

from __future__ import annotations

import os
import shutil
import threading

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.models.sharding import rules_for_mesh as jrules_for_mesh
from repro_torch.launch import mesh as mesh_lib

ARCH = ranks.TRAINER_ARCH
LR = 1e-3
TOL = 1e-5
MESHES = (("2x2", (2, 2), ("data", "model")),
          ("1x4", (1, 4), ("data", "model")))
DEADLINE_S = 180.0


def _ref_trainer(compressor="none", checkpoint_dir=None):
    """The reference's ``Trainer`` with mesh rules on a one-device mesh
    with Auto axes, and that mesh."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    cfg = jax_smoke(ARCH)
    data = JDataConfig(vocab_size=cfg.vocab_size, seq_len=ranks.SEQ,
                       global_batch=ranks.BATCH)
    return jm, jtrain.Trainer(
        cfg, data, sync="dssp", s_lower=1, s_upper=3, lr=LR,
        optimizer="momentum", compressor=compressor,
        checkpoint_dir=checkpoint_dir,
        rules=jrules_for_mesh(jm, sp=True, role="tp"))


def _state(trainer):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        {"params": trainer.params, "opt": trainer.opt_state,
         "pipeline": trainer.pipeline})]


def _oracle(ref_dir, cont_dir):
    out = {}
    for name in ranks.COMPRESSORS:
        jm, ref = _ref_trainer(name)
        with jm:
            log = ref.train(ranks.TRAINER_STEPS)
        out[name] = {"losses": list(log.losses), "delays": list(log.delays),
                     "params": [np.asarray(x) for x in
                                jax.tree_util.tree_leaves(ref.params)]}
    # the reference resumed from its own checkpoint (a copy: its saves
    # must not meet the ranks' reads)
    jm, ref = _ref_trainer(checkpoint_dir=cont_dir)
    with jm:
        assert ref.resume()
        log = ref.train(ranks.RESUMED_STEPS)
    out["continued"] = {"losses": list(log.losses), "state": _state(ref),
                        "step": ref.step_idx}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
    cont_dir = str(tmp_path_factory.mktemp("ref_continued"))
    out_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    torn_dir = str(tmp_path_factory.mktemp("torn_ckpt"))
    jm, ref = _ref_trainer(checkpoint_dir=ref_dir)
    with jm:
        ref.train(ranks.TRAINER_STEPS)
    saved = {"state": _state(ref), "step": ref.step_idx}
    shutil.copytree(ref_dir, cont_dir, dirs_exist_ok=True)
    # a crash between a resave's two renames at the same step: the
    # committed snapshot set aside, the new one not yet renamed in
    step_dir = f"step_{ref.step_idx:09d}"
    shutil.copytree(os.path.join(ref_dir, step_dir),
                    os.path.join(torn_dir, step_dir + ".old_"))
    os.makedirs(os.path.join(torn_dir, step_dir + ".tmp_"))
    init = jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jax_smoke(ARCH),
                                          jax.random.PRNGKey(0)))
    out = {"saved": saved}

    def ranks_run():
        try:
            out["ranks"] = mesh_lib.run_ranks(
                ranks.mesh_trainer_ranks, 4,
                str(tmp_path_factory.mktemp("trainer")),
                args=(MESHES, init, LR, ref_dir, out_dir, torn_dir),
                timeout=DEADLINE_S)
        except BaseException as e:      # re-raised in the test process
            out["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        out["oracle"] = _oracle(ref_dir, cont_dir)
    finally:
        t.join()
    if "error" in out:
        raise out["error"]
    # the reference resumes the ranks' checkpoint
    jm, ref = _ref_trainer(checkpoint_dir=out_dir)
    with jm:
        assert ref.resume()
    out["ref_resumed"] = {"state": _state(ref), "step": ref.step_idx}
    return out


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), atol=tol,
                                   rtol=0)


def _equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
@pytest.mark.parametrize("compressor", ranks.COMPRESSORS)
def test_mesh_trainer_compression_matches_the_reference(mesh, compressor,
                                                        runs):
    """Compression of each rank's gradient blocks, the error state in
    blocks: the reference's ``Trainer`` compressing the whole gradient,
    within 1e-5."""
    want = runs["oracle"][compressor]
    for out in runs["ranks"]:
        rec = out[f"{mesh}/{compressor}"]
        np.testing.assert_allclose(rec["losses"], want["losses"], atol=TOL,
                                   rtol=0)
        assert rec["delays"] == want["delays"]
        assert rec["err_blocks"] == rec["param_blocks"]
    shapes = [np.shape(x) for x in want["params"]]
    assert runs["ranks"][0][f"{mesh}/{compressor}"]["err_blocks"] != shapes
    _close(runs["ranks"][0][f"{mesh}/{compressor}"]["params"],
           want["params"])


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
@pytest.mark.parametrize("compressor", ranks.COMPRESSORS)
def test_block_compressors_equal_the_one_device_compressors(mesh, compressor,
                                                            runs):
    """int8's scale and top-k's threshold (an exact radix select) of the
    whole leaf from its blocks: the gathered result is the one-device
    compressor's on the gathered leaf, bit for bit, kept masks too."""
    for out in runs["ranks"]:
        rec = out[f"{mesh}/blocks"][compressor]
        assert rec["decoded"] == 0.0 and rec["error"] == 0.0, rec
        assert rec["masks_differ"] == 0 and rec["kept"] > 0, rec


def test_mesh_trainer_resumes_the_reference_checkpoint(runs):
    """Four ranks on (2, 2) resume the reference's one-device checkpoint:
    each rank's blocks of every leaf (params, momentum, ring) are the
    saved values, and two more steps stay within 1e-5 of the reference
    resumed from it."""
    saved, cont = runs["saved"], runs["oracle"]["continued"]
    for out in runs["ranks"]:
        rec = out["checkpoint"]
        assert rec["resumed"]["step"] == saved["step"]
        np.testing.assert_allclose(rec["losses"], cont["losses"], atol=TOL,
                                   rtol=0)
        assert rec["step"] == cont["step"]
    rec = runs["ranks"][0]["checkpoint"]
    _equal(rec["resumed"]["state"], saved["state"])
    _close(rec["state"], cont["state"])


def test_reference_trainer_resumes_the_mesh_checkpoint(runs):
    """The reference's one-device ``Trainer`` resumes the checkpoint the
    four ranks wrote (whole leaves, gathered one at a time): its state
    is the ranks' gathered state, bit for bit."""
    rec = runs["ranks"][0]["checkpoint"]
    assert runs["ref_resumed"]["step"] == rec["step"]
    _equal(runs["ref_resumed"]["state"], rec["state"])


def test_mesh_trainer_resumes_a_save_torn_between_its_renames(runs):
    """Four ranks open a folder where a resave crashed between its two
    renames: the first rank alone renames the set-aside snapshot back
    and drops the torn one while the others wait, and every rank
    resumes that snapshot's step and state."""
    saved = runs["saved"]
    want = [f"step_{saved['step']:09d}"]
    for i, out in enumerate(runs["ranks"]):
        rec = out["torn"]
        assert rec["tidied"] == (1 if i == 0 else 0)
        assert rec["step"] == saved["step"]
        assert rec["entries"] == want
    _equal(runs["ranks"][0]["torn"]["state"], saved["state"])
