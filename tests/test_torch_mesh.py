"""The port's device mesh (``repro_torch.launch.mesh``, ``launch.steps``,
``launch.elastic``, the mesh half of ``core.dssp_spmd``) against the
reference.

The oracle is the reference on a one-device mesh whose axes are Auto
(``jax.sharding.Mesh`` over ``jax.devices()[:1]``): its ``Trainer`` with
``rules_for_mesh`` rules and its ``build_train_step`` bundle, jitted as
the reference jits them, on h2o-danube-1.8b's f32 smoke config from the
same initial parameters and batches.  Under GSPMD a sharding never
changes a value, so one device is the reference's answer for any mesh.

* One rank, in this process (a gloo group of one): the ``Trainer`` and
  the ``spmd`` session with ``rules=`` (losses within 1e-5; momentum
  params within 1e-5, adamw by the rule of ``tests/test_torch_train.py``),
  no flash kernel and no collective; the step bundles (train with
  ``grad_accum=2``, prefill, decode) against the reference's bundle and
  the plain forward.
* Four ranks over gloo (``run_ranks``: a ``FileStore`` under
  ``tmp_path``, a 120 s deadline each): the (2, 2) ``Trainer`` and
  session, the (2, 2) bundles, ``cross_pod_sync`` bit for bit against
  the reference's (8 forced host devices, in a subprocess) with the
  local-SGD scenario of ``tests/test_cross_pod.py``, the ring split over
  'data' (``tests/test_distributed.py``'s semantics), and
  ``rescale_params`` from 4 ranks to 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.core import dssp_spmd as jdssp
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batches as jbatches
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.models.sharding import rules_for_mesh as jrules_for_mesh
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.api.session import batch_tensors
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import dssp_spmd
from repro_torch.data.synthetic import DataConfig, batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.train import Trainer
from repro_torch.models import layers, transformer
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.perfcount import MESH

torch.set_num_threads(2)

ARCH = ranks.ARCH
SEQ, BATCH = ranks.SEQ, ranks.BATCH
STEPS = 4
LR = 1e-3
DELAYS = [0, 1, 2, 3, 3, 1]
ACCUM = 2
DEADLINE_S = 120.0
REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


# ------------------------------------------------------------ oracles
def _jmesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _jdata(cfg):
    return JDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       global_batch=BATCH)


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial smoke parameters, as numpy."""
    params = jregistry.init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _ref_trainer_run(optimizer):
    jm = _jmesh()
    cfg = jax_smoke(ARCH)
    ref = jtrain.Trainer(cfg, _jdata(cfg), sync="dssp", s_lower=1,
                         s_upper=3, lr=LR, optimizer=optimizer,
                         rules=jrules_for_mesh(jm, sp=True, role="tp"))
    with jm:
        log = ref.train(STEPS)
    return {"losses": list(log.losses), "delays": list(log.delays),
            "params": ref.params}


@pytest.fixture(scope="module")
def ref_momentum():
    return _ref_trainer_run("momentum")


@pytest.fixture(scope="module")
def ref_bundle():
    """The reference's ``build_train_step`` on the one-device mesh with
    ``grad_accum=2``, damped momentum, explicit delays."""
    jm = _jmesh()
    cfg = jax_smoke(ARCH).scaled(grad_accum=ACCUM)
    opt = jmake_optimizer("momentum", LR, staleness_damping=True)
    b = jsteps.build_train_step(cfg, jm, JShapeSpec("smoke", SEQ, BATCH,
                                                    "train"),
                                sync="dssp", s_upper=3, optimizer=opt)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    state = opt.init(params)
    pipe = jdssp.init_pipeline(
        jax.tree_util.tree_map(jnp.zeros_like, params), 4)
    it = jbatches(cfg, _jdata(cfg))
    losses = []
    with jm:
        for d in DELAYS:
            bt = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, state, pipe, m = fn(params, state, pipe, bt,
                                        jnp.int32(d))
            losses.append(float(m["loss"]))
    return {"losses": losses, "params": params}


@pytest.fixture(scope="module")
def ref_adafactor():
    """The reference's BSP ``build_train_step`` with adafactor on the
    one-device mesh: parameters and state after a few steps."""
    jm = _jmesh()
    cfg = jax_smoke(ARCH)
    opt = jmake_optimizer("adafactor", LR)
    b = jsteps.build_train_step(cfg, jm, JShapeSpec("smoke", SEQ, BATCH,
                                                    "train"),
                                sync="bsp", optimizer=opt)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    params = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    state = opt.init(params)
    it = jbatches(cfg, _jdata(cfg))
    with jm:
        for _ in range(ranks.ADAFACTOR_STEPS):
            bt = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, state, _, _ = fn(params, state, (), bt, jnp.int32(0))
    return {"params": params, "state": state}


def _close(port_leaves, ref_tree, tol):
    ref = jax.tree_util.tree_leaves(ref_tree)
    assert len(port_leaves) == len(ref)
    for x, y in zip(port_leaves, ref):
        x = x.detach().float().numpy() if isinstance(x, torch.Tensor) else x
        np.testing.assert_allclose(x, np.asarray(y, np.float32), atol=tol,
                                   rtol=0)


# ------------------------------------------------------------ one rank
@pytest.fixture(scope="module")
def one_rank_mesh():
    """A gloo group of one in this process and its (1, 1) mesh."""
    started = not dist.is_initialized()
    if started:
        mesh_lib.start_group(backend="gloo")
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"))
    finally:
        if started:
            dist.destroy_process_group()


def _no_flash(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the flash path ran on a mesh")
    monkeypatch.setattr(layers.K, "attention", boom)


@pytest.mark.parametrize("optimizer", ["momentum", "adamw"])
def test_one_rank_mesh_trainer_matches_the_reference_with_rules(
        optimizer, one_rank_mesh, ref_init, ref_momentum, monkeypatch):
    ref = ref_momentum if optimizer == "momentum" else \
        _ref_trainer_run("adamw")
    _no_flash(monkeypatch)
    cfg = get_smoke_config(ARCH)
    rules = rules_for_mesh(one_rank_mesh, sp=True, role="tp")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH)
    t = Trainer(cfg, data, sync="dssp", s_lower=1, s_upper=3, lr=LR,
                optimizer=optimizer, device="cpu", rules=rules)
    t.params = from_numpy_tree(ref_init, "cpu")
    stored = [x.data_ptr() for x in tree_util.leaves(t.params)]
    MESH.reset()
    log = t.train(STEPS)
    assert MESH.snapshot() == {k: 0 for k in MESH.snapshot()}
    # the step updated the stored tensors: nothing was placed or copied
    assert [x.data_ptr() for x in tree_util.leaves(t.params)] == stored
    assert log.delays == ref["delays"]
    if optimizer == "momentum":
        np.testing.assert_allclose(log.losses, ref["losses"], atol=1e-5,
                                   rtol=0)
        _close(tree_util.leaves(t.params), ref["params"], 1e-5)
    else:
        # the Adam rule of tests/test_torch_train.py: elements
        # whose gradient is far below eps move by up to about lr
        np.testing.assert_allclose(log.losses, ref["losses"], atol=2e-5,
                                   rtol=0)
        beyond = total = 0
        for x, y in zip(tree_util.leaves(t.params),
                        jax.tree_util.tree_leaves(ref["params"])):
            err = np.abs(x.numpy() - np.asarray(y, np.float32))
            assert err.max() <= 2 * LR
            beyond += int((err > 1e-5).sum())
            total += err.size
        assert beyond <= 1e-4 * total

    # the session with rules= is that Trainer, bit for bit
    spec = api.RunSpec(
        model=api.ModelSpec(arch=ARCH),
        data=api.DataSpec(seq_len=SEQ, global_batch=BATCH),
        optimizer=api.OptimizerSpec(name=optimizer, lr=LR),
        sync=api.SyncSpec(mode="dssp", s_lower=1, s_upper=3))
    with api.build_session(spec, device="cpu", rules=rules) as session:
        session.start()
        session.trainer.params = from_numpy_tree(ref_init, "cpu")
        m = session.run(STEPS)
    assert session.trainer.log.losses == log.losses
    assert m["final_loss"] == log.losses[-1]


def test_remat_recompute_in_another_thread_keeps_the_mesh_path(
        one_rank_mesh, monkeypatch):
    """On the card autograd runs the backward on a device thread of its
    own, where the forward's thread-local rules are not installed: the
    checkpointed layers re-install them (``remat_contexts``), so the
    recompute takes the mesh formulation again.  Here the backward runs
    in another thread on purpose; its gradients equal the same-thread
    ones bit for bit, and no flash attention runs."""
    import threading

    from repro_torch.models.sharding import use_rules
    _no_flash(monkeypatch)
    cfg = get_smoke_config(ARCH).scaled(remat="full")
    params = from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jregistry.init_params(
            jax_smoke(ARCH), jax.random.PRNGKey(0))), "cpu")
    batch = batch_tensors(next(batches(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH))), "cpu")
    rules = rules_for_mesh(one_rank_mesh, sp=True, role="tp")
    leaves, treedef = tree_util.flatten(params)

    def grads(elsewhere: bool):
        live = [x.detach().requires_grad_() for x in leaves]
        with use_rules(rules):
            loss = transformer.loss_fn(
                cfg, tree_util.unflatten(treedef, live), batch)[0]
        out = {}
        if not elsewhere:
            return torch.autograd.grad(loss, live)
        t = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, live)))
        t.start()
        t.join(60)
        return out["g"]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


def test_one_rank_step_bundles_match_the_reference(one_rank_mesh, ref_init,
                                                   ref_bundle, monkeypatch):
    _no_flash(monkeypatch)
    mesh = one_rank_mesh
    cfg = get_smoke_config(ARCH).scaled(grad_accum=ACCUM)
    opt = make_optimizer("momentum", LR, staleness_damping=True)
    bundle = steps.build_train_step(
        cfg, mesh, ShapeSpec("smoke", SEQ, BATCH, "train"), sync="dssp",
        s_upper=3, optimizer=opt)
    assert bundle.donate_argnums == (0, 1, 2)
    # shapes only: meta tensors, but the host's 0-d step counters
    assert all(x.device.type == "meta" or x.dim() == 0
               for x in tree_util.leaves(bundle.input_sds))
    p_sh, _, _, b_sh, _ = bundle.in_shardings
    full = from_numpy_tree(ref_init, "cpu")
    params = mesh_lib.place(full, p_sh, mesh)
    assert all(a is b for a, b in zip(tree_util.leaves(params),
                                      tree_util.leaves(full)))
    state = opt.init(params)
    pipe = dssp_spmd.init_pipeline(params, 4)
    it = batches(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH))
    MESH.reset()
    losses = []
    for d in DELAYS:
        batch = mesh_lib.place(batch_tensors(next(it), "cpu"), b_sh, mesh)
        params, state, pipe, m = bundle.fn(params, state, pipe, batch, d)
        losses.append(float(m["loss"]))
    assert sum(MESH.snapshot().values()) == 0
    np.testing.assert_allclose(losses, ref_bundle["losses"], atol=1e-5,
                               rtol=0)
    _close(tree_util.leaves(params), ref_bundle["params"], 1e-5)

    # prefill and decode against the plain forward and decode
    pcfg = get_smoke_config(ARCH)
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, pcfg.vocab_size, (BATCH, SEQ))).long()
    pre = steps.build_prefill_step(pcfg, mesh, ShapeSpec("p", SEQ, BATCH,
                                                         "prefill"))
    tok, cache = pre.fn(full, {"tokens": tokens, "labels": tokens})
    monkeypatch.undo()      # the plain forward takes the registry's path
    with torch.no_grad():
        logits, want = transformer.forward_prefill(pcfg, full, tokens)
    assert torch.equal(tok, torch.argmax(logits[:, -1], dim=-1))
    for k in want:
        torch.testing.assert_close(cache[k], want[k], atol=1e-6, rtol=0)
    serve = steps.build_serve_step(pcfg, mesh, ShapeSpec("d", SEQ, BATCH,
                                                         "decode"))
    assert serve.donate_argnums == (2,)
    mine = tree_util.tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype),
                              serve.input_sds[2])
    plain = transformer.init_cache(pcfg, BATCH, SEQ)
    a = b = tokens[:, :1].clone()
    for index in range(ranks.DECODE_STEPS):
        a, mine = serve.fn(full, a, mine, index)
        with torch.no_grad():
            logits, plain = transformer.forward_decode(pcfg, full, b, plain,
                                                       index)
        b = torch.argmax(logits[:, -1], dim=-1)[:, None]
        assert torch.equal(a, b)
    for k in plain:
        torch.testing.assert_close(mine[k], plain[k], atol=1e-6, rtol=0)


def test_mesh_constructors_refuse_what_they_cannot_build(one_rank_mesh):
    with pytest.raises(RuntimeError, match=r"mesh \(2, 2\) needs 4 devices, "
                                           r"have 1"):
        mesh_lib.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="needs 256 devices, have 1"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True)
    m = mesh_lib.elastic_mesh(1)
    assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")


# ------------------------------------------------------------ four ranks
def _run(fn, tmp_path, *args):
    return mesh_lib.run_ranks(fn, 4, str(tmp_path), args=args,
                              timeout=DEADLINE_S)


@pytest.fixture(scope="module")
def collective_branches(tmp_path_factory):
    return mesh_lib.run_ranks(ranks.collective_branch_ranks, 4,
                              str(tmp_path_factory.mktemp("branches")),
                              timeout=DEADLINE_S)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_single_tensor_collectives_keep_the_gloo_block_order(
        dim, collective_branches):
    """The single-tensor branches of ``all_gather_cat`` and
    ``reduce_scatter_cat`` (NCCL's ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, here their list-based equivalents on a
    gloo group) give the gloo branch's blocks, in group-rank order,
    along every dimension: the ranks' tensors concatenated, and this
    rank's block of their sum."""
    xs = [np.arange(4 * 8 * 12, dtype=np.float32).reshape(4, 8, 12)
          + 1000.0 * r for r in range(4)]
    gathered = np.concatenate(xs, axis=dim)
    total = sum(xs)
    for rank, out in enumerate(collective_branches):
        step = total.shape[dim] // 4
        block = np.take(total, range(rank * step, (rank + 1) * step),
                        axis=dim)
        for branch in ("gloo", "single"):
            ag, rs = out[branch][dim]
            np.testing.assert_array_equal(ag, gathered)
            np.testing.assert_array_equal(rs, block)


def test_2x2_gloo_mesh_trainer_and_session_match_the_reference(
        tmp_path, ref_init, ref_momentum):
    outs = _run(ranks.trainer_ranks, tmp_path, (2, 2), ("data", "model"),
                ref_init, STEPS, LR)
    full_shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(ref_init)]
    for out in outs:
        for run in ("trainer", "session"):
            np.testing.assert_allclose(out[run]["losses"],
                                       ref_momentum["losses"], atol=1e-5,
                                       rtol=0)
        assert out["trainer"]["delays"] == ref_momentum["delays"]
        # stored blocks: the fsdp dims split over 'data', the MLP's over
        # 'model' (SP rules); every rank gathered, reduced and broadcast
        blocks = out["trainer"]["block_shapes"]
        assert sum(np.prod(b) for b in blocks) < sum(
            np.prod(s) for s in full_shapes)
        counts = out["mesh_counts"]
        assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
        assert counts["broadcast"] == STEPS
    for run in ("trainer", "session"):
        _close(outs[0][run]["params"], ref_momentum["params"], 1e-5)


def test_2x2_gloo_mesh_step_bundles_match_the_reference(
        tmp_path, ref_init, ref_bundle, ref_adafactor):
    outs = _run(ranks.bundle_ranks, tmp_path, (2, 2), ("data", "model"),
                ref_init, DELAYS, LR, ACCUM)
    np.testing.assert_allclose(outs[0]["losses"], ref_bundle["losses"],
                               atol=1e-5, rtol=0)
    _close(outs[0]["params"], ref_bundle["params"], 1e-5)
    # adafactor: the whole-leaf update, blocks kept (the factored moments
    # of split leaves are split too)
    _close(outs[0]["adafactor"]["params"], ref_adafactor["params"], 1e-5)
    _close(outs[0]["adafactor"]["state"], ref_adafactor["state"], 1e-5)
    full_state = [np.shape(x) for x in
                  jax.tree_util.tree_leaves(ref_adafactor["state"])]
    assert outs[0]["adafactor_blocks"] != full_state
    pcfg = get_smoke_config(ARCH)
    full = from_numpy_tree(ref_init, "cpu")
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, pcfg.vocab_size, (BATCH, SEQ))).long()
    with torch.no_grad():
        logits, want = transformer.forward_prefill(pcfg, full, tokens)
    plain = transformer.init_cache(pcfg, BATCH, SEQ)
    b, decoded = tokens[:, :1].clone(), []
    for index in range(ranks.DECODE_STEPS):
        with torch.no_grad():
            lg, plain = transformer.forward_decode(pcfg, full, b, plain,
                                                   index)
        b = torch.argmax(lg[:, -1], dim=-1)[:, None]
        decoded.append(b.numpy())
    for out in outs:
        assert out["losses"] == outs[0]["losses"]
        np.testing.assert_array_equal(
            out["prefill_tokens"], torch.argmax(logits[:, -1], -1).numpy())
        for k in want:
            np.testing.assert_allclose(out["prefill_cache"][k],
                                       want[k].numpy(), atol=1e-6, rtol=0)
        for got, ref in zip(out["decoded"], decoded):
            np.testing.assert_array_equal(got, ref)
        for k in plain:
            np.testing.assert_allclose(out["decode_cache"][k],
                                       plain[k].numpy(), atol=1e-6, rtol=0)
        # the decode cache's sequence is split over 'model'
        full_cache = plain["k"].shape
        assert out["cache_blocks"]["k"] == (full_cache[0], full_cache[1] // 2,
                                            full_cache[2] // 2,
                                            *full_cache[3:])


_REF_CROSS_POD = """
import os, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.dssp_spmd import DsspScheduleController, cross_pod_sync
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
x = np.load({x_path!r})
sh = NamedSharding(mesh, P('pod', None, None))
out = jax.jit(lambda t: cross_pod_sync(t, mesh, P('pod', None, None)))(
    jax.device_put(jnp.asarray(x), sh))
np.save({out_path!r}, np.asarray(out))

rng = np.random.RandomState({seed})
w_true = rng.randn(16, 1).astype(np.float32)
X = rng.randn(512, 16).astype(np.float32)
Y = X @ w_true
w = jax.device_put(jnp.zeros((2, 16, 1)), sh)
xb = jax.device_put(jnp.asarray(X).reshape(2, 256, 16),
                    NamedSharding(mesh, P('pod', 'data', None)))
yb = jax.device_put(jnp.asarray(Y).reshape(2, 256, 1),
                    NamedSharding(mesh, P('pod', 'data', None)))

def loss(w, x, y):
    return jnp.mean((jnp.einsum('pbd,pdo->pbo', x, w) - y) ** 2)

local_step = jax.jit(lambda w, x, y: w - 0.1 * jax.grad(loss)(w, x, y))
sync = jax.jit(lambda w: cross_pod_sync(w, mesh, P('pod', None, None)))
ctrl = DsspScheduleController(1, 4)
l0 = float(loss(w, xb, yb))
periods = []
for outer in range(12):
    k = ctrl.period([1.0, 1.3])
    periods.append(k)
    for _ in range(k):
        w = local_step(w, xb, yb)
    w = sync(w)
print(json.dumps({{"l0": l0, "l1": float(loss(w, xb, yb)),
                  "periods": periods}}))
"""


def test_cross_pod_sync_and_local_sgd_match_the_reference(tmp_path):
    seed = 0
    x = np.random.RandomState(3).randn(2, 4, 4).astype(np.float32)
    x_path, out_path = str(tmp_path / "x.npy"), str(tmp_path / "out.npy")
    np.save(x_path, x)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_CROSS_POD.format(
            x_path=x_path, out_path=out_path, seed=seed))],
        env=env, capture_output=True, text=True, timeout=DEADLINE_S)
    assert ref.returncode == 0, ref.stderr
    ref_sgd = json.loads(ref.stdout.strip().splitlines()[-1])
    ref_sync = np.load(out_path)

    outs = _run(ranks.cross_pod_ranks, tmp_path, x, seed)
    for out in outs:
        # bit for bit: each rank holds its pod's block, averaged
        assert out["synced"].tobytes() == ref_sync[out["pod"]].tobytes()
        assert out["periods"] == ref_sgd["periods"]
        assert all(out["synced_equal"]) and any(out["drifted"])
        np.testing.assert_allclose(out["l0"], ref_sgd["l0"], rtol=1e-6)
        assert out["l1"] < 0.2 * out["l0"], (out["l0"], out["l1"])
        np.testing.assert_allclose(out["l1"], ref_sgd["l1"], rtol=1e-3)


def test_ring_split_over_data_keeps_the_reference_semantics(tmp_path):
    for outs in _run(ranks.pipeline_ranks, tmp_path):
        # delay 2: nothing valid before step 2, then step t - 2's grads
        assert [o[:2] for o in outs] == [(0.0, 0.0), (0.0, 0.0),
                                         (1.0, 1.0), (2.0, 1.0)]
        assert all(o[2] == (4, 8) and o[3] for o in outs)


def test_rescale_params_from_4_ranks_to_2_keeps_values(tmp_path, ref_init):
    outs = _run(ranks.rescale_ranks, tmp_path, ref_init)
    want = jax.tree_util.tree_leaves(ref_init)
    for rank, out in enumerate(outs):
        assert out["shape2"] == (1, 2)
        assert out["in_mesh2"] == (rank < 2)
        if rank < 2:
            for got, ref in zip(out["values"], want):
                assert got.tobytes() == np.asarray(ref, np.float32).tobytes()
            assert out["blocks2"] != out["blocks4"]
