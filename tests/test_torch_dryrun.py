"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* ``run_cell`` on every arch's smoke config, on a fake (2, 4) mesh of 8
  ranks, returns ``ok`` for a train, a prefill and a decode shape.
* The arguments' bytes it reports are the sum of the ``spec_tree``
  blocks of the step's arguments (``tests/test_torch_sharding.py`` holds
  those specs equal to the reference's).
* Its collective counts equal those a real four-rank gloo run of the
  same cell records, for a train and a (partitioned) prefill cell, and
  for Jamba's partitioned train cell with its ``ssm_scan`` calls.
* The transformers and the hybrid under role 'tp' prefill and decode
  on blocks (``partitioned``), with the collectives of a gloo run's
  decode call; the two-depth fit of the hybrid's decode gives its
  direct count.
* It leaves no process group, the kernel registry as it was, and the
  counters untouched; it refuses to start beside a group.
* The partitioned step's peak per rank is below the gather-whole step's.

The production cells (16 × 16, the published configs) take 10-125 s each
here, too long for the suite: ``chip_smoke.py``'s ``dryrun`` phase and
the CLI run them.
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro_torch import tree as tree_util
from repro_torch.configs import arch_names, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import registry as kreg
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ssm
from repro_torch.models.sharding import is_spec, mesh_axis_sizes
from repro_torch.perfcount import LAUNCHES, MESH

SHAPES = {"train": ShapeSpec("train", 32, 8, "train"),
          "prefill": ShapeSpec("prefill", 32, 8, "prefill"),
          "decode": ShapeSpec("decode", 32, 8, "decode")}


@pytest.mark.parametrize("arch", arch_names())
def test_run_cell_on_every_smoke_config_is_ok(arch):
    cfg = get_smoke_config(arch)
    for name, shape in SHAPES.items():
        rep = dryrun.run_cell(arch, name, False, verbose=False, cfg=cfg,
                              shape=shape, mesh_shape=(2, 4))
        assert rep["status"] == "ok" and rep["mesh"] == "2x4", rep
        assert rep["flops_per_chip"] > 0 and rep["hbm_bytes_per_chip"] > 0
        assert 0 < rep["argument_gib_per_chip"] <= rep["peak_gib_per_chip"]
        assert rep["fits_hbm"]
        if name == "prefill":
            # the transformers and the hybrid under role 'tp' prefill
            # on blocks
            assert rep["partitioned"] == (
                cfg.family in ("dense", "vlm", "moe", "hybrid")
                and cfg.model_axis_role == "tp")
        if name == "decode":
            # the transformers and the hybrid under role 'tp' decode on
            # blocks
            assert rep["partitioned"] == (
                cfg.family in ("dense", "vlm", "moe", "hybrid")
                and cfg.model_axis_role == "tp")
        if name == "train":
            assert rep["partitioned"] == (
                cfg.family in ("dense", "vlm", "moe", "hybrid")
                and cfg.model_axis_role == "tp")
            assert rep["collective_counts"]["all-gather"] > 0
            # the norms' stand-ins ran in place of the kernels
            assert rep["kernel_calls"].get("rmsnorm", 0) > 0 or \
                cfg.norm != "rmsnorm"


def _block_bytes(sds, specs, sizes):
    total = 0
    flat = tree_util.leaves(sds)
    sp = tree_util.leaves(specs, is_leaf=is_spec)
    for x, s in zip(flat, sp):
        shape = dryrun._block_shape(x.shape, s, sizes)
        total += math.prod(shape) * x.element_size()
    return total


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "h2o-danube-1.8b"])
def test_argument_bytes_are_the_spec_blocks(arch):
    cfg = get_smoke_config(arch)
    shape = SHAPES["train"]
    with dryrun.fake_group(8):
        mesh = mesh_lib.make_mesh((2, 4), ("data", "model"))
        bundle = dryrun.build_step(cfg, mesh, shape)
        counts = dryrun.execute(bundle, mesh, shape)
        sizes = mesh_axis_sizes(mesh)
    want = sum(_block_bytes(x, s, sizes) for x, s in
               zip(bundle.input_sds[:-1], bundle.in_shardings[:-1]))
    assert counts["argument_bytes"] == want
    assert counts["peak_bytes"] > counts["argument_bytes"]


KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce", "broadcast": "broadcast",
         "all_to_all": "all-to-all"}


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    """``perfcount.MESH`` of four gloo ranks on (2, 2)
    (``torch_mesh_ranks.dryrun_count_ranks``)."""
    return mesh_lib.run_ranks(ranks.dryrun_count_ranks, 4,
                              str(tmp_path_factory.mktemp("counts")),
                              args=(ranks.SEQ, ranks.BATCH), timeout=120.0)


def test_collective_counts_equal_a_real_four_rank_run(real_counts):
    """qwen1.5-32b's smoke step (partitioned, adafactor) and
    h2o-danube's (gather-whole) on (2, 2): the dry run's counts per kind
    against a gloo run's ``perfcount.MESH``."""
    kinds = KINDS
    real = real_counts
    for arch in ("qwen1.5-32b", "h2o-danube-1.8b"):
        rep = dryrun.run_cell(arch, "train", False, verbose=False,
                              cfg=get_smoke_config(arch),
                              shape=ShapeSpec("train", ranks.SEQ,
                                              ranks.BATCH, "train"),
                              mesh_shape=(2, 2))
        for rank_counts in real:
            got = {kinds[k]: rank_counts[arch][k] for k in kinds
                   if rank_counts[arch][k]}
            assert got == rep["collective_counts"], arch


def test_hybrid_counts_equal_a_real_four_rank_run(real_counts):
    """Jamba's smoke step (partitioned: the Mamba on channel blocks,
    adafactor) on (2, 2): the dry run's collectives per kind and its
    ``ssm_scan`` stand-in calls against a gloo run's ``perfcount.MESH``
    and its calls of the registry's scan."""
    arch = ranks.HYBRID_ARCH
    rep = dryrun.run_cell(arch, "train", False, verbose=False,
                          cfg=get_smoke_config(arch),
                          shape=ShapeSpec("train", ranks.SEQ, ranks.BATCH,
                                          "train"),
                          mesh_shape=(2, 2))
    assert rep["partitioned"]
    assert rep["kernel_calls"]["ssm_scan"] > 0
    for rank_counts in real_counts:
        got = rank_counts[arch]
        assert {KINDS[k]: got[k] for k in KINDS if got[k]} == \
            rep["collective_counts"]
        assert got["ssm_scan"] == rep["kernel_calls"]["ssm_scan"]


def test_prefill_collective_counts_equal_a_real_four_rank_run(real_counts):
    """qwen1.5-32b's smoke prefill on (2, 2): partitioned in the dry run
    and in a gloo run, with the same collectives per kind (the
    broadcast of the last position among them)."""
    rep = dryrun.run_cell("qwen1.5-32b", "prefill", False, verbose=False,
                          cfg=get_smoke_config("qwen1.5-32b"),
                          shape=ShapeSpec("prefill", ranks.SEQ, ranks.BATCH,
                                          "prefill"),
                          mesh_shape=(2, 2))
    assert rep["partitioned"]
    assert rep["collective_counts"]["broadcast"] == 1
    for rank_counts in real_counts:
        got = rank_counts["prefill"]
        assert got["partitioned"]
        assert {KINDS[k]: got[k] for k in KINDS if got[k]} == \
            rep["collective_counts"]


@pytest.mark.parametrize("arch", ranks.DECODE_COUNT_ARCHS)
def test_decode_collective_counts_equal_a_real_four_rank_run(arch,
                                                             real_counts):
    """A smoke decode call on (2, 2), on blocks: the dry run's
    collectives per kind against a gloo run's (qwen1.5-32b: the batch
    replicated, the cache's sequence over ('data', 'model'); deepseek:
    the batch over 'data', the heads and K/V heads over 'model', the
    experts gathered whole), and its ``rmsnorm`` stand-in calls two a
    layer and the final norm's."""
    cfg = get_smoke_config(arch)
    rep = dryrun.run_cell(arch, "decode", False, verbose=False, cfg=cfg,
                          shape=ShapeSpec("decode", ranks.SEQ, ranks.BATCH,
                                          "decode"),
                          mesh_shape=(2, 2))
    assert rep["partitioned"]
    assert rep["kernel_calls"]["rmsnorm"] == (
        cfg.n_layers * (2 + 2 * cfg.qk_norm) + 1)
    assert rep["collective_counts"]["all-reduce"] > 0
    for rank_counts in real_counts:
        got = rank_counts[f"decode/{arch}"]
        assert got["partitioned"]
        assert {KINDS[k]: got[k] for k in KINDS if got[k]} == \
            rep["collective_counts"]


def test_hybrid_decode_collective_counts_equal_a_real_four_rank_run(
        real_counts):
    """Jamba's smoke decode call on (2, 2), on blocks (the rows over
    'data', the KV cache's sequence and the Mamba channels over 'model',
    ``w_in`` moved by an all-to-all, the experts gathered whole): the
    dry run's collectives per kind against a gloo run's, and its
    ``rmsnorm`` stand-in calls two a slot and the final norm's."""
    arch = ranks.HYBRID_ARCH
    cfg = get_smoke_config(arch)
    rep = dryrun.run_cell(arch, "decode", False, verbose=False, cfg=cfg,
                          shape=ShapeSpec("decode", ranks.SEQ, ranks.BATCH,
                                          "decode"),
                          mesh_shape=(2, 2))
    assert rep["partitioned"]
    assert rep["kernel_calls"] == {"rmsnorm": 2 * cfg.n_layers + 1}
    assert rep["collective_counts"]["all-to-all"] == (
        cfg.n_layers - cfg.n_layers // cfg.attn_period)
    for rank_counts in real_counts:
        got = rank_counts[f"decode/{arch}"]
        assert got["partitioned"]
        assert {KINDS[k]: got[k] for k in KINDS if got[k]} == \
            rep["collective_counts"]


def test_depth_fit_holds_for_a_hybrid_decode_trace():
    """The hybrid's decode counted at one and two period groups and
    fitted to three (``depth_fit``, ``_fit``) gives the direct trace's
    counts at three: every count of a decode call is affine in the
    groups."""
    cfg = get_smoke_config(ranks.HYBRID_ARCH)
    cfg = cfg.scaled(n_layers=3 * cfg.attn_period)
    shape = ShapeSpec("decode", ranks.SEQ, ranks.BATCH, "decode")
    cfg1, cfg2, d1, d2, units = dryrun.depth_fit(cfg)
    assert units == 3
    with dryrun.fake_group(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
        c1, _ = dryrun._cell_counts(cfg1, mesh, shape, {})
        c2, _ = dryrun._cell_counts(cfg2, mesh, shape, {})
        direct, partitioned = dryrun._cell_counts(cfg, mesh, shape, {})
    assert partitioned
    fit = dryrun._fit(c1, c2, d1, d2, units)
    for k in ("flops", "bytes", "argument_bytes", "peak_bytes"):
        assert fit[k] == pytest.approx(direct[k], rel=1e-9), k
    assert fit["kernels"] == direct["kernels"]
    got, want = fit["collectives"], direct["collectives"]
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind == want.bytes_by_kind


def test_dry_run_restores_the_process_state():
    before = (kreg.resolved, kreg._rn, kreg._rrn, kreg._fa, kreg._scan,
              kreg.scan_backward_body, ssm.slstm_loop,
              ssm.slstm_backward_body)
    MESH.reset()
    LAUNCHES.reset()
    MESH.all_gather = 7
    rep = dryrun.run_cell("qwen1.5-32b", "train", False, verbose=False,
                          cfg=get_smoke_config("qwen1.5-32b"),
                          shape=SHAPES["train"], mesh_shape=(2, 4))
    assert rep["status"] == "ok"
    assert not dist.is_initialized()
    assert (kreg.resolved, kreg._rn, kreg._rrn, kreg._fa, kreg._scan,
            kreg.scan_backward_body, ssm.slstm_loop,
            ssm.slstm_backward_body) == before
    assert mesh_lib.COLLECTIVE_LOG is None
    assert MESH.snapshot() == dict({k: 0 for k in MESH.snapshot()},
                                   all_gather=7)
    assert not any(LAUNCHES.snapshot().values())
    MESH.reset()
    # beside a group of the caller's it refuses to start
    mesh_lib.start_group(backend="gloo")
    try:
        with pytest.raises(RuntimeError, match="without a default"):
            dryrun.run_cell("qwen1.5-32b", "train", False, verbose=False,
                            cfg=get_smoke_config("qwen1.5-32b"),
                            shape=SHAPES["train"], mesh_shape=(1, 1))
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_partitioned_peak_is_below_the_gather_whole_peak():
    cfg = get_smoke_config("qwen1.5-32b").scaled(n_layers=4)
    reps = {part: dryrun.run_cell("qwen1.5-32b", "train", False,
                                  verbose=False, cfg=cfg,
                                  shape=SHAPES["train"], mesh_shape=(2, 4),
                                  partition=part)
            for part in (True, False)}
    assert reps[True]["partitioned"] and not reps[False]["partitioned"]
    assert reps[True]["peak_gib_per_chip"] < reps[False]["peak_gib_per_chip"]
    assert reps[True]["argument_gib_per_chip"] == \
        reps[False]["argument_gib_per_chip"]


def test_cli_reports_and_exits_zero(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    import json
    rep = json.loads(out.read_text())
    assert [r["status"] for r in rep] == ["ok"]
    keys = {"status", "fits_hbm", "flops_per_chip", "hbm_bytes_per_chip",
            "collective_bytes_per_chip", "t_compute", "t_memory",
            "t_collective", "dominant", "model_flops", "useful_flops_ratio",
            "roofline_fraction", "argument_gib_per_chip",
            "peak_gib_per_chip", "collective_counts"}
    assert keys <= set(rep[0])
    assert "1 ok, 0 skipped, 0 failed" in capsys.readouterr().out
    assert torch.get_default_dtype() == torch.float32
