"""The port's roofline terms (``repro_torch.roofline``) against the
reference's ``repro.roofline.analysis``.

* Ring bytes: every collective a dry-run step records (kind, result
  bytes, group size) costs the wire bytes that the reference's
  ``parse_collectives`` gives one HLO line of the same kind, shape,
  dtype and group size.  The reference's promoted-reduction case (an
  XLA:CPU bf16 all-reduce promoted to f32, counted at half) is left out:
  the port never promotes, so its lines carry no ``_promoted`` reducer.
* ``model_flops`` equals the reference's for every arch × applicable
  shape.
* ``RooflineTerms``' properties equal the reference's on the inputs of
  ``tests/test_roofline.py::test_roofline_terms_dominant_and_fraction``,
  with the H100's constants in place of the v5e's on both sides.
"""

from __future__ import annotations

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as JR
from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis as R

HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int64: "s64", torch.int32: "s32"}
HLO_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}


def _hlo_line(kind, n, dtype, shape):
    dims = ",".join(str(d) for d in shape)
    layout = ",".join(str(i) for i in reversed(range(len(shape))))
    return (f"  %c = {HLO_DTYPES[dtype]}[{dims}]{{{layout}}} "
            f"{HLO_KINDS[kind]}(%x), replica_groups=[{8 // n},{n}]<=[8]")


@pytest.fixture(scope="module")
def records():
    """The collectives of one partitioned smoke step (qwen1.5-32b, f32
    and bf16, SP and TP) and one gather-whole step (h2o-danube), rank 0
    of a fake (2, 4) mesh."""
    out = []
    for arch, dtype, sp in (("qwen1.5-32b", "float32", True),
                            ("qwen1.5-32b", "bfloat16", False),
                            ("h2o-danube-1.8b", "bfloat16", True)):
        cfg = get_smoke_config(arch).scaled(dtype=dtype,
                                            sequence_parallel=sp)
        shape = ShapeSpec("smoke", 32, 8, "train")
        with dryrun.fake_group(8):
            from repro_torch.launch import mesh as mesh_lib
            mesh = mesh_lib.make_mesh((2, 4), ("data", "model"))
            bundle = dryrun.build_step(cfg, mesh, shape)
            out.extend(dryrun.execute(bundle, mesh, shape)["collectives"])
    return out


def test_ring_bytes_of_every_recorded_collective_match_the_reference(
        records):
    kinds = {r[0] for r in records}
    assert {"all_reduce", "all_gather", "reduce_scatter"} <= kinds
    assert any(r[4] == torch.bfloat16 for r in records)
    for kind, nbytes, n, local, dtype, shape in records:
        assert nbytes == R.shape_bytes(shape, dtype)
        ours = R.parse_collectives([(kind, nbytes, n, local)])
        theirs = JR.parse_collectives(_hlo_line(kind, n, dtype, shape))
        k = HLO_KINDS[kind]
        assert ours.bytes_by_kind == {k: theirs.bytes_by_kind[k]}, (
            kind, shape, n)
        assert ours.result_bytes_by_kind[k] == theirs.result_bytes_by_kind[k]
        assert ours.count_by_kind[k] == theirs.count_by_kind[k] == 1


def test_collective_seconds_follow_the_link_of_the_group():
    """A group inside one node of 8 rides NVLink, one across nodes the
    NIC: the same bytes cost 9x longer across nodes."""
    inside = R.parse_collectives([("all_gather", 1 << 20, 8, True)])
    across = R.parse_collectives([("all_gather", 1 << 20, 8, False)])
    assert inside.total_bytes == across.total_bytes
    assert across.seconds == pytest.approx(inside.seconds * R.NVLINK_BW
                                           / R.NIC_BW)


@pytest.mark.parametrize("arch", arch_names())
def test_model_flops_match_the_reference(arch):
    for name, shape in SHAPES.items():
        if not cell_applicable(arch, name):
            continue
        assert R.model_flops(get_config(arch), shape) == \
            JR.model_flops(jget_config(arch), JSHAPES[name])


@pytest.mark.parametrize("mesh,n", [("16x16", 256), ("2x16x16", 512)])
def test_roofline_terms_properties_match_the_reference(mesh, n,
                                                       monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    kw = dict(arch="a", shape="train_4k", mesh=mesh,
              flops=1e12, hbm_bytes=1e11, collective_bytes=1e9,
              t_compute=1e12 / R.PEAK_FLOPS, t_memory=1e11 / R.HBM_BW,
              t_collective=1e9 / R.ICI_BW,
              model_flops=6e14, per_device_argument_bytes=1e9,
              peak_memory_bytes=2e9, collective_counts={})
    ours, theirs = R.RooflineTerms(**kw, n_chips=n), JR.RooflineTerms(**kw)
    for prop in ("dominant", "bounded_time", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert ours.dominant == "memory"
    assert 0 < ours.roofline_fraction < 1


def test_shape_bytes_affine_fit_and_constants():
    assert R.shape_bytes((16, 256, 512), torch.bfloat16) == 16 * 256 * 512 * 2
    assert R.shape_bytes((), torch.float32) == 4
    assert R.shape_bytes((10,), torch.int8) == 10
    assert R.affine_fit(17.0, 24.0, 1, 2, 24) == pytest.approx(10 + 7 * 24)
    assert R.affine_fit(17.0, 24.0, 1, 2, 24) == JR.affine_fit(17.0, 24.0,
                                                               1, 2, 24)
    assert (R.PEAK_FLOPS, R.HBM_BW, R.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert R.ICI_BW == R.NIC_BW < R.NVLINK_BW
    assert "peakGiB" in R.HEADER and len(R.HEADER.split()) == 14
