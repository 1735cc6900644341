"""repro_torch's main path end to end on the CPU, through ``build_session``.

(a) one worker, BSP, 4 shards, a fixed seed: the port's loss equals the
    reference session's step by step within 1e-4;
(b) 4 workers, DSSP, a 3x straggler: no worker is released past
    s_upper, the DSSP extensions equal ``credit_releases``, the loss
    falls;
and the device rule: without ``device=`` and without CUDA,
``build_session`` raises.
"""

from __future__ import annotations

import json
import math
import pathlib

import jax
import pytest
import torch

import repro.api as japi
from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jregistry
from repro_torch import api
from repro_torch.ft.faults import FaultPlan
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs.trace import TRACE
from repro_torch.perfcount import WIRE

torch.set_num_threads(2)


def _spec(mod, *, workers, sync, straggler=1.0, steps_lr=3e-3):
    return mod.RunSpec(
        model=mod.ModelSpec(arch="h2o-danube-1.8b", smoke=True),
        data=mod.DataSpec(seq_len=32, global_batch=4, seed=3),
        optimizer=mod.OptimizerSpec(lr=steps_lr, momentum=0.9),
        sync=mod.SyncSpec(mode=sync, s_lower=1, s_upper=4),
        ps=mod.ServerSpec(kind="sharded", shards=4, workers=workers,
                          apply="fused", straggler=straggler),
        wire=mod.WireSpec(format="packed", delta_pull=True))


def _losses(session):
    return [loss for _, _, loss in session.server.metrics.loss_trajectory]


def test_one_worker_bsp_loss_matches_reference_step_by_step():
    steps = 4
    jspec = _spec(japi, workers=1, sync="bsp", steps_lr=5e-2)
    with japi.build_session(jspec) as s:
        s.run(steps)
        jlosses = _losses(s)
    params = jregistry.init_params(jax_smoke("h2o-danube-1.8b"),
                                   jax.random.PRNGKey(0))
    tspec = _spec(api, workers=1, sync="bsp", steps_lr=5e-2)
    WIRE.reset()   # process-global: earlier tests in this process count too
    with api.build_session(tspec, device="cpu",
                           params=from_numpy_tree(params, "cpu")) as s:
        m = s.run(steps)
        tlosses = _losses(s)
    assert len(tlosses) == len(jlosses) == steps
    assert jlosses[-1] < jlosses[0]          # the steps really moved
    for a, b in zip(tlosses, jlosses):
        assert abs(a - b) <= 1e-4, (tlosses, jlosses)
    assert m["pushes"] == steps and m["applied_updates"] == 4 * steps
    assert m["perfcount"]["wire"]["leaf_concats"] == 0


def test_four_workers_dssp_straggler_bounded_and_learning():
    spec = _spec(api, workers=4, sync="dssp", straggler=3.0, steps_lr=5e-2)
    TRACE.enable(source="server")
    try:
        with api.build_session(spec, device="cpu") as s:
            m = s.run(48)
            losses = _losses(s)
        events = TRACE.drain()
    finally:
        TRACE.disable()
    assert m["pushes"] == 48
    assert all(math.isfinite(x) for x in losses)
    # No worker is RELEASED with a gap beyond s_upper; the push that
    # arrives one past it is applied and blocked, so the recorded
    # arrival staleness may reach s_upper + 1 (the reference's bound,
    # tests/test_ps_training.py and tests/test_sharded_ps.py).
    decisions = [e for e in events if e["name"] == "dssp_decision"]
    assert decisions
    assert all(e["args"]["gap"] <= spec.sync.s_upper for e in decisions
               if e["args"]["reason"] != "block")
    assert m["max_staleness"] <= spec.sync.s_upper + 1
    ext = {(e["worker"], e["clock"]) for e in decisions
           if e["args"]["reason"] in ("grant", "credit_spend")}
    assert len(ext) == m["credit_releases"]
    k = 8
    assert sum(losses[-k:]) / k < sum(losses[:k]) / k, losses
    # every later pull was a delta of the advanced shards only
    assert m["perfcount"]["wire"]["full_pull_bytes_avoided"] >= 0


def test_build_session_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the session would run")
    spec = _spec(api, workers=1, sync="bsp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_session(spec)


def test_spec_json_round_trips_and_schema_is_the_reference_schema():
    spec = _spec(api, workers=2, sync="dssp")
    assert api.RunSpec.from_json(spec.to_json()) == spec
    # one JSON drives both packages
    assert japi.RunSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    assert api.dump_schema() == japi.dump_schema()
    copy = pathlib.Path(api.__file__).parent / "schema.json"
    assert json.loads(copy.read_text()) == json.loads(json.dumps(
        api.dump_schema()))


@pytest.mark.parametrize("section,field,value,item", [
    ("ps", "kind", "none", "item 11"),
    ("serve", "replicas", 1, "item 9"),
    ("model", "arch", "xlstm-125m", "item 10"),
])
def test_later_slices_raise_spec_errors_naming_their_item(section, field,
                                                         value, item):
    d = _spec(api, workers=2, sync="dssp").to_dict()
    d[section][field] = value
    if (section, field) == ("ps", "kind"):
        d["ps"].update(shards=0, apply="tree")
        d["wire"].update(format="tree", delta_pull=False)
    japi.RunSpec.from_dict(d)              # valid for the reference ...
    with pytest.raises(api.SpecError, match=item):
        api.RunSpec.from_dict(d)           # ... refused, with its item


def _item8_spec(section, field, value, tmp_path) -> dict:
    d = _spec(api, workers=2, sync="dssp").to_dict()
    d[section][field] = value
    if (section, field) == ("ft", "snapshot_every_s"):
        d["ft"]["dir"] = str(tmp_path / "ckpt")
    if section == "ft" and field != "snapshot_every_s":
        d["transport"]["kind"] = "tcp"
    if (section, field) == ("ft", "reshard_shards"):
        d["ft"]["reshard_round"] = 4
    if (section, field) == ("ft", "fault_kill_worker"):
        d["ft"]["fault_kill_worker_round"] = 2
    return d


@pytest.mark.parametrize("section,field,value", [
    ("ft", "reshard_shards", 6),
    ("ft", "fault_kill_worker", 1),
    ("ft", "snapshot_every_s", 1.0),
    ("obs", "trace", True),
    ("ft", "reconnect_tries", 2),
])
def test_item8_specs_are_accepted_and_arm_their_rig(section, field, value,
                                                    tmp_path):
    """The item-8 fields the port refused until its observability and
    fault-tolerance slice: each spec is now accepted as the reference
    accepts it, and the session it builds arms the matching piece."""
    from repro_torch.launch.proc_pool import WorkerTask
    d = _item8_spec(section, field, value, tmp_path)
    jspec = japi.RunSpec.from_dict(d)
    spec = api.RunSpec.from_dict(d)
    assert spec.to_json() == jspec.to_json()
    task = WorkerTask.from_spec(spec, 2, device="cpu")
    external = spec.transport.kind != "inproc"
    with api.build_session(spec, device="cpu",
                           **({"external_workers": True} if external
                              else {})) as s:
        if field == "reshard_shards":
            assert s.reshard(6) is True and s.server.n_shards == 6
            assert s.server.reshard_epoch == 1
        elif field == "fault_kill_worker":
            assert task.fault_plan == jspec.ft.fault_plan().to_dict()
            assert FaultPlan.from_dict(task.fault_plan).worker_kill_due(1, 2)
        elif field == "snapshot_every_s":
            assert s.ft_rig is not None and s.ft_rig.snapshotter is not None
            s.run(2)
        elif field == "trace":
            assert s.obs_rig is not None and task.trace
            s.run(2)
        else:
            assert task.reconnect_tries == 2
    if field == "snapshot_every_s":
        assert s.metrics()["ft"]["latest_step"] == s.server.version > 0
    if field == "trace":
        names = {e["name"] for e in s.obs_rig.events}
        assert {"push", "compute_step"} <= names
        assert s.metrics()["obs"]["events"] == len(s.obs_rig.events)


def _lifted(case: str) -> dict:
    """The main-path spec, moved onto one of the paths this slice ports."""
    d = _spec(api, workers=2, sync="bsp", steps_lr=5e-2).to_dict()
    ps, wire = d["ps"], d["wire"]
    if case.startswith("compression-"):
        wire["compression"] = case.split("-")[1]
    elif case == "coalesce":
        ps.update(coalesce=2, coalesce_wait_ms=5000.0)
    elif case == "mono-packed":
        ps.update(kind="mono", shards=1, apply="packed", coalesce=2,
                  coalesce_wait_ms=5000.0)
    elif case == "mono-tree":
        ps.update(kind="mono", shards=1, apply="tree")
        wire.update(format="tree", delta_pull=False)
    elif case == "global-gating":
        ps["gating"] = "global"
    elif case == "tree-wire":
        ps["gating"] = "global"
        wire.update(format="tree", delta_pull=False)
    elif case == "tree-apply-int8":
        ps["apply"] = "tree"
        wire.update(format="tree", delta_pull=False, compression="int8")
    return d


@pytest.mark.parametrize("case", [
    "compression-int8", "compression-topk", "coalesce", "mono-packed",
    "mono-tree", "global-gating", "tree-wire", "tree-apply-int8"])
def test_paths_this_slice_ports_build_and_train(case):
    """What the port refused before this slice — wire compression,
    coalescing, the mono server, the global gate and the tree wire —
    now builds and trains through ``build_session`` on the CPU."""
    d = _lifted(case)
    japi.RunSpec.from_dict(d)                # valid for the reference
    spec = api.RunSpec.from_dict(d)          # and no longer refused
    with api.build_session(spec, device="cpu", timeout=300.0) as s:
        m = s.run(4)
        losses = _losses(s)
    assert m["pushes"] == 4
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert m["max_staleness"] <= 1            # BSP
    n_shards = 1 if spec.ps.kind == "mono" else spec.ps.shards
    assert m["applied_updates"] == 4 * n_shards
