"""The port's discrete-event simulators and spec CLI against the
reference's.

``repro_torch.ps.simulator`` and ``repro_torch.ps.sharded.simulator``
run the same event order over the port's gates, so under each of
bsp/asp/ssp/dssp they give the reference's decision stream (every
``on_push`` decision and ``may_release`` answer, in order, and DSSP's
traced decisions) and a ``RunMetrics`` equal field for field; at S=1
the sharded simulator equals the monolithic one; ``hot_shard_service``
skews the same shard.  ``python -m repro_torch.api --dump-schema``
prints the shared schema.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest

from repro.core import policies as jpolicies
from repro.obs.trace import TRACE as JTRACE
from repro.ps import simulator as jsim
from repro.ps.sharded import simulator as jssim
from repro_torch.api import __main__ as cli
from repro_torch.core import policies
from repro_torch.obs.trace import TRACE
from repro_torch.ps import simulator as sim
from repro_torch.ps.sharded import simulator as ssim

#: examples/quickstart.py's virtual cluster: 4 workers, one 3x straggler
QUICKSTART = [1.0, 1.1, 1.2, 3.0]
POLICIES = [("bsp", {}), ("asp", {}), ("ssp", dict(staleness=3)),
            ("dssp", dict(s_lower=3, s_upper=15))]
IDS = [name for name, _ in POLICIES]


class Recorded:
    """A policy whose every decision is appended to ``log``."""

    def __init__(self, policy, log):
        self._p, self.log = policy, log
        self.name = policy.name

    def on_push(self, tracker, worker, t):
        d = self._p.on_push(tracker, worker, t)
        self.log.append(("push", worker, t, d.apply_update, d.release_now,
                         d.credit_used))
        return d

    def may_release(self, tracker, worker):
        ok = self._p.may_release(tracker, worker)
        self.log.append(("release?", worker, ok))
        return ok


def _metrics(m) -> dict:
    return dataclasses.asdict(m)


def _decisions(events) -> list:
    return [(e["worker"], e["clock"], e["args"]) for e in events
            if e["name"] == "dssp_decision"]


def _both(name, kw, run):
    """``run(policy_module, simulator_module, wrap)`` in both packages,
    traced; returns ((metrics, log, decisions) reference, port)."""
    out = []
    for pol, mod, tracer in ((jpolicies, jsim, JTRACE),
                             (policies, sim, TRACE)):
        log = []
        tracer.enable(source="sim")
        try:
            m = run(pol, mod, lambda p: Recorded(p, log))
            events = tracer.drain()
        finally:
            tracer.disable()
        out.append((_metrics(m), log, _decisions(events)))
    return out


@pytest.mark.parametrize("name,kw", POLICIES, ids=IDS)
def test_run_policy_matches_reference(name, kw):
    def run(pol, mod, wrap):
        return mod.run_policy(wrap(pol.make_policy(name, n_workers=4, **kw)),
                              QUICKSTART, max_pushes=2000)

    ref, port = _both(name, kw, run)
    assert port[1] == ref[1]          # every decision, in order
    assert port[2] == ref[2]          # DSSP's traced decisions
    assert port[0] == ref[0]          # RunMetrics, field for field
    assert port[0]["total_pushes"] == 2000
    if name == "dssp":
        assert port[2], "DSSP traced no decisions"


@pytest.mark.parametrize("name,kw", POLICIES, ids=IDS)
def test_jittered_and_phase_shifted_intervals_match_reference(name, kw):
    def run(pol, mod, wrap):
        jit = mod.PSSimulator(wrap(pol.make_policy(name, n_workers=4, **kw)),
                              4, mod.jittered_intervals(QUICKSTART, 0.3,
                                                        seed=7))
        a = jit.run(max_pushes=600)
        shift = mod.PSSimulator(
            wrap(pol.make_policy(name, n_workers=4, **kw)), 4,
            mod.phase_shift_intervals(QUICKSTART, slow_after=50,
                                      factor=4.0, worker=1))
        b = shift.run(max_time=300.0)
        return _Pair(a, b)

    ref, port = _both(name, kw, run)
    assert port == ref


@dataclasses.dataclass
class _Pair:
    """Two runs' metrics as one dataclass (``asdict`` recurses)."""

    a: object
    b: object


def test_interval_functions_match_reference():
    for k in range(50):
        for w in range(4):
            assert sim.jittered_intervals(QUICKSTART, 0.25, 3)(w, k) == \
                jsim.jittered_intervals(QUICKSTART, 0.25, 3)(w, k)
            assert sim.phase_shift_intervals(QUICKSTART, 10, 2.5, 2)(w, k) \
                == jsim.phase_shift_intervals(QUICKSTART, 10, 2.5, 2)(w, k)
            assert sim.constant_intervals(QUICKSTART)(w, k) == QUICKSTART[w]
    with pytest.raises(ValueError, match="stopping condition"):
        sim.PSSimulator(policies.make_policy("asp"), 2,
                        sim.constant_intervals([1.0, 1.0])).run()


@pytest.mark.parametrize("name,kw", POLICIES, ids=IDS)
def test_sharded_s1_equals_monolithic(name, kw):
    """As ``tests/test_sharded_ps.py`` checks for the reference."""
    intervals = [1.0, 1.0, 1.0, 4.0]
    mono = sim.run_policy(policies.make_policy(name, n_workers=4, **kw),
                          intervals, max_pushes=1500)
    s1 = ssim.run_sharded_policy(
        policies.make_policy_factory(name, n_workers=4, **kw), intervals, 1,
        max_pushes=1500).metrics
    a, b = mono.summary(), s1.summary()
    for key in ("pushes", "applied", "total_wait", "mean_staleness",
                "max_staleness", "time", "throughput"):
        assert a[key] == b[key], (key, a[key], b[key])


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("name,kw", POLICIES, ids=IDS)
def test_sharded_simulator_matches_reference(name, kw, n_shards):
    """Aggregate and per-shard metrics of ``run_sharded_policy`` with a
    hot shard equal the reference's."""
    def run(pol, mod, service):
        s = mod.run_sharded_policy(
            pol.make_policy_factory(name, n_workers=4, **kw), QUICKSTART,
            n_shards, max_pushes=800,
            shard_service_fn=service(n_shards - 1, 0.5, 0.05))
        return ([_metrics(s.metrics)] + [_metrics(m)
                                         for m in s.shard_metrics()],
                s.max_staleness_per_shard())

    assert run(policies, ssim, ssim.hot_shard_service) == \
        run(jpolicies, jssim, jssim.hot_shard_service)


def test_hot_shard_service_matches_reference():
    for args in ((0, 2.0), (3, 0.5, 0.1)):
        fn, jfn = ssim.hot_shard_service(*args), jssim.hot_shard_service(*args)
        for shard in range(5):
            for worker in range(3):
                assert fn(shard, worker) == jfn(shard, worker)
    with pytest.raises(ValueError, match="n_shards"):
        ssim.ShardedPSSimulator(policies.make_policy_factory("asp"), 2, 0,
                                sim.constant_intervals([1.0, 1.0]))


# ----------------------------------------------------------------- CLI
def test_cli_dump_schema_is_the_shared_schema(capsys):
    assert cli.main(["--dump-schema"]) == 0
    printed = json.loads(capsys.readouterr().out)
    shared = pathlib.Path(cli.__file__).with_name("schema.json")
    reference = pathlib.Path(jsim.__file__).parents[1] / "api" / \
        "schema.json"
    assert printed == json.loads(shared.read_text())
    assert printed == json.loads(reference.read_text())


def test_cli_example_validates_and_validate_refuses_with_item(capsys,
                                                              tmp_path):
    assert cli.main(["--example"]) == 0
    text = capsys.readouterr().out
    good = tmp_path / "main.json"
    good.write_text(text)
    assert cli.main(["--validate", str(good)]) == 0
    assert "engine=ps-threads" in capsys.readouterr().out
    d = json.loads(text)
    d["model"]["arch"] = "xlstm-125m"
    bad = tmp_path / "xlstm.json"
    bad.write_text(json.dumps(d))
    assert cli.main(["--validate", str(bad)]) == 1
    assert "item 10" in capsys.readouterr().err
    assert cli.main(["--validate", str(tmp_path / "missing.json")]) == 1
