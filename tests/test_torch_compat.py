"""The port's legacy-construction warnings (``repro_torch._compat``): the
counterpart of ``tests/test_api.py::
test_legacy_construction_warns_once_and_behaves_identically``.

A direct ``ParameterServer``, ``ShardedParameterServer`` or ``PSWorker``
warns once per class and process, naming
``repro_torch.api.build_session``; the builder's own constructions warn
never; a directly built server applies a push exactly as the builder's
does; ``reset_legacy_warnings`` forgets.
"""

from __future__ import annotations

import warnings

import pytest
import torch

from repro_torch import _compat
from repro_torch.api import (ModelSpec, OptimizerSpec, RunSpec, ServerSpec,
                             SyncSpec, build_server, build_session)
from repro_torch.core.policies import make_policy
from repro_torch.ps.server import ParameterServer, ServerOptimizer
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.ps.worker import PSWorker

PARAMS = {"w": torch.zeros((6, 3))}
GRADS = {"w": torch.ones((6, 3))}


def _deprecations(caught):
    return [w for w in caught if issubclass(w.category, DeprecationWarning)]


def _mono():
    return ParameterServer(
        {"w": PARAMS["w"].clone()}, make_policy("asp"),
        ServerOptimizer(lr=0.1), 1)


def _sharded():
    return ShardedParameterServer(
        {"w": PARAMS["w"].clone()}, lambda: make_policy("asp"),
        lambda: ServerOptimizer(lr=0.1), 1, 1)


def _worker():
    return PSWorker(0, _mono_quiet(), lambda p, b: (p, {}), iter(()), 0)


def _mono_quiet():
    with _compat.api_managed():
        return _mono()


@pytest.mark.parametrize("name,make", [("ParameterServer", _mono),
                                       ("ShardedParameterServer", _sharded),
                                       ("PSWorker", _worker)])
def test_direct_construction_warns_once_per_class(name, make):
    _compat.reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = make()
    dep = _deprecations(caught)
    assert len(dep) == 1
    msg = str(dep[0].message)
    assert name in msg and "repro_torch.api.build_session" in msg
    # the warning points at the caller's line, not at the constructor
    assert dep[0].filename == __file__
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        second = make()
    assert not _deprecations(caught)
    # reset_legacy_warnings forgets: the next construction warns again
    _compat.reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        third = make()
    assert len(_deprecations(caught)) == 1
    for server in (first, second, third):
        stop = getattr(server, "stop", None)
        if stop is not None and not isinstance(server, PSWorker):
            stop()


def test_api_managed_nests_and_is_per_thread():
    assert not _compat.in_api_build()
    with _compat.api_managed():
        with _compat.api_managed():
            assert _compat.in_api_build()
        assert _compat.in_api_build()
        seen = []
        import threading
        t = threading.Thread(target=lambda: seen.append(
            _compat.in_api_build()))
        t.start()
        t.join()
        assert seen == [False]
    assert not _compat.in_api_build()


def test_builder_never_warns_and_applies_identically():
    spec = RunSpec(model=ModelSpec(arch="custom"),
                   optimizer=OptimizerSpec(lr=0.1),
                   sync=SyncSpec(mode="asp"),
                   ps=ServerSpec(kind="mono", shards=1, workers=1))
    _compat.reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        built = build_server(spec, params={"w": PARAMS["w"].clone()},
                             device="cpu")
    assert not _deprecations(caught)
    _compat.reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = _mono()
    assert len(_deprecations(caught)) == 1
    legacy.push(0, {"w": GRADS["w"].clone()})
    built.push(0, {"w": GRADS["w"].clone()})
    assert torch.equal(legacy.params["w"], built.params["w"])
    assert not torch.equal(built.params["w"], PARAMS["w"])
    legacy.stop()
    built.stop()


def test_a_threaded_session_runs_warning_free():
    """The ``ps-threads`` engine constructs its server and its
    ``PSWorker`` threads inside the builder: a whole run warns never."""
    spec = RunSpec.from_dict({
        "model": {"arch": "h2o-danube-1.8b", "smoke": True},
        "data": {"seq_len": 16, "global_batch": 2},
        "ps": {"kind": "sharded", "shards": 2, "workers": 2},
        "sync": {"mode": "ssp", "s_lower": 1, "s_upper": 2}})
    _compat.reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with build_session(spec, device="cpu") as session:
            m = session.run(4)
    assert not _deprecations(caught)
    assert m["final_loss"] > 0
