"""The host exchange of ``repro_torch.launch.mesh``: the collectives of
a gloo group (its ranks on one host: CPU ranks, or several ranks on one
card) pass through a shared-memory segment instead of gloo's transport.

Four gloo ranks (``torch_mesh_ranks.host_exchange_ranks``) run every
collective (all-gather and reduce-scatter along each dimension, the
all-to-all of ``models.partition``'s ``w_in`` routes, all-reduce by
sum, max and min, broadcast) on the groups of a (2, 2) and a (1, 4)
mesh: each result equals, bit for bit, the one each rank makes from
every rank's input (the tensors hold small integers, so every sum is
exact in any order).
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro_torch.launch import mesh as mesh_lib


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mesh_lib.run_ranks(ranks.host_exchange_ranks, 4,
                              str(tmp_path_factory.mktemp("exchange")),
                              timeout=120.0)


@pytest.mark.parametrize("case", ["2x2/data", "2x2/model", "1x4/model"])
def test_host_exchange_collectives(case, results):
    for rank, out in enumerate(results):
        for k, (got, want) in out[case].items():
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"rank {rank} {k}")
