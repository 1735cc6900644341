"""Import isolation: repro_torch and chip_smoke.py never import JAX, the
reference package or ``ml_dtypes``."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "repro", "ml_dtypes") or
             k.startswith(("jax.", "jaxlib.", "repro.", "ml_dtypes.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_every_repro_torch_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {"repro_torch.api.session", "repro_torch.ps.worker",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.fused_compress",
                "repro_torch.optim.compression", "repro_torch.ps.server",
                "repro_torch.device",
                "repro_torch.ps.sharded.server", "repro_torch.models.layers",
                "repro_torch.models.ssm", "repro_torch.models.moe",
                "repro_torch.models.hybrid", "repro_torch.kernels.ssm_scan",
                "repro_torch.configs.jamba_v01_52b",
                "repro_torch.wireformat", "repro_torch.ft.backoff",
                "repro_torch.transport", "repro_torch.transport.base",
                "repro_torch.transport.inproc", "repro_torch.transport.tcp",
                "repro_torch.transport.shmem",
                "repro_torch.transport.endpoint",
                "repro_torch.launch.proc_pool", "repro_torch.ps.simulator",
                "repro_torch.ps.sharded.simulator",
                "repro_torch.api.__main__",
                "repro_torch.obs", "repro_torch.obs.collect",
                "repro_torch.obs.export", "repro_torch.obs.summarize",
                "repro_torch.obs.__main__", "repro_torch.checkpoint",
                "repro_torch.checkpoint.manager", "repro_torch.ft",
                "repro_torch.ft.snapshot", "repro_torch.ft.faults",
                "repro_torch.ft.server_proc", "repro_torch.ft.reshard"}
    assert expected <= set(res["modules"])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _is_reference(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    names = list(_imports(ROOT / "chip_smoke.py"))
    assert "repro_torch.api" in names or "repro_torch" in names
    assert not [n for n in names if _is_reference(n)]


def test_no_repro_torch_source_names_jax_or_repro_in_an_import():
    offenders = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        offenders += [(path.name, n) for n in _imports(path)
                      if _is_reference(n)]
    assert offenders == []
