"""The port's four examples (``repro_torch.examples``) run to their end on
the CPU at their smoke sizes, each as its own process
(``python -m repro_torch.examples.<name> --device cpu``) under a
timeout, with the reference examples' asserts (``serve_decode``'s sit
in the example itself: no staleness-bound violation, every request
served, served versions advancing); and so does the train-and-serve CLI
(``python -m repro_torch.launch.serve``)."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def _run(name: str, *args: str, package: str = "examples") -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.{package}.{name}", *args,
         "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_quickstart_smoke():
    out = _run("quickstart", "--smoke")
    assert "dssp(s_L=3,s_U=15" in out
    losses = re.findall(r"sync=(\w+)\s+loss ([\d.]+) -> ([\d.]+)", out)
    assert [s for s, _, _ in losses] == ["bsp", "dssp"]
    for _, first, last in losses:
        assert float(last) < float(first)
    assert out.rstrip().endswith("on a pod the delay hides the gradient "
                                 "all-reduce.")


@pytest.mark.parametrize("shards", ["1", "2"])
def test_heterogeneous_ps_smoke(shards):
    out = _run("heterogeneous_ps", "--smoke", "--ps-shards", shards,
               "--ps-apply", "fused" if shards != "1" else "tree")
    for policy in ("bsp", "asp", "ssp(s=3)", "dssp(s_L=3,s_U=15,last)"):
        assert re.search(re.escape(policy) + r".*  acc=0\.\d+", out), policy
    assert ("Per-shard view" in out) == (shards != "1")
    assert out.rstrip().endswith("unlike ASP.")


def test_train_lm_tiny_then_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _run("train_lm", "--preset", "tiny", "--steps", "10",
               "--checkpoint-dir", ckpt)
    assert "done: loss" in out and "rerun with --resume" in out
    out = _run("train_lm", "--preset", "tiny", "--steps", "10",
               "--checkpoint-dir", ckpt, "--resume")
    assert "resumed from step 10" in out
    assert re.search(r"step\s+10 loss", out)
    assert "rerun with --resume" in out


def test_serve_decode():
    out = _run("serve_decode")
    assert out.rstrip().endswith(
        "OK: train-and-serve over one live parameter server works.")


def test_serve_cli():
    out = _run("serve", "--steps", "8", "--replicas", "1", "--requests",
               "3", "--request-every-ms", "20", package="launch")
    assert "train: pushes=" in out
    assert re.search(r'"requests": 3,', out)
    assert re.search(r'"violations": 0', out)
