"""Shared test configuration.

Collection guard: some test modules are property-based and import
``hypothesis`` at module scope.  On environments without hypothesis
(e.g. a bare container before ``pip install -r requirements-dev.txt``)
importing those modules aborts pytest during *collection*, before a
single test runs.  Detect the situation up front and skip exactly the
modules that need hypothesis, with an explicit reason in the header.
"""

from __future__ import annotations

import importlib.util
import pathlib

_HERE = pathlib.Path(__file__).parent

HAVE_HYPOTHESIS = importlib.util.find_spec("hypothesis") is not None


def _needs_hypothesis(path: pathlib.Path) -> bool:
    try:
        src = path.read_text()
    except OSError:
        return False
    return ("import hypothesis" in src) or ("from hypothesis" in src)


_SKIPPED = ([] if HAVE_HYPOTHESIS else
            sorted(p.name for p in _HERE.glob("test_*.py")
                   if _needs_hypothesis(p)))

# pytest reads this to drop the modules from collection entirely.
collect_ignore = list(_SKIPPED)


def pytest_report_header(config):
    if _SKIPPED:
        return ("hypothesis not installed — skipping property-based "
                f"modules: {', '.join(_SKIPPED)} "
                "(pip install -r requirements-dev.txt to run them)")
    return None


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's Hopper kernels); "
        "skipped where torch.cuda.is_available() is false")
