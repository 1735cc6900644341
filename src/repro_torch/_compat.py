"""Legacy-construction bookkeeping for the ``repro_torch.api`` builder.

Counterpart of ``repro/_compat.py``.  The declarative session layer
(``repro_torch.api.build_session``) is the supported way to wire
servers, workers and transports together.  The direct constructors
(``ParameterServer``, ``ShardedParameterServer``, ``PSWorker``) keep
working, but emit one ``DeprecationWarning`` per class and process
naming the replacement, unless the construction happens inside the
builder itself, the one place allowed to call them without ceremony.

Standard library only: ``repro_torch.ps`` imports it at module scope,
and it must never create an import cycle with ``repro_torch.api``.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

_local = threading.local()
_warned: set = set()


@contextlib.contextmanager
def api_managed():
    """Mark the current thread as inside the ``repro_torch.api``
    builder: legacy-constructor warnings are suppressed within the
    block."""
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    try:
        yield
    finally:
        _local.depth = depth


def in_api_build() -> bool:
    return getattr(_local, "depth", 0) > 0


def warn_legacy(name: str, replacement: str) -> None:
    """One ``DeprecationWarning`` per process for ``name``; nothing
    while the builder constructs on this thread (the builder is the
    replacement and stays warning-free)."""
    if in_api_build() or name in _warned:
        return
    _warned.add(name)
    warnings.warn(
        f"constructing {name} directly is deprecated; build the run "
        f"declaratively via {replacement}",
        DeprecationWarning, stacklevel=3)


def reset_legacy_warnings() -> None:
    """Forget which classes already warned (a test hook)."""
    _warned.clear()
