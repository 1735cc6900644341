"""The port's device rule, shared by every public entry point.

The port runs on the card: an entry point that is not told otherwise
uses ``cuda:0`` and raises when there is no CUDA device, rather than
carrying on on the CPU.  Callers that want the CPU (the tests) say so
with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda:0``; raises when neither is
    available rather than falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card (cuda:0) and found no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)
