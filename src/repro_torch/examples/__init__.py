"""The reference's four examples, on the port.

    python -m repro_torch.examples.quickstart [--smoke] [--device cpu]
    python -m repro_torch.examples.heterogeneous_ps [--ps-shards N]
    python -m repro_torch.examples.train_lm --preset tiny [--resume]
    python -m repro_torch.examples.serve_decode

Each keeps its reference's flags and asserts and adds ``--device``
(default ``cuda:0``; without CUDA the run raises unless it names
another device, e.g. ``cpu``).  Nothing runs at import time.
"""
