"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

A package of its own beside the JAX reference: it mirrors ``repro``'s
module paths, imports ``torch`` and never ``jax`` or ``repro``.  It runs
the paper's DSSP training of the dense h2o-danube-1.8b and the Jamba
hybrid through the sharded or monolithic parameter server, with worker
threads or spawned worker processes over the frame protocol, on eight
hand-written Hopper kernels (``kernels/csrc/``).  ``ROADMAP.md`` lists
what is still to be ported.
"""
