"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

A package of its own beside the JAX reference: it mirrors ``repro``'s
module paths, imports ``torch`` and never ``jax`` or ``repro``.  This
slice runs the paper's main path — DSSP training of the dense
h2o-danube-1.8b through the sharded parameter server on the packed wire
with version-delta pulls — with four hand-written Hopper kernels
(``kernels/csrc/``).  ``ROADMAP.md`` lists what is still to be ported.
"""
