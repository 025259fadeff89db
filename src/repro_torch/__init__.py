"""PyTorch port of the RIPPLE streaming GNN inference system.

The package mirrors ``repro``'s module layout, so each module's counterpart
sits at the same path.  It imports ``torch`` and ``numpy`` only: never
``jax`` and nothing of ``repro``.  Hot-path kernels are hand-written CUDA
C++ for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
What is ported so far, and what is still to come, is in ROADMAP.md.
"""
