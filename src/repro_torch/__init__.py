"""PyTorch/CUDA port of the semantic-router fleet (``src/repro``'s twin).

The package mirrors ``repro``'s module names so each counterpart is easy
to find.  It imports ``torch`` and numpy only: nothing of JAX and nothing
of ``repro``, whose JAX-free helpers it keeps its own copies of.  The
Pallas kernels of the reference become hand-written CUDA kernels for
Hopper (``kernels/csrc``), built at first use.
"""
