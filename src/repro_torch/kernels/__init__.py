"""Hand-written Hopper kernels of the port.

Each kernel lives in ``csrc/<name>.cu`` (built by ``_build``) with a
wrapper and a plain PyTorch version beside it in its package's ``ops.py``.
"""
