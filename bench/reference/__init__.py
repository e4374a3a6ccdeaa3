"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the program (``repro_torch``) nor of the JAX
package, and take no weights from the program: ``common.draw_block``
draws every weight from the run's seed, for the harness to load into the
program and for the reference to draw again, block by block.
"""
