"""The benchmark harness of ``repro_torch``: traffic, drivers, trace
reading, the correctness check and the metric readers' host.

Only ``system`` imports the program (``repro_torch``); everything else here
is the yardstick and imports nothing of it.
"""
