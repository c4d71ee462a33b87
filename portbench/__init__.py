"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints its result line.
A cell is its entry in ``BENCHMARK.json``; everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own under
``configs/``, ``traffic/``, ``limits/`` and ``metrics/``, found by its
name; the modules
here are the general generator, the plain reference, the work counts and
the comparison that decides ``correct``.  Nothing here imports JAX or the
JAX package, and the reference imports nothing of ``repro_torch``.
"""
