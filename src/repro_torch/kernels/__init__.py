"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each subpackage mirrors ``repro/kernels/<name>``: the kernel's wrapper
(``<name>.py``), the routing entry point (``ops.py``: a CUDA tensor goes to
the kernel, a CPU tensor to the plain version) and the plain version
(``ref.py`` or beside the wrapper).  Sources are in ``csrc/``; ``build.py``
compiles, loads and counts them.
"""
