"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds the CUDA source (``csrc/``), its build and binding
(``kernel.py``), the plain PyTorch version (``ref.py``) and the public
wrappers with their launch counters (``ops.py``).
"""
