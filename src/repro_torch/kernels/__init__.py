"""Hand-written CUDA kernels for the H100 (``sm_90a``), ported from the
Pallas TPU kernels of ``src/repro/kernels``.

Each kernel package keeps the reference's three files: ``<name>.py``
launches the kernel of ``csrc/<name>.cu`` through ``ctypes``, ``ops.py`` is
the public wrapper with the engine's contract and a launch counter, and
``ref.py`` is the plain PyTorch version.  A wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
``_build.py`` compiles the sources with ``nvcc`` at first use.
"""
