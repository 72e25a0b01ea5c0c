"""PyTorch/CUDA port of the positional recursive-query engine (PosDB's
PRecursive) for one NVIDIA H100.

It mirrors the layout of the JAX package ``repro``, which stays the
reference: ``core`` (storage, CSR index, operators, engine), ``data`` (the
tree generator), ``kernels`` (hand-written CUDA kernels with their plain
PyTorch versions) and ``convert`` (the reference's table into the port).
It imports neither ``jax`` nor ``repro``.
"""
