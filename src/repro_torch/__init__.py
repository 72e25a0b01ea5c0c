"""PyTorch/CUDA port of the positional recursive-query engine (PosDB's
PRecursive) and of DeepFM serving, for one NVIDIA H100.

It mirrors the layout of the JAX package ``repro``, which stays the
reference: ``core`` (storage, CSR index, operators, engine), ``data`` (the
tree generator and the recsys stream), ``configs`` and ``models`` (DeepFM
at Criteo width), ``kernels`` (hand-written CUDA kernels with their plain
PyTorch versions) and ``convert`` (the reference's table and DeepFM
parameters into the port).  It imports neither ``jax`` nor ``repro``.
"""
