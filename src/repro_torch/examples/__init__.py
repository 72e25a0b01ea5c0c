"""The reference's ``examples/*.py`` on the port, one device each:
``quickstart``, ``bfs_traversal``, ``gnn_reddit``, ``recsys_serve`` and
``train_lm``.  Each runs as ``python -m repro_torch.examples.<name>``
with the reference script's flags and ``--device`` (default: the card),
and each has a function under ``main`` that takes the sizes and returns
what it printed, for the tests to run small."""
