"""Data: the paper's tree generator and its BFS oracle, the Criteo-like
recsys stream, the R-MAT and molecule graphs of the GNN archs
(``graphgen``), GraphSAGE's positional neighbour sampler (``sampler``)
and the LM token stream (``tokens``)."""
