"""Data: the paper's tree generator and its BFS oracle, and the
Criteo-like recsys stream."""
