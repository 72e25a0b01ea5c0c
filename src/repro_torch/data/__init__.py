"""Data: the paper's tree generator and its BFS oracle."""
