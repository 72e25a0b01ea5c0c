"""Configurations of the models the port serves: the five language
models, DeepFM, the four GNN architectures and the paper's BFS deployment
(``registry`` maps an arch id to its module)."""
