"""Configurations of the models the port serves: the five language
models, DeepFM and the four GNN architectures (``registry`` maps an arch
id to its module)."""
