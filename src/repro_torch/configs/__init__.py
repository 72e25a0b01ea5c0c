"""Configurations of the models the port serves: DeepFM and the four GNN
architectures (``registry`` maps an arch id to its module)."""
