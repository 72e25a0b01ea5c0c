"""Models the port serves: DeepFM (``recsys``) and the four GNN
architectures, GatedGCN, GraphSAGE, EGNN and GAT (``gnn``)."""
