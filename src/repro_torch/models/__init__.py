"""Models the port serves: DeepFM (``recsys``), the four GNN
architectures, GatedGCN, GraphSAGE, EGNN and GAT (``gnn``), and the five
decoder-only language models (``transformer``, built of ``layers``)."""
