"""GNN layers and models over sampled blocks."""
