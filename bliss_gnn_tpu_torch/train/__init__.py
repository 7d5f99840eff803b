"""The fused training step, optimizer and F1 metrics."""
