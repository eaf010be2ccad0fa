"""Tensor ops: pooling, BatchNorm folding, losses, metrics."""
