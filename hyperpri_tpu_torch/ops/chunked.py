"""Chunked inference for per-pixel models (port of hyperpri_tpu/ops/chunked.py).

At full 608x968 resolution one SpectralUNET activation is (588K pixels, 1650)
wide. In the eval form no pixel couples to another (BatchNorm uses the
running statistics), so the pixel axis streams through the model in chunks:
the activations live for one chunk at a time, and the logits equal the
unchunked eval's.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def apply_pixelwise_chunked(model, x: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """Eval form of a per-pixel model over (N, H, W, D) in chunks of `chunk`
    pixels (the last one shorter): -> (N, H, W, n_classes), as
    model(x, train=False). Each chunk runs as a (1, chunk, 1, D) image."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n, h, w, d = x.shape
    pixels = x.reshape(n * h * w, d)
    out = [model(pixels[i:i + chunk][None, :, None, :], train=False)[0, :, 0, :]
           for i in range(0, pixels.shape[0], chunk)]
    return torch.cat(out).reshape(n, h, w, -1)
