"""Chunked-pixel gradient accumulation for per-pixel models (port of
hyperpri_tpu/train/chunked.py:53-138): SpectralUNET's memory control.

The batch's (N, H, W, C) image is rasterised image-major to (N*H*W, C) rows,
so chunk boundaries at multiples of H*W are image boundaries. Each of the
`n_chunks` equal chunks runs the forward and backward on a (1, chunk, 1, C)
view against the whole batch's valid-pixel denominator; the gradients add up
in `.grad` and the optimizer steps once. Peak activation memory is that of
one chunk.

BatchNorm takes its statistics per chunk, and the running statistics move
chunk by chunk. At n_chunks == N that is the reference's own per-image
training semantics; at n_chunks == 1 the step is the unchunked one. A chunk
count that does not divide N*H*W raises: the JAX step would zero-pad the
last chunk, and those rows would enter its BatchNorm statistics (ROADMAP
caveat R2).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from hyperpri_tpu_torch.ops.losses import bce_with_logits
from hyperpri_tpu_torch.ops.metrics import StatScores
from hyperpri_tpu_torch.train.step import offload_context, wait_for_offloaded


def make_chunked_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                            threshold: float, n_chunks: int, offload: bool = False
                            ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, object]]:
    """-> step(batch) -> {"loss_sum", "n", "stats"}, as train/step.py's
    make_train_step. `offload`: step.offload_context, around each chunk's
    forward and loss."""
    if n_chunks <= 0:
        raise ValueError(f"n_chunks must be positive, got {n_chunks}")

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        image, mask, valid = batch["image"], batch["mask"], batch["valid"]
        n, h, w, c = image.shape
        total = n * h * w
        if total % n_chunks:
            raise ValueError(f"{n_chunks} chunks do not divide the batch's {total} pixels "
                             f"({n}x{h}x{w}); a padded chunk would enter BatchNorm's "
                             "statistics")
        chunk = total // n_chunks
        pixels = image.reshape(total, c)
        targets = mask.reshape(total).float()
        pix_valid = (valid.reshape(n, 1) > 0).expand(n, h * w).reshape(total)
        # the whole batch's mean-BCE denominator, the unchunked step's
        denom = torch.clamp_min(valid.float().sum() * (h * w), 1.0)

        optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=image.device)
        stats = StatScores.zeros(image.device)
        for k in range(n_chunks):
            rows = slice(k * chunk, (k + 1) * chunk)
            target, keep = targets[rows], pix_valid[rows]
            with offload_context(offload):
                logits = model(pixels[rows][None, :, None, :], train=True).reshape(chunk)
                per = bce_with_logits(logits, target, reduction="none")
                loss_c = (per * keep.float()).sum() / denom
            loss_c.backward()
            wait_for_offloaded(model, offload)
            with torch.no_grad():
                loss = loss + loss_c.detach()
                stats = stats.update(torch.sigmoid(logits.detach()), target > 0.5, threshold,
                                     valid=keep)
        optimizer.step()
        n_valid = valid.sum()
        return {"loss_sum": loss * n_valid, "n": n_valid, "stats": stats}

    return train_step
