"""Losses (port of hyperpri_tpu/ops/losses.py:9-25)."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    reduction: str = "mean") -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, in float32 (float64
    for float64 logits, a reference run at higher precision):
    max(x, 0) - x*z + log(1 + exp(-|x|)), as torch.nn.BCEWithLogitsLoss."""
    x = logits if logits.dtype == torch.float64 else logits.float()
    z = targets.to(x.dtype)
    loss = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")
