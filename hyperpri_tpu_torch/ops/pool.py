"""2x2 max pooling, forward only (port of hyperpri_tpu/ops/pool.py:40-46).

VALID padding and stride 2, torch nn.MaxPool2d(2) semantics: odd tails are
dropped (121 -> 60). The backward, with its first-max tie-break, comes with
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H//2, W//2, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
