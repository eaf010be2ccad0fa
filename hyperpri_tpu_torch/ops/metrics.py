"""Binary segmentation metrics (port of hyperpri_tpu/ops/metrics.py:39-116).

torchmetrics semantics: point metrics threshold with `prob > threshold`;
0/0 gives 0 (dice takes a `zero_division` value instead).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _safe_div(num, den) -> torch.Tensor:
    num = torch.as_tensor(num, dtype=torch.float32)
    den = torch.as_tensor(den, dtype=torch.float32, device=num.device)
    return torch.where(den == 0, torch.zeros_like(num),
                       num / torch.where(den == 0, torch.ones_like(den), den))


class StatScores(NamedTuple):
    """Micro-accumulated binary confusion counts (int64 scalars)."""

    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "StatScores":
        z = torch.zeros((), dtype=torch.int64, device=device)
        return cls(z, z, z, z)

    def update(self, preds, target, threshold: float = 0.5, valid=None) -> "StatScores":
        """Accumulate counts of float `preds > threshold` against `target`;
        `valid` (broadcastable bool/0-1 mask) excludes padded samples or
        pixels from all four counts."""
        p = preds > threshold
        t = target.bool()
        p, t = torch.broadcast_tensors(p, t)
        v = torch.ones((), dtype=torch.bool, device=p.device) if valid is None \
            else torch.as_tensor(valid, device=p.device).bool()
        tp = (p & t & v).sum()
        fp = (p & ~t & v).sum()
        tn = (~p & ~t & v).sum()
        fn = (~p & t & v).sum()
        return StatScores(self.tp + tp, self.fp + fp, self.tn + tn, self.fn + fn)


def accuracy_from_stats(s: StatScores) -> torch.Tensor:
    return _safe_div(s.tp + s.tn, s.tp + s.tn + s.fp + s.fn)


def dice_from_stats(s: StatScores, zero_division: float = 0.0) -> torch.Tensor:
    den = (2 * s.tp + s.fp + s.fn).float()
    return torch.where(den == 0, torch.full_like(den, zero_division),
                       2 * s.tp.float() / den.clamp_min(1.0))


def jaccard_from_stats(s: StatScores) -> torch.Tensor:
    return _safe_div(s.tp, s.tp + s.fp + s.fn)

