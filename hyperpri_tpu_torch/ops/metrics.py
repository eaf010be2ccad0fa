"""Binary segmentation metrics (port of hyperpri_tpu/ops/metrics.py).

torchmetrics semantics: point metrics threshold with `prob > threshold`;
0/0 gives 0 (dice takes a `zero_division` value instead). The curve metrics
(`pr_curve`, `average_precision`, `best_threshold_from_pr`, `patch_pr_tail`)
compute on the tensors' device, with no float atomics, so they give the same
bits on every run.
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

    def merge(self, other: "StatScores") -> "StatScores":
        return StatScores(*(a + b.to(a.device) for a, b in zip(self, other)))


def accuracy_from_stats(s: StatScores) -> torch.Tensor:
    return _safe_div(s.tp + s.tn, s.tp + s.tn + s.fp + s.fn)


def dice_from_stats(s: StatScores, zero_division: float = 0.0) -> torch.Tensor:
    den = (2 * s.tp + s.fp + s.fn).float()
    return torch.where(den == 0, torch.full_like(den, zero_division),
                       2 * s.tp.float() / den.clamp_min(1.0))


def jaccard_from_stats(s: StatScores) -> torch.Tensor:
    return _safe_div(s.tp, s.tp + s.fp + s.fn)



def binary_accuracy(preds, target, threshold: float = 0.5):
    return accuracy_from_stats(StatScores.zeros(preds.device).update(preds, target, threshold))


def binary_dice(preds, target, threshold: float = 0.5, zero_division: float = 0.0):
    return dice_from_stats(StatScores.zeros(preds.device).update(preds, target, threshold),
                           zero_division)


def binary_jaccard(preds, target, threshold: float = 0.5):
    return jaccard_from_stats(StatScores.zeros(preds.device).update(preds, target, threshold))


def confusion_matrix(preds, target, threshold: float = 0.5, normalize: bool = False):
    """2x2 [[TN, FP], [FN, TP]], optionally normalized by true-class totals
    (metrics.py:118-127)."""
    s = StatScores.zeros(preds.device).update(preds, target, threshold)
    mat = torch.stack([torch.stack([s.tn, s.fp]), torch.stack([s.fn, s.tp])]).float()
    if normalize:
        mat = mat / mat.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return mat


def pr_curve(probs: torch.Tensor, target: torch.Tensor, thresholds: int = 500):
    """Thresholded precision-recall curve, torchmetrics semantics
    (metrics.py:130-165): (precision[T+1], recall[T+1], thresholds[T]) with
    thresholds = linspace(0, 1, T), preds compared with >=, 0/0 -> 0 and the
    appended final point (precision 1, recall 0)."""
    t = torch.linspace(0.0, 1.0, thresholds, device=probs.device)
    p = probs.reshape(-1).float()
    y = target.reshape(-1).bool()
    scale = thresholds - 1
    # a prediction's bucket is the number of thresholds <= it, minus one
    bucket = torch.clamp(torch.floor(p * scale).long(), 0, thresholds - 1)
    bucket = torch.where(p * scale >= bucket + 1, bucket + 1, bucket)
    pos = torch.bincount(bucket[y], minlength=thresholds)
    neg = torch.bincount(bucket[~y], minlength=thresholds)
    tps = torch.flip(torch.cumsum(torch.flip(pos, [0]), 0), [0])
    fps = torch.flip(torch.cumsum(torch.flip(neg, [0]), 0), [0])
    precision = _safe_div(tps, tps + fps)
    recall = _safe_div(tps, y.sum())
    one = torch.ones(1, device=p.device)
    return torch.cat([precision, one]), torch.cat([recall, one * 0]), t


def average_precision(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Exact binary average precision, tie-aware (metrics.py:168-194): all
    predictions sharing a probability fall at one curve point whose precision
    is taken at the end of the tie group."""
    p = probs.reshape(-1).float()
    y = target.reshape(-1).float()
    n = p.shape[0]
    order = torch.argsort(-p, stable=True)
    p_sorted, y_sorted = p[order], y[order]
    cum_tp = torch.cumsum(y_sorted, 0)
    precision = cum_tp / torch.arange(1, n + 1, device=p.device, dtype=torch.float32)
    boundary = torch.ones(n, dtype=torch.bool, device=p.device)
    boundary[:-1] = p_sorted[:-1] != p_sorted[1:]
    # each element's group ends at the first boundary at or after it
    idx = torch.where(boundary, torch.arange(n, device=p.device), torch.full_like(order, n))
    group_end = torch.flip(torch.cummin(torch.flip(idx, [0]), 0).values, [0])
    return _safe_div((y_sorted * precision[group_end]).sum(), cum_tp[-1])


def best_threshold_from_pr(precision, recall, thresholds, crop_frac: int = 100):
    """The reference's best-DICE threshold (metrics.py:197-220): crop
    len(precision)//crop_frac entries from both ends, take the argmax of
    2PR/(P+R), round its threshold to 2 decimals. Precision and recall have
    one entry more than thresholds, so the argmax can land one past the
    cropped thresholds; it then takes the last one, as jnp's clamped gather
    does. -> (best_threshold, precision_at_best, recall_at_best)."""
    crop = len(precision) // crop_frac
    end = -crop if crop else None
    tp, tr, tt = precision[crop:end], recall[crop:end], thresholds[crop:end]
    idx = int(torch.argmax(_safe_div(2 * tp * tr, tp + tr)))
    best = torch.round(tt[min(idx, len(tt) - 1)] * 100) / 100
    return best, tp[idx], tr[idx]


def patch_pr_tail(precision: torch.Tensor) -> torch.Tensor:
    """The reference's cosmetic fill of the undefined-precision tail
    (metrics.py:223-230): if precision[-2] ~ 0, set it to (1 + p[-3]) / 2."""
    out = precision.clone()
    if float(out[-2]) < 1e-6:
        out[-2] = (1.0 + out[-3]) / 2.0
    return out
