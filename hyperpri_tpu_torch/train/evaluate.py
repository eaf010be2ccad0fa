"""Evaluation: threshold sweeps (validate_net) and fixed-threshold tests
(test_net), port of hyperpri_tpu/train/evaluate.py.

validate_net: load the best checkpoint (the port's own, or the reference's
Lightning .ckpt, raw best_wts.pt or ZeRO-2 directory, routed by content as
evaluate.py:60-82 routes them) -> predict over the split -> overall
BCE -> 500-threshold PR sweep -> crop 1% tails -> best-DICE threshold (2
decimals) -> print BCE/PixAcc/Prec/Recall/DICE/+IOU/AP and the row-normalized
confusion matrix -> write the PR curve -> patch the undefined-precision tail.
Returns (precision, recall, thresholds) as numpy arrays.

test_net: the same predict-then-metrics flow at a given threshold.

With `save_segmaps`, both then render each valid image's overlay at the
threshold into cfg.fig_dir (utils/segmaps.py, PNGs through data/png.py), from
the batches' logits kept on the host and the images read again from the
split, through its decoded-image cache while the split fits
SEGMAP_CACHE_ITEMS_CAP (evaluate.py:107-120, :177-183, :226-249).

Under a mesh (cfg.mesh_shape, or a mesh trainer) each rank predicts its
samples' rows, Trainer.predict gathers the whole batch on every rank, and the
sweep runs on the same logits as on one device; the mesh's first rank alone
prints and writes.

The metrics run on the predictions' device over the concatenated logits. The
PR curve is written as {save_path}/pr_curve.csv (columns threshold, precision,
recall) where the JAX package draws pr_curve.png with matplotlib.
"""

from __future__ import annotations

import contextlib
import csv
import os
from typing import Optional, Tuple

import numpy as np
import torch

from hyperpri_tpu_torch.config import ExperimentConfig
from hyperpri_tpu_torch.data.pipeline import DataLoader
from hyperpri_tpu_torch.ops.losses import bce_with_logits
from hyperpri_tpu_torch.ops.metrics import (
    average_precision,
    best_threshold_from_pr,
    binary_accuracy,
    binary_dice,
    binary_jaccard,
    confusion_matrix,
    patch_pr_tail,
    pr_curve,
)
from hyperpri_tpu_torch.train.checkpoint import find_eval_checkpoint, read_checkpoint
from hyperpri_tpu_torch.train.torch_import import (
    load_torch_checkpoint_state,
    load_zero2_checkpoint_state,
)
from hyperpri_tpu_torch.train.trainer import Trainer
from hyperpri_tpu_torch.utils.segmaps import eval_color_segmaps

# At most this many decoded images are held in the split's cache across the
# predict and render passes (about 0.5 GB a float32 cube at full resolution).
SEGMAP_CACHE_ITEMS_CAP = 16


def _gather_predictions(trainer: Trainer, loader: DataLoader, keep_batches: bool = False):
    """-> flat (logits, masks) of the valid samples, on the device, and with
    `keep_batches` each batch's (logits, masks, valid, names) on the host
    for the render pass (else an empty list)."""
    logit_parts, mask_parts, batches = [], [], []
    for logits, masks, valid, names in trainer.predict(loader):
        keep = valid > 0
        logit_parts.append(logits[keep].reshape(-1))
        mask_parts.append(masks[keep].reshape(-1))
        if keep_batches:
            batches.append((logits.cpu().numpy(), masks.cpu().numpy(), valid.cpu().numpy(),
                            names))
    return torch.cat(logit_parts), torch.cat(mask_parts), batches


@contextlib.contextmanager
def _segmap_image_cache(dataset, enabled: bool):
    """Hold the split's decoded images in its cache across the predict and
    render passes, so each is decoded once, up to SEGMAP_CACHE_ITEMS_CAP
    images; the cache's size is restored on exit."""
    if not enabled:
        yield
        return
    wanted = min(len(dataset), SEGMAP_CACHE_ITEMS_CAP)
    old = dataset.set_cache_items(max(wanted, dataset._cache_items))
    try:
        yield
    finally:
        dataset.set_cache_items(old)


def _reload_images(dataset, names, valid) -> np.ndarray:
    """The batch's images read again from the split, as float32 (H, W, C)
    numpy arrays (zeros for padding entries)."""
    by_name = {e.name: i for i, e in enumerate(dataset.files)}
    images = [None if valid is not None and not valid[i]
              else dataset[by_name[name]]["image"].float().numpy()
              for i, name in enumerate(names)]
    h, w, c = next(im.shape for im in images if im is not None)
    return np.stack([im if im is not None else np.zeros((h, w, c), np.float32)
                     for im in images])


def _render_segmaps(data, cfg: ExperimentConfig, batches, threshold: float) -> list:
    written = []
    for logits, masks, valid, names in batches:
        written += eval_color_segmaps(_reload_images(data, names, valid), names, logits, masks,
                                      cfg.fig_dir, dataset=cfg.dataset,
                                      model_param_str=cfg.model_param_str,
                                      threshold=threshold, valid=valid)
    return written


def _load_eval_state(trainer: Trainer, cfg: ExperimentConfig, state=None):
    """The state to evaluate: `state` when given (it must be the trainer's),
    else the best checkpoint under cfg.save_path loaded into the trainer, by
    its format (checkpoint.read_checkpoint): the port's own payload, a
    reference .ckpt / .pt file, or a ZeRO-2 directory."""
    if state is not None:
        if state.model is not trainer.model:
            raise ValueError("the state to evaluate must be the trainer's")
        return state
    ckpt_path = find_eval_checkpoint(cfg.save_path)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.save_path} "
                                "(Checkpoints/ or best_wts.pt)")
    if trainer.is_main:
        print(f"   LOADING FROM CKPT FILE: {ckpt_path}")
    fmt, payload = read_checkpoint(ckpt_path)
    if fmt == "zero_dir":
        return load_zero2_checkpoint_state(trainer, cfg, ckpt_path)
    if fmt == "torch":
        return load_torch_checkpoint_state(trainer, cfg, ckpt_path, raw=payload)
    return trainer.restore_state(ckpt_path, payload=payload)


def _eval_loader(data, cfg: ExperimentConfig, trainer: Trainer) -> DataLoader:
    image_dtype = torch.bfloat16 if cfg.precision == "bf16" else None
    return DataLoader(data, trainer.effective_batch(cfg.b_size["test"]), shuffle=False,
                      device=trainer.device, image_dtype=image_dtype, mesh=trainer.mesh)


def write_pr_csv(path: str, precision, recall, thresholds) -> None:
    """The PR curve as CSV: T rows of (threshold, precision, recall) and the
    appended end point (precision 1, recall 0) with an empty threshold."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    thr = [f"{float(t):.6f}" for t in thresholds] + [""]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["threshold", "precision", "recall"])
        for t, p, r in zip(thr, precision.tolist(), recall.tolist()):
            w.writerow([t, f"{p:.8f}", f"{r:.8f}"])


def validate_net(val_data, params: ExperimentConfig, trainer: Optional[Trainer] = None,
                 save_segmaps: bool = False, state=None, n_thresholds: int = 500,
                 verbose: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    cfg = params
    trainer = trainer or Trainer(cfg)
    _load_eval_state(trainer, cfg, state)
    verbose, save_segmaps = verbose and trainer.is_main, save_segmaps and trainer.is_main
    with _segmap_image_cache(val_data, save_segmaps):
        logits, masks, batches = _gather_predictions(
            trainer, _eval_loader(val_data, cfg, trainer), keep_batches=save_segmaps)
        bce = bce_with_logits(logits, masks)
        probs = torch.sigmoid(logits)
        precision, recall, thresholds = pr_curve(probs, masks, n_thresholds)
        best_thr, curve_prec, curve_rec = best_threshold_from_pr(precision, recall, thresholds)
        best_thr_f = float(best_thr)
        best_acc = binary_accuracy(probs, masks, best_thr_f)
        # P = R = 0 reports dice 0, not NaN (evaluate.py:145-150)
        pr_sum = curve_prec + curve_rec
        best_dice = torch.where(pr_sum > 0,
                                2 * curve_prec * curve_rec / pr_sum.clamp_min(1e-12),
                                torch.zeros_like(pr_sum))
        best_iou = binary_jaccard(probs, masks, best_thr_f)
        ap = average_precision(probs, masks)
        conf = confusion_matrix(probs, masks, best_thr_f, normalize=True)
        if verbose:
            print(f"\n{cfg.model_name}\n   Best Threshold {best_thr_f:.3f}:")
            print(f"      BCE Loss : {float(bce):.3f}")
            print(f"      Pixel Acc: {float(best_acc):.3f}")
            print(f"      Precision: {float(curve_prec):.3f}")
            print(f"      Recall   : {float(curve_rec):.3f}")
            print(f"      DICE     : {float(best_dice):.3f}")
            print(f"      +IOU     : {float(best_iou):.3f}")
            print(f"      Avg Prec : {float(ap):.3f}\n")
            print(f"      Conf Mat : {conf[0].tolist()}")
            print(f"                 {conf[1].tolist()}")
        if trainer.is_main:
            write_pr_csv(os.path.join(cfg.save_path, "pr_curve.csv"), precision, recall,
                         thresholds)
        precision = patch_pr_tail(precision)
        if save_segmaps:
            _render_segmaps(val_data, cfg, batches, best_thr_f)
    return precision.cpu().numpy(), recall.cpu().numpy(), thresholds.cpu().numpy()


def test_net(test_data, params: ExperimentConfig, best_threshold: float,
             trainer: Optional[Trainer] = None, save_segmaps: bool = False, state=None,
             verbose: bool = True) -> dict:
    cfg = params
    trainer = trainer or Trainer(cfg)
    _load_eval_state(trainer, cfg, state)
    verbose, save_segmaps = verbose and trainer.is_main, save_segmaps and trainer.is_main
    with _segmap_image_cache(test_data, save_segmaps):
        logits, masks, batches = _gather_predictions(
            trainer, _eval_loader(test_data, cfg, trainer), keep_batches=save_segmaps)
        probs = torch.sigmoid(logits)
        thr = float(best_threshold)
        results = {
            "pix_acc": float(binary_accuracy(probs, masks, thr)),
            "dice": float(binary_dice(probs, masks, thr, zero_division=1e-12)),
            "pos_iou": float(binary_jaccard(probs, masks, thr)),
            "avg_prec": float(average_precision(probs, masks)),
            "conf_mat": confusion_matrix(probs, masks, thr, normalize=True).cpu().numpy(),
            "threshold": thr,
        }
        if verbose:
            print(f"Threshold {thr:.3f}:")
            print(f"      Pixel Acc: {results['pix_acc']:.3f}")
            print(f"      DICE     : {results['dice']:.3f}")
            print(f"      +IOU     : {results['pos_iou']:.3f}")
            print(f"      Avg Prec : {results['avg_prec']:.3f}\n")
            print(f"      Conf Mat : {results['conf_mat'][0].tolist()}")
            print(f"                 {results['conf_mat'][1].tolist()}")
        if save_segmaps:
            _render_segmaps(test_data, cfg, batches, thr)
    return results
