"""Segmentation maps: prediction-against-ground-truth overlays (port of
hyperpri_tpu/utils/segmaps.py:1-84).

  - HSI cubes become pseudo-RGB from band indices [125, 49, 0] of the band
    window (about 700 / 546 / 436 nm) with gamma 1/2.2;
  - a colour-blind-safe palette: red = prediction only, blue = ground truth
    only, green = agreement;
  - one image per sample, {fig_dir}/{name}_seg.png.

The JAX package draws with matplotlib (imshow of the image, then of the
overlay at alpha 0.6). The port blends the same two layers in numpy and
writes the PNG with data/png.py: no PIL, no matplotlib. The figure's title,
axes margin and dpi are not reproduced; the PNG has the image's own size.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from hyperpri_tpu_torch.data.png import write_png

HSI_PSEUDO_RGB_BANDS = [125, 49, 0]  # R ~700nm, G ~546nm, B ~436nm
RED = np.array([202, 0, 32]) / 255.0  # prediction only
BLUE = np.array([5, 133, 176]) / 255.0  # ground truth only
GREEN = np.array([155, 191, 133]) / 255.0  # agreement
OVERLAY_ALPHA = 0.6


def to_display_rgb(image_hwc: np.ndarray, dataset: str) -> np.ndarray:
    """(H, W, C) image -> (H, W, 3) display RGB (gamma-corrected pseudo-RGB
    for HSI)."""
    if dataset.lower() == "hsi":
        bands = [min(b, image_hwc.shape[-1] - 1) for b in HSI_PSEUDO_RGB_BANDS]
        rgb = image_hwc[..., bands]
        return np.clip(rgb, 0, None) ** (1 / 2.2)
    return np.clip(image_hwc[..., :3], 0, 1)


def overlay_mask(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(H, W) bool pred / gt -> (H, W, 3) colour-blind-safe overlay."""
    h, w = pred.shape
    out = np.zeros((h, w, 3))
    out[..., 0] = pred
    out[..., 1] = gt
    out[pred, :] = RED
    out[gt, :] = BLUE
    out[pred & gt, :] = GREEN
    return out


def blend(img: np.ndarray, overlay: np.ndarray, alpha: float = OVERLAY_ALPHA) -> np.ndarray:
    """The overlay drawn over the image at `alpha`, as uint8 RGB: (1 - alpha)
    * img + alpha * overlay everywhere, so the image darkens where the
    overlay is zero, as under matplotlib's two imshow calls. The image is
    clipped to [0, 1] first, as imshow clips float RGB."""
    mixed = (1.0 - alpha) * np.clip(img, 0.0, 1.0) + alpha * overlay
    return np.clip(np.round(mixed * 255.0), 0, 255).astype(np.uint8)


def eval_color_segmaps(
    batch_img: np.ndarray,
    batch_name: Sequence[str],
    batch_pred_logits: np.ndarray,
    batch_mask: np.ndarray,
    fig_dir: str,
    dataset: str = "RGB",
    model_param_str: str = "",
    threshold: float = 0.5,
    valid: Optional[np.ndarray] = None,
) -> list:
    """Render and save the overlays of one batch; returns the written paths.
    `model_param_str` titles the JAX package's figure and is not drawn here."""
    os.makedirs(fig_dir, exist_ok=True)
    written = []
    for idx in range(batch_img.shape[0]):
        if valid is not None and not valid[idx]:
            continue
        name = batch_name[idx]
        img = to_display_rgb(np.asarray(batch_img[idx]), dataset)
        probs = 1.0 / (1.0 + np.exp(-np.asarray(batch_pred_logits[idx], np.float64)))
        pred = (probs > threshold).squeeze(-1).astype(bool)
        gt = np.asarray(batch_mask[idx]).squeeze(-1).astype(bool)
        path = os.path.join(fig_dir, f"{name}_seg.png")
        write_png(path, blend(img, overlay_mask(pred, gt)))
        written.append(path)
    return written
