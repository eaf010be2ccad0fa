"""Synthetic HyperPRI-format data generation (port of
hyperpri_tpu/data/synthetic.py): rhizobox data in the on-disk format the
reference consumes (ENVI .hdr/.dat cubes, RGB PNGs, mask PNGs, box/date split
JSONs), drawn from numpy's generator in the JAX package's order so the same
seed writes the same arrays. PNGs go through the port's codec (png.py).

Images contain procedurally drawn root-like curves so that segmentation
training on them actually converges (smoke-testable learning signal).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from hyperpri_tpu_torch.data.envi import write_envi
from hyperpri_tpu_torch.data.png import write_png
from hyperpri_tpu_torch.data.splits import write_split_json


def draw_roots(h: int, w: int, rng: np.random.Generator, n_roots: int = 4) -> np.ndarray:
    """Binary (h, w) mask of random downward-wandering root curves."""
    mask = np.zeros((h, w), bool)
    for _ in range(n_roots):
        x = rng.integers(w // 8, w - w // 8)
        width = int(rng.integers(1, max(2, w // 40)))
        for y in range(0, h):
            x = int(np.clip(x + rng.integers(-2, 3), 0, w - 1))
            mask[y, max(0, x - width) : min(w, x + width + 1)] = True
            if rng.random() < 0.01:  # branch
                width = max(1, width - 1)
    return mask


def root_spectrum(bands: int) -> np.ndarray:
    """Smooth 'root' reflectance: brighter in the NIR half."""
    x = np.linspace(0, 1, bands)
    return 0.25 + 0.5 / (1 + np.exp(-(x - 0.55) * 14))


def soil_spectrum(bands: int) -> np.ndarray:
    x = np.linspace(0, 1, bands)
    return 0.15 + 0.25 * x


def make_box(
    root_dir: str,
    plant: str,
    resolution: str,
    box_key: str,
    dates: List[str],
    size_hw: Tuple[int, int],
    bands: int,
    rng: np.random.Generator,
    with_hsi: bool = True,
    with_rgb: bool = True,
    interleave: str = "bil",
) -> None:
    h, w = size_hw
    base = os.path.join(root_dir, f"{plant}_{resolution}")
    rgb_dir = os.path.join(base, "rgb_files")
    hsi_dir = os.path.join(base, "hsi_files")
    mask_dir = os.path.join(base, "mask_files")
    for d in (rgb_dir, hsi_dir, mask_dir):
        os.makedirs(d, exist_ok=True)

    for date in dates:
        name = f"{date}_{box_key}_ref"
        mask = draw_roots(h, w, rng)
        noise = rng.normal(0, 0.02, (h, w, 1)).astype(np.float32)

        if with_rgb:
            rgb = np.where(mask[..., None], [0.8, 0.7, 0.6], [0.35, 0.25, 0.2]).astype(
                np.float32
            ) + noise
            arr = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(rgb_dir, f"{name}.png"), arr)

        if with_hsi:
            spec = np.where(
                mask[..., None], root_spectrum(bands), soil_spectrum(bands)
            ).astype(np.float32)
            cube = np.clip(spec + rng.normal(0, 0.02, (h, w, bands)), 0, 1).astype(
                np.float32
            )
            write_envi(
                os.path.join(hsi_dir, "hinalea_hsi.hdr"),
                os.path.join(hsi_dir, f"{name}.dat"),
                cube,
                interleave=interleave,
            )

        write_png(os.path.join(mask_dir, f"{name}_mask.png"), (mask * 255).astype(np.uint8))


def make_experiment_tree(
    calling_path: str,
    n_boxes: int = 2,
    dates_per_box: int = 2,
    size_hw: Tuple[int, int] = (16, 24),
    bands: int = 20,
    seed: int = 0,
    with_hsi: bool = True,
    n_splits: int = 1,
) -> dict:
    """Synthetic data at the path layout the config layer expects:
    {calling_path}/Datasets/HyperPRI/ with data_splits/{train,val}{k}.json.

    With n_splits > 1, box-level rotation mirrors the reference's 5-fold
    protocol (each split holds out a different box subset as validation) and
    a test.json is written (the held-out final box, the reference's box-40
    analog).
    """
    root = os.path.join(calling_path, "Datasets", "HyperPRI")
    os.makedirs(root, exist_ok=True)
    info = make_synthetic_dataset(
        root,
        n_boxes=n_boxes,
        dates_per_box=dates_per_box,
        size_hw=size_hw,
        bands=bands,
        seed=seed,
        with_hsi=with_hsi,
    )
    train_path = info["splits"]["train"]
    val_path = info["splits"].get("val") or train_path
    import shutil

    split_dir = os.path.join(root, "data_splits")
    boxes = info["boxes"]
    keys = list(boxes)
    for k in range(1, n_splits + 1):
        if k == 1 and n_splits == 1:
            for want, have in [("train1.json", train_path), ("val1.json", val_path)]:
                dst = os.path.join(split_dir, want)
                if os.path.abspath(dst) != os.path.abspath(have):
                    shutil.copy(have, dst)
            continue
        val_keys = [keys[(k - 1) % len(keys)]]
        train_keys = [b for b in keys if b not in val_keys] or keys[:1]
        write_split_json(os.path.join(split_dir, f"train{k}.json"),
                         {b: boxes[b] for b in train_keys})
        write_split_json(os.path.join(split_dir, f"val{k}.json"),
                         {b: boxes[b] for b in val_keys})
    if n_splits > 1:
        write_split_json(os.path.join(split_dir, "test.json"), {keys[-1]: boxes[keys[-1]]})
    return info


def make_synthetic_dataset(
    root_dir: str,
    n_boxes: int = 2,
    dates_per_box: int = 2,
    size_hw: Tuple[int, int] = (32, 48),
    bands: int = 299,
    seed: int = 0,
    plant: str = "Peanut",
    splits: Optional[dict] = None,
    with_hsi: bool = True,
) -> dict:
    """Create boxes + a {train,val} split-JSON pair; returns their paths.

    `bands` defaults to 299 stored bands like the real Hinalea cubes, so the
    paper band window [25, 263) -> 238 slices cleanly (use a smaller value
    plus explicit hsi_lo/hsi_hi in fast tests).
    """
    rng = np.random.default_rng(seed)
    resolution = f"{size_hw[1]}x{size_hw[0]}"
    dates = [f"202207{d:02d}" for d in range(1, dates_per_box + 1)]
    boxes = {}
    for b in range(n_boxes):
        key = f"box{33 + b}"
        make_box(root_dir, plant, resolution, key, dates, size_hw, bands, rng, with_hsi=with_hsi)
        boxes[key] = {
            "plant_folder": plant,
            "resolution": resolution,
            "box_no": 33 + b,
            "phenotype": 1,
            "dates": dates,
            "weights": None,
        }

    split_dir = os.path.join(root_dir, "data_splits")
    os.makedirs(split_dir, exist_ok=True)
    if splits is None:
        box_keys = list(boxes)
        n_train = max(1, len(box_keys) - 1)
        splits = {"train": box_keys[:n_train], "val": box_keys[n_train:] or box_keys[-1:]}
    paths = {}
    for split_name, keys in splits.items():
        path = os.path.join(split_dir, f"{split_name}1.json")
        write_split_json(path, {k: boxes[k] for k in keys})
        paths[split_name] = path
    return {"root": root_dir, "splits": paths, "boxes": boxes}
