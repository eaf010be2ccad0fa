"""HyperPRI dataset: (RGB PNG | gray | ENVI HSI cube) + mask PNG pairs (port of
hyperpri_tpu/data/dataset.py).

The reference's contract, as the JAX package keeps it: modes 'rgb' / 'gray' /
'hsi'; RGB images rotated 90 degrees when W < H, HSI cubes not; the band
window [hsi_lo, hsi_hi) with hsi_hi <= 0 meaning 299 + hsi_hi; one random crop
offset shared by image and mask; a rescale by 1/255 when a cropped image
exceeds 10; labels binarized with value > 0.

Items are dicts {'image', 'mask', 'index', 'label', 'timing'}: 'image' a
(H, W, C) CPU tensor in `image_dtype` (float32, or bfloat16 rounded to
nearest even, as ml_dtypes casts in the JAX package), 'mask' a (H, W, 1)
float32 tensor of {0, 1}, and 'timing' the seconds spent reading (the ENVI
band-window gather or the PNG decode) and casting. HSI cubes are decoded
straight into `image_dtype` by the native reader (dataset.py:143-158), so
their cast takes no time; with `decoded_cache_dir` the decoded window
persists on disk across processes (data/disk_cache.py). PNGs go through the
port's own codec (png.py): no PIL.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperpri_tpu_torch.data.disk_cache import read_cube_cached
from hyperpri_tpu_torch.data.png import load_png
from hyperpri_tpu_torch.data.splits import DEFAULT_CLASS_LIST, SplitIndex, parse_split_json


class HyperpriDataset:
    """Map-style dataset over a resolved split index (dataset.py:49-198)."""

    def __init__(
        self,
        root: str,
        mode: str = "RGB",
        crop_size: Optional[Tuple[int, int]] = None,
        subset: Optional[List[str]] = None,
        hsi_lo: int = 0,
        hsi_hi: int = 0,
        json_file: Optional[str] = None,
        json_verb: bool = False,
        seed: int = 0,
        cache_items: int = 0,
        image_dtype: torch.dtype = torch.float32,
        decoded_cache_dir: Optional[str] = None,
    ):
        if json_file is None:
            raise ValueError("the dataset requires a split JSON")
        if hsi_lo < 0:
            raise ValueError(f"hsi_lo must be >= 0, got {hsi_lo}")
        if hsi_hi <= 0:
            hsi_hi = 299 + hsi_hi
        if hsi_lo >= hsi_hi:
            raise ValueError(f"empty band window [{hsi_lo}, {hsi_hi})")
        self.root = root
        self.mode = mode.lower()
        self.crop_size = tuple(crop_size) if crop_size else None
        self.class_list = subset if subset is not None else list(DEFAULT_CLASS_LIST)
        self.hsi_lo = hsi_lo
        self.hsi_hi = hsi_hi
        self.index: SplitIndex = parse_split_json(
            json_file, root, mode=self.mode, class_list=self.class_list, verbose=json_verb)
        self.files = self.index.entries
        self.sample_weights = np.asarray(self.index.sample_weights(self.class_list))
        self._rng = np.random.default_rng(seed)
        # decoded (image, label) pairs kept in host RAM, pre-crop
        self._cache_items = cache_items
        self._cache: "dict[int, tuple]" = {}
        self.decoded_cache_dir = decoded_cache_dir
        self.image_dtype = image_dtype

    def set_cache_items(self, n: int) -> int:
        """Resize the decoded-image LRU; returns the previous size."""
        old = self._cache_items
        self._cache_items = n
        if n <= 0:
            self._cache.clear()
        else:
            while len(self._cache) > n:
                self._cache.pop(next(iter(self._cache)))
        return old

    def set_image_dtype(self, dtype: torch.dtype) -> None:
        """Change the returned image dtype; drops the cached images, which
        were decoded in the old one."""
        if dtype != self.image_dtype:
            self.image_dtype = dtype
            self._cache.clear()

    def __len__(self) -> int:
        return len(self.files)

    @property
    def n_channels(self) -> int:
        return self.hsi_hi - self.hsi_lo if self.mode == "hsi" else 3

    def _load_raw(self, i: int):
        """((H, W, C) image, uint8 (H, W) label): an HSI cube decoded in
        image_dtype (a numpy float32 array or a torch.bfloat16 tensor), a PNG
        as a float32 numpy array."""
        entry = self.files[i]
        if self.mode == "hsi":
            img = read_cube_cached(entry.hdr, entry.dat, self.hsi_lo, self.hsi_hi,
                                   dtype=self.image_dtype, cache_dir=self.decoded_cache_dir)
        elif self.mode == "gray":
            g = load_png(entry.img, "L").astype(np.float32) / 255.0
            img = np.repeat(g[..., None], 3, axis=-1)
        else:
            img = load_png(entry.img, "RGB").astype(np.float32) / 255.0
        label = load_png(entry.label, "L")
        if self.mode != "hsi" and img.shape[1] < img.shape[0]:
            img = np.rot90(img, 1, axes=(0, 1))
            label = np.rot90(label, 1, axes=(0, 1))
        return img, label

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None) -> Dict:
        entry = self.files[i]
        rng = rng or self._rng
        t0 = time.perf_counter()
        if self._cache_items > 0:
            if i in self._cache:
                img, label = self._cache.pop(i)
            else:
                img, label = self._load_raw(i)
                while len(self._cache) >= self._cache_items:
                    self._cache.pop(next(iter(self._cache)))
            self._cache[i] = (img, label)
        else:
            img, label = self._load_raw(i)
        if self.crop_size is not None:
            img, label = paired_random_crop(img, label, self.crop_size, rng)
            if img.max() > 10:
                img = img / 255.0
        t1 = time.perf_counter()
        if isinstance(img, torch.Tensor):
            image = img.contiguous()
        else:
            image = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
            image = image.to(self.image_dtype) if self.image_dtype != torch.float32 else image
        mask = torch.from_numpy((np.asarray(label) > 0).astype(np.float32)[..., None])
        return {"image": image, "mask": mask, "index": entry.name, "label": entry.label,
                "timing": {"read": t1 - t0, "cast": time.perf_counter() - t1}}


def paired_random_crop(img, label: np.ndarray, size: Tuple[int, int],
                       rng: np.random.Generator):
    """Crop image and mask with one shared offset drawn from `rng`; zero-pads
    at the bottom and right first when the image is smaller than the crop
    (dataset.py:201-220). The image is a numpy array or a torch tensor."""
    th, tw = size
    h, w = img.shape[:2]
    if h < th or w < tw:
        ph, pw = max(0, th - h), max(0, tw - w)
        if isinstance(img, torch.Tensor):
            img = torch.nn.functional.pad(img, (0, 0, 0, pw, 0, ph))
        else:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        label = np.pad(label, ((0, ph), (0, pw)))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - th + 1))
    left = int(rng.integers(0, w - tw + 1))
    return img[top:top + th, left:left + tw], label[top:top + th, left:left + tw]
