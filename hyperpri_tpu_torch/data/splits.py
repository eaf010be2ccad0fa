"""HyperPRI data-split parsing (JSON box/date schema + CSV mirrors); the
port's copy of hyperpri_tpu/data/splits.py.

Parity target: the reference's src/dataset.py:160-244 (_parse_json_file) and
the shipped split files Datasets/HyperPRI/data_splits/{train,val}{1..5}.json.

Schema: top-level `img_dir` / `hsi_dir` / `mask_dir` strings plus
`boxNN: {plant_folder, resolution, box_no, phenotype, dates[], weights}`.
File layout on disk:
  {root}/{plant_folder}_{resolution}/{img_dir}/{date}_{box}_ref.png
  {root}/{plant_folder}_{resolution}/{hsi_dir}/{date}_{box}_ref.dat (+ shared hinalea_hsi.hdr)
  {root}/{plant_folder}_{resolution}/{mask_dir}/{date}_{box}_ref_mask.png
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_CLASS_LIST = ["Peanut", "SweetCorn"]


@dataclass(frozen=True)
class SplitEntry:
    """One (image, mask[, cube]) example resolved from a split file."""

    name: str  # e.g. "20220624_box33_ref"
    img: str
    label: str
    hdr: Optional[str] = None
    dat: Optional[str] = None
    box: str = ""
    plant_folder: str = ""
    phenotype: Optional[int] = None
    date: str = ""


@dataclass
class SplitIndex:
    entries: List[SplitEntry] = field(default_factory=list)
    class_count: Dict[str, int] = field(default_factory=dict)

    def __len__(self):
        return len(self.entries)

    def sample_weights(self, class_list: List[str]) -> List[float]:
        """Inverse-frequency sample weights, matching dataset.py:76-82:
        weight(class) = max_count / count, laid out per entry in class-block
        order. (The reference computes these but never consumes them; kept
        for API parity and for optional weighted sampling.)"""
        counts = [self.class_count.get(c, 0) for c in class_list]
        mx = max(counts) if counts else 0
        weights = []
        for entry in self.entries:
            cnt = self.class_count.get(entry.plant_folder, 0)
            weights.append(0.0 if cnt == 0 else mx / cnt)
        return weights


def parse_split_json(
    json_path: str,
    root: str,
    mode: str = "rgb",
    class_list: Optional[List[str]] = None,
    require_exists: bool = True,
    verbose: bool = False,
) -> SplitIndex:
    """Resolve a split JSON into concrete file paths.

    Missing files are skipped (with an optional note), matching the
    reference's tolerance of partially present data (dataset.py:208-212,
    227-229). Boxes without dates or non-`boxNN` keys are ignored.
    """
    class_list = class_list or DEFAULT_CLASS_LIST
    with open(json_path) as f:
        spec = json.load(f)

    img_dir_name = spec.get("img_dir", "rgb_files")
    hsi_dir_name = spec.get("hsi_dir", "hsi_files")
    mask_dir_name = spec.get("mask_dir", "mask_files")

    index = SplitIndex(class_count={c: 0 for c in class_list})
    for key, box in spec.items():
        if not key.startswith("box") or not isinstance(box, dict) or not box.get("dates"):
            continue
        plant = box["plant_folder"]
        if plant not in class_list:
            continue
        res = box["resolution"]
        base = os.path.join(root, f"{plant}_{res}")
        img_dir = os.path.join(base, img_dir_name)
        hsi_dir = os.path.join(base, hsi_dir_name)
        mask_dir = os.path.join(base, mask_dir_name)

        for date in box["dates"]:
            name = f"{date}_{key}_ref"
            img = os.path.join(img_dir, f"{name}.png")
            label = os.path.join(mask_dir, f"{name}_mask.png")
            hdr = dat = None
            if mode.lower() == "hsi":
                hdr = os.path.join(hsi_dir, "hinalea_hsi.hdr")
                dat = os.path.join(hsi_dir, f"{name}.dat")
                needed = [label, hdr, dat]
            else:
                needed = [img, label]
            if require_exists and not all(os.path.exists(p) for p in needed):
                if verbose:
                    print(f"{name}: missing one of {needed}; skipping")
                continue
            index.entries.append(
                SplitEntry(
                    name=name,
                    img=img,
                    label=label,
                    hdr=hdr,
                    dat=dat,
                    box=key,
                    plant_folder=plant,
                    phenotype=box.get("phenotype"),
                    date=date,
                )
            )
            index.class_count[plant] += 1
    return index


def parse_split_csv(
    csv_path: str,
    root: str,
    mode: str = "rgb",
    class_list: Optional[List[str]] = None,
    require_exists: bool = True,
) -> SplitIndex:
    """Resolve a CSV split mirror (one `{date}_{box}_ref` basename per line,
    the format shipped next to each JSON in data_splits/*.csv).

    Basenames carry no plant/resolution, so files are located by scanning the
    `{root}/{Plant}_{WxH}/` directories for each name.
    """
    import glob as _glob

    class_list = class_list or DEFAULT_CLASS_LIST
    with open(csv_path) as f:
        names = [line.strip() for line in f if line.strip()]

    plant_dirs = sorted(
        d for d in _glob.glob(os.path.join(root, "*_*")) if os.path.isdir(d)
    )
    index = SplitIndex(class_count={c: 0 for c in class_list})
    for name in names:
        box = name.split("_")[1] if "_" in name else ""
        date = name.split("_")[0]
        for d in plant_dirs:
            plant = os.path.basename(d).rsplit("_", 1)[0]
            if plant not in class_list:
                continue
            img = os.path.join(d, "rgb_files", f"{name}.png")
            label = os.path.join(d, "mask_files", f"{name}_mask.png")
            hdr = os.path.join(d, "hsi_files", "hinalea_hsi.hdr")
            dat = os.path.join(d, "hsi_files", f"{name}.dat")
            needed = [label, hdr, dat] if mode.lower() == "hsi" else [img, label]
            if require_exists and not all(os.path.exists(p) for p in needed):
                continue
            index.entries.append(
                SplitEntry(
                    name=name,
                    img=img,
                    label=label,
                    hdr=hdr if mode.lower() == "hsi" else None,
                    dat=dat if mode.lower() == "hsi" else None,
                    box=box,
                    plant_folder=plant,
                    date=date,
                )
            )
            index.class_count[plant] += 1
            break
    return index


def write_split_json(path: str, boxes: Dict[str, dict], img_dir="rgb_files",
                     hsi_dir="hsi_files", mask_dir="mask_files") -> None:
    """Write a split JSON in the reference schema (test fixtures)."""
    spec = {"img_dir": img_dir, "hsi_dir": hsi_dir, "mask_dir": mask_dir}
    spec.update(boxes)
    with open(path, "w") as f:
        json.dump(spec, f, indent=2)
