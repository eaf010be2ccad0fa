"""Experiment configuration layer, config-as-factory (port of
hyperpri_tpu/config.py).

Attribute names, defaults and the path templates are the JAX package's:
  Saved_Models/{dataset}/{model_param_str}/Run_{run_num}/   (run_num = 10*seed + split)
  Saved_Models/{dataset}/Val_Segmentation_Maps/Run_{run_num}/{model_param_str}/
Differences: `device` defaults to 'cuda' ('cpu' on request); `precision`
'fp32' (the default, as in the JAX package) or 'bf16' is the model's compute
dtype, and with `pallas_train` the gated 3x3 convs and pool backwards run the
CUDA kernels in that dtype (float32 by 3xTF32 products). At fp32 the host
pre-padded ingest buffer of CubeNET is float32 too (2x610x970x256 floats,
about 1.2 GB of pinned host memory at full resolution). The JAX package's
mesh, ZeRO, offload, chunked-accumulation, orbax and profiling options are
kept as fields so configurations read the same: `mesh_shape`,
`zero_shard_opt` and `offload_opt_state` run multi-device training
(train/trainer.py, parallel/), `orbax_under_mesh` changes no format (the
port's checkpoints are torch.save files under a mesh too), and the Trainer
refuses the options this port does not have yet (feature extraction,
comet_logging).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from hyperpri_tpu_torch.data.dataset import HyperpriDataset
from hyperpri_tpu_torch.models.registry import initialize_model, translate_load_dir


@dataclass
class ExperimentConfig:
    """Shared experiment parameters; see subclasses for per-dataset defaults."""

    calling_path: str = "."
    split_no: int = 1
    seed_num: int = 0
    augment: bool = False
    comet_logging: bool = False  # the offline Comet archive: not ported, the Trainer refuses it

    # Basic definitions
    dataset: str = "RGB"
    b_size: Dict[str, int] = field(default_factory=lambda: {"train": 2, "val": 2, "test": 1})
    device: str = "cuda"
    epochs: int = 2000

    # Dataset definitions
    patch_size: Tuple[int, int] = (608, 968)
    color_mode: str = "rgb"
    channels: int = 3
    rescale: int = 1
    rotate: bool = False
    num_classes: int = 1
    label_set: Optional[list] = None
    hsi_lo: int = 0
    hsi_hi: int = 299
    cache_items: int = 0  # host-RAM LRU of decoded images/cubes (0 = off)
    # On-disk decoded-cube cache dir (None = off): the decoded (H, W, B) band
    # window in the loader's dtype, read back sequentially by cold processes
    # instead of re-paying the ENVI gather (data/disk_cache.py)
    decoded_cache_dir: Optional[str] = None

    # Model parameters
    model_name: str = "UNET"
    bilinear: bool = False
    feature_extraction: bool = False
    use_attention: bool = False
    use_pretrained: bool = False
    spectral_bn_size: int = 1650
    cube_featmaps: int = 64
    mlp_layers: tuple = ()
    test_deepspeed: Optional[bool] = None

    # Optimizer
    criterion: str = "bce_with_logits"
    optimizer: str = "adam"
    learn_rate: float = 0.001
    weight_decay: float = 0.0
    momentum: float = 0.9

    # Metrics
    task: str = "binary"
    threshold: float = 0.5

    # Early stopping (patience on val_loss, epochs)
    consecutive: Optional[int] = None
    overall: int = 500

    # Execution
    precision: str = "fp32"  # 'fp32' | 'bf16'
    remat: bool = False
    offload: bool = False
    grad_accum_chunks: int = 0
    pallas_train: bool = True  # the kernel route for the full-resolution convs
    mesh_shape: Optional[Dict[str, int]] = None  # {"data": d, "spatial": s} over the world
    zero_shard_opt: bool = False  # Adam moments sharded over 'data'
    offload_opt_state: bool = False  # Adam moments in pinned host memory between steps
    profile_dir: Optional[str] = None  # torch.profiler trace of one post-warm-up epoch
    orbax_under_mesh: bool = True  # no effect: one checkpoint format with or without a mesh

    def __post_init__(self):
        self.run_num = 10 * self.seed_num + self.split_no
        self.data_dir = f"{self.calling_path}/Datasets/HyperPRI"
        self.json_dir = {
            "train": f"{self.data_dir}/data_splits/train{self.split_no}.json",
            "val": f"{self.data_dir}/data_splits/val{self.split_no}.json",
            "test": f"{self.data_dir}/data_splits/val{self.split_no}.json",
        }
        self._refresh_paths()

    def _refresh_paths(self):
        self.model_param_str = self.translate_load_dir()
        self.save_path = (f"{self.calling_path}/Saved_Models/{self.dataset}/"
                          f"{self.model_param_str}/Run_{self.run_num}/")
        self.fig_dir = (f"{self.calling_path}/Saved_Models/{self.dataset}/"
                        f"Val_Segmentation_Maps/Run_{self.run_num}/{self.model_param_str}/")

    def translate_load_dir(self) -> str:
        return translate_load_dir(self.model_name, self.network_parameters())

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    def network_parameters(self) -> Dict[str, Any]:
        return {
            "channels": self.channels,
            "bilinear": self.bilinear,
            "feature_extraction": self.feature_extraction,
            "use_attention": self.use_attention,
            "hsi_lo": self.hsi_lo,
            "hsi_hi": self.hsi_hi,
            "spectral_bn_size": self.spectral_bn_size,
            "3d_featmaps": self.cube_featmaps,
            "remat": self.remat,
            "offload": self.offload,
            "pallas_train": self.pallas_train,
        }

    def get_network(self, seed: Optional[int] = None):
        """The model, with flax's init drawn from `seed` (run_num by default)."""
        return initialize_model(self.model_name, self.num_classes, self.network_parameters(),
                                dtype=self.compute_dtype,
                                seed=self.run_num if seed is None else seed)

    def _dataset(self, split: str, crop: Optional[Tuple[int, int]]) -> HyperpriDataset:
        mode = "HSI" if self.dataset.upper() == "HSI" else self.color_mode
        return HyperpriDataset(
            root=self.data_dir,
            mode=mode,
            crop_size=crop,
            subset=self.label_set,
            hsi_lo=self.hsi_lo if mode.lower() == "hsi" else 0,
            hsi_hi=self.hsi_hi if mode.lower() == "hsi" else 0,
            json_file=self.json_dir.get(split),
            seed=self.run_num,
            cache_items=self.cache_items,
            decoded_cache_dir=self.decoded_cache_dir,
        )

    def get_train_data(self) -> HyperpriDataset:
        crop = self.patch_size if self.augment or self.dataset.upper() == "RGB" else None
        return self._dataset("train", crop)

    def get_val_data(self) -> HyperpriDataset:
        return self._dataset("val", None)

    def get_test_data(self) -> HyperpriDataset:
        return self._dataset("test", None)

    def change_network_param(self, new_model_name: str, calling_path: str, split_no: int,
                             seed_num: int = 0, model_params: Optional[Dict[str, Any]] = None):
        """Swap the model (and optionally other attributes) on the fly and
        recompute run_num and the path templates (config.py:202-219)."""
        if model_params is not None:
            for k, v in model_params.items():
                if getattr(self, k, None) is not None:
                    setattr(self, k, v)
        self.calling_path = calling_path
        self.run_num = 10 * seed_num + split_no
        self.model_name = new_model_name
        self._refresh_paths()


@dataclass
class ExpRedGreenBluePRI(ExperimentConfig):
    """RGB experiment defaults."""

    dataset: str = "RGB"
    color_mode: str = "rgb"
    model_name: str = "UNET"
    b_size: Dict[str, int] = field(default_factory=lambda: {"train": 2, "val": 2, "test": 1})

    def __post_init__(self):
        self.channels = 3 if self.color_mode.lower() != "gray" else 1
        super().__post_init__()


@dataclass
class ExpHyperspectralPRI(ExperimentConfig):
    """HSI experiment defaults."""

    dataset: str = "HSI"
    model_name: str = "CubeNET"
    hsi_lo: int = 25
    hsi_hi: int = 263
    channels: int = 238
    b_size: Dict[str, int] = field(default_factory=lambda: {"train": 2, "val": 2, "test": 2})
    test_deepspeed: Optional[bool] = False

    def __post_init__(self):
        self.channels = self.hsi_hi - self.hsi_lo
        super().__post_init__()


def resolve_criterion(name: str):
    from hyperpri_tpu_torch.ops.losses import bce_with_logits

    if name in ("bce_with_logits", "bce", "BCEWithLogitsLoss"):
        return bce_with_logits
    raise ValueError(f"unknown criterion {name!r}")
