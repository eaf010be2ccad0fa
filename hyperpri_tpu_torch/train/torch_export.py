"""Export a port model as a reference-keyed PyTorch state dict (port of
hyperpri_tpu/train/torch_export.py:40 `export_state_dict`).

The inverse of train/torch_import.py: the model's flax-path trees
(weights.export_flax_trees) become tensors keyed exactly like the
reference's architectures (`inc.double_conv.0.weight`,
`down1.maxpool_conv.1.double_conv.*`, `first_conv.weight` as a Conv3d, ...),
so that the reference's models, and torch_import, read them. Layout
transforms, each the inverse of torch_import.convert_state_dict's:

  flax Conv kernel (kh, kw, I, O)      -> torch Conv2d  (O, I, kh, kw)
  flax Conv kernel (kh, kw, D, O)      -> torch Conv3d  (O, 1, D, kh, kw)
  flax ConvTranspose kernel            -> torch ConvT2d (I, O, kh, kw),
    (kh, kw, I, O), unflipped             spatially flipped
  flax Dense kernel (I, O)             -> torch Linear  (O, I)
  flax BN scale/bias + batch_stats     -> torch BN weight/bias/running_*
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from hyperpri_tpu_torch.train.torch_import import module_map
from hyperpri_tpu_torch.weights import export_flax_trees


def _get(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def export_state_dict(model: nn.Module, model_name: str, cfg=None) -> Dict[str, torch.Tensor]:
    """The model's parameters and BatchNorm statistics as a reference-keyed
    state dict of float32 CPU tensors, with the bare-module keys of the
    reference's `model.state_dict()` (no 'm_network.' wrapper;
    torch_import.normalize_torch_keys reads the wrapped forms too)."""
    trees = export_flax_trees(model)
    params, batch_stats = trees["params"], trees["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for flax_path, (tprefix, kind) in module_map(model_name, cfg).items():
        node = _get(params, flax_path)
        if kind == "conv":
            sd[f"{tprefix}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
        elif kind == "conv3d":
            sd[f"{tprefix}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1))[:, None])
        elif kind == "convT":
            sd[f"{tprefix}.weight"] = _t(np.transpose(node["kernel"][::-1, ::-1], (2, 3, 0, 1)))
        elif kind == "linear":
            sd[f"{tprefix}.weight"] = _t(node["kernel"].T)
        elif kind == "bn":
            stats = _get(batch_stats, flax_path)
            sd[f"{tprefix}.weight"] = _t(node["scale"])
            sd[f"{tprefix}.bias"] = _t(node["bias"])
            sd[f"{tprefix}.running_mean"] = _t(stats["mean"])
            sd[f"{tprefix}.running_var"] = _t(stats["var"])
            sd[f"{tprefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            continue
        else:  # pragma: no cover
            raise ValueError(kind)
        sd[f"{tprefix}.bias"] = _t(node["bias"])
    return sd
