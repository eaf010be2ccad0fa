"""Model factory and naming (port of hyperpri_tpu/models/registry.py).

CubeNET is ported; UNET and SpectralUNET raise until their slices land.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch.models.cubenet import CubeNET


def initialize_model(model_name: str, num_classes: int, network_parameters: Mapping[str, Any],
                     analyze: bool = False, dtype: torch.dtype = torch.float32,
                     seed: Optional[int] = None) -> nn.Module:
    """Name -> model on the CPU, with flax's init drawn from `seed` (torch's
    default generator when None). The kernel route (`pallas_train`) is taken
    only by a bf16 model: the CUDA kernels take bf16 inputs. A float32 model
    with `pallas_train` runs every conv on F.conv2d, and `describe_route`,
    which the Trainer prints, says so."""
    name = model_name.lower()
    if name in ("unet", "unet+", "spectralunet"):
        raise NotImplementedError(f"{model_name} is not ported yet (ROADMAP slices D/E); "
                                  "the port has CubeNET")
    if name != "cubenet":
        raise RuntimeError(f"Invalid model: {model_name!r}")
    if analyze or network_parameters.get("use_attention", False):
        raise NotImplementedError("CubeNET's analyze and use_attention options are not "
                                  "ported yet")
    depth = network_parameters["hsi_hi"] - network_parameters["hsi_lo"]
    use_kernels = network_parameters.get("pallas_train", False) and dtype == torch.bfloat16
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    return CubeNET(hsi_depth=depth, n_classes=num_classes,
                   first_depth=network_parameters["3d_featmaps"],
                   bilinear=network_parameters.get("bilinear", True), use_kernels=use_kernels,
                   dtype=dtype, generator=generator)


def describe_route(model: nn.Module, pallas_train: bool) -> str:
    """Which convs `model` runs, for the log, and why when `pallas_train`
    asked for the kernels and the model's dtype turned them down."""
    dtype = getattr(model, "dtype", None)
    name = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(dtype, str(dtype))
    if any(getattr(m, "use_kernels", False) for m in model.modules()):
        return f"{name}: gated 3x3 convs on the CUDA kernels"
    if pallas_train:
        return (f"{name}: every conv on F.conv2d, although pallas_train is set: the CUDA "
                "kernels take bf16 inputs only (precision 'bf16', --precision bf16, for them)")
    return f"{name}: every conv on F.conv2d (pallas_train off)"


def translate_load_dir(model_name: str, net_params: Mapping[str, Any]) -> str:
    """Model name -> save-directory string (the JAX package's config form)."""
    name = model_name.lower()
    if name == "spectralunet":
        return f"{model_name}_{net_params['spectral_bn_size']}"
    if name == "cubenet":
        return f"{model_name}_{net_params['3d_featmaps']}"
    if name in ("unet", "unet+"):
        return model_name
    raise ValueError(f"{model_name} is not in list of possible models "
                     "(accepted: UNET, UNET+, SpectralUNET, CubeNET)")


def count_params(model: nn.Module) -> int:
    """Learnable parameters (BatchNorm running statistics are buffers)."""
    return sum(p.numel() for p in model.parameters())
