"""Model factory and naming (port of hyperpri_tpu/models/registry.py).

UNET, UNET+ (UNET with `use_attention`: each Up merges by skip * x),
SpectralUNET and CubeNET (which also takes `use_attention`); `analyze`
builds UNET or CubeNET returning (logits, logits, sigmoid(logits)).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch.models.cubenet import CubeNET
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET
from hyperpri_tpu_torch.models.unet import UNet


def initialize_model(model_name: str, num_classes: int, network_parameters: Mapping[str, Any],
                     analyze: bool = False, dtype: torch.dtype = torch.float32,
                     seed: Optional[int] = None) -> nn.Module:
    """Name -> model on the CPU, with flax's init drawn from `seed` (torch's
    default generator when None). `pallas_train` sends the gated 3x3 convs
    and the pool backwards through the CUDA kernels, which take bf16 and
    float32 inputs; `describe_route`, which the Trainer prints, says which.
    SpectralUNET has no kernel route (its Dense layers are matrix products)
    and reads `remat` and `offload`."""
    name = model_name.lower()
    if name not in ("unet", "unet+", "spectralunet", "cubenet"):
        raise RuntimeError(f"Invalid model: {model_name!r}")
    use_attention = name != "spectralunet" and (
        network_parameters.get("use_attention", False) or name == "unet+")
    use_kernels = network_parameters.get("pallas_train", False)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    if name == "spectralunet":
        depth = network_parameters["hsi_hi"] - network_parameters["hsi_lo"]
        return SpectralUNET(hsi_depth=depth, n_classes=num_classes,
                            bn_feats=network_parameters["spectral_bn_size"],
                            remat=network_parameters.get("remat", False),
                            offload=network_parameters.get("offload", False), dtype=dtype,
                            generator=generator)
    if name in ("unet", "unet+"):
        return UNet(n_channels=network_parameters["channels"], n_classes=num_classes,
                    bilinear=network_parameters.get("bilinear", True),
                    use_attention=use_attention, analyze=analyze, use_kernels=use_kernels,
                    dtype=dtype, generator=generator)
    depth = network_parameters["hsi_hi"] - network_parameters["hsi_lo"]
    return CubeNET(hsi_depth=depth, n_classes=num_classes,
                   first_depth=network_parameters["3d_featmaps"],
                   bilinear=network_parameters.get("bilinear", True),
                   use_attention=use_attention, analyze=analyze, use_kernels=use_kernels,
                   dtype=dtype, generator=generator)


def describe_route(model: nn.Module, pallas_train: bool) -> str:
    """Which convs `model` runs, for the log."""
    dtype = getattr(model, "dtype", None)
    name = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(dtype, str(dtype))
    if isinstance(model, SpectralUNET):
        return f"{name}: Dense layers on torch.matmul (no kernel route)"
    attention = (", skip*x merges (use_attention)"
                 if any(getattr(m, "use_attention", False) for m in model.modules()) else "")
    if any(getattr(m, "use_kernels", False) for m in model.modules()):
        products = "3xTF32" if dtype == torch.float32 else "bf16"
        return (f"{name}: gated 3x3 convs on the CUDA kernels ({products} products), and "
                f"the even pools' backwards; the rest on F.conv2d{attention}")
    why = "although pallas_train is set" if pallas_train else "pallas_train off"
    return f"{name}: every conv on F.conv2d ({why}){attention}"


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
