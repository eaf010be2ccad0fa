"""Inference-time BatchNorm folding (port of hyperpri_tpu/ops/fold_bn.py:27-63).

At eval, BatchNorm is the affine y = (x - mean) / sqrt(var + eps) * scale + bias,
which folds into the conv (or linear layer) that feeds it:

    k' = k * (scale / sqrt(var + eps))        (on the output channels)
    b' = (b - mean) * scale / sqrt(var + eps) + bias

Works on the unfolded model's state dict and returns the state dict of its
`fused_bn=True` twin. Pairing is by name, as in the JAX package: conv1->bn1,
conv2->bn2, first_conv->first_bn, inc2_conv->inc2_bn, linear->bn.
"""

from __future__ import annotations

from typing import Dict

import torch

from hyperpri_tpu_torch.models.parts import BN_EPS

_PAIRS = {
    "conv1": "bn1",
    "conv2": "bn2",
    "first_conv": "first_bn",
    "inc2_conv": "inc2_bn",
    "linear": "bn",
}


def fold_batch_norm(state_dict: Dict[str, torch.Tensor],
                    eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Unfolded state dict -> folded state dict, in float32 arithmetic."""
    modules: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        modules.setdefault(prefix, {})[leaf] = value
    partner = {}
    for prefix in modules:
        parent, dot, name = prefix.rpartition(".")
        bn = _PAIRS.get(name)
        if bn is not None and f"{parent}{dot}{bn}" in modules:
            partner[prefix] = f"{parent}{dot}{bn}"
    consumed = set(partner.values())
    folded: Dict[str, torch.Tensor] = {}
    for prefix, leaves in modules.items():
        if prefix in consumed:
            continue
        if prefix not in partner:
            folded.update({f"{prefix}.{leaf}": v for leaf, v in leaves.items()})
            continue
        bn = modules[partner[prefix]]
        scale = bn["weight"].float() / torch.sqrt(bn["running_var"].float() + eps)
        kernel = leaves["weight"]
        shape = (-1,) + (1,) * (kernel.dim() - 1)  # output channels lead in torch
        folded[f"{prefix}.weight"] = (kernel.float() * scale.reshape(shape)).to(kernel.dtype)
        bias = leaves["bias"].float() if "bias" in leaves else 0.0
        folded[f"{prefix}.bias"] = (bias - bn["running_mean"].float()) * scale + bn["bias"].float()
    return folded
