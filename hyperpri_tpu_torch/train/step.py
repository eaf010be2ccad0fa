"""The training step (port of hyperpri_tpu/train/trainer.py:68-82 `make_optimizer`
and :168-226 `make_train_step`).

A batch is a dict of tensors on the model's device: `image` (N, H, W, bands),
`mask` (N, H, W, 1) of 0/1 targets and `valid` (N,), which is 0 for padding
entries of a fixed-size batch. The loss is the masked BCE-with-logits of
serve.py; parameters and BatchNorm statistics are float32, the model computes
in its `dtype`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from hyperpri_tpu_torch._device import resolve_device
from hyperpri_tpu_torch.models.cubenet import CubeNET
from hyperpri_tpu_torch.models.unet import UNet
from hyperpri_tpu_torch.serve import FIRST_DEPTH, HSI_DEPTH, batch_stats_metrics, masked_bce


def make_optimizer(model: nn.Module, optimizer: str = "ADAM", learn_rate: float = 1e-3,
                   momentum: float = 0.9, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam or SGD as the reference selects them. torch.optim.Adam's defaults
    are optax.adam's (b1 0.9, b2 0.999, eps 1e-8 outside the root), and
    `weight_decay` is the coupled L2 term added to the gradient, for both."""
    name = optimizer.upper()
    if name == "ADAM":
        return torch.optim.Adam(model.parameters(), lr=learn_rate, weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(model.parameters(), lr=learn_rate, momentum=momentum,
                               weight_decay=weight_decay)
    raise ValueError(f"Unknown Optimizer name: {name}")


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    threshold: float = 0.5, return_logits: bool = False, ingest_hw=None
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, object]]:
    """-> step(batch) -> {"loss_sum": loss * n_valid, "n": n_valid, "stats":
    StatScores of sigmoid(logits) > threshold} (and "logits" on request). One
    call runs the model's training form, the backward and the optimizer
    update; the BatchNorm running statistics move in place. `ingest_hw`:
    logical (h, w) when the batch's image is the host pre-padded ingest
    buffer (CubeNET.ingest_spec)."""

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["image"], train=True, ingest_hw=ingest_hw)
        loss = masked_bce(logits, batch["mask"], batch["valid"])
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            logits = logits.detach()
            stats = batch_stats_metrics(logits, batch["mask"], batch["valid"], threshold)
            n_valid = batch["valid"].sum()
            logs = {"loss_sum": loss.detach() * n_valid, "n": n_valid, "stats": stats}
        if return_logits:
            logs["logits"] = logits
        return logs

    return train_step


def _trainer(model: nn.Module, device: torch.device, optimizer: str, learn_rate: float,
             threshold: float, return_logits: bool):
    model = model.to(device)
    opt = make_optimizer(model, optimizer, learn_rate)
    return model, opt, make_train_step(model, opt, threshold, return_logits)


def build_cubenet_trainer(seed: int = 0, device=None, use_kernels: bool = True,
                          dtype=torch.bfloat16, optimizer: str = "ADAM",
                          learn_rate: float = 1e-3, threshold: float = 0.5,
                          return_logits: bool = False):
    """CubeNET-64 with flax's init drawn from `seed`, on `device` (None: the
    CUDA card, raising without one), with its optimizer and train step:
    -> (model, optimizer, step). `use_kernels` sends the gated 3x3 convs and
    the pool backwards through the CUDA kernels."""
    device = resolve_device(device)
    model = CubeNET(HSI_DEPTH, 1, FIRST_DEPTH, use_kernels=use_kernels, dtype=dtype,
                    generator=torch.Generator().manual_seed(seed))
    return _trainer(model, device, optimizer, learn_rate, threshold, return_logits)


def build_unet_trainer(seed: int = 0, device=None, use_kernels: bool = True,
                       dtype=torch.float32, optimizer: str = "ADAM", learn_rate: float = 1e-3,
                       threshold: float = 0.5, return_logits: bool = False):
    """UNET on RGB (3 channels, bilinear=False, one class: the configuration's
    defaults) with flax's init drawn from `seed`, as build_cubenet_trainer:
    -> (model, optimizer, step)."""
    device = resolve_device(device)
    model = UNet(3, 1, bilinear=False, use_kernels=use_kernels, dtype=dtype,
                 generator=torch.Generator().manual_seed(seed))
    return _trainer(model, device, optimizer, learn_rate, threshold, return_logits)
