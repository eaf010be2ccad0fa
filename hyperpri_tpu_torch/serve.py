"""Serving: the folded bf16 CubeNET-64 or UNET answering request batches.

Ports the eval pieces of hyperpri_tpu/train/trainer.py: `masked_bce` and
`_batch_stats_metrics` (:118-146), `make_eval_step` (:229-246) and the
logits `predict` hands back (:652-664).

A request batch is a dict of tensors on the model's device: `image`
(N, H, W, 238) for CubeNET-64 or (N, H, W, 3) for UNET, `mask` (N, H, W, 1)
of 0/1 targets and `valid` (N,), which is 0 for padding entries of a
fixed-size batch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from hyperpri_tpu_torch._device import resolve_device
from hyperpri_tpu_torch.models.cubenet import CubeNET
from hyperpri_tpu_torch.models.parts import TorchBatchNorm
from hyperpri_tpu_torch.models.unet import UNet
from hyperpri_tpu_torch.ops.fold_bn import fold_batch_norm
from hyperpri_tpu_torch.ops.losses import bce_with_logits
from hyperpri_tpu_torch.ops.metrics import StatScores
from hyperpri_tpu_torch.parallel.mesh import DATA_AXIS

HSI_DEPTH = 238
FIRST_DEPTH = 64
RGB_CHANNELS = 3
THRESHOLD = 0.5


def _squeeze_last(*tensors):
    """Drop a trailing size-1 channel axis (trainer.py:118-128)."""
    return tuple(t[..., 0] if t.dim() >= 3 and t.shape[-1] == 1 else t for t in tensors)


def masked_bce(logits: torch.Tensor, targets: torch.Tensor,
               valid: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean BCE over the valid samples only (trainer.py:131-139). Under a
    mesh (parallel/mesh.Mesh) the arguments are this rank's samples and rows
    and the result is this rank's share of the global mean: its sum over the
    global count of valid samples times pixels, so that the shares (and
    their gradients) sum to the single device's."""
    logits, targets = _squeeze_last(logits, targets)
    per = bce_with_logits(logits, targets, reduction="none")
    w = valid.reshape((-1,) + (1,) * (per.dim() - 1)).float()
    n_valid, pixels = w.sum(), math.prod(per.shape[1:])
    if mesh is not None:
        n_valid = mesh.all_reduce_(n_valid.detach().clone(), (DATA_AXIS,))
        pixels *= mesh.spatial
    denom = torch.clamp_min(n_valid * pixels, 1.0)
    return (per * w).sum() / denom


def step_logs(loss: torch.Tensor, logits: torch.Tensor, batch: Dict[str, torch.Tensor],
              threshold: float, mesh=None) -> Dict[str, object]:
    """{"loss_sum": loss * n_valid, "n": n_valid, "stats": StatScores at
    `threshold`} of a step (trainer.py:219-225). Under a mesh `loss` is
    this rank's share (masked_bce), the counts are this rank's, and all of
    it is reduced in one collective over the mesh: n counts each sample
    once (spatial peers hold the same samples' rows)."""
    stats = batch_stats_metrics(logits, batch["mask"], batch["valid"], threshold)
    n_valid = batch["valid"].sum()
    loss = loss.detach()
    if mesh is not None:
        own = n_valid if mesh.coordinate[1] == 0 else torch.zeros_like(n_valid)
        packed = torch.stack([loss.double(), own.double(), *(c.double() for c in stats)])
        mesh.all_reduce_(packed)
        loss, n_valid = packed[0].to(loss.dtype), packed[1].to(n_valid.dtype)
        stats = StatScores(*(v.to(c.dtype) for v, c in zip(packed[2:], stats)))
    return {"loss_sum": loss * n_valid, "n": n_valid, "stats": stats}


def batch_stats_metrics(logits: torch.Tensor, mask: torch.Tensor, valid: torch.Tensor,
                        threshold: float) -> StatScores:
    """Confusion counts of sigmoid(logits) > threshold over valid samples
    (trainer.py:142-146)."""
    logits, mask = _squeeze_last(logits, mask)
    v = valid.reshape((-1,) + (1,) * (mask.dim() - 1)) > 0
    return StatScores.zeros(logits.device).update(torch.sigmoid(logits), mask,
                                                  threshold, valid=v)


def _seed_batch_norms(model: nn.Module, g: torch.Generator) -> nn.Module:
    """Seeded BatchNorm affines and running statistics, so that folding them
    is not close to the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.empty(n).uniform_(0.8, 1.2, generator=g))
                m.bias.copy_(torch.empty(n).normal_(0.0, 0.1, generator=g))
                m.running_mean.copy_(torch.empty(n).normal_(0.0, 0.2, generator=g))
                m.running_var.copy_(torch.empty(n).uniform_(0.5, 2.0, generator=g))
    return model


def random_cubenet(seed: int, dtype=torch.bfloat16) -> CubeNET:
    """Unfolded CubeNET-64 on the CPU with weights drawn from `seed`: flax's
    init for the convs, then seeded BatchNorm affines and running statistics."""
    g = torch.Generator().manual_seed(seed)
    return _seed_batch_norms(CubeNET(HSI_DEPTH, 1, FIRST_DEPTH, dtype=dtype, generator=g), g)


def random_unet(seed: int, dtype=torch.bfloat16) -> UNet:
    """Unfolded UNET on RGB (3 channels, one class, ConvTranspose upsampling
    as the configuration trains it) on the CPU with weights drawn from
    `seed`, as random_cubenet."""
    g = torch.Generator().manual_seed(seed)
    return _seed_batch_norms(UNet(RGB_CHANNELS, 1, False, dtype=dtype, generator=g), g)


class Server:
    """Answers request batches with one model, CubeNET or UNet
    (`make_eval_step` semantics: the counts threshold sigmoid(logits) at 0.5,
    as validation does)."""

    def __init__(self, model: nn.Module):
        self.model = model.eval()

    @torch.inference_mode()
    def serve(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """-> {"logits": (N, H, W, 1) f32, "loss_sum", "n", "stats": StatScores}."""
        logits = self.model(batch["image"])
        loss = masked_bce(logits, batch["mask"], batch["valid"])
        stats = batch_stats_metrics(logits, batch["mask"], batch["valid"], THRESHOLD)
        n = batch["valid"].sum()
        return {"logits": logits, "loss_sum": loss * n, "n": n, "stats": stats}


def _server(model: nn.Module, fold, device: torch.device, folded: bool) -> Server:
    """`model` on `device`, or with `folded` its BatchNorm-folded twin
    `fold()` loaded with its folded state dict."""
    if folded:
        state = fold_batch_norm(model.state_dict())
        model = fold()
        model.load_state_dict(state, strict=True)
    return Server(model.to(device))


def build_cubenet_server(seed: int = 0, device=None, folded: bool = True,
                         use_kernels: bool = True, dtype=torch.bfloat16) -> Server:
    """CubeNET-64 with random weights from `seed`, on `device` (None: the CUDA
    card, raising without one). `folded` serves the BatchNorm-folded model,
    whose full-resolution narrow convs take the conv3x3_packed kernel when
    `use_kernels`; unfolded, it is the plain eval model."""
    device = resolve_device(device)
    return _server(random_cubenet(seed, dtype),
                   lambda: CubeNET(HSI_DEPTH, 1, FIRST_DEPTH, fused_bn=True,
                                   use_kernels=use_kernels, dtype=dtype), device, folded)


def build_unet_server(seed: int = 0, device=None, folded: bool = True,
                      use_kernels: bool = True, dtype=torch.bfloat16) -> Server:
    """UNET on RGB with random weights from `seed`, as build_cubenet_server:
    folded, its full-resolution narrow convs take the conv3x3_packed kernel
    when `use_kernels` (inc.conv2, up4.conv1 and up4.conv2 at 608x968)."""
    device = resolve_device(device)
    return _server(random_unet(seed, dtype),
                   lambda: UNet(RGB_CHANNELS, 1, False, fused_bn=True,
                                use_kernels=use_kernels, dtype=dtype), device, folded)
