"""The training step (port of hyperpri_tpu/train/trainer.py:68-82 `make_optimizer`
and :168-226 `make_train_step`).

A batch is a dict of tensors on the model's device: `image` (N, H, W, bands),
`mask` (N, H, W, 1) of 0/1 targets and `valid` (N,), which is 0 for padding
entries of a fixed-size batch. The loss is the masked BCE-with-logits of
serve.py; parameters and BatchNorm statistics are float32, the model computes
in its `dtype`.

`offload` (SpectralUNET's host-offloaded residuals, the counterpart of
trainer.py:148 `spectral_offload_policy`) runs the forward and the loss under
`save_on_host`: every tensor autograd saves for the backward waits in host
memory (pinned, for a tensor on the card) and comes back for the backward;
the numerics are those of the plain step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn as nn

from hyperpri_tpu_torch._device import resolve_device
from hyperpri_tpu_torch.models.cubenet import CubeNET
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET
from hyperpri_tpu_torch.models.unet import UNet
from hyperpri_tpu_torch.parallel.sharding import sum_gradients
from hyperpri_tpu_torch.serve import FIRST_DEPTH, HSI_DEPTH, masked_bce, step_logs


def make_optimizer(model, optimizer: str = "ADAM", learn_rate: float = 1e-3,
                   momentum: float = 0.9, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam or SGD as the reference selects them, over a model's parameters
    (or a list of tensors: ZeroOptimizer's slices). torch.optim.Adam's
    defaults are optax.adam's (b1 0.9, b2 0.999, eps 1e-8 outside the root),
    and `weight_decay` is the coupled L2 term added to the gradient, for both."""
    params = model.parameters() if isinstance(model, nn.Module) else model
    name = optimizer.upper()
    if name == "ADAM":
        return torch.optim.Adam(params, lr=learn_rate, weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(params, lr=learn_rate, momentum=momentum,
                               weight_decay=weight_decay)
    raise ValueError(f"Unknown Optimizer name: {name}")


class save_on_host(torch.autograd.graph.saved_tensors_hooks):
    """torch.autograd.graph.save_on_cpu(pin_memory=True) with the saved
    tensors' strides kept: each saved tensor is copied to host memory
    (pinned, for a tensor on the card) as it is saved and copied back to
    its device when the backward reads it. save_on_cpu makes every copy
    contiguous, so a transposed view (the weight F.linear saves) came back
    with other strides, the backward's matrix products took other kernels,
    and the offloaded step differed from the plain one in the last bits. A
    tensor whose elements overlap or leave gaps (an expanded or strided
    view) stays where it is."""

    def __init__(self):
        def pack(t: torch.Tensor):
            if t.layout != torch.strided or not _dense(t):
                return t
            pin = t.device.type == "cuda"
            host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, pin_memory=pin)
            host.copy_(t, non_blocking=pin)
            return t.device, host

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            device, host = packed
            return host.to(device, non_blocking=True)

        super().__init__(pack, unpack)


def _dense(t: torch.Tensor) -> bool:
    """True iff t's elements fill a block of memory exactly once, in some
    order of its dimensions (so empty_strided can give a copy its strides)."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


def offload_context(offload: bool):
    """The context a train step runs its forward and loss in: save_on_host
    with `offload`, else nothing."""
    return save_on_host() if offload else contextlib.nullcontext()


def wait_for_offloaded(model: nn.Module, offload: bool):
    """Call after an offloaded backward: wait for the card. The pinned blocks
    of the backward's copies go back to the allocator's cache only once the
    copies are done, and a host that ran ahead would pin the next chunk's
    residuals beside them: eight chunks' worth of SpectralUNET-1650's
    residuals outgrew the host memory of a one-card machine (H100 80GB
    HBM3, 700 W)."""
    device = next(model.parameters()).device
    if offload and device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(model: nn.Module, optimizer, threshold: float = 0.5,
                    return_logits: bool = False, ingest_hw=None, offload: bool = False,
                    mesh=None) -> Callable[[Dict[str, torch.Tensor]], Dict[str, object]]:
    """-> step(batch) -> {"loss_sum": loss * n_valid, "n": n_valid, "stats":
    StatScores of sigmoid(logits) > threshold} (and "logits" on request). One
    call runs the model's training form, the backward and the optimizer
    update; the BatchNorm running statistics move in place. `ingest_hw`:
    logical (h, w) when the batch's image is the host pre-padded ingest
    buffer (CubeNET.ingest_spec). `offload`: offload_context. `mesh`
    (parallel/mesh.Mesh; the model's spatial_mesh): the batch is this rank's
    samples and rows, the loss this rank's share of the global mean, the
    gradients are summed over the mesh before the update (a torch optimizer,
    or parallel/sharding.ZeroOptimizer), and the logs are the mesh's; the
    logits, on request, this rank's."""

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        optimizer.zero_grad(set_to_none=True)
        with offload_context(offload):
            logits = model(batch["image"], train=True, ingest_hw=ingest_hw)
            loss = masked_bce(logits, batch["mask"], batch["valid"], mesh)
        loss.backward()
        wait_for_offloaded(model, offload)
        if mesh is not None:
            sum_gradients(model, mesh)
        optimizer.step()
        with torch.no_grad():
            logits = logits.detach()
            logs = step_logs(loss, logits, batch, threshold, mesh)
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
                       threshold: float = 0.5, return_logits: bool = False,
                       use_attention: bool = False):
    """UNET on RGB (3 channels, bilinear=False, one class: the configuration's
    defaults) with flax's init drawn from `seed`, as build_cubenet_trainer:
    -> (model, optimizer, step). `use_attention` builds UNET+."""
    device = resolve_device(device)
    model = UNet(3, 1, bilinear=False, use_attention=use_attention, use_kernels=use_kernels,
                 dtype=dtype, generator=torch.Generator().manual_seed(seed))
    return _trainer(model, device, optimizer, learn_rate, threshold, return_logits)


def build_spectral_unet_trainer(seed: int = 0, device=None, dtype=torch.float32,
                                n_chunks: int = 0, offload: bool = False,
                                hsi_depth: int = HSI_DEPTH,
                                bn_feats: int = 1650, remat: bool = False,
                                optimizer: str = "ADAM", learn_rate: float = 1e-3,
                                threshold: float = 0.5, return_logits: bool = False):
    """SpectralUNET (bn_feats 1650 over 238 bands: the configuration's
    defaults) with flax's init drawn from `seed`, as build_cubenet_trainer:
    -> (model, optimizer, step). `n_chunks` > 0 takes train/chunked.py's
    step (BatchNorm statistics per chunk of pixels); `offload` keeps the
    saved residuals in host memory (offload_context). The model has no
    kernel route: its Dense layers are matrix products."""
    from hyperpri_tpu_torch.train.chunked import make_chunked_train_step

    device = resolve_device(device)
    model = SpectralUNET(hsi_depth, 1, bn_feats, remat=remat, offload=offload, dtype=dtype,
                         generator=torch.Generator().manual_seed(seed)).to(device)
    opt = make_optimizer(model, optimizer, learn_rate)
    if n_chunks > 0:
        step = make_chunked_train_step(model, opt, threshold, n_chunks, offload=offload)
    else:
        step = make_train_step(model, opt, threshold, return_logits, offload=offload)
    return model, opt, step
