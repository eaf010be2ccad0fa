"""SpectralUNET: a per-pixel spectral MLP with U-Net skip concats (port of
hyperpri_tpu/models/spectral_unet.py:35-130).

Blocks tail, down1-4, up1-4 of Linear -> BatchNorm1d -> ReLU, all `bn_feats`
wide, the skips concatenated inside the up blocks as cat([skip, x]), and the
head `outc`, a Linear over cat([x0, u]): 30,388,051 parameters at
hsi_depth=238, bn_feats=1650.

Input (N, H, W, hsi_depth) NHWC, rasterised to (N*H*W, hsi_depth) rows; output
(N, H, W, n_classes) float32 logits (float64 for a float64 model). BatchNorm
statistics are taken over all the rows of a call, as in the JAX package
(train/chunked.py takes them per chunk). The Dense layers are plain matrix products (F.linear), as the JAX
package leaves them to XLA: no kernel of ops/kernels runs here.

`fused_bn` takes the state dict of ops/fold_bn.py (linear -> bn folded).
`remat` recomputes each block in the backward (torch.utils.checkpoint, the
counterpart of nn.remat); the recompute leaves the running statistics as the
forward left them, as flax discards a recompute's updates. `offload` is read
by the train steps (train/step.py, train/chunked.py), which keep the saved
residuals in pinned host memory across the forward-to-backward gap; with it
the blocks are not rematerialized, as in the JAX package.

`spatial_mesh` (the Trainer sets it under a mesh): each rank runs the pixels
of its samples' rows, and the BatchNorm statistics are all-reduced over the
mesh (models/parts.py TorchBatchNorm). The JAX model has no such attribute:
GSPMD partitions it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hyperpri_tpu_torch.models.parts import TorchBatchNorm, lecun_normal_, stat_float
from hyperpri_tpu_torch.parallel.mesh import Rows


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """nn.Linear with flax Dense's init (lecun_normal kernel, zero bias),
    drawn by reset_parameters."""
    layer = nn.Linear(in_features, out_features)
    _reset_dense(layer)
    return layer


def _reset_dense(layer: nn.Linear, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
        lecun_normal_(layer.weight, layer.in_features, generator)
        layer.bias.zero_()


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax Dense(dtype=...): inputs, kernel and bias in the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class SpectralBlock(nn.Module):
    """[cat(skip, x)] -> Linear -> [BatchNorm] -> ReLU (spectral_unet.py:35-62)."""

    def __init__(self, in_features: int, feats: int, bnorm: bool = True,
                 fused_bn: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = _dense(in_features, feats)
        self.bn = TorchBatchNorm(feats) if bnorm and not fused_bn else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                train: bool = False, rows: Optional[Rows] = None) -> torch.Tensor:
        if skip is not None:
            x = torch.cat([skip, x], dim=-1)
        x = _linear(self.linear, x, self.dtype)
        if self.bn is not None:
            x = self.bn(x, train=train, rows=rows)
        return F.relu(x).to(self.dtype)

    @contextlib.contextmanager
    def keep_running_stats(self):
        """Restore the BatchNorm running statistics on exit: a recompute runs
        the training form again, which would move them a second time."""
        if self.bn is None:
            yield
            return
        saved = [b.clone() for b in self.bn.buffers()]
        try:
            yield
        finally:
            with torch.no_grad():
                for buf, value in zip(self.bn.buffers(), saved):
                    buf.copy_(value)


class SpectralUNET(nn.Module):
    def __init__(self, hsi_depth: int = 238, n_classes: int = 1, bn_feats: int = 16,
                 bnorm: bool = True, remat: bool = False, fused_bn: bool = False,
                 offload: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, spatial_mesh=None):
        super().__init__()
        self.spatial_mesh = spatial_mesh
        self.hsi_depth = hsi_depth
        self.n_classes = n_classes
        self.bn_feats = bn_feats
        self.bnorm = bnorm
        self.remat = remat
        self.fused_bn = fused_bn
        self.offload = offload
        self.dtype = dtype
        f = bn_feats

        def block(in_features):
            return SpectralBlock(in_features, f, bnorm, fused_bn, dtype)

        self.tail = block(hsi_depth)
        self.down1, self.down2, self.down3, self.down4 = (block(f) for _ in range(4))
        self.up1 = block(f)
        self.up2, self.up3, self.up4 = (block(2 * f) for _ in range(3))
        self.outc = _dense(2 * f, n_classes)
        if generator is not None:
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    _reset_dense(m, generator)

    def _rematerialize(self, train: bool) -> bool:
        return train and self.remat and not self.offload and torch.is_grad_enabled()

    def _block(self, block: SpectralBlock, x, skip, train: bool, rows=None):
        if not self._rematerialize(train):
            return block(x, skip, train, rows)
        return checkpoint(block, x, skip, train, rows, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              block.keep_running_stats()))

    def _head(self, u, x0):
        return _linear(self.outc, torch.cat([x0, u], dim=-1), self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False, ingest_hw=None) -> torch.Tensor:
        """`ingest_hw` is accepted and ignored: the host pre-padded ingest is
        CubeNET's, and this model reads logical cubes."""
        if x.shape[-1] != self.hsi_depth:
            raise ValueError(f"SpectralUNET expects {self.hsi_depth} bands (NHWC), got shape "
                             f"{tuple(x.shape)}")
        n, h, w, d = x.shape
        r = None if self.spatial_mesh is None else Rows.of_input(self.spatial_mesh, x)
        p = x.to(self.dtype).reshape(n * h * w, d)
        x0 = self._block(self.tail, p, None, train, r)
        x1 = self._block(self.down1, x0, None, train, r)
        x2 = self._block(self.down2, x1, None, train, r)
        x3 = self._block(self.down3, x2, None, train, r)
        x4 = self._block(self.down4, x3, None, train, r)
        u = self._block(self.up1, x4, None, train, r)
        u = self._block(self.up2, u, x3, train, r)
        u = self._block(self.up3, u, x2, train, r)
        u = self._block(self.up4, u, x1, train, r)
        if self._rematerialize(train):
            out = checkpoint(self._head, u, x0, use_reentrant=False)
        else:
            out = self._head(u, x0)
        return stat_float(out).reshape(n, h, w, self.n_classes)
