"""CubeNET, eval and training forms (port of hyperpri_tpu/models/cubenet.py:39-179).

The reference's Conv3d(1, first_depth, (hsi_depth, 3, 3), padding (0, 1, 1))
over the whole spectral depth is one 3x3 2D conv with `hsi_depth` input
channels, followed by inc2 (conv + BN + ReLU) and a U-Net at C=128:
31,178,881 parameters at hsi_depth=238, first_depth=64, bilinear=False.

Input (N, H, W, hsi_depth) NHWC; output (N, H, W, n_classes) float32
logits (float64 for a float64 model).
With `fused_bn` the model takes the state dict of ops/fold_bn.py and every 3x3
conv is a ServingConv3x3; `use_kernels` (JAX's `use_pallas`) lets those convs
take the conv3x3_packed kernel where `packed_serving_route` allows. Unfolded,
`forward(x, train=True)` is the training form and `use_kernels` (JAX's
`pallas_train`) sends the 3x3 convs that pass Conv3x3's gates through the
trainable kernel convs; `conv_kwargs` reaches every Conv3x3 (the gates).
A training forward may take the host pre-padded ingest buffer (`ingest_hw`,
cubenet.py:50-60 and :97-118; geometry from `ingest_spec`).
`use_attention` merges up1-up4 by skip * x (the first_depth != 64 head keeps
its concat, as in the JAX model); `analyze` returns (logits, logits,
sigmoid(logits)) (cubenet.py:177-179).

`spatial_mesh` (cubenet.py:49; the Trainer sets it under a mesh): the forward
takes this rank's samples and rows of the batch and runs every module on its
shard with the mesh's collectives (models/parts.py); the logits are this
rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch.models.parts import (
    Conv3x3,
    ConvTransposeUp,
    DoubleConv,
    Down,
    OutConv,
    ServingConv3x3,
    TorchBatchNorm,
    Up,
    _Conv,
    conv_bn_relu_eval,
    conv_bn_relu_pair,
    first_conv_ingest_spec,
    stat_float,
    upsample2x_align_corners,
    upsample_to,
)
from hyperpri_tpu_torch.parallel.mesh import Rows


class CubeNET(nn.Module):
    def __init__(self, hsi_depth: int = 238, n_classes: int = 1, first_depth: int = 64,
                 bilinear: bool = False, use_attention: bool = False, analyze: bool = False,
                 fused_bn: bool = False, use_kernels: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, spatial_mesh=None,
                 **conv_kwargs):
        super().__init__()
        self.spatial_mesh = spatial_mesh
        self.hsi_depth = hsi_depth
        self.bilinear = bilinear
        self.fused_bn = fused_bn
        self.analyze = analyze
        self.dtype = dtype
        fd, c = first_depth, 128
        factor = 2 if bilinear else 1
        kw = dict(fused_bn=fused_bn, use_kernels=use_kernels, dtype=dtype, **conv_kwargs)
        up = dict(use_attention=use_attention, **kw)

        if fused_bn:
            self.first_conv = ServingConv3x3(hsi_depth, fd, use_kernels, dtype)
            self.inc2_conv = ServingConv3x3(fd, fd, use_kernels, dtype)
        else:
            self.first_conv = Conv3x3(hsi_depth, fd, dtype, use_kernels, **conv_kwargs)
            self.first_bn = TorchBatchNorm(fd)
            self.inc2_conv = Conv3x3(fd, fd, dtype, use_kernels, **conv_kwargs)
            self.inc2_bn = TorchBatchNorm(fd)
        self.down1 = Down(fd, c, **kw)
        self.down2 = Down(c, c * 2, **kw)
        self.down3 = Down(c * 2, c * 4, **kw)
        self.down4 = Down(c * 4, c * 8 // factor, **kw)
        self.up1 = Up(c * 8, c * 4, bilinear, **up)
        self.up2 = Up(c * 4, c * 2, bilinear, **up)
        self.up3 = Up(c * 2, c, bilinear, **up)
        if fd == 64:
            self.up4 = Up(c, 64 * factor, bilinear, **up)
        else:
            # Alternate head for first_depth != 64 (cubenet.py:162-172):
            # upsample, center-pad, concat [x1, y], DoubleConv -> 64.
            self.up4 = None
            if not bilinear:
                self.upsample4 = ConvTransposeUp(c, 64, dtype)
            self.upconv4 = DoubleConv(fd + 64, 64, 64, **kw)
        self.outc = OutConv(64, n_classes, dtype)
        if generator is not None:
            for m in self.modules():
                if isinstance(m, _Conv):
                    m.reset_parameters(generator)

    def ingest_spec(self, h: int, w: int):
        """The host pre-padded ingest geometry for (h, w) cubes, or None when
        the first conv does not take the packed kernel (parts.py:96-122)."""
        if self.fused_bn:
            return None
        return first_conv_ingest_spec(h, w, self.hsi_depth, self.first_conv.weight.shape[0],
                                      **self.first_conv.gates())

    def forward(self, x: torch.Tensor, train: bool = False, ingest_hw=None):
        """-> float32 logits, or with `analyze` (logits, logits, sigmoid).
        ingest_hw: logical (h, w) when x is the host pre-padded ingest
        buffer of `ingest_spec`, a training-only contract."""
        if self.fused_bn and train:
            raise ValueError("a BatchNorm-folded model serves; it does not train")
        if ingest_hw is not None and not train:
            raise ValueError("pre-padded ingest is a train-step-only contract")
        if ingest_hw is None and x.shape[-1] != self.hsi_depth:
            raise ValueError(f"CubeNET expects {self.hsi_depth} bands (NHWC), "
                             f"got shape {tuple(x.shape)}")
        x = x.to(self.dtype)
        r = [None] * 5   # the mesh.Rows of each level, under a mesh
        if self.spatial_mesh is not None:
            h = x.shape[1] if ingest_hw is None else ingest_hw[0]
            r[0] = Rows(self.spatial_mesh, h * self.spatial_mesh.spatial)
            for k in range(1, 5):
                r[k] = r[k - 1].halved()
        if self.fused_bn:
            x1 = self.inc2_conv(self.first_conv(x))
        elif train:
            x1 = conv_bn_relu_pair(self.first_conv, self.first_bn, self.inc2_conv,
                                   self.inc2_bn, x, self.dtype, ingest_hw, rows=r[0])
        else:
            x1 = conv_bn_relu_eval(self.first_conv, self.first_bn, self.inc2_conv,
                                   self.inc2_bn, x, self.dtype, rows=r[0])
        x2 = self.down1(x1, train, r[0])
        x3 = self.down2(x2, train, r[1])
        x4 = self.down3(x3, train, r[2])
        x5 = self.down4(x4, train, r[3])
        y = self.up1(x5, x4, train, r[4], r[3])
        y = self.up2(y, x3, train, r[3], r[2])
        y = self.up3(y, x2, train, r[2], r[1])
        if self.up4 is not None:
            y = self.up4(y, x1, train, r[1], r[0])
        else:
            upsample = upsample2x_align_corners if self.bilinear else self.upsample4
            y = upsample_to(upsample, y, x1, r[1], r[0], local=not self.bilinear)
            y = self.upconv4(torch.cat([x1, y], dim=-1), train, r[0])
        logits = stat_float(self.outc(y))
        return (logits, logits, torch.sigmoid(logits)) if self.analyze else logits
