"""UNet for RGB root segmentation, eval and training forms (port of
hyperpri_tpu/models/unet.py:21-70).

Widths 64 -> 128 -> 256 -> 512 -> 1024 and a binary logit head: 31,043,521
parameters at n_channels=3, bilinear=False, n_classes=1.

Input (N, H, W, n_channels) NHWC; output (N, H, W, n_classes) float32
logits (float64 for a float64 model).
`forward(x, train=True)` is the training form. `use_kernels` (JAX's
`pallas_train`) sends the 3x3 convs that pass Conv3x3's gates through the
trainable kernel convs, and the even pools' backwards through the pool
kernel; `conv_kwargs` reaches every Conv3x3 (the gates). The 3-channel stem
`inc.conv1` stays on F.conv2d under the C >= 32 gate, as in the JAX package.

`use_attention` is UNET+: each Up merges by skip * x instead of the concat.
`analyze` returns (logits, logits, sigmoid(logits)) (unet.py:64-66). With
`fused_bn` the model takes the state dict of ops/fold_bn.py and serves: every
3x3 conv is a ServingConv3x3, and `use_kernels` (JAX's `use_pallas`) sends
those that pass `packed_serving_route` to the conv3x3_packed kernel. At
1x608x968x3 with bilinear=False those are inc.conv2, up4.conv1 and up4.conv2
(three launches an image); with bilinear=True up3.conv2 (128 -> 64 at
304x484) passes too.

`spatial_mesh` (the Trainer sets it under a mesh): the forward runs on this
rank's samples and rows with the mesh's collectives (models/parts.py). The
JAX model has no such attribute: GSPMD partitions it on XLA's ops; here it
takes the same collectives as CubeNET.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch.models.parts import DoubleConv, Down, OutConv, Up, _Conv, stat_float
from hyperpri_tpu_torch.parallel.mesh import Rows


class UNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1, bilinear: bool = True,
                 use_attention: bool = False, analyze: bool = False,
                 fused_bn: bool = False, use_kernels: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, spatial_mesh=None,
                 **conv_kwargs):
        super().__init__()
        self.spatial_mesh = spatial_mesh
        self.n_channels = n_channels
        self.analyze = analyze
        self.fused_bn = fused_bn
        self.dtype = dtype
        factor = 2 if bilinear else 1
        c = 64
        kw = dict(fused_bn=fused_bn, use_kernels=use_kernels, dtype=dtype, **conv_kwargs)
        up = dict(use_attention=use_attention, **kw)
        self.inc = DoubleConv(n_channels, c, **kw)
        self.down1 = Down(c, c * 2, **kw)
        self.down2 = Down(c * 2, c * 4, **kw)
        self.down3 = Down(c * 4, c * 8, **kw)
        self.down4 = Down(c * 8, c * 16 // factor, **kw)
        self.up1 = Up(c * 16, c * 8, bilinear, **up)
        self.up2 = Up(c * 8, c * 4, bilinear, **up)
        self.up3 = Up(c * 4, c * 2, bilinear, **up)
        self.up4 = Up(c * 2, c * factor, bilinear, **up)
        self.outc = OutConv(c, n_classes, dtype)   # up4 gives c channels either way
        if generator is not None:
            for m in self.modules():
                if isinstance(m, _Conv):
                    m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False, ingest_hw=None):
        """-> float32 logits, or with `analyze` (logits, logits, sigmoid).
        ingest_hw must be None: the host pre-padded ingest is CubeNET's (its
        first conv takes the packed kernel; UNet's stem does not)."""
        if ingest_hw is not None:
            raise ValueError("UNet takes logical images: the pre-padded ingest is CubeNET's")
        if x.shape[-1] != self.n_channels:
            raise ValueError(f"UNet expects {self.n_channels} input channels (NHWC), got "
                             f"shape {tuple(x.shape)}")
        x = x.to(self.dtype)
        r = [None] * 5   # the mesh.Rows of each level, under a mesh
        if self.spatial_mesh is not None:
            r[0] = Rows.of_input(self.spatial_mesh, x)
            for k in range(1, 5):
                r[k] = r[k - 1].halved()
        x1 = self.inc(x, train, r[0])
        x2 = self.down1(x1, train, r[0])
        x3 = self.down2(x2, train, r[1])
        x4 = self.down3(x3, train, r[2])
        x5 = self.down4(x4, train, r[3])
        y = self.up1(x5, x4, train, r[4], r[3])
        y = self.up2(y, x3, train, r[3], r[2])
        y = self.up3(y, x2, train, r[2], r[1])
        y = self.up4(y, x1, train, r[1], r[0])
        logits = stat_float(self.outc(y))
        return (logits, logits, torch.sigmoid(logits)) if self.analyze else logits
