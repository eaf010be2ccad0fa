"""U-Net building blocks, eval and training forms (port of
hyperpri_tpu/models/parts.py).

Modules take and return NHWC tensors, as the JAX package's do. Inside,
`x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is the zero-copy
channels_last NCHW view that F.conv2d, F.max_pool2d and F.conv_transpose2d
take, and the buffer layout the CUDA kernel reads. Parameters are float32 in
torch layouts; each module computes in its `dtype` (float32, the
configuration's default, or bf16), and BatchNorm statistics stay float32.

Training (`train=True`) mirrors the reference's rounding points: a conv hands
its BatchNorm the batch statistics (from its kernel's epilogue where it takes
the kernel route), the first BatchNorm of a pair returns only its folded
affine (pa, pb), and the second conv applies relu(pa*x + pb) to its input
itself, in its kernel's prologue or, off the kernel route, in float32 tensor
ops rounded to the compute dtype.

Under a mesh (parallel/mesh.py) the modules take `rows`, the mesh.Rows of
their input's H axis (the models pass them down, level by level):
  - with more than one spatial rank every 3x3 conv, gated or not, runs
    parallel/spatial_conv.conv3x3_spatial, the JAX mesh route's unfused conv
    (no statistics epilogue, no prologue: parts.py:386-405), on the kernels
    when the gates pass at the map's GLOBAL H x W (parts.py:322-326), so a
    layer's route does not change with the mesh;
  - on a data-only mesh each rank's geometry is the single device's, and
    the single-device route stays: statistics epilogue, fused prologue;
  - TorchBatchNorm all-reduces its sums (the kernel epilogue's too) over the
    ranks that hold the map's pixels, with the global pixel count;
  - ops that are not local in H (the bilinear upsample, a center pad in H,
    a pool of a shard with an odd row count) gather the rows, compute on the
    whole map and keep this rank's rows; a level whose rows do not split
    evenly is held whole by every spatial peer (mesh.Rows).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
from hyperpri_tpu_torch.ops.kernels import framing
from hyperpri_tpu_torch.ops.kernels.conv_train import (
    BNACT_PACKED_MAX_BC,
    PACKED_MAX_O,
    conv3x3_bias_stats_train,
    conv3x3_bias_train,
    conv3x3_bnact_stats_train,
)
from hyperpri_tpu_torch.ops.pool import max_pool_2x2
from hyperpri_tpu_torch.parallel.mesh import Rows
from hyperpri_tpu_torch.parallel.spatial_conv import conv3x3_spatial

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # decay of the running average: new = 0.9*old + 0.1*batch

# Training route gates of hyperpri_tpu/models/parts.py:42-49 (tuned on a TPU,
# kept as they are): maps of at least 30,000 pixels with 32 <= C and
# max(C, O) <= 256 take the trainable kernel convs.
TRAIN_MIN_PIXELS = 30_000
TRAIN_MIN_CHANNELS = 32
TRAIN_MAX_CHANNELS = 256

# Serving route gates of hyperpri_tpu/models/parts.py:558-568: full-resolution
# maps with wide inputs and narrow outputs take the conv3x3_packed kernel.
SERVING_MIN_PIXELS = 140_000
SERVING_MIN_CHANNELS = 33
SERVING_MAX_OUT = 64


def packed_serving_route(h: int, w: int, c: int, o: int) -> bool:
    """True iff ServingConv3x3 sends this layer to conv3x3_packed
    (`_packed_serving_route`, parts.py:561; the kernel wrapper dispatches by
    device, so there is no backend clause)."""
    return h * w >= SERVING_MIN_PIXELS and c >= SERVING_MIN_CHANNELS and o <= SERVING_MAX_OUT


def train_kernel_route(h: int, w: int, c: int, o: int, use_kernels: bool = True,
                       min_pixels: int = TRAIN_MIN_PIXELS,
                       min_channels: int = TRAIN_MIN_CHANNELS,
                       max_channels: int = TRAIN_MAX_CHANNELS) -> bool:
    """True iff a training conv takes the trainable kernel convs (the
    `use_pallas` gate of parts.py:322-333 with the gates as arguments; the
    wrappers dispatch by device, so there is no backend clause)."""
    return (use_kernels and h * w >= min_pixels and min_channels <= c
            and max(c, o) <= max_channels)


def first_conv_ingest_spec(h: int, w: int, c: int, o: int, **gates):
    """The host pre-padded ingest geometry of the network's first conv
    (parts.py:96-122): ((H_pad, W_pad, C_pad), (1, 1), (h, w, c)), or None
    when that conv would not take conv3x3_packed (the caller then feeds
    logical cubes). `gates` are train_kernel_route's."""
    if not (train_kernel_route(h, w, c, o, **gates) and o <= PACKED_MAX_O):
        return None
    return framing.ingest_spec(h, w, c)


def _conv2d(x: torch.Tensor, weight: torch.Tensor, **kwargs) -> torch.Tensor:
    """F.conv2d on NHWC in and out, through the channels_last view."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, **kwargs).permute(0, 2, 3, 1)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at two deviations, scaled so
    that its variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class _Conv(nn.Module):
    """Weight and bias of a conv layer, with flax's init."""

    def __init__(self, weight_shape, out_channels: int, fan_in: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.fan_in = fan_in
        self.dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            lecun_normal_(self.weight, self.fan_in, generator)
            self.bias.zero_()


class Conv3x3(_Conv):
    """3x3 SAME conv + bias (parts.py:250 Conv3x3). Called as `conv(x)` it is
    the eval route (:436-443): the bias is added in the compute dtype.
    `train_forward` is the training route, which sends layers that pass the
    gates through the trainable kernel convs of ops/kernels/conv_train.py.
    The gates are constructor arguments so that tests can lower them."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32,
                 use_kernels: bool = False, min_pixels: int = TRAIN_MIN_PIXELS,
                 min_channels: int = TRAIN_MIN_CHANNELS,
                 max_channels: int = TRAIN_MAX_CHANNELS,
                 bnact_packed_max_bc: int = BNACT_PACKED_MAX_BC):
        super().__init__((out_channels, in_channels, 3, 3), out_channels,
                         9 * in_channels, dtype)
        self.use_kernels = use_kernels
        self.min_pixels = min_pixels
        self.min_channels = min_channels
        self.max_channels = max_channels
        self.bnact_packed_max_bc = bnact_packed_max_bc

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        if rows is not None and rows.mesh.spatial > 1:
            return conv3x3_spatial(x.to(self.dtype), self._hwio(), self.bias, rows.mesh,
                                   split=rows.split)
        y = _conv2d(x.to(self.dtype), self.weight.to(self.dtype), padding=1)
        return y + self.bias.to(self.dtype)

    def _hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0).to(self.dtype)  # OIHW -> HWIO

    def kernel_route(self, h: int, w: int) -> bool:
        """True iff `train_forward` sends an (N, h, w, C) input through the
        kernel convs."""
        o, c = self.weight.shape[:2]
        return train_kernel_route(h, w, c, o, **self.gates())

    def gates(self) -> dict:
        """The route gates, as train_kernel_route takes them."""
        return dict(use_kernels=self.use_kernels, min_pixels=self.min_pixels,
                    min_channels=self.min_channels, max_channels=self.max_channels)

    def train_forward(self, x: torch.Tensor, collect_stats: bool = False, prologue=None,
                      pre_padded=None, rows: Optional[Rows] = None):
        """-> (y, stats). stats is the (sum, sumsq) float32 pair of y's batch
        statistics when `collect_stats` and the kernel route is taken, else
        None (the BatchNorm then reduces them itself). prologue: optional
        per-input-channel float32 (pa, pb); the conv then reads
        relu(pa*x + pb), in the kernel's prologue on the kernel route with
        `collect_stats`, else applied here first in float32 and rounded to
        the compute dtype (parts.py:377-443). `pre_padded` = logical
        (h, w, c) declares x the host pre-padded ingest buffer, for the bare
        statistics conv on the conv3x3_packed route only, else this raises.
        `rows`: the input's mesh.Rows under a mesh (module docstring)."""
        o, c = self.weight.shape[:2]
        if pre_padded is None:
            _, h, w, _ = x.shape
        else:
            h, w, pc = pre_padded
            if pc != c:
                raise ValueError(f"pre-padded ingest of {pc} channels into a {c}-channel conv")
        x = x.to(self.dtype)
        spatial = rows is not None and rows.mesh.spatial > 1
        use_kernels = self.kernel_route(h if rows is None else rows.h, w)
        if pre_padded is not None and not (use_kernels and o <= PACKED_MAX_O and collect_stats
                                           and prologue is None and not spatial):
            raise ValueError(f"pre-padded ingest off the packed statistics route: kernel route "
                             f"{use_kernels}, features {o}, collect_stats {collect_stats}, "
                             f"prologue {prologue is not None}, spatial mesh {spatial}")
        fuse_prologue = prologue is not None and use_kernels and collect_stats and not spatial
        if prologue is not None and not fuse_prologue:
            pa, pb = prologue
            x = F.relu(stat_float(x) * pa + pb).to(self.dtype)
        if spatial:
            return conv3x3_spatial(x, self._hwio(), self.bias, rows.mesh, kernels=use_kernels,
                                   split=rows.split), None
        if use_kernels:
            kernel = self._hwio()
            bias = self.bias.float()
            x = x.contiguous()
            if fuse_prologue:
                y, s, ss = conv3x3_bnact_stats_train(x, prologue[0], prologue[1], kernel,
                                                     bias, self.bnact_packed_max_bc)
                return y, (s, ss)
            if collect_stats:
                y, s, ss = conv3x3_bias_stats_train(
                    x, kernel, bias, None if pre_padded is None else (h, w))
                return y, (s, ss)
            return conv3x3_bias_train(x, kernel, bias), None
        y = _conv2d(x, self.weight.to(self.dtype), padding=1)
        return y + self.bias.to(self.dtype), None


class ServingConv3x3(_Conv):
    """relu(conv3x3_SAME(x) + b) of the folded serving model: port of
    parts.py:593 PallasConv3x3 (:648-668). Layers that pass
    `packed_serving_route` go to the conv3x3_packed kernel, which adds the
    bias in float32 before rounding; the rest go to F.conv2d with the bias
    added in the compute dtype, as the JAX route does."""

    def __init__(self, in_channels: int, out_channels: int, use_kernels: bool = True,
                 dtype=torch.float32):
        super().__init__((out_channels, in_channels, 3, 3), out_channels,
                         9 * in_channels, dtype)
        self.use_kernels = use_kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        o = self.weight.shape[0]
        x = x.to(self.dtype)
        if self.use_kernels and packed_serving_route(h, w, c, o):
            return conv3x3_packed(x.contiguous(),
                                  self.weight.permute(2, 3, 1, 0).to(self.dtype),
                                  self.bias.float(), relu=True)
        y = _conv2d(x, self.weight.to(self.dtype), padding=1) + self.bias.to(self.dtype)
        return F.relu(y)


class Conv1x1(_Conv):
    """1x1 conv + bias (flax nn.Conv (1, 1)), in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__((out_channels, in_channels, 1, 1), out_channels,
                         in_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv2d(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class ConvTransposeUp(_Conv):
    """ConvTranspose 2x2, stride 2 (parts.py:489-506). The weight is in torch's
    (C, O, 2, 2) layout: flax's (2, 2, C, O) kernel, flipped on both spatial
    axes (weights.py does the conversion)."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__((in_channels, out_channels, 2, 2), out_channels,
                         4 * in_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), stride=2)
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


def stat_float(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' precision: float32, or float64 for a float64
    model (a reference run at higher precision)."""
    return x if x.dtype == torch.float64 else x.float()


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch semantics in float32 (parts.py:125-194), eps 1e-5;
    returns float32 (float64 for float64 input). Eval uses the running
    statistics. Training uses the batch's: var = E[x^2] - mean^2 from
    per-channel sums, the running statistics take the unbiased variance with
    momentum 0.1, and the gradient reaches the producer through the sums."""

    def __init__(self, features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.momentum = momentum

    def forward(self, x: torch.Tensor, train: bool = False, precomputed=None,
                affine_only: bool = False, rows: Optional[Rows] = None):
        """precomputed: optional (sum, sumsq) float32 pair over N, H, W from
        the producing conv's epilogue, instead of reducing x here.
        affine_only: update the running statistics but return the folded
        per-channel float32 pair (pa, pb) with y = pa*x + pb instead of
        applying it; the consumer fuses the apply (+ ReLU) into its load.
        rows: under a mesh, the mesh.Rows of x's H axis: the sums are
        all-reduced over the ranks that hold x's pixels before use, and the
        count is the global one."""
        x32 = stat_float(x)
        if not train:
            mean, var = self.running_mean, self.running_var
        elif rows is not None:
            count = float(x.numel() // x.shape[-1])
            if precomputed is None:
                axes = tuple(range(x.dim() - 1))
                precomputed = (x32.sum(dim=axes), (x32 * x32).sum(dim=axes))
            sums = rows.mesh.all_reduce(torch.stack(precomputed), rows.reduce_axes)
            count *= math.prod(rows.mesh.shape[a] for a in rows.reduce_axes)
            mean = sums[0] / count
            var = sums[1] / count - mean * mean
            self._update_running(mean, var, count)
        else:
            axes = tuple(range(x.dim() - 1))
            count = float(x.numel() // x.shape[-1])
            if precomputed is not None:
                psum, psumsq = precomputed
                mean = psum / count
                var = psumsq / count - mean * mean
            else:
                mean = x32.mean(dim=axes)
                var = (x32 * x32).mean(dim=axes) - mean * mean
            self._update_running(mean, var, count)
        if affine_only:
            a = self.weight * torch.rsqrt(var + self.eps)
            return a, self.bias - mean * a
        return (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias

    @torch.no_grad()
    def _update_running(self, mean, var, count: float):
        unbiased = var * (count / max(count - 1.0, 1.0))
        self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * unbiased)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling, align_corners=True, NHWC (parts.py:197-226)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Center-pad NHWC x to (target_h, target_w): top/left get floor(diff/2)
    (parts.py:229-247)."""
    dy = target_h - x.shape[1]
    dx = target_w - x.shape[2]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def upsample_to(upsample, x1: torch.Tensor, x2: torch.Tensor,
                rows1: Optional[Rows] = None, rows2: Optional[Rows] = None,
                local: bool = True) -> torch.Tensor:
    """upsample(x1), center-padded to the skip x2's H and W. Under a mesh: a
    `local` upsample (the 2x2 transposed conv maps each row to two) of split
    rows that double to x2's height runs on this rank's rows; otherwise the
    rows are gathered, upsampled and padded whole, and x2's rows kept."""
    if rows1 is None:
        return pad_to_match(upsample(x1), x2.shape[1], x2.shape[2])
    if local and rows1.split and rows1.doubled().h == rows2.h:
        y = upsample(x1)
        return pad_to_match(y, y.shape[1], x2.shape[2])
    y = pad_to_match(upsample(rows1.whole(x1)), rows2.h, x2.shape[2])
    return rows2.keep(y)


def conv_bn_relu_pair(conv1, bn1, conv2, bn2, x: torch.Tensor, dtype,
                      ingest_hw=None, rows: Optional[Rows] = None) -> torch.Tensor:
    """Training form of conv1 -> bn1 -> ReLU -> conv2 -> bn2 -> ReLU
    (parts.py:720-759, and cubenet.py:115-141 across first_conv and inc2):
    bn1 only folds its affine, conv2 applies it with the ReLU on its input,
    and each BatchNorm takes its statistics from its conv where the conv has
    them. `ingest_hw` = logical (h, w) when x is the host pre-padded ingest
    buffer of conv1. `rows`: x's mesh.Rows under a mesh."""
    pre_padded = None if ingest_hw is None else (*ingest_hw, conv1.weight.shape[1])
    x, st = conv1.train_forward(x, collect_stats=True, pre_padded=pre_padded, rows=rows)
    prologue = bn1(x, train=True, precomputed=st, affine_only=True, rows=rows)
    x, st = conv2.train_forward(x, collect_stats=True, prologue=prologue, rows=rows)
    return F.relu(bn2(x, train=True, precomputed=st, rows=rows)).to(dtype)


def conv_bn_relu_eval(conv1, bn1, conv2, bn2, x: torch.Tensor, dtype,
                      rows: Optional[Rows] = None) -> torch.Tensor:
    """Eval form of the same pair, with the running statistics."""
    x = F.relu(bn1(conv1(x, rows))).to(dtype)
    return F.relu(bn2(conv2(x, rows))).to(dtype)


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) * 2 (parts.py:671-759). Folded (`fused_bn`), each
    half is one ServingConv3x3 (serving only). Unfolded, `use_kernels` sends
    the training convs that pass Conv3x3's gates through the kernels;
    `conv_kwargs` reaches both Conv3x3s (the gates)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, fused_bn: bool = False,
                 use_kernels: bool = False, dtype=torch.float32, **conv_kwargs):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.fused_bn = fused_bn
        self.dtype = dtype
        if fused_bn:
            self.conv1 = ServingConv3x3(in_channels, mid, use_kernels, dtype)
            self.conv2 = ServingConv3x3(mid, out_channels, use_kernels, dtype)
        else:
            self.conv1 = Conv3x3(in_channels, mid, dtype, use_kernels, **conv_kwargs)
            self.bn1 = TorchBatchNorm(mid)
            self.conv2 = Conv3x3(mid, out_channels, dtype, use_kernels, **conv_kwargs)
            self.bn2 = TorchBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rows: Optional[Rows] = None) -> torch.Tensor:
        if self.fused_bn:
            if train:
                raise ValueError("a BatchNorm-folded model serves; it does not train")
            if rows is not None:
                raise ValueError("a BatchNorm-folded model serves on one device")
            return self.conv2(self.conv1(x))
        pair = conv_bn_relu_pair if train else conv_bn_relu_eval
        return pair(self.conv1, self.bn1, self.conv2, self.bn2, x, self.dtype, rows=rows)


class Down(nn.Module):
    """2x2 max pool -> DoubleConv (parts.py:762-789)."""

    def __init__(self, in_channels: int, out_channels: int, fused_bn: bool = False,
                 use_kernels: bool = False, dtype=torch.float32, **conv_kwargs):
        super().__init__()
        self.use_kernels = use_kernels
        self.conv = DoubleConv(in_channels, out_channels, fused_bn=fused_bn,
                               use_kernels=use_kernels, dtype=dtype, **conv_kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """rows: x's mesh.Rows under a mesh; the output's are rows.halved()."""
        # with kernels off the pool is stock too: autograd's own backward
        if rows is None:
            return self.conv(max_pool_2x2(x, first_max_backward=self.use_kernels), train)
        out = rows.halved()
        if rows.split and x.shape[1] % 2 == 0:   # each shard pools its own rows
            y = max_pool_2x2(x, first_max_backward=self.use_kernels)
        else:
            y = out.keep(max_pool_2x2(rows.whole(x), first_max_backward=self.use_kernels))
        return self.conv(y, train, out)


class Up(nn.Module):
    """Upsample -> center-pad -> merge with the skip -> DoubleConv
    (parts.py:792-845). `in_channels` is the channel count after the concat,
    which is also the deeper input's count on the ConvTranspose path. The
    merge is concat [skip, x], or skip * x with `use_attention` (UNET+):
    the product has half the channels, so the DoubleConv then takes
    in_channels // 2 on both paths (flax infers it; the names stay up{k}/conv
    and up{k}/up)."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = False,
                 fused_bn: bool = False, use_kernels: bool = False, dtype=torch.float32,
                 use_attention: bool = False, **conv_kwargs):
        super().__init__()
        self.bilinear = bilinear
        self.use_attention = use_attention
        merged = in_channels // 2 if use_attention else in_channels
        if bilinear:
            self.conv = DoubleConv(merged, out_channels // 2, in_channels // 2,
                                   fused_bn, use_kernels, dtype, **conv_kwargs)
        else:
            self.up = ConvTransposeUp(in_channels, in_channels // 2, dtype)
            self.conv = DoubleConv(merged, out_channels, None, fused_bn,
                                   use_kernels, dtype, **conv_kwargs)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = False,
                rows1: Optional[Rows] = None, rows2: Optional[Rows] = None) -> torch.Tensor:
        """rows1, rows2: the mesh.Rows of x1 and of the skip x2 under a mesh."""
        upsample = upsample2x_align_corners if self.bilinear else self.up
        x1 = upsample_to(upsample, x1, x2, rows1, rows2, local=not self.bilinear)
        x = x2 * x1 if self.use_attention else torch.cat([x2, x1], dim=-1)
        return self.conv(x, train, rows2)


class OutConv(nn.Module):
    """1x1 conv head (parts.py:883-893). The reference's training head
    (_FlatHead, :848-880) is a layout workaround for the TPU with the math of
    this 1x1 conv in the compute dtype, so one module serves both."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv1x1(in_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
