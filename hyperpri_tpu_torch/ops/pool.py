"""2x2 max pooling with the first-max backward (port of
hyperpri_tpu/ops/pool.py:40-89).

VALID padding and stride 2, torch nn.MaxPool2d(2) semantics: odd tails are
dropped (121 -> 60). The backward sends each window's cotangent to the FIRST
maximal element in row-major order. Layers with even H and W, whole channel
vectors and at least 4096 pixels take the max_pool_2x2_bwd kernel; the others
(CubeNET's odd-width 76x121x512 pool) take the same math in tensor ops. That
is routing by shape before any launch, not a fallback after a failure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hyperpri_tpu_torch.ops.kernels._plain import first_max_backward
from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd

KERNEL_MIN_PIXELS = 4096  # tiny maps are not worth a launch


def pool_bwd_kernel_route(h: int, w: int, c: int) -> bool:
    """True iff the backward of an (N, h, w, c) pool takes the kernel
    (`_pallas_route_ok`, pool.py:49-62, without its backend clause: the
    wrapper dispatches by device)."""
    return (h % 2 == 0 and w % 2 == 0
            and (c % 128 == 0 or (c <= 128 and c % 8 == 0))
            and h * w >= KERNEL_MIN_PIXELS)


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _, h, w, c = x.shape
        g = g.to(x.dtype)
        if pool_bwd_kernel_route(h, w, c):
            return max_pool_2x2_bwd(x.contiguous(), g.contiguous())
        return first_max_backward(x, g)


def max_pool_2x2(x: torch.Tensor, first_max_backward: bool = True) -> torch.Tensor:
    """(N, H, W, C) -> (N, H//2, W//2, C), differentiable. With
    `first_max_backward` off it is stock F.max_pool2d with autograd's own
    backward (the same tie-break), which launches no kernel of the port."""
    if not first_max_backward:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return _MaxPool2x2.apply(x)
