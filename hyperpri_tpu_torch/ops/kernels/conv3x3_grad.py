"""Weight gradient of the 3x3 SAME conv: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3_grad.py:conv3x3_wgrad, as the hand-written
CUDA kernel in csrc/conv3x3_grad.cu.

Contract: dW[dh,dw,c,o] = sum_{n,h,w} z_pad[n,h+dh,w+dw,c] * g[n,h,w,o], a
float32 (3, 3, C, O) tensor, for x (N, H, W, C) and the cotangent g
(N, H, W, O) of one dtype (bf16 on the card). z = x, or with `pa, pb`
(float32 (C,)) z = relu(pa*x + pb) recomputed from the raw x in float32 and
rounded to x's dtype, with the SAME border exact zero. On the card the long
pixel axis is split across blocks and the partials are added in a fixed order:
no float atomics, two runs give the same bits. The source note in the .cu file
gives the kernel's bound and design.

`conv3x3_wgrad` runs the plain version, `conv3x3_wgrad_reference`, only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _build, _plain

_TH, _TW, _CT, _OT = 8, 32, 64, 64  # the kernel's pixel, C and O tiles
_TARGET_BLOCKS = 2 * 132  # about two blocks per SM of an H100
_MAX_PARTIAL_BYTES = 1 << 28


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor,
                            pa: Optional[torch.Tensor] = None,
                            pb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: for each tap, the float32 product of the shifted,
    zero-padded input (C, N*H*W) with the cotangent (N*H*W, O)."""
    _, h, width, c = x.shape
    o = g.shape[-1]
    zp = _plain.pad_same(_plain.prologue_act(x, pa, pb))
    g2 = g.float().reshape(-1, o)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dwi in range(3):
            dw[dh, dwi] = zp[:, dh:dh + h, dwi:dwi + width, :].reshape(-1, c).t() @ g2
    return dw


def _lib():
    fn = _build.load("conv3x3_grad").conv3x3_wgrad_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _splits(n: int, h: int, width: int, c: int, o: int) -> int:
    """Blocks along the pixel axis: enough to fill the card with the C and O
    tiles, no more than there are pixel tiles, and a bounded partial buffer."""
    tiles = n * -(-h // _TH) * -(-width // _TW)
    co_blocks = -(-c // _CT) * -(-o // _OT)
    by_memory = max(1, _MAX_PARTIAL_BYTES // (36 * c * o))
    return max(1, min(tiles, -(-_TARGET_BLOCKS // co_blocks), by_memory))


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, pa: Optional[torch.Tensor] = None,
                  pb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW (3, 3, C, O) float32; see the module docstring.

    `conv3x3_wgrad.calls` counts every call; `conv3x3_wgrad.launches` counts
    launches of the CUDA kernel only."""
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"need x (N,H,W,C) and g (N,H,W,O); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"x and g must share a dtype, got {x.dtype} and {g.dtype}")
    c, o = x.shape[-1], g.shape[-1]
    if (pa is None) != (pb is None):
        raise ValueError("pa and pb come together")
    if pa is not None and (tuple(pa.shape) != (c,) or tuple(pb.shape) != (c,)):
        raise ValueError(f"pa, pb must be ({c},), got {tuple(pa.shape)}, {tuple(pb.shape)}")
    conv3x3_wgrad.calls += 1
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g, pa, pb)
    _plain.require_cuda_bf16("conv3x3_wgrad", x, g, pa, pb)
    if not g.is_contiguous():
        raise ValueError("conv3x3_wgrad: g must be a contiguous NHWC tensor")
    n, h, width, _ = x.shape
    if x.numel() == 0 or g.numel() == 0:
        raise ValueError("conv3x3_wgrad: empty input")
    splits = _splits(n, h, width, c, o)
    paf, pbf = _plain.f32_vector(pa), _plain.f32_vector(pb)
    partial = torch.empty((splits, 9, c, o), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), g.data_ptr(), _plain.ptr(paf), _plain.ptr(pbf),
            partial.data_ptr(), dw.data_ptr(), n, h, width, c, o, splits,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad kernel launch failed: cudaError_t {err}")
    conv3x3_wgrad.launches += 1
    return dw


conv3x3_wgrad.calls = 0
conv3x3_wgrad.launches = 0
