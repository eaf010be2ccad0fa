"""Backward of the 2x2, stride-2 max pool: the port of the TPU kernel
hyperpri_tpu/ops/pallas/pool_bwd.py:max_pool_2x2_bwd_pallas, as the
hand-written CUDA kernel in csrc/pool_bwd.cu.

Contract: x (N, H, W, C) with even H and W, g (N, H/2, W/2, C) of x's dtype
(bf16 or float32 on the card). Each window's maximum is recomputed and g goes
to the FIRST maximal element in row-major order (0,0), (0,1), (1,0), (1,1),
zero elsewhere (torch MaxPool2d's tie-break); the equality is x >= max, so a
window of -inf routes too. Returns dx of x's shape and dtype. The kernel
moves bytes and does no arithmetic beyond compares, so it agrees with the
plain version exactly. The source note in the .cu file gives its bound and design.

`max_pool_2x2_bwd` runs the plain version, `max_pool_2x2_bwd_reference`, only
for tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from hyperpri_tpu_torch.ops.kernels import _plain


def max_pool_2x2_bwd_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: the window-stack form of _plain.first_max_backward (the
    four elements of each window in row-major order, `x >= max` as the
    equality, the first maximal element found by a running count)."""
    return _plain.first_max_backward(x, g)


def _lib(suffix: str):
    return _plain.bind("pool_bwd", f"max_pool_2x2_bwd_{suffix}",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def max_pool_2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx for even H and W; see the module docstring.

    `max_pool_2x2_bwd.calls` counts every call; `max_pool_2x2_bwd.launches`
    counts launches of the CUDA kernel only, and `launches_by_dtype` by the
    activations' type ("bf16", "f32")."""
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"need x (N,H,W,C) and g (N,H/2,W/2,C); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_2x2_bwd needs even H and W, got {h}x{w}")
    if tuple(g.shape) != (n, h // 2, w // 2, c) or g.dtype != x.dtype:
        raise ValueError(f"g must be {(n, h // 2, w // 2, c)} {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    max_pool_2x2_bwd.calls += 1
    if x.device.type == "cpu":
        return max_pool_2x2_bwd_reference(x, g)
    suffix = _plain.require_cuda("max_pool_2x2_bwd", x, g)
    if not g.is_contiguous():
        raise ValueError("max_pool_2x2_bwd: g must be a contiguous NHWC tensor")
    if x.numel() == 0:
        raise ValueError("max_pool_2x2_bwd: empty input")
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib(suffix)(x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, h, w, c,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_2x2_bwd kernel launch failed: cudaError_t {err}")
    max_pool_2x2_bwd.launches += 1
    _plain.count(max_pool_2x2_bwd.launches_by_dtype, (suffix,))
    return dx


max_pool_2x2_bwd.calls = 0
max_pool_2x2_bwd.launches = 0
max_pool_2x2_bwd.launches_by_dtype = {}
