"""Probe of the arena output framing: y = 2x written at (+8, +8) into a
zero-framed arena, the port of the TPU probe scripts/probe_element_out.py:run
(the JAX package's), as the hand-written CUDA kernel in
csrc/probe_element_out.cu.

Contract: x (N, H, W, C) float32; returns the arena buffer
framing.arena_shape(N, H, W, C) with y[:, 8:8+H, 8:8+W, :C] = 2*x and zeros
elsewhere. It is the arena modes' test: the conv kernels' arena_out stores
through the same framed index.

`element_out` runs the plain version, `element_out_reference`, only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from hyperpri_tpu_torch.ops.kernels import _plain, framing
from hyperpri_tpu_torch.ops.kernels.framing import Frame


def _arena(x: torch.Tensor):
    n, h, w, c = x.shape
    y = x.new_zeros(framing.arena_shape(n, h, w, c))
    return y, Frame.of(y, framing.ARENA_OFFSET)


def element_out_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a zero arena with 2x written into its logical view."""
    y, frame = _arena(x)
    frame.logical(y, *x.shape[1:]).copy_(2.0 * x)
    return y


def _lib():
    return _plain.bind("probe_element_out", "element_out_f32",
                       [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def element_out(x: torch.Tensor) -> torch.Tensor:
    """The arena of 2x; see the module docstring. `element_out.launches`
    counts launches of the CUDA kernel."""
    if x.dim() != 4 or x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"need a non-empty float32 (N, H, W, C) x, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return element_out_reference(x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"element_out: need a contiguous CUDA tensor, got {x.device}")
    y, frame = _arena(x)
    n, h, w, c = x.shape
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), y.data_ptr(), framing.frames_arg(frame), n, h, w, c,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"element_out kernel launch failed: cudaError_t {err}")
    element_out.launches += 1
    return y


element_out.launches = 0
