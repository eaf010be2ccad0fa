"""3x3 SAME conv + bias (+ReLU) for narrow outputs: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3_packed.py:conv3x3_packed (forward, bias + ReLU
mode), as the hand-written CUDA kernel in csrc/conv3x3_packed.cu.

Contract: y = act(conv3x3_SAME(x, w) + b) with x (N, H, W, C) NHWC, w HWIO
(3, 3, C, O) with O <= 128, b (O,) float32, float32 accumulation and the bias
added in float32 before the optional ReLU; y has x's dtype. On the card x is
bf16. The source note in the .cu file gives the kernel's bound and design.

`conv3x3_packed` runs the plain version, `conv3x3_packed_reference`, only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from hyperpri_tpu_torch.ops.kernels import _build

MAX_OUT = 128
_KC = 32  # input-channel chunk of the kernel; packed weights pad C to it


def conv3x3_packed_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             relu: bool = True) -> torch.Tensor:
    """Plain version: a float32 sum of nine shifted (N,H,W,C)x(C,O) products
    over the zero-padded input, plus the bias, optional ReLU, then one rounding
    to x's dtype. Deliberately not F.conv2d, so it does not depend on cuDNN's
    TF32 setting (matmul stays in full float32 unless
    torch.backends.cuda.matmul.allow_tf32 is set)."""
    _, h, width, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    y = None
    for dh in range(3):
        for dw in range(3):
            tap = torch.matmul(xp[:, dh:dh + h, dw:dw + width, :], wf[dh, dw])
            y = tap if y is None else y + tap
    y = y + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, w, b):
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"need x (N,H,W,C), w (3,3,C,O), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c, o = x.shape[-1], w.shape[-1]
    if tuple(w.shape) != (3, 3, c, o) or b.shape[0] != o:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if o > MAX_OUT:
        raise ValueError(f"conv3x3_packed requires O <= {MAX_OUT}, got {o}")
    if c < 1:
        raise ValueError("conv3x3_packed needs at least one input channel")


def _lib():
    lib = _build.load("conv3x3_packed")
    fn = lib.conv3x3_packed_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, O) -> bf16 (9, NP, Cp): wp[3*dh+dw, o, c] = w[dh, dw, c, o],
    zero-padded to NP in {64, 128} outputs and Cp a multiple of 32 inputs."""
    _, _, c, o = w.shape
    np_ = 64 if o <= 64 else 128
    cp = -(-c // _KC) * _KC
    wp = torch.zeros((9, np_, cp), dtype=torch.bfloat16, device=w.device)
    wp[:, :o, :c] = w.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9, o, c)
    return wp


def conv3x3_packed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool = True) -> torch.Tensor:
    """y = act(conv3x3_SAME(x, w) + b); see the module docstring.

    `conv3x3_packed.calls` counts every call (the kernel route was taken);
    `conv3x3_packed.launches` counts CUDA kernel launches only."""
    _check(x, w, b)
    conv3x3_packed.calls += 1
    if x.device.type == "cpu":
        return conv3x3_packed_reference(x, w, b, relu)
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w, b must share one CUDA device; got "
                         f"{x.device}, {w.device}, {b.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, width, c = x.shape
    o = w.shape[-1]
    y = torch.empty((n, h, width, o), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    wp = _pack_weights(w)
    bf = b.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(),
            n, h, width, c, wp.shape[2], o, wp.shape[1], int(relu),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_packed kernel launch failed: cudaError_t {err}")
    conv3x3_packed.launches += 1
    return y


conv3x3_packed.calls = 0
conv3x3_packed.launches = 0
