"""3x3 SAME conv + bias + optional ReLU from three H-shifted input bands: the
port of the TPU kernel hyperpri_tpu/ops/pallas/conv3x3_shift.py:
conv3x3_bias_act_shift, as the hand-written CUDA kernels in
csrc/conv3x3_shift.cu.

Contract (kernel 2's, conv3x3.py, without statistics or prologue):
y = act(conv3x3_SAME(x, w) + b) with x (N, H, W, C) NHWC, w HWIO (3, 3, C, O)
for any O (cast to x's dtype), b (O,), float32 accumulation and the bias
added in float32 before the optional ReLU, one rounding to `out_dtype`
(default x's). On the card x is bf16 or float32 (float32 by 3xTF32 products)
and `out_dtype` x's dtype or float32. The JAX kernel's `th` and `to` are TPU
tile choices (rows per block, output lanes per block) and have no
counterpart: the CUDA kernels' tiles are fixed (8x32 pixels, 64 or 128
outputs). No model path calls it; it is a variant of kernel 2 with its own
staging (the .cu file's source note).

On the card the call takes one of two kernel bodies, chosen before the launch
by sm90_plan.shift_plan from its dtype and layout: "sm90", the Hopper kernels
(each dh band one TMA box in an mbarrier ring, wgmma products; C and O
multiples of 8 in bf16, of 4 in float32, 16-byte aligned pointers; bf16 reads
w in place, float32 first splits w into K-major TF32 hi and lo planes,
conv3x3.split_weights_tf32), or "legacy", the synchronous mma.sync kernel on
packed weights (other layouts, e.g. C = 238 in bf16 or C = 61). The private
keyword `_legacy=True` takes the synchronous body whatever the layout, to
hold the two bodies against each other.

`conv3x3_bias_act_shift` runs the plain version,
`conv3x3_bias_act_shift_reference`, only for tensors on the CPU. For CUDA
tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _plain, sm90_plan
from hyperpri_tpu_torch.ops.kernels.conv3x3 import split_weights_tf32

# C entry points of the synchronous body by (x dtype, out dtype); the Hopper
# body's add "_sm90" after "conv3x3_shift"
_ENTRY = {(torch.bfloat16, torch.bfloat16): "conv3x3_shift_bf16",
          (torch.bfloat16, torch.float32): "conv3x3_shift_bf16_f32",
          (torch.float32, torch.float32): "conv3x3_shift_f32"}


def conv3x3_bias_act_shift_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                                     relu: bool = True,
                                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: nine shifted float32 matrix products of the zero-padded
    input with w rounded to x's dtype, plus the bias, optional ReLU, one
    rounding to out_dtype."""
    y = _plain.conv3x3_same_f32(x, w.to(x.dtype)) + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or x.dtype)


def _lib(entry: str):
    return _plain.bind("conv3x3_shift", entry,
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _lib_sm90(entry: str):
    return _plain.bind("conv3x3_shift", entry.replace("conv3x3_shift", "conv3x3_shift_sm90"),
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def call_plan(x: torch.Tensor, w_k: torch.Tensor, *, _legacy: bool = False):
    """The sm90_plan.ShiftPlan of a call on x with the weights as the kernels
    take them, w_k (3, 3, C, O) in x's dtype and contiguous (the bf16 Hopper
    body reads them in place)."""
    n, h, width, c = x.shape
    aligned = x.data_ptr() % 16 == 0 and w_k.data_ptr() % 16 == 0
    return sm90_plan.shift_plan(n, h, width, c, w_k.shape[-1], x.dtype, aligned,
                                sm90=not _legacy)


def conv3x3_bias_act_shift(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                           relu: bool = True, out_dtype: Optional[torch.dtype] = None,
                           _legacy: bool = False) -> torch.Tensor:
    """y (N, H, W, O); see the module docstring.

    `conv3x3_bias_act_shift.launches` counts launches of the CUDA kernels,
    `launches_by_dtype` by x's type ("bf16", "f32") and `launches_by_path`
    by kernel body ("sm90", "legacy")."""
    _plain.check_conv_args("conv3x3_bias_act_shift", x, w, b, None, None)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv3x3_bias_act_shift_reference(x, w, b, relu=relu, out_dtype=out_dtype)
    suffix = _plain.require_cuda("conv3x3_bias_act_shift", x, w, b)
    entry = _ENTRY.get((x.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"conv3x3_bias_act_shift writes x's dtype or float32, not {out_dtype}")
    n, h, width, c = x.shape
    o = w.shape[-1]
    y = torch.empty((n, h, width, o), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        raise ValueError("conv3x3_bias_act_shift: empty input")
    w_k = w.to(x.dtype).contiguous()
    plan = call_plan(x, w_k, _legacy=_legacy)
    bf = _plain.f32_vector(b)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == "sm90":
            if suffix == "f32":   # the K-major TF32 hi and lo planes (2, 9, O, C)
                w_k = split_weights_tf32(w_k)
            err = _lib_sm90(entry)(x.data_ptr(), w_k.data_ptr(), bf.data_ptr(), y.data_ptr(), n,
                                   h, width, c, o, int(relu), plan.grid[0], stream)
        else:
            wp = _plain.pack_weights(w, plan.tile_o, x.dtype)
            err = _lib(entry)(x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), n, h,
                              width, c, wp.shape[2], o, wp.shape[1], plan.tile_o, int(relu),
                              stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bias_act_shift kernel launch failed ({plan.path}): "
                           f"cudaError_t {err}")
    conv3x3_bias_act_shift.launches += 1
    _plain.count(conv3x3_bias_act_shift.launches_by_dtype, (suffix,))
    _plain.count(conv3x3_bias_act_shift.launches_by_path, (plan.path,))
    return y


conv3x3_bias_act_shift.launches = 0
conv3x3_bias_act_shift.launches_by_dtype = {}
conv3x3_bias_act_shift.launches_by_path = {}
