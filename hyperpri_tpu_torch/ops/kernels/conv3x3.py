"""3x3 SAME conv for any output width: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3.py:conv3x3_bias_act, as the hand-written CUDA
kernel in csrc/conv3x3.cu.

Contract: y = act(conv3x3_SAME(act_in(x), w) + b) with x (N, H, W, C) NHWC, w
HWIO (3, 3, C, O) for any O, b (O,) float32, float32 accumulation and the bias
added in float32 before the optional ReLU; y has x's dtype (bf16 or float32
on the card, float32 by 3xTF32 products).
  - prologue `pa, pb` (float32 (C,)): act_in(x) = relu(pa*x + pb) computed in
    float32 and rounded to x's dtype before the products; the SAME border is
    exact zero.
  - `with_stats` (needs relu=False): returns (y, (sum y, sum y*y)), float32
    (O,) vectors over N, H, W taken from the float32 value before y is rounded,
    deterministic on the card (fixed-order sums, no float atomics).
It is the route of forward convs wider than 64 outputs and of adjoint convs
wider than conv3x3_packed takes. The source note in the .cu file gives the
kernel's bound and design.

On the card the call takes one of two kernel bodies, chosen before the launch
by sm90_plan.bias_act_plan from its dtype and layout: "sm90", the Hopper
kernels (TMA staging, wgmma; C <= 256 and C, O whose rows TMA can address:
multiples of 8 in bf16, of 4 in float32; every call of a bf16 or float32
training step. bf16 reads w in place; float32 first splits w into K-major
TF32 hi and lo planes, `split_weights_tf32`, and multiplies by 3xTF32), or
"legacy", the synchronous mma.sync kernel on packed weights (other layouts,
e.g. C = 238). The private keyword `_legacy=True` takes the synchronous body
whatever the layout, to hold the two bodies against each other.

`conv3x3_bias_act` runs the plain version, `conv3x3_bias_act_reference`, only
for tensors on the CPU. For CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _plain, sm90_plan


def conv3x3_bias_act_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                               pa: Optional[torch.Tensor] = None,
                               pb: Optional[torch.Tensor] = None, *,
                               relu: bool = True, with_stats: bool = False):
    """Plain version: nine shifted float32 matrix products over the
    zero-padded (optionally affine + ReLU transformed) input, plus the bias,
    optional ReLU, one rounding to x's dtype; statistics from the float32
    value. Not F.conv2d, so independent of cuDNN and its TF32 setting."""
    return _plain.conv3x3_modes_reference(x, w, b, pa, pb, relu=relu, with_stats=with_stats)


def _lib(suffix: str):
    return _plain.bind("conv3x3", f"conv3x3_bias_act_{suffix}",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def _lib_sm90(suffix: str):
    pointers = 8 if suffix == "bf16" else 9   # float32 also takes the planes' scratch
    return _plain.bind("conv3x3", f"conv3x3_bias_act_sm90_{suffix}",
                       [ctypes.c_void_p] * pointers + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def split_weights_tf32(w: torch.Tensor, pitch: Optional[int] = None) -> torch.Tensor:
    """(3, 3, C, O) float32 weights -> their (2, 9, O, pitch) K-major TF32 hi
    and lo planes (pitch C when None), zero from channel C to the pitch: what
    the float32 Hopper bodies split on the card before each conv,
    conv3x3_bias_act's with pitch C and conv3x3_packed's with C rounded up to
    whole 32-channel chunks (the kernel alone, to hold it against
    `_plain.split_weights_tf32_reference`, which runs for CPU tensors)."""
    if w.dim() != 4 or w.shape[:2] != (3, 3) or w.dtype != torch.float32:
        raise ValueError(f"need (3, 3, C, O) float32 weights, got {tuple(w.shape)} {w.dtype}")
    c, o = w.shape[2], w.shape[3]
    pitch = c if pitch is None else pitch
    if pitch < c:
        raise ValueError(f"pitch {pitch} < C = {c}")
    if w.device.type == "cpu":
        return _plain.split_weights_tf32_reference(w, pitch)
    w = w.contiguous()
    planes = torch.empty((2, 9, o, pitch), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        fn = _plain.bind("conv3x3", "conv3x3_split_weights_tf32",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        err = fn(w.data_ptr(), planes.data_ptr(), c, o, pitch,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_weights_tf32 kernel launch failed: cudaError_t {err}")
    return planes


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     pa: Optional[torch.Tensor] = None, pb: Optional[torch.Tensor] = None,
                     *, relu: bool = True, with_stats: bool = False, _legacy: bool = False):
    """y or (y, (sum, sumsq)); see the module docstring.

    `conv3x3_bias_act.calls` counts every call; `conv3x3_bias_act.launches`
    counts launches of the CUDA kernels only, `launches_by_dtype` by the
    activations' type ("bf16", "f32") and `launches_by_path` by kernel body
    ("sm90", "legacy")."""
    _plain.check_conv_args("conv3x3_bias_act", x, w, b, pa, pb)
    if with_stats and relu:
        raise ValueError("with_stats needs relu=False")
    c, o = x.shape[-1], w.shape[-1]
    if pa is not None and (tuple(pa.shape) != (c,) or tuple(pb.shape) != (c,)):
        raise ValueError(f"pa, pb must be ({c},), got {tuple(pa.shape)}, {tuple(pb.shape)}")
    conv3x3_bias_act.calls += 1
    if x.device.type == "cpu":
        return conv3x3_bias_act_reference(x, w, b, pa, pb, relu=relu, with_stats=with_stats)
    suffix = _plain.require_cuda("conv3x3_bias_act", x, w, b, pa, pb)
    n, h, width, _ = x.shape
    y = torch.empty((n, h, width, o), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        raise ValueError("conv3x3_bias_act: empty input")
    w_k = w.to(x.dtype).contiguous()   # what the Hopper kernels read (bf16) or split (float32)
    aligned = x.data_ptr() % 16 == 0 and w_k.data_ptr() % 16 == 0
    plan = sm90_plan.bias_act_plan(n, h, width, c, o, x.dtype, aligned, sm90=not _legacy)
    # the bf16 Hopper kernel reads w in place, the float32 one its TF32 planes;
    # the synchronous one packed weights
    op = -(-o // plan.tile_o) * plan.tile_o
    bf, paf, pbf = _plain.f32_vector(b), _plain.f32_vector(pa), _plain.f32_vector(pb)
    partial = sums = None
    if with_stats:
        partial = torch.empty((plan.partial_rows, 2, op), dtype=torch.float32, device=x.device)
        sums = torch.empty((2, op), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == "sm90":
            weights = [w_k.data_ptr()]
            if suffix == "f32":   # scratch the call fills with the weights' TF32 planes
                planes = torch.empty((2, 9, o, c), dtype=torch.float32, device=x.device)
                weights.append(planes.data_ptr())
            err = _lib_sm90(suffix)(
                x.data_ptr(), *weights, bf.data_ptr(), y.data_ptr(), _plain.ptr(paf),
                _plain.ptr(pbf), _plain.ptr(partial), _plain.ptr(sums), n, h, width, c, o,
                int(relu), int(with_stats), plan.stages, plan.partial_rows, stream)
        else:
            wp = _plain.pack_weights(w, plan.tile_o, x.dtype)
            err = _lib(suffix)(
                x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), _plain.ptr(paf),
                _plain.ptr(pbf), _plain.ptr(partial), _plain.ptr(sums), n, h, width, c,
                wp.shape[2], o, op, plan.tile_o, int(relu), int(with_stats), plan.partial_rows,
                stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bias_act kernel launch failed ({plan.path}): "
                           f"cudaError_t {err}")
    conv3x3_bias_act.launches += 1
    _plain.count(conv3x3_bias_act.launches_by_dtype, (suffix,))
    _plain.count(conv3x3_bias_act.launches_by_path, (plan.path,))
    if with_stats:
        return y, (sums[0, :o], sums[1, :o])
    return y


conv3x3_bias_act.calls = 0
conv3x3_bias_act.launches = 0
conv3x3_bias_act.launches_by_dtype = {}
conv3x3_bias_act.launches_by_path = {}
