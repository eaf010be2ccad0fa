"""3x3 SAME conv for narrow outputs (O <= 128), in the modes of a training
step: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3_packed.py:conv3x3_packed, as the hand-written
CUDA kernel in csrc/conv3x3_packed.cu.

Contract: y = act(conv3x3_SAME(act_in(x), w) + b) with x (N, H, W, C) NHWC, w
HWIO (3, 3, C, O), b (O,) float32, float32 accumulation and the bias added in
float32 before the optional ReLU; y has x's dtype. On the card x is bf16.
  - prologue `pa, pb` (float32 (C,)): act_in(x) = relu(pa*x + pb), computed in
    float32 and rounded to x's dtype before the products; the SAME border is
    exact zero, not relu(pb).
  - `with_stats` (needs relu=False): returns (y, (sum y, sum y*y)), two float32
    (O,) vectors over N, H, W taken from the float32 value before y is rounded.
  - `bwd_x` (the backward epilogue): x is a cotangent, w the flipped and
    transposed weights, b is ignored, pa/pb are the (O,) affine of the boundary
    and bwd_x the saved raw producer output (N, H, W, O). With dz the float32
    conv and m = (pa*bwd_x + pb > 0): returns (dx, (dpa, dpb)) with
    dx = m*dz*pa rounded, dpa = sum m*dz*bwd_x, dpb = sum m*dz in float32.
The per-channel sums are deterministic on the card: per-block partials added
in a fixed order, no float atomics. The source note in the .cu file gives the
kernel's bound and design.

`conv3x3_packed` runs the plain version, `conv3x3_packed_reference`, only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _build, _plain

MAX_OUT = 128
_KC = 32  # input-channel chunk of the kernel; packed weights pad C to it
_TH, _TW = 8, 32  # the kernel's pixel tile: one row of partial sums per tile
_MODE_PLAIN, _MODE_STATS, _MODE_BWD = 0, 1, 2


def conv3x3_packed_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             pa: Optional[torch.Tensor] = None,
                             pb: Optional[torch.Tensor] = None,
                             bwd_x: Optional[torch.Tensor] = None, *,
                             relu: bool = True, with_stats: bool = False):
    """Plain version: a float32 sum of nine shifted (N,H,W,C)x(C,O) products
    over the zero-padded input, plus the bias, optional ReLU, then one rounding
    to x's dtype; the modes as the module docstring states them. Deliberately
    not F.conv2d, so it does not depend on cuDNN's TF32 setting (matmul stays
    in full float32 unless torch.backends.cuda.matmul.allow_tf32 is set)."""
    if bwd_x is None:
        return _plain.conv3x3_modes_reference(x, w, b, pa, pb, relu=relu,
                                              with_stats=with_stats)
    dz = _plain.conv3x3_same_f32(x, w)
    r = bwd_x.float()
    a = pa.float()
    mdz = torch.where(r * a + pb.float() > 0, dz, torch.zeros_like(dz))
    return (mdz * a).to(x.dtype), ((mdz * r).sum(dim=(0, 1, 2)), mdz.sum(dim=(0, 1, 2)))


def _check(x, w, b, pa, pb, bwd_x, relu, with_stats):
    _plain.check_conv_args("conv3x3_packed", x, w, b, pa, pb, MAX_OUT)
    if with_stats and relu:
        raise ValueError("with_stats needs relu=False")
    if bwd_x is not None:
        if relu or with_stats or pa is None:
            raise ValueError("bwd_x needs pa/pb and excludes relu and with_stats")
        expect = tuple(x.shape[:3]) + (w.shape[-1],)
        if tuple(bwd_x.shape) != expect or bwd_x.dtype != x.dtype:
            raise ValueError(f"bwd_x must be {expect} {x.dtype}, got "
                             f"{tuple(bwd_x.shape)} {bwd_x.dtype}")
    channels = w.shape[-1] if bwd_x is not None else x.shape[-1]
    if pa is not None and (tuple(pa.shape) != (channels,) or tuple(pb.shape) != (channels,)):
        raise ValueError(f"pa, pb must be ({channels},), got {tuple(pa.shape)}, "
                         f"{tuple(pb.shape)}")


def _lib():
    fn = _build.load("conv3x3_packed").conv3x3_packed_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3x3_packed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   pa: Optional[torch.Tensor] = None, pb: Optional[torch.Tensor] = None,
                   bwd_x: Optional[torch.Tensor] = None, *,
                   relu: bool = True, with_stats: bool = False):
    """y, (y, (sum, sumsq)) or (dx, (dpa, dpb)); see the module docstring.

    `conv3x3_packed.calls` counts every call (the kernel route was taken);
    `conv3x3_packed.launches` counts launches of the CUDA kernel only."""
    _check(x, w, b, pa, pb, bwd_x, relu, with_stats)
    conv3x3_packed.calls += 1
    if x.device.type == "cpu":
        return conv3x3_packed_reference(x, w, b, pa, pb, bwd_x, relu=relu,
                                        with_stats=with_stats)
    _plain.require_cuda_bf16("conv3x3_packed", x, w, b, pa, pb, bwd_x)
    if bwd_x is not None and not bwd_x.is_contiguous():
        raise ValueError("bwd_x must be a contiguous NHWC tensor")
    n, h, width, c = x.shape
    o = w.shape[-1]
    y = torch.empty((n, h, width, o), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        raise ValueError("conv3x3_packed: empty input")
    mode = _MODE_BWD if bwd_x is not None else _MODE_STATS if with_stats else _MODE_PLAIN
    wp = _plain.pack_weights(w, 64 if o <= 64 else 128, _KC)
    np_ = wp.shape[1]
    bf, paf, pbf = _plain.f32_vector(b), _plain.f32_vector(pa), _plain.f32_vector(pb)
    rows = n * -(-h // _TH) * -(-width // _TW)
    partial = sums = None
    if mode != _MODE_PLAIN:
        partial = torch.empty((rows, 2, np_), dtype=torch.float32, device=x.device)
        sums = torch.empty((2, np_), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), _plain.ptr(paf),
            _plain.ptr(pbf), _plain.ptr(bwd_x), _plain.ptr(partial), _plain.ptr(sums),
            n, h, width, c, wp.shape[2], o, np_, int(relu), mode, rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_packed kernel launch failed: cudaError_t {err}")
    conv3x3_packed.launches += 1
    if mode == _MODE_PLAIN:
        return y
    return y, (sums[0, :o], sums[1, :o])


conv3x3_packed.calls = 0
conv3x3_packed.launches = 0
