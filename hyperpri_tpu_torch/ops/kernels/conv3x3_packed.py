"""3x3 SAME conv for narrow outputs (O <= 128), in the modes of a training
step: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3_packed.py:conv3x3_packed, as the hand-written
CUDA kernel in csrc/conv3x3_packed.cu.

Contract: y = act(conv3x3_SAME(act_in(x), w) + b) with x (N, H, W, C) NHWC, w
HWIO (3, 3, C, O), b (O,) float32, float32 accumulation and the bias added in
float32 before the optional ReLU; y has x's dtype. On the card x is bf16 (bf16
tensor-core products) or float32 (3xTF32 products, about 2**-21 relative
each).
  - prologue `pa, pb` (float32 (C,)): act_in(x) = relu(pa*x + pb), computed in
    float32 and rounded to x's dtype before the products (the identity at
    float32); the SAME border is exact zero, not relu(pb).
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

Framings (the JAX kernel's, hyperpri_tpu/ops/pallas/conv3x3_packed.py:376-391;
geometry in framing.py). Each operand is a framed view of its buffer:
  - `pre_padded` (needs `logical_hw`): x is the host pre-padded ingest buffer,
    logical (0,0) at (1,1) and zeros everywhere else; the true C comes from w.
    Excludes the prologue, `bwd_x` and the arena reads.
  - `arena_in` (needs `logical_hw`): with the prologue, x is an arena (logical
    (0,0) at (8,8), anything in the frame, NaN included); with `bwd_x`, the
    residual bwd_x is an arena.
  - `arena_g` (needs `logical_hw`): x, the cotangent of an adjoint conv, is a
    zero-framed arena.
  - `arena_out`: y is returned as a zero-framed arena, of bwd_x's shape when
    bwd_x is an arena (dx then matches the framed input it is the gradient
    of), else of framing.arena_shape; the statistics stay over the logical
    region.
The JAX kernel's `lane_stride` is the width of the output tile, which the
plan picks from O (64 for O <= 64, else 128). Only the logical region of a
framed input is read: the Hopper kernel's tensor maps cover just that region
(TMA zero-fills the rest), the synchronous one zero-fills it by select, and
the plain version slices it out.

On the card the call takes one of two kernel bodies, chosen before the launch
by sm90_plan.packed_plan from its dtype and layout: "sm90", the Hopper
kernels (persistent blocks, TMA staging into mbarrier rings, wgmma; views
TMA can address with C <= 256: in bf16 with O % 8 == 0, reading w in place;
in float32 with an even O, by 3xTF32 on the weights' K-major TF32 hi and lo
planes, which the call first writes with a pitch of whole 32-channel
chunks), or "legacy", the synchronous mma.sync kernel on packed weights
(layouts TMA cannot take, e.g. C = 238 unframed). The private keyword
`_legacy=True` takes the synchronous body whatever the layout, to hold the
two bodies against each other.

`conv3x3_packed` runs the plain version, `conv3x3_packed_reference`, only for
tensors on the CPU. For CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _plain, framing, sm90_plan
from hyperpri_tpu_torch.ops.kernels.framing import Frame

MAX_OUT = 128
_MODE_PLAIN, _MODE_STATS, _MODE_BWD = 0, 1, 2


class _Framing(NamedTuple):
    """The resolved geometry of one call: logical sizes, the frames of x, y
    and bwd_x, and the output buffer's shape."""

    n: int
    h: int
    w: int
    c: int
    o: int
    fx: Frame
    fy: Frame
    fr: Frame
    y_shape: tuple
    names: tuple


def _resolve(x, w, pa, bwd_x, *, logical_hw, arena_in, arena_out, arena_g, pre_padded) -> _Framing:
    """Check the framing flags against each other and the buffers (the JAX
    kernel's rules, conv3x3_packed.py:458-). Raises on what the kernel does
    not take."""
    bwd = bwd_x is not None
    prologue = pa is not None and not bwd
    n, c, o = x.shape[0], w.shape[2], w.shape[3]
    if arena_g and prologue:
        raise ValueError("arena_g conflicts with the prologue")
    if pre_padded and (arena_in or arena_g or prologue or bwd):
        raise ValueError("pre_padded is the bare host-ingest conv: no arena reads, no "
                         "prologue, no bwd epilogue")
    if arena_in and not (prologue or bwd):
        raise ValueError("arena_in frames the prologue's input or the residual bwd_x")
    framed_x = pre_padded or arena_g or (arena_in and prologue)
    if framed_x or (arena_in and bwd):
        if logical_hw is None:
            raise ValueError("a framed operand needs logical_hw")
        h, width = logical_hw
    else:
        h, width = x.shape[1], x.shape[2]
        if logical_hw is not None and tuple(logical_hw) != (h, width):
            raise ValueError(f"logical_hw {tuple(logical_hw)} != x's {(h, width)}")
    if not framed_x and tuple(x.shape[1:]) != (h, width, c):
        raise ValueError(f"shape mismatch: x must be (N, {h}, {width}, {c}), got "
                         f"{tuple(x.shape)}")
    if pre_padded:
        fx = Frame.of(x, framing.INGEST_OFFSET)
    elif framed_x:
        fx = Frame.of(x, framing.ARENA_OFFSET)
    else:
        fx = Frame.of(x)
    fx.check("conv3x3_packed x", h, width, c)
    fr = Frame(h, width, o)
    if bwd:
        if arena_in:
            if bwd_x.dim() != 4 or bwd_x.shape[0] != n:
                raise ValueError(f"arena bwd_x {tuple(bwd_x.shape)} mismatches n={n}")
            fr = Frame.of(bwd_x, framing.ARENA_OFFSET)
            fr.check("conv3x3_packed bwd_x", h, width, o)
        elif tuple(bwd_x.shape) != (n, h, width, o):
            raise ValueError(f"bwd_x must be {(n, h, width, o)}, got {tuple(bwd_x.shape)}")
    if arena_out:
        y_shape = (tuple(bwd_x.shape) if bwd and arena_in
                   else framing.arena_shape(n, h, width, o))
        fy = Frame(y_shape[1], y_shape[2], y_shape[3], framing.ARENA_OFFSET,
                   framing.ARENA_OFFSET)
        fy.check("conv3x3_packed y", h, width, o)
    else:
        y_shape = (n, h, width, o)
        fy = Frame(h, width, o)
    names = tuple(name for name, on in (("pre_padded", pre_padded), ("arena_in", arena_in),
                                        ("arena_out", arena_out), ("arena_g", arena_g)) if on)
    return _Framing(n, h, width, c, o, fx, fy, fr, y_shape, names or ("unframed",))


def _framing_kwargs(kwargs):
    return {k: kwargs.get(k, v) for k, v in
            (("logical_hw", None), ("arena_in", False), ("arena_out", False),
             ("arena_g", False), ("pre_padded", False))}


def conv3x3_packed_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             pa: Optional[torch.Tensor] = None,
                             pb: Optional[torch.Tensor] = None,
                             bwd_x: Optional[torch.Tensor] = None, *,
                             relu: bool = True, with_stats: bool = False, **framing_flags):
    """Plain version: a float32 sum of nine shifted (N,H,W,C)x(C,O) products
    over the zero-padded input, plus the bias, optional ReLU, then one rounding
    to x's dtype; the modes as the module docstring states them. Deliberately
    not F.conv2d, so it does not depend on cuDNN's TF32 setting (matmul stays
    in full float32 unless torch.backends.cuda.matmul.allow_tf32 is set).
    Framed operands are sliced to their logical views first, and a framed
    output is written into a zero buffer."""
    f = _resolve(x, w, pa, bwd_x, **_framing_kwargs(framing_flags))
    x = f.fx.logical(x, f.h, f.w, f.c)
    if bwd_x is None:
        out = _plain.conv3x3_modes_reference(x, w, b, pa, pb, relu=relu, with_stats=with_stats)
    else:
        dz = _plain.conv3x3_same_f32(x, w)
        r = f.fr.logical(bwd_x, f.h, f.w, f.o).float()
        a = pa.float()
        mdz = torch.where(r * a + pb.float() > 0, dz, torch.zeros_like(dz))
        out = (mdz * a).to(x.dtype), ((mdz * r).sum(dim=(0, 1, 2)), mdz.sum(dim=(0, 1, 2)))
    if f.y_shape == (f.n, f.h, f.w, f.o):
        return out
    y = out[0] if isinstance(out, tuple) else out
    framed = y.new_zeros(f.y_shape)
    f.fy.logical(framed, f.h, f.w, f.o).copy_(y)
    return (framed, out[1]) if isinstance(out, tuple) else framed


def _check(x, w, b, pa, pb, bwd_x, relu, with_stats):
    _plain.check_conv_args("conv3x3_packed", x, w, b, pa, pb, MAX_OUT, framed=True)
    if with_stats and relu:
        raise ValueError("with_stats needs relu=False")
    if bwd_x is not None:
        if relu or with_stats or pa is None:
            raise ValueError("bwd_x needs pa/pb and excludes relu and with_stats")
        if bwd_x.dtype != x.dtype:
            raise ValueError(f"bwd_x must be {x.dtype}, got {bwd_x.dtype}")
    channels = w.shape[-1] if bwd_x is not None else w.shape[2]
    if pa is not None and (tuple(pa.shape) != (channels,) or tuple(pb.shape) != (channels,)):
        raise ValueError(f"pa, pb must be ({channels},), got {tuple(pa.shape)}, "
                         f"{tuple(pb.shape)}")


def _lib(suffix: str):
    return _plain.bind("conv3x3_packed", f"conv3x3_packed_{suffix}",
                       [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def _lib_sm90(suffix: str):
    if suffix == "bf16":
        return _plain.bind("conv3x3_packed", "conv3x3_packed_sm90_bf16",
                           [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int)]
                           + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    # float32 also takes the weights' planes as scratch
    return _plain.bind("conv3x3_packed", "conv3x3_packed_sm90_f32",
                       [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def _plan(x, w, bwd_x, f: _Framing, legacy: bool) -> sm90_plan.PackedPlan:
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return sm90_plan.packed_plan(f.n, f.h, f.w, f.c, f.o, x.dtype, f.fx.pitch,
                                 bwd=bwd_x is not None, aligned=aligned, sm90=not legacy,
                                 y_pitch=f.fy.pitch, r_pitch=f.fr.pitch)


def call_plan(x: torch.Tensor, w: torch.Tensor, pa: Optional[torch.Tensor] = None,
              bwd_x: Optional[torch.Tensor] = None, *, _legacy: bool = False,
              **framing_flags) -> sm90_plan.PackedPlan:
    """The plan (kernel body, tiling, rings, grid) that conv3x3_packed takes
    for these operands on the card; w as the wrapper reads it (x's dtype,
    contiguous)."""
    f = _resolve(x, w, pa, bwd_x, **_framing_kwargs(framing_flags))
    return _plan(x, w, bwd_x, f, _legacy)


def conv3x3_packed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   pa: Optional[torch.Tensor] = None, pb: Optional[torch.Tensor] = None,
                   bwd_x: Optional[torch.Tensor] = None, *,
                   relu: bool = True, with_stats: bool = False, logical_hw=None,
                   arena_in: bool = False, arena_out: bool = False, arena_g: bool = False,
                   pre_padded: bool = False, _legacy: bool = False):
    """y, (y, (sum, sumsq)) or (dx, (dpa, dpb)); see the module docstring.

    `conv3x3_packed.calls` counts every call (the kernel route was taken);
    `conv3x3_packed.launches` counts launches of the CUDA kernels only,
    `calls_by_framing` / `launches_by_framing` count them by framing flag
    ("unframed" for a call without one), `launches_by_dtype` by the
    activations' type ("bf16", "f32") and `launches_by_path` by kernel body
    ("sm90", "legacy")."""
    _check(x, w, b, pa, pb, bwd_x, relu, with_stats)
    flags = dict(logical_hw=logical_hw, arena_in=arena_in, arena_out=arena_out,
                 arena_g=arena_g, pre_padded=pre_padded)
    f = _resolve(x, w, pa, bwd_x, **flags)
    conv3x3_packed.calls += 1
    _plain.count(conv3x3_packed.calls_by_framing, f.names)
    if x.device.type == "cpu":
        return conv3x3_packed_reference(x, w, b, pa, pb, bwd_x, relu=relu,
                                        with_stats=with_stats, **flags)
    suffix = _plain.require_cuda("conv3x3_packed", x, w, b, pa, pb, bwd_x)
    if bwd_x is not None and not bwd_x.is_contiguous():
        raise ValueError("bwd_x must be a contiguous NHWC tensor")
    n, h, width, c, o = f.n, f.h, f.w, f.c, f.o
    alloc = torch.zeros if arena_out else torch.empty   # an arena's frame is zero
    y = alloc(f.y_shape, dtype=x.dtype, device=x.device)
    if n * h * width == 0:
        raise ValueError("conv3x3_packed: empty input")
    mode = _MODE_BWD if bwd_x is not None else _MODE_STATS if with_stats else _MODE_PLAIN
    w_k = w.to(x.dtype).contiguous()   # what the Hopper kernels read (bf16) or split (float32)
    plan = _plan(x, w_k, bwd_x, f, _legacy)
    np_ = plan.tile_o
    bf, paf, pbf = _plain.f32_vector(b), _plain.f32_vector(pa), _plain.f32_vector(pb)
    partial = sums = None
    if mode != _MODE_PLAIN:
        partial = torch.empty((plan.partial_rows, 2, np_), dtype=torch.float32, device=x.device)
        sums = torch.empty((2, np_), dtype=torch.float32, device=x.device)
    frames = framing.frames_arg(f.fx, f.fy, f.fr)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == "sm90" and suffix == "bf16":
            # the bf16 Hopper kernel reads w in place, the float32 one its TF32
            # planes; the synchronous one packed weights
            err = _lib_sm90(suffix)(
                x.data_ptr(), w_k.data_ptr(), bf.data_ptr(), y.data_ptr(), _plain.ptr(paf),
                _plain.ptr(pbf), _plain.ptr(bwd_x), _plain.ptr(partial), _plain.ptr(sums),
                frames, n, h, width, c, o, np_, plan.tile_rows, int(plan.resident),
                plan.stages, plan.w_stages, plan.grid[0], int(relu), mode, plan.partial_rows,
                stream)
        elif plan.path == "sm90":
            planes = torch.empty((2, 9, o, framing.round_up(c, sm90_plan.F32_CHUNK)),
                                 dtype=torch.float32, device=x.device)
            err = _lib_sm90(suffix)(
                x.data_ptr(), w_k.data_ptr(), planes.data_ptr(), bf.data_ptr(), y.data_ptr(),
                _plain.ptr(paf), _plain.ptr(pbf), _plain.ptr(bwd_x), _plain.ptr(partial),
                _plain.ptr(sums), frames, n, h, width, c, o, np_, plan.w_stages, plan.grid[0],
                int(relu), mode, plan.partial_rows, stream)
        else:
            wp = _plain.pack_weights(w, np_, x.dtype)
            err = _lib(suffix)(
                x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), _plain.ptr(paf),
                _plain.ptr(pbf), _plain.ptr(bwd_x), _plain.ptr(partial), _plain.ptr(sums),
                frames, n, h, width, c, wp.shape[2], o, np_, int(relu), mode, int(pre_padded),
                plan.partial_rows, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_packed kernel launch failed ({plan.path}): "
                           f"cudaError_t {err}")
    conv3x3_packed.launches += 1
    _plain.count(conv3x3_packed.launches_by_framing, f.names)
    _plain.count(conv3x3_packed.launches_by_dtype, (suffix,))
    _plain.count(conv3x3_packed.launches_by_path, (plan.path,))
    if mode == _MODE_PLAIN:
        return y
    return y, (sums[0, :o], sums[1, :o])


conv3x3_packed.calls = 0
conv3x3_packed.launches = 0
conv3x3_packed.calls_by_framing = {}
conv3x3_packed.launches_by_framing = {}
conv3x3_packed.launches_by_dtype = {}
conv3x3_packed.launches_by_path = {}
