"""Weight gradient of the 3x3 SAME conv: the port of the TPU kernel
hyperpri_tpu/ops/pallas/conv3x3_grad.py:conv3x3_wgrad, as the hand-written
CUDA kernel in csrc/conv3x3_grad.cu.

Contract: dW[dh,dw,c,o] = sum_{n,h,w} z_pad[n,h+dh,w+dw,c] * g[n,h,w,o], a
float32 (3, 3, C, O) tensor, for x (N, H, W, C) and the cotangent g
(N, H, W, O) of one dtype (bf16 or float32 on the card, float32 by 3xTF32
products). z = x, or with `pa, pb` (float32 (C,)) z = relu(pa*x + pb)
recomputed from the raw x in float32 and rounded to x's dtype, with the SAME
border exact zero. On the card the long pixel axis is split across blocks
and the partials are added in a fixed order: no float atomics, two runs give
the same bits. The source note in the .cu file gives the kernel's bound and
design.

Framings (the JAX kernel's, hyperpri_tpu/ops/pallas/conv3x3_grad.py:184-330;
geometry in framing.py). x and g are framed views of their buffers:
  - `pre_padded_c=C`: x is the host pre-padded ingest buffer (logical (0,0) at
    (1,1), zeros elsewhere) of C true channels; excludes the prologue and
    the arena modes;
  - `arena_in`: x is an arena (logical (0,0) at (8,8), anything in the frame);
    needs the prologue, whose pa gives C;
  - `arena_g` (needs `logical_hw`): g is a zero-framed arena whose channel
    width is O.
Logical (h, w) come from g, or from `logical_hw` when g is framed. Only the
logical regions are read. The JAX kernel's `pad_w_to` has no counterpart: it
names the width of a pad pass the CUDA kernel never makes.

Fold mode (`y`, `gsum`, `gsumsq` together; conv3x3_grad.py:101-118 of the
JAX package): g is the raw cotangent gy of a statistics conv, y its saved
output (g's shape and dtype, and with `arena_g` framed alike), gsum and
gsumsq the (O,) cotangents of its statistics. The effective cotangent
g_eff = (gy + gsum) + (2y)*gsumsq is formed in float32 on the logical
region, rounded to g's dtype, and the call returns (dW of g_eff,
db = sum of the rounded g_eff in float32). With `arena_g`, O is gsum's
length. No model path calls it: conv_train.py materializes g_eff, which the
adjoint conv reads too.

On the card the call takes one of two kernel bodies, chosen before the launch
by sm90_plan.wgrad_plan from its dtype, mode and layout (`call_plan`):
"sm90", the Hopper kernels (TMA staging, wgmma, 3xTF32 in float32; views
whose channel pitch TMA can address, a multiple of 8 in bf16 and of 4 in
float32, from 16-byte aligned buffers, y's too in fold mode: every call of a
bf16 or float32 training step, the ingest buffer included), or "legacy", the
synchronous mma.sync kernel (other layouts, such as C = 238 unframed). A fold
call takes the splits of the same call without the fold, so its dW is bit
for bit the non-fold body's on the materialized g_eff. The private keyword
`_legacy=True` takes the synchronous body whatever the layout: the two
bodies are held against each other with it.

`conv3x3_wgrad` runs the plain version, `conv3x3_wgrad_reference`, only for
tensors on the CPU. For CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hyperpri_tpu_torch.ops.kernels import _plain, framing, sm90_plan
from hyperpri_tpu_torch.ops.kernels.framing import Frame

def _resolve(x, g, pa, arena_in, arena_g, logical_hw, pre_padded_c, fold_o=None):
    """(n, h, w, c, o, frame of x, frame of g, framing names); raises on what
    the kernel does not take (the JAX kernel's rules, conv3x3_grad.py:243-330).
    `fold_o`: gsum's length in fold mode, which is O under `arena_g`."""
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"need x (N,H,W,C) and g (N,H,W,O); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    if pre_padded_c is not None and (arena_in or arena_g or pa is not None):
        raise ValueError("pre_padded_c is a raw read of the ingest buffer: no arena "
                         "modes, no prologue")
    if arena_in and pa is None:
        raise ValueError("arena_in x needs the prologue (its pa gives C)")
    if arena_g:
        if logical_hw is None:
            raise ValueError("arena_g needs logical_hw")
        h, width = logical_hw
        fg = Frame.of(g, framing.ARENA_OFFSET)
    else:
        h, width = g.shape[1], g.shape[2]
        if logical_hw is not None and tuple(logical_hw) != (h, width):
            raise ValueError(f"logical_hw {tuple(logical_hw)} != g's {(h, width)}")
        fg = Frame.of(g)
    o = fold_o if arena_g and fold_o is not None else g.shape[-1]
    if arena_in:
        c, fx = pa.shape[0], Frame.of(x, framing.ARENA_OFFSET)
    elif pre_padded_c is not None:
        c, fx = pre_padded_c, Frame.of(x, framing.INGEST_OFFSET)
    else:
        c, fx = x.shape[-1], Frame.of(x)
        if tuple(x.shape[1:3]) != (h, width):
            raise ValueError(f"x {tuple(x.shape)} and g's logical {(h, width)} differ")
    fx.check("conv3x3_wgrad x", h, width, c)
    fg.check("conv3x3_wgrad g", h, width, o)
    names = tuple(name for name, on in (("pre_padded", pre_padded_c is not None),
                                        ("arena_in", arena_in), ("arena_g", arena_g)) if on)
    return x.shape[0], h, width, c, o, fx, fg, names or ("unframed",)


def _check_fold(g, y, gsum, gsumsq):
    """Fold mode's operands come together, y like g, the statistics' cotangents
    of one length (conv3x3_grad.py:243-247). Returns whether the call folds."""
    given = [t is not None for t in (y, gsum, gsumsq)]
    if any(given) and not all(given):
        raise ValueError("fold mode needs y, gsum and gsumsq together")
    if not all(given):
        return False
    if y.shape != g.shape or y.dtype != g.dtype:
        raise ValueError(f"y {tuple(y.shape)} {y.dtype} must match g {tuple(g.shape)} {g.dtype}")
    if gsum.dim() != 1 or gsum.shape != gsumsq.shape:
        raise ValueError(f"gsum, gsumsq must be (O,), got {tuple(gsum.shape)}, "
                         f"{tuple(gsumsq.shape)}")
    return True


def _wgrad_plain(x, g, pa, pb, h, width, c, o):
    """Per tap, the float32 product of the shifted, zero-padded input
    (C, N*H*W) with the cotangent (N*H*W, O), on logical views."""
    zp = _plain.pad_same(_plain.prologue_act(x, pa, pb))
    g2 = g.float().reshape(-1, o)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dwi in range(3):
            dw[dh, dwi] = zp[:, dh:dh + h, dwi:dwi + width, :].reshape(-1, c).t() @ g2
    return dw


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor,
                            pa: Optional[torch.Tensor] = None,
                            pb: Optional[torch.Tensor] = None, *,
                            y: Optional[torch.Tensor] = None,
                            gsum: Optional[torch.Tensor] = None,
                            gsumsq: Optional[torch.Tensor] = None, arena_in: bool = False,
                            arena_g: bool = False, logical_hw=None,
                            pre_padded_c: Optional[int] = None):
    """Plain version: dW as float32 products of the logical views; in fold
    mode g_eff first (conv_train's arithmetic, _plain.fold_stats_cotangent),
    then (dW of g_eff, sum of g_eff)."""
    fold = _check_fold(g, y, gsum, gsumsq)
    _, h, width, c, o, fx, fg, _ = _resolve(x, g, pa, arena_in, arena_g, logical_hw,
                                            pre_padded_c, gsum.shape[0] if fold else None)
    x, g = fx.logical(x, h, width, c), fg.logical(g, h, width, o)
    if not fold:
        return _wgrad_plain(x, g, pa, pb, h, width, c, o)
    g_eff = _plain.fold_stats_cotangent(g, gsum, gsumsq, fg.logical(y, h, width, o), g.dtype)
    return _wgrad_plain(x, g_eff, pa, pb, h, width, c, o), g_eff.float().sum(dim=(0, 1, 2))


def _lib(suffix: str):
    """conv3x3_wgrad_<suffix>: the synchronous entries ("bf16", "f32") and
    the Hopper fold entries ("sm90_fold_bf16", ...), which take the same
    arguments, the ring's depth where the former take x_lanes_zero."""
    return _plain.bind("conv3x3_grad", f"conv3x3_wgrad_{suffix}",
                       [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _lib_sm90(suffix: str):
    return _plain.bind("conv3x3_grad", f"conv3x3_wgrad_sm90_{suffix}",
                       [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _plan(x, g, y, n, h, width, c, o, fx, fg, legacy):
    """The wgrad plan of a resolved call: the alignment of x's, g's and, in
    fold mode, y's buffers (y lies in g's frame) as the data pointers give
    it."""
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    fold = y is not None
    return sm90_plan.wgrad_plan(n, h, width, c, o, x.dtype, fx.pitch, fg.pitch, fold, aligned,
                                sm90=not legacy, y_pitch=fg.pitch if fold else None,
                                y_aligned=not fold or y.data_ptr() % 16 == 0)


def call_plan(x: torch.Tensor, g: torch.Tensor, pa: Optional[torch.Tensor] = None, *,
              y: Optional[torch.Tensor] = None, gsum: Optional[torch.Tensor] = None,
              gsumsq: Optional[torch.Tensor] = None, arena_in: bool = False,
              arena_g: bool = False, logical_hw=None, pre_padded_c: Optional[int] = None,
              _legacy: bool = False) -> sm90_plan.WgradPlan:
    """The plan (kernel body, splits, ring) that conv3x3_wgrad takes for
    these operands on the card."""
    fold = _check_fold(g, y, gsum, gsumsq)
    n, h, width, c, o, fx, fg, _ = _resolve(x, g, pa, arena_in, arena_g, logical_hw,
                                            pre_padded_c, gsum.shape[0] if fold else None)
    return _plan(x, g, y, n, h, width, c, o, fx, fg, _legacy)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, pa: Optional[torch.Tensor] = None,
                  pb: Optional[torch.Tensor] = None, *, y: Optional[torch.Tensor] = None,
                  gsum: Optional[torch.Tensor] = None, gsumsq: Optional[torch.Tensor] = None,
                  arena_in: bool = False, arena_g: bool = False, logical_hw=None,
                  pre_padded_c: Optional[int] = None, _legacy: bool = False):
    """dW (3, 3, C, O) float32, or in fold mode (dW, db (O,) float32); see the
    module docstring.

    `conv3x3_wgrad.calls` counts every call; `conv3x3_wgrad.launches` counts
    launches of the CUDA kernel only, `calls_by_framing` /
    `launches_by_framing` count them by framing ("unframed" without one),
    `launches_by_dtype` by the activations' type ("bf16", "f32"),
    `launches_by_mode` by mode ("dw", "fold") and `launches_by_path` by
    kernel body ("sm90", "legacy")."""
    if g.dtype != x.dtype:
        raise TypeError(f"x and g must share a dtype, got {x.dtype} and {g.dtype}")
    if (pa is None) != (pb is None):
        raise ValueError("pa and pb come together")
    fold = _check_fold(g, y, gsum, gsumsq)
    flags = dict(arena_in=arena_in, arena_g=arena_g, logical_hw=logical_hw,
                 pre_padded_c=pre_padded_c)
    n, h, width, c, o, fx, fg, names = _resolve(x, g, pa, arena_in, arena_g, logical_hw,
                                                pre_padded_c, gsum.shape[0] if fold else None)
    if pa is not None and (tuple(pa.shape) != (c,) or tuple(pb.shape) != (c,)):
        raise ValueError(f"pa, pb must be ({c},), got {tuple(pa.shape)}, {tuple(pb.shape)}")
    if fold and gsum.shape[0] != o:
        raise ValueError(f"gsum, gsumsq must be ({o},), got {tuple(gsum.shape)}")
    conv3x3_wgrad.calls += 1
    _plain.count(conv3x3_wgrad.calls_by_framing, names)
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g, pa, pb, y=y, gsum=gsum, gsumsq=gsumsq, **flags)
    suffix = _plain.require_cuda("conv3x3_wgrad", x, g, pa, pb, y, gsum, gsumsq)
    if not g.is_contiguous() or (fold and not y.is_contiguous()):
        raise ValueError("conv3x3_wgrad: g and y must be contiguous NHWC tensors")
    if n * h * width == 0:
        raise ValueError("conv3x3_wgrad: empty input")
    plan = _plan(x, g, y, n, h, width, c, o, fx, fg, _legacy)
    paf, pbf = _plain.f32_vector(pa), _plain.f32_vector(pb)
    gsf, gssf = _plain.f32_vector(gsum), _plain.f32_vector(gsumsq)
    cols = 9 * c * o + (o if fold else 0)
    partial = torch.empty((plan.splits, cols), dtype=torch.float32, device=x.device)
    out = torch.empty((cols,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == "sm90" and fold:
            err = _lib(f"sm90_fold_{suffix}")(
                x.data_ptr(), g.data_ptr(), y.data_ptr(), gsf.data_ptr(), gssf.data_ptr(),
                _plain.ptr(paf), _plain.ptr(pbf), partial.data_ptr(), out.data_ptr(),
                framing.frames_arg(fx, fg), n, h, width, c, o, plan.splits, plan.stages, stream)
        elif plan.path == "sm90":
            err = _lib_sm90(suffix)(
                x.data_ptr(), g.data_ptr(), _plain.ptr(paf), _plain.ptr(pbf), partial.data_ptr(),
                out.data_ptr(), framing.frames_arg(fx, fg), n, h, width, c, o, plan.splits,
                plan.stages, stream)
        else:
            err = _lib(suffix)(
                x.data_ptr(), g.data_ptr(), _plain.ptr(y), _plain.ptr(gsf), _plain.ptr(gssf),
                _plain.ptr(paf), _plain.ptr(pbf), partial.data_ptr(), out.data_ptr(),
                framing.frames_arg(fx, fg), n, h, width, c, o, plan.splits,
                int(pre_padded_c is not None), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad kernel launch failed ({plan.path}): "
                           f"cudaError_t {err}")
    conv3x3_wgrad.launches += 1
    _plain.count(conv3x3_wgrad.launches_by_framing, names)
    _plain.count(conv3x3_wgrad.launches_by_dtype, (suffix,))
    _plain.count(conv3x3_wgrad.launches_by_mode, ("fold" if fold else "dw",))
    _plain.count(conv3x3_wgrad.launches_by_path, (plan.path,))
    dw = out[:9 * c * o].view(3, 3, c, o)
    return (dw, out[9 * c * o:]) if fold else dw


conv3x3_wgrad.calls = 0
conv3x3_wgrad.launches = 0
conv3x3_wgrad.calls_by_framing = {}
conv3x3_wgrad.launches_by_framing = {}
conv3x3_wgrad.launches_by_dtype = {}
conv3x3_wgrad.launches_by_mode = {}
conv3x3_wgrad.launches_by_path = {}
