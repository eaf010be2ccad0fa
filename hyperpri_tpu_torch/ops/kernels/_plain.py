"""Plain float32 arithmetic shared by the kernels' plain versions, and the
argument checks and C bindings shared by their CUDA wrappers.

The plain versions are built from explicit float32 tensor arithmetic (shifted
matrix products, sums), not from F.conv2d or autograd of a convolution, so
they do not depend on cuDNN or its TF32 setting.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from hyperpri_tpu_torch.ops.kernels import _build


def prologue_act(x: torch.Tensor, pa: Optional[torch.Tensor],
                 pb: Optional[torch.Tensor]) -> torch.Tensor:
    """The convs' input transform: x itself without an affine; with one,
    relu(pa*x + pb) per channel computed in float32 and rounded to x's dtype
    (what the kernels feed their products)."""
    if pa is None:
        return x
    return torch.relu(x.float() * pa.float() + pb.float()).to(x.dtype)


def pad_same(z: torch.Tensor) -> torch.Tensor:
    """Float32 copy of NHWC z with the one-pixel zero border of a SAME 3x3
    conv. The border is exact zero whatever the prologue: it pads z, not x."""
    return F.pad(z.float(), (0, 0, 1, 1, 1, 1))


def conv3x3_same_f32(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float32 sum of the nine shifted (N,H,W,C) x (C,O) products of a SAME
    3x3 conv; z NHWC, w HWIO."""
    _, h, width, _ = z.shape
    zp = pad_same(z)
    wf = w.float()
    y = None
    for dh in range(3):
        for dw in range(3):
            tap = torch.matmul(zp[:, dh:dh + h, dw:dw + width, :], wf[dh, dw])
            y = tap if y is None else y + tap
    return y


def conv3x3_modes_reference(x, w, b, pa=None, pb=None, *, relu: bool, with_stats: bool):
    """y = act(conv3x3_SAME(act_in(x), w) + b) in float32 with one rounding to
    x's dtype; with_stats also returns (sum y, sum y*y) per output channel over
    N, H, W, taken from the float32 value before that rounding."""
    if with_stats and relu:
        raise ValueError("with_stats needs relu=False")
    y = conv3x3_same_f32(prologue_act(x, pa, pb), w) + b.float()
    if relu:
        y = torch.relu(y)
    out = y.to(x.dtype)
    if with_stats:
        return out, (y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2)))
    return out


def fold_stats_cotangent(gy, gsum, gsumsq, y, dtype):
    """g_eff = (g_y + g_sum) + (2*y)*g_sumsq in float32, rounded to `dtype`: the
    effective cotangent of a statistics conv's output y (conv_train.py:195-199
    of the JAX package). A missing cotangent is zero."""
    g = gy.float() if gy is not None else torch.zeros_like(y, dtype=torch.float32)
    if gsum is not None:
        g = g + gsum.float()
    if gsumsq is not None:
        g = g + 2.0 * y.float() * gsumsq.float()
    return g.to(dtype).contiguous()


def first_max_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward of a 2x2, stride-2 VALID max pool in tensor ops (port of
    hyperpri_tpu/ops/pool.py:70-86): the cotangent g (N, H//2, W//2, C) goes
    to the first element of each window, in row-major order, that is >= the
    window's maximum; odd tails of x, which the pool drops, get zero."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    xs = (x[:, :h2 * 2, :w2 * 2, :].reshape(n, h2, 2, w2, 2, c)
          .permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4, c))
    eq = xs >= xs.amax(dim=3, keepdim=True)
    first = eq & (torch.cumsum(eq.to(torch.int32), dim=3) == 1)
    dxs = torch.where(first, g.unsqueeze(3), torch.zeros((), dtype=g.dtype, device=g.device))
    dx = (dxs.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
          .reshape(n, h2 * 2, w2 * 2, c))
    if h2 * 2 != h or w2 * 2 != w:
        dx = F.pad(dx, (0, 0, 0, w - w2 * 2, 0, h - h2 * 2))
    return dx


def check_conv_args(name: str, x, w, b, pa, pb, max_out: Optional[int] = None,
                    framed: bool = False):
    """Shapes of a 3x3 conv call. With `framed`, x may be a framed buffer
    whose channel pitch exceeds C; C is then w's (framing.py)."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"need x (N,H,W,C), w (3,3,C,O), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c, o = (w.shape[2] if framed else x.shape[-1]), w.shape[-1]
    if tuple(w.shape) != (3, 3, c, o) or b.shape[0] != o:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if max_out is not None and o > max_out:
        raise ValueError(f"{name} requires O <= {max_out}, got {o}")
    if c < 1:
        raise ValueError(f"{name} needs at least one input channel")
    if (pa is None) != (pb is None):
        raise ValueError("pa and pb come together")


# The activation types the CUDA kernels take, by the suffix of their C entry
# points (csrc/*.cu: <name>_bf16, <name>_f32).
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def require_cuda(name: str, x: torch.Tensor, *others: torch.Tensor) -> str:
    """The CUDA kernels take contiguous bf16 or float32 activations; every
    other operand lies on x's device. Returns the entry points' suffix for x's
    dtype; raises on anything else (there is no fallback)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operands must share one CUDA device; got "
                             f"{x.device} and {t.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes bf16 or float32 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    return KERNEL_DTYPES[x.dtype]


def bind(library: str, symbol: str, argtypes):
    """The C entry point `symbol` of csrc/<library>.cu, built and loaded at
    first use, with its argument types set."""
    fn = getattr(_build.load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def f32_vector(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if v is None else v.to(torch.float32).contiguous()


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def chunk_channels(dtype: torch.dtype) -> int:
    """Input channels of the conv kernels' 64-byte staging chunk: 32 bf16 or
    16 float32. Packed weights pad C to a multiple of it."""
    return 64 // torch.empty((), dtype=dtype).element_size()


def pack_weights(w: torch.Tensor, tile: int, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, C, O) -> (9, OP, Cp) in `dtype`: wp[3*dh+dw, o, c] = w[dh, dw, c, o],
    zero-padded to OP a multiple of `tile` outputs and Cp a whole staging
    chunk of inputs."""
    _, _, c, o = w.shape
    kc = chunk_channels(dtype)
    op = -(-o // tile) * tile
    cp = -(-c // kc) * kc
    wp = torch.zeros((9, op, cp), dtype=dtype, device=w.device)
    wp[:, :o, :c] = w.to(dtype).permute(0, 1, 3, 2).reshape(9, o, c)
    return wp


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 `t`: round to the 10 mantissa bits of TF32,
    to nearest with ties away from zero, the low 13 bits zero; NaN stays
    NaN."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (sign | mag).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(t), t, out)


def split_tf32_reference(t: torch.Tensor):
    """(hi, lo) of float32 `t` as the 3xTF32 kernels split an operand: hi =
    tf32(t), lo = tf32(t - hi); t - hi is exact in float32 and hi + lo is
    within 2**-21 of t relative (split_tf32 in csrc/conv3x3_common.cuh)."""
    hi = tf32_rna(t.float())
    return hi, tf32_rna(t.float() - hi)


def split_weights_tf32_reference(w: torch.Tensor, pitch: Optional[int] = None) -> torch.Tensor:
    """(3, 3, C, O) float32 weights -> (2, 9, O, pitch): planes[0][tap][o][c] =
    hi and planes[1][tap][o][c] = lo of w[dh][dw][c][o] (tap = 3*dh + dw) for
    c < C, zero from C to the pitch (C when None): the K-major TF32 halves
    the float32 Hopper convs read."""
    _, _, c, o = w.shape
    hi, lo = split_tf32_reference(w.float().permute(0, 1, 3, 2).reshape(9, o, c))
    planes = torch.stack([hi, lo])
    pitch = c if pitch is None else pitch
    return F.pad(planes, (0, pitch - c)) if pitch > c else planes


def count(counts: dict, names) -> None:
    """Add one to each name's entry of a wrapper's by-framing counter."""
    for name in names:
        counts[name] = counts.get(name, 0) + 1
