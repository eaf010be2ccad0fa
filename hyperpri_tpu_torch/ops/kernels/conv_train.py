"""Trainable 3x3 SAME convs: the forward kernels with hand-written backwards
(port of hyperpri_tpu/ops/pallas/conv_train.py:102-371, the three custom VJPs).

No kernel of its own: each `torch.autograd.Function` chains conv3x3_packed,
conv3x3_bias_act and conv3x3_wgrad.

    conv3x3_bias_train(x, w, b)                   -> y
    conv3x3_bias_stats_train(x, w, b)             -> y, sum(y), sum(y*y)
    conv3x3_bnact_stats_train(x, pa, pb, w, b)    -> the same for z = relu(pa*x + pb)

x (N, H, W, C) in the compute dtype (bf16 or float32; the roundings below are
the identity at float32), w HWIO (3, 3, C, O) in the same dtype (the cast of
the float32 parameter, so that autograd's cast node carries dW back), b (O,)
float32, pa/pb (C,) float32. Backward:
  - the cotangent of y is cast to x's dtype; the statistics' cotangents fold
    into it, g_eff = g_y + g_sum[c] + 2*y*g_sumsq[c], computed in float32 from
    the saved rounded y and rounded to the compute dtype. This pass stays
    here, as in the reference: the adjoint conv reads g_eff too, and
    conv3x3_wgrad's fold mode (g_eff and db formed in the weight gradient)
    is ported but not wired, pending a measured gain (PERF.md §6);
  - dx = conv3x3_SAME(g_eff, W') with W'[dh,dw,o,c] = W[2-dh,2-dw,c,o] and a
    zero bias, skipped when x needs no gradient;
  - dW from conv3x3_wgrad in float32, rounded to w's dtype; db = sum g_eff in
    float32;
  - through z = relu(pa*x + pb): narrow boundaries take the backward epilogue
    of conv3x3_packed (mask, dx = m*dz*pa, dpa, dpb in the kernel); wider ones
    take conv3x3_bias_act for dz and plain tensor ops for the rest.
Routing by width, as the reference has it: a forward conv with O <= 64 takes
conv3x3_packed, a wider one conv3x3_bias_act; the plain VJP's adjoint goes by
the same rule on its own output width (= C); the statistics VJP's adjoint
stays on conv3x3_packed up to 128 outputs; the BatchNorm-ReLU boundary takes
the packed epilogue up to `packed_max_bc` (64) channels.

Framing (conv_train.py:146-247 of the reference; framing.py): the statistics
conv with `pre_padded_hw` takes x as the host pre-padded ingest buffer, read in
place forward and by the weight gradient; dx is None (the ingest buffer is
leaf data). The reference's arena chain (arena_out -> arena_hw, arena-g
backwards) is not wired here: on the TPU it saves the pad and slice passes
between convs, but the CUDA kernels read unframed tensors with no pad pass,
so an arena only adds a zeroed buffer and a copy of g_eff per conv. The
kernels keep the arena modes (conv3x3_packed.py, conv3x3_grad.py).
"""

from __future__ import annotations

import torch

from hyperpri_tpu_torch.ops.kernels._plain import fold_stats_cotangent
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed

PACKED_MAX_O = 64            # forward outputs up to here take conv3x3_packed
PACKED_MAX_ADJOINT = 128     # adjoint outputs (= C) of the stats VJP likewise
BNACT_PACKED_MAX_BC = 64     # boundary widths that take the backward epilogue


def _conv_route(x, w, b, pa=None, pb=None, *, relu, with_stats=False, **framing):
    """One 3x3 SAME conv, routed by its output width (conv_train.py:57-80).
    The pre-padded framing is packed-route only."""
    if w.shape[-1] <= PACKED_MAX_O:
        return conv3x3_packed(x, w, b, pa, pb, relu=relu, with_stats=with_stats, **framing)
    if any(framing.values()):
        raise ValueError("pre-padded geometry is packed-route only")
    return conv3x3_bias_act(x, w, b, pa, pb, relu=relu, with_stats=with_stats)


def _wgrad(x, g, w_dtype, pa=None, pb=None, **framing):
    """dW in w's dtype: float32 out of the kernel, then rounded as the
    reference's `.astype(w.dtype)` does."""
    return conv3x3_wgrad(x, g, pa, pb, **framing).to(w_dtype)


def _adjoint_weights(w):
    """W'[dh,dw,o,c] = W[2-dh,2-dw,c,o]: the adjoint of a stride-1 SAME conv
    is a SAME conv with the spatially flipped, channel-transposed kernel."""
    return w.flip(0, 1).permute(0, 1, 3, 2).contiguous()


def _zero_bias(w):
    return torch.zeros((w.shape[2],), dtype=torch.float32, device=w.device)


class _BiasTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _conv_route(x, w, b, relu=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _conv_route(g, _adjoint_weights(w), _zero_bias(w), relu=False)
        return dx, _wgrad(x, g, w.dtype), g.float().sum(dim=(0, 1, 2))


class _BiasStatsTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pre_padded_hw):
        framed = pre_padded_hw is not None
        y, (s, ss) = _conv_route(x, w, b, relu=False, with_stats=True, pre_padded=framed,
                                 logical_hw=pre_padded_hw)
        ctx.save_for_backward(x, w, y)
        ctx.pre_padded_hw = pre_padded_hw
        return y, s, ss

    @staticmethod
    def backward(ctx, gy, gsum, gsumsq):
        x, w, y = ctx.saved_tensors
        g_eff = fold_stats_cotangent(gy, gsum, gsumsq, y, x.dtype)
        if ctx.pre_padded_hw is not None:
            # the ingest buffer is leaf data: no dx (conv_train.py:204-211)
            dw = _wgrad(x, g_eff, w.dtype, pre_padded_c=w.shape[2])
            return None, dw, g_eff.float().sum(dim=(0, 1, 2)), None
        dx = None
        if ctx.needs_input_grad[0]:
            # Adjoint outputs (= C) up to 128 stay on the packed kernel
            # (conv_train.py:213-244), wider ones take the halo kernel.
            wt, zero = _adjoint_weights(w), _zero_bias(w)
            if w.shape[2] <= PACKED_MAX_ADJOINT:
                dx = conv3x3_packed(g_eff, wt, zero, relu=False)
            else:
                dx = conv3x3_bias_act(g_eff, wt, zero, relu=False)
        return dx, _wgrad(x, g_eff, w.dtype), g_eff.float().sum(dim=(0, 1, 2)), None


class _BnactStatsTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pa, pb, w, b, packed_max_bc):
        y, (s, ss) = _conv_route(x, w, b, pa, pb, relu=False, with_stats=True)
        ctx.save_for_backward(x, pa, pb, w, y)
        ctx.packed_max_bc = packed_max_bc
        return y, s, ss

    @staticmethod
    def backward(ctx, gy, gsum, gsumsq):
        x, pa, pb, w, y = ctx.saved_tensors
        g_eff = fold_stats_cotangent(gy, gsum, gsumsq, y, x.dtype)
        dx = dpa = dpb = None
        if any(ctx.needs_input_grad[:3]):
            wt, zero = _adjoint_weights(w), _zero_bias(w)
            if w.shape[2] <= ctx.packed_max_bc:
                # mask, scale and the two reductions in the kernel's epilogue
                dx, (dpa, dpb) = conv3x3_packed(g_eff, wt, zero, pa, pb, x, relu=False)
            else:
                # wider boundary: the kernel computes dz; the backward through
                # z = relu(pa*x + pb) is plain tensor code (conv_train.py:355-365)
                dz = _conv_route(g_eff, wt, zero, relu=False).float()
                x32 = x.float()
                mdz = torch.where(x32 * pa + pb > 0, dz, torch.zeros_like(dz))
                dx = (mdz * pa).to(x.dtype)
                dpa = (mdz * x32).sum(dim=(0, 1, 2))
                dpb = mdz.sum(dim=(0, 1, 2))
        dw = _wgrad(x, g_eff, w.dtype, pa, pb)
        return dx, dpa, dpb, dw, g_eff.float().sum(dim=(0, 1, 2)), None


def conv3x3_bias_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = conv3x3_SAME(x, w) + b, differentiable (conv_train.py:102-143)."""
    return _BiasTrain.apply(x, w, b)


def conv3x3_bias_stats_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             pre_padded_hw=None):
    """(y, sum_c(y), sumsq_c(y)): the conv and the BatchNorm batch statistics
    of its output from the kernel's epilogue (conv_train.py:146-247).
    `pre_padded_hw` = logical (h, w) when x is the host pre-padded ingest
    buffer (no dx then)."""
    return _BiasStatsTrain.apply(x, w, b, pre_padded_hw)


def conv3x3_bnact_stats_train(x: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                              w: torch.Tensor, b: torch.Tensor,
                              packed_max_bc: int = BNACT_PACKED_MAX_BC):
    """BatchNorm-apply + ReLU + conv + statistics in one differentiable call
    (conv_train.py:250-371): z = relu(pa*x + pb) never exists in device memory.
    x is the raw output of the producing conv, pa = gamma*rsqrt(var + eps),
    pb = beta - mean*pa. `packed_max_bc` is the widest boundary whose backward
    takes the kernel's epilogue (the reference's _BNACT_PACKED_MAX_BC)."""
    if packed_max_bc > 128:
        raise ValueError("the backward epilogue takes boundaries up to 128 channels")
    return _BnactStatsTrain.apply(x, pa, pb, w, b, packed_max_bc)
