"""The port's trainable convs (hyperpri_tpu_torch/ops/kernels/conv_train.py,
three torch.autograd.Functions) against the JAX package's custom VJPs run with
interpret=True on the CPU, and against plain autograd.

A scalar loss that weighs y, sum(y) and sum(y*y) drives all three cotangents.
Inputs come from a numpy seed. On CPU tensors the wrappers run their plain
versions, so this holds the VJP glue and the plain versions together.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas import conv_train as jct  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import conv_train as ct  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402

# float32: sums of <= 9*C*N*H*W products of magnitude <= 1 in two orders.
F32 = dict(atol=1e-3, rtol=1e-3)
# bf16: both sides round at the same places (operands, y, g_eff, dx, dW), but
# a float32 sum that differs in its last bits can round to the neighbouring
# bf16 value, 2**-8 relative; cotangents here reach magnitude ~8.
BF16 = dict(atol=8 * 2.0 ** -7, rtol=2.0 ** -6)

# (n, h, w, c, o): forward route by o (<= 64 packed), adjoint route by c.
SHAPES = {
    "packed": (2, 8, 10, 16, 8),
    "halo": (1, 9, 11, 12, 72),          # forward halo (o > 64), adjoint packed
    "wide_adjoint": (1, 6, 8, 136, 8),   # adjoint output c > 128: halo kernel
}


def _inputs(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
    pa = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    pb = (rng.normal(size=(c,)) * 0.5).astype(np.float32)
    gy = rng.normal(size=(n, h, w, o)).astype(np.float32)
    gs = rng.normal(size=(o,)).astype(np.float32)
    gss = (rng.normal(size=(o,)) * 0.5).astype(np.float32)
    return x, wk, b, pa, pb, gy, gs, gss


def _jax_side(kind, arrays, dtype):
    """(outputs, grads) of the JAX custom VJP, interpret mode."""
    x, wk, b, pa, pb, gy, gs, gss = (jnp.asarray(a) for a in arrays)
    x, wk, gy = x.astype(dtype), wk.astype(dtype), gy.astype(dtype)
    if kind == "bias":
        out, vjp = jax.vjp(lambda x, w, b: jct.conv3x3_bias_train(x, w, b, True), x, wk, b)
        return (out,), vjp(gy)
    if kind == "stats":
        out, vjp = jax.vjp(lambda x, w, b: jct.conv3x3_bias_stats_train(x, w, b, True),
                           x, wk, b)
    else:
        out, vjp = jax.vjp(
            lambda x, pa, pb, w, b: jct.conv3x3_bnact_stats_train(x, pa, pb, w, b, True),
            x, pa, pb, wk, b)
    return out, vjp((gy, gs, gss))


def _torch_side(kind, arrays, dtype, packed_max_bc=64):
    x, wk, b, pa, pb, gy, gs, gss = (torch.from_numpy(a) for a in arrays)
    x = x.to(dtype).requires_grad_()
    wk = wk.to(dtype).requires_grad_()
    b.requires_grad_()
    gy = gy.to(dtype)
    if kind == "bias":
        out = (ct.conv3x3_bias_train(x, wk, b),)
        leaves, cot = (x, wk, b), (gy,)
    elif kind == "stats":
        out = ct.conv3x3_bias_stats_train(x, wk, b)
        leaves, cot = (x, wk, b), (gy, gs, gss)
    else:
        pa.requires_grad_()
        pb.requires_grad_()
        out = ct.conv3x3_bnact_stats_train(x, pa, pb, wk, b, packed_max_bc)
        leaves, cot = (x, pa, pb, wk, b), (gy, gs, gss)
    grads = torch.autograd.grad(out, leaves, cot)
    return out, grads


def _compare(got, want, tol, names):
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["bias", "stats", "bnact"])
def test_function_matches_jax_vjp(rng, kind, shape, dtype):
    arrays = _inputs(rng, *SHAPES[shape])
    tol = F32 if dtype == "float32" else BF16
    jout, jgrads = _jax_side(kind, arrays, getattr(jnp, dtype))
    tout, tgrads = _torch_side(kind, arrays, getattr(torch, dtype))
    assert tout[0].dtype == getattr(torch, dtype)
    _compare(tout, jout, tol, ["y", "sum", "sumsq"][:len(tout)])
    names = ["dx", "dpa", "dpb", "dw", "db"] if kind == "bnact" else ["dx", "dw", "db"]
    assert tgrads[names.index("dw")].dtype == getattr(torch, dtype)   # rounded like w
    assert tgrads[names.index("db")].dtype == torch.float32
    _compare(tgrads, jgrads, tol, names)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bnact_wide_boundary_matches_jax_vjp(rng, dtype):
    """Boundary wider than 64 channels: dz from the conv kernel, then the mask,
    dx, dpa and dpb in tensor ops (the reference's halo branch)."""
    arrays = _inputs(rng, 1, 6, 8, 72, 8)
    tol = F32 if dtype == "float32" else BF16
    calls = conv3x3_packed.calls
    jout, jgrads = _jax_side("bnact", arrays, getattr(jnp, dtype))
    tout, tgrads = _torch_side("bnact", arrays, getattr(torch, dtype))
    # forward (o = 8) is packed; the adjoint (72 outputs > 64) is not
    assert conv3x3_packed.calls - calls == 1
    _compare(tout, jout, tol, ["y", "sum", "sumsq"])
    _compare(tgrads, jgrads, tol, ["dx", "dpa", "dpb", "dw", "db"])


def test_bnact_both_backward_branches_agree(rng):
    """The kernel's backward epilogue (boundary <= packed_max_bc) and the
    tensor-op branch compute the same dx, dpa, dpb."""
    arrays = _inputs(rng, 1, 7, 9, 24, 16)
    _, fused = _torch_side("bnact", arrays, torch.float32, packed_max_bc=64)
    _, unfused = _torch_side("bnact", arrays, torch.float32, packed_max_bc=8)
    for a, b, name in zip(fused, unfused, ["dx", "dpa", "dpb", "dw", "db"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("kind", ["bias", "stats", "bnact"])
def test_function_matches_plain_autograd_float64(rng, kind):
    """Against autograd of F.conv2d in float64 (the plain versions compute in
    float32, so the limit is float32 round-off of the sums)."""
    arrays = _inputs(rng, 2, 6, 7, 5, 6)
    _, got = _torch_side(kind, arrays, torch.float32)
    x, wk, b, pa, pb, gy, gs, gss = (torch.from_numpy(a).double() for a in arrays)
    leaves = [t.requires_grad_() for t in ((x, pa, pb, wk, b) if kind == "bnact" else (x, wk, b))]
    z = torch.relu(x * pa + pb) if kind == "bnact" else x
    y = F.conv2d(z.permute(0, 3, 1, 2), wk.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)
    loss = (y * gy).sum()
    if kind != "bias":
        loss = loss + (y.sum(dim=(0, 1, 2)) * gs).sum() + ((y * y).sum(dim=(0, 1, 2)) * gss).sum()
    want = torch.autograd.grad(loss, leaves)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.double(), w_, rtol=1e-4, atol=1e-4)


def test_first_conv_skips_the_adjoint(rng):
    """An input that needs no gradient (the cube) costs no adjoint conv."""
    x, wk, b = (torch.from_numpy(a) for a in _inputs(rng, 1, 6, 7, 5, 6)[:3])
    wk.requires_grad_()
    b.requires_grad_()
    counts = [f.calls for f in (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)]
    y, s, ss = ct.conv3x3_bias_stats_train(x, wk, b)
    (y.sum() + s.sum() + ss.sum()).backward()
    after = [f.calls for f in (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)]
    assert [a - c for a, c in zip(after, counts)] == [1, 0, 1]   # forward and dW only
    assert wk.grad is not None and b.grad is not None


def test_forward_routes_by_output_width(rng):
    for o, packed in ((64, 1), (65, 0)):
        x, wk, b = (torch.from_numpy(a) for a in _inputs(rng, 1, 4, 5, 3, o)[:3])
        calls = conv3x3_packed.calls, conv3x3_bias_act.calls
        ct.conv3x3_bias_train(x, wk, b)
        assert conv3x3_packed.calls - calls[0] == packed
        assert conv3x3_bias_act.calls - calls[1] == 1 - packed
