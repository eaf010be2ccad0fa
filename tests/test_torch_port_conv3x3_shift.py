"""The port's conv3x3_bias_act_shift (the 3x3 SAME conv + bias + ReLU built
from three H-shifted input bands) against the JAX package's Pallas kernel,
run in interpret mode: C = 24 and 130 (one and two 128-lane chunks of the
TPU kernel), and C = 64 with O = 256 (two O tiles of the card's bf16 Hopper
body, whose second tile stages the bands again, four of its float32 one),
ragged H and W, ReLU on and off, float32 and bf16.

Inputs come from a numpy seed. On CPU tensors the wrapper runs its plain
version: the code that chip_smoke.py holds the CUDA kernel against.
Tolerances: float32, within 1e-5 of each output's sum of absolute terms
(two float32 summation orders of 9*C + 1 terms); bf16 outputs within one
bf16 ulp of max(|a|, |b|, 2**-6) (both sum the exact bf16 products in
float32 and round once; the floor covers outputs that cancel).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas.conv3x3_shift import (  # noqa: E402
    conv3x3_bias_act_shift as jax_shift,
)
from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import (  # noqa: E402
    conv3x3_bias_act_shift,
    conv3x3_bias_act_shift_reference,
)

F32_REL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.normal(size=(o,))).astype(np.float32)
    return x, wk, b


def _bf16_ulps(out, ref):
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -6)
    return float(((o - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("n,h,w,c,o", [(1, 13, 21, 24, 40), (2, 9, 19, 130, 72),
                                       (1, 11, 35, 64, 256)])
def test_shift_matches_pallas(rng, n, h, w, c, o, relu, dtype):
    tdt, jdt = DTYPES[dtype]
    x, wk, b = _inputs(rng, n, h, w, c, o)
    ref = jax_shift(jnp.asarray(x).astype(jdt), jnp.asarray(wk).astype(jdt), jnp.asarray(b),
                    relu=relu, interpret=True)
    xt, wt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(wk).to(tdt), torch.from_numpy(b)
    out = conv3x3_bias_act_shift(xt, wt, bt, relu=relu)
    assert tuple(out.shape) == (n, h, w, o) and out.dtype == tdt
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(tdt)
    if dtype == "bf16":
        assert _bf16_ulps(out, ref) <= 1.0
        return
    terms = conv3x3_bias_act_shift_reference(xt.abs(), wt.abs(), bt.abs(), relu=False)
    err = (out.double() - ref.double()).abs()
    assert bool((err <= F32_REL * terms.double()).all()), float((err / terms.double()).max())


def test_shift_out_dtype_float32_from_bf16(rng):
    """out_dtype: bf16 inputs, float32 output (one rounding fewer)."""
    x, wk, b = _inputs(rng, 1, 11, 17, 24, 16)
    xb, wb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wk).astype(jnp.bfloat16)
    ref = np.asarray(jax_shift(xb, wb, jnp.asarray(b), relu=True, out_dtype=jnp.float32,
                               interpret=True))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(wk).bfloat16()
    out = conv3x3_bias_act_shift(xt, wt, torch.from_numpy(b), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    terms = conv3x3_bias_act_shift_reference(xt.abs(), wt.abs(), torch.from_numpy(b).abs(),
                                             relu=False, out_dtype=torch.float32)
    assert np.all(np.abs(out.numpy() - ref) <= F32_REL * terms.numpy())


def test_shift_matches_the_halo_conv_plain_version(rng):
    """Kernel 2's function: the shift conv's plain version equals
    conv3x3_bias_act's (no prologue, no statistics) bit for bit."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act_reference

    x, wk, b = (torch.from_numpy(a) for a in _inputs(rng, 2, 10, 14, 24, 40))
    for relu in (True, False):
        torch.testing.assert_close(conv3x3_bias_act_shift(x, wk, b, relu=relu),
                                   conv3x3_bias_act_reference(x, wk, b, relu=relu),
                                   rtol=0, atol=0)
