"""The plain versions of the port's kernels (the modes of a training step)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain version, so these tests hold the
plain versions against the Pallas kernels; the CUDA kernels are held against
the plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
Inputs come from a numpy seed and are float32 unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas.conv3x3 import conv3x3_bias_act as jax_bias_act  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_grad import conv3x3_wgrad as jax_wgrad  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import conv3x3_packed as jax_packed  # noqa: E402
from hyperpri_tpu.ops.pallas.pool_bwd import max_pool_2x2_bwd_pallas  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd  # noqa: E402
from hyperpri_tpu_torch.ops.pool import max_pool_2x2, pool_bwd_kernel_route  # noqa: E402

# float32 on the CPU: both sides sum the same products in different orders.
ATOL = 2e-5       # conv outputs of magnitude ~1
SUM_RTOL = 1e-4   # per-channel sums over N*H*W <= 800 terms, plus an atol for
SUM_ATOL = 1e-3   # sums that cancel


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _conv_inputs(rng, n, h, w, c, o, prologue):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    pa = pb = None
    if prologue:
        pa = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
        pb = (rng.normal(size=(c,)) * 0.5).astype(np.float32)
    return x, wk, b, pa, pb


_KERNELS = {"packed": (conv3x3_packed, jax_packed), "halo": (conv3x3_bias_act, jax_bias_act)}


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("kernel,n,h,w,c,o", [
    ("packed", 2, 16, 24, 8, 16),
    ("packed", 1, 9, 11, 16, 8),      # odd H and W
    ("packed", 1, 10, 13, 238, 64),   # CubeNET's first conv
    ("packed", 1, 8, 10, 12, 128),    # O = 128
    ("halo", 2, 16, 24, 8, 16),
    ("halo", 1, 9, 11, 16, 136),      # O > 128, odd H and W
    ("halo", 1, 10, 12, 130, 24),     # C > 128
])
def test_conv_stats_and_prologue_match_pallas(rng, kernel, n, h, w, c, o, prologue):
    fn, jax_fn = _KERNELS[kernel]
    x, wk, b, pa, pb = _conv_inputs(rng, n, h, w, c, o, prologue)
    ry, (rs, rss) = jax_fn(*_j(x, wk, b, pa, pb), relu=False, with_stats=True, interpret=True)
    y, (s, ss) = fn(*_t(x, wk, b, pa, pb), relu=False, with_stats=True)
    assert y.shape == (n, h, w, o) and s.shape == ss.shape == (o,)
    assert s.dtype == ss.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(ss.numpy(), np.asarray(rss), rtol=SUM_RTOL, atol=SUM_ATOL)


@pytest.mark.parametrize("kernel", ["packed", "halo"])
def test_prologue_border_is_zero_like_pallas(rng, kernel):
    """A strongly positive shift makes relu(pb) = 3 wherever the border is not
    masked; the SAME border must stay exact zero, as in the Pallas kernels."""
    fn, jax_fn = _KERNELS[kernel]
    c, o = 8, 8
    x = rng.normal(size=(1, 8, 9, c)).astype(np.float32)
    pa = np.full((c,), 0.5, np.float32)
    pb = np.full((c,), 3.0, np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = np.zeros((o,), np.float32)
    ref = jax_fn(*_j(x, wk, b, pa, pb), relu=False, interpret=True)
    out = fn(*_t(x, wk, b, pa, pb), relu=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # and against the definition: pad the activated input with zeros
    z = np.maximum(x * pa + pb, 0.0)
    plain = conv3x3_packed(*_t(z, wk, b), relu=False)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)


@pytest.mark.parametrize("n,h,w,c,o", [
    (2, 16, 24, 16, 8),     # cotangent 16 channels, boundary 8
    (1, 9, 11, 8, 64),      # odd H and W
    (1, 10, 13, 24, 128),   # the widest boundary the epilogue takes
])
def test_packed_bwd_epilogue_matches_pallas(rng, n, h, w, c, o):
    """bwd_x mode: dx = m*dz*pa, dpa = sum m*dz*r, dpb = sum m*dz."""
    g, wt, _, _, _ = _conv_inputs(rng, n, h, w, c, o, False)
    zero = np.zeros((o,), np.float32)
    pa = rng.uniform(0.5, 1.5, size=(o,)).astype(np.float32)
    pb = (rng.normal(size=(o,)) * 0.5).astype(np.float32)
    r = rng.normal(size=(n, h, w, o)).astype(np.float32)
    rdx, (rdpa, rdpb) = jax_packed(*_j(g, wt, zero, pa, pb, r), relu=False, interpret=True)
    dx, (dpa, dpb) = conv3x3_packed(*_t(g, wt, zero, pa, pb, r), relu=False)
    assert float((dx == 0).float().mean()) > 0.1   # the mask does cut
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=ATOL)
    np.testing.assert_allclose(dpa.numpy(), np.asarray(rdpa), rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(dpb.numpy(), np.asarray(rdpb), rtol=SUM_RTOL, atol=SUM_ATOL)


def test_packed_bwd_epilogue_ignores_bias(rng):
    g, wt, b, _, _ = _conv_inputs(rng, 1, 6, 7, 4, 5, False)
    pa, pb = np.ones(5, np.float32), np.zeros(5, np.float32)
    r = rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
    with_b = conv3x3_packed(*_t(g, wt, b, pa, pb, r), relu=False)[0]
    without = conv3x3_packed(*_t(g, wt, np.zeros_like(b), pa, pb, r), relu=False)[0]
    torch.testing.assert_close(with_b, without, rtol=0, atol=0)


def test_modes_reject_bad_combinations():
    x, w, b = torch.zeros((1, 4, 4, 4)), torch.zeros((3, 3, 4, 4)), torch.zeros(4)
    with pytest.raises(ValueError, match="relu=False"):
        conv3x3_packed(x, w, b, relu=True, with_stats=True)
    with pytest.raises(ValueError, match="relu=False"):
        conv3x3_bias_act(x, w, b, relu=True, with_stats=True)
    with pytest.raises(ValueError, match="together"):
        conv3x3_packed(x, w, b, torch.ones(4), None, relu=False)
    with pytest.raises(ValueError, match="bwd_x"):
        conv3x3_packed(x, w, b, bwd_x=x, relu=False)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("n,h,w,c,o", [
    (2, 10, 12, 8, 8),
    (1, 9, 11, 16, 24),     # odd H and W
    (1, 8, 10, 130, 8),     # C > 128
    (1, 8, 10, 12, 136),    # O > 128
])
def test_wgrad_matches_pallas(rng, n, h, w, c, o, prologue):
    x, _, _, pa, pb = _conv_inputs(rng, n, h, w, c, o, prologue)
    g = rng.normal(size=(n, h, w, o)).astype(np.float32)
    ref = jax_wgrad(*_j(x, g, pa, pb), interpret=True)
    out = conv3x3_wgrad(*_t(x, g, pa, pb))
    assert out.shape == (3, 3, c, o) and out.dtype == torch.float32
    # sums of N*H*W <= 240 products of magnitude ~1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _pool_cases(rng):
    yield "quantized", rng.integers(0, 4, (2, 16, 24, 64)).astype(np.float32)
    yield "wide row", rng.integers(0, 4, (1, 8, 968, 64)).astype(np.float32)
    yield "post-relu zeros", np.maximum(rng.normal(size=(1, 6, 10, 256)), 0).astype(np.float32)
    yield "all ties", np.zeros((1, 4, 4, 128), np.float32)
    yield "random", rng.normal(size=(2, 32, 16, 128)).astype(np.float32)


@pytest.mark.parametrize("case", range(5))
def test_pool_bwd_matches_pallas_exactly(rng, case):
    """bf16, as in training; ties included; exact."""
    name, x = list(_pool_cases(rng))[case]
    n, h, w, c = x.shape
    g = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    xj, gj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    ref = np.asarray(max_pool_2x2_bwd_pallas(xj, gj, interpret=True), np.float32)
    out = max_pool_2x2_bwd(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref, err_msg=name)


def test_pool_bwd_neg_inf_window_routes_to_first():
    x = torch.full((1, 2, 2, 1), -float("inf"))
    g = torch.tensor(2.0).reshape(1, 1, 1, 1)
    dx = max_pool_2x2_bwd(x, g)
    assert dx.flatten().tolist() == [2.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("shape", [(1, 9, 11, 3), (2, 64, 64, 8), (1, 6, 8, 5)])
def test_max_pool_gradient_matches_jax(rng, shape):
    """The autograd Function (kernel route or tensor-op route, odd tails
    included) against the JAX package's custom VJP, on tie-heavy input."""
    from hyperpri_tpu.ops.pool import max_pool_2x2 as jax_max_pool_2x2

    x = rng.integers(0, 3, shape).astype(np.float32)
    n, h, w, c = shape
    g = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    y, vjp = jax.vjp(jax_max_pool_2x2, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    calls = max_pool_2x2_bwd.calls
    out = max_pool_2x2(xt)
    out.backward(torch.from_numpy(g))
    assert max_pool_2x2_bwd.calls - calls == int(pool_bwd_kernel_route(h, w, c))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_pool_route_gate():
    assert pool_bwd_kernel_route(608, 968, 64)
    assert pool_bwd_kernel_route(152, 242, 256)
    assert not pool_bwd_kernel_route(76, 121, 512)   # odd W
    assert not pool_bwd_kernel_route(608, 968, 60)   # not whole channel vectors
    assert not pool_bwd_kernel_route(32, 32, 64)     # tiny
