"""Port's model parts (hyperpri_tpu_torch/models/parts.py, ops/pool.py)
against their flax counterparts in float32 on the CPU, with the same flax
variables loaded through hyperpri_tpu_torch.weights.load_jax_variables."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import parts as jparts  # noqa: E402
from hyperpri_tpu.ops.pool import max_pool_2x2 as jax_max_pool_2x2  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.pool import max_pool_2x2  # noqa: E402
from hyperpri_tpu_torch.weights import load_jax_variables  # noqa: E402

# float32 convs on the CPU (XLA vs oneDNN) sum in different orders.
ATOL = RTOL = 1e-5


def _variables(module, rng, *xs):
    """flax init, with seeded non-trivial BatchNorm running statistics."""
    variables = jax.tree.map(np.asarray, module.init(jax.random.key(0), *xs, train=False))
    stats = jax.tree.map(
        lambda a: (np.abs(rng.normal(0.5, 0.3, a.shape)) + 0.1).astype(np.float32),
        variables.get("batch_stats", {}))
    return variables["params"], stats


def _run_flax(module, params, stats, *xs):
    return np.asarray(module.apply({"params": params, "batch_stats": stats}, *xs, train=False))


def _run_port(module, params, stats, *xs):
    load_jax_variables(module, params, stats)
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(x)) for x in xs)).numpy()


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_double_conv_unfolded(rng):
    x = _normal(rng, 2, 9, 11, 6)
    fm = jparts.DoubleConv(10, 7)
    params, stats = _variables(fm, rng, x)
    out = _run_port(parts.DoubleConv(6, 10, 7), params, stats, x)
    np.testing.assert_allclose(out, _run_flax(fm, params, stats, x), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_double_conv_folded(rng, monkeypatch, use_kernels):
    """Folded DoubleConv; with use_kernels and the pixel gate lowered, both
    convs (40->48, 48->48) take the conv3x3_packed route (plain version on the
    CPU), which adds the bias in float32."""
    monkeypatch.setattr(parts, "SERVING_MIN_PIXELS", 0)
    x = _normal(rng, 1, 9, 11, 40)
    fm = jparts.DoubleConv(48, fused_bn=True, use_pallas=True)
    params, stats = _variables(fm, rng, x)
    calls = conv3x3_packed.calls
    out = _run_port(parts.DoubleConv(40, 48, fused_bn=True, use_kernels=use_kernels),
                    params, stats, x)
    assert conv3x3_packed.calls - calls == (2 if use_kernels else 0)
    np.testing.assert_allclose(out, _run_flax(fm, params, stats, x), atol=ATOL, rtol=RTOL)


def test_down_odd_size(rng):
    x = _normal(rng, 1, 9, 11, 8)
    fm = jparts.Down(12)
    params, stats = _variables(fm, rng, x)
    out = _run_port(parts.Down(8, 12), params, stats, x)
    assert out.shape == (1, 4, 5, 12)
    np.testing.assert_allclose(out, _run_flax(fm, params, stats, x), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bilinear", [False, True])
def test_up_odd_skip(rng, bilinear):
    """Deeper map 5x7 -> 10x14, center-padded to the 11x15 skip."""
    x1 = _normal(rng, 1, 5, 7, 8 if bilinear else 16)
    x2 = _normal(rng, 1, 11, 15, 8)
    fm = jparts.Up(16, 12, bilinear=bilinear)
    params, stats = _variables(fm, rng, x1, x2)
    out = _run_port(parts.Up(16, 12, bilinear=bilinear), params, stats, x1, x2)
    assert out.shape == (1, 11, 15, 6 if bilinear else 12)
    np.testing.assert_allclose(out, _run_flax(fm, params, stats, x1, x2),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("target", [(8, 9), (5, 6), (6, 11)])
def test_pad_to_match_odd(rng, target):
    x = _normal(rng, 1, 5, 6, 3)
    ref = np.asarray(jparts.pad_to_match(jnp.asarray(x), *target))
    out = parts.pad_to_match(torch.from_numpy(x), *target).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", [(1, 9, 11, 4), (2, 8, 6, 3), (1, 121, 5, 2)])
def test_max_pool_2x2_floors_odd_sizes(rng, shape):
    x = _normal(rng, *shape)
    ref = np.asarray(jax_max_pool_2x2(jnp.asarray(x)))
    out = max_pool_2x2(torch.from_numpy(x)).numpy()
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(5, 7), (1, 4)])
def test_upsample2x_align_corners(rng, hw):
    x = _normal(rng, 1, *hw, 3)
    ref = np.asarray(jparts.upsample2x_align_corners(jnp.asarray(x)))
    out = parts.upsample2x_align_corners(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_load_rejects_unused_leaf(rng):
    x = _normal(rng, 1, 6, 6, 4)
    fm = jparts.DoubleConv(5)
    params, stats = _variables(fm, rng, x)
    params = dict(params, extra={"kernel": np.zeros((1,), np.float32)})
    with pytest.raises(ValueError, match="unused params"):
        load_jax_variables(parts.DoubleConv(4, 5), params, stats)
