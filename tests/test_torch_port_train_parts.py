"""Training forms of the port's model parts (TorchBatchNorm, Conv3x3,
DoubleConv, Down, Up) against their flax counterparts in float32 on the CPU,
from one flax init loaded through hyperpri_tpu_torch.weights.

On the CPU the flax modules take XLA's conv (their kernel gate needs a TPU);
the port's modules run with their gates lowered, so the same layers go through
the trainable kernel convs (plain versions on CPU tensors). Both are the same
function in float32, up to summation order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import parts as jparts  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

# float32 convs and reductions in two summation orders.
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
LOW_GATES = dict(min_pixels=0, min_channels=4)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _init(module, rng, *xs):
    variables = jax.tree.map(np.asarray, module.init(jax.random.key(0), *xs, train=False))
    params = jax.tree.map(lambda a: a + 0.1 * _normal(rng, *a.shape), variables["params"])
    stats = jax.tree.map(lambda a: (np.abs(rng.normal(0.5, 0.3, a.shape)) + 0.1).astype(np.float32),
                         variables.get("batch_stats", {}))
    return params, stats


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _assert_trees_close(got, want, tol, what):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=f"{what} {path}", **tol)


def _flax_train(module, params, stats, g, *xs):
    """Output, gradients of sum(out * g) and new batch_stats, train=True."""
    def loss(p):
        out, upd = module.apply({"params": p, "batch_stats": stats}, *xs, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd["batch_stats"])
    (_, (out, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), grads, new_stats


def _port_train(module, params, stats, g, *xs):
    load_jax_variables(module, params, stats)
    out = module(*(torch.from_numpy(x) for x in xs), train=True)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), export_flax_trees(module)


@pytest.mark.parametrize("mode", ["reduce", "precomputed", "affine_only"])
def test_batch_norm_training_form(rng, mode):
    """Output (or the folded affine), gradients of scale, bias and x, and the
    running statistics (unbiased variance, momentum 0.1) against flax."""
    x = _normal(rng, 2, 5, 7, 6) * 2.0 + 0.5
    g = _normal(rng, 2, 5, 7, 6)
    fm = jparts.TorchBatchNorm()
    variables = fm.init(jax.random.key(0), jnp.asarray(x), use_running_average=True)
    params = {"scale": _normal(rng, 6) * 0.2 + 1.0, "bias": _normal(rng, 6) * 0.2}
    stats = {"mean": _normal(rng, 6), "var": np.abs(_normal(rng, 6)) + 0.5}
    assert sorted(variables["params"]) == ["bias", "scale"]

    def flax_loss(p, xj):
        pre = (jnp.sum(xj, (0, 1, 2)), jnp.sum(xj * xj, (0, 1, 2))) if mode != "reduce" else None
        out, upd = fm.apply({"params": p, "batch_stats": stats}, xj, use_running_average=False,
                            precomputed=pre, affine_only=mode == "affine_only",
                            mutable=["batch_stats"])
        if mode == "affine_only":
            out = out[0] * xj + out[1]
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (ref, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        flax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = parts.TorchBatchNorm(6)
    load_jax_variables(bn, params, stats)
    xt = torch.from_numpy(x).requires_grad_()
    pre = (xt.sum((0, 1, 2)), (xt * xt).sum((0, 1, 2))) if mode != "reduce" else None
    out = bn(xt, train=True, precomputed=pre, affine_only=mode == "affine_only")
    if mode == "affine_only":
        assert out[0].shape == out[1].shape == (6,)
        out = out[0] * xt + out[1]
    assert out.dtype == torch.float32
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), **GRAD_TOL)
    trees = export_flax_trees(bn)
    _assert_trees_close(trees["grads"], ref_gp, GRAD_TOL, "grads")
    _assert_trees_close(trees["batch_stats"], ref_stats, TOL, "batch_stats")
    assert not np.allclose(trees["batch_stats"]["mean"], stats["mean"])


def test_batch_norm_eval_leaves_running_stats(rng):
    bn = parts.TorchBatchNorm(4)
    before = bn.running_mean.clone(), bn.running_var.clone()
    bn(torch.from_numpy(_normal(rng, 1, 3, 3, 4)))
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_double_conv_training_form(rng, use_kernels):
    """Forward, every gradient leaf and the running statistics. With kernels
    on and the gates lowered: conv1 (12->72) takes the halo kernel with
    statistics, conv2 (72->10) the packed kernel with the prologue, and the
    backward runs two weight-gradient calls and two adjoints."""
    x, g = _normal(rng, 2, 9, 11, 12), _normal(rng, 2, 9, 11, 10)
    fm = jparts.DoubleConv(10, 72)
    params, stats = _init(fm, rng, x)
    ref, ref_grads, ref_stats = _flax_train(fm, params, stats, g, x)
    counts = [f.calls for f in (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)]
    pm = parts.DoubleConv(12, 10, 72, use_kernels=use_kernels, **LOW_GATES)
    xt = torch.from_numpy(x).requires_grad_()
    load_jax_variables(pm, params, stats)
    out = pm(xt, train=True)
    (out * torch.from_numpy(g)).sum().backward()
    used = [f.calls - c for f, c in zip((conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad), counts)]
    # conv2 forward + conv1's adjoint (12 outputs) packed; conv1 forward +
    # conv2's adjoint (72 > 64 boundary) halo
    assert used == ([2, 2, 2] if use_kernels else [0, 0, 0])
    trees = export_flax_trees(pm)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    _assert_trees_close(trees["grads"], ref_grads, GRAD_TOL, "grads")
    _assert_trees_close(trees["batch_stats"], ref_stats, TOL, "batch_stats")


def test_conv3x3_gates():
    conv = parts.Conv3x3(64, 128, use_kernels=True)
    assert conv.kernel_route(304, 484) and conv.kernel_route(152, 242)
    assert not conv.kernel_route(76, 121)                                  # < 30,000 pixels
    assert not parts.Conv3x3(512, 256, use_kernels=True).kernel_route(152, 242)   # > 256
    assert not parts.Conv3x3(3, 64, use_kernels=True).kernel_route(608, 968)      # C < 32
    assert not parts.Conv3x3(64, 64).kernel_route(608, 968)                       # kernels off
    assert parts.Conv3x3(512, 256, use_kernels=True, max_channels=512).kernel_route(152, 242)


def test_unfused_prologue_rounds_like_the_reference(rng):
    """Off the kernel route the conv applies relu(pa*x + pb) in float32 and
    rounds to the compute dtype before the conv (parts.py:381-385)."""
    x = torch.from_numpy(_normal(rng, 1, 5, 6, 4))
    pa, pb = torch.rand(4) + 0.5, torch.randn(4)
    conv = parts.Conv3x3(4, 3, dtype=torch.bfloat16)
    y, st = conv.train_forward(x, collect_stats=True, prologue=(pa, pb))
    z = torch.relu(x.to(torch.bfloat16).float() * pa + pb).to(torch.bfloat16)
    assert st is None and y.dtype == torch.bfloat16
    torch.testing.assert_close(y, conv(z), rtol=0, atol=0)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_down_and_up_training_forms(rng, use_kernels):
    x1, x2 = _normal(rng, 1, 4, 5, 16), _normal(rng, 1, 9, 11, 8)
    g = _normal(rng, 1, 9, 11, 6)
    fm = jparts.Up(16, 6, bilinear=False)
    params, stats = _init(fm, rng, x1, x2)
    ref, ref_grads, ref_stats = _flax_train(fm, params, stats, g, x1, x2)
    out, trees = _port_train(parts.Up(16, 6, use_kernels=use_kernels, **LOW_GATES),
                             params, stats, g, x1, x2)
    np.testing.assert_allclose(out, ref, **TOL)
    _assert_trees_close(trees["grads"], ref_grads, GRAD_TOL, "Up grads")
    _assert_trees_close(trees["batch_stats"], ref_stats, TOL, "Up batch_stats")

    x, g = _normal(rng, 2, 9, 12, 8), _normal(rng, 2, 4, 6, 6)
    fm = jparts.Down(6)
    params, stats = _init(fm, rng, x)
    ref, ref_grads, ref_stats = _flax_train(fm, params, stats, g, x)
    out, trees = _port_train(parts.Down(8, 6, use_kernels=use_kernels, **LOW_GATES),
                             params, stats, g, x)
    np.testing.assert_allclose(out, ref, **TOL)
    _assert_trees_close(trees["grads"], ref_grads, GRAD_TOL, "Down grads")
    _assert_trees_close(trees["batch_stats"], ref_stats, TOL, "Down batch_stats")


def test_folded_model_refuses_to_train(rng):
    with pytest.raises(ValueError, match="does not train"):
        parts.DoubleConv(4, 4, fused_bn=True)(torch.zeros(1, 4, 4, 4), train=True)


def test_export_inverts_load(rng):
    """export_flax_trees gives back the flax layouts load_jax_variables took:
    HWIO kernels and the conv-transpose flip."""
    x1, x2 = _normal(rng, 1, 4, 5, 16), _normal(rng, 1, 8, 10, 8)
    params, stats = _init(jparts.Up(16, 6, bilinear=False), rng, x1, x2)
    trees = export_flax_trees(load_jax_variables(parts.Up(16, 6), params, stats))
    _assert_trees_close(trees["params"], params, dict(atol=0, rtol=0), "params")
    _assert_trees_close(trees["batch_stats"], stats, dict(atol=0, rtol=0), "batch_stats")
    assert trees["grads"] == {} and trees["mu"] == {}
