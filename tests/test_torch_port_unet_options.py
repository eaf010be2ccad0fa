"""UNET's and CubeNET's options against the JAX package's flax modules, on
the CPU in float32, from seeded weights and numpy-seeded inputs at 16x24:

  - UNET+ (use_attention: each Up merges by skip * x), bilinear on and off:
    the eval forward, and the training forward's logits and updated
    BatchNorm running statistics, at the full widths (at 32x48: see
    HW_TRAIN);
  - the attention Up alone, at narrow widths with the kernel route's gates
    lowered (the plain versions of the kernels run), bilinear on and off:
    the training forward and jax.grad op by op (not jitted: ROADMAP caveat
    R5) of every parameter and both inputs;
  - CubeNET with use_attention, and `analyze`'s (logits, logits, sigmoid)
    for both models;
  - the folded UNET (fused_bn) on its kernel route (the serving pixel gate
    lowered, so conv3x3_packed's plain version runs) against flax
    UNet(fused_bn=True) on ops/fold_bn.py trees, and the port's fold of the
    unfolded state dict against that tree.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import CubeNET as JaxCubeNET  # noqa: E402
from hyperpri_tpu.models.parts import Up as JaxUp  # noqa: E402
from hyperpri_tpu.models.unet import UNet as JaxUNet  # noqa: E402
from hyperpri_tpu.ops.fold_bn import fold_batch_norm as jax_fold_batch_norm  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.models.parts import Up  # noqa: E402
from hyperpri_tpu_torch.models.unet import UNet  # noqa: E402
from hyperpri_tpu_torch.ops.fold_bn import fold_batch_norm  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

HW = (16, 24)
# The whole-model training forward at 16x24 normalizes two values a channel
# at the bottom, where var = E[x^2] - mean^2 keeps few digits (4.4e-4 apart
# without attention); at 32x48 the plain UNET agrees to 2e-5, UNET+ to 1e-4.
HW_TRAIN = (32, 48)
BANDS = 8
# float32 through up to two dozen convs, XLA against oneDNN summation orders.
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
# The Up module's gradients: one DoubleConv with two training BatchNorms.
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _seeded(make, seed):
    """A port model with seeded normal weights (deviation 1/sqrt(fan-in)),
    BatchNorm affines and running statistics, built without its full-width
    initializers (they take seconds on the CPU)."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif t.dim() > 1:
                t.copy_(torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1
                        + (1.0 if name.endswith(".weight") else 0.0))
    return model


def _inputs(seed, channels, n=2, hw=HW):
    return np.random.default_rng(seed).normal(size=(n,) + hw + (channels,)).astype(np.float32)


def _jax_forwards(jmodel, trees, x):
    """(eval logits, training logits, updated batch_stats) of the flax model."""
    def run(variables, a):
        logits, updates = jmodel.apply(variables, a, train=True, mutable=["batch_stats"])
        return jmodel.apply(variables, a, train=False), logits, updates["batch_stats"]

    out = jax.jit(run)({"params": trees["params"], "batch_stats": trees["batch_stats"]},
                       jnp.asarray(x))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_plus_forwards_match_flax(bilinear):
    model = _seeded(lambda: UNet(3, 1, bilinear=bilinear, use_attention=True), 0)
    x = _inputs(1, 3, hw=HW_TRAIN)
    want_eval, want_train, want_stats = _jax_forwards(
        JaxUNet(3, 1, bilinear=bilinear, use_attention=True), export_flax_trees(model), x)
    with torch.no_grad():
        got_eval = model(torch.from_numpy(x)).numpy()
        got_train = model(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got_eval, want_eval, **LOGIT_TOL)
    np.testing.assert_allclose(got_train, want_train, **LOGIT_TOL)
    got_stats = _flat(export_flax_trees(model)["batch_stats"])
    for path, want in _flat(want_stats).items():
        np.testing.assert_allclose(got_stats[path], want, err_msg=path, **STATS_TOL)


@pytest.mark.parametrize("bilinear", [False, True])
def test_attention_up_gradients_match_jax(bilinear):
    """Up(64 -> 32) with skip * x at 2x16x24 on the kernel route's plain
    versions (gates lowered): the DoubleConv then reads 32 channels, half the
    concat's 64."""
    c_in, c_out = 64, 32
    up = _seeded(lambda: Up(c_in, c_out, bilinear, use_kernels=True, use_attention=True,
                            min_pixels=0), 2)
    assert up.conv.conv1.weight.shape[1] == c_in // 2
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(2, HW[0] // 2, HW[1] // 2, c_in // 2 if bilinear else c_in)).astype(
        np.float32)
    x2 = rng.normal(size=(2,) + HW + (c_in // 2,)).astype(np.float32)
    out_c = c_out // 2 if bilinear else c_out
    cot = rng.normal(size=(2,) + HW + (out_c,)).astype(np.float32)
    trees = export_flax_trees(up)
    jup = JaxUp(c_in, c_out, bilinear, use_attention=True)

    def loss(params, a, b):
        y, _ = jup.apply({"params": params, "batch_stats": trees["batch_stats"]}, a, b,
                         train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), y

    want, want_y = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        trees["params"], jnp.asarray(x1), jnp.asarray(x2))
    t1 = torch.from_numpy(x1).requires_grad_()
    t2 = torch.from_numpy(x2).requires_grad_()
    calls = [f.calls for f in (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)]
    y = up(t1, t2, train=True)
    (y * torch.from_numpy(cot)).sum().backward()
    # packed: both forwards, conv2's adjoint epilogue and conv1's adjoint (the
    # merge needs dx); two weight gradients
    assert [f.calls - c for f, c in zip((conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad),
                                        calls)] == [4, 0, 2]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **LOGIT_TOL)
    got = _flat(export_flax_trees(up)["grads"])
    for path, g in _flat(jax.tree.map(np.asarray, want[0])).items():
        np.testing.assert_allclose(got[path], g, err_msg=path,
                                   atol=GRAD_TOL["atol"] * max(1.0, np.abs(g).max()),
                                   rtol=GRAD_TOL["rtol"])
    for t, g in ((t1, want[1]), (t2, want[2])):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * max(1.0, np.abs(g).max()))


def test_cubenet_attention_and_analyze_match_flax():
    model = _seeded(lambda: CubeNET(BANDS, 1, 64, use_attention=True, analyze=True), 4)
    x = _inputs(5, BANDS, n=1)
    trees = export_flax_trees(model)
    jmodel = JaxCubeNET(BANDS, 1, first_depth=64, bilinear=False, use_attention=True,
                        analyze=True)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        {"params": trees["params"], "batch_stats": trees["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == 3 and got[0] is got[1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    assert torch.equal(got[2], torch.sigmoid(got[0]))


def test_unet_analyze_returns_the_triple():
    model = _seeded(lambda: UNet(3, 1, bilinear=False, analyze=True), 6)
    plain = load_jax_variables(_seeded(lambda: UNet(3, 1, bilinear=False), 7),
                               *(lambda t: (t["params"], t["batch_stats"]))(
                                   export_flax_trees(model)))
    x = torch.from_numpy(_inputs(7, 3, n=1))
    with torch.no_grad():
        logits, again, probs = model(x)
        assert torch.equal(logits, plain(x)) and again is logits
        assert torch.equal(probs, torch.sigmoid(logits))


@pytest.mark.parametrize("bilinear, launches", [(False, 3), (True, 4)])
def test_folded_unet_matches_flax_on_fold_bn_trees(monkeypatch, bilinear, launches):
    """Serving pixel gate lowered: the O <= 64 layers with C >= 33 (inc.conv2,
    up4.conv1, up4.conv2, and with bilinear up3.conv2) take conv3x3_packed."""
    unfolded = _seeded(lambda: UNet(3, 1, bilinear=bilinear), 8)
    trees = export_flax_trees(unfolded)
    folded_tree = jax.tree.map(np.asarray, jax_fold_batch_norm(trees["params"],
                                                               trees["batch_stats"]))
    model = load_jax_variables(_seeded(lambda: UNet(3, 1, bilinear=bilinear, fused_bn=True,
                                                    use_kernels=True), 9), folded_tree)
    mine = fold_batch_norm(unfolded.state_dict())
    for key, value in model.state_dict().items():
        torch.testing.assert_close(mine[key], value, rtol=1e-6, atol=1e-7)
    x = _inputs(10, 3, n=1)
    jmodel = JaxUNet(3, 1, bilinear=bilinear, fused_bn=True, use_pallas=True)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        {"params": folded_tree, "batch_stats": {}}, jnp.asarray(x))
    monkeypatch.setattr(parts, "SERVING_MIN_PIXELS", 0)
    calls = conv3x3_packed.calls
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert conv3x3_packed.calls - calls == launches
    np.testing.assert_allclose(got, np.asarray(want), **LOGIT_TOL)
