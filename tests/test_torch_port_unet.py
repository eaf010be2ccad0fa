"""The UNET slice: the port's models/unet.py against the JAX package's flax
UNet (hyperpri_tpu/models/unet.py), at the default configuration's widths
(n_channels=3, bilinear=False, n_classes=1: 64 ... 1024 channels, which the
architecture fixes) and a small map, in float32 on the CPU, from one flax init
on numpy-seeded inputs.

  - the parameter count, 31,043,521, and the flax tree carried into the port
    with every leaf used and every entry filled;
  - the eval form and the training form (logits and the updated BatchNorm
    running statistics) at 1x32x48x3;
  - one training step at 2x32x48x3 against the JAX make_train_step run op by
    op (not under jit; ROADMAP caveat R5): loss, logits, every gradient, the
    running statistics, the Adam moments and the updated parameters. The
    port's gates are lowered so that the ten 3x3 convs that take the kernels
    at 608x968 (32 <= C, max(C, O) <= 256) and the even pools take the kernel
    route here too, on the kernels' plain versions (CPU tensors). The JAX
    model runs XLA's convs (its kernel gate needs a TPU).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hyperpri_tpu.models.unet import UNet as JaxUNet  # noqa: E402
from hyperpri_tpu.train.trainer import TrainState, make_train_step as jax_make_train_step  # noqa: E402
from hyperpri_tpu.train.trainer import masked_bce as jax_masked_bce  # noqa: E402
from hyperpri_tpu_torch.models.registry import count_params, initialize_model  # noqa: E402
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET  # noqa: E402
from hyperpri_tpu_torch.models.unet import UNet  # noqa: E402
from hyperpri_tpu_torch.ops import pool  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd  # noqa: E402
from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

PARAMS_UNET = 31_043_521
SHAPE = (32, 48)
LR = 1e-3
# float32 through 23 convs and their backwards, XLA against oneDNN and the plain
# versions' summation orders; the deepest maps are 2x3.
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
# Each gradient leaf within 3e-2 of its own largest entry (plus rtol), as in
# test_torch_port_train_step.py: BatchNorms over 12 values a channel at the
# bottom divide float32 round-off by small batch variances. A wrong route,
# layout or rounding point shows as an error of order 1.
GRAD_REL = 3e-2
GRAD_ABS = 1e-7
# Adam's first step moves an entry by about LR whatever its gradient's size;
# entries whose gradient is above GRAD_FLOOR of the leaf's largest take the
# tight limit.
GRAD_FLOOR = 1e-1
PARAM_TIGHT = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def flax_init():
    x = np.random.default_rng(0).normal(size=(1,) + SHAPE + (3,)).astype(np.float32)
    jmodel = JaxUNet(3, 1, bilinear=False)
    variables = jax.jit(lambda k, v: jmodel.init(k, v, train=False))(jax.random.key(0),
                                                                     jnp.asarray(x))
    return (jmodel, jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


def test_parameter_count_and_registry(flax_init):
    _, params, stats = flax_init
    assert sum(v.size for v in _flat(params).values()) == PARAMS_UNET
    model = initialize_model("UNET", 1, {"channels": 3, "bilinear": False,
                                         "pallas_train": True}, seed=0)
    assert isinstance(model, UNet) and count_params(model) == PARAMS_UNET
    assert model.inc.conv2.use_kernels and model.dtype == torch.float32
    load_jax_variables(model, params, stats)   # every leaf used, every entry filled
    net_params = {"channels": 3, "hsi_lo": 25, "hsi_hi": 263, "spectral_bn_size": 16}
    plus = initialize_model("UNET+", 1, net_params)   # UNET with the skip*x merge
    assert isinstance(plus, UNet) and all(getattr(plus, f"up{k}").use_attention
                                          for k in range(1, 5))
    assert isinstance(initialize_model("SpectralUNET", 1, net_params), SpectralUNET)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(flax_init, train):
    jmodel, params, stats = flax_init
    x = np.random.default_rng(1).normal(size=(1,) + SHAPE + (3,)).astype(np.float32)
    model = load_jax_variables(UNet(3, 1, bilinear=False), params, stats)
    got = model(torch.from_numpy(x), train=train)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        got_stats = _flat(export_flax_trees(model)["batch_stats"])
        for path, want in _flat(jax.tree.map(np.asarray, updates["batch_stats"])).items():
            np.testing.assert_allclose(got_stats[path], want, err_msg=path, **STATS_TOL)
    else:
        ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    assert tuple(got.shape) == (1,) + SHAPE + (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **LOGIT_TOL)


def test_forward_rejects_wrong_input(flax_init):
    model = UNet(3, 1, bilinear=False)
    with pytest.raises(ValueError, match="3 input channels"):
        model(torch.zeros((1, 8, 8, 4)))
    with pytest.raises(ValueError, match="CubeNET's"):
        model(torch.zeros((1, 8, 8, 3)), train=True, ingest_hw=(8, 8))
    with pytest.raises(ValueError, match="serves"):
        UNet(3, 1, fused_bn=True)(torch.zeros((1, 8, 8, 3)), train=True)


@pytest.fixture(scope="module")
def step_records(flax_init):
    """One step on each side from the same state and batch."""
    jmodel, params, stats = flax_init
    rng = np.random.default_rng(2)
    batch = {"image": rng.normal(size=(2,) + SHAPE + (3,)).astype(np.float32),
             "mask": (rng.random((2,) + SHAPE + (1,)) < 0.3).astype(np.float32),
             "valid": np.array([1.0, 1.0], np.float32)}

    tx = optax.adam(LR)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jb["image"], train=True,
                                 mutable=["batch_stats"])
        return jax_masked_bce(logits, jb["mask"], jb["valid"]), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(jparams), apply_fn=jmodel.apply, tx=tx)
    state, logs = jax_make_train_step(0.5)(state, jb)
    ref = {"loss": float(loss), "logits": np.asarray(logits),
           "grads": _flat(jax.tree.map(np.asarray, grads)),
           "stats": [int(v) for v in logs["stats"]],
           "params": _flat(jax.tree.map(np.asarray, state.params)),
           "batch_stats": _flat(jax.tree.map(np.asarray, state.batch_stats)),
           "mu": _flat(jax.tree.map(np.asarray, state.opt_state[0].mu)),
           "nu": _flat(jax.tree.map(np.asarray, state.opt_state[0].nu))}

    model = UNet(3, 1, bilinear=False, use_kernels=True, min_pixels=0)
    load_jax_variables(model, params, stats)
    opt = make_optimizer(model, "ADAM", LR)
    step = make_train_step(model, opt, 0.5, return_logits=True)
    wrappers = (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad, max_pool_2x2_bwd)
    before = [f.calls for f in wrappers]
    min_pixels, pool.KERNEL_MIN_PIXELS = pool.KERNEL_MIN_PIXELS, 0
    try:
        out = step({k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        pool.KERNEL_MIN_PIXELS = min_pixels
    got = {"loss": float(out["loss_sum"]) / float(out["n"]), "logits": out["logits"].numpy(),
           "stats": [int(v) for v in out["stats"]],
           "calls": [f.calls - b for f, b in zip(wrappers, before)],
           **{k: _flat(v) for k, v in export_flax_trees(model, opt).items()}}
    return ref, got


def test_every_route_fires(step_records):
    """Forward: inc.conv2, up4.conv1 and up4.conv2 packed (O = 64), down1,
    down2, up2.conv2 and up3 halo (7). Adjoints: packed for the statistics
    convs with C <= 128 (down1.conv1, down2.conv1, up4.conv1) and the two
    64-channel BatchNorm-ReLU boundaries (inc.conv2, up4.conv2, epilogue); halo
    for up3.conv1 (C = 256) and the four wider boundaries. Ten weight
    gradients. The four even pools (32x48 ... 4x6) through the kernel wrapper."""
    _, got = step_records
    assert got["calls"] == [8, 12, 10, 4]


def test_loss_and_logits_match(step_records):
    ref, got = step_records
    np.testing.assert_allclose(got["logits"], ref["logits"], **LOGIT_TOL)
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    flips = int(((got["logits"] > 0) != (ref["logits"] > 0)).sum())
    assert sum(abs(a - b) for a, b in zip(got["stats"], ref["stats"])) <= 2 * flips


def test_every_gradient_leaf_matches(step_records):
    ref, got = step_records
    r, g = ref["grads"], got["grads"]
    assert sorted(g) == sorted(r) and len(r) == 82
    for path, want in r.items():
        assert g[path].shape == want.shape, path
        np.testing.assert_allclose(g[path], want, rtol=GRAD_REL,
                                   atol=max(GRAD_REL * np.abs(want).max(), GRAD_ABS),
                                   err_msg=path)


def test_batch_norm_running_stats_match(step_records):
    ref, got = step_records
    r, g = ref["batch_stats"], got["batch_stats"]
    assert sorted(g) == sorted(r) and len(r) == 36
    for path, want in r.items():
        np.testing.assert_allclose(g[path], want, err_msg=path, **STATS_TOL)


def test_adam_moments_and_parameters_match(step_records):
    """mu and nu are g and g*g scaled: the gradient limits apply, squared for
    nu. The updated parameters: within 2.5 LR everywhere, PARAM_TIGHT where
    the gradient's sign is not in doubt."""
    ref, got = step_records
    for name, power in (("mu", 1), ("nu", 2)):
        for path, want in ref[name].items():
            np.testing.assert_allclose(
                got[name][path], want, rtol=power * GRAD_REL,
                atol=max(power * GRAD_REL * np.abs(want).max(), GRAD_ABS ** power),
                err_msg=f"{name} {path}")
    for path, want in ref["params"].items():
        grad = ref["grads"][path]
        steady = np.abs(grad) > max(GRAD_FLOOR * np.abs(grad).max(), 100 * GRAD_ABS)
        diff = np.abs(got["params"][path] - want)
        assert diff.max() <= 2.5 * LR, path
        if steady.any():
            assert diff[steady].max() <= PARAM_TIGHT, (path, diff[steady].max())
