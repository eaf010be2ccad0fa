"""The slice as a whole: three consecutive training steps of a narrow-input
CubeNET at 2x40x58x40 in float32 on the CPU, the port's train/step.py against
the JAX package's make_train_step, from one flax init on identical batches.

The port runs its three steps freely. Before each, the JAX state (parameters,
BatchNorm statistics, Adam moments and count) is set to the port's, carried
over by weights.export_flax_trees, so every step is compared from one common
state: Adam turns a gradient entry at round-off level into an update of
+-learn_rate whose sign is noise, and two free-running float32 trajectories
of this tiny model drift apart for that reason alone.

The port runs with its gates lowered, so every route fires: packed and halo
forward convs with statistics and prologues, packed and halo adjoints, both
backwards through the BatchNorm-ReLU boundary, eleven weight-gradient calls,
and the pool backward through the kernel wrapper (even maps) and through
tensor ops (the odd 20x29 and 5x7 maps). On CPU tensors the wrappers run their
plain versions. The JAX model takes XLA's convs (its kernel gate needs a TPU)
and runs op by op, not under jit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hyperpri_tpu.models import CubeNET as JaxCubeNET  # noqa: E402
from hyperpri_tpu.train.trainer import TrainState, make_train_step as jax_make_train_step  # noqa: E402
from hyperpri_tpu.train.trainer import masked_bce as jax_masked_bce  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.ops import pool  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd  # noqa: E402
from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

BANDS, SHAPE = 40, (2, 40, 58)
LR, STEPS = 1e-3, 3
# float32 through ~two dozen convs and their backwards, XLA vs oneDNN and the
# plain versions' summation orders.
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
# Gradient leaves span magnitudes; each is held to 3e-2 of its own largest
# entry (plus rtol). This small model amplifies float32 round-off: its deepest
# BatchNorms see 12 values a channel, and single channels with a tiny batch
# variance divide by it. Against a float64 run of the same step, the JAX
# gradients and plain autograd of F.conv2d are each off by up to 1.6e-2 of a
# leaf's largest entry in such channels, the port's kernel route by 4e-3. A
# wrong route, layout or rounding point shows as an error of order 1.
GRAD_REL = 3e-2
# A leaf whose gradient is exactly zero (a conv bias that feeds a BatchNorm)
# holds only the round-off of a sum of ~1e4 terms of magnitude <= 1e-4.
GRAD_ABS = 1e-7
# Adam divides by sqrt(nu): where |g| is at round-off level the update's sign
# is noise, so such entries may differ by up to STEPS * LR; entries whose
# gradient is above GRAD_FLOOR of the leaf's largest (several times GRAD_REL, so
# that its sign and size are not in doubt) take the tight limit.
GRAD_FLOOR = 1e-1
PARAM_TIGHT = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _batches(rng):
    out = []
    for _ in range(2):
        out.append({
            "image": rng.normal(size=SHAPE + (BANDS,)).astype(np.float32),
            "mask": (rng.random(SHAPE + (1,)) < 0.3).astype(np.float32),
            "valid": np.array([1.0, 1.0], np.float32),
        })
    out[1]["valid"] = np.array([1.0, 0.0], np.float32)   # a padded entry
    return [out[0], out[1], out[0]]


@pytest.fixture(scope="module")
def trajectories():
    """Run both sides once; the tests below read the records."""
    rng = np.random.default_rng(0)
    batches = _batches(rng)
    jmodel = JaxCubeNET(BANDS, 1, first_depth=64, bilinear=False)
    variables = jax.jit(lambda k, v: jmodel.init(k, v, train=False))(
        jax.random.key(0), jnp.asarray(batches[0]["image"]))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    tx = optax.adam(LR)
    jstep = jax_make_train_step(0.5)

    def jprobe(params, batch_stats, batch):
        def loss_fn(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                     batch["image"], train=True, mutable=["batch_stats"])
            return jax_masked_bce(logits, batch["mask"], batch["valid"]), logits
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits, grads

    model = CubeNET(BANDS, 1, 64, use_kernels=True, min_pixels=0)
    load_jax_variables(model, params, stats)
    opt = make_optimizer(model, "ADAM", LR)
    step = make_train_step(model, opt, 0.5, return_logits=True)
    wrappers = (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad, max_pool_2x2_bwd)
    ref, got, calls = [], [], []
    min_pixels, pool.KERNEL_MIN_PIXELS = pool.KERNEL_MIN_PIXELS, 0
    try:
        for k, batch in enumerate(batches):
            # the JAX state for this step is the port's state before it
            trees = jax.tree.map(jnp.asarray, export_flax_trees(model, opt))
            adam, rest = tx.init(trees["params"])
            if k > 0:
                adam = adam._replace(count=jnp.asarray(k, jnp.int32), mu=trees["mu"],
                                     nu=trees["nu"])
            state = TrainState(step=jnp.asarray(k, jnp.int32), params=trees["params"],
                               batch_stats=trees["batch_stats"], opt_state=(adam, rest),
                               apply_fn=jmodel.apply, tx=tx)
            jb = {name: jnp.asarray(v) for name, v in batch.items()}
            loss, logits, grads = jprobe(state.params, state.batch_stats, jb)
            state, logs = jstep(state, jb)
            ref.append({
                "loss": float(loss), "logits": np.asarray(logits),
                "grads": _flat(jax.tree.map(np.asarray, grads)),
                "loss_sum": float(logs["loss_sum"]), "n": float(logs["n"]),
                "stats": [int(v) for v in logs["stats"]],
                "params": _flat(jax.tree.map(np.asarray, state.params)),
                "batch_stats": _flat(jax.tree.map(np.asarray, state.batch_stats)),
                "mu": _flat(jax.tree.map(np.asarray, state.opt_state[0].mu)),
                "nu": _flat(jax.tree.map(np.asarray, state.opt_state[0].nu)),
            })

            before = [f.calls for f in wrappers]
            logs = step({name: torch.from_numpy(v) for name, v in batch.items()})
            calls.append([f.calls - b for f, b in zip(wrappers, before)])
            n = float(logs["n"])
            got.append({
                "loss": float(logs["loss_sum"]) / max(n, 1.0), "logits": logs["logits"].numpy(),
                "loss_sum": float(logs["loss_sum"]), "n": n,
                "stats": [int(v) for v in logs["stats"]],
                **{name: _flat(v) for name, v in export_flax_trees(model, opt).items()},
            })
    finally:
        pool.KERNEL_MIN_PIXELS = min_pixels
    return ref, got, calls


def test_every_route_fires(trajectories):
    """With the pixel gate at 0, the 3x3 convs with 32 <= C and max(C, O) <= 256
    take the kernels: first_conv, inc2, down1 and down2 (2 each), up2.conv2,
    up3 and up4 (2 each) = 11 convs, as at full resolution. Forward: 4 with
    O <= 64 packed, 7 halo. Adjoints: first_conv has none; packed for inc2 and
    up4.conv2 (boundary 64, epilogue) and the statistics convs with C <= 128
    (down1.conv1, down2.conv1, up4.conv1); halo for the other five. One
    weight gradient each. Pools: 40x58 and 10x14 are even (kernel wrapper),
    20x29 and 5x7 are odd (tensor ops)."""
    _, _, calls = trajectories
    assert calls == [[9, 12, 11, 2]] * STEPS


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_logits_and_counts_match(trajectories, step):
    ref, got, _ = trajectories
    r, g = ref[step], got[step]
    assert g["logits"].shape == SHAPE + (1,) and g["logits"].dtype == np.float32
    np.testing.assert_allclose(g["logits"], r["logits"], **LOGIT_TOL)
    assert g["loss"] == pytest.approx(r["loss"], rel=1e-5)
    assert g["loss_sum"] == pytest.approx(r["loss_sum"], rel=1e-5)
    assert g["n"] == r["n"] == (1.0 if step == 1 else 2.0)
    flips = int(((g["logits"] > 0) != (r["logits"] > 0)).sum())   # logits at the threshold
    assert sum(abs(a - b) for a, b in zip(g["stats"], r["stats"])) <= 2 * flips
    assert sum(g["stats"]) == int(r["n"]) * SHAPE[1] * SHAPE[2]


@pytest.mark.parametrize("step", range(STEPS))
def test_every_gradient_leaf_matches(trajectories, step):
    ref, got, _ = trajectories
    r, g = ref[step]["grads"], got[step]["grads"]
    assert sorted(g) == sorted(r) and len(r) == 82
    for path, want in r.items():
        assert g[path].shape == want.shape, path
        np.testing.assert_allclose(g[path], want, rtol=GRAD_REL,
                                   atol=max(GRAD_REL * np.abs(want).max(), GRAD_ABS),
                                   err_msg=path)


@pytest.mark.parametrize("step", range(STEPS))
def test_batch_norm_running_stats_match(trajectories, step):
    ref, got, _ = trajectories
    r, g = ref[step]["batch_stats"], got[step]["batch_stats"]
    assert sorted(g) == sorted(r) and len(r) == 36
    for path, want in r.items():
        np.testing.assert_allclose(g[path], want, err_msg=path, **STATS_TOL)
    assert not np.allclose(g["first_bn/mean"], 0.0)   # they moved


@pytest.mark.parametrize("step", range(STEPS))
def test_adam_moments_match(trajectories, step):
    """mu and nu are running means of g and g*g: the gradient limits apply,
    squared for nu."""
    ref, got, _ = trajectories
    for name, power in (("mu", 1), ("nu", 2)):
        r, g = ref[step][name], got[step][name]
        assert sorted(g) == sorted(r)
        for path, want in r.items():
            np.testing.assert_allclose(
                g[path], want, rtol=power * GRAD_REL,
                atol=max(power * GRAD_REL * np.abs(want).max(), GRAD_ABS ** power),
                err_msg=f"{name} {path}")


@pytest.mark.parametrize("step", range(STEPS))
def test_updated_parameters_match(trajectories, step):
    ref, got, _ = trajectories
    r, g = ref[step]["params"], got[step]["params"]
    assert sorted(g) == sorted(r)
    for path, want in r.items():
        grad = ref[step]["grads"][path]
        steady = np.abs(grad) > max(GRAD_FLOOR * np.abs(grad).max(), 100 * GRAD_ABS)
        diff = np.abs(g[path] - want)
        assert diff.max() <= 2.5 * LR, path   # one Adam step moves an entry by about LR
        if steady.any():
            assert diff[steady].max() <= PARAM_TIGHT, (path, diff[steady].max())


def test_loss_falls_on_a_repeated_batch(trajectories):
    _, got, _ = trajectories
    assert got[2]["loss"] < got[0]["loss"]   # steps 0 and 2 share a batch


def test_make_optimizer_variants():
    model = torch.nn.Linear(2, 2)
    sgd = make_optimizer(model, "sgd", 0.1, momentum=0.8, weight_decay=1e-4)
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.defaults["momentum"] == 0.8 and sgd.defaults["weight_decay"] == 1e-4
    adam = make_optimizer(model, "Adam", 1e-3)
    assert adam.defaults["eps"] == 1e-8 and adam.defaults["betas"] == (0.9, 0.999)
    with pytest.raises(ValueError, match="Unknown Optimizer"):
        make_optimizer(model, "lion")
