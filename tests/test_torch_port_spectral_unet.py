"""The SpectralUNET slice: the port's models/spectral_unet.py against the JAX
package's flax SpectralUNET (hyperpri_tpu/models/spectral_unet.py), on the
CPU in float32, from one flax init on numpy-seeded inputs, at hsi_depth 16,
bn_feats 32 and 2x8x12 images:

  - the eval and training forms (logits within rel L2 1e-5, the running
    statistics after a training forward within 1e-6);
  - the parameter count at full width, 30,388,051, and the registry;
  - export_flax_trees carrying Dense leaves back under flax paths and
    layouts, and a checkpoint's state with the Adam moments round-tripping;
  - one training step against the JAX make_train_step run op by op
    (jax.disable_jit; ROADMAP caveat R5): the loss within rel 1e-5, the
    gradients within rel L2 1e-4 (all together, and leaf by leaf above a
    floor), the running statistics within 1e-6;
  - the offloaded step bit-equal to the plain one, and the rematerialized
    step equal to it, running statistics included.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hyperpri_tpu.models.spectral_unet import SpectralUNET as JaxSpectralUNET  # noqa: E402
from hyperpri_tpu.train.trainer import TrainState  # noqa: E402
from hyperpri_tpu.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.models.registry import (  # noqa: E402
    count_params,
    describe_route,
    initialize_model,
)
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET  # noqa: E402
from hyperpri_tpu_torch.ops.fold_bn import fold_batch_norm  # noqa: E402
from hyperpri_tpu_torch.train.step import (  # noqa: E402
    build_spectral_unet_trainer,
    make_optimizer,
    make_train_step,
)
from hyperpri_tpu_torch.weights import (  # noqa: E402
    export_flax_trees,
    export_state,
    load_adam_moments,
    load_jax_variables,
)

DEPTH, FEATS, SHAPE = 16, 32, (2, 8, 12)
PARAMS_SPECTRAL = 30_388_051
LR = 1e-3
LOGIT_REL_L2 = 1e-5
STATS_TOL = dict(atol=1e-6, rtol=0)
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
GRAD_FLOOR = 1e-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=SHAPE + (DEPTH,)).astype(np.float32),
            "mask": (rng.random(SHAPE + (1,)) < 0.4).astype(np.float32),
            "valid": np.ones(SHAPE[0], np.float32)}


@pytest.fixture(scope="module")
def flax_init():
    x = np.random.default_rng(0).normal(size=SHAPE + (DEPTH,)).astype(np.float32)
    jmodel = JaxSpectralUNET(hsi_depth=DEPTH, bn_feats=FEATS)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x), train=False)
    return (jmodel, jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


def _port(params, stats, **kw):
    return load_jax_variables(SpectralUNET(DEPTH, 1, FEATS, **kw), params, stats)


def test_parameter_count_and_registry():
    model = initialize_model("SpectralUNET", 1, {"hsi_lo": 25, "hsi_hi": 263,
                                                 "spectral_bn_size": 1650, "remat": True,
                                                 "offload": True}, seed=0)
    assert isinstance(model, SpectralUNET) and count_params(model) == PARAMS_SPECTRAL
    assert (model.hsi_depth, model.bn_feats, model.remat, model.offload) == (238, 1650, True,
                                                                             True)
    assert describe_route(model, True) == "fp32: Dense layers on torch.matmul (no kernel route)"
    cfg = ExpHyperspectralPRI(calling_path=".", model_name="SpectralUNET", device="cpu",
                              spectral_bn_size=FEATS)
    assert cfg.model_param_str == f"SpectralUNET_{FEATS}"
    assert isinstance(cfg.get_network(), SpectralUNET)
    assert initialize_model("UNET+", 1, {"channels": 3}).up1.use_attention


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(flax_init, train):
    jmodel, params, stats = flax_init
    x = np.random.default_rng(1).normal(size=SHAPE + (DEPTH,)).astype(np.float32)
    model = _port(params, stats)
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
    assert tuple(got.shape) == SHAPE + (1,) and got.dtype == torch.float32
    assert _rel_l2(got.detach().numpy(), np.asarray(ref)) <= LOGIT_REL_L2


def test_folded_model_matches_flax_fused(flax_init):
    """fused_bn=True takes ops/fold_bn.py's state dict (linear -> bn); the
    eval logits are the unfolded model's to float32 round-off."""
    jmodel, params, stats = flax_init
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
                         stats)
    x = np.random.default_rng(4).normal(size=SHAPE + (DEPTH,)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    folded = SpectralUNET(DEPTH, 1, FEATS, fused_bn=True)
    folded.load_state_dict(fold_batch_norm(_port(params, stats).state_dict()))
    with torch.no_grad():
        assert _rel_l2(folded(torch.from_numpy(x)).numpy(), ref) <= LOGIT_REL_L2


def test_forward_rejects_wrong_bands():
    with pytest.raises(ValueError, match=f"{DEPTH} bands"):
        SpectralUNET(DEPTH, 1, FEATS)(torch.zeros((1, 2, 2, DEPTH + 1)))


def test_export_flax_trees_round_trips_dense_leaves(flax_init):
    _, params, stats = flax_init
    trees = export_flax_trees(_port(params, stats))
    for kind, ref in (("params", params), ("batch_stats", stats)):
        got, want = _flat(trees[kind]), _flat(ref)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # (in, out) flax kernels against torch's (out, in) weights
    assert trees["params"]["up2"]["linear"]["kernel"].shape == (2 * FEATS, FEATS)


def test_checkpoint_state_round_trips_adam_moments(flax_init):
    """export_state after a step, loaded into a fresh model and optimizer
    (Trainer.restore_state's path), gives back every parameter, running
    statistic and Adam moment exactly: Dense kernels and their moments go
    out as (in, out) and come back as (out, in)."""
    _, params, stats = flax_init
    model = _port(params, stats)
    opt = make_optimizer(model, "ADAM", LR)
    make_train_step(model, opt, 0.5)({k: torch.from_numpy(v) for k, v in _batch(8).items()})
    state = export_state(model, opt)
    assert tuple(state["mu"]["outc"]["kernel"].shape) == (2 * FEATS, 1)
    twin = load_jax_variables(SpectralUNET(DEPTH, 1, FEATS), state["params"],
                              state["batch_stats"])
    twin_opt = make_optimizer(twin, "ADAM", LR)
    load_adam_moments(twin, twin_opt, state["mu"], state["nu"], int(state["count"]))
    for key, value in model.state_dict().items():
        assert torch.equal(twin.state_dict()[key], value), key
    for p, q in zip(model.parameters(), twin.parameters()):
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][moment], twin_opt.state[q][moment])


@pytest.fixture(scope="module")
def step_pair(flax_init):
    """One step on each side from the same state and batch: the JAX step op
    by op, its gradients taken by an optax transform ahead of Adam."""
    jmodel, params, stats = flax_init
    batch = _batch(2)
    captured = {}

    def capture(updates, state, params=None):
        captured["grads"] = updates
        return updates, state

    tx = optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(), capture),
                     optax.adam(LR))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    with jax.disable_jit():
        state, logs = jax_make_train_step(0.5)(state, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    ref = {"loss": float(logs["loss_sum"] / logs["n"]),
           "grads": _flat(jax.tree.map(np.asarray, captured["grads"])),
           "batch_stats": _flat(jax.tree.map(np.asarray, state.batch_stats)),
           "stats": [int(v) for v in logs["stats"]]}
    model = _port(params, stats)
    opt = make_optimizer(model, "ADAM", LR)
    logs = make_train_step(model, opt, 0.5)({k: torch.from_numpy(v) for k, v in batch.items()})
    trees = export_flax_trees(model, opt)
    got = {"loss": float(logs["loss_sum"] / logs["n"]), "grads": _flat(trees["grads"]),
           "batch_stats": _flat(trees["batch_stats"]),
           "stats": [int(v) for v in logs["stats"]]}
    return ref, got


def test_train_step_matches_jax(step_pair):
    """All gradients together within rel L2 GRAD_REL_L2, and each leaf within
    GRAD_REL_L2 of max(its norm, GRAD_FLOOR of the largest leaf's): the
    biases of the Linears that feed a BatchNorm have a gradient of zero,
    which both sides reach only to float32 round-off."""
    ref, got = step_pair
    assert abs(got["loss"] - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    assert set(got["grads"]) == set(ref["grads"])
    want = np.concatenate([ref["grads"][p].ravel() for p in sorted(ref["grads"])])
    have = np.concatenate([got["grads"][p].ravel() for p in sorted(ref["grads"])])
    assert _rel_l2(have, want) <= GRAD_REL_L2
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in ref["grads"].values())
    for path, g in ref["grads"].items():
        err = np.linalg.norm(got["grads"][path].astype(np.float64) - g)
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(g), floor), path
    for path, want in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][path], want, err_msg=path, **STATS_TOL)
    assert got["stats"] == ref["stats"]


def _trajectory(model, steps=2, **step_kw):
    opt = make_optimizer(model, "ADAM", LR)
    step = make_train_step(model, opt, 0.5, **step_kw)
    losses = [float(step({k: torch.from_numpy(v) for k, v in _batch(5 + i).items()})["loss_sum"])
              for i in range(steps)]
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("variant", ["offload", "remat", "remat+offload"])
def test_offload_and_remat_equal_the_plain_step(flax_init, variant):
    """Offload moves the saved residuals to host memory and back; remat
    recomputes each block in the backward, leaving the running statistics as
    the forward left them. Both give the plain step's bits (with offload the
    blocks are not rematerialized, as in the JAX package)."""
    _, params, stats = flax_init
    plain = _trajectory(_port(params, stats))
    model = _port(params, stats, remat="remat" in variant, offload="offload" in variant)
    got = _trajectory(model, offload="offload" in variant)
    assert got[0] == plain[0]
    for key, value in plain[1].items():
        assert torch.equal(got[1][key], value), key


def test_build_spectral_unet_trainer_takes_the_chunked_step():
    """build_spectral_unet_trainer: -> (model, optimizer, step), the model
    drawn from `seed` as SpectralUNET's constructor draws it, the step
    chunked with n_chunks."""
    model, opt, step = build_spectral_unet_trainer(0, device="cpu", hsi_depth=DEPTH,
                                                   bn_feats=FEATS, n_chunks=2, offload=True)
    assert isinstance(model, SpectralUNET) and model.offload
    twin = SpectralUNET(DEPTH, 1, FEATS, generator=torch.Generator().manual_seed(0))
    for a, b in zip(twin.parameters(), model.parameters()):
        assert torch.equal(a, b)
    logs = step({k: torch.from_numpy(v) for k, v in _batch(7).items()})
    assert float(logs["n"]) == 2 and np.isfinite(float(logs["loss_sum"]))
    assert opt.state   # one Adam step taken
