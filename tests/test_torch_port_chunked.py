"""SpectralUNET's chunked paths against the JAX package's, on the CPU in
float32 at hsi_depth 16, bn_feats 32, 2x8x12 images from numpy seeds:

  - train/chunked.py make_chunked_train_step: n_chunks=1 is the port's
    unchunked step to round-off; n_chunks=N (one image a chunk, the
    reference's per-image BatchNorm semantics) and 2N held against JAX's
    make_chunked_train_step run op by op (jax.disable_jit; ROADMAP caveat
    R5): the loss within rel 1e-5, the accumulated gradients within rel L2
    1e-4, the running statistics within 1e-6, the confusion counts equal; a
    chunk count that does not divide N*H*W raises (caveat R2), and the
    Trainer refuses chunks and offload for a spatial model;
  - ops/chunked.py apply_pixelwise_chunked against JAX's and against the
    port's unchunked eval, with a chunk that does not divide the pixels.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hyperpri_tpu.models.spectral_unet import SpectralUNET as JaxSpectralUNET  # noqa: E402
from hyperpri_tpu.ops.chunked import apply_pixelwise_chunked as jax_chunked  # noqa: E402
from hyperpri_tpu.train.chunked import make_chunked_train_step as jax_chunked_step  # noqa: E402
from hyperpri_tpu.train.trainer import TrainState  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET  # noqa: E402
from hyperpri_tpu_torch.ops.chunked import apply_pixelwise_chunked  # noqa: E402
from hyperpri_tpu_torch.train.chunked import make_chunked_train_step  # noqa: E402
from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step  # noqa: E402
from hyperpri_tpu_torch.train.trainer import Trainer  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

DEPTH, FEATS, SHAPE = 16, 32, (2, 8, 12)
LR = 1e-3
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
GRAD_FLOOR = 1e-2   # as in test_torch_port_spectral_unet.py
STATS_TOL = dict(atol=1e-6, rtol=0)
# The same rows through GEMMs of another height: float32 round-off.
EVAL_REL_L2 = 1e-6


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=SHAPE + (DEPTH,)).astype(np.float32),
             "mask": (rng.random(SHAPE + (1,)) < 0.4).astype(np.float32),
             "valid": np.ones(SHAPE[0], np.float32)}
    jmodel = JaxSpectralUNET(hsi_depth=DEPTH, bn_feats=FEATS)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(batch["image"][:1]), train=False)
    return (jmodel, jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]), batch)


def _port(params, stats):
    return load_jax_variables(SpectralUNET(DEPTH, 1, FEATS), params, stats)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(setup, n_chunks):
    _, params, stats, batch = setup
    model = _port(params, stats)
    opt = make_optimizer(model, "ADAM", LR)
    if n_chunks:
        step = make_chunked_train_step(model, opt, 0.5, n_chunks)
    else:
        step = make_train_step(model, opt, 0.5)
    logs = step(_torch_batch(batch))
    trees = export_flax_trees(model, opt)
    return {"loss": float(logs["loss_sum"] / logs["n"]), "n": float(logs["n"]),
            "grads": _flat(trees["grads"]), "batch_stats": _flat(trees["batch_stats"]),
            "params": _flat(trees["params"]), "stats": [int(v) for v in logs["stats"]]}


def test_one_chunk_is_the_unchunked_step(setup):
    plain, chunked = _port_step(setup, 0), _port_step(setup, 1)
    assert chunked["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    assert chunked["stats"] == plain["stats"] and chunked["n"] == plain["n"]
    for kind in ("grads", "batch_stats", "params"):
        for path, want in plain[kind].items():
            np.testing.assert_allclose(chunked[kind][path], want, atol=2e-6, rtol=0,
                                       err_msg=f"{kind} {path}")


@pytest.mark.parametrize("per_image", [1, 2])
def test_chunked_step_matches_jax(setup, per_image):
    """n_chunks = N * per_image: chunks of one image, then of half an image."""
    jmodel, params, stats, batch = setup
    n_chunks = SHAPE[0] * per_image
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
        state, logs = jax_chunked_step(0.5, n_chunks)(state, {k: jnp.asarray(v)
                                                              for k, v in batch.items()})
    ref_grads = _flat(jax.tree.map(np.asarray, captured["grads"]))
    got = _port_step(setup, n_chunks)
    ref_loss = float(logs["loss_sum"] / logs["n"])
    assert abs(got["loss"] - ref_loss) <= LOSS_REL * abs(ref_loss)
    assert got["stats"] == [int(v) for v in logs["stats"]]
    paths = sorted(ref_grads)
    assert sorted(got["grads"]) == paths
    assert _rel_l2(np.concatenate([got["grads"][p].ravel() for p in paths]),
                   np.concatenate([ref_grads[p].ravel() for p in paths])) <= GRAD_REL_L2
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in ref_grads.values())
    for path, g in ref_grads.items():
        err = np.linalg.norm(got["grads"][path].astype(np.float64) - g)
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(g), floor), path
    for path, want in _flat(jax.tree.map(np.asarray, state.batch_stats)).items():
        np.testing.assert_allclose(got["batch_stats"][path], want, err_msg=path, **STATS_TOL)


def test_chunk_count_must_divide_the_pixels(setup):
    _, params, stats, batch = setup
    model = _port(params, stats)
    step = make_chunked_train_step(model, make_optimizer(model), 0.5, 5)
    with pytest.raises(ValueError, match="do not divide"):
        step(_torch_batch(batch))
    with pytest.raises(ValueError, match="positive"):
        make_chunked_train_step(model, make_optimizer(model), 0.5, 0)


@pytest.mark.parametrize("option", [{"grad_accum_chunks": 2}, {"offload": True}])
def test_trainer_refuses_a_spatial_model(tmp_path, option):
    cfg = ExpHyperspectralPRI(calling_path=str(tmp_path), hsi_lo=0, hsi_hi=DEPTH,
                              device="cpu", cube_featmaps=8, **option)
    with pytest.raises(ValueError, match="SpectralUNET"):
        Trainer(cfg)


def test_chunked_eval_matches_jax_and_the_unchunked_eval(setup):
    """A chunk of 50 pixels: 192 pixels make three whole chunks and one of 42
    (JAX zero-pads it to 50)."""
    jmodel, params, stats, _ = setup
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
                         stats)
    x = rng.normal(size=SHAPE + (DEPTH,)).astype(np.float32)
    ref = np.asarray(jax_chunked(jmodel, {"params": params, "batch_stats": stats},
                                 jnp.asarray(x), chunk=50))
    model = _port(params, stats)
    got = apply_pixelwise_chunked(model, torch.from_numpy(x), chunk=50)
    assert tuple(got.shape) == SHAPE + (1,) and not got.requires_grad
    assert _rel_l2(got.numpy(), ref) <= EVAL_REL_L2
    with torch.no_grad():
        assert _rel_l2(got.numpy(), model(torch.from_numpy(x)).numpy()) <= EVAL_REL_L2
    with pytest.raises(ValueError, match="positive"):
        apply_pixelwise_chunked(model, torch.from_numpy(x), chunk=0)
