"""The float32 kernel route: the configuration's default precision.

  - The registry sends a float32 model's gated convs to the CUDA kernels
    (`pallas_train`), as the JAX package's routing gates, which never look
    at the dtype, send float32 tensors to its Pallas kernels; describe_route
    says so.
  - One CubeNET training step in float32, the model built by the HSI
    configuration (registry, flax init carried in), with the gates lowered so
    that every kernel route fires and the first conv reads the host
    pre-padded ingest buffer in float32, against the JAX make_train_step run
    op by op (ROADMAP caveat R5) from the same state on the same batch.
  - The float32 plain versions of the ingest conv (conv3x3_packed
    pre_padded, conv3x3_wgrad pre_padded_c, C = 238 in the 256-channel pitch)
    against the Pallas kernels in interpret mode at float32, and the float32
    pool backward against max_pool_2x2_bwd_pallas in interpret mode, exactly.

On CPU tensors the wrappers run their plain versions, which chip_smoke.py
holds the CUDA kernels against. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hyperpri_tpu.models import CubeNET as JaxCubeNET  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_grad import conv3x3_wgrad as jax_wgrad  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import conv3x3_packed as jax_packed  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import fit_tiles  # noqa: E402
from hyperpri_tpu.ops.pallas.conv_train import _PACKED_LS  # noqa: E402
from hyperpri_tpu.ops.pallas.pool_bwd import max_pool_2x2_bwd_pallas  # noqa: E402
from hyperpri_tpu.train.trainer import TrainState, make_train_step as jax_make_train_step  # noqa: E402
from hyperpri_tpu.train.trainer import masked_bce as jax_masked_bce  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI, ExpRedGreenBluePRI  # noqa: E402
from hyperpri_tpu_torch.data.pipeline import pre_pad_images  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.models.registry import describe_route  # noqa: E402
from hyperpri_tpu_torch.ops import pool  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd  # noqa: E402
from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step  # noqa: E402
from hyperpri_tpu_torch.weights import export_flax_trees, load_jax_variables  # noqa: E402

BANDS, SHAPE, LR = 40, (2, 24, 40), 1e-3
# float32 sums of up to 9*C products in two orders (as test_torch_port_framing).
F32 = dict(atol=2e-5, rtol=1e-5)
SUMS = dict(atol=1e-4, rtol=1e-5)
WGRAD = dict(atol=1e-4, rtol=1e-4)
# The step: the limits of test_torch_port_train_step.py, for the same reasons
# (float32 round-off through ~two dozen convs, BatchNorms over few values).
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL, GRAD_ABS = 3e-2, 1e-7


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.mark.parametrize("cls,gated", [(ExpRedGreenBluePRI, "inc.conv2"),
                                       (ExpHyperspectralPRI, "first_conv")])
def test_float32_models_take_the_kernel_route(cls, gated):
    cfg = cls(device="cpu")
    assert cfg.precision == "fp32" and cfg.pallas_train
    model = cfg.get_network()
    assert model.dtype == torch.float32 and model.get_submodule(gated).use_kernels
    assert model.get_submodule(gated).kernel_route(608, 968)
    assert describe_route(model, cfg.pallas_train).startswith(
        "fp32: gated 3x3 convs on the CUDA kernels (3xTF32 products)")
    off = cls(device="cpu", pallas_train=False)
    assert describe_route(off.get_network(), False) == \
        "fp32: every conv on F.conv2d (pallas_train off)"


@pytest.fixture(scope="module")
def step_records():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=SHAPE + (BANDS,)).astype(np.float32),
             "mask": (rng.random(SHAPE + (1,)) < 0.3).astype(np.float32),
             "valid": np.array([1.0, 1.0], np.float32)}
    jmodel = JaxCubeNET(BANDS, 1, first_depth=64, bilinear=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k, v: jmodel.init(k, v, train=False))(jax.random.key(0),
                                                                     jb["image"])
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jb["image"], train=True,
                                 mutable=["batch_stats"])
        return jax_masked_bce(logits, jb["mask"], jb["valid"]), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tx = optax.adam(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(jparams), apply_fn=jmodel.apply, tx=tx)
    state, _ = jax_make_train_step(0.5)(state, jb)
    ref = {"loss": float(loss), "logits": np.asarray(logits),
           "grads": _flat(jax.tree.map(np.asarray, grads)),
           "batch_stats": _flat(jax.tree.map(np.asarray, state.batch_stats)),
           "mu": _flat(jax.tree.map(np.asarray, state.opt_state[0].mu))}

    model = ExpHyperspectralPRI(hsi_lo=0, hsi_hi=BANDS, device="cpu").get_network()
    for m in model.modules():
        if isinstance(m, parts.Conv3x3):
            m.min_pixels = 0
    load_jax_variables(model, params, stats)
    h, w = SHAPE[1:]
    spec = model.ingest_spec(h, w)
    image = pre_pad_images(torch.from_numpy(batch["image"]), spec)
    opt = make_optimizer(model, "ADAM", LR)
    step = make_train_step(model, opt, 0.5, return_logits=True, ingest_hw=(h, w))
    wrappers = (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad, max_pool_2x2_bwd)
    before = [f.calls for f in wrappers]
    framed = conv3x3_packed.calls_by_framing.get("pre_padded", 0)
    min_pixels, pool.KERNEL_MIN_PIXELS = pool.KERNEL_MIN_PIXELS, 0
    try:
        out = step({"image": image, "mask": torch.from_numpy(batch["mask"]),
                    "valid": torch.from_numpy(batch["valid"])})
    finally:
        pool.KERNEL_MIN_PIXELS = min_pixels
    got = {"loss": float(out["loss_sum"]) / float(out["n"]), "logits": out["logits"].numpy(),
           "calls": [f.calls - b for f, b in zip(wrappers, before)],
           "ingest": conv3x3_packed.calls_by_framing["pre_padded"] - framed,
           "spec": spec, "image_dtype": image.dtype,
           **{k: _flat(v) for k, v in export_flax_trees(model, opt).items()}}
    return ref, got


def test_step_routes(step_records):
    """The float32 model takes the CubeNET counts of test_torch_port_train_step
    (9 packed, 12 halo, 11 weight gradients); pools: 24x40 and 12x20 even,
    6x10 even, 3x5 odd. The first conv reads a float32 ingest buffer."""
    _, got = step_records
    assert got["calls"] == [9, 12, 11, 3]
    assert got["ingest"] == 1 and got["image_dtype"] == torch.float32
    assert got["spec"] == ((26, 42, 64), (1, 1), (24, 40, BANDS))


def test_step_matches_jax(step_records):
    ref, got = step_records
    np.testing.assert_allclose(got["logits"], ref["logits"], **LOGIT_TOL)
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert sorted(got["grads"]) == sorted(ref["grads"]) and len(ref["grads"]) == 82
    for name, power in (("grads", 1), ("mu", 1)):
        for path, want in ref[name].items():
            np.testing.assert_allclose(
                got[name][path], want, rtol=power * GRAD_REL,
                atol=max(power * GRAD_REL * np.abs(want).max(), GRAD_ABS), err_msg=path)
    for path, want in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][path], want, err_msg=path, **STATS_TOL)


def _ingest_buffer(x, o):
    """The JAX package's host pre-padded buffer for x (tests/test_ingest.py)."""
    n, h, w, c = x.shape
    th, tw = fit_tiles(h, w, c, o, jnp.float32, jnp.float32, lane_stride=_PACKED_LS)
    hp, wp, cp = -(-h // th) * th + 2, -(-w // tw) * tw + 8, -(-c // 128) * 128
    buf = np.zeros((n, hp, wp, cp), np.float32)
    buf[:, 1:1 + h, 1:1 + w, :c] = x
    return buf


@pytest.mark.parametrize("n,h,w,c,o", [(2, 9, 20, 238, 64), (1, 13, 21, 61, 64)])
def test_f32_ingest_matches_pallas(n, h, w, c, o):
    """CubeNET's first conv in float32 from the ingest buffer: forward with
    statistics and the weight gradient, against Pallas in interpret mode."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    g = rng.normal(size=(n, h, w, o)).astype(np.float32)
    xp = _ingest_buffer(x, o)
    ref, (s_ref, ss_ref) = jax_packed(
        jnp.asarray(xp), jnp.asarray(wk), jnp.asarray(b), relu=False, with_stats=True,
        lane_stride=64, interpret=True, logical_hw=(h, w), pre_padded=True)
    out, (s, ss) = conv3x3_packed(torch.from_numpy(xp), torch.from_numpy(wk),
                                  torch.from_numpy(b), relu=False, with_stats=True,
                                  logical_hw=(h, w), pre_padded=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, h, w, o)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **SUMS)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_ref), **SUMS)
    dw_ref = jax_wgrad(jnp.asarray(xp), jnp.asarray(g), pre_padded_c=c, interpret=True)
    dw = conv3x3_wgrad(torch.from_numpy(xp), torch.from_numpy(g), pre_padded_c=c)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **WGRAD)


@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 8, 12, 128), (1, 4, 6, 256)])
@pytest.mark.parametrize("kind", ["random", "ties", "neg_inf"])
def test_f32_pool_bwd_matches_pallas_exactly(shape, kind):
    """The widths of the pools that take the kernel on the main paths (64,
    128, 256 channels), in float32, ties and -inf elements included: exact.
    A window of four -inf is left out here: the Pallas kernel routes nothing
    there, while the JAX package's max_pool_2x2 VJP and torch route to the
    first element, as the port does (test below; ROADMAP caveat R6)."""
    rng = np.random.default_rng(len(kind) + shape[-1])
    n, h, w, c = shape
    if kind == "random":
        x = rng.normal(size=shape)
    elif kind == "ties":
        x = rng.integers(0, 3, size=shape).astype(np.float64)
    else:
        x = np.where(rng.random(size=shape) < 0.7, -np.inf, rng.normal(size=shape))
        windows = x.reshape(n, h // 2, 2, w // 2, 2, c)   # a view of x
        empty = np.isneginf(windows).all(axis=(2, 4))
        windows[:, :, 1, :, 1, :][empty] = 0.5   # one finite element a window
    x = x.astype(np.float32)
    g = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    ref = np.asarray(max_pool_2x2_bwd_pallas(jnp.asarray(x), jnp.asarray(g), interpret=True))
    out = max_pool_2x2_bwd(torch.from_numpy(x), torch.from_numpy(g))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_f32_pool_bwd_all_neg_inf_window_follows_the_vjp():
    """Four -inf: the port routes to the first element, as the JAX package's
    max_pool_2x2 custom VJP (hyperpri_tpu/ops/pool.py) does."""
    from hyperpri_tpu.ops.pool import max_pool_2x2 as jax_max_pool_2x2

    x = np.full((1, 4, 4, 8), -np.inf, np.float32)
    x[0, 2:, 2:] = np.arange(32, dtype=np.float32).reshape(2, 2, 8)
    g = np.random.default_rng(3).normal(size=(1, 2, 2, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax_max_pool_2x2, jnp.asarray(x))
    out = max_pool_2x2_bwd(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert out[0, 0, 0].tolist() == g[0, 0, 0].tolist()
