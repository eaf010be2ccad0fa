"""The port's CubeNET-64 and its serving step against the JAX package, at
1x40x58x238 in float32 on the CPU. The pools floor 40x58 to 20x29, 10x14, 5x7
and 2x3, so every odd center-pad of the decoder runs.

One flax init (with seeded BatchNorm statistics) is shared by the module."""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import CubeNET as JaxCubeNET  # noqa: E402
from hyperpri_tpu.ops.fold_bn import fold_batch_norm as jax_fold_batch_norm  # noqa: E402
from hyperpri_tpu.train.trainer import make_eval_step  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.ops.fold_bn import fold_batch_norm  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.serve import Server  # noqa: E402
from hyperpri_tpu_torch.weights import load_jax_variables  # noqa: E402

SHAPE = (1, 40, 58, 238)
# float32 logits after ~two dozen convs, XLA vs oneDNN summation orders.
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_cubenet():
    rng = np.random.default_rng(0)
    x = rng.normal(size=SHAPE).astype(np.float32)
    model = JaxCubeNET(238, 1, first_depth=64, bilinear=False)
    variables = jax.jit(lambda k, v: model.init(k, v, train=False))(
        jax.random.key(0), jnp.asarray(x))
    variables = jax.tree.map(np.asarray, variables)
    params = variables["params"]
    stats = jax.tree.map(
        lambda a: (np.abs(rng.normal(0.5, 0.3, a.shape)) + 0.1).astype(np.float32),
        variables["batch_stats"])
    folded = jax.tree.map(np.asarray, jax_fold_batch_norm(params, stats))
    served = JaxCubeNET(238, 1, first_depth=64, bilinear=False, fused_bn=True,
                        use_pallas=True)
    return types.SimpleNamespace(
        x=x, model=model, params=params, stats=stats, folded=folded,
        logits=np.asarray(model.apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x), train=False)),
        folded_logits=np.asarray(served.apply({"params": folded, "batch_stats": {}},
                                              jnp.asarray(x), train=False)),
    )


def test_param_count():
    assert sum(p.numel() for p in CubeNET().parameters()) == 31_178_881


def test_unfolded_eval_matches_jax(jax_cubenet):
    model = load_jax_variables(CubeNET(), jax_cubenet.params, jax_cubenet.stats).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(jax_cubenet.x)).numpy()
    assert out.shape == (1, 40, 58, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, jax_cubenet.logits, atol=ATOL, rtol=RTOL)


def test_folded_kernel_route_matches_jax(jax_cubenet, monkeypatch):
    """Folded model with kernels on, the pixel gate lowered so that the four
    O=64 layers with C >= 33 (first_conv, inc2_conv, up4's two convs) take the
    conv3x3_packed route, against JAX CubeNET(fused_bn, use_pallas) on the
    same folded tree."""
    monkeypatch.setattr(parts, "SERVING_MIN_PIXELS", 0)
    model = load_jax_variables(CubeNET(fused_bn=True, use_kernels=True),
                               jax_cubenet.folded).eval()
    calls = conv3x3_packed.calls
    with torch.no_grad():
        out = model(torch.from_numpy(jax_cubenet.x)).numpy()
    assert conv3x3_packed.calls - calls == 4
    np.testing.assert_allclose(out, jax_cubenet.folded_logits, atol=ATOL, rtol=RTOL)


def test_fold_batch_norm_matches_jax(jax_cubenet):
    """The port folds the unfolded state dict; the JAX package folds the flax
    tree. Same float32 arithmetic; allow a few ulps for op order."""
    unfolded = load_jax_variables(CubeNET(), jax_cubenet.params, jax_cubenet.stats)
    folded = fold_batch_norm(unfolded.state_dict())
    expected = load_jax_variables(CubeNET(fused_bn=True), jax_cubenet.folded).state_dict()
    assert sorted(folded) == sorted(expected)
    for key in expected:
        torch.testing.assert_close(folded[key], expected[key], rtol=1e-6, atol=1e-7)


def test_serve_matches_eval_step(jax_cubenet):
    """loss_sum, n and the confusion counts of Server.serve against the
    JAX make_eval_step on the same variables and batch. The second entry is
    padding (valid 0) and must not count."""
    rng = np.random.default_rng(1)
    image = rng.normal(size=(2, 16, 24, 238)).astype(np.float32)
    mask = (rng.random((2, 16, 24, 1)) < 0.3).astype(np.float32)
    valid = np.array([1.0, 0.0], np.float32)
    state = types.SimpleNamespace(apply_fn=jax_cubenet.model.apply,
                                  params=jax_cubenet.params, batch_stats=jax_cubenet.stats)
    ref = make_eval_step(0.5)(state, {"image": jnp.asarray(image), "mask": jnp.asarray(mask),
                                      "valid": jnp.asarray(valid)})
    model = load_jax_variables(CubeNET(), jax_cubenet.params, jax_cubenet.stats)
    out = Server(model).serve({"image": torch.from_numpy(image),
                                      "mask": torch.from_numpy(mask),
                                      "valid": torch.from_numpy(valid)})
    assert out["logits"].shape == (2, 16, 24, 1)
    assert float(out["n"]) == float(ref["n"]) == 1.0
    assert float(out["loss_sum"]) == pytest.approx(float(ref["loss_sum"]), rel=1e-5)
    assert [int(v) for v in out["stats"]] == [int(v) for v in ref["stats"]]
    assert int(sum(out["stats"])) == 16 * 24
