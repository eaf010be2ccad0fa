"""Port's loss and metrics against the JAX package."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops import metrics as jmetrics  # noqa: E402
from hyperpri_tpu.ops.losses import bce_with_logits as jax_bce  # noqa: E402
from hyperpri_tpu_torch.ops import metrics  # noqa: E402
from hyperpri_tpu_torch.ops.losses import bce_with_logits  # noqa: E402


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_with_logits(rng, reduction):
    x = (rng.normal(size=(2, 5, 7)) * 30).astype(np.float32)  # large |x| too
    z = (rng.random((2, 5, 7)) < 0.4).astype(np.float32)
    ref = np.asarray(jax_bce(jnp.asarray(x), jnp.asarray(z), reduction))
    out = bce_with_logits(torch.from_numpy(x), torch.from_numpy(z), reduction).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_bce_rejects_unknown_reduction():
    with pytest.raises(ValueError):
        bce_with_logits(torch.zeros(2), torch.zeros(2), "median")


@pytest.mark.parametrize("case", ["random", "no_positives", "empty_valid"])
def test_stat_scores_and_rates(rng, case):
    """Counts with the `>` threshold and a validity mask, and the 0/0
    conventions of accuracy, dice (zero_division) and jaccard."""
    probs = rng.random((3, 4, 5)).astype(np.float32)
    probs[0, 0, :2] = 0.5  # exactly at the threshold: negative under `>`
    target = (rng.random((3, 4, 5)) < 0.5).astype(np.float32)
    valid = np.array([1, 0, 1], np.float32).reshape(3, 1, 1) > 0
    if case == "no_positives":
        probs[:] = 0.1
        target[:] = 0.0
    if case == "empty_valid":
        valid[:] = False
    js = jmetrics.StatScores.zeros().update(jnp.asarray(probs), jnp.asarray(target), 0.5,
                                            valid=jnp.asarray(valid))
    ps = metrics.StatScores.zeros().update(torch.from_numpy(probs), torch.from_numpy(target),
                                           0.5, valid=torch.from_numpy(valid))
    assert [int(v) for v in ps] == [int(v) for v in js]
    assert int(sum(ps)) == int(valid.sum()) * 4 * 5
    for jf, pf in [(jmetrics.accuracy_from_stats, metrics.accuracy_from_stats),
                   (jmetrics.jaccard_from_stats, metrics.jaccard_from_stats)]:
        assert float(pf(ps)) == pytest.approx(float(jf(js)), abs=1e-7)
    for zd in (0.0, 1e-12, 1.0):
        assert float(metrics.dice_from_stats(ps, zd)) == pytest.approx(
            float(jmetrics.dice_from_stats(js, zd)), abs=1e-7)

