"""The port's curve metrics (hyperpri_tpu_torch/ops/metrics.py: pr_curve,
average_precision, best_threshold_from_pr, patch_pr_tail, confusion_matrix)
against the JAX package's on identical seeded logits, ties included.
Thresholds, precision, recall and AP within 1e-6; the chosen threshold equal.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops import metrics as jm  # noqa: E402
from hyperpri_tpu_torch.ops import metrics as tm  # noqa: E402

TOL = dict(atol=1e-6, rtol=0)


def _case(seed, n=20_000, ties=False, positives=0.3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, size=n).astype(np.float32)
    if ties:
        logits = np.round(logits * 4) / 4   # many equal probabilities
    target = (rng.random(n) < positives).astype(np.float32)
    probs = np.array(jax.nn.sigmoid(jnp.asarray(logits)))
    return probs, target


CASES = [dict(seed=0), dict(seed=1, ties=True), dict(seed=2, positives=0.02),
         dict(seed=3, n=999, ties=True, positives=0.6)]


@pytest.mark.parametrize("case", CASES)
def test_pr_curve_ap_and_threshold_match_jax(case):
    probs, target = _case(**case)
    jp, jr, jt = jm.pr_curve(jnp.asarray(probs), jnp.asarray(target), 500)
    tp, tr, tt = tm.pr_curve(torch.from_numpy(probs), torch.from_numpy(target), 500)
    assert tp.shape == (501,) and tt.shape == (500,)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    japap = float(jm.average_precision(jnp.asarray(probs), jnp.asarray(target)))
    ap = float(tm.average_precision(torch.from_numpy(probs), torch.from_numpy(target)))
    assert ap == pytest.approx(japap, abs=1e-6)
    jbest, jprec, jrec = jm.best_threshold_from_pr(jp, jr, jt)
    best, prec, rec = tm.best_threshold_from_pr(tp, tr, tt)
    assert float(best) == float(jbest)
    assert float(prec) == pytest.approx(float(jprec), abs=1e-6)
    assert float(rec) == pytest.approx(float(jrec), abs=1e-6)
    np.testing.assert_allclose(tm.patch_pr_tail(tp).numpy(), np.asarray(jm.patch_pr_tail(jp)),
                               **TOL)


def test_best_threshold_clamps_past_the_last_threshold():
    """precision/recall have one entry more than thresholds: an argmax on the
    last cropped entry takes the last threshold, as jnp's clamped gather
    does (tests/test_metrics.py pins the JAX side)."""
    precision = np.full(11, 0.1, np.float32)
    recall = np.full(11, 0.1, np.float32)
    precision[-1] = recall[-1] = 1.0
    thresholds = np.linspace(0, 1, 10).astype(np.float32)
    jbest = jm.best_threshold_from_pr(jnp.asarray(precision), jnp.asarray(recall),
                                      jnp.asarray(thresholds), crop_frac=100)[0]
    best = tm.best_threshold_from_pr(torch.from_numpy(precision), torch.from_numpy(recall),
                                     torch.from_numpy(thresholds), crop_frac=100)[0]
    assert float(best) == float(jbest) == 1.0


def test_patch_pr_tail_fills_an_undefined_tail():
    precision = np.array([0.4, 0.5, 0.6, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(tm.patch_pr_tail(torch.from_numpy(precision)).numpy(),
                               np.asarray(jm.patch_pr_tail(jnp.asarray(precision))), **TOL)
    assert float(tm.patch_pr_tail(torch.from_numpy(precision))[-2]) == pytest.approx(0.8)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_confusion_matrix_and_point_metrics_match_jax(normalize, threshold):
    probs, target = _case(5, n=5000)
    p, t = torch.from_numpy(probs), torch.from_numpy(target)
    jp, jt = jnp.asarray(probs), jnp.asarray(target)
    np.testing.assert_allclose(tm.confusion_matrix(p, t, threshold, normalize).numpy(),
                               np.asarray(jm.confusion_matrix(jp, jt, threshold, normalize)),
                               **TOL)
    for name in ("binary_accuracy", "binary_dice", "binary_jaccard"):
        assert float(getattr(tm, name)(p, t, threshold)) == pytest.approx(
            float(getattr(jm, name)(jp, jt, threshold)), abs=1e-6), name
