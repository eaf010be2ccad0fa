"""Segmentation maps and kfold_segmaps: the port's utils/segmaps.py against the
JAX package's (hyperpri_tpu/utils/segmaps.py) on numpy inputs, and the
port's `kfold_segmaps --no-segmaps` against the JAX package's on one synthetic
tree, from the same weights written to both checkpoint formats.

  - to_display_rgb and overlay_mask bit-equal to the JAX package's;
  - the blend: 0.4 * image + 0.6 * overlay, quantised to uint8;
  - eval_color_segmaps writing {name}_seg.png, read back through the PNG
    codec, for valid samples only;
  - test_net's pix_acc, dice, pos_iou and avg_prec within 1e-5 and conf_mat
    within 1e-6 for UNET, SpectralUNET and CubeNET at the published split-1
    thresholds.
"""

import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu import cli as jcli  # noqa: E402
from hyperpri_tpu import train as jtrain  # noqa: E402
from hyperpri_tpu.config import ExpHyperspectralPRI as JaxHSI  # noqa: E402
from hyperpri_tpu.config import ExpRedGreenBluePRI as JaxRGB  # noqa: E402
from hyperpri_tpu.train.checkpoint import save_pytree  # noqa: E402
from hyperpri_tpu.utils import segmaps as jseg  # noqa: E402
from hyperpri_tpu_torch import cli  # noqa: E402
from hyperpri_tpu_torch.data.png import load_png  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402
from hyperpri_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from hyperpri_tpu_torch.utils import segmaps  # noqa: E402

HW = (16, 24)
FEATS = 16
METRIC_TOL = 1e-5
CONF_TOL = 1e-6


def _case(seed, dataset):
    rng = np.random.default_rng(seed)
    bands = 238 if dataset == "HSI" else 3
    img = rng.uniform(-0.2, 1.3, size=HW + (bands,)).astype(np.float32)
    pred = rng.random(HW) < 0.4
    gt = rng.random(HW) < 0.3
    return img, pred, gt


@pytest.mark.parametrize("dataset", ["HSI", "RGB", "hsi"])
def test_display_rgb_and_overlay_bit_equal(dataset):
    img, pred, gt = _case(0, dataset.upper())
    got = segmaps.to_display_rgb(img, dataset)
    want = jseg.to_display_rgb(img, dataset)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = segmaps.overlay_mask(pred, gt), jseg.overlay_mask(pred, gt)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # HSI with fewer bands than the pseudo-RGB indices: clamped to the last band
    few = img[..., :40] if dataset.upper() == "HSI" else img
    assert np.array_equal(segmaps.to_display_rgb(few, dataset), jseg.to_display_rgb(few, dataset))


def test_blend_formula():
    img, pred, gt = _case(1, "RGB")
    overlay = segmaps.overlay_mask(pred, gt)
    got = segmaps.blend(img, overlay)
    want = np.round((0.4 * np.clip(img, 0, 1) + 0.6 * overlay) * 255).astype(np.uint8)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    # where the overlay is zero the image shows at 0.4: a white pixel reads 102
    white = segmaps.blend(np.ones((1, 1, 3)), np.zeros((1, 1, 3)))
    assert white.tolist() == [[[102, 102, 102]]]


def test_eval_color_segmaps_writes_pngs(tmp_path):
    img, _, gt = _case(2, "HSI")
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2,) + HW + (1,)).astype(np.float32)
    masks = np.stack([gt, ~gt])[..., None].astype(np.float32)
    images = np.stack([img, img * 0.5])
    written = segmaps.eval_color_segmaps(images, ["a", "b"], logits, masks, str(tmp_path),
                                         dataset="HSI", threshold=0.45,
                                         valid=np.array([1.0, 0.0]))
    assert written == [os.path.join(str(tmp_path), "a_seg.png")]
    assert not os.path.exists(tmp_path / "b_seg.png")
    pred = 1.0 / (1.0 + np.exp(-logits[0, ..., 0].astype(np.float64))) > 0.45
    want = segmaps.blend(segmaps.to_display_rgb(img, "HSI"), segmaps.overlay_mask(pred, gt))
    assert np.array_equal(load_png(written[0], "RGB"), want)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two calling paths over one synthetic tree (16x24, 299 stored bands),
    with the same flax init of each model written as the JAX package's
    msgpack checkpoint into one and as the port's torch checkpoint into the
    other."""
    jax_root = tmp_path_factory.mktemp("segmaps_jax")
    make_experiment_tree(str(jax_root), n_boxes=2, dates_per_box=2, size_hw=HW, bands=299,
                         seed=0)
    port_root = tmp_path_factory.mktemp("segmaps_port")
    (port_root / "Datasets").symlink_to(jax_root / "Datasets")
    for model, cls in (("UNET", JaxRGB), ("SpectralUNET", JaxHSI), ("CubeNET", JaxHSI)):
        jcfg = cls(calling_path=str(jax_root), model_name=model, spectral_bn_size=FEATS)
        net = jcfg.get_network()
        x = np.zeros((1, 32, 32, jcfg.channels), np.float32)
        variables = jax.jit(lambda k, v: net.init(k, v, train=False))(jax.random.key(3),
                                                                       jnp.asarray(x))
        rng = np.random.default_rng(4)
        tree = {"params": jax.tree.map(np.array, variables["params"]),
                # running statistics away from the identity, so eval reads them
                "batch_stats": jax.tree.map(
                    lambda v: (np.asarray(v) + rng.uniform(0.05, 0.3, v.shape)).astype(
                        np.float32), variables["batch_stats"])}
        name = "Checkpoints/epoch=0-val_loss=0.500-val_dice=0.500.ckpt"
        save_pytree(os.path.join(jcfg.save_path, name), tree)
        port_path = os.path.join(jcfg.save_path.replace(str(jax_root), str(port_root)), name)
        save_checkpoint(port_path, jax.tree.map(torch.from_numpy, tree))
    yield jax_root, port_root
    for root in (jax_root, port_root):
        shutil.rmtree(root / "Saved_Models", ignore_errors=True)


def test_kfold_segmaps_matches_jax(trees, monkeypatch):
    jax_root, port_root = trees
    val = os.path.join(str(jax_root), "Datasets", "HyperPRI", "data_splits", "val1.json")
    flags = ["--num-splits", "1", "--no-segmaps", "--test-json", val, "--spectral-bn-size",
             str(FEATS)]
    ref = []
    test_net = jtrain.test_net
    monkeypatch.setattr(jtrain, "test_net", lambda *a, **k: ref.append(test_net(*a, **k)))
    jcli.kfold_segmaps(["--calling-path", str(jax_root)] + flags)
    got = cli.kfold_segmaps(["--calling-path", str(port_root), "--device", "cpu"] + flags)
    assert list(got) == [(1, m) for m in cli.KFOLD_MODELS] and len(ref) == 3
    for (_, model), mine, want in zip(got, got.values(), ref):
        assert mine["threshold"] == want["threshold"] == cli.REFERENCE_THRESHOLDS[model][0]
        for key in ("pix_acc", "dice", "pos_iou", "avg_prec"):
            assert abs(mine[key] - want[key]) <= METRIC_TOL, (model, key)
        np.testing.assert_allclose(mine["conf_mat"], want["conf_mat"], atol=CONF_TOL, rtol=0,
                                   err_msg=model)
    assert not any(f.endswith("_seg.png") for _, _, files in os.walk(port_root / "Saved_Models")
                   for f in files)
