"""The port's fit loop on its own (train/trainer.py, checkpoint.py, config,
registry), on a tiny synthetic tree on the CPU: a resumed epoch bit-equal to
an uninterrupted one, the host pre-padded ingest bit-equal to logical cubes,
early stopping at patience 0, and the kernel route of a bf16 and of a float32
configuration.

The gates are lowered through CubeNET's constructor so that the kernel route
and the ingest fire on their plain versions at 16x24. A
CubeNET-64 full checkpoint is ~375 MB, so each run directory is removed once
its results are read.
"""

import copy
import shutil

import pytest
import torch

from hyperpri_tpu_torch.config import ExpHyperspectralPRI
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree
from hyperpri_tpu_torch.models.cubenet import CubeNET
from hyperpri_tpu_torch.models.registry import describe_route
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
from hyperpri_tpu_torch.train.trainer import Trainer, train_net

BANDS, HW = 20, (16, 24)
GATES = dict(min_pixels=16, min_channels=8)   # every gated 3x3 conv takes a kernel


def _cfg(tmp_path_factory, tree, name, **kw):
    """A configuration on a fresh calling path whose Datasets/ is the tree's."""
    root = tmp_path_factory.mktemp(name)
    (root / "Datasets").symlink_to(tree / "Datasets")
    return ExpHyperspectralPRI(calling_path=str(root), hsi_lo=0, hsi_hi=BANDS, device="cpu",
                               **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_experiment_tree(str(root), n_boxes=2, dates_per_box=2, size_hw=HW, bands=BANDS,
                         seed=0)
    return root


@pytest.fixture(scope="module")
def init():
    return CubeNET(BANDS, 1, 64, bilinear=False, use_kernels=True,
                   generator=torch.Generator().manual_seed(0), **GATES)


@pytest.fixture(scope="module")
def runs(tree, init, tmp_path_factory):
    """From one init: 2 epochs then a resumed 3rd, 3 epochs uninterrupted,
    2 epochs with the ingest on and 2 with it off."""
    out = {}
    cfg = _cfg(tmp_path_factory, tree, "resume")
    out["first"] = train_net(cfg, max_epochs=2, progress=False,
                             model=copy.deepcopy(init)).fit_result
    out["resumed"] = train_net(cfg, checkpoint=True, max_epochs=3, progress=False,
                               model=copy.deepcopy(init)).fit_result
    shutil.rmtree(cfg.save_path)
    cfg = _cfg(tmp_path_factory, tree, "straight")
    out["straight"] = train_net(cfg, max_epochs=3, progress=False,
                                model=copy.deepcopy(init)).fit_result
    shutil.rmtree(cfg.save_path)
    cfg = _cfg(tmp_path_factory, tree, "no_ingest")
    model = copy.deepcopy(init)
    model.ingest_spec = lambda h, w: None
    before = conv3x3_packed.calls_by_framing.get("pre_padded", 0)
    out["no_ingest"] = train_net(cfg, max_epochs=2, progress=False, model=model).fit_result
    shutil.rmtree(cfg.save_path)
    assert conv3x3_packed.calls_by_framing.get("pre_padded", 0) == before
    return out


def test_resume_equals_uninterrupted(runs):
    """The resumed run restores the model, the BatchNorm statistics and Adam
    from last.ckpt: its third epoch is bit-equal to the uninterrupted one's."""
    resumed, straight = runs["resumed"], runs["straight"]
    assert resumed.epochs_run == 1 and resumed.history[0]["epoch"] == 2
    for key in ("tr_loss", "val_loss", "val_dice"):
        assert resumed.history[0][key] == straight.history[2][key], key


def test_ingest_on_equals_ingest_off(runs):
    """The pre-padded buffer holds the same values at the same places, so the
    plain versions compute the same sums: equal bits."""
    for a, b in zip(runs["first"].history, runs["no_ingest"].history):
        assert a["tr_loss"] == b["tr_loss"] and a["val_loss"] == b["val_loss"]


def test_early_stop_at_patience_zero(tree, tmp_path_factory, capsys):
    """Patience 0 stops after the first epoch; the fit states its route: the
    configuration's default fp32 takes the kernels (3xTF32 products)."""
    cfg = _cfg(tmp_path_factory, tree, "early", overall=0)
    trainer = train_net(cfg, max_epochs=3)
    shutil.rmtree(cfg.save_path)
    assert trainer.fit_result.stopped_early and trainer.fit_result.epochs_run == 1
    assert ("route: fp32: gated 3x3 convs on the CUDA kernels (3xTF32 products)"
            in capsys.readouterr().out)


@pytest.mark.parametrize("precision,pallas_train,route", [
    ("bf16", True, "bf16: gated 3x3 convs on the CUDA kernels"),
    ("fp32", True, "fp32: gated 3x3 convs on the CUDA kernels (3xTF32 products)"),
    ("bf16", False, "bf16: every conv on F.conv2d (pallas_train off)"),
])
def test_route_is_described(tree, precision, pallas_train, route):
    cfg = ExpHyperspectralPRI(calling_path=str(tree), device="cpu", precision=precision,
                              pallas_train=pallas_train)
    assert describe_route(cfg.get_network(), pallas_train).startswith(route)


def test_bf16_config_takes_the_kernel_route(tree, tmp_path_factory):
    """precision 'bf16' builds a kernel-route model whose first conv takes the
    ingest at full resolution; so does 'fp32', in float32."""
    cfg = _cfg(tmp_path_factory, tree, "bf16")
    model = ExpHyperspectralPRI(calling_path=cfg.calling_path, device="cpu",
                                precision="bf16").get_network()
    assert model.first_conv.use_kernels and model.dtype == torch.bfloat16
    assert model.ingest_spec(608, 968) == ((610, 970, 256), (1, 1), (608, 968, 238))
    assert model.ingest_spec(*HW) is None   # below the pixel gate: logical cubes
    fp32 = ExpHyperspectralPRI(calling_path=cfg.calling_path, device="cpu").get_network()
    assert fp32.first_conv.use_kernels and fp32.dtype == torch.float32
    assert fp32.ingest_spec(608, 968) == ((610, 970, 256), (1, 1), (608, 968, 238))
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(ExpHyperspectralPRI(calling_path=cfg.calling_path, device="cpu",
                                    comet_logging=True))
    # SpectralUNET builds (no kernel route); UNET+ builds UNet with the skip*x merge
    spectral = ExpHyperspectralPRI(calling_path=cfg.calling_path, precision="bf16",
                                   model_name="SpectralUNET", spectral_bn_size=16).get_network()
    assert describe_route(spectral, True) == ("bf16: Dense layers on torch.matmul (no kernel "
                                              "route)")
    plus = ExpHyperspectralPRI(calling_path=cfg.calling_path, model_name="UNET+").get_network()
    assert plus.up4.use_attention and describe_route(plus, True).endswith("(use_attention)")
