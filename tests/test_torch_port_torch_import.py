"""Checkpoint import from the reference's formats (hyperpri_tpu_torch/train/
torch_import.py, torch_export.py, checkpoint.detect_checkpoint_format and
evaluate._load_eval_state) against the JAX package's train/torch_import.py
and train/torch_export.py, on the CPU in float32:

  - module_map and convert_state_dict's trees equal the JAX package's exactly
    for UNET, UNET+, SpectralUNET at a narrow bn_feats and CubeNET at
    cube_featmaps 64 and 32, on the reference-keyed state dict that the JAX
    exporter writes from a flax init (with seeded BatchNorm statistics); the
    port's exporter writes the same state dict from the port model;
  - the port's logits after the import equal the flax model's on a 16x24
    input;
  - a ZeRO-2 directory (written as tests/test_torch_ckpt_e2e.py writes one:
    bf16 module copies, float32 master shards with world-size padding)
    consolidates to the JAX package's state dict;
  - detect_checkpoint_format tells the port's payloads, the reference's
    files and directories apart, by content; only a Lightning .ckpt is ever
    fully unpickled; ZeRO-2 shards are ordered by rank as a number;
  - validate_net and kfold_validate evaluate a Lightning .ckpt, a raw
    best_wts.pt and a ZeRO-2 directory found under the save path.
"""

import argparse
import collections
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import CubeNET as JaxCubeNET  # noqa: E402
from hyperpri_tpu.models.spectral_unet import SpectralUNET as JaxSpectralUNET  # noqa: E402
from hyperpri_tpu.models.unet import UNet as JaxUNet  # noqa: E402
from hyperpri_tpu.train import torch_export as jexport  # noqa: E402
from hyperpri_tpu.train import torch_import as jimport  # noqa: E402
from hyperpri_tpu_torch import cli  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.models.parts import TorchBatchNorm  # noqa: E402
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET  # noqa: E402
from hyperpri_tpu_torch.models.unet import UNet  # noqa: E402
from hyperpri_tpu_torch.train import torch_import  # noqa: E402
from hyperpri_tpu_torch.train.checkpoint import (  # noqa: E402
    DualCheckpointManager,
    detect_checkpoint_format,
    load_torch_file,
)
from hyperpri_tpu_torch.train.evaluate import validate_net  # noqa: E402
from hyperpri_tpu_torch.train.torch_export import export_state_dict  # noqa: E402
from hyperpri_tpu_torch.train.trainer import Trainer  # noqa: E402
from hyperpri_tpu_torch.weights import (  # noqa: E402
    export_flax_trees,
    export_state,
    load_jax_variables,
)

HW = (16, 24)
BANDS = 8
# float32 through up to two dozen convs, XLA against oneDNN summation orders.
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)

# name, cfg for module_map, flax model, port model, input channels
CASES = {
    "UNET": ("UNET", None, lambda: JaxUNet(3, 1, bilinear=False),
             lambda: UNet(3, 1, bilinear=False), 3),
    "UNET+": ("UNET+", None, lambda: JaxUNet(3, 1, bilinear=False, use_attention=True),
              lambda: UNet(3, 1, bilinear=False, use_attention=True), 3),
    "SpectralUNET": ("SpectralUNET", None,
                     lambda: JaxSpectralUNET(hsi_depth=BANDS, bn_feats=16),
                     lambda: SpectralUNET(hsi_depth=BANDS, bn_feats=16), BANDS),
    "CubeNET-64": ("CubeNET", types.SimpleNamespace(cube_featmaps=64),
                   lambda: JaxCubeNET(BANDS, 1, first_depth=64, bilinear=False),
                   lambda: CubeNET(BANDS, 1, 64), BANDS),
    "CubeNET-32": ("CubeNET", types.SimpleNamespace(cube_featmaps=32),
                   lambda: JaxCubeNET(BANDS, 1, first_depth=32, bilinear=False),
                   lambda: CubeNET(BANDS, 1, 32), BANDS),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _empty(port_model):
    """The port model with storage but no init (its full-width initializers
    take seconds on the CPU): a caller fills every entry."""
    with torch.device("meta"):
        model = port_model()
    return model.to_empty(device="cpu")


@pytest.fixture(scope="module")
def flax_inits():
    """{case: (flax model, params, batch_stats, x, port model)}: seeded normal
    weights (deviation 1/sqrt(fan-in)) and BatchNorm statistics in a port
    model, and its flax trees, which the flax model applies as they are."""
    out = {}
    for i, (case, (_, _, jmodel, port_model, channels)) in enumerate(CASES.items()):
        g = torch.Generator().manual_seed(i)
        model = _empty(port_model)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.endswith("running_var"):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                elif t.dim() > 1:
                    t.copy_(torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5)
                else:
                    t.copy_(torch.randn(t.shape, generator=g) * 0.1 + (
                        1.0 if name.endswith(".weight") else 0.0))
        trees = export_flax_trees(model)
        x = np.random.default_rng(i).normal(size=(1,) + HW + (channels,)).astype(np.float32)
        out[case] = (jmodel(), trees["params"], trees["batch_stats"], x, model)
    return out


def _reference_sd(flax_inits, case):
    name, cfg, *_ = CASES[case]
    _, params, stats, *_ = flax_inits[case]
    return {k: torch.from_numpy(np.array(v))
            for k, v in jexport.export_state_dict(params, stats, name, cfg).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_module_map_matches_jax(case):
    name, cfg, *_ = CASES[case]
    assert torch_import.module_map(name, cfg) == jimport.module_map(name, cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_convert_state_dict_matches_jax_exactly(flax_inits, case):
    name, cfg, *_ = CASES[case]
    sd = _reference_sd(flax_inits, case)
    for mine, theirs in zip(torch_import.convert_state_dict(sd, name, cfg),
                            jimport.convert_state_dict(sd, name, cfg)):
        mine, theirs = _flat(mine), _flat(theirs)
        assert sorted(mine) == sorted(theirs)
        for path, want in theirs.items():
            assert mine[path].dtype == want.dtype and np.array_equal(mine[path], want), path


@pytest.mark.parametrize("case", list(CASES))
def test_export_matches_jax(flax_inits, case):
    """The port's exporter writes the JAX exporter's state dict from the port
    model."""
    name, cfg, *_ = CASES[case]
    sd = _reference_sd(flax_inits, case)
    exported = export_state_dict(flax_inits[case][4], name, cfg)
    assert sorted(exported) == sorted(sd)
    for k, v in sd.items():
        assert exported[k].dtype == v.dtype and torch.equal(exported[k], v), k


# UNET and CubeNET-64 load flax trees against flax in test_torch_port_unet.py
# and test_torch_port_cubenet.py; here the merge, the other head and the
# Dense layers.
@pytest.mark.parametrize("case", ["UNET+", "SpectralUNET", "CubeNET-32"])
def test_logits_after_import_match_flax(flax_inits, case):
    """The reference-keyed state dict imported into a fresh port model gives
    the flax model's logits with the JAX package's import of it."""
    name, cfg, _, port_model, _ = CASES[case]
    jmodel, _, _, x, _ = flax_inits[case]
    sd = _reference_sd(flax_inits, case)
    target = load_jax_variables(_empty(port_model),
                                *torch_import.convert_state_dict(sd, name, cfg))
    with torch.no_grad():
        got = target(torch.from_numpy(x)).numpy()
    jp, js = jimport.convert_state_dict(sd, name, cfg)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        {"params": jp, "batch_stats": js}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def _write_zero2_dir(ckpt_dir, sd_fp32, world=2, n_groups=2):
    """Synthesize a DeepSpeed ZeRO-2 sharded checkpoint: bf16 module copies
    + rank-partitioned fp32 masters (padded flat groups), 'latest' tag
    (the writer of tests/test_torch_ckpt_e2e.py)."""
    tag = "checkpoint"
    root = os.path.join(ckpt_dir, tag)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(tag)

    param_items = [(k, v) for k, v in sd_fp32.items()
                   if "running_" not in k and "num_batches" not in k]
    buffers = {k: v for k, v in sd_fp32.items() if k not in dict(param_items)}
    # split params into groups round-robin (any grouping is legal)
    groups = [param_items[g::n_groups] for g in range(n_groups)]

    param_shapes = []
    partitions = [[] for _ in range(world)]
    for items in groups:
        shapes = collections.OrderedDict((k, v.shape) for k, v in items)
        param_shapes.append(shapes)
        flat = torch.cat([v.flatten().float() for _, v in items])
        pad = (-len(flat)) % world
        flat = torch.cat([flat, torch.zeros(pad)])
        per = len(flat) // world
        for r in range(world):
            partitions[r].append(flat[r * per: (r + 1) * per].clone())

    module_bf16 = {k: (v.bfloat16().float() if v.dtype.is_floating_point else v)
                   for k, v in {**dict(param_items), **buffers}.items()}
    torch.save({"module": module_bf16, "param_shapes": param_shapes,
                "ds_version": "0.9.0"},
               os.path.join(root, "mp_rank_00_model_states.pt"))
    for r in range(world):
        torch.save({"optimizer_state_dict":
                    {"single_partition_of_fp32_groups": partitions[r],
                     "zero_stage": 2, "partition_count": world}},
                   os.path.join(root, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))


@pytest.mark.parametrize("case", ["UNET+", "CubeNET-32"])
def test_zero2_consolidation_matches_jax(flax_inits, tmp_path, case):
    sd = {f"_forward_module.m_network.{k}": v for k, v in _reference_sd(flax_inits,
                                                                          case).items()}
    _write_zero2_dir(str(tmp_path / "z"), sd, world=3)
    try:
        mine = torch_import.consolidate_zero2_dir(str(tmp_path / "z"))
        theirs = jimport.consolidate_zero2_dir(str(tmp_path / "z"))
    finally:
        shutil.rmtree(tmp_path / "z")   # about 0.5 GB at these widths
    assert sorted(mine) == sorted(theirs) == sorted(sd)
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
        if "running_" not in k and "num_batches" not in k:
            assert torch.equal(mine[k], sd[k]), k   # the float32 masters, not bf16 copies


def test_detect_checkpoint_format(tmp_path):
    model = SpectralUNET(hsi_depth=BANDS, bn_feats=16)
    ckpt = DualCheckpointManager(str(tmp_path / "run"))
    state = export_state(model, torch.optim.Adam(model.parameters()))
    ckpt.step(0, 0.5, 0.5, {"state": state, "epoch": 0}, {k: state[k] for k in
                                                          ("params", "batch_stats")})
    for d in ("Checkpoints", "diceCheckpoints"):
        for name in os.listdir(tmp_path / "run" / d):
            assert detect_checkpoint_format(str(tmp_path / "run" / d / name)) == "port"
    sd = export_state_dict(model, "SpectralUNET")
    files = {
        "lightning.ckpt": {"pytorch-lightning_version": "2.0.7", "epoch": 3,
                           "hyper_parameters": argparse.Namespace(lr=1e-3),
                           "state_dict": {f"_forward_module.m_network.{k}": v
                                          for k, v in sd.items()}},
        "best_wts.pt": {f"module.{k}": v for k, v in sd.items()},
        "bare.pt": sd,
    }
    for name, payload in files.items():
        torch.save(payload, tmp_path / name)
        assert detect_checkpoint_format(str(tmp_path / name)) == "torch", name
    _write_zero2_dir(str(tmp_path / "zero"), sd)
    assert detect_checkpoint_format(str(tmp_path / "zero")) == "zero_dir"
    torch.save([1, 2, 3], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="neither the port's checkpoint"):
        detect_checkpoint_format(str(tmp_path / "list.pt"))


def test_zero2_consolidation_orders_ranks_numerically(tmp_path):
    """Twelve ranks: zero_pp_rank_10_* and _11_* sort after _9_*, not after
    _1_* (string order would interleave the master shards)."""
    sd = export_state_dict(_source(5), "SpectralUNET")
    _write_zero2_dir(str(tmp_path / "z"), sd, world=12)
    got = torch_import.consolidate_zero2_dir(str(tmp_path / "z"))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        if "running_" not in k and "num_batches" not in k:
            assert torch.equal(got[k], v), k


TRIPPED = []


def _trip():
    TRIPPED.append(1)


class _Tripwire:
    """An object whose unpickling calls _trip: it shows a full unpickling."""

    def __reduce__(self):
        return _trip, ()


def test_load_torch_file_fully_unpickles_only_lightning(tmp_path):
    sd = export_state_dict(SpectralUNET(hsi_depth=BANDS, bn_feats=16), "SpectralUNET")
    TRIPPED.clear()
    torch.save({**{f"module.{k}": v for k, v in sd.items()}, "extra": _Tripwire()},
               tmp_path / "best_wts.pt")
    with pytest.raises(pickle.UnpicklingError, match="not a Lightning checkpoint"):
        load_torch_file(str(tmp_path / "best_wts.pt"))
    assert not TRIPPED
    torch.save({"pytorch-lightning_version": "2.0.7", "hyper_parameters": _Tripwire(),
                "state_dict": {f"_forward_module.m_network.{k}": v for k, v in sd.items()}},
               tmp_path / "lightning.ckpt")
    assert load_torch_file(str(tmp_path / "lightning.ckpt"))["pytorch-lightning_version"]
    assert TRIPPED == [1]   # the documented full unpickling of a Lightning .ckpt
    torch.save({"state": {}, "pytorch-lightning_version": "x"}, tmp_path / "safe.ckpt")
    TRIPPED.clear()
    assert detect_checkpoint_format(str(tmp_path / "safe.ckpt")) == "port"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_experiment_tree(str(root), n_boxes=2, dates_per_box=1, size_hw=(12, 16), bands=299,
                         seed=0)
    return root


FEATS = 16


def _config(tree, tmp_path):
    """SpectralUNET-16 on the tree's 8-band window, in a calling path of its
    own (the model, not the checkpoint formats, is what the width costs)."""
    calling = tmp_path / "calling"
    shutil.copytree(tree / "Datasets", calling / "Datasets")
    return ExpHyperspectralPRI(calling_path=str(calling), device="cpu", hsi_lo=0,
                               hsi_hi=BANDS, model_name="SpectralUNET",
                               spectral_bn_size=FEATS)


def _source(seed):
    """A seeded SpectralUNET whose BatchNorm running statistics are bf16
    values, as a bf16-mixed DeepSpeed run keeps them (the ZeRO-2 module
    copies carry them in bf16)."""
    g = torch.Generator().manual_seed(seed)
    model = SpectralUNET(hsi_depth=BANDS, bn_feats=FEATS, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=g).bfloat16().float())
                m.running_var.copy_((torch.rand(n, generator=g) + 0.5).bfloat16().float())
    return model.eval()


def _write_reference(fmt, cfg, sd):
    os.makedirs(os.path.join(cfg.save_path, "Checkpoints"), exist_ok=True)
    name = os.path.join(cfg.save_path, "Checkpoints", "epoch=4-val_loss=0.300-val_dice=0.700.ckpt")
    if fmt == "lightning":
        torch.save({"pytorch-lightning_version": "2.0.7",
                    "hyper_parameters": argparse.Namespace(lr=1e-3),
                    "state_dict": {f"_forward_module.m_network.{k}": v for k, v in sd.items()}},
                   name)
    elif fmt == "best_wts":
        os.rmdir(os.path.join(cfg.save_path, "Checkpoints"))
        torch.save({f"module.{k}": v for k, v in sd.items()},
                   os.path.join(cfg.save_path, "best_wts.pt"))
    else:
        _write_zero2_dir(name, {f"_forward_module.m_network.{k}": v for k, v in sd.items()})


@pytest.mark.parametrize("fmt", ["lightning", "best_wts", "zero2"])
def test_validate_net_evaluates_reference_checkpoints(tree, tmp_path, fmt, capsys):
    """The checkpoint under save_path is loaded by its format; the loaded model
    gives the source model's logits bit for bit, and the sweep runs."""
    cfg = _config(tree, tmp_path)
    source = _source(3)
    _write_reference(fmt, cfg, export_state_dict(source, "SpectralUNET", cfg))
    trainer = Trainer(cfg)
    precision, recall, thr = validate_net(cfg.get_val_data(), cfg, trainer=trainer,
                                          n_thresholds=50, verbose=False)
    assert "LOADING FROM CKPT FILE" in capsys.readouterr().out
    assert precision.shape == (51,) and np.isfinite(precision).all()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 12, 16, BANDS)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(trainer.model(x), source(x))


def test_kfold_validate_reads_a_zero2_directory(tree, tmp_path):
    cfg = _config(tree, tmp_path)
    _write_reference("zero2", cfg, export_state_dict(_source(4), "SpectralUNET", cfg))
    cli.main(["kfold_validate", "--calling-path", cfg.calling_path, "--models", "SpectralUNET",
              "--num-splits", "1", "--hsi-lo", "0", "--hsi-hi", str(BANDS),
              "--spectral-bn-size", str(FEATS), "--device", "cpu"])
    saved = os.path.join(cfg.calling_path, "Saved_Models", "HSI")
    assert os.path.exists(os.path.join(saved, "SpectralUNET_pr.csv"))
    assert os.path.exists(os.path.join(cfg.save_path, "pr_curve.csv"))
