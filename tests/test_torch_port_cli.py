"""The port's CLI (python -m hyperpri_tpu_torch.cli) on a tiny synthetic
tree of RGB PNGs and ENVI cubes on the CPU: kfold_train --dataset RGB (UNET),
kfold_train with no flag (CubeNET on HSI) and kfold_train --model
SpectralUNET --chunks 2, each with --validate, then kfold_validate
--save-segmaps over the three and kfold_segmaps at the published thresholds,
with the JAX package's flags; the options not ported yet refuse to run, and
--chunks / --offload refuse any model but SpectralUNET."""

import csv
import os
import shutil

import pytest
import torch

from hyperpri_tpu_torch import cli
from hyperpri_tpu_torch.data.png import load_png
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_tree")
    # 299 stored bands, so the HSI defaults' 25:263 window applies as on real cubes
    make_experiment_tree(str(root), n_boxes=2, dates_per_box=2, size_hw=(16, 24), bands=299,
                         seed=0)
    return root


@pytest.fixture
def saved(tree):
    """The run directories the CLI writes, removed afterwards: a full UNET or
    CubeNET-64 checkpoint is ~375 MB, and the suite's temporary space is
    shared."""
    yield tree / "Saved_Models"
    shutil.rmtree(tree / "Saved_Models", ignore_errors=True)


def test_kfold_train_then_validate(tree, saved, capsys):
    """As in the JAX package, kfold_train trains one model per call, the one
    its dataset's configuration names: --dataset RGB trains UNET, the default
    (HSI) CubeNET. Both run at fp32 on the kernel route (below its gates at
    16x24: the plain versions' shapes never fire) and are validated;
    kfold_validate then sweeps both, and --load-ckpt resumes CubeNET."""
    common = ["--calling-path", str(tree), "--num-splits", "1", "--device", "cpu"]
    runs = {"UNET": saved / "RGB" / "UNET" / "Run_1",
            "CubeNET_64": saved / "HSI" / "CubeNET_64" / "Run_1"}
    for flags, model in [(["--dataset", "RGB"], "UNET"), ([], "CubeNET_64")]:
        assert cli.main(["kfold_train", "--max-epochs", "2", "--validate"] + flags
                        + common) == 0
        out = capsys.readouterr().out
        assert "route: fp32: gated 3x3 convs on the CUDA kernels" in out
        assert out.count("Best Threshold") == 1
        assert f"Model: {model}\n" in out
        assert not any(f"Model: {other}" in out for other in runs if other != model)
        run = runs[model]
        assert (run / "Checkpoints" / "last.ckpt").exists()
        assert (run / "pr_curve.csv").exists() and (run / "LOGS" / "metrics.csv").exists()
        with open(run / "LOGS" / "metrics.csv") as f:
            assert [float(row["epoch"]) for row in csv.DictReader(f)] == [0, 1]
    # SpectralUNET: two pixel chunks a step (one image each), no kernel route
    spectral = ["--spectral-bn-size", "16"]
    assert cli.main(["kfold_train", "--model", "SpectralUNET", "--chunks", "2", "--max-epochs",
                     "1", "--validate"] + spectral + common) == 0
    out = capsys.readouterr().out
    assert ("route: fp32: Dense layers on torch.matmul (no kernel route); 2 pixel chunks a "
            "step") in out
    assert "Model: SpectralUNET_16\n" in out and out.count("Best Threshold") == 1
    assert (saved / "HSI" / "SpectralUNET_16" / "Run_1" / "Checkpoints" / "last.ckpt").exists()
    assert cli.KFOLD_MODELS == ["UNET", "SpectralUNET", "CubeNET"]
    assert cli.main(["kfold_validate", "--save-segmaps"] + spectral + common) == 0
    with open(saved / "HSI" / "UNET_SpectralUNET_CubeNET_pr.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 * 501 and {r["model"] for r in rows} == set(cli.KFOLD_MODELS)
    maps = [sorted((saved / ds / "Val_Segmentation_Maps" / "Run_1" / name).glob("*_seg.png"))
            for ds, name in (("RGB", "UNET"), ("HSI", "SpectralUNET_16"), ("HSI", "CubeNET_64"))]
    assert [len(m) for m in maps] == [2, 2, 2]   # one a validation image
    for path in sum(maps, []):
        assert load_png(str(path), "RGB").shape == (16, 24, 3)
    # test-set metrics at the published split-1 thresholds, the overlays rewritten
    written = {p: p.stat().st_mtime_ns for p in sum(maps, [])}
    val = os.path.join(str(tree), "Datasets", "HyperPRI", "data_splits", "val1.json")
    results = cli.kfold_segmaps(["--test-json", val] + spectral + common)
    assert [(split, m, r["threshold"]) for (split, m), r in results.items()] == [
        (1, m, cli.REFERENCE_THRESHOLDS[m][0]) for m in cli.KFOLD_MODELS]
    assert all(0 <= r["dice"] <= 1 and r["conf_mat"].shape == (2, 2) for r in results.values())
    assert all(p.stat().st_mtime_ns > t for p, t in written.items())
    capsys.readouterr()
    # --load-ckpt resumes the split from last.ckpt: one more epoch
    assert cli.main(["kfold_train", "--load-ckpt", "--max-epochs", "3"] + common) == 0
    assert "Resumed from" in capsys.readouterr().out
    with open(runs["CubeNET_64"] / "LOGS" / "metrics.csv") as f:
        assert [float(row["epoch"]) for row in csv.DictReader(f)] == [0, 1, 2]


@pytest.mark.parametrize("argv, why", [
    (["kfold_train", "--model-shard", "--offload"],
     "--offload is a SpectralUNET training mode \\(per-pixel model\\); current model is "
     "CubeNET"),
    (["kfold_train", "--chunks", "2"],
     "--chunks is a SpectralUNET training mode \\(per-pixel model\\); current model is "
     "CubeNET"),
    (["kfold_train", "--offload"],
     "--offload is a SpectralUNET training mode \\(per-pixel model\\); current model is "
     "CubeNET"),
    (["kfold_train", "--dataset", "RGB", "--chunks", "2"],
     "--chunks is a SpectralUNET training mode \\(per-pixel model\\); current model is "
     "UNET"),
])
def test_options_not_ported_refuse(tmp_path, argv, why):
    with pytest.raises(SystemExit, match=why):
        cli.main(argv + ["--calling-path", str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "Saved_Models")


@pytest.mark.parametrize("argv", [
    ["kfold_train", "--model", "SpectralUNET", "--chunks", "2", "--spectral-bn-size", "16"],
    ["kfold_segmaps", "--no-segmaps"],
])
def test_commands_default_to_the_card(tree, saved, monkeypatch, argv):
    """Without --device cpu and without a card, they raise instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    val = os.path.join(str(tree), "Datasets", "HyperPRI", "data_splits", "val1.json")
    extra = ["--test-json", val] if argv[0] == "kfold_segmaps" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + extra + ["--calling-path", str(tree), "--num-splits", "1"])


def test_unknown_command_prints_usage(capsys):
    assert cli.main(["kfold_export"]) == 2
    assert "{kfold_train | kfold_validate | kfold_segmaps}" in capsys.readouterr().err
