"""The port's CLI (python -m hyperpri_tpu_torch.cli) on a tiny synthetic
tree of RGB PNGs and ENVI cubes on the CPU: kfold_train --dataset RGB (UNET)
and kfold_train with no flag (CubeNET on HSI), each with --validate, then
kfold_validate over both, with the JAX package's flags; the options not
ported yet refuse to run."""

import csv
import os
import shutil

import pytest

from hyperpri_tpu_torch import cli
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
    assert cli.KFOLD_MODELS == ["UNET", "CubeNET"]
    assert cli.main(["kfold_validate"] + common) == 0
    with open(saved / "HSI" / "UNET_CubeNET_pr.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * 501 and {r["model"] for r in rows} == {"UNET", "CubeNET"}
    capsys.readouterr()
    # --load-ckpt resumes the split from last.ckpt: one more epoch
    assert cli.main(["kfold_train", "--load-ckpt", "--max-epochs", "3"] + common) == 0
    assert "Resumed from" in capsys.readouterr().out
    with open(runs["CubeNET_64"] / "LOGS" / "metrics.csv") as f:
        assert [float(row["epoch"]) for row in csv.DictReader(f)] == [0, 1, 2]


@pytest.mark.parametrize("argv", [
    ["kfold_train", "--model-shard"], ["kfold_train", "--chunks", "2"],
    ["kfold_train", "--offload"], ["kfold_validate", "--save-segmaps"],
])
def test_options_not_ported_refuse(tmp_path, argv):
    with pytest.raises(SystemExit, match="not ported|segmaps"):
        cli.main(argv + ["--calling-path", str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "Saved_Models")


def test_unknown_command_prints_usage(capsys):
    assert cli.main(["kfold_segmaps"]) == 2
    assert "segmaps slice" in capsys.readouterr().err
