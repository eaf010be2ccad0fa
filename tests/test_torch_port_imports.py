"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the CUDA card unless told otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hyperpri_tpu_torch.serve import build_cubenet_server, build_unet_server
from hyperpri_tpu_torch.train.step import build_cubenet_trainer, build_spectral_unet_trainer

ROOT = Path(__file__).resolve().parents[1]

# `hyperpri_tpu` is a prefix of `hyperpri_tpu_torch`, so the check reads
# sys.modules by exact package name rather than grepping sources.
_CHECK = """
import sys
import chip_smoke
import hyperpri_tpu_torch
import hyperpri_tpu_torch.models.cubenet
import hyperpri_tpu_torch.ops.fold_bn
import hyperpri_tpu_torch.models.parts
import hyperpri_tpu_torch.ops.kernels._build
import hyperpri_tpu_torch.ops.kernels._plain
import hyperpri_tpu_torch.ops.kernels.conv3x3
import hyperpri_tpu_torch.ops.kernels.conv3x3_grad
import hyperpri_tpu_torch.ops.kernels.conv3x3_packed
import hyperpri_tpu_torch.ops.kernels.conv_train
import hyperpri_tpu_torch.ops.kernels.pool_bwd
import hyperpri_tpu_torch.ops.losses
import hyperpri_tpu_torch.ops.metrics
import hyperpri_tpu_torch.ops.pool
import hyperpri_tpu_torch.serve
import hyperpri_tpu_torch.train.step
import hyperpri_tpu_torch.weights
import hyperpri_tpu_torch.cli
import hyperpri_tpu_torch.config
import hyperpri_tpu_torch.data.dataset
import hyperpri_tpu_torch.data.envi
import hyperpri_tpu_torch.data.pipeline
import hyperpri_tpu_torch.data.png
import hyperpri_tpu_torch.data.splits
import hyperpri_tpu_torch.data.synthetic
import hyperpri_tpu_torch.models.registry
import hyperpri_tpu_torch.ops.kernels.framing
import hyperpri_tpu_torch.ops.kernels.probe_element_out
import hyperpri_tpu_torch.ops.kernels.conv3x3_shift
import hyperpri_tpu_torch.ops.kernels.probe_dh_fold
import hyperpri_tpu_torch.ops.kernels.probe_mosaic_ops
import hyperpri_tpu_torch.ops.kernels.sm90_plan
import hyperpri_tpu_torch.train.checkpoint
import hyperpri_tpu_torch.train.evaluate
import hyperpri_tpu_torch.train.trainer
import hyperpri_tpu_torch.utils.logging
import hyperpri_tpu_torch.utils.tb_events
import hyperpri_tpu_torch.models.spectral_unet
import hyperpri_tpu_torch.ops.chunked
import hyperpri_tpu_torch.train.chunked
import hyperpri_tpu_torch.utils.segmaps
import hyperpri_tpu_torch.data.native_io
import hyperpri_tpu_torch.data.disk_cache
import hyperpri_tpu_torch.train.torch_import
import hyperpri_tpu_torch.train.torch_export
import hyperpri_tpu_torch.parallel.mesh
import hyperpri_tpu_torch.parallel.sharding
import hyperpri_tpu_torch.parallel.spatial_conv
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton",
                                    "hyperpri_tpu", "PIL", "matplotlib", "ml_dtypes"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cubenet_server(0)


def test_unet_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_unet_server(0)


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cubenet_trainer(0)


def test_spectral_unet_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_spectral_unet_trainer(0, bn_feats=16, n_chunks=2)


def test_every_csrc_file_rebuilds_every_library(tmp_path, monkeypatch):
    """The kernels share headers, so a library is stale when ANY file under
    csrc/ is newer than it (nvcc is replaced by a recorder here)."""
    from hyperpri_tpu_torch.ops.kernels import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text("// source")
    runs = []

    def fake_run(cmd, **kwargs):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    _build.build("a")
    _build.build("a")
    assert len(runs) == 1 and str(csrc / "a.cu") in runs[0]
    newer = (out / "liba.so").stat().st_mtime + 10
    os.utime(csrc / "shared.cuh", (newer, newer))
    _build.build("a")
    assert len(runs) == 2
    built = _build.build_all(("a", "b"), force=True)
    assert sorted(built) == ["a", "b"] and len(runs) == 4


@pytest.mark.parametrize("name", ["conv3x3_packed", "conv3x3", "conv3x3_grad", "pool_bwd",
                                  "probe_element_out", "conv3x3_shift", "probe_dh_fold",
                                  "probe_mosaic_ops"])
def test_each_library_rebuilds_on_any_csrc_change(name, tmp_path, monkeypatch):
    """Every kernel library of the port is in LIBRARIES, built from its own
    csrc/<name>.cu, and stale once any file under csrc/ (a shared header) is
    newer (nvcc is replaced by a recorder here)."""
    from hyperpri_tpu_torch.ops.kernels import _build

    assert name in _build.LIBRARIES and (_build.CSRC / f"{name}.cu").is_file()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    runs = []

    def fake_run(cmd, **kwargs):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    _build.build(name)
    _build.build(name)
    assert len(runs) == 1 and runs[0][-1] == str(csrc / f"{name}.cu")
    newer = (tmp_path / "build" / f"lib{name}.so").stat().st_mtime + 10
    os.utime(csrc / "conv3x3_common.cuh", (newer, newer))
    _build.build(name)
    assert len(runs) == 2


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_product_loop_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from hyperpri_tpu_torch.config import ExpHyperspectralPRI
    from hyperpri_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExpHyperspectralPRI(calling_path=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
