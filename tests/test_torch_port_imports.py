"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the CUDA card unless told otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hyperpri_tpu_torch.serve import build_cubenet_server

ROOT = Path(__file__).resolve().parents[1]

# `hyperpri_tpu` is a prefix of `hyperpri_tpu_torch`, so the check reads
# sys.modules by exact package name rather than grepping sources.
_CHECK = """
import sys
import chip_smoke
import hyperpri_tpu_torch
import hyperpri_tpu_torch.models.cubenet
import hyperpri_tpu_torch.ops.fold_bn
import hyperpri_tpu_torch.ops.kernels._build
import hyperpri_tpu_torch.ops.kernels.conv3x3_packed
import hyperpri_tpu_torch.ops.losses
import hyperpri_tpu_torch.ops.metrics
import hyperpri_tpu_torch.serve
import hyperpri_tpu_torch.weights
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "hyperpri_tpu"))
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


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
