"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They import
no JAX, so they also run where only the port's dependencies exist:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import (
    conv3x3_packed,
    conv3x3_packed_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bf16_ulp_error(out, ref):
    """Max |out - ref| in bf16 ulps of max(|out|, |ref|, 2**-6): the kernel and
    the plain version sum in float32 in different orders and round once; the
    floor covers outputs that cancel below the float32 round-off of the sum."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((o - r).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,relu", [
    ((1, 37, 53, 238), 48, False),   # C=238: 4-byte loads, ragged H/W tiles
    ((2, 29, 71, 64), 64, True),     # 16-byte loads
    ((1, 17, 33, 61), 128, True),    # odd C: element loads; O=128
])
def test_conv3x3_packed_matches_plain(cuda_device, shape, o, relu):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(o,))).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    w = w.to(cuda_device, torch.bfloat16)
    b = b.to(cuda_device)
    launches = conv3x3_packed.launches
    out = conv3x3_packed(x, w, b, relu=relu)
    assert conv3x3_packed.launches == launches + 1
    ref = conv3x3_packed_reference(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _bf16_ulp_error(out, ref) <= 1.0


@pytest.mark.cuda
def test_conv3x3_packed_rejects_non_bf16(cuda_device):
    x = torch.zeros((1, 8, 8, 8), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        conv3x3_packed(x, torch.zeros((3, 3, 8, 8), device=cuda_device),
                       torch.zeros(8, device=cuda_device))
