"""Port's conv3x3_packed (hyperpri_tpu_torch/ops/kernels/conv3x3_packed.py)
against the JAX tap-packed Pallas kernel run in interpret mode on the CPU.

On a CPU tensor the port's wrapper runs its plain version, so these tests
hold the plain version against the Pallas kernel. The CUDA kernel itself is
held against the plain version by tests/test_torch_port_cuda.py (and by
chip_smoke.py), which need the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas.conv3x3_packed import conv3x3_packed as jax_conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import (  # noqa: E402
    conv3x3_packed,
    conv3x3_packed_reference,
)

# float32 on the CPU: the two sum the same products in different orders.
ATOL = 2e-5


def _inputs(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    "n,h,w,c,o",
    [
        (2, 16, 24, 8, 16),
        (1, 10, 12, 8, 8),      # ragged H
        (1, 9, 11, 16, 8),      # odd everything
        (1, 7, 5, 4, 4),        # tiny map
        (1, 12, 30, 64, 64),    # ragged W
        (2, 16, 11, 130, 8),    # > 128 input channels
        (1, 10, 13, 238, 64),   # CubeNET's first conv, 238 -> 64
        (1, 8, 10, 12, 128),    # O = 128
    ],
)
def test_plain_matches_pallas_interpret(rng, relu, n, h, w, c, o):
    x, wk, b = _inputs(rng, n, h, w, c, o)
    ref = jax_conv3x3_packed(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                             relu=relu, interpret=True)
    out = conv3x3_packed(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b),
                         relu=relu)
    assert out.dtype == torch.float32 and out.shape == (n, h, w, o)
    if not relu:
        assert float(out.min()) < 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_rejects_wide_output():
    x = torch.zeros((1, 8, 8, 8))
    with pytest.raises(ValueError, match="O <= 128"):
        conv3x3_packed(x, torch.zeros((3, 3, 8, 136)), torch.zeros(136))


def test_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        conv3x3_packed(torch.zeros((1, 8, 8, 8)), torch.zeros((3, 3, 4, 16)), torch.zeros(16))


def test_cpu_tensor_takes_plain_version_and_launches_nothing(rng):
    x, wk, b = (torch.from_numpy(a) for a in _inputs(rng, 1, 6, 7, 5, 3))
    calls, launches = conv3x3_packed.calls, conv3x3_packed.launches
    out = conv3x3_packed(x, wk, b)
    assert conv3x3_packed.calls == calls + 1
    assert conv3x3_packed.launches == launches
    torch.testing.assert_close(out, conv3x3_packed_reference(x, wk, b), rtol=0, atol=0)
