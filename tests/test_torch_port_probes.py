"""The port's two probes against the JAX package's probe scripts: the dh-fold
probe's plain versions against scripts/probe_dh_fold.py's Pallas kernels
(built by its `build` inside force_tpu_interpret_mode, at n=1, h=16, w=100,
on the arrays `build` returns), within one bf16 ulp; each Mosaic-op body of
scripts/probe_mosaic_ops.py in an interpret-mode pallas_call against the
port's plain op, bit for bit (pltpu.roll runs in interpret mode, not outside
a kernel). On CPU tensors the port's wrappers run their plain versions: the
code that chip_smoke.py holds the CUDA kernels against. Also the dh-fold
Hopper kernel's in-place weight map, emulated on the CPU, against the rows
the synchronous kernel's packing gives.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hyperpri_tpu_torch.ops.kernels import probe_dh_fold, probe_mosaic_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16_ulps(out, ref):
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -6)
    return float(((o - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _torch_bf16(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).bfloat16()


@pytest.fixture(scope="module")
def jax_dh_fold():
    """The JAX probe's two kernels and their outputs, run in interpret mode."""
    probe = _script("probe_dh_fold")
    with pltpu.force_tpu_interpret_mode():
        (cur, a_cur), (fold, a_fold) = probe.build(n=1, h=16, w=100)
        outs = (cur(*a_cur), fold(*a_fold))
    return ([_torch_bf16(a) for a in a_cur], [_torch_bf16(a) for a in a_fold],
            [_torch_bf16(o) for o in outs])


@pytest.mark.parametrize("kernel", ["current", "folded"])
def test_dh_fold_plain_matches_pallas(jax_dh_fold, kernel):
    a_cur, a_fold, (y_cur, y_fold) = jax_dh_fold
    if kernel == "current":
        out, ref = probe_dh_fold.current(*a_cur), y_cur
    else:
        out, ref = probe_dh_fold.folded(*a_fold), y_fold
    assert out.shape == ref.shape == (1, 16, 128, 64) and out.dtype == torch.bfloat16
    assert _bf16_ulps(out, ref) <= 1.0


def test_dh_fold_build_and_both_forms_agree():
    """The port's own inputs at the JAX test's size: shapes as the TPU probe
    builds them, zero upper lanes, and the two forms within one bf16 ulp."""
    (cur, a_cur), (fold, a_fold) = probe_dh_fold.build(n=1, h=16, w=100, device="cpu")
    x128, w = a_cur
    x64, w01, w2 = a_fold
    assert x128.shape == (1, 18, 136, 128) and x64.shape == (1, 18, 136, 64)
    assert not x128[..., 64:].any() and not w[:, 64:].any() and not w2[:, 64:].any()
    assert torch.equal(w01[0, 64:], w[1, :64])
    assert _bf16_ulps(cur(*a_cur), fold(*a_fold)) <= 1.0


def test_dh_fold_rejects_ragged_tiles():
    with pytest.raises(ValueError):
        probe_dh_fold.current(torch.zeros((1, 17, 136, 128), dtype=torch.bfloat16),
                              torch.zeros((3, 128, 192), dtype=torch.bfloat16))


def _weight_box(w, tap, chunk, dw):
    """The (64 channels, 64 outputs) box of w (taps, 128, 192) that the
    Hopper kernel's tensor map reads in place at coordinates (dw * 64,
    chunk * 64, tap): the map's dims (192, 128, taps) and strides (1, 192,
    128 * 192 elements; csrc/probe_dh_fold.cu, weight_map) applied to w's
    storage."""
    dims, strides = (192, 128, w.shape[0]), (1, 192, 128 * 192)
    o = torch.arange(dw * 64, (dw + 1) * 64)
    c = torch.arange(chunk * 64, (chunk + 1) * 64)
    assert tap < dims[2] and o[-1] < dims[0] and c[-1] < dims[1]
    flat = w.contiguous().reshape(-1)
    return flat[tap * strides[2] + c[:, None] * strides[1] + o[None, :] * strides[0]]


@pytest.mark.parametrize("weights", ["current", "w01", "w2"])
def test_dh_fold_weight_map_boxes_are_the_packed_rows(weights):
    """The Hopper kernel reads W (taps, 128, 192) in place through a tensor
    map of dims (192, 128, taps), boxes of 64 outputs x 64 channels at (dw *
    64, chunk * 64, tap). Emulated on the CPU by the map's dims and strides,
    each (tap, chunk, dw) box is W's block of those channels and outputs
    and, transposed, the two 32-lane rows [tap][2*chunk + j][dw] that `_pack`
    gives the synchronous body: both bodies multiply the same weights."""
    (_, (_, w)), (_, (_, w01, w2)) = probe_dh_fold.build(n=1, h=16, w=100, device="cpu",
                                                         seed=3)
    w = {"current": w, "w01": w01, "w2": w2}[weights]
    packed = probe_dh_fold._pack(w)
    for tap in range(w.shape[0]):
        for chunk in range(2):
            for dw in range(3):
                box = _weight_box(w, tap, chunk, dw)
                block = w[tap, chunk * 64:(chunk + 1) * 64, dw * 64:(dw + 1) * 64]
                assert box.shape == (64, 64) and torch.equal(box, block)
                for j in range(2):
                    assert torch.equal(box[j * 32:(j + 1) * 32].T, packed[tap, 2 * chunk + j, dw])


_JAX_BODIES = {
    "roll_axis0": lambda x: pltpu.roll(x, 1, 0),
    "roll_axis1": lambda x: pltpu.roll(x, 1, 1),
    "repeat_axis0": lambda x: jnp.repeat(x[:4], 2, axis=0),
    "repeat_axis1": lambda x: jnp.repeat(x[:, :8], 2, axis=1),
    "neg_inf_where": lambda x: jnp.where(x > 0, jnp.full_like(x, -jnp.inf), x),
    "stride2_axis0": lambda x: jnp.concatenate([x[0::2], x[1::2]], 0),
    "stack_reshape_axis0": lambda x: jnp.stack([x[:4], x[4:]], axis=1).reshape(8, 16, 128),
    "bcast_reshape_axis1": lambda x: jnp.broadcast_to(x[:, :8, None, :],
                                                      (8, 8, 2, 128)).reshape(8, 16, 128),
}


def test_mosaic_ops_are_the_jax_probes_cases():
    """The port's ops are the TPU probe's eight cases, in its order (the
    bodies above are copied from scripts/probe_mosaic_ops.py:43-56)."""
    source = (ROOT / "scripts" / "probe_mosaic_ops.py").read_text()
    assert list(probe_mosaic_ops.OPS) == list(_JAX_BODIES)
    assert [name for name in _JAX_BODIES if f'"{name}"' in source] == list(_JAX_BODIES)
    assert probe_mosaic_ops.S == _script("probe_mosaic_ops").S


@pytest.mark.parametrize("name", list(_JAX_BODIES))
def test_mosaic_op_matches_pallas_exactly(name):
    body = _JAX_BODIES[name]

    def kernel(x_ref, o_ref):
        o_ref[...] = body(x_ref[...])

    x = probe_mosaic_ops.probe_input("cpu")
    ref = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(probe_mosaic_ops.S, jnp.float32),
                         interpret=True)(jnp.asarray(x.numpy()))
    out = probe_mosaic_ops.run_case(name, x)
    assert torch.equal(out, torch.from_numpy(np.array(ref)))


def test_mosaic_run_case_rejects_unknown_ops_and_shapes():
    x = probe_mosaic_ops.probe_input("cpu")
    with pytest.raises(ValueError):
        probe_mosaic_ops.run_case("transpose", x)
    with pytest.raises(ValueError):
        probe_mosaic_ops.run_case("roll_axis0", x[:4])
