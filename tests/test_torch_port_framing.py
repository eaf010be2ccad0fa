"""The port's framed kernel modes (pre_padded, arena_in, arena_out, arena_g,
logical_hw of conv3x3_packed; pre_padded_c, arena_in, arena_g of
conv3x3_wgrad) against the JAX package's Pallas kernels in interpret mode, on
buffers built to the JAX package's own geometry (the port's kernels read any
frame that covers the logical region), and the port's ingest geometry
against the JAX package's at CubeNET's shapes. The JAX kernel's lane_stride
is the output tile width, which the port's wrapper picks from O.

Shapes follow tests/test_ingest.py and tests/test_arena.py, NaN-filled arena
frames included. Inputs come from a numpy seed. On CPU tensors the wrappers
run their plain versions: the same code that chip_smoke.py holds the CUDA
kernels against.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.models import parts as jparts  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_grad import conv3x3_wgrad as jax_wgrad  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import (  # noqa: E402
    arena_extent as jax_arena_extent,
    arena_g_extent as jax_arena_g_extent,
    conv3x3_packed as jax_packed,
    fit_tiles,
)
from hyperpri_tpu.ops.pallas.conv_train import _PACKED_LS  # noqa: E402
from hyperpri_tpu_torch.models import parts  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import framing  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.probe_element_out import (  # noqa: E402
    element_out,
    element_out_reference,
)

ROOT = Path(__file__).resolve().parents[1]
# float32: sums of up to 9*C products in two orders (as test_ingest/test_arena).
F32 = dict(atol=2e-5, rtol=1e-5)
SUMS = dict(atol=1e-4, rtol=1e-5)
WGRAD = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return np.asarray(t.detach().float().numpy())


def _conv_inputs(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, wk, b


def _ingest_buffer(x, o):
    """The JAX package's host pre-padded buffer for x (test_ingest._spec)."""
    n, h, w, c = x.shape
    th, tw = fit_tiles(h, w, c, o, jnp.float32, jnp.float32, lane_stride=_PACKED_LS)
    hp, wp, cp = -(-h // th) * th + 2, -(-w // tw) * tw + 8, -(-c // 128) * 128
    buf = np.zeros((n, hp, wp, cp), np.float32)
    buf[:, 1:1 + h, 1:1 + w, :c] = x
    return buf


def _arena_buffer(x, eh, ew, fill=np.nan):
    """The JAX package's arena of x (test_arena._embed_arena): logical at
    (8, 8), beyond-logical tiles finite, pad lanes zero, borders `fill`."""
    n, h, w, c = x.shape
    op = -(-c // 8) * 8
    buf = np.full((n, 8 + eh + 8, 8 + ew + 8, op), fill, np.float32)
    buf[:, 8:8 + h, 8:8 + w, :c] = x
    inner = buf[:, 8:8 + eh, 8:8 + ew, :]
    inner[np.isnan(inner)] = 3.25
    buf[:, 8:8 + eh, 8:8 + ew, c:] = 0.0
    return buf


@pytest.mark.parametrize("n,h,w,c,o", [(1, 16, 24, 37, 64), (2, 13, 21, 130, 24),
                                       (1, 9, 11, 238, 64)])
def test_pre_padded_forward_matches_pallas(rng, n, h, w, c, o):
    x, wk, b = _conv_inputs(rng, n, h, w, c, o)
    xp = _ingest_buffer(x, o)
    ref, (s_ref, ss_ref) = jax_packed(
        jnp.asarray(xp), jnp.asarray(wk), jnp.asarray(b), relu=False, with_stats=True,
        lane_stride=64, interpret=True, logical_hw=(h, w), pre_padded=True)
    out, (s, ss) = conv3x3_packed(_t(xp), _t(wk), _t(b), relu=False, with_stats=True,
                                  logical_hw=(h, w), pre_padded=True)
    assert tuple(out.shape) == (n, h, w, o)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), **SUMS)
    np.testing.assert_allclose(_np(ss), np.asarray(ss_ref), **SUMS)
    # the port's own ingest geometry gives the same result
    (hp, wp, cp), (r0, c0), _ = framing.ingest_spec(h, w, c)
    own = np.zeros((n, hp, wp, cp), np.float32)
    own[:, r0:r0 + h, c0:c0 + w, :c] = x
    out2 = conv3x3_packed(_t(own), _t(wk), _t(b), relu=False, logical_hw=(h, w),
                          pre_padded=True)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("n,h,w,c,o", [(1, 16, 24, 37, 64), (2, 13, 21, 130, 24)])
def test_pre_padded_wgrad_matches_pallas(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    g = rng.normal(size=(n, h, w, o)).astype(np.float32)
    xp = _ingest_buffer(x, o)
    ref = jax_wgrad(jnp.asarray(xp), jnp.asarray(g), pre_padded_c=c, interpret=True)
    dw = conv3x3_wgrad(_t(xp), _t(g), pre_padded_c=c)
    assert tuple(dw.shape) == (3, 3, c, o)
    np.testing.assert_allclose(_np(dw), np.asarray(ref), **WGRAD)


@pytest.mark.parametrize("n,h,w,o", [(1, 16, 24, 64), (2, 13, 21, 64), (1, 12, 20, 20)])
def test_arena_out_interior_matches_pallas(rng, n, h, w, o):
    c = 16
    x, wk, b = _conv_inputs(rng, n, h, w, c, o)
    ref, (s_ref, ss_ref) = jax_packed(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                                      relu=False, with_stats=True, lane_stride=64,
                                      interpret=True, arena_out=True)
    out, (s, ss) = conv3x3_packed(_t(x), _t(wk), _t(b), relu=False, with_stats=True,
                                  arena_out=True)
    assert tuple(out.shape) == framing.arena_shape(n, h, w, o)
    np.testing.assert_allclose(_np(out)[:, 8:8 + h, 8:8 + w, :o],
                               np.asarray(ref)[:, 8:8 + h, 8:8 + w, :o], **F32)
    frame = _np(out).copy()
    frame[:, 8:8 + h, 8:8 + w, :o] = 0.0
    assert not frame.any()   # the frame is left as allocated: zeros
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), **SUMS)
    np.testing.assert_allclose(_np(ss), np.asarray(ss_ref), **SUMS)


@pytest.mark.parametrize("n,h,w,c1,o1,o2", [(1, 16, 24, 16, 64, 64), (2, 13, 21, 16, 20, 24)])
def test_arena_in_prologue_matches_pallas(rng, n, h, w, c1, o1, o2):
    """The consumer of a hand-built arena with NaN borders, as the JAX test
    feeds it, against the JAX kernel reading the same buffer."""
    x1 = rng.normal(size=(n, h, w, o1)).astype(np.float32)
    pa = rng.normal(size=(o1,)).astype(np.float32)
    pb = (rng.normal(size=(o1,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, o1, o2)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(o2,)).astype(np.float32)
    eh, ew = jax_arena_extent(h, w, c1, o1, jnp.float32, jnp.float32)
    xa = _arena_buffer(x1, eh, ew)
    ref, (s_ref, ss_ref) = jax_packed(
        jnp.asarray(xa), jnp.asarray(w2), jnp.asarray(b2), jnp.asarray(pa), jnp.asarray(pb),
        relu=False, with_stats=True, lane_stride=64, interpret=True, logical_hw=(h, w),
        arena_in=True)
    out, (s, ss) = conv3x3_packed(_t(xa), _t(w2), _t(b2), _t(pa), _t(pb), relu=False,
                                  with_stats=True, logical_hw=(h, w), arena_in=True)
    assert np.isfinite(_np(out)).all()
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), **SUMS)
    np.testing.assert_allclose(_np(ss), np.asarray(ss_ref), **SUMS)


@pytest.mark.parametrize("n,h,w,o1,o2", [(1, 16, 24, 64, 64), (2, 13, 21, 20, 24)])
def test_arena_in_wgrad_matches_pallas(rng, n, h, w, o1, o2):
    x1 = rng.normal(size=(n, h, w, o1)).astype(np.float32)
    g = rng.normal(size=(n, h, w, o2)).astype(np.float32)
    pa = rng.normal(size=(o1,)).astype(np.float32)
    pb = (rng.normal(size=(o1,)) * 0.1).astype(np.float32)
    eh, ew = jax_arena_extent(h, w, 16, o1, jnp.float32, jnp.float32)
    xa = _arena_buffer(x1, eh, ew)
    ref = jax_wgrad(jnp.asarray(xa), jnp.asarray(g), jnp.asarray(pa), jnp.asarray(pb),
                    arena_in=True, interpret=True)
    out = conv3x3_wgrad(_t(xa), _t(g), _t(pa), _t(pb), arena_in=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **WGRAD)


@pytest.mark.parametrize("n,h,w,c,o", [(1, 16, 24, 64, 64), (2, 13, 21, 64, 24),
                                       (1, 12, 20, 128, 64)])
def test_arena_g_adjoint_and_wgrad_match_pallas(rng, n, h, w, c, o):
    """The statistics conv's arena-g backward: a zero-framed g_eff read by the
    adjoint conv (c = its output width) and by the weight gradient."""
    g = rng.normal(size=(n, h, w, o)).astype(np.float32)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, o, c)) * 0.1).astype(np.float32)
    zero = np.zeros((c,), np.float32)
    ls = 64 if c <= 64 else 128
    eh, ew = jax_arena_g_extent(h, w, o, c, jnp.float32, jnp.float32, lane_stride=ls,
                                affine_bwd=False)
    ga = np.zeros((n, eh + 16, ew + 16, o), np.float32)   # the frame is exact zeros
    ga[:, 8:8 + h, 8:8 + w] = g
    ref = jax_packed(jnp.asarray(ga), jnp.asarray(wt), jnp.asarray(zero), relu=False,
                     lane_stride=ls, interpret=True, logical_hw=(h, w), arena_g=True)
    out = conv3x3_packed(_t(ga), _t(wt), _t(zero), relu=False, logical_hw=(h, w),
                         arena_g=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    dref = jax_wgrad(jnp.asarray(x), jnp.asarray(ga), arena_g=True, logical_hw=(h, w),
                     interpret=True)
    dw = conv3x3_wgrad(_t(x), _t(ga), arena_g=True, logical_hw=(h, w))
    np.testing.assert_allclose(_np(dw), np.asarray(dref)[..., :dw.shape[-1]], **WGRAD)


@pytest.mark.parametrize("n,h,w,o1,o2", [(1, 16, 24, 64, 64), (2, 13, 21, 64, 64)])
@pytest.mark.parametrize("arena_g", [False, True])
def test_arena_bwd_epilogue_matches_pallas(rng, n, h, w, o1, o2, arena_g):
    """The BatchNorm-ReLU boundary's backward epilogue with an arena residual
    (NaN frame) and dx written as an arena of the residual's shape; with
    arena_g the cotangent is a zero-framed arena too."""
    x1 = rng.normal(size=(n, h, w, o1)).astype(np.float32)
    g = rng.normal(size=(n, h, w, o2)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, o2, o1)) * 0.1).astype(np.float32)
    pa = rng.uniform(0.5, 1.5, size=(o1,)).astype(np.float32)
    pb = (rng.normal(size=(o1,)) * 0.5).astype(np.float32)
    zero = np.zeros((o1,), np.float32)
    eh, ew = jax_arena_extent(h, w, 16, o1, jnp.float32, jnp.float32)
    ra = _arena_buffer(x1, eh, ew)
    gin = g
    if arena_g:
        geh, gew = jax_arena_g_extent(h, w, o2, o1, jnp.float32, jnp.float32)
        gin = np.zeros((n, geh + 16, gew + 16, o2), np.float32)
        gin[:, 8:8 + h, 8:8 + w] = g
    kw = dict(logical_hw=(h, w), arena_in=True, arena_out=True, arena_g=arena_g)
    ref, (dpa_ref, dpb_ref) = jax_packed(
        jnp.asarray(gin), jnp.asarray(wt), jnp.asarray(zero), jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(ra), relu=False, lane_stride=64, interpret=True, **kw)
    dx, (dpa, dpb) = conv3x3_packed(_t(gin), _t(wt), _t(zero), _t(pa), _t(pb), _t(ra),
                                    relu=False, **kw)
    assert tuple(dx.shape) == ra.shape
    np.testing.assert_allclose(_np(dx)[:, 8:8 + h, 8:8 + w, :o1],
                               np.asarray(ref)[:, 8:8 + h, 8:8 + w, :o1], **F32)
    np.testing.assert_allclose(_np(dpa), np.asarray(dpa_ref), **SUMS)
    np.testing.assert_allclose(_np(dpb), np.asarray(dpb_ref), **SUMS)


def test_bf16_framed_forward_within_one_ulp(rng):
    """bf16: the plain version on a framed buffer against the Pallas kernel,
    within one bf16 ulp (both round a float32 sum once)."""
    n, h, w, c, o = 1, 13, 21, 37, 24
    x, wk, b = _conv_inputs(rng, n, h, w, c, o)
    xp = _ingest_buffer(x, o)
    ref = jax_packed(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16),
                     jnp.asarray(b), relu=True, lane_stride=64, interpret=True,
                     logical_hw=(h, w), pre_padded=True)
    out = conv3x3_packed(_t(xp).bfloat16(), _t(wk).bfloat16(), _t(b), relu=True,
                         logical_hw=(h, w), pre_padded=True)
    r = np.asarray(ref.astype(jnp.float32))
    o32 = _np(out)
    mag = np.maximum(np.maximum(np.abs(r), np.abs(o32)), 2.0 ** -6)
    assert (np.abs(o32 - r) <= np.exp2(np.floor(np.log2(mag)) - 7)).all()


def test_framing_flags_are_checked(rng):
    x, wk, b = (_t(a) for a in _conv_inputs(rng, 1, 8, 8, 8, 16))
    pa = torch.ones(8)
    with pytest.raises(ValueError, match="pre_padded"):
        conv3x3_packed(x, wk, b, pa, pa, relu=False, pre_padded=True, logical_hw=(6, 6))
    with pytest.raises(ValueError, match="logical_hw"):
        conv3x3_packed(x, wk, b, relu=False, arena_g=True)
    with pytest.raises(ValueError, match="arena_g conflicts"):
        conv3x3_packed(x, wk, b, pa, pa, relu=False, arena_g=True, logical_hw=(8, 8))
    with pytest.raises(ValueError, match="frames the prologue"):
        conv3x3_packed(x, wk, b, arena_in=True, logical_hw=(8, 8))
    with pytest.raises(ValueError, match="cover"):
        conv3x3_packed(x, wk, b, pre_padded=True, logical_hw=(8, 8))
    with pytest.raises(ValueError, match="prologue"):
        conv3x3_wgrad(x, torch.zeros(1, 8, 8, 16), arena_in=True)


def test_launch_counters_count_framings(rng):
    x, wk, b = (_t(a) for a in _conv_inputs(rng, 1, 8, 8, 8, 16))
    counts = conv3x3_packed.calls_by_framing
    before = dict(counts)
    y = conv3x3_packed(x, wk, b, relu=False, with_stats=True, arena_out=True)[0]
    conv3x3_packed(y, torch.zeros(3, 3, 16, 16), b, torch.ones(16), torch.zeros(16),
                   relu=False, with_stats=True, arena_in=True, logical_hw=(8, 8))
    assert counts.get("arena_out", 0) == before.get("arena_out", 0) + 1
    assert counts.get("arena_in", 0) == before.get("arena_in", 0) + 1


@pytest.mark.parametrize("h,w", [(608, 968), (304, 484)])
@pytest.mark.parametrize("c1", [238, 128])
def test_ingest_spec_agrees_with_jax(monkeypatch, h, w, c1):
    """first_conv_ingest_spec agrees with the JAX package's at CubeNET's
    shapes (its route predicate needs a TPU backend, which is stubbed here;
    the shape math is the same)."""
    monkeypatch.setattr(jparts.jax, "default_backend", lambda: "tpu")
    for dtype in (jnp.float32, jnp.bfloat16):
        mine = parts.first_conv_ingest_spec(h, w, c1, 64)
        theirs = jparts.first_conv_ingest_spec(h, w, c1, 64, dtype)
        assert (mine is None) == (theirs is None) is False
        assert mine[1:] == theirs[1:] == ((1, 1), (h, w, c1))
        assert mine[0][2] == theirs[0][2] == (256 if c1 == 238 else 128)
        # the JAX buffer covers the port's logical region at the same origin
        assert theirs[0][0] >= h + 2 and theirs[0][1] >= w + 2
        assert parts.first_conv_ingest_spec(16, 16, c1, 64) is None
        assert jparts.first_conv_ingest_spec(16, 16, c1, 64, dtype) is None


def _probe_pallas(x):
    """The JAX package's element-out probe (scripts/probe_element_out.py) run
    in interpret mode on x, returning its output."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from jax._src.pallas.core import Element

    spec = importlib.util.spec_from_file_location("probe_element_out",
                                                  ROOT / "scripts" / "probe_element_out.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    n, h, w, c = x.shape
    th, tw = 8, 16
    n_h, n_w = -(-h // th), -(-w // tw)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, n_h * th - h), (0, n_w * tw - w), (0, 0)))
    return pl.pallas_call(
        probe._kernel, grid=(n, n_h, n_w),
        in_specs=[pl.BlockSpec((1, th, tw, c), lambda b, i, j: (b, i, j, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(
            (Element(1), Element(th), Element(tw), Element(c)),
            lambda b, i, j: (b, (i * (th // 8) + 1) * 8, (j * (tw // 8) + 1) * 8, 0),
            memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 8 + n_h * th + 8, 8 + n_w * tw + 8, c),
                                       jnp.float32),
        interpret=True)(xp)


@pytest.mark.parametrize("shape", [(1, 16, 24, 128), (2, 13, 21, 5)])
def test_element_out_probe_matches_pallas(rng, shape):
    n, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(_probe_pallas(x))
    y = element_out(_t(x))
    assert tuple(y.shape) == framing.arena_shape(n, h, w, c)
    np.testing.assert_array_equal(_np(y)[:, 8:8 + h, 8:8 + w, :c], ref[:, 8:8 + h, 8:8 + w])
    assert _np(y).sum() == pytest.approx(float((2 * x).sum()), rel=1e-5)   # zero frame
    torch.testing.assert_close(y, element_out_reference(_t(x)), rtol=0, atol=0)
