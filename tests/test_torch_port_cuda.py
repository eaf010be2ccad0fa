"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They import
no JAX, so they also run where only the port's dependencies exist:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from hyperpri_tpu_torch.ops.kernels.conv3x3 import (
    conv3x3_bias_act,
    conv3x3_bias_act_reference,
)
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import (
    conv3x3_wgrad,
    conv3x3_wgrad_reference,
)
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import (
    conv3x3_packed,
    conv3x3_packed_reference,
)
from hyperpri_tpu_torch.ops.kernels.pool_bwd import (
    max_pool_2x2_bwd,
    max_pool_2x2_bwd_reference,
)

# Float32 per-channel sums of the bf16 kernels (statistics, dpa, dpb, dW): the
# kernel and the plain version add the same float32 terms in different orders.
# With K terms of absolute sum A, each order's error is at most about
# K * 2**-24 * A, and far less in practice (the partial sums grow like
# sqrt(K)); the shapes here have K <= 8e3, so 1e-4 * A leaves room.
SUM_REL = 1e-4
# Float32 kernels (3xTF32 products, about 2**-21 relative each, float32
# accumulation in another order than the plain version's): every output and
# every sum within 2e-5 of the sum of the absolute values of its terms, which
# the plain version computes from the absolute values of the inputs. A single
# TF32 product (2**-11) would miss it.
F32_REL = 2e-5
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp_error(out, ref):
    """Max |out - ref| in bf16 ulps of max(|out|, |ref|, 2**-6): the kernel and
    the plain version sum in float32 in different orders and round once; the
    floor covers outputs that cancel below the float32 round-off of the sum."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((o - r).abs() / ulp).max())


def _assert_sums_close(out, ref, scale, rel=SUM_REL):
    """|out - ref| <= rel * scale, elementwise; scale is the sum of the
    absolute terms."""
    err = (out.double() - ref.double()).abs()
    assert bool((err <= rel * scale.double() + 1e-30).all()), float(
        (err / scale.double().clamp_min(1e-30)).max())


def _assert_out_close(out, ref, abs_terms):
    """A conv output against its plain version: one bf16 ulp in bf16; in
    float32 within F32_REL of `abs_terms`, the plain version's output for the
    absolute values of the inputs."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if out.dtype == torch.bfloat16:
        assert _bf16_ulp_error(out, ref) <= 1.0
    else:
        _assert_sums_close(out, ref, abs_terms, F32_REL)


def _conv_inputs(device, shape, o, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(o,))).astype(np.float32))
    return (x.to(device, dtype), w.to(device, dtype), b.to(device), rng)


def _affine(rng, device, channels):
    pa = torch.from_numpy(rng.uniform(0.5, 1.5, size=(channels,)).astype(np.float32))
    pb = torch.from_numpy(rng.normal(0.0, 0.5, size=(channels,)).astype(np.float32))
    return pa.to(device), pb.to(device)


_CONV_KERNELS = {
    "packed": (conv3x3_packed, conv3x3_packed_reference),
    "halo": (conv3x3_bias_act, conv3x3_bias_act_reference),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,relu", [
    ((1, 37, 53, 238), 48, False),   # C=238: 4- or 8-byte loads, ragged H/W tiles
    ((2, 29, 71, 64), 64, True),     # 16-byte loads
    ((1, 17, 33, 61), 128, True),    # odd C: element loads; O=128
])
def test_conv3x3_packed_matches_plain(cuda_device, shape, o, relu, dtype):
    x, w, b, _ = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    launches = conv3x3_packed.launches
    out = conv3x3_packed(x, w, b, relu=relu)
    assert conv3x3_packed.launches == launches + 1
    ref = conv3x3_packed_reference(x, w, b, relu=relu)
    abs_terms = conv3x3_packed_reference(x.abs(), w.abs(), b.abs(), relu=False)
    torch.cuda.synchronize()
    _assert_out_close(out, ref, abs_terms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_conv3x3_packed_rejects_non_bf16(cuda_device, dtype):
    """The kernels take bf16 and float32 activations; any other type raises
    (there is no fallback)."""
    x = torch.zeros((1, 8, 8, 8), device=cuda_device, dtype=dtype)
    with pytest.raises(TypeError, match="bf16 or float32"):
        conv3x3_packed(x, torch.zeros((3, 3, 8, 8), device=cuda_device, dtype=dtype),
                       torch.zeros(8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,shape,o,relu", [
    ("halo", (1, 37, 53, 238), 48, False),
    ("halo", (2, 29, 71, 64), 96, True),
    ("halo", (1, 17, 33, 61), 256, True),
    ("halo", (2, 20, 40, 128), 131, False),  # odd O: element stores, ragged O tile
])
def test_conv3x3_bias_act_matches_plain(cuda_device, kernel, shape, o, relu, dtype):
    fn, ref_fn = _CONV_KERNELS[kernel]
    x, w, b, _ = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    launches = fn.launches
    out = fn(x, w, b, relu=relu)
    assert fn.launches == launches + 1
    ref = ref_fn(x, w, b, relu=relu)
    abs_terms = ref_fn(x.abs(), w.abs(), b.abs(), relu=False)
    torch.cuda.synchronize()
    _assert_out_close(out, ref, abs_terms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("kernel,shape,o", [
    ("packed", (2, 29, 71, 64), 64),
    ("packed", (1, 37, 53, 238), 48),
    ("packed", (1, 17, 33, 61), 128),
    ("halo", (2, 29, 71, 64), 256),
    ("halo", (1, 37, 53, 238), 96),
    ("halo", (1, 17, 33, 61), 131),
])
def test_conv_stats_and_prologue_match_plain(cuda_device, kernel, shape, o, prologue, dtype):
    """with_stats (and the pa/pb prologue): y within one bf16 ulp, the sums
    within SUM_REL of their absolute sums (float32: y and the sums within
    F32_REL of their absolute terms), and the same bits on a second run."""
    fn, ref_fn = _CONV_KERNELS[kernel]
    x, w, b, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    pa, pb = _affine(rng, cuda_device, shape[-1]) if prologue else (None, None)
    y, (s, ss) = fn(x, w, b, pa, pb, relu=False, with_stats=True)
    y2, (s2, ss2) = fn(x, w, b, pa, pb, relu=False, with_stats=True)
    ry, (rs, rss) = ref_fn(x, w, b, pa, pb, relu=False, with_stats=True)
    # relu(pa*x + pb) >= 0 already: the prologue's input stays as it is
    abs_terms = ref_fn(x if prologue else x.abs(), w.abs(), b.abs(), pa, pb, relu=False)
    torch.cuda.synchronize()
    assert s.shape == (o,) and s.dtype == torch.float32
    _assert_out_close(y, ry, abs_terms)
    if dtype == torch.bfloat16:
        yf = ry.float()
        _assert_sums_close(s, rs, yf.abs().sum(dim=(0, 1, 2)))
        _assert_sums_close(ss, rss, (yf * yf).sum(dim=(0, 1, 2)))
    else:
        a = abs_terms.float()
        _assert_sums_close(s, rs, a.sum(dim=(0, 1, 2)), F32_REL)
        _assert_sums_close(ss, rss, (a * a).sum(dim=(0, 1, 2)), F32_REL)
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prologue_border_is_zero(cuda_device, dtype):
    """With x = 0 and pb > 0 every in-image z is relu(pb) and the border must
    still be exact zero: the corner output sums 4 taps, the centre 9."""
    c, o = 16, 8
    x = torch.zeros((1, 8, 8, c), dtype=dtype, device=cuda_device)
    w = torch.ones((3, 3, c, o), dtype=dtype, device=cuda_device)
    b = torch.zeros(o, device=cuda_device)
    pa = torch.ones(c, device=cuda_device)
    pb = torch.full((c,), 0.5, device=cuda_device)
    for fn in (conv3x3_packed, conv3x3_bias_act):
        paths = dict(getattr(fn, "launches_by_path", {}))
        y = fn(x, w, b, pa, pb, relu=False)
        assert float(y[0, 0, 0, 0]) == 4 * c * 0.5
        assert float(y[0, 4, 4, 0]) == 9 * c * 0.5
        assert float(y[0, 0, 4, 0]) == 6 * c * 0.5
        if fn is conv3x3_bias_act:
            # both dtypes take the Hopper kernel (prologue on the landed TMA box)
            assert fn.launches_by_path.get("sm90", 0) == paths.get("sm90", 0) + 1


def _assert_bwd_close(g, wt, zero, pa, pb, r, dx, dpa, dpb, rdx, rdpa, rdpb, logical, **kw):
    """The backward epilogue against its plain version. bf16: dx within one
    ulp, dpa and dpb within SUM_REL of sums of |m*dz|(*|r|) taken from the
    rounded dx. float32: dx, dpa and dpb within F32_REL of their absolute
    terms, m * conv(|g|, |W'|) * pa (times |r| for dpa), from the plain
    version on |g| and |W'|. `logical` slices a framed dx to its logical view."""
    if dx.dtype == torch.bfloat16:
        assert _bf16_ulp_error(dx, rdx) <= 1.0
        mdz = logical(rdx).float().abs() / pa   # |m*dz| up to the bf16 rounding of dx
        _assert_sums_close(dpa, rdpa, (mdz * r.float().abs()).sum(dim=(0, 1, 2)) + 1e-3)
        _assert_sums_close(dpb, rdpb, mdz.sum(dim=(0, 1, 2)) + 1e-3)
        return
    adx = conv3x3_packed_reference(g.abs(), wt.abs(), zero, pa, pb, **kw)[0]
    _assert_sums_close(dx, rdx, adx, F32_REL)
    amdz = logical(adx) / pa
    _assert_sums_close(dpa, rdpa, (amdz * r.abs()).sum(dim=(0, 1, 2)), F32_REL)
    _assert_sums_close(dpb, rdpb, amdz.sum(dim=(0, 1, 2)), F32_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [
    ((2, 29, 71, 64), 64),     # cotangent 64 channels, boundary 64
    ((1, 37, 53, 48), 33),     # odd boundary width: element loads and stores
    ((1, 17, 33, 96), 128),
])
def test_conv3x3_packed_bwd_epilogue_matches_plain(cuda_device, shape, o, dtype):
    g, wt, zero, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    zero = torch.zeros_like(zero)
    pa, pb = _affine(rng, cuda_device, o)
    r = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
        cuda_device, dtype)
    dx, (dpa, dpb) = conv3x3_packed(g, wt, zero, pa, pb, r, relu=False)
    dx2, (dpa2, dpb2) = conv3x3_packed(g, wt, zero, pa, pb, r, relu=False)
    rdx, (rdpa, rdpb) = conv3x3_packed_reference(g, wt, zero, pa, pb, r, relu=False)
    torch.cuda.synchronize()
    _assert_bwd_close(g, wt, zero, pa, pb, r, dx, dpa, dpb, rdx, rdpa, rdpb, lambda t: t,
                      bwd_x=r, relu=False)
    assert torch.equal(dx, dx2) and torch.equal(dpa, dpa2) and torch.equal(dpb, dpb2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("shape,o", [
    ((2, 29, 71, 64), 64),
    ((1, 37, 53, 238), 48),     # ragged C tile, 4- or 8-byte loads
    ((1, 17, 33, 61), 131),     # element loads on both operands
    ((2, 40, 64, 128), 256),
])
def test_conv3x3_wgrad_matches_plain(cuda_device, shape, o, prologue, dtype):
    x, _, _, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    g = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
        cuda_device, dtype)
    pa, pb = _affine(rng, cuda_device, shape[-1]) if prologue else (None, None)
    launches = conv3x3_wgrad.launches
    dw = conv3x3_wgrad(x, g, pa, pb)
    assert conv3x3_wgrad.launches == launches + 1
    dw2 = conv3x3_wgrad(x, g, pa, pb)
    ref = conv3x3_wgrad_reference(x, g, pa, pb)
    scale = conv3x3_wgrad_reference(
        x.abs() if pa is None else x, g.abs(), pa, pb)  # relu(..) >= 0 already
    torch.cuda.synchronize()
    assert dw.shape == (3, 3, shape[-1], o) and dw.dtype == torch.float32
    _assert_sums_close(dw, ref, scale, SUM_REL if dtype == torch.bfloat16 else F32_REL)
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 10, 14, 238), (1, 6, 8, 7),
                                   (1, 64, 64, 128)])
@pytest.mark.parametrize("kind", ["random", "constant", "duplicates", "neg_inf", "nan"])
def test_max_pool_2x2_bwd_matches_plain_exactly(cuda_device, shape, kind, dtype):
    rng = np.random.default_rng(0)
    if kind == "random":
        x = rng.normal(size=shape)
    elif kind == "constant":
        x = np.full(shape, 1.5)
    elif kind == "duplicates":
        x = rng.integers(0, 2, size=shape).astype(np.float64)  # many tied maxima
    elif kind == "neg_inf":
        x = np.where(rng.random(size=shape) < 0.7, -np.inf, rng.normal(size=shape))
    else:   # a window that holds a NaN routes nothing
        x = np.where(rng.random(size=shape) < 0.1, np.nan, rng.normal(size=shape))
    n, h, w, c = shape
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device, dtype)
    g = torch.from_numpy(rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)).to(
        cuda_device, dtype)
    launches = max_pool_2x2_bwd.launches
    dx = max_pool_2x2_bwd(x, g)
    assert max_pool_2x2_bwd.launches == launches + 1
    ref = max_pool_2x2_bwd_reference(x, g)
    torch.cuda.synchronize()
    assert torch.equal(dx, ref)
    # every window routes its cotangent to exactly one element (none with a NaN)
    routed = dx.float().reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))
    has_nan = torch.isnan(x.float()).reshape(n, h // 2, 2, w // 2, 2, c).any(dim=4).any(dim=2)
    assert torch.equal(routed, torch.where(has_nan, torch.zeros_like(routed), g.float()))


def _framed(t, offset):
    """t inside an arena (offset 8) or the pre-padded ingest buffer (offset
    1): NaN frame, zero lanes past C in the logical pixels."""
    from hyperpri_tpu_torch.ops.kernels import framing

    n, h, w, c = t.shape
    if offset == framing.ARENA_OFFSET:
        shape = framing.arena_shape(n, h, w, c)
    else:
        (hp, wp, cp), _, _ = framing.ingest_spec(h, w, c)
        shape = (n, hp, wp, cp)
    buf = torch.full(shape, float("nan"), dtype=t.dtype, device=t.device)
    buf[:, offset:offset + h, offset:offset + w] = 0
    buf[:, offset:offset + h, offset:offset + w, :c] = t
    return buf


_FRAMED_SHAPES = [((1, 37, 53, 238), 48), ((2, 29, 71, 64), 24), ((1, 13, 21, 61), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", _FRAMED_SHAPES)
@pytest.mark.parametrize("mode", ["pre_padded", "pre_padded+arena_out", "arena_out",
                                  "relu+arena_out", "relu+arena_g", "arena_in", "arena_g"])
def test_conv3x3_packed_framings_match_plain(cuda_device, shape, o, mode, dtype):
    """Each framed mode of conv3x3_packed on NaN-framed buffers: within one
    bf16 ulp of the plain version, sums within SUM_REL (float32: outputs and
    sums within F32_REL of their absolute terms), same bits twice."""
    x, w, b, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    h, wd = shape[1], shape[2]
    x_abs = x.abs()
    kw = dict(relu=mode.startswith("relu"), with_stats=not mode.startswith("relu"))
    pa = pb = None
    if "pre_padded" in mode:
        x, x_abs = _framed(x, 1), _framed(x_abs, 1)
        kw.update(pre_padded=True, logical_hw=(h, wd))
    if mode in ("arena_in", "relu+arena_g", "arena_g"):
        x, x_abs = _framed(x, 8), _framed(x_abs, 8)
        kw.update(logical_hw=(h, wd), **{"arena_in" if mode == "arena_in" else "arena_g": True})
    if mode == "arena_in":
        pa, pb = _affine(rng, cuda_device, shape[-1])
        x_abs = x   # relu(pa*x + pb) >= 0 already
    if mode == "arena_g":
        b = torch.zeros_like(b)
    if "arena_out" in mode:
        kw["arena_out"] = True
    out, again = (conv3x3_packed(x, w, b, pa, pb, **kw) for _ in range(2))
    ref = conv3x3_packed_reference(x, w, b, pa, pb, **kw)
    abs_kw = dict(kw, relu=False, with_stats=False)
    abs_terms = conv3x3_packed_reference(x_abs, w.abs(), b.abs(), pa, pb, **abs_kw)
    torch.cuda.synchronize()
    if kw["with_stats"]:
        (out, (s, ss)), (again, (s2, ss2)), (ref, (rs, rss)) = out, again, ref
        logical = ((lambda t: t.float()[:, 8:8 + h, 8:8 + wd, :o]) if "arena_out" in mode
                   else (lambda t: t.float()))
        yf = logical(abs_terms if dtype == torch.float32 else ref)
        rel = F32_REL if dtype == torch.float32 else SUM_REL
        _assert_sums_close(s, rs, yf.abs().sum(dim=(0, 1, 2)), rel)
        _assert_sums_close(ss, rss, (yf * yf).sum(dim=(0, 1, 2)), rel)
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    _assert_out_close(out, ref, abs_terms)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [((2, 29, 71, 64), 64), ((1, 37, 53, 48), 24)])
@pytest.mark.parametrize("arena_g", [False, True])
def test_conv3x3_packed_arena_bwd_epilogue_matches_plain(cuda_device, shape, o, arena_g,
                                                         dtype):
    """The backward epilogue with an arena residual (NaN frame), dx written as
    an arena of the residual's shape; with arena_g the cotangent is framed."""
    g, wt, zero, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    zero = torch.zeros_like(zero)
    pa, pb = _affine(rng, cuda_device, o)
    h, wd = shape[1], shape[2]
    r = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
        cuda_device, dtype)
    ra = _framed(r, 8)
    if arena_g:
        g = _framed(g, 8)
    kw = dict(relu=False, logical_hw=(h, wd), arena_in=True, arena_out=True, arena_g=arena_g)
    dx, (dpa, dpb) = conv3x3_packed(g, wt, zero, pa, pb, ra, **kw)
    rdx, (rdpa, rdpb) = conv3x3_packed_reference(g, wt, zero, pa, pb, ra, **kw)
    torch.cuda.synchronize()
    assert dx.shape == ra.shape and bool(torch.isfinite(dx).all())
    _assert_bwd_close(g, wt, zero, pa, pb, r, dx, dpa, dpb, rdx, rdpa, rdpb,
                      lambda t: t[:, 8:8 + h, 8:8 + wd, :o], bwd_x=ra, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [((1, 37, 53, 238), 48), ((2, 29, 71, 64), 64),
                                     ((1, 13, 21, 61), 24)])
@pytest.mark.parametrize("mode", ["pre_padded", "arena_g", "arena_in", "arena_in+arena_g"])
def test_conv3x3_wgrad_framings_match_plain(cuda_device, shape, o, mode, dtype):
    x, _, _, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    g = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
        cuda_device, dtype)
    h, wd, c = shape[1], shape[2], shape[3]
    pa = pb = None
    kw = {}
    if mode == "pre_padded":
        x = _framed(x, 1)
        kw["pre_padded_c"] = c
    if "arena_in" in mode:
        pa, pb = _affine(rng, cuda_device, c)
        x = _framed(x, 8)
        kw["arena_in"] = True
    if "arena_g" in mode:
        g = _framed(g, 8)
        kw.update(arena_g=True, logical_hw=(h, wd))
    dw, dw2 = (conv3x3_wgrad(x, g, pa, pb, **kw) for _ in range(2))
    ref = conv3x3_wgrad_reference(x, g, pa, pb, **kw)
    scale = conv3x3_wgrad_reference(x.abs() if pa is None else x, g.abs(), pa, pb, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dw).all()) and torch.equal(dw, dw2)
    _assert_sums_close(dw, ref, scale, SUM_REL if dtype == torch.bfloat16 else F32_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 96, 64), (1, 13, 21, 5)])
def test_element_out_probe_matches_plain_exactly(cuda_device, shape):
    from hyperpri_tpu_torch.ops.kernels.probe_element_out import (
        element_out, element_out_reference)

    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(
        cuda_device)
    launches = element_out.launches
    y = element_out(x)
    assert element_out.launches == launches + 1
    assert torch.equal(y, element_out_reference(x))


def _fold_operands(rng, device, shape, o, dtype):
    """gy, y (N, H, W, O) of the activations' dtype and the statistics'
    cotangents gsum, gsumsq (O,) float32."""
    n, h, w, _ = shape
    gy, y = (torch.from_numpy(rng.normal(size=(n, h, w, o)).astype(np.float32)).to(device, dtype)
             for _ in range(2))
    gs = torch.from_numpy(rng.normal(size=(o,)).astype(np.float32)).to(device)
    gss = torch.from_numpy((0.1 * rng.normal(size=(o,))).astype(np.float32)).to(device)
    return gy, y, gs, gss


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [((1, 37, 53, 238), 48), ((2, 29, 71, 64), 64),
                                     ((1, 17, 33, 61), 131), ((1, 13, 21, 61), 24),
                                     ((1, 17, 33, 72), 136), ((2, 9, 35, 128), 40)])
@pytest.mark.parametrize("mode", ["unframed", "prologue", "pre_padded", "arena_g",
                                  "arena_in+arena_g"])
def test_conv3x3_wgrad_fold_matches_plain(cuda_device, shape, o, mode, dtype):
    """Fold mode (g_eff and db formed in the kernel from the raw gy and y) on
    NaN-framed buffers, on the body its plan names ("sm90" wherever TMA can
    address x, g and y; the last two shapes' pixel tiles, C tiles and O
    tiles overhang every edge): dW and db within the sums' limit of their
    absolute terms, the same bits twice, and dW bit-equal to the non-fold
    kernel on the same body on the materialized g_eff (framed alike; a
    non-fold arena_g call's O is the arena's channel width, whose columns
    past the fold's O are the zero lanes' and not compared). Where
    the plan takes the Hopper body, the synchronous fold (`_legacy=True`)
    too: within the limit, and its dW bit-equal to the synchronous non-fold
    kernel's."""
    from hyperpri_tpu_torch.ops.kernels import _plain
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import call_plan

    x, _, _, rng = _conv_inputs(cuda_device, shape, o, dtype=dtype)
    gy, y, gs, gss = _fold_operands(rng, cuda_device, shape, o, dtype)
    h, wd, c = shape[1], shape[2], shape[3]
    pa = pb = None
    kw = {}
    xk, gk, yk = x, gy, y
    g_eff = _plain.fold_stats_cotangent(gy, gs, gss, y, dtype)
    g_effk = g_eff
    if mode in ("prologue", "arena_in+arena_g"):
        pa, pb = _affine(rng, cuda_device, c)
    if mode == "pre_padded":
        xk = _framed(x, 1)
        kw["pre_padded_c"] = c
    if "arena_in" in mode:
        xk = _framed(x, 8)
        kw["arena_in"] = True
    if "arena_g" in mode:
        gk, yk, g_effk = _framed(gy, 8), _framed(y, 8), _framed(g_eff, 8)
        kw.update(arena_g=True, logical_hw=(h, wd))
    fold_kw = dict(kw, y=yk, gsum=gs, gsumsq=gss)
    body = call_plan(xk, gk, pa, **fold_kw).path
    tma = all(p * x.element_size() % 16 == 0 for p in (xk.shape[-1], gk.shape[-1]))
    assert body == ("sm90" if tma else "legacy")
    launches = conv3x3_wgrad.launches_by_mode.get("fold", 0)
    by_path = dict(conv3x3_wgrad.launches_by_path)
    (dw, db), (dw2, db2) = (conv3x3_wgrad(xk, gk, pa, pb, **fold_kw) for _ in range(2))
    assert conv3x3_wgrad.launches_by_mode["fold"] == launches + 2
    assert conv3x3_wgrad.launches_by_path[body] == by_path.get(body, 0) + 2
    rdw, rdb = conv3x3_wgrad_reference(xk, gk, pa, pb, **fold_kw)
    z = _plain.prologue_act(x, pa, pb)
    scale = conv3x3_wgrad_reference(z.abs(), g_eff.abs())
    db_scale = g_eff.float().abs().sum(dim=(0, 1, 2))
    materialized = conv3x3_wgrad(xk, g_effk, pa, pb, _legacy=body == "legacy", **kw)
    torch.cuda.synchronize()
    rel = SUM_REL if dtype == torch.bfloat16 else F32_REL
    assert dw.shape == (3, 3, c, o) and db.shape == (o,)
    assert bool(torch.isfinite(dw).all()) and bool(torch.isfinite(db).all())
    _assert_sums_close(dw, rdw, scale, rel)
    _assert_sums_close(db, rdb, db_scale, rel)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(dw, materialized[..., :o])
    if body == "sm90":
        sdw, sdb = conv3x3_wgrad(xk, gk, pa, pb, _legacy=True, **fold_kw)
        sync = conv3x3_wgrad(xk, g_effk, pa, pb, _legacy=True, **kw)
        torch.cuda.synchronize()
        _assert_sums_close(sdw, rdw, scale, rel)
        _assert_sums_close(sdb, rdb, db_scale, rel)
        assert torch.equal(sdw, sync[..., :o])


# conv3x3_bias_act_shift: ragged shapes (C = 238 in bf16 and C = 61 take the
# synchronous body, "legacy"), every distinct kernel-2 call shape of a
# training step (bf16 product loop, float32 UNET and CubeNET-64: the same
# shapes), and the overhang shapes where the band box, the pixel tile and the
# O tile overhang every edge; in every (x, out) dtype pair, ReLU on and off.
_SHIFT_CASES = [((1, 37, 53, 238), 48), ((2, 29, 71, 64), 64), ((1, 17, 33, 61), 131),
                ((2, 29, 71, 64), 256),
                ((2, 304, 484, 64), 128), ((2, 304, 484, 128), 128), ((2, 304, 484, 256), 128),
                ((2, 304, 484, 128), 256), ((2, 152, 242, 128), 256), ((2, 152, 242, 256), 256),
                ((1, 13, 37, 64), 128), ((1, 13, 37, 128), 256)]
_SHIFT_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                 (torch.float32, torch.float32)]


def _shift_case(device, shape, o, dtypes):
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import call_plan

    x, w, b, _ = _conv_inputs(device, shape, o, dtype=dtypes[0])
    return x, w, b, call_plan(x, w.contiguous()).path


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _SHIFT_DTYPES, ids=["bf16", "bf16-f32", "f32"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,o", _SHIFT_CASES)
def test_conv3x3_bias_act_shift_matches_plain(cuda_device, shape, o, relu, dtypes):
    """The body the plan names, against the plain version; twice with
    identical bits."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import (
        conv3x3_bias_act_shift,
        conv3x3_bias_act_shift_reference,
    )

    x, w, b, body = _shift_case(cuda_device, shape, o, dtypes)
    # 476- and 122-byte bf16 pixels, 952- and 244-byte float32 ones
    assert body == ("legacy" if shape[-1] in (238, 61) else "sm90")
    kw = dict(relu=relu, out_dtype=dtypes[1])
    launches = conv3x3_bias_act_shift.launches
    before = dict(conv3x3_bias_act_shift.launches_by_path)
    out, again = (conv3x3_bias_act_shift(x, w, b, **kw) for _ in range(2))
    assert conv3x3_bias_act_shift.launches == launches + 2
    assert _path_delta(conv3x3_bias_act_shift, before) == {body: 2}
    ref = conv3x3_bias_act_shift_reference(x, w, b, **kw)
    terms = conv3x3_bias_act_shift_reference(x.abs(), w.abs(), b.abs(), relu=False,
                                             out_dtype=dtypes[1])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    _assert_out_close(out, ref, terms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _SHIFT_DTYPES, ids=["bf16", "bf16-f32", "f32"])
@pytest.mark.parametrize("shape,o", [case for case in _SHIFT_CASES if case[0][-1] % 8 == 0])
def test_sm90_shift_matches_the_synchronous_body(cuda_device, shape, o, dtypes):
    """The Hopper body against the synchronous one (`_legacy=True`) on the
    same inputs: bf16 outputs within one bf16 ulp of each other, float32
    ones within F32_REL of the sum of their absolute terms."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import (
        conv3x3_bias_act_shift,
        conv3x3_bias_act_shift_reference,
    )

    x, w, b, body = _shift_case(cuda_device, shape, o, dtypes)
    assert body == "sm90"
    before = dict(conv3x3_bias_act_shift.launches_by_path)
    out = conv3x3_bias_act_shift(x, w, b, relu=False, out_dtype=dtypes[1])
    sync = conv3x3_bias_act_shift(x, w, b, relu=False, out_dtype=dtypes[1], _legacy=True)
    assert _path_delta(conv3x3_bias_act_shift, before) == {"sm90": 1, "legacy": 1}
    terms = conv3x3_bias_act_shift_reference(x.abs(), w.abs(), b.abs(), relu=False,
                                             out_dtype=dtypes[1])
    torch.cuda.synchronize()
    _assert_out_close(out, sync, terms)


@pytest.mark.cuda
def test_conv3x3_bias_act_shift_float32_out_from_bf16(cuda_device):
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import (
        conv3x3_bias_act_shift,
        conv3x3_bias_act_shift_reference,
    )

    x, w, b, _ = _conv_inputs(cuda_device, (1, 17, 33, 64), 96)
    out = conv3x3_bias_act_shift(x, w, b, out_dtype=torch.float32)
    ref = conv3x3_bias_act_shift_reference(x, w, b, out_dtype=torch.float32)
    terms = conv3x3_bias_act_shift_reference(x.abs(), w.abs(), b.abs(), relu=False,
                                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    _assert_sums_close(out, ref, terms, F32_REL)


@pytest.mark.cuda
def test_shift_legacy_layouts(cuda_device):
    """Layouts TMA cannot address take the synchronous body, chosen before the
    launch: C = 238 bf16 (476-byte pixels), C = 61 in both dtypes, and O = 20
    in bf16 (40-byte weight rows)."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import conv3x3_bias_act_shift

    for dtype, c, o in ((torch.bfloat16, 238, 64), (torch.bfloat16, 61, 64),
                        (torch.float32, 61, 64), (torch.bfloat16, 64, 20)):
        x, w, b, _ = _conv_inputs(cuda_device, (1, 13, 37, c), o, dtype=dtype)
        before = dict(conv3x3_bias_act_shift.launches_by_path)
        conv3x3_bias_act_shift(x, w, b)
        assert _path_delta(conv3x3_bias_act_shift, before) == {"legacy": 1}


def _dh_fold_case(device, kernel, size):
    """(wrapper, args, plain output) of one dh-fold probe kernel on the
    probe's inputs: "small" 1x66x264 buffers, or "probe" 2x610x1032."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    n, h, w = (1, 64, 200) if size == "small" else (2, 608, 968)
    (cur, a_cur), (fold, a_fold) = probe_dh_fold.build(n=n, h=h, w=w, device=device)
    if kernel == "current":
        return cur, a_cur, probe_dh_fold.current_reference(*a_cur)
    return fold, a_fold, probe_dh_fold.folded_reference(*a_fold)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "probe"])
@pytest.mark.parametrize("kernel", ["current", "folded"])
def test_dh_fold_probe_matches_plain(cuda_device, kernel, size):
    """The Hopper body (the plan's, for aligned operands) within one bf16 ulp
    of the plain version, twice with the same bits."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    fn, args, ref = _dh_fold_case(cuda_device, kernel, size)
    assert probe_dh_fold.call_plan(*args).path == "sm90"
    launches, before = fn.launches, dict(fn.launches_by_path)
    out = fn(*args)
    again = fn(*args)
    assert fn.launches == launches + 2 and _path_delta(fn, before) == {"sm90": 2}
    torch.cuda.synchronize()
    n, hp, wp, _ = args[0].shape
    assert out.shape == (n, hp - 2, wp - 8, 64) and bool(torch.isfinite(out.float()).all())
    assert _bf16_ulp_error(out, ref) <= 1.0
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "probe"])
@pytest.mark.parametrize("kernel", ["current", "folded"])
def test_dh_fold_probe_matches_the_synchronous_body(cuda_device, kernel, size):
    """The Hopper body within one bf16 ulp of the synchronous body
    (`_legacy=True`) on the same inputs, and each body counted as such."""
    fn, args, _ = _dh_fold_case(cuda_device, kernel, size)
    before = dict(fn.launches_by_path)
    out = fn(*args)
    legacy = fn(*args, _legacy=True)
    assert _path_delta(fn, before) == {"sm90": 1, "legacy": 1}
    torch.cuda.synchronize()
    assert _bf16_ulp_error(out, legacy) <= 1.0


@pytest.mark.cuda
def test_dh_fold_probe_unaligned_weights_take_the_synchronous_body(cuda_device):
    """Weights whose data pointer is 2 bytes off a 16-byte boundary cannot be
    read in place by TMA: the plan sends the call to the synchronous body,
    which packs them. An unaligned x, which both bodies read in 16-byte
    units, is refused before any launch."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    fn, (x64, w01, w2), ref = _dh_fold_case(cuda_device, "folded", "small")

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(t.shape)
        return out.copy_(t)

    w01_off = shifted(w01)
    assert probe_dh_fold.call_plan(x64, w01_off, w2).path == "legacy"
    before = dict(fn.launches_by_path)
    out = fn(x64, w01_off, w2)
    assert _path_delta(fn, before) == {"legacy": 1}
    torch.cuda.synchronize()
    assert _bf16_ulp_error(out, ref) <= 1.0
    launches = fn.launches
    with pytest.raises(ValueError, match="aligned"):
        fn(shifted(x64), w01, w2)
    assert fn.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["roll_axis0", "roll_axis1", "repeat_axis0", "repeat_axis1",
                                  "neg_inf_where", "stride2_axis0", "stack_reshape_axis0",
                                  "bcast_reshape_axis1"])
def test_mosaic_op_probe_matches_plain_exactly(cuda_device, name):
    from hyperpri_tpu_torch.ops.kernels import probe_mosaic_ops

    x = probe_mosaic_ops.probe_input(cuda_device)
    launches = probe_mosaic_ops.run_case.launches
    out = probe_mosaic_ops.run_case(name, x)
    assert probe_mosaic_ops.run_case.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(out, probe_mosaic_ops.run_case_reference(name, x))


# The Hopper kernels ("sm90": TMA staging, wgmma) of conv3x3_bias_act and
# conv3x3_wgrad in bf16, at the limits of PERF.md section 2: outputs within
# one bf16 ulp; the sums and dW within SM90_SUM_REL of the sum of the absolute
# values of their terms; every reducing call twice with identical bits.
SM90_SUM_REL = 2e-5
# Every distinct bf16 call of a training step (CubeNET-64 and UNET make the
# same ones; batch 2), then ragged small ones where the TMA box and the pixel
# tile overhang every edge.
_SM90_BIAS_ACT = [
    ((2, 304, 484, 64), 128, "stats"),
    ((2, 304, 484, 128), 128, "stats+prologue"),
    ((2, 304, 484, 256), 128, "stats"),
    ((2, 152, 242, 128), 256, "stats"),
    ((2, 152, 242, 256), 256, "stats+prologue"),
    ((2, 304, 484, 128), 128, "adjoint"),
    ((2, 304, 484, 128), 256, "adjoint"),
    ((2, 152, 242, 256), 256, "adjoint"),
] + [((1, 13, 37, c), o, mode) for c, o in ((64, 128), (128, 256))
     for mode in ("relu", "stats", "stats+prologue")]
_SM90_WGRAD = [
    ((2, 608, 968, 238), 64, "pre_padded"),
    ((2, 608, 968, 64), 64, "prologue"),
    ((2, 304, 484, 64), 128, "plain"),
    ((2, 304, 484, 128), 128, "prologue"),
    ((2, 152, 242, 128), 256, "plain"),
    ((2, 152, 242, 256), 256, "prologue"),
    ((2, 304, 484, 256), 128, "plain"),
    ((2, 608, 968, 128), 64, "plain"),
] + [((1, 13, 37, c), o, mode) for c, o in ((64, 128), (128, 256))
     for mode in ("plain", "prologue", "pre_padded", "arena_in", "arena_g", "arena_in+arena_g")]


def _path_delta(fn, before):
    return {k: v - before.get(k, 0) for k, v in fn.launches_by_path.items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", _SM90_BIAS_ACT)
def test_sm90_bias_act_matches_plain(cuda_device, shape, o, mode):
    x, w, b, rng = _conv_inputs(cuda_device, shape, o)
    pa, pb = _affine(rng, cuda_device, shape[-1]) if "prologue" in mode else (None, None)
    if mode == "adjoint":
        b = torch.zeros_like(b)
    kw = dict(relu=mode == "relu", with_stats=mode.startswith("stats"))
    before = dict(conv3x3_bias_act.launches_by_path)
    out, again = (conv3x3_bias_act(x, w, b, pa, pb, **kw) for _ in range(2))
    assert _path_delta(conv3x3_bias_act, before) == {"sm90": 2}
    ref = conv3x3_bias_act_reference(x, w, b, pa, pb, **kw)
    torch.cuda.synchronize()
    if kw["with_stats"]:
        (out, (s, ss)), (again, (s2, ss2)), (ref, (rs, rss)) = out, again, ref
        yf = ref.float()
        _assert_sums_close(s, rs, yf.abs().sum(dim=(0, 1, 2)), SM90_SUM_REL)
        _assert_sums_close(ss, rss, (yf * yf).sum(dim=(0, 1, 2)), SM90_SUM_REL)
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
    assert bool(torch.isfinite(out).all())
    _assert_out_close(out, ref, None)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", _SM90_WGRAD)
def test_sm90_wgrad_matches_plain(cuda_device, shape, o, mode):
    """Framed views sit in buffers whose frames hold NaN: TMA reads only the
    logical regions."""
    x, _, _, rng = _conv_inputs(cuda_device, shape, o)
    g = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    h, wd, c = shape[1], shape[2], shape[3]
    pa = pb = None
    kw = {}
    if "prologue" in mode or "arena_in" in mode:
        pa, pb = _affine(rng, cuda_device, c)
    if mode == "pre_padded":
        x = _framed(x, 1)
        kw["pre_padded_c"] = c
    if "arena_in" in mode:
        x = _framed(x, 8)
        kw["arena_in"] = True
    if "arena_g" in mode:
        g = _framed(g, 8)
        kw.update(arena_g=True, logical_hw=(h, wd))
    before = dict(conv3x3_wgrad.launches_by_path)
    dw, dw2 = (conv3x3_wgrad(x, g, pa, pb, **kw) for _ in range(2))
    assert _path_delta(conv3x3_wgrad, before) == {"sm90": 2}
    ref = conv3x3_wgrad_reference(x, g, pa, pb, **kw)
    scale = conv3x3_wgrad_reference(x.abs() if pa is None else x, g.abs(), pa, pb, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dw).all()) and torch.equal(dw, dw2)
    _assert_sums_close(dw, ref, scale, SM90_SUM_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bias_act", "wgrad", "packed"])
def test_legacy_body_takes_float32_and_untma_layouts(cuda_device, kernel):
    """Views TMA cannot address take the synchronous kernel, chosen before
    the launch: C = 238 unframed, 476-byte bf16 and 952-byte float32 pixels;
    and for conv3x3_packed also C = 61 in float32 (244-byte pixels)."""
    fn = {"bias_act": conv3x3_bias_act, "wgrad": conv3x3_wgrad, "packed": conv3x3_packed}[kernel]
    cases = [(torch.float32, 238), (torch.bfloat16, 238)]
    for dtype, c in cases + ([(torch.float32, 61)] if kernel == "packed" else []):
        x, w, b, rng = _conv_inputs(cuda_device, (1, 13, 37, c), 64, dtype=dtype)
        before = dict(fn.launches_by_path)
        if kernel == "wgrad":
            fn(x, torch.ones((1, 13, 37, 64), dtype=dtype, device=cuda_device))
        else:
            fn(x, w, b, relu=False)
        assert _path_delta(fn, before) == {"legacy": 1}


# The float32 Hopper bodies (3xTF32 on wgmma, TMA rings) of conv3x3_bias_act
# and conv3x3_wgrad at the same calls, every mode and framing (framed views
# on NaN frames): outputs, sums and dW within F32_REL of the sum of the
# absolute values of their terms, against the plain version and against the
# synchronous body (`_legacy=True`); every call twice with identical bits.

def _f32_conv_case(device, shape, o, mode):
    x, w, b, rng = _conv_inputs(device, shape, o, dtype=torch.float32)
    pa, pb = _affine(rng, device, shape[-1]) if "prologue" in mode else (None, None)
    if mode == "adjoint":
        b = torch.zeros_like(b)
    return (x, w, b, pa, pb), dict(relu=mode == "relu", with_stats=mode.startswith("stats"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", _SM90_BIAS_ACT)
def test_sm90_f32_bias_act_matches_plain(cuda_device, shape, o, mode):
    args, kw = _f32_conv_case(cuda_device, shape, o, mode)
    x, w, b, pa, pb = args
    before = dict(conv3x3_bias_act.launches_by_path)
    out, again = (conv3x3_bias_act(*args, **kw) for _ in range(2))
    assert _path_delta(conv3x3_bias_act, before) == {"sm90": 2}
    ref = conv3x3_bias_act_reference(*args, **kw)
    terms = conv3x3_bias_act_reference(x if pa is not None else x.abs(), w.abs(), b.abs(), pa,
                                       pb, relu=False)
    torch.cuda.synchronize()
    if kw["with_stats"]:
        (out, (s, ss)), (again, (s2, ss2)), (ref, (rs, rss)) = out, again, ref
        _assert_sums_close(s, rs, terms.abs().sum(dim=(0, 1, 2)), F32_REL)
        _assert_sums_close(ss, rss, (terms * terms).sum(dim=(0, 1, 2)), F32_REL)
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    _assert_out_close(out, ref, terms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", _SM90_BIAS_ACT)
def test_sm90_f32_bias_act_matches_the_synchronous_body(cuda_device, shape, o, mode):
    args, kw = _f32_conv_case(cuda_device, shape, o, mode)
    x, w, b, pa, pb = args
    before = dict(conv3x3_bias_act.launches_by_path)
    out = conv3x3_bias_act(*args, **kw)
    sync = conv3x3_bias_act(*args, _legacy=True, **kw)
    assert _path_delta(conv3x3_bias_act, before) == {"sm90": 1, "legacy": 1}
    terms = conv3x3_bias_act_reference(x if pa is not None else x.abs(), w.abs(), b.abs(), pa,
                                       pb, relu=False)
    torch.cuda.synchronize()
    if kw["with_stats"]:
        (out, sums), (sync, sync_sums) = out, sync
        scales = (terms.abs().sum(dim=(0, 1, 2)), (terms * terms).sum(dim=(0, 1, 2)))
        for a, b2, scale in zip(sums, sync_sums, scales):
            _assert_sums_close(a, b2, scale, F32_REL)
    _assert_sums_close(out, sync, terms, F32_REL)


def _f32_wgrad_case(device, shape, o, mode):
    """Arguments, keywords and the logical x of one float32 weight gradient;
    framed operands sit on NaN frames."""
    x, _, _, rng = _conv_inputs(device, shape, o, dtype=torch.float32)
    g = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(device)
    h, wd, c = shape[1], shape[2], shape[3]
    pa = pb = None
    kw = {}
    if "prologue" in mode or "arena_in" in mode:
        pa, pb = _affine(rng, device, c)
    xk = x
    if mode == "pre_padded":
        xk = _framed(x, 1)
        kw["pre_padded_c"] = c
    if "arena_in" in mode:
        xk = _framed(x, 8)
        kw["arena_in"] = True
    if "arena_g" in mode:
        g = _framed(g, 8)
        kw.update(arena_g=True, logical_hw=(h, wd))
    return (xk, g, pa, pb), kw, x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", _SM90_WGRAD)
def test_sm90_f32_wgrad_matches_plain(cuda_device, shape, o, mode):
    args, kw, x = _f32_wgrad_case(cuda_device, shape, o, mode)
    xk, g, pa, pb = args
    before = dict(conv3x3_wgrad.launches_by_path)
    dw, dw2 = (conv3x3_wgrad(*args, **kw) for _ in range(2))
    sync = conv3x3_wgrad(*args, _legacy=True, **kw)
    assert _path_delta(conv3x3_wgrad, before) == {"sm90": 2, "legacy": 1}
    ref = conv3x3_wgrad_reference(*args, **kw)
    scale = conv3x3_wgrad_reference(xk.abs() if pa is None else xk, g.abs(), pa, pb, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dw).all()) and torch.equal(dw, dw2)
    _assert_sums_close(dw, ref, scale, F32_REL)
    _assert_sums_close(dw, sync, scale, F32_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode", [
    ((2, 608, 968, 64), 64, "prologue"), ((2, 304, 484, 64), 128, "plain"),
    ((2, 304, 484, 128), 128, "prologue"), ((2, 152, 242, 128), 256, "plain"),
    ((2, 152, 242, 256), 256, "prologue"), ((2, 304, 484, 256), 128, "plain"),
    ((2, 608, 968, 128), 64, "plain"), ((2, 608, 968, 238), 64, "pre_padded")])
def test_sm90_f32_wgrad_one_signed_terms(cuda_device, shape, o, mode):
    """Every float32 weight gradient of the UNET and CubeNET-64 steps on a
    cotangent with a per-channel offset (one-signed terms, where float32
    rounding along the accumulator chains shows): both bodies within F32_REL
    of a float64 dW."""
    args, kw, x = _f32_wgrad_case(cuda_device, shape, o, mode)
    xk, g, pa, pb = args
    offset = torch.from_numpy(np.random.default_rng(1).normal(size=(o,)).astype(np.float32))
    g = g + offset.to(cuda_device)
    z = (torch.relu(x * pa + pb) if pa is not None else x).double()
    zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
    g2 = g.double().reshape(-1, o)
    h, w, c = shape[1], shape[2], shape[3]
    taps = [zp[:, dh:dh + h, dw:dw + w, :].reshape(-1, c).t() for dh in range(3) for dw in range(3)]
    exact = torch.stack([t @ g2 for t in taps]).reshape(3, 3, c, o)
    scale = torch.stack([t.abs() @ g2.abs() for t in taps]).reshape(3, 3, c, o)
    before = dict(conv3x3_wgrad.launches_by_path)
    dw = conv3x3_wgrad(xk, g, pa, pb, **kw)
    dw_sync = conv3x3_wgrad(xk, g, pa, pb, _legacy=True, **kw)
    assert _path_delta(conv3x3_wgrad, before) == {"sm90": 1, "legacy": 1}
    torch.cuda.synchronize()
    _assert_sums_close(dw, exact, scale, F32_REL)
    _assert_sums_close(dw_sync, exact, scale, F32_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o,pitch", [(64, 128, None), (256, 256, None), (5, 12, None),
                                       (61, 24, 64), (238, 64, 256), (64, 128, 64)])
def test_split_weights_tf32_matches_plain_exactly(cuda_device, c, o, pitch):
    """The float32 Hopper convs' weight split on the card, bit for bit its
    plain version: conv3x3_bias_act's with the pitch C (None) and
    conv3x3_packed's with whole 32-channel chunks, zero from C to the
    pitch."""
    from hyperpri_tpu_torch.ops.kernels import _plain
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import split_weights_tf32

    _, w, _, _ = _conv_inputs(cuda_device, (1, 1, 1, c), o, dtype=torch.float32)
    planes = split_weights_tf32(w, pitch)
    torch.cuda.synchronize()
    assert torch.equal(planes, _plain.split_weights_tf32_reference(w, pitch))
    assert not bool(planes[..., c:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o", [
    ((2, 608, 968, 64), 64), ((2, 608, 968, 128), 64), ((2, 304, 484, 64), 128),
    ((2, 304, 484, 128), 128), ((2, 304, 484, 256), 128), ((2, 152, 242, 128), 256),
    ((2, 152, 242, 256), 256)])
def test_sm90_wgrad_one_signed_terms(cuda_device, shape, o):
    """A training step's cotangent of a statistics conv carries a
    per-channel offset, and after the prologue z >= 0: dW sums a million
    terms of one sign, where float32 rounding along a block's accumulator
    chain shows. Both kernel bodies within SM90_SUM_REL of a float64 dW."""
    x, _, _, rng = _conv_inputs(cuda_device, shape, o)
    pa, pb = _affine(rng, cuda_device, shape[-1])
    offset = torch.from_numpy(rng.normal(size=(o,)).astype(np.float32)).to(cuda_device)
    g = (torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(cuda_device)
         + offset).to(torch.bfloat16)
    z = torch.relu(x.float() * pa + pb).to(torch.bfloat16).double()
    zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
    g2 = g.double().reshape(-1, o)
    h, w, c = shape[1], shape[2], shape[3]
    taps = [zp[:, dh:dh + h, dw:dw + w, :].reshape(-1, c).t() for dh in range(3) for dw in range(3)]
    exact = torch.stack([t @ g2 for t in taps]).reshape(3, 3, c, o)
    scale = torch.stack([t.abs() @ g2.abs() for t in taps]).reshape(3, 3, c, o)
    before = dict(conv3x3_wgrad.launches_by_path)
    dw = conv3x3_wgrad(x, g, pa, pb)
    dw_sync = conv3x3_wgrad(x, g, pa, pb, _legacy=True)
    assert _path_delta(conv3x3_wgrad, before) == {"sm90": 1, "legacy": 1}
    torch.cuda.synchronize()
    _assert_sums_close(dw, exact, scale, SM90_SUM_REL)
    _assert_sums_close(dw_sync, exact, scale, SM90_SUM_REL)


# The Hopper body of conv3x3_packed (kernel 1), at the bf16 step's calls cut
# to 24 rows (608x968 -> 24x968: the persistent walk, both unit heights and
# ragged units at the bottom edge) and 152x242 -> 19x242: every mode in every
# framing it takes, at 64 outputs (resident weights for C = 64, streamed with
# two-tile units for C = 128 and the ingest conv's C = 238) and at 128 (NP =
# 128, streamed). Framed buffers hold NaN in their frames.
_SM90_PACKED = [
    ((2, 24, 968, 64), 64, mode, framing)
    for mode, framing in (
        ("relu", ()), ("stats", ()), ("prologue", ()), ("bwd_x", ()), ("relu", ("arena_out",)),
        ("stats", ("arena_out",)), ("prologue", ("arena_in",)),
        ("prologue", ("arena_in", "arena_out")), ("relu", ("arena_g",)),
        ("stats", ("arena_g",)), ("bwd_x", ("arena_in",)), ("bwd_x", ("arena_in", "arena_out")),
        ("bwd_x", ("arena_in", "arena_out", "arena_g")), ("bwd_x", ("arena_g",)))
] + [
    ((2, 24, 968, 128), 64, mode, framing)
    for mode, framing in (("relu", ()), ("stats", ()), ("prologue", ()), ("bwd_x", ()),
                          ("stats", ("arena_out",)), ("prologue", ("arena_in",)),
                          ("stats", ("arena_g",)))
] + [
    ((2, 24, 968, 238), 64, mode, framing)
    for mode, framing in (("stats", ("pre_padded",)), ("relu", ("pre_padded",)),
                          ("stats", ("pre_padded", "arena_out")))
] + [
    ((2, 24, 968, 64), 128, mode, framing)
    for mode, framing in (("adjoint", ()), ("relu", ()), ("prologue", ()), ("bwd_x", ()),
                          ("adjoint", ("arena_g",)), ("bwd_x", ("arena_in", "arena_out")))
] + [
    ((2, 19, 242, 256), 128, mode, framing)
    for mode, framing in (("adjoint", ()), ("stats", ("arena_out",)),
                          ("prologue", ("arena_in",)), ("relu", ("arena_g",)))
]


def _packed_case(device, shape, o, mode, framing, seed=0, dtype=torch.bfloat16):
    """Arguments and keywords of one conv3x3_packed call on seeded inputs of
    `dtype`: (x, w, b, pa, pb, r) with x, r framed as `framing` says, the
    logical x and r, and the kwargs."""
    x, w, b, rng = _conv_inputs(device, shape, o, seed=seed, dtype=dtype)
    h, wd, c = shape[1], shape[2], shape[3]
    pa = pb = r = None
    kw = dict(relu=mode == "relu", with_stats=mode in ("stats", "prologue"))
    if mode == "prologue":
        pa, pb = _affine(rng, device, c)
    if mode in ("bwd_x", "adjoint"):
        b = torch.zeros_like(b)
    if mode == "bwd_x":
        pa, pb = _affine(rng, device, o)
        r = torch.from_numpy(rng.normal(size=shape[:3] + (o,)).astype(np.float32)).to(
            device, dtype)
        kw["with_stats"] = False
    x_logical, r_logical = x, r
    if framing:
        kw["logical_hw"] = (h, wd)
    if "pre_padded" in framing:
        x = _framed(x, 1)
        kw["pre_padded"] = True
    if "arena_g" in framing or ("arena_in" in framing and mode == "prologue"):
        x = _framed(x, 8)
        kw["arena_g" if "arena_g" in framing else "arena_in"] = True
    if "arena_in" in framing and mode == "bwd_x":
        r = _framed(r, 8)
        kw["arena_in"] = True
    if "arena_out" in framing:
        kw["arena_out"] = True
    return (x, w, b, pa, pb, r), x_logical, r_logical, kw


def _packed_terms(args, mode, kw):
    """The plain version on the absolute values of the inputs (a prologue's
    relu(pa*x + pb) is non-negative already, pa > 0 in the backward
    epilogue): per output, the sum of the absolute values of its terms, in
    the output's framing."""
    x, w, b, pa, pb, r = args
    out = conv3x3_packed_reference(x if mode == "prologue" else x.abs(), w.abs(), b.abs(), pa,
                                   pb, r, **dict(kw, relu=False, with_stats=False))
    return out[0] if isinstance(out, tuple) else out


def _check_packed(out, ref, args, x_logical, r_logical, mode, kw, rel=SM90_SUM_REL):
    """A conv3x3_packed result against its plain version (or the other
    body): the output (frame included) finite and, in bf16, within one bf16
    ulp, in float32 within F32_REL of the sum of the absolute values of its
    terms; the float32 sums within `rel` of the sums of the absolute values
    of their terms."""
    from hyperpri_tpu_torch.ops.kernels import _plain

    sums = ref_sums = None
    if isinstance(out, tuple):
        (out, sums), (ref, ref_sums) = out, ref
    assert out.shape == ref.shape and out.dtype == ref.dtype == x_logical.dtype
    assert bool(torch.isfinite(out).all())
    terms = None
    if out.dtype == torch.bfloat16:
        assert _bf16_ulp_error(out, ref) <= 1.0
    else:
        terms = _packed_terms(args, mode, kw)
        _assert_sums_close(out, ref, terms, F32_REL)
    if sums is None:
        return
    _, w, _, pa, pb, _ = args
    n, h, wd, o = x_logical.shape[0], x_logical.shape[1], x_logical.shape[2], w.shape[-1]
    if mode == "bwd_x":
        dz = _plain.conv3x3_same_f32(x_logical, w)
        rf = r_logical.float()
        mdz = torch.where(rf * pa + pb > 0, dz, torch.zeros_like(dz)).abs()
        if terms is not None:   # |m*dz| from the absolute terms of dx = m*dz*pa
            mdz = (terms[:, 8:8 + h, 8:8 + wd, :o] if kw.get("arena_out") else terms) / pa
        scales = ((mdz * rf.abs()).sum(dim=(0, 1, 2)), mdz.sum(dim=(0, 1, 2)))
    else:
        y = ref if terms is None else terms
        y = y[:, 8:8 + h, 8:8 + wd, :o] if kw.get("arena_out") else y
        yf = y.float()
        scales = (yf.abs().sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2)))
    for s, rs, sc in zip(sums, ref_sums, scales):
        _assert_sums_close(s, rs, sc, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode,framing", _SM90_PACKED)
def test_sm90_packed_matches_plain(cuda_device, shape, o, mode, framing):
    """The Hopper body in one mode and framing: it is the body taken, its
    output within one bf16 ulp of the plain version (an arena output's zero
    frame too), its sums within SM90_SUM_REL of their absolute terms, NaN
    frames never reach an output, and a reducing call gives the same bits
    twice."""
    args, x_logical, r_logical, kw = _packed_case(cuda_device, shape, o, mode, framing)
    before = dict(conv3x3_packed.launches_by_path)
    out, again = (conv3x3_packed(*args, **kw) for _ in range(2))
    assert _path_delta(conv3x3_packed, before) == {"sm90": 2}
    ref = conv3x3_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    _check_packed(out, ref, args, x_logical, r_logical, mode, kw)
    if isinstance(out, tuple):
        assert torch.equal(out[0], again[0])
        assert all(torch.equal(a, b) for a, b in zip(out[1], again[1]))
    else:
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode,framing", [
    ((2, 24, 968, 238), 64, "stats", ("pre_padded",)),
    ((2, 24, 968, 64), 64, "prologue", ()),
    ((2, 24, 968, 64), 64, "bwd_x", ()),
    ((2, 32, 484, 128), 64, "adjoint", ()),
    ((2, 24, 968, 64), 128, "adjoint", ()),
    ((2, 19, 242, 256), 128, "adjoint", ()),
])
def test_sm90_packed_matches_the_synchronous_body(cuda_device, shape, o, mode, framing):
    """The Hopper and synchronous bodies on the same bf16 inputs (the
    synchronous one through `_legacy`): outputs within one bf16 ulp of each
    other, sums within SM90_SUM_REL of their absolute terms of each other."""
    args, x_logical, r_logical, kw = _packed_case(cuda_device, shape, o, mode, framing, seed=1)
    before = dict(conv3x3_packed.launches_by_path)
    hopper = conv3x3_packed(*args, **kw)
    sync = conv3x3_packed(*args, _legacy=True, **kw)
    assert _path_delta(conv3x3_packed, before) == {"sm90": 1, "legacy": 1}
    torch.cuda.synchronize()
    _check_packed(hopper, sync, args, x_logical, r_logical, mode, kw)


# The float32 Hopper body of conv3x3_packed (3xTF32 on wgmma, TMA rings,
# persistent units of one 8x32 tile by one O tile of 64): every mode in every
# framing it takes, at NP = 64 and 128, at ragged shapes where tiles and TMA
# boxes overhang every edge, with C = 61 (arena pitch 64) and 238 (the ingest
# buffer's pitch 256) beside whole chunks, and at rows of the steps' calls.
# Framed buffers hold NaN in their frames; outputs and sums within F32_REL of
# the sums of the absolute values of their terms, every call twice with
# identical bits.
_SM90_PACKED_F32 = [
    ((1, 13, 37, 64), 64, mode, framing)
    for mode, framing in (
        ("relu", ()), ("stats", ()), ("prologue", ()), ("bwd_x", ()), ("adjoint", ()),
        ("relu", ("arena_out",)), ("stats", ("arena_out",)), ("prologue", ("arena_in",)),
        ("prologue", ("arena_in", "arena_out")), ("relu", ("arena_g",)), ("stats", ("arena_g",)),
        ("bwd_x", ("arena_in",)), ("bwd_x", ("arena_in", "arena_out")),
        ("bwd_x", ("arena_in", "arena_out", "arena_g")), ("bwd_x", ("arena_g",)))
] + [
    ((2, 29, 71, 128), 48, mode, framing)
    for mode, framing in (("stats", ()), ("prologue", ()), ("bwd_x", ()),
                          ("stats", ("arena_out",)))
] + [
    ((1, 13, 21, 61), 24, mode, framing)
    for mode, framing in (("prologue", ("arena_in",)), ("relu", ("arena_g",)),
                          ("stats", ("pre_padded",)), ("bwd_x", ("arena_g",)),
                          ("bwd_x", ("arena_in", "arena_out", "arena_g")))
] + [
    ((1, 11, 45, 238), 64, mode, framing)
    for mode, framing in (("stats", ("pre_padded",)), ("relu", ("pre_padded",)),
                          ("stats", ("pre_padded", "arena_out")))
] + [
    ((1, 13, 37, 64), 128, mode, framing)
    for mode, framing in (("adjoint", ()), ("relu", ()), ("prologue", ()), ("bwd_x", ()),
                          ("adjoint", ("arena_g",)), ("bwd_x", ("arena_in", "arena_out")))
] + [
    ((1, 19, 50, 256), 96, mode, framing)
    for mode, framing in (("adjoint", ()), ("stats", ("arena_out",)),
                          ("prologue", ("arena_in",)), ("relu", ("arena_g",)))
] + [
    ((2, 24, 968, 238), 64, "stats", ("pre_padded",)),
    ((2, 24, 968, 64), 64, "bwd_x", ()),
    ((2, 24, 968, 64), 128, "adjoint", ()),
    ((2, 19, 242, 256), 128, "adjoint", ()),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode,framing", _SM90_PACKED_F32)
def test_sm90_f32_packed_matches_plain(cuda_device, shape, o, mode, framing):
    """The float32 Hopper body in one mode and framing: it is the body
    taken, its output (an arena output's zero frame too) and its sums within
    F32_REL of their absolute terms of the plain version, NaN frames never
    reach an output, and every call gives the same bits twice."""
    args, x_logical, r_logical, kw = _packed_case(cuda_device, shape, o, mode, framing,
                                                  dtype=torch.float32)
    before = dict(conv3x3_packed.launches_by_path)
    out, again = (conv3x3_packed(*args, **kw) for _ in range(2))
    assert _path_delta(conv3x3_packed, before) == {"sm90": 2}
    ref = conv3x3_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    _check_packed(out, ref, args, x_logical, r_logical, mode, kw, F32_REL)
    if isinstance(out, tuple):
        assert torch.equal(out[0], again[0])
        assert all(torch.equal(a, b) for a, b in zip(out[1], again[1]))
    else:
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,mode,framing", [
    ((1, 13, 37, 64), 64, "prologue", ()),
    ((1, 13, 37, 64), 64, "bwd_x", ("arena_in", "arena_out")),
    ((1, 13, 21, 61), 24, "stats", ("pre_padded",)),
    ((1, 11, 45, 238), 64, "stats", ("pre_padded",)),
    ((1, 13, 37, 64), 128, "adjoint", ("arena_g",)),
    ((2, 24, 968, 64), 64, "bwd_x", ()),
    ((2, 32, 484, 128), 64, "adjoint", ()),
    ((2, 19, 242, 256), 128, "adjoint", ()),
])
def test_sm90_f32_packed_matches_the_synchronous_body(cuda_device, shape, o, mode, framing):
    """The float32 Hopper and synchronous bodies on the same inputs (the
    synchronous one through `_legacy`): outputs and sums within F32_REL of
    their absolute terms of each other."""
    args, x_logical, r_logical, kw = _packed_case(cuda_device, shape, o, mode, framing, seed=1,
                                                  dtype=torch.float32)
    before = dict(conv3x3_packed.launches_by_path)
    hopper = conv3x3_packed(*args, **kw)
    sync = conv3x3_packed(*args, _legacy=True, **kw)
    assert _path_delta(conv3x3_packed, before) == {"sm90": 1, "legacy": 1}
    torch.cuda.synchronize()
    _check_packed(hopper, sync, args, x_logical, r_logical, mode, kw, F32_REL)

