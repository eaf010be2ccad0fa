"""The fold mode of the port's conv3x3_wgrad (y, gsum, gsumsq: g_eff = gy +
gsum + 2*y*gsumsq and db = sum g_eff formed inside the weight gradient)
against the JAX package's Pallas kernel in fold mode, run in interpret mode,
on the shapes of tests/test_arena.py's fold test, with and without the
prologue, unframed and with arena-framed gy and y (NaN frames) and arena x.

Inputs come from a numpy seed. On CPU tensors the wrapper runs its plain
version: the code that chip_smoke.py holds the CUDA kernel against.
Tolerances: float32, dW and db within 2e-4 rel/abs (tests/test_arena.py's);
bf16, within 1e-5 of the sum of the absolute values of each output's terms
(the two sides round g_eff to bf16 alike and sum the exact bf16 products in
float32 in different orders). With the prologue, XLA on the CPU contracts the
JAX kernel's pa*x + pb into one fused multiply-add, where the port (kernel and
plain version alike) rounds the product and then the sum; the two z = relu(..)
then differ by one bf16 ulp at a few elements. The bf16 limit adds exactly
what those elements contribute: the plain weight gradient of |z_fma - z| and
|g_eff|, with z_fma emulated in float64.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas.conv3x3_grad import conv3x3_wgrad as jax_wgrad  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import arena_extent  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import _plain  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import (  # noqa: E402
    conv3x3_wgrad,
    conv3x3_wgrad_reference,
)

F32 = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 1e-5
SHAPES = [(1, 16, 24, 64, 64), (2, 13, 21, 20, 24)]   # (n, h, w, c, o), ragged second
MODES = ["plain", "prologue", "arena_g", "prologue+arena_g", "arena_in+arena_g"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _arena(t, eh, ew):
    """t (n, h, w, c) in the JAX package's arena (tests/test_arena.py's
    _embed_arena): logical at (8, 8), NaN border, finite beyond-logical
    tiles, zero pad lanes up to round_up(c, 8)."""
    n, h, w, c = t.shape
    buf = np.full((n, 8 + eh + 8, 8 + ew + 8, -(-c // 8) * 8), np.nan, np.float32)
    buf[:, 8:8 + h, 8:8 + w, :c] = t
    inner = buf[:, 8:8 + eh, 8:8 + ew, :]
    inner[np.isnan(inner)] = 3.25
    buf[:, 8:8 + eh, 8:8 + ew, c:] = 0.0
    return buf


def _case(rng, n, h, w, c, o, mode):
    """numpy operands, the kernel's keyword arguments and the logical x."""
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    gy = rng.normal(size=(n, h, w, o)).astype(np.float32)
    y = rng.normal(size=(n, h, w, o)).astype(np.float32)
    gs = rng.normal(size=(o,)).astype(np.float32)
    gss = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
    pa = pb = None
    if "prologue" in mode or "arena_in" in mode:
        pa = rng.normal(size=(c,)).astype(np.float32)
        pb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    kw = {}
    xk = x
    if "arena_g" in mode:
        eh, ew = arena_extent(h, w, 16, o, jnp.float32, jnp.float32)
        gy, y = _arena(gy, eh, ew), _arena(y, eh, ew)
        kw.update(arena_g=True, logical_hw=(h, w))
    if "arena_in" in mode:
        eh, ew = arena_extent(h, w, 16, c, jnp.float32, jnp.float32)
        xk = _arena(x, eh, ew)
        kw["arena_in"] = True
    return dict(x=xk, gy=gy, y=y, gs=gs, gss=gss, pa=pa, pb=pb), kw


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _logical(t, framed, h, w, c):
    return t[:, 8:8 + h, 8:8 + w, :c] if framed else t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,h,w,c,o", SHAPES)
def test_fold_matches_pallas(rng, n, h, w, c, o, mode, dtype):
    tdt, jdt = DTYPES[dtype]
    a, kw = _case(rng, n, h, w, c, o, mode)
    vec = ("gs", "gss", "pa", "pb")   # float32 vectors on both sides
    ja = {k: (_jax(v, jnp.float32) if k in vec else _jax(v, jdt)) for k, v in a.items()}
    ta = {k: (_torch(v, torch.float32) if k in vec else _torch(v, tdt)) for k, v in a.items()}
    dw_ref, db_ref = jax_wgrad(ja["x"], ja["gy"], ja["pa"], ja["pb"], y=ja["y"], gsum=ja["gs"],
                               gsumsq=ja["gss"], interpret=True, **kw)
    dw, db = conv3x3_wgrad(ta["x"], ta["gy"], ta["pa"], ta["pb"], y=ta["y"], gsum=ta["gs"],
                           gsumsq=ta["gss"], **kw)
    assert tuple(dw.shape) == (3, 3, c, o) and tuple(db.shape) == (o,)
    assert dw.dtype == db.dtype == torch.float32
    dw_ref, db_ref = np.asarray(dw_ref), np.asarray(db_ref)
    assert np.isfinite(dw.numpy()).all() and np.isfinite(db.numpy()).all()
    if dtype == "f32":
        np.testing.assert_allclose(dw.numpy(), dw_ref, **F32)
        np.testing.assert_allclose(db.numpy(), db_ref, **F32)
        return
    # bf16: scale = each output's sum of absolute terms, from the rounded g_eff
    framed_g = "arena_g" in mode
    g_eff = _plain.fold_stats_cotangent(
        _logical(ta["gy"], framed_g, h, w, o), ta["gs"], ta["gss"],
        _logical(ta["y"], framed_g, h, w, o), torch.bfloat16)
    x = _logical(ta["x"], "arena_in" in mode, h, w, c)
    z = _plain.prologue_act(x, ta["pa"], ta["pb"])
    limit = BF16_REL * conv3x3_wgrad_reference(z.abs(), g_eff.abs()).numpy()
    if ta["pa"] is not None:
        fma = x.double() * ta["pa"].double() + ta["pb"].double()
        z_fma = torch.relu(fma.float()).to(torch.bfloat16)
        limit += conv3x3_wgrad_reference((z_fma.float() - z.float()).abs(),
                                         g_eff.float().abs()).numpy()
    assert np.all(np.abs(dw.numpy() - dw_ref) <= limit + 1e-30)
    db_scale = g_eff.float().abs().sum(dim=(0, 1, 2)).numpy()
    assert np.all(np.abs(db.numpy() - db_ref) <= BF16_REL * db_scale + 1e-30)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,c,o", SHAPES)
def test_fold_equals_materialized(rng, n, h, w, c, o, dtype):
    """Fold mode equals the non-fold mode on the port's own materialized
    g_eff (conv_train's arithmetic) and db its float32 sum."""
    tdt = DTYPES[dtype][0]
    a, _ = _case(rng, n, h, w, c, o, "prologue")
    x, gy, y = (_torch(a[k], tdt) for k in ("x", "gy", "y"))
    gs, gss, pa, pb = (_torch(a[k], torch.float32) for k in ("gs", "gss", "pa", "pb"))
    dw, db = conv3x3_wgrad(x, gy, pa, pb, y=y, gsum=gs, gsumsq=gss)
    g_eff = _plain.fold_stats_cotangent(gy, gs, gss, y, tdt)
    torch.testing.assert_close(dw, conv3x3_wgrad(x, g_eff, pa, pb), rtol=0, atol=0)
    torch.testing.assert_close(db, g_eff.float().sum(dim=(0, 1, 2)), rtol=0, atol=0)


def test_fold_counts_its_launches_by_mode_only_on_the_card():
    """On the CPU the wrapper counts calls, never launches."""
    rng = np.random.default_rng(1)
    a, _ = _case(rng, 1, 8, 8, 16, 8, "plain")
    launches = conv3x3_wgrad.launches
    calls = conv3x3_wgrad.calls
    conv3x3_wgrad(_torch(a["x"], torch.float32), _torch(a["gy"], torch.float32),
                  y=_torch(a["y"], torch.float32), gsum=_torch(a["gs"], torch.float32),
                  gsumsq=_torch(a["gss"], torch.float32))
    assert conv3x3_wgrad.calls == calls + 1 and conv3x3_wgrad.launches == launches
    assert "fold" not in conv3x3_wgrad.launches_by_mode


@pytest.mark.parametrize("bad", ["y_alone", "no_gsumsq", "y_shape", "y_dtype", "gsum_len"])
def test_fold_rejects_what_the_jax_kernel_rejects(bad):
    """y, gsum and gsumsq come together, y matches g's shape and dtype
    (conv3x3_grad.py:243-247), and the statistics' cotangents are (O,)."""
    x = torch.zeros((1, 8, 8, 16))
    g = torch.zeros((1, 8, 8, 8))
    kw = dict(y=torch.zeros_like(g), gsum=torch.zeros(8), gsumsq=torch.zeros(8))
    if bad == "y_alone":
        kw = dict(y=kw["y"])
    elif bad == "no_gsumsq":
        del kw["gsumsq"]
    elif bad == "y_shape":
        kw["y"] = torch.zeros((1, 8, 8, 4))
    elif bad == "y_dtype":
        kw["y"] = kw["y"].bfloat16()
    else:
        kw.update(gsum=torch.zeros(4), gsumsq=torch.zeros(4))
    with pytest.raises(ValueError):
        conv3x3_wgrad(x, g, **kw)
