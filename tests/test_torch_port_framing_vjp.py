"""The port's trainable convs (ops/kernels/conv_train.py) against the JAX
package's custom VJPs (hyperpri_tpu/ops/pallas/conv_train.py) in their framed
forms, run with interpret=True: values and every gradient, float32 and bf16.

The ingest conv is framed on both sides (`pre_padded_hw`, each side's buffer
in its own geometry). The JAX arena chain (the statistics conv with
`arena_out`, the BatchNorm-ReLU conv reading an arena, the arena-g backwards)
is held against the port's unframed convs, which compute the same function
without the frames: a scalar loss reads only the logical regions, so the two
are compared there. JAX arena inputs carry NaN frames, as tests/test_arena.py's
do.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.ops.pallas import conv_train as jct  # noqa: E402
from hyperpri_tpu.ops.pallas.conv3x3_packed import arena_extent, fit_tiles  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import conv_train as ct  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import framing  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402

# float32: as tests/test_ingest.py and test_arena.py hold the JAX arena paths
# against the logical ones (sums in two orders).
F32 = dict(atol=3e-4, rtol=1e-4)
# bf16: both sides round at the same places (operands, y, g_eff, dx, dW); a
# float32 sum differing in its last bits can round to the neighbouring bf16
# value, 2**-8 relative, and the cotangents here reach magnitude ~8.
BF16 = dict(atol=8 * 2.0 ** -7, rtol=2.0 ** -6)
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol, what):
    np.testing.assert_allclose(_np(a), _np(b), err_msg=what, **tol)


def _inputs(rng, n, h, w, c, o):
    return dict(
        x=rng.normal(size=(n, h, w, c)).astype(np.float32),
        w=(rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32),
        b=(rng.normal(size=(o,)) * 0.1).astype(np.float32),
        pa=rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        pb=(rng.normal(size=(c,)) * 0.5).astype(np.float32),
        gy=rng.normal(size=(n, h, w, o)).astype(np.float32),
        gs=rng.normal(size=(o,)).astype(np.float32),
        gss=(rng.normal(size=(o,)) * 0.5).astype(np.float32))


def _jax_ingest(x, o):
    n, h, w, c = x.shape
    th, tw = fit_tiles(h, w, c, o, jnp.float32, jnp.float32, lane_stride=64)
    buf = np.zeros((n, -(-h // th) * th + 2, -(-w // tw) * tw + 8, -(-c // 128) * 128),
                   np.float32)
    buf[:, 1:1 + h, 1:1 + w, :c] = x
    return buf


def _port_ingest(x):
    n, h, w, c = x.shape
    (hp, wp, cp), (r0, c0), _ = framing.ingest_spec(h, w, c)
    buf = np.zeros((n, hp, wp, cp), np.float32)
    buf[:, r0:r0 + h, c0:c0 + w, :c] = x
    return buf


def _nan_arena(x, shape):
    n, h, w, c = x.shape
    buf = np.full(shape, np.nan, np.float32)
    buf[:, 8:8 + h, 8:8 + w, :] = 0.0
    buf[:, 8:8 + h, 8:8 + w, :c] = x
    return buf


def _loss_terms(y, s, ss, a, hw, o, arena):
    """sum(y*gy) + sum(s*gs) + sum(ss*gss) over y's logical region, for JAX
    arrays and torch tensors alike."""
    h, w = hw
    if arena:
        y = y[:, 8:8 + h, 8:8 + w, :o]
    if isinstance(y, torch.Tensor):
        gy, gs, gss = (torch.from_numpy(a[k]) for k in ("gy", "gs", "gss"))
        return (y.float() * gy).sum() + (s * gs).sum() + (ss * gss).sum()
    return (y.astype(jnp.float32) * a["gy"]).sum() + (s * a["gs"]).sum() + \
        (ss * a["gss"]).sum()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arena_out", [False, True])
def test_stats_conv_pre_padded(rng, dtype, arena_out):
    """The ingest conv: x is the host pre-padded buffer, no dx; dW and db,
    against the JAX ingest conv with and without its arena output."""
    jdt, tdt, tol = DTYPES[dtype]
    n, h, w, c, o = 1, 16, 24, 37, 64
    a = _inputs(rng, n, h, w, c, o)

    def jloss(wk, b):
        xp = jnp.asarray(_jax_ingest(a["x"], o), jdt)
        y, s, ss = jct.conv3x3_bias_stats_train(xp, wk.astype(jdt), b, True, arena_out, (h, w))
        return _loss_terms(y, s, ss, a, (h, w), o, arena_out)

    jl, (jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(a["w"]),
                                                             jnp.asarray(a["b"]))
    wk = torch.from_numpy(a["w"]).requires_grad_()
    b = torch.from_numpy(a["b"]).requires_grad_()
    xp = torch.from_numpy(_port_ingest(a["x"])).to(tdt)
    y, s, ss = ct.conv3x3_bias_stats_train(xp, wk.to(tdt), b, (h, w))
    assert tuple(y.shape) == (n, h, w, o)
    loss = _loss_terms(y, s, ss, a, (h, w), o, False)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-3 if dtype == "bf16" else 1e-5)
    _close(wk.grad, jdw, tol, "dW")
    _close(b.grad, jdb, tol, "db")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stats_conv_against_jax_arena_out_and_arena_g(rng, dtype):
    """The statistics conv against the JAX one handing an arena on, with its
    arena-g backward (the adjoint conv and the weight gradient read one
    zero-framed g_eff); the port's calls stay unframed."""
    jdt, tdt, tol = DTYPES[dtype]
    n, h, w, c, o = 2, 13, 21, 24, 64
    a = _inputs(rng, n, h, w, c, o)

    def jloss(x, wk, b):
        y, s, ss = jct.conv3x3_bias_stats_train(x.astype(jdt), wk.astype(jdt), b, True, True)
        return _loss_terms(y, s, ss, a, (h, w), o, True)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a[k])
                                                            for k in ("x", "w", "b")))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "w", "b")]
    x, wk, b = leaves
    before = dict(conv3x3_packed.calls_by_framing), dict(conv3x3_wgrad.calls_by_framing)
    y, s, ss = ct.conv3x3_bias_stats_train(x.to(tdt), wk.to(tdt), b)
    loss = _loss_terms(y, s, ss, a, (h, w), o, False)
    loss.backward()
    assert conv3x3_packed.calls_by_framing["unframed"] == before[0].get("unframed", 0) + 2
    assert conv3x3_wgrad.calls_by_framing["unframed"] == before[1].get("unframed", 0) + 1
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-3 if dtype == "bf16" else 1e-5)
    for name, mine, theirs in zip(("dx", "dW", "db"), (t.grad for t in leaves), jg):
        _close(mine, theirs, tol, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("o", [64, 20])
def test_bnact_conv_against_jax_arena_in(rng, dtype, o):
    """The BatchNorm-ReLU conv against the JAX one reading its producer's
    arena (NaN frame): values and the gradients of x's logical region, pa,
    pb, W and b. On the JAX side O = 64 takes the arena-g epilogue backward,
    O = 20 the epilogue with a logical g_eff."""
    jdt, tdt, tol = DTYPES[dtype]
    n, h, w, c = 1, 16, 24, 64
    a = _inputs(rng, n, h, w, c, o)
    jshape = (n,) + tuple(d + 16 for d in arena_extent(h, w, 16, c, jnp.float32,
                                                       jnp.float32)) + (c,)
    xa_j = _nan_arena(a["x"], jshape)

    def jloss(x, pa, pb, wk, b):
        y, s, ss = jct.conv3x3_bnact_stats_train(x.astype(jdt), pa, pb, wk.astype(jdt), b,
                                                 True, (h, w))
        return _loss_terms(y, s, ss, a, (h, w), o, False)

    args = [jnp.asarray(xa_j)] + [jnp.asarray(a[k]) for k in ("pa", "pb", "w", "b")]
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(*args)
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "pa", "pb", "w", "b")]
    x, pa, pb, wk, b = leaves
    y, s, ss = ct.conv3x3_bnact_stats_train(x.to(tdt), pa, pb, wk.to(tdt), b, 64)
    loss = _loss_terms(y, s, ss, a, (h, w), o, False)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-3 if dtype == "bf16" else 1e-5)
    assert np.isfinite(_np(jg[0])[:, 8:8 + h, 8:8 + w, :c]).all()
    _close(x.grad, jg[0][:, 8:8 + h, 8:8 + w, :c], tol, "dx")
    for name, mine, theirs in zip(("dpa", "dpb", "dW", "db"), leaves[1:], jg[1:]):
        _close(mine.grad, theirs, tol, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chain_against_jax_arena_chain(rng, dtype):
    """conv1 -> BatchNorm-ReLU conv2, as DoubleConv wires it, against the JAX
    chain through an arena (conv1 arena_out, conv2 reading it): the loss and
    the gradients of x, w1, b1, pa, pb, w2 and b2 (test_arena.py's chain
    test, in both dtypes)."""
    jdt, tdt, tol = DTYPES[dtype]
    n, h, w, c1, o1, o2 = 2, 13, 21, 16, 64, 64
    a1, a2 = _inputs(rng, n, h, w, c1, o1), _inputs(rng, n, h, w, o1, o2)

    def jloss(x, w1, b1, pa, pb, w2, b2):
        y1, _, _ = jct.conv3x3_bias_stats_train(x.astype(jdt), w1.astype(jdt), b1, True, True)
        y2, s2, ss2 = jct.conv3x3_bnact_stats_train(y1, pa, pb, w2.astype(jdt), b2, True,
                                                    (h, w))
        return _loss_terms(y2, s2, ss2, a2, (h, w), o2, False)

    names = [(a1, "x"), (a1, "w"), (a1, "b"), (a2, "pa"), (a2, "pb"), (a2, "w"), (a2, "b")]
    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(d[k]) for d, k in names))
    leaves = [torch.from_numpy(d[k]).requires_grad_() for d, k in names]
    x, w1, b1, pa, pb, w2, b2 = leaves
    y1, _, _ = ct.conv3x3_bias_stats_train(x.to(tdt), w1.to(tdt), b1)
    y2, s2, ss2 = ct.conv3x3_bnact_stats_train(y1, pa, pb, w2.to(tdt), b2, 64)
    loss = _loss_terms(y2, s2, ss2, a2, (h, w), o2, False)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-3 if dtype == "bf16" else 1e-5)
    for (_, k), mine, theirs in zip(names, leaves, jg):
        _close(mine.grad, theirs, tol, k)
