"""The host-side plan of the Hopper conv kernels (ops/kernels/sm90_plan.py):
which kernel body a conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad or
conv3x3_bias_act_shift call takes, and its tiling, ring depths, grid and
pixel splits. The plan is a pure function of shape,
dtype, mode and layout, so it is held here without a card. Also the plain
TF32 split that the float32 Hopper bodies apply to their operands."""

import numpy as np
import pytest
import torch

import chip_smoke
from hyperpri_tpu_torch.ops.kernels import _plain, framing, sm90_plan
from hyperpri_tpu_torch.ops.kernels.conv3x3 import split_weights_tf32
from hyperpri_tpu_torch.ops.kernels.framing import Frame


def _x_pitch(call):
    """The channel pitch of the call's x: the ingest buffer's for the
    pre-padded first conv, else C."""
    n, h, w, c = call["shape"]
    if "pre_padded" in call["framing"]:
        return framing.ingest_spec(h, w, c)[0][2]
    return c


def _plans(model, dtype="bf16"):
    """(conv3x3_bias_act plans, conv3x3_wgrad plans) of one training step of
    `model` in `dtype`, from the routing's walk of the model."""
    calls = chip_smoke.training_calls(model, ingest=model == "CubeNET", dtype=dtype)
    torch_dtype = chip_smoke.DTYPES[dtype]
    bias_act, wgrad = [], []
    for call in calls:
        n, h, w, c = call["shape"]
        o = call["o"]
        if call["kernel"] == "conv3x3_bias_act":
            bias_act.append(sm90_plan.bias_act_plan(n, h, w, c, o, torch_dtype))
        elif call["kernel"] == "conv3x3_wgrad":
            wgrad.append(sm90_plan.wgrad_plan(n, h, w, c, o, torch_dtype, _x_pitch(call), o))
    return bias_act, wgrad


@pytest.mark.parametrize("model", ["CubeNET", "UNET"])
def test_every_bf16_step_call_takes_sm90(model):
    bias_act, wgrad = _plans(model)
    assert (len(bias_act), len(wgrad)) == (12, 11 if model == "CubeNET" else 10)
    assert {p.path for p in bias_act} == {"sm90"}
    assert {p.path for p in wgrad} == {"sm90"}


@pytest.mark.parametrize("model", ["CubeNET", "UNET"])
def test_every_float32_step_call_takes_sm90(model):
    """Every float32 call of conv3x3_bias_act and conv3x3_wgrad in the step
    of the CLI's default run takes the Hopper bodies: 12 + 10 calls for UNET,
    12 + 11 for CubeNET-64 (whose first conv's weight gradient reads the
    host pre-padded ingest buffer), with the float32 plans' tiles and
    shared memory."""
    bias_act, wgrad = _plans(model, "f32")
    assert (len(bias_act), len(wgrad)) == (12, 11 if model == "CubeNET" else 10)
    assert {p.path for p in bias_act} == {"sm90"}
    assert {p.path for p in wgrad} == {"sm90"}
    assert {(p.tile_o, p.smem) for p in bias_act} == {
        (sm90_plan.K2F_N, sm90_plan.k2f_smem_bytes(sm90_plan.K2F_MAX_STAGES))}
    assert {(p.stages, p.smem) for p in wgrad} == {
        (sm90_plan.K3F_HSTAGES, sm90_plan.k3f_smem_bytes())}


def test_float32_ingest_weight_gradient_takes_sm90():
    """CubeNET-64's first-conv weight gradient reads the float32 ingest buffer:
    a 256-channel pitch is 1,024-byte pixels, which TMA can address; the same
    C = 238 unframed is 952-byte pixels, which it cannot."""
    (hp, wp, cp), _, _ = framing.ingest_spec(608, 968, 238)
    assert cp * 4 == 1024
    assert sm90_plan.wgrad_plan(2, 608, 968, 238, 64, torch.float32, cp, 64).path == "sm90"
    assert sm90_plan.wgrad_plan(2, 608, 968, 238, 64, torch.float32, 238, 64).path == "legacy"


def test_float32_shared_memory_sums_fit_an_h100_block():
    """The float32 bodies' shared memory (k2f_smem_bytes, k3f_smem_bytes,
    mirroring the kernels' sums) fits one block: kernel 2's weight ring at
    its deepest, kernel 3's fixed layout."""
    assert sm90_plan.k2f_smem_bytes(sm90_plan.K2F_MAX_STAGES) <= sm90_plan.SMEM_LIMIT
    assert sm90_plan.k2f_smem_bytes(sm90_plan.K2F_MAX_STAGES + 1) > sm90_plan.SMEM_LIMIT
    assert sm90_plan.k3f_smem_bytes() <= sm90_plan.SMEM_LIMIT
    # kernel 3: two halo stages of 64 channels, the raw g quarter, two planes
    assert sm90_plan.k3f_smem_bytes() == (1024 + 2 * 2 * sm90_plan.HALO_SLOT + 16384
                                          + 2 * 16384 + 512 + 24)


@pytest.mark.parametrize("case", [
    dict(dtype=torch.float32, c=238, o=128),              # 952-byte float32 pixels
    dict(dtype=torch.bfloat16, c=238, o=64),              # 476-byte pixels
    dict(dtype=torch.bfloat16, c=61, o=64),               # 122-byte pixels
    dict(dtype=torch.bfloat16, c=64, o=64, aligned=False),  # origin off 16 bytes
    dict(dtype=torch.bfloat16, c=320, o=64),              # halo past the shared memory
    dict(dtype=torch.bfloat16, c=64, o=131),              # 262-byte weight rows
])
def test_bias_act_legacy_cases(case):
    plan = sm90_plan.bias_act_plan(2, 37, 53, case["c"], case["o"], case["dtype"],
                                   case.get("aligned", True))
    assert plan.path == "legacy" and plan.stages == 0
    assert plan.tile_o == (64 if case["o"] <= 64 else 128)


@pytest.mark.parametrize("case", [
    dict(c=66, o=64),                 # a pitch that is not a multiple of 4: 264-byte pixels
    dict(c=64, o=66),                 # 264-byte rows of the weights' planes
    dict(c=320, o=64),                # past the prologue's affine buffer (C <= 256)
    dict(c=64, o=64, aligned=False),  # origin off 16 bytes
])
def test_bias_act_float32_legacy_cases(case):
    """Float32 layouts the Hopper body does not take stay on the synchronous
    one."""
    plan = sm90_plan.bias_act_plan(2, 37, 53, case["c"], case["o"], torch.float32,
                                   case.get("aligned", True))
    assert plan.path == "legacy" and plan.stages == 0


@pytest.mark.parametrize("case", [
    dict(dtype=torch.float32, c=238, o=64, xp=238, gp=64),    # 952-byte float32 pixels
    dict(dtype=torch.bfloat16, c=238, o=64, xp=238, gp=64, fold=True),  # the fold, C = 238
    dict(dtype=torch.bfloat16, c=238, o=64, xp=238, gp=64),   # C = 238 unframed
    dict(dtype=torch.bfloat16, c=64, o=20, xp=64, gp=20),     # 40-byte g pixels
    dict(dtype=torch.bfloat16, c=64, o=64, xp=64, gp=64, aligned=False),
])
def test_wgrad_legacy_cases(case):
    plan = sm90_plan.wgrad_plan(2, 37, 53, case["c"], case["o"], case["dtype"], case["xp"],
                                case["gp"], case.get("fold", False), case.get("aligned", True),
                                y_aligned=case.get("y_aligned", True))
    assert plan.path == "legacy" and plan.stages == 0


@pytest.mark.parametrize("case", [
    dict(c=64, o=64, xp=64, gp=64, fold=True, y_aligned=False),  # the fold, y off 16 bytes
    dict(c=64, o=66, xp=64, gp=66),              # g pitch not a multiple of 4
    dict(c=61, o=64, xp=61, gp=64),              # 244-byte x pixels
    dict(c=64, o=64, xp=64, gp=64, aligned=False),
])
def test_wgrad_float32_legacy_cases(case):
    """Float32 weight gradients the Hopper body does not take stay on the
    synchronous one, with the synchronous plan's splits."""
    plan = sm90_plan.wgrad_plan(2, 37, 53, case["c"], case["o"], torch.float32, case["xp"],
                                case["gp"], case.get("fold", False), case.get("aligned", True),
                                y_aligned=case.get("y_aligned", True))
    assert plan.path == "legacy" and plan.stages == 0


# conv3x3_wgrad's fold mode (y, gsum, gsumsq): its Hopper bodies' plans.
_FOLD_VIEWS = {
    # (x's frame, g's and y's frame) of a logical 1x13x37 call, C -> O
    "unframed": lambda c, o: (Frame.of(torch.empty(1, 13, 37, c)),
                              Frame.of(torch.empty(1, 13, 37, o))),
    "pre_padded": lambda c, o: (Frame(*framing.ingest_spec(13, 37, c)[0][:2],
                                      framing.ingest_spec(13, 37, c)[0][2], 1, 1),
                                Frame.of(torch.empty(1, 13, 37, o))),
    "arena_g": lambda c, o: (Frame.of(torch.empty(1, 13, 37, c)),
                             Frame.of(torch.empty(framing.arena_shape(1, 13, 37, o)), 8)),
    "arena_in+arena_g": lambda c, o: (Frame.of(torch.empty(framing.arena_shape(1, 13, 37, c)), 8),
                                      Frame.of(torch.empty(framing.arena_shape(1, 13, 37, o)), 8)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view,c,o", [(view, c, o) for view in _FOLD_VIEWS
                                      for c, o in ((64, 64), (128, 136), (24, 40))]
                         + [(view, 238, 24) for view in ("pre_padded", "arena_in+arena_g")])
def test_wgrad_fold_takes_sm90_with_the_non_fold_splits(dtype, view, c, o):
    """Fold calls whose x, g and y views TMA can address take the Hopper
    bodies in both dtypes and every framing, with the splits and tile walk
    of the same call without the fold (its dW is held bit for bit against
    the non-fold body on the materialized g_eff), in a layout that fits an
    H100 block: bf16 two stages of x halo + g + y tiles, float32 the fold's
    fixed layout. C = 238 only with x framed (unframed: test_wgrad_legacy_cases)."""
    fx, fg = _FOLD_VIEWS[view](c, o)
    args = (1, 13, 37, c, o, dtype, fx.pitch, fg.pitch)
    fold, plain = sm90_plan.wgrad_plan(*args, fold=True), sm90_plan.wgrad_plan(*args)
    assert fold.path == plain.path == "sm90"
    assert (fold.splits, fold.tiles, fold.tiles_per_split) == (
        plain.splits, plain.tiles, plain.tiles_per_split)
    assert 0 < fold.smem <= sm90_plan.SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert fold.stages == 2 and fold.smem == sm90_plan.k3_smem_bytes(2, fold=True)
        assert sm90_plan.k3_smem_bytes(3, fold=True) > sm90_plan.SMEM_LIMIT
    else:
        assert (fold.stages, fold.smem) == (sm90_plan.K3F_HSTAGES,
                                            sm90_plan.k3f_smem_bytes(fold=True))


@pytest.mark.parametrize("model", ["CubeNET", "UNET"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_wgrad_fold_at_the_step_calls_takes_sm90(model, dtype):
    """At every weight-gradient call of a training step the fold mode would
    take the Hopper body with the call's own splits."""
    calls = chip_smoke.training_calls(model, ingest=model == "CubeNET", dtype=dtype)
    torch_dtype = chip_smoke.DTYPES[dtype]
    for call in calls:
        if call["kernel"] != "conv3x3_wgrad":
            continue
        n, h, w, c = call["shape"]
        args = (n, h, w, c, call["o"], torch_dtype, _x_pitch(call), call["o"])
        fold, plain = sm90_plan.wgrad_plan(*args, fold=True), sm90_plan.wgrad_plan(*args)
        assert fold.path == "sm90" and fold.splits == plain.splits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("why", ["y_pitch", "y_pitch_tma", "y_aligned", "legacy"])
def test_wgrad_fold_legacy_cases(dtype, why):
    """A fold call stays on the synchronous body when y's view is not g's
    (another pitch), TMA cannot address it (61 channels: 122-byte bf16 and
    244-byte float32 pixels), its buffer is off 16 bytes, or the caller asks
    for it (sm90=False), with the synchronous plan's splits."""
    kw = {"y_pitch": dict(y_pitch=128), "y_pitch_tma": dict(y_pitch=61),
          "y_aligned": dict(y_aligned=False), "legacy": dict(sm90=False)}[why]
    args = (2, 37, 53, 64, 64, dtype, 64, 64)
    plan = sm90_plan.wgrad_plan(*args, fold=True, **kw)
    assert plan.path == "legacy" and plan.stages == 0
    assert plan.splits == sm90_plan.wgrad_plan(*args, fold=True, sm90=False).splits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_call_plan_reads_y_alignment(dtype):
    """conv3x3_wgrad (through call_plan, which the wrapper calls) hands the
    plan the alignment of y's buffer: the same fold call takes the Hopper
    body with y on a 16-byte boundary and the synchronous one with y an
    element off it, with the same splits; without the fold y plays no part."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import call_plan

    n, h, w, c, o = 2, 29, 71, 64, 64
    x = torch.zeros((n, h, w, c), dtype=dtype)
    g = torch.zeros((n, h, w, o), dtype=dtype)
    gsum, gsumsq = torch.zeros(o), torch.zeros(o)
    buf = torch.zeros(n * h * w * o + 8, dtype=dtype)
    y_on, y_off = buf[:-8].view(n, h, w, o), buf[1:-7].view(n, h, w, o)
    assert y_on.data_ptr() % 16 == 0 and y_off.data_ptr() % 16 != 0
    on = call_plan(x, g, y=y_on, gsum=gsum, gsumsq=gsumsq)
    off = call_plan(x, g, y=y_off, gsum=gsum, gsumsq=gsumsq)
    assert (on.path, off.path) == ("sm90", "legacy")
    assert on.tiles == off.tiles
    assert call_plan(x, g).path == "sm90"
    assert call_plan(x, g, y=y_on, gsum=gsum, gsumsq=gsumsq, _legacy=True).path == "legacy"


def test_wgrad_fold_shared_memory_sums():
    """The fold layouts, as csrc/conv3x3_grad.cu sums them: bf16 two stages
    of x halo, g and y tiles, the C tile's affine, gsum and gsumsq and 12
    warps' db sums, two stages' barriers; float32 the two x halos, two raw
    buffers of a pixel row of gy and y, the one-row planes, the affine,
    gsum and gsumsq, 128 transposers' four db sums, four barriers."""
    assert sm90_plan.k3_smem_bytes(2, fold=True) == (
        1024 + 2 * (sm90_plan.HALO_SLOT + 2 * sm90_plan.TILE_BYTES) + 512 + 512 + 12 * 256 + 32)
    assert sm90_plan.k3f_smem_bytes(fold=True) == (
        1024 + 2 * 2 * sm90_plan.HALO_SLOT + 2 * 16384 + 2 * 8192 + 512 + 512 + 2048 + 32)
    assert sm90_plan.k3f_smem_bytes(fold=True) <= sm90_plan.SMEM_LIMIT
    # the non-fold layouts keep their sizes
    assert sm90_plan.k3_smem_bytes(3) == 231_984 and sm90_plan.k3f_smem_bytes() == 226_840


def test_wgrad_framed_views_take_sm90():
    """The ingest buffer (256-channel pitch) and arenas (pitch round_up(C, 8))
    are TMA views even where the logical C is not a multiple of 8."""
    for c, fx in ((238, Frame(610, 970, 256, 1, 1)), (61, Frame(29, 80, 64, 8, 8))):
        plan = sm90_plan.wgrad_plan(1, 13, 37, c, 24, torch.bfloat16, fx.pitch,
                                    framing.round_up(24, 8))
        assert plan.path == "sm90"


_SHAPES = [(2, 304, 484, 64, 128), (2, 152, 242, 256, 256), (2, 608, 968, 238, 64),
           (1, 13, 37, 64, 128), (1, 13, 37, 128, 256), (1, 1, 1, 8, 8), (3, 9, 33, 192, 48),
           (2, 304, 484, 256, 128), (1, 17, 33, 24, 131)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_plans_fit_shared_memory(shape):
    n, h, w, c, o = shape
    for dtype in (torch.bfloat16, torch.float32):
        k2 = sm90_plan.bias_act_plan(n, h, w, c, o, dtype)
        k3 = sm90_plan.wgrad_plan(n, h, w, c, o, dtype, c, o)
        for plan in (k2, k3):
            assert 0 < plan.smem <= sm90_plan.SMEM_LIMIT
            assert plan.stages >= (2 if plan.path == "sm90" else 0)
        if k2.path == "sm90" and dtype == torch.bfloat16:
            assert k2.smem == sm90_plan.k2_smem_bytes(-(-c // 64), k2.stages)
            assert k2.stages == sm90_plan.K2_MAX_STAGES or sm90_plan.k2_smem_bytes(
                -(-c // 64), k2.stages + 1) > sm90_plan.SMEM_LIMIT
        elif k2.path == "sm90":
            assert k2.smem == sm90_plan.k2f_smem_bytes(k2.stages)
            assert k2.stages == sm90_plan.K2F_MAX_STAGES or sm90_plan.k2f_smem_bytes(
                k2.stages + 1) > sm90_plan.SMEM_LIMIT
        if k3.path == "sm90" and dtype == torch.float32:
            assert (k3.stages, k3.smem) == (sm90_plan.K3F_HSTAGES, sm90_plan.k3f_smem_bytes())


@pytest.mark.parametrize("shape", _SHAPES)
def test_bias_act_grid_covers_the_image(shape):
    """Every pixel tile has a block, and the statistics' partial buffer has
    a row per block."""
    n, h, w, c, o = shape
    for dtype in (torch.bfloat16, torch.float32):
        plan = sm90_plan.bias_act_plan(n, h, w, c, o, dtype)
        gx, gy, gz = plan.grid
        assert (gx, gy) == (-(-w // sm90_plan.TW), -(-h // sm90_plan.TH))
        if plan.path == "sm90":
            assert gz == n and plan.partial_rows == gx * gy * gz
        else:
            assert gz == n * -(-o // plan.tile_o) and plan.partial_rows == gx * gy * n


@pytest.mark.parametrize("shape", _SHAPES)
def test_wgrad_splits_cover_every_pixel_tile(shape):
    n, h, w, c, o = shape
    tiles = n * -(-h // 8) * -(-w // 32)
    for dtype in (torch.bfloat16, torch.float32):
        plan = sm90_plan.wgrad_plan(n, h, w, c, o, dtype, c, o)
        assert plan.tiles == tiles
        assert plan.splits * plan.tiles_per_split >= tiles
        assert 1 <= plan.splits <= tiles
        assert plan.tiles_per_split <= sm90_plan.K3_MAX_CHAIN
        if plan.path == "sm90":
            # no split without a tile, and no more blocks than fill the
            # waves that the least split count needs
            assert (plan.splits - 1) * plan.tiles_per_split < tiles
            co_blocks = -(-c // 64) * -(-o // 64)
            least = -(-tiles // sm90_plan.K3_MAX_CHAIN)
            waves = -(-least * co_blocks // sm90_plan.SMS)
            assert plan.splits * co_blocks <= max(waves * sm90_plan.SMS, co_blocks)


@pytest.mark.parametrize("model", ["CubeNET", "UNET"])
def test_wgrad_chains_stay_within_the_cap(model):
    """At every weight gradient of a bf16 and a float32 step, on either body,
    a block's float32 accumulators chain no more than K3_MAX_CHAIN pixel
    tiles (the float64 check on one-signed terms rests on it), and the
    Hopper body fills whole waves of one block per SM but the last."""
    for dtype, torch_dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        calls = chip_smoke.training_calls(model, ingest=model == "CubeNET", dtype=dtype)
        for call in calls:
            if call["kernel"] != "conv3x3_wgrad":
                continue
            n, h, w, c = call["shape"]
            o = call["o"]
            args = (n, h, w, c, o, torch_dtype, _x_pitch(call), o)
            for plan in (sm90_plan.wgrad_plan(*args), sm90_plan.wgrad_plan(*args, sm90=False)):
                assert plan.tiles_per_split <= sm90_plan.K3_MAX_CHAIN
                if plan.path == "sm90":
                    blocks = plan.splits * -(-c // 64) * -(-o // 64)
                    assert blocks > (-(-blocks // sm90_plan.SMS) - 1) * sm90_plan.SMS


def test_switching_sm90_off_takes_the_synchronous_kernels():
    """sm90=False (what the wrappers pass for `_legacy=True`) sends a call the
    Hopper kernels would take to the synchronous ones."""
    k2 = sm90_plan.bias_act_plan(2, 304, 484, 128, 128, torch.bfloat16, sm90=False)
    k3 = sm90_plan.wgrad_plan(2, 304, 484, 128, 128, torch.bfloat16, 128, 128, sm90=False)
    assert (k2.path, k3.path) == ("legacy", "legacy")
    k3f = sm90_plan.wgrad_plan(2, 304, 484, 128, 128, torch.float32, 128, 128, sm90=False)
    assert k3.splits == k3f.splits and k3f.path == "legacy"
    k2f = sm90_plan.bias_act_plan(2, 304, 484, 128, 128, torch.float32, sm90=False)
    assert (k2f.path, k2f.tile_o) == ("legacy", 128)


# conv3x3_packed (kernel 1): the Hopper body's persistent plan.

def _packed_plan(call, **kw):
    n, h, w, c = call["shape"]
    return sm90_plan.packed_plan(n, h, w, c, call["o"], chip_smoke.DTYPES[call["dtype"]],
                                 _x_pitch(call), bwd=call["mode"] == "bwd_x", **kw)


@pytest.mark.parametrize("path", ["product_loop", "training_step", "serving"])
def test_packed_bf16_calls_take_sm90(path):
    """All nine bf16 packed calls of the product loop's step take the Hopper
    body; phase e's unframed C = 238 first conv (476-byte pixels) and
    serving's keep the synchronous one: 8 of 9 and 3 of 4."""
    if path == "serving":
        calls = chip_smoke.serving_calls()
    else:
        calls = [c for c in chip_smoke.training_calls(ingest=path == "product_loop")
                 if c["kernel"] == "conv3x3_packed"]
    paths = [_packed_plan(call).path for call in calls]
    want = {"product_loop": (9, 0), "training_step": (8, 1), "serving": (3, 1)}[path]
    assert (paths.count("sm90"), paths.count("legacy")) == want
    for call, p in zip(calls, paths):
        if p == "legacy":
            assert call["shape"][-1] == 238 and call["framing"] == ()


@pytest.mark.parametrize("model", ["CubeNET", "UNET"])
def test_packed_float32_and_legacy_flag_take_the_synchronous_body(model):
    """Every float32 conv3x3_packed call of the UNET and CubeNET-64 steps (8
    and 9, CubeNET-64's first conv through the float32 ingest buffer's
    1,024-byte pixels) takes the float32 Hopper body; sm90=False (the
    wrappers' `_legacy`) sends them, and their bf16 forms, to the
    synchronous one."""
    calls = [c for c in chip_smoke.training_calls(model, ingest=model == "CubeNET", dtype="f32")
             if c["kernel"] == "conv3x3_packed"]
    assert len(calls) == (9 if model == "CubeNET" else 8)
    plans = [_packed_plan(call) for call in calls]
    assert {p.path for p in plans} == {"sm90"}
    assert {(p.stages, p.smem) for p in plans} == {
        (sm90_plan.K1F_HSTAGES, sm90_plan.k1f_smem_bytes(sm90_plan.K1F_MAX_WSTAGES))}
    assert {_packed_plan(call, sm90=False).path for call in calls} == {"legacy"}
    bf16 = [dict(call, dtype="bf16") for call in calls]
    assert {_packed_plan(call, sm90=False).path for call in bf16} == {"legacy"}


@pytest.mark.parametrize("case", [
    dict(c=238, o=64, xp=238),                   # unframed C = 238: 952-byte pixels
    dict(c=66, o=64, xp=66),                     # a pitch not a multiple of 4: 264 bytes
    dict(c=320, o=64, xp=320),                   # past the prologue's affine buffer
    dict(c=64, o=64, xp=64, aligned=False),      # origin off 16 bytes
    dict(c=64, o=63, xp=64),                     # odd O: no channel pairs
    dict(c=64, o=64, xp=64, bwd=True, r_pitch=65),
])
def test_packed_float32_legacy_cases(case):
    """Float32 layouts the Hopper body does not take stay on the synchronous
    one."""
    plan = sm90_plan.packed_plan(2, 37, 53, case["c"], case["o"], torch.float32, case["xp"],
                                 bwd=case.get("bwd", False), aligned=case.get("aligned", True),
                                 r_pitch=case.get("r_pitch"))
    assert plan.path == "legacy" and plan.stages == plan.w_stages == 0
    assert plan.o_units == 1 and plan.partial_rows == 2 * 5 * 2


@pytest.mark.parametrize("case", [
    dict(c=238, o=64, xp=238),                   # 476-byte pixels
    dict(c=61, o=64, xp=61),                     # 122-byte pixels
    dict(c=64, o=20, xp=64),                     # 40-byte weight rows
    dict(c=64, o=64, xp=64, aligned=False),      # origin off 16 bytes
    dict(c=320, o=64, xp=320),                   # past the prologue's affine buffer
    dict(c=64, o=64, xp=64, y_pitch=65),         # odd y pitch: no channel pairs
    dict(c=64, o=64, xp=64, bwd=True, r_pitch=65),
])
def test_packed_legacy_cases(case):
    plan = sm90_plan.packed_plan(2, 37, 53, case["c"], case["o"], torch.bfloat16, case["xp"],
                                 bwd=case.get("bwd", False), aligned=case.get("aligned", True),
                                 y_pitch=case.get("y_pitch"), r_pitch=case.get("r_pitch"))
    assert plan.path == "legacy" and plan.stages == plan.w_stages == 0
    assert plan.tile_o == 64 and plan.partial_rows == 2 * 5 * 2


_PACKED_SHAPES = [(2, 608, 968, 238, 64, 256, False), (2, 608, 968, 64, 64, 64, False),
                  (2, 608, 968, 64, 64, 64, True), (2, 304, 484, 128, 64, 128, False),
                  (2, 152, 242, 256, 128, 256, False), (2, 608, 968, 128, 64, 128, False),
                  (2, 608, 968, 64, 128, 64, False), (1, 13, 37, 64, 128, 64, True),
                  (1, 9, 33, 24, 16, 24, False), (3, 17, 65, 96, 128, 96, True),
                  (1, 21, 40, 256, 64, 256, True), (1, 1, 1, 8, 8, 8, False)]


@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_packed_plans_fit_shared_memory(shape):
    """Each Hopper plan fits an H100 block with the deepest rings that fit;
    weights stay resident exactly where all of them fit beside two halo
    stages (C <= 64 at 64 outputs), and two tiles share a streamed weight
    slice at 64 outputs unless the backward epilogue holds r in registers."""
    n, h, w, c, o, xp, bwd = shape
    plan = sm90_plan.packed_plan(n, h, w, c, o, torch.bfloat16, xp, bwd=bwd)
    assert plan.path == "sm90" and plan.tile_o == (64 if o <= 64 else 128)
    assert plan.resident == (o <= 64 and c <= 64)
    assert plan.tile_rows == (16 if o <= 64 and c > 64 and not bwd else 8)
    tu, chunks = plan.tile_rows // 8, -(-c // 64)
    smem = sm90_plan.k1_smem_bytes(plan.tile_o, tu, plan.resident, chunks, plan.stages,
                                   plan.w_stages)
    assert plan.smem == smem <= sm90_plan.SMEM_LIMIT
    if plan.resident:
        assert plan.w_stages == 0 and plan.stages >= 2
        deeper = sm90_plan.k1_smem_bytes(64, 1, True, chunks, plan.stages + 1, 0)
        assert plan.stages == sm90_plan.K1_MAX_HSTAGES or deeper > sm90_plan.SMEM_LIMIT
    else:
        assert plan.stages == 2 and plan.w_stages >= 2
        deeper = sm90_plan.k1_smem_bytes(plan.tile_o, tu, False, chunks, 2, plan.w_stages + 1)
        assert plan.w_stages == sm90_plan.K1_MAX_WSTAGES or deeper > sm90_plan.SMEM_LIMIT


@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_packed_walk_covers_every_tile_once(shape):
    """The persistent blocks (no more than one per SM, none idle) walk every
    8x32 pixel tile exactly once, and the sums' partial buffer has one row
    per tile, whatever the unit size."""
    n, h, w, c, o, xp, bwd = shape
    plan = sm90_plan.packed_plan(n, h, w, c, o, torch.bfloat16, xp, bwd=bwd)
    tiles = [(i, ty, tx, 0) for i in range(n) for ty in range(-(-h // 8))
             for tx in range(-(-w // 32))]
    assert plan.partial_rows == len(tiles)
    assert plan.units == n * -(-h // plan.tile_rows) * -(-w // 32)
    assert plan.grid == (min(plan.units, sm90_plan.SMS), 1, 1)
    walked = [t for b in range(plan.grid[0]) for t in sm90_plan.packed_tiles(plan, n, h, w, b)]
    assert sorted(walked) == tiles
    assert all(sm90_plan.packed_tiles(plan, n, h, w, b) for b in range(plan.grid[0]))


@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_packed_float32_plans_fit_shared_memory(shape):
    """The float32 Hopper plan (k1f_smem_bytes, mirroring the kernel's sum)
    fits an H100 block with the deepest weight ring that fits beside two
    halo stages; it takes one unit a tile and O tile of 64 (two at 128
    outputs) and streams its weights."""
    n, h, w, c, o, xp, bwd = shape
    plan = sm90_plan.packed_plan(n, h, w, c, o, torch.float32, xp, bwd=bwd)
    assert plan.path == "sm90" and plan.tile_o == (64 if o <= 64 else 128)
    assert (plan.tile_rows, plan.o_units, plan.resident) == (8, plan.tile_o // 64, False)
    assert plan.stages == sm90_plan.K1F_HSTAGES
    assert plan.smem == sm90_plan.k1f_smem_bytes(plan.w_stages) <= sm90_plan.SMEM_LIMIT
    deeper = sm90_plan.k1f_smem_bytes(plan.w_stages + 1)
    assert plan.w_stages == sm90_plan.K1F_MAX_WSTAGES or deeper > sm90_plan.SMEM_LIMIT
    # the halo ring, the weight ring, both sums of 8 warps, the affine, barriers
    assert plan.smem == (1024 + plan.stages * sm90_plan.HALO_SLOT + plan.w_stages * 16384
                         + 2 * 8 * 64 * 4 + 2 * 256 * 4 + (3 * plan.stages + 2 * plan.w_stages) * 8)


@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_packed_float32_walk_covers_every_unit_once(shape):
    """The float32 body's persistent blocks walk every (8x32 tile, O tile of
    64) unit exactly once, and the sums' partial buffer has one row per
    tile."""
    n, h, w, c, o, xp, bwd = shape
    plan = sm90_plan.packed_plan(n, h, w, c, o, torch.float32, xp, bwd=bwd)
    units = [(i, ty, tx, ot) for i in range(n) for ty in range(-(-h // 8))
             for tx in range(-(-w // 32)) for ot in range(plan.o_units)]
    assert plan.partial_rows == len(units) // plan.o_units
    assert plan.units == len(units) and plan.grid == (min(plan.units, sm90_plan.SMS), 1, 1)
    walked = [t for b in range(plan.grid[0]) for t in sm90_plan.packed_tiles(plan, n, h, w, b)]
    assert sorted(walked) == units
    assert all(sm90_plan.packed_tiles(plan, n, h, w, b) for b in range(plan.grid[0]))


# The plain TF32 split of the float32 Hopper bodies' operands.

def _rna_tf32_numpy(x):
    """cvt.rna.tf32.f32 emulated in float64 arithmetic, independently of the
    port's bit manipulation: 11 significant bits (1 implicit + 10 stored),
    rounded to nearest with ties away from zero; normal float32 inputs."""
    x = np.asarray(x, dtype=np.float32).astype(np.float64)
    m, e = np.frexp(np.abs(x))                 # |x| = m * 2**e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return (np.sign(x) * np.ldexp(r, e)).astype(np.float32)


def test_tf32_split_matches_a_numpy_emulation_bit_for_bit():
    """hi = rna_tf32(x) and lo = rna_tf32(x - hi), on random normal numbers of
    many magnitudes and on exact ties (the 13 dropped bits 0x1000), bit for
    bit; hi + lo within 2**-21 of x relative."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * np.exp2(rng.integers(-60, 60, size=4096))).astype(np.float32)
    ties = ((rng.integers(0x0A000000, 0x7F000000, size=512) & ~0x1FFF) | 0x1000).astype(np.uint32)
    ties = np.concatenate([ties, ties | 0x80000000]).view(np.float32)
    x = np.concatenate([x, ties, np.float32([1.0, -1.0, 0.0, 3.0e38, -2.5e-30])])
    hi, lo = _plain.split_tf32_reference(torch.from_numpy(x))
    want_hi = _rna_tf32_numpy(x)
    want_lo = _rna_tf32_numpy((x - want_hi).astype(np.float32))
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    # equal values: the same bits, but for the sign of a zero remainder
    assert np.array_equal(lo.numpy(), want_lo)
    assert np.all(hi.numpy().view(np.uint32) & 0x1FFF == 0)
    assert np.all(lo.numpy().view(np.uint32) & 0x1FFF == 0)
    total = hi.double() + lo.double()
    rel = ((total - torch.from_numpy(x).double()).abs()
           / torch.from_numpy(x).double().abs().clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -21


def test_split_weights_plain_version_is_the_k_major_planes():
    """split_weights_tf32 on CPU tensors (its plain version): (3, 3, C, O) ->
    (2, 9, O, C), plane 0 the hi and plane 1 the lo half of w[dh][dw][c][o]
    at [tap = 3*dh + dw][o][c]."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 7)).astype(np.float32))
    planes = split_weights_tf32(w)
    assert planes.shape == (2, 9, 7, 5) and planes.dtype == torch.float32
    for dh in range(3):
        for dw in range(3):
            hi, lo = _plain.split_tf32_reference(w[dh, dw].t())
            assert torch.equal(planes[0, 3 * dh + dw], hi)
            assert torch.equal(planes[1, 3 * dh + dw], lo)
    with pytest.raises(ValueError, match="float32"):
        split_weights_tf32(w.to(torch.bfloat16))


@pytest.mark.parametrize("c", [61, 238])
def test_split_weights_with_a_chunk_pitch_matches_the_numpy_emulation(c):
    """The split that conv3x3_packed's float32 body runs first, with the
    channel pitch of whole 32-channel chunks (64 for C = 61, 256 for C =
    238: a 952-byte plane row is no TMA stride), on CPU tensors (its plain
    version): hi and lo bit for bit the numpy emulation of cvt.rna.tf32 at
    [tap][o][c], zero from C to the pitch."""
    rng = np.random.default_rng(c)
    o = 24
    w = (rng.normal(size=(3, 3, c, o)) * np.exp2(rng.integers(-20, 20, size=(3, 3, c, o)))
         ).astype(np.float32)
    pitch = -(-c // 32) * 32
    planes = split_weights_tf32(torch.from_numpy(w), pitch).numpy()
    assert planes.shape == (2, 9, o, pitch) and planes.dtype == np.float32
    k_major = w.reshape(9, c, o).transpose(0, 2, 1)
    want_hi = _rna_tf32_numpy(k_major)
    want_lo = _rna_tf32_numpy((k_major - want_hi).astype(np.float32))
    assert np.array_equal(planes[0, :, :, :c].view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(planes[1, :, :, :c], want_lo)
    assert not planes[:, :, :, c:].any()
    with pytest.raises(ValueError, match="pitch"):
        split_weights_tf32(torch.from_numpy(w), c - 1)


# conv3x3_bias_act_shift (kernel 6): the Hopper bodies' plan. No model path
# calls it; its calls are measured at the kernel-2 calls of the steps.

@pytest.mark.parametrize("model,ingest,dtype", [("CubeNET", True, "bf16"), ("UNET", False, "f32"),
                                                ("CubeNET", True, "f32")])
def test_shift_plan_takes_sm90_at_every_kernel2_step_call(model, ingest, dtype):
    """Every conv3x3_bias_act call shape of the bf16 product-loop step and of
    the float32 UNET and CubeNET-64 steps (12 each) takes the Hopper body,
    with its O tile (128 bf16, 64 float32), a band slot per dh and six
    weight stages."""
    calls = [c for c in chip_smoke.training_calls(model, ingest=ingest, dtype=dtype)
             if c["kernel"] == "conv3x3_bias_act"]
    assert len(calls) == 12
    torch_dtype = chip_smoke.DTYPES[dtype]
    for call in calls:
        plan = sm90_plan.shift_plan(*call["shape"], call["o"], torch_dtype)
        assert plan.path == "sm90"
        assert plan.tile_o == (128 if dtype == "bf16" else 64)
        assert (plan.band_stages, plan.stages) == (3, 6)


@pytest.mark.parametrize("case", [
    dict(dtype=torch.bfloat16, c=238, o=64),              # 476-byte pixels
    dict(dtype=torch.bfloat16, c=61, o=64),               # 122-byte pixels
    dict(dtype=torch.float32, c=61, o=64),                # 244-byte pixels
    dict(dtype=torch.float32, c=238, o=128),              # 952-byte pixels
    dict(dtype=torch.bfloat16, c=64, o=20),               # 40-byte weight rows
    dict(dtype=torch.float32, c=64, o=66),                # 264-byte plane rows
    dict(dtype=torch.bfloat16, c=64, o=64, aligned=False),  # origin off 16 bytes
    dict(dtype=torch.float32, c=64, o=64, aligned=False),
])
def test_shift_plan_legacy_cases(case):
    """Layouts TMA cannot address take the synchronous body, whose blocks
    walk O tiles of 64 or 128 on grid z."""
    plan = sm90_plan.shift_plan(2, 37, 53, case["c"], case["o"], case["dtype"],
                                case.get("aligned", True))
    assert plan.path == "legacy" and (plan.band_stages, plan.stages) == (0, 0)
    assert plan.tile_o == (64 if case["o"] <= 64 else 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shift_plan_sm90_off_takes_the_synchronous_body(dtype):
    """sm90=False (what the wrapper passes for `_legacy=True`)."""
    assert sm90_plan.shift_plan(2, 304, 484, 128, 256, dtype).path == "sm90"
    plan = sm90_plan.shift_plan(2, 304, 484, 128, 256, dtype, sm90=False)
    assert (plan.path, plan.tile_o, plan.grid) == ("legacy", 128, (16, 38, 4))
    assert plan.units == 16 * 38 * 4


@pytest.mark.parametrize("shape", _SHAPES)
def test_shift_plans_fit_shared_memory(shape):
    """Both bodies' shared memory fits one H100 block; the Hopper body's sum
    is csrc/conv3x3_shift.cu's k6_smem_bytes term by term: the 1 KiB
    alignment slack, three 8x34-pixel bands of 128-byte rows, six 16 KiB
    weight slices and a full and an empty barrier for each stage of both
    rings."""
    n, h, w, c, o = shape
    for dtype in (torch.bfloat16, torch.float32):
        plan = sm90_plan.shift_plan(n, h, w, c, o, dtype)
        assert 0 < plan.smem <= sm90_plan.SMEM_LIMIT
        if plan.path == "legacy":
            assert plan.smem == (3 * 8 * 34 + 9 * plan.tile_o) * 80
            continue
        assert plan.smem == 1024 + 3 * 8 * 34 * 128 + 6 * 16384 + 2 * (3 + 6) * 8
        assert plan.smem == sm90_plan.k6_smem_bytes()


@pytest.mark.parametrize("shape", _SHAPES)
def test_shift_grid_covers_every_tile_once(shape):
    """Each (image, 8x32 pixel tile, O tile) unit is computed exactly once, on
    either body, at main-path and ragged shapes: by the Hopper body's
    persistent blocks (one per SM, every block with a unit) or by the
    synchronous body's one block each."""
    n, h, w, c, o = shape
    for dtype in (torch.bfloat16, torch.float32):
        for sm90 in (True, False):
            plan = sm90_plan.shift_plan(n, h, w, c, o, dtype, sm90=sm90)
            want = [(i, ty, tx, ot) for i in range(n) for ty in range(-(-h // 8))
                    for tx in range(-(-w // 32)) for ot in range(-(-o // plan.tile_o))]
            gx, gy, gz = plan.grid
            walks = [sm90_plan.shift_tiles(plan, n, h, w, o, b) for b in range(gx * gy * gz)]
            assert plan.units == len(want) and all(walks)
            assert sorted(t for walk in walks for t in walk) == want
            if plan.path == "sm90":
                assert plan.grid == (min(len(want), sm90_plan.SMS), 1, 1)


# The dh-fold probe (row 7): its Hopper body's plan. No model path calls it.
# Shapes (n, hp, wp): the probe's 2x610x1032 buffers, the cuda tests' small
# one and a single-tile one.
_DH_FOLD_SHAPES = [(2, 610, 1032), (1, 66, 264), (1, 10, 72)]


@pytest.mark.parametrize("lanes", [128, 64])
@pytest.mark.parametrize("shape", _DH_FOLD_SHAPES)
def test_dh_fold_plan_takes_sm90(shape, lanes):
    """Aligned operands take the Hopper body: folded (64 lanes) keeps its
    weights resident, current (128) streams them through twelve stages;
    three halo slots; one persistent block per SM, no more than there are
    8x32 tiles."""
    n, hp, wp = shape
    plan = sm90_plan.dh_fold_plan(n, hp, wp, lanes)
    tiles = n * (hp - 2) // 8 * ((wp - 8) // 32)
    assert plan.path == "sm90" and plan.tiles == tiles
    assert plan.resident == (lanes == 64)
    assert (plan.halo_stages, plan.w_stages) == (3, 0 if lanes == 64 else 12)
    assert plan.grid == (min(tiles, sm90_plan.SMS), 1, 1)
    if shape == (2, 610, 1032):
        assert plan.tiles == 4864 and plan.grid == (132, 1, 1)


@pytest.mark.parametrize("lanes", [128, 64])
def test_dh_fold_plan_fits_shared_memory(lanes):
    """The Hopper body's shared memory is csrc/probe_dh_fold.cu's
    k7_smem_bytes term by term (the 1 KiB alignment slack, three halo slots
    of 10x34 pixels of 128 bytes rounded up to 1 KiB, twelve 8 KiB weight
    slots, a full and an empty barrier for each), the same for both kernels,
    and fits one H100 block; so does the synchronous body's."""
    plan = sm90_plan.dh_fold_plan(2, 610, 1032, lanes)
    assert plan.smem == 1024 + 3 * 44032 + 12 * 8192 + 2 * (3 + 12) * 8 == 231_664
    assert plan.smem == sm90_plan.k7_smem_bytes() <= sm90_plan.SMEM_LIMIT
    legacy = sm90_plan.dh_fold_plan(2, 610, 1032, lanes, sm90=False)
    assert legacy.smem == (10 * 66 + 9 * 64) * 80 <= sm90_plan.SMEM_LIMIT


@pytest.mark.parametrize("sm90", [True, False])
@pytest.mark.parametrize("shape", _DH_FOLD_SHAPES)
def test_dh_fold_tiles_cover_every_tile_once(shape, sm90):
    """Each (image, 8x32 tile) of the output is computed exactly once, by the
    Hopper body's persistent blocks (every block with a tile) or by the
    synchronous body's one block per 8x64 tile."""
    n, hp, wp = shape
    plan = sm90_plan.dh_fold_plan(n, hp, wp, 64, sm90=sm90)
    want = [(i, ty, tx) for i in range(n) for ty in range((hp - 2) // 8)
            for tx in range((wp - 8) // 32)]
    gx, gy, gz = plan.grid
    walks = [sm90_plan.dh_fold_tiles(plan, n, hp, wp, b) for b in range(gx * gy * gz)]
    assert plan.tiles == len(want) and all(walks)
    assert sorted(t for walk in walks for t in walk) == want
    if sm90:
        assert [len(walk) for walk in walks] == [len(range(b, len(want), gx)) for b in range(gx)]


@pytest.mark.parametrize("lanes", [128, 64])
@pytest.mark.parametrize("why", ["unaligned", "sm90_off"])
def test_dh_fold_plan_legacy_cases(lanes, why):
    """Unaligned operands (TMA cannot read them) and sm90=False (what the
    wrappers pass for `_legacy=True`) take the synchronous body: one block
    per 8x64 tile, grid (columns / 64, rows / 8, images)."""
    kw = {"aligned": False} if why == "unaligned" else {"sm90": False}
    plan = sm90_plan.dh_fold_plan(2, 610, 1032, lanes, **kw)
    assert (plan.path, plan.resident, plan.halo_stages, plan.w_stages) == ("legacy", False, 0, 0)
    assert plan.grid == (16, 76, 2) and plan.tiles == 4864
