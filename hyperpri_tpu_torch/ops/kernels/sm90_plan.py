"""How a conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad or
conv3x3_bias_act_shift call, or a dh-fold probe call, runs on the card:
which kernel body, with which tiling, ring depths, weight residency,
persistent grid and pixel splits.

Each plan is a pure function of the call's shape, dtype, mode and layout
(frames, strides, alignment), so that the CPU tests can hold it without a
card, and the wrappers choose before the launch, never on a failure.

  - "sm90": the Hopper kernels (csrc/conv3x3_sm90.cuh;
    conv3x3_packed_sm90_kernel and conv3x3_packed_sm90_f32_kernel in
    csrc/conv3x3_packed.cu, conv3x3_sm90_kernel and conv3x3_sm90_f32_kernel
    in csrc/conv3x3.cu, conv3x3_wgrad_sm90_kernel and
    conv3x3_wgrad_sm90_f32_kernel in csrc/conv3x3_grad.cu,
    conv3x3_shift_sm90_kernel and conv3x3_shift_sm90_f32_kernel in
    csrc/conv3x3_shift.cu, dh_fold_sm90_kernel in csrc/probe_dh_fold.cu):
    TMA staging into mbarrier rings and wgmma products (3xTF32 in float32).
    They take views that TMA can address: every stride a multiple of 16
    bytes (a channel pitch that is a multiple of 8 in bf16, of 4 in float32)
    and a 16-byte aligned logical origin. The four conv kernels take them in
    bf16 and float32 (conv3x3_wgrad in its fold mode too, where y's view is
    g's), the probe in bf16.
  - "legacy": the synchronous mma.sync kernels (conv3x3_common.cuh), for
    layouts TMA cannot take (e.g. C = 238 unframed: 476-byte bf16 or
    952-byte float32 pixels).

The shared-memory sums mirror the kernels' (k1_smem_bytes and
k1f_smem_bytes in conv3x3_packed.cu, k2_smem_bytes and k2f_smem_bytes in
conv3x3.cu, k3_smem_bytes and k3f_smem_bytes in conv3x3_grad.cu,
k6_smem_bytes in conv3x3_shift.cu, k7_smem_bytes in probe_dh_fold.cu);
each plan's must fit an H100 block.
`sm90=False` sends a call to the synchronous kernels whatever its layout:
the wrappers pass it for their private `_legacy` keyword, with which the
two bodies are compared with each other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use
SMS = 132              # streaming multiprocessors of an H100 SXM
ALIGN_SLACK = 1024     # the kernels round their shared base up to 1 KiB
TH, TW = 8, 32         # output pixel tile of every conv kernel here
CHUNK = 64             # channels of one staged TMA box row (128 bytes of bf16)
BOX_ROW = 2 * CHUNK
HALO_BYTES = (TH + 2) * (TW + 2) * BOX_ROW
HALO_SLOT = -(-HALO_BYTES // 1024) * 1024
TILE_BYTES = TH * TW * BOX_ROW

# conv3x3_packed_sm90_kernel: persistent blocks walking work units of TU
# 8x32 pixel tiles; the halo of each (unit, 64-channel chunk) in a ring of
# halo stages; the weights (chunk, tap) slices of 64 x NP, resident where all
# of them fit beside a ring of two halo stages, else streamed through a ring
# of their own; TU = 2 at NP = 64 with streamed weights (one slice feeds two
# tiles) unless the backward epilogue holds r in registers.
K1_MAX_CHUNKS = 4
K1_AFFINE_BYTES = 2 * K1_MAX_CHUNKS * CHUNK * 4
K1_MAX_HSTAGES = 4
K1_MAX_WSTAGES = 8
# conv3x3_packed_sm90_f32_kernel: persistent blocks walking work units of one
# 8x32 tile by one O tile of 64 outputs; the halo streamed in 32-channel
# chunks through a ring of two stages; (tap, chunk) weight slices of 64
# outputs in TF32 hi and lo planes (16 KiB) in a ring of 2-8 stages; C <= 256
# (the prologue's affine buffer). Slices and sums' sizes as kernel 2's below.
K1F_HSTAGES = 2
K1F_MAX_WSTAGES = 8
K1F_MAX_C = 256
# conv3x3_sm90_kernel: O tiles of 128 walked inside the block, the whole halo
# resident (at most 4 chunks: C <= 256), weight slices of 16 KiB in a ring of
# 2-4 stages.
K2_N = 128
K2_WSTAGE = K2_N * BOX_ROW
K2_MAX_CHUNKS = 4
K2_MAX_STAGES = 4
K2_RED_BYTES = TH * K2_N * 4
# conv3x3_sm90_f32_kernel: O tiles of 64 walked inside the block, the halo
# streamed in 32-channel chunks (one 128-byte box row of float32) through a
# ring of two stages, staged again for every O tile; (tap, chunk) weight
# slices of 64 outputs x 32 channels in TF32 hi and lo planes (16 KiB) in a
# ring of 2-8 stages; C <= 256 (the prologue's affine buffer).
F32_CHUNK = BOX_ROW // 4
K2F_N = 64
K2F_WSTAGE = 2 * K2F_N * BOX_ROW
K2F_HSTAGES = 2
K2F_MAX_C = 256
K2F_MAX_STAGES = 8
K2F_RED_BYTES = TH * K2F_N * 4
K2F_AFFINE_BYTES = 2 * K2F_MAX_C * 4
# conv3x3_wgrad_sm90_kernel: a ring of whole pixel tiles (x halo + g tile;
# in fold mode + the y tile, beside the O tile's gsum and gsumsq and a row of
# CHUNK db sums for each of the 12 warps: two stages fit, three do not).
# In both weight-gradient kernels a split's float32 accumulators chain the K
# steps of its pixel tiles, and on one-signed terms (a step's cotangents)
# dW's rounding grows about linearly with that chain: no split takes more
# than K3_MAX_CHAIN tiles (256 pixels each), where the float64 check keeps a
# margin of 1.5 (PERF.md §6; 37 tiles missed it).
K3_STAGE = HALO_SLOT + TILE_BYTES
K3_MAX_STAGES = 3
K3_WARPS = 12
K3_FOLD_BYTES = 2 * CHUNK * 4 + K3_WARPS * CHUNK * 4
K3_MAX_CHAIN = 19
# conv3x3_wgrad_sm90_f32_kernel: a ring of two x halos (64 channels: two
# 32-channel boxes), the g tile a unit at a time, raw and as TF32 hi and lo
# planes of g^T: a quarter (2 pixel rows) in one 16 KiB raw buffer; in fold
# mode one pixel row of gy and y (16 KiB together) in a ring of two, planes
# of one row, the O tile's gsum and gsumsq and 4 db sums for each of the 128
# transposers.
K3F_HSTAGES = 2
K3F_RAW = 2 * 2 * TW * BOX_ROW
K3F_PLANE = 2 * 64 * BOX_ROW
K3F_FOLD_RAW_STAGES = 2
K3F_FOLD_BYTES = 2 * 64 * 4 + 128 * 4 * 4
# conv3x3_shift_sm90_kernel and conv3x3_shift_sm90_f32_kernel: persistent
# blocks, one per SM, walking work units of one 8x32 tile by one O tile (128
# outputs in bf16, 64 in float32), the O tiles of a pixel tile adjacent in
# the walk; the three dh bands of each chunk
# (8 x 34 pixels of one 128-byte box row: 64 bf16 or 32 float32 channels) in
# a ring of one slot per dh, the (tap, chunk) weight slices (16 KiB in
# either dtype) in a ring of six stages, the slices of two bands; a fixed
# layout, so every ring address is a constant offset. Bands stream, so C has
# no cap.
K6_BAND_BYTES = TH * (TW + 2) * BOX_ROW
K6_BSTAGES = 3
K6_WSTAGES = 6
K6_WSTAGE = K2_WSTAGE
# dh_fold_sm90_kernel (the dh-fold probe, both kernels): persistent blocks,
# one per SM, walking the 8x32 output tiles; a ring of three halo slots (one
# 64-lane box of 10 x 34 pixels of the pre-padded buffer each) and twelve
# 8 KiB weight slots (64 channels x 64 outputs of W, read in place): folded's
# twelve boxes resident, current's (chunk, dh, dw) slices streamed through
# them; one fixed layout for both.
K7_HSTAGES = 3
K7_WSLOTS = 12
K7_WBOX = CHUNK * 64 * 2
# the synchronous kernels
LEGACY_ROW_BYTES = 80
LEGACY_HALO_PIX = (TH + 2) * (TW + 2)
LEGACY_WGRAD_ROW = 72          # elements a staged row: 64 channels + 8
LEGACY_TARGET_BLOCKS = 2 * SMS
MAX_PARTIAL_BYTES = 1 << 28


class BiasActPlan(NamedTuple):
    path: str                     # "sm90" or "legacy"
    tile_o: int                   # output channels of one pass (NP)
    stages: int                   # weight ring depth (sm90), 0 for legacy
    grid: Tuple[int, int, int]
    partial_rows: int             # rows of the statistics' partial buffer
    smem: int                     # dynamic shared memory of a block


class PackedPlan(NamedTuple):
    path: str                     # "sm90" or "legacy"
    tile_o: int                   # output channels of the tile (NP)
    tile_rows: int                # pixel rows of a work unit: 8 * TU (8 for legacy)
    o_units: int                  # work units a tile's NP outputs make (float32 sm90: NP / 64)
    resident: bool                # the weights stay in shared memory (sm90)
    stages: int                   # halo ring depth (sm90), 0 for legacy
    w_stages: int                 # weight ring depth (sm90, streamed), else 0
    grid: Tuple[int, int, int]
    units: int                    # work units the blocks walk (legacy: one per block)
    partial_rows: int             # rows of the sums' partial buffer: one per 8x32 tile
    smem: int                     # dynamic shared memory of a block


class ShiftPlan(NamedTuple):
    path: str                     # "sm90" or "legacy"
    tile_o: int                   # output channels of a work unit or block (NP)
    band_stages: int              # band ring depth (sm90), 0 for legacy
    stages: int                   # weight ring depth (sm90), 0 for legacy
    grid: Tuple[int, int, int]
    units: int                    # (8x32 tile, O tile) work units
    smem: int                     # dynamic shared memory of a block


class DhFoldPlan(NamedTuple):
    path: str                     # "sm90" or "legacy"
    resident: bool                # the weights stay in shared memory (sm90 folded)
    halo_stages: int              # halo ring depth (sm90), 0 for legacy
    w_stages: int                 # weight ring depth (sm90 current), else 0
    grid: Tuple[int, int, int]
    tiles: int                    # 8x32 output tiles of the call
    smem: int                     # dynamic shared memory of a block


class WgradPlan(NamedTuple):
    path: str                     # "sm90" or "legacy"
    splits: int                   # blocks along the pixel axis
    tiles: int                    # 8x32 pixel tiles of the call
    tiles_per_split: int
    stages: int                   # ring depth (sm90), 0 for legacy
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k1_halo_slot(tu: int) -> int:
    return _cdiv((TH * tu + 2) * (TW + 2) * BOX_ROW, 1024) * 1024


def k1_smem_bytes(tile_o: int, tu: int, resident: bool, n_chunks: int, hstages: int,
                  wstages: int) -> int:
    wslots = 9 * n_chunks if resident else wstages
    wbars = 1 if resident else wstages
    return (ALIGN_SLACK + wslots * tile_o * BOX_ROW + hstages * k1_halo_slot(tu)
            + 2 * tu * TH * tile_o * 4 + K1_AFFINE_BYTES + (2 * wbars + 3 * hstages) * 8)


def k1f_smem_bytes(wstages: int) -> int:
    return (ALIGN_SLACK + K1F_HSTAGES * HALO_SLOT + wstages * K2F_WSTAGE
            + 2 * TH * K2F_N * 4 + K2F_AFFINE_BYTES + (3 * K1F_HSTAGES + 2 * wstages) * 8)


def k2_smem_bytes(n_chunks: int, stages: int) -> int:
    return (ALIGN_SLACK + n_chunks * HALO_SLOT + stages * K2_WSTAGE + K2_RED_BYTES
            + (2 * K2_MAX_CHUNKS + 2 * stages) * 8)


def k2f_smem_bytes(stages: int) -> int:
    return (ALIGN_SLACK + K2F_HSTAGES * HALO_SLOT + stages * K2F_WSTAGE + K2F_RED_BYTES
            + K2F_AFFINE_BYTES + (3 * K2F_HSTAGES + 2 * stages) * 8)


def k6_smem_bytes() -> int:
    return (ALIGN_SLACK + K6_BSTAGES * K6_BAND_BYTES + K6_WSTAGES * K6_WSTAGE
            + 2 * (K6_BSTAGES + K6_WSTAGES) * 8)


def k7_smem_bytes() -> int:
    return (ALIGN_SLACK + K7_HSTAGES * HALO_SLOT + K7_WSLOTS * K7_WBOX
            + 2 * (K7_HSTAGES + K7_WSLOTS) * 8)


def k3_smem_bytes(stages: int, fold: bool = False) -> int:
    stage = K3_STAGE + (TILE_BYTES if fold else 0)
    return (ALIGN_SLACK + stages * stage + 2 * CHUNK * 4 + (K3_FOLD_BYTES if fold else 0)
            + 2 * stages * 8)


def k3f_smem_bytes(fold: bool = False) -> int:
    raw_stages = K3F_FOLD_RAW_STAGES if fold else 1
    plane = K3F_PLANE // 2 if fold else K3F_PLANE
    return (ALIGN_SLACK + K3F_HSTAGES * 2 * HALO_SLOT + raw_stages * K3F_RAW + 2 * plane
            + 2 * 2 * F32_CHUNK * 4 + (K3F_FOLD_BYTES if fold else 0)
            + (K3F_HSTAGES + raw_stages) * 8)


def tma_view_ok(pitch: int, aligned: bool, esize: int = 2) -> bool:
    """An NHWC view of `esize`-byte elements TMA can address: pixel stride
    (pitch * esize bytes) a multiple of 16, so every row and image stride
    and, with the buffer's base 16-byte aligned (`aligned`), the logical
    origin are too."""
    return pitch * esize % 16 == 0 and aligned


def _esize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def packed_plan(n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype, x_pitch: int,
                bwd: bool = False, aligned: bool = True, sm90: bool = True,
                y_pitch: Optional[int] = None, r_pitch: Optional[int] = None) -> PackedPlan:
    """The plan of conv3x3_packed for logical (n, h, w) images of c input
    and o <= 128 output channels, x in a view of channel pitch x_pitch and y
    and (with the backward epilogue, `bwd`) r in views of y_pitch and r_pitch
    (their frames'; o when None); `aligned`: the data pointers of x's buffer
    and of the (3, 3, c, o) weights, which the Hopper kernel reads in place
    by TMA, are 16-byte aligned. The Hopper bodies take a TMA view of x,
    even y and r pitches (their stores and loads take channel pairs) and c
    <= 256; in bf16 also o % 8 == 0 (TMA strides of the weights), in float32
    an even o (the weights' TF32 planes, which the call writes, have a
    pitch of whole 32-channel chunks). They launch one persistent block per
    SM (no more than there are work units), the rings as deep as the shared
    memory allows."""
    tile_o = 64 if o <= 64 else 128
    tiles = n * _cdiv(h, TH) * _cdiv(w, TW)
    n_chunks = _cdiv(c, CHUNK)
    pairs = all(p % 2 == 0 for p in (y_pitch or o, r_pitch or o))
    if (sm90 and dtype == torch.float32 and c <= K1F_MAX_C and pairs and o % 2 == 0
            and tma_view_ok(x_pitch, aligned, 4)):
        wstages = max(s for s in range(2, K1F_MAX_WSTAGES + 1)
                      if s == 2 or k1f_smem_bytes(s) <= SMEM_LIMIT)
        units = tiles * (tile_o // K2F_N)
        return PackedPlan("sm90", tile_o, TH, tile_o // K2F_N, False, K1F_HSTAGES, wstages,
                          (min(units, SMS), 1, 1), units, tiles,
                          k1f_smem_bytes(wstages))
    if (sm90 and dtype == torch.bfloat16 and n_chunks <= K1_MAX_CHUNKS and pairs
            and tma_view_ok(x_pitch, aligned) and tma_view_ok(o, aligned)):
        resident = tile_o == 64 and k1_smem_bytes(64, 1, True, n_chunks, 2, 0) <= SMEM_LIMIT
        tu = 2 if tile_o == 64 and not resident and not bwd else 1
        if resident:
            wstages = 0
            hstages = max(s for s in range(2, K1_MAX_HSTAGES + 1)
                          if s == 2 or k1_smem_bytes(64, 1, True, n_chunks, s, 0) <= SMEM_LIMIT)
        else:
            hstages = 2
            wstages = max(s for s in range(2, K1_MAX_WSTAGES + 1)
                          if s == 2 or k1_smem_bytes(tile_o, tu, False, n_chunks, 2, s)
                          <= SMEM_LIMIT)
        units = n * _cdiv(h, TH * tu) * _cdiv(w, TW)
        return PackedPlan("sm90", tile_o, TH * tu, 1, resident, hstages, wstages,
                          (min(units, SMS), 1, 1), units, tiles,
                          k1_smem_bytes(tile_o, tu, resident, n_chunks, hstages, wstages))
    return PackedPlan("legacy", tile_o, TH, 1, False, 0, 0, (_cdiv(w, TW), _cdiv(h, TH), n), tiles,
                      tiles, (LEGACY_HALO_PIX + 9 * tile_o) * LEGACY_ROW_BYTES)


def packed_tiles(plan: PackedPlan, n: int, h: int, w: int, block: int):
    """The (image, tile row, tile column, O tile) of the 8x32 pixel tiles
    that block `block` of an sm90 plan computes, in its order: units block,
    block + grid, ... (the kernels' walks: a bf16 unit is 1-2 vertically
    adjacent tiles, whose tiles past the image are skipped, with all NP
    outputs, O tile 0; a float32 unit one tile by one O tile of 64, the O
    tiles of a tile adjacent)."""
    tu = plan.tile_rows // TH
    tiles_h, tiles_w = _cdiv(h, TH), _cdiv(w, TW)
    units_h = _cdiv(h, plan.tile_rows)
    out = []
    for u in range(block, plan.units, plan.grid[0]):
        t, ot = divmod(u, plan.o_units)
        t, ux = divmod(t, tiles_w)
        image, uy = divmod(t, units_h)
        out += [(image, uy * tu + j, ux, ot) for j in range(tu) if uy * tu + j < tiles_h]
    return out


def bias_act_plan(n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype,
                  aligned: bool = True, sm90: bool = True) -> BiasActPlan:
    """The plan of conv3x3_bias_act on an unframed (n, h, w, c) x with o
    outputs; `aligned`: the data pointers of x and of the (3, 3, c, o)
    weights, which the bf16 Hopper kernel reads in place, are 16-byte
    aligned (the float32 one reads the weights' TF32 planes, which the call
    writes). Both Hopper bodies take C <= 256 and TMA views of x and of the
    weights' rows (c and o); bf16 walks O tiles of 128 over a resident halo,
    float32 O tiles of 64 over a streamed one."""
    tiles_h, tiles_w = _cdiv(h, TH), _cdiv(w, TW)
    n_chunks = _cdiv(c, CHUNK)
    esize = _esize(dtype)
    tma = tma_view_ok(c, aligned, esize) and tma_view_ok(o, aligned, esize)
    if sm90 and tma and dtype == torch.bfloat16 and n_chunks <= K2_MAX_CHUNKS:
        stages = max(s for s in range(2, K2_MAX_STAGES + 1)
                     if s == 2 or k2_smem_bytes(n_chunks, s) <= SMEM_LIMIT)
        return BiasActPlan("sm90", K2_N, stages, (tiles_w, tiles_h, n),
                           n * tiles_h * tiles_w, k2_smem_bytes(n_chunks, stages))
    if sm90 and tma and dtype == torch.float32 and c <= K2F_MAX_C:
        stages = max(s for s in range(2, K2F_MAX_STAGES + 1)
                     if s == 2 or k2f_smem_bytes(s) <= SMEM_LIMIT)
        return BiasActPlan("sm90", K2F_N, stages, (tiles_w, tiles_h, n),
                           n * tiles_h * tiles_w, k2f_smem_bytes(stages))
    tile_o = 64 if o <= 64 else 128
    return BiasActPlan("legacy", tile_o, 0, (tiles_w, tiles_h, n * _cdiv(o, tile_o)),
                       n * tiles_h * tiles_w,
                       (LEGACY_HALO_PIX + 9 * tile_o) * LEGACY_ROW_BYTES)


def shift_plan(n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype,
               aligned: bool = True, sm90: bool = True) -> ShiftPlan:
    """The plan of conv3x3_bias_act_shift on an unframed (n, h, w, c) x with o
    outputs; `aligned`: the data pointers of x and of the (3, 3, c, o)
    weights in x's dtype are 16-byte aligned. The Hopper bodies take TMA
    views of x and of the weights' rows (c and o multiples of 8 in bf16, of
    4 in float32) and launch one persistent block per SM (no more than there
    are units); other layouts (e.g. c = 238 in bf16, c = 61) take the
    synchronous body, one block per (pixel tile, O tile), the O tiles on
    grid z."""
    tiles_h, tiles_w = _cdiv(h, TH), _cdiv(w, TW)
    esize = _esize(dtype)
    if (sm90 and dtype in (torch.bfloat16, torch.float32)
            and tma_view_ok(c, aligned, esize) and tma_view_ok(o, aligned, esize)):
        tile_o = K2_N if dtype == torch.bfloat16 else K2F_N
        units = n * tiles_h * tiles_w * _cdiv(o, tile_o)
        return ShiftPlan("sm90", tile_o, K6_BSTAGES, K6_WSTAGES, (min(units, SMS), 1, 1), units,
                         k6_smem_bytes())
    tile_o = 64 if o <= 64 else 128
    n_otiles = _cdiv(o, tile_o)
    return ShiftPlan("legacy", tile_o, 0, 0, (tiles_w, tiles_h, n * n_otiles),
                     n * tiles_h * tiles_w * n_otiles,
                     (3 * TH * (TW + 2) + 9 * tile_o) * LEGACY_ROW_BYTES)


def shift_tiles(plan: ShiftPlan, n: int, h: int, w: int, o: int, block: int):
    """The (image, tile row, tile column, O tile) units that block `block` of
    the plan's grid (x-major) computes, in its order: for sm90 the units
    block, block + grid, ... of a walk whose O tiles run fastest, then tile
    columns, rows and images (the kernels' unit_at); for legacy its one
    unit."""
    n_otiles = _cdiv(o, plan.tile_o)
    tiles_h, tiles_w = _cdiv(h, TH), _cdiv(w, TW)
    if plan.path == "legacy":
        x, rest = block % plan.grid[0], block // plan.grid[0]
        y, z = rest % plan.grid[1], rest // plan.grid[1]
        return [(z // n_otiles, y, x, z % n_otiles)]
    out = []
    for u in range(block, plan.units, plan.grid[0]):
        t, ot = divmod(u, n_otiles)
        t, tx = divmod(t, tiles_w)
        image, ty = divmod(t, tiles_h)
        out.append((image, ty, tx, ot))
    return out


def dh_fold_plan(n: int, hp: int, wp: int, lanes: int, aligned: bool = True,
                 sm90: bool = True) -> DhFoldPlan:
    """The plan of a dh-fold probe call (probe_dh_fold.current at lanes =
    128, folded at 64) on an (n, hp, wp, lanes) pre-padded bf16 buffer, its
    (n, hp - 2, wp - 8, 64) output in 8x32 tiles; `aligned`: the data
    pointers of x and the weights, which the Hopper kernel reads in place by
    TMA, are 16-byte aligned. The Hopper body launches one persistent block
    per SM (no more than there are tiles); the synchronous body one block
    per 8x64 tile."""
    ho, wo = hp - 2, wp - 8
    tiles = n * (ho // TH) * (wo // TW)
    if sm90 and aligned:
        resident = lanes == 64
        return DhFoldPlan("sm90", resident, K7_HSTAGES, 0 if resident else K7_WSLOTS,
                          (min(tiles, SMS), 1, 1), tiles, k7_smem_bytes())
    return DhFoldPlan("legacy", False, 0, 0, (wo // (2 * TW), ho // TH, n), tiles,
                      ((TH + 2) * (2 * TW + 2) + 9 * 64) * LEGACY_ROW_BYTES)


def dh_fold_tiles(plan: DhFoldPlan, n: int, hp: int, wp: int, block: int):
    """The (image, tile row, tile column) of the 8x32 output tiles that block
    `block` of the plan's grid (x-major) computes, in its order: for sm90 the
    tiles block, block + grid, ... of a walk whose columns run fastest, then
    rows and images (the kernel's tile_at); for legacy the two 8x32 halves of
    its 8x64 tile."""
    ho, wo = hp - 2, wp - 8
    tiles_h, tiles_w = ho // TH, wo // TW
    if plan.path == "legacy":
        x, rest = block % plan.grid[0], block // plan.grid[0]
        y, z = rest % plan.grid[1], rest // plan.grid[1]
        return [(z, y, 2 * x), (z, y, 2 * x + 1)]
    out = []
    for u in range(block, plan.tiles, plan.grid[0]):
        t, tx = divmod(u, tiles_w)
        image, ty = divmod(t, tiles_h)
        out.append((image, ty, tx))
    return out


def wgrad_plan(n: int, h: int, w: int, c: int, o: int, dtype: torch.dtype, x_pitch: int,
               g_pitch: int, fold: bool = False, aligned: bool = True,
               sm90: bool = True, y_pitch: Optional[int] = None,
               y_aligned: bool = True) -> WgradPlan:
    """The plan of conv3x3_wgrad for logical (n, h, w) images of c input and o
    output channels, x and g in views of channel pitch x_pitch and g_pitch
    (their frames'); `aligned`: both buffers' data pointers are 16-byte
    aligned. In fold mode y lies in a view of channel pitch y_pitch (g's
    when None) and `y_aligned` says the same of its buffer; the Hopper
    bodies read it through g's frame, so they take it only at g's pitch.
    The splits: at least enough that none chains more than
    K3_MAX_CHAIN pixel tiles; beyond that the synchronous kernel aims at two
    blocks per SM, and the sm90 kernel, one block per SM (its ring fills the
    shared memory), fills the waves of blocks over the (C tile, O tile)
    pairs that the least count needs; both no more than there are pixel
    tiles and within a bounded partial buffer (for sm90 every split has
    tiles). The Hopper bodies (bf16 and float32) take every call whose views
    TMA can address, the fold mode with the splits of the same call without
    it (so that its dW has the non-fold body's bits on the materialized
    g_eff)."""
    tiles = n * _cdiv(h, TH) * _cdiv(w, TW)
    co_blocks = _cdiv(c, CHUNK) * _cdiv(o, CHUNK)
    by_memory = max(1, MAX_PARTIAL_BYTES // (36 * c * o))
    least = _cdiv(tiles, K3_MAX_CHAIN)
    esize = _esize(dtype)
    y_pitch = g_pitch if y_pitch is None else y_pitch
    sm90 = (sm90 and tma_view_ok(x_pitch, aligned, esize)
            and tma_view_ok(g_pitch, aligned, esize)
            and (not fold or (y_pitch == g_pitch and tma_view_ok(y_pitch, y_aligned, esize))))
    if sm90:
        if dtype == torch.bfloat16:
            stages = max(s for s in range(2, K3_MAX_STAGES + 1)
                         if s == 2 or k3_smem_bytes(s, fold) <= SMEM_LIMIT)
            smem = k3_smem_bytes(stages, fold)
        else:
            stages, smem = K3F_HSTAGES, k3f_smem_bytes(fold)
        waves = _cdiv(least * co_blocks, SMS)
        target = waves * SMS // co_blocks
    else:
        stages, target = 0, max(least, _cdiv(LEGACY_TARGET_BLOCKS, co_blocks))
        smem = ((LEGACY_HALO_PIX + TH * TW) * LEGACY_WGRAD_ROW * esize
                + ((2 * CHUNK + 256 * (16 // esize)) * 4 if fold else 0))
    splits = max(1, min(tiles, target, by_memory))
    per_split = _cdiv(tiles, splits)
    if sm90:
        splits = _cdiv(tiles, per_split)   # no split without a tile
    return WgradPlan("sm90" if sm90 else "legacy", splits, tiles, per_split, stages, smem)
