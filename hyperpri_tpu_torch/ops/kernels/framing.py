"""Framed NHWC views: the port of the JAX package's pre-padded ingest and arena
geometries (hyperpri_tpu/ops/pallas/conv3x3_packed.py:376-391 and :359-374).

A framed tensor is a buffer (N, rows, cols, pitch) whose logical (N, H, W, C)
content starts at (r0, c0) and occupies the first C channels; everything else
is frame. Two framings exist, with the JAX package's offsets so buffers can
move between the two packages:
  - the host pre-padded ingest buffer: logical (0,0) at (1,1), zeros
    everywhere else, channel pitch round_up(C, 32) (256 for CubeNET's 238
    bands), written by the data pipeline so the first conv's 16-byte loads
    need no pad pass on the card;
  - an arena: logical (0,0) at (8,8) inside (N, 8+Eh+8, 8+Ew+8, round_up(C, 8)),
    which on the TPU a producer kernel writes and a consumer kernel reads in
    place, without the slice and pad passes between them. The CUDA kernels
    need no pad pass, so the port's model hands over unframed tensors; the
    kernels' arena modes take buffers from the JAX package.
The CUDA kernels take a frame as {rows, cols, pitch, r0, c0} and read only the
logical region, so any buffer that covers it works, this geometry's or the
JAX package's. The extent (Eh, Ew) follows the CUDA kernels' 8x32 pixel tile,
not the TPU's VMEM tiling.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

ARENA_OFFSET = 8    # logical (0,0) of an arena sits at (8, 8)
INGEST_OFFSET = 1   # and of the host pre-padded ingest buffer at (1, 1)
TILE_H, TILE_W = 8, 32  # the CUDA conv kernels' output pixel tile
INGEST_LANES = 32   # the conv kernels' input-channel chunk


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Frame(NamedTuple):
    """Where a logical (N, H, W, C) tensor sits in its buffer."""

    rows: int
    cols: int
    pitch: int
    r0: int = 0
    c0: int = 0

    @classmethod
    def of(cls, buf: torch.Tensor, offset: int = 0) -> "Frame":
        """The frame of a contiguous NHWC buffer with the logical origin at
        (offset, offset)."""
        if buf.dim() != 4:
            raise ValueError(f"need an NHWC buffer, got shape {tuple(buf.shape)}")
        return cls(buf.shape[1], buf.shape[2], buf.shape[3], offset, offset)

    def check(self, name: str, h: int, w: int, c: int):
        """Raise unless the frame covers a logical (h, w, c) image and an image
        of it is indexable in 32 bits, as the kernels index it."""
        if not (self.rows >= self.r0 + h and self.cols >= self.c0 + w and self.pitch >= c):
            raise ValueError(f"{name}: buffer {(self.rows, self.cols, self.pitch)} with origin "
                             f"{(self.r0, self.c0)} does not cover logical {(h, w, c)}")
        if self.rows * self.cols * self.pitch >= 2 ** 31:
            raise ValueError(f"{name}: an image of {(self.rows, self.cols, self.pitch)} "
                             "elements is past the kernels' 32-bit indexing")

    def logical(self, buf: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
        """The logical (N, h, w, c) view of `buf` (no copy)."""
        return buf[:, self.r0:self.r0 + h, self.c0:self.c0 + w, :c]


def frames_arg(*frames: Frame):
    """The frames as the C entry points take them: a flat int array."""
    flat = [v for f in frames for v in f]
    return (ctypes.c_int * len(flat))(*flat)


def arena_extent(h: int, w: int) -> Tuple[int, int]:
    """(Eh, Ew): the tile cover of a logical (h, w) map, so an arena buffer is
    (n, 8 + Eh + 8, 8 + Ew + 8, round_up(c, 8))."""
    return round_up(h, TILE_H), round_up(w, TILE_W)


def arena_shape(n: int, h: int, w: int, c: int) -> Tuple[int, int, int, int]:
    eh, ew = arena_extent(h, w)
    return (n, 2 * ARENA_OFFSET + eh, 2 * ARENA_OFFSET + ew, round_up(c, 8))


def ingest_spec(h: int, w: int, c: int):
    """((H_pad, W_pad, C_pad), (row0, col0), (h, w, c)): the host pre-padded
    buffer of one (h, w, c) cube, in the layout of the JAX package's
    first_conv_ingest_spec (the logical dims last, so the pipeline can reject
    a batch whose crop drifted from them)."""
    return ((h + 2 * INGEST_OFFSET, w + 2 * INGEST_OFFSET, round_up(c, INGEST_LANES)),
            (INGEST_OFFSET, INGEST_OFFSET), (h, w, c))
