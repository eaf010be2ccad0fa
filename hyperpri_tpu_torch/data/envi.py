"""Minimal, dependency-free ENVI hyperspectral cube I/O (the port's copy of
hyperpri_tpu/data/envi.py, numpy only).

Parse the text .hdr once and materialize only the requested band window in
(H, W, B) channel-last order, the NHWC layout the models consume: through
the native C++ reader (data/native_io.py, built at first use) by default,
or through np.memmap with `use_native=False`.

ENVI header keys honored: samples, lines, bands, interleave (bil|bip|bsq),
data type, byte order, header offset. `envi_support_nonlowercase_params`
behavior (kfold_train.py:30) is the default: keys are case-normalized.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

# ENVI data-type codes -> numpy dtypes.
ENVI_DTYPES = {
    1: np.uint8,
    2: np.int16,
    3: np.int32,
    4: np.float32,
    5: np.float64,
    12: np.uint16,
    13: np.uint32,
    14: np.int64,
    15: np.uint64,
}


@dataclass(frozen=True)
class EnviHeader:
    samples: int  # columns (W)
    lines: int  # rows (H)
    bands: int
    dtype: np.dtype
    interleave: str  # 'bil' | 'bip' | 'bsq'
    byte_order: int  # 0 little, 1 big
    header_offset: int
    extras: Dict[str, str]

    @property
    def shape_hwb(self):
        return (self.lines, self.samples, self.bands)


def parse_envi_header(path: str) -> EnviHeader:
    """Parse an ENVI .hdr text file.

    Handles `key = value` lines, multi-line `{ ... }` blocks, and is
    case-insensitive in keys (matching spectral's non-lowercase tolerance).
    """
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if not text.lstrip().lower().startswith("envi"):
        raise ValueError(f"{path}: not an ENVI header (missing 'ENVI' magic)")

    # Collapse { ... } blocks onto one line so the simple splitter works.
    text = re.sub(r"\{[^}]*\}", lambda m: m.group(0).replace("\n", " "), text)

    fields: Dict[str, str] = {}
    for line in text.splitlines()[1:]:
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        fields[key.strip().lower()] = value.strip()

    def geti(key, default=None):
        if key in fields:
            return int(float(fields[key]))
        if default is None:
            raise KeyError(f"{path}: missing required ENVI field '{key}'")
        return default

    code = geti("data type")
    if code not in ENVI_DTYPES:
        raise ValueError(f"{path}: unsupported ENVI data type {code}")
    interleave = fields.get("interleave", "bil").lower()
    if interleave not in ("bil", "bip", "bsq"):
        raise ValueError(f"{path}: unsupported interleave {interleave!r}")

    return EnviHeader(
        samples=geti("samples"),
        lines=geti("lines"),
        bands=geti("bands"),
        dtype=np.dtype(ENVI_DTYPES[code]),
        interleave=interleave,
        byte_order=geti("byte order", 0),
        header_offset=geti("header offset", 0),
        extras={k: v for k, v in fields.items()},
    )


def open_memmap(hdr: EnviHeader, dat_path: str) -> np.memmap:
    """Memory-map the raw cube in its native interleave order."""
    dtype = hdr.dtype.newbyteorder(">" if hdr.byte_order == 1 else "<")
    shapes = {
        "bsq": (hdr.bands, hdr.lines, hdr.samples),
        "bil": (hdr.lines, hdr.bands, hdr.samples),
        "bip": (hdr.lines, hdr.samples, hdr.bands),
    }
    expected = hdr.lines * hdr.samples * hdr.bands * dtype.itemsize + hdr.header_offset
    actual = os.path.getsize(dat_path)
    if actual < expected:
        raise ValueError(
            f"{dat_path}: file too small for header ({actual} < {expected} bytes)"
        )
    return np.memmap(
        dat_path, mode="r", dtype=dtype, offset=hdr.header_offset, shape=shapes[hdr.interleave]
    )


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype, or torch.float32 / torch.float64, as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def read_cube(
    hdr_path: str,
    dat_path: str,
    band_lo: int = 0,
    band_hi: Optional[int] = None,
    dtype=np.float32,
    use_native: bool = True,
):
    """Read bands [band_lo, band_hi) as a contiguous (H, W, B) array,
    channel-last from the start: a numpy array in `dtype`, or, for
    torch.bfloat16, a torch.bfloat16 tensor (numpy has no bfloat16).

    Float32 and bfloat16 go through the native reader (data/native_io.py),
    whose float32 bytes are the numpy reader's and whose bfloat16 bits are
    the float32 read rounded by torch's cast (nearest even) for finite
    values. The numpy reader runs only with `use_native=False`, for another
    output dtype, or for a header whose data type or interleave the native
    reader does not take; a failed build or read raises."""
    hdr = parse_envi_header(hdr_path)
    if band_hi is None:
        band_hi = hdr.bands
    if not (0 <= band_lo < band_hi <= hdr.bands):
        raise ValueError(f"invalid band window [{band_lo}, {band_hi}) of {hdr.bands}")
    expected = hdr.lines * hdr.samples * hdr.bands * hdr.dtype.itemsize + hdr.header_offset
    actual = os.path.getsize(dat_path)
    if actual < expected:
        raise ValueError(f"{dat_path}: file too small for header ({actual} < {expected} bytes)")
    bf16 = dtype == torch.bfloat16
    if use_native:
        from hyperpri_tpu_torch.data import native_io

        if native_io.native_supports(hdr) and (bf16 or numpy_dtype(dtype) == np.float32):
            return native_io.read_cube_native(hdr, dat_path, band_lo, band_hi, dtype)

    mm = open_memmap(hdr, dat_path)
    if hdr.interleave == "bsq":
        cube = np.transpose(mm[band_lo:band_hi], (1, 2, 0))
    elif hdr.interleave == "bil":
        cube = np.transpose(mm[:, band_lo:band_hi, :], (0, 2, 1))
    else:  # bip
        cube = mm[:, :, band_lo:band_hi]
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(cube, dtype=np.float32)).to(torch.bfloat16)
    return np.ascontiguousarray(cube, dtype=numpy_dtype(dtype))


def write_envi(
    hdr_path: str,
    dat_path: str,
    cube_hwb: np.ndarray,
    interleave: str = "bil",
    description: str = "hyperpri_tpu synthetic cube",
) -> None:
    """Write an (H, W, B) array as an ENVI .hdr/.dat pair (test fixtures)."""
    h, w, b = cube_hwb.shape
    dtype_code = {v: k for k, v in ENVI_DTYPES.items()}[cube_hwb.dtype.type]
    arrs = {
        "bsq": np.transpose(cube_hwb, (2, 0, 1)),
        "bil": np.transpose(cube_hwb, (0, 2, 1)),
        "bip": cube_hwb,
    }
    arrs[interleave].tofile(dat_path)
    with open(hdr_path, "w") as f:
        f.write(
            "ENVI\n"
            f"description = {{{description}}}\n"
            f"samples = {w}\n"
            f"lines = {h}\n"
            f"bands = {b}\n"
            "header offset = 0\n"
            "file type = ENVI Standard\n"
            f"data type = {dtype_code}\n"
            f"interleave = {interleave}\n"
            "byte order = 0\n"
        )
