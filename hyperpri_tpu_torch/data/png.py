"""A small PNG codec with the standard library's zlib: the port's stand-in for
PIL, which the JAX package calls for masks and RGB images
(hyperpri_tpu/data/dataset.py:35-46, data/synthetic.py make_box).

Decodes 8-bit gray, gray+alpha, RGB and RGBA images without interlace, with
any of the five row filters; encodes gray, RGB and RGBA with filter 0 (none)
and zlib level 6. `load_png(path, mode)` converts like PIL's
`Image.open(path).convert(mode)` for the modes the data layer uses: "L" (gray,
ITU-R 601-2 luma in PIL's integer form) and "RGB".
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # colour type -> samples a pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def _unfilter_sequential(kind: int, filt: bytes, prior: bytes, bpp: int) -> bytes:
    """Average (3) and Paeth (4) rows: each byte depends on the reconstructed
    byte bpp to its left, so they are undone byte by byte."""
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return bytes(out)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array (H, W) for gray, else (H, W, channels)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit gray/RGB(A), no interlace)")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data is {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            row = filt
        elif kind == 1:   # Sub: a running sum per channel, modulo 256
            row = np.cumsum(filt.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            row = filt + prior
        elif kind in (3, 4):
            row = np.frombuffer(_unfilter_sequential(kind, filt.tobytes(), prior.tobytes(),
                                                     bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter {kind}")
        out[y] = row
        prior = out[y]
    return out.reshape(height, width) if bpp == 1 else out.reshape(height, width, bpp)


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"PNG encoding takes uint8 images, got {image.dtype}")
    channels = 1 if image.ndim == 2 else image.shape[-1]
    if image.ndim not in (2, 3) or channels not in _COLOUR_TYPE:
        raise ValueError(f"need (H, W), (H, W, 3) or (H, W, 4), got {image.shape}")
    height, width = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(height, width * channels)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def load_png(path: str, mode: str) -> np.ndarray:
    """The image converted as PIL's convert(mode) does: "L" -> (H, W) uint8,
    "RGB" -> (H, W, 3) uint8. Alpha is dropped."""
    img = read_png(path)
    gray = img.ndim == 2 or img.shape[-1] == 2
    if mode == "L":
        if gray:
            return img if img.ndim == 2 else img[..., 0]
        rgb = img[..., :3].astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    if mode == "RGB":
        if gray:
            g = img if img.ndim == 2 else img[..., 0]
            return np.repeat(g[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"unsupported mode {mode!r} (L or RGB)")
