"""ctypes binding of the native C++ ENVI reader (port of
hyperpri_tpu/data/native_io.py).

The reader (hyperpri_tpu_torch/native/envi_reader.cc, the port's own copy)
mmaps the .dat and gathers the requested band window into channel-last
float32 or bfloat16 with a thread pool. It is built at first use with
`g++ -O3 -std=c++17 -fPIC -shared -pthread` into
`<repo>/build/native/libhyperpri_io.so`, beside the target and then renamed,
so that concurrent processes never load half a library, and rebuilt when the
source is newer than it.

Nothing falls back quietly: a failed build raises with g++'s output, and a
nonzero return code of the reader raises with the code. bfloat16 needs no
ml_dtypes: the reader writes its bit patterns into a uint16 buffer, which is
viewed as torch.bfloat16.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from hyperpri_tpu_torch.data.envi import numpy_dtype

SOURCE = Path(__file__).resolve().parents[1] / "native" / "envi_reader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIBRARY_NAME = "libhyperpri_io.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

# The interleaves and ENVI data-type codes the C++ reader takes.
INTERLEAVE_CODE = {"bil": 0, "bip": 1, "bsq": 2}
DTYPE_CODE = {np.dtype(np.uint8): 1, np.dtype(np.int16): 2, np.dtype(np.int32): 3,
              np.dtype(np.float32): 4, np.dtype(np.float64): 5, np.dtype(np.uint16): 12,
              np.dtype(np.uint32): 13, np.dtype(np.int64): 14, np.dtype(np.uint64): 15}

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile SOURCE unless an up-to-date library exists; -> its path.
    Raises RuntimeError with g++'s output when the compiler fails."""
    out = BUILD_DIR / LIBRARY_NAME
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_library() -> ctypes.CDLL:
    """The loaded reader, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            head = [ctypes.c_char_p, ctypes.c_long] + [ctypes.c_int] * 8
            for fn, elem in ((lib.envi_read_slice, ctypes.c_float),
                             (lib.envi_read_slice_bf16, ctypes.c_uint16)):
                fn.restype = ctypes.c_int
                fn.argtypes = head + [ctypes.POINTER(elem), ctypes.c_int]
            _lib = lib
        return _lib


def native_supports(hdr) -> bool:
    """True iff the C++ reader takes this header's data type and interleave
    (decided before any call, from the header alone)."""
    return np.dtype(hdr.dtype.type) in DTYPE_CODE and hdr.interleave in INTERLEAVE_CODE


def read_cube_native(hdr, dat_path: str, band_lo: int, band_hi: int, dtype=torch.float32):
    """Bands [band_lo, band_hi) of the cube as contiguous (H, W, B): a float32
    numpy array for float32, a torch.bfloat16 tensor for bfloat16 (rounded
    to nearest even in the reader). Raises on a nonzero return code."""
    shape = (hdr.lines, hdr.samples, band_hi - band_lo)
    if dtype == torch.bfloat16:
        fn, out, elem = get_library().envi_read_slice_bf16, np.empty(shape, np.uint16), \
            ctypes.c_uint16
    elif numpy_dtype(dtype) == np.float32:
        fn, out, elem = get_library().envi_read_slice, np.empty(shape, np.float32), ctypes.c_float
    else:
        raise ValueError(f"the native reader writes float32 or bfloat16, not {dtype}")
    if not native_supports(hdr):
        raise ValueError(f"the native reader does not take {hdr.dtype} / {hdr.interleave}")
    rc = fn(dat_path.encode(), hdr.header_offset, hdr.lines, hdr.samples, hdr.bands,
            DTYPE_CODE[np.dtype(hdr.dtype.type)], hdr.byte_order,
            INTERLEAVE_CODE[hdr.interleave], band_lo, band_hi,
            out.ctypes.data_as(ctypes.POINTER(elem)),
            min(os.cpu_count() or 1, 8))
    if rc != 0:
        raise OSError(f"envi_read_slice returned {rc} for {dat_path}")
    return torch.from_numpy(out).view(torch.bfloat16) if out.dtype == np.uint16 else out
